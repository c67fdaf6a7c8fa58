"""Data pipeline substrate: deterministic sharded synthetic LM data with
long-tail request generators for inference workloads.

Training side: every host builds only its shard (seeded by
(epoch, host_id)) — the pattern a 1000-node deployment needs: no global
shuffle state, resumable from a (step, epoch) cursor stored in the train
checkpoint.

Inference side: ``LongTailRequestStream`` generates batch-API request
dicts with lognormal prompt/output lengths (the Fig. 2c long-tail shape
``runtime.cluster.longtail_workload`` measures against), streamed one
request at a time so a million-line input file is written in O(1)
memory.  Requests are fully deterministic given the seed — the
streaming driver's byte-identical-resume tests depend on it.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from repro_torch.models.api import ModelConfig


@dataclasses.dataclass
class DataConfig:
    global_batch: int
    seq_len: int
    vocab_size: int
    num_hosts: int = 1
    host_id: int = 0
    seed: int = 0
    markov_p: float = 0.8       # synthetic structure (learnable signal)


class SyntheticLMStream:
    """Infinite deterministic stream; host h yields rows
    [h*B/H, (h+1)*B/H) of the global batch."""

    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.num_hosts == 0
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.trans = rng.integers(2, cfg.vocab_size,
                                  (cfg.vocab_size,)).astype(np.int32)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        B = c.global_batch // c.num_hosts
        rng = np.random.default_rng(
            np.random.SeedSequence([c.seed, step, c.host_id]))
        toks = np.zeros((B, c.seq_len), np.int32)
        toks[:, 0] = rng.integers(2, c.vocab_size, B)
        for t in range(1, c.seq_len):
            follow = rng.random(B) < c.markov_p
            toks[:, t] = np.where(follow, self.trans[toks[:, t - 1]],
                                  rng.integers(2, c.vocab_size, B))
        return {"tokens": toks, "labels": toks}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class LongTailRequestStream:
    """Seeded stream of batch-input request dicts with long-tail lengths.

    Prompt lengths are Poisson(mean_in); output budgets are lognormal
    (mu = log(mean_out) - sigma^2/2, so the mean is ``mean_out`` and the
    P99/P95 tail ratio lands near Fig. 2c at sigma≈1.0) — the same
    calibration as ``longtail_workload``, but emitted as jsonl-ready
    request dicts one at a time instead of a materialized Workload.

    Each request draws from its own ``SeedSequence([seed, i])``, so
    request *i* is a pure function of (seed, i): regeneration, resume
    and replica reassignment all see identical requests.  Greedy by
    default (temperature 0) — simulated greedy decode is deterministic,
    which the driver's byte-identical merged-output contract needs.
    """

    def __init__(self, n: int, *, seed: int = 0, mean_in: int = 64,
                 mean_out: int = 24, sigma: float = 1.0,
                 max_in_cap: int = 4096, max_out_cap: int = 2048,
                 vocab: int = 32000, temperature: float = 0.0):
        self.n = int(n)
        self.seed = int(seed)
        self.mean_in = int(mean_in)
        self.mean_out = int(mean_out)
        self.sigma = float(sigma)
        self.max_in_cap = int(max_in_cap)
        self.max_out_cap = int(max_out_cap)
        self.vocab = int(vocab)
        self.temperature = float(temperature)

    def request(self, i: int) -> Dict[str, Any]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, i]))
        n_in = int(min(max(rng.poisson(self.mean_in), 4), self.max_in_cap))
        mu = math.log(self.mean_out) - self.sigma ** 2 / 2
        n_out = int(min(max(int(rng.lognormal(mu, self.sigma)), 2),
                        self.max_out_cap))
        body: Dict[str, Any] = {
            "prompt": [int(t) for t in rng.integers(2, self.vocab, n_in)],
            "max_tokens": n_out,
        }
        if self.temperature > 0.0:
            # explicit per-request seed: sampled decode stays a pure
            # function of the request, never of the scheduler's seq_id
            body["temperature"] = self.temperature
            body["seed"] = self.seed * 1_000_003 + i
        return {"custom_id": f"req-{i:08d}", "body": body}

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for i in range(self.n):
            yield self.request(i)

    def write_jsonl(self, path: str) -> int:
        """Stream the whole job to a jsonl input file (O(1) memory)."""
        with open(path, "w", encoding="utf-8", newline="\n") as fh:
            for req in self:
                fh.write(json.dumps(req) + "\n")
        return self.n


def frontend_stub(cfg: ModelConfig, batch: Dict[str, np.ndarray],
                  rng: Optional[np.random.Generator] = None):
    """Attach the modality-frontend stand-ins the VLM/audio archs need
    (precomputed patch/frame embeddings, per the assignment spec)."""
    rng = rng or np.random.default_rng(0)
    B = batch["tokens"].shape[0]
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32) * 0.02
        batch["labels"] = np.concatenate(
            [np.full((B, cfg.num_patches), -1, np.int32), batch["labels"]], 1)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32) * 0.02
    return batch
