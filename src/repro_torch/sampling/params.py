"""Host-side sampling configuration and its batched device packing.

``SamplingParams`` travels on the coroutine (so COMBINE/MIGRATE/PARTITION
carry it for free); ``pack_params`` produces the (B,)-shaped arrays the
jitted processors consume, one row per device slot.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

# Fixed stop-token capacity so megastep shapes stay static across batches.
MAX_STOP_TOKENS = 8


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-sequence decoding configuration (vLLM/OpenAI-style surface).

    ``temperature <= 0`` means greedy argmax; the default instance is
    exactly the greedy megastep (every processor is an identity at its
    default value).  ``seed=None`` derives a deterministic per-sequence
    seed from ``seq_id`` at submit time, so two sequences with identical
    prompts still explore independently while staying reproducible.
    """
    temperature: float = 0.0
    top_k: int = 0                    # 0 = disabled
    top_p: float = 1.0                # 1.0 = disabled
    min_p: float = 0.0                # 0.0 = disabled
    repetition_penalty: float = 1.0   # 1.0 = disabled
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    seed: Optional[int] = None
    stop: Tuple[int, ...] = ()        # stop token ids (emitted, then halt)
    # host-only: wall-clock deadline (seconds since submit) after which
    # the sequence finishes gracefully with finish_reason="deadline".
    # Never packed to device (pack_params) and irrelevant to
    # is_greedy_default — it shapes scheduling, not logits.
    deadline_s: Optional[float] = None

    def __post_init__(self):
        if len(self.stop) > MAX_STOP_TOKENS:
            raise ValueError(
                f"at most {MAX_STOP_TOKENS} stop tokens (got {len(self.stop)})")
        if self.top_k < 0 or not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"bad top_k/top_p: {self.top_k}/{self.top_p}")

    @property
    def is_greedy_default(self) -> bool:
        """True iff this instance is indistinguishable from greedy —
        eligible for the sampling-free megastep (no PRNG, no counts)."""
        return (self.temperature <= 0.0 and self.top_k == 0
                and self.top_p >= 1.0 and self.min_p <= 0.0
                and self.repetition_penalty == 1.0
                and self.presence_penalty == 0.0
                and self.frequency_penalty == 0.0
                and self.seed is None and not self.stop)

    def effective_seed(self, seq_id: int) -> int:
        return self.seed if self.seed is not None else seq_id

    def truncate_at_stop(self, tokens) -> Tuple[list, bool]:
        """Host-side mirror of the on-device stop semantics: the stop
        token is emitted, then the sequence halts.  Returns
        (kept_tokens, stopped)."""
        toks = [int(t) for t in tokens]
        if not self.stop:
            return toks, False
        ss = set(self.stop)
        for i, t in enumerate(toks):
            if t in ss:
                return toks[: i + 1], True
        return toks, False


def derive_fork_seed(base_seed: int, fork_index: int) -> int:
    """Per-fork seed derivation for ``submit(n=...)`` fan-out.

    An explicit seed shared by a whole fork group would make every sibling
    decode the same stream; splitmix-style mixing gives each fork a stable,
    well-separated seed so fork k of seed s is reproducible on its own
    (submit a single sequence with ``derive_fork_seed(s, k)`` and you get
    the identical stream).  Fork 0 (the lead) keeps the base seed."""
    if fork_index == 0:
        return base_seed
    z = (base_seed + fork_index * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) & 0xFFFFFFFF


def pack_params(sps: Sequence[SamplingParams],
                seq_ids: Sequence[int]) -> Dict[str, np.ndarray]:
    """Batch per-sequence params into row-aligned numpy arrays.

    Returns float32/int32 arrays of shape (B,) plus a (B, MAX_STOP_TOKENS)
    stop table padded with -1 (token ids are non-negative, so -1 never
    matches) and the (B,) effective seeds.  Callers upload with
    ``jnp.asarray`` and scatter rows with ``.at[slot].set`` as slots churn.
    """
    B = len(sps)
    out = {
        "temperature": np.zeros((B,), np.float32),
        "top_k": np.zeros((B,), np.int32),
        "top_p": np.ones((B,), np.float32),
        "min_p": np.zeros((B,), np.float32),
        "repetition_penalty": np.ones((B,), np.float32),
        "presence_penalty": np.zeros((B,), np.float32),
        "frequency_penalty": np.zeros((B,), np.float32),
        "stop": np.full((B, MAX_STOP_TOKENS), -1, np.int32),
        "seed": np.zeros((B,), np.uint32),
    }
    for i, (sp, sid) in enumerate(zip(sps, seq_ids)):
        out["temperature"][i] = sp.temperature
        out["top_k"][i] = sp.top_k
        out["top_p"][i] = sp.top_p
        out["min_p"][i] = sp.min_p
        out["repetition_penalty"][i] = sp.repetition_penalty
        out["presence_penalty"][i] = sp.presence_penalty
        out["frequency_penalty"][i] = sp.frequency_penalty
        if sp.stop:
            out["stop"][i, : len(sp.stop)] = sp.stop
        out["seed"][i] = np.uint32(sp.effective_seed(sid) & 0xFFFFFFFF)
    return out
