"""Model-level serving of a batch of equal-length prompts, with no engine:
``prefill``, the first token drawn from its logits, then ``decode_page``s
until every row has its tokens.

This is how the port serves the SSM and hybrid families, sliding-window
decoders, the Whisper encoder-decoder and the Pixtral vision decoder
(``NodeEngine`` refuses them, as the JAX engine does): through the model
functions the JAX package's ``launch/steps.py`` builds its prefill and
decode cells on.  A windowed model's prefill rings (min(window, S)
slots) are re-laid into a decode cache of min(window, S + the most
tokens a row gets) slots (``transformer.install_rings``), so decode past
the window's wrap matches the teacher-forced forward.  Whisper's and
Pixtral's prefill caches go into a decode cache of S + the most tokens a
row gets, rounded up to 16 positions (``transformer.install_cache``):
decode attention views the cache as pages of gcd(length, 16) positions,
so the round-up keeps its pages at 16.  Whisper takes stub ``frames``
(B, encoder_seq, D), Pixtral optional stub ``patches`` (B, P, D) placed
before the prompt (its positions then count them).  Greedy rows
take the argmax; with ``sampling`` every row draws through the port's
sampler (the first token with key fold_in(seed, 0) and the prompt's
penalty counts, as ``NodeEngine`` draws it; then ``decode_page``'s
sampled steps).  With ``lp_k`` every page carries the logprob plane of
the raw logits (the chosen token's logprob and, for lp_k > 0, the top
lp_k).  Each page crosses to the host in one copy of its token block.

    from repro_torch.launch.model_level import generate
    out = generate(cfg, params, prompts, 32, sampling=[SamplingParams(
        temperature=0.8, top_k=40, seed=i) for i in range(len(prompts))])
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import sampling as smp
from repro_torch.models import transformer as T


@dataclasses.dataclass
class Generation:
    tokens: List[List[int]]          # per row, the generated tokens
    # per row, (chosen logprob, top values, top ids) of each token, with
    # lp_k set; None otherwise
    logprobs: Optional[List[tuple]]
    prefill_s: float                 # host clock, ended by a synchronize
    decode_s: float
    decode_steps: int                # steps run by the decode pages
    pages: int

    @property
    def out_tokens(self) -> int:
        return sum(len(t) for t in self.tokens)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _windowed(cfg) -> bool:
    return cfg.family == "hybrid" or cfg.sliding_window > 0


def _as_tensor(x, dev):
    """An fp32 tensor on ``dev`` from a tensor or a numpy array."""
    if x is None:
        return None
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.asarray(x, np.float32))
    return t.to(dev, torch.float32)


def generate(cfg, params, prompts, max_tokens: Union[int, Sequence[int]], *,
             sampling: Optional[Sequence[smp.SamplingParams]] = None,
             lp_k: Optional[int] = None, page_steps: int = 16,
             frames=None, patches=None) -> Generation:
    """Serve ``prompts`` (B equal-length token lists) on the device of
    ``params``: each row gets ``max_tokens`` tokens (an int or one per
    row), fewer when a sampled row hits a stop token.  Each
    ``decode_page`` runs ``page_steps`` steps.  Whisper needs ``frames``
    (B, encoder_seq, D) and Pixtral takes ``patches`` (B, P, D), tensors
    or numpy arrays (fp32)."""
    if cfg.family not in ("ssm", "audio", "vlm") and not _windowed(cfg):
        raise NotImplementedError(
            f"{cfg.name}: model-level serving takes the SSM, hybrid, "
            f"encoder-decoder and vision families and sliding-window "
            f"decoders; full-attention decoders are served by NodeEngine")
    dev = params["embed"].device
    B = len(prompts)
    toks = torch.tensor(np.asarray(prompts, np.int32), device=dev)
    V = T.padded_vocab(cfg)
    want = np.broadcast_to(np.asarray(max_tokens, np.int32), (B,)).copy()
    if (want < 1).any():
        raise ValueError("every row needs max_tokens >= 1")
    frames, patches = _as_tensor(frames, dev), _as_tensor(patches, dev)
    # the positions before the first generated token: Pixtral's count its
    # patches
    S = toks.shape[1] + (0 if patches is None else patches.shape[1])

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = T.prefill(cfg, params, toks, frames=frames,
                              patches=patches)
    if _windowed(cfg):
        rings = T.init_cache(cfg, B, S + int(want.max()), dev)
        cache = T.install_rings(cfg, rings, cache)
    elif cfg.family in ("audio", "vlm"):
        max_len = -(-(S + int(want.max())) // 16) * 16
        cache = T.install_cache(cfg, T.init_cache(cfg, B, max_len, dev),
                                cache)
    logits = logits[:, 0]
    if sampling is None:
        first = torch.argmax(logits, dim=-1).to(torch.int32)
        page_kw = {}
    else:
        sp = smp.pack_params(list(sampling), list(range(B)))
        flags = smp.flags_for(list(sampling), V)
        rows = {k: torch.from_numpy(v).to(dev) for k, v in sp.items()
                if k != "seed"}
        st = smp.init_state(sp["seed"], [list(p) for p in prompts],
                            [[] for _ in range(B)], V)
        base = smp.base_keys(st["seed"], dev)
        prompt_counts = torch.from_numpy(st["prompt_counts"]).to(dev)
        first = smp.sample(
            logits, prompt_counts, torch.from_numpy(st["counts"]).to(dev),
            rows, smp.step_keys(base, torch.zeros((B,), dtype=torch.int32,
                                                   device=dev)), flags)
    first_np = first.cpu().numpy()
    prefill_s = time.perf_counter() - t0

    tokens = [[int(t)] for t in first_np]
    remaining = want - 1
    if sampling is not None:
        for i, s in enumerate(sampling):
            if int(first_np[i]) in s.stop:
                remaining[i] = 0
        st = smp.init_state(sp["seed"], [list(p) for p in prompts],
                            [[int(t)] for t in first_np], V)
        state = {"base_key": base,
                 "gen_count": torch.from_numpy(st["gen_count"]).to(dev),
                 "counts": torch.from_numpy(st["counts"]).to(dev),
                 "prompt_counts": prompt_counts}
        page_kw = dict(sampling=(rows, state), flags=flags)
    lps = None
    if lp_k is not None:
        plane = T.pack_logprob_block(first, logits, lp_k).cpu().numpy()
        _, c, v, i = T.unpack_logprob_block(plane[None])
        lps = [([float(c[0, b])], [] if v is None else [v[0, b].tolist()],
                [] if i is None else [i[0, b].tolist()]) for b in range(B)]

    cur = first
    lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
    rem = torch.from_numpy(remaining).to(dev)
    decode_s, steps, pages = 0.0, 0, 0
    while remaining.max() > 0:
        t = time.perf_counter()
        out = T.decode_page(cfg, params, cache, cur, lengths, rem,
                            page_steps, lp_k=lp_k, **page_kw)
        block, cur, new_lengths, rem, cache = out[:5]
        if sampling is not None:
            page_kw["sampling"] = (rows, out[5])
        block_np = block.cpu().numpy()
        live = (new_lengths - lengths).cpu().numpy()
        remaining = rem.cpu().numpy()
        decode_s += time.perf_counter() - t
        steps += page_steps
        pages += 1
        lengths = new_lengths
        if lp_k is None:
            page_toks = block_np
        else:
            page_toks, c, v, i = T.unpack_logprob_block(block_np)
        for b in range(B):
            n = int(live[b])
            tokens[b] += page_toks[:n, b].tolist()
            if lp_k is not None:
                lps[b][0].extend(c[:n, b].tolist())
                if v is not None:
                    lps[b][1].extend(v[:n, b].tolist())
                    lps[b][2].extend(i[:n, b].tolist())
    return Generation(tokens, lps, prefill_s, decode_s, steps, pages)
