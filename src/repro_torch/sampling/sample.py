"""Batched sampling entry points of the PyTorch port, with the per-slot
PRNG and penalty state carried through the decode page.

Counterpart of ``repro.sampling.sample``.

Key discipline: the key of a sequence's t-th generated token is
``fold_in(PRNGKey(seed), t)``, a pure function of (seed, t) and never of
batch composition, slot or node.  ``fold_in`` is a bitwise torch port of
JAX's threefry-2x32 (20 rounds): ``fold_in(key, d) = threefry_2x32(key,
(0, d))``, as ``jax._src.prng._threefry_fold_in`` defines it.  torch has
next to no uint32 arithmetic, so words live in int64 masked to 32 bits.
Keys are (..., 2) int64 tensors holding the two uint32 words.

Sampling is the Gumbel-max trick over token-addressed noise:
``token_gumbel`` hashes ``fold_in(step_key, token_id)``, so every route
realises the same (seed, t, token) -> noise map as the JAX package, bit
for bit in the hash (the final ``-log(-log(u))`` may differ by an ulp
between math libraries).

Static plan (:class:`SampleFlags`), decided on the host per page:

* ``backend`` — ``"fused"`` routes filter and draw through the fused
  sampling kernel (``repro_torch.kernels.fused_sampling``): its CUDA
  kernel for a CUDA tensor, its plain PyTorch version for a CPU tensor.
  ``"sort"`` is the shared-sort route (the JAX package's ``"xla"``
  tiers), kept as the executable specification; only a caller that
  passes the flags itself reaches it.  ``flags_for`` always picks
  ``"fused"``, and no environment variable overrides it.
* ``pen`` — False drops the penalty ops and the count updates.
* ``kc`` — the sort route's tier: 0 full sort, > 0 top-kc lanes, -1
  sortless.
* ``mixed`` / ``stops`` — any greedy row, any stop set.

State per slot (``init_state`` on the host, device tensors in the
engine): ``base_key`` (B, 2) int64, ``gen_count`` (B,) int32, ``counts``
and ``prompt_counts`` (B, V) int32.  ``sample_step`` advances
``counts`` in place (it is the engine's own buffer; an out-of-place
update would copy B x V ints every step).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import compat
from repro_torch.sampling.processors import (_NEG_INF, apply_penalties,
                                             apply_temperature,
                                             joint_threshold,
                                             process_logits,
                                             tau_from_sorted_rows)

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


@dataclasses.dataclass(frozen=True)
class SampleFlags:
    """Static (host-decided) execution plan for one decode page."""
    backend: str = "fused"   # "fused" | "sort"
    pen: bool = True         # any penalty enabled in the active batch
    kc: int = 0              # sort tier: 0 full, >0 top-kc, -1 sortless
    mixed: bool = True       # any greedy (temperature <= 0) row present
    stops: bool = True       # any stop-token set non-empty


DEFAULT_FLAGS = SampleFlags()


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def flags_for(sps, vocab: int) -> SampleFlags:
    """The static plan for the active slots' SamplingParams: always the
    kernel route, with the JAX package's pen / kc / mixed / stops.

    ``kc`` buckets the top-k cap to a pow2 (floor 8); the lane tier needs
    every drawing row (temperature > 0) to have top-k active, any other
    drawing row with top-k or top-p forces the full sort, and no filter at
    all gives the sortless tier."""
    act = [s for s in sps if not s.is_greedy_default]
    pen = any(s.repetition_penalty != 1.0 or s.presence_penalty != 0.0
              or s.frequency_penalty != 0.0 for s in act)
    drawing = [s for s in act if s.temperature > 0.0]
    ks = [s.top_k for s in drawing if s.top_k > 0]
    if drawing and all(s.top_k > 0 for s in drawing):
        kc = max(_pow2(max(ks)), 8)
        if kc >= vocab:
            kc = 0
    elif any(s.top_k > 0 or s.top_p < 1.0 for s in drawing):
        kc = 0
    else:
        kc = -1
    return SampleFlags(backend="fused", pen=pen, kc=kc,
                       mixed=any(s.temperature <= 0.0 for s in sps),
                       stops=any(s.stop for s in sps))


# ---------------------------------------------------------------------------
# threefry-2x32 and the keys
# ---------------------------------------------------------------------------


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry_2x32(k0, k1, x0, x1):
    """JAX's threefry2x32 hash (``_threefry2x32_lowering``) on int64
    tensors holding uint32 words; broadcasts its four operands.  Returns
    the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def fold_in(key, data):
    """``jax.random.fold_in`` for raw threefry keys: key (..., 2) int64
    words, data (...) integers (taken as uint32) -> (..., 2) int64."""
    key = torch.as_tensor(key, dtype=torch.int64)
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & _M32
    y0, y1 = threefry_2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                           data)
    return torch.stack([y0, y1], dim=-1)


def base_keys_host(seeds) -> np.ndarray:
    """(B,) seeds -> (B, 2) uint32 raw threefry keys, built on the host:
    ``PRNGKey(s)`` of a 32-bit seed is ``[0, s]``."""
    seeds = np.asarray(seeds, np.uint32)
    return np.stack([np.zeros_like(seeds), seeds], axis=-1)


def base_keys(seeds, device=None) -> torch.Tensor:
    """(B,) seeds -> (B, 2) int64 key words on ``device`` (default
    ``"cuda"``, as every entry point of the port)."""
    return torch.from_numpy(base_keys_host(seeds).astype(np.int64)).to(
        compat.resolve_device(device))


def step_keys(base, gen_count):
    """Per-slot key for the current step: fold_in(base_b, gen_count_b)."""
    return fold_in(base, gen_count)


def token_gumbel(keys, ids):
    """Token-addressed Gumbel noise: g[b, j] is a pure function of
    (keys[b], ids[b, j]), the uniform taken from the first word of
    ``fold_in(key, token_id)``.  keys (B, 2) int64; ids (B, I) -> (B, I)
    f32."""
    ids = torch.as_tensor(ids, device=keys.device).to(torch.int64) & _M32
    bits, _ = threefry_2x32(keys[:, 0:1], keys[:, 1:2], torch.zeros_like(ids),
                            ids)
    u = (bits >> 8).to(torch.float32) * 2.0 ** -24
    u = u + 2.0 ** -25                  # (0, 1): log(log) stays finite
    return -torch.log(-torch.log(u))


def _gumbel_rows(keys, V: int):
    """(B, V) full-vocabulary noise rows: ``token_gumbel`` at every id."""
    ids = torch.arange(V, dtype=torch.int64, device=keys.device)
    return token_gumbel(keys, ids[None].expand(keys.shape[0], V))


def _bincounts(token_lists, vocab: int) -> np.ndarray:
    out = np.zeros((len(token_lists), vocab), np.int32)
    for i, toks in enumerate(token_lists):
        if toks:
            out[i] = np.bincount(
                np.asarray(toks, np.int64), minlength=vocab)[:vocab]
    return out


def init_state(seeds, prompt_lists, generated_lists,
               vocab: int) -> Dict[str, np.ndarray]:
    """Host-side state for a batch of slots (install / prefill time):
    penalty counts and the PRNG position are recomputed from the token
    lists, never migrated as device state."""
    return {"seed": np.asarray(seeds, np.uint32),
            "gen_count": np.asarray([len(g) for g in generated_lists],
                                    np.int32),
            "counts": _bincounts(generated_lists, vocab),
            "prompt_counts": _bincounts(prompt_lists, vocab)}


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def _top_sorted(x, k: int):
    """The k largest entries per row with their ids, ties to the lowest id
    (``jax.lax.top_k``'s rule; ``torch.topk`` leaves tie order open)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def sample_one(logits, counts_full, counts_gen, sp_row, key,
               flags: SampleFlags = DEFAULT_FLAGS):
    """Reference single-row form: logits (V,), counts (V,), ``sp_row`` one
    row of the pack_params arrays, key (2,).  Returns the token id."""
    proc = process_logits(logits, counts_full, counts_gen, sp_row,
                          pen=flags.pen, kc=flags.kc)
    greedy_tok = torch.argmax(proc)
    V = proc.shape[-1]
    gumbel = token_gumbel(torch.as_tensor(key)[None], torch.arange(
        V, device=proc.device)[None])[0]
    sampled_tok = torch.argmax(proc + gumbel)
    t = torch.as_tensor(sp_row["temperature"])
    return torch.where(t <= 0.0, greedy_tok, sampled_tok).to(torch.int32)


def _processed(logits, counts_full, counts_gen, sp, flags: SampleFlags):
    """Batched penalties + temperature (the elementwise prefix the kernel
    does not fold in)."""
    x = logits.to(torch.float32)
    if flags.pen:
        x = apply_penalties(x, counts_full, counts_gen,
                            sp["repetition_penalty"], sp["presence_penalty"],
                            sp["frequency_penalty"])
    return apply_temperature(x, sp["temperature"])


def _sort_lanes(raw, tokens, lp_k: int):
    """Logprob lanes from raw logits: the same math as
    ``models.transformer.pack_logprob_block``."""
    lp = torch.log_softmax(raw.to(torch.float32), dim=-1)
    chosen = torch.gather(lp, 1, tokens[:, None].long())[:, 0]
    lanes = {"chosen_lp": chosen, "top_vals": None, "top_idx": None}
    if lp_k > 0:
        vals, idx = _top_sorted(lp, lp_k)
        lanes["top_vals"], lanes["top_idx"] = vals, idx.to(torch.int32)
    return lanes


def _sample_impl(logits, counts_full, counts_gen, sp, keys,
                 flags: SampleFlags, raw=None, lp_k: Optional[int] = None):
    """Shared batched core: returns (tokens (B,) int32, lanes | None).
    ``raw`` are the pre-pipeline model logits the logprob lanes report."""
    temp = sp["temperature"]
    if flags.backend == "fused":
        from repro_torch.kernels.fused_sampling.ops import fused_sample

        proc = _processed(logits, counts_full, counts_gen, sp, flags)
        gumbel = _gumbel_rows(keys, proc.shape[-1])
        out = fused_sample(proc, gumbel, sp["top_k"], sp["top_p"],
                           sp["min_p"], raw=raw,
                           lp_k=0 if lp_k is None else max(lp_k, 0),
                           with_lanes=lp_k is not None)
        tokens = (torch.where(temp <= 0.0, out["greedy"], out["sampled"])
                  if flags.mixed else out["sampled"]).to(torch.int32)
        lanes = None
        if lp_k is not None:
            logz = out["m_raw"] + torch.log(out["l_raw"])
            lanes = {"chosen_lp": torch.gather(
                         raw.to(torch.float32), 1,
                         tokens[:, None].long())[:, 0] - logz,
                     "top_vals": None, "top_idx": None}
            if lp_k > 0:
                lanes["top_vals"] = out["top_vals"] - logz[:, None]
                lanes["top_idx"] = out["top_idx"]
        return tokens, lanes
    if flags.backend != "sort":
        raise ValueError(f"unknown sampling backend {flags.backend!r}")

    if flags.kc > 0:
        tokens = _sample_topk_lanes(logits, counts_full, counts_gen, sp,
                                    keys, flags)
    else:
        proc = _processed(logits, counts_full, counts_gen, sp, flags)
        tau = joint_threshold(proc, sp["top_k"], sp["top_p"], sp["min_p"],
                              flags.kc)
        proc = torch.where(proc >= tau[:, None], proc, _NEG_INF)
        sampled = torch.argmax(proc + _gumbel_rows(keys, proc.shape[-1]),
                               dim=-1)
        if flags.mixed:
            sampled = torch.where(temp <= 0.0, torch.argmax(proc, dim=-1),
                                  sampled)
        tokens = sampled.to(torch.int32)
    lanes = _sort_lanes(raw, tokens, lp_k) if lp_k is not None else None
    return tokens, lanes


def _sample_topk_lanes(logits, counts_full, counts_gen, sp, keys,
                       flags: SampleFlags):
    """Top-kc tier: when every drawing row has top-k active (<= kc), the
    kept set lies in the top-kc lanes, so temperature, thresholds and the
    argmax run on (B, kc).  The noise stays token-indexed (hashed at the
    lane ids), so this tier draws the same stream as the full ones."""
    x = logits.to(torch.float32)
    if flags.pen:
        x = apply_penalties(x, counts_full, counts_gen,
                            sp["repetition_penalty"], sp["presence_penalty"],
                            sp["frequency_penalty"])
    sl, si = _top_sorted(x, flags.kc)
    temp = sp["temperature"]
    scale = torch.where(temp > 0.0, temp, torch.ones_like(temp))
    sl = sl / scale[:, None]
    tau = tau_from_sorted_rows(sl, sp["top_k"], sp["top_p"], sp["min_p"])
    masked = torch.where(sl >= tau[:, None], sl, _NEG_INF)
    lane = torch.argmax(masked + token_gumbel(keys, si), dim=-1)
    sampled = torch.gather(si, 1, lane[:, None])[:, 0]
    if flags.mixed:
        sampled = torch.where(temp <= 0.0, si[:, 0], sampled)
    return sampled.to(torch.int32)


def sample(logits, counts_full, counts_gen, sp, keys,
           flags: SampleFlags = DEFAULT_FLAGS):
    """Batched sampling across slots: logits (B, V), counts (B, V), ``sp``
    dict of (B,) rows from pack_params ("stop" / "seed" ignored), keys
    (B, 2).  Returns (B,) int32 tokens."""
    return _sample_impl(logits, counts_full, counts_gen, sp, keys,
                        flags)[0]


def stop_hit(tokens, stop_table):
    """(B,) bool: did slot b's token land in its stop set?  stop_table
    (B, MAX_STOP_TOKENS) int32 padded with -1 (never matches)."""
    return (tokens[:, None] == stop_table).any(dim=1)


def sample_step(logits, remaining, state, sp,
                flags: SampleFlags = DEFAULT_FLAGS,
                lp_k: Optional[int] = None):
    """One decode step's draw for the whole batch.

    Draws one token per slot with the per-slot fold_in key and advances
    the state of LIVE slots only (a masked slot consumes no randomness and
    no counts, or batch composition would perturb the stream).  Returns
    ``(next_tokens, live, new_remaining, new_state)``, plus the logprob
    lanes of the raw logits when ``lp_k`` is not None.  A stop-token hit
    zeroes the slot's remaining after the stop token is emitted."""
    base = state["base_key"]
    gen_count = state["gen_count"]
    counts = state["counts"]
    prompt_counts = state["prompt_counts"]
    keys = step_keys(base, gen_count)
    cf = prompt_counts + counts if flags.pen else counts
    nxt, lanes = _sample_impl(logits, cf, counts, sp, keys, flags,
                              raw=logits if lp_k is not None else None,
                              lp_k=lp_k)
    live = remaining > 0
    step = live.to(torch.int32)
    if flags.pen:
        rows = torch.arange(nxt.shape[0], device=nxt.device)
        counts.index_put_((rows, nxt.long()), step, accumulate=True)
    gen_count = gen_count + step
    new_remaining = remaining - step
    if flags.stops:
        hit = stop_hit(nxt, sp["stop"]) & live
        new_remaining = torch.where(hit, torch.zeros_like(new_remaining),
                                    new_remaining)
    new_state = {"base_key": base, "gen_count": gen_count, "counts": counts,
                 "prompt_counts": prompt_counts}
    if lp_k is None:
        return nxt, live, new_remaining, new_state
    return nxt, live, new_remaining, new_state, lanes
