"""Logit processors of the PyTorch port: penalties, temperature and the
single joint top-k / top-p / min-p threshold.

Counterpart of ``repro.sampling.processors``.  Every truncation filter is
a value threshold, so their sequential composition keeps exactly
``{x : x >= max(tau_k, tau_p, tau_m)}``; ``joint_threshold`` finds that
``tau`` with one sort and one softmax instead of one per filter.  Three
tiers share its semantics (``SampleFlags.kc`` in ``sample.py``):

* ``kc == 0``  full descending sort;
* ``kc > 0``   the top-kc values (``torch.topk``; only values are read
  here, so its unspecified tie order cannot matter);
* ``kc == -1`` no sort (only min-p can be active: ``tau_m`` needs the
  row max).

Every processor is an exact identity at its parameter's disabled value,
so the default ``SamplingParams()`` reproduces the greedy argmax bit for
bit.  The per-filter ``apply_top_k`` / ``apply_top_p`` / ``apply_min_p``
are the executable specification of each filter.

Functions take rows ``(..., V)`` and per-row parameters ``(...,)`` (or
scalars) and broadcast over the leading dims, where the JAX package
vmaps one-row functions.
"""
from __future__ import annotations

import torch

_NEG_INF = -1e30      # matches the attention-mask convention in models/


def _col(v, x: torch.Tensor) -> torch.Tensor:
    """A per-row parameter as a (..., 1) column on ``x``'s device."""
    return torch.as_tensor(v, device=x.device)[..., None]


def apply_penalties(logits, counts_full, counts_gen, rep, pres, freq):
    """Repetition / presence / frequency penalties.

    Repetition follows the HF full-context convention (divides positive
    logits, multiplies negative ones, for any token seen in prompt OR
    output); presence / frequency follow the OpenAI / vLLM convention and
    penalize only tokens the model itself generated."""
    rep, pres, freq = (_col(v, logits) for v in (rep, pres, freq))
    seen = counts_full > 0
    rep_l = torch.where(logits > 0, logits / rep, logits * rep)
    logits = torch.where(seen, rep_l, logits)
    cg = counts_gen.to(torch.float32)
    return logits - freq * cg - pres * (counts_gen > 0).to(torch.float32)


def apply_temperature(logits, temperature):
    """Scale by 1/T; T <= 0 (greedy) leaves the logits untouched."""
    t = _col(temperature, logits)
    return logits / torch.where(t > 0.0, t, torch.ones_like(t))


# ---------------------------------------------------------------------------
# reference per-filter processors (executable spec; not on the hot path)
# ---------------------------------------------------------------------------


def apply_top_k(logits, k):
    """Keep the k highest logits (k == 0 disables); ties at the k-th value
    are all kept."""
    V = logits.shape[-1]
    k = _col(k, logits)
    srt = torch.sort(logits, dim=-1, descending=True).values
    kth = torch.gather(srt, -1, torch.clamp(k - 1, 0, V - 1).long()
                       .expand(*logits.shape[:-1], 1))
    keep = (logits >= kth) | (k <= 0)
    return torch.where(keep, logits, _NEG_INF)


def apply_top_p(logits, p):
    """Nucleus: keep the smallest prefix of the sorted distribution whose
    cumulative probability reaches p (p >= 1 disables); the top token is
    always kept (exclusive cumulative sum)."""
    p = _col(p, logits)
    sl = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sl, dim=-1)
    cum_excl = torch.cumsum(probs, dim=-1) - probs
    kept = torch.where(cum_excl < p, sl, torch.inf)
    kth = kept.amin(dim=-1, keepdim=True)
    keep = (logits >= kth) | (p >= 1.0)
    return torch.where(keep, logits, _NEG_INF)


def apply_min_p(logits, min_p):
    """Drop tokens whose probability is below min_p * max probability
    (min_p == 0 disables)."""
    min_p = _col(min_p, logits)
    probs = torch.softmax(logits, dim=-1)
    keep = (probs >= min_p * probs.amax(dim=-1, keepdim=True)) | \
        (min_p <= 0.0)
    return torch.where(keep, logits, _NEG_INF)


# ---------------------------------------------------------------------------
# single-pass joint threshold (the sort route's hot path)
# ---------------------------------------------------------------------------


def joint_threshold(logits, k, p, min_p, kc: int = 0):
    """The value ``tau`` such that the top-k -> top-p -> min-p composition
    keeps exactly ``{x : x >= tau}``; -inf when all three filters are off.
    ``kc`` is the static tier of the module docstring."""
    k, p, min_p = (torch.as_tensor(v, device=logits.device)
                   for v in (k, p, min_p))
    if kc < 0:
        return torch.where(min_p > 0.0,
                           logits.amax(dim=-1) + torch.log(min_p),
                           -torch.inf)
    if kc == 0:
        sl = torch.sort(logits, dim=-1, descending=True).values
    else:
        sl = torch.topk(logits, kc, dim=-1).values
    return tau_from_sorted_rows(sl, k, p, min_p)


def tau_from_sorted_rows(sl, k, p, min_p):
    """Joint threshold from descending(-prefix) rows ``sl`` (..., cap):
    the full sorted row or the top-kc lanes."""
    cap = sl.shape[-1]
    k, p, min_p = (torch.as_tensor(v, device=sl.device)
                   for v in (k, p, min_p))
    idx = torch.clamp(k - 1, 0, cap - 1).long()
    kth = torch.gather(sl, -1, idx[..., None].expand(*sl.shape[:-1], 1))[
        ..., 0]
    tau_k = torch.where(k > 0, kth, -torch.inf)
    slk = torch.where(sl >= tau_k[..., None], sl, _NEG_INF)
    probs = torch.softmax(slk, dim=-1)
    cum_excl = torch.cumsum(probs, dim=-1) - probs
    kept = torch.where(cum_excl < p[..., None], slk, torch.inf)
    tau_p = torch.where(p < 1.0, kept.amin(dim=-1), -torch.inf)
    tau_m = torch.where(min_p > 0.0, sl[..., 0] + torch.log(min_p),
                        -torch.inf)
    return torch.maximum(torch.maximum(tau_k, tau_p), tau_m)


def joint_filter(logits, k, p, min_p, kc: int = 0):
    """Mask everything below the joint threshold to ``_NEG_INF``."""
    tau = joint_threshold(logits, k, p, min_p, kc)
    return torch.where(logits >= tau[..., None], logits, _NEG_INF)


def process_logits(logits, counts_full, counts_gen, sp_row, *,
                   pen: bool = True, kc: int = 0):
    """Full pipeline: penalties -> temperature -> joint top-k/top-p/min-p
    filter.  ``sp_row`` holds rows of the ``pack_params`` arrays (one
    slot's scalars, or (B,) rows for a batch); ``pen=False`` skips the
    penalty ops."""
    logits = logits.to(torch.float32)
    if pen:
        logits = apply_penalties(logits, counts_full, counts_gen,
                                 sp_row["repetition_penalty"],
                                 sp_row["presence_penalty"],
                                 sp_row["frequency_penalty"])
    logits = apply_temperature(logits, sp_row["temperature"])
    return joint_filter(logits, sp_row["top_k"], sp_row["top_p"],
                        sp_row["min_p"], kc)
