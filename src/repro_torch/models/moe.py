"""Mixture-of-Experts layer on one device.

PyTorch counterpart of the single-device path of ``repro.models.moe``:
the router, the capacity-bounded MoE (``_moe_local``), shared experts and
the dense oracle ``moe_ref``.  Parameters keep the JAX layout:
``wg (D, E)`` in fp32 whatever ``cfg.dtype`` is, ``w1 / w3 (E, D, F)``,
``w2 (E, F, D)`` and an optional ``shared`` gated MLP.

The reference computes ``_moe_local`` as a dense einsum over all E experts
on an (E, C, D) capacity buffer.  The port keeps its semantics (the
capacity C counts every row of the forward, and a choice whose rank among
its expert's choices in flat token-major order is >= C is dropped) but
runs only the kept choices, sorted by expert, through the ``moe_gemm``
grouped GEMM: three launches per layer.  The result equals the
reference's.  ``_moe_shard_body`` is one rank's share of the
expert-parallel layer (``models/transformer.py::_train_layer``
all-reduces the partial outputs over the model group).

Under autograd the router (an fp32 matmul and softmax), the gather and the
combine stay plain torch ops, and the grouped GEMMs run
``moe_gemm``'s ``GroupedGemmFn`` (dX and dW kernels on the card); a
dropped choice weighs 0 in the combine, so it gets no gradient, as the
reference's fill gather gives none.  ``moe_fwd`` returns the layer's
load-balance aux beside its output; ``forward_loss`` adds it to the loss.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.moe_gemm import ops as moe_ops
from repro_torch.models import layers
from repro_torch.models.api import ModelConfig


def expert_capacity(cfg: ModelConfig, tokens: int) -> int:
    """Static per-expert slot count for a local token pool of size
    ``tokens``."""
    c = math.ceil(tokens * cfg.experts_per_token / cfg.num_experts
                  * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to 8, floor of 8 slots


def _router(cfg: ModelConfig, wg, xt):
    """(vals (T,k) fp32, ids (T,k) int64, probs (T,E) fp32).  Top-k
    breaks ties to the lowest expert id (``lax.top_k``'s rule; a stable
    descending sort, since ``torch.topk`` leaves tie order open)."""
    logits = torch.matmul(xt.float(), wg)
    probs = torch.softmax(logits, dim=-1)
    k = cfg.experts_per_token
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, ids = vals[:, :k], ids[:, :k]
    vals = vals / torch.clamp_min(vals.sum(-1, keepdim=True), 1e-9)
    return vals, ids, probs


def _route_terms(cfg: ModelConfig, wg, xt):
    """Router: (vals (T,k) fp32, ids (T,k) int64, the load-balance aux's
    terms (E,) fp32, whose sum is the aux)."""
    vals, ids, probs = _router(cfg, wg, xt)
    # Switch-style load-balance aux: E * sum_e f_e * p_e
    E = cfg.num_experts
    f = torch.zeros((E,), dtype=torch.float32, device=xt.device) \
        .index_add_(0, ids.reshape(-1),
                    torch.ones((ids.numel(),), device=xt.device)) \
        / ids.numel() * E
    return vals, ids, f * probs.mean(0)


def _spread_route_terms(cfg: ModelConfig, wg, xt, route):
    """``_route_terms`` of this rank's rows xt of a batch split in order
    over the data group ``route`` (the ``fsdp`` regime, whose reference
    routes the global batch as one ``_moe_local``): its choices are a
    contiguous block of the global flat order, so one all-gather of each
    rank's (E,) choice counts gives each expert's choices before this
    rank's.  The terms are this rank's share of the global aux, E f_e
    from the global counts times its rows' sum of p_e over the global
    token count: they sum over the group (the caller's loss) to the
    whole batch's.  Returns (vals, ids, terms, the earlier ranks' counts
    (E,), the global token count)."""
    vals, ids, probs = _router(cfg, wg, xt)
    E, k = cfg.num_experts, cfg.experts_per_token
    counts = torch.zeros((E,), dtype=torch.long, device=xt.device) \
        .index_add_(0, ids.reshape(-1), torch.ones_like(ids.reshape(-1)))
    every = route.all_gather(counts[None])             # (ranks, E)
    T_all = xt.shape[0] * route.size
    f = every.sum(0).float() / (T_all * k) * E
    return (vals, ids, f * probs.sum(0) / T_all, every[:route.rank].sum(0),
            T_all)


def _route(cfg: ModelConfig, wg, xt):
    """Router: (vals (T,k) fp32, ids (T,k) int64, aux fp32 scalar)."""
    vals, ids, terms = _route_terms(cfg, wg, xt)
    return vals, ids, torch.sum(terms)


def _moe_shard_body(cfg: ModelConfig, p, x, m: int = 0, tp: int = 1,
                    route=None):
    """Rank ``m`` of ``tp``'s share of the capacity-bounded MoE,
    x (B, S, D) -> (partial (B, S, D), partial aux): the counterpart of
    ``repro.models.moe._moe_shard_body``.  ``p`` holds the router ``wg``
    (D, E) whole and this rank's E/tp experts [m E/tp, (m+1) E/tp) of
    ``w1`` / ``w3`` / ``w2``.  Routing runs on the whole x; the choices
    kept are those of a local expert whose rank among their expert's
    choices (flat order over x's T tokens) is below C =
    ``expert_capacity(cfg, T)``: that rank is the same counted over all
    experts or within the block, so ``dispatch_plan`` over local ids (the
    others as E/tp, dropped) drops what the reference drops.  The partial
    output sums the local experts' weighted outputs and the partial aux
    the local experts' terms: each sums over the ranks (the caller's
    all-reduce) to the layer's.  At tp = 1 it is ``_moe_local``.

    With a non-trivial group ``route`` x is this rank's rows of a batch
    split over the group in order, routed as the whole batch is
    (``_spread_route_terms``): C counts every rank's tokens, expert e
    keeps C less the earlier ranks' choices of e, and the partial aux is
    this rank's share of the whole batch's."""
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    T, k, E = xt.shape[0], cfg.experts_per_token, cfg.num_experts
    El = E // tp
    lo = m * El
    if p["w1"].shape[0] != El:
        raise ValueError(f"_moe_shard_body: {p['w1'].shape[0]} local "
                         f"experts, {E}/{tp} expected")
    if route is None or route.trivial:
        vals, ids, terms = _route_terms(cfg, p["wg"], xt)
        capacity = expert_capacity(cfg, T)
    else:
        vals, ids, terms, before, T_all = _spread_route_terms(
            cfg, p["wg"], xt, route)
        capacity = (expert_capacity(cfg, T_all)
                    - before[lo:lo + El]).clamp(min=0)
    flat = ids.reshape(-1)
    local = torch.where((flat >= lo) & (flat < lo + El), flat - lo, El)
    plan = moe_ops.dispatch_plan(local, El, moe_ops.pick_block_t(T * k, E),
                                 capacity=capacity)
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    y = moe_ops.grouped_ffn(moe_ops.gather_rows(xt, plan, tok), plan,
                            p["w1"], p["w3"], p["w2"],
                            act=layers.activation(cfg))
    # dropped choices read zero rows and weigh 0, as the reference's fill
    gathered = y[moe_ops.combine_index(plan)]
    w = torch.where(plan.keep, vals.reshape(-1), 0.0).to(x.dtype)
    out = (gathered * w[:, None]).reshape(T, k, D).sum(1)
    return out.reshape(B, S, D), torch.sum(terms[lo:lo + El])


def _moe_local(cfg: ModelConfig, p, x):
    """Capacity-bounded MoE on one device, x (B, S, D) -> ((B, S, D),
    aux), through the grouped GEMM on the kept choices."""
    return _moe_shard_body(cfg, p, x)


def moe_fwd(cfg: ModelConfig, p, x, m: int = 0, tp: int = 1, route=None):
    """MoE with shared experts, x (B, S, D) -> ((B, S, D), aux); rank
    ``m`` of ``tp``'s partial (output, aux) over its experts
    (``_moe_shard_body``, routed over the data group ``route`` where one
    is given) and its columns of the shared experts, which sum over the
    ranks to the layer's."""
    y, aux = _moe_shard_body(cfg, p, x, m, tp, route)
    if cfg.num_shared_experts > 0:
        y = y + layers.mlp_fwd(cfg, p["shared"], x)
    return y, aux


def moe_ref(cfg: ModelConfig, p, x):
    """Oracle: the exact dense computation over all experts, no capacity
    drops (fp32 sums)."""
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    vals, ids, _ = _route(cfg, p["wg"], xt)
    act = layers.activation(cfg)
    xf = xt.float()
    w_full = torch.zeros((xt.shape[0], cfg.num_experts),
                         dtype=torch.float32, device=x.device)
    w_full.scatter_(1, ids, vals)
    out = torch.zeros((xt.shape[0], D), dtype=torch.float32,
                      device=x.device)
    for e in range(cfg.num_experts):
        h = act(xf @ p["w1"][e].float()) * (xf @ p["w3"][e].float())
        out += w_full[:, e:e + 1] * (h @ p["w2"][e].float())
    y = out.reshape(B, S, D).to(x.dtype)
    if cfg.num_shared_experts > 0:
        y = y + layers.mlp_fwd(cfg, p["shared"], x)
    return y
