"""RG-LRU recurrent block (RecurrentGemma, arXiv:2402.19427).

PyTorch counterpart of ``repro.models.rglru``, as plain functions on
tensors.  Prefill evaluates the linear recurrence h_t = a_t * h_{t-1} + b_t
(per element of the lru width, fp32) as a log-depth scan over the
sequence: log2(S) rounds of the combine (a1, b1), (a2, b2) -> (a1 * a2,
b1 * a2 + b2) over (B, S, W), where the JAX package runs
``jax.lax.associative_scan`` with the same combine (another tree of the
same products: the two agree to fp32 rounding).  Decode is the O(1) step.
No TPU kernel computes the recurrence (the JAX package leaves it to XLA),
and the port's ``ssd_scan`` kernel does not fit it: its decay is one
scalar per (batch, head, chunk), here every element has its own.

Under autograd (training) the scan runs through ``LinearScanFn``: the
forward keeps a and h (two (B, S, W) fp32 tensors), and the backward runs
the adjoint recurrence G_t = dh_t + a_{t+1} G_{t+1}, the same scan over
the reversed sequence, so that db = G and da_t = G_t h_{t-1}.  Autograd
through the log-depth scan itself would keep each round's a and b, 2
ceil(log2 S) tensors of that size (26 at S = 8192).

Gates are block-diagonal with ``RG_BLOCKS`` = 16 blocks, as the reference
has them; gates and the recurrence run in fp32, projections and the
causal convolution in the model dtype.  The conv cache holds the last K-1
raw projections; for S < K-1 it is left-padded with zeros (stepwise decode
from a zero cache holds them so), where the reference's slice
``uraw[:, S-(K-1):]`` takes a wrapped, too-short window.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import compat
from repro_torch.models.api import ModelConfig
from repro_torch.models.ssm import _causal_conv, _conv_step

RG_BLOCKS = 16
_C = 8.0            # RG-LRU temperature
K_CONV = 4


def param_spec(cfg: ModelConfig, stack=()):
    """(shape, init[, dtype]) of each leaf of ``repro.models.rglru
    .init_rglru`` with a leading ``stack``: init is a normal draw's std,
    "zeros" or "lam" (``lam_init``); ``lam`` stays fp32."""
    D, W, L = cfg.d_model, cfg.lru_width, cfg.num_layers
    nb, wb = RG_BLOCKS, cfg.lru_width // RG_BLOCKS
    s = tuple(stack)
    sc = 1.0 / math.sqrt(D)
    return {
        "wx": (s + (D, W), sc), "wgate": (s + (D, W), sc),
        "conv": (s + (K_CONV, W), 1.0 / math.sqrt(K_CONV)),
        "Wa": (s + (nb, wb, wb), 1.0 / math.sqrt(wb)),
        "ba": (s + (nb, wb), "zeros"),
        "Wi": (s + (nb, wb, wb), 1.0 / math.sqrt(wb)),
        "bi": (s + (nb, wb), "zeros"),
        "lam": (s + (W,), "lam", "float32"),
        "wout": (s + (W, D), 1.0 / math.sqrt(W) / math.sqrt(max(L, 1))),
    }


def lam_init(shape, gen, device=None):
    """The reference's Lambda init: softplus^-1(-log(u) / 2c) for u drawn
    uniformly in [0.9^2, 0.999^2], so that a^c lies in [0.9, 0.999]."""
    u = torch.rand(shape, generator=gen, device=device) \
        * (0.999 ** 2 - 0.9 ** 2) + 0.9 ** 2
    return torch.log(torch.exp(-torch.log(u) / (2 * _C)) - 1.0)


def _block_diag(u, W, b):
    """u (B,S,width) @ block-diag W (nb,wb,wb) + b (nb,wb)."""
    B, S, width = u.shape
    nb, wb = W.shape[0], W.shape[1]
    ub = u.reshape(B, S, nb, wb)
    return (torch.einsum("bsnw,nwv->bsnv", ub, W) + b).reshape(B, S, width)


def _gates(p, u):
    """(a, b) of the recurrence, fp32 (B,S,W): a = exp(-c r softplus(lam)),
    b = sqrt(1 - a^2) * i * u."""
    r = torch.sigmoid(_block_diag(u, p["Wa"], p["ba"]).float())
    i = torch.sigmoid(_block_diag(u, p["Wi"], p["bi"]).float())
    log_a = -_C * r * F.softplus(p["lam"])                     # (B,S,W) <= 0
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, mult * i * u.float()


def linear_scan(a, b):
    """h_t = a_t * h_{t-1} + b_t over axis 1 from h_{-1} = 0, for a, b
    (B, S, W): ceil(log2 S) rounds, each combining every position with
    the one ``d`` before it (d = 1, 2, 4, ...)."""
    S, d = a.shape[1], 1
    while d < S:
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


class LinearScanFn(torch.autograd.Function):
    """``linear_scan`` under autograd: h (B, S, W) fp32 from a and b; the
    backward is the adjoint recurrence G_t = dh_t + a_{t+1} G_{t+1} (G_{S-1}
    = dh_{S-1}), run by ``linear_scan`` over the reversed sequence with a
    shifted by one, then db = G and da_t = G_t h_{t-1} (h_{-1} = 0).  Saves
    a and h only."""

    @staticmethod
    def forward(ctx, a, b):
        with torch.no_grad():
            h = linear_scan(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        nxt = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
        g = linear_scan(nxt.flip(1), dh.flip(1)).flip(1)
        prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
        return g * prev, g


def rglru_fwd(cfg: ModelConfig, p, x, *, return_state=False):
    """Full-sequence RG-LRU block. x (B,S,D) -> (B,S,D); with
    ``return_state`` also the decode cache {state (B,W) fp32, conv
    (B,K-1,W)}.  Differentiable (the scan through ``LinearScanFn`` while
    autograd records).

    ``p`` may be one rank's channel shard (the ``tp`` and ``decode``
    regimes, ``distributed/sharding.py``): channels [m W/tp, (m+1) W/tp)
    of ``wx``, ``wgate``, ``conv`` and ``lam`` are gate blocks [m
    ``RG_BLOCKS``/tp, (m+1) ``RG_BLOCKS``/tp) of ``Wa``, ``Wi``, ``ba``
    and ``bi``, so the gates and the recurrence are the rank's own,
    ``wout``'s rows give its partial output (the ranks' sum is the
    block's) and its cache is its shard of the decode cache; the widths
    are read off the leaves."""
    gate = torch.matmul(x, p["wgate"])
    uraw = torch.matmul(x, p["wx"])
    u = F.silu(_causal_conv(uraw, p["conv"]))
    a, bterm = _gates(p, u)
    if torch.is_grad_enabled() and (a.requires_grad or bterm.requires_grad):
        h = LinearScanFn.apply(a, bterm)
    else:
        h = linear_scan(a, bterm)
    h = h.to(x.dtype)
    y = h * F.gelu(gate, approximate="tanh")
    out = torch.matmul(y, p["wout"])
    if not return_state:
        return out
    S, K = x.shape[1], p["conv"].shape[0]
    if S < K - 1:
        uraw = F.pad(uraw, (0, 0, K - 1 - S, 0))
    return out, {"state": h[:, -1].float(),
                 "conv": uraw[:, uraw.shape[1] - (K - 1):, :]}


def rglru_decode(cfg: ModelConfig, p, x, cache):
    """One-token step. x (B,1,D); cache {state (B,W) fp32, conv (B,K-1,W)},
    written in place; returns (out, cache)."""
    gate = torch.matmul(x, p["wgate"])
    uraw = torch.matmul(x, p["wx"])
    u, conv_c = _conv_step(uraw, cache["conv"], p["conv"])
    u = F.silu(u)
    a, bterm = _gates(p, u)                                    # (B,1,W)
    h = cache["state"] * a[:, 0] + bterm[:, 0]
    y = h[:, None, :].to(x.dtype) * F.gelu(gate, approximate="tanh")
    out = torch.matmul(y, p["wout"])
    cache["state"].copy_(h)
    cache["conv"].copy_(conv_c)
    return out, cache


def init_rglru_cache(cfg: ModelConfig, B: int, dtype=torch.bfloat16,
                     device=None):
    dev = compat.resolve_device(device)
    return {"state": torch.zeros((B, cfg.lru_width), dtype=torch.float32,
                                 device=dev),
            "conv": torch.zeros((B, K_CONV - 1, cfg.lru_width), dtype=dtype,
                                device=dev)}
