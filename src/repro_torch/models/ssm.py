"""Mamba-2 (SSD, state-space duality) block.

PyTorch counterpart of ``repro.models.ssm``, as plain functions on
tensors: prefill runs the chunked SSD algorithm (a quadratic term within
each chunk, a state recurrence between chunks: arXiv:2405.21060 Alg. 1)
and decode the O(1) recurrent step.  The recurrence between chunks runs
through the ``ssd_scan`` kernel (``kernels/ssd_scan``): the Hopper kernel
for CUDA tensors, its plain version for CPU tensors, as ``SsdScanFn``,
whose backward (training) is the ``ssd_scan_bwd`` kernel's adjoint
recurrence; everything else here is torch ops autograd follows (the exponent masked to ``MASK_EXP`` above
the diagonal before ``exp``, as the reference masks it, so that no
gradient meets an overflow).

The reference's numerics are kept where they depart from upstream
Mamba-2: the gated norm is ``rms_norm(y) * silu(z)``, the exponent mask
is -60, B/C are shared by the heads of a group, ``dt`` is projected in
the model dtype and then softplus'd in fp32 with ``dt_bias``.
Projections and the causal convolutions run in the model dtype,
``ssd_chunked`` in fp32.  Conv caches hold the raw projections (model
dtype), the state is fp32.

Layout: ``ssd_chunked`` works per (batch, head, chunk) — the chunked
inputs are (b, h, nc, Q, ...) — so the chunk states reach the kernel as
(b, h, nc, n, p) straight from their product and ``prev`` is read in that
layout: no transposed copy of either.  Products are written as explicit
pairwise matmuls (no three-operand einsum), so every intermediate is
known.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import compat
from repro_torch.kernels.ssd_scan.ops import SsdScanFn
from repro_torch.models import layers
from repro_torch.models.api import ModelConfig

MASK_EXP = -60.0        # the reference's exponent for j > i


def param_spec(cfg: ModelConfig, stack=()):
    """(shape, init[, dtype]) of each leaf of ``repro.models.ssm.init_ssm``
    with a leading ``stack``: init is a normal draw's std, "ones",
    "zeros" or "a_log" (log(linspace(1, 16, H)), the reference's fixed
    A_log); ``dt_bias``, ``A_log`` and ``D_skip`` stay fp32."""
    D, W, L = cfg.d_model, cfg.d_inner, cfg.num_layers
    H, K = cfg.ssm_heads, cfg.ssm_conv
    GN = cfg.ssm_groups * cfg.ssm_state
    sc, ksc = 1.0 / math.sqrt(D), 1.0 / math.sqrt(K)
    s = tuple(stack)
    return {
        "wz": (s + (D, W), sc), "wx": (s + (D, W), sc),
        "wB": (s + (D, GN), sc), "wC": (s + (D, GN), sc),
        "wdt": (s + (D, H), sc),
        "dt_bias": (s + (H,), "zeros", "float32"),
        "A_log": (s + (H,), "a_log", "float32"),
        "D_skip": (s + (H,), "ones", "float32"),
        "conv_x": (s + (K, W), ksc), "conv_B": (s + (K, GN), ksc),
        "conv_C": (s + (K, GN), ksc),
        "norm_w": (s + (W,), "ones"),
        "wout": (s + (W, D), 1.0 / math.sqrt(W) / math.sqrt(max(L, 1))),
    }


def a_log_init(n_heads: int, device=None):
    return torch.log(torch.linspace(1.0, 16.0, n_heads, dtype=torch.float32,
                                    device=device))


def _causal_conv(x, w):
    """Depthwise causal conv. x (B,S,C), w (K,C); the reference's sum of
    K shifted products, in the same order and dtype."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    return out


def _conv_step(x, conv_cache, w):
    """x (B,1,C); conv_cache (B,K-1,C) holds the previous K-1 inputs.
    Returns (out (B,1,C), the new cache (B,K-1,C))."""
    window = torch.cat([conv_cache, x], dim=1)                 # (B,K,C)
    out = torch.einsum("bkc,kc->bc", window, w)[:, None, :]
    return out, window[:, 1:, :]


def ssd_chunked(xh, dt, A, Bm, Cm, *, chunk=64):
    """Chunked SSD scan.

    xh (b,s,h,p); dt (b,s,h) fp32 post-softplus; A (h,) fp32 negative;
    Bm/Cm (b,s,g,n).  Returns (y (b,s,h,p) fp32, final_state (b,h,n,p)).
    A sequence longer than ``chunk`` must be a multiple of it (the
    reference asserts the same; padding would fold into the state)."""
    b, s, h, p = xh.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    Q = min(chunk, s)
    if s % Q:
        raise ValueError(f"ssd_chunked: sequence length {s} is not a "
                         f"multiple of the chunk {Q}")
    nc = s // Q
    f32 = torch.float32
    # per (batch, head, chunk): x (b,h,nc,Q,p), dt (b,h,nc,Q)
    X = xh.permute(0, 2, 1, 3).to(f32).reshape(b, h, nc, Q, p)
    dtc = dt.permute(0, 2, 1).reshape(b, h, nc, Q)
    # B / C per group, (b,g,1,nc,Q,n): broadcast over the group's heads
    Bg = Bm.to(f32).permute(0, 2, 1, 3).reshape(b, g, 1, nc, Q, n)
    Cg = Cm.to(f32).permute(0, 2, 1, 3).reshape(b, g, 1, nc, Q, n)

    def heads(t):                   # (b,g,rep,nc,...) -> (b,h,nc,...)
        return t.reshape((b, h) + t.shape[3:])

    def by_group(t):                # (b,h,nc,...) -> (b,g,rep,nc,...)
        return t.reshape((b, g, rep) + t.shape[2:])

    cums = torch.cumsum(dtc * A[:, None, None], dim=-1)        # (b,h,nc,Q)
    # --- within each chunk (quadratic) ---
    scores = torch.matmul(Cg, Bg.transpose(-1, -2))            # (b,g,1,nc,i,j)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=xh.device).tril()
    delta = cums[..., :, None] - cums[..., None, :]            # (b,h,nc,i,j)
    delta = torch.where(tri, delta, MASK_EXP)
    Lw = torch.exp(delta) * dtc[..., None, :]                  # dt_j
    M = heads(scores * by_group(Lw))
    y = torch.matmul(M, X)                                     # (b,h,nc,Q,p)
    del delta, Lw, M
    # --- chunk states, (b,h,nc,n,p) ---
    decay_end = torch.exp(cums[..., -1:] - cums)               # (b,h,nc,Q)
    Xw = X * (dtc * decay_end)[..., None]
    states = heads(torch.matmul(Bg.transpose(-1, -2), by_group(Xw)))
    del Xw
    chunk_decay = torch.exp(cums[..., -1]).contiguous()        # (b,h,nc)
    prev, final = SsdScanFn.apply(states.contiguous(), chunk_decay)
    del states
    # --- between chunks ---
    y_inter = heads(torch.matmul(Cg, by_group(prev)))          # (b,h,nc,Q,p)
    y = y + y_inter * torch.exp(cums)[..., None]
    return y.reshape(b, h, s, p).permute(0, 2, 1, 3), final


def gated_norm(y, w, z, group=None, eps: float = 1e-6):
    """The gated norm ``rms_norm(y, w) * silu(z)`` over the last dim.
    Over a model ``group`` y, w and z are the rank's equal shard of that
    dim (the split channels): the mean square is the mean of the ranks'
    means, their sum through ``group.reduce_whole`` (all-reduced forward
    and backward: every rank's output depends on every rank's channels)
    over the group's size.  A trivial group (or none) is ``rms_norm``; a
    group of one whose collectives are sent gives its bits too (the sum
    of one term, over 1)."""
    if group is None or group.trivial:
        return layers.rms_norm(y, w, eps) * F.silu(z)
    yf = y.float()
    ms = group.reduce_whole(torch.mean(yf * yf, dim=-1, keepdim=True))
    yf = yf * torch.rsqrt(ms / group.size + eps)
    return yf.to(y.dtype) * w * F.silu(z)


def ssm_fwd(cfg: ModelConfig, p, x, *, chunk=64, return_state=False,
            group=None):
    """Full-sequence Mamba-2 block. x (B,S,D) -> (B,S,D); with
    ``return_state`` also the decode cache {conv_x, conv_B, conv_C,
    state}.  For S < K-1 the conv caches are zero-padded on the left, as
    stepwise decode from a zero cache holds them.

    ``p`` may be one rank's channel shard (the ``tp`` and ``decode``
    regimes, ``distributed/sharding.py``): ``wz``, ``wx``, ``conv_x``,
    ``norm_w`` and ``wout``'s rows over its W/tp channels, ``wdt``,
    ``dt_bias``, ``A_log`` and ``D_skip`` over their H/tp heads, B and C
    whole (one group, shared by every head); the widths are read off the
    leaves.  The convolutions and the scan are then the rank's own, the
    gated norm's mean square is taken over ``group`` (``gated_norm``)
    and the output is the rank's partial, which the ranks' sum makes the
    block's; its cache is the rank's shard of the decode cache."""
    B, S, D = x.shape
    H, P, N = p["A_log"].shape[-1], cfg.ssm_head_dim, cfg.ssm_state
    W = p["wx"].shape[-1]
    z = torch.matmul(x, p["wz"])
    uraw = torch.matmul(x, p["wx"])
    Braw = torch.matmul(x, p["wB"])
    Craw = torch.matmul(x, p["wC"])
    u = F.silu(_causal_conv(uraw, p["conv_x"]))
    Bm = F.silu(_causal_conv(Braw, p["conv_B"]))
    Cm = F.silu(_causal_conv(Craw, p["conv_C"]))
    dt = F.softplus(torch.matmul(x, p["wdt"]).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = u.reshape(B, S, H, P)
    y, Hlast = ssd_chunked(xh, dt, A, Bm.reshape(B, S, cfg.ssm_groups, N),
                           Cm.reshape(B, S, cfg.ssm_groups, N), chunk=chunk)
    y = y + p["D_skip"][:, None] * xh.float()
    y = y.reshape(B, S, W).to(x.dtype)
    y = gated_norm(y, p["norm_w"], z, group)
    out = torch.matmul(y, p["wout"])
    if not return_state:
        return out
    K = cfg.ssm_conv

    def tail(t):                    # the last K-1 raw inputs
        if S < K - 1:
            t = F.pad(t, (0, 0, K - 1 - S, 0))
        return t[:, t.shape[1] - (K - 1):, :]

    return out, {"conv_x": tail(uraw), "conv_B": tail(Braw),
                 "conv_C": tail(Craw), "state": Hlast}


def ssm_decode(cfg: ModelConfig, p, x, cache, group=None):
    """One-token recurrent step. x (B,1,D); cache as ``init_ssm_cache``
    gives it.  Its leaves are written in place; returns (out, cache).  A
    rank's channel shard of ``p`` and of the cache (state over its heads,
    ``conv_x`` over its channels) gives its partial, as ``ssm_fwd``."""
    B = x.shape[0]
    H, P, N, g = p["A_log"].shape[-1], cfg.ssm_head_dim, cfg.ssm_state, \
        cfg.ssm_groups
    z = torch.matmul(x, p["wz"])
    uraw = torch.matmul(x, p["wx"])
    Braw = torch.matmul(x, p["wB"])
    Craw = torch.matmul(x, p["wC"])
    u, cx = _conv_step(uraw, cache["conv_x"], p["conv_x"])
    Bm, cB = _conv_step(Braw, cache["conv_B"], p["conv_B"])
    Cm, cC = _conv_step(Craw, cache["conv_C"], p["conv_C"])
    u, Bm, Cm = F.silu(u), F.silu(Bm), F.silu(Cm)
    dt = F.softplus(torch.matmul(x, p["wdt"]).float()
                    + p["dt_bias"])[:, 0]                      # (B,H)
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A)                                      # (B,H)
    xh = u[:, 0].reshape(B, H, P).float()
    Bh = Bm[:, 0].reshape(B, g, 1, N).expand(B, g, H // g, N) \
        .reshape(B, H, N).float()
    Ch = Cm[:, 0].reshape(B, g, 1, N).expand(B, g, H // g, N) \
        .reshape(B, H, N).float()
    state = cache["state"] * a[:, :, None, None] + \
        (Bh * dt[:, :, None])[..., None] * xh[:, :, None, :]
    y = torch.matmul(Ch[:, :, None, :], state)[:, :, 0] + \
        p["D_skip"][:, None] * xh
    y = y.reshape(B, 1, p["wx"].shape[-1]).to(x.dtype)
    y = gated_norm(y, p["norm_w"], z, group)
    out = torch.matmul(y, p["wout"])
    for name, new in (("conv_x", cx), ("conv_B", cB), ("conv_C", cC),
                      ("state", state)):
        cache[name].copy_(new)
    return out, cache


def init_ssm_cache(cfg: ModelConfig, B: int, dtype=torch.bfloat16,
                   device=None):
    dev = compat.resolve_device(device)
    H, P, N, K = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv
    GN = cfg.ssm_groups * N
    return {
        "conv_x": torch.zeros((B, K - 1, cfg.d_inner), dtype=dtype,
                              device=dev),
        "conv_B": torch.zeros((B, K - 1, GN), dtype=dtype, device=dev),
        "conv_C": torch.zeros((B, K - 1, GN), dtype=dtype, device=dev),
        "state": torch.zeros((B, H, N, P), dtype=torch.float32, device=dev),
    }
