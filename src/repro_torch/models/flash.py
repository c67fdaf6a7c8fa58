"""Chunked online-softmax attention: the plain PyTorch version of prefill
attention and of its backward.

Forward of ``repro.models.flash._flash_fwd_impl`` (the contract the JAX
package's prefill runs): GQA with flat q heads (B, Sq, H, dh) against
grouped k (B, Skv, Hkv, dh) and v (B, Skv, Hkv, dv) without repeating
K/V, explicit q/kv positions, causal and sliding-window masks, a tanh
logit softcap, and Sq != Skv.  dv may differ from dh (MLA's prefill: q/k
heads of 192, v heads of 128); the scale is 1/sqrt(dh).  Softmax
statistics are fp32.  Unlike the JAX scan, the loop takes a ragged last
chunk, so Skv need not be a multiple of the chunk and keys are masked at
the true Skv.

``flash_attention(..., return_lse=True)`` also returns the rows'
log-sum-exp (B, Sq, H) fp32 in natural-log units of the scaled (and
softcapped) scores, ``m + log(max(l, 1e-30))``: what the backward needs
in place of JAX's (m, l) residuals.  ``flash_attention_bwd`` is the
backward of ``repro.models.flash._bwd``: D = rowsum(dO * O), then chunk by
chunk P recomputed from the scores and ``lse``, dV = P^T dO, dP = dO V^T,
dS = P (dP - D) times the softcap's chain factor and the mask, dQ += dS K,
dK = dS^T Q, with dK and dV folded over the G q heads of each kv head.

``kernels/flash_attention`` holds the Hopper kernel of the forward and
``kernels/flash_attention_bwd`` that of the backward; their wrappers run
these functions for tensors on the CPU.
"""
from __future__ import annotations

import math

import torch

NEG = -1e30


def _mask(q_pos, kv_pos, causal: bool, window: int):
    """(B, Sq, c) bool: may query position attend to key position."""
    m = torch.ones(q_pos.shape + kv_pos.shape[1:], dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= kv_pos[:, None, :] <= q_pos[:, :, None]
    if window > 0:
        m &= kv_pos[:, None, :] > (q_pos[:, :, None] - window)
    return m


def flash_attention(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                    window: int = 0, softcap: float = 0.0,
                    chunk: int = 512, return_lse: bool = False):
    """q (B,Sq,H,dh), k (B,Skv,Hkv,dh), v (B,Skv,Hkv,dv), positions
    (B,Sq)/(B,Skv) int -> (B,Sq,H,dv) in q's dtype; with ``return_lse``
    (out, lse (B,Sq,H) fp32)."""
    B, Sq, H, dh = q.shape
    Skv, Hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // Hkv
    c = min(chunk, Skv)
    scale = 1.0 / math.sqrt(dh)
    qf = (q.float() * scale).reshape(B, Sq, Hkv, G, dh)
    m = torch.full((B, Sq, Hkv, G), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Sq, Hkv, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, Hkv, G, dv), dtype=torch.float32,
                      device=q.device)
    for s0 in range(0, Skv, c):
        kb = k[:, s0:s0 + c].float()
        vb = v[:, s0:s0 + c].float()
        s = torch.einsum("bqhgd,bchd->bqhgc", qf, kb)
        if softcap > 0:
            s = torch.tanh(s / softcap) * softcap
        msk = _mask(q_pos, kv_pos[:, s0:s0 + c], causal, window)
        s = torch.where(msk[:, :, None, None, :], s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqhgc,bchd->bqhgd", p, vb)
        m = m_new
    lsafe = torch.clamp_min(l, 1e-30)
    out = (acc / lsafe[..., None]).reshape(B, Sq, H, dv).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(lsafe)).reshape(B, Sq, H)
    return out


def flash_attention_bwd(q, k, v, q_pos, kv_pos, out, lse, dout, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0, chunk: int = 512):
    """The gradients (dq, dk, dv) of ``flash_attention`` at q, k, v, in
    their dtypes, from its output ``out``, its ``lse`` (B,Sq,H) and the
    output's gradient ``dout`` (B,Sq,H,dv).  Sums in fp32; a ragged last
    chunk is taken, keys are masked at the true Skv."""
    B, Sq, H, dh = q.shape
    Skv, Hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // Hkv
    c = min(chunk, Skv)
    scale = 1.0 / math.sqrt(dh)
    qf = q.float().reshape(B, Sq, Hkv, G, dh)
    dof = dout.float().reshape(B, Sq, Hkv, G, dv)
    D = (dof * out.float().reshape(B, Sq, Hkv, G, dv)).sum(-1)
    lse = lse.float().reshape(B, Sq, Hkv, G)
    dq = torch.zeros((B, Sq, Hkv, G, dh), dtype=torch.float32,
                     device=q.device)
    dks, dvs = [], []
    for s0 in range(0, Skv, c):
        kb = k[:, s0:s0 + c].float()
        vb = v[:, s0:s0 + c].float()
        s = torch.einsum("bqhgd,bchd->bqhgc", qf * scale, kb)
        if softcap > 0:
            s = torch.tanh(s / softcap) * softcap
        msk = _mask(q_pos, kv_pos[:, s0:s0 + c], causal,
                    window)[:, :, None, None, :]
        s = torch.where(msk, s, NEG)
        p = torch.exp(s - lse[..., None])
        dvs.append(torch.einsum("bqhgc,bqhgd->bchd", p, dof))
        dp = torch.einsum("bqhgd,bchd->bqhgc", dof, vb)
        ds = p * (dp - D[..., None])
        if softcap > 0:
            ds = ds * (1.0 - torch.square(s / softcap))
        ds = torch.where(msk, ds, 0.0)
        dq += torch.einsum("bqhgc,bchd->bqhgd", ds, kb) * scale
        dks.append(torch.einsum("bqhgc,bqhgd->bchd", ds, qf) * scale)
    return (dq.reshape(B, Sq, H, dh).to(q.dtype),
            torch.cat(dks, 1).to(k.dtype), torch.cat(dvs, 1).to(v.dtype))
