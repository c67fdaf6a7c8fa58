"""Chunked online-softmax attention: the plain PyTorch version of prefill
attention.

Forward of ``repro.models.flash._flash_fwd_impl`` (the contract the JAX
package's prefill runs): GQA with flat q heads (B, Sq, H, dh) against
grouped k (B, Skv, Hkv, dh) and v (B, Skv, Hkv, dv) without repeating
K/V, explicit q/kv positions, causal and sliding-window masks, a tanh
logit softcap, and Sq != Skv.  dv may differ from dh (MLA's prefill: q/k
heads of 192, v heads of 128); the scale is 1/sqrt(dh).  Softmax
statistics are fp32.  Unlike the JAX scan, the loop takes a ragged last
chunk, so Skv need not be a multiple of the chunk and keys are masked at
the true Skv.

``kernels/flash_attention`` holds the Hopper kernel of the same contract;
its wrapper runs this function for tensors on the CPU.
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
                    chunk: int = 512):
    """q (B,Sq,H,dh), k (B,Skv,Hkv,dh), v (B,Skv,Hkv,dv), positions
    (B,Sq)/(B,Skv) int -> (B,Sq,H,dv) in q's dtype."""
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
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, Sq, H, dv).to(q.dtype)
