"""Core layers of the models: norms (RMSNorm, LayerNorm), RoPE and
sinusoid positions, GQA and MLA attention, cross-attention on encoder
states, sliding-window attention over a ring cache, gated MLP.

PyTorch counterpart of ``repro.models.layers``, with the same numerics
order (norm reductions and softmax statistics in fp32, activations in
``cfg.dtype``) and the same layouts:
q heads flat (B, S, H, dh), k/v grouped (B, S, Hkv, dh), weights in the
JAX einsum layouts ``wq (D,H,dh)``, ``wo (H,dh,D)``, ``w1 (D,F)``, and
MLA's ``wq_b (r_q,H,dn+dr)``, ``wk_b / wv_b (r_kv,H,dn)``.

Attention runs through the Hopper kernels of ``repro_torch.kernels``:
full-sequence attention through ``flash_attention`` (MLA's prefill too,
at q/k heads of dn + dr and v heads of dn; an encoder's self-attention
and cross-attention non-causal, the latter at Sq != Skv) and one-token
GQA decode through ``paged_attention`` (a dense cache is a page pool with
the identity table; cross-attention decode reads the encoder's K/V cache
the same way).  MLA's absorbed decode attends over the latent cache in
fp32 PyTorch, as the JAX package's einsums do: no TPU kernel computes
it.  So does sliding-window decode over a ring cache
(``ring_decode_shard``: H2O-Danube, RecurrentGemma's local attention),
whose window and softcap lie outside the paged kernel's contract.  On
CPU tensors the kernel wrappers run their plain PyTorch versions.  In
the decode regime of the multi-GPU path each rank attends over its
sequence shard of the cache (``decode_attention_shard``: the
paged kernel with its log-sum-exp output; MLA's latent shard,
``mla_decode_shard``; a ring's block of slots, ``ring_decode_shard``) and
the ranks' partial attentions merge over the model group
(``merge_shards``, flash-decoding's merge, which the reference gets from
XLA's partitioning of its whole-cache einsum).

Caches are written in place (the JAX package donates them instead):
``cache_update``, ``attention_decode`` and ``mla_decode`` return the
same tensors they were given.

``cfg.logit_softcap`` caps the attention scores as well as the logits,
as the reference applies it (``repro.models.layers.attention_fwd`` and
``decode_attention_ring``); the port follows it.
"""
from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.models.api import ModelConfig

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x, w, eps: float = 1e-6):
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return xf.to(dt) * w


def layer_norm(x, w, b, eps: float = 1e-5):
    """LayerNorm with fp32 statistics, normalised in fp32, cast, then the
    affine in x's dtype (the reference's order)."""
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(dt) * w + b


def apply_norm(cfg: ModelConfig, p, x):
    if cfg.norm == "rmsnorm":
        return rms_norm(x, p["w"])
    return layer_norm(x, p["w"], p["b"])


# ---------------------------------------------------------------------------
# RoPE (rotate-half / neox convention)
# ---------------------------------------------------------------------------


def rope_tables(positions, dh: int, theta: float):
    """fp32 (cos, sin), each (B, S, dh/2), for ``positions`` (B, S).  All
    layers of one forward share them."""
    half = dh // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                        device=positions.device)
                           * 2.0 / dh))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, tables):
    """Rotate x (B, S, ..., dh) by precomputed ``rope_tables``."""
    cos, sin = tables
    half = cos.shape[-1]
    shape = cos.shape[:2] + (1,) * (x.dim() - 3) + (half,)
    cos, sin = cos.reshape(shape), sin.reshape(shape)
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     -1).to(x.dtype)


def rope(x, positions, theta: float):
    """x: (B, S, ..., dh); positions: (B, S)."""
    return apply_rope(x, rope_tables(positions, x.shape[-1], theta))


def sinusoid_pos(positions, d: int, dtype):
    """Whisper-style sinusoid embedding: positions (B, S) -> (B, S, d),
    [sin | cos] of fp32 angles, cast to ``dtype``."""
    half = d // 2
    inv = torch.exp(-torch.arange(half, dtype=torch.float32,
                                  device=positions.device)
                    * (math.log(10000.0) / max(half - 1, 1)))
    ang = positions.float()[..., None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


def rope_dim(cfg: ModelConfig) -> int:
    """The width RoPE rotates: MLA's ``rope_head_dim`` slice, else the
    whole head."""
    return cfg.rope_head_dim if cfg.use_mla else cfg.head_dim


# ---------------------------------------------------------------------------
# Attention cores
# ---------------------------------------------------------------------------


def chunked_attention(q, k, v, q_positions, kv_positions, *,
                      causal: bool = True, window: int = 0,
                      softcap: float = 0.0):
    """Full-sequence attention (prefill): the ``flash_attention`` kernel."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           q_positions.to(torch.int32).contiguous(),
                           kv_positions.to(torch.int32).contiguous(),
                           causal=causal, window=window, softcap=softcap)


def decode_attention(q, k_cache, v_cache, lengths, *, window: int = 0,
                     softcap: float = 0.0, lse=None):
    """One-token attention, q (B, 1, H, dh), against a dense cache
    (B, S, Hkv, dh) whose first ``lengths`` positions are valid.  The cache
    is passed to ``paged_attention`` as the pool (B*S/page, page, Hkv, dh)
    with the identity page table: a view, no copy.  ``lse``: None, or a
    (B, H) fp32 tensor the same launch fills with each row's log-sum-exp
    (``decode_attention_shard``)."""
    if window or softcap:
        raise NotImplementedError(
            "decode attention with a window or a softcap is outside the "
            "paged kernel's contract")
    B, _, H, dh = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    page = math.gcd(S, 16)
    k_pool = k_cache.view(B * S // page, page, Hkv, dh)
    v_pool = v_cache.view(B * S // page, page, Hkv, v_cache.shape[-1])
    table = torch.arange(B * S // page, dtype=torch.int32,
                         device=q.device).reshape(B, S // page)
    o = paged_attention(q.reshape(B, H, dh).contiguous(), k_pool, v_pool,
                        table, lengths.to(torch.int32).contiguous(), lse)
    return o.reshape(B, 1, H, -1)


def decode_attention_shard(q, k_shard, v_shard, lengths, m: int, S_l: int,
                           *, softcap: float = 0.0):
    """Rank ``m``'s part of one-token attention over a cache whose sequence
    is split over the ranks in shards of ``S_l`` positions (the decode
    regime, ``distributed/sharding.py::cache_specs``): q (B, 1, H, dh)
    against its shard (B, S_l, Hkv, dh), i.e. positions [m S_l, (m+1) S_l)
    of each row, of which the first ``lengths`` (global) are valid, so
    ``clamp(lengths - m S_l, 0, S_l)`` locally.  Returns (out (B, 1, H,
    dv) in q's dtype, lse (B, 1, H) fp32): the shard's softmax-weighted
    values and the log-sum-exp of its scores (``NEG``, -1e30, where it
    holds none of the row), which ``merge_shards`` joins across ranks."""
    local = (lengths - m * S_l).clamp(0, S_l)
    B, _, H, _ = q.shape
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device)
    o = decode_attention(q, k_shard, v_shard, local, softcap=softcap,
                         lse=lse)
    return o, lse.reshape(B, 1, H)


def merge_shards(o, lse, group):
    """The attention of the whole sequence from each rank's
    ``decode_attention_shard`` over ``group`` (the model group: flash-
    decoding's merge): M = max over the ranks of lse, w = exp(lse - M),
    then one fp32 sum over the ranks of ``[w o, w]`` (concatenated on the
    last dim), and ``sum(w o) / max(sum(w), 1e-30)`` in o's dtype.  ``o``
    (..., dv) and ``lse`` (...) of any leading shape.  A row no rank holds
    (all lse -1e30) gives zeros, as a length-0 row does on one device.  In
    a trivial group (one rank, collectives skipped) ``o`` itself."""
    if group.trivial:
        return o
    M = group.all_reduce(lse, "max")
    w = torch.exp(lse - M)[..., None]
    s = group.all_reduce(torch.cat([o.float() * w, w], dim=-1))
    return (s[..., :-1] / torch.clamp_min(s[..., -1:], 1e-30)).to(o.dtype)


def decode_attention_ring(q, k_cache, v_cache, pos_cache, lengths, *,
                          window: int, softcap: float = 0.0):
    """One-token attention, q (B, 1, H, dh), against a ring cache (B, Wc,
    Hkv, dh) whose slots hold the positions ``pos_cache`` (B, Wc) (-1:
    empty): a slot counts if its position is below ``lengths`` and within
    ``window`` of the newest, ``lengths`` - 1.  fp32 scores and softmax,
    as the reference's einsums.  Returns (out (B, 1, H, dv) in q's dtype,
    lse (B, 1, H) fp32): the log-sum-exp of the counted scores (-1e30
    where no slot counts), what ``merge_shards`` needs of a rank's
    slots."""
    B, _, H, dh = q.shape
    Wc, Hkv, dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[3]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, dh).float() * (1.0 / math.sqrt(dh))
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float())
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    last = lengths[:, None]
    mask = (pos_cache >= 0) & (pos_cache < last) \
        & (pos_cache > last - 1 - window)
    s = torch.where(mask[:, None, None, :], s, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bshd->bhgd", p / torch.clamp_min(l, 1e-30),
                       v_cache.float())
    return out.reshape(B, 1, H, dv).to(q.dtype), \
        (m + torch.log(l)).reshape(B, 1, H)


def cache_update(cache, new, lengths):
    """Write ``new`` (B, 1, ...) at position ``lengths`` of ``cache``
    (B, S, ...), in place: (B, S, Hkv, dh) K/V, or MLA's (B, S, r) latent
    leaves.  Rows whose index falls outside [0, S) are
    no-op writes (finished slots sit at ``lengths == S``)."""
    B, S = cache.shape[0], cache.shape[1]
    rows = torch.arange(B, device=cache.device)
    inb = (lengths >= 0) & (lengths < S)
    idx = lengths.clamp(0, S - 1).long()
    cur = cache[rows, idx]
    val = torch.where(inb.reshape((B,) + (1,) * (cur.dim() - 1)),
                      new[:, 0].to(cache.dtype), cur)
    cache[rows, idx] = val
    return cache


# ---------------------------------------------------------------------------
# GQA attention block (flat q heads)
# ---------------------------------------------------------------------------


def _proj_heads(x, w):
    """x (B,S,D) @ w (D,H,dh) -> (B,S,H,dh)."""
    D, H, dh = w.shape
    return torch.matmul(x, w.reshape(D, H * dh)).reshape(
        x.shape[:-1] + (H, dh))


def _merge_heads(o, wo):
    """o (B,S,H,dh) @ wo (H,dh,D) -> (B,S,D)."""
    H, dh, D = wo.shape
    return torch.matmul(o.reshape(o.shape[:-2] + (H * dh,)),
                        wo.reshape(H * dh, D))


def _q_proj(cfg: ModelConfig, p, x):
    q = _proj_heads(x, p["wq"])
    return q + p["bq"] if cfg.attn_bias else q


def kv_from_states(cfg: ModelConfig, p, states):
    """(k, v), each (B, Se, Hkv, dh), of encoder states (B, Se, D): the
    cross-attention's source, without RoPE."""
    k = _proj_heads(states, p["wk"])
    v = _proj_heads(states, p["wv"])
    if cfg.attn_bias:
        k, v = k + p["bk"], v + p["bv"]
    return k, v


def attention_qkv(cfg: ModelConfig, p, x, positions, *, rope_tab=None,
                  use_rope: bool = True):
    """Projections, with RoPE unless ``use_rope`` is False; ``rope_tab``
    are this forward's shared ``rope_tables`` (computed from
    ``positions`` when absent)."""
    q = _q_proj(cfg, p, x)
    k, v = kv_from_states(cfg, p, x)
    if not use_rope:
        return q, k, v
    tab = rope_tab if rope_tab is not None else rope_tables(
        positions, q.shape[-1], cfg.rope_theta)
    return apply_rope(q, tab), apply_rope(k, tab), v


def attention_fwd(cfg: ModelConfig, p, x, positions, *, rope_tab=None,
                  window=None, causal: bool = True, use_rope: bool = True,
                  kv=None, kv_positions=None):
    """Full-sequence attention over ``window`` keys (``cfg.sliding_window``
    when absent; 0: all), causal unless ``causal`` is False; returns (out,
    (k, v)) for the cache.  With ``kv=(k, v)`` (``kv_from_states`` of
    encoder states) at ``kv_positions`` the queries attend to those
    (cross-attention) and no RoPE is applied to them."""
    if kv is not None:
        q, (k, v), kv_pos = _q_proj(cfg, p, x), kv, kv_positions
    else:
        q, k, v = attention_qkv(cfg, p, x, positions, rope_tab=rope_tab,
                                use_rope=use_rope)
        kv_pos = positions
    w = cfg.sliding_window if window is None else window
    o = chunked_attention(q, k, v, positions, kv_pos, causal=causal,
                          window=w, softcap=cfg.logit_softcap)
    return _merge_heads(o, p["wo"]), (k, v)


def kv_heads_of_rank(cfg: ModelConfig, m: int, tp: int):
    """The kv heads [lo, hi) that rank ``m`` of ``tp``'s q heads [m H/tp,
    (m+1) H/tp) attend to, when the kv heads do not split over ``tp``
    (their weights replicated): Qwen3-30B-A3B's 32 q heads over 4 kv
    heads at tp 8 give rank m kv head m // 2.  Raises when the rank's q
    heads do not map onto whole groups of one size."""
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    Hl, G = H // tp, H // Hkv
    if G % Hl and Hl % G:
        raise NotImplementedError(
            f"{cfg.name}: {Hl} q heads a rank over groups of {G} do not "
            f"map onto whole kv heads")
    lo = m * Hl // G
    return lo, lo + max(Hl // G, 1)


def tp_attention_params(cfg: ModelConfig, p, m: int, tp: int):
    """Rank ``m``'s attention leaves for ``attention_fwd``: ``p`` holds its
    q-head shard of ``wq`` / ``wo`` / ``bq``; kv leaves that split over
    ``tp`` are its shard already, and replicated ones (read through the
    model group's ``copy_in`` by the caller: every rank holds a part of
    their gradient) are sliced to ``kv_heads_of_rank``."""
    if cfg.num_kv_heads % tp == 0:
        return p
    lo, hi = kv_heads_of_rank(cfg, m, tp)
    out = dict(p)
    for name in ("wk", "wv"):
        out[name] = p[name][:, lo:hi]
    for name in ("bk", "bv"):
        if name in p:
            out[name] = p[name][lo:hi]
    return out


def attention_decode(cfg: ModelConfig, p, x, k_cache, v_cache, lengths, *,
                     rope_tab=None, use_rope: bool = True):
    """One-token decode; returns (out, k_cache, v_cache), the caches
    updated in place."""
    q, k, v = attention_qkv(cfg, p, x, lengths[:, None], rope_tab=rope_tab,
                            use_rope=use_rope)
    cache_update(k_cache, k, lengths)
    cache_update(v_cache, v, lengths)
    o = decode_attention(q, k_cache, v_cache, lengths + 1,
                         window=cfg.sliding_window, softcap=cfg.logit_softcap)
    return _merge_heads(o, p["wo"]), k_cache, v_cache


def ring_decode_shard(cfg: ModelConfig, p, x, k_shard, v_shard, pos_shard,
                      lengths, m: int = 0, tp: int = 1, *, window=None,
                      rope_tab=None):
    """Rank ``m`` of ``tp``'s part of one-token sliding-window decode over
    a ring of Wd = ``tp`` Wl slots split over the ranks in blocks of Wl
    (the decode regime, ``distributed/sharding.py::cache_specs``: slots
    [m Wl, (m+1) Wl) of ``k``, ``v`` and ``pos`` here, (B, Wl, Hkv, dh)
    and (B, Wl)).  q, k, v of every head (the attention weights
    replicated); the token at position ``lengths`` goes to slot ``lengths
    % Wd``, written with its position by the rank that holds the slot
    (``cache_update`` drops the others' writes); the rank's slots attended
    as ``decode_attention_ring`` does (their positions are global).
    Returns (out (B, 1, H, dh) in x's dtype, lse (B, 1, H) fp32), which
    ``merge_shards`` joins across ranks; at tp 1 the whole ring's
    attention (``window``: RecurrentGemma's ``local_window``, else
    ``cfg.sliding_window``)."""
    w = cfg.sliding_window if window is None else window
    q, k, v = attention_qkv(cfg, p, x, lengths[:, None], rope_tab=rope_tab)
    Wl = k_shard.shape[1]
    slot = lengths % (Wl * tp) - m * Wl
    cache_update(k_shard, k, slot)
    cache_update(v_shard, v, slot)
    cache_update(pos_shard, lengths[:, None], slot)
    return decode_attention_ring(q, k_shard, v_shard, pos_shard, lengths + 1,
                                 window=w, softcap=cfg.logit_softcap)


# ---------------------------------------------------------------------------
# MLA attention (DeepSeek-style latent KV)
# ---------------------------------------------------------------------------


def mla_project(cfg: ModelConfig, p, x, positions, *, rope_tab=None):
    """Low-rank projections with RoPE on the ``rope_head_dim`` slices:
    (q_nope (B,S,H,dn), q_rope (B,S,H,dr), c_kv (B,S,r_kv), k_rope
    (B,S,dr)).  ``rope_tab`` are tables at ``rope_head_dim``."""
    dn, r = cfg.head_dim, cfg.kv_lora_rank
    tab = rope_tab if rope_tab is not None else rope_tables(
        positions, cfg.rope_head_dim, cfg.rope_theta)
    cq = rms_norm(torch.matmul(x, p["wq_a"]), p["q_norm"])
    q = _proj_heads(cq, p["wq_b"])
    q_nope, q_rope = q[..., :dn], apply_rope(q[..., dn:], tab)
    ckv = torch.matmul(x, p["wkv_a"])
    c_kv = rms_norm(ckv[..., :r], p["kv_norm"])
    # k_rope carries a head axis of one while it is rotated
    k_rope = apply_rope(ckv[..., r:][:, :, None, :], tab)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def mla_fwd(cfg: ModelConfig, p, x, positions, *, rope_tab=None):
    """Prefill: decompress the latent KV and run causal MHA through the
    flash kernel, q/k heads of dn + dr against v heads of dn; returns
    (out, (c_kv, k_rope)) for the cache."""
    q_nope, q_rope, c_kv, k_rope = mla_project(cfg, p, x, positions,
                                               rope_tab=rope_tab)
    k_nope = _proj_heads(c_kv, p["wk_b"])
    v = _proj_heads(c_kv, p["wv_b"])
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        k_nope.shape[:3] + (cfg.rope_head_dim,))], -1)
    o = chunked_attention(q, k, v, positions, positions, causal=True)
    return _merge_heads(o, p["wo"]), (c_kv, k_rope)


def mla_decode(cfg: ModelConfig, p, x, ckv_cache, krope_cache, lengths, *,
               rope_tab=None):
    """Absorbed one-token decode in latent space: writes the token's c_kv
    and k_rope at ``lengths`` of the (B, S, r) caches in place, then
    attends over positions < lengths + 1 in fp32; returns (out,
    ckv_cache, krope_cache): ``mla_decode_shard`` on the whole cache,
    through ``wo``."""
    o, _ = mla_decode_shard(cfg, p, x, ckv_cache, krope_cache, lengths,
                            rope_tab=rope_tab)
    return _merge_heads(o, p["wo"]), ckv_cache, krope_cache


def mla_decode_shard(cfg: ModelConfig, p, x, ckv_shard, kr_shard, lengths,
                     m: int = 0, *, rope_tab=None):
    """Rank ``m``'s part of MLA's absorbed one-token decode over a latent
    cache split over the ranks in sequence shards of S_l positions (the
    decode regime: positions [m S_l, (m+1) S_l) of ``ckv`` and ``kr``
    here, (B, S_l, r) and (B, S_l, dr)), every MLA weight replicated.  The
    token's c_kv and k_rope are written at ``lengths - m S_l`` (the owner
    writes; ``cache_update`` drops the others' writes and a finished
    row's); the absorbed scores of every head against the shard's
    positions below ``clamp(lengths + 1 - m S_l, 0, S_l)`` in fp32, their
    softmax over the latent values, cast to x's dtype and taken through
    ``wv_b``.  Returns (out (B, 1, H, dn), lse (B, 1, H) fp32): the merge
    (``merge_shards``) runs in value space, after ``wv_b``, which is
    linear, so it is the merge of the latent outputs (dn + 1 floats a
    head sent, not r + 1); at m 0 over the whole cache the one-device
    decode."""
    q_nope, q_rope, c_kv, k_rope = mla_project(cfg, p, x, lengths[:, None],
                                               rope_tab=rope_tab)
    S_l = ckv_shard.shape[1]
    cache_update(ckv_shard, c_kv, lengths - m * S_l)
    cache_update(kr_shard, k_rope, lengths - m * S_l)
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["wk_b"])
    scale = 1.0 / math.sqrt(cfg.head_dim + cfg.rope_head_dim)
    ckv = ckv_shard.float()
    s = (torch.einsum("bqhr,bsr->bhqs", q_lat.float(), ckv)
         + torch.einsum("bqhk,bsk->bhqs", q_rope.float(),
                        kr_shard.float())) * scale
    local = (lengths + 1 - m * S_l).clamp(0, S_l)
    mask = torch.arange(S_l, device=x.device)[None, :] < local[:, None]
    s = torch.where(mask[:, None, None, :], s, -1e30)
    pattn = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhqs,bsr->bqhr", pattn, ckv).to(x.dtype)
    o = torch.einsum("bqhr,rhk->bqhk", o_lat, p["wv_b"])
    lse = torch.logsumexp(s, dim=-1).permute(0, 2, 1)       # (B, 1, H)
    return o, lse


# ---------------------------------------------------------------------------
# Gated MLP
# ---------------------------------------------------------------------------


def activation(cfg: ModelConfig):
    """The gated MLP's activation: silu, or gelu in its tanh form."""
    return F.silu if cfg.act == "silu" else partial(F.gelu,
                                                    approximate="tanh")


def mlp_fwd(cfg: ModelConfig, p, x):
    g = activation(cfg)(torch.matmul(x, p["w1"]))
    u = torch.matmul(x, p["w3"])
    return torch.matmul(g * u, p["w2"])
