"""Models: parameters, prefill, decode step, the decode page (greedy,
sampled, with or without logprobs) and its logprob planes.

PyTorch counterpart of ``repro.models.transformer`` for every family of
the JAX package: dense decoders (H2O-Danube's sliding window among
them), MoE decoders (``models/moe.py`` for the expert layer), with GQA
or, as DeepSeek-R1, MLA attention, Mamba-2 SSMs (``models/ssm.py``),
the RecurrentGemma hybrid (units of RG-LRU, RG-LRU and local-attention
sublayers, ``models/rglru.py``), the Whisper encoder-decoder (LayerNorm,
sinusoid positions, a non-causal encoder over stub frame embeddings,
decoder layers with cross-attention on its states) and the Pixtral
vision decoder (stub patch embeddings through an adapter, placed before
the token embeddings).  Parameters are a plain dict in the JAX
package's layout: per-layer leaves stacked with a leading L
(``layers.attn.wq`` is (L, D, H, dh), ``layers.attn.wq_b`` (L, r_q, H,
dn + dr), ``layers.moe.w1`` (L, E, D, F), ``layers.ssm.wx`` (L, D, W)),
the hybrid's with a leading unit (``units.b0.t.wx`` is (n_units, D, W))
or tail-layer axis, so ``params_from_numpy`` takes the JAX params pytree
as numpy unchanged.  The layer stack is a Python loop over per-layer
views; the decode cache is written in place: ``{"k", "v"}`` of (L, B,
max_len, Hkv, dh) for GQA attention, ``{"k", "v", "pos"}`` rings of
min(window, max_len) slots for a sliding window, ``{"ckv", "kr"}`` of (L,
B, max_len, kv_lora_rank) and (L, B, max_len, rope_head_dim) for MLA,
``{"conv_x", "conv_B", "conv_C", "state"}`` of (L, B, ...) for an SSM,
whose prefill cache is its decode cache, for the hybrid
``{"units": {"b0", "b1": RG-LRU state and conv, "b2": ring}, "tail": ...}``,
and for the encoder-decoder ``{"k", "v"}`` of (L, B, max_len, Hkv, dh)
beside the encoder's cross-attention K/V ``{"xk", "xv"}`` of (L, B,
encoder_seq, Hkv, dh); ``install_cache`` takes a prefill's cache of
either full-attention family into ``init_cache``'s longer one.

A windowed prefill returns the reference's ring, min(window, S) slots
(``_to_ring``); ``install_ring`` re-lays it into ``init_cache``'s ring of
min(window, max_len) slots before decode.  Decoding straight from the
prefill's ring, as the reference's shapes would have it, writes position
S into slot S % S = 0 while position 0 is still in the window whenever S
< window: the port repairs that, and its decode equals the
teacher-forced forward.
"""
from __future__ import annotations

import math
import weakref
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import compat
from repro_torch.models import layers, moe, rglru, ssm
from repro_torch.models.api import ModelConfig


def padded_vocab(cfg: ModelConfig) -> int:
    return -(-cfg.vocab_size // 16) * 16


def check_model(cfg: ModelConfig) -> None:
    """What the port's model functions serve: every family of the JAX
    package.  Dense and MoE decoders with RMSNorm, a gated MLP and full
    RoPE attention (Llama-3.2-1B, Qwen2-0.5B, SmolLM-360M, Qwen3-30B-A3B,
    Phi-3.5-MoE), dense ones with a sliding window too (H2O-Danube-1.8B),
    MoE decoders with MLA (DeepSeek-R1: the JAX package builds MLA in MoE
    layers only), Mamba-2 SSMs (Mamba2-370M), the RG-LRU +
    local-attention hybrid with its logit softcap (RecurrentGemma-2B),
    the encoder-decoder with LayerNorm, a tanh-GELU gated MLP, sinusoid
    positions and cross-attention (Whisper-base), and the vision decoder
    with its patch prefix (Pixtral-12B)."""
    if (cfg.family not in ("dense", "moe", "ssm", "hybrid", "audio", "vlm")
            or (cfg.use_mla and cfg.family != "moe")
            or (cfg.sliding_window > 0 and cfg.family != "dense")
            or (cfg.norm != "rmsnorm" and cfg.family != "audio")
            or (cfg.logit_softcap > 0 and cfg.family != "hybrid")):
        raise NotImplementedError(
            f"{cfg.name}: the PyTorch port's model functions serve dense "
            f"and MoE RMSNorm decoders (MLA in MoE decoders only, a "
            f"sliding window in dense ones only), Mamba-2 SSMs, the "
            f"RecurrentGemma hybrid (the only family with a logit "
            f"softcap), the Whisper encoder-decoder (the only family with "
            f"LayerNorm) and the Pixtral vision decoder")


def check_served(cfg: ModelConfig) -> None:
    """What ``NodeEngine`` serves: the dense and MoE decoders of
    ``check_model`` without a sliding window.  The SSM, hybrid,
    encoder-decoder and vision families and windowed decoders are served
    at model level only (``launch/model_level.py::generate``: ``prefill``,
    ``install_rings`` / ``install_cache``, ``decode_page``), as the JAX
    engine refuses them too."""
    check_model(cfg)
    if cfg.family not in ("dense", "moe") or cfg.sliding_window > 0:
        what = (f"the {cfg.family} family" if cfg.family not in
                ("dense", "moe") else "a sliding-window decoder")
        raise NotImplementedError(
            f"{cfg.name}: NodeEngine serves dense and MoE decoders with "
            f"full attention; {what} is served at model level "
            f"(launch/model_level.py::generate: prefill, decode_page)")


def _hybrid_counts(cfg: ModelConfig):
    """(#full units, #tail rec layers) of the hybrid's block pattern:
    RecurrentGemma-2B's 26 layers are 8 (rec, rec, attn) units and 2
    tail rec layers."""
    unit = len(cfg.block_pattern)
    return cfg.num_layers // unit, cfg.num_layers % unit


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """Nested dict of (shape, init[, dtype]) per leaf, in the layout and
    with the scales of ``repro.models.transformer.init_params``; init is
    the normal draw's std, or "ones" / "zeros" / "a_log" (the SSM's fixed
    ``A_log``, ``ssm.a_log_init``); dtype, where given, overrides
    ``cfg.dtype`` (the MoE router ``wg``, the SSM's ``dt_bias``,
    ``A_log`` and ``D_skip`` and the RG-LRU's ``lam`` stay fp32, as the
    JAX package keeps them).  The hybrid's sublayers are stacked per
    unit position (``units.b0`` .. ``b2``, leading n_units) and its tail
    (leading n_tail)."""
    check_model(cfg)
    V, D, L = padded_vocab(cfg), cfg.d_model, cfg.num_layers
    H, Hkv, dh, Fd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    sc, lsc = 1.0 / math.sqrt(D), 1.0 / math.sqrt(max(L, 1))

    def norm(stack=()):
        if cfg.norm == "rmsnorm":
            return {"w": (stack + (D,), "ones")}
        return {"w": (stack + (D,), "ones"), "b": (stack + (D,), "zeros")}

    top = {"embed": ((V, D), 0.01), "lm_head": ((D, V), sc),
           "final_norm": norm()}
    if cfg.family == "ssm":
        return dict(top, layers={"ln1": norm((L,)),
                                 "ssm": ssm.param_spec(cfg, (L,))})

    def gqa(stack):
        a = {"wq": (stack + (D, H, dh), sc), "wk": (stack + (D, Hkv, dh), sc),
             "wv": (stack + (D, Hkv, dh), sc),
             "wo": (stack + (H, dh, D), sc * lsc)}
        if cfg.attn_bias:
            a.update(bq=(stack + (H, dh), "zeros"),
                     bk=(stack + (Hkv, dh), "zeros"),
                     bv=(stack + (Hkv, dh), "zeros"))
        return a

    def mlp(F, stack=(L,)):
        return {"w1": (stack + (D, F), sc), "w3": (stack + (D, F), sc),
                "w2": (stack + (F, D), 1.0 / math.sqrt(F) * lsc)}

    if cfg.family == "hybrid":      # repro.models.transformer._init_rg_*
        n_units, n_tail = _hybrid_counts(cfg)

        def sub(kind, stack):
            t = rglru.param_spec(cfg, stack) if kind == "rec" else gqa(stack)
            return {"ln1": norm(stack), "t": t, "ln2": norm(stack),
                    "mlp": mlp(Fd, stack)}

        out = dict(top, units={f"b{i}": sub(kind, (n_units,))
                               for i, kind in enumerate(cfg.block_pattern)})
        if n_tail:
            out["tail"] = sub("rec", (n_tail,))
        return out

    if cfg.family == "audio":       # _init_enc_layer, _init_dec_layer
        E = (cfg.encoder_layers,)
        return dict(top, enc_layers={"ln1": norm(E), "attn": gqa(E),
                                     "ln2": norm(E), "mlp": mlp(Fd, E)},
                    enc_norm=norm(),
                    layers={"ln1": norm((L,)), "attn": gqa((L,)),
                            "ln2": norm((L,)), "xattn": gqa((L,)),
                            "ln3": norm((L,)), "mlp": mlp(Fd)},
                    adapter=((D, D), sc))

    if cfg.use_mla:     # repro.models.layers.init_mla
        r_q, r_kv, dr = cfg.q_lora_rank, cfg.kv_lora_rank, cfg.rope_head_dim
        attn = {"wq_a": ((L, D, r_q), sc), "q_norm": ((L, r_q), "ones"),
                "wq_b": ((L, r_q, H, dh + dr), 1.0 / math.sqrt(r_q)),
                "wkv_a": ((L, D, r_kv + dr), sc),
                "kv_norm": ((L, r_kv), "ones"),
                "wk_b": ((L, r_kv, H, dh), 1.0 / math.sqrt(r_kv)),
                "wv_b": ((L, r_kv, H, dh), 1.0 / math.sqrt(r_kv)),
                "wo": ((L, H, dh, D), sc * lsc)}
    else:
        attn = gqa((L,))

    block = {"ln1": norm((L,)), "attn": attn, "ln2": norm((L,))}
    if cfg.is_moe:
        E = cfg.num_experts
        block["moe"] = dict(wg=((L, D, E), sc, "float32"),
                            **mlp(cfg.moe_d_ff, (L, E)))
        if cfg.num_shared_experts > 0:
            block["moe"]["shared"] = mlp(cfg.shared_d_ff)
    else:
        block["mlp"] = mlp(Fd)
    out = dict(top, layers=block)
    if cfg.family == "vlm":
        out["adapter"] = ((D, D), sc)
    return out


def _map_spec(spec, fn, path=()):
    if isinstance(spec, dict):
        return {k: _map_spec(v, fn, path + (k,)) for k, v in spec.items()}
    return fn(path, spec)


def _leaf_dtype(cfg: ModelConfig, spec) -> torch.dtype:
    return compat.torch_dtype(spec[2] if len(spec) > 2 else cfg.dtype)


def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """Random weights drawn from a seeded ``torch.Generator`` on the target
    device (normal draws in fp32, scaled in place, cast to each leaf's
    dtype).  A stacked layer leaf is drawn one layer at a time into its
    final tensor, and a leaf with an expert axis one (layer, expert) at a
    time, so the fp32 temporary is one expert's matrix at most
    (DeepSeek-R1's ``moe.w1`` is 7.5 GB a layer in bf16; drawn a layer at
    a time its fp32 draw would take 15.0 GB, an expert at a time 58.7 MB).
    They are not the JAX package's draws; use ``params_from_numpy`` for
    those."""
    dev = compat.resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def draw(shape, scale, dt):
        x = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return x.mul_(scale).to(dt)

    def make(path, spec):
        shape, scale, dt = spec[0], spec[1], _leaf_dtype(cfg, spec)
        if scale == "ones":
            return torch.ones(shape, dtype=dt, device=dev)
        if scale == "zeros":
            return torch.zeros(shape, dtype=dt, device=dev)
        if scale == "a_log":
            return ssm.a_log_init(shape[-1], dev).expand(shape).to(dt) \
                .contiguous()
        if scale == "lam":
            return rglru.lam_init(shape, gen, dev).to(dt)
        if path[0] not in ("layers", "enc_layers", "units", "tail"):
            return draw(shape, scale, dt)
        out = torch.empty(shape, dtype=dt, device=dev)
        experts = path[-2] == "moe" and len(shape) == 4   # (L, E, ., .)
        for i in range(shape[0]):
            if experts:
                for e in range(shape[1]):
                    out[i, e] = draw(shape[2:], scale, dt)
            else:
                out[i] = draw(shape[1:], scale, dt)
        return out

    return _map_spec(param_shapes(cfg), make)


def param_template(cfg: ModelConfig):
    """The parameter tree as tensors on the ``meta`` device: each leaf's
    shape and dtype without storage (what ``checkpoint.unflatten_into``
    fills)."""
    return _map_spec(param_shapes(cfg), lambda path, spec: torch.empty(
        spec[0], dtype=_leaf_dtype(cfg, spec), device="meta"))


def params_from_numpy(np_params, cfg: ModelConfig, device=None):
    """The JAX params pytree, as numpy arrays (``np.asarray`` of each leaf;
    bf16 leaves as their 16-bit patterns), in the port's layout on
    ``device``.  Raises on a missing, extra or misshapen leaf."""
    dev = compat.resolve_device(device)
    spec = param_shapes(cfg)

    def walk(sp, tree, path):
        if set(sp) != set(tree):
            raise ValueError(f"params{'.'.join(('',) + path)}: keys "
                             f"{sorted(tree)} != {sorted(sp)}")
        out = {}
        for k, v in sp.items():
            if isinstance(v, dict):
                out[k] = walk(v, tree[k], path + (k,))
                continue
            a = np.asarray(tree[k])
            if tuple(a.shape) != tuple(v[0]):
                raise ValueError(f"params.{'.'.join(path + (k,))}: shape "
                                 f"{a.shape} != {v[0]}")
            if a.dtype == np.uint16 or a.dtype.name == "bfloat16":
                t = compat.from_numpy(a.view(np.uint16), torch.bfloat16, dev)
            else:
                t = torch.from_numpy(np.array(a)).to(dev)
            out[k] = t.to(_leaf_dtype(cfg, v))
        return out

    return walk(spec, np_params, ())


def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameters in all leaves; with ``active_only`` the routed experts
    count k of E (shared experts and the router count whole: a shared
    expert runs for every token, where the JAX ``param_count`` scales it
    by k/E too)."""
    total = 0

    def count(path, spec):
        nonlocal total
        n = math.prod(spec[0])
        if active_only and path[-2:-1] == ("moe",) and path[-1] != "wg":
            n = n // cfg.num_experts * cfg.experts_per_token
        total += n

    _map_spec(param_shapes(cfg), count)
    return total


# id(stacked ln1.w) -> (weak reference to it, per-layer views)
_PER_LAYER: Dict[int, Tuple[Any, List[Dict[str, Any]]]] = {}


def _layer_view(t, i):
    """``t[i]`` sharing t's storage but not holding the tensor ``t``
    itself (a plain ``t[i]`` keeps its base alive), so the cache entry
    below dies with the params."""
    v = t[i]
    return torch.empty(0, dtype=t.dtype, device=t.device).set_(
        v.untyped_storage(), v.storage_offset(), v.size(), v.stride())


def _per_layer(params, stack: str = "layers") -> List[Dict[str, Any]]:
    """Per-layer views of the leaves stacked under ``stack`` ("layers",
    the encoder's "enc_layers", or the hybrid's "units" and "tail"),
    cached while the params live (one view per leaf and layer instead of
    one per call).  The views
    hold the leaves' storage, not the leaves, so dropping the params
    drops the anchor (the stack's first leaf), whose weak reference
    evicts the entry and frees the weights."""
    anchor = params[stack]
    while isinstance(anchor, dict):
        anchor = next(iter(anchor.values()))
    hit = _PER_LAYER.get(id(anchor))
    if hit is not None and hit[0]() is anchor:
        return hit[1]

    def index(tree, i):
        return {k: index(v, i) if isinstance(v, dict) else _layer_view(v, i)
                for k, v in tree.items()}

    views = [index(params[stack], i) for i in range(anchor.shape[0])]
    key = id(anchor)
    ref = weakref.ref(anchor, lambda _: _PER_LAYER.pop(key, None))
    _PER_LAYER[key] = (ref, views)
    return views


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------


def _embed_tokens(cfg, params, tokens):
    h = params["embed"][tokens.long()]
    if cfg.family == "hybrid":      # gemma: times sqrt(d_model), rounded
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype,
                             device=h.device)   # to h's dtype first
    return h


def logits_fn(cfg, params, h):
    logits = torch.matmul(h, params["lm_head"]).float()
    if cfg.logit_softcap > 0:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------


def _ring_cache(lead, B: int, Wc: int, Hkv: int, dh: int, dt, dev):
    """An empty ring: k / v zeros (*lead, B, Wc, Hkv, dh), positions -1."""
    return {"k": torch.zeros(lead + (B, Wc, Hkv, dh), dtype=dt, device=dev),
            "v": torch.zeros(lead + (B, Wc, Hkv, dh), dtype=dt, device=dev),
            "pos": torch.full(lead + (B, Wc), -1, dtype=torch.int32,
                              device=dev)}


def init_cache(cfg: ModelConfig, B: int, max_len: int, device=None):
    """Decode cache of zeros: {"k", "v"} of (L, B, max_len, Hkv, dh); for
    a sliding window a ring {"k", "v", "pos"} of min(window, max_len)
    slots (positions -1: empty); for MLA {"ckv", "kr"} of (L, B, max_len,
    kv_lora_rank) and (L, B, max_len, rope_head_dim); for an SSM
    ``ssm.init_ssm_cache``'s leaves with a leading L (no ``max_len`` axis:
    the state does not grow); for the hybrid {"units": {"b<i>": RG-LRU
    cache or ring of min(local_window, max_len)}, "tail": RG-LRU cache},
    leaves with a leading n_units / n_tail; for the encoder-decoder
    {"k", "v"} beside the cross-attention's {"xk", "xv"} of (L, B,
    encoder_seq, Hkv, dh)."""
    check_model(cfg)
    dev = compat.resolve_device(device)
    dt = compat.torch_dtype(cfg.dtype)
    L = cfg.num_layers
    Hkv, dh = cfg.num_kv_heads, cfg.head_dim
    if cfg.family == "ssm":
        one = ssm.init_ssm_cache(cfg, B, dt, dev)
        return {k: v.new_zeros((L,) + v.shape) for k, v in one.items()}
    if cfg.family == "hybrid":
        n_units, n_tail = _hybrid_counts(cfg)
        Wc = min(cfg.local_window, max_len)

        def rec(n):
            one = rglru.init_rglru_cache(cfg, B, dt, dev)
            return {k: v.new_zeros((n,) + v.shape) for k, v in one.items()}

        cache = {"units": {
            f"b{i}": rec(n_units) if kind == "rec" else
            _ring_cache((n_units,), B, Wc, Hkv, dh, dt, dev)
            for i, kind in enumerate(cfg.block_pattern)}}
        if n_tail:
            cache["tail"] = rec(n_tail)
        return cache
    if cfg.sliding_window > 0:
        return _ring_cache((L,), B, min(cfg.sliding_window, max_len), Hkv,
                           dh, dt, dev)
    if cfg.use_mla:
        return {"ckv": torch.zeros((L, B, max_len, cfg.kv_lora_rank),
                                   dtype=dt, device=dev),
                "kr": torch.zeros((L, B, max_len, cfg.rope_head_dim),
                                  dtype=dt, device=dev)}
    shape = (L, B, max_len, cfg.num_kv_heads, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=dt, device=dev),
             "v": torch.zeros(shape, dtype=dt, device=dev)}
    if cfg.family == "audio":
        xshape = (L, B, cfg.encoder_seq, Hkv, dh)
        cache.update(xk=torch.zeros(xshape, dtype=dt, device=dev),
                     xv=torch.zeros(xshape, dtype=dt, device=dev))
    return cache


def install_cache(cfg: ModelConfig, dst, src):
    """A full-attention prefill's cache ``src`` into ``dst``, a longer
    cache of ``init_cache``, in place: the (L, B, S, Hkv, dh) ``k`` and
    ``v`` into dst's first S positions; the encoder-decoder's ``xk`` and
    ``xv`` (encoder_seq positions in both) copied as they are.  Returns
    ``dst``."""
    if cfg.family not in ("dense", "moe", "audio", "vlm") or \
            cfg.sliding_window > 0 or cfg.use_mla:
        raise NotImplementedError(f"{cfg.name}: install_cache takes a "
                                  f"full-attention GQA cache")
    S = src["k"].shape[2]
    if S > dst["k"].shape[2]:
        raise ValueError(f"install_cache: a prefill of {S} positions into "
                         f"a cache of {dst['k'].shape[2]}")
    for name in ("k", "v"):
        dst[name][:, :, :S] = src[name]
    for name in ("xk", "xv"):
        if name in src:
            dst[name].copy_(src[name])
    return dst


def ffn(cfg: ModelConfig, p, h):
    """The layer's second half on the residual stream h: RMSNorm, then
    the MoE (``models/moe.py``) or the gated MLP, added back to h.  Returns
    (h, aux): the MoE's load-balance aux (fp32 scalar), None for the MLP."""
    xn = layers.apply_norm(cfg, p["ln2"], h)
    if cfg.is_moe:
        y, aux = moe.moe_fwd(cfg, p["moe"], xn)
        return h + y, aux
    return h + layers.mlp_fwd(cfg, p["mlp"], xn), None


def _to_ring(k, v, positions, window: int):
    """Full (B, S, Hkv, dh) K/V folded into the reference's prefill ring of
    Wc = min(window, S) slots: the last Wc positions, each at slot
    position % Wc, positions (B, Wc) int32 (-1: empty)."""
    B, S = k.shape[0], k.shape[1]
    Wc = min(window, S)
    k_r, v_r = k[:, S - Wc:], v[:, S - Wc:]
    pos_r = positions[:, S - Wc:].to(torch.int32)
    rows = torch.arange(B, device=k.device)[:, None]
    slot = (pos_r % Wc).long()
    k_ring, v_ring = torch.zeros_like(k_r), torch.zeros_like(v_r)
    k_ring[rows, slot] = k_r
    v_ring[rows, slot] = v_r
    pos_ring = torch.full((B, Wc), -1, dtype=torch.int32, device=k.device)
    pos_ring[rows, slot] = pos_r
    return {"k": k_ring, "v": v_ring, "pos": pos_ring}


def install_ring(dst, src):
    """Re-lay a prefill ring ``src`` ({"k", "v", "pos"} of Ws slots, as
    ``_to_ring`` makes it, with any leading axes) into ``dst``, a ring of
    ``init_cache``'s Wd = min(window, max_len) slots with the same leading
    axes, in place: each of the newest Wd positions p goes to slot p % Wd;
    the other slots are emptied (zeros, position -1).  Decode then writes
    position p at slot p % Wd of the ring it reads, whatever the prompt's
    length.  Returns ``dst``."""
    Ws, Wd = src["pos"].shape[-1], dst["pos"].shape[-1]
    sp = src["pos"].reshape(-1, Ws).long()
    n = sp.shape[0]
    keep = (sp >= 0) & (sp > sp.amax(dim=-1, keepdim=True) - Wd)
    rows = torch.arange(n, device=sp.device)[:, None].expand(n, Ws)[keep]
    slots = (sp % Wd)[keep]
    dpos = dst["pos"].view(n, Wd)
    dpos.fill_(-1)
    dpos[rows, slots] = sp[keep].to(dpos.dtype)
    for name in ("k", "v"):
        tail = dst[name].shape[-2:]
        d = dst[name].view((n, Wd) + tail)
        d.zero_()
        d[rows, slots] = src[name].reshape((n, Ws) + tail)[keep] \
            .to(d.dtype)
    return dst


def install_rings(cfg: ModelConfig, dst, src):
    """``install_ring`` for every ring of a windowed model's cache: the
    whole cache of a sliding-window decoder, the attention positions of
    the hybrid's units.  The RG-LRU leaves (fixed size) are copied.
    Returns ``dst``."""
    if cfg.family != "hybrid":
        return install_ring(dst, src)
    pairs = [(dst["units"][b], c) for b, c in src["units"].items()]
    if "tail" in src:
        pairs.append((dst["tail"], src["tail"]))
    for d, c in pairs:
        if "pos" in c:
            install_ring(d, c)
        else:
            for k, t in c.items():
                d[k].copy_(t)
    return dst


def _rg_sub_fwd(cfg, p, h, positions, tab, kind):
    """One hybrid sublayer over the sequence: RMSNorm, RG-LRU or local
    attention (window ``cfg.local_window``), RMSNorm, gelu MLP; returns
    (h, its prefill cache: the RG-LRU's state and conv, or the ring)."""
    xn = layers.apply_norm(cfg, p["ln1"], h)
    if kind == "rec":
        y, cache = rglru.rglru_fwd(cfg, p["t"], xn, return_state=True)
    else:
        y, (k, v) = layers.attention_fwd(cfg, p["t"], xn, positions,
                                         rope_tab=tab,
                                         window=cfg.local_window)
        cache = _to_ring(k, v, positions, cfg.local_window)
    h = h + y
    return h + layers.mlp_fwd(cfg, p["mlp"],
                              layers.apply_norm(cfg, p["ln2"], h)), cache


def _rg_sub_decode(cfg, p, h, c, lengths, tab, kind):
    """One hybrid sublayer's decode step; its cache ``c`` (one unit's or
    tail layer's views) is written in place."""
    xn = layers.apply_norm(cfg, p["ln1"], h)
    if kind == "rec":
        y, _ = rglru.rglru_decode(cfg, p["t"], xn, c)
    else:
        y, _, _, _ = layers.attention_decode_ring(
            cfg, p["t"], xn, c["k"], c["v"], c["pos"], lengths,
            window=cfg.local_window, rope_tab=tab)
    h = h + y
    return h + layers.mlp_fwd(cfg, p["mlp"],
                              layers.apply_norm(cfg, p["ln2"], h))


def _assemble_inputs(cfg, params, tokens, patches=None):
    """Token embeddings, after Pixtral's stub patch embeddings (B, P, D)
    times ``adapter`` when given (positions then run over P + S); for the
    encoder-decoder plus sinusoid positions.  Returns (h, positions)."""
    h = _embed_tokens(cfg, params, tokens)
    if cfg.family == "vlm" and patches is not None:
        pe = torch.matmul(patches.float(), params["adapter"].float())
        h = torch.cat([pe.to(h.dtype), h], dim=1)
    B, S = h.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=h.device)[None].expand(B, S)
    if cfg.family == "audio":
        h = h + layers.sinusoid_pos(positions, cfg.d_model, h.dtype)
    return h, positions


def _encode(cfg, params, frames):
    """The encoder over stub frame embeddings (B, Se, D): ``adapter``,
    sinusoid positions, non-causal self-attention layers without RoPE,
    then ``enc_norm``.  Returns (states (B, Se, D), positions (B, Se))."""
    dt = compat.torch_dtype(cfg.dtype)
    h = torch.matmul(frames.float(), params["adapter"].float()).to(dt)
    B, S = h.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=h.device)[None].expand(B, S)
    h = h + layers.sinusoid_pos(positions, cfg.d_model, h.dtype)
    for p in _per_layer(params, "enc_layers"):
        xn = layers.apply_norm(cfg, p["ln1"], h)
        a, _ = layers.attention_fwd(cfg, p["attn"], xn, positions,
                                    causal=False, use_rope=False)
        h = h + a
        h = h + layers.mlp_fwd(cfg, p["mlp"],
                               layers.apply_norm(cfg, p["ln2"], h))
    return layers.apply_norm(cfg, params["enc_norm"], h), positions


def _dec_layer_fwd(cfg, p, h, positions, enc, enc_pos):
    """One decoder layer of the encoder-decoder over the sequence: causal
    self-attention without RoPE, non-causal cross-attention on the
    encoder states, the MLP.  Returns (h, (k, v, xk, xv))."""
    xn = layers.apply_norm(cfg, p["ln1"], h)
    a, (k, v) = layers.attention_fwd(cfg, p["attn"], xn, positions,
                                     causal=True, use_rope=False)
    h = h + a
    xk, xv = layers.kv_from_states(cfg, p["xattn"], enc)
    xn = layers.apply_norm(cfg, p["ln2"], h)
    a, _ = layers.attention_fwd(cfg, p["xattn"], xn, positions,
                                causal=False, kv=(xk, xv),
                                kv_positions=enc_pos)
    h = h + a
    h = h + layers.mlp_fwd(cfg, p["mlp"], layers.apply_norm(cfg, p["ln3"],
                                                            h))
    return h, (k, v, xk, xv)


def _dec_layer_decode(cfg, p, h, c, lengths):
    """One decoder layer's decode step; its cache ``c`` (one layer's
    views of k, v, xk, xv) is written in place (k and v at ``lengths``)."""
    xn = layers.apply_norm(cfg, p["ln1"], h)
    a, _, _ = layers.attention_decode(cfg, p["attn"], xn, c["k"], c["v"],
                                      lengths, use_rope=False)
    h = h + a
    xn = layers.apply_norm(cfg, p["ln2"], h)
    h = h + layers.cross_attention_decode(cfg, p["xattn"], xn, c["xk"],
                                          c["xv"])
    return h + layers.mlp_fwd(cfg, p["mlp"],
                              layers.apply_norm(cfg, p["ln3"], h))


def _stacked(per_layer):
    """A list of per-layer cache dicts -> one dict of stacked leaves."""
    return {k: torch.stack([c[k] for c in per_layer])
            for k in per_layer[0]}


def _hybrid_backbone(cfg, params, h, positions, tab):
    units = []
    for p in _per_layer(params, "units"):
        c = {}
        for i, kind in enumerate(cfg.block_pattern):
            h, c[f"b{i}"] = _rg_sub_fwd(cfg, p[f"b{i}"], h, positions, tab,
                                        kind)
        units.append(c)
    cache = {"units": {b: _stacked([u[b] for u in units])
                       for b in units[0]}}
    if "tail" in params:
        tail = []
        for p in _per_layer(params, "tail"):
            h, c = _rg_sub_fwd(cfg, p, h, positions, tab, "rec")
            tail.append(c)
        cache["tail"] = _stacked(tail)
    return h, cache


def _backbone(cfg: ModelConfig, params, tokens, *, frames=None,
              patches=None):
    """tokens (B, S) -> (final-normed hidden (B, S', D), cache); the cache
    is ``init_cache``'s leaves at max_len S', an SSM's decode cache, or for
    a window the reference's prefill rings of min(window, S) slots
    (``install_rings`` takes them to a decode cache).  S' is S, or P + S
    with Pixtral's ``patches`` (B, P, D) placed first; the
    encoder-decoder needs ``frames`` (B, encoder_seq, D)."""
    check_model(cfg)
    if (frames is not None and cfg.family != "audio") or \
            (patches is not None and cfg.family != "vlm"):
        raise ValueError(f"{cfg.name}: frames are Whisper's input and "
                         f"patches Pixtral's, not the {cfg.family} "
                         f"family's")
    h, positions = _assemble_inputs(cfg, params, tokens, patches)
    B, S = positions.shape
    if cfg.family == "audio":
        got = None if frames is None else tuple(frames.shape)
        if got is None or got[1:] != (cfg.encoder_seq, cfg.d_model):
            raise ValueError(f"{cfg.name}: prefill needs frames of (B, "
                             f"{cfg.encoder_seq}, {cfg.d_model}), got {got}")
        enc, enc_pos = _encode(cfg, params, frames)
        cache = init_cache(cfg, B, S, tokens.device)
        for i, p in enumerate(_per_layer(params)):
            h, kv = _dec_layer_fwd(cfg, p, h, positions, enc, enc_pos)
            for name, t in zip(("k", "v", "xk", "xv"), kv):
                cache[name][i] = t
        return layers.apply_norm(cfg, params["final_norm"], h), cache
    if cfg.family == "ssm":
        cache = init_cache(cfg, B, S, tokens.device)
        for i, p in enumerate(_per_layer(params)):
            xn = layers.apply_norm(cfg, p["ln1"], h)
            y, c = ssm.ssm_fwd(cfg, p["ssm"], xn, return_state=True)
            for name, t in c.items():
                cache[name][i] = t
            h = h + y
        return layers.apply_norm(cfg, params["final_norm"], h), cache
    tab = layers.rope_tables(positions, layers.rope_dim(cfg), cfg.rope_theta)
    if cfg.family == "hybrid":
        h, cache = _hybrid_backbone(cfg, params, h, positions, tab)
        return layers.apply_norm(cfg, params["final_norm"], h), cache
    if cfg.sliding_window > 0:
        rings = []
        for p in _per_layer(params):
            xn = layers.apply_norm(cfg, p["ln1"], h)
            a, (k, v) = layers.attention_fwd(cfg, p["attn"], xn, positions,
                                             rope_tab=tab)
            rings.append(_to_ring(k, v, positions, cfg.sliding_window))
            h = ffn(cfg, p, h + a)[0]
        return layers.apply_norm(cfg, params["final_norm"], h), \
            _stacked(rings)
    cache = init_cache(cfg, B, S, tokens.device)
    names = ("ckv", "kr") if cfg.use_mla else ("k", "v")
    attn_fwd = layers.mla_fwd if cfg.use_mla else layers.attention_fwd
    for i, p in enumerate(_per_layer(params)):
        xn = layers.apply_norm(cfg, p["ln1"], h)
        a, kv = attn_fwd(cfg, p["attn"], xn, positions, rope_tab=tab)
        for name, t in zip(names, kv):
            cache[name][i] = t
        h = ffn(cfg, p, h + a)[0]
    return layers.apply_norm(cfg, params["final_norm"], h), cache


# ---------------------------------------------------------------------------
# training: forward_loss and the chunked cross-entropy
# ---------------------------------------------------------------------------

CE_CHUNK = 512
# weight of the MoE load-balance aux in the loss, over the layers
# (``repro.models.transformer.AUX_COEF``)
AUX_COEF = 0.01


def check_trainable(cfg: ModelConfig) -> None:
    """What ``forward_loss`` trains: the dense decoders (H2O-Danube's
    sliding window among them), the MoE decoders with GQA attention and
    the Mamba-2 SSMs.  Each other family raises ``ValueError`` naming what
    its training still needs."""
    check_model(cfg)
    needs = {
        "hybrid": "a backward of the RG-LRU scan",
        "audio": "the encoder-decoder's trunk under autograd",
        "vlm": "the vision decoder's patch prefix under autograd",
    }
    if cfg.use_mla:
        raise ValueError(f"{cfg.name}: training MLA needs the flash "
                         f"backward at q/k 192, v 128 (unequal head dims)")
    if cfg.family not in ("dense", "moe", "ssm"):
        raise ValueError(f"{cfg.name}: forward_loss trains the dense, MoE "
                         f"and SSM decoders; the {cfg.family} family needs "
                         f"{needs[cfg.family]}")


def _chunk_ce(cfg, params, h, labels):
    """(sum of the valid rows' losses, their count) of one chunk: fp32
    logits, logsumexp minus the label's logit, labels < 0 left out."""
    logits = logits_fn(cfg, params, h)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.clamp_min(0).long()[..., None])
    valid = (labels >= 0).float()
    return ((lse - ll[..., 0]) * valid).sum(), valid.sum()


def _chunked_ce(cfg: ModelConfig, params, h, labels):
    """Mean cross-entropy of ``labels`` (B, S) against the logits of the
    final hidden states ``h`` (B, S, D), without the (B, S, V) logits:
    chunks of ``CE_CHUNK`` positions, each under ``torch.utils.checkpoint``
    so its backward recomputes the chunk's (B, c, V) fp32 logits instead
    of keeping them (``repro.models.transformer._chunked_ce``'s
    ``jax.checkpoint``).  The label of position t scores position t's
    logits, unshifted, as the reference does."""
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for s0 in range(0, h.shape[1], CE_CHUNK):
        t, n = checkpoint(_chunk_ce, cfg, params, h[:, s0:s0 + CE_CHUNK],
                          labels[:, s0:s0 + CE_CHUNK], use_reentrant=False,
                          preserve_rng_state=False)
        tot, cnt = tot + t, cnt + n
    return tot / torch.clamp_min(cnt, 1.0)


def _train_layer(cfg, stack, i, h, positions, tab):
    """Layer ``i`` of the training trunk: its leaves indexed from the
    stacked ones (``t[i]``, which autograd follows back to them).  Returns
    (h, aux) as ``ffn``; an SSM layer ``h + ssm_fwd(norm(h))`` and no aux,
    as the reference's ``_layer_fwd`` (its chunked SSD's scan through
    ``SsdScanFn``).  Under remat its recompute must route as the first run
    did: the router's fp32 matmul, softmax and stable sort see the same
    inputs and give the same bits (``chip_smoke.py`` phase 13 compares the
    two runs' dispatch plans on the card)."""
    p = _map_spec(stack, lambda path, t: t[i])
    xn = layers.apply_norm(cfg, p["ln1"], h)
    if cfg.family == "ssm":
        return h + ssm.ssm_fwd(cfg, p["ssm"], xn), None
    a, _ = layers.attention_fwd(cfg, p["attn"], xn, positions, rope_tab=tab)
    return ffn(cfg, p, h + a)


def forward_loss(cfg: ModelConfig, params, batch, *, remat: bool = True):
    """Training loss of a dense, MoE or SSM decoder: ``batch["tokens"]``
    (B, S) through the layer stack, the final norm and the chunked
    cross-entropy against ``batch["labels"]`` (B, S) (< 0: ignored), plus
    for MoE ``AUX_COEF`` times the layers' summed load-balance aux over
    their count.  The trunk builds no cache (an SSM no state and no rope
    table); with ``remat`` each layer runs under
    ``torch.utils.checkpoint`` and is recomputed in the backward
    (``_stack_fwd``'s ``jax.checkpoint``).  Differentiable in every leaf of
    ``params`` that requires grad."""
    check_trainable(cfg)
    h, positions = _assemble_inputs(cfg, params, batch["tokens"])
    tab = None if cfg.family == "ssm" else layers.rope_tables(
        positions, layers.rope_dim(cfg), cfg.rope_theta)
    stack = params["layers"]
    aux = None
    for i in range(cfg.num_layers):
        if remat:
            h, a = checkpoint(_train_layer, cfg, stack, i, h, positions, tab,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            h, a = _train_layer(cfg, stack, i, h, positions, tab)
        if a is not None:
            aux = a if aux is None else aux + a
    h = layers.apply_norm(cfg, params["final_norm"], h)
    loss = _chunked_ce(cfg, params, h, batch["labels"])
    if cfg.is_moe:
        loss = loss + AUX_COEF * aux / max(cfg.num_layers, 1)
    return loss


def prefill(cfg: ModelConfig, params, tokens, *, frames=None, patches=None):
    """Prefill: returns (last-position logits (B, 1, V), cache).  Whisper
    needs ``frames`` (B, encoder_seq, D); Pixtral takes ``patches`` (B, P,
    D) before the tokens, so its cache holds P + S positions."""
    h, cache = _backbone(cfg, params, tokens, frames=frames, patches=patches)
    return logits_fn(cfg, params, h[:, -1:, :]), cache


def decode_step_logits(cfg: ModelConfig, params, cache, tokens, lengths):
    """One decode step: tokens (B,), lengths (B,) -> (raw next-token
    logits (B, V) fp32, cache).  Writes each row's new K/V (MLA: c_kv and
    k_rope) at ``lengths`` in place (dropped for rows at or past the cache
    length; a ring writes slot ``lengths % Wc``); an SSM and an RG-LRU
    advance every row's conv caches and state in place (a finished row's
    state advances too, and its tokens are discarded, as in the JAX
    scan).  The encoder-decoder adds sinusoid positions at ``lengths``
    and reads its cross-attention cache; Pixtral's ``lengths`` count its
    patches."""
    check_model(cfg)
    h = _embed_tokens(cfg, params, tokens[:, None])
    if cfg.family == "audio":
        h = h + layers.sinusoid_pos(lengths[:, None], cfg.d_model, h.dtype)
        for i, p in enumerate(_per_layer(params)):
            h = _dec_layer_decode(cfg, p, h,
                                  {k: t[i] for k, t in cache.items()},
                                  lengths)
        return head_logits(cfg, params, h), cache
    if cfg.family == "ssm":
        for i, p in enumerate(_per_layer(params)):
            xn = layers.apply_norm(cfg, p["ln1"], h)
            y, _ = ssm.ssm_decode(cfg, p["ssm"], xn,
                                  {k: v[i] for k, v in cache.items()})
            h = h + y
        return head_logits(cfg, params, h), cache
    positions = lengths[:, None]
    tab = layers.rope_tables(positions, layers.rope_dim(cfg), cfg.rope_theta)
    if cfg.family == "hybrid":
        for u, p in enumerate(_per_layer(params, "units")):
            for i, kind in enumerate(cfg.block_pattern):
                c = {k: t[u] for k, t in cache["units"][f"b{i}"].items()}
                h = _rg_sub_decode(cfg, p[f"b{i}"], h, c, lengths, tab, kind)
        if "tail" in cache:
            for j, p in enumerate(_per_layer(params, "tail")):
                c = {k: t[j] for k, t in cache["tail"].items()}
                h = _rg_sub_decode(cfg, p, h, c, lengths, tab, "rec")
        return head_logits(cfg, params, h), cache
    if cfg.sliding_window > 0:
        for i, p in enumerate(_per_layer(params)):
            xn = layers.apply_norm(cfg, p["ln1"], h)
            a, _, _, _ = layers.attention_decode_ring(
                cfg, p["attn"], xn, cache["k"][i], cache["v"][i],
                cache["pos"][i], lengths, rope_tab=tab)
            h = ffn(cfg, p, h + a)[0]
        return head_logits(cfg, params, h), cache
    names = ("ckv", "kr") if cfg.use_mla else ("k", "v")
    attn_decode = (layers.mla_decode if cfg.use_mla
                   else layers.attention_decode)
    for i, p in enumerate(_per_layer(params)):
        xn = layers.apply_norm(cfg, p["ln1"], h)
        a, _, _ = attn_decode(cfg, p["attn"], xn, cache[names[0]][i],
                              cache[names[1]][i], lengths, rope_tab=tab)
        h = ffn(cfg, p, h + a)[0]
    return head_logits(cfg, params, h), cache


def head_logits(cfg: ModelConfig, params, h):
    """Final norm + LM head on one position, h (B, 1, D) -> (B, V) fp32."""
    h = layers.apply_norm(cfg, params["final_norm"], h)
    return logits_fn(cfg, params, h)[:, 0, :]


def decode_step(cfg: ModelConfig, params, cache, tokens, lengths):
    """One greedy decode step -> (next tokens (B,) int32, cache)."""
    logits, cache = decode_step_logits(cfg, params, cache, tokens, lengths)
    return torch.argmax(logits, dim=-1).to(torch.int32), cache


def pack_logprob_block(tokens, logits, lp_k: int):
    """Pack one decode step's (tokens, raw logits) into a single f32 row
    block, so the whole page still crosses to the host in ONE copy.

    Layout along the last axis (width 2 + 2*lp_k):
      [0]                 tokens, int32 bit pattern viewed as f32
      [1]                 log-softmax(logits)[token]
      [2 : 2+K]           top-K logprob values (descending)
      [2+K : 2+2K]        top-K token ids, int32 bit pattern viewed as f32
    The top K break ties to the lowest id (``jax.lax.top_k``'s rule; a
    stable descending sort, since ``torch.topk`` leaves tie order open).
    Unpacked on the host by ``unpack_logprob_block``."""
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    tok = tokens.to(torch.int32)
    chosen = torch.gather(lp, 1, tok[:, None].long())
    parts = [tok.view(torch.float32)[:, None], chosen]
    if lp_k > 0:
        vals, idx = torch.sort(lp, dim=-1, descending=True, stable=True)
        parts += [vals[:, :lp_k],
                  idx[:, :lp_k].to(torch.int32).view(torch.float32)]
    return torch.cat(parts, dim=-1)


def pack_plane_from_lanes(tokens, lanes):
    """The ``pack_logprob_block`` layout from the lanes dict of
    ``repro_torch.sampling.sample_step`` (chosen logprob + top-K values and
    ids), so a sampled page reuses the fused-sampling pass for its
    logprobs instead of a second full-vocabulary log_softmax and sort."""
    parts = [tokens.to(torch.int32).view(torch.float32)[:, None],
             lanes["chosen_lp"][:, None]]
    if lanes["top_vals"] is not None:
        parts += [lanes["top_vals"],
                  lanes["top_idx"].to(torch.int32).view(torch.float32)]
    return torch.cat(parts, dim=-1)


def unpack_logprob_block(block_np):
    """Inverse of ``pack_logprob_block`` for a (steps, B, 2+2K) host array:
    (tokens (steps, B) int32, chosen logprobs (steps, B) f32, top-K values
    (steps, B, K) f32 | None, top-K ids (steps, B, K) int32 | None)."""
    K = (block_np.shape[-1] - 2) // 2
    tokens = np.ascontiguousarray(block_np[..., 0]).view(np.int32)
    chosen = block_np[..., 1]
    if K == 0:
        return tokens, chosen, None, None
    vals = block_np[..., 2:2 + K]
    ids = np.ascontiguousarray(block_np[..., 2 + K:]).view(np.int32)
    return tokens, chosen, vals, ids


def decode_page(cfg: ModelConfig, params, cache, tokens, lengths, remaining,
                steps: int, sampling=None, lp_k=None, flags=None) -> Tuple:
    """Decode megastep: ``steps`` decode steps with tokens, lengths,
    ``remaining`` and the cache kept on the device; each step's token
    feeds the next, and a slot stops advancing once its ``remaining``
    reaches zero (its writes land one past its valid region, as in the
    JAX scan).  Returns ``(token_block (steps, B), tokens, lengths,
    remaining, cache)``; row t is each slot's token after step t.

    With ``sampling=(sp, state)`` (device rows of ``pack_params`` and the
    per-slot PRNG / penalty state of ``repro_torch.sampling``) each step
    draws through ``sample_step`` under the static ``flags`` instead of
    the argmax; stop-token hits zero a slot's ``remaining`` on the
    device, and the advanced ``state`` is appended to the returned tuple.

    With ``lp_k`` set (0: the chosen token's logprob only; K > 0: also the
    top K) each step's row is the packed ``pack_logprob_block`` plane,
    (steps, B, 2+2K) f32, of the RAW model logits, so logprobs ride the
    page's one copy and report pre-filter values under sampling too."""
    return page_loop(
        lambda c, t, ln: decode_step_logits(cfg, params, c, t, ln), cache,
        tokens, lengths, remaining, steps, sampling=sampling, lp_k=lp_k,
        flags=flags)


def page_loop(step_logits: Callable, cache, tokens, lengths, remaining,
              steps: int, sampling=None, lp_k=None, flags=None) -> Tuple:
    """The decode page's loop around one model step, ``step_logits(cache,
    tokens, lengths) -> (logits (B, V), cache)``: the monolithic step of
    ``decode_page`` or the module-granularity step of
    ``core.forward.ModuleRuntime``.  Arguments and return as
    ``decode_page``."""
    if sampling is not None:
        from repro_torch.sampling import DEFAULT_FLAGS, sample_step
        sp, state = sampling
        flags = flags or DEFAULT_FLAGS
    rows = []
    for _ in range(steps):
        logits, cache = step_logits(cache, tokens, lengths)
        if sampling is None:
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            live = remaining > 0
            step = live.to(torch.int32)
            remaining = remaining - step
        elif lp_k is None:
            nxt, live, remaining, state = sample_step(logits, remaining,
                                                      state, sp, flags)
            step = live.to(torch.int32)
        else:
            nxt, live, remaining, state, lanes = sample_step(
                logits, remaining, state, sp, flags, lp_k=lp_k)
            step = live.to(torch.int32)
        tokens = torch.where(live, nxt, tokens)
        lengths = lengths + step
        if lp_k is None:
            rows.append(tokens)
        elif sampling is None:
            rows.append(pack_logprob_block(tokens, logits, lp_k))
        else:
            rows.append(pack_plane_from_lanes(tokens, lanes))
    out = (torch.stack(rows), tokens, lengths, remaining, cache)
    return out if sampling is None else out + (state,)
