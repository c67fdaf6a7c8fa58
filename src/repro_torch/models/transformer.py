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

Over a ``distributed/collectives.py::Comm`` every family also trains
(``forward_loss``, the ``tp`` regime) and serves (``prefill`` in the
``tp`` regime, its cache handed over in the decode layout;
``decode_step`` in the decode regime over a sequence-split cache, MLA's
latent cache split the same way, a window's ring split by slots, the
encoder-decoder's cross cache by encoder positions) as one rank of a
mesh: attention split over q heads or, where they do not split, over q
positions (the ``seq`` mode, ``_seq_share``); the SSM over its channels
and heads (its gated norm's mean square all-reduced), the RG-LRU over
its channels and gate blocks, their states and convolutions split the
same way in both regimes.  In the ``fsdp`` regime (``comm.fsdp``) every
family trains, each rank on its shards gathered where they are read.
In groups of one each is the one-device function, bit for bit: every
family's trunk (``_blocks``, ``_block_fwd``, ``_decode_block``) is the
multi-GPU body, run on one device too.

A windowed prefill returns the reference's ring, min(window, S) slots
(``fold_ring``); ``install_ring`` re-lays it into ``init_cache``'s ring of
min(window, max_len) slots before decode.  Decoding straight from the
prefill's ring, as the reference's shapes would have it, writes position
S into slot S % S = 0 while position 0 is still in the window whenever S
< window: the port repairs that, and its decode equals the
teacher-forced forward.
"""
from __future__ import annotations

import functools
import math
import weakref
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import compat
from repro_torch.distributed.collectives import LOCAL
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


# the top-level keys whose leaves stack the layers on a leading axis
STACKS = ("layers", "enc_layers", "units", "tail")


def _map_spec(spec, fn, path=()):
    if isinstance(spec, dict):
        return {k: _map_spec(v, fn, path + (k,)) for k, v in spec.items()}
    return fn(path, spec)


def _leaf_dtype(cfg: ModelConfig, spec) -> torch.dtype:
    return compat.torch_dtype(spec[2] if len(spec) > 2 else cfg.dtype)


def init_params(cfg: ModelConfig, seed: int = 0, device=None, *,
                part=None):
    """Random weights drawn from a seeded ``torch.Generator`` on the target
    device (normal draws in fp32, scaled in place, cast to each leaf's
    dtype).  A stacked layer leaf is drawn one layer at a time into its
    final tensor, and a leaf with an expert axis one (layer, expert) at a
    time, so the fp32 temporary is one expert's matrix at most
    (DeepSeek-R1's ``moe.w1`` is 7.5 GB a layer in bf16; drawn a layer at
    a time its fp32 draw would take 15.0 GB, an expert at a time 58.7 MB).
    They are not the JAX package's draws; use ``params_from_numpy`` for
    those.

    ``part(path, shape)``, a tuple of one slice a dim
    (``distributed/sharding.py::part_of``), keeps only that part of each
    leaf: every draw is still made, in the same order, so the result is
    ``shard_params`` of the full tree in bits, but the full tree is never
    held (a rank of a model larger than one card draws its slices on its
    card)."""
    dev = compat.resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def draw(shape, scale, dt):
        x = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return x.mul_(scale).to(dt)

    def make(path, spec):
        shape, scale, dt = spec[0], spec[1], _leaf_dtype(cfg, spec)
        sl = (slice(None),) * len(shape) if part is None \
            else part(path, shape)
        idx = [range(n)[s] for n, s in zip(shape, sl)]
        local = tuple(len(r) for r in idx)
        if scale == "ones":
            return torch.ones(local, dtype=dt, device=dev)
        if scale == "zeros":
            return torch.zeros(local, dtype=dt, device=dev)
        if scale == "a_log":
            return ssm.a_log_init(shape[-1], dev).expand(shape)[sl].to(dt) \
                .contiguous()
        if scale == "lam":
            return rglru.lam_init(shape, gen, dev)[sl].to(dt).contiguous()
        if path[0] not in STACKS:
            return draw(shape, scale, dt)[sl].contiguous()
        out = torch.empty(local, dtype=dt, device=dev)
        experts = path[-2] == "moe" and len(shape) == 4   # (L, E, ., .)
        for i in range(shape[0]):
            if experts:
                for e in range(shape[1]):
                    x = draw(shape[2:], scale, dt)
                    if i in idx[0] and e in idx[1]:
                        out[idx[0].index(i), idx[1].index(e)] = x[sl[2:]]
            else:
                x = draw(shape[1:], scale, dt)
                if i in idx[0]:
                    out[idx[0].index(i)] = x[sl[1:]]
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
    return _gemma_scale(cfg, params["embed"][tokens.long()])


def _gemma_scale(cfg, h):
    """The hybrid's embedding times sqrt(d_model), the factor rounded to
    h's dtype first (gemma's); the others' as it is."""
    if cfg.family != "hybrid":
        return h
    return h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype,
                            device=h.device)


def embed_finish(cfg, params, h, patches=None):
    """The embedding's rows h (B, S, D) made the trunk's input: the
    hybrid's scale (``_gemma_scale``), Pixtral's patches placed before
    them (``place_patches``), the encoder-decoder's sinusoid positions
    added.  Over a model group h is the ranks' ``embed_share`` summed and
    this runs once, after the reduce: before it the patches and the
    positions would count once a rank (the scale is the same either way:
    the reduce adds zeros to the owning rank's row).  Returns (h,
    positions (B, S'))."""
    h, positions = place_patches(cfg, params, _gemma_scale(cfg, h), patches)
    if cfg.family == "audio":
        h = h + layers.sinusoid_pos(positions, cfg.d_model, h.dtype)
    return h, positions


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


def _same(*ts):
    return ts[0] if len(ts) == 1 else ts


def seq_split(cfg: ModelConfig, tp: int) -> bool:
    """Whether attention over ``tp`` ranks runs in the ``seq`` mode
    (``distributed/sharding.py::attention_mode``): the q heads do not
    split over them."""
    return tp > 1 and cfg.num_heads % tp != 0


def seq_rows(S: int, m: int, tp: int) -> Tuple[int, int]:
    """The q rows [lo, hi) of rank ``m`` of ``tp`` in the ``seq`` mode:
    the reference's contiguous ``P(batch, model, None, None)`` split,
    ceil(S / tp) rows a rank (the last ranks' fewer or none when S does
    not split)."""
    c = -(-S // tp)
    return min(S, m * c), min(S, (m + 1) * c)


def attention_share(cfg: ModelConfig, p, h, positions, tab, m: int = 0,
                    tp: int = 1, copy=_same, want_kv: bool = False, *,
                    leaves: str = "attn", norm: str = "ln1", window=None,
                    causal: bool = True, states=None):
    """The layer's attention sublayer on the residual stream h, or rank
    ``m`` of ``tp``'s partial output of it: the norm ``p[norm]``, then
    attention over the rank's q-head shard of the leaves ``p[leaves]``
    (``layers.tp_attention_params``; MLA's q, k_nope and v of its heads
    from its shards of ``wq_b``, ``wk_b`` and ``wv_b``, the latent and its
    norms from the replicated ``MLA_WHOLE``) through ``wo``'s rows of
    those heads.  The ranks' outputs sum to the sublayer's (the caller's
    reduce).  ``copy`` wraps what every rank reads whole (the model
    group's ``copy_in``: its gradient sums over the ranks); at tp 1 it is
    the identity and this is the one-device sublayer.  With ``want_kv``
    returns (output, (k, v)): the K/V of the kv heads the rank's q heads
    read (MLA: its latent cache leaves), what a prefill keeps, the same
    on every rank).  The kv leaves that do not split over ``tp``
    (``MLA_WHOLE``, a replicated kv head) are read whole, through the
    same ``copy`` as the normed input (one all-reduce of their
    gradients).  MLA whose q heads do not split raises: it has no ``seq``
    mode.  When the q heads do not split over ``tp`` (``seq_split``) the
    rank's share is ``_seq_share``'s.

    The same share serves every attention sublayer of the port: the
    decoders' (``leaves`` "attn"), the hybrid's local attention
    (``leaves`` "t", ``window`` ``cfg.local_window``), the encoder's
    (``causal`` False) and the encoder-decoder's cross-attention
    (``leaves`` "xattn", ``norm`` "ln2", ``causal`` False, ``states``
    the encoder's (states, positions): K/V from the rank's ``wk`` /
    ``wv`` heads over them; the caller reads the states through its
    ``copy`` once).  ``window`` None is ``cfg.sliding_window``; RoPE is
    applied where ``tab`` is given, none where it is None (the
    encoder-decoder)."""
    attn = p[leaves]
    w = cfg.sliding_window if window is None else window
    if cfg.use_mla:
        if cfg.num_heads % tp:
            raise NotImplementedError(f"{cfg.name}: MLA's {cfg.num_heads} "
                                      f"q heads do not split over {tp} ranks")
        whole = MLA_WHOLE
    elif seq_split(cfg, tp):
        out = _seq_share(cfg, p, h, positions, tab, m, tp, copy,
                         leaves=leaves, norm=norm, window=w, causal=causal,
                         states=states)
        return out if want_kv else out[0]
    else:
        whole = [] if cfg.num_kv_heads % tp == 0 else \
            sorted(k for k in ("wk", "wv", "bk", "bv") if k in attn)
    xn, *ws = _copied(copy, layers.apply_norm(cfg, p[norm], h),
                      *(attn[k] for k in whole))
    pa = dict(attn, **dict(zip(whole, ws)))
    if cfg.use_mla:
        out = layers.mla_fwd(cfg, pa, xn, positions, rope_tab=tab)
    else:
        pa = layers.tp_attention_params(cfg, pa, m, tp)
        kv = None if states is None else layers.kv_from_states(cfg, pa,
                                                               states[0])
        out = layers.attention_fwd(
            cfg, pa, xn, positions, rope_tab=tab, window=w, causal=causal,
            use_rope=tab is not None, kv=kv,
            kv_positions=None if states is None else states[1])
    return out if want_kv else out[0]


# MLA's leaves every rank of the ``tp`` regime reads whole (``_leaf_rule``):
# the low-rank down-projections and their norms
MLA_WHOLE = ("kv_norm", "q_norm", "wkv_a", "wq_a")
# the SSM's leaves every rank reads whole: B and C (one group, shared by
# every head) and their convolutions
SSM_WHOLE = ("conv_B", "conv_C", "wB", "wC")


def _copied(copy, *ts):
    """``copy`` of the tensors ``ts``, as a tuple."""
    out = copy(*ts)
    return out if len(ts) > 1 else (out,)


def _seq_share(cfg: ModelConfig, p, h, positions, tab, m: int, tp: int,
               copy, *, leaves: str = "attn", norm: str = "ln1",
               window: int = 0, causal: bool = True, states=None):
    """Rank ``m`` of ``tp``'s share of the attention sublayer in the
    ``seq`` mode (q positions over the model group, K/V replicated; the
    attention leaves replicated, ``_leaf_rule``): the norm of the whole
    h; k and v of every position (of the encoder's ``states`` for the
    cross-attention); q of the rank's rows ``seq_rows`` only, RoPE at
    their positions where ``tab`` is given; ``flash_attention`` of those
    rows at their positions against every key (causal or not, ``window``
    and the softcap as configured); ``wo`` on the rows, placed in a (B,
    S, D) tensor of zeros, which the caller reduces as the ``heads``
    mode's partial.  The normed input and every attention leaf pass
    through one ``copy`` (one all-reduce of their gradients: each rank's
    rows give a part of every one).  Leaves, norm and the rest as
    ``attention_share``.  Returns (output, (k, v)): every kv head's K/V
    at every position."""
    attn = p[leaves]
    names = sorted(attn)
    xn, *ws = _copied(copy, layers.apply_norm(cfg, p[norm], h),
                      *(attn[k] for k in names))
    pa = dict(zip(names, ws))
    if states is None:
        k, v = layers.kv_from_states(cfg, pa, xn)
        kv_pos = positions
        if tab is not None:
            k = layers.apply_rope(k, tab)
    else:
        (k, v), kv_pos = layers.kv_from_states(cfg, pa, states[0]), states[1]
    S = h.shape[1]
    lo, hi = seq_rows(S, m, tp)
    if hi == lo:
        return torch.zeros_like(h), (k, v)
    q = layers._q_proj(cfg, pa, xn[:, lo:hi])
    if tab is not None:
        q = layers.apply_rope(q, (tab[0][:, lo:hi], tab[1][:, lo:hi]))
    o = layers.chunked_attention(q, k, v, positions[:, lo:hi], kv_pos,
                                 causal=causal, window=window,
                                 softcap=cfg.logit_softcap)
    y = layers._merge_heads(o, pa["wo"])
    return torch.nn.functional.pad(y, (0, 0, lo, S - hi)), (k, v)


def ffn_share(cfg: ModelConfig, p, h, m: int = 0, tp: int = 1, copy=_same,
              route=None, norm: str = "ln2"):
    """The layer's feed-forward sublayer on h, or rank ``m`` of ``tp``'s
    partial of it, as ``attention_share``: the norm ``p[norm]`` (the
    encoder-decoder's decoder layers: "ln3"), then the MoE over the
    rank's E/tp experts and shared-expert columns (``moe.moe_fwd``, the
    router whole; routed over the data group ``route`` as one batch where
    one is given) or the gated MLP over its columns.  Returns (partial
    output, partial aux): the MoE's load-balance aux (fp32 scalar), None
    for the MLP; each sums over the ranks to the layer's."""
    xn = copy(layers.apply_norm(cfg, p[norm], h))
    if cfg.is_moe:
        pm = dict(p["moe"], wg=copy(p["moe"]["wg"]))
        return moe.moe_fwd(cfg, pm, xn, m, tp, route)
    return layers.mlp_fwd(cfg, p["mlp"], xn), None


def ssm_share(cfg: ModelConfig, p, h, copy=_same, group=None,
              want_cache: bool = False):
    """The SSM layer's block on h (its norm, then ``ssm.ssm_fwd``), or one
    rank's partial of it on its channel shard of ``p["ssm"]``: the normed
    input and ``SSM_WHOLE`` read through one ``copy`` (each rank's heads
    give a part of B's and C's gradients), the gated norm's mean square
    over ``group`` (the model group).  The ranks' outputs sum to the
    block's.  With ``want_cache`` returns (output, the rank's decode
    cache)."""
    ps = p["ssm"]
    xn, *ws = _copied(copy, layers.apply_norm(cfg, p["ln1"], h),
                      *(ps[k] for k in SSM_WHOLE))
    return ssm.ssm_fwd(cfg, dict(ps, **dict(zip(SSM_WHOLE, ws))), xn,
                       return_state=want_cache, group=group)


def rglru_share(cfg: ModelConfig, p, h, copy=_same,
                want_cache: bool = False):
    """The hybrid's RG-LRU sublayer on h (its norm, then
    ``rglru.rglru_fwd`` of ``p["t"]``), or one rank's partial of it on its
    channel shard (its gate blocks; the recurrence is the rank's own),
    the normed input read through ``copy``.  With ``want_cache`` returns
    (output, the rank's state and conv)."""
    xn = copy(layers.apply_norm(cfg, p["ln1"], h))
    return rglru.rglru_fwd(cfg, p["t"], xn, return_state=want_cache)


def ffn(cfg: ModelConfig, p, h):
    """The layer's second half on the residual stream h, added back to h
    (``ffn_share`` on one device).  Returns (h, aux)."""
    y, aux = ffn_share(cfg, p, h)
    return h + y, aux


def install_ring(dst, src):
    """Re-lay a prefill ring ``src`` ({"k", "v", "pos"} of Ws slots, as
    ``_prefill_trunk`` makes it, with any leading axes) into ``dst``, a ring of
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


def _assemble_inputs(cfg, params, tokens, patches=None):
    """Token embeddings on one device, after Pixtral's stub patch
    embeddings (``embed_finish``).  Returns (h, positions)."""
    return embed_finish(cfg, params, params["embed"][tokens.long()], patches)


def place_patches(cfg, params, h, patches=None):
    """The token embeddings ``h`` (B, S, D) after Pixtral's stub patch
    embeddings (B, P, D) times ``adapter`` when given (an fp32 product,
    cast to h's dtype); positions then run over P + S.  Over a model group
    h is the reduced embedding (the ranks' ``embed_share`` summed) and the
    patches are placed once, after the reduce: placed before it they would
    count once a rank.  Returns (h, positions (B, S'))."""
    if cfg.family == "vlm" and patches is not None:
        pe = torch.matmul(patches.float(), params["adapter"].float())
        h = torch.cat([pe.to(h.dtype), h], dim=1)
    B, S = h.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=h.device)[None].expand(B, S)
    return h, positions


def _enc_inputs(cfg, params, frames):
    """The encoder's input: stub frame embeddings (B, Se, D) times
    ``adapter`` (an fp32 product, cast to ``cfg.dtype``) plus sinusoid
    positions.  Returns (h, positions (B, Se))."""
    dt = compat.torch_dtype(cfg.dtype)
    h = torch.matmul(frames.float(), params["adapter"].float()).to(dt)
    B, S = h.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=h.device)[None].expand(B, S)
    return h + layers.sinusoid_pos(positions, cfg.d_model, h.dtype), positions


def _window(cfg: ModelConfig) -> int:
    """The attention window of the model's windowed sublayers: the
    hybrid's ``local_window``, else ``cfg.sliding_window`` (0: none)."""
    return cfg.local_window if cfg.family == "hybrid" else cfg.sliding_window


def _blocks(cfg: ModelConfig, params):
    """(kind, leaves, cache path, index) of each step of the decoder trunk
    in order: "layer" (a dense, MoE or vision decoder layer), "ssm", the
    hybrid's "rec" and "attn" sublayers (its units' ``b0`` .., then its
    tail layers), "dec" (an encoder-decoder decoder layer).  The cache
    path is where the step's cache leaves sit in the cache tree (() for a
    flat cache), the index their position on the leaves' leading axis."""
    if cfg.family == "hybrid":
        for i, p in enumerate(_per_layer(params, "units")):
            for j, kind in enumerate(cfg.block_pattern):
                yield kind, p[f"b{j}"], ("units", f"b{j}"), i
        if "tail" in params:
            for i, p in enumerate(_per_layer(params, "tail")):
                yield "rec", p, ("tail",), i
        return
    kind = {"ssm": "ssm", "audio": "dec"}.get(cfg.family, "layer")
    for i, p in enumerate(_per_layer(params)):
        yield kind, p, (), i


def _block_fwd(cfg: ModelConfig, kind: str, p, h, positions, tab, model,
               *, want_cache: bool = False, slots: int = 0, enc=None,
               route=None):
    """One step of a trunk over the sequence on rank ``model.rank`` of the
    model group (the ``tp`` regime; in a group of one the one-device
    step): each sublayer this rank's share (``attention_share``,
    ``ffn_share``, ``ssm_share``, ``rglru_share``), its input read
    through the group's ``copy_in`` and its partial output all-reduced
    (``reduce_out``) into h.  ``kind`` as ``_blocks`` gives it, or "enc"
    (an encoder layer: non-causal, no RoPE).  "dec" runs the causal
    self-attention, the cross-attention on ``enc`` (the encoder's states
    and positions) and the MLP.  Returns (h, the FFN's partial aux or
    None, the step's cache or None): with ``want_cache`` its K/V ({"k",
    "v"}; MLA's {"ckv", "kr"}; folded into a ring of ``slots`` where the
    sublayer is windowed; the decoder layer's {"k", "v", "xk", "xv"}),
    the SSM's or the RG-LRU's decode cache, each the rank's."""
    reduce, copy = model.reduce_out, model.copy_in
    share = dict(m=model.rank, tp=model.size, copy=copy)
    if kind == "ssm":
        y = ssm_share(cfg, p, h, copy, model, want_cache)
        y, cache = y if want_cache else (y, None)
        return h + reduce(y), None, cache
    cache = None
    if kind == "rec":
        y = rglru_share(cfg, p, h, copy, want_cache)
        y, cache = y if want_cache else (y, None)
    else:
        y, kv = attention_share(
            cfg, p, h, positions, tab, **share, want_kv=True,
            leaves="t" if kind == "attn" else "attn",
            window=_window(cfg), causal=kind != "enc")
        if kind == "dec":
            h = h + reduce(y)
            y, xkv = attention_share(cfg, p, h, positions, None, **share,
                                     want_kv=True, leaves="xattn",
                                     norm="ln2", causal=False, states=enc)
            kv = tuple(kv) + tuple(xkv)
        if want_cache:
            if slots and kind != "enc":
                kv = [fold_ring(t, slots) for t in kv]
            names = ("ckv", "kr") if cfg.use_mla else ("k", "v", "xk", "xv")
            cache = dict(zip(names, kv))
    h = h + reduce(y)
    y, aux = ffn_share(cfg, p, h, **share, route=route,
                       norm="ln3" if kind == "dec" else "ln2")
    return h + reduce(y), aux, cache


def _encoder(cfg: ModelConfig, params, frames, model):
    """The encoder over stub frame embeddings (B, Se, D) on rank
    ``model.rank`` of the model group: ``_enc_inputs`` (on every rank, as
    the vision patches are placed), its layers (``_block_fwd`` "enc"),
    then ``enc_norm``.  Returns (states (B, Se, D), positions (B, Se)),
    whole on every rank."""
    h, positions = _enc_inputs(cfg, params, frames)
    for p in _per_layer(params, "enc_layers"):
        h = _block_fwd(cfg, "enc", p, h, positions, None, model)[0]
    return layers.apply_norm(cfg, params["enc_norm"], h), positions


def _encode(cfg, params, frames):
    """The encoder on one device (``_encoder``)."""
    return _encoder(cfg, params, frames, LOCAL.model)


def _check_stubs(cfg: ModelConfig, frames, patches) -> None:
    """Raise ``ValueError`` on frames outside the encoder-decoder, patches
    outside the vision decoder, or the encoder-decoder without frames of
    (B, encoder_seq, d_model)."""
    if (frames is not None and cfg.family != "audio") or \
            (patches is not None and cfg.family != "vlm"):
        raise ValueError(f"{cfg.name}: frames are Whisper's input and "
                         f"patches Pixtral's, not the {cfg.family} "
                         f"family's")
    if cfg.family == "audio":
        got = None if frames is None else tuple(frames.shape)
        if got is None or got[1:] != (cfg.encoder_seq, cfg.d_model):
            raise ValueError(f"{cfg.name}: the encoder needs frames of (B, "
                             f"{cfg.encoder_seq}, {cfg.d_model}), got {got}")


def _backbone(cfg: ModelConfig, params, tokens, *, frames=None,
              patches=None):
    """tokens (B, S) -> (final-normed hidden (B, S', D), cache) on one
    device: ``_prefill_trunk`` over ``LOCAL``.  The cache is
    ``init_cache``'s leaves at max_len S', an SSM's decode cache, or for
    a window the reference's prefill rings of min(window, S) slots
    (``install_rings`` takes them to a decode cache).  S' is S, or P + S
    with Pixtral's ``patches`` (B, P, D) placed first; the
    encoder-decoder needs ``frames`` (B, encoder_seq, D)."""
    check_model(cfg)
    _check_stubs(cfg, frames, patches)
    return _prefill_trunk(cfg, params, tokens, LOCAL.model, patches,
                          frames=frames)


# ---------------------------------------------------------------------------
# training: forward_loss and the chunked cross-entropy
# ---------------------------------------------------------------------------

CE_CHUNK = 512
# weight of the MoE load-balance aux in the loss, over the layers
# (``repro.models.transformer.AUX_COEF``)
AUX_COEF = 0.01


def check_trainable(cfg: ModelConfig, tp: int = 1) -> None:
    """What ``forward_loss`` trains: every family ``check_model`` serves,
    as the reference's ``forward_loss`` does (dense decoders, a sliding
    window among them; MoE decoders with GQA or MLA attention; Mamba-2
    SSMs; the RecurrentGemma hybrid; the Whisper encoder-decoder; the
    Pixtral vision decoder), over a model group of ``tp`` ranks too:
    attention over the q heads (``distributed/sharding.py::
    attention_mode`` "heads") or, where GQA heads do not split, over the
    q positions (``seq_split``); the SSM's channels and heads, the
    RG-LRU's channels and gate blocks, the experts or MLP columns and the
    vocabulary split over ``tp``.  A model whose rules leave one of these
    replicated raises, naming it (``_split_refusal``)."""
    check_model(cfg)
    why = _split_refusal(cfg, tp) if tp > 1 else None
    if why:
        raise NotImplementedError(
            f"{cfg.name} at tp {tp}: {why} (the tp regime splits it over "
            f"the model group)")


def _split_refusal(cfg: ModelConfig, tp: int):
    """What of a model does not split over ``tp`` ranks under the
    reference's rules (its vocabulary, experts or MLP columns, MLA's q
    heads, the SSM's channels and heads, the RG-LRU's gate blocks), or
    None."""
    if padded_vocab(cfg) % tp:
        return "a replicated vocabulary"
    if cfg.use_mla and cfg.num_heads % tp:
        return "MLA q heads that do not split (MLA has no seq mode)"
    if cfg.is_moe and (cfg.num_experts % tp or (
            cfg.num_shared_experts and cfg.shared_d_ff % tp)):
        return "replicated experts"
    if not cfg.is_moe and cfg.d_ff % tp:
        return "a replicated MLP"
    if cfg.family == "ssm" and (cfg.d_inner % tp or cfg.ssm_heads % tp or
                                cfg.ssm_groups > 1):
        return (f"SSM channels or heads that do not split ({cfg.d_inner} "
                f"channels, {cfg.ssm_heads} heads, {cfg.ssm_groups} groups; "
                f"B and C are replicated, so one group)")
    if cfg.family == "hybrid" and (cfg.lru_width % tp or
                                   rglru.RG_BLOCKS % tp):
        return (f"RG-LRU gate blocks that do not split ({rglru.RG_BLOCKS} "
                f"blocks of {cfg.lru_width} channels: the rules would "
                f"split the channels and replicate the gates, or the "
                f"reverse)")
    return None


def check_servable(cfg: ModelConfig, tp: int, kind: str) -> None:
    """What the serving cells of ``launch/steps.py::build_cell`` take
    (``kind`` "prefill" or "decode") over a model group of ``tp`` ranks:
    every family, whose vocabulary, experts or MLP columns, SSM channels
    and heads or RG-LRU gate blocks split over ``tp`` (``_split_refusal``;
    a window's ring must split too, ``ring_slots``).  A prefill runs the
    ``tp`` regime's q-head split, or its q-position split where GQA heads
    do not split (``seq_split``); the decode regime replicates the
    attention weights and splits the caches' sequence (GQA, MLA's latent,
    the encoder-decoder's self and cross caches), a ring's slots, or the
    SSM's and RG-LRU's states and convolutions by channel.  The rest
    raises, naming what does not split."""
    check_model(cfg)
    why = _split_refusal(cfg, tp) if tp > 1 else None
    if why:
        raise NotImplementedError(
            f"{cfg.name} {kind} at tp {tp}: {why} (the serving cells split "
            f"it over the model group)")


def ce_shard(cfg, params, h, labels, m: int = 0, tp: int = 1, copy=_same):
    """Rank ``m`` of ``tp``'s statistics of one chunk's cross-entropy over
    its vocabulary shard of ``lm_head`` (V/tp columns, h read through
    ``copy`` as ``attention_share`` reads it): each row's log-sum-exp of
    the shard's fp32 logits, and the label's logit where this shard owns
    the label (0 elsewhere).  ``ce_merge`` combines the ranks'."""
    logits = logits_fn(cfg, params, copy(h))
    Vl = logits.shape[-1]
    lse = torch.logsumexp(logits, dim=-1)
    t = labels.long() - m * Vl
    own = (t >= 0) & (t < Vl)
    ll = torch.gather(logits, -1, t.clamp(0, Vl - 1)[..., None])[..., 0]
    return lse, torch.where(own, ll, 0.0)


def ce_merge(lse, ll, labels, max_over, sum_over):
    """(sum of the valid rows' losses, their count) of one chunk from the
    ranks' ``ce_shard`` statistics, ``max_over`` and ``sum_over``
    reducing over the ranks (on the multi-GPU path the model group's
    all-reduce of the max and its ``reduce_out``): the ranks'
    log-sum-exps joined past their max (detached: a shift), minus the
    label's logit, labels < 0 left out.  One rank's log-sum-exp comes
    back in its bits, and so does its gradient (exp(0) is 1, log 1 is
    0), so a group of one gives one device's loss and gradients whether
    its collectives are skipped or sent."""
    top = max_over(lse.detach())
    lse = torch.log(sum_over(torch.exp(lse - top))) + top
    valid = (labels >= 0).float()
    return ((lse - sum_over(ll)) * valid).sum(), valid.sum()


def _chunk_ce_tp(cfg, params, h, labels, model):
    """(sum of the valid rows' losses, their count) of one chunk over the
    model group ``model``, the vocabulary split across it: this rank's
    ``ce_shard`` merged by the group's collectives (in a trivial group
    the one device's chunk: the collectives are identities)."""
    stats = ce_shard(cfg, params, h, labels, model.rank, model.size,
                     model.copy_in)
    return ce_merge(*stats, labels, lambda t: model.all_reduce(t, "max"),
                    model.reduce_out)


def _chunked_ce(cfg: ModelConfig, params, h, labels, comm=LOCAL):
    """Mean cross-entropy of ``labels`` (B, S) against the logits of the
    final hidden states ``h`` (B, S, D), without the (B, S, V) logits:
    chunks of ``CE_CHUNK`` positions, each under ``torch.utils.checkpoint``
    so its backward recomputes the chunk's (B, c, V) fp32 logits instead
    of keeping them (``repro.models.transformer._chunked_ce``'s
    ``jax.checkpoint``).  The label of position t scores position t's
    logits, unshifted, as the reference does.  Over ``comm``
    (``distributed/collectives.py::Comm``) the vocabulary splits over its
    model group (``_chunk_ce_tp``) and this rank's summed loss is divided
    by the count of valid labels over its data group: the data group's
    sum of the results is the batch's mean.  One device runs the same
    merge (``ce_merge`` keeps its bits)."""
    model = comm.model
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for s0 in range(0, h.shape[1], CE_CHUNK):
        args = (cfg, params, h[:, s0:s0 + CE_CHUNK],
                labels[:, s0:s0 + CE_CHUNK])
        t, n = checkpoint(_chunk_ce_tp, *args, model, use_reentrant=False,
                          preserve_rng_state=False)
        tot, cnt = tot + t, cnt + n
    cnt = comm.data.all_reduce(cnt)
    return tot / torch.clamp_min(cnt, 1.0)


def _index(stack, i):
    return _map_spec(stack, lambda path, t: t[i])


def _taker(comm, name: str):
    """``(stack, i) -> layer i's leaves`` of the stack ``name``: ``t[i]``
    of each stacked leaf (``_index``), and in the ``fsdp`` regime each
    gathered whole from this rank's shard there (``comm.fsdp``), so that
    a layer's weights are whole only while it runs (and again in its
    recompute under remat)."""
    if comm.fsdp is None:
        return _index
    return lambda stack, i: _map_spec(
        stack, lambda path, t: comm.fsdp((name,) + path, t[i]))


def _gather_unstacked(params, comm):
    """``params`` with each leaf outside the layer stacks (the embedding,
    ``lm_head``, the final and encoder norms, ``adapter``) gathered whole
    in the ``fsdp`` regime; the stacks stay this rank's shards."""
    if comm.fsdp is None:
        return params
    return {k: v if k in STACKS else
            _map_spec(v, lambda path, t, k=k: comm.fsdp((k,) + path, t))
            if isinstance(v, dict) else comm.fsdp((k,), v)
            for k, v in params.items()}


def _train_layer(cfg, stack, i, h, positions, tab, comm=LOCAL, take=_index):
    """Layer ``i`` of the training trunk: its leaves indexed from the
    stacked ones (``take``: ``t[i]``, which autograd follows back to them;
    gathered in the ``fsdp`` regime, ``_taker``).  Returns
    (h, aux) as ``ffn``; an SSM layer ``h + ssm_fwd(norm(h))`` and no aux,
    as the reference's ``_layer_fwd`` (its chunked SSD's scan through
    ``SsdScanFn``); MLA attention through ``mla_fwd`` (``tab`` at
    ``rope_head_dim``; the flash kernels at q/k dn + dr, v dn).  Under
    remat its recompute must route as the first run did: the router's fp32
    matmul, softmax and stable sort see the same inputs and give the same
    bits (``chip_smoke.py`` phase 13 compares the two runs' dispatch plans
    on the card).  Each sublayer is this rank's share over the model group
    of ``comm`` (``_block_fwd``) and the partial outputs (and aux) are
    all-reduced (``reduce_out``); in a group of one they are the
    one-device sublayers and nothing is sent.  In the ``fsdp`` regime an
    MoE routes the data group's rows as one batch, as the reference's
    ``_moe_local`` on the global batch does (one all-gather of the expert
    counts a layer, again in the recompute)."""
    h, aux, _ = _block_fwd(
        cfg, "ssm" if cfg.family == "ssm" else "layer", take(stack, i), h,
        positions, tab, comm.model,
        route=None if comm.fsdp is None else comm.data)
    return h, None if aux is None else comm.model.reduce_out(aux)


def _train_enc_layer(cfg, stack, i, h, positions, tab, comm=LOCAL,
                     take=_index):
    """Encoder layer ``i`` of the encoder-decoder (``_block_fwd`` "enc"),
    its leaves taken as ``_train_layer`` takes them.  Returns (h, None)."""
    return _block_fwd(cfg, "enc", take(stack, i), h, positions, None,
                      comm.model)[0], None


def _train_dec_layer(cfg, stack, i, h, positions, tab, enc=None,
                     comm=LOCAL, take=_index):
    """Decoder layer ``i`` of the encoder-decoder (``_block_fwd`` "dec",
    its K/V left unkept) on ``enc``, the encoder's (states, positions):
    every decoder layer reads the same states, so their gradient sums over
    the layers (and, over a model group, over the ranks: ``forward_loss``
    reads them through one ``copy_in``).  Returns (h, None)."""
    return _block_fwd(cfg, "dec", take(stack, i), h, positions, None,
                      comm.model, enc=enc)[0], None


def _train_unit(cfg, stack, i, h, positions, tab, comm=LOCAL, take=_index):
    """Unit ``i`` of the hybrid's trunk: its sublayers ``b0`` .. over
    ``cfg.block_pattern`` (``_block_fwd`` "rec" or "attn", without a
    cache), the leaves taken from the stacked ones as ``_train_layer``
    takes them.  Returns (h, None): the hybrid has no aux."""
    p = take(stack, i)
    for j, kind in enumerate(cfg.block_pattern):
        h = _block_fwd(cfg, kind, p[f"b{j}"], h, positions, tab,
                       comm.model)[0]
    return h, None


def _train_tail(cfg, stack, i, h, positions, tab, comm=LOCAL, take=_index):
    """Tail layer ``i`` of the hybrid (an RG-LRU sublayer), as
    ``_train_unit``."""
    return _block_fwd(cfg, "rec", take(stack, i), h, positions, tab,
                      comm.model)[0], None


def _train_steps(cfg, params, enc=None, comm=LOCAL):
    """(step function, its stacked leaves, index) of each step of the
    training trunk: the layers, the hybrid's units and then its tail
    layers, or the encoder-decoder's decoder layers on ``enc`` (the
    reference's ``_stack_fwd`` scans); each step takes ``comm`` and its
    leaves through ``_taker(comm, stack)``."""
    part = functools.partial
    if cfg.family == "audio":
        fn = part(_train_dec_layer, enc=enc, comm=comm,
                  take=_taker(comm, "layers"))
        return [(fn, params["layers"], i) for i in range(cfg.num_layers)]
    if cfg.family != "hybrid":
        fn = part(_train_layer, comm=comm, take=_taker(comm, "layers"))
        return [(fn, params["layers"], i) for i in range(cfg.num_layers)]
    n_units, n_tail = _hybrid_counts(cfg)
    unit = part(_train_unit, comm=comm, take=_taker(comm, "units"))
    tail = part(_train_tail, comm=comm, take=_taker(comm, "tail"))
    return [(unit, params["units"], i) for i in range(n_units)] + \
        [(tail, params["tail"], j) for j in range(n_tail)]


def _run_steps(steps, cfg, h, positions, tab, remat):
    """h through each (step function, stacked leaves, index) of
    ``steps``, each under ``torch.utils.checkpoint`` with ``remat``.
    Returns (h, the steps' summed aux or None)."""
    aux = None
    for fn, stack, i in steps:
        if remat:
            h, a = checkpoint(fn, cfg, stack, i, h, positions, tab,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            h, a = fn(cfg, stack, i, h, positions, tab)
        if a is not None:
            aux = a if aux is None else aux + a
    return h, aux


def embed_share(cfg, params, tokens, m: int = 0, tp: int = 1):
    """Rank ``m`` of ``tp``'s partial embedding of ``tokens`` over its
    vocabulary shard of ``embed`` (``padded_vocab``/tp rows): the rows of
    the tokens it owns, zeros for the others.  The ranks' sum is
    ``_embed_tokens``'s for the dense and MoE decoders."""
    emb = params["embed"]
    Vl = emb.shape[0]
    t = tokens.long() - m * Vl
    own = (t >= 0) & (t < Vl)
    return torch.where(own[..., None], emb[t.clamp(0, Vl - 1)], 0.0) \
        .to(emb.dtype)


def forward_loss(cfg: ModelConfig, params, batch, *, remat: bool = True,
                 comm=LOCAL):
    """Training loss of every family (``check_trainable``):
    ``batch["tokens"]`` (B, S) through the layer stack (the hybrid's units,
    then its tail layers), the final norm and the chunked cross-entropy
    against ``batch["labels"]`` (< 0: ignored), plus for MoE ``AUX_COEF``
    times the layers' summed load-balance aux over their count.  The
    encoder-decoder first runs its encoder over ``batch["frames"]`` (B,
    encoder_seq, D), a step a layer as the decoder's, and every decoder
    layer cross-attends to its states.  The vision decoder places
    ``batch["patches"]`` (B, P, D) times ``adapter`` before the tokens
    (``_assemble_inputs``): positions and ``labels`` then run over P + S
    (the reference's labels are -1 over the patches); a batch without
    patches leaves ``adapter`` out of the loss, as the reference does.
    The trunk builds no cache (an SSM no state and no rope table); with
    ``remat`` each layer (each encoder layer, each hybrid unit, each tail
    layer) runs under ``torch.utils.checkpoint`` and is recomputed in the
    backward (``_stack_fwd``'s ``jax.checkpoint`` around one scan step).
    Differentiable in every leaf of ``params`` that requires grad.

    Over ``comm`` (``distributed/collectives.py::Comm``) the loss is this
    rank's share on the multi-GPU path: ``params`` hold its local slices
    (``distributed/sharding.py::shard_params``, regime ``tp``) and
    ``batch`` its data shard; the embedding, each layer and the
    cross-entropy split over the model group, and the result is this
    rank's term of the data group's sum (the cross-entropy over the
    group's count of valid labels, the MoE aux over the group's size: the
    reference's ``pmean`` of the aux over every axis).  In groups of one
    every collective is skipped, and the loss and its gradients are the
    one device's, bit for bit.

    In the ``fsdp`` regime (``comm.fsdp``; ``comm.model`` a group of one,
    ``comm.data`` the world) ``params`` hold this rank's shards of every
    leaf under ``param_specs(..., "fsdp")`` and ``batch`` its rows: the
    one-device trunk of every family runs on each leaf gathered whole
    where it is read (``_gather_unstacked``, ``_taker``), an MoE routes
    the world's rows as one batch (``moe._spread_route_terms``: its
    capacity and aux the global batch's), and the loss is this rank's
    term of the world's sum."""
    model = comm.model
    check_trainable(cfg, model.size)
    frames, patches = batch.get("frames"), batch.get("patches")
    _check_stubs(cfg, frames, patches)
    params = _gather_unstacked(params, comm)
    if not model.trivial:
        # the vocabulary split over the group; the hybrid's scale, the
        # patches and the encoder-decoder's positions after its reduce
        # (``embed_finish``).  ``adapter``'s gradient is then the whole
        # one on every rank (the residual stream's gradient is), as a
        # norm's is
        h, positions = embed_finish(cfg, params, model.reduce_out(
            embed_share(cfg, params, batch["tokens"], model.rank,
                        model.size)), patches)
    else:
        h, positions = _assemble_inputs(cfg, params, batch["tokens"],
                                        patches)
    tab = None if cfg.family in ("ssm", "audio") else layers.rope_tables(
        positions, layers.rope_dim(cfg), cfg.rope_theta)
    enc = None
    if cfg.family == "audio":
        # the encoder on every rank, its layers split as the decoder's;
        # its states read by every decoder layer through one copy_in
        eh, enc_pos = _enc_inputs(cfg, params, frames)
        fn = functools.partial(_train_enc_layer, comm=comm,
                               take=_taker(comm, "enc_layers"))
        eh, _ = _run_steps([(fn, params["enc_layers"], i)
                            for i in range(cfg.encoder_layers)],
                           cfg, eh, enc_pos, None, remat)
        enc = (model.copy_in(layers.apply_norm(cfg, params["enc_norm"], eh)),
               enc_pos)
    h, aux = _run_steps(_train_steps(cfg, params, enc, comm), cfg, h,
                        positions, tab, remat)
    h = layers.apply_norm(cfg, params["final_norm"], h)
    loss = _chunked_ce(cfg, params, h, batch["labels"], comm)
    if cfg.is_moe:
        if not comm.data.trivial and comm.fsdp is None:
            aux = aux / comm.data.size
        loss = loss + AUX_COEF * aux / max(cfg.num_layers, 1)
    return loss


def prefill(cfg: ModelConfig, params, tokens, *, frames=None, patches=None,
            comm=LOCAL, max_len=None):
    """Prefill: returns (last-position logits (B, 1, V), cache).  Whisper
    needs ``frames`` (B, encoder_seq, D); Pixtral takes ``patches`` (B, P,
    D) before the tokens, so its cache holds P + S positions.  With
    ``max_len`` the full-attention cache is ``init_cache``'s of max_len
    positions, the prefill's in the first S, and a window's ring
    ``init_cache``'s of min(window, max_len) slots (``install_ring``'s
    layout); without it a ring is the reference's of min(window, S).  An
    SSM's cache and the RG-LRU's states do not grow with ``max_len``.

    Every family runs ``_prefill_shard`` over ``comm``: on the multi-GPU
    path one rank's prefill in the ``tp`` regime, the logits all-gathered
    and the cache this rank's shard in the decode layout; in groups of
    one (``LOCAL``) every collective is skipped and it is the one-device
    prefill."""
    _check_stubs(cfg, frames, patches)
    n = tokens.shape[1] + (0 if patches is None else patches.shape[1])
    return _prefill_shard(cfg, params, tokens, comm.model, max_len or n,
                          patches, frames)


def _prefill_trunk(cfg: ModelConfig, params, tokens, model, patches=None,
                   slots=None, frames=None):
    """Rank ``model.rank``'s trunk of a prefill of tokens (B, S) over the
    model group in the ``tp`` regime (``params`` its slices under
    ``param_specs(..., "tp")``; in a group of one the whole tree): the
    embedding over its vocabulary rows reduced, then ``embed_finish``
    (the hybrid's scale, the vision decoder's ``patches`` placed: S' = P
    + S positions, the encoder-decoder's positions), the encoder-decoder's
    encoder over ``frames`` (``_encoder``), each step of ``_blocks``
    (``_block_fwd`` without gradients: each sublayer's share reduced over
    the group; the MoE's aux dropped: serving has no loss), then the
    final norm.  Returns (h (B, S', D), cache): each step's cache stacked
    at its path, {"k", "v"} of the kv heads its q heads read, (L, B, S',
    Hl, dh) each (in the ``seq`` mode, ``seq_split``, every kv head;
    the encoder-decoder's cross K/V {"xk", "xv"} the same over the
    encoder's positions); MLA's {"ckv", "kr"} of every position, the
    same on every rank; a window's ring of ``slots`` (default min(window,
    S')) {"k", "v"} of its kv heads and "pos", each step's K/V folded in
    as it is made (``fold_ring``); the SSM's and the RG-LRU's decode
    caches over the rank's heads and channels (the hybrid's nested
    {"units": {"b<i>": ...}, "tail": ...}).  Collectives: 1 + 2 a
    reduced sublayer all-reduces (an SSM layer's norm counts as one)."""
    m, tp = model.rank, model.size
    h, positions = embed_finish(cfg, params, model.all_reduce(embed_share(
        cfg, params, tokens, m, tp)), patches)
    S = positions.shape[1]
    tab = None if cfg.family in ("ssm", "audio") else layers.rope_tables(
        positions, layers.rope_dim(cfg), cfg.rope_theta)
    enc = None if frames is None else _encoder(cfg, params, frames, model)
    ring = slots or min(_window(cfg), S) if _window(cfg) else 0
    dt = compat.torch_dtype(cfg.dtype)
    cache, count = {}, {}
    for kind, p, path, i in _blocks(cfg, params):
        count[path] = max(count.get(path, 0), i + 1)
    for kind, p, path, i in _blocks(cfg, params):
        h, _, c = _block_fwd(cfg, kind, p, h, positions, tab, model,
                             want_cache=True, slots=ring, enc=enc)
        node = cache
        for k in path:
            node = node.setdefault(k, {})
        for name, t in c.items():
            if name not in node:
                node[name] = t.new_empty((count[path],) + t.shape,
                                         dtype=t.dtype if name in (
                                             "state", "conv") else dt)
            node[name][i] = t
        if ring and kind in ("layer", "attn") and "pos" not in node:
            pos = fold_ring(positions.to(torch.int32), ring, -1)
            node["pos"] = pos[None].expand((count[path],) + pos.shape)
    return layers.apply_norm(cfg, params["final_norm"], h), cache


def fold_ring(t, slots: int, empty=0):
    """t (B, S, ...) over positions 0 .. S-1 folded into a ring of
    ``slots``: the newest min(slots, S) positions p at slot p % slots, the
    other slots ``empty`` (``install_ring``'s layout; with slots
    min(window, S) the reference's prefill ring).  Returns
    (B, slots, ...)."""
    S = t.shape[1]
    keep = min(slots, S)
    idx = torch.arange(S - keep, S, device=t.device) % slots
    out = t.new_full((t.shape[0], slots) + tuple(t.shape[2:]), empty)
    out[:, idx] = t[:, S - keep:]
    return out


def _prefill_shard(cfg: ModelConfig, params, tokens, model, max_len: int,
                   patches=None, frames=None):
    """Rank ``model.rank``'s prefill of tokens (B, S) (and the vision
    decoder's ``patches`` (B, P, D) before them: S' = P + S positions;
    the encoder-decoder's ``frames``) over the model group in the ``tp``
    regime: ``_prefill_trunk``, then its ``lm_head`` columns of the last
    position.  Returns (the logits (B, 1, V) all-gathered over the group,
    as the reference's out sharding ``P(Bax, None, None)`` holds them; the
    cache in the decode layout, ``_to_decode_cache``: this rank's shard of
    ``max_len`` / tp positions, or of a window's Wd / tp ring slots, Wd =
    min(window, max_len), zeros past S'; the SSM's and RG-LRU's leaves as
    the trunk made them).  Collectives: the trunk's all-reduces, one
    all-gather, one all-to-all a K/V leaf (none in the ``seq`` mode, where
    every rank holds every kv head, and none for MLA, whose latent every
    rank holds); in a trivial group none, and the one-device prefill."""
    check_servable(cfg, model.size, "prefill")
    tp = model.size
    B = tokens.shape[0]
    S = tokens.shape[1] + (0 if patches is None else patches.shape[1])
    if max_len < S or max_len % tp:
        raise ValueError(f"prefill over {tp} ranks: max_len {max_len} must "
                         f"hold the {S} positions and split in {tp}")
    Wd = ring_slots(cfg, max_len, tp)
    h, cache = _prefill_trunk(cfg, params, tokens, model, patches, Wd,
                              frames)
    part = logits_fn(cfg, params, h[:, -1:, :])            # (B, 1, V/tp)
    logits = model.all_gather(part[None]).permute(1, 2, 0, 3) \
        .reshape(B, 1, tp * part.shape[-1])
    return logits, _to_decode_cache(cfg, cache, model, max_len)


def ring_slots(cfg: ModelConfig, max_len: int, tp: int = 1):
    """A window's decode ring slots Wd = min(window, max_len) (0 without a
    window; the hybrid's ``local_window``); raises ``ValueError`` when
    they do not split over ``tp`` ranks."""
    if not _window(cfg):
        return 0
    Wd = min(_window(cfg), max_len)
    if Wd % tp:
        raise ValueError(f"{cfg.name}: a ring of {Wd} slots does not split "
                         f"over {tp} ranks")
    return Wd


def _to_decode_cache(cfg: ModelConfig, cache, model, max_len: int):
    """A prefill trunk's cache in the decode layout of rank ``model.rank``
    (``distributed/sharding.py::cache_specs``), at every node of a nested
    cache: K/V to its sequence shard of every kv head
    (``_to_decode_layout``: one all-to-all a leaf; the encoder-decoder's
    cross K/V over the encoder's ``encoder_seq`` positions); a ring's K/V
    the same over its slots, its "pos" (the same on every rank) cut to
    its slots without a send; MLA's latent its ``seq_block``, with no
    exchange; the SSM's and RG-LRU's leaves, already its shard, as they
    are."""
    m, tp = model.rank, model.size
    if "pos" in cache:
        n = cache["pos"].shape[-1]
        Wl = n // tp
        return dict({k: _to_decode_layout(cfg, cache[k], model, n)
                     for k in ("k", "v")},
                    pos=cache["pos"][..., m * Wl:(m + 1) * Wl].contiguous())
    out = {}
    for k, t in cache.items():
        if isinstance(t, dict):
            out[k] = _to_decode_cache(cfg, t, model, max_len)
        elif k in ("ckv", "kr"):
            out[k] = seq_block(t, m, tp, max_len)
        elif k in ("k", "v"):
            out[k] = _to_decode_layout(cfg, t, model, max_len)
        elif k in ("xk", "xv"):
            out[k] = _to_decode_layout(cfg, t, model, cfg.encoder_seq)
        else:
            out[k] = t
    return out


def kv_owners(cfg: ModelConfig, tp: int):
    """(rank, local head) of each kv head after a ``tp``-regime prefill:
    a kv head's K/V is taken from the first rank whose q heads read it
    (``layers.kv_heads_of_rank`` when the kv heads are replicated:
    Qwen3-30B-A3B's 4 at tp 8 sit on ranks 0, 2, 4, 6)."""
    Hkv = cfg.num_kv_heads
    if Hkv % tp == 0:
        Hl = Hkv // tp
        return [(j // Hl, j % Hl) for j in range(Hkv)]
    out = {}
    for r in range(tp):
        lo, hi = layers.kv_heads_of_rank(cfg, r, tp)
        for j in range(lo, hi):
            out.setdefault(j, (r, j - lo))
    if sorted(out) != list(range(Hkv)):
        raise ValueError(f"{cfg.name}: at tp {tp} only kv heads "
                         f"{sorted(out)} of {Hkv} have an owner")
    return [out[j] for j in range(Hkv)]


def seq_blocks(t, tp: int, max_len: int):
    """A rank's K or V of every position and of its kv heads, (L, B, S,
    Hl, dh), as the ``tp`` sequence blocks of a ``max_len`` cache (zeros
    past S), (tp, L, B, max_len / tp, Hl, dh): what it sends to each rank
    in ``_to_decode_layout``'s all-to-all; a view of t when S is
    ``max_len``."""
    L, B, S, Hl, dh = t.shape
    S_l = max_len // tp
    if S == max_len:
        return t.reshape(L, B, tp, S_l, Hl, dh).permute(2, 0, 1, 3, 4, 5)
    out = t.new_zeros((tp, L, B, S_l, Hl, dh))
    for r in range(tp):
        lo, hi = r * S_l, min(S, (r + 1) * S_l)
        if hi > lo:
            out[r, :, :, :hi - lo] = t[:, :, lo:hi]
    return out


def heads_of_blocks(cfg: ModelConfig, recv, tp: int):
    """This rank's sequence block of every kv head from what each rank
    sent it, recv (tp, L, B, S_l, Hl, dh) in rank order: each kv head
    taken from its first owner (``kv_owners``).  Returns a contiguous
    (L, B, S_l, Hkv, dh)."""
    _, L, B, S_l, Hl, dh = recv.shape
    flat = recv.permute(1, 2, 3, 0, 4, 5).reshape(L, B, S_l, tp * Hl, dh)
    own = [r * Hl + i for r, i in kv_owners(cfg, tp)]
    if own == list(range(tp * Hl)):         # every kv head held once
        return flat.contiguous()
    return flat.index_select(3, torch.tensor(own, device=recv.device))


def _to_decode_layout(cfg: ModelConfig, t, model, max_len: int):
    """Heads to sequence: each rank's K or V of its kv heads over every
    position (L, B, S, Hl, dh) to its sequence shard of every kv head,
    (L, B, max_len / tp, Hkv, dh): one all-to-all over the model group of
    ``seq_blocks``, then ``heads_of_blocks``.  In the ``seq`` mode the
    rank holds every kv head already and keeps its block, with no
    exchange (``seq_block``)."""
    if seq_split(cfg, model.size):
        return seq_block(t, model.rank, model.size, max_len)
    recv = model.all_to_all(seq_blocks(t, model.size, max_len))
    return heads_of_blocks(cfg, recv, model.size)


def seq_block(t, m: int, tp: int, max_len: int):
    """Positions [m S_l, (m+1) S_l) of t (L, B, S, ...), (L, B, S, Hkv,
    dh) K/V or MLA's (L, B, S, r) latent, S_l = max_len / tp, zeros past
    S: rank ``m``'s block of ``seq_blocks``, a new contiguous tensor."""
    L, B, S = t.shape[:3]
    S_l = max_len // tp
    out = t.new_zeros((L, B, S_l) + tuple(t.shape[3:]))
    lo, hi = m * S_l, min(S, (m + 1) * S_l)
    if hi > lo:
        out[:, :, :hi - lo] = t[:, :, lo:hi]
    return out


def decode_step_logits(cfg: ModelConfig, params, cache, tokens, lengths,
                       comm=LOCAL):
    """One decode step: tokens (B,), lengths (B,) -> (raw next-token
    logits (B, V) fp32, cache).  Writes each row's new K/V (MLA: c_kv and
    k_rope) at ``lengths`` in place (dropped for rows at or past the cache
    length; a ring writes slot ``lengths % Wc``); an SSM and an RG-LRU
    advance every row's conv caches and state in place (a finished row's
    state advances too, and its tokens are discarded, as in the JAX
    scan).  The encoder-decoder adds sinusoid positions at ``lengths``
    and reads its cross-attention cache; Pixtral's ``lengths`` count its
    patches.  Every family runs ``_decode_shard_logits`` over ``comm``:
    on the multi-GPU path one rank's step in the decode regime, its
    logits its vocabulary shard (B, V / tp); in groups of one (``LOCAL``)
    the one-device step."""
    check_model(cfg)
    return _decode_shard_logits(cfg, params, cache, tokens, lengths,
                                comm.model)


def head_logits(cfg: ModelConfig, params, h):
    """Final norm + LM head on one position, h (B, 1, D) -> (B, V) fp32."""
    h = layers.apply_norm(cfg, params["final_norm"], h)
    return logits_fn(cfg, params, h)[:, 0, :]


def decode_step(cfg: ModelConfig, params, cache, tokens, lengths,
                comm=LOCAL):
    """One greedy decode step -> (next tokens (B,) int32, cache).  Over
    ``comm`` the argmax of the ranks' vocabulary shards
    (``argmax_shards``)."""
    logits, cache = decode_step_logits(cfg, params, cache, tokens, lengths,
                                       comm)
    if comm.model.trivial:
        return torch.argmax(logits, dim=-1).to(torch.int32), cache
    return argmax_shards(logits, comm.model), cache


def _attn_decode_shard(cfg, pa, xn, c, lengths, tab, model, window=None):
    """Rank ``model.rank``'s one-token attention over its shard ``c`` of a
    layer's cache in the decode regime, merged over the group, through
    ``wo``: q, k, v of every head from ``pa`` (the attention weights
    replicated; RoPE where ``tab`` is given); the new K/V written at
    ``lengths`` by the rank whose shard of S_l positions holds it
    (``cache_update`` drops the others' writes, and a finished row's at
    ``lengths`` = S on every rank: the reference's
    ``_cache_update_dus``); the rank's shard attention
    (``layers.decode_attention_shard``, RoPE at the global positions)
    merged over the group (``layers.merge_shards``: an all-reduce of the
    lse's max and one of the weighted sums).  MLA's latent shard runs
    ``layers.mla_decode_shard`` (merged after ``wv_b``) and a ring of
    slots ``layers.ring_decode_shard`` (the owner writes k, v and the
    position; ``window``) in place of the shard attention."""
    m, tp = model.rank, model.size
    if cfg.use_mla:
        o, lse = layers.mla_decode_shard(cfg, pa, xn, c["ckv"], c["kr"],
                                         lengths, m, rope_tab=tab)
    elif "pos" in c:
        o, lse = layers.ring_decode_shard(cfg, pa, xn, c["k"], c["v"],
                                          c["pos"], lengths, m, tp,
                                          window=window, rope_tab=tab)
    else:
        q, k, v = layers.attention_qkv(cfg, pa, xn, lengths[:, None],
                                       rope_tab=tab,
                                       use_rope=tab is not None)
        S_l = c["k"].shape[1]
        layers.cache_update(c["k"], k, lengths - m * S_l)
        layers.cache_update(c["v"], v, lengths - m * S_l)
        o, lse = layers.decode_attention_shard(q, c["k"], c["v"],
                                               lengths + 1, m, S_l,
                                               softcap=cfg.logit_softcap)
    return layers._merge_heads(layers.merge_shards(o, lse, model), pa["wo"])


def _cross_decode_shard(cfg, pa, xn, c, model):
    """Rank ``model.rank``'s one-token cross-attention over its sequence
    shard of the encoder's K/V (``xk``, ``xv`` (B, Se / tp, Hkv, dh), read
    only), every position of which counts, merged over the group
    (``layers.decode_attention_shard`` at the encoder's whole length, then
    ``layers.merge_shards``), through ``wo``."""
    q = layers._q_proj(cfg, pa, xn)
    S_l = c["xk"].shape[1]
    enc_len = torch.full((xn.shape[0],), S_l * model.size, dtype=torch.int32,
                         device=xn.device)
    o, lse = layers.decode_attention_shard(q, c["xk"], c["xv"], enc_len,
                                           model.rank, S_l)
    return layers._merge_heads(layers.merge_shards(o, lse, model), pa["wo"])


def _decode_block(cfg, kind, p, h, c, lengths, tab, model):
    """One step of ``_blocks`` decoding one token on rank ``model.rank``
    of the decode regime, h (B, 1, D), its cache views ``c`` written in
    place: the attention sublayers' merged shards (``_attn_decode_shard``;
    the hybrid's ring at ``local_window``; the encoder-decoder's causal
    self-attention, then its cross-attention, ``_cross_decode_shard``),
    whole on every rank; the SSM and the RG-LRU on the rank's channels
    (``ssm.ssm_decode`` with its gated norm over the group,
    ``rglru.rglru_decode``), their partial outputs all-reduced; the
    rank's experts or MLP columns (``ffn_share``, the MoE's aux dropped)
    all-reduced."""
    m, tp = model.rank, model.size
    xn = layers.apply_norm(cfg, p["ln1"], h)
    if kind == "ssm":
        y, _ = ssm.ssm_decode(cfg, p["ssm"], xn, c, group=model)
        return h + model.all_reduce(y)
    if kind == "rec":
        y, _ = rglru.rglru_decode(cfg, p["t"], xn, c)
        h = h + model.all_reduce(y)
    else:
        h = h + _attn_decode_shard(cfg, p["t" if kind == "attn" else "attn"],
                                   xn, c, lengths, tab, model, _window(cfg))
    if kind == "dec":
        h = h + _cross_decode_shard(
            cfg, p["xattn"], layers.apply_norm(cfg, p["ln2"], h), c, model)
    y, _ = ffn_share(cfg, p, h, m, tp, norm="ln3" if kind == "dec" else "ln2")
    return h + model.all_reduce(y)


def _decode_shard_logits(cfg: ModelConfig, params, cache, tokens, lengths,
                         model):
    """Rank ``model.rank``'s decode step in the decode regime (the port's
    ``serve_step`` body): ``params`` its slices under ``param_specs(...,
    "decode")``, ``cache`` its shard under ``distributed/sharding.py::
    cache_specs`` ({"k", "v"} of (L, B, S_l, Hkv, dh); MLA's {"ckv",
    "kr"} of (L, B, S_l, r); a ring's slots {"k", "v", "pos"}; the
    encoder-decoder's {"xk", "xv"} of its Se / tp encoder positions
    beside k and v; the SSM's and RG-LRU's leaves over its heads and
    channels; the hybrid's nested), tokens and lengths its rows.  The
    embedding over its vocabulary rows reduced (the hybrid's scale, the
    encoder-decoder's positions at ``lengths`` added after it), each step
    ``_decode_block``, the final norm and its ``lm_head`` columns.
    Returns (its logits' vocabulary shard (B, V / tp) fp32, cache updated
    in place).  Collectives: 1 + 3 L all-reduces for a decoder (a
    layer's lse max, merged sum and FFN), 1 + 2 L an SSM, 1 + 2 an RG-LRU
    and 3 a ring sublayer for the hybrid, 1 + 5 L the encoder-decoder; in
    a trivial group none (``merge_shards`` returns the one shard's
    output), and the one-device step."""
    check_servable(cfg, model.size, "decode")
    h = _gemma_scale(cfg, model.all_reduce(embed_share(
        cfg, params, tokens[:, None], model.rank, model.size)))
    if cfg.family == "audio":
        h = h + layers.sinusoid_pos(lengths[:, None], cfg.d_model, h.dtype)
    tab = None if cfg.family in ("ssm", "audio") else layers.rope_tables(
        lengths[:, None], layers.rope_dim(cfg), cfg.rope_theta)
    for kind, p, path, i in _blocks(cfg, params):
        node = cache
        for k in path:
            node = node[k]
        h = _decode_block(cfg, kind, p, h, {k: t[i] for k, t in
                                            node.items()}, lengths, tab,
                          model)
    return head_logits(cfg, params, h), cache


def argmax_shards(logits, model):
    """The greedy token of each row from the ranks' vocabulary shards of
    its logits, logits (B, V / tp) on rank m holding columns [m V/tp,
    (m+1) V/tp): each rank's (max logit, its global index) all-gathered
    (one all-gather of (tp, B, 2) fp32, not of the logits), then the
    greatest value, the lowest index on ties (the first rank, and within
    it ``torch.argmax``'s first), as ``torch.argmax`` and ``jnp.argmax``
    over the whole row pick.  Returns (B,) int32."""
    Vl = logits.shape[-1]
    idx = torch.argmax(logits, dim=-1)
    val = torch.gather(logits, -1, idx[:, None])[:, 0].float()
    # indices below 2^24 are exact in fp32
    pair = torch.stack([val, (idx + model.rank * Vl).float()], dim=-1)
    every = model.all_gather(pair[None])                   # (tp, B, 2)
    best = torch.argmax(every[..., 0], dim=0)
    return torch.gather(every[..., 1], 0, best[None])[0].to(torch.int32)


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
