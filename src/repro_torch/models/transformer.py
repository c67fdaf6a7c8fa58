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

Over a ``distributed/collectives.py::Comm`` the dense, MoE and vision
decoders (GQA or MLA attention, a sliding window among them) also train
(``forward_loss``, the ``tp`` regime) and serve (``prefill`` in the
``tp`` regime, its cache handed over in the decode layout;
``decode_step`` in the decode regime over a sequence-split cache, MLA's
latent cache split the same way, a window's ring split by slots) as one
rank of a mesh, their attention split over q heads or, where GQA heads
do not split, over q positions (the ``seq`` mode, ``_seq_share``); in
the ``fsdp`` regime (``comm.fsdp``) every family trains, each rank on
its shards gathered where they are read.  In groups of one each is the
one-device function, bit for bit: these families' prefill and decode
step run the multi-GPU bodies on one device too.

A windowed prefill returns the reference's ring, min(window, S) slots
(``fold_ring``; the hybrid's ``_to_ring``); ``install_ring`` re-lays it into ``init_cache``'s ring of
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
                    tp: int = 1, copy=_same, want_kv: bool = False):
    """The layer's attention sublayer on the residual stream h, or rank
    ``m`` of ``tp``'s partial output of it: RMSNorm, then attention over
    the rank's q-head shard (``layers.tp_attention_params``; MLA's q,
    k_nope and v of its heads from its shards of ``wq_b``, ``wk_b`` and
    ``wv_b``, the latent and its norms from the replicated ``MLA_WHOLE``)
    through ``wo``'s rows of those heads.  The ranks' outputs sum to
    the sublayer's (the caller's reduce).  ``copy`` wraps what every rank
    reads whole (the model group's ``copy_in``: its gradient sums over the
    ranks); at tp 1 it is the identity and this is the one-device
    sublayer.  With ``want_kv`` returns (output, (k, v)): the K/V of the
    kv heads the rank's q heads read (MLA: its latent cache leaves), what
    a prefill keeps, the same on every rank).  The kv leaves that do not
    split over ``tp`` (MLA's ``MLA_WHOLE``) are read whole, through the
    same ``copy`` as the normed input (one all-reduce of their
    gradients).  MLA whose q heads do not split raises: it has no ``seq``
    mode.  When the q heads do not split over
    ``tp`` (``seq_split``) the rank's share is ``_seq_share``'s."""
    attn = p["attn"]
    if cfg.use_mla:
        if cfg.num_heads % tp:
            raise NotImplementedError(f"{cfg.name}: MLA's {cfg.num_heads} "
                                      f"q heads do not split over {tp} ranks")
        whole = MLA_WHOLE
    elif seq_split(cfg, tp):
        out = _seq_share(cfg, p, h, positions, tab, m, tp, copy)
        return out if want_kv else out[0]
    else:
        whole = [] if cfg.num_kv_heads % tp == 0 else \
            sorted(k for k in ("wk", "wv", "bk", "bv") if k in attn)
    xn, *ws = _copied(copy, layers.apply_norm(cfg, p["ln1"], h),
                      *(attn[k] for k in whole))
    pa = dict(attn, **dict(zip(whole, ws)))
    if cfg.use_mla:
        out = layers.mla_fwd(cfg, pa, xn, positions, rope_tab=tab)
    else:
        out = layers.attention_fwd(
            cfg, layers.tp_attention_params(cfg, pa, m, tp), xn, positions,
            rope_tab=tab)
    return out if want_kv else out[0]


# MLA's leaves every rank of the ``tp`` regime reads whole (``_leaf_rule``):
# the low-rank down-projections and their norms
MLA_WHOLE = ("kv_norm", "q_norm", "wkv_a", "wq_a")


def _copied(copy, *ts):
    """``copy`` of the tensors ``ts``, as a tuple."""
    out = copy(*ts)
    return out if len(ts) > 1 else (out,)


def _seq_share(cfg: ModelConfig, p, h, positions, tab, m: int, tp: int,
               copy):
    """Rank ``m`` of ``tp``'s share of the attention sublayer in the
    ``seq`` mode (q positions over the model group, K/V replicated; the
    attention leaves replicated, ``_leaf_rule``): RMSNorm of the whole h;
    k and v of every position; q of the rank's rows ``seq_rows`` only,
    RoPE at their positions; ``flash_attention`` of those rows at their
    positions against every key (causal, the window and softcap as
    configured); ``wo`` on the rows, placed in a (B, S, D) tensor of
    zeros, which the caller reduces as the ``heads`` mode's partial.  The
    normed input and every attention leaf pass through one ``copy`` (one
    all-reduce of their gradients: each rank's rows give a part of every
    one).  Returns (output, (k, v)): every kv head's K/V at every
    position."""
    attn = p["attn"]
    names = sorted(attn)
    xn, *ws = _copied(copy, layers.apply_norm(cfg, p["ln1"], h),
                      *(attn[k] for k in names))
    pa = dict(zip(names, ws))
    k, v = layers.kv_from_states(cfg, pa, xn)
    k = layers.apply_rope(k, tab)
    S = h.shape[1]
    lo, hi = seq_rows(S, m, tp)
    if hi == lo:
        return torch.zeros_like(h), (k, v)
    q = layers.apply_rope(layers._q_proj(cfg, pa, xn[:, lo:hi]),
                          (tab[0][:, lo:hi], tab[1][:, lo:hi]))
    o = layers.chunked_attention(q, k, v, positions[:, lo:hi], positions,
                                 window=cfg.sliding_window,
                                 softcap=cfg.logit_softcap)
    y = layers._merge_heads(o, pa["wo"])
    return torch.nn.functional.pad(y, (0, 0, lo, S - hi)), (k, v)


def ffn_share(cfg: ModelConfig, p, h, m: int = 0, tp: int = 1, copy=_same,
              route=None):
    """The layer's second sublayer on h, or rank ``m`` of ``tp``'s partial
    of it, as ``attention_share``: RMSNorm, then the MoE over the rank's
    E/tp experts and shared-expert columns (``moe.moe_fwd``, the router
    whole; routed over the data group ``route`` as one batch where one is
    given) or the gated MLP over its columns.  Returns (partial output,
    partial aux): the MoE's load-balance aux (fp32 scalar), None for the
    MLP; each sums over the ranks to the layer's."""
    xn = copy(layers.apply_norm(cfg, p["ln2"], h))
    if cfg.is_moe:
        pm = dict(p["moe"], wg=copy(p["moe"]["wg"]))
        return moe.moe_fwd(cfg, pm, xn, m, tp, route)
    return layers.mlp_fwd(cfg, p["mlp"], xn), None


def ffn(cfg: ModelConfig, p, h):
    """The layer's second half on the residual stream h, added back to h
    (``ffn_share`` on one device).  Returns (h, aux)."""
    y, aux = ffn_share(cfg, p, h)
    return h + y, aux


def _to_ring(k, v, positions, window: int):
    """Full (B, S, Hkv, dh) K/V folded into the reference's prefill ring of
    Wc = min(window, S) slots (``fold_ring``): the last Wc positions, each
    at slot position % Wc, positions (B, Wc) int32 (-1: empty)."""
    Wc = min(window, k.shape[1])
    return {"k": fold_ring(k, Wc), "v": fold_ring(v, Wc),
            "pos": fold_ring(positions.to(torch.int32), Wc, -1)}


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


def _rg_sub_fwd(cfg, p, h, positions, tab, kind, want_cache=True):
    """One hybrid sublayer over the sequence: RMSNorm, RG-LRU or local
    attention (window ``cfg.local_window``, the softcap on its scores),
    RMSNorm, gelu MLP; returns (h, its prefill cache: the RG-LRU's state
    and conv, or the ring; None without ``want_cache``, as in training)."""
    xn = layers.apply_norm(cfg, p["ln1"], h)
    cache = None
    if kind == "rec":
        if want_cache:
            y, cache = rglru.rglru_fwd(cfg, p["t"], xn, return_state=True)
        else:
            y = rglru.rglru_fwd(cfg, p["t"], xn)
    else:
        y, (k, v) = layers.attention_fwd(cfg, p["t"], xn, positions,
                                         rope_tab=tab,
                                         window=cfg.local_window)
        if want_cache:
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
    """Token embeddings, after Pixtral's stub patch embeddings
    (``place_patches``); for the encoder-decoder plus sinusoid positions.
    Returns (h, positions)."""
    h, positions = place_patches(cfg, params, _embed_tokens(cfg, params,
                                                            tokens), patches)
    if cfg.family == "audio":
        h = h + layers.sinusoid_pos(positions, cfg.d_model, h.dtype)
    return h, positions


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


def _enc_layer_fwd(cfg, p, h, positions):
    """One encoder layer: non-causal self-attention without RoPE, the
    MLP."""
    xn = layers.apply_norm(cfg, p["ln1"], h)
    a, _ = layers.attention_fwd(cfg, p["attn"], xn, positions, causal=False,
                                use_rope=False)
    h = h + a
    return h + layers.mlp_fwd(cfg, p["mlp"], layers.apply_norm(cfg, p["ln2"],
                                                               h))


def _encode(cfg, params, frames):
    """The encoder over stub frame embeddings (B, Se, D): ``_enc_inputs``,
    its layers, then ``enc_norm``.  Returns (states (B, Se, D), positions
    (B, Se))."""
    h, positions = _enc_inputs(cfg, params, frames)
    for p in _per_layer(params, "enc_layers"):
        h = _enc_layer_fwd(cfg, p, h, positions)
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
    """tokens (B, S) -> (final-normed hidden (B, S', D), cache); the cache
    is ``init_cache``'s leaves at max_len S', an SSM's decode cache, or for
    a window the reference's prefill rings of min(window, S) slots
    (``install_rings`` takes them to a decode cache).  S' is S, or P + S
    with Pixtral's ``patches`` (B, P, D) placed first; the
    encoder-decoder needs ``frames`` (B, encoder_seq, D).  The dense, MoE
    and vision decoders (``_serves_split``: MLA and the window among them)
    run ``_prefill_trunk`` on one device."""
    check_model(cfg)
    _check_stubs(cfg, frames, patches)
    if _serves_split(cfg):
        return _prefill_trunk(cfg, params, tokens, LOCAL.model, patches)
    h, positions = _assemble_inputs(cfg, params, tokens, patches)
    B, S = positions.shape
    if cfg.family == "audio":
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
    h, cache = _hybrid_backbone(cfg, params, h, positions, tab)
    return layers.apply_norm(cfg, params["final_norm"], h), cache


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
    Pixtral vision decoder).  Over a model group of ``tp`` > 1 ranks:
    dense and MoE decoders (GQA or MLA attention) and the vision decoder,
    their q heads split over ``tp`` (``distributed/sharding.py::
    attention_mode`` "heads") or, where GQA heads do not split, their q
    positions (``seq_split``); the rest raises, naming what ROADMAP Queue
    A item 3 queues for it."""
    check_model(cfg)
    if tp <= 1:
        return
    why = None
    if cfg.family not in ("dense", "moe", "vlm"):
        why = "the SSM, RG-LRU and encoder-decoder TP rules at run time"
    else:
        why = _split_refusal(cfg, tp)
    if why:
        raise NotImplementedError(
            f"{cfg.name} at tp {tp}: waits for {why} (ROADMAP Queue A item "
            f"3, the multi-device path)")


def _split_refusal(cfg: ModelConfig, tp: int):
    """What of a dense, MoE or vision decoder does not split over ``tp``
    ranks (its vocabulary, experts or MLP columns, MLA's q heads), or
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
    return None


# what each family waits for in the serving cells (ROADMAP Queue A item 3)
_SERVE_QUEUED = {"ssm": "the SSM's rules", "hybrid": "the RG-LRU hybrid's "
                 "rules", "audio": "the encoder-decoder's rules"}


def check_servable(cfg: ModelConfig, tp: int, kind: str) -> None:
    """What the serving cells of ``launch/steps.py::build_cell`` take
    (``kind`` "prefill" or "decode") over a model group of ``tp`` ranks
    (``_serves_split``): the dense and MoE decoders with GQA attention
    and a full-length cache (Llama-3.2-1B, Qwen2-0.5B, SmolLM-360M,
    Qwen3-30B-A3B, Phi-3.5-MoE), with MLA's latent cache (DeepSeek-R1) or
    a sliding window's ring (H2O-Danube-1.8B), and the vision decoder
    (Pixtral-12B), whose vocabulary and experts or MLP columns split over
    ``tp``; a prefill runs the ``tp`` regime's q-head split, or its
    q-position split where GQA heads do not split (``seq_split``; the
    decode regime replicates the attention weights).  The rest raises,
    naming what ROADMAP Queue A item 3 queues for it."""
    check_model(cfg)
    if not _serves_split(cfg):
        why = _SERVE_QUEUED[cfg.family]
    else:
        why = _split_refusal(cfg, tp) if tp > 1 else None
    if why:
        raise NotImplementedError(
            f"{cfg.name} {kind} at tp {tp}: waits for {why} (ROADMAP Queue "
            f"A item 3, the multi-device path)")


def _chunk_ce(cfg, params, h, labels):
    """(sum of the valid rows' losses, their count) of one chunk: fp32
    logits, logsumexp minus the label's logit, labels < 0 left out."""
    logits = logits_fn(cfg, params, h)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.clamp_min(0).long()[..., None])
    valid = (labels >= 0).float()
    return ((lse - ll[..., 0]) * valid).sum(), valid.sum()


def ce_shard(cfg, params, h, labels, m: int = 0, tp: int = 1, copy=_same):
    """Rank ``m`` of ``tp``'s statistics of one chunk's cross-entropy over
    its vocabulary shard of ``lm_head`` (V/tp columns, h read through
    ``copy`` as ``attention_share`` reads it): each row's max logit
    (detached: a shift), the sum of the exponentials past it, and the
    label's logit where this shard owns the label (0 elsewhere).
    ``ce_merge`` combines the ranks'."""
    logits = logits_fn(cfg, params, copy(h))
    Vl = logits.shape[-1]
    mx = logits.detach().amax(-1)
    se = torch.exp(logits - mx[..., None]).sum(-1)
    t = labels.long() - m * Vl
    own = (t >= 0) & (t < Vl)
    ll = torch.gather(logits, -1, t.clamp(0, Vl - 1)[..., None])[..., 0]
    return mx, se, torch.where(own, ll, 0.0)


def ce_merge(mx, se, ll, labels, max_over, sum_over):
    """(sum of the valid rows' losses, their count) of one chunk from the
    ranks' ``ce_shard`` statistics, ``max_over`` and ``sum_over``
    reducing over the ranks (on the multi-GPU path the model group's
    all-reduce of the max and its ``reduce_out``): each rank's sum of
    exponentials rescaled to the global max, the log-sum-exp, minus the
    label's logit."""
    top = max_over(mx)
    lse = torch.log(sum_over(se * torch.exp(mx - top))) + top
    valid = (labels >= 0).float()
    return ((lse - sum_over(ll)) * valid).sum(), valid.sum()


def _chunk_ce_tp(cfg, params, h, labels, model):
    """``_chunk_ce`` over the model group ``model``, the vocabulary split
    across it: this rank's ``ce_shard`` merged by the group's
    collectives."""
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
    sum of the results is the batch's mean.  A model group of one keeps
    ``_chunk_ce``'s ``logsumexp``, whose bits ``ce_merge``'s rescaled sum
    would not give."""
    model = comm.model
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for s0 in range(0, h.shape[1], CE_CHUNK):
        args = (cfg, params, h[:, s0:s0 + CE_CHUNK],
                labels[:, s0:s0 + CE_CHUNK])
        if model.trivial:
            t, n = checkpoint(_chunk_ce, *args, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            t, n = checkpoint(_chunk_ce_tp, *args, model,
                              use_reentrant=False, preserve_rng_state=False)
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
    of ``comm`` (``attention_share``, ``ffn_share``) and the partial
    outputs (and aux) are all-reduced (``reduce_out``); in a group of one
    both are the one-device sublayers and nothing is sent.  In the
    ``fsdp`` regime an MoE routes the data group's rows as one batch, as
    the reference's ``_moe_local`` on the global batch does (one
    all-gather of the expert counts a layer, again in the recompute)."""
    p = take(stack, i)
    if cfg.family == "ssm":
        xn = layers.apply_norm(cfg, p["ln1"], h)
        return h + ssm.ssm_fwd(cfg, p["ssm"], xn), None
    model = comm.model
    share = dict(m=model.rank, tp=model.size, copy=model.copy_in)
    h = h + model.reduce_out(attention_share(cfg, p, h, positions, tab,
                                             **share))
    y, aux = ffn_share(cfg, p, h, **share,
                       route=None if comm.fsdp is None else comm.data)
    return h + model.reduce_out(y), (None if aux is None
                                     else model.reduce_out(aux))


def _train_enc_layer(cfg, stack, i, h, positions, tab, take=_index):
    """Encoder layer ``i`` of the encoder-decoder (``_enc_layer_fwd``), its
    leaves taken as ``_train_layer`` takes them.  Returns (h, None)."""
    return _enc_layer_fwd(cfg, take(stack, i), h, positions), None


def _train_dec_layer(cfg, stack, i, h, positions, tab, enc=None,
                     take=_index):
    """Decoder layer ``i`` of the encoder-decoder (``_dec_layer_fwd``,
    its K/V left unkept) on ``enc``, the encoder's (states, positions):
    every decoder layer reads the same states, so their gradient sums over
    the layers.  Returns (h, None)."""
    return _dec_layer_fwd(cfg, take(stack, i), h, positions, *enc)[0], None


def _train_unit(cfg, stack, i, h, positions, tab, take=_index):
    """Unit ``i`` of the hybrid's trunk: its sublayers ``b0`` .. over
    ``cfg.block_pattern`` (``_rg_sub_fwd`` without a cache), the leaves
    taken from the stacked ones as ``_train_layer`` takes them.
    Returns (h, None): the hybrid has no aux."""
    p = take(stack, i)
    for j, kind in enumerate(cfg.block_pattern):
        h, _ = _rg_sub_fwd(cfg, p[f"b{j}"], h, positions, tab, kind,
                           want_cache=False)
    return h, None


def _train_tail(cfg, stack, i, h, positions, tab, take=_index):
    """Tail layer ``i`` of the hybrid (an RG-LRU sublayer), as
    ``_train_unit``."""
    return _rg_sub_fwd(cfg, take(stack, i), h, positions, tab, "rec",
                       want_cache=False)[0], None


def _train_steps(cfg, params, enc=None, comm=LOCAL):
    """(step function, its stacked leaves, index) of each step of the
    training trunk: the layers, the hybrid's units and then its tail
    layers, or the encoder-decoder's decoder layers on ``enc`` (the
    reference's ``_stack_fwd`` scans); the layers take ``comm``, and each
    step its leaves through ``_taker(comm, stack)``."""
    part = functools.partial
    if cfg.family == "audio":
        fn = part(_train_dec_layer, enc=enc, take=_taker(comm, "layers"))
        return [(fn, params["layers"], i) for i in range(cfg.num_layers)]
    if cfg.family != "hybrid":
        fn = part(_train_layer, comm=comm, take=_taker(comm, "layers"))
        return [(fn, params["layers"], i) for i in range(cfg.num_layers)]
    n_units, n_tail = _hybrid_counts(cfg)
    unit = part(_train_unit, take=_taker(comm, "units"))
    tail = part(_train_tail, take=_taker(comm, "tail"))
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
        # the vocabulary split over the group, the patches placed after
        # its reduce; the hybrid's scaled embedding and the
        # encoder-decoder's positions ``check_trainable`` keeps off this
        # path.  ``adapter``'s gradient is then the whole one on every
        # rank (the residual stream's gradient is), as a norm's is
        h, positions = place_patches(cfg, params, model.reduce_out(
            embed_share(cfg, params, batch["tokens"], model.rank,
                        model.size)), patches)
    else:
        h, positions = _assemble_inputs(cfg, params, batch["tokens"],
                                        patches)
    tab = None if cfg.family in ("ssm", "audio") else layers.rope_tables(
        positions, layers.rope_dim(cfg), cfg.rope_theta)
    enc = None
    if cfg.family == "audio":
        eh, enc_pos = _enc_inputs(cfg, params, frames)
        fn = functools.partial(_train_enc_layer,
                               take=_taker(comm, "enc_layers"))
        eh, _ = _run_steps([(fn, params["enc_layers"], i)
                            for i in range(cfg.encoder_layers)],
                           cfg, eh, enc_pos, None, remat)
        enc = (layers.apply_norm(cfg, params["enc_norm"], eh), enc_pos)
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
    layout); without it a ring is the reference's of min(window, S).

    The dense, MoE and vision decoders (``_serves_split``) run
    ``_prefill_shard`` over ``comm``: on the multi-GPU path one rank's
    prefill in the ``tp`` regime, the logits all-gathered and the cache
    this rank's shard in the decode layout; in groups of one (``LOCAL``)
    every collective is skipped and it is the one-device prefill.  Over a
    model group of more than one rank, or one whose collectives are sent,
    the other families raise (``check_servable``)."""
    if _serves_split(cfg) or not comm.model.trivial:
        _check_stubs(cfg, frames, patches)
        n = tokens.shape[1] + (0 if patches is None else patches.shape[1])
        return _prefill_shard(cfg, params, tokens, comm.model, max_len or n,
                              patches)
    h, cache = _backbone(cfg, params, tokens, frames=frames, patches=patches)
    logits = logits_fn(cfg, params, h[:, -1:, :])
    if max_len is not None and max_len != h.shape[1]:
        cache = install_cache(cfg, init_cache(cfg, tokens.shape[0], max_len,
                                              tokens.device), cache)
    return logits, cache


def _serves_split(cfg: ModelConfig) -> bool:
    """The dense, MoE and vision decoders, what the serving cells take
    (GQA with a full-length cache, MLA's latent cache, a sliding window's
    ring): their prefill and decode step run the multi-GPU bodies
    (``_prefill_shard``, ``_decode_shard_logits``) over every ``comm``,
    ``LOCAL`` included."""
    return cfg.family in ("dense", "moe", "vlm")


def _prefill_trunk(cfg: ModelConfig, params, tokens, model, patches=None,
                   slots=None):
    """Rank ``model.rank``'s trunk of a prefill of tokens (B, S) over the
    model group in the ``tp`` regime (``params`` its slices under
    ``param_specs(..., "tp")``; in a group of one the whole tree): the
    embedding over its vocabulary rows reduced, the vision decoder's
    ``patches`` placed after the reduce (``place_patches``: S' = P + S
    positions), each layer's ``attention_share`` (its q heads through
    ``flash_attention``) and ``ffn_share`` (its experts or MLP columns),
    each reduced over the group (the MoE's aux dropped: serving has no
    loss), then the final norm.  Returns (h (B, S', D), cache): {"k", "v"}
    of the kv heads its q heads read, (L, B, S', Hl, dh) each (in the
    ``seq`` mode, ``seq_split``, its q rows' attention and every kv head);
    MLA's {"ckv", "kr"} of every position, (L, B, S', r) and (L, B, S',
    dr), the same on every rank; a window's ring of ``slots`` (default
    min(window, S')) {"k", "v"} of its kv heads, (L, B, slots, Hl, dh),
    and "pos" (B, slots), each layer's K/V folded in as it is made
    (``fold_ring``).  Collectives: 1 + 2 L all-reduces."""
    m, tp = model.rank, model.size
    h, positions = place_patches(cfg, params, model.all_reduce(embed_share(
        cfg, params, tokens, m, tp)), patches)
    S = positions.shape[1]
    tab = layers.rope_tables(positions, layers.rope_dim(cfg), cfg.rope_theta)
    dt = compat.torch_dtype(cfg.dtype)
    ring = slots or min(cfg.sliding_window, S) if cfg.sliding_window else 0
    kept = None
    for i, p in enumerate(_per_layer(params)):
        a, kv = attention_share(cfg, p, h, positions, tab, m, tp,
                                want_kv=True)
        if ring:
            kv = [fold_ring(t, ring) for t in kv]
        if kept is None:
            kept = [t.new_empty((cfg.num_layers,) + t.shape, dtype=dt)
                    for t in kv]
        for buf, t in zip(kept, kv):
            buf[i] = t
        h = h + model.all_reduce(a)
        h = h + model.all_reduce(ffn_share(cfg, p, h, m, tp)[0])
    h = layers.apply_norm(cfg, params["final_norm"], h)
    if cfg.use_mla:
        return h, {"ckv": kept[0], "kr": kept[1]}
    cache = {"k": kept[0], "v": kept[1]}
    if ring:
        cache["pos"] = fold_ring(positions.to(torch.int32), ring, -1)
    return h, cache


def fold_ring(t, slots: int, empty=0):
    """t (B, S, ...) over positions 0 .. S-1 folded into a ring of
    ``slots``: the newest min(slots, S) positions p at slot p % slots, the
    other slots ``empty`` (``install_ring``'s layout; with slots
    min(window, S) the reference's prefill ring, ``_to_ring``).  Returns
    (B, slots, ...)."""
    S = t.shape[1]
    keep = min(slots, S)
    idx = torch.arange(S - keep, S, device=t.device) % slots
    out = t.new_full((t.shape[0], slots) + tuple(t.shape[2:]), empty)
    out[:, idx] = t[:, S - keep:]
    return out


def _prefill_shard(cfg: ModelConfig, params, tokens, model, max_len: int,
                   patches=None):
    """Rank ``model.rank``'s prefill of tokens (B, S) (and the vision
    decoder's ``patches`` (B, P, D) before them: S' = P + S positions)
    over the model group in the ``tp`` regime: ``_prefill_trunk``, then
    its ``lm_head`` columns of the last position.  Returns (the logits (B,
    1, V) all-gathered over the group, as the reference's out sharding
    ``P(Bax, None, None)`` holds them; the cache in the decode layout,
    ``_to_decode_cache``: this rank's shard of ``max_len`` / tp positions,
    or of a window's Wd / tp ring slots, Wd = min(window, max_len), zeros
    past S').  Collectives: 1 + 2 L all-reduces, one all-gather, one
    all-to-all a K/V leaf (none in the ``seq`` mode, where every rank
    holds every kv head, and none for MLA, whose latent every rank holds);
    in a trivial group none, and the one-device prefill."""
    check_servable(cfg, model.size, "prefill")
    tp = model.size
    B = tokens.shape[0]
    S = tokens.shape[1] + (0 if patches is None else patches.shape[1])
    if max_len < S or max_len % tp:
        raise ValueError(f"prefill over {tp} ranks: max_len {max_len} must "
                         f"hold the {S} positions and split in {tp}")
    Wd = ring_slots(cfg, max_len, tp)
    h, cache = _prefill_trunk(cfg, params, tokens, model, patches, Wd)
    part = logits_fn(cfg, params, h[:, -1:, :])            # (B, 1, V/tp)
    logits = model.all_gather(part[None]).permute(1, 2, 0, 3) \
        .reshape(B, 1, tp * part.shape[-1])
    return logits, _to_decode_cache(cfg, cache, model, max_len)


def ring_slots(cfg: ModelConfig, max_len: int, tp: int = 1):
    """A window's decode ring slots Wd = min(window, max_len) (0 without a
    window); raises ``ValueError`` when they do not split over ``tp``
    ranks."""
    if not cfg.sliding_window:
        return 0
    Wd = min(cfg.sliding_window, max_len)
    if Wd % tp:
        raise ValueError(f"{cfg.name}: a ring of {Wd} slots does not split "
                         f"over {tp} ranks")
    return Wd


def _to_decode_cache(cfg: ModelConfig, cache, model, max_len: int):
    """A prefill trunk's cache in the decode layout of rank ``model.rank``
    (``distributed/sharding.py::cache_specs``): K/V to its sequence shard
    of every kv head (``_to_decode_layout``: one all-to-all a leaf); a
    ring's K/V the same over its slots, its "pos" (the same on every rank)
    cut to its slots without a send, one copy a layer; MLA's latent its
    ``seq_block``, with no exchange."""
    m, tp = model.rank, model.size
    if cfg.use_mla:
        return {k: seq_block(t, m, tp, max_len) for k, t in cache.items()}
    n = cache["pos"].shape[-1] if "pos" in cache else max_len
    out = {k: _to_decode_layout(cfg, cache[k], model, n) for k in ("k", "v")}
    if "pos" in cache:
        Wl = n // tp
        out["pos"] = cache["pos"][None, :, m * Wl:(m + 1) * Wl].expand(
            (cfg.num_layers,) + cache["pos"].shape[:1] + (Wl,)).contiguous()
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
    patches.  The dense, MoE and vision decoders (``_serves_split``: MLA
    and the window among them) run ``_decode_shard_logits`` over
    ``comm``: on the multi-GPU path one rank's step in the decode regime,
    its logits its vocabulary shard (B, V / tp); in groups of one
    (``LOCAL``) the one-device step.  Over a model group of more than one
    rank, or one whose collectives are sent, the other families raise
    (``check_servable``)."""
    check_model(cfg)
    if _serves_split(cfg) or not comm.model.trivial:
        return _decode_shard_logits(cfg, params, cache, tokens, lengths,
                                    comm.model)
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
    tab = layers.rope_tables(lengths[:, None], layers.rope_dim(cfg),
                             cfg.rope_theta)
    for u, p in enumerate(_per_layer(params, "units")):
        for i, kind in enumerate(cfg.block_pattern):
            c = {k: t[u] for k, t in cache["units"][f"b{i}"].items()}
            h = _rg_sub_decode(cfg, p[f"b{i}"], h, c, lengths, tab, kind)
    if "tail" in cache:
        for j, p in enumerate(_per_layer(params, "tail")):
            c = {k: t[j] for k, t in cache["tail"].items()}
            h = _rg_sub_decode(cfg, p, h, c, lengths, tab, "rec")
    return head_logits(cfg, params, h), cache


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


def _decode_layer_shard(cfg, p, h, c, lengths, tab, model):
    """One layer's decode step on rank ``model.rank`` of the decode
    regime, h (B, 1, D): RMSNorm and q, k, v of every head (the attention
    weights replicated); the new K/V written at ``lengths`` by the rank
    whose shard of S_l positions holds it (``cache_update`` drops the
    others' writes, and a finished row's at ``lengths`` = S on every
    rank: the reference's ``_cache_update_dus``); the rank's shard
    attention (``layers.decode_attention_shard``, RoPE at the global
    positions) merged over the group (``layers.merge_shards``: an
    all-reduce of the lse's max and one of the weighted sums); ``wo``;
    the rank's experts or MLP columns (``ffn_share``, the MoE's aux
    dropped) all-reduced.  MLA's latent shard runs
    ``layers.mla_decode_shard`` (merged after ``wv_b``) and a window's
    ring of slots ``layers.ring_decode_shard`` (the owner writes k, v and
    the position) in place of the shard attention."""
    m, tp = model.rank, model.size
    xn = layers.apply_norm(cfg, p["ln1"], h)
    if cfg.use_mla:
        o, lse = layers.mla_decode_shard(cfg, p["attn"], xn, c["ckv"],
                                         c["kr"], lengths, m, rope_tab=tab)
    elif "pos" in c:
        o, lse = layers.ring_decode_shard(cfg, p["attn"], xn, c["k"],
                                          c["v"], c["pos"], lengths, m, tp,
                                          rope_tab=tab)
    else:
        q, k, v = layers.attention_qkv(cfg, p["attn"], xn, lengths[:, None],
                                       rope_tab=tab)
        S_l = c["k"].shape[1]
        layers.cache_update(c["k"], k, lengths - m * S_l)
        layers.cache_update(c["v"], v, lengths - m * S_l)
        o, lse = layers.decode_attention_shard(q, c["k"], c["v"],
                                               lengths + 1, m, S_l,
                                               softcap=cfg.logit_softcap)
    o = layers.merge_shards(o, lse, model)
    h = h + layers._merge_heads(o, p["attn"]["wo"])
    return h + model.all_reduce(ffn_share(cfg, p, h, m, tp)[0])


def _decode_shard_logits(cfg: ModelConfig, params, cache, tokens, lengths,
                         model):
    """Rank ``model.rank``'s decode step in the decode regime (the port's
    ``serve_step`` body): ``params`` its slices under ``param_specs(...,
    "decode")``, ``cache`` its sequence shard {"k", "v"} of (L, B, S_l,
    Hkv, dh) (``distributed/sharding.py::cache_specs``; MLA's {"ckv",
    "kr"} of (L, B, S_l, r); a ring's slots {"k", "v", "pos"}), tokens and
    lengths its rows.  The embedding over its vocabulary rows reduced, each
    layer ``_decode_layer_shard``, the final norm and its ``lm_head``
    columns.  Returns (its logits' vocabulary shard (B, V / tp) fp32,
    cache updated in place).  Collectives: 1 + 3 L all-reduces; in a
    trivial group none (``merge_shards`` returns the one shard's output),
    and the one-device step."""
    check_servable(cfg, model.size, "decode")
    h = model.all_reduce(embed_share(cfg, params, tokens[:, None],
                                     model.rank, model.size))
    tab = layers.rope_tables(lengths[:, None], layers.rope_dim(cfg),
                             cfg.rope_theta)
    for i, p in enumerate(_per_layer(params)):
        h = _decode_layer_shard(cfg, p, h, {k: t[i] for k, t in
                                            cache.items()}, lengths, tab,
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
