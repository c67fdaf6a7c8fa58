"""Sharding regimes of the port: the reference's name-based partition
rules over ``models/transformer.py::param_shapes``, and the bridge that
cuts a full parameter tree into one rank's local slices.

Three regimes, as in ``repro.distributed.sharding``:

* ``tp`` (train / prefill): batch over the DP axes; attention q heads,
  FFN columns, experts, SSM / LRU channels over ``model``.  Archs whose
  head count does not divide the model axis (qwen2 14, smollm 15,
  whisper 8, recurrentgemma 10) fall back to sequence-parallel attention
  (``attention_mode`` "seq").
* ``decode`` (serve): batch over the DP axes; KV-cache sequence over
  ``model``; experts over ``model``; attention projections replicated
  (``launch/steps.py``'s decode cell; ``shard_cache`` / ``gather_cache``
  cut and join a cache under ``cache_specs``).
* ``fsdp`` (ZeRO-3): every weight sharded over all axes on its largest
  divisible dim.

A spec is a plain tuple with one entry a dim: an axis name, a tuple of
axis names, or None (replicated).  Divisibility is checked against the
axis size and falls back to replication.  The reference's ``make_hint``
has no counterpart: tensor parallelism is explicit here, and its choice
of ``heads`` or ``seq`` is ``attention_mode``'s.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models import transformer as T
from repro_torch.models.api import MeshAxes, ModelConfig


def _div(n, tp):
    return tp > 0 and n % tp == 0


def axis_entry(names):
    """A spec entry over ``names``: None for none, the name for one (as
    ``PartitionSpec`` normalizes it), else the tuple."""
    names = tuple(names or ())
    if not names:
        return None
    return names[0] if len(names) == 1 else names


def _map(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_specs(cfg: ModelConfig, axes: MeshAxes, tp: int, regime: str,
                n_dev: int = 0):
    """Spec tree matching ``param_shapes(cfg)``; regimes 'tp', 'decode',
    'fsdp' (``n_dev``: the device count it shards over)."""
    M = axes.model
    all_ax = axis_entry(axes.batch + ((M,) if M else ()))

    def rule(names, spec):
        stacked = names[0] in T.STACKS
        shape = spec[0][1:] if stacked else spec[0]
        if regime == "fsdp":
            sp = _fsdp_rule(shape, n_dev, all_ax, tp, M)
        else:
            sp = _leaf_rule(cfg, names, shape, tp, M, regime)
        return (None,) + sp if stacked else sp

    return _map(T.param_shapes(cfg), rule)


def _fsdp_rule(shape, n_dev, all_ax, tp, M):
    """Shard the largest dim divisible by the full device count; fall back
    to a partial shard over the last mesh axis; else replicate."""
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if n_dev and shape[i] % n_dev == 0:
            return tuple(all_ax if j == i else None
                         for j in range(len(shape)))
    last = (all_ax if isinstance(all_ax, str) else all_ax[-1]) \
        if all_ax else M
    for i in order:
        if shape[i] % tp == 0:
            return tuple(last if j == i else None for j in range(len(shape)))
    return (None,) * len(shape)


def _leaf_rule(cfg, names, shape, tp, M, regime):
    last = names[-1]
    in_moe = "moe" in names and "shared" not in names
    is_attn = any(n in ("attn", "xattn") for n in names) or (
        "t" in names and last in ("wq", "wk", "wv", "wo", "bq", "bk", "bv"))
    attn_repl = regime == "decode"
    R2, R3 = (None, None), (None, None, None)

    if last == "embed":
        return (M, None) if _div(T.padded_vocab(cfg), tp) else R2
    if last == "lm_head":
        return (None, M) if _div(T.padded_vocab(cfg), tp) else R2
    if last == "adapter":
        return R2

    # attention
    if is_attn or last in ("wq_a", "wq_b", "wkv_a", "wk_b", "wv_b",
                           "q_norm", "kv_norm"):
        if attn_repl:
            return (None,) * len(shape)
        if last == "wq":
            return (None, M, None) if _div(cfg.num_heads, tp) else R3
        if last in ("wk", "wv"):
            return (None, M, None) if _div(cfg.num_kv_heads, tp) else R3
        if last == "wo":
            return (M, None, None) if _div(cfg.num_heads, tp) else R3
        if last == "bq":
            return (M, None) if _div(cfg.num_heads, tp) else R2
        if last in ("bk", "bv"):
            return (M, None) if _div(cfg.num_kv_heads, tp) else R2
        if last in ("wq_b", "wk_b", "wv_b"):
            return (None, M, None) if _div(cfg.num_heads, tp) else R3
        if last in ("wq_a", "wkv_a"):
            return R2
        if last in ("q_norm", "kv_norm"):
            return (None,)

    # MoE experts
    if in_moe:
        if last == "wg":
            return R2
        if last in ("w1", "w2", "w3") and len(shape) == 3:
            return (M, None, None) if _div(cfg.num_experts, tp) else R3
        # a shared expert falls through to the dense rules

    # dense MLP
    if last in ("w1", "w3"):
        return (None, M) if _div(shape[-1], tp) else R2
    if last == "w2":
        return (M, None) if _div(shape[0], tp) else R2

    # SSM (mamba2)
    if last in ("wz", "wx", "conv_x"):
        width = cfg.d_inner if cfg.family == "ssm" else cfg.lru_width
        return (None, M) if _div(width, tp) else R2
    if last in ("wB", "wC", "conv_B", "conv_C"):
        return R2
    if last == "wdt":
        return (None, M) if _div(cfg.ssm_heads, tp) else R2
    if last in ("dt_bias", "A_log", "D_skip"):
        return (M,) if _div(cfg.ssm_heads, tp) else (None,)
    if last == "norm_w":
        return (M,) if _div(cfg.d_inner, tp) else (None,)
    if last == "wout":
        return (M, None) if _div(shape[0], tp) else R2

    # RG-LRU
    if last == "wgate":
        return (None, M) if _div(cfg.lru_width, tp) else R2
    if last == "conv":
        return (None, M) if _div(cfg.lru_width, tp) else R2
    if last in ("Wa", "Wi"):
        return (M, None, None) if _div(shape[0], tp) else R3
    if last in ("ba", "bi"):
        return (M, None) if _div(shape[0], tp) else R2
    if last == "lam":
        return (M,) if _div(cfg.lru_width, tp) else (None,)

    # norms, biases and everything else: replicated
    return (None,) * len(shape)


def cache_specs(cfg: ModelConfig, axes: MeshAxes, tp: int, batch: int,
                mesh_batch: int):
    """Spec tree matching ``init_cache(cfg, batch, ...)``'s leaves:
    sequence dims over ``model`` (flash-decoding), batch over the DP axes
    when divisible."""
    M = axes.model
    Bax = axis_entry(axes.batch) if batch % max(mesh_batch, 1) == 0 \
        else None
    shapes = T.init_cache(cfg, batch, 1024, device="meta")

    def rule(names, leaf):
        last, nd = names[-1], leaf.dim()
        if last in ("k", "v", "xk", "xv"):         # (L, B, S, Hkv, dh)
            return (None, Bax, M, None, None)
        if last in ("ckv", "kr"):                  # (L, B, S, R)
            return (None, Bax, M, None)
        if last == "pos":                          # (L, B, Wc)
            return (None, Bax, M)
        if last == "state" and nd == 5:            # ssm (L, B, H, N, P)
            return (None, Bax, M if _div(cfg.ssm_heads, tp) else None,
                    None, None)
        if last == "state":                        # rg (L, B, W)
            return (None, Bax, M if _div(cfg.lru_width, tp) else None)
        if last == "conv_x":                       # (L, B, K-1, W)
            return (None, Bax, None, M if _div(cfg.d_inner, tp) else None)
        if last in ("conv_B", "conv_C"):
            return (None, Bax, None, None)
        if last == "conv":                         # rg (L, B, K-1, W)
            return (None, Bax, None, M if _div(cfg.lru_width, tp) else None)
        return (None,) * nd

    return _map(shapes, rule)


def batch_specs(cfg: ModelConfig, axes: MeshAxes, batch: int,
                mesh_batch: int, kind: str) -> Dict[str, Any]:
    Bax = axis_entry(axes.batch) if batch % max(mesh_batch, 1) == 0 \
        else None
    sp: Dict[str, Any] = {"tokens": (Bax, None)}
    if kind == "train":
        sp["labels"] = (Bax, None)
    if cfg.family == "vlm" and kind in ("train", "prefill"):
        sp["patches"] = (Bax, None, None)
    if cfg.family == "audio" and kind in ("train", "prefill"):
        sp["frames"] = (Bax, None, None)
    if kind == "decode":
        sp = {"tokens": (Bax,), "lengths": (Bax,)}
    return sp


def attention_mode(cfg: ModelConfig, tp: int) -> str:
    """'heads' TP when the q heads divide ``tp``, else sequence-parallel
    'seq'."""
    if cfg.num_heads and cfg.num_heads % max(tp, 1) == 0:
        return "heads"
    return "seq"


def explain(cfg: ModelConfig, tp: int) -> str:
    mode = attention_mode(cfg, tp)
    notes = [f"attention={mode}"]
    if cfg.is_moe:
        notes.append(f"EP {cfg.num_experts}/{tp} experts per shard")
    if cfg.family in ("ssm", "hybrid"):
        notes.append("channel TP")
    return ", ".join(notes)


# ---------------------------------------------------------------------------
# the weight bridge's multi-rank leg (parameters and decode caches)
# ---------------------------------------------------------------------------


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def dim_slices(spec, shape, sizes: Dict[str, int],
               coords: Dict[str, int]) -> Tuple[slice, ...]:
    """This rank's slice of each dim of a leaf of ``shape`` under
    ``spec``: a dim over axes (a, b) splits in prod(sizes) blocks, taken
    in row-major order of the axes' coordinates."""
    out = []
    for n, entry in zip(shape, spec):
        idx, parts = 0, 1
        for a in _axes_of(entry):
            idx, parts = idx * sizes[a] + coords[a], parts * sizes[a]
        if n % parts:
            raise ValueError(f"dim {n} does not split in {parts}")
        b = n // parts
        out.append(slice(idx * b, (idx + 1) * b))
    return tuple(out)


def part_of(specs, mesh):
    """``(path, shape) -> dim_slices``: this rank's slices of the leaf at
    ``path`` under ``specs`` on ``mesh`` (``init_params``'s ``part``)."""
    sizes, coords = mesh.shape, mesh.coords
    return lambda path, shape: dim_slices(_get(specs, path), shape, sizes,
                                          coords)


def shard_params(params, specs, mesh):
    """Each leaf of a full tree (``init_params`` or ``params_from_numpy``)
    cut to this rank's local slice under ``specs`` on the realized
    ``mesh`` (contiguous copies)."""
    part = part_of(specs, mesh)
    return _map(params, lambda path, t: t[part(path, t.shape)].contiguous())


def gather_params(local, specs, mesh):
    """Inverse of ``shard_params``: every rank's local slices gathered
    into the full tree (on every rank), through the world group."""
    sizes = mesh.shape
    world = mesh.comm.world
    names = mesh.axis_names

    def coords_of(r):
        out = {}
        for name, n in reversed(list(zip(names, mesh.sizes))):
            out[name] = r % n
            r //= n
        return out

    def join(path, t):
        sp = _get(specs, path)
        full_shape = tuple(n * _parts(e, sizes) for n, e in zip(t.shape, sp))
        parts = world.all_gather(t.contiguous().reshape(1, -1))
        out = torch.empty(full_shape, dtype=t.dtype, device=t.device)
        for r in range(world.size):
            sl = dim_slices(sp, full_shape, sizes, coords_of(r))
            out[sl] = parts[r].reshape(t.shape)
        return out

    return _map(local, join)


def shard_cache(cache, specs, mesh):
    """The cache's leg of the bridge: each leaf of a full decode cache
    (``init_cache``, or a one-device prefill's installed in one) cut to this
    rank's slice under ``cache_specs`` (rows over the batch axes, sequence
    or ring slots over ``model``, the SSM's and RG-LRU's states and
    convolutions over their channels; a nested cache, the hybrid's
    ``{"units": {"b<i>": ...}, "tail": ...}``, leaf by leaf), each its own
    contiguous tensor: the paged kernel's 16-byte checks and
    ``decode_attention``'s pool view need that."""
    return shard_params(cache, specs, mesh)


def gather_cache(local, specs, mesh):
    """Inverse of ``shard_cache``: every rank's cache slices gathered into
    the full cache (on every rank, nested as it is), through the world
    group."""
    return gather_params(local, specs, mesh)


def _parts(entry, sizes) -> int:
    n = 1
    for a in _axes_of(entry):
        n *= sizes[a]
    return n


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree
