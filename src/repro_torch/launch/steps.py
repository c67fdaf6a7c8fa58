"""The training step, on one device and over a mesh: the port's
counterpart of ``repro.launch.steps``.

``train_step`` takes the loss's gradients (``models/transformer.py::
forward_loss``) with respect to every parameter leaf, over ``microbatches``
slices of the batch on dim 0 (grads accumulated in fp32, summed and then
divided by the count, as the reference's scan does; the loss, an MoE
decoder's aux included, is averaged the same way), and applies one AdamW
step (``optim.apply_updates``).  With ``comm`` (a
``distributed/collectives.py::Comm``) it is one rank's step on the
multi-GPU path: its local parameter slices, its data shard of the batch,
tensor and expert parallelism over the model group inside
``forward_loss``, ZeRO-1 over every rank in ``apply_updates``; the loss
it returns is the data group's sum of the ranks' terms, the batch's.

``build_cell`` builds a (arch x shape) cell on a mesh (``launch/mesh.py``)
of each kind of the reference's ``build_cell``:

* ``train``: the microbatch count (``_auto_microbatches``), the
  parameter, batch and optimizer specs (``distributed/sharding.py``,
  regime ``tp``), and a ``Cell`` whose ``init_state`` draws this rank's
  slices of the weights, whose ``local_batch`` takes this rank's rows of
  a global batch (microbatch j's data shard, as the reference's
  ``_mb_split`` keeps the DP shard on dim 1), and whose ``step`` runs
  ``train_step`` over the realized mesh's groups.  Every family trains
  in it: the dense, MoE (MLA among them) and vision decoders, the SSM
  (its channels and heads over ``model``, the gated norm's mean square
  all-reduced), the RecurrentGemma hybrid (its RG-LRU channels and gate
  blocks, its local attention) and the Whisper encoder-decoder (its
  encoder, self- and cross-attention); attention whose q heads do not
  split over ``model`` runs in the ``seq`` mode
  (``transformer.attention_share``).
  ``train_regime="fsdp"`` (the reference's ZeRO-3, ``_build_train``): the
  whole mesh is the data-parallel world (``MeshAxes(batch=(*batch,
  "model"), model=None)``), the batch splits over every rank in one
  microbatch, ``param_specs(..., "fsdp")`` places each leaf's shards,
  and the step runs the one-device trunk of every family on the leaves
  gathered where they are read (``collectives.FsdpGather``), AdamW on
  each rank's shards.
* ``prefill`` (the reference's ``_build_prefill``): the ``tp`` regime's
  parameter specs and the decode cache's (``cache_specs``); a
  ``PrefillCell`` whose ``step(params, batch)`` runs ``transformer.
  prefill`` over the mesh on this rank's rows of a global batch
  (``batch_seq`` its (batch, prompt length)) and returns (the last
  position's logits (B_l, 1, V), gathered over the model group; this
  rank's cache in the decode layout, ``max_len`` positions split over
  ``model``: the reference's ``_prefill_cache_specs``).
* ``decode`` (``_build_decode``): the ``decode`` regime's specs (the
  attention weights replicated, experts and MLP columns over ``model``)
  and a ``DecodeCell`` whose ``init_state`` draws this rank's slices,
  ``init_cache`` makes its zero shard of the cache (rows over the batch
  axes, the sequence over ``model``: flash-decoding), and ``step(params,
  cache, tokens, lengths)`` on this rank's rows (``local_batch``)
  returns ``(next_tokens, cache, lengths + 1)`` as the reference's
  ``serve_step``, the cache updated in place.  A decode cell built on the
  same mesh, batch and ``max_len`` takes a prefill cell's cache as it is.

The serving kinds take every family (``transformer.check_servable``:
GQA, MLA's latent cache, a window's ring of min(window, ``max_len``)
slots over ``model`` (the hybrid's ``local_window``), the SSM's and the
RG-LRU's states and convolutions over their channels, the
encoder-decoder's self and cross caches over their sequences), a prefill
in the ``seq`` mode where GQA q heads do not split; the vision decoder's
prefill batch holds its ``patches`` beside seq - P tokens, the
encoder-decoder's its ``frames``.  A model whose vocabulary, MLP, SSM
channels or RG-LRU gate blocks, or ring, do not split raises, naming
what does not.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import compat, optim
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.collectives import LOCAL, ONE, Comm, FsdpGather
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as T
from repro_torch.models.api import (SHAPES, MeshAxes, ModelConfig,
                                    shape_applicable)


def loss_and_grads(cfg: ModelConfig, params, batch, *, remat: bool = True,
                   comm=LOCAL):
    """(loss, grads): ``forward_loss`` and its gradient at every leaf of
    ``params``, as a tree of the same keys in the leaves' dtypes.  The
    params themselves are not marked: the loss runs on detached aliases
    (the same storage) that require grad.  A leaf the loss does not reach
    raises ``ValueError`` naming it (the vision decoder's ``adapter`` in a
    batch without patches: the reference's gradient there is zeros, and
    AdamW's weight decay would still move the leaf)."""
    req = optim.tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = T.forward_loss(cfg, req, batch, remat=remat, comm=comm)
        leaves = optim.tree_leaves(req)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    missed = [name for name, g in zip(_paths(req), grads) if g is None]
    if missed:
        raise ValueError(f"{cfg.name}: the loss does not reach {missed} "
                         f"(a vision decoder's batch needs its patches)")
    it = iter(grads)
    return loss.detach(), _unflatten(req, it)


def _paths(tree, prefix=""):
    """The dotted path of each leaf, in ``optim.tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], f"{prefix}{k}.")]
    return [prefix[:-1]]


def _unflatten(tree, it):
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], it) for k in sorted(tree)}
    return next(it)


def train_step(cfg: ModelConfig, params, opt_state, batch,
               ocfg: optim.AdamWConfig, *, microbatches: int = 1,
               remat: bool = True, comm=LOCAL,
               specs=None) -> Dict[str, torch.Tensor]:
    """One training step: the loss and gradients of ``batch`` (``tokens``
    and ``labels``, (B, S) each, on the params' device; the
    encoder-decoder's ``frames`` and the vision decoder's ``patches``
    beside them, and its labels (B, P + S)), over ``microbatches`` equal
    slices of B (every key sliced on dim 0) when more than one, then
    AdamW.  Over ``comm`` the params are this rank's slices under
    ``specs``, ``batch`` its rows (``Cell.local_batch``) and the
    optimizer state ``optim.init_opt_state``'s parts over ``comm``; on
    one device (``LOCAL``) nothing is sent.
    ``params`` and ``opt_state`` are updated in place.  Returns
    ``{"loss", "grad_norm"}`` (fp32 scalars on the device)."""
    n_mb = microbatches
    if n_mb <= 1:
        loss, grads = loss_and_grads(cfg, params, batch, remat=remat,
                                     comm=comm)
    else:
        B = batch["tokens"].shape[0]
        if B % n_mb:
            raise ValueError(f"train_step: batch {B} does not split into "
                             f"{n_mb} microbatches")
        b = B // n_mb
        loss = None
        grads = None
        for j in range(n_mb):
            mb = {k: t[j * b:(j + 1) * b] for k, t in batch.items()}
            l, g = loss_and_grads(cfg, params, mb, remat=remat, comm=comm)
            if grads is None:       # 0 + g, exactly as the reference's
                grads = optim.tree_map(lambda x: x.float(), g)
                loss = l
            else:
                grads = optim.tree_map(lambda a, x: a.add_(x.float()),
                                       grads, g)
                loss = loss + l
            del g
        loss = loss / n_mb
        grads = optim.tree_map(lambda a: a.div_(n_mb), grads)
    loss = comm.data.all_reduce(loss)
    _, _, gnorm = optim.apply_updates(ocfg, params, grads, opt_state,
                                      comm.n_dev, comm=comm, specs=specs)
    return {"loss": loss, "grad_norm": gnorm}


# ---------------------------------------------------------------------------
# cells over a mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cell:
    """One train cell on a mesh.  ``batch`` and ``seq`` are the global
    batch's; ``mesh`` may be abstract (specs, shapes, the dry run) or
    realized (``init_state``, ``step``)."""
    arch: str
    shape: str
    cfg: ModelConfig
    mesh: mesh_lib.Mesh
    batch: int
    seq: int
    microbatches: int
    param_specs: Any
    batch_specs: Dict[str, Any]
    ocfg: optim.AdamWConfig
    note: str = ""
    regime: str = "tp"

    @property
    def comm(self):
        """The mesh's groups; in the ``fsdp`` regime a model group of
        one, the world as the data group, and the ``FsdpGather`` of this
        rank's shards."""
        comm = _comm(self.mesh)
        if self.regime != "fsdp":
            return comm
        return Comm(model=ONE, data=comm.world, world=comm.world,
                    fsdp=FsdpGather(self.param_specs, comm))

    def init_state(self, seed: int = 0, device=None) -> Tuple[Any, Any]:
        """(this rank's parameter slices, its optimizer parts):
        ``init_params(cfg, seed)`` cut by ``shard_params``, drawn a slice
        at a time (``part``) so that the full tree is never held."""
        params = T.init_params(self.cfg, seed, device, part=shd.part_of(
            self.param_specs, self.mesh))
        return params, self.init_opt(params)

    def init_opt(self, params):
        return optim.init_opt_state(params, self.mesh.size, comm=self.comm,
                                    specs=self.param_specs)

    def local_batch(self, batch: Dict[str, torch.Tensor]):
        """This rank's rows of a global batch: for each key split on dim
        0, microbatch j's (rows [j b, (j+1) b)) data shard, microbatches
        in order; a key the batch specs replicate stays whole."""
        if self.regime == "fsdp":
            return _rows(batch, self.batch_specs, self.mesh.size,
                         self.comm.world.rank)
        return _rows(batch, self.batch_specs, mesh_lib.batch_extent(
            self.mesh), _comm(self.mesh).data.rank, self.microbatches)

    def step(self, params, opt_state, batch, *, remat: bool = True):
        """One ``train_step`` of this rank on its rows of the global
        ``batch``."""
        return train_step(self.cfg, params, opt_state,
                          self.local_batch(batch), self.ocfg,
                          microbatches=self.microbatches, remat=remat,
                          comm=self.comm, specs=self.param_specs)


def _comm(mesh):
    """A cell's groups: its realized mesh's ``Comm``."""
    if mesh.rank is None:
        raise ValueError("the cell's mesh is abstract: realize it")
    return mesh.comm


def _rows(batch, specs, d: int, c: int, n: int = 1):
    """``Cell.local_batch`` of ``n`` microbatches: data shard ``c`` of
    ``d``."""
    out = {}
    for k, t in batch.items():
        if d == 1 or specs.get(k, (None,))[0] is None:
            out[k] = t
            continue
        B = t.shape[0]
        if B % (n * d):
            raise ValueError(f"{k}: batch {B} does not split into "
                             f"{n} microbatches over {d} data ranks")
        b = B // n // d
        v = t.reshape((n, d, b) + tuple(t.shape[1:]))[:, c]
        out[k] = v.reshape((n * b,) + tuple(t.shape[1:]))
    return out


@dataclasses.dataclass
class ServeCell:
    """A serving cell on a mesh (the ``prefill`` and ``decode`` kinds):
    ``batch`` the global batch, ``seq`` the prompt length (prefill) or the
    cache's (decode), ``max_len`` the cache's positions, split over
    ``model`` in shards of ``max_len / tp``."""
    arch: str
    shape: str
    kind: str
    cfg: ModelConfig
    mesh: mesh_lib.Mesh
    batch: int
    seq: int
    max_len: int
    param_specs: Any
    batch_specs: Dict[str, Any]
    cache_specs: Any
    note: str = ""

    @property
    def comm(self):
        return _comm(self.mesh)

    def init_state(self, seed: int = 0, device=None):
        """This rank's parameter slices under ``param_specs``: the
        full tree of ``init_params(cfg, seed)`` cut by ``shard_params``,
        drawn a slice at a time (``part``)."""
        return T.init_params(self.cfg, seed, device, part=shd.part_of(
            self.param_specs, self.mesh))

    def init_cache(self, device=None):
        """This rank's empty shard of the decode cache under
        ``cache_specs``: {"k", "v"} of (L, B_l, max_len / tp, Hkv, dh),
        MLA's {"ckv", "kr"}, a ring's {"k", "v", "pos"} of its Wd / tp
        slots, the encoder-decoder's {"xk", "xv"} beside k and v, the
        SSM's and RG-LRU's leaves over the rank's heads and channels (the
        hybrid's nested tree), each leaf its own tensor filled as
        ``init_cache`` fills it (zeros; a ring's positions -1, empty)."""
        dev = compat.resolve_device(device)
        part = shd.part_of(self.cache_specs, self.mesh)
        full = T.init_cache(self.cfg, self.batch, self.max_len,
                            device="meta")
        fill = T.init_cache(self.cfg, 1, 1, device="cpu")
        return T._map_spec(full, lambda path, t: torch.full(
            t[part(path, t.shape)].shape,
            shd._get(fill, path).reshape(-1)[0].item(), dtype=t.dtype,
            device=dev))

    def local_batch(self, batch: Dict[str, torch.Tensor]):
        """This rank's rows of a global batch (``tokens``, a decode's
        ``lengths``): each key split on dim 0 over the data ranks in their
        order; a key the batch specs replicate stays whole."""
        return _rows(batch, self.batch_specs, mesh_lib.batch_extent(
            self.mesh), _comm(self.mesh).data.rank)


class PrefillCell(ServeCell):
    def step(self, params, batch: Dict[str, torch.Tensor]):
        """``transformer.prefill`` of this rank's rows of the global
        ``batch`` over the mesh: (the last position's logits (B_l, 1, V),
        this rank's cache in the decode layout, ``max_len`` positions).
        The vision decoder's batch holds ``patches`` (B, P, D) beside its
        tokens (B, seq - P), which together fill the cell's ``seq``
        positions, and the encoder-decoder's its ``frames`` (B,
        encoder_seq, D), as the reference's prefill batch does."""
        b = self.local_batch(batch)
        patches = b.get("patches")
        n = b["tokens"].shape[1] + (0 if patches is None
                                    else patches.shape[1])
        if n != self.seq:
            raise ValueError(f"{self.arch} x {self.shape}: a prompt of {n} "
                             f"positions (patches and tokens) in a cell of "
                             f"{self.seq}")
        return T.prefill(self.cfg, params, b["tokens"], patches=patches,
                         frames=b.get("frames"), comm=self.comm,
                         max_len=self.max_len)


class DecodeCell(ServeCell):
    def step(self, params, cache, tokens, lengths):
        """One greedy step of this rank's rows (``local_batch``) over the
        mesh: ``(next_tokens, cache, lengths + 1)``, the cache (this
        rank's shard) updated in place."""
        nxt, cache = T.decode_step(self.cfg, params, cache, tokens, lengths,
                                   self.comm)
        return nxt, cache, lengths + 1


def _serve_cell(cfg, arch, shape, mesh, batch_seq, max_len) -> ServeCell:
    """``build_cell``'s prefill and decode kinds."""
    kind = shape.kind
    axes = mesh_lib.mesh_axes(mesh)
    tp = mesh.shape["model"]
    T.check_servable(cfg, tp, kind)
    mesh_batch = mesh_lib.batch_extent(mesh)
    B, S = batch_seq or (shape.global_batch, shape.seq_len)
    if kind == "decode" and max_len not in (None, S):
        raise ValueError(f"a decode cell's cache holds its {S} positions, "
                         f"not max_len {max_len}")
    n = max_len or S
    if n < S or n % tp:
        raise ValueError(f"{arch} x {shape.name}: a cache of {n} positions "
                         f"(the sequence {S}) does not split over {tp} ranks")
    if cfg.family == "vlm" and kind == "prefill" and S <= cfg.num_patches:
        raise ValueError(f"{arch} x {shape.name}: {S} positions hold no "
                         f"token after the {cfg.num_patches} patches")
    T.ring_slots(cfg, n, tp)
    if cfg.family == "audio" and cfg.encoder_seq % tp:
        raise ValueError(f"{arch} x {shape.name}: a cross cache of "
                         f"{cfg.encoder_seq} encoder positions does not "
                         f"split over {tp} ranks")
    regime = "tp" if kind == "prefill" else "decode"
    Wd = T.ring_slots(cfg, n)
    held = (f"ring slots over model ({Wd // tp} of {Wd} a rank)" if Wd else
            f"cache sequence over model ({n // tp} positions a rank)")
    if cfg.family == "ssm":
        held = "SSM state and conv over model (channel TP)"
    elif cfg.family == "hybrid":
        held += ", RG-LRU state and conv over model (channel TP)"
    elif cfg.family == "audio":
        held += (f", cross cache over model ({cfg.encoder_seq // tp} "
                 f"encoder positions a rank)")
    note = shd.explain(cfg, tp) if kind == "prefill" else (
        f"attention replicated, {held}" + (
            f", EP {cfg.num_experts}/{tp} experts per shard" if cfg.is_moe
            else ""))
    return (PrefillCell if kind == "prefill" else DecodeCell)(
        arch, shape.name, kind, cfg, mesh, B, S, n,
        shd.param_specs(cfg, axes, tp, regime),
        shd.batch_specs(cfg, axes, B, mesh_batch, kind),
        shd.cache_specs(cfg, axes, tp, B, mesh_batch), note=note)


def _auto_microbatches(cfg, B, S, mesh_batch, floor, target=2 * 2**30):
    """Pick the microbatch count so the per-device remat stash (one hidden
    state per layer per microbatch) stays under ``target`` bytes."""
    L = cfg.num_layers + cfg.encoder_layers
    n = 1
    while n < floor and B % (2 * n * mesh_batch) == 0:
        n *= 2
    per_layer = lambda nn: (B // mesh_batch // nn) * S * cfg.d_model * 2
    while (L * per_layer(n) > target and B % (2 * n * mesh_batch) == 0
           and B // mesh_batch // n > 1):
        n *= 2
    return n


def build_cell(arch, shape_name: str, mesh: mesh_lib.Mesh, *,
               opt_cfg: Optional[optim.AdamWConfig] = None,
               microbatches: int = 4,
               exact_microbatches: Optional[int] = None,
               train_regime: str = "tp",
               batch_seq: Optional[Tuple[int, int]] = None,
               over: Optional[Dict[str, Any]] = None,
               max_len: Optional[int] = None):
    """The cell of ``arch`` (an arch id or a ``ModelConfig``) x
    ``shape_name`` on ``mesh``: a train ``Cell``, or a ``PrefillCell`` or
    ``DecodeCell`` for the serving shapes.  ``batch_seq`` overrides the
    shape's (global batch, sequence) and ``over`` replaces config fields
    (a depth cut, ``num_layers``; a dtype); ``max_len`` is a prefill's
    cache length (default the sequence, the reference's).
    ``train_regime`` is a train cell's: "tp" or "fsdp"."""
    if isinstance(arch, ModelConfig):
        cfg, arch = arch, arch.name
    else:
        cfg = get_config(arch)
    if over:
        cfg = dataclasses.replace(cfg, **over)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{arch} x {shape_name}: {why}")
    if shape.kind != "train":
        return _serve_cell(cfg, arch, shape, mesh, batch_seq, max_len)
    if train_regime not in ("tp", "fsdp"):
        raise ValueError(f"train_regime {train_regime!r}: 'tp' or 'fsdp'")
    axes = mesh_lib.mesh_axes(mesh)
    tp = mesh.shape["model"]
    B, S = batch_seq or (shape.global_batch, shape.seq_len)
    if train_regime == "fsdp":
        # ZeRO-3: the whole mesh is the data-parallel world
        T.check_trainable(cfg, 1)
        axes = MeshAxes(batch=axes.batch + (axes.model,), model=None)
        return Cell(arch, shape_name, cfg, mesh, B, S, 1,
                    shd.param_specs(cfg, axes, tp, "fsdp", n_dev=mesh.size),
                    shd.batch_specs(cfg, axes, B, mesh.size, "train"),
                    opt_cfg or optim.AdamWConfig(),
                    note=f"fsdp over {mesh.size} ranks", regime="fsdp")
    T.check_trainable(cfg, tp)
    mesh_batch = mesh_lib.batch_extent(mesh)
    n_mb = (exact_microbatches if exact_microbatches
            else _auto_microbatches(cfg, B, S, mesh_batch, microbatches))
    return Cell(arch, shape_name, cfg, mesh, B, S, n_mb,
                shd.param_specs(cfg, axes, tp, "tp", n_dev=mesh.size),
                shd.batch_specs(cfg, axes, B, mesh_batch, "train"),
                opt_cfg or optim.AdamWConfig(), note=shd.explain(cfg, tp))
