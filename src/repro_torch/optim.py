"""AdamW with mixed precision and ZeRO-1 optimizer-state sharding: the
port's counterpart of ``repro.optim``.

The optimizer keeps, per parameter leaf, a flat fp32 master copy and the
Adam moments m and v; the step counter drives the bias correction; the
gradients are clipped by their global fp32 norm; weight decay acts on
the master, and each parameter is the master cast to the leaf's dtype.
``apply_updates`` computes what ``repro.optim.apply_updates`` computes,
leaf for leaf (in the JAX package's leaf order: sorted keys), and writes
the parameters and the optimizer state in place under ``torch.no_grad``:
the serving path's per-layer views (``models/transformer._per_layer``)
share the parameters' storage and stay valid.  A leaf is updated in
slices of ``UPDATE_CHUNK`` elements, so that the fp32 temporaries of one
update stay small beside a large leaf (Qwen3-30B-A3B's stacked expert
weights hold 201M parameters a layer); every element's arithmetic is the
same either way.

ZeRO-1 over ``n_dev`` ranks (``comm``, a
``distributed/collectives.py::Comm``, and ``specs``, the leaves'
``distributed/sharding.py`` specs): each rank holds 1/n_dev of every
leaf's flat fp32 master and moments.  A leaf split over the model group
pads its local flat slice to a multiple of the data group's size; the
data group reduce-scatters its gradient and each rank updates its part,
then all-gathers the parameter slice.  A leaf replicated over the model
group pads its flat to a multiple of n_dev (the reference's
``_flat_pad``); the data group reduce-scatters it in data-size pieces,
of which each model rank keeps its 1/tp (the model ranks hold the same
gradient), and the world all-gathers the parameter.  World rank = data
index x tp + model index, so a replicated leaf's parts lie in the
reference's flat order.  The gradients are reduced in their own dtype
(bf16 for one bf16 microbatch, as the reference's); the global norm sums
each rank's squares of its parts, so each element counts once.  On one
device nothing is padded or sent, and the arithmetic is that of the
one-device optimizer; ``zero1`` then changes nothing, as in the
reference.

In the ``fsdp`` regime (``comm.fsdp``, ZeRO-3) the parameters are each
rank's shards and their gradients arrive summed over the world (the
gathers' backward); each rank keeps the master and moments of its
shards and updates them as one device does, and the global norm counts
each shard once, on the first rank that holds it
(``FsdpGather.first_holder``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.distributed.collectives import LOCAL


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    zero1: bool = True          # shard master/m/v over all devices
    max_grad_norm: float = 1.0


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a nested dict in the JAX package's order (sorted
    keys at every level)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree)
                for leaf in tree_leaves(tree[key])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of the trees in ``rest``,
    which share its keys), as a nested dict of the same keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _model_split(spec) -> bool:
    return any(e == "model" or (isinstance(e, tuple) and "model" in e)
               for e in spec)


def _layout(comm, specs, n_dev: int):
    """(comm, leaf -> (split over the model group, pad multiple)).  On
    ``n_dev`` 1 nothing pads."""
    if comm is None:
        comm = LOCAL
    if comm.n_dev != n_dev:
        raise ValueError(f"n_dev {n_dev} but the comm spans "
                         f"{comm.n_dev} ranks")
    if n_dev > 1 and specs is None:
        raise ValueError("ZeRO-1 over n_dev > 1 needs the leaves' specs")

    def of(spec):
        split = comm.tp > 1 and spec is not None and _model_split(spec)
        return split, (comm.data.size if split else n_dev)

    return comm, of


def _part(flat: torch.Tensor, split: bool, mult: int, comm):
    """This rank's part of a leaf's flat (padded to ``mult``) after the
    data group's reduce-scatter; the flat itself on one device."""
    pad = (-flat.numel()) % mult
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    piece = comm.data.reduce_scatter(flat)
    if split or comm.tp == 1:
        return piece
    c = piece.numel() // comm.tp
    r = comm.model.rank
    return piece[r * c:(r + 1) * c]


def _spec_leaves(specs, params):
    if specs is None:
        return [None] * len(tree_leaves(params))
    out = []

    def walk(sp, p):
        if isinstance(p, dict):
            for k in sorted(p):
                walk(sp[k], p[k])
        else:
            out.append(sp)

    walk(specs, params)
    return out


def init_opt_state(params, n_dev: int = 1, *, comm=None,
                   specs=None) -> Dict[str, Any]:
    """Per leaf this rank's part of the flat fp32 master (a copy of the
    parameter) and zero moments m and v; the step counter (int32) at 0.
    ``params`` are this rank's local slices."""
    comm, of = _layout(comm, specs, n_dev)
    sp = iter(_spec_leaves(specs, params))
    zero1 = n_dev > 1 and comm.fsdp is None

    def make(p):
        split, mult = of(next(sp))
        f = p.detach().reshape(-1).to(torch.float32)
        if zero1:
            pad = (-f.numel()) % mult
            f = torch.cat([f, f.new_zeros(pad)])
            n = f.numel() // comm.data.size
            f = f[comm.data.rank * n:(comm.data.rank + 1) * n]
            if not split and comm.tp > 1:
                c = n // comm.tp
                f = f[comm.model.rank * c:(comm.model.rank + 1) * c]
        f = f.clone()
        return {"master": f, "m": torch.zeros_like(f),
                "v": torch.zeros_like(f)}

    leaves = _unflatten_like(params, [make(p) for p in tree_leaves(params)])
    dev = tree_leaves(params)[0].device
    return {"leaves": leaves,
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _unflatten_like(tree, flat):
    it = iter(flat)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return next(it)

    return walk(tree)


def opt_state_specs(param_specs_tree, all_axes: Tuple[str, ...],
                    zero1: bool):
    """The reference's spec tree of ``init_opt_state``'s result: each flat
    leaf over every axis under ZeRO-1, else replicated."""
    names = tuple(all_axes)
    flat_spec = ((names[0] if len(names) == 1 else names),) if zero1 \
        else ()

    def make(_):
        return {"master": flat_spec, "m": flat_spec, "v": flat_spec}

    return {"leaves": tree_map(make, param_specs_tree), "step": ()}


# elements of a leaf updated at once
UPDATE_CHUNK = 1 << 26


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, opt_state,
                  n_dev: int = 1, *, comm=None, specs=None):
    """One AdamW step on ``params`` with ``grads`` (a tree of the same
    keys, any float dtype; this rank's unreduced local gradients).
    Writes the parameters and ``opt_state`` in place and returns
    ``(params, opt_state, grad_norm)``; ``grad_norm`` is the fp32 global
    norm before the clip."""
    comm, of = _layout(comm, specs, n_dev)
    if n_dev > 1 and not cfg.zero1:
        raise NotImplementedError("AdamW over n_dev > 1 shards its state "
                                  "(zero1=True)")
    step = opt_state["step"] + 1
    stepf = step.to(torch.float32)
    b1c = 1.0 - cfg.b1 ** stepf
    b2c = 1.0 - cfg.b2 ** stepf

    pairs = list(_pairs(params, opt_state["leaves"]))
    flat_g = tree_leaves(grads)
    if len(pairs) != len(flat_g):
        raise ValueError(f"apply_updates: {len(pairs)} params, "
                         f"{len(flat_g)} grads")
    spec_leaves = _spec_leaves(specs, params)
    layout = [of(sp) for sp in spec_leaves]
    zero1 = n_dev > 1 and comm.fsdp is None
    counted = flat_g
    if zero1:
        flat_g = [_part(g.reshape(-1), split, mult, comm)
                  for g, (split, mult) in zip(flat_g, layout)]
        counted = flat_g
    elif comm.fsdp is not None:
        counted = [g for g, sp in zip(flat_g, spec_leaves)
                   if comm.fsdp.first_holder(sp)]
    sq = sum(torch.sum(torch.square(g.to(torch.float32))) for g in counted)
    gnorm = torch.sqrt(comm.world.all_reduce(sq))
    scale = torch.clamp_max(cfg.max_grad_norm / torch.clamp_min(gnorm, 1e-12),
                            1.0)

    for (p, st), g, (split, _) in zip(pairs, flat_g, layout):
        flat_gl = g.reshape(-1)
        upd_p = None if zero1 else p.view(-1)
        for a in range(0, flat_gl.numel(), UPDATE_CHUNK):
            sl = slice(a, a + UPDATE_CHUNK)
            gf = flat_gl[sl].to(torch.float32) * scale
            m = cfg.b1 * st["m"][sl] + (1 - cfg.b1) * gf
            v = cfg.b2 * st["v"][sl] + (1 - cfg.b2) * gf * gf
            upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            master = (st["master"][sl] * (1 - cfg.lr * cfg.weight_decay)
                      - cfg.lr * upd)
            st["m"][sl].copy_(m)
            st["v"][sl].copy_(v)
            st["master"][sl].copy_(master)
            if upd_p is not None:
                upd_p[sl].copy_(master)
        if upd_p is None:
            _gather_into(p, st["master"], split, comm)
    opt_state["step"] = step
    return params, opt_state, gnorm


def _gather_into(p: torch.Tensor, master: torch.Tensor, split: bool,
                 comm) -> None:
    """The parameter slice ``p`` from every rank's master part: gathered
    over the data group (a model-split leaf) or the world, unpadded and
    cast."""
    group = comm.data if split else comm.world
    full = group.all_gather(master.to(p.dtype))
    p.view(-1).copy_(full[:p.numel()])


def gather_opt_state(opt_state, params, comm, specs) -> Dict[str, Any]:
    """Each leaf's master, m and v as this rank's whole local slice
    (unpadded, the local parameter's shape): the inverse of the parts'
    layout, for checkpoints and tests."""
    _, of = _layout(comm, specs, comm.n_dev)
    sp = iter(_spec_leaves(specs, params))

    def join(p, st):
        split, _ = of(next(sp))
        group = comm.data if split else comm.world
        return {k: group.all_gather(st[k])[:p.numel()].reshape(p.shape)
                for k in ("master", "m", "v")}

    if comm.fsdp is not None:       # each rank's shard's state
        return {"leaves": tree_map(lambda p, st: {
            k: st[k].reshape(p.shape) for k in ("master", "m", "v")},
            params, opt_state["leaves"]), "step": opt_state["step"]}
    flat = [join(p, st) for p, st in _pairs(params, opt_state["leaves"])]
    return {"leaves": _unflatten_like(params, flat),
            "step": opt_state["step"]}


def _pairs(params, states):
    """(parameter, its ``{"master", "m", "v"}``) in ``tree_leaves`` order."""
    if isinstance(params, dict):
        for key in sorted(params):
            yield from _pairs(params[key], states[key])
    else:
        yield params, states
