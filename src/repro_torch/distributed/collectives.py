"""The port's collectives: every model and optimizer collective of the
multi-GPU path goes through a ``Group`` here, which records it.

Counterpart of ``repro.distributed.collectives``.  The reference reads
its collectives off the partitioned HLO (``collective_stats(hlo)``); the
port issues them itself, explicitly, over ``torch.distributed`` process
groups, so each call records one event (kind, result bytes, group size)
and ``collective_stats()`` turns the recorded events into the
reference's dict with the reference's ring factors (``_FACTORS``):

    all-reduce          2*(n-1)/n * bytes      (ring reduce+broadcast)
    all-gather          (n-1)/n  * bytes       (result = gathered tensor)
    reduce-scatter      (n-1)    * bytes       (result = one shard)
    all-to-all          (n-1)/n  * bytes

Bytes are per rank.  A group of one is skipped, as the reference skips
it: the call returns its input (no process-group call, no autograd node)
and records nothing; ``skip_one=False`` sends it all the same (a check
of the transport on one card).

The conjugate pairs of tensor parallelism are autograd functions over a
group: ``Group.copy_in`` (identity forward, all-reduce backward: before
a column-parallel product, and on a replicated weight whose gradient
each rank holds only a part of; several tensors' gradients in one
all-reduce) and ``Group.reduce_out`` (all-reduce forward, identity
backward: after a row-parallel product); ``Group.reduce_whole``, the
two composed (all-reduce both ways), sums the ranks' terms of a
statistic every rank reads whole (the SSM's gated norm over its split
channels).  The ``fsdp`` regime's
``FsdpGather`` gathers a weight's shards where the model reads it
(all-gather forward, reduce-scatter backward).

The reduce-scatter is ``reduce_scatter_tensor`` (not
``reduce_scatter_single``, which torch 2.11 lacks).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

_FACTORS = {
    "all-reduce": lambda n: 2 * (n - 1) / max(n, 1),
    "all-gather": lambda n: (n - 1) / max(n, 1),
    "reduce-scatter": lambda n: float(n - 1),
    "all-to-all": lambda n: (n - 1) / max(n, 1),
    "collective-permute": lambda n: 1.0,
}


def hierarchical_a2a_cost(nbytes_per_device: float, pods: int, per_pod: int,
                          ici_bw: float = 50e9, dcn_bw: float = 12.5e9):
    """Two-hop (pod-local first) all-to-all vs flat all-to-all cost model
    (the reference's, copied; its default rates are the TPU's links).
    Flat a2a sends (g-1)/g of the buffer over the slowest link class; the
    hierarchical schedule first exchanges within the pod, then sends one
    aggregated stream per pod pair over the inter-pod links.  Returns
    (flat_s, hierarchical_s)."""
    g = pods * per_pod
    flat = nbytes_per_device * (g - 1) / g / dcn_bw
    intra = nbytes_per_device * (per_pod - 1) / per_pod / ici_bw
    inter = nbytes_per_device * (pods - 1) / pods / dcn_bw
    return flat, intra + inter


# (kind, result bytes, group size) of every call since ``reset_events``
EVENTS: List[Tuple[str, int, int]] = []


def reset_events() -> None:
    EVENTS.clear()


def stats_of(events: Iterable[Tuple[str, int, int]]) -> Dict:
    """The reference's ``collective_stats`` dict of (kind, bytes, group
    size) events: counts, raw and wire bytes by kind, total wire bytes;
    groups of one skipped."""
    raw = defaultdict(float)
    wire = defaultdict(float)
    counts = defaultdict(int)
    for kind, nbytes, n in events:
        if n <= 1:
            continue
        counts[kind] += 1
        raw[kind] += nbytes
        wire[kind] += nbytes * _FACTORS[kind](n)
    return {
        "counts": dict(counts),
        "raw_bytes": dict(raw),
        "wire_bytes": dict(wire),
        "total_wire_bytes": sum(wire.values()),
    }


def collective_stats() -> Dict:
    """``stats_of`` the events recorded since ``reset_events``."""
    return stats_of(EVENTS)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclasses.dataclass(frozen=True)
class Group:
    """One process group of the mesh: its size, this rank's index in it,
    the ``torch.distributed`` group, and the world ranks it holds in group
    order."""
    name: str
    size: int = 1
    rank: int = 0
    pg: Optional[object] = None
    ranks: Tuple[int, ...] = (0,)
    skip_one: bool = True

    @property
    def trivial(self) -> bool:
        return self.size == 1 and self.skip_one

    def _record(self, kind: str, nbytes: int) -> None:
        EVENTS.append((kind, nbytes, self.size))

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The reduction of x over the group (a new tensor; x itself in a
        group of one).  Not differentiable: see ``reduce_out``."""
        if self.trivial:
            return x
        out = x.detach().contiguous().clone()
        self._record("all-reduce", _nbytes(out))
        dist.all_reduce(out, op=_OPS[op], group=self.pg)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The group's x (each of the same shape) concatenated on dim 0 in
        group order."""
        if self.trivial:
            return x
        x = x.contiguous()
        out = torch.empty((self.size * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        self._record("all-gather", _nbytes(out))
        dist.all_gather_into_tensor(out, x, group=self.pg)
        return out

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the group of x (dim 0 a multiple of the size),
        this rank's 1/size of it on dim 0."""
        if self.trivial:
            return x
        x = x.contiguous()
        if x.shape[0] % self.size:
            raise ValueError(f"reduce_scatter over {self.name}: dim 0 "
                             f"{x.shape[0]} not a multiple of {self.size}")
        out = torch.empty((x.shape[0] // self.size,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        self._record("reduce-scatter", _nbytes(out))
        dist.reduce_scatter_tensor(out, x, group=self.pg)
        return out

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Equal splits of x on dim 0 exchanged across the group."""
        if self.trivial:
            return x
        x = x.contiguous()
        out = torch.empty_like(x)
        self._record("all-to-all", _nbytes(out))
        dist.all_to_all_single(out, x, group=self.pg)
        return out

    def copy_in(self, *xs: torch.Tensor):
        """Identity forward, all-reduce (sum) of the gradient backward.
        Given several tensors, returns them as a tuple and sums their
        gradients in one all-reduce (of their flats concatenated)."""
        if self.trivial:
            return xs[0] if len(xs) == 1 else xs
        out = _CopyIn.apply(self, *xs)
        return out[0] if len(xs) == 1 else out

    def reduce_out(self, x: torch.Tensor) -> torch.Tensor:
        """All-reduce (sum) forward, identity backward."""
        if self.trivial:
            return x
        return _ReduceOut.apply(x, self)

    def reduce_whole(self, x: torch.Tensor) -> torch.Tensor:
        """All-reduce (sum) forward and backward: ``copy_in`` of
        ``reduce_out``.  For a sum of the ranks' terms that every rank
        then reads whole, each rank's output depending on it through its
        own shard (the mean square of the SSM's gated norm over the
        group's channels): the gradient of a rank's term is the ranks'
        gradients of the sum, summed."""
        return self.copy_in(self.reduce_out(x))


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *dys):
        if len(dys) == 1:
            return None, ctx.group.all_reduce(dys[0])
        dt = dys[0].dtype
        for d in dys[1:]:
            dt = torch.promote_types(dt, d.dtype)
        s = ctx.group.all_reduce(torch.cat([d.reshape(-1).to(dt)
                                            for d in dys]))
        out, a = [], 0
        for d in dys:
            out.append(s[a:a + d.numel()].view_as(d).to(d.dtype))
            a += d.numel()
        return (None,) + tuple(out)


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _Gather(torch.autograd.Function):
    """A leaf's shard to the whole leaf: all-gather over ``group`` on dim
    ``dim`` forward; backward the gradient reduce-scattered over
    ``group`` on that dim, then all-reduced over ``rest`` (the ranks
    that hold the same shard)."""

    @staticmethod
    def forward(ctx, x, dim, group, rest):
        ctx.dim, ctx.group, ctx.rest = dim, group, rest
        full = group.all_gather(x.movedim(dim, 0).contiguous())
        return full.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, dy):
        g = ctx.group.reduce_scatter(dy.movedim(ctx.dim, 0).contiguous())
        g = ctx.rest.all_reduce(g.movedim(0, ctx.dim).contiguous())
        return g, None, None, None


class FsdpGather:
    """The ``fsdp`` regime's weights (ZeRO-3): each rank holds its shard
    of every leaf under ``specs`` (``distributed/sharding.py::
    param_specs(..., "fsdp")``) and the model gathers a leaf where it
    reads it.  A leaf split over every mesh axis is gathered over the
    world; one split over ``model`` alone (the fallback of ``_fsdp_rule``)
    over the model group, its gradient then summed over the data group;
    a replicated one is read as it is, its gradient summed over the
    world (``Group.copy_in``).  ``groups`` is the mesh's ``Comm``."""

    def __init__(self, specs, groups: "Comm"):
        self.specs, self.groups = specs, groups

    def _split(self, spec):
        """(dim, gather group, group of the ranks holding the same shard)
        of a spec; dim None for a replicated leaf."""
        g = self.groups
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            if entry == "model":
                return d, g.model, g.data
            return d, g.world, ONE
        return None, ONE, g.world

    def __call__(self, path, t: torch.Tensor) -> torch.Tensor:
        """The whole leaf at ``path`` from this rank's shard ``t``, or of
        a stacked leaf one layer's (``t`` one dim short of the spec,
        whose leading entry is the layer axis), differentiable."""
        sp = self.specs
        for k in path:
            sp = sp[k]
        dim, group, rest = self._split(sp[len(sp) - t.dim():])
        if dim is None:
            return rest.copy_in(t)
        if group.trivial and rest.trivial:
            return t
        return _Gather.apply(t, dim, group, rest)

    def first_holder(self, spec) -> bool:
        """Whether this rank is the first of the ranks that hold the same
        shard of a leaf under ``spec`` (its gradient counts once in the
        global norm)."""
        _, _, rest = self._split(spec)
        return rest.rank == 0


ONE = Group("one")


@dataclasses.dataclass(frozen=True)
class Comm:
    """The groups of one rank of a mesh: ``model`` (the tensor- and
    expert-parallel axis), ``data`` (every batch axis: ``pod`` and
    ``data`` flattened) and ``world``; world rank = data index x model
    size + model index, so the world group's order is the reference's
    flat layout over ``(*batch, "model")``.  In the ``fsdp`` regime
    ``model`` is a group of one, ``data`` the world, and ``fsdp`` the
    ``FsdpGather`` of the rank's weight shards (None elsewhere)."""
    model: Group = ONE
    data: Group = ONE
    world: Group = ONE
    fsdp: Optional[FsdpGather] = None

    @property
    def tp(self) -> int:
        return self.model.size

    @property
    def n_dev(self) -> int:
        return self.world.size


LOCAL = Comm()
