"""Meshes of the port's multi-GPU path.

A ``Mesh`` names its axes (``("data", "model")``, or ``("pod", "data",
"model")``) and their sizes.  An abstract mesh (no rank) is a shape for
the meta-device dry run (``launch/dryrun.py``) and for the sharding
rules; ``Mesh.realize`` joins it to the running ``torch.distributed``
process group: this rank's coordinates, the
``torch.distributed.device_mesh.init_device_mesh`` mesh, and the
``collectives.Comm`` of its groups (``model``, the batch axes flattened
as ``data``, and the world).

``make_production_mesh`` lays the paper's 128-GPU cluster out on H100
nodes: ``(16, 8)``, ``model`` being the 8 GPUs of one NVLink node, so
that tensor and expert parallelism stay on NVLink and only data
parallelism crosses InfiniBand; ``multi_pod=True`` gives ``(2, 16, 8)``.
The reference's ``16x16`` and ``2x16x16`` are TPU v5e pods: on H100s a
model axis of 16 would cross InfiniBand.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch.distributed as dist

from repro_torch.distributed.collectives import Comm, Group
from repro_torch.models.api import MeshAxes


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    rank: Optional[int] = None          # world rank; None: abstract
    comm: Comm = Comm()
    device_mesh: Optional[object] = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's index on each axis (row-major over the axes)."""
        if self.rank is None:
            raise ValueError("an abstract mesh has no rank")
        out, r = {}, self.rank
        for name, n in reversed(list(zip(self.axis_names, self.sizes))):
            out[name] = r % n
            r //= n
        return {name: out[name] for name in self.axis_names}

    def realize(self, device_type: str) -> "Mesh":
        """This mesh over the initialized default process group, whose
        world size must be the mesh's size: the device mesh and this
        rank's ``Comm``.  Every rank must call it, in the same order."""
        from torch.distributed.device_mesh import init_device_mesh

        if not dist.is_initialized():
            raise RuntimeError("Mesh.realize: torch.distributed is not "
                               "initialized (init_process_group first)")
        world = dist.get_world_size()
        if world != self.size:
            raise ValueError(f"mesh {self.shape} needs {self.size} ranks, "
                             f"the process group has {world}")
        rank = dist.get_rank()
        dm = init_device_mesh(device_type, self.sizes,
                              mesh_dim_names=self.axis_names)
        tp = self.shape["model"]
        nb = self.size // tp
        cb = rank // tp
        if len(self.axis_names) == 2:
            data_pg = dm.get_group("data")
        else:       # the batch axes flattened: one group per model index
            data_pg = None
            for m in range(tp):
                pg = dist.new_group([b * tp + m for b in range(nb)])
                if m == rank % tp:
                    data_pg = pg

        comm = Comm(
            model=Group("model", tp, rank % tp, dm.get_group("model"),
                        tuple(cb * tp + m for m in range(tp))),
            data=Group("data", nb, cb, data_pg,
                       tuple(b * tp + rank % tp for b in range(nb))),
            world=Group("world", self.size, rank, dist.group.WORLD,
                        tuple(range(self.size))))
        return dataclasses.replace(self, rank=rank, comm=comm,
                                   device_mesh=dm)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(16, 8) over ("data", "model"): 128 H100s, 16 nodes of 8; with
    ``multi_pod`` (2, 16, 8) over ("pod", "data", "model")."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 8))
    return Mesh(("data", "model"), (16, 8))


def make_test_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A small abstract mesh with the production axis names."""
    return Mesh(("data", "model"), (data, model))


def mesh_axes(mesh: Mesh) -> MeshAxes:
    if "pod" in mesh.axis_names:
        return MeshAxes(batch=("pod", "data"), model="model")
    return MeshAxes(batch=("data",), model="model")


def batch_extent(mesh: Mesh) -> int:
    """Product of the DP axis sizes."""
    ax = mesh_axes(mesh)
    return math.prod(mesh.shape[a] for a in ax.batch) if ax.batch else 1
