"""The port's sharding rules against the reference's, on the CPU.

For every arch of the reference's ``ARCH_IDS`` and tp in {1, 2, 4, 8,
16}: ``param_specs`` in the ``tp``, ``decode`` and ``fsdp`` regimes,
``cache_specs`` and ``batch_specs`` (single-pod and multi-pod axes, a
batch that splits over the DP axes and one that does not),
``attention_mode`` and ``explain`` equal the reference's, each
``PartitionSpec`` read as a tuple.  ``shard_params`` then
``gather_params`` is the identity, and ``opt_state_specs`` is the
reference's.  The reference traces ``init_params`` once per call
(``jax.eval_shape``); the tests memoize that trace per config.
"""
import dataclasses

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import optim as joptim
from repro.configs import ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.distributed import sharding as J
from repro.models.api import MeshAxes as JAxes
from repro_torch import optim
from repro_torch.configs import get_config, reduced_config
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.collectives import Comm
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as TT
from repro_torch.models.api import MeshAxes

TPS = (1, 2, 4, 8, 16)
AXES = {"single": (JAxes(), MeshAxes()),
        "multi": (JAxes(batch=("pod", "data")),
                  MeshAxes(batch=("pod", "data")))}


class _MemoJax:
    """``jax`` for the reference's sharding module, with ``eval_shape``
    of its ``init_params`` / ``init_cache`` closures memoized by the
    closure's contents (the config and the cache's sizes)."""

    def __init__(self):
        self.cache = {}

    def __getattr__(self, name):
        return getattr(jax, name)

    def eval_shape(self, fn, *a):
        key = (fn.__code__, tuple(c.cell_contents
                                  for c in fn.__closure__ or ()))
        if key not in self.cache:
            self.cache[key] = jax.eval_shape(fn, *a)
        return self.cache[key]


_MEMO = _MemoJax()


@pytest.fixture
def memo(monkeypatch):
    monkeypatch.setattr(J, "jax", _MEMO)


def _as_tuples(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


def _nested(tree):
    """A JAX pytree of dicts as plain nested dicts."""
    if isinstance(tree, dict):
        return {k: _nested(v) for k, v in tree.items()}
    return tree


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_the_reference(arch, memo):
    jcfg, cfg = j_get_config(arch), get_config(arch)
    for tp in TPS:
        assert shd.attention_mode(cfg, tp) == J.attention_mode(jcfg, tp)
        assert shd.explain(cfg, tp) == J.explain(jcfg, tp)
        for name, (jax_axes, axes) in AXES.items():
            n_dev = tp * (16 if name == "single" else 32)
            for regime in ("tp", "decode", "fsdp"):
                want = _nested(_as_tuples(J.param_specs(
                    jcfg, jax_axes, tp, regime, n_dev=n_dev)))
                got = shd.param_specs(cfg, axes, tp, regime, n_dev=n_dev)
                assert got == want, (arch, tp, name, regime)
            mesh_batch = n_dev // tp
            for batch in (128, 1):
                want = _nested(_as_tuples(J.cache_specs(
                    jcfg, jax_axes, tp, batch, mesh_batch)))
                assert shd.cache_specs(cfg, axes, tp, batch,
                                       mesh_batch) == want
                for kind in ("train", "prefill", "decode"):
                    want = _as_tuples(J.batch_specs(
                        jcfg, jax_axes, batch, mesh_batch, kind))
                    assert shd.batch_specs(cfg, axes, batch, mesh_batch,
                                           kind) == want, (kind, batch)


def test_opt_state_specs_match_the_reference(memo):
    jcfg, cfg = j_get_config("qwen3_moe_30b"), get_config("qwen3_moe_30b")
    for name, (jax_axes, axes) in AXES.items():
        jsp = J.param_specs(jcfg, jax_axes, 8, "tp")
        for zero1 in (True, False):
            want = _as_tuples(joptim.opt_state_specs(jsp, jax_axes.all,
                                                     zero1))
            got = optim.opt_state_specs(
                shd.param_specs(cfg, axes, 8, "tp"), axes.all, zero1)
            assert got == _nested(want)


class _Rank:
    """A realized mesh's stand-in for one rank of ``sizes`` (no process
    group: ``shard_params`` reads only the shape and the coordinates)."""

    def __init__(self, sizes, rank):
        self.base = mesh_lib.Mesh(("data", "model"), sizes, rank=rank)
        self.shape, self.coords = self.base.shape, self.base.coords


@pytest.mark.parametrize("arch", ["llama3_2_1b", "qwen3_moe_30b"])
@pytest.mark.parametrize("sizes", [(1, 2), (2, 2), (1, 4)])
def test_shard_then_gather_is_the_identity(arch, sizes):
    """Every rank's ``shard_params`` slices, put back by the dim slices
    ``gather_params`` writes them to, give the full tree; a leaf split
    over ``model`` differs between model ranks and not between data
    ranks."""
    cfg = dataclasses.replace(reduced_config(arch), dtype="float32")
    full = TT.init_params(cfg, 0, "cpu")
    tp = sizes[1]
    specs = shd.param_specs(cfg, MeshAxes(), tp, "tp")
    ranks = [_Rank(sizes, r) for r in range(sizes[0] * sizes[1])]
    local = [shd.shard_params(full, specs, r) for r in ranks]
    for path_leaf in _walk(full):
        path, leaf = path_leaf
        sp = _get(specs, path)
        out = torch.full_like(leaf, float("nan"))
        for r, loc in zip(ranks, local):
            sl = shd.dim_slices(sp, leaf.shape, r.shape, r.coords)
            out[sl] = _get(loc, path)
        assert torch.equal(out, leaf), path
        if "model" in sp and tp > 1:
            assert not torch.equal(_get(local[0], path), _get(local[1], path))
    # the one-rank bridge through the process group: a trivial world
    mesh = mesh_lib.Mesh(("data", "model"), (1, 1), rank=0, comm=Comm())
    specs1 = shd.param_specs(cfg, MeshAxes(), 1, "tp")
    back = shd.gather_params(shd.shard_params(full, specs1, mesh), specs1,
                             mesh)
    for (_, a), (_, b) in zip(_walk(back), _walk(full)):
        assert torch.equal(a, b)


def test_kv_heads_of_a_rank_when_the_kv_heads_do_not_split():
    from repro_torch.models import layers
    cfg = get_config("qwen3_moe_30b")            # 32 q heads over 4 kv
    assert [layers.kv_heads_of_rank(cfg, m, 8) for m in range(8)] == \
        [(m // 2, m // 2 + 1) for m in range(8)]
    specs = shd.param_specs(cfg, MeshAxes(), 8, "tp")
    assert specs["layers"]["attn"]["wk"] == (None, None, None, None)
    assert specs["layers"]["attn"]["wq"] == (None, None, "model", None)
    llama = get_config("llama3_2_1b")             # 32 over 8: splits
    assert shd.param_specs(llama, MeshAxes(), 8, "tp")["layers"]["attn"][
        "wk"] == (None, None, "model", None)
    odd = dataclasses.replace(cfg, num_heads=24, num_kv_heads=4)
    with pytest.raises(NotImplementedError, match="whole kv heads"):
        layers.kv_heads_of_rank(odd, 1, 6)      # 4 q heads, groups of 6
    odd = dataclasses.replace(cfg, num_heads=24, num_kv_heads=3)
    assert [layers.kv_heads_of_rank(odd, m, 6) for m in range(6)] == \
        [(0, 1), (0, 1), (1, 2), (1, 2), (2, 3), (2, 3)]


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree
