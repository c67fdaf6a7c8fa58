"""The port's checkpoints held to the JAX package's, in both directions.

The same bf16 weights (reduced ``qwen2_0_5b`` from the JAX
``init_params``; the port's copy from ``params_from_numpy``) are saved by
each package: the files must be the same bytes, and a checkpoint written
by either package must restore in the other to the same bits.  A
sequence pool snapshotted mid-batch by either package's scheduler
(reduced ``llama3_2_1b`` in fp32, the same weights) must be the same
``pool.json`` and must restore in either package, every sequence
completing with the same tokens.
"""
import dataclasses
import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.core.scheduler import CoroutineScheduler as JScheduler
from repro.core.scheduler import SchedulerConfig as JSchedulerConfig
from repro.models import transformer as JT
from repro.runtime import checkpoint as jckpt
from repro.runtime.engine import NodeEngine as JNodeEngine
from repro_torch.configs import reduced_config
from repro_torch.core.scheduler import CoroutineScheduler, SchedulerConfig
from repro_torch.models import transformer as TT
from repro_torch.runtime import checkpoint as tckpt
from repro_torch.runtime.engine import NodeEngine


@pytest.fixture(scope="module")
def weights():
    """(JAX params as numpy, the port's params on the CPU, port config)."""
    jp = jax.tree.map(np.asarray, JT.init_params(j_reduced("qwen2_0_5b"),
                                                 jax.random.PRNGKey(0)))
    cfg = reduced_config("qwen2_0_5b")
    return jp, TT.params_from_numpy(jp, cfg, device="cpu"), cfg


def _bits(x):
    """A leaf's bytes as a flat uint8 array (a tensor, or any package's
    array, bf16 included)."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous().view(torch.uint8) if x.dtype == torch.bfloat16 \
            else x
        return x.numpy().reshape(-1).view(np.uint8)
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in os.listdir(d) if f.endswith(".bin")}


def test_checkpoint_roundtrip(tmp_path, weights):
    jp, tp, cfg = weights
    assert any(v.dtype == torch.bfloat16
               for v in tckpt._flatten(tp).values()), "a bf16 checkpoint"
    tckpt.save(str(tmp_path / "t"), tp, extra={"step": 7})
    jckpt.save(str(tmp_path / "j"), jp, extra={"step": 7})
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    man = [json.load(open(tmp_path / d / "manifest.json"))
           for d in ("t", "j")]
    assert man[0]["manifest"] == man[1]["manifest"]
    assert man[0]["extra"] == man[1]["extra"] == {"step": 7}
    flat, extra = tckpt.restore(str(tmp_path / "t"), mmap=True)
    assert extra["step"] == 7
    assert all(isinstance(a, np.memmap) and not a.flags.writeable
               for a in flat.values())
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # no non-writable-array warning
        restored = tckpt.unflatten_into(TT.param_template(cfg), flat,
                                        device="cpu")
    want = tckpt._flatten(tp)
    got = tckpt._flatten(restored)
    assert got.keys() == want.keys()
    for name, t in want.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t), name


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_restores_in_the_other_package(tmp_path, weights, writer):
    """A bf16 checkpoint written by one package restores in the other to
    the same bits."""
    jp, tp, cfg = weights
    d = str(tmp_path / "c")
    if writer == "jax":
        jckpt.save(d, jp)
        flat, _ = tckpt.restore(d, mmap=True)
        got = tckpt._flatten(tckpt.unflatten_into(TT.param_template(cfg),
                                                  flat, device="cpu"))
    else:
        tckpt.save(d, tp)
        flat, _ = jckpt.restore(d, mmap=True)
        got = jckpt._flatten(jax.tree.map(np.asarray,
                                          jckpt.unflatten_into(jp, flat)))
    want = jckpt._flatten(jp)
    assert got.keys() == want.keys()
    for name, a in want.items():
        assert tuple(got[name].shape) == a.shape, name
        np.testing.assert_array_equal(_bits(got[name]), _bits(a),
                                      err_msg=name)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_checkpoint_restore_detects_corruption(tmp_path, weights, pkg):
    jp, tp, _ = weights
    ck = jckpt if pkg == "jax" else tckpt
    ck.save(str(tmp_path / "c"), jp if pkg == "jax" else tp)
    with open(str(tmp_path / "c" / "manifest.json")) as f:
        name, info = next(iter(json.load(f)["manifest"].items()))
    victim = str(tmp_path / "c" / info["file"])
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) // 2)
    with pytest.raises(ValueError, match=name.split("/")[0]):
        ck.restore(str(tmp_path / "c"))


def test_unflatten_into_refuses_a_leaf_that_does_not_fit(tmp_path, weights):
    _, tp, cfg = weights
    tckpt.save(str(tmp_path / "c"), tp)
    flat, _ = tckpt.restore(str(tmp_path / "c"))
    fp32 = TT.param_template(dataclasses.replace(cfg, dtype="float32"))
    with pytest.raises(ValueError, match="does not fit"):
        tckpt.unflatten_into(fp32, flat, device="cpu")
    name = next(iter(flat))
    flat[name] = flat[name][:1]
    with pytest.raises(ValueError, match="does not fit"):
        tckpt.unflatten_into(TT.param_template(cfg), flat, device="cpu")


# ---------------------------------------------------------------------------
# in-flight pool snapshot
# ---------------------------------------------------------------------------

KW = dict(max_active=2, max_len=64, page_size=8)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """Each package's scheduler snapshotted after two ticks of the same
    batch, on the same fp32 weights; and ``sched(pkg)``, a fresh
    scheduler of that package over one engine with those weights."""
    jcfg = dataclasses.replace(j_reduced("llama3_2_1b"), dtype="float32")
    tcfg = dataclasses.replace(reduced_config("llama3_2_1b"),
                               dtype="float32")
    params = TT.params_from_numpy(
        jax.tree.map(np.asarray, JNodeEngine(jcfg, seed=0, **KW).params),
        tcfg, device="cpu")

    def sched(pkg):
        if pkg == "jax":
            eng = JNodeEngine(jcfg, seed=0, **KW)
            return JScheduler([eng], JSchedulerConfig(page_size=8)), eng
        eng = NodeEngine(tcfg, params=params, device="cpu", **KW)
        return CoroutineScheduler([eng], SchedulerConfig(page_size=8)), eng

    root = tmp_path_factory.mktemp("pools")
    dirs = {}
    for pkg, ck in (("jax", jckpt), ("torch", tckpt)):
        s, eng = sched(pkg)
        s.submit([[2, 3, 4], [5, 6, 7, 8], [9] * 11, [2, 3, 4]], [6] * 4)
        for _ in range(2):
            s._node_tick(0, eng)
        dirs[pkg] = str(root / pkg)
        ck.snapshot_pool(dirs[pkg], s)
    return dirs, sched


def test_pool_snapshot_is_the_jax_snapshot(pools):
    dirs, _ = pools
    pool = [json.load(open(os.path.join(dirs[p], "pool.json")))
            for p in ("torch", "jax")]
    assert pool[0] == pool[1]
    assert len(pool[0]) == 4
    assert any(d["generated"] for d in pool[0]), "snapshot mid-batch"


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_pool_snapshot_restart(pools, writer):
    """Either package's snapshot restores in both; every sequence
    completes, with the same tokens in both packages."""
    dirs, sched = pools
    toks = {}
    for pkg, ck in (("jax", jckpt), ("torch", tckpt)):
        s, _ = sched(pkg)
        assert ck.restore_pool(dirs[writer], s) == 4
        rep = s.run(max_ticks=300)
        assert rep["completed"] == 4
        toks[pkg] = {i: list(c.generated) for i, c in s.cos.items()}
    assert toks["torch"] == toks["jax"]
    assert all(len(t) == 6 for t in toks["torch"].values())
