"""The port's multi-GPU training path in two ``gloo`` processes on the CPU,
held to the JAX package.

Each mesh, (1, 2), (2, 1) and the multi-pod axes' (2, 1, 1) (the data
group flattens pod and data), is one group of two processes
(``tests/torch_dist_worker.py``, ``init_method=file://`` under
``tmp_path``) that runs every case's task and pickles its results; the
group is joined with a deadline and the test fails rather than hangs.
fp32, inputs from ``np.random.default_rng(seed)``, weights from the JAX
package's ``init_params``.  Cases:

- expert parallelism at tp 2 (reduced Qwen3-30B-A3B, 4 experts, top 2,
  capacity factor 0.5, so that choices drop): output, aux and the
  gradients of x, the router and the local experts against
  ``jax.vmap(repro.models.moe._moe_shard_body, axis_name="model")`` over
  the experts split in two stacks; atol 1e-5 (values), 1e-4 (grads);
- one tensor-parallel training layer at tp 2 (reduced Llama-3.2-1B, kv
  heads split; reduced Qwen3-30B-A3B with one kv head, replicated and
  sliced, and its MoE): output and the gradients of h and every leaf
  against ``jax.vjp`` of ``repro.models.transformer._layer_fwd``;
- the vocab-parallel cross-entropy at tp 2 (S 1024, two chunks, labels
  -1 among them): value (rtol 1e-6) and the gradients of h and
  ``lm_head`` against JAX's ``_chunked_ce``;
- ZeRO-1 over two ranks, on each mesh: three ``apply_updates`` against
  ``repro.optim.apply_updates(n_dev=2)``: grad norms, gathered
  parameters and gathered master, m and v (unpadded) to atol 1e-6;
- ``build_cell``'s sharded ``train_step``, reduced Llama-3.2-1B and
  Qwen3-30B-A3B, two steps on (1, 2) and (2, 1), Qwen3-30B-A3B also on
  (2, 1, 1) (Llama at (2, 1) in two microbatches): losses (rtol 1e-5), grad norms (rtol 1e-4), gathered
  parameters and optimizer state after each step (m and v to atol 2e-6,
  rtol 1e-4; parameters and masters to that plus 1e-2 lr a step, and an
  element whose gradient's RMS is below 1e-4 to lr a step:
  ``_check_state``) against
  ``jax.value_and_grad(forward_loss)`` and ``apply_updates(n_dev=2)``;
  at data 2 the reference's MoE is its shard_map body on each data
  shard (capacity and aux per shard, the aux averaged: its ``pmean``);
- the collective stats of each step: the all-reduces the design
  predicts (below), one reduce-scatter a leaf over the data group, one
  all-gather a replicated leaf over the world or a leaf over the data
  group.

In one process (no group): ``_moe_shard_body`` at tp 1 is ``_moe_local``
bit for bit, and ``build_cell``'s step on a (1, 1) mesh gives the
one-device ``train_step``'s losses, grad norms and parameters bit for
bit.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import reduced_config as j_reduced
from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro.models.api import MeshAxes as JAxes
from repro_torch import optim
from repro_torch.configs import reduced_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import moe
from repro_torch.models import transformer as TT
from repro_torch.models.api import MeshAxes

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_dist_worker.py"
JOIN_S = 240.0
AX = JAxes()
OCFG = dict(lr=1e-3, max_grad_norm=1.0)
OCFG_B2 = 0.95


def _cfgs(arch, **over):
    return (dataclasses.replace(j_reduced(arch), dtype="float32", **over),
            dataclasses.replace(reduced_config(arch), dtype="float32",
                                **over))


def _np_params(jcfg, seed=0):
    return jax.tree.map(np.asarray,
                        JT.init_params(jcfg, jax.random.PRNGKey(seed)))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def run_groups(tmp_path: Path, groups, timeout: float = JOIN_S):
    """Each ``(sizes, jobs)`` of ``groups`` in a group of prod(sizes)
    worker processes, all groups at once; returns each group's per-rank
    results.  Polls the processes with a deadline and kills them all when
    it passes."""
    return join_groups(start_groups(tmp_path, groups), timeout)


def start_groups(tmp_path: Path, groups):
    """``run_groups``' processes started; ``join_groups`` waits for them
    (the caller may work meanwhile)."""
    procs, logs, names = [], [], []
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    for sizes, jobs in groups:
        world = int(np.prod(sizes))
        tag = "x".join(map(str, sizes))
        inp = tmp_path / f"in_{tag}.pkl"
        with open(inp, "wb") as f:
            pickle.dump(jobs, f)
        for r in range(world):
            names.append((tag, r))
            log = open(tmp_path / f"log_{tag}_{r}.txt", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, str(WORKER), str(r), str(world),
                 ",".join(map(str, sizes)), str(tmp_path / f"init_{tag}"),
                 str(inp), str(tmp_path / f"out_{tag}_{r}.pkl")],
                env=env, stdout=log, stderr=subprocess.STDOUT))
    return tmp_path, groups, procs, logs, names, time.monotonic()


def join_groups(started, timeout: float = JOIN_S):
    """The results of ``start_groups``' processes, as ``run_groups``
    returns them; the deadline counts from their start."""
    tmp_path, groups, procs, logs, names, t0 = started
    deadline = t0 + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                raise AssertionError(f"the groups did not finish within "
                                     f"{timeout} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    codes = [p.returncode for p in procs]
    if any(codes):
        text = "\n".join(f"-- {tag} rank {r}:\n" + (
            tmp_path / f"log_{tag}_{r}.txt").read_text()[-3000:]
            for tag, r in names)
        raise AssertionError(f"the groups exited {codes}:\n{text}")
    out = {}
    for tag, r in names:
        with open(tmp_path / f"out_{tag}_{r}.pkl", "rb") as f:
            out.setdefault(tag, []).append(pickle.load(f))
    return [out["x".join(map(str, sizes))] for sizes, _ in groups]


# ---------------------------------------------------------------- inputs

MOE_OVER = dict(capacity_factor=0.5)
KV1 = dict(num_kv_heads=1)


def _moe_inputs():
    jcfg, _ = _cfgs("qwen3_moe_30b", **MOE_OVER)
    rng = np.random.default_rng(11)
    D, E, F = jcfg.d_model, jcfg.num_experts, jcfg.moe_d_ff
    p = {"wg": rng.standard_normal((D, E)).astype(np.float32) / D ** 0.5,
         "w1": rng.standard_normal((E, D, F)).astype(np.float32) / D ** 0.5,
         "w3": rng.standard_normal((E, D, F)).astype(np.float32) / D ** 0.5,
         "w2": rng.standard_normal((E, F, D)).astype(np.float32) / F ** 0.5}
    x = rng.standard_normal((2, 16, D)).astype(np.float32)
    g = rng.standard_normal((2, 16, D)).astype(np.float32)
    return dict(task="moe", arch="qwen3_moe_30b", over=MOE_OVER, p=p, x=x,
                g=g)


def _layer_inputs(arch, over):
    jcfg, _ = _cfgs(arch, **over)
    rng = np.random.default_rng(12)
    layers = jax.tree.map(lambda a: a[:1], _np_params(jcfg, 3)["layers"])
    h = rng.standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    g = rng.standard_normal(h.shape).astype(np.float32)
    return dict(task="layer", arch=arch, over=over,
                p=jax.tree.map(np.asarray, layers), h=h, g=g)


def _ce_inputs():
    jcfg, _ = _cfgs("llama3_2_1b")
    rng = np.random.default_rng(13)
    V = JT.padded_vocab(jcfg)
    W = rng.standard_normal((jcfg.d_model, V)).astype(np.float32) * 0.1
    h = rng.standard_normal((1, 1024, jcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, jcfg.vocab_size, (1, 1024)).astype(np.int32)
    labels[0, ::7] = -1
    return dict(task="ce", arch="llama3_2_1b", lm_head=W, h=h,
                labels=labels)


def _zero_inputs():
    jcfg, _ = _cfgs("llama3_2_1b")
    npp = _np_params(jcfg)
    grads = []
    for i in range(3):
        rng = np.random.default_rng(20 + i)
        grads.append(jax.tree.map(
            lambda a: (rng.standard_normal(a.shape) * 0.05)
            .astype(np.float32), npp))
    return dict(task="zero", arch="llama3_2_1b", params=npp, grads=grads,
                ocfg=OCFG)


TRAIN = {("llama3_2_1b", 1): 1, ("llama3_2_1b", 2): 2,
         ("qwen3_moe_30b", 1): 1, ("qwen3_moe_30b", 2): 1}


def _train_inputs(arch, data):
    jcfg, _ = _cfgs(arch)
    rng = np.random.default_rng(30)
    B, S = 4, 32
    toks = [rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
            for _ in range(2)]
    labels = [t.copy() for t in toks]
    labels[0][:, :3] = -1
    return dict(task="train", arch=arch, params=_np_params(jcfg, 5),
                tokens=toks, labels=labels, ocfg=OCFG,
                microbatches=TRAIN[(arch, data)])


MESHES = {(1, 2): lambda: [_moe_inputs(), _layer_inputs("llama3_2_1b", {}),
                           _layer_inputs("qwen3_moe_30b", KV1),
                           _ce_inputs(), _zero_inputs(),
                           _train_inputs("llama3_2_1b", 1),
                           _train_inputs("qwen3_moe_30b", 1)],
          (2, 1): lambda: [_zero_inputs(), _train_inputs("llama3_2_1b", 2),
                           _train_inputs("qwen3_moe_30b", 2)],
          # the multi-pod axes: the data group flattens (pod, data)
          (2, 1, 1): lambda: [_zero_inputs(),
                              _train_inputs("qwen3_moe_30b", 2)]}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's torch work on one intra-op thread (its tensors are
    tiny; many threads on them, beside the suite's other workers, only
    contend), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Both meshes' inputs and every rank's results, run once."""
    groups = [(sizes, make()) for sizes, make in MESHES.items()]
    res = run_groups(tmp_path_factory.mktemp("groups"), groups)
    return {sizes: (jobs, r) for (sizes, jobs), r in zip(groups, res)}


def _job(groups, sizes, task, arch=None, over=None):
    jobs, res = groups[sizes]
    for i, job in enumerate(jobs):
        if job["task"] == task and (arch is None or job["arch"] == arch) \
                and (over is None or job.get("over") == over):
            return job, [r[i] for r in res]
    raise KeyError((sizes, task, arch))


# ---------------------------------------------------------------- EP

def test_expert_parallel_moe_matches_the_shard_body_under_vmap(groups):
    job, res = _job(groups, (1, 2), "moe")
    jcfg, _ = _cfgs("qwen3_moe_30b", **MOE_OVER)
    tp, E = 2, jcfg.num_experts
    p = {k: jnp.asarray(v) for k, v in job["p"].items()}

    def f(x, wg, w1, w3, w2):
        split = lambda w: w.reshape((tp, E // tp) + w.shape[1:])
        y, aux = jax.vmap(
            lambda a, b, c: jmoe._moe_shard_body(jcfg, "model", x, wg, a, b,
                                                 c, ("model",)),
            axis_name="model")(split(w1), split(w3), split(w2))
        return y[0], aux[0]

    g = jnp.asarray(job["g"])

    def loss(*a):
        y, aux = f(*a)
        return jnp.sum(y * g) + aux, (y, aux)

    (_, (y, aux)), want = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(
        jnp.asarray(job["x"]), p["wg"], p["w1"], p["w3"], p["w2"])
    # the capacity binds: some choices drop
    T = job["x"].shape[0] * job["x"].shape[1]
    assert moe.expert_capacity(reduced_config("qwen3_moe_30b"), T) * E < \
        T * jcfg.experts_per_token or MOE_OVER["capacity_factor"] < 1
    El = E // tp
    for m, r in enumerate(res):
        _close(r["y"], y, atol=1e-5, rtol=1e-5)
        _close(r["aux"], aux, atol=1e-6, rtol=1e-6)
        dx, dwg, dw1, dw3, dw2 = r["grads"]
        _close(dx, want[0], atol=1e-4, rtol=1e-4)
        _close(dwg, want[1], atol=1e-4, rtol=1e-4)
        for got, w in zip((dw1, dw3, dw2), want[2:]):
            _close(got, w[m * El:(m + 1) * El], atol=1e-4, rtol=1e-4)


def test_moe_shard_body_at_tp_1_is_moe_local_bit_for_bit():
    _, cfg = _cfgs("qwen3_moe_30b", **MOE_OVER)
    job = _moe_inputs()
    p = {k: torch.from_numpy(v) for k, v in job["p"].items()}
    x = torch.from_numpy(job["x"])
    y1, a1 = moe._moe_shard_body(cfg, p, x, 0, 1)
    y0, a0 = moe._moe_local(cfg, p, x)
    assert torch.equal(y1, y0) and torch.equal(a1, a0)
    # and the two halves' partials sum to it (fp32 sums of two terms)
    halves = [moe._moe_shard_body(
        cfg, dict(p, **{k: p[k][m * 2:(m + 1) * 2] for k in
                        ("w1", "w3", "w2")}), x, m, 2) for m in (0, 1)]
    _close(halves[0][0] + halves[1][0], y0, atol=1e-6, rtol=1e-6)
    _close(halves[0][1] + halves[1][1], a0, atol=1e-7, rtol=1e-6)


# ---------------------------------------------------------------- TP

@pytest.mark.parametrize("arch,over", [("llama3_2_1b", {}),
                                       ("qwen3_moe_30b", KV1)],
                         ids=["llama_kv_split", "qwen3_kv_replicated"])
def test_tensor_parallel_layer_matches_jax(groups, arch, over):
    job, res = _job(groups, (1, 2), "layer", arch)
    jcfg, cfg = _cfgs(arch, **over)
    p = jax.tree.map(lambda a: jnp.asarray(a[0]), job["p"])
    h = jnp.asarray(job["h"])
    S = h.shape[1]
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), h.shape[:2])

    g = jnp.asarray(job["g"])

    def loss(p, h):
        out, aux, _ = JT._layer_fwd(jcfg, AX, p, h, pos, None, False)
        return jnp.sum(out * g) + aux, out

    (_, out), (gp, gh) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(p, h)
    specs = shd.param_specs(cfg, MeshAxes(), 2, "tp")["layers"]
    paths = [path for path, _ in _walk(specs)]
    full = {path: np.zeros((1,) + np.shape(_get(gp, path)), np.float32)
            for path in paths}
    for m, r in enumerate(res):
        _close(r["out"], out, atol=1e-5, rtol=1e-5)
        _close(r["dh"], gh, atol=1e-4, rtol=1e-4)
        coords = {"data": 0, "model": m}
        for path, g in zip(paths, r["grads"]):
            sl = shd.dim_slices(_get(specs, path), full[path].shape,
                                {"data": 1, "model": 2}, coords)
            full[path][sl] = g
    for path in paths:
        _close(full[path][0], _get(gp, path), atol=1e-4, rtol=1e-4)


def test_vocab_parallel_cross_entropy_matches_jax(groups):
    job, res = _job(groups, (1, 2), "ce")
    jcfg, _ = _cfgs("llama3_2_1b")
    (loss, (gh, gw)) = jax.value_and_grad(
        lambda h, w: JT._chunked_ce(jcfg, {"lm_head": w}, h,
                                    jnp.asarray(job["labels"])),
        argnums=(0, 1))(jnp.asarray(job["h"]), jnp.asarray(job["lm_head"]))
    Vl = job["lm_head"].shape[1] // 2
    for m, r in enumerate(res):
        _close(r["loss"], loss, rtol=1e-6, atol=0)
        _close(r["dh"], gh, atol=1e-6, rtol=1e-5)
        _close(r["dw"], gw[:, m * Vl:(m + 1) * Vl], atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------- ZeRO-1

def _check_state(got, params, opt, atol=1e-6, rtol=0.0, lr=None):
    """Gathered parameters and optimizer state against the reference's.
    With ``lr``, a parameter (and master) element may differ by a
    hundredth of the update, 1e-2 lr a step, beside ``atol``: AdamW's
    step lr m / (sqrt(v) + eps) carries the gradients' relative
    differences with a factor of order one from the second step on; and
    one whose gradient's RMS (sqrt(v / (1 - b2^t))) is below 1e-4 by the
    whole update, lr a step: the summation order moves a gradient element
    by ~1e-7 absolute, which is more than 1e-3 of such a one."""
    gp, gst = got
    t = int(opt["step"])
    b2c = 1.0 - OCFG_B2 ** t

    def loose(path):
        v = np.asarray(_get(opt["leaves"], path)["v"])
        n = int(np.prod(np.shape(_get(params, path))))
        return np.sqrt(v[:n] / b2c) < 1e-4

    def cmp(a, b, path):
        a, b = np.asarray(a).reshape(-1), np.asarray(b).reshape(-1)
        if lr is None or t == 0:
            _close(a, b, atol=atol, rtol=rtol)
            return
        lo = loose(path)
        _close(a[~lo], b[~lo], atol=atol + 1e-2 * lr * t, rtol=rtol)
        _close(a[lo], b[lo], atol=lr * t, rtol=0)

    for (path, x) in _walk(gp):
        cmp(x, _get(params, path), path)
    for (path, st) in _walk(gst["leaves"], stop="master"):
        want = _get(opt["leaves"], path)
        n = int(np.prod(st["master"].shape))
        cmp(st["master"], np.asarray(want["master"])[:n], path)
        for k in ("m", "v"):
            _close(st[k].reshape(-1), np.asarray(want[k])[:n], atol=atol,
                   rtol=rtol)
        assert np.asarray(want["master"]).size % 2 == 0   # padded to n_dev
    assert gst["step"] == t


@pytest.mark.parametrize("sizes", [(1, 2), (2, 1), (2, 1, 1)],
                         ids=["model2", "data2", "pod2"])
def test_zero1_matches_apply_updates_over_two_devices(groups, sizes):
    job, res = _job(groups, sizes, "zero")
    ocfg = joptim.AdamWConfig(**OCFG)
    params = jax.tree.map(jnp.asarray, job["params"])
    opt = joptim.init_opt_state(params, 2)
    update = jax.jit(lambda p, g, o: joptim.apply_updates(ocfg, p, g, o, 2))
    for r in res:
        _check_state(r["init"], params, opt)
    for i, g in enumerate(job["grads"]):
        params, opt, gn = update(params, jax.tree.map(jnp.asarray, g), opt)
        for r in res:
            got_gn, state = r["steps"][i]
            _close(got_gn, gn, rtol=1e-6, atol=0)
            _check_state(state, params, opt)


# ---------------------------------------------------------------- train

def _jax_moe_per_data_shard(d):
    """The reference's MoE on a (d, 1) mesh: its shard_map body on each
    data shard of x (at tp 1 that is ``_moe_local``), the aux averaged."""
    def moe_fwd(cfg, axes, p, x):
        xs = x.reshape((d, x.shape[0] // d) + x.shape[1:])
        ys, auxes = jax.vmap(lambda xl: jmoe._moe_local(cfg, p, xl))(xs)
        y = ys.reshape(x.shape)
        if cfg.num_shared_experts > 0:
            y = y + JT.layers.mlp_fwd(cfg, p["shared"], x)
        return y, jnp.mean(auxes)
    return moe_fwd


@pytest.mark.parametrize("arch,sizes", [
    ("llama3_2_1b", (1, 2)), ("llama3_2_1b", (2, 1)),
    ("qwen3_moe_30b", (1, 2)), ("qwen3_moe_30b", (2, 1)),
    ("qwen3_moe_30b", (2, 1, 1))],
    ids=["llama-model2", "llama-data2", "qwen3-model2", "qwen3-data2",
         "qwen3-pod2"])
def test_sharded_train_step_matches_jax(groups, sizes, arch, monkeypatch):
    job, res = _job(groups, sizes, "train", arch)
    jcfg, _ = _cfgs(arch)
    data = int(np.prod(sizes[:-1]))
    if jcfg.is_moe and data > 1:
        monkeypatch.setattr(jmoe, "moe_fwd", _jax_moe_per_data_shard(data))
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.forward_loss(jcfg, AX, p, b, remat=True)))
    ocfg = joptim.AdamWConfig(**OCFG)
    update = jax.jit(lambda p, g, o: joptim.apply_updates(ocfg, p, g, o, 2))
    params = jax.tree.map(jnp.asarray, job["params"])
    opt = joptim.init_opt_state(params, 2)
    n_mb = job["microbatches"]
    assert all(r["microbatches"] == n_mb for r in res)
    for i, (toks, labels) in enumerate(zip(job["tokens"], job["labels"])):
        b = toks.shape[0] // n_mb
        loss, gacc = 0.0, None
        for j in range(n_mb):
            mb = {"tokens": jnp.asarray(toks[j * b:(j + 1) * b]),
                  "labels": jnp.asarray(labels[j * b:(j + 1) * b])}
            l, g = vg(params, mb)
            gacc = g if gacc is None else jax.tree.map(jnp.add, gacc, g)
            loss = loss + l
        grads = jax.tree.map(lambda x: x / n_mb, gacc)
        params, opt, gn = update(params, grads, opt)
        for r in res:
            got_loss, got_gn, _, state = r["steps"][i]
            _close(got_loss, loss / n_mb, rtol=1e-5, atol=0)
            _close(got_gn, gn, rtol=1e-4, atol=0)
            _check_state(state, params, opt, atol=2e-6, rtol=1e-4,
                         lr=OCFG["lr"])


def _n_leaves(tree):
    return len(list(_walk(tree)))


@pytest.mark.parametrize("arch,sizes", [
    ("llama3_2_1b", (1, 2)), ("llama3_2_1b", (2, 1)),
    ("qwen3_moe_30b", (1, 2)), ("qwen3_moe_30b", (2, 1)),
    ("qwen3_moe_30b", (2, 1, 1))],
    ids=["llama-model2", "llama-data2", "qwen3-model2", "qwen3-data2",
         "qwen3-pod2"])
def test_collective_stats_of_the_sharded_step(groups, sizes, arch):
    job, res = _job(groups, sizes, "train", arch)
    _, cfg = _cfgs(arch)
    specs = shd.param_specs(cfg, MeshAxes(), sizes[-1], "tp")
    leaves = list(_walk(specs))
    n_mb = job["microbatches"]
    chunks = -(-job["tokens"][0].shape[1] // TT.CE_CHUNK)
    split = sum("model" in sp for _, sp in leaves)
    # the dry run's accounting of the design, held here to what the ranks
    # send: at (1, 2) the model group's all-reduces (the embedding, each
    # layer's and each cross-entropy chunk's) and the grad norm, and the
    # world's gathers of the replicated leaves (the model-split ones stay
    # whole on their rank, a data group of one); over data ranks the
    # count of valid labels a microbatch, the loss and the grad norm, one
    # reduce-scatter and one gather a leaf (the (pod, data) group of the
    # multi-pod axes alike)
    want = dryrun.design_collectives(
        cfg, "train", sizes[-1], int(np.prod(sizes[:-1])), n_mb,
        job["tokens"][0].shape[1], len(leaves), split * (sizes[-1] > 1))
    if sizes == (1, 2):
        kind = "moe" if cfg.is_moe else "dense"
        assert want["all-reduce"] == n_mb * (
            1 + cfg.num_layers * dryrun.AR_LAYER[kind]
            + chunks * dryrun.AR_CE_CHUNK) + 1
    else:
        assert want == {"all-reduce": n_mb + 2,
                        "reduce-scatter": len(leaves),
                        "all-gather": len(leaves)}
    for r in res:
        for _, _, stats, _ in r["steps"]:
            c = stats["counts"]
            assert c == want, (sizes, arch, c, want)
            if sizes[-1] == 1:
                padded = sum(-(-int(np.prod(_get(job["params"], path).shape))
                               // 2) * 4 for path, _ in leaves)
                assert stats["raw_bytes"]["reduce-scatter"] == padded
                assert stats["wire_bytes"]["reduce-scatter"] == padded


def test_sharded_step_on_one_rank_is_the_one_device_step_bit_for_bit():
    """``build_cell``'s step over a (1, 1) mesh (every group of one, every
    collective skipped, ZeRO-1 on) against ``train_step`` on one device:
    equal losses, grad norms and parameters, bit for bit."""
    for arch, n_mb in (("qwen3_moe_30b", 1), ("llama3_2_1b", 2)):
        _, cfg = _cfgs(arch)
        over = {f.name: getattr(cfg, f.name)
                for f in dataclasses.fields(cfg)}
        mesh = mesh_lib.Mesh(("data", "model"), (1, 1), rank=0)
        cell = steps.build_cell(arch, "train_4k", mesh, batch_seq=(4, 32),
                                over=over, exact_microbatches=n_mb,
                                opt_cfg=optim.AdamWConfig(lr=1e-3))
        p1, o1 = cell.init_state(0, "cpu")
        p0 = TT.init_params(cfg, 0, "cpu")
        o0 = optim.init_opt_state(p0)
        job = _train_inputs(arch, 1)
        for toks, labels in zip(job["tokens"], job["labels"]):
            batch = {"tokens": torch.from_numpy(toks),
                     "labels": torch.from_numpy(labels)}
            a = cell.step(p1, o1, batch)
            b = steps.train_step(cfg, p0, o0, batch,
                                 optim.AdamWConfig(lr=1e-3, zero1=False),
                                 microbatches=n_mb)
            assert torch.equal(a["loss"], b["loss"])
            assert torch.equal(a["grad_norm"], b["grad_norm"])
        for (_, x), (_, y) in zip(_walk(p1), _walk(p0)):
            assert torch.equal(x, y)


def test_refusals():
    mesh = mesh_lib.make_test_mesh(1, 2)
    # the SSM, RG-LRU and encoder-decoder train and serve over the model
    # group, their channels split; where a rule would leave a part
    # replicated, the cell refuses, naming it
    for arch in ("recurrentgemma_2b", "mamba2_370m", "whisper_base"):
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            steps.build_cell(arch, shape, mesh)
    assert "channel TP" in steps.build_cell("mamba2_370m", "train_4k",
                                            mesh).note
    for arch, over, tp, what in (
            ("mamba2_370m", dict(ssm_groups=2), 2, "SSM channels"),
            ("recurrentgemma_2b", None, 32, "RG-LRU gate blocks"),
            ("whisper_base", dict(d_ff=2049), 2, "replicated MLP")):
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            with pytest.raises(NotImplementedError, match=what):
                steps.build_cell(arch, shape, mesh_lib.make_test_mesh(1, tp),
                                 over=over)
    assert steps.build_cell("smollm_360m", "train_4k", mesh).note == \
        "attention=seq"
    for arch in ("deepseek_r1", "pixtral_12b"):
        assert steps.build_cell(arch, "train_4k", mesh).note.startswith(
            "attention=heads")
    # MLA has no seq mode: q heads that do not split refuse
    with pytest.raises(NotImplementedError, match="MLA q heads"):
        steps.build_cell("deepseek_r1", "train_4k", mesh_lib.make_test_mesh(
            1, 3), over=dict(num_heads=4, vocab_size=129264))
    # fsdp takes every family; no other regime exists
    assert steps.build_cell("mamba2_370m", "train_4k", mesh,
                            train_regime="fsdp").regime == "fsdp"
    with pytest.raises(ValueError, match="train_regime"):
        steps.build_cell("llama3_2_1b", "train_4k", mesh,
                         train_regime="zero2")
    with pytest.raises(ValueError, match="abstract"):
        steps.build_cell("llama3_2_1b", "train_4k", mesh).comm
    # ZeRO-1 needs the specs, a comm of its size, and zero1
    _, cfg = _cfgs("llama3_2_1b")
    p = TT.init_params(cfg, 0, "cpu")
    with pytest.raises(ValueError, match="comm spans"):
        optim.init_opt_state(p, 2)


def _walk(tree, path=(), stop=None):
    if isinstance(tree, dict) and (stop is None or stop not in tree):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,), stop)
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree
