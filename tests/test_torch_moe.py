"""The port's MoE path, held to the JAX package on the CPU: the grouped
GEMM's plain version, the dispatch, ``moe_ffn``, the capacity-bounded MoE
layer and the Algorithm-1 module runtime.

Inputs are made with numpy from each test's own seed; weights come from
the JAX package's initialisers and reach the port as numpy.  Everything
runs in fp32.  The JAX kernels run in interpret mode, as the JAX
package's own tests run them.  Tolerances: 1e-5 absolute for one grouped
GEMM (fp32 summation order), atol 1e-5 / rtol 1e-4 for a whole MoE layer
(three GEMMs and the weighted sum); tokens and keep masks exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.core.forward import ModuleRuntime as JModuleRuntime
from repro.kernels.moe_gemm.moe_gemm import (grouped_gemm_tpu,
                                             sort_tokens_by_expert as j_sort)
from repro.kernels.moe_gemm.ops import moe_ffn as j_moe_ffn
from repro.kernels.moe_gemm.ref import ref_moe_ffn
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.api import MeshAxes
from repro_torch.configs import reduced_config
from repro_torch.core.forward import ModuleRuntime, _sub_slices
from repro_torch.kernels.moe_gemm import ops
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT

AXES = MeshAxes()
GEMM_TOL = dict(atol=1e-5, rtol=1e-5)
LAYER_TOL = dict(atol=1e-5, rtol=1e-4)


def _cfgs(arch="qwen3_moe_30b", **over):
    return (dataclasses.replace(j_reduced(arch), dtype="float32", **over),
            dataclasses.replace(reduced_config(arch), dtype="float32",
                                **over))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else _t(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("T,D,F,E", [(256, 64, 128, 4), (512, 32, 256, 8),
                                     (128, 128, 64, 2)])
def test_grouped_gemm_plain_matches_tpu_kernel(T, D, F, E):
    r = np.random.default_rng(T + D)
    x = r.standard_normal((T, D)).astype(np.float32)
    w = (r.standard_normal((E, D, F)) * 0.1).astype(np.float32)
    be = r.integers(0, E, T // 128).astype(np.int32)
    want = grouped_gemm_tpu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(be),
                            block_t=128, interpret=True)
    got = ops.grouped_gemm(_t(x), _t(w), _t(be), block_t=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEMM_TOL)


def test_grouped_gemm_plain_skips_unused_blocks():
    """Blocks marked -1 give zero rows; the others are the reference's,
    at block_t 16 and a ragged F."""
    r = np.random.default_rng(1)
    T, D, F, E, bt = 96, 48, 40, 3, 16
    x = r.standard_normal((T, D)).astype(np.float32)
    w = r.standard_normal((E, D, F)).astype(np.float32)
    be = np.array([2, 0, -1, 1, -1, -1], np.int32)
    got = ops.grouped_gemm_plain(_t(x), _t(w), _t(be), block_t=bt).numpy()
    want = np.asarray(grouped_gemm_tpu(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(np.maximum(be, 0)),
        block_t=bt, block_f=F, interpret=True))
    for i, e in enumerate(be):
        rows = slice(i * bt, (i + 1) * bt)
        if e < 0:
            assert not got[rows].any()
        else:
            np.testing.assert_allclose(got[rows], want[rows], **GEMM_TOL)


def test_sort_tokens_by_expert_matches_reference():
    """Sorted rows, slots, order and validity as the reference's; its
    block map on the used blocks, and -1 on the unused trailing ones."""
    r = np.random.default_rng(2)
    N, D, E, bt = 50, 8, 4, 16
    x = r.standard_normal((N, D)).astype(np.float32)
    ids = r.integers(0, E, N).astype(np.int32)
    ids[ids == 3] = 2                        # an expert with no rows
    want = [np.asarray(a) for a in j_sort(jnp.asarray(x), jnp.asarray(ids),
                                          E, block_t=bt)]
    got = [a.numpy() for a in ops.sort_tokens_by_expert(_t(x), _t(ids), E,
                                                        block_t=bt)]
    for i in (0, 2, 3, 4):                   # x_sorted, slot_of, order, valid
        np.testing.assert_array_equal(got[i], want[i])
    used = int(sum(-(-np.sum(ids == e) // bt) for e in range(E)))
    np.testing.assert_array_equal(got[1][:used], want[1][:used])
    assert (got[1][used:] == -1).all() and len(got[1]) == len(want[1])


@pytest.mark.parametrize("T,D,F,E,k", [(64, 32, 64, 4, 2),
                                       (96, 64, 256, 16, 4)])
def test_moe_ffn_matches_reference(T, D, F, E, k):
    r = np.random.default_rng(T * k)
    x = r.standard_normal((T, D)).astype(np.float32)
    ids = np.stack([r.permutation(E)[:k] for _ in range(T)]).astype(np.int32)
    vals = r.random((T, k)).astype(np.float32)
    ws = [(r.standard_normal(s) * 0.1).astype(np.float32)
          for s in ((E, D, F), (E, D, F), (E, F, D))]
    got = ops.moe_ffn(_t(x), _t(ids), _t(vals), *map(_t, ws),
                      num_experts=E).numpy()
    jargs = [jnp.asarray(a) for a in (x, ids, vals, *ws)]
    want = np.asarray(j_moe_ffn(*jargs, num_experts=E, interpret=True))
    np.testing.assert_allclose(got, want, **LAYER_TOL)
    np.testing.assert_allclose(got, np.asarray(ref_moe_ffn(*jargs)),
                               **LAYER_TOL)


def _moe_params(jcfg, seed):
    return _np_tree(JM.init_moe(jcfg, jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_moe_local_matches_with_capacity_drops(act):
    """Reduced qwen3 at capacity factor 0.5: C = 16 slots against ~32
    choices per expert for T = 64 tokens, so many choices drop.  Outputs
    to atol 1e-5 / rtol 1e-4, the routing and the keep mask exactly."""
    jcfg, tcfg = _cfgs(capacity_factor=0.5, act=act)
    np_p = _moe_params(jcfg, 3)
    x = np.random.default_rng(4).standard_normal(
        (4, 16, jcfg.d_model)).astype(np.float32)
    T, E = 64, jcfg.num_experts
    assert TM.expert_capacity(tcfg, T) == JM.expert_capacity(jcfg, T) == 16
    jp = jax.tree.map(jnp.asarray, np_p)
    want, jaux = JM._moe_local(jcfg, jp, jnp.asarray(x))
    tp = _torch_tree(np_p)
    got, taux = TM._moe_local(tcfg, tp, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-5)
    _, ids, _ = JM._route(jcfg, jp["wg"], jnp.asarray(x).reshape(T, -1))
    _, tids, _ = TM._route(tcfg, tp["wg"], _t(x).reshape(T, -1))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(ids))
    # the plan _moe_local builds from these ids
    plan = ops.dispatch_plan(tids, E, ops.pick_block_t(T * 2, E),
                             capacity=16)
    oh = np.eye(E, dtype=np.int64)[np.asarray(ids).reshape(-1)]
    rank = ((np.cumsum(oh, 0) - 1) * oh).sum(-1)
    np.testing.assert_array_equal(plan.keep.numpy(), rank < 16)
    assert (rank >= 16).sum() > 0


def test_moe_fwd_with_a_shared_expert_and_the_oracle_match():
    jcfg, tcfg = _cfgs(num_shared_experts=1, shared_d_ff=48)
    np_p = _moe_params(jcfg, 5)
    assert np_p["shared"]["w1"].shape == (jcfg.d_model, 48)
    x = np.random.default_rng(6).standard_normal(
        (2, 5, jcfg.d_model)).astype(np.float32)
    jp, tp = jax.tree.map(jnp.asarray, np_p), _torch_tree(np_p)
    want, _ = JM.moe_fwd(jcfg, AXES, jp, jnp.asarray(x))
    got, _ = TM.moe_fwd(tcfg, tp, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    np.testing.assert_allclose(TM.moe_ref(tcfg, tp, _t(x)).numpy(),
                               np.asarray(JM.moe_ref(jcfg, jp,
                                                     jnp.asarray(x))),
                               **LAYER_TOL)


def _model(seed=0):
    jcfg, tcfg = _cfgs()
    np_params = _np_tree(JT.init_params(jcfg, jax.random.PRNGKey(seed)))
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, np_params),
            TT.params_from_numpy(np_params, tcfg, device="cpu"))


def _caches(tcfg, B, S, seed):
    """A random (L, B, S, Hkv, dh) cache, as numpy and as two torch copies
    (the port writes its caches in place)."""
    shape = (tcfg.num_layers, B, S, tcfg.num_kv_heads, tcfg.head_dim)
    r = np.random.default_rng(seed)
    c = {n: r.standard_normal(shape).astype(np.float32) for n in ("k", "v")}
    return c, {n: _t(a) for n, a in c.items()}, {n: _t(a) for n, a in
                                                  c.items()}


def test_module_runtime_decode_matches_jax_and_monolithic():
    """B=5, b_attn=2: sub-batches of 2 and 3 rows.  Tokens equal the JAX
    ModuleRuntime's and the port's monolithic step's; caches to 1e-5; one
    yield per attention sub-batch and one per FFN in each layer."""
    jcfg, tcfg, jparams, tparams = _model()
    B, S = 5, 32
    r = np.random.default_rng(7)
    toks = r.integers(2, jcfg.vocab_size, B).astype(np.int32)
    lens = r.integers(1, 16, B).astype(np.int32)
    c_np, c_mod, c_mono = _caches(tcfg, B, S, 8)
    jrt = JModuleRuntime(jcfg, AXES, jparams)
    jn, jc = jrt.forward_decode(jnp.asarray(toks), jax.tree.map(
        jnp.asarray, c_np), jnp.asarray(lens), b_attn=2)
    rt = ModuleRuntime(tcfg, tparams)
    yields = []
    tn, tc = rt.forward_decode(_t(toks), c_mod, _t(lens), b_attn=2,
                               on_yield=lambda *a: yields.append(a))
    mn, mc = TT.decode_step(tcfg, tparams, c_mono, _t(toks), _t(lens))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tn.numpy(), mn.numpy())
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(tc[name].numpy(), mc[name].numpy(),
                                   atol=1e-5, rtol=1e-5)
    n_sub = len(_sub_slices(B, B // 2))
    assert n_sub == 2 and len(yields) == tcfg.num_layers * (n_sub + 1)
    assert [t.batch for t in rt.traces[:3]] == [2, 3, 5]
    # COMBINE: the expert batch of two sub-batches is twice one's
    assert rt.expert_load(4)["per_expert"] == \
        2 * rt.expert_load(2)["per_expert"]


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_forward_decode_page_matches_jax_and_monolithic(sampled):
    """Two pages of 8 steps with b_attn=2 over 4 slots (one finishing
    mid-page, one never live): token blocks, lengths and countdowns equal
    the JAX ModuleRuntime's page and the port's monolithic page."""
    from repro import sampling as JS
    from repro_torch import sampling as TS

    jcfg, tcfg, jparams, tparams = _model(1)
    B, S0, S, P = 4, 8, 64, 8
    V = TT.padded_vocab(tcfg)
    toks = np.random.default_rng(9).integers(2, jcfg.vocab_size, (B, S0),
                                             dtype=np.int32)
    jlog, jpc = JT.prefill(jcfg, AXES, jparams, {"tokens": jnp.asarray(toks)})
    first = np.argmax(np.asarray(jlog)[:, 0], axis=-1).astype(np.int32)
    c_np = {n: np.zeros((tcfg.num_layers, B, S, tcfg.num_kv_heads,
                         tcfg.head_dim), np.float32) for n in ("k", "v")}
    for n in ("k", "v"):
        c_np[n][:, :, :S0] = np.asarray(jpc[n])
    jcache = jax.tree.map(jnp.asarray, c_np)
    caches = {m: {n: _t(a) for n, a in c_np.items()} for m in ("mod", "mono")}
    state0 = (first, np.full((B,), S0, np.int32),
              np.array([16, 11, 16, 0], np.int32))
    jkw, tkw = {}, {}
    if sampled:
        sps = [TS.SamplingParams(),
               TS.SamplingParams(temperature=0.8, top_k=20, seed=1),
               TS.SamplingParams(temperature=1.1, top_p=0.9, seed=2),
               TS.SamplingParams(temperature=0.7, repetition_penalty=1.3,
                                 seed=3)]
        packed = TS.pack_params(sps, list(range(B)))
        st = TS.init_state(packed["seed"], [list(t) for t in toks],
                           [[int(f)] for f in first], V)
        flags = TS.flags_for(sps, V)
        jkw = dict(flags=JS.SampleFlags("pallas_interpret", flags.pen,
                                        flags.kc, flags.mixed, flags.stops),
                   sampling=({k: jnp.asarray(v) for k, v in packed.items()
                              if k != "seed"},
                             {"base_key": JS.base_keys(st["seed"]),
                              **{n: jnp.asarray(st[n]) for n in
                                 ("gen_count", "counts", "prompt_counts")}}))
        t_sp = {k: _t(v) for k, v in packed.items() if k != "seed"}
        t_st = {"base_key": TS.base_keys(st["seed"], "cpu"),
                **{n: _t(st[n]) for n in ("gen_count", "counts",
                                          "prompt_counts")}}
        tkw = {m: dict(flags=flags, sampling=(t_sp, dict(t_st)))
               for m in ("mod", "mono")}
    else:
        tkw = {"mod": {}, "mono": {}}
    jrt = JModuleRuntime(jcfg, AXES, jparams)
    rt = ModuleRuntime(tcfg, tparams)
    jstate = tuple(map(jnp.asarray, state0))
    tstate = {m: tuple(_t(a) for a in state0) for m in ("mod", "mono")}
    for _ in range(2):
        jout = jrt.forward_decode_page(jstate[0], jcache, jstate[1],
                                       jstate[2], 2, P, **jkw)
        outs = {"mod": rt.forward_decode_page(
                    tstate["mod"][0], caches["mod"], tstate["mod"][1],
                    tstate["mod"][2], 2, P, **tkw["mod"]),
                "mono": TT.decode_page(tcfg, tparams, caches["mono"],
                                       *tstate["mono"], P, **tkw["mono"])}
        for m, out in outs.items():
            np.testing.assert_array_equal(out[0].numpy(),
                                          np.asarray(jout[0]), err_msg=m)
            for g, w in zip(out[1:4], jout[1:4]):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            caches[m] = out[4]
            tstate[m] = tuple(out[1:4])
            if sampled:
                tkw[m]["sampling"] = (tkw[m]["sampling"][0], out[5])
        for n in ("k", "v"):
            np.testing.assert_allclose(caches["mod"][n].numpy(),
                                       np.asarray(jout[4][n]), atol=1e-5,
                                       rtol=1e-5)
        jcache, jstate = jout[4], tuple(jout[1:4])
        if sampled:
            jkw["sampling"] = (jkw["sampling"][0], jout[5])
