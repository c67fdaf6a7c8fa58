"""The fused sampling kernel's plain PyTorch version, held to the JAX
package's kernel in interpret mode and to its oracle ``ref.py`` on the CPU.

Inputs are made with numpy from a seed.  Tolerances: ``sampled``,
``greedy`` and ``top_idx`` are exact; ``tau``, ``m``, ``l``, ``m_raw``,
``l_raw`` and ``top_vals`` agree to 1e-6 (float summation order; the
thresholds themselves are bucket edges and agree exactly when the same
buckets are crossed).  The CUDA kernel is held to this plain version on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sampling as JS
from repro.kernels.fused_sampling import ref as R
from repro.kernels.fused_sampling.ops import fused_sample as jax_fused
from repro_torch import kernels
from repro_torch import sampling as TS
from repro_torch.kernels import get_kernel
from repro_torch.kernels.fused_sampling.ops import (fused_sample,
                                                    fused_sample_plain,
                                                    joint_threshold_plain)

tsample = importlib.import_module("repro_torch.sampling.sample")
TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs(V, B, seed=None):
    rng = np.random.default_rng(V if seed is None else seed)
    x = rng.normal(0.0, 2.0, (B, V)).astype(np.float32)
    g = rng.normal(0.0, 1.0, (B, V)).astype(np.float32)
    raw = rng.normal(0.0, 1.0, (B, V)).astype(np.float32)
    k = rng.choice([0, 1, 5, 40, 300], B).astype(np.int32)
    p = rng.choice([1.0, 0.95, 0.9, 0.5], B).astype(np.float32)
    mp = rng.choice([0.0, 0.02, 0.1], B).astype(np.float32)
    return x, g, raw, k, p, mp


def _compare(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        a, w = got[key].numpy(), np.asarray(w)
        if key in ("sampled", "greedy", "top_idx"):
            np.testing.assert_array_equal(a, w, err_msg=key)
        else:
            np.testing.assert_allclose(a, w, err_msg=key, **TOL)


@pytest.mark.parametrize("K", [0, 4])
@pytest.mark.parametrize("V,B", [(512, 4), (1000, 4), (4096, 3)])
def test_plain_matches_jax_interpret_kernel(V, B, K):
    """Pow2 and odd vocabularies, mixed top-k / top-p / min-p rows, with
    and without the logprob lanes."""
    x, g, raw, k, p, mp = _inputs(V, B)
    kw = dict(lp_k=K, with_lanes=K > 0)
    want = jax_fused(*map(jnp.asarray, (x, g, k, p, mp)),
                     raw=jnp.asarray(raw) if K else None, interpret=True,
                     **kw)
    got = fused_sample(*map(torch.from_numpy, (x, g, k, p, mp)),
                       raw=torch.from_numpy(raw) if K else None, **kw)
    _compare(got, want)


@pytest.mark.parametrize("V,B", [(512, 4), (1000, 4), (4096, 3)])
def test_plain_matches_ref_oracle(V, B):
    """``ref.py`` row by row on the row the reference pads to its tile:
    the padding lands in the catch-all bucket and moves no threshold."""
    x, g, raw, k, p, mp = _inputs(V, B, seed=V + 1)
    pad = (-V) % 512
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (0, pad)), constant_values=R.NEG)
    gp = jnp.pad(jnp.asarray(g), ((0, 0), (0, pad)))
    want = jax.vmap(R.ref_fused_sample)(xp, gp, *map(jnp.asarray, (k, p, mp)))
    want.update(jax.vmap(lambda r: R.ref_lanes(r, 4))(jnp.asarray(raw)))
    got = fused_sample_plain(*map(torch.from_numpy, (x, g, k, p, mp)),
                             raw=torch.from_numpy(raw), lp_k=4,
                             with_lanes=True)
    _compare(got, want)
    th = joint_threshold_plain(*map(torch.from_numpy, (x, k, p, mp)))
    jth = jax.vmap(R.ref_joint_threshold)(xp, *map(jnp.asarray, (k, p, mp)))
    for key in ("tau_k", "tau_p", "tau_m", "z"):
        np.testing.assert_allclose(th[key].numpy(), np.asarray(jth[key]),
                                   err_msg=key, **TOL)


def test_plain_matches_sort_route_tokens():
    """The same fold_in Gumbel rows through the kernel route and the full
    shared sort give identical tokens (the histogram threshold resolves
    ~2e-6 nats, far inside the logit spacing)."""
    B, V = 8, 512
    x = np.random.default_rng(0).normal(0.0, 2.0, (B, V)).astype(np.float32)
    keys = TS.step_keys(TS.base_keys(np.arange(B, dtype=np.uint32), "cpu"),
                        torch.arange(B, dtype=torch.int32))
    g = tsample._gumbel_rows(keys, V)
    k = torch.tensor([0, 1, 5, 40, 300, 0, 5, 1], dtype=torch.int32)
    p = torch.tensor([1.0, 0.95, 0.9, 0.5, 1.0, 0.7, 1.0, 0.9])
    mp = torch.tensor([0.0, 0.02, 0.1, 0.0, 0.05, 0.0, 0.0, 0.1])
    out = fused_sample(torch.from_numpy(x), g, k, p, mp)
    tau = TS.joint_threshold(torch.from_numpy(x), k, p, mp, 0)
    masked = torch.where(torch.from_numpy(x) >= tau[:, None],
                         torch.from_numpy(x), -1e30)
    assert torch.equal(out["sampled"],
                       torch.argmax(masked + g, dim=-1).to(torch.int32))


def test_lanes_reproduce_log_softmax_top_k_with_ties():
    """The lanes give log_softmax + lax.top_k: values, and ids with ties
    broken to the lowest index (rows carry deliberate ties)."""
    B, V, K = 3, 700, 6
    x, g, raw, _, _, _ = _inputs(V, B, seed=1)
    raw[:, 10] = raw[:, 20] = raw[:, 30] = 9.0        # a 3-way tie on top
    raw[1, 5] = raw[1, 6] = 8.0
    zk = np.zeros((B,), np.int32)
    out = fused_sample(*map(torch.from_numpy, (x, g, zk)),
                       torch.ones((B,)), torch.zeros((B,)),
                       raw=torch.from_numpy(raw), lp_k=K, with_lanes=True)
    lp = jax.nn.log_softmax(jnp.asarray(raw), axis=-1)
    v_ref, i_ref = jax.lax.top_k(lp, K)
    logz = out["m_raw"] + torch.log(out["l_raw"])
    np.testing.assert_array_equal(out["top_idx"].numpy(), np.asarray(i_ref))
    np.testing.assert_allclose((out["top_vals"] - logz[:, None]).numpy(),
                               np.asarray(v_ref), atol=1e-5)


def test_sample_step_kernel_route_matches_jax_pallas_interpret():
    """``sample_step`` with logprob lanes: the port's kernel route (plain
    version on the CPU) against JAX's Pallas kernel in interpret mode."""
    sps = [TS.SamplingParams(),
           TS.SamplingParams(temperature=0.8, top_k=20, seed=1),
           TS.SamplingParams(temperature=1.1, top_p=0.9, min_p=0.05, seed=2,
                             stop=(3,)),
           TS.SamplingParams(temperature=0.7, repetition_penalty=1.3,
                             frequency_penalty=0.2, seed=3)]
    B, V, K = len(sps), 512, 3
    flags = TS.flags_for(sps, V)
    jflags = JS.SampleFlags("pallas_interpret", flags.pen, flags.kc,
                            flags.mixed, flags.stops)
    packed = TS.pack_params(sps, list(range(B)))
    r = np.random.default_rng(9)
    st = TS.init_state(packed["seed"], [list(r.integers(0, V, 5))] * B,
                       [[1, 2], [], [7], [4, 4, 4]], V)
    jstate = {"base_key": JS.base_keys(st["seed"]),
              **{n: jnp.asarray(st[n]) for n in
                 ("gen_count", "counts", "prompt_counts")}}
    tstate = {"base_key": TS.base_keys(st["seed"], "cpu"),
              **{n: torch.from_numpy(st[n]) for n in
                 ("gen_count", "counts", "prompt_counts")}}
    rem = np.array([4, 4, 4, 0], np.int32)
    jrem, trem = jnp.asarray(rem), torch.from_numpy(rem)
    jsp = {k: jnp.asarray(v) for k, v in packed.items() if k != "seed"}
    tsp = {k: torch.from_numpy(v) for k, v in packed.items() if k != "seed"}
    for _ in range(2):
        logits = r.normal(0.0, 2.0, (B, V)).astype(np.float32)
        jn, _, jrem, jstate, jl = JS.sample_step(
            jnp.asarray(logits), jrem, jstate, jsp, jflags, lp_k=K)
        tn, _, trem, tstate, tl = TS.sample_step(
            torch.from_numpy(logits), trem, tstate, tsp, flags, lp_k=K)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(trem.numpy(), np.asarray(jrem))
        np.testing.assert_array_equal(tl["top_idx"].numpy(),
                                      np.asarray(jl["top_idx"]))
        for key in ("chosen_lp", "top_vals"):
            np.testing.assert_allclose(tl[key].numpy(), np.asarray(jl[key]),
                                       atol=1e-5, rtol=1e-5)
        for name in ("gen_count", "counts"):
            np.testing.assert_array_equal(tstate[name].numpy(),
                                          np.asarray(jstate[name]))


def test_registry_and_cpu_launches_nothing():
    op, plain = get_kernel("fused_sampling")
    assert op is fused_sample and plain is fused_sample_plain
    kernels.reset_launches()
    x, g, raw, k, p, mp = _inputs(300, 2)
    fused_sample(*map(torch.from_numpy, (x, g, k, p, mp)),
                 raw=torch.from_numpy(raw), lp_k=2, with_lanes=True)
    assert kernels.launches() == {name: 0 for name in kernels.KERNELS}
