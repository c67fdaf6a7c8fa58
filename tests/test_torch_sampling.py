"""The port's sampling subsystem, held to the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: threefry words are bitwise equal; Gumbel noise agrees to rtol
1e-6 with atol 1e-6 (the final ``-log(-log(u))`` may differ by an ulp of
the inner log between math libraries, which is ~5e-7 absolute where the
noise is near zero); processors and thresholds agree to 1e-6; sampled
tokens, counts and countdowns are identical.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sp_stats

from repro import sampling as JS
from repro_torch import sampling as TS

jsample = importlib.import_module("repro.sampling.sample")
tsample = importlib.import_module("repro_torch.sampling.sample")

TOL = dict(rtol=1e-6, atol=1e-6)
ROW_KEYS = ("temperature", "top_k", "top_p", "min_p", "repetition_penalty",
            "presence_penalty", "frequency_penalty")


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# threefry
# ---------------------------------------------------------------------------

DATA = np.array([0, 1, 2, 77, 4095, 2 ** 16 + 3, 2 ** 31 - 1, 2 ** 31],
                np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31, 2 ** 32 - 1])
def test_fold_in_is_bitwise_jax(seed):
    key = jax.random.PRNGKey(np.uint32(seed))
    want = np.stack([np.asarray(jax.random.fold_in(key, d)) for d in DATA])
    got = TS.fold_in(TS.base_keys([seed], "cpu")[0].expand(len(DATA), 2),
                     _t(DATA.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # folding twice (a step key, then a token id) stays bitwise too
    twice = np.asarray(jax.random.fold_in(jax.random.fold_in(key, 5), 2 ** 31))
    base = TS.base_keys([seed], "cpu")[0]
    np.testing.assert_array_equal(
        TS.fold_in(TS.fold_in(base, 5), 2 ** 31).numpy(),
        twice.astype(np.int64))


def test_base_and_step_keys_match():
    seeds = np.array([0, 1, 77, 2 ** 31, 2 ** 32 - 1], np.uint32)
    ref = np.asarray(jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds)))
    np.testing.assert_array_equal(TS.base_keys_host(seeds), ref)
    np.testing.assert_array_equal(TS.base_keys(seeds, "cpu").numpy(),
                                  ref.astype(np.int64))
    gen = np.array([0, 3, 9, 1000, 2 ** 31 - 1], np.int32)
    want = JS.step_keys(JS.base_keys(seeds), jnp.asarray(gen))
    got = TS.step_keys(TS.base_keys(seeds, "cpu"), _t(gen))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))


def test_token_gumbel_bits_exact_noise_close():
    B, V = 3, 1500
    seeds = np.array([0, 7, 2 ** 32 - 1], np.uint32)
    gen = np.array([0, 3, 9], np.int32)
    jkeys = JS.step_keys(JS.base_keys(seeds), jnp.asarray(gen))
    tkeys = TS.step_keys(TS.base_keys(seeds, "cpu"), _t(gen))
    ids = np.random.default_rng(0).integers(0, 2 ** 31, (B, V)).astype(
        np.int32)
    bits = np.asarray(jax.vmap(lambda k, row: jax.vmap(
        lambda v: jax.random.fold_in(k, v))(row))(jkeys, jnp.asarray(ids)))
    got_bits = TS.fold_in(tkeys[:, None, :].expand(B, V, 2), _t(ids))
    np.testing.assert_array_equal(got_bits.numpy(), bits.astype(np.int64))
    np.testing.assert_allclose(
        TS.token_gumbel(tkeys, _t(ids)).numpy(),
        np.asarray(JS.token_gumbel(jkeys, jnp.asarray(ids))), **TOL)
    np.testing.assert_allclose(
        tsample._gumbel_rows(tkeys, V).numpy(),
        np.asarray(jsample._gumbel_rows(jkeys, V)), **TOL)


# ---------------------------------------------------------------------------
# processors and the joint threshold
# ---------------------------------------------------------------------------


def _rows(seed, B=4, V=300):
    r = np.random.default_rng(seed)
    x = r.normal(0.0, 2.0, (B, V)).astype(np.float32)
    cf = r.integers(0, 3, (B, V)).astype(np.int32)
    cg = np.minimum(cf, r.integers(0, 2, (B, V))).astype(np.int32)
    return r, x, cf, cg


PROCESSORS = ["penalties", "temperature", "top_k", "top_p", "min_p"]


@pytest.mark.parametrize("name", PROCESSORS)
def test_processor_matches_jax(name):
    r, x, cf, cg = _rows(1)
    B = x.shape[0]
    if name == "penalties":
        rep = np.array([1.0, 1.3, 0.8, 2.0], np.float32)
        pres = np.array([0.0, 0.2, 0.5, 1.0], np.float32)
        freq = np.array([0.0, 0.1, 0.3, 0.0], np.float32)
        want = jax.vmap(JS.apply_penalties)(*map(jnp.asarray,
                                                 (x, cf, cg, rep, pres, freq)))
        got = TS.apply_penalties(*map(_t, (x, cf, cg, rep, pres, freq)))
    elif name == "temperature":
        t = np.array([0.0, 0.5, 1.0, 1.7], np.float32)
        want = jax.vmap(JS.apply_temperature)(jnp.asarray(x), jnp.asarray(t))
        got = TS.apply_temperature(_t(x), _t(t))
    else:
        arg = {"top_k": np.array([0, 1, 5, 40], np.int32),
               "top_p": np.array([1.0, 0.9, 0.5, 0.1], np.float32),
               "min_p": np.array([0.0, 0.02, 0.1, 0.5], np.float32)}[name]
        jf = getattr(JS, f"apply_{name}")
        want = jnp.stack([jf(jnp.asarray(x[i]), jnp.asarray(arg[i]))
                          for i in range(B)])
        got = getattr(TS, f"apply_{name}")(_t(x), _t(arg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kc", [0, 16, -1])
def test_joint_threshold_matches_jax(kc):
    _, x, _, _ = _rows(2, B=6, V=400)
    k = np.array([0, 1, 5, 16, 10, 3], np.int32)
    p = np.array([1.0, 0.9, 0.95, 0.5, 0.8, 1.0], np.float32)
    mp = np.array([0.0, 0.0, 0.05, 0.1, 0.0, 0.2], np.float32)
    if kc < 0:              # the sortless tier: min-p only
        k, p = np.zeros_like(k), np.ones_like(p)
    want = JS.joint_threshold(*map(jnp.asarray, (x, k, p, mp)), kc)
    got = TS.joint_threshold(*map(_t, (x, k, p, mp)), kc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(
        (TS.joint_filter(*map(_t, (x, k, p, mp)), kc) > -1e29).numpy(),
        np.asarray(JS.joint_filter(*map(jnp.asarray, (x, k, p, mp)), kc))
        > -1e29)


def test_default_pipeline_is_exact_identity():
    """SamplingParams() processors are a bitwise identity in every tier."""
    _, x, cf, cg = _rows(3, B=1, V=640)
    row = {k: torch.from_numpy(v)[0] for k, v in TS.pack_params(
        [TS.SamplingParams()], [0]).items() if k not in ("stop", "seed")}
    for kc in (0, 64, -1):
        out = TS.process_logits(_t(x[0]), _t(cf[0]), _t(cg[0]), row, kc=kc)
        np.testing.assert_array_equal(out.numpy(), x[0])


# ---------------------------------------------------------------------------
# sample / sample_step on the sort route against JAX "xla"
# ---------------------------------------------------------------------------

SP_MIX = [TS.SamplingParams(),
          TS.SamplingParams(temperature=0.8, top_k=20, seed=1),
          TS.SamplingParams(temperature=1.1, top_p=0.9, seed=2, stop=(5, 9)),
          TS.SamplingParams(temperature=0.7, min_p=0.05,
                            repetition_penalty=1.3, presence_penalty=0.2,
                            frequency_penalty=0.1, seed=3),
          TS.SamplingParams(temperature=1.0, seed=4)]


def _jsp(sp):
    return JS.SamplingParams(**{f: getattr(sp, f) for f in (
        "temperature", "top_k", "top_p", "min_p", "repetition_penalty",
        "presence_penalty", "frequency_penalty", "seed", "stop")})


# (name, rows of SP_MIX) -> kc tiers full sort, lanes and sortless
TIERS = [("full", [0, 1, 2, 3, 4]), ("lanes", [0, 1]), ("sortless", [0, 3])]


@pytest.mark.parametrize("rows", [t[1] for t in TIERS],
                         ids=[t[0] for t in TIERS])
def test_sample_step_sort_route_matches_jax_xla(rows):
    """Three decode steps of ``sample_step``: identical tokens, gen_count,
    counts and remaining (stops included) under the JAX flags' tier."""
    sps = [SP_MIX[i] for i in rows]
    B, V = len(sps), 256
    jflags = JS.flags_for([_jsp(s) for s in sps], V)
    tflags = TS.flags_for(sps, V)
    assert (tflags.pen, tflags.kc, tflags.mixed, tflags.stops) == \
        (jflags.pen, jflags.kc, jflags.mixed, jflags.stops)
    tflags = TS.SampleFlags("sort", tflags.pen, tflags.kc, tflags.mixed,
                            tflags.stops)
    jflags = JS.SampleFlags("xla", jflags.pen, jflags.kc, jflags.mixed,
                            jflags.stops)
    packed = TS.pack_params(sps, list(range(B)))
    r = np.random.default_rng(4)
    prompts = [list(r.integers(0, V, 6)) for _ in range(B)]
    gens = [list(r.integers(0, V, i)) for i in range(B)]
    st = TS.init_state(packed["seed"], prompts, gens, V)
    jstate = {"base_key": JS.base_keys(st["seed"]),
              "gen_count": jnp.asarray(st["gen_count"]),
              "counts": jnp.asarray(st["counts"]),
              "prompt_counts": jnp.asarray(st["prompt_counts"])}
    tstate = {"base_key": TS.base_keys(st["seed"], "cpu"),
              "gen_count": _t(st["gen_count"]), "counts": _t(st["counts"]),
              "prompt_counts": _t(st["prompt_counts"])}
    jsp = {k: jnp.asarray(v) for k, v in packed.items() if k != "seed"}
    tsp = {k: _t(v) for k, v in packed.items() if k != "seed"}
    rem0 = np.array([3, 2, 3, 0, 3][:B], np.int32)
    jrem, trem = jnp.asarray(rem0), _t(rem0)
    for _ in range(3):
        logits = r.normal(0.0, 2.0, (B, V)).astype(np.float32)
        logits[2 % B, [5, 9]] += 8.0        # a likely stop hit
        jn, jl, jrem, jstate = JS.sample_step(jnp.asarray(logits), jrem,
                                              jstate, jsp, jflags)
        tn, tl, trem, tstate = TS.sample_step(_t(logits), trem, tstate, tsp,
                                              tflags)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(trem.numpy(), np.asarray(jrem))
        for name in ("gen_count", "counts"):
            np.testing.assert_array_equal(tstate[name].numpy(),
                                          np.asarray(jstate[name]))


def test_sample_one_matches_jax():
    _, x, cf, cg = _rows(5, B=1, V=200)
    sp = SP_MIX[3]
    row = TS.pack_params([sp], [0])
    key = np.array([0, 12345], np.uint32)
    for kc in (0, -1):
        flags = TS.SampleFlags("sort", True, kc, True, False)
        jflags = JS.SampleFlags("xla", True, kc, True, False)
        got = TS.sample_one(_t(x[0]), _t(cf[0]), _t(cg[0]),
                            {k: _t(row[k])[0] for k in ROW_KEYS},
                            _t(key.astype(np.int64)), flags)
        want = JS.sample_one(jnp.asarray(x[0]), jnp.asarray(cf[0]),
                             jnp.asarray(cg[0]),
                             {k: jnp.asarray(row[k][0]) for k in ROW_KEYS},
                             jnp.asarray(key), jflags)
        assert int(got) == int(want)


def test_flags_for_matches_jax_and_always_picks_the_kernel():
    cases = [[TS.SamplingParams(temperature=0.8, top_k=40, top_p=0.95,
                                seed=0)],
             [TS.SamplingParams(temperature=0.8, top_p=0.9, seed=0)],
             [TS.SamplingParams(temperature=0.8, min_p=0.1, seed=0)],
             [TS.SamplingParams(),
              TS.SamplingParams(temperature=0.8, top_k=12, seed=0)],
             [TS.SamplingParams(),
              TS.SamplingParams(temperature=1.0, top_k=500,
                                repetition_penalty=1.2, seed=0, stop=(3,))],
             [TS.SamplingParams(temperature=1.0, top_k=4000, seed=0)],
             SP_MIX]
    for sps in cases:
        j = JS.flags_for([_jsp(s) for s in sps], 4096)
        t = TS.flags_for(sps, 4096)
        assert t.backend == "fused"
        assert (t.pen, t.kc, t.mixed, t.stops) == \
            (j.pen, j.kc, j.mixed, j.stops)
    assert TS.DEFAULT_FLAGS.backend == "fused"


# ---------------------------------------------------------------------------
# distribution
# ---------------------------------------------------------------------------


def _ref_probs(logits, temperature=1.0, top_k=0, top_p=1.0, min_p=0.0):
    """NumPy ground truth: temperature -> top-k -> top-p -> min-p."""
    l = np.asarray(logits, np.float64) / temperature
    if top_k > 0:
        kth = np.sort(l)[::-1][min(top_k, len(l)) - 1]
        l = np.where(l >= kth, l, -np.inf)
    if top_p < 1.0:
        order = np.argsort(l)[::-1]
        pr = np.exp(l[order] - np.max(l))
        pr /= pr.sum()
        cum_excl = np.cumsum(pr) - pr
        l = np.where(l >= l[order][cum_excl < top_p].min(), l, -np.inf)
    if min_p > 0.0:
        fin = np.isfinite(l)
        pm = np.where(fin, np.exp(l - l[fin].max()), 0.0)
        l = np.where(pm >= min_p * pm.max(), l, -np.inf)
    pr = np.exp(l - np.max(l[np.isfinite(l)]))
    pr[~np.isfinite(l)] = 0.0
    return pr / pr.sum()


@pytest.mark.parametrize("backend", ["fused", "sort"])
def test_chi_square_against_softmax(backend):
    """4000 draws of one row (one key per draw, fold_in(seed, i) as the
    decode step keys them) follow the filtered softmax."""
    logits = np.random.default_rng(7).normal(0.0, 2.0, 24)
    kw = {"temperature": 0.8, "top_k": 10, "top_p": 0.9, "min_p": 0.02}
    n, V = 4000, len(logits)
    row = {"temperature": 1.0, "top_k": 0, "top_p": 1.0, "min_p": 0.0,
           "repetition_penalty": 1.0, "presence_penalty": 0.0,
           "frequency_penalty": 0.0}
    row.update(kw)
    sp = {k: torch.full((n,), v, dtype=torch.int32 if k == "top_k"
                        else torch.float32) for k, v in row.items()}
    keys = TS.step_keys(TS.base_keys(np.full((n,), 4, np.uint32), "cpu"),
                        torch.arange(n, dtype=torch.int32))
    zeros = torch.zeros((n, V), dtype=torch.int32)
    flags = TS.SampleFlags(backend, False, 0, False, False)
    toks = TS.sample(torch.tensor(logits, dtype=torch.float32)[None]
                     .expand(n, V).contiguous(), zeros, zeros, sp, keys,
                     flags).numpy()
    probs = _ref_probs(logits, **kw)
    obs = np.bincount(toks, minlength=V).astype(np.float64)
    assert obs[probs == 0].sum() == 0, "drew a filtered (p=0) token"
    live = probs > 0
    exp = n * probs[live]
    chi2 = float(((obs[live] - exp) ** 2 / exp).sum())
    crit = float(sp_stats.chi2.ppf(1 - 1e-3, int(live.sum()) - 1))
    assert chi2 < crit, f"chi2={chi2:.1f} >= crit={crit:.1f}"
