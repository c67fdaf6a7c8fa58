"""The port's Mamba-2 block and its ``ssd_scan`` kernel, held to the JAX
package on the CPU.

Inputs are made with numpy from a seed; weights come from the JAX
package's ``init_ssm`` / ``init_params``.  Everything runs in fp32.
Tolerances: the scan's plain version against the JAX kernel (interpret
mode) and ``ref_state_scan`` atol 1e-5, as the JAX test holds them (the
same fp32 operations in the same order, but XLA on the CPU may contract
them into an FMA); ``ssd_chunked`` / ``ssm_fwd`` / ``ssm_decode`` atol and
rtol 1e-5 (the two frameworks sum the einsums' products in other
orders); the chunked form against the stepwise recurrence at the JAX
test's atol 2e-3 / rtol 1e-2 (a different algorithm, exponentials of
cumulative sums against a product of per-step decays).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.kernels.ssd_scan.ops import ssd_state_scan as j_scan
from repro.kernels.ssd_scan.ref import ref_state_scan
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.models.api import MeshAxes
from repro_torch import kernels
from repro_torch.configs import reduced_config
from repro_torch.kernels.ssd_scan.ops import (ssd_state_scan,
                                              ssd_state_scan_plain)
from repro_torch.launch import profile
from repro_torch.launch.model_level import generate
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.sampling import SamplingParams

TOL = dict(atol=1e-5, rtol=1e-5)


def _cfgs(**over):
    return (dataclasses.replace(j_reduced("mamba2_370m"), dtype="float32",
                                **over),
            dataclasses.replace(reduced_config("mamba2_370m"),
                                dtype="float32", **over))


def _params(jcfg, seed=1):
    """One layer's JAX ``init_ssm`` as numpy, and as torch tensors."""
    np_p = jax.tree.map(np.asarray,
                        JS.init_ssm(jcfg, jax.random.PRNGKey(seed)))
    return np_p, {k: torch.from_numpy(np.array(v)) for k, v in np_p.items()}


# the JAX kernel test's two shapes, and a single chunk
SCAN_SHAPES = [(2, 4, 8, 16, 8), (1, 2, 16, 32, 16), (2, 3, 1, 16, 8)]


@pytest.mark.parametrize("shape", SCAN_SHAPES,
                         ids=["x".join(map(str, s)) for s in SCAN_SHAPES])
def test_scan_plain_matches_jax_kernel_and_ref(shape):
    r = np.random.default_rng(0)
    B, H, nc, N, P = shape
    s = r.standard_normal(shape).astype(np.float32)
    d = (r.random((B, H, nc)) * 0.9).astype(np.float32)
    jp, jf = j_scan(jnp.asarray(s), jnp.asarray(d), interpret=True)
    rp, rf = ref_state_scan(jnp.asarray(s), jnp.asarray(d))
    kernels.reset_launches()
    tp, tf = ssd_state_scan(torch.from_numpy(s), torch.from_numpy(d))
    assert kernels.launches()["ssd_scan"] == 0      # the CPU: plain version
    assert tp.shape == shape and tf.shape == (B, H, N, P)
    for want_p, want_f in ((jp, jf), (rp, rf)):
        np.testing.assert_allclose(tp.numpy(), np.asarray(want_p), atol=1e-5)
        np.testing.assert_allclose(tf.numpy(), np.asarray(want_f), atol=1e-5)
    # the entering state of chunk 0 is zero; final = the last step
    assert not tp[:, :, 0].any()
    want = tp[:, :, -1] * torch.from_numpy(d)[:, :, -1, None, None] \
        + torch.from_numpy(s)[:, :, -1]
    assert torch.equal(tf, want)
    p2, f2 = ssd_state_scan_plain(torch.from_numpy(s), torch.from_numpy(d))
    assert torch.equal(p2, tp) and torch.equal(f2, tf)


# (S, chunk): shorter than a chunk, one chunk, two chunks, chunk 8 at 32
CHUNK_CASES = [(24, 64), (64, 64), (128, 64), (32, 8)]


@pytest.mark.parametrize("S,chunk", CHUNK_CASES,
                         ids=[f"S{s}_Q{q}" for s, q in CHUNK_CASES])
def test_ssd_chunked_matches_jax(S, chunk):
    """x, B and C at half the unit scale (the block feeds silu outputs);
    y is cubic in them, so unit inputs give outputs of ~40 whose fp32
    summation-order differences (~2e-6 of the largest) exceed atol 1e-5."""
    r = np.random.default_rng(1)
    b, h, p, g, n = 2, 4, 8, 1, 16
    xh = (0.5 * r.standard_normal((b, S, h, p))).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((b, S, h)))).astype(np.float32)
    A = -np.linspace(1.0, 16.0, h).astype(np.float32)
    Bm = (0.5 * r.standard_normal((b, S, g, n))).astype(np.float32)
    Cm = (0.5 * r.standard_normal((b, S, g, n))).astype(np.float32)
    jy, jst = JS.ssd_chunked(*map(jnp.asarray, (xh, dt, A, Bm, Cm)),
                             chunk=chunk)
    ty, tst = TS.ssd_chunked(*map(torch.from_numpy, (xh, dt, A, Bm, Cm)),
                             chunk=chunk)
    assert ty.shape == (b, S, h, p) and tst.shape == (b, h, n, p)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), **TOL)


def test_ssd_chunked_groups_share_b_and_c():
    """Two groups of two heads: each head reads its own group's B and C,
    as the reference's ``jnp.repeat`` over heads gives them."""
    r = np.random.default_rng(2)
    b, S, h, p, g, n = 1, 32, 4, 8, 2, 8
    args = ((0.5 * r.standard_normal((b, S, h, p))).astype(np.float32),
            (0.5 * r.random((b, S, h))).astype(np.float32),
            -np.linspace(1.0, 4.0, h).astype(np.float32),
            (0.5 * r.standard_normal((b, S, g, n))).astype(np.float32),
            (0.5 * r.standard_normal((b, S, g, n))).astype(np.float32))
    jy, jst = JS.ssd_chunked(*map(jnp.asarray, args), chunk=8)
    ty, tst = TS.ssd_chunked(*map(torch.from_numpy, args), chunk=8)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), **TOL)


def test_ssd_chunked_refuses_a_ragged_sequence():
    """S = 100 > chunk 64 is not a multiple of it: the reference asserts,
    the port raises (no padding: pad tokens would fold into the state)."""
    r = np.random.default_rng(3)
    args = (r.standard_normal((1, 100, 2, 4)).astype(np.float32),
            r.random((1, 100, 2)).astype(np.float32),
            -np.ones((2,), np.float32),
            r.standard_normal((1, 100, 1, 4)).astype(np.float32),
            r.standard_normal((1, 100, 1, 4)).astype(np.float32))
    with pytest.raises(AssertionError):
        JS.ssd_chunked(*map(jnp.asarray, args))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        TS.ssd_chunked(*map(torch.from_numpy, args))


@pytest.mark.parametrize("S", [8, 64, 128])
def test_ssm_fwd_state_and_decode_match_jax(S):
    """``ssm_fwd(return_state=True)``: output and every cache leaf; then
    four ``ssm_decode`` steps from that cache: outputs and leaves."""
    jcfg, tcfg = _cfgs()
    np_p, tp = _params(jcfg)
    r = np.random.default_rng(4)
    B = 2
    x = (0.5 * r.standard_normal((B, S, jcfg.d_model))).astype(np.float32)
    jo, jc = JS.ssm_fwd(jcfg, jax.tree.map(jnp.asarray, np_p),
                        jnp.asarray(x), return_state=True)
    to, tc = TS.ssm_fwd(tcfg, tp, torch.from_numpy(x), return_state=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    assert list(tc) == list(jc)
    for k in jc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL,
                                   err_msg=k)
    tc = {k: v.clone() for k, v in tc.items()}
    for t in range(4):
        xs = (0.5 * r.standard_normal((B, 1, jcfg.d_model))).astype(
            np.float32)
        jo, jc = JS.ssm_decode(jcfg, jax.tree.map(jnp.asarray, np_p),
                               jnp.asarray(xs), jc)
        before = {k: v for k, v in tc.items()}
        to, tc2 = TS.ssm_decode(tcfg, tp, torch.from_numpy(xs), tc)
        assert all(tc2[k] is before[k] for k in tc)    # written in place
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL,
                                   err_msg=f"step {t}")
        for k in jc:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       **TOL, err_msg=f"step {t} {k}")


def _stepwise(cfg, p, x):
    """The recurrent oracle: ``ssm_decode`` one token at a time from a
    zero cache; returns (outputs (B,S,D), the final cache)."""
    cache = TS.init_ssm_cache(cfg, x.shape[0], torch.float32, "cpu")
    outs = [TS.ssm_decode(cfg, p, x[:, t:t + 1], cache)[0]
            for t in range(x.shape[1])]
    return torch.cat(outs, 1), cache


def test_chunked_matches_stepwise_decode():
    """The port's chunked prefill against its own stepwise decode (the
    counterpart of ``tests/test_models.py::test_ssd_chunked_matches_
    stepwise``), outputs and the handed-off cache."""
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    r = np.random.default_rng(5)
    x = torch.from_numpy((0.1 * r.standard_normal((2, 32, jcfg.d_model)))
                         .astype(np.float32))
    full, cache = TS.ssm_fwd(tcfg, tp, x, chunk=8, return_state=True)
    step, scache = _stepwise(tcfg, tp, x)
    np.testing.assert_allclose(full.numpy(), step.numpy(), atol=2e-3,
                               rtol=1e-2)
    for k in cache:
        np.testing.assert_allclose(cache[k].numpy(), scache[k].numpy(),
                                   atol=2e-3, rtol=1e-2, err_msg=k)


def test_short_prompt_conv_cache_is_left_padded():
    """S = 2 < K - 1 = 3: the reference slices a (B, 1, C) conv cache
    (a known reference defect, ROADMAP Queue C); the port zero-pads on
    the left, which is what stepwise decode from a zero cache holds."""
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    r = np.random.default_rng(6)
    x = torch.from_numpy((0.5 * r.standard_normal((2, 2, jcfg.d_model)))
                         .astype(np.float32))
    out, cache = TS.ssm_fwd(tcfg, tp, x, return_state=True)
    step, scache = _stepwise(tcfg, tp, x)
    K = tcfg.ssm_conv
    for k in ("conv_x", "conv_B", "conv_C"):
        assert cache[k].shape[1] == K - 1
        assert not cache[k][:, 0].any()
        np.testing.assert_allclose(cache[k].numpy(), scache[k].numpy(),
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(cache["state"].numpy(),
                               scache["state"].numpy(), atol=2e-3,
                               rtol=1e-2)
    np.testing.assert_allclose(out.numpy(), step.numpy(), atol=2e-3,
                               rtol=1e-2)


def test_model_level_serving_matches_jax_pages():
    """The slice as a whole on reduced Mamba-2: ``generate`` (prefill, the
    first token, greedy ``decode_page``s of 16 steps) gives the tokens of
    JAX's prefill and ``decode_page`` loop, rows of 1 to 35 tokens over
    three pages; the sampled batch with logprob planes gives the same
    streams twice."""
    jcfg, tcfg = _cfgs()
    np_params = jax.tree.map(np.asarray,
                             JT.init_params(jcfg, jax.random.PRNGKey(2)))
    jparams = jax.tree.map(jnp.asarray, np_params)
    tparams = TT.params_from_numpy(np_params, tcfg, device="cpu")
    want = np.array([1, 16, 35, 20], np.int32)
    B = len(want)
    toks = np.random.default_rng(7).integers(2, jcfg.vocab_size, (B, 128),
                                             dtype=np.int32)
    got = generate(tcfg, tparams, toks.tolist(), want.tolist())
    assert [len(t) for t in got.tokens] == want.tolist()
    assert got.pages == 3 and got.decode_steps == 48

    jlog, cache = JT.prefill(jcfg, MeshAxes(), jparams,
                             {"tokens": jnp.asarray(toks)})
    cur = jnp.argmax(jlog[:, 0], axis=-1).astype(jnp.int32)
    rows = [[int(t)] for t in np.asarray(cur)]
    lengths = jnp.full((B,), 128, jnp.int32)
    rem = jnp.asarray(want - 1)
    while int(rem.max()) > 0:
        blk, cur, new_len, rem, cache = JT.decode_page(
            jcfg, MeshAxes(), jparams, cache, cur, lengths, rem, 16)
        live = np.asarray(new_len - lengths)
        for b in range(B):
            rows[b] += np.asarray(blk)[:live[b], b].tolist()
        lengths = new_len
    assert got.tokens == rows

    sps = [SamplingParams(temperature=0.8, top_k=40, top_p=0.95, seed=i)
           for i in range(B)]
    runs = [generate(tcfg, tparams, toks.tolist(), 20, sampling=sps, lp_k=5)
            for _ in range(2)]
    assert runs[0].tokens == runs[1].tokens
    assert runs[0].logprobs == runs[1].logprobs
    chosen, vals, ids = runs[0].logprobs[0]
    assert len(chosen) == len(vals) == len(ids) == 20
    assert all(len(v) == 5 and c <= 0 for v, c in zip(vals, chosen))


def test_model_level_page_length_is_the_callers():
    """``page_steps`` sets the steps of each ``decode_page``: greedy rows
    of 1 to 35 tokens take five pages of 8 steps instead of three of 16,
    with the same tokens."""
    _, tcfg = _cfgs()
    tparams = TT.init_params(tcfg, 3, device="cpu")
    toks = np.random.default_rng(8).integers(2, tcfg.vocab_size, (4, 64))
    want = [1, 16, 35, 20]
    by16 = generate(tcfg, tparams, toks.tolist(), want)
    by8 = generate(tcfg, tparams, toks.tolist(), want, page_steps=8)
    assert (by16.pages, by16.decode_steps) == (3, 48)
    assert (by8.pages, by8.decode_steps) == (5, 40)
    assert by8.tokens == by16.tokens
    assert [len(t) for t in by8.tokens] == want


@pytest.mark.parametrize("flag", [["--max-active", "4"], ["--max-len", "512"],
                                  ["--module-granularity"], ["--b-attn", "2"]],
                         ids=lambda f: f[0].lstrip("-"))
def test_profile_refuses_engine_options_for_the_ssm(flag, capsys):
    """``launch.profile`` serves the SSM at model level, with no engine:
    it refuses the engine's options before it touches a device."""
    with pytest.raises(SystemExit) as exc:
        profile.main(["--arch", "mamba2_370m", "--reduced"] + flag)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "served at model level" in err and flag[0] in err
