"""The port's dense decoder, held to the JAX package on the CPU.

Weights come from the JAX package's ``init_params`` and reach the port
through ``params_from_numpy``; other inputs are made with numpy from a
seed.  Everything runs in fp32 (``dataclasses.replace(cfg,
dtype="float32")``).  Tolerances: 1e-5 for single layers, 1e-4 for whole
forwards (errors of the two frameworks' summation orders add up over the
layers); greedy tokens must be identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.models import layers as jl
from repro.models import transformer as JT
from repro.models.api import MeshAxes
from repro_torch.configs import reduced_config
from repro_torch.models import layers as tl
from repro_torch.models import transformer as TT

AXES = MeshAxes()
TOL = dict(atol=1e-5, rtol=1e-5)
FWD_TOL = dict(atol=1e-4, rtol=1e-4)


def _cfgs(arch, **over):
    """The same reduced fp32 config in both packages."""
    return (dataclasses.replace(j_reduced(arch), dtype="float32", **over),
            dataclasses.replace(reduced_config(arch), dtype="float32",
                                **over))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_params(jcfg, seed=0, bias_rng=None):
    """JAX init_params as numpy; with ``bias_rng`` the (zero-initialised)
    QKV biases are drawn so the bias path is exercised."""
    params = _np_tree(JT.init_params(jcfg, jax.random.PRNGKey(seed)))
    if bias_rng is not None:
        for name in ("bq", "bk", "bv"):
            a = params["layers"]["attn"][name]
            params["layers"]["attn"][name] = (
                0.1 * bias_rng.standard_normal(a.shape)).astype(np.float32)
    return params


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch,dtype", [("llama3_2_1b", "float32"),
                                        ("qwen2_0_5b", "float32"),
                                        ("llama3_2_1b", "bfloat16")])
def test_params_from_numpy_round_trips(arch, dtype):
    """Every leaf of the JAX pytree arrives unchanged (bf16 bit for bit,
    compared as uint16 patterns)."""
    jcfg = dataclasses.replace(j_reduced(arch), dtype=dtype)
    tcfg = dataclasses.replace(reduced_config(arch), dtype=dtype)
    np_params = _np_tree(JT.init_params(jcfg, jax.random.PRNGKey(0)))
    params = TT.params_from_numpy(np_params, tcfg, device="cpu")
    want = dict(_leaves(np_params))
    got = dict(_leaves(params))
    assert want.keys() == got.keys()
    for name, a in want.items():
        t = got[name]
        assert str(t.dtype) == f"torch.{dtype}", name
        if dtype == "bfloat16":
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy().view(np.uint16),
                a.view(np.uint16), err_msg=name)
        else:
            np.testing.assert_array_equal(t.numpy(), a, err_msg=name)
    assert TT.param_count(tcfg) == JT.param_count(jcfg)


def test_params_from_numpy_rejects_wrong_shapes():
    jcfg, tcfg = _cfgs("llama3_2_1b")
    np_params = _jax_params(jcfg)
    np_params["lm_head"] = np_params["lm_head"][:, :-16]
    with pytest.raises(ValueError):
        TT.params_from_numpy(np_params, tcfg, device="cpu")


def test_rms_norm_and_rope_match():
    r = np.random.default_rng(0)
    x = r.standard_normal((2, 5, 64)).astype(np.float32)
    w = r.standard_normal((64,)).astype(np.float32)
    np.testing.assert_allclose(
        tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w))), **TOL)
    xh = r.standard_normal((2, 5, 3, 32)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 100, 2047, 5, 9]], np.int32)
    np.testing.assert_allclose(
        tl.rope(torch.from_numpy(xh), torch.from_numpy(pos), 500000.0).numpy(),
        np.asarray(jl.rope(jnp.asarray(xh), jnp.asarray(pos), 500000.0)),
        **TOL)


def test_attention_qkv_with_bias_and_mlp_match():
    """qwen2's QKV bias path, with drawn biases, and the SwiGLU MLP."""
    jcfg, tcfg = _cfgs("qwen2_0_5b")
    np_params = _jax_params(jcfg, bias_rng=np.random.default_rng(1))
    tparams = TT.params_from_numpy(np_params, tcfg, device="cpu")
    r = np.random.default_rng(2)
    x = r.standard_normal((2, 6, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6)).copy()
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), np_params["layers"])
    tp = TT._per_layer(tparams)[0]
    want = jl.attention_qkv(jcfg, jp["attn"], jnp.asarray(x),
                            jnp.asarray(pos))
    got = tl.attention_qkv(tcfg, tp["attn"], torch.from_numpy(x),
                           torch.from_numpy(pos))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(
        tl.mlp_fwd(tcfg, tp["mlp"], torch.from_numpy(x)).numpy(),
        np.asarray(jl.mlp_fwd(jcfg, jp["mlp"], jnp.asarray(x))), **TOL)


def test_cache_update_matches_and_drops_out_of_range():
    """In-place write at ``lengths``; rows at or past the cache length and
    negative rows are no-op writes, as in the JAX function."""
    r = np.random.default_rng(3)
    cache = r.standard_normal((4, 8, 2, 16)).astype(np.float32)
    new = r.standard_normal((4, 1, 2, 16)).astype(np.float32)
    lengths = np.array([0, 7, 8, -1], np.int32)
    want = np.asarray(jl.cache_update(jnp.asarray(cache), jnp.asarray(new),
                                      jnp.asarray(lengths)))
    t = torch.from_numpy(cache.copy())
    out = tl.cache_update(t, torch.from_numpy(new), torch.from_numpy(lengths))
    assert out is t
    np.testing.assert_array_equal(t.numpy(), want)
    np.testing.assert_array_equal(t.numpy()[2:], cache[2:])


@pytest.mark.parametrize("arch", ["llama3_2_1b", "qwen2_0_5b"])
def test_prefill_logits_and_cache_match(arch):
    jcfg, tcfg = _cfgs(arch)
    np_params = _jax_params(jcfg, bias_rng=np.random.default_rng(4)
                            if jcfg.attn_bias else None)
    tparams = TT.params_from_numpy(np_params, tcfg, device="cpu")
    toks = np.random.default_rng(5).integers(2, jcfg.vocab_size, (2, 16),
                                             dtype=np.int32)
    jlog, jcache = JT.prefill(jcfg, AXES,
                              jax.tree.map(jnp.asarray, np_params),
                              {"tokens": jnp.asarray(toks)})
    tlog, tcache = TT.prefill(tcfg, tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **FWD_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), **FWD_TOL)


# smollm's published 15 heads / 5 kv heads cut to 6 / 2: a head count and
# a GQA group (3) that are not powers of two
DECODE_CASES = [("llama3_2_1b", {}), ("qwen2_0_5b", {}),
                ("smollm_360m", dict(num_heads=6, num_kv_heads=2))]


@pytest.mark.parametrize("arch,over", DECODE_CASES,
                         ids=[c[0] for c in DECODE_CASES])
def test_decode_page_tokens_match_over_two_pages(arch, over):
    """Greedy ``decode_page`` from a prefilled cache: two pages of 8 steps,
    one slot finishing mid-page and one never live, give the JAX scan's
    tokens exactly, and the same lengths and countdowns."""
    jcfg, tcfg = _cfgs(arch, **over)
    np_params = _jax_params(jcfg, bias_rng=np.random.default_rng(6)
                            if jcfg.attn_bias else None)
    jparams = jax.tree.map(jnp.asarray, np_params)
    tparams = TT.params_from_numpy(np_params, tcfg, device="cpu")
    B, S0, max_len, P = 3, 8, 64, 8
    toks = np.random.default_rng(7).integers(2, jcfg.vocab_size, (B, S0),
                                             dtype=np.int32)
    jlog, jpc = JT.prefill(jcfg, AXES, jparams, {"tokens": jnp.asarray(toks)})
    first = np.argmax(np.asarray(jlog)[:, 0], axis=-1).astype(np.int32)
    jcache = {n: JT.init_cache(jcfg, B, max_len)[n].at[:, :, :S0].set(jpc[n])
              for n in ("k", "v")}
    tcache = TT.init_cache(tcfg, B, max_len, "cpu")
    for n in ("k", "v"):
        tcache[n][:, :, :S0] = torch.from_numpy(np.array(jpc[n]))
    lengths = np.full((B,), S0, np.int32)
    remaining = np.array([16, 11, 0], np.int32)
    jstate = tuple(map(jnp.asarray, (first, lengths, remaining)))
    tstate = tuple(map(torch.from_numpy, (first.copy(), lengths.copy(),
                                          remaining.copy())))
    for _ in range(2):
        jblk, jt, jln, jrem, jcache = JT.decode_page(
            jcfg, AXES, jparams, jcache, *jstate, P)
        tblk, tt, tln, trem, tcache = TT.decode_page(
            tcfg, tparams, tcache, *tstate, P)
        np.testing.assert_array_equal(tblk.numpy(), np.asarray(jblk))
        for g, w in zip((tt, tln, trem), (jt, jln, jrem)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert tblk.dtype == torch.int32
        jstate, tstate = (jt, jln, jrem), (tt, tln, trem)
