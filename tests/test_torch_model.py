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


def _prompt_len(cfg):
    """8 prompt tokens; an SSM gets 128, two chunks of its SSD scan."""
    return 128 if cfg.family == "ssm" else 8


def _prefilled(jcfg, tcfg, jparams, toks, max_len):
    """JAX prefill of ``toks`` (B, S0): the greedy first tokens and the
    same decode cache in both packages (the prompt's K/V at the head of a
    ``max_len`` cache; an SSM's prefill cache is its decode cache)."""
    B, S0 = toks.shape
    jlog, jpc = JT.prefill(jcfg, AXES, jparams, {"tokens": jnp.asarray(toks)})
    first = np.argmax(np.asarray(jlog)[:, 0], axis=-1).astype(np.int32)
    if tcfg.family == "ssm":
        return first, jpc, {n: torch.from_numpy(np.array(a))
                            for n, a in jpc.items()}
    jcache = {n: JT.init_cache(jcfg, B, max_len)[n].at[:, :, :S0].set(jpc[n])
              for n in ("k", "v")}
    tcache = TT.init_cache(tcfg, B, max_len, "cpu")
    for n in ("k", "v"):
        tcache[n][:, :, :S0] = torch.from_numpy(np.array(jpc[n]))
    return first, jcache, tcache


@pytest.mark.parametrize("arch,dtype", [("llama3_2_1b", "float32"),
                                        ("qwen2_0_5b", "float32"),
                                        ("llama3_2_1b", "bfloat16"),
                                        ("qwen3_moe_30b", "float32"),
                                        ("qwen3_moe_30b", "bfloat16"),
                                        ("mamba2_370m", "float32"),
                                        ("mamba2_370m", "bfloat16")])
def test_params_from_numpy_round_trips(arch, dtype):
    """Every leaf of the JAX pytree arrives unchanged (bf16 bit for bit,
    compared as uint16 patterns), in its own dtype: the MoE router ``wg``
    and the SSM's ``dt_bias``, ``A_log`` and ``D_skip`` stay fp32 in a
    bf16 model, as in the JAX package."""
    jcfg = dataclasses.replace(j_reduced(arch), dtype=dtype)
    tcfg = dataclasses.replace(reduced_config(arch), dtype=dtype)
    np_params = _np_tree(JT.init_params(jcfg, jax.random.PRNGKey(0)))
    params = TT.params_from_numpy(np_params, tcfg, device="cpu")
    want = dict(_leaves(np_params))
    got = dict(_leaves(params))
    assert want.keys() == got.keys()
    for name, a in want.items():
        t = got[name]
        leaf_dt = "float32" if a.dtype == np.float32 else dtype
        assert str(t.dtype) == f"torch.{leaf_dt}", name
        if leaf_dt == "bfloat16":
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy().view(np.uint16),
                a.view(np.uint16), err_msg=name)
        else:
            np.testing.assert_array_equal(t.numpy(), a, err_msg=name)
    assert TT.param_count(tcfg) == JT.param_count(jcfg)
    assert TT.param_count(tcfg, active_only=True) == \
        JT.param_count(jcfg, active_only=True)
    if tcfg.is_moe:
        assert got[".layers.moe.wg"].dtype == torch.float32
    if tcfg.family == "ssm":
        for leaf in ("dt_bias", "A_log", "D_skip"):
            assert got[f".layers.ssm.{leaf}"].dtype == torch.float32


def test_params_from_numpy_rejects_wrong_shapes():
    jcfg, tcfg = _cfgs("llama3_2_1b")
    np_params = _jax_params(jcfg)
    np_params["lm_head"] = np_params["lm_head"][:, :-16]
    with pytest.raises(ValueError):
        TT.params_from_numpy(np_params, tcfg, device="cpu")


def test_per_layer_views_do_not_keep_params_alive():
    """The per-layer view cache shares the weights' storage while the
    params live, and lets them go with the params (a cache that held the
    stacked leaves kept every model a process had built on the card)."""
    import gc
    import weakref

    cfg = reduced_config("mamba2_370m")
    params = TT.init_params(cfg, seed=0, device="cpu")
    views = TT._per_layer(params)
    assert TT._per_layer(params) is views
    wx = params["layers"]["ssm"]["wx"]
    assert views[1]["ssm"]["wx"].data_ptr() == wx[1].data_ptr()
    assert torch.equal(views[1]["ssm"]["wx"], wx[1])
    refs = [weakref.ref(params["layers"]["ln1"]["w"]), weakref.ref(wx)]
    del params, views, wx
    gc.collect()
    assert all(r() is None for r in refs)


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


@pytest.mark.parametrize("arch", ["llama3_2_1b", "qwen2_0_5b",
                                  "qwen3_moe_30b", "phi3_5_moe",
                                  "mamba2_370m"])
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
    assert set(tcache) == set(jcache)       # k, v; or an SSM's four leaves
    for name in jcache:
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), **FWD_TOL,
                                   err_msg=name)


# smollm's published 15 heads / 5 kv heads cut to 6 / 2: a head count and
# a GQA group (3) that are not powers of two; the two MoE decoders; the SSM
DECODE_CASES = [("llama3_2_1b", {}), ("qwen2_0_5b", {}),
                ("smollm_360m", dict(num_heads=6, num_kv_heads=2)),
                ("qwen3_moe_30b", {}), ("phi3_5_moe", {}),
                ("mamba2_370m", {})]


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
    B, S0, max_len, P = 3, _prompt_len(tcfg), 64, 8
    toks = np.random.default_rng(7).integers(2, jcfg.vocab_size, (B, S0),
                                             dtype=np.int32)
    first, jcache, tcache = _prefilled(jcfg, tcfg, jparams, toks, max_len)
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


def test_pack_logprob_block_round_trips_and_matches_jax():
    """The packed plane's layout: int32 token and id bit patterns survive
    the f32 view exactly; values agree with JAX's pack to 1e-6, and ids
    (with a deliberate tie) exactly."""
    r = np.random.default_rng(8)
    B, V, K = 4, 300, 5
    logits = r.normal(0.0, 2.0, (B, V)).astype(np.float32)
    logits[:, 40] = logits[:, 7] = 12.0          # tie on top: lowest id first
    tokens = np.array([0, 123, 299, 7], np.int32)
    for k in (0, K):
        got = TT.pack_logprob_block(torch.from_numpy(tokens),
                                    torch.from_numpy(logits), k).numpy()
        want = np.asarray(JT.pack_logprob_block(jnp.asarray(tokens),
                                                jnp.asarray(logits), k))
        assert got.shape == want.shape == (B, 2 + 2 * k)
        gt, gc, gv, gi = TT.unpack_logprob_block(got[None])
        wt, wc, wv, wi = JT.unpack_logprob_block(want[None])
        np.testing.assert_array_equal(gt[0], tokens)
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_allclose(gc, wc, **TOL)
        if k:
            np.testing.assert_array_equal(gi, wi)
            assert list(gi[0, 0, :2]) == [7, 40]
            np.testing.assert_allclose(gv, wv, **TOL)
        else:
            assert gv is None and gi is None


# (sampled, lp_k): the greedy logprob page, the sampled page, and the
# sampled page with logprob lanes from the fused sampling pass
PAGE_VARIANTS = [(False, 3), (True, None), (True, 2)]


@pytest.mark.parametrize("sampled,lp_k", PAGE_VARIANTS,
                         ids=["greedy_lp3", "sampled", "sampled_lp2"])
def test_decode_page_sampled_and_logprobs_match_jax(sampled, lp_k):
    """Two pages of 8 steps against JAX's ``decode_page`` with the Pallas
    sampling kernel in interpret mode: identical token blocks (or plane
    token columns and ids), planes within 1e-5, equal countdowns and
    sampling state.  One slot finishes mid-page, one carries a stop set
    and one is never live."""
    _check_page_variant("llama3_2_1b", sampled, lp_k)


@pytest.mark.parametrize("sampled,lp_k", PAGE_VARIANTS,
                         ids=["greedy_lp3", "sampled", "sampled_lp2"])
def test_ssm_decode_page_sampled_and_logprobs_match_jax(sampled, lp_k):
    """The same pages on reduced Mamba-2 after a two-chunk prompt: the
    SSM's decode cache advances in place, a finished row's state too."""
    _check_page_variant("mamba2_370m", sampled, lp_k)


def _check_page_variant(arch, sampled, lp_k):
    from repro import sampling as JS
    from repro_torch import sampling as TS

    jcfg, tcfg = _cfgs(arch)
    np_params = _jax_params(jcfg)
    jparams = jax.tree.map(jnp.asarray, np_params)
    tparams = TT.params_from_numpy(np_params, tcfg, device="cpu")
    B, S0, max_len, P = 4, _prompt_len(tcfg), 64, 8
    V = TT.padded_vocab(tcfg)
    toks = np.random.default_rng(9).integers(2, jcfg.vocab_size, (B, S0),
                                             dtype=np.int32)
    first, jcache, tcache = _prefilled(jcfg, tcfg, jparams, toks, max_len)
    lengths = np.full((B,), S0, np.int32)
    remaining = np.array([16, 11, 16, 0], np.int32)
    jkw, tkw = {"lp_k": lp_k}, {"lp_k": lp_k}
    if sampled:
        sps = [TS.SamplingParams(),
               TS.SamplingParams(temperature=0.8, top_k=20, seed=1),
               TS.SamplingParams(temperature=1.1, top_p=0.9, seed=2,
                                 stop=tuple(range(0, V, V // 8))),
               TS.SamplingParams(temperature=0.7, repetition_penalty=1.3,
                                 presence_penalty=0.2, seed=3)]
        packed = TS.pack_params(sps, list(range(B)))
        st = TS.init_state(packed["seed"], [list(t) for t in toks],
                           [[int(f)] for f in first], V)
        flags = TS.flags_for(sps, V)
        jflags = JS.SampleFlags("pallas_interpret", flags.pen, flags.kc,
                                flags.mixed, flags.stops)
        jkw.update(flags=jflags, sampling=(
            {k: jnp.asarray(v) for k, v in packed.items() if k != "seed"},
            {"base_key": JS.base_keys(st["seed"]),
             **{n: jnp.asarray(st[n]) for n in
                ("gen_count", "counts", "prompt_counts")}}))
        tkw.update(flags=flags, sampling=(
            {k: torch.from_numpy(v) for k, v in packed.items() if k != "seed"},
            {"base_key": TS.base_keys(st["seed"], "cpu"),
             **{n: torch.from_numpy(st[n]) for n in
                ("gen_count", "counts", "prompt_counts")}}))
    jstate = tuple(map(jnp.asarray, (first, lengths, remaining)))
    tstate = tuple(map(torch.from_numpy, (first.copy(), lengths.copy(),
                                          remaining.copy())))
    for _ in range(2):
        jout = JT.decode_page(jcfg, AXES, jparams, jcache, *jstate, P, **jkw)
        tout = TT.decode_page(tcfg, tparams, tcache, *tstate, P, **tkw)
        jblk, tblk = np.asarray(jout[0]), tout[0].numpy()
        if lp_k is None:
            np.testing.assert_array_equal(tblk, jblk)
        else:
            jt, jc, jv, ji = JT.unpack_logprob_block(jblk)
            tt, tc, tv, ti = TT.unpack_logprob_block(tblk)
            np.testing.assert_array_equal(tt, jt)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_allclose(tc, jc, atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=1e-5)
        for g, w in zip(tout[1:4], jout[1:4]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        jcache, tcache = jout[4], tout[4]
        jstate, tstate = tuple(jout[1:4]), tuple(tout[1:4])
        if sampled:
            for n in ("base_key", "gen_count", "counts", "prompt_counts"):
                np.testing.assert_array_equal(
                    tout[5][n].numpy(),
                    np.asarray(jout[5][n]).astype(tout[5][n].numpy().dtype))
            jkw["sampling"] = (jkw["sampling"][0], jout[5])
            tkw["sampling"] = (tkw["sampling"][0], tout[5])


def test_node_engine_refuses_the_ssm_family_in_both_packages():
    """Both engines serve dense and MoE caches only; the SSM is served at
    model level (``prefill`` / ``decode_page``).  The port's serving
    entry point builds a ``NodeEngine``, so it refuses too."""
    from repro.runtime.engine import NodeEngine as JEngine
    from repro_torch.launch import serve
    from repro_torch.runtime.engine import NodeEngine

    with pytest.raises(AssertionError):
        JEngine(j_reduced("mamba2_370m"), max_active=2, max_len=32)
    with pytest.raises(NotImplementedError, match="model level"):
        NodeEngine(reduced_config("mamba2_370m"), device="cpu",
                   max_active=2, max_len=32)
    with pytest.raises(NotImplementedError, match="model level"):
        serve.main(["--arch", "mamba2_370m", "--reduced", "--device", "cpu",
                    "--requests", "1"])
