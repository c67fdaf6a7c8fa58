"""The port's RG-LRU block and the RecurrentGemma hybrid (reduced), held to
the JAX package on the CPU.

Inputs are made with numpy from a seed; weights come from the JAX
package's ``init_rglru`` / ``init_params``.  Everything runs in fp32
unless a test says otherwise.  Tolerances: single functions
(``_block_diag``, ``_gates``, ``rglru_fwd``, ``rglru_decode``, the scan)
atol/rtol 1e-5 (the log-depth scan combines the same products in another
tree than ``jax.lax.associative_scan``, and the einsums sum in other
orders); whole forwards (prefill logits, the caches) atol/rtol 1e-4, as
``test_torch_model.py`` holds them (differences add up over the layers);
tokens, positions, bf16 bits and sampling state exactly.

The reference's prefill conv cache ``uraw[:, S-(K-1):]`` is too short for
S < K-1 = 3; the port left-pads it with zeros, as stepwise decode from a
zero cache holds it, and is held to that.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as JR
from repro.models import transformer as JT
from repro_torch.launch.model_level import generate
from repro_torch.models import rglru as TR
from repro_torch.models import transformer as TT
from repro_torch.runtime.engine import NodeEngine
from test_torch_window import (AXES, FWD_TOL, TOL, _cfgs, _jax_decode_cache,
                               _params, _teacher_forced, _tokens,
                               check_pages)

ARCH = "recurrentgemma_2b"


def _block(jcfg, seed=1):
    """One RG-LRU block's JAX ``init_rglru`` as numpy and as tensors."""
    np_p = jax.tree.map(np.asarray,
                        JR.init_rglru(jcfg, jax.random.PRNGKey(seed)))
    return np_p, {k: torch.from_numpy(np.array(v)) for k, v in np_p.items()}


def _x(jcfg, B, S, seed=2):
    return (np.random.default_rng(seed).standard_normal(
        (B, S, jcfg.d_model)) * 0.5).astype(np.float32)


def test_block_diag_and_gates_match():
    """The block-diagonal gate projection (16 blocks) and the fp32 gates
    (a, b) on the same inputs."""
    jcfg, _ = _cfgs(ARCH)
    np_p, tp = _block(jcfg)
    u = np.random.default_rng(3).standard_normal(
        (2, 10, jcfg.lru_width)).astype(np.float32)
    got = TR._block_diag(torch.from_numpy(u), tp["Wa"], tp["ba"])
    want = JR._block_diag(jnp.asarray(u), jnp.asarray(np_p["Wa"]),
                          jnp.asarray(np_p["ba"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ga, gb = TR._gates(tp, torch.from_numpy(u))
    wa, wb = JR._gates(jax.tree.map(jnp.asarray, np_p), jnp.asarray(u))
    assert ga.dtype == gb.dtype == torch.float32
    assert ((ga > 0) & (ga < 1)).all()
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), **TOL)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), **TOL)


@pytest.mark.parametrize("S", [1, 7, 64, 100])
def test_linear_scan_matches_associative_scan_and_a_loop(S):
    """The log-depth scan against ``jax.lax.associative_scan`` with the
    reference's combine, and against the step-by-step recurrence."""
    r = np.random.default_rng(S)
    a = r.uniform(0.5, 1.0, (2, S, 16)).astype(np.float32)
    b = r.standard_normal((2, S, 16)).astype(np.float32)

    def combine(e1, e2):
        return e1[0] * e2[0], e1[1] * e2[0] + e2[1]

    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                 jnp.asarray(b)), axis=1)
    got = TR.linear_scan(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    h, loop = np.zeros((2, 16), np.float32), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        loop.append(h)
    np.testing.assert_allclose(got, np.stack(loop, 1), **TOL)


@pytest.mark.parametrize("S", [3, 16, 100])
def test_rglru_fwd_and_its_cache_match(S):
    """The full-sequence block's output and its decode cache (the fp32
    state and the last K-1 raw projections)."""
    jcfg, tcfg = _cfgs(ARCH)
    np_p, tp = _block(jcfg)
    x = _x(jcfg, 2, S)
    jo, jc = JR.rglru_fwd(jcfg, jax.tree.map(jnp.asarray, np_p),
                          jnp.asarray(x), return_state=True)
    to, tc = TR.rglru_fwd(tcfg, tp, torch.from_numpy(x), return_state=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    assert tc["state"].dtype == torch.float32
    for n in ("state", "conv"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), **TOL)


def test_rglru_decode_three_steps_match():
    """Three one-token steps from a prefilled cache; the port writes the
    cache in place."""
    jcfg, tcfg = _cfgs(ARCH)
    np_p, tp = _block(jcfg)
    jp = jax.tree.map(jnp.asarray, np_p)
    x = _x(jcfg, 2, 12)
    _, jc = JR.rglru_fwd(jcfg, jp, jnp.asarray(x[:, :9]), return_state=True)
    _, tc = TR.rglru_fwd(tcfg, tp, torch.from_numpy(x[:, :9]),
                         return_state=True)
    for t in range(9, 12):
        jo, jc = JR.rglru_decode(jcfg, jp, jnp.asarray(x[:, t:t + 1]), jc)
        state = tc["state"]
        to, tc2 = TR.rglru_decode(tcfg, tp, torch.from_numpy(x[:, t:t + 1]),
                                  tc)
        assert tc2 is tc and tc["state"] is state
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        for n in ("state", "conv"):
            np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                       **TOL)


def test_conv_cache_at_s2_is_left_padded():
    """A 2-token prefill: the port's conv cache is (B, 3, W), a zero row
    then the two raw projections, what two decode steps from a zero cache
    leave, with the same state; the reference's slice ``uraw[:, -1:]``
    keeps one row only."""
    jcfg, tcfg = _cfgs(ARCH)
    np_p, tp = _block(jcfg)
    x = _x(jcfg, 2, 2)
    _, jc = JR.rglru_fwd(jcfg, jax.tree.map(jnp.asarray, np_p),
                         jnp.asarray(x), return_state=True)
    assert jc["conv"].shape[1] == 1
    _, tc = TR.rglru_fwd(tcfg, tp, torch.from_numpy(x), return_state=True)
    step = TR.init_rglru_cache(tcfg, 2, torch.float32, "cpu")
    for t in range(2):
        TR.rglru_decode(tcfg, tp, torch.from_numpy(x[:, t:t + 1]), step)
    assert tc["conv"].shape == (2, 3, tcfg.lru_width)
    assert not tc["conv"][:, 0].any()
    np.testing.assert_allclose(tc["conv"].numpy(), step["conv"].numpy(),
                               **TOL)
    np.testing.assert_allclose(tc["state"].numpy(), step["state"].numpy(),
                               **TOL)


def test_embedding_scale_rounds_to_bf16_first():
    """The gemma embedding scale: sqrt(2560) = 50.596... is rounded to
    bf16 (50.5) before the product, and the port's bf16 embeddings equal
    the JAX package's bit for bit."""
    jcfg, tcfg = (dataclasses.replace(c, d_model=2560) for c in
                  _cfgs(ARCH))
    jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16") for c in
                  (jcfg, tcfg))
    r = np.random.default_rng(4)
    emb = (r.standard_normal((64, 2560)) * 0.01).astype(np.float32)
    jemb = jnp.asarray(emb, jnp.bfloat16)
    temb = torch.from_numpy(emb).to(torch.bfloat16)
    toks = r.integers(0, 64, (2, 5), dtype=np.int32)
    want = JT._embed_tokens(jcfg, {"embed": jemb}, jnp.asarray(toks))
    got = TT._embed_tokens(tcfg, {"embed": temb}, torch.from_numpy(toks))
    assert float(torch.tensor(2560 ** 0.5, dtype=torch.bfloat16)) == 50.5
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy(),
        np.asarray(want).view(np.int16))
    np.testing.assert_array_equal(
        got.float().numpy(), (temb[toks].float() * 50.5).to(
            torch.bfloat16).float().numpy())


def test_softcapped_logits_match():
    """``logits_fn`` caps the logits at 30 with tanh, as the reference."""
    jcfg, tcfg = _cfgs(ARCH)
    r = np.random.default_rng(5)
    # logits of std ~11 (some past the cap): fp32 sums of 128 products
    h = r.standard_normal((2, 3, 128)).astype(np.float32)
    head = r.standard_normal((128, 512)).astype(np.float32)
    got = TT.logits_fn(tcfg, {"lm_head": torch.from_numpy(head)},
                       torch.from_numpy(h))
    want = JT.logits_fn(jcfg, {"lm_head": jnp.asarray(head)}, jnp.asarray(h))
    raw = torch.from_numpy(h) @ torch.from_numpy(head)
    assert got.abs().max() <= 30.0 < raw.abs().max()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_params_from_numpy_round_trips_the_hybrid_tree():
    """The JAX tree's ``units.b0..b2`` stacks (8 units of (rec, rec, attn)
    at full depth: 26 layers = 8 units + 2 tail rec layers) and its
    ``tail`` arrive with their keys, shapes and values, ``lam`` fp32; the
    port's own draw has the same shapes and dtypes, and the counts agree
    with the JAX package's."""
    jcfg, tcfg = _cfgs(ARCH)
    np_params = jax.tree.map(np.asarray,
                             JT.init_params(jcfg, jax.random.PRNGKey(0)))
    got = TT.params_from_numpy(np_params, tcfg, device="cpu")
    own = TT.init_params(tcfg, seed=1, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(np_params)[0]
    assert len(flat) == len(jax.tree.leaves(own))
    for path, leaf in flat:
        keys = [k.key for k in path]
        t = got
        o = own
        for k in keys:
            t, o = t[k], o[k]
        np.testing.assert_array_equal(t.numpy(), leaf)
        assert tuple(o.shape) == leaf.shape and o.dtype == t.dtype
    assert got["units"]["b0"]["t"]["lam"].dtype == torch.float32
    assert set(got["units"]) == {"b0", "b1", "b2"}
    assert set(got["units"]["b2"]["t"]) == {"wq", "wk", "wv", "wo"}
    assert TT.param_count(tcfg) == JT.param_count(jcfg)
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config
    assert TT._hybrid_counts(get_config(ARCH)) == (8, 2)
    assert TT.param_count(get_config(ARCH)) == JT.param_count(jget(ARCH))


def test_init_cache_has_the_jax_layout():
    """``init_cache`` at max_len 40: the units' RG-LRU states (fp32) and
    conv rows, the attention position's ring of min(64, 40) slots empty
    (positions -1), the tail's states: the JAX package's keys, shapes and
    dtypes."""
    jcfg, tcfg = _cfgs(ARCH)
    want = JT.init_cache(jcfg, 3, 40)
    got = TT.init_cache(tcfg, 3, 40, "cpu")
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(jax.tree.leaves(got))
    for path, leaf in flat:
        t = got
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype)[6:] == str(leaf.dtype)
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


@pytest.mark.parametrize("S", [2, 48, 100])
def test_prefill_logits_and_cache_match(S):
    """Prefill's last-position logits and its cache (RG-LRU states and
    conv rows, the local attention's ring of min(64, S) slots); at S = 2
    the reference keeps the last conv row only, and the port holds a zero
    row before its two."""
    jcfg, tcfg = _cfgs(ARCH)
    jparams, tparams = _params(jcfg, tcfg)
    toks = _tokens(jcfg, 2, S)
    jlog, jc = JT.prefill(jcfg, AXES, jparams, {"tokens": jnp.asarray(toks)})
    tlog, tc = TT.prefill(tcfg, tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **FWD_TOL)
    assert np.abs(np.asarray(jlog)).max() <= 30.0
    for path, leaf in jax.tree_util.tree_flatten_with_path(jc)[0]:
        t = tc
        for k in path:
            t = t[k.key]
        t = t.numpy()
        if path[-1].key == "conv" and S < 3:     # JAX keeps the last row
            assert leaf.shape[-2] == 1 and not t[..., :3 - S, :].any()
            t = t[..., 2:, :]
        if path[-1].key == "pos":
            np.testing.assert_array_equal(t, np.asarray(leaf))
        else:
            np.testing.assert_allclose(t, np.asarray(leaf), **FWD_TOL)


@pytest.mark.parametrize("S,steps", [(48, 40), (2, 30), (100, 20)],
                         ids=["S48_wraps", "S2_conv_padded",
                              "S100_past_window"])
def test_generate_matches_jax_and_the_teacher_forced_forward(S, steps):
    """``generate`` on the reduced hybrid gives JAX's tokens (prefill, the
    ring re-laid into 64 slots, one ``decode_page``) and the argmax of the
    JAX teacher-forced forward, past the ring's wrap and from a prompt
    longer than the window; at S = 2 JAX's own conv rows are too short, so
    there the port is held to the teacher-forced forward only."""
    jcfg, tcfg = _cfgs(ARCH)
    jparams, tparams = _params(jcfg, tcfg)
    B = 2
    toks = _tokens(jcfg, B, S)
    got = generate(tcfg, tparams, toks.tolist(), steps + 1)
    np.testing.assert_array_equal(
        np.asarray(got.tokens), _teacher_forced(jcfg, jparams, toks,
                                                got.tokens))
    if S < 3:
        return
    jlog, jpc = JT.prefill(jcfg, AXES, jparams, {"tokens": jnp.asarray(toks)})
    cur = jnp.argmax(jlog[:, 0], axis=-1).astype(jnp.int32)
    jcache = _jax_decode_cache(jcfg, jpc, B, S + steps + 1)
    blk, *_ = JT.decode_page(jcfg, AXES, jparams, jcache, cur,
                             jnp.full((B,), S, jnp.int32),
                             jnp.full((B,), steps, jnp.int32), steps)
    jax_rows = np.concatenate([np.asarray(cur)[None], np.asarray(blk)]).T
    assert got.tokens == jax_rows.tolist()


# (sampled, lp_k)
PAGE_VARIANTS = [(False, None), (False, 3), (True, None), (True, 2)]


@pytest.mark.parametrize("sampled,lp_k", PAGE_VARIANTS,
                         ids=["greedy", "greedy_lp3", "sampled",
                              "sampled_lp2"])
def test_decode_pages_match_jax_across_the_wrap(sampled, lp_k):
    """Two pages of 8 steps from a 56-token prompt in both packages
    (positions 56..71 cross the local window's wrap at 64): identical
    token blocks or planes, countdowns, sampling state and ring
    positions."""
    check_pages(ARCH, 56, 96, 16, 8, sampled, lp_k)


def test_generate_sampled_streams_repeat():
    """The model card's sampling (T 1.0, top-k 64, top-p 0.95) with a seed
    a row and top-5 logprobs: two runs give the same streams and
    planes."""
    from repro_torch.configs import default_sampling
    jcfg, tcfg = _cfgs(ARCH)
    _, tparams = _params(jcfg, tcfg)
    toks = _tokens(jcfg, 3, 40)
    sps = [default_sampling(ARCH, seed=i) for i in range(3)]
    runs = [generate(tcfg, tparams, toks.tolist(), 20, sampling=sps,
                     lp_k=5) for _ in range(2)]
    assert runs[0].tokens == runs[1].tokens
    assert runs[0].logprobs == runs[1].logprobs
    chosen, vals, ids = runs[0].logprobs[0]
    assert len(chosen) == 20 and all(len(v) == 5 for v in vals)


def test_engines_refuse_the_hybrid():
    """Both packages' ``NodeEngine`` refuse the hybrid; the port's names
    model level."""
    from repro.runtime.engine import NodeEngine as JEngine
    jcfg, tcfg = _cfgs(ARCH)
    with pytest.raises(AssertionError):
        JEngine(jcfg, max_active=2, max_len=32)
    with pytest.raises(NotImplementedError, match="model level"):
        NodeEngine(tcfg, device="cpu", max_active=2, max_len=32)
    with pytest.raises(NotImplementedError, match="model level"):
        TT.check_served(tcfg)
