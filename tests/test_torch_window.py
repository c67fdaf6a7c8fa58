"""The port's sliding-window decoder (H2O-Danube-1.8B, reduced) and the
flash kernel's plain version at head dims 80 and 256, held to the JAX
package on the CPU.

Inputs are made with numpy from a seed; weights come from the JAX
package's ``init_params``.  Everything runs in fp32.  Tolerances: the
plain flash against JAX's ``models.flash`` and the Pallas kernel in
interpret mode atol/rtol 1e-5 (the same fp32 softmax, summed in other
orders); whole forwards (prefill logits, the rings' K/V) atol/rtol 1e-4,
as ``test_torch_model.py`` holds them (the two frameworks' summation
orders differ in every layer, and the differences add up over the
layers); tokens, positions and sampling state exactly.

A windowed prefill leaves the reference's ring of min(window, S) slots.
Decode continues from ``init_cache``'s ring of min(window, max_len)
slots: the port re-lays the prefill's ring into it (``install_ring``),
and the JAX side here re-lays its own ring the same way with an
independent numpy loop (``_relay``), so both packages decode from the
same layout.  Decoding from the reference's prefill ring as it is drops
position 0 while it is still in the window (the last test shows it); the
port is held to the teacher-forced forward, not to that.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.configs import reduced_config as j_reduced
from repro.kernels.flash_attention.flash_attention import flash_attention_tpu
from repro.models import flash as jflash
from repro.models import transformer as JT
from repro.models.api import MeshAxes
from repro_torch import configs as torch_configs
from repro_torch import kernels
from repro_torch.configs import reduced_config
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.launch.model_level import generate
from repro_torch.models import transformer as TT
from repro_torch.runtime.engine import NodeEngine

AXES = MeshAxes()
TOL = dict(atol=1e-5, rtol=1e-5)
FWD_TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "h2o_danube_1_8b"


def _cfgs(arch=ARCH, **over):
    """The same reduced fp32 config in both packages."""
    return (dataclasses.replace(j_reduced(arch), dtype="float32", **over),
            dataclasses.replace(reduced_config(arch), dtype="float32",
                                **over))


def _params(jcfg, tcfg, seed=0):
    """JAX ``init_params`` as JAX arrays and as the port's tensors."""
    np_params = jax.tree.map(np.asarray,
                             JT.init_params(jcfg, jax.random.PRNGKey(seed)))
    return (jax.tree.map(jnp.asarray, np_params),
            TT.params_from_numpy(np_params, tcfg, device="cpu"))


def _tokens(jcfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(2, jcfg.vocab_size, (B, S),
                                                dtype=np.int32)


def _rings(tree, path=()):
    """(path, ring) of every {"k", "v", "pos"} dict in a cache tree."""
    if "pos" in tree:
        yield path, tree
        return
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _rings(v, path + (k,))


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _relay(src, dst):
    """numpy: each valid slot of the prefill ring ``src`` (positions p >= 0,
    the newest Wd of them) into slot p % Wd of the empty ring ``dst``
    (leaves with the same leading axes; Wd its slot count)."""
    out = {n: np.array(a) for n, a in dst.items()}
    pos = np.asarray(src["pos"])
    Wd = out["pos"].shape[-1]
    for idx in np.ndindex(pos.shape[:-1]):
        newest = pos[idx].max()
        for s, p in enumerate(pos[idx]):
            if p >= 0 and p > newest - Wd:
                out["pos"][idx + (p % Wd,)] = p
                for n in ("k", "v"):
                    out[n][idx + (p % Wd,)] = np.asarray(src[n])[idx + (s,)]
    return out


def _jax_decode_cache(jcfg, jcache, B, max_len):
    """JAX ``init_cache`` with every prefill ring re-laid into it by
    ``_relay`` and the other leaves (RG-LRU states) as the prefill left
    them."""
    cache = jax.tree.map(np.asarray, JT.init_cache(jcfg, B, max_len))
    for path, ring in _rings(jcache):
        laid = _relay(ring, _get(cache, path))
        parent = _get(cache, path[:-1]) if path else None
        if parent is None:
            cache = laid
        else:
            parent[path[-1]] = laid
    for path, leaf in jax.tree_util.tree_flatten_with_path(jcache)[0]:
        keys = [k.key for k in path]
        if keys[-1] in ("state", "conv"):
            _get(cache, keys[:-1])[keys[-1]] = np.asarray(leaf)
    return jax.tree.map(jnp.asarray, cache)


def _teacher_forced(jcfg, jparams, toks, gen):
    """Argmax of the JAX forward over prompt + generated tokens at every
    position from the prompt's last: what greedy decode must give."""
    full = np.concatenate([toks, np.asarray(gen, np.int32)[:, :-1]], 1)
    h, _, _ = JT._backbone(jcfg, AXES, jparams,
                           {"tokens": jnp.asarray(full)}, None, False, False)
    logits = JT.logits_fn(jcfg, jparams, h)
    return np.asarray(jnp.argmax(logits[:, toks.shape[1] - 1:], axis=-1))


def check_pages(arch, S0, max_len, steps, P, sampled, lp_k, seed=9):
    """``decode_page``s of P steps (``steps`` in all) in both packages
    from the same decode cache (each package's prefill rings re-laid for
    ``max_len``), greedy or sampled (the JAX sampling kernel in interpret
    mode), with or without logprob planes: identical token blocks (plane
    token columns and top ids), planes within 1e-5, equal countdowns and
    sampling state.  One slot finishes mid-page and one is never live."""
    from repro import sampling as JS
    from repro_torch import sampling as TS

    jcfg, tcfg = _cfgs(arch)
    jparams, tparams = _params(jcfg, tcfg)
    B, V = 4, TT.padded_vocab(tcfg)
    toks = _tokens(jcfg, B, S0, seed)
    jlog, jpc = JT.prefill(jcfg, AXES, jparams, {"tokens": jnp.asarray(toks)})
    first = np.argmax(np.asarray(jlog)[:, 0], axis=-1).astype(np.int32)
    jcache = _jax_decode_cache(jcfg, jpc, B, max_len)
    _, tpc = TT.prefill(tcfg, tparams, torch.from_numpy(toks))
    tcache = TT.install_rings(tcfg, TT.init_cache(tcfg, B, max_len, "cpu"),
                              tpc)
    lengths = np.full((B,), S0, np.int32)
    remaining = np.array([steps, steps - 5, steps, 0], np.int32)
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
            {k: torch.from_numpy(v) for k, v in packed.items()
             if k != "seed"},
            {"base_key": TS.base_keys(st["seed"], "cpu"),
             **{n: torch.from_numpy(st[n]) for n in
                ("gen_count", "counts", "prompt_counts")}}))
    jstate = tuple(map(jnp.asarray, (first, lengths, remaining)))
    tstate = tuple(map(torch.from_numpy, (first.copy(), lengths.copy(),
                                          remaining.copy())))
    blocks = []
    for _ in range(steps // P):
        jout = JT.decode_page(jcfg, AXES, jparams, jcache, *jstate, P, **jkw)
        tout = TT.decode_page(tcfg, tparams, tcache, *tstate, P, **tkw)
        jblk, tblk = np.asarray(jout[0]), tout[0].numpy()
        if lp_k is None:
            np.testing.assert_array_equal(tblk, jblk)
            blocks.append(tblk)
        else:
            jt, jc, jv, ji = JT.unpack_logprob_block(jblk)
            tt, tc, tv, ti = TT.unpack_logprob_block(tblk)
            np.testing.assert_array_equal(tt, jt)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_allclose(tc, jc, **TOL)
            np.testing.assert_allclose(tv, jv, **TOL)
            blocks.append(tt)
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
    for path, ring in _rings(tcache):
        np.testing.assert_array_equal(ring["pos"].numpy(),
                                      np.asarray(_get(jcache, path)["pos"]))
    return toks, first, np.concatenate(blocks), jcfg, jparams


# ------------------------------------------------------------ configs


@pytest.mark.parametrize("arch", [ARCH, "recurrentgemma_2b"])
def test_configs_and_sampling_defaults_match_jax(arch):
    """The port's config files are copies of the JAX package's: the same
    published and reduced configs (window 64; the hybrid's 5 layers with
    lru_width 128) and the same model-card sampling."""
    assert arch in torch_configs.ARCH_IDS
    assert dataclasses.asdict(torch_configs.get_config(arch)) == \
        dataclasses.asdict(jax_configs.get_config(arch))
    jcfg, tcfg = j_reduced(arch), reduced_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert torch_configs.SAMPLING_DEFAULTS[arch] == \
        jax_configs.SAMPLING_DEFAULTS[arch]
    assert dataclasses.asdict(torch_configs.default_sampling(arch)) == \
        dataclasses.asdict(jax_configs.default_sampling(arch))
    if arch == ARCH:
        assert tcfg.sliding_window == 64 and tcfg.head_dim == 32
    else:
        assert (tcfg.local_window, tcfg.num_layers, tcfg.lru_width) == \
            (64, 5, 128)


# ------------------------------------------------- flash, plain version

# (window, softcap): Danube's window, RecurrentGemma's softcap, both
FLASH_MASKS = [(0, 0.0), (48, 0.0), (48, 30.0), (0, 30.0)]


@pytest.mark.parametrize("window,softcap", FLASH_MASKS,
                         ids=[f"w{w}_cap{int(c)}" for w, c in FLASH_MASKS])
@pytest.mark.parametrize("D,H,Hkv", [(80, 4, 2), (256, 5, 1)],
                         ids=["d80_gqa2", "d256_mqa5"])
def test_plain_flash_at_head_dims_80_and_256(D, H, Hkv, window, softcap):
    """The wrapper on CPU tensors (its plain version, no launch) against
    JAX's ``models.flash`` at head dims 80 (GQA, Danube) and 256 (MQA,
    RecurrentGemma), windowed and softcapped; without softcap also
    against the Pallas kernel in interpret mode, as
    ``tests/test_kernels.py`` runs it (the Pallas kernel has no softcap)."""
    r = np.random.default_rng(D + window)
    B, S = 2, 128
    q = r.standard_normal((B, S, H, D)).astype(np.float32)
    k = r.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = r.standard_normal((B, S, Hkv, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    kernels.reset_launches()
    got = flash_attention(*map(torch.from_numpy, (q, k, v, pos, pos)),
                          window=window, softcap=softcap).numpy()
    assert kernels.launches()["flash_attention"] == 0
    assert got.shape == (B, S, H, D)
    want = jflash.flash_attention((True, window, 64, softcap),
                                  *map(jnp.asarray, (q, k, v, pos, pos)))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    if softcap == 0:
        pallas = flash_attention_tpu(*map(jnp.asarray, (q, k, v)),
                                     causal=True, window=window, block_q=64,
                                     block_k=64, interpret=True)
        np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


# ----------------------------------------------------- prefill and rings


@pytest.mark.parametrize("S", [48, 100], ids=["S48_in_window",
                                             "S100_past_window"])
def test_prefill_logits_and_rings_match_jax(S):
    """Prefill's last-position logits and its rings, min(64, S) slots a
    layer, as the JAX package lays them out (slot = position % slots)."""
    jcfg, tcfg = _cfgs()
    jparams, tparams = _params(jcfg, tcfg)
    toks = _tokens(jcfg, 2, S)
    jlog, jc = JT.prefill(jcfg, AXES, jparams, {"tokens": jnp.asarray(toks)})
    tlog, tc = TT.prefill(tcfg, tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **FWD_TOL)
    assert set(tc) == set(jc) == {"k", "v", "pos"}
    Wc = min(64, S)
    assert tc["k"].shape == (tcfg.num_layers, 2, Wc, 2, 32)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   **FWD_TOL)


# (S, max_len): a ring wider than the prompt, a prompt past the window,
# a ring narrower than the window
INSTALL_CASES = [(48, 88), (100, 120), (48, 56)]


@pytest.mark.parametrize("S,max_len", INSTALL_CASES,
                         ids=[f"S{s}_max{m}" for s, m in INSTALL_CASES])
def test_install_ring_lays_out_init_cache(S, max_len):
    """``install_ring`` puts the prefill's ring into ``init_cache``'s ring
    of min(window, max_len) slots, each of the newest positions p at slot
    p % slots, the other slots empty (zeros, position -1): the JAX
    package's ``init_cache`` shapes and dtypes, filled by ``_relay``'s
    numpy loop from the JAX prefill's ring."""
    jcfg, tcfg = _cfgs()
    jparams, tparams = _params(jcfg, tcfg)
    toks = _tokens(jcfg, 2, S)
    _, jc = JT.prefill(jcfg, AXES, jparams, {"tokens": jnp.asarray(toks)})
    _, tc = TT.prefill(tcfg, tparams, torch.from_numpy(toks))
    empty = JT.init_cache(jcfg, 2, max_len)
    want = _relay(jc, empty)
    got = TT.install_ring(TT.init_cache(tcfg, 2, max_len, "cpu"), tc)
    for n in ("k", "v", "pos"):
        assert tuple(got[n].shape) == empty[n].shape
        assert str(got[n].dtype)[6:] == str(empty[n].dtype)
    np.testing.assert_array_equal(got["pos"].numpy(), want["pos"])
    Wd = min(64, max_len)
    assert sorted(got["pos"][0, 0].tolist()) == \
        [-1] * (Wd - min(Wd, S)) + list(range(S - min(Wd, S), S))
    for n in ("k", "v"):
        np.testing.assert_allclose(got[n].numpy(), want[n], **FWD_TOL)
        assert not got[n][got["pos"] < 0].any()


# ----------------------------------------------------------------- decode

# (sampled, lp_k)
PAGE_VARIANTS = [(False, None), (False, 3), (True, None), (True, 2)]


@pytest.mark.parametrize("sampled,lp_k", PAGE_VARIANTS,
                         ids=["greedy", "greedy_lp3", "sampled",
                              "sampled_lp2"])
def test_decode_pages_match_jax_across_the_wrap(sampled, lp_k):
    """From a 56-token prompt, two pages of 8 steps in both packages from
    the re-laid rings of 64 slots: positions 56..71 cross the window's
    wrap at 64 (slot 0 takes position 64 once position 0 has left the
    window).  Greedy pages also run past it from a 48-token prompt: 40
    steps in 5 pages."""
    check_pages(ARCH, 56, 96, 16, 8, sampled, lp_k)
    if not sampled and lp_k is None:
        check_pages(ARCH, 48, 96, 40, 8, False, None)


@pytest.mark.parametrize("S,steps", [(48, 40), (100, 20)],
                         ids=["S48_wraps", "S100_past_window"])
def test_generate_matches_jax_and_the_teacher_forced_forward(S, steps):
    """``generate`` (prefill, the first token, rings installed, pages of
    16) gives JAX's tokens (prefill, rings re-laid, ``decode_page``) and
    the argmax of the JAX teacher-forced forward at every position, past
    the ring's wrap; the prompt of 100 is longer than the window."""
    jcfg, tcfg = _cfgs()
    jparams, tparams = _params(jcfg, tcfg)
    B = 2
    toks = _tokens(jcfg, B, S)
    got = generate(tcfg, tparams, toks.tolist(), steps + 1)
    assert got.pages == -(-steps // 16)
    jlog, jpc = JT.prefill(jcfg, AXES, jparams, {"tokens": jnp.asarray(toks)})
    cur = jnp.argmax(jlog[:, 0], axis=-1).astype(jnp.int32)
    jcache = _jax_decode_cache(jcfg, jpc, B, S + steps + 1)
    blk, *_ = JT.decode_page(jcfg, AXES, jparams, jcache, cur,
                             jnp.full((B,), S, jnp.int32),
                             jnp.full((B,), steps, jnp.int32), steps)
    jax_rows = np.concatenate([np.asarray(cur)[None], np.asarray(blk)]).T
    assert got.tokens == jax_rows.tolist()
    np.testing.assert_array_equal(
        np.asarray(got.tokens), _teacher_forced(jcfg, jparams, toks,
                                                got.tokens))


def test_generate_sampled_streams_repeat():
    """The model card's sampling (T 0.7, top-p 0.95) with a seed a row and
    top-3 logprobs: two runs give the same streams and planes."""
    from repro_torch.configs import default_sampling
    jcfg, tcfg = _cfgs()
    _, tparams = _params(jcfg, tcfg)
    toks = _tokens(jcfg, 3, 48)
    sps = [default_sampling(ARCH, seed=i) for i in range(3)]
    runs = [generate(tcfg, tparams, toks.tolist(), 24, sampling=sps,
                     lp_k=3) for _ in range(2)]
    assert runs[0].tokens == runs[1].tokens
    assert runs[0].logprobs == runs[1].logprobs
    assert [len(t) for t in runs[0].tokens] == [24] * 3


def test_reference_prefill_ring_drops_position_zero():
    """The reference defect the port repairs: decoding straight from the
    JAX prefill's ring (min(window, S) = 16 slots) writes position 16 into
    slot 0 while position 0 is still inside the window of 64, so the JAX
    tokens leave the teacher-forced forward; the port's ``generate`` (the
    ring re-laid into min(64, S + 7) = 23 slots) stays on it."""
    jcfg, tcfg = _cfgs()
    jparams, tparams = _params(jcfg, tcfg)
    B, S, steps = 2, 16, 6
    toks = _tokens(jcfg, B, S)
    jlog, jpc = JT.prefill(jcfg, AXES, jparams, {"tokens": jnp.asarray(toks)})
    assert jpc["pos"].shape[-1] == S
    cur = jnp.argmax(jlog[:, 0], axis=-1).astype(jnp.int32)
    blk, _, _, _, jcache = JT.decode_page(
        jcfg, AXES, jparams, jpc, cur, jnp.full((B,), S, jnp.int32),
        jnp.full((B,), steps, jnp.int32), steps)
    pos = np.asarray(jcache["pos"])
    # positions 16..21 went to slots 0..5: 0..5 evicted, inside the window
    assert (pos[:, :, 0] == S).all() and 0 not in pos
    jax_rows = np.concatenate([np.asarray(cur)[None], np.asarray(blk)]).T
    got = generate(tcfg, tparams, toks.tolist(), steps + 1)
    oracle = _teacher_forced(jcfg, jparams, toks, got.tokens)
    np.testing.assert_array_equal(np.asarray(got.tokens), oracle)
    assert (jax_rows != oracle).any()


def test_engines_refuse_windowed_decoders_and_later_families():
    """``NodeEngine`` serves no sliding window in either package (the port
    names model level); the later families, Whisper and Pixtral, pass the
    port's ``check_model`` and are refused by ``check_served`` with a
    pointer to model-level serving."""
    from repro.runtime.engine import NodeEngine as JEngine
    jcfg, tcfg = _cfgs()
    with pytest.raises(AssertionError):
        JEngine(jcfg, max_active=2, max_len=32)
    with pytest.raises(NotImplementedError, match="model level"):
        NodeEngine(tcfg, device="cpu", max_active=2, max_len=32)
    for arch in ("whisper_base", "pixtral_12b"):
        cfg = torch_configs.get_config(arch)
        TT.check_model(cfg)
        with pytest.raises(NotImplementedError, match="model_level.py"):
            TT.check_served(cfg)
    dense = dataclasses.replace(reduced_config("llama3_2_1b"),
                                dtype="float32")
    with pytest.raises(NotImplementedError, match="NodeEngine"):
        generate(dense, TT.init_params(dense, device="cpu"), [[3, 4]], 2)
