"""The port's encoder-decoder (Whisper-base, reduced) held to the JAX package
on the CPU: LayerNorm, sinusoid positions, the cross-attention source, the
plain flash kernel non-causal at Sq != Skv, the encoder, prefill, decode
steps (self-attention and cross-attention through ``paged_attention``'s
plain version) and model-level serving through ``generate``.

Reduced ``whisper_base`` in fp32: 2 encoder and 2 decoder layers, d_model
128, 4 query heads on 2 kv heads of 32, d_ff 256, vocab 512, 32 stub
frames.  Weights come from the JAX package's ``init_params`` and reach the
port through ``params_from_numpy``; frames (at ``frontend_stub``'s 0.02
scale), tokens and other inputs are made with numpy from a seed.
Tolerances, as ``test_torch_window.py`` holds them: single functions and
the kernels' plain versions atol/rtol 1e-5 (the same fp32 operations,
summed in other orders); whole forwards (the encoder's states, prefill
logits, caches) atol/rtol 1e-4 (the differences add up over the layers);
tokens, top ids and sampling state exactly, logprobs 1e-5.

``jax_generate`` is the JAX side of ``generate``: JAX ``prefill``, its
cache put into JAX ``init_cache`` as ``tests/test_models.py`` installs it,
the first token by argmax or JAX ``sample`` (the Pallas sampling kernel in
interpret mode), then JAX ``decode_page``s; ``test_torch_vlm.py`` shares
it.
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
from repro.models import layers as jl
from repro.models import transformer as JT
from repro.models.api import MeshAxes
from repro_torch import configs as torch_configs
from repro_torch import kernels
from repro_torch.configs import reduced_config
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.launch.model_level import generate
from repro_torch.models import layers as tl
from repro_torch.models import transformer as TT
from repro_torch.runtime.engine import NodeEngine
from repro_torch.sampling import SamplingParams

AXES = MeshAxes()
TOL = dict(atol=1e-5, rtol=1e-5)
FWD_TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "whisper_base"


def cfgs(arch=ARCH):
    """The same reduced fp32 config in both packages."""
    return (dataclasses.replace(j_reduced(arch), dtype="float32"),
            dataclasses.replace(reduced_config(arch), dtype="float32"))


def params(jcfg, tcfg, seed=0):
    """JAX ``init_params`` as JAX arrays and as the port's tensors."""
    np_params = jax.tree.map(np.asarray,
                             JT.init_params(jcfg, jax.random.PRNGKey(seed)))
    return (jax.tree.map(jnp.asarray, np_params),
            TT.params_from_numpy(np_params, tcfg, device="cpu"))


def tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(2, cfg.vocab_size, (B, S),
                                                dtype=np.int32)


def stub(cfg, B, n, seed=1):
    """Stub frame or patch embeddings (B, n, D) at ``frontend_stub``'s
    scale."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, n, cfg.d_model)) * 0.02).astype(
        np.float32)


def sampled_params(B, V):
    """Mixed SamplingParams a row: greedy, top-k, top-p with stop tokens,
    penalties."""
    sps = [SamplingParams(),
           SamplingParams(temperature=0.8, top_k=20, seed=1),
           SamplingParams(temperature=1.1, top_p=0.9, seed=2,
                          stop=tuple(range(0, V, V // 8))),
           SamplingParams(temperature=0.7, repetition_penalty=1.3,
                          presence_penalty=0.2, seed=3)]
    return sps[:B]


def _planes(block, lp_k):
    """A (steps, B, 2 + 2K) plane as per-row (chosen, values, ids)."""
    _, c, v, i = JT.unpack_logprob_block(np.asarray(block))
    return [(c[:, b].tolist(), [] if v is None else v[:, b].tolist(),
             [] if i is None else i[:, b].tolist())
            for b in range(block.shape[1])]


def jax_generate(jcfg, jparams, toks, want, extra, sps=None, lp_k=None,
                 page_steps=16):
    """``generate``'s work in the JAX package: (tokens a row, logprobs a
    row or None).  ``extra`` holds the JAX batch's frames or patches."""
    from repro import sampling as JS
    from repro_torch import sampling as TS
    B = toks.shape[0]
    want = np.broadcast_to(np.asarray(want, np.int32), (B,)).copy()
    jlog, pc = JT.prefill(jcfg, AXES, jparams,
                          {"tokens": jnp.asarray(toks), **extra})
    S = pc["k"].shape[2]
    max_len = -(-(S + int(want.max())) // 16) * 16
    cache = {n: np.array(a) for n, a in JT.init_cache(jcfg, B,
                                                      max_len).items()}
    for n in ("k", "v"):
        cache[n][:, :, :S] = np.asarray(pc[n])
    for n in ("xk", "xv"):
        if n in pc:
            cache[n] = np.asarray(pc[n])
    cache = {n: jnp.asarray(a) for n, a in cache.items()}
    logits = jlog[:, 0]
    V = logits.shape[-1]
    remaining = want - 1
    kw = {"lp_k": lp_k}
    if sps is None:
        first = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    else:
        packed = JS.pack_params(sps, list(range(B)))
        flags = TS.flags_for(sps, V)
        jflags = JS.SampleFlags("pallas_interpret", flags.pen, flags.kc,
                                flags.mixed, flags.stops)
        rows = {k: jnp.asarray(v) for k, v in packed.items() if k != "seed"}
        st = JS.init_state(packed["seed"], [list(t) for t in toks],
                           [[] for _ in range(B)], V)
        base = JS.base_keys(st["seed"])
        first = JS.sample(logits, jnp.asarray(st["prompt_counts"]),
                          jnp.asarray(st["counts"]), rows,
                          JS.step_keys(base, jnp.zeros((B,), jnp.int32)),
                          jflags)
        for b, sp in enumerate(sps):
            if int(first[b]) in sp.stop:
                remaining[b] = 0
        st = JS.init_state(packed["seed"], [list(t) for t in toks],
                           [[int(t)] for t in np.asarray(first)], V)
        kw.update(flags=jflags, sampling=(rows, {
            "base_key": base, **{n: jnp.asarray(st[n]) for n in
                                 ("gen_count", "counts", "prompt_counts")}}))
    out = [[int(t)] for t in np.asarray(first)]
    lps = None
    if lp_k is not None:
        lps = _planes(JT.pack_logprob_block(first, logits, lp_k)[None],
                      lp_k)
    cur, lengths = first, jnp.full((B,), S, jnp.int32)
    rem = jnp.asarray(remaining)
    while int(rem.max()) > 0:
        res = JT.decode_page(jcfg, AXES, jparams, cache, cur, lengths, rem,
                             page_steps, **kw)
        block, cur, new_len, rem, cache = res[:5]
        if sps is not None:
            kw["sampling"] = (kw["sampling"][0], res[5])
        live = np.asarray(new_len - lengths)
        lengths = new_len
        if lp_k is None:
            for b in range(B):
                out[b] += np.asarray(block)[:live[b], b].tolist()
            continue
        toks_blk = JT.unpack_logprob_block(np.asarray(block))[0]
        for b, (c, v, i) in enumerate(_planes(block, lp_k)):
            out[b] += toks_blk[:live[b], b].tolist()
            lps[b][0].extend(c[:live[b]])
            lps[b][1].extend(v[:live[b]])
            lps[b][2].extend(i[:live[b]])
    return out, lps


def check_generation(got, want_tokens, want_lps):
    """Tokens and top ids exactly, chosen logprobs and top values to
    1e-5."""
    assert got.tokens == want_tokens
    if want_lps is None:
        assert got.logprobs is None
        return
    for (c, v, i), (wc, wv, wi) in zip(got.logprobs, want_lps):
        assert i == wi
        np.testing.assert_allclose(c, wc, **TOL)
        np.testing.assert_allclose(np.asarray(v, np.float32).reshape(-1),
                                   np.asarray(wv, np.float32).reshape(-1),
                                   **TOL)


# ------------------------------------------------------------ configs


@pytest.mark.parametrize("arch", [ARCH, "pixtral_12b"])
def test_configs_match_jax(arch):
    """The port's config files are copies of the JAX package's: the same
    published and reduced configs (32 frames, 8 patches), registered, and
    no model-card sampling (greedy by default) in either package."""
    assert arch in torch_configs.ARCH_IDS
    assert dataclasses.asdict(torch_configs.get_config(arch)) == \
        dataclasses.asdict(jax_configs.get_config(arch))
    jcfg, tcfg = j_reduced(arch), reduced_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert arch not in torch_configs.SAMPLING_DEFAULTS
    assert arch not in jax_configs.SAMPLING_DEFAULTS
    if arch == ARCH:
        assert (tcfg.encoder_seq, tcfg.encoder_layers, tcfg.norm) == \
            (32, 2, "layernorm")
    else:
        assert (tcfg.num_patches, tcfg.family) == (8, "vlm")


# ------------------------------------------------------------- layers


def test_layer_norm_and_sinusoid_positions_match_jax():
    """``layer_norm`` (eps 1e-5, fp32 statistics; also through
    ``apply_norm`` under ``norm="layernorm"``) and ``sinusoid_pos`` at
    decoder, encoder and decode positions, against ``repro.models.layers``."""
    jcfg, tcfg = cfgs()
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 7, 128)) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(128).astype(np.float32)
    b = rng.standard_normal(128).astype(np.float32)
    want = np.asarray(jl.layer_norm(*map(jnp.asarray, (x, w, b))))
    got = tl.layer_norm(*map(torch.from_numpy, (x, w, b)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    via = tl.apply_norm(tcfg, {"w": torch.from_numpy(w),
                               "b": torch.from_numpy(b)},
                        torch.from_numpy(x))
    np.testing.assert_allclose(
        via.numpy(), np.asarray(jl.apply_norm(
            jcfg, {"w": jnp.asarray(w), "b": jnp.asarray(b)},
            jnp.asarray(x))), **TOL)
    # the published encoder's 1536 positions: the two libraries' fp32 exp
    # differ by one ulp at some frequencies (a relative 2**-23), which
    # moves an angle of up to 1535 rad by up to 1535 * 2**-23 = 1.8e-4,
    # and the angle's own rounding adds up to half an ulp (6.1e-5) on each
    # side, so that table is held to atol 4e-4 (its sin and cos agree to
    # one ulp of 1 at equal angles)
    for pos, tol in ((np.arange(16)[None], TOL),
                     (np.array([[5], [77]]), TOL),
                     (np.arange(1536)[None], dict(atol=4e-4, rtol=0))):
        pos = np.broadcast_to(pos, (2, pos.shape[1])).astype(np.int32)
        for d in (128, 512):
            got = tl.sinusoid_pos(torch.from_numpy(pos), d, torch.float32)
            want = jl.sinusoid_pos(jnp.asarray(pos), d, jnp.float32)
            assert got.shape == (2, pos.shape[1], d)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_kv_from_states_and_cross_attention_match_jax():
    """The cross-attention source (``kv_from_states``) of encoder states
    and the decoder's full-sequence cross-attention (``attention_fwd``
    with ``kv=``, non-causal, no RoPE) against ``repro.models.layers``."""
    jcfg, tcfg = cfgs()
    np_params = jax.tree.map(np.asarray,
                             JT.init_params(jcfg, jax.random.PRNGKey(2)))
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      np_params["layers"]["xattn"])
    tp = TT._per_layer(TT.params_from_numpy(np_params, tcfg,
                                            device="cpu"))[0]["xattn"]
    rng = np.random.default_rng(4)
    enc = rng.standard_normal((2, 32, 128)).astype(np.float32)
    x = rng.standard_normal((2, 12, 128)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    epos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32)).copy()
    jk, jv = jl.kv_from_states(jcfg, jp, jnp.asarray(enc))
    tk, tv = tl.kv_from_states(tcfg, tp, torch.from_numpy(enc))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    want, _ = jl.attention_fwd(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                               causal=False, use_rope=False, kv=(jk, jv),
                               kv_positions=jnp.asarray(epos))
    got, (k, _) = tl.attention_fwd(tcfg, tp, torch.from_numpy(x),
                                   torch.from_numpy(pos), causal=False,
                                   kv=(tk, tv),
                                   kv_positions=torch.from_numpy(epos))
    assert k is tk
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# (Sq, Skv, H, Hkv): the cross shape at Sq < Skv and Sq > Skv, the
# encoder's self-attention (MHA), and a Skv no chunk of 64 divides
NONCAUSAL = [(16, 64, 4, 2), (96, 32, 4, 4), (64, 64, 8, 8), (24, 100, 4, 2)]


@pytest.mark.parametrize("Sq,Skv,H,Hkv", NONCAUSAL,
                         ids=[f"sq{a}_skv{b}_h{c}_{d}" for a, b, c, d in
                              NONCAUSAL])
def test_plain_flash_non_causal_matches_jax(Sq, Skv, H, Hkv):
    """The wrapper on CPU tensors (its plain version, no launch),
    non-causal at Sq != Skv, against JAX's ``models.flash`` (its chunk the
    largest of 64 and Skv dividing Skv) and, where Sq and Skv are aligned
    to the Pallas kernel's 32-key blocks,
    ``flash_attention_tpu(interpret=True)``."""
    r = np.random.default_rng(Sq + Skv)
    B, D = 2, 64
    q = r.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = r.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    v = r.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    qp = np.broadcast_to(np.arange(Sq, dtype=np.int32), (B, Sq)).copy()
    kp = np.broadcast_to(np.arange(Skv, dtype=np.int32), (B, Skv)).copy()
    kernels.reset_launches()
    got = flash_attention(*map(torch.from_numpy, (q, k, v, qp, kp)),
                          causal=False).numpy()
    assert kernels.launches()["flash_attention"] == 0
    assert got.shape == (B, Sq, H, D)
    chunk = 64 if Skv % 64 == 0 else Skv
    want = jflash.flash_attention((False, 0, chunk, 0.0),
                                  *map(jnp.asarray, (q, k, v, qp, kp)))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    if Skv % 32 == 0:
        pallas = flash_attention_tpu(*map(jnp.asarray, (q, k, v)),
                                     causal=False, block_q=Sq, block_k=32,
                                     interpret=True)
        np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


# --------------------------------------------------------------- model


def test_encoder_matches_jax():
    """``_encode``: the adapter, sinusoid positions, two non-causal
    layers and ``enc_norm`` over 32 stub frames."""
    jcfg, tcfg = cfgs()
    jparams, tparams = params(jcfg, tcfg)
    frames = stub(jcfg, 2, 32)
    want, wpos = JT._encode(jcfg, AXES, jparams, jnp.asarray(frames), None,
                            False)
    got, pos = TT._encode(tcfg, tparams, torch.from_numpy(frames))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(wpos))
    assert got.shape == (2, 32, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("S", [16, 48])
def test_prefill_logits_and_cache_match_jax(S):
    """Prefill's last-position logits and its cache: the decoder's
    self-attention K/V (L, B, S, Hkv, dh) and the cross-attention's
    (L, B, 32, Hkv, dh)."""
    jcfg, tcfg = cfgs()
    jparams, tparams = params(jcfg, tcfg)
    toks, frames = tokens(jcfg, 2, S), stub(jcfg, 2, 32)
    jlog, jc = JT.prefill(jcfg, AXES, jparams,
                          {"tokens": jnp.asarray(toks),
                           "frames": jnp.asarray(frames)})
    tlog, tc = TT.prefill(tcfg, tparams, torch.from_numpy(toks),
                          frames=torch.from_numpy(frames))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **FWD_TOL)
    assert set(tc) == set(jc) == {"k", "v", "xk", "xv"}
    for n in tc:
        assert tuple(tc[n].shape) == jc[n].shape
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   **FWD_TOL)
    with pytest.raises(ValueError, match="frames"):
        TT.prefill(tcfg, tparams, torch.from_numpy(toks))
    with pytest.raises(ValueError, match="frames"):
        TT.prefill(tcfg, tparams, torch.from_numpy(toks),
                   frames=torch.from_numpy(frames[:, :16]))


def test_decode_steps_match_jax():
    """Four greedy ``decode_step``s in both packages from the prefill's
    cache installed into ``init_cache`` at max_len 32 (the JAX side as
    ``tests/test_models.py`` installs it, the port by ``install_cache``):
    equal tokens each step and caches within 1e-4, ``xk`` / ``xv`` left
    as the prefill wrote them; the installed cache has JAX
    ``init_cache``'s layout."""
    jcfg, tcfg = cfgs()
    jparams, tparams = params(jcfg, tcfg)
    B, S = 2, 16
    toks, frames = tokens(jcfg, B, S, 5), stub(jcfg, B, 32, 5)
    jlog, jpc = JT.prefill(jcfg, AXES, jparams,
                           {"tokens": jnp.asarray(toks),
                            "frames": jnp.asarray(frames)})
    _, tpc = TT.prefill(tcfg, tparams, torch.from_numpy(toks),
                        frames=torch.from_numpy(frames))
    empty = JT.init_cache(jcfg, B, 32)
    jc = {n: np.array(a) for n, a in empty.items()}
    for n in ("k", "v"):
        jc[n][:, :, :S] = np.asarray(jpc[n])
    for n in ("xk", "xv"):
        jc[n] = np.asarray(jpc[n])
    jc = {n: jnp.asarray(a) for n, a in jc.items()}
    tc = TT.install_cache(tcfg, TT.init_cache(tcfg, B, 32, "cpu"), tpc)
    for n in tc:
        assert tuple(tc[n].shape) == empty[n].shape
        assert str(tc[n].dtype)[6:] == str(empty[n].dtype)
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   **FWD_TOL)
    xk = tc["xk"].clone()
    cur = np.argmax(np.asarray(jlog)[:, 0], axis=-1).astype(np.int32)
    jt, tt = jnp.asarray(cur), torch.from_numpy(cur.copy())
    for step in range(4):
        lengths = np.full((B,), S + step, np.int32)
        jt, jc = JT.decode_step(jcfg, AXES, jparams, jc, jt,
                                jnp.asarray(lengths))
        tt, tc = TT.decode_step(tcfg, tparams, tc, tt,
                                torch.from_numpy(lengths))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   **FWD_TOL)
    assert torch.equal(tc["xk"], xk)


def test_install_cache_refuses_what_it_cannot_take():
    """A prefill longer than the cache, and a family with another cache
    layout (a sliding window's rings)."""
    _, tcfg = cfgs()
    small = TT.init_cache(tcfg, 2, 16, "cpu")
    big = TT.init_cache(tcfg, 2, 32, "cpu")
    with pytest.raises(ValueError, match="32"):
        TT.install_cache(tcfg, small, big)
    danube = dataclasses.replace(reduced_config("h2o_danube_1_8b"),
                                 dtype="float32")
    with pytest.raises(NotImplementedError):
        TT.install_cache(danube, small, big)


# (sampled, lp_k)
VARIANTS = [(False, None), (False, 3), (True, None), (True, 2)]


@pytest.mark.parametrize("sampled,lp_k", VARIANTS,
                         ids=["greedy", "greedy_lp3", "sampled",
                              "sampled_lp2"])
def test_generate_matches_jax(sampled, lp_k):
    """The slice as a whole: ``generate`` (prefill with frames, the first
    token, the cache installed at a multiple of 16 positions, pages of
    16) gives the JAX package's tokens and logprob planes, rows of 1 to
    21 tokens (greedy), mixed sampling a row with stop tokens (sampled);
    greedy tokens are also the argmax of the JAX teacher-forced forward."""
    jcfg, tcfg = cfgs()
    jparams, tparams = params(jcfg, tcfg)
    B, S = 4, 16
    toks, frames = tokens(jcfg, B, S, 6), stub(jcfg, B, 32, 6)
    want = [21, 1, 9, 17] if not sampled else 20
    sps = sampled_params(B, TT.padded_vocab(tcfg)) if sampled else None
    got = generate(tcfg, tparams, toks.tolist(), want, sampling=sps,
                   lp_k=lp_k, frames=frames)
    ref, ref_lps = jax_generate(jcfg, jparams, toks, want,
                                {"frames": jnp.asarray(frames)}, sps, lp_k)
    check_generation(got, ref, ref_lps)
    if not sampled and lp_k is None:
        rows = [t + [0] * (21 - len(t)) for t in got.tokens]
        full = np.concatenate([toks, np.asarray(rows, np.int32)[:, :-1]], 1)
        h, _, _ = JT._backbone(jcfg, AXES, jparams,
                               {"tokens": jnp.asarray(full),
                                "frames": jnp.asarray(frames)}, None, False,
                               False)
        oracle = np.asarray(jnp.argmax(JT.logits_fn(jcfg, jparams, h)
                                       [:, S - 1:], axis=-1))
        for b, t in enumerate(got.tokens):
            assert t == oracle[b, :len(t)].tolist()


def test_generate_sampled_streams_repeat_and_need_frames():
    """Explicit sampling with a seed a row and top-5 logprobs: two runs
    give the same streams and planes; without frames ``generate``
    raises, as does a frames tensor of another length."""
    jcfg, tcfg = cfgs()
    _, tparams = params(jcfg, tcfg)
    toks, frames = tokens(jcfg, 3, 16, 7), stub(jcfg, 3, 32, 7)
    sps = [SamplingParams(temperature=0.8, top_k=40, top_p=0.95, seed=i)
           for i in range(3)]
    runs = [generate(tcfg, tparams, toks.tolist(), 20, sampling=sps,
                     lp_k=5, frames=torch.from_numpy(frames))
            for _ in range(2)]
    assert runs[0].tokens == runs[1].tokens
    assert runs[0].logprobs == runs[1].logprobs
    assert [len(t) for t in runs[0].tokens] == [20] * 3
    with pytest.raises(ValueError, match="frames"):
        generate(tcfg, tparams, toks.tolist(), 4)
    with pytest.raises(ValueError, match="frames"):
        generate(tcfg, tparams, toks.tolist(), 4, frames=frames[:, :31])
    with pytest.raises(ValueError, match="patches"):
        generate(tcfg, tparams, toks.tolist(), 4, frames=frames,
                 patches=frames)


def test_weight_bridge_and_param_count():
    """``params_from_numpy`` carries the JAX tree (``enc_layers``,
    ``enc_norm``, ``adapter``, ``xattn``, LayerNorm biases) across with
    every value, fails loudly on a missing or an extra leaf, and the
    port's own draw has the same shapes and dtypes; ``param_count``
    equals the JAX package's, reduced and published."""
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config
    jcfg, tcfg = cfgs()
    np_params = jax.tree.map(np.asarray,
                             JT.init_params(jcfg, jax.random.PRNGKey(0)))
    got = TT.params_from_numpy(np_params, tcfg, device="cpu")
    own = TT.init_params(tcfg, seed=1, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(np_params)[0]
    assert len(flat) == len(jax.tree.leaves(own))
    for path, leaf in flat:
        t, o = got, own
        for k in path:
            t, o = t[k.key], o[k.key]
        np.testing.assert_array_equal(t.numpy(), leaf)
        assert tuple(o.shape) == leaf.shape and o.dtype == t.dtype
    assert set(got) == {"embed", "lm_head", "final_norm", "enc_layers",
                        "enc_norm", "layers", "adapter"}
    assert set(got["layers"]) == {"ln1", "attn", "ln2", "xattn", "ln3",
                                  "mlp"}
    assert set(got["enc_norm"]) == {"w", "b"}
    assert not own["layers"]["ln1"]["b"].any()
    missing = dict(np_params, layers=dict(np_params["layers"]))
    del missing["layers"]["xattn"]
    with pytest.raises(ValueError, match="xattn"):
        TT.params_from_numpy(missing, tcfg, device="cpu")
    extra = dict(np_params, enc_norm=dict(np_params["enc_norm"],
                                          extra=np_params["enc_norm"]["b"]))
    with pytest.raises(ValueError, match="extra"):
        TT.params_from_numpy(extra, tcfg, device="cpu")
    assert TT.param_count(tcfg) == JT.param_count(jcfg)
    assert TT.param_count(get_config(ARCH)) == JT.param_count(jget(ARCH))


def test_node_engine_refuses_the_family():
    """``NodeEngine`` refuses the encoder-decoder in both packages; the
    port's names model-level serving."""
    from repro.runtime.engine import NodeEngine as JEngine
    jcfg, tcfg = cfgs()
    with pytest.raises(AssertionError):
        JEngine(jcfg, max_active=2, max_len=32)
    with pytest.raises(NotImplementedError, match="generate"):
        NodeEngine(tcfg, device="cpu", max_active=2, max_len=32)
