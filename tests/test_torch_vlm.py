"""The port's vision decoder (Pixtral-12B, reduced) held to the JAX package
on the CPU: stub patch embeddings through the adapter before the token
embeddings, prefill with and without patches, decode steps whose lengths
count the patches, and model-level serving through ``generate``.

Reduced ``pixtral_12b`` in fp32: 2 layers, d_model 128, 4 query heads on
2 kv heads of 32, d_ff 256, vocab 512, 8 stub patches.  Weights come from
the JAX package's ``init_params`` through ``params_from_numpy``; patches
(at ``frontend_stub``'s 0.02 scale) and tokens are made with numpy from a
seed.  Tolerances as in ``test_torch_encdec.py``: whole forwards
atol/rtol 1e-4, tokens and top ids exactly, logprobs 1e-5.  The JAX
side of ``generate`` is ``test_torch_encdec.jax_generate``.

The reference's prefill attention takes a length of at most 512 or a
multiple of 512 (``repro.models.layers.chunked_attention``); the port
masks keys at the true length and takes any.  The tests use lengths the
reference takes; 40 patches and 17 tokens (57 positions, pages of 16
ending mid-page) are also held to the port's own teacher-forced forward.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro.models.api import MeshAxes
from repro_torch.launch.model_level import generate
from repro_torch.models import transformer as TT
from repro_torch.runtime.engine import NodeEngine
from test_torch_encdec import (check_generation, cfgs, jax_generate,
                               params, sampled_params, stub, tokens)

AXES = MeshAxes()
FWD_TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "pixtral_12b"


@pytest.mark.parametrize("P", [8, 0], ids=["patches8", "no_patches"])
def test_prefill_logits_and_cache_match_jax(P):
    """Prefill's last-position logits and its K/V cache, with the 8 stub
    patches before 16 tokens (24 positions) and without patches."""
    jcfg, tcfg = cfgs(ARCH)
    jparams, tparams = params(jcfg, tcfg)
    toks = tokens(jcfg, 2, 16)
    jb, kw = {"tokens": jnp.asarray(toks)}, {}
    if P:
        patches = stub(jcfg, 2, P)
        jb["patches"] = jnp.asarray(patches)
        kw["patches"] = torch.from_numpy(patches)
    jlog, jc = JT.prefill(jcfg, AXES, jparams, jb)
    tlog, tc = TT.prefill(tcfg, tparams, torch.from_numpy(toks), **kw)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **FWD_TOL)
    assert set(tc) == set(jc) == {"k", "v"}
    for n in tc:
        assert tuple(tc[n].shape) == jc[n].shape == (2, 2, 16 + P, 2, 32)
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   **FWD_TOL)


def test_decode_steps_count_the_patches():
    """Four greedy ``decode_step``s after 8 patches and 16 tokens, at
    lengths 24, 25, ... (positions and RoPE past the patches), in both
    packages from the prefill's cache installed at max_len 32: equal
    tokens each step, caches within 1e-4."""
    jcfg, tcfg = cfgs(ARCH)
    jparams, tparams = params(jcfg, tcfg)
    B, S, P = 2, 16, 8
    toks, patches = tokens(jcfg, B, S, 3), stub(jcfg, B, P, 3)
    jlog, jpc = JT.prefill(jcfg, AXES, jparams,
                           {"tokens": jnp.asarray(toks),
                            "patches": jnp.asarray(patches)})
    _, tpc = TT.prefill(tcfg, tparams, torch.from_numpy(toks),
                        patches=torch.from_numpy(patches))
    jc = {n: np.array(a) for n, a in JT.init_cache(jcfg, B, 32).items()}
    for n in ("k", "v"):
        jc[n][:, :, :S + P] = np.asarray(jpc[n])
    jc = {n: jnp.asarray(a) for n, a in jc.items()}
    tc = TT.install_cache(tcfg, TT.init_cache(tcfg, B, 32, "cpu"), tpc)
    cur = np.argmax(np.asarray(jlog)[:, 0], axis=-1).astype(np.int32)
    jt, tt = jnp.asarray(cur), torch.from_numpy(cur.copy())
    for step in range(4):
        lengths = np.full((B,), S + P + step, np.int32)
        jt, jc = JT.decode_step(jcfg, AXES, jparams, jc, jt,
                                jnp.asarray(lengths))
        tt, tc = TT.decode_step(tcfg, tparams, tc, tt,
                                torch.from_numpy(lengths))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   **FWD_TOL)


# (sampled, lp_k)
VARIANTS = [(False, None), (False, 3), (True, None), (True, 2)]


@pytest.mark.parametrize("sampled,lp_k", VARIANTS,
                         ids=["greedy", "greedy_lp3", "sampled",
                              "sampled_lp2"])
def test_generate_matches_jax(sampled, lp_k):
    """``generate`` with 8 patches before prompts of 16 gives the JAX
    package's tokens and logprob planes (rows of 1 to 21 tokens greedy,
    mixed sampling a row with stop tokens); without patches too for the
    plain greedy rows."""
    jcfg, tcfg = cfgs(ARCH)
    jparams, tparams = params(jcfg, tcfg)
    B, S = 4, 16
    toks, patches = tokens(jcfg, B, S, 4), stub(jcfg, B, 8, 4)
    want = [21, 1, 9, 17] if not sampled else 20
    sps = sampled_params(B, TT.padded_vocab(tcfg)) if sampled else None
    got = generate(tcfg, tparams, toks.tolist(), want, sampling=sps,
                   lp_k=lp_k, patches=patches)
    ref, ref_lps = jax_generate(jcfg, jparams, toks, want,
                                {"patches": jnp.asarray(patches)}, sps, lp_k)
    check_generation(got, ref, ref_lps)
    if not sampled and lp_k is None:
        got = generate(tcfg, tparams, toks.tolist(), want)
        ref, _ = jax_generate(jcfg, jparams, toks, want, {})
        assert got.tokens == ref


def test_unaligned_patch_prefix_follows_the_teacher_forced_forward():
    """40 patches and 17 tokens (57 positions; the decode cache of
    57 + 24 rounded up to 96), 24 greedy tokens a row: each equals the
    argmax of the port's own forward over the patches, the prompt and
    the tokens before it, and the JAX package gives the same tokens."""
    jcfg, tcfg = cfgs(ARCH)
    jparams, tparams = params(jcfg, tcfg)
    B, S, P, n = 2, 17, 40, 24
    toks, patches = tokens(jcfg, B, S, 8), stub(jcfg, B, P, 8)
    got = generate(tcfg, tparams, toks.tolist(), n,
                   patches=torch.from_numpy(patches))
    assert got.pages == 2
    full = np.concatenate([toks, np.asarray(got.tokens, np.int32)[:, :-1]],
                          1)
    h, _ = TT._backbone(tcfg, tparams, torch.from_numpy(full),
                        patches=torch.from_numpy(patches))
    oracle = torch.argmax(TT.logits_fn(tcfg, tparams, h)[:, P + S - 1:],
                          dim=-1)
    assert got.tokens == oracle.tolist()
    ref, _ = jax_generate(jcfg, jparams, toks, n,
                          {"patches": jnp.asarray(patches)})
    assert got.tokens == ref


def test_node_engine_refuses_the_family():
    """``NodeEngine`` refuses the vision decoder in both packages; the
    port's names model-level serving."""
    from repro.runtime.engine import NodeEngine as JEngine
    jcfg, tcfg = cfgs(ARCH)
    with pytest.raises(AssertionError):
        JEngine(jcfg, max_active=2, max_len=32)
    with pytest.raises(NotImplementedError, match="generate"):
        NodeEngine(tcfg, device="cpu", max_active=2, max_len=32)
