"""Training in the port, held to the JAX package on the CPU.

fp32 throughout; inputs from ``np.random.default_rng(seed)``; the JAX side
runs on the same numpy weights (``params_from_numpy`` carries them to the
port).  Cases:

- the plain flash backward through ``FlashAttentionFn`` on CPU tensors
  against ``jax.vjp`` of ``repro.models.flash.flash_attention`` (chunk 16)
  and against ``torch.autograd`` through the plain forward (a second
  oracle): G = 1, 2, 3 (6 q heads on 6, 3 and 2), causal, non-causal and
  window 24 with softcap 30, Sq = Skv = 64, head dims (32, 32) and
  (48, 32); atol 1e-5, rtol 1e-4 (summation order);
- the plain forward's ``lse`` against m + log(l) of JAX's
  ``_flash_fwd_impl`` (atol 1e-5);
- ``_chunked_ce``'s value (rtol 1e-5) and its gradients at h and
  ``lm_head`` (atol 1e-5) against JAX's, S 16 and 1024 (two chunks), some
  labels -1, logit softcap 0 and 30;
- ``forward_loss`` and the gradient of every leaf against
  ``jax.value_and_grad(forward_loss)`` on reduced SmolLM-360M,
  Llama-3.2-1B, Qwen2-0.5B (B 2, S 64) and H2O-Danube-1.8B (window 64, S
  200: past the window), remat on and off; every port
  leaf gets a gradient; loss rtol 1e-5, gradients atol 1e-4, rtol 1e-3 (as
  ``tests/test_models.py::test_flash_vjp_matches_autodiff``);
- three AdamW steps (``apply_updates``) against ``repro.optim``: params,
  master, m, v, step and grad norm to atol 1e-6, with the clip active and
  not; bf16 params are the fp32 master cast;
- ``train_step`` with two microbatches against a JAX loop over the two
  halves (fp32 sum, then the mean, then ``apply_updates``): loss (rtol
  1e-5) and grad norm (rtol 1e-4) over two steps, and after the first the
  moments m, v, whose elements carry the mean gradients (atol 1e-6, rtol
  1e-4);
- eight steps of ``python -m repro_torch.launch.train --reduced --device
  cpu --dtype float32`` against the same JAX loop on the same stream and
  weights (rtol 1e-4), with a falling loss;
- the refusals: ``forward_loss`` on the hybrid, audio, vision and MLA
  families, the card's backward at unequal head dims or a head dim it
  has no kernel for (it takes a window, a softcap and D 80), ``--dry``,
  ``n_dev > 1``.  The MoE family trains: ``test_torch_train_moe.py``; the
  SSM: ``test_torch_train_ssm.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import reduced_config as j_reduced
from repro.models import flash as jflash
from repro.models import transformer as JT
from repro.models.api import MeshAxes
from repro_torch import kernels, optim
from repro_torch.configs import reduced_config
from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
from repro_torch.kernels.flash_attention.ops import (FlashAttentionFn,
                                                     flash_attention)
from repro_torch.kernels.flash_attention_bwd import ops as bwd_ops
from repro_torch.launch import steps, train
from repro_torch.models import flash as tflash
from repro_torch.models import transformer as TT

AXES = MeshAxes()
BWD_TOL = dict(atol=1e-5, rtol=1e-4)
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)
DENSE = ["smollm_360m", "llama3_2_1b", "qwen2_0_5b", "h2o_danube_1_8b"]


def _cfgs(arch):
    return (dataclasses.replace(j_reduced(arch), dtype="float32"),
            dataclasses.replace(reduced_config(arch), dtype="float32"))


def _np_params(jcfg, seed=0):
    return jax.tree.map(np.asarray,
                        JT.init_params(jcfg, jax.random.PRNGKey(seed)))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _pos(B, S):
    return np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()


# ---------------------------------------------------------------- flash

MASKS = {"causal": (True, 0, 0.0), "noncausal": (False, 0, 0.0),
         "window24_softcap30": (True, 24, 30.0)}


@pytest.mark.parametrize("dims", [(32, 32), (48, 32)],
                         ids=["dh32_dv32", "dh48_dv32"])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("Hkv", [6, 3, 2], ids=["G1", "G2", "G3"])
def test_plain_flash_backward_matches_jax_vjp(Hkv, mask, dims):
    dh, dv = dims
    causal, window, softcap = MASKS[mask]
    B, S, H = 2, 64, 6
    rng = np.random.default_rng(Hkv * 10 + dh)
    q = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, dv)).astype(np.float32)
    g = rng.standard_normal((B, S, H, dv)).astype(np.float32)
    pos = _pos(B, S)
    opts = (causal, window, 16, softcap)
    out, vjp = jax.vjp(
        lambda a, b, c: jflash.flash_attention(opts, a, b, c,
                                               jnp.asarray(pos),
                                               jnp.asarray(pos)),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))

    tp = torch.from_numpy(pos)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    before = kernels.launches()
    got = flash_attention(*leaves, tp, tp, causal=causal, window=window,
                          softcap=softcap)
    assert got.grad_fn is not None and \
        type(got.grad_fn).__name__.startswith("FlashAttentionFn")
    got.backward(torch.from_numpy(g))
    assert kernels.launches() == before       # the CPU launches nothing
    _close(got.detach(), out, atol=1e-5, rtol=1e-5)
    for t, w in zip(leaves, want):
        _close(t.grad, w, **BWD_TOL)

    # the second oracle: torch.autograd through the plain forward
    auto = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    tflash.flash_attention(*auto, tp, tp, causal=causal, window=window,
                           softcap=softcap).backward(torch.from_numpy(g))
    for t, a in zip(leaves, auto):
        _close(t.grad, a.grad, **BWD_TOL)


@pytest.mark.parametrize("mask", list(MASKS))
def test_plain_flash_lse_matches_jax_statistics(mask):
    causal, window, softcap = MASKS[mask]
    B, S, H, Hkv, D = 2, 64, 6, 2, 32
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((B, S, h, D)).astype(np.float32)
               for h in (H, Hkv, Hkv))
    pos = _pos(B, S)
    out, (m, l) = jflash._flash_fwd_impl((causal, window, 16, softcap),
                                         *map(jnp.asarray, (q, k, v, pos,
                                                            pos)))
    tp = torch.from_numpy(pos)
    got, lse = tflash.flash_attention(*map(torch.from_numpy, (q, k, v)), tp,
                                      tp, causal=causal, window=window,
                                      softcap=softcap, return_lse=True)
    assert lse.shape == (B, S, H) and lse.dtype == torch.float32
    _close(lse, np.asarray(m) + np.log(np.asarray(l)), atol=1e-5, rtol=0)
    _close(got, out, atol=1e-5, rtol=1e-5)


def test_flash_attention_fn_saves_what_the_backward_reads():
    """The autograd node's backward equals the plain backward called on
    the forward's out and lse."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 40, h, 32))
                                .astype(np.float32)) for h in (4, 2, 2))
    g = torch.from_numpy(rng.standard_normal((1, 40, 4, 32))
                         .astype(np.float32))
    pos = torch.from_numpy(_pos(1, 40))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    FlashAttentionFn.apply(*leaves, pos, pos, True, 0, 0.0).backward(g)
    out, lse = tflash.flash_attention(q, k, v, pos, pos, return_lse=True)
    want = bwd_ops.flash_attention_bwd(q, k, v, pos, pos, out, lse, g)
    for t, w in zip(leaves, want):
        assert torch.equal(t.grad, w)


def test_card_backward_refuses_a_window_or_a_softcap():
    """What the card's backward refuses: v's head dim apart from q's (MLA)
    and head dims it has no kernel for (48, and RecurrentGemma's 256); a
    window, a softcap (each alone and together) and D 80 (Danube's) it
    takes."""
    q = torch.zeros((1, 8, 4, 64))
    k = torch.zeros((1, 8, 2, 64))
    bwd_ops.check_supported(q, k, k, window=16)
    bwd_ops.check_supported(q, k, k, softcap=30.0)
    bwd_ops.check_supported(q, k, k, window=16, softcap=30.0)
    bwd_ops.check_supported(q, k, k)
    q80, k80 = torch.zeros((1, 8, 32, 80)), torch.zeros((1, 8, 8, 80))
    bwd_ops.check_supported(q80, k80, k80, window=4096)
    for D in (48, 256):
        with pytest.raises(ValueError, match="head dims"):
            bwd_ops.check_supported(q[..., :1].expand(1, 8, 4, D),
                                    k[..., :1].expand(1, 8, 2, D),
                                    k[..., :1].expand(1, 8, 2, D))
    with pytest.raises(ValueError, match="head dims"):
        bwd_ops.check_supported(q, k, k[..., :32])


# ---------------------------------------------------------------- loss

@pytest.mark.parametrize("softcap", [0.0, 30.0], ids=["nocap", "cap30"])
@pytest.mark.parametrize("S", [16, 1024])
def test_chunked_ce_matches_jax(S, softcap):
    jcfg, tcfg = _cfgs("smollm_360m")
    jcfg = dataclasses.replace(jcfg, logit_softcap=softcap)
    tcfg = dataclasses.replace(tcfg, logit_softcap=softcap)
    V = TT.padded_vocab(tcfg)
    rng = np.random.default_rng(S)
    B, D = 2, tcfg.d_model
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) * 0.3).astype(np.float32)
    y = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    y[0, :3] = -1
    y[1, S // 2:S // 2 + 5] = -1
    jl, (jh, jw) = jax.value_and_grad(
        lambda hh, ww: JT._chunked_ce(jcfg, {"lm_head": ww}, hh,
                                      jnp.asarray(y)), argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    loss = TT._chunked_ce(tcfg, {"lm_head": tw}, th, torch.from_numpy(y))
    loss.backward()
    _close(loss.detach(), jl, rtol=1e-5, atol=0)
    _close(th.grad, jh, atol=1e-5, rtol=0)
    _close(tw.grad, jw, atol=1e-5, rtol=0)


def _batch(tcfg, B=2, S=None, seed=1):
    """Tokens and labels (B, S); S defaults to 64, or past a sliding
    window (2 x window + 72)."""
    if S is None:
        S = 2 * tcfg.sliding_window + 72 if tcfg.sliding_window else 64
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, tcfg.vocab_size, (B, S)).astype(np.int32)
    labels = toks.copy()
    labels[0, :5] = -1
    return toks, labels


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "noremat"])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_loss_and_every_leaf_grad_match_jax(arch, remat):
    jcfg, tcfg = _cfgs(arch)
    npp = _np_params(jcfg)
    toks, labels = _batch(tcfg)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    jl, jg = jax.value_and_grad(
        lambda p: JT.forward_loss(jcfg, AXES, p, jb, remat=remat))(
        jax.tree.map(jnp.asarray, npp))
    tp = optim.tree_map(lambda t: t.requires_grad_(True),
                        TT.params_from_numpy(npp, tcfg, device="cpu"))
    loss = TT.forward_loss(tcfg, tp, {"tokens": torch.from_numpy(toks),
                                      "labels": torch.from_numpy(labels)},
                           remat=remat)
    loss.backward()
    _close(loss.detach(), jl, rtol=1e-5, atol=0)
    got = optim.tree_leaves(tp)
    want = jax.tree.leaves(jg)
    assert len(got) == len(want)
    assert all(t.grad is not None for t in got)
    for t, w in zip(got, want):
        assert t.grad.shape == w.shape
        _close(t.grad, w, **GRAD_TOL)


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "whisper_base",
                                  "pixtral_12b", "deepseek_r1"])
def test_forward_loss_refuses_the_other_families(arch):
    cfg = reduced_config(arch)
    toks = torch.zeros((1, 8), dtype=torch.int32)
    what = {"recurrentgemma_2b": "RG-LRU", "whisper_base": "encoder",
            "pixtral_12b": "patch", "deepseek_r1": "MLA"}[arch]
    with pytest.raises(ValueError, match=what):
        TT.forward_loss(cfg, {}, {"tokens": toks, "labels": toks})


# ---------------------------------------------------------------- AdamW

def _np_grads(npp, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * scale)
                        .astype(np.float32), npp)


def _check_state(tp, topt, jparams, jopt):
    for t, w in zip(optim.tree_leaves(tp), jax.tree.leaves(jparams)):
        _close(t, w, atol=1e-6, rtol=0)
    tl = optim.tree_leaves(topt["leaves"])
    jl = jax.tree.leaves(jopt["leaves"])
    assert len(tl) == len(jl)
    for t, w in zip(tl, jl):
        _close(t, w, atol=1e-6, rtol=0)
    assert int(topt["step"]) == int(jopt["step"])


@pytest.mark.parametrize("max_norm", [1e-3, 1e6], ids=["clip", "noclip"])
def test_apply_updates_matches_jax(max_norm):
    jcfg, tcfg = _cfgs("llama3_2_1b")
    npp = _np_params(jcfg)
    jo = joptim.AdamWConfig(lr=1e-2, max_grad_norm=max_norm, zero1=False)
    to = optim.AdamWConfig(lr=1e-2, max_grad_norm=max_norm, zero1=False)
    jparams = jax.tree.map(jnp.asarray, npp)
    jopt = joptim.init_opt_state(jparams, 1)
    tp = TT.params_from_numpy(npp, tcfg, device="cpu")
    topt = optim.init_opt_state(tp)
    _check_state(tp, topt, jparams, jopt)
    for i in range(3):
        g = _np_grads(npp, 10 + i, 0.05)
        jparams, jopt, jn = joptim.apply_updates(
            jo, jparams, jax.tree.map(jnp.asarray, g), jopt, 1)
        tg = TT.params_from_numpy(g, tcfg, device="cpu")
        same, topt2, tn = optim.apply_updates(to, tp, tg, topt)
        assert same is tp and topt2 is topt        # written in place
        _close(tn, jn, atol=1e-6, rtol=1e-6)
        _check_state(tp, topt, jparams, jopt)
    assert (float(jn) > max_norm) == (max_norm < 1)


def test_apply_updates_casts_bf16_params_from_the_fp32_master():
    cfg = reduced_config("smollm_360m")
    tp = TT.init_params(cfg, 0, "cpu")
    assert tp["embed"].dtype == torch.bfloat16
    topt = optim.init_opt_state(tp)
    g = optim.tree_map(lambda t: torch.randn(t.shape,
                                             generator=torch.Generator()
                                             .manual_seed(t.numel()))
                       .to(t.dtype), tp)
    views = TT._per_layer(tp)           # the serving path's views
    optim.apply_updates(optim.AdamWConfig(lr=1e-2), tp, g, topt)
    for p, st in zip(optim.tree_leaves(tp),
                     optim._pairs(tp, topt["leaves"])):
        master = st[1]["master"]
        assert master.dtype == torch.float32
        assert torch.equal(p, master.reshape(p.shape).to(torch.bfloat16))
    # the per-layer views share the updated storage
    assert torch.equal(views[1]["attn"]["wq"], tp["layers"]["attn"]["wq"][1])
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        optim.apply_updates(optim.AdamWConfig(), tp, g, topt, n_dev=2)


# ---------------------------------------------------------------- steps

def _jax_value_and_grad(jcfg):
    """The reference's jitted loss and gradients, ``(params, batch)``."""
    return jax.jit(jax.value_and_grad(
        lambda p, b: JT.forward_loss(jcfg, AXES, p, b, remat=True)))


def _jax_loop_step(vg, ocfg, params, opt, batches):
    """The reference's microbatched step on the CPU: value_and_grad of each
    microbatch (``vg``), fp32 sum, mean, apply_updates."""
    loss_sum, gacc = 0.0, None
    for b in batches:
        l, g = vg(params, b)
        g = jax.tree.map(lambda x: x.astype(jnp.float32), g)
        gacc = g if gacc is None else jax.tree.map(jnp.add, gacc, g)
        loss_sum = loss_sum + l
    n = len(batches)
    grads = jax.tree.map(lambda x: x / n, gacc)
    params, opt, gn = joptim.apply_updates(ocfg, params, grads, opt, 1)
    return params, opt, loss_sum / n, gn


def test_train_step_with_two_microbatches_matches_jax():
    jcfg, tcfg = _cfgs("smollm_360m")
    npp = _np_params(jcfg)
    toks, labels = _batch(tcfg, B=4, S=32, seed=7)
    halves = [{"tokens": jnp.asarray(toks[i:i + 2]),
               "labels": jnp.asarray(labels[i:i + 2])} for i in (0, 2)]
    jo = joptim.AdamWConfig(lr=1e-3, zero1=False)
    jparams = jax.tree.map(jnp.asarray, npp)
    jopt = joptim.init_opt_state(jparams, 1)
    tp = TT.params_from_numpy(npp, tcfg, device="cpu")
    topt = optim.init_opt_state(tp)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    vg = _jax_value_and_grad(jcfg)
    for step in range(2):
        jparams, jopt, jl, jn = _jax_loop_step(vg, jo, jparams, jopt,
                                               halves)
        out = steps.train_step(tcfg, tp, topt, batch,
                               optim.AdamWConfig(lr=1e-3, zero1=False),
                               microbatches=2)
        _close(out["loss"], jl, rtol=1e-5, atol=0)
        _close(out["grad_norm"], jn, rtol=1e-4, atol=1e-6)
        if step == 0:
            # after the first step the moments are the microbatches' mean
            # gradient (m) and its square (v), element by element; later
            # elements are not compared one by one: Adam's first steps
            # move each by about lr * sign(g), so an element whose
            # gradient is ~0 may step either way in the two frameworks
            for (_, t), w in zip(optim._pairs(tp, topt["leaves"]),
                                 jax.tree.leaves(
                                     jopt["leaves"],
                                     is_leaf=lambda x: "master" in x)):
                for key in ("m", "v"):
                    _close(t[key], w[key], atol=1e-6, rtol=1e-4)
    assert all(not t.requires_grad for t in optim.tree_leaves(tp))
    with pytest.raises(ValueError, match="microbatches"):
        steps.train_step(tcfg, tp, topt, batch, optim.AdamWConfig(),
                         microbatches=3)


def test_train_driver_follows_the_jax_loss_trajectory(capsys):
    """``launch/train.py``'s loop (its weights drawn by the port's
    ``init_params``, handed to JAX as numpy) against the reference's loop
    on the same stream: the same eight losses, falling."""
    losses = train.main(["--arch", "smollm_360m", "--reduced", "--device",
                         "cpu", "--dtype", "float32", "--steps", "8",
                         "--batch", "4", "--seq", "32"])
    printed = capsys.readouterr().out
    assert "step 7 loss" in printed and "tokens/s" in printed
    jcfg, tcfg = _cfgs("smollm_360m")
    start = TT.init_params(tcfg, 0, "cpu")
    jparams = optim.tree_map(lambda t: jnp.asarray(t.numpy()), start)
    jo = joptim.AdamWConfig(lr=train.LR, zero1=False)
    jopt = joptim.init_opt_state(jparams, 1)
    stream = SyntheticLMStream(DataConfig(global_batch=4, seq_len=32,
                                          vocab_size=tcfg.vocab_size))
    want = []
    vg = _jax_value_and_grad(jcfg)
    for i in range(8):
        b = {k: jnp.asarray(v) for k, v in stream.batch_at(i).items()}
        jparams, jopt, jl, _ = _jax_loop_step(vg, jo, jparams, jopt, [b])
        want.append(float(jl))
    _close(losses, want, rtol=1e-4, atol=0)
    assert losses[-1] < losses[0] - 0.1, losses


def test_train_driver_saves_a_checkpoint_and_refuses_dry(tmp_path):
    from repro_torch.runtime import checkpoint
    train.main(["--reduced", "--device", "cpu", "--dtype", "float32",
                "--steps", "1", "--ckpt", str(tmp_path / "ck")])
    flat, extra = checkpoint.restore(str(tmp_path / "ck"))
    assert extra["steps"] == 1 and "embed" in flat
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        train.main(["--dry"])
    with pytest.raises(ValueError, match="RG-LRU"):
        train.main(["--arch", "recurrentgemma_2b", "--reduced", "--device",
                    "cpu", "--steps", "1"])
