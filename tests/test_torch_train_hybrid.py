"""Training the RecurrentGemma hybrid in the port, held to the JAX package on
the CPU.

fp32 throughout; inputs from ``np.random.default_rng(seed)``, the JAX side
on the same numpy weights.  Cases:

- ``LinearScanFn``'s h and (da, db) against ``jax.vjp`` of the
  reference's ``jax.lax.associative_scan`` with its combine, at S 1, 7, 64
  and 200, with every a near 0 and near 1 (the adjoint then carries a
  cotangent across all 200 steps): rtol 1e-5 and an atol of 1e-5 plus 2
  ulps (2.4e-7) of the magnitudes summed (the same products summed in
  another tree: XLA differentiates the scan's tree, the port scans the
  reversed sequence): for h and db the recurrence run on |a| and |b| (or
  |dh|), for da = G h_{t-1} twice the product of the two;
- ``LinearScanFn`` under ``torch.autograd.gradcheck`` in fp64, and
  ``rglru_fwd`` scanning through it only while autograd records (serving
  launches what it did);
- ``rglru_fwd``'s gradients in x and every leaf of the block against
  ``jax.vjp(repro.models.rglru.rglru_fwd)``, with drawn gates and with
  gates whose r is near 0 (~1e-13: a rounds to 1, so 1 - a^2 is 0 and
  meets the clamp at 1e-12, where sqrt's derivative would be 5e5 and
  ``torch.clamp_min`` and ``jnp.maximum`` both pass no gradient): atol
  1e-4, rtol 1e-3 (``GRAD_TOL``).  Between the two, where 1 - a^2 is a
  few ulps of 1, fp32 cannot hold it: one ulp of exp moves it by ~6% in
  either library, so no tolerance tied to the algorithm compares them;
- the plain flash backward at head dim 256, 10 q heads on 1 kv head,
  window 24 with softcap 30 and causal without either, against
  ``jax.vjp`` of ``repro.models.flash.flash_attention`` (its ``_bwd``):
  atol 1e-5, rtol 1e-4 (``BWD_TOL``, summation order);
- ``forward_loss`` and every leaf's gradient against
  ``jax.value_and_grad(repro.models.transformer.forward_loss)`` on reduced
  RecurrentGemma-2B (1 unit + 2 tail layers, window 64, softcap 30), remat
  on and off, at S 128 (past the window) and S 48, and at head dim 256 by
  ``dataclasses.replace``: loss rtol 1e-5, gradients atol 1e-4, rtol 1e-3
  (as ``test_torch_train.py``); ``lam`` stays fp32 with an fp32 gradient;
- ``train_step`` with two microbatches against the reference's loop over
  the two halves (loss rtol 1e-5, grad norm rtol 1e-4, the moments after
  the first step atol 1e-6, rtol 1e-4), ``lam``'s fp32 master moving;
- eight steps of ``launch/train.py --arch recurrentgemma_2b --reduced
  --device cpu --dtype float32`` against the reference's loop on the same
  stream and weights (rtol 1e-4), with a falling loss.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.models import flash as jflash
from repro.models import rglru as JR
from repro_torch import optim
from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.launch import steps, train
from repro_torch.models import rglru as TR
from repro_torch.models import transformer as TT
from test_torch_train import (BWD_TOL, GRAD_TOL, _batch, _cfgs, _close,
                              _jax_loop_step, _jax_value_and_grad,
                              _np_params, _pos)
from test_torch_train_moe import _check_grads, _loss_and_grads

ARCH = "recurrentgemma_2b"
SCAN_TOL = dict(atol=1e-5, rtol=1e-5)
ULP2 = 2.4e-7              # 2 ulps of fp32 at 1
# a drawn uniformly in these ranges
A_RANGES = {"a_near_0": (0.0, 0.05), "a_near_1": (0.95, 0.9999)}


def _combine(e1, e2):
    return e1[0] * e2[0], e1[1] * e2[0] + e2[1]


def _magnitudes(a, x, reverse=False):
    """The recurrence m_t = |x_t| + |a| m_{t-1} (reversed: m_t = |x_t| +
    |a_{t+1}| m_{t+1}) in fp64: the sum of the magnitudes of the terms
    that h (or the adjoint G) adds up."""
    a, x = np.abs(a).astype(np.float64), np.abs(x).astype(np.float64)
    m, out = np.zeros(a[:, 0].shape), np.zeros(a.shape)
    S = a.shape[1]
    for t in (range(S - 1, -1, -1) if reverse else range(S)):
        coef = (a[:, t + 1] if t + 1 < S else 0.0) if reverse else a[:, t]
        m = x[:, t] + coef * m
        out[:, t] = m
    return out


def _within(got, want, mag):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    bound = SCAN_TOL["atol"] + ULP2 * mag + \
        SCAN_TOL["rtol"] * np.abs(np.asarray(want, np.float64))
    assert (err <= bound).all(), (err.max(), (err - bound).max())


@pytest.mark.parametrize("a_range", list(A_RANGES))
@pytest.mark.parametrize("S", [1, 7, 64, 200])
def test_linear_scan_fn_matches_jax_vjp(S, a_range):
    r = np.random.default_rng(S)
    lo, hi = A_RANGES[a_range]
    a = r.uniform(lo, hi, (2, S, 16)).astype(np.float32)
    b = r.standard_normal((2, S, 16)).astype(np.float32)
    dh = r.standard_normal((2, S, 16)).astype(np.float32)
    want_h, vjp = jax.vjp(
        lambda x, y: jax.lax.associative_scan(_combine, (x, y), axis=1)[1],
        jnp.asarray(a), jnp.asarray(b))
    want_da, want_db = vjp(jnp.asarray(dh))
    ta, tb = (torch.tensor(x, requires_grad=True) for x in (a, b))
    h = TR.LinearScanFn.apply(ta, tb)
    assert h.dtype == torch.float32
    mag_h, mag_g = _magnitudes(a, b), _magnitudes(a, dh, reverse=True)
    _within(h.detach(), want_h, mag_h)
    h.backward(torch.from_numpy(dh))
    _within(tb.grad, want_db, mag_g)
    mag_prev = np.concatenate([np.zeros_like(mag_h[:, :1]), mag_h[:, :-1]],
                              axis=1)
    _within(ta.grad, want_da, 2 * mag_g * mag_prev)
    if S == 1:                       # h_{-1} = 0: nothing flows to a
        assert not ta.grad.any()


@pytest.mark.parametrize("S", [1, 2, 9])
def test_linear_scan_fn_gradcheck(S):
    r = np.random.default_rng(40 + S)
    a = torch.tensor(r.uniform(0.1, 0.99, (2, S, 3)), requires_grad=True)
    b = torch.tensor(r.standard_normal((2, S, 3)), requires_grad=True)
    assert torch.autograd.gradcheck(TR.LinearScanFn.apply, (a, b))


def test_rglru_fwd_scans_through_the_autograd_node(monkeypatch):
    """While autograd records, ``rglru_fwd`` scans through
    ``LinearScanFn`` (once a call); with nothing to differentiate (serving)
    it records no graph and gives the same output."""
    calls = []
    orig = TR.LinearScanFn

    class Counted(orig):
        @staticmethod
        def forward(ctx, a, b):
            calls.append(a.shape)
            return orig.forward(ctx, a, b)
    monkeypatch.setattr(TR, "LinearScanFn", Counted)
    jcfg, tcfg = _cfgs(ARCH)
    p = _block_params(jcfg)[1]
    x = torch.from_numpy(_x(jcfg, 2, 40))
    with torch.no_grad():
        y0 = TR.rglru_fwd(tcfg, p, x)
    y1 = TR.rglru_fwd(tcfg, p, x)
    assert calls == [] and y1.grad_fn is None
    x.requires_grad_(True)
    y2 = TR.rglru_fwd(tcfg, p, x)
    assert calls == [(2, 40, tcfg.lru_width)]
    assert torch.equal(y0, y1) and torch.equal(y0, y2.detach())
    y2.sum().backward()
    assert torch.isfinite(x.grad).all()


def _block_params(jcfg, seed=1, r_near_0=False):
    """One RG-LRU block (JAX ``init_rglru``) as numpy and as tensors; with
    ``r_near_0`` the a-gate's bias at -30, so that r = sigmoid(...) lies
    in ~[5e-15, 2e-12] and a = exp(-8 r softplus(lam)) rounds to 1."""
    np_p = jax.tree.map(np.asarray,
                        JR.init_rglru(jcfg, jax.random.PRNGKey(seed)))
    if r_near_0:
        np_p["ba"] = np.full_like(np_p["ba"], -30.0)
    return np_p, {k: torch.from_numpy(np.array(v)) for k, v in np_p.items()}


def _x(jcfg, B, S, seed=2):
    return (np.random.default_rng(seed).standard_normal(
        (B, S, jcfg.d_model)) * 0.5).astype(np.float32)


@pytest.mark.parametrize("gates", ["drawn", "r_near_0"])
@pytest.mark.parametrize("S", [7, 100])
def test_rglru_fwd_grads_match_jax_vjp(S, gates):
    jcfg, tcfg = _cfgs(ARCH)
    np_p, tp = _block_params(jcfg, r_near_0=gates == "r_near_0")
    x = _x(jcfg, 2, S)
    gy = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, np_p)
    want_y, vjp = jax.vjp(lambda p, xx: JR.rglru_fwd(jcfg, p, xx), jp,
                          jnp.asarray(x))
    want_gp, want_gx = vjp(jnp.asarray(gy))
    leaves = {k: t.requires_grad_(True) for k, t in tp.items()}
    tx = torch.tensor(x, requires_grad=True)
    y = TR.rglru_fwd(tcfg, leaves, tx)
    _close(y.detach(), want_y, atol=1e-5, rtol=1e-5)
    y.backward(torch.from_numpy(gy))
    _close(tx.grad, want_gx, **GRAD_TOL)
    assert leaves["lam"].grad.dtype == torch.float32
    for name, t in leaves.items():
        assert t.grad is not None and torch.isfinite(t.grad).all(), name
        _close(t.grad, want_gp[name], **GRAD_TOL)


FLASH256 = {"window24_softcap30": (True, 24, 30.0),
            "causal": (True, 0, 0.0)}


@pytest.mark.parametrize("mask", list(FLASH256))
def test_plain_flash_backward_at_head_dim_256_matches_jax(mask):
    """RecurrentGemma's attention geometry: 10 q heads on one kv head of
    256, through ``FlashAttentionFn`` on CPU tensors (the plain backward)
    against ``jax.vjp`` of the reference's custom VJP."""
    causal, window, softcap = FLASH256[mask]
    B, S, H, Hkv, D = 2, 80, 10, 1, 256
    rng = np.random.default_rng(256 + window)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    g = rng.standard_normal((B, S, H, D)).astype(np.float32)
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
    got = flash_attention(*leaves, tp, tp, causal=causal, window=window,
                          softcap=softcap)
    got.backward(torch.from_numpy(g))
    _close(got.detach(), out, atol=1e-5, rtol=1e-5)
    for t, w in zip(leaves, want):
        _close(t.grad, w, **BWD_TOL)


def _hybrid_cfgs(head_dim=None):
    jcfg, tcfg = _cfgs(ARCH)
    if head_dim is not None:
        jcfg, tcfg = (dataclasses.replace(c, head_dim=head_dim)
                      for c in (jcfg, tcfg))
    return jcfg, tcfg


def _check_hybrid(jcfg, tcfg, S, remat):
    npp = _np_params(jcfg)
    toks, labels = _batch(tcfg, S=S)
    loss, jl, tp, jg = _loss_and_grads(jcfg, tcfg, npp, toks, labels, remat)
    _close(loss, jl, rtol=1e-5, atol=0)
    _check_grads(tp, jg)
    for stack in (tp["units"]["b0"]["t"], tp["tail"]["t"]):
        assert stack["lam"].dtype == stack["lam"].grad.dtype == torch.float32
        assert stack["lam"].grad.abs().sum() > 0


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "noremat"])
@pytest.mark.parametrize("S", [128, 48])
def test_hybrid_forward_loss_and_every_leaf_grad_match_jax(S, remat):
    jcfg, tcfg = _hybrid_cfgs()
    assert TT._hybrid_counts(tcfg) == (1, 2) and tcfg.local_window == 64
    _check_hybrid(jcfg, tcfg, S, remat)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "noremat"])
def test_hybrid_forward_loss_at_head_dim_256_matches_jax(remat):
    jcfg, tcfg = _hybrid_cfgs(head_dim=256)
    _check_hybrid(jcfg, tcfg, 128, remat)


def test_hybrid_train_step_with_two_microbatches_matches_jax():
    jcfg, tcfg = _cfgs(ARCH)
    npp = _np_params(jcfg)
    toks, labels = _batch(tcfg, B=4, S=128, seed=7)
    halves = [{"tokens": jnp.asarray(toks[i:i + 2]),
               "labels": jnp.asarray(labels[i:i + 2])} for i in (0, 2)]
    jo = joptim.AdamWConfig(lr=1e-3, zero1=False)
    jparams = jax.tree.map(jnp.asarray, npp)
    jopt = joptim.init_opt_state(jparams, 1)
    tp = TT.params_from_numpy(npp, tcfg, device="cpu")
    topt = optim.init_opt_state(tp)
    lam0 = topt["leaves"]["tail"]["t"]["lam"]["master"].clone()
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
            # the moments after one step carry the mean gradient
            # (test_torch_train.py's microbatch test says why later steps
            # are not compared element by element)
            for (_, t), w in zip(optim._pairs(tp, topt["leaves"]),
                                 jax.tree.leaves(
                                     jopt["leaves"],
                                     is_leaf=lambda x: "master" in x)):
                for key in ("m", "v"):
                    _close(t[key], w[key], atol=1e-6, rtol=1e-4)
    lam = topt["leaves"]["tail"]["t"]["lam"]
    assert lam["master"].dtype == torch.float32
    assert not torch.equal(lam["master"], lam0)
    assert torch.equal(tp["tail"]["t"]["lam"], lam["master"].view(
        tp["tail"]["t"]["lam"].shape))


def test_hybrid_train_driver_follows_the_jax_loss_trajectory(capsys):
    """``launch/train.py --arch recurrentgemma_2b`` (weights from the port's
    ``init_params``, handed to JAX as numpy) against the reference's loop
    on the same stream: the same eight losses, falling."""
    losses = train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                         "--dtype", "float32", "--steps", "8", "--batch",
                         "4", "--seq", "128"])
    assert "step 7 loss" in capsys.readouterr().out
    jcfg, tcfg = _cfgs(ARCH)
    start = TT.init_params(tcfg, 0, "cpu")
    jparams = optim.tree_map(lambda t: jnp.asarray(t.numpy()), start)
    jo = joptim.AdamWConfig(lr=train.LR, zero1=False)
    jopt = joptim.init_opt_state(jparams, 1)
    stream = SyntheticLMStream(DataConfig(global_batch=4, seq_len=128,
                                          vocab_size=tcfg.vocab_size))
    want = []
    vg = _jax_value_and_grad(jcfg)
    for i in range(8):
        b = {k: jnp.asarray(v) for k, v in stream.batch_at(i).items()}
        jparams, jopt, jl, _ = _jax_loop_step(vg, jo, jparams, jopt, [b])
        want.append(float(jl))
    _close(losses, want, rtol=1e-4, atol=0)
    assert losses[-1] < losses[0] - 0.1, losses
