"""Training the Mamba-2 SSM in the port, held to the JAX package on the CPU.

fp32 throughout; inputs from ``np.random.default_rng(seed)``, the JAX side
on the same numpy weights.  Cases:

- ``ssd_state_scan_bwd_plain`` (the adjoint recurrence between chunks)
  against ``jax.vjp`` of ``repro.kernels.ssd_scan.ref.ref_state_scan`` at
  the JAX kernel test's shapes, one chunk, Mamba2-370M's N 128 x P 64 and
  a ragged N * P, with dfinal None (zeros to JAX) and drawn: dstates to
  atol 1e-5, rtol 1e-5 (the same fp32 operations; XLA may contract them
  into an FMA), ddecay, a sum of N * P products that XLA adds in another
  order, to atol 1e-5 + 1e-7 x the sum of the products' magnitudes (~2
  ulps of it), rtol 1e-5; None gives the bits of explicit zeros;
- ``SsdScanFn`` under ``torch.autograd.gradcheck`` in fp64, with ``final``
  used and unused (dfinal None), and its backward equal to the plain
  backward on the forward's ``prev``;
- ``ssd_chunked``'s gradients in xh, dt, A, Bm and Cm against
  ``jax.vjp(repro.models.ssm.ssd_chunked)``, with 1 and 2 groups, final
  used and unused, and a steep dt (|dt * A| up to ~560 a step: the
  exponents above the diagonal would overflow unmasked): atol 1e-4, rtol
  1e-3, all finite;
- ``ssd_chunked`` scans through ``SsdScanFn``, which records no graph
  when nothing is differentiated (serving) and gives the same outputs;
- ``forward_loss`` and every leaf's gradient against
  ``jax.value_and_grad(repro.models.transformer.forward_loss)`` on reduced
  Mamba2-370M, remat on and off, at S 128 (two chunks) and S 48 (one
  chunk of 48): loss rtol 1e-5, gradients atol 1e-4, rtol 1e-3 (as
  ``test_torch_train.py``), fp32 leaves (``dt_bias``, ``A_log``,
  ``D_skip``) with fp32 gradients;
- ``train_step`` with two microbatches against the reference's loop over
  the two halves (loss rtol 1e-5, grad norm rtol 1e-4, the moments after
  the first step atol 1e-6, rtol 1e-4);
- eight steps of ``launch/train.py --arch mamba2_370m --reduced --device
  cpu --dtype float32`` against the reference's loop on the same stream
  and weights (rtol 1e-4), with a falling loss.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.kernels.ssd_scan.ref import ref_state_scan
from repro.models import ssm as JS
from repro_torch import kernels, optim
from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
from repro_torch.kernels.ssd_scan.ops import SsdScanFn, ssd_state_scan
from repro_torch.kernels.ssd_scan_bwd.ops import (ssd_state_scan_bwd,
                                                  ssd_state_scan_bwd_plain)
from repro_torch.launch import steps, train
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from test_torch_train import (GRAD_TOL, _batch, _cfgs, _close,
                              _jax_loop_step, _jax_value_and_grad, _np_params)
from test_torch_train_moe import _check_grads, _loss_and_grads

ARCH = "mamba2_370m"
SCAN_TOL = dict(atol=1e-5, rtol=1e-5)

# (B, H, nc, N, P): the JAX kernel test's shapes, one chunk, Mamba2-370M's
# state (N 128, P 64) over 4 chunks, a ragged N * P
BWD_SHAPES = [(2, 4, 8, 16, 8), (1, 2, 16, 32, 16), (2, 3, 1, 16, 8),
              (1, 2, 4, 128, 64), (2, 3, 5, 7, 3)]


def _scan_inputs(shape, seed):
    r = np.random.default_rng(seed)
    B, H, nc, N, P = shape
    s = r.standard_normal(shape).astype(np.float32)
    d = (r.random((B, H, nc)) * 0.9 + 0.05).astype(np.float32)
    dprev = r.standard_normal(shape).astype(np.float32)
    dfinal = r.standard_normal((B, H, N, P)).astype(np.float32)
    return s, d, dprev, dfinal


@pytest.mark.parametrize("final", ["none", "drawn"])
@pytest.mark.parametrize("shape", BWD_SHAPES,
                         ids=["x".join(map(str, s)) for s in BWD_SHAPES])
def test_scan_bwd_plain_matches_jax_vjp(shape, final):
    s, d, dprev, dfinal = _scan_inputs(shape, sum(shape))
    if final == "none":
        dfinal_j = np.zeros_like(dfinal)
    else:
        dfinal_j = dfinal
    (jprev, _), vjp = jax.vjp(ref_state_scan, jnp.asarray(s), jnp.asarray(d))
    jds, jdd = vjp((jnp.asarray(dprev), jnp.asarray(dfinal_j)))
    prev = torch.from_numpy(np.asarray(jprev).copy())
    kernels.reset_launches()
    ds, dd = ssd_state_scan_bwd(
        prev, torch.from_numpy(d), torch.from_numpy(dprev),
        None if final == "none" else torch.from_numpy(dfinal))
    assert kernels.launches()["ssd_scan_bwd"] == 0  # the CPU: plain version
    assert ds.shape == shape and dd.shape == shape[:3]
    assert ds.dtype == dd.dtype == torch.float32
    _close(ds, jds, **SCAN_TOL)
    mag = (ds.abs() * prev.abs()).sum(dim=(-2, -1)).numpy()
    err = np.abs(dd.numpy() - np.asarray(jdd))
    assert (err <= 1e-5 + 1e-7 * mag + 1e-5 * np.abs(np.asarray(jdd))).all(), \
        err.max()
    # the last chunk's dS is dfinal; chunk 0 enters at zero, so its dd is 0
    _close(ds[:, :, -1], dfinal_j, atol=0, rtol=0)
    assert not dd[:, :, 0].any()


def test_scan_bwd_none_is_zeros_bit_for_bit():
    s, d, dprev, dfinal = _scan_inputs((2, 3, 6, 8, 4), 3)
    prev, _ = ssd_state_scan(torch.from_numpy(s), torch.from_numpy(d))
    args = (prev, torch.from_numpy(d), torch.from_numpy(dprev))
    for a, b in zip(ssd_state_scan_bwd_plain(*args, None),
                    ssd_state_scan_bwd_plain(*args,
                                             torch.zeros_like(prev[:, :, 0]))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("final", ["used", "unused"])
def test_ssd_scan_fn_gradcheck_fp64(final):
    r = np.random.default_rng(11)
    shape = (1, 2, 4, 3, 2)
    s = torch.tensor(r.standard_normal(shape), requires_grad=True)
    d = torch.tensor(r.random(shape[:3]) * 0.9 + 0.05, requires_grad=True)

    def fn(states, decay):
        prev, fin = SsdScanFn.apply(states, decay)
        return (prev, fin) if final == "used" else prev
    assert torch.autograd.gradcheck(fn, (s, d), eps=1e-6, atol=1e-8)


def test_ssd_scan_fn_backward_is_the_plain_backward():
    s, d, dprev, dfinal = _scan_inputs((2, 4, 5, 16, 8), 4)
    st = torch.from_numpy(s).requires_grad_(True)
    dc = torch.from_numpy(d).requires_grad_(True)
    prev, fin = SsdScanFn.apply(st, dc)
    torch.autograd.backward((prev, fin), (torch.from_numpy(dprev),
                                          torch.from_numpy(dfinal)))
    want = ssd_state_scan_bwd_plain(prev.detach(), torch.from_numpy(d),
                                    torch.from_numpy(dprev),
                                    torch.from_numpy(dfinal))
    assert torch.equal(st.grad, want[0]) and torch.equal(dc.grad, want[1])


# (groups, final used, dt scale): a steep dt drives the exponents above the
# diagonal past fp32's range unless masked first
CHUNKED_CASES = [(1, True, 1.0), (2, True, 1.0), (1, False, 1.0),
                 (2, False, 12.0)]


@pytest.mark.parametrize("g,final,scale", CHUNKED_CASES,
                         ids=[f"g{g}_{'final' if f else 'nofinal'}_dt{s:g}"
                              for g, f, s in CHUNKED_CASES])
def test_ssd_chunked_grads_match_jax_vjp(g, final, scale):
    r = np.random.default_rng(20 + g)
    b, S, h, p, n, chunk = 2, 64, 4, 8, 16, 16
    xh = (0.5 * r.standard_normal((b, S, h, p))).astype(np.float32)
    dt = (scale * np.log1p(np.exp(r.standard_normal((b, S, h))))) \
        .astype(np.float32)
    A = -np.linspace(1.0, 16.0, h).astype(np.float32)
    Bm = (0.5 * r.standard_normal((b, S, g, n))).astype(np.float32)
    Cm = (0.5 * r.standard_normal((b, S, g, n))).astype(np.float32)
    gy = r.standard_normal((b, S, h, p)).astype(np.float32)
    gf = (r.standard_normal((b, h, n, p)) if final
          else np.zeros((b, h, n, p))).astype(np.float32)
    inputs = (xh, dt, A, Bm, Cm)
    (jy, jf), vjp = jax.vjp(lambda *a: JS.ssd_chunked(*a, chunk=chunk),
                            *map(jnp.asarray, inputs))
    want = vjp((jnp.asarray(gy), jnp.asarray(gf)))
    leaves = [torch.tensor(x, requires_grad=True) for x in inputs]
    ty, tf = TS.ssd_chunked(*leaves, chunk=chunk)
    _close(ty.detach(), jy, atol=1e-5, rtol=1e-5)
    if final:
        torch.autograd.backward((ty, tf), (torch.from_numpy(gy),
                                           torch.from_numpy(gf)))
    else:
        ty.backward(torch.from_numpy(gy))
    for name, t, w in zip(("xh", "dt", "A", "Bm", "Cm"), leaves, want):
        assert torch.isfinite(t.grad).all(), name
        assert np.isfinite(np.asarray(w)).all(), name
        _close(t.grad, w, **GRAD_TOL)


def test_ssd_chunked_scans_through_the_autograd_node(monkeypatch):
    """``ssd_chunked`` scans through ``SsdScanFn``, once a call: with
    nothing to differentiate (serving) it records no graph and gives the
    same y as under autograd, whose graph holds the node."""
    calls = []

    class Counted(SsdScanFn):
        @staticmethod
        def forward(ctx, states, decay):
            calls.append(states.shape)
            return SsdScanFn.forward(ctx, states, decay)
    monkeypatch.setattr(TS, "SsdScanFn", Counted)
    r = np.random.default_rng(5)
    b, S, h, p, n = 1, 32, 2, 4, 8
    args = [torch.from_numpy(x.astype(np.float32)) for x in (
        r.standard_normal((b, S, h, p)), r.random((b, S, h)) + 0.1,
        -np.linspace(1.0, 2.0, h), r.standard_normal((b, S, 1, n)),
        r.standard_normal((b, S, 1, n)))]
    y0, f0 = TS.ssd_chunked(*args, chunk=8)
    assert y0.grad_fn is None and f0.grad_fn is None
    args[0].requires_grad_(True)
    y1, f1 = TS.ssd_chunked(*args, chunk=8)
    assert calls == [(b, h, S // 8, n, p)] * 2
    assert f1.grad_fn is not None and \
        type(f1.grad_fn).__name__.startswith("Counted")
    assert torch.equal(y0, y1.detach()) and torch.equal(f0, f1.detach())
    y1.sum().backward()
    assert torch.isfinite(args[0].grad).all()


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "noremat"])
@pytest.mark.parametrize("S", [128, 48])
def test_ssm_forward_loss_and_every_leaf_grad_match_jax(S, remat):
    jcfg, tcfg = _cfgs(ARCH)
    npp = _np_params(jcfg)
    toks, labels = _batch(tcfg, S=S)
    loss, jl, tp, jg = _loss_and_grads(jcfg, tcfg, npp, toks, labels, remat)
    _close(loss, jl, rtol=1e-5, atol=0)
    _check_grads(tp, jg)
    ssm = tp["layers"]["ssm"]
    for name in ("dt_bias", "A_log", "D_skip"):
        assert ssm[name].dtype == ssm[name].grad.dtype == torch.float32
        assert ssm[name].grad.abs().sum() > 0


def test_ssm_train_step_with_two_microbatches_matches_jax():
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
    for name in ("dt_bias", "A_log", "D_skip"):
        assert tp["layers"]["ssm"][name].dtype == torch.float32


def test_ssm_train_driver_follows_the_jax_loss_trajectory(capsys):
    """``launch/train.py --arch mamba2_370m`` (weights from the port's
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
