"""Training the MoE decoders in the port, held to the JAX package on the CPU.

fp32 throughout, reduced configs (2 layers, d_model 128, 4 experts top-2,
expert d_ff 64); inputs from ``np.random.default_rng(seed)``, the JAX side
on the same numpy weights.  Cases:

- ``forward_loss`` (cross-entropy + ``AUX_COEF`` x the layers' aux over
  their count) and the gradient of every leaf against
  ``jax.value_and_grad(repro.models.transformer.forward_loss)`` on reduced
  Qwen3-30B-A3B and Phi-3.5-MoE, remat on and off, and with a capacity
  factor of 0.5 that drops choices (dropped choices get no gradient, as
  the reference's fill gather); loss rtol 1e-5, gradients ``GRAD_TOL``
  (atol 1e-4, rtol 1e-3, as ``test_torch_train.py``);
- the aux's share of the loss: the port's loss less its cross-entropy is
  ``AUX_COEF`` x the mean of the layers' aux (rtol 1e-5);
- ``train_step`` with two microbatches against the reference's loop over
  the two halves (loss rtol 1e-5, grad norm rtol 1e-4, and after the first
  step the moments m and v, atol 1e-6, rtol 1e-4);
- eight steps of ``launch/train.py --arch qwen3_moe_30b --reduced
  --device cpu --dtype float32`` against the reference's loop on the same
  stream and weights (rtol 1e-4), with a falling loss.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import optim as joptim
from repro.models import transformer as JT
from repro_torch import optim
from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
from repro_torch.kernels.moe_gemm import ops as moe_ops
from repro_torch.launch import steps, train
from repro_torch.models import transformer as TT
from test_torch_train import (AXES, GRAD_TOL, _batch, _cfgs, _close,
                              _jax_loop_step, _jax_value_and_grad, _np_params)

MOE = ["qwen3_moe_30b", "phi3_5_moe"]


def _loss_and_grads(jcfg, tcfg, npp, toks, labels, remat):
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
    return loss.detach(), jl, tp, jg


def _check_grads(tp, jg):
    got = optim.tree_leaves(tp)
    want = jax.tree.leaves(jg)
    assert len(got) == len(want)
    assert all(t.grad is not None for t in got)
    for t, w in zip(got, want):
        assert t.grad.shape == w.shape
        _close(t.grad, w, **GRAD_TOL)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "noremat"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_forward_loss_and_every_leaf_grad_match_jax(arch, remat):
    jcfg, tcfg = _cfgs(arch)
    npp = _np_params(jcfg)
    toks, labels = _batch(tcfg)
    loss, jl, tp, jg = _loss_and_grads(jcfg, tcfg, npp, toks, labels, remat)
    _close(loss, jl, rtol=1e-5, atol=0)
    _check_grads(tp, jg)
    # every expert weight and the router take a gradient
    for name in ("w1", "w3", "w2", "wg"):
        assert tp["layers"]["moe"][name].grad.abs().sum() > 0


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "noremat"])
def test_moe_grads_match_jax_with_capacity_drops(remat, monkeypatch):
    """A capacity factor of 0.5 leaves each expert half its mean share:
    choices are dropped (checked on the plans the port's layers make), and
    the loss and gradients still follow the reference's."""
    jcfg, tcfg = _cfgs("qwen3_moe_30b")
    jcfg = dataclasses.replace(jcfg, capacity_factor=0.5)
    tcfg = dataclasses.replace(tcfg, capacity_factor=0.5)
    kept = []
    orig = moe_ops.dispatch_plan

    def record(*a, **kw):
        plan = orig(*a, **kw)
        kept.append((int(plan.keep.sum()), plan.keep.numel()))
        return plan
    monkeypatch.setattr(moe_ops, "dispatch_plan", record)
    npp = _np_params(jcfg, seed=3)
    toks, labels = _batch(tcfg, seed=4)
    loss, jl, tp, jg = _loss_and_grads(jcfg, tcfg, npp, toks, labels, remat)
    assert kept and all(k < n for k, n in kept), kept
    _close(loss, jl, rtol=1e-5, atol=0)
    _check_grads(tp, jg)


def test_moe_loss_carries_the_aux(monkeypatch):
    """The loss is the cross-entropy plus AUX_COEF x the layers' summed aux
    over their count (the aux of each layer read off ``moe_fwd``)."""
    _, tcfg = _cfgs("qwen3_moe_30b")
    tp = TT.init_params(tcfg, 0, "cpu")
    toks, labels = _batch(tcfg, seed=9)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    auxes, ces = [], []
    orig_moe, orig_ce = TT.moe.moe_fwd, TT._chunked_ce

    def moe_fwd(cfg, p, x, *share):
        y, aux = orig_moe(cfg, p, x, *share)
        auxes.append(aux)
        return y, aux

    def chunked_ce(*a):
        ces.append(orig_ce(*a))
        return ces[-1]
    monkeypatch.setattr(TT.moe, "moe_fwd", moe_fwd)
    monkeypatch.setattr(TT, "_chunked_ce", chunked_ce)
    with torch.no_grad():
        loss = TT.forward_loss(tcfg, tp, batch, remat=False)
    assert len(auxes) == tcfg.num_layers and len(ces) == 1
    aux = sum(float(a) for a in auxes)
    assert aux > 0
    _close(float(loss) - float(ces[0]),
           TT.AUX_COEF * aux / tcfg.num_layers, rtol=1e-5, atol=1e-7)
    assert TT.AUX_COEF == JT.AUX_COEF


def test_moe_train_step_with_two_microbatches_matches_jax():
    jcfg, tcfg = _cfgs("qwen3_moe_30b")
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
            # the moments after one step are the microbatches' mean
            # gradient and its square, element by element (later steps:
            # see test_torch_train.py's microbatch test)
            for (_, t), w in zip(optim._pairs(tp, topt["leaves"]),
                                 jax.tree.leaves(
                                     jopt["leaves"],
                                     is_leaf=lambda x: "master" in x)):
                for key in ("m", "v"):
                    _close(t[key], w[key], atol=1e-6, rtol=1e-4)


def test_moe_train_driver_follows_the_jax_loss_trajectory(capsys):
    """``launch/train.py --arch qwen3_moe_30b`` (weights from the port's
    ``init_params``, handed to JAX as numpy) against the reference's loop
    on the same stream: the same eight losses, falling."""
    losses = train.main(["--arch", "qwen3_moe_30b", "--reduced", "--device",
                         "cpu", "--dtype", "float32", "--steps", "8",
                         "--batch", "4", "--seq", "32"])
    assert "step 7 loss" in capsys.readouterr().out
    jcfg, tcfg = _cfgs("qwen3_moe_30b")
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
