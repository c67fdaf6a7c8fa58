"""Training the encoder-decoder in the port, held to the JAX package on the
CPU.

Reduced ``whisper_base`` in fp32 (2 encoder and 2 decoder layers, d_model
128, 4 query heads on 2 kv heads of 32, LayerNorm, sinusoid positions, 32
stub frames, vocab 512); inputs from ``np.random.default_rng(seed)``
(frames at ``frontend_stub``'s 0.02 scale), the JAX side on the same numpy
weights.  Cases:

- ``forward_loss`` and the gradient of every leaf against
  ``jax.value_and_grad(repro.models.transformer.forward_loss)``, remat on
  and off, at 64 decoder tokens and past one cross-entropy chunk (1024
  tokens, two chunks of ``CE_CHUNK``); loss rtol 1e-5, gradients
  ``GRAD_TOL`` (atol 1e-4, rtol 1e-3, as ``test_torch_train.py``); the
  encoder's leaves, ``adapter`` among them, and every decoder layer's
  cross-attention take a gradient;
- the encoder states' gradient is the sum over the decoder layers that
  read them: the loss as a function of the states, taken once through all
  layers, equals the sum of its per-layer parts;
- a batch without frames, or with frames of the wrong length, is refused;
- ``train_step`` with two microbatches (frames sliced with the tokens)
  against the reference's loop over the two halves (loss rtol 1e-5, grad
  norm rtol 1e-4, and after the first step the moments m and v, atol
  1e-6, rtol 1e-4);
- eight steps of ``launch/train.py --arch whisper_base --reduced --device
  cpu --dtype float32`` (each step's frames from ``frontend_stub``)
  against the reference's loop on the same batches and weights (rtol
  1e-4), with a falling loss.

``loss_and_grads`` and ``check_grads`` are shared with
``test_torch_train_vlm.py`` and ``test_torch_train_mla.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.models import transformer as JT
from repro_torch import optim
from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
from repro_torch.launch import steps, train
from repro_torch.models import transformer as TT
from test_torch_train import (AXES, GRAD_TOL, _cfgs, _close, _jax_loop_step,
                              _jax_value_and_grad, _np_params)

ARCH = "whisper_base"


def make_batch(tcfg, B=2, S=64, seed=1):
    """Tokens and labels (B, S), some labels -1, and the family's stub:
    frames (B, encoder_seq, D) or patches (B, P, D) at 0.02, the labels
    then -1 over the patches."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, tcfg.vocab_size, (B, S)).astype(np.int32)
    labels = toks.copy()
    labels[0, :5] = -1
    b = {"tokens": toks, "labels": labels}
    if tcfg.family == "audio":
        b["frames"] = (rng.standard_normal(
            (B, tcfg.encoder_seq, tcfg.d_model)) * 0.02).astype(np.float32)
    if tcfg.family == "vlm":
        b["patches"] = (rng.standard_normal(
            (B, tcfg.num_patches, tcfg.d_model)) * 0.02).astype(np.float32)
        b["labels"] = np.concatenate(
            [np.full((B, tcfg.num_patches), -1, np.int32), labels], 1)
    return b


def loss_and_grads(jcfg, tcfg, npp, batch, remat):
    """(port loss, JAX loss, port params with .grad, JAX grads) of one
    numpy ``batch`` on the numpy weights ``npp``."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jg = jax.value_and_grad(
        lambda p: JT.forward_loss(jcfg, AXES, p, jb, remat=remat))(
        jax.tree.map(jnp.asarray, npp))
    tp = optim.tree_map(lambda t: t.requires_grad_(True),
                        TT.params_from_numpy(npp, tcfg, device="cpu"))
    loss = TT.forward_loss(tcfg, tp, {k: torch.from_numpy(v)
                                      for k, v in batch.items()},
                           remat=remat)
    loss.backward()
    return loss.detach(), jl, tp, jg


def check_grads(tp, jg):
    """Every port leaf has a gradient, of the JAX leaf's shape and within
    ``GRAD_TOL`` of it."""
    got = optim.tree_leaves(tp)
    want = jax.tree.leaves(jg)
    assert len(got) == len(want)
    assert all(t.grad is not None for t in got)
    for t, w in zip(got, want):
        assert t.grad.shape == w.shape
        _close(t.grad, w, **GRAD_TOL)


def microbatch_check(arch, batch, seed=0):
    """``train_step`` with two microbatches against the reference's loop
    over the two halves of ``batch`` (every key sliced on dim 0): two
    steps' loss and grad norm, and the moments after the first."""
    jcfg, tcfg = _cfgs(arch)
    npp = _np_params(jcfg, seed=seed)
    B = batch["tokens"].shape[0]
    halves = [{k: jnp.asarray(v[i:i + B // 2]) for k, v in batch.items()}
              for i in (0, B // 2)]
    jo = joptim.AdamWConfig(lr=1e-3, zero1=False)
    jparams = jax.tree.map(jnp.asarray, npp)
    jopt = joptim.init_opt_state(jparams, 1)
    tp = TT.params_from_numpy(npp, tcfg, device="cpu")
    topt = optim.init_opt_state(tp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    vg = _jax_value_and_grad(jcfg)
    for step in range(2):
        jparams, jopt, jl, jn = _jax_loop_step(vg, jo, jparams, jopt,
                                               halves)
        out = steps.train_step(tcfg, tp, topt, tb,
                               optim.AdamWConfig(lr=1e-3, zero1=False),
                               microbatches=2)
        _close(out["loss"], jl, rtol=1e-5, atol=0)
        _close(out["grad_norm"], jn, rtol=1e-4, atol=1e-6)
        if step == 0:       # as test_torch_train.py's microbatch test
            for (_, t), w in zip(optim._pairs(tp, topt["leaves"]),
                                 jax.tree.leaves(
                                     jopt["leaves"],
                                     is_leaf=lambda x: "master" in x)):
                for key in ("m", "v"):
                    _close(t[key], w[key], atol=1e-6, rtol=1e-4)


def driver_check(arch, capsys, steps_n=8, B=4, S=32):
    """``launch/train.py --arch arch --reduced --device cpu --dtype
    float32`` (weights from the port's ``init_params``, handed to JAX as
    numpy; each step's batch from ``train.step_batch``, the stub frames or
    patches included) against the reference's loop on the same batches:
    the same losses, falling."""
    losses = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                         "--dtype", "float32", "--steps", str(steps_n),
                         "--batch", str(B), "--seq", str(S)])
    assert f"step {steps_n - 1} loss" in capsys.readouterr().out
    jcfg, tcfg = _cfgs(arch)
    start = TT.init_params(tcfg, 0, "cpu")
    jparams = optim.tree_map(lambda t: jnp.asarray(t.numpy()), start)
    jo = joptim.AdamWConfig(lr=train.LR, zero1=False)
    jopt = joptim.init_opt_state(jparams, 1)
    stream = SyntheticLMStream(DataConfig(global_batch=B, seq_len=S,
                                          vocab_size=tcfg.vocab_size))
    want = []
    vg = _jax_value_and_grad(jcfg)
    for i in range(steps_n):
        b = {k: jnp.asarray(v)
             for k, v in train.step_batch(tcfg, stream, i).items()}
        jparams, jopt, jl, _ = _jax_loop_step(vg, jo, jparams, jopt, [b])
        want.append(float(jl))
    _close(losses, want, rtol=1e-4, atol=0)
    assert losses[-1] < losses[0] - 0.1, losses
    return losses


@pytest.mark.parametrize("remat,S", [(True, 64), (False, 64), (True, 1024)],
                         ids=["remat", "noremat", "remat_S1024_two_ce_chunks"])
def test_encdec_forward_loss_and_every_leaf_grad_match_jax(remat, S):
    assert S <= TT.CE_CHUNK or S == 2 * TT.CE_CHUNK
    jcfg, tcfg = _cfgs(ARCH)
    npp = _np_params(jcfg)
    batch = make_batch(tcfg, S=S)
    loss, jl, tp, jg = loss_and_grads(jcfg, tcfg, npp, batch, remat)
    _close(loss, jl, rtol=1e-5, atol=0)
    check_grads(tp, jg)
    assert tp["adapter"].grad.abs().sum() > 0
    for i in range(tcfg.num_layers):     # each layer's cross-attention
        assert tp["layers"]["xattn"]["wk"].grad[i].abs().sum() > 0
    for leaf in optim.tree_leaves(tp["enc_layers"]):
        assert leaf.grad.abs().sum() > 0


def test_encdec_encoder_states_gradient_sums_over_the_decoder_layers():
    """The gradient at the encoder's states, through all decoder layers at
    once, equals the sum over layers of the gradient when only that
    layer's cross-attention reads them (the others read a detached
    copy)."""
    _, tcfg = _cfgs(ARCH)
    tp = TT.init_params(tcfg, 0, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(tcfg).items()}
    enc, enc_pos = TT._encode(tcfg, tp, batch["frames"])
    h0, positions = TT._assemble_inputs(tcfg, tp, batch["tokens"])

    def grad_at_states(readers):
        st = enc.detach().clone().requires_grad_(True)
        h = h0
        for i in range(tcfg.num_layers):
            src = st if i in readers else st.detach()
            h, _ = TT._train_dec_layer(tcfg, tp["layers"], i, h, positions,
                                       None, enc=(src, enc_pos))
        h = TT.layers.apply_norm(tcfg, tp["final_norm"], h)
        TT._chunked_ce(tcfg, tp, h, batch["labels"]).backward()
        return st.grad

    whole = grad_at_states(set(range(tcfg.num_layers)))
    parts = [grad_at_states({i}) for i in range(tcfg.num_layers)]
    assert all(p.abs().sum() > 0 for p in parts)
    _close(whole, sum(parts), atol=1e-7, rtol=1e-5)


def test_encdec_forward_loss_needs_its_frames():
    _, tcfg = _cfgs(ARCH)
    tp = TT.init_params(tcfg, 0, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(tcfg).items()}
    frames = batch.pop("frames")
    with pytest.raises(ValueError, match="frames"):
        TT.forward_loss(tcfg, tp, batch)
    with pytest.raises(ValueError, match="frames"):
        TT.forward_loss(tcfg, tp, dict(batch, frames=frames[:, :16]))
    with pytest.raises(ValueError, match="frames"):
        TT.forward_loss(tcfg, tp, dict(batch, frames=frames,
                                       patches=frames))


def test_encdec_train_step_with_two_microbatches_matches_jax():
    _, tcfg = _cfgs(ARCH)
    microbatch_check(ARCH, make_batch(tcfg, B=4, S=32, seed=7))


def test_encdec_train_driver_follows_the_jax_loss_trajectory(capsys):
    driver_check(ARCH, capsys)
