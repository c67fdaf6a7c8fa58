"""Training the vision decoder in the port, held to the JAX package on the
CPU.

Reduced ``pixtral_12b`` in fp32 (2 layers, d_model 128, 4 query heads on 2
kv heads of 32, 8 stub patches, vocab 512); inputs from
``np.random.default_rng(seed)`` (patches at ``frontend_stub``'s 0.02
scale), the JAX side on the same numpy weights.  Cases:

- ``forward_loss`` and the gradient of every leaf against
  ``jax.value_and_grad(repro.models.transformer.forward_loss)``, remat on
  and off, 8 patches before 56 tokens, labels (B, P + S) with -1 over the
  patches (as ``repro.data.pipeline.frontend_stub`` writes them); loss
  rtol 1e-5, gradients ``GRAD_TOL``; ``adapter`` takes a gradient;
- the labels over the patches are ignored: other labels there leave the
  loss unchanged as long as they are negative;
- without patches the loss still follows the reference's, but
  ``steps.loss_and_grads`` raises naming ``adapter``, the leaf the loss
  no longer reaches (the reference would give it a zero gradient);
- ``train_step`` with two microbatches (patches and labels sliced with the
  tokens) against the reference's loop over the two halves;
- eight steps of ``launch/train.py --arch pixtral_12b --reduced --device
  cpu --dtype float32`` (each step's patches from ``frontend_stub``)
  against the reference's loop (rtol 1e-4), with a falling loss.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro_torch.launch import steps
from repro_torch.models import transformer as TT
from test_torch_train import AXES, _cfgs, _close, _np_params
from test_torch_train_encdec import (check_grads, driver_check,
                                     loss_and_grads, make_batch,
                                     microbatch_check)

ARCH = "pixtral_12b"


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "noremat"])
def test_vlm_forward_loss_and_every_leaf_grad_match_jax(remat):
    jcfg, tcfg = _cfgs(ARCH)
    npp = _np_params(jcfg)
    batch = make_batch(tcfg, S=64 - tcfg.num_patches)
    assert batch["labels"].shape == (2, 64)
    assert (batch["labels"][:, :tcfg.num_patches] == -1).all()
    loss, jl, tp, jg = loss_and_grads(jcfg, tcfg, npp, batch, remat)
    _close(loss, jl, rtol=1e-5, atol=0)
    check_grads(tp, jg)
    assert tp["adapter"].grad.abs().sum() > 0


def test_vlm_labels_over_the_patches_are_ignored():
    _, tcfg = _cfgs(ARCH)
    tp = TT.init_params(tcfg, 0, "cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in make_batch(tcfg, S=24).items()}
    other = batch["labels"].clone()
    other[:, :tcfg.num_patches] = -7
    with torch.no_grad():
        a = TT.forward_loss(tcfg, tp, batch)
        b = TT.forward_loss(tcfg, tp, dict(batch, labels=other))
    assert torch.equal(a, b)


def test_vlm_without_patches_the_loss_follows_jax_and_adapter_raises():
    """The reference accepts a batch without patches (its gradient at
    ``adapter`` is then zeros); the port's loss agrees, and its
    ``loss_and_grads`` refuses the batch, naming the unreached leaf."""
    jcfg, tcfg = _cfgs(ARCH)
    npp = _np_params(jcfg)
    batch = make_batch(tcfg, S=32)
    batch.pop("patches")
    batch["labels"] = batch["labels"][:, tcfg.num_patches:]
    jl = JT.forward_loss(jcfg, AXES, jax.tree.map(jnp.asarray, npp),
                         {k: jnp.asarray(v) for k, v in batch.items()})
    tp = TT.params_from_numpy(npp, tcfg, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        _close(TT.forward_loss(tcfg, tp, tb), jl, rtol=1e-5, atol=0)
    with pytest.raises(ValueError, match=r"\['adapter'\]"):
        steps.loss_and_grads(tcfg, tp, tb)


def test_vlm_train_step_with_two_microbatches_matches_jax():
    _, tcfg = _cfgs(ARCH)
    microbatch_check(ARCH, make_batch(tcfg, B=4, S=24, seed=7))


def test_vlm_train_driver_follows_the_jax_loss_trajectory(capsys):
    driver_check(ARCH, capsys)
