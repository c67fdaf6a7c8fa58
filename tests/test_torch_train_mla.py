"""Training MLA in the port (DeepSeek-R1's latent attention in MoE layers
with a shared expert), held to the JAX package on the CPU.

Reduced ``deepseek_r1`` in fp32 (2 layers, d_model 128, 4 heads of 32 +
16 rope columns over latents of 64 (q) and 32 (kv), 4 experts top-2 of
d_ff 64 and one shared expert of 64, vocab 512), so its attention runs at
q/k head dim 48 and v head dim 32; inputs from
``np.random.default_rng(seed)``, the JAX side on the same numpy weights.
Cases:

- one MLA layer's ``mla_fwd`` under autograd: the flash forward goes
  through ``FlashAttentionFn`` and its backward through the plain
  backward at (48, 32) (the kernel's CPU path), and the gradients at x
  and at every attention leaf match ``jax.vjp`` of
  ``repro.models.layers.mla_fwd`` (atol 1e-5, rtol 1e-4);
- ``forward_loss`` (cross-entropy + ``AUX_COEF`` x the layers' aux over
  their count) and the gradient of every leaf against
  ``jax.value_and_grad(repro.models.transformer.forward_loss)``, remat on
  and off; loss rtol 1e-5, gradients ``GRAD_TOL``; every MLA leaf, the
  shared expert and the router take a gradient;
- ``train_step`` with two microbatches against the reference's loop;
- eight steps of ``launch/train.py --arch deepseek_r1 --reduced --device
  cpu --dtype float32`` against the reference's loop (rtol 1e-4), with a
  falling loss.

The card's backward at DeepSeek-R1's own (192, 128) is held to the plain
version in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch import optim
from repro_torch.kernels.flash_attention_bwd import ops as bwd_ops
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as TT
from test_torch_train import _cfgs, _close, _np_params
from test_torch_train_encdec import (check_grads, driver_check,
                                     loss_and_grads, make_batch,
                                     microbatch_check)

ARCH = "deepseek_r1"


def test_mla_layer_backward_runs_the_plain_flash_backward_at_48_32(
        monkeypatch):
    jcfg, tcfg = _cfgs(ARCH)
    assert (tcfg.head_dim + tcfg.rope_head_dim, tcfg.head_dim) == (48, 32)
    npp = _np_params(jcfg)
    p_np = jax.tree.map(lambda a: a[0], npp["layers"]["attn"])
    rng = np.random.default_rng(5)
    B, S = 2, 40
    x = (rng.standard_normal((B, S, tcfg.d_model)) * 0.5).astype(np.float32)
    g = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()

    out, vjp = jax.vjp(lambda xx, pp: jlayers.mla_fwd(jcfg, pp, xx,
                                                      jnp.asarray(pos))[0],
                       jnp.asarray(x), jax.tree.map(jnp.asarray, p_np))
    jx, jp = vjp(jnp.asarray(g))

    seen = []
    orig = bwd_ops.flash_attention_bwd_plain

    def record(q, k, v, *a, **kw):
        seen.append((q.shape[-1], k.shape[-1], v.shape[-1]))
        return orig(q, k, v, *a, **kw)
    monkeypatch.setattr(bwd_ops, "flash_attention_bwd_plain", record)
    tx = torch.tensor(x, requires_grad=True)
    tp = {k: torch.tensor(np.asarray(v), requires_grad=True)
          for k, v in p_np.items()}
    y, _ = tlayers.mla_fwd(tcfg, tp, tx, torch.from_numpy(pos))
    y.backward(torch.from_numpy(g))
    assert seen == [(48, 48, 32)]
    _close(y.detach(), out, atol=1e-5, rtol=1e-5)
    _close(tx.grad, jx, atol=1e-5, rtol=1e-4)
    for name, t in tp.items():
        _close(t.grad, jp[name], atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "noremat"])
def test_mla_forward_loss_and_every_leaf_grad_match_jax(remat):
    jcfg, tcfg = _cfgs(ARCH)
    npp = _np_params(jcfg)
    batch = make_batch(tcfg)
    loss, jl, tp, jg = loss_and_grads(jcfg, tcfg, npp, batch, remat)
    _close(loss, jl, rtol=1e-5, atol=0)
    check_grads(tp, jg)
    for leaf in optim.tree_leaves(tp["layers"]["attn"]):
        assert leaf.grad.abs().sum() > 0
    for name in ("wg", "w1", "w2"):
        assert tp["layers"]["moe"][name].grad.abs().sum() > 0
    for leaf in optim.tree_leaves(tp["layers"]["moe"]["shared"]):
        assert leaf.grad.abs().sum() > 0


def test_mla_train_step_with_two_microbatches_matches_jax():
    _, tcfg = _cfgs(ARCH)
    microbatch_check(ARCH, make_batch(tcfg, B=4, S=32, seed=7))


def test_mla_train_driver_follows_the_jax_loss_trajectory(capsys):
    driver_check(ARCH, capsys)
