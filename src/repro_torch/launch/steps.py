"""The training step on one device: the port's counterpart of the body of
``repro.launch.steps._build_train``.

``train_step`` takes the loss's gradients (``models/transformer.py::
forward_loss``) with respect to every parameter leaf, over ``microbatches``
slices of the batch on dim 0 (grads accumulated in fp32, summed and then
divided by the count, as the reference's scan does; the loss, an MoE
decoder's aux included, is averaged the same way), and applies one AdamW
step (``optim.apply_updates``).  The mesh, the shardings and
``build_cell`` wait for the port's multi-GPU slice.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import optim
from repro_torch.models import transformer as T
from repro_torch.models.api import ModelConfig


def loss_and_grads(cfg: ModelConfig, params, batch, *, remat: bool = True):
    """(loss, grads): ``forward_loss`` and its gradient at every leaf of
    ``params``, as a tree of the same keys in the leaves' dtypes.  The
    params themselves are not marked: the loss runs on detached aliases
    (the same storage) that require grad.  A leaf the loss does not reach
    raises ``ValueError`` naming it (the vision decoder's ``adapter`` in a
    batch without patches: the reference's gradient there is zeros, and
    AdamW's weight decay would still move the leaf)."""
    req = optim.tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = T.forward_loss(cfg, req, batch, remat=remat)
        leaves = optim.tree_leaves(req)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    missed = [name for name, g in zip(_paths(req), grads) if g is None]
    if missed:
        raise ValueError(f"{cfg.name}: the loss does not reach {missed} "
                         f"(a vision decoder's batch needs its patches)")
    it = iter(grads)
    return loss.detach(), _unflatten(req, it)


def _paths(tree, prefix=""):
    """The dotted path of each leaf, in ``optim.tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], f"{prefix}{k}.")]
    return [prefix[:-1]]


def _unflatten(tree, it):
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], it) for k in sorted(tree)}
    return next(it)


def train_step(cfg: ModelConfig, params, opt_state, batch,
               ocfg: optim.AdamWConfig, *, microbatches: int = 1,
               remat: bool = True) -> Dict[str, torch.Tensor]:
    """One training step: the loss and gradients of ``batch`` (``tokens``
    and ``labels``, (B, S) each, on the params' device; the
    encoder-decoder's ``frames`` and the vision decoder's ``patches``
    beside them, and its labels (B, P + S)), over ``microbatches`` equal
    slices of B (every key sliced on dim 0) when more than one, then
    AdamW.
    ``params`` and ``opt_state`` are updated in place.  Returns
    ``{"loss", "grad_norm"}`` (fp32 scalars on the device)."""
    n_mb = microbatches
    if n_mb <= 1:
        loss, grads = loss_and_grads(cfg, params, batch, remat=remat)
    else:
        B = batch["tokens"].shape[0]
        if B % n_mb:
            raise ValueError(f"train_step: batch {B} does not split into "
                             f"{n_mb} microbatches")
        b = B // n_mb
        loss = None
        grads = None
        for j in range(n_mb):
            mb = {k: t[j * b:(j + 1) * b] for k, t in batch.items()}
            l, g = loss_and_grads(cfg, params, mb, remat=remat)
            if grads is None:       # 0 + g, exactly as the reference's
                grads = optim.tree_map(lambda x: x.float(), g)
                loss = l
            else:
                grads = optim.tree_map(lambda a, x: a.add_(x.float()),
                                       grads, g)
                loss = loss + l
            del g
        loss = loss / n_mb
        grads = optim.tree_map(lambda a: a.div_(n_mb), grads)
    _, _, gnorm = optim.apply_updates(ocfg, params, grads, opt_state)
    return {"loss": loss, "grad_norm": gnorm}
