"""AdamW with mixed precision: the port's counterpart of ``repro.optim``
on one device.

The optimizer keeps, per parameter leaf, a flat fp32 master copy and the
Adam moments m and v; the step counter drives the bias correction; the
gradients are clipped by their global fp32 norm; weight decay acts on
the master, and each parameter is the master cast to the leaf's dtype.
``apply_updates`` computes what ``repro.optim.apply_updates`` computes,
leaf for leaf (in the JAX package's leaf order: sorted keys), and writes
the parameters and the optimizer state in place under ``torch.no_grad``:
the serving path's per-layer views (``models/transformer._per_layer``)
share the parameters' storage and stay valid.  A leaf is updated in
slices of ``UPDATE_CHUNK`` elements, so that the fp32 temporaries of one
update stay small beside a large leaf (Qwen3-30B-A3B's stacked expert
weights hold 201M parameters a layer); every element's arithmetic is the
same either way.  ZeRO-1 sharding of the
flat leaves over devices (``n_dev > 1``) and ``opt_state_specs`` wait
for the port's multi-GPU slice; on one device there is nothing to shard
and ``zero1`` changes nothing, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    zero1: bool = True          # shard master/m/v over all devices
    max_grad_norm: float = 1.0


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a nested dict in the JAX package's order (sorted
    keys at every level)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree)
                for leaf in tree_leaves(tree[key])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of the trees in ``rest``,
    which share its keys), as a nested dict of the same keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _one_device(n_dev: int) -> None:
    if n_dev != 1:
        raise NotImplementedError(
            f"AdamW over {n_dev} devices (ZeRO-1 sharding of the flat "
            f"leaves) waits for the port's multi-GPU slice; n_dev must be 1")


def init_opt_state(params, n_dev: int = 1) -> Dict[str, Any]:
    """Per leaf a flat fp32 master (a copy of the parameter) and zero
    moments m and v; the step counter (int32) at 0."""
    _one_device(n_dev)

    def make(p):
        f = p.detach().reshape(-1).to(torch.float32).clone()
        return {"master": f, "m": torch.zeros_like(f),
                "v": torch.zeros_like(f)}

    leaves = tree_map(make, params)
    dev = tree_leaves(params)[0].device
    return {"leaves": leaves,
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


# elements of a leaf updated at once
UPDATE_CHUNK = 1 << 26


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, opt_state,
                  n_dev: int = 1):
    """One AdamW step on ``params`` with ``grads`` (a tree of the same
    keys, any float dtype).  Writes the parameters and ``opt_state`` in
    place and returns ``(params, opt_state, grad_norm)``; ``grad_norm`` is
    the fp32 global norm before the clip."""
    _one_device(n_dev)
    step = opt_state["step"] + 1
    stepf = step.to(torch.float32)
    b1c = 1.0 - cfg.b1 ** stepf
    b2c = 1.0 - cfg.b2 ** stepf

    flat_g = tree_leaves(grads)
    sq = sum(torch.sum(torch.square(g.to(torch.float32))) for g in flat_g)
    gnorm = torch.sqrt(sq)
    scale = torch.clamp_max(cfg.max_grad_norm / torch.clamp_min(gnorm, 1e-12),
                            1.0)

    pairs = list(_pairs(params, opt_state["leaves"]))
    if len(pairs) != len(flat_g):
        raise ValueError(f"apply_updates: {len(pairs)} params, "
                         f"{len(flat_g)} grads")
    for (p, st), g in zip(pairs, flat_g):
        flat_p, flat_gl = p.view(-1), g.reshape(-1)
        for a in range(0, flat_gl.numel(), UPDATE_CHUNK):
            sl = slice(a, a + UPDATE_CHUNK)
            gf = flat_gl[sl].to(torch.float32) * scale
            m = cfg.b1 * st["m"][sl] + (1 - cfg.b1) * gf
            v = cfg.b2 * st["v"][sl] + (1 - cfg.b2) * gf * gf
            upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            master = (st["master"][sl] * (1 - cfg.lr * cfg.weight_decay)
                      - cfg.lr * upd)
            st["m"][sl].copy_(m)
            st["v"][sl].copy_(v)
            st["master"][sl].copy_(master)
            flat_p[sl].copy_(master)
    opt_state["step"] = step
    return params, opt_state, gnorm


def _pairs(params, states):
    """(parameter, its ``{"master", "m", "v"}``) in ``tree_leaves`` order."""
    if isinstance(params, dict):
        for key in sorted(params):
            yield from _pairs(params[key], states[key])
    else:
        yield params, states
