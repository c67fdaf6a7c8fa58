"""Train a decoder on the port's synthetic token stream.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_360m \\
        [--reduced] --steps 8 --batch 16 --seq 4096 --microbatches 2 \\
        [--device cuda] [--ckpt DIR]
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_370m \\
        --steps 5 --batch 16 --seq 4096 --microbatches 2

``--arch`` takes what ``models/transformer.py::check_trainable`` accepts:
the dense decoders (H2O-Danube-1.8B's sliding window among them), the
MoE decoders with GQA attention (Qwen3-30B-A3B, Phi-3.5-MoE; the MoE aux
is in the loss) and the Mamba-2 SSM (Mamba2-370M; its scan's backward is
the ``ssd_scan_bwd`` kernel, and a sequence longer than 64 tokens must be
a multiple of 64).  Full depth: a config too large for one card (the
full Qwen3-30B-A3B's weights, masters and moments) runs out of memory;
the port's multi-GPU slice will shard it.

The counterpart of ``repro.launch.train``'s training path (and of
``examples/train_smollm.py``, whose width cut ``--reduced`` gives):
random weights from ``--seed`` (``init_params``), AdamW (lr 1e-3, as the
reference's driver), ``launch/steps.py::train_step`` with ``remat`` on
``--steps`` batches of ``data/pipeline.py::SyntheticLMStream``
(``labels = tokens``, as the reference's stream).  Prints each step's
loss, grad norm and tokens/s, and with ``--ckpt`` saves the weights by
``runtime/checkpoint.py::save``.  Runs on the card unless ``--device
cpu``.  ``--dry`` (the reference's compile-only check on a production
mesh) waits for the port's multi-GPU slice and raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import torch

from repro_torch import compat, optim
from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
from repro_torch.launch.steps import train_step
from repro_torch.models import transformer as T

LR = 1e-3


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: Optional[List[str]] = None) -> List[float]:
    """Runs the loop; returns each step's loss."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default=None,
                    help="override the config's dtype (e.g. float32)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--dry", action="store_true")
    args = ap.parse_args(argv)
    if args.dry:
        raise NotImplementedError(
            "--dry (compile the train cell on a production mesh) waits for "
            "the port's multi-GPU slice (ROADMAP Queue A item 6)")

    dev = compat.resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    T.check_trainable(cfg)
    params = T.init_params(cfg, args.seed, dev)
    ocfg = optim.AdamWConfig(lr=LR, zero1=False)
    opt = optim.init_opt_state(params)
    stream = SyntheticLMStream(DataConfig(
        global_batch=args.batch, seq_len=args.seq,
        vocab_size=cfg.vocab_size, seed=args.seed))
    print(f"{cfg.name}: {T.param_count(cfg):,} parameters, {cfg.dtype}, "
          f"batch {args.batch} x {args.seq} in {args.microbatches} "
          f"microbatches, on {dev}", flush=True)
    losses = []
    for step in range(args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in stream.batch_at(step).items()}
        _sync(dev)
        t0 = time.perf_counter()
        out = train_step(cfg, params, opt, batch, ocfg,
                         microbatches=args.microbatches)
        loss, gnorm = float(out["loss"]), float(out["grad_norm"])
        secs = time.perf_counter() - t0
        losses.append(loss)
        print(f"step {step} loss {loss:.4f} grad_norm {gnorm:.4f} "
              f"{args.batch * args.seq / secs:.1f} tokens/s", flush=True)
    if args.ckpt:
        from repro_torch.runtime import checkpoint
        checkpoint.save(args.ckpt, params, extra={"steps": args.steps,
                                                  "arch": args.arch})
        print(f"checkpoint saved to {args.ckpt}", flush=True)
    return losses


if __name__ == "__main__":
    main()
