"""Train a decoder on the port's synthetic token stream.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_360m \\
        [--reduced] --steps 8 --batch 16 --seq 4096 --microbatches 2 \\
        [--device cuda] [--ckpt DIR]
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_370m \\
        --steps 5 --batch 16 --seq 4096 --microbatches 2
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch recurrentgemma_2b --steps 5 --batch 4 --seq 8192 \\
        --microbatches 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper_base \\
        --steps 5 --batch 16 --seq 448 --microbatches 2

``--arch`` takes every family of the configs
(``models/transformer.py::check_trainable``): the dense decoders
(H2O-Danube-1.8B's sliding window among them), the MoE decoders
(Qwen3-30B-A3B, Phi-3.5-MoE, and DeepSeek-R1 with MLA attention, whose
backward is the flash backward kernel at q/k 192, v 128; the MoE aux is
in the loss), the Mamba-2 SSM (Mamba2-370M; its scan's backward is the
``ssd_scan_bwd`` kernel, and a sequence longer than 64 tokens must be a
multiple of 64), the RecurrentGemma hybrid (RecurrentGemma-2B: its local
attention's backward is the flash backward kernel at head dim 256, its
RG-LRU scan's the adjoint recurrence of ``models/rglru.py::
LinearScanFn``; remat checkpoints each unit and each tail layer), the
Whisper encoder-decoder (each step's batch carries ``encoder_seq`` stub
frames a row) and the Pixtral vision decoder (``num_patches`` stub
patches a row before its ``--seq`` text tokens, labels -1 over them).
The stub embeddings are ``data/pipeline.py::frontend_stub``'s, drawn
from (``--seed``, step).  Full depth: a config too large for one card
(the full Qwen3-30B-A3B's or DeepSeek-R1's weights, masters and
moments) runs out of memory on one; across cards it shards (below).

The counterpart of ``repro.launch.train``'s training path (and of
``examples/train_smollm.py``, whose width cut ``--reduced`` gives):
random weights from ``--seed`` (``init_params``), AdamW (lr 1e-3, as the
reference's driver), ``launch/steps.py::train_step`` with ``remat`` on
``--steps`` batches of ``data/pipeline.py::SyntheticLMStream``
(``labels = tokens``, as the reference's stream; ``--seq`` counts text
tokens).  Prints each step's
loss, grad norm and tokens/s, on the card the peak device memory, and
with ``--ckpt`` saves the weights by
``runtime/checkpoint.py::save``.  Runs on the card unless ``--device
cpu``.

Across ranks (``torchrun``'s ``WORLD_SIZE`` above 1, or ``--tp``) it
joins the process group (NCCL on the card, gloo on the CPU; without
``torchrun``'s address a one-rank group on ``tcp://localhost``), builds
the (WORLD / tp, tp) mesh and trains through
``launch/steps.py::build_cell``'s sharded step: tensor and expert
parallelism over ``model`` (``--tp``, the world by default), data
parallelism over ``data``, ZeRO-1 over every rank; each rank draws the
full weights from ``--seed`` and keeps its slices, and rank 0 prints (each
step with its collectives' counts and ring wire bytes,
``distributed/collectives.py::collective_stats``).
Every family shards (``check_trainable``): the dense, MoE and vision
decoders, Mamba-2 over its channels and heads, RecurrentGemma over its
RG-LRU channels and gate blocks, Whisper over its encoder's, self- and
cross-attention's heads; attention whose q heads do not split over
``--tp`` runs over q positions (the ``seq`` mode):

    torchrun --nproc-per-node 8 -m repro_torch.launch.train \
        --arch qwen3_moe_30b --steps 4 --batch 16 --seq 4096 \
        --microbatches 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_1b \
        --reduced --device cpu --dtype float32 --tp 1

``main(argv, regime="fsdp")`` (no flag: the reference reaches the
regime only through ``build_cell``) trains the ``fsdp`` cell instead:
ZeRO-3 over every rank, each leaf's shards gathered where the model
reads it, every family.

``--layers`` cuts the depth and ``--experts`` an MoE's routed experts (as
``chip_smoke.py``'s phases do).
``--sample-params PATH`` saves (``torch.save``, rank 0) each step's loss
and grad norm and a fixed sample of the full parameters before the first
step and after each: every k-th element of each leaf's flat, 4096 at
most, gathered over the mesh on the multi-GPU path (what a one-card and
a multi-card run of the same command are compared by).  ``--dry`` runs
the meta-device dry run (``launch/dryrun.py``) for
``--arch`` on the production meshes, all shapes, and allocates nothing.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import socket
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import compat, optim
from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import (DataConfig, SyntheticLMStream,
                                       frontend_stub)
from repro_torch.launch.steps import train_step
from repro_torch.models import transformer as T

LR = 1e-3


def step_batch(cfg, stream: SyntheticLMStream, step: int,
               seed: int = 0) -> Dict[str, np.ndarray]:
    """Step ``step``'s batch as numpy: the stream's tokens and labels and,
    for the encoder-decoder and the vision decoder, ``frontend_stub``'s
    frames or patches (labels -1 over the patches) drawn from (seed,
    step)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    return frontend_stub(cfg, stream.batch_at(step), rng)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: Optional[List[str]] = None, regime: str = "tp"
         ) -> List[float]:
    """Runs the loop; returns each step's loss.  ``regime`` is the
    multi-GPU path's train regime ("tp" or "fsdp")."""
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
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config's depth to this many layers")
    ap.add_argument("--experts", type=int, default=0,
                    help="cut an MoE config's routed experts to this many")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--dry", action="store_true")
    ap.add_argument("--tp", type=int, default=0,
                    help="ranks of the model axis (multi-GPU path)")
    ap.add_argument("--outdir", default="build/dryrun",
                    help="--dry's records")
    ap.add_argument("--sample-params", default=None,
                    help="save losses, grad norms and parameter samples")
    args = ap.parse_args(argv)
    if args.dry:
        from repro_torch.launch import dryrun
        return dryrun.main(["--arch", args.arch, "--outdir", args.outdir])

    dev = compat.resolve_device(args.device)
    cfg = _config(args)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 or args.tp or \
            regime != "tp":
        return _main_sharded(args, cfg, dev, regime)
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
    rec = _Record(args.sample_params, lambda: params)
    for step in range(args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in step_batch(cfg, stream, step, args.seed).items()}
        _sync(dev)
        t0 = time.perf_counter()
        out = train_step(cfg, params, opt, batch, ocfg,
                         microbatches=args.microbatches)
        loss, gnorm = float(out["loss"]), float(out["grad_norm"])
        secs = time.perf_counter() - t0
        losses.append(loss)
        rec.step(loss, gnorm)
        print(f"step {step} loss {loss:.4f} grad_norm {gnorm:.4f} "
              f"{args.batch * args.seq / secs:.1f} tokens/s", flush=True)
    rec.save()
    if dev.type == "cuda":
        print(f"peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB",
              flush=True)
    if args.ckpt:
        from repro_torch.runtime import checkpoint
        checkpoint.save(args.ckpt, params, extra={"steps": args.steps,
                                                  "arch": args.arch})
        print(f"checkpoint saved to {args.ckpt}", flush=True)
    return losses


SAMPLE = 4096


def _sample(params, n: int = SAMPLE):
    """Every k-th element of each leaf's flat (k = numel // n, at least
    1), n at most, as fp32 on the CPU, keyed by the leaf's dotted path."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
            return
        flat = t.detach().reshape(-1)
        out[".".join(path)] = flat[::max(1, flat.numel() // n)][:n] \
            .to("cpu", torch.float32, copy=True)

    walk(params, ())
    return out


class _Record:
    """``--sample-params``: each step's loss and grad norm and
    ``_sample`` of the full parameters (``full()``; every rank calls it,
    a collective on the multi-GPU path) before the first step and after
    each, saved by the lead rank; nothing without a path."""

    def __init__(self, path, full, lead: bool = True):
        self.path, self.full, self.lead = path, full, lead
        self.data = {"loss": [], "grad_norm": [], "params": []}
        self._take()

    def _take(self):
        if self.path:
            self.data["params"].append(_sample(self.full()))

    def step(self, loss: float, gnorm: float):
        self.data["loss"].append(loss)
        self.data["grad_norm"].append(gnorm)
        self._take()

    def save(self):
        if self.path and self.lead:
            torch.save(self.data, self.path)


def _config(args):
    """``--arch``'s config, reduced with ``--reduced``, its dtype, depth
    and routed experts replaced by ``--dtype``, ``--layers`` and
    ``--experts``."""
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    over = {}
    if args.dtype:
        over["dtype"] = args.dtype
    if args.layers:
        over["num_layers"] = args.layers
    if args.experts:
        over["num_experts"] = args.experts
    return dataclasses.replace(cfg, **over)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _main_sharded(args, base, dev, regime: str = "tp") -> List[float]:
    """The loop over a mesh of every rank of the process group, in the
    train ``regime``."""
    import torch.distributed as dist

    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.steps import build_cell

    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{_free_port()}",
            rank=0, world_size=1)
    try:
        tp = args.tp or world
        if world % tp:
            raise ValueError(f"--tp {tp} does not divide {world} ranks")
        mesh = mesh_lib.Mesh(("data", "model"), (world // tp, tp)) \
            .realize(dev.type)
        cell = build_cell(base, "train_4k", mesh,
                          batch_seq=(args.batch, args.seq),
                          exact_microbatches=args.microbatches,
                          opt_cfg=optim.AdamWConfig(lr=LR),
                          train_regime=regime)
        cfg = cell.cfg
        params, opt = cell.init_state(args.seed, dev)
        stream = SyntheticLMStream(DataConfig(
            global_batch=args.batch, seq_len=args.seq,
            vocab_size=cfg.vocab_size, seed=args.seed))
        lead = rank == 0
        rec = _Record(args.sample_params, lambda: shd.gather_params(
            params, cell.param_specs, mesh), lead)
        if lead:
            print(f"{cfg.name}: {T.param_count(cfg):,} parameters, "
                  f"{cfg.dtype}, mesh {mesh.shape} ({cell.note}), batch "
                  f"{args.batch} x {args.seq} in {cell.microbatches} "
                  f"microbatches, on {dev.type}", flush=True)
        losses = []
        for step in range(args.steps):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in
                     step_batch(cfg, stream, step, args.seed).items()}
            _sync(dev)
            collectives.reset_events()
            t0 = time.perf_counter()
            out = cell.step(params, opt, batch)
            loss, gnorm = float(out["loss"]), float(out["grad_norm"])
            secs = time.perf_counter() - t0
            losses.append(loss)
            rec.step(loss, gnorm)
            if lead:
                st = collectives.collective_stats()
                print(f"step {step} loss {loss:.4f} grad_norm {gnorm:.4f} "
                      f"{args.batch * args.seq / secs:.1f} tokens/s; "
                      f"collectives {st['counts']}, "
                      f"{st['total_wire_bytes'] / 1e6:.1f} MB on the wire "
                      f"(rank 0)", flush=True)
        rec.save()
        if lead and dev.type == "cuda":
            print(f"peak device memory (rank 0) "
                  f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB",
                  flush=True)
        return losses
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
