"""Serving entry point of the PyTorch port: builds NodeEngines on one
card and serves a batch of greedy requests through the BatchMaster.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_2_1b
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_moe_30b \
        --module-granularity --b-attn 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek_r1 \
        --reduced --device cpu

``--module-granularity`` decodes through the Algorithm-1 module runtime:
attention in sub-batches of ``--b-attn`` slots (0: all of them), COMBINE
before each FFN/MoE layer.

The weights are random, drawn from ``--seed``.  Without a CUDA card the
default ``--device cuda`` raises; ``--device cpu`` runs the plain
PyTorch path.  A config whose weights exceed the card's memory is refused
before any is drawn (the full ``deepseek_r1``: 1.41 TB of bf16 weights;
``chip_smoke.py`` serves it at full width with its depth cut to 2
layers).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import compat
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.models import transformer as T
from repro_torch.runtime.api import BatchMaster, BatchRequest
from repro_torch.runtime.engine import NodeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_2_1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nodes", type=int, default=1)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-active", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--module-granularity", action="store_true")
    ap.add_argument("--b-attn", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    device = compat.resolve_device(args.device)
    if device.type == "cuda":
        weights = T.param_count(cfg) * compat.torch_dtype(cfg.dtype).itemsize
        card = torch.cuda.get_device_properties(device).total_memory
        if weights > card:
            raise SystemExit(
                f"serve: {cfg.name}'s weights take {weights / 1e9:.1f} GB in "
                f"{cfg.dtype}, more than the card's {card / 1e9:.1f} GB; it "
                f"does not fit one card (pass --reduced)")
    engines = [NodeEngine(cfg, node_id=i, max_active=args.max_active,
                          max_len=args.max_len, page_size=args.page_size,
                          seed=args.seed, device=args.device,
                          module_granularity=args.module_granularity,
                          b_attn=args.b_attn)
               for i in range(args.nodes)]
    master = BatchMaster(engines, SchedulerConfig(page_size=args.page_size))
    rng = np.random.default_rng(args.seed)
    reqs = [BatchRequest(custom_id=f"r{i}",
                         prompt=[int(t) for t in rng.integers(
                             2, cfg.vocab_size, args.prompt_len)],
                         max_tokens=int(rng.integers(4, 48)))
            for i in range(args.requests)]
    t0 = time.perf_counter()
    bo = master.run(master.submit(reqs))
    if engines[0].device.type == "cuda":
        torch.cuda.synchronize(engines[0].device)
    wall = time.perf_counter() - t0
    counts = bo.request_counts
    out_tokens = sum(len(r["response"]["tokens"]) for r in bo.results)
    print(f"{bo.id}: {counts} BCT={bo.bct_s:.2f}s")
    print(f"completed: {counts['completed']} failed: {counts['failed']} "
          f"output_tokens: {out_tokens} wall_s: {wall:.3f} "
          f"device: {engines[0].device}")
    for i, e in enumerate(engines):
        print(f"node{i}: {e.stats.counts} decode_steps={e.decode_steps}")
    return bo


if __name__ == "__main__":
    main()
