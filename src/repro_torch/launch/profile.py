"""Where the serving path's time goes on the card: a ``torch.profiler``
trace of one served batch.

    PYTHONPATH=src python -m repro_torch.launch.profile --arch llama3_2_1b
    PYTHONPATH=src python -m repro_torch.launch.profile --arch qwen3_moe_30b \
        --module-granularity --b-attn 4
    PYTHONPATH=src python -m repro_torch.launch.profile --arch mamba2_370m \
        --prompt-len 256 [--sampled]

Builds one ``NodeEngine`` (random weights from ``--seed``), serves a
warm-up request, then traces a batch of greedy requests (``--sampled``:
sampled ones, temperature 0.8, top-k 40, top-p 0.95, a seed each)
through the ``BatchMaster`` and prints: wall time, output tokens/s,
device busy share (summed kernel time over wall time; one stream, so
kernels do not overlap), device time per kernel class, the top kernels
by device time, and host time per decode step.  ``--module-granularity``
and ``--b-attn`` decode through the Algorithm-1 module runtime; on a MoE
model the classes split out the ``moe_gemm`` kernel and the sort /
scatter / scan / search kernels of its dispatch (the sampled pages'
penalty counts land there too).  An SSM (``--arch mamba2_370m``) is
served at model level, as ``NodeEngine`` refuses it: the trace covers
``prefill`` of ``--requests`` equal-length prompts and the greedy or
``--sampled`` ``decode_page``s of ``--page-size`` steps after it
(``launch/model_level.py``), with the ``ssd_scan`` kernel as its own
class; a prompt longer than 64 tokens must be a multiple of 64, and the
engine's options (``--max-active``, ``--max-len``,
``--module-granularity``, ``--b-attn``) are refused.
``--trace PATH`` also writes the Chrome trace.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import collections
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.launch.model_level import generate
from repro_torch.models import transformer as T
from repro_torch.runtime.api import BatchMaster, BatchRequest
from repro_torch.runtime.engine import NodeEngine
from repro_torch.sampling import SamplingParams


# the __global__ functions of each hand-written kernel, csrc/<kernel>.cu
KERNEL_ENTRIES = {
    "flash_attention": ("flash_fwd_kernel", "flash_fwd_wgmma"),
    "flash_attention_bwd": ("flash_bwd_preprocess", "flash_bwd_dkdv_simt",
                            "flash_bwd_dq_simt", "flash_bwd_dkdv_wgmma",
                            "flash_bwd_dq_wgmma"),
    "paged_attention": ("paged_split_kernel",),
    "fused_sampling": ("fused_sample_kernel",),
    "moe_gemm": ("grouped_gemm_kernel", "grouped_gemm_wgmma"),
    "moe_gemm_wgrad": ("grouped_gemm_wgrad_kernel",
                       "grouped_gemm_wgrad_wgmma"),
    "ssd_scan": ("ssd_scan_kernel",),
    "ssd_scan_bwd": ("ssd_scan_bwd_kernel", "ssd_scan_bwd_reduce"),
}


def kernel_class(name: str) -> str:
    """The class of a device kernel's name in the trace: a hand-written
    kernel by its entry points (before the library names they share words
    with), then PyTorch's and cuBLAS's kernels by what their names hold."""
    n = name.lower()
    for kernel, entries in KERNEL_ENTRIES.items():
        if any(e in n for e in entries):
            return f"{kernel} kernel"
    if any(k in n for k in ("sort", "scatter", "scan", "searchsorted",
                            "index_put", "bincount")):
        return "sort / scatter / scan / search (MoE dispatch, penalties)"
    if any(k in n for k in ("gemm", "gemv", "cutlass", "xmma", "nvjet")):
        return "matmul (cuBLAS)"
    if "memcpy" in n or "memset" in n:
        return "copies"
    return "other PyTorch kernels"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_2_1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--max-tokens", type=int, default=48)
    ap.add_argument("--max-active", type=int, default=None,
                    help="engine slots (default 8)")
    ap.add_argument("--max-len", type=int, default=None,
                    help="engine cache length (default 2048)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="decode steps per page (and the engine's KV page)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sampled", action="store_true")
    ap.add_argument("--module-granularity", action="store_true")
    ap.add_argument("--b-attn", type=int, default=0)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    rng = np.random.default_rng(args.seed)

    def sp(i):
        return SamplingParams(temperature=0.8, top_k=40, top_p=0.95,
                              seed=i) if args.sampled else SamplingParams()

    def prompts(n, plen):
        return [[int(t) for t in rng.integers(2, cfg.vocab_size, plen)]
                for _ in range(n)]

    if cfg.family == "ssm":
        engine_only = [flag for flag, given in (
            ("--max-active", args.max_active is not None),
            ("--max-len", args.max_len is not None),
            ("--module-granularity", args.module_granularity),
            ("--b-attn", args.b_attn != 0)) if given]
        if engine_only:
            ap.error(f"{args.arch} is served at model level, with no "
                     f"engine: {', '.join(engine_only)} does not apply")
        params = T.init_params(cfg, args.seed)

        def serve(n, plen, out):
            return generate(cfg, params, prompts(n, plen), out,
                            sampling=[sp(i) for i in range(n)]
                            if args.sampled else None,
                            page_steps=args.page_size)

        serve(1, 64, 4)                                  # warm-up
    else:
        eng = NodeEngine(cfg, max_active=args.max_active or 8,
                         max_len=args.max_len or 2048,
                         page_size=args.page_size,
                         seed=args.seed,
                         module_granularity=args.module_granularity,
                         b_attn=args.b_attn)
        master = BatchMaster([eng], SchedulerConfig(page_size=args.page_size))

        def serve(n, plen, out, tag="r"):
            bo = master.run(master.submit([
                BatchRequest(f"{tag}{i}", p, out, sampling=sp(i))
                for i, p in enumerate(prompts(n, plen))]))
            if bo.request_counts["failed"]:
                raise SystemExit(f"requests failed: {bo.request_counts}")
            return bo

        serve(1, 8, 4, "warm")                           # warm-up
    torch.cuda.synchronize()
    steps0 = 0 if cfg.family == "ssm" else eng.decode_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = serve(args.requests, args.prompt_len, args.max_tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if cfg.family == "ssm":
        steps, out_tokens, n_served = res.decode_steps, res.out_tokens, \
            len(res.tokens)
    else:
        steps = eng.decode_steps - steps0
        out_tokens = sum(len(r["response"]["tokens"]) for r in res.results)
        n_served = len(res.results)

    by_class = collections.Counter()
    by_name = collections.Counter()
    launches = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            launches += 1
            us = ev.device_time if hasattr(ev, "device_time") \
                else ev.cuda_time
            by_class[kernel_class(ev.name)] += us
            by_name[ev.name] += us
    busy_s = sum(by_class.values()) / 1e6
    print(f"device: {torch.cuda.get_device_name(0)}")
    kind = ("sampled" if args.sampled else "greedy") + (
        f", module granularity (b_attn {eng.b_attn})"
        if args.module_granularity else "") + (
        ", model level (prefill + decode pages)"
        if cfg.family == "ssm" else "")
    print(f"served {n_served} {kind} requests "
          f"({args.prompt_len}-token prompts, {args.max_tokens} output "
          f"tokens) in {wall:.3f} s: "
          f"{out_tokens / wall:.1f} output tokens/s, {steps} decode steps, "
          f"{wall / max(steps, 1) * 1e3:.2f} ms wall per step")
    if cfg.family == "ssm":
        print(f"prefill {res.prefill_s * 1e3:.1f} ms, decode "
              f"{res.decode_s * 1e3 / max(steps, 1):.2f} ms/step over "
              f"{res.pages} pages (host clock, under the profiler)")
    if busy_s <= 0:
        print("device busy share: not measured (the trace holds no device "
              "time)")
    else:
        print(f"device busy share: {busy_s / wall:.3f} "
              f"({busy_s * 1e3:.1f} ms of kernels in {wall * 1e3:.1f} ms)")
        for cls, us in by_class.most_common():
            print(f"  {cls}: {us / 1e3:.1f} ms "
                  f"({us / 1e6 / busy_s:.3f} of device time)")
        print(f"device kernels: {launches} "
              f"({launches / max(steps, 1):.0f} per decode step)")
        print("top kernels by device time:")
        for name, us in by_name.most_common(12):
            print(f"  {us / 1e3:9.2f} ms  {name[:100]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
        print(f"trace written to {args.trace}")


if __name__ == "__main__":
    main()
