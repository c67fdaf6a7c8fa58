"""Time this checkout's kernel against another checkout's on one card, in
turns.

    PYTHONPATH=src python -m repro_torch.launch.flash_ab --other DIR \
        [--kernel {flash_attention,paged_attention,moe_gemm}]

DIR is the root of another checkout of the repository (for example the
parent commit, unpacked with ``git archive`` into a directory that
``.gitignore`` lists).  Its ``src/repro_torch/csrc/<kernel>.cu`` is built
with this checkout's nvcc flags beside this checkout's own kernel; both
are called through the same C entry point on the same inputs (random, from
seed 0).  ``--kernel flash_attention`` (the default) runs the bf16 causal
prefill shapes that ``chip_smoke.py`` times; ``--kernel paged_attention``
the four bf16 decode shapes it times (``PAGED_SHAPES``: the serving path's
slot cache as a page-16 pool view with the identity table);
``--kernel moe_gemm`` the grouped expert GEMM at Qwen3-30B-A3B's decode
(8 tokens) and 8 x 256 prefill (w1: D 2048 -> F 768, and w2: 768 -> 2048),
top-8 of 128 experts, rows laid out by the MoE layer's own dispatch
(``GEMM_SHAPES``); this checkout's kernel runs on the route ``ops.route``
names; an older library whose entry point has no route argument (before
the wgmma route) is declared by this tool with its own arguments and picks
its route itself.  At each shape
the two run in the order other, this, this, other, each timed as
``chip_smoke.py`` times a kernel (``launch/timing.py``: median of 20
launches, L2 flushed before each, CUDA events).  Prints the card's name
and power limit, one line per shape, and a JSON line of every time.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import math
import re
import subprocess
import types
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.launch.timing import Timer

KERNELS = ("flash_attention", "paged_attention", "moe_gemm")
# (B, S, H, Hkv, D): Llama-3.2-1B's 4 x 512 and 8 x 256 prefill batches,
# Qwen3-30B-A3B's 8 x 256, and one 2048-token prompt
SHAPES = [(4, 512, 32, 8, 64), (8, 256, 32, 8, 64), (8, 256, 32, 4, 128),
          (1, 2048, 32, 8, 64)]
# (B, max_len, H, Hkv, D, lengths): Llama-3.2-1B's dense decode (8 slots of
# a 2048-token cache), Qwen3-30B-A3B's monolithic decode and its attention
# sub-batch at b_attn = 4, and the prefix-hit tail (batch 1, a cache of
# pow2 length 512)
LENGTHS = [256, 512, 768, 1024, 1024, 1280, 1536, 1792]
PAGED_SHAPES = [(8, 2048, 32, 8, 64, LENGTHS), (8, 2048, 32, 4, 128, LENGTHS),
                (4, 2048, 32, 4, 128, LENGTHS[:4]), (1, 512, 32, 8, 64, [261])]

# (label, tokens, D, F): Qwen3-30B-A3B (128 experts, top-8) at a decode
# step of 8 slots and at the 8 x 256 prefill, w1 (and w3) then w2
GEMM_SHAPES = [("decode B8 w1", 8, 2048, 768),
               ("prefill 8x256 w1", 2048, 2048, 768),
               ("prefill 8x256 w2", 2048, 768, 2048)]
GEMM_EXPERTS, GEMM_TOP_K = 128, 8


def paged_label(B, S, H, Hkv, D, lengths) -> str:
    return f"B{B} max_len{S} H{H}/{Hkv} D{D} sum(len)={sum(lengths)}"


def _ops(kernel: str):
    return importlib.import_module(f"repro_torch.kernels.{kernel}.ops")


def build_other(root: Path, kernel: str = "flash_attention") -> ctypes.CDLL:
    """The other checkout's kernel ``kernel``, built and bound; nvcc's
    log (``-Xptxas -v``: registers, spills) lands beside the library."""
    src = root / "src" / "repro_torch" / "csrc" / f"{kernel}.cu"
    out = build.build_dir() / "ab" / f"lib{kernel}-other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                           str(src)], capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    if kernel == "moe_gemm" and not _gemm_takes_route(src):
        return _bind_gemm_without_route(lib)
    return _ops(kernel).bind(lib)


def _gemm_takes_route(src: Path) -> bool:
    """Whether a ``moe_gemm.cu``'s C entry point takes the route argument
    (the wgmma route added it before ``stream``)."""
    sig = re.search(r"repro_grouped_gemm\(([^)]*)\)", src.read_text())
    return sig is not None and "int route" in sig.group(1)


def _bind_gemm_without_route(lib: ctypes.CDLL):
    """An older library's ``repro_grouped_gemm``, with no route argument,
    behind the current signature: the route ``ops.launch`` passes is
    dropped and the library picks its own (mma for every bf16 call)."""
    fn = lib.repro_grouped_gemm
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    return types.SimpleNamespace(
        repro_grouped_gemm=lambda *args: fn(*args[:-2], args[-1]))


def _flash_cases(gen, dev):
    """(shape, call(lib)) at each flash shape."""
    ops = _ops("flash_attention")
    for B, S, H, Hkv, D in SHAPES:
        q = torch.randn((B, S, H, D), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((B, S, Hkv, D), generator=gen, device=dev)
                .bfloat16() for _ in range(2))
        pos = torch.arange(S, dtype=torch.int32, device=dev)[None] \
            .expand(B, S).contiguous()
        ops._check(q, k, v, pos, pos)
        yield (f"B{B} S{S} H{H}/{Hkv} D{D}",
               lambda lib, a=(q, k, v, pos, pos): ops.launch(
                   lib, *a, causal=True, window=0, softcap=0.0))


def _paged_cases(gen, dev):
    """(shape, call(lib)) at each paged shape."""
    ops = _ops("paged_attention")
    for B, S, H, Hkv, D, lens in PAGED_SHAPES:
        page = math.gcd(S, 16)
        q = torch.randn((B, H, D), generator=gen, device=dev).bfloat16()
        kp, vp = (torch.randn((B * S // page, page, Hkv, D), generator=gen,
                              device=dev).bfloat16() for _ in range(2))
        table = torch.arange(B * S // page, dtype=torch.int32,
                             device=dev).reshape(B, S // page)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        ops._check(q, kp, vp, table, lengths)
        yield (paged_label(B, S, H, Hkv, D, lens),
               lambda lib, a=(q, kp, vp, table, lengths): ops.launch(lib, *a))


def _gemm_cases(gen, dev):
    """(shape, call(lib)) at each grouped-GEMM shape: random router
    logits' top-k through ``dispatch_plan`` at the block size the MoE
    layer picks, x rows gathered as the layer gathers them."""
    ops = _ops("moe_gemm")
    E, k = GEMM_EXPERTS, GEMM_TOP_K
    for label, T, D, Fo in GEMM_SHAPES:
        ids = torch.topk(torch.randn((T, E), generator=gen, device=dev),
                         k, dim=-1).indices
        plan = ops.dispatch_plan(ids, E, ops.pick_block_t(T * k, E))
        tok = torch.arange(T, device=dev).repeat_interleave(k)
        xs = ops.gather_rows(torch.randn((T, D), generator=gen, device=dev)
                             .bfloat16(), plan, tok)
        w = (0.02 * torch.randn((E, D, Fo), generator=gen, device=dev)) \
            .bfloat16()
        be, bt = plan.block_expert, plan.block_t
        ops._check(xs, w, be, bt)
        r = ops.route(xs.dtype, bt, D, Fo, xs.data_ptr() % 16 == 0
                      and w.data_ptr() % 16 == 0)
        yield (f"{label} rows{xs.shape[0]} bt{bt} ({r})",
               lambda lib, a=(xs, w, be, bt, r): ops.launch(lib, *a))


def compare(other: Path, kernel: str = "flash_attention") -> list:
    """One row a shape: the other kernel's two times and this one's (ms,
    in the order other, this, this, other) and the largest difference
    between their outputs."""
    if kernel not in KERNELS:
        raise ValueError(f"flash_ab: no A/B for {kernel}, only {KERNELS}")
    dev = torch.device("cuda", 0)
    libs = {"this": _ops(kernel)._lib(), "other": build_other(other, kernel)}
    timer = Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = {"flash_attention": _flash_cases, "paged_attention": _paged_cases,
             "moe_gemm": _gemm_cases}[kernel]
    rows = []
    for shape, fn in cases(gen, dev):
        def call(name):
            return fn(libs[name])

        diff = (call("this").float() - call("other").float()).abs().max()
        times = {name: [] for name in libs}
        for name in ("other", "this", "this", "other"):
            times[name].append(timer(lambda: call(name)))
        rows.append(dict(shape=shape, other_ms=times["other"],
                         this_ms=times["this"], max_abs_diff=diff.item()))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="root of the other checkout")
    ap.add_argument("--kernel", choices=KERNELS, default="flash_attention",
                    help="the kernel to time (default flash_attention)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_ab: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    rows = compare(args.other, args.kernel)
    for r in rows:
        print(f"{args.kernel} {r['shape']}: other {r['other_ms'][0]:.4f} / "
              f"{r['other_ms'][1]:.4f} ms, this {r['this_ms'][0]:.4f} / "
              f"{r['this_ms'][1]:.4f} ms (max |this - other| "
              f"{r['max_abs_diff']:.3e})")
    print(json.dumps({"flash_ab": rows, "kernel": args.kernel}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
