"""Time this checkout's prefill attention kernel against another
checkout's on one card, in turns.

    PYTHONPATH=src python -m repro_torch.launch.flash_ab --other DIR

DIR is the root of another checkout of the repository (for example the
parent commit, unpacked with ``git archive`` into a directory that
``.gitignore`` lists).  Its ``src/repro_torch/csrc/flash_attention.cu`` is
built with this checkout's nvcc flags beside this checkout's own kernel;
both are called through the same C entry point on the same inputs.  At
each bf16 causal shape that ``chip_smoke.py`` times (random inputs from
seed 0) the two run in the order other, this, this, other, each timed as
``chip_smoke.py`` times a kernel (``launch/timing.py``: median of 20
launches, L2 flushed before each, CUDA events).  Prints the card's name
and power limit, one line per shape, and a JSON line of every time.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops
from repro_torch.launch.timing import Timer

# (B, S, H, Hkv, D): Llama-3.2-1B's 4 x 512 and 8 x 256 prefill batches,
# Qwen3-30B-A3B's 8 x 256, and one 2048-token prompt
SHAPES = [(4, 512, 32, 8, 64), (8, 256, 32, 8, 64), (8, 256, 32, 4, 128),
          (1, 2048, 32, 8, 64)]


def build_other(root: Path) -> ctypes.CDLL:
    """The other checkout's flash kernel, built and bound."""
    src = root / "src" / "repro_torch" / "csrc" / "flash_attention.cu"
    out = build.build_dir() / "ab" / "libflash_attention-other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ops.bind(ctypes.CDLL(str(out)))


def compare(other: Path) -> list:
    """One row a shape: the other kernel's two times and this one's (ms,
    in the order other, this, this, other) and the largest difference
    between their outputs."""
    dev = torch.device("cuda", 0)
    libs = {"this": ops._lib(), "other": build_other(other)}
    timer = Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for B, S, H, Hkv, D in SHAPES:
        q = torch.randn((B, S, H, D), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((B, S, Hkv, D), generator=gen, device=dev)
                .bfloat16() for _ in range(2))
        pos = torch.arange(S, dtype=torch.int32, device=dev)[None] \
            .expand(B, S).contiguous()
        ops._check(q, k, v, pos, pos)

        def call(name):
            return ops.launch(libs[name], q, k, v, pos, pos, causal=True,
                              window=0, softcap=0.0)

        diff = (call("this").float() - call("other").float()).abs().max()
        times = {name: [] for name in libs}
        for name in ("other", "this", "this", "other"):
            times[name].append(timer(lambda: call(name)))
        rows.append(dict(shape=f"B{B} S{S} H{H}/{Hkv} D{D}",
                         other_ms=times["other"], this_ms=times["this"],
                         max_abs_diff=diff.item()))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="root of the other checkout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_ab: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    rows = compare(args.other)
    for r in rows:
        print(f"{r['shape']}: other {r['other_ms'][0]:.4f} / "
              f"{r['other_ms'][1]:.4f} ms, this {r['this_ms'][0]:.4f} / "
              f"{r['this_ms'][1]:.4f} ms (max |this - other| "
              f"{r['max_abs_diff']:.3e})")
    print(json.dumps({"flash_ab": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
