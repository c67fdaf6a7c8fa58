"""Time this checkout's kernel against another checkout's on one card, in
turns.

    PYTHONPATH=src python -m repro_torch.launch.flash_ab --other DIR \
        [--kernel {flash_attention,flash_attention_bwd,paged_attention,
                   moe_gemm,moe_gemm_wgrad,fused_sampling}]

DIR is the root of another checkout of the repository (for example the
parent commit, unpacked with ``git archive`` into a directory that
``.gitignore`` lists).  Its ``src/repro_torch/csrc/<kernel>.cu`` is built
with this checkout's nvcc flags beside this checkout's own kernel; both
are called through the same C entry point on the same inputs (random, from
seed 0).  ``--kernel flash_attention`` (the default) runs the bf16 causal
prefill shapes that ``chip_smoke.py`` times; ``--kernel
flash_attention_bwd`` the backward at ``chip_smoke.py`` phase 3's three
bf16 causal training shapes (``BWD_SHAPES``; out and lse from this
checkout's forward; an older library whose entry point takes one head
dim for q, k and v is declared by this tool with its own arguments),
holding the two checkouts' (dq, dk, dv) to each other
with phase 3's tolerance (``bwd_tol``), its "alone" time the sum over the
library's own bf16 ``__global__`` functions, read from its source (the
preprocess, dK/dV and dQ kernels); ``--kernel paged_attention``
the four bf16 decode shapes it times (``PAGED_SHAPES``: the serving path's
slot cache as a page-16 pool view with the identity table);
``--kernel moe_gemm`` the grouped expert GEMM at Qwen3-30B-A3B's decode
(8 tokens) and 8 x 256 prefill (w1: D 2048 -> F 768, and w2: 768 -> 2048),
top-8 of 128 experts, rows laid out by the MoE layer's own dispatch
(``GEMM_SHAPES``); this checkout's kernel runs on the route ``ops.route``
names; an older library whose entry point has no route argument (before
the wgmma route) is declared by this tool with its own arguments and picks
its route itself; ``--kernel moe_gemm_wgrad`` the grouped GEMM's weight
gradient at ``chip_smoke.py`` phase 3's two training shapes
(``WGRAD_SHAPES``: Qwen3-30B-A3B's 4 x 4096 tokens, top-8 of 128
experts, w1/w3 dW (D 2048 x F 768) and w2 dW (768 x 2048), rows laid out
by the MoE layer's dispatch), this checkout's kernel on the route
``ops.route`` names, an older library without the route argument (before
the wgmma route) declared with its own arguments, and each checkout's dw
held to the plain version with phase 3's bf16 tolerance (``plain_err``);
``--kernel fused_sampling`` the sampler at the serving
path's rows (``SAMPLING_SHAPES``: Llama-3.2-1B's B8 V128256 without lanes
and with K = 5 logprob lanes, the batch-1 prefix tail, Qwen3's B8 V151936
with K = 5; mixed top-k / top-p / min-p rows), checks that ``sampled``,
``greedy``, ``tau``, ``m``, ``m_raw``, ``top_idx`` and ``top_vals`` equal
the other's bits and ``l`` and ``l_raw`` agree to 1e-6 relative, and times
each checkout's own Python wrapper's host side (``Timer.host_us`` of its
``fused_sample``, in a process of its own).  At each shape
the two run in the order other, this, this, other, each timed as
``chip_smoke.py`` times a kernel (``launch/timing.py``: median of 20
launches, L2 flushed before each, CUDA events) and by the duration of the
kernel alone in ``torch.profiler``'s device trace (``Timer.kernel_ms``),
which leaves out any wait for the host.  Prints the card's name
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
import os
import subprocess
import sys
import types
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.launch.profile import KERNEL_ENTRIES
from repro_torch.launch.timing import Timer

KERNELS = ("flash_attention", "flash_attention_bwd", "paged_attention",
           "moe_gemm", "moe_gemm_wgrad", "fused_sampling")
# (B, S, H, Hkv, D): Llama-3.2-1B's 4 x 512 and 8 x 256 prefill batches,
# Qwen3-30B-A3B's 8 x 256, and one 2048-token prompt
SHAPES = [(4, 512, 32, 8, 64), (8, 256, 32, 8, 64), (8, 256, 32, 4, 128),
          (1, 2048, 32, 8, 64)]
# (B, S, H, Hkv, D): the backward's training shapes, chip_smoke.py's
# TRAIN_FLASH: SmolLM-360M's and Llama-3.2-1B's heads at 4096 tokens, and
# heads of 128 at 2048
BWD_SHAPES = [(8, 4096, 15, 5, 64), (4, 4096, 32, 8, 64),
              (4, 2048, 32, 4, 128)]
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

# (label, tokens, M, N): the weight gradient at Qwen3-30B-A3B's training
# batch of 4 x 4096 tokens (chip_smoke.py's TRAIN_MOE), w1 (and w3) dW then
# w2 dW; phase 3's bf16 tolerance against the plain version
WGRAD_SHAPES = [("train 4x4096 w1 dW", 4 * 4096, 2048, 768),
                ("train 4x4096 w2 dW", 4 * 4096, 768, 2048)]
WGRAD_TOL = dict(atol=2e-2, rtol=2e-2)

# (B, V, lanes): Llama-3.2-1B's sampled decode batch without and with K = 5
# logprob lanes, the batch-1 steps of a prefix-hit tail, Qwen3-30B-A3B's
# batch with lanes; lanes -1 is no lanes
SAMPLING_SHAPES = [(8, 128256, -1), (8, 128256, 5), (1, 128256, -1),
                   (8, 151936, 5)]
# (label, k, p): B8 V128256 rows without lanes whose filters run the
# histogram passes apart (min_p 0): none, tau_k's three count passes,
# tau_p's coarse count pass and two mass passes, all five
SAMPLING_PASSES = [("0 passes", 0, 1.0), ("3 count passes", 40, 1.0),
                   ("1 count + 2 mass passes", 0, 0.9),
                   ("5 passes", 40, 0.9)]
# outputs that must equal the other kernel's bits; l and l_raw are sums in
# another order and agree to SAMPLING_RTOL
SAMPLING_EXACT = ("sampled", "greedy", "tau", "m", "m_raw", "top_idx",
                  "top_vals")
SAMPLING_RTOL = 1e-6

# the host side of a checkout's own sampling wrapper, run with that
# checkout's src first on the path
_HOST_PROBE = """
import torch
from repro_torch.kernels.fused_sampling.ops import fused_sample
from repro_torch.launch.profile import KERNEL_ENTRIES
from repro_torch.launch.timing import Timer
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)
B, V = 8, 128256
x = torch.randn((B, V), generator=gen, device=dev)
k = torch.tensor([0, 1, 5, 40, 300, 0, 1, 5], dtype=torch.int32, device=dev)
p = torch.full((B,), 0.9, device=dev)
mp = torch.full((B,), 0.02, device=dev)
print(Timer.host_us(lambda: fused_sample(x, x, k, p, mp)))
"""


def paged_label(B, S, H, Hkv, D, lengths) -> str:
    return f"B{B} max_len{S} H{H}/{Hkv} D{D} sum(len)={sum(lengths)}"


def sampling_rows(gen, B, V, dev, k=None, p=None, min_p=None):
    """Processed logits, Gumbel rows and raw logits (B, V) f32, with mixed
    per-row top-k / top-p / min-p unless given."""
    x = 2.0 * torch.randn((B, V), generator=gen, device=dev)
    g = -torch.log(-torch.log(torch.rand((B, V), generator=gen, device=dev)
                              .clamp(1e-7, 1 - 1e-7)))
    raw = torch.randn((B, V), generator=gen, device=dev)
    cyc = torch.arange(B, device=dev)
    if k is None:
        k = torch.tensor([0, 1, 5, 40, 300], device=dev)[cyc % 5]
    if p is None:
        p = torch.tensor([1.0, 0.95, 0.9, 0.5], device=dev)[cyc % 4]
    if min_p is None:
        min_p = torch.tensor([0.0, 0.02, 0.1], device=dev)[cyc % 3]
    full = lambda v, dt: torch.as_tensor(v, device=dev).to(dt).expand(
        B).contiguous()
    return (x, g, full(k, torch.int32), full(p, torch.float32),
            full(min_p, torch.float32), raw)


def catch_all_rows(gen, V, dev):
    """Three rows (V >= 8) whose crossings land on a histogram's catch-all
    bucket past the coarse level, where the kernel sums that bucket's mass
    apart: a top-2 whose second value falls in the lowest bucket of level 1
    (row 0) and of level 2 (row 1, with top-p 0.9, so that this bucket's
    mass, in the kept mass, moves tau), with the rest 3 nats or more under
    the max; and a top-p 0.9 whose level-1 mass crossing falls in the
    lowest bucket (row 2, k 0, the rest 40 nats under).  Each row's two
    top values sit at ends of the row, in different ranks' slices."""
    x = -3.0 - 2.0 * torch.randn((3, V), generator=gen, device=dev).abs()
    x[2] = -40.0 - torch.rand((V,), generator=gen, device=dev)
    w1, w2 = 2.0 ** -11, 2.0 ** -19          # level 1 and 2 bucket widths
    second = torch.tensor([-0.1249, -(10 * w1 + 255.5 * w2), -0.1249],
                          device=dev)
    x[:, 1] = 0.0
    x[:, V - 2] = second
    g = -torch.log(-torch.log(torch.rand((3, V), generator=gen, device=dev)
                              .clamp(1e-7, 1 - 1e-7)))
    raw = torch.randn((3, V), generator=gen, device=dev)
    k = torch.tensor([2, 2, 0], dtype=torch.int32, device=dev)
    p = torch.tensor([1.0, 0.9, 0.9], device=dev)
    return x, g, k, p, torch.zeros(3, device=dev), raw


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
    if kernel == "moe_gemm_wgrad" and not _gemm_takes_route(
            src, "repro_grouped_gemm_wgrad"):
        return _bind_wgrad_without_route(lib)
    if kernel == "flash_attention" and not _flash_takes(src, "lse"):
        return _bind_flash_older(lib, _flash_takes(src, "int DV"))
    if kernel == "flash_attention_bwd" and not _bwd_takes(src, "int Dv"):
        return _bind_bwd_older(lib, _bwd_takes(src, "int window"))
    return _ops(kernel).bind(lib)


def _bwd_takes(src: Path, arg: str) -> bool:
    """Whether a ``flash_attention_bwd.cu``'s C entry point names ``arg``:
    a window and a softcap (``int window``, added for H2O-Danube-1.8B's
    training) or v's head dim apart from q's (``int Dv``, added for MLA's
    training)."""
    sig = re.search(r"repro_flash_attention_bwd\(([^)]*)\)", src.read_text())
    return sig is not None and arg in sig.group(1)


def _bind_bwd_older(lib: ctypes.CDLL, takes_window: bool):
    """An older library's ``repro_flash_attention_bwd``, with one head dim
    for q, k and v and, before the window, without the window and softcap
    arguments, behind the current signature: v's head dim must equal q's
    and the window and softcap be 0 where the library lacks them (as at
    every shape timed here), and they are dropped.  Its
    ``repro_flash_bwd_max_len`` (one head dim) is declared the same way."""
    fn = lib.repro_flash_attention_bwd
    fn.restype = ctypes.c_int
    n_int, n_float = 7 + takes_window, 1 + takes_window
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * n_int
                   + [ctypes.c_float] * n_float
                   + [ctypes.c_int, ctypes.c_void_p])

    def call(*args):
        # args: 12 pointers, B, Sq, Skv, H, Hkv, D, Dv (18), causal (19),
        # window (20), softcap (21), scale, dtype, stream
        if args[18] != args[17]:
            raise ValueError("an older backward takes one head dim")
        if not takes_window:
            if args[20] or args[21]:
                raise ValueError("an older backward takes no window or "
                                 "softcap")
            return fn(*args[:18], args[19], *args[22:])
        return fn(*args[:18], *args[19:])

    lim = getattr(lib, "repro_flash_bwd_max_len", None)
    if lim is not None:
        lim.restype = ctypes.c_int
        lim.argtypes = [ctypes.c_int]
    return types.SimpleNamespace(
        repro_flash_attention_bwd=call,
        repro_flash_bwd_max_len=None if lim is None else (
            lambda D, Dv: lim(D) if D == Dv else 0))


def _flash_takes(src: Path, arg: str) -> bool:
    """Whether a ``flash_attention.cu``'s C entry point names ``arg``: v's
    head dim apart from q's (``int DV``, added for MLA's prefill) or the
    log-sum-exp buffer (``lse``, added for training)."""
    sig = re.search(r"repro_flash_attention_fwd\(([^)]*)\)", src.read_text())
    return sig is not None and arg in sig.group(1)


def _bind_flash_older(lib: ctypes.CDLL, takes_dv: bool):
    """An older library's ``repro_flash_attention_fwd``, without the
    ``lse`` pointer (null at every call timed here) and, before MLA, with
    one head dim, behind the current signature: those arguments are
    dropped (v's head dim equals q's at every shape timed here)."""
    fn = lib.repro_flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * (8 + takes_dv)
                   + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])

    def call(*args):
        if args[6] is not None:
            raise ValueError("an older flash library writes no lse")
        args = args[:6] + args[7:]
        return fn(*args) if takes_dv else fn(*args[:12], *args[13:])
    return types.SimpleNamespace(repro_flash_attention_fwd=call)


def _gemm_takes_route(src: Path, entry: str = "repro_grouped_gemm") -> bool:
    """Whether the C entry point ``entry`` of a ``moe_gemm.cu`` (or
    ``moe_gemm_wgrad.cu``) takes the route argument (each kernel's wgmma
    route added it before ``stream``)."""
    sig = re.search(rf"{entry}\(([^)]*)\)", src.read_text())
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


def _bind_wgrad_without_route(lib: ctypes.CDLL):
    """An older library's ``repro_grouped_gemm_wgrad``, with no route
    argument, behind the current signature: the route ``ops.launch``
    passes is dropped (that library runs every bf16 call on mma.sync)."""
    fn = lib.repro_grouped_gemm_wgrad
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    return types.SimpleNamespace(
        repro_grouped_gemm_wgrad=lambda *args: fn(*args[:-2], args[-1]))


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


def _bwd_cases(gen, dev):
    """(shape, call(lib)) at each backward shape: random q, k, v, dout;
    out and lse from this checkout's forward kernel."""
    ops = _ops("flash_attention_bwd")
    fwd = _ops("flash_attention")
    for B, S, H, Hkv, D in BWD_SHAPES:
        q = torch.randn((B, S, H, D), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((B, S, Hkv, D), generator=gen, device=dev)
                .bfloat16() for _ in range(2))
        dout = torch.randn((B, S, H, D), generator=gen, device=dev).bfloat16()
        pos = torch.arange(S, dtype=torch.int32, device=dev)[None] \
            .expand(B, S).contiguous()
        out, lse = fwd.flash_attention_lse(q, k, v, pos, pos)
        args = (q, k, v, pos, pos, out, lse, dout)
        ops._check(*args, 0, 0.0)
        yield (f"B{B} S{S} H{H}/{Hkv} D{D} causal",
               lambda lib, a=args: ops.launch(lib, *a, causal=True))


def bwd_tol(wants) -> dict:
    """chip_smoke.py phase 3's bf16 tolerance of the backward, tied to the
    scale of its three gradients: atol min(2e-2, 0.05 x their rms), rtol
    2e-2 (one bf16 rounding of each gradient)."""
    rms = math.sqrt(sum(w.float().pow(2).sum().item() for w in wants)
                    / sum(w.numel() for w in wants))
    return dict(atol=min(2e-2, 0.05 * rms), rtol=2e-2)


def bf16_entries(src: Path) -> tuple:
    """The ``__global__`` functions of a ``flash_attention_bwd.cu`` that a
    bf16 call launches: all but the fp32 route's (``*_simt``)."""
    names = re.findall(r"__global__\s+void\s+(?:__\w+__\([^)]*\)\s*)*"
                       r"(\w+)\s*\(", src.read_text())
    return tuple(n for n in names if not n.endswith("_simt"))


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


def _wgrad_plain(x, dy, be, E, bt, chunk=128):
    """The weight gradient's plain version ``chunk`` blocks at a time into
    one fp32 sum (its per-block products at the training shapes take ~7
    GB at once), cast to x's dtype at the end."""
    wops = _ops("moe_gemm_wgrad")
    dw = torch.zeros((E, x.shape[1], dy.shape[1]), dtype=torch.float32,
                     device=x.device)
    for i in range(0, be.numel(), chunk):
        rows = slice(i * bt, (i + chunk) * bt)
        dw += wops.grouped_gemm_wgrad_plain(x[rows].float(),
                                            dy[rows].float(),
                                            be[i:i + chunk], E, block_t=bt)
    return dw.to(x.dtype)


def _wgrad_cases(gen, dev):
    """(shape, call(lib), plain dw) at each weight-gradient shape: random
    router logits' top-k through ``dispatch_plan`` at the block size the
    MoE layer picks, x and dy rows gathered as the layer gathers them."""
    gops, wops = _ops("moe_gemm"), _ops("moe_gemm_wgrad")
    E, k = GEMM_EXPERTS, GEMM_TOP_K
    for label, T, M, N in WGRAD_SHAPES:
        ids = torch.topk(torch.randn((T, E), generator=gen, device=dev),
                         k, dim=-1).indices
        plan = gops.dispatch_plan(ids, E, gops.pick_block_t(T * k, E))
        tok = torch.arange(T, device=dev).repeat_interleave(k)
        x, dy = (gops.gather_rows(torch.randn((T, w), generator=gen,
                                              device=dev).bfloat16(),
                                  plan, tok) for w in (M, N))
        be, bt = plan.block_expert, plan.block_t
        wops._check(x, dy, be, E, bt)
        r = wops.route(x.dtype, bt, M, N, x.data_ptr() % 16 == 0
                       and dy.data_ptr() % 16 == 0)
        yield (f"{label} rows{x.shape[0]} bt{bt} ({r})",
               lambda lib, a=(x, dy, be, E, bt, r): wops.launch(lib, *a),
               _wgrad_plain(x, dy, be, E, bt))


def _sampling_cases(gen, dev):
    """(shape, call(lib)) at each sampling shape."""
    ops = _ops("fused_sampling")
    for B, V, lanes in SAMPLING_SHAPES:
        x, g, k, p, mp, raw = sampling_rows(gen, B, V, dev)
        kw = dict(raw=raw if lanes >= 0 else None, lp_k=max(lanes, 0),
                  with_lanes=lanes >= 0)
        ops._check(x, g, k, p, mp, kw["raw"], kw["lp_k"], kw["with_lanes"])
        yield (f"B{B} V{V}" + (f" lanes{lanes}" if lanes >= 0 else ""),
               lambda lib, a=(x, g, k, p, mp), kw=kw: ops.launch(lib, *a,
                                                                **kw))
    for label, k, p in SAMPLING_PASSES:
        x, g, k, p, mp, _ = sampling_rows(gen, 8, 128256, dev, k, p, 0.0)
        yield (f"B8 V128256 {label}",
               lambda lib, a=(x, g, k, p, mp): ops.launch(
                   lib, *a, None, lp_k=0, with_lanes=False))


def _difference(got, want) -> dict:
    """How this kernel's outputs differ from the other's: the largest
    absolute difference of a tensor; for the sampler's dict, the outputs
    whose bits differ and the largest relative difference of l / l_raw
    (raises where SAMPLING_EXACT or SAMPLING_RTOL does not hold)."""
    if isinstance(got, tuple):  # the backward's (dq, dk, dv)
        tol = bwd_tol(want)
        for g, w, name in zip(got, want, ("dq", "dk", "dv")):
            if not torch.allclose(g.float(), w.float(), **tol):
                raise AssertionError(f"flash_attention_bwd: {name} differs "
                                     f"from the other kernel's past {tol}")
        return dict(max_abs_diff=max((g.float() - w.float()).abs().max()
                                     .item() for g, w in zip(got, want)))
    if not isinstance(got, dict):
        return dict(max_abs_diff=(got.float() - want.float()).abs().max()
                    .item())
    unequal = sorted(key for key in got if not torch.equal(got[key],
                                                           want[key]))
    rel = max(((got[key] - want[key]).abs() / want[key].abs()).max().item()
              for key in ("l", "l_raw") if key in got)
    if set(unequal) - {"l", "l_raw"} or rel > SAMPLING_RTOL:
        raise AssertionError(f"fused_sampling: {unequal} differ from the "
                             f"other kernel's (l rel {rel:.3e})")
    return dict(unequal_bits=unequal, max_rel_diff_l=rel)


def wrapper_host_us(root: Path) -> float:
    """``Timer.host_us`` of the checkout at ``root``'s own ``fused_sample``
    at B8 V128256 (its kernel built into its own ``build/``), in a process
    of its own."""
    env = dict(os.environ, PYTHONPATH=str(root.resolve() / "src"))
    env.pop("REPRO_TORCH_BUILD_DIR", None)
    proc = subprocess.run([sys.executable, "-c", _HOST_PROBE], env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"host probe of {root} failed:\n{proc.stderr}")
    return float(proc.stdout.strip().splitlines()[-1])


def compare(other: Path, kernel: str = "flash_attention") -> list:
    """One row a shape: the other kernel's two times and this one's (ms,
    in the order other, this, this, other), each by CUDA events around the
    call and by the profiler's duration of the kernel alone, and how
    their outputs differ (from each other and, where the case gives one,
    from the plain version)."""
    if kernel not in KERNELS:
        raise ValueError(f"flash_ab: no A/B for {kernel}, only {KERNELS}")
    dev = torch.device("cuda", 0)
    libs = {"this": _ops(kernel)._lib(), "other": build_other(other, kernel)}
    # the kernels timed alone, each group's median summed: the backward's
    # three launches one by one, by each library's own names
    groups = {name: (KERNEL_ENTRIES[kernel],) for name in libs}
    if kernel == "flash_attention_bwd":
        here = Path(__file__).resolve().parents[3]
        groups = {name: tuple((e,) for e in bf16_entries(
            root / "src" / "repro_torch" / "csrc" / f"{kernel}.cu"))
            for name, root in (("this", here), ("other", other))}
    timer = Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = {"flash_attention": _flash_cases,
             "flash_attention_bwd": _bwd_cases,
             "paged_attention": _paged_cases, "moe_gemm": _gemm_cases,
             "moe_gemm_wgrad": _wgrad_cases,
             "fused_sampling": _sampling_cases}[kernel]
    rows = []
    for shape, fn, *plain in cases(gen, dev):
        def call(name):
            return fn(libs[name])

        outs = {name: call(name) for name in ("this", "other")}
        diff = _difference(outs["this"], outs["other"])
        for name, got in outs.items():  # each held to the plain version
            for want in plain:
                if not torch.allclose(got.float(), want.float(),
                                      **WGRAD_TOL):
                    raise AssertionError(f"{kernel} {shape}: the {name} "
                                         f"checkout's output differs from "
                                         f"the plain version past "
                                         f"{WGRAD_TOL}")
                diff[f"{name}_plain_err"] = (got.float() - want.float()) \
                    .abs().max().item()
        del outs, plain
        times = {name: [] for name in libs}
        alone = {name: [] for name in libs}
        for name in ("other", "this", "this", "other"):
            times[name].append(timer(lambda: call(name)))
        for name in ("other", "this", "this", "other"):
            alone[name].append(sum(timer.kernel_ms(lambda: call(name), g)
                                   for g in groups[name]))
        rows.append(dict(shape=shape, other_ms=times["other"],
                         this_ms=times["this"],
                         other_kernel_ms=alone["other"],
                         this_kernel_ms=alone["this"], **diff))
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
        diff = (f"max |this - other| {r['max_abs_diff']:.3e}"
                if "max_abs_diff" in r else
                f"bits differ in {r['unequal_bits']}, l rel "
                f"{r['max_rel_diff_l']:.3e}")
        if "this_plain_err" in r:
            diff += (f"; max |- plain| this {r['this_plain_err']:.3e}, "
                     f"other {r['other_plain_err']:.3e}")
        print(f"{args.kernel} {r['shape']}: other {r['other_ms'][0]:.4f} / "
              f"{r['other_ms'][1]:.4f} ms, this {r['this_ms'][0]:.4f} / "
              f"{r['this_ms'][1]:.4f} ms; kernel alone: other "
              f"{r['other_kernel_ms'][0]:.4f} / {r['other_kernel_ms'][1]:.4f}"
              f" ms, this {r['this_kernel_ms'][0]:.4f} / "
              f"{r['this_kernel_ms'][1]:.4f} ms ({diff})", flush=True)
    result = {"flash_ab": rows, "kernel": args.kernel}
    if args.kernel == "fused_sampling":
        here = Path(__file__).resolve().parents[3]
        host = {"other": [], "this": []}
        for name in ("other", "this", "this", "other"):
            host[name].append(wrapper_host_us(args.other if name == "other"
                                              else here))
        print(f"fused_sample wrapper host side, B8 V128256: other "
              f"{host['other'][0]:.1f} / {host['other'][1]:.1f} us, this "
              f"{host['this'][0]:.1f} / {host['this'][1]:.1f} us a call")
        result["wrapper_host_us"] = host
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
