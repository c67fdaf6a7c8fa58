"""The weight gradient of the grouped expert GEMM: wrapper of the Hopper
kernel ``csrc/moe_gemm_wgrad.cu`` and its plain PyTorch version.

``grouped_gemm_wgrad(x, dy, block_expert, num_experts, block_t=...)``
gives dw (E, M, N) in x's dtype: for each expert e the sum, over the
blocks of ``block_t`` rows whose expert is e, of x_b^T dy_b (x (T, M) and
dy (T, N) laid out as ``moe_gemm``'s rows: sorted by expert, padded per
expert), summed in fp32; an expert with no block gives zeros, a block
whose expert is -1 (unused) is skipped.  It is the dW half of
``kernels/moe_gemm/ops.py::GroupedGemmFn``'s backward, the only caller on
the port's path.

The wrapper runs the plain version for tensors on the CPU.  For CUDA
tensors it checks them, names the kernel's route with ``route()``, lists
the blocks by expert on the device (``block_order``: a stable sort, no
host sync), launches the kernel on the current stream, raises if the
launch failed and counts the launch in ``kernels.LAUNCHES`` and, by
route, in ``ROUTE_LAUNCHES``.  The three routes (the kernel's note says
how each works):

- ``"wgmma"``: bf16 with ``block_t`` a multiple of 64, M and N multiples
  of 8 and 16-byte-aligned x and dy (TMA's stride and alignment rules):
  every weight gradient of bf16 MoE training.  128 x 256 output tiles on
  ``wgmma`` with both operands MN-major, x and dy k-tiles fed by TMA
  through an mbarrier ring, the output stored by TMA.
- ``"mma"``: every other bf16 call (ragged widths, ``block_t`` 16).
  128 x 128 tiles on ``mma.sync``.
- ``"simt"``: fp32, on the CUDA cores.

No route stands in for another: a launch the named route refuses raises.
On every route one CTA sums an output tile over its expert's blocks in a
fixed order, so there are no atomics and two launches give equal bits.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import build

NAME = "moe_gemm_wgrad"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTE_CODES = {"simt": 0, "mma": 1, "wgmma": 2}
_LIB = None

# launches by route since the last reset_routes()
ROUTE_LAUNCHES = {"wgmma": 0, "mma": 0, "simt": 0}


def route(dtype, block_t: int, M: int, N: int, aligned: bool) -> str:
    """The kernel's route for a call: "simt" for fp32; for bf16 "wgmma"
    when ``block_t`` is a multiple of 64, M and N are multiples of 8 (TMA
    strides of 16 bytes) and ``aligned`` (x and dy start on 16-byte
    boundaries), else "mma"."""
    if dtype == torch.float32:
        return "simt"
    if dtype != torch.bfloat16:
        raise TypeError(f"{NAME}: no route for {dtype}")
    if block_t % 64 == 0 and M % 8 == 0 and N % 8 == 0 and aligned:
        return "wgmma"
    return "mma"


def reset_routes() -> None:
    for key in ROUTE_LAUNCHES:
        ROUTE_LAUNCHES[key] = 0


def grouped_gemm_wgrad_plain(x, dy, block_expert, num_experts: int, *,
                             block_t: int = 128):
    """Per used block an fp32 x_b^T dy_b, ``index_add``ed onto its expert
    (E, M, N), cast to x's dtype."""
    T, M = x.shape
    N = dy.shape[1]
    nb = T // block_t
    be = block_expert.long()
    used = torch.nonzero((be >= 0) & (be < num_experts)).squeeze(1)
    dw = torch.zeros((num_experts, M, N), dtype=torch.float32,
                     device=x.device)
    xb = x.reshape(nb, block_t, M)[used].float()
    yb = dy.reshape(nb, block_t, N)[used].float()
    dw.index_add_(0, be[used], torch.bmm(xb.transpose(1, 2), yb))
    return dw.to(x.dtype)


def block_order(block_expert, num_experts: int):
    """(order (nb,), start (E + 1,)) int32: the blocks sorted by expert,
    each expert's in block order, and the bounds of expert e's in ``order``
    (``order[start[e]:start[e + 1]]``); unused blocks (-1) sort first and
    belong to no expert."""
    be = block_expert.long()
    srt, order = torch.sort(be, stable=True)
    bounds = torch.arange(num_experts + 1, device=be.device)
    start = torch.searchsorted(srt, bounds)
    return order.to(torch.int32), start.to(torch.int32)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry point ``repro_grouped_gemm_wgrad`` of a loaded
    library."""
    fn = lib.repro_grouped_gemm_wgrad
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        _LIB = bind(build.load(NAME))
    return _LIB


def _check(x, dy, block_expert, num_experts, block_t):
    dev = x.device
    for name, t in (("x", x), ("dy", dy), ("block_expert", block_expert)):
        if t.device != dev:
            raise ValueError(f"{NAME}: {name} on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be contiguous")
    if x.dtype not in _DTYPES or dy.dtype != x.dtype:
        raise TypeError(f"{NAME}: x and dy must share one of float32/"
                        f"bfloat16, got {x.dtype}/{dy.dtype}")
    if block_expert.dtype != torch.int32:
        raise TypeError(f"{NAME}: block_expert must be int32")
    if x.dim() != 2 or dy.dim() != 2 or dy.shape[0] != x.shape[0]:
        raise ValueError(f"{NAME}: x (T,M), dy (T,N); got "
                         f"{tuple(x.shape)}, {tuple(dy.shape)}")
    T = x.shape[0]
    if block_t <= 0 or block_t % 16 or T % block_t:
        raise ValueError(f"{NAME}: block_t {block_t} must be a multiple of "
                         f"16 that divides T={T}")
    if block_expert.shape != (T // block_t,):
        raise ValueError(f"{NAME}: block_expert {tuple(block_expert.shape)} "
                         f"!= ({T // block_t},)")
    if num_experts <= 0:
        raise ValueError(f"{NAME}: num_experts {num_experts}")


def grouped_gemm_wgrad(x, dy, block_expert, num_experts: int, *,
                       block_t: int = 128):
    """x (T, M), dy (T, N) rows sorted by expert, padded per expert to
    ``block_t``; block_expert (T / block_t,) int32 (-1: unused) -> dw (E,
    M, N) in x's dtype, fp32 sums."""
    if x.device.type == "cpu":
        return grouped_gemm_wgrad_plain(x, dy, block_expert, num_experts,
                                        block_t=block_t)
    if x.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {x.device}")
    _check(x, dy, block_expert, num_experts, block_t)
    r = route(x.dtype, block_t, x.shape[1], dy.shape[1],
              x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0)
    out = launch(_lib(), x, dy, block_expert, num_experts, block_t, r)
    kernels.LAUNCHES[NAME] += 1
    ROUTE_LAUNCHES[r] += 1
    return out


def launch(lib, x, dy, block_expert, num_experts: int, block_t: int,
           route_name: str):
    """One launch of ``repro_grouped_gemm_wgrad`` from ``lib`` (see
    ``bind``) on checked CUDA tensors, on route ``route_name``; raises if
    the launch failed.  Counts nothing."""
    T, M = x.shape
    N = dy.shape[1]
    order, start = block_order(block_expert, num_experts)
    out = torch.empty((num_experts, M, N), dtype=x.dtype, device=x.device)
    vec = 16 // x.element_size()          # elements of one 16-byte load
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_grouped_gemm_wgrad(
            x.data_ptr(), dy.data_ptr(), order.data_ptr(), start.data_ptr(),
            out.data_ptr(), T, M, N, num_experts, block_t,
            int(x.data_ptr() % 16 == 0 and M % vec == 0),
            int(dy.data_ptr() % 16 == 0 and N % vec == 0),
            _DTYPES[x.dtype], _ROUTE_CODES[route_name], stream)
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed on the "
                           f"{route_name} route: CUDA error {err}")
    return out
