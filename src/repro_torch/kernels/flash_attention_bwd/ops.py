"""The backward of prefill attention: wrapper of the Hopper kernel
``csrc/flash_attention_bwd.cu`` and its plain PyTorch version
(``models/flash.py::flash_attention_bwd``).

``flash_attention_bwd`` runs the plain version for tensors on the CPU.
For CUDA tensors it checks them, launches the kernel's three launches
(preprocess, dK/dV, dQ) on the current stream, raises if a launch
failed and counts the call once in ``kernels.LAUNCHES`` and, by route,
in ``ROUTE_LAUNCHES``: "wgmma" for bf16 inputs (the products on the
tensor cores by ``wgmma``, the tiles brought by TMA, fp32 sums; q, k, v,
out and dout must start on a 16-byte boundary, and Sq and Skv may not pass
``max_len``), "simt" for fp32 inputs (the CUDA cores).  Both routes take a
sliding window and a tanh softcap, as the plain version does, at the (q/k,
v) head-dim pairs of ``HEAD_DIMS`` (v's apart from q's at MLA's (192,
128)); any other pair is refused on the card (``ValueError``); it never
falls back to the plain version.
``kernels/flash_attention/ops.py::FlashAttentionFn`` calls it from
autograd.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.models import flash

NAME = "flash_attention_bwd"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the (q/k, v) head dims the kernel is instantiated for, on both routes
HEAD_DIMS = ((32, 32), (64, 64), (80, 80), (128, 128), (192, 128),
             (256, 256))
_ROUTES = {torch.float32: "simt", torch.bfloat16: "wgmma"}
_LIB = None

# calls by route since the last reset_routes()
ROUTE_LAUNCHES = {"simt": 0, "wgmma": 0}


def route(dtype) -> str:
    """The kernel route of a storage type: "simt" (fp32, CUDA cores) or
    "wgmma" (bf16, tensor cores)."""
    if dtype not in _ROUTES:
        raise TypeError(f"{NAME}: no route for {dtype}")
    return _ROUTES[dtype]


def max_len(dqk: int, dv: Optional[int] = None) -> int:
    """The most q rows (Sq) and keys (Skv) the bf16 route takes at q/k head
    dim ``dqk`` and v head dim ``dv`` (``dqk`` when absent), as the built
    kernel computes it (``repro_flash_bwd_max_len``): the least and
    greatest position of each tile it walks, 8 bytes a tile, share each
    CTA's 227 KiB of shared memory with its tiles and its ring.  244,928 at
    (80, 80) and (128, 128), 253,536 at (192, 128), 122,464 at (256,
    256); 0 for a pair it has no instantiation for."""
    return _lib().repro_flash_bwd_max_len(dqk, dqk if dv is None else dv)


def scratch_len(dtype, B: int, Sq: int, Skv: int, H: int) -> int:
    """fp32 words of the kernel's scratch, whatever the head dims: Dl (B,
    Sq, H) on the fp32 route;
    on the bf16 route, for each (batch row, q head) the rows' lse, Dl and q
    positions side by side, (B, H, 3, Sqp), then the kv positions (B,
    Skvp), Sqp and Skvp being Sq and Skv rounded up to a multiple of 64 (so
    that every row TMA reads starts on a 16-byte boundary)."""
    if route(dtype) == "simt":
        return B * Sq * H
    pad = lambda n: -(-n // 64) * 64
    return 3 * B * H * pad(Sq) + B * pad(Skv)


def reset_routes() -> None:
    for key in ROUTE_LAUNCHES:
        ROUTE_LAUNCHES[key] = 0


def flash_attention_bwd_plain(q, k, v, q_pos, kv_pos, out, lse, dout, *,
                              causal=True, window=0, softcap=0.0):
    return flash.flash_attention_bwd(q, k, v, q_pos, kv_pos, out, lse, dout,
                                     causal=causal, window=window,
                                     softcap=softcap)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a loaded library:
    ``repro_flash_attention_bwd`` (q/k's and v's head dims apart) and,
    where the library has it (not before the wgmma route),
    ``repro_flash_bwd_max_len``."""
    fn = lib.repro_flash_attention_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 9
                   + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    if hasattr(lib, "repro_flash_bwd_max_len"):
        lib.repro_flash_bwd_max_len.restype = ctypes.c_int
        lib.repro_flash_bwd_max_len.argtypes = [ctypes.c_int] * 2
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        _LIB = bind(build.load(NAME))
    return _LIB


def check_supported(q, k, v, *, window=0, softcap=0.0) -> None:
    """Raise ``ValueError`` where the card's kernel cannot take the
    backward: k's head dim apart from q's, or a (q/k, v) pair it is not
    instantiated for (one outside ``HEAD_DIMS``; MLA's (192, 128) is
    one of them).  Any ``window`` and ``softcap`` are taken.
    ``FlashAttentionFn`` asks before its forward runs."""
    D, Dk, Dv = q.shape[-1], k.shape[-1], v.shape[-1]
    if D != Dk or (D, Dv) not in HEAD_DIMS:
        raise ValueError(f"{NAME}: head dims q {D}, k {Dk}, v {Dv}; the "
                         f"kernel takes one of {HEAD_DIMS} as (q/k, v), q "
                         f"and k alike")


def _check(q, k, v, q_pos, kv_pos, out, lse, dout, window=0, softcap=0.0):
    check_supported(q, k, v, window=window, softcap=softcap)
    dev = q.device
    named = (("q", q), ("k", k), ("v", v), ("q_pos", q_pos),
             ("kv_pos", kv_pos), ("out", out), ("lse", lse), ("dout", dout))
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{NAME}: {name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be contiguous")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype
                                     for t in (k, v, out, dout)):
        raise TypeError(f"{NAME}: q/k/v/out/dout must share one of "
                        f"float32/bfloat16, got {q.dtype}/{k.dtype}/"
                        f"{v.dtype}/{out.dtype}/{dout.dtype}")
    if lse.dtype != torch.float32:
        raise TypeError(f"{NAME}: lse must be float32, got {lse.dtype}")
    if q_pos.dtype != torch.int32 or kv_pos.dtype != torch.int32:
        raise TypeError(f"{NAME}: positions must be int32")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or \
            k.shape[:3] != v.shape[:3]:
        raise ValueError(f"{NAME}: q (B,Sq,H,Dqk), k (B,Skv,Hkv,Dqk), v "
                         f"(B,Skv,Hkv,Dv); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != B or H % Hkv:
        raise ValueError(f"{NAME}: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if out.shape != (B, Sq, H, Dv) or dout.shape != out.shape or \
            lse.shape != (B, Sq, H):
        raise ValueError(f"{NAME}: out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)} must be (B, Sq, H, Dv) "
                         f"{(B, Sq, H, Dv)}, lse {tuple(lse.shape)} "
                         f"(B, Sq, H)")
    if q_pos.shape != (B, Sq) or kv_pos.shape != (B, Skv):
        raise ValueError(f"{NAME}: positions {tuple(q_pos.shape)}, "
                         f"{tuple(kv_pos.shape)} vs q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if route(q.dtype) == "wgmma":
        # TMA reads q, k, v and dout in tiles, the preprocess out and dout
        # 16 bytes a lane: each base on a 16-byte boundary (the row strides,
        # H * D * 2 and Hkv * D * 2 bytes, are multiples of 16 at every head
        # dim of HEAD_DIMS)
        for name, t in (("q", q), ("k", k), ("v", v), ("out", out),
                        ("dout", dout)):
            if t.data_ptr() % 16:
                raise ValueError(f"{NAME}: bf16 {name} must start on a "
                                 f"16-byte boundary (TMA and 16-byte loads "
                                 f"read its tiles), its address is "
                                 f"{t.data_ptr():#x}")
        limit = max_len(D, Dv)
        if max(Sq, Skv) > limit:
            raise ValueError(f"{NAME}: bf16 takes at most {limit} q rows "
                             f"and keys at head dims (q/k {D}, v {Dv}) "
                             f"(each CTA keeps "
                             f"the position range of every tile it walks "
                             f"in its 227 KiB of shared memory), got Sq "
                             f"{Sq}, Skv {Skv}")


def flash_attention_bwd(q, k, v, q_pos, kv_pos, out, lse, dout, *,
                        causal=True, window=0, softcap=0.0):
    """(dq, dk, dv) in the inputs' dtype: the gradients of
    ``flash_attention`` at q (B,Sq,H,Dqk), k (B,Skv,Hkv,Dqk) and v
    (B,Skv,Hkv,Dv), from its output ``out`` (B,Sq,H,Dv), its ``lse``
    (B,Sq,H) fp32 and ``dout`` (out's shape)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, q_pos, kv_pos, out, lse,
                                         dout, causal=causal, window=window,
                                         softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {q.device}")
    _check(q, k, v, q_pos, kv_pos, out, lse, dout, window, softcap)
    grads = launch(_lib(), q, k, v, q_pos, kv_pos, out, lse, dout,
                   causal=causal, window=window, softcap=softcap)
    kernels.LAUNCHES[NAME] += 1
    ROUTE_LAUNCHES[route(q.dtype)] += 1
    return grads


def launch(lib, q, k, v, q_pos, kv_pos, out, lse, dout, *, causal,
           window=0, softcap=0.0):
    """One call of ``repro_flash_attention_bwd`` from ``lib`` (its three
    launches) on checked CUDA tensors; raises if a launch failed.  Counts
    nothing."""
    B, Sq, H, D = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    scratch = torch.empty(scratch_len(q.dtype, B, Sq, Skv, H),
                          dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            kv_pos.data_ptr(), out.data_ptr(), lse.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            scratch.data_ptr(), B, Sq, Skv, H, Hkv, D, Dv, int(bool(causal)),
            int(window), float(softcap), 1.0 / math.sqrt(D),
            _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err}")
    return dq, dk, dv
