"""The backward of prefill attention: wrapper of the Hopper kernel
``csrc/flash_attention_bwd.cu`` and its plain PyTorch version
(``models/flash.py::flash_attention_bwd``).

``flash_attention_bwd`` runs the plain version for tensors on the CPU.
For CUDA tensors it checks them, launches the kernel's three launches
(preprocess, dK/dV, dQ) on the current stream, raises if a launch
failed and counts the call once in ``kernels.LAUNCHES`` and, by route,
in ``ROUTE_LAUNCHES``: "mma" for bf16 inputs (the products on the
tensor cores, ``mma.sync``, fp32 sums; bf16 bases must be 16-byte
aligned), "simt" for fp32 inputs (the CUDA cores).  A window or a softcap, which the plain version takes, is
refused on the card (``ValueError``); it never falls back to the plain
version.  ``kernels/flash_attention/ops.py::FlashAttentionFn`` calls it
from autograd.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.models import flash

NAME = "flash_attention_bwd"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the head dims the kernel is instantiated for (q, k and v alike)
HEAD_DIMS = (32, 64, 128)
_ROUTES = {torch.float32: "simt", torch.bfloat16: "mma"}
_LIB = None

# calls by route since the last reset_routes()
ROUTE_LAUNCHES = {"simt": 0, "mma": 0}


def route(dtype) -> str:
    """The kernel route of a storage type: "simt" (fp32, CUDA cores) or
    "mma" (bf16, tensor cores)."""
    if dtype not in _ROUTES:
        raise TypeError(f"{NAME}: no route for {dtype}")
    return _ROUTES[dtype]


def reset_routes() -> None:
    for key in ROUTE_LAUNCHES:
        ROUTE_LAUNCHES[key] = 0


def flash_attention_bwd_plain(q, k, v, q_pos, kv_pos, out, lse, dout, *,
                              causal=True, window=0, softcap=0.0):
    return flash.flash_attention_bwd(q, k, v, q_pos, kv_pos, out, lse, dout,
                                     causal=causal, window=window,
                                     softcap=softcap)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.repro_flash_attention_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        _LIB = bind(build.load(NAME))
    return _LIB


def check_supported(q, k, v, *, window=0, softcap=0.0) -> None:
    """Raise ``ValueError`` where the card's kernel cannot take the
    backward: a window, a softcap, v's head dim apart from q's, or a head
    dim it is not instantiated for.  ``FlashAttentionFn`` asks before its
    forward runs."""
    if window > 0 or softcap > 0:
        raise ValueError(f"{NAME}: the card's backward takes no window or "
                         f"softcap (window {window}, softcap {softcap}); "
                         f"only the plain version on the CPU does")
    D, Dk, Dv = q.shape[-1], k.shape[-1], v.shape[-1]
    if not D == Dk == Dv or D not in HEAD_DIMS:
        raise ValueError(f"{NAME}: head dims q {D}, k {Dk}, v {Dv}; the "
                         f"kernel takes one of {HEAD_DIMS} for all three")


def _check(q, k, v, q_pos, kv_pos, out, lse, dout, window, softcap):
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
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"{NAME}: q (B,Sq,H,D), k and v (B,Skv,Hkv,D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or H % Hkv:
        raise ValueError(f"{NAME}: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if route(q.dtype) == "mma":
        for name, t in (("q", q), ("k", k), ("v", v), ("dout", dout)):
            if t.data_ptr() % 16:
                raise ValueError(f"{NAME}: bf16 {name} must start on a "
                                 f"16-byte boundary (16-byte tile loads), "
                                 f"its address is {t.data_ptr():#x}")
    if out.shape != q.shape or dout.shape != q.shape or \
            lse.shape != (B, Sq, H):
        raise ValueError(f"{NAME}: out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)} must be q's shape "
                         f"{tuple(q.shape)}, lse {tuple(lse.shape)} "
                         f"(B, Sq, H)")
    if q_pos.shape != (B, Sq) or kv_pos.shape != (B, Skv):
        raise ValueError(f"{NAME}: positions {tuple(q_pos.shape)}, "
                         f"{tuple(kv_pos.shape)} vs q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")


def flash_attention_bwd(q, k, v, q_pos, kv_pos, out, lse, dout, *,
                        causal=True, window=0, softcap=0.0):
    """(dq, dk, dv) in the inputs' dtype: the gradients of
    ``flash_attention`` at q (B,Sq,H,D), k and v (B,Skv,Hkv,D), from its
    output ``out``, its ``lse`` (B,Sq,H) fp32 and ``dout``."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, q_pos, kv_pos, out, lse,
                                         dout, causal=causal, window=window,
                                         softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {q.device}")
    _check(q, k, v, q_pos, kv_pos, out, lse, dout, window, softcap)
    grads = launch(_lib(), q, k, v, q_pos, kv_pos, out, lse, dout,
                   causal=causal)
    kernels.LAUNCHES[NAME] += 1
    ROUTE_LAUNCHES[route(q.dtype)] += 1
    return grads


def launch(lib, q, k, v, q_pos, kv_pos, out, lse, dout, *, causal):
    """One call of ``repro_flash_attention_bwd`` from ``lib`` (its three
    launches) on checked CUDA tensors; raises if a launch failed.  Counts
    nothing."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dl = torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            kv_pos.data_ptr(), out.data_ptr(), lse.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            dl.data_ptr(), B, Sq, Skv, H, Hkv, D, int(bool(causal)),
            1.0 / math.sqrt(D), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err}")
    return dq, dk, dv
