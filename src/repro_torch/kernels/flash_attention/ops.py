"""Prefill attention: wrapper of the Hopper kernel ``csrc/flash_attention.cu``
and its plain PyTorch version (``models/flash.py``).

``flash_attention`` runs the plain version for tensors on the CPU.  For
CUDA tensors it checks them, launches the kernel on the current stream,
raises if the launch failed and counts the launch.  The kernel has two
routes, chosen here by the storage type: bf16 runs on the tensor cores
(``wgmma``, K/V tiles by TMA), fp32 on the CUDA cores.  Each launch is
counted in ``kernels.LAUNCHES`` and, by route, in ``ROUTE_LAUNCHES``.
A bf16 input the tensor-core route cannot take raises; it never goes to
the fp32 route.  V may be narrower than q and k (MLA's prefill: q/k heads
of 192, v heads of 128) for the instantiated pairs of ``HEAD_DIMS``; V is
never padded in device memory, and any other pair raises.  A head dim
that is not a multiple of the tensor-core route's 64-column box (80) is
padded in shared memory only.

Under autograd (grad enabled and q, k or v requiring grad)
``flash_attention`` goes through ``FlashAttentionFn``: its forward runs
the kernel with the rows' log-sum-exp (``flash_attention_lse``), its
backward the kernel of ``kernels/flash_attention_bwd`` (on the CPU both
plain versions).  The serving path, whose weights never require grad,
keeps the launch without ``lse``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention_bwd import ops as bwd_ops
from repro_torch.models import flash

NAME = "flash_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the (q/k, v) head dims the kernel is instantiated for, on both routes
HEAD_DIMS = ((32, 32), (64, 64), (80, 80), (128, 128), (192, 128),
             (256, 256))
_ROUTES = {torch.float32: "simt", torch.bfloat16: "wgmma"}
_LIB = None

# launches by route since the last reset_routes()
ROUTE_LAUNCHES = {"wgmma": 0, "simt": 0}


def route(dtype) -> str:
    """The kernel route of a storage type: "wgmma" (bf16, tensor cores) or
    "simt" (fp32, CUDA cores)."""
    if dtype not in _ROUTES:
        raise TypeError(f"{NAME}: no route for {dtype}")
    return _ROUTES[dtype]


def max_keys(dqk: int, dv: Optional[int] = None) -> int:
    """The most keys (Skv) the tensor-core route takes at q/k head dim
    ``dqk`` and v head dim ``dv`` (``dqk`` when absent), as the built
    kernel computes it (``repro_flash_max_keys``): its tile list, 12 bytes
    a 64-key tile, shares the CTA's 227 KiB of shared memory with the Q
    tile and the K/V ring.  ~354K keys at (128, 128) and at (80, 80),
    ~791K at (64, 64), ~1.0M at (32, 32), ~92K at (192, 128), ~182K at
    (256, 256)."""
    return _lib().repro_flash_max_keys(dqk, dqk if dv is None else dv)


def reset_routes() -> None:
    for key in ROUTE_LAUNCHES:
        ROUTE_LAUNCHES[key] = 0


def flash_attention_plain(q, k, v, q_pos, kv_pos, *, causal=True, window=0,
                          softcap=0.0):
    return flash.flash_attention(q, k, v, q_pos, kv_pos, causal=causal,
                                 window=window, softcap=softcap)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a loaded library:
    ``repro_flash_attention_fwd`` (with its ``lse`` pointer) and, where the
    library has it (not before head dims 80 and 256),
    ``repro_flash_max_keys``."""
    fn = lib.repro_flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                   + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    if hasattr(lib, "repro_flash_max_keys"):
        lib.repro_flash_max_keys.restype = ctypes.c_int
        lib.repro_flash_max_keys.argtypes = [ctypes.c_int] * 2
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        _LIB = bind(build.load(NAME))
    return _LIB


def _check(q, k, v, q_pos, kv_pos):
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v), ("q_pos", q_pos),
                    ("kv_pos", kv_pos)):
        if t.device != dev:
            raise ValueError(f"{NAME}: {name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be contiguous")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{NAME}: q/k/v must share one of float32/bfloat16, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if q_pos.dtype != torch.int32 or kv_pos.dtype != torch.int32:
        raise TypeError(f"{NAME}: positions must be int32")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"{NAME}: q (B,Sq,H,Dqk), k (B,Skv,Hkv,Dqk), v "
                         f"(B,Skv,Hkv,Dv); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != B or k.shape[3] != D or H % Hkv:
        raise ValueError(f"{NAME}: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if (D, Dv) not in HEAD_DIMS:
        raise ValueError(f"{NAME}: head dim (q/k {D}, v {Dv}) not in "
                         f"{HEAD_DIMS}")
    if q_pos.shape != (B, Sq) or kv_pos.shape != (B, Skv):
        raise ValueError(f"{NAME}: positions {tuple(q_pos.shape)}, "
                         f"{tuple(kv_pos.shape)} vs q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if route(q.dtype) == "wgmma":
        # TMA reads q/k/v from a 16-byte-aligned base (its row strides,
        # D * 2 bytes and up, are multiples of 16 at every head dim)
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"{NAME}: bf16 {name} must start on a "
                                 f"16-byte boundary for TMA, its address "
                                 f"is {t.data_ptr():#x}")
        limit = max_keys(D, Dv)
        if Skv > limit:
            raise ValueError(f"{NAME}: bf16 takes at most "
                             f"{limit} keys at head dim (q/k {D}, "
                             f"v {Dv}) (its tile list must fit the CTA's "
                             f"227 KiB of shared memory), got Skv {Skv}")


def flash_attention(q, k, v, q_pos, kv_pos, *, causal=True, window=0,
                    softcap=0.0):
    """q (B,Sq,H,Dqk), k (B,Skv,Hkv,Dqk), v (B,Skv,Hkv,Dv), q_pos (B,Sq) /
    kv_pos (B,Skv) int32 -> (B,Sq,H,Dv) in q's dtype; the scale is
    1/sqrt(Dqk).  Differentiable in q, k and v (``FlashAttentionFn``)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, q_pos, kv_pos, causal,
                                      window, softcap)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_pos, kv_pos, causal=causal,
                                     window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {q.device}")
    _check(q, k, v, q_pos, kv_pos)
    out = launch(_lib(), q, k, v, q_pos, kv_pos, causal=causal,
                 window=window, softcap=softcap)
    kernels.LAUNCHES[NAME] += 1
    ROUTE_LAUNCHES[route(q.dtype)] += 1
    return out


def flash_attention_lse(q, k, v, q_pos, kv_pos, *, causal=True, window=0,
                        softcap=0.0):
    """``flash_attention``'s (out, lse): lse (B,Sq,H) fp32 is each row's
    log-sum-exp in natural-log units of the scaled (and softcapped)
    scores, what the backward recomputes P from.  Not differentiable."""
    if q.device.type == "cpu":
        return flash.flash_attention(q, k, v, q_pos, kv_pos, causal=causal,
                                     window=window, softcap=softcap,
                                     return_lse=True)
    if q.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {q.device}")
    _check(q, k, v, q_pos, kv_pos)
    out = launch(_lib(), q, k, v, q_pos, kv_pos, causal=causal,
                 window=window, softcap=softcap, with_lse=True)
    kernels.LAUNCHES[NAME] += 1
    ROUTE_LAUNCHES[route(q.dtype)] += 1
    return out


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` under autograd: the forward kernel with ``lse``
    on CUDA (the plain forward on the CPU), saving q, k, v, the positions,
    out and lse; the backward kernel on CUDA (the plain backward on the
    CPU), with the forward's causal flag, window and softcap.  The two
    kernels take the same (q/k, v) head-dim pairs (MLA's (192, 128) among
    them); on the card a pair outside the backward's ``HEAD_DIMS`` raises
    ``ValueError`` before the forward runs, so that no graph is built
    whose backward cannot run."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, causal, window, softcap):
        if q.device.type == "cuda":
            bwd_ops.check_supported(q, k, v, window=window, softcap=softcap)
        out, lse = flash_attention_lse(q, k, v, q_pos, kv_pos,
                                       causal=causal, window=window,
                                       softcap=softcap)
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, out, lse)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_pos, kv_pos, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        if dout.data_ptr() % 16:        # the kernel's 16-byte tile loads
            dout = dout.clone()
        dq, dk, dv = bwd_ops.flash_attention_bwd(
            q, k, v, q_pos, kv_pos, out, lse, dout, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def launch(lib, q, k, v, q_pos, kv_pos, *, causal, window, softcap,
           with_lse=False):
    """One launch of ``repro_flash_attention_fwd`` from ``lib`` on checked
    CUDA tensors; raises if the launch failed.  Counts nothing.  Returns
    out, or with ``with_lse`` (out, lse (B,Sq,H) fp32)."""
    B, Sq, H, D = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            kv_pos.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, Sq, Skv, H, Hkv, D,
            Dv, int(bool(causal)), int(window), float(softcap),
            1.0 / math.sqrt(D), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err}")
    return (out, lse) if with_lse else out
