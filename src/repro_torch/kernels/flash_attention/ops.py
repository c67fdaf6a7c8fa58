"""Prefill attention: wrapper of the Hopper kernel ``csrc/flash_attention.cu``
and its plain PyTorch version (``models/flash.py``).

``flash_attention`` runs the plain version for tensors on the CPU.  For
CUDA tensors it checks them, launches the kernel on the current stream,
raises if the launch failed and counts the launch.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.models import flash

NAME = "flash_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_LIB = None


def flash_attention_plain(q, k, v, q_pos, kv_pos, *, causal=True, window=0,
                          softcap=0.0):
    return flash.flash_attention(q, k, v, q_pos, kv_pos, causal=causal,
                                 window=window, softcap=softcap)


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load(NAME)
        fn = lib.repro_flash_attention_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                       + [ctypes.c_float] * 2
                       + [ctypes.c_int, ctypes.c_void_p])
        _LIB = lib
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
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{NAME}: q (B,Sq,H,D), k/v (B,Skv,Hkv,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % Hkv:
        raise ValueError(f"{NAME}: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"{NAME}: head dim {D} not in {_HEAD_DIMS}")
    if q_pos.shape != (B, Sq) or kv_pos.shape != (B, Skv):
        raise ValueError(f"{NAME}: positions {tuple(q_pos.shape)}, "
                         f"{tuple(kv_pos.shape)} vs q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")


def flash_attention(q, k, v, q_pos, kv_pos, *, causal=True, window=0,
                    softcap=0.0):
    """q (B,Sq,H,D), k/v (B,Skv,Hkv,D), q_pos (B,Sq) / kv_pos (B,Skv)
    int32 -> (B,Sq,H,D) in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_pos, kv_pos, causal=causal,
                                     window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {q.device}")
    _check(q, k, v, q_pos, kv_pos)
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            kv_pos.data_ptr(), out.data_ptr(), B, Sq, Skv, H, Hkv, D,
            int(bool(causal)), int(window), float(softcap),
            1.0 / math.sqrt(D), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err}")
    kernels.LAUNCHES[NAME] += 1
    return out
