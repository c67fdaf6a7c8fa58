"""Mamba-2 state recurrence between chunks: wrapper of the Hopper kernel
``csrc/ssd_scan.cu`` and its plain PyTorch version.

``ssd_state_scan`` runs the plain version for tensors on the CPU.  For
CUDA tensors it checks them, launches the kernel on the current stream,
raises if the launch failed and counts the launch.  Counterpart of
``repro.kernels.ssd_scan.ssd_state_scan`` (same arguments, same outputs);
the kernel gives the plain version's bits (its update rounds the product
and the sum separately, as ``h * d + s`` does).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import build

NAME = "ssd_scan"
_LIB = None


def ssd_state_scan_plain(states, decay):
    """H_c = H_{c-1} * decay_c + S_c from H_{-1} = 0, one chunk at a time:
    (the state entering each chunk (B, H, nc, N, P), the final state
    (B, H, N, P))."""
    B, H, nc, N, P = states.shape
    prev = torch.empty_like(states)
    h = torch.zeros((B, H, N, P), dtype=states.dtype, device=states.device)
    for c in range(nc):
        prev[:, :, c] = h
        h = h * decay[:, :, c, None, None] + states[:, :, c]
    return prev, h


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load(NAME)
        fn = lib.repro_ssd_state_scan
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        _LIB = lib
    return _LIB


def _check(states, decay):
    dev = states.device
    if decay.device != dev:
        raise ValueError(f"{NAME}: decay on {decay.device}, states on {dev}")
    if states.dtype != torch.float32 or decay.dtype != torch.float32:
        raise TypeError(f"{NAME}: states and decay must be float32, got "
                        f"{states.dtype}/{decay.dtype}")
    if states.dim() != 5 or decay.dim() != 3 or \
            tuple(decay.shape) != tuple(states.shape[:3]):
        raise ValueError(f"{NAME}: states (B,H,nc,N,P), decay (B,H,nc); got "
                         f"{tuple(states.shape)}, {tuple(decay.shape)}")
    if states.numel() == 0:
        raise ValueError(f"{NAME}: empty states {tuple(states.shape)}")
    for name, t in (("states", states), ("decay", decay)):
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be contiguous")


def ssd_state_scan(states, decay):
    """states (B, H, nc, N, P) fp32, decay (B, H, nc) fp32 ->
    (prev (B, H, nc, N, P), final (B, H, N, P)), both fp32."""
    if states.device.type == "cpu":
        return ssd_state_scan_plain(states, decay)
    if states.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {states.device}")
    _check(states, decay)
    B, H, nc, N, P = states.shape
    prev = torch.empty_like(states)
    final = torch.empty((B, H, N, P), dtype=torch.float32,
                        device=states.device)
    vec = int((N * P) % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (states, prev, final)))
    lib = _lib()
    with torch.cuda.device(states.device):
        stream = torch.cuda.current_stream(states.device).cuda_stream
        err = lib.repro_ssd_state_scan(
            states.data_ptr(), decay.data_ptr(), prev.data_ptr(),
            final.data_ptr(), B, H, nc, N, P, vec, stream)
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err}")
    kernels.LAUNCHES[NAME] += 1
    return prev, final
