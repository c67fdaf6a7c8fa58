"""Backward of the Mamba-2 state recurrence between chunks: wrapper of the
Hopper kernel ``csrc/ssd_scan_bwd.cu`` and its plain PyTorch version.

The forward (``kernels/ssd_scan``) gives prev_c = H_{c-1} and final =
H_{nc-1} of H_c = H_{c-1} * d_c + S_c from H_{-1} = 0.  Given dprev
(B, H, nc, N, P) and dfinal (B, H, N, P) or None (zeros), the backward
runs the adjoint recurrence from the last chunk down:

    G = dfinal;  for c = nc-1 .. 0:  dS_c = G,
                                     dd_c = sum over (N, P) of G * prev_c,
                                     G = dprev_c + d_c * G

and returns (dstates (B, H, nc, N, P), ddecay (B, H, nc)).  It is the
derivative XLA takes of the reference's ``lax.scan``
(``repro.models.ssm.ssd_chunked``); no TPU kernel computes it.  The only
caller on the port's path is ``kernels/ssd_scan/ops.py::SsdScanFn``.

``ssd_state_scan_bwd`` runs the plain version for tensors on the CPU.
For CUDA tensors it checks them, launches the kernel on the current
stream, raises if the launch failed and counts the launch.  The kernel
gives dstates in the plain version's bits (its update rounds the product
and the sum separately, as ``dprev + d * G`` does) and ddecay summed in
a fixed order, so two launches give equal bits; ddecay differs from the
plain version's sum by float summation order.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import build

NAME = "ssd_scan_bwd"
_LIB = None


def ssd_state_scan_bwd_plain(prev, decay, dprev, dfinal=None):
    """The adjoint recurrence, one chunk at a time from the last, in the
    inputs' dtype: (dstates (B, H, nc, N, P), ddecay (B, H, nc))."""
    B, H, nc, N, P = prev.shape
    dstates = torch.empty_like(prev)
    ddecay = torch.empty((B, H, nc), dtype=prev.dtype, device=prev.device)
    g = (torch.zeros((B, H, N, P), dtype=prev.dtype, device=prev.device)
         if dfinal is None else dfinal)
    for c in range(nc - 1, -1, -1):
        dstates[:, :, c] = g
        ddecay[:, :, c] = (g * prev[:, :, c]).sum(dim=(-2, -1))
        g = dprev[:, :, c] + decay[:, :, c, None, None] * g
    return dstates, ddecay


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load(NAME)
        fn = lib.repro_ssd_state_scan_bwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        lib.repro_ssd_state_scan_bwd_scratch.restype = ctypes.c_longlong
        lib.repro_ssd_state_scan_bwd_scratch.argtypes = [ctypes.c_int] * 6
        _LIB = lib
    return _LIB


def _check(prev, decay, dprev, dfinal):
    dev = prev.device
    named = [("prev", prev), ("decay", decay), ("dprev", dprev)]
    if dfinal is not None:
        named.append(("dfinal", dfinal))
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{NAME}: {name} on {t.device}, prev on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{NAME}: {name} must be float32, got "
                            f"{t.dtype}")
    if prev.dim() != 5 or decay.dim() != 3 or \
            tuple(decay.shape) != tuple(prev.shape[:3]):
        raise ValueError(f"{NAME}: prev (B,H,nc,N,P), decay (B,H,nc); got "
                         f"{tuple(prev.shape)}, {tuple(decay.shape)}")
    if dprev.shape != prev.shape:
        raise ValueError(f"{NAME}: dprev {tuple(dprev.shape)} is not prev's "
                         f"shape {tuple(prev.shape)}")
    B, H, nc, N, P = prev.shape
    if dfinal is not None and tuple(dfinal.shape) != (B, H, N, P):
        raise ValueError(f"{NAME}: dfinal {tuple(dfinal.shape)}, expected "
                         f"{(B, H, N, P)}")
    if prev.numel() == 0:
        raise ValueError(f"{NAME}: empty prev {tuple(prev.shape)}")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be contiguous")


def ssd_state_scan_bwd(prev, decay, dprev, dfinal=None):
    """prev, dprev (B, H, nc, N, P) fp32, decay (B, H, nc) fp32, dfinal
    (B, H, N, P) fp32 or None -> (dstates (B, H, nc, N, P), ddecay
    (B, H, nc)), both fp32."""
    if prev.device.type == "cpu":
        return ssd_state_scan_bwd_plain(prev, decay, dprev, dfinal)
    if prev.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {prev.device}")
    _check(prev, decay, dprev, dfinal)
    B, H, nc, N, P = prev.shape
    dstates = torch.empty_like(prev)
    ddecay = torch.empty((B, H, nc), dtype=torch.float32, device=prev.device)
    vec = int((N * P) % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (prev, dprev, dstates, dfinal)
        if t is not None))
    lib = _lib()
    # each tile's partial sums of ddecay, summed over the tiles in order
    # by the kernel's second launch
    partial = torch.empty(
        (lib.repro_ssd_state_scan_bwd_scratch(B, H, nc, N, P, vec),),
        dtype=torch.float32, device=prev.device)
    with torch.cuda.device(prev.device):
        stream = torch.cuda.current_stream(prev.device).cuda_stream
        err = lib.repro_ssd_state_scan_bwd(
            prev.data_ptr(), decay.data_ptr(), dprev.data_ptr(),
            None if dfinal is None else dfinal.data_ptr(),
            dstates.data_ptr(), ddecay.data_ptr(), partial.data_ptr(), B, H,
            nc, N, P, vec, stream)
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err}")
    kernels.LAUNCHES[NAME] += 1
    return dstates, ddecay
