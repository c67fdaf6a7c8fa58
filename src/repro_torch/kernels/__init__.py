"""Hopper kernel registry of the PyTorch port.

Each kernel is a CUDA C++ source ``repro_torch/csrc/<name>.cu``, built for
``sm_90a`` by ``kernels/build.py`` into a shared library with a plain C
interface, and a wrapper ``kernels/<name>/ops.py`` that checks its
inputs, launches it on the current stream and counts the launch.  Beside
every wrapper lives the kernel's plain PyTorch version, which the wrapper
takes only for tensors on the CPU: for a CUDA tensor it launches the
kernel or raises.  ``get_kernel(name)`` resolves both lazily, so
importing this package builds nothing.
"""
import importlib
from typing import Dict

# name -> (wrapper, plain PyTorch version), both in kernels/<name>/ops.py
KERNELS = {
    "flash_attention": ("flash_attention", "flash_attention_plain"),
    "flash_attention_bwd": ("flash_attention_bwd",
                            "flash_attention_bwd_plain"),
    "paged_attention": ("paged_attention", "paged_attention_plain"),
    "fused_sampling": ("fused_sample", "fused_sample_plain"),
    "moe_gemm": ("grouped_gemm", "grouped_gemm_plain"),
    # the grouped GEMM's weight gradient (its backward's dW; no TPU kernel)
    "moe_gemm_wgrad": ("grouped_gemm_wgrad", "grouped_gemm_wgrad_plain"),
    "ssd_scan": ("ssd_state_scan", "ssd_state_scan_plain"),
}

# launches of each kernel since the last reset: a wrapper adds one where
# it launches its kernel, and nowhere else
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}


def get_kernel(name: str):
    """(wrapper, plain PyTorch version) of a registered kernel."""
    op_name, plain_name = KERNELS[name]
    ops = importlib.import_module(f"repro_torch.kernels.{name}.ops")
    return getattr(ops, op_name), getattr(ops, plain_name)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launches() -> Dict[str, int]:
    return dict(LAUNCHES)
