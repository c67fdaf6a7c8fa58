"""Device selection and host<->device helpers shared by the port.

* ``resolve_device``: every entry point takes ``device=``.  The default
  is ``"cuda"``, and without a card that raises: nothing carries on on
  the CPU unless the caller asks for ``device="cpu"``.  ``"meta"`` gives
  tensors without storage (shapes for the sharding rules and the dry
  run).
* bf16 has no numpy dtype, and the host store (``memory/paged_kv.py``)
  holds numpy pages.  Pages of a bf16 cache are kept as ``uint16`` bit
  views; ``to_numpy`` / ``from_numpy`` convert at the boundary, and the
  engine notes the torch dtype to view them back on restore.
* ``HostCopy`` is the counterpart of ``repro.compat.copy_to_host_async``:
  a ``non_blocking`` copy into pinned host memory on a side stream, with a
  CUDA event that ``HostCopy.wait`` blocks on.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

_COPY_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller
    names another.  Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """``ModelConfig.dtype`` ("bfloat16", "float32", ...) as a torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host numpy snapshot of ``t`` (bf16 as ``uint16`` bits).  A CPU
    tensor is copied, so the array never aliases a cache written in
    place later."""
    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    else:
        t = t.clone()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def from_numpy(a: np.ndarray, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """Inverse of ``to_numpy``: a tensor of ``dtype`` on ``device``.  A
    bf16 target takes ``uint16`` bits, or a bfloat16 array of another
    package viewed as its bits."""
    if not a.flags.writeable or not a.flags.c_contiguous:
        a = np.array(a, order="C")
    if dtype == torch.bfloat16:
        if a.dtype != np.uint16 and a.dtype.name != "bfloat16":
            raise TypeError(f"bf16 host data must be uint16 bits, "
                            f"got {a.dtype}")
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a).to(dtype)
    return t.to(device)


def _copy_stream(device: torch.device) -> "torch.cuda.Stream":
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    s = _COPY_STREAMS.get(idx)
    if s is None:
        s = _COPY_STREAMS[idx] = torch.cuda.Stream(device=idx)
    return s


class HostCopy:
    """One issued device->host copy: the pinned host tensor it lands in
    and the event recorded after it on the copy stream.  On the CPU the
    source is simply kept."""
    __slots__ = ("host", "event")

    def __init__(self, src: torch.Tensor):
        self.event: Optional[torch.cuda.Event] = None
        if src.device.type != "cuda":
            self.host = src
            return
        stream = _copy_stream(src.device)
        # the copy must see every kernel that produced ``src``
        stream.wait_stream(torch.cuda.current_stream(src.device))
        self.host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        with torch.cuda.stream(stream):
            self.host.copy_(src, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(stream)
        # the caching allocator must not hand ``src`` out again before the
        # copy stream is done reading it
        src.record_stream(stream)

    def wait(self) -> torch.Tensor:
        if self.event is not None:
            self.event.synchronize()
        return self.host

