"""Decode attention over a paged KV pool: wrapper of the Hopper kernel
``csrc/paged_attention.cu`` and its plain PyTorch version.

``paged_attention`` runs the plain version for tensors on the CPU.  For
CUDA tensors it checks them, launches the kernel on the current stream,
raises if the launch failed and counts the launch.  The kernel splits each
(sequence, kv head) across a cluster of 8 CTAs and merges their partial
softmax states in distributed shared memory.  Its products have two
routes, chosen by the storage type: bf16 on the tensor cores
(``mma.sync``), fp32 on the CUDA cores; each launch is counted in
``kernels.LAUNCHES`` and, by route, in ``ROUTE_LAUNCHES``.  A row of length
0 (a free slot) gives zeros, as the TPU kernel does.  Given ``lse``, a (B, H)
fp32 tensor, the same launch also writes each (row, query head)'s log-sum-exp
of its scaled scores (``NEG`` for a row of length 0): the statistics with
which ``models/layers.py::merge_shards`` joins the outputs of a cache's
sequence shards held by other ranks.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch import kernels
from repro_torch.kernels import build

NAME = "paged_attention"
NEG = -1e30
MAX_GROUP = 16          # most query heads per kv head the kernel serves
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_ROUTES = {torch.float32: "simt", torch.bfloat16: "mma"}
_LIB = None

# launches by route since the last reset_routes()
ROUTE_LAUNCHES = {"mma": 0, "simt": 0}


def route(dtype) -> str:
    """The product route of a storage type: "mma" (bf16, tensor cores) or
    "simt" (fp32, CUDA cores)."""
    if dtype not in _ROUTES:
        raise TypeError(f"{NAME}: no route for {dtype}")
    return _ROUTES[dtype]


def reset_routes() -> None:
    for key in ROUTE_LAUNCHES:
        ROUTE_LAUNCHES[key] = 0


def paged_attention_plain(q, k_pool, v_pool, page_table, lengths, lse=None):
    """Gather each sequence's pages through the table, then a masked
    softmax over its first ``lengths`` positions (fp32 statistics).  A row
    with ``lengths <= 0`` attends to nothing and gives zeros, as
    ``paged_attention_tpu`` does.  With ``lse`` ((B, H) fp32) it also
    fills each row and head's natural-log log-sum-exp of the masked
    scaled scores, ``NEG`` for a row of length 0."""
    B, H, dh = q.shape
    _, page, Hkv, _ = k_pool.shape
    max_pages = page_table.shape[1]
    G = H // Hkv
    S = max_pages * page
    tab = page_table.long()
    k = k_pool[tab].reshape(B, S, Hkv, dh).float()
    v = v_pool[tab].reshape(B, S, Hkv, -1).float()
    qg = q.float().reshape(B, Hkv, G, dh) * (1.0 / math.sqrt(dh))
    s = torch.einsum("bhgd,bshd->bhgs", qg, k)
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] < lengths[:, None]
    s = torch.where(mask[:, None, None, :], s, NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bshd->bhgd", p / torch.clamp_min(l, 1e-30), v)
    out = torch.where((lengths > 0)[:, None, None, None], out, 0.0)
    if lse is not None:
        stat = (m + torch.log(l))[..., 0].reshape(B, H)
        lse.copy_(torch.where((lengths > 0)[:, None], stat, NEG))
    return out.reshape(B, H, -1).to(q.dtype)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry point ``repro_paged_attention_fwd`` of a
    loaded library."""
    fn = lib.repro_paged_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p])
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        _LIB = bind(build.load(NAME))
    return _LIB


def _check(q, k_pool, v_pool, page_table, lengths, lse=None):
    dev = q.device
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", page_table), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"{NAME}: {name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be contiguous")
    if (q.dtype not in _DTYPES or k_pool.dtype != q.dtype
            or v_pool.dtype != q.dtype):
        raise TypeError(f"{NAME}: q/pools must share one of float32/"
                        f"bfloat16, got {q.dtype}/{k_pool.dtype}/"
                        f"{v_pool.dtype}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"{NAME}: page_table and lengths must be int32")
    if q.dim() != 3 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"{NAME}: q (B,H,D), pools (NP,page,Hkv,D); got "
                         f"{tuple(q.shape)}, {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)}")
    B, H, D = q.shape
    Hkv = k_pool.shape[2]
    if k_pool.shape[3] != D or H % Hkv or H // Hkv > MAX_GROUP:
        raise ValueError(f"{NAME}: q {tuple(q.shape)} vs pool "
                         f"{tuple(k_pool.shape)} (at most {MAX_GROUP} q "
                         f"heads per kv head)")
    if D not in _HEAD_DIMS:
        raise ValueError(f"{NAME}: head dim {D} not in {_HEAD_DIMS}")
    if page_table.dim() != 2 or page_table.shape[0] != B or \
            lengths.shape != (B,):
        raise ValueError(f"{NAME}: page_table {tuple(page_table.shape)}, "
                         f"lengths {tuple(lengths.shape)} vs batch {B}")
    if lse is not None and (lse.device != dev or lse.dtype != torch.float32
                            or lse.shape != (B, H)
                            or not lse.is_contiguous()):
        raise ValueError(f"{NAME}: lse must be a contiguous ({B}, {H}) "
                         f"float32 tensor on {dev}, got {tuple(lse.shape)} "
                         f"{lse.dtype} on {lse.device}")
    # K/V rows arrive by 16-byte cp.async (their strides, D * 2 bytes and
    # up, are multiples of 16 at every head dim)
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{NAME}: {name} must start on a 16-byte "
                             f"boundary, its address is {t.data_ptr():#x}")


def paged_attention(q, k_pool, v_pool, page_table, lengths, lse=None):
    """q (B,H,D); pools (num_pages, page, Hkv, D); page_table (B,max_pages)
    int32; lengths (B,) int32 -> (B,H,D) in q's dtype.  ``lse``: None, or a
    (B, H) fp32 tensor that the launch fills with each row's log-sum-exp."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, page_table, lengths,
                                     lse)
    if q.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {q.device}")
    _check(q, k_pool, v_pool, page_table, lengths, lse)
    out = launch(_lib(), q, k_pool, v_pool, page_table, lengths, lse)
    kernels.LAUNCHES[NAME] += 1
    ROUTE_LAUNCHES[route(q.dtype)] += 1
    return out


def launch(lib, q, k_pool, v_pool, page_table, lengths, lse=None):
    """One launch of ``repro_paged_attention_fwd`` from ``lib`` on checked
    CUDA tensors (``lse`` None: a null pointer, which a library built
    without the argument never reads); raises if the launch failed.  Counts
    nothing."""
    B, H, D = q.shape
    _, page, Hkv, _ = k_pool.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_paged_attention_fwd(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, H,
            Hkv, D, page, page_table.shape[1], 1.0 / math.sqrt(D),
            _DTYPES[q.dtype], stream,
            None if lse is None else lse.data_ptr())
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err}")
    return out
