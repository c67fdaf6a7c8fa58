"""Fused sampling (joint top-k / top-p / min-p threshold + Gumbel-max draw,
with optional raw-logit logprob lanes): wrapper of the Hopper kernel
``csrc/fused_sampling.cu`` and its plain PyTorch version.

``fused_sample`` runs the plain version for tensors on the CPU.  For CUDA
tensors it checks them, launches the kernel on the current stream, raises
if the launch failed and counts the launch.  The kernel splits each row
across a cluster of CTAs, each with its slice of the row in shared memory,
so it takes V up to ``max_vocab()`` (337,888, past every vocabulary of the
repo's configs) and the wrapper refuses a longer row.

The plain version is ``repro.kernels.fused_sampling.ref`` batched over
rows: online-softmax stats, then the threshold found by LEVELS rounds of
NB-bucket histogram refinement over ``(m - SPAN, m]`` (``tau_k`` and the
kept mass from count crossings, ``tau_p`` from mass crossings against
``p * Z_kept``, ``tau_m = m + log(min_p)``), then the Gumbel-max draw over
``x >= max(tau_k, tau_p, tau_m)``.  The histograms are ``scatter_add_``
into (B, NB) bins, so the serving shape (B=8, V=128256) needs no (V, NB)
one-hot.  Rows are masked at their true V: the reference pads V to its
512-wide tile with a sentinel that lands only in the catch-all bucket,
which moves no crossing.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from repro_torch import kernels
from repro_torch.kernels import build

NAME = "fused_sampling"
NEG = -1e30          # filtered-logit sentinel (matches sampling/processors)
NB = 256             # histogram buckets per refinement level
SPAN = 32.0          # nats below the max covered by the coarse histogram
LEVELS = 3           # coarse + 2 refinements -> SPAN/NB**3 ~ 1.9e-6 nats
_LIB = None


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _hist(x, w, sel, hi, width: float):
    """Bin the weights ``w`` of the selected ``x <= hi`` into NB buckets of
    ``width`` below ``hi`` (per row); values under the interval clamp into
    the catch-all bucket NB-1.  Returns (counts, mass), each (B, NB)."""
    sel = sel & (x <= hi[:, None])
    q = torch.floor((hi[:, None] - x) / width)
    idx = torch.clamp(q, 0, NB - 1).long()
    B = x.shape[0]
    cnt = x.new_zeros((B, NB)).scatter_add_(1, idx, sel.to(x.dtype))
    mass = x.new_zeros((B, NB)).scatter_add_(
        1, idx, torch.where(sel, w, torch.zeros_like(w)))
    return cnt, mass


def _cross(cum, per, target):
    """Per row: the first bucket where ``cum`` reaches ``target`` (the
    bottom bucket when it never does), and the cumulative weight strictly
    above it."""
    got = cum >= target[:, None]
    b = torch.where(got.any(dim=1), torch.argmax(got.to(torch.int32), dim=1),
                    NB - 1)
    pick = b[:, None]
    return b, (torch.gather(cum, 1, pick) - torch.gather(per, 1, pick))[:, 0]


def joint_threshold_plain(x, k, p, min_p) -> Dict[str, torch.Tensor]:
    """Histogram-refined joint threshold of rows ``x`` (B, V) f32 with
    per-row k (B,) int, p and min_p (B,) f32: ``tau`` and the per-filter
    ``tau_k`` / ``tau_p`` / ``tau_m`` (-inf when disabled), the softmax
    stats ``m`` / ``l`` and the kept-set mass ``z``."""
    V = x.shape[1]
    m = x.amax(dim=1)
    w = torch.exp(x - m[:, None])
    l = w.sum(dim=1)
    every = torch.ones_like(x, dtype=torch.bool)
    k, p, min_p = k.to(x.device), p.to(x.device), min_p.to(x.device)

    # tau_k: count-crossing refinement (+ the coarse mass kept for tau_p)
    hi, width = m, SPAN / NB
    rem = torch.clamp(k, 1, V).to(torch.float32)
    above_mass = torch.zeros_like(m)
    coarse_mass = tau_k = in_mass = None
    for lvl in range(LEVELS):
        cnt, mass = _hist(x, w, every, hi, width)
        if lvl == 0:
            coarse_mass = mass
        b, above_cnt = _cross(torch.cumsum(cnt, 1), cnt, rem)
        pick = b[:, None]
        above_mass = above_mass + (torch.gather(torch.cumsum(mass, 1), 1,
                                                pick)
                                   - torch.gather(mass, 1, pick))[:, 0]
        rem = rem - above_cnt
        in_mass = torch.gather(mass, 1, pick)[:, 0]
        hi = hi - b.to(torch.float32) * width
        tau_k = hi - width
        width = width / NB
    z = torch.where(k > 0, above_mass + in_mass, l)
    tau_k = torch.where(k > 0, tau_k, -torch.inf)

    # tau_p: mass-crossing refinement against p * z
    target = p * z
    b, above = _cross(torch.cumsum(coarse_mass, 1), coarse_mass, target)
    hi = m - b.to(torch.float32) * (SPAN / NB)
    tau_p, width = hi - SPAN / NB, SPAN / NB / NB
    kept = x >= tau_k[:, None]
    for _ in range(1, LEVELS):
        _, mass = _hist(x, w, kept, hi, width)
        b, above_l = _cross(torch.cumsum(mass, 1), mass, target - above)
        above = above + above_l
        hi = hi - b.to(torch.float32) * width
        tau_p = hi - width
        width = width / NB
    tau_p = torch.where(p < 1.0, tau_p, -torch.inf)

    tau_m = torch.where(min_p > 0.0, m + torch.log(min_p), -torch.inf)
    tau = torch.maximum(torch.maximum(tau_k, tau_p), tau_m)
    return {"tau": tau, "tau_k": tau_k, "tau_p": tau_p, "tau_m": tau_m,
            "m": m, "l": l, "z": z}


def fused_sample_plain(logits, gumbel, k, p, min_p, raw=None, *,
                       lp_k: int = 0, with_lanes: bool = False):
    """Plain PyTorch version of ``fused_sample`` (same arguments and
    outputs), batched over rows."""
    x = logits.to(torch.float32)
    th = joint_threshold_plain(x, k, p, min_p)
    s = torch.where(x >= th["tau"][:, None], x + gumbel.to(torch.float32),
                    NEG)
    out = {"sampled": torch.argmax(s, dim=1).to(torch.int32),
           "greedy": torch.argmax(x, dim=1).to(torch.int32),
           "tau": th["tau"], "m": th["m"], "l": th["l"]}
    if with_lanes:
        r = raw.to(torch.float32)
        m_raw = r.amax(dim=1)
        out["m_raw"] = m_raw
        out["l_raw"] = torch.exp(r - m_raw[:, None]).sum(dim=1)
        if lp_k > 0:
            # ties to the lowest index, as jax.lax.top_k
            vals, idx = torch.sort(r, dim=1, descending=True, stable=True)
            out["top_vals"] = vals[:, :lp_k].contiguous()
            out["top_idx"] = idx[:, :lp_k].to(torch.int32)
    return out


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a loaded library:
    ``repro_fused_sample`` and, where the library has them (not before
    the cluster kernel), ``repro_fused_sample_max_vocab``,
    ``repro_fused_sample_slice_width`` and
    ``repro_fused_sample_residency``."""
    fn = lib.repro_fused_sample
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 10)
    if hasattr(lib, "repro_fused_sample_max_vocab"):
        lib.repro_fused_sample_max_vocab.restype = ctypes.c_int
        lib.repro_fused_sample_max_vocab.argtypes = []
        lib.repro_fused_sample_slice_width.restype = ctypes.c_int
        lib.repro_fused_sample_slice_width.argtypes = [ctypes.c_int]
        lib.repro_fused_sample_residency.restype = ctypes.c_int
        lib.repro_fused_sample_residency.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 3)
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        _LIB = bind(build.load(NAME))
    return _LIB


@functools.lru_cache(maxsize=None)
def max_vocab() -> int:
    """The longest row the kernel takes: each rank's slice of x must fit
    its CTA's shared memory beside the histograms (``csrc/
    fused_sampling.cu``'s layout)."""
    return _lib().repro_fused_sample_max_vocab()


def slice_width(V: int) -> int:
    """The entries each CTA of a row's cluster owns at V: rank r's slice
    of the row starts at ``r * slice_width(V)``."""
    return _lib().repro_fused_sample_slice_width(V)


def residency(V: int, with_lanes: bool) -> Dict[str, int]:
    """The launch a call at V makes: its dynamic shared memory in bytes,
    whether the raw row is parked beside x, and how many clusters the card
    holds at once (``cudaOccupancyMaxActiveClusters``)."""
    smem, park, clusters = (ctypes.c_int() for _ in range(3))
    err = _lib().repro_fused_sample_residency(
        V, int(with_lanes), ctypes.byref(smem), ctypes.byref(park),
        ctypes.byref(clusters))
    if err != 0:
        raise RuntimeError(f"{NAME}: residency query failed: CUDA error "
                           f"{err}")
    return dict(smem_bytes=smem.value, park_raw=bool(park.value),
                clusters=clusters.value)


def _check(logits, gumbel, k, p, min_p, raw, lp_k, with_lanes):
    rows = [("logits", logits), ("gumbel", gumbel)] + (
        [("raw", raw)] if with_lanes else [])
    params = [("k", k, torch.int32), ("p", p, torch.float32),
              ("min_p", min_p, torch.float32)]
    for name, t in rows + [(n, t) for n, t, _ in params]:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{NAME}: {name} must be a tensor")
        if t.device != logits.device:
            raise ValueError(f"{NAME}: {name} on {t.device}, logits on "
                             f"{logits.device}")
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be contiguous")
    if logits.dim() != 2 or logits.numel() == 0:
        raise ValueError(f"{NAME}: logits must be a non-empty (B, V), got "
                         f"{tuple(logits.shape)}")
    B, V = logits.shape
    for name, t in rows:
        if t.dtype != torch.float32:
            raise TypeError(f"{NAME}: {name} must be float32, got {t.dtype}")
        if t.shape != (B, V):
            raise ValueError(f"{NAME}: {name} {tuple(t.shape)} vs logits "
                             f"{(B, V)}")
    for name, t, dtype in params:
        if t.dtype != dtype:
            raise TypeError(f"{NAME}: {name} must be {dtype}, got {t.dtype}")
        if t.shape != (B,):
            raise ValueError(f"{NAME}: {name} {tuple(t.shape)} vs batch {B}")
    if lp_k < 0 or lp_k > V:
        raise ValueError(f"{NAME}: lp_k {lp_k} outside [0, {V}]")


def fused_sample(logits, gumbel, k, p, min_p, raw=None, *, lp_k: int = 0,
                 with_lanes: bool = False) -> Dict[str, torch.Tensor]:
    """Single-pass sample for a (B, V) batch of processed f32 logits with
    (B, V) f32 Gumbel rows, per-row k (B,) int32, p and min_p (B,) f32.

    Returns ``sampled`` / ``greedy`` (B,) int32, ``tau`` / ``m`` / ``l``
    (B,) f32, and, with ``with_lanes``, the raw-logit softmax stats
    ``m_raw`` / ``l_raw`` and, for ``lp_k > 0``, the ``top_vals`` /
    ``top_idx`` lanes ((B, lp_k), raw values, ties to the lowest index;
    log-softmax = top_vals - m_raw - log(l_raw))."""
    if logits.device.type == "cpu":
        return fused_sample_plain(logits, gumbel, k, p, min_p, raw,
                                  lp_k=lp_k, with_lanes=with_lanes)
    if logits.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {logits.device}")
    _check(logits, gumbel, k, p, min_p, raw, lp_k, with_lanes)
    V, limit = logits.shape[1], max_vocab()
    if V > limit:
        raise ValueError(f"{NAME}: V {V} above the kernel's limit {limit} "
                         f"(a rank's slice of the row must fit its CTA's "
                         f"shared memory)")
    out = launch(_lib(), logits, gumbel, k, p, min_p, raw, lp_k=lp_k,
                 with_lanes=with_lanes)
    kernels.LAUNCHES[NAME] += 1
    return out


def launch(lib, logits, gumbel, k, p, min_p, raw, *, lp_k: int,
           with_lanes: bool) -> Dict[str, torch.Tensor]:
    """One launch of ``repro_fused_sample`` from ``lib`` on checked CUDA
    tensors; raises if the launch failed.  Counts nothing.  The outputs
    are views of one int32 and one float32 buffer."""
    B, V = logits.shape
    dev = logits.device
    K = lp_k if with_lanes else 0
    ints = torch.empty((B * (2 + K),), dtype=torch.int32, device=dev)
    floats = torch.empty((B * (3 + 2 * with_lanes + K),),
                         dtype=torch.float32, device=dev)
    out = {"sampled": ints[:B], "greedy": ints[B:2 * B],
           "tau": floats[:B], "m": floats[B:2 * B], "l": floats[2 * B:3 * B]}
    if with_lanes:
        out["m_raw"] = floats[3 * B:4 * B]
        out["l_raw"] = floats[4 * B:5 * B]
        if K > 0:
            out["top_vals"] = floats[5 * B:].view(B, K)
            out["top_idx"] = ints[2 * B:].view(B, K)

    def ptr(name: str) -> Optional[int]:
        t = out.get(name)
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_fused_sample(
            logits.data_ptr(), gumbel.data_ptr(), k.data_ptr(), p.data_ptr(),
            min_p.data_ptr(), raw.data_ptr() if with_lanes else None, B, V,
            lp_k if with_lanes else -1, ptr("sampled"), ptr("greedy"),
            ptr("tau"), ptr("m"), ptr("l"), ptr("m_raw"), ptr("l_raw"),
            ptr("top_vals"), ptr("top_idx"), stream)
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err}")
    return out
