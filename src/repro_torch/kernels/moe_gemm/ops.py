"""Grouped expert GEMM: wrapper of the Hopper kernel ``csrc/moe_gemm.cu``,
its plain PyTorch version, and the dispatch around it.

``grouped_gemm`` runs the plain version for tensors on the CPU.  For CUDA
tensors it checks them, names the kernel's route with ``route()``,
launches the kernel on the current stream, raises if the launch failed
and counts the launch in ``kernels.LAUNCHES`` and, by route, in
``ROUTE_LAUNCHES``.  The three routes (the kernel's note says how each
works):

- ``"wgmma"``: bf16 with ``block_t`` a multiple of 64, D and F multiples
  of 8 and 16-byte-aligned x and w (TMA's stride and alignment rules):
  every prefill launch of the serving path.  128 x 128 output tiles on
  ``wgmma``, x and w tiles fed by TMA into a 6-stage ring, the output
  stored by TMA.
- ``"mma"``: every other bf16 call, decode's ``block_t`` 16 among them.
  64-column tiles on ``mma.sync``.
- ``"simt"``: fp32, on the CUDA cores.

No route stands in for another: a launch the named route refuses raises.

Under autograd (grad enabled and x or w requiring it) ``grouped_gemm``
runs ``GroupedGemmFn``: its forward is the call above; its backward is
dX = grouped_gemm(dY, w^T, block_expert), the same kernel on the
expert-transposed weight (E, F, D) (transposed by a copy here: a layout
flag that reads w transposed is later work), and dW from
``kernels/moe_gemm_wgrad`` (``repro_grouped_gemm_wgrad``: each output
tile of an expert summed over the expert's blocks in one CTA, bf16 on its
own wgmma route).  On the CPU both are the plain versions.

The kernel is bound by bytes: at Qwen3-30B-A3B's 8 x 256 prefill it must
read 403 MB of expert weights, at decode ~157 MB of the touched experts'.

Counterparts of ``repro.kernels.moe_gemm``: ``grouped_gemm`` of
``grouped_gemm_tpu`` (same arguments), ``sort_tokens_by_expert`` of the
function of that name and ``moe_ffn`` of ``ops.moe_ffn``.  The dispatch
(``dispatch_plan``) runs on the device without a host sync: a stable sort
of the flat choices by expert, ``scatter_add_`` counts (``torch.bincount``
would sync to size its output), a cumulative sum of the block-padded
group sizes and a ``searchsorted`` for each block's expert.  One
difference from the reference: the unused trailing blocks of the static
(ceil(N / block_t) + E) * block_t rows get expert -1, which the kernel
skips, where the reference clamps them to expert E - 1 and multiplies
zero rows.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.moe_gemm_wgrad import ops as wgrad_ops

NAME = "moe_gemm"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTE_CODES = {"simt": 0, "mma": 1, "wgmma": 2}
_LIB = None

# launches by route since the last reset_routes()
ROUTE_LAUNCHES = {"wgmma": 0, "mma": 0, "simt": 0}


def route(dtype, block_t: int, D: int, F: int, aligned: bool) -> str:
    """The kernel's route for a call: "simt" for fp32; for bf16 "wgmma"
    when ``block_t`` is a multiple of 64, D and F are multiples of 8 (TMA
    strides of 16 bytes) and ``aligned`` (x and w start on 16-byte
    boundaries), else "mma"."""
    if dtype == torch.float32:
        return "simt"
    if dtype != torch.bfloat16:
        raise TypeError(f"{NAME}: no route for {dtype}")
    if block_t % 64 == 0 and D % 8 == 0 and F % 8 == 0 and aligned:
        return "wgmma"
    return "mma"


def reset_routes() -> None:
    for key in ROUTE_LAUNCHES:
        ROUTE_LAUNCHES[key] = 0


# ---------------------------------------------------------------------------
# the kernel and its plain version
# ---------------------------------------------------------------------------


def grouped_gemm_plain(x, w, block_expert, *, block_t: int = 128):
    """Per used block, an fp32 matmul of its rows with its expert's weight
    (gathered as ``w[block_expert]``); blocks whose expert is outside
    [0, E) give zero rows."""
    T, D = x.shape
    E, _, Fo = w.shape
    nb = T // block_t
    be = block_expert.long()
    used = torch.nonzero((be >= 0) & (be < E)).squeeze(1)
    out = torch.zeros((nb, block_t, Fo), dtype=x.dtype, device=x.device)
    xb = x.reshape(nb, block_t, D)[used].float()
    out[used] = torch.bmm(xb, w[be[used]].float()).to(x.dtype)
    return out.reshape(T, Fo)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry point ``repro_grouped_gemm`` of a loaded
    library."""
    fn = lib.repro_grouped_gemm
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        _LIB = bind(build.load(NAME))
    return _LIB


def _check(x, w, block_expert, block_t):
    dev = x.device
    for name, t in (("x", x), ("w", w), ("block_expert", block_expert)):
        if t.device != dev:
            raise ValueError(f"{NAME}: {name} on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be contiguous")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"{NAME}: x and w must share one of float32/"
                        f"bfloat16, got {x.dtype}/{w.dtype}")
    if block_expert.dtype != torch.int32:
        raise TypeError(f"{NAME}: block_expert must be int32")
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"{NAME}: x (T,D), w (E,D,F); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    T = x.shape[0]
    if block_t <= 0 or block_t % 16 or T % block_t:
        raise ValueError(f"{NAME}: block_t {block_t} must be a multiple of "
                         f"16 that divides T={T}")
    if block_expert.shape != (T // block_t,):
        raise ValueError(f"{NAME}: block_expert {tuple(block_expert.shape)} "
                         f"!= ({T // block_t},)")


def grouped_gemm(x, w, block_expert, *, block_t: int = 128):
    """x (T, D) rows sorted by expert, padded per expert to ``block_t``;
    w (E, D, F); block_expert (T / block_t,) int32 expert of each block
    (-1: unused, zero rows) -> (T, F) in x's dtype, fp32 accumulation.
    Differentiable in x and w (``GroupedGemmFn``)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return GroupedGemmFn.apply(x, w, block_expert, block_t)
    return _grouped_gemm(x, w, block_expert, block_t)


def _grouped_gemm(x, w, block_expert, block_t: int):
    """The kernel on CUDA tensors, the plain version on CPU ones; outside
    autograd."""
    if x.device.type == "cpu":
        return grouped_gemm_plain(x, w, block_expert, block_t=block_t)
    if x.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {x.device}")
    _check(x, w, block_expert, block_t)
    r = route(x.dtype, block_t, x.shape[1], w.shape[2],
              x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    out = launch(_lib(), x, w, block_expert, block_t, r)
    kernels.LAUNCHES[NAME] += 1
    ROUTE_LAUNCHES[r] += 1
    return out


class GroupedGemmFn(torch.autograd.Function):
    """``grouped_gemm`` under autograd, saving x and w.  Backward: dX =
    grouped_gemm(dY, w^T) (the kernel on CUDA, the plain version on the
    CPU) and dW = ``grouped_gemm_wgrad`` (E, D, F) in w's dtype; unused
    blocks' rows get zero dX and add nothing to dW."""

    @staticmethod
    def forward(ctx, x, w, block_expert, block_t):
        ctx.save_for_backward(x, w, block_expert)
        ctx.block_t = block_t
        return _grouped_gemm(x, w, block_expert, block_t)

    @staticmethod
    def backward(ctx, dy):
        x, w, be = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _grouped_gemm(dy, w.transpose(1, 2).contiguous(), be,
                               ctx.block_t)
        if ctx.needs_input_grad[1]:
            dw = wgrad_ops.grouped_gemm_wgrad(x, dy, be, w.shape[0],
                                              block_t=ctx.block_t)
        return dx, dw, None, None


def launch(lib, x, w, block_expert, block_t: int, route_name: str):
    """One launch of ``repro_grouped_gemm`` from ``lib`` (see ``bind``) on
    checked CUDA tensors, on route ``route_name``; raises if the launch
    failed.  Counts nothing."""
    T, D = x.shape
    E, _, Fo = w.shape
    out = torch.empty((T, Fo), dtype=x.dtype, device=x.device)
    vec = 16 // x.element_size()          # elements of one 16-byte load
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_grouped_gemm(
            x.data_ptr(), w.data_ptr(), block_expert.data_ptr(),
            out.data_ptr(), T, D, Fo, E, block_t,
            int(x.data_ptr() % 16 == 0 and D % vec == 0),
            int(w.data_ptr() % 16 == 0 and Fo % vec == 0),
            _DTYPES[x.dtype], _ROUTE_CODES[route_name], stream)
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed on the "
                           f"{route_name} route: CUDA error {err}")
    return out


# ---------------------------------------------------------------------------
# dispatch: sort the choices by expert, pad each group to block_t
# ---------------------------------------------------------------------------


class DispatchPlan(NamedTuple):
    """Where each flat choice goes in the expert-sorted row buffer.

    ``dest`` (N,) int64: its row among the ``rows`` sorted rows, or
    ``rows`` for a dropped choice; ``keep`` (N,) bool;
    ``block_expert`` (rows / block_t,) int32, -1 for unused blocks;
    ``order`` (N,): the stable sort of the choices by expert."""
    dest: torch.Tensor
    keep: torch.Tensor
    block_expert: torch.Tensor
    order: torch.Tensor
    rows: int
    block_t: int


def dispatch_plan(expert_ids, num_experts: int, block_t: int,
                  capacity=None) -> DispatchPlan:
    """Plan the grouped GEMM's rows for flat choices ``expert_ids`` (N,) in
    [0, E].  With ``capacity`` C a choice whose rank among its expert's
    choices (in flat order) is >= C is dropped, as in
    ``repro.models.moe._moe_local``: the stable sort puts each expert's
    choices in flat order, so a choice's rank is its position in its
    group and the kept ones are each group's first C.  ``capacity`` may
    be an int or an (E,) tensor, one C an expert (the slots that earlier
    ranks' choices left it, ``models/moe.py::_moe_shard_body``).  A
    choice of id E (an expert another rank holds) is dropped and takes no
    rank in any group."""
    ids = expert_ids.reshape(-1).long()
    N, E, dev = ids.numel(), num_experts, ids.device
    order = torch.argsort(ids, stable=True)
    sid = ids[order]
    counts = torch.zeros((E + 1,), dtype=torch.long, device=dev) \
        .scatter_add_(0, ids, torch.ones_like(ids))
    grp_start = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(N, device=dev) - grp_start[sid]
    counts = counts[:E]
    sidc = sid.clamp(max=E - 1)
    if isinstance(capacity, torch.Tensor):
        kept = torch.minimum(counts, capacity)
        capacity = capacity[sidc]
    else:
        kept = counts if capacity is None else counts.clamp(max=capacity)
    padded = (kept + block_t - 1) // block_t * block_t
    cum = torch.cumsum(padded, 0)
    rows = (-(-N // block_t) + E) * block_t        # static, as the reference
    keep_sorted = sid < E
    if capacity is not None:
        keep_sorted &= rank_sorted < capacity
    dest_sorted = torch.where(keep_sorted, cum[sidc] - padded[sidc]
                              + rank_sorted, rows)
    dest = torch.empty_like(dest_sorted).scatter_(0, order, dest_sorted)
    starts = torch.arange(rows // block_t, device=dev) * block_t
    be = torch.searchsorted(cum, starts, right=True)
    be = torch.where(be < E, be, -1).to(torch.int32)
    return DispatchPlan(dest, dest < rows, be, order, rows, block_t)


def combine_index(plan: DispatchPlan):
    """(N,) int64: each choice's row of the sorted buffer to gather its
    expert output from: ``dest`` for a kept choice, and for a dropped one a
    row no kept choice holds (padding or an unused block, so its output is
    zeros), a different one for each.  The buffer's ``rows`` >= N + E x
    block_t leave at least as many such rows as there are drops.  Distinct
    rows keep the gather's backward (an accumulating scatter) from
    serializing on one row: with ``dest``'s shared drop row it took 466.7 ms
    of a 1045.5 ms training step at Qwen3-30B-A3B's widths on an H100
    (PERF.md)."""
    taken = torch.zeros((plan.rows + 1,), dtype=torch.int32,
                        device=plan.dest.device)
    taken[plan.dest] = 1                     # drops mark the extra row
    free = torch.argsort(taken[:plan.rows], stable=True)   # free rows first
    drop_rank = torch.cumsum((~plan.keep).long(), 0) - 1
    return torch.where(plan.keep, plan.dest, free[drop_rank.clamp(min=0)])


def pick_block_t(n_choices: int, num_experts: int) -> int:
    """Rows per block: the power of two at or above the mean group size,
    within [16, 128].  A decode step (64 choices over 128 experts) takes
    16, so ~50 touched experts pad to 16 rows each instead of 128; the
    unsorted result does not depend on it."""
    mean = max(-(-n_choices // max(num_experts, 1)), 1)
    return min(max(1 << (mean - 1).bit_length(), 16), 128)


def gather_rows(xt, plan: DispatchPlan, token_of):
    """The (rows, D) sorted buffer: row ``dest[i]`` holds ``xt[token_of[i]]``
    for each kept choice i, zeros elsewhere."""
    xs = xt.new_zeros((plan.rows + 1, xt.shape[1]))   # + a row for drops
    xs[plan.dest] = xt[token_of]
    return xs[:plan.rows]


def grouped_ffn(xs, plan: DispatchPlan, w1, w3, w2, act=F.silu):
    """The gated expert MLP on the sorted rows: three grouped GEMMs, with
    ``act(g) * u`` between them."""
    be, bt = plan.block_expert, plan.block_t
    g = grouped_gemm(xs, w1, be, block_t=bt)
    u = grouped_gemm(xs, w3, be, block_t=bt)
    return grouped_gemm(act(g) * u, w2, be, block_t=bt)


def sort_tokens_by_expert(xt, expert_ids, num_experts: int, *,
                          block_t: int = 128):
    """Sort token rows by expert, pad each expert's group to a block
    multiple.  Returns (x_sorted (Tp, D), block_expert (Tp/block_t,),
    slot_of (T,), order (T,), valid (Tp,) bool), as the reference does
    (``slot_of`` maps each original row to its sorted row)."""
    plan = dispatch_plan(expert_ids, num_experts, block_t)
    tok = torch.arange(xt.shape[0], device=xt.device)
    valid = torch.zeros((plan.rows,), dtype=torch.bool, device=xt.device)
    valid[plan.dest] = True
    return (gather_rows(xt, plan, tok), plan.block_expert, plan.dest,
            plan.order, valid)


def moe_ffn(xt, expert_ids, vals, w1, w3, w2, *, num_experts: int,
            block_t: int = 128):
    """Routed SwiGLU FFN over every choice (no capacity drops): xt (T, D);
    expert_ids / vals (T, k); w1 / w3 (E, D, F); w2 (E, F, D) -> (T, D)."""
    T, k = expert_ids.shape
    plan = dispatch_plan(expert_ids, num_experts, block_t)
    tok = torch.arange(T, device=xt.device).repeat_interleave(k)
    y = grouped_ffn(gather_rows(xt, plan, tok), plan, w1, w3, w2,
                    act=lambda g: F.silu(g.float()).to(xt.dtype))
    y_tok = y[plan.dest] * vals.reshape(-1, 1).to(y.dtype)
    return y_tok.reshape(T, k, -1).sum(1)
