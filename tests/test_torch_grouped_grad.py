"""The grouped expert GEMM's backward in the port, on the CPU.

``kernels/moe_gemm/ops.py::GroupedGemmFn`` (what ``grouped_gemm`` runs
under autograd) against autograd of ``grouped_gemm_plain``, and
``kernels/moe_gemm_wgrad/ops.py::grouped_gemm_wgrad_plain`` against a JAX
einsum over the padded (E, C, D) capacity buffer the reference's MoE
contracts; the weight gradient's ``route()``, and a numpy model of its
wgmma route's walk (``csrc/moe_gemm_wgrad.cu``: the tiles each CTA takes,
the rows each k-tile loads, the ring's stage releases) against the plain
version.  fp32 inputs from ``np.random.default_rng(seed)``.  Tolerances:
atol 1e-5, rtol 1e-4 (fp32 sums in another order).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.moe_gemm import ops
from repro_torch.kernels.moe_gemm_wgrad import ops as wops

TOL = dict(atol=1e-5, rtol=1e-4)


def _layout(rng, experts, block_t, D, F, E):
    """Blocks of ``block_t`` rows for the expert list ``experts`` (-1: an
    unused block), x (T, D) random in every row (unused ones included), w
    (E, D, F), block_expert int32."""
    be = np.asarray(experts, np.int32)
    T = len(be) * block_t
    x = rng.standard_normal((T, D)).astype(np.float32)
    w = (rng.standard_normal((E, D, F)) * 0.3).astype(np.float32)
    return x, w, be


# (experts of the blocks in order, E): unused trailing blocks, experts 1
# and 4 without a block, an expert with three consecutive blocks, and a
# layout whose blocks of one expert are not contiguous
LAYOUTS = {
    "sorted, unused tail, empty experts": ([0, 0, 2, 3, 3, 3, 5, -1, -1], 6),
    "one expert": ([1, 1], 3),
    "interleaved": ([2, 0, 2, -1, 0, 1], 3),
}


@pytest.mark.parametrize("block_t", [16, 64, 128])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_grouped_gemm_fn_grads_match_autograd_of_the_plain_version(
        layout, block_t):
    experts, E = LAYOUTS[layout]
    rng = np.random.default_rng(block_t + len(experts))
    x, w, be = _layout(rng, experts, block_t, 24, 40, E)
    g = rng.standard_normal((x.shape[0], 40)).astype(np.float32)
    tbe = torch.from_numpy(be)

    def grads(fn):
        tx = torch.tensor(x, requires_grad=True)
        tw = torch.tensor(w, requires_grad=True)
        y = fn(tx, tw, tbe, block_t=block_t)
        y.backward(torch.from_numpy(g))
        return y.detach(), tx.grad, tw.grad

    kernels.reset_launches()
    y, dx, dw = grads(ops.grouped_gemm)
    y0, dx0, dw0 = grads(ops.grouped_gemm_plain)
    assert kernels.launches() == {n: 0 for n in kernels.KERNELS}
    assert torch.equal(y, y0)
    torch.testing.assert_close(dx, dx0, **TOL)
    torch.testing.assert_close(dw, dw0, **TOL)
    unused = torch.from_numpy(np.repeat(be < 0, block_t))
    assert not dx[unused].any()             # unused rows: exact zeros
    for e in set(range(E)) - set(experts):
        assert not dw[e].any()              # an expert with no block
    # the node is GroupedGemmFn's, whatever needs grad
    tx = torch.tensor(x, requires_grad=True)
    out = ops.grouped_gemm(tx, torch.from_numpy(w), tbe, block_t=block_t)
    assert type(out.grad_fn).__name__.startswith("GroupedGemmFn")
    out.backward(torch.from_numpy(g))
    torch.testing.assert_close(tx.grad, dx0, **TOL)


@pytest.mark.parametrize("block_t", [16, 64])
def test_grouped_gemm_runs_no_node_without_grad(block_t):
    rng = np.random.default_rng(3)
    x, w, be = _layout(rng, [0, 1, -1], block_t, 8, 12, 2)
    tx = torch.tensor(x, requires_grad=True)
    with torch.no_grad():
        y = ops.grouped_gemm(tx, torch.from_numpy(w), torch.from_numpy(be),
                             block_t=block_t)
    assert y.grad_fn is None
    y = ops.grouped_gemm(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(be), block_t=block_t)
    assert y.grad_fn is None


def _capacity_buffer(x, be, block_t, E):
    """The (E, C, D) buffer of the reference's MoE: expert e's rows, in
    block order, then zeros up to C (the most rows an expert has)."""
    rows = {e: [] for e in range(E)}
    for b, e in enumerate(be):
        if 0 <= e < E:
            rows[e].append(x[b * block_t:(b + 1) * block_t])
    C = max([sum(len(r) for r in v) for v in rows.values()] + [1])
    buf = np.zeros((E, C, x.shape[1]), np.float32)
    for e, parts in rows.items():
        if parts:
            cat = np.concatenate(parts)
            buf[e, :len(cat)] = cat
    return buf


@pytest.mark.parametrize("block_t", [16, 64, 128])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_wgrad_plain_matches_an_einsum_over_the_capacity_buffer(layout,
                                                               block_t):
    experts, E = LAYOUTS[layout]
    rng = np.random.default_rng(7 * block_t + len(experts))
    be = np.asarray(experts, np.int32)
    T = len(be) * block_t
    x = rng.standard_normal((T, 20)).astype(np.float32)
    dy = rng.standard_normal((T, 36)).astype(np.float32)
    want = jnp.einsum("ecd,ecf->edf",
                      jnp.asarray(_capacity_buffer(x, be, block_t, E)),
                      jnp.asarray(_capacity_buffer(dy, be, block_t, E)))
    kernels.reset_launches()
    got = wops.grouped_gemm_wgrad(torch.from_numpy(x), torch.from_numpy(dy),
                                  torch.from_numpy(be), E, block_t=block_t)
    plain = wops.grouped_gemm_wgrad_plain(
        torch.from_numpy(x), torch.from_numpy(dy), torch.from_numpy(be), E,
        block_t=block_t)
    assert kernels.launches()["moe_gemm_wgrad"] == 0
    assert torch.equal(got, plain)          # the CPU wrapper is the plain
    assert got.shape == (E, 20, 36) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wgrad_plain_keeps_the_dtype_and_sums_in_fp32():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    be = torch.tensor([0, 0, 1, -1], dtype=torch.int32)
    got = wops.grouped_gemm_wgrad_plain(x.bfloat16(), dy.bfloat16(), be, 2,
                                        block_t=16)
    assert got.dtype == torch.bfloat16
    want = wops.grouped_gemm_wgrad_plain(x.bfloat16().float(),
                                         dy.bfloat16().float(), be, 2,
                                         block_t=16)
    assert torch.equal(got, want.bfloat16())


@pytest.mark.parametrize("experts,E", [([0, 0, 2, -1, -1], 4),
                                       ([2, 0, 2, 1, -1, 0], 3),
                                       ([-1, -1], 2)])
def test_block_order_lists_each_experts_blocks_in_order(experts, E):
    """The kernel's walk: expert e's blocks are order[start[e]:start[e+1]],
    in block order; unused blocks belong to none."""
    order, start = wops.block_order(torch.tensor(experts, dtype=torch.int32),
                                    E)
    assert order.dtype == start.dtype == torch.int32
    assert start.shape == (E + 1,)
    for e in range(E):
        got = order[start[e]:start[e + 1]].tolist()
        assert got == [b for b, x in enumerate(experts) if x == e]
    assert int(start[0]) == sum(x < 0 for x in experts)
    assert int(start[E]) == len(experts)


def test_wgrad_wrapper_checks_its_inputs():
    x = torch.zeros((32, 8))
    dy = torch.zeros((32, 4))
    be = torch.zeros((2,), dtype=torch.int32)
    wops._check(x, dy, be, 2, 16)
    with pytest.raises(TypeError, match="int32"):
        wops._check(x, dy, be.long(), 2, 16)
    with pytest.raises(TypeError, match="share"):
        wops._check(x, dy.bfloat16(), be, 2, 16)
    with pytest.raises(ValueError, match="block_t"):
        wops._check(x, dy, be, 2, 24)
    with pytest.raises(ValueError, match="block_expert"):
        wops._check(x, dy, be[:1], 2, 16)
    with pytest.raises(ValueError, match="contiguous"):
        wops._check(x.t().contiguous().t(), dy, be, 2, 16)
    with pytest.raises(ValueError, match="device"):
        wops.grouped_gemm_wgrad(x.to("meta"), dy.to("meta"), be.to("meta"),
                                2, block_t=16)


@pytest.mark.parametrize("capacity", [None, 8, 24])
@pytest.mark.parametrize("block_t", [16, 64])
def test_combine_index_gives_each_drop_its_own_free_row(capacity, block_t):
    """The combine's gather rows: a kept choice's ``dest``, and for each
    dropped one a distinct row that no kept choice holds (so its expert
    output is zeros); all N rows distinct and inside the buffer."""
    rng = np.random.default_rng(block_t + (capacity or 0))
    E, N = 6, 96
    ids = torch.from_numpy(rng.choice(E, N, p=[0.5, 0.2, 0.1, 0.1, 0.1, 0.0])
                           .astype(np.int64))
    plan = ops.dispatch_plan(ids, E, block_t, capacity=capacity)
    idx = ops.combine_index(plan)
    keep = plan.keep
    assert (not keep.all()) == (capacity is not None)
    assert torch.equal(idx[keep], plan.dest[keep])
    assert len(set(idx.tolist())) == N and int(idx.max()) < plan.rows
    assert not set(idx[~keep].tolist()) & set(plan.dest[keep].tolist())
    # those rows come out of the grouped GEMM as zeros
    x = torch.from_numpy(rng.standard_normal((N, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((E, 8, 5)).astype(np.float32))
    y = ops.grouped_gemm(ops.gather_rows(x, plan, torch.arange(N)), w,
                         plan.block_expert, block_t=block_t)
    assert not y[idx[~keep]].any()


@pytest.mark.parametrize("dtype,bt,M,N,aligned,want", [
    (torch.bfloat16, 128, 2048, 768, True, "wgmma"),    # Qwen3's w1 dW
    (torch.bfloat16, 128, 768, 2048, True, "wgmma"),    # and its w2 dW
    (torch.bfloat16, 64, 200, 136, True, "wgmma"),
    (torch.bfloat16, 192, 72, 264, True, "wgmma"),
    (torch.bfloat16, 16, 2048, 768, True, "mma"),       # decode's block_t
    (torch.bfloat16, 32, 256, 256, True, "mma"),
    (torch.bfloat16, 96, 256, 256, True, "mma"),
    (torch.bfloat16, 128, 100, 768, True, "mma"),       # ragged M
    (torch.bfloat16, 128, 2048, 772, True, "mma"),      # ragged N
    (torch.bfloat16, 128, 2048, 768, False, "mma"),     # a base TMA refuses
    (torch.float32, 128, 2048, 768, True, "simt"),
    (torch.float32, 16, 72, 100, False, "simt"),
])
def test_wgrad_route_follows_type_block_and_widths(dtype, bt, M, N, aligned,
                                                   want):
    """The wrapper names the route without a card: bf16 at block_t a
    multiple of 64, M and N multiples of 8 and 16-byte-aligned bases on
    wgmma, other bf16 calls on mma, fp32 on simt; no other type."""
    assert wops.route(dtype, bt, M, N, aligned) == want
    with pytest.raises(TypeError, match="route"):
        wops.route(torch.float16, bt, M, N, aligned)


# The wgmma route's walk (csrc/moe_gemm_wgrad.cu), modelled in numpy from
# the constants of the source: one CTA an SM walks output tiles grid apart
# (N tiles fastest, then M, then experts); its producer loads the k-tiles
# of a tile's expert's blocks in ``order``, x and dy boxes wholly past M
# or N not loaded (zeros); its consumers release each k-tile's ring stage
# once; each tile is stored once, clipped at M and N.
_WGRAD_SRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
              / "csrc" / "moe_gemm_wgrad.cu").read_text()


def _wgrad_geo():
    """{BM, BN, BK, STAGES} of the wgmma route, from the source's ``tc``
    namespace."""
    tc = _WGRAD_SRC[_WGRAD_SRC.index("namespace tc {"):]
    geo = {}
    for name in ("BM", "BN", "BK", "STAGES"):
        m = re.search(rf"constexpr int {name} = (\d+);", tc)
        assert m, f"tc::{name} changed"
        geo[name] = int(m.group(1))
    return geo


def _wgrad_walk(x, dy, be, E, block_t, sms):
    """(dw, stores, blocks read, released k-tiles by CTA, loaded k-tiles by
    CTA) of the kernel's walk on ``sms`` SMs; dw's elements never stored
    stay NaN."""
    g = _wgrad_geo()
    BM, BN, BK = g["BM"], g["BN"], g["BK"]
    assert block_t % BK == 0            # a k-tile never straddles a block
    T, M = x.shape
    N = dy.shape[1]
    order, start = (t.numpy() for t in wops.block_order(torch.from_numpy(be),
                                                        E))
    ntn, ntm = -(-N // BN), -(-M // BM)
    tiles = ntn * ntm * E
    grid = min(tiles, sms)
    tpb = block_t // BK
    dw = np.full((E, M, N), np.nan, np.float64)
    stores = np.zeros((E, M, N), np.int64)
    read, released, loaded = set(), {}, {}
    for cta in range(grid):
        it, rel = 0, []
        for t in range(cta, tiles, grid):
            n0, m0, e = t % ntn * BN, t // ntn % ntm * BM, t // (ntn * ntm)
            first = start[e]
            nk = (start[e + 1] - first) * tpb
            xb = min(BM // 64, (M - m0 + 63) // 64)
            yb = min(BN // 64, (N - n0 + 63) // 64)
            acc = np.zeros((BM, BN))
            for kt in range(nk):
                blk = order[first + kt // tpb]
                assert be[blk] == e
                read.add(int(blk))
                row = blk * block_t + kt % tpb * BK
                xs, ys = np.zeros((BK, BM)), np.zeros((BK, BN))
                mx, ny = min(M, m0 + 64 * xb), min(N, n0 + 64 * yb)
                xs[:, :mx - m0] = x[row:row + BK, m0:mx]
                ys[:, :ny - n0] = dy[row:row + BK, n0:ny]
                acc += xs.T @ ys
                if kt > 0:
                    rel.append(it - 1)
                it += 1
            if nk > 0:
                rel.append(it - 1)
            mh, nh = min(M, m0 + BM) - m0, min(N, n0 + BN) - n0
            dw[e, m0:m0 + mh, n0:n0 + nh] = acc[:mh, :nh]
            stores[e, m0:m0 + mh, n0:n0 + nh] += 1
        released[cta], loaded[cta] = rel, it
    return dw, stores, read, released, loaded


def _wgrad_layouts():
    """name -> (experts of the blocks, block_t, M, N, E, SMs): random
    layouts with unused (-1) blocks anywhere, experts with no block and one
    expert's blocks apart, at block_t 64, 128 and 192, M and N multiples of
    8 (not all of 64), on 132 SMs (one tile a CTA) and on few (many)."""
    r = np.random.default_rng(27)
    out = {}
    for i, (bt, M, N, E, nb, sms) in enumerate([
            (64, 200, 136, 5, 9, 132), (128, 72, 264, 4, 6, 132),
            (64, 256, 512, 6, 10, 3), (192, 136, 72, 3, 5, 2),
            (128, 128, 256, 8, 7, 5), (64, 64, 520, 2, 4, 1)]):
        experts = r.integers(-1, E, nb).astype(np.int32)
        experts[r.integers(0, nb)] = -1
        out[f"bt{bt} M{M} N{N} E{E} sms{sms} #{i}"] = (experts, bt, M, N, E,
                                                       sms)
    return out


@pytest.mark.parametrize("case", list(_wgrad_layouts()))
def test_wgrad_walk_sums_to_the_plain_version(case):
    """The walk stores every element of dw once, reads only the blocks of
    each tile's expert (never an unused one), releases each CTA's k-tiles
    once and in order, and its sums equal the plain version's: an expert
    with no block gets zeros."""
    experts, bt, M, N, E, sms = _wgrad_layouts()[case]
    rng = np.random.default_rng(len(case))
    T = len(experts) * bt
    x = rng.standard_normal((T, M)).astype(np.float32)
    dy = rng.standard_normal((T, N)).astype(np.float32)
    dw, stores, read, released, loaded = _wgrad_walk(x, dy, experts, E, bt,
                                                     sms)
    assert (stores == 1).all()
    assert read == {b for b, e in enumerate(experts) if e >= 0}
    for cta, rel in released.items():
        assert rel == list(range(loaded[cta]))
    want = wops.grouped_gemm_wgrad_plain(torch.from_numpy(x),
                                         torch.from_numpy(dy),
                                         torch.from_numpy(experts), E,
                                         block_t=bt)
    np.testing.assert_allclose(dw, want.numpy(), **TOL)
    for e in set(range(E)) - set(experts.tolist()):
        assert not dw[e].any()
