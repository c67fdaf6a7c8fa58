"""The grouped expert GEMM's routes and the tile walk of its wgmma route,
on the CPU.

``ops.route`` names the kernel's route from the call's dtype, block_t,
widths and alignment; ``ops.pick_block_t`` sets block_t at the serving
shapes.  The wgmma route's tile walk (``csrc/moe_gemm.cu``, namespace
``tc``) is modelled in numpy: the grid's tile order (the kernel's own
mapping of a CTA to its tile, read from the source: row-major, a row
tile's column tiles together), BM x BN output tiles summed over
BK-deep k-tiles whose elements past D or F arrive as zeros (TMA's fill),
a second 64-column box of w left unloaded (stale) when it lies wholly
past F, and zero rows for a block whose expert is outside [0, E).  The
model's constants are read from the kernel's source.  It is held to the
JAX package's ``grouped_gemm_tpu`` in interpret mode, as the JAX tests run
it, in fp32 to 1e-5 (summation order), and every output tile must be
written exactly once.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gemm.moe_gemm import grouped_gemm_tpu
from repro_torch.kernels.moe_gemm import ops

CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
      / "moe_gemm.cu")
TOL = dict(atol=1e-5, rtol=1e-5)


def _tc_source():
    """The wgmma route's part of the kernel source (namespace ``tc``)."""
    src = CU.read_text()
    return src[src.index("namespace tc {"):src.index("}  // namespace tc")]


TC_SRC = _tc_source()
TC = {k: int(v) for k, v in re.findall(
    r"constexpr int (BN|BK|STAGES) = (\d+);", TC_SRC)}


# ---------------------------------------------------------------- routes
FP32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("dtype,block_t,D,F,aligned,want", [
    pytest.param(FP32, 128, 2048, 768, True, "simt", id="fp32_prefill"),
    pytest.param(FP32, 16, 72, 100, False, "simt", id="fp32_ragged"),
    pytest.param(BF16, 16, 2048, 768, True, "mma", id="bt16_decode"),
    pytest.param(BF16, 32, 2048, 768, True, "mma", id="bt32"),
    pytest.param(BF16, 64, 2048, 768, True, "wgmma", id="bt64"),
    pytest.param(BF16, 128, 2048, 768, True, "wgmma", id="bt128_w1"),
    pytest.param(BF16, 128, 768, 2048, True, "wgmma", id="bt128_w2"),
    pytest.param(BF16, 96, 2048, 768, True, "mma", id="bt96"),
    pytest.param(BF16, 192, 2048, 768, True, "wgmma", id="bt192"),
    pytest.param(BF16, 64, 72, 96, True, "wgmma", id="d72_past_bk"),
    pytest.param(BF16, 128, 2048, 100, True, "mma", id="f100_ragged"),
    pytest.param(BF16, 128, 36, 768, True, "mma", id="d36_ragged"),
    pytest.param(BF16, 128, 2048, 768, False, "mma", id="unaligned"),
])
def test_route(dtype, block_t, D, F, aligned, want):
    """fp32 takes simt; bf16 takes wgmma only with block_t a multiple of
    64, D and F multiples of 8 and aligned bases, else mma."""
    assert ops.route(dtype, block_t, D, F, aligned) == want


def test_route_refuses_other_types():
    with pytest.raises(TypeError):
        ops.route(torch.float16, 128, 2048, 768, True)


@pytest.mark.parametrize("tokens,experts,top_k,want_bt,want_route", [
    (2048, 128, 8, 128, "wgmma"),   # Qwen3-30B-A3B 8 x 256 prefill
    (8, 128, 8, 16, "mma"),         # its decode step of 8 slots
    (4, 128, 8, 16, "mma"),         # a b_attn 4 sub-batch's step
    (808, 128, 8, 64, "wgmma"),     # 808 prompt tokens unpadded
])
def test_pick_block_t_at_serving_shapes(tokens, experts, top_k, want_bt,
                                        want_route):
    bt = ops.pick_block_t(tokens * top_k, experts)
    assert bt == want_bt
    assert ops.route(torch.bfloat16, bt, 2048, 768, True) == want_route


# ------------------------------------------------------- the tile walk
def _cta_tile():
    """The kernel's column-tile count and each CTA's first row and column,
    as the expressions its source computes them, in Python."""
    ntn = re.search(r"const int ntn = ([^;]+);", TC_SRC).group(1)
    row0, n0 = re.search(r"const int row0 = ([^,;]+), n0 = ([^;]+);",
                         TC_SRC).groups()

    def py(expr):       # C int arithmetic on non-negative values
        return compile(expr.replace("blockIdx.x", "cta").replace("/", "//"),
                       "moe_gemm.cu", "eval")
    return py(ntn), py(row0), py(n0)


NTN, ROW0, N0 = _cta_tile()


def launch_order(T, F, BM):
    """(CTA index, row tile, column tile) of every CTA of the grid of
    T / BM row tiles, in launch order, by the kernel's own mapping."""
    BN = TC["BN"]
    ntn = eval(NTN, dict(F=F, BN=BN))
    for cta in range(T // BM * ntn):
        env = dict(cta=cta, ntn=ntn, BM=BM, BN=BN)
        yield cta, eval(ROW0, env) // BM, eval(N0, env) // BN


def wgmma_walk(x, w, block_expert, block_t):
    """The wgmma route on x (T, D), w (E, D, F) in fp32: one CTA per tile
    in launch order.  Returns the output and each tile's write count; an
    element no tile writes stays NaN."""
    BN, BK = TC["BN"], TC["BK"]
    T, D = x.shape
    E, _, F = w.shape
    BM = 128 if block_t % 128 == 0 else 64
    ntm, ntn = T // BM, -(-F // BN)
    out = np.full((T, F), np.nan, np.float32)
    writes = np.zeros((ntm, ntn), np.int64)
    for _, rm, cn in launch_order(T, F, BM):
        row0, n0 = rm * BM, cn * BN
        rows, cols = slice(row0, row0 + BM), slice(n0, min(n0 + BN, F))
        writes[rm, cn] += 1
        e = int(block_expert[row0 // block_t])
        if not 0 <= e < E:                  # unused: zeros, no weight read
            out[rows, cols] = 0.0
            continue
        acc = np.zeros((BM, BN), np.float32)
        for k0 in range(0, D, BK):
            kv = min(BK, D - k0)
            a = np.zeros((BM, BK), np.float32)     # TMA fills with zeros
            a[:, :kv] = x[rows, k0:k0 + kv]
            b = np.zeros((BK, BN), np.float32)
            nv = min(BN, F - n0)
            b[:kv, :nv] = w[e, k0:k0 + kv, n0:n0 + nv]
            if n0 + 64 >= F:                # box 1 not loaded: stale
                b[:, 64:] = np.nan
            acc += a @ b
        out[rows, cols] = acc[:, :cols.stop - n0]
    return out, writes


def _case(seed, T, D, F, E, block_t, experts):
    """x with the dispatch's zero rows in unused blocks, w, and the block
    expert map (-1 after ``experts``)."""
    r = np.random.default_rng(seed)
    nb = T // block_t
    be = np.full((nb,), -1, np.int32)
    be[:len(experts)] = experts
    x = r.standard_normal((T, D)).astype(np.float32)
    x[len(experts) * block_t:] = 0.0
    w = (0.1 * r.standard_normal((E, D, F))).astype(np.float32)
    return x, w, be


# (name, T, D, F, E, block_t, experts of the used blocks): expert 3 has no
# block in any, expert 1 three consecutive ones in most
WALK_CASES = [
    ("bt64", 64 * 9, 192, 256, 8, 64, [0, 1, 1, 1, 2, 5, 7]),
    ("bt128", 128 * 6, 192, 256, 8, 128, [1, 1, 1, 4, 6]),
    ("bt64_ragged_d72_f200", 64 * 5, 72, 200, 8, 64, [1, 1, 1, 0]),
    ("bt128_f64", 128 * 4, 192, 64, 8, 128, [2, 1, 1, 1]),
    ("bt256_many_k_tiles", 256 * 3, 640, 136, 8, 256, [1, 5]),
]


@pytest.mark.parametrize("case", WALK_CASES, ids=[c[0] for c in WALK_CASES])
def test_tile_walk_matches_tpu_kernel(case):
    _, T, D, F, E, bt, experts = case
    x, w, be = _case(len(experts) + D, T, D, F, E, bt, experts)
    got, writes = wgmma_walk(x, w, be, bt)
    assert (writes == 1).all()              # every tile exactly once
    assert np.isfinite(got).all()           # every element written
    assert not got[len(experts) * bt:].any()
    # the reference clamps an unused block's expert into [0, E) and
    # multiplies its zero rows
    want = grouped_gemm_tpu(jnp.asarray(x), jnp.asarray(w),
                            jnp.asarray(np.where(be < 0, E - 1, be)),
                            block_t=bt, block_f=F, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    plain = ops.grouped_gemm(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(be), block_t=bt)
    np.testing.assert_allclose(got, plain.numpy(), **TOL)


@pytest.mark.parametrize("ntm,F", [(256, 768), (256, 2048), (5, 200)])
def test_tile_order_runs_a_row_blocks_column_tiles_together(ntm, F):
    """The kernel's grid is one CTA per tile, each tile exactly once; the
    column tiles of a row tile are launched together, and consecutive row
    tiles (an expert's blocks, sorted together by the dispatch) one after
    the other."""
    ntn = -(-F // TC["BN"])
    seen = {}
    for cta, rm, cn in launch_order(ntm * 128, F, 128):
        seen.setdefault((rm, cn), []).append(cta)
    assert sorted(seen) == [(m, n) for m in range(ntm) for n in range(ntn)]
    assert all(len(ctas) == 1 for ctas in seen.values())
    for m in range(ntm):
        launched = sorted(seen[(m, n)][0] for n in range(ntn))
        assert launched == list(range(m * ntn, (m + 1) * ntn))


def test_ring_is_deeper_than_one_tile_and_tiles_fit_shared_memory():
    """The ring keeps loads in flight beside the tile computed, and its
    stages and the output tile at BM = 128 fit an H100 block's 227 KB of
    shared memory."""
    BN, BK, stages = TC["BN"], TC["BK"], TC["STAGES"]
    assert stages >= 4 and BK * 2 == 128       # 128-byte swizzled rows
    assert BN % 64 == 0                        # whole 64-column boxes
    stage = 128 * BK * 2 + BK * BN * 2         # x tile, then w's boxes
    out = 128 * BN * 2                         # the bf16 output tile
    assert 1024 + stages * stage + out + 16 * stages <= 232448
