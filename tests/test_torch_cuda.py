"""The port's CUDA kernels on the card, held to their plain PyTorch versions.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one; on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The first test builds the kernels from ``src/repro_torch/csrc`` with
``nvcc``.  Prefill attention has two routes: bf16 on the tensor cores
(``wgmma``, K/V by TMA) and fp32 on the CUDA cores; every flash case runs
in both types, and the bf16 route is also held to equal bits over two
launches, to its per-route launch count and to its refusal of a base
TMA cannot read.  Decode attention splits each (sequence, kv head) across
a cluster of 8 CTAs, bf16 products on ``mma.sync`` and fp32 on the CUDA
cores: it is held to its plain version on shuffled tables at edge lengths
(0 gives exact zeros) and at the four timed decode shapes, to equal bits
over two launches in both types, to its per-route launch count and to its
refusal of a pool ``cp.async`` cannot read.  Tolerances: fp32 atol/rtol 1e-4 (summation order), bf16
atol/rtol 2e-2 (one bf16 rounding of the output).  fp32 products run in
full fp32 (TF32 off), so the reduced engine's greedy tokens on the card
equal those of its plain CPU path.  The fused sampling kernel (each row
split across a cluster of 8 CTAs) gives its plain version's tokens and
top-K ids exactly, bitwise identical over two launches, at the serving
shapes, the batch-1 prefix tail, V 256000 (the largest slice), V 7 (ranks
left empty), 40 lanes (two rounds) and a maximum tied across a rank
boundary, and refuses a row past its limit; its stats hold to rtol 1e-5
(float summation order).  The
grouped GEMM holds to its plain version at the same fp32 / bf16
tolerances, with unused (-1) blocks (exact zeros), empty experts and
ragged D and F, on each of its routes (bf16 at block_t 64 and up on
``wgmma``, other bf16 calls on ``mma.sync``, fp32 on the CUDA cores), to
equal bits over two launches and to its per-route launch count.
The SSD state scan gives its plain version's bits (``torch.equal``: it
rounds the product and the sum separately, as ``h * d + s`` does); its
backward (``ssd_scan_bwd``) gives the plain backward's dstates bits and
ddecay to atol 1e-5 + 1e-7 x the sum of the products' magnitudes, rtol
1e-5 (a sum of N * P products in another order), with equal bits over two
launches, through ``SsdScanFn`` too, and reduced fp32 Mamba2-370M's
``forward_loss`` and gradients on the card equal the CPU's.  Flash
runs at the windowed decoders' head dims, (80, 80) and (256, 256), in
both types, windowed and softcapped with scores spread so that a window
edge off by a tile or a dropped cap fails (bf16 atol tied to the output's
scale, at most 2e-2), and at its key limit, which is the built kernel's
(``repro_flash_max_keys``); reduced fp32 H2O-Danube and RecurrentGemma
at those head dims give the CPU's tokens at model level.  Flash runs
non-causal at Whisper-base's encoder (B8 S1536, MHA of 64) and cross
shapes (Sq 32 on Skv 1536), paged attention at G = 1 (D 64) and at the
served Whisper and Pixtral-12B decode shapes; the checks must see a
causal encoder mask and a cross row one page short; reduced fp32
Whisper and Pixtral give the CPU's tokens at model level.  The flash
forward writes each row's log-sum-exp on both routes at every head-dim
pair (held to the plain forward's); the backward kernel holds to its plain
version on the same out and lse in both types (fp32 atol 1e-4 x the
largest |gradient| of dq, dk, dv, rtol 1e-4; bf16 2e-2 x the same, rtol
2e-2: one bf16 rounding of each gradient) at ragged tiles, S = 1, G = 1
and 3, non-causal at Sq != Skv and head dims 32, 64, 128 and 256 (10 q
heads on 1), and windowed, softcapped or both at head dims 64, 80, 128 and
256, and at MLA's q/k 192, v 128 (ragged tiles, S = 1, G = 1 and 2,
non-causal at Sq != Skv, an offset q block, more q tiles than ring
stages, a window with a softcap; under autograd through
``FlashAttentionFn``; ``max_len(192, 128)``), gives equal bits over two
launches, counts by route, and refuses D 160 and (64, 32);
reduced fp32 SmolLM-360M's, Qwen3-30B-A3B's and H2O-Danube-1.8B's
``forward_loss`` and every gradient on the card equal the CPU's (loss
rtol 1e-5, grads atol 1e-4, rtol 1e-3) with the launches remat implies.
The grouped GEMM's autograd node (``GroupedGemmFn``: dX by the forward
kernel on the transposed weight, dW by ``moe_gemm_wgrad``) holds to
autograd through the plain version in both types, and the weight
gradient gives equal bits over two launches.  The weight gradient's
wgmma route (bf16 at block_t 64 and up, M and N multiples of 8) holds to
its plain version (bf16 atol 2e-2 x the largest |dw|, rtol 2e-2) at
ragged widths, empty experts, unused blocks, blocks of one expert apart
and more k-tiles than its ring has stages, with equal bits; each launch
counts on the route ``route()`` names, and a launch on a route the call
cannot take raises.  The multi-GPU path's shapes: the flash forward and
backward at a rank's tp-8 head shard (4 q heads over 1 kv head, D 64 and
128) against their plain versions, one rank's grouped GEMM over its 16 of
Qwen3-30B-A3B's 128 experts (most choices another rank's) forward and
under autograd, and a real NCCL group of world size 1 through
``distributed/collectives.py`` (every collective sent, the conjugate
pairs' values and gradients passed through).
"""
import dataclasses
import math
from pathlib import Path

import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import reduced_config
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_plain)
from repro_torch.kernels.flash_attention_bwd import ops as fb_ops
from repro_torch.kernels.flash_attention_bwd.ops import (
    flash_attention_bwd, flash_attention_bwd_plain)
from repro_torch.kernels.fused_sampling import ops as fs_ops
from repro_torch.kernels.fused_sampling.ops import (fused_sample,
                                                    fused_sample_plain)
from repro_torch.kernels.moe_gemm import ops as moe_ops
from repro_torch.kernels.moe_gemm.ops import (grouped_gemm,
                                              grouped_gemm_plain, moe_ffn)
from repro_torch.kernels.moe_gemm_wgrad import ops as wgrad_ops
from repro_torch.kernels.moe_gemm_wgrad.ops import (
    grouped_gemm_wgrad, grouped_gemm_wgrad_plain)
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention.ops import (paged_attention,
                                                     paged_attention_plain)
from repro_torch.kernels.ssd_scan.ops import (SsdScanFn, ssd_state_scan,
                                              ssd_state_scan_plain)
from repro_torch.kernels.ssd_scan_bwd.ops import (ssd_state_scan_bwd,
                                                  ssd_state_scan_bwd_plain)
from repro_torch.launch.flash_ab import (LENGTHS, PAGED_SHAPES,
                                         catch_all_rows, paged_label,
                                         sampling_rows)
from repro_torch.launch.model_level import generate
from repro_torch.models import transformer as TT
from repro_torch.runtime.api import BatchMaster, BatchRequest
from repro_torch.runtime.engine import NodeEngine
from repro_torch.sampling import SamplingParams

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _pos(B, start, n, dev):
    return (torch.arange(n, dtype=torch.int32, device=dev) + start)[None] \
        .expand(B, n).contiguous()


def _close(got, want, dtype, tol=None):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == dtype
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(),
                               **(tol or TOL[dtype]))


# The windowed decoders' cases scale q so that q.k / sqrt(D) has a std of
# SPREAD: the softmax rests on a few keys, so a key moved across the
# window's edge moves an output by a whole v row, and a softcap of 30
# bites (at scores of std 1, tanh(s / 30) * 30 ~ s).  Their bf16 outputs
# are held to atol min(2e-2, 0.05 * rms(plain)), never looser than TOL.
SPREAD = 15.0


def _spread_tol(want, dtype):
    if dtype != torch.bfloat16:
        return TOL[dtype]
    rms = want.float().pow(2).mean().sqrt().item()
    return dict(TOL[dtype], atol=min(TOL[dtype]["atol"], 0.05 * rms))


# (name, B, Sq, Skv, H, Hkv, D, causal, window, softcap)
FLASH_CASES = [
    ("causal_gqa4", 2, 130, 130, 8, 2, 64, True, 0, 0.0),
    ("offset_q", 2, 40, 200, 8, 2, 64, True, 0, 0.0),
    ("window_softcap", 1, 150, 150, 4, 2, 64, True, 37, 20.0),
    ("noncausal_skv96", 1, 96, 96, 4, 2, 64, False, 0, 0.0),
    ("gqa3_d32", 1, 40, 40, 6, 2, 32, True, 0, 0.0),
    ("mha_d128", 1, 70, 70, 4, 4, 128, True, 0, 0.0),
    # more K/V tiles than ring stages, and a ragged last tile
    ("causal_s1000", 1, 1000, 1000, 4, 2, 64, True, 0, 0.0),
    ("offset_sq1", 2, 1, 300, 8, 2, 64, True, 0, 0.0),
    # Whisper-base's encoder self-attention over 1536 frames and its
    # cross-attention of 32 decoder positions on them, MHA of 64
    ("noncausal_enc_b8_s1536", 8, 1536, 1536, 8, 8, 64, False, 0, 0.0),
    ("cross_b8_sq32_skv1536", 8, 32, 1536, 8, 8, 64, False, 0, 0.0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_kernel_matches_plain(dev, case, dtype):
    _, B, Sq, Skv, H, Hkv, D, causal, window, softcap = case
    gen = torch.Generator(device=dev).manual_seed(0)
    q = _randn(gen, (B, Sq, H, D), dtype, dev)
    k = _randn(gen, (B, Skv, Hkv, D), dtype, dev)
    v = _randn(gen, (B, Skv, Hkv, D), dtype, dev)
    qp, kp = _pos(B, Skv - Sq, Sq, dev), _pos(B, 0, Skv, dev)
    kw = dict(causal=causal, window=window, softcap=softcap)
    _close(flash_attention(q, k, v, qp, kp, **kw),
           flash_attention_plain(q, k, v, qp, kp, **kw), dtype)


# (name, B, Sq, Skv, H, q0): MLA's prefill head dims, q/k 192 and v 128
MLA_FLASH_CASES = [("causal_s200", 2, 200, 200, 4, 0),
                   ("offset_q", 1, 40, 300, 8, 260)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", MLA_FLASH_CASES,
                         ids=[c[0] for c in MLA_FLASH_CASES])
def test_flash_kernel_takes_a_narrower_v(dev, case, dtype):
    """q/k heads of 192 against v heads of 128 (DeepSeek-R1's MLA
    prefill) on the route of the dtype, against the plain version: the
    output is (B, Sq, H, 128), scaled by 1/sqrt(192)."""
    _, B, Sq, Skv, H, q0 = case
    gen = torch.Generator(device=dev).manual_seed(12)
    q = _randn(gen, (B, Sq, H, 192), dtype, dev)
    k = _randn(gen, (B, Skv, H, 192), dtype, dev)
    v = _randn(gen, (B, Skv, H, 128), dtype, dev)
    qp, kp = _pos(B, q0, Sq, dev), _pos(B, 0, Skv, dev)
    fa_ops.reset_routes()
    got = flash_attention(q, k, v, qp, kp)
    assert got.shape == (B, Sq, H, 128)
    assert fa_ops.ROUTE_LAUNCHES[fa_ops.route(dtype)] == 1
    _close(got, flash_attention_plain(q, k, v, qp, kp), dtype)


# (name, B, Sq, Skv, H, Hkv, q0, window, softcap): the windowed decoders'
# head dims, 80 (H2O-Danube-1.8B: 32/8 heads, window 4096) and 256
# (RecurrentGemma-2B: 10/1 heads, window 2048, softcap 30), at narrower
# heads and windows that prompts here outrun (keys past the window on both
# sides of a 64-key tile), ragged tiles and an offset q block
WINDOW_FLASH_CASES = [
    ("causal_s200", 2, 200, 200, 8, 2, 0, 0, 0.0),
    ("window100_s700", 1, 700, 700, 8, 2, 0, 100, 0.0),
    ("window100_softcap30_s700", 1, 700, 700, 5, 1, 0, 100, 30.0),
    ("offset_q_window64_softcap30", 2, 40, 300, 5, 1, 260, 64, 30.0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("D", [80, 256])
@pytest.mark.parametrize("case", WINDOW_FLASH_CASES,
                         ids=[c[0] for c in WINDOW_FLASH_CASES])
def test_flash_kernel_at_head_dims_80_and_256(dev, case, D, dtype):
    """Head dims (80, 80) and (256, 256) on the route of the dtype against
    the plain version: bf16 pads a row of 80 to two 64-column boxes in
    shared memory only (the output holds exactly 80 columns a head) and
    runs 2 ring stages at 256; windowed, softcapped, GQA and MQA, with
    scores spread (``SPREAD``) so that the window's edge and the cap show."""
    _, B, Sq, Skv, H, Hkv, q0, window, softcap = case
    gen = torch.Generator(device=dev).manual_seed(14)
    q = (_randn(gen, (B, Sq, H, D), torch.float32, dev) * SPREAD).to(dtype)
    k = _randn(gen, (B, Skv, Hkv, D), dtype, dev)
    v = _randn(gen, (B, Skv, Hkv, D), dtype, dev)
    qp, kp = _pos(B, q0, Sq, dev), _pos(B, 0, Skv, dev)
    kw = dict(window=window, softcap=softcap)
    fa_ops.reset_routes()
    got = flash_attention(q, k, v, qp, kp, **kw)
    assert got.shape == (B, Sq, H, D)
    assert fa_ops.ROUTE_LAUNCHES[fa_ops.route(dtype)] == 1
    want = flash_attention_plain(q, k, v, qp, kp, **kw)
    _close(got, want, dtype, _spread_tol(want, dtype))


# the tensor-core route's key limit at each pair, from its shared memory:
# a 128-row Q tile, a ring of 64-key K + V stages (4; 2 at (256, 256)),
# barriers, positions and alignment, then 12 bytes a 64-key tile in 227 KiB
MAX_KEYS = {(32, 32): 1009600, (64, 64): 791104, (80, 80): 354240,
            (128, 128): 354240, (192, 128): 92096, (256, 256): 182336}


def test_flash_max_keys_of_every_pair(dev):
    """``ops.max_keys`` is the built kernel's limit (``Geo::max_keys``)
    for every instantiated pair, and 0 for a pair it does not take."""
    assert {p: fa_ops.max_keys(*p) for p in fa_ops.HEAD_DIMS} == MAX_KEYS
    assert fa_ops.max_keys(96) == 0


@pytest.mark.parametrize("D", [80, 256])
def test_flash_bf16_windowed_runs_at_its_key_limit(dev, D):
    """At (80, 80) (a row in two 64-column boxes) and (256, 256) (2 ring
    stages) the tensor-core route launches at ``max_keys(D)`` keys with one
    kv head for two q heads, windowed and softcapped, and matches its plain
    version; one key more raises before any launch."""
    n = fa_ops.max_keys(D)
    gen = torch.Generator(device=dev).manual_seed(15)
    q = _randn(gen, (1, 64, 2, D), torch.bfloat16, dev)
    k = _randn(gen, (1, n + 1, 1, D), torch.bfloat16, dev)
    v = _randn(gen, (1, n + 1, 1, D), torch.bfloat16, dev)
    qp, kp = _pos(1, n - 64, 64, dev), _pos(1, 0, n + 1, dev)
    kw = dict(window=2048, softcap=30.0)
    args = (q, k[:, :n], v[:, :n], qp, kp[:, :n].contiguous())
    _close(flash_attention(*args, **kw), flash_attention_plain(*args, **kw),
           torch.bfloat16)
    with pytest.raises(ValueError, match=f"at most {n} keys"):
        flash_attention(q, k, v, qp, kp, **kw)


def test_flash_bf16_mla_runs_at_its_key_limit(dev):
    """At (q/k 192, v 128) the tensor-core route launches at
    ``max_keys(192, 128)`` keys and matches its plain version; one key
    more raises before any launch."""
    n = fa_ops.max_keys(192, 128)
    gen = torch.Generator(device=dev).manual_seed(13)
    q = _randn(gen, (1, 64, 1, 192), torch.bfloat16, dev)
    k = _randn(gen, (1, n + 1, 1, 192), torch.bfloat16, dev)
    v = _randn(gen, (1, n + 1, 1, 128), torch.bfloat16, dev)
    qp, kp = _pos(1, n - 64, 64, dev), _pos(1, 0, n + 1, dev)
    args = (q, k[:, :n], v[:, :n], qp, kp[:, :n].contiguous())
    _close(flash_attention(*args), flash_attention_plain(*args),
           torch.bfloat16)
    with pytest.raises(ValueError, match=f"at most {n} keys"):
        flash_attention(q, k, v, qp, kp)


@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_kernel_rows_at_different_offsets(dev, D):
    """One batch whose rows hold q blocks at different offsets into their
    keys (a prefix hit's tail beside a fresh prompt), in bf16 on the
    tensor cores."""
    B, Sq, Skv, H, Hkv = 3, 70, 330, 8, 2
    gen = torch.Generator(device=dev).manual_seed(4)
    q = _randn(gen, (B, Sq, H, D), torch.bfloat16, dev)
    k = _randn(gen, (B, Skv, Hkv, D), torch.bfloat16, dev)
    v = _randn(gen, (B, Skv, Hkv, D), torch.bfloat16, dev)
    starts = torch.tensor([0, 130, Skv - Sq], dtype=torch.int32, device=dev)
    qp = (starts[:, None] + torch.arange(Sq, dtype=torch.int32,
                                         device=dev)).contiguous()
    kp = _pos(B, 0, Skv, dev)
    _close(flash_attention(q, k, v, qp, kp),
           flash_attention_plain(q, k, v, qp, kp), torch.bfloat16)


def test_flash_bf16_is_deterministic_and_routes_count(dev):
    """bf16 gives equal bits over two launches; bf16 launches count on the
    wgmma route and fp32 ones on the simt route, each in the kernel's
    total as well."""
    gen = torch.Generator(device=dev).manual_seed(5)
    q = _randn(gen, (2, 300, 8, 64), torch.bfloat16, dev)
    k = _randn(gen, (2, 300, 2, 64), torch.bfloat16, dev)
    pos = _pos(2, 0, 300, dev)
    kernels.reset_launches()
    fa_ops.reset_routes()
    a = flash_attention(q, k, k, pos, pos, window=100, softcap=30.0)
    b = flash_attention(q, k, k, pos, pos, window=100, softcap=30.0)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert fa_ops.ROUTE_LAUNCHES == {"wgmma": 2, "simt": 0}
    flash_attention(q.float(), k.float(), k.float(), pos, pos)
    assert fa_ops.ROUTE_LAUNCHES == {"wgmma": 2, "simt": 1}
    assert kernels.launches()["flash_attention"] == 3


def test_flash_bf16_rejects_a_misaligned_base(dev):
    """TMA needs a 16-byte-aligned base: a contiguous bf16 view that
    starts 2 bytes in raises and never falls back to the fp32 route."""
    gen = torch.Generator(device=dev).manual_seed(6)

    def shifted(shape):         # contiguous, 2 bytes past an aligned base
        flat = _randn(gen, (1 + shape.numel(),), torch.bfloat16, dev)
        return flat[1:].view(shape)

    q = _randn(gen, (1, 16, 4, 64), torch.bfloat16, dev)
    k = _randn(gen, (1, 16, 2, 64), torch.bfloat16, dev)
    q_off, k_off = shifted(q.shape), shifted(k.shape)
    assert q_off.is_contiguous() and q_off.data_ptr() % 16 == 2
    pos = _pos(1, 0, 16, dev)
    fa_ops.reset_routes()
    for args in ((q_off, k, k), (q, k_off, k), (q, k, k_off)):
        with pytest.raises(ValueError, match="16-byte"):
            flash_attention(*args, pos, pos)
    assert fa_ops.ROUTE_LAUNCHES == {"wgmma": 0, "simt": 0}


def test_flash_bf16_runs_at_its_key_limit(dev):
    """At D = 128, the head dim with the fewest keys, the tensor-core
    route launches at ``max_keys`` keys (the wrapper's limit agrees with
    the kernel's shared memory) and matches its plain version; one key
    more raises before any launch."""
    D, n = 128, fa_ops.max_keys(128)
    gen = torch.Generator(device=dev).manual_seed(7)
    q = _randn(gen, (1, 64, 1, D), torch.bfloat16, dev)
    k = _randn(gen, (1, n + 1, 1, D), torch.bfloat16, dev)
    v = _randn(gen, (1, n + 1, 1, D), torch.bfloat16, dev)
    qp = _pos(1, n - 64, 64, dev)
    kp = _pos(1, 0, n + 1, dev)
    kw = dict(causal=False)
    args = (q, k[:, :n], v[:, :n], qp, kp[:, :n].contiguous())
    _close(flash_attention(*args, **kw),
           flash_attention_plain(*args, **kw), torch.bfloat16)
    with pytest.raises(ValueError, match=f"at most {n} keys"):
        flash_attention(q, k, v, qp, kp, **kw)


def test_flash_ab_against_itself(dev):
    """The parent-versus-change timing tool, given this checkout as the
    other one: both builds give equal bits at every timed shape, and
    every time is a positive reading."""
    from repro_torch.launch import flash_ab
    rows = flash_ab.compare(Path(__file__).resolve().parents[1])
    assert [r["shape"] for r in rows] == [
        f"B{B} S{S} H{H}/{Hkv} D{D}" for B, S, H, Hkv, D in flash_ab.SHAPES]
    for r in rows:
        assert r["max_abs_diff"] == 0.0
        assert len(r["this_ms"]) == len(r["other_ms"]) == 2
        assert min(r["this_ms"] + r["other_ms"]) > 0


def test_bwd_ab_against_itself(dev):
    """The same tool for the backward (``--kernel flash_attention_bwd``):
    equal bits at its three training shapes, and every time, through the
    wrapper and alone (its three kernels summed), a positive reading."""
    from repro_torch.launch import flash_ab
    rows = flash_ab.compare(Path(__file__).resolve().parents[1],
                            kernel="flash_attention_bwd")
    assert [r["shape"] for r in rows] == [
        f"B{B} S{S} H{H}/{Hkv} D{D} causal"
        for B, S, H, Hkv, D in flash_ab.BWD_SHAPES]
    for r in rows:
        assert r["max_abs_diff"] == 0.0
        assert len(r["this_kernel_ms"]) == len(r["other_kernel_ms"]) == 2
        assert min(r["this_ms"] + r["other_ms"] + r["this_kernel_ms"]
                   + r["other_kernel_ms"]) > 0


def test_paged_ab_against_itself(dev):
    """The same tool for the decode kernel (``--kernel paged_attention``):
    equal bits and positive readings at its four shapes."""
    from repro_torch.launch import flash_ab
    rows = flash_ab.compare(Path(__file__).resolve().parents[1],
                            kernel="paged_attention")
    assert [r["shape"] for r in rows] == [
        paged_label(*s) for s in flash_ab.PAGED_SHAPES]
    for r in rows:
        assert r["max_abs_diff"] == 0.0
        assert len(r["this_ms"]) == len(r["other_ms"]) == 2
        assert min(r["this_ms"] + r["other_ms"]) > 0


def test_gemm_ab_against_itself(dev):
    """The same tool for the grouped GEMM (``--kernel moe_gemm``): equal
    bits and positive readings at its decode and two prefill shapes, the
    prefill ones on the wgmma route."""
    from repro_torch.launch import flash_ab
    rows = flash_ab.compare(Path(__file__).resolve().parents[1],
                            kernel="moe_gemm")
    assert [r["shape"].split(" rows")[0] for r in rows] == [
        label for label, *_ in flash_ab.GEMM_SHAPES]
    assert [r["shape"].endswith("(wgmma)") for r in rows] == [False, True,
                                                              True]
    for r in rows:
        assert r["max_abs_diff"] == 0.0
        assert len(r["this_ms"]) == len(r["other_ms"]) == 2
        assert min(r["this_ms"] + r["other_ms"]) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("H,Hkv,D", [(8, 2, 64), (14, 2, 64), (6, 2, 32),
                                     (4, 4, 128), (32, 2, 128), (8, 8, 64)])
def test_paged_kernel_matches_plain(dev, H, Hkv, D, dtype):
    """A shuffled page table with spare pages, and lengths inside a page,
    across pages, at the table's end and past it (clamped), 0 (a free
    slot: exact zeros), 1, and shorter than one rank's share of the
    cluster's split; groups of 4, 7, 3, 1 (D 128 and Whisper's D 64: 8
    outputs a cluster rank) and 16 q heads per kv head."""
    B, page, max_pages = 8, 16, 40
    gen = torch.Generator(device=dev).manual_seed(1)
    pool = B * max_pages + 5
    q = _randn(gen, (B, H, D), dtype, dev)
    kp = _randn(gen, (pool, page, Hkv, D), dtype, dev)
    vp = _randn(gen, (pool, page, Hkv, D), dtype, dev)
    table = torch.randperm(pool, generator=gen, device=dev)[:B * max_pages] \
        .reshape(B, max_pages).to(torch.int32)
    full = page * max_pages
    lengths = torch.tensor([3, 70, full, full + 1, 0, 1, 100, 333],
                           dtype=torch.int32, device=dev)
    got = paged_attention(q, kp, vp, table, lengths)
    _close(got, paged_attention_plain(q, kp, vp, table, lengths), dtype)
    assert torch.equal(got[4], torch.zeros_like(got[4]))


def _paged_dense(gen, B, S, H, Hkv, D, dtype, dev):
    """q and one layer's slot cache as the serving path passes them: a
    page-16 pool view with the identity table."""
    page = math.gcd(S, 16)
    q = _randn(gen, (B, H, D), dtype, dev)
    kp = _randn(gen, (B * S // page, page, Hkv, D), dtype, dev)
    vp = _randn(gen, (B * S // page, page, Hkv, D), dtype, dev)
    table = torch.arange(B * S // page, dtype=torch.int32,
                         device=dev).reshape(B, S // page)
    return q, kp, vp, table


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", PAGED_SHAPES,
                         ids=[paged_label(*s) for s in PAGED_SHAPES])
def test_paged_kernel_matches_plain_at_timed_shapes(dev, shape, dtype):
    """The four decode shapes ``chip_smoke.py`` times (Llama-3.2-1B and
    Qwen3-30B-A3B decode, Qwen3's b_attn = 4 sub-batch, the prefix-hit
    tail), at full size."""
    B, S, H, Hkv, D, lens = shape
    gen = torch.Generator(device=dev).manual_seed(8)
    q, kp, vp, table = _paged_dense(gen, B, S, H, Hkv, D, dtype, dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    _close(paged_attention(q, kp, vp, table, lengths),
           paged_attention_plain(q, kp, vp, table, lengths), dtype)


# (name, B, max_len, H, Hkv, D, length): Whisper-base's decoder
# self-attention cache and its 1536-frame cross cache (G = 1), Pixtral-12B's
# cache after 1024 patches + 512 tokens + 64 (G = 4)
SERVED_PAGED = [("whisper_self", 8, 96, 8, 8, 64, 96),
                ("whisper_cross", 8, 1536, 8, 8, 64, 1536),
                ("pixtral", 8, 1600, 32, 8, 128, 1600)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", SERVED_PAGED,
                         ids=[s[0] for s in SERVED_PAGED])
def test_paged_kernel_matches_plain_at_served_encdec_vlm_shapes(dev, shape,
                                                                 dtype):
    """The decode shapes of Whisper-base and Pixtral-12B at full size,
    each row at the cache's full length, as ``decode_attention`` passes
    them (a page-16 view with the identity table)."""
    _, B, S, H, Hkv, D, n = shape
    gen = torch.Generator(device=dev).manual_seed(15)
    q, kp, vp, table = _paged_dense(gen, B, S, H, Hkv, D, dtype, dev)
    lengths = torch.full((B,), n, dtype=torch.int32, device=dev)
    _close(paged_attention(q, kp, vp, table, lengths),
           paged_attention_plain(q, kp, vp, table, lengths), dtype)


def test_the_checks_see_a_causal_encoder_and_a_short_cross_row(dev):
    """The served shapes' checks must see a wrong kernel: at the encoder's
    shape the plain version with the mask made causal, and at the cross
    cache's a row's length one page (16 keys) short, each fail the bf16
    tolerance the kernel is held to.  The cross cache's last page holds,
    for row 0, a key along each head's query (queries scaled by SPREAD),
    so row 0's output rests on that page."""
    gen = torch.Generator(device=dev).manual_seed(16)
    dt = torch.bfloat16
    q = _randn(gen, (8, 1536, 8, 64), dt, dev)
    k = _randn(gen, (8, 1536, 8, 64), dt, dev)
    v = _randn(gen, (8, 1536, 8, 64), dt, dev)
    pos = _pos(8, 0, 1536, dev)
    want = flash_attention_plain(q, k, v, pos, pos, causal=False)
    _close(flash_attention(q, k, v, pos, pos, causal=False), want, dt)
    wrong = flash_attention_plain(q, k, v, pos, pos, causal=True)
    assert not torch.isclose(wrong.float(), want.float(), **TOL[dt]).all()
    q, kp, vp, table = _paged_dense(gen, 8, 1536, 8, 8, 64, dt, dev)
    q = (q.float() * SPREAD).to(dt)
    kp.view(8, 1536, 8, 64)[0, -1] = q[0]
    lengths = torch.full((8,), 1536, dtype=torch.int32, device=dev)
    want = paged_attention_plain(q, kp, vp, table, lengths)
    _close(paged_attention(q, kp, vp, table, lengths), want, dt)
    lengths[0] -= 16
    wrong = paged_attention_plain(q, kp, vp, table, lengths)
    assert not torch.isclose(wrong[0].float(), want[0].float(),
                             **TOL[dt]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_paged_is_deterministic_and_routes_count(dev, dtype):
    """Two launches give equal bits (the cluster merges in rank order, with
    no atomics); bf16 launches count on the mma route, fp32 ones on the
    simt route, each in the kernel's total as well."""
    gen = torch.Generator(device=dev).manual_seed(9)
    q, kp, vp, table = _paged_dense(gen, 8, 2048, 32, 8, 64, dtype, dev)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    kernels.reset_launches()
    pa_ops.reset_routes()
    a = paged_attention(q, kp, vp, table, lengths)
    b = paged_attention(q, kp, vp, table, lengths)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert pa_ops.ROUTE_LAUNCHES == {"mma": 2 * (dtype == torch.bfloat16),
                                     "simt": 2 * (dtype == torch.float32)}
    assert kernels.launches()["paged_attention"] == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("H,Hkv,D,S", [(32, 8, 64, 2048), (32, 4, 128, 512),
                                       (8, 8, 64, 96), (14, 2, 32, 64)])
def test_paged_lse_matches_plain(dev, dtype, H, Hkv, D, S):
    """The kernel's log-sum-exp output (the decode regime's shard
    statistics) against the plain version's, length-0 rows -1e30 (fp32
    atol 1e-4, bf16 atol 1e-3, rtol 1e-4: the sums' order); the output
    equal in bits to the launch without it."""
    gen = torch.Generator(device=dev).manual_seed(11)
    q, kp, vp, table = _paged_dense(gen, 6, S, H, Hkv, D, dtype, dev)
    lengths = torch.tensor([0, 1, S // 3, S - 1, S, 0], dtype=torch.int32,
                           device=dev)
    lse = torch.full((6, H), 7.0, device=dev)
    got = paged_attention(q, kp, vp, table, lengths, lse)
    want_lse = torch.empty_like(lse)
    want = paged_attention_plain(q, kp, vp, table, lengths, want_lse)
    torch.cuda.synchronize()
    assert torch.equal(got, paged_attention(q, kp, vp, table, lengths))
    _close(got, want, dtype)
    tol = 1e-4 if dtype == torch.float32 else 1e-3
    assert torch.allclose(lse, want_lse, atol=tol, rtol=1e-4)
    assert (lse[lengths == 0] == pa_ops.NEG).all()
    with pytest.raises(ValueError, match="lse"):
        paged_attention(q, kp, vp, table, lengths, lse[:, :-1])


def test_paged_rejects_a_misaligned_pool(dev):
    """K/V rows arrive by 16-byte cp.async: a contiguous pool view that
    starts 2 bytes in raises before any launch."""
    gen = torch.Generator(device=dev).manual_seed(10)
    q, kp, vp, table = _paged_dense(gen, 1, 32, 4, 2, 64, torch.bfloat16,
                                    dev)
    flat = _randn(gen, (1 + kp.numel(),), torch.bfloat16, dev)
    shifted = flat[1:].view(kp.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    lengths = torch.tensor([20], dtype=torch.int32, device=dev)
    pa_ops.reset_routes()
    for args in ((shifted, vp), (kp, shifted)):
        with pytest.raises(ValueError, match="16-byte"):
            paged_attention(q, *args, table, lengths)
    assert pa_ops.ROUTE_LAUNCHES == {"mma": 0, "simt": 0}


def _sampling_rows(gen, B, V, dev, k=None, p=None, min_p=None):
    """Processed logits, Gumbel rows and raw logits (B, V) f32, with mixed
    per-row top-k / top-p / min-p unless given."""
    return sampling_rows(gen, B, V, dev, k, p, min_p)


def _same_sample(got, want):
    torch.cuda.synchronize()
    assert set(got) == set(want)
    for key in ("sampled", "greedy", "top_idx"):
        if key in want:
            assert torch.equal(got[key], want[key]), key
    for key in ("tau", "m", "l", "m_raw", "l_raw", "top_vals"):
        if key in want:
            torch.testing.assert_close(got[key], want[key], rtol=1e-5,
                                       atol=1e-6, msg=key)


# (name, B, V, lp_k, k, p, min_p): None draws mixed rows
SAMPLING_CASES = [
    ("mixed_v512", 5, 512, -1, None, None, None),
    ("mixed_odd_v1000_lanes4", 6, 1000, 4, None, None, None),
    ("mixed_v4096_lanes0", 4, 4096, 0, None, None, None),
    ("filters_off", 3, 3001, -1, 0, 1.0, 0.0),
    ("k1", 3, 2048, 5, 1, 1.0, 0.0),
    ("top_p_only", 4, 4097, -1, 0, 0.7, 0.0),
    ("v128256_lanes5", 8, 128256, 5, None, None, None),
    ("b1_v128256_prefix_tail", 1, 128256, -1, 0, 0.9, 0.0),
    ("v151936_lanes5", 8, 151936, 5, None, None, None),
    ("b2_v256000_lanes5_largest_slice", 2, 256000, 5, None, None, None),
    ("b1_v7_empty_ranks", 1, 7, 7, 3, 0.9, 0.0),
    ("lanes40_two_rounds", 3, 4096, 40, None, None, None),
    # Whisper-base's padded vocabulary (no multiple of 128) and
    # Pixtral-12B's
    ("v51872_lanes5_whisper", 8, 51872, 5, None, None, None),
    ("v131072_lanes5_pixtral", 8, 131072, 5, None, None, None),
]


@pytest.mark.parametrize("case", SAMPLING_CASES,
                         ids=[c[0] for c in SAMPLING_CASES])
def test_fused_sampling_kernel_matches_plain(dev, case):
    _, B, V, lp_k, k, p, min_p = case
    gen = torch.Generator(device=dev).manual_seed(5)
    x, g, kk, pp, mp, raw = _sampling_rows(gen, B, V, dev, k, p, min_p)
    kw = dict(raw=raw if lp_k >= 0 else None, lp_k=max(lp_k, 0),
              with_lanes=lp_k >= 0)
    got = fused_sample(x, g, kk, pp, mp, **kw)
    again = fused_sample(x, g, kk, pp, mp, **kw)
    _same_sample(got, fused_sample_plain(x, g, kk, pp, mp, **kw))
    for key in got:            # deterministic: two launches, equal bits
        assert torch.equal(got[key], again[key]), key


def test_fused_sampling_tie_across_a_rank_boundary(dev):
    """A maximum, a draw and a top raw entry tied between the last entry
    of rank 0's slice and the first of rank 1's: greedy, the draw and the
    lanes take the lower index, in a row that keeps only the pair (k = 2)
    and in one that keeps every entry."""
    V = 128256
    gen = torch.Generator(device=dev).manual_seed(8)
    x, g, kk, pp, mp, raw = _sampling_rows(gen, 2, V, dev,
                                           torch.tensor([2, 0]), 1.0, 0.0)
    w = fs_ops.slice_width(V)
    assert 0 < w < V and w % 4 == 0
    for t, val in ((x, 30.0), (g, 10.0), (raw, 9.0)):
        t[:, w - 1:w + 1] = val
    kw = dict(raw=raw, lp_k=3, with_lanes=True)
    got = fused_sample(x, g, kk, pp, mp, **kw)
    _same_sample(got, fused_sample_plain(x, g, kk, pp, mp, **kw))
    assert got["sampled"].tolist() == [w - 1, w - 1]
    assert got["greedy"].tolist() == [w - 1, w - 1]
    assert got["top_idx"][:, :2].tolist() == [[w - 1, w], [w - 1, w]]


@pytest.mark.parametrize("V", [1000, 128256])
def test_fused_sampling_crossings_on_the_catch_all_bucket(dev, V):
    """Crossings that land on a refinement level's catch-all bucket, whose
    mass the kernel sums in a pass of its own: the kernel keeps its plain
    version's tokens, and the kept sets are the pair of top values."""
    gen = torch.Generator(device=dev).manual_seed(11)
    x, g, kk, pp, mp, raw = catch_all_rows(gen, V, dev)
    kw = dict(raw=raw, lp_k=2, with_lanes=True)
    got = fused_sample(x, g, kk, pp, mp, **kw)
    want = fused_sample_plain(x, g, kk, pp, mp, **kw)
    _same_sample(got, want)
    assert set(got["sampled"].tolist()) <= {1, V - 2}
    assert torch.equal(got["tau"], want["tau"])


def test_fused_sampling_refuses_a_row_past_its_limit(dev):
    """One entry past ``max_vocab()`` raises before any launch; the limit
    takes every vocabulary of the repo's configs (256000 the largest)."""
    limit = fs_ops.max_vocab()
    assert limit >= 256000
    gen = torch.Generator(device=dev).manual_seed(9)
    x, g, kk, pp, mp, _ = _sampling_rows(gen, 1, limit + 1, dev)
    kernels.reset_launches()
    with pytest.raises(ValueError, match=f"limit {limit}"):
        fused_sample(x, g, kk, pp, mp)
    assert kernels.launches()["fused_sampling"] == 0


def test_each_launch_is_counted_once(dev):
    gen = torch.Generator(device=dev).manual_seed(2)
    q = _randn(gen, (1, 16, 4, 64), torch.float32, dev)
    k = _randn(gen, (1, 16, 2, 64), torch.float32, dev)
    pos = _pos(1, 0, 16, dev)
    qd = _randn(gen, (1, 4, 64), torch.float32, dev)
    table = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    lengths = torch.tensor([16], dtype=torch.int32, device=dev)
    rows = _sampling_rows(gen, 2, 300, dev)
    kernels.reset_launches()
    flash_attention(q, k, k, pos, pos)
    flash_attention(q, k, k, pos, pos)
    paged_attention(qd, k, k, table, lengths)
    fused_sample(*rows[:5], raw=rows[5], lp_k=2, with_lanes=True)
    x = _randn(gen, (32, 64), torch.float32, dev)
    w = _randn(gen, (2, 64, 16), torch.float32, dev)
    be = torch.tensor([1, -1], dtype=torch.int32, device=dev)
    grouped_gemm(x, w, be, block_t=16)
    grouped_gemm(x, w, be, block_t=16)
    grouped_gemm(x, w, be, block_t=16)
    dy = _randn(gen, (32, 16), torch.float32, dev)
    grouped_gemm_wgrad(x, dy, be, 2, block_t=16)
    st = _randn(gen, (1, 2, 3, 4, 8), torch.float32, dev)
    dec = torch.rand((1, 2, 3), generator=gen, device=dev)
    ssd_state_scan(st, dec)
    ssd_state_scan(st, dec)
    ssd_state_scan_bwd(st, dec, st)
    flash_attention_plain(q, k, k, pos, pos)
    out, lse = fa_ops.flash_attention_lse(q, k, k, pos, pos)
    flash_attention_bwd(q, k, k, pos, pos, out, lse, out)
    paged_attention_plain(qd, k, k, table, lengths)
    fused_sample_plain(*rows[:5])
    grouped_gemm_plain(x, w, be, block_t=16)
    grouped_gemm_wgrad_plain(x, dy, be, 2, block_t=16)
    ssd_state_scan_plain(st, dec)
    ssd_state_scan_bwd_plain(st, dec, st)
    flash_attention_bwd_plain(q, k, k, pos, pos, out, lse, out)
    torch.cuda.synchronize()
    assert kernels.launches() == {"flash_attention": 3,
                                  "flash_attention_bwd": 1,
                                  "paged_attention": 1, "fused_sampling": 1,
                                  "moe_gemm": 3, "moe_gemm_wgrad": 1,
                                  "ssd_scan": 2, "ssd_scan_bwd": 1}


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    q = _randn(gen, (1, 16, 4, 64), torch.float32, dev)
    k = _randn(gen, (1, 16, 2, 64), torch.float32, dev)
    pos = _pos(1, 0, 16, dev)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                        k, k, pos, pos)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), k.half(), pos, pos)
    with pytest.raises(TypeError):
        flash_attention(q, k, k, pos.long(), pos.long())
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                        k[..., :48].contiguous(), pos, pos)
    with pytest.raises(ValueError):
        flash_attention(q, k, k, pos, pos.cpu())
    table = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    lengths = torch.tensor([16], dtype=torch.int32, device=dev)
    qd = _randn(gen, (1, 34, 64), torch.float32, dev)
    with pytest.raises(ValueError, match="q heads per kv head"):
        paged_attention(qd, k, k, table, lengths)    # a group of 17
    with pytest.raises(TypeError):
        paged_attention(qd[:, :4], k, k, table, lengths.long())
    x, g, kk, pp, mp, raw = _sampling_rows(gen, 2, 300, dev)
    with pytest.raises(TypeError):
        fused_sample(x.half(), g, kk, pp, mp)
    with pytest.raises(TypeError):
        fused_sample(x, g, kk.long(), pp, mp)
    with pytest.raises(ValueError, match="contiguous"):
        fused_sample(x.t().contiguous().t(), g, kk, pp, mp)
    with pytest.raises(ValueError):
        fused_sample(x, g[:, :299].contiguous(), kk, pp, mp)
    with pytest.raises(ValueError):
        fused_sample(x, g, kk[:1].contiguous(), pp, mp)
    with pytest.raises(ValueError):
        fused_sample(x, g, kk, pp, mp.cpu())
    with pytest.raises(ValueError, match="lp_k"):
        fused_sample(x, g, kk, pp, mp, raw=raw, lp_k=301, with_lanes=True)
    xs = _randn(gen, (64, 32), torch.bfloat16, dev)
    ws = _randn(gen, (3, 32, 24), torch.bfloat16, dev)
    be = torch.zeros((4,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="block_t"):
        grouped_gemm(xs, ws, be[:3].contiguous(), block_t=24)
    with pytest.raises(ValueError, match="block_expert"):
        grouped_gemm(xs, ws, be[:2].contiguous(), block_t=16)
    with pytest.raises(TypeError):
        grouped_gemm(xs, ws, be.long(), block_t=16)
    with pytest.raises(TypeError):
        grouped_gemm(xs, ws.float(), be, block_t=16)
    with pytest.raises(ValueError, match="contiguous"):
        grouped_gemm(xs.t().contiguous().t(), ws, be, block_t=16)
    with pytest.raises(ValueError):
        grouped_gemm(xs, ws[:, :16].contiguous(), be, block_t=16)
    st = _randn(gen, (2, 3, 4, 8, 8), torch.float32, dev)
    dec = torch.rand((2, 3, 4), generator=gen, device=dev)
    with pytest.raises(TypeError):
        ssd_state_scan(st.bfloat16(), dec)
    with pytest.raises(TypeError):
        ssd_state_scan(st, dec.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        ssd_state_scan(st.transpose(3, 4).contiguous().transpose(3, 4), dec)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_state_scan(st, dec.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError):
        ssd_state_scan(st[0], dec[0])                # wrong ranks
    with pytest.raises(ValueError):
        ssd_state_scan(st, dec[:, :, :3].contiguous())
    with pytest.raises(ValueError):
        ssd_state_scan(st, dec.cpu())


def test_reduced_engine_tokens_match_cpu(dev):
    """The reduced fp32 model served through BatchMaster on the card (the
    kernels) and on the CPU (the plain versions): identical greedy
    tokens, and the card's run launched both kernels."""
    cfg = dataclasses.replace(reduced_config("llama3_2_1b"), dtype="float32")
    params = TT.init_params(cfg, seed=4, device="cpu")
    gen = torch.Generator().manual_seed(4)
    reqs = [(f"s{i}", torch.randint(2, cfg.vocab_size, (n,),
                                    generator=gen).tolist())
            for i, n in enumerate([5, 12, 17, 30])]
    def to(tree, target):
        return {k: to(v, target) if isinstance(v, dict) else v.to(target)
                for k, v in tree.items()}

    out = {}
    for target in (dev, torch.device("cpu")):
        eng = NodeEngine(cfg, params=to(params, target), max_active=4,
                         max_len=128, page_size=8, device=target)
        master = BatchMaster([eng], SchedulerConfig(page_size=8))
        kernels.reset_launches()
        bo = master.run(master.submit(
            [BatchRequest(c, p, 20) for c, p in reqs]))
        assert bo.request_counts["completed"] == len(reqs)
        used = kernels.launches()
        assert used["fused_sampling"] == 0, used     # all-greedy: argmax
        assert (min(used["flash_attention"], used["paged_attention"]) > 0) \
            == (target.type == "cuda"), used
        out[target.type] = {r["custom_id"]: r["response"]["tokens"]
                            for r in bo.results}
    assert out["cuda"] == out["cpu"]


def test_reduced_sampled_engine_tokens_match_cpu(dev):
    """Sampled and logprob requests of the reduced fp32 model on the card
    (the fused sampling kernel) and on the CPU (its plain version):
    identical tokens and logprobs within 1e-4, and the card's run
    launched all three kernels."""
    cfg = dataclasses.replace(reduced_config("llama3_2_1b"), dtype="float32")
    params = TT.init_params(cfg, seed=6, device="cpu")
    gen = torch.Generator().manual_seed(6)
    sps = [SamplingParams(),
           SamplingParams(temperature=0.8, top_k=20, seed=1),
           SamplingParams(temperature=1.1, top_p=0.9, min_p=0.02, seed=2,
                          stop=(7,)),
           SamplingParams(temperature=0.7, repetition_penalty=1.3,
                          presence_penalty=0.2, frequency_penalty=0.1,
                          seed=3)]
    reqs = [BatchRequest(f"s{i}", torch.randint(2, cfg.vocab_size, (n,),
                                                generator=gen).tolist(), 20,
                         sampling=sp, logprobs=i % 2 == 1,
                         top_logprobs=3 if i == 3 else 0)
            for i, (n, sp) in enumerate(zip([5, 12, 17, 30], sps))]

    def to(tree, target):
        return {k: to(v, target) if isinstance(v, dict) else v.to(target)
                for k, v in tree.items()}

    out = {}
    for target in (dev, torch.device("cpu")):
        eng = NodeEngine(cfg, params=to(params, target), max_active=4,
                         max_len=128, page_size=8, device=target)
        master = BatchMaster([eng], SchedulerConfig(page_size=8))
        kernels.reset_launches()
        bo = master.run(master.submit(reqs))
        assert bo.request_counts["completed"] == len(reqs)
        used = kernels.launches()
        if target.type == "cuda":       # a dense model: no grouped GEMM
            assert min(used[k] for k in ("flash_attention",
                                         "paged_attention",
                                         "fused_sampling")) > 0, used
            assert used["moe_gemm"] == 0, used
        else:
            assert max(used.values()) == 0, used
        out[target.type] = {r["custom_id"]: r["response"]
                            for r in bo.results}
    for cid, want in out["cpu"].items():
        got = out["cuda"][cid]
        assert got["tokens"] == want["tokens"], cid
        if "logprobs" in want:
            torch.testing.assert_close(
                torch.tensor(got["logprobs"]["token_logprobs"]),
                torch.tensor(want["logprobs"]["token_logprobs"]),
                rtol=1e-4, atol=1e-4)


# (name, T rows, D, F, E, block_t, experts of the used blocks); the rest of
# the T / block_t blocks are unused (-1).  Expert E-1 gets no block.  In
# bf16, block_t a multiple of 64 with D and F multiples of 8 takes the
# wgmma route, the rest the mma route (``ops.route``); fp32 takes simt.
GEMM_CASES = [
    ("decode_bt16_ragged_f", 16 * 20, 256, 96, 8, 16, [0, 3, 5, 6, 2, 1]),
    ("reduced_bt32_f64", 32 * 8, 128, 64, 4, 32, [0, 0, 1, 2]),
    ("ragged_d72_f100_bt64", 64 * 5, 72, 100, 3, 64, [1, 0, 1]),
    ("odd_d36_bt16", 16 * 6, 36, 40, 2, 16, [0, 0, 0]),
    ("qwen3_w1_bt128", 128 * 6, 2048, 768, 16, 128, [4, 9, 9, 0]),
    ("qwen3_w2_bt16", 16 * 12, 768, 2048, 16, 16, [3, 7, 8, 12, 14, 0, 1]),
    ("wgmma_d72_f96_bt64", 64 * 6, 72, 96, 3, 64, [1, 0, 0, 0]),
    ("wgmma_f64_bt128", 128 * 4, 128, 64, 4, 128, [0, 1, 1]),
    ("wgmma_w2_bt64", 64 * 8, 768, 2048, 8, 64, [2, 2, 5, 0, 6]),
    ("wgmma_f200_bt256", 256 * 3, 1024, 200, 4, 256, [3, 1]),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", GEMM_CASES, ids=[c[0] for c in GEMM_CASES])
def test_moe_gemm_kernel_matches_plain(dev, case, dtype):
    _, T, D, F, E, bt, used = case
    gen = torch.Generator(device=dev).manual_seed(7)
    x = _randn(gen, (T, D), dtype, dev)
    w = (0.1 * torch.randn((E, D, F), generator=gen, device=dev)).to(dtype)
    be = torch.full((T // bt,), -1, dtype=torch.int32, device=dev)
    be[:len(used)] = torch.tensor(used, dtype=torch.int32, device=dev)
    got = grouped_gemm(x, w, be, block_t=bt)
    want = grouped_gemm_plain(x, w, be, block_t=bt)
    _close(got, want, dtype)
    assert not got[len(used) * bt:].any()


@pytest.mark.parametrize("bt", [16, 128], ids=["decode_mma",
                                              "prefill_wgmma"])
@pytest.mark.parametrize("wname", ["w1", "w2"])
def test_moe_gemm_at_deepseek_widths(dev, bt, wname):
    """DeepSeek-R1's expert weights, E 256 of (D 7168, F 2048) as w1 and
    (2048, 7168) as w2, bf16: the last expert's weight starts 3.7e9
    elements in (past a 32-bit index), on the route of its block_t."""
    gen = torch.Generator(device=dev).manual_seed(17)
    E, D, F = 256, 7168, 2048
    shape = (E, D, F) if wname == "w1" else (E, F, D)
    w = torch.randn(shape, generator=gen, device=dev,
                    dtype=torch.bfloat16).mul_(0.02)
    used = [255, 0, 128, 255, 17]
    T = bt * (len(used) + 2)
    x = _randn(gen, (T, shape[1]), torch.bfloat16, dev)
    be = torch.full((T // bt,), -1, dtype=torch.int32, device=dev)
    be[:len(used)] = torch.tensor(used, dtype=torch.int32, device=dev)
    moe_ops.reset_routes()
    got = grouped_gemm(x, w, be, block_t=bt)
    assert moe_ops.ROUTE_LAUNCHES[moe_ops.route(torch.bfloat16, bt,
                                                shape[1], shape[2],
                                                True)] == 1
    _close(got, grouped_gemm_plain(x, w, be, block_t=bt), torch.bfloat16)
    assert not got[len(used) * bt:].any()


def test_moe_gemm_is_deterministic_and_routes_count(dev):
    """The wgmma route gives equal bits over two launches (no split-K, no
    atomics); each launch counts on the route ``ops.route`` names: wgmma
    at block_t 128, mma at block_t 16 and for a base TMA cannot read,
    simt for fp32, each in the kernel's total as well."""
    gen = torch.Generator(device=dev).manual_seed(11)
    T, D, F, E, bt = 128 * 8, 2048, 768, 8, 128
    x = _randn(gen, (T, D), torch.bfloat16, dev)
    w = (0.05 * torch.randn((E, D, F), generator=gen, device=dev)).bfloat16()
    be = torch.tensor([0, 0, 0, 2, 5, 7, -1, -1], dtype=torch.int32,
                      device=dev)
    kernels.reset_launches()
    moe_ops.reset_routes()
    a = grouped_gemm(x, w, be, block_t=bt)
    b = grouped_gemm(x, w, be, block_t=bt)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert moe_ops.ROUTE_LAUNCHES == {"wgmma": 2, "mma": 0, "simt": 0}
    be16 = be.repeat_interleave(bt // 16).contiguous()
    c = grouped_gemm(x, w, be16, block_t=16)
    flat = torch.empty((T * D + 1,), dtype=torch.bfloat16, device=dev)
    shifted = flat[1:].view(T, D)
    shifted.copy_(x)
    assert moe_ops.route(torch.bfloat16, bt, D, F, False) == "mma"
    d = grouped_gemm(shifted, w, be, block_t=bt)
    grouped_gemm(x.float(), w.float(), be, block_t=bt)
    torch.cuda.synchronize()
    assert moe_ops.ROUTE_LAUNCHES == {"wgmma": 2, "mma": 2, "simt": 1}
    assert kernels.launches()["moe_gemm"] == 5
    want = grouped_gemm_plain(x, w, be, block_t=bt)
    for got in (a, c, d):
        _close(got, want, torch.bfloat16)


def test_moe_ffn_on_the_card_matches_cpu(dev):
    """The dispatch, three grouped GEMMs and the weighted sum on the card
    against the same op on the CPU (the plain version), fp32."""
    gen = torch.Generator().manual_seed(8)
    T, D, F, E, k = 40, 64, 96, 8, 2
    x = torch.randn((T, D), generator=gen)
    ids = torch.stack([torch.randperm(E, generator=gen)[:k]
                       for _ in range(T)]).to(torch.int32)
    vals = torch.rand((T, k), generator=gen)
    ws = [0.1 * torch.randn(s, generator=gen)
          for s in ((E, D, F), (E, D, F), (E, F, D))]
    kernels.reset_launches()
    got = moe_ffn(x.to(dev), ids.to(dev), vals.to(dev),
                  *(a.to(dev) for a in ws), num_experts=E, block_t=16)
    assert kernels.launches()["moe_gemm"] == 3
    want = moe_ffn(x, ids, vals, *ws, num_experts=E, block_t=16)
    torch.testing.assert_close(got.cpu(), want, **TOL[torch.float32])


def test_reduced_moe_module_engine_tokens_match_cpu(dev):
    """Reduced fp32 qwen3 MoE with module granularity (b_attn 2 of 4
    slots), greedy and sampled requests, on the card (the kernels) and on
    the CPU (the plain versions): identical tokens, and the card's run
    launched its four kernels and not the scan."""
    cfg = dataclasses.replace(reduced_config("qwen3_moe_30b"),
                              dtype="float32")
    params = TT.init_params(cfg, seed=9, device="cpu")
    gen = torch.Generator().manual_seed(9)
    sps = [SamplingParams(), SamplingParams(),
           SamplingParams(temperature=0.8, top_k=20, seed=1),
           SamplingParams(temperature=1.1, top_p=0.9, seed=2)]
    reqs = [BatchRequest(f"s{i}", torch.randint(2, cfg.vocab_size, (n,),
                                                generator=gen).tolist(), 20,
                         sampling=sp)
            for i, (n, sp) in enumerate(zip([5, 12, 17, 30], sps))]

    def to(tree, target):
        return {k: to(v, target) if isinstance(v, dict) else v.to(target)
                for k, v in tree.items()}

    out = {}
    for target in (dev, torch.device("cpu")):
        eng = NodeEngine(cfg, params=to(params, target), max_active=4,
                         max_len=128, page_size=8, device=target,
                         module_granularity=True, b_attn=2)
        master = BatchMaster([eng], SchedulerConfig(page_size=8))
        kernels.reset_launches()
        bo = master.run(master.submit(reqs))
        assert bo.request_counts["completed"] == len(reqs)
        used = kernels.launches()
        if target.type == "cuda":       # an attention model: no scan
            assert min(used[k] for k in ("flash_attention",
                                         "paged_attention",
                                         "fused_sampling",
                                         "moe_gemm")) > 0, used
            assert used["ssd_scan"] == 0, used
        else:
            assert max(used.values()) == 0, used
        out[target.type] = {r["custom_id"]: r["response"]["tokens"]
                            for r in bo.results}
    assert out["cuda"] == out["cpu"]


# (B, H, nc, N, P): the JAX test's shapes, one chunk, mamba2_370m's width
# at a short prompt, a ragged N*P (the scalar path)
SCAN_CASES = [(2, 4, 8, 16, 8), (1, 2, 16, 32, 16), (2, 3, 1, 16, 8),
              (2, 32, 4, 128, 64), (2, 3, 5, 7, 3)]


@pytest.mark.parametrize("shape", SCAN_CASES,
                         ids=["x".join(map(str, c)) for c in SCAN_CASES])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
def test_ssd_scan_kernel_matches_plain_bits(dev, shape, offset):
    """Equal bits on ``prev`` and ``final``; offset 1 is a contiguous view
    off the 16-byte grid, which takes the scalar path."""
    gen = torch.Generator(device=dev).manual_seed(10)
    B, H, nc = shape[:3]
    n = B * H * nc * shape[3] * shape[4]
    st = torch.randn(n + offset, generator=gen, device=dev)[offset:] \
        .view(shape)
    dec = torch.rand((B, H, nc), generator=gen, device=dev) * 0.9 + 0.05
    got = ssd_state_scan(st, dec)
    torch.cuda.synchronize()
    want = ssd_state_scan_plain(st, dec)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not got[0][:, :, 0].any()


# (B, H, nc, N, P): the JAX test's shapes, one chunk, Mamba2-370M's state
# at 16 chunks, a ragged N*P (the scalar path), a ragged tile count
SCAN_BWD_CASES = [(2, 4, 8, 16, 8), (1, 2, 16, 32, 16), (2, 3, 1, 16, 8),
                  (2, 32, 16, 128, 64), (2, 3, 5, 7, 3), (1, 2, 7, 24, 36)]


def _ddecay_close(got, want, dstates, prev):
    """ddecay, a sum of N * P products, to atol 1e-5 + 1e-7 x the sum of
    their magnitudes (~2 ulps of it), rtol 1e-5."""
    mag = (dstates.abs() * prev.abs()).sum(dim=(-2, -1))
    err = (got - want).abs()
    assert (err <= 1e-5 + 1e-7 * mag + 1e-5 * want.abs()).all(), \
        err.max().item()


@pytest.mark.parametrize("shape", SCAN_BWD_CASES,
                         ids=["x".join(map(str, c)) for c in SCAN_BWD_CASES])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("final", [False, True], ids=["nofinal", "final"])
def test_ssd_scan_bwd_kernel_matches_plain(dev, shape, offset, final):
    """dstates in the plain backward's bits, ddecay to a summation-order
    bound, equal bits over two launches; offset 1 is a contiguous view off
    the 16-byte grid (the scalar path)."""
    gen = torch.Generator(device=dev).manual_seed(12)
    B, H, nc, N, P = shape
    n = B * H * nc * N * P

    def view(numel, shp):
        return torch.randn(numel + offset, generator=gen,
                           device=dev)[offset:].view(shp)
    prev = view(n, shape)
    dprev = view(n, shape)
    dfinal = view(B * H * N * P, (B, H, N, P)) if final else None
    dec = torch.rand((B, H, nc), generator=gen, device=dev) * 0.9 + 0.05
    kernels.reset_launches()
    got = ssd_state_scan_bwd(prev, dec, dprev, dfinal)
    again = ssd_state_scan_bwd(prev, dec, dprev, dfinal)
    torch.cuda.synchronize()
    assert kernels.launches()["ssd_scan_bwd"] == 2
    want = ssd_state_scan_bwd_plain(prev, dec, dprev, dfinal)
    assert torch.equal(got[0], want[0])
    _ddecay_close(got[1], want[1], want[0], prev)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_ssd_scan_fn_on_the_card_matches_cpu(dev):
    """``SsdScanFn`` forward and backward on the card (one launch each)
    against the CPU's plain versions, ``final`` unused (dfinal None)."""
    gen = torch.Generator().manual_seed(13)
    shape = (2, 32, 8, 128, 64)
    st = torch.randn(shape, generator=gen)
    dec = torch.rand(shape[:3], generator=gen) * 0.9 + 0.05
    dprev = torch.randn(shape, generator=gen)
    grads = {}
    for target in ("cpu", dev):
        s = st.to(target).clone().requires_grad_(True)
        d = dec.to(target).clone().requires_grad_(True)
        kernels.reset_launches()
        prev, _ = SsdScanFn.apply(s, d)
        prev.backward(dprev.to(target))
        used = kernels.launches()
        want = 1 if target == dev else 0
        assert used["ssd_scan"] == used["ssd_scan_bwd"] == want, used
        grads[str(target)] = (prev.detach().cpu(), s.grad.cpu(),
                              d.grad.cpu())
    (pc, sc, dc), (pg, sg, dg) = grads.values()
    assert torch.equal(pc, pg) and torch.equal(sc, sg)
    _ddecay_close(dg, dc, sc, pc)


def test_reduced_ssm_forward_loss_on_the_card_matches_cpu(dev):
    """Reduced fp32 Mamba2-370M: the loss and every leaf's gradient on the
    card (the scan twice a layer under remat, its backward once) against
    the CPU's plain versions."""
    from repro_torch import optim
    from repro_torch.launch.steps import loss_and_grads
    cfg = dataclasses.replace(reduced_config("mamba2_370m"), dtype="float32")
    cpu = TT.init_params(cfg, 0, "cpu")
    cuda = optim.tree_map(lambda t: t.to(dev), cpu)
    gen = torch.Generator().manual_seed(42)
    toks = torch.randint(2, cfg.vocab_size, (2, 192), generator=gen,
                         dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks}
    want_l, want_g = loss_and_grads(cfg, cpu, batch)
    kernels.reset_launches()
    got_l, got_g = loss_and_grads(cfg, cuda, {k: t.to(dev)
                                              for k, t in batch.items()})
    torch.cuda.synchronize()
    used = {k: n for k, n in kernels.launches().items() if n}
    assert used == {"ssd_scan": 2 * cfg.num_layers,
                    "ssd_scan_bwd": cfg.num_layers}, used
    torch.testing.assert_close(got_l.cpu(), want_l, rtol=1e-5, atol=0)
    for g, w in zip(optim.tree_leaves(got_g), optim.tree_leaves(want_g)):
        torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=1e-3)


def test_reduced_ssm_model_level_tokens_match_cpu(dev):
    """Reduced fp32 mamba2_370m at model level (prefill, then decode
    pages) on the card (the scan kernel; the sampling kernel on sampled
    pages) and on the CPU (the plain versions): identical greedy and
    sampled tokens, and no attention or MoE kernel launched."""
    cfg = dataclasses.replace(reduced_config("mamba2_370m"), dtype="float32")
    params = TT.init_params(cfg, seed=11, device="cpu")
    gen = torch.Generator().manual_seed(11)
    prompts = torch.randint(2, cfg.vocab_size, (4, 128),
                            generator=gen).tolist()
    sps = [SamplingParams(),
           SamplingParams(temperature=0.8, top_k=20, seed=1),
           SamplingParams(temperature=1.1, top_p=0.9, seed=2, stop=(7,)),
           SamplingParams(temperature=0.7, repetition_penalty=1.3, seed=3)]

    def to(tree, target):
        return {k: to(v, target) if isinstance(v, dict) else v.to(target)
                for k, v in tree.items()}

    out = {}
    for target in (dev, torch.device("cpu")):
        p = to(params, target)
        kernels.reset_launches()
        greedy = generate(cfg, p, prompts, [20, 3, 17, 20])
        used = kernels.launches()
        sampled = generate(cfg, p, prompts, 20, sampling=sps, lp_k=2)
        used_s = {k: v - used[k] for k, v in kernels.launches().items()}
        if target.type == "cuda":
            assert used["ssd_scan"] == cfg.num_layers, used
            assert used_s["ssd_scan"] == cfg.num_layers, used_s
            assert used_s["fused_sampling"] > 0, used_s
            assert used["fused_sampling"] == 0, used
            for name in ("flash_attention", "paged_attention", "moe_gemm"):
                assert used[name] == used_s[name] == 0, name
        else:
            assert max(used.values()) == max(used_s.values()) == 0
        out[target.type] = (greedy.tokens, sampled.tokens,
                            sampled.logprobs)
    assert out["cuda"][:2] == out["cpu"][:2]
    for g, w in zip(out["cuda"][2], out["cpu"][2]):
        assert g[2] == w[2]                                 # top-2 ids
        torch.testing.assert_close(torch.tensor(g[0]), torch.tensor(w[0]),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch,head_dim", [("h2o_danube_1_8b", 80),
                                           ("recurrentgemma_2b", 256)])
def test_reduced_windowed_model_level_tokens_match_cpu(dev, arch, head_dim):
    """A reduced fp32 windowed decoder (window 64) at its published head
    dim at model level, on the card (the flash kernel's fp32 route at
    (head_dim, head_dim); the sampling kernel on sampled pages; ring
    decode is PyTorch) and on the CPU: prompts of 80 decoded past the
    window's wrap give identical greedy and sampled tokens, and no
    paged, MoE or scan kernel is launched."""
    cfg = dataclasses.replace(reduced_config(arch), dtype="float32",
                              head_dim=head_dim)
    params = TT.init_params(cfg, seed=12, device="cpu")
    gen = torch.Generator().manual_seed(12)
    prompts = torch.randint(2, cfg.vocab_size, (3, 80),
                            generator=gen).tolist()
    sps = [SamplingParams(),
           SamplingParams(temperature=0.8, top_k=20, seed=1),
           SamplingParams(temperature=1.1, top_p=0.9, seed=2, stop=(7,))]

    def to(tree, target):
        return {k: to(v, target) if isinstance(v, dict) else v.to(target)
                for k, v in tree.items()}

    out = {}
    for target in (dev, torch.device("cpu")):
        p = to(params, target)
        kernels.reset_launches()
        fa_ops.reset_routes()
        greedy = generate(cfg, p, prompts, [30, 3, 17])
        used = kernels.launches()
        sampled = generate(cfg, p, prompts, 30, sampling=sps)
        used_s = {k: v - used[k] for k, v in kernels.launches().items()}
        if target.type == "cuda":
            assert used["flash_attention"] == used_s["flash_attention"] > 0
            assert fa_ops.ROUTE_LAUNCHES["wgmma"] == 0
            assert used_s["fused_sampling"] > 0 == used["fused_sampling"]
            for name in ("paged_attention", "moe_gemm", "ssd_scan"):
                assert used[name] == used_s[name] == 0, name
        else:
            assert max(used.values()) == max(used_s.values()) == 0
        out[target.type] = (greedy.tokens, sampled.tokens)
    assert out["cuda"] == out["cpu"]


@pytest.mark.parametrize("arch,over", [
    ("whisper_base", dict(num_heads=4, num_kv_heads=4, head_dim=64)),
    ("pixtral_12b", dict(num_heads=8, num_kv_heads=2, head_dim=128))],
    ids=["whisper_base", "pixtral_12b"])
def test_reduced_encdec_vlm_model_level_tokens_match_cpu(dev, arch, over):
    """Reduced fp32 Whisper (32 stub frames, MHA of 64: G = 1) and Pixtral
    (8 stub patches, heads of 128: G = 4) at model level, on the card
    (the flash kernel's fp32 route, non-causal in Whisper's encoder and
    cross-attention; ``paged_attention`` for every decode attention; the
    sampling kernel on sampled pages) and on the CPU: identical greedy
    and sampled tokens, and no MoE or scan kernel."""
    cfg = dataclasses.replace(reduced_config(arch), dtype="float32", **over)
    params = TT.init_params(cfg, seed=17, device="cpu")
    gen = torch.Generator().manual_seed(17)
    prompts = torch.randint(2, cfg.vocab_size, (3, 24),
                            generator=gen).tolist()
    n = cfg.encoder_seq if cfg.family == "audio" else cfg.num_patches
    stub = torch.randn((3, n, cfg.d_model), generator=gen) * 0.02
    extra = {"frames" if cfg.family == "audio" else "patches": stub}
    sps = [SamplingParams(),
           SamplingParams(temperature=0.8, top_k=20, seed=1),
           SamplingParams(temperature=1.1, top_p=0.9, seed=2, stop=(7,))]

    def to(tree, target):
        return {k: to(v, target) if isinstance(v, dict) else v.to(target)
                for k, v in tree.items()}

    out = {}
    for target in (dev, torch.device("cpu")):
        p = to(params, target)
        kernels.reset_launches()
        fa_ops.reset_routes()
        greedy = generate(cfg, p, prompts, [30, 3, 17], **extra)
        used = kernels.launches()
        sampled = generate(cfg, p, prompts, 30, sampling=sps, **extra)
        used_s = {k: v - used[k] for k, v in kernels.launches().items()}
        if target.type == "cuda":
            for u in (used, used_s):
                assert u["flash_attention"] > 0 and u["paged_attention"] > 0
                assert u["moe_gemm"] == u["ssd_scan"] == 0
            assert fa_ops.ROUTE_LAUNCHES["wgmma"] == 0
            assert used_s["fused_sampling"] > 0 == used["fused_sampling"]
        else:
            assert max(used.values()) == max(used_s.values()) == 0
        out[target.type] = (greedy.tokens, sampled.tokens)
    assert out["cuda"] == out["cpu"]


# ---------------------------------------------------------------- training

# (tag, B, Sq, Skv, H, Hkv, D, causal, q offset)
BWD_CASES = [
    ("S100_ragged", 2, 100, 100, 4, 2, 64, True, 0),
    ("S1", 2, 1, 1, 4, 2, 64, True, 0),
    ("G1_D32", 1, 128, 128, 4, 4, 32, True, 0),
    ("G3_D32", 1, 96, 96, 6, 2, 32, True, 0),
    ("noncausal_Sq40_Skv130_D128", 2, 40, 130, 4, 2, 128, False, 0),
    ("offset_q_Sq64_Skv200_D64", 1, 64, 200, 8, 2, 64, True, 136),
    ("D128_S200", 1, 200, 200, 4, 1, 128, True, 0),
    # a key tile walks more q tiles than the ring has stages, over G = 3
    # heads, the last tile ragged
    ("ring_S1000_G3", 1, 1000, 1000, 6, 2, 64, True, 0),
    # a single key tile (the q rows continue after it) under many q tiles
    ("one_key_tile_Sq700_Skv48", 2, 700, 48, 4, 2, 64, True, 48),
    # D = 128 at the training length with G = 8: the register budget
    ("D128_S4096_G8", 1, 4096, 4096, 8, 1, 128, True, 0),
    # D = 256 (RecurrentGemma's 10 q heads on one kv head): the column
    # halves of dK/dV and dQ, ragged tiles, Sq != Skv
    ("D256_S300_G10", 2, 300, 300, 10, 1, 256, True, 0),
    ("noncausal_Sq40_Skv130_D256", 2, 40, 130, 4, 2, 256, False, 0),
    ("offset_q_Sq64_Skv200_D256", 1, 64, 200, 10, 1, 256, True, 136),
]


def _grad_tol(want, dtype):
    """fp32: summation order; bf16: one bf16 rounding of each gradient;
    both tied to the scale of the three gradients ``want`` (one of them
    may be ~0 throughout: at S = 1, dq and dk are 0 in exact arithmetic)."""
    scale = max(w.float().abs().max().item() for w in want)
    r = 1e-4 if dtype == torch.float32 else 2e-2
    return dict(atol=r * scale, rtol=r)


def _bwd_inputs(gen, dev, dtype, B, Sq, Skv, H, Hkv, D, causal, q0,
                Dv=None, q_scale=1.0, window=0, softcap=0.0):
    """q, k (head dim D), v (Dv, D when absent), positions, the plain
    forward's out and lse, and dout; q scaled by ``q_scale``."""
    Dv = D if Dv is None else Dv
    q = (_randn(gen, (B, Sq, H, D), torch.float32, dev) * q_scale).to(dtype)
    k = _randn(gen, (B, Skv, Hkv, D), dtype, dev)
    v = _randn(gen, (B, Skv, Hkv, Dv), dtype, dev)
    qp, kp = _pos(B, q0, Sq, dev), _pos(B, 0, Skv, dev)
    out, lse = fa_ops.flash.flash_attention(q, k, v, qp, kp, causal=causal,
                                            window=window, softcap=softcap,
                                            return_lse=True)
    dout = _randn(gen, (B, Sq, H, Dv), dtype, dev)
    return q, k, v, qp, kp, out, lse, dout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_flash_bwd_kernel_matches_plain(dev, case, dtype):
    _, B, Sq, Skv, H, Hkv, D, causal, q0 = case
    gen = torch.Generator(device=dev).manual_seed(31)
    args = _bwd_inputs(gen, dev, dtype, B, Sq, Skv, H, Hkv, D, causal, q0)
    got = flash_attention_bwd(*args, causal=causal)
    want = flash_attention_bwd_plain(*args, causal=causal)
    tol = _grad_tol(want, dtype)
    for g, w in zip(got, want):
        _close(g, w, dtype, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("m", [0, 1, 3])
def test_flash_at_a_seq_rank_matches_plain(dev, m, dtype):
    """The flash forward and backward at rank ``m`` of 4 of the ``seq``
    attention mode: the rank's q rows [256 m, 256 (m+1)) of S 1024 at
    their positions against every key (SmolLM-360M's 15 q heads on 5 kv
    heads, D 64, causal; rank 0's rows see a quarter of the keys, rank
    3's all), against the plain versions."""
    B, S, H, Hkv, D, tp = 2, 1024, 15, 5, 64, 4
    lo, hi = TT.seq_rows(S, m, tp)
    gen = torch.Generator(device=dev).manual_seed(37 + m)
    args = _bwd_inputs(gen, dev, dtype, B, hi - lo, S, H, Hkv, D, True, lo)
    q, k, v, qp, kp = args[:5]
    _close(flash_attention(q, k, v, qp, kp),
           flash_attention_plain(q, k, v, qp, kp), dtype)
    got = flash_attention_bwd(*args)
    want = flash_attention_bwd_plain(*args)
    tol = _grad_tol(want, dtype)
    for g, w in zip(got, want):
        _close(g, w, dtype, tol)
    # keys past the rank's last row get no gradient
    assert not got[1][:, hi:].any() and not got[2][:, hi:].any()


def test_flash_bwd_is_deterministic_and_routes_count(dev):
    gen = torch.Generator(device=dev).manual_seed(32)
    kernels.reset_launches()
    fb_ops.reset_routes()
    for dtype in (torch.bfloat16, torch.float32):
        args = _bwd_inputs(gen, dev, dtype, 2, 300, 300, 8, 2, 64, True, 0)
        a = flash_attention_bwd(*args)
        b = flash_attention_bwd(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert fb_ops.ROUTE_LAUNCHES == {"simt": 2, "wgmma": 2}
    assert kernels.launches()["flash_attention_bwd"] == 4


@pytest.mark.parametrize("D", [32, 128, 256])
def test_flash_bwd_bf16_gives_equal_bits_at_every_head_dim(dev, D):
    """Two launches of the wgmma route on the same inputs give the same
    bits at head dims 32, 128 and 256 too (64: the test above), causal over
    ragged tiles with G = 4."""
    gen = torch.Generator(device=dev).manual_seed(36)
    args = _bwd_inputs(gen, dev, torch.bfloat16, 2, 300, 300, 8, 2, D, True,
                       0)
    a = flash_attention_bwd(*args)
    b = flash_attention_bwd(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# MLA's (q/k 192, v 128): (tag, B, Sq, Skv, H, Hkv, causal, q offset,
# window, softcap); DeepSeek-R1 has as many kv heads as q heads
MLA_BWD_CASES = [
    ("S300_G1", 2, 300, 300, 4, 4, True, 0, 0, 0.0),
    ("S100_ragged_G2", 2, 100, 100, 4, 2, True, 0, 0, 0.0),
    ("S1", 2, 1, 1, 4, 4, True, 0, 0, 0.0),
    ("noncausal_Sq40_Skv130", 2, 40, 130, 4, 2, False, 0, 0, 0.0),
    ("offset_q_Sq64_Skv200", 1, 64, 200, 8, 8, True, 136, 0, 0.0),
    # a key tile walks more q tiles than the ring has stages
    ("ring_S1000", 1, 1000, 1000, 4, 4, True, 0, 0, 0.0),
    # the window and softcap instantiations at this pair
    ("S300_w96_cap30", 2, 300, 300, 4, 2, True, 0, 96, 30.0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", MLA_BWD_CASES,
                         ids=[c[0] for c in MLA_BWD_CASES])
def test_flash_bwd_at_mla_head_dims_matches_plain(dev, case, dtype):
    """The backward at q/k 192, v 128 (dq and dk 192 wide, dv 128) against
    its plain version, on the route of its type; two bf16 launches give
    equal bits."""
    _, B, Sq, Skv, H, Hkv, causal, q0, window, softcap = case
    gen = torch.Generator(device=dev).manual_seed(40)
    args = _bwd_inputs(gen, dev, dtype, B, Sq, Skv, H, Hkv, 192, causal, q0,
                       Dv=128, q_scale=4.0 if window else 1.0,
                       window=window, softcap=softcap)
    kw = dict(causal=causal, window=window, softcap=softcap)
    kernels.reset_launches()
    fb_ops.reset_routes()
    got = flash_attention_bwd(*args, **kw)
    assert fb_ops.ROUTE_LAUNCHES[fb_ops.route(dtype)] == 1
    assert kernels.launches()["flash_attention_bwd"] == 1
    assert [t.shape[-1] for t in got] == [192, 192, 128]
    want = flash_attention_bwd_plain(*args, **kw)
    tol = _grad_tol(want, dtype)
    for g, w in zip(got, want):
        _close(g, w, dtype, tol)
    if dtype == torch.bfloat16:
        again = flash_attention_bwd(*args, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_flash_bwd_max_len_at_mla_head_dims(dev):
    """The built library's length limit at (192, 128): the dQ walk's
    ranges of 32-key tiles bind; a pair without an instantiation gives
    0."""
    assert fb_ops.max_len(192, 128) == 253_536
    assert fb_ops.max_len(128) == 244_928
    assert fb_ops.max_len(192) == fb_ops.max_len(64, 32) == 0


def test_flash_under_autograd_at_mla_head_dims(dev):
    """FlashAttentionFn at (192, 128) on the card: the forward with lse and
    the backward kernel, gradients against autograd through the plain
    forward (fp32)."""
    gen = torch.Generator(device=dev).manual_seed(41)
    q, k = (_randn(gen, (2, 96, 4, 192), torch.float32, dev)
            for _ in range(2))
    v = _randn(gen, (2, 96, 4, 128), torch.float32, dev)
    g = _randn(gen, (2, 96, 4, 128), torch.float32, dev)
    pos = _pos(2, 0, 96, dev)
    kernels.reset_launches()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    flash_attention(*leaves, pos, pos).backward(g)
    used = kernels.launches()
    assert used["flash_attention"] == 1 and used["flash_attention_bwd"] == 1
    auto = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fa_ops.flash.flash_attention(*auto, pos, pos).backward(g)
    for a, b in zip(leaves, auto):
        _close(a.grad, b.grad, torch.float32,
               dict(atol=1e-4 * b.grad.abs().max().item(), rtol=1e-4))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("dims", fa_ops.HEAD_DIMS,
                         ids=[f"{a}_{b}" for a, b in fa_ops.HEAD_DIMS])
def test_flash_forward_writes_lse_on_both_routes(dev, dims, dtype):
    """The kernel's lse (natural-log units; the wgmma route converts its
    log2 running max) against the plain forward's, causal over a ragged
    tile and non-causal at Sq != Skv; out is unchanged by asking."""
    D, Dv = dims
    gen = torch.Generator(device=dev).manual_seed(33)
    for Sq, Skv, causal in ((200, 200, True), (40, 130, False)):
        q = _randn(gen, (2, Sq, 4, D), dtype, dev)
        k = _randn(gen, (2, Skv, 2, D), dtype, dev)
        v = _randn(gen, (2, Skv, 2, Dv), dtype, dev)
        qp, kp = _pos(2, Skv - Sq, Sq, dev), _pos(2, 0, Skv, dev)
        out, lse = fa_ops.flash_attention_lse(q, k, v, qp, kp, causal=causal)
        _, want = fa_ops.flash.flash_attention(q, k, v, qp, kp,
                                               causal=causal,
                                               return_lse=True)
        torch.cuda.synchronize()
        assert lse.dtype == torch.float32 and lse.shape == (2, Sq, 4)
        torch.testing.assert_close(lse, want, atol=1e-3 if dtype ==
                                   torch.bfloat16 else 1e-4, rtol=1e-4)
        assert torch.equal(out, flash_attention(q, k, v, qp, kp,
                                                causal=causal))


def test_flash_bwd_refuses_a_window_or_a_softcap_on_the_card(dev):
    """The card's backward takes a window and a softcap (the windowed
    cases below hold its values); it refuses D 160 (before the forward
    runs under autograd) and (q/k 64, v 32)."""
    gen = torch.Generator(device=dev).manual_seed(34)
    args = _bwd_inputs(gen, dev, torch.float32, 1, 64, 64, 4, 2, 64, True, 0)
    for kw in (dict(window=16), dict(softcap=30.0)):
        flash_attention_bwd(*args, **kw)
    q, k, v = (_randn(gen, (1, 64, h, 160), torch.bfloat16,
                      dev).requires_grad_(True) for h in (4, 1, 1))
    pos = _pos(1, 0, 64, dev)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, k, v, pos, pos, window=16, softcap=30.0)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_bwd(*args[:2], args[2][..., :32].contiguous(),
                            *args[3:])


# (D, window, softcap): Danube's head dim and window shape, the softcapped
# rows of phase 3, and both together
WINDOWED_BWD = [(D, w, c) for D in (64, 80, 128, 256)
                for w, c in ((96, 0.0), (0, 30.0), (96, 30.0))]


def _windowed_bwd_inputs(gen, dev, dtype, D, window, softcap, S=300, B=2,
                         H=8, Hkv=2):
    """q scaled so that the scores have a std of ~4: the softcap bites and
    the softmax leans on a few keys, so a window edge off by a tile moves
    the gradients."""
    q = (_randn(gen, (B, S, H, D), torch.float32, dev) * 4.0).to(dtype)
    k = _randn(gen, (B, S, Hkv, D), dtype, dev)
    v = _randn(gen, (B, S, Hkv, D), dtype, dev)
    pos = _pos(B, 0, S, dev)
    out, lse = fa_ops.flash.flash_attention(q, k, v, pos, pos, causal=True,
                                            window=window, softcap=softcap,
                                            return_lse=True)
    dout = _randn(gen, (B, S, H, D), dtype, dev)
    return q, k, v, pos, pos, out, lse, dout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("D,window,softcap", WINDOWED_BWD,
                         ids=[f"D{d}_w{w}_cap{int(c)}"
                              for d, w, c in WINDOWED_BWD])
def test_flash_bwd_windowed_softcapped_matches_plain(dev, D, window, softcap,
                                                     dtype):
    gen = torch.Generator(device=dev).manual_seed(37 + D)
    args = _windowed_bwd_inputs(gen, dev, dtype, D, window, softcap)
    kw = dict(causal=True, window=window, softcap=softcap)
    fb_ops.reset_routes()
    got = flash_attention_bwd(*args, **kw)
    want = flash_attention_bwd_plain(*args, **kw)
    assert fb_ops.ROUTE_LAUNCHES[fb_ops.route(dtype)] == 1
    tol = _grad_tol(want, dtype)
    for g, w in zip(got, want):
        _close(g, w, dtype, tol)
    if window:      # the check sees a window edge one tile off
        wrong = flash_attention_bwd_plain(*args, causal=True,
                                          window=window + 64,
                                          softcap=softcap)
        assert any(not torch.allclose(w.float(), x.float(), **tol)
                   for w, x in zip(want, wrong))


@pytest.mark.parametrize("D", [64, 80, 128, 256])
def test_flash_bwd_windowed_gives_equal_bits(dev, D):
    gen = torch.Generator(device=dev).manual_seed(38)
    args = _windowed_bwd_inputs(gen, dev, torch.bfloat16, D, 96, 30.0)
    a = flash_attention_bwd(*args, window=96, softcap=30.0)
    b = flash_attention_bwd(*args, window=96, softcap=30.0)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _gemm_layout(gen, dev, dtype, experts, block_t, D, F, E):
    be = torch.tensor(experts, dtype=torch.int32, device=dev)
    x = _randn(gen, (len(experts) * block_t, D), dtype, dev)
    w = (0.1 * torch.randn((E, D, F), generator=gen, device=dev)).to(dtype)
    return x, w, be


# (experts of the blocks, block_t, D, F, E): the training layout (block_t
# 128, wgmma for the forward and dX), decode's block_t 16 (mma), ragged D
# and F, empty experts and unused blocks
GEMM_GRAD_CASES = [
    ([0, 0, 1, 3, 3, 3, -1, -1], 128, 256, 192, 5),
    ([2, 0, 0, 1, -1], 16, 72, 100, 4),
    ([1, 1, 1, 0, -1], 64, 128, 64, 3),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", GEMM_GRAD_CASES,
                         ids=[f"bt{c[1]}_D{c[2]}_F{c[3]}"
                              for c in GEMM_GRAD_CASES])
def test_grouped_gemm_fn_matches_plain_autograd(dev, case, dtype):
    """GroupedGemmFn on the card (forward and dX by the grouped GEMM, dW by
    its weight-gradient kernel) against autograd through the plain version
    on the card; atol scaled by each tensor's largest element."""
    experts, bt, D, F, E = case
    gen = torch.Generator(device=dev).manual_seed(39)
    x, w, be = _gemm_layout(gen, dev, dtype, experts, bt, D, F, E)
    g = _randn(gen, (x.shape[0], F), dtype, dev)

    def run(fn):
        tx, tw = (t.clone().requires_grad_(True) for t in (x, w))
        y = fn(tx, tw, be, block_t=bt)
        y.backward(g)
        return y.detach(), tx.grad, tw.grad

    kernels.reset_launches()
    wgrad_ops.reset_routes()
    got = run(grouped_gemm)
    used = kernels.launches()
    assert used["moe_gemm"] == 2 and used["moe_gemm_wgrad"] == 1
    assert wgrad_ops.ROUTE_LAUNCHES[wgrad_ops.route(dtype, bt, D, F,
                                                    True)] == 1
    want = run(grouped_gemm_plain)
    for a, b in zip(got, want):
        scale = b.float().abs().max().item()
        _close(a, b, dtype, dict(atol=TOL[dtype]["atol"] * max(scale, 1.0),
                                 rtol=TOL[dtype]["rtol"]))
    unused = (be < 0).repeat_interleave(bt)
    assert not got[1][unused].any()
    for e in set(range(E)) - set(experts):
        assert not got[2][e].any()


def test_grouped_gemm_wgrad_gives_equal_bits(dev):
    gen = torch.Generator(device=dev).manual_seed(40)
    for dtype in (torch.bfloat16, torch.float32):
        x, _, be = _gemm_layout(gen, dev, dtype, [0, 0, 2, 2, 2, -1], 128,
                                512, 384, 4)
        dy = _randn(gen, (x.shape[0], 384), dtype, dev)
        a = grouped_gemm_wgrad(x, dy, be, 4, block_t=128)
        b = grouped_gemm_wgrad(x, dy, be, 4, block_t=128)
        torch.cuda.synchronize()
        assert torch.equal(a, b)
        want = grouped_gemm_wgrad_plain(x, dy, be, 4, block_t=128)
        scale = want.float().abs().max().item()
        _close(a, want, dtype, dict(atol=TOL[dtype]["atol"] * scale,
                                    rtol=TOL[dtype]["rtol"]))


# (experts of the blocks, block_t, M, N, E): the weight gradient's wgmma
# route at ragged widths (M and N multiples of 8, not of 64; M 72 leaves the
# second warpgroup's rows past M), empty experts, unused blocks, one
# expert's blocks apart, more k-tiles than ring stages, Qwen3's widths
WGRAD_CASES = [
    ([0, 0, 1, 3, 3, 3, -1, -1], 128, 256, 512, 5),
    ([1, 1, 1, 0, -1], 64, 128, 64, 3),
    ([0, 2, 0, 1, 2], 64, 200, 136, 3),
    ([2, 0, 0, 2, -1], 128, 72, 264, 4),
    ([0] * 40, 64, 768, 2048, 2),
    ([4, 9, 9, 0, -1, -1], 128, 2048, 768, 16),
]


@pytest.mark.parametrize("case", WGRAD_CASES,
                         ids=[f"bt{c[1]}_M{c[2]}_N{c[3]}_E{c[4]}"
                              for c in WGRAD_CASES])
def test_wgrad_wgmma_matches_plain(dev, case):
    experts, bt, M, N, E = case
    gen = torch.Generator(device=dev).manual_seed(41)
    be = torch.tensor(experts, dtype=torch.int32, device=dev)
    x = _randn(gen, (len(experts) * bt, M), torch.bfloat16, dev)
    dy = _randn(gen, (len(experts) * bt, N), torch.bfloat16, dev)
    wgrad_ops.reset_routes()
    got = grouped_gemm_wgrad(x, dy, be, E, block_t=bt)
    again = grouped_gemm_wgrad(x, dy, be, E, block_t=bt)
    torch.cuda.synchronize()
    assert wgrad_ops.ROUTE_LAUNCHES == {"wgmma": 2, "mma": 0, "simt": 0}
    assert torch.equal(got, again)
    want = grouped_gemm_wgrad_plain(x, dy, be, E, block_t=bt)
    scale = want.float().abs().max().item()
    _close(got, want, torch.bfloat16, dict(atol=2e-2 * scale, rtol=2e-2))
    for e in set(range(E)) - set(experts):
        assert not got[e].any()


def test_wgrad_routes_count_and_refuse_what_they_cannot_take(dev):
    """Each launch counts on the route ``route()`` names (wgmma at block_t
    128, mma at block_t 16 and for a base TMA cannot read, simt for fp32),
    each in the kernel's total too; a launch on a route the call cannot
    take raises and runs nothing else."""
    gen = torch.Generator(device=dev).manual_seed(42)
    T, M, N, E, bt = 128 * 6, 512, 384, 4, 128
    x = _randn(gen, (T, M), torch.bfloat16, dev)
    dy = _randn(gen, (T, N), torch.bfloat16, dev)
    be = torch.tensor([0, 0, 2, 2, 2, -1], dtype=torch.int32, device=dev)
    be16 = be.repeat_interleave(bt // 16).contiguous()
    flat = torch.empty((T * M + 1,), dtype=torch.bfloat16, device=dev)
    shifted = flat[1:].view(T, M)
    shifted.copy_(x)
    kernels.reset_launches()
    wgrad_ops.reset_routes()
    outs = [grouped_gemm_wgrad(x, dy, be, E, block_t=bt),
            grouped_gemm_wgrad(x, dy, be16, E, block_t=16),
            grouped_gemm_wgrad(shifted, dy, be, E, block_t=bt)]
    grouped_gemm_wgrad(x.float(), dy.float(), be, E, block_t=bt)
    torch.cuda.synchronize()
    assert wgrad_ops.ROUTE_LAUNCHES == {"wgmma": 1, "mma": 2, "simt": 1}
    assert kernels.launches()["moe_gemm_wgrad"] == 4
    want = grouped_gemm_wgrad_plain(x, dy, be, E, block_t=bt)
    scale = want.float().abs().max().item()
    for got in outs:
        _close(got, want, torch.bfloat16, dict(atol=2e-2 * scale, rtol=2e-2))
    lib = wgrad_ops._lib()
    for args, r in (((x, dy, be16, E, 16), "wgmma"),
                    ((shifted, dy, be, E, bt), "wgmma"),
                    ((x[:, :100].contiguous(), dy, be, E, bt), "wgmma"),
                    ((x.float(), dy.float(), be, E, bt), "mma"),
                    ((x.float(), dy.float(), be, E, bt), "wgmma"),
                    ((x, dy, be, E, bt), "simt")):
        with pytest.raises(RuntimeError, match=f"{r} route"):
            wgrad_ops.launch(lib, *args, r)


def test_wgrad_ab_against_itself(dev):
    """The A/B tool for the weight gradient (``--kernel moe_gemm_wgrad``):
    at phase 3's two training shapes, on the wgmma route, equal bits, each
    side held to the plain version, positive readings."""
    from repro_torch.launch import flash_ab
    rows = flash_ab.compare(Path(__file__).resolve().parents[1],
                            kernel="moe_gemm_wgrad")
    assert [r["shape"].split(" rows")[0] for r in rows] == [
        label for label, *_ in flash_ab.WGRAD_SHAPES]
    for r in rows:
        assert r["shape"].endswith("(wgmma)")
        assert r["max_abs_diff"] == 0.0
        assert r["this_plain_err"] == r["other_plain_err"]
        assert len(r["this_kernel_ms"]) == len(r["other_kernel_ms"]) == 2
        assert min(r["this_ms"] + r["other_ms"] + r["this_kernel_ms"]
                   + r["other_kernel_ms"]) > 0


@pytest.mark.parametrize("arch", ["qwen3_moe_30b", "h2o_danube_1_8b"])
def test_reduced_moe_and_windowed_forward_loss_on_the_card_matches_cpu(
        dev, arch):
    """Reduced fp32 Qwen3-30B-A3B (the grouped GEMM's forward, dX and dW
    kernels) and H2O-Danube-1.8B (window 64, S 160: the windowed backward
    kernel): the loss and every leaf's gradient on the card against the
    CPU's plain versions."""
    from repro_torch import optim
    from repro_torch.launch.steps import loss_and_grads
    cfg = dataclasses.replace(reduced_config(arch), dtype="float32")
    cpu = TT.init_params(cfg, 0, "cpu")
    cuda = optim.tree_map(lambda t: t.to(dev), cpu)
    gen = torch.Generator().manual_seed(41)
    toks = torch.randint(2, cfg.vocab_size, (2, 160), generator=gen,
                         dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks}
    want_l, want_g = loss_and_grads(cfg, cpu, batch)
    kernels.reset_launches()
    got_l, got_g = loss_and_grads(cfg, cuda, {k: t.to(dev)
                                              for k, t in batch.items()})
    torch.cuda.synchronize()
    used = kernels.launches()
    assert used["flash_attention_bwd"] == cfg.num_layers
    if cfg.is_moe:
        assert used["moe_gemm"] == 9 * cfg.num_layers
        assert used["moe_gemm_wgrad"] == 3 * cfg.num_layers
    torch.testing.assert_close(got_l.cpu(), want_l, rtol=1e-5, atol=0)
    for g, w in zip(optim.tree_leaves(got_g), optim.tree_leaves(want_g)):
        torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("head_dim", [32, 256])
def test_reduced_hybrid_forward_loss_on_the_card_matches_cpu(dev, head_dim):
    """Reduced fp32 RecurrentGemma-2B (1 unit + 2 tail layers, window 64,
    softcap 30, S 160) at head dim 32 and at its published 256: the loss
    and every leaf's gradient on the card (the flash forward twice and
    its backward once for the one attention sublayer; the RG-LRU scan's
    backward is PyTorch) against the CPU's plain versions."""
    from repro_torch import optim
    from repro_torch.launch.steps import loss_and_grads
    cfg = dataclasses.replace(reduced_config("recurrentgemma_2b"),
                              dtype="float32", head_dim=head_dim)
    cpu = TT.init_params(cfg, 0, "cpu")
    cuda = optim.tree_map(lambda t: t.to(dev), cpu)
    gen = torch.Generator().manual_seed(43)
    toks = torch.randint(2, cfg.vocab_size, (2, 160), generator=gen,
                         dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks}
    want_l, want_g = loss_and_grads(cfg, cpu, batch)
    kernels.reset_launches()
    got_l, got_g = loss_and_grads(cfg, cuda, {k: t.to(dev)
                                              for k, t in batch.items()})
    torch.cuda.synchronize()
    used = {k: n for k, n in kernels.launches().items() if n}
    assert used == {"flash_attention": 2, "flash_attention_bwd": 1}, used
    torch.testing.assert_close(got_l.cpu(), want_l, rtol=1e-5, atol=0)
    for g, w in zip(optim.tree_leaves(got_g), optim.tree_leaves(want_g)):
        torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=1e-3)


def test_reduced_forward_loss_on_the_card_matches_cpu(dev):
    """Reduced fp32 SmolLM-360M (2 layers, heads of 32): the loss and the
    gradient of every leaf on the card (flash forward with lse and the
    backward kernel) against the CPU's plain versions; remat launches the
    forward twice a layer and the backward once."""
    from repro_torch import optim
    from repro_torch.launch.steps import loss_and_grads
    cfg = dataclasses.replace(reduced_config("smollm_360m"), dtype="float32")
    cpu = TT.init_params(cfg, 0, "cpu")
    cuda = optim.tree_map(lambda t: t.to(dev), cpu)
    gen = torch.Generator().manual_seed(35)
    toks = torch.randint(2, cfg.vocab_size, (2, 96), generator=gen,
                         dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks}
    want_l, want_g = loss_and_grads(cfg, cpu, batch)
    kernels.reset_launches()
    fb_ops.reset_routes()
    got_l, got_g = loss_and_grads(cfg, cuda, {k: t.to(dev)
                                              for k, t in batch.items()})
    torch.cuda.synchronize()
    used = kernels.launches()
    assert used["flash_attention"] == 2 * cfg.num_layers
    assert used["flash_attention_bwd"] == cfg.num_layers
    assert fb_ops.ROUTE_LAUNCHES == {"simt": cfg.num_layers, "wgmma": 0}
    torch.testing.assert_close(got_l.cpu(), want_l, rtol=1e-5, atol=0)
    for g, w in zip(optim.tree_leaves(got_g), optim.tree_leaves(want_g)):
        torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=1e-3)


# ------------------------------------------------ the multi-GPU path's shapes
# A rank's attention at tp 8: Llama-3.2-1B's 32 q heads over 8 kv heads
# give H 4 over Hkv 1 at D 64; Qwen3-30B-A3B's 32 over 4 (kv replicated,
# rank m on kv head m // 2) H 4 over Hkv 1 at D 128.
TP8_FLASH = [("llama_tp8_D64", 2, 1024, 4, 1, 64),
             ("qwen3_tp8_D128", 2, 1024, 4, 1, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", TP8_FLASH, ids=[c[0] for c in TP8_FLASH])
def test_flash_at_the_tp8_head_shards(dev, case, dtype):
    """Forward and backward at a rank's head shard against the plain
    versions (the backward's tolerance as ``test_flash_bwd_kernel_matches
    _plain``'s)."""
    _, B, S, H, Hkv, D = case
    gen = torch.Generator(device=dev).manual_seed(41)
    args = _bwd_inputs(gen, dev, dtype, B, S, S, H, Hkv, D, True, 0)
    q, k, v, qp, kp = args[:5]
    _close(flash_attention(q, k, v, qp, kp),
           flash_attention_plain(q, k, v, qp, kp), dtype)
    got = flash_attention_bwd(*args)
    want = flash_attention_bwd_plain(*args)
    tol = _grad_tol(want, dtype)
    for g, w in zip(got, want):
        _close(g, w, dtype, tol)


def test_moe_gemm_on_a_ranks_16_experts(dev):
    """One rank (m 3 of tp 8) of Qwen3-30B-A3B's expert-parallel MoE: its
    dispatch of 512 tokens' top-8 choices over the 16 local experts of
    (D 2048, F 768), most of the choices another rank's, through the
    grouped GEMM (bf16, wgmma at block_t 64 and up) against the plain
    version on the same plan, and under autograd (dX by the kernel, dW by
    ``moe_gemm_wgrad``) against autograd through the plain version."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("qwen3_moe_30b")
    gen = torch.Generator(device=dev).manual_seed(43)
    T, D, F, E, tp, m = 512, cfg.d_model, cfg.moe_d_ff, cfg.num_experts, 8, 3
    El = E // tp
    xt = _randn(gen, (T, D), torch.bfloat16, dev)
    wg = torch.randn((D, E), generator=gen, device=dev) / D ** 0.5
    _, ids, _ = moe._route_terms(cfg, wg, xt)
    flat = ids.reshape(-1)
    local = torch.where((flat >= m * El) & (flat < (m + 1) * El),
                        flat - m * El, El)
    bt = moe_ops.pick_block_t(T * cfg.experts_per_token, E)
    plan = moe_ops.dispatch_plan(local, El, bt,
                                 capacity=moe.expert_capacity(cfg, T))
    assert 0 < int(plan.keep.sum()) < flat.numel() // 4
    tok = torch.arange(T, device=dev).repeat_interleave(cfg.experts_per_token)
    xs = moe_ops.gather_rows(xt, plan, tok)
    w = (0.02 * torch.randn((El, D, F), generator=gen, device=dev)) \
        .to(torch.bfloat16)
    moe_ops.reset_routes()
    got = grouped_gemm(xs, w, plan.block_expert, block_t=bt)
    want = grouped_gemm_plain(xs, w, plan.block_expert, block_t=bt)
    _close(got, want, torch.bfloat16)
    assert moe_ops.ROUTE_LAUNCHES[moe_ops.route(torch.bfloat16, bt, D, F,
                                                True)] == 1
    xa = xs.clone().requires_grad_(True)
    wa = w.clone().requires_grad_(True)
    dy = _randn(gen, got.shape, torch.bfloat16, dev)
    dx, dw = torch.autograd.grad(
        grouped_gemm(xa, wa, plan.block_expert, block_t=bt), (xa, wa), dy)
    xp = xs.float().requires_grad_(True)
    wp = w.float().requires_grad_(True)
    pdx, pdw = torch.autograd.grad(
        grouped_gemm_plain(xp, wp, plan.block_expert, block_t=bt), (xp, wp),
        dy.float())
    _close(dx, pdx.to(torch.bfloat16), torch.bfloat16,
           _grad_tol([pdx], torch.bfloat16))
    _close(dw, pdw.to(torch.bfloat16), torch.bfloat16,
           _grad_tol([pdw], torch.bfloat16))


def test_nccl_at_world_size_one_through_collectives(dev):
    """A real NCCL process group of one rank on the card, the (1, 1) mesh
    realized over it: every collective of ``distributed/collectives.py``
    sent through NCCL (``skip_one=False``) returns its input, the
    conjugate pairs pass values and gradients through, and the events
    count nowhere (a group of one); with ``skip_one`` (the default) the
    calls return their input itself."""
    import socket

    import torch.distributed as dist

    from repro_torch.distributed import collectives as C
    from repro_torch.launch import mesh as mesh_lib
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = mesh_lib.Mesh(("data", "model"), (1, 1)).realize("cuda")
        assert mesh.coords == {"data": 0, "model": 0}
        C.reset_events()
        for base in (mesh.comm.world, mesh.comm.model, mesh.comm.data):
            g = dataclasses.replace(base, skip_one=False)
            x = torch.arange(24.0, device=dev).reshape(6, 4)
            for fn in (g.all_reduce, g.all_gather, g.reduce_scatter,
                       g.all_to_all):
                y = fn(x)
                torch.cuda.synchronize()
                assert y is not x and torch.equal(y, x)
            assert torch.equal(g.all_reduce(x, "max"), x)
            xr = x.clone().requires_grad_(True)
            out = g.reduce_out(g.copy_in(xr) * 2.0)
            (dx,) = torch.autograd.grad(out.sum(), xr)
            assert torch.equal(out, 2 * x) and torch.equal(dx, 2 * torch.ones_like(x))
            assert base.all_reduce(x) is x and base.copy_in(x) is x
        assert len(C.EVENTS) == 3 * 7
        assert C.collective_stats()["counts"] == {}
    finally:
        dist.destroy_process_group()


def _train_record(args, path, timeout=600):
    """What a ``launch/train.py`` run saves with ``--sample-params``: each
    step's loss and grad norm and the samples of the full parameters
    before the first step and after each (rank 0's under torchrun)."""
    import os
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=str(
        Path(__file__).resolve().parents[1] / "src"))
    out = subprocess.run([sys.executable] + args
                         + ["--sample-params", str(path)], env=env,
                         timeout=timeout, capture_output=True, text=True)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return torch.load(path)


# Bounds of the multi-card run against one card, each from the readings
# of four H100s (PERF.md; Qwen3-30B-A3B at tp 4, the larger of the
# two cases) with its margin: the relative gaps of the loss and the grad
# norm at step 0, from the same weights (read 3.1e-7 and 1.9e-7: x10),
# and at steps 1-2 (read 1.2e-4 and 1.3e-3: x4 and x8), and the largest
# share of a leaf's sampled elements that stand more than lr / 2 apart
# after the first update (read 7.3e-4: x14) and after the later ones,
# which drift (read 4.0e-2 and 8.8e-2: x2.3).  A stale or misplaced gather
# of one rank's part leaves a quarter of a leaf an update (~lr) away.
SHARDED_BOUNDS = {"loss0": 3e-6, "gnorm0": 2e-6, "loss": 5e-4,
                  "gnorm": 1e-2, "moved0": 1e-2, "moved": 0.2}
# SmolLM-360M's cases (the seq mode over (1, cards), fsdp over every card),
# from two equal readings of four H100s (PERF.md): a dense model drifts
# less, so its bounds are tighter: loss gaps read 8.4e-8 at step 0 and
# 1.7e-7 after (x12), grad norm gaps 0 at step 0 and 3.3e-6 after (x12,
# and 1e-6 where 0 was read), no sampled element lr / 2 away after any
# update (the bound stays 1e-2: a stale or misplaced gather moves a
# quarter of a leaf)
SMOLLM_BOUNDS = {"loss0": 1e-6, "gnorm0": 1e-6, "loss": 2e-6, "gnorm": 4e-5,
                 "moved0": 1e-2, "moved": 1e-2}


# the config cuts of a four-card case beside its 2 layers: DeepSeek-R1 at 8
# of its 256 experts (its fp32 weights, gradients, master and moments at 2
# layers: 60 GB on the one card it is held to; phase 17's 16 would be 74.5);
# RecurrentGemma-2B at 3 layers, one unit (RG-LRU, RG-LRU, local
# attention), so that its attention runs (2 layers are 2 tail RG-LRUs)
CUTS = {"deepseek_r1": ["--experts", "8"],
        "recurrentgemma_2b": ["--layers", "3"]}


@pytest.mark.parametrize("arch,dp,regime", [
    ("qwen3_moe_30b", 1, "tp"), ("llama3_2_1b", 2, "tp"),
    ("smollm_360m", 1, "tp"), ("smollm_360m", 1, "fsdp"),
    ("qwen3_moe_30b", 1, "fsdp"), ("deepseek_r1", 1, "tp"),
    ("pixtral_12b", 1, "tp"), ("mamba2_370m", 1, "tp"),
    ("recurrentgemma_2b", 1, "tp"), ("whisper_base", 1, "tp")],
    ids=["qwen3_tp_all_cards", "llama_dp2_tp_rest", "smollm_seq_all_cards",
         "smollm_fsdp_all_cards", "qwen3_fsdp_all_cards", "deepseek_tp",
         "pixtral_tp", "mamba_tp", "recurrentgemma_tp", "whisper_tp"])
def test_sharded_training_over_every_card(dev, arch, dp, regime, tmp_path):
    """``launch/train.py`` under torchrun over every card of the machine
    (NCCL), at every published width with 2 layers in fp32, 3 steps of 4 x
    1024 tokens, against the same command on one card: Qwen3-30B-A3B over
    a model axis of all the cards (tensor and expert parallelism, kv
    replicated past 4 cards), Llama-3.2-1B over (2, cards / 2) in 2
    microbatches (data parallelism: the MoE's capacity and aux are per
    data shard, as the reference's, so only a dense model equals one
    card there); SmolLM-360M over a model axis of all the cards in the
    ``seq`` attention mode (its 15 q heads split over none of 2, 4 or 8)
    and in the ``fsdp`` regime (``tests/torch_fsdp_worker.py``: ZeRO-3
    over every card, the batch over every card), and Qwen3-30B-A3B in the
    ``fsdp`` regime (its MoE routing the cards' rows as one batch, as one
    card routes the whole batch); DeepSeek-R1 (MLA, 8 experts and its
    shared expert, ``CUTS``) and Pixtral-12B (its 1024 patches before the
    1024 tokens) over a model axis of all the cards; Mamba2-370M (its
    channels and heads over the cards, the gated norm's mean square
    all-reduced), RecurrentGemma-2B (one unit, ``CUTS``: its RG-LRU
    channels and gate blocks over the cards, its 10 attention heads in
    the ``seq`` mode at 4 or 8) and Whisper-base (2 decoder layers beside
    its 6 encoder layers, 1536 stub frames a row) over a model axis of
    all the cards.  Each rank draws its
    slices of the weights
    (``init_params`` with ``part``): the sampled parameters before the
    first step equal one card's in bits.  Loss and grad norm within
    ``SHARDED_BOUNDS`` (relative; step 0 from the same weights, the
    later steps drift: AdamW moves an element whose gradient is ~0 by ~lr
    either way, and a router choice near a tie flips with the summation
    order), and after each update at most ``SHARDED_BOUNDS["moved0"]``
    (the first) or ``["moved"]`` (the later) of every leaf's sampled
    elements more than lr / 2 from one card's; SmolLM-360M's cases within
    ``SMOLLM_BOUNDS``.  The readings are
    printed.  Skips with fewer than two cards."""
    import json
    n = torch.cuda.device_count()
    if n < 2 or n % dp:
        pytest.skip(f"needs two or more cards (has {n})")
    common = ["-m", "repro_torch.launch.train", "--arch", arch, "--layers",
              "2", "--dtype", "float32", "--steps", "3", "--batch", "4",
              "--seq", "1024", "--microbatches", str(dp)] + CUTS.get(arch, [])
    want = _train_record(common, tmp_path / "one.pt")
    run = ["-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={n}"]
    if regime == "fsdp":
        got = _train_record(run + [str(Path(__file__).resolve().parent
                                       / "torch_fsdp_worker.py")]
                            + common[2:], tmp_path / "all.pt")
    else:
        got = _train_record(run + common + ["--tp", str(n // dp)],
                            tmp_path / "all.pt")
    lr = 1e-3
    assert len(want["loss"]) == len(got["loss"]) == 3
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    gaps = {"loss": [rel(a, b) for a, b in zip(got["loss"], want["loss"])],
            "gnorm": [rel(a, b) for a, b in
                      zip(got["grad_norm"], want["grad_norm"])],
            "moved": [], "max_abs": []}
    for s in range(1, 4):
        g, w = got["params"][s], want["params"][s]
        assert g.keys() == w.keys()
        gaps["moved"].append(max(
            ((g[k] - w[k]).abs() > lr / 2).float().mean().item() for k in w))
        gaps["max_abs"].append(max((g[k] - w[k]).abs().max().item()
                                   for k in w))
    print(json.dumps({"sharded_training": {"arch": arch, "cards": n,
                                           "dp": dp, "regime": regime,
                                           "gaps": gaps}}))
    for k, w in want["params"][0].items():
        assert torch.equal(got["params"][0][k], w), k
    b = SMOLLM_BOUNDS if arch == "smollm_360m" else SHARDED_BOUNDS
    assert gaps["loss"][0] <= b["loss0"], gaps
    assert gaps["gnorm"][0] <= b["gnorm0"], gaps
    assert max(gaps["loss"][1:]) <= b["loss"], gaps
    assert max(gaps["gnorm"][1:]) <= b["gnorm"], gaps
    assert gaps["moved"][0] <= b["moved0"], gaps
    assert max(gaps["moved"][1:]) <= b["moved"], gaps


# Bound of the first decode step's logits over every card against one
# card's, relative to their largest magnitude (fp32, Llama-3.2-1B at
# every published width, 2 layers), from the readings of four H100s
# (PERF.md: 2.76e-6 over (1, 4), 2.43e-6 over (2, 2)) with a margin of
# ten: the sums' order moves a logit by a few ulps of the largest; a
# shard merged with a wrong weight or a stale position moves it by the
# value's scale
SERVING_LOGITS_BOUND = 3e-5


def _serve_record(args, path, nproc=0, timeout=600):
    """What ``tests/torch_serve_worker.py`` saves: one process, or
    ``nproc`` under ``torch.distributed.run``."""
    import os
    import subprocess
    import sys
    here = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(here.parent / "src"))
    cmd = [sys.executable]
    if nproc:
        cmd += ["-m", "torch.distributed.run", "--standalone",
                f"--nproc-per-node={nproc}"]
    cmd += [str(here / "torch_serve_worker.py"), str(path)] + args
    out = subprocess.run(cmd, env=env, timeout=timeout, capture_output=True,
                         text=True)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return torch.load(path)


def test_sharded_serving_over_every_card(dev, tmp_path):
    """``build_cell``'s prefill and decode cells over every card of the
    machine (NCCL, ``tests/torch_serve_worker.py`` under torchrun): fp32
    Llama-3.2-1B at every published width with 2 layers, 4 prompts of 1024
    tokens into a cache of 4096, then 16 greedy steps, over (1, cards)
    (the cache's sequence over every card) and (2, cards / 2), against the
    one-device ``prefill`` and ``decode_step`` on one card: every token
    equal, the first step's logits within ``SERVING_LOGITS_BOUND`` of
    their scale; the same for Qwen2-0.5B over (1, cards),
    whose 14 q heads over 4 or 8 cards prefill in the ``seq`` attention
    mode (each rank's q rows against every key, the cache's block kept
    without an all-to-all).  With four cards or more it then reads the bf16 decode
    cell at its real size over (1, cards): Llama-3.2-1B at full depth at
    ``decode_32k`` (B 128 x 32768, 34.4 GB of cache a rank at four) and
    Qwen3-30B-A3B at full depth (48 layers) at B 32 x 32768, 16 steps
    each: ms a step, tokens/s, peaks and one step's collectives, printed
    as one JSON line each.  Skips with fewer than two cards."""
    import json
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two or more cards (has {n})")
    gaps = {}
    for arch, datas in (("llama3_2_1b", (1, 2)), ("qwen2_0_5b", (1,))):
        common = ["--arch", arch]
        want = _serve_record(common, tmp_path / f"{arch}_one.pt")
        scale = want["logits0"].abs().max().item()
        for data in datas:
            got = _serve_record(common + ["--data", str(data)],
                                tmp_path / f"{arch}_d{data}.pt", nproc=n)
            gaps[f"{arch} ({data}, {n // data})"] = dict(
                tokens_equal=bool(torch.equal(got["tokens"],
                                              want["tokens"])),
                logits_gap=(got["logits0"] - want["logits0"]).abs().max()
                .item() / scale)
    print(json.dumps({"sharded_serving": {"cards": n, "gaps": gaps}}))
    for g in gaps.values():
        assert g["tokens_equal"], gaps
        assert g["logits_gap"] <= SERVING_LOGITS_BOUND, gaps
    if n < 4:
        return
    for arch, layers, B in (("llama3_2_1b", 0, 128),
                            ("qwen3_moe_30b", 0, 32)):
        rec = _serve_record(["--mode", "bench", "--arch", arch, "--layers",
                             str(layers), "--dtype", "bfloat16", "--batch",
                             str(B), "--seq", "32768"],
                            tmp_path / f"{arch}.pt", nproc=n)
        print(json.dumps({"sharded_serving_bf16": rec}))
        assert rec["final_lengths_ok"]
        assert rec["paged_launches_by_route"]["simt"] == 0
        assert rec["paged_launches_by_route"]["mma"] == 16 * rec["layers"]


# the attention families' serving cases over (1, cards): (arch, the
# worker's arguments beside fp32 and 2 layers); then the recurrent and
# encoder-decoder families': Mamba2-370M over its channels, RecurrentGemma-2B
# at one unit with a prompt of 2560 (its window of 2048 wrapped) into a
# ring of 2048 slots, Whisper-base 32 tokens into 448 over 1536 frames
ATTN_SERVING = (("deepseek_r1", ["--experts", "16"]),
                ("pixtral_12b", []),
                ("h2o_danube_1_8b", ["--seq", "5120", "--max-len", "8192"]),
                ("mamba2_370m", []),
                ("recurrentgemma_2b", ["--layers", "3", "--seq", "2560"]),
                ("whisper_base", ["--seq", "32", "--max-len", "448"]))


def test_attention_families_serving_over_every_card(dev, tmp_path):
    """``build_cell``'s prefill and decode cells over (1, cards) as
    ``test_sharded_serving_over_every_card``'s, fp32 at every published
    width with 2 layers, against the one-device ``prefill`` and
    ``decode_step`` on one card: DeepSeek-R1 (16 of its 256 experts) over
    its latent cache, Pixtral-12B with 1024 patches before its 1024
    tokens, H2O-Danube-1.8B with a prompt of 5120 (its window of 4096
    wrapped) into a ring of 4096 slots over the cards; Mamba2-370M (its
    states and convolutions over the cards), RecurrentGemma-2B (one unit,
    a prompt of 2560 wrapping its ring of 2048 slots) and Whisper-base
    (its self and cross caches over the cards).  Every token equal, the
    first step's logits within ``SERVING_LOGITS_BOUND`` of their scale.
    Skips with fewer than two cards."""
    import json
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two or more cards (has {n})")
    gaps = {}
    for arch, extra in ATTN_SERVING:
        common = ["--arch", arch, "--layers", "2"] + extra
        want = _serve_record(common, tmp_path / f"{arch}_one.pt")
        scale = want["logits0"].abs().max().item()
        got = _serve_record(common, tmp_path / f"{arch}_all.pt", nproc=n)
        gaps[f"{arch} (1, {n})"] = dict(
            tokens_equal=bool(torch.equal(got["tokens"], want["tokens"])),
            logits_gap=(got["logits0"] - want["logits0"]).abs().max()
            .item() / scale)
    print(json.dumps({"attention_families_serving": {"cards": n,
                                                     "gaps": gaps}}))
    for g in gaps.values():
        assert g["tokens_equal"], gaps
        assert g["logits_gap"] <= SERVING_LOGITS_BOUND, gaps


def test_deepseek_decode_256_experts_over_every_card(dev, tmp_path):
    """The configuration no card holds: DeepSeek-R1's ``decode_32k`` cell
    in bf16 at every published width with 4 layers and all 256 experts
    (4 x 26.7 GB of experts), B 32 x 32768 over (1, cards): each rank its
    256 / cards experts, the replicated MLA weights and its 32768 / cards
    positions of the latent cache (random values), 16 steps: ms a step,
    tokens/s, the peak of every rank and one step's collectives (counts,
    ring wire bytes a rank), printed as JSON.  Skips with fewer than four
    cards."""
    import json
    n = torch.cuda.device_count()
    if n < 4:
        pytest.skip(f"needs four or more cards (has {n})")
    rec = _serve_record(["--mode", "bench", "--arch", "deepseek_r1",
                         "--layers", "4", "--dtype", "bfloat16", "--batch",
                         "32", "--seq", "32768"], tmp_path / "ds.pt",
                        nproc=n, timeout=900)
    print(json.dumps({"deepseek_decode_256_experts": rec}))
    assert rec["final_lengths_ok"]
    assert rec["collectives_a_step"]["counts"] == {"all-reduce": 1 + 3 * 4,
                                                   "all-gather": 1}
    assert max(rec["peak_gb_by_rank"]) < 80


def _train_readings(args, nproc=0, timeout=900):
    """One ``launch/train.py`` run (under ``torch.distributed.run`` over
    ``nproc`` cards when given; ``args`` start with the module or script):
    each step's loss, tokens/s, collectives and wire MB (rank 0's), the
    median tokens/s of steps 1 on, and the peak device memory (rank
    0's), read off its output."""
    import os
    import re
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=str(
        Path(__file__).resolve().parents[1] / "src"))
    cmd = [sys.executable]
    if nproc:
        cmd += ["-m", "torch.distributed.run", "--standalone",
                f"--nproc-per-node={nproc}"]
    out = subprocess.run(cmd + args, env=env, timeout=timeout,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    steps = [dict(loss=float(m[0]), tokens_per_s=float(m[1]),
                  collectives=m[2], wire_mb=float(m[3]) if m[3] else None)
             for m in re.findall(
                 r"step \d+ loss (\S+) grad_norm \S+ (\S+) tokens/s"
                 r"(?:; collectives (\{[^}]*\}), (\S+) MB on the wire)?",
                 out.stdout)]
    peak = re.search(r"peak device memory (?:\(rank 0\) )?(\S+) GB",
                     out.stdout)
    return {"steps": steps, "peak_gb": float(peak[1]),
            "tokens_per_s": sorted(s["tokens_per_s"] for s in steps[1:])[
                (len(steps) - 1) // 2]}


def test_recurrentgemma_bf16_tp_reading_over_every_card(dev):
    """A bf16 reading of the hybrid's ``tp`` step at its real size,
    printed as JSON: RecurrentGemma-2B at full depth (26 layers), 4 x 8192
    in 4 microbatches (``chip_smoke.py`` phase 15's batch and microbatches
    on one card) over (1, cards): its RG-LRU channels and gate blocks over
    the cards, its 10 attention heads in the ``seq`` mode.  Tokens/s
    (median of steps 1-3), the peak of rank 0, rank 0's collectives and
    wire bytes a step; each loss finite.  Skips with fewer than four
    cards."""
    import json
    n = torch.cuda.device_count()
    if n < 4:
        pytest.skip(f"needs four or more cards (has {n})")
    rec = _train_readings(["-m", "repro_torch.launch.train", "--arch",
                           "recurrentgemma_2b", "--steps", "4", "--batch",
                           "4", "--seq", "8192", "--microbatches", "4"], n)
    print(json.dumps({"recurrentgemma_tp_bf16": dict(rec, cards=n)}))
    assert len(rec["steps"]) == 4 and all(
        math.isfinite(s["loss"]) for s in rec["steps"]), rec


def test_seq_and_fsdp_bf16_readings_over_every_card(dev):
    """bf16 readings of the two training regimes of the four-card cases
    above at their real sizes, printed as JSON: Qwen2-0.5B at full depth,
    8 x 4096 in 2 microbatches, in the ``seq`` attention mode over (1,
    cards) against the ``heads`` mode over (cards / 2, 2) (its 14 heads
    split over 2); SmolLM-360M at full depth, 16 x 4096, in the ``fsdp``
    regime over every card (one microbatch, 16 / cards rows a card)
    against ``launch/train.py`` on one card (2 microbatches).  Tokens/s
    (median of steps 1-3), the peak of rank 0, and rank 0's collectives
    and wire bytes a step; each loss finite.  Skips with fewer than four
    cards."""
    import json
    n = torch.cuda.device_count()
    if n < 4:
        pytest.skip(f"needs four or more cards (has {n})")
    train = ["-m", "repro_torch.launch.train", "--steps", "4", "--seq",
             "4096"]
    qwen = train + ["--arch", "qwen2_0_5b", "--batch", "8",
                    "--microbatches", "2"]
    smol = ["--arch", "smollm_360m", "--batch", "16"]
    fsdp = str(Path(__file__).resolve().parent / "torch_fsdp_worker.py")
    rec = {"cards": n,
           "qwen2_seq": _train_readings(qwen, n),
           "qwen2_heads": _train_readings(qwen + ["--tp", "2"], n),
           "smollm_fsdp": _train_readings([fsdp] + train[2:] + smol, n),
           "smollm_one_card": _train_readings(train + smol
                                              + ["--microbatches", "2"])}
    print(json.dumps({"seq_fsdp_bf16": rec}))
    for r in rec.values():
        if isinstance(r, dict):
            assert len(r["steps"]) == 4 and all(
                math.isfinite(s["loss"]) for s in r["steps"]), r
