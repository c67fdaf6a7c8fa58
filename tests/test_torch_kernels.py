"""The port's attention kernels, held to the JAX package on the CPU.

On CPU tensors each wrapper of ``repro_torch.kernels`` runs its plain
PyTorch version; these tests hold those plain versions to the JAX
functions the serving path runs and to the Pallas kernels in interpret
mode, on the same inputs made with numpy from a seed.  The CUDA kernels
themselves are held to the plain versions on the card by
``chip_smoke.py``.  Tolerance: atol 1e-5 / rtol 1e-5 in fp32 (the two
frameworks sum in different orders).
"""
import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as pallas_flash
from repro.kernels.flash_attention.ref import ref_attention
from repro.kernels.paged_attention.ops import paged_attention as pallas_paged
from repro.kernels.paged_attention.ref import ref_paged_attention
from repro.models import flash as jflash
from repro.models import layers as jlayers
from repro_torch import kernels
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_lse,
                                                     flash_attention_plain)
from repro_torch.kernels.flash_attention_bwd import ops as fb_ops
from repro_torch.kernels.flash_attention_bwd.ops import (
    flash_attention_bwd, flash_attention_bwd_plain)
from repro_torch.kernels.fused_sampling.ops import (fused_sample,
                                                    fused_sample_plain)
from repro_torch.kernels.moe_gemm.ops import grouped_gemm, grouped_gemm_plain
from repro_torch.kernels.moe_gemm_wgrad import ops as wgrad_ops
from repro_torch.kernels.moe_gemm_wgrad.ops import (
    grouped_gemm_wgrad, grouped_gemm_wgrad_plain)
from repro_torch.kernels.paged_attention.ops import (paged_attention,
                                                     paged_attention_plain)
from repro_torch.kernels.ssd_scan.ops import (ssd_state_scan,
                                              ssd_state_scan_plain)
from repro_torch.kernels.ssd_scan_bwd.ops import (ssd_state_scan_bwd,
                                                  ssd_state_scan_bwd_plain)
from repro_torch.models import flash as tflash
from repro_torch.models import layers as tlayers

TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(seed, B, Sq, Skv, H, Hkv, dh):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, Sq, H, dh)).astype(np.float32)
    k = r.standard_normal((B, Skv, Hkv, dh)).astype(np.float32)
    v = r.standard_normal((B, Skv, Hkv, dh)).astype(np.float32)
    return q, k, v


def _pos(B, start, n):
    return np.broadcast_to(np.arange(start, start + n, dtype=np.int32)[None],
                           (B, n)).copy()


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


# (name, B, Sq, Skv, H, Hkv, dh, causal, window, softcap)
PREFILL_CASES = [
    ("causal_gqa", 2, 64, 64, 4, 2, 32, True, 0, 0.0),
    ("causal_gqa3", 1, 40, 40, 6, 2, 32, True, 0, 0.0),
    ("offset_q", 2, 8, 64, 4, 2, 32, True, 0, 0.0),
    ("window", 2, 64, 64, 4, 1, 32, True, 16, 0.0),
    ("softcap", 1, 32, 32, 4, 2, 64, True, 0, 5.0),
    ("noncausal", 2, 32, 48, 4, 4, 32, False, 0, 0.0),
]


@pytest.mark.parametrize("case", PREFILL_CASES,
                         ids=[c[0] for c in PREFILL_CASES])
def test_plain_prefill_matches_jax_flash(case):
    """Plain prefill attention == ``repro.models.flash.flash_attention``
    (explicit positions; the offset case is the tail recompute's Sq < Skv
    shape with q positions at the end of the keys)."""
    _, B, Sq, Skv, H, Hkv, dh, causal, window, softcap = case
    q, k, v = _qkv(1, B, Sq, Skv, H, Hkv, dh)
    qp, kp = _pos(B, Skv - Sq, Sq), _pos(B, 0, Skv)
    chunk = min(512, Skv)
    want = jflash.flash_attention((causal, window, chunk, softcap),
                                  *map(jnp.asarray, (q, k, v, qp, kp)))
    got = flash_attention_plain(*_t(q, k, v, qp, kp), causal=causal,
                                window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 16)])
def test_plain_prefill_matches_pallas_interpret(causal, window):
    """Plain prefill attention == the Pallas TPU kernel in interpret mode
    (implicit positions 0..S-1, block-aligned S so its padding does not
    enter), with GQA."""
    B, S, H, Hkv, dh = 2, 64, 4, 2, 32
    q, k, v = _qkv(2, B, S, S, H, Hkv, dh)
    want = pallas_flash(*map(jnp.asarray, (q, k, v)), causal=causal,
                        window=window, interpret=True)
    got = flash_attention_plain(*_t(q, k, v, _pos(B, 0, S), _pos(B, 0, S)),
                                causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("chunk", [512, 64])
def test_plain_prefill_masks_true_length(chunk):
    """Regression for the reference wrapper's padding fault: non-causal
    attention with Skv = 96 (not a multiple of the 64-key block).  The
    JAX wrapper ``repro.kernels.flash_attention.ops.flash_attention`` pads
    the keys to 128 and attends to the zero padding, which puts it 0.127
    away from ``ref_attention`` here; the port masks at the true Skv and
    matches the oracle to 1e-5, with one chunk or a ragged last chunk."""
    B, S, H, Hkv, dh = 1, 96, 4, 2, 32
    q, k, v = _qkv(3, B, S, S, H, Hkv, dh)
    want = ref_attention(*map(jnp.asarray, (q, k, v)), causal=False)
    got = tflash.flash_attention(*_t(q, k, v, _pos(B, 0, S), _pos(B, 0, S)),
                                 causal=False, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _pool(seed, B, H, Hkv, dh, page, max_pages, extra):
    r = np.random.default_rng(seed)
    num_pages = B * max_pages + extra
    q = r.standard_normal((B, H, dh)).astype(np.float32)
    kp = r.standard_normal((num_pages, page, Hkv, dh)).astype(np.float32)
    vp = r.standard_normal((num_pages, page, Hkv, dh)).astype(np.float32)
    table = r.permutation(num_pages)[:B * max_pages].reshape(
        B, max_pages).astype(np.int32)
    return q, kp, vp, table


@pytest.mark.parametrize("H,Hkv", [(4, 2), (6, 2), (8, 8)])
def test_plain_decode_matches_pallas_interpret(H, Hkv):
    """Plain decode attention == the Pallas paged kernel in interpret mode
    and its oracle, over a shuffled page table and mixed lengths (one
    inside a page, one a full table, one ragged)."""
    B, dh, page, max_pages = 3, 32, 8, 4
    q, kp, vp, table = _pool(4, B, H, Hkv, dh, page, max_pages, extra=3)
    lengths = np.array([5, 32, 17], np.int32)
    args = (q, kp, vp, table, lengths)
    got = paged_attention_plain(*_t(*args)).numpy()
    want = pallas_paged(*map(jnp.asarray, args), interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    oracle = ref_paged_attention(*map(jnp.asarray, args))
    np.testing.assert_allclose(got, np.asarray(oracle), **TOL)


@pytest.mark.parametrize("S", [8, 64, 48])
def test_dense_decode_view_matches_jax_decode_attention(S):
    """The port's ``layers.decode_attention`` (the dense slot cache passed
    to paged attention as a pool view with the identity table) ==
    ``repro.models.layers.decode_attention``, including a cache of the
    prefix-hit tail's pow2 length 8 at batch 1 shapes, a length that is
    not a power of two, and lengths past the cache (finished slots)."""
    r = np.random.default_rng(5)
    B, H, Hkv, dh = 3, 6, 2, 32
    q = r.standard_normal((B, 1, H, dh)).astype(np.float32)
    kc = r.standard_normal((B, S, Hkv, dh)).astype(np.float32)
    vc = r.standard_normal((B, S, Hkv, dh)).astype(np.float32)
    lengths = np.array([1, S // 2 + 1, S + 1], np.int32)
    want = jlayers.decode_attention(*map(jnp.asarray, (q, kc, vc, lengths)))
    got = tlayers.decode_attention(*_t(q, kc, vc, lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cpu_wrappers_run_plain_and_count_no_launch():
    """On CPU tensors a wrapper is its plain version and launches nothing:
    the launch counters (and the weight gradient's by route) stay at
    zero."""
    kernels.reset_launches()
    wgrad_ops.reset_routes()
    q, k, v = _qkv(6, 1, 16, 16, 4, 2, 32)
    k_attn = k
    pos = _pos(1, 0, 16)
    a = flash_attention(*_t(q, k, v, pos, pos))
    b = flash_attention_plain(*_t(q, k, v, pos, pos))
    assert torch.equal(a, b)
    qd, kp, vp, table = _pool(7, 2, 4, 2, 32, 8, 2, extra=0)
    lengths = torch.tensor([3, 16], dtype=torch.int32)
    c = paged_attention(*_t(qd, kp, vp, table), lengths)
    d = paged_attention_plain(*_t(qd, kp, vp, table), lengths)
    assert torch.equal(c, d)
    r = np.random.default_rng(8)
    rows = [torch.from_numpy(r.standard_normal((2, 50)).astype(np.float32))
            for _ in range(2)]
    k = torch.tensor([0, 5], dtype=torch.int32)
    p, mp = torch.tensor([0.9, 1.0]), torch.tensor([0.0, 0.1])
    e = fused_sample(*rows, k, p, mp)
    f = fused_sample_plain(*rows, k, p, mp)
    assert all(torch.equal(e[key], f[key]) for key in f)
    x = torch.from_numpy(r.standard_normal((32, 8)).astype(np.float32))
    w = torch.from_numpy(r.standard_normal((2, 8, 5)).astype(np.float32))
    be = torch.tensor([1, -1], dtype=torch.int32)
    assert torch.equal(grouped_gemm(x, w, be, block_t=16),
                       grouped_gemm_plain(x, w, be, block_t=16))
    dy = torch.from_numpy(r.standard_normal((32, 5)).astype(np.float32))
    assert torch.equal(grouped_gemm_wgrad(x, dy, be, 2, block_t=16),
                       grouped_gemm_wgrad_plain(x, dy, be, 2, block_t=16))
    # bf16 at block_t 64 (the wgmma route's call on a card)
    xb, dyb = (torch.from_numpy(r.standard_normal((128, w))
                                .astype(np.float32)).bfloat16()
               for w in (16, 8))
    assert torch.equal(grouped_gemm_wgrad(xb, dyb, be, 2, block_t=64),
                       grouped_gemm_wgrad_plain(xb, dyb, be, 2, block_t=64))
    st = torch.from_numpy(r.standard_normal((1, 2, 3, 4, 4))
                          .astype(np.float32))
    dec = torch.from_numpy(r.random((1, 2, 3)).astype(np.float32))
    for g, w in zip(ssd_state_scan(st, dec), ssd_state_scan_plain(st, dec)):
        assert torch.equal(g, w)
    prev = ssd_state_scan_plain(st, dec)[0]
    for g, w in zip(ssd_state_scan_bwd(prev, dec, st),
                    ssd_state_scan_bwd_plain(prev, dec, st)):
        assert torch.equal(g, w)
    qt, kt, vt, pt = _t(q, k_attn, v, pos)
    out, lse = flash_attention_lse(qt, kt, vt, pt, pt)
    for g, w in zip(flash_attention_bwd(qt, kt, vt, pt, pt, out, lse, out),
                    flash_attention_bwd_plain(qt, kt, vt, pt, pt, out, lse,
                                              out)):
        assert torch.equal(g, w)
    assert kernels.launches() == {"flash_attention": 0,
                                  "flash_attention_bwd": 0,
                                  "paged_attention": 0, "fused_sampling": 0,
                                  "moe_gemm": 0, "moe_gemm_wgrad": 0,
                                  "ssd_scan": 0, "ssd_scan_bwd": 0}
    assert wgrad_ops.ROUTE_LAUNCHES == {"wgmma": 0, "mma": 0, "simt": 0}
    assert set(kernels.KERNELS) == {"flash_attention", "flash_attention_bwd",
                                    "paged_attention", "fused_sampling",
                                    "moe_gemm", "moe_gemm_wgrad",
                                    "ssd_scan", "ssd_scan_bwd"}
    for name in kernels.KERNELS:
        op, plain = kernels.get_kernel(name)
        assert callable(op) and callable(plain)


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "simt"),
                                         (torch.float16, None)])
def test_flash_route_follows_the_storage_type(dtype, route):
    """The wrapper's route choice needs no card: bf16 goes to the
    tensor-core kernel, fp32 to the CUDA-core one, and any other type has
    no route (the wrapper raises rather than converting it)."""
    if route is None:
        with pytest.raises(TypeError):
            fa_ops.route(dtype)
    else:
        assert fa_ops.route(dtype) == route


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_flash_tma_alignment_check(dtype, monkeypatch):
    """The check the wrapper runs before a launch: a contiguous bf16 view
    that starts 2 bytes past an aligned base cannot feed TMA and raises
    ValueError naming the cause; fp32 (the CUDA-core route) takes any
    base.  On the CPU the wrapper runs the plain version whatever the
    base, and counts no launch on either route.  The bf16 key limit is
    the built kernel's (``max_keys``); here it is any limit the 16 keys
    are within."""
    r = np.random.default_rng(9)
    B, S, H, Hkv, dh = 1, 16, 4, 2, 32
    monkeypatch.setattr(fa_ops, "max_keys", lambda dqk, dv=None: 64)
    flat = torch.from_numpy(r.standard_normal(1 + B * S * H * dh)
                            .astype(np.float32)).to(dtype)
    q_off = flat[1:].view(B, S, H, dh)
    assert q_off.is_contiguous() and q_off.data_ptr() % 16
    q, k, v = _t(*_qkv(10, B, S, S, H, Hkv, dh))
    k, v = k.to(dtype), v.to(dtype)
    pos = torch.from_numpy(_pos(B, 0, S))
    fa_ops._check(q.to(dtype), k, v, pos, pos)
    if dtype == torch.bfloat16:
        with pytest.raises(ValueError, match="16-byte"):
            fa_ops._check(q_off, k, v, pos, pos)
    else:
        fa_ops._check(q_off, k, v, pos, pos)
    fa_ops.reset_routes()
    kernels.reset_launches()
    got = flash_attention(q_off, k, v, pos, pos)
    assert torch.equal(got, flash_attention_plain(q_off, k, v, pos, pos))
    assert fa_ops.ROUTE_LAUNCHES == {"wgmma": 0, "simt": 0}
    assert kernels.launches()["flash_attention"] == 0


@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_bf16_key_limit_check(D, monkeypatch):
    """The tensor-core route's tile list lives in shared memory, so the
    wrapper refuses a bf16 call with more keys than ``max_keys(D)`` with
    a ValueError that names the limit, before any launch; at the limit,
    and in fp32 (the CUDA-core route) past it, the check passes.  The
    limit is the built kernel's (``repro_flash_max_keys``, held on the
    card by ``tests/test_torch_cuda.py``); here it is the layout's: a
    128-row Q tile and a 4-stage ring (1280 * D bytes), 2188 bytes of
    barriers, positions and alignment, then 12 bytes a 64-key tile in
    227 KiB.  The tensors are never written, so their pages are never
    touched."""
    n = (227 * 1024 - 1280 * D - 2188) // 12 * 64
    monkeypatch.setattr(fa_ops, "max_keys", lambda dqk, dv=None: n)
    q = torch.zeros((1, 1, 1, D), dtype=torch.bfloat16)
    qp = torch.zeros((1, 1), dtype=torch.int32)
    for Skv in (n, n + 1):
        k = torch.empty((1, Skv, 1, D), dtype=torch.bfloat16)
        kp = torch.empty((1, Skv), dtype=torch.int32)
        if Skv > n:
            with pytest.raises(ValueError, match=f"at most {n} keys"):
                fa_ops._check(q, k, k, qp, kp)
            k32 = torch.empty((1, Skv, 1, D), dtype=torch.float32)
            fa_ops._check(q.float(), k32, k32, qp, kp)
        else:
            fa_ops._check(q, k, k, qp, kp)


# ------------------------------------------------ the backward's wrapper

@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "simt"),
                                         (torch.float16, None)])
def test_flash_bwd_route_follows_the_storage_type(dtype, route):
    """bf16 goes to the wgmma kernels, fp32 to the CUDA-core ones, any
    other type has no route (the wrapper raises rather than converting)."""
    if route is None:
        with pytest.raises(TypeError):
            fb_ops.route(dtype)
    else:
        assert fb_ops.route(dtype) == route


def _bwd_args(dtype, B=1, Sq=16, Skv=16, H=4, Hkv=2, D=32):
    r = np.random.default_rng(11)
    q, k, v = (t.to(dtype) for t in _t(*_qkv(12, B, Sq, Skv, H, Hkv, D)))
    out = torch.from_numpy(r.standard_normal((B, Sq, H, D))
                           .astype(np.float32)).to(dtype)
    lse = torch.zeros((B, Sq, H), dtype=torch.float32)
    qp, kp = (torch.from_numpy(_pos(B, 0, n)) for n in (Sq, Skv))
    return [q, k, v, qp, kp, out, lse, out.clone()]


@pytest.mark.parametrize("name", ["q", "k", "v", "out", "dout"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_flash_bwd_checks_what_tma_needs(name, dtype, monkeypatch):
    """The wrapper's check before a launch: a contiguous bf16 view 2 bytes
    past an aligned base cannot feed TMA (nor the preprocess's 16-byte
    loads) and raises a ValueError naming the tensor and the cause; fp32
    (the CUDA-core route) takes any base.  The length limit is the built
    kernel's (``max_len``); here any limit the 16 rows are within."""
    monkeypatch.setattr(fb_ops, "max_len", lambda dqk, dv=None: 64)
    args = _bwd_args(dtype)
    i = ["q", "k", "v", "q_pos", "kv_pos", "out", "lse", "dout"].index(name)
    t = args[i]
    flat = torch.zeros(1 + t.numel(), dtype=dtype)
    off = flat[1:].view(t.shape)
    off.copy_(t)
    assert off.is_contiguous() and off.data_ptr() % 16
    fb_ops._check(*args, 0, 0.0)
    args[i] = off
    if dtype == torch.bfloat16:
        with pytest.raises(ValueError, match=f"bf16 {name} must start on a "
                                             f"16-byte boundary"):
            fb_ops._check(*args, 0, 0.0)
    else:
        fb_ops._check(*args, 0, 0.0)


@pytest.mark.parametrize("D", [16, 48, 96, 160])
def test_flash_bwd_refuses_a_head_dim_it_has_no_kernel_for(D):
    """Head dims outside HEAD_DIMS (32, 64, 80, 128, 256) are refused
    before any launch, in both types."""
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="the kernel takes one of"):
            fb_ops._check(*_bwd_args(dtype, D=D), 0, 0.0)


@pytest.mark.parametrize("D", [32, 64, 80, 128, 256])
def test_flash_bwd_length_limit_check(D, monkeypatch):
    """The bf16 route keeps each tile's position range in shared memory,
    so the wrapper refuses a bf16 call whose Sq or Skv passes ``max_len``
    with a ValueError naming the limit; at the limit, and in fp32 past
    it, the check passes."""
    n = 40
    monkeypatch.setattr(fb_ops, "max_len", lambda dqk, dv=None: n)
    for Sq, Skv, ok in ((n, n, True), (n + 1, n, False), (n, n + 1, False)):
        args = _bwd_args(torch.bfloat16, Sq=Sq, Skv=Skv, D=D)
        if ok:
            fb_ops._check(*args, 0, 0.0)
        else:
            with pytest.raises(ValueError, match=f"at most {n} q rows"):
                fb_ops._check(*args, 0, 0.0)
            fb_ops._check(*_bwd_args(torch.float32, Sq=Sq, Skv=Skv, D=D),
                          0, 0.0)


@pytest.mark.parametrize("B,Sq,Skv,H", [(2, 100, 130, 4), (1, 1, 1, 1),
                                        (8, 4096, 4096, 15)])
def test_flash_bwd_scratch_len(B, Sq, Skv, H):
    """The scratch: Dl (B, Sq, H) in fp32; in bf16 the (B, H, 3, Sqp) rows
    of lse, Dl and q positions and the (B, Skvp) kv positions, Sq and Skv
    padded to multiples of 64, so that every row starts on a 16-byte
    boundary."""
    pad = lambda n: (n + 63) // 64 * 64
    assert fb_ops.scratch_len(torch.float32, B, Sq, Skv, H) == B * Sq * H
    got = fb_ops.scratch_len(torch.bfloat16, B, Sq, Skv, H)
    assert got == 3 * B * H * pad(Sq) + B * pad(Skv)
    assert (3 * B * H * pad(Sq) * 4) % 16 == 0 and (pad(Sq) * 4) % 16 == 0


# The wgmma kernels' walk (csrc/flash_attention_bwd.cu), modelled in numpy
# from the constants of the source: the tiles a CTA walks, and the tiles a
# consumer skips or takes without its per-element mask, from the tiles'
# least and greatest positions.  Held to a brute-force reading of the mask.
_BWD_SRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
            / "csrc" / "flash_attention_bwd.cu").read_text()


def _holds(cond, D):
    """Whether a Geo condition on the q/k head dim, clauses ``DQ == n`` or
    ``DQ >= n`` joined by ``||``, holds at D."""
    return any(int(n) == D if op == "==" else D >= int(n)
               for op, n in re.findall(r"DQ (==|>=) (\d+)", cond))


def _geo(D):
    """(BN, keys of a dK/dV CTA, whether its consumers share them, q rows
    of a dQ CTA, whether its consumers share them, keys a dQ step) at q/k
    head dim D (the walk's geometry depends on it alone), read from the
    source's Geo."""
    cond = r"((?:DQ (?:==|>=) \d+(?: \|\| )?)+)"
    bn = re.search(rf"static constexpr int BN = {cond} \? (\d+) : (\d+);",
                   _BWD_SRC)
    split = re.search(rf"static constexpr bool kSplit = {cond};", _BWD_SRC)
    halves = re.search(rf"static constexpr int kHalves = {cond} \? 2 : 1;",
                       _BWD_SRC)
    br = re.search(r"static constexpr int BR = 64 \* NC / kHalves;",
                   _BWD_SRC)
    bkq = re.search(rf"static constexpr int BKQ = {cond} \? (\d+) : "
                    r"(\d+);", _BWD_SRC)
    assert bn and split and halves and br and bkq, \
        "Geo's BN / kSplit / kHalves / BR / BKQ lines changed"
    BN = int(bn.group(2)) if _holds(bn.group(1), D) else int(bn.group(3))
    is_split = _holds(split.group(1), D)
    shared = _holds(halves.group(1), D)    # dQ's consumers: column halves
    BKQ = int(bkq.group(2)) if _holds(bkq.group(1), D) else \
        int(bkq.group(3))
    return (BN, (64 if is_split else 128), is_split, 64 if shared else 128,
            shared, BKQ)


def _ranges(pos, n, rows):
    return [(pos[t:min(t + rows, n)].min(), pos[t:min(t + rows, n)].max())
            for t in range(0, n, rows)]


def _walks(q_pos, kv_pos, causal, D, window=0):
    """Per dK/dV consumer (CTA, c) and dQ consumer: {tile: full} of the
    streamed tiles it multiplies, as the kernels decide: a CTA walks the
    tiles not wholly above the causal limit nor wholly outside the window
    for all its rows, a consumer skips those for its own rows, and takes
    without the per-element mask those whose every pair is allowed."""
    Sq, Skv = len(q_pos), len(kv_pos)
    BN, BKV, split, BR, shared, BKQ = _geo(D)
    w = window
    dkdv, dq = {}, {}
    qr = _ranges(q_pos, Sq, BN)
    for k0 in range(0, Skv, BKV):
        klo = kv_pos[k0:min(k0 + BKV, Skv)].min()
        khi = kv_pos[k0:min(k0 + BKV, Skv)].max()
        for c in (0,) if split else (0, 1):
            kw0 = k0 + 64 * c
            if kw0 >= Skv:
                continue
            wlo, whi = kv_pos[kw0:min(kw0 + 64, Skv)].min(), \
                kv_pos[kw0:min(kw0 + 64, Skv)].max()
            got = {}
            for t, (lo, hi) in enumerate(qr):
                if (causal and hi < klo) or (w > 0 and lo - w >= khi):
                    continue                     # not walked
                if (causal and hi < wlo) or (w > 0 and lo - w >= whi):
                    continue                     # skipped
                got[t] = (kw0 + 64 <= Skv and (t + 1) * BN <= Sq
                          and (not causal or whi <= lo)
                          and (w <= 0 or hi - w < wlo))
            dkdv[(kw0, min(kw0 + 64, Skv))] = got
    kr = _ranges(kv_pos, Skv, BKQ)
    for q0 in range(0, Sq, BR):
        qlo = q_pos[q0:min(q0 + BR, Sq)].min()
        qhi = q_pos[q0:min(q0 + BR, Sq)].max()
        for qw0 in (q0,) if shared else (q0, q0 + 64):
            if qw0 >= Sq:
                continue
            wlo, whi = q_pos[qw0:min(qw0 + 64, Sq)].min(), \
                q_pos[qw0:min(qw0 + 64, Sq)].max()
            got = {}
            for t, (lo, hi) in enumerate(kr):
                if (causal and lo > qhi) or (w > 0 and hi <= qlo - w):
                    continue                     # not walked
                if (causal and lo > whi) or (w > 0 and hi <= wlo - w):
                    continue                     # skipped
                got[t] = (qw0 + 64 <= Sq and (t + 1) * BKQ <= Skv
                          and (not causal or hi <= wlo)
                          and (w <= 0 or lo > whi - w))
            dq[(qw0, min(qw0 + 64, Sq))] = got
    return BN, BKQ, dkdv, dq


def _position_sets():
    """name -> (q positions, kv positions, causal, window)."""
    r = np.random.default_rng(13)
    return {
        "causal S300": (np.arange(300), np.arange(300), True, 0),
        "offset q Sq100 Skv300": (np.arange(200, 300), np.arange(300), True,
                                  0),
        "non-causal Sq40 Skv130": (np.arange(40), np.arange(130), False, 0),
        "causal Sq1000 G-ring": (np.arange(1000), np.arange(1000), True, 0),
        "one key tile Sq700 Skv48": (np.arange(48, 748), np.arange(48),
                                     True, 0),
        "packed rows, shuffled": (r.permutation(260), r.permutation(260),
                                  True, 0),
        "window 64 causal S300": (np.arange(300), np.arange(300), True, 64),
        "window 100 causal S1000": (np.arange(1000), np.arange(1000), True,
                                    100),
        "window 70 offset q Sq100 Skv300": (np.arange(200, 300),
                                            np.arange(300), True, 70),
        "window 24 non-causal Sq40 Skv130": (np.arange(40), np.arange(130),
                                             False, 24),
        "window 50 packed rows, shuffled": (r.permutation(260),
                                            r.permutation(260), True, 50),
    }


@pytest.mark.parametrize("D", [32, 64, 80, 128, 192, 256])
@pytest.mark.parametrize("case", list(_position_sets()))
def test_flash_bwd_walk_covers_the_mask(case, D):
    """Every allowed (q row, key) pair is multiplied by its dK/dV consumer
    and by its dQ consumer; a tile taken without the per-element mask has
    every pair allowed and in range; and where positions rise with the
    index (every set but the shuffled ones) a consumer multiplies exactly
    the tiles that hold an allowed pair of its rows.  The windowed sets
    skip the tiles wholly outside the window."""
    q_pos, kv_pos, causal, window = _position_sets()[case]
    Sq, Skv = len(q_pos), len(kv_pos)
    allowed = np.ones((Sq, Skv), bool) if not causal else \
        kv_pos[None, :] <= q_pos[:, None]
    if window > 0:
        allowed &= kv_pos[None, :] > q_pos[:, None] - window
    BN, BKQ, dkdv, dq = _walks(q_pos, kv_pos, causal, D, window)
    monotone = "shuffled" not in case
    for (a, z), got in dkdv.items():
        want = {i // BN for i in range(Sq) if allowed[i, a:z].any()}
        assert want <= set(got), (case, a)
        if monotone:
            assert want == set(got), (case, a)
        for t, full in got.items():
            if full:
                assert allowed[t * BN:(t + 1) * BN, a:z].all()
    for (a, z), got in dq.items():
        want = {j // BKQ for j in range(Skv) if allowed[a:z, j].any()}
        assert want <= set(got), (case, a)
        if monotone:
            assert want == set(got), (case, a)
        for t, full in got.items():
            if full:
                assert allowed[a:z, t * BKQ:(t + 1) * BKQ].all()
