"""Decode attention's split and merge, held to the JAX package on the CPU.

The Hopper kernel ``csrc/paged_attention.cu`` splits each (sequence, kv
head) across a cluster of C CTAs: rank r takes the 64-token tiles
[r * ntiles // C, (r + 1) * ntiles // C) of the sequence, each of its four
warps takes one 16-token chunk of every tile and runs its own online
softmax, the warps merge in warp order and the ranks in rank order.  No
compiler or card is here, so this file models that arithmetic in numpy,
with the kernel's formulas, and holds the model to the Pallas kernel in
interpret mode and to the port's plain version, in fp32 at atol/rtol 1e-5
(the two frameworks sum in different orders).  It also settles what a row
of length 0 (a free slot) gives: zeros, as ``paged_attention_tpu`` does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.ops import paged_attention as pallas_paged
from repro.kernels.paged_attention.ref import ref_paged_attention
from repro_torch.kernels.paged_attention.ops import paged_attention_plain

TOL = dict(atol=1e-5, rtol=1e-5)
NEG = np.float32(-1e30)
TK, CH, NW = 64, 16, 4          # the kernel's tile, warp chunk and warps


def rank_tiles(length, C):
    """The tile range [lo, hi) of each rank: the kernel's formula."""
    ntiles = -(-length // TK)
    return [(r * ntiles // C, (r + 1) * ntiles // C) for r in range(C)]


def _online(state, s, v):
    """One chunk of the online softmax: s (G, n) scores, v (n, D)."""
    m, l, acc = state
    mn = np.maximum(m, s.max(axis=1))
    corr = np.exp(m - mn)
    p = np.exp(s - mn[:, None])
    return mn, l * corr + p.sum(axis=1), acc * corr[:, None] + p @ v


def _merge(states):
    """Partial states merged in the order given."""
    M = np.max([m for m, _, _ in states], axis=0)
    L, A = np.zeros_like(M), np.zeros_like(states[0][2])
    for m, l, acc in states:
        a = np.exp(m - M)
        L, A = L + a * l, A + a[:, None] * acc
    return M, L, A


def split_merge(q, kp, vp, table, lengths, C):
    """The kernel's split of each (sequence, kv head) over C ranks and NW
    warps, and its two merges, in float32."""
    B, H, D = q.shape
    _, page, Hkv, _ = kp.shape
    G = H // Hkv
    out = np.zeros((B, H, D), np.float32)
    for b in range(B):
        n = int(min(max(lengths[b], 0), table.shape[1] * page))
        if n == 0:
            continue
        pos = np.arange(n)
        rows = table[b][pos // page], pos % page
        for hk in range(Hkv):
            k, v = kp[rows + (hk,)], vp[rows + (hk,)]
            s = (q[b, hk * G:(hk + 1) * G] / np.float32(np.sqrt(D))) @ k.T
            ranks = []
            for lo, hi in rank_tiles(n, C):
                warps = []
                for w in range(NW):
                    st = (np.full(G, NEG), np.zeros(G, np.float32),
                          np.zeros((G, D), np.float32))
                    for t in range(lo, hi):
                        c0 = t * TK + w * CH
                        if c0 < n:
                            c1 = min(c0 + CH, n)
                            st = _online(st, s[:, c0:c1], v[c0:c1])
                    warps.append(st)
                ranks.append(_merge(warps))
            _, L, A = _merge(ranks)
            out[b, hk * G:(hk + 1) * G] = A / np.maximum(L, 1e-30)[:, None]
    return out


def _pool(seed, B, H, Hkv, D, page, max_pages, spare):
    """q, K/V pools with ``spare`` pages no row uses, and a shuffled page
    table."""
    r = np.random.default_rng(seed)
    num_pages = B * max_pages + spare
    q = r.standard_normal((B, H, D)).astype(np.float32)
    kp = r.standard_normal((num_pages, page, Hkv, D)).astype(np.float32)
    vp = r.standard_normal((num_pages, page, Hkv, D)).astype(np.float32)
    table = r.permutation(num_pages)[:B * max_pages].reshape(
        B, max_pages).astype(np.int32)
    return q, kp, vp, table


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def test_length_zero_gives_zeros():
    """A row of length 0: the Pallas kernel (interpret mode) gives zeros,
    and so does the port's plain version, on every row; the JAX oracle
    ``ref_paged_attention`` softmaxes a row of -1e30 scores into the mean
    of V over the whole table, which the port does not follow."""
    B, H, Hkv, D, page, max_pages = 2, 4, 2, 32, 8, 3
    q, kp, vp, table = _pool(0, B, H, Hkv, D, page, max_pages, spare=2)
    lengths = np.array([0, 5], np.int32)
    args = (q, kp, vp, table, lengths)
    got = paged_attention_plain(*_t(*args)).numpy()
    want = np.asarray(pallas_paged(*map(jnp.asarray, args), interpret=True))
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[0].any() and not want[0].any()
    assert np.abs(got[1]).max() > 0.1
    mean_v = vp[table[0]].reshape(max_pages * page, Hkv, D).mean(axis=0)
    oracle = np.asarray(ref_paged_attention(*map(jnp.asarray, args)))
    np.testing.assert_allclose(oracle[0], np.repeat(mean_v, H // Hkv, axis=0),
                               **TOL)
    np.testing.assert_allclose(oracle[1], got[1], **TOL)


def test_plain_length_zero_in_bf16_is_exact_zeros():
    """The plain version's length-0 rows are exact zeros in bf16 too (the
    card compares the kernel's with torch.equal)."""
    q, kp, vp, table = _pool(1, 3, 8, 2, 64, 16, 2, spare=1)
    args = [x.bfloat16() for x in _t(q, kp, vp)] + _t(table)
    out = paged_attention_plain(*args, torch.tensor([7, 0, -3],
                                                    dtype=torch.int32))
    assert out.dtype == torch.bfloat16
    assert torch.equal(out[1:], torch.zeros_like(out[1:]))
    assert out[0].abs().max() > 0.1


@pytest.mark.parametrize("length", [0, 1, 63, 64, 65, 511, 512, 1792, 2048])
@pytest.mark.parametrize("C", [1, 8])
def test_rank_tiles_cover_the_sequence(length, C):
    """The ranks' tile ranges are contiguous, cover every tile once, and
    differ in size by at most one tile."""
    ranges = rank_tiles(length, C)
    ntiles = -(-length // TK)
    assert ranges[0][0] == 0 and ranges[-1][1] == ntiles
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = [hi - lo for lo, hi in ranges]
    assert min(sizes) >= 0 and max(sizes) - min(sizes) <= 1


# (G, D): a group of 1, 3, 7 and 16 q heads per kv head; Hkv 2
GROUPS = [(1, 32), (3, 128), (7, 32), (16, 128)]


@pytest.mark.parametrize("G,D", GROUPS, ids=[f"G{g}-D{d}" for g, d in GROUPS])
@pytest.mark.parametrize("C", [1, 8])
def test_split_merge_model_matches_pallas(C, G, D):
    """The split-and-merge model == the Pallas kernel in interpret mode ==
    the port's plain version, over a shuffled table with spare pages, at
    lengths 0, 1, 63, 64, 65, one shorter than C tiles (ranks left empty
    at C = 8), a full table of 10 tiles (ranks of one and two tiles) and a
    length past the table (clamped)."""
    Hkv, page, max_pages = 2, 16, 40
    full = page * max_pages
    lengths = np.array([0, 1, 63, 64, 65, 200, full, full + 9], np.int32)
    q, kp, vp, table = _pool(10 + G, len(lengths), G * Hkv, Hkv, D, page,
                             max_pages, spare=5)
    if C == 8:
        assert any(hi == lo for lo, hi in rank_tiles(200, C))
    args = (q, kp, vp, table, lengths)
    model = split_merge(*args, C)
    plain = paged_attention_plain(*_t(*args)).numpy()
    want = np.asarray(pallas_paged(*map(jnp.asarray, args), interpret=True))
    np.testing.assert_allclose(model, want, **TOL)
    np.testing.assert_allclose(plain, want, **TOL)
    assert not model[0].any() and not plain[0].any()
