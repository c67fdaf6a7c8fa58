"""The fused sampling kernel's split across a cluster, held to the JAX
package on the CPU.

The Hopper kernel ``csrc/fused_sampling.cu`` splits each row across a
cluster of C CTAs: rank r owns the slice [r * W, (r + 1) * W) of the row,
clipped to V, with W = V / C rounded up to ALIGN entries.  Each rank
reduces its slice to softmax stats, to integer histograms (u32 counts, u64
masses in units of 2^-44) in every pass, to a local draw and to sorted
lane lists; the ranks merge their stats in rank order, sum their
histograms, and merge their draws and lists (value descending, index
ascending), the lists in rounds of at most KC.  A pass leaves the
catch-all bucket's mass 0 and sums it apart only where a crossing past the
coarse level lands on it.  No compiler or card is here, so this file
models that arithmetic in numpy, with C, ALIGN, KC, the histogram
constants, the slice and limit formulas and the shared-memory layout read
from the kernel's source, and holds the model to the port's plain version
and to the Pallas kernel in interpret mode: tokens and lane ids exact,
``tau`` to 1e-6 (exact where the crossings are built to be tested), stats
to 1e-6 (float sums in other orders).  The card holds the kernel itself to
the plain version (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.kernels.fused_sampling.ops import fused_sample as pallas_sample
from repro_torch import configs as torch_configs
from repro_torch.kernels.fused_sampling import ops
from repro_torch.kernels.fused_sampling.ops import fused_sample_plain
from repro_torch.launch.flash_ab import catch_all_rows

SRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
       / "fused_sampling.cu").read_text()
TOL = dict(rtol=1e-6, atol=1e-6)
F32 = np.float32
INT_MAX = 2 ** 31 - 1


def _constants(src):
    """Every ``constexpr int|float NAME = expr;`` of the source, evaluated
    in order (C integer division as Python's)."""
    out = {}
    for kind, name, expr in re.findall(
            r"^constexpr (int|float) (\w+) = ([^;]+);", src, re.M):
        out[name] = (eval(expr.replace("/", "//"), {}, dict(out))
                     if kind == "int" else float(expr.rstrip("f")))
    return out


K_ = _constants(SRC)
C, ALIGN, NT, NB, LEVELS, KC = (K_[n] for n in
                                ("C", "ALIGN", "NT", "NB", "LEVELS", "KC"))
SPAN, FIX = F32(K_["SPAN"]), F32(K_["kFix"])


def _body_return(head):
    """The expression the one-line C function of the source whose
    declaration ends with ``head`` returns."""
    m = re.search(re.escape(head) + r"\([^)]*\) \{\s*return ([^;]+);", SRC)
    assert m, head
    return m.group(1).replace("/", "//")


def slice_width(V, c=C):
    return eval(_body_return("constexpr int slice_width"), {},
                dict(K_, V=V, C=c))


def max_vocab():
    return eval(_body_return('extern "C" int repro_fused_sample_max_vocab'),
                {}, dict(K_))


def smem_bytes(V, park_raw, c=C):
    """``smem_bytes`` of the source: the fixed regions, then one slice (x)
    or two (x and raw) of slice_width(V) + ALIGN floats."""
    return K_["OFF_SLICE"] + (2 if park_raw else 1) * (
        slice_width(V, c) + ALIGN) * 4


def slices(V, c):
    w = slice_width(V, c)
    return [(min(V, r * w), min(V, (r + 1) * w)) for r in range(c)]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _combine_stats(a, b):
    """The kernel's combine_stats in f32: (m, l, argmax) of two parts."""
    (m, l, i), (m2, l2, i2) = a, b
    mn = max(m, m2)
    x = F32(0) if m == -np.inf else F32(l * np.exp(F32(m - mn)))
    y = F32(0) if m2 == -np.inf else F32(l2 * np.exp(F32(m2 - mn)))
    i = i2 if (m2 > m or (m2 == m and i2 < i)) else i
    return mn, F32(x + y), i


def _rank_stats(v, lo):
    if v.size == 0:
        return F32(-np.inf), F32(0), INT_MAX
    m = v.max()
    return m, F32(np.where(v == m, F32(1), np.exp(v - m)).sum(dtype=F32)), \
        lo + int(np.argmax(v))


def _bucket(hi, v, width):
    q = np.floor((F32(hi) - v) * F32(F32(1) / F32(width)))
    return np.clip(q, 0, NB - 1).astype(np.int64)


def _weights(v, m):
    return np.rint(np.exp(v - F32(m)).astype(F32) * FIX).astype(np.uint64)


class Row:
    """One row as the cluster sees it: the ranks' slices of x, and the
    passes' histograms summed over ranks."""

    def __init__(self, x, c):
        self.parts = [(lo, x[lo:hi]) for lo, hi in slices(len(x), c)]
        self.catch_passes = 0

    def hist(self, hi, width, m, sel_min):
        """Counts and f32 masses of one pass, the catch-all's mass 0."""
        cnt = np.zeros(NB, np.uint64)
        mass = np.zeros(NB, np.uint64)
        for _, v in self.parts:             # each rank's integer histogram
            sel = (v >= sel_min) & (v <= F32(hi))
            b = _bucket(hi, v[sel], width)
            cnt += np.bincount(b, minlength=NB).astype(np.uint64)
            inner = b < NB - 1
            np.add.at(mass, b[inner], _weights(v[sel][inner], m))
        return cnt.astype(np.int64), (mass.astype(np.float64)
                                      * 2.0 ** -44).astype(F32)

    def catch_mass(self, hi, width, m, sel_min):
        """The catch-all bucket's f32 mass, summed over ranks."""
        self.catch_passes += 1
        tot = np.uint64(0)
        for _, v in self.parts:
            sel = (v >= sel_min) & (v <= F32(hi))
            last = _bucket(hi, v[sel], width) == NB - 1
            tot += _weights(v[sel][last], m).sum(dtype=np.uint64)
        return F32(np.float64(tot) * 2.0 ** -44)


def _cross(cum, target):
    hit = np.nonzero(cum >= target)[0]
    return int(hit[0]) if hit.size else NB - 1


def model_row(x, g, k, p, min_p, raw, lp_k, c):
    """The kernel's arithmetic for one row over a cluster of c ranks."""
    row = Row(x, c)
    stats = functools.reduce(_combine_stats,
                             [_rank_stats(v, lo) for lo, v in row.parts])
    m, l, greedy = stats
    V = len(x)
    need_k, need_p = k > 0, p < 1
    tau_k, z = F32(-np.inf), l
    coarse = None
    if need_k or need_p:
        hi, width = F32(m), F32(SPAN / NB)
        rem = min(max(k, 1), V)
        above_mass, in_mass = F32(0), F32(0)
        for lvl in range(LEVELS if need_k else 1):
            cnt, mass = row.hist(hi, width, m, F32(-np.inf))
            if lvl == 0:
                coarse = mass.copy()
            b = _cross(np.cumsum(cnt), rem)
            if b == NB - 1 and lvl > 0:
                mass[NB - 1] = row.catch_mass(hi, width, m, F32(-np.inf))
            cum = np.cumsum(mass, dtype=F32)
            rem -= int(np.cumsum(cnt)[b] - cnt[b])
            above_mass = F32(above_mass + F32(cum[b] - mass[b]))
            in_mass = mass[b]
            hi = F32(hi - F32(b) * width)
            tau_k = F32(hi - width)
            width = F32(width / NB)
        if need_k:
            z = F32(above_mass + in_mass)
        else:
            tau_k = F32(-np.inf)
    tau_p = F32(-np.inf)
    if need_p:
        target = F32(F32(p) * z)
        cum = np.cumsum(coarse, dtype=F32)
        b = _cross(cum, target)
        above = F32(cum[b] - coarse[b])
        hi = F32(F32(m) - F32(b) * F32(SPAN / NB))
        tau_p = F32(hi - F32(SPAN / NB))
        width = F32(SPAN / NB / NB)
        for _ in range(1, LEVELS):
            _, mass = row.hist(hi, width, m, tau_k)
            b = _cross(np.cumsum(mass, dtype=F32), F32(target - above))
            if b == NB - 1:
                mass[NB - 1] = row.catch_mass(hi, width, m, tau_k)
            cum = np.cumsum(mass, dtype=F32)
            above = F32(above + F32(cum[b] - mass[b]))
            hi = F32(hi - F32(b) * width)
            tau_p = F32(hi - width)
            width = F32(width / NB)
    tau_m = F32(m + np.log(F32(min_p))) if min_p > 0 else F32(-np.inf)
    tau = max(tau_k, tau_p, tau_m)

    # the draw: each rank's argmax, merged (value desc, index asc)
    draws = []
    for lo, v in row.parts:
        sc = np.where(v >= tau, v + g[lo:lo + len(v)], F32(-1e30))
        draws.append((sc.max(), lo + int(np.argmax(sc))) if v.size else
                     (-np.inf, INT_MAX))
    sampled = min(draws, key=lambda d: (-d[0], d[1]))[1]
    out = dict(sampled=sampled, greedy=greedy, tau=tau, m=m, l=l)
    if raw is not None:
        rs = functools.reduce(_combine_stats, [
            _rank_stats(raw[lo:lo + len(v)], lo) for lo, v in row.parts])
        out.update(m_raw=rs[0], l_raw=rs[1])
        if lp_k > 0:
            out["top_vals"], out["top_idx"] = _model_lanes(raw, row, lp_k)
    return out, row


def _model_lanes(raw, row, K):
    """Rounds of at most KC: each rank's next entries below the last
    merged pick, its list sorted (value desc, index asc), the C lists
    merged."""
    vals, ids = [], []
    cur = (np.inf, -1)
    while len(ids) < K:
        count = min(KC, K - len(ids))
        lists = []
        for lo, v in row.parts:
            r = raw[lo:lo + len(v)]
            order = sorted((e for e in zip(r.tolist(), range(lo, lo + len(r)))
                            if e[0] > -np.inf and (e[0] < cur[0] or (
                                e[0] == cur[0] and e[1] > cur[1]))),
                           key=lambda e: (-e[0], e[1]))
            lists.append(order[:count])
        merged = sorted((e for lst in lists for e in lst),
                        key=lambda e: (-e[0], e[1]))[:count]
        merged += [(-np.inf, INT_MAX)] * (count - len(merged))
        vals += [e[0] for e in merged]
        ids += [e[1] for e in merged]
        cur = merged[-1]
    return np.array(vals, F32), np.array(ids, np.int32)


def model(x, g, k, p, mp, raw, lp_k, c):
    outs = [model_row(x[b], g[b], int(k[b]), F32(p[b]), F32(mp[b]),
                      None if raw is None else raw[b], lp_k, c)[0]
            for b in range(x.shape[0])]
    return {key: np.stack([np.asarray(o[key]) for o in outs])
            for key in outs[0]}


# ---------------------------------------------------------------------------
# the references
# ---------------------------------------------------------------------------


def _inputs(V, B, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 2.0, (B, V)).astype(F32)
    g = rng.gumbel(size=(B, V)).astype(F32)
    raw = rng.normal(0.0, 1.0, (B, V)).astype(F32)
    k = np.array([0, 1, 5, 40, 300, 0][:B], np.int32)
    p = np.array([1.0, 0.95, 0.9, 0.5, 0.9, 0.6][:B], F32)
    mp = np.array([0.0, 0.02, 0.1, 0.0, 0.0, 0.05][:B], F32)
    return x, g, k, p, mp, raw


@functools.lru_cache(maxsize=None)
def _references(V, lp_k):
    x, g, k, p, mp, raw = _inputs(V, 6, seed=V)
    kw = dict(lp_k=lp_k, with_lanes=True)
    plain = fused_sample_plain(*map(torch.from_numpy, (x, g, k, p, mp)),
                               raw=torch.from_numpy(raw), **kw)
    pallas = pallas_sample(*map(jnp.asarray, (x, g, k, p, mp)),
                           raw=jnp.asarray(raw), interpret=True, **kw)
    return (x, g, k, p, mp, raw), plain, pallas


def _compare(got, want, exact_tau=False):
    for key, w in want.items():
        a, w = np.asarray(got[key]), np.asarray(w)
        if key in ("sampled", "greedy", "top_idx") or (
                key == "tau" and exact_tau):
            np.testing.assert_array_equal(a, w, err_msg=key)
        else:
            np.testing.assert_allclose(a, w, err_msg=key, **TOL)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def test_constants_are_read_from_the_kernel():
    """The split the model follows is the source's: a cluster of 8 (the
    portable size) with 16-byte slice edges, and ops' refusal limit is
    the source's own formula over its layout."""
    assert (C, ALIGN, NB, LEVELS) == (8, 4, 256, 3)
    assert 1 <= KC <= 32           # a round's list fits one warp's merge
    assert K_["OFF_SLICE"] % 16 == 0
    assert "337,888" in ops.__doc__ and max_vocab() == 337888


@pytest.mark.parametrize("c", [1, 8, 16])
@pytest.mark.parametrize("V", [1, 7, 31, 32, 33, 1000, 4097, 50257, 128256,
                               151936, 256000])
def test_slices_cover_the_row_on_16_byte_edges(V, c):
    """Contiguous, in rank order, each starting on an ALIGN multiple, the
    last ending at V, none longer than slice_width; where the row has at
    most ALIGN * (c - 1) entries, the last rank's slice is empty."""
    sl = slices(V, c)
    assert sl[0][0] == 0 and sl[-1][1] == V
    assert all(a[1] == b[0] for a, b in zip(sl, sl[1:]))
    assert all(lo % ALIGN == 0 or lo == V for lo, _ in sl)
    assert max(hi - lo for lo, hi in sl) <= slice_width(V, c)
    if V <= ALIGN * (c - 1):
        assert sl[-1][0] == sl[-1][1] == V


@pytest.mark.parametrize("c", [1, 8, 16])
@pytest.mark.parametrize("V,lp_k", [(7, 7), (1000, 40), (4097, 5),
                                    (50257, 3)])
def test_split_model_matches_plain_and_pallas(V, lp_k, c):
    """Mixed top-k / top-p / min-p rows through the cluster model: the
    port's plain version's and the Pallas kernel's tokens and lane ids,
    for 1, 8 and 16 ranks (V 7 leaves ranks empty; 40 lanes take two
    rounds of KC)."""
    args, plain, pallas = _references(V, lp_k)
    got = model(*args, lp_k, c)
    _compare(got, {k: v.numpy() for k, v in plain.items()})
    _compare(got, {k: np.asarray(v) for k, v in pallas.items()})


@pytest.mark.parametrize("V", [1000, 4097])
def test_crossings_on_the_catch_all_bucket(V):
    """The rows whose crossings land on a refinement level's catch-all
    bucket (count levels 1 and 2, a mass level): the model sums that
    bucket apart where the kernel does, and gives the plain version's and
    the Pallas kernel's tau bit for bit; without that sum the row whose
    last count crossing lands there keeps the wrong mass."""
    x, g, k, p, mp, raw = (t.numpy() for t in catch_all_rows(
        torch.Generator().manual_seed(11), V, torch.device("cpu")))
    kw = dict(lp_k=2, with_lanes=True)
    plain = fused_sample_plain(*map(torch.from_numpy, (x, g, k, p, mp)),
                               raw=torch.from_numpy(raw), **kw)
    pallas = pallas_sample(*map(jnp.asarray, (x, g, k, p, mp)),
                           raw=jnp.asarray(raw), interpret=True, **kw)
    got = model(x, g, k, p, mp, raw, 2, C)
    _compare(got, {kk: v.numpy() for kk, v in plain.items()}, exact_tau=True)
    _compare(got, {kk: np.asarray(v) for kk, v in pallas.items()},
             exact_tau=True)
    rows = [model_row(x[b], g[b], int(k[b]), p[b], mp[b], raw[b], 2, C)[1]
            for b in range(3)]
    assert all(r.catch_passes >= 1 for r in rows)
    z = ops.joint_threshold_plain(*map(torch.from_numpy, (x, k, p, mp)))["z"]
    assert float(z[1]) > 10.0      # the catch-all mass is most of row 1's z


def test_fixed_point_catch_all_is_zero_at_the_coarse_level():
    """The kernel skips the coarse level's catch-all mass: from 31.875
    nats under the max down, exp(x - m) * 2^44 rounds to 0."""
    d = -np.concatenate([np.linspace(31.875, 40.0, 4001, dtype=F32),
                         np.array([31.875, np.inf], F32)])
    assert not _weights(d, F32(0)).any()
    assert _weights(np.array([-31.0], F32), F32(0))[0] > 0


@pytest.mark.parametrize("level", range(3))
def test_bucket_widths_are_powers_of_two(level):
    """(hi - x) * (1 / width) is (hi - x) / width bit for bit at each
    level's width, so the kernel's multiply bins as the reference's
    divide."""
    width = F32(SPAN / F32(NB) ** (level + 1))
    assert np.frexp(width)[0] == 0.5
    rng = np.random.default_rng(level)
    diff = (rng.normal(0, 4, 100000) * 10.0 ** rng.integers(-8, 2, 100000)
            ).astype(F32)
    np.testing.assert_array_equal(diff * (F32(1) / width), diff / width)


def _largest_vocab():
    """The largest row the repo's configs (both packages) sample, as the
    engines pad it (to a multiple of 16)."""
    sizes = [jax_configs.get_config(a).vocab_size
             for a in jax_configs.ARCH_IDS]
    sizes += [torch_configs.get_config(a).vocab_size
              for a in torch_configs.ARCH_IDS]
    return max(-(-s // 16) * 16 for s in sizes)


def test_shared_memory_fits_at_the_largest_vocabulary():
    """At the largest vocabulary of the repo's configs (256000), a CTA's
    layout fits the 232,448 bytes an H100 block may take; raw is parked
    beside x at Llama's and Qwen's vocabularies and not at 256000; the
    kernel's limit is the last V whose layout fits."""
    limit = K_["SMEM_LIMIT"]
    assert limit == 232448
    V = _largest_vocab()
    assert V == 256000
    assert smem_bytes(V, False) <= limit < smem_bytes(V, True)
    for v in (128256, 151936):
        assert smem_bytes(v, True) <= limit
    top = max_vocab()
    assert top >= V
    assert smem_bytes(top, False) <= limit < smem_bytes(top + 1, False)
