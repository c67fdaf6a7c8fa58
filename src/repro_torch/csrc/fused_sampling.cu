// Fused sampling for Hopper (sm_90a): joint top-k / top-p / min-p
// threshold and Gumbel-max draw, with optional raw-logit logprob lanes,
// one row split across a thread-block cluster.
//
// Replaces the TPU kernel
// repro/kernels/fused_sampling/fused_sampling.py::fused_sampling_tpu, under
// the contract of its oracle ref.py.  Per row of processed logits x (V,) f32
// with Gumbel noise g (V,) f32 and per-row k (int), p, min_p (f32):
//
//   * online-softmax stats m = max x, l = sum exp(x - m), greedy = argmax x
//     (first index of the max);
//   * tau_k and the kept mass Z from LEVELS = 3 rounds of NB = 256-bucket
//     count histograms over (m - SPAN, m] (SPAN = 32 nats), each round
//     recursing into the bucket where the cumulative count crosses k;
//   * tau_p from two further rounds of mass histograms of x >= tau_k, the
//     coarse level reused from the first tau_k round, crossing p * Z;
//   * tau_m = m + log(min_p); tau = max(tau_k, tau_p, tau_m), -inf for a
//     disabled filter;
//   * the draw argmax over x >= tau of x + g (first index on ties);
//   * with lanes: m_raw, l_raw of the raw logits and their top K values and
//     ids (ties to the lowest id, as jax.lax.top_k).
//
// What bounds it on an H100: bytes.  Each input is read once from device
// memory: B * V * 4 * (2, or 3 with lanes) bytes, 8.2 MB (12.3 MB) at B = 8,
// V = 128256, 2.45 us (3.67 us) at 3.35 TB/s; the arithmetic is a few
// operations per element per pass.  The first version ran one CTA per row
// (8 of the 132 SMs at B = 8) and up to eight passes over the row from L2:
// 0.50 ms, 16 GB/s.
//
// Design.
// - Split: each row is a cluster of C = 8 CTAs (the portable cluster
//   size), grid B * C.  Rank r owns the slice [r * W, (r + 1) * W) of the
//   row, clipped to V, with W = V / C rounded up to a multiple of ALIGN = 4
//   entries (16 bytes); a rank whose slice is empty (V <= 4 * (C - 1))
//   still joins every cluster barrier with empty partials.
// - Park: each rank copies its slice of x into shared memory once, by
//   16-byte cp.async (a row whose start is not 16-byte aligned, as at V =
//   50257, takes scalar loads for its head and tail), and every later pass
//   reads shared memory.  The raw row's slice is parked beside it where both
//   fit (V <= 168928: Llama's and Qwen's vocabularies), else read from
//   device memory once for its stats and again from L2 by the lanes.  g is
//   read once, by the draw, at the kept entries only, BATCH loads in flight
//   a thread.  The slice must fit beside the histograms: V <= 337888
//   (repro_fused_sample_max_vocab), past every vocabulary of the repo.
// - Stats: each thread takes the max of its entries, then the sum of
//   exp(v - max) (two loops: no exponential waits on a running max); each
//   rank reduces its slice to (m, l, argmax), for x and raw; every rank
//   reads the C partials from the others' shared memory (distributed
//   shared memory, cluster.map_shared_rank) and merges them in rank order,
//   so all ranks hold the same bits.
// - Histograms: each pass bins the rank's parked slice into per-warp NB
//   histograms (u32 counts, u64 fixed-point masses in units of 2^-44), sums
//   the warps into the CTA's histogram, then one cluster barrier, then
//   every rank sums the C histograms from distributed shared memory and
//   finds the crossing itself.  The totals are integers, so they are the
//   one-CTA kernel's totals bit for bit, and so are the f32 masses, the
//   crossings, tau and the tokens.  Two histogram buffers alternate: a rank
//   overwrites buffer b two passes later, after a barrier that every rank
//   reaches only once it has read b, so one barrier a pass is enough.  A
//   row skips the passes its filters do not need (k <= 0, p >= 1), the
//   whole cluster alike.
// - What held the passes back on the card (PERF.md, section 6): a 64-bit
//   shared atomic add is a compare-and-swap loop on sm_90, and every entry
//   paid a divide, a floor, two conversions and an exponential on the
//   quarter-rate unit, even the many that only fall into the catch-all
//   bucket NB-1.  So a mass is added as two native 32-bit atomics with the
//   carry; the bucket comes from a multiply by the power-of-two reciprocal
//   of the width and a round-down add of 2^23 (exact); a thread takes
//   BATCH entries' buckets before any atomic, and a warp whose batch put
//   none in buckets 0..NB-2 skips the atomics; and a catch-all entry is
//   only counted.  Its mass is summed apart (catch_mass) only where a
//   crossing past the coarse level lands on NB-1, the one place the
//   reference reads it; at the coarse level it is 0 (31.875 nats or more
//   under the max, exp(x - m) * 2^44 rounds to 0).
// - Draw and lanes: each rank takes the argmax of x + g over its kept
//   entries, and for the lanes its local top n = min(K, KC) of raw: each
//   thread keeps its best entry below the last pick, a block argmax takes
//   the best of those, and the warp of the thread that owned the pick
//   rescans that thread's entries.  One cluster barrier publishes the draw
//   and the candidate lists; a warp merges the C draws and the C sorted
//   lists (value descending, index ascending); rank 0 writes the outputs.
//   K > KC takes further rounds of KC, each rank's list found below the
//   last merged pick.
// - Synchronisation: barrier.cluster arrive.release / wait.acquire at pass
//   boundaries only, about 8 a launch (stats, up to 5 histogram passes,
//   the draw, and a last one that keeps every rank's shared memory alive
//   until the others have read it); no cluster-scope arrival inside a loop
//   over entries, no workspace in device memory, no global atomics, one
//   launch.
// - Residency: one CTA an SM (128 KB of shared memory at V = 128256, 192
//   KB with raw parked), 15 clusters of 8 resident on an H100; C = 16 was
//   slower at B = 8 (PERF.md, section 6).
//
// Determinism: a fixed seed must give the same stream, so no float is
// summed in an order that depends on scheduling.  Counts and fixed-point
// masses are integer sums; the stats reductions run in a fixed tree inside
// a CTA and in rank order across the cluster.  The fixed point's error,
// below 2^-45 per entry, is far under the f32 rounding of the reference's
// own sums.  Registers (64, no spills), times and the variants tried:
// PERF.md, section 6.

#include <cooperative_groups.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int C = 8;               // CTAs of a cluster: ranks sharing a row
constexpr int ALIGN = 4;           // slice edges at multiples of 4 entries
constexpr int NT = 512;            // threads a CTA
constexpr int NW = NT / 32;        // warps a CTA
constexpr int NB = 256;            // histogram buckets per level
constexpr int LEVELS = 3;          // coarse + 2 refinements
constexpr int KC = 32;             // lane candidates a rank offers a round
constexpr int BATCH = 8;           // entries a thread loads before using
constexpr int SMALL_BYTES = 512;   // the CTA's scalars (struct Small)
constexpr int SMEM_LIMIT = 232448; // most shared memory a CTA may take
constexpr float SPAN = 32.f;       // nats below the max of the coarse level
constexpr float kFix = 17592186044416.f;         // 2^44
constexpr double kUnfix = 1.0 / 17592186044416.0;
constexpr unsigned kFull = 0xffffffffu;

// Dynamic shared memory, byte offsets: the per-warp histograms, the CTA's
// histograms (two buffers, read by the other ranks), the level arrays, the
// lane candidates (two buffers, read by the other ranks), the merged lists,
// the scalars, then the parked slices (x, and raw where it fits), each
// slice_width(V) + ALIGN floats.
constexpr int OFF_WMASS = 0;                          // u64 [NW][NB]
constexpr int OFF_WCNT = OFF_WMASS + NW * NB * 8;     // u32 [NW][NB]
constexpr int OFF_HMASS = OFF_WCNT + NW * NB * 4;     // u64 [2][NB]
constexpr int OFF_HCNT = OFF_HMASS + 2 * NB * 8;      // u32 [2][NB]
constexpr int OFF_LEVEL = OFF_HCNT + 2 * NB * 4;      // 5 x [NB] of 4 bytes
constexpr int OFF_CAND = OFF_LEVEL + 5 * NB * 4;      // Arg [2][KC]
constexpr int OFF_MERGE = OFF_CAND + 2 * KC * 8;      // Arg [C][KC]
constexpr int OFF_SMALL = OFF_MERGE + C * KC * 8;     // struct Small
constexpr int OFF_SLICE = OFF_SMALL + SMALL_BYTES;    // f32 slices

static_assert(C >= 1 && C <= 16 && (C & (C - 1)) == 0, "cluster size");
static_assert(OFF_SLICE % 16 == 0, "slices start 16-byte aligned");

struct Arg {    // a candidate of an argmax in (value desc, index asc) order
  float v;
  int i;
};

struct Stats {  // an online softmax with argmax
  float m, l;
  int i;
};

struct Small {
  unsigned long long red_w[NW];
  unsigned long long pub_catch;  // this rank's catch-all mass (read remotely)
  float red_f[NW], red_g[NW];
  int red_i[NW];
  Stats pub_stats[2];   // this rank's partials of x and raw (read remotely)
  Arg pub_draw;         // this rank's draw (read remotely)
  Stats row[2];         // the merged stats of x and raw
  Arg cursor;           // the last merged lane pick
  float hi, tau_k, tau_p, above, z;
  int b;                // the crossing bucket of the last pass
};
static_assert(sizeof(Small) <= SMALL_BYTES, "scalars fit their region");

// Entries a rank owns: V / C rounded up to a multiple of ALIGN.
__host__ __device__ constexpr int slice_width(int V) {
  return (V + C * ALIGN - 1) / (C * ALIGN) * ALIGN;
}

__host__ __device__ constexpr size_t smem_bytes(int V, bool park_raw) {
  return OFF_SLICE +
         (park_raw ? 2 : 1) * static_cast<size_t>(slice_width(V) + ALIGN) * 4;
}

// ---------------------------------------------------------------- reductions
// (m, l, idx) of an online softmax with argmax: the max, the sum of exp(x -
// max), and the first index of the max.
__device__ __forceinline__ void combine_stats(float& m, float& l, int& i,
                                              float m2, float l2, int i2) {
  const float mn = fmaxf(m, m2);
  const float a = (m == -INFINITY) ? 0.f : l * expf(m - mn);
  const float b = (m2 == -INFINITY) ? 0.f : l2 * expf(m2 - mn);
  i = (m2 > m || (m2 == m && i2 < i)) ? i2 : i;
  m = mn;
  l = a + b;
}

// argmax in (value desc, index asc) order
__device__ __forceinline__ void combine_arg(float& v, int& i, float v2,
                                            int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ __forceinline__ void warp_arg(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    combine_arg(v, i, __shfl_xor_sync(kFull, v, o),
                __shfl_xor_sync(kFull, i, o));
}

__device__ void block_stats(float& m, float& l, int& i, Small& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    combine_stats(m, l, i, __shfl_xor_sync(kFull, m, o),
                  __shfl_xor_sync(kFull, l, o), __shfl_xor_sync(kFull, i, o));
  if (lane == 0) {
    s.red_f[warp] = m;
    s.red_g[warp] = l;
    s.red_i[warp] = i;
  }
  __syncthreads();
  m = lane < NW ? s.red_f[lane] : -INFINITY;
  l = lane < NW ? s.red_g[lane] : 0.f;
  i = lane < NW ? s.red_i[lane] : INT_MAX;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    combine_stats(m, l, i, __shfl_xor_sync(kFull, m, o),
                  __shfl_xor_sync(kFull, l, o), __shfl_xor_sync(kFull, i, o));
  __syncthreads();  // the scratch is reused by the next reduction
}

__device__ void block_arg(float& v, int& i, Small& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_arg(v, i);
  if (lane == 0) {
    s.red_f[warp] = v;
    s.red_i[warp] = i;
  }
  __syncthreads();
  v = lane < NW ? s.red_f[lane] : -INFINITY;
  i = lane < NW ? s.red_i[lane] : INT_MAX;
  warp_arg(v, i);
  __syncthreads();
}

// The cluster barrier: this thread's earlier writes (its shared memory
// included) become visible to every thread of the cluster that waits.
__device__ __forceinline__ void cluster_sync() {
  sm90::cluster_arrive_release();
  sm90::cluster_wait();
}

// This thread's (m, l, argmax) over its entries of a slice: the max and its
// first index, then the sum of exp(v - m), 1 at each maximum.  Two loops,
// so that the exponentials do not wait on a running max.
__device__ __forceinline__ void thread_stats(const float* vs, int n, int lo,
                                             float& m, float& l, int& i) {
#pragma unroll 8
  for (int j = threadIdx.x; j < n; j += NT) {
    const float v = vs[j];
    if (v > m) {
      m = v;
      i = lo + j;
    }
  }
  if (m == -INFINITY) return;
#pragma unroll 8
  for (int j = threadIdx.x; j < n; j += NT) {
    const float v = vs[j];
    l += v == m ? 1.f : expf(v - m);
  }
}

// ------------------------------------------------------------------ parking
// Copies src[0, n) into shared memory at region (slice_width + ALIGN
// floats, 16-byte aligned) and returns where src[0] landed: src's offset
// within its 16 bytes is kept, so the aligned body moves by 16-byte
// cp.async and only a misaligned head and tail by scalar loads.  The caller
// commits and waits.
__device__ const float* park(float* region, const float* src, int n) {
  const int mis =
      static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & (ALIGN - 1));
  float* dst = region + mis;
  const int head = min((ALIGN - mis) & (ALIGN - 1), n);
  const int nv = (n - head) / ALIGN;
  for (int j = threadIdx.x; j < head; j += NT) dst[j] = src[j];
  for (int q = threadIdx.x; q < nv; q += NT)
    sm90::cp_async16(dst + head + ALIGN * q, src + head + ALIGN * q);
  for (int j = head + ALIGN * nv + threadIdx.x; j < n; j += NT)
    dst[j] = src[j];
  return dst;
}

// ---------------------------------------------------------------- histograms
struct Hist {
  unsigned long long* wmass;   // [NW][NB]
  unsigned* wcnt;              // [NW][NB]
  unsigned long long* hmass;   // [2][NB], read by the other ranks
  unsigned* hcnt;              // [2][NB], read by the other ranks
  float* mass;                 // the row's bucket masses (f32)
  float* coarse;               // the coarse level's masses, kept for tau_p
  float* cum_mass;
  int* cnt;                    // the row's bucket counts
  int* cum_cnt;
};

// The bucket of x in a pass: floor((hi - x) / width) clamped to [0, NB-1].
// width = SPAN / NB^L is a power of two, so (hi - x) * (1 / width) is the
// quotient itself, and adding 2^23 rounding down leaves floor(q) in the low
// bits: no divide and no conversion on the quarter-rate unit.
__device__ __forceinline__ int bucket(float hi, float x, float inv) {
  const float q = fminf(fmaxf((hi - x) * inv, 0.f), float(NB - 1));
  return __float_as_int(__fadd_rd(q, 8388608.f)) - 0x4B000000;
}

// exp(x - m) in fixed point, units of 2^-44.
__device__ __forceinline__ unsigned long long weight(float x, float m) {
  return __float2ull_rn(expf(x - m) * kFix);
}

// Adds w to a 64-bit mass of a warp histogram by two native 32-bit shared
// atomics on its halves, the carry out of the low half added to the high
// one (a 64-bit shared atomic add is a compare-and-swap loop on sm_90).
// Exact: the two halves always hold the integer sum.
__device__ __forceinline__ void add_mass(unsigned long long* slot,
                                         unsigned long long w) {
  unsigned* half = reinterpret_cast<unsigned*>(slot);
  const unsigned lo = static_cast<unsigned>(w);
  const unsigned old = atomicAdd(half, lo);
  const unsigned hi = static_cast<unsigned>(w >> 32) + (old + lo < old);
  if (hi != 0) atomicAdd(half + 1, hi);
}

// One pass: bin every parked x with sel_min <= x <= hi into NB buckets of
// `width` below hi (values under the interval land in the catch-all NB-1),
// counting (kCount) and summing exp(x - m) over buckets 0..NB-2; then the
// cluster's totals, summed from every rank's histogram in buffer `buf`.
// Leaves the row's counts in h.cnt (kCount) and f32 masses in h.mass, with
// the catch-all's mass 0 (catch_mass finds it where a crossing needs it).
template <bool kCount>
__device__ void hist_pass(const float* xs, int n, float hi, float width,
                          float m, float sel_min, const Hist& h, int buf,
                          cg::cluster_group& cluster) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned* wc = h.wcnt + warp * NB;
  unsigned long long* wm = h.wmass + warp * NB;
  for (int b = lane; b < NB; b += 32) {   // this warp's own histogram, last
    if (kCount) wc[b] = 0;                // read before the previous pass's
    wm[b] = 0;                            // cluster barrier
  }
  __syncwarp();
  const float inv = 1.f / width;
  unsigned c_catch = 0;
  for (int j0 = 0; j0 < n; j0 += BATCH * NT) {   // as many turns in every
    float vk[BATCH];                             // lane (for __any_sync)
    int bk[BATCH];   // the bucket, -1 where x is not selected
    bool any = false;
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int j = j0 + u * NT + tid;
      vk[u] = j < n ? xs[j] : 0.f;
      bk[u] = (j < n && vk[u] >= sel_min && vk[u] <= hi)
                  ? bucket(hi, vk[u], inv)
                  : -1;
      c_catch += bk[u] == NB - 1;
      any |= bk[u] >= 0 && bk[u] < NB - 1;
    }
    // past the coarse level nearly every entry is in the catch-all: a warp
    // whose batch put none in a bucket skips the atomics
    if (!__any_sync(kFull, any)) continue;
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      if (bk[u] >= 0 && bk[u] < NB - 1) {
        if (kCount) atomicAdd(wc + bk[u], 1u);
        add_mass(wm + bk[u], weight(vk[u], m));
      }
    }
  }
  if (kCount) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      c_catch += __shfl_xor_sync(kFull, c_catch, o);
    if (lane == 0) wc[NB - 1] += c_catch;   // no atomic touched NB-1
  }
  __syncthreads();
  unsigned* hc = h.hcnt + buf * NB;
  unsigned long long* hm = h.hmass + buf * NB;
  if (tid < NB) {
    unsigned c = 0;
    unsigned long long s = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if (kCount) c += h.wcnt[w * NB + tid];
      s += h.wmass[w * NB + tid];
    }
    if (kCount) hc[tid] = c;
    hm[tid] = s;
  }
  cluster_sync();   // every rank's histogram of this pass is in place
  if (tid < NB) {
    unsigned c = 0;
    unsigned long long s = 0;
#pragma unroll
    for (int r = 0; r < C; ++r) {
      if (kCount) c += cluster.map_shared_rank(hc, r)[tid];
      s += cluster.map_shared_rank(hm, r)[tid];
    }
    if (kCount) h.cnt[tid] = static_cast<int>(c);
    h.mass[tid] = static_cast<float>(static_cast<double>(s) * kUnfix);
  }
  __syncthreads();
}

// The mass of the catch-all bucket NB-1 of the pass at (hi, width,
// sel_min), summed over the cluster, into h.mass[NB-1].  A pass leaves it
// 0, and the crossings read it only where they land on NB-1: a count
// crossing's kept mass, and the mass above a crossing, which the reference
// takes as a float difference cum - mass.  At the coarse level (hi = m,
// width SPAN / NB) it is 0 in any case: NB-1 starts 31.875 nats under m,
// where exp(x - m) * 2^44 rounds to 0.  The whole CTA calls it.
__device__ void catch_mass(const float* xs, int n, float hi, float width,
                           float m, float sel_min, const Hist& h, Small& s,
                           cg::cluster_group& cluster) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float inv = 1.f / width;
  unsigned long long w = 0;
  for (int j = tid; j < n; j += NT) {
    const float v = xs[j];
    if (v >= sel_min && v <= hi && bucket(hi, v, inv) == NB - 1)
      w += weight(v, m);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) w += __shfl_xor_sync(kFull, w, o);
  if (lane == 0) s.red_w[warp] = w;
  __syncthreads();
  if (tid == 0) {
    unsigned long long t = 0;
    for (int i = 0; i < NW; ++i) t += s.red_w[i];
    s.pub_catch = t;
  }
  cluster_sync();   // every rank's catch-all mass is in place
  if (tid < 32) {
    unsigned long long t =
        lane < C ? cluster.map_shared_rank(&s.pub_catch, lane)[0] : 0ull;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(kFull, t, o);
    if (lane == 0)
      h.mass[NB - 1] = static_cast<float>(static_cast<double>(t) * kUnfix);
  }
  __syncthreads();
}

// Warp 0 only: inclusive cumulative sums of an NB array, each lane owning 8
// consecutive buckets (a sequential sum inside the lane, a fixed scan across
// lanes).
template <typename T>
__device__ void warp_cumsum(const T* per, T* cum, int lane) {
  T loc[NB / 32];
  T s = 0;
#pragma unroll
  for (int t = 0; t < NB / 32; ++t) {
    s += per[lane * (NB / 32) + t];
    loc[t] = s;
  }
  T inc = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  T ex = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) ex = 0;
#pragma unroll
  for (int t = 0; t < NB / 32; ++t) cum[lane * (NB / 32) + t] = ex + loc[t];
  __syncwarp();
}

// Warp 0 only: the first bucket whose cumulative value reaches `target`
// (NB-1 when none does).
template <typename T>
__device__ int warp_cross(const T* cum, T target, int lane) {
  int first = NB;
#pragma unroll
  for (int t = NB / 32 - 1; t >= 0; --t)
    if (cum[lane * (NB / 32) + t] >= target) first = lane * (NB / 32) + t;
  const unsigned hit = __ballot_sync(kFull, first < NB);
  if (hit == 0) return NB - 1;
  return __shfl_sync(kFull, first, __ffs(hit) - 1);
}

// ---------------------------------------------------------------- the lanes
// This thread's best raw entry strictly below `cur` in (value desc, index
// asc) order; -inf entries are never taken (-inf, INT_MAX when none is).
__device__ __forceinline__ Arg best_below(const float* rs, int n, int lo,
                                          Arg cur) {
  Arg b{-INFINITY, INT_MAX};
#pragma unroll 4
  for (int j = threadIdx.x; j < n; j += NT) {
    const float v = rs[j];
    const int id = lo + j;
    if ((v < cur.v || (v == cur.v && id > cur.i)) && v > b.v) {
      b.v = v;
      b.i = id;
    }
  }
  return b;
}

// The same over the entries of thread `owner` (owner + q * NT), found by
// the owner's whole warp at once; the result in every lane.
__device__ __forceinline__ Arg warp_best_below(const float* rs, int n, int lo,
                                               int owner, Arg cur, int lane) {
  Arg b{-INFINITY, INT_MAX};
  for (int j = owner + lane * NT; j < n; j += 32 * NT) {
    const float v = rs[j];
    const int id = lo + j;
    if ((v < cur.v || (v == cur.v && id > cur.i)) && v > b.v) {
      b.v = v;
      b.i = id;
    }
  }
  warp_arg(b.v, b.i);
  return b;
}

// The rank's next `count` raw entries in order into out[0, count), from
// each thread's candidate `mine` (updated: the warp of a pick's owner
// rescans the owner's entries below it).  Sentinels (-inf, INT_MAX) past
// the rank's last.
__device__ void local_picks(const float* rs, int n, int lo, Arg& mine,
                            int count, Arg* out, Small& s) {
  const int tid = threadIdx.x;
  for (int t = 0; t < count; ++t) {
    float v = mine.v;
    int i = mine.i;
    block_arg(v, i, s);
    if (tid == 0) out[t] = Arg{v, i};
    if (i == INT_MAX) {   // the whole CTA alike: no entry left
      if (tid == 0)
        for (int u = t + 1; u < count; ++u) out[u] = Arg{-INFINITY, INT_MAX};
      break;
    }
    const int owner = (i - lo) % NT;
    if (tid >> 5 == owner >> 5) {   // the owner's warp, all lanes
      const Arg next = warp_best_below(rs, n, lo, owner, Arg{v, i}, tid & 31);
      if (tid == owner) mine = next;
    }
  }
}

// Warp 0 only: the first `count` of the C ranks' sorted lists in buffer
// `cand`, merged in (value desc, index asc) order; rank 0 writes them to
// out[0, count).  Returns the last.
__device__ Arg merge_lists(const Arg* cand, Arg* mb, int count, int lane,
                           bool write, float* out_v, int* out_i,
                           cg::cluster_group& cluster) {
  for (int e = lane; e < C * count; e += 32) {
    const int c = e / count, t = e - c * count;
    mb[c * KC + t] = cluster.map_shared_rank(cand, c)[t];
  }
  __syncwarp();
  int pos = 0;          // lane c's place in rank c's list
  Arg last{-INFINITY, INT_MAX};
  for (int t = 0; t < count; ++t) {
    const Arg head = (lane < C && pos < count) ? mb[lane * KC + pos]
                                               : Arg{-INFINITY, INT_MAX};
    float v = head.v;
    int i = head.i;
    warp_arg(v, i);
    if (i != INT_MAX && head.i == i) ++pos;
    if (write && lane == 0) {
      out_v[t] = v;
      out_i[t] = i;
    }
    last = Arg{v, i};
  }
  return last;
}

// ---------------------------------------------------------------- the kernel
__global__ void __cluster_dims__(C, 1, 1) __launch_bounds__(NT)
fused_sample_kernel(const float* __restrict__ logits,
                    const float* __restrict__ gumbel,
                    const int* __restrict__ k_rows,
                    const float* __restrict__ p_rows,
                    const float* __restrict__ minp_rows,
                    const float* __restrict__ raw, int V, int lanes,
                    int park_raw, int* __restrict__ o_sampled,
                    int* __restrict__ o_greedy, float* __restrict__ o_tau,
                    float* __restrict__ o_m, float* __restrict__ o_l,
                    float* __restrict__ o_m_raw, float* __restrict__ o_l_raw,
                    float* __restrict__ o_top_v, int* __restrict__ o_top_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / C, tid = threadIdx.x, lane = tid & 31;
  Hist h;
  h.wmass = reinterpret_cast<unsigned long long*>(smem + OFF_WMASS);
  h.wcnt = reinterpret_cast<unsigned*>(smem + OFF_WCNT);
  h.hmass = reinterpret_cast<unsigned long long*>(smem + OFF_HMASS);
  h.hcnt = reinterpret_cast<unsigned*>(smem + OFF_HCNT);
  h.mass = reinterpret_cast<float*>(smem + OFF_LEVEL);
  h.coarse = h.mass + NB;
  h.cum_mass = h.coarse + NB;
  h.cnt = reinterpret_cast<int*>(h.cum_mass + NB);
  h.cum_cnt = h.cnt + NB;
  Arg* cand = reinterpret_cast<Arg*>(smem + OFF_CAND);
  Arg* mb = reinterpret_cast<Arg*>(smem + OFF_MERGE);
  Small& s = *reinterpret_cast<Small*>(smem + OFF_SMALL);
  float* region = reinterpret_cast<float*>(smem + OFF_SLICE);

  // this rank's slice [lo, lo + n) of the row
  const int W = slice_width(V);
  const int lo = min(V, rank * W), n = min(V - lo, W);
  const size_t base = static_cast<size_t>(row) * V + lo;
  const bool with_raw = lanes >= 0;
  const float* xs = park(region, logits + base, n);
  const float* rs = with_raw ? raw + base : nullptr;
  if (with_raw && park_raw) rs = park(region + W + ALIGN, raw + base, n);
  sm90::cp_async_commit();

  // ---- stats: m, l, greedy, and the raw row's m, l and each thread's best
  // raw entry (its first lane candidate)
  float mr = -INFINITY, lr = 0.f;
  int ri = INT_MAX;
  if (with_raw && !park_raw)   // from device memory, while the copies fly
    thread_stats(rs, n, lo, mr, lr, ri);
  sm90::cp_async_wait<0>();
  __syncthreads();
  if (with_raw && park_raw) thread_stats(rs, n, lo, mr, lr, ri);
  Arg mine{mr, ri};

  float m = -INFINITY, l = 0.f;
  int gi = INT_MAX;
  thread_stats(xs, n, lo, m, l, gi);
  block_stats(m, l, gi, s);
  if (with_raw) block_stats(mr, lr, ri, s);
  if (tid == 0) {
    s.pub_stats[0] = Stats{m, l, gi};
    s.pub_stats[1] = Stats{mr, lr, ri};
  }
  cluster_sync();   // every rank has started and published its partials
  if (tid < 32) {   // merge the C partials in rank order: lanes 0..15 x's,
    const int q = lane >> 4, first = lane & 16;   // lanes 16..31 raw's
    Stats p{-INFINITY, 0.f, INT_MAX};
    if (lane - first < C && (q == 0 || with_raw))
      p = cluster.map_shared_rank(&s.pub_stats[q], lane - first)[0];
    Stats a{__shfl_sync(kFull, p.m, first), __shfl_sync(kFull, p.l, first),
            __shfl_sync(kFull, p.i, first)};
    for (int c = 1; c < C; ++c)
      combine_stats(a.m, a.l, a.i, __shfl_sync(kFull, p.m, first + c),
                    __shfl_sync(kFull, p.l, first + c),
                    __shfl_sync(kFull, p.i, first + c));
    if (lane == first) s.row[q] = a;
  }
  __syncthreads();
  m = s.row[0].m;
  l = s.row[0].l;
  gi = s.row[0].i;

  const int k = k_rows[row];
  const float p = p_rows[row], min_p = minp_rows[row];
  const bool need_k = k > 0, need_p = p < 1.f;
  int pass = 0;     // histogram passes so far: the buffer alternates

  // ---- tau_k: count-crossing refinement (+ the coarse mass for tau_p)
  float tau_k = -INFINITY, z = l;
  if (need_k || need_p) {
    float hi = m, width = SPAN / NB;
    int rem = min(max(k, 1), V);
    float above_mass = 0.f, in_mass = 0.f;
    for (int lvl = 0; lvl < (need_k ? LEVELS : 1); ++lvl) {
      hist_pass<true>(xs, n, hi, width, m, -INFINITY, h, pass++ & 1,
                      cluster);
      if (lvl == 0 && tid < NB) h.coarse[tid] = h.mass[tid];
      if (tid < 32) {
        warp_cumsum(h.cnt, h.cum_cnt, lane);
        const int b = warp_cross(h.cum_cnt, rem, lane);
        if (lane == 0) s.b = b;
      }
      __syncthreads();
      if (s.b == NB - 1 && lvl > 0)   // the whole cluster alike
        catch_mass(xs, n, hi, width, m, -INFINITY, h, s, cluster);
      if (tid < 32) {
        const int b = s.b;
        warp_cumsum(h.mass, h.cum_mass, lane);
        rem -= h.cum_cnt[b] - h.cnt[b];
        above_mass = above_mass + (h.cum_mass[b] - h.mass[b]);
        in_mass = h.mass[b];
        hi = hi - static_cast<float>(b) * width;
        if (lane == 0) {
          s.hi = hi;
          s.tau_k = hi - width;
        }
      }
      __syncthreads();
      hi = s.hi;
      tau_k = s.tau_k;
      width = width / NB;
    }
    if (need_k) {
      if (tid == 0) s.z = above_mass + in_mass;
      __syncthreads();
      z = s.z;
    } else {
      tau_k = -INFINITY;
    }
  }

  // ---- tau_p: mass-crossing refinement against p * Z
  float tau_p = -INFINITY;
  if (need_p) {
    const float target = p * z;
    if (tid < 32) {
      warp_cumsum(h.coarse, h.cum_mass, lane);
      const int b = warp_cross(h.cum_mass, target, lane);
      if (lane == 0) {
        s.above = h.cum_mass[b] - h.coarse[b];
        s.hi = m - static_cast<float>(b) * (SPAN / NB);
        s.tau_p = s.hi - SPAN / NB;
      }
    }
    __syncthreads();
    float width = SPAN / NB / NB;
    for (int lvl = 1; lvl < LEVELS; ++lvl) {
      hist_pass<false>(xs, n, s.hi, width, m, tau_k, h, pass++ & 1, cluster);
      if (tid < 32) {   // the first crossing of buckets 0..NB-2 does not
        warp_cumsum(h.mass, h.cum_mass, lane);   // depend on NB-1's mass
        const int b = warp_cross(h.cum_mass, target - s.above, lane);
        if (lane == 0) s.b = b;
      }
      __syncthreads();
      if (s.b == NB - 1) {   // the whole cluster alike
        catch_mass(xs, n, s.hi, width, m, tau_k, h, s, cluster);
        if (tid < 32) warp_cumsum(h.mass, h.cum_mass, lane);
      }
      if (tid < 32) {
        const float above = s.above;
        const int b = s.b;
        const float above_l = h.cum_mass[b] - h.mass[b];
        const float hi = s.hi - static_cast<float>(b) * width;
        __syncwarp();
        if (lane == 0) {
          s.above = above + above_l;
          s.hi = hi;
          s.tau_p = hi - width;
        }
      }
      __syncthreads();
      width = width / NB;
    }
    tau_p = s.tau_p;
  }
  const float tau_m = min_p > 0.f ? m + logf(min_p) : -INFINITY;
  const float tau = fmaxf(fmaxf(tau_k, tau_p), tau_m);

  // ---- the Gumbel-max draw over the kept set, and the lanes' first list
  float best = -INFINITY;
  int bi = INT_MAX;
  const float* gs = gumbel + base;
  for (int j0 = tid; j0 < n; j0 += BATCH * NT) {
    float vk[BATCH], gk[BATCH];   // g is loaded at kept entries only, a
#pragma unroll                    // batch in flight at once
    for (int u = 0; u < BATCH; ++u) {
      const int j = j0 + u * NT;
      vk[u] = j < n ? xs[j] : -INFINITY;
      gk[u] = (j < n && vk[u] >= tau) ? gs[j] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const float sc = vk[u] >= tau ? vk[u] + gk[u] : rt::kNeg;
      if (j0 + u * NT < n && sc > best) {
        best = sc;
        bi = lo + j0 + u * NT;
      }
    }
  }
  block_arg(best, bi, s);
  if (tid == 0) s.pub_draw = Arg{best, bi};
  const int K = max(lanes, 0);
  if (K > 0) local_picks(rs, n, lo, mine, min(K, KC), cand, s);
  cluster_sync();   // every rank's draw and first list are in place

  if (tid < 32) {
    Arg d{-INFINITY, INT_MAX};
    if (lane < C) d = cluster.map_shared_rank(&s.pub_draw, lane)[0];
    warp_arg(d.v, d.i);
    if (rank == 0 && lane == 0) {
      o_sampled[row] = d.i;
      o_greedy[row] = gi;
      o_tau[row] = tau;
      o_m[row] = m;
      o_l[row] = l;
      if (with_raw) {
        o_m_raw[row] = s.row[1].m;
        o_l_raw[row] = s.row[1].l;
      }
    }
  }

  // ---- the lanes: rounds of KC, each rank's list found below the last
  // merged pick
  for (int done = 0, round = 0; done < K; done += KC, ++round) {
    const int count = min(KC, K - done);
    Arg* buf = cand + (round & 1) * KC;
    if (round > 0) {
      mine = best_below(rs, n, lo, s.cursor);
      local_picks(rs, n, lo, mine, count, buf, s);
      cluster_sync();   // every rank's list of this round is in place
    }
    if (tid < 32) {
      const size_t at = static_cast<size_t>(row) * lanes + done;
      const Arg last = merge_lists(buf, mb, count, lane, rank == 0,
                                   o_top_v + at, o_top_i + at, cluster);
      if (lane == 0) s.cursor = last;
    }
    __syncthreads();
  }
  cluster_sync();   // no rank leaves while another may read its memory
}

// The kernel's attributes for a launch with `smem` bytes of shared memory
// (and a cluster past the portable 8, where C is).
cudaError_t prepare(size_t smem) {
  cudaError_t err = rt::allow_smem(fused_sample_kernel, smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(fused_sample_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  return err;
}

}  // namespace

// lanes < 0: no logprob lanes (raw and the lane outputs may be null);
// lanes >= 0: raw stats, and the top `lanes` entries of raw.
// Returns the CUDA error of the launch (0 on success);
// cudaErrorInvalidValue for arguments the kernel does not take, V past
// repro_fused_sample_max_vocab() included.
extern "C" int repro_fused_sample(const void* logits, const void* gumbel,
                                  const void* k, const void* p,
                                  const void* min_p, const void* raw, int B,
                                  int V, int lanes, void* sampled,
                                  void* greedy, void* tau, void* m, void* l,
                                  void* m_raw, void* l_raw, void* top_vals,
                                  void* top_idx, void* stream) {
  if (B <= 0 || V <= 0 || lanes > V) return cudaErrorInvalidValue;
  if (lanes >= 0 && (raw == nullptr || m_raw == nullptr || l_raw == nullptr))
    return cudaErrorInvalidValue;
  if (lanes > 0 && (top_vals == nullptr || top_idx == nullptr))
    return cudaErrorInvalidValue;
  if (smem_bytes(V, false) > SMEM_LIMIT) return cudaErrorInvalidValue;
  const bool park_raw = lanes >= 0 && smem_bytes(V, true) <= SMEM_LIMIT;
  const size_t smem = smem_bytes(V, park_raw);
  const cudaError_t err = prepare(smem);
  if (err != cudaSuccess) return err;
  fused_sample_kernel<<<B * C, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const float*>(gumbel),
      static_cast<const int*>(k), static_cast<const float*>(p),
      static_cast<const float*>(min_p), static_cast<const float*>(raw), V,
      lanes, park_raw ? 1 : 0, static_cast<int*>(sampled),
      static_cast<int*>(greedy), static_cast<float*>(tau),
      static_cast<float*>(m), static_cast<float*>(l),
      static_cast<float*>(m_raw), static_cast<float*>(l_raw),
      static_cast<float*>(top_vals), static_cast<int*>(top_idx));
  return cudaGetLastError();
}

// The largest V the kernel takes: its slice of x must fit the shared memory
// beside the histograms.
extern "C" int repro_fused_sample_max_vocab() {
  return (SMEM_LIMIT - OFF_SLICE) / 4 / ALIGN * ALIGN * C - ALIGN * C;
}

// The entries each rank owns at V: rank r's slice starts at r times this.
extern "C" int repro_fused_sample_slice_width(int V) {
  return slice_width(V);
}

// The launch a call at V makes (with lanes if `with_lanes`): its dynamic shared
// memory, whether raw is parked, and how many clusters of C CTAs the card
// can hold at once (cudaOccupancyMaxActiveClusters).  Returns the CUDA
// error of the query.
extern "C" int repro_fused_sample_residency(int V, int with_lanes, int* smem,
                                            int* park_raw, int* clusters) {
  const bool park = with_lanes != 0 && smem_bytes(V, true) <= SMEM_LIMIT;
  *smem = static_cast<int>(smem_bytes(V, park));
  *park_raw = park ? 1 : 0;
  const cudaError_t err = prepare(*smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(*smem);
  return cudaOccupancyMaxActiveClusters(clusters, fused_sample_kernel, &cfg);
}
