// Fused sampling for Hopper (sm_90a): joint top-k / top-p / min-p
// threshold and Gumbel-max draw, with optional raw-logit logprob lanes.
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
// operations per element per pass.
//
// Design, first version: one CTA of 512 threads per row.  A 128256-entry f32
// row is 501 KB and a block gets at most 227 KB of shared memory, so the row
// is not parked: every pass re-reads it, from L2 after the first (8 rows of
// 3 inputs, ~12 MB, stay inside the 50 MB L2).  Passes: stats (x, and raw
// with lanes); up to 3 count levels and 2 mass levels (skipped for a row
// whose k <= 0 or p >= 1: their results are discarded there); the draw (x
// and g); K lane passes over raw, each a block argmax of the entries below
// the previous pick in (value desc, index asc) order.  B CTAs fill B of the
// 132 SMs; splitting V across a thread-block cluster with distributed shared
// memory, more than B CTAs and TMA are later work.
//
// Determinism: a fixed seed must give the same stream, so no float is
// summed in an order that depends on scheduling.  Counts are integer
// atomics.  Bucket masses exp(x - m) in (0, 1] are accumulated as 64-bit
// fixed point (units of 2^-44; integer sums do not depend on order) in one
// histogram per warp, summed over warps at the end of the pass and then
// rounded to f32; the catch-all bucket NB-1, which takes every value below
// the interval, is summed in registers per thread to keep all threads off
// one address.  The stats and argmax reductions run in a fixed tree.  The
// fixed point's error, below 2^-45 per entry, is far under the f32
// rounding of the reference's own sums.

#include <climits>
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int NT = 512;            // threads per row
constexpr int NW = NT / 32;        // warps
constexpr int NB = 256;            // histogram buckets per level
constexpr int LEVELS = 3;          // coarse + 2 refinements
constexpr float SPAN = 32.f;       // nats below the max of the coarse level
constexpr float kFix = 17592186044416.f;         // 2^44
constexpr double kUnfix = 1.0 / 17592186044416.0;
constexpr unsigned kFull = 0xffffffffu;

// dynamic shared memory: per-warp histograms, then per-level arrays
constexpr size_t kSmem = sizeof(unsigned long long) * NW * NB  // warp mass
                         + sizeof(unsigned) * NW * NB   // warp counts
                         + sizeof(float) * NB * 3       // mass, coarse, cum
                         + sizeof(int) * NB * 2;        // count, cum

struct Shared {
  unsigned long long* wmass;
  unsigned* wcnt;
  float* mass;
  float* coarse;
  float* cum_mass;
  int* cnt;
  int* cum_cnt;
};

// ---------------------------------------------------------------- reductions
// (m, l, idx) of an online softmax with argmax: the max, the sum of exp(x -
// max), and the first index of the max.  Commutative, so the butterfly gives
// every lane the same bits.
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

__device__ void block_stats(float& m, float& l, int& i, float* sm, float* sl,
                            int* si) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    combine_stats(m, l, i, __shfl_xor_sync(kFull, m, o),
                  __shfl_xor_sync(kFull, l, o), __shfl_xor_sync(kFull, i, o));
  if (lane == 0) {
    sm[warp] = m;
    sl[warp] = l;
    si[warp] = i;
  }
  __syncthreads();
  m = lane < NW ? sm[lane] : -INFINITY;
  l = lane < NW ? sl[lane] : 0.f;
  i = lane < NW ? si[lane] : INT_MAX;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    combine_stats(m, l, i, __shfl_xor_sync(kFull, m, o),
                  __shfl_xor_sync(kFull, l, o), __shfl_xor_sync(kFull, i, o));
  __syncthreads();  // the scratch is reused by the next reduction
}

__device__ void block_arg(float& v, int& i, float* sv, int* si) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    combine_arg(v, i, __shfl_xor_sync(kFull, v, o),
                __shfl_xor_sync(kFull, i, o));
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  v = lane < NW ? sv[lane] : -INFINITY;
  i = lane < NW ? si[lane] : INT_MAX;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    combine_arg(v, i, __shfl_xor_sync(kFull, v, o),
                __shfl_xor_sync(kFull, i, o));
  __syncthreads();
}

// ---------------------------------------------------------------- histograms
// One pass: bin every x with sel_min <= x <= hi into NB buckets of `width`
// below hi (floor((hi - x) / width), clamped: values under the interval land
// in the catch-all NB-1), counting and summing exp(x - m).  Leaves the
// bucket counts in sh.cnt and f32 masses in sh.mass, and the per-warp
// histograms zeroed for the next pass.
__device__ void hist_pass(const float* __restrict__ x, int V, float hi,
                          float width, float m, float sel_min,
                          const Shared& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned* wc = sh.wcnt + warp * NB;
  unsigned long long* wm = sh.wmass + warp * NB;
  unsigned c_catch = 0;
  unsigned long long m_catch = 0;
#pragma unroll 4
  for (int j = tid; j < V; j += NT) {
    const float v = x[j];
    if (v >= sel_min && v <= hi) {
      const float q = floorf((hi - v) / width);
      const int b = static_cast<int>(fminf(fmaxf(q, 0.f), float(NB - 1)));
      const unsigned long long w = __float2ull_rn(expf(v - m) * kFix);
      if (b == NB - 1) {
        ++c_catch;
        m_catch += w;
      } else {
        atomicAdd(wc + b, 1u);
        atomicAdd(wm + b, w);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    c_catch += __shfl_xor_sync(kFull, c_catch, o);
    m_catch += __shfl_xor_sync(kFull, m_catch, o);
  }
  if (lane == 0) {  // no lane of this warp touched bucket NB-1 by atomics
    wc[NB - 1] += c_catch;
    wm[NB - 1] += m_catch;
  }
  __syncthreads();
  if (tid < NB) {
    unsigned c = 0;
    unsigned long long s = 0;
    for (int w = 0; w < NW; ++w) {
      c += sh.wcnt[w * NB + tid];
      s += sh.wmass[w * NB + tid];
      sh.wcnt[w * NB + tid] = 0;
      sh.wmass[w * NB + tid] = 0;
    }
    sh.cnt[tid] = static_cast<int>(c);
    sh.mass[tid] = static_cast<float>(static_cast<double>(s) * kUnfix);
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

// ---------------------------------------------------------------- the kernel
__global__ void __launch_bounds__(NT)
fused_sample_kernel(const float* __restrict__ logits,
                    const float* __restrict__ gumbel,
                    const int* __restrict__ k_rows,
                    const float* __restrict__ p_rows,
                    const float* __restrict__ minp_rows,
                    const float* __restrict__ raw, int V, int lanes,
                    int* __restrict__ o_sampled, int* __restrict__ o_greedy,
                    float* __restrict__ o_tau, float* __restrict__ o_m,
                    float* __restrict__ o_l, float* __restrict__ o_m_raw,
                    float* __restrict__ o_l_raw, float* __restrict__ o_top_v,
                    int* __restrict__ o_top_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared sh;
  sh.wmass = reinterpret_cast<unsigned long long*>(smem);
  sh.wcnt = reinterpret_cast<unsigned*>(sh.wmass + NW * NB);
  sh.mass = reinterpret_cast<float*>(sh.wcnt + NW * NB);
  sh.coarse = sh.mass + NB;
  sh.cum_mass = sh.coarse + NB;
  sh.cnt = reinterpret_cast<int*>(sh.cum_mass + NB);
  sh.cum_cnt = sh.cnt + NB;
  __shared__ float red_f[NW], red_g[NW];
  __shared__ int red_i[NW];
  // row state written by warp 0 after each level, read by every thread
  __shared__ float s_hi, s_tau_k, s_tau_p, s_above, s_z;

  const int row = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const float* x = logits + static_cast<size_t>(row) * V;
  const float* g = gumbel + static_cast<size_t>(row) * V;

  for (int e = tid; e < NW * NB; e += NT) {
    sh.wcnt[e] = 0;
    sh.wmass[e] = 0;
  }

  // ---- stats: m, l, greedy (and the raw row's m, l)
  float m = -INFINITY, l = 0.f;
  int gi = INT_MAX;
  float mr = -INFINITY, lr = 0.f;
  int ri = INT_MAX;
  const float* r = lanes >= 0 ? raw + static_cast<size_t>(row) * V : nullptr;
#pragma unroll 4
  for (int j = tid; j < V; j += NT) {
    const float v = x[j];
    if (v > m) {
      l = l * expf(m - v) + 1.f;
      m = v;
      gi = j;
    } else if (v > -INFINITY) {
      l += expf(v - m);
    }
  }
  if (r != nullptr) {
#pragma unroll 4
    for (int j = tid; j < V; j += NT) {
      const float v = r[j];
      if (v > mr) {
        lr = lr * expf(mr - v) + 1.f;
        mr = v;
        ri = j;
      } else if (v > -INFINITY) {
        lr += expf(v - mr);
      }
    }
  }
  block_stats(m, l, gi, red_f, red_g, red_i);
  if (r != nullptr) block_stats(mr, lr, ri, red_f, red_g, red_i);

  const int k = k_rows[row];
  const float p = p_rows[row], min_p = minp_rows[row];
  const bool need_k = k > 0, need_p = p < 1.f;

  // ---- tau_k: count-crossing refinement (+ the coarse mass for tau_p)
  float tau_k = -INFINITY, z = l;
  if (need_k || need_p) {
    float hi = m, width = SPAN / NB;
    int rem = min(max(k, 1), V);
    float above_mass = 0.f, in_mass = 0.f;
    for (int lvl = 0; lvl < (need_k ? LEVELS : 1); ++lvl) {
      hist_pass(x, V, hi, width, m, -INFINITY, sh);
      if (lvl == 0 && tid < NB) sh.coarse[tid] = sh.mass[tid];
      if (tid < 32) {
        warp_cumsum(sh.cnt, sh.cum_cnt, lane);
        warp_cumsum(sh.mass, sh.cum_mass, lane);
        const int b = warp_cross(sh.cum_cnt, rem, lane);
        rem -= sh.cum_cnt[b] - sh.cnt[b];
        above_mass = above_mass + (sh.cum_mass[b] - sh.mass[b]);
        in_mass = sh.mass[b];
        hi = hi - static_cast<float>(b) * width;
        if (lane == 0) {
          s_hi = hi;
          s_tau_k = hi - width;
        }
      }
      __syncthreads();
      hi = s_hi;
      tau_k = s_tau_k;
      width = width / NB;
    }
    if (need_k) {
      if (tid == 0) s_z = above_mass + in_mass;
      __syncthreads();
      z = s_z;
    } else {
      tau_k = -INFINITY;
    }
  }

  // ---- tau_p: mass-crossing refinement against p * Z
  float tau_p = -INFINITY;
  if (need_p) {
    const float target = p * z;
    if (tid < 32) {
      warp_cumsum(sh.coarse, sh.cum_mass, lane);
      const int b = warp_cross(sh.cum_mass, target, lane);
      if (lane == 0) {
        s_above = sh.cum_mass[b] - sh.coarse[b];
        s_hi = m - static_cast<float>(b) * (SPAN / NB);
        s_tau_p = s_hi - SPAN / NB;
      }
    }
    __syncthreads();
    float width = SPAN / NB / NB;
    for (int lvl = 1; lvl < LEVELS; ++lvl) {
      hist_pass(x, V, s_hi, width, m, tau_k, sh);
      if (tid < 32) {
        warp_cumsum(sh.mass, sh.cum_mass, lane);
        const float above = s_above;
        const int b = warp_cross(sh.cum_mass, target - above, lane);
        const float above_l = sh.cum_mass[b] - sh.mass[b];
        const float hi = s_hi - static_cast<float>(b) * width;
        __syncwarp();
        if (lane == 0) {
          s_above = above + above_l;
          s_hi = hi;
          s_tau_p = hi - width;
        }
      }
      __syncthreads();
      width = width / NB;
    }
    tau_p = s_tau_p;
  }
  const float tau_m = min_p > 0.f ? m + logf(min_p) : -INFINITY;
  const float tau = fmaxf(fmaxf(tau_k, tau_p), tau_m);

  // ---- the Gumbel-max draw over the kept set
  float best = -INFINITY;
  int bi = INT_MAX;
#pragma unroll 4
  for (int j = tid; j < V; j += NT) {
    const float v = x[j];
    const float s = v >= tau ? v + g[j] : rt::kNeg;
    if (s > best) {
      best = s;
      bi = j;
    }
  }
  block_arg(best, bi, red_f, red_i);
  if (tid == 0) {
    o_sampled[row] = bi;
    o_greedy[row] = gi;
    o_tau[row] = tau;
    o_m[row] = m;
    o_l[row] = l;
    if (r != nullptr) {
      o_m_raw[row] = mr;
      o_l_raw[row] = lr;
    }
  }

  // ---- logprob lanes: K block argmaxes, each below the previous pick
  float prev_v = INFINITY;
  int prev_i = -1;
  for (int t = 0; t < lanes; ++t) {
    float bv = -INFINITY;
    int bj = INT_MAX;
#pragma unroll 4
    for (int j = tid; j < V; j += NT) {
      const float v = r[j];
      if ((v < prev_v || (v == prev_v && j > prev_i)) && v > bv) {
        bv = v;
        bj = j;
      }
    }
    block_arg(bv, bj, red_f, red_i);
    if (tid == 0) {
      o_top_v[static_cast<size_t>(row) * lanes + t] = bv;
      o_top_i[static_cast<size_t>(row) * lanes + t] = bj;
    }
    prev_v = bv;
    prev_i = bj;
  }
}

}  // namespace

// lanes < 0: no logprob lanes (raw and the lane outputs may be null);
// lanes >= 0: raw stats, and the top `lanes` entries of raw.
// Returns the CUDA error of the launch (0 on success).
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
  cudaError_t err = rt::allow_smem(fused_sample_kernel, kSmem);
  if (err != cudaSuccess) return err;
  fused_sample_kernel<<<B, NT, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const float*>(gumbel),
      static_cast<const int*>(k), static_cast<const float*>(p),
      static_cast<const float*>(min_p), static_cast<const float*>(raw), V,
      lanes, static_cast<int*>(sampled), static_cast<int*>(greedy),
      static_cast<float*>(tau), static_cast<float*>(m), static_cast<float*>(l),
      static_cast<float*>(m_raw), static_cast<float*>(l_raw),
      static_cast<float*>(top_vals), static_cast<int*>(top_idx));
  return cudaGetLastError();
}
