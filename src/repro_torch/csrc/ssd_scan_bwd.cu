// Backward of the Mamba-2 state recurrence between chunks for Hopper
// (sm_90a).
//
// The forward (ssd_scan.cu) gives prev_c = H_{c-1} and final = H_{nc-1} of
// H_c = H_{c-1} * decay_c + S_c from H_{-1} = 0.  This kernel is the
// derivative XLA takes of the reference's lax.scan
// (repro/models/ssm.py::ssd_chunked; no TPU kernel computes it): given
// prev and dprev (B, H, nc, N, P) fp32, decay (B, H, nc) fp32 and dfinal
// (B, H, N, P) fp32 or null (zeros), it runs the adjoint recurrence from
// the last chunk down,
//
//   G = dfinal;  for c = nc-1 .. 0:  dS_c = G,
//                                    dd_c = sum over (N, P) of G * prev_c,
//                                    G = dprev_c + decay_c * G,
//
// and writes dstates (B, H, nc, N, P) and ddecay (B, H, nc).  Training
// (models/ssm.py through kernels/ssd_scan/ops.py::SsdScanFn) calls it once
// per layer and microbatch.
//
// What bounds it on an H100: bytes.  prev and dprev are read once and
// dstates written once, for 4 FLOP an element and chunk: ~0.33 FLOP per
// byte.  At Mamba2-370M's training microbatch of 8 x 4096 tokens
// (8, 32, 64, 128, 64) that is 1.61 GB, ~0.48 ms at 3.35 TB/s.
//
// Design: the forward kernel's layout run in reverse.  The adjoint
// recurrence is independent for each of the N * P elements of a (b, h)
// cell, so one CTA serves a (b, h, tile of N * P), each of its 128 threads
// holding four elements of G in registers; a cell of N * P = 8192 spans 16
// CTAs.  Loads of prev and dprev are 16-byte float4s with streaming cache
// hints (every byte is touched once), issued for four chunks before their
// four dependent updates, so a thread keeps 128 bytes in flight while G
// waits.  The update is __fadd_rn(__fmul_rn(decay, G), dprev): no FMA
// contraction, so dstates is the plain version's fp32 `dprev + d * G`
// bit for bit.
//
// ddecay sums over a whole cell, across CTAs.  No float atomics (their
// order, and so their bits, would change from run to run): for each group
// of four chunks every warp reduces its threads' products by a shuffle
// butterfly, the four warps' sums meet in shared memory and thread u adds
// them in warp order, writing the tile's partial sum of chunk c to a
// scratch (B * H, tiles, nc).  A second launch of this source sums each
// (cell, chunk)'s partials over the tiles in tile order.  Both orders are
// fixed, so two calls give equal bits.  An N * P that is not a multiple of
// 4, or a pointer off the 16-byte grid, takes the same loop one float at a
// time; threads past a ragged N * P stay in the loop (the barriers need
// them) with G = 0.

#include "common.cuh"

namespace {

constexpr int NT = 128;  // threads per CTA of the adjoint scan
constexpr int NW = NT / 32;
constexpr int U = 4;     // chunks whose loads are in flight together
constexpr int NR = 256;  // threads per CTA of the reduction over tiles

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T load(const float* p) {
    return __ldcs(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ T zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ void put(float* g, T v) {
    g[0] = v.x;
    g[1] = v.y;
    g[2] = v.z;
    g[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* g) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(g[0], g[1], g[2], g[3]));
  }
  static __device__ __forceinline__ float dot(const float* g, T v) {
    float s = g[0] * v.x;
    s = fmaf(g[1], v.y, s);
    s = fmaf(g[2], v.z, s);
    return fmaf(g[3], v.w, s);
  }
  static __device__ __forceinline__ void update(float* g, float d, T dp) {
    g[0] = __fadd_rn(__fmul_rn(d, g[0]), dp.x);
    g[1] = __fadd_rn(__fmul_rn(d, g[1]), dp.y);
    g[2] = __fadd_rn(__fmul_rn(d, g[2]), dp.z);
    g[3] = __fadd_rn(__fmul_rn(d, g[3]), dp.w);
  }
};
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T load(const float* p) {
    return __ldcs(p);
  }
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ void put(float* g, T v) { g[0] = v; }
  static __device__ __forceinline__ void store(float* p, const float* g) {
    __stcs(p, g[0]);
  }
  static __device__ __forceinline__ float dot(const float* g, T v) {
    return g[0] * v;
  }
  static __device__ __forceinline__ void update(float* g, float d, T dp) {
    g[0] = __fadd_rn(__fmul_rn(d, g[0]), dp);
  }
};

// grid.x = (B * H) * tiles; CTA x serves cell x / tiles, tile x % tiles,
// and writes partial[(cell * tiles + tile) * nc + c] for every chunk c.
template <int VEC>
__global__ void __launch_bounds__(NT)
ssd_scan_bwd_kernel(const float* __restrict__ prev,
                    const float* __restrict__ decay,
                    const float* __restrict__ dprev,
                    const float* __restrict__ dfinal,
                    float* __restrict__ dstates, float* __restrict__ partial,
                    int nc, long long np, int tiles) {
  using V = Vec<VEC>;
  __shared__ float red[2][U][NW];
  const long long cell = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long e = ((long long)tile * NT + tid) * VEC;
  const bool active = e < np;
  const long long base = cell * nc * np + e;
  const float* d = decay + cell * nc;
  float* part = partial + ((long long)cell * tiles + tile) * nc;
  float g[VEC];
  V::put(g, active && dfinal != nullptr ? V::load(dfinal + cell * np + e)
                                        : V::zero());
  int buf = 0;
  for (int top = nc - 1; top >= 0; top -= U) {
    const int n = min(U, top + 1);  // chunks top, top - 1, ..., top - n + 1
    typename V::T pv[U], dp[U];
    float dv[U], s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < n) {
        const long long off = base + (long long)(top - u) * np;
        pv[u] = active ? V::load(prev + off) : V::zero();
        dp[u] = active ? V::load(dprev + off) : V::zero();
        dv[u] = __ldg(d + top - u);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      s[u] = 0.f;
      if (u < n) {
        if (active) V::store(dstates + base + (long long)(top - u) * np, g);
        s[u] = V::dot(g, pv[u]);
        V::update(g, dv[u], dp[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
    }
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < U; ++u) red[buf][u][warp] = s[u];
    }
    // one barrier a group: a buffer is written again two groups later,
    // after every thread has passed the next group's barrier
    __syncthreads();
    if (tid < n) {
      float t = red[buf][tid][0];
#pragma unroll
      for (int w = 1; w < NW; ++w) t += red[buf][tid][w];
      part[top - tid] = t;
    }
    buf ^= 1;
  }
}

// One thread per (cell, chunk): ddecay = the tiles' partials summed in
// tile order.
__global__ void __launch_bounds__(NR)
ssd_scan_bwd_reduce(const float* __restrict__ partial,
                    float* __restrict__ ddecay, long long rows, int nc,
                    int tiles) {
  const long long i = (long long)blockIdx.x * NR + threadIdx.x;
  if (i >= rows) return;
  const long long cell = i / nc, c = i % nc;
  const float* p = partial + cell * tiles * nc + c;
  float t = p[0];
  for (int k = 1; k < tiles; ++k) t += p[(long long)k * nc];
  ddecay[i] = t;
}

long long tiles_of(long long np, int vec) {
  const long long per_cta = (long long)NT * (vec ? 4 : 1);
  return (np + per_cta - 1) / per_cta;
}

template <int VEC>
cudaError_t launch(const float* prev, const float* decay, const float* dprev,
                   const float* dfinal, float* dstates, float* ddecay,
                   float* partial, long long cells, int nc, long long np,
                   cudaStream_t stream) {
  const long long tiles = tiles_of(np, VEC == 4);
  const long long grid = cells * tiles;
  const long long rows = cells * nc;
  const long long grid_r = (rows + NR - 1) / NR;
  if (grid > 0x7fffffffLL || grid_r > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  ssd_scan_bwd_kernel<VEC><<<(unsigned)grid, NT, 0, stream>>>(
      prev, decay, dprev, dfinal, dstates, partial, nc, np, (int)tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_scan_bwd_reduce<<<(unsigned)grid_r, NR, 0, stream>>>(
      partial, ddecay, rows, nc, (int)tiles);
  return cudaGetLastError();
}

}  // namespace

// Floats of the scratch the call with these arguments needs (the tiles'
// partial sums of ddecay).
extern "C" long long repro_ssd_state_scan_bwd_scratch(int B, int H, int nc,
                                                      int N, int P,
                                                      int vec) {
  return (long long)B * H * nc * tiles_of((long long)N * P, vec);
}

// Returns the CUDA error of the launches (0 on success).  dfinal may be
// null (zeros).  vec: take the float4 path (N * P a multiple of 4, prev,
// dprev, dfinal and dstates 16-byte aligned).  partial holds
// repro_ssd_state_scan_bwd_scratch(...) floats.
extern "C" int repro_ssd_state_scan_bwd(const void* prev, const void* decay,
                                        const void* dprev,
                                        const void* dfinal, void* dstates,
                                        void* ddecay, void* partial, int B,
                                        int H, int nc, int N, int P, int vec,
                                        void* stream) {
  if (B <= 0 || H <= 0 || nc <= 0 || N <= 0 || P <= 0)
    return cudaErrorInvalidValue;
  const long long cells = (long long)B * H, np = (long long)N * P;
  const float* pv = static_cast<const float*>(prev);
  const float* d = static_cast<const float*>(decay);
  const float* dp = static_cast<const float*>(dprev);
  const float* df = static_cast<const float*>(dfinal);
  float* ds = static_cast<float*>(dstates);
  float* dd = static_cast<float*>(ddecay);
  float* part = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    if (np % 4 != 0) return cudaErrorInvalidValue;
    return launch<4>(pv, d, dp, df, ds, dd, part, cells, nc, np, st);
  }
  return launch<1>(pv, d, dp, df, ds, dd, part, cells, nc, np, st);
}
