// Mamba-2 state recurrence between chunks for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_scan/ssd_scan.py
// ::ssd_state_scan_tpu, under its contract: states (B, H, nc, N, P) fp32,
// the state each chunk adds, and decay (B, H, nc) fp32, each chunk's decay;
// with H_{-1} = 0 and H_c = H_{c-1} * decay_c + S_c it writes prev
// (B, H, nc, N, P), the state entering chunk c (H_{c-1}), and final
// (B, H, N, P), the state after the last chunk.  The models' chunked SSD
// (models/ssm.py::ssd_chunked) calls it once per layer and prefill.
//
// What bounds it on an H100: bytes.  Every element of states is read once
// and every element of prev written once, for 2 FLOP each: 0.25 FLOP per
// byte, three orders of magnitude below the card's balance point.  At the
// 8 x 256-token prefill of mamba2_370m (8, 32, 4, 128, 64) the call moves
// 75.5 MB, ~22.5 us at 3.35 TB/s; at one 32768-token prompt
// (1, 32, 512, 128, 64), 1.07 GB, ~321 us.
//
// Design: the recurrence is independent for each of the N * P elements of
// a (b, h) cell, so the TPU kernel's one grid step per (b, h), which
// carried the state through a loop over chunks in VMEM, becomes one CTA
// per (b, h, tile of N * P), each thread holding four state elements in
// registers.  A tile is 128 threads x one float4 = 512 elements, so a
// served (b, h) cell (N * P = 8192) spreads over 16 CTAs: at the long
// prompt (B * H = 32) that is 512 CTAs for 132 SMs, where one CTA per
// (b, h) would leave 100 SMs idle.  Loads are 16-byte float4s, neighbouring
// threads on neighbouring addresses, with streaming cache hints (every
// byte is touched once); the chunk loop starts the loads of four chunks
// before their four dependent updates, so each thread keeps 64 bytes in
// flight while the running state waits.  The update is
// __fadd_rn(__fmul_rn(h, d), s): no FMA contraction, so each operation
// rounds as the plain version's fp32 `h * d + s` does and the kernel gives
// its bits exactly.  An N * P that is not a multiple of 4, or a pointer
// not 16-byte aligned, takes the same loop one float at a time.

#include "common.cuh"

namespace {

constexpr int NT = 128;  // threads per CTA
constexpr int U = 4;     // chunks whose loads are in flight together

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T load(const float* p) {
    return __ldcs(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void store(float* p, const float* h) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(h[0], h[1], h[2], h[3]));
  }
  static __device__ __forceinline__ void update(float* h, float d, T s) {
    h[0] = __fadd_rn(__fmul_rn(h[0], d), s.x);
    h[1] = __fadd_rn(__fmul_rn(h[1], d), s.y);
    h[2] = __fadd_rn(__fmul_rn(h[2], d), s.z);
    h[3] = __fadd_rn(__fmul_rn(h[3], d), s.w);
  }
};
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T load(const float* p) {
    return __ldcs(p);
  }
  static __device__ __forceinline__ void store(float* p, const float* h) {
    __stcs(p, h[0]);
  }
  static __device__ __forceinline__ void update(float* h, float d, T s) {
    h[0] = __fadd_rn(__fmul_rn(h[0], d), s);
  }
};

// grid.x = (B * H) * tiles; CTA x serves cell x / tiles, tile x % tiles.
template <int VEC>
__global__ void __launch_bounds__(NT)
ssd_scan_kernel(const float* __restrict__ states,
                const float* __restrict__ decay, float* __restrict__ prev,
                float* __restrict__ final_state, int nc, long long np,
                int tiles) {
  using V = Vec<VEC>;
  const long long cell = blockIdx.x / tiles;
  const long long e =
      ((long long)(blockIdx.x % tiles) * NT + threadIdx.x) * VEC;
  if (e >= np) return;  // no barrier below, so the ragged tail may leave
  const float* s = states + cell * nc * np + e;
  float* pv = prev + cell * nc * np + e;
  const float* d = decay + cell * nc;
  float h[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) h[i] = 0.f;
  for (int c0 = 0; c0 < nc; c0 += U) {
    const int n = min(U, nc - c0);
    typename V::T sv[U];
    float dv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < n) {
        sv[u] = V::load(s + (long long)(c0 + u) * np);
        dv[u] = __ldg(d + c0 + u);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < n) {
        V::store(pv + (long long)(c0 + u) * np, h);
        V::update(h, dv[u], sv[u]);
      }
    }
  }
  V::store(final_state + cell * np + e, h);
}

template <int VEC>
cudaError_t launch(const float* states, const float* decay, float* prev,
                   float* final_state, long long cells, int nc, long long np,
                   cudaStream_t stream) {
  const long long per_cta = (long long)NT * VEC;
  const long long tiles = (np + per_cta - 1) / per_cta;
  const long long grid = cells * tiles;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  ssd_scan_kernel<VEC><<<(unsigned)grid, NT, 0, stream>>>(
      states, decay, prev, final_state, nc, np, (int)tiles);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launch (0 on success).  vec: take the
// float4 path (N * P a multiple of 4, all pointers 16-byte aligned).
extern "C" int repro_ssd_state_scan(const void* states, const void* decay,
                                    void* prev, void* final_state, int B,
                                    int H, int nc, int N, int P, int vec,
                                    void* stream) {
  if (B <= 0 || H <= 0 || nc <= 0 || N <= 0 || P <= 0)
    return cudaErrorInvalidValue;
  const long long cells = (long long)B * H, np = (long long)N * P;
  const float* s = static_cast<const float*>(states);
  const float* d = static_cast<const float*>(decay);
  float* pv = static_cast<float*>(prev);
  float* f = static_cast<float*>(final_state);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    if (np % 4 != 0) return cudaErrorInvalidValue;
    return launch<4>(s, d, pv, f, cells, nc, np, st);
  }
  return launch<1>(s, d, pv, f, cells, nc, np, st);
}
