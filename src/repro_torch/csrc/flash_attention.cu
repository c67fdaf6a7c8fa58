// Prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py
// ::flash_attention_tpu, under the contract of repro/models/flash.py
// ::flash_attention that the serving path runs: q (B, Sq, H, D) against
// k/v (B, Skv, Hkv, D) with explicit q/kv positions, causal and
// sliding-window masks, a tanh logit softcap, Sq != Skv (the tail recompute
// after a prefix hit starts at an offset) and GQA (q head h reads kv head
// h / (H / Hkv)).  Output (B, Sq, H, D) in the input type; all arithmetic
// in fp32.
//
// What bounds it on an H100: at the serving path's prefill shape (B=4,
// S=512, H=32, D=64, causal, bf16) the work is ~4.3 GFLOP against ~21 MB
// of q/k/v/out, ~205 FLOP/byte, just under the card's ~295 FLOP/byte
// balance point: bytes bound it (~6.3 us at 3.35 TB/s), with the bf16
// tensor-core rate close behind (~4.3 us), and longer prompts become
// operation-bound (the work grows with S^2, the bytes with S).  This
// first version computes with fp32 FMAs on the CUDA cores instead, whose
// 67 TFLOP/s alone put it at >= ~64 us here (its measured time is in
// PERF.md).  Moving the two products to wgmma with TMA-fed tiles is
// later work.
//
// Design: one CTA per (64-row q tile, q head, batch row), 256 threads.
// The q tile is loaded once (pre-scaled by 1/sqrt(D)); the CTA then walks
// 64-key tiles of K and V through shared memory with an online softmax
// (running max m, sum l and the fp32 accumulator in registers: each thread
// owns 4 rows x 4 keys of the score tile and 4 rows x D/16 output
// columns).  The mask is computed from the positions alone, so a tile no
// row of the CTA may attend to (above the causal diagonal, outside the
// window, or past Skv) is skipped before its K/V are read.  Keys are masked
// at the true Skv: nothing is padded, so padding is never attended to.
// Shared-memory row strides are padded so that no access pattern has bank
// conflicts.

#include "common.cuh"

namespace {

constexpr int BQ = 64;       // query rows per CTA
constexpr int BK = 64;       // keys per K/V tile
constexpr int NT = 256;      // threads: 16 row groups x 16 lanes
constexpr int PS = BK + 4;   // row stride of the probability tile

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ q_pos,
                 const int* __restrict__ kv_pos, T* __restrict__ out, int Sq,
                 int Skv, int H, int Hkv, int causal, int window,
                 float softcap, float scale) {
  constexpr int DP = D + 1;   // padded row stride of the Q and K tiles
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;            // BQ x DP
  float* Ks = Qs + BQ * DP;    // BK x DP
  float* Vs = Ks + BK * DP;    // BK x D
  float* Ps = Vs + BK * D;     // BQ x PS

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, d = e % D, qi = q0 + r;
    float x = 0.f;
    if (qi < Sq)
      x = rt::to_f32(q[(((size_t)b * Sq + qi) * H + h) * D + d]) * scale;
    Qs[r * DP + d] = x;
  }

  int qp[4];
  bool qin[4];
  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    qin[i] = qi < Sq;
    qp[i] = qin[i] ? q_pos[(size_t)b * Sq + qi] : 0;
    m[i] = rt::kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int nkt = (Skv + BK - 1) / BK;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    int kp[4];
    bool kin[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = k0 + tx + 16 * j;
      kin[j] = kj < Skv;
      kp[j] = kin[j] ? kv_pos[(size_t)b * Skv + kj] : 0;
    }
    bool ok[4][4];
    int any = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bool o = qin[i] && kin[j];
        if (causal) o = o && kp[j] <= qp[i];
        if (window > 0) o = o && kp[j] > qp[i] - window;
        ok[i][j] = o;
        any |= o;
      }
    }
    // also the barrier between the last tile's readers and this tile's
    // writers of Ks/Vs/Ps
    if (!__syncthreads_or(any)) continue;

#pragma unroll 4
    for (int e = tid; e < BK * D; e += NT) {
      const int c = e / D, d = e % D, kj = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (kj < Skv) {
        const size_t off = (((size_t)b * Skv + kj) * Hkv + hk) * D + d;
        kx = rt::to_f32(k[off]);
        vx = rt::to_f32(v[off]);
      }
      Ks[c * DP + d] = kx;
      Vs[c * D + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = rt::kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j];
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        x = ok[i][j] ? x : rt::kNeg;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // the 16 lanes of a row group share its rows
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * PS + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      float p[4], w[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * PS + c];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) w[cc] = Vs[c * D + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < DC; ++cc)
          acc[i][cc] = fmaf(p[i], w[cc], acc[i][cc]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Sq) continue;
    const float lsafe = fmaxf(l[i], 1e-30f);
    T* o = out + (((size_t)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc)
      o[tx + 16 * cc] = rt::from_f32<T>(acc[i][cc] / lsafe);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_pos, const int* kv_pos, void* out, int B,
                   int Sq, int Skv, int H, int Hkv, int causal, int window,
                   float softcap, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * PS);
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = rt::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, kv_pos, static_cast<T*>(out), Sq, Skv,
      H, Hkv, causal, window, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     const int* q_pos, const int* kv_pos, void* out, int B,
                     int Sq, int Skv, int H, int Hkv, int causal, int window,
                     float softcap, float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, H, Hkv,
                           causal, window, softcap, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, H, Hkv,
                           causal, window, softcap, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, H, Hkv,
                            causal, window, softcap, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the CUDA error of the launch (0 on success).
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* kv_pos, void* out, int B, int Sq, int Skv, int H, int Hkv,
    int D, int causal, int window, float softcap, float scale, int dtype,
    void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv != 0)
    return cudaErrorInvalidValue;
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32)
    return dispatch<float>(D, q, k, v, qp, kp, out, B, Sq, Skv, H, Hkv,
                           causal, window, softcap, scale, s);
  if (dtype == rt::kBF16)
    return dispatch<__nv_bfloat16>(D, q, k, v, qp, kp, out, B, Sq, Skv, H,
                                   Hkv, causal, window, softcap, scale, s);
  return cudaErrorInvalidValue;
}
