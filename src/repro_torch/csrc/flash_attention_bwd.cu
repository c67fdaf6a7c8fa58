// The backward of prefill attention for Hopper (sm_90a).
//
// Replaces the VJP of repro/models/flash.py::flash_attention (_bwd, pure
// JAX in the reference: the TPU kernel flash_attention_tpu has no
// backward of its own) under the contract of the port's plain version,
// repro_torch/models/flash.py::flash_attention_bwd: q (B, Sq, H, D), k and
// v (B, Skv, Hkv, D) with explicit q/kv positions, causal or not, Sq != Skv
// and GQA (q head h reads kv head h / (H / Hkv)); from the forward's out
// (B, Sq, H, D), its log-sum-exp lse (B, Sq, H) fp32 (natural-log units of
// the scaled scores) and dout (B, Sq, H, D), it writes dq, dk, dv in the
// input type.  The scale is 1/sqrt(D); every sum is fp32.  A window or a
// softcap is not taken (the wrapper raises).  Head dims 32, 64 and 128 are
// instantiated.
//
// What bounds it on an H100: at the training shape (SmolLM-360M, B=8,
// S=4096, H=15 on 5, D=64, causal) the work is ~0.65 TFLOP (2.5 times the
// forward's) against ~0.4 GB of q, k, v, out, dout, lse, dq, dk, dv: far
// past the card's balance point, so operations bound it.  mma.sync with
// fragments read from shared memory by plain loads, no asynchronous
// copies and no warp specialisation keep it far from that bound; wgmma
// and TMA are the next step.
//
// Two routes, chosen by the storage type: bf16 runs the products of each
// step on the tensor cores (mma.sync m16n8k16, fp32 sums; tiles kept bf16
// in shared memory; P and dS, the fp32 A operands of the second products,
// go in as bf16 hi + lo pairs, two mma each, where FlashAttention-2 rounds
// them to bf16 once: with one rounding the gradients' near-zero elements
// missed the plain version's tolerance); fp32 runs them on the CUDA cores
// in fp32.  Both take three launches on the caller's stream:
//   1. preprocess: Dl = rowsum(dout * out) in fp32, one warp a (b, s, h);
//   2. dK/dV: one CTA per (64-key tile, kv head, batch row) keeps its K and
//      V tiles in shared memory and walks the G q heads of its kv head
//      and, for each, the 64-row q tiles some row of which may attend to
//      one of its keys (causal: from its diagonal on; a tile is skipped by
//      a block vote on the exact mask, before its Q and dO are read).  Each
//      step recomputes S = Q K^T * scale and P = exp(S - lse) (0 where
//      masked), dP = dO V^T and dS = P (dP - Dl), and adds dV += P^T dO and
//      dK += dS^T Q; dK is scaled once at the end;
//   3. dQ: one CTA per (64-row q tile, q head, batch row) keeps its Q and dO
//      tiles and walks the key tiles it may attend to, recomputing S, P, dP
//      and dS as above, and adds dQ += dS K, scaled at the end.
// On the CUDA cores each thread owns 4 x 4 of a 64 x 64 score tile (rows
// 4 ty.., keys tx + 16 j) and 4 rows x D/16 columns of an accumulator; on
// the tensor cores each of 4 warps owns 16 keys (dK/dV) or 16 q rows (dQ)
// and the dK/dV step takes 64 q rows (32 at D = 128, for registers).
// Every sum runs in a fixed order and nothing is added across CTAs, so the
// GQA fold needs no atomics and two launches on the same inputs give equal
// bits.  Keys are masked at the true Skv and rows at the true Sq: nothing
// is padded.

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BQ = 64;      // q rows per tile
constexpr int BK = 64;      // keys per tile
constexpr int NT = 256;     // threads: 16 row groups x 16 lanes
constexpr int PS = BK + 4;  // row stride of the P / dS tiles (16-byte rows)

// Dl[r] = sum_d dout[r, d] * out[r, d] for the B * Sq * H rows r.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_preprocess(const T* __restrict__ out, const T* __restrict__ dout,
                     float* __restrict__ Dl, long long rows) {
  const long long r = (long long)blockIdx.x * (NT / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const T* o = out + r * D;
  const T* g = dout + r * D;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32)
    acc = fmaf(rt::to_f32(g[d]), rt::to_f32(o[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) Dl[r] = acc;
}

// rows [r0, r0 + 64) of a (B, S, heads, D) tensor at (b, head) into a
// 64 x (D + 1) fp32 tile; rows past S are zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst,
                                          const T* __restrict__ src, int b,
                                          int r0, int S, int heads,
                                          int head) {
  constexpr int DP = D + 1;
#pragma unroll 4
  for (int e = threadIdx.x; e < 64 * D; e += NT) {
    const int r = e / D, d = e % D, ri = r0 + r;
    const size_t at = (((size_t)b * S + ri) * heads + head) * D + d;
    dst[r * DP + d] = ri < S ? rt::to_f32(src[at]) : 0.f;
  }
}

// The 4 x 4 scores of this thread, S = A B^T and dP = C E^T over D (A, C:
// the q-side tiles Q, dO; B, E: the key-side tiles K, V), then P and dS in
// place of them: P = exp(S * scale - lse) where ok, else 0; dS = P (dP - Dl).
template <int D>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       int ty, int tx, const bool (&ok)[4][4],
                                       const float (&lse)[4],
                                       const float (&dl)[4], float scale,
                                       float (&p)[4][4], float (&ds)[4][4]) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) p[i][j] = ds[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], c[4], bk[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = Qs[(ty * 4 + i) * DP + d];
      c[i] = dOs[(ty * 4 + i) * DP + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bk[j] = Ks[(tx + 16 * j) * DP + d];
      bv[j] = Vs[(tx + 16 * j) * DP + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = fmaf(a[i], bk[j], p[i][j]);
        ds[i][j] = fmaf(c[i], bv[j], ds[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float pij = ok[i][j] ? expf(p[i][j] * scale - lse[i]) : 0.f;
      p[i][j] = pij;
      ds[i][j] = pij * (ds[i][j] - dl[i]);
    }
}

// The mask of this thread's 4 x 4 pairs; returns whether any is allowed.
__device__ __forceinline__ int pair_mask(const int (&qp)[4],
                                         const bool (&qin)[4],
                                         const int (&kp)[4],
                                         const bool (&kin)[4], int causal,
                                         bool (&ok)[4][4]) {
  int any = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bool o = qin[i] && kin[j];
      if (causal) o = o && kp[j] <= qp[i];
      ok[i][j] = o;
      any |= o;
    }
  return any;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_simt(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ q_pos,
                    const int* __restrict__ kv_pos,
                    const float* __restrict__ lse,
                    const float* __restrict__ Dl, const T* __restrict__ dout,
                    T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv,
                    int H, int Hkv, int causal, float scale) {
  constexpr int DP = D + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;             // BK x DP
  float* Vs = Ks + BK * DP;     // BK x DP
  float* Qs = Vs + BK * DP;     // BQ x DP
  float* dOs = Qs + BQ * DP;    // BQ x DP
  float* Ps = dOs + BQ * DP;    // BQ x PS
  float* dSs = Ps + BQ * PS;    // BQ x PS

  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * BK;
  const int G = H / Hkv;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  load_tile<T, D>(Ks, k, b, k0, Skv, Hkv, hk);
  load_tile<T, D>(Vs, v, b, k0, Skv, Hkv, hk);
  int kp[4];
  bool kin[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kj = k0 + tx + 16 * j;
    kin[j] = kj < Skv;
    kp[j] = kin[j] ? kv_pos[(size_t)b * Skv + kj] : 0;
  }
  float acc_k[4][DC], acc_v[4][DC];  // keys 4 ty + i, columns tx + 16 c
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  const int nqt = (Sq + BQ - 1) / BQ;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int qt = 0; qt < nqt; ++qt) {
      const int q0 = qt * BQ;
      int qp[4];
      bool qin[4];
      float ls[4], dl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q0 + ty * 4 + i;
        qin[i] = qi < Sq;
        const size_t row = ((size_t)b * Sq + qi) * H + h;
        qp[i] = qin[i] ? q_pos[(size_t)b * Sq + qi] : 0;
        ls[i] = qin[i] ? lse[row] : 0.f;
        dl[i] = qin[i] ? Dl[row] : 0.f;
      }
      bool ok[4][4];
      const int any = pair_mask(qp, qin, kp, kin, causal, ok);
      // also the barrier between the last step's readers and this step's
      // writers of Qs, dOs, Ps and dSs (and, first, the K/V loads)
      if (!__syncthreads_or(any)) continue;
      load_tile<T, D>(Qs, q, b, q0, Sq, H, h);
      load_tile<T, D>(dOs, dout, b, q0, Sq, H, h);
      __syncthreads();

      float p[4][4], ds[4][4];
      scores<D>(Qs, dOs, Ks, Vs, ty, tx, ok, ls, dl, scale, p, ds);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          Ps[(ty * 4 + i) * PS + tx + 16 * j] = p[i][j];
          dSs[(ty * 4 + i) * PS + tx + 16 * j] = ds[i][j];
        }
      __syncthreads();

      // dV[key] += sum_r P[r, key] dO[r]; dK[key] += sum_r dS[r, key] Q[r]
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        const float4 pr =
            *reinterpret_cast<const float4*>(Ps + r * PS + ty * 4);
        const float4 sr =
            *reinterpret_cast<const float4*>(dSs + r * PS + ty * 4);
        const float pv[4] = {pr.x, pr.y, pr.z, pr.w};
        const float sv[4] = {sr.x, sr.y, sr.z, sr.w};
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float go = dOs[r * DP + tx + 16 * c];
          const float qq = Qs[r * DP + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_v[i][c] = fmaf(pv[i], go, acc_v[i][c]);
            acc_k[i][c] = fmaf(sv[i], qq, acc_k[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty * 4 + i;
    if (kj >= Skv) continue;
    const size_t base = (((size_t)b * Skv + kj) * Hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[base + tx + 16 * c] = rt::from_f32<T>(acc_k[i][c] * scale);
      dv[base + tx + 16 * c] = rt::from_f32<T>(acc_v[i][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_simt(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ q_pos,
                  const int* __restrict__ kv_pos,
                  const float* __restrict__ lse, const float* __restrict__ Dl,
                  const T* __restrict__ dout, T* __restrict__ dq, int Sq,
                  int Skv, int H, int Hkv, int causal, float scale) {
  constexpr int DP = D + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;             // BQ x DP
  float* dOs = Qs + BQ * DP;    // BQ x DP
  float* Ks = dOs + BQ * DP;    // BK x DP
  float* Vs = Ks + BK * DP;     // BK x DP
  float* dSs = Vs + BK * DP;    // BQ x PS

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // last tile first
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  load_tile<T, D>(Qs, q, b, q0, Sq, H, h);
  load_tile<T, D>(dOs, dout, b, q0, Sq, H, h);
  int qp[4];
  bool qin[4];
  float ls[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    qin[i] = qi < Sq;
    const size_t row = ((size_t)b * Sq + qi) * H + h;
    qp[i] = qin[i] ? q_pos[(size_t)b * Sq + qi] : 0;
    ls[i] = qin[i] ? lse[row] : 0.f;
    dl[i] = qin[i] ? Dl[row] : 0.f;
  }
  float acc[4][DC];  // rows 4 ty + i, columns tx + 16 c
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

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
    const int any = pair_mask(qp, qin, kp, kin, causal, ok);
    // also the barrier between the last step's readers and this step's
    // writers of Ks, Vs and dSs (and, first, the Q/dO loads)
    if (!__syncthreads_or(any)) continue;
    load_tile<T, D>(Ks, k, b, k0, Skv, Hkv, hk);
    load_tile<T, D>(Vs, v, b, k0, Skv, Hkv, hk);
    __syncthreads();

    float p[4][4], ds[4][4];
    scores<D>(Qs, dOs, Ks, Vs, ty, tx, ok, ls, dl, scale, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dSs[(ty * 4 + i) * PS + tx + 16 * j] = ds[i][j];
    __syncthreads();

    // dQ[r] += sum_key dS[r, key] K[key]
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dSs[(ty * 4 + i) * PS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kk = Ks[j * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(sv[i], kk, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Sq) continue;
    T* o = dq + (((size_t)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      o[tx + 16 * c] = rt::from_f32<T>(acc[i][c] * scale);
  }
}

// ---------------------------------------------------------------------------
// bf16: the same three steps on the tensor cores (mma.sync m16n8k16, fp32
// sums).  Tiles stay bf16 in shared memory (rows padded by 8 values, so the
// fragment reads meet no bank conflict); each of 4 warps owns 16 rows of
// the CTA's 64 (keys in dK/dV, q rows in dQ).  P and dS pass from the score
// registers to the next product as A fragments of bf16 hi + lo pairs
// (frag_split); everything else is as in the fp32 kernels above.
// ---------------------------------------------------------------------------
namespace tc {

constexpr int NW = 4;            // warps: 16 rows each
constexpr int NTC = 32 * NW;     // threads
constexpr int ROWS = 16 * NW;    // keys (dK/dV) or q rows (dQ) per CTA

using bf16 = __nv_bfloat16;

template <int D>
struct Geo {
  static constexpr int LD = D + 8;                // bf16 row stride
  static constexpr int BQ = D == 128 ? 32 : 64;   // q rows a dK/dV step
};

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of k step kq from two accumulator tiles of 8 columns (the
// C layout of s[2 kq], s[2 kq + 1] is the A layout of their 16 columns),
// split into bf16 hi and lo parts (x = hi + lo to ~16 bits), so that the
// product with bf16 B keeps the fp32 P and dS almost whole.
__device__ __forceinline__ void frag_split(uint32_t (&hi)[4],
                                           uint32_t (&lo)[4],
                                           const float (&c0)[4],
                                           const float (&c1)[4]) {
  const float x[8] = {c0[0], c0[1], c0[2], c0[3],
                      c1[0], c1[1], c1[2], c1[3]};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * r], x[2 * r + 1]);
    const float2 hf = __bfloat1622float2(h);
    hi[r] = *reinterpret_cast<const uint32_t*>(&h);
    lo[r] = pack(x[2 * r] - hf.x, x[2 * r + 1] - hf.y);
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 of one column from rows r and r + 1 (row stride LD)
template <int LD>
__device__ __forceinline__ uint32_t col2(const bf16* p) {
  const uint16_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint16_t hi = *reinterpret_cast<const uint16_t*>(p + LD);
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// rows [r0, r0 + n) of a (B, S, heads, D) bf16 tensor at (b, head) into
// an n x LD tile by 16-byte copies; rows past S are zeros
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst,
                                          const bf16* __restrict__ src, int b,
                                          int r0, int n, int S, int heads,
                                          int head) {
  constexpr int LD = Geo<D>::LD, V = D / 8;
  for (int e = threadIdx.x; e < n * V; e += NTC) {
    const int r = e / V, c = (e % V) * 8, ri = r0 + r;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (ri < S)
      x = *reinterpret_cast<const uint4*>(
          src + (((size_t)b * S + ri) * heads + head) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = x;
  }
}

// A fragment of rows 16 w .. of a tile, k step kk
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* t,
                                       int row, int col) {
  a[0] = ld32(t + row * LD + col);
  a[1] = ld32(t + (row + 8) * LD + col);
  a[2] = ld32(t + row * LD + col + 8);
  a[3] = ld32(t + (row + 8) * LD + col + 8);
}

// S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys against BQ q rows,
// then P^T = exp(S^T scale - lse) (0 where masked) and dS^T = P^T (dP^T -
// Dl) in place; dV += P^T dO and dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(NTC)
flash_bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const int* __restrict__ q_pos,
                   const int* __restrict__ kv_pos,
                   const float* __restrict__ lse,
                   const float* __restrict__ Dl,
                   const bf16* __restrict__ dout, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int Sq, int Skv, int H, int Hkv,
                   int causal, float scale) {
  constexpr int LD = Geo<D>::LD, BQ = Geo<D>::BQ, NQ = BQ / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // ROWS x LD
  bf16* Vs = Ks + ROWS * LD;                      // ROWS x LD
  bf16* Qs = Vs + ROWS * LD;                      // BQ x LD
  bf16* dOs = Qs + BQ * LD;                       // BQ x LD
  int* qpos = reinterpret_cast<int*>(dOs + BQ * LD);  // BQ
  float* ls = reinterpret_cast<float*>(qpos + BQ);    // BQ
  float* dl = ls + BQ;                                 // BQ

  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * ROWS;
  const int G = H / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, row = 16 * warp + g;

  load_tile<D>(Ks, k, b, k0, ROWS, Skv, Hkv, hk);
  load_tile<D>(Vs, v, b, k0, ROWS, Skv, Hkv, hk);
  int kp[2];
  bool kin[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = k0 + row + 8 * i;
    kin[i] = kj < Skv;
    kp[i] = kin[i] ? kv_pos[(size_t)b * Skv + kj] : 0;
  }
  // keys row, row + 8 (C layout: [0..1] row, [2..3] row + 8), columns
  // 8 j + 2 t + {0, 1}
  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  const int nqt = (Sq + BQ - 1) / BQ;
  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    for (int qt = 0; qt < nqt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the last step's readers are done
      if (threadIdx.x < BQ) {
        const int qi = q0 + threadIdx.x;
        const size_t r = ((size_t)b * Sq + qi) * H + h;
        qpos[threadIdx.x] = qi < Sq ? q_pos[(size_t)b * Sq + qi] : 0;
        ls[threadIdx.x] = qi < Sq ? lse[r] : 0.f;
        dl[threadIdx.x] = qi < Sq ? Dl[r] : 0.f;
      }
      __syncthreads();
      // this thread's pairs: keys row, row + 8; q columns 8 n + 2 t + e
      unsigned ok = 0;  // bit 4 n + 2 i + e
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qc = 8 * n + 2 * t + e;
          const bool qin = q0 + qc < Sq;
          const int qp = qpos[qc];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const bool o = qin && kin[i] && (!causal || kp[i] <= qp);
            ok |= unsigned(o) << (4 * n + 2 * i + e);
          }
        }
      if (!__syncthreads_or(ok != 0)) continue;
      load_tile<D>(Qs, q, b, q0, BQ, Sq, H, h);
      load_tile<D>(dOs, dout, b, q0, BQ, Sq, H, h);
      __syncthreads();

      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        frag_a<LD>(ak, Ks, row, 16 * kk + 2 * t);
        frag_a<LD>(av, Vs, row, 16 * kk + 2 * t);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          const bf16* qr = Qs + (8 * n + g) * LD + 16 * kk + 2 * t;
          const bf16* dr = dOs + (8 * n + g) * LD + 16 * kk + 2 * t;
          mma(s[n], ak, ld32(qr), ld32(qr + 8));
          mma(dp[n], av, ld32(dr), ld32(dr + 8));
        }
      }
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4) {
          const int i = e4 >> 1, e = e4 & 1, qc = 8 * n + 2 * t + e;
          const bool o = (ok >> (4 * n + 2 * i + e)) & 1u;
          const float p = o ? expf(s[n][e4] * scale - ls[qc]) : 0.f;
          s[n][e4] = p;
          dp[n][e4] = p * (dp[n][e4] - dl[qc]);
        }
#pragma unroll
      for (int kq = 0; kq < BQ / 16; ++kq) {
        uint32_t ph[4], pl[4], sh[4], sl[4];
        frag_split(ph, pl, s[2 * kq], s[2 * kq + 1]);
        frag_split(sh, sl, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          const bf16* gr = dOs + (16 * kq + 2 * t) * LD + 8 * j + g;
          const bf16* qr = Qs + (16 * kq + 2 * t) * LD + 8 * j + g;
          const uint32_t g0 = col2<LD>(gr), g1 = col2<LD>(gr + 8 * LD);
          const uint32_t q0b = col2<LD>(qr), q1b = col2<LD>(qr + 8 * LD);
          mma(acc_v[j], ph, g0, g1);
          mma(acc_v[j], pl, g0, g1);
          mma(acc_k[j], sh, q0b, q1b);
          mma(acc_k[j], sl, q0b, q1b);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = k0 + row + 8 * i;
    if (kj >= Skv) continue;
    const size_t base = (((size_t)b * Skv + kj) * Hkv + hk) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      *reinterpret_cast<uint32_t*>(dk + base + 8 * j) = pack(
          acc_k[j][2 * i] * scale, acc_k[j][2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + base + 8 * j) =
          pack(acc_v[j][2 * i], acc_v[j][2 * i + 1]);
    }
  }
}

// S = Q K^T and dP = dO V^T for this warp's 16 q rows against a 64-key
// tile, P and dS in place, dQ += dS K.
template <int D>
__global__ void __launch_bounds__(NTC)
flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ q_pos,
                 const int* __restrict__ kv_pos,
                 const float* __restrict__ lse, const float* __restrict__ Dl,
                 const bf16* __restrict__ dout, bf16* __restrict__ dq, int Sq,
                 int Skv, int H, int Hkv, int causal, float scale) {
  constexpr int LD = Geo<D>::LD, NK = 64 / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // ROWS x LD
  bf16* dOs = Qs + ROWS * LD;                     // ROWS x LD
  bf16* Ks = dOs + ROWS * LD;                     // 64 x LD
  bf16* Vs = Ks + 64 * LD;                        // 64 x LD
  int* kpos = reinterpret_cast<int*>(Vs + 64 * LD);  // 64

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;  // last tile first
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, row = 16 * warp + g;

  load_tile<D>(Qs, q, b, q0, ROWS, Sq, H, h);
  load_tile<D>(dOs, dout, b, q0, ROWS, Sq, H, h);
  int qp[2];
  bool qin[2];
  float lr[2], dlr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + row + 8 * i;
    const size_t r = ((size_t)b * Sq + qi) * H + h;
    qin[i] = qi < Sq;
    qp[i] = qin[i] ? q_pos[(size_t)b * Sq + qi] : 0;
    lr[i] = qin[i] ? lse[r] : 0.f;
    dlr[i] = qin[i] ? Dl[r] : 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int nkt = (Skv + 63) / 64;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * 64;
    __syncthreads();  // the last step's readers are done
    if (threadIdx.x < 64) {
      const int kj = k0 + threadIdx.x;
      kpos[threadIdx.x] = kj < Skv ? kv_pos[(size_t)b * Skv + kj] : 0;
    }
    __syncthreads();
    unsigned ok = 0;  // bit 4 n + 2 i + e: row + 8 i, key 8 n + 2 t + e
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = 8 * n + 2 * t + e;
        const bool kin = k0 + kc < Skv;
        const int kpv = kpos[kc];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const bool o = qin[i] && kin && (!causal || kpv <= qp[i]);
          ok |= unsigned(o) << (4 * n + 2 * i + e);
        }
      }
    if (!__syncthreads_or(ok != 0)) continue;
    load_tile<D>(Ks, k, b, k0, 64, Skv, Hkv, hk);
    load_tile<D>(Vs, v, b, k0, 64, Skv, Hkv, hk);
    __syncthreads();

    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ag[4];
      frag_a<LD>(aq, Qs, row, 16 * kk + 2 * t);
      frag_a<LD>(ag, dOs, row, 16 * kk + 2 * t);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const bf16* kr = Ks + (8 * n + g) * LD + 16 * kk + 2 * t;
        const bf16* vr = Vs + (8 * n + g) * LD + 16 * kk + 2 * t;
        mma(s[n], aq, ld32(kr), ld32(kr + 8));
        mma(dp[n], ag, ld32(vr), ld32(vr + 8));
      }
    }
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        const int i = e4 >> 1, e = e4 & 1;
        const bool o = (ok >> (4 * n + 2 * i + e)) & 1u;
        const float p = o ? expf(s[n][e4] * scale - lr[i]) : 0.f;
        dp[n][e4] = p * (dp[n][e4] - dlr[i]);
      }
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      uint32_t sh[4], sl[4];
      frag_split(sh, sl, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const bf16* kr = Ks + (16 * kq + 2 * t) * LD + 8 * j + g;
        const uint32_t k0b = col2<LD>(kr), k1b = col2<LD>(kr + 8 * LD);
        mma(acc[j], sh, k0b, k1b);
        mma(acc[j], sl, k0b, k1b);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + row + 8 * i;
    if (qi >= Sq) continue;
    bf16* o = dq + (((size_t)b * Sq + qi) * H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(o + 8 * j) =
          pack(acc[j][2 * i] * scale, acc[j][2 * i + 1] * scale);
  }
}

template <int D>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v,
                   const int* q_pos, const int* kv_pos, const float* lse,
                   const float* Dl, const bf16* dout, bf16* dq, bf16* dk,
                   bf16* dv, int B, int Sq, int Skv, int H, int Hkv,
                   int causal, float scale, cudaStream_t stream) {
  constexpr int LD = Geo<D>::LD, BQ = Geo<D>::BQ;
  const size_t smem_kv = 2 * (2 * ROWS * LD + 2 * BQ * LD) + 3 * 4 * BQ;
  auto kern_kv = flash_bwd_dkdv_mma<D>;
  cudaError_t err = rt::allow_smem(kern_kv, smem_kv);
  if (err != cudaSuccess) return err;
  kern_kv<<<dim3((Skv + ROWS - 1) / ROWS, Hkv, B), NTC, smem_kv, stream>>>(
      q, k, v, q_pos, kv_pos, lse, Dl, dout, dk, dv, Sq, Skv, H, Hkv, causal,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem_q = 2 * (2 * ROWS * LD + 2 * 64 * LD) + 4 * 64;
  auto kern_q = flash_bwd_dq_mma<D>;
  err = rt::allow_smem(kern_q, smem_q);
  if (err != cudaSuccess) return err;
  kern_q<<<dim3((Sq + ROWS - 1) / ROWS, H, B), NTC, smem_q, stream>>>(
      q, k, v, q_pos, kv_pos, lse, Dl, dout, dq, Sq, Skv, H, Hkv, causal,
      scale);
  return cudaGetLastError();
}

}  // namespace tc

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_pos, const int* kv_pos, const void* out,
                   const float* lse, const void* dout, void* dq, void* dk,
                   void* dv, float* Dl, int B, int Sq, int Skv, int H,
                   int Hkv, int causal, float scale, cudaStream_t stream) {
  constexpr int DP = D + 1;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);

  const long long rows = (long long)B * Sq * H;
  flash_bwd_preprocess<T, D><<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)),
                               NT, 0, stream>>>(static_cast<const T*>(out),
                                                gt, Dl, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return tc::launch<D>(qt, kt, vt, q_pos, kv_pos, lse, Dl, gt,
                         static_cast<T*>(dq), static_cast<T*>(dk),
                         static_cast<T*>(dv), B, Sq, Skv, H, Hkv, causal,
                         scale, stream);
  } else {
    const size_t smem_kv =
        sizeof(float) * (2 * BK * DP + 2 * BQ * DP + 2 * BQ * PS);
    auto kern_kv = flash_bwd_dkdv_simt<T, D>;
    err = rt::allow_smem(kern_kv, smem_kv);
    if (err != cudaSuccess) return err;
    kern_kv<<<dim3((Skv + BK - 1) / BK, Hkv, B), NT, smem_kv, stream>>>(
        qt, kt, vt, q_pos, kv_pos, lse, Dl, gt, static_cast<T*>(dk),
        static_cast<T*>(dv), Sq, Skv, H, Hkv, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    const size_t smem_q =
        sizeof(float) * (2 * BQ * DP + 2 * BK * DP + BQ * PS);
    auto kern_q = flash_bwd_dq_simt<T, D>;
    err = rt::allow_smem(kern_q, smem_q);
    if (err != cudaSuccess) return err;
    kern_q<<<dim3((Sq + BQ - 1) / BQ, H, B), NT, smem_q, stream>>>(
        qt, kt, vt, q_pos, kv_pos, lse, Dl, gt, static_cast<T*>(dq), Sq,
        Skv, H, Hkv, causal, scale);
    return cudaGetLastError();
  }
}

// The instantiated head dims; ops.py's HEAD_DIMS lists the same.
template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     const int* q_pos, const int* kv_pos, const void* out,
                     const float* lse, const void* dout, void* dq, void* dk,
                     void* dv, float* Dl, int B, int Sq, int Skv, int H,
                     int Hkv, int causal, float scale, cudaStream_t stream) {
#define REPRO_FLASH_BWD_CASE(A)                                             \
  if (D == A)                                                               \
    return launch<T, A>(q, k, v, q_pos, kv_pos, out, lse, dout, dq, dk, dv, \
                        Dl, B, Sq, Skv, H, Hkv, causal, scale, stream);
  REPRO_FLASH_BWD_CASE(32)
  REPRO_FLASH_BWD_CASE(64)
  REPRO_FLASH_BWD_CASE(128)
#undef REPRO_FLASH_BWD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the CUDA error of the three launches (0 on success).  D is the
// head dim of q, k and v alike; Dl is fp32 scratch of B * Sq * H.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* kv_pos, const void* out, const void* lse, const void* dout,
    void* dq, void* dk, void* dv, void* Dl, int B, int Sq, int Skv, int H,
    int Hkv, int D, int causal, float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv != 0)
    return cudaErrorInvalidValue;
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  const float* ls = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(Dl);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32)
    return dispatch<float>(D, q, k, v, qp, kp, out, ls, dout, dq, dk, dv, dl,
                           B, Sq, Skv, H, Hkv, causal, scale, s);
  if (dtype == rt::kBF16)
    return dispatch<__nv_bfloat16>(D, q, k, v, qp, kp, out, ls, dout, dq, dk,
                                   dv, dl, B, Sq, Skv, H, Hkv, causal, scale,
                                   s);
  return cudaErrorInvalidValue;
}
