// The backward of prefill attention for Hopper (sm_90a).
//
// Replaces the VJP of repro/models/flash.py::flash_attention (_bwd, pure
// JAX in the reference: the TPU kernel flash_attention_tpu has no
// backward of its own) under the contract of the port's plain version,
// repro_torch/models/flash.py::flash_attention_bwd: q and k (B, S, heads,
// DQ), v (B, Skv, Hkv, DV) with explicit q/kv positions, causal or not, Sq
// != Skv and GQA (q head h reads kv head h / (H / Hkv)); from the forward's
// out (B, Sq, H, DV), its log-sum-exp lse (B, Sq, H) fp32 (natural-log units
// of the scaled, softcapped scores) and dout (B, Sq, H, DV), it writes dq,
// dk, dv in the input type.  The scale is 1/sqrt(DQ); every sum is fp32.  A
// sliding window masks the keys at or below q position - window; a tanh
// softcap takes S = tanh(S_pre / cap) cap before the mask and multiplies
// dS by its chain factor 1 - (S / cap)^2, as the reference's _bwd does.
// The (q/k, v) head dims (32, 32), (64, 64), (80, 80) (H2O-Danube-1.8B),
// (128, 128), (192, 128) (DeepSeek-R1's MLA: q/k heads of 128 + 64 rope
// columns, v heads of 128) and (256, 256) (RecurrentGemma-2B) are
// instantiated.  The products contract over DQ (S = Q K^T) or DV (dP = dO
// V^T, and the preprocess's rowsum); dV is DV wide, dK and dQ DQ wide.
//
// What bounds it on an H100: at the training shape (SmolLM-360M, B=8,
// S=4096, H=15 on 5, D=64, causal) the work is ~0.65 TFLOP (2.5 times the
// forward's) against ~0.4 GB of q, k, v, out, dout, lse, dq, dk, dv: far
// past the card's balance point, so the tensor cores' rate bounds it.
//
// Three launches on the caller's stream, and no atomics:
//   1. preprocess: Dl = rowsum(dout * out) in fp32;
//   2. dK/dV: one CTA per (key tile, kv head, batch row) walks the q tiles
//      of its G q heads that may attend to its keys and adds, each step,
//      dV += P^T dO and dK += dS^T Q, recomputing S^T = K Q^T, P^T =
//      exp(S^T scale - lse) (0 where masked; under a softcap exp(tanh(S^T
//      scale / cap) cap - lse)), dP^T = V dO^T and dS^T = P^T (dP^T - Dl)
//      (times the softcap's chain factor); dK is scaled once at the end;
//   3. dQ: one CTA per (q tile, q head, batch row) walks the key tiles it
//      may attend to, recomputing S, P, dP and dS, and adds dQ += dS K,
//      scaled at the end.
// Splitting dK/dV from dQ recomputes S and dP once more, but each CTA owns
// its outputs whole: nothing is added across CTAs (the GQA fold of dK/dV
// over the G q heads is a loop inside the CTA), every sum runs in a fixed
// order, and two launches on the same inputs give equal bits.
//
// bf16 (namespace wg) runs the products on the tensor cores by wgmma, on
// tiles that TMA brings:
// - The preprocess also writes, for each (batch row, q head), the rows'
//   lse (in log2 units), Dl and q positions side by side into fp32
//   scratch, (B, H, 3, Sqp) with Sq padded to Sqp, a multiple of 64
//   (padding rows 0), and the kv positions as (B, Skvp): one TMA box then
//   reads a q tile's 3 x BN values (over lse's own (B, Sq, H) layout a box
//   would have an inner extent of one float, and TMA needs 16 bytes), and
//   the padding keeps every row stride a multiple of 16 bytes whatever Sq
//   and Skv are.
// - A CTA is two consumer warpgroups of 64 rows each (wgmma's M) and one
//   producer warp, whose lane 0 issues every TMA load.  Two consumers
//   share each streamed tile: half the TMA loads and shared-memory fills
//   of one consumer a CTA.  No setmaxnreg: the SM reserves a 288-thread
//   CTA's registers as for 384 threads, so ptxas caps every thread at 168
//   (224 failed to launch), and with a producer warpgroup lowered by
//   setmaxnreg ptxas still compiled the consumers to 168 (the same spills),
//   so it would free nothing they could use.
// - dK/dV: the CTA's keys of K and V are loaded once (128-byte swizzle,
//   64-byte at D = 32; two 64-column boxes a row at D = 128).  Q, dO and
//   the (lse, Dl, position) rows of each visited q tile stream through a
//   4-stage ring: a stage's "full" mbarrier counts its TMA bytes, its
//   "empty" one the 8 consumer warps done with it.  Per step and consumer:
//   S^T = K Q^T and dP^T = V dO^T by SS wgmma (both operands K-major over
//   D; N = BN q rows), P^T and dS^T in the accumulators' registers, each
//   split into bf16 hi + lo A fragments (the accumulator's columns 16 kk..
//   are the A fragment of k step kk, as for the forward's P V), then dV +=
//   P^T dO and dK += dS^T Q by RS wgmma, twice each (hi, lo), dO and Q
//   being MN-major B operands (D contiguous in a row).
// - Registers (168 a thread): dK and dV take D/2 fp32 each, S^T and dP^T
//   BN/2 each, their hi + lo fragments BN/4 each.  D = 32 and 64: each
//   consumer owns 64 of the CTA's 128 keys and adds both, BN = 64 (at D =
//   64 this fills the 168 with a few bytes spilled).  D = 80: each consumer
//   owns 64 keys and adds both, BN = 32 (dK and dV take 80, S^T and dP^T
//   32 and their fragments 32: D = 64's budget).  Its rows are two
//   64-column TMA boxes over maps of extent 80, the second arriving
//   zero-filled past column 80 (as the forward's); S^T = K Q^T and dP^T run
//   5 k16 steps, and a product at N = 80 is an n64 product over the first
//   box and an n16 over the second (sm90::wgmma_rs<80>), whose registers lie
//   as one n80 product's.  ptxas: dQ 144-166 registers, dK/dV 161-168, no
//   spills (PERF.md).
//   D = 128: dK and dV alone would take 128, so both consumers own the
//   CTA's 64 keys, consumer 0 adds dV (from S^T only) and consumer 1 dK,
//   BN = 32; that recomputes S^T once more (7 units of product work where
//   the others do 6) but spills nothing.  The two roles are separate
//   instantiations of the walk: ptxas serializes every wgmma of a kernel
//   that issues one on a branch it cannot prove uniform.
//   D = 256: even one 64 x 256 fp32 accumulator (128 registers) leaves too
//   few for S^T, dP^T and their fragments, so every accumulator holds half
//   of its 256 columns (Geo::kHalves = 2, 64 registers).  dK/dV: the two
//   roles of D = 128 (consumer 0 dV, consumer 1 dK, one 64-key tile, BN =
//   32), each over the columns of the CTA's half: two CTAs a key tile
//   (grid y = key tile x 2 + half), each recomputing S^T (and dP^T) whole,
//   10 units of product work where D = 128 does 7.  dQ: both consumers
//   take the CTA's 64 q rows (Geo::BR = 64), consumer c adding columns
//   128 c.. of dQ, with 32-key steps (Geo::BKQ) so that S, dP and their
//   fragments take 48 registers; each consumer recomputes S and dP whole.
//   (DQ, DV) = (192, 128) (MLA): rows of q and k are three 64-column
//   boxes, rows of v and dO two (Geo::kRowQK, kRowV).  dK/dV: D = 128's
//   split roles, BN = 32: consumer 0 adds dV (N = 128, 64 registers),
//   consumer 1 dK by one n192 wgmma a k step (96 registers, beside S^T,
//   dP^T and their fragments, 48).  dQ: 64 rows a consumer as at D = 128,
//   but 32-key steps (Geo::BKQ), as at D = 256: with 64-key steps S, dP
//   and their fragments (96 registers) beside dQ's 96 would pass the 168,
//   and Q + dO of 128 rows (80 KiB) with 4 stages of 64 keys (41 KiB
//   each) the 227 KiB; at 32 keys a stage takes 21 KiB.  S^T = K Q^T and
//   S = Q K^T run 12 k16 steps over three boxes, dP^T and dP 8 over two.
//   A product of 128 columns is an n128 wgmma over two 64-column boxes
//   (MN-major B, LBO one box apart), the half's boxes 2 x box apart; S^T =
//   K Q^T and S = Q K^T run 16 k16 steps over the four boxes of a row.
// - A softcap and a window are compile-time flags of both walks (CAP, WIN;
//   four instantiations a head dim): with them as runtime branches the
//   uncapped, unwindowed walks lost registers to code they never run and
//   took ~7% longer at the training shapes of the dense decoders.
// - dQ: the CTA's 128 q rows of Q and dO are loaded once; K, V and the kv
//   positions of each visited 64-key tile stream through the ring; S = Q
//   K^T and dP = dO V^T by SS wgmma, P and dS in registers, dQ += dS K by
//   an RS wgmma pair with K as the MN-major B.  No online softmax: lse is
//   given.  A thread holds D/2 + 32 + 32 + 32 registers of it.
// - Visits: before the loop the whole CTA reads the positions and keeps in
//   shared memory the least and greatest position of every tile it may
//   walk (8 bytes a tile).  The producer and the consumers then walk the
//   same tiles in the same order, each dropping a tile that lies wholly
//   above the causal limit or wholly outside the window for every row of
//   the CTA (a dK/dV CTA visits q tiles only from its least key position
//   up to its greatest + window, a dQ CTA key tiles only from its least q
//   position - window up to its greatest), so the producer loads ahead with
//   no vote.  A consumer skips the products of a tile none of its 64 rows
//   may attend to, and the per-element mask of one whose every pair is
//   allowed (the softcap's tanh and chain factor stay).  The tile index is
//   the grid's slowest dimension, taken from the heaviest end under a causal mask (dK/dV's first key tiles,
//   dQ's last q tiles): the longest CTAs of every head start first, and the
//   last wave is short ones.
// - Shared memory: dK/dV holds K and V (16, 32, 64, 32, 40, 64 KiB at D =
//   32, 64, 80, 128, (192, 128), 256) and 4 stages of 9, 17, 17, 17, 21, 33
//   KiB; dQ holds Q and dO (16, 32, 64, 64, 80, 64 KiB) and 4 stages of 9,
//   17, 33, 33, 21, 33 KiB.  The tile ranges take what is left of the 227
//   KiB, which caps Sq and Skv (repro_flash_bwd_max_len: 244,928 at D = 80
//   and 128, 253,536 at (192, 128), 122,464 at 256).
// - Where the time goes (PERF.md, SmolLM-360M's shape): the loads and
//   barriers alone (no products, no exponentials) take ~0.3 ms a kernel;
//   the rest is the products and, in dQ, the exponentials and splits,
//   which the two consumers overlap poorly.  Measured no faster on an
//   H100: the consumers taking turns at the tensor cores (named barriers),
//   a 6-stage ring, 32 q rows a dK/dV step at D = 64.
// Why the hi + lo split stays: P and dS are fp32 A operands; rounded to
// bf16 once (as FlashAttention-2 does), the gradients' near-zero elements
// missed the plain version's tolerance at the training shapes, so each
// goes in as hi + lo (x = hi + lo to ~16 bits), two products each.  With
// the recomputed S and dP that is 10 units of product work where the bound
// counts 5: this design's floor is twice the bound.
//
// fp32 (the simt kernels, the first version) runs the same three steps on
// the CUDA cores: each thread owns 4 x 4 of a 64 x 64 score tile (rows
// 4 ty.., keys tx + 16 j) and 4 rows x D/16 columns of an accumulator; a
// tile is skipped by a block vote on the exact mask before its Q and dO
// (or K and V) are read.  At D = 256 the 64-row fp32 tiles of K, V, Q and
// dO would take 290 KiB, so dK/dV steps over 32 q rows and dQ over 32 keys
// (2 x 4 and 4 x 2 scores a thread; 210 and 202 KiB).  At (192, 128) the
// 64-row tiles fit (195 and 178 KiB).
// Keys are masked at the true Skv and rows at the true Sq: nothing is
// padded in the inputs.

#include <climits>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int BQ = 64;      // q rows per tile
constexpr int BK = 64;      // keys per tile
constexpr int NT = 256;     // threads: 16 row groups x 16 lanes
constexpr int PS = BK + 4;  // row stride of the P / dS tiles (16-byte rows)

// n rounded up to a multiple of 64: the padded row count of the bf16
// route's scratch
__host__ __device__ constexpr int pad64(int n) { return (n + 63) / 64 * 64; }

// Lanes of the bf16 preprocess a row: D / 8 (16 bytes each) rounded up to a
// power of two (16 at D = 80, whose last 6 lanes read nothing; the whole
// warp at D = 256), so that a row's lanes sit in one warp and sum by
// butterfly shuffles.
__host__ __device__ constexpr int row_lanes(int D) {
  return D / 8 <= 4 ? 4 : D / 8 <= 8 ? 8 : D / 8 <= 16 ? 16 : 32;
}

// sum_d g[d] * o[d] over one row, in every lane of the warp
template <typename T, int D>
__device__ __forceinline__ float row_dot(const T* __restrict__ o,
                                         const T* __restrict__ g, int lane) {
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32)
    acc = fmaf(rt::to_f32(g[d]), rt::to_f32(o[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// Dl = rowsum(dout * out) over v's head dim D.  Plain (fp32 route): one
// warp a row, Dl is (B, Sq, H).  Tiled (bf16 route): row_lanes(D) lanes a row, and Dl is the wgmma
// kernels' scratch: for each (b, h) three rows of Sqp fp32, lse, Dl and the
// q position's bits (rows s >= Sq hold 0), rows running s fastest so that
// neighbours write side by side; then, from the blocks of blockIdx.y = 1,
// the kv positions
// as (B, Skvp) int32 (keys past Skv hold 0).
template <typename T, int D, bool kTiled>
__global__ void __launch_bounds__(NT)
flash_bwd_preprocess(const T* __restrict__ out, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const int* __restrict__ q_pos,
                     const int* __restrict__ kv_pos, float* __restrict__ Dl,
                     int B, int Sq, int Skv, int H) {
  if constexpr (!kTiled) {
    const int lane = threadIdx.x % 32;
    const long long w = (long long)blockIdx.x * (NT / 32) + threadIdx.x / 32;
    if (w >= (long long)B * Sq * H) return;
    const float acc = row_dot<T, D>(out + w * D, dout + w * D, lane);
    if (lane == 0) Dl[w] = acc;
  } else {
    const int Sqp = pad64(Sq), Skvp = pad64(Skv);
    if (blockIdx.y == 1) {
      const long long e = (long long)blockIdx.x * NT + threadIdx.x;
      if (e >= (long long)B * Skvp) return;
      const int b = int(e / Skvp), j = int(e % Skvp);
      reinterpret_cast<int*>(Dl + 3LL * B * H * Sqp)[e] =
          j < Skv ? kv_pos[(size_t)b * Skv + j] : 0;
      return;
    }
    // L lanes a row, 16 bytes of out and dout each (D / 8 of them)
    constexpr int L = row_lanes(D);
    const long long r = ((long long)blockIdx.x * NT + threadIdx.x) / L;
    const int sub = threadIdx.x % L;
    const bool live = r < (long long)B * H * Sqp;  // a row's lanes agree
    const int s = int(r % Sqp);
    const long long bh = r / Sqp;  // b * H + h
    float acc = 0.f, ls = 0.f;
    int qp = 0;
    if (live && s < Sq) {
      const int h = int(bh % H), b = int(bh / H);
      const long long row = ((long long)b * Sq + s) * H + h;
      if (sub < D / 8) {
        const uint4 o = reinterpret_cast<const uint4*>(out + row * D)[sub];
        const uint4 g = reinterpret_cast<const uint4*>(dout + row * D)[sub];
        const __nv_bfloat162* o2 =
            reinterpret_cast<const __nv_bfloat162*>(&o);
        const __nv_bfloat162* g2 =
            reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 x = __bfloat1622float2(o2[i]);
          const float2 y = __bfloat1622float2(g2[i]);
          acc = fmaf(y.x, x.x, acc);
          acc = fmaf(y.y, x.y, acc);
        }
      }
      ls = lse[row];
      qp = q_pos[(size_t)b * Sq + s];
    }
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (live && sub == 0) {  // lse in log2 units: the kernels take 2^x
      float* o = Dl + bh * 3 * Sqp + s;
      o[0] = ls * 1.4426950408889634f;
      o[Sqp] = acc;
      o[2 * Sqp] = __int_as_float(qp);
    }
  }
}

// rows [r0, r0 + ROWS) of a (B, S, heads, D) tensor at (b, head) into a
// ROWS x (D + 1) fp32 tile; rows past S are zeros
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst,
                                          const T* __restrict__ src, int b,
                                          int r0, int S, int heads,
                                          int head) {
  constexpr int DP = D + 1;
#pragma unroll 4
  for (int e = threadIdx.x; e < ROWS * D; e += NT) {
    const int r = e / D, d = e % D, ri = r0 + r;
    const size_t at = (((size_t)b * S + ri) * heads + head) * D + d;
    dst[r * DP + d] = ri < S ? rt::to_f32(src[at]) : 0.f;
  }
}

// The RI x RJ scores of this thread (rows RI ty + i, keys tx + 16 j), S =
// A B^T over DQ and dP = C E^T over DV (A, C: the q-side tiles Q, dO; B, E:
// the key-side tiles K, V; DV <= DQ), then P and dS in place of them: P =
// exp(S * scale - lse) where ok, else 0; dS = P (dP - Dl).  Under a softcap
// S * scale becomes tanh(S * scale / cap) cap and dS takes the chain factor
// 1 - tanh^2.
template <int DQ, int DV, int RI, int RJ>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       int ty, int tx,
                                       const bool (&ok)[RI][RJ],
                                       const float (&lse)[RI],
                                       const float (&dl)[RI], float scale,
                                       float softcap, float (&p)[RI][RJ],
                                       float (&ds)[RI][RJ]) {
  constexpr int DPQ = DQ + 1, DPV = DV + 1;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RJ; ++j) p[i][j] = ds[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DV; ++d) {
    float a[RI], c[RI], bk[RJ], bv[RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      a[i] = Qs[(ty * RI + i) * DPQ + d];
      c[i] = dOs[(ty * RI + i) * DPV + d];
    }
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      bk[j] = Ks[(tx + 16 * j) * DPQ + d];
      bv[j] = Vs[(tx + 16 * j) * DPV + d];
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        p[i][j] = fmaf(a[i], bk[j], p[i][j]);
        ds[i][j] = fmaf(c[i], bv[j], ds[i][j]);
      }
  }
  // S's columns past v's head dim (none where DQ = DV)
#pragma unroll 8
  for (int d = DV; d < DQ; ++d) {
    float a[RI], bk[RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) a[i] = Qs[(ty * RI + i) * DPQ + d];
#pragma unroll
    for (int j = 0; j < RJ; ++j) bk[j] = Ks[(tx + 16 * j) * DPQ + d];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) p[i][j] = fmaf(a[i], bk[j], p[i][j]);
  }
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      float x = p[i][j] * scale, chain = 1.f;
      if (softcap > 0.f) {
        const float th = tanhf(x / softcap);
        x = th * softcap;
        chain = 1.f - th * th;
      }
      const float pij = ok[i][j] ? expf(x - lse[i]) : 0.f;
      p[i][j] = pij;
      ds[i][j] = pij * (ds[i][j] - dl[i]) * chain;
    }
}

// The mask of this thread's RI x RJ pairs; returns whether any is allowed.
template <int RI, int RJ>
__device__ __forceinline__ int pair_mask(const int (&qp)[RI],
                                         const bool (&qin)[RI],
                                         const int (&kp)[RJ],
                                         const bool (&kin)[RJ], int causal,
                                         int window, bool (&ok)[RI][RJ]) {
  int any = 0;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      bool o = qin[i] && kin[j];
      if (causal) o = o && kp[j] <= qp[i];
      if (window > 0) o = o && kp[j] > qp[i] - window;
      ok[i][j] = o;
      any |= o;
    }
  return any;
}

// dK/dV of 64 keys, stepping over QR q rows (64; 32 at D = 256)
template <typename T, int DQ, int DV, int QR>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_simt(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ q_pos,
                    const int* __restrict__ kv_pos,
                    const float* __restrict__ lse,
                    const float* __restrict__ Dl, const T* __restrict__ dout,
                    T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv,
                    int H, int Hkv, int causal, int window, float softcap,
                    float scale) {
  constexpr int DPQ = DQ + 1, DPV = DV + 1, DCK = DQ / 16, DCV = DV / 16;
  constexpr int RI = QR / 16;
  extern __shared__ float smem[];
  float* Ks = smem;             // BK x DPQ
  float* Vs = Ks + BK * DPQ;    // BK x DPV
  float* Qs = Vs + BK * DPV;    // QR x DPQ
  float* dOs = Qs + QR * DPQ;   // QR x DPV
  float* Ps = dOs + QR * DPV;   // QR x PS
  float* dSs = Ps + QR * PS;    // QR x PS

  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * BK;
  const int G = H / Hkv;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  load_tile<T, DQ, BK>(Ks, k, b, k0, Skv, Hkv, hk);
  load_tile<T, DV, BK>(Vs, v, b, k0, Skv, Hkv, hk);
  int kp[4];
  bool kin[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kj = k0 + tx + 16 * j;
    kin[j] = kj < Skv;
    kp[j] = kin[j] ? kv_pos[(size_t)b * Skv + kj] : 0;
  }
  float acc_k[4][DCK], acc_v[4][DCV];  // keys 4 ty + i, columns tx + 16 c
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < DCK; ++c) acc_k[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < DCV; ++c) acc_v[i][c] = 0.f;
  }

  const int nqt = (Sq + QR - 1) / QR;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int qt = 0; qt < nqt; ++qt) {
      const int q0 = qt * QR;
      int qp[RI];
      bool qin[RI];
      float ls[RI], dl[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int qi = q0 + ty * RI + i;
        qin[i] = qi < Sq;
        const size_t row = ((size_t)b * Sq + qi) * H + h;
        qp[i] = qin[i] ? q_pos[(size_t)b * Sq + qi] : 0;
        ls[i] = qin[i] ? lse[row] : 0.f;
        dl[i] = qin[i] ? Dl[row] : 0.f;
      }
      bool ok[RI][4];
      const int any = pair_mask(qp, qin, kp, kin, causal, window, ok);
      // also the barrier between the last step's readers and this step's
      // writers of Qs, dOs, Ps and dSs (and, first, the K/V loads)
      if (!__syncthreads_or(any)) continue;
      load_tile<T, DQ, QR>(Qs, q, b, q0, Sq, H, h);
      load_tile<T, DV, QR>(dOs, dout, b, q0, Sq, H, h);
      __syncthreads();

      float p[RI][4], ds[RI][4];
      scores<DQ, DV>(Qs, dOs, Ks, Vs, ty, tx, ok, ls, dl, scale, softcap, p,
                     ds);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          Ps[(ty * RI + i) * PS + tx + 16 * j] = p[i][j];
          dSs[(ty * RI + i) * PS + tx + 16 * j] = ds[i][j];
        }
      __syncthreads();

      // dV[key] += sum_r P[r, key] dO[r]; dK[key] += sum_r dS[r, key] Q[r]
#pragma unroll 4
      for (int r = 0; r < QR; ++r) {
        const float4 pr =
            *reinterpret_cast<const float4*>(Ps + r * PS + ty * 4);
        const float4 sr =
            *reinterpret_cast<const float4*>(dSs + r * PS + ty * 4);
        const float pv[4] = {pr.x, pr.y, pr.z, pr.w};
        const float sv[4] = {sr.x, sr.y, sr.z, sr.w};
#pragma unroll
        for (int c = 0; c < DCV; ++c) {
          const float go = dOs[r * DPV + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc_v[i][c] = fmaf(pv[i], go, acc_v[i][c]);
        }
#pragma unroll
        for (int c = 0; c < DCK; ++c) {
          const float qq = Qs[r * DPQ + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc_k[i][c] = fmaf(sv[i], qq, acc_k[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty * 4 + i;
    if (kj >= Skv) continue;
    const size_t row = ((size_t)b * Skv + kj) * Hkv + hk;
#pragma unroll
    for (int c = 0; c < DCK; ++c)
      dk[row * DQ + tx + 16 * c] = rt::from_f32<T>(acc_k[i][c] * scale);
#pragma unroll
    for (int c = 0; c < DCV; ++c)
      dv[row * DV + tx + 16 * c] = rt::from_f32<T>(acc_v[i][c]);
  }
}

// dQ of 64 q rows, stepping over KR keys (64; 32 at D = 256)
template <typename T, int DQ, int DV, int KR>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_simt(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ q_pos,
                  const int* __restrict__ kv_pos,
                  const float* __restrict__ lse, const float* __restrict__ Dl,
                  const T* __restrict__ dout, T* __restrict__ dq, int Sq,
                  int Skv, int H, int Hkv, int causal, int window,
                  float softcap, float scale) {
  constexpr int DPQ = DQ + 1, DPV = DV + 1, DC = DQ / 16, RJ = KR / 16;
  constexpr int PK = KR + 4;
  extern __shared__ float smem[];
  float* Qs = smem;             // BQ x DPQ
  float* dOs = Qs + BQ * DPQ;   // BQ x DPV
  float* Ks = dOs + BQ * DPV;   // KR x DPQ
  float* Vs = Ks + KR * DPQ;    // KR x DPV
  float* dSs = Vs + KR * DPV;   // BQ x PK

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // last tile first
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  load_tile<T, DQ, BQ>(Qs, q, b, q0, Sq, H, h);
  load_tile<T, DV, BQ>(dOs, dout, b, q0, Sq, H, h);
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

  const int nkt = (Skv + KR - 1) / KR;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * KR;
    int kp[RJ];
    bool kin[RJ];
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      const int kj = k0 + tx + 16 * j;
      kin[j] = kj < Skv;
      kp[j] = kin[j] ? kv_pos[(size_t)b * Skv + kj] : 0;
    }
    bool ok[4][RJ];
    const int any = pair_mask(qp, qin, kp, kin, causal, window, ok);
    // also the barrier between the last step's readers and this step's
    // writers of Ks, Vs and dSs (and, first, the Q/dO loads)
    if (!__syncthreads_or(any)) continue;
    load_tile<T, DQ, KR>(Ks, k, b, k0, Skv, Hkv, hk);
    load_tile<T, DV, KR>(Vs, v, b, k0, Skv, Hkv, hk);
    __syncthreads();

    float p[4][RJ], ds[4][RJ];
    scores<DQ, DV>(Qs, dOs, Ks, Vs, ty, tx, ok, ls, dl, scale, softcap, p,
                   ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j)
        dSs[(ty * 4 + i) * PK + tx + 16 * j] = ds[i][j];
    __syncthreads();

    // dQ[r] += sum_key dS[r, key] K[key]
#pragma unroll 4
    for (int j = 0; j < KR; ++j) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dSs[(ty * 4 + i) * PK + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kk = Ks[j * DPQ + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(sv[i], kk, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Sq) continue;
    T* o = dq + (((size_t)b * Sq + qi) * H + h) * DQ;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      o[tx + 16 * c] = rt::from_f32<T>(acc[i][c] * scale);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), tiles by TMA; a producer warp and two
// consumer warpgroups a CTA (the note at the head of the file)
// ---------------------------------------------------------------------------
namespace wg {

using bf16 = __nv_bfloat16;

constexpr int NC = 2;               // consumer warpgroups
constexpr int NT = 128 * NC + 32;   // threads: the consumers, then the
                                    // producer warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kSmemLimit = 227 * 1024;  // the most a CTA may take

__host__ __device__ constexpr uint32_t up1024(uint32_t x) {
  return (x + 1023) & ~1023u;
}

// Shared-memory geometry at q/k head dim DQ and v head dim DV, offsets
// from a 1024-aligned base.  A TMA box is at most 64 bf16 columns (128
// bytes, the swizzle's width); D = 80, 128, 192 and 256 take two, two,
// three and four boxes a row, stored one after the other (at 80 the second
// holds columns 64..79 and zeros).  Rows of Q and K are DQ wide (kRowQK
// bytes), rows of V and dO DV wide (kRowV).
template <int DQ, int DV = DQ>
struct Geo {
  static_assert(DV == DQ || (DQ % 64 == 0 && DV % 64 == 0 && DV < DQ),
                "Geo: v's head dim apart from q's in whole boxes only");
  static constexpr int kBoxCols = DQ < 64 ? DQ : 64;
  static constexpr int kBoxesQK = (DQ + kBoxCols - 1) / kBoxCols;
  static constexpr int kBoxesV = (DV + kBoxCols - 1) / kBoxCols;
  static constexpr int kRowBytes = kBoxCols * 2;
  static constexpr uint32_t kRowQK = kBoxesQK * kRowBytes;  // a q or k row
  static constexpr uint32_t kRowV = kBoxesV * kRowBytes;    // a v or dO row
  static constexpr uint32_t kAtom = 8 * kRowBytes;          // 8 rows of a box
  static constexpr uint64_t kSwizzle =
      DQ < 64 ? sm90::kSwizzle64 : sm90::kSwizzle128;
  static constexpr int kKSteps = kBoxCols / 16;  // k16 steps a box
  // q rows a dK/dV step
  static constexpr int BN = DQ == 80 || DQ >= 128 ? 32 : 64;
  static constexpr int kStages = 4;              // ring stages
  // DQ >= 128: dK and dV would take 128 or more of a consumer's 168
  // registers, so the two consumers share one 64-key tile, consumer 0
  // adding dV and consumer 1 dK (both recompute S^T); below it each owns 64
  // keys and adds both
  static constexpr bool kSplit = DQ >= 128;
  // D = 256: an accumulator holds half of its columns (kColsK of dK or dQ,
  // kColsV of dV), a dK/dV CTA one half of dK and dV (kHalves CTAs a key
  // tile), and the two dQ consumers the two halves of one 64-row tile's dQ
  static constexpr int kHalves = DQ == 256 ? 2 : 1;
  static constexpr int kColsK = DQ / kHalves;
  static constexpr int kColsV = DV / kHalves;
  static constexpr int BKV = kSplit ? 64 : 64 * NC;  // keys of a dK/dV CTA
  static constexpr int BR = 64 * NC / kHalves;       // q rows of a dQ CTA
  // keys a dQ step: 32 from DQ = 192 on (dQ's accumulator takes 96
  // registers or more, and Q and dO 80 KiB or more)
  static constexpr int BKQ = DQ >= 192 ? 32 : 64;
  // dK/dV: K and V (BKV rows), then the ring: per stage Q and dO (BN rows)
  // and the (lse, Dl, q position) rows, 3 x BN fp32
  static constexpr uint32_t kKvTx = BN * (kRowQK + kRowV) + 3 * BN * 4;
  static constexpr uint32_t kKvStage = up1024(kKvTx);
  static constexpr uint32_t kKvRing = BKV * (kRowQK + kRowV);
  // barriers full[kStages], empty[kStages] and the first loads', then int
  // lo[4], hi[4] (the positions of 4 warps' 32 rows), then per tile walked
  // its least and greatest position
  static constexpr uint32_t kKvBars = kKvRing + kStages * kKvStage;
  static constexpr uint32_t kKvRed = kKvBars + 8 * (2 * kStages + 1);
  static constexpr uint32_t kKvRanges = kKvRed + 8 * 4;
  // dQ: Q and dO (BR rows), then per stage K and V (BKQ rows) and the kv
  // positions (BKQ int32)
  static constexpr uint32_t kQTx = BKQ * (kRowQK + kRowV) + BKQ * 4;
  static constexpr uint32_t kQStage = up1024(kQTx);
  static constexpr uint32_t kQRing = BR * (kRowQK + kRowV);
  static constexpr uint32_t kQBars = kQRing + kStages * kQStage;
  static constexpr uint32_t kQRed = kQBars + 8 * (2 * kStages + 1);
  static constexpr uint32_t kQRanges = kQRed + 8 * 4;
  static size_t smem_kv(int nqt) {
    return 1024 + kKvRanges + 8 * size_t(nqt);
  }
  static size_t smem_q(int nkt) { return 1024 + kQRanges + 8 * size_t(nkt); }
  // the most q rows (dK/dV's BN-row tiles) and keys (dQ's BKQ-key tiles)
  // whose ranges fit the CTA's shared memory
  static int max_len() {
    const size_t q = (kSmemLimit - smem_kv(0)) / 8 * BN;
    const size_t k = (kSmemLimit - smem_q(0)) / 8 * BKQ;
    return int(q < k ? q : k);
  }
};

__device__ __forceinline__ float ex2(float x) {  // 2^x
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void warp_minmax(int& lo, int& hi) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
}

// The least and greatest position of each tile of ROWS rows of pos[0, n)
// into lo[], hi[] (a tile's rows past n are left out; a tile always has
// one), the CTA's warps taking the tiles in turn.
template <int ROWS>
__device__ __forceinline__ void tile_ranges(const int* __restrict__ pos,
                                            int n, int* lo, int* hi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = warp; t * ROWS < n; t += NT / 32) {
    int a = INT_MAX, z = INT_MIN;
#pragma unroll
    for (int j = lane; j < ROWS; j += 32)
      if (t * ROWS + j < n) {
        const int p = pos[t * ROWS + j];
        a = min(a, p);
        z = max(z, p);
      }
    warp_minmax(a, z);
    if (lane == 0) {
      lo[t] = a;
      hi[t] = z;
    }
  }
}

// The position range of the CTA's rows [r0, min(r0 + rows, n)), 32 a warp,
// by warps 0..3: red[w] the least of warp w's rows, red[4 + w] the greatest
// (INT_MAX and INT_MIN for a warp with none).
__device__ __forceinline__ void row_ranges(const int* __restrict__ pos,
                                           int r0, int rows, int n,
                                           int* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 4) return;
  const int r = r0 + 32 * warp + lane;
  int a = INT_MAX, z = INT_MIN;
  if (32 * warp + lane < rows && r < n) a = z = pos[r];
  warp_minmax(a, z);
  if (lane == 0) {
    red[warp] = a;
    red[4 + warp] = z;
  }
}

// The A fragments of k step kk from an accumulator x (the C layout of its
// columns 16 kk.. is the A layout of k step kk), split into bf16 hi and lo
// parts (x = hi + lo to ~16 bits), so that products with bf16 B keep the
// fp32 P and dS almost whole.
template <int N>
__device__ __forceinline__ void split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                      const float (&x)[N], int kk) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float a = x[8 * kk + 2 * r], c = x[8 * kk + 2 * r + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, c);
    const float2 f = __bfloat1622float2(h);
    hi[r] = *reinterpret_cast<const uint32_t*>(&h);
    lo[r] = sm90::pack_bf16(a - f.x, c - f.y);
  }
}

// d = A B^T over K columns: A's 64 rows at a_rows, B's N rows at b_rows,
// both K-major in boxes of G::kBoxCols columns a_box and b_box bytes apart.
template <int N, int K, class G>
__device__ __forceinline__ void ss_product(float (&d)[N / 2], uint32_t a_rows,
                                           uint32_t a_box, uint32_t b_rows,
                                           uint32_t b_box) {
#pragma unroll
  for (int k = 0; k < K / 16; ++k) {
    const int bx = k / G::kKSteps, col = (k % G::kKSteps) * 32;
    sm90::wgmma_ss<N>(
        d, sm90::desc(a_rows + bx * a_box + col, 16, G::kAtom, G::kSwizzle),
        sm90::desc(b_rows + bx * b_box + col, 16, G::kAtom, G::kSwizzle), k);
  }
}

// Two bf16 to global memory (4 bytes, aligned).
__device__ __forceinline__ void store2(bf16* p, float a, float c) {
  *reinterpret_cast<uint32_t*>(p) = sm90::pack_bf16(a, c);
}

// dK/dV of BKV keys of one kv head (at D = 256 of the columns of one
// half).  A consumer thread holds keys r0 and r0 + 8 of its 64 (rows of
// S^T), q columns 8 j + c0 + {0, 1}.  CAP: a softcap, WIN: a window
// (window > 0); separate instantiations, so that the walk without them
// keeps its registers.
template <int DQ, int DV, bool CAP, bool WIN>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tld,
                     const int* __restrict__ q_pos,
                     const int* __restrict__ kv_pos, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int Sq, int Skv, int H, int Hkv,
                     int causal, int window, float softcap, float scale) {
  using G = Geo<DQ, DV>;
  constexpr int BN = G::BN, BKV = G::BKV, RB = G::kRowBytes;
  constexpr int NK = G::kColsK, NV = G::kColsV;
  constexpr bool kSplit = G::kSplit;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;
  unsigned char* base = smem_raw + pad;
  const uint32_t sK = raw + pad, sV = sK + BKV * G::kRowQK;
  const uint32_t bar_full = sK + G::kKvBars;  // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * G::kStages;
  const uint32_t bar_kv = bar_empty + 8 * G::kStages;
  int* red = reinterpret_cast<int*>(base + G::kKvRed);
  const int nqt = (Sq + BN - 1) / BN;
  int* qlo = reinterpret_cast<int*>(base + G::kKvRanges);
  int* qhi = qlo + nqt;

  // grid (kv heads x batch rows, key tiles x halves): the key tiles with the
  // most q tiles (the first, when causal) of every head launch first
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int k0 = blockIdx.y / G::kHalves * BKV;
  // the CTA's half: columns half * kColsK.. of dK, half * kColsV.. of dV
  const int half = blockIdx.y % G::kHalves;
  const int groups = H / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {  // K and V at once; the ranges overlap them
    for (int st = 0; st < G::kStages; ++st) {
      sm90::mbar_init(bar_full + 8 * st, 1);
      sm90::mbar_init(bar_empty + 8 * st, 4 * NC);
    }
    sm90::mbar_init(bar_kv, 1);
    sm90::fence_mbar_init();
    sm90::mbar_expect_tx(bar_kv, BKV * (G::kRowQK + G::kRowV));
#pragma unroll
    for (int i = 0; i < G::kBoxesQK; ++i)
      sm90::tma_load_4d(sK + i * BKV * RB, &tk, bar_kv, i * G::kBoxCols, hk,
                        k0, b);
#pragma unroll
    for (int i = 0; i < G::kBoxesV; ++i)
      sm90::tma_load_4d(sV + i * BKV * RB, &tv, bar_kv, i * G::kBoxCols, hk,
                        k0, b);
  }
  row_ranges(kv_pos + (size_t)b * Skv, k0, BKV, Skv, red);
  tile_ranges<BN>(q_pos + (size_t)b * Sq, Sq, qlo, qhi);
  __syncthreads();
  const int klo = min(min(red[0], red[1]), min(red[2], red[3]));
  const int khi = max(max(red[4], red[5]), max(red[6], red[7]));
  // q tile t is walked if a row of it may attend to a key of the CTA: not
  // wholly above the causal limit, nor wholly past the window (q positions
  // only up to the greatest key's + window)
  auto walked = [&](int t) {
    return (!causal || qhi[t] >= klo) &&
           (!WIN || (long long)qlo[t] - window < khi);
  };

  if (warp == 4 * NC) {  // the producer warp: lane 0 issues every load
    if (lane == 0) {
      int i = 0;
      for (int g = 0; g < groups; ++g) {
        const int h = hk * groups + g;
        for (int t = 0; t < nqt; ++t) {
          if (!walked(t)) continue;
          const int st = i % G::kStages;
          if (i >= G::kStages)  // the stage's previous tile is consumed
            sm90::mbar_wait(bar_empty + 8 * st, (i / G::kStages - 1) & 1);
          const uint32_t dst = sK + G::kKvRing + st * G::kKvStage;
          const uint32_t full = bar_full + 8 * st;
          sm90::mbar_expect_tx(full, G::kKvTx);
#pragma unroll
          for (int bx = 0; bx < G::kBoxesQK; ++bx)
            sm90::tma_load_4d(dst + bx * BN * RB, &tq, full,
                              bx * G::kBoxCols, h, t * BN, b);
#pragma unroll
          for (int bx = 0; bx < G::kBoxesV; ++bx)
            sm90::tma_load_4d(dst + BN * G::kRowQK + bx * BN * RB, &tdo,
                              full, bx * G::kBoxCols, h, t * BN, b);
          sm90::tma_load_4d(dst + BN * (G::kRowQK + G::kRowV), &tld, full,
                            t * BN, 0, h, b);
          ++i;
        }
      }
    }
    return;
  }

  // ---- consumer cw (warps 4 cw..): keys kw0 + r0 and + 8
  const int cw = warp / 4;
  const int kw = kSplit ? 0 : 64 * cw;  // this consumer's first key row
  const int r0 = 16 * (warp % 4) + lane / 4, c0 = 2 * (lane % 4);
  const int kw0 = k0 + kw, kr0 = kw0 + r0, kr1 = kr0 + 8;
  const bool kin0 = kr0 < Skv, kin1 = kr1 < Skv;
  const int kp0 = kin0 ? kv_pos[(size_t)b * Skv + kr0] : 0;
  const int kp1 = kin1 ? kv_pos[(size_t)b * Skv + kr1] : 0;
  // the position range of this consumer's keys (warps kw / 32, + 1)
  const int wlo = min(red[kw / 32], red[kw / 32 + 1]);
  const int whi = max(red[4 + kw / 32], red[4 + kw / 32 + 1]);
  const bool wany = kw0 < Skv, wall = kw0 + 64 <= Skv;
  const float sl2e = scale * kLog2e;
  // under a softcap: S scale / cap, and the capped score's log2 factor
  const float s_cap = softcap > 0.f ? scale / softcap : 0.f;
  const float cap_l2e = softcap * kLog2e;
  const uint32_t k_rows = sK + kw * RB, v_rows = sV + kw * RB;
  // the byte offsets of the half's first box in a streamed Q and dO tile
  const uint32_t col_box_k = half * (NK / G::kBoxCols) * BN * RB;
  const uint32_t col_box_v = half * (NV / G::kBoxCols) * BN * RB;
  sm90::mbar_wait(bar_kv, 0);

  // The walk of one consumer.  ADD_V, ADD_K: whether it adds dV and dK
  // (both below D = 128; under the split consumer 0 adds dV, needing P^T
  // only, and consumer 1 dK).  Compile-time, so that no wgmma sits on a
  // branch ptxas cannot see to be warpgroup-uniform (it then serializes
  // them).
  auto walk = [&](auto dv_flag, auto dk_flag) {
    constexpr bool ADD_V = decltype(dv_flag)::value;
    constexpr bool ADD_K = decltype(dk_flag)::value;
    float acc_v[ADD_V ? NV / 2 : 1], acc_k[ADD_K ? NK / 2 : 1];
#pragma unroll
    for (int e = 0; e < (ADD_V ? NV / 2 : 1); ++e) acc_v[e] = 0.f;
#pragma unroll
    for (int e = 0; e < (ADD_K ? NK / 2 : 1); ++e) acc_k[e] = 0.f;
    int i = 0;
    for (int g = 0; g < groups; ++g) {
      for (int t = 0; t < nqt; ++t) {
        if (!walked(t)) continue;
        const int st = i % G::kStages, q0 = t * BN;
        // no key of this consumer meets a row of the tile (skip), or every
        // pair is allowed (no per-element mask)
        const bool skip = !wany || (causal && qhi[t] < wlo) ||
                          (WIN && (long long)qlo[t] - window >= whi);
        const bool full =
            wall && q0 + BN <= Sq && (!causal || whi <= qlo[t]) &&
            (!WIN || (long long)qhi[t] - window < wlo);
        const uint32_t sQ = sK + G::kKvRing + st * G::kKvStage;
        const uint32_t sdO = sQ + BN * G::kRowQK;
        const float* ld = reinterpret_cast<const float*>(
            base + G::kKvRing + st * G::kKvStage +
            BN * (G::kRowQK + G::kRowV));
        sm90::mbar_wait(bar_full + 8 * st, (i / G::kStages) & 1);
        if (!skip) {
          // S^T = K Q^T and (for dK) dP^T = V dO^T
          float s[BN / 2], dp[BN / 2];
#pragma unroll
          for (int e = 0; e < BN / 2; ++e) s[e] = dp[e] = 0.f;
          sm90::fence_regs(s);
          sm90::fence_regs(dp);
          sm90::wgmma_fence();
          ss_product<BN, DQ, G>(s, k_rows, BKV * RB, sQ, BN * RB);
          if constexpr (ADD_K)
            ss_product<BN, DV, G>(dp, v_rows, BKV * RB, sdO, BN * RB);
          sm90::wgmma_commit();
          sm90::wgmma_wait_all();
          sm90::fence_regs(s);
          sm90::fence_regs(dp);

          // P^T = exp(S^T scale - lse) (0 where masked; under a softcap
          // exp(tanh(S^T scale / cap) cap - lse)) into s, dS^T = P^T (dP^T -
          // Dl) (times the softcap's 1 - tanh^2) into dp, for q columns c =
          // 8 j + c0 + e (the lse row is in log2 units)
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 8 * j + c0 + e;
              float p0, p1, ch0 = 1.f, ch1 = 1.f;
              if constexpr (CAP) {
                const float t0 = tanhf(s[4 * j + e] * s_cap);
                const float t1 = tanhf(s[4 * j + 2 + e] * s_cap);
                p0 = ex2(fmaf(t0, cap_l2e, -ld[c]));
                p1 = ex2(fmaf(t1, cap_l2e, -ld[c]));
                ch0 = 1.f - t0 * t0;
                ch1 = 1.f - t1 * t1;
              } else {
                p0 = ex2(fmaf(s[4 * j + e], sl2e, -ld[c]));
                p1 = ex2(fmaf(s[4 * j + 2 + e], sl2e, -ld[c]));
              }
              if (!full) {
                const int qp = __float_as_int(ld[2 * BN + c]);
                const bool qin = q0 + c < Sq;
                const bool w0 = !WIN || kp0 > qp - window;
                const bool w1 = !WIN || kp1 > qp - window;
                p0 = qin && kin0 && w0 && (!causal || kp0 <= qp) ? p0 : 0.f;
                p1 = qin && kin1 && w1 && (!causal || kp1 <= qp) ? p1 : 0.f;
              }
              s[4 * j + e] = p0;
              s[4 * j + 2 + e] = p1;
              if constexpr (ADD_K) {
                const float dl = ld[BN + c];
                dp[4 * j + e] = p0 * (dp[4 * j + e] - dl) * ch0;
                dp[4 * j + 2 + e] = p1 * (dp[4 * j + 2 + e] - dl) * ch1;
              }
            }
          }

          // dV += P^T dO, then dK += dS^T Q: k steps of 16 q rows, B
          // MN-major (its 64-column boxes BN rows apart; at D = 256 the
          // half's two); each accumulator's products issued together
          uint32_t ph[ADD_V ? BN / 16 : 1][4], pl[ADD_V ? BN / 16 : 1][4];
          uint32_t sh[ADD_K ? BN / 16 : 1][4], sl[ADD_K ? BN / 16 : 1][4];
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk) {
            if constexpr (ADD_V) split(ph[kk], pl[kk], s, kk);
            if constexpr (ADD_K) split(sh[kk], sl[kk], dp, kk);
          }
          sm90::fence_regs(acc_v);
          sm90::fence_regs(acc_k);
          sm90::wgmma_fence();
          if constexpr (ADD_V) {
#pragma unroll
            for (int kk = 0; kk < BN / 16; ++kk) {
              const uint64_t bdo =
                  sm90::desc(sdO + col_box_v + kk * 16 * RB, BN * RB,
                             G::kAtom, G::kSwizzle);
              sm90::wgmma_rs<NV>(acc_v, ph[kk], bdo, BN * RB);
              sm90::wgmma_rs<NV>(acc_v, pl[kk], bdo, BN * RB);
            }
          }
          if constexpr (ADD_K) {
#pragma unroll
            for (int kk = 0; kk < BN / 16; ++kk) {
              const uint64_t bq =
                  sm90::desc(sQ + col_box_k + kk * 16 * RB, BN * RB,
                             G::kAtom, G::kSwizzle);
              sm90::wgmma_rs<NK>(acc_k, sh[kk], bq, BN * RB);
              sm90::wgmma_rs<NK>(acc_k, sl[kk], bq, BN * RB);
            }
          }
          sm90::wgmma_commit();
          sm90::wgmma_wait_all();
          sm90::fence_regs(acc_v);
          sm90::fence_regs(acc_k);
        }
        if (lane == 0) sm90::mbar_arrive(bar_empty + 8 * st);  // this warp
        ++i;                                                    // is done
      }
    }

    // dK (scaled once) and dV in bf16 (the half's columns), keys past Skv
    // not written
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!(r == 0 ? kin0 : kin1)) continue;
      const size_t row = ((size_t)b * Skv + (r == 0 ? kr0 : kr1)) * Hkv + hk;
      if constexpr (ADD_V) {
#pragma unroll
        for (int j = 0; j < NV / 8; ++j)
          store2(dv + row * DV + half * NV + 8 * j + c0,
                 acc_v[4 * j + 2 * r], acc_v[4 * j + 2 * r + 1]);
      }
      if constexpr (ADD_K) {
#pragma unroll
        for (int j = 0; j < NK / 8; ++j)
          store2(dk + row * DQ + half * NK + 8 * j + c0,
                 acc_k[4 * j + 2 * r] * scale,
                 acc_k[4 * j + 2 * r + 1] * scale);
      }
    }
  };
  using yes = std::true_type;
  using no = std::false_type;
  if constexpr (!kSplit)
    walk(yes{}, yes{});
  else if (cw == 0)
    walk(yes{}, no{});
  else
    walk(no{}, yes{});
}

// dQ of BR q rows of one q head.  A consumer thread holds rows r0 and
// r0 + 8 of its 64, columns 8 j + c0 + {0, 1} (at D = 256 of its half).
// CAP, WIN: as dK/dV's.
template <int DQ, int DV, bool CAP, bool WIN>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tkp,
                   const int* __restrict__ q_pos,
                   const int* __restrict__ kv_pos,
                   const float* __restrict__ scratch, bf16* __restrict__ dq,
                   int Sq, int Skv, int H, int Hkv, int causal, int window,
                   float softcap, float scale) {
  using G = Geo<DQ, DV>;
  constexpr int RB = G::kRowBytes, BR = G::BR, BK = G::BKQ, NK = G::kColsK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;
  unsigned char* base = smem_raw + pad;
  const uint32_t sQ = raw + pad, sdO = sQ + BR * G::kRowQK;
  const uint32_t bar_full = sQ + G::kQBars;  // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * G::kStages;
  const uint32_t bar_q = bar_empty + 8 * G::kStages;
  int* red = reinterpret_cast<int*>(base + G::kQRed);
  const int nkt = (Skv + BK - 1) / BK;
  int* klo = reinterpret_cast<int*>(base + G::kQRanges);
  int* khi = klo + nkt;

  // grid (q heads x batch rows, q tiles): the last q tiles (the most key
  // tiles, when causal) of every head launch first
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {  // Q and dO at once; the ranges overlap them
    for (int st = 0; st < G::kStages; ++st) {
      sm90::mbar_init(bar_full + 8 * st, 1);
      sm90::mbar_init(bar_empty + 8 * st, 4 * NC);
    }
    sm90::mbar_init(bar_q, 1);
    sm90::fence_mbar_init();
    sm90::mbar_expect_tx(bar_q, BR * (G::kRowQK + G::kRowV));
#pragma unroll
    for (int i = 0; i < G::kBoxesQK; ++i)
      sm90::tma_load_4d(sQ + i * BR * RB, &tq, bar_q, i * G::kBoxCols, h,
                        q0, b);
#pragma unroll
    for (int i = 0; i < G::kBoxesV; ++i)
      sm90::tma_load_4d(sdO + i * BR * RB, &tdo, bar_q, i * G::kBoxCols, h,
                        q0, b);
  }
  row_ranges(q_pos + (size_t)b * Sq, q0, BR, Sq, red);
  tile_ranges<BK>(kv_pos + (size_t)b * Skv, Skv, klo, khi);
  __syncthreads();
  const int qlo = min(min(red[0], red[1]), min(red[2], red[3]));
  const int qhi = max(max(red[4], red[5]), max(red[6], red[7]));
  // key tile t is walked if a row of the CTA may attend to a key of it: not
  // wholly above the causal limit, nor wholly before the window (key
  // positions only from the least row's - window)
  auto walked = [&](int t) {
    return (!causal || klo[t] <= qhi) &&
           (!WIN || (long long)khi[t] > (long long)qlo - window);
  };

  if (warp == 4 * NC) {  // the producer warp: lane 0 issues every load
    if (lane == 0) {
      int i = 0;
      for (int t = 0; t < nkt; ++t) {
        if (!walked(t)) continue;
        const int st = i % G::kStages;
        if (i >= G::kStages)  // the stage's previous tile is consumed
          sm90::mbar_wait(bar_empty + 8 * st, (i / G::kStages - 1) & 1);
        const uint32_t dst = sQ + G::kQRing + st * G::kQStage;
        const uint32_t full = bar_full + 8 * st;
        sm90::mbar_expect_tx(full, G::kQTx);
#pragma unroll
        for (int bx = 0; bx < G::kBoxesQK; ++bx)
          sm90::tma_load_4d(dst + bx * BK * RB, &tk, full, bx * G::kBoxCols,
                            hk, t * BK, b);
#pragma unroll
        for (int bx = 0; bx < G::kBoxesV; ++bx)
          sm90::tma_load_4d(dst + BK * G::kRowQK + bx * BK * RB, &tv, full,
                            bx * G::kBoxCols, hk, t * BK, b);
        sm90::tma_load_4d(dst + BK * (G::kRowQK + G::kRowV), &tkp, full,
                          t * BK, b, 0, 0);
        ++i;
      }
    }
    return;
  }

  // ---- consumer cw (warps 4 cw..): q rows qi0 = qw0 + r0 and qi0 + 8;
  // at D = 256 both take the CTA's rows, and cw is the columns' half
  const int cw = warp / 4;
  const int rw = G::kHalves == 1 ? cw : 0, half = G::kHalves == 1 ? 0 : cw;
  const int r0 = 16 * (warp % 4) + lane / 4, c0 = 2 * (lane % 4);
  const int qw0 = q0 + 64 * rw, qi0 = qw0 + r0, qi1 = qi0 + 8;
  const bool qin0 = qi0 < Sq, qin1 = qi1 < Sq;
  const int qp0 = qin0 ? q_pos[(size_t)b * Sq + qi0] : 0;
  const int qp1 = qin1 ? q_pos[(size_t)b * Sq + qi1] : 0;
  const int Sqp = pad64(Sq);
  // this head's rows of the scratch: lse in log2 units, then Dl
  const float* lrow = scratch + ((size_t)b * H + h) * 3 * Sqp;
  const float l2_0 = qin0 ? lrow[qi0] : 0.f, l2_1 = qin1 ? lrow[qi1] : 0.f;
  const float dl0 = qin0 ? lrow[Sqp + qi0] : 0.f;
  const float dl1 = qin1 ? lrow[Sqp + qi1] : 0.f;
  // the position range of this consumer's rows (warps 2 rw, 2 rw + 1)
  const int wlo = min(red[2 * rw], red[2 * rw + 1]);
  const int whi = max(red[4 + 2 * rw], red[4 + 2 * rw + 1]);
  const bool wany = qw0 < Sq, wall = qw0 + 64 <= Sq;
  const float sl2e = scale * kLog2e;
  const float s_cap = softcap > 0.f ? scale / softcap : 0.f;
  const float cap_l2e = softcap * kLog2e;
  const uint32_t q_rows = sQ + 64 * rw * RB, do_rows = sdO + 64 * rw * RB;
  // the byte offset of the half's first box in a streamed K tile
  const uint32_t col_box = half * (NK / G::kBoxCols) * BK * RB;

  float acc[NK / 2];
#pragma unroll
  for (int i = 0; i < NK / 2; ++i) acc[i] = 0.f;

  sm90::mbar_wait(bar_q, 0);
  int i = 0;
  for (int t = 0; t < nkt; ++t) {
    if (!walked(t)) continue;
    const int st = i % G::kStages, k0 = t * BK;
    const bool skip =
        !wany || (causal && klo[t] > whi) ||
        (WIN && (long long)khi[t] <= (long long)wlo - window);
    const bool full =
        wall && k0 + BK <= Skv && (!causal || khi[t] <= wlo) &&
        (!WIN || (long long)klo[t] > (long long)whi - window);
    const uint32_t sK = sQ + G::kQRing + st * G::kQStage;
    const uint32_t sV = sK + BK * G::kRowQK;
    const int* kvp = reinterpret_cast<const int*>(
        base + G::kQRing + st * G::kQStage + BK * (G::kRowQK + G::kRowV));
    sm90::mbar_wait(bar_full + 8 * st, (i / G::kStages) & 1);

    if (!skip) {
      // S = Q K^T, dP = dO V^T
      float s[BK / 2], dp[BK / 2];
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) s[e] = dp[e] = 0.f;
      sm90::fence_regs(s);
      sm90::fence_regs(dp);
      sm90::wgmma_fence();
      ss_product<BK, DQ, G>(s, q_rows, BR * RB, sK, BK * RB);
      ss_product<BK, DV, G>(dp, do_rows, BR * RB, sV, BK * RB);
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);
      // dS = P (dP - Dl) (times the softcap's 1 - tanh^2), P = exp(S scale
      // - lse) (0 where masked; under a softcap exp(tanh(S scale / cap) cap
      // - lse)), for keys c = 8 j + c0 + e
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p0, p1, ch0 = 1.f, ch1 = 1.f;
          if constexpr (CAP) {
            const float t0 = tanhf(s[4 * j + e] * s_cap);
            const float t1 = tanhf(s[4 * j + 2 + e] * s_cap);
            p0 = ex2(fmaf(t0, cap_l2e, -l2_0));
            p1 = ex2(fmaf(t1, cap_l2e, -l2_1));
            ch0 = 1.f - t0 * t0;
            ch1 = 1.f - t1 * t1;
          } else {
            p0 = ex2(fmaf(s[4 * j + e], sl2e, -l2_0));
            p1 = ex2(fmaf(s[4 * j + 2 + e], sl2e, -l2_1));
          }
          if (!full) {
            const int c = 8 * j + c0 + e, kp = kvp[c];
            const bool kin = k0 + c < Skv;
            const bool w0 = !WIN || kp > qp0 - window;
            const bool w1 = !WIN || kp > qp1 - window;
            p0 = qin0 && kin && w0 && (!causal || kp <= qp0) ? p0 : 0.f;
            p1 = qin1 && kin && w1 && (!causal || kp <= qp1) ? p1 : 0.f;
          }
          dp[4 * j + e] = p0 * (dp[4 * j + e] - dl0) * ch0;
          dp[4 * j + 2 + e] = p1 * (dp[4 * j + 2 + e] - dl1) * ch1;
        }
      }

      // dQ += dS K: k steps of 16 keys, K MN-major (its 64-column boxes BK
      // rows apart; at D = 256 the half's two)
      uint32_t sh[BK / 16][4], sl[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) split(sh[kk], sl[kk], dp, kk);
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t bk = sm90::desc(sK + col_box + kk * 16 * RB, BK * RB,
                                       G::kAtom, G::kSwizzle);
        sm90::wgmma_rs<NK>(acc, sh[kk], bk, BK * RB);
        sm90::wgmma_rs<NK>(acc, sl[kk], bk, BK * RB);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(acc);
    }
    if (lane == 0) sm90::mbar_arrive(bar_empty + 8 * st);  // this warp is
    ++i;                                                    // done with it
  }

  // dQ (scaled once) in bf16 (the half's columns), rows past Sq not
  // written
#pragma unroll
  for (int j = 0; j < NK / 8; ++j) {
    const int col = half * NK + 8 * j + c0;
    if (qin0)
      store2(dq + (((size_t)b * Sq + qi0) * H + h) * DQ + col,
             acc[4 * j] * scale, acc[4 * j + 1] * scale);
    if (qin1)
      store2(dq + (((size_t)b * Sq + qi1) * H + h) * DQ + col,
             acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
  }
}

// The 4-D map {D, heads, rows, B} (innermost first) of a contiguous bf16
// tensor (B, rows, heads, D), read in boxes of {<=64, 1, box_rows, 1} with
// the 128-byte swizzle (64-byte at D = 32); rows past `rows` arrive as
// zeros.  TMA needs a 16-byte-aligned base; the wrapper checks it.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int D, int heads,
                     int rows, int B, int box_rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = sm90::map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(heads),
                              cuuint64_t(rows), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(D) * 2,
                                 cuuint64_t(heads) * D * 2,
                                 cuuint64_t(rows) * heads * D * 2};
  const cuuint32_t box[4] = {cuuint32_t(D < 64 ? D : 64), 1,
                             cuuint32_t(box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      D < 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The 4-D map of contiguous 32-bit words of extents `dims` (innermost
// first, the innermost a multiple of 64: the scratch's padded rows), read
// in boxes of {box0, box1, 1, 1} without swizzle.
cudaError_t make_map32(CUtensorMap* map, const void* ptr,
                       CUtensorMapDataType type, const int (&dims)[4],
                       int box0, int box1) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = sm90::map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t ext[4] = {cuuint64_t(dims[0]), cuuint64_t(dims[1]),
                             cuuint64_t(dims[2]), cuuint64_t(dims[3])};
  const cuuint64_t strides[3] = {ext[0] * 4, ext[0] * ext[1] * 4,
                                 ext[0] * ext[1] * ext[2] * 4};
  const cuuint32_t box[4] = {cuuint32_t(box0), cuuint32_t(box1), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, type, 4, const_cast<void*>(ptr), ext, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The dK/dV and dQ launches, after the preprocess has filled `scratch`.
template <int DQ, int DV>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v,
                   const int* q_pos, const int* kv_pos, const bf16* dout,
                   float* scratch, bf16* dq, bf16* dk, bf16* dv, int B,
                   int Sq, int Skv, int H, int Hkv, int causal, int window,
                   float softcap, float scale, cudaStream_t stream) {
  using G = Geo<DQ, DV>;
  constexpr int BR = G::BR, BK = G::BKQ;
  if (Sq > G::max_len() || Skv > G::max_len()) return cudaErrorInvalidValue;
  const int Sqp = pad64(Sq), Skvp = pad64(Skv);
  CUtensorMap tq, tdo, tk, tv, tld, tq2, tdo2, tk2, tv2, tkp;
  cudaError_t err = make_map(&tq, q, DQ, H, Sq, B, G::BN);
  if (err == cudaSuccess) err = make_map(&tdo, dout, DV, H, Sq, B, G::BN);
  if (err == cudaSuccess) err = make_map(&tk, k, DQ, Hkv, Skv, B, G::BKV);
  if (err == cudaSuccess) err = make_map(&tv, v, DV, Hkv, Skv, B, G::BKV);
  if (err == cudaSuccess)
    err = make_map32(&tld, scratch, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                     {Sqp, 3, H, B}, G::BN, 3);
  if (err == cudaSuccess) err = make_map(&tq2, q, DQ, H, Sq, B, BR);
  if (err == cudaSuccess) err = make_map(&tdo2, dout, DV, H, Sq, B, BR);
  if (err == cudaSuccess) err = make_map(&tk2, k, DQ, Hkv, Skv, B, BK);
  if (err == cudaSuccess) err = make_map(&tv2, v, DV, Hkv, Skv, B, BK);
  if (err == cudaSuccess)
    err = make_map32(&tkp, scratch + 3LL * B * H * Sqp,
                     CU_TENSOR_MAP_DATA_TYPE_INT32, {Skvp, B, 1, 1}, BK, 1);
  if (err != cudaSuccess) return err;

  const size_t smem_kv = G::smem_kv((Sq + G::BN - 1) / G::BN);
  const bool cap = softcap > 0.f, win = window > 0;
  auto kern_kv = cap ? (win ? &flash_bwd_dkdv_wgmma<DQ, DV, true, true>
                            : &flash_bwd_dkdv_wgmma<DQ, DV, true, false>)
                     : (win ? &flash_bwd_dkdv_wgmma<DQ, DV, false, true>
                            : &flash_bwd_dkdv_wgmma<DQ, DV, false, false>);
  err = rt::allow_smem(kern_kv, smem_kv);
  if (err != cudaSuccess) return err;
  kern_kv<<<dim3(Hkv * B, (Skv + G::BKV - 1) / G::BKV * G::kHalves), NT,
              smem_kv, stream>>>(
      tq, tdo, tk, tv, tld, q_pos, kv_pos, dk, dv, Sq, Skv, H, Hkv, causal,
      window, softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_q = G::smem_q((Skv + BK - 1) / BK);
  auto kern_q = cap ? (win ? &flash_bwd_dq_wgmma<DQ, DV, true, true>
                           : &flash_bwd_dq_wgmma<DQ, DV, true, false>)
                    : (win ? &flash_bwd_dq_wgmma<DQ, DV, false, true>
                           : &flash_bwd_dq_wgmma<DQ, DV, false, false>);
  err = rt::allow_smem(kern_q, smem_q);
  if (err != cudaSuccess) return err;
  kern_q<<<dim3(H * B, (Sq + BR - 1) / BR), NT, smem_q, stream>>>(
      tq2, tdo2, tk2, tv2, tkp, q_pos, kv_pos, scratch, dq, Sq, Skv, H, Hkv,
      causal, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace wg

template <typename T, int DQ, int DV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_pos, const int* kv_pos, const void* out,
                   const float* lse, const void* dout, void* dq, void* dk,
                   void* dv, float* Dl, int B, int Sq, int Skv, int H,
                   int Hkv, int causal, int window, float softcap,
                   float scale, cudaStream_t stream) {
  constexpr int DPQ = DQ + 1, DPV = DV + 1;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(out);
  const T* gt = static_cast<const T*>(dout);

  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const long long rows = (long long)B * H * pad64(Sq);
    const long long kvs = (long long)B * pad64(Skv);
    constexpr int RPB = NT / row_lanes(DV);  // rows a block
    const long long br = (rows + RPB - 1) / RPB, bk = (kvs + NT - 1) / NT;
    const long long blocks = br > bk ? br : bk;
    flash_bwd_preprocess<T, DV, true><<<dim3((unsigned)blocks, 2), NT, 0,
                                        stream>>>(ot, gt, lse, q_pos, kv_pos,
                                                  Dl, B, Sq, Skv, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return wg::launch<DQ, DV>(qt, kt, vt, q_pos, kv_pos, gt, Dl,
                         static_cast<T*>(dq), static_cast<T*>(dk),
                         static_cast<T*>(dv), B, Sq, Skv, H, Hkv, causal,
                         window, softcap, scale, stream);
  } else {
    const long long rows = (long long)B * Sq * H;
    constexpr int WB = NT / 32;  // rows (warps) a block
    flash_bwd_preprocess<T, DV, false><<<(unsigned)((rows + WB - 1) / WB),
                                         NT, 0, stream>>>(ot, gt, lse, q_pos,
                                                          kv_pos, Dl, B, Sq,
                                                          Skv, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    // q rows a dK/dV step and keys a dQ step: 64; 32 at D = 256, whose
    // 64-row tiles would pass the 227 KiB
    constexpr int QR = DQ == 256 ? 32 : BQ, KR = DQ == 256 ? 32 : BK;
    const size_t smem_kv = sizeof(float) * (BK * (DPQ + DPV) +
                                            QR * (DPQ + DPV) + 2 * QR * PS);
    auto kern_kv = flash_bwd_dkdv_simt<T, DQ, DV, QR>;
    err = rt::allow_smem(kern_kv, smem_kv);
    if (err != cudaSuccess) return err;
    kern_kv<<<dim3((Skv + BK - 1) / BK, Hkv, B), NT, smem_kv, stream>>>(
        qt, kt, vt, q_pos, kv_pos, lse, Dl, gt, static_cast<T*>(dk),
        static_cast<T*>(dv), Sq, Skv, H, Hkv, causal, window, softcap,
        scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    const size_t smem_q = sizeof(float) * (BQ * (DPQ + DPV) +
                                           KR * (DPQ + DPV) + BQ * (KR + 4));
    auto kern_q = flash_bwd_dq_simt<T, DQ, DV, KR>;
    err = rt::allow_smem(kern_q, smem_q);
    if (err != cudaSuccess) return err;
    kern_q<<<dim3((Sq + BQ - 1) / BQ, H, B), NT, smem_q, stream>>>(
        qt, kt, vt, q_pos, kv_pos, lse, Dl, gt, static_cast<T*>(dq), Sq,
        Skv, H, Hkv, causal, window, softcap, scale);
    return cudaGetLastError();
  }
}

// The instantiated (q/k, v) head dims; ops.py's HEAD_DIMS lists the same.
template <typename T>
cudaError_t dispatch(int D, int Dv, const void* q, const void* k, const void* v,
                     const int* q_pos, const int* kv_pos, const void* out,
                     const float* lse, const void* dout, void* dq, void* dk,
                     void* dv, float* Dl, int B, int Sq, int Skv, int H,
                     int Hkv, int causal, int window, float softcap,
                     float scale, cudaStream_t stream) {
#define REPRO_FLASH_BWD_CASE(A, AV)                                         \
  if (D == A && Dv == AV)                                                   \
    return launch<T, A, AV>(q, k, v, q_pos, kv_pos, out, lse, dout, dq, dk, \
                            dv, Dl, B, Sq, Skv, H, Hkv, causal, window,     \
                            softcap, scale, stream);
  REPRO_FLASH_BWD_CASE(32, 32)
  REPRO_FLASH_BWD_CASE(64, 64)
  REPRO_FLASH_BWD_CASE(80, 80)
  REPRO_FLASH_BWD_CASE(128, 128)
  REPRO_FLASH_BWD_CASE(192, 128)
  REPRO_FLASH_BWD_CASE(256, 256)
#undef REPRO_FLASH_BWD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// The most q rows (Sq) and keys (Skv) the bf16 route takes at q/k head dim
// D and v head dim Dv: its tile ranges, 8 bytes a tile, share each CTA's
// 227 KiB of shared memory with the tiles it keeps and its ring.  0 for a
// pair the kernel is not instantiated for.
extern "C" int repro_flash_bwd_max_len(int D, int Dv) {
  if (D == 32 && Dv == 32) return wg::Geo<32>::max_len();
  if (D == 64 && Dv == 64) return wg::Geo<64>::max_len();
  if (D == 80 && Dv == 80) return wg::Geo<80>::max_len();
  if (D == 128 && Dv == 128) return wg::Geo<128>::max_len();
  if (D == 192 && Dv == 128) return wg::Geo<192, 128>::max_len();
  if (D == 256 && Dv == 256) return wg::Geo<256>::max_len();
  return 0;
}

// Returns the CUDA error of the three launches (0 on success).  D is the
// head dim of q and k, Dv that of v (and of out and dout); window <= 0 and
// softcap <= 0 mean none.  Dl is fp32 scratch: B * Sq * H for fp32;
// 3 * B * H * Sqp + B * Skvp for bf16, Sqp and Skvp being Sq and Skv
// rounded up to a multiple of 64 (16-byte aligned, as TMA reads it).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* kv_pos, const void* out, const void* lse, const void* dout,
    void* dq, void* dk, void* dv, void* Dl, int B, int Sq, int Skv, int H,
    int Hkv, int D, int Dv, int causal, int window, float softcap,
    float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv != 0)
    return cudaErrorInvalidValue;
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  const float* ls = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(Dl);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32)
    return dispatch<float>(D, Dv, q, k, v, qp, kp, out, ls, dout, dq, dk, dv,
                           dl, B, Sq, Skv, H, Hkv, causal, window, softcap,
                           scale, s);
  if (dtype == rt::kBF16)
    return dispatch<__nv_bfloat16>(D, Dv, q, k, v, qp, kp, out, ls, dout, dq,
                                   dk, dv, dl, B, Sq, Skv, H, Hkv, causal,
                                   window, softcap, scale, s);
  return cudaErrorInvalidValue;
}
