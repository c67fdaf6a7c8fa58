// Weight gradient of the grouped expert GEMM for Hopper (sm_90a).
//
// Replaces no TPU kernel: it is the dW half of the backward of
// csrc/moe_gemm.cu (the port's grouped_gemm, which replaces
// repro/kernels/moe_gemm/moe_gemm.py::grouped_gemm_tpu).  The reference
// trains its MoE through XLA's derivative of the dense einsum over the
// (E, C, D) capacity buffer (repro/models/moe.py::_expert_mlp); the port
// runs the kept choices sorted by expert through grouped_gemm, so its
// autograd node (kernels/moe_gemm/ops.py::GroupedGemmFn) needs, per expert,
// the sum of x_b^T dy_b over the expert's blocks b.  dX is the forward
// kernel on the expert-transposed weight; this kernel is dW.
//
// Contract: x (T, M) and dy (T, N), rows sorted by expert and padded per
// expert to block_t rows; block_expert (T / block_t,) int32 names each
// block's expert (-1: unused, skipped); order (nb,) int32 lists the blocks
// sorted by expert (stable: each expert's in block order) and start (E +
// 1,) int32 bounds expert e's as order[start[e] .. start[e + 1]) (the
// wrapper computes both on the device).  out dw (E, M, N) in x's type:
// dw[e] = sum over e's blocks of x_b^T dy_b, fp32 sums; an expert with no
// block gets zeros.  M and N may be ragged: tiles are masked at the true
// sizes.
//
// What bounds it on an H100: at Qwen3-30B-A3B's training shape (4 x 4096
// tokens, top-8 of 128 experts: ~131K kept rows, D 2048, expert F 768) a
// call is 2 x 131072 x 2048 x 768 = 412 GFLOP against ~0.5 GB of x, dy and
// dw: ~800 FLOP a byte, past the card's balance point, so the tensor
// cores' rate bounds it (~0.42 ms at 989 TFLOP/s).
//
// Design: one CTA of 256 threads per (expert, M tile, N tile).  It walks
// its expert's blocks in order, k-tiles of 32 rows each, so every sum runs
// in a fixed order and nothing is added across CTAs: no atomics, and two
// launches on the same inputs give equal bits.  The next k-tile's x and dy
// rows load into registers (16 bytes a thread where the rows are aligned)
// while the CTA multiplies the current ones in shared memory (two stages,
// one barrier a tile).  bf16: 128 x 128 output tiles on mma.sync m16n8k16
// (fp32 accumulate); eight warps of 64 x 32 each; both operands are
// row-major in rows (M or N contiguous), which is K-major for neither, so
// the fragments come by ldmatrix.trans from rows padded by 16 bytes
// (conflict-free).  fp32: 64 x 64 tiles on the CUDA cores, 4 x 4 a
// thread.  This is the simple first version: no TMA, no wgmma, no
// persistent CTAs (PERF.md has its time beside its bound).

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int NT = 256;  // threads: eight warps
constexpr int BK = 32;   // rows of a k-tile

template <typename T>
struct Tiles;
// bf16: 128 x 128 output tiles, rows padded by 8 elements (16 bytes)
template <>
struct Tiles<__nv_bfloat16> {
  static constexpr int BM = 128, BN = 128, PAD = 8;
};
// fp32: 64 x 64 output tiles, rows padded by 4 elements (16 bytes)
template <>
struct Tiles<float> {
  static constexpr int BM = 64, BN = 64, PAD = 4;
};

// A BK x COLS tile of a row-major matrix (leading dimension ld) held in
// registers between its load and its store to shared memory; rows at or
// past `rows` and columns at or past `col_lim` are zeros.
template <typename T, int COLS>
struct Stage {
  static constexpr int V = 16 / sizeof(T);  // elements of a 16-byte chunk
  static constexpr int CPR = COLS / V;      // chunks a row
  static constexpr int N = BK * CPR / NT;   // chunks a thread
  static_assert(BK * CPR % NT == 0, "whole chunks a thread");
  uint4 buf[N];

  __device__ __forceinline__ void fetch(const T* __restrict__ src, int ld,
                                        long long row0, int rows, int c0,
                                        int col_lim, bool vec) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int ch = threadIdx.x + j * NT;
      const int r = ch / CPR, c = c0 + (ch % CPR) * V;
      const T* p = src + (row0 + r) * ld + c;
      if (vec && r < rows && c + V <= col_lim) {
        buf[j] = __ldg(reinterpret_cast<const uint4*>(p));
      } else {
        T* e = reinterpret_cast<T*>(&buf[j]);
#pragma unroll
        for (int i = 0; i < V; ++i)
          e[i] = (r < rows && c + i < col_lim) ? p[i] : rt::from_f32<T>(0.f);
      }
    }
  }

  __device__ __forceinline__ void stash(T* dst, int stride) const {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int ch = threadIdx.x + j * NT;
      *reinterpret_cast<uint4*>(dst + (ch / CPR) * stride +
                                (ch % CPR) * V) = buf[j];
    }
  }
};

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&d)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(sm90::smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The products of one k-tile in shared memory, As (BK x SA: x's rows, M
// contiguous) and Bs (BK x SB: dy's rows, N contiguous), into this thread's
// accumulators.
template <typename T>
struct Product;

template <>
struct Product<__nv_bfloat16> {
  using P = Tiles<__nv_bfloat16>;
  static constexpr int SA = P::BM + P::PAD, SB = P::BN + P::PAD;
  // warp (wm, wn) of a 2 x 4 grid owns 64 rows x 32 columns: 4 m16 tiles x
  // 4 n8 tiles, c[mt][nt] in mma.sync's C layout
  float c[4][4][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) c[mt][nt][i] = 0.f;
  }

  __device__ __forceinline__ void run(const __nv_bfloat16* As,
                                      const __nv_bfloat16* Bs) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int m0 = (warp / 4) * 64, n0 = (warp % 4) * 32;
    const int r = lane % 8, j = lane / 8;  // lane's row of matrix j
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // A = x^T: matrix j of an m16 tile is rows k (8 more for j >= 2),
      // columns m (8 more for odd j) of As, transposed
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4_t(a[mt], As + (kk + (j >= 2 ? 8 : 0) + r) * SA + m0 +
                             mt * 16 + (j & 1 ? 8 : 0));
      // B = dy: matrix j of an n8 pair is rows k (8 more for odd j),
      // columns n (the pair's second n8 tile for j >= 2) of Bs, transposed
      uint32_t b[2][4];
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldsm_x4_t(b[np], Bs + (kk + (j & 1 ? 8 : 0) + r) * SB + n0 +
                             np * 16 + (j >= 2 ? 8 : 0));
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(c[mt][nt], a[mt], b[nt / 2][2 * (nt % 2)],
                   b[nt / 2][2 * (nt % 2) + 1]);
    }
  }

  __device__ __forceinline__ void store(__nv_bfloat16* __restrict__ out,
                                        int M, int N, int tm, int tn) const {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = tm + (warp / 4) * 64 + mt * 16 + g + 8 * h;
          const int n = tn + (warp % 4) * 32 + nt * 8 + 2 * t;
          if (m >= M) continue;
          __nv_bfloat16* o = out + (size_t)m * N + n;
          if (n + 1 < N && N % 2 == 0) {
            *reinterpret_cast<uint32_t*>(o) =
                sm90::pack_bf16(c[mt][nt][2 * h], c[mt][nt][2 * h + 1]);
          } else {
            if (n < N) o[0] = __float2bfloat16(c[mt][nt][2 * h]);
            if (n + 1 < N) o[1] = __float2bfloat16(c[mt][nt][2 * h + 1]);
          }
        }
  }
};

template <>
struct Product<float> {
  using P = Tiles<float>;
  static constexpr int SA = P::BM + P::PAD, SB = P::BN + P::PAD;
  // rows 4 ty + i, columns tx + 16 j
  float c[4][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
  }

  __device__ __forceinline__ void run(const float* As, const float* Bs) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(As + k * SA + 4 * ty);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float bv = Bs[k * SB + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) c[i][j] = fmaf(av[i], bv, c[i][j]);
      }
    }
  }

  __device__ __forceinline__ void store(float* __restrict__ out, int M, int N,
                                        int tm, int tn) const {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = tm + 4 * ty + i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tn + tx + 16 * j;
        if (n < N) out[(size_t)m * N + n] = c[i][j];
      }
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(NT)
grouped_gemm_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                          const int* __restrict__ order,
                          const int* __restrict__ start, T* __restrict__ dw,
                          int M, int N, int block_t, int vec_x, int vec_y) {
  using P = Tiles<T>;
  using Prod = Product<T>;
  constexpr int SA = Prod::SA, SB = Prod::SB;
  __shared__ __align__(16) unsigned char smem[2 * BK * (SA + SB) * sizeof(T)];
  T* As = reinterpret_cast<T*>(smem);  // [2][BK][SA]
  T* Bs = As + 2 * BK * SA;            // [2][BK][SB]
  const int tn = blockIdx.x * P::BN, tm = blockIdx.y * P::BM, e = blockIdx.z;
  const int first = start[e];
  const int tpb = (block_t + BK - 1) / BK;  // k-tiles a block
  const int ntiles = (start[e + 1] - first) * tpb;

  Stage<T, P::BM> xs;
  Stage<T, P::BN> ys;
  // k-tile i: rows [off, off + BK) of the expert's (i / tpb)-th block
  auto fetch = [&](int i) {
    const int blk = order[first + i / tpb], off = (i % tpb) * BK;
    const long long row0 = (long long)blk * block_t + off;
    const int rows = min(BK, block_t - off);
    xs.fetch(x, M, row0, rows, tm, M, vec_x != 0);
    ys.fetch(dy, N, row0, rows, tn, N, vec_y != 0);
  };
  Prod prod;
  prod.zero();
  if (ntiles > 0) {
    fetch(0);
    xs.stash(As, SA);
    ys.stash(Bs, SB);
    __syncthreads();
  }
  for (int i = 0; i < ntiles; ++i) {
    const int st = i % 2;
    if (i + 1 < ntiles) fetch(i + 1);  // in flight during the products
    prod.run(As + st * BK * SA, Bs + st * BK * SB);
    if (i + 1 < ntiles) {  // the other stage: last read before the barrier
      xs.stash(As + (1 - st) * BK * SA, SA);  // that ended tile i - 1
      ys.stash(Bs + (1 - st) * BK * SB, SB);
    }
    __syncthreads();
  }
  prod.store(dw + (size_t)e * M * N, M, N, tm, tn);
}

template <typename T>
cudaError_t launch(const void* x, const void* dy, const int* order,
                   const int* start, void* dw, int M, int N, int E,
                   int block_t, int vec_x, int vec_y, cudaStream_t stream) {
  using P = Tiles<T>;
  const dim3 grid((N + P::BN - 1) / P::BN, (M + P::BM - 1) / P::BM, E);
  grouped_gemm_wgrad_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), order, start,
      static_cast<T*>(dw), M, N, block_t, vec_x, vec_y);
  return cudaGetLastError();
}

}  // namespace

// dw (E, M, N) = per expert e, the sum over its blocks of x_b^T dy_b.  x (T,
// M), dy (T, N), T a multiple of block_t (a multiple of 16); order (nb,) and
// start (E + 1,) as the note at the head says.  vec_x / vec_y: x / dy start
// on a 16-byte boundary and M / N are multiples of 16 bytes' elements.
// Returns the launch's CUDA error (0 on success).
extern "C" int repro_grouped_gemm_wgrad(const void* x, const void* dy,
                                        const void* order, const void* start,
                                        void* dw, int T_rows, int M, int N,
                                        int E, int block_t, int vec_x,
                                        int vec_y, int dtype, void* stream) {
  if (T_rows <= 0 || M <= 0 || N <= 0 || E <= 0 || block_t <= 0 ||
      block_t % 16 != 0 || T_rows % block_t != 0)
    return cudaErrorInvalidValue;
  const int* o = static_cast<const int*>(order);
  const int* s = static_cast<const int*>(start);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32)
    return launch<float>(x, dy, o, s, dw, M, N, E, block_t, vec_x, vec_y,
                         st);
  if (dtype == rt::kBF16)
    return launch<__nv_bfloat16>(x, dy, o, s, dw, M, N, E, block_t, vec_x,
                                 vec_y, st);
  return cudaErrorInvalidValue;
}
