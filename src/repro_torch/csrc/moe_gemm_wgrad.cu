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
// sizes.  Every route sums each output tile's k-tiles in one CTA, in the
// expert's block order: no split-K, no atomics, and two launches on the
// same inputs give equal bits.
//
// What bounds it on an H100: at Qwen3-30B-A3B's training shape (4 x 4096
// tokens, top-8 of 128 experts: ~131K kept rows, D 2048, expert F 768) a
// call is 2 x 131072 x 2048 x 768 = 412 GFLOP against ~1.2 GB of x, dy and
// dw: ~350 FLOP a byte, past the card's balance point, so the tensor
// cores' rate bounds it (~0.42 ms at 989 TFLOP/s), with the bytes close
// behind (~0.35 ms at 3.35 TB/s): the kernel must stream and multiply at
// close to full rate at once.
//
// Three routes, named by the wrapper (ops.py route()) and never swapped
// for one another here: a call the named route cannot take is refused.
//
// "wgmma" (bf16, block_t a multiple of 64, M and N multiples of 8, x, dy
// and dw 16-byte aligned: TMA's stride and alignment rules; every weight
// gradient of MoE training in bf16): output tiles of BM = 128 x BN = 256,
// run N fastest, then M, then experts, so a row strip of x is read from
// DRAM about once and an expert's dy (~1.5 MB) stays in L2.  One CTA an SM
// walks the tiles grid apart (a tile averages ~16 k-tiles at Qwen3's
// shape, so the next tile's loads fill the ring while this one's epilogue
// runs).  A producer warp walks each tile's expert's blocks, order[start[e]
// .. start[e + 1]), and issues TMA loads of 64-row k-tiles at row blk *
// block_t + off: x as 64 rows x 128 M-columns and dy as 64 rows x 256
// N-columns, in 64-column boxes with the 128-byte swizzle (elements past M
// or N arrive as zeros; a box wholly past them is not loaded), into a ring
// of 4 stages of 48 KB with full/empty mbarriers.  A = x^T and B = dy are
// both MN-major (rows of x hold M contiguous, rows of dy N), so two
// consumer warpgroups of 64 output rows each run wgmma m64n256k16 with
// both operands' transpose bits set, each A descriptor on its warpgroup's
// 64-column box of the x stage; they keep one k-tile's products in flight
// while the next is issued and release a stage once the products that
// read it are done.  The epilogue rounds the fp32 sums to bf16 and puts
// them by stmatrix into a half-tile buffer in shared memory, swizzled as
// TMA reads it, in two halves; TMA stores each through a 3-D map over dw
// (E, M, N): rows past M stay inside their expert and columns past N are
// not written.  An expert with no block runs no loads and stores a zero
// tile.  The producer's warpgroup gives its registers to the consumers
// (setmaxnreg), though ptxas holds each thread to 168 all the same: the
// 128 accumulators and the rest fit without spills.  Measured on an H100
// at Qwen3's shape against this kernel (PERF.md, launch/flash_ab.py on
// variant sources): per-thread stores of a whole-tile buffer with 3 stages
// spilled 196 bytes a thread (the epilogue's addresses) and ran 1.20-1.22x
// slower; from that base, 128 x 128 tiles (64 FLOP a byte of L2 reads
// against 85) 1.22-1.26x slower, one CTA a tile 1.07-1.14x, clusters of
// two CTAs multicasting dy 1.14-1.15x; this kernel with 3 stages
// 1.05-1.16x slower, with 32-row k-tiles 1.53-1.58x, with heaviest experts
// first (ranked in each CTA's prologue) 1.10-1.22x.
//
// "mma" (every other bf16 call: ragged widths, block_t 16) and "simt"
// (fp32) run the first version: one CTA of 256 threads per (expert, M
// tile, N tile) walks its expert's blocks in k-tiles of 32 rows.  The next
// k-tile's x and dy rows load into registers (16 bytes a thread where the
// rows are aligned) while the CTA multiplies the current ones in shared
// memory (two stages, one barrier a tile).  bf16: 128 x 128 output tiles
// on mma.sync m16n8k16 (fp32 accumulate); eight warps of 64 x 32 each;
// both operands are row-major in rows (M or N contiguous), which is
// K-major for neither, so the fragments come by ldmatrix.trans from rows
// padded by 16 bytes (conflict-free).  fp32: 64 x 64 tiles on the CUDA
// cores, 4 x 4 a thread.

#include <algorithm>
#include <climits>
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

// ---------------------------------------------------------------------------
// the wgmma route: bf16 on wgmma, x and dy k-tiles by TMA
// ---------------------------------------------------------------------------
namespace tc {

constexpr int BM = 128;     // output rows of a tile: two warpgroups of 64
constexpr int BN = 256;     // output columns of a tile: wgmma's N
static_assert(BN == 256, "the products are wgmma m64n256k16");
constexpr int BK = 64;      // rows of a k-tile
constexpr int STAGES = 4;   // ring stages
constexpr int NT = 3 * 128;  // two consumer warpgroups, then the producer's
constexpr uint32_t kBox = BK * 128;     // one BK-row, 64-column bf16 box
constexpr uint32_t kOutBox = 64 * 128;  // one 64 x 64 bf16 box of dw
constexpr int kHalfBoxes = BN / 128;    // a warpgroup's boxes of half a tile

// Shared-memory layout from a 1024-aligned base: per stage the x k-tile
// (BM / 64 boxes of 64 M-columns) then the dy k-tile (BN / 64 boxes of 64
// N-columns), each box BK rows of 128 bytes; half the bf16 output tile
// (each consumer warpgroup's kHalfBoxes boxes of 64 x 64); the full and
// empty barriers.
constexpr uint32_t kXBytes = BM / 64 * kBox;
constexpr uint32_t kStage = kXBytes + BN / 64 * kBox;
constexpr uint32_t kOut = STAGES * kStage;
constexpr uint32_t kBars = kOut + 2 * kHalfBoxes * kOutBox;
constexpr size_t kSmem = 1024 + kBars + 16 * STAGES;
static_assert(kSmem <= 232448, "past the shared memory a CTA may use");

// Tile t of the launch: N tiles fastest, then M tiles, then experts.
struct Tile {
  int n0, m0, e;
  __device__ __forceinline__ Tile(int t, int ntn, int ntm)
      : n0(t % ntn * BN), m0(t / ntn % ntm * BM), e(t / (ntn * ntm)) {}
};

__global__ void __launch_bounds__(NT, 1)
grouped_gemm_wgrad_wgmma(const __grid_constant__ CUtensorMap tx,
                         const __grid_constant__ CUtensorMap ty,
                         const __grid_constant__ CUtensorMap to,
                         const int* __restrict__ order,
                         const int* __restrict__ start, int M, int N, int E,
                         int block_t) {
  extern __shared__ unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ntn = (N + BN - 1) / BN, ntm = (M + BM - 1) / BM;
  const int tiles = ntn * ntm * E;
  const int tpb = block_t / BK;  // k-tiles a block
  const uint32_t base = (sm90::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t bar_full = base + kBars;  // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * STAGES;
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      sm90::mbar_init(bar_full + 8 * st, 1);   // the producer's arrival
      sm90::mbar_init(bar_empty + 8 * st, 8);  // every consumer warp
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup: one lane issues every load
    sm90::regs_dec<40>();
    if (warp == 8 && lane == 0) {
      int it = 0;  // k-tiles this CTA has loaded
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const Tile tile(t, ntn, ntm);
        const int first = start[tile.e];
        const int nk = (start[tile.e + 1] - first) * tpb;
        // boxes holding a column < M (x) or < N (dy); a box wholly past
        // them is not loaded
        const int xb = min(BM / 64, (M - tile.m0 + 63) / 64);
        const int yb = min(BN / 64, (N - tile.n0 + 63) / 64);
        const uint32_t bytes = (xb + yb) * kBox;
        int row0 = 0;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          if (kt % tpb == 0) row0 = order[first + kt / tpb] * block_t;
          const int row = row0 + kt % tpb * BK;
          const int st = it % STAGES;
          if (it >= STAGES)  // the stage's previous k-tile is consumed
            sm90::mbar_wait(bar_empty + 8 * st, (it / STAGES - 1) & 1);
          const uint32_t a = base + st * kStage, b = a + kXBytes;
          const uint32_t full = bar_full + 8 * st;
          sm90::mbar_expect_tx(full, bytes);
          for (int i = 0; i < xb; ++i)
            sm90::tma_load_4d(a + i * kBox, &tx, full, tile.m0 + 64 * i, row,
                              0, 0);
          for (int i = 0; i < yb; ++i)
            sm90::tma_load_4d(b + i * kBox, &ty, full, tile.n0 + 64 * i, row,
                              0, 0);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: rows [64 wg, 64 wg + 64) of each tile
  sm90::regs_inc<232>();
  const int wg = warp / 4;
  const uint32_t out = base + kOut + wg * kHalfBoxes * kOutBox;
  // stmatrix: lane l addresses row l % 8 (+ 8 for odd l / 8) of its warp's
  // 16 rows, in the column group of 8 named by l / 16 (of each pair)
  const int row = 16 * (warp % 4) + (lane / 8 % 2) * 8 + lane % 8;
  const uint32_t out_row = out + row * 128;
  const int q = lane / 16;
  float acc[BN / 2];
  int it = 0;  // k-tiles this CTA has consumed
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile tile(t, ntn, ntm);
    const int nk = (start[tile.e + 1] - start[tile.e]) * tpb;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int st = it % STAGES;
      const uint32_t a = base + st * kStage + wg * kBox;
      const uint32_t b = base + st * kStage + kXBytes;
      sm90::mbar_wait(bar_full + 8 * st, (it / STAGES) & 1);
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // 16 rows of K a step (two 8-row groups 1024 bytes apart); A is
        // this warpgroup's one 64-column box of x, B's 64-column boxes lie
        // kBox apart along N
        const uint64_t da = sm90::desc(a + kk * 2048, kBox, 1024,
                                       sm90::kSwizzle128);
        const uint64_t db = sm90::desc(b + kk * 2048, kBox, 1024,
                                       sm90::kSwizzle128);
        sm90::wgmma_ss_mnab_n256(acc, da, db);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // the previous k-tile's products are done
      sm90::fence_regs(acc);
      if (kt > 0 && lane == 0)
        sm90::mbar_arrive(bar_empty + 8 * ((it - 1) % STAGES));
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    if (nk > 0 && lane == 0)
      sm90::mbar_arrive(bar_empty + 8 * ((it - 1) % STAGES));

    // epilogue, in two halves of BN / 2 columns (a half-tile buffer leaves
    // room for a fourth stage): thread (warp w of the warpgroup, lane l)
    // holds rows 16 w + l / 4 and + 8, columns 8 j + 2 (l % 4) and + 1 for
    // j < BN / 8, each pair of column groups four 8 x 8 matrices that one
    // stmatrix puts in bf16 into this warpgroup's boxes of the buffer,
    // swizzled as TMA reads them, once the last stores have read it; one
    // TMA store a box sends them out
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (tid % 128 == 0) sm90::bulk_wait_read();
      sm90::named_barrier(1 + wg, 128);
#pragma unroll
      for (int jp = 0; jp < BN / 32; ++jp) {
        const int j = h * (BN / 16) + 2 * jp;  // its first column group
        const int g = 2 * jp + q;              // group in this half
        sm90::stmatrix_x4(
            out_row + g / 8 * kOutBox + (((g % 8) ^ (row & 7)) << 4),
            sm90::pack_bf16(acc[4 * j], acc[4 * j + 1]),
            sm90::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]),
            sm90::pack_bf16(acc[4 * j + 4], acc[4 * j + 5]),
            sm90::pack_bf16(acc[4 * j + 6], acc[4 * j + 7]));
      }
      sm90::fence_async_smem();
      sm90::named_barrier(1 + wg, 128);
      if (tid % 128 == 0) {
        if (tile.m0 + 64 * wg < M)
          for (int i = 0; i < kHalfBoxes; ++i) {
            const int n = tile.n0 + 64 * (h * kHalfBoxes + i);
            if (n < N)
              sm90::tma_store_4d(&to, out + i * kOutBox, n,
                                 tile.m0 + 64 * wg, tile.e, 0);
          }
        sm90::bulk_commit();
      }
    }
  }
  if (tid % 128 == 0) sm90::bulk_wait_read();
}

cudaError_t launch(const void* x, const void* dy, const int* order,
                   const int* start, void* dw, int T_rows, int M, int N,
                   int E, int block_t, cudaStream_t stream) {
  const long long tiles = (long long)E * ((M + BM - 1) / BM) *
                          ((N + BN - 1) / BN);
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  CUtensorMap tx, ty, to;
  cudaError_t err = sm90::map_bf16(&tx, x, M, T_rows, 1, BK);
  if (err == cudaSuccess) err = sm90::map_bf16(&ty, dy, N, T_rows, 1, BK);
  if (err == cudaSuccess) err = sm90::map_bf16(&to, dw, N, M, E, 64);
  if (err != cudaSuccess) return err;
  static const cudaError_t smem_ok =
      rt::allow_smem(grouped_gemm_wgrad_wgmma, kSmem);
  if (smem_ok != cudaSuccess) return smem_ok;
  int dev = 0, sms = 0;  // one CTA an SM, each walking tiles grid apart
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>(std::min<long long>(tiles, sms));
  grouped_gemm_wgrad_wgmma<<<grid, NT, kSmem, stream>>>(
      tx, ty, to, order, start, M, N, E, block_t);
  return cudaGetLastError();
}

}  // namespace tc

constexpr int kSimt = 0, kMma = 1, kWgmma = 2;  // the wrapper's route codes

}  // namespace

// dw (E, M, N) = per expert e, the sum over its blocks of x_b^T dy_b.  x (T,
// M), dy (T, N), T a multiple of block_t (a multiple of 16); order (nb,) and
// start (E + 1,) as the note at the head says.  vec_x / vec_y: x / dy start
// on a 16-byte boundary and M / N are multiples of 16 bytes' elements.
// `route` is the wrapper's choice: 0 simt (fp32), 1 mma (bf16), 2 wgmma
// (bf16 under TMA's rules, which vec_x and vec_y state with dw's
// alignment, and block_t a multiple of 64); a call the route cannot take is
// refused, never run on another route.  Returns the launch's CUDA error (0
// on success).
extern "C" int repro_grouped_gemm_wgrad(const void* x, const void* dy,
                                        const void* order, const void* start,
                                        void* dw, int T_rows, int M, int N,
                                        int E, int block_t, int vec_x,
                                        int vec_y, int dtype, int route,
                                        void* stream) {
  if (T_rows <= 0 || M <= 0 || N <= 0 || E <= 0 || block_t <= 0 ||
      block_t % 16 != 0 || T_rows % block_t != 0)
    return cudaErrorInvalidValue;
  const int* o = static_cast<const int*>(order);
  const int* s = static_cast<const int*>(start);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == kSimt && dtype == rt::kF32)
    return launch<float>(x, dy, o, s, dw, M, N, E, block_t, vec_x, vec_y,
                         st);
  if (route == kMma && dtype == rt::kBF16)
    return launch<__nv_bfloat16>(x, dy, o, s, dw, M, N, E, block_t, vec_x,
                                 vec_y, st);
  if (route == kWgmma && dtype == rt::kBF16 && vec_x && vec_y &&
      reinterpret_cast<uintptr_t>(dw) % 16 == 0 && block_t % 64 == 0)
    return tc::launch(x, dy, o, s, dw, T_rows, M, N, E, block_t, st);
  return cudaErrorInvalidValue;
}
