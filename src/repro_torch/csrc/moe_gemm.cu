// Grouped expert GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/moe_gemm/moe_gemm.py
// ::grouped_gemm_tpu, under its contract: x (T, D) holds token rows sorted
// by expert and padded per expert to block_t rows; w (E, D, F) holds one
// weight per expert; block_expert (T / block_t,) int32 names the expert of
// each block of block_t rows.  out[i*bt:(i+1)*bt] = x[i*bt:(i+1)*bt] @
// w[block_expert[i]], accumulated in fp32 and stored in x's type (fp32 or
// bf16).  A block whose expert is outside [0, E) (the dispatch marks the
// unused trailing blocks with -1) gets zero rows and reads no weight.  D and
// F may be ragged: tiles are masked at the true sizes.
//
// What bounds it on an H100: bytes.  At decode (8 tokens x top-8 of 128
// experts, Qwen3-30B-A3B) about 50 experts receive a choice; a call must
// read their weights, ~50 x 2048 x 768 x 2 B = 157 MB, ~47 us at 3.35
// TB/s, for ~1.6 GFLOP.  At an 8 x 256 prefill (block_t 128, ~187 used
// blocks of 256) all 128 experts are touched: 403 MB of weights, ~98 MB of
// used x rows and 50 MB of output, ~165 us, against ~76 us of bf16
// tensor-core work on the padded rows.  So the prefill must stream every
// weight byte from DRAM about once while the tensor cores run at about
// half their peak.
//
// Three routes, named by the wrapper (ops.py route()) and never swapped
// for one another here: a call the named route cannot take is refused.
//
// "wgmma" (bf16, block_t a multiple of 64, D and F multiples of 8, 16-byte
// aligned bases: TMA's stride and alignment rules; every prefill launch
// of the serving path): one CTA per output tile of BM = 128 rows (64 when
// block_t is 64) by BN = 128 columns, one expert per tile, read from
// block_expert by the CTA.  A producer warp keeps TMA loads of the x tile
// (BM x 64, K-major) and the expert's w tile (64 x 128, N contiguous: an
// MN-major B operand, two 64-column boxes) in flight in a ring of 6
// stages (32 KB each at BM = 128) with full/empty mbarriers (128-byte
// swizzle; elements past D or F arrive as zeros, and a box wholly past F
// is not loaded).  One or two consumer warpgroups, 64 rows each, run
// wgmma m64n128k16 with both operands in shared memory, keep one k-tile's
// products in flight while the next is issued, and release a stage once
// the products that read it are done.  The epilogue rounds the fp32 sums
// to bf16 into an output tile in shared memory, swizzled as TMA reads it,
// and TMA stores it (columns past F are not written).  Tiles run in
// row-major order: a row block's column tiles run together, so its x is
// read from DRAM once, and so do the row blocks of one expert (the
// dispatch sorts them together), so its weight strips are read from DRAM
// about once.  An unused block's CTAs write zeros and exit.  No split-K
// and no atomics: two launches on the same inputs give equal bits.
// Measured on an H100 (PERF.md): stores from registers, 4 stages, groups
// of 8 row blocks, one persistent CTA an SM, 256-column tiles, and
// clusters of two CTAs that multicast each x tile were each slower at one
// prefill shape or both; 7 stages were no faster.
//
// "mma" (every other bf16 call; decode's block_t 16) and "simt" (fp32) run
// the first version of the kernel: one CTA of 128 threads per (block of BM
// rows, 64 output columns), BM the largest of 64, 32, 16 that divides
// block_t; an unused block writes zeros and exits before touching a
// weight.  The reduction over D runs in tiles of 64: each thread fetches
// its share of the next x and w tiles into registers (16-byte loads where
// the rows are aligned) while the CTA computes on the current tiles in
// shared memory.  bf16 runs on the tensor cores through mma.sync
// m16n8k16 (fp32 accumulate); fp32 runs fp32 FMAs on the CUDA cores (no
// TF32, so fp32 results hold to a plain fp32 matmul).  At decode the mma
// route is within 1.5x of its bound (PERF.md), and a tile of 64 rows
// would pad each touched expert's one or two rows fourfold.

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int NT = 128;  // threads: four warps
constexpr int BN = 64;   // output columns per CTA
constexpr int BK = 64;   // reduction depth of one shared-memory tile

template <typename T>
constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load

// shared tile row strides (elements), padded by one 16-byte chunk
template <typename T>
constexpr int kStride = BK + kVec<T>;
static_assert(BK == BN, "x and w tiles share one padded stride");

// A ROWS x COLS tile of a row-major matrix (leading dimension ld), held in
// registers between its fetch from device memory and its store to shared
// memory.  Elements at or past (row_lim, col_lim) are zero.
template <typename T, int ROWS, int COLS>
struct Tile {
  static constexpr int V = kVec<T>;
  static constexpr int CPR = COLS / V;  // 16-byte chunks per row
  static constexpr int N = ROWS * CPR / NT;
  static_assert(ROWS * CPR % NT == 0, "a tile is whole chunks per thread");
  uint4 buf[N];

  __device__ __forceinline__ void fetch(const T* __restrict__ src, int ld,
                                        int r0, int row_lim, int c0,
                                        int col_lim, bool vec) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int ch = threadIdx.x + j * NT;
      const int gr = r0 + ch / CPR, gc = c0 + (ch % CPR) * V;
      if (vec && gr < row_lim && gc + V <= col_lim) {
        buf[j] = __ldg(reinterpret_cast<const uint4*>(src + (size_t)gr * ld +
                                                      gc));
      } else {
        T* e = reinterpret_cast<T*>(&buf[j]);
#pragma unroll
        for (int i = 0; i < V; ++i)
          e[i] = (gr < row_lim && gc + i < col_lim)
                     ? src[(size_t)gr * ld + gc + i]
                     : rt::from_f32<T>(0.f);
      }
    }
  }

  __device__ __forceinline__ void stash(T* dst) const {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int ch = threadIdx.x + j * NT;
      *reinterpret_cast<uint4*>(dst + (ch / CPR) * kStride<T> +
                                (ch % CPR) * V) = buf[j];
    }
  }
};

__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Warp tiling of the bf16 path: WM warps along the BM rows (16 each), WN
// along the 64 columns, NSUB 8-column mma tiles per warp.
template <int BM>
struct WarpGrid {
  static constexpr int WM = BM / 16;
  static constexpr int WN = 4 / WM;
  static constexpr int COLS = BN / WN;
  static constexpr int NSUB = COLS / 8;
};

// The CTA's BM x 64 output tile: sum over D of the x rows times the
// expert's weight columns, then the store.  Xs/Ws hold the current tiles.
template <typename T, int BM>
__device__ __forceinline__ void mainloop(
    const T* __restrict__ x, const T* __restrict__ we, T* __restrict__ out,
    int row0, int n0, int T_rows, int D, int F, bool vec_x, bool vec_w,
    T* Xs, T* Ws) {
  constexpr int S = kStride<T>;
  Tile<T, BM, BK> xt;
  Tile<T, BK, BN> wt;
  xt.fetch(x, D, row0, T_rows, 0, D, vec_x);
  wt.fetch(we, F, 0, D, n0, F, vec_w);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if constexpr (std::is_same<T, float>::value) {
    // fp32: thread owns column c of rows r0, r0 + 2, ... (BM / 2 sums)
    const int c = tid % BN, r0 = tid / BN;
    float acc[BM / 2];
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
    for (int k0 = 0; k0 < D; k0 += BK) {
      xt.stash(Xs);
      wt.stash(Ws);
      __syncthreads();
      if (k0 + BK < D) {  // the next tiles load while this one computes
        xt.fetch(x, D, row0, T_rows, k0 + BK, D, vec_x);
        wt.fetch(we, F, k0 + BK, D, n0, F, vec_w);
      }
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        const float b = Ws[kk * S + c];
#pragma unroll
        for (int i = 0; i < BM / 2; ++i)
          acc[i] = fmaf(Xs[(r0 + 2 * i) * S + kk], b, acc[i]);
      }
      __syncthreads();
    }
    if (n0 + c < F) {
#pragma unroll
      for (int i = 0; i < BM / 2; ++i)
        out[(size_t)(row0 + r0 + 2 * i) * F + n0 + c] = acc[i];
    }
  } else {
    // bf16: mma.sync m16n8k16, fragments read from the shared tiles
    using G = WarpGrid<BM>;
    const int wm = warp / G::WN, wn = warp % G::WN;
    const int g = lane >> 2, t = lane & 3;
    const int rm = wm * 16, cn = wn * G::COLS;
    float acc[G::NSUB][4];
#pragma unroll
    for (int j = 0; j < G::NSUB; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    const uint16_t* Xb = reinterpret_cast<const uint16_t*>(Xs);
    const uint16_t* Wb = reinterpret_cast<const uint16_t*>(Ws);
    for (int k0 = 0; k0 < D; k0 += BK) {
      xt.stash(Xs);
      wt.stash(Ws);
      __syncthreads();
      if (k0 + BK < D) {
        xt.fetch(x, D, row0, T_rows, k0 + BK, D, vec_x);
        wt.fetch(we, F, k0 + BK, D, n0, F, vec_w);
      }
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        uint32_t a[4];
        const uint16_t* xa = Xb + (rm + g) * S + ks + 2 * t;
        a[0] = *reinterpret_cast<const uint32_t*>(xa);
        a[1] = *reinterpret_cast<const uint32_t*>(xa + 8 * S);
        a[2] = *reinterpret_cast<const uint32_t*>(xa + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(xa + 8 * S + 8);
#pragma unroll
        for (int j = 0; j < G::NSUB; ++j) {
          const uint16_t* wb = Wb + (ks + 2 * t) * S + cn + j * 8 + g;
          uint32_t b[2];
          b[0] = pack2(wb[0], wb[S]);
          b[1] = pack2(wb[8 * S], wb[9 * S]);
          mma_bf16(acc[j], a, b);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < G::NSUB; ++j) {
      const int col = n0 + cn + j * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        T* o = out + (size_t)(row0 + rm + g + 8 * h) * F + col;
        if (col < F) o[0] = rt::from_f32<T>(acc[j][2 * h]);
        if (col + 1 < F) o[1] = rt::from_f32<T>(acc[j][2 * h + 1]);
      }
    }
  }
}

template <typename T, int BM>
__global__ void __launch_bounds__(NT)
grouped_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const int* __restrict__ block_expert, T* __restrict__ out,
                    int T_rows, int D, int F, int E, int block_t, int vec_x,
                    int vec_w) {
  // raw bytes: a __shared__ array of a class type (bf16) needs no ctor
  __shared__ __align__(16) unsigned char smem[(BM + BK) * kStride<T> *
                                              sizeof(T)];
  T* Xs = reinterpret_cast<T*>(smem);
  T* Ws = Xs + BM * kStride<T>;
  const int row0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int e = block_expert[row0 / block_t];
  if (e < 0 || e >= E) {  // an unused block: zero rows, no weight read
    for (int i = threadIdx.x; i < BM * BN; i += NT) {
      const int c = n0 + i % BN;
      if (c < F) out[(size_t)(row0 + i / BN) * F + c] = rt::from_f32<T>(0.f);
    }
    return;
  }
  mainloop<T, BM>(x, w + (size_t)e * D * F, out, row0, n0, T_rows, D, F,
                  vec_x != 0, vec_w != 0, Xs, Ws);
}

template <typename T, int BM>
cudaError_t launch(const void* x, const void* w, const int* block_expert,
                   void* out, int T_rows, int D, int F, int E, int block_t,
                   int vec_x, int vec_w, cudaStream_t stream) {
  const dim3 grid(T_rows / BM, (F + BN - 1) / BN);
  grouped_gemm_kernel<T, BM><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), block_expert,
      static_cast<T*>(out), T_rows, D, F, E, block_t, vec_x, vec_w);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, const int* block_expert,
                     void* out, int T_rows, int D, int F, int E, int block_t,
                     int vec_x, int vec_w, cudaStream_t stream) {
  if (block_t % 64 == 0)
    return launch<T, 64>(x, w, block_expert, out, T_rows, D, F, E, block_t,
                         vec_x, vec_w, stream);
  if (block_t % 32 == 0)
    return launch<T, 32>(x, w, block_expert, out, T_rows, D, F, E, block_t,
                         vec_x, vec_w, stream);
  return launch<T, 16>(x, w, block_expert, out, T_rows, D, F, E, block_t,
                       vec_x, vec_w, stream);
}

// ---------------------------------------------------------------------------
// the wgmma route: bf16 on wgmma, x and w tiles by TMA
// ---------------------------------------------------------------------------
namespace tc {

constexpr int BN = 128;     // output columns per tile: wgmma's N
constexpr int BK = 64;      // reduction depth of a stage: 128-byte rows
constexpr int STAGES = 6;   // ring stages
constexpr int kBoxBytes = BK * 64 * 2;  // one 64 x 64 bf16 box of w

// Shared-memory layout of WG consumer warpgroups (BM = 64 WG rows): per
// stage the x tile (BM rows of 128 bytes), then w's BN / 64 boxes of 64
// columns; the bf16 output tile (64-row, 64-column boxes); then the full
// and empty barriers.  Offsets from a 1024-aligned base.
template <int WG>
struct Geo {
  static constexpr int BM = 64 * WG;
  static constexpr int NT = 128 * WG + 32;  // consumers, then the producer
  static constexpr uint32_t kABytes = BM * BK * 2;
  static constexpr uint32_t kStage = kABytes + BN / 64 * kBoxBytes;
  static constexpr uint32_t kOut = STAGES * kStage;  // the output tile
  static constexpr uint32_t kBars = kOut + BM * BN * 2;
  static constexpr size_t kSmem = 1024 + kBars + 16 * STAGES;
};

template <int WG>
__global__ void __launch_bounds__(Geo<WG>::NT, 1)
grouped_gemm_wgmma(const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap tw,
                   const __grid_constant__ CUtensorMap to,
                   const int* __restrict__ block_expert,
                   __nv_bfloat16* __restrict__ out, int T_rows, int D, int F,
                   int E, int block_t) {
  using G = Geo<WG>;
  constexpr int BM = G::BM;
  extern __shared__ unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // row-major tile order: a row block's column tiles run together (x is
  // read from DRAM once), and so do the consecutive row blocks of one
  // expert (its weight strips are read from DRAM about once)
  const int ntn = (F + BN - 1) / BN;
  const int row0 = blockIdx.x / ntn * BM, n0 = blockIdx.x % ntn * BN;
  const int e = block_expert[row0 / block_t];

  if (e < 0 || e >= E) {  // an unused block: zero rows, no weight read
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int c = tid; c < BM * (BN / 8); c += G::NT) {  // 16-byte chunks
      const int col = n0 + (c % (BN / 8)) * 8;
      if (col < F)
        *reinterpret_cast<uint4*>(out + (size_t)(row0 + c / (BN / 8)) * F +
                                  col) = zero;
    }
    return;
  }

  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bar_full = base + G::kBars;  // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * STAGES;
  const int nk = (D + BK - 1) / BK;
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      sm90::mbar_init(bar_full + 8 * st, 1);        // the producer's arrival
      sm90::mbar_init(bar_empty + 8 * st, 4 * WG);  // every consumer warp
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (warp == 4 * WG) {  // the producer warp: one lane issues every load
    if (lane == 0) {
      // boxes holding a column < F (a box wholly past F is not loaded)
      const int boxes = min(BN / 64, (F - n0 + 63) / 64);
      const uint32_t bytes = G::kABytes + boxes * kBoxBytes;
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % STAGES;
        if (kt >= STAGES)  // the stage's previous k-tile is consumed
          sm90::mbar_wait(bar_empty + 8 * st, (kt / STAGES - 1) & 1);
        const uint32_t a = base + st * G::kStage, b = a + G::kABytes;
        const uint32_t full = bar_full + 8 * st;
        sm90::mbar_expect_tx(full, bytes);
        sm90::tma_load_4d(a, &tx, full, kt * BK, row0, 0, 0);
        for (int i = 0; i < boxes; ++i)
          sm90::tma_load_4d(b + i * kBoxBytes, &tw, full, n0 + 64 * i,
                            kt * BK, e, 0);
      }
    }
    return;
  }

  // consumer warpgroup wg: rows [64 wg, 64 wg + 64) of the tile
  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % STAGES;
    const uint32_t a = base + st * G::kStage + wg * 64 * 128;
    const uint32_t b = base + st * G::kStage + G::kABytes;
    sm90::mbar_wait(bar_full + 8 * st, (kt / STAGES) & 1);
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A: 32 bytes of K a step inside the 128-byte swizzled rows, 8-row
      // groups 1024 bytes apart; B: 16 rows of K a step, its 64-column
      // boxes kBoxBytes apart along N
      const uint64_t da = sm90::desc(a + kk * 32, 16, 1024, sm90::kSwizzle128);
      const uint64_t db = sm90::desc(b + kk * 16 * 128, kBoxBytes, 1024,
                                     sm90::kSwizzle128);
      sm90::wgmma_ss_mnb_n128(acc, da, db);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();  // the previous k-tile's products are done
    sm90::fence_regs(acc);
    if (kt > 0 && lane == 0)
      sm90::mbar_arrive(bar_empty + 8 * ((kt - 1) % STAGES));
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);

  // epilogue: thread (warp w of the warpgroup, lane l) holds rows
  // 16 w + l / 4 and + 8, columns 8 j + 2 (l % 4) and + 1 for j < BN / 8;
  // they go in bf16 into this warpgroup's two 64 x 64 boxes of the output
  // tile in shared memory, swizzled as TMA reads them, and one TMA store
  // a box sends them out (columns past F are not written)
  const uint32_t boxes_out = base + G::kOut + wg * 2 * kBoxBytes;
  const int r0 = 16 * (warp % 4) + lane / 4;
  auto swz = [](uint32_t off) { return off ^ (((off >> 7) & 7u) << 4); };
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * (lane % 4);
    const uint32_t box = boxes_out + (c / 64) * kBoxBytes;
    const uint32_t cb = (c % 64) * 2;
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                     box + swz(r0 * 128 + cb)),
                 "r"(sm90::pack_bf16(acc[4 * j], acc[4 * j + 1]))
                 : "memory");
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                     box + swz((r0 + 8) * 128 + cb)),
                 "r"(sm90::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]))
                 : "memory");
  }
  sm90::fence_async_smem();
  sm90::named_barrier(1 + wg, 128);
  if (tid % 128 == 0) {
    for (int i = 0; i < BN / 64; ++i)
      if (n0 + 64 * i < F)
        sm90::tma_store_4d(&to, boxes_out + i * kBoxBytes, n0 + 64 * i,
                           row0 + 64 * wg, 0, 0);
    sm90::bulk_commit();
    sm90::bulk_wait_read();
  }
}

template <int WG>
cudaError_t launch(const void* x, const void* w, const int* block_expert,
                   void* out, int T_rows, int D, int F, int E, int block_t,
                   cudaStream_t stream) {
  using G = Geo<WG>;
  CUtensorMap tx, tw, to;
  cudaError_t err = sm90::map_bf16(&tx, x, D, T_rows, 1, G::BM);
  if (err == cudaSuccess) err = sm90::map_bf16(&tw, w, F, D, E, BK);
  if (err == cudaSuccess) err = sm90::map_bf16(&to, out, F, T_rows, 1, 64);
  if (err != cudaSuccess) return err;
  auto kern = grouped_gemm_wgmma<WG>;
  static const cudaError_t smem_ok = rt::allow_smem(kern, G::kSmem);
  if (smem_ok != cudaSuccess) return smem_ok;
  const int tiles = T_rows / G::BM * ((F + BN - 1) / BN);
  kern<<<tiles, G::NT, G::kSmem, stream>>>(
      tx, tw, to, block_expert, static_cast<__nv_bfloat16*>(out), T_rows, D,
      F, E, block_t);
  return cudaGetLastError();
}

}  // namespace tc

constexpr int kSimt = 0, kMma = 1, kWgmma = 2;  // the wrapper's route codes

}  // namespace

// Returns the CUDA error of the launch (0 on success).  vec_x / vec_w say
// that x / w may be read in 16-byte chunks (aligned base, row length a
// multiple of the chunk).  `route` is the wrapper's choice: 0 simt (fp32),
// 1 mma (bf16), 2 wgmma (bf16 under TMA's rules, which vec_x and vec_w
// state, and block_t a multiple of 64); a call the route cannot take is
// refused, never run on another route.
extern "C" int repro_grouped_gemm(const void* x, const void* w,
                                  const void* block_expert, void* out,
                                  int T_rows, int D, int F, int E,
                                  int block_t, int vec_x, int vec_w,
                                  int dtype, int route, void* stream) {
  if (T_rows <= 0 || D <= 0 || F <= 0 || E <= 0 || block_t <= 0 ||
      block_t % 16 != 0 || T_rows % block_t != 0)
    return cudaErrorInvalidValue;
  const int* be = static_cast<const int*>(block_expert);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kSimt && dtype == rt::kF32)
    return dispatch<float>(x, w, be, out, T_rows, D, F, E, block_t, vec_x,
                           vec_w, s);
  if (route == kMma && dtype == rt::kBF16)
    return dispatch<__nv_bfloat16>(x, w, be, out, T_rows, D, F, E, block_t,
                                   vec_x, vec_w, s);
  if (route == kWgmma && dtype == rt::kBF16 && vec_x && vec_w &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0 && block_t % 64 == 0) {
    if (block_t % 128 == 0)
      return tc::launch<2>(x, w, be, out, T_rows, D, F, E, block_t, s);
    return tc::launch<1>(x, w, be, out, T_rows, D, F, E, block_t, s);
  }
  return cudaErrorInvalidValue;
}
