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
// What bounds it on an H100: bytes at decode and at the serving path's
// prefill.  At decode (8 tokens x top-8 of 128 experts, Qwen3-30B-A3B)
// about 50 experts receive a choice; each call must read their weights,
// ~50 x 2048 x 768 x 2 B = 157 MB, ~47 us at 3.35 TB/s, for ~1.6 GFLOP.
// At an 8 x 256 prefill all 128 experts are touched: 403 MB of weights,
// ~120 us, against ~52 us of bf16 tensor-core FLOPs.
//
// Design: one CTA of 128 threads per (block of BM rows, 64 output
// columns); BM is 64, 32 or 16, the largest that divides block_t.  The CTA
// reads its expert id from device memory (Hopper has no scalar prefetch);
// an unused block writes zeros and exits before touching a weight, so the
// ~130 empty blocks of a decode call cost one small store each.  The
// reduction over D runs in tiles of 64: each thread fetches its share of
// the next x and w tiles into registers (16-byte loads where the rows are
// aligned) while the CTA computes on the current tiles in shared memory,
// so every weight byte is read from device memory once per row block.
// bf16 runs on the tensor cores through mma.sync m16n8k16 (fp32
// accumulate); fp32 runs fp32 FMAs on the CUDA cores (no TF32, so fp32
// results hold to a plain fp32 matmul).  wgmma, TMA and a persistent
// schedule are later work.

#include <cstdint>
#include <type_traits>

#include "common.cuh"

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

}  // namespace

// Returns the CUDA error of the launch (0 on success).  vec_x / vec_w say
// that x / w may be read in 16-byte chunks (aligned base, row length a
// multiple of the chunk).
extern "C" int repro_grouped_gemm(const void* x, const void* w,
                                  const void* block_expert, void* out,
                                  int T_rows, int D, int F, int E,
                                  int block_t, int vec_x, int vec_w,
                                  int dtype, void* stream) {
  if (T_rows <= 0 || D <= 0 || F <= 0 || E <= 0 || block_t <= 0 ||
      block_t % 16 != 0 || T_rows % block_t != 0)
    return cudaErrorInvalidValue;
  const int* be = static_cast<const int*>(block_expert);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32)
    return dispatch<float>(x, w, be, out, T_rows, D, F, E, block_t, vec_x,
                           vec_w, s);
  if (dtype == rt::kBF16)
    return dispatch<__nv_bfloat16>(x, w, be, out, T_rows, D, F, E, block_t,
                                   vec_x, vec_w, s);
  return cudaErrorInvalidValue;
}
