// Decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attention/paged_attention.py
// ::paged_attention_tpu, under its contract: one query token per sequence,
// q (B, H, D), against K/V pools (num_pages, page, Hkv, D) reached through
// page_table (B, max_pages) int32, with lengths (B,) int32 valid positions
// per sequence (clamped to max_pages * page).  GQA: the G = H / Hkv query
// heads of a kv head share its keys.  Output (B, H, D) in the input type;
// all arithmetic in fp32.  The serving path passes its dense slot cache
// of one layer, (B, max_len, Hkv, D), as the pool view
// (B * max_len / page, page, Hkv, D) with the identity table, without a
// copy.
//
// What bounds it on an H100: bytes.  Each cached key and value is read
// once and used for G dot products, about 2 FLOP per byte, far below the
// card's ~295 FLOP/byte balance point; at B=8, L=1024, Hkv=8, D=64 in bf16
// the call reads 16.8 MB, ~5.0 us at 3.35 TB/s.
//
// Design: one CTA per (kv head, sequence), 256 threads, serving all G of
// its query heads, so each K/V element is read from device memory once.
// It streams 64-token tiles of the sequence's pages into shared memory
// (looking each token's page up in the table; nothing past the length is
// read) and runs an online softmax over them: scores for G x 64 pairs,
// then one warp per head updates the running max and sum, then every
// thread rescales and accumulates its (head, column) outputs in
// registers.  B * Hkv CTAs (64 at B=8 for Llama-3.2-1B) do not fill the
// 132 SMs; splitting a sequence's pages across CTAs with a combine pass
// (flash-decoding) is later work.

#include "common.cuh"

namespace {

constexpr int TK = 64;     // tokens per tile (two per lane of a warp)
constexpr int NT = 256;    // threads
constexpr int MAXG = 16;   // most query heads per kv head

template <typename T, int D>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int H, int Hkv, int page_size, int max_pages,
                    float scale) {
  constexpr int DP = D + 1;                      // padded K row stride
  constexpr int ACC = (MAXG * D + NT - 1) / NT;  // outputs per thread
  extern __shared__ float smem[];
  float* Ks = smem;               // TK x DP
  float* Vs = Ks + TK * DP;       // TK x D
  float* Qs = Vs + TK * D;        // G x D, pre-scaled
  float* Ss = Qs + MAXG * D;      // G x TK scores, then probabilities
  __shared__ float m_s[MAXG], l_s[MAXG], corr_s[MAXG];

  const int hk = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int G = H / Hkv;
  const int len = min(max(lengths[b], 0), max_pages * page_size);
  const int* table = page_table + (size_t)b * max_pages;

  for (int e = tid; e < G * D; e += NT)
    Qs[e] = rt::to_f32(q[((size_t)b * H + hk * G) * D + e]) * scale;
  if (tid < G) {
    m_s[tid] = rt::kNeg;
    l_s[tid] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int j = 0; j < ACC; ++j) acc[j] = 0.f;
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  for (int t0 = 0; t0 < len; t0 += TK) {
#pragma unroll 4
    for (int e = tid; e < TK * D; e += NT) {
      const int t = e / D, d = e % D, pos = t0 + t;
      float kx = 0.f, vx = 0.f;
      if (pos < len) {
        const int page = table[pos / page_size];
        const size_t off =
            (((size_t)page * page_size + pos % page_size) * Hkv + hk) * D + d;
        kx = rt::to_f32(k_pool[off]);
        vx = rt::to_f32(v_pool[off]);
      }
      Ks[t * DP + d] = kx;
      Vs[t * D + d] = vx;
    }
    __syncthreads();

    for (int e = tid; e < G * TK; e += NT) {
      const int g = e / TK, t = e % TK;
      float s = rt::kNeg;
      if (t0 + t < len) {
        s = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) s = fmaf(Qs[g * D + d], Ks[t * DP + d], s);
      }
      Ss[g * TK + t] = s;
    }
    __syncthreads();

    for (int g = warp; g < G; g += NT / 32) {
      const float a = Ss[g * TK + lane], c = Ss[g * TK + lane + 32];
      float mx = fmaxf(a, c);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float pa = expf(a - m_new), pc = expf(c - m_new);
      Ss[g * TK + lane] = pa;
      Ss[g * TK + lane + 32] = pc;
      float sum = pa + pc;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < ACC; ++j) {
      const int e = tid + j * NT;
      if (e < G * D) {
        const int g = e / D, d = e % D;
        float a = acc[j] * corr_s[g];
#pragma unroll 16
        for (int t = 0; t < TK; ++t) a = fmaf(Ss[g * TK + t], Vs[t * D + d], a);
        acc[j] = a;
      }
    }
    __syncthreads();   // the next tile overwrites Ks, Vs and Ss
  }

#pragma unroll
  for (int j = 0; j < ACC; ++j) {
    const int e = tid + j * NT;
    if (e < G * D) {
      const int g = e / D;
      out[((size_t)b * H + hk * G) * D + e] =
          rt::from_f32<T>(acc[j] / fmaxf(l_s[g], 1e-30f));
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* table, const int* lengths, void* out, int B,
                   int H, int Hkv, int page_size, int max_pages, float scale,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (TK * (D + 1) + TK * D + MAXG * D + MAXG * TK);
  auto kern = paged_decode_kernel<T, D>;
  cudaError_t err = rt::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hkv, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), table, lengths, static_cast<T*>(out), H,
      Hkv, page_size, max_pages, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k_pool,
                     const void* v_pool, const int* table, const int* lengths,
                     void* out, int B, int H, int Hkv, int page_size,
                     int max_pages, float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k_pool, v_pool, table, lengths, out, B, H, Hkv,
                           page_size, max_pages, scale, stream);
    case 64:
      return launch<T, 64>(q, k_pool, v_pool, table, lengths, out, B, H, Hkv,
                           page_size, max_pages, scale, stream);
    case 128:
      return launch<T, 128>(q, k_pool, v_pool, table, lengths, out, B, H,
                            Hkv, page_size, max_pages, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the CUDA error of the launch (0 on success).
extern "C" int repro_paged_attention_fwd(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* lengths, void* out, int B, int H,
    int Hkv, int D, int page_size, int max_pages, float scale, int dtype,
    void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > MAXG ||
      page_size <= 0 || max_pages <= 0)
    return cudaErrorInvalidValue;
  const int* tab = static_cast<const int*>(page_table);
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32)
    return dispatch<float>(D, q, k_pool, v_pool, tab, len, out, B, H, Hkv,
                           page_size, max_pages, scale, s);
  if (dtype == rt::kBF16)
    return dispatch<__nv_bfloat16>(D, q, k_pool, v_pool, tab, len, out, B, H,
                                   Hkv, page_size, max_pages, scale, s);
  return cudaErrorInvalidValue;
}
