// Decode attention for Hopper (sm_90a), split across a thread-block cluster.
//
// Replaces the TPU kernel repro/kernels/paged_attention/paged_attention.py
// ::paged_attention_tpu, under its contract: one query token per sequence,
// q (B, H, D), against K/V pools (num_pages, page, Hkv, D) reached through
// page_table (B, max_pages) int32, with lengths (B,) int32 valid positions
// per sequence (clamped to [0, max_pages * page]).  GQA: the G = H / Hkv
// <= 16 query heads of a kv head share its keys.  Output (B, H, D) in the
// input type; softmax statistics and sums in fp32.  A row of length 0
// reads nothing and gives zeros, as the TPU kernel does.  The serving path
// passes its dense slot cache of one layer, (B, max_len, Hkv, D), as the
// pool view (B * max_len / page, page, Hkv, D) with the identity table.
// With lse (B, H) fp32 given (not null), it also writes each (row, query
// head)'s natural-log log-sum-exp of its scaled scores over the first
// lengths positions, -1e30 for a row of length 0: the statistics a merge
// of sequence shards across ranks needs (models/layers.py::merge_shards).
//
// What bounds it on an H100: bytes.  Each cached key and value is read
// once and used for G dot products, about 2G FLOP per bf16 pair of bytes,
// far below the card's ~295 FLOP/byte balance point: at B8, lengths
// 256..1792 (8192 tokens), Hkv 8, D 64 in bf16 a call reads 16.8 MB,
// 5.0 us at 3.35 TB/s.  What held the first version back was latency: one
// CTA per (kv head, sequence), 64 CTAs on 132 SMs, each walking its whole
// row tile after tile with scalar loads and four CTA barriers a tile.
//
// Design.
// - Split: each (sequence b, kv head hk) is a cluster of C = 8 CTAs, grid
//   (C * Hkv, B), so 512 CTAs at Llama-3.2-1B's B8 H32/8 instead of 64.
//   The sequence's 64-token tiles, ntiles = ceil(len / 64), are shared out
//   in contiguous ranges: rank r takes tiles [r * ntiles / C,
//   (r + 1) * ntiles / C) (integer division), computed on the card from
//   lengths[b], so the host never reads a length.  A rank with no tile
//   keeps m = -1e30, l = 0, acc = 0.  C = 8 is the portable cluster
//   maximum; at the longest served row (1792 tokens, 28 tiles) it leaves
//   each rank 3-4 tiles.
// - Tiles: a tile's 64 tokens are four 16-token chunks, one per warp.  Each
//   warp keeps its own online-softmax state and its own ring of STAGES
//   chunk buffers (K and V in the input type, rows padded by 16 bytes so
//   that ldmatrix and the fp32 reads meet no bank conflict), filled by
//   16-byte cp.async.cg with the next STAGES - 1 chunks in flight while it
//   computes one: no CTA barrier in the loop, a __syncwarp a chunk.  The
//   rank's slice of the page-table row is read once into shared memory;
//   each lane then looks up one token row's page per chunk (a shift for a
//   power-of-two page, one division otherwise) and copies half that row.
//   STAGES is the most chunks (2..4) whose rings fit 40 KB a CTA: 4 at
//   bf16 D32, 2 elsewhere.  Deeper rings at D64 cost occupancy: with 4
//   stages (74 KB a CTA, three an SM) the 512 CTAs of the Llama shape do
//   not all fit at once, and the call was slower (PERF.md, section 6).
// - Products: bf16 runs QK^T and PV on mma.sync m16n8k16 (fp32 sums), the
//   G query rows of the kv head padded to 16, K fragments by ldmatrix and
//   V fragments by ldmatrix.trans, P passed from the score registers;
//   wgmma needs 64 rows and G <= 16 does not fill them.  fp32 runs on the
//   CUDA cores in the same register layout (TF32 would miss the 1e-4
//   tolerance).  The two routes share the loads and the merge.
// - Merge, inside the launch: the four warps' states merge in shared
//   memory in warp order into the CTA's (m, l, acc[G x D]).  Rank c owns
//   outputs [c * G * D / C, (c + 1) * G * D / C); each rank writes its
//   (m, l) and its part of every owner's slice of acc straight into the
//   owner's shared memory (distributed shared memory, through
//   cluster.map_shared_rank), then one cluster barrier (arrive.release,
//   wait.acquire), then each rank merges the C states of its slice in
//   rank order 0..C-1 from its own shared memory and writes them.  Nothing
//   remote is touched after that barrier, so no rank need wait for the
//   others to leave; a relaxed arrival at the top, waited for just before
//   the first remote write, makes sure every rank has started.  No
//   workspace in device memory, no atomics: two launches give equal bits.
//
// Registers (-Xptxas -v, CUDA 12.8, on an NVIDIA H100 80GB HBM3 at 700 W;
// no spills): bf16 64 / 96 / 152 at D 32 / 64 / 128, fp32 80 / 114 / 154.
// Shared memory (dynamic, from the layout below): the rings, 1.4 KB of
// weights and received (m, l), G * D * 4 bytes of received sums, the fp32
// route's Q, and 4 bytes a page-table entry of the longest rank range:
// 39.4 KB at bf16 D64 G4 over 2048 positions (five CTAs an SM by
// registers and shared memory alike: 660 slots for the Llama shape's 512
// CTAs), 75.2 KB at bf16 D128 G8 (three CTAs an SM).  The received sums
// are sized by G, not by 16, for that third CTA: at 84 KB two fit, and the
// 32 clusters of Qwen3-30B-A3B's decode (each on 8 SMs of one GPC) were
// not all resident at once.  Times and the variants tried: PERF.md
// section 6.

#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"
#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int C = 8;          // CTAs of a cluster: ranks sharing a sequence
constexpr int NW = 4;         // warps a CTA
constexpr int NT = NW * 32;   // threads a CTA
constexpr int CH = 16;        // tokens a warp's chunk (the k of m16n8k16)
constexpr int TK = CH * NW;   // tokens a tile: the unit of the rank split
constexpr int MAXG = 16;      // query rows of a kv head (the fragment's m)
constexpr int RING_BYTES = 40 * 1024;   // budget of the CTA's K/V rings
constexpr int SMEM_LIMIT = 227 * 1024;  // most shared memory a CTA may take

template <typename T, int D>
struct Geo {
  static constexpr int EPV = 16 / sizeof(T);   // elements a 16-byte vector
  static constexpr int VR = D / EPV;           // vectors a token row
  static constexpr int DP = D + EPV;           // padded K/V row (elements)
  static constexpr int CHUNK = 2 * CH * DP * sizeof(T);   // K + V, bytes
  static constexpr int FIT = RING_BYTES / (NW * CHUNK);
  static constexpr int STAGES = FIT < 2 ? 2 : (FIT > 4 ? 4 : FIT);
  static constexpr int WARP_RING = STAGES * CHUNK;
  static constexpr int AP = D + 8;             // padded row of a warp's acc
  static constexpr int QP = D + 4;             // padded fp32 Q row
  // a warp's state (acc[16][AP], m[16], l[16]) reuses its own ring
  static_assert((MAXG * AP + 2 * MAXG) * 4 <= WARP_RING, "state fits ring");
  static_assert(VR % 2 == 0, "two lanes share a token row");
  // byte offsets in dynamic shared memory: the warps' rings, then
  static constexpr int WSC = NW * WARP_RING;   // warp weights [NW][16],
                                               // the CTA's m[16], l[16]
  static constexpr int QS = WSC + (NW + 2) * MAXG * 4;  // fp32 Q [16][QP]
  // what the other ranks send: m[C][16], l[C][16], then acc[C][G * D / C]
  static constexpr int RECV = QS + (sizeof(T) == 4 ? MAXG * QP * 4 : 0);
  static constexpr int RECV_ACC = RECV + 2 * C * MAXG * 4;
  // then the page-table slice, at RECV_ACC + G * D * 4
  static size_t bytes(int G, long long table_entries) {
    return RECV_ACC + (size_t)G * D * 4 + (size_t)table_entries * 4;
  }
};

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

using sm90::cluster_arrive_relaxed;
using sm90::cluster_arrive_release;
using sm90::cluster_wait;
using sm90::cp_async16;
using sm90::cp_async_commit;
using sm90::cp_async_wait;

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr(p))
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Register layout of a warp's state, shared by both routes (the
// m16n8k16 accumulator's): lane (gid = lane / 4, tig = lane % 4) holds
// rows gid and gid + 8; s[nt][0..1] are row gid's scores of tokens
// nt * 8 + 2 * tig + {0, 1}, s[nt][2..3] row gid + 8's; acc[j][0..1] row
// gid's outputs at columns 8j + 2 tig + {0, 1}, acc[j][2..3] row gid + 8's.

// Scores of one chunk, bf16: S = Q K^T on the tensor cores.
template <int D>
__device__ __forceinline__ void scores_bf16(float (&s)[2][4],
                                            const uint32_t (&qa)[D / 16][4],
                                            const __nv_bfloat16* Ks,
                                            int lane) {
  constexpr int DP = Geo<__nv_bfloat16, D>::DP;
  const int m = lane >> 3, r = lane & 7;
  // matrices (tokens 0-7 | 8-15) x (d lo | hi): lane's row address
  const __nv_bfloat16* base = Ks + ((m >> 1) * 8 + r) * DP + (m & 1) * 8;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t b[4];
    ldsm_x4(b, base + kc * 16);
    mma_bf16(s[0], qa[kc], b[0], b[1]);
    mma_bf16(s[1], qa[kc], b[2], b[3]);
  }
}

// O += P V of one chunk, bf16, P from the score registers.
template <int D>
__device__ __forceinline__ void pv_bf16(float (&acc)[D / 8][4],
                                        const float (&p)[2][4],
                                        const __nv_bfloat16* Vs, int lane) {
  constexpr int DP = Geo<__nv_bfloat16, D>::DP;
  const uint32_t a[4] = {pack_bf16(p[0][0], p[0][1]),
                         pack_bf16(p[0][2], p[0][3]),
                         pack_bf16(p[1][0], p[1][1]),
                         pack_bf16(p[1][2], p[1][3])};
  const int m = lane >> 3, r = lane & 7;
  // matrices (tokens 0-7 | 8-15) x (columns of n-tile j | j + 1)
  const __nv_bfloat16* base = Vs + ((m & 1) * 8 + r) * DP + (m >> 1) * 8;
#pragma unroll
  for (int j = 0; j < D / 8; j += 2) {
    uint32_t b[4];
    ldsm_x4_t(b, base + j * 8);
    mma_bf16(acc[j], a, b[0], b[1]);
    mma_bf16(acc[j + 1], a, b[2], b[3]);
  }
}

// Scores of one chunk, fp32 on the CUDA cores, Q from shared memory.
template <int D>
__device__ __forceinline__ void scores_f32(float (&s)[2][4], const float* Qs,
                                           const float* Ks, int gid,
                                           int tig) {
  constexpr int DP = Geo<float, D>::DP, QP = Geo<float, D>::QP;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 q0 = *reinterpret_cast<const float4*>(Qs + gid * QP + d);
    const float4 q1 =
        *reinterpret_cast<const float4*>(Qs + (gid + 8) * QP + d);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 k = *reinterpret_cast<const float4*>(
            Ks + (nt * 8 + 2 * tig + e) * DP + d);
        s[nt][e] = fmaf(q0.x, k.x, fmaf(q0.y, k.y, fmaf(q0.z, k.z,
                   fmaf(q0.w, k.w, s[nt][e]))));
        s[nt][2 + e] = fmaf(q1.x, k.x, fmaf(q1.y, k.y, fmaf(q1.z, k.z,
                       fmaf(q1.w, k.w, s[nt][2 + e]))));
      }
  }
}

// O += P V of one chunk, fp32: each token's two probabilities of the
// lane's rows come from the lane of its quad that holds them.
template <int D>
__device__ __forceinline__ void pv_f32(float (&acc)[D / 8][4],
                                       const float (&p)[2][4], const float* Vs,
                                       int lane, int tig) {
  constexpr int DP = Geo<float, D>::DP;
#pragma unroll
  for (int t = 0; t < CH; ++t) {
    const int src = (lane & ~3) | ((t & 7) >> 1);
    const float p0 = __shfl_sync(0xffffffffu, p[t >> 3][t & 1], src);
    const float p1 = __shfl_sync(0xffffffffu, p[t >> 3][2 + (t & 1)], src);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float2 v =
          *reinterpret_cast<const float2*>(Vs + t * DP + j * 8 + 2 * tig);
      acc[j][0] = fmaf(p0, v.x, acc[j][0]);
      acc[j][1] = fmaf(p0, v.y, acc[j][1]);
      acc[j][2] = fmaf(p1, v.x, acc[j][2]);
      acc[j][3] = fmaf(p1, v.y, acc[j][3]);
    }
  }
}

template <typename T, int D>
__global__ void __cluster_dims__(C, 1, 1) __launch_bounds__(NT)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                   const T* __restrict__ v_pool,
                   const int* __restrict__ page_table,
                   const int* __restrict__ lengths, T* __restrict__ out,
                   float* __restrict__ lse, int H, int Hkv, int page,
                   int log2_page, int max_pages, float scale_log2) {
  using Gm = Geo<T, D>;
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int hk = blockIdx.x / C, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int G = H / Hkv;
  const int len = min(max(lengths[b], 0), max_pages * page);
  const int share = G * D / C;            // outputs this rank writes
  T* orow = out + ((size_t)b * H + (size_t)hk * G) * D + rank * share;

  if (len == 0) {   // the whole cluster alike: read nothing, write zeros
    for (int e = tid; e < share; e += NT) orow[e] = rt::from_f32<T>(0.f);
    if (lse != nullptr && rank == 0 && tid < G)
      lse[(size_t)b * H + hk * G + tid] = rt::kNeg;
    return;
  }

  // no rank writes into another's shared memory before all have started:
  // this arrival is waited for only after the loop, where it has long
  // completed
  cluster_arrive_relaxed();

  // this rank's tiles, and the slice of the page-table row they span
  const int ntiles = (len + TK - 1) / TK;
  const int t_lo = rank * ntiles / C, t_hi = (rank + 1) * ntiles / C;
  const int tok_lo = t_lo * TK, tok_hi = min(t_hi * TK, len);
  const int pg_lo = tok_lo / page;
  const int npg = tok_hi > tok_lo ? (tok_hi - 1) / page - pg_lo + 1 : 0;
  int* tab = reinterpret_cast<int*>(smem + Gm::RECV_ACC + G * D * 4);
  const int* trow = page_table + (size_t)b * max_pages + pg_lo;
  for (int i = tid; i < npg; i += NT) tab[i] = trow[i];
  const T* qrow = q + ((size_t)b * H + (size_t)hk * G) * D;
  float* Qs = reinterpret_cast<float*>(smem + Gm::QS);
  if constexpr (kF32) {
    for (int e = tid; e < MAXG * D; e += NT) {
      const int g = e / D, d = e % D;
      Qs[g * Gm::QP + d] = g < G ? qrow[e] : 0.f;
    }
  }
  uint32_t qa[D / 16][4];   // bf16: the Q fragments, rows past G zero
  if constexpr (!kF32) {
    const uint16_t* q16 = reinterpret_cast<const uint16_t*>(qrow);
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int g = gid + (i & 1) * 8, d = kc * 16 + (i >> 1) * 8 + 2 * tig;
        qa[kc][i] = g < G ? (uint32_t)q16[g * D + d] |
                                ((uint32_t)q16[g * D + d + 1] << 16)
                          : 0u;
      }
  }
  __syncthreads();

  // this warp's chunks: the w-th quarter of each of the rank's tiles, up
  // to the length (only the last tile can be partial)
  int nch = t_hi - t_lo;
  if (nch > 0 && (t_hi - 1) * TK + warp * CH >= len) --nch;
  T* ring = reinterpret_cast<T*>(smem + warp * Gm::WARP_RING);
  const int row = lane >> 1, half = lane & 1;

  auto issue = [&](int i) {   // chunk i into stage i % STAGES
    if (i < nch) {
      const int tok = (t_lo + i) * TK + warp * CH + row;
      T* kd = ring + (i % Gm::STAGES) * (2 * CH * Gm::DP) + row * Gm::DP;
      T* vd = kd + CH * Gm::DP;
      if (tok < len) {
        int pi, off;
        if (log2_page >= 0) {
          pi = (tok >> log2_page) - pg_lo;
          off = tok & (page - 1);
        } else {
          pi = tok / page;
          off = tok - pi * page;
          pi -= pg_lo;
        }
        const size_t src = (((size_t)tab[pi] * page + off) * Hkv + hk) * D;
#pragma unroll
        for (int j = 0; j < Gm::VR / 2; ++j) {
          const int c = (2 * j + half) * Gm::EPV;
          cp_async16(kd + c, k_pool + src + c);
          cp_async16(vd + c, v_pool + src + c);
        }
      } else {      // past the length: zeros, so that P = 0 meets no NaN
#pragma unroll
        for (int j = 0; j < Gm::VR / 2; ++j) {
          const int c = (2 * j + half) * Gm::EPV;
          *reinterpret_cast<uint4*>(kd + c) = make_uint4(0, 0, 0, 0);
          *reinterpret_cast<uint4*>(vd + c) = make_uint4(0, 0, 0, 0);
        }
      }
    }
    cp_async_commit();   // one group a chunk index, empty or not
  };

  float m[2] = {rt::kNeg, rt::kNeg}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

#pragma unroll
  for (int i = 0; i < Gm::STAGES - 1; ++i) issue(i);
  for (int i = 0; i < nch; ++i) {
    issue(i + Gm::STAGES - 1);
    cp_async_wait<Gm::STAGES - 1>();   // chunk i has landed (this lane's)
    __syncwarp();                      // ... and every lane's
    const T* Ks = ring + (i % Gm::STAGES) * (2 * CH * Gm::DP);
    const T* Vs = Ks + CH * Gm::DP;
    const int valid = len - ((t_lo + i) * TK + warp * CH);
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    if constexpr (kF32)
      scores_f32<D>(s, Qs, Ks, gid, tig);
    else
      scores_bf16<D>(s, qa, Ks, lane);

    float mx[2] = {rt::kNeg, rt::kNeg};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = nt * 8 + 2 * tig + e < valid;
        s[nt][e] = ok ? s[nt][e] * scale_log2 : rt::kNeg;
        s[nt][2 + e] = ok ? s[nt][2 + e] * scale_log2 : rt::kNeg;
        mx[0] = fmaxf(mx[0], s[nt][e]);
        mx[1] = fmaxf(mx[1], s[nt][2 + e]);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      corr[r] = exp2f(m[r] - mn);
      m[r] = mn;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - m[e >> 1]);
        sum[e >> 1] += s[nt][e];
      }
    l[0] = l[0] * corr[0] + sum[0];
    l[1] = l[1] * corr[1] + sum[1];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }
    if constexpr (kF32)
      pv_f32<D>(acc, s, Vs, lane, tig);
    else
      pv_bf16<D>(acc, s, Vs, lane);
    __syncwarp();   // every lane is done with this stage before its reuse
  }
  cp_async_wait<0>();
  __syncwarp();

  // the warp's state, in its own ring: acc[16][AP], then m[16], l[16]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* wacc = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<float2*>(wacc + gid * Gm::AP + j * 8 + 2 * tig) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(wacc + (gid + 8) * Gm::AP + j * 8 + 2 * tig) =
        make_float2(acc[j][2], acc[j][3]);
  }
  if (tig == 0) {
    wacc[MAXG * Gm::AP + gid] = m[0];
    wacc[MAXG * Gm::AP + gid + 8] = m[1];
    wacc[MAXG * Gm::AP + MAXG + gid] = l[0];
    wacc[MAXG * Gm::AP + MAXG + gid + 8] = l[1];
  }
  __syncthreads();

  // the CTA's state: the warps merged in warp order, sent straight to the
  // rank that owns each output (rank c owns outputs [c * share,
  // (c + 1) * share)) through distributed shared memory
  float* wsc = reinterpret_cast<float*>(smem + Gm::WSC);   // [NW][16]
  float* cm = wsc + NW * MAXG;
  float* cl = cm + MAXG;
  float* rm = reinterpret_cast<float*>(smem + Gm::RECV);   // [C][16]
  float* rl = rm + C * MAXG;                               // [C][16]
  float* racc = reinterpret_cast<float*>(smem + Gm::RECV_ACC);  // [C][share]
  auto wstate = [&](int w) {
    return reinterpret_cast<const float*>(smem + w * Gm::WARP_RING);
  };
  if (tid < G) {
    float M = rt::kNeg;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, wstate(w)[MAXG * Gm::AP + tid]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float* ws = wstate(w) + MAXG * Gm::AP;
      const float a = exp2f(ws[tid] - M);
      wsc[w * MAXG + tid] = a;
      L += a * ws[MAXG + tid];
    }
    cm[tid] = M;
    cl[tid] = L;
  }
  __syncthreads();
  cluster_wait();   // every rank has started
  if (tid < C * G) {  // this rank's (m, l) of row g, to rank c
    const int c = tid / G, g = tid % G;
    cluster.map_shared_rank(rm, c)[rank * MAXG + g] = cm[g];
    cluster.map_shared_rank(rl, c)[rank * MAXG + g] = cl[g];
  }
  for (int e = tid; e < G * D; e += NT) {
    const int g = e / D, d = e % D, c = e / share;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      a += wsc[w * MAXG + g] * wstate(w)[g * Gm::AP + d];
    cluster.map_shared_rank(racc, c)[rank * share + e - c * share] = a;
  }
  cluster_arrive_release();
  cluster_wait();   // every rank's states have arrived; nothing remote after

  // this rank's 1/C of the outputs: the C ranks merged in rank order
  for (int e = tid; e < share; e += NT) {
    const int g = (rank * share + e) / D;
    float M = rt::kNeg;
#pragma unroll
    for (int c = 0; c < C; ++c) M = fmaxf(M, rm[c * MAXG + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float a = exp2f(rm[c * MAXG + g] - M);
      L += a * rl[c * MAXG + g];
      A += a * racc[c * share + e];
    }
    orow[e] = rt::from_f32<T>(A / fmaxf(L, 1e-30f));
    // one writer a row: the rank and thread that hold its column 0;
    // M is in log2 units of the scaled scores
    if (lse != nullptr && (rank * share + e) % D == 0)
      lse[(size_t)b * H + hk * G + g] = (M + log2f(L)) * 0.6931471805599453f;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* table, const int* lengths, void* out, float* lse,
                   int B, int H, int Hkv, int page, int max_pages, float scale,
                   cudaStream_t stream) {
  using Gm = Geo<T, D>;
  // the page-table slice of the longest rank range: ceil(ntiles / C)
  // tiles of the longest row, over at most one page more than they fill
  const long long max_tok = (long long)max_pages * page;
  if (max_tok > (1ll << 30)) return cudaErrorInvalidValue;
  const long long ntiles = (max_tok + TK - 1) / TK;
  const long long rank_tok = (ntiles + C - 1) / C * TK;
  const long long cap = (rank_tok + page - 1) / page + 1;
  const size_t smem = Gm::bytes(H / Hkv, cap);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidConfiguration;
  auto kern = paged_split_kernel<T, D>;
  cudaError_t err = rt::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const int log2_page = (page & (page - 1)) == 0 ? __builtin_ctz(page) : -1;
  const dim3 grid(C * Hkv, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), table, lengths, static_cast<T*>(out), lse,
      H, Hkv, page, log2_page, max_pages, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k_pool,
                     const void* v_pool, const int* table, const int* lengths,
                     void* out, float* lse, int B, int H, int Hkv,
                     int page_size, int max_pages, float scale,
                     cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k_pool, v_pool, table, lengths, out, lse, B, H,
                           Hkv, page_size, max_pages, scale, stream);
    case 64:
      return launch<T, 64>(q, k_pool, v_pool, table, lengths, out, lse, B, H,
                           Hkv, page_size, max_pages, scale, stream);
    case 128:
      return launch<T, 128>(q, k_pool, v_pool, table, lengths, out, lse, B,
                            H, Hkv, page_size, max_pages, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the CUDA error of the launch (0 on success).  K/V pools must
// start on a 16-byte boundary (cp.async); the wrapper checks it.  lse, the
// last argument, is a (B, H) fp32 output or null (none written); a caller
// built against the entry without it passes one argument fewer.
extern "C" int repro_paged_attention_fwd(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* lengths, void* out, int B, int H,
    int Hkv, int D, int page_size, int max_pages, float scale, int dtype,
    void* stream, void* lse) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > MAXG ||
      page_size <= 0 || max_pages <= 0 ||
      reinterpret_cast<uintptr_t>(k_pool) % 16 ||
      reinterpret_cast<uintptr_t>(v_pool) % 16)
    return cudaErrorInvalidValue;
  const int* tab = static_cast<const int*>(page_table);
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ls = static_cast<float*>(lse);
  if (dtype == rt::kF32)
    return dispatch<float>(D, q, k_pool, v_pool, tab, len, out, ls, B, H, Hkv,
                           page_size, max_pages, scale, s);
  if (dtype == rt::kBF16)
    return dispatch<__nv_bfloat16>(D, q, k_pool, v_pool, tab, len, out, ls, B,
                                   H, Hkv, page_size, max_pages, scale, s);
  return cudaErrorInvalidValue;
}
