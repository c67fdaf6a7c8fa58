// Prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py
// ::flash_attention_tpu, under the contract of repro/models/flash.py
// ::flash_attention that the serving path runs: q (B, Sq, H, DQK) against
// k (B, Skv, Hkv, DQK) and v (B, Skv, Hkv, DV) with explicit q/kv
// positions, causal and sliding-window masks, a tanh logit softcap, Sq !=
// Skv (the tail recompute after a prefix hit starts at an offset) and GQA
// (q head h reads kv head h / (H / Hkv)).  Output (B, Sq, H, DV) in the
// input type; the scale is 1/sqrt(DQK); softmax statistics and
// accumulators in fp32.  A masked score is the finite rt::kNeg, never
// -inf, as in the plain version.  The head dims are template parameters:
// (DQK, DV) = (32, 32), (64, 64), (80, 80) (H2O-Danube-1.8B), (128, 128),
// (192, 128), MLA's prefill (DeepSeek-R1: a 128-wide no-RoPE part and a
// 64-wide RoPE part in q and k, v 128 wide), and (256, 256)
// (RecurrentGemma-2B's local attention, one kv head for 10 q heads).
//
// What bounds it on an H100: at the serving path's prefill shape (B=4,
// S=512, H=32, D=64, causal, bf16) the work is ~4.3 GFLOP against ~21 MB
// of q/k/v/out, ~205 FLOP/byte, just under the card's ~295 FLOP/byte
// balance point: bytes bound it (~6.3 us at 3.35 TB/s), with the bf16
// tensor-core rate close behind (~4.3 us); longer prompts become
// operation-bound (the work grows with S^2, the bytes with S).
//
// Two routes, chosen by the storage type:
//
// bf16 (every served attention path) runs on the tensor cores.  One CTA
// of two warpgroups per (128-row q tile, q head, batch row); each
// warpgroup owns 64 q rows, wgmma's M.  Thread 0 starts the Q load by TMA
// at once.  A pre-pass reads the CTA's q positions and each 64-key tile's
// kv positions (all loads in flight together) and lists in shared memory
// the tiles some row may attend to: a tile is dropped only if it lies
// wholly above the causal limit, outside the window or past Skv for every
// row; the per-element mask stays exact.  The listed K/V tiles then
// arrive by TMA (4-D tensor maps built on the host for each call,
// 128-byte swizzle, 64-byte for D = 32; rows past Sq or Skv arrive as
// zeros and are masked by index) into a 4-stage ring, two tiles ahead of
// the one computed.  Warps 0 and 1 produce: thread 0 starts the TMA, and
// each writes one key's kv position (loaded an iteration earlier, so its
// latency hides behind a tile); a stage's "full" mbarrier counts the
// bytes and the 64 writers, its "empty" mbarrier the 8 warps that are
// done with it, so the two warpgroups run apart by up to two tiles.  Per
// tile and warpgroup: a tile none of its rows may attend to is skipped;
// S = Q K^T by wgmma m64n64k16 with both operands in shared memory
// (K-major: D is contiguous in a key row); the scale 1/sqrt(DQK) is applied
// to S in fp32, then the softcap, then the mask from the positions (a
// tile every row attends to in full, without softcap, skips the mask and
// folds the scale into the exponent's FMA), then the online softmax in
// the accumulator's registers (row max across the quad of lanes that
// share a row, exp2, rescale of O); P is rounded to bf16 and packed
// pairwise, which is already the register A operand of the next wgmma:
// O += P V by wgmma m64nDk16 with V from shared memory as an MN-major
// operand (D is contiguous in a key row and is this product's N).  The
// epilogue divides by the row sum and writes O in bf16 over the
// warpgroup's own rows of the Q tile, in the same swizzled layout, and
// one TMA store a box sends it out; rows past Sq are not written.  Causal
// launches walk the q tiles from the last, so the longest CTAs start
// first.  No atomics: two launches on the same inputs give equal bits.
// Tile sizes: 128 q rows share each K/V tile between two warpgroups
// (half the K/V traffic of 64-row CTAs); 64-key tiles keep S at 32
// registers a thread beside O's DV/2 (122 registers at D = 64, two CTAs an
// SM; 155 at D = 128, one).  At (192, 128) V keeps its own width: a stage
// is a 24 KiB K tile (three 64-column boxes, so S = Q K^T runs 12 k16
// steps) and a 16 KiB V tile, and the CTA's shared memory is the 48 KiB Q
// tile, a ring of 4 such stages (160 KiB) and the tile list; a V padded to
// 192 would leave the list almost no room.  O is written back over the
// first two of Q's three boxes.  At (80, 80) a row is two 64-column boxes
// over a tensor map of extent 80: the second box arrives zero-filled past
// column 80 and the TMA store drops O's columns past it, so nothing is
// padded in device memory; S = Q K^T runs 5 k16 steps, O += P V runs at
// N = 128 (1.6x the products of N = 80, but the 128-byte swizzle and the
// descriptor strides of every other pair; 16-column boxes would need a
// 32-byte swizzle and five TMA boxes a row).  At (256, 256) Q takes 64 KiB
// and a K + V stage 64 KiB, so the ring has 2 stages, loads one tile
// ahead (Geo::kStages), and O += P V is two N = 128 products over V's two
// halves (O is 128 fp32 registers a thread).  128-key tiles, a third ring
// stage or four stages with loads three tiles ahead, an O += P V of the
// previous tile started beside the next S (overlapping the softmax), and
// two CTAs an SM at D = 128 were each measured no faster on an H100
// (PERF.md).  No producer warp, no warp specialisation and no ping-pong
// between the warpgroups: those are the next steps.  The tile list takes
// 12 bytes of shared memory a 64-key tile, so D = 128 takes up to ~354K
// keys (~791K at D = 64, ~92K at (192, 128), ~182K at (256, 256)); past
// that the wrapper refuses the call (repro_flash_max_keys).
//
// fp32 runs the first version of this kernel, on the CUDA cores (wgmma
// takes no fp32 operands, and TF32 would keep ~3 digits): one CTA per
// (64-row q tile, q head, batch row), 256 threads; the q tile is loaded
// once (pre-scaled by 1/sqrt(DQK)); the CTA walks 64-key tiles of K and V
// through shared memory with an online softmax (running max m, sum l and
// the fp32 accumulator in registers: each thread owns 4 rows x 4 keys of
// the score tile and 4 rows x DV/16 output columns), and skips a tile no
// row of the CTA may attend to before its K/V are read.
//
// In both routes keys are masked at the true Skv: nothing is padded, so
// padding is never attended to.
//
// For training, the forward also writes each row's log-sum-exp when the
// caller passes an lse buffer (B, Sq, H) fp32 (null on the serving path,
// which then runs exactly as without it): m + log(max(l, 1e-30)) in
// natural-log units of the scaled (and softcapped) scores, as the plain
// version's return_lse.  The fp32 route keeps m in those units; the bf16
// route keeps it in log2 units with the scale folded in, so it writes
// m * ln 2 + log(l) (a row with no key to attend to keeps m = kNeg).  The
// backward, csrc/flash_attention_bwd.cu, recomputes P = exp(S - lse).

#include <climits>
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32: CUDA cores (the first version of this kernel, unchanged)
// ---------------------------------------------------------------------------
namespace simt {

constexpr int BQ = 64;       // query rows per CTA
constexpr int BK = 64;       // keys per K/V tile
constexpr int NT = 256;      // threads: 16 row groups x 16 lanes
constexpr int PS = BK + 4;   // row stride of the probability tile

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ q_pos,
                 const int* __restrict__ kv_pos, T* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Skv, int H, int Hkv,
                 int causal, int window, float softcap, float scale) {
  constexpr int DP = DQK + 1;  // padded row stride of the Q and K tiles
  constexpr int DC = DV / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;            // BQ x DP
  float* Ks = Qs + BQ * DP;    // BK x DP
  float* Vs = Ks + BK * DP;    // BK x DV
  float* Ps = Vs + BK * DV;    // BQ x PS

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  for (int e = tid; e < BQ * DQK; e += NT) {
    const int r = e / DQK, d = e % DQK, qi = q0 + r;
    float x = 0.f;
    if (qi < Sq)
      x = rt::to_f32(q[(((size_t)b * Sq + qi) * H + h) * DQK + d]) * scale;
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
    for (int e = tid; e < BK * DQK; e += NT) {
      const int c = e / DQK, d = e % DQK, kj = k0 + c;
      Ks[c * DP + d] =
          kj < Skv ? rt::to_f32(k[(((size_t)b * Skv + kj) * Hkv + hk) * DQK +
                                  d])
                   : 0.f;
    }
#pragma unroll 4
    for (int e = tid; e < BK * DV; e += NT) {
      const int c = e / DV, d = e % DV, kj = k0 + c;
      Vs[c * DV + d] =
          kj < Skv ? rt::to_f32(v[(((size_t)b * Skv + kj) * Hkv + hk) * DV +
                                  d])
                   : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < DQK; ++d) {
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
      for (int cc = 0; cc < DC; ++cc) w[cc] = Vs[c * DV + tx + 16 * cc];
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
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * Sq + qi) * H + h] = m[i] + logf(lsafe);
    T* o = out + (((size_t)b * Sq + qi) * H + h) * DV;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc)
      o[tx + 16 * cc] = rt::from_f32<T>(acc[i][cc] / lsafe);
  }
}

template <typename T, int DQK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_pos, const int* kv_pos, void* out,
                   float* lse, int B, int Sq, int Skv, int H, int Hkv,
                   int causal, int window, float softcap, float scale,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (BQ * (DQK + 1) + BK * (DQK + 1) + BK * DV + BQ * PS);
  auto kern = flash_fwd_kernel<T, DQK, DV>;
  cudaError_t err = rt::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, kv_pos, static_cast<T*>(out), lse, Sq,
      Skv, H, Hkv, causal, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), K/V by TMA
// ---------------------------------------------------------------------------
namespace tc {

constexpr int BQ = 128;  // query rows per CTA: two warpgroups of 64
constexpr int BK = 64;   // keys per K/V tile
constexpr int NT = 256;  // threads: two warpgroups
constexpr int NW = NT / 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr size_t kSmemLimit = 227 * 1024;  // the most a CTA may take

// Shared-memory geometry of a pair of head dims.  A TMA box is at most 64
// bf16 columns (128 bytes, the swizzle's width); a wider row takes several
// boxes a tile, stored one after the other: Q and K ceil(DQK / 64) of them,
// V ceil(DV / 64).  Both head dims share the box width, so one swizzle and
// one descriptor stride serve every tile.  A head dim that is not a
// multiple of the box (80) takes one more box, whose columns past the head
// dim arrive as zeros (the tensor map's extent is the head dim): S = Q K^T
// runs DQK / 16 k16 steps and never reads them; O += P V runs at the padded
// width kDVP (128 at DV = 80: wgmma's N over whole swizzle atoms), and the
// store drops O's columns past DV.
template <int DQK, int DV>
struct Geo {
  static constexpr int kBoxCols = DQK < 64 ? DQK : 64;
  static_assert((DV < 64 ? DV : 64) == kBoxCols && DV <= DQK &&
                    DQK % 16 == 0 && DV % 8 == 0,
                "head dims of one box width, DV <= DQK");
  static constexpr int kQKBoxes = (DQK + kBoxCols - 1) / kBoxCols;
  static constexpr int kVBoxes = (DV + kBoxCols - 1) / kBoxCols;
  static constexpr int kDVP = kVBoxes * kBoxCols;  // O's accumulator columns
  static constexpr int kRowBytes = kBoxCols * 2;
  static constexpr uint32_t kAtom = 8 * kRowBytes;  // 8 rows of a box
  static constexpr uint64_t kSwizzle =
      kBoxCols < 64 ? sm90::kSwizzle64 : sm90::kSwizzle128;
  static constexpr int kKSteps = kBoxCols / 16;     // k16 steps a box
  // O reuses Q's boxes
  static constexpr uint32_t kQBytes = BQ * kQKBoxes * kRowBytes;
  static constexpr uint32_t kKBytes = BK * kQKBoxes * kRowBytes;  // K tile
  static constexpr uint32_t kVBytes = BK * kVBoxes * kRowBytes;   // V tile
  static constexpr uint32_t kStageBytes = kKBytes + kVBytes;
  // the K/V ring: 4 stages, loads two tiles ahead of the one computed,
  // where Q and four stages leave the tile list 19 KiB or more of the 227;
  // else 2 stages, one tile ahead ((256, 256): Q 64 KiB, a stage 64 KiB)
  static constexpr int kStages =
      kQBytes + 4 * kStageBytes <= 208 * 1024 ? 4 : 2;
  static constexpr int kAhead = kStages / 2;
  // offsets from the 1024-aligned base: Q, then per stage K and V
  static constexpr uint32_t kKV = kQBytes;
  static constexpr uint32_t kBars = kKV + kStages * kStageBytes;
  // barriers: full[kStages], empty[kStages], q
  static constexpr uint32_t kKvPos = kBars + 8 * (2 * kStages + 1);
  static constexpr uint32_t kRed = kKvPos + kStages * BK * 4;  // int [2][NW]
  // int n, then per K/V tile: the list, the kv position min and max
  static constexpr uint32_t kList = kRed + 2 * NW * 4;
  static size_t smem_bytes(int ntiles) {
    return 1024 + kList + 4 * (1 + 3 * size_t(ntiles));
  }
  // the most keys whose tile list fits the CTA's shared memory
  static int max_keys() {
    return int((kSmemLimit - smem_bytes(0)) / 12) * BK;
  }
};

__device__ __forceinline__ float ex2(float x) {  // 2^x; -1e30 gives 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int DQK, int DV>
__global__ void __launch_bounds__(NT)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap to,
                const int* __restrict__ q_pos,
                const int* __restrict__ kv_pos, float* __restrict__ lse,
                int Sq, int Skv, int H, int Hkv, int causal, int window,
                float softcap, float scale) {
  using G = Geo<DQK, DV>;
  constexpr int STAGES = G::kStages, AHEAD = G::kAhead;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;
  unsigned char* base = smem_raw + pad;
  const uint32_t sQ = raw + pad;
  // a stage is full when its K/V bytes have landed and its kv positions
  // are written, empty when every warp is done with it
  const uint32_t bar_full = sQ + G::kBars;  // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * STAGES;
  const uint32_t bar_q = bar_empty + 8 * STAGES;
  int* kvp = reinterpret_cast<int*>(base + G::kKvPos);  // [STAGES][BK]
  int* red = reinterpret_cast<int*>(base + G::kRed);    // [2][NW]
  int* nlist = reinterpret_cast<int*>(base + G::kList);

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // last tile first
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ntiles = (Skv + BK - 1) / BK;
  int* tiles = nlist + 1;        // the list of tiles to load
  int* klo = tiles + ntiles;     // per tile: least and greatest kv position
  int* khi = klo + ntiles;

  // ---- thread 0 starts the Q load at once; the pre-pass overlaps it
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      sm90::mbar_init(bar_full + 8 * st, 1 + BK);  // TMA, BK position writers
      sm90::mbar_init(bar_empty + 8 * st, NW);
    }
    sm90::mbar_init(bar_q, 1);
    sm90::fence_mbar_init();
    sm90::mbar_expect_tx(bar_q, G::kQBytes);
#pragma unroll
    for (int i = 0; i < G::kQKBoxes; ++i)
      sm90::tma_load_4d(sQ + i * BQ * G::kRowBytes, &tq, bar_q,
                        i * G::kBoxCols, h, q0, b);
  }
  auto load_kv = [&](int t, int st) {
    const uint32_t k_dst = sQ + G::kKV + st * G::kStageBytes;
    const uint32_t v_dst = k_dst + G::kKBytes;
    sm90::mbar_expect_tx(bar_full + 8 * st, G::kStageBytes);
#pragma unroll
    for (int i = 0; i < G::kQKBoxes; ++i)
      sm90::tma_load_4d(k_dst + i * BK * G::kRowBytes, &tk, bar_full + 8 * st,
                        i * G::kBoxCols, hk, t * BK, b);
#pragma unroll
    for (int i = 0; i < G::kVBoxes; ++i)
      sm90::tma_load_4d(v_dst + i * BK * G::kRowBytes, &tv, bar_full + 8 * st,
                        i * G::kBoxCols, hk, t * BK, b);
  };
  // entry i of the tile list into stage i % STAGES, by threads < BK
  // (warps 0 and 1): thread 0 starts the TMA, each thread writes the kv
  // position of one key, loaded an iteration earlier, and arrives
  auto pos_of = [&](int i) {
    const int kj = tiles[i] * BK + tid;
    return kj < Skv ? kv_pos[(size_t)b * Skv + kj] : 0;
  };
  auto produce = [&](int i, int pos) {
    const int st = i % STAGES;
    if (i >= STAGES)  // the stage's previous tile is consumed
      sm90::mbar_wait(bar_empty + 8 * st, (i / STAGES - 1) & 1);
    if (tid == 0) load_kv(tiles[i], st);
    kvp[st * BK + tid] = pos;
    sm90::mbar_arrive(bar_full + 8 * st);
  };

  // ---- pre-pass: each K/V tile's kv position range and the q rows'
  // range (their loads in flight together), then the list of the tiles
  // some row of this CTA may attend to
  {
    int qlo = INT_MAX, qhi = INT_MIN;  // over this warp's 32 q rows
    if (tid < BQ && q0 + tid < Sq)
      qlo = qhi = q_pos[(size_t)b * Sq + q0 + tid];
    for (int t0 = warp; t0 < ntiles; t0 += 4 * NW) {  // 4 tiles a warp
      int lo[4], hi[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        lo[u] = INT_MAX;
        hi[u] = INT_MIN;
#pragma unroll
        for (int j = lane; j < BK; j += 32) {
          const int kj = (t0 + u * NW) * BK + j;
          if (t0 + u * NW < ntiles && kj < Skv) {
            const int p = kv_pos[(size_t)b * Skv + kj];
            lo[u] = min(lo[u], p);
            hi[u] = max(hi[u], p);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          lo[u] = min(lo[u], __shfl_xor_sync(0xffffffffu, lo[u], o));
          hi[u] = max(hi[u], __shfl_xor_sync(0xffffffffu, hi[u], o));
        }
        if (lane == 0 && t0 + u * NW < ntiles) {
          klo[t0 + u * NW] = lo[u];
          khi[t0 + u * NW] = hi[u];
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      qlo = min(qlo, __shfl_xor_sync(0xffffffffu, qlo, o));
      qhi = max(qhi, __shfl_xor_sync(0xffffffffu, qhi, o));
    }
    if (lane == 0) {
      red[warp] = qlo;
      red[NW + warp] = qhi;
    }
  }
  __syncthreads();
  if (warp == 0) {  // flag each tile and compact the flags into the list
    const int qmin = min(min(red[0], red[1]), min(red[2], red[3]));
    const int qmax =
        max(max(red[NW], red[NW + 1]), max(red[NW + 2], red[NW + 3]));
    int n = 0;
    for (int t0 = 0; t0 < ntiles; t0 += 32) {
      const int t = t0 + lane;
      const bool keep =
          t < ntiles && (!causal || klo[t] <= qmax) &&
          (window <= 0 || (long long)khi[t] > (long long)qmin - window);
      const unsigned m = __ballot_sync(0xffffffffu, keep);
      if (keep) tiles[n + __popc(m & ((1u << lane) - 1))] = t;
      n += __popc(m);
    }
    if (lane == 0) *nlist = n;
  }
  __syncthreads();
  const int n = *nlist;
  int pos_next = 0;  // threads < BK: for the next tile to produce
  if (tid < BK) {
    for (int i = 0; i < AHEAD && i < n; ++i) produce(i, pos_of(i));
    if (AHEAD < n) pos_next = pos_of(AHEAD);
  }

  // ---- this thread's rows: r and r + 8 of its warpgroup's 64
  const int wg = tid / 128, wl = (tid % 128) / 32;
  const int qi0 = q0 + 64 * wg + 16 * wl + lane / 4, qi1 = qi0 + 8;
  const bool qin0 = qi0 < Sq, qin1 = qi1 < Sq;
  const int qp0 = qin0 ? q_pos[(size_t)b * Sq + qi0] : 0;
  const int qp1 = qin1 ? q_pos[(size_t)b * Sq + qi1] : 0;
  // q position range of the warpgroup's rows (warps 2wg, 2wg + 1 above)
  const int wq_min = min(red[2 * wg], red[2 * wg + 1]);
  const int wq_max = max(red[NW + 2 * wg], red[NW + 2 * wg + 1]);
  const int c0 = 2 * (lane % 4);  // first of this thread's columns
  // scores to log2 units: s * s_mul, or tanh(s * s_mul) * cap_mul
  const float s_mul = softcap > 0.f ? scale / softcap : scale * kLog2e;
  const float cap_mul = softcap * kLog2e;

  float o[G::kDVP / 2];
#pragma unroll
  for (int i = 0; i < G::kDVP / 2; ++i) o[i] = 0.f;
  float m0 = rt::kNeg, m1 = rt::kNeg, l0 = 0.f, l1 = 0.f;  // m in log2 units
  const uint32_t q_rows = sQ + 64 * wg * G::kRowBytes;

  sm90::mbar_wait(bar_q, 0);
  for (int it = 0; it < n; ++it) {
    const int st = it % STAGES;
    if (tid < BK && it + AHEAD < n) {
      produce(it + AHEAD, pos_next);
      if (it + AHEAD + 1 < n) pos_next = pos_of(it + AHEAD + 1);
    }
    const int t = tiles[it], k0 = t * BK;
    // per warpgroup: no row may attend to the tile (skip it), or every
    // row may attend to every key (no per-element mask)
    const bool skip =
        wq_min == INT_MAX || (causal && klo[t] > wq_max) ||
        (window > 0 && (long long)khi[t] <= (long long)wq_min - window);
    const bool full =
        k0 + BK <= Skv && (!causal || khi[t] <= wq_min) &&
        (window <= 0 || (long long)klo[t] > (long long)wq_max - window);
    const uint32_t k_tile = sQ + G::kKV + st * G::kStageBytes;
    const uint32_t v_tile = k_tile + G::kKBytes;
    sm90::mbar_wait(bar_full + 8 * st, (it / STAGES) & 1);
    if (!skip) {
      // S = Q K^T
      float s[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
      sm90::fence_regs(s);
      sm90::wgmma_fence();
#pragma unroll
      for (int k = 0; k < DQK / 16; ++k) {
        const int box = k / G::kKSteps, col = (k % G::kKSteps) * 32;
        const uint64_t da =
            sm90::desc(q_rows + box * BQ * G::kRowBytes + col, 16, G::kAtom,
                       G::kSwizzle);
        const uint64_t db =
            sm90::desc(k_tile + box * BK * G::kRowBytes + col, 16, G::kAtom,
                       G::kSwizzle);
        sm90::wgmma_ss_n64(s, da, db, k);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(s);

      // this thread's share of the tile's row maxima, and the factor of s
      // in the exponent: raw scores times s_mul on an unmasked tile
      // without softcap, else scores already in log2 units
      float t0 = rt::kNeg, t1 = rt::kNeg, ce = 1.f;
      if (full && softcap <= 0.f) {
        ce = s_mul;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          t0 = fmaxf(t0, fmaxf(s[4 * j], s[4 * j + 1]));
          t1 = fmaxf(t1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
      } else {  // scale, softcap, mask
        const int* pos = kvp + st * BK;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + c0 + e;
            const int kp = pos[c];
            const bool kin = k0 + c < Skv;
            bool ok0 = qin0 && kin, ok1 = qin1 && kin;
            if (causal) {
              ok0 = ok0 && kp <= qp0;
              ok1 = ok1 && kp <= qp1;
            }
            if (window > 0) {
              ok0 = ok0 && kp > qp0 - window;
              ok1 = ok1 && kp > qp1 - window;
            }
            float x0 = s[4 * j + e] * s_mul, x1 = s[4 * j + 2 + e] * s_mul;
            if (softcap > 0.f) {
              x0 = tanhf(x0) * cap_mul;
              x1 = tanhf(x1) * cap_mul;
            }
            x0 = ok0 ? x0 : rt::kNeg;
            x1 = ok1 ? x1 : rt::kNeg;
            s[4 * j + e] = x0;
            s[4 * j + 2 + e] = x1;
            t0 = fmaxf(t0, x0);
            t1 = fmaxf(t1, x1);
          }
        }
      }
      // the four lanes of a quad hold one row's 64 columns between them
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, off));
        t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, off));
      }
      const float mx0 = fmaxf(m0, t0 * ce), mx1 = fmaxf(m1, t1 * ce);
      const float corr0 = ex2(m0 - mx0), corr1 = ex2(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * j + e] = ex2(fmaf(s[4 * j + e], ce, -m0));
          s[4 * j + 2 + e] = ex2(fmaf(s[4 * j + 2 + e], ce, -m1));
          sum0 += s[4 * j + e];
          sum1 += s[4 * j + 2 + e];
        }
      }
      l0 = l0 * corr0 + sum0;  // this thread's share; the quad sums last
      l1 = l1 * corr1 + sum1;
#pragma unroll
      for (int j = 0; j < G::kDVP / 8; ++j) {
        o[4 * j] *= corr0;
        o[4 * j + 1] *= corr0;
        o[4 * j + 2] *= corr1;
        o[4 * j + 3] *= corr1;
      }

      // O += P V, P from registers: the accumulator's columns
      // 16kk..16kk+15 are the A fragment of k step kk
      uint32_t a[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          a[kk][r] =
              sm90::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      }
      sm90::fence_regs(o);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv =
            sm90::desc(v_tile + kk * 16 * G::kRowBytes, BK * G::kRowBytes,
                       G::kAtom, G::kSwizzle);
        sm90::wgmma_rs<G::kDVP>(o, a[kk], dv, 2 * BK * G::kRowBytes);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(o);
    }
    if (lane == 0) sm90::mbar_arrive(bar_empty + 8 * st);  // this warp is
                                                          // done with it
  }

  // ---- epilogue: O / l in bf16 into this warpgroup's rows of the Q tile
  // (no longer read), in its swizzled layout, then one TMA store a box;
  // rows past Sq are not written
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  if (lse != nullptr && lane % 4 == 0) {  // m from log2 to natural units
    if (qin0)
      lse[((size_t)b * Sq + qi0) * H + h] =
          (m0 == rt::kNeg ? rt::kNeg : m0 * kLn2) + logf(d0);
    if (qin1)
      lse[((size_t)b * Sq + qi1) * H + h] =
          (m1 == rt::kNeg ? rt::kNeg : m1 * kLn2) + logf(d1);
  }
  const int r0 = 16 * wl + lane / 4;  // this thread's first row of the 64
  // 16-byte chunk c of a row moves to c ^ (row % 8) (128-byte swizzle) or
  // c ^ (row / 2 % 4) (64-byte): the bits 7.. of the offset into 4..
  auto swz = [](uint32_t off) {
    return off ^ (((off >> 7) & (G::kBoxCols < 64 ? 3u : 7u)) << 4);
  };
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    const int col = 8 * j + c0, box = col / G::kBoxCols;
    const uint32_t tile = q_rows + box * BQ * G::kRowBytes;
    const uint32_t cb = (col % G::kBoxCols) * 2;
    const uint32_t v0 = sm90::pack_bf16(o[4 * j] / d0, o[4 * j + 1] / d0);
    const uint32_t v1 = sm90::pack_bf16(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                     tile + swz(r0 * G::kRowBytes + cb)),
                 "r"(v0)
                 : "memory");
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                     tile + swz((r0 + 8) * G::kRowBytes + cb)),
                 "r"(v1)
                 : "memory");
  }
  sm90::fence_async_smem();
  sm90::named_barrier(1 + wg, 128);
  if (tid % 128 == 0 && q0 + 64 * wg < Sq) {
#pragma unroll
    for (int i = 0; i < G::kVBoxes; ++i)
      sm90::tma_store_4d(&to, q_rows + i * BQ * G::kRowBytes,
                         i * G::kBoxCols, h, q0 + 64 * wg, b);
    sm90::bulk_commit();
    sm90::bulk_wait_read();
  }
}

// The 4-D map {D, heads, rows, B} (innermost first) of a contiguous bf16
// tensor (B, rows, heads, D), read in boxes of {<=64, 1, box_rows, 1}.
// TMA needs a 16-byte-aligned base; the wrapper checks it.
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

template <int DQK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_pos, const int* kv_pos, void* out,
                   float* lse, int B, int Sq, int Skv, int H, int Hkv,
                   int causal, int window, float softcap, float scale,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  cudaError_t err = make_map(&tq, q, DQK, H, Sq, B, BQ);
  if (err == cudaSuccess) err = make_map(&tk, k, DQK, Hkv, Skv, B, BK);
  if (err == cudaSuccess) err = make_map(&tv, v, DV, Hkv, Skv, B, BK);
  if (err == cudaSuccess) err = make_map(&to, out, DV, H, Sq, B, 64);
  if (err != cudaSuccess) return err;
  const size_t smem = Geo<DQK, DV>::smem_bytes((Skv + BK - 1) / BK);
  auto kern = flash_fwd_wgmma<DQK, DV>;
  err = rt::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(tq, tk, tv, to, q_pos, kv_pos, lse, Sq,
                                   Skv, H, Hkv, causal, window, softcap,
                                   scale);
  return cudaGetLastError();
}

}  // namespace tc

// fp32 -> CUDA cores, bf16 -> tensor cores
template <typename T, int DQK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_pos, const int* kv_pos, void* out,
                   float* lse, int B, int Sq, int Skv, int H, int Hkv,
                   int causal, int window, float softcap, float scale,
                   cudaStream_t stream) {
  if constexpr (std::is_same_v<T, float>)
    return simt::launch<float, DQK, DV>(q, k, v, q_pos, kv_pos, out, lse, B,
                                        Sq, Skv, H, Hkv, causal, window,
                                        softcap, scale, stream);
  else
    return tc::launch<DQK, DV>(q, k, v, q_pos, kv_pos, out, lse, B, Sq, Skv,
                               H, Hkv, causal, window, softcap, scale,
                               stream);
}

// The instantiated (DQK, DV) pairs; ops.py's HEAD_DIMS lists the same.
template <typename T>
cudaError_t dispatch(int DQK, int DV, const void* q, const void* k,
                     const void* v, const int* q_pos, const int* kv_pos,
                     void* out, float* lse, int B, int Sq, int Skv, int H,
                     int Hkv, int causal, int window, float softcap,
                     float scale, cudaStream_t stream) {
#define REPRO_FLASH_CASE(A, C)                                              \
  if (DQK == A && DV == C)                                                  \
    return launch<T, A, C>(q, k, v, q_pos, kv_pos, out, lse, B, Sq, Skv, H, \
                           Hkv, causal, window, softcap, scale, stream);
  REPRO_FLASH_CASE(32, 32)
  REPRO_FLASH_CASE(64, 64)
  REPRO_FLASH_CASE(80, 80)
  REPRO_FLASH_CASE(128, 128)
  REPRO_FLASH_CASE(192, 128)
  REPRO_FLASH_CASE(256, 256)
#undef REPRO_FLASH_CASE
  return cudaErrorInvalidValue;
}

// The most keys the tensor-core route takes at a pair (Geo::max_keys).
int max_keys(int DQK, int DV) {
#define REPRO_FLASH_CASE(A, C) \
  if (DQK == A && DV == C) return tc::Geo<A, C>::max_keys();
  REPRO_FLASH_CASE(32, 32)
  REPRO_FLASH_CASE(64, 64)
  REPRO_FLASH_CASE(80, 80)
  REPRO_FLASH_CASE(128, 128)
  REPRO_FLASH_CASE(192, 128)
  REPRO_FLASH_CASE(256, 256)
#undef REPRO_FLASH_CASE
  return 0;
}

}  // namespace

// The most keys (Skv) the tensor-core route takes at head dims (DQK, DV):
// its tile list, 12 bytes a 64-key tile, shares the CTA's 227 KiB of
// shared memory with the Q tile and the K/V ring.  0 for a pair the kernel
// is not instantiated for.
extern "C" int repro_flash_max_keys(int DQK, int DV) {
  return max_keys(DQK, DV);
}

// Returns the CUDA error of the launch (0 on success).
// DQK is the head dim of q and k, DV that of v and out.  lse (B, Sq, H)
// fp32 receives each row's log-sum-exp, or is null (the serving path).
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* kv_pos, void* out, void* lse, int B, int Sq, int Skv, int H,
    int Hkv, int DQK, int DV, int causal, int window, float softcap,
    float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv != 0)
    return cudaErrorInvalidValue;
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  float* ls = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32)
    return dispatch<float>(DQK, DV, q, k, v, qp, kp, out, ls, B, Sq, Skv, H,
                           Hkv, causal, window, softcap, scale, s);
  if (dtype == rt::kBF16)
    return dispatch<__nv_bfloat16>(DQK, DV, q, k, v, qp, kp, out, ls, B, Sq,
                                   Skv, H, Hkv, causal, window, softcap,
                                   scale, s);
  return cudaErrorInvalidValue;
}
