// Blocked online-softmax GQA attention forward (flash attention) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::flash_attention
// (_kernel): q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D], kv head = q head / (Hq / Hkv)
// with no KV repeat, static causal / window / q_offset, fully masked k-blocks
// skipped, fp32 running max / sum / accumulator, output in q's dtype.
//
// What it computes (the same recurrence as the TPU kernel and ref.mha_blocked_fwd):
//   s = (q * scale) k^T, masked to -1e30 where col >= Sk, (causal and col > row)
//   or (window > 0 and col <= row - window), with row = q index + q_offset;
//   m' = max(m, rowmax s); a = exp(m - m'); p = exp(s - m');
//   l = l a + rowsum p; acc = acc a + p v;  out = acc / max(l, 1e-30).
// -1e30 instead of -inf keeps exp(m - m') finite on rows masked so far.
//
// Bound on this card: operations.  Causal prefill at Sq = Sk = 2048, Hq 15,
// D 64 is ~8.05 GFLOP per call (~8.1 us at the 989 TFLOP/s bf16 tensor-core
// peak) against ~1 MB of q/k/v/o traffic (~0.3 us at 3.35 TB/s).
//
// Two kernels, chosen by dtype (explicit dispatch, not a fallback):
//
// bf16: tensor cores fed by TMA (flash_fwd_wgmma_kernel).  One block per
//   (b * Hq + h, 128-row q tile); the grid's x is the head, so the block
//   scheduler issues every head's heaviest causal tile first.  Warps 0-7 are
//   two consumer warpgroups of 64 q rows each; warp 8 is the producer, whose
//   lane 0 loads the q tile once and then k and v tiles of 128 keys through a
//   ring of kStages stages in shared memory, all with TMA (128-byte swizzle,
//   3-d maps over [B * H, S, D], so a tile past Sq or Sk is zero-filled and
//   never reads the next head) signalled on mbarriers.  A consumer
//   warpgroup computes S = Q K^T with wgmma m64n128k16 (both operands in
//   shared memory, fp32 accumulators in registers), masks only the tiles
//   that straddle the diagonal, the window edge or Sk, runs the online
//   softmax in registers in base 2 (scores times scale * log2(e), then ex2;
//   row max over the 4 lanes of a row with shuffles, row sums kept per
//   thread and reduced once at the end from the fp32 p), converts p to bf16
//   in place as the register A operand and accumulates O += P V with
//   wgmma m64nDk16 (V read MN-major through the transpose bit).  The
//   output is written from registers with a row guard for a ragged Sq.
//
// fp32: the SIMT kernel (flash_fwd_simt_kernel).  Tensor cores would take
//   fp32 through TF32 (10-bit mantissa), too coarse for the fp32 parity
//   checks.  One 256-thread block per (b * Hq + h, 64-row q tile), heaviest
//   causal tiles first; q (pre-scaled, transposed) and 64-key tiles of k and
//   v staged in shared memory; each thread owns a 4 x 4 patch of the score
//   tile and a 4 x (4 * D / 64) patch of the output; the 16 threads of a
//   row reduce max and sum with warp shuffles.
//
// Head dims 64, 128 and 256 (gemma-2b: MQA 8:1 at 256).  At 256 the bf16
//   kernel's K / V tiles hold 64 keys (128-key tiles in two stages would
//   take 256 KB beside the 64 KB q tile), and its producer is a warpgroup
//   that lends its registers to the consumers (setmaxnreg), whose O
//   accumulator of 64 x 256 fp32 alone is 128 registers a thread.  The
//   fp32 kernel takes 256 as it is (217 KB of shared memory, 64 output
//   columns a thread's row).
//
// Both mask the q and k edges that do not fill a tile inside the kernel;
// nothing is padded in memory.  They launch on the caller's stream and
// allocate nothing.  Given an ``lse`` pointer, both also write each row's
// natural-log log-sum-exp ``m + log(max(l, 1e-30))`` in fp32 (the reference's
// _mha_blocked_fwd_pass residual), which the backward reads; serving passes
// none.
//
// Backward (flash_attention_bwd; the reference has no Pallas backward: its
// rule is ref._mha_core_bwd, the VJP of the plain blocked forward).  P is
// recomputed from the saved lse, never stored whole:
//   delta = rowsum(dO * O);  P = exp(s scale - lse);  dV = P^T dO;
//   dS = P (dO V^T - delta) scale;  dK = dS^T Q;  dQ = dS K.
// Bound on this card: operations.  Five S x S x D products; causal at
// Sq = Sk = 4096, B 2, Hq 15, D 64 (the training call) that is ~161 GFLOP
// (163 us at the bf16 tensor-core peak).  Without atomics the kernels below
// compute seven (S and dP twice: once for dK / dV, once for dQ), a floor of
// ~228 us there.  Three kernels, none with atomics, so the result is the
// same bit for bit from run to run:
//   (a) delta: 16 bytes of O and dO a lane, several rows a warp, fp32;
//   (b) dK / dV: one block per (b, kv head, key tile), looping over the q
//       heads of its GQA group and the q tiles that can see the key tile; it
//       accumulates dK and dV in fp32 registers and writes them once, so the
//       group sum never leaves the block;
//   (c) dQ: one block per (b, q head, q tile), looping over the key tiles it
//       can see.
// Two forms of (b) and (c), chosen by dtype like the forward:
//   bf16 (namespace bwd_tc): wgmma fed by TMA, the forward's shape.  Warps
//     0-7 are two consumer warpgroups; warpgroup 2 is the producer, one
//     thread of which issues every copy (128-byte swizzle, zero fill past Sq
//     / Sk) through a 3-stage mbarrier ring, while the warpgroup hands its
//     registers to the consumers (setmaxnreg: 24 a thread for it, 240 for
//     them).  (b): 128 keys a block, 64 per warpgroup; K and V stay
//     resident; the producer streams one (q head, q tile) pair after another
//     over the whole group: Q, dO and the tile's lse and delta (1-d maps).
//     A warpgroup computes S^T = K Q^T (wgmma, both operands K-major), so P^T
//     leaves the accumulators already as the register A operand of
//     dV += P^T dO, issued together with dP^T = V dO^T; then
//     dS^T = P^T (dP^T - delta) scale feeds dK += dS^T Q the same way.  The
//     same Q and dO tiles are read MN-major for those (the transpose bit): no
//     transposed copy.  q tiles are 128 rows at D 64, 32 at D 128, where the
//     dK and dV accumulators take 64 registers each.  Key block 0, which a
//     causal mask shows every q tile, starts first.  (c): 128 q rows a
//     block, 64 per warpgroup, Q and dO resident, K and V streamed in tiles
//     of 128 keys (64 at D 128); S = Q K^T and dP = dO V^T as two groups,
//     then dQ += dS K with K read MN-major; heaviest causal tiles first.
//     Only the tiles that straddle a mask edge, Sq or Sk are masked, after
//     the exponentials (no branch among them); a tile a warpgroup cannot see
//     at all is skipped.  P and dS are rounded to bf16 for their products,
//     as the forward rounds P; the dK / dV kernel forms dS^T from that bf16
//     P^T too (registers).  A tile's products are issued and awaited inside
//     one branch: ptxas serialises wgmma whose groups span two.
//   fp32 (namespace bwd): SIMT, because tensor cores would take fp32 through
//     TF32; a 256-thread block gives each thread a 4 x 4 patch of the 64 x 64
//     score tile (row-major Q / dO against transposed K / V in shared memory,
//     16-byte reads) and a 4 x (4 D / 64) patch of the tile it accumulates.
//   At head_dim 256 the bf16 kernels are a design of their own (namespace
//     bwd_tc::d256): a dK / dV block holds 64 keys, one consumer warpgroup
//     computes S^T, P^T and dV, the other dP^T, dS^T (from the bf16 P^T the
//     first leaves in shared memory) and dK, so each score product is
//     computed once; the dQ kernel takes 128 q rows a block with 64-key
//     tiles; seven S x S x D products, as at D 64.  The dK / dV grid pairs
//     causal key blocks j and n - 1 - j and splits a kv head's q-head group
//     into slices, whose fp32 partials a fourth kernel adds in slice order.
//     The fp32 kernels stage D in chunks of 64 columns
//     (a [D][68] K^T beside a [64][D + 4] Q no longer fits): S and dP sum
//     over the chunks, each output chunk is a further pass, and dK / dV
//     split their columns between two blocks.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// floor(a / b) for b > 0
__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// ---------------------------------------------------------------------------
// fp32: SIMT
// ---------------------------------------------------------------------------

namespace simt {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per k tile
constexpr int kThreads = 256;  // 16 x 16 threads, each a 4 x 4 patch
constexpr int kPad = 4;        // keeps float4 rows aligned, spreads banks

template <int D>
struct Smem {
  static constexpr int kQT = D * (kBQ + kPad);  // q^T  [D][BQ + pad]
  static constexpr int kKT = D * (kBK + kPad);  // k^T  [D][BK + pad]
  static constexpr int kV = kBK * D;            // v    [BK][D]
  static constexpr int kPT = kBK * (kBQ + kPad);  // p^T [BK][BQ + pad]
  static constexpr size_t kBytes = sizeof(float) * (kQT + kKT + kV + kPT);
  static_assert(kBytes <= 232448, "a block takes at most 227 KB of shared memory");
};

// Stage `rows_valid` rows of a [rows, D] tile from global memory into shared
// memory, either transposed ([D][ld]) or row-major ([rows][D]); rows past the
// valid edge are zero-filled.
template <int D, int ROWS, bool TRANSPOSE>
__device__ __forceinline__ void stage_tile(const float* __restrict__ src, int rows_valid,
                                           float mul, float* dst, int ld) {
  constexpr int kVecs = ROWS * D / 4;
  for (int e = threadIdx.x; e < kVecs; e += kThreads) {
    const int r = (e * 4) / D;
    const int d0 = (e * 4) % D;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows_valid) v = *reinterpret_cast<const float4*>(src + (size_t)r * D + d0);
    const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (TRANSPOSE) dst[(d0 + i) * ld + r] = f[i] * mul;
      else dst[r * D + d0 + i] = f[i] * mul;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      float* __restrict__ lse, int hq, int hkv, int sq, int sk,
                      float scale, int causal, int window, int q_offset) {
  constexpr int DC = D / 64;      // output column chunks of 64 per thread row
  constexpr int LQ = kBQ + kPad;
  constexpr int LK = kBK + kPad;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sQT = smem;
  float* sKT = sQT + Smem<D>::kQT;
  float* sV = sKT + Smem<D>::kKT;
  float* sPT = sV + Smem<D>::kV;

  const int tid = threadIdx.x;
  const int tr = tid >> 4;        // row group: rows 4 tr .. 4 tr + 3
  const int tc = tid & 15;        // key group / output column group
  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int h = bh % hq;
  const int kvh = h / (hq / hkv);
  const int q_tile = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int q0 = q_tile * kBQ;
  const int q_first = q0 + q_offset;

  const float* qb = q + ((size_t)bh * sq + q0) * D;
  const float* kb = k + (size_t)(b * hkv + kvh) * sk * D;
  const float* vb = v + (size_t)(b * hkv + kvh) * sk * D;
  stage_tile<D, kBQ, true>(qb, min(kBQ, sq - q0), scale, sQT, LQ);

  float m_run[4], l_run[4], acc[4][4 * DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * DC; ++j) acc[i][j] = 0.f;
  }

  const int nk = (sk + kBK - 1) / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k_first = kt * kBK;
    // the TPU kernel's block-skip test (flash_attention.py:48-54)
    bool needed = true;
    if (causal) needed = needed && (k_first <= q_first + kBQ - 1);
    if (window > 0) needed = needed && (k_first + kBK - 1 > q_first - window);
    if (!needed) continue;  // uniform over the block

    __syncthreads();  // the previous tile's sKT / sV / sPT reads are done
    const int k_valid = min(kBK, sk - k_first);
    stage_tile<D, kBK, true>(kb + (size_t)k_first * D, k_valid, 1.f, sKT, LK);
    stage_tile<D, kBK, false>(vb + (size_t)k_first * D, k_valid, 1.f, sV, D);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(sQT + d * LQ + 4 * tr);
      const float4 kv = *reinterpret_cast<const float4*>(sKT + d * LK + 4 * tc);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q_first + 4 * tr + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k_first + 4 * tc + j;
        bool ok = col < sk;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && col > row - window;
        if (!ok) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 lanes of a row group are one half-warp: xor 8, 4, 2, 1 stays inside it
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = __expf(m_run[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = __expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_run[i] = l_run[i] * alpha + rs;
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * DC; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(sPT + (4 * tc + j) * LQ + 4 * tr) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 pv = *reinterpret_cast<const float4*>(sPT + kk * LQ + 4 * tr);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(sV + kk * D + c * 64 + 4 * tc);
        const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][c * 4 + j] = fmaf(pa[i], va[j], acc[i][c * 4 + j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * tr + i;
    if (r >= sq) continue;
    const float inv = 1.f / fmaxf(l_run[i], 1e-30f);
    // every lane of the row's half-warp holds the reduced m and l
    if (lse != nullptr && tc == 0)
      lse[(size_t)bh * sq + r] = m_run[i] + logf(fmaxf(l_run[i], 1e-30f));
    float* orow = out + ((size_t)bh * sq + r) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) orow[c * 64 + 4 * tc + j] = acc[i][c * 4 + j] * inv;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int b,
                   int hq, int hkv, int sq, int sk, float scale, int causal, int window,
                   int q_offset, cudaStream_t stream) {
  auto kern = flash_fwd_simt_kernel<D>;
  const size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + kBQ - 1) / kBQ, b * hq);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, hq, hkv, sq, sk, scale,
      causal, window, q_offset);
  return cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kBM = 128;                    // q rows per block: 2 warpgroups x 64
constexpr int kStages = 2;                  // k / v ring depth
constexpr int kConsumers = 256;             // warps 0-7
constexpr int kRowBytes = 128;              // one swizzled panel row: 64 bf16

template <int D>
struct Smem {
  // keys per k / v tile: at D 256, 128-key tiles in two stages would take
  // 256 KB beside the q tile; 64-key tiles take 128 KB (192 KB in all)
  static constexpr int kBN = D == 256 ? 64 : 128;
  // the producer: one warp, or at D 256 a warpgroup that gives its registers
  // to the consumers (setmaxnreg: 24 a thread for it, 240 for them), whose O
  // accumulator alone takes 128 a thread (ptxas budgets 168 at 288 threads)
  static constexpr bool kLendRegs = D == 256;
  static constexpr int kThreads = kConsumers + (kLendRegs ? 128 : 32);
  static constexpr int kPanels = D / 64;
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kTileBytes = kBN * D * 2;   // one k or v tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;           // stage s at kK + s * kTileBytes
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  // q_full, k_full[kStages], v_full[kStages], empty[kStages]
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages);
  static constexpr size_t kAlloc = kBytes + 1024;   // slack to align the base to 1024
  static_assert(kAlloc <= 232448, "a block takes at most 227 KB of shared memory");
};

template <int D>
__global__ void __launch_bounds__(Smem<D>::kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
                       float* __restrict__ lse, int hq, int hkv, int sq, int sk,
                       float scale_log2, int causal, int window, int q_offset) {
  using L = Smem<D>;
  constexpr int kBN = L::kBN;
  using ScoreMma = Wgmma<kBN>;   // S: 64 q rows x kBN keys
  using OutMma = Wgmma<D>;       // O: 64 q rows x D
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ;
  const uint32_t sK = base + L::kK;
  const uint32_t sV = base + L::kV;
  const uint32_t q_full = base + L::kBar;
  auto k_full = [&](int s) { return q_full + 8u * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8u * (1 + kStages + s); };
  auto empty = [&](int s) { return q_full + 8u * (1 + 2 * kStages + s); };

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / hq;
  const int kv_bh = b * hkv + (bh % hq) / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // heaviest causal tiles first
  const int q_first = q0 + q_offset;

  // k tiles the TPU kernel's block-skip test keeps (flash_attention.py:48-54):
  // causal: k_first <= q_first + kBM - 1; window: k_first + kBN - 1 > q_first - window
  int kt_hi = (sk + kBN - 1) / kBN - 1;
  if (causal) kt_hi = min(kt_hi, floor_div(q_first + kBM - 1, kBN));
  const int kt_lo = window > 0 ? max(0, floor_div(q_first - window - kBN + 1, kBN) + 1) : 0;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), kConsumers / 32);   // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer: lane 0 of warp 8 issues every copy ----
    if constexpr (L::kLendRegs) setmaxnreg_dec<24>();
    if (tid == kConsumers) {
      mbar_arrive_expect_tx(q_full, L::kQBytes);
      for (int p = 0; p < L::kPanels; ++p)
        tma_load_3d(sQ + p * kBM * kRowBytes, &tq, q_full, 64 * p, q0, bh);
      for (int it = 0, kt = kt_lo; kt <= kt_hi; ++it, ++kt) {
        const int s = it % kStages;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        const uint32_t ks = sK + s * L::kTileBytes;
        const uint32_t vs = sV + s * L::kTileBytes;
        mbar_arrive_expect_tx(k_full(s), L::kTileBytes);
        for (int p = 0; p < L::kPanels; ++p)
          tma_load_3d(ks + p * kBN * kRowBytes, &tk, k_full(s), 64 * p, kt * kBN, kv_bh);
        mbar_arrive_expect_tx(v_full(s), L::kTileBytes);
        for (int p = 0; p < L::kPanels; ++p)
          tma_load_3d(vs + p * kBN * kRowBytes, &tv, v_full(s), 64 * p, kt * kBN, kv_bh);
      }
    }
    return;
  }

  if constexpr (L::kLendRegs) setmaxnreg_inc<240>();

  // ---- consumers: warpgroup wg owns q rows 64 wg .. 64 wg + 63 of the tile ----
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int r_lo = 16 * warp + lane / 4;          // rows r_lo and r_lo + 8 of the 64
  const int row0 = q_first + 64 * wg + r_lo;      // key position of each row
  const int row1 = row0 + 8;
  const int wg_row_min = q_first + 64 * wg;
  const int wg_row_max = wg_row_min + 63;
  const int col_lane = 2 * (lane % 4);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float s[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) s[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;   // l: this thread's share

  const uint32_t qa = sQ + wg * 64 * kRowBytes;
  mbar_wait(q_full, 0);

  for (int it = 0, kt = kt_lo; kt <= kt_hi; ++it, ++kt) {
    const int st = it % kStages;
    const uint32_t ph = (it / kStages) & 1;
    const uint32_t ks = sK + st * L::kTileBytes;
    const uint32_t vs = sV + st * L::kTileBytes;

    // S = Q K^T: D / 16 steps of k16, both operands K-major
    mbar_wait(k_full(st), ph);
    wgmma_fence();
    reg_fence(s);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBM * kRowBytes + (kk % 4) * 32;
      const uint32_t koff = (kk / 4) * kBN * kRowBytes + (kk % 4) * 32;
      ScoreMma::ss(s, sw128_desc(qa + off, 16, 1024), sw128_desc(ks + koff, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);

    // scores in base 2: s c with c = scale * log2(e), then the -1e30 mask, so
    // p = 2^(s c - m) is the reference's exp(s scale - m') term for term (a
    // row masked so far has m = -1e30 and takes p = 1, as there)
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) s[i] *= scale_log2;
    const int k_first = kt * kBN;
    const bool edge = (k_first + kBN > sk) || (causal && k_first + kBN - 1 > wg_row_min) ||
                      (window > 0 && k_first <= wg_row_max - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k_first + 8 * j + col_lane + e;
          bool ok0 = col < sk, ok1 = col < sk;
          if (causal) { ok0 = ok0 && col <= row0; ok1 = ok1 && col <= row1; }
          if (window > 0) { ok0 = ok0 && col > row0 - window; ok1 = ok1 && col > row1 - window; }
          if (!ok0) s[4 * j + e] = kNegInf;
          if (!ok1) s[4 * j + 2 + e] = kNegInf;
        }
      }
    }

    // online softmax: row max over this thread's 32 columns, then the 4 lanes
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {     // the 4 lanes of a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float alpha0 = ex2(m0 - mx0);
    const float alpha1 = ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      s[4 * j] = ex2(s[4 * j] - mx0);
      s[4 * j + 1] = ex2(s[4 * j + 1] - mx0);
      s[4 * j + 2] = ex2(s[4 * j + 2] - mx1);
      s[4 * j + 3] = ex2(s[4 * j + 3] - mx1);
      rs0 += s[4 * j] + s[4 * j + 1];
      rs1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= alpha0;
      o[4 * j + 1] *= alpha0;
      o[4 * j + 2] *= alpha1;
      o[4 * j + 3] *= alpha1;
    }

    // O += P V: kBN / 16 steps of k16 over the tile's keys; P from registers,
    // V MN-major (LBO: the next 64-wide panel of d; SBO: the next 8 keys)
    uint32_t pa[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) to_a_frag(s, kk, pa[kk]);
    mbar_wait(v_full(st), ph);
    wgmma_fence();
    reg_fence(o);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      OutMma::rs(o, pa[kk], sw128_desc(vs + kk * 16 * kRowBytes, kBN * kRowBytes, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int r0 = q0 + 64 * wg + r_lo;
  const int r1 = r0 + 8;
  if (lse != nullptr && lane % 4 == 0) {
    // m and l are in base 2 here: lse = (m + log2 l) ln 2
    constexpr float kLn2 = 0.6931471805599453f;
    if (r0 < sq) lse[(size_t)bh * sq + r0] = (m0 + __log2f(fmaxf(l0, 1e-30f))) * kLn2;
    if (r1 < sq) lse[(size_t)bh * sq + r1] = (m1 + __log2f(fmaxf(l1, 1e-30f))) * kLn2;
  }
  bf16* out0 = out + ((size_t)bh * sq + r0) * D + col_lane;
  bf16* out1 = out0 + 8 * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (r0 < sq)
      *reinterpret_cast<__nv_bfloat162*>(out0 + 8 * j) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (r1 < sq)
      *reinterpret_cast<__nv_bfloat162*>(out1 + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver API call: fetched once through the runtime,
// so the library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-d map over a contiguous [heads, s, d] bf16 tensor, boxes of `rows` rows x
// 64 columns (one swizzle panel); rows past s arrive as zeros.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int heads, int s, int d,
              int rows = 128) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)s * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int b,
                   int hq, int hkv, int sq, int sk, float scale, int causal, int window,
                   int q_offset, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  constexpr int kBN = Smem<D>::kBN;
  if (!make_map(encode, &tq, q, b * hq, sq, D, kBM) ||
      !make_map(encode, &tk, k, b * hkv, sk, D, kBN) ||
      !make_map(encode, &tv, v, b * hkv, sk, D, kBN))
    return cudaErrorInvalidValue;
  auto kern = flash_fwd_wgmma_kernel<D>;
  const size_t smem = Smem<D>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(b * hq, (sq + kBM - 1) / kBM);
  kern<<<grid, Smem<D>::kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), lse, hq, hkv, sq, sk, scale * 1.4426950408889634f,
      causal, window, q_offset);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// backward: the delta kernel (both dtypes) and the fp32 SIMT kernels
// ---------------------------------------------------------------------------

namespace bwd {

constexpr int kB = 64;          // q rows per q tile, keys per k tile
constexpr int kThreads = 256;   // 16 x 16 threads, each a 4 x 4 patch of a tile
constexpr int kLT = kB + 4;     // row length of [.][kB] tiles: K^T, V^T, P, dS

template <int D>
struct Smem {
  static constexpr int kLR = D + 4;   // row length of row-major [kB][D] tiles
  // dK/dV: K^T, V^T [D][kLT]; Q, dO [kB][kLR]; P, dS [kB][kLT]; lse, delta [kB]
  static constexpr size_t kDkdv =
      sizeof(float) * (2 * D * kLT + 2 * kB * kLR + 2 * kB * kLT + 2 * kB);
  // dQ: Q, dO, K [kB][kLR]; K^T, V^T [D][kLT]; dS^T [kB][kLT]; lse, delta [kB]
  static constexpr size_t kDq =
      sizeof(float) * (3 * kB * kLR + 2 * D * kLT + kB * kLT + 2 * kB);
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void unpack(const float4& v, float (&f)[4]) {
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}

// Rows [0, rows_valid) of a [kB, W] fp32 tile at src (rows src_ld apart)
// into shared memory, row-major (dst[r * ld + d]) or transposed
// (dst[d * ld + r]); rows past the edge are zero.
template <int W, bool TRANSPOSE>
__device__ __forceinline__ void stage_cols(const float* __restrict__ src, int src_ld,
                                           int rows_valid, float* dst, int ld) {
  constexpr int kVecs = kB * W / 4;
  for (int e = threadIdx.x; e < kVecs; e += kThreads) {
    const int r = (e * 4) / W;
    const int d0 = (e * 4) % W;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows_valid) v = load4(src + (size_t)r * src_ld + d0);
    if (TRANSPOSE) {
      dst[(d0 + 0) * ld + r] = v.x;
      dst[(d0 + 1) * ld + r] = v.y;
      dst[(d0 + 2) * ld + r] = v.z;
      dst[(d0 + 3) * ld + r] = v.w;
    } else {
      store4(dst + r * ld + d0, v);
    }
  }
}

// A whole [kB, D] tile: stage_cols over all of its D columns
template <int D, bool TRANSPOSE>
__device__ __forceinline__ void stage(const float* __restrict__ src, int rows_valid, float* dst,
                                      int ld) {
  stage_cols<D, TRANSPOSE>(src, D, rows_valid, dst, ld);
}

__device__ __forceinline__ void stage_rows(const float* __restrict__ src, int n_valid,
                                           float* dst) {
  for (int i = threadIdx.x; i < kB; i += kThreads) dst[i] = i < n_valid ? src[i] : 0.f;
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// acc[i][j] += sum_d A[4 tr + i][d] Bt[d][4 tc + j]; A row-major [kB][lda], Bt [D][kLT]
template <int D>
__device__ __forceinline__ void patch_abt_add(const float* A, int lda, const float* Bt, int tr,
                                              int tc, float (&acc)[4][4]) {
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float a[4][4], b[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) unpack(load4(A + (4 * tr + i) * lda + d), a[i]);
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) unpack(load4(Bt + (d + dd) * kLT + 4 * tc), b[dd]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int dd = 0; dd < 4; ++dd) acc[i][j] = fmaf(a[i][dd], b[dd][j], acc[i][j]);
  }
}

// acc[i][j] = sum_d A[4 tr + i][d] Bt[d][4 tc + j]
template <int D>
__device__ __forceinline__ void patch_abt(const float* A, int lda, const float* Bt, int tr,
                                          int tc, float (&acc)[4][4]) {
  zero(acc);
  patch_abt_add<D>(A, lda, Bt, tr, tc, acc);
}

// acc[i][4 c + j] += sum_r X[r][4 tr + i] Y[r][64 c + 4 tc + j];
// X [kB][kLT], Y row-major [kB][ldy]
template <int D>
__device__ __forceinline__ void patch_atb(const float* X, const float* Y, int ldy, int tr,
                                          int tc, float (&acc)[4][D / 16]) {
#pragma unroll 4
  for (int r = 0; r < kB; ++r) {
    float x[4];
    unpack(load4(X + r * kLT + 4 * tr), x);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      float y[4];
      unpack(load4(Y + r * ldy + 64 * c + 4 * tc), y);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][4 * c + j] = fmaf(x[i], y[j], acc[i][4 * c + j]);
    }
  }
}

// The forward's block-skip test for a (q tile, k tile) pair
__device__ __forceinline__ bool tile_needed(int q_first, int k_first, int causal, int window) {
  bool needed = true;
  if (causal) needed = needed && (k_first <= q_first + kB - 1);
  if (window > 0) needed = needed && (k_first + kB - 1 > q_first - window);
  return needed;
}

// s (scores) -> P = exp(s scale - lse), masked to 0; dp (dO V^T) -> dS =
// P (dp - delta) scale.  Rows are q0 + 4 tr + i, keys k0 + 4 tc + j.
__device__ __forceinline__ void probs_and_dscores(float (&s)[4][4], float (&dp)[4][4],
                                                  const float* sLse, const float* sDelta,
                                                  int q0, int k0, int tr, int tc, int sq,
                                                  int sk, float scale, int causal, int window,
                                                  int q_offset) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * tr + i;
    const int pos = row + q_offset;
    const float lse_i = sLse[4 * tr + i];
    const float delta_i = sDelta[4 * tr + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + 4 * tc + j;
      bool ok = row < sq && col < sk;
      if (causal) ok = ok && col <= pos;
      if (window > 0) ok = ok && col > pos - window;
      const float p = ok ? __expf(s[i][j] * scale - lse_i) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - delta_i) * scale;
    }
  }
}

// (a) delta[row] = sum_d dO[row][d] O[row][d]: a row is D * sizeof(T) / 16
// lanes (at most 32), each with 16 bytes of O and of dO a load, so a warp
// takes 32 / that rows (4 at bf16 D 64) with full 16-byte loads; a row
// wider than a warp's loads (fp32 D 256) takes kLoads loads a lane; the
// lanes of a row reduce by shuffles in a fixed order
template <typename T, int D>
struct DeltaShape {
  static constexpr int kVec = 16 / sizeof(T);                       // elements a load
  static constexpr int kLanes = D / kVec < 32 ? D / kVec : 32;      // lanes a row
  static constexpr int kLoads = D / (kVec * kLanes);                // loads a lane
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows) {
  using S = DeltaShape<T, D>;
  constexpr int kVec = S::kVec;
  constexpr int kLanes = S::kLanes;
  const int lane = threadIdx.x & 31;
  const int row = ((blockIdx.x * kThreads + threadIdx.x) >> 5) * (32 / kLanes) + lane / kLanes;
  const int c = (lane % kLanes) * kVec;
  float acc = 0.f;
  if (row < rows) {
#pragma unroll
    for (int l = 0; l < S::kLoads; ++l)
#pragma unroll
      for (int i = 0; i < kVec; i += 4) {
        const float4 a = load4(out + (size_t)row * D + l * kLanes * kVec + c + i);
        const float4 b = load4(dout + (size_t)row * D + l * kLanes * kVec + c + i);
        acc += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
      }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && lane % kLanes == 0) delta[row] = acc;
}

// (b) dK, dV for one (b, kv head, key tile), summed over its GQA group
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int hq, int hkv, int sq,
                      int sk, float scale, int causal, int window, int q_offset) {
  constexpr int LR = Smem<D>::kLR;
  constexpr int DC = D / 16;
  extern __shared__ float4 smem4[];
  float* sKt = reinterpret_cast<float*>(smem4);
  float* sVt = sKt + D * kLT;
  float* sQ = sVt + D * kLT;
  float* sdO = sQ + kB * LR;
  float* sP = sdO + kB * LR;
  float* sdS = sP + kB * kLT;
  float* sLse = sdS + kB * kLT;
  float* sDelta = sLse + kB;

  const int tid = threadIdx.x;
  const int tr = tid >> 4;
  const int tc = tid & 15;
  const int bkv = blockIdx.y;               // b * hkv + kv head
  const int b = bkv / hkv;
  const int group = hq / hkv;
  const int k0 = blockIdx.x * kB;
  const int k_valid = min(kB, sk - k0);
  stage<D, true>(k + ((size_t)bkv * sk + k0) * D, k_valid, sKt, kLT);
  stage<D, true>(v + ((size_t)bkv * sk + k0) * D, k_valid, sVt, kLT);

  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int nq = (sq + kB - 1) / kB;
  for (int g = 0; g < group; ++g) {
    const int bh = b * hq + (bkv % hkv) * group + g;
    for (int qt = 0; qt < nq; ++qt) {
      const int q0 = qt * kB;
      if (!tile_needed(q0 + q_offset, k0, causal, window)) continue;   // uniform
      const int q_valid = min(kB, sq - q0);
      __syncthreads();   // the previous tile's reads of sQ .. sDelta are done
      stage<D, false>(q + ((size_t)bh * sq + q0) * D, q_valid, sQ, LR);
      stage<D, false>(dout + ((size_t)bh * sq + q0) * D, q_valid, sdO, LR);
      stage_rows(lse + (size_t)bh * sq + q0, q_valid, sLse);
      stage_rows(delta + (size_t)bh * sq + q0, q_valid, sDelta);
      __syncthreads();

      float s[4][4], dp[4][4];
      patch_abt<D>(sQ, LR, sKt, tr, tc, s);
      patch_abt<D>(sdO, LR, sVt, tr, tc, dp);
      probs_and_dscores(s, dp, sLse, sDelta, q0, k0, tr, tc, sq, sk, scale, causal, window,
                        q_offset);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        store4(sP + (4 * tr + i) * kLT + 4 * tc, make_float4(s[i][0], s[i][1], s[i][2], s[i][3]));
        store4(sdS + (4 * tr + i) * kLT + 4 * tc,
               make_float4(dp[i][0], dp[i][1], dp[i][2], dp[i][3]));
      }
      __syncthreads();
      patch_atb<D>(sP, sdO, LR, tr, tc, dv_acc);    // dV += P^T dO
      patch_atb<D>(sdS, sQ, LR, tr, tc, dk_acc);    // dK += dS^T Q
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * tr + i;
    if (key >= sk) continue;
    const size_t base = ((size_t)bkv * sk + key) * D + 4 * tc;
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      store4(dk + base + 64 * c, make_float4(dk_acc[i][4 * c], dk_acc[i][4 * c + 1],
                                             dk_acc[i][4 * c + 2], dk_acc[i][4 * c + 3]));
      store4(dv + base + 64 * c, make_float4(dv_acc[i][4 * c], dv_acc[i][4 * c + 1],
                                             dv_acc[i][4 * c + 2], dv_acc[i][4 * c + 3]));
    }
  }
}

// (c) dQ for one (b, q head, q tile)
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int hq, int hkv, int sq, int sk, float scale,
                    int causal, int window, int q_offset) {
  constexpr int LR = Smem<D>::kLR;
  constexpr int DC = D / 16;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sdO = sQ + kB * LR;
  float* sK = sdO + kB * LR;
  float* sKt = sK + kB * LR;
  float* sVt = sKt + D * kLT;
  float* sdSt = sVt + D * kLT;
  float* sLse = sdSt + kB * kLT;
  float* sDelta = sLse + kB;

  const int tid = threadIdx.x;
  const int tr = tid >> 4;
  const int tc = tid & 15;
  const int bh = blockIdx.y;
  const int kv_bh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;   // heaviest causal tiles first
  const int q_valid = min(kB, sq - q0);
  stage<D, false>(q + ((size_t)bh * sq + q0) * D, q_valid, sQ, LR);
  stage<D, false>(dout + ((size_t)bh * sq + q0) * D, q_valid, sdO, LR);
  stage_rows(lse + (size_t)bh * sq + q0, q_valid, sLse);
  stage_rows(delta + (size_t)bh * sq + q0, q_valid, sDelta);

  float dq_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dq_acc[i][j] = 0.f;

  const int nk = (sk + kB - 1) / kB;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kB;
    if (!tile_needed(q0 + q_offset, k0, causal, window)) continue;   // uniform
    const int k_valid = min(kB, sk - k0);
    const float* kg = k + ((size_t)kv_bh * sk + k0) * D;
    __syncthreads();   // the previous tile's reads of sK, sKt, sVt, sdSt are done
    stage<D, false>(kg, k_valid, sK, LR);
    stage<D, true>(kg, k_valid, sKt, kLT);
    stage<D, true>(v + ((size_t)kv_bh * sk + k0) * D, k_valid, sVt, kLT);
    __syncthreads();

    float s[4][4], dp[4][4];
    patch_abt<D>(sQ, LR, sKt, tr, tc, s);
    patch_abt<D>(sdO, LR, sVt, tr, tc, dp);
    probs_and_dscores(s, dp, sLse, sDelta, q0, k0, tr, tc, sq, sk, scale, causal, window,
                      q_offset);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store4(sdSt + (4 * tc + j) * kLT + 4 * tr,
             make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]));
    __syncthreads();
    patch_atb<D>(sdSt, sK, LR, tr, tc, dq_acc);     // dQ += dS K
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * tr + i;
    if (row >= sq) continue;
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
      store4(dq + ((size_t)bh * sq + row) * D + 64 * c + 4 * tc,
             make_float4(dq_acc[i][4 * c], dq_acc[i][4 * c + 1], dq_acc[i][4 * c + 2],
                         dq_acc[i][4 * c + 3]));
  }
}

// fp32 at D 256: a [D][kLT] K^T / V^T pair beside the [kB][D + 4] Q / dO
// pair would take 301 KB, so both kernels below stage D in chunks of 64
// columns ([64][kLT] tiles, ~105 KB in all): S and dP sum over the chunks,
// then each chunk of the output is one more pass over its columns.  Their
// tiles, patches and masks are the kernels' above.
constexpr int kC = 64;             // columns a chunk
constexpr int kChunkOut = 2;       // dK / dV chunks a block: at D 256 two blocks share a key tile

struct SmemChunked {
  // dK / dV: Q, dO, K^T, V^T chunks, P, dS [64][kLT]; dQ: Q, dO, K^T, V^T
  // chunks, dS^T (and the K chunk in Q's place); lse, delta [kB]
  static constexpr size_t kBytes = sizeof(float) * (6 * kB * kLT + 2 * kB);
};

// S = Q K^T and dP = dO V^T for a (q tile, key tile) pair, summed over D's
// chunks (the previous tile's reads of the chunk buffers must be done)
template <int D>
__device__ __forceinline__ void chunked_scores(const float* qg, int q_valid, const float* dog,
                                               const float* kg, const float* vg, int k_valid,
                                               float* sA, float* sB, float* sKt, float* sVt,
                                               int tr, int tc, float (&s)[4][4],
                                               float (&dp)[4][4]) {
  zero(s);
  zero(dp);
#pragma unroll 1
  for (int c = 0; c < D / kC; ++c) {
    __syncthreads();   // the previous chunk's reads are done
    stage_cols<kC, false>(qg + kC * c, D, q_valid, sA, kLT);
    stage_cols<kC, false>(dog + kC * c, D, q_valid, sB, kLT);
    stage_cols<kC, true>(kg + kC * c, D, k_valid, sKt, kLT);
    stage_cols<kC, true>(vg + kC * c, D, k_valid, sVt, kLT);
    __syncthreads();
    patch_abt_add<kC>(sA, kLT, sKt, tr, tc, s);
    patch_abt_add<kC>(sB, kLT, sVt, tr, tc, dp);
  }
}

// (b) at D 256: dK, dV columns 128 z .. 128 z + 127 of one (b, kv head, key tile)
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_chunked_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv, int hq, int hkv,
                              int sq, int sk, float scale, int causal, int window,
                              int q_offset) {
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sdO = sQ + kB * kLT;
  float* sKt = sdO + kB * kLT;
  float* sVt = sKt + kC * kLT;
  float* sP = sVt + kC * kLT;
  float* sdS = sP + kB * kLT;
  float* sLse = sdS + kB * kLT;
  float* sDelta = sLse + kB;

  const int tid = threadIdx.x;
  const int tr = tid >> 4;
  const int tc = tid & 15;
  const int bkv = blockIdx.y;
  const int b = bkv / hkv;
  const int group = hq / hkv;
  const int k0 = blockIdx.x * kB;
  const int k_valid = min(kB, sk - k0);
  const int c_first = blockIdx.z * kChunkOut;     // this block's first output chunk
  const float* kg = k + ((size_t)bkv * sk + k0) * D;
  const float* vg = v + ((size_t)bkv * sk + k0) * D;

  float dk_acc[kChunkOut][4][4], dv_acc[kChunkOut][4][4];
#pragma unroll
  for (int c = 0; c < kChunkOut; ++c) {
    zero(dk_acc[c]);
    zero(dv_acc[c]);
  }

  const int nq = (sq + kB - 1) / kB;
  for (int g = 0; g < group; ++g) {
    const int bh = b * hq + (bkv % hkv) * group + g;
    for (int qt = 0; qt < nq; ++qt) {
      const int q0 = qt * kB;
      if (!tile_needed(q0 + q_offset, k0, causal, window)) continue;   // uniform
      const int q_valid = min(kB, sq - q0);
      const float* qg = q + ((size_t)bh * sq + q0) * D;
      const float* dog = dout + ((size_t)bh * sq + q0) * D;
      float s[4][4], dp[4][4];
      chunked_scores<D>(qg, q_valid, dog, kg, vg, k_valid, sQ, sdO, sKt, sVt, tr, tc, s, dp);
      stage_rows(lse + (size_t)bh * sq + q0, q_valid, sLse);
      stage_rows(delta + (size_t)bh * sq + q0, q_valid, sDelta);
      __syncthreads();
      probs_and_dscores(s, dp, sLse, sDelta, q0, k0, tr, tc, sq, sk, scale, causal, window,
                        q_offset);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        store4(sP + (4 * tr + i) * kLT + 4 * tc, make_float4(s[i][0], s[i][1], s[i][2], s[i][3]));
        store4(sdS + (4 * tr + i) * kLT + 4 * tc,
               make_float4(dp[i][0], dp[i][1], dp[i][2], dp[i][3]));
      }
#pragma unroll
      for (int c = 0; c < kChunkOut; ++c) {
        __syncthreads();   // P / dS written; the previous chunk's reads are done
        stage_cols<kC, false>(qg + kC * (c_first + c), D, q_valid, sQ, kLT);
        stage_cols<kC, false>(dog + kC * (c_first + c), D, q_valid, sdO, kLT);
        __syncthreads();
        patch_atb<kC>(sP, sdO, kLT, tr, tc, dv_acc[c]);    // dV += P^T dO
        patch_atb<kC>(sdS, sQ, kLT, tr, tc, dk_acc[c]);    // dK += dS^T Q
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * tr + i;
    if (key >= sk) continue;
    const size_t base = ((size_t)bkv * sk + key) * D + kC * c_first + 4 * tc;
#pragma unroll
    for (int c = 0; c < kChunkOut; ++c) {
      store4(dk + base + kC * c, make_float4(dk_acc[c][i][0], dk_acc[c][i][1], dk_acc[c][i][2],
                                             dk_acc[c][i][3]));
      store4(dv + base + kC * c, make_float4(dv_acc[c][i][0], dv_acc[c][i][1], dv_acc[c][i][2],
                                             dv_acc[c][i][3]));
    }
  }
}

// (c) at D 256: dQ for one (b, q head, q tile)
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_chunked_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dq, int hq, int hkv, int sq, int sk, float scale,
                            int causal, int window, int q_offset) {
  constexpr int NC = D / kC;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);    // a Q chunk, then a K chunk for dQ
  float* sdO = sQ + kB * kLT;
  float* sKt = sdO + kB * kLT;
  float* sVt = sKt + kC * kLT;
  float* sdSt = sVt + kC * kLT;
  float* sLse = sdSt + kB * kLT;
  float* sDelta = sLse + kB;

  const int tid = threadIdx.x;
  const int tr = tid >> 4;
  const int tc = tid & 15;
  const int bh = blockIdx.y;
  const int kv_bh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;   // heaviest causal tiles first
  const int q_valid = min(kB, sq - q0);
  const float* qg = q + ((size_t)bh * sq + q0) * D;
  const float* dog = dout + ((size_t)bh * sq + q0) * D;
  stage_rows(lse + (size_t)bh * sq + q0, q_valid, sLse);
  stage_rows(delta + (size_t)bh * sq + q0, q_valid, sDelta);

  float dq_acc[NC][4][4];
#pragma unroll
  for (int c = 0; c < NC; ++c) zero(dq_acc[c]);

  const int nk = (sk + kB - 1) / kB;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kB;
    if (!tile_needed(q0 + q_offset, k0, causal, window)) continue;   // uniform
    const int k_valid = min(kB, sk - k0);
    const float* kg = k + ((size_t)kv_bh * sk + k0) * D;
    float s[4][4], dp[4][4];
    chunked_scores<D>(qg, q_valid, dog, kg, v + ((size_t)kv_bh * sk + k0) * D, k_valid, sQ, sdO,
                      sKt, sVt, tr, tc, s, dp);
    probs_and_dscores(s, dp, sLse, sDelta, q0, k0, tr, tc, sq, sk, scale, causal, window,
                      q_offset);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store4(sdSt + (4 * tc + j) * kLT + 4 * tr,
             make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]));
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      __syncthreads();   // dS^T written; the previous chunk's reads are done
      stage_cols<kC, false>(kg + kC * c, D, k_valid, sQ, kLT);
      __syncthreads();
      patch_atb<kC>(sdSt, sQ, kLT, tr, tc, dq_acc[c]);     // dQ += dS K
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * tr + i;
    if (row >= sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      store4(dq + ((size_t)bh * sq + row) * D + kC * c + 4 * tc,
             make_float4(dq_acc[c][i][0], dq_acc[c][i][1], dq_acc[c][i][2], dq_acc[c][i][3]));
  }
}

template <typename T, int D>
cudaError_t launch_delta(const void* out, const void* dout, float* delta, int rows,
                         cudaStream_t stream) {
  constexpr int kRowsPerBlock = kThreads / 32 * (32 / DeltaShape<T, D>::kLanes);
  flash_bwd_delta_kernel<T, D><<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, kThreads, 0,
                                 stream>>>(static_cast<const T*>(out),
                                           static_cast<const T*>(dout), delta, rows);
  return cudaGetLastError();
}

// The fp32 kernels for head dim D (only the chosen form is instantiated).
// The chunked form gives the same bits at D 64 and 128 but restages K^T /
// V^T for every q tile and Q / dO for every key tile: 13-23% slower there
// on an H100 (scripts/time_attention_bwd.py), so it is kept to D 256.
template <int D>
auto dkdv_kernel() {
  if constexpr (D > 128) return flash_bwd_dkdv_chunked_kernel<D>;
  else return flash_bwd_dkdv_kernel<D>;
}
template <int D>
auto dq_kernel() {
  if constexpr (D > 128) return flash_bwd_dq_chunked_kernel<D>;
  else return flash_bwd_dq_kernel<D>;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out,
                   const void* dout, const float* lse, float* delta, void* dq, void* dk,
                   void* dv, int b, int hq, int hkv, int sq, int sk, float scale, int causal,
                   int window, int q_offset, cudaStream_t stream) {
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dout);
  cudaError_t err = launch_delta<float, D>(out, dout, delta, b * hq * sq, stream);
  if (err != cudaSuccess) return err;
  // fp32 D 256 takes the chunked kernels: the others' tiles do not fit
  constexpr bool kChunked = D > 128;
  constexpr size_t dkdv_smem = kChunked ? SmemChunked::kBytes : Smem<D>::kDkdv;
  constexpr size_t dq_smem = kChunked ? SmemChunked::kBytes : Smem<D>::kDq;
  const dim3 dkdv_grid((sk + kB - 1) / kB, b * hkv, kChunked ? D / (kC * kChunkOut) : 1);
  const dim3 dq_grid((sq + kB - 1) / kB, b * hq);
  auto dkdv = dkdv_kernel<D>();
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkdv_smem);
  if (err != cudaSuccess) return err;
  dkdv<<<dkdv_grid, kThreads, dkdv_smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), hq, hkv,
      sq, sk, scale, causal, window, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = dq_kernel<D>();
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem);
  if (err != cudaSuccess) return err;
  dqk<<<dq_grid, kThreads, dq_smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<float*>(dq), hq, hkv, sq, sk, scale, causal,
      window, q_offset);
  return cudaGetLastError();
}

}  // namespace bwd

// ---------------------------------------------------------------------------
// backward, bf16: wgmma + TMA
// ---------------------------------------------------------------------------

namespace bwd_tc {

using namespace hopper;
using bf16 = __nv_bfloat16;
using tc::kRowBytes;

constexpr int kConsumers = 256;             // warps 0-7: two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup (one thread copies)
constexpr int kProducerRegs = 24;           // setmaxnreg: the producer gives registers
constexpr int kConsumerRegs = 240;          // back, each consumer thread takes 240
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ bool visible(int row, int pos, int key, int sq, int sk, int causal,
                                        int window) {
  bool ok = row < sq && key < sk;
  if (causal) ok = ok && key <= pos;
  if (window > 0) ok = ok && key > pos - window;
  return ok;
}

// Descriptors of a swizzled [rows, D] bf16 tile (64-column panels of `rows`
// rows) at k16 step kk.  K-major (d is k): 32 bytes a step, the next panel
// after four.  MN-major (rows are k, d is n): 16 rows a step, the next
// 64-wide panel of d `rows` rows further.
__device__ __forceinline__ uint64_t k_desc(uint32_t tile, int kk, int rows) {
  return sw128_desc(tile + (kk / 4) * rows * kRowBytes + (kk % 4) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t mn_desc(uint32_t tile, int kk, int rows) {
  return sw128_desc(tile + kk * 16 * kRowBytes, rows * kRowBytes, 1024);
}

// (b) dK / dV: one block per (b, kv head, 128 keys); D 64 and 128 (D 256:
// namespace d256 below)
template <int D>
struct Dkdv {
  static constexpr int kBK = 128;                 // keys a block: two warpgroups x 64
  static constexpr int kBQ = D == 64 ? 128 : 32;  // q rows a streamed tile (registers at D 128)
  static constexpr int kStages = 3;
  static constexpr int kPanels = D / 64;
  static constexpr int kKVBytes = kBK * D * 2;    // the K or the V block
  static constexpr int kQBytes = kBQ * D * 2;     // one Q or dO tile
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKVBytes;
  static constexpr int kQ = kV + kKVBytes;        // stage s at kQ + s * kQBytes
  static constexpr int kdO = kQ + kStages * kQBytes;
  // a tile's lse and delta: a 1-d box that starts on a 16-byte boundary at or
  // before the tile's first row (TMA takes no other start), so 4 more
  static constexpr int kRowBox = kBQ + 4;
  static constexpr int kRowSlot = (kRowBox * 4 + 127) / 128 * 128;   // bytes a stage
  static constexpr int kLse = kdO + kStages * kQBytes;
  static constexpr int kDelta = kLse + kStages * kRowSlot;
  static constexpr int kStageBytes = 2 * kQBytes + 2 * kRowBox * 4;   // TMA bytes a stage
  static constexpr int kBar = kDelta + kStages * kRowSlot;  // kv_full, full[], empty[]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages);
  static constexpr size_t kAlloc = kBytes + 1024;           // slack to align the base
  static_assert(kAlloc <= 232448, "a block takes at most 227 KB of shared memory");
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const __grid_constant__ CUtensorMap tlse,
                            const __grid_constant__ CUtensorMap tdelta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv, int hq, int hkv,
                            int sq, int sk, float scale, int causal, int window, int q_offset) {
  using L = Dkdv<D>;
  constexpr int BQ = L::kBQ;
  using ScoreMma = Wgmma<BQ>;   // S^T, dP^T: 64 keys x BQ q rows
  using GradMma = Wgmma<D>;     // dV, dK: 64 keys x D
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const float* s_lse = reinterpret_cast<const float*>(smem_raw + (base - raw) + L::kLse);
  const float* s_delta = reinterpret_cast<const float*>(smem_raw + (base - raw) + L::kDelta);
  const uint32_t sK = base + L::kK;
  const uint32_t sV = base + L::kV;
  auto sQ = [&](int s) { return base + L::kQ + s * L::kQBytes; };
  auto sdO = [&](int s) { return base + L::kdO + s * L::kQBytes; };
  const uint32_t kv_full = base + L::kBar;
  auto full = [&](int s) { return kv_full + 8u * (1 + s); };
  auto empty = [&](int s) { return kv_full + 8u * (1 + L::kStages + s); };

  const int tid = threadIdx.x;
  const int bkv = blockIdx.x;                                // b * hkv + kv head
  const int group = hq / hkv;
  const int bh0 = (bkv / hkv) * hq + (bkv % hkv) * group;    // the group's first q head
  const int k0 = blockIdx.y * L::kBK;   // key block 0 first: causal, it sees every q tile
  // q tiles the forward's block-skip test keeps for these keys (positions
  // q0 + q_offset ..): causal, the tile's last position at or past k0; a
  // window, its first position before the last key + window
  const int nq = (sq + BQ - 1) / BQ;
  const int qt_lo = causal ? max(0, floor_div(k0 - q_offset, BQ)) : 0;
  const int qt_hi = window > 0
                        ? min(nq - 1, floor_div(k0 + L::kBK - 2 + window - q_offset, BQ))
                        : nq - 1;
  const int n_qt = max(0, qt_hi - qt_lo + 1);
  const int n_items = group * n_qt;     // (q head, q tile) pairs, heads outer

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers / 32);    // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warpgroup: one thread issues every copy; the (q head, q
    //      tile) pairs in order, each Q, dO, lse and delta tile on one barrier
    //      (rows past Sq: zeros for Q and dO, the next head's lse and delta,
    //      which the mask discards; lse and delta from the 16-byte boundary
    //      at or before the tile's first row) ----
    setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      mbar_arrive_expect_tx(kv_full, 2 * L::kKVBytes);
      for (int p = 0; p < L::kPanels; ++p) {
        tma_load_3d(sK + p * L::kBK * kRowBytes, &tk, kv_full, 64 * p, k0, bkv);
        tma_load_3d(sV + p * L::kBK * kRowBytes, &tv, kv_full, 64 * p, k0, bkv);
      }
      for (int it = 0; it < n_items; ++it) {
        const int s = it % L::kStages;
        const int bh = bh0 + it / n_qt;
        const int q0 = (qt_lo + it % n_qt) * BQ;
        mbar_wait(empty(s), ((it / L::kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(full(s), L::kStageBytes);
        for (int p = 0; p < L::kPanels; ++p) {
          tma_load_3d(sQ(s) + p * BQ * kRowBytes, &tq, full(s), 64 * p, q0, bh);
          tma_load_3d(sdO(s) + p * BQ * kRowBytes, &tdo, full(s), 64 * p, q0, bh);
        }
        const int row_box = (bh * sq + q0) & ~3;
        tma_load_1d(base + L::kLse + s * L::kRowSlot, &tlse, full(s), row_box);
        tma_load_1d(base + L::kDelta + s * L::kRowSlot, &tdelta, full(s), row_box);
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  // ---- consumers: warpgroup wg owns keys k0 + 64 wg .. k0 + 64 wg + 63 ----
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int kw0 = k0 + 64 * wg;
  const int key0 = kw0 + 16 * warp + lane / 4;    // this thread's keys: key0, key0 + 8
  const int col_lane = 2 * (lane % 4);
  const float scale_log2 = scale * kLog2e;
  const uint32_t ka = sK + wg * 64 * kRowBytes;   // this warpgroup's rows of K and V
  const uint32_t va = sV + wg * 64 * kRowBytes;

  float dk_acc[D / 2], dv_acc[D / 2], st[BQ / 2], dpt[BQ / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.f;
  mbar_wait(kv_full, 0);

  for (int it = 0; it < n_items; ++it) {
    const int s = it % L::kStages;
    const int q0 = (qt_lo + it % n_qt) * BQ;
    const int p0 = q0 + q_offset;                 // the tile's first q position
    const int row_off = (bh0 + it / n_qt) * sq + q0;   // lse / delta of the tile's rows
    // a tile these 64 keys cannot see at all is skipped (uniform over the
    // warpgroup); one that straddles a mask edge, Sq or Sk is masked (with
    // selects: past Sq, lse and delta are another head's)
    const bool dead = kw0 >= sk || (causal && p0 + BQ - 1 < kw0) ||
                      (window > 0 && p0 - (kw0 + 63) >= window);
    const bool edge = q0 + BQ > sq || kw0 + 64 > sk || (causal && p0 < kw0 + 63) ||
                      (window > 0 && p0 + BQ - 1 - kw0 >= window);
    mbar_wait(full(s), (it / L::kStages) & 1);
    if (!dead) {
      const uint32_t qs = sQ(s);
      const uint32_t dos = sdO(s);
      const float* lse_s = s_lse + s * (L::kRowSlot / 4) + (row_off & 3);
      const float* delta_s = s_delta + s * (L::kRowSlot / 4) + (row_off & 3);
      // S^T = K Q^T (both operands K-major)
      wgmma_fence();
      reg_fence(st);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ScoreMma::ss(st, k_desc(ka, kk, L::kBK), k_desc(qs, kk, BQ), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(st);
      // P^T = 2^(S^T scale log2 e - lse log2 e), a column is a q row (no
      // branch inside: the exponentials of a tile issue back to back); kept
      // as bf16 only, the A operand of dV and the P of dS^T
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float l0 = lse_s[8 * j + col_lane] * kLog2e;
        const float l1 = lse_s[8 * j + col_lane + 1] * kLog2e;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          st[4 * j + 2 * h] = ex2(fmaf(st[4 * j + 2 * h], scale_log2, -l0));
          st[4 * j + 2 * h + 1] = ex2(fmaf(st[4 * j + 2 * h + 1], scale_log2, -l1));
        }
      }
      if (edge) {
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + col_lane + e;
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if (!visible(q0 + c, p0 + c, key0 + 8 * h, sq, sk, causal, window))
                st[4 * j + 2 * h + e] = 0.f;
          }
      }
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) to_a_frag(st, kk, pa[kk]);
      // dP^T = V dO^T (K-major) and dV += P^T dO (A from registers, the dO
      // tile read MN-major), one group
      wgmma_fence();
      reg_fence(dpt);
      reg_fence(dv_acc);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ScoreMma::ss(dpt, k_desc(va, kk, L::kBK), k_desc(dos, kk, BQ), kk > 0);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        GradMma::rs(dv_acc, pa[kk], mn_desc(dos, kk, BQ));
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dpt);
      reg_fence(dv_acc);
      // dS^T = P^T (dP^T - delta) scale, then dK += dS^T Q (Q read MN-major)
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 dl = make_float2(delta_s[8 * j + col_lane], delta_s[8 * j + col_lane + 1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const __nv_bfloat162 p2 =
              *reinterpret_cast<const __nv_bfloat162*>(&pa[j / 2][2 * (j % 2) + h]);
          const float2 pf = __bfloat1622float2(p2);
          dpt[4 * j + 2 * h] = pf.x * (dpt[4 * j + 2 * h] - dl.x) * scale;
          dpt[4 * j + 2 * h + 1] = pf.y * (dpt[4 * j + 2 * h + 1] - dl.y) * scale;
        }
      }
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) to_a_frag(dpt, kk, da[kk]);
      wgmma_fence();
      reg_fence(dk_acc);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        GradMma::rs(dk_acc, da[kk], mn_desc(qs, kk, BQ));
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dk_acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

  // dK and dV of keys key0 and key0 + 8 (those below Sk), rounded to bf16 once
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    if (key >= sk) continue;
    const size_t row = ((size_t)bkv * sk + key) * D + col_lane;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + row + 8 * j) =
          __floats2bfloat162_rn(dk_acc[4 * j + 2 * h], dk_acc[4 * j + 2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + row + 8 * j) =
          __floats2bfloat162_rn(dv_acc[4 * j + 2 * h], dv_acc[4 * j + 2 * h + 1]);
    }
  }
}

// (c) dQ: one block per (b, q head, 128 q rows); D 64 and 128
template <int D>
struct Dq {
  static constexpr int kBM = 128;                 // q rows a block: two warpgroups x 64
  // keys a streamed K / V tile: dQ's accumulator takes D / 2 registers, the
  // scores 2 x kBN / 2
  static constexpr int kBN = D == 64 ? 128 : 64;
  static constexpr int kStages = 3;
  static constexpr int kPanels = D / 64;
  static constexpr int kQBytes = kBM * D * 2;     // Q or dO
  static constexpr int kTileBytes = kBN * D * 2;  // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kdO = kQ + kQBytes;
  static constexpr int kK = kdO + kQBytes;        // stage s at kK + s * kTileBytes
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;    // q_full, k_full[], v_full[], empty[]
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages);
  static constexpr size_t kAlloc = kBytes + 1024;
  static_assert(kAlloc <= 232448, "a block takes at most 227 KB of shared memory");
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dq, int hq, int hkv, int sq, int sk, float scale,
                          int causal, int window, int q_offset) {
  using L = Dq<D>;
  using ScoreMma = Wgmma<L::kBN>;   // S, dP: 64 q rows x kBN keys
  using GradMma = Wgmma<D>;         // dQ: 64 q rows x D
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ;
  const uint32_t sdO = base + L::kdO;
  auto sK = [&](int s) { return base + L::kK + s * L::kTileBytes; };
  auto sV = [&](int s) { return base + L::kV + s * L::kTileBytes; };
  const uint32_t q_full = base + L::kBar;
  auto k_full = [&](int s) { return q_full + 8u * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8u * (1 + L::kStages + s); };
  auto empty = [&](int s) { return q_full + 8u * (1 + 2 * L::kStages + s); };

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int kv_bh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * L::kBM;   // heaviest causal tiles first
  const int q_first = q0 + q_offset;
  // the forward's block-skip bounds, for 128 rows against 64-key tiles
  int kt_hi = (sk + L::kBN - 1) / L::kBN - 1;
  if (causal) kt_hi = min(kt_hi, floor_div(q_first + L::kBM - 1, L::kBN));
  const int kt_lo =
      window > 0 ? max(0, floor_div(q_first - window - L::kBN + 1, L::kBN) + 1) : 0;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warpgroup: one thread issues every copy ----
    setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      mbar_arrive_expect_tx(q_full, 2 * L::kQBytes);
      for (int p = 0; p < L::kPanels; ++p) {
        tma_load_3d(sQ + p * L::kBM * kRowBytes, &tq, q_full, 64 * p, q0, bh);
        tma_load_3d(sdO + p * L::kBM * kRowBytes, &tdo, q_full, 64 * p, q0, bh);
      }
      for (int it = 0, kt = kt_lo; kt <= kt_hi; ++it, ++kt) {
        const int s = it % L::kStages;
        mbar_wait(empty(s), ((it / L::kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(k_full(s), L::kTileBytes);
        for (int p = 0; p < L::kPanels; ++p)
          tma_load_3d(sK(s) + p * L::kBN * kRowBytes, &tk, k_full(s), 64 * p, kt * L::kBN, kv_bh);
        mbar_arrive_expect_tx(v_full(s), L::kTileBytes);
        for (int p = 0; p < L::kPanels; ++p)
          tma_load_3d(sV(s) + p * L::kBN * kRowBytes, &tv, v_full(s), 64 * p, kt * L::kBN, kv_bh);
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  // ---- consumers: warpgroup wg owns q rows q0 + 64 wg .. q0 + 64 wg + 63 ----
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int qw0 = q0 + 64 * wg;
  const int pw0 = qw0 + q_offset;
  const int row0 = qw0 + 16 * warp + lane / 4;    // this thread's rows: row0, row0 + 8
  const int row1 = row0 + 8;
  const int col_lane = 2 * (lane % 4);
  const float scale_log2 = scale * kLog2e;
  const float lse0 = row0 < sq ? lse[(size_t)bh * sq + row0] * kLog2e : 0.f;
  const float lse1 = row1 < sq ? lse[(size_t)bh * sq + row1] * kLog2e : 0.f;
  const float delta0 = row0 < sq ? delta[(size_t)bh * sq + row0] : 0.f;
  const float delta1 = row1 < sq ? delta[(size_t)bh * sq + row1] : 0.f;
  const uint32_t qa = sQ + wg * 64 * kRowBytes;   // this warpgroup's rows of Q and dO
  const uint32_t doa = sdO + wg * 64 * kRowBytes;

  float dq_acc[D / 2], sc[L::kBN / 2], dp[L::kBN / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < L::kBN / 2; ++i) sc[i] = dp[i] = 0.f;
  mbar_wait(q_full, 0);

  for (int it = 0, kt = kt_lo; kt <= kt_hi; ++it, ++kt) {
    const int s = it % L::kStages;
    const uint32_t ph = (it / L::kStages) & 1;
    const int k_first = kt * L::kBN;
    const uint32_t ks = sK(s);
    const bool dead = qw0 >= sq || (causal && k_first > pw0 + 63) ||
                      (window > 0 && k_first + L::kBN - 1 <= pw0 - window);
    const bool edge = qw0 + 64 > sq || k_first + L::kBN > sk ||
                      (causal && k_first + L::kBN - 1 > pw0) ||
                      (window > 0 && k_first <= pw0 + 63 - window);
    // S = Q K^T and dP = dO V^T (K-major operands) as two groups; a tile's
    // products are issued and awaited inside one branch (wgmma spread over
    // two branches is serialised by ptxas)
    mbar_wait(k_full(s), ph);
    mbar_wait(v_full(s), ph);
    if (!dead) {
      wgmma_fence();
      reg_fence(sc);
      reg_fence(dp);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ScoreMma::ss(sc, k_desc(qa, kk, L::kBM), k_desc(ks, kk, L::kBN), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ScoreMma::ss(dp, k_desc(doa, kk, L::kBM), k_desc(sV(s), kk, L::kBN), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      reg_fence(sc);
      // P = 2^(S scale log2 e - lse log2 e)
#pragma unroll
      for (int i = 0; i < L::kBN / 2; ++i)
        sc[i] = ex2(fmaf(sc[i], scale_log2, (i & 2) ? -lse1 : -lse0));
      if (edge) {
#pragma unroll
        for (int j = 0; j < L::kBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k_first + 8 * j + col_lane + e;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = h ? row1 : row0;
              if (!visible(row, row + q_offset, key, sq, sk, causal, window))
                sc[4 * j + 2 * h + e] = 0.f;
            }
          }
      }
      wgmma_wait<0>();
      reg_fence(dp);
      // dS = P (dP - delta) scale, then dQ += dS K with K read MN-major
#pragma unroll
      for (int i = 0; i < L::kBN / 2; ++i)
        dp[i] = sc[i] * (dp[i] - ((i & 2) ? delta1 : delta0)) * scale;
      uint32_t da[L::kBN / 16][4];
#pragma unroll
      for (int kk = 0; kk < L::kBN / 16; ++kk) to_a_frag(dp, kk, da[kk]);
      wgmma_fence();
      reg_fence(dq_acc);
#pragma unroll
      for (int kk = 0; kk < L::kBN / 16; ++kk) GradMma::rs(dq_acc, da[kk], mn_desc(ks, kk, L::kBN));
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dq_acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

  // dQ rows row0 and row0 + 8 (those below Sq), rounded to bf16 once
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? row1 : row0;
    if (row >= sq) continue;
    bf16* out = dq + ((size_t)bh * sq + row) * D + col_lane;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(dq_acc[4 * j + 2 * h], dq_acc[4 * j + 2 * h + 1]);
  }
}

// A 1-d map over n fp32 values, boxes of `box`; past n arrive as zeros.
bool make_map_1d(tc::EncodeTiled encode, CUtensorMap* map, const float* ptr, size_t n, int box) {
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)n * 4};   // rank 1: not read
  const cuuint32_t boxes[1] = {(cuuint32_t)box};
  const cuuint32_t elem[1] = {1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(ptr), dims, strides,
                boxes, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---- (b) and (c) at head_dim 256 -------------------------------------------
//
// A 64 x 256 fp32 accumulator is 128 registers a thread of a warpgroup, so
// dK and dV of 64 keys take both consumer warpgroups, one each.  Each
// 64 x 64 tile's two score products are shared out, not repeated:
// warpgroup 0 computes S^T = K Q^T, P^T and dV, warpgroup 1 dP^T = V dO^T,
// dS^T (from the bf16 P^T that warpgroup 0 leaves in shared memory) and
// dK.  dQ keeps a kernel of its own, 128 q rows a block, 64 a warpgroup
// with all 256 columns.  Seven S x S x D products in all (4 in dK / dV, 3
// in dQ), as at D 64.  The causal tail: the dK / dV grid pairs key block u
// with n - 1 - u (each block then sees n + 1 q tiles of a head), and splits
// a kv head's q-head group into the fewest slices that fill the card; with
// more than one slice each block writes fp32 partials that
// flash_bwd_dkdv_sum_kernel adds in slice order (no atomics: the same bits
// every run).  The dK / dV kernel reads all its epilogue needs from shared
// memory before it writes there: a load behind a store to shared memory
// waits out the store, and an epilogue of 16 such steps was the kernel's
// largest cost.
namespace d256 {

constexpr int D = 256;
constexpr int kTile = 64;                       // keys and q rows a tile
constexpr int kPanelBytes = kTile * kRowBytes;  // 64 rows x 64 bf16: 8 KB
constexpr int kOpBytes = kTile * D * 2;         // a 64 x 256 bf16 tile: 32 KB
constexpr int kStages = 2;                      // streamed tiles in flight
constexpr int kTargetBlocks = 132;              // an H100's SMs

// Descriptors of k16 step kk from step 0's (k_desc / mn_desc at kk = 0):
// the start-address field moves by whole 16-byte units and never carries
// out of its 14 bits (shared addresses stay below 232,448).  `opaque` keeps
// the compiler from computing every step's descriptor ahead of a loop and
// holding them in registers.
__device__ __forceinline__ uint64_t k_step(uint64_t d0, int kk, int rows) {
  return d0 + (((kk / 4) * rows * kRowBytes + (kk % 4) * 32) >> 4);
}
__device__ __forceinline__ uint64_t mn_step(uint64_t d0, int kk) {
  return d0 + ((kk * 16 * kRowBytes) >> 4);
}
__device__ __forceinline__ uint64_t opaque(uint64_t d) {
  asm volatile("" : "+l"(d));
  return d;
}

// Causal without a window: key block u is paired with n - 1 - u.
__host__ __device__ __forceinline__ bool paired(int causal, int window) {
  return causal && window <= 0;
}

// q-head slices of the dK / dV grid: the fewest (a divisor of the group)
// that give at least 7/8 of a wave of blocks.
int dkdv_slices(int b, int hq, int hkv, int sk, int causal, int window) {
  const int group = hq / hkv;
  const int n_kb = (sk + kTile - 1) / kTile;
  const long units = (long)b * hkv * (paired(causal, window) ? (n_kb + 1) / 2 : n_kb);
  int ns = 1;
  while (ns < group && units * ns * 8 < kTargetBlocks * 7) {
    do ++ns; while (group % ns);
  }
  return ns;
}

// The fp32 partials follow delta at the next multiple of 64 floats.
size_t part_offset(int b, int hq, int sq) { return ((size_t)b * hq * sq + 63) / 64 * 64; }

struct DkdvLayout {
  static constexpr int kK = 0;
  static constexpr int kV = kK + kOpBytes;
  static constexpr int kQ = kV + kOpBytes;              // stage s at kQ + s * kOpBytes
  static constexpr int kdO = kQ + kStages * kOpBytes;
  // P^T of stage s's tile for warpgroup 1: 16 bf16 pairs a thread of
  // warpgroup 0, pair i of thread t at word 128 i + t
  static constexpr int kPBytes = kTile * kTile * 2;
  static constexpr int kP = kdO + kStages * kOpBytes;   // buffer s at kP + s * kPBytes
  // a tile's lse and delta: a 1-d box from the 16-byte boundary at or
  // before its first row, so 4 more
  static constexpr int kRowBox = kTile + 4;
  static constexpr int kRowSlot = (kRowBox * 4 + 127) / 128 * 128;
  static constexpr int kLse = kP + kStages * kPBytes;
  static constexpr int kDelta = kLse + kStages * kRowSlot;
  static constexpr int kStageBytes = 2 * kOpBytes + 2 * kRowBox * 4;
  // kv_full, kv_empty, full[], empty[], p_full[]
  static constexpr int kBar = kDelta + kStages * kRowSlot;
  static constexpr int kBytes = kBar + 8 * (2 + 3 * kStages);
  static constexpr size_t kAlloc = kBytes + 1024;
  static_assert(kAlloc <= 232448, "a block takes at most 227 KB of shared memory");
};

// (b) one block per (b, kv head, q-head slice) x (key block, or pair of
// key blocks); K and V of 64 keys resident, (q head, 64-row q tile) items
// streamed: Q, dO, lse and delta.  Warpgroup 0 computes S^T = K Q^T, P^T
// and dV += P^T dO (all 256 columns, P^T as the register A operand);
// warpgroup 1 computes dP^T = V dO^T, dS^T = P^T (dP^T - delta) scale from
// the bf16 P^T that warpgroup 0 leaves in shared memory (barrier p_full),
// and dK += dS^T Q the same way.  Neither waits for the other's products,
// so one warpgroup's exponentials overlap the other's wgmma.
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_d256_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tlse,
                           const __grid_constant__ CUtensorMap tdelta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           float* __restrict__ part, int hq, int hkv, int sq, int sk,
                           float scale, int causal, int window, int q_offset, int slices) {
  using L = DkdvLayout;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);     // the same bytes, generic
  const float* s_lse = reinterpret_cast<const float*>(gbase + L::kLse);
  const float* s_delta = reinterpret_cast<const float*>(gbase + L::kDelta);
  const uint32_t sK = base + L::kK;
  const uint32_t sV = base + L::kV;
  auto sQ = [&](int s) { return base + L::kQ + s * kOpBytes; };
  auto sdO = [&](int s) { return base + L::kdO + s * kOpBytes; };
  auto s_p = [&](int s) { return reinterpret_cast<uint32_t*>(gbase + L::kP + s * L::kPBytes); };
  const uint32_t kv_full = base + L::kBar;
  const uint32_t kv_empty = kv_full + 8u;
  auto full = [&](int s) { return kv_full + 8u * (2 + s); };
  auto empty = [&](int s) { return kv_full + 8u * (2 + kStages + s); };
  auto p_full = [&](int s) { return kv_full + 8u * (2 + 2 * kStages + s); };

  const int tid = threadIdx.x;
  const int bkv = blockIdx.x / slices;                    // b * hkv + kv head
  const int slice = blockIdx.x % slices;
  const int group = hq / hkv;
  const int h_lo = slice * group / slices;
  const int n_h = (slice + 1) * group / slices - h_lo;    // q heads of this slice
  const int bh0 = (bkv / hkv) * hq + (bkv % hkv) * group + h_lo;
  const int n_kb = (sk + kTile - 1) / kTile;
  const int unit = blockIdx.y;
  const int n_blocks = paired(causal, window) && n_kb - 1 - unit != unit ? 2 : 1;
  const int nq = (sq + kTile - 1) / kTile;
  // the r-th key block of this block, and the q tiles the forward's
  // block-skip test keeps for it (causal: the tile's last position at or
  // past k0; a window: its first position before the last key + window)
  auto key0 = [&](int r) { return (r ? n_kb - 1 - unit : unit) * kTile; };
  auto qt_lo = [&](int k0) { return causal ? max(0, floor_div(k0 - q_offset, kTile)) : 0; };
  auto n_qt = [&](int k0) {
    const int hi = window > 0 ? min(nq - 1, floor_div(k0 + kTile - 2 + window - q_offset, kTile))
                              : nq - 1;
    return max(0, hi - qt_lo(k0) + 1);
  };
  // Item i of key block r: q tile i / n_h, the slice's head i % n_h (the
  // heads of a tile back to back).  A pair's first key block walks its q
  // tiles down from the last, the second up from its first: at step t
  // every block of a (b, slice) then reads q tile nq - 1 - t or t - 1 of
  // the same heads (causal, Sq == Sk), so the blocks of a (b, slice) read
  // two q tiles at a time.
  auto q_tile = [&](int r, int lo, int n, int i) {
    const int t = i / n_h;
    return paired(causal, window) && r == 0 ? lo + n - 1 - t : lo + t;
  };

  if (tid == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, kConsumers / 32);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers / 32);    // one arrival per consumer warp
      mbar_init(p_full(s), 128);               // every thread of warpgroup 0
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warpgroup: one thread issues every copy; K and V of a
    //      key block once the consumers are done with the last one, then its
    //      (q head, q tile) items ----
    setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      for (int r = 0, it = 0; r < n_blocks; ++r) {
        const int k0 = key0(r);
        const int lo = qt_lo(k0), n = n_qt(k0);
        if (r > 0) mbar_wait(kv_empty, 0);
        mbar_arrive_expect_tx(kv_full, 2 * kOpBytes);
        for (int p = 0; p < D / 64; ++p) {
          tma_load_3d(sK + p * kPanelBytes, &tk, kv_full, 64 * p, k0, bkv);
          tma_load_3d(sV + p * kPanelBytes, &tv, kv_full, 64 * p, k0, bkv);
        }
        for (int i = 0; i < n_h * n; ++i, ++it) {
          const int s = it % kStages;
          const int bh = bh0 + i % n_h;
          const int q0 = q_tile(r, lo, n, i) * kTile;
          mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(full(s), L::kStageBytes);
          for (int p = 0; p < D / 64; ++p) {
            tma_load_3d(sQ(s) + p * kPanelBytes, &tq, full(s), 64 * p, q0, bh);
            tma_load_3d(sdO(s) + p * kPanelBytes, &tdo, full(s), 64 * p, q0, bh);
          }
          const int row_box = (bh * sq + q0) & ~3;
          tma_load_1d(base + L::kLse + s * L::kRowSlot, &tlse, full(s), row_box);
          tma_load_1d(base + L::kDelta + s * L::kRowSlot, &tdelta, full(s), row_box);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  // ---- consumers: rows of a score tile are keys, its columns q rows;
  //      warpgroup 0 accumulates dV, warpgroup 1 dK ----
  const int wg = tid / 128;
  const int t = tid % 128;
  const int lane = tid % 32;
  const int r_lo = 16 * (t / 32) + lane / 4;       // this thread's rows: r_lo, r_lo + 8
  const int col_lane = 2 * (lane % 4);
  const float scale_log2 = scale * kLog2e;
  const uint32_t sa = wg ? sV : sK;                // A of S^T (warpgroup 0) or dP^T (1)

  float acc[D / 2], sc[kTile / 2];                 // dV (warpgroup 0) or dK (1); a score tile
#pragma unroll
  for (int i = 0; i < kTile / 2; ++i) sc[i] = 0.f;

  for (int r = 0, it = 0; r < n_blocks; ++r) {
    const int k0 = key0(r);
    const int lo = qt_lo(k0), n = n_qt(k0);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    mbar_wait(kv_full, r & 1);
    for (int i = 0; i < n_h * n; ++i, ++it) {
      const int s = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const int q0 = q_tile(r, lo, n, i) * kTile;
      const int p0 = q0 + q_offset;                      // the tile's first q position
      const int row_off = (bh0 + i % n_h) * sq + q0;     // lse / delta of its rows
      // the q tiles in range all see some of these keys; one that straddles
      // a mask edge, Sq or Sk is masked (past Sq, lse and delta are another
      // head's)
      const bool edge = q0 + kTile > sq || k0 + kTile > sk || (causal && p0 < k0 + kTile - 1) ||
                        (window > 0 && p0 + kTile - 1 - k0 >= window);
      const float* per_col = (wg ? s_delta : s_lse) + s * (L::kRowSlot / 4) + (row_off & 3);
      uint32_t* const sp = s_p(s);
      mbar_wait(full(s), ph);
      // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (1), both operands K-major
      const uint64_t ad = opaque(k_desc(sa, 0, kTile));
      const uint64_t bd = opaque(k_desc(wg ? sdO(s) : sQ(s), 0, kTile));
      wgmma_fence();
      reg_fence(sc);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<64>::ss(sc, k_step(ad, kk, kTile), k_step(bd, kk, kTile), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(sc);
      // this thread's 16 columns' lse (warpgroup 0) or delta (1), all read
      // before any store to shared memory (loads behind a store would each
      // wait out the one before)
      float rv[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        rv[2 * j] = per_col[8 * j + col_lane];
        rv[2 * j + 1] = per_col[8 * j + col_lane + 1];
      }
      // pk[2 j + h]: the bf16 pair of columns 8 j + col_lane (+1), row
      // r_lo + 8 h; pk[4 kk .. 4 kk + 3] is the A fragment of k16 step kk
      uint32_t pk[16];
      if (wg == 0) {
        // P^T = 2^(S^T scale log2 e - lse log2 e), masked (no branch among
        // the exponentials); to warpgroup 1 through shared memory
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + col_lane;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float pv0 = ex2(fmaf(sc[4 * j + 2 * h], scale_log2, -rv[2 * j] * kLog2e));
            float pv1 = ex2(fmaf(sc[4 * j + 2 * h + 1], scale_log2, -rv[2 * j + 1] * kLog2e));
            if (edge) {
              const int key = k0 + r_lo + 8 * h;
              if (!visible(q0 + c, p0 + c, key, sq, sk, causal, window)) pv0 = 0.f;
              if (!visible(q0 + c + 1, p0 + c + 1, key, sq, sk, causal, window)) pv1 = 0.f;
            }
            pk[2 * j + h] = pack_bf16(pv0, pv1);
          }
        }
#pragma unroll
        for (int x = 0; x < 16; ++x) sp[128 * x + t] = pk[x];
        mbar_arrive(p_full(s));
      } else {
        // dS^T = P^T (dP^T - delta) scale, from warpgroup 0's bf16 P^T
        mbar_wait(p_full(s), ph);
#pragma unroll
        for (int x = 0; x < 16; ++x) pk[x] = sp[128 * x + t];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 pf =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pk[2 * j + h]));
            pk[2 * j + h] = pack_bf16(pf.x * (sc[4 * j + 2 * h] - rv[2 * j]) * scale,
                                      pf.y * (sc[4 * j + 2 * h + 1] - rv[2 * j + 1]) * scale);
          }
      }
      // dV += P^T dO (warpgroup 0) or dK += dS^T Q (1): A from registers,
      // dO / Q read MN-major, all 256 columns
      const uint64_t gd = opaque(mn_desc(wg ? sQ(s) : sdO(s), 0, kTile));
      wgmma_fence();
      reg_fence(acc);
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        const uint32_t a[4] = {pk[4 * kk], pk[4 * kk + 1], pk[4 * kk + 2], pk[4 * kk + 3]};
        Wgmma<D>::rs(acc, a, mn_step(gd, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

    // keys k0 + r_lo and + 8 (those below Sk), all columns of dV
    // (warpgroup 0) or dK (1): bf16 once, or this slice's fp32 partial
    const size_t n_kv = (size_t)(gridDim.x / slices) * sk * D;   // elements of dK
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = k0 + r_lo + 8 * h;
      if (key >= sk) continue;
      const size_t at = ((size_t)bkv * sk + key) * D + col_lane;
      if (part == nullptr) {
        bf16* out = (wg ? dk : dv) + at;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      } else {
        float* out = part + (wg ? slice : slices + slice) * n_kv + at;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<float2*>(out + 8 * j) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(kv_empty);
  }
}

// dK and dV ([n] each) from the slices' fp32 partials (dK's slices, then
// dV's), added in slice order and rounded to bf16 once; 4 elements a thread
__global__ void __launch_bounds__(256)
flash_bwd_dkdv_sum_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, size_t n, int slices) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= 2 * n) return;
  const bool second = i >= n;
  const size_t j = second ? i - n : i;
  const float* src = part + (second ? slices * n : 0) + j;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int s = 1; s < slices; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(src + s * n);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  bf16* dst = (second ? dv : dk) + j;
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(acc.x, acc.y);
  *reinterpret_cast<__nv_bfloat162*>(dst + 2) = __floats2bfloat162_rn(acc.z, acc.w);
}

struct DqLayout {
  static constexpr int kBM = 128;                        // q rows a block: two warpgroups x 64
  static constexpr int kQ = 0;                           // 128 x 256 bf16: 64 KB
  static constexpr int kdO = kQ + 2 * kOpBytes;
  static constexpr int kK = kdO + 2 * kOpBytes;          // K slot s at kK + s * kOpBytes
  static constexpr int kV = kK + 2 * kOpBytes;           // one V slot
  static constexpr int kBar = kV + kOpBytes;             // q_full, k_full[2], k_empty[2], v_full, v_empty
  static constexpr int kBytes = kBar + 8 * 7;
  static constexpr size_t kAlloc = kBytes + 1024;
  static_assert(kAlloc <= 232448, "a block takes at most 227 KB of shared memory");
};

// (c) one block per (b, q head, 128 q rows), heaviest causal tiles first.
// Each consumer warpgroup owns 64 rows and all 256 of dQ's columns (128
// registers), computes S = Q K^T and dP = dO V^T for them, P and dS in
// registers, and dQ += dS K with dS as the register A operand (m64n256k16),
// as at D 64 and 128.  Q and dO (128 KB) stay resident; 64-key tiles stream
// through two K slots and one V slot (a V tile is done with after dP, a K
// tile only after dQ), so the next K tile loads during a whole tile's work.
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_d256_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dq, int hq, int hkv, int sq, int sk, float scale,
                         int causal, int window, int q_offset) {
  using L = DqLayout;
  constexpr int BM = L::kBM;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ;
  const uint32_t sdO = base + L::kdO;
  auto sK = [&](int s) { return base + L::kK + s * kOpBytes; };
  const uint32_t sV = base + L::kV;
  const uint32_t q_full = base + L::kBar;
  auto k_full = [&](int s) { return q_full + 8u * (1 + s); };
  auto k_empty = [&](int s) { return q_full + 8u * (3 + s); };
  const uint32_t v_full = q_full + 8u * 5;
  const uint32_t v_empty = q_full + 8u * 6;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int kv_bh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // heaviest causal tiles first
  const int q_first = q0 + q_offset;
  // the forward's block-skip bounds for 128 rows against 64-key tiles
  int kt_hi = (sk + kTile - 1) / kTile - 1;
  if (causal) kt_hi = min(kt_hi, floor_div(q_first + BM - 1, kTile));
  const int kt_lo = window > 0 ? max(0, floor_div(q_first - window - kTile + 1, kTile) + 1) : 0;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(k_empty(s), kConsumers / 32);
    }
    mbar_init(v_full, 1);
    mbar_init(v_empty, kConsumers / 32);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warpgroup: one thread issues every copy; tile t's K into
    //      slot t % 2 once tile t - 2's dQ is done, its V once tile t - 1's
    //      dP is ----
    setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      mbar_arrive_expect_tx(q_full, 4 * kOpBytes);
      for (int p = 0; p < D / 64; ++p) {
        tma_load_3d(sQ + p * BM * kRowBytes, &tq, q_full, 64 * p, q0, bh);
        tma_load_3d(sdO + p * BM * kRowBytes, &tdo, q_full, 64 * p, q0, bh);
      }
      for (int it = 0, kt = kt_lo; kt <= kt_hi; ++it, ++kt) {
        const int s = it % 2;
        mbar_wait(k_empty(s), ((it / 2) & 1) ^ 1);
        mbar_arrive_expect_tx(k_full(s), kOpBytes);
        for (int p = 0; p < D / 64; ++p)
          tma_load_3d(sK(s) + p * kPanelBytes, &tk, k_full(s), 64 * p, kt * kTile, kv_bh);
        mbar_wait(v_empty, (it & 1) ^ 1);
        mbar_arrive_expect_tx(v_full, kOpBytes);
        for (int p = 0; p < D / 64; ++p)
          tma_load_3d(sV + p * kPanelBytes, &tv, v_full, 64 * p, kt * kTile, kv_bh);
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  // ---- consumers: warpgroup wg owns q rows q0 + 64 wg .. q0 + 64 wg + 63 ----
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int qw0 = q0 + 64 * wg;
  const int pw0 = qw0 + q_offset;
  const int row0 = qw0 + 16 * warp + lane / 4;    // this thread's rows: row0, row0 + 8
  const int row1 = row0 + 8;
  const int col_lane = 2 * (lane % 4);
  const float scale_log2 = scale * kLog2e;
  const float lse0 = row0 < sq ? lse[(size_t)bh * sq + row0] * kLog2e : 0.f;
  const float lse1 = row1 < sq ? lse[(size_t)bh * sq + row1] * kLog2e : 0.f;
  const float delta0 = row0 < sq ? delta[(size_t)bh * sq + row0] : 0.f;
  const float delta1 = row1 < sq ? delta[(size_t)bh * sq + row1] : 0.f;
  const uint32_t qa = sQ + wg * 64 * kRowBytes;   // this warpgroup's rows of Q and dO
  const uint32_t doa = sdO + wg * 64 * kRowBytes;

  float dq_acc[D / 2], sc[kTile / 2], dp[kTile / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kTile / 2; ++i) sc[i] = dp[i] = 0.f;
  mbar_wait(q_full, 0);

  for (int it = 0, kt = kt_lo; kt <= kt_hi; ++it, ++kt) {
    const int s = it % 2;
    const int k_first = kt * kTile;
    const uint32_t ks = sK(s);
    // a tile this warpgroup's rows cannot see at all is skipped (the last
    // causal tile for warpgroup 0); one that straddles a mask edge, Sq or
    // Sk is masked after the exponentials
    const bool dead = qw0 >= sq || (causal && k_first > pw0 + 63) ||
                      (window > 0 && k_first + kTile - 1 <= pw0 - window);
    const bool edge = qw0 + 64 > sq || k_first + kTile > sk ||
                      (causal && k_first + kTile - 1 > pw0) ||
                      (window > 0 && k_first <= pw0 + 63 - window);
    mbar_wait(k_full(s), (it / 2) & 1);
    mbar_wait(v_full, it & 1);
    if (!dead) {
      // S = Q K^T and dP = dO V^T (K-major operands) as two groups; a
      // tile's products are issued and awaited inside one branch
      const uint64_t qd = opaque(k_desc(qa, 0, BM)), dod = opaque(k_desc(doa, 0, BM));
      const uint64_t kd = opaque(k_desc(ks, 0, kTile)), vd = opaque(k_desc(sV, 0, kTile));
      wgmma_fence();
      reg_fence(sc);
      reg_fence(dp);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<64>::ss(sc, k_step(qd, kk, BM), k_step(kd, kk, kTile), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<64>::ss(dp, k_step(dod, kk, BM), k_step(vd, kk, kTile), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      reg_fence(sc);
      // P = 2^(S scale log2 e - lse log2 e), masked, kept as bf16 pairs (the
      // dK / dV kernel forms dS from the same bf16 P; 16 registers, not 32,
      // while dP lands)
      uint32_t pk[kTile / 4];
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float pv0 = ex2(fmaf(sc[4 * j + 2 * h], scale_log2, h ? -lse1 : -lse0));
          float pv1 = ex2(fmaf(sc[4 * j + 2 * h + 1], scale_log2, h ? -lse1 : -lse0));
          if (edge) {
            const int row = h ? row1 : row0;
            const int key = k_first + 8 * j + col_lane;
            if (!visible(row, row + q_offset, key, sq, sk, causal, window)) pv0 = 0.f;
            if (!visible(row, row + q_offset, key + 1, sq, sk, causal, window)) pv1 = 0.f;
          }
          pk[2 * j + h] = pack_bf16(pv0, pv1);
        }
      wgmma_wait<0>();
      reg_fence(dp);
      __syncwarp();
      if (lane == 0) mbar_arrive(v_empty);
      // dS = P (dP - delta) scale, then dQ += dS K with K read MN-major
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float dl = h ? delta1 : delta0;
          const float2 pf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pk[2 * j + h]));
          dp[4 * j + 2 * h] = pf.x * (dp[4 * j + 2 * h] - dl) * scale;
          dp[4 * j + 2 * h + 1] = pf.y * (dp[4 * j + 2 * h + 1] - dl) * scale;
        }
      uint32_t da[kTile / 16][4];
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) to_a_frag(dp, kk, da[kk]);
      const uint64_t kt_mn = opaque(mn_desc(ks, 0, kTile));
      wgmma_fence();
      reg_fence(dq_acc);
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) Wgmma<D>::rs(dq_acc, da[kk], mn_step(kt_mn, kk));
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dq_acc);
    } else {
      __syncwarp();
      if (lane == 0) mbar_arrive(v_empty);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(k_empty(s));
  }

  // dQ rows row0 and row1 (those below Sq), rounded to bf16 once
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? row1 : row0;
    if (row >= sq) continue;
    bf16* out = dq + ((size_t)bh * sq + row) * D + col_lane;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(dq_acc[4 * j + 2 * h], dq_acc[4 * j + 2 * h + 1]);
  }
}

cudaError_t launch(const void* q, const void* k, const void* v, const void* out,
                   const void* dout, const float* lse, float* delta, void* dq, void* dk,
                   void* dv, int b, int hq, int hkv, int sq, int sk, float scale, int causal,
                   int window, int q_offset, cudaStream_t stream) {
  const tc::EncodeTiled encode = tc::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  cudaError_t err = bwd::launch_delta<bf16, D>(out, dout, delta, b * hq * sq, stream);
  if (err != cudaSuccess) return err;

  CUtensorMap tq, tk, tv, tdo, tlse, tdelta;
  const size_t rows = (size_t)b * hq * sq;
  if (!tc::make_map(encode, &tq, q, b * hq, sq, D, kTile) ||
      !tc::make_map(encode, &tdo, dout, b * hq, sq, D, kTile) ||
      !tc::make_map(encode, &tk, k, b * hkv, sk, D, kTile) ||
      !tc::make_map(encode, &tv, v, b * hkv, sk, D, kTile) ||
      !make_map_1d(encode, &tlse, lse, rows, DkdvLayout::kRowBox) ||
      !make_map_1d(encode, &tdelta, delta, rows, DkdvLayout::kRowBox))
    return cudaErrorInvalidValue;

  const int slices = dkdv_slices(b, hq, hkv, sk, causal, window);
  float* part = slices > 1 ? delta + part_offset(b, hq, sq) : nullptr;
  const int n_kb = (sk + kTile - 1) / kTile;
  const int units = paired(causal, window) ? (n_kb + 1) / 2 : n_kb;
  auto dkdv = flash_bwd_dkdv_d256_kernel;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)DkdvLayout::kAlloc);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3(b * hkv * slices, units), kThreads, DkdvLayout::kAlloc, stream>>>(
      tq, tk, tv, tdo, tlse, tdelta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), part, hq,
      hkv, sq, sk, scale, causal, window, q_offset, slices);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (part != nullptr) {
    const size_t n = (size_t)b * hkv * sk * D;
    const size_t threads = 2 * n / 4;
    flash_bwd_dkdv_sum_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
        part, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, slices);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  constexpr int BM = DqLayout::kBM;
  if (!tc::make_map(encode, &tq, q, b * hq, sq, D, BM) ||
      !tc::make_map(encode, &tdo, dout, b * hq, sq, D, BM))
    return cudaErrorInvalidValue;
  auto dqk = flash_bwd_dq_d256_kernel;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)DqLayout::kAlloc);
  if (err != cudaSuccess) return err;
  dqk<<<dim3(b * hq, (sq + BM - 1) / BM), kThreads, DqLayout::kAlloc, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dq), hq, hkv, sq, sk, scale, causal,
      window, q_offset);
  return cudaGetLastError();
}

}  // namespace d256

// D 64 and 128
template <int D>
cudaError_t launch_narrow(const void* q, const void* k, const void* v, const void* out,
                          const void* dout, const float* lse, float* delta, void* dq, void* dk,
                          void* dv, int b, int hq, int hkv, int sq, int sk, float scale,
                          int causal, int window, int q_offset, cudaStream_t stream) {
  const tc::EncodeTiled encode = tc::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  cudaError_t err = bwd::launch_delta<bf16, D>(out, dout, delta, b * hq * sq, stream);
  if (err != cudaSuccess) return err;

  using KV = Dkdv<D>;
  CUtensorMap tq, tk, tv, tdo, tlse, tdelta;
  const size_t rows = (size_t)b * hq * sq;
  if (!tc::make_map(encode, &tq, q, b * hq, sq, D, KV::kBQ) ||
      !tc::make_map(encode, &tdo, dout, b * hq, sq, D, KV::kBQ) ||
      !tc::make_map(encode, &tk, k, b * hkv, sk, D, KV::kBK) ||
      !tc::make_map(encode, &tv, v, b * hkv, sk, D, KV::kBK) ||
      !make_map_1d(encode, &tlse, lse, rows, KV::kRowBox) ||
      !make_map_1d(encode, &tdelta, delta, rows, KV::kRowBox))
    return cudaErrorInvalidValue;
  auto dkdv = flash_bwd_dkdv_wgmma_kernel<D>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)KV::kAlloc);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3(b * hkv, (sk + KV::kBK - 1) / KV::kBK), kThreads, KV::kAlloc, stream>>>(
      tq, tk, tv, tdo, tlse, tdelta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), hq, hkv,
      sq, sk, scale, causal, window, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  using Q = Dq<D>;
  if (!tc::make_map(encode, &tq, q, b * hq, sq, D, Q::kBM) ||
      !tc::make_map(encode, &tdo, dout, b * hq, sq, D, Q::kBM) ||
      !tc::make_map(encode, &tk, k, b * hkv, sk, D, Q::kBN) ||
      !tc::make_map(encode, &tv, v, b * hkv, sk, D, Q::kBN))
    return cudaErrorInvalidValue;
  auto dqk = flash_bwd_dq_wgmma_kernel<D>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Q::kAlloc);
  if (err != cudaSuccess) return err;
  dqk<<<dim3(b * hq, (sq + Q::kBM - 1) / Q::kBM), kThreads, Q::kAlloc, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dq), hq, hkv, sq, sk, scale, causal,
      window, q_offset);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out,
                   const void* dout, const float* lse, float* delta, void* dq, void* dk,
                   void* dv, int b, int hq, int hkv, int sq, int sk, float scale, int causal,
                   int window, int q_offset, cudaStream_t stream) {
  if constexpr (D == 256)
    return d256::launch(q, k, v, out, dout, lse, delta, dq, dk, dv, b, hq, hkv, sq, sk, scale,
                        causal, window, q_offset, stream);
  else
    return launch_narrow<D>(q, k, v, out, dout, lse, delta, dq, dk, dv, b, hq, hkv, sq, sk,
                            scale, causal, window, q_offset, stream);
}

}  // namespace bwd_tc

// fn(std::integral_constant<int, D>{}) for the head dims the kernels take
template <typename Fn>
cudaError_t by_head_dim(int d, Fn fn) {
  switch (d) {
    case 64: return fn(std::integral_constant<int, 64>{});
    case 128: return fn(std::integral_constant<int, 128>{});
    case 256: return fn(std::integral_constant<int, 256>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 (SIMT kernel), 1 = bfloat16 (wgmma + TMA kernel); q, k, v
// and out share it; d in {64, 128, 256}.  ``lse`` ([B, Hq, Sq] fp32) may be
// null.  The caller guarantees contiguous [B, H, S, D] tensors, 16-byte
// aligned pointers, hq % hkv == 0 and b * hq <= 65535.  Returns a cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   float* lse, int b, int hq, int hkv, int sq, int sk, int d,
                                   float scale, int causal, int window, int q_offset,
                                   int dtype, void* stream) {
  if (b <= 0 || sq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    return dtype == 0 ? simt::launch<D>(q, k, v, out, lse, b, hq, hkv, sq, sk, scale, causal,
                                        window, q_offset, s)
                      : tc::launch<D>(q, k, v, out, lse, b, hq, hkv, sq, sk, scale, causal,
                                      window, q_offset, s);
  }));
}

// The backward of flash_attention_fwd: dq [B, Hq, Sq, D], dk / dv [B, Hkv, Sk, D]
// from q, k, v, the forward's out and lse, and dout; dtype 0 = float32 (SIMT),
// 1 = bfloat16 (wgmma + TMA).  ``delta`` is a caller's fp32 scratch of
// B * Hq * Sq floats, and where flash_attention_bwd_slices gives more than
// one slice also, from B * Hq * Sq rounded up to a multiple of 64, the dK
// and dV partials: 2 * slices * B * Hkv * Sk * D floats.  Same dtypes,
// shapes and guarantees as the forward; d in {64, 128, 256}.  Returns a
// cudaError_t.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* out, const void* dout, const float* lse,
                                   float* delta, void* dq, void* dk, void* dv, int b, int hq,
                                   int hkv, int sq, int sk, int d, float scale, int causal,
                                   int window, int q_offset, int dtype, void* stream) {
  if (b <= 0 || sq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    return dtype == 0 ? bwd::launch<D>(q, k, v, out, dout, lse, delta, dq, dk, dv, b, hq, hkv,
                                       sq, sk, scale, causal, window, q_offset, s)
                      : bwd_tc::launch<D>(q, k, v, out, dout, lse, delta, dq, dk, dv, b, hq,
                                          hkv, sq, sk, scale, causal, window, q_offset, s);
  }));
}

// q-head slices over which the bf16 head_dim-256 dK / dV kernel splits each
// kv head's group for this call (their fp32 partials are summed in slice
// order); 1 for every other call.  Same arguments as flash_attention_bwd.
extern "C" int flash_attention_bwd_slices(int b, int hq, int hkv, int sk, int d, int causal,
                                          int window, int dtype) {
  if (d != 256 || dtype != 1 || b <= 0 || hkv <= 0) return 1;
  return bwd_tc::d256::dkdv_slices(b, hq, hkv, sk, causal, window);
}
