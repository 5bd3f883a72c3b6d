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
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
constexpr int kBN = 128;                    // keys per k / v tile
constexpr int kStages = 2;                  // k / v ring depth
constexpr int kConsumers = 256;             // warps 0-7
constexpr int kThreads = kConsumers + 32;   // + the producer warp
constexpr int kRowBytes = 128;              // one swizzled panel row: 64 bf16

template <int D>
struct Smem {
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
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
                       float* __restrict__ lse, int hq, int hkv, int sq, int sk,
                       float scale_log2, int causal, int window, int q_offset) {
  using L = Smem<D>;
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
  float s[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
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
      wgmma_ss_n128(s, sw128_desc(qa + off, 16, 1024), sw128_desc(ks + koff, 16, 1024),
                    kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);

    // scores in base 2: s c with c = scale * log2(e), then the -1e30 mask, so
    // p = 2^(s c - m) is the reference's exp(s scale - m') term for term (a
    // row masked so far has m = -1e30 and takes p = 1, as there)
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] *= scale_log2;
    const int k_first = kt * kBN;
    const bool edge = (k_first + kBN > sk) || (causal && k_first + kBN - 1 > wg_row_min) ||
                      (window > 0 && k_first <= wg_row_max - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
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
    for (int j = 0; j < 16; ++j) {
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
    for (int j = 0; j < 16; ++j) {
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

    // O += P V: 8 steps of k16 over the 128 keys; P from registers, V MN-major
    // (LBO: the next 64-wide panel of d; SBO: the next 8 keys)
    uint32_t pa[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) to_a_frag(s, kk, pa[kk]);
    mbar_wait(v_full(st), ph);
    wgmma_fence();
    reg_fence(o);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint64_t dv = sw128_desc(vs + kk * 16 * kRowBytes, kBN * kRowBytes, 1024);
      if constexpr (D == 64) wgmma_rs_n64(o, pa[kk], dv);
      else wgmma_rs_n128(o, pa[kk], dv);
    }
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
  static_assert(kBM == 128 && kBN == 128, "the maps' boxes are 128 rows");
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map(encode, &tq, q, b * hq, sq, D) || !make_map(encode, &tk, k, b * hkv, sk, D) ||
      !make_map(encode, &tv, v, b * hkv, sk, D))
    return cudaErrorInvalidValue;
  auto kern = flash_fwd_wgmma_kernel<D>;
  const size_t smem = Smem<D>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(b * hq, (sq + kBM - 1) / kBM);
  kern<<<grid, kThreads, smem, stream>>>(tq, tk, tv, static_cast<bf16*>(out), lse, hq, hkv, sq,
                                         sk, scale * 1.4426950408889634f, causal, window,
                                         q_offset);
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

// Rows [0, rows_valid) of a [kB, D] fp32 tile at src into shared memory,
// row-major (dst[r * ld + d]) or transposed (dst[d * ld + r]); rows past the
// edge are zero.
template <int D, bool TRANSPOSE>
__device__ __forceinline__ void stage(const float* __restrict__ src, int rows_valid, float* dst,
                                      int ld) {
  constexpr int kVecs = kB * D / 4;
  for (int e = threadIdx.x; e < kVecs; e += kThreads) {
    const int r = (e * 4) / D;
    const int d0 = (e * 4) % D;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows_valid) v = load4(src + (size_t)r * D + d0);
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

__device__ __forceinline__ void stage_rows(const float* __restrict__ src, int n_valid,
                                           float* dst) {
  for (int i = threadIdx.x; i < kB; i += kThreads) dst[i] = i < n_valid ? src[i] : 0.f;
}

// acc[i][j] = sum_d A[4 tr + i][d] Bt[d][4 tc + j]; A row-major [kB][lda], Bt [D][kLT]
template <int D>
__device__ __forceinline__ void patch_abt(const float* A, int lda, const float* Bt, int tr,
                                          int tc, float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
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
// lanes, each with 16 bytes of O and of dO, so a warp takes 32 / that rows
// (4 at bf16 D 64) with full 16-byte loads; the lanes of a row reduce by
// shuffles in a fixed order
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows) {
  constexpr int kVec = 16 / sizeof(T);        // elements a lane loads
  constexpr int kLanes = D / kVec;            // lanes a row
  const int lane = threadIdx.x & 31;
  const int row = ((blockIdx.x * kThreads + threadIdx.x) >> 5) * (32 / kLanes) + lane / kLanes;
  const int c = (lane % kLanes) * kVec;
  float acc = 0.f;
  if (row < rows) {
#pragma unroll
    for (int i = 0; i < kVec; i += 4) {
      const float4 a = load4(out + (size_t)row * D + c + i);
      const float4 b = load4(dout + (size_t)row * D + c + i);
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

template <typename T, int D>
cudaError_t launch_delta(const void* out, const void* dout, float* delta, int rows,
                         cudaStream_t stream) {
  constexpr int kRowsPerBlock = kThreads / 32 * (32 / (D * (int)sizeof(T) / 16));
  flash_bwd_delta_kernel<T, D><<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, kThreads, 0,
                                 stream>>>(static_cast<const T*>(out),
                                           static_cast<const T*>(dout), delta, rows);
  return cudaGetLastError();
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

  auto dkdv = flash_bwd_dkdv_kernel<D>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Smem<D>::kDkdv);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((sk + kB - 1) / kB, b * hkv), kThreads, Smem<D>::kDkdv, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), hq, hkv,
      sq, sk, scale, causal, window, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = flash_bwd_dq_kernel<D>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Smem<D>::kDq);
  if (err != cudaSuccess) return err;
  dqk<<<dim3((sq + kB - 1) / kB, b * hq), kThreads, Smem<D>::kDq, stream>>>(
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

// (b) dK / dV: one block per (b, kv head, 128 keys)
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
      for (int kk = 0; kk < BQ / 16; ++kk) GradMma::rs(dv_acc, pa[kk], mn_desc(dos, kk, BQ));
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
      for (int kk = 0; kk < BQ / 16; ++kk) GradMma::rs(dk_acc, da[kk], mn_desc(qs, kk, BQ));
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

// (c) dQ: one block per (b, q head, 128 q rows)
template <int D>
struct Dq {
  static constexpr int kBM = 128;                 // q rows a block: two warpgroups x 64
  static constexpr int kBN = D == 64 ? 128 : 64;  // keys a streamed K / V tile
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

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out,
                   const void* dout, const float* lse, float* delta, void* dq, void* dk,
                   void* dv, int b, int hq, int hkv, int sq, int sk, float scale, int causal,
                   int window, int q_offset, cudaStream_t stream) {
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

}  // namespace bwd_tc

}  // namespace

// dtype: 0 = float32 (SIMT kernel), 1 = bfloat16 (wgmma + TMA kernel); q, k, v
// and out share it; d in {64, 128}.  ``lse`` ([B, Hq, Sq] fp32) may be null.
// The caller guarantees contiguous [B, H, S, D] tensors, 16-byte aligned
// pointers, hq % hkv == 0 and b * hq <= 65535.  Returns a cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   float* lse, int b, int hq, int hkv, int sq, int sk, int d,
                                   float scale, int causal, int window, int q_offset,
                                   int dtype, void* stream) {
  if (b <= 0 || sq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = d == 64 ? simt::launch<64>(q, k, v, out, lse, b, hq, hkv, sq, sk, scale, causal,
                                     window, q_offset, s)
                  : simt::launch<128>(q, k, v, out, lse, b, hq, hkv, sq, sk, scale, causal,
                                      window, q_offset, s);
  } else {
    err = d == 64 ? tc::launch<64>(q, k, v, out, lse, b, hq, hkv, sq, sk, scale, causal,
                                   window, q_offset, s)
                  : tc::launch<128>(q, k, v, out, lse, b, hq, hkv, sq, sk, scale, causal,
                                    window, q_offset, s);
  }
  return static_cast<int>(err);
}

// The backward of flash_attention_fwd: dq [B, Hq, Sq, D], dk / dv [B, Hkv, Sk, D]
// from q, k, v, the forward's out and lse, and dout; dtype 0 = float32 (SIMT),
// 1 = bfloat16 (wgmma + TMA).  ``delta`` is a caller's
// fp32 scratch of B * Hq * Sq floats.  Same dtypes, shapes and guarantees as
// the forward; d in {64, 128}.  Returns a cudaError_t.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* out, const void* dout, const float* lse,
                                   float* delta, void* dq, void* dk, void* dv, int b, int hq,
                                   int hkv, int sq, int sk, int d, float scale, int causal,
                                   int window, int q_offset, int dtype, void* stream) {
  if (b <= 0 || sq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = d == 64 ? bwd::launch<64>(q, k, v, out, dout, lse, delta, dq, dk, dv, b, hq, hkv, sq,
                                    sk, scale, causal, window, q_offset, s)
                  : bwd::launch<128>(q, k, v, out, dout, lse, delta, dq, dk, dv, b, hq, hkv, sq,
                                     sk, scale, causal, window, q_offset, s);
  } else {
    err = d == 64 ? bwd_tc::launch<64>(q, k, v, out, dout, lse, delta, dq, dk, dv, b, hq, hkv,
                                       sq, sk, scale, causal, window, q_offset, s)
                  : bwd_tc::launch<128>(q, k, v, out, dout, lse, delta, dq, dk, dv, b, hq,
                                        hkv, sq, sk, scale, causal, window, q_offset, s);
  }
  return static_cast<int>(err);
}
