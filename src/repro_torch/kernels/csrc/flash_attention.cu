// Blocked online-softmax GQA attention forward (flash attention) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::flash_attention
// (_kernel): q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D], kv head = q head / (Hq / Hkv)
// with no KV repeat, static causal / window / q_offset, fully masked k-blocks
// skipped, fp32 running max / sum / accumulator, output in q's dtype.
//
// What it computes (the same recurrence as the TPU kernel and ref.mha_blocked):
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
// allocate nothing.
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
                      int hq, int hkv, int sq, int sk, float scale,
                      int causal, int window, int q_offset) {
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
    float* orow = out + ((size_t)bh * sq + r) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) orow[c * 64 + 4 * tc + j] = acc[i][c * 4 + j] * inv;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int b, int hq,
                   int hkv, int sq, int sk, float scale, int causal, int window,
                   int q_offset, cudaStream_t stream) {
  auto kern = flash_fwd_simt_kernel<D>;
  const size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + kBQ - 1) / kBQ, b * hq);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), hq, hkv, sq, sk, scale, causal,
      window, q_offset);
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
                       int hq, int hkv, int sq, int sk, float scale_log2, int causal,
                       int window, int q_offset) {
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
    wgmma_wait_all();
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
    for (int kk = 0; kk < 8; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
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
    wgmma_wait_all();
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

// A 3-d map over a contiguous [heads, s, d] bf16 tensor, boxes of 128 rows x 64
// columns (one swizzle panel); rows past s arrive as zeros.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int heads, int s, int d) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)s * d * 2};
  const cuuint32_t box[3] = {64, 128, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int b, int hq,
                   int hkv, int sq, int sk, float scale, int causal, int window,
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
  kern<<<grid, kThreads, smem, stream>>>(tq, tk, tv, static_cast<bf16*>(out), hq, hkv, sq, sk,
                                         scale * 1.4426950408889634f, causal, window, q_offset);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32 (SIMT kernel), 1 = bfloat16 (wgmma + TMA kernel); q, k, v
// and out share it; d in {64, 128}.  The caller guarantees contiguous
// [B, H, S, D] tensors, 16-byte aligned pointers, hq % hkv == 0 and
// b * hq <= 65535.  Returns a cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   int b, int hq, int hkv, int sq, int sk, int d,
                                   float scale, int causal, int window, int q_offset,
                                   int dtype, void* stream) {
  if (b <= 0 || sq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = d == 64 ? simt::launch<64>(q, k, v, out, b, hq, hkv, sq, sk, scale, causal, window,
                                     q_offset, s)
                  : simt::launch<128>(q, k, v, out, b, hq, hkv, sq, sk, scale, causal, window,
                                      q_offset, s);
  } else {
    err = d == 64 ? tc::launch<64>(q, k, v, out, b, hq, hkv, sq, sk, scale, causal, window,
                                   q_offset, s)
                  : tc::launch<128>(q, k, v, out, b, hq, hkv, sq, sk, scale, causal, window,
                                    q_offset, s);
  }
  return static_cast<int>(err);
}
