// RWKV-6 (Finch) WKV recurrence forward for Hopper (sm_90a).
//
//   out_t = r_t · (S_t + u ⊙ k_t ⊗ v_t)        S_{t+1} = diag(w_t) S_t + k_t ⊗ v_t
//
// per (batch, head), with a [K, V] = [64, 64] fp32 state; returns out and the
// final state S_T, given the initial state S_0.
//
// Replaces the Pallas TPU kernel repro/kernels/rwkv6.py::wkv6_pallas
// (_kernel), which chunks time into 64 steps for the MXU with exp(-cum)
// decay algebra: that overflows once a chunk's decays multiply below e^-88
// and needs T % 64 == 0.  The chunked form here references every decay
// factor to the boundary between the two positions it joins, so each is
// 2^x with x <= 0 and nothing overflows; it takes any T.
//
// Bound on this card.  At the serving prefill (one micro-batch: B = 1,
// H = 32, T = 2048, bf16 r/k/v/out, fp32 w) one call must move 51.4 MB
// (25.2 MB of r/k/v, 16.8 MB of w, 8.4 MB of out, 1 MB of state in and out):
// 15.3 us at 3.35 TB/s.  With the products on tensor cores the operations
// are far below that (four 64 x 64 x 64 products a chunk, 2.1 GFLOP of bf16:
// 2.2 us), so the call is bound by bytes.  The serial form's 1.34 GFLOP of
// fp32 FMA would take 20.0 us at the 67 TFLOP/s of the CUDA cores.  The
// chunked form moves more than the bound counts: U and S_in (16.8 MB each)
// are written and read once more.  A decode call (T = 1) moves ~1 MB of
// state: ~0.3 us, so it is bound by launch latency.
//
// Two forms behind one entry point, wkv6_fwd; the wrapper picks one by dtype
// and T (kernels/wkv6.py::uses_chunked_form) and passes a scratch for it:
//
// 1. bf16 r/k/v with T >= 64 (the prefill): the chunked form, three kernels.
//    Time is cut into chunks of 64 steps, each into four sub-chunks of 16;
//    the last chunk is masked past T (k = v = 0, log w = 0, nothing stored).
//    lw = log2(max(w, 1e-30)) (w = 0 underflows from exp(-exp(x)); the clamp
//    keeps log w finite).  Every decay factor is referenced to the boundary
//    between the two positions it joins, so it is 2^x with x <= 0.
//    (a) wkv6_update_kernel, grid (B·H, n_chunks), fully parallel: what each
//        chunk adds to the state, U = k~^T v with k~_i = k_i 2^{D_i} (D_i the
//        sum of lw after step i: a direct suffix sum), on mma.sync m16n8k16
//        with k~ split into bf16 hi + lo (one bf16 operand fails the 1e-4
//        state tolerance), and the chunk's decay 2^G.
//    (b) wkv6_scan_kernel, grid (B·H, 4): the only serial part, elementwise:
//        S_in[c] = S, S <- 2^{G_c} ⊙ S + U_c; each thread streams its U and
//        2^G chunks ahead of use, so the pass runs at memory rate.  U and
//        S_in live in a scratch the wrapper allocates (16.8 MB each at the
//        prefill, L2-sized).
//    (c) wkv6_out_kernel, grid (B·H, n_chunks), fully parallel: one block a
//        chunk, warp p the 16 rows of sub-chunk p, with c' the inclusive
//        prefix of lw within each sub-chunk, x_t = c'_{t-1} (0 at its first
//        row), C_p and G_m the sums of the sub-chunks before p and of
//        sub-chunk m:
//          inter     (r_t 2^{x_t} 2^{C_p}) S_in                   (mma, hi/lo x hi/lo)
//          off-diag  (r_t 2^{x_t}) (k_i 2^{E_i})^T for keys of sub-chunks
//                    q < p, E_i = (G_q - c'_i) + sum_{q<m<p} G_m  (mma, hi/lo x hi/lo)
//          diagonal  16 x 16: the lower-left 8 x 8 quadrant as
//                    (r_t 2^{x_t - c'_7}) (k_i 2^{c'_7 - c'_i})^T  (mma, hi/lo x hi/lo);
//                    the rest pairwise, sum_k r_t k_i 2^{x_t - c'_i} for
//                    i < t in fp32, and the bonus r_t · (u ⊙ k_t) at i = t
//        then out = inter + A v (A as hi + lo bf16), rounded once to bf16.
//        Operands reach the tensor cores through ldmatrix from padded tiles.
//        This pass holds most of the time (the pairwise 2^x on the special
//        function units, and latency at 3 blocks an SM).
// 2. fp32, or T < 64 (decode is T = 1): wkv6_serial_kernel, the serial form
//    spread over the card.  Grid (B·H, 4), 128 threads: 16 state columns x 8
//    groups of 8 state rows; a thread keeps 8 state elements in registers
//    and reduces its share of r·S over the 8 groups with warp shuffles.
//    Steps arrive 16 at a time through a 2-stage cp.async ring.  fp32 stays
//    off the tensor cores (TF32 would break the fp32 tolerance of 1e-4).
//
// All launch on the caller's stream and allocate nothing (the caller passes
// the chunked form's scratch).  ref.wkv6_subchunked mirrors the chunked
// arithmetic in plain torch; the CPU tests hold it against the JAX oracle.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using hopper::ex2;
using hopper::frag_row;
using hopper::ldsm;
using hopper::ldsm_t;
using hopper::mma;
using hopper::pack_bf16;

constexpr int kN = 64;        // K = V = head size
constexpr int kChunk = 64;    // chunked form: steps a chunk
constexpr int kSub = 16;      // steps a sub-chunk (one mma row tile)
constexpr int kSlice = 16;    // serial form: state columns a block (V / 4)
constexpr int kThreads = 128;
constexpr float kMinW = 1e-30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

// 16-byte asynchronous copy global -> shared; zero-filled when !pred (the
// source is then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(hopper::smem_u32(dst)), "l"(src), "r"(pred ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Two fp32 values as bf16 pairs hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

__device__ __forceinline__ float log2w(float w) { return log2f(fmaxf(w, kMinW)); }

// ---------------------------------------------------------------------------
// 2. Serial form: fp32 r/k/v, or T < 64
// ---------------------------------------------------------------------------

constexpr int kSteps = 16;    // steps staged a ring stage

template <typename T, typename TW>
struct SerialSmem {
  T r[2][kSteps][kN];
  T k[2][kSteps][kN];
  TW w[2][kSteps][kN];
  T v[2][kSteps][kSlice];
  float beta[kSteps];         // r_t · (u ⊙ k_t)
};

// Eight consecutive values as floats (16- or 32-byte aligned).
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float (&x)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t q[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&q[i]);
    x[2 * i] = __low2float(h);
    x[2 * i + 1] = __high2float(h);
  }
}

// Copy ROWS rows of COLS values (row stride kN in global, `stride` in shared
// memory) asynchronously with NT threads, zero-filling rows at or past
// `valid`.  The shape is compiled in, so each thread's copies unroll.
template <int ROWS, int COLS, int NT = kThreads, typename E>
__device__ __forceinline__ void stage_rows(E* dst, int stride, const E* src, int valid) {
  constexpr int kPerRow = COLS * sizeof(E) / 16;
  constexpr int kCopies = ROWS * kPerRow;
#pragma unroll
  for (int m = 0; m < (kCopies + NT - 1) / NT; ++m) {
    const int i = threadIdx.x + m * NT;
    if (kCopies % NT == 0 || i < kCopies) {
      const int row = i / kPerRow, col = (i % kPerRow) * (16 / sizeof(E));
      const bool ok = row < valid;
      cp_async16(dst + row * stride + col, src + (ok ? (size_t)row * kN + col : 0), ok);
    }
  }
}

template <typename T, typename TW>
__global__ void __launch_bounds__(kThreads)
wkv6_serial_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const TW* __restrict__ w,
                   const float* __restrict__ u, const float* __restrict__ s0,
                   T* __restrict__ out, float* __restrict__ sT, int H, int T_len) {
  __shared__ __align__(16) SerialSmem<T, TW> sm;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int grp = lane & 7;                                // state rows 8 grp ..
  const int col = (tid >> 5) * 4 + (lane >> 3);            // slice column 0..15
  const int bh = blockIdx.x;
  const int h = bh % H;
  const int v0 = blockIdx.y * kSlice;
  const size_t base = (size_t)bh * T_len * kN;
  const size_t sbase = (size_t)bh * kN * kN + v0 + col;
  const int n_blk = (T_len + kSteps - 1) / kSteps;

  auto load = [&](int bi, int b) {
    const int t0 = bi * kSteps;
    const int valid = T_len - t0;
    stage_rows<kSteps, kN>(&sm.r[b][0][0], kN, r + base + (size_t)t0 * kN, valid);
    stage_rows<kSteps, kN>(&sm.k[b][0][0], kN, k + base + (size_t)t0 * kN, valid);
    stage_rows<kSteps, kN>(&sm.w[b][0][0], kN, w + base + (size_t)t0 * kN, valid);
    stage_rows<kSteps, kSlice>(&sm.v[b][0][0], kSlice, v + base + (size_t)t0 * kN + v0, valid);
  };

  float S[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) S[q] = s0[sbase + (size_t)(8 * grp + q) * kN];

  load(0, 0);
  cp_async_commit();
  if (n_blk > 1) load(1, 1);
  cp_async_commit();
  for (int bi = 0; bi < n_blk; ++bi) {
    const int b = bi & 1;
    const int n = min(kSteps, T_len - bi * kSteps);
    cp_async_wait<1>();
    __syncthreads();
    {  // beta_t = r_t · (u ⊙ k_t): 8 lanes a step, 8 channels a lane
      const int t = tid >> 3, c0 = (tid & 7) * 8;
      float rr[8], kk[8], part = 0.f;
      load8(&sm.r[b][t][c0], rr);
      load8(&sm.k[b][t][c0], kk);
#pragma unroll
      for (int q = 0; q < 8; ++q) part = fmaf(rr[q], u[h * kN + c0 + q] * kk[q], part);
#pragma unroll
      for (int d = 1; d < 8; d <<= 1) part += __shfl_xor_sync(0xffffffffu, part, d);
      if ((tid & 7) == 0) sm.beta[t] = part;
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {          // n is uniform over the block
      float rr[8], kk[8], ww[8];
      load8(&sm.r[b][i][8 * grp], rr);
      load8(&sm.k[b][i][8 * grp], kk);
      load8(&sm.w[b][i][8 * grp], ww);
      const float vj = to_f32(sm.v[b][i][col]);
      float y = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        y = fmaf(rr[q], S[q], y);
        S[q] = fmaf(ww[q], S[q], kk[q] * vj);
      }
#pragma unroll
      for (int d = 1; d < 8; d <<= 1) y += __shfl_xor_sync(0xffffffffu, y, d);
      if (grp == 0)
        store(out + base + (size_t)(bi * kSteps + i) * kN + v0 + col, y + vj * sm.beta[i]);
    }
    __syncthreads();                       // stage b and beta are consumed
    if (bi + 2 < n_blk) load(bi + 2, b);
    cp_async_commit();
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) sT[sbase + (size_t)(8 * grp + q) * kN] = S[q];
}

template <typename T, typename TW>
cudaError_t launch_serial(const void* r, const void* k, const void* v, const void* w,
                          const float* u, const float* s0, void* out, float* sT, int B,
                          int H, int T_len, cudaStream_t stream) {
  wkv6_serial_kernel<T, TW><<<dim3(B * H, kN / kSlice), kThreads, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const TW*>(w), u, s0, static_cast<T*>(out), sT, H, T_len);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 1. Chunked form: prep (parallel), state scan (serial over chunks), output
//    (parallel).  Tiles are staged in shared memory with padded rows, so the
//    8 rows that one ldmatrix reads fall in distinct banks.
// ---------------------------------------------------------------------------

constexpr int kPad = 72;      // bf16 row stride of staged 64-wide tiles (144 B)
constexpr int kPadF = 68;     // fp32 row stride (272 B)
constexpr int kSubs = kChunk / kSub;

__device__ __forceinline__ float2 unpack(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}
__device__ __forceinline__ float2 bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 f2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// -- 1a. Chunk update, one block a (bh, chunk), all in parallel: what the
//    chunk adds to the state, U = k~^T v with k~_i = k_i 2^{D_i} (D_i the sum
//    of lw after step i in the chunk: a direct suffix sum, no difference of
//    large prefix sums), and its decay 2^G (G the chunk's sum of lw).  k~ is
//    split into bf16 hi + lo for the tensor cores (one bf16 operand fails the
//    1e-4 state tolerance); v is exact in bf16.  Steps past T count as
//    k = v = 0, lw = 0 (cp.async zero-fills them).

template <typename TW>
struct UpdateSmem {
  bf16 k[kChunk][kN];
  TW w[kChunk][kN];
  bf16 v[kChunk][kPad];
  bf16 kt[2][kN][kPad];       // k~ hi, lo: [channel][step]
  float upper[kN];            // sum of lw over steps 32..63, per channel
};

template <typename TW>
__global__ void __launch_bounds__(kThreads)
wkv6_update_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                   const TW* __restrict__ w, float* __restrict__ upd, float* __restrict__ decay,
                   int T_len, int n_chunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  UpdateSmem<TW>& sm = *reinterpret_cast<UpdateSmem<TW>*>(smem_raw);
  const int tid = threadIdx.x;
  const int bh = blockIdx.x, ci = blockIdx.y;
  const int valid = min(kChunk, T_len - ci * kChunk);
  const size_t base = ((size_t)bh * T_len + (size_t)ci * kChunk) * kN;
  stage_rows<kChunk, kN>(&sm.k[0][0], kN, k + base, valid);
  stage_rows<kChunk, kN>(&sm.w[0][0], kN, w + base, valid);
  cp_async_commit();
  stage_rows<kChunk, kN>(&sm.v[0][0], kPad, v + base, valid);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  const int ch = tid & (kN - 1), half = tid >> 6;    // channel, steps 32 half ..
  float lw[32];
  float tot = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int t = 32 * half + i;
    lw[i] = t < valid ? log2w(to_f32(sm.w[t][ch])) : 0.f;
    tot += lw[i];
  }
  if (half == 1) sm.upper[ch] = tot;
  __syncthreads();
  float suf = half == 0 ? sm.upper[ch] : 0.f;        // sum of lw after step t
  const size_t chunk = (size_t)bh * n_chunks + ci;
  if (half == 0) decay[chunk * kN + ch] = exp2f(tot + suf);
#pragma unroll
  for (int i = 31; i >= 0; --i) {
    const int t = 32 * half + i;
    const float x = __bfloat162float(sm.k[t][ch]) * exp2f(suf);
    suf += lw[i];
    const bf16 hi = __float2bfloat16_rn(x);
    sm.kt[0][ch][t] = hi;
    sm.kt[1][ch][t] = __float2bfloat16_rn(x - __bfloat162float(hi));
  }
  cp_async_wait<0>();
  __syncthreads();
  // U = k~^T v: warp w the channels 16 w .. + 15, all 64 columns
  const int lane = tid & 31, rows = 16 * (tid >> 5);
  const int g = lane >> 2, c4 = lane & 3;
  float d[8][4] = {};
#pragma unroll
  for (int s = 0; s < kChunk / 16; ++s) {
    uint32_t ah[4], al[4];
    ldsm(ah, frag_row(&sm.kt[0][0][0], kPad, rows, 16 * s, lane));
    ldsm(al, frag_row(&sm.kt[1][0][0], kPad, rows, 16 * s, lane));
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t bv[4];
      ldsm_t(bv, frag_row(&sm.v[0][0], kPad, 16 * s, 16 * jp, lane));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mma(d[2 * jp + h], ah, bv[2 * h], bv[2 * h + 1]);
        mma(d[2 * jp + h], al, bv[2 * h], bv[2 * h + 1]);
      }
    }
  }
  float* p = upd + chunk * kN * kN + (size_t)(rows + g) * kN + 2 * c4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<float2*>(p + 8 * j) = make_float2(d[j][0], d[j][1]);
    *reinterpret_cast<float2*>(p + 8 * j + 8 * kN) = make_float2(d[j][2], d[j][3]);
  }
}

// -- 1b. State scan, elementwise: S_in[c] = S, S <- 2^{G_c} ⊙ S + U_c, serial
//    over the chunks but with no dependence between state elements: each
//    thread owns 4 of one head's 4096 and streams U and 2^G ahead of use
//    (kScanAhead chunks of loads in flight), so the pass runs at the rate at
//    which it can read U and write S_in.

constexpr int kScanThreads = 256;
constexpr int kScanAhead = 8;

__global__ void __launch_bounds__(kScanThreads)
wkv6_scan_kernel(const float* __restrict__ upd, const float* __restrict__ decay,
                 const float* __restrict__ s0, float* __restrict__ s_in,
                 float* __restrict__ sT, int n_chunks) {
  const int bh = blockIdx.x;
  const int idx = blockIdx.y * kScanThreads + threadIdx.x;   // float4 of the head's state
  const int row = idx >> 4;                                 // 16 float4 a row of 64
  const size_t head = (size_t)bh * n_chunks;
  float4 S = reinterpret_cast<const float4*>(s0 + (size_t)bh * kN * kN)[idx];
  for (int c0 = 0; c0 < n_chunks; c0 += kScanAhead) {
    float4 u4[kScanAhead];
    float dec[kScanAhead];
#pragma unroll
    for (int a = 0; a < kScanAhead; ++a) {
      if (c0 + a < n_chunks) {
        const size_t chunk = head + c0 + a;
        u4[a] = reinterpret_cast<const float4*>(upd + chunk * kN * kN)[idx];
        dec[a] = decay[chunk * kN + row];
      }
    }
#pragma unroll
    for (int a = 0; a < kScanAhead; ++a) {
      if (c0 + a < n_chunks) {
        reinterpret_cast<float4*>(s_in + (head + c0 + a) * kN * kN)[idx] = S;
        S.x = fmaf(dec[a], S.x, u4[a].x);
        S.y = fmaf(dec[a], S.y, u4[a].y);
        S.z = fmaf(dec[a], S.z, u4[a].z);
        S.w = fmaf(dec[a], S.w, u4[a].w);
      }
    }
  }
  reinterpret_cast<float4*>(sT + (size_t)bh * kN * kN)[idx] = S;
}

// -- 1c. Output, one block a (bh, chunk), warp p the 16 rows of sub-chunk p.

struct OutSmem {
  bf16 r[kChunk][kPad];
  bf16 k[kChunk][kPad];
  bf16 v[kChunk][kPad];
  bf16 s[2][kN][kPad];        // S_in hi, lo: [channel][column]
  float cp[kChunk][kPadF];    // w as loaded, then c' (inclusive prefix in a sub-chunk)
  float G[kSubs][kN];         // each sub-chunk's sum of lw
  float pw[kSubs][kN];        // 2^{C_p}, C_p the sum of lw before sub-chunk p
  float u[kN];
};

// The 16 rows of sub-chunk P: out[t][0..63] for t = 16 P + g and
// 16 P + g + 8 (g = lane / 4), accumulated in mma layout.
template <int P>
__device__ __forceinline__ void out_rows(const OutSmem& sm, bf16* __restrict__ out, int valid,
                                         int lane) {
  const int g = lane >> 2, c4 = lane & 3;
  const int r0 = kSub * P + g, r1 = r0 + 8;
  float acc[8][4] = {};                    // out[r0 / r1][8 j + 2 c4 (+1)]
  float att[2 * P + 2][4] = {};            // A[r0 / r1][key 8 n + 2 c4 (+1)]
  // x_t = c'_{t-1}: row r0 reads the row above unless it opens the sub-chunk
  const int x0row = g > 0 ? r0 - 1 : r0;
  const float x0on = g > 0 ? 1.f : 0.f;

#pragma unroll 1
  for (int s = 0; s < kN / 16; ++s) {      // channels 16 s .. 16 s + 15
    const int ch0 = 16 * s + 2 * c4;
    uint32_t rf[4], qh[4], ql[4], rh[4], rl[4];   // A operands: r 2^x 2^{C_p}, r 2^x
    ldsm(rf, frag_row(&sm.r[0][0], kPad, kSub * P, 16 * s, lane));
#pragma unroll
    for (int q = 0; q < 4; ++q) {          // a[q]: row r0 / r1 (q & 1), channels + 8 (q >> 1)
      const int ch = ch0 + (q >> 1) * 8;
      const float2 rr = unpack(rf[q]);
      float2 x = (q & 1) ? f2(&sm.cp[r1 - 1][ch]) : f2(&sm.cp[x0row][ch]);
      if (!(q & 1)) { x.x *= x0on; x.y *= x0on; }
      const float2 rx = make_float2(rr.x * ex2(x.x), rr.y * ex2(x.y));
      if (P > 0) {
        const float2 pw = f2(&sm.pw[P][ch]);
        split(rx.x * pw.x, rx.y * pw.y, qh[q], ql[q]);
        split(rx.x, rx.y, rh[q], rl[q]);
      } else {
        split(rx.x, rx.y, qh[q], ql[q]);
      }
    }
    // inter: (r 2^x 2^{C_p}) S_in
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t bh[4], bl[4];
      ldsm_t(bh, frag_row(&sm.s[0][0][0], kPad, 16 * s, 16 * jp, lane));
      ldsm_t(bl, frag_row(&sm.s[1][0][0], kPad, 16 * s, 16 * jp, lane));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float (&a)[4] = acc[2 * jp + h];
        mma(a, qh, bh[2 * h], bh[2 * h + 1]);
        mma(a, qh, bl[2 * h], bl[2 * h + 1]);
        mma(a, ql, bh[2 * h], bh[2 * h + 1]);
      }
    }
    // the diagonal block's lower-left quadrant (rows 8..15, keys 0..7 of
    // sub-chunk P), referenced at its step 7: (r_t 2^{x_t - c'_7})
    // (k_i 2^{c'_7 - c'_i}), both factors <= 1; A's rows 0..7 are zero.  The
    // k tile read as B[k = channel][n = key]: kf[0..1] = b0 of keys + 0 /
    // + 8, kf[2..3] their b1.
    {
      const int mid = kSub * P + 7, key = kSub * P + g;
      uint32_t kf[4], ah[4] = {0u, 0u, 0u, 0u}, al[4] = {0u, 0u, 0u, 0u}, kh[2], kl[2];
      ldsm(kf, frag_row(&sm.k[0][0], kPad, kSub * P, 16 * s, lane));
#pragma unroll
      for (int h = 0; h < 2; ++h) {        // channels ch0 + 8 h (+1)
        const int ch = ch0 + 8 * h;
        const float2 cm = f2(&sm.cp[mid][ch]);
        const float2 rr = unpack(rf[1 + 2 * h]);
        const float2 x = f2(&sm.cp[r1 - 1][ch]);
        split(rr.x * ex2(x.x - cm.x), rr.y * ex2(x.y - cm.y), ah[1 + 2 * h], al[1 + 2 * h]);
        const float2 kk = unpack(kf[2 * h]);
        const float2 ck = f2(&sm.cp[key][ch]);
        split(kk.x * ex2(cm.x - ck.x), kk.y * ex2(cm.y - ck.y), kh[h], kl[h]);
      }
      mma(att[2 * P], ah, kh[0], kh[1]);
      mma(att[2 * P], ah, kl[0], kl[1]);
      mma(att[2 * P], al, kh[0], kh[1]);
    }
    // off-diagonal: keys of sub-chunks q < P, k_i 2^{E_i}
#pragma unroll
    for (int q = 0; q < P; ++q) {
      uint32_t kf[4], kh[4], kl[4];
      ldsm(kf, frag_row(&sm.k[0][0], kPad, kSub * q, 16 * s, lane));
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int key = kSub * q + 8 * (f & 1) + g, ch = ch0 + 8 * (f >> 1);
        const float2 kk = unpack(kf[f]);
        const float2 ck = f2(&sm.cp[key][ch]);
        const float2 gq = f2(&sm.G[q][ch]);
        float2 e = make_float2(gq.x - ck.x, gq.y - ck.y);
#pragma unroll
        for (int m = q + 1; m < P; ++m) {
          const float2 gm = f2(&sm.G[m][ch]);
          e.x += gm.x;
          e.y += gm.y;
        }
        split(kk.x * ex2(e.x), kk.y * ex2(e.y), kh[f], kl[f]);
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        float (&a)[4] = att[2 * q + jj];
        mma(a, rh, kh[jj], kh[jj + 2]);
        mma(a, rh, kl[jj], kl[jj + 2]);
        mma(a, rl, kh[jj], kh[jj + 2]);
      }
    }
  }

  // the rest of the diagonal block, pairwise in fp32, with the bonus
  // r_t · (u ⊙ k_t) at i = t: row r0 against keys 0..7 and row r1 against
  // keys 8..15 (row r0 never reaches keys 8..15: att[2P + 1][0..1] stay 0).
#pragma unroll 2
  for (int ch = 0; ch < kN; ch += 2) {
    const float2 uu = f2(&sm.u[ch]);
#pragma unroll
    for (int jt = 0; jt < 2; ++jt) {
      const int lt = g + 8 * jt;           // row within the sub-chunk
      const float2 rr = bf2(&sm.r[jt ? r1 : r0][ch]);
      float2 x = jt ? f2(&sm.cp[r1 - 1][ch]) : f2(&sm.cp[x0row][ch]);
      if (!jt) { x.x *= x0on; x.y *= x0on; }
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int li = 8 * jt + 2 * c4 + e1;           // key within the sub-chunk
        const float2 kk = bf2(&sm.k[kSub * P + li][ch]);
        const float2 ck = f2(&sm.cp[kSub * P + li][ch]);
        float f0 = ex2(fminf(x.x - ck.x, 0.f)), f1 = ex2(fminf(x.y - ck.y, 0.f));
        f0 = li < lt ? f0 : (li == lt ? uu.x : 0.f);
        f1 = li < lt ? f1 : (li == lt ? uu.y : 0.f);
        float& a = att[2 * P + jt][2 * jt + e1];
        a = fmaf(rr.x * kk.x, f0, fmaf(rr.y * kk.y, f1, a));
      }
    }
  }

  // out += A v, A (16 x 16 (P + 1)) as bf16 hi + lo, v exact in bf16
#pragma unroll
  for (int s = 0; s <= P; ++s) {
    uint32_t ah[4], al[4];
    split(att[2 * s][0], att[2 * s][1], ah[0], al[0]);
    split(att[2 * s][2], att[2 * s][3], ah[1], al[1]);
    split(att[2 * s + 1][0], att[2 * s + 1][1], ah[2], al[2]);
    split(att[2 * s + 1][2], att[2 * s + 1][3], ah[3], al[3]);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t bv[4];
      ldsm_t(bv, frag_row(&sm.v[0][0], kPad, kSub * s, 16 * jp, lane));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mma(acc[2 * jp + h], ah, bv[2 * h], bv[2 * h + 1]);
        mma(acc[2 * jp + h], al, bv[2 * h], bv[2 * h + 1]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * c4;
    if (r0 < valid)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r0 * kN + col) =
          __floats2bfloat162_rn(acc[j][0], acc[j][1]);
    if (r1 < valid)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r1 * kN + col) =
          __floats2bfloat162_rn(acc[j][2], acc[j][3]);
  }
}

template <typename TW>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_out_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const TW* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s_in,
                bf16* __restrict__ out, int H, int T_len, int n_chunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  OutSmem& sm = *reinterpret_cast<OutSmem*>(smem_raw);
  const int tid = threadIdx.x;
  const int bh = blockIdx.x, ci = blockIdx.y;
  const int valid = min(kChunk, T_len - ci * kChunk);
  const size_t base = ((size_t)bh * T_len + (size_t)ci * kChunk) * kN;
  // S_in (fp32 [channel][column]) into registers, split into smem below
  float4 sv[kN * kN / 4 / kThreads];
  {
    const float4* src =
        reinterpret_cast<const float4*>(s_in + ((size_t)bh * n_chunks + ci) * kN * kN);
#pragma unroll
    for (int m = 0; m < kN * kN / 4 / kThreads; ++m) sv[m] = src[tid + kThreads * m];
  }
  // w first (its own group: the scan starts when it lands), raw into cp
  constexpr int kWStride = kPadF * sizeof(float) / sizeof(TW);
  const TW* wr = reinterpret_cast<const TW*>(&sm.cp[0][0]);
  stage_rows<kChunk, kN>(reinterpret_cast<TW*>(&sm.cp[0][0]), kWStride, w + base, valid);
  cp_async_commit();
  stage_rows<kChunk, kN>(&sm.r[0][0], kPad, r + base, valid);
  stage_rows<kChunk, kN>(&sm.k[0][0], kPad, k + base, valid);
  stage_rows<kChunk, kN>(&sm.v[0][0], kPad, v + base, valid);
  cp_async_commit();
  if (tid < kN) sm.u[tid] = u[(bh % H) * kN + tid];
  cp_async_wait<1>();
  __syncthreads();
  {  // c' and G: (channel, sub-chunk) pairs; every raw w is read before c'
     // overwrites it.  lg2.approx suffices here (its ~2^-22 error moves a
     // bf16 output far less than one rounding); the update pass keeps log2f
    const int ch = tid & (kN - 1);
    float lw[2][kSub];
#pragma unroll
    for (int rep = 0; rep < 2; ++rep)
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const int t = kSub * ((tid >> 6) + 2 * rep) + i;
        const float wt = to_f32(wr[t * kWStride + ch]);
        lw[rep][i] = t < valid ? __log2f(fmaxf(wt, kMinW)) : 0.f;
      }
    __syncthreads();
#pragma unroll
    for (int rep = 0; rep < 2; ++rep) {
      const int sub = (tid >> 6) + 2 * rep;
      float run = 0.f;
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        run += lw[rep][i];
        sm.cp[kSub * sub + i][ch] = run;
      }
      sm.G[sub][ch] = run;
    }
  }
#pragma unroll
  for (int m = 0; m < kN * kN / 4 / kThreads; ++m) {    // S_in as bf16 hi + lo
    const int idx = tid + kThreads * m, row = idx >> 4, col = (idx & 15) * 4;
    uint2 hi, lo;
    split(sv[m].x, sv[m].y, hi.x, lo.x);
    split(sv[m].z, sv[m].w, hi.y, lo.y);
    *reinterpret_cast<uint2*>(&sm.s[0][row][col]) = hi;
    *reinterpret_cast<uint2*>(&sm.s[1][row][col]) = lo;
  }
  cp_async_wait<0>();
  __syncthreads();
  const int lane = tid & 31;
  if (tid < kN) {                          // 2^{C_p}
    float c = 0.f;
#pragma unroll
    for (int p = 0; p < kSubs; ++p) {
      sm.pw[p][tid] = ex2(c);
      c += sm.G[p][tid];
    }
  }
  __syncthreads();
  bf16* o = out + base;
  switch (tid >> 5) {                      // warp p: sub-chunk p
    case 0: out_rows<0>(sm, o, valid, lane); break;
    case 1: out_rows<1>(sm, o, valid, lane); break;
    case 2: out_rows<2>(sm, o, valid, lane); break;
    default: out_rows<3>(sm, o, valid, lane); break;
  }
}

// The scratch holds, a chunk, S_in and U (64 x 64 fp32 each) and 2^G (64
// fp32): 2 * 64 * 64 + 64 floats, each region a run over all (bh, chunk).
template <typename TW>
cudaError_t launch_chunked(const void* r, const void* k, const void* v, const void* w,
                           const float* u, const float* s0, void* out, float* sT,
                           float* scratch, int B, int H, int T_len, cudaStream_t stream) {
  const int n_chunks = (T_len + kChunk - 1) / kChunk;
  if (n_chunks > 65535) return cudaErrorInvalidValue;       // grid y
  const size_t n = (size_t)B * H * n_chunks;
  float* s_in = scratch;
  float* upd = scratch + n * kN * kN;
  float* decay = scratch + n * 2 * kN * kN;
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const TW* wt = static_cast<const TW*>(w);
  const dim3 chunks(B * H, n_chunks);
  auto ku = wkv6_update_kernel<TW>;
  const int su = static_cast<int>(sizeof(UpdateSmem<TW>));
  cudaError_t err = cudaFuncSetAttribute(ku, cudaFuncAttributeMaxDynamicSharedMemorySize, su);
  if (err != cudaSuccess) return err;
  ku<<<chunks, kThreads, su, stream>>>(kb, vb, wt, upd, decay, T_len, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv6_scan_kernel<<<dim3(B * H, kN * kN / 4 / kScanThreads), kScanThreads, 0, stream>>>(
      upd, decay, s0, s_in, sT, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto ko = wkv6_out_kernel<TW>;
  const int so = static_cast<int>(sizeof(OutSmem));
  err = cudaFuncSetAttribute(ko, cudaFuncAttributeMaxDynamicSharedMemorySize, so);
  if (err != cudaSuccess) return err;
  ko<<<chunks, kThreads, so, stream>>>(static_cast<const bf16*>(r), kb, vb, wt, u, s_in,
                                       static_cast<bf16*>(out), H, T_len, n_chunks);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  r, k, v and out share `dtype`; w is
// float32 or `dtype` (`w_dtype`); u [H, 64], s0 and sT [B, H, 64, 64] are
// float32.  The caller picks the form: a `scratch` of B * H * ceil(T / 64) *
// (2 * 64 * 64 + 64) floats selects the chunked form (bf16 only), a null one
// the serial form.  The caller guarantees contiguous [B, H, T, 64] tensors
// with 16-byte aligned pointers, T >= 1, B * H <= 2^31 - 1, and that out, sT
// and scratch alias no input.  Returns a cudaError_t.
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v, const void* w,
                        const void* u, const void* s0, void* out, void* sT, void* scratch,
                        int B, int H, int T_len, int dtype, int w_dtype, void* stream) {
  if (B <= 0 || H <= 0 || T_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* sTf = static_cast<float*>(sT);
  float* sc = static_cast<float*>(scratch);
  cudaError_t err;
  if (sc != nullptr) {
    if (dtype == 1 && w_dtype == 0)
      err = launch_chunked<float>(r, k, v, w, uf, s0f, out, sTf, sc, B, H, T_len, s);
    else if (dtype == 1 && w_dtype == 1)
      err = launch_chunked<bf16>(r, k, v, w, uf, s0f, out, sTf, sc, B, H, T_len, s);
    else
      err = cudaErrorInvalidValue;
  } else if (dtype == 0 && w_dtype == 0) {
    err = launch_serial<float, float>(r, k, v, w, uf, s0f, out, sTf, B, H, T_len, s);
  } else if (dtype == 1 && w_dtype == 0) {
    err = launch_serial<bf16, float>(r, k, v, w, uf, s0f, out, sTf, B, H, T_len, s);
  } else if (dtype == 1 && w_dtype == 1) {
    err = launch_serial<bf16, bf16>(r, k, v, w, uf, s0f, out, sTf, B, H, T_len, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
