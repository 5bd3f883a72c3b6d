// RWKV-6 (Finch) WKV recurrence for Hopper (sm_90a): forward and backward.
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
// 2^x with x <= 0 and nothing overflows; it takes any T.  The backward,
// wkv6_bwd (section 3), replaces the reference's custom VJP, which has no
// Pallas kernel: repro/kernels/ops.py::_wkv6_bwd, the VJP of the sequential
// ref.wkv6.
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

// Copy ROWS rows of COLS values, starting at step `row0` of a [T_len, kN]
// tensor (row0 may be negative; row stride kN in global, `stride` in shared
// memory), asynchronously with NT threads, zero-filling the rows outside
// [0, T_len).  kRev stages steps row0, row0 - 1, ... (time reversed).  The
// shape is compiled in, so each thread's copies unroll.
template <int ROWS, int COLS, int NT = kThreads, bool kRev = false, typename E>
__device__ __forceinline__ void stage_rows(E* dst, int stride, const E* src, int row0, int T_len) {
  constexpr int kPerRow = COLS * sizeof(E) / 16;
  constexpr int kCopies = ROWS * kPerRow;
#pragma unroll
  for (int m = 0; m < (kCopies + NT - 1) / NT; ++m) {
    const int i = threadIdx.x + m * NT;
    if (kCopies % NT == 0 || i < kCopies) {
      const int row = i / kPerRow, col = (i % kPerRow) * (16 / sizeof(E));
      const int t = kRev ? row0 - row : row0 + row;
      const bool ok = t >= 0 && t < T_len;
      cp_async16(dst + row * stride + col, src + (ok ? (size_t)t * kN + col : 0), ok);
    }
  }
}

// kRev runs time backwards (step T - 1 first): the WKV backward's dv pass,
// which is this same recurrence on the cotangents (wkv6_bwd below).  A null
// s0 starts from zero; a null out or sT is not written.
template <typename T, typename TW, bool kRev>
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

  // ring stage bi holds steps bi * kSteps .. (the last kSteps, reversed, with kRev)
  auto load = [&](int bi, int b) {
    const int row0 = kRev ? T_len - kSteps - bi * kSteps : bi * kSteps;
    stage_rows<kSteps, kN>(&sm.r[b][0][0], kN, r + base, row0, T_len);
    stage_rows<kSteps, kN>(&sm.k[b][0][0], kN, k + base, row0, T_len);
    stage_rows<kSteps, kN>(&sm.w[b][0][0], kN, w + base, row0, T_len);
    stage_rows<kSteps, kSlice>(&sm.v[b][0][0], kSlice, v + base + v0, row0, T_len);
  };

  float S[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) S[q] = s0 ? s0[sbase + (size_t)(8 * grp + q) * kN] : 0.f;

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
      const int si = kRev ? kSteps - 1 - i : i;             // row in the stage
      float rr[8], kk[8], ww[8];
      load8(&sm.r[b][si][8 * grp], rr);
      load8(&sm.k[b][si][8 * grp], kk);
      load8(&sm.w[b][si][8 * grp], ww);
      const float vj = to_f32(sm.v[b][si][col]);
      float y = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        y = fmaf(rr[q], S[q], y);
        S[q] = fmaf(ww[q], S[q], kk[q] * vj);
      }
#pragma unroll
      for (int d = 1; d < 8; d <<= 1) y += __shfl_xor_sync(0xffffffffu, y, d);
      const int t = kRev ? T_len - 1 - (bi * kSteps + i) : bi * kSteps + i;
      if (grp == 0 && out != nullptr)
        store(out + base + (size_t)t * kN + v0 + col, y + vj * sm.beta[si]);
    }
    __syncthreads();                       // stage b and beta are consumed
    if (bi + 2 < n_blk) load(bi + 2, b);
    cp_async_commit();
  }
  if (sT != nullptr) {
#pragma unroll
    for (int q = 0; q < 8; ++q) sT[sbase + (size_t)(8 * grp + q) * kN] = S[q];
  }
}

template <typename T, typename TW, bool kRev = false>
cudaError_t launch_serial(const void* r, const void* k, const void* v, const void* w,
                          const float* u, const float* s0, void* out, float* sT, int B,
                          int H, int T_len, cudaStream_t stream) {
  wkv6_serial_kernel<T, TW, kRev><<<dim3(B * H, kN / kSlice), kThreads, 0, stream>>>(
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

// The passes below run forwards in time, or with kRev backwards (the WKV
// backward, section 3): a chunk's steps are then staged last first, so
// staged row l is step 63 - l of the chunk, and the steps past T (the last
// chunk's tail) are its first rows.  Whether staged row t is a step before T:
template <bool kRev>
__device__ __forceinline__ bool live(int t, int valid) {
  return kRev ? t >= kChunk - valid : t < valid;
}

__device__ __forceinline__ float2 unpack(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}
__device__ __forceinline__ float2 bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 f2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// acc += op^T tile over the steps 16 s .. 16 s + 15, for the state rows
// row0 .. row0 + 15 and columns col0 .. col0 + 8 NJ - 1 (acc in mma
// layout): op a [channel][step] operand as bf16 hi and lo planes, tile a
// [step][column] tile exact in bf16.  Every state update of the chunked
// forms is this product.
template <int NJ>
__device__ __forceinline__ void state_mma(float (&acc)[NJ][4], const bf16* oph, const bf16* opl,
                                          const bf16* tile, int s, int row0, int col0,
                                          int lane) {
  uint32_t ah[4], al[4];
  ldsm(ah, frag_row(oph, kPad, row0, 16 * s, lane));
  ldsm(al, frag_row(opl, kPad, row0, 16 * s, lane));
#pragma unroll
  for (int jp = 0; jp < NJ / 2; ++jp) {
    uint32_t b[4];
    ldsm_t(b, frag_row(tile, kPad, 16 * s, col0 + 16 * jp, lane));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mma(acc[2 * jp + h], ah, b[2 * h], b[2 * h + 1]);
      mma(acc[2 * jp + h], al, b[2 * h], b[2 * h + 1]);
    }
  }
}

// Rows row0 .. row0 + 15 of a [64, 64] fp32 state from mma layout.
__device__ __forceinline__ void store_state(const float (&acc)[8][4], float* dst, int row0,
                                            int lane) {
  float* p = dst + (size_t)(row0 + (lane >> 2)) * kN + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<float2*>(p + 8 * j) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(p + 8 * j + 8 * kN) = make_float2(acc[j][2], acc[j][3]);
  }
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
  stage_rows<kChunk, kN>(&sm.k[0][0], kN, k + base, 0, valid);
  stage_rows<kChunk, kN>(&sm.w[0][0], kN, w + base, 0, valid);
  cp_async_commit();
  stage_rows<kChunk, kN>(&sm.v[0][0], kPad, v + base, 0, valid);
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
  float d[8][4] = {};
#pragma unroll
  for (int s = 0; s < kChunk / 16; ++s)
    state_mma(d, &sm.kt[0][0][0], &sm.kt[1][0][0], &sm.v[0][0], s, rows, 0, lane);
  store_state(d, upd + chunk * kN * kN, rows, lane);
}

// -- 1b. State scan, elementwise: S_in[c] = S, S <- 2^{G_c} ⊙ S + U_c, serial
//    over the chunks but with no dependence between state elements: each
//    thread owns 4 of one head's 4096 and streams U and 2^G ahead of use
//    (kScanAhead chunks of loads in flight), so the pass runs at the rate at
//    which it can read U and write S_in.  kRev runs the chunks last to
//    first; a null s0 starts from zero, a null sT is not written; s_in may
//    be upd (each thread reads a chunk's U before it writes its S_in).

constexpr int kScanThreads = 256;
constexpr int kScanAhead = 8;

template <bool kRev = false, bool kBwd = false>
__global__ void __launch_bounds__(kScanThreads)
wkv6_scan_kernel(const float* upd, const float* __restrict__ decay,
                 const float* __restrict__ s0, float* s_in, float* __restrict__ sT,
                 int n_chunks) {
  const int bh = blockIdx.x;
  const int idx = blockIdx.y * kScanThreads + threadIdx.x;   // float4 of the head's state
  const int row = idx >> 4;                                 // 16 float4 a row of 64
  const size_t head = (size_t)bh * n_chunks;
  auto at = [&](int c) { return head + (kRev ? n_chunks - 1 - c : c); };
  float4 S = s0 ? reinterpret_cast<const float4*>(s0 + (size_t)bh * kN * kN)[idx]
                : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 u4[kScanAhead];
  float dec[kScanAhead];
  auto fetch = [&](int c0) {
#pragma unroll
    for (int a = 0; a < kScanAhead; ++a) {
      if (c0 + a < n_chunks) {
        const size_t chunk = at(c0 + a);
        u4[a] = reinterpret_cast<const float4*>(upd + chunk * kN * kN)[idx];
        dec[a] = decay[chunk * kN + row];
      }
    }
  };
  fetch(0);
  for (int c0 = 0; c0 < n_chunks; c0 += kScanAhead) {
    // this batch out of u4, the next one's loads issued before its stores
    // (in place, they read other chunks)
    float4 cu[kScanAhead];
    float cd[kScanAhead];
#pragma unroll
    for (int a = 0; a < kScanAhead; ++a) {
      cu[a] = u4[a];
      cd[a] = dec[a];
    }
    fetch(c0 + kScanAhead);
#pragma unroll
    for (int a = 0; a < kScanAhead; ++a) {
      if (c0 + a < n_chunks) {
        reinterpret_cast<float4*>(s_in + at(c0 + a) * kN * kN)[idx] = S;
        S.x = fmaf(cd[a], S.x, cu[a].x);
        S.y = fmaf(cd[a], S.y, cu[a].y);
        S.z = fmaf(cd[a], S.z, cu[a].z);
        S.w = fmaf(cd[a], S.w, cu[a].w);
      }
    }
  }
  if (sT != nullptr) reinterpret_cast<float4*>(sT + (size_t)bh * kN * kN)[idx] = S;
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
template <int P, bool kRev>
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
  const int o0 = kRev ? kChunk - 1 - r0 : r0, o1 = kRev ? kChunk - 1 - r1 : r1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * c4;
    if (live<kRev>(r0, valid))
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)o0 * kN + col) =
          __floats2bfloat162_rn(acc[j][0], acc[j][1]);
    if (live<kRev>(r1, valid))
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)o1 * kN + col) =
          __floats2bfloat162_rn(acc[j][2], acc[j][3]);
  }
}

template <typename TW, bool kRev = false>
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
  const int row0 = kRev ? kChunk - 1 : 0;
  stage_rows<kChunk, kN, kThreads, kRev>(reinterpret_cast<TW*>(&sm.cp[0][0]), kWStride,
                                         w + base, row0, valid);
  cp_async_commit();
  stage_rows<kChunk, kN, kThreads, kRev>(&sm.r[0][0], kPad, r + base, row0, valid);
  stage_rows<kChunk, kN, kThreads, kRev>(&sm.k[0][0], kPad, k + base, row0, valid);
  stage_rows<kChunk, kN, kThreads, kRev>(&sm.v[0][0], kPad, v + base, row0, valid);
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
        lw[rep][i] = live<kRev>(t, valid) ? __log2f(fmaxf(wt, kMinW)) : 0.f;
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
    case 0: out_rows<0, kRev>(sm, o, valid, lane); break;
    case 1: out_rows<1, kRev>(sm, o, valid, lane); break;
    case 2: out_rows<2, kRev>(sm, o, valid, lane); break;
    default: out_rows<3, kRev>(sm, o, valid, lane); break;
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
  wkv6_scan_kernel<><<<dim3(B * H, kN * kN / 4 / kScanThreads), kScanThreads, 0, stream>>>(
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


// ---------------------------------------------------------------------------
// 3. Backward (wkv6_bwd)
// ---------------------------------------------------------------------------
//
// With G_t = dL/dS_t (G_T = dS_T) and S_t the state before step t:
//   dr_t = S_t dout_t + u ⊙ k_t (v_t · dout_t)       (row sums over V)
//   dk_t = G_{t+1} v_t + r_t ⊙ u (v_t · dout_t)
//   dw_t = rowsum(G_{t+1} ⊙ S_t)
//   du   = sum over b, t of r_t ⊙ k_t (v_t · dout_t)
//   dv_t = G_{t+1}^T k_t + (r_t · (u ⊙ k_t)) dout_t  (column sums over K)
//   G_t  = diag(w_t) G_{t+1} + r_t ⊗ dout_t,           ds0 = G_0
//
// The G recurrence is the forward one run backwards in time on (r', k', v')
// = (k, r, dout) from S'_0 = dS_T: its output is dv, its final state ds0.
// S_t is never got back by dividing by w (w = exp(-exp(x)) underflows to
// 0), so neither form uses the identity w_t dw_t = ... of other chunked
// backwards.  Two forms, picked by the wrapper as the forward's are
// (kernels/wkv6.py::uses_chunked_form, passed in as `chunked`):
//
// 3a. bf16 r/k/v with T >= 64 (the training call): the chunked form, six
//     launches, products on mma.sync tensor cores, the longest serial chain
//     64 steps (a chunk's scan) instead of T:
//   (1) wkv6_bwd_update_kernel, one block a (bh, chunk), all in parallel:
//       what each chunk adds to the state, U_c = (k ⊙ 2^D)^T v (D the sum
//       of lw after each step in the chunk), and to G going backwards,
//       W_c = (r ⊙ 2^P)^T dout (P the sum of lw before each step), and the
//       chunk's decay 2^{G_c}: the forward's update (1a) for both at once.
//   (2) S_in, the state entering every chunk: the forward's scan (1b) from
//       s0, written over U in place.
//   (3) G_out, dL/dS leaving every chunk, and ds0: the same scan last chunk
//       first from dS_T (or 0), G_in = 2^{G_c} ⊙ G_out + W_c, over W.
//   (4) dv: the forward's output pass (1c) backwards in time on (k, r,
//       dout) from each chunk's G_out.
//   (5) wkv6_bwd_chunk_kernel, one block a (bh, chunk), all in parallel:
//       dr, dk, dw and a du partial from S_in and G_out (below).
//   (6) wkv6_du_kernel: du summed over the chunks and the batch, in order.
//   No atomics: two calls give the same bits.  Launches (2)-(4) are the
//   forward's kernels with a template flag true (kBwd or kRev), so a
//   profile files their time under the backward.
//
//   The chunk pass cuts the chunk into four sub-chunks p of 16 steps and
//   works with products of w over them, formed by running products (no
//   log, no exp, no division, and w = 0 gives exact zeros as in the
//   sequential reference): x_t over the steps of p before t, y_t over those
//   after t, g_p over all 16, D[t,i] over the steps strictly between i and
//   t.  The states at p's edges, S_p entering it and Γ_p leaving it, follow
//   from S_in and G_out by S_{p+1} = g_p ⊙ S_p + (k ⊙ y)_p^T v_p and
//   Γ_{p-1} = g_p ⊙ Γ_p + (r ⊙ x)_p^T dout_p (mma, the fp32 operand as
//   bf16 hi + lo).  Then, with Z_t = S_p dout_t, X_t = Γ_p v_t (mma, the
//   state as hi + lo B operands straight from its accumulators),
//   A[t,i] = dout_t · v_i (mma, exact) and c_p = rowsum(S_p ⊙ Γ_p):
//     dr_t = x_t Z_t + sum_{i<t} A[t,i] D[t,i] k_i + u k_t A[t,t]
//     dk_t = y_t X_t + sum_{j>t} A[j,t] D[j,t] r_j + u r_t A[t,t]
//     dw_t = x_t y_t c_p + y_t sum_{i<t} D[t,i] k_i X_i
//            + x_t sum_{j>t} D[j,t] r_j Z_j + sum_{i<t<j} D[t,i] D[j,t] k_i r_j A[j,i]
//   (i, j within p), which is rowsum(G_{t+1} ⊙ S_t) with
//   S_t = x_t S_p + sum_{i<t} D[t,i] k_i v_i^T and
//   G_{t+1} = y_t Γ_p + sum_{j>t} D[j,t] r_j dout_j^T expanded.  Warp
//   (rows 16 rg, sub-chunks 2 h and 2 h + 1) steps S_in forward and G_out
//   back to its sub-chunks' edges and forms Z, X and c there (four or six
//   chain steps a warp); then thread (p, channel) walks its 16 steps in fp32
//   registers and writes dr, dk, dw: the sums over i < t are recurrences
//   in t (M[j] = sum_{i<t} D[t,i] k_i A[j,i] <- w_t M[j] + k_t A[j,t], of
//   which dr_t takes M[t] and the triple sum sum_{j>t} D[j,t] r_j M[j]),
//   those over j > t run over the products D[j,t] r_j formed afresh.  The scratch
//   holds U then S_in, W then G_out, 2^G and the du partials: 2 * 64 * 64 +
//   2 * 64 floats a chunk (B·H·ceil(T/64) chunks; 135 MB at the training
//   call).
//   ref.wkv6_subchunked_bwd mirrors this arithmetic in plain torch.
//
// 3b. fp32, or T < 64: the serial form, four launches, fp32 math on the CUDA
//     cores (TF32 would break the fp32 tolerance of 1e-3).  Rows of S and G
//     evolve independently (the decay is per row), and so do their columns,
//     so each sum has a pass laid out for it:
//   (a) wkv6_ckpt_kernel, grid (B·H, 4), elementwise: S_{64 c} for every
//       chunk c into a scratch (S_0 = s0), 4 state elements a thread, 64
//       steps of k, w and v staged in shared memory at a time.
//   (b) wkv6_serial_kernel<kRev = true> on (k, r, dout) from dS_T: dv, ds0.
//   (c) wkv6_bwd_rows_kernel, grid (B·H, 4 blocks of 16 rows), 256 threads:
//       16 threads a row, 4 columns each.  Chunks run last to first: stage
//       the chunk's inputs, run forward from the chunk's checkpoint (dr, and
//       S at every 16th step into shared memory), then backwards by
//       sub-chunks of 16 steps: recompute the sub-chunk's 16 states into
//       registers and step G back through them (dk, dw, du).  A row's sums
//       over its 16 threads are warp shuffles within a half-warp.
//   (d) wkv6_du_kernel: du summed over the batch, in order.
//
// Bound at the training call (B 2, H 32, T 4096, bf16 r/k/v/dout/dr/dk/dv,
// fp32 w/dw): 372 MB to move, 111 us at 3.35 TB/s; the chunked form's
// products are ten 64 x 64 x 64 a chunk, 21.7 us of bf16 tensor-core time,
// so it is bound by bytes.  Its scratch is written and read on top of that.

constexpr int kBwdRows = 16;      // state rows a block of the rows pass owns
constexpr int kBwdSub = 16;       // steps a sub-chunk of the rows pass
constexpr int kBwdThreads = 256;  // kBwdRows rows x 16 threads of 4 columns

template <typename T, typename TW>
__global__ void __launch_bounds__(kBwdThreads)
wkv6_ckpt_kernel(const T* __restrict__ k, const T* __restrict__ v, const TW* __restrict__ w,
                 const float* __restrict__ s0, float* __restrict__ ckpt, int T_len, int n_chunks) {
  __shared__ __align__(16) float kk[kChunk][kN];
  __shared__ __align__(16) float ww[kChunk][kN];
  __shared__ float vv[kChunk][kSlice];
  const int tid = threadIdx.x, col = tid & (kSlice - 1), rg = tid >> 4;   // rows 4 rg ..
  const int bh = blockIdx.x, v0 = blockIdx.y * kSlice;
  const size_t base = (size_t)bh * T_len * kN;
  const size_t off = (size_t)(4 * rg) * kN + v0 + col;
  float S[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) S[q] = s0[(size_t)bh * kN * kN + off + (size_t)q * kN];
  for (int c = 0; c < n_chunks; ++c) {
    float* dst = ckpt + ((size_t)bh * n_chunks + c) * kN * kN + off;
#pragma unroll
    for (int q = 0; q < 4; ++q) dst[(size_t)q * kN] = S[q];
    if (c == n_chunks - 1) break;          // the last chunk's steps are not needed
    const size_t g = base + (size_t)c * kChunk * kN;       // a whole chunk: 64 steps
    __syncthreads();
    for (int i = tid; i < kChunk * kN; i += kBwdThreads) {
      kk[i / kN][i % kN] = to_f32(k[g + i]);
      ww[i / kN][i % kN] = to_f32(w[g + i]);
    }
    for (int i = tid; i < kChunk * kSlice; i += kBwdThreads)
      vv[i / kSlice][i % kSlice] = to_f32(v[g + (size_t)(i / kSlice) * kN + v0 + i % kSlice]);
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < kChunk; ++t) {
      const float4 wq = *reinterpret_cast<const float4*>(&ww[t][4 * rg]);
      const float4 kq = *reinterpret_cast<const float4*>(&kk[t][4 * rg]);
      const float x = vv[t][col];
      S[0] = fmaf(wq.x, S[0], kq.x * x);
      S[1] = fmaf(wq.y, S[1], kq.y * x);
      S[2] = fmaf(wq.z, S[2], kq.z * x);
      S[3] = fmaf(wq.w, S[3], kq.w * x);
    }
  }
}

struct RowsSmem {
  float v[kChunk][kN];
  float d[kChunk][kN];            // dout
  float r[kChunk][kBwdRows];      // the block's rows of r, k, w
  float k[kChunk][kBwdRows];
  float w[kChunk][kBwdRows];
  float vd[kChunk];               // v_t · dout_t
  float sub[kChunk / kBwdSub][kBwdRows][kN];   // S at each sub-chunk's start
  float dr[kChunk][kBwdRows];     // the chunk's outputs
  float dk[kChunk][kBwdRows];
  float dw[kChunk][kBwdRows];
};

// Sum over the 16 lanes of a half-warp (one state row).
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}
__device__ __forceinline__ float4 axpy4(float a, float4 x, float b, float4 y) {   // a x + b y
  return make_float4(fmaf(a, x.x, b * y.x), fmaf(a, x.y, b * y.y), fmaf(a, x.z, b * y.z),
                     fmaf(a, x.w, b * y.w));
}

template <typename T, typename TW>
__global__ void __launch_bounds__(kBwdThreads)
wkv6_bwd_rows_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                     const TW* __restrict__ w, const float* __restrict__ u,
                     const T* __restrict__ dout, const float* __restrict__ dsT,
                     const float* __restrict__ ckpt, T* __restrict__ dr, T* __restrict__ dk,
                     TW* __restrict__ dw, float* __restrict__ du_part, int H, int T_len,
                     int n_chunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  RowsSmem& sm = *reinterpret_cast<RowsSmem*>(smem_raw);
  const int tid = threadIdx.x, row = tid >> 4, c0 = 4 * (tid & 15);
  const int bh = blockIdx.x, k0 = blockIdx.y * kBwdRows;
  const int K = k0 + row;                                  // this thread's state row
  const size_t base = (size_t)bh * T_len * kN;
  const size_t state = (size_t)bh * kN * kN + (size_t)K * kN + c0;
  const float uk = u[(bh % H) * kN + K];
  float4 G = dsT ? ld4(dsT + state) : make_float4(0.f, 0.f, 0.f, 0.f);
  float du = 0.f;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk, n = min(kChunk, T_len - t0);
    __syncthreads();                       // the last chunk's outputs are out
    for (int i = tid; i < kChunk * kN; i += kBwdThreads) {
      const int t = i / kN;
      const size_t g = base + (size_t)t0 * kN + i;
      sm.v[t][i % kN] = t < n ? to_f32(v[g]) : 0.f;
      sm.d[t][i % kN] = t < n ? to_f32(dout[g]) : 0.f;
    }
    for (int i = tid; i < kChunk * kBwdRows; i += kBwdThreads) {
      const int t = i / kBwdRows, j = i % kBwdRows;
      const size_t g = base + (size_t)(t0 + t) * kN + k0 + j;
      sm.r[t][j] = t < n ? to_f32(r[g]) : 0.f;
      sm.k[t][j] = t < n ? to_f32(k[g]) : 0.f;
      sm.w[t][j] = t < n ? to_f32(w[g]) : 0.f;
    }
    __syncthreads();
    {  // v_t · dout_t: 4 lanes a step
      const int t = tid >> 2, q = tid & 3;
      float x = 0.f;
#pragma unroll
      for (int j = q * (kN / 4); j < (q + 1) * (kN / 4); ++j) x = fmaf(sm.v[t][j], sm.d[t][j], x);
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      if (q == 0) sm.vd[t] = x;
    }
    __syncthreads();
    // forward through the chunk from its checkpoint: dr, and S at each
    // sub-chunk's start
    float4 S = ld4(ckpt + ((size_t)bh * n_chunks + c) * kN * kN + (size_t)K * kN + c0);
#pragma unroll 1
    for (int s = 0; s < kChunk / kBwdSub; ++s) {
      *reinterpret_cast<float4*>(&sm.sub[s][row][c0]) = S;
#pragma unroll 4
      for (int i = 0; i < kBwdSub; ++i) {
        const int t = s * kBwdSub + i;
        if (t >= n) break;                 // uniform over the block
        const float a = row_sum(dot4(S, ld4(&sm.d[t][c0])));
        const float kt = sm.k[t][row];
        if ((tid & 15) == 0) sm.dr[t][row] = fmaf(uk * kt, sm.vd[t], a);
        S = axpy4(sm.w[t][row], S, kt, ld4(&sm.v[t][c0]));
      }
    }
    // backwards, a sub-chunk at a time: its 16 states recomputed into
    // registers, then G stepped back through them
#pragma unroll 1
    for (int s = kChunk / kBwdSub - 1; s >= 0; --s) {
      if (s * kBwdSub >= n) continue;      // uniform over the block
      float4 hist[kBwdSub];
      float4 x = ld4(&sm.sub[s][row][c0]);
#pragma unroll
      for (int i = 0; i < kBwdSub; ++i) {
        const int t = s * kBwdSub + i;
        hist[i] = x;
        x = axpy4(sm.w[t][row], x, sm.k[t][row], ld4(&sm.v[t][c0]));
      }
#pragma unroll
      for (int i = kBwdSub - 1; i >= 0; --i) {
        const int t = s * kBwdSub + i;
        if (t < n) {                       // uniform over the block
          const float b = row_sum(dot4(G, ld4(&sm.v[t][c0])));
          const float q = row_sum(dot4(G, hist[i]));
          const float rt = sm.r[t][row];
          if ((tid & 15) == 0) {
            const float x1 = sm.vd[t];
            sm.dk[t][row] = fmaf(rt * uk, x1, b);
            sm.dw[t][row] = q;
            du = fmaf(rt * sm.k[t][row], x1, du);
          }
          G = axpy4(sm.w[t][row], G, rt, ld4(&sm.d[t][c0]));
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < kChunk * kBwdRows; i += kBwdThreads) {
      const int t = i / kBwdRows, j = i % kBwdRows;
      if (t < n) {
        const size_t g = base + (size_t)(t0 + t) * kN + k0 + j;
        store(dr + g, sm.dr[t][j]);
        store(dk + g, sm.dk[t][j]);
        store(dw + g, sm.dw[t][j]);
      }
    }
  }
  if ((tid & 15) == 0) du_part[(size_t)bh * kN + K] = du;
}

// du[h] = the sum of each (b, h)'s n_parts partials over b and the parts:
// block h, thread (q, channel) sums every fourth part of each b in order,
// then the four sums are added in order (deterministic: no atomics).
__global__ void __launch_bounds__(kBwdThreads)
wkv6_du_kernel(const float* __restrict__ du_part, float* __restrict__ du, int B, int H,
               int n_parts) {
  __shared__ float part[kBwdThreads / kN][kN];
  const int h = blockIdx.x, ch = threadIdx.x % kN, q = threadIdx.x / kN;
  constexpr int kQ = kBwdThreads / kN;
  float x = 0.f;
  for (int b = 0; b < B; ++b) {
    const float* src = du_part + ((size_t)b * H + h) * n_parts * kN + ch;
#pragma unroll 4
    for (int c = q; c < n_parts; c += kQ) x += src[(size_t)c * kN];
  }
  part[q][ch] = x;
  __syncthreads();
  if (q == 0) {
    float y = part[0][ch];
#pragma unroll
    for (int j = 1; j < kQ; ++j) y += part[j][ch];
    du[h * kN + ch] = y;
  }
}

template <typename T, typename TW>
cudaError_t launch_bwd_serial(const void* r, const void* k, const void* v, const void* w,
                       const float* u, const float* s0, const void* dout, const float* dsT,
                       void* dr, void* dk, void* dv, void* dw, float* du, float* ds0,
                       float* scratch, int B, int H, int T_len, cudaStream_t stream) {
  const int n_chunks = (T_len + kChunk - 1) / kChunk;
  float* ckpt = scratch;
  float* du_part = scratch + (size_t)B * H * n_chunks * kN * kN;
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const TW* wt = static_cast<const TW*>(w);
  const dim3 grid(B * H, kN / kBwdRows);
  wkv6_ckpt_kernel<T, TW><<<dim3(B * H, kN / kSlice), kBwdThreads, 0, stream>>>(
      kt, vt, wt, s0, ckpt, T_len, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // dv and ds0: the forward recurrence backwards in time on (k, r, dout)
  err = launch_serial<T, TW, true>(k, r, dout, w, u, dsT, dv, ds0, B, H, T_len, stream);
  if (err != cudaSuccess) return err;
  auto kr = wkv6_bwd_rows_kernel<T, TW>;
  const int sr = static_cast<int>(sizeof(RowsSmem));
  err = cudaFuncSetAttribute(kr, cudaFuncAttributeMaxDynamicSharedMemorySize, sr);
  if (err != cudaSuccess) return err;
  kr<<<grid, kBwdThreads, sr, stream>>>(rt, kt, vt, wt, u, static_cast<const T*>(dout), dsT,
                                        ckpt, static_cast<T*>(dr), static_cast<T*>(dk),
                                        static_cast<TW*>(dw), du_part, H, T_len, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv6_du_kernel<<<H, kBwdThreads, 0, stream>>>(du_part, du, B, H, 1);
  return cudaGetLastError();
}

// -- 3a (1). Both chunk updates, one block a (bh, chunk), 8 warps: what the
//    chunk adds to the state, U = k~^T v with k~_t = k_t 2^{D_t} (D_t the
//    sum of lw after step t in the chunk), and to G going backwards,
//    W = r~^T dout with r~_t = r_t 2^{P_t} (P_t the sum of lw before t),
//    and the chunk's decay 2^G.  Thread (quarter, channel) takes 16 steps;
//    D_t and P_t are direct sums (the quarters' totals before or after its
//    own, then a running sum), never a difference of large sums.  Warps 0-3
//    form U, 4-7 W (16 state rows a warp, the fp32 operand as hi + lo).

constexpr int kCbThreads = 256;

template <typename TW>
struct BwdUpdateSmem {
  bf16 k[kChunk][kN];
  bf16 r[kChunk][kN];
  TW w[kChunk][kN];
  bf16 v[kChunk][kPad];
  bf16 d[kChunk][kPad];           // dout
  bf16 kt[2][kN][kPad];           // k~ hi, lo: [channel][step]
  bf16 rt[2][kN][kPad];           // r~
  float tot[kSubs][kN];           // sum of lw over each quarter
};

template <typename TW>
__global__ void __launch_bounds__(kCbThreads, 2)
wkv6_bwd_update_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const TW* __restrict__ w, float* __restrict__ upd_s,
                       float* __restrict__ upd_g, float* __restrict__ decay, int T_len,
                       int n_chunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdUpdateSmem<TW>& sm = *reinterpret_cast<BwdUpdateSmem<TW>*>(smem_raw);
  const int tid = threadIdx.x;
  const int bh = blockIdx.x, ci = blockIdx.y;
  const int valid = min(kChunk, T_len - ci * kChunk);
  const size_t base = ((size_t)bh * T_len + (size_t)ci * kChunk) * kN;
  const size_t chunk = (size_t)bh * n_chunks + ci;
  stage_rows<kChunk, kN, kCbThreads>(&sm.k[0][0], kN, k + base, 0, valid);
  stage_rows<kChunk, kN, kCbThreads>(&sm.r[0][0], kN, r + base, 0, valid);
  stage_rows<kChunk, kN, kCbThreads>(&sm.w[0][0], kN, w + base, 0, valid);
  cp_async_commit();
  stage_rows<kChunk, kN, kCbThreads>(&sm.v[0][0], kPad, v + base, 0, valid);
  stage_rows<kChunk, kN, kCbThreads>(&sm.d[0][0], kPad, dout + base, 0, valid);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  const int ch = tid & (kN - 1), qt = tid >> 6;      // steps 16 qt ..
  float lw[kSub], tot = 0.f;
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int t = kSub * qt + i;
    lw[i] = t < valid ? log2w(to_f32(sm.w[t][ch])) : 0.f;
    tot += lw[i];
  }
  sm.tot[qt][ch] = tot;
  __syncthreads();
  float pre = 0.f, suf = 0.f;
#pragma unroll
  for (int q = 0; q < kSubs; ++q) {
    const float x = sm.tot[q][ch];
    if (q < qt) pre += x;
    if (q > qt) suf += x;
  }
  if (qt == 0)
    decay[chunk * kN + ch] =
        exp2f(((sm.tot[0][ch] + sm.tot[1][ch]) + sm.tot[2][ch]) + sm.tot[3][ch]);
  float xk[kSub], xr[kSub];
#pragma unroll
  for (int i = kSub - 1; i >= 0; --i) {
    xk[i] = __bfloat162float(sm.k[kSub * qt + i][ch]) * exp2f(suf);
    suf += lw[i];
  }
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    xr[i] = __bfloat162float(sm.r[kSub * qt + i][ch]) * exp2f(pre);
    pre += lw[i];
  }
#pragma unroll
  for (int i = 0; i < kSub; i += 2) {
    const int t = kSub * qt + i;
    uint32_t hi, lo;
    split(xk[i], xk[i + 1], hi, lo);
    *reinterpret_cast<uint32_t*>(&sm.kt[0][ch][t]) = hi;
    *reinterpret_cast<uint32_t*>(&sm.kt[1][ch][t]) = lo;
    split(xr[i], xr[i + 1], hi, lo);
    *reinterpret_cast<uint32_t*>(&sm.rt[0][ch][t]) = hi;
    *reinterpret_cast<uint32_t*>(&sm.rt[1][ch][t]) = lo;
  }
  cp_async_wait<0>();
  __syncthreads();
  const int lane = tid & 31, wp = tid >> 5, rows = kSub * (wp & 3);
  const bool su = wp < 4;
  float acc[8][4] = {};
#pragma unroll
  for (int s = 0; s < kChunk / 16; ++s)
    state_mma(acc, su ? &sm.kt[0][0][0] : &sm.rt[0][0][0],
              su ? &sm.kt[1][0][0] : &sm.rt[1][0][0], su ? &sm.v[0][0] : &sm.d[0][0], s, rows,
              0, lane);
  store_state(acc, (su ? upd_s : upd_g) + chunk * kN * kN, rows, lane);
}

// -- 3a (5). The chunk pass: one block a (bh, chunk), 8 warps.

struct ChunkBwdSmem {
  bf16 v[kChunk][kPad];
  bf16 d[kChunk][kPad];           // dout
  bf16 ky[2][kN][kPad];           // (k ⊙ y)^T as bf16 hi, lo: [channel][step]
  bf16 rx[2][kN][kPad];           // (r ⊙ x)^T
  // Z_t = S_p dout_t and X_t = Γ_p v_t, [step][channel]; before them the
  // chunk's r, k and w as loaded ([step][channel], 64 wide)
  float sd[kChunk][kPadF];
  float gv[kChunk][kPadF];
  float a[kSubs][kSub][kSub + 4]; // A_p = dout_p v_p^T, [t][i]
  float c[kSubs][kN];             // rowsum(S_p ⊙ Γ_p)
  float g[kSubs][kN];             // products of w over each sub-chunk
  float du[kSubs][kN];
  float u[kN];
};

// Rows ch0 .. ch0 + 15, columns col0 .. col0 + 8 NJ - 1 of a [64, 64] fp32
// state, in mma accumulator layout.
template <int NJ>
__device__ __forceinline__ void load_state(float (&st)[NJ][4], const float* __restrict__ src,
                                           int ch0, int col0, int lane) {
  const int g = lane >> 2, c4 = lane & 3;
  const float* p = src + (size_t)(ch0 + g) * kN + col0 + 2 * c4;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float2 lo = f2(p + 8 * j), hi = f2(p + 8 * j + 8 * kN);
    st[j][0] = lo.x; st[j][1] = lo.y; st[j][2] = hi.x; st[j][3] = hi.y;
  }
}

// One sub-chunk q of a state's chain on those rows and columns:
// st <- gq ⊙ st + op_q^T tile_q, op = (k ⊙ y)^T or (r ⊙ x)^T as hi + lo
// ([channel][step] rows), tile = v or dout (exact in bf16).
template <int NJ>
__device__ __forceinline__ void chain_step(float (&st)[NJ][4], const bf16 (*op)[kN][kPad],
                                           const bf16* tile, const float* gq, int q, int ch0,
                                           int col0, int lane) {
  const int g = lane >> 2;
  const float g0 = gq[ch0 + g], g1 = gq[ch0 + g + 8];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    st[j][0] *= g0; st[j][1] *= g0; st[j][2] *= g1; st[j][3] *= g1;
  }
  state_mma(st, &op[0][0][0], &op[1][0][0], tile, q, ch0, col0, lane);
}

// acc[t][ch] += sum_m tile[t][m] st[ch][m] for the steps t of sub-chunk p,
// the warp's channels ch0 .. + 15 and the state's columns m = col0 .. : its
// accumulators are the B operand as they stand (accumulator row = B
// column), split into hi + lo.
template <int NJ>
__device__ __forceinline__ void edge_product(float (&acc)[2][4], const float (&st)[NJ][4],
                                             const bf16* tile, int p, int col0, int lane) {
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk) {     // m = col0 + 16 kk ..
    uint32_t a[4];
    ldsm(a, frag_row(tile, kPad, kSub * p, col0 + 16 * kk, lane));
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {        // channels ch0 + 8 nt ..
      uint32_t h0, l0, h1, l1;
      split(st[2 * kk][2 * nt], st[2 * kk][2 * nt + 1], h0, l0);
      split(st[2 * kk + 1][2 * nt], st[2 * kk + 1][2 * nt + 1], h1, l1);
      mma(acc[nt], a, h0, h1);
      mma(acc[nt], a, l0, l1);
    }
  }
}

__device__ __forceinline__ void store_edge(const float (&acc)[2][4], float (*out)[kPadF], int p,
                                           int ch0, int lane) {
  const int g = lane >> 2, c4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int col = ch0 + 8 * nt + 2 * c4;
    *reinterpret_cast<float2*>(&out[kSub * p + g][col]) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(&out[kSub * p + g + 8][col]) = make_float2(acc[nt][2], acc[nt][3]);
  }
}

// The 16 steps of sub-chunk p in channel ch of a chunk's [step][channel]
// tiles (global or staged): w (1 past T), k and r (0 past T) as floats.
template <typename TW>
__device__ __forceinline__ void load_column(const bf16* r, const bf16* k, const TW* w, int p,
                                            int ch, int valid, float (&rr)[kSub],
                                            float (&kk)[kSub], float (&ww)[kSub]) {
#pragma unroll
  for (int l = 0; l < kSub; ++l) {
    const int t = kSub * p + l;
    const bool ok = t < valid;
    const int at = (ok ? t : 0) * kN + ch;
    rr[l] = ok ? __bfloat162float(r[at]) : 0.f;
    kk[l] = ok ? __bfloat162float(k[at]) : 0.f;
    ww[l] = ok ? to_f32(w[at]) : 1.f;
  }
}

template <typename TW>
__global__ void __launch_bounds__(kCbThreads, 2)
wkv6_bwd_chunk_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const TW* __restrict__ w, const float* __restrict__ u,
                      const float* __restrict__ s_in, const float* __restrict__ g_out,
                      bf16* __restrict__ dr, bf16* __restrict__ dk, TW* __restrict__ dw,
                      float* __restrict__ du_part, int H, int T_len, int n_chunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkBwdSmem& sm = *reinterpret_cast<ChunkBwdSmem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, ci = blockIdx.y;
  const int valid = min(kChunk, T_len - ci * kChunk);
  const size_t base = ((size_t)bh * T_len + (size_t)ci * kChunk) * kN;
  const size_t chunk = (size_t)bh * n_chunks + ci;
  bf16* in_r = reinterpret_cast<bf16*>(&sm.sd[0][0]);
  bf16* in_k = in_r + kChunk * kN;
  TW* in_w = reinterpret_cast<TW*>(in_k + kChunk * kN);
  stage_rows<kChunk, kN, kCbThreads>(&sm.v[0][0], kPad, v + base, 0, valid);
  stage_rows<kChunk, kN, kCbThreads>(&sm.d[0][0], kPad, dout + base, 0, valid);
  stage_rows<kChunk, kN, kCbThreads>(in_r, kN, r + base, 0, valid);
  stage_rows<kChunk, kN, kCbThreads>(in_k, kN, k + base, 0, valid);
  stage_rows<kChunk, kN, kCbThreads>(in_w, kN, w + base, 0, valid);
  cp_async_commit();
  if (tid < kN) sm.u[tid] = u[(bh % H) * kN + tid];
  cp_async_wait<0>();
  __syncthreads();
  const int p = tid >> 6, ch = tid & (kN - 1);       // thread (sub-chunk, channel)
  {  // x, y and g by running products; (r ⊙ x)^T and (k ⊙ y)^T as hi + lo
    float rr[kSub], kk[kSub], ww[kSub], xs[kSub], ys[kSub];
    load_column(in_r, in_k, in_w, p, ch, valid, rr, kk, ww);
    float a = 1.f, b = 1.f;
#pragma unroll
    for (int l = 0; l < kSub; ++l) {
      xs[l] = a;
      a *= ww[l];
    }
#pragma unroll
    for (int l = kSub - 1; l >= 0; --l) {
      ys[l] = b;
      b *= ww[l];
    }
    sm.g[p][ch] = a;
#pragma unroll
    for (int l = 0; l < kSub; l += 2) {
      uint32_t hi, lo;
      split(rr[l] * xs[l], rr[l + 1] * xs[l + 1], hi, lo);
      *reinterpret_cast<uint32_t*>(&sm.rx[0][ch][kSub * p + l]) = hi;
      *reinterpret_cast<uint32_t*>(&sm.rx[1][ch][kSub * p + l]) = lo;
      split(kk[l] * ys[l], kk[l + 1] * ys[l + 1], hi, lo);
      *reinterpret_cast<uint32_t*>(&sm.ky[0][ch][kSub * p + l]) = hi;
      *reinterpret_cast<uint32_t*>(&sm.ky[1][ch][kSub * p + l]) = lo;
    }
  }
  __syncthreads();
  {  // the edge states: warp (rows 16 rg, sub-chunks 2 hp, 2 hp + 1)
    const int rg = warp & 3, hp = warp >> 2, ch0 = kSub * rg;
    const int g = lane >> 2, c4 = lane & 3;
    if (warp < kSubs) {                       // A_warp = dout v^T (exact products)
      float acc[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t af[4], bf[4];
        ldsm(af, frag_row(&sm.d[0][0], kPad, kSub * warp, 16 * kk, lane));
        ldsm(bf, frag_row(&sm.v[0][0], kPad, kSub * warp, 16 * kk, lane));
        mma(acc[0], af, bf[0], bf[2]);
        mma(acc[1], af, bf[1], bf[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        *reinterpret_cast<float2*>(&sm.a[warp][g][8 * nt + 2 * c4]) =
            make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(&sm.a[warp][g + 8][8 * nt + 2 * c4]) =
            make_float2(acc[nt][2], acc[nt][3]);
      }
    }
    // S_p stepped forward from S_in (kept from one sub-chunk to the next), Z;
    // then Γ_p from G_out a half of its columns at a time, for c and X (S
    // and half of Γ live: no spills at two blocks an SM)
    const float* gt_out = g_out + chunk * kN * kN;
    float S[8][4];
    load_state(S, s_in + chunk * kN * kN, ch0, 0, lane);
#pragma unroll 1
    for (int q = 0; q < 2 * hp; ++q) chain_step(S, sm.ky, &sm.v[0][0], sm.g[q], q, ch0, 0, lane);
#pragma unroll 1
    for (int pp = 0; pp < 2; ++pp) {
      const int q0 = 2 * hp + pp;
      if (pp) chain_step(S, sm.ky, &sm.v[0][0], sm.g[q0 - 1], q0 - 1, ch0, 0, lane);
      {
        float z[2][4] = {};
        edge_product(z, S, &sm.d[0][0], q0, 0, lane);
        store_edge(z, sm.sd, q0, ch0, lane);
      }
      float x[2][4] = {}, c0 = 0.f, c1 = 0.f;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float Gm[4][4];
        load_state(Gm, gt_out, ch0, 32 * hf, lane);
#pragma unroll 1
        for (int q = kSubs - 1; q > q0; --q)
          chain_step(Gm, sm.rx, &sm.d[0][0], sm.g[q], q, ch0, 32 * hf, lane);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          c0 = fmaf(S[4 * hf + j][0], Gm[j][0], fmaf(S[4 * hf + j][1], Gm[j][1], c0));
          c1 = fmaf(S[4 * hf + j][2], Gm[j][2], fmaf(S[4 * hf + j][3], Gm[j][3], c1));
        }
        edge_product(x, Gm, &sm.v[0][0], q0, 32 * hf, lane);
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        c0 += __shfl_xor_sync(0xffffffffu, c0, o);
        c1 += __shfl_xor_sync(0xffffffffu, c1, o);
      }
      if (c4 == 0) {
        sm.c[q0][ch0 + g] = c0;
        sm.c[q0][ch0 + g + 8] = c1;
      }
      store_edge(x, sm.gv, q0, ch0, lane);
    }
  }
  // the next pass's columns from global memory (L2), in flight across the
  // barrier (the staged copies were overwritten by Z and X)
  float rr[kSub], kk[kSub], ww[kSub];
  load_column(r + base, k + base, w + base, p, ch, valid, rr, kk, ww);
  __syncthreads();
  {  // thread (p, ch): the sums over i < t and j > t within the sub-chunk,
     // by running products and recurrences of w in fp32 registers:
     //   M[j] = sum_{i<t} D[t,i] k_i A[j,i] (j >= t; dr_t takes M[t]),
     //   yf = sum_{i<t} D[t,i] k_i X_i, xt = x_t,
     // each advanced one step a t (M[j] <- w_t M[j] + k_t A[j,t], ...), and
     // F[j] = D[j,t] r_j (j > t) by a running product, which ends at y_t
    const float uc = sm.u[ch], cp = sm.c[p][ch];
    const float (*A)[kSub + 4] = sm.a[p];
    const float* zc = &sm.sd[kSub * p][ch];          // Z_t at zc[t * kPadF]
    const float* xc = &sm.gv[kSub * p][ch];          // X_t
    float M[kSub] = {}, yf = 0.f, xt = 1.f, du = 0.f;
#pragma unroll
    for (int t = 0; t < kSub; ++t) {
      float F[kSub], f = 1.f;
#pragma unroll
      for (int j = t + 1; j < kSub; ++j) {
        F[j] = f * rr[j];
        f *= ww[j];
      }
      const float att = A[t][t], zt = zc[t * kPadF], xv = xc[t * kPadF];
      const float drt = fmaf(xt, zt, M[t] + uc * kk[t] * att);
      float dkt = fmaf(f, xv, uc * rr[t] * att), sb = 0.f, lt = 0.f;
#pragma unroll
      for (int j = t + 1; j < kSub; ++j) {
        const float a = A[j][t];
        dkt = fmaf(a, F[j], dkt);
        sb = fmaf(F[j], zc[j * kPadF], sb);
        lt = fmaf(F[j], M[j], lt);
        M[j] = fmaf(ww[t], M[j], kk[t] * a);
      }
      const float dwt = fmaf(xt * f, cp, fmaf(f, yf, fmaf(xt, sb, lt)));
      du = fmaf(rr[t] * kk[t], att, du);
      const int row = kSub * p + t;
      if (row < valid) {
        const size_t at = base + (size_t)row * kN + ch;
        dr[at] = __float2bfloat16_rn(drt);
        dk[at] = __float2bfloat16_rn(dkt);
        store(dw + at, dwt);
      }
      yf = fmaf(ww[t], yf, kk[t] * xv);
      xt *= ww[t];
      // no shared value is kept across steps (it would cost registers)
      asm volatile("" ::: "memory");
    }
    sm.du[p][ch] = du;
  }
  __syncthreads();
  if (tid < kN)
    du_part[chunk * kN + tid] = ((sm.du[0][tid] + sm.du[1][tid]) + sm.du[2][tid]) + sm.du[3][tid];
}

template <typename TW>
cudaError_t launch_bwd_chunked(const void* r, const void* k, const void* v, const void* w,
                               const float* u, const float* s0, const void* dout,
                               const float* dsT, void* dr, void* dk, void* dv, void* dw,
                               float* du, float* ds0, float* scratch, int B, int H, int T_len,
                               cudaStream_t stream) {
  const int n_chunks = (T_len + kChunk - 1) / kChunk;
  if (n_chunks > 65535) return cudaErrorInvalidValue;       // grid y
  const size_t n = (size_t)B * H * n_chunks;
  float* s_in = scratch;                  // U, then S_in in its place
  float* g_out = s_in + n * kN * kN;      // W, then G_out
  float* decay = g_out + n * kN * kN;
  float* du_part = decay + n * kN;
  const bf16* rb = static_cast<const bf16*>(r);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* db = static_cast<const bf16*>(dout);
  const TW* wt = static_cast<const TW*>(w);
  const dim3 chunks(B * H, n_chunks);
  const dim3 scan(B * H, kN * kN / 4 / kScanThreads);
  auto ku = wkv6_bwd_update_kernel<TW>;
  auto ko = wkv6_out_kernel<TW, true>;
  auto kc = wkv6_bwd_chunk_kernel<TW>;
  const int su = static_cast<int>(sizeof(BwdUpdateSmem<TW>));
  const int so = static_cast<int>(sizeof(OutSmem));
  const int sc = static_cast<int>(sizeof(ChunkBwdSmem));
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(ku, cudaFuncAttributeMaxDynamicSharedMemorySize, su)) ||
      (err = cudaFuncSetAttribute(ko, cudaFuncAttributeMaxDynamicSharedMemorySize, so)) ||
      (err = cudaFuncSetAttribute(kc, cudaFuncAttributeMaxDynamicSharedMemorySize, sc)))
    return err;
  // (1) U and W of every chunk, and its decay
  ku<<<chunks, kCbThreads, su, stream>>>(rb, kb, vb, db, wt, s_in, g_out, decay, T_len,
                                         n_chunks);
  if ((err = cudaGetLastError())) return err;
  // (2) S_in from s0; (3) G_out and ds0 from dS_T, last chunk first (in place)
  wkv6_scan_kernel<false, true><<<scan, kScanThreads, 0, stream>>>(s_in, decay, s0, s_in,
                                                                   nullptr, n_chunks);
  if ((err = cudaGetLastError())) return err;
  wkv6_scan_kernel<true, true><<<scan, kScanThreads, 0, stream>>>(g_out, decay, dsT, g_out,
                                                                  ds0, n_chunks);
  if ((err = cudaGetLastError())) return err;
  // (4) dv: the output pass backwards in time on (k, r, dout) from G_out
  ko<<<chunks, kThreads, so, stream>>>(kb, rb, db, wt, u, g_out, static_cast<bf16*>(dv), H,
                                       T_len, n_chunks);
  if ((err = cudaGetLastError())) return err;
  // (5) dr, dk, dw and du's partials
  kc<<<chunks, kCbThreads, sc, stream>>>(rb, kb, vb, db, wt, u, s_in, g_out,
                                         static_cast<bf16*>(dr), static_cast<bf16*>(dk),
                                         static_cast<TW*>(dw), du_part, H, T_len, n_chunks);
  if ((err = cudaGetLastError())) return err;
  // (6) du
  wkv6_du_kernel<<<H, kBwdThreads, 0, stream>>>(du_part, du, B, H, n_chunks);
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

// The backward of wkv6_fwd (section 3 above).  r, k, v, dout, dr, dk and dv
// share `dtype`; w and dw are float32 or `dtype` (`w_dtype`); u [H, 64], s0,
// dsT, ds0 [B, H, 64, 64] and du [H, 64] are float32.  dsT may be null (no
// cotangent for the final state).  `chunked` selects the chunked form (3a,
// bf16 only; `scratch` then holds B * H * ceil(T / 64) * (2 * 64 * 64 + 2 *
// 64) floats), else the serial one (3b; B * H * (ceil(T / 64) * 64 * 64 +
// 64) floats).  The same layout and alias rules as wkv6_fwd.  Returns a
// cudaError_t.
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v, const void* w,
                        const void* u, const void* s0, const void* dout, const void* dsT,
                        void* dr, void* dk, void* dv, void* dw, void* du, void* ds0,
                        void* scratch, int B, int H, int T_len, int dtype, int w_dtype,
                        int chunked, void* stream) {
  if (B <= 0 || H <= 0 || T_len <= 0 || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  const float* dsTf = static_cast<const float*>(dsT);
  float* duf = static_cast<float*>(du);
  float* ds0f = static_cast<float*>(ds0);
  float* sc = static_cast<float*>(scratch);
  cudaError_t err;
  if (chunked) {
    if (dtype == 1 && w_dtype == 0)
      err = launch_bwd_chunked<float>(r, k, v, w, uf, s0f, dout, dsTf, dr, dk, dv, dw, duf,
                                      ds0f, sc, B, H, T_len, st);
    else if (dtype == 1 && w_dtype == 1)
      err = launch_bwd_chunked<bf16>(r, k, v, w, uf, s0f, dout, dsTf, dr, dk, dv, dw, duf,
                                     ds0f, sc, B, H, T_len, st);
    else
      err = cudaErrorInvalidValue;
  } else if (dtype == 0 && w_dtype == 0) {
    err = launch_bwd_serial<float, float>(r, k, v, w, uf, s0f, dout, dsTf, dr, dk, dv, dw,
                                          duf, ds0f, sc, B, H, T_len, st);
  } else if (dtype == 1 && w_dtype == 0) {
    err = launch_bwd_serial<bf16, float>(r, k, v, w, uf, s0f, dout, dsTf, dr, dk, dv, dw, duf,
                                         ds0f, sc, B, H, T_len, st);
  } else if (dtype == 1 && w_dtype == 1) {
    err = launch_bwd_serial<bf16, bf16>(r, k, v, w, uf, s0f, dout, dsTf, dr, dk, dv, dw, duf,
                                        ds0f, sc, B, H, T_len, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
