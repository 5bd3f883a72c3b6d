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
// Design (the simple, right first version; no tensor cores, TMA or warp
// specialisation yet): one 256-thread block per (b * Hq + h, 64-row q tile),
// heaviest causal tiles first.  The block keeps q (pre-scaled, transposed)
// in shared memory and loops over 64-key tiles of k and v staged in shared
// memory in fp32 (bf16 inputs are widened on the load).  Each thread owns a
// 4 x 4 patch of the score tile and a 4 x (4 * D / 64) patch of the output,
// so every inner step is two or three 16-byte shared loads feeding 16 FMAs.
// The 16 threads that share a row reduce max and sum with warp shuffles.
// The q and k edges that do not fill a tile are masked inside the kernel
// (zero-filled operands, -1e30 scores); nothing is padded in memory.
// Launches on the caller's stream and allocates nothing.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per k tile
constexpr int kThreads = 256;  // 16 x 16 threads, each a 4 x 4 patch
constexpr int kPad = 4;        // keeps float4 rows aligned, spreads banks
constexpr float kNegInf = -1e30f;

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ static void store1(float* p, float v) { *p = v; }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x; out[2 * i + 1] = f.y;
    }
  }
  __device__ static void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
};

template <int D>
struct Smem {
  static constexpr int kQT = D * (kBQ + kPad);  // q^T  [D][BQ + pad]
  static constexpr int kKT = D * (kBK + kPad);  // k^T  [D][BK + pad]
  static constexpr int kV = kBK * D;            // v    [BK][D]
  static constexpr int kPT = kBK * (kBQ + kPad);  // p^T [BK][BQ + pad]
  static constexpr size_t kBytes = sizeof(float) * (kQT + kKT + kV + kPT);
};

// Stage `rows_valid` rows of a [rows, D] tile from global memory into shared
// memory as fp32, either transposed ([D][ld]) or row-major ([rows][D]);
// rows past the valid edge are zero-filled.
template <typename T, int D, int ROWS, bool TRANSPOSE>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src, int rows_valid,
                                           float mul, float* dst, int ld) {
  constexpr int N = Vec<T>::N;
  constexpr int kVecs = ROWS * D / N;
  for (int e = threadIdx.x; e < kVecs; e += kThreads) {
    const int r = (e * N) / D;
    const int d0 = (e * N) % D;
    float f[N];
    if (r < rows_valid) {
      Vec<T>::load(src + (size_t)r * D + d0, f);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) f[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (TRANSPOSE) dst[(d0 + i) * ld + r] = f[i] * mul;
      else dst[r * D + d0 + i] = f[i] * mul;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
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

  const T* qb = q + ((size_t)bh * sq + q0) * D;
  const T* kb = k + (size_t)(b * hkv + kvh) * sk * D;
  const T* vb = v + (size_t)(b * hkv + kvh) * sk * D;
  stage_tile<T, D, kBQ, true>(qb, min(kBQ, sq - q0), scale, sQT, LQ);

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
    stage_tile<T, D, kBK, true>(kb + (size_t)k_first * D, k_valid, 1.f, sKT, LK);
    stage_tile<T, D, kBK, false>(vb + (size_t)k_first * D, k_valid, 1.f, sV, D);
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
    T* orow = out + ((size_t)bh * sq + r) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) Vec<T>::store1(orow + c * 64 + 4 * tc + j, acc[i][c * 4 + j] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int b, int hq,
                   int hkv, int sq, int sk, float scale, int causal, int window,
                   int q_offset, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, D>;
  const size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + kBQ - 1) / kBQ, b * hq);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), hq, hkv, sq, sk, scale, causal, window, q_offset);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it); d in {64, 128}.
// The caller guarantees contiguous [B, H, S, D] tensors, 16-byte aligned
// pointers, hq % hkv == 0 and b * hq <= 65535.  Returns a cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   int b, int hq, int hkv, int sq, int sk, int d,
                                   float scale, int causal, int window, int q_offset,
                                   int dtype, void* stream) {
  if (b <= 0 || sq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = d == 64 ? launch<float, 64>(q, k, v, out, b, hq, hkv, sq, sk, scale, causal, window,
                                      q_offset, s)
                  : launch<float, 128>(q, k, v, out, b, hq, hkv, sq, sk, scale, causal, window,
                                       q_offset, s);
  } else {
    err = d == 64 ? launch<__nv_bfloat16, 64>(q, k, v, out, b, hq, hkv, sq, sk, scale, causal,
                                              window, q_offset, s)
                  : launch<__nv_bfloat16, 128>(q, k, v, out, b, hq, hkv, sq, sk, scale, causal,
                                               window, q_offset, s);
  }
  return static_cast<int>(err);
}
