// RWKV-6 (Finch) WKV recurrence forward for Hopper (sm_90a).
//
//   out_t = r_t · (S_t + u ⊙ k_t ⊗ v_t)        S_{t+1} = diag(w_t) S_t + k_t ⊗ v_t
//
// per (batch, head), with a [K, V] = [64, 64] fp32 state; returns out and the
// final state S_T, given the initial state S_0.
//
// Replaces the Pallas TPU kernel repro/kernels/rwkv6.py::wkv6_pallas
// (_kernel), which chunks time into 64 steps so that the MXU does the
// intra-chunk work as C x C products, with exp(-cum) decay algebra that needs
// w bounded away from 0 and T % chunk == 0.  This kernel computes the same
// function in the serial form instead: it takes any T >= 1 (decode runs
// T = 1) and has no overflow in the decay.
//
// Bound on this card.  At the serving prefill (one micro-batch: B = 1,
// H = 32, T = 2048, bf16 r/k/v/out, fp32 w) one call moves ~51 MB (25.2 MB
// of r/k/v, 16.8 MB of w, 8.4 MB of out, 1 MB of state in and out), ~15 us
// at 3.35 TB/s, and does 5 K V fp32 operations a step (2 for r·S, 3 for
// the state update), 1.34 GFLOP, ~20 us at the 67 TFLOP/s of fp32 outside
// the tensor cores.  A decode call (T = 1) moves ~1 MB of state: ~0.3 us,
// so it is bound by launch latency.
//
// Design: one block per (b, h), 64 threads; thread j owns the state column
// S[:, j] in 64 registers for the whole sequence, so the state never leaves
// the chip between steps.  Time is staged in chunks of 32 steps: the block
// loads r, k, w, v of the chunk into shared memory with coalesced loads
// (converted to fp32) and reduces the bonus scalar a_t = sum_k r_t u k_t of
// each step with warp shuffles on the way, then runs the 32 steps with no
// barrier between them: out_t[j] = sum_k r_t[k] S[k][j] + v_t[j] a_t (in
// four partial sums), then S[k][j] = w_t[k] S[k][j] + k_t[k] v_t[j].  r, k
// and w are read from shared memory as broadcast float4s.  The serial
// dependence over T remains:
// with B * H = 32 blocks on 132 SMs and 2 warps a block, the kernel is bound
// by the latency of the step loop, far above the bound above; splitting V
// over blocks and a chunked tensor-core form are later work.  Launches on
// the caller's stream, allocates nothing.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kN = 64;       // K = V = head size
constexpr int kChunk = 32;   // time steps staged in shared memory at once

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T, typename TW>
__global__ void __launch_bounds__(kN)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const TW* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ out, float* __restrict__ sT, int H, int T_len) {
  __shared__ __align__(16) float r_s[kChunk][kN];
  __shared__ __align__(16) float k_s[kChunk][kN];
  __shared__ __align__(16) float w_s[kChunk][kN];
  __shared__ float v_s[kChunk][kN];
  __shared__ float a_s[2][kChunk];                 // a_t, one half per warp

  const int j = threadIdx.x;
  const int lane = j & 31;
  const int warp = j >> 5;
  const int bh = blockIdx.x;
  const int h = bh % H;
  const size_t base = (size_t)bh * T_len * kN;     // [B*H, T, 64] row start
  const size_t sbase = (size_t)bh * kN * kN;       // [B*H, 64, 64] state start

  const float uj = u[h * kN + j];
  float S[kN];
#pragma unroll
  for (int q = 0; q < kN; ++q) S[q] = s0[sbase + (size_t)q * kN + j];

  for (int t0 = 0; t0 < T_len; t0 += kChunk) {
    const int n = min(kChunk, T_len - t0);
    __syncthreads();           // the previous chunk is consumed
#pragma unroll 4
    for (int i = 0; i < n; ++i) {    // n is uniform over the block
      const size_t off = base + (size_t)(t0 + i) * kN + j;
      const float rj = to_f32(r[off]);
      const float kj = to_f32(k[off]);
      r_s[i][j] = rj;
      k_s[i][j] = kj;
      w_s[i][j] = to_f32(w[off]);
      v_s[i][j] = to_f32(v[off]);
      float a = rj * (uj * kj);
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) a += __shfl_xor_sync(0xffffffffu, a, d);
      if (lane == 0) a_s[warp][i] = a;
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float vj = v_s[i][j];
      float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
#pragma unroll
      for (int q = 0; q < kN; q += 4) {
        const float4 rq = *reinterpret_cast<const float4*>(&r_s[i][q]);
        const float4 kq = *reinterpret_cast<const float4*>(&k_s[i][q]);
        const float4 wq = *reinterpret_cast<const float4*>(&w_s[i][q]);
        acc0 = fmaf(rq.x, S[q + 0], acc0);
        acc1 = fmaf(rq.y, S[q + 1], acc1);
        acc2 = fmaf(rq.z, S[q + 2], acc2);
        acc3 = fmaf(rq.w, S[q + 3], acc3);
        S[q + 0] = fmaf(wq.x, S[q + 0], kq.x * vj);
        S[q + 1] = fmaf(wq.y, S[q + 1], kq.y * vj);
        S[q + 2] = fmaf(wq.z, S[q + 2], kq.z * vj);
        S[q + 3] = fmaf(wq.w, S[q + 3], kq.w * vj);
      }
      store(out + base + (size_t)(t0 + i) * kN + j,
            ((acc0 + acc1) + (acc2 + acc3)) + vj * (a_s[0][i] + a_s[1][i]));
    }
  }
#pragma unroll
  for (int q = 0; q < kN; ++q) sT[sbase + (size_t)q * kN + j] = S[q];
}

template <typename T, typename TW>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const float* u, const float* s0, void* out, float* sT,
                   int B, int H, int T_len, cudaStream_t stream) {
  wkv6_kernel<T, TW><<<B * H, kN, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const TW*>(w), u, s0, static_cast<T*>(out), sT, H, T_len);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  r, k, v and out share `dtype`; w is
// float32 or `dtype` (`w_dtype`); u [H, 64], s0 and sT [B, H, 64, 64] are
// float32.  The caller guarantees contiguous [B, H, T, 64] tensors, T >= 1,
// B * H <= 2^31 - 1, and that out and sT alias no input.
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s0, void* out,
                        void* sT, int B, int H, int T_len, int dtype,
                        int w_dtype, void* stream) {
  if (B <= 0 || H <= 0 || T_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* sTf = static_cast<float*>(sT);
  cudaError_t err;
  if (dtype == 0 && w_dtype == 0)
    err = launch<float, float>(r, k, v, w, uf, s0f, out, sTf, B, H, T_len, s);
  else if (dtype == 1 && w_dtype == 0)
    err = launch<__nv_bfloat16, float>(r, k, v, w, uf, s0f, out, sTf, B, H, T_len, s);
  else if (dtype == 1 && w_dtype == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16>(r, k, v, w, uf, s0f, out, sTf, B, H,
                                               T_len, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
