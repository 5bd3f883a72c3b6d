// Fused RMSNorm forward for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * scale.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py::rmsnorm_pallas
// (_kernel), which tiles [256, D] rows into VMEM and does the reduction and
// the scale in one pass with fp32 math and the input dtype kept for the output.
//
// Bound on this card: bytes.  Per row the kernel reads D inputs and writes D
// outputs and does ~4 flops per element, far below the ~295 flop/byte the
// H100 needs before compute matters; at the serving prefill (2048 rows x 960,
// bf16) the least time is ~7.9 MB / 3.35 TB/s = 2.3 us.
//
// Design: one warp per row, 16-byte vector loads (8 bf16 or 4 fp32 values per
// lane per step; D = 960 bf16 is 120 vectors, so a warp covers it in 4
// steps).  Pass 1 sums squares in fp32 and reduces across the warp with
// shuffles; pass 2 re-reads the row (it is 1.9 KB, so the re-read hits L1)
// and writes (x * r) * scale in the output dtype.  No shared memory, no
// atomics, nothing allocated.  Launches on the caller's stream.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ static void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
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
  __device__ static void store(__nv_bfloat16* p, const float* in) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               T* __restrict__ out, int rows, int d, float eps) {
  constexpr int N = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + (size_t)row * d;
  T* orow = out + (size_t)row * d;
  const int nvec = d / N;

  float ss = 0.f;
  for (int v = lane; v < nvec; v += 32) {
    float f[N];
    Vec<T>::load(xr + v * N, f);
#pragma unroll
    for (int i = 0; i < N; ++i) ss += f[i] * f[i];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / (float)d + eps);

  for (int v = lane; v < nvec; v += 32) {
    float f[N], s[N];
    Vec<T>::load(xr + v * N, f);
    Vec<T>::load(scale + v * N, s);
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = (f[i] * r) * s[i];
    Vec<T>::store(orow + v * N, f);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, void* out, int rows, int d,
                   float eps, cudaStream_t stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  rmsnorm_kernel<T><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<T*>(out),
      rows, d, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, scale and out share it).  The caller
// guarantees contiguous rows, 16-byte aligned pointers and d % (16 / elem) == 0.
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out, int rows,
                           int d, float eps, int dtype, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0
      ? launch<float>(x, scale, out, rows, d, eps, s)
      : launch<__nv_bfloat16>(x, scale, out, rows, d, eps, s);
  return static_cast<int>(err);
}
