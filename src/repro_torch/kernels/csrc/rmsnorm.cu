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
// Design: one warp per row, two rows per warp in bf16 (one in fp32), four
// warps per block (a 2048-row bf16 call is 256 blocks: every warp of it
// resident at once on the 132 SMs).  With D known at compile time (960 and
// 2048, the widths the serving paths use) a lane holds its share of each
// row in registers as 16-byte
// vectors (8 bf16 or 4 fp32: D = 960 bf16 is 120 vectors, 4 per lane at
// most): it issues every load of its rows, with no L1 allocation, before the
// first reduction, sums squares in fp32, reduces across the warp with
// shuffles and writes (x * r) * scale from the same registers.  The scale
// vector is loaded once per warp and reused for its rows.  Any other D (a
// multiple of the vector width) takes the same kernel with D = 0: runtime
// loops that read the row twice.  No shared memory, no atomics, nothing
// allocated.  Launches on the caller's stream.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;   // warps per block

// Rows per warp: two in bf16; one in fp32, whose rows take twice the registers.
template <typename T> __host__ __device__ constexpr int rows_per_warp() { return sizeof(T) == 2 ? 2 : 1; }

__device__ __forceinline__ uint4 load_stream(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& raw, float* out) {
    out[0] = __uint_as_float(raw.x); out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z); out[3] = __uint_as_float(raw.w);
  }
  __device__ static uint4 pack(const float* in) {
    return make_uint4(__float_as_uint(in[0]), __float_as_uint(in[1]),
                      __float_as_uint(in[2]), __float_as_uint(in[3]));
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& raw, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x; out[2 * i + 1] = f.y;
    }
  }
  __device__ static uint4 pack(const float* in) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    return raw;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__device__ __forceinline__ float sum_squares(const uint4& raw) {
  float f[Vec<T>::N];
  Vec<T>::unpack(raw, f);
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) ss += f[i] * f[i];
  return ss;
}

template <typename T>
__device__ __forceinline__ uint4 normed(const uint4& xraw, const uint4& sraw, float r) {
  float f[Vec<T>::N], s[Vec<T>::N];
  Vec<T>::unpack(xraw, f);
  Vec<T>::unpack(sraw, s);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) f[i] = (f[i] * r) * s[i];
  return Vec<T>::pack(f);
}

// D > 0: the row lives in registers; D == 0: runtime d, two passes.
template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               T* __restrict__ out, int rows, int d, float eps) {
  constexpr int N = Vec<T>::N;
  constexpr int kRows = rows_per_warp<T>();
  const int lane = threadIdx.x & 31;
  const int row_first = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRows;
  if (row_first >= rows) return;
  const int nrows = min(kRows, rows - row_first);   // uniform over the warp

  if constexpr (D > 0) {
    constexpr int kVecs = D / N;                     // 16-byte vectors per row
    constexpr int kPer = (kVecs + 31) / 32;          // per lane, at most
    uint4 xv[kRows][kPer], sv[kPer];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < nrows) {
        const T* xr = x + (size_t)(row_first + r) * D;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int v = lane + 32 * i;
          if (v < kVecs) xv[r][i] = load_stream(xr + v * N);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int v = lane + 32 * i;
      if (v < kVecs) sv[i] = *reinterpret_cast<const uint4*>(scale + v * N);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= nrows) break;
      float ss = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        if (lane + 32 * i < kVecs) ss += sum_squares<T>(xv[r][i]);
      const float rs = rsqrtf(warp_sum(ss) / (float)D + eps);
      T* orow = out + (size_t)(row_first + r) * D;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int v = lane + 32 * i;
        if (v < kVecs)
          *reinterpret_cast<uint4*>(orow + v * N) = normed<T>(xv[r][i], sv[i], rs);
      }
    }
  } else {
    const int nvec = d / N;
    for (int r = 0; r < nrows; ++r) {
      const T* xr = x + (size_t)(row_first + r) * d;
      T* orow = out + (size_t)(row_first + r) * d;
      float ss = 0.f;
      for (int v = lane; v < nvec; v += 32) ss += sum_squares<T>(load_stream(xr + v * N));
      const float rs = rsqrtf(warp_sum(ss) / (float)d + eps);
      for (int v = lane; v < nvec; v += 32)
        *reinterpret_cast<uint4*>(orow + v * N) =
            normed<T>(*reinterpret_cast<const uint4*>(xr + v * N),
                      *reinterpret_cast<const uint4*>(scale + v * N), rs);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, void* out, int rows, int d,
                   float eps, cudaStream_t stream) {
  constexpr int kPerBlock = kWarps * rows_per_warp<T>();
  const int blocks = (rows + kPerBlock - 1) / kPerBlock;
  auto kern = d == 960 ? rmsnorm_kernel<T, 960>
            : d == 2048 ? rmsnorm_kernel<T, 2048>
            : rmsnorm_kernel<T, 0>;
  kern<<<blocks, kWarps * 32, 0, stream>>>(
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
