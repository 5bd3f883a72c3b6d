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
//
// Backward (rmsnorm_bwd; the reference has no rule for the Pallas kernel, so
// this is the gradient of its plain ref.rmsnorm): with g = dy * scale,
// xhat = x * rstd and rstd recomputed from x,
//   dx = rstd (g - xhat mean(g xhat)) = rstd g - x rstd^3 sum(g x) / D,
//   dscale = sum over rows of dy xhat.
// Bound: bytes, as the forward (x and dy read, dx written: 11.8 MB, 3.5 us at
// [2048, 960] bf16; 47 MB, 14.1 us at the training call [8192, 960]).  Two
// kernels, no atomics, so dscale is the same bit for bit from run to run:
//   rmsnorm_bwd_kernel: each block (8 warps) takes a contiguous run of rows,
//     one warp a row at a time.  With D known at compile time (960, the
//     width that trains, in bf16) the row stays in registers, as in the
//     forward: a lane issues every 16-byte load of its share of x and dy (no
//     L1 allocation) before the first reduction, and the two row sums, dx
//     and the dscale contribution all come from those registers; scale is
//     read once a warp.  A lane's columns are the same for every row it
//     takes, so it adds dy xhat into its own fp32 registers across its rows.
//     Any other width (at 2048 the row and the sums need more registers than
//     a thread has), and fp32, takes the generic form (D = 0): runtime loops
//     that read a row twice (the dot products, then dx, the second time from
//     L1), sums in shared memory.  Every warp's sums end in shared memory and
//     the block adds its warps in a fixed order into its row of a
//     [n_blocks, D] fp32 scratch;
//   rmsnorm_dscale_kernel: each column of the scratch summed in a fixed
//     order (16 interleaved partial sums per column, then a fixed order).
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

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

constexpr int kBwdWarps = 8;      // warps per block of rmsnorm_bwd_kernel

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
constexpr int kColBlock = 32;     // columns per block of rmsnorm_dscale_kernel
constexpr int kColSplit = 16;     // partial sums per column

// A warp's fp32 column sums: vector v = lane + 32 i of the row, element e of
// it, at (i * N + e) * 32 + lane, so the 32 lanes touch 32 banks.
template <typename T> __host__ __device__ int acc_floats_per_warp(int d) {
  return (d / Vec<T>::N + 31) / 32 * Vec<T>::N * 32;
}

// D > 0: the row and the dscale sums live in registers; D == 0: runtime d,
// two passes, the sums in shared memory (vector v = lane + 32 i of the row,
// element e at (i N + e) 32 + lane: every lane its own bank).  Either way
// each warp's sums end in shared memory (column by column for D > 0), and
// the block adds its warps there in a fixed order.
template <typename T, int D>
__global__ void __launch_bounds__(kBwdWarps * 32, D > 0 ? 2 : 1)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                   const T* __restrict__ dy, T* __restrict__ dx,
                   float* __restrict__ partial, int rows, int d, int rows_per_block,
                   float eps) {
  constexpr int N = Vec<T>::N;
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);
  const int dd = D > 0 ? D : d;
  const int per_warp = acc_floats_per_warp<T>(dd);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r_begin = blockIdx.x * rows_per_block;
  const int r_end = min(rows, r_begin + rows_per_block);
  float* my = acc + warp * per_warp;

  if constexpr (D > 0) {
    constexpr int kVecs = D / N;                 // 16-byte vectors per row
    constexpr int kPer = (kVecs + 31) / 32;      // per lane, at most
    uint4 sv[kPer];
    float ds[kPer][N];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int v = lane + 32 * i;
      if (v < kVecs) sv[i] = *reinterpret_cast<const uint4*>(scale + v * N);
#pragma unroll
      for (int e = 0; e < N; ++e) ds[i][e] = 0.f;
    }
    for (int r = r_begin + warp; r < r_end; r += kBwdWarps) {
      const T* xr = x + (size_t)r * D;
      const T* gr = dy + (size_t)r * D;
      uint4 xv[kPer], gv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int v = lane + 32 * i;
        if (v < kVecs) {
          xv[i] = load_stream(xr + v * N);
          gv[i] = load_stream(gr + v * N);
        }
      }
      float ss = 0.f, sgx = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        if (lane + 32 * i < kVecs) {
          float xf[N], gf[N], sf[N];
          Vec<T>::unpack(xv[i], xf);
          Vec<T>::unpack(gv[i], gf);
          Vec<T>::unpack(sv[i], sf);
#pragma unroll
          for (int e = 0; e < N; ++e) {
            ss += xf[e] * xf[e];
            sgx += gf[e] * sf[e] * xf[e];
          }
        }
      }
      ss = warp_sum(ss);
      sgx = warp_sum(sgx);
      const float rstd = rsqrtf(ss / (float)D + eps);
      const float c = rstd * rstd * rstd * sgx / (float)D;
      T* dxr = dx + (size_t)r * D;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int v = lane + 32 * i;
        if (v < kVecs) {
          float xf[N], gf[N], sf[N], out[N];
          Vec<T>::unpack(xv[i], xf);
          Vec<T>::unpack(gv[i], gf);
          Vec<T>::unpack(sv[i], sf);
#pragma unroll
          for (int e = 0; e < N; ++e) {
            out[e] = rstd * (gf[e] * sf[e]) - xf[e] * c;
            ds[i][e] += gf[e] * (xf[e] * rstd);
          }
          *reinterpret_cast<uint4*>(dxr + v * N) = Vec<T>::pack(out);
        }
      }
    }
    // the sums column by column (16-byte stores), reduced below in order
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int v = lane + 32 * i;
      if (v < kVecs)
#pragma unroll
        for (int e = 0; e < N; e += 4)
          *reinterpret_cast<float4*>(my + v * N + e) =
              make_float4(ds[i][e], ds[i][e + 1], ds[i][e + 2], ds[i][e + 3]);
    }
  } else {
    const int nvec = d / N;
    for (int i = lane; i < per_warp; i += 32) my[i] = 0.f;
    for (int r = r_begin + warp; r < r_end; r += kBwdWarps) {
      const T* xr = x + (size_t)r * d;
      const T* gr = dy + (size_t)r * d;
      float ss = 0.f, sgx = 0.f;
      for (int v = lane; v < nvec; v += 32) {
        float xf[N], gf[N], sf[N];
        Vec<T>::unpack(*reinterpret_cast<const uint4*>(xr + v * N), xf);
        Vec<T>::unpack(*reinterpret_cast<const uint4*>(gr + v * N), gf);
        Vec<T>::unpack(*reinterpret_cast<const uint4*>(scale + v * N), sf);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          ss += xf[e] * xf[e];
          sgx += gf[e] * sf[e] * xf[e];
        }
      }
      ss = warp_sum(ss);
      sgx = warp_sum(sgx);
      const float rstd = rsqrtf(ss / (float)d + eps);
      const float c = rstd * rstd * rstd * sgx / (float)d;
      T* dxr = dx + (size_t)r * d;
      for (int v = lane, i = 0; v < nvec; v += 32, ++i) {
        float xf[N], gf[N], sf[N], out[N];
        Vec<T>::unpack(*reinterpret_cast<const uint4*>(xr + v * N), xf);
        Vec<T>::unpack(*reinterpret_cast<const uint4*>(gr + v * N), gf);
        Vec<T>::unpack(*reinterpret_cast<const uint4*>(scale + v * N), sf);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          out[e] = rstd * (gf[e] * sf[e]) - xf[e] * c;
          my[(i * N + e) * 32 + lane] += gf[e] * (xf[e] * rstd);
        }
        *reinterpret_cast<uint4*>(dxr + v * N) = Vec<T>::pack(out);
      }
    }
  }
  __syncthreads();
  // this block's column sums, warps added in a fixed order
  for (int col = threadIdx.x; col < dd; col += kBwdWarps * 32) {
    const int v = col / N;
    const int idx = D > 0 ? col : ((v / 32) * N + col % N) * 32 + v % 32;
    float sum = 0.f;
    for (int w = 0; w < kBwdWarps; ++w) sum += acc[w * per_warp + idx];
    partial[(size_t)blockIdx.x * dd + col] = sum;
  }
}

template <typename T>
__global__ void __launch_bounds__(kColBlock * kColSplit)
rmsnorm_dscale_kernel(const float* __restrict__ partial, T* __restrict__ dscale,
                      int n_blocks, int d) {
  __shared__ float part[kColSplit][kColBlock];
  const int cl = threadIdx.x % kColBlock;
  const int split = threadIdx.x / kColBlock;
  const int col = blockIdx.x * kColBlock + cl;
  float sum = 0.f;
  if (col < d)
    for (int b = split; b < n_blocks; b += kColSplit) sum += partial[(size_t)b * d + col];
  part[split][cl] = sum;
  __syncthreads();
  if (split == 0 && col < d) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < kColSplit; ++i) total += part[i][cl];
    dscale[col] = from_float<T>(total);
  }
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* scale, const void* dy, void* dx,
                       void* dscale, float* partial, int n_blocks, int rows, int d, float eps,
                       cudaStream_t stream) {
  const int rows_per_block = (rows + n_blocks - 1) / n_blocks;
  // the row in registers for bf16 at 960 and 2048; fp32 rows take twice the
  // registers, so fp32 and any other width take the generic form
  // the row in registers for bf16 at 960; at 2048 the row and the sums need
  // more registers than a thread has (ptxas spilled), and fp32 rows take twice
  // those of bf16: the generic form
  auto kern = rmsnorm_bwd_kernel<T, 0>;
  if constexpr (sizeof(T) == 2) {
    if (d == 960) kern = rmsnorm_bwd_kernel<T, 960>;
  }
  const size_t smem = sizeof(float) * kBwdWarps * acc_floats_per_warp<T>(d);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<n_blocks, kBwdWarps * 32, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<const T*>(dy),
      static_cast<T*>(dx), partial, rows, d, rows_per_block, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_dscale_kernel<T><<<(d + kColBlock - 1) / kColBlock, kColBlock * kColSplit, 0,
                             stream>>>(partial, static_cast<T*>(dscale), n_blocks, d);
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

// The backward of rmsnorm_fwd: dx (x's shape) and dscale [d] from x, scale and
// dy, all of one dtype (0 = float32, 1 = bfloat16).  ``partial`` is a caller's
// fp32 scratch of n_blocks * d floats; n_blocks (>= 1) blocks share the rows.
// Same guarantees as the forward.  Returns a cudaError_t.
extern "C" int rmsnorm_bwd(const void* x, const void* scale, const void* dy, void* dx,
                           void* dscale, float* partial, int n_blocks, int rows, int d,
                           float eps, int dtype, void* stream) {
  if (rows <= 0 || n_blocks <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0
      ? launch_bwd<float>(x, scale, dy, dx, dscale, partial, n_blocks, rows, d, eps, s)
      : launch_bwd<__nv_bfloat16>(x, scale, dy, dx, dscale, partial, n_blocks, rows, d, eps,
                                  s);
  return static_cast<int>(err);
}
