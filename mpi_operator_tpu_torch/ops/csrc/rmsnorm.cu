// K5': fused RMSNorm forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_rmsnorm_kernel`
// (mpi_operator_tpu/ops/rmsnorm.py, launched by `_rmsnorm_forward`) and
// computes what it computes, row by row over x [rows, d]:
//   rstd = rsqrt(mean(x^2) + eps)            (f32)
//   y    = (x * rstd) * scale                (f32, cast to x's type)
// and writes y and rstd [rows] (f32, saved for the plain backward).
//
// Bound: device memory.  Each element is read, squared and summed, then
// scaled twice: about 4 flops per element against 2-4 bytes moved, far
// below the ~295 flops/byte where an H100's compute would limit.  So the
// least time is x read once and y written once (plus scale and rstd)
// over the memory rate.  The design:
//   * one CTA per row (the Pallas grid's 256-row blocks had to divide the
//     row count; here any row count and any d are taken);
//   * pass 1: each thread sums x^2 in f32 over a strided slice of the
//     row; a warp-shuffle reduction, then one across the warps through
//     shared memory, gives every thread the row's sum;
//   * pass 2 reads the row again (it was just read, so it comes from L1
//     or L2, not device memory) and writes y;
//   * the row's 16-byte-aligned body moves as 16-byte vectors; an
//     unaligned head and a ragged tail take scalar loads.  The wrapper
//     turns vectors off when x and y do not share their alignment;
//   * scale may be f32 or x's type; it is read per element (d values,
//     shared by every row, so it stays in cache).
// Holding the row in registers between the passes and several rows per
// CTA at small d are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kF16 = 2;
constexpr int kMaxWarps = 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// Sum of v over the block; every thread gets the total.  blockDim.x is
// a multiple of 32 and at most 1024.
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = lane < static_cast<int>(blockDim.x >> 5) ? warp_sums[lane] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

template <typename T, typename S>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const S* __restrict__ scale,
                               T* __restrict__ y, float* __restrict__ rstd,
                               int d, float eps, int vec) {
  __shared__ float warp_sums[kMaxWarps];
  constexpr int kVec = 16 / sizeof(T);
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;

  // Split of the row: scalar head up to the first 16-byte boundary,
  // vector body, scalar tail.  Without vectors the whole row is "head".
  int head = d, nvec = 0;
  if (vec) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(xr);
    head = static_cast<int>(((16 - (a & 15)) & 15) / sizeof(T));
    if (head > d) head = d;
    nvec = (d - head) / kVec;
  }
  const int tail = head + nvec * kVec;
  const uint4* xv = reinterpret_cast<const uint4*>(xr + head);

  float ss = 0.f;
  for (int i = threadIdx.x; i < head; i += blockDim.x) {
    const float f = to_f32(xr[i]);
    ss += f * f;
  }
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    uint4 raw = xv[i];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float f = to_f32(e[j]);
      ss += f * f;
    }
  }
  for (int i = tail + threadIdx.x; i < d; i += blockDim.x) {
    const float f = to_f32(xr[i]);
    ss += f * f;
  }
  const float r = rsqrtf(block_sum(ss, warp_sums) / static_cast<float>(d)
                         + eps);
  if (threadIdx.x == 0) rstd[row] = r;

  for (int i = threadIdx.x; i < head; i += blockDim.x) {
    yr[i] = from_f32<T>((to_f32(xr[i]) * r) * to_f32(scale[i]));
  }
  uint4* yv = reinterpret_cast<uint4*>(yr + head);
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    uint4 raw = xv[i];
    uint4 out;
    const T* e = reinterpret_cast<const T*>(&raw);
    T* o = reinterpret_cast<T*>(&out);
    const S* s = scale + head + i * kVec;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      o[j] = from_f32<T>((to_f32(e[j]) * r) * to_f32(s[j]));
    }
    yv[i] = out;
  }
  for (int i = tail + threadIdx.x; i < d; i += blockDim.x) {
    yr[i] = from_f32<T>((to_f32(xr[i]) * r) * to_f32(scale[i]));
  }
}

template <typename T, typename S>
cudaError_t launch(const void* x, const void* scale, void* y, float* rstd,
                   long long rows, int d, float eps, int vec,
                   cudaStream_t stream) {
  // 256 threads keep a 4096-wide row at 2 (bf16) or 4 (f32) vectors a
  // thread; narrower rows take 128.
  const int threads = d >= 2048 ? 256 : 128;
  rmsnorm_kernel<T, S><<<static_cast<unsigned>(rows), threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(y), rstd, d, eps, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_scale(const void* x, const void* scale, void* y,
                           float* rstd, long long rows, int d, float eps,
                           int scale_f32, int vec, cudaStream_t stream) {
  if (scale_f32) {
    return launch<T, float>(x, scale, y, rstd, rows, d, eps, vec, stream);
  }
  return launch<T, T>(x, scale, y, rstd, rows, d, eps, vec, stream);
}

}  // namespace

extern "C" {

const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches K5' on `stream`, a stream of the current device, which must
// hold every pointer: x and y [rows, d] contiguous in the type
// `x_dtype` (0 f32, 1 bf16, 2 f16), scale [d] in f32 (`scale_f32`) or
// x's type, rstd [rows] f32.  `vec` allows 16-byte vectors (x and y
// share their alignment mod 16).  Returns the cudaError_t of the launch
// (0 on success); allocates nothing and does not synchronise.
int rmsnorm_forward(const void* x, const void* scale, void* y, void* rstd,
                    long long rows, int d, float eps, int x_dtype,
                    int scale_f32, int vec, void* stream) {
  if (rows < 1 || rows > 0x7fffffffLL || d < 1) return cudaErrorInvalidValue;
  float* r = static_cast<float*>(rstd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (x_dtype) {
    case kF32:
      e = launch<float, float>(x, scale, y, r, rows, d, eps, vec, s);
      break;
    case kBF16:
      e = dispatch_scale<__nv_bfloat16>(x, scale, y, r, rows, d, eps,
                                        scale_f32, vec, s);
      break;
    case kF16:
      e = dispatch_scale<__half>(x, scale, y, r, rows, d, eps, scale_f32,
                                 vec, s);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

}  // extern "C"
