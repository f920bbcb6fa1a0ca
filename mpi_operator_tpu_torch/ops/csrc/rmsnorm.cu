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
// over the memory rate.  Two kernels; the caller picks one by shape and
// alignment (`row_vecs`, ops/rmsnorm.py `kernel_variant`):
//
// rmsnorm_rows_kernel<V> (row_vecs = V in {1, 2, 4, 8}): taken when x and
// y are 16-byte aligned, a row is a whole number of 16-byte vectors, and
// those vectors fit 256 threads x V.  One device read per row:
//   * a persistent grid (as many CTAs as fit on the card, at most one
//     per row) walks the rows; a CTA handles one row at a time with
//     ceil(vectors / V) threads (rounded up to a warp, at most 256), each
//     holding V 16-byte vectors of the row in registers between the sum
//     of squares and the output;
//   * the scale is read once per CTA, into f32 registers: a thread
//     always covers the same columns;
//   * the next row's vectors are loaded before the current row is
//     reduced, so each CTA keeps two rows' bytes in flight (with several
//     CTAs per SM, tens of KB per SM);
//   * one block-wide barrier per row: warp sums go to one of two
//     shared-memory slots (alternating by row), which the barrier of the
//     next row keeps from being overwritten before every warp read them;
//   * x is read and y written with streaming (evict-first) accesses.
// rmsnorm_kernel (row_vecs = 0): every other shape (rows wider than 256 x
// 8 vectors, rows that are not a whole number of vectors, x and y not
// 16-byte aligned):
//   * one CTA per row; pass 1 sums x^2 in f32 over a strided slice of the
//     row, a warp-shuffle reduction and one across the warps through
//     shared memory give every thread the row's sum;
//   * pass 2 reads the row again (from L1 or L2) and writes y;
//   * the row's 16-byte-aligned body moves as 16-byte vectors; an
//     unaligned head and a ragged tail take scalar loads.  The caller
//     turns vectors off when x and y do not share their alignment;
//   * scale is read per element.
// In both, scale may be f32 or x's type.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kF16 = 2;
constexpr int kMaxWarps = 32;
constexpr int kRowThreads = 256;       // at most, per row of the rows kernel
constexpr int kMaxDevices = 64;

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Sum of v over the block; every thread gets the total.  blockDim.x is
// a multiple of 32 and at most 1024.
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = lane < static_cast<int>(blockDim.x >> 5) ? warp_sums[lane] : 0.f;
  return warp_sum(v);
}

// ---- the rows kernel: one read per row, scale held per CTA -----------------

template <typename T, typename S, int V>
__global__ void __launch_bounds__(kRowThreads)
    rmsnorm_rows_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                        T* __restrict__ y, float* __restrict__ rstd,
                        long long rows, int d, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ float warp_sums[2][kRowThreads / 32];
  const int nvec = d / kVec;
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // Vector i = threadIdx.x + v * blockDim.x of every row is this thread's.
  bool mine[V];
  float sc[V][kVec];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int i = threadIdx.x + v * blockDim.x;
    mine[v] = i < nvec;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      sc[v][e] = mine[v] ? to_f32(scale[i * kVec + e]) : 0.f;
    }
  }

  long long row = blockIdx.x;
  uint4 cur[V], nxt[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const uint4* src = reinterpret_cast<const uint4*>(x + row * d);
    cur[v] = mine[v] ? __ldcs(src + threadIdx.x + v * blockDim.x)
                     : make_uint4(0, 0, 0, 0);
  }
  for (int it = 0; row < rows; ++it, row += gridDim.x) {
    const long long next = row + gridDim.x;
    if (next < rows) {
      const uint4* src = reinterpret_cast<const uint4*>(x + next * d);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        nxt[v] = mine[v] ? __ldcs(src + threadIdx.x + v * blockDim.x)
                         : make_uint4(0, 0, 0, 0);
      }
    }
    float ss = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const T* e = reinterpret_cast<const T*>(&cur[v]);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float f = to_f32(e[j]);
        ss = fmaf(f, f, ss);
      }
    }
    ss = warp_sum(ss);
    float* slot = warp_sums[it & 1];
    if (lane == 0) slot[warp] = ss;
    __syncthreads();
    float total = 0.f;
    for (int w = 0; w < warps; ++w) total += slot[w];
    const float r = rsqrtf(total / static_cast<float>(d) + eps);
    if (threadIdx.x == 0) rstd[row] = r;

    uint4* dst = reinterpret_cast<uint4*>(y + row * d);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (!mine[v]) continue;
      uint4 out;
      const T* e = reinterpret_cast<const T*>(&cur[v]);
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        o[j] = from_f32<T>((to_f32(e[j]) * r) * sc[v][j]);
      }
      __stcs(dst + threadIdx.x + v * blockDim.x, out);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) cur[v] = nxt[v];
  }
}

// ---- the two-pass kernel: any shape -----------------------------------------

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

// CTAs of the rows kernel that fit on the current device at `threads`,
// computed once per device and block size (the occupancy query costs
// host time on every launch otherwise).
template <typename T, typename S, int V>
cudaError_t rows_grid(int threads, int* ctas) {
  static std::atomic<int> cached[kMaxDevices][kRowThreads / 32 + 1];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::atomic<int>& slot = cached[dev][threads / 32];
  int n = slot.load(std::memory_order_acquire);
  if (n == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rmsnorm_rows_kernel<T, S, V>, threads, 0);
    if (e != cudaSuccess) return e;
    n = sms * (per_sm > 0 ? per_sm : 1);
    slot.store(n, std::memory_order_release);
  }
  *ctas = n;
  return cudaSuccess;
}

template <typename T, typename S, int V>
cudaError_t launch_rows(const void* x, const void* scale, void* y,
                        float* rstd, long long rows, int d, float eps,
                        cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int nvec = d / kVec;
  int threads = (nvec + V - 1) / V;
  threads = (threads + 31) / 32 * 32;
  if (d % kVec != 0 || threads > kRowThreads) return cudaErrorInvalidValue;
  int ctas = 0;
  cudaError_t e = rows_grid<T, S, V>(threads, &ctas);
  if (e != cudaSuccess) return e;
  const long long grid = rows < ctas ? rows : ctas;
  rmsnorm_rows_kernel<T, S, V>
      <<<static_cast<unsigned>(grid), threads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const S*>(scale),
          static_cast<T*>(y), rstd, rows, d, eps);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t launch(const void* x, const void* scale, void* y, float* rstd,
                   long long rows, int d, float eps, int vec, int row_vecs,
                   cudaStream_t stream) {
  switch (row_vecs) {
    case 0: {
      // 256 threads keep a 4096-wide row at 2 (bf16) or 4 (f32) vectors
      // a thread; narrower rows take 128.
      const int threads = d >= 2048 ? 256 : 128;
      rmsnorm_kernel<T, S><<<static_cast<unsigned>(rows), threads, 0,
                             stream>>>(
          static_cast<const T*>(x), static_cast<const S*>(scale),
          static_cast<T*>(y), rstd, d, eps, vec);
      return cudaGetLastError();
    }
    case 1:
      return launch_rows<T, S, 1>(x, scale, y, rstd, rows, d, eps, stream);
    case 2:
      return launch_rows<T, S, 2>(x, scale, y, rstd, rows, d, eps, stream);
    case 4:
      return launch_rows<T, S, 4>(x, scale, y, rstd, rows, d, eps, stream);
    case 8:
      return launch_rows<T, S, 8>(x, scale, y, rstd, rows, d, eps, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_scale(const void* x, const void* scale, void* y,
                           float* rstd, long long rows, int d, float eps,
                           int scale_f32, int vec, int row_vecs,
                           cudaStream_t stream) {
  if (scale_f32) {
    return launch<T, float>(x, scale, y, rstd, rows, d, eps, vec, row_vecs,
                            stream);
  }
  return launch<T, T>(x, scale, y, rstd, rows, d, eps, vec, row_vecs,
                      stream);
}

}  // namespace

extern "C" {

const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches K5' on `stream`, a stream of the current device, which must
// hold every pointer: x and y [rows, d] contiguous in the type
// `x_dtype` (0 f32, 1 bf16, 2 f16), scale [d] in f32 (`scale_f32`) or
// x's type, rstd [rows] f32.  `row_vecs` picks the kernel: 0 the
// two-pass kernel, where `vec` allows 16-byte vectors (x and y share
// their alignment mod 16); 1, 2, 4 or 8 the rows kernel with that many
// 16-byte vectors a thread (x and y 16-byte aligned, d * element size a
// multiple of 16, at most 256 * row_vecs vectors a row).  Returns the
// cudaError_t of the launch (0 on success); allocates nothing and does
// not synchronise.
int rmsnorm_forward(const void* x, const void* scale, void* y, void* rstd,
                    long long rows, int d, float eps, int x_dtype,
                    int scale_f32, int vec, int row_vecs, void* stream) {
  if (rows < 1 || rows > 0x7fffffffLL || d < 1) return cudaErrorInvalidValue;
  if (row_vecs != 0 &&
      (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
       reinterpret_cast<uintptr_t>(y) % 16 != 0)) {
    return cudaErrorInvalidValue;
  }
  float* r = static_cast<float*>(rstd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (x_dtype) {
    case kF32:
      e = launch<float, float>(x, scale, y, r, rows, d, eps, vec, row_vecs,
                               s);
      break;
    case kBF16:
      e = dispatch_scale<__nv_bfloat16>(x, scale, y, r, rows, d, eps,
                                        scale_f32, vec, row_vecs, s);
      break;
    case kF16:
      e = dispatch_scale<__half>(x, scale, y, r, rows, d, eps, scale_f32,
                                 vec, row_vecs, s);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

}  // extern "C"
