// K4': paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_paged_kernel_core`
// (mpi_operator_tpu/ops/paged_attention.py, launched by `_pallas_paged`)
// and computes what its reference `_xla_paged` computes: one decode step
// of attention, q [B, H, D] against a block pool [NB, page, KH, D]
// through block_table [B, MAXB] and lengths [B], with an optional int8
// pool (per-token-per-head f32 scales [NB, page, KH]) and an optional
// sliding window.
//
// Bound: device memory.  Each live K/V byte is used for 2*G flops (one
// multiply-add per query head of its group), far below the ~295
// flops/byte an H100 needs before compute limits, so the least time is
// the live K/V bytes (plus q and out) over the memory rate.  The design
// reads every live byte once and shares it across the whole group:
//   * one CTA per (row b, kv head); the CTA reads its own lengths[b] and
//     copies the live part of block_table[b, :] into shared memory once
//     (the TPU kernel's scalar prefetch), so issuing a chunk's copies
//     waits on no global load;
//   * the CTA walks only the live positions [lo, hi): hi = min(len,
//     MAXB*page), so an idle slot whose cache_index ran past the table
//     never reads past the end of its row, and lo = len - window with a
//     window, so whole pages before it are skipped;
//   * K/V tokens of this head are staged in shared memory in chunks of
//     `chunk` consecutive positions (across pages; 16-byte cp.async
//     copies, rows padded by 16 bytes) through a ring of kStages buffers,
//     so the next chunk is in flight while one is computed;
//   * all G = H/KH query heads of the group read each staged chunk (the
//     point of the TPU kernel's [Gp, D] tile);
//   * scores: a team of threads per (query head, token) dot product;
//     softmax: one warp per query head; P.V: one thread per (head, dim)
//     output, the chunk's tokens split over idle threads when G*D is
//     below the block size, summed once at the end;
//   * f32 online softmax (running max m, sum l) and f32 accumulators in
//     registers; out = acc / l, zeros where l == 0, cast to q's type;
//   * int8 pools fold the scales in after the products: s *= k_scale,
//     and p *= v_scale only after l has been updated with the unscaled p.
// Tensor cores (wgmma), TMA and split-K over long contexts are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxAcc = 32;          // accumulators per thread: G*D <= 8192
constexpr int kPad = 16;             // bytes of padding per staged row
// Two stages of 64 bf16 positions at head_dim 128 (70 KB) keep two CTAs
// on each SM; deeper rings or longer chunks measured slower (PERF.md).
constexpr int kStages = 2;           // cp.async ring depth
constexpr size_t kStageBudget = 96 * 1024;   // all K+V stage buffers
constexpr size_t kSmemLimit = 227 * 1024;
constexpr int kMaxDevices = 64;      // per-device attribute flags

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

// sum_i q[i] * x[i] over the 16 bytes of x (16 / sizeof(TP) elements).
template <typename TP>
__device__ __forceinline__ float dot16(const uint4& raw, const float* q) {
  const TP* x = reinterpret_cast<const TP*>(&raw);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 16 / static_cast<int>(sizeof(TP)); ++i) {
    s += q[i] * to_f32(x[i]);
  }
  return s;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Params {
  const void* q;          // [B, KH*G, D] TQ
  const void* k;          // [NB, page, KH, D] TP
  const void* v;          // [NB, page, KH, D] TP
  const float* k_scale;   // [NB, page, KH] (int8 pools only)
  const float* v_scale;   // [NB, page, KH] (int8 pools only)
  const int* table;       // [B, maxb]
  const int* lengths;     // [B]
  void* out;              // [B, KH*G, D] TQ
  int kv_heads, group, head_dim, page, maxb;
  float scale;
  int window;             // <= 0: no window
  int chunk;              // positions staged per step (multiple of 16)
};

// Shared memory of one CTA: kStages K and kStages V buffers of `chunk`
// padded rows, then q [G][D], scores [G][chunk], m/l/alpha [G], the int8
// scale stages [2][kStages][chunk] (f32) and the table row [maxb].
template <typename TP>
size_t smem_bytes(int group, int head_dim, int chunk, int maxb) {
  const size_t row = static_cast<size_t>(head_dim) * sizeof(TP) + kPad;
  return 2 * kStages * static_cast<size_t>(chunk) * row +
         sizeof(float) * (static_cast<size_t>(group) * head_dim +
                          static_cast<size_t>(group) * chunk + 3 * group +
                          2 * kStages * chunk) +
         sizeof(int) * static_cast<size_t>(maxb);
}

// Largest chunk whose stages fit the stage budget (and the whole CTA the
// shared-memory limit); 0 when even 16 positions do not fit.
template <typename TP>
int choose_chunk(int group, int head_dim, int maxb) {
  for (int chunk = 128; chunk >= 16; chunk /= 2) {
    const size_t row = static_cast<size_t>(head_dim) * sizeof(TP) + kPad;
    if ((2 * kStages * chunk * row <= kStageBudget || chunk == 16) &&
        smem_bytes<TP>(group, head_dim, chunk, maxb) <= kSmemLimit) {
      return chunk;
    }
  }
  return 0;
}

template <typename TQ, typename TP, bool kInt8>
__global__ void __launch_bounds__(kThreads, 2)
    paged_decode_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int G = p.group, D = p.head_dim, KH = p.kv_heads, page = p.page;
  const int T = p.chunk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ld = D + kPad / static_cast<int>(sizeof(TP));  // row pitch
  constexpr int kVec = 16 / sizeof(TP);                    // elems / 16B
  const int nvec = D / kVec;                               // 16B per row

  TP* kbuf = reinterpret_cast<TP*>(smem);             // [kStages][T][ld]
  TP* vbuf = kbuf + kStages * T * ld;                 // [kStages][T][ld]
  float* q_s = reinterpret_cast<float*>(vbuf + kStages * T * ld);  // [G][D]
  float* s_s = q_s + G * D;                                // [G][T]
  float* m_s = s_s + G * T;                                // [G]
  float* l_s = m_s + G;                                    // [G]
  float* a_s = l_s + G;                                    // [G] rescale
  float* ksc = a_s + G;                                    // [kStages][T]
  float* vsc = ksc + kStages * T;                          // [kStages][T]
  int* tbl_s = reinterpret_cast<int*>(vsc + kStages * T);  // [maxb]

  const int len = p.lengths[b];
  const int hi = min(len, p.maxb * page);   // never past the table row
  const int lo = p.window > 0 ? max(0, len - p.window) : 0;

  const size_t head0 = (static_cast<size_t>(b) * KH + head) * G * D;
  const TQ* q = static_cast<const TQ*>(p.q) + head0;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_f32(q[i]) * p.scale;
  }
  for (int i = tid; i < G; i += kThreads) {
    m_s[i] = -FLT_MAX;
    l_s[i] = 0.f;
  }
  if (hi > lo) {
    const int* row = p.table + static_cast<size_t>(b) * p.maxb;
    for (int j = lo / page + tid; j <= (hi - 1) / page; j += kThreads) {
      tbl_s[j] = row[j];
    }
  }

  // P.V work split: E = G*D outputs; below kThreads outputs, the chunk's
  // tokens are dealt round-robin to S groups of E threads.
  const int E = G * D;
  const int S = E >= kThreads ? 1 : kThreads / E;
  const int split = E >= kThreads ? 0 : tid / E;
  const bool pv_active = E >= kThreads || split < S;
  const int n_acc = E >= kThreads ? (E + kThreads - 1) / kThreads : 1;
  float acc[kMaxAcc];
#pragma unroll
  for (int k = 0; k < kMaxAcc; ++k) acc[k] = 0.f;

  // Scores work split: a team of tpd threads (a power of two dividing
  // the warp) per (query head, token) dot product.
  int tpd = 1;
  while (tpd < 32 && tpd * 2 <= nvec && G * T * tpd * 2 <= kThreads) {
    tpd *= 2;
  }

  const size_t tok_stride = static_cast<size_t>(KH) * D;
  const TP* kpool = static_cast<const TP*>(p.k) + static_cast<size_t>(head) * D;
  const TP* vpool = static_cast<const TP*>(p.v) + static_cast<size_t>(head) * D;

  auto stage = [&](int c, int buf) {
    const int pos0 = c * T;
    const int t_lo = max(lo - pos0, 0), t_hi = min(hi - pos0, T);
    TP* kd = kbuf + buf * T * ld;
    TP* vd = vbuf + buf * T * ld;
    for (int i = t_lo * nvec + tid; i < t_hi * nvec; i += kThreads) {
      const int t = i / nvec;
      const int col = (i - t * nvec) * kVec;
      const int pos = pos0 + t;
      const size_t tok =
          static_cast<size_t>(tbl_s[pos / page]) * page + pos % page;
      cp_async16(kd + t * ld + col, kpool + tok * tok_stride + col);
      cp_async16(vd + t * ld + col, vpool + tok * tok_stride + col);
    }
    if (kInt8) {
      for (int t = t_lo + tid; t < t_hi; t += kThreads) {
        const int pos = pos0 + t;
        const size_t s = (static_cast<size_t>(tbl_s[pos / page]) * page +
                          pos % page) * KH + head;
        cp_async4(ksc + buf * T + t, p.k_scale + s);
        cp_async4(vsc + buf * T + t, p.v_scale + s);
      }
    }
    cp_async_commit();
  };

  // One cp.async group per chunk (empty past the last chunk), so
  // wait_group<kStages - 1> always means "chunk c has landed".
  const int c_first = lo / T;
  const int c_last = hi > lo ? (hi - 1) / T : c_first - 1;
  __syncthreads();  // tbl_s visible to every issuing thread
  for (int s = 0; s < kStages - 1; ++s) {
    if (c_first + s <= c_last) {
      stage(c_first + s, s);
    } else {
      cp_async_commit();
    }
  }
  __syncthreads();  // q_s, m_s, l_s visible

  for (int c = c_first, it = 0; c <= c_last; ++c, ++it) {
    const int buf = it % kStages;
    if (c + kStages - 1 <= c_last) {
      // Its buffer held chunk c-1, released by the last barrier.
      stage(c + kStages - 1, (it + kStages - 1) % kStages);
    } else {
      cp_async_commit();
    }
    cp_async_wait<kStages - 1>();
    __syncthreads();

    const int pos0 = c * T;
    const int t_lo = max(lo - pos0, 0), t_hi = min(hi - pos0, T);
    const int n = t_hi - t_lo;
    const TP* kd = kbuf + buf * T * ld;
    const TP* vd = vbuf + buf * T * ld;

    // Scores s[g, t] = (q[g] . k[t]) (* k_scale[t]).  The loop bound is
    // uniform, so every lane reaches the team shuffles.
    for (int base = 0; base < G * n * tpd; base += kThreads) {
      const int i = base + tid;
      const int pair = i / tpd, member = i - pair * tpd;
      float part = 0.f;
      int g = 0, t = 0;
      if (pair < G * n) {
        g = pair / n;
        t = t_lo + pair - g * n;
        const uint4* krow = reinterpret_cast<const uint4*>(kd + t * ld);
        const float* qrow = q_s + g * D;
        for (int v = member; v < nvec; v += tpd) {
          part += dot16<TP>(krow[v], qrow + v * kVec);
        }
      }
      for (int o = tpd / 2; o > 0; o >>= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, o);
      }
      if (pair < G * n && member == 0) {
        if (kInt8) part *= ksc[buf * T + t];
        s_s[g * T + t] = part;
      }
    }
    __syncthreads();

    // Online softmax, one warp per query head.
    for (int g = warp; g < G; g += kWarps) {
      float* srow = s_s + g * T;
      const float m_prev = m_s[g];
      float m_new = m_prev;
      for (int t = t_lo + lane; t < t_hi; t += 32) m_new = fmaxf(m_new, srow[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, o));
      }
      float sum = 0.f;
      for (int t = t_lo + lane; t < t_hi; t += 32) {
        float pt = __expf(srow[t] - m_new);
        sum += pt;
        if (kInt8) pt *= vsc[buf * T + t];  // after l's update
        srow[t] = pt;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      }
      if (lane == 0) {
        const float alpha = __expf(m_prev - m_new);
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // acc[g, d] = acc * alpha[g] + sum_t p[g, t] * v[t, d].
    if (pv_active) {
#pragma unroll
      for (int k = 0; k < kMaxAcc; ++k) {
        if (k < n_acc) {
          const int e = (S > 1 ? tid - split * E : tid + k * kThreads);
          if (e < E) {
            const int g = e / D, d = e - g * D;
            const float* prow = s_s + g * T;
            float a = acc[k] * a_s[g];
            for (int t = t_lo + split; t < t_hi; t += S) {
              a += prow[t] * to_f32(vd[t * ld + d]);
            }
            acc[k] = a;
          }
        }
      }
    }
    __syncthreads();  // releases this buffer and s_s for the next chunk
  }

  TQ* out = static_cast<TQ*>(p.out) + head0;
  if (S > 1) {
    // Sum the token splits' partial accumulators (the stage buffers are
    // free now: every copy has landed and the last barrier has passed).
    float* red = reinterpret_cast<float*>(kbuf);
    if (pv_active) red[tid] = acc[0];
    __syncthreads();
    for (int e = tid; e < E; e += kThreads) {
      float a = 0.f;
      for (int j = 0; j < S; ++j) a += red[j * E + e];
      const float l = l_s[e / D];
      out[e] = from_f32<TQ>(l > 0.f ? a / l : 0.f);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kMaxAcc; ++k) {
      if (k < n_acc) {
        const int e = tid + k * kThreads;
        if (e < E) {
          const float l = l_s[e / D];
          out[e] = from_f32<TQ>(l > 0.f ? acc[k] / l : 0.f);
        }
      }
    }
  }
}

template <typename TQ, typename TP, bool kInt8>
cudaError_t launch(Params p, int batch, cudaStream_t stream) {
  p.chunk = choose_chunk<TP>(p.group, p.head_dim, p.maxb);
  if (p.chunk == 0) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<TP>(p.group, p.head_dim, p.chunk, p.maxb);
  auto kern = paged_decode_kernel<TQ, TP, kInt8>;
  // Raise this instantiation's dynamic shared-memory limit once per
  // device (the attribute belongs to the current device), to the most
  // any shape may ask; a repeated call would cost host time on every
  // decode step.
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  static std::atomic<bool> raised[kMaxDevices];
  if (!raised[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemLimit));
    if (e != cudaSuccess) return e;
    raised[dev].store(true, std::memory_order_release);
  }
  kern<<<dim3(p.kv_heads, batch), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t dispatch_pool(const Params& p, int batch, int pool_dtype,
                          cudaStream_t stream) {
  switch (pool_dtype) {
    case kF32: return launch<TQ, float, false>(p, batch, stream);
    case kBF16: return launch<TQ, __nv_bfloat16, false>(p, batch, stream);
    case kF16: return launch<TQ, __half, false>(p, batch, stream);
    case kI8: return launch<TQ, int8_t, true>(p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TP>
size_t smem_for(int group, int head_dim, int maxb) {
  const int chunk = choose_chunk<TP>(group, head_dim, maxb);
  return chunk ? smem_bytes<TP>(group, head_dim, chunk, maxb) : 0;
}

}  // namespace

extern "C" {

// Shared memory one CTA needs (0: the shape does not fit), for the
// wrapper's limit check.
size_t paged_decode_smem_bytes(int group, int head_dim, int max_blocks,
                               int pool_dtype) {
  switch (pool_dtype) {
    case kF32: return smem_for<float>(group, head_dim, max_blocks);
    case kBF16: return smem_for<__nv_bfloat16>(group, head_dim, max_blocks);
    case kF16: return smem_for<__half>(group, head_dim, max_blocks);
    case kI8: return smem_for<int8_t>(group, head_dim, max_blocks);
    default: return 0;
  }
}

const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches K4' on `stream`, a stream of the current device, which must
// hold every pointer; returns the cudaError_t of the launch (0 on
// success).  Allocates nothing and does not synchronise.
int paged_decode_attention(const void* q, const void* pool_k,
                           const void* pool_v, const void* k_scale,
                           const void* v_scale, const void* block_table,
                           const void* lengths, void* out, int batch,
                           int kv_heads, int group, int head_dim, int page,
                           int max_blocks, float scale, int window,
                           int q_dtype, int pool_dtype, void* stream) {
  if (head_dim % 32 != 0 || head_dim > 256 || group < 1 ||
      group * head_dim > kThreads * kMaxAcc || page < 1 || batch < 1 ||
      kv_heads < 1 || max_blocks < 1 ||
      (pool_dtype == kI8) != (k_scale != nullptr)) {
    return cudaErrorInvalidValue;
  }
  Params p;
  p.q = q;
  p.k = pool_k;
  p.v = pool_v;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.table = static_cast<const int*>(block_table);
  p.lengths = static_cast<const int*>(lengths);
  p.out = out;
  p.kv_heads = kv_heads;
  p.group = group;
  p.head_dim = head_dim;
  p.page = page;
  p.maxb = max_blocks;
  p.scale = scale;
  p.window = window;
  p.chunk = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (q_dtype) {
    case kF32: e = dispatch_pool<float>(p, batch, pool_dtype, s); break;
    case kBF16: e = dispatch_pool<__nv_bfloat16>(p, batch, pool_dtype, s); break;
    case kF16: e = dispatch_pool<__half>(p, batch, pool_dtype, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

}  // extern "C"
