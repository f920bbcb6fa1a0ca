// K1', K2', K3': flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of mpi_operator_tpu/ops/attention.py:
//   flash_fwd     <- `_flash_fwd_kernel`     (launched by `_flash_forward`)
//   flash_bwd_dq  <- `_flash_bwd_dq_kernel`  (launched by `_flash_backward`)
//   flash_bwd_dkv <- `_flash_bwd_dkv_kernel` (launched by `_flash_backward`)
// and computes what they compute, on the layout [B*H, S, D], contiguous,
// D in {64, 128}, bf16 or f32, causal or not, for any S >= 1:
//   fwd:  out = softmax(Q K^T * scale) V (in the input type or f32) and
//         lse = m + log(l) per row (the finite mask value for an empty row);
//   dq:   P = exp(S - lse), dP = dO V^T, dS = P o (dP - delta),
//         dQ = sum over kv tiles of dS K * scale;
//   dkv:  dV = sum over q tiles of P^T dO, dK = sum of dS^T Q * scale,
// where delta = rowsum(dO o O) - dlse is computed by the caller, as the JAX
// package does.  Masked scores take the finite mask value of the JAX
// kernel (-0.7 * FLT_MAX), so exp() gives 0 without inf or NaN.
//
// Bound: operations.  At the training shape (S = 4096, D = 128, bf16) each
// loaded K/V byte feeds ~2*64 flops per q tile and there are 64 q tiles
// per kv tile, far above the ~295 flops/byte where the H100's bf16 tensor
// cores (989 TFLOP/s) become the limit; the least time is the products'
// flops (2 per multiply-add; causal counts half) over that rate.
//
// Design.  The Pallas grid walks kv blocks in order and keeps m, l and acc
// in VMEM scratch between grid steps; blocks on Hopper run in no order, so
// each CTA owns one output tile and loops over the other axis itself:
//   * 64-row tiles, 4 warps, each warp owns 16 rows of the output tile;
//   * fwd and dq: CTA = (b*h, q tile), loop over kv tiles up to the
//     diagonal; dkv: CTA = (b*h, kv tile), loop over q tiles from the
//     diagonal on.  The heaviest causal tiles are launched first;
//   * the streamed tiles (K/V, or Q/dO with their lse/delta rows) go
//     through a two-stage cp.async ring in dynamic shared memory (one
//     stage for f32, whose tiles are twice as large), rows padded by 16
//     bytes against bank conflicts; the ragged last tile is zero-filled
//     and masked, so S need not be a multiple of 64;
//   * bf16 products run on the tensor cores with mma.sync m16n8k16 and
//     f32 accumulation; P and dS are rounded to bf16 for their product.
//     f32 products run as f32 FMAs in the same fragment layout (no TF32),
//     so the f32 path holds the plain version to 2e-5;
//   * the online softmax (running max m, sum l) and every accumulator are
//     f32 in registers; the dkv kernel computes S^T = K Q^T directly, so
//     every product reads its A operand row-major from shared memory;
//   * the GQA repeat of K/V stays in the caller, as in the JAX model.
// wgmma, TMA, warp specialisation and KV-head indexing are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kTile = 64;              // rows of a q or kv tile
constexpr int kWarps = 4;              // each owns 16 rows of the tile
constexpr int kThreads = kWarps * 32;
constexpr float kMaskValue = -0.7f * FLT_MAX;   // _MASK_VALUE of the JAX kernel
constexpr int kSmemLimit = 227 * 1024;
constexpr int kMaxDevices = 64;        // per-device attribute flags

enum DType { kF32 = 0, kBF16 = 1 };

template <typename T>
struct Traits;
template <>
struct Traits<float> {
  static constexpr int kPad = 4;       // elements: 16 bytes per row
  static constexpr int kStages = 1;    // f32 tiles are twice as large
};
template <>
struct Traits<__nv_bfloat16> {
  static constexpr int kPad = 8;
  static constexpr int kStages = 2;
};

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;        // 0 source bytes: zero fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + 64) of a [seq, D] head into a padded tile; rows past
// seq are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int seq, int tid) {
  constexpr int kElems = 16 / sizeof(T);
  constexpr int kChunks = D / kElems;            // 16-byte chunks per row
  constexpr int ld = D + Traits<T>::kPad;
  for (int c = tid; c < kTile * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * kElems;
    const int row = row0 + r;
    const bool valid = row < seq;
    cp_async16(dst + r * ld + col,
               src + static_cast<size_t>(valid ? row : 0) * D + col, valid);
  }
}

// 64 f32 values of a per-row vector (lse or delta), zero past seq.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int seq, int tid) {
  if (tid < kTile) {
    const int row = row0 + tid;
    const bool valid = row < seq;
    cp_async4(dst + tid, src + (valid ? row : 0), valid);
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp: acc += A[16 x K] * B[K x 8*NT].  A is row-major at As (lda);
// B(k, n) = Bs[n * ldb + k] when kBT, else Bs[k * ldb + n].  acc holds
// the m16n8 accumulator fragment: acc[j][e] is row g + 8*(e >> 1),
// column 8*j + 2*t + (e & 1), with g = lane / 4 and t = lane % 4.
template <int NT, int K, bool kBT>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][4],
                                          const __nv_bfloat16* As, int lda,
                                          const __nv_bfloat16* Bs, int ldb,
                                          int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[4];
    a[0] = ld32(As + g * lda + k0 + 2 * t);
    a[1] = ld32(As + (g + 8) * lda + k0 + 2 * t);
    a[2] = ld32(As + g * lda + k0 + 2 * t + 8);
    a[3] = ld32(As + (g + 8) * lda + k0 + 2 * t + 8);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = j * 8 + g;
      uint32_t b0, b1;
      if (kBT) {
        b0 = ld32(Bs + n * ldb + k0 + 2 * t);
        b1 = ld32(Bs + n * ldb + k0 + 2 * t + 8);
      } else {
        b0 = pack(Bs[(k0 + 2 * t) * ldb + n], Bs[(k0 + 2 * t + 1) * ldb + n]);
        b1 = pack(Bs[(k0 + 2 * t + 8) * ldb + n],
                  Bs[(k0 + 2 * t + 9) * ldb + n]);
      }
      mma_bf16(acc[j], a, b0, b1);
    }
  }
}

// The f32 counterpart: the same fragment layout, f32 FMAs (no TF32).
template <int NT, int K, bool kBT>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][4],
                                          const float* As, int lda,
                                          const float* Bs, int ldb,
                                          int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a0 = As[g * lda + k];
    const float a1 = As[(g + 8) * lda + k];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = j * 8 + 2 * t;
      float b0, b1;
      if (kBT) {
        b0 = Bs[n * ldb + k];
        b1 = Bs[(n + 1) * ldb + k];
      } else {
        b0 = Bs[k * ldb + n];
        b1 = Bs[k * ldb + n + 1];
      }
      acc[j][0] = fmaf(a0, b0, acc[j][0]);
      acc[j][1] = fmaf(a0, b1, acc[j][1]);
      acc[j][2] = fmaf(a1, b0, acc[j][2]);
      acc[j][3] = fmaf(a1, b1, acc[j][3]);
    }
  }
}

// A warp's fragment into its 16 rows of a [64 x 64] tile, in T.
template <typename T, int NT>
__device__ __forceinline__ void store_frag(T* dst, int ld,
                                           const float (&x)[NT][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dst[(g + 8 * (e >> 1)) * ld + j * 8 + 2 * t + (e & 1)] =
          from_f32<T>(x[j][e]);
    }
  }
}

// A warp's [16 x D] accumulator times `mul` into rows [row0, row0 + 16) of
// a [seq, D] output of type O; rows past seq are dropped.
template <typename O, int NT>
__device__ __forceinline__ void write_rows(O* out, int row0, int seq,
                                           const float (&acc)[NT][4],
                                           const float (&mul)[2], int lane) {
  constexpr int D = NT * 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= seq) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      O* dst = out + static_cast<size_t>(row) * D + j * 8 + 2 * t;
      dst[0] = from_f32<O>(acc[j][2 * r] * mul[r]);
      dst[1] = from_f32<O>(acc[j][2 * r + 1] * mul[r]);
    }
  }
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;      // [BH, S] (backward input)
  const float* delta;    // [BH, S] (backward input)
  void* out;             // fwd: [BH, S, D] in T, or f32 when out_f32
  float* lse_out;        // fwd: [BH, S]
  void* dq;
  void* dk;
  void* dv;
  int seq;
  float scale;
  int causal;
  int out_f32;
};

template <typename T, int D>
constexpr size_t fwd_smem() {
  constexpr int ld = D + Traits<T>::kPad, ldp = kTile + Traits<T>::kPad;
  return (static_cast<size_t>(kTile) * ld * (1 + 2 * Traits<T>::kStages) +
          kTile * ldp) * sizeof(T);
}

template <typename T, int D>
constexpr size_t dq_smem() {
  constexpr int ld = D + Traits<T>::kPad, ldp = kTile + Traits<T>::kPad;
  return (static_cast<size_t>(kTile) * ld * (2 + 2 * Traits<T>::kStages) +
          kTile * ldp) * sizeof(T);
}

template <typename T, int D>
constexpr size_t dkv_smem() {
  return dq_smem<T, D>() + 2 * Traits<T>::kStages * kTile * sizeof(float);
}

// ---- K1': forward -------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(Params p) {
  constexpr int kStages = Traits<T>::kStages;
  constexpr int ld = D + Traits<T>::kPad, ldp = kTile + Traits<T>::kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + kTile * ld;                    // [kStages][kTile][ld]
  T* Vs = Ks + kStages * kTile * ld;
  T* Ps = Vs + kStages * kTile * ld;          // [kTile][ldp]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rb = warp * 16;
  const int seq = p.seq;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int q0 = qt * kTile;
  const size_t head = static_cast<size_t>(blockIdx.x) * seq * D;
  const T* q = static_cast<const T*>(p.q) + head;
  const T* k = static_cast<const T*>(p.k) + head;
  const T* v = static_cast<const T*>(p.v) + head;
  const int n_kv = p.causal ? qt + 1 : (seq + kTile - 1) / kTile;

  load_tile<T, D>(Qs, q, q0, seq, tid);
  if (kStages == 2) {
    load_tile<T, D>(Ks, k, 0, seq, tid);
    load_tile<T, D>(Vs, v, 0, seq, tid);
  }
  cp_async_commit();

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kMaskValue, kMaskValue};
  float l[2] = {0.f, 0.f};

  for (int j = 0; j < n_kv; ++j) {
    const int buf = kStages == 2 ? (j & 1) : 0;
    if (kStages == 2) {
      if (j + 1 < n_kv) {
        load_tile<T, D>(Ks + (buf ^ 1) * kTile * ld, k, (j + 1) * kTile, seq,
                        tid);
        load_tile<T, D>(Vs + (buf ^ 1) * kTile * ld, v, (j + 1) * kTile, seq,
                        tid);
      }
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      load_tile<T, D>(Ks, k, j * kTile, seq, tid);
      load_tile<T, D>(Vs, v, j * kTile, seq, tid);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kb = Ks + buf * kTile * ld;
    const T* Vb = Vs + buf * kTile * ld;

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    warp_gemm<8, D, true>(s, Qs + rb * ld, ld, Kb, ld, lane);

    const int kv0 = j * kTile;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + rb + g + 8 * (e >> 1);
        const int col = kv0 + n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * p.scale;
        if (col >= seq || (p.causal && col > row)) x = kMaskValue;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float rs[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m[r] - mx[r]);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = expf(s[n][e] - mx[e >> 1]);
        s[n][e] = pe;
        rs[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
      m[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    store_frag<T, 8>(Ps + rb * ldp, ldp, s, lane);
    __syncwarp();
    warp_gemm<D / 8, kTile, false>(o, Ps + rb * ldp, ldp, Vb, ld, lane);
    __syncthreads();                        // before this stage is refilled
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / (l[r] > 0.f ? l[r] : 1.f);
  if (p.out_f32) {
    write_rows<float, D / 8>(static_cast<float*>(p.out) + head, q0 + rb, seq,
                             o, inv, lane);
  } else {
    write_rows<T, D / 8>(static_cast<T*>(p.out) + head, q0 + rb, seq, o, inv,
                         lane);
  }
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + rb + g + 8 * r;
      if (row < seq) {
        p.lse_out[static_cast<size_t>(blockIdx.x) * seq + row] =
            l[r] > 0.f ? m[r] + logf(l[r]) : kMaskValue;
      }
    }
  }
}

// ---- K2': dQ ------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(Params p) {
  constexpr int kStages = Traits<T>::kStages;
  constexpr int ld = D + Traits<T>::kPad, ldp = kTile + Traits<T>::kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + kTile * ld;
  T* Ks = dOs + kTile * ld;                   // [kStages][kTile][ld]
  T* Vs = Ks + kStages * kTile * ld;
  T* Ss = Vs + kStages * kTile * ld;          // dS, [kTile][ldp]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rb = warp * 16;
  const int seq = p.seq;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * kTile;
  const size_t head = static_cast<size_t>(blockIdx.x) * seq * D;
  const size_t rows = static_cast<size_t>(blockIdx.x) * seq;
  const T* q = static_cast<const T*>(p.q) + head;
  const T* k = static_cast<const T*>(p.k) + head;
  const T* v = static_cast<const T*>(p.v) + head;
  const T* dout = static_cast<const T*>(p.dout) + head;
  const int n_kv = p.causal ? qt + 1 : (seq + kTile - 1) / kTile;

  load_tile<T, D>(Qs, q, q0, seq, tid);
  load_tile<T, D>(dOs, dout, q0, seq, tid);
  if (kStages == 2) {
    load_tile<T, D>(Ks, k, 0, seq, tid);
    load_tile<T, D>(Vs, v, 0, seq, tid);
  }
  cp_async_commit();

  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rb + g + 8 * r;
    lse[r] = row < seq ? p.lse[rows + row] : 0.f;
    delta[r] = row < seq ? p.delta[rows + row] : 0.f;
  }
  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    const int buf = kStages == 2 ? (j & 1) : 0;
    if (kStages == 2) {
      if (j + 1 < n_kv) {
        load_tile<T, D>(Ks + (buf ^ 1) * kTile * ld, k, (j + 1) * kTile, seq,
                        tid);
        load_tile<T, D>(Vs + (buf ^ 1) * kTile * ld, v, (j + 1) * kTile, seq,
                        tid);
      }
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      load_tile<T, D>(Ks, k, j * kTile, seq, tid);
      load_tile<T, D>(Vs, v, j * kTile, seq, tid);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kb = Ks + buf * kTile * ld;
    const T* Vb = Vs + buf * kTile * ld;

    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
    warp_gemm<8, D, true>(s, Qs + rb * ld, ld, Kb, ld, lane);
    warp_gemm<8, D, true>(dp, dOs + rb * ld, ld, Vb, ld, lane);
    const int kv0 = j * kTile;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int row = q0 + rb + g + 8 * r;
        const int col = kv0 + n * 8 + 2 * t + (e & 1);
        const bool masked = col >= seq || (p.causal && col > row);
        const float pr = masked ? 0.f : expf(s[n][e] * p.scale - lse[r]);
        s[n][e] = pr * (dp[n][e] - delta[r]);
      }
    }
    store_frag<T, 8>(Ss + rb * ldp, ldp, s, lane);
    __syncwarp();
    warp_gemm<D / 8, kTile, false>(dq, Ss + rb * ldp, ldp, Kb, ld, lane);
    __syncthreads();
  }
  const float mul[2] = {p.scale, p.scale};
  write_rows<T, D / 8>(static_cast<T*>(p.dq) + head, q0 + rb, seq, dq, mul,
                       lane);
}

// ---- K3': dK, dV --------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(Params p) {
  constexpr int kStages = Traits<T>::kStages;
  constexpr int ld = D + Traits<T>::kPad, ldp = kTile + Traits<T>::kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + kTile * ld;
  T* Qs = Vs + kTile * ld;                    // [kStages][kTile][ld]
  T* dOs = Qs + kStages * kTile * ld;
  T* Ps = dOs + kStages * kTile * ld;         // P^T, then dS^T: [kTile][ldp]
  float* lse_s = reinterpret_cast<float*>(Ps + kTile * ldp);  // [kStages][64]
  float* delta_s = lse_s + kStages * kTile;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rb = warp * 16;
  const int seq = p.seq;
  const int kt = blockIdx.y;                  // kv tile 0 has the most work
  const int k0 = kt * kTile;
  const size_t head = static_cast<size_t>(blockIdx.x) * seq * D;
  const size_t rows = static_cast<size_t>(blockIdx.x) * seq;
  const T* q = static_cast<const T*>(p.q) + head;
  const T* k = static_cast<const T*>(p.k) + head;
  const T* v = static_cast<const T*>(p.v) + head;
  const T* dout = static_cast<const T*>(p.dout) + head;
  const int n_q = (seq + kTile - 1) / kTile;
  const int i0 = p.causal ? kt : 0;

  load_tile<T, D>(Ks, k, k0, seq, tid);
  load_tile<T, D>(Vs, v, k0, seq, tid);
  if (kStages == 2) {
    load_tile<T, D>(Qs, q, i0 * kTile, seq, tid);
    load_tile<T, D>(dOs, dout, i0 * kTile, seq, tid);
    load_rows(lse_s, p.lse + rows, i0 * kTile, seq, tid);
    load_rows(delta_s, p.delta + rows, i0 * kTile, seq, tid);
  }
  cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
  }

  for (int i = i0; i < n_q; ++i) {
    const int buf = kStages == 2 ? ((i - i0) & 1) : 0;
    if (kStages == 2) {
      if (i + 1 < n_q) {
        const int nb = buf ^ 1;
        const int r0 = (i + 1) * kTile;
        load_tile<T, D>(Qs + nb * kTile * ld, q, r0, seq, tid);
        load_tile<T, D>(dOs + nb * kTile * ld, dout, r0, seq, tid);
        load_rows(lse_s + nb * kTile, p.lse + rows, r0, seq, tid);
        load_rows(delta_s + nb * kTile, p.delta + rows, r0, seq, tid);
      }
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      load_tile<T, D>(Qs, q, i * kTile, seq, tid);
      load_tile<T, D>(dOs, dout, i * kTile, seq, tid);
      load_rows(lse_s, p.lse + rows, i * kTile, seq, tid);
      load_rows(delta_s, p.delta + rows, i * kTile, seq, tid);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Qb = Qs + buf * kTile * ld;
    const T* dOb = dOs + buf * kTile * ld;
    const float* lse_b = lse_s + buf * kTile;
    const float* delta_b = delta_s + buf * kTile;
    const int q0 = i * kTile;

    // S^T = K Q^T: rows are this warp's keys, columns the tile's queries.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    warp_gemm<8, D, true>(s, Ks + rb * ld, ld, Qb, ld, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + rb + g + 8 * (e >> 1);
        const int c = n * 8 + 2 * t + (e & 1);
        const int qi = q0 + c;
        const bool masked = qi >= seq || (p.causal && key > qi);
        s[n][e] = masked ? 0.f : expf(s[n][e] * p.scale - lse_b[c]);
      }
    }
    store_frag<T, 8>(Ps + rb * ldp, ldp, s, lane);
    __syncwarp();
    warp_gemm<D / 8, kTile, false>(dv, Ps + rb * ldp, ldp, dOb, ld, lane);

    // dP^T = V dO^T, dS^T = P^T o (dP^T - delta).
    float dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    warp_gemm<8, D, true>(dp, Vs + rb * ld, ld, dOb, ld, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);
        s[n][e] = s[n][e] * (dp[n][e] - delta_b[c]);
      }
    }
    __syncwarp();                             // every lane is done with P^T
    store_frag<T, 8>(Ps + rb * ldp, ldp, s, lane);
    __syncwarp();
    warp_gemm<D / 8, kTile, false>(dk, Ps + rb * ldp, ldp, Qb, ld, lane);
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  const float mul[2] = {p.scale, p.scale};
  write_rows<T, D / 8>(static_cast<T*>(p.dk) + head, k0 + rb, seq, dk, mul,
                       lane);
  write_rows<T, D / 8>(static_cast<T*>(p.dv) + head, k0 + rb, seq, dv, one,
                       lane);
}

// ---- host side ------------------------------------------------------------

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

// Raise the kernel's dynamic shared-memory limit once per device (the
// attribute belongs to the current device); a repeated call would cost
// host time on every launch.
template <typename K>
cudaError_t raise_smem(K kern, std::atomic<bool>* raised) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!raised[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemLimit);
    if (e != cudaSuccess) return e;
    raised[dev].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t launch(int kind, const Params& p, int bh, cudaStream_t stream) {
  static_assert(fwd_smem<T, D>() <= kSmemLimit, "fwd shared memory");
  static_assert(dq_smem<T, D>() <= kSmemLimit, "dq shared memory");
  static_assert(dkv_smem<T, D>() <= kSmemLimit, "dkv shared memory");
  static std::atomic<bool> raised[3][kMaxDevices];
  const dim3 grid(bh, (p.seq + kTile - 1) / kTile);
  cudaError_t e;
  switch (kind) {
    case kFwd:
      e = raise_smem(flash_fwd_kernel<T, D>, raised[kFwd]);
      if (e != cudaSuccess) return e;
      flash_fwd_kernel<T, D><<<grid, kThreads, fwd_smem<T, D>(), stream>>>(p);
      break;
    case kDq:
      e = raise_smem(flash_bwd_dq_kernel<T, D>, raised[kDq]);
      if (e != cudaSuccess) return e;
      flash_bwd_dq_kernel<T, D><<<grid, kThreads, dq_smem<T, D>(), stream>>>(p);
      break;
    case kDkv:
      e = raise_smem(flash_bwd_dkv_kernel<T, D>, raised[kDkv]);
      if (e != cudaSuccess) return e;
      flash_bwd_dkv_kernel<T, D>
          <<<grid, kThreads, dkv_smem<T, D>(), stream>>>(p);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

int dispatch(int kind, const Params& p, int bh, int head_dim, int dtype,
             void* stream) {
  if (bh < 1 || p.seq < 1 || (p.seq + kTile - 1) / kTile > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == kBF16 && head_dim == 64) {
    e = launch<__nv_bfloat16, 64>(kind, p, bh, s);
  } else if (dtype == kBF16 && head_dim == 128) {
    e = launch<__nv_bfloat16, 128>(kind, p, bh, s);
  } else if (dtype == kF32 && head_dim == 64) {
    e = launch<float, 64>(kind, p, bh, s);
  } else if (dtype == kF32 && head_dim == 128) {
    e = launch<float, 128>(kind, p, bh, s);
  }
  return static_cast<int>(e);
}

Params make_params(const void* q, const void* k, const void* v, int seq,
                   float scale, int causal) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.seq = seq;
  p.scale = scale;
  p.causal = causal;
  return p;
}

}  // namespace

extern "C" {

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each entry launches one kernel on `stream`, a stream of the current
// device, which must hold every pointer; tensors are [bh, seq, head_dim]
// (lse, delta: [bh, seq] f32), contiguous and 16-byte aligned.  Returns the
// cudaError_t of the launch (0 on success).  Allocates nothing and does
// not synchronise.  dtype: 0 f32, 1 bf16; head_dim 64 or 128.

int flash_fwd(const void* q, const void* k, const void* v, void* out,
              float* lse, int bh, int seq, int head_dim, float scale,
              int causal, int dtype, int out_f32, void* stream) {
  Params p = make_params(q, k, v, seq, scale, causal);
  p.out = out;
  p.lse_out = lse;
  p.out_f32 = out_f32;
  return dispatch(kFwd, p, bh, head_dim, dtype, stream);
}

int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, int bh, int seq, int head_dim, float scale,
                 int causal, int dtype, void* stream) {
  Params p = make_params(q, k, v, seq, scale, causal);
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  return dispatch(kDq, p, bh, head_dim, dtype, stream);
}

int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dk, void* dv, int bh, int seq, int head_dim,
                  float scale, int causal, int dtype, void* stream) {
  Params p = make_params(q, k, v, seq, scale, causal);
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dk = dk;
  p.dv = dv;
  return dispatch(kDkv, p, bh, head_dim, dtype, stream);
}

}  // extern "C"
