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
// kernel (-0.7 * FLT_MAX) in the forward and P = 0 in the backward, so
// exp() gives 0 without inf or NaN.
//
// Bound: operations.  At the training shape (S = 4096, D = 128, bf16) each
// loaded K/V byte feeds ~2*64 flops per q tile and there are 64 q tiles
// per kv tile, far above the ~295 flops/byte where the H100's bf16 tensor
// cores (989 TFLOP/s) become the limit.  The least time is the products'
// flops over that rate, 2 per multiply-add over the unmasked (q, k)
// pairs: 2 products in the forward, 3 in dq (S, dP, dQ) and 4 in dkv
// (S^T, dP^T, dV, dK).  Both backward kernels recompute S and dP (and
// dkv S^T twice, below), so the pair issues 8 products where a fused
// backward would issue 5: that keeps each kernel the sole owner of its
// output tile, with no atomics, so two runs on the same inputs give
// bit-identical out, lse, dq, dk and dv.
//
// The Pallas grid walks the reduction axis in order and keeps its sums in
// VMEM scratch between grid steps; blocks on Hopper run in no order, so
// each CTA owns output tiles and loops over the other axis itself.  The
// heaviest causal tiles are launched first.  The GQA repeat of K/V stays
// in the caller, as in the JAX model.
//
// bf16 (flash_fwd_wgmma_kernel, flash_bwd_dq_wgmma_kernel,
// flash_bwd_dkv_wgmma_kernel):
//   * three warpgroups: two consumers and one producer; setmaxnreg moves
//     registers from the producer (56) to the consumers (224).  fwd and
//     dq: CTA = (b*h, 128 q rows), each consumer owns 64 of them.  dkv:
//     CTA = (b*h, 64 keys); consumer 0 accumulates dV, consumer 1 dK, and
//     each computes S^T itself (5 products instead of 4).  A consumer
//     that held both dK and dV of 64 keys needed 192 f32 accumulator
//     registers in contiguous blocks plus the P^T and dS^T fragments,
//     more than the 232 it could be given: ptxas spilled them around
//     every wgmma and serialised the wgmmas, which cost more than the
//     recomputed S^T;
//   * the producer streams K and V tiles (128 keys for fwd, 64 for dq;
//     64 rows of Q, dO and their lse and delta rows for dkv) with 16-byte
//     cp.async into a ring (three stages for fwd, two for dq and dkv)
//     guarded by full/empty mbarriers (cp.async.mbarrier.arrive), so
//     loads run under the consumers' products without __syncthreads;
//   * every product is a wgmma (m64n128k16 for the forward's S,
//     m64n64k16 for the backward's S and dP, m64n{D}k16 for O, dQ, dK,
//     dV) with f32 accumulators in registers.  Tiles sit in shared
//     memory in the 128-byte swizzle the wgmma descriptors read (no
//     padding, no bank conflicts); S and dP read both operands K-major,
//     the third product reads V, K, dO or Q MN-major through the
//     descriptor's transpose bit, and takes P or dS as its A operand from
//     registers: the accumulator fragment rounded to bf16 pairs, so P and
//     dS never touch shared memory;
//   * exp2 with the scale and log2(e) folded into one FMA; masks only on
//     the tiles that cross the diagonal or the end of the sequence.  The
//     forward's online softmax keeps the running max m in raw score
//     units and each thread's partial row sum l; the max is reduced over
//     the 4 lanes of a row every tile, the sum once at the end, and O is
//     rescaled by alpha = exp2((m_old - m_new) * scale * log2(e)) on
//     every tile (alpha is 1 where the max did not move; skipping the
//     rescale where no max in the warp moved measured slower);
//   * the forward overlaps its softmax with wgmma twice: inside a
//     consumer, S of tile j is issued together with P V of tile j - 1,
//     whose softmax is done; across the two consumers, named barriers
//     give them turns to issue their products (ping-pong), so one's
//     softmax runs under the other's products.  Its 128-key tiles make S
//     an m64n128k16 product, whose operands take 75% of the SM's
//     shared-memory bandwidth where m64n64k16 takes all of it;
//   * the ragged last tile is zero-filled on load and its rows dropped on
//     store, so S need not be a multiple of 64; the bf16 epilogue stages
//     the scaled output tile in the warpgroup's own (swizzled) input rows
//     and writes it as 16-byte vectors; the forward's f32 output (for
//     flash_attention_with_lse) goes out from registers as 8-byte pairs.
// f32: 64-row tiles, 4 warps of 16 rows each, one cp.async stage with
// padded rows, products as f32 FMAs in the mma.sync m16n8 fragment layout
// (no TF32), so the f32 path holds the plain version to 2e-5.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kTile = 64;              // rows of an f32 q or kv tile
constexpr int kWarps = 4;              // each owns 16 rows of the tile
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 4;                // f32 elements: 16 bytes per row
constexpr float kMaskValue = -0.7f * FLT_MAX;   // _MASK_VALUE of the JAX kernel
constexpr int kSmemLimit = 227 * 1024;
constexpr int kMaxDevices = 64;        // per-device attribute flags

enum DType { kF32 = 0, kBF16 = 1 };

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

// Rows [row0, row0 + 64) of an f32 [seq, D] head into a padded tile; rows
// past seq are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int seq, int tid) {
  constexpr int kChunks = D / 4;                 // 16-byte chunks per row
  constexpr int ld = D + kPad;
  for (int c = tid; c < kTile * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 4;
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

// One warp: acc += A[16 x K] * B[K x 8*NT] in f32 FMAs (no TF32).  A is
// row-major at As (lda); B(k, n) = Bs[n * ldb + k] when kBT, else
// Bs[k * ldb + n].  acc holds the m16n8 accumulator fragment: acc[j][e]
// is row g + 8*(e >> 1), column 8*j + 2*t + (e & 1), with g = lane / 4
// and t = lane % 4.
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

// A warp's fragment into its 16 rows of a [64 x 64] tile.
template <int NT>
__device__ __forceinline__ void store_frag(float* dst, int ld,
                                           const float (&x)[NT][4],
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dst[(g + 8 * (e >> 1)) * ld + j * 8 + 2 * t + (e & 1)] = x[j][e];
    }
  }
}

// A warp's [16 x D] accumulator times `mul` into rows [row0, row0 + 16) of
// an f32 [seq, D] output; rows past seq are dropped.
template <int NT>
__device__ __forceinline__ void write_rows(float* out, int row0, int seq,
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
      float* dst = out + static_cast<size_t>(row) * D + j * 8 + 2 * t;
      dst[0] = acc[j][2 * r] * mul[r];
      dst[1] = acc[j][2 * r + 1] * mul[r];
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

// The f32 kernels: one-stage [64 x D] tiles (three for the forward, four
// for the backward), a [64 x 64] one, and for dkv 64 lse and 64 delta
// values.
template <int D>
constexpr size_t fwd_smem() {
  constexpr int ld = D + kPad, ldp = kTile + kPad;
  return (static_cast<size_t>(kTile) * ld * 3 + kTile * ldp) * sizeof(float);
}

template <int D>
constexpr size_t dq_smem() {
  constexpr int ld = D + kPad, ldp = kTile + kPad;
  return (static_cast<size_t>(kTile) * ld * 4 + kTile * ldp) * sizeof(float);
}

template <int D>
constexpr size_t dkv_smem() {
  return dq_smem<D>() + 2 * kTile * sizeof(float);
}

// ---- K1' (f32): forward -----------------------------------------------------

// One stage: K and V are reloaded for each kv tile after the last product
// that reads the previous ones.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(Params p) {
  using T = float;
  constexpr int ld = D + kPad, ldp = kTile + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + kTile * ld;
  T* Vs = Ks + kTile * ld;
  T* Ps = Vs + kTile * ld;                    // [kTile][ldp]

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

  load_tile<D>(Qs, q, q0, seq, tid);
  cp_async_commit();

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kMaskValue, kMaskValue};
  float l[2] = {0.f, 0.f};

  for (int j = 0; j < n_kv; ++j) {
    load_tile<D>(Ks, k, j * kTile, seq, tid);
    load_tile<D>(Vs, v, j * kTile, seq, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    warp_gemm<8, D, true>(s, Qs + rb * ld, ld, Ks, ld, lane);

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
    store_frag<8>(Ps + rb * ldp, ldp, s, lane);
    __syncwarp();
    warp_gemm<D / 8, kTile, false>(o, Ps + rb * ldp, ldp, Vs, ld, lane);
    __syncthreads();                        // before K and V are refilled
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / (l[r] > 0.f ? l[r] : 1.f);
  write_rows<D / 8>(static_cast<float*>(p.out) + head, q0 + rb, seq, o, inv,
                    lane);
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

// ---- K2' (f32): dQ -------------------------------------------------------

// One stage: each f32 tile is reloaded after the last product that reads
// it (the tiles are twice as large as bf16's).
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(Params p) {
  using T = float;
  constexpr int ld = D + kPad, ldp = kTile + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + kTile * ld;
  T* Ks = dOs + kTile * ld;
  T* Vs = Ks + kTile * ld;
  T* Ss = Vs + kTile * ld;                    // dS, [kTile][ldp]

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

  load_tile<D>(Qs, q, q0, seq, tid);
  load_tile<D>(dOs, dout, q0, seq, tid);
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
    load_tile<D>(Ks, k, j * kTile, seq, tid);
    load_tile<D>(Vs, v, j * kTile, seq, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const T* Kb = Ks;
    const T* Vb = Vs;

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
    store_frag<8>(Ss + rb * ldp, ldp, s, lane);
    __syncwarp();
    warp_gemm<D / 8, kTile, false>(dq, Ss + rb * ldp, ldp, Kb, ld, lane);
    __syncthreads();
  }
  const float mul[2] = {p.scale, p.scale};
  write_rows<D / 8>(static_cast<T*>(p.dq) + head, q0 + rb, seq, dq, mul,
                    lane);
}

// ---- K3' (f32): dK, dV ---------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(Params p) {
  using T = float;
  constexpr int ld = D + kPad, ldp = kTile + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + kTile * ld;
  T* Qs = Vs + kTile * ld;
  T* dOs = Qs + kTile * ld;
  T* Ps = dOs + kTile * ld;                   // P^T, then dS^T: [kTile][ldp]
  float* lse_s = reinterpret_cast<float*>(Ps + kTile * ldp);  // [64]
  float* delta_s = lse_s + kTile;

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

  load_tile<D>(Ks, k, k0, seq, tid);
  load_tile<D>(Vs, v, k0, seq, tid);
  cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
  }

  for (int i = i0; i < n_q; ++i) {
    load_tile<D>(Qs, q, i * kTile, seq, tid);
    load_tile<D>(dOs, dout, i * kTile, seq, tid);
    load_rows(lse_s, p.lse + rows, i * kTile, seq, tid);
    load_rows(delta_s, p.delta + rows, i * kTile, seq, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const T* Qb = Qs;
    const T* dOb = dOs;
    const float* lse_b = lse_s;
    const float* delta_b = delta_s;
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
    store_frag<8>(Ps + rb * ldp, ldp, s, lane);
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
    store_frag<8>(Ps + rb * ldp, ldp, s, lane);
    __syncwarp();
    warp_gemm<D / 8, kTile, false>(dk, Ps + rb * ldp, ldp, Qb, ld, lane);
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  const float mul[2] = {p.scale, p.scale};
  write_rows<D / 8>(static_cast<T*>(p.dk) + head, k0 + rb, seq, dk, mul,
                    lane);
  write_rows<D / 8>(static_cast<T*>(p.dv) + head, k0 + rb, seq, dv, one,
                    lane);
}

// ---- K1', K2', K3' in bf16: wgmma, swizzled shared memory, warp
// specialisation

constexpr int kWgRows = 64;            // rows of one consumer warpgroup
constexpr int kCtaRows = 128;          // rows of a CTA: two consumers
constexpr int kWsThreads = 384;        // two consumers + one producer
constexpr int kConsumerThreads = 256;
constexpr int kProducerThreads = 128;
constexpr int kRing = 2;               // stages of the producer's ring
constexpr int kProducerRegs = 56;      // setmaxnreg: 128*56 + 256*224
constexpr int kConsumerRegs = 224;     //   = 384*168, the launch's share
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (r, c) of a bf16 tile of R rows, stored as D/64
// column blocks of R rows x 128 bytes whose 16-byte chunks are swizzled
// by r % 8: the 128-byte swizzle of wgmma (and TMA).  Tile bases are
// 1024-byte aligned, so the hardware's swizzle of the address matches.
template <int R>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 6) * (R * 128) + r * 128 +
         ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

// wgmma shared-memory descriptor with the 128-byte swizzle; the leading
// and stride byte offsets are in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo) << 16) |
         (static_cast<uint64_t>(sbo) << 32) | (1ull << 62);
}

// K-major operand: rows [r0, r0 + 64) of an R-row tile at k-step kk
// (columns 16kk .. 16kk + 15).  8-row groups are 1024 bytes apart; a
// k-step inside a 64-column block moves the start by 32 bytes.
template <int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int r0, int kk) {
  return make_desc(tile + (kk >> 2) * (R * 128) + r0 * 128 + (kk & 3) * 32,
                   1, 64);
}

// MN-major operand B[k][n] = tile[k][n] of an R-row tile at k-step kk
// (rows 16kk .. 16kk + 15, every column): 8-row groups 1024 bytes apart
// (stride offset), 64-column blocks R * 128 bytes apart (leading offset).
template <int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return make_desc(tile + kk * 2048, R * 8, 64);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup are running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from touching accumulators across an async wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Keeps register A fragments allocated until their wgmma has finished.
template <int K>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[kk][r])::"memory");
  }
}
// Generic-proxy writes (cp.async, st.shared) before async-proxy reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          bar)
      : "memory");
}
// One arrival on `bar` once every cp.async this thread issued has landed.
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
// Barrier of one warpgroup (ids 1 and 2; 0 is __syncthreads').
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}
// Barrier of both consumer warpgroups (id 3).
__device__ __forceinline__ void bar_sync_consumers() {
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
}
// The forward's turns (ids 4 and 5, one per consumer): a consumer waits
// on its own id for the other's arrival.
__device__ __forceinline__ void turn_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo: low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The wgmma accumulator of m64nN: thread t of the warpgroup holds, for
// each 8-column block j, d[4j + e] at row 16 * (t / 32) + (t % 32) / 4 +
// 8 * (e >> 1) and column 8j + 2 * (t % 4) + (e & 1).  Its bf16 pairs are
// the A fragment of the next product over those 64 columns: k-step kk
// takes blocks 2kk and 2kk + 1.
template <int K>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[K][4],
                                         const float (&d)[8 * K]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a[kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
    }
  }
}

// The scale-d predicate comes from a register (setp), as PTX takes no
// immediate there; the first product of a sum writes its accumulator
// without reading it, so no stale value is kept live across the loop.
// d[32] = A[64 x 16] * B[16 x 64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_init(float (&d)[32], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(a), "l"(b), "r"(0));
}

// d[32] += A[64 x 16] * B[16 x 64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d[64] = A[64 x 16] * B[16 x 128], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_init(float (&d)[64], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(a), "l"(b), "r"(0));
}

// d[64] += A[64 x 16] * B[16 x 128], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// d[32] += A[64 x 16] * B[16 x 64], A in registers (the bf16 pairs of an
// accumulator fragment), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64] += A[64 x 16] * B[16 x 128], A in registers (the bf16 pairs of an
// accumulator fragment), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Rows [row0, row0 + R) of a [seq, D] head into a swizzled R-row tile at
// `tile`, 16 bytes a cp.async, by the producer's 128 threads; rows past
// seq are zero-filled.
template <int R, int D>
__device__ __forceinline__ void load_tile_swz(uint32_t tile, const bf16* src,
                                              int row0, int seq, int t) {
  constexpr int kChunks = D / 8;
#pragma unroll 4
  for (int c = t; c < R * kChunks; c += kProducerThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const int row = row0 + r;
    const bool valid = row < seq;
    const bf16* g = src + static_cast<size_t>(valid ? row : 0) * D + col;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     tile + swz<R>(r, col)),
                 "l"(g), "r"(valid ? 16 : 0)
                 : "memory");
  }
}

// A warpgroup's [64 x D] accumulator, each of the thread's two rows times
// its factor mul[h], as bf16, into rows [r0, r0 + 64) of a swizzled R-row
// tile.
template <int R, int D>
__device__ __forceinline__ void stage_acc(unsigned char* tile, int r0,
                                          const float (&acc)[D / 2],
                                          const float (&mul)[2], int t) {
  const int r = r0 + 16 * (t >> 5) + ((t & 31) >> 2);
  const int c = 2 * (t & 3);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<uint32_t*>(tile + swz<R>(r + 8 * h, 8 * j + c)) =
          pack_bf16(acc[4 * j + 2 * h] * mul[h],
                    acc[4 * j + 2 * h + 1] * mul[h]);
    }
  }
}

// Rows [r0, r0 + 64) of a swizzled R-row tile to rows [row0, row0 + 64)
// of a [seq, D] output, 16 bytes a thread; rows past seq are dropped.
template <int R, int D>
__device__ __forceinline__ void store_rows(bf16* out, int row0, int seq,
                                           const unsigned char* tile, int r0,
                                           int t) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int c = t; c < kWgRows * kChunks; c += 128) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    if (row0 + r < seq) {
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(row0 + r) * D +
                                col) =
          *reinterpret_cast<const uint4*>(tile + swz<R>(r0 + r, col));
    }
  }
}

template <int D>
struct DqLayout {                      // byte offsets from a 1024-aligned base
  static constexpr int kTile = kWgRows * D * 2;       // one 64-row tile
  static constexpr int kQ = 0;                        // 128 rows
  static constexpr int kDO = kQ + 2 * kTile;          // 128 rows
  static constexpr int kK = kDO + 2 * kTile;          // [kRing] x 64 rows
  static constexpr int kV = kK + kRing * kTile;       // [kRing] x 64 rows
  static constexpr int kBar = kV + kRing * kTile;     // full, empty, q
  static constexpr int kBytes = kBar + (2 * kRing + 1) * 8 + 1024;
};

template <int D>
struct DkvLayout {
  static constexpr int kTile = kWgRows * D * 2;
  static constexpr int kK = 0;                        // 64 rows
  static constexpr int kV = kK + kTile;               // 64 rows
  static constexpr int kQ = kV + kTile;               // [kRing] x 64 rows
  static constexpr int kDO = kQ + kRing * kTile;      // [kRing] x 64 rows
  static constexpr int kLse = kDO + kRing * kTile;    // [kRing][64] f32
  static constexpr int kDelta = kLse + kRing * kWgRows * 4;
  static constexpr int kBar = kDelta + kRing * kWgRows * 4;
  static constexpr int kBytes = kBar + (2 * kRing + 1) * 8 + 1024;
};

// P of one (64 q rows, 64 keys) tile from S, in place.  kMask: the tile
// crosses the diagonal or the end of the sequence.
template <bool kMask>
__device__ __forceinline__ void dq_p(float (&s)[32], float sl2,
                                     const float (&nl2)[2], int row, int col,
                                     int seq, int causal) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    float pr = ex2(fmaf(s[i], sl2, nl2[h]));
    if (kMask) {
      const int c = col + 8 * (i >> 2) + (i & 1);
      if (c >= seq || (causal && c > row + 8 * h)) pr = 0.f;
    }
    s[i] = pr;
  }
}

// bf16 dS = P o (dP - delta) as the A fragment of dQ += dS K.
__device__ __forceinline__ void dq_ds(uint32_t (&ds)[4][4], float (&p)[32],
                                      const float (&dp)[32],
                                      const float (&dlt)[2]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] *= dp[i] - dlt[(i >> 1) & 1];
  acc_to_a(ds, p);
}

// ---- K1' (bf16): forward ----------------------------------------------------

constexpr int kKvRows = 128;           // keys of a forward kv tile
constexpr int kFwdRing = 3;            // a consumer holds two stages

template <int D>
struct FwdLayout {                     // byte offsets from a 1024-aligned base
  static constexpr int kTile = kKvRows * D * 2;       // one 128-row tile
  static constexpr int kQ = 0;                        // 128 rows
  static constexpr int kK = kQ + kTile;               // [kFwdRing] x 128 rows
  static constexpr int kV = kK + kFwdRing * kTile;    // [kFwdRing] x 128 rows
  static constexpr int kBar = kV + kFwdRing * kTile;  // full, empty, q
  static constexpr int kBytes = kBar + (2 * kFwdRing + 1) * 8 + 1024;
};

// One step of the online softmax over a (64 q rows, 128 keys) tile: S
// (raw scores) becomes P in place; the running max m (raw units) and this
// thread's partial row sums l are updated, and alpha is the factor O must
// be scaled by (1 where the max did not move).  kMask: the tile crosses
// the diagonal or the end of the sequence.
template <bool kMask>
__device__ __forceinline__ void fwd_softmax(float (&s)[64],
                                            float (&alpha)[2],
                                            float (&m)[2], float (&l)[2],
                                            float sl2, int row, int col,
                                            int seq, int causal) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int h = (i >> 1) & 1;
    if (kMask) {
      const int c = col + 8 * (i >> 2) + (i & 1);
      if (c >= seq || (causal && c > row + 8 * h)) s[i] = kMaskValue;
    }
    mx[h] = fmaxf(mx[h], s[i]);
  }
  float nm[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    alpha[h] = ex2((m[h] - mx[h]) * sl2);
    nm[h] = -mx[h] * sl2;
    m[h] = mx[h];
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int h = (i >> 1) & 1;
    const float pr = ex2(fmaf(s[i], sl2, nm[h]));
    s[i] = pr;
    l[h] += pr;
  }
}

// Issues S = Q K^T of consumer wg's 64 rows and a 128-key tile at ka.
template <int D>
__device__ __forceinline__ void fwd_s(float (&s)[64], uint32_t qa, int wg,
                                      uint32_t ka) {
  wgmma_ss_init(s, desc_k<kCtaRows>(qa, wg * kWgRows, 0),
                desc_k<kKvRows>(ka, 0, 0));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk) {
    wgmma_ss(s, desc_k<kCtaRows>(qa, wg * kWgRows, kk),
             desc_k<kKvRows>(ka, 0, kk));
  }
  wgmma_commit();
}

// Issues O += P V, P from registers, the V tile at va MN-major.
template <int N>
__device__ __forceinline__ void fwd_pv(float (&o)[N],
                                       const uint32_t (&pa)[8][4],
                                       uint32_t va) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    wgmma_rs(o, pa[kk], desc_mn<kKvRows>(va, kk));
  }
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_fwd_wgmma_kernel(Params p) {
  using L = FwdLayout<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t full = base + L::kBar, empty = full + 8 * kFwdRing;
  const uint32_t qbar = empty + 8 * kFwdRing;

  const int seq = p.seq;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int q0 = qt * kCtaRows;
  const size_t head = static_cast<size_t>(blockIdx.x) * seq * D;
  const int n_kv = p.causal ? qt + 1 : (seq + kKvRows - 1) / kKvRows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kFwdRing; ++s) {
      mbar_init(full + 8 * s, kProducerThreads);
      mbar_init(empty + 8 * s, kConsumerThreads);
    }
    mbar_init(qbar, kProducerThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;

  if (wg == 2) {
    // Producer: Q once, then K and V tiles through the ring.
    regs_dec<kProducerRegs>();
    const bf16* k = static_cast<const bf16*>(p.k) + head;
    const bf16* v = static_cast<const bf16*>(p.v) + head;
    load_tile_swz<kCtaRows, D>(base + L::kQ,
                               static_cast<const bf16*>(p.q) + head, q0, seq,
                               t);
    mbar_arrive_cp_async(qbar);
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % kFwdRing;
      mbar_wait(empty + 8 * s, ((j / kFwdRing) & 1) ^ 1);
      load_tile_swz<kKvRows, D>(base + L::kK + s * L::kTile, k, j * kKvRows,
                                seq, t);
      load_tile_swz<kKvRows, D>(base + L::kV + s * L::kTile, v, j * kKvRows,
                                seq, t);
      mbar_arrive_cp_async(full + 8 * s);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    // Consumer: 64 q rows.  Per 128-key tile j: S_j = Q K_j^T (both
    // operands K-major) is issued together with O += P_{j-1} V_{j-1} (P
    // from registers, V MN-major); the softmax of S_j runs while P V is
    // still on the tensor cores; then O is rescaled by alpha.  The causal
    // loop ends at the CTA's diagonal tile, so no tile lies wholly above
    // consumer 1's rows; consumer 0's half of that tile is masked.
    regs_inc<kConsumerRegs>();
    const int lane = t & 31;
    const int qw0 = q0 + wg * kWgRows;                 // first row of ours
    const int row = qw0 + 16 * (t >> 5) + (lane >> 2); // and h = 1: + 8
    const int col = 2 * (lane & 3);
    const float sl2 = p.scale * kLog2e;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};
    float s[64];
    const uint32_t qa = base + L::kQ;
    mbar_wait(qbar, 0);
    // The first tile that crosses the diagonal or the end of S.
    const int n_all = (seq + kKvRows - 1) / kKvRows;
    const int ragged = seq % kKvRows ? seq / kKvRows : n_all;
    const int mask_from = p.causal ? min(qt, ragged) : ragged;
    uint32_t pa[8][4];
    float alpha[2];
    // Ping-pong: the two consumers take turns issuing their products
    // (turn ids 4 + wg), so one's softmax runs under the other's wgmma.
    // Consumer 0 goes first; consumer 1 does not hand back its last turn,
    // so each id sees as many arrivals as waits.
    if (wg == 1) turn_arrive(4);
    mbar_wait(full, 0);
    fence_async_smem();
    turn_sync(4 + wg);
    wgmma_fence();
    fwd_s<D>(s, qa, wg, base + L::kK);
    turn_arrive(5 - wg);
    wgmma_wait<0>();
    fence_regs(s);
    if (mask_from == 0) {
      fwd_softmax<true>(s, alpha, m, l, sl2, row, col, seq, p.causal);
    } else {
      fwd_softmax<false>(s, alpha, m, l, sl2, row, col, seq, 0);
    }
    acc_to_a(pa, s);
    for (int j = 1; j < n_kv; ++j) {
      const int st = j % kFwdRing, prev = (j - 1) % kFwdRing;
      mbar_wait(full + 8 * st, (j / kFwdRing) & 1);
      fence_async_smem();
      turn_sync(4 + wg);
      wgmma_fence();
      fwd_s<D>(s, qa, wg, base + L::kK + st * L::kTile);
      fwd_pv(o, pa, base + L::kV + prev * L::kTile);
      turn_arrive(5 - wg);
      wgmma_wait<1>();                               // S has landed
      fence_regs(s);
      const int kv0 = j * kKvRows;
      if (j >= mask_from) {
        fwd_softmax<true>(s, alpha, m, l, sl2, row, kv0 + col, seq,
                            p.causal);
      } else {
        fwd_softmax<false>(s, alpha, m, l, sl2, row, kv0 + col, seq, 0);
      }
      wgmma_wait<0>();                               // P V has landed
      fence_regs(o);
      fence_frag(pa);
      mbar_arrive(empty + 8 * prev);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      acc_to_a(pa, s);
    }
    {
      const int last = (n_kv - 1) % kFwdRing;
      turn_sync(4 + wg);
      wgmma_fence();
      fwd_pv(o, pa, base + L::kV + last * L::kTile);
      if (wg == 0) turn_arrive(5);
      wgmma_wait<0>();
      fence_regs(o);
      fence_frag(pa);
      mbar_arrive(empty + 8 * last);
    }
    // Epilogue: l summed over the row's 4 lanes; out = O / l, lse in
    // natural-log units.
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      inv[h] = 1.f / (l[h] > 0.f ? l[h] : 1.f);
    }
    if (p.out_f32) {
      float* out = static_cast<float*>(p.out) + head;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        if (r >= seq) continue;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<float2*>(out + static_cast<size_t>(r) * D +
                                     8 * j + col) =
              make_float2(o[4 * j + 2 * h] * inv[h],
                          o[4 * j + 2 * h + 1] * inv[h]);
        }
      }
    } else {
      // Through our own Q rows (no other warpgroup reads them), out as
      // 16-byte rows.
      wg_sync(1 + wg);
      stage_acc<kCtaRows, D>(gbase + L::kQ, wg * kWgRows, o, inv, t);
      wg_sync(1 + wg);
      store_rows<kCtaRows, D>(static_cast<bf16*>(p.out) + head, qw0, seq,
                              gbase + L::kQ, wg * kWgRows, t);
    }
    if ((lane & 3) == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        if (r < seq) {
          p.lse_out[static_cast<size_t>(blockIdx.x) * seq + r] =
              l[h] > 0.f ? m[h] * p.scale + logf(l[h]) : kMaskValue;
        }
      }
    }
  }
}

// ---- K2' (bf16): dQ -------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_bwd_dq_wgmma_kernel(Params p) {
  using L = DqLayout<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t full = base + L::kBar, empty = full + 8 * kRing;
  const uint32_t qbar = empty + 8 * kRing;

  const int seq = p.seq;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int q0 = qt * kCtaRows;
  const size_t head = static_cast<size_t>(blockIdx.x) * seq * D;
  const int n_all = (seq + kWgRows - 1) / kWgRows;
  const int n_kv = p.causal ? min(n_all, (q0 + kCtaRows) / kWgRows) : n_all;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(full + 8 * s, kProducerThreads);
      mbar_init(empty + 8 * s, kConsumerThreads);
    }
    mbar_init(qbar, kProducerThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;

  if (wg == 2) {
    // Producer: Q and dO once, then K and V tiles through the ring.
    regs_dec<kProducerRegs>();
    const bf16* k = static_cast<const bf16*>(p.k) + head;
    const bf16* v = static_cast<const bf16*>(p.v) + head;
    load_tile_swz<kCtaRows, D>(base + L::kQ,
                               static_cast<const bf16*>(p.q) + head, q0, seq,
                               t);
    load_tile_swz<kCtaRows, D>(base + L::kDO,
                               static_cast<const bf16*>(p.dout) + head, q0,
                               seq, t);
    mbar_arrive_cp_async(qbar);
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % kRing;
      mbar_wait(empty + 8 * s, ((j / kRing) & 1) ^ 1);
      load_tile_swz<kWgRows, D>(base + L::kK + s * L::kTile, k, j * kWgRows,
                                seq, t);
      load_tile_swz<kWgRows, D>(base + L::kV + s * L::kTile, v, j * kWgRows,
                                seq, t);
      mbar_arrive_cp_async(full + 8 * s);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    // Consumer: 64 q rows; S = Q K^T and dP = dO V^T, both K-major, then
    // dQ += dS K with dS from registers and K MN-major.
    regs_inc<kConsumerRegs>();
    const int lane = t & 31;
    const int qw0 = q0 + wg * kWgRows;                 // first row of ours
    const int row = qw0 + 16 * (t >> 5) + (lane >> 2); // and h = 1: + 8
    const int col = 2 * (lane & 3);
    const size_t rows = static_cast<size_t>(blockIdx.x) * seq;
    const float sl2 = p.scale * kLog2e;
    float nl2[2], dlt[2];                              // -lse log2(e), delta
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool valid = row + 8 * h < seq;
      nl2[h] = valid ? -p.lse[rows + row + 8 * h] * kLog2e : 0.f;
      dlt[h] = valid ? p.delta[rows + row + 8 * h] : 0.f;
    }
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    float s[32], dp[32];
    const uint32_t qa = base + L::kQ, doa = base + L::kDO;
    mbar_wait(qbar, 0);
    for (int j = 0; j < n_kv; ++j) {
      const int st = j % kRing;
      mbar_wait(full + 8 * st, (j / kRing) & 1);
      const int kv0 = j * kWgRows;
      if (p.causal && kv0 > qw0 + kWgRows - 1) {     // above our diagonal
        mbar_arrive(empty + 8 * st);
        continue;
      }
      fence_async_smem();
      const uint32_t ka = base + L::kK + st * L::kTile;
      const uint32_t va = base + L::kV + st * L::kTile;
      wgmma_fence();
      wgmma_ss_init(s, desc_k<kCtaRows>(qa, wg * kWgRows, 0),
                    desc_k<kWgRows>(ka, 0, 0));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk) {
        wgmma_ss(s, desc_k<kCtaRows>(qa, wg * kWgRows, kk),
                 desc_k<kWgRows>(ka, 0, kk));
      }
      wgmma_commit();
      wgmma_ss_init(dp, desc_k<kCtaRows>(doa, wg * kWgRows, 0),
                    desc_k<kWgRows>(va, 0, 0));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk) {
        wgmma_ss(dp, desc_k<kCtaRows>(doa, wg * kWgRows, kk),
                 desc_k<kWgRows>(va, 0, kk));
      }
      wgmma_commit();
      wgmma_wait<1>();                               // S has landed
      fence_regs(s);
      if (kv0 + kWgRows > seq || (p.causal && kv0 + kWgRows - 1 > qw0)) {
        dq_p<true>(s, sl2, nl2, row, kv0 + col, seq, p.causal);
      } else {
        dq_p<false>(s, sl2, nl2, row, kv0 + col, seq, 0);
      }
      wgmma_wait<0>();                               // dP has landed
      fence_regs(dp);
      uint32_t ds[4][4];
      dq_ds(ds, s, dp, dlt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs(dq, ds[kk], desc_mn<kWgRows>(ka, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      fence_frag(ds);
      mbar_arrive(empty + 8 * st);
    }
    // Epilogue: dQ * scale through our own Q rows, out as 16-byte rows.
    wg_sync(1 + wg);
    const float mul[2] = {p.scale, p.scale};
    stage_acc<kCtaRows, D>(gbase + L::kQ, wg * kWgRows, dq, mul, t);
    wg_sync(1 + wg);
    store_rows<kCtaRows, D>(static_cast<bf16*>(p.dq) + head, qw0, seq,
                            gbase + L::kQ, wg * kWgRows, t);
  }
}

// bf16 P^T of one (64 keys, 64 q rows) tile from S^T, as the A fragment
// of dV += P^T dO; the tile's lse rows come from the ring.  kMask: the
// tile crosses the diagonal or the end of the sequence.
template <bool kMask>
__device__ __forceinline__ void dkv_p(uint32_t (&pa)[4][4], float (&s)[32],
                                      const float* lse, float sl2, int key,
                                      int q0, int col, int seq, int causal) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(lse + 8 * j + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      float pr = ex2(fmaf(s[i], sl2, -(e & 1 ? l.y : l.x) * kLog2e));
      if (kMask) {
        const int qi = q0 + 8 * j + col + (e & 1);
        if (qi >= seq || (causal && key + 8 * (e >> 1) > qi)) pr = 0.f;
      }
      s[i] = pr;
    }
  }
  acc_to_a(pa, s);
}

// bf16 dS^T = P^T o (dP^T - delta) from the bf16 P^T fragment (masked
// entries are 0 there), as the A fragment of dK += dS^T Q.  Taking P from
// its bf16 pairs frees the f32 S^T before dP^T is read.
__device__ __forceinline__ void dkv_ds(uint32_t (&dsa)[4][4],
                                       const uint32_t (&pa)[4][4],
                                       const float (&dp)[32],
                                       const float* delta, int col) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 d = *reinterpret_cast<const float2*>(delta + 8 * j + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // pa[j / 2][2 * (j % 2) + h] holds accumulator elements 4j + 2h, + 1.
      const int r = 2 * (j & 1) + h, i = 4 * j + 2 * h;
      const uint32_t pr = pa[j >> 1][r];
      const float lo = __uint_as_float(pr << 16);
      const float hi = __uint_as_float(pr & 0xffff0000u);
      dsa[j >> 1][r] = pack_bf16(lo * (dp[i] - d.x), hi * (dp[i + 1] - d.y));
    }
  }
}

// One consumer of K3' over the CTA's q tiles.  Each computes S^T = K Q^T
// (K-major operands) and P^T; kDk: dP^T = V dO^T, dS^T and dK += dS^T Q,
// else dV += P^T dO.  P^T and dS^T stay in registers as A operands.
template <int D, bool kDk>
__device__ __forceinline__ void dkv_consume(
    float (&acc)[D / 2], const Params& p, uint32_t base,
    const unsigned char* gbase, uint32_t full, uint32_t empty, int i0,
    int n_q, int k0, int key, int col, float sl2) {
  using L = DkvLayout<D>;
  const int seq = p.seq;
  const uint32_t ka = base + L::kK, va = base + L::kV;
  float s[32], dp[32];
  for (int i = i0; i < n_q; ++i) {
    const int n = i - i0, st = n % kRing;
    mbar_wait(full + 8 * st, (n / kRing) & 1);
    const int qt0 = i * kWgRows;
    fence_async_smem();
    const uint32_t qa = base + L::kQ + st * L::kTile;
    const uint32_t doa = base + L::kDO + st * L::kTile;
    const float* lse =
        reinterpret_cast<const float*>(gbase + L::kLse) + st * kWgRows;
    const float* delta =
        reinterpret_cast<const float*>(gbase + L::kDelta) + st * kWgRows;
    wgmma_fence();
    wgmma_ss_init(s, desc_k<kWgRows>(ka, 0, 0), desc_k<kWgRows>(qa, 0, 0));
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk) {
      wgmma_ss(s, desc_k<kWgRows>(ka, 0, kk), desc_k<kWgRows>(qa, 0, kk));
    }
    wgmma_commit();
    if constexpr (kDk) {
      wgmma_ss_init(dp, desc_k<kWgRows>(va, 0, 0),
                    desc_k<kWgRows>(doa, 0, 0));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk) {
        wgmma_ss(dp, desc_k<kWgRows>(va, 0, kk), desc_k<kWgRows>(doa, 0, kk));
      }
      wgmma_commit();
      wgmma_wait<1>();                               // S^T has landed
    } else {
      wgmma_wait<0>();
    }
    fence_regs(s);
    uint32_t pa[4][4];
    if (qt0 + kWgRows > seq || (p.causal && k0 + kWgRows - 1 > qt0)) {
      dkv_p<true>(pa, s, lse, sl2, key, qt0, col, seq, p.causal);
    } else {
      dkv_p<false>(pa, s, lse, sl2, key, qt0, col, seq, 0);
    }
    if constexpr (kDk) {
      wgmma_wait<0>();                               // dP^T has landed
      fence_regs(dp);
      uint32_t dsa[4][4];
      dkv_ds(dsa, pa, dp, delta, col);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs(acc, dsa[kk], desc_mn<kWgRows>(qa, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_frag(dsa);
    } else {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs(acc, pa[kk], desc_mn<kWgRows>(doa, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_frag(pa);
    }
    mbar_arrive(empty + 8 * st);
  }
}

// ---- K3' (bf16): dK, dV ---------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_bwd_dkv_wgmma_kernel(Params p) {
  using L = DkvLayout<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t full = base + L::kBar, empty = full + 8 * kRing;
  const uint32_t kvbar = empty + 8 * kRing;

  const int seq = p.seq;
  const int kt = blockIdx.y;                 // kv tile 0 has the most work
  const int k0 = kt * kWgRows;
  const size_t head = static_cast<size_t>(blockIdx.x) * seq * D;
  const size_t rows = static_cast<size_t>(blockIdx.x) * seq;
  const int n_q = (seq + kWgRows - 1) / kWgRows;
  const int i0 = p.causal ? kt : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(full + 8 * s, kProducerThreads);
      mbar_init(empty + 8 * s, kConsumerThreads);
    }
    mbar_init(kvbar, kProducerThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;

  if (wg == 2) {
    // Producer: K and V once, then Q, dO, lse and delta through the ring.
    regs_dec<kProducerRegs>();
    const bf16* q = static_cast<const bf16*>(p.q) + head;
    const bf16* dout = static_cast<const bf16*>(p.dout) + head;
    // Threads 0-63 copy lse rows, 64-127 delta rows, 4 bytes each.
    const float* vec = (t < kWgRows ? p.lse : p.delta) + rows;
    const uint32_t vdst = base + (t < kWgRows ? L::kLse : L::kDelta) +
                          (t % kWgRows) * 4;
    load_tile_swz<kWgRows, D>(base + L::kK,
                              static_cast<const bf16*>(p.k) + head, k0, seq,
                              t);
    load_tile_swz<kWgRows, D>(base + L::kV,
                              static_cast<const bf16*>(p.v) + head, k0, seq,
                              t);
    mbar_arrive_cp_async(kvbar);
    for (int i = i0; i < n_q; ++i) {
      const int n = i - i0, s = n % kRing;
      mbar_wait(empty + 8 * s, ((n / kRing) & 1) ^ 1);
      load_tile_swz<kWgRows, D>(base + L::kQ + s * L::kTile, q, i * kWgRows,
                                seq, t);
      load_tile_swz<kWgRows, D>(base + L::kDO + s * L::kTile, dout,
                                i * kWgRows, seq, t);
      const int r = i * kWgRows + t % kWgRows;
      const bool valid = r < seq;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                       vdst + s * kWgRows * 4),
                   "l"(vec + (valid ? r : 0)), "r"(valid ? 4 : 0)
                   : "memory");
      mbar_arrive_cp_async(full + 8 * s);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    // Consumers, both over the CTA's 64 keys: warpgroup 0 accumulates dV,
    // warpgroup 1 dK, so each holds one D-wide accumulator, not two.
    regs_inc<kConsumerRegs>();
    const int lane = t & 31;
    const int key = k0 + 16 * (t >> 5) + (lane >> 2);  // and h = 1: + 8
    const int col = 2 * (lane & 3);
    const float sl2 = p.scale * kLog2e;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    mbar_wait(kvbar, 0);
    // One loop per role, so no wgmma sits on a path that diverges inside
    // the loop (ptxas serialises those).
    if (wg == 0) {
      dkv_consume<D, false>(acc, p, base, gbase, full, empty, i0, n_q, k0,
                            key, col, sl2);
    } else {
      dkv_consume<D, true>(acc, p, base, gbase, full, empty, i0, n_q, k0,
                           key, col, sl2);
    }
    // Epilogue: once both warpgroups are done with K and V, dV goes out
    // through V's rows and dK * scale through K's.
    bar_sync_consumers();
    unsigned char* tile = gbase + (wg == 0 ? L::kV : L::kK);
    const float m = wg == 0 ? 1.f : p.scale;
    const float mul[2] = {m, m};
    stage_acc<kWgRows, D>(tile, 0, acc, mul, t);
    wg_sync(1 + wg);
    store_rows<kWgRows, D>(static_cast<bf16*>(wg == 0 ? p.dv : p.dk) + head,
                           k0, seq, tile, 0, t);
  }
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
  static std::atomic<bool> raised[3][kMaxDevices];
  cudaError_t e;
  if constexpr (std::is_same<T, float>::value) {
    static_assert(fwd_smem<D>() <= kSmemLimit, "fwd shared memory");
    static_assert(dq_smem<D>() <= kSmemLimit, "dq shared memory");
    static_assert(dkv_smem<D>() <= kSmemLimit, "dkv shared memory");
    const dim3 grid(bh, (p.seq + kTile - 1) / kTile);
    if (kind == kFwd) {
      e = raise_smem(flash_fwd_kernel<D>, raised[kFwd]);
      if (e != cudaSuccess) return e;
      flash_fwd_kernel<D><<<grid, kThreads, fwd_smem<D>(), stream>>>(p);
    } else if (kind == kDq) {
      e = raise_smem(flash_bwd_dq_kernel<D>, raised[kDq]);
      if (e != cudaSuccess) return e;
      flash_bwd_dq_kernel<D><<<grid, kThreads, dq_smem<D>(), stream>>>(p);
    } else if (kind == kDkv) {
      e = raise_smem(flash_bwd_dkv_kernel<D>, raised[kDkv]);
      if (e != cudaSuccess) return e;
      flash_bwd_dkv_kernel<D><<<grid, kThreads, dkv_smem<D>(), stream>>>(p);
    } else {
      return cudaErrorInvalidValue;
    }
  } else {
    static_assert(FwdLayout<D>::kBytes <= kSmemLimit, "fwd shared memory");
    static_assert(DqLayout<D>::kBytes <= kSmemLimit, "dq shared memory");
    static_assert(DkvLayout<D>::kBytes <= kSmemLimit, "dkv shared memory");
    const dim3 ws_grid(bh, (p.seq + kCtaRows - 1) / kCtaRows);
    if (kind == kFwd) {
      e = raise_smem(flash_fwd_wgmma_kernel<D>, raised[kFwd]);
      if (e != cudaSuccess) return e;
      flash_fwd_wgmma_kernel<D>
          <<<ws_grid, kWsThreads, FwdLayout<D>::kBytes, stream>>>(p);
    } else if (kind == kDq) {
      e = raise_smem(flash_bwd_dq_wgmma_kernel<D>, raised[kDq]);
      if (e != cudaSuccess) return e;
      flash_bwd_dq_wgmma_kernel<D>
          <<<ws_grid, kWsThreads, DqLayout<D>::kBytes, stream>>>(p);
    } else if (kind == kDkv) {
      e = raise_smem(flash_bwd_dkv_wgmma_kernel<D>, raised[kDkv]);
      if (e != cudaSuccess) return e;
      flash_bwd_dkv_wgmma_kernel<D>
          <<<dim3(bh, (p.seq + kWgRows - 1) / kWgRows), kWsThreads,
             DkvLayout<D>::kBytes, stream>>>(p);
    } else {
      return cudaErrorInvalidValue;
    }
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
