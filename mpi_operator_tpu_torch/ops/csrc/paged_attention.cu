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
// the live K/V bytes (plus q and out) over the memory rate.  What the
// design does about it:
//   * split over the sequence (flash-decoding): the grid is (kv head x
//     head tile, row, split); a CTA takes `split_len` consecutive
//     positions of one row and kv head, so a long row is read by many
//     SMs at once and short rows do not leave SMs idle.  The number of
//     splits comes from the table width MAXB*page (the host does not
//     know lengths without a sync); a CTA whose range lies wholly
//     outside the row's live positions [lo, hi) exits at once.  Each
//     split writes a partial (m, l, acc) in f32 to a workspace, and
//     `paged_merge_kernel` merges the live splits of each (row, head)
//     in split order.  No atomics: repeated calls give the same bits;
//   * warps own tokens: warp w of a CTA takes chunks w, w + nwarps, ...
//     of 16 consecutive positions, stages them through its own ring of
//     kStages buffers, and keeps its own running max, sum and
//     accumulator in registers.  There is no block-wide barrier per
//     chunk: the CTA's warps meet once, at the end, to merge through
//     shared memory.  Positions are looked up one by one in the CTA's
//     copy of its table slice (read in the same round trip as the row's
//     length), so any page size works; a page of one kv head is `page`
//     rows of D elements strided by KH*D;
//   * bytes in flight: each row of a chunk (D elements, a multiple of 16
//     bytes) is one bulk copy by the TMA, issued by its own lane and
//     counted on the stage's mbarrier; rows outside [lo, hi) are zeroed
//     instead (0 * stale bytes could be NaN).  Int8 pools, whose 4-byte
//     scales a bulk copy cannot move, stage by 16-byte cp.async with
//     consecutive lanes on one row, and zero-fill.  Two warps per CTA and
//     a three-stage ring fit four CTAs on an SM; splits of at most 512
//     positions (the host's `split_plan`) measured best over deeper
//     rings, more warps, cp.async for every pool and longer splits
//     (PERF.md);
//   * products on tensor cores (bf16, f16 and int8 pools): with up to 8
//     query heads of the group as the n dimension of mma.sync
//     m16n8k16, S^T = K Q^T takes 16 staged tokens as the A rows
//     (ldmatrix) and Q from registers, and O^T += V^T P^T takes V^T by
//     ldmatrix.trans and P^T from registers (the S^T accumulator packed
//     to 16 bits and transposed by movmatrix).  Each lane then holds the
//     same two heads in S, in O and in its softmax state, so the
//     rescale needs no shuffle.  wgmma needs 64 rows, and a group has
//     at most 8 heads here: it would compute 8-64x the needed products
//     and buys nothing in a kernel bound by bytes.  Int8 values are
//     widened exactly to bf16 in shared memory before the products;
//     the scales stay where the TPU kernel puts them: s *= k_scale
//     after Q K^T, p *= v_scale after l is updated.  f32 pools (a test
//     shape, not a serving one) take f32 FMAs in the same fragment
//     layout, so the softmax and the merges are shared;
//   * groups of more than 8 heads take ceil(G / 8) head tiles, each its
//     own CTA (the same K/V, read again from L2).
// Scores are kept in log2 units (scale * log2(e) folded in), so every
// exponential is one ex2.approx.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kChunk = 16;           // positions per warp step
constexpr int kHeadTile = 8;         // query heads per CTA (the mma's n)
constexpr int kMaxWarps = 2;         // warps per CTA (fewer if smem is short)
constexpr int kStages16 = 3;         // ring depth of 16-bit pools
constexpr int kPad = 16;             // bytes of padding per staged row
constexpr size_t kSmemLimit = 227 * 1024;
constexpr int kMaxDevices = 64;      // per-device attribute flags
constexpr float kLog2e = 1.4426950408889634f;

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3 };

// Ring depth: kStages16 for 16-bit pools; two for int8 pools (a third
// CTA on each SM hides the widening better than a deeper ring) and f32.
template <typename TP>
__host__ __device__ constexpr int stages_of() {
  return sizeof(TP) == 2 ? kStages16 : 2;
}

// Shared memory of one CTA, in bytes: the table slice, q of the head
// tile (f32 pools), then per warp its ring of stages (K rows, V rows,
// int8 scales), the int8 pools' bf16 copy of one chunk and the f32
// pools' P buffer.  The CTA's final merge reuses the warps' regions.
struct Layout {
  int pitch;        // bytes per staged row
  int stage;        // bytes of one stage
  int conv_pitch;   // bytes per row of the bf16 copy (int8 pools)
  int warp;         // bytes of one warp's region
  int head;         // bytes before the first warp's region
};

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline Layout layout_of(int head_dim, int elem, int dtype,
                                            int stages, int page,
                                            int split_len) {
  Layout l;
  l.pitch = head_dim * elem + kPad;
  l.stage = 2 * kChunk * l.pitch + (dtype == kI8 ? 2 * kChunk * 4 : 0);
  l.conv_pitch = 2 * head_dim + kPad;
  l.warp = stages * l.stage +
           (dtype == kI8 ? 2 * kChunk * l.conv_pitch : 0) +
           (dtype == kF32 ? kChunk * kHeadTile * 4 : 0) +
           round16(8 * stages);            // an mbarrier per stage (TMA)
  l.head = round16(4 * (split_len / page + 2)) +
           (dtype == kF32 ? kHeadTile * head_dim * 4 : 0);
  return l;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const int n = valid ? 16 : 0;        // 0 source bytes: zero fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// The phase's one arrival, expecting `bytes` from bulk copies.
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// `bytes` (a multiple of 16) from global to shared memory by the TMA,
// completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(smem)),
      "l"(gmem), "r"(bytes), "r"(bar)
      : "memory");
}

// Generic-proxy accesses of shared memory before async-proxy writes.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename TM>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo: low half
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four int8 values (one 32-bit word) as four bf16, exactly: each byte,
// biased to unsigned, becomes the low mantissa byte of 2^23 and the bias
// is subtracted in f32 (byte permutes and adds in place of the
// quarter-rate integer-to-float conversion).
__device__ __forceinline__ uint2 widen_i8x4(uint32_t w) {
  w ^= 0x80808080u;
  constexpr float kBias = 8388736.f;   // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650)) - kBias;
  const float f1 = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7651)) - kBias;
  const float f2 = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7652)) - kBias;
  const float f3 = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7653)) - kBias;
  return make_uint2(pack2<__nv_bfloat16>(f0, f1), pack2<__nv_bfloat16>(f2, f3));
}

// D (16x8, f32) += A (16x16) B (16x8), A row-major, B column-major.
template <typename TM>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<TM, __half>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&a)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_u32(p))
      : "memory");
}

// The 8x8 16-bit matrix held one row per 4 lanes, transposed.
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

__device__ __forceinline__ float load_as_f32(const void* p, size_t i,
                                             int dtype) {
  switch (dtype) {
    case kBF16:
      return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    case kF16: return __half2float(static_cast<const __half*>(p)[i]);
    default: return static_cast<const float*>(p)[i];
  }
}

struct Params {
  const void* q;          // [B, KH*G, D], q_dtype
  const void* k;          // [NB, page, KH, D] TP
  const void* v;          // [NB, page, KH, D] TP
  const float* k_scale;   // [NB, page, KH] (int8 pools only)
  const float* v_scale;   // [NB, page, KH] (int8 pools only)
  const int* table;       // [B, maxb]
  const int* lengths;     // [B]
  float* ws;              // partial acc [B*H, n_split, D], then m, l
  void* out;              // [B, KH*G, D], q_dtype
  int batch, kv_heads, group, head_dim, page, maxb;
  float scale;
  int window;             // <= 0: no window
  int q_dtype;
  int split_len, n_split, head_tiles;
};

// The live positions [lo, hi) of a row of length len: never past the
// table's end (an idle slot's length runs past it), from len - window
// with a window.
__device__ __forceinline__ void live_range(const Params& p, int len, int& lo,
                                           int& hi) {
  hi = min(len, p.maxb * p.page);
  lo = p.window > 0 ? max(0, len - p.window) : 0;
}

// One chunk's online-softmax step for the lane's two heads.  s[e] is the
// score of token gr + 8 * (e >> 1) and head 2 * qd + (e & 1), in log2
// units, -inf where masked; on return s holds p and alpha[j] the factor
// by which the lane's accumulators of head j are rescaled.
__device__ __forceinline__ void softmax_step(float (&s)[4], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float mx = fmaxf(s[j], s[2 + j]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
    const float m_new = fmaxf(m[j], mx);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    alpha[j] = ex2(m[j] - m_use);
    s[j] = ex2(s[j] - m_use);
    s[2 + j] = ex2(s[2 + j] - m_use);
    l[j] = l[j] * alpha[j] + s[j] + s[2 + j];   // this lane's tokens only
    m[j] = m_new;
  }
}

template <typename TP, int DMAX>
__global__ void __launch_bounds__(kMaxWarps * 32)
    paged_split_kernel(const Params p) {
  constexpr bool kF32Pool = std::is_same<TP, float>::value;
  constexpr bool kInt8 = std::is_same<TP, int8_t>::value;
  constexpr int kStages = stages_of<TP>();
  constexpr int kDType = kF32Pool ? kF32 : kInt8 ? kI8
                         : std::is_same<TP, __half>::value ? kF16 : kBF16;
  using TM = typename std::conditional<std::is_same<TP, __half>::value,
                                       __half, __nv_bfloat16>::type;
  constexpr int kMT = DMAX / 16;        // 16-wide steps over head_dim
  // Bulk copies by the TMA (rows are whole 16-byte multiples), except
  // for int8 pools, whose 4-byte scales a bulk copy cannot move: those
  // take cp.async.
  constexpr bool kTma = !kInt8;

  extern __shared__ __align__(16) unsigned char smem[];
  const int kvh = blockIdx.x / p.head_tiles;
  const int g0 = (blockIdx.x - kvh * p.head_tiles) * kHeadTile;
  const int b = blockIdx.y, split = blockIdx.z;
  const int G = p.group, D = p.head_dim, KH = p.kv_heads, page = p.page;
  const int ng = min(kHeadTile, G - g0);
  const int nwarps = blockDim.x >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, qd = lane & 3;

  const int base = split * p.split_len;
  const Layout L = layout_of(D, sizeof(TP), kDType, kStages, page,
                             p.split_len);
  int* tbl_s = reinterpret_cast<int*>(smem);
  float* q_s = reinterpret_cast<float*>(smem + round16(
                   4 * (p.split_len / page + 2)));          // f32 pools
  unsigned char* wbase = smem + L.head + warp * L.warp;

  // The table slice of the whole split is read together with lengths[b]
  // (one round trip before the first copy, not two); a CTA with no live
  // position then exits.
  const int len = p.lengths[b];
  const int j0 = base / page;
  {
    const int* row = p.table + static_cast<size_t>(b) * p.maxb;
    const int j1 = (min(base + p.split_len, p.maxb * page) - 1) / page;
    for (int j = j0 + tid; j <= j1; j += blockDim.x) tbl_s[j - j0] = row[j];
  }
  int lo, hi;
  live_range(p, len, lo, hi);
  const int s_lo = max(lo, base), s_hi = min(hi, base + p.split_len);
  if (s_lo >= s_hi) return;            // uniform over the CTA

  const int H = KH * G;
  const size_t qrow = (static_cast<size_t>(b) * H + kvh * G + g0) * D;
  if constexpr (kF32Pool) {
    for (int i = tid; i < kHeadTile * D; i += blockDim.x) {
      q_s[i] = i < ng * D ? load_as_f32(p.q, qrow + i, p.q_dtype) : 0.f;
    }
  }
  __syncthreads();                     // tbl_s (and q_s) visible

  const float sc = p.scale * kLog2e;
  const size_t tok_stride = static_cast<size_t>(KH) * D * sizeof(TP);
  const unsigned char* kpool = static_cast<const unsigned char*>(p.k) +
                               static_cast<size_t>(kvh) * D * sizeof(TP);
  const unsigned char* vpool = static_cast<const unsigned char*>(p.v) +
                               static_cast<size_t>(kvh) * D * sizeof(TP);
  const int vpr = D * static_cast<int>(sizeof(TP)) / 16;   // 16 B per row

  // This warp's chunks: i = c_first + warp, + nwarps, ... while <= c_last.
  const int c_first = (s_lo - base) / kChunk;
  const int c_last = (s_hi - 1 - base) / kChunk;
  const int n_mine = c_first + warp <= c_last
                         ? (c_last - c_first - warp) / nwarps + 1 : 0;

  const uint32_t bars = smem_u32(wbase + L.warp - round16(8 * kStages));
  if constexpr (kTma) {
    if (lane == 0) {
      for (int i = 0; i < kStages; ++i) mbar_init(bars + 8 * i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
  }

  auto stage = [&](int k, int buf) {
    unsigned char* st = wbase + buf * L.stage;
    const int pos0 = base + (c_first + warp + k * nwarps) * kChunk;
    if constexpr (kTma) {
      // Lane t < 16 copies K row t, lane 16 + t V row t; rows outside
      // [s_lo, s_hi) are zeroed by their lane (0 * garbage could be NaN).
      const int t = lane & 15;
      const int own = pos0 + t;
      const bool valid = own >= s_lo && own < s_hi;
      const int row_bytes = D * static_cast<int>(sizeof(TP));
      unsigned char* dst = st + ((lane >> 4) * kChunk + t) * L.pitch;
      const uint32_t bar = bars + 8 * buf;
      const uint32_t n = __popc(__ballot_sync(0xffffffffu, valid));
      fence_async_smem();
      if (lane == 0) mbar_arrive_tx(bar, n * row_bytes);
      if (valid) {
        const size_t tok =
            static_cast<size_t>(tbl_s[own / page - j0]) * page + own % page;
        bulk_copy(dst, (lane < 16 ? kpool : vpool) + tok * tok_stride,
                  row_bytes, bar);
      } else {
        for (int o = 0; o < row_bytes; o += 16) {
          *reinterpret_cast<uint4*>(dst + o) = make_uint4(0, 0, 0, 0);
        }
      }
      return;
    }
    // cp.async (int8 pools): lane t < 16 looks up token t; the warp then
    // copies whole rows, consecutive lanes on consecutive 16-byte pieces.
    const int own = pos0 + (lane & 15);
    const bool own_valid = own >= s_lo && own < s_hi;
    const int own_tok =
        own_valid ? tbl_s[own / page - j0] * page + own % page : 0;
    int t = lane / vpr, v = lane - t * vpr;
    for (int i = lane; i < kChunk * vpr; i += 32) {
      const int tok = __shfl_sync(0xffffffffu, own_tok, t);
      const bool valid = __shfl_sync(0xffffffffu, own_valid, t);
      const size_t off = static_cast<size_t>(tok) * tok_stride + 16 * v;
      cp_async16(st + t * L.pitch + 16 * v, kpool + off, valid);
      cp_async16(st + (kChunk + t) * L.pitch + 16 * v, vpool + off, valid);
      v += 32;
      while (v >= vpr) {
        v -= vpr;
        ++t;
      }
    }
    if constexpr (kInt8) {
      float* scales = reinterpret_cast<float*>(st + 2 * kChunk * L.pitch);
      const size_t s = static_cast<size_t>(own_tok) * KH + kvh;
      if (lane < 16) {
        cp_async4(scales + lane, p.k_scale + s, own_valid);
      } else {
        cp_async4(scales + lane, p.v_scale + s, own_valid);
      }
    }
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[kMT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;
  }

  // cp.async: one group per chunk (empty past the warp's last chunk), so
  // wait_group<kStages - 1> always means "chunk k has landed".  TMA: the
  // stage's mbarrier completes once per use, so chunk k waits on parity
  // (k / kStages) & 1.
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < n_mine) stage(k, k);
    cp_async_commit();
  }
  // Q as the B fragments of S^T = K Q^T: k-step kk, lane (gr, qd) holds
  // head gr, dims 16 kk + 2 qd + {0, 1} and + 8.  Heads past the tile
  // are zero.  Loaded while the first chunks are in flight.
  uint32_t qf[kMT][2];
  if constexpr (!kF32Pool) {
#pragma unroll
    for (int kk = 0; kk < kMT; ++kk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x0 = 0.f, x1 = 0.f;
        const int d = 16 * kk + 8 * h + 2 * qd;
        if (gr < ng && d < D) {
          x0 = load_as_f32(p.q, qrow + gr * D + d, p.q_dtype);
          x1 = load_as_f32(p.q, qrow + gr * D + d + 1, p.q_dtype);
        }
        qf[kk][h] = pack2<TM>(x0, x1);
      }
    }
  }
  for (int k = 0; k < n_mine; ++k) {
    if (k + kStages - 1 < n_mine) {
      // Its buffer held chunk k - 1, released by the last __syncwarp.
      stage(k + kStages - 1, (k + kStages - 1) % kStages);
    }
    if constexpr (kTma) {
      mbar_wait(bars + 8 * (k % kStages), (k / kStages) & 1);
    } else {
      cp_async_commit();
      cp_async_wait<kStages - 1>();
    }
    __syncwarp();                      // every lane's copies visible

    const unsigned char* st = wbase + (k % kStages) * L.stage;
    const int pos0 = base + (c_first + warp + k * nwarps) * kChunk;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    const float* scales = reinterpret_cast<const float*>(
        st + 2 * kChunk * L.pitch);

    if constexpr (kF32Pool) {
      const float* kt = reinterpret_cast<const float*>(st);
      const int ldf = L.pitch / 4;
      const float* k0 = kt + gr * ldf;
      const float* k1 = kt + (gr + 8) * ldf;
      const float* qa = q_s + 2 * qd * D;
      const float* qb = qa + D;
      for (int d = 0; d < D; d += 4) {
        const float4 x0 = *reinterpret_cast<const float4*>(k0 + d);
        const float4 x1 = *reinterpret_cast<const float4*>(k1 + d);
        const float4 a = *reinterpret_cast<const float4*>(qa + d);
        const float4 c = *reinterpret_cast<const float4*>(qb + d);
        s[0] += x0.x * a.x + x0.y * a.y + x0.z * a.z + x0.w * a.w;
        s[1] += x0.x * c.x + x0.y * c.y + x0.z * c.z + x0.w * c.w;
        s[2] += x1.x * a.x + x1.y * a.y + x1.z * a.z + x1.w * a.w;
        s[3] += x1.x * c.x + x1.y * c.y + x1.z * c.z + x1.w * c.w;
      }
    } else {
      const unsigned char* kt = st;
      const unsigned char* vt = st + kChunk * L.pitch;
      int pitch = L.pitch;
      if constexpr (kInt8) {
        // Widen the chunk to bf16 (exact for int8) in the warp's copy,
        // unrolled over the rows so the loads are issued together.
        unsigned char* conv = wbase + kStages * L.stage;
        const int nw = D / 4;              // 32-bit words per row
#pragma unroll
        for (int r = 0; r < 2 * kChunk; ++r) {
          const uint32_t* src =
              reinterpret_cast<const uint32_t*>(st + r * L.pitch);
          uint2* dst = reinterpret_cast<uint2*>(conv + r * L.conv_pitch);
#pragma unroll
          for (int c = 0; c < DMAX / 4; c += 32) {
            if (c + lane < nw) dst[c + lane] = widen_i8x4(src[c + lane]);
          }
        }
        __syncwarp();
        kt = conv;
        vt = conv + kChunk * L.conv_pitch;
        pitch = L.conv_pitch;
      }
      // S^T (16 tokens x 8 heads) = K Q^T over D.
      const unsigned char* ka = kt + (lane & 15) * pitch + (lane >> 4) * 16;
#pragma unroll
      for (int kk = 0; kk < kMT; ++kk) {
        if (16 * kk < D) {
          uint32_t a[4];
          ldsm_x4(a, ka + 32 * kk);
          mma16816<TM>(s, a, qf[kk][0], qf[kk][1]);
        }
      }
    }

    // Scale into log2 units (and by k_scale), mask, online softmax.
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = gr + 8 * (e >> 1);
      const int pos = pos0 + t;
      float x = s[e] * sc;
      if constexpr (kInt8) x *= scales[t];
      s[e] = (pos >= s_lo && pos < s_hi) ? x : -INFINITY;
    }
    float alpha[2];
    softmax_step(s, m, l, alpha);
    if constexpr (kInt8) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e] *= scales[kChunk + gr + 8 * (e >> 1)];
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][e] *= alpha[e & 1];
    }

    if constexpr (kF32Pool) {
      // P through the warp's buffer: every lane needs all 16 tokens of
      // its two heads.
      float* p_s = reinterpret_cast<float*>(wbase + kStages * L.stage);
      p_s[gr * kHeadTile + 2 * qd] = s[0];
      p_s[gr * kHeadTile + 2 * qd + 1] = s[1];
      p_s[(gr + 8) * kHeadTile + 2 * qd] = s[2];
      p_s[(gr + 8) * kHeadTile + 2 * qd + 1] = s[3];
      __syncwarp();
      const float* vt = reinterpret_cast<const float*>(st + kChunk * L.pitch);
      const int ldf = L.pitch / 4;
      for (int t = 0; t < kChunk; ++t) {
        const float2 pp =
            *reinterpret_cast<const float2*>(p_s + t * kHeadTile + 2 * qd);
        const float* vrow = vt + t * ldf + gr;
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          if (16 * mt < D) {
            const float v0 = vrow[16 * mt], v1 = vrow[16 * mt + 8];
            acc[mt][0] += pp.x * v0;
            acc[mt][1] += pp.y * v0;
            acc[mt][2] += pp.x * v1;
            acc[mt][3] += pp.y * v1;
          }
        }
      }
    } else {
      // P^T as the B fragments of O^T += V^T P^T: the S^T accumulator's
      // 16-bit pairs, each 8x8 block transposed.
      const uint32_t pb0 = movmatrix_t(pack2<TM>(s[0], s[1]));
      const uint32_t pb1 = movmatrix_t(pack2<TM>(s[2], s[3]));
      const unsigned char* vt = kInt8
          ? wbase + kStages * L.stage + kChunk * L.conv_pitch
          : st + kChunk * L.pitch;
      const int pitch = kInt8 ? L.conv_pitch : L.pitch;
      const unsigned char* va = vt + ((lane & 7) + ((lane >> 4) << 3)) * pitch +
                                ((lane >> 3) & 1) * 16;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        if (16 * mt < D) {
          uint32_t a[4];
          ldsm_x4_t(a, va + 32 * mt);
          mma16816<TM>(acc[mt], a, pb0, pb1);
        }
      }
    }
    __syncwarp();                      // releases this stage
  }
  cp_async_wait<0>();
  if constexpr (kTma) {
    if (lane == 0) {                   // the region is reused below
      for (int i = 0; i < kStages; ++i) {
        asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(
                         bars + 8 * i)
                     : "memory");
      }
    }
  }

  // The lane's l covers its own tokens: sum over the 8 lanes of a head.
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 4);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 8);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 16);
  }
  __syncthreads();                     // every warp is done with its ring

  // Merge the warps in warp order through the (now free) warp regions:
  // warp w writes acc [8 heads][D], then m[8], l[8].
  const int red_stride = kHeadTile * D + 2 * kHeadTile;
  float* red = reinterpret_cast<float*>(smem + L.head);
  {
    float* mine = red + warp * red_stride;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      if (16 * mt < D) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int g = 2 * qd + (e & 1);
          const int d = 16 * mt + gr + 8 * (e >> 1);
          mine[g * D + d] = acc[mt][e];
        }
      }
    }
    if (gr == 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mine[kHeadTile * D + 2 * qd + j] = m[j];
        mine[kHeadTile * D + kHeadTile + 2 * qd + j] = l[j];
      }
    }
  }
  __syncthreads();
  const size_t pair0 = static_cast<size_t>(b) * H + kvh * G + g0;
  float* ws_acc = p.ws;
  float* ws_m = p.ws + static_cast<size_t>(p.batch) * H * p.n_split * D;
  float* ws_l = ws_m + static_cast<size_t>(p.batch) * H * p.n_split;
  for (int e = tid; e < ng * D; e += blockDim.x) {
    const int g = e / D, d = e - g * D;
    float mx = -INFINITY;
    for (int w = 0; w < nwarps; ++w) {
      mx = fmaxf(mx, red[w * red_stride + kHeadTile * D + g]);
    }
    const float m_use = mx == -INFINITY ? 0.f : mx;
    float a = 0.f, ls = 0.f;
    for (int w = 0; w < nwarps; ++w) {
      const float* r = red + w * red_stride;
      const float f = ex2(r[kHeadTile * D + g] - m_use);
      a += r[g * D + d] * f;
      ls += r[kHeadTile * D + kHeadTile + g] * f;
    }
    const size_t slot = (pair0 + g) * p.n_split + split;
    ws_acc[slot * D + d] = a;
    if (d == 0) {
      ws_m[slot] = mx;
      ws_l[slot] = ls;
    }
  }
}

template <typename TQ>
__device__ __forceinline__ void store4(TQ* out, float4 y) {
  if constexpr (std::is_same<TQ, float>::value) {
    *reinterpret_cast<float4*>(out) = y;
  } else {
    uint2 v;
    v.x = pack2<TQ>(y.x, y.y);
    v.y = pack2<TQ>(y.z, y.w);
    *reinterpret_cast<uint2*>(out) = v;
  }
}

// out[b, h] from the live splits of row b, merged in split order; zeros
// where l == 0 (no live position).  One warp per (row, head): lane j
// reads m and l of splits s0 + j, + 32, ...; each lane then sums four
// (or eight) head dims over the splits in order, its loads issued eight
// splits at a time.
template <typename TQ>
__global__ void __launch_bounds__(128) paged_merge_kernel(const Params p) {
  const int H = p.kv_heads * p.group, D = p.head_dim;
  const int pair = blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (pair >= p.batch * H) return;
  const int b = pair / H;
  int lo, hi;
  live_range(p, p.lengths[b], lo, hi);
  const float* ws_acc = p.ws;
  const float* ws_m = p.ws + static_cast<size_t>(p.batch) * H * p.n_split * D;
  const float* ws_l = ws_m + static_cast<size_t>(p.batch) * H * p.n_split;
  const size_t slot0 = static_cast<size_t>(pair) * p.n_split;
  int s0 = 0, s1 = -1;                 // live splits [s0, s1]
  if (hi > lo) {
    s0 = lo / p.split_len;
    s1 = (hi - 1) / p.split_len;
  }
  float mx = -INFINITY;
  for (int s = s0 + lane; s <= s1; s += 32) mx = fmaxf(mx, ws_m[slot0 + s]);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
  }
  const float m_use = mx == -INFINITY ? 0.f : mx;
  float ls = 0.f;
  for (int s = s0 + lane; s <= s1; s += 32) {
    ls += ws_l[slot0 + s] * ex2(ws_m[slot0 + s] - m_use);
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, w);

  const int nv = D / 4;                // float4 per row (D <= 256: <= 64)
  const bool v0 = lane < nv, v1 = lane + 32 < nv;
  float4 o0 = make_float4(0.f, 0.f, 0.f, 0.f), o1 = o0;
  for (int c = s0; c <= s1; c += 32) {
    // This lane's split's factor; split c + j's is lane j's.
    const float f = c + lane <= s1 ? ex2(ws_m[slot0 + c + lane] - m_use)
                                   : 0.f;
    const int n = min(32, s1 - c + 1);
    for (int j = 0; j < n; j += 8) {
      float4 a0[8], a1[8];
      float fj[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        fj[u] = __shfl_sync(0xffffffffu, f, (j + u) & 31);
        a0[u] = a1[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j + u < n) {
          const float4* a = reinterpret_cast<const float4*>(
              ws_acc + (slot0 + c + j + u) * D);
          if (v0) a0[u] = a[lane];
          if (v1) a1[u] = a[lane + 32];
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (j + u < n) {
          o0.x += a0[u].x * fj[u];
          o0.y += a0[u].y * fj[u];
          o0.z += a0[u].z * fj[u];
          o0.w += a0[u].w * fj[u];
          o1.x += a1[u].x * fj[u];
          o1.y += a1[u].y * fj[u];
          o1.z += a1[u].z * fj[u];
          o1.w += a1[u].w * fj[u];
        }
      }
    }
  }
  const float r = ls > 0.f ? 1.f / ls : 0.f;
  TQ* out = static_cast<TQ*>(p.out) + static_cast<size_t>(pair) * D;
  if (v0) {
    store4(out + 4 * lane, make_float4(o0.x * r, o0.y * r, o0.z * r,
                                       o0.w * r));
  }
  if (v1) {
    store4(out + 4 * (lane + 32), make_float4(o1.x * r, o1.y * r, o1.z * r,
                                              o1.w * r));
  }
}

// Warps per CTA (at most kMaxWarps) whose shared memory fits; 0: none.
template <typename TP>
int warps_for(int head_dim, int dtype, int page, int split_len,
              size_t* smem) {
  const Layout L = layout_of(head_dim, sizeof(TP), dtype, stages_of<TP>(),
                             page, split_len);
  for (int w = kMaxWarps; w >= 1; --w) {
    const size_t bytes = static_cast<size_t>(L.head) +
                         static_cast<size_t>(w) * L.warp;
    if (bytes <= kSmemLimit) {
      *smem = bytes;
      return w;
    }
  }
  return 0;
}

// Raise a kernel's dynamic shared-memory limit once per device (the
// attribute belongs to the current device), to the most any shape may
// ask; a repeated call would cost host time on every decode step.
template <typename Kern>
cudaError_t raise_smem_once(Kern kern, std::atomic<bool>* raised) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!raised[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemLimit));
    if (e != cudaSuccess) return e;
    raised[dev].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

template <typename TP, int DMAX>
cudaError_t launch_split(const Params& p, int dtype, cudaStream_t stream) {
  size_t smem = 0;
  const int w = warps_for<TP>(p.head_dim, dtype, p.page, p.split_len, &smem);
  if (w == 0) return cudaErrorInvalidValue;
  auto kern = paged_split_kernel<TP, DMAX>;
  static std::atomic<bool> raised[kMaxDevices];
  cudaError_t e = raise_smem_once(kern, raised);
  if (e != cudaSuccess) return e;
  kern<<<dim3(p.kv_heads * p.head_tiles, p.batch, p.n_split), 32 * w, smem,
         stream>>>(p);
  return cudaGetLastError();
}

template <typename TP>
cudaError_t dispatch_dim(const Params& p, int dtype, cudaStream_t stream) {
  if (p.head_dim <= 64) return launch_split<TP, 64>(p, dtype, stream);
  if (p.head_dim <= 128) return launch_split<TP, 128>(p, dtype, stream);
  return launch_split<TP, 256>(p, dtype, stream);
}

template <typename TQ>
cudaError_t launch_merge(const Params& p, cudaStream_t stream) {
  const int pairs = p.batch * p.kv_heads * p.group;
  paged_merge_kernel<TQ><<<(pairs + 3) / 4, 128, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of one split CTA for this shape (0: it does not fit),
// for the wrapper's check, made once per shape.
size_t paged_decode_smem_bytes(int head_dim, int page, int split_len,
                               int pool_dtype) {
  size_t smem = 0;
  switch (pool_dtype) {
    case kF32: warps_for<float>(head_dim, kF32, page, split_len, &smem); break;
    case kBF16:
      warps_for<__nv_bfloat16>(head_dim, kBF16, page, split_len, &smem);
      break;
    case kF16: warps_for<__half>(head_dim, kF16, page, split_len, &smem); break;
    case kI8: warps_for<int8_t>(head_dim, kI8, page, split_len, &smem); break;
    default: break;
  }
  return smem;
}

const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches K4' (the split kernel, then the merge) on `stream`, a stream
// of `device`, which must hold every pointer; `workspace` holds
// batch * H * n_split * (head_dim + 2) floats.  The calling thread's
// current device is switched to `device` for the launches and restored.
// Returns the cudaError_t of the launches (0 on success).  Allocates
// nothing and does not synchronise.
int paged_decode_attention(const void* q, const void* pool_k,
                           const void* pool_v, const void* k_scale,
                           const void* v_scale, const void* block_table,
                           const void* lengths, void* out, void* workspace,
                           int batch, int kv_heads, int group, int head_dim,
                           int page, int max_blocks, float scale, int window,
                           int q_dtype, int pool_dtype, int split_len,
                           int n_split, int device, void* stream) {
  if (head_dim % 32 != 0 || head_dim > 256 || group < 1 || page < 1 ||
      batch < 1 || kv_heads < 1 || max_blocks < 1 || split_len < kChunk ||
      split_len % kChunk != 0 ||
      static_cast<long long>(split_len) * n_split <
          static_cast<long long>(max_blocks) * page ||
      (pool_dtype == kI8) != (k_scale != nullptr) || q_dtype < kF32 ||
      q_dtype > kF16) {
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
  p.ws = static_cast<float*>(workspace);
  p.out = out;
  p.batch = batch;
  p.kv_heads = kv_heads;
  p.group = group;
  p.head_dim = head_dim;
  p.page = page;
  p.maxb = max_blocks;
  p.scale = scale;
  p.window = window;
  p.q_dtype = q_dtype;
  p.split_len = split_len;
  p.n_split = n_split;
  p.head_tiles = (group + kHeadTile - 1) / kHeadTile;
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess && prev != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pool_dtype) {
    case kF32: e = dispatch_dim<float>(p, kF32, s); break;
    case kBF16: e = dispatch_dim<__nv_bfloat16>(p, kBF16, s); break;
    case kF16: e = dispatch_dim<__half>(p, kF16, s); break;
    case kI8: e = dispatch_dim<int8_t>(p, kI8, s); break;
    default: e = cudaErrorInvalidValue;
  }
  if (e == cudaSuccess) {
    switch (q_dtype) {
      case kF32: e = launch_merge<float>(p, s); break;
      case kBF16: e = launch_merge<__nv_bfloat16>(p, s); break;
      default: e = launch_merge<__half>(p, s); break;
    }
  }
  if (prev != device) {
    const cudaError_t r = cudaSetDevice(prev);
    if (e == cudaSuccess) e = r;
  }
  return static_cast<int>(e);
}

}  // extern "C"
