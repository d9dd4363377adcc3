// Shared by the vector-attention kernels (vecattn_fwd.cu, vecattn_bwd.cu): the
// block shape, and the product of a block's edge rows with a (D, D) weight
// on the tensor cores, the weight streamed through shared memory that a
// thread-block cluster shares. Each product has two instances, by the
// weight's element type W: f32 weights (3×TF32, below) and bf16 weights (the
// bf16 mode, further below).
//
// A block of 256 threads (8 warps) holds E = 16·TQ edge rows (TQ = 1024/D
// queries, 16 neighbour slots each) as (E, D) f32 tiles in shared memory,
// rows padded to D + 4 floats. Outside the products a thread (query, 4
// channels) owns the 16 × 4 tile of its query's 16 rows.
//
// The product, `rows_times_weights`: out (E, D) = A (E, D) · W (D, D), f32.
// - Tensor cores, 3×TF32. `mma.sync.m16n8k8` multiplies TF32 operands (10
//   mantissa bits) and sums in f32. One TF32 pass keeps about 3 decimal
//   digits, and the kernels are held to 1e-5 of the plain f32 version on
//   the card. So each operand is split, hi = tf32(x) and lo = tf32(x - hi),
//   which together keep about 22 of f32's 24 bits, and the product sums
//   lo·hi + hi·lo and then hi·hi into one f32 accumulator (lo·lo, below
//   f32's rounding, is dropped). Each warp owns a 32 × 64 tile of the
//   output. The tensor cores sum toward zero at the scale of the largest
//   term, so each 16-term chunk of the inner index is summed in a fresh
//   accumulator and added to the running sum with an f32 add.
// - The weight stream. W's rows come in chunks of 16 (32 KB at D = 512)
//   through a ring of kStages stages. The kCluster blocks of a cluster
//   (consecutive query tiles of one cloud) share every chunk: each block
//   copies 16/kCluster of its rows with one `cp.async.bulk`, multicast into
//   the same stage of every block of the cluster, so each weight byte leaves
//   L2 once per cluster instead of once per block. A stage's `full`
//   mbarrier counts the bytes that land in it; its `empty` mbarrier counts
//   the cluster's blocks that are done reading it, and a block writes a
//   stage again only after every block of its cluster has released it.
//   A bulk copy cannot pad, so the caller pads W's rows to D + 8 floats in
//   global memory (`WEIGHT_PAD` in ops/vector_attention.py).
// - Bank conflicts. With rows of D + 4 (activations) and D + 8 (weights)
//   floats, the 32 lanes of a fragment load (row lane/4, column lane%4, or
//   the transpose for W) hit 32 different banks.
// The chunks form one stream across a kernel's products: a product issues
// the first chunks of the next weight while it finishes its own, so the
// copies overlap the epilogue between two products.
//
// The bf16 mode (W = __nv_bfloat16; the TPU kernels' `precise=False`,
// sug_tpu/ops/vector_attention_pallas.py `_bdot` :76): the caller rounds the
// weights to bf16, and a product rounds its A operand, the f32 activation
// tile, to bf16 (`__float2bfloat16_rn`) as it loads the fragments, then runs
// one `mma.sync.m16n8k16.bf16` per chunk of 16 (one k16 step), f32 sums. Two
// bf16 values multiply exactly in f32, so the mode's only roundings are the
// operands'. The chunk's stage holds bf16 rows of D + kWPad elements, half
// the bytes of the f32 stage. A k16 step's 16 inner indices may sit in the
// mma's slots in any order, as long as A and W agree: slot 2t, 2t+1, 2t+8,
// 2t+9 of lane (g, t) takes inner index t, t+4, t+8, t+12, so a fragment
// load reads A at (row g, column t + 4i) as the TF32 fragments do, and W at
// (row t + 4i, column g): with W rows of D + 8 bf16 (D/2 + 4 words), the 32
// lanes of a load touch 16 distinct words in 16 banks, two lanes a word.
//
// Sums: every output element is summed in a fixed order (the tensor cores'
// within a chunk of 16, the chunks ascending in f32), so two launches on the
// same inputs agree bit for bit. No float atomics.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;   // 8 warps per block
constexpr int kMaxK = 16;       // neighbour slots per query
constexpr int kCols = 4;        // channels per thread outside the products (one float4)
constexpr int kChunk = 16;      // weight rows per pipeline stage
constexpr int kStages = 3;      // the ring: two chunks in flight while one is read
constexpr int kCluster = 2;     // blocks that share each weight chunk
constexpr int kKSteps = kChunk / 8;        // mma k-steps per chunk
constexpr int kRowsPerBlock = 1024;  // TQ·D
constexpr int kMaxD = 512;
constexpr int kActPad = 4;      // floats past D in an activation row
constexpr int kWPad = 8;        // elements past D in a staged weight row (f32 or bf16)
constexpr size_t kSmemLimit = 227 * 1024;
// the 2·kStages mbarriers (8 bytes each) at the start of dynamic shared
// memory, padded to keep what follows 128-byte aligned
constexpr size_t kBarrierBytes = 128;

static_assert(kChunk % kCluster == 0, "each block of a cluster copies whole weight rows");
static_assert(2 * kStages * 8 <= (int)kBarrierBytes, "the mbarriers fit their area");
static_assert(kChunk % 8 == 0, "a chunk is whole mma k-steps");
static_assert(kStages >= 2, "a chunk is asked for while an earlier one is read");

// Shapes of the block tile at width D (128, 256 or 512).
template <int D>
struct Tile {
  static_assert(D == 128 || D == 256 || D == 512, "the kernels take D = 128, 256 or 512");
  static constexpr int kTq = kRowsPerBlock / D;      // queries per block
  static constexpr int kE = kTq * kMaxK;             // edge rows per block
  static constexpr int kLd = D + kActPad;            // activation row stride (floats)
  static constexpr int kLdw = D + kWPad;             // staged weight row stride (elements)
  // each warp owns a 32 × 64 output tile: 2 × 8 mma tiles of 16 × 8
  static constexpr int kWarpsN = D / 64;             // warps across the columns
  static constexpr int kStageElems = kChunk * kLdw;   // one stage of the weight ring
  static constexpr int kActFloats = kE * kLd;        // one (E, D) activation tile
  static constexpr int kChunks = D / kChunk;
  static_assert(kTq * (D / kCols) == kThreads, "one thread per (query, 4 channels)");
  static_assert((kE / 32) * kWarpsN == kThreads / kWarp, "the warps tile (E, D)");
  static_assert((kLdw * 2) % 16 == 0, "a bf16 weight row is whole 16-byte units (bulk copy)");
  static_assert((kLdw / 2) % 32 == 4, "bf16 weight rows t and t + 1 start 4 banks apart");
};

template <typename W>
constexpr bool kIsBf16 = std::is_same<W, __nv_bfloat16>::value;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- 3×TF32 on the tensor cores -------------------------------------------

// x = hi + lo up to about 2^-22 relative: hi its TF32 rounding (to nearest,
// ties away from zero, as cvt.rna.tf32.f32 without its guard for non-finite
// values), lo the TF32 rounding of the exact remainder. The tensor cores read
// only the upper 19 bits of a TF32 operand, so lo is rounded by adding half
// of its last place and leaving the low 13 bits to be dropped.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// c += a · b for one 16 × 8 × 8 tile (A row-major, B column-major fragments)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a·b with a and b split: lo·hi, hi·lo, then hi·hi
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(c, a_lo, b_hi);
  mma_tf32(c, a_hi, b_lo);
  mma_tf32(c, a_hi, b_hi);
}

// ---- bf16 on the tensor cores (the bf16 mode) ----------------------------

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float4 round_bf16(float4 v) {
  return make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z), round_bf16(v.w));
}

// two f32 values rounded to bf16 (to nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// c += a · b for one 16 × 8 × 16 tile of bf16 operands (A row-major, B
// column-major fragments), f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four consecutive elements of a row of key or val, widened to f32
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
}

// ---- cluster, mbarriers and bulk copies -----------------------------------

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// whether the barrier's phase of parity `parity` has completed
__device__ __forceinline__ bool mbar_try(uint32_t bar, unsigned parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for that phase. A wait of more than about 2^33 clocks (seconds)
// means a block of the cluster will never signal: the kernel traps, and the
// launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  if (mbar_try(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try(bar, parity)) {
    if (clock64() - start > (1ll << 33)) __trap();
  }
}

// arrive on the barrier at the same offset in block `rank` of the cluster.
// No cluster-scope release: it would fence all of the GPU's memory at every
// chunk, and the reads it would order (of the stage being released) have
// finished at the __syncthreads() before it.
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar, unsigned rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(bar), "r"(rank));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
}

// `bytes` from global `src` to the same shared-memory offset `dst` in every
// block of the cluster; each block's barrier at offset `bar` counts them
__device__ __forceinline__ void bulk_multicast(uint32_t dst, const void* src, unsigned bytes,
                                               uint32_t bar) {
  const uint16_t mask = (1u << kCluster) - 1u;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

// The ring of weight chunks, of the weight's element type W. `issued` is
// thread 0's count of chunks it has asked for, `consumed` every thread's
// count of chunks used; chunk c sits in stage c % kStages.
template <typename W>
struct WeightPipe {
  W* buf;           // [kStages][kChunk][D + kWPad]
  uint32_t full;    // shared address of full[0]; full[s] at + 8·s
  uint32_t empty;   // empty[0], after the kStages full barriers
  unsigned rank;    // this block's rank in its cluster
  unsigned issued;
  unsigned consumed;
};

// Sets up the barriers at the start of shared memory (every thread calls
// it); ends with a cluster barrier, so no block copies into another before
// that block's barriers exist.
template <typename W>
__device__ __forceinline__ WeightPipe<W> pipe_init(void* smem_base, W* buf) {
  WeightPipe<W> p;
  p.buf = buf;
  p.full = smem_addr(smem_base);
  p.empty = p.full + 8 * kStages;
  p.rank = cluster_rank();
  p.issued = p.consumed = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(p.full + 8 * s, 1);
      mbar_init(p.empty + 8 * s, kCluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();
  return p;
}

// Thread 0 only: copies this block's share of chunk `chunk` of W (rows of
// D + kWPad elements) into the next stage of every block of the cluster, once
// the cluster has released that stage.
template <int D, typename W>
__device__ __forceinline__ void pipe_issue(WeightPipe<W>& p, const W* w, int chunk) {
  using T = Tile<D>;
  const unsigned s = p.issued % kStages, round = p.issued / kStages;
  mbar_wait(p.empty + 8 * s, (round & 1u) ^ 1u);  // round 0 passes at once
  const uint32_t full = p.full + 8 * s;
  mbar_expect_tx(full, T::kStageElems * sizeof(W));
  constexpr int rows = kChunk / kCluster;
  const size_t row0 = (size_t)chunk * kChunk + p.rank * rows;
  bulk_multicast(smem_addr(p.buf + (size_t)s * T::kStageElems + (size_t)p.rank * rows * T::kLdw),
                 w + row0 * T::kLdw, rows * T::kLdw * sizeof(W), full);
  ++p.issued;
}

// Thread 0 only, before a kernel's first product: its first kStages - 1
// chunks. A product then asks for chunk c + kStages - 1 once it is done with
// chunk c, into the stage that chunk c - 1 left: by then every block of the
// cluster has as a rule released that one, so the wait seldom holds up
// thread 0's warp.
template <int D, typename W>
__device__ __forceinline__ void pipe_prologue(WeightPipe<W>& p, const W* w) {
  if (threadIdx.x == 0) {
    for (int c = 0; c < kStages - 1; ++c) pipe_issue<D, W>(p, w, c);
  }
}

// out (E, D) = A (E, D) · W (D, D), both tiles in shared memory at row stride
// D + kActPad; W's rows padded to D + kWPad elements of W's type (f32:
// 3×TF32; bf16: A rounded to bf16, one bf16 product). The first kStages - 1
// chunks of W (`weight`) must have been issued (`pipe_prologue`, or the
// previous product's `weight_next`); this one issues the first kStages - 1
// chunks of `weight_next` unless it is null. Starts by
// waiting for chunk data, not for a barrier: the caller puts a
// __syncthreads() between writing A and calling. Ends with one, so every
// thread may read out.
template <int D, typename W>
__device__ __forceinline__ void rows_times_weights(WeightPipe<W>& p, const float* A,
                                                   const W* weight, const W* weight_next,
                                                   float* out) {
  using T = Tile<D>;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (warp / T::kWarpsN) * 32, col0 = (warp % T::kWarpsN) * 64;
  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.0f;
    }
  }
  for (int ch = 0; ch < T::kChunks; ++ch) {
    const unsigned s = p.consumed % kStages;
    mbar_wait(p.full + 8 * s, (p.consumed / kStages) & 1u);
    if constexpr (kIsBf16<W>) {
      static_assert(kChunk == 16, "a bf16 chunk is one k16 step");
      // one k16 step: inner index t + 4i in slot 2t, 2t+1, 2t+8, 2t+9 (the comment at the top)
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* r = A + (size_t)(row0 + mi * 16 + g) * T::kLd + ch * kChunk + t;
        a[mi][0] = pack_bf16(r[0], r[4]);
        a[mi][1] = pack_bf16(r[8 * T::kLd], r[8 * T::kLd + 4]);
        a[mi][2] = pack_bf16(r[8], r[12]);
        a[mi][3] = pack_bf16(r[8 * T::kLd + 8], r[8 * T::kLd + 12]);
      }
      const W* w = p.buf + (size_t)s * T::kStageElems + (size_t)t * T::kLdw + col0 + g;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const uint32_t b[2] = {pack_bf16(w[ni * 8], w[4 * T::kLdw + ni * 8]),
                               pack_bf16(w[8 * T::kLdw + ni * 8], w[12 * T::kLdw + ni * 8])};
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          // in a fresh accumulator, added in f32, as the 3×TF32 chunks below
          float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_bf16(part, a[mi], b);
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mi][ni][c] += part[c];
        }
      }
    } else {
      // A's fragments for the chunk's k-steps of 8
      uint32_t a_hi[2][kKSteps][4], a_lo[2][kKSteps][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks) {
          const float* a = A + (size_t)(row0 + mi * 16 + g) * T::kLd + ch * kChunk + ks * 8 + t;
          split_tf32(a[0], a_hi[mi][ks][0], a_lo[mi][ks][0]);
          split_tf32(a[8 * T::kLd], a_hi[mi][ks][1], a_lo[mi][ks][1]);
          split_tf32(a[4], a_hi[mi][ks][2], a_lo[mi][ks][2]);
          split_tf32(a[8 * T::kLd + 4], a_hi[mi][ks][3], a_lo[mi][ks][3]);
        }
      }
      const float* w = p.buf + (size_t)s * T::kStageElems + (size_t)t * T::kLdw + col0 + g;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        uint32_t b_hi[kKSteps][2], b_lo[kKSteps][2];
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks) {
          split_tf32(w[(ks * 8) * T::kLdw + ni * 8], b_hi[ks][0], b_lo[ks][0]);
          split_tf32(w[(ks * 8 + 4) * T::kLdw + ni * 8], b_hi[ks][1], b_lo[ks][1]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          // the chunk's 16 terms in a fresh accumulator, added to acc in f32:
          // the tensor cores round a sum toward zero at the scale of its largest
          // term, so a long sum kept in them drifts by an ulp of the total per
          // step, all one way; these partial sums take both signs
          float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int ks = 0; ks < kKSteps; ++ks) {
            mma_3xtf32(part, a_hi[mi][ks], a_lo[mi][ks], b_hi[ks], b_lo[ks]);
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mi][ni][c] += part[c];
        }
      }
    }
    __syncthreads();  // every warp is done with stage s (after the last chunk, with A)
    if (threadIdx.x == 0) {
      for (unsigned r = 0; r < kCluster; ++r) mbar_arrive_remote(p.empty + 8 * s, r);
      const int next = ch + kStages - 1;
      if (next < T::kChunks) {
        pipe_issue<D, W>(p, weight, next);
      } else if (weight_next != nullptr) {
        pipe_issue<D, W>(p, weight_next, next - T::kChunks);
      }
    }
    ++p.consumed;
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      float* o = out + (size_t)(row0 + mi * 16 + g) * T::kLd + col0 + ni * 8 + 2 * t;
      *reinterpret_cast<float2*>(o) = make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(o + 8 * T::kLd) = make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
  }
  __syncthreads();
}

}  // namespace
