// Shared by the vector-attention kernels (vecattn_fwd.cu, vecattn_bwd.cu): the
// block shape and the register-tiled SIMT product of a block's edge rows with
// a (D, D) weight streamed from global memory.
//
// A block of 256 threads holds E = 16·TQ edge rows (TQ = 1024/D queries, 16
// neighbour slots each) as (E, D) f32 tiles in shared memory. Thread (query,
// 4 channels) owns the 16 × 4 output tile of its query's 16 rows; weight rows
// come in chunks of 16 through a two-stage cp.async ring. Everything is f32
// with FMAs, summed in ascending order of the inner index.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxK = 16;       // neighbour slots per query
constexpr int kCols = 4;        // output channels per thread (one float4)
constexpr int kChunk = 16;      // weight rows per pipeline stage
constexpr int kRowsPerBlock = 1024;  // TQ·D: 256 threads of kCols channels
constexpr int kMaxD = 512;
constexpr size_t kSmemLimit = 227 * 1024;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy weight rows [chunk·kChunk, (chunk+1)·kChunk) of W (D, D) into `dst`.
__device__ __forceinline__ void stage_chunk(float* dst, const float* W, int chunk, int D) {
  const float4* src = reinterpret_cast<const float4*>(W + (size_t)chunk * kChunk * D);
  float4* d4 = reinterpret_cast<float4*>(dst);
  const int n4 = kChunk * D / 4;
  for (int i = threadIdx.x; i < n4; i += blockDim.x) cp_async16(d4 + i, src + i);
  cp_async_commit();
}

// acc[r][c] = sum_kk A[r][kk] · W[kk][col0 + c] for this thread's 16 rows
// (A points at its query's first row in shared memory, row stride D), in
// ascending kk. Ends with a barrier, so the caller may overwrite A.
__device__ __forceinline__ void rows_times_weights(float (&acc)[kMaxK][kCols],
                                                   const float* A, const float* W,
                                                   float* wbuf, int D, int col0) {
#pragma unroll
  for (int r = 0; r < kMaxK; ++r) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
  }
  const int nchunks = D / kChunk;
  stage_chunk(wbuf, W, 0, D);
  for (int ch = 0; ch < nchunks; ++ch) {
    if (ch + 1 < nchunks) {
      stage_chunk(wbuf + ((ch + 1) & 1) * kChunk * D, W, ch + 1, D);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk ch has landed for every thread
    const float* ws = wbuf + (ch & 1) * kChunk * D + col0;
    const float* a_chunk = A + ch * kChunk;
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 4) {
      const float4 b0 = ld4(ws + (kk + 0) * D);
      const float4 b1 = ld4(ws + (kk + 1) * D);
      const float4 b2 = ld4(ws + (kk + 2) * D);
      const float4 b3 = ld4(ws + (kk + 3) * D);
#pragma unroll
      for (int r = 0; r < kMaxK; ++r) {
        const float4 a = ld4(a_chunk + r * D + kk);  // a broadcast in the warp
        acc[r][0] = fmaf(a.w, b3.x, fmaf(a.z, b2.x, fmaf(a.y, b1.x, fmaf(a.x, b0.x, acc[r][0]))));
        acc[r][1] = fmaf(a.w, b3.y, fmaf(a.z, b2.y, fmaf(a.y, b1.y, fmaf(a.x, b0.y, acc[r][1]))));
        acc[r][2] = fmaf(a.w, b3.z, fmaf(a.z, b2.z, fmaf(a.y, b1.z, fmaf(a.x, b0.z, acc[r][2]))));
        acc[r][3] = fmaf(a.w, b3.w, fmaf(a.z, b2.w, fmaf(a.y, b1.w, fmaf(a.x, b0.w, acc[r][3]))));
      }
    }
    __syncthreads();  // stage (ch & 1) is free for chunk ch + 2
  }
}

}  // namespace
