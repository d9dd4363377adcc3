// Min-dists: each query point's smallest squared distance to a source cloud,
// without the (B, N, M) distance matrix.
//
// Replaces the TPU kernel `_min_dists_tiled` (sug_tpu/ops/pallas_kernels.py:76,
// its pallas_call :84, kernel body `_chamfer_min_kernel` :53), which
// `chamfer_pallas` calls once per direction for clouds above 2048 points.
//
// Contract, for each query n of cloud b, any N >= 1 and M >= 1:
//   out[b, n] = min_m (-2 q[b,n]·s[b,m] + |q[b,n]|^2 + |s[b,m]|^2)      (f32)
// Inputs q (B,N,3) and s (B,M,3) f32 contiguous; output (B,N) f32. No clamp:
// the expanded form cancels, so the min of two near-identical points may be
// slightly negative, as in the plain PyTorch version and the JAX op. The
// terms are added in another order than there, so the mins agree to f32
// rounding of the squared norms.
//
// The TPU kernel runs a grid of N / tile_q query tiles and loops over
// M / tile_s source tiles, so the queries past the last full tile are never
// written and the sources past it never searched; here both ragged edges are
// masked: a partial last query block computes clamped queries and does not
// store them, a partial last source tile stages only its real points.
//
// What bounds it on an H100. Operations: per (query, source) pair the
// function needs three FMAs and a min, 7 operations counting an FMA as two:
// -2 is folded into the query and |s|^2 starts the FMA chain, so the chain
// gives |s|^2 - 2 q·s, and |q|^2 is added once per query after the min
// (adding a constant keeps the order of rounded values, so the min is the
// same). At B=64, N=M=4096 that is 7.5 GFLOP per call, 0.112 ms at 67
// TFLOP/s. Bytes: q and s read once, out written once, 7.3 MB there, 2.2 us
// at 3.35 TB/s. So a call is bound by f32 arithmetic, and the design keeps
// the inner loop at one shared-memory load per four pairs.
//
// Design (simple and right first; speed is later work):
// - Grid (query blocks, clouds); a block of 128 threads owns 512 queries, a
//   thread four of them (strided by 128, so loads and stores coalesce), with
//   their coordinates times -2 and running minima in registers.
// - Source points are staged through shared memory in tiles of 512 as float4
//   (x, y, z, |s|^2), |s|^2 computed once per staged point; every thread
//   reads the same element (a broadcast) and updates its four minima.
// - One launch per direction: two per chamfer, as the TPU makes two
//   pallas_calls.
// The kernel runs on the caller's stream, does not synchronise and
// allocates nothing.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kQueriesPerThread = 4;
constexpr int kQueriesPerBlock = kThreads * kQueriesPerThread;
constexpr int kTile = 512;  // source points staged per pass

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return fmaf(z, z, fmaf(y, y, x * x));
}

__global__ void __launch_bounds__(kThreads)
min_dists_kernel(const float* __restrict__ q, const float* __restrict__ s,
                 float* __restrict__ out, int N, int M) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * kQueriesPerBlock + threadIdx.x;
  const float* qb = q + (size_t)b * N * 3;
  const float* sb = s + (size_t)b * M * 3;

  // -2·q, exact in f32; a query past N is computed on a clamped copy and
  // never stored
  float qx[kQueriesPerThread], qy[kQueriesPerThread], qz[kQueriesPerThread];
  float best[kQueriesPerThread];
#pragma unroll
  for (int r = 0; r < kQueriesPerThread; ++r) {
    const int n = min(n0 + r * kThreads, N - 1);
    qx[r] = -2.0f * qb[(size_t)n * 3 + 0];
    qy[r] = -2.0f * qb[(size_t)n * 3 + 1];
    qz[r] = -2.0f * qb[(size_t)n * 3 + 2];
    best[r] = CUDART_INF_F;
  }

  for (int m0 = 0; m0 < M; m0 += kTile) {
    const int ns = min(kTile, M - m0);  // the last tile may be partial
    __syncthreads();                    // the previous tile has been consumed
    for (int j = threadIdx.x; j < ns; j += kThreads) {
      const float* p = sb + (size_t)(m0 + j) * 3;
      const float x = p[0], y = p[1], z = p[2];
      tile[j] = make_float4(x, y, z, sq_norm(x, y, z));
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < ns; ++j) {
      const float4 p = tile[j];
#pragma unroll
      for (int r = 0; r < kQueriesPerThread; ++r) {
        // |s|^2 - 2 q·s in three FMAs
        const float d = fmaf(qz[r], p.z, fmaf(qy[r], p.y, fmaf(qx[r], p.x, p.w)));
        best[r] = fminf(best[r], d);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kQueriesPerThread; ++r) {
    const int n = n0 + r * kThreads;
    if (n < N) {
      const float* p = qb + (size_t)n * 3;
      out[(size_t)b * N + n] = best[r] + sq_norm(p[0], p[1], p[2]);
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`. Returns a cudaError_t:
// cudaErrorInvalidValue for sizes out of range, otherwise cudaGetLastError()
// after the launch.
int min_dists(const float* q, const float* s, float* out, int B, int N, int M, void* stream) {
  if (B < 1 || N < 1 || M < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kQueriesPerBlock - 1) / kQueriesPerBlock, B);
  min_dists_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(q, s, out, N, M);
  return (int)cudaGetLastError();
}

const char* min_dists_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
