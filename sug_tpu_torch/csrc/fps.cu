// Farthest point sampling: the whole npoint-step loop of one cloud in one
// block.
//
// Replaces the TPU kernel behind `fps_pallas` (sug_tpu/ops/pallas_kernels.py:151,
// its pallas_call :161, kernel body `_fps_kernel` :128), which
// `geometry.farthest_point_sample` runs for clouds of 4096 points or more.
//
// Contract, identical index for index to the plain loop (`fps_plain`):
//   dists[n] = 1e10 for every point; farthest = start[b]
//   for i < npoint:
//     out[b, i] = farthest
//     d[n] = (dx·dx + dy·dy) + dz·dz, d = xyz[b, n] - xyz[b, farthest], in f32
//     dists = min(dists, d)
//     farthest = the FIRST index of the largest dists (torch/jnp.argmax)
// Inputs xyz (B,N,3) f32 and start (B,) int64, contiguous; output (B,npoint)
// int64. N <= 16384. Each start must lie in [0, N): the wrapper checks it.
//
// Bit-exactness. nvcc contracts a*a + b into an FMA by default, which rounds
// once where the plain version rounds twice and so can move the arg-max on a
// near-tie; the distance is written with __fmul_rn / __fadd_rn / __fsub_rn,
// which are never contracted. The arg-max compares (value, index): a larger
// value wins, an equal one goes to the lower index, so the result is the
// first maximal index whatever order the threads reduce in.
//
// What bounds it on an H100. Operations: per point and step 3 subtractions,
// 3 multiplies, 2 adds, a min and a compare, 10 in all; at B=64, N=4096,
// npoint=64 that is 0.17 GFLOP, 2.5 us at 67 TFLOP/s. Bytes: xyz read once,
// the indices written once, 3.2 MB, 0.9 us at 3.35 TB/s. Neither binds: each
// step ends in a block-wide arg-max whose result the next step needs, so the
// floor is npoint dependent reductions (two barriers and ten shuffle rounds
// each), about a microsecond apiece, and one block per cloud leaves most of
// the card idle at B=64.
//
// Design (simple and right first; speed is later work):
// - One block of 1024 threads per cloud. Thread t owns points t, t+1024, ...
//   (P = ceil(N/1024) of them, P a template parameter up to 16) and keeps
//   their running minima in registers. Their coordinates live in shared
//   memory (12 bytes a point, 192 KB at N=16384): at 1024 threads a thread
//   may use 64 registers, and 16 points' coordinates and minima would spill.
// - Each step: the centroid is read from shared memory (a broadcast), each
//   thread updates its minima and keeps its own first maximum, a warp
//   shuffle reduction over (value, index), one shared-memory round across
//   the 32 warps, and the winner broadcast through shared memory.
// The kernel runs on the caller's stream, does not synchronise and
// allocates nothing.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxPointsPerThread = 16;
constexpr int kMaxPoints = kThreads * kMaxPointsPerThread;  // 16384

// (value, index) arg-max step: the larger value, then the lower index
__device__ __forceinline__ void take_max(float& bv, int& bi, float ov, int oi) {
  if (ov > bv || (ov == bv && oi < bi)) {
    bv = ov;
    bi = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& bv, int& bi) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    take_max(bv, bi, ov, oi);
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, const long long* __restrict__ start,
           long long* __restrict__ out, int N, int npoint) {
  extern __shared__ float pts[];  // [N][3], the cloud's coordinates
  __shared__ float warp_val[kWarps];
  __shared__ int warp_idx[kWarps];
  __shared__ int winner;

  const int b = blockIdx.x;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const float* xb = xyz + (size_t)b * N * 3;
  long long* ob = out + (size_t)b * npoint;

  for (int e = threadIdx.x; e < 3 * N; e += kThreads) pts[e] = xb[e];
  float dist[P];
#pragma unroll
  for (int j = 0; j < P; ++j) dist[j] = 1e10f;
  __syncthreads();

  int far = (int)start[b];
  for (int i = 0; i < npoint; ++i) {
    if (threadIdx.x == 0) ob[i] = far;
    const float cx = pts[3 * far], cy = pts[3 * far + 1], cz = pts[3 * far + 2];
    float bv = -CUDART_INF_F;
    int bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int p = threadIdx.x + j * kThreads;  // ascending: a strict > keeps the first
      if (p < N) {
        const float dx = __fsub_rn(pts[3 * p], cx);
        const float dy = __fsub_rn(pts[3 * p + 1], cy);
        const float dz = __fsub_rn(pts[3 * p + 2], cz);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        dist[j] = fminf(dist[j], d);
        if (dist[j] > bv) {
          bv = dist[j];
          bi = p;
        }
      }
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      warp_val[warp] = bv;
      warp_idx[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = warp_val[lane];
      bi = warp_idx[lane];
      warp_argmax(bv, bi);
      if (lane == 0) winner = bi;
    }
    // warp 0 has read warp_val before any thread passes this barrier, and
    // every thread reads `winner` before the next step's first barrier, after
    // which alone it is written again
    __syncthreads();
    far = winner;
  }
}

template <int P>
cudaError_t launch(const float* xyz, const long long* start, long long* out, int B, int N,
                   int npoint, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 3 * (size_t)N;
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fps_kernel<P><<<B, kThreads, smem, stream>>>(xyz, start, out, N, npoint);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`. Returns a cudaError_t:
// cudaErrorInvalidValue for sizes out of range (N above 16384 included),
// otherwise the attribute call's error or cudaGetLastError() after the launch.
int fps(const float* xyz, const long long* start, long long* out, int B, int N, int npoint,
        void* stream) {
  if (B < 1 || N < 1 || npoint < 1 || N > kMaxPoints || B > INT_MAX / 2) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const int per_thread = (N + kThreads - 1) / kThreads;
  if (per_thread <= 1) return (int)launch<1>(xyz, start, out, B, N, npoint, st);
  if (per_thread <= 2) return (int)launch<2>(xyz, start, out, B, N, npoint, st);
  if (per_thread <= 4) return (int)launch<4>(xyz, start, out, B, N, npoint, st);
  if (per_thread <= 8) return (int)launch<8>(xyz, start, out, B, N, npoint, st);
  return (int)launch<16>(xyz, start, out, B, N, npoint, st);
}

const char* fps_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
