// EdgeConv backward: replay of the edge activations, first-hit routing of
// the max/min cotangents, and a deterministic scatter into dU.
//
// Replaces the TPU kernel `_bwd_pallas` (sug_tpu/ops/edgeconv_pallas.py:589,
// kernel bodies `_bwd_kernel` :292 and `_bwd_kernel_batched` :397), the
// backward of the custom VJP `_fused_cross` (:675-699) behind both the four
// DGCNN EdgeConv blocks (self-kNN, k=20) and the SA-node's kNN-64 re-query.
//
// Contract, for each query s of cloud b and each channel f:
//   a_j    = u[b, idx_j, f] + v[b, s, f]       (the forward's single f32 add)
//   selmax = 1 at the first j (in idx order) with a_j == amax, else 0;
//            selmin likewise with amin
//   da_j   = damax*selmax + damin*selmin + ds1 + 2*a_j*ds2
//   dv[b, s, f] = sum_j da_j;   du[b, n, f] = sum over (s, j) with idx_j == n
// Inputs idx (B,S,k) int32; u (B,N,F); v, amax, amin, damax, damin, ds1, ds2
// (B,S,F), all f32 contiguous. Outputs du (B,N,F) and dv (B,S,F) f32; every
// element of both is written, so the caller need not zero them.
//
// What bounds it on an H100. Bytes: idx, u and the seven (B,S,F) inputs read
// once, du and dv written once; at EdgeConv block 4 (B=64, S=N=1024, F=256,
// k=20) that is ~676 MB, 0.20 ms at 3.35 TB/s. Operations: about 8 f32 ops
// per edge and channel, 2.7 GFLOP there, 0.04 ms at 67 TFLOP/s. So the call
// is bound by HBM bytes. This design is far from that bound: see below.
//
// Design (simple and right first; speed is later work):
// - One warp per (cloud b, slice of 32 channels, tile of keys); lane f owns
//   channel f of the slice. The warp walks the (s, j) entries of its cloud in
//   order, replays a_j, keeps its first-hit flags and dv for the current s,
//   and adds da_j into its own column of a shared-memory dU tile. No two lanes
//   touch the same element and the order of the adds is fixed, so there is no
//   atomic and dU is bit-identical from launch to launch.
// - Latency: with one warp on an SM nothing else hides a load, so the rows
//   are software-pipelined: while row s is replayed, row s+1's inputs and the
//   gathers of its first 32 neighbours, and row s+2's neighbour ids, are in
//   flight (the lanes load a row's ids together and share them by shuffle).
// - The dU tile holds up to kKeyTile keys (N x 32 f32 = 128 KB at N=1024), so
//   one block holds one warp and an SM runs one block. Clouds with more keys
//   split into several tiles, each replaying every entry and keeping only the
//   keys in its range; dv is written by the first tile.
// Its parallelism is low: B * ceil(F/32) * tiles warps, 128 at B=64, F=64,
// on 132 SMs of one warp each; every entry costs a dependent shared-memory
// read-modify-write. A key-sorted (CSR) layout, or per-partition partials
// summed in a fixed order, is the later speed work.
// The kernel runs on the caller's stream, does not synchronise and allocates
// nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kKeyTile = 1536;  // 1536 keys x 32 lanes x 4 B = 192 KB of shared memory

// One query row's per-channel inputs.
struct Row {
  float v, mx, mn, gmax, gmin, g1, g2;
};

__device__ __forceinline__ Row load_row(const float* __restrict__ v,
                                        const float* __restrict__ amax,
                                        const float* __restrict__ amin,
                                        const float* __restrict__ damax,
                                        const float* __restrict__ damin,
                                        const float* __restrict__ ds1,
                                        const float* __restrict__ ds2, size_t row,
                                        bool active) {
  Row r = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (active) {
    r.v = v[row]; r.mx = amax[row]; r.mn = amin[row];
    r.gmax = damax[row]; r.gmin = damin[row]; r.g1 = ds1[row]; r.g2 = ds2[row];
  }
  return r;
}

// Lane jj's neighbour id (held by lane jj of the warp) gathers u[n, f] into
// val[jj], for the first cnt neighbours of a chunk.
__device__ __forceinline__ void gather(float (&val)[kWarp], int my_n, int cnt,
                                       const float* __restrict__ u_b, int F, int f,
                                       bool active) {
#pragma unroll
  for (int jj = 0; jj < kWarp; ++jj) {
    const int n = __shfl_sync(0xffffffffu, my_n, jj);
    val[jj] = (active && jj < cnt) ? u_b[(size_t)n * F + f] : 0.0f;
  }
}

__global__ void edgeconv_bwd_kernel(const int* __restrict__ idx,
                                    const float* __restrict__ u,
                                    const float* __restrict__ v,
                                    const float* __restrict__ amax,
                                    const float* __restrict__ amin,
                                    const float* __restrict__ damax,
                                    const float* __restrict__ damin,
                                    const float* __restrict__ ds1,
                                    const float* __restrict__ ds2,
                                    float* __restrict__ du,
                                    float* __restrict__ dv,
                                    int S, int N, int F, int k,
                                    int n_slices, int key_tile) {
  extern __shared__ float du_tile[];  // [key_tile][kWarp]
  const int lane = threadIdx.x;
  const int slice = blockIdx.x % n_slices;
  const int tile = blockIdx.x / n_slices;
  const int b = blockIdx.y;
  const int f = slice * kWarp + lane;
  // lanes past F take part in the shuffles but load and store nothing global
  const bool active = f < F;
  const int n0 = tile * key_tile;
  const int nk = min(key_tile, N - n0);

  for (int n = 0; n < nk; ++n) du_tile[n * kWarp + lane] = 0.0f;

  const int* idx_b = idx + (size_t)b * S * k;
  const float* u_b = u + (size_t)b * N * F;
  const size_t row0 = (size_t)b * S * F + f;
  // a row's first chunk of neighbours: lane j holds neighbour j
  const int first_cnt = min(k, kWarp);
  auto first_ids = [&](int s) { return (s < S && lane < first_cnt) ? idx_b[(size_t)s * k + lane] : 0; };

  // software pipeline: row s is replayed while row s+1's inputs and first
  // gathers and row s+2's neighbour ids are in flight
  int ids_cur = first_ids(0), ids_next = first_ids(1);
  float val_cur[kWarp], val_next[kWarp];
  gather(val_cur, ids_cur, first_cnt, u_b, F, f, active);
  Row cur = load_row(v, amax, amin, damax, damin, ds1, ds2, row0, active);
  for (int s = 0; s < S; ++s) {
    const bool more = s + 1 < S;
    Row next = load_row(v, amax, amin, damax, damin, ds1, ds2, row0 + (size_t)(s + 1) * F,
                        active && more);
    gather(val_next, ids_next, more ? first_cnt : 0, u_b, F, f, active);
    const int ids_after = first_ids(s + 2);

    bool hit_max = false, hit_min = false;
    float dvs = 0.0f;
    for (int j0 = 0; j0 < k; j0 += kWarp) {
      const int cnt = min(kWarp, k - j0);
      int my_n = ids_cur;
      if (j0 > 0) {  // k > 32: the later chunks are loaded here
        my_n = lane < cnt ? idx_b[(size_t)s * k + j0 + lane] : 0;
        gather(val_cur, my_n, cnt, u_b, F, f, active);
      }
#pragma unroll
      for (int jj = 0; jj < kWarp; ++jj) {
        if (jj < cnt) {  // uniform across the warp
          const int n = __shfl_sync(0xffffffffu, my_n, jj);
          // the same single f32 add as the forward: __fadd_rn is never contracted
          const float a = __fadd_rn(val_cur[jj], cur.v);
          const bool sel_max = !hit_max && a == cur.mx;
          const bool sel_min = !hit_min && a == cur.mn;
          hit_max |= sel_max;
          hit_min |= sel_min;
          // the Pallas kernel's order: damax*selmax + damin*selmin + ds1 + 2*a*ds2
          const float da = __fadd_rn(
              __fadd_rn(__fadd_rn(sel_max ? cur.gmax : 0.0f, sel_min ? cur.gmin : 0.0f), cur.g1),
              __fmul_rn(__fmul_rn(2.0f, a), cur.g2));
          dvs += da;
          const int m = n - n0;
          if (m >= 0 && m < nk) du_tile[m * kWarp + lane] += da;
        }
      }
    }
    if (active && tile == 0) dv[row0 + (size_t)s * F] = dvs;

    cur = next;
    ids_cur = ids_next;
    ids_next = ids_after;
#pragma unroll
    for (int jj = 0; jj < kWarp; ++jj) val_cur[jj] = val_next[jj];
  }

  if (!active) return;
  float* du_b = du + ((size_t)b * N + n0) * F + f;
  for (int n = 0; n < nk; ++n) du_b[(size_t)n * F] = du_tile[n * kWarp + lane];
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`. Returns a cudaError_t:
// cudaErrorInvalidValue when the shapes are out of range, otherwise
// cudaGetLastError() after the launch.
int edgeconv_bwd(const int* idx, const float* u, const float* v, const float* amax,
                 const float* amin, const float* damax, const float* damin,
                 const float* ds1, const float* ds2, float* du, float* dv,
                 int B, int S, int N, int F, int k, void* stream) {
  if (B < 1 || S < 1 || N < 1 || F < 1 || k < 1 || k > N || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_slices = (F + kWarp - 1) / kWarp;
  const int n_tiles = (N + kKeyTile - 1) / kKeyTile;
  const int key_tile = min(N, kKeyTile);
  const size_t smem = sizeof(float) * (size_t)key_tile * kWarp;
  cudaError_t err = cudaFuncSetAttribute(
      edgeconv_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_slices * n_tiles, B);
  edgeconv_bwd_kernel<<<grid, kWarp, smem, (cudaStream_t)stream>>>(
      idx, u, v, amax, amin, damax, damin, ds1, ds2, du, dv, S, N, F, k, n_slices,
      key_tile);
  return (int)cudaGetLastError();
}

const char* edgeconv_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
