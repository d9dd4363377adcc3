// EdgeConv forward: kNN selection + neighbour gather + four reductions.
//
// Replaces the TPU kernel `_fwd_pallas` (sug_tpu/ops/edgeconv_pallas.py:498,
// kernel bodies `_fwd_kernel` :120 and `_fwd_kernel_batched` :219), which
// serves both `fused_edgeconv_reduce` (self-kNN, the four DGCNN EdgeConv
// blocks, k=20) and `fused_cross_edgeconv_reduce` (the SA-node's kNN-64
// re-query of S=64 offset nodes against the cloud).
//
// Contract, for each query s of cloud b:
//   d_j    = -2 q_s·kv_j + |q_s|^2 + |kv_j|^2           (f32, j < N)
//   idx    = the k smallest d_j, ascending; the lowest j wins a tie
//   a_j    = u[b, idx_j, :] + v[b, s, :]
//   amax, amin, s1, s2 = max, min, sum and sum of squares of a_j over j
// Inputs q (B,S,C), kv (B,N,C), u (B,N,F), v (B,S,F), all f32 contiguous;
// outputs amax/amin/s1/s2 (B,S,F) f32 and idx (B,S,k) int32.
//
// What bounds it on an H100. Bytes: q, kv, u and v read once, four (B,S,F)
// outputs and idx written once; at EdgeConv block 4 (B=64, S=N=1024, C=128,
// F=256, k=20, q is kv) that is ~441 MB, 0.13 ms at 3.35 TB/s. Operations: the f32
// distances, 2·B·S·N·C = 17.2 GFLOP there, 0.26 ms at 67 TFLOP/s outside the
// tensor cores. So the block-4 call is bound by f32 arithmetic, not by HBM.
// The k selection rounds (k·N compares per query) are not counted in that
// bound: they are comparisons, and a different selection algorithm needs
// fewer of them; at C=3 (block 1, the SA-node) they are the larger share.
//
// Design (simple and right first; speed is later work):
// - One warp per query; a block holds QPB queries of one cloud.
// - Key coordinates are staged through shared memory in chunks of CHUNK
//   keys, shared by the block's warps; rows are padded to a float4 width
//   whose stride avoids bank conflicts, and |kv_j|^2 is computed once per
//   key per block. Distances use the same formula as the plain PyTorch
//   version, so exact duplicates tie exactly.
// - Each warp keeps its query's N distances in a shared-memory row and runs
//   k rounds of a warp arg-min over (distance, index), compared
//   lexicographically; the winner is set to +inf.
// - The gather: lanes stride over F, read u[b, idx_j, :] coalesced, add v,
//   and keep max, min, sum and sum of squares in registers.
// The kernel runs on the caller's stream, does not synchronise and
// allocates nothing.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxQueriesPerBlock = 8;
constexpr int kChunk = 64;                      // keys staged per pass
constexpr size_t kSmemBudget = 200 * 1024;      // of the 227 KB a block may use

// Row stride in floats for C channels: a multiple of 4 (float4 loads) that is
// 4 mod 8, so the 8 lanes of a quarter-warp hit distinct banks.
__host__ __device__ inline int padded_width(int C) {
  int cp = (C + 3) / 4 * 4;
  return (cp % 8 == 0) ? cp + 4 : cp;
}

struct Layout {
  int qpb;       // queries (warps) per block
  int cp;        // padded channel stride
  size_t bytes;  // dynamic shared memory
};

Layout make_layout(int N, int C, int k) {
  Layout L;
  L.cp = padded_width(C);
  const size_t fixed = sizeof(float) * ((size_t)kChunk * L.cp + kChunk);
  const size_t per_query = sizeof(float) * ((size_t)L.cp + N) + sizeof(int) * (size_t)k;
  L.qpb = 0;
  for (int q = kMaxQueriesPerBlock; q >= 1; --q) {
    if (fixed + q * per_query <= kSmemBudget) { L.qpb = q; break; }
  }
  L.bytes = fixed + (size_t)L.qpb * per_query;
  return L;
}

__global__ void edgeconv_fwd_kernel(const float* __restrict__ q,
                                    const float* __restrict__ kv,
                                    const float* __restrict__ u,
                                    const float* __restrict__ v,
                                    float* __restrict__ amax,
                                    float* __restrict__ amin,
                                    float* __restrict__ s1,
                                    float* __restrict__ s2,
                                    int* __restrict__ idx_out,
                                    int S, int N, int C, int F, int k, int cp) {
  extern __shared__ __align__(16) float smem[];
  const int qpb = blockDim.x / kWarp;
  float* kc = smem;                              // [kChunk][cp] key coordinates
  float* ksq = kc + (size_t)kChunk * cp;         // [kChunk] |kv_j|^2
  float* qs = ksq + kChunk;                      // [qpb][cp] query coordinates
  float* drow_all = qs + (size_t)qpb * cp;       // [qpb][N] distances
  int* sidx_all = reinterpret_cast<int*>(drow_all + (size_t)qpb * N);  // [qpb][k]

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int b = blockIdx.y;
  const int s = blockIdx.x * qpb + warp;
  const bool active = s < S;

  float* qrow = qs + (size_t)warp * cp;
  float* drow = drow_all + (size_t)warp * N;
  int* sidx = sidx_all + (size_t)warp * k;

  // this warp's query, zero-padded to cp
  for (int c = lane; c < cp; c += kWarp) {
    qrow[c] = (active && c < C) ? q[((size_t)b * S + s) * C + c] : 0.0f;
  }
  __syncwarp();
  float qsq = 0.0f;
  for (int c = 0; c < C; ++c) qsq = fmaf(qrow[c], qrow[c], qsq);

  const float* kvb = kv + (size_t)b * N * C;
  for (int j0 = 0; j0 < N; j0 += kChunk) {
    const int nk = min(kChunk, N - j0);
    __syncthreads();  // the previous chunk has been consumed
    for (int e = threadIdx.x; e < kChunk * cp; e += blockDim.x) {
      const int jj = e / cp, c = e % cp;
      kc[e] = (jj < nk && c < C) ? kvb[(size_t)(j0 + jj) * C + c] : 0.0f;
    }
    __syncthreads();
    for (int jj = threadIdx.x; jj < nk; jj += blockDim.x) {
      const float* row = kc + (size_t)jj * cp;
      float acc = 0.0f;
      for (int c = 0; c < C; ++c) acc = fmaf(row[c], row[c], acc);
      ksq[jj] = acc;
    }
    __syncthreads();
    if (active) {
      for (int jj = lane; jj < nk; jj += kWarp) {
        const float4* kr = reinterpret_cast<const float4*>(kc + (size_t)jj * cp);
        const float4* qr = reinterpret_cast<const float4*>(qrow);
        float dot = 0.0f;
        for (int c4 = 0; c4 < cp / 4; ++c4) {
          const float4 a = qr[c4], w = kr[c4];
          dot = fmaf(a.x, w.x, dot);
          dot = fmaf(a.y, w.y, dot);
          dot = fmaf(a.z, w.z, dot);
          dot = fmaf(a.w, w.w, dot);
        }
        drow[j0 + jj] = (-2.0f * dot + qsq) + ksq[jj];
      }
    }
  }
  if (!active) return;  // no block-wide barrier follows
  __syncwarp();

  // k rounds of a warp arg-min; lanes scan their strided columns in
  // ascending index order, so a strict < keeps the lowest index per lane
  for (int r = 0; r < k; ++r) {
    float bd = CUDART_INF_F;
    int bi = N;
    for (int j = lane; j < N; j += kWarp) {
      const float d = drow[j];
      if (d < bd) { bd = d; bi = j; }
    }
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (od < bd || (od == bd && oi < bi)) { bd = od; bi = oi; }
    }
    bi = min(bi, N - 1);  // only non-finite distances leave the sentinel
    if (lane == 0) {
      sidx[r] = bi;
      drow[bi] = CUDART_INF_F;
    }
    __syncwarp();
  }

  int* idx_row = idx_out + ((size_t)b * S + s) * k;
  for (int r = lane; r < k; r += kWarp) idx_row[r] = sidx[r];

  const float* ub = u + (size_t)b * N * F;
  const size_t out_row = ((size_t)b * S + s) * F;
  for (int f = lane; f < F; f += kWarp) {
    const float vf = v[out_row + f];
    float mx = -CUDART_INF_F, mn = CUDART_INF_F, sum = 0.0f, sq = 0.0f;
    for (int r = 0; r < k; ++r) {
      const float a = ub[(size_t)sidx[r] * F + f] + vf;
      mx = fmaxf(mx, a);
      mn = fminf(mn, a);
      sum += a;
      sq += a * a;
    }
    amax[out_row + f] = mx;
    amin[out_row + f] = mn;
    s1[out_row + f] = sum;
    s2[out_row + f] = sq;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`. Returns a cudaError_t: cudaErrorInvalidValue
// when the shapes are out of range or N is too large for one warp's distance
// row in shared memory; otherwise cudaGetLastError() after the launch.
int edgeconv_fwd(const float* q, const float* kv, const float* u, const float* v,
                 float* amax, float* amin, float* s1, float* s2, int* idx,
                 int B, int S, int N, int C, int F, int k, void* stream) {
  if (B < 1 || S < 1 || N < 1 || C < 1 || F < 1 || k < 1 || k > N || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const Layout L = make_layout(N, C, k);
  if (L.qpb < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      edgeconv_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + L.qpb - 1) / L.qpb, B);
  const dim3 block(L.qpb * kWarp);
  edgeconv_fwd_kernel<<<grid, block, L.bytes, (cudaStream_t)stream>>>(
      q, kv, u, v, amax, amin, s1, s2, idx, S, N, C, F, k, L.cp);
  return (int)cudaGetLastError();
}

const char* edgeconv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
