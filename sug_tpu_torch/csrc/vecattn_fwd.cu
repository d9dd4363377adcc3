// Vector-attention forward (Point Transformer): kNN + per-edge delta and
// gamma MLPs + per-channel softmax over the neighbours.
//
// Replaces the TPU kernel `_fwd_pallas` (sug_tpu/ops/vector_attention_pallas.py:523,
// kernel body `_fwd_kernel` :181), behind `fused_vector_attention` (:693),
// which every `VectorAttentionBlock` of the PTran backbone calls.
//
// Contract, for each point n of cloud b (k <= 16, C = 3):
//   d_j   = -2 x_n·x_j + |x_n|^2 + |x_j|^2               (f32, j < N)
//   idx   = the k smallest d_j, ascending; the lowest j wins a tie
//   pos_j = relu((x_n - x_j)·Wd1 + bd1)·Wd2 + bd2          (3 -> D -> D)
//   z_j   = (relu((q_n - key_j + pos_j)·Wg1 + bg1)·Wg2 + bg2) · s,  s = 1/sqrt(D)
//   m     = max_j z_j,  l = sum_j exp(z_j - m)
//   out   = sum_j exp(z_j - m) (val_j + pos_j) / l          (per channel)
// Inputs xyz (B,N,3), q/key/val (B,N,D), wd1 (3,D), wd2/wg1/wg2 (D,D) in the
// (in, out) layout with each row padded to D + 8 floats (kWPad; the padding
// is never read into a product), biases (D), all f32 contiguous and 16-byte
// aligned;
// outputs out/m/l (B,N,D) f32 and idx (B,N,k) int32. D is 128, 256 or 512.
// s is 1/sqrt(D) computed in double and rounded to f32, as the plain
// PyTorch version computes it.
//
// The bf16 mode (`bf16` = 1; the TPU kernel's `precise=False`, selected
// under the PRECISION: bf16 policy): key and val are bf16 (widened to f32 as
// they are gathered); wd2, wg1 and wg2 are bf16, with s folded into wg2 and
// bg2 by the caller (wg2 = bf16(Wg2·s), bg2 = bg2·s in f32, as
// `fused_vector_attention` folds it, vector_attention_pallas.py:721-731), so
// z = relu_g·wg2 + bg2 with no further scale; wd1 comes rounded to bf16 (in
// f32). Each product rounds its left operand to bf16 and sums in f32
// (`_bdot`, :76): bf16(delta)·wd1 on FMAs, bf16(relu_d)·wd2,
// bf16(att_in)·wg1 and bf16(relu_g)·wg2 on bf16 `mma.sync` (vecattn_tile.cuh).
// att_in = q - key_j + pos, the softmax and the sum over (val_j + pos) stay
// f32, and so does the kNN. The instance takes W = __nv_bfloat16 where the
// f32 one takes float; the f32 instance is as it was.
//
// What bounds it on an H100. Operations: B·N·(2·N·C + k·(2·C·D + 6·D^2)),
// almost all of it the three D×D products per edge; at PTran's level 0
// (B=64, N=1024, D=512, k=16) that is 1.65 TFLOP. The products run on the
// tensor cores as 3×TF32 (three TF32 products per f32 product, for f32's
// accuracy: vecattn_tile.cuh), so their bound is 3 × 1.65 TFLOP at 495
// TFLOP/s, 10.0 ms, against 24.7 ms for the same work in f32 outside the
// tensor cores. Bytes: xyz, q, key, val and the weights read once,
// out/m/l/idx written once, ~0.8 GB there, 0.24 ms at 3.35 TB/s. So the
// tensor-core arithmetic bounds it. Next in line is the L2 stream of the
// weights: every block multiplies its 32 edge rows (D=512) by three 1 MiB
// weights, 103 GB of L2 reads per call at level 0 if each block read them
// alone. A cluster of kCluster blocks shares each weight chunk (one
// multicast copy per chunk and cluster), which cuts that kCluster times.
// In the bf16 mode each D×D product is one bf16 product at 989 TFLOP/s,
// 1.7 ms at level 0, a sixth of the 3×TF32 bound, and the weight stream
// moves half the bytes.
//
// Design:
// - One block of 256 threads per (cloud, TQ queries); TQ = 1024/D, for D =
//   128, 256 or 512. The block's E = 16·TQ edge rows (16 neighbour slots
//   per query; slots past k repeat slot 0 and are masked in the softmax).
//   The grid's query tiles are rounded up to whole clusters; the blocks
//   past the last query run every product on clamped inputs, take part in
//   every copy and barrier of their cluster, and store nothing.
// - Phase A, kNN: the block writes the TQ distance rows to shared memory
//   (the same formula as the plain version, so exact duplicates tie
//   exactly); then 8/TQ warps per query run k rounds of an arg-min over
//   (distance, index). Meanwhile the first weight chunks are in flight.
// - Phase B, the per-edge products (vecattn_tile.cuh, `rows_times_weights`:
//   3×TF32 mma.sync, weight chunks multicast across the cluster).
//   Activations sit in two (E, D) shared-memory tiles, G (the product's
//   input) and P (pos). A product writes its result over its input, so
//   three products need only G and P:
//     G = relu_d;  P = pos = G·Wd2 + bd2, G = q - key + P;
//     G = relu(G·Wg1 + bg1);  G = G·Wg2, z = (G + bg2)·s.
//   Between products a thread (query, 4 channels) applies biases, relus
//   and the gathers to its query's 16 × 4 tile.
// - Phase C, the softmax: a thread holds all k logits of its channels, so
//   m, l and out come from its registers, P and the gathered val rows.
// The kernel runs on the caller's stream, does not synchronise and
// allocates nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <math_constants.h>
#include <stdint.h>

#include "vecattn_tile.cuh"

namespace {

struct Layout {
  int tq;             // queries per block
  size_t act_floats;  // G and P, or the distance rows during phase A
  size_t bytes;       // dynamic shared memory
};

template <int D, typename V>
Layout make_layout(int N) {
  using T = Tile<D>;
  Layout L;
  L.tq = T::kTq;
  const size_t act = 2 * (size_t)T::kActFloats;
  const size_t dist = ((size_t)T::kTq * N + 3) / 4 * 4;  // float4-aligned end
  L.act_floats = act > dist ? act : dist;
  L.bytes = kBarrierBytes + sizeof(float) * L.act_floats +
            sizeof(V) * (size_t)kStages * T::kStageElems + sizeof(int) * (size_t)T::kE;
  return L;
}

// V: the element type of key, val and the (D, D) weights, float or
// __nv_bfloat16 (the bf16 mode)
template <int D, typename V>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
vecattn_fwd_kernel(const float* __restrict__ xyz, const float* __restrict__ q,
                   const V* __restrict__ key, const V* __restrict__ val,
                   const float* __restrict__ wd1, const float* __restrict__ bd1,
                   const V* __restrict__ wd2, const float* __restrict__ bd2,
                   const V* __restrict__ wg1, const float* __restrict__ bg1,
                   const V* __restrict__ wg2, const float* __restrict__ bg2,
                   float* __restrict__ out, float* __restrict__ m_out,
                   float* __restrict__ l_out, int* __restrict__ idx_out,
                   int N, int k, float scale, int act_floats) {
  using T = Tile<D>;
  constexpr int tq = T::kTq, ld = T::kLd;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* act = reinterpret_cast<float*>(smem_raw + kBarrierBytes);
  float* P = act;                        // [E][ld] pos
  float* G = act + T::kActFloats;        // [E][ld] relu_d, att_in, relu_g, the logits
  float* dist = act;                     // [tq][N] during phase A
  V* wbuf = reinterpret_cast<V*>(act + act_floats);  // [kStages][kChunk][D + kWPad]
  int* sidx = reinterpret_cast<int*>(wbuf + kStages * T::kStageElems);  // [tq][kMaxK]

  WeightPipe<V> pipe = pipe_init(smem_raw, wbuf);
  pipe_prologue<D, V>(pipe, wd2);  // the first chunks of Wd2 load during phase A

  const int b = blockIdx.y;
  const int n0 = blockIdx.x * tq;
  constexpr int per_query = D / kCols;
  const int ql = threadIdx.x / per_query;  // this thread's query in the block
  const int col0 = (threadIdx.x % per_query) * kCols;
  const int n = n0 + ql;
  const bool valid = n < N;
  const int n_ld = valid ? n : N - 1;    // idle queries of a ragged or idle tile
  const float* xyzb = xyz + (size_t)b * N * 3;

  // Phase A: the block's distance rows, then k arg-min rounds per query
  for (int e = threadIdx.x; e < tq * N; e += blockDim.x) {
    const int qi = e / N, j = e - qi * N;
    const float* xq = xyzb + (size_t)min(n0 + qi, N - 1) * 3;
    const float* xk = xyzb + (size_t)j * 3;
    const float dot = fmaf(xq[2], xk[2], fmaf(xq[1], xk[1], xq[0] * xk[0]));
    const float qsq = fmaf(xq[2], xq[2], fmaf(xq[1], xq[1], xq[0] * xq[0]));
    const float ksq = fmaf(xk[2], xk[2], fmaf(xk[1], xk[1], xk[0] * xk[0]));
    dist[e] = (-2.0f * dot + qsq) + ksq;
  }
  __syncthreads();
  // kWq warps per query: each takes the arg-min of its share of the row
  // (lanes scan their strided columns in ascending order, so a strict <
  // keeps the lowest index per lane; the shuffle breaks ties by index), and
  // the query's first lane combines the kWq candidates, lowest index first
  // among equal distances
  constexpr int kWq = kThreads / kWarp / tq;
  __shared__ float cand_d[kThreads / kWarp];
  __shared__ int cand_i[kThreads / kWarp];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int qa = warp / kWq, share = warp % kWq;
  float* drow = dist + (size_t)qa * N;
  for (int r = 0; r < k; ++r) {
    float bd = CUDART_INF_F;
    int bi = N;
    for (int j = share * kWarp + lane; j < N; j += kWarp * kWq) {
      const float d = drow[j];
      if (d < bd) { bd = d; bi = j; }
    }
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (od < bd || (od == bd && oi < bi)) { bd = od; bi = oi; }
    }
    if (lane == 0) {
      cand_d[warp] = bd;
      cand_i[warp] = bi;
    }
    __syncthreads();
    if (share == 0 && lane == 0) {
      for (int w = warp + 1; w < warp + kWq; ++w) {
        if (cand_d[w] < bd || (cand_d[w] == bd && cand_i[w] < bi)) {
          bd = cand_d[w];
          bi = cand_i[w];
        }
      }
      bi = min(bi, N - 1);  // only non-finite distances leave the sentinel
      sidx[qa * kMaxK + r] = bi;
      drow[bi] = CUDART_INF_F;
    }
    __syncthreads();  // after the last round sidx is complete, the distance rows dead
  }

  int nbr[kMaxK];  // slots past k repeat slot 0: finite, and masked below
#pragma unroll
  for (int r = 0; r < kMaxK; ++r) nbr[r] = sidx[ql * kMaxK + (r < k ? r : 0)];
  float* Pq = P + (size_t)ql * kMaxK * ld + col0;
  float* Gq = G + (size_t)ql * kMaxK * ld + col0;
  const size_t row_n = ((size_t)b * N + n_ld) * D;

  // G = relu((x_n - x_j)·Wd1 + bd1)
  {
    const float x0 = xyzb[n_ld * 3], x1 = xyzb[n_ld * 3 + 1], x2 = xyzb[n_ld * 3 + 2];
    const float4 w0 = ld4(wd1 + col0), w1 = ld4(wd1 + D + col0), w2 = ld4(wd1 + 2 * D + col0);
    const float4 bias = ld4(bd1 + col0);
#pragma unroll
    for (int r = 0; r < kMaxK; ++r) {
      const float* xj = xyzb + (size_t)nbr[r] * 3;
      float d0 = x0 - xj[0], d1 = x1 - xj[1], d2 = x2 - xj[2];
      if constexpr (kIsBf16<V>) {  // bf16(delta)·bf16(wd1): exact products, f32 sums
        d0 = round_bf16(d0);
        d1 = round_bf16(d1);
        d2 = round_bf16(d2);
      }
      float4 h;
      h.x = fmaxf(fmaf(d2, w2.x, fmaf(d1, w1.x, d0 * w0.x)) + bias.x, 0.0f);
      h.y = fmaxf(fmaf(d2, w2.y, fmaf(d1, w1.y, d0 * w0.y)) + bias.y, 0.0f);
      h.z = fmaxf(fmaf(d2, w2.z, fmaf(d1, w1.z, d0 * w0.z)) + bias.z, 0.0f);
      h.w = fmaxf(fmaf(d2, w2.w, fmaf(d1, w1.w, d0 * w0.w)) + bias.w, 0.0f);
      st4(Gq + r * ld, h);
    }
  }
  __syncthreads();

  // P = G·Wd2 + bd2;  G = (q_n - key_j) + P
  rows_times_weights<D, V>(pipe, G, wd2, wg1, G);
  {
    const float4 bias = ld4(bd2 + col0);
    const float4 qv = ld4(q + row_n + col0);
#pragma unroll
    for (int r = 0; r < kMaxK; ++r) {
      const float4 kv = ld4(key + ((size_t)b * N + nbr[r]) * D + col0);
      const float4 a = ld4(Gq + r * ld);
      const float4 p = make_float4(a.x + bias.x, a.y + bias.y, a.z + bias.z, a.w + bias.w);
      st4(Pq + r * ld, p);
      st4(Gq + r * ld, make_float4((qv.x - kv.x) + p.x, (qv.y - kv.y) + p.y,
                                   (qv.z - kv.z) + p.z, (qv.w - kv.w) + p.w));
    }
  }
  __syncthreads();

  // G = relu(G·Wg1 + bg1)
  rows_times_weights<D, V>(pipe, G, wg1, wg2, G);
  {
    const float4 bias = ld4(bg1 + col0);
#pragma unroll
    for (int r = 0; r < kMaxK; ++r) {
      const float4 a = ld4(Gq + r * ld);
      st4(Gq + r * ld, make_float4(fmaxf(a.x + bias.x, 0.0f), fmaxf(a.y + bias.y, 0.0f),
                                   fmaxf(a.z + bias.z, 0.0f), fmaxf(a.w + bias.w, 0.0f)));
    }
  }
  __syncthreads();

  // z = (G·Wg2 + bg2)·s (bf16 mode: s folded in, scale 1); the softmax over the k valid slots
  rows_times_weights<D, V>(pipe, G, wg2, static_cast<const V*>(nullptr), G);
  cluster_sync();  // no block exits while another of its cluster may still signal it
  if (!valid) return;  // no barrier follows
  const float4 b4 = ld4(bg2 + col0);
  const float bias[kCols] = {b4.x, b4.y, b4.z, b4.w};
  float z[kMaxK][kCols];
  float mx[kCols], lsum[kCols], o[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    mx[c] = -CUDART_INF_F;
    lsum[c] = 0.0f;
    o[c] = 0.0f;
  }
#pragma unroll
  for (int r = 0; r < kMaxK; ++r) {
    const float4 a = ld4(Gq + r * ld);
    const float av[kCols] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      z[r][c] = (av[c] + bias[c]) * scale;
      if (r < k) mx[c] = fmaxf(mx[c], z[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < kMaxK; ++r) {
    if (r < k) {
      const float4 v = ld4(val + ((size_t)b * N + nbr[r]) * D + col0);
      const float4 p = ld4(Pq + r * ld);
      const float vp[kCols] = {v.x + p.x, v.y + p.y, v.z + p.z, v.w + p.w};
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float e = expf(z[r][c] - mx[c]);
        lsum[c] += e;
        o[c] += e * vp[c];
      }
    }
  }
  const size_t row = ((size_t)b * N + n) * D + col0;
  st4(out + row, make_float4(o[0] / lsum[0], o[1] / lsum[1], o[2] / lsum[2], o[3] / lsum[3]));
  st4(m_out + row, make_float4(mx[0], mx[1], mx[2], mx[3]));
  st4(l_out + row, make_float4(lsum[0], lsum[1], lsum[2], lsum[3]));
  if (col0 == 0) {
    for (int r = 0; r < k; ++r) idx_out[((size_t)b * N + n) * k + r] = sidx[ql * kMaxK + r];
  }
}

template <int D, typename V>
int launch(const float* xyz, const float* q, const void* key, const void* val,
           const float* wd1, const float* bd1, const void* wd2, const float* bd2,
           const void* wg1, const float* bg1, const void* wg2, const float* bg2,
           float* out, float* m, float* l, int* idx, int B, int N, int k, cudaStream_t stream) {
  const Layout L = make_layout<D, V>(N);
  if (L.bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  // the bf16 mode's caller has folded s into wg2 and bg2
  const float scale = kIsBf16<V> ? 1.0f : (float)(1.0 / sqrt((double)D));
  cudaError_t err = cudaFuncSetAttribute(
      vecattn_fwd_kernel<D, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (N + L.tq - 1) / L.tq;
  const dim3 grid((tiles + kCluster - 1) / kCluster * kCluster, B);
  vecattn_fwd_kernel<D, V><<<grid, kThreads, L.bytes, stream>>>(
      xyz, q, static_cast<const V*>(key), static_cast<const V*>(val), wd1, bd1,
      static_cast<const V*>(wd2), bd2, static_cast<const V*>(wg1), bg1,
      static_cast<const V*>(wg2), bg2, out, m, l, idx, N, k, scale, (int)L.act_floats);
  return (int)cudaGetLastError();
}

template <typename V>
int launch_width(const float* xyz, const float* q, const void* key, const void* val,
                 const float* wd1, const float* bd1, const void* wd2, const float* bd2,
                 const void* wg1, const float* bg1, const void* wg2, const float* bg2,
                 float* out, float* m, float* l, int* idx, int B, int N, int D, int k,
                 cudaStream_t s) {
  switch (D) {
    case 128:
      return launch<128, V>(xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2, out, m, l,
                            idx, B, N, k, s);
    case 256:
      return launch<256, V>(xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2, out, m, l,
                            idx, B, N, k, s);
    case 512:
      return launch<512, V>(xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2, out, m, l,
                            idx, B, N, k, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`. key, val, wd2, wg1 and wg2 are float,
// or bf16 where `bf16` is 1 (the bf16 mode: the contract's note). Returns a
// cudaError_t: cudaErrorInvalidValue when the shapes are out of range (D
// not 128, 256 or 512, k outside [1, min(N, 16)], bf16 not 0 or 1) or N is
// too large for the distance rows in shared memory; otherwise
// cudaGetLastError() after the launch.
int vecattn_fwd(const float* xyz, const float* q, const void* key, const void* val,
                const float* wd1, const float* bd1, const void* wd2, const float* bd2,
                const void* wg1, const float* bg1, const void* wg2, const float* bg2,
                float* out, float* m, float* l, int* idx,
                int B, int N, int D, int k, int bf16, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || k < 1 || k > kMaxK || k > N || (bf16 != 0 && bf16 != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch_width<__nv_bfloat16>(xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2,
                                            bg2, out, m, l, idx, B, N, D, k, s)
              : launch_width<float>(xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2,
                                    out, m, l, idx, B, N, D, k, s);
}

const char* vecattn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
