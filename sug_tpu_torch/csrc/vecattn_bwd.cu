// Vector-attention backward (Point Transformer): from the forward's inputs,
// its saved idx, m, l, out and the cotangent dout, the gradients of q, key,
// val and of the eight weights of the delta and gamma MLPs.
//
// Replaces the TPU kernels behind `_bwd_pallas`
// (sug_tpu/ops/vector_attention_pallas.py:574; bodies `_bwd_input_kernel` :279
// and `_bwd_weight_kernel` :358), the backward of `fused_vector_attention`.
//
// Contract, per edge (n, j) of cloud b with neighbour i = idx[b,n,j], s = 1/sqrt(D):
//   delta = x_n - x_i;  relu_d = relu(delta·Wd1 + bd1);  pos = relu_d·Wd2 + bd2
//   att_in = q_n - key_i + pos;  relu_g = relu(att_in·Wg1 + bg1)
//   z = (relu_g·Wg2 + bg2)·s;    alpha = exp(z - m_n) / l_n
//   dvpos = alpha * dout_n;      dzs = dvpos * (val_i + pos - out_n) · s
//   dh_g = (relu_g > 0) * (dzs·Wg2ᵀ);   datt = dh_g·Wg1ᵀ
//   dpos = datt + dvpos;         dh_d = (relu_d > 0) * (dpos·Wd2ᵀ)
//   dq_n = Σ_j datt;  dkey_i = -Σ datt;  dval_i = Σ dvpos   (over the edges that name i)
//   dWg2 = relu_gᵀ·dzs;  dWg1 = att_inᵀ·dh_g;  dWd2 = relu_dᵀ·dpos;  dWd1 = deltaᵀ·dh_d
//   dbg2 = Σ dzs;  dbg1 = Σ dh_g;  dbd2 = Σ dpos;  dbd1 = Σ dh_d   (over every edge)
// Tensors as in vecattn_fwd.cu (f32, contiguous, 16-byte aligned, weights in
// the (in, out) layout, the (D, D) ones and their transposes with rows padded
// to D + 8 elements, D = 128, 256 or 512, k <= 16); idx (B,N,k) int32; xyz
// gets no gradient.
//
// The bf16 mode (`bf16` = 1; `precise=False` of the TPU kernels, the
// PRECISION: bf16 policy's): key, val, the (D, D) weights and their
// transposes are bf16, s is folded into wg2 and bg2 by the caller as in
// vecattn_fwd.cu (so the formulas above run with s = 1, and the plane dzs
// holds dz = dvpos·(val_i + pos - out), the gradient of the folded logits,
// whose sums are the gradients of the folded wg2 and bg2: the caller
// multiplies them by s), wd1 comes rounded to bf16. The roundings are the
// TPU kernels' (`_bwd_input_kernel` :279, `_bwd_weight_kernel` :358): every
// product of the chain rounds its left operand to bf16 (bf16(delta),
// relu_d, att_in, relu_g in the replay; bf16(dz)·wg2ᵀ, bf16(dh_g)·wg1ᵀ,
// bf16(dpos)·wd2ᵀ back), each weight gradient is the product of two
// bf16-rounded operands (`_bdotT`, :85), dWd1 = bf16(delta)ᵀ·bf16(dh_d),
// the bias gradients sum the unrounded cotangents, dq sums datt unrounded,
// and dkey, dval sum bf16(-datt), bf16(dvpos) in f32 (:351-352).
//
// What bounds it on an H100. Operations: B·N·k·(18·D² + 4·C·D) — per edge
// three D×D products to replay the forward, three for the chain back and
// three outer products for the weight gradients; at PTran's level 0 (B=64,
// N=1024, D=512, k=16) 4.95 TFLOP. The D×D products run on the tensor cores
// as 3×TF32 (vecattn_tile.cuh), so their bound is 3 × 4.95 TFLOP at 495
// TFLOP/s, 30 ms, against 74 ms for the same work in f32 outside the tensor
// cores. Bytes: 10 (B,N,D) tensors, xyz, idx and the weights, about 1.35 GB
// there, under 1 ms. The nine staged planes below add 19.3 GB of writes per
// call at level 0 and at least as many bytes of reads, some 11.5 ms at 3.35
// TB/s, which the bound does not count (they are the design's, not the
// function's). In the bf16 mode the products' bound falls to 5.0 ms at level
// 0 (one bf16 product each at 989 TFLOP/s), below the staged planes' time,
// which stay f32: the planes that are only read rounded (relu_d, att_in,
// relu_g, datt, dvpos) could be stored in bf16.
//
// Design: five kernels, no float atomics, every sum in a fixed order, so two
// launches on the same inputs agree bit for bit. The caller walks the clouds
// in chunks, so that the staged tensors below stay small.
// 1. `edge`: the forward kernel's block (vecattn_tile.cuh: TQ queries × 16
//    slots, tiles G and P in shared memory, clusters of kCluster blocks
//    sharing every weight chunk) replays the three forward products from
//    idx, then runs the three products of the chain back with the
//    transposed weights (transposed once by the caller); all six on the
//    tensor cores. Between products a thread (query, 4 channels) keeps the
//    two relu masks of its 16 × 4 tile as 64 bits each. It owns all 16 slots
//    of its query, so dq is its sum over the slots in ascending order. Slots
//    past k repeat slot 0 with alpha = 0, so all their cotangents are
//    exactly zero. It writes dq, and stages per edge row, in global memory,
//    the operands of what follows: relu_d, att_in, relu_g, dzs, dh_g, datt,
//    dvpos, dpos, dh_d (rows, D) and [delta, 1] (rows, 4), rows =
//    clouds·N·16.
// 2. `wgrad`: dWg2, dWg1, dWd2 as split-K products AᵀG of the staged
//    operands on the tensor cores (3×TF32 mma.sync), a 128 × 128 tile and
//    one K share per block, operands through a cp.async ring. The
//    blocks of the first tile row also sum G's columns: the three bias
//    gradients. Each block writes its own partial.
// 3. `thin`: dWd1 and dbd1 together as [delta, 1]ᵀ·dh_d, a (4, D) result,
//    split over row shares, a partial per block.
// 4. `scatter`: dkey and dval. Each key gets a warp that scans its cloud's
//    idx (in shared memory) in (n, j) order and adds the staged datt and
//    dvpos rows of the edges that name it.
// 5. `reduce`: sums the partials of every chunk and share, in order.
// Each launcher runs on the caller's stream, does not synchronise and
// allocates nothing.

#include "vecattn_tile.cuh"

namespace {

// planes of the staged (9, rows, D) tensor
enum Plane { kReluD = 0, kAttIn, kReluG, kDzs, kDhG, kDatt, kDvpos, kDpos, kDhD, kPlanes };

constexpr int kTile = 128;      // wgrad: output tile edge
constexpr int kTileK = 16;      // wgrad: rows per pipeline stage
constexpr int kTileLd = kTile + 8;  // wgrad: padded stage row, so fragment loads do not conflict
constexpr int kWgStages = 3;    // wgrad: pipeline stages
constexpr size_t kWgSmem = sizeof(float) * 2 * kWgStages * kTileK * kTileLd;
constexpr int kScatterWarps = 16;

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// bit c of the result: v's component c is positive
__device__ __forceinline__ unsigned positive_bits(float4 v) {
  return (v.x > 0.0f ? 1u : 0u) | (v.y > 0.0f ? 2u : 0u) | (v.z > 0.0f ? 4u : 0u) |
         (v.w > 0.0f ? 8u : 0u);
}

__device__ __forceinline__ float4 masked(float4 a, unsigned bits) {
  return make_float4(bits & 1u ? a.x : 0.0f, bits & 2u ? a.y : 0.0f, bits & 4u ? a.z : 0.0f,
                     bits & 8u ? a.w : 0.0f);
}

// V: the element type of key, val and the (D, D) weights, float or
// __nv_bfloat16 (the bf16 mode)
template <int D, typename V>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
vecattn_bwd_edge_kernel(const float* __restrict__ xyz, const float* __restrict__ q,
                        const V* __restrict__ key, const V* __restrict__ val,
                        const float* __restrict__ wd1, const float* __restrict__ bd1,
                        const V* __restrict__ wd2, const float* __restrict__ bd2,
                        const V* __restrict__ wg1, const float* __restrict__ bg1,
                        const V* __restrict__ wg2, const float* __restrict__ bg2,
                        const V* __restrict__ wd2t, const V* __restrict__ wg1t,
                        const V* __restrict__ wg2t, const int* __restrict__ idx,
                        const float* __restrict__ m_in, const float* __restrict__ l_in,
                        const float* __restrict__ out, const float* __restrict__ dout,
                        float* __restrict__ dq, float* __restrict__ stage,
                        float* __restrict__ delta1, int N, int k, float scale, size_t plane) {
  using T = Tile<D>;
  constexpr int tq = T::kTq, ld = T::kLd;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* P = reinterpret_cast<float*>(smem_raw + kBarrierBytes);  // [E][ld] pos, then dvpos
  float* G = P + T::kActFloats;          // [E][ld] the next product's input
  V* wbuf = reinterpret_cast<V*>(G + T::kActFloats);  // [kStages][kChunk][D + kWPad]

  WeightPipe<V> pipe = pipe_init(smem_raw, wbuf);
  pipe_prologue<D, V>(pipe, wd2);

  const int b = blockIdx.y;
  constexpr int per_query = D / kCols;
  const int ql = threadIdx.x / per_query;
  const int col0 = (threadIdx.x % per_query) * kCols;
  const int n = blockIdx.x * tq + ql;
  const bool valid = n < N;
  const int n_ld = valid ? n : N - 1;    // idle queries of a ragged or idle tile
  const float* xyzb = xyz + (size_t)b * N * 3;
  float* Pq = P + (size_t)ql * kMaxK * ld + col0;
  float* Gq = G + (size_t)ql * kMaxK * ld + col0;
  const size_t row_n = ((size_t)b * N + n_ld) * D;
  // this thread's part of staged row r of its query
  const size_t srow = ((size_t)b * N + n_ld) * kMaxK;
  float* sq = stage + srow * D + col0;
#define STAGE(plane_id, r, v) \
  if (valid) st4(sq + (size_t)(plane_id) * plane + (size_t)(r) * D, (v))

  int nbr[kMaxK];  // slots past k repeat slot 0 and get alpha = 0 below
#pragma unroll
  for (int r = 0; r < kMaxK; ++r) nbr[r] = idx[((size_t)b * N + n_ld) * k + (r < k ? r : 0)];

  unsigned long long mask_d = 0ull, mask_g = 0ull;  // bit 4·r + c: relu_x[r][col0 + c] > 0

  // G = relu_d = relu((x_n - x_i)·Wd1 + bd1)
  {
    const float x0 = xyzb[n_ld * 3], x1 = xyzb[n_ld * 3 + 1], x2 = xyzb[n_ld * 3 + 2];
    const float4 w0 = ld4(wd1 + col0), w1 = ld4(wd1 + D + col0), w2 = ld4(wd1 + 2 * D + col0);
    const float4 bias = ld4(bd1 + col0);
#pragma unroll
    for (int r = 0; r < kMaxK; ++r) {
      const float* xj = xyzb + (size_t)nbr[r] * 3;
      float d0 = x0 - xj[0], d1 = x1 - xj[1], d2 = x2 - xj[2];
      if constexpr (kIsBf16<V>) {  // bf16(delta), here and in dWd1 (the thin kernel)
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
      STAGE(kReluD, r, h);
      mask_d |= (unsigned long long)positive_bits(h) << (4 * r);
      if (valid && col0 == 0) st4(delta1 + (srow + r) * 4, make_float4(d0, d1, d2, 1.0f));
    }
  }
  __syncthreads();

  // P = pos = G·Wd2 + bd2;  G = att_in = (q_n - key_i) + pos
  rows_times_weights<D, V>(pipe, G, wd2, wg1, G);
  {
    const float4 bias = ld4(bd2 + col0);
    const float4 qv = ld4(q + row_n + col0);
#pragma unroll
    for (int r = 0; r < kMaxK; ++r) {
      const float4 kv = ld4(key + ((size_t)b * N + nbr[r]) * D + col0);
      const float4 acc = ld4(Gq + r * ld);
      const float4 p = make_float4(acc.x + bias.x, acc.y + bias.y, acc.z + bias.z,
                                   acc.w + bias.w);
      const float4 a = make_float4((qv.x - kv.x) + p.x, (qv.y - kv.y) + p.y,
                                   (qv.z - kv.z) + p.z, (qv.w - kv.w) + p.w);
      st4(Pq + r * ld, p);
      st4(Gq + r * ld, a);
      STAGE(kAttIn, r, a);
    }
  }
  __syncthreads();

  // G = relu_g = relu(G·Wg1 + bg1)
  rows_times_weights<D, V>(pipe, G, wg1, wg2, G);
  {
    const float4 bias = ld4(bg1 + col0);
#pragma unroll
    for (int r = 0; r < kMaxK; ++r) {
      const float4 acc = ld4(Gq + r * ld);
      const float4 h = make_float4(fmaxf(acc.x + bias.x, 0.0f), fmaxf(acc.y + bias.y, 0.0f),
                                   fmaxf(acc.z + bias.z, 0.0f), fmaxf(acc.w + bias.w, 0.0f));
      st4(Gq + r * ld, h);
      STAGE(kReluG, r, h);
      mask_g |= (unsigned long long)positive_bits(h) << (4 * r);
    }
  }
  __syncthreads();

  // z = (G·Wg2 + bg2)·s;  alpha = exp(z - m)/l;  P = dvpos = alpha·dout;
  // G = dzs = dvpos·((val_i + pos) - out)·s
  rows_times_weights<D, V>(pipe, G, wg2, wg2t, G);
  {
    const float4 b4 = ld4(bg2 + col0), m4 = ld4(m_in + row_n + col0);
    const float4 l4 = ld4(l_in + row_n + col0), o4 = ld4(out + row_n + col0);
    const float4 g4 = ld4(dout + row_n + col0);
    const float bias[kCols] = {b4.x, b4.y, b4.z, b4.w}, mx[kCols] = {m4.x, m4.y, m4.z, m4.w};
    const float ls[kCols] = {l4.x, l4.y, l4.z, l4.w}, o[kCols] = {o4.x, o4.y, o4.z, o4.w};
    const float go[kCols] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
    for (int r = 0; r < kMaxK; ++r) {
      const float4 v4 = ld4(val + ((size_t)b * N + nbr[r]) * D + col0);
      const float4 p4 = ld4(Pq + r * ld);
      const float4 z4 = ld4(Gq + r * ld);
      const float vp[kCols] = {v4.x + p4.x, v4.y + p4.y, v4.z + p4.z, v4.w + p4.w};
      const float acc[kCols] = {z4.x, z4.y, z4.z, z4.w};
      float dv[kCols], dz[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float z = (acc[c] + bias[c]) * scale;
        const float alpha = r < k ? expf(z - mx[c]) / ls[c] : 0.0f;
        dv[c] = alpha * go[c];
        dz[c] = dv[c] * (vp[c] - o[c]) * scale;
      }
      const float4 dv4 = make_float4(dv[0], dv[1], dv[2], dv[3]);
      const float4 dz4 = make_float4(dz[0], dz[1], dz[2], dz[3]);
      st4(Pq + r * ld, dv4);
      st4(Gq + r * ld, dz4);
      STAGE(kDvpos, r, dv4);
      STAGE(kDzs, r, dz4);
    }
  }
  __syncthreads();

  // G = dh_g = (relu_g > 0)·(G·Wg2ᵀ)
  rows_times_weights<D, V>(pipe, G, wg2t, wg1t, G);
#pragma unroll
  for (int r = 0; r < kMaxK; ++r) {
    const float4 h = masked(ld4(Gq + r * ld), (unsigned)(mask_g >> (4 * r)) & 15u);
    st4(Gq + r * ld, h);
    STAGE(kDhG, r, h);
  }
  __syncthreads();

  // datt = G·Wg1ᵀ;  dq_n = sum over the slots;  G = dpos = datt + dvpos
  rows_times_weights<D, V>(pipe, G, wg1t, wd2t, G);
  {
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int r = 0; r < kMaxK; ++r) {
      const float4 da = ld4(Gq + r * ld);
      const float4 dp = add4(da, ld4(Pq + r * ld));
      sum = add4(sum, da);
      st4(Gq + r * ld, dp);
      STAGE(kDatt, r, da);
      STAGE(kDpos, r, dp);
    }
    if (valid) st4(dq + row_n + col0, sum);
  }
  __syncthreads();

  // dh_d = (relu_d > 0)·(G·Wd2ᵀ)
  rows_times_weights<D, V>(pipe, G, wd2t, static_cast<const V*>(nullptr), G);
#pragma unroll
  for (int r = 0; r < kMaxK; ++r) {
    STAGE(kDhD, r, masked(ld4(Gq + r * ld), (unsigned)(mask_d >> (4 * r)) & 15u));
  }
#undef STAGE
  cluster_sync();  // no block exits while another of its cluster may still signal it
}

// One 128 × 128 tile of AᵀG over rows [k0, k1) of the staged operands A and G
// (rows, D), on the tensor cores as 3×TF32 (vecattn_tile.cuh): partial[split]
// [pair] is (D + 1, D), dW in its first D rows (in, out) and G's column sums,
// the bias gradient, in the last. The mma's A operand (16 weight rows × 8
// edge rows) is read transposed from the row-major stage, which mma.sync
// allows because its fragments are loaded by hand. Warp (wm, wn) of the 4 ×
// 2 warps owns the 32 × 64 sub-tile at (32·wm, 64·wn). kBf16 (the bf16
// mode): both operands rounded to bf16 as the fragments load, one bf16
// m16n8k16 per chunk of 16 rows, inner index t + 4i in the slots of lane
// (g, t) as in vecattn_tile.cuh; the column sums stay over the unrounded G.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
vecattn_bwd_wgrad_kernel(const float* __restrict__ stage, float* __restrict__ partial,
                         int rows, int D, int share, size_t plane) {
  extern __shared__ __align__(16) float wsm[];
  // [kWgStages][kTileK][kTileLd] each
  auto As = reinterpret_cast<float(*)[kTileK][kTileLd]>(wsm);
  auto Gs = reinterpret_cast<float(*)[kTileK][kTileLd]>(wsm + kWgStages * kTileK * kTileLd);
  const int pair = blockIdx.z;  // dWg2, dWg1, dWd2
  const int a_plane = pair == 0 ? kReluG : pair == 1 ? kAttIn : kReluD;
  const int g_plane = pair == 0 ? kDzs : pair == 1 ? kDhG : kDpos;
  const int tiles = D / kTile;
  const int m0 = (blockIdx.x / tiles) * kTile, n0 = (blockIdx.x % tiles) * kTile;
  const float* A = stage + (size_t)a_plane * plane + m0;
  const float* Gm = stage + (size_t)g_plane * plane + n0;
  const int k0 = blockIdx.y * share;
  const int k1 = min(k0 + share, rows);
  const int nchunks = k1 > k0 ? (k1 - k0) / kTileK : 0;  // rows and share are multiples of 16
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 64;

  // a stage: 16 rows × 128 floats of each operand, two float4 per thread each
  auto load = [&](int stage_id, int chunk) {
    const size_t base = (size_t)(k0 + chunk * kTileK) * D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int f = threadIdx.x + i * kThreads;  // float4 index in the 16 × 32 stage
      const int r = f / (kTile / 4), c = (f % (kTile / 4)) * 4;
      cp_async16(&As[stage_id][r][c], A + base + (size_t)r * D + c);
      cp_async16(&Gs[stage_id][r][c], Gm + base + (size_t)r * D + c);
    }
    cp_async_commit();
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.0f;
    }
  }
  float colsum = 0.0f;  // thread t < 128 of the first tile row: column n0 + t
  const bool sums = m0 == 0 && threadIdx.x < kTile;

  // a ring of kWgStages stages, kWgStages - 1 chunks in flight; an empty
  // group stands in for a chunk past the share, so the waits count alike
  for (int c = 0; c < kWgStages - 1; ++c) {
    if (c < nchunks) {
      load(c, c);
    } else {
      cp_async_commit();
    }
  }
  for (int ch = 0; ch < nchunks; ++ch) {
    cp_async_wait<kWgStages - 2>();
    __syncthreads();  // chunk ch has landed for every thread; every thread is done with ch - 1
    const int next = ch + kWgStages - 1;  // into the stage chunk ch - 1 left
    if (next < nchunks) {
      load(next % kWgStages, next);
    } else {
      cp_async_commit();
    }
    const int st = ch % kWgStages;
    if constexpr (kBf16) {
      static_assert(kTileK == 16, "a bf16 chunk is one k16 step");
      uint32_t a[2][4];  // [m tile]
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int c = wm + mi * 16 + g;
        a[mi][0] = pack_bf16(As[st][t][c], As[st][t + 4][c]);
        a[mi][1] = pack_bf16(As[st][t][c + 8], As[st][t + 4][c + 8]);
        a[mi][2] = pack_bf16(As[st][t + 8][c], As[st][t + 12][c]);
        a[mi][3] = pack_bf16(As[st][t + 8][c + 8], As[st][t + 12][c + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int c = wn + ni * 8 + g;
        const uint32_t b[2] = {pack_bf16(Gs[st][t][c], Gs[st][t + 4][c]),
                               pack_bf16(Gs[st][t + 8][c], Gs[st][t + 12][c])};
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_bf16(part, a[mi], b);
#pragma unroll
          for (int c4 = 0; c4 < 4; ++c4) acc[mi][ni][c4] += part[c4];
        }
      }
    } else {
      uint32_t a_hi[2][2][4], a_lo[2][2][4];  // [m tile][k-step]
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const float* a0 = &As[st][ks * 8 + t][wm + mi * 16 + g];
          const float* a4 = &As[st][ks * 8 + t + 4][wm + mi * 16 + g];
          split_tf32(a0[0], a_hi[mi][ks][0], a_lo[mi][ks][0]);
          split_tf32(a0[8], a_hi[mi][ks][1], a_lo[mi][ks][1]);
          split_tf32(a4[0], a_hi[mi][ks][2], a_lo[mi][ks][2]);
          split_tf32(a4[8], a_hi[mi][ks][3], a_lo[mi][ks][3]);
        }
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        uint32_t b_hi[2][2], b_lo[2][2];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          split_tf32(Gs[st][ks * 8 + t][wn + ni * 8 + g], b_hi[ks][0], b_lo[ks][0]);
          split_tf32(Gs[st][ks * 8 + t + 4][wn + ni * 8 + g], b_hi[ks][1], b_lo[ks][1]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          // the chunk's 16 rows in a fresh accumulator, added in f32 (as in
          // rows_times_weights)
          float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            mma_3xtf32(part, a_hi[mi][ks], a_lo[mi][ks], b_hi[ks], b_lo[ks]);
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mi][ni][c] += part[c];
        }
      }
    }
    if (sums) {
#pragma unroll
      for (int kk = 0; kk < kTileK; ++kk) colsum += Gs[st][kk][threadIdx.x];
    }
  }

  float* dst = partial + ((size_t)blockIdx.y * 3 + pair) * (size_t)(D + 1) * D;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      float* o = dst + (size_t)(m0 + wm + mi * 16 + g) * D + n0 + wn + ni * 8 + 2 * t;
      *reinterpret_cast<float2*>(o) = make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(o + 8 * (size_t)D) = make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
  }
  if (sums) dst[(size_t)D * D + n0 + threadIdx.x] = colsum;
}

// partial[split] (4, D) = [delta, 1]ᵀ·dh_d over this block's share of the
// rows: dWd1 in rows 0-2, dbd1 in row 3. Thread t owns columns 4t..4t+3.
// kBf16 (the bf16 mode): dWd1 takes dh_d rounded to bf16 (delta comes
// rounded from the edge kernel), dbd1 the unrounded dh_d.
template <bool kBf16>
__global__ void vecattn_bwd_thin_kernel(const float* __restrict__ delta1,
                                        const float* __restrict__ dh_d,
                                        float* __restrict__ partial, int rows, int D, int share) {
  const int col0 = threadIdx.x * 4;
  const int k0 = blockIdx.x * share;
  const int k1 = min(k0 + share, rows);
  float4 acc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
  for (int r = k0; r < k1; ++r) {
    const float4 a = ld4(delta1 + (size_t)r * 4);
    const float4 g1 = ld4(dh_d + (size_t)r * D + col0);
    const float4 gw = kBf16 ? round_bf16(g1) : g1;
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 g = i < 3 ? gw : g1;
      acc[i].x = fmaf(av[i], g.x, acc[i].x);
      acc[i].y = fmaf(av[i], g.y, acc[i].y);
      acc[i].z = fmaf(av[i], g.z, acc[i].z);
      acc[i].w = fmaf(av[i], g.w, acc[i].w);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) st4(partial + ((size_t)blockIdx.x * 4 + i) * D + col0, acc[i]);
}

// dkey[b,i] = -Σ datt, dval[b,i] = Σ dvpos over the edges (n, j) with
// idx[b,n,j] = i, in ascending (n, j). One warp per key; lane t owns columns
// 128·c + 4t..4t+3 for c < D/128. kBf16 (the bf16 mode): each term rounded
// to bf16 first, the sums f32.
template <bool kBf16>
__global__ void __launch_bounds__(kScatterWarps* kWarp)
vecattn_bwd_scatter_kernel(const int* __restrict__ idx, const float* __restrict__ datt,
                           const float* __restrict__ dvpos, float* __restrict__ dkey,
                           float* __restrict__ dval, int N, int D, int k) {
  extern __shared__ int sidx[];  // [N·k] this cloud's idx
  const int b = blockIdx.y;
  const int edges = N * k;
  for (int e = threadIdx.x; e < edges; e += blockDim.x) sidx[e] = idx[(size_t)b * edges + e];
  __syncthreads();
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int i = blockIdx.x * kScatterWarps + warp;
  if (i >= N) return;  // no barrier follows
  const int nvec = D / 128;
  float4 ak[kMaxD / 128], av[kMaxD / 128];
#pragma unroll
  for (int c = 0; c < kMaxD / 128; ++c) ak[c] = av[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int base = 0; base < edges; base += kWarp) {
    const int e = base + lane;
    unsigned hits = __ballot_sync(0xffffffffu, e < edges && sidx[e] == i);
    while (hits) {
      const int e2 = base + __ffs(hits) - 1;
      hits &= hits - 1;
      const int n = e2 / k, j = e2 - n * k;
      const size_t off = (((size_t)b * N + n) * kMaxK + j) * D + lane * 4;
#pragma unroll
      for (int c = 0; c < kMaxD / 128; ++c) {
        if (c < nvec) {
          const float4 da = ld4(datt + off + c * 128), dv = ld4(dvpos + off + c * 128);
          ak[c] = add4(ak[c], kBf16 ? round_bf16(da) : da);
          av[c] = add4(av[c], kBf16 ? round_bf16(dv) : dv);
        }
      }
    }
  }
  const size_t o = ((size_t)b * N + i) * D + lane * 4;
#pragma unroll
  for (int c = 0; c < kMaxD / 128; ++c) {
    if (c < nvec) {
      st4(dkey + o + c * 128, make_float4(-ak[c].x, -ak[c].y, -ak[c].z, -ak[c].w));
      st4(dval + o + c * 128, av[c]);
    }
  }
}

// dst[i] = Σ_p src[p·count + i], p ascending; blockIdx.y picks the (wgrad,
// thin) set of partials.
__global__ void vecattn_bwd_reduce_kernel(const float* __restrict__ src0, float* __restrict__ dst0,
                                          int count0, int parts0,
                                          const float* __restrict__ src1, float* __restrict__ dst1,
                                          int count1, int parts1) {
  const float* src = blockIdx.y == 0 ? src0 : src1;
  float* dst = blockIdx.y == 0 ? dst0 : dst1;
  const int count = blockIdx.y == 0 ? count0 : count1;
  const int parts = blockIdx.y == 0 ? parts0 : parts1;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float sum = 0.0f;
  for (int p = 0; p < parts; ++p) sum += src[(size_t)p * count + i];
  dst[i] = sum;
}

bool bad_shape(int B, int N, int D, int k) {
  return B < 1 || B > 65535 || N < 1 || k < 1 || k > kMaxK || k > N ||
         (D != 128 && D != 256 && D != 512);
}

template <int D, typename V>
int launch_edge(const float* xyz, const float* q, const void* key, const void* val,
                const float* wd1, const float* bd1, const void* wd2, const float* bd2,
                const void* wg1, const float* bg1, const void* wg2, const float* bg2,
                const void* wd2t, const void* wg1t, const void* wg2t, const int* idx,
                const float* m, const float* l, const float* out, const float* dout, float* dq,
                float* stage, float* delta1, int B, int N, int k, cudaStream_t stream) {
  using T = Tile<D>;
  const size_t bytes = kBarrierBytes + sizeof(float) * 2 * (size_t)T::kActFloats +
                       sizeof(V) * (size_t)kStages * T::kStageElems;
  if (bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      vecattn_bwd_edge_kernel<D, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  // the bf16 mode's caller has folded s into wg2 and bg2
  const float scale = kIsBf16<V> ? 1.0f : (float)(1.0 / sqrt((double)D));
  const int tiles = (N + T::kTq - 1) / T::kTq;
  const dim3 grid((tiles + kCluster - 1) / kCluster * kCluster, B);
  const auto w = [](const void* p) { return static_cast<const V*>(p); };
  vecattn_bwd_edge_kernel<D, V><<<grid, kThreads, bytes, stream>>>(
      xyz, q, w(key), w(val), wd1, bd1, w(wd2), bd2, w(wg1), bg1, w(wg2), bg2, w(wd2t), w(wg1t),
      w(wg2t), idx, m, l, out, dout, dq, stage, delta1, N, k, scale,
      (size_t)B * N * kMaxK * D);
  return (int)cudaGetLastError();
}

template <typename V>
int launch_edge_width(const float* xyz, const float* q, const void* key, const void* val,
                      const float* wd1, const float* bd1, const void* wd2, const float* bd2,
                      const void* wg1, const float* bg1, const void* wg2, const float* bg2,
                      const void* wd2t, const void* wg1t, const void* wg2t, const int* idx,
                      const float* m, const float* l, const float* out, const float* dout,
                      float* dq, float* stage, float* delta1, int B, int N, int D, int k,
                      cudaStream_t s) {
#define EDGE_ARGS                                                                            \
  xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2, wd2t, wg1t, wg2t, idx, m, l, out, \
      dout, dq, stage, delta1, B, N, k, s
  switch (D) {
    case 128: return launch_edge<128, V>(EDGE_ARGS);
    case 256: return launch_edge<256, V>(EDGE_ARGS);
    default: return launch_edge<512, V>(EDGE_ARGS);
  }
#undef EDGE_ARGS
}

}  // namespace

extern "C" {

// Every launcher returns a cudaError_t: cudaErrorInvalidValue when the shapes
// are out of range or `bf16` is not 0 or 1, otherwise cudaGetLastError()
// after the launch. `bf16` = 1 runs the bf16 mode (the contract's note).

// Replays the B clouds given and writes dq (B,N,D), the nine staged planes
// `stage` (9, B·N·16, D) and `delta1` (B·N·16, 4). wd2t, wg1t, wg2t are the
// transposes of wd2, wg1, wg2; key, val and these six are float, or bf16
// where `bf16` is 1.
int vecattn_bwd_edge(const float* xyz, const float* q, const void* key, const void* val,
                     const float* wd1, const float* bd1, const void* wd2, const float* bd2,
                     const void* wg1, const float* bg1, const void* wg2, const float* bg2,
                     const void* wd2t, const void* wg1t, const void* wg2t, const int* idx,
                     const float* m, const float* l, const float* out, const float* dout,
                     float* dq, float* stage, float* delta1,
                     int B, int N, int D, int k, int bf16, void* stream) {
  if (bad_shape(B, N, D, k) || (bf16 != 0 && bf16 != 1)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch_edge_width<__nv_bfloat16>(xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1,
                                                 wg2, bg2, wd2t, wg1t, wg2t, idx, m, l, out,
                                                 dout, dq, stage, delta1, B, N, D, k, s)
              : launch_edge_width<float>(xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2,
                                         bg2, wd2t, wg1t, wg2t, idx, m, l, out, dout, dq, stage,
                                         delta1, B, N, D, k, s);
}

// partial (splits, 3, D + 1, D) from the staged planes of `rows` rows.
int vecattn_bwd_wgrad(const float* stage, float* partial, int rows, int D, int splits, int bf16,
                      void* stream) {
  if (rows < kTileK || rows % kTileK != 0 || D < 128 || D > kMaxD || D % 128 != 0 || splits < 1 ||
      splits > 65535 || (bf16 != 0 && bf16 != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const int chunks = rows / kTileK;
  const int share = (chunks + splits - 1) / splits * kTileK;
  const dim3 grid((D / kTile) * (D / kTile), splits, 3);
  const auto kernel = bf16 ? vecattn_bwd_wgrad_kernel<true> : vecattn_bwd_wgrad_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kWgSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, kWgSmem, (cudaStream_t)stream>>>(stage, partial, rows, D, share,
                                                            (size_t)rows * D);
  return (int)cudaGetLastError();
}

// partial (splits, 4, D) from delta1 (rows, 4) and the staged dh_d (rows, D).
int vecattn_bwd_thin(const float* delta1, const float* dh_d, float* partial, int rows, int D,
                     int splits, int bf16, void* stream) {
  if (rows < 1 || D < 128 || D > kMaxD || D % 128 != 0 || splits < 1 ||
      (bf16 != 0 && bf16 != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const int share = (rows + splits - 1) / splits;
  const auto kernel = bf16 ? vecattn_bwd_thin_kernel<true> : vecattn_bwd_thin_kernel<false>;
  kernel<<<splits, D / 4, 0, (cudaStream_t)stream>>>(delta1, dh_d, partial, rows, D, share);
  return (int)cudaGetLastError();
}

// dkey, dval (B,N,D) f32 of the B clouds given, from idx (B,N,k) and the
// staged datt and dvpos (B·N·16, D).
int vecattn_bwd_scatter(const int* idx, const float* datt, const float* dvpos, float* dkey,
                        float* dval, int B, int N, int D, int k, int bf16, void* stream) {
  if (bad_shape(B, N, D, k) || (bf16 != 0 && bf16 != 1)) return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(int) * (size_t)N * k;
  if (bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  const auto kernel = bf16 ? vecattn_bwd_scatter_kernel<true> : vecattn_bwd_scatter_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kScatterWarps - 1) / kScatterWarps, B);
  kernel<<<grid, kScatterWarps * kWarp, bytes, (cudaStream_t)stream>>>(idx, datt, dvpos, dkey,
                                                                       dval, N, D, k);
  return (int)cudaGetLastError();
}

// wsum (3, D + 1, D) from wpart (wparts, 3, D + 1, D), and tsum (4, D) from
// tpart (tparts, 4, D).
int vecattn_bwd_reduce(const float* wpart, float* wsum, const float* tpart, float* tsum,
                       int D, int wparts, int tparts, void* stream) {
  if (D < 128 || D > kMaxD || D % 128 != 0 || wparts < 1 || tparts < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int count0 = 3 * (D + 1) * D, count1 = 4 * D;
  const dim3 grid((count0 + 255) / 256, 2);
  vecattn_bwd_reduce_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      wpart, wsum, count0, wparts, tpart, tsum, count1, tparts);
  return (int)cudaGetLastError();
}

const char* vecattn_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
