// EdgeConv forward: kNN selection, then neighbour gather and four reductions.
//
// Replaces the TPU kernel `_fwd_pallas` (sug_tpu/ops/edgeconv_pallas.py:498,
// kernel bodies `_fwd_kernel` :120 and `_fwd_kernel_batched` :219), which
// serves both `fused_edgeconv_reduce` (self-kNN, the four DGCNN EdgeConv
// blocks, k=20) and `fused_cross_edgeconv_reduce` (the SA-node's kNN-64
// re-query of S=64 offset nodes against the cloud).
//
// Contract, for each query s of cloud b:
//   d_j    = (-2 q_s·kv_j + |q_s|^2) + |kv_j|^2         (f32, j < N)
//   idx    = the k smallest d_j, ascending in (d, j): the lowest j wins a tie
//   a_j    = u[b, idx_j, :] + v[b, s, :]
//   amax, amin, s1, s2 = max, min, sum and sum of squares of a_j over j
// Inputs q (B,S,C), kv (B,N,C), u (B,N,F), v (B,S,F), all f32 contiguous (u
// bf16 with values_bf16, below);
// outputs amax/amin/s1/s2 (B,S,F) f32 and idx (B,S,k) int32. A +inf or NaN
// distance is never selected; a query with fewer than k finite distances
// gets N-1 in the slots left over, so idx stays in range.
//
// What bounds it on an H100. Bytes: q, kv, u and v read once, four (B,S,F)
// outputs and idx written once; at EdgeConv block 4 (B=64, S=N=1024, C=128,
// F=256, k=20, q is kv) that is ~441 MB, 0.13 ms at 3.35 TB/s. Operations: the
// f32 distances, 2·B·S·N·C = 17.2 GFLOP there, 0.26 ms at 67 TFLOP/s outside
// the tensor cores (275 GFLOP, 4.1 ms, at N=4096). So the distances bind
// wherever C is large; at C=3 (block 1, the SA-node) the selection's
// comparisons and the bytes do, and neither is in the bound's count.
//
// Design: two kernels on the caller's stream; no state per query grows with
// N, so the key count has no cap and shared memory is the same at any N.
// - select: a block owns kTQ=64 queries of one cloud and streams the cloud's
//   keys in tiles of kTK=64. The query tile stays in shared memory; each key
//   tile passes through it in chunks of up to 32 channels, double-buffered
//   with cp.async (the next chunk, or the next tile's first, loads while
//   this one is used), rows padded so that a quarter-warp's float4 loads hit
//   distinct banks. Each of the 256 threads computes a 4x4 register
//   micro-tile of the 64x64 distance tile (queries ty*4+i, keys tx+16*jj):
//   per 4 channels 8 float4 shared loads feed 64 FMAs. The dot adds channels
//   in ascending order with fmaf for every pair, |kv|^2 and |q|^2 likewise,
//   so exact duplicates tie exactly.
//   The tile goes to shared memory, and the warp whose threads computed a
//   query's row keeps that query's top-k: its best k pairs (d, j), sorted,
//   in shared memory (k <= 64: two words of a warp), and its bar, the k-th
//   pair, in a register of one lane. The warp tests the row's 64 entries
//   against the bar lexicographically (d < bar.d, or d == bar.d and
//   j < bar.j) and ballots the survivors. From kMergeFrom survivors (the
//   first tile, and a few after it) the warp sorts the tile (a bitonic
//   network over its 64 pairs, 2 a lane) and merges it into the list (the
//   elementwise minimum of the list and the reversed tile, then a bitonic
//   merge); below that it inserts each survivor at its rank, which a ballot
//   counts, the entries behind it shifting up a lane. Either way the list is
//   the k smallest pairs in (d, j) order whatever the order of arrival, the
//   lowest index first among equal distances. After the first tiles
//   survivors are rare (about k·ln(N/k) a query on a random cloud); on a
//   zero-padded cloud the 2048 copies of the origin tie, and the bar turns
//   away all but the k lowest-index ones.
// - gather: one thread per (b, s, f) reads idx (the select kernel's output),
//   forms a_j = u[b, idx_j, f] + v[b, s, f] (loads coalesce over f) and keeps
//   max, min, and the sum and sum of squares in j order, each product and add
//   rounded on its own, so a plain loop in j order repeats them bit for bit.
//   Splitting costs one idx round trip (B·S·k·4 bytes) and shows how the
//   forward's time divides between selection and gather.
// values_bf16 (the bf16 policy's mode, the TPU kernel's flag of that name):
// u arrives as bf16, rounded once by the caller, and the gather forms
// a_j = float(u_j) + v in f32, the TPU kernel's one-pass bf16 gather; the
// gather kernel is instantiated for each element type of u, so the f32
// instance is the same code as before, and u is read at 2 bytes an element.
// select is the same in both modes: neighbours are chosen in f32.
// The kernels allocate nothing and do not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kTQ = 64;                    // queries per select block
constexpr int kTK = 64;                    // keys per tile
constexpr int kThreads = 256;              // 16 x 16 threads, a 4x4 micro-tile each
constexpr int kQPW = kTQ / (kThreads / kWarp);  // queries per warp in the top-k: 8
constexpr int kMaxKC = 32;                 // key channels staged per chunk
constexpr int kDistStride = kTK + 4;       // the two half-warps' rows on other banks
constexpr int kMergeFrom = 12;             // survivors from which a tile is sorted and merged
constexpr int kGatherThreads = 256;
constexpr size_t kSmemLimit = 227 * 1024;  // what a block may take
// the launcher's limits, which ops/edgeconv.py checks before it launches
constexpr int kMaxK = 64;                  // two list words per lane
constexpr int kMaxC = 512;                 // a 64-query tile in shared memory

// Row stride in floats: a multiple of 4 (float4 loads) that is 4 mod 8, so
// the 8 lanes of a quarter-warp reading 8 rows hit distinct banks.
__host__ __device__ constexpr int padded_width(int C) {
  int cp = (C + 3) / 4 * 4;
  return (cp % 8 == 0) ? cp + 4 : cp;
}

struct SelectLayout {
  int kc;   // key channels per chunk: 4 or kMaxKC
  int kcp;  // key-chunk row stride
  int cq;   // query row stride: every chunk's channels, padded
};

SelectLayout select_layout(int C) {
  SelectLayout L;
  L.kc = C <= 4 ? 4 : kMaxKC;  // point coordinates, or features
  L.kcp = padded_width(L.kc);
  L.cq = padded_width((C + L.kc - 1) / L.kc * L.kc);
  return L;
}

// Dynamic shared memory of a select block: the query tile, two key chunks,
// the distance tile, the squared norms and the lists (kWarp * KH pairs a
// query).
size_t select_bytes(const SelectLayout& L, int KH) {
  return sizeof(float) * ((size_t)kTQ * L.cq + 2 * (size_t)kTK * L.kcp +
                          (size_t)kTQ * kDistStride + kTQ + kTK) +
         (sizeof(float) + sizeof(int)) * (size_t)kTQ * kWarp * KH;
}

// (d, j) strictly before (bd, bj): the lower distance, the lower index on a
// tie; false for a NaN d
__device__ __forceinline__ bool before(float d, int j, float bd, int bj) {
  return d < bd || (d == bd && j < bj);
}

// A warp's 64 pairs, position p in lane p % 32 of word p / 32: the
// compare-exchange of one bitonic step between each lane and lane ^ stride
// (stride < 32) in word h; the lower lane of a pair keeps the first pair if
// `up`, the upper one the second.
__device__ __forceinline__ void exchange(float& d, int& j, int stride, bool up, int lane) {
  const float od = __shfl_xor_sync(kFull, d, stride);
  const int oj = __shfl_xor_sync(kFull, j, stride);
  const bool lower = (lane & stride) == 0;
  if ((lower == up) == before(od, oj, d, j)) { d = od; j = oj; }
}

// Sorts a warp's 64 pairs ascending in (d, j) (a bitonic network: 21 steps,
// the one of stride 32 inside each lane).
__device__ __forceinline__ void sort64(float (&d)[2], int (&j)[2], int lane) {
#pragma unroll
  for (int size = 2; size <= 2 * kWarp; size <<= 1) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      if (stride == kWarp) {
        if (before(d[1], j[1], d[0], j[0])) {
          const float td = d[0]; d[0] = d[1]; d[1] = td;
          const int tj = j[0]; j[0] = j[1]; j[1] = tj;
        }
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = lane + kWarp * h;
          exchange(d[h], j[h], stride, (e & size) == 0, lane);
        }
      }
    }
  }
}

// The list `ld`/`lj` (positions p < k valid, sorted) becomes the k smallest
// pairs of itself and the 64 pairs `td`/`tj` (a key tile, any order): the
// tile is sorted, reversed against the list and the elementwise minimum
// (a bitonic sequence holding the 64 smallest of both) is merged.
template <int KH>
__device__ __forceinline__ void sort_merge(float (&ld)[KH], int (&lj)[KH], float (&td)[2],
                                           int (&tj)[2], int k, int lane) {
  sort64(td, tj, lane);
  float cd[2];
  int cj[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // the tile's position 63 - p: lane ^ 31 of the other word
    const float rd = __shfl_xor_sync(kFull, td[1 - h], kWarp - 1);
    const int rj = __shfl_xor_sync(kFull, tj[1 - h], kWarp - 1);
    const bool in_list = h < KH && lane + kWarp * h < k;
    const float ad = in_list ? ld[h < KH ? h : 0] : CUDART_INF_F;
    const int aj = in_list ? lj[h < KH ? h : 0] : -1;
    const bool take_list = before(ad, aj, rd, rj);
    cd[h] = take_list ? ad : rd;
    cj[h] = take_list ? aj : rj;
  }
  if (before(cd[1], cj[1], cd[0], cj[0])) {
    const float t = cd[0]; cd[0] = cd[1]; cd[1] = t;
    const int u = cj[0]; cj[0] = cj[1]; cj[1] = u;
  }
#pragma unroll
  for (int stride = kWarp / 2; stride > 0; stride >>= 1) {
#pragma unroll
    for (int h = 0; h < KH; ++h) exchange(cd[h], cj[h], stride, true, lane);
  }
#pragma unroll
  for (int h = 0; h < KH; ++h) { ld[h] = cd[h]; lj[h] = cj[h]; }
}

// Inserts (nd, nj) into the list at its rank, the count of entries before
// it: the entries from there on shift one position up and the k-th drops
// out. A pair that no longer beats the k-th has rank k and changes nothing.
template <int KH>
__device__ __forceinline__ void insert(float (&d)[KH], int (&j)[KH], float nd, int nj, int k,
                                       int lane) {
  int pos = 0;
#pragma unroll
  for (int h = 0; h < KH; ++h) {
    pos += __popc(__ballot_sync(kFull, lane + kWarp * h < k && before(d[h], j[h], nd, nj)));
  }
  float pd[KH];
  int pj[KH];
#pragma unroll
  for (int h = 0; h < KH; ++h) {
    pd[h] = __shfl_up_sync(kFull, d[h], 1);
    pj[h] = __shfl_up_sync(kFull, j[h], 1);
    if (h > 0) {  // lane 0 of a word takes the previous word's lane 31
      const float cd = __shfl_sync(kFull, d[h - 1], kWarp - 1);
      const int cj = __shfl_sync(kFull, j[h - 1], kWarp - 1);
      if (lane == 0) { pd[h] = cd; pj[h] = cj; }
    }
  }
#pragma unroll
  for (int h = 0; h < KH; ++h) {
    const int p = lane + kWarp * h;
    if (p < k && p > pos) { d[h] = pd[h]; j[h] = pj[h]; }
    else if (p < k && p == pos) { d[h] = nd; j[h] = nj; }
  }
}

// Copies 4 bytes from global to shared memory asynchronously; zero-fills
// where `valid` is false (nothing is read then).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

template <int KH, int kc>
__global__ void __launch_bounds__(kThreads, 3)
edgeconv_fwd_select_kernel(const float* __restrict__ q, const float* __restrict__ kv,
                           int* __restrict__ idx_out, int S, int N, int C, int k, int cq) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kcp = padded_width(kc);      // key-chunk row stride
  constexpr int kLP = kWarp * KH;            // list positions a query
  float* qs = smem;                          // [kTQ][cq] query coordinates
  float* ks = qs + (size_t)kTQ * cq;         // [2][kTK][kcp] key chunks, double-buffered
  float* dist = ks + 2 * (size_t)kTK * kcp;  // [kTQ][kDistStride] the distance tile
  float* qsq = dist + kTQ * kDistStride;     // [kTQ] |q|^2
  float* ksq = qsq + kTQ;                    // [kTK] |kv|^2 of the tile
  float* lsd = ksq + kTK;                    // [kTQ][kLP] each query's sorted list: d
  int* lsj = reinterpret_cast<int*>(lsd + kTQ * kLP);  // and j

  const int tid = threadIdx.x;
  const int lane = tid % kWarp, warp = tid / kWarp;
  const int tx = tid % 16, ty = tid / 16;    // keys tx+16*jj, queries ty*4+i
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * kTQ;
  const int nq = min(kTQ, S - s0);
  const float* qb = q + ((size_t)b * S + s0) * C;
  const float* kvb = kv + (size_t)b * N * C;
  const int nchunk = (C + kc - 1) / kc;
  const int nsteps = (N + kTK - 1) / kTK * nchunk;

  // step st: key tile st / nchunk, channel chunk st % nchunk, into buffer st % 2
  auto stage = [&](int st) {
    const int t0 = st / nchunk * kTK, c0 = st % nchunk * kc;
    const int nk = min(kTK, N - t0), cn = min(kc, C - c0);
    float* buf = ks + (st & 1) * kTK * kcp;
    for (int e = tid; e < kTK * kcp; e += kThreads) {
      const int r = e / kcp, c = e % kcp;
      const bool valid = r < nk && c < cn;
      cp_async4(buf + e, valid ? kvb + (size_t)(t0 + r) * C + c0 + c : kvb, valid);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  stage(0);

  for (int e = tid; e < kTQ * cq; e += kThreads) {
    const int r = e / cq, c = e % cq;
    qs[e] = (r < nq && c < C) ? qb[(size_t)r * C + c] : 0.0f;
  }
  // every list empty: the sentinel (+inf, -1), which lets no +inf or NaN in
  for (int e = tid; e < kTQ * kLP; e += kThreads) {
    lsd[e] = CUDART_INF_F;
    lsj[e] = -1;
  }
  __syncthreads();
  if (tid < kTQ) {
    float a = 0.0f;
    for (int c = 0; c < C; ++c) a = fmaf(qs[tid * cq + c], qs[tid * cq + c], a);
    qsq[tid] = a;
  }
  // lane i holds the bar (the k-th pair) of this warp's query i
  float bar_d = CUDART_INF_F;
  int bar_j = -1;
  const int kw = (k - 1) / kWarp, kl = (k - 1) % kWarp;  // the bar's word and lane

  float acc[4][4];
  for (int st = 0; st < nsteps; ++st) {
    const int t0 = st / nchunk * kTK, ch = st % nchunk;
    if (st + 1 < nsteps) stage(st + 1);
    else asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();  // step st's chunk is in shared memory
    const float* buf = ks + (st & 1) * kTK * kcp;
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.0f;
      }
    }
    if (tid < kTK) {
      float a = ch == 0 ? 0.0f : ksq[tid];
      const int cn = min(kc, C - ch * kc);
      for (int c = 0; c < cn; ++c) a = fmaf(buf[tid * kcp + c], buf[tid * kcp + c], a);
      ksq[tid] = a;
    }
    const float* qc = qs + ch * kc;
#pragma unroll
    for (int c4 = 0; c4 < kc; c4 += 4) {
      float4 kr[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        kr[jj] = *reinterpret_cast<const float4*>(buf + (tx + 16 * jj) * kcp + c4);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qr = *reinterpret_cast<const float4*>(qc + (ty * 4 + i) * cq + c4);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          acc[i][jj] = fmaf(qr.x, kr[jj].x, acc[i][jj]);
          acc[i][jj] = fmaf(qr.y, kr[jj].y, acc[i][jj]);
          acc[i][jj] = fmaf(qr.z, kr[jj].z, acc[i][jj]);
          acc[i][jj] = fmaf(qr.w, kr[jj].w, acc[i][jj]);
        }
      }
    }
    if (ch == nchunk - 1) {
      __syncthreads();  // the tile's |kv|^2 is complete
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qq = qsq[ty * 4 + i];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          dist[(ty * 4 + i) * kDistStride + tx + 16 * jj] =
              fmaf(-2.0f, acc[i][jj], qq) + ksq[tx + 16 * jj];
        }
      }
      __syncwarp();  // this warp wrote rows warp*kQPW .. +kQPW-1, the rows it reads
      const int nk = min(kTK, N - t0);
      for (int i = 0; i < kQPW; ++i) {
        const int row = warp * kQPW + i;
        if (row >= nq) break;
        const float bd = __shfl_sync(kFull, bar_d, i);
        const int bj = __shfl_sync(kFull, bar_j, i);
        float td[2];
        int tj[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          td[h] = dist[row * kDistStride + lane + kWarp * h];
          tj[h] = t0 + lane + kWarp * h;
        }
        const unsigned m0 = __ballot_sync(kFull, lane < nk && before(td[0], tj[0], bd, bj));
        const unsigned m1 =
            __ballot_sync(kFull, lane + kWarp < nk && before(td[1], tj[1], bd, bj));
        const int n = __popc(m0) + __popc(m1);
        if (n == 0) continue;
        float ld[KH];
        int lj[KH];
#pragma unroll
        for (int h = 0; h < KH; ++h) {
          ld[h] = lsd[row * kLP + lane + kWarp * h];
          lj[h] = lsj[row * kLP + lane + kWarp * h];
        }
        if (n >= kMergeFrom) {  // many survivors (the first tile): sort and merge
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // out of range, +inf and NaN: the sentinel
            if (!(lane + kWarp * h < nk && td[h] < CUDART_INF_F)) {
              td[h] = CUDART_INF_F;
              tj[h] = -1;
            }
          }
          sort_merge<KH>(ld, lj, td, tj, k, lane);
        } else {  // a few: insert each by rank, in ascending j
          unsigned m[2] = {m0, m1};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            while (m[h]) {
              const int src = __ffs(m[h]) - 1;
              m[h] &= m[h] - 1;
              insert<KH>(ld, lj, __shfl_sync(kFull, td[h], src), t0 + kWarp * h + src, k,
                         lane);
            }
          }
        }
#pragma unroll
        for (int h = 0; h < KH; ++h) {
          lsd[row * kLP + lane + kWarp * h] = ld[h];
          lsj[row * kLP + lane + kWarp * h] = lj[h];
        }
        const float nbd = __shfl_sync(kFull, kw == 0 ? ld[0] : ld[KH - 1], kl);
        const int nbj = __shfl_sync(kFull, kw == 0 ? lj[0] : lj[KH - 1], kl);
        if (lane == i) { bar_d = nbd; bar_j = nbj; }
      }
    }
    __syncthreads();  // buffer st % 2 has been read: step st + 2 may overwrite it
  }

  for (int i = 0; i < kQPW; ++i) {
    const int row = warp * kQPW + i;
    if (row >= nq) break;
    int* out = idx_out + ((size_t)b * S + s0 + row) * k;
    for (int p = lane; p < k; p += kWarp) {
      const int jj = lsj[row * kLP + p];
      out[p] = jj < 0 ? N - 1 : jj;
    }
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// T: the element type of u, float or (values_bf16) __nv_bfloat16
template <class T>
__global__ void __launch_bounds__(kGatherThreads)
edgeconv_fwd_gather_kernel(const int* __restrict__ idx, const T* __restrict__ u,
                           const float* __restrict__ v, float* __restrict__ amax,
                           float* __restrict__ amin, float* __restrict__ s1,
                           float* __restrict__ s2, int S, int N, int F, int k, size_t total) {
  const size_t e = (size_t)blockIdx.x * kGatherThreads + threadIdx.x;
  if (e >= total) return;
  const size_t row = e / F;                  // b * S + s
  const int f = (int)(e - row * F);
  const int* ir = idx + row * k;
  const T* ub = u + (row / S) * N * F + f;
  const float vf = v[e];
  float mx = -CUDART_INF_F, mn = CUDART_INF_F, sum = 0.0f, sq = 0.0f;
  for (int r = 0; r < k; ++r) {
    const float a = __fadd_rn(to_float(ub[(size_t)ir[r] * F]), vf);
    mx = fmaxf(mx, a);
    mn = fminf(mn, a);
    sum = __fadd_rn(sum, a);
    sq = __fadd_rn(sq, __fmul_rn(a, a));
  }
  amax[e] = mx;
  amin[e] = mn;
  s1[e] = sum;
  s2[e] = sq;
}

}  // namespace

extern "C" {

// Launches select, then gather, on `stream`. u is float, or __nv_bfloat16
// where values_bf16 is not 0. Returns a cudaError_t:
// cudaErrorInvalidValue when a shape is out of range (k above kMaxK, C above
// kMaxC, more than 65535 clouds); otherwise cudaGetLastError() after each
// launch.
int edgeconv_fwd(const float* q, const float* kv, const void* u, const float* v,
                 float* amax, float* amin, float* s1, float* s2, int* idx,
                 int B, int S, int N, int C, int F, int k, int values_bf16, void* stream) {
  if (B < 1 || S < 1 || N < 1 || C < 1 || F < 1 || k < 1 || k > N || k > kMaxK ||
      C > kMaxC || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const SelectLayout L = select_layout(C);
  const int KH = k <= kWarp ? 1 : 2;
  const size_t bytes = select_bytes(L, KH);
  if (bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  void (*select)(const float*, const float*, int*, int, int, int, int, int) =
      L.kc == 4 ? (KH == 1 ? edgeconv_fwd_select_kernel<1, 4> : edgeconv_fwd_select_kernel<2, 4>)
                : (KH == 1 ? edgeconv_fwd_select_kernel<1, kMaxKC>
                           : edgeconv_fwd_select_kernel<2, kMaxKC>);
  cudaError_t err = cudaFuncSetAttribute(
      select, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  select<<<dim3((S + kTQ - 1) / kTQ, B), kThreads, bytes, st>>>(q, kv, idx, S, N, C, k, L.cq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)B * S * F;
  const unsigned blocks = (unsigned)((total + kGatherThreads - 1) / kGatherThreads);
  if (values_bf16) {
    edgeconv_fwd_gather_kernel<__nv_bfloat16><<<blocks, kGatherThreads, 0, st>>>(
        idx, static_cast<const __nv_bfloat16*>(u), v, amax, amin, s1, s2, S, N, F, k, total);
  } else {
    edgeconv_fwd_gather_kernel<float><<<blocks, kGatherThreads, 0, st>>>(
        idx, static_cast<const float*>(u), v, amax, amin, s1, s2, S, N, F, k, total);
  }
  return (int)cudaGetLastError();
}

const char* edgeconv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
