// EdgeConv backward: replay of the edge activations, first-hit routing of
// the max/min cotangents, and a deterministic key-major sum into dU.
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
// Inputs idx (B,S,k) int32 with entries in [0, N); u (B,N,F); v, amax, amin,
// damax, damin, ds1, ds2 (B,S,F), all f32 contiguous.
// values_bf16 (the bf16 policy's mode, as in the forward): u is bf16, a_j is
// float(u) + v, dv sums the unrounded da_j, and du sums da_j rounded to bf16
// (round to nearest even), in f32, as the TPU kernel's one-pass bf16 dU
// product does (edgeconv_pallas.py:351-355). rows and keys are instantiated
// for each element type of u; csr does not read u. Outputs du (B,N,F) and
// dv (B,S,F) f32; every element of both is written, so the caller need not
// zero them. Scratch, allocated by the caller: offsets (B,N+1) and edges
// (B,S*k) int32, jmax and jmin (B,S,F) uint8.
//
// What bounds it on an H100. Bytes: idx, u and the seven (B,S,F) inputs read
// once, du and dv written once; at EdgeConv block 4 (B=64, S=N=1024, F=256,
// k=20) that is ~676 MB, 0.20 ms at 3.35 TB/s. Operations: about 8 f32 ops
// per edge and channel, 2.7 GFLOP there, 0.04 ms at 67 TFLOP/s. So the call
// is bound by HBM bytes.
//
// Design: three kernels on the caller's stream, none holding a dU tile,
// none using a float atomic, with no key tile: at any N, csr reads idx three
// times and rows and keys visit each edge once.
// - csr: one block per cloud builds the key lists. A shared histogram of the
//   N keys (integer atomics: a count does not depend on order) and a block
//   scan give the offsets. Then the entries e = s*k + j are cut into up to
//   32 contiguous segments, one per warp; each warp walks its segment in
//   ascending e, 32 entries at a time, counting each key (uint16 counts in
//   shared memory); a pass over the keys turns the counts into each
//   segment's first slot after the earlier segments' entries; and each warp
//   walks its segment again, placing: __match_any_sync gives each lane its
//   rank among the lanes of its key, and the group's leader advances that
//   key's slot. So each key's list is in ascending e, the same arrays every
//   launch. Where two segments' counts do not fit beside the N-int cursor
//   (N above about 29000) or a key has more than 65535 entries, one warp
//   walks every entry with the cursor alone. The cursor bounds N at
//   kMaxKeys; the forward has no key cap, so above it the backward refuses.
// - rows: one thread per (b, s, f) replays a_j over j in order, writes dv as
//   the sum of da_j in j order from 0, and the first j that hits amax (amin)
//   as jmax (jmin), or k where none does (a NaN row, or a max taken
//   elsewhere). The gathered u rows are F*4 contiguous bytes: loads coalesce
//   over f.
// - keys: one thread per (b, n, f) walks key n's list, forms a = u[n] + v[s]
//   (the key's own u, no gather), da with the selections j == jmax[s] and
//   j == jmin[s], and sums in list order from 0, writing du for every key (0
//   for a key no query chose). Per entry and channel it reads v, ds1, ds2
//   and the two uint8 (14 bytes, damax/damin only where selected), from L2
//   while one cloud's rows are live.
// Every grid is full: a thread per output element, as many warps as the SM
// takes, in place of one warp per SM; no shared read-modify-write chain.
// Since the lists are in ascending e, du adds each key's terms in (s, j)
// order from 0.0f and dv each query's in j order, as the earlier one-pass
// kernel that walked the entries in order did: both are bit for bit what it
// gave, and every launch gives the same bits.
// A zero-padded cloud makes hub keys: every padded query's k nearest keys
// are the same k lowest-index padded points, so a few keys hold thousands of
// entries; their threads walk long lists while the rest of the grid runs on.
// The kernels allocate nothing and do not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kCsrThreads = 1024;
constexpr int kThreads = 256;           // rows and keys kernels
constexpr int kBatch = 8;               // chunks of 32 entries loaded ahead by the csr walk
constexpr int kSmemBytes = 227 * 1024 - 256;  // dynamic shared memory of a csr block
// the launcher's limits, which ops/edgeconv.py checks before it launches
constexpr int kMaxKeys = 56 * 1024;     // a 224 KB cursor
constexpr int kMaxK = 255;              // jmax and jmin are uint8, k meaning "no hit"

// The max/min cotangent on the selected entries plus the sum terms, in the
// Pallas kernel's order: damax*selmax + damin*selmin + ds1 + 2*a*ds2. Each
// operation rounds on its own (__fadd_rn, __fmul_rn are never contracted).
__device__ __forceinline__ float edge_cotangent(float a, float gmax, float gmin, float g1,
                                                float g2) {
  return __fadd_rn(__fadd_rn(__fadd_rn(gmax, gmin), g1), __fmul_rn(__fmul_rn(2.0f, a), g2));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// A term of du: da itself, or (values_bf16) da rounded to bf16.
__device__ __forceinline__ float du_term(float da, const float*) { return da; }
__device__ __forceinline__ float du_term(float da, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(da));
}

// The ints that n_seg uint16 counts of N keys take.
__host__ __device__ __forceinline__ int seg_words(int n_seg, int N) {
  return (int)(((long long)n_seg * N + 1) / 2);
}

// Walks the entries [e0, e1) of a cloud in ascending e, 32 at a time, with
// kBatch chunks of ids in flight ahead of the chunk being visited. For each
// chunk every lane calls group(n, e, peers, rank): n its key (-1 past e1),
// peers the lanes of the chunk with the same key, rank its place among them.
template <class Group>
__device__ __forceinline__ void walk_entries(const int* __restrict__ idx_b, int e0, int e1,
                                             int lane, Group group) {
  int cur[kBatch], nxt[kBatch];
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    const int e = e0 + i * kWarp + lane;
    cur[i] = e < e1 ? idx_b[e] : -1;
  }
  for (int base = e0; base < e1; base += kBatch * kWarp) {
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = base + (kBatch + i) * kWarp + lane;
      nxt[i] = e < e1 ? idx_b[e] : -1;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (base + i * kWarp >= e1) break;  // uniform across the warp
      const unsigned peers = __match_any_sync(kFull, cur[i]);
      group(cur[i], base + i * kWarp + lane, peers, __popc(peers & ((1u << lane) - 1u)));
      __syncwarp();  // this chunk's shared writes before the next chunk's reads
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) cur[i] = nxt[i];
  }
}

// Key n's group in a chunk takes the next popc(peers) slots of its list:
// the group's leader reads and advances slot[n], the others get it by
// shuffle; each lane writes its entry at base[n] + slot + rank.
template <class Slot>
__device__ __forceinline__ void place(int n, int e, unsigned peers, int rank, Slot* slot,
                                      const int* base, int* __restrict__ edges_b) {
  const int leader = __ffs(peers) - 1;
  int p = 0;
  if (rank == 0 && n >= 0) {
    p = slot[n];
    slot[n] = (Slot)(p + __popc(peers));
  }
  p = __shfl_sync(kFull, p, leader);
  if (n >= 0) edges_b[(base ? base[n] : 0) + p + rank] = e;
}

__global__ void __launch_bounds__(kCsrThreads)
edgeconv_bwd_csr_kernel(const int* __restrict__ idx, int* __restrict__ offsets,
                        int* __restrict__ edges, int S, int N, int k, int n_seg) {
  // cursor [N]: counts, then offsets; seg [n_seg][N] (when n_seg > 1): each
  // segment's count of each key, then its first slot in the key's list
  extern __shared__ int cursor[];
  uint16_t* seg = reinterpret_cast<uint16_t*>(cursor + N);
  __shared__ int warp_total[kCsrThreads / kWarp];
  const int t = threadIdx.x, lane = t % kWarp, warp = t / kWarp;
  const int E = S * k;
  const int* idx_b = idx + (size_t)blockIdx.x * E;
  int* off_b = offsets + (size_t)blockIdx.x * (N + 1);
  int* edges_b = edges + (size_t)blockIdx.x * E;

  for (int n = t; n < N; n += kCsrThreads) cursor[n] = 0;
  if (n_seg > 1) {
    for (int i = t; i < seg_words(n_seg, N); i += kCsrThreads) cursor[N + i] = 0;
  }
  __syncthreads();
  for (int e = t; e < E; e += kCsrThreads) atomicAdd(&cursor[idx_b[e]], 1);
  __syncthreads();

  // exclusive scan of the counts: thread t owns keys [lo, hi)
  const int per = (N + kCsrThreads - 1) / kCsrThreads;
  const int lo = min(N, t * per), hi = min(N, lo + per);
  int own = 0;
  bool wide = false;  // a key whose count a uint16 segment slot cannot hold
  for (int n = lo; n < hi; ++n) {
    own += cursor[n];
    wide |= cursor[n] > 0xffff;
  }
  int incl = own;
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == kWarp - 1) warp_total[warp] = incl;
  wide = __syncthreads_or(wide);
  if (warp == 0) {
    const int w = warp_total[lane];
    int wi = w;
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const int y = __shfl_up_sync(kFull, wi, d);
      if (lane >= d) wi += y;
    }
    warp_total[lane] = wi - w;
  }
  __syncthreads();
  int run = warp_total[warp] + incl - own;
  for (int n = lo; n < hi; ++n) {
    const int c = cursor[n];
    cursor[n] = run;
    off_b[n] = run;
    run += c;
  }
  if (t == 0) off_b[N] = E;
  __syncthreads();

  if (n_seg == 1 || wide) {
    // one warp walks every entry; cursor[n] is key n's next slot
    if (warp == 0) {
      walk_entries(idx_b, 0, E, lane, [&](int n, int e, unsigned peers, int rank) {
        place(n, e, peers, rank, cursor, static_cast<const int*>(nullptr), edges_b);
      });
    }
    return;
  }
  // warp w < n_seg owns the entries [w * len, (w + 1) * len): it counts each
  // key there, a pass over the keys turns the counts into each segment's
  // first slot after the earlier segments' entries, and each warp then
  // places its own entries in order
  const int len = (E + n_seg - 1) / n_seg;
  const int e0 = min(E, warp * len), e1 = min(E, e0 + len);
  uint16_t* my_seg = seg + (size_t)warp * N;
  if (warp < n_seg) {
    walk_entries(idx_b, e0, e1, lane, [&](int n, int, unsigned peers, int rank) {
      if (rank == 0 && n >= 0) my_seg[n] = (uint16_t)(my_seg[n] + __popc(peers));
    });
  }
  __syncthreads();
  for (int n = t; n < N; n += kCsrThreads) {
    int before = 0;
    for (int w = 0; w < n_seg; ++w) {
      const int c = seg[(size_t)w * N + n];
      seg[(size_t)w * N + n] = (uint16_t)before;
      before += c;
    }
  }
  __syncthreads();
  if (warp < n_seg) {
    walk_entries(idx_b, e0, e1, lane, [&](int n, int e, unsigned peers, int rank) {
      place(n, e, peers, rank, my_seg, static_cast<const int*>(cursor), edges_b);
    });
  }
}

// T: the element type of u, float or (values_bf16) __nv_bfloat16
template <class T>
__global__ void __launch_bounds__(kThreads)
edgeconv_bwd_rows_kernel(const int* __restrict__ idx, const T* __restrict__ u,
                         const float* __restrict__ v, const float* __restrict__ amax,
                         const float* __restrict__ amin, const float* __restrict__ damax,
                         const float* __restrict__ damin, const float* __restrict__ ds1,
                         const float* __restrict__ ds2, float* __restrict__ dv,
                         uint8_t* __restrict__ jmax, uint8_t* __restrict__ jmin, int S, int N,
                         int F, int k) {
  const int g = blockIdx.x * kThreads + threadIdx.x;  // s * F + f within cloud b
  if (g >= S * F) return;
  const int b = blockIdx.y;
  const int s = g / F, f = g - s * F;
  const size_t r = (size_t)b * S * F + g;
  const int* ids = idx + ((size_t)b * S + s) * k;
  const T* u_b = u + (size_t)b * N * F + f;
  const float vv = v[r], mx = amax[r], mn = amin[r];
  const float gmax = damax[r], gmin = damin[r], g1 = ds1[r], g2 = ds2[r];
  int jmx = k, jmn = k;
  float dvs = 0.0f;
#pragma unroll 4
  for (int j = 0; j < k; ++j) {
    // the same single f32 add as the forward
    const float a = __fadd_rn(to_float(u_b[(size_t)ids[j] * F]), vv);
    const bool sel_max = jmx == k && a == mx;
    const bool sel_min = jmn == k && a == mn;
    if (sel_max) jmx = j;
    if (sel_min) jmn = j;
    dvs = __fadd_rn(dvs, edge_cotangent(a, sel_max ? gmax : 0.0f, sel_min ? gmin : 0.0f, g1, g2));
  }
  dv[r] = dvs;
  jmax[r] = (uint8_t)jmx;
  jmin[r] = (uint8_t)jmn;
}

template <class T>
__global__ void __launch_bounds__(kThreads)
edgeconv_bwd_keys_kernel(const int* __restrict__ offsets, const int* __restrict__ edges,
                         const T* __restrict__ u, const float* __restrict__ v,
                         const uint8_t* __restrict__ jmax, const uint8_t* __restrict__ jmin,
                         const float* __restrict__ damax, const float* __restrict__ damin,
                         const float* __restrict__ ds1, const float* __restrict__ ds2,
                         float* __restrict__ du, int S, int N, int F, int k) {
  const int g = blockIdx.x * kThreads + threadIdx.x;  // n * F + f within cloud b
  if (g >= N * F) return;
  const int b = blockIdx.y;
  const int n = g / F, f = g - n * F;
  const int* off_b = offsets + (size_t)b * (N + 1);
  const int* edges_b = edges + (size_t)b * S * k;
  const size_t row0 = (size_t)b * S * F + f;
  const size_t out = (size_t)b * N * F + g;
  const float un = to_float(u[out]);
  const int end = off_b[n + 1];
  float acc = 0.0f;
#pragma unroll 4
  for (int p = off_b[n]; p < end; ++p) {
    const int e = edges_b[p];
    const int s = e / k, j = e - s * k;
    const size_t r = row0 + (size_t)s * F;
    const float a = __fadd_rn(un, v[r]);
    const float gmax = j == jmax[r] ? damax[r] : 0.0f;
    const float gmin = j == jmin[r] ? damin[r] : 0.0f;
    acc = __fadd_rn(acc, du_term(edge_cotangent(a, gmax, gmin, ds1[r], ds2[r]), u));
  }
  du[out] = acc;
}

// The csr kernel's segments: as many warps (up to the block's 32) as have a
// uint16 count of every key beside the N-int cursor in shared memory.
int csr_segments(int N) {
  const long long fit = ((long long)kSmemBytes - (long long)sizeof(int) * (N + 1)) /
                        ((long long)sizeof(uint16_t) * N);
  return (int)(fit < 1 ? 1 : fit > kCsrThreads / kWarp ? kCsrThreads / kWarp : fit);
}

// rows, then keys, for u of element type T.
template <class T>
cudaError_t rows_and_keys(const int* idx, const T* u, const float* v, const float* amax,
                          const float* amin, const float* damax, const float* damin,
                          const float* ds1, const float* ds2, float* du, float* dv,
                          const int* offsets, const int* edges, uint8_t* jmax, uint8_t* jmin,
                          int B, int S, int N, int F, int k, cudaStream_t st) {
  const dim3 rows_grid((S * F + kThreads - 1) / kThreads, B);
  edgeconv_bwd_rows_kernel<T><<<rows_grid, kThreads, 0, st>>>(
      idx, u, v, amax, amin, damax, damin, ds1, ds2, dv, jmax, jmin, S, N, F, k);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 keys_grid((N * F + kThreads - 1) / kThreads, B);
  edgeconv_bwd_keys_kernel<T><<<keys_grid, kThreads, 0, st>>>(
      offsets, edges, u, v, jmax, jmin, damax, damin, ds1, ds2, du, S, N, F, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the three kernels in turn on `stream`. u is float, or
// __nv_bfloat16 where values_bf16 is not 0. Returns a cudaError_t:
// cudaErrorInvalidValue when the shapes are out of range (k above 255 or N
// above kMaxKeys among them), otherwise the first error of the launches.
int edgeconv_bwd(const int* idx, const void* u, const float* v, const float* amax,
                 const float* amin, const float* damax, const float* damin,
                 const float* ds1, const float* ds2, float* du, float* dv, int* offsets,
                 int* edges, uint8_t* jmax, uint8_t* jmin, int B, int S, int N, int F, int k,
                 int values_bf16, void* stream) {
  if (B < 1 || S < 1 || N < 1 || F < 1 || k < 1 || k > N || B > 65535 || k > kMaxK ||
      N > kMaxKeys || (long long)S * k > INT32_MAX || (long long)S * F > INT32_MAX ||
      (long long)N * F > INT32_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int n_seg = csr_segments(N);
  const size_t smem = sizeof(int) * ((size_t)N + (n_seg > 1 ? seg_words(n_seg, N) : 0));
  cudaError_t err = cudaFuncSetAttribute(
      edgeconv_bwd_csr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  edgeconv_bwd_csr_kernel<<<B, kCsrThreads, smem, st>>>(idx, offsets, edges, S, N, k, n_seg);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (values_bf16) {
    return (int)rows_and_keys(idx, static_cast<const __nv_bfloat16*>(u), v, amax, amin, damax,
                              damin, ds1, ds2, du, dv, offsets, edges, jmax, jmin, B, S, N, F, k,
                              st);
  }
  return (int)rows_and_keys(idx, static_cast<const float*>(u), v, amax, amin, damax, damin, ds1,
                            ds2, du, dv, offsets, edges, jmax, jmin, B, S, N, F, k, st);
}

const char* edgeconv_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
