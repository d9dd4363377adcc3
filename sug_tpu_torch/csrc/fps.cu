// Farthest point sampling: the whole npoint-step loop of a cloud in one
// launch, at every cloud size from 1 to 131072 points.
//
// Replaces the TPU kernel behind `fps_pallas` (sug_tpu/ops/pallas_kernels.py:151,
// its pallas_call :161, kernel body `_fps_kernel` :128). The JAX package runs
// that kernel from 4096 points and its `fori_loop` (one compiled program)
// below; the port runs this kernel at every size on the card.
//
// Contract, identical index for index to the plain loop (`fps_plain`):
//   dists[n] = 1e10 for every point; farthest = start[b]
//   for i < npoint:
//     out[b, i] = farthest
//     d[n] = (dx·dx + dy·dy) + dz·dz, d = xyz[b, n] - xyz[b, farthest], in f32
//     dists = min(dists, d)
//     farthest = the FIRST index of the largest dists (torch/jnp.argmax)
// Inputs xyz (B,N,3) f32 and start (B,) int64, contiguous; output (B,npoint)
// int64. Each start must lie in [0, N): the kernel checks it and stops with a
// device-side assert otherwise, as PyTorch's indexing kernels do, so the
// wrapper never reads the starts back to the host.
//
// Bit-exactness. nvcc contracts a*a + b into an FMA by default, which rounds
// once where the plain version rounds twice and so can move the arg-max on a
// near-tie; the distance is written with __fmul_rn / __fadd_rn / __fsub_rn,
// which are never contracted. The arg-max compares (value, index): a larger
// value wins, an equal one goes to the lower index, so the result is the
// first maximal index whatever order the threads reduce in. Distances are
// never negative, so their bits compare as ints in the order of the floats;
// a point past the cloud's end holds -1, below every real distance.
//
// What bounds it on an H100. Operations: per point and step 3 subtractions,
// 3 multiplies, 2 adds, a min and a compare, 10 in all; at B=64, N=4096,
// npoint=64 that is 0.17 GFLOP, 2.5 us at 67 TFLOP/s. Bytes: xyz read once,
// the indices written once. Neither binds: each step ends in an arg-max over
// the whole cloud whose result the next step needs, so the time is npoint
// dependent steps, each the instruction time of the team's share of points plus
// the latency of its reduction; at B=64 most of the card has nothing to do.
//
// Design. A cloud belongs to a team: W warps (W a power of two up to 32) in
// one block, or, with a thread-block cluster of C blocks, W warps in each of
// C blocks. Team thread t of block part r owns points r·T·P + t + j·T
// (T = 32·W threads, j < P, P a power of two and a template parameter).
// - State in registers: each thread keeps its points' coordinates and running
//   minima in registers (P up to 8 at 1024 threads, 16 at 512, 32 at 256).
//   Only a 1024-thread part with P = 16 (8193 to 16384 points a block) keeps
//   its coordinates in shared memory, written and read by the owning thread
//   alone: 16 points' state does not fit 64 registers.
// - A step: each thread updates its minima and keeps its first maximum with
//   its coordinates; the warp reduces (value, index) with two `redux.sync`
//   (max of the value bits, then min of the indices holding it). A one-warp
//   team is done: the winner sits on lane index % 32, which hands its
//   coordinates round with three shuffles. A larger team writes each warp's
//   candidate (value, index, coordinates) into a slot, in every block of
//   the cluster through distributed shared memory when C > 1; the slots are
//   double-buffered by step parity, so one barrier a step suffices (a named
//   barrier over the team's warps, or the cluster barrier); then every warp
//   reduces the slots the same way and reads the winner's coordinates from
//   its slot, whose position follows from the index.
// - Small clouds: a team of fewer than 4 warps shares a 4-warp block with
//   other clouds' teams (4 / W clouds a block), each with its own named
//   barrier. A block part holds at most 16384 points and a cluster at most
//   8 blocks, so N <= 131072.
// - The team. On the card a step across warps (slot stores, the barrier,
//   the second reduction) costs more than the distances of 16 to 32 points
//   a thread, and a cluster barrier more again (PERF.md §6). So the wrapper
//   (`fps_plan` in ops/geometry_kernels.py) gives a cloud of up to 1024
//   points one warp, up to 8192 one block of 8 warps, up to 65536 a cluster
//   of 8-warp blocks of 8192 points (32 a thread), and above that a cluster
//   of 1024-thread blocks of 16384 points.
// The kernel runs on the caller's stream, does not synchronise and
// allocates nothing.

#undef NDEBUG  // the start check is a device-side assert, in every build
#include <cassert>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 32;     // 1024 threads a block part
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr int kMaxSlots = kMaxCluster * kMaxWarps;
constexpr int kSmallTeamBlockWarps = 4;  // a block of teams below 4 warps
constexpr int kSmemP = 16;        // the points per thread kept in shared memory

template <int P, bool kSmem>
constexpr int max_threads() {
  return kSmem ? 1024 : (P <= 8 ? 1024 : (P == 16 ? 512 : 256));
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// every thread of every block of the cluster; orders the slot stores before
// it against the slot loads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// the slot at the same shared-memory offset in block `rank` of the cluster
__device__ __forceinline__ void store_remote(const int2* key_slot, const float4* xyz_slot,
                                             unsigned rank, int2 key, float4 c) {
  const uint32_t key_local = (uint32_t)__cvta_generic_to_shared(key_slot);
  const uint32_t xyz_local = (uint32_t)__cvta_generic_to_shared(xyz_slot);
  uint32_t key_remote, xyz_remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(key_remote) : "r"(key_local), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(xyz_remote) : "r"(xyz_local), "r"(rank));
  asm volatile("st.shared::cluster.v2.s32 [%0], {%1, %2};\n" ::"r"(key_remote), "r"(key.x),
               "r"(key.y) : "memory");
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(xyz_remote),
               "f"(c.x), "f"(c.y), "f"(c.z), "f"(c.w) : "memory");
}

template <int P, bool kSmem>
__global__ void __launch_bounds__(max_threads<P, kSmem>())
fps_kernel(const float* __restrict__ xyz, const long long* __restrict__ start,
           long long* __restrict__ out, int B, int N, int npoint, int warps, int cluster) {
  extern __shared__ float smem_xyz[];  // kSmem only: [3][T·P], thread t's point j at j·T + t
  // each warp's candidate of a step: (value bits, index) and coordinates,
  // by step parity
  __shared__ int2 slot_key[2][kMaxSlots];
  __shared__ float4 slot_xyz[2][kMaxSlots];

  const int T = warps * kWarp;
  const int team = threadIdx.x / T;  // the team's place in its block (cluster == 1)
  const int t = threadIdx.x % T;
  const int lane = threadIdx.x % kWarp;
  const int warp = t / kWarp;
  int b, rank = 0;
  if (cluster > 1) {
    b = blockIdx.x / cluster;
    rank = (int)cluster_rank();
  } else {
    b = blockIdx.x * (blockDim.x / T) + team;
  }
  if (b >= B) return;  // a whole team past the batch (cluster == 1 only)

  const int per_part = T * P;
  const int part_shift = __ffs(per_part) - 1;  // per_part and T are powers of two
  const int first = rank * per_part + t;       // this thread's point j = 0
  const int slot0 = cluster > 1 ? 0 : team * warps;
  const int nslots = cluster * warps;
  const float* xb = xyz + (size_t)b * N * 3;
  long long* ob = out + (size_t)b * npoint;

  float px[kSmem ? 1 : P], py[kSmem ? 1 : P], pz[kSmem ? 1 : P], dist[P];
  float* sx = smem_xyz;
  float* sy = smem_xyz + per_part;
  float* sz = smem_xyz + 2 * per_part;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int p = first + j * T;
    const bool valid = p < N;
    const float x = valid ? xb[3 * p] : 0.0f;
    const float y = valid ? xb[3 * p + 1] : 0.0f;
    const float z = valid ? xb[3 * p + 2] : 0.0f;
    if constexpr (kSmem) {
      sx[j * T + t] = x;
      sy[j * T + t] = y;
      sz[j * T + t] = z;
    } else {
      px[j] = x;
      py[j] = y;
      pz[j] = z;
    }
    dist[j] = valid ? 1e10f : -1.0f;  // -1: never the maximum
  }

  const long long s = start[b];
  assert(s >= 0 && s < N && "fps: start index out of [0, N)");
  int far = (int)s;
  float cx = xb[3 * far], cy = xb[3 * far + 1], cz = xb[3 * far + 2];
  // every block of the cluster runs before any block stores into another
  if (cluster > 1) cluster_sync();

  const bool leader = rank == 0 && t == 0;
  for (int i = 0;; ++i) {
    if (leader) ob[i] = far;
    if (i + 1 == npoint) break;

    // this thread's first maximum, ascending j: a strict > keeps the first
    float bv = -1.0f, bx = 0.0f, by = 0.0f, bz = 0.0f;
    int bj = -1;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      float x, y, z;
      if constexpr (kSmem) {
        x = sx[j * T + t];
        y = sy[j * T + t];
        z = sz[j * T + t];
      } else {
        x = px[j];
        y = py[j];
        z = pz[j];
      }
      const float dx = __fsub_rn(x, cx);
      const float dy = __fsub_rn(y, cy);
      const float dz = __fsub_rn(z, cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      dist[j] = fminf(dist[j], d);
      if (dist[j] > bv) {
        bv = dist[j];
        bj = j;
        bx = x;
        by = y;
        bz = z;
      }
    }
    const int bi = bj < 0 ? INT_MAX : first + bj * T;
    // the warp's (value, index) maximum; a warp with no point gives (-1, INT_MAX)
    const int vw = __reduce_max_sync(kFull, __float_as_int(bv));
    const int iw = __reduce_min_sync(kFull, __float_as_int(bv) == vw ? bi : INT_MAX);

    if (nslots == 1) {  // a one-warp team: point p lives on lane p % 32
      far = iw;
      cx = __shfl_sync(kFull, bx, far & (kWarp - 1));
      cy = __shfl_sync(kFull, by, far & (kWarp - 1));
      cz = __shfl_sync(kFull, bz, far & (kWarp - 1));
      continue;
    }
    const int par = i & 1;
    const int mine = slot0 + rank * warps + warp;
    if (lane == (iw & (kWarp - 1))) {  // the owner (lane 31 for an empty warp)
      const int2 key = make_int2(vw, iw);
      const float4 c = make_float4(bx, by, bz, 0.0f);
      if (cluster > 1) {
        for (int r = 0; r < cluster; ++r) {
          store_remote(&slot_key[par][mine], &slot_xyz[par][mine], (unsigned)r, key, c);
        }
      } else {
        slot_key[par][mine] = key;
        slot_xyz[par][mine] = c;
      }
    }
    __syncwarp();
    // Step i writes the slots of parity i & 1 and reads them after this
    // barrier; a thread writes them again at step i + 2, only after the
    // barrier of step i + 1, which every thread reaches after its reads.
    if (cluster > 1) {
      cluster_sync();
    } else {
      named_barrier(1 + team, T);
    }
    int rv = __float_as_int(-1.0f), ri = INT_MAX;
    for (int k = lane; k < nslots; k += kWarp) {
      const int2 key = slot_key[par][slot0 + k];
      if (key.x > rv || (key.x == rv && key.y < ri)) {
        rv = key.x;
        ri = key.y;
      }
    }
    const int v = __reduce_max_sync(kFull, rv);
    far = __reduce_min_sync(kFull, rv == v ? ri : INT_MAX);
    // the winner's slot: its block part, then its warp in the part
    const int won = slot0 + (far >> part_shift) * warps + ((far & (T - 1)) >> 5);
    const float4 c = slot_xyz[par][won];
    cx = c.x;
    cy = c.y;
    cz = c.z;
  }
}

template <int P, bool kSmem>
cudaError_t launch(const float* xyz, const long long* start, long long* out, int B, int N,
                   int npoint, int warps, int cluster, cudaStream_t stream) {
  const int T = warps * kWarp;
  const int teams = (cluster == 1 && warps < kSmallTeamBlockWarps) ? kSmallTeamBlockWarps / warps
                                                                    : 1;
  const int threads = T * teams;
  if (threads > max_threads<P, kSmem>()) return cudaErrorInvalidValue;
  const size_t smem = kSmem ? sizeof(float) * 3 * (size_t)T * P : 0;
  if (kSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        fps_kernel<P, kSmem>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  if (cluster == 1) {
    const int blocks = (B + teams - 1) / teams;
    fps_kernel<P, kSmem><<<blocks, threads, smem, stream>>>(xyz, start, out, B, N, npoint, warps,
                                                            cluster);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * cluster));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, fps_kernel<P, kSmem>, xyz, start, out, B, N, npoint,
                                       warps, cluster);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` for a team of `warps` warps (1, 2, 4, ...,
// 32) in each of `cluster` blocks (1 to 8) per cloud. Returns a cudaError_t:
// cudaErrorInvalidValue for sizes or a team out of range (a block part of
// more than 16384 points, so N above 131072, included), otherwise the
// attribute call's error or the launch's.
int fps(const float* xyz, const long long* start, long long* out, int B, int N, int npoint,
        int warps, int cluster, void* stream) {
  if (B < 1 || N < 1 || npoint < 1 || B > INT_MAX / kMaxCluster) {
    return (int)cudaErrorInvalidValue;
  }
  if (warps < 1 || warps > kMaxWarps || (warps & (warps - 1)) != 0 || cluster < 1 ||
      cluster > kMaxCluster) {
    return (int)cudaErrorInvalidValue;
  }
  const int T = warps * kWarp;
  const int per_part = (N + cluster - 1) / cluster;
  if (per_part > 32 * T) return (int)cudaErrorInvalidValue;
  int P = 1;
  while (P * T < per_part) P *= 2;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (P) {
    case 1: return (int)launch<1, false>(xyz, start, out, B, N, npoint, warps, cluster, st);
    case 2: return (int)launch<2, false>(xyz, start, out, B, N, npoint, warps, cluster, st);
    case 4: return (int)launch<4, false>(xyz, start, out, B, N, npoint, warps, cluster, st);
    case 8: return (int)launch<8, false>(xyz, start, out, B, N, npoint, warps, cluster, st);
    case 16:
      if (T > max_threads<16, false>()) {
        return (int)launch<kSmemP, true>(xyz, start, out, B, N, npoint, warps, cluster, st);
      }
      return (int)launch<16, false>(xyz, start, out, B, N, npoint, warps, cluster, st);
    case 32: return (int)launch<32, false>(xyz, start, out, B, N, npoint, warps, cluster, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* fps_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
