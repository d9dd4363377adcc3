"""Large-N geometry: the CUDA kernels, their plain versions, and the wrappers
that dispatch between them. The counterpart of ``sug_tpu/ops/pallas_kernels.py``.

- ``min_dists(query, source)``: each query point's smallest squared distance
  to the source cloud, without the (B, N, M) matrix; ``chamfer_tiled`` takes
  one per direction, as ``chamfer_pallas`` does. The kernel
  (``csrc/chamfer_min.cu``) replaces ``_min_dists_tiled``, and masks both
  ragged edges, which the TPU kernel does not (ROADMAP.md §3).
- ``fps(xyz, npoint, start_idx)``: farthest point sampling, the whole loop of
  a cloud in one launch (``csrc/fps.cu``) at any N up to 131072, replacing
  ``fps_pallas``; its indices are identical to ``fps_plain``'s. ``fps_plan``
  picks the kernel's team of threads for a cloud size.

``geometry.chamfer_distance`` routes here above 2048 points, as the JAX
package does; ``geometry.farthest_point_sample`` at every size. On a CPU
tensor each wrapper runs its plain version, in f32 or f64; on a CUDA tensor
it launches its kernel (f32 only) or raises. Neither op has a gradient, as
in the JAX package: the clouds are data and indices are not differentiable,
so ``min_dists`` raises on an input that requires grad.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from sug_tpu_torch.ops import cuda_build
from sug_tpu_torch.ops.geometry import index_points, square_distance


def _check_cloud(op: str, name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.dtype != torch.float32 and not (t.dtype == torch.float64 and t.device.type == "cpu"):
        raise TypeError(f"{op}: {name} must be float32 (or float64 on the CPU), got {t.dtype}")
    if t.dim() != 3 or t.shape[-1] != 3 or t.shape[1] < 1:
        raise ValueError(f"{op}: {name} must be (B, N, 3) with N >= 1, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{op}: {name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{op}: {name} is on {t.device}, expected {device}")


# ---------------------------------------------------------------------------
# min-dists and the tiled chamfer
# ---------------------------------------------------------------------------


def min_dists_plain(query: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``(B, N, 3), (B, M, 3) -> (B, N)``, the min
    over sources of ``square_distance``'s ``-2·q·s + |q|² + |s|²``, in its
    summation order and without a clamp. Materialises (B, N, M)."""
    return torch.amin(square_distance(query, source), dim=2)


def _launch_min_dists(query: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    lib = cuda_build.library("chamfer_min", "min_dists_error_string", 3, 3, launcher="min_dists")
    B, N, _ = query.shape
    M = source.shape[1]
    out = torch.empty((B, N), dtype=torch.float32, device=query.device)
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        err = lib.min_dists(query.data_ptr(), source.data_ptr(), out.data_ptr(), B, N, M, stream)
    if err != 0:
        raise RuntimeError(f"min_dists launch failed: {lib.min_dists_error_string(err).decode()} "
                           f"(B={B}, N={N}, M={M})")
    min_dists.launches += 1
    return out


def min_dists(query: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """Each query point's smallest squared distance to ``source``:
    ``(B, N, 3), (B, M, 3) -> (B, N)`` in the inputs' type, for any N, M >= 1.

    CPU tensors go to the plain version, CUDA tensors to the kernel; a build
    or launch failure raises, and so does an input that requires grad (the op
    has no gradient). ``min_dists.launches`` counts kernel launches.
    """
    _check_cloud("min_dists", "query", query, query.device)
    _check_cloud("min_dists", "source", source, query.device)
    if source.shape[0] != query.shape[0]:
        raise ValueError(f"min_dists: batch sizes differ, {query.shape[0]} and {source.shape[0]}")
    if source.dtype != query.dtype:
        raise TypeError(f"min_dists: query is {query.dtype}, source {source.dtype}")
    if query.requires_grad or source.requires_grad:
        raise ValueError("min_dists: an input requires grad, but the op has no gradient "
                         "(the chamfer SDA weights are computed from the raw clouds)")
    if query.device.type == "cpu":
        return min_dists_plain(query, source)
    if query.device.type != "cuda":
        raise ValueError(f"min_dists: no path for device {query.device}")
    return _launch_min_dists(query, source)


min_dists.launches = 0


def chamfer_tiled(pc1: torch.Tensor, pc2: torch.Tensor, per_sample: bool = True) -> torch.Tensor:
    """Bidirectional chamfer distance from two ``min_dists`` calls, the
    counterpart of ``chamfer_pallas``: (B,) ``mean_n min_m d + mean_m min_n
    d``, or its mean over the batch. The means are taken outside the kernel,
    as the JAX op takes them outside its ``pallas_call``."""
    per = torch.mean(min_dists(pc1, pc2), dim=1) + torch.mean(min_dists(pc2, pc1), dim=1)
    return per if per_sample else torch.mean(per)


# ---------------------------------------------------------------------------
# farthest point sampling
# ---------------------------------------------------------------------------


def _starts(xyz: torch.Tensor, start_idx: Optional[torch.Tensor]) -> torch.Tensor:
    if start_idx is None:
        return torch.zeros(xyz.shape[0], dtype=torch.long, device=xyz.device)
    return start_idx.to(device=xyz.device, dtype=torch.long)


def fps_plain(xyz: torch.Tensor, npoint: int,
              start_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain loop ``(B, N, 3) -> (B, npoint)`` int64, starting at
    ``start_idx`` (B,) of each cloud, or at index 0 when it is None.

    The squared distance is summed as ``(dx·dx + dy·dy) + dz·dz``, written
    out: that is ``torch.sum``'s order over three terms on the CPU and the
    JAX loop's, but not ``torch.sum``'s on the card, and the kernel repeats
    it bit for bit. The indices are stacked once at the end, so a step
    launches as many kernels as one with ``torch.sum`` and an indexed store
    would. ``torch.argmax`` returns the first maximal index, as
    ``jnp.argmax`` does. The distances are kept in the cloud's type."""
    B, N, _ = xyz.shape
    farthest = _starts(xyz, start_idx)
    dists = torch.full((B, N), 1e10, dtype=xyz.dtype, device=xyz.device)
    centroids = []
    for _ in range(npoint):
        centroids.append(farthest)
        sq = (xyz - index_points(xyz, farthest[:, None])) ** 2  # (B, N, 3)
        dists = torch.minimum(dists, (sq[..., 0] + sq[..., 1]) + sq[..., 2])
        farthest = torch.argmax(dists, dim=-1)
    return torch.stack(centroids, dim=1)


# The kernel's team per cloud (csrc/fps.cu): W warps in each of C blocks
# (a cluster when C > 1), each thread holding P points, P the power of two
# that covers ceil(N / C) points with 32·W threads. Chosen by time per step
# on the card (PERF.md §6): a reduction across warps costs more than the
# distances of 16 to 32 points a thread, so up to 1024 points a cloud takes
# one warp (four clouds a block, no barrier), up to 8192 one block of 8
# warps, up to 65536 a cluster of 8-warp blocks of up to 8192 points each
# (32 a thread, all in registers), and up to 131072 a cluster of 8
# 1024-thread blocks of 16384 points, their coordinates in shared memory.
FPS_ONE_WARP = 1024
FPS_TEAM_WARPS = 8
FPS_PART_POINTS = 8192  # a block part of FPS_TEAM_WARPS warps, 32 points a thread
FPS_SMEM_PART_POINTS = 16384  # a block part of 32 warps, coordinates in shared memory
FPS_MAX_CLUSTER = 8  # the portable cluster size
FPS_MAX_POINTS = FPS_MAX_CLUSTER * FPS_SMEM_PART_POINTS  # 131072


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, math.ceil(math.log2(max(n, 1))))


def fps_plan(n: int) -> Tuple[int, int]:
    """``(warps, cluster)``: the FPS kernel's team for an n-point cloud, W
    warps in each of C blocks. The launcher refuses a plan whose block part
    would hold more than ``FPS_SMEM_PART_POINTS``, so n above
    ``FPS_MAX_POINTS``."""
    if n <= FPS_ONE_WARP:
        return 1, 1
    if n <= FPS_MAX_CLUSTER * FPS_PART_POINTS:
        return FPS_TEAM_WARPS, math.ceil(n / FPS_PART_POINTS)
    return 32, math.ceil(n / FPS_SMEM_PART_POINTS)


def fps_points_per_thread(n: int, warps: int, cluster: int) -> int:
    """P of the kernel's instance for an n-point cloud on that team, as its
    launcher derives it."""
    return _pow2_at_least(math.ceil(math.ceil(n / cluster) / (32 * warps)))


def _launch_fps(xyz: torch.Tensor, npoint: int, starts: torch.Tensor,
                plan: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """One launch of the kernel on ``fps_plan``'s team, or on ``plan``'s
    (warps, cluster)."""
    lib = cuda_build.library("fps", "fps_error_string", 3, 5)
    B, N, _ = xyz.shape
    warps, cluster = plan or fps_plan(N)
    out = torch.empty((B, npoint), dtype=torch.long, device=xyz.device)
    with torch.cuda.device(xyz.device):
        stream = torch.cuda.current_stream(xyz.device).cuda_stream
        err = lib.fps(xyz.data_ptr(), starts.data_ptr(), out.data_ptr(), B, N, npoint, warps,
                      cluster, stream)
    if err != 0:
        raise RuntimeError(f"fps launch failed: {lib.fps_error_string(err).decode()} "
                           f"(B={B}, N={N}, npoint={npoint}, warps={warps}, cluster={cluster})")
    fps.launches += 1
    return out


def fps(xyz: torch.Tensor, npoint: int, start_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Farthest point sampling ``(B, N, 3) -> (B, npoint)`` int64, the same
    indices as ``fps_plain``. ``start_idx`` (B,) must lie in [0, N).

    CPU tensors (f32 or f64) go to the plain version, which checks the
    starts and raises ValueError on one out of range. CUDA tensors (f32) go
    to the kernel, for N up to 131072, with no read back to the host: the
    kernel checks each start and stops with a device-side assert on one out
    of range, which the next synchronising call reports. A cloud the
    launcher refuses, a build or a launch failure raises. ``fps.launches``
    counts kernel launches.
    """
    _check_cloud("fps", "xyz", xyz, xyz.device)
    if npoint < 1:
        raise ValueError(f"fps: npoint must be >= 1, got {npoint}")
    starts = _starts(xyz, start_idx)
    if starts.shape != (xyz.shape[0],):
        raise ValueError(f"fps: start_idx must be (B,) = ({xyz.shape[0]},), got "
                         f"{tuple(starts.shape)}")
    if xyz.device.type == "cpu":
        if not bool(((starts >= 0) & (starts < xyz.shape[1])).all()):
            raise ValueError(f"fps: start_idx must lie in [0, {xyz.shape[1]}), got "
                             f"{starts.tolist()}")
        return fps_plain(xyz, npoint, starts)
    if xyz.device.type != "cuda":
        raise ValueError(f"fps: no path for device {xyz.device}")
    return _launch_fps(xyz, npoint, starts.contiguous())


fps.launches = 0
