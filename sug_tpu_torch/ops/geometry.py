"""Point-cloud geometry ops: counterparts of ``sug_tpu/ops/geometry.py``.

Channels-last ``(B, N, C)`` layout throughout, as in the JAX package. Every
k-nearest selection breaks distance ties by the lowest index, as
``lax.top_k`` does: the distances are sorted with ``torch.sort(stable=True)``
and the first k taken, because ``torch.topk`` guarantees no tie order.

Large clouds route as the JAX package routes them (``chamfer_is_tiled``,
``knn_is_blockwise``): the chamfer to the wrapper of
``ops/geometry_kernels.py``, which launches the CUDA kernel on the card and
runs the same plain code as below on the CPU, and the kNN (a cloud's own
and, for the plain EdgeConv, a query set's among the cloud) to the plain
``knn_blockwise``. FPS goes to the wrapper ``geometry_kernels.fps`` at every
size: the JAX package takes its Pallas kernel only from 4096 points on a
TPU, where ``npoint % 8 == 0``, because below that its ``fori_loop`` is
already one compiled program; on the card the same function is one kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

CHAMFER_TILED_ABOVE = 2048  # points, in either cloud
KNN_BLOCKWISE_ABOVE = 4096  # points


def chamfer_is_tiled(n: int, m: int) -> bool:
    """Whether the chamfer of N- and M-point clouds takes ``chamfer_tiled``
    (no (B, N, M) matrix), as ``geometry.py:297`` of the JAX package."""
    return n > CHAMFER_TILED_ABOVE or m > CHAMFER_TILED_ABOVE


def knn_is_blockwise(n: int) -> bool:
    """Whether the kNN of an N-point cloud takes ``knn_blockwise``, as
    ``geometry.py:85`` of the JAX package."""
    return n > KNN_BLOCKWISE_ABOVE


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distance ``(B, N, C), (B, M, C) -> (B, N, M)``.

    Same ``-2·src·dst + |src|² + |dst|²`` form and f32 as the JAX op; TF32 is
    off package-wide, since rounded distances reorder near-tied neighbours.
    """
    dist = -2.0 * torch.matmul(src, dst.transpose(1, 2))
    dist = dist + torch.sum(src**2, dim=-1, keepdim=True)
    dist = dist + torch.sum(dst**2, dim=-1)[:, None, :]
    return dist


def smallest_k(dist: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest entries along the last axis, ascending, the
    lowest index first among equal values. Returns int64."""
    return torch.sort(dist, dim=-1, stable=True).indices[..., :k]


def knn_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """``(B, N, C) -> (B, N, k)`` int64 indices of each point's k nearest
    neighbours, the point itself included; large clouds go blockwise."""
    return cross_knn_indices(x, x, k)


def cross_knn_indices(q: torch.Tensor, kv: torch.Tensor, k: int) -> torch.Tensor:
    """``(B, S, C), (B, N, C) -> (B, S, k)`` int64 indices of each query's k
    nearest keys, ascending, the lowest index first among equal distances;
    above 4096 keys by ``knn_blockwise``, never the (B, S, N) matrix."""
    if knn_is_blockwise(kv.shape[1]):
        return knn_blockwise(q, k, keys=kv)
    return smallest_k(square_distance(q, kv), k)


def knn_blockwise(x: torch.Tensor, k: int, tile: int = 1024,
                  keys: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``knn_indices`` (with ``keys``, the k nearest ``keys`` of each point of
    ``x``) as a scan over key tiles with a running top-k merge: memory
    O(B·S·(k + tile)), never (B, S, N). A stable sort over ``[best, tile]``
    keeps the lowest index first among equal distances, since the running
    best holds lower indices than the tile."""
    keys = x if keys is None else keys
    B, S = x.shape[:2]
    best_d = torch.full((B, S, k), float("inf"), dtype=x.dtype, device=x.device)
    best_i = torch.zeros((B, S, k), dtype=torch.long, device=x.device)
    for t0 in range(0, keys.shape[1], tile):
        src = keys[:, t0:t0 + tile]
        idx = torch.arange(t0, t0 + src.shape[1], device=x.device).expand(B, S, -1)
        cat_d = torch.cat([best_d, square_distance(x, src)], dim=-1)
        cat_i = torch.cat([best_i, idx], dim=-1)
        pos = smallest_k(cat_d, k)
        best_d, best_i = torch.gather(cat_d, -1, pos), torch.gather(cat_i, -1, pos)
    return best_i


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather ``points`` (B, N, C) by ``idx`` (B, S) or (B, S, K) into
    (B, S, C) or (B, S, K, C)."""
    if idx.dim() not in (2, 3):
        raise ValueError(f"idx must be rank 2 or 3, got {idx.dim()}")
    B, C = points.shape[0], points.shape[-1]
    flat = idx.reshape(B, -1).long()
    out = torch.gather(points, 1, flat[..., None].expand(-1, -1, C))
    return out.reshape(*idx.shape, C)


def farthest_point_sample(
    xyz: torch.Tensor, npoint: int, start_idx: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Farthest point sampling ``(B, N, 3) -> (B, npoint)`` int64, starting at
    ``start_idx`` (B,) of each cloud, or at index 0 when it is None, through
    the wrapper ``fps`` at every N: the kernel on the card, the plain loop on
    the CPU."""
    from sug_tpu_torch.ops import geometry_kernels

    return geometry_kernels.fps(xyz.contiguous(), npoint, start_idx)


def query_ball_point(
    radius: Optional[float], nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> torch.Tensor:
    """Neighbours of each query ``new_xyz`` (B, S, 3) in ``xyz`` (B, N, 3):
    (B, S, nsample) int64.

    With a radius, the in-ball points in ascending index order, padded with
    the first in-ball index; ``radius=None`` is plain kNN sorted by distance.
    """
    N = xyz.shape[1]
    nsample = min(nsample, N)
    sqrdists = square_distance(new_xyz, xyz)  # (B, S, N)
    if radius is None:
        return smallest_k(sqrdists, nsample)
    iota = torch.arange(N, device=xyz.device)
    # out-of-ball points get the sentinel key N; the nsample smallest keys are
    # the smallest in-ball indices, ascending
    keys = torch.where(sqrdists > radius**2, N, iota[None, None, :])
    group_idx = torch.sort(keys, dim=-1).values[..., :nsample]
    group_idx = torch.where(group_idx == N, group_idx[..., :1], group_idx)
    # an empty ball leaves only sentinels: clamp into range
    return torch.clamp(group_idx, max=N - 1)


def sample_and_group(
    npoint: int,
    radius: Optional[float],
    nsample: int,
    xyz: torch.Tensor,
    feats: Optional[torch.Tensor],
    start_idx: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """PointNet++ grouping: FPS of ``npoint`` centroids of ``xyz`` (B, N, 3)
    from ``start_idx``, the ball query around each, the gather and the
    centring. Returns new_xyz (B, npoint, 3) and the grouped features
    (B, npoint, nsample, 3 [+ D]): ``[grouped_xyz − centroid, feats]`` in
    that channel order, ``feats`` (B, N, D) or None."""
    new_xyz = index_points(xyz, farthest_point_sample(xyz, npoint, start_idx))
    group_idx = query_ball_point(radius, nsample, xyz, new_xyz)
    grouped = index_points(xyz, group_idx) - new_xyz[:, :, None, :]
    if feats is not None:
        grouped = torch.cat([grouped, index_points(feats, group_idx)], dim=-1)
    return new_xyz, grouped


def sample_and_group_all(
    xyz: torch.Tensor, feats: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole cloud as one group around the origin (the last SA layer):
    new_xyz zeros (B, 1, 3), grouped (B, 1, N, 3 [+ D]), ``[xyz, feats]``."""
    new_xyz = xyz.new_zeros((xyz.shape[0], 1, 3))
    grouped = xyz[:, None]
    if feats is not None:
        grouped = torch.cat([grouped, feats[:, None]], dim=-1)
    return new_xyz, grouped


def three_nn_interpolate(
    xyz_dense: torch.Tensor,
    xyz_coarse: torch.Tensor,
    feats_coarse: torch.Tensor,
    k: int = 3,
) -> torch.Tensor:
    """Inverse-distance-weighted kNN upsampling of ``feats_coarse`` (B, S, D)
    at ``xyz_coarse`` onto ``xyz_dense`` (B, N, 3): (B, N, D)."""
    sqrdists = square_distance(xyz_dense, xyz_coarse)  # (B, N, S)
    idx = smallest_k(sqrdists, k)
    dists = torch.clamp(torch.gather(sqrdists, -1, idx), min=1e-10)
    weight = 1.0 / dists
    weight = weight / torch.sum(weight, dim=-1, keepdim=True)  # (B, N, k)
    neighbor_feats = index_points(feats_coarse, idx)  # (B, N, k, D)
    return torch.sum(neighbor_feats * weight[..., None], dim=2)


def chamfer_distance(pc1: torch.Tensor, pc2: torch.Tensor, per_sample: bool = True) -> torch.Tensor:
    """Bidirectional chamfer distance, ``(B, N, 3), (B, M, 3)`` -> (B,)
    ``mean_n min_m d + mean_m min_n d`` of squared distances, or its mean
    over the batch. Up to 2048 points the plain (B, N, M) version, above
    them ``chamfer_tiled``."""
    if chamfer_is_tiled(pc1.shape[1], pc2.shape[1]):
        from sug_tpu_torch.ops.geometry_kernels import chamfer_tiled

        return chamfer_tiled(pc1, pc2, per_sample)
    sqrdists = square_distance(pc1, pc2)  # (B, N, M)
    per = torch.mean(torch.amin(sqrdists, dim=2), dim=1) + torch.mean(torch.amin(sqrdists, dim=1), dim=1)
    return per if per_sample else torch.mean(per)
