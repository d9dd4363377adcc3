"""Point-cloud geometry ops: counterparts of ``sug_tpu/ops/geometry.py``.

Channels-last ``(B, N, C)`` layout throughout, as in the JAX package. Every
k-nearest selection breaks distance ties by the lowest index, as
``lax.top_k`` does: the distances are sorted with ``torch.sort(stable=True)``
and the first k taken, because ``torch.topk`` guarantees no tie order.
"""

from __future__ import annotations

from typing import Optional

import torch


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
    neighbours, the point itself included."""
    return smallest_k(square_distance(x, x), k)


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
    """Farthest point sampling ``(B, N, 3) -> (B, npoint)`` int64.

    A plain loop, like the JAX package's below N=4096, starting at
    ``start_idx`` (B,) of each cloud, or at index 0 when it is None.
    ``torch.argmax`` returns the first maximal index, as ``jnp.argmax`` does.
    """
    B, N, _ = xyz.shape
    if start_idx is None:
        farthest = torch.zeros(B, dtype=torch.long, device=xyz.device)
    else:
        farthest = start_idx.to(device=xyz.device, dtype=torch.long)
    dists = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    centroids = torch.empty((B, npoint), dtype=torch.long, device=xyz.device)
    for i in range(npoint):
        centroids[:, i] = farthest
        centroid = index_points(xyz, farthest[:, None])  # (B, 1, 3)
        dists = torch.minimum(dists, torch.sum((xyz - centroid) ** 2, dim=-1))
        farthest = torch.argmax(dists, dim=-1)
    return centroids


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
    over the batch. The plain (B, N, M) version, as the JAX package runs it
    up to 2048 points."""
    sqrdists = square_distance(pc1, pc2)  # (B, N, M)
    per = torch.mean(torch.amin(sqrdists, dim=2), dim=1) + torch.mean(torch.amin(sqrdists, dim=1), dim=1)
    return per if per_sample else torch.mean(per)
