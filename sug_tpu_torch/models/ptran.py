"""Point Transformer (PTran) backbone, DG generator and standalone
classifier: counterparts of ``sug_tpu/models/ptran.py``.

Every ``VectorAttentionBlock`` runs its attention body (kNN, the delta and
gamma MLPs over each point's k=16 neighbours, the per-channel softmax) in
``fused_vector_attention``, the CUDA kernel on the card, at every level of
the backbone. The Dense layers around it are ``nn.Linear`` layers named after
the JAX tree (``fc1``, ``w_qs``, ..., ``fc_gamma2``, ``fc2``); the kernel takes
their weights in the (in, out) layout of flax's Dense kernels.

Under the bf16 policy (``models/precision.py``) the block's ``fc1``,
``w_qs``, ``w_ks`` and ``w_vs`` compute in bf16, as the JAX block passes them
``dtype=compute_dtype()`` (``sug_tpu/models/ptran.py:113-116``), so q, key
and val reach the attention in bf16 and select its bf16 mode; ``fc2`` has no
dtype there (:132, :162) and promotes, and so does the residual ``+
features``; the backbone's ``fc1a``/``fc1b`` and the generator's
``point_mix`` stay f32; ``TransitionDown``'s ``ConvBN``s follow the policy.
The classifier's ``fc2a``, ``fc2b`` and ``fc2c`` stay f32: they have no
dtype there either (:298-302).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from sug_tpu_torch.models.layers import ConvBN, Dense, flax_init_
from sug_tpu_torch.models.precision import Mixed
from sug_tpu_torch.ops.geometry import (
    farthest_point_sample,
    index_points,
    smallest_k,
    square_distance,
)
from sug_tpu_torch.ops.vector_attention import fused_vector_attention


def _kernel(layer: nn.Linear) -> torch.Tensor:
    """A Linear layer's weight in flax's (in, out) kernel layout."""
    return layer.weight.t().contiguous()


class VectorAttentionBlock(Mixed):
    """TransformerBlock: d_points <-> d_model projections around vector
    attention with relative-position encodings, plus the residual; the four
    projections into the attention in the compute dtype."""

    def __init__(self, d_points: int, d_model: int = 512, k: int = 16):
        super().__init__()
        self.k = k
        self.fc1 = Dense(d_points, d_model)
        self.w_qs = Dense(d_model, d_model, bias=False)
        self.w_ks = Dense(d_model, d_model, bias=False)
        self.w_vs = Dense(d_model, d_model, bias=False)
        self.fc_delta1 = nn.Linear(3, d_model)
        self.fc_delta2 = nn.Linear(d_model, d_model)
        self.fc_gamma1 = nn.Linear(d_model, d_model)
        self.fc_gamma2 = nn.Linear(d_model, d_model)
        self.fc2 = nn.Linear(d_model, d_points)

    def forward(self, xyz: torch.Tensor, features: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = self.fc1(features, dt)
        res = fused_vector_attention(
            xyz, self.w_qs(x, dt), self.w_ks(x, dt), self.w_vs(x, dt),
            _kernel(self.fc_delta1), self.fc_delta1.bias,
            _kernel(self.fc_delta2), self.fc_delta2.bias,
            _kernel(self.fc_gamma1), self.fc_gamma1.bias,
            _kernel(self.fc_gamma2), self.fc_gamma2.bias,
            min(self.k, xyz.shape[1]),
        )
        return self.fc2(res) + features


class TransitionDown(nn.Module):
    """FPS to ``npoint`` + kNN grouping (relative xyz concatenated with the
    features) + two ConvBN + max over the neighbours."""

    def __init__(self, nneighbor: int, in_features: int, mlp: Sequence[int]):
        super().__init__()
        self.nneighbor = nneighbor
        self.mlp0 = ConvBN(in_features + 3, mlp[0])
        self.mlp1 = ConvBN(mlp[0], mlp[1])

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor, npoint: int,
                fps_start: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        new_xyz = index_points(xyz, farthest_point_sample(xyz, npoint, fps_start))
        idx = smallest_k(square_distance(new_xyz, xyz), min(self.nneighbor, xyz.shape[1]))
        grouped_xyz = index_points(xyz, idx) - new_xyz[:, :, None, :]
        grouped = torch.cat([grouped_xyz, index_points(feats, idx)], dim=-1)
        return new_xyz, torch.amax(self.mlp1(self.mlp0(grouped)), dim=2)


class PointTransformerBackbone(nn.Module):
    """fc(3->32) -> transformer -> ``nblocks`` x (TransitionDown to a quarter
    of the points with twice the channels, + transformer). Returns the last
    level's features (B, N/4^nblocks, 32·2^nblocks) and every level's
    (xyz, features)."""

    def __init__(self, nblocks: int = 4, nneighbor: int = 16, transformer_dim: int = 512):
        super().__init__()
        self.nblocks = nblocks
        self.fc1a = nn.Linear(3, 32)
        self.fc1b = nn.Linear(32, 32)
        self.transformer1 = VectorAttentionBlock(32, transformer_dim, nneighbor)
        for i in range(nblocks):
            channel = 32 * 2 ** (i + 1)
            self.add_module(f"td{i}", TransitionDown(nneighbor, channel // 2, (channel, channel)))
            self.add_module(f"transformer{i + 2}",
                            VectorAttentionBlock(channel, transformer_dim, nneighbor))

    def forward(self, pc: torch.Tensor, fps_start: Optional[torch.Tensor] = None):
        N = pc.shape[1]
        xyz = pc
        points = self.transformer1(xyz, self.fc1b(torch.relu(self.fc1a(pc))))
        levels: List[Tuple[torch.Tensor, torch.Tensor]] = [(xyz, points)]
        for i in range(self.nblocks):
            xyz, points = getattr(self, f"td{i}")(xyz, points, max(N // 4 ** (i + 1), 1),
                                                  fps_start if i == 0 else None)
            points = getattr(self, f"transformer{i + 2}")(xyz, points)
            levels.append((xyz, points))
        return points, levels


class PointTransformerGenerator(nn.Module):
    """DG generator: global feature = the mean over the last level's points
    (B, 512); node features = level 2's (B, N/16, 128) strided by 2 over
    features and mixed over its points by ``point_mix`` (a Dense over the
    point axis, the reference's stride-2 point-mixing Conv1d): (B, 64, 64).
    ``point_mix`` has ``num_points // 16`` inputs, so the generator is built
    for one cloud size; flax sizes it at the first call."""

    def __init__(self, num_points: int = 1024):
        super().__init__()
        self.num_points = num_points
        self.backbone = PointTransformerBackbone()
        self.point_mix = nn.Linear(max(num_points // 16, 1), 64)

    def forward(self, pc: torch.Tensor, fps_start: Optional[torch.Tensor] = None):
        if pc.shape[1] != self.num_points:
            raise ValueError(f"PointTransformerGenerator was built for {self.num_points} points "
                             f"(point_mix), got clouds of {pc.shape[1]}")
        points, levels = self.backbone(pc, fps_start)
        strided = levels[2][1][:, :, ::2]  # (B, N/16, 64): stride 2 over features
        node_fea = self.point_mix(strided.transpose(1, 2))  # Dense over the points
        return torch.mean(points, dim=1), node_fea, None


class PointTransformerClassifier(nn.Module):
    """The standalone PTran classifier: the backbone, the mean over the last
    level's points, ``fc2a`` to 256 (the mid feature), relu, ``fc2b`` to 64,
    relu, ``fc2c`` to ``num_class``. ``forward`` returns (logits,
    mid_feature); it has no dropout, so ``generator`` is not read. Without
    the generator's ``point_mix`` it takes any cloud size the kernels take;
    every TransitionDown's FPS starts at index 0. The constructor's
    ``generator`` (CPU) draws the initial Dense kernels."""

    def __init__(self, num_class: int = 10, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.backbone = PointTransformerBackbone()
        self.fc2a = nn.Linear(512, 256)
        self.fc2b = nn.Linear(256, 64)
        self.fc2c = nn.Linear(64, num_class)
        flax_init_(self, generator)

    def forward(self, pc: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        points, _ = self.backbone(pc)
        mid_feature = self.fc2a(torch.mean(points, dim=1))
        x = torch.relu(self.fc2b(torch.relu(mid_feature)))
        return self.fc2c(x), mid_feature
