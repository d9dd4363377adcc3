"""PointNet++: counterparts of the modules of ``sug_tpu/models/pointnet2.py``.
Channels-last (B, N, C); every shared MLP is a ``ConvBN`` over the channel
axis, named ``mlp{i}`` (``branch{b}_mlp{i}`` in the multi-scale layer) as in
the JAX tree, with its in-width given explicitly.

FPS runs through ``farthest_point_sample`` (the kernel on the card), the ball
query and the gathers in plain PyTorch, as the JAX package computes them
outside any Pallas kernel. Maxima over a neighbourhood are ``torch.amax``,
whose gradient splits evenly among ties, as the JAX max's does: the ball
query pads a short ball with copies of its first point.

Every module here is f32 only: the bf16 policy over PointNet++ is not
ported (``models/precision.py`` refuses it by ``bf16_queued``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from sug_tpu_torch.models.bn import BatchNorm
from sug_tpu_torch.models.heads import dropout
from sug_tpu_torch.models.layers import ConvBN, Dense, flax_init_, maxpool1d_strided
from sug_tpu_torch.ops.geometry import (
    farthest_point_sample,
    index_points,
    query_ball_point,
    sample_and_group,
    sample_and_group_all,
    three_nn_interpolate,
)

BF16_QUEUED = "item 16b"


class _MLP(nn.Module):
    """A layer of shared MLPs: ConvBNs named ``{prefix}{i}``. Every
    PointNet++ model holds such layers, so each refuses the bf16 policy."""

    bf16_queued = BF16_QUEUED

    def add_mlp(self, prefix: str, in_features: int, widths: Sequence[int]) -> Tuple[str, ...]:
        """ConvBNs ``in_features`` -> ``widths[0]`` -> ...; returns their names."""
        names = tuple(f"{prefix}{i}" for i in range(len(widths)))
        for name, fan_in, width in zip(names, (in_features,) + tuple(widths[:-1]), widths):
            self.add_module(name, ConvBN(fan_in, width))
        return names


class SetAbstraction(_MLP):
    """Single-scale grouping: ``(xyz (B, N, 3), feats (B, N, D) or None)``
    -> ``(new_xyz (B, S, 3), new_feats (B, S, mlp[-1]))``; ``in_features``
    is 3 + D. With ``adapt`` it also returns the node tap, the max over the
    neighbourhood after the second MLP layer. ``fps_start`` (B,) starts the
    FPS (index 0 when None)."""

    def __init__(self, npoint: Optional[int], radius: Optional[float], nsample: Optional[int],
                 in_features: int, mlp: Sequence[int], group_all: bool = False):
        super().__init__()
        self.npoint, self.radius, self.nsample, self.group_all = npoint, radius, nsample, group_all
        self.mlp = self.add_mlp("mlp", in_features, mlp)

    def forward(self, xyz: torch.Tensor, feats: Optional[torch.Tensor], adapt: bool = False,
                fps_start: Optional[torch.Tensor] = None):
        if self.group_all:
            new_xyz, x = sample_and_group_all(xyz, feats)
        else:
            new_xyz, x = sample_and_group(self.npoint, self.radius, self.nsample, xyz, feats,
                                          fps_start)
        node_fea = None
        for i, name in enumerate(self.mlp):
            x = getattr(self, name)(x)
            if adapt and i == 1:
                node_fea = torch.amax(x, dim=2)  # (B, S, width)
        x = torch.amax(x, dim=2)  # the max over the neighbourhood
        return (new_xyz, x, node_fea) if adapt else (new_xyz, x)


class SetAbstractionMSG(_MLP):
    """Multi-scale grouping: one FPS, then a (radius, nsample, mlp) branch
    each, their maxima concatenated on the channel axis; ``in_features`` is
    3 + D."""

    def __init__(self, npoint: int, radii: Sequence[float], nsamples: Sequence[int],
                 in_features: int, mlps: Sequence[Sequence[int]]):
        super().__init__()
        self.npoint, self.radii, self.nsamples = npoint, tuple(radii), tuple(nsamples)
        self.branches = tuple(self.add_mlp(f"branch{b}_mlp", in_features, mlp)
                              for b, mlp in enumerate(mlps))

    def forward(self, xyz: torch.Tensor, feats: Optional[torch.Tensor],
                fps_start: Optional[torch.Tensor] = None):
        new_xyz = index_points(xyz, farthest_point_sample(xyz, self.npoint, fps_start))
        outs = []
        for radius, nsample, names in zip(self.radii, self.nsamples, self.branches):
            group_idx = query_ball_point(radius, nsample, xyz, new_xyz)
            x = index_points(xyz, group_idx) - new_xyz[:, :, None, :]
            if feats is not None:
                x = torch.cat([x, index_points(feats, group_idx)], dim=-1)
            for name in names:
                x = getattr(self, name)(x)
            outs.append(torch.amax(x, dim=2))
        return new_xyz, torch.cat(outs, dim=-1)


class FeaturePropagation(_MLP):
    """Upsampling: the coarse features interpolated onto the dense points
    from their 3 nearest coarse points (broadcast where the coarse level is
    one point), after the dense skip features, then the shared MLP;
    ``in_features`` is the skip width plus the coarse width."""

    def __init__(self, in_features: int, mlp: Sequence[int]):
        super().__init__()
        self.mlp = self.add_mlp("mlp", in_features, mlp)

    def forward(self, xyz_dense: torch.Tensor, xyz_coarse: torch.Tensor,
                feats_dense: Optional[torch.Tensor], feats_coarse: torch.Tensor) -> torch.Tensor:
        if xyz_coarse.shape[1] == 1:
            x = feats_coarse.expand(-1, xyz_dense.shape[1], -1)
        else:
            x = three_nn_interpolate(xyz_dense, xyz_coarse, feats_coarse)
        if feats_dense is not None:
            x = torch.cat([feats_dense, x], dim=-1)
        for name in self.mlp:
            x = getattr(self, name)(x)
        return x


def _sa_stack(module: nn.Module) -> None:
    """The SSG encoder of the generator and the classifier: SA(512, r 0.2,
    32, [64, 64, 128]) -> SA(128, r 0.4, 64, [128, 128, 256]) ->
    SA(group_all, [256, 512, 1024])."""
    module.sa1 = SetAbstraction(512, 0.2, 32, 3, (64, 64, 128))
    module.sa2 = SetAbstraction(128, 0.4, 64, 128 + 3, (128, 128, 256))
    module.sa3 = SetAbstraction(None, None, None, 256 + 3, (256, 512, 1024), group_all=True)


class PointNet2Generator(nn.Module):
    """The SSG generator of the DG model. Returns (global_feat (B, 1024),
    node_fea (B, 64, 64), None): the node features are ``sa1``'s tap
    (B, 512, 64) max-pooled with kernel 3, stride 8. ``fps_start`` (B,)
    starts ``sa1``'s FPS (index 0 when None); ``sa2``'s starts at 0."""

    def __init__(self):
        super().__init__()
        _sa_stack(self)

    def forward(self, pc: torch.Tensor, fps_start: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, None]:
        l1_xyz, l1_feats, node_tap = self.sa1(pc, None, adapt=True, fps_start=fps_start)
        l2_xyz, l2_feats = self.sa2(l1_xyz, l1_feats)
        _, l3_feats = self.sa3(l2_xyz, l2_feats)
        node_fea = maxpool1d_strided(node_tap, kernel=3, stride=8)  # (B, 64, 64)
        return l3_feats.reshape(pc.shape[0], 1024), node_fea, None


class PointNet2MSGSegmenter(nn.Module):
    """MSG encoder and FP decoder: (B, N, 3) -> per-point features
    (B, N, 256). No entry point builds it, in either package. The
    constructor's ``generator`` (CPU) draws the initial Dense kernels."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.sa1 = SetAbstractionMSG(512, (0.2,), (32,), 3, ((64, 64, 128),))
        self.sa2 = SetAbstractionMSG(128, (0.4,), (64,), 128 + 3, ((128, 128, 256),))
        self.sa3 = SetAbstraction(None, None, None, 256 + 3, (256, 512, 1024), group_all=True)
        self.fp2 = FeaturePropagation(256 + 1024, (1024, 1024))
        self.fp1 = FeaturePropagation(128 + 1024, (1024, 1024))
        self.fp0 = FeaturePropagation(1024, (256, 256))
        flax_init_(self, generator)

    def forward(self, pc: torch.Tensor) -> torch.Tensor:
        l1_xyz, l1_f = self.sa1(pc, None)
        l2_xyz, l2_f = self.sa2(l1_xyz, l1_f)
        l3_xyz, l3_f = self.sa3(l2_xyz, l2_f)  # l3_xyz: the origin
        d2 = self.fp2(l2_xyz, l3_xyz, l2_f, l3_f)
        d1 = self.fp1(l1_xyz, l2_xyz, l1_f, d2)
        return self.fp0(pc, l1_xyz, None, d1)


class PointNet2Classifier(nn.Module):
    """The standalone PointNet++ SSG classifier: the three SA layers (the
    1024-d mid feature) -> fc1 512, BN, relu, dropout -> fc2 256, BN, relu,
    dropout -> fc3 to ``num_class``. ``forward`` returns (logits,
    mid_feature); train mode draws the dropout masks (rate 0.4) from
    ``generator``. Its BNs are ``bn`` and ``bn1`` (flax's ``BatchNorm_0``,
    ``BatchNorm_1``). The constructor's ``generator`` (CPU) draws the
    initial Dense kernels."""

    def __init__(self, num_class: int = 10, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout_rate = 0.4
        _sa_stack(self)
        self.fc1 = Dense(1024, 512)
        self.bn = BatchNorm(512)
        self.fc2 = Dense(512, 256)
        self.bn1 = BatchNorm(256)
        self.fc3 = Dense(256, num_class)
        flax_init_(self, generator)

    def forward(self, pc: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        l1_xyz, l1_feats = self.sa1(pc, None)
        l2_xyz, l2_feats = self.sa2(l1_xyz, l1_feats)
        _, l3_feats = self.sa3(l2_xyz, l2_feats)
        mid_feature = l3_feats.reshape(pc.shape[0], 1024)
        x = mid_feature
        for fc, bn in ((self.fc1, self.bn), (self.fc2, self.bn1)):
            x = dropout(torch.relu(bn(fc(x))), self.dropout_rate, self.training, generator)
        return self.fc3(x), mid_feature
