"""PointNet DG generator and standalone classifier: counterparts of
``PointNetGenerator`` and ``PointNetClassifier`` in
``sug_tpu/models/pointnet.py``. Channels-last (B, N, C); every shared MLP is
a Dense over the channel axis.

Under the bf16 policy the ConvBNs return bf16 and each T-Net an f32 matrix,
so the product with the second T-Net promotes its bf16 features to f32, as
the JAX ``einsum`` does; the max over the points stays bf16 and ``bn1``
promotes it to an f32 global feature. The classifier's 1024-d mid feature
is that bf16 max, its FCLayers compute in bf16 and ``mlp3`` promotes to f32
logits."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from sug_tpu_torch.models.adapt_node import SelfAdaptiveNodeModule
from sug_tpu_torch.models.bn import BatchNorm
from sug_tpu_torch.models.heads import dropout
from sug_tpu_torch.models.layers import ConvBN, Dense, FCLayer, TransformNet, flax_init_


def aligned_features(net: nn.Module, pc: torch.Tensor) -> torch.Tensor:
    """T-Net(3), ``conv1``, ``conv2`` and T-Net(64) of ``net``: (B, N, 64)."""
    x = torch.bmm(pc, net.trans_net1(pc))
    x = net.conv2(net.conv1(x))
    # bf16 features promote to the T-Net matrix's f32, as in the JAX einsum
    return torch.bmm(x.to(torch.promote_types(x.dtype, torch.float32)), net.trans_net2(x))


class PointNetGenerator(nn.Module):
    """T-Net(3) -> ConvBN 64, 64 -> T-Net(64) -> SA-node (64 -> 128) ->
    ConvBN 128, 1024 -> max over points -> BatchNorm. Returns (global_feat
    (B, 1024), node_fea (B, 64, 64), node_offset (B, 64, 3)); ``fps_start``
    (B,) starts the SA-node's FPS (index 0 when None)."""

    def __init__(self):
        super().__init__()
        self.trans_net1 = TransformNet(3, 3)
        self.conv1 = ConvBN(3, 64)
        self.conv2 = ConvBN(64, 64)
        self.trans_net2 = TransformNet(64, 64)
        self.sa_node = SelfAdaptiveNodeModule(64)
        self.conv4 = ConvBN(128, 128)
        self.conv5 = ConvBN(128, 1024)
        self.bn1 = BatchNorm(1024)

    def forward(
        self, pc: torch.Tensor, fps_start: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = aligned_features(self, pc)
        x, node_fea, node_off = self.sa_node(x, pc, fps_start)
        x = self.conv5(self.conv4(x))
        return self.bn1(torch.amax(x, dim=1)), node_fea, node_off


class PointNetClassifier(nn.Module):
    """The standalone PointNet classifier: T-Net(3) -> ConvBN 64, 64 ->
    T-Net(64) -> ConvBN 64, 128, 1024 -> max over points (the 1024-d mid
    feature) -> FCLayer 512, dropout, FCLayer 256, dropout -> Dense to
    ``num_class``. ``forward`` returns (logits, mid_feature); train mode
    draws the dropout masks (rate 0.7, ``dropout_rate``) from ``generator``. It
    has no SA-node, so it launches no kernel. The constructor's
    ``generator`` (CPU) draws the initial Dense kernels."""

    def __init__(self, num_class: int = 10, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout_rate = 0.7
        self.trans_net1 = TransformNet(3, 3)
        self.conv1 = ConvBN(3, 64)
        self.conv2 = ConvBN(64, 64)
        self.trans_net2 = TransformNet(64, 64)
        self.conv3 = ConvBN(64, 64)
        self.conv4 = ConvBN(64, 128)
        self.conv5 = ConvBN(128, 1024)
        self.mlp1 = FCLayer(1024, 512)
        self.mlp2 = FCLayer(512, 256)
        self.mlp3 = Dense(256, num_class)  # no dtype: f32 logits from bf16 features
        flax_init_(self, generator)

    def forward(self, pc: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.conv5(self.conv4(self.conv3(aligned_features(self, pc))))
        mid_feature = torch.amax(x, dim=1)
        x = dropout(self.mlp1(mid_feature), self.dropout_rate, self.training, generator)
        x = dropout(self.mlp2(x), self.dropout_rate, self.training, generator)
        return self.mlp3(x), mid_feature
