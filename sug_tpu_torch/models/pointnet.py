"""PointNet DG generator: counterpart of ``PointNetGenerator`` in
``sug_tpu/models/pointnet.py``. Channels-last (B, N, C); every shared MLP is
a Dense over the channel axis. The standalone ``PointNetClassifier`` comes
with the other standalone classifiers (ROADMAP.md).

Under the bf16 policy the ConvBNs return bf16 and each T-Net an f32 matrix,
so the product with the second T-Net promotes its bf16 features to f32, as
the JAX ``einsum`` does; the max over the points stays bf16 and ``bn1``
promotes it to an f32 global feature."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from sug_tpu_torch.models.adapt_node import SelfAdaptiveNodeModule
from sug_tpu_torch.models.bn import BatchNorm
from sug_tpu_torch.models.layers import ConvBN, TransformNet


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
        x = torch.bmm(pc, self.trans_net1(pc))
        x = self.conv2(self.conv1(x))
        # bf16 features promote to the T-Net matrix's f32, as in the JAX einsum
        x = torch.bmm(x.to(torch.promote_types(x.dtype, torch.float32)), self.trans_net2(x))
        x, node_fea, node_off = self.sa_node(x, pc, fps_start)
        x = self.conv5(self.conv4(x))
        return self.bn1(torch.amax(x, dim=1)), node_fea, node_off
