"""DGCNN backbone with the SA-node module, and the standalone classifier
without it: counterparts of ``sug_tpu/models/dgcnn.py``.

Each EdgeConv block splits its Dense kernel W (2C, F) into the neighbour and
centre halves W1 = W[:C], W2 = W[C:], so that the edge activation is
``a_j = u[nbr_j] + v`` with ``u = x @ W1`` and ``v = x @ (W2 - W1)``. The
EdgeConv kernel returns max/min/sum/sumsq of ``a`` over the k=20 neighbours;
since BN's per-channel affine and leaky_relu are monotone, the block output
``max_j lrelu(BN(a_j))`` is ``lrelu(BN(amax))`` where the BN slope is >= 0
and ``lrelu(BN(amin))`` where it is negative. In train mode the BN batch
statistics come from the kernel's sums over the ``M = B·N·k`` edges, so the
gradients reach every edge through the kernel's ds1/ds2 cotangents, and the
max/min branch through damax/damin. With BN groups (``GroupedNorm``) the
statistics are taken per contiguous batch group from the same sums, as the
JAX block does (``dgcnn.py:92-141``).

Under the bf16 policy the blocks' ``u``/``v`` products stay f32, as the JAX
``conv_dense`` has no dtype, and the kernels run in their ``values_bf16``
mode (``u`` gathered rounded to bf16, f32 sums); the blocks' BN works on
those f32 sums, so every block returns f32, and so do ``reproject``,
``conv5`` and ``bn5``. Only the SA-node's ``residual`` ConvBN computes in
bf16.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as Fn
from torch import nn

from sug_tpu_torch.models.adapt_node import SelfAdaptiveNodeModule
from sug_tpu_torch.models.bn import (EPS, BatchNorm, GroupedNorm, check_groups,
                                     update_running, update_running_grouped)
from sug_tpu_torch.models.heads import ClassifierHead
from sug_tpu_torch.models.layers import flax_init_
from sug_tpu_torch.models.precision import Mixed
from sug_tpu_torch.ops.edgeconv import fused_edgeconv_reduce

K_NEIGHBORS = 20


class EdgeConvBlock(GroupedNorm, Mixed):
    """One EdgeConv block, the counterpart of ``_EdgeConvBlock``: kNN-20
    graph -> Dense + BN + leaky_relu(0.01) -> max over the neighbours; the
    kernels in ``values_bf16`` mode under the bf16 policy."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.conv_dense = nn.Linear(2 * in_features, features, bias=False)
        self.bn_scale = nn.Parameter(torch.ones(features))
        self.bn_bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("bn_mean", torch.zeros(features))
        self.register_buffer("bn_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        w = self.conv_dense.weight  # (F, 2C): torch Linear layout
        w1, w2 = w[:, :C], w[:, C:]
        u = torch.matmul(x, w1.t())
        v = torch.matmul(x, (w2 - w1).t())
        amax, amin, s1, s2, _ = fused_edgeconv_reduce(
            x, u, v, K_NEIGHBORS, values_bf16=self.compute_dtype == torch.bfloat16)

        if self.training and self.groups > 1:
            inv, off = self._group_slopes(s1, s2)
        else:
            if self.training:
                m = B * N * K_NEIGHBORS  # every edge, not every point
                mean = torch.sum(s1, dim=(0, 1)) / m
                var = torch.clamp(torch.sum(s2, dim=(0, 1)) / m - mean * mean, min=0.0)
                update_running(self.bn_mean, self.bn_var, mean, var)
            else:
                mean, var = self.bn_mean, self.bn_var
            inv = self.bn_scale * torch.rsqrt(var + EPS)  # signed slopes
            off = self.bn_bias - mean * inv
        sel = torch.where(inv >= 0, amax, amin)
        return Fn.leaky_relu(sel * inv + off, negative_slope=0.01)

    def _group_slopes(self, s1: torch.Tensor, s2: torch.Tensor):
        """Train mode with BN groups: each contiguous batch group's slopes and
        offsets from its own edges' sums, on its rows, (B, 1, F) each."""
        B, N, F = s1.shape
        g = self.groups
        check_groups(B, g)
        m = (B // g) * N * K_NEIGHBORS  # every edge of a group, not every point
        mean = torch.sum(s1.reshape(g, -1, F), dim=1) / m  # (g, F)
        var = torch.clamp(torch.sum(s2.reshape(g, -1, F), dim=1) / m - mean * mean, min=0.0)
        update_running_grouped(self.bn_mean, self.bn_var, mean, var, self.momentum_mode)
        inv = self.bn_scale * torch.rsqrt(var + EPS)  # (g, F) signed slopes
        off = self.bn_bias - mean * inv
        return tuple(t[:, None, None, :].expand(g, B // g, 1, F).reshape(B, 1, F)
                     for t in (inv, off))


class DGCNNGenerator(nn.Module):
    """DG generator: (B, N, 3) -> (global_feat (B, 1024), node_fea
    (B, 64, 64), node_offset (B, 64, 3))."""

    def __init__(self):
        super().__init__()
        self.block1 = EdgeConvBlock(3, 64)
        self.block2 = EdgeConvBlock(64, 64)
        self.sa_node = SelfAdaptiveNodeModule(64)
        self.reproject = nn.Linear(128, 64)
        self.block3 = EdgeConvBlock(64, 128)
        self.block4 = EdgeConvBlock(128, 256)
        self.conv5 = nn.Linear(512, 512, bias=False)
        self.bn5 = BatchNorm(512)

    def forward(
        self, pc: torch.Tensor, fps_start: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x1 = self.block1(pc)
        x2 = self.block2(x1)
        x_up, node_fea, node_off = self.sa_node(x2, pc, fps_start)
        x2 = self.reproject(x_up)
        return pooled_features(self, x1, x2), node_fea, node_off


def pooled_features(net: nn.Module, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """``block3``, ``block4``, ``conv5`` and ``bn5`` of ``net`` after the
    first two levels' features, then the max and the mean over the points:
    (B, 1024)."""
    x3 = net.block3(x2)
    x4 = net.block4(x3)
    x5 = net.conv5(torch.cat([x1, x2, x3, x4], dim=-1))  # (B, N, 512)
    x5 = Fn.leaky_relu(net.bn5(x5), negative_slope=0.2)
    return torch.cat([torch.amax(x5, dim=1), torch.mean(x5, dim=1)], dim=-1)


class DGCNNClassifier(nn.Module):
    """The standalone DGCNN classifier: the generator's four EdgeConv blocks
    without the SA-node (``block2`` feeds ``block3``), ``conv5``, ``bn5``,
    the max and mean over the points, and the dgcnn ``ClassifierHead``.
    ``forward`` returns (logits, the head's 256-d mid feature); train mode
    draws the head's dropout masks from ``generator``. The constructor's
    ``generator`` (CPU) draws the initial Dense kernels."""

    def __init__(self, num_class: int = 10, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.block1 = EdgeConvBlock(3, 64)
        self.block2 = EdgeConvBlock(64, 64)
        self.block3 = EdgeConvBlock(64, 128)
        self.block4 = EdgeConvBlock(128, 256)
        self.conv5 = nn.Linear(512, 512, bias=False)
        self.bn5 = BatchNorm(512)
        self.classifier = ClassifierHead(num_class, "dgcnn")
        flax_init_(self, generator)

    def forward(self, pc: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        x1 = self.block1(pc)
        return self.classifier(pooled_features(self, x1, self.block2(x1)), generator)
