"""Self-adaptive node module (SA-node): counterpart of
``sug_tpu/models/adapt_node.py``.

FPS 64 nodes -> ball query (r=0.3, 64) -> learned tanh offsets on the
centred group features -> kNN re-query at the offset nodes -> max-pool of the
residual features -> 3-NN inverse-distance upsample, concatenated with the
input features. The gather-then-project order of the JAX default is kept.
The max-pool re-query goes through ``edgeconv_reduce`` with ``v = 0``,
taking ``amax``: the CUDA kernels on the card, their plain versions on the
CPU. In train mode the ``residual`` ConvBN takes batch statistics, and its
gradient arrives through the backward kernel's ``du`` from the ``amax``
cotangent. ``fps_start`` (B,) is FPS's first index per cloud (index 0 when
None); the trainers draw it at random.

Under the bf16 policy the ``residual`` ConvBN computes in bf16 and the
re-query runs in the kernels' ``values_bf16`` mode on that bf16 feature as
it is (rounding it again is exact), so the node features come back f32, as
on the JAX package's kernel route (``adapt_node.py:99-110``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from sug_tpu_torch.models.layers import ConvBN
from sug_tpu_torch.models.precision import Mixed
from sug_tpu_torch.ops.edgeconv import fused_cross_edgeconv_reduce
from sug_tpu_torch.ops.geometry import (
    farthest_point_sample,
    index_points,
    query_ball_point,
    three_nn_interpolate,
)

NUM_NODE = 64  # FPS nodes
NSAMPLE = 64  # ball-query group size, and k of the max-pool re-query
RADIUS = 0.3
FC_DIM = 64  # node feature width


class SelfAdaptiveNodeModule(Mixed):
    """(B, N, C) features + (B, N, 3) coords -> (B, N, C + FC_DIM) upsampled
    features, (B, NUM_NODE, FC_DIM) node features, (B, NUM_NODE, 3) node
    offsets."""

    def __init__(self, in_features: int = 64):
        super().__init__()
        # no bias: the name 'pred_offset' is what the optimizer's group
        # masks key on, as in the JAX package
        self.pred_offset = nn.Linear(in_features, 3, bias=False)
        self.residual = ConvBN(in_features, FC_DIM)

    def forward(
        self, feats: torch.Tensor, xyz: torch.Tensor, fps_start: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        fps_idx = farthest_point_sample(xyz, NUM_NODE, fps_start)
        fpoint_loc = index_points(xyz, fps_idx)  # (B, S, 3)
        group_idx = query_ball_point(RADIUS, NSAMPLE, xyz, fpoint_loc)

        fpoint_fea = index_points(feats, fps_idx)
        group_fea = index_points(feats, group_idx) - fpoint_fea[:, :, None, :]
        seman_trans = torch.tanh(self.pred_offset(group_fea))  # (B, S, ns, 3)
        group_loc = index_points(xyz, group_idx) - fpoint_loc[:, :, None, :]
        node_offset = torch.mean(seman_trans * group_loc, dim=2)  # (B, S, 3)

        node_loc = (fpoint_loc + node_offset).contiguous()
        residual_fea = self.residual(feats)  # (B, N, FC_DIM)
        zeros_v = torch.zeros(node_loc.shape[:2] + (FC_DIM,),
                              dtype=feats.dtype, device=feats.device)
        node_fea = fused_cross_edgeconv_reduce(
            node_loc, xyz, residual_fea, zeros_v, min(NSAMPLE, xyz.shape[1]),
            values_bf16=self.compute_dtype == torch.bfloat16,
        )[0]

        interpolated = three_nn_interpolate(xyz, node_loc, node_fea, k=3)
        return torch.cat([feats, interpolated], dim=-1), node_fea, node_offset
