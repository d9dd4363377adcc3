"""BatchNorm with flax semantics: counterpart of ``sug_tpu/models/bn.py``.

Channels-last (normalises the last axis of any rank), eps 1e-5, and the
eval-mode arithmetic of ``flax.linen.BatchNorm``:
``(x - mean) * (rsqrt(var + eps) * scale) + bias``. Only eval mode is
ported: train mode, whose running variance is fed the *biased* batch
variance, and the grouped and stacked two-group modes come with the training
slice (ROADMAP.md).
"""

from __future__ import annotations

import torch
from torch import nn

EPS = 1e-5


class BatchNorm(nn.Module):
    """``weight``/``bias`` are flax's ``scale``/``bias``; ``running_mean``/
    ``running_var`` its ``batch_stats`` ``mean``/``var``."""

    def __init__(self, num_features: int, eps: float = EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "BatchNorm train mode comes with the training slice (ROADMAP.md); "
                "call .eval() for inference"
            )
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean) * mul + self.bias
