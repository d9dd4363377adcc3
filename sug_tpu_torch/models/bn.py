"""BatchNorm with flax semantics: counterpart of ``sug_tpu/models/bn.py``.

Channels-last (normalises the last axis of any rank), eps 1e-5, momentum
0.9, and the arithmetic of ``flax.linen.BatchNorm``, written out:

- train mode: the batch mean over every axis but the last, and the biased
  variance ``max(mean(x²) − mean², 0)`` (flax's ``use_fast_variance``);
  the running stats become ``0.9·running + 0.1·batch``, the variance
  biased, without gradient;
- both modes: ``(x − mean) * (rsqrt(var + eps) * scale) + bias``.

``torch.nn.functional.batch_norm`` is not used: its Welford variance rounds
differently, and its running variance takes the unbiased estimate. The
grouped per-replica and the stacked two-group modes come with later slices
(ROADMAP.md).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

EPS = 1e-5
MOMENTUM = 0.9


def batch_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flax's train-mode (mean, biased variance) over every axis but the last."""
    axes = tuple(range(x.dim() - 1))
    mean = torch.mean(x, dim=axes)
    var = torch.clamp(torch.mean(x * x, dim=axes) - mean * mean, min=0.0)
    return mean, var


@torch.no_grad()
def update_running(running_mean: torch.Tensor, running_var: torch.Tensor,
                   mean: torch.Tensor, var: torch.Tensor) -> None:
    """``running = momentum·running + (1 − momentum)·batch``, in place."""
    running_mean.copy_(MOMENTUM * running_mean + (1.0 - MOMENTUM) * mean)
    running_var.copy_(MOMENTUM * running_var + (1.0 - MOMENTUM) * var)


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
            mean, var = batch_stats(x)
            update_running(self.running_mean, self.running_var, mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias
