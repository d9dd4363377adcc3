"""Classifier head: counterpart of ``ClassifierHead(dgcnn=True)`` in
``sug_tpu/models/heads.py``. The relu and PTran variants and the KPConv head
come with their backbones' slices (ROADMAP.md)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from sug_tpu_torch.models.layers import FCLayer


class ClassifierHead(nn.Module):
    """1024 -> 512 -> 256 -> num_class with leaky-relu FC layers (the DGCNN
    variant: biased first FC). Returns (logits, the 256-d pre-dropout mid
    feature).

    Dropout (rate ``dropout_rate``, after ``mlp1`` and after the mid
    feature) runs in train mode only, as flax's ``nn.Dropout``: a kept unit
    is scaled by ``1 / (1 - rate)``. Its masks come from ``generator``, which
    train mode with a non-zero rate requires."""

    def __init__(self, num_class: int = 10, in_features: int = 1024,
                 dropout_rate: float = 0.4):
        super().__init__()
        self.mlp1 = FCLayer(in_features, 512, act="leakyrelu", use_bias=True)
        self.mlp2 = FCLayer(512, 256, act="leakyrelu", use_bias=True)
        self.mlp3 = nn.Linear(256, num_class)
        self.dropout_rate = dropout_rate

    def dropout(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        if not self.training or self.dropout_rate == 0.0:
            return x
        if generator is None:
            raise ValueError("ClassifierHead: train-mode dropout needs a torch.Generator")
        keep_prob = 1.0 - self.dropout_rate
        keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.dropout(self.mlp1(x), generator)
        mid_feature = self.mlp2(x)
        logits = self.mlp3(self.dropout(mid_feature, generator))
        return logits, mid_feature
