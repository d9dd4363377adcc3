"""Classifier head: counterpart of ``ClassifierHead(dgcnn=True)`` in
``sug_tpu/models/heads.py``. The relu and PTran variants and the KPConv head
come with their backbones' slices (ROADMAP.md)."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from sug_tpu_torch.models.layers import FCLayer


class ClassifierHead(nn.Module):
    """1024 -> 512 -> 256 -> num_class with leaky-relu FC layers (the DGCNN
    variant: biased first FC). Returns (logits, the 256-d pre-dropout mid
    feature). Dropout(0.4) is the identity in eval mode."""

    def __init__(self, num_class: int = 10, in_features: int = 1024,
                 dropout_rate: float = 0.4):
        super().__init__()
        self.mlp1 = FCLayer(in_features, 512, act="leakyrelu", use_bias=True)
        self.mlp2 = FCLayer(512, 256, act="leakyrelu", use_bias=True)
        self.mlp3 = nn.Linear(256, num_class)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.dropout(self.mlp1(x))
        mid_feature = self.mlp2(x)
        logits = self.mlp3(self.dropout(mid_feature))
        return logits, mid_feature
