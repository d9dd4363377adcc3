"""Classifier heads: counterparts of ``ClassifierHead`` (in its three
variants) and ``KPConvHead`` in ``sug_tpu/models/heads.py``."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from sug_tpu_torch.models.layers import Dense, FCLayer

VARIANTS = ("dgcnn", "relu", "ptran")


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's ``nn.Dropout`` in train mode (``training``) with a non-zero
    ``rate``, else the identity: a kept unit is scaled by ``1 / (1 -
    rate)``, in the features' dtype. The masks come from ``generator``,
    which train mode with a non-zero rate requires."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("train-mode dropout needs a torch.Generator")
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class ClassifierHead(nn.Module):
    """1024 -> 512 -> 256 -> num_class. Returns (logits, the 256-d
    pre-dropout mid feature). ``variant``:

    - ``dgcnn``: leaky-relu FC layers, ``mlp1`` biased (``dgcnn=True``);
    - ``relu``: relu FC layers, ``mlp1`` without bias (the PointNet heads);
    - ``ptran``: relu, and no ``mlp1``: the PTran generator's global feature
      is already 512-d (``ptran=True``).

    Dropout (rate ``dropout_rate``, after ``mlp1`` and after the mid
    feature) runs in train mode only (``dropout``), its masks drawn from
    ``generator``.
    Under the bf16 policy ``mlp1``, ``mlp2`` and the mid feature are bf16
    and ``mlp3`` promotes them to f32 logits, as in the JAX head."""

    def __init__(self, num_class: int = 10, variant: str = "dgcnn", dropout_rate: float = 0.4):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"ClassifierHead variant must be one of {VARIANTS}, got {variant!r}")
        act = "leakyrelu" if variant == "dgcnn" else "relu"
        self.mlp1 = None if variant == "ptran" else FCLayer(1024, 512, act=act,
                                                           use_bias=variant == "dgcnn")
        self.mlp2 = FCLayer(512, 256, act=act, use_bias=True)
        self.mlp3 = Dense(256, num_class)  # no dtype: f32 logits from bf16 features
        self.dropout_rate = dropout_rate

    def dropout(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        return dropout(x, self.dropout_rate, self.training, generator)

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.mlp1 is not None:
            x = self.dropout(self.mlp1(x), generator)
        mid_feature = self.mlp2(x)
        logits = self.mlp3(self.dropout(mid_feature, generator))
        return logits, mid_feature


class KPConvHead(nn.Module):
    """KPConv's head in the DG model: ``mlp1`` 256 (the mid feature, before
    its relu) -> ``mlp2`` 64, relu -> ``mlp3`` to ``num_class``, all biased,
    no dropout. ``forward(x, generator=None)`` returns (logits,
    mid_feature); ``in_features`` is the generator's width (1024)."""

    def __init__(self, num_class: int = 10, in_features: int = 1024):
        super().__init__()
        self.mlp1 = Dense(in_features, 256)
        self.mlp2 = Dense(256, 64)
        self.mlp3 = Dense(64, num_class)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        mid_feature = self.mlp1(x)
        x = torch.relu(self.mlp2(torch.relu(mid_feature)))
        return self.mlp3(x), mid_feature
