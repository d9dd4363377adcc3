"""Models: the twin-head ``NetMDA`` (``net_mda.py``), the standalone
classifiers of the source-only trainer (``make_classifier``) and their
building blocks."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

CLASSIFIERS = ("DGCNN", "PTran", "Pointnet", "Pointnet2", "KPConv")


def make_classifier(model_name: str, num_class: int = 10,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
    """The standalone classifier of ``model_name``, as the source-only
    trainer and ``infer`` without ``--dg`` build it; ``generator`` (CPU)
    draws its initial Dense kernels. Its ``forward(pc, generator=None)``
    returns (logits, mid_feature). KPConv's is built with the defaults and
    no MODEL_CFG, as the JAX package builds it (ROADMAP.md §3, R4). An
    unknown name raises ``NotImplementedError``, as in the JAX package."""
    if model_name == "Pointnet":
        from sug_tpu_torch.models.pointnet import PointNetClassifier

        return PointNetClassifier(num_class, generator=generator)
    if model_name == "DGCNN":
        from sug_tpu_torch.models.dgcnn import DGCNNClassifier

        return DGCNNClassifier(num_class, generator=generator)
    if model_name == "PTran":
        from sug_tpu_torch.models.ptran import PointTransformerClassifier

        return PointTransformerClassifier(num_class, generator=generator)
    if model_name == "Pointnet2":
        from sug_tpu_torch.models.pointnet2 import PointNet2Classifier

        return PointNet2Classifier(num_class, generator=generator)
    if model_name == "KPConv":
        from sug_tpu_torch.models.kpconv import KPConvClassifier

        return KPConvClassifier(num_class, generator=generator)
    raise NotImplementedError(f"Unsupported model name {model_name}")
