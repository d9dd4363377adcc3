"""Models: the twin-head ``NetMDA`` (``net_mda.py``), the standalone
classifiers of the source-only trainer (``make_classifier``) and their
building blocks."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

CLASSIFIERS = ("DGCNN", "PTran", "Pointnet", "Pointnet2")


def make_classifier(model_name: str, num_class: int = 10,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
    """The standalone classifier of ``model_name``, as the source-only
    trainer and ``infer`` without ``--dg`` build it; ``generator`` (CPU)
    draws its initial Dense kernels. Its ``forward(pc, generator=None)``
    returns (logits, mid_feature). KPConv raises ``NotImplementedError``;
    an unknown name raises it too, as in the JAX package."""
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
        raise NotImplementedError("the KPConv classifier is not ported yet; it is queued in "
                                  "ROADMAP.md (item 17)")
    raise NotImplementedError(f"Unsupported model name {model_name}")
