"""Classification losses: counterpart of ``sug_tpu/losses/classification.py``.
Only ``cross_entropy`` is ported so far; focal loss, class weights and the
discrepancy loss come with the training slice (ROADMAP.md)."""

from __future__ import annotations

import torch
import torch.nn.functional as Fn


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    """Softmax cross entropy with integer labels; ``reduction="none"`` gives
    the per-sample terms whose mean the default returns."""
    return Fn.cross_entropy(logits.float(), labels.long(), reduction=reduction)
