"""Classification losses: counterpart of ``sug_tpu/losses/classification.py``.

Cross entropy, focal / class-weighted cross entropy, the per-class weights
(host-side numpy) and the two-head discrepancy.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as Fn


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    """Softmax cross entropy with integer labels; ``reduction="none"`` gives
    the per-sample terms whose mean the default returns."""
    return Fn.cross_entropy(logits.float(), labels.long(), reduction=reduction)


def focal_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    gamma: float = 2.0,
    alpha: Optional[torch.Tensor] = None,
    num_classes: int = 10,
) -> torch.Tensor:
    """``-alpha_y · (1 − p_y)^gamma · log p_y``, mean over the batch. alpha
    defaults to 1/C per class, so gamma=0 is cross entropy times 1/C, as in
    the JAX package."""
    if alpha is None:
        alpha = torch.full((num_classes,), 1.0 / num_classes, device=logits.device)
    else:
        alpha = torch.as_tensor(alpha, dtype=torch.float32, device=logits.device)
    labels = labels.long()
    logp_y = torch.gather(torch.log_softmax(logits, dim=-1), -1, labels[:, None])[:, 0]
    p_y = torch.exp(logp_y)
    loss = -alpha[labels] * (1.0 - p_y) ** gamma * logp_y
    return torch.mean(loss)


def class_weights(
    cls_counts: Sequence[int],
    weighting: str = "number_inverse",
    q: Union[float, str, None] = None,
    adaptive_q: bool = False,
) -> np.ndarray:
    """Per-class alpha weights from training-set class counts, normalised to
    sum to 1: ``number_inverse`` (1/n_c), ``exp_inverse`` (exp(−n_c/total))
    or ``DLSA`` (n_c^−q, q fixed (0.4 by default) or, with ``adaptive_q`` or
    a string q, the sym-KL between the class distribution and uniform).
    A class with zero count gets weight 0; any other name gives uniform 1/C.
    """
    counts = np.asarray(cls_counts, dtype=np.float64)
    present = counts > 0
    total = counts.sum()
    safe = np.where(present, counts, 1.0)

    def _norm(w: np.ndarray) -> np.ndarray:
        w = np.where(present, w, 0.0)
        return (w / w.sum()).astype(np.float32)

    if weighting == "number_inverse":
        return _norm(1.0 / safe)
    if weighting == "exp_inverse":
        return _norm(np.exp(-counts / total))
    if weighting == "DLSA":
        if adaptive_q or isinstance(q, str):
            n_present = int(present.sum())
            uni = np.full(n_present, 1.0 / n_present)
            cur = counts[present] / total

            def kl(x, y):  # scipy's kl_div, with its x = 0 -> y convention
                return np.where(x > 0, x * np.log(np.where(x > 0, x, 1.0) / y) - x + y, y)

            q_val = float(np.sum(0.5 * kl(cur, uni) + 0.5 * kl(uni, cur)))
        else:
            q_val = 0.4 if q is None else float(q)
        return _norm(safe ** (-q_val))
    return np.full(len(counts), 1.0 / len(counts), dtype=np.float32)


def discrepancy(out1: torch.Tensor, out2: torch.Tensor) -> torch.Tensor:
    """Mean ``|softmax(out1) − softmax(out2)|``, the adversarial two-head term."""
    return torch.mean(torch.abs(torch.softmax(out1, dim=-1) - torch.softmax(out2, dim=-1)))
