"""The source-only trainer: counterpart of ``sug_tpu/engine/source_trainer.py``.

One standalone classifier (``models.make_classifier``), one step per batch:
augmentation (z-rotation + jitter), the train-mode forward (head dropout on),
cross entropy, and one Adam step with L2 weight decay over every parameter,
as the JAX package chains ``add_decayed_weights`` and ``scale_by_adam``.

The precision policy (``models/precision.py``) and the BN group count
(``models/bn.py``) are read once, at construction, from ``cfg`` and the
environment, and set on the model. The KPConv classifier takes KPConv's
defaults, as the JAX trainer builds it without MODEL_CFG, so its loss has
no regularizer.
"""

from __future__ import annotations

from typing import Dict

import torch

from sug_tpu_torch import resolve_device
from sug_tpu_torch.engine.optim import GroupAdam
from sug_tpu_torch.losses.classification import cross_entropy
from sug_tpu_torch.models import make_classifier
from sug_tpu_torch.models.bn import configure_from_cfg, set_bn_groups
from sug_tpu_torch.models.precision import compute_dtype, set_compute_dtype
from sug_tpu_torch.ops.augment import augment_batch


class SourceTrainer:
    """Owns the classifier on ``device``, its optimizer and the trainer's
    generator, which draws the augmentation and the dropout masks. ``seed``
    seeds the initial weights (drawn on the CPU, so the same on every
    device) and the generator."""

    def __init__(self, model_name: str = "Pointnet", num_class: int = 10,
                 weight_decay: float = 5e-4, augment: bool = True,
                 device="cuda", seed: int = 0, cfg=None):
        self.device = resolve_device(device)
        self.model_name = model_name
        self.num_class = num_class
        self.criterion = cross_entropy
        self.augment = augment
        model = make_classifier(model_name, num_class, torch.Generator().manual_seed(seed))
        self.model = model.to(self.device)
        self.bn_groups = configure_from_cfg(cfg)
        set_bn_groups(self.model, self.bn_groups)
        self.compute_dtype = compute_dtype(cfg)
        set_compute_dtype(self.model, self.compute_dtype)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.params = list(self.model.named_parameters())
        self.optimizer = GroupAdam(self.params, weight_decay, {"all": [True] * len(self.params)})

    def _loss(self, data: torch.Tensor, label: torch.Tensor):
        """(loss, logits) of one train-mode forward; the BN running stats
        are updated in place."""
        logits, _ = self.model.train()(data, self.generator)
        return self.criterion(logits, label), logits

    def grads(self, loss: torch.Tensor):
        """Gradients of ``loss`` for every parameter, in the optimizer's order."""
        return torch.autograd.grad(loss, [p for _, p in self.params], allow_unused=True)

    def train_step(self, data, label, lr: float) -> Dict[str, torch.Tensor]:
        """One step on (B, N, 3) clouds and (B,) labels (numpy or tensors),
        augmented from the trainer's generator when ``augment``. Returns the
        detached loss and accuracy, still on the device."""
        data = torch.as_tensor(data, dtype=torch.float32, device=self.device)
        label = torch.as_tensor(label, dtype=torch.long, device=self.device)
        if self.augment:
            data = augment_batch(data, self.generator)
        loss, logits = self._loss(data, label)
        self.optimizer.step(self.grads(loss), {"all": lr})
        acc = torch.mean((torch.argmax(logits, dim=-1) == label).float())
        return {"loss": loss.detach(), "acc": acc}

    def eval_logits(self, data: torch.Tensor) -> torch.Tensor:
        """The single head's logits, in eval mode (no ensemble)."""
        return self.model.eval()(data)[0]
