"""The alternating two-phase trainer of the UDA and naive-MMD baselines:
counterpart of ``sug_tpu/engine/alternating_trainer.py``.

One step on a source and a target batch (augmented when ``augment``):

- phase A: ``NetMDA`` with no domain (no channel attention; every FPS
  starts at index 0) on the source batch, then on the target batch, whose
  global feature takes the gradient-reversal layer at λ = ``cons``.
  ``mode="uda"``: ``src_weight·(ce1 + ce2) − discrepancy``;
  ``mode="naive"``: ``0.5·SRC_LOSS_WEIGHT·loss_s − discrepancy +
  0.5·TARGET_LOSS·loss_t`` when ``METHODS.TARGET_LOSS`` > 0 (``loss_t`` on
  the target's own labels unless ``TARGET_LOSS_USES_SOURCE_LABELS``), else
  ``SRC_LOSS_WEIGHT·loss_s − discrepancy``, with ``loss_s = 0.5·ce1 +
  0.5·ce2``. Then the ``g`` group steps at ``lr_g``, and the ``c`` group at
  ``lr_c`` on the parameters ``g`` left;
- phase B, on the parameters and the BN running statistics phase A left:
  ``NetMDA`` with the source domain, then the target domain, both clouds'
  SA-node FPS from one draw of starts; ``mix_rbf_mmd2`` of the two attended
  node features (uda) or ``mmd_cal`` with ``METHODS.CLASS_MMD[0]`` and the
  labels, without sample weights (naive). Only the ``dis`` group steps, at
  ``lr_dis``.

So a step updates the running statistics four times, source and target of
phase A, then of phase B. Each group keeps its own Adam moments
(``GroupAdam.step``): a group that does not step keeps them. Eval
classifies by the twin heads' ensemble. The precision policy and the BN
group count are read once, at construction, from ``cfg``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from sug_tpu_torch import resolve_device
from sug_tpu_torch.engine.optim import ThreeGroupOptimizer
from sug_tpu_torch.losses.classification import cross_entropy, discrepancy
from sug_tpu_torch.losses.mmd import mix_rbf_mmd2, mmd_cal
from sug_tpu_torch.models.bn import configure_from_cfg, set_bn_groups
from sug_tpu_torch.models.net_mda import BACKBONES, NetMDA, ensemble_logits
from sug_tpu_torch.models.precision import compute_dtype
from sug_tpu_torch.ops.augment import augment_batch

MODES = ("uda", "naive")
# the alignments mmd_cal takes (the contrastive loss is the DG trainer's own)
CLASS_MMD_NAMES = ("SOFT_MMD", "HARD_MMD", "MAX_HARD_MMD", "OFF")


class AlternatingTrainer:
    """Owns the ``NetMDA`` model on ``device``, the three-group optimizer and
    the trainer's generator, which draws the augmentation, the FPS starts
    and the dropout masks. ``seed`` seeds the initial weights (drawn on the
    CPU) and the generator; ``num_points`` sizes a PTran model. KPConv's
    ``NetMDA`` is built without MODEL_CFG, as the JAX trainer builds it
    (ROADMAP.md §3, R4). An unknown
    model raises ``NotImplementedError``, an unknown mode or naive-mode
    ``CLASS_MMD`` name ``ValueError``."""

    def __init__(self, model_name: str = "Pointnet", num_class: int = 10, mode: str = "uda",
                 cfg=None, criterion=None, weight_decay: float = 5e-4, src_weight: float = 1.0,
                 augment: bool = True, device="cuda", seed: int = 0, num_points: int = 1024):
        if model_name not in BACKBONES:
            raise NotImplementedError(f"Model {model_name!r} is not ported yet (the port trains "
                                      f"{', '.join(BACKBONES)}); it is queued in ROADMAP.md")
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.cfg = cfg or {}
        self.methods = self.cfg.get("METHODS", {})
        if mode == "naive" and self.methods["CLASS_MMD"][0]["NAME"] not in CLASS_MMD_NAMES:
            raise ValueError(f"Not supported MMD method {self.methods['CLASS_MMD'][0]['NAME']} "
                             "(METHODS.CLASS_MMD)")
        self.device = resolve_device(device)
        self.model_name = model_name
        self.num_class = num_class
        self.mode = mode
        self.criterion = criterion or cross_entropy
        self.src_weight = float(src_weight)
        self.augment = augment
        model = NetMDA(model_name, num_class, generator=torch.Generator().manual_seed(seed),
                       num_points=num_points)
        self.model = model.to(self.device)
        self.bn_groups = configure_from_cfg(self.cfg)
        set_bn_groups(self.model, self.bn_groups)
        self.compute_dtype = compute_dtype(self.cfg)
        self.model.set_compute_dtype(self.compute_dtype)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.params = list(self.model.named_parameters())
        self.optimizer = ThreeGroupOptimizer(self.params, weight_decay)

    def grads(self, loss: torch.Tensor):
        """Gradients of ``loss`` for every parameter, in the optimizer's order."""
        return torch.autograd.grad(loss, [p for _, p in self.params], allow_unused=True)

    def _loss_a(self, data_s, label_s, data_t, label_t, cons: float):
        """Phase A's loss and metrics (train mode, no domain)."""
        crit = self.criterion
        out_s = self.model(data_s, None, None, self.generator)
        out_t = self.model(data_t, None, None, self.generator, grl_constant=cons)
        ce1 = crit(out_s["logits1"], label_s)
        ce2 = crit(out_s["logits2"], label_s)
        loss_adv = -1.0 * discrepancy(out_t["logits1"], out_t["logits2"])
        loss_s = 0.5 * ce1 + 0.5 * ce2
        if self.mode == "uda":
            loss = self.src_weight * (ce1 + ce2) + loss_adv
        else:
            target_weight = float(self.methods.get("TARGET_LOSS", 0.0))
            src_weight = float(self.methods.get("SRC_LOSS_WEIGHT", 1.0))
            if target_weight > 0:
                use_source = self.methods.get("TARGET_LOSS_USES_SOURCE_LABELS", False)
                t_labels = label_s if use_source else label_t
                loss_t = 0.5 * crit(out_t["logits1"], t_labels) + 0.5 * crit(out_t["logits2"],
                                                                            t_labels)
                loss = 0.5 * src_weight * loss_s + loss_adv + 0.5 * target_weight * loss_t
            else:
                loss = src_weight * loss_s + loss_adv
        return loss, {"loss_s": loss_s, "loss_adv": loss_adv}

    def _loss_b(self, data_s, label_s, data_t, label_t, fps):
        """Phase B's node-feature alignment (train mode, per domain)."""
        node_s = self.model(data_s, "source", fps, self.generator)["node_attn"]
        node_t = self.model(data_t, "target", fps, self.generator)["node_attn"]
        if self.mode == "uda":
            return mix_rbf_mmd2(node_s, node_t)
        return mmd_cal(label_s, node_s, label_t, node_t, dict(self.methods["CLASS_MMD"][0]),
                       num_class=self.num_class)

    def train_step(self, data_s, label_s, data_t, label_t, lr_g: float, lr_c: float,
                   lr_dis: float, cons: float = 0.0,
                   fps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One step of both phases on (B, N, 3) clouds and (B,) labels (numpy
        or tensors). ``fps`` (B,) are phase B's FPS starts, drawn uniform in
        [0, N) from the trainer's generator where not given. Returns the
        detached ``loss_s``, ``loss_adv`` and ``loss_node``, still on the
        device."""
        dev = self.device
        data_s, data_t = (torch.as_tensor(d, dtype=torch.float32, device=dev)
                          for d in (data_s, data_t))
        label_s, label_t = (torch.as_tensor(lb, dtype=torch.long, device=dev)
                            for lb in (label_s, label_t))
        if self.augment:
            data_s = augment_batch(data_s, self.generator)
            data_t = augment_batch(data_t, self.generator)
        if fps is None:
            B, N = data_s.shape[:2]
            fps = torch.randint(0, N, (B,), generator=self.generator, device=dev)
        self.model.train()
        loss_a, metrics = self._loss_a(data_s, label_s, data_t, label_t, cons)
        grads = self.grads(loss_a)
        self.optimizer.step(grads, {"g": lr_g})
        self.optimizer.step(grads, {"c": lr_c})
        loss_node = self._loss_b(data_s, label_s, data_t, label_t, fps)
        self.optimizer.step(self.grads(loss_node), {"dis": lr_dis})
        return {**{k: v.detach() for k, v in metrics.items()}, "loss_node": loss_node.detach()}

    def eval_logits(self, data: torch.Tensor) -> torch.Tensor:
        """The twin-head ensemble logits, in eval mode."""
        return ensemble_logits(self.model.eval(), data)
