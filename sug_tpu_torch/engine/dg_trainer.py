"""The SUG DG trainer: counterpart of ``sug_tpu/engine/dg_trainer.py``.

One step: augmentation, the source and the target forward of ``NetMDA``
(the BN running stats flow from one to the next through the module
buffers), every loss, one backward, and the fused three-group update.
The two forwards are one stacked forward over ``concat(source, target)``
when ``SUG_STACKED_FORWARD=1`` (``NetMDA(domain="stacked")``: 2-group BN in
the generator, numerically the sequential forwards' up to rounding, the
head dropout drawn once over 2B rows); ``SUG_STACKED_FORWARD=0`` or unset
keeps the sequential forwards for the three ported backbones. BN groups
(``MODEL_CFG.BN_SEMANTICS: per_replica`` or ``SUG_BN_GROUPS``) are read once,
at construction, and set on the model's BNs; with groups the forward stays
sequential. ``METHODS.GRL`` reverses the target forward's gradient into the
generator by the λ that ``train_step`` is given.

Loss semantics, as in the JAX package:
- cls: 0.5·crit(head 1) + 0.5·crit(head 2) on the source batch;
- adv: −ADV_WEIGHT · discrepancy(target heads), added after the average;
- TARGET_LOSS > 0: the target split's own cross terms (its own labels
  unless ``TARGET_LOSS_USES_SOURCE_LABELS``), else SRC_LOSS_WEIGHT · cls;
- geo MMD on the attended 4096-d node features with chamfer SDA weights;
- sem MMD on the two heads' 256-d mid features with KL SDA weights;
- either alignment as the cosine contrastive loss instead (``NAME: CL``);
- PURE_CLS_EPOCH gating through ``mmd_on``.

Precision: the bf16 policy (``PRECISION: bf16`` at the top level or under
``OPTIMIZATION``, or ``SUG_PRECISION=bf16``, ``models/precision.py``) is
read once, at construction, and set on the model: the Dense layers of the
ConvBNs, FCLayers and CALayers compute in bf16, their norms take f32
statistics, the EdgeConv kernels run in ``values_bf16`` mode, and the
params, their gradients and the optimizer's moments stay f32. The heads'
logits are f32; their 256-d mid features are bf16, as in the JAX package,
and so is what the sem alignments other than ``SOFT_MMD`` compute from them.

``model_name`` is "DGCNN", "PTran", "Pointnet" or "Pointnet2"; PTran's
vector attention runs its bf16 mode under the policy, and Pointnet2 refuses
the policy (``NotImplementedError``). What the port does not have yet
(KPConv, with its regularizer) raises ``NotImplementedError`` naming
ROADMAP.md.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Optional, Tuple

import torch

from sug_tpu_torch import resolve_device
from sug_tpu_torch.engine.optim import ThreeGroupOptimizer
from sug_tpu_torch.losses.classification import cross_entropy, discrepancy, focal_loss
from sug_tpu_torch.losses.mmd import PORTED_MMD, contrastive_loss_weighted, mmd_cal
from sug_tpu_torch.models.bn import configure_from_cfg, set_bn_groups
from sug_tpu_torch.models.net_mda import BACKBONES, NetMDA, ensemble_logits
from sug_tpu_torch.models.precision import compute_dtype
from sug_tpu_torch.ops.augment import augment_batch

# backbones whose default is the stacked forward (the JAX package's
# _STACKED_DEFAULT_ON: none of the three ported ones)
_STACKED_DEFAULT_ON: tuple = ()


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet; it is queued in ROADMAP.md")


def make_criterion(opt_cfg, source_dataset=None, num_class: int = 10, device="cpu"):
    """The classification loss from the OPTIMIZATION config: FocalLoss,
    ClassWeighting (focal with gamma 0 and class weights) or cross entropy.
    The class weights are placed on ``device`` once."""
    name = opt_cfg.get("CLS_LOSS", "CrossEntropyLoss")
    if name == "FocalLoss":
        alpha = None
        if opt_cfg.get("CLS_WEIGHT", None) and source_dataset is not None:
            alpha = torch.as_tensor(source_dataset.cls_wights(weighting=opt_cfg["CLS_WEIGHT"]),
                                    device=device)
        return functools.partial(focal_loss, gamma=float(opt_cfg["FOCAL_GAMMA"]), alpha=alpha,
                                 num_classes=num_class)
    if name == "ClassWeighting":
        if not opt_cfg.get("CLS_WEIGHT", None):
            raise RuntimeError("When setting ClassWeighting, CLS_WEIGHT should be provided")
        alpha = source_dataset.cls_wights(weighting=opt_cfg["CLS_WEIGHT"], q_=opt_cfg.get("DLSA_Q", None))
        return functools.partial(focal_loss, gamma=0.0, alpha=torch.as_tensor(alpha, device=device),
                                 num_classes=num_class)
    return cross_entropy


def check_supported(cfg, model_name: str) -> None:
    """Raise for config keys whose paths the port does not have yet, and,
    as the JAX package does, for a malformed BN config or an alignment
    name the trainer does not know."""
    methods = cfg["METHODS"]
    if model_name not in BACKBONES:
        raise _not_ported(f"Model {model_name!r} (the port trains {', '.join(BACKBONES)}; "
                          "the other backbones)")
    compute_dtype(cfg)  # an unknown PRECISION name raises ValueError
    configure_from_cfg(cfg)
    for key in ("GEO_MMD", "SEM_MMD"):
        if key in methods and methods[key][0]["NAME"] not in PORTED_MMD:
            raise ValueError(f"Not supported MMD method {methods[key][0]['NAME']} "
                             f"(METHODS.{key})")


def stacked_forward(model_name: str) -> bool:
    """``SUG_STACKED_FORWARD`` 1 or 0, else the backbone's default."""
    env = os.environ.get("SUG_STACKED_FORWARD")
    if env in ("0", "1"):
        return env == "1"
    return model_name in _STACKED_DEFAULT_ON


class DGTrainer:
    """Owns the ``NetMDA`` model on ``device``, the fused optimizer and the
    trainer's generator, which draws the augmentation, the FPS starts and
    the dropout masks. ``seed`` seeds the initial weights (drawn on the CPU,
    so the same on every device) and the generator. ``num_points`` is the
    cloud size a PTran model is built for (its ``point_mix``); DGCNN and
    Pointnet take any, Pointnet2 any from 512. ``bn_groups`` is the BN group count the config asked
    for, set on every BN of the model, and ``compute_dtype`` the precision
    policy's (None: f32; ``torch.bfloat16``), set on its layers."""

    def __init__(self, cfg, model_name: str = "DGCNN", num_class: int = 10, criterion=None,
                 augment: bool = True, device="cuda", seed: int = 0, num_points: int = 1024):
        check_supported(cfg, model_name)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.num_class = num_class
        self.criterion = criterion or cross_entropy
        self.augment = augment
        model = NetMDA(model_name, num_class, generator=torch.Generator().manual_seed(seed),
                       num_points=num_points)
        self.model = model.to(self.device)
        self.model_name = model_name
        self.bn_groups = configure_from_cfg(cfg)
        set_bn_groups(self.model, self.bn_groups)
        self.compute_dtype = compute_dtype(cfg)
        self.model.set_compute_dtype(self.compute_dtype)
        self.grl = bool(cfg["METHODS"].get("GRL", False))
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.params = list(self.model.named_parameters())
        wd = float(cfg["OPTIMIZATION"]["WEIGHT_DECAY"])
        self.optimizer = ThreeGroupOptimizer(self.params, wd)

    def _forward_both(self, data_s, data_t, fps_s, fps_t, train: bool, grl_const: float = 0.0):
        """Source then target forward, or one stacked forward (as
        ``stacked_forward`` says, and only without BN groups), as the
        sequential contract's two dicts. ``train=False`` is deterministic: BN
        running stats (left unchanged), no dropout, and FPS from the given
        starts (index 0 when None). With GRL on, the target forward reverses
        its gradient by ``grl_const``."""
        self.model.train(train)
        grl = grl_const if self.grl else None
        if stacked_forward(self.model_name) and self.bn_groups == 1:
            return self._forward_stacked(data_s, data_t, fps_s, fps_t, grl)
        out_s = self.model(data_s, "source", fps_s, self.generator)
        out_t = self.model(data_t, "target", fps_t, self.generator, grl_constant=grl)
        return out_s, out_t

    def _forward_stacked(self, data_s, data_t, fps_s, fps_t, grl):
        """Both domains through one stacked forward, split back into
        ``(out_s, out_t)``."""
        B = data_s.shape[0]
        fps = None if fps_s is None else torch.cat([fps_s, fps_t])
        out = self.model(torch.cat([data_s, data_t]), "stacked", fps, self.generator,
                         grl_constant=grl)

        def half(rows, attn):
            d = {k: out[k][rows] for k in ("logits1", "logits2", "sem1", "sem2", "node_flat",
                                           "global_feat")}
            d["node_offset"] = None if out["node_offset"] is None else out["node_offset"][rows]
            d["node_attn"] = out[attn]
            return d

        return half(slice(0, B), "node_attn"), half(slice(B, 2 * B), "node_attn_t")

    def _align(self, cfg, label_s, feat_s, label_t, feat_t, data_s, data_t) -> torch.Tensor:
        """The alignment ``cfg["NAME"]`` names: the contrastive loss for CL,
        else ``mmd_cal`` with ``data_s``/``data_t`` for the SDA weights."""
        if cfg["NAME"] == "CL":
            return contrastive_loss_weighted(label_s, feat_s, label_t, feat_t)
        return mmd_cal(label_s, feat_s, label_t, feat_t, cfg, data_s=data_s, data_t=data_t,
                       num_class=self.num_class)

    def _loss(self, data_s, label_s, data_t, label_t, fps_s=None, fps_t=None,
              mmd_on: bool = True, train: bool = True,
              grl_const: float = 0.0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total loss, metrics) of one batch pair; in train mode the BN
        running stats are updated in place."""
        methods = self.cfg["METHODS"]
        out_s, out_t = self._forward_both(data_s, data_t, fps_s, fps_t, train, grl_const)
        crit = self.criterion
        loss_s = 0.5 * crit(out_s["logits1"], label_s) + 0.5 * crit(out_s["logits2"], label_s)

        adv_weight = float(methods.get("ADV_WEIGHT", 0.0))
        loss_adv = torch.zeros((), device=data_s.device)
        if adv_weight > 0:
            loss_adv = -adv_weight * discrepancy(out_t["logits1"], out_t["logits2"])
            loss_s = loss_s + loss_adv

        if float(methods.get("TARGET_LOSS", 0.0)) > 0:
            t_labels = label_s if methods.get("TARGET_LOSS_USES_SOURCE_LABELS", False) else label_t
            loss_t = 0.5 * crit(out_t["logits1"], t_labels) + 0.5 * crit(out_t["logits2"], t_labels)
            loss = 0.5 * loss_s + 0.5 * loss_t
        else:
            loss = float(methods.get("SRC_LOSS_WEIGHT", 1.0)) * loss_s
        loss_cls = float(methods.get("CLS_WEIGHT", 1.0)) * loss
        metrics = {"loss_cls": loss_cls, "loss_adv": loss_adv}

        total = loss_cls
        if mmd_on:
            mmd_weight = float(methods["MMD_WEIGHT"])
            geo_cfg = dict(methods["GEO_MMD"][0])
            geo_align = self._align(geo_cfg, label_s, out_s["node_attn"], label_t,
                                    out_t["node_attn"], data_s, data_t)
            loss_geo = mmd_weight * float(geo_cfg.get("GEO_SCALE", 1.0)) * geo_align
            total = total + loss_geo
            metrics["loss_geo"] = loss_geo

            sem_cfg = dict(methods["SEM_MMD"][0])
            sem_scale = float(sem_cfg.get("SEM_SCALE", 1.0))
            if sem_scale > 0:
                l1, l2 = (sem_scale * self._align(sem_cfg, label_s, out_s[f"sem{h}"], label_t,
                                                  out_t[f"sem{h}"], out_s[f"logits{h}"],
                                                  out_t[f"logits{h}"])
                          for h in (1, 2))
                loss_sem = mmd_weight * (0.5 * l1 + 0.5 * l2)
                total = total + loss_sem
                metrics["loss_sem"] = loss_sem
        metrics["loss_total"] = total
        return total, metrics

    def grads(self, total: torch.Tensor):
        """Gradients of ``total`` for every parameter, in the optimizer's order."""
        return torch.autograd.grad(total, [p for _, p in self.params], allow_unused=True)

    def train_step(self, data_s, label_s, data_t, label_t, lr_g: float, lr_c: float,
                   lr_dis: float, mmd_on: bool = True,
                   fps_s: Optional[torch.Tensor] = None,
                   fps_t: Optional[torch.Tensor] = None,
                   grl_const: float = 0.0) -> Dict[str, torch.Tensor]:
        """One training step on (B, N, 3) clouds and (B,) labels (numpy or
        tensors). Augmentation (when on) and, where not given, the FPS starts
        (uniform in [0, N)) are drawn from the trainer's generator;
        ``grl_const`` is the GRL's λ (read only with ``METHODS.GRL``).
        Returns the detached metrics, still on the device."""
        dev = self.device
        data_s, data_t = (torch.as_tensor(d, dtype=torch.float32, device=dev) for d in (data_s, data_t))
        label_s, label_t = (torch.as_tensor(lb, dtype=torch.long, device=dev) for lb in (label_s, label_t))
        if self.augment:
            data_s = augment_batch(data_s, self.generator)
            data_t = augment_batch(data_t, self.generator)
        B, N = data_s.shape[:2]
        if fps_s is None:
            fps_s = torch.randint(0, N, (B,), generator=self.generator, device=dev)
        if fps_t is None:
            fps_t = torch.randint(0, N, (B,), generator=self.generator, device=dev)
        total, metrics = self._loss(data_s, label_s, data_t, label_t, fps_s, fps_t, mmd_on,
                                    train=True, grl_const=grl_const)
        self.optimizer.update(self.grads(total), lr_g, lr_c, lr_dis)
        return {k: v.detach() for k, v in metrics.items()}

    def eval_logits(self, data: torch.Tensor) -> torch.Tensor:
        """The twin-head ensemble logits, in eval mode."""
        return ensemble_logits(self.model.eval(), data)
