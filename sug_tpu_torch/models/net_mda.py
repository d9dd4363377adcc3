"""NetMDA, the twin-head DG model: counterpart of
``sug_tpu/models/net_mda.py`` for ``model_name`` "DGCNN", "PTran",
"Pointnet", "Pointnet2" and "KPConv" (on either pyramid, rigid or
deformable, with the two ``KPConvHead``s), in eval and train mode: the
per-domain forward, the stacked both-domains forward (``domain="stacked"``)
and the gradient-reversal layer. ``set_compute_dtype`` sets the bf16 policy
(``models/precision.py``) on DGCNN, PTran and Pointnet; Pointnet2 and
KPConv refuse it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from sug_tpu_torch.models.dgcnn import DGCNNGenerator
from sug_tpu_torch.models.kpconv import KPConvGenerator, init_kpconv_weights_
from sug_tpu_torch.models.heads import ClassifierHead, KPConvHead
from sug_tpu_torch.models.bn import stacked_bn
from sug_tpu_torch.models.layers import CALayer, flax_init_, grad_reverse
from sug_tpu_torch.models.pointnet import PointNetGenerator
from sug_tpu_torch.models.pointnet2 import PointNet2Generator
from sug_tpu_torch.models.precision import set_compute_dtype
from sug_tpu_torch.models.ptran import PointTransformerGenerator

DOMAINS = (None, "source", "target", "both")
BACKBONES = ("DGCNN", "PTran", "Pointnet", "Pointnet2", "KPConv")
# the classifier-head variant of each backbone but KPConv (KPConvHead)
HEAD_VARIANTS = {"DGCNN": "dgcnn", "PTran": "ptran", "Pointnet": "relu", "Pointnet2": "relu"}


class NetMDA(nn.Module):
    """Generator ``g`` + twin heads ``c1``/``c2`` + per-domain channel
    attention ``attention_s``/``attention_t``.

    ``forward`` returns a dict: logits1, logits2 (B, num_class); sem1, sem2
    (B, 256); global_feat (B, 1024 for DGCNN, Pointnet and Pointnet2, 512
    for PTran); node_flat (B, 64*64), flattened node-major (on KPConv's
    FPS pyramid below 256 points, (B, max(N // 4, 4)·64)); node_offset (None
    for PTran and Pointnet2); node_attn (domain 'source' or 'target') or
    node_attn and node_attn_t (domain 'both'); and, for a KPConv with
    deformable blocks, regularizers: its ops' terms for
    ``kpconv.p2p_fitting_regularizer`` (2B rows in the stacked forward).

    ``domain="stacked"`` takes ``concat(source, target)`` (2B clouds) and
    runs the generator once over it, its BNs in the 2-group sequential
    regime (``bn.stacked_bn``), so each half is normalised by its own
    statistics and the running stats are updated source then target, as two
    per-domain forwards would. ``attention_s`` takes the source half and
    ``attention_t`` the target half (node_attn, node_attn_t, B rows each);
    the heads run once over the 2B rows. Every other output has 2B rows.

    ``grl_constant`` λ (None: off) reverses the gradient of the global
    feature before the heads, ``−λ·g``; in the stacked forward only the
    target half's, as the reference applies it to the target forward.

    ``num_points`` sizes PTran's ``point_mix`` and, on KPConv's FPS
    pyramid, the attentions (flax sizes both at the first call); DGCNN,
    Pointnet and KPConv's grid pyramid take any cloud size, Pointnet2 any
    from 512 points (its first FPS takes 512). ``model_cfg`` is KPConv's
    MODEL_CFG (other backbones ignore it, as in the JAX package).
    ``fps_start`` (B,) starts the first FPS (index 0 when None; KPConv's
    grid pyramid has none); ``generator`` draws the heads' dropout masks in
    train mode. The constructor's ``generator`` (CPU) draws the initial
    weights.
    """

    def __init__(self, model_name: str = "DGCNN", num_class: int = 10,
                 generator: Optional[torch.Generator] = None, num_points: int = 1024,
                 model_cfg=None):
        super().__init__()
        if model_name not in BACKBONES:
            raise NotImplementedError(
                f"NetMDA({model_name!r}) is not ported yet; the port's backbones are "
                "queued in ROADMAP.md under 'Modules to port'"
            )
        self.model_name = model_name
        node_rows, node_width = 64, 64  # node_fea is (B, node_rows, node_width)
        if model_name == "KPConv":
            self.g = KPConvGenerator(model_cfg)
            node_rows, node_width = self.g.node_rows(num_points), self.g.encoder.tap_dim
            self.c1 = KPConvHead(num_class, self.g.encoder.out_dim)
            self.c2 = KPConvHead(num_class, self.g.encoder.out_dim)
        else:
            if model_name == "DGCNN":
                self.g = DGCNNGenerator()
            elif model_name == "Pointnet":
                self.g = PointNetGenerator()
            elif model_name == "Pointnet2":
                self.g = PointNet2Generator()
            else:
                self.g = PointTransformerGenerator(num_points)
            self.c1 = ClassifierHead(num_class, HEAD_VARIANTS[model_name])
            self.c2 = ClassifierHead(num_class, HEAD_VARIANTS[model_name])
        self.attention_s = CALayer(node_rows * node_width)
        self.attention_t = CALayer(node_rows * node_width)
        flax_init_(self, generator)
        init_kpconv_weights_(self, generator)

    def set_compute_dtype(self, dtype: Optional[torch.dtype]) -> "NetMDA":
        """The compute dtype of every layer that follows the policy: None
        (f32) or ``torch.bfloat16``."""
        set_compute_dtype(self, dtype)
        return self

    def forward(
        self,
        pc: torch.Tensor,
        domain: Optional[str] = None,
        fps_start: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        grl_constant: Optional[float] = None,
    ) -> Dict[str, torch.Tensor]:
        if domain == "stacked":
            return self._stacked(pc, fps_start, generator, grl_constant)
        if domain not in DOMAINS:
            raise ValueError(f"domain must be one of {DOMAINS + ('stacked',)}, got {domain!r}")
        out: Dict[str, torch.Tensor] = {}
        feat, node_fea, node_off = self._generate(pc, fps_start, out)
        node_flat = node_fea.reshape(feat.shape[0], -1)
        out.update(node_flat=node_flat, node_offset=node_off)
        if domain in ("source", "both"):
            out["node_attn"] = self.attention_s(node_flat)
        if domain in ("target", "both"):
            out["node_attn_t" if domain == "both" else "node_attn"] = self.attention_t(node_flat)
        if grl_constant is not None:
            feat = grad_reverse(feat, grl_constant)
        return self._heads(feat, out, generator)

    def _generate(self, pc, fps_start, out):
        """The generator's (feat, node_fea, node_offset); a KPConv's
        regularizer terms, where it has deformable ops, go to
        ``out["regularizers"]``."""
        if self.model_name != "KPConv":
            return self.g(pc, fps_start)
        terms: list = []
        feats = self.g(pc, fps_start, terms)
        if terms:
            out["regularizers"] = terms
        return feats

    def _stacked(self, pc, fps_start, generator, grl_constant) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        with stacked_bn(self.g):
            feat, node_fea, node_off = self._generate(pc, fps_start, out)
        B = feat.shape[0] // 2
        node_flat = node_fea.reshape(2 * B, -1)
        out.update(node_flat=node_flat, node_offset=node_off,
                   node_attn=self.attention_s(node_flat[:B]),
                   node_attn_t=self.attention_t(node_flat[B:]))
        if grl_constant is not None:
            feat = torch.cat([feat[:B], grad_reverse(feat[B:], grl_constant)])
        return self._heads(feat, out, generator)

    def _heads(self, feat, out, generator) -> Dict[str, torch.Tensor]:
        logits1, sem1 = self.c1(feat, generator)
        logits2, sem2 = self.c2(feat, generator)
        out.update(logits1=logits1, logits2=logits2, sem1=sem1, sem2=sem2, global_feat=feat)
        return out


def ensemble_logits(model: NetMDA, pc: torch.Tensor) -> torch.Tensor:
    """The twin-head DG ensemble ``(logits1 + logits2) / 2`` used to classify."""
    out = model(pc)
    return (out["logits1"] + out["logits2"]) / 2.0
