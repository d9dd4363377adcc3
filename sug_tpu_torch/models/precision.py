"""The mixed-precision policy: counterpart of ``sug_tpu/models/precision.py``.

``PRECISION: bf16`` in the config (top level, else under ``OPTIMIZATION``)
or ``SUG_PRECISION=bf16`` switches the Dense layers of ``ConvBN``,
``FCLayer``, ``CALayer`` and PTran's ``VectorAttentionBlock`` (its four
projections into the attention) to bfloat16, the EdgeConv kernels to their
``values_bf16`` mode and the vector attention to its bf16 mode (selected by
its bf16 key and val), as the JAX package does with flax's ``dtype=``:

- parameters, gradients and optimizer state stay f32;
- a bf16 Dense casts its input, kernel and bias to bf16 and returns bf16;
  a Dense without a dtype that is handed bf16 features (the T-Net's last,
  the heads' ``mlp3``) promotes them against its f32 params and returns
  f32, as flax's ``promote_dtype`` does;
- BatchNorm and LayerNorm take their statistics and normalise in f32 and
  cast the result to their dtype (bf16 in ``ConvBN`` and ``FCLayer``; the
  promoted f32 where the JAX module sets none);
- neighbour selection stays f32; the EdgeConv kernels gather ``u`` rounded
  to bf16 (``values_bf16``) and return f32 sums.

Names: ``bf16``/``bfloat16`` give bf16; ``f32``/``fp32``/``float32``/``none``
give f32; anything else raises ``ValueError``. ``SUG_PRECISION=bf16`` (or
``bfloat16``) gives bf16 wherever the config does not, an explicit f32
included, as ``compute_dtype()`` reads it in the JAX package.

The JAX package keeps the policy in process-global state that flax reads
while tracing. Here the trainer and ``infer`` read it once
(``compute_dtype``) and set it on the model's modules
(``set_compute_dtype``); ``forward`` reads only the module attribute
``Mixed.compute_dtype``: None (f32, no cast) or ``torch.bfloat16``.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import torch
from torch import nn

_NAMES = {
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "f32": None,
    "fp32": None,
    "float32": None,
    "none": None,
}


def parse_precision(name) -> Optional[torch.dtype]:
    """``torch.bfloat16`` or None (f32) for a PRECISION name; raises
    ``ValueError`` for an unknown one."""
    key = str(name).lower()
    if key not in _NAMES:
        raise ValueError(f"unknown PRECISION {name!r} (use 'bf16' or 'f32')")
    return _NAMES[key]


def compute_dtype(cfg: Optional[Mapping] = None) -> Optional[torch.dtype]:
    """The policy of ``cfg`` and the environment: ``PRECISION`` at the top
    level, else ``OPTIMIZATION.PRECISION``; where that gives f32 or is
    unset, ``SUG_PRECISION=bf16``. Returns ``torch.bfloat16`` or None."""
    prec = None
    if cfg is not None:
        prec = cfg.get("PRECISION", None)
        if prec is None:
            prec = (cfg.get("OPTIMIZATION", None) or {}).get("PRECISION", None)
    dtype = None if prec is None else parse_precision(prec)
    if dtype is None and os.environ.get("SUG_PRECISION", "").lower() in ("bf16", "bfloat16"):
        return torch.bfloat16
    return dtype


class Mixed(nn.Module):
    """A module that computes in the policy's dtype: the counterpart of a
    flax module that passes ``dtype=compute_dtype()`` to its layers."""

    def __init__(self):
        super().__init__()
        self.compute_dtype: Optional[torch.dtype] = None


def set_compute_dtype(module: nn.Module, dtype: Optional[torch.dtype]) -> None:
    """Every ``Mixed`` module of ``module`` computes in ``dtype`` (None: f32).
    bf16 raises ``NotImplementedError`` for a module whose policy is not
    ported yet: one with a ``bf16_queued`` attribute, the ROADMAP.md item
    that queues it."""
    if dtype not in (None, torch.bfloat16):
        raise ValueError(f"the compute dtype is None (f32) or torch.bfloat16, got {dtype}")
    queued = [m for m in module.modules() if getattr(m, "bf16_queued", None)]
    if dtype is not None and queued:
        raise NotImplementedError(f"{type(queued[0]).__name__} under the bf16 policy is not "
                                  f"ported yet; it is queued in ROADMAP.md ({queued[0].bf16_queued})")
    for m in module.modules():
        if isinstance(m, Mixed):
            m.compute_dtype = dtype
