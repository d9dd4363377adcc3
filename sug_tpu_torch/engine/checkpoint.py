"""Checkpoints: counterpart of ``sug_tpu/engine/checkpoint.py`` for the port.

The port's own checkpoints are ``torch.save`` files holding
``{"state": state_dict, "epoch": int}``. An ``.npz`` of the JAX package's
variables (``params/...`` and ``batch_stats/...`` keys, written from an orbax
checkpoint on the JAX side as the README shows) loads through the weight
bridge. Orbax directories themselves are read only by the JAX package.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from sug_tpu_torch.utils.jax_bridge import load_jax_variables, unflatten


def save_checkpoint(path: str, model: nn.Module, epoch: int) -> str:
    """Write ``model``'s state and ``epoch`` to ``path``; returns the path."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"state": state, "epoch": int(epoch)}, path)
    return path


def load_checkpoint(path: str, model: nn.Module) -> Optional[int]:
    """Fill every tensor of ``model`` from ``path`` (strictly: leftovers on
    either side raise). Returns the saved epoch, or None for an ``.npz`` of
    JAX variables."""
    if str(path).endswith(".npz"):
        with np.load(path) as z:
            load_jax_variables(model, unflatten({k: z[k] for k in z.files}))
        return None
    payload = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(payload["state"], strict=True)
    return int(payload["epoch"])
