"""Checkpoints: counterpart of ``sug_tpu/engine/checkpoint.py`` for the port.

The port's own checkpoints are ``torch.save`` files holding
``{"state": state_dict, "epoch": int}`` and, from the trainer, the
optimizer's moments and step counts (``"optimizer"``) and any ``"extra"``.
An ``.npz`` of the JAX package's variables (``params/...`` and
``batch_stats/...`` keys, written from an orbax checkpoint on the JAX side
as the README shows) loads through the weight bridge. Orbax directories
themselves are read only by the JAX package.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from sug_tpu_torch.utils.jax_bridge import load_jax_variables, unflatten


def save_checkpoint(path: str, model: nn.Module, epoch: int, optimizer=None,
                    extra: Optional[Dict] = None) -> str:
    """Write ``model``'s state, ``epoch`` and, when given, the optimizer's
    state and ``extra`` to ``path``; returns the path."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {"state": {k: v.detach().cpu() for k, v in model.state_dict().items()},
               "epoch": int(epoch)}
    if optimizer is not None:
        payload["optimizer"] = optimizer.state_dict()
    if extra:
        payload["extra"] = extra
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)  # a reader never sees a half-written file
    return path


def load_checkpoint(path: str, model: nn.Module, optimizer=None) -> Optional[int]:
    """Fill every tensor of ``model`` (and, when given, the optimizer's
    state) from ``path``, strictly: leftovers on either side raise. Returns
    the saved epoch, or None for an ``.npz`` of JAX variables."""
    if str(path).endswith(".npz"):
        if optimizer is not None:
            raise ValueError(f"{path}: an .npz of JAX variables holds no optimizer state")
        with np.load(path) as z:
            load_jax_variables(model, unflatten({k: z[k] for k in z.files}))
        return None
    payload = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(payload["state"], strict=True)
    if optimizer is not None:
        if "optimizer" not in payload:
            raise KeyError(f"{path} holds no optimizer state")
        optimizer.load_state_dict(payload["optimizer"])
    return int(payload["epoch"])


def save_train_checkpoint(ckpt_dir: str, source: str, epoch: int, model: nn.Module, optimizer,
                          max_ckpt_save_num: int = 50) -> str:
    """``<ckpt_dir>/<source>_checkpoint_epoch_<epoch>.pt``, after removing
    the oldest (by mtime) periodic checkpoints beyond ``max_ckpt_save_num - 1``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    existing = sorted(glob.glob(os.path.join(ckpt_dir, "*_checkpoint_epoch_*.pt")),
                      key=os.path.getmtime)
    for old in existing[:max(0, len(existing) - max_ckpt_save_num + 1)]:
        os.remove(old)
    path = os.path.join(ckpt_dir, f"{source}_checkpoint_epoch_{epoch}.pt")
    return save_checkpoint(path, model, epoch, optimizer)
