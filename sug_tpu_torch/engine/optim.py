"""Group Adam: counterpart of ``sug_tpu/engine/optim.py`` and of the optax
chains of the source and alternating trainers.

The reference steps three Adam optimizers back to back from one backward
pass, over overlapping parameter groups:

- ``g``: the generator (``g.``) except ``pred_offset``, lr = cosine LR;
- ``c``: both classifier heads (``c1.``, ``c2.``), lr = cosine LR;
- ``dis``: the generator and both attention layers (``g.``,
  ``attention_s.``, ``attention_t.``), lr = LR·scaler with its step decay.

An Adam step depends only on the gradient and its own moments, so the three
steps are the sum of three deltas computed from the same gradients. Each
group keeps its own moments for every parameter (masked-out parameters
included, as ``optax`` does) and computes ``g + wd·p`` on every parameter,
BN and LayerNorm scales included (``optax.add_decayed_weights``); the
generator's parameters take two deltas (the reference's double update).

The DG trainer steps the three groups together (``update``). The
alternating trainer steps them one at a time (``step``), each on its own
phase's gradient, as the JAX package keeps three optax states; the source
trainer has one group over every parameter.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Sequence, Tuple

import torch

GROUPS = ("g", "c", "dis")
BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-8


def param_group_masks(names: Sequence[str]) -> Dict[str, List[bool]]:
    """For each group, one bool per parameter name (the port's
    ``named_parameters`` names)."""
    parts = [name.split(".") for name in names]
    return {
        "g": [p[0] == "g" and "pred_offset" not in p for p in parts],
        "c": [p[0] in ("c1", "c2") for p in parts],
        "dis": [p[0] in ("g", "attention_s", "attention_t") for p in parts],
    }


class GroupAdam:
    """Adam (betas 0.9/0.999, eps 1e-8) with L2 weight decay added to the
    gradient, over named groups of parameters (``masks``: one bool per
    parameter for each group), as the JAX package chains
    ``add_decayed_weights`` and ``scale_by_adam`` and applies ``-lr·u``.
    ``step`` takes the gradients in the order of ``named_params`` and the
    learning rate of each group it steps: those groups advance their moments
    of every parameter and their count, and move the parameters of their
    mask; a group it is not given keeps its moments and its count."""

    def __init__(self, named_params: Sequence[Tuple[str, torch.Tensor]], weight_decay: float,
                 masks: Mapping[str, Sequence[bool]]):
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.weight_decay = float(weight_decay)
        self.masks = {group: list(mask) for group, mask in masks.items()}
        self.state = {
            group: {
                "mu": [torch.zeros_like(p) for p in self.params],
                "nu": [torch.zeros_like(p) for p in self.params],
                "count": 0,
            }
            for group in self.masks
        }

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], lrs: Mapping[str, float]) -> None:
        """Apply one step of the groups in ``lrs`` to the parameters in
        place; the weight decay reads the parameters as they are now."""
        unknown = set(lrs) - set(self.masks)
        if unknown:
            raise KeyError(f"no parameter group {sorted(unknown)}")
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, self.params)]
        decayed = torch._foreach_add(grads, self.params, alpha=self.weight_decay)
        decayed_sq = torch._foreach_mul(decayed, decayed)
        total = [None] * len(self.params)
        for group in self.masks:
            if group not in lrs:
                continue
            lr, st = lrs[group], self.state[group]
            torch._foreach_mul_(st["mu"], BETA1)
            torch._foreach_add_(st["mu"], decayed, alpha=1.0 - BETA1)
            torch._foreach_mul_(st["nu"], BETA2)
            torch._foreach_add_(st["nu"], decayed_sq, alpha=1.0 - BETA2)
            st["count"] += 1
            # optax's bias corrections, 1 - beta**count, in f32
            count = torch.tensor(float(st["count"]), dtype=torch.float32)
            bc1 = float(1.0 - torch.tensor(BETA1, dtype=torch.float32) ** count)
            bc2 = float(1.0 - torch.tensor(BETA2, dtype=torch.float32) ** count)
            denom = torch._foreach_div(st["nu"], bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, ADAM_EPS)
            step = torch._foreach_div(st["mu"], bc1)
            torch._foreach_div_(step, denom)
            for i, on in enumerate(self.masks[group]):
                if on:
                    delta = step[i] * (-lr)
                    total[i] = delta if total[i] is None else total[i] + delta
        for p, delta in zip(self.params, total):
            if delta is not None:
                p.add_(delta)

    def state_dict(self) -> Dict:
        return {
            group: {
                "mu": {n: t.detach().cpu() for n, t in zip(self.names, st["mu"])},
                "nu": {n: t.detach().cpu() for n, t in zip(self.names, st["nu"])},
                "count": st["count"],
            }
            for group, st in self.state.items()
        }

    def load_state_dict(self, sd: Dict) -> None:
        if set(sd) != set(self.masks):
            raise KeyError(f"optimizer state of groups {sorted(sd)}, expected {sorted(self.masks)}")
        for group, st in self.state.items():
            for key in ("mu", "nu"):
                if set(sd[group][key]) != set(self.names):
                    raise KeyError(f"optimizer state {group}/{key} does not match the parameters")
                for t, name in zip(st[key], self.names):
                    t.copy_(sd[group][key][name])
            st["count"] = int(sd[group]["count"])


class ThreeGroupOptimizer(GroupAdam):
    """The three groups of ``param_group_masks``, stepped together from one
    gradient by ``update`` (the DG trainer) or one at a time by ``step``
    (the alternating trainer)."""

    def __init__(self, named_params: Sequence[Tuple[str, torch.Tensor]], weight_decay: float):
        super().__init__(named_params, weight_decay,
                         param_group_masks([n for n, _ in named_params]))

    def update(self, grads: Sequence[torch.Tensor], lr_g: float, lr_c: float, lr_dis: float) -> None:
        """One step of all three groups, at their three learning rates."""
        self.step(grads, dict(zip(GROUPS, (lr_g, lr_c, lr_dis))))


def cosine_lr(base_lr: float, epoch: int, max_epochs: int) -> float:
    """torch CosineAnnealingLR with eta_min=0, stepped per epoch."""
    return base_lr * (1.0 + math.cos(math.pi * epoch / max_epochs)) / 2.0


def dis_lr_schedule(base_lr: float, scaler: float, epoch: int) -> float:
    """The dis group's decay: halve every 5 epochs up to epoch 30, then every
    10; epoch 0 keeps LR·scaler."""
    if epoch <= 0:
        return base_lr * scaler
    if epoch <= 30:
        return base_lr * scaler * (0.5 ** (epoch // 5))
    return base_lr * scaler * (0.5 ** (epoch // 10))
