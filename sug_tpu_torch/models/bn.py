"""BatchNorm with flax semantics and its grouped per-replica form:
counterpart of ``sug_tpu/models/bn.py``.

Channels-last (normalises the last axis of any rank), eps 1e-5, momentum
0.9. With one group (the default, globally exact statistics) the arithmetic
is that of ``flax.linen.BatchNorm``, written out:

- train mode: the batch mean over every axis but the last, and the biased
  variance ``max(mean(x²) − mean², 0)`` (flax's ``use_fast_variance``);
  the running stats become ``0.9·running + 0.1·batch``, the variance
  biased, without gradient;
- both modes: ``(x − mean) * (rsqrt(var + eps) * scale) + bias``.

With ``groups`` g > 1 it is the JAX package's own grouped ``BatchNorm``
(``bn.py:137-211``): the batch splits into g contiguous groups, each
normalised by its own mean and variance ``mean(x²) − mean²`` (no clamp). The
JAX class computes ``y = (x − mean) * rsqrt(var + eps)`` then ``y * scale +
bias``; here the scale is folded into each group's slope, ``(x − mean) *
(rsqrt(var + eps) * scale) + bias`` as with one group, which rounds
differently by about an ulp and keeps one full-size tensor for the backward
instead of two. Eval mode is the one-group formula on the running stats, as
in the JAX class up to the same rounding. The running stats take
one momentum update with the across-group mean (``momentum_mode="mean"``,
the per-replica emulation of ``MODEL_CFG.BN_SEMANTICS: per_replica``) or
one per group in group order (``"sequential"``: the stacked both-domains
forward, whose two groups are the source and the target half).

The JAX package keeps the group count in process-global state that flax
reads while tracing; here it lives on the modules (``GroupedNorm.groups``),
set by ``set_bn_groups`` and, for the stacked forward, ``stacked_bn``.

Mixed precision (``models/precision.py``): ``forward(x, dtype)`` returns
``dtype``, or, where that is None, the promotion of ``x`` with the f32
params, as flax's ``BatchNorm(dtype=...)`` does. A bf16 ``x`` is normalised
in f32 (statistics, ``x − mean`` and the affine) and the result cast once,
as flax does; in train mode ``_NormLow`` keeps only that bf16 ``x`` for the
backward and recomputes its f32 view there, where autograd over the f32
formula would keep two full-size f32 tensors. An f32 ``x`` takes the f32
arithmetic above bit for bit. The running stats stay f32.
``torch.nn.functional.batch_norm`` is not used: its Welford variance rounds
differently, and its running variance takes the unbiased estimate.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional, Tuple

import torch
from torch import nn

EPS = 1e-5
MOMENTUM = 0.9
MOMENTUM_MODES = ("mean", "sequential")


def batch_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flax's train-mode (mean, biased variance) over every axis but the last."""
    axes = tuple(range(x.dim() - 1))
    mean = torch.mean(x, dim=axes)
    var = torch.clamp(torch.mean(x * x, dim=axes) - mean * mean, min=0.0)
    return mean, var


@torch.no_grad()
def update_running(running_mean: torch.Tensor, running_var: torch.Tensor,
                   mean: torch.Tensor, var: torch.Tensor) -> None:
    """``running = momentum·running + (1 − momentum)·batch``, in place."""
    running_mean.copy_(MOMENTUM * running_mean + (1.0 - MOMENTUM) * mean)
    running_var.copy_(MOMENTUM * running_var + (1.0 - MOMENTUM) * var)


@torch.no_grad()
def update_running_grouped(running_mean: torch.Tensor, running_var: torch.Tensor,
                           mean: torch.Tensor, var: torch.Tensor, momentum_mode: str) -> None:
    """The running stats from per-group (g, C) statistics: one update per
    group in order (``"sequential"``) or one with their mean (``"mean"``)."""
    if momentum_mode == "sequential":
        for i in range(mean.shape[0]):
            update_running(running_mean, running_var, mean[i], var[i])
    else:
        update_running(running_mean, running_var, torch.mean(mean, dim=0), torch.mean(var, dim=0))


def check_groups(batch: int, groups: int) -> None:
    if batch % groups != 0:
        raise ValueError(f"batch {batch} not divisible by {groups} BN replica groups")


class GroupedNorm(nn.Module):
    """A module with BN statistics over ``groups`` contiguous batch groups:
    ``BatchNorm``, and the EdgeConv block, whose BN reads the kernel's sums."""

    def __init__(self):
        super().__init__()
        self.groups = 1
        self.momentum_mode = "mean"


class BatchNorm(GroupedNorm):
    """``weight``/``bias`` are flax's ``scale``/``bias``; ``running_mean``/
    ``running_var`` its ``batch_stats`` ``mean``/``var``."""

    def __init__(self, num_features: int, eps: float = EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        compute = torch.promote_types(x.dtype, self.weight.dtype)
        out = compute if dtype is None else dtype
        if x.dtype != compute:
            return self._low(x, compute, out)
        if self.training and self.groups > 1:
            return self._grouped(x).to(out)
        return self._one_group(x).to(out)

    def _one_group(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var = batch_stats(x)
            update_running(self.running_mean, self.running_var, mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias

    def _grouped(self, x: torch.Tensor) -> torch.Tensor:
        g, B = self.groups, x.shape[0]
        check_groups(B, g)
        xg = x.reshape((g, B // g) + tuple(x.shape[1:]))
        axes = tuple(range(1, xg.dim() - 1))  # all but the group and the channel
        mean = torch.mean(xg, dim=axes)  # (g, C)
        var = torch.mean(xg * xg, dim=axes) - mean * mean
        update_running_grouped(self.running_mean, self.running_var, mean, var, self.momentum_mode)
        shape = (g,) + (1,) * (xg.dim() - 2) + (x.shape[-1],)
        mul = torch.rsqrt(var + self.eps) * self.weight  # each group's slopes
        return ((xg - mean.reshape(shape)) * mul.reshape(shape) + self.bias).reshape(x.shape)

    def _low(self, x: torch.Tensor, compute: torch.dtype, out: torch.dtype) -> torch.Tensor:
        """A lower-precision ``x`` (bf16) normalised in ``compute`` (f32),
        cast to ``out``."""
        if not self.training:
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            return ((x.to(compute) - self.running_mean) * mul + self.bias).to(out)
        y, mean, var = _NormLow.apply(x, self.weight, self.bias, self.groups, self.eps, out)
        if self.groups > 1:
            update_running_grouped(self.running_mean, self.running_var, mean, var,
                                   self.momentum_mode)
        else:
            update_running(self.running_mean, self.running_var, mean[0], var[0])
        return y


class _NormLow(torch.autograd.Function):
    """Train-mode BN of a bf16 ``x`` over ``groups`` contiguous batch groups,
    in the params' f32: statistics ``mean(x)`` and ``mean(x²) − mean²``
    (clamped at 0 with one group, as flax's ``_compute_stats``; not with
    groups, as the JAX grouped class), then ``(x − mean) * (rsqrt(var + eps)
    * scale) + bias`` cast to ``out_dtype``. Returns y and the (g, C) mean
    and variance. The backward is the gradient of that formula, taken in
    f32 from the saved bf16 ``x`` and cast to bf16 once, as JAX casts the
    summed f32 cotangent of ``x.astype(f32)``."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups: int, eps: float, out_dtype):
        check_groups(x.shape[0], groups)
        xg = x.reshape(groups, -1, x.shape[-1]).to(weight.dtype)  # (g, M, C)
        mean = torch.mean(xg, dim=1)
        var = torch.mean(torch.square(xg), dim=1) - mean * mean
        if groups == 1:
            var = torch.clamp(var, min=0.0)
        mul = torch.rsqrt(var + eps) * weight
        y = xg.sub_(mean[:, None]).mul_(mul[:, None]).add_(bias).to(out_dtype).reshape(x.shape)
        ctx.save_for_backward(x, weight, mean, var, mul)
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, var, mul = ctx.saved_tensors
        g, C = mean.shape
        xc = x.reshape(g, -1, C).to(weight.dtype).sub_(mean[:, None])  # x − mean
        m = xc.shape[1]
        dyg = dy.reshape(g, -1, C).to(weight.dtype)
        sum_dy = torch.sum(dyg, dim=1)
        sum_dy_xc = torch.sum(dyg * xc, dim=1)
        rstd = torch.rsqrt(var + ctx.eps)
        dvar = -0.5 * rstd / (var + ctx.eps) * weight * sum_dy_xc  # d rsqrt(var + eps)
        if g == 1:  # the clamp passes no gradient where it bit
            dvar = torch.where(var > 0, dvar, 0.0)
        # dy·mul, the mean's share −Σdy·mul/m, and the variance's 2·dvar·(x − mean)/m
        dx = (dyg * mul[:, None]).add_((-sum_dy * mul / m)[:, None])
        dx.add_(xc.mul_((2.0 / m) * dvar[:, None]))
        return (dx.to(x.dtype).reshape(x.shape), torch.sum(sum_dy_xc * rstd, dim=0),
                torch.sum(sum_dy, dim=0), None, None, None)


def set_bn_groups(module: nn.Module, groups: int, momentum_mode: str = "mean") -> None:
    """Every BN of ``module`` normalises over ``groups`` batch groups."""
    if groups < 1:
        raise ValueError(f"BN groups must be >= 1, got {groups}")
    if momentum_mode not in MOMENTUM_MODES:
        raise ValueError(f"momentum_mode must be one of {MOMENTUM_MODES}, got {momentum_mode!r}")
    for m in module.modules():
        if isinstance(m, GroupedNorm):
            m.groups, m.momentum_mode = int(groups), momentum_mode


@contextlib.contextmanager
def stacked_bn(module: nn.Module) -> Iterator[None]:
    """The stacked-forward regime over ``module``'s BNs: 2 groups (the
    source half, then the target half) with sequential momentum, restored
    on exit. Per-replica groups and the stacked halves would collide, so a
    module whose BNs already have groups raises ``ValueError``."""
    norms = [m for m in module.modules() if isinstance(m, GroupedNorm)]
    if any(m.groups != 1 for m in norms):
        raise ValueError("stacked forward + per-replica BN groups are mutually exclusive "
                         "(grouped-BN group axes would collide)")
    saved = [m.momentum_mode for m in norms]
    try:
        set_bn_groups(module, 2, "sequential")
        yield
    finally:
        for m, mode in zip(norms, saved):
            m.groups, m.momentum_mode = 1, mode


def configure_from_cfg(cfg, devices: int = 1) -> int:
    """The BN group count of ``MODEL_CFG.BN_SEMANTICS``, as the JAX
    package's ``configure_from_cfg`` returns it: without BN_SEMANTICS,
    ``SUG_BN_GROUPS`` when above 1, else 1; ``global``: 1; ``per_replica``:
    ``MODEL_CFG.BN_GROUPS``, or ``devices``. An unknown semantics or a
    MODEL_CFG that is not a mapping raises ``ValueError``."""
    model_cfg = cfg.get("MODEL_CFG", None) if cfg is not None else None
    if model_cfg is not None and not hasattr(model_cfg, "get"):
        raise ValueError(f"MODEL_CFG is not a mapping: {model_cfg!r}")
    sem = model_cfg.get("BN_SEMANTICS", None) if model_cfg is not None else None
    if sem is None:
        env = os.environ.get("SUG_BN_GROUPS", "")
        return int(env) if env.isdigit() and int(env) > 1 else 1
    sem = str(sem).lower()
    if sem == "global":
        return 1
    if sem != "per_replica":
        raise ValueError(f"unknown BN_SEMANTICS {sem!r}")
    groups = model_cfg.get("BN_GROUPS", None)
    groups = int(groups) if groups else max(devices, 1)
    if groups < 1:
        raise ValueError(f"BN groups must be >= 1, got {groups}")
    return groups
