"""Shared building blocks: counterparts of ``sug_tpu/models/layers.py``.

Dense layers act on the last axis (channels-last), as flax's ``nn.Dense``.
Submodule names follow the JAX tree, with flax's auto-names renamed
(``Dense_0`` -> ``dense0``, ``Dense_1`` -> ``dense1``, ``BatchNorm_0`` ->
``bn``, ``LayerNorm_0`` -> ``ln``, ``ConvBN_i`` -> ``convbni``, ``FCLayer_i``
-> ``fci``; see ``utils/jax_bridge.py``).

Under the bf16 policy (``models/precision.py``) ``ConvBN``, ``FCLayer`` and
``CALayer`` are the modules whose flax counterparts pass
``dtype=compute_dtype()``: their Dense layers, ``ConvBN``'s BatchNorm and
``FCLayer``'s LayerNorm return bf16 (the norms from f32 statistics), and
``CALayer`` gates in f32 and keeps its BatchNorm at the promoted f32. Every
other Dense promotes its input against its f32 params (``Dense``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as Fn
from torch import nn

from sug_tpu_torch.models.bn import BatchNorm
from sug_tpu_torch.models.precision import Mixed


def flax_init_(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Initialise every ``nn.Linear`` in ``module`` as flax's ``nn.Dense``
    is: kernel ``lecun_normal`` (a normal of variance 1/fan_in truncated at
    two standard deviations), bias zeros. Torch's default (uniform, variance
    1/(3 fan_in)) shrinks activations layer by layer, and a random DGCNN
    then gives nearly the same logits for every cloud. ``generator`` (a CPU
    generator) draws the kernels; None uses torch's global one."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            # flax divides by the truncated normal's own stddev, 0.8796...
            std = m.in_features**-0.5 / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, std=std, a=-2.0 * std, b=2.0 * std,
                                  generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)


class Dense(nn.Linear):
    """``nn.Linear`` with flax ``nn.Dense``'s dtype rule: with ``dtype`` the
    input, kernel and bias are cast to it; without, to their common type,
    so a bf16 input against the f32 params computes in f32. The params stay
    f32 either way. The bias add is fused into the product, which rounds
    once after its f32 sums; flax adds the bias as a second op, which XLA
    fuses on the TPU and rounds again where it does not."""

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        dtype = torch.promote_types(x.dtype, self.weight.dtype) if dtype is None else dtype
        bias = None if self.bias is None else self.bias.to(dtype)
        return Fn.linear(x.to(dtype), self.weight.to(dtype), bias)


def activation(x: torch.Tensor, name: str, negative_slope: float = 0.01) -> torch.Tensor:
    if name == "relu":
        return torch.relu(x)
    if name == "leakyrelu":
        return Fn.leaky_relu(x, negative_slope=negative_slope)
    if name == "tanh":
        return torch.tanh(x)
    raise ValueError(f"unknown activation {name}")


class ConvBN(Mixed):
    """Dense (biased) + BatchNorm + activation (leaky slope 0.01), the
    reference's ``conv_2d``; both layers in the compute dtype."""

    def __init__(self, in_features: int, features: int, act: str = "relu"):
        super().__init__()
        self.act = act
        self.dense0 = Dense(in_features, features)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return activation(self.bn(self.dense0(x, dt), dt), self.act)


class FCLayer(Mixed):
    """Dense + LayerNorm (eps 1e-5) + activation (leaky slope 0.2), the
    reference's ``fc_layer``; the LayerNorm's statistics and normalisation
    in f32, its result in the compute dtype."""

    def __init__(self, in_features: int, features: int, act: str = "leakyrelu",
                 use_bias: bool = False):
        super().__init__()
        self.act = act
        self.dense0 = Dense(in_features, features, bias=use_bias)
        self.ln = nn.LayerNorm(features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.dense0(x, self.compute_dtype)
        compute = torch.promote_types(y.dtype, self.ln.weight.dtype)
        y = self.ln(y.to(compute)).to(self.compute_dtype or compute)
        return activation(y, self.act, negative_slope=0.2)


class TransformNet(nn.Module):
    """The T-Net: (B, N, C) -> (B, K, K), a K x K alignment matrix biased
    toward the identity. ConvBN 64 -> 128 -> 1024, a max over the points,
    FCLayer 512 -> 256 and a Dense to K·K, plus the identity.

    Only the JAX module's ``reduce_neighbors=False`` form: the edge variant,
    which maxes over a neighbour axis, is built by no JAX model (PointNet
    is the only user of ``TransformNet``)."""

    def __init__(self, in_features: int, K: int):
        super().__init__()
        self.K = K
        self.convbn0 = ConvBN(in_features, 64)
        self.convbn1 = ConvBN(64, 128)
        self.convbn2 = ConvBN(128, 1024)
        self.fc0 = FCLayer(1024, 512)
        self.fc1 = FCLayer(512, 256)
        self.dense0 = Dense(256, K * K)  # no dtype: promotes the bf16 features to f32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.convbn2(self.convbn1(self.convbn0(x)))
        x = self.dense0(self.fc1(self.fc0(torch.amax(x, dim=1))))
        return x.reshape(-1, self.K, self.K) + torch.eye(self.K, dtype=x.dtype, device=x.device)


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lambd):
        ctx.lambd = lambd
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.lambd * g, None


def grad_reverse(x: torch.Tensor, lambd: float) -> torch.Tensor:
    """The working gradient-reversal layer: the identity forward, ``−λ·g``
    backward, no gradient for λ (a float)."""
    return _GradReverse.apply(x, float(lambd))


class CALayer(Mixed):
    """Squeeze-excite channel attention over flattened node features (B, D):
    Dense down/up (reduction 8, in the compute dtype) + sigmoid gate (in at
    least f32), ``x*y + x``, then BatchNorm over the D features at the
    promoted dtype: f32 node features stay f32."""

    def __init__(self, features: int = 64 * 64, reduction: int = 8):
        super().__init__()
        self.dense0 = Dense(features, features // reduction)
        self.dense1 = Dense(features // reduction, features)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = self.dense1(torch.relu(self.dense0(x, dt)), dt)
        y = torch.sigmoid(y.to(torch.promote_types(y.dtype, torch.float32)))
        return self.bn(x * y + x)
