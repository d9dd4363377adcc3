"""Train-time augmentation: counterpart of ``augment_batch`` in
``sug_tpu/ops/augment.py`` with its defaults (z-rotation + jitter).

The random numbers come from a ``torch.Generator``; torch cannot replay
JAX's PRNG streams, so parity tests feed both packages the same augmented
clouds instead.
"""

from __future__ import annotations

import math

import torch

# the JAX package's defaults: jitter sigma·N(0, 1), clipped at ±clip
JITTER_SIGMA = 0.01
JITTER_CLIP = 0.05


def rot_z(angles: torch.Tensor) -> torch.Tensor:
    """(B,) angles -> (B, 3, 3) rotations about z, laid out as ``_rot_z``."""
    c, s = torch.cos(angles), torch.sin(angles)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    return torch.stack([
        torch.stack([c, -s, zero], -1),
        torch.stack([s, c, zero], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)


def augment_batch(pc: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """(B, N, 3) clouds -> a per-cloud uniform z-rotation ``pc @ Rz``, then
    per-point jitter ``clip(0.01·N(0, 1), ±0.05)``."""
    angles = torch.rand(pc.shape[0], generator=generator, device=pc.device) * 2.0 * math.pi
    pc = torch.einsum("bnc,bcd->bnd", pc, rot_z(angles))
    noise = torch.randn(pc.shape, generator=generator, device=pc.device)
    return pc + torch.clamp(JITTER_SIGMA * noise, -JITTER_CLIP, JITTER_CLIP)
