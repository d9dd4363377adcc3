"""SUG in PyTorch and CUDA: the port of ``sug_tpu`` to one NVIDIA H100.

The package mirrors ``sug_tpu``'s layout (``ops/``, ``models/``, ``losses/``,
``engine/``, ``data/``, ``utils/``) and keeps its layouts at every public
function: clouds are channels-last ``(B, N, 3)`` and node features flatten
node-major. It imports ``torch`` and numpy, never JAX or ``sug_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for ``cuda`` on a machine without a card raises instead of quietly
running on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

# The JAX package computes its distances and Dense layers in f32. PyTorch
# would route f32 convolutions (and, if enabled, matmuls) through TF32, which
# keeps ~3 decimal digits and reorders near-tied kNN neighbours; turn both off.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None] = DEFAULT_DEVICE) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless asked otherwise.

    Raises RuntimeError when CUDA is asked for and no card is present.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev
