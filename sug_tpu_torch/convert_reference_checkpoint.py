"""Convert a ``Net_MDA`` checkpoint of the reference PyTorch repo
(SiyuanHuang95/SUG) into a port checkpoint, so that a model trained there is
served or fine-tuned by the port: the counterpart of
``tools/convert_reference_checkpoint.py``.

    python -m sug_tpu_torch.convert_reference_checkpoint --ckpt model.pth \\
        --model (Pointnet | DGCNN | Pointnet2) --out model.pt [--key K]
    python -m sug_tpu_torch.infer --ckpt model.pt --model Pointnet --dg --pts clouds.npy

The ``.pth`` holds a raw state dict or one wrapped under ``--key`` (else
``model_state``, ``state_dict`` or ``model``), with or without DataParallel's
``module.`` prefix (``utils/torch_convert.load_reference_checkpoint``). The
converted state is loaded strictly into the port's ``NetMDA`` before it is
written, as ``{"state": ..., "epoch": 0}`` (``engine/checkpoint.py``), and
the tool prints its parameter count. PTran converts through the function
(``convert_net_mda``), as in the JAX package.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from sug_tpu_torch.engine.checkpoint import save_checkpoint
from sug_tpu_torch.models.net_mda import NetMDA
from sug_tpu_torch.utils.torch_convert import load_reference_checkpoint


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Convert ``--ckpt`` into ``--out``; returns the written path."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True, help="reference .pth state dict")
    ap.add_argument("--model", default="Pointnet", choices=["Pointnet", "DGCNN", "Pointnet2"])
    ap.add_argument("--out", required=True, help="the port checkpoint (.pt) to write")
    ap.add_argument("--key", default=None, help="the sub-dict of the checkpoint holding the state")
    args = ap.parse_args(argv)

    state = load_reference_checkpoint(args.ckpt, args.model, key=args.key)
    model = NetMDA(args.model)
    model.load_state_dict(state, strict=True)
    path = save_checkpoint(args.out, model, epoch=0)
    n = sum(v.numel() for v in state.values())
    print(f"wrote {path}: {n:,} parameters ({args.model})")
    return path


if __name__ == "__main__":
    main()
