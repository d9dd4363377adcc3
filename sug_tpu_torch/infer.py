"""Batch inference from a checkpoint: the port's counterpart of ``infer.py``.

Loads a twin-head DG model (``--dg``), which classifies clouds with the
ensemble ``(logits1 + logits2) / 2``, or a standalone classifier of the
source-only trainer (without ``--dg``), which classifies with its single
head; reports accuracy on a dataset split or predicts an ``.npy`` of
clouds, and optionally saves the predictions.

    python -m sug_tpu_torch.infer --ckpt model.pt \\
        --model (DGCNN | PTran | Pointnet | Pointnet2) [--dg] \\
        (--dataset scannet --split test | --pts clouds.npy) \\
        [--batch_size 64] [--num_points 1024] [--device cuda] [--save preds.npy]

``--ckpt`` takes the port's own ``torch.save`` checkpoint (from a trainer,
or from ``convert_reference_checkpoint`` for a ``.pth`` of the reference
PyTorch repo) or an ``.npz`` of the JAX package's variables (see the
README). A PTran DG model is built for
``--num_points`` points (its ``point_mix`` layer), so its checkpoint must
come from a model of that size; the PTran classifier takes any.
``SUG_PRECISION=bf16`` serves each model under the bf16 policy
(``models/precision.py``).
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from sug_tpu_torch import resolve_device
from sug_tpu_torch.data.datasets import PointCloudDataset, create_single_dataset
from sug_tpu_torch.data.sampler import BatchIterator
from sug_tpu_torch.engine.checkpoint import load_checkpoint
from sug_tpu_torch.engine.evaluation import Evaluator
from sug_tpu_torch.models import make_classifier
from sug_tpu_torch.models.net_mda import NetMDA, ensemble_logits
from sug_tpu_torch.models.precision import compute_dtype, set_compute_dtype


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True, help="port checkpoint (.pt) or JAX variables (.npz)")
    ap.add_argument("--model", default="DGCNN", help="DGCNN, PTran, Pointnet or Pointnet2")
    ap.add_argument("--dg", action="store_true",
                    help="DG twin-head checkpoint (ensembled); without it a standalone classifier")
    ap.add_argument("--dataset", default=None, help="scannet/shapenet/modelnet")
    ap.add_argument("--split", default="test")
    ap.add_argument("--pts", default=None, help=".npy file of raw clouds instead of a dataset")
    ap.add_argument("--data_root", default=None)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--num_points", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--save", default=None, help="write predicted labels to this .npy")
    args = ap.parse_args(argv)
    if not args.pts and not args.dataset:
        ap.error("--dataset or --pts required")
    return args


def load_model(model_name: str, ckpt: str, device: torch.device, num_points: int = 1024,
               dtype: Optional[torch.dtype] = None, dg: bool = True) -> torch.nn.Module:
    """The checkpoint's model in eval mode on ``device``, computing in
    ``dtype`` (None: f32; ``torch.bfloat16``: the bf16 policy): the
    twin-head ``NetMDA`` with ``dg``, else the standalone classifier."""
    if dg:
        model = NetMDA(model_name, num_points=num_points)
    else:
        model = make_classifier(model_name)
    set_compute_dtype(model, dtype)
    load_checkpoint(ckpt, model)
    return model.eval().to(device)


def model_logits(model: torch.nn.Module, pc: torch.Tensor) -> torch.Tensor:
    """The logits a model classifies by: the ensemble of a twin-head
    ``NetMDA``, the single head of a standalone classifier."""
    if isinstance(model, NetMDA):
        return ensemble_logits(model, pc)
    return model(pc)[0]


@torch.no_grad()
def predict(model: torch.nn.Module, pts: np.ndarray, batch_size: int,
            device: torch.device) -> np.ndarray:
    """Argmax of ``model_logits`` for (M, N, 3) ingested clouds, batch by batch."""
    preds = []
    for i in range(0, len(pts), batch_size):
        batch = torch.from_numpy(np.ascontiguousarray(pts[i : i + batch_size])).to(device)
        preds.append(torch.argmax(model_logits(model, batch), dim=-1).cpu().numpy())
    return np.concatenate(preds)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Run inference; returns ``{"preds": ...}`` for ``--pts`` and the
    Evaluator's result for ``--dataset``."""
    args = parse_args(argv)
    dtype = compute_dtype()  # SUG_PRECISION
    device = resolve_device(args.device)
    model = load_model(args.model, args.ckpt, device, args.num_points, dtype, args.dg)

    if args.pts:
        raw = np.load(args.pts).astype(np.float32)[..., :3]
        ds = PointCloudDataset("modelnet", raw, np.zeros(len(raw)), num_points=args.num_points)
        t0 = time.perf_counter()
        preds = predict(model, ds.pts, args.batch_size, device)
        dt = time.perf_counter() - t0
        print(f"predicted {len(preds)} clouds in {dt:.2f}s ({len(preds) / dt:.0f} clouds/s) on {device}")
        result: Dict = {"preds": preds}
    else:
        ds = create_single_dataset(
            args.dataset, args.split, model=args.model, data_root=args.data_root,
            pc_num=args.num_points,
        )
        ev = Evaluator(lambda d: model_logits(model, d), device=device)
        t0 = time.perf_counter()
        result = ev.run(BatchIterator(ds, args.batch_size, shuffle=False, drop_last=False))
        dt = time.perf_counter() - t0
        print(
            f"{args.dataset}/{args.split}: overall_acc={result['overall_acc']:.4f} "
            f"mean_class_acc={result['mean_class_acc']:.4f} "
            f"({len(ds) / dt:.0f} clouds/s on {device})"
        )
        print("per-class acc:", np.round(result["class_acc"], 3))

    if args.save and "preds" in result:
        np.save(args.save, result["preds"])
        print(f"saved predictions to {args.save}")
    return result


if __name__ == "__main__":
    main()
