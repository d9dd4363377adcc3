"""Source-only training with zero-shot eval: the port's counterpart of
``train_source.py``.

    python -m sug_tpu_torch.train_source --source modelnet \\
        --cfg tools/cfgs/cfgs_local/direct_inference.yaml [--set Model (DGCNN|PTran|Pointnet2)] \\
        [--batch_size 64] [--num_points 1024] [--device cuda] \\
        [--resume ckpt.pt | --pretrained_model ckpt.pt] [--fix_random_seed]

``--device cpu`` runs the kernels' plain versions on the CPU. The port
trains the standalone classifier of the config's ``Model``: ``Pointnet``
(the shipped config's), ``DGCNN``, ``PTran`` (at most about 3600 points
on the card) or ``Pointnet2`` (at least 512 points, f32 only); another
model raises.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

from sug_tpu_torch.engine.source_loop import run_source_training
from sug_tpu_torch.utils.config import parser_config


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args, cfg = parser_config(argv)
    return run_source_training(args, cfg)


if __name__ == "__main__":
    since = time.time()
    main()
    dt = time.time() - since
    print("Training complete in {:.0f}m {:.0f}s".format(dt // 60, dt % 60))
