"""SUG DG training on one GPU: the port's counterpart of
``train_dg_single_gpu.py``.

    python -m sug_tpu_torch.train_dg_single_gpu --source modelnet \\
        --cfg tools/cfgs/cfgs_local/DG_unified_loss.yaml [--set Model (DGCNN|PTran)] \\
        [--batch_size 64] [--num_points 1024] [--device cuda] [--resume ckpt.pt] \\
        [--fix_random_seed]

``--device cpu`` runs the kernels' plain versions on the CPU. The port
trains the config's ``Model``: ``Pointnet`` (the shipped config's, at any
``--num_points``, 4096 included), ``DGCNN``, or ``PTran`` (built for
``--num_points`` points, at most about 3600 on the card); another model
raises.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

from sug_tpu_torch.engine.dg_loop import run_dg_training
from sug_tpu_torch.utils.config import parser_config


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args, cfg = parser_config(argv)
    return run_dg_training(args, cfg)


if __name__ == "__main__":
    since = time.time()
    main()
    dt = time.time() - since
    print("Training complete in {:.0f}m {:.0f}s".format(dt // 60, dt % 60))
