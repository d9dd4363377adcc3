"""The naive-MMD DG baseline: alternating (classification + adversarial) /
node-MMD updates on the two sub-domains of one source dataset, the port's
counterpart of ``train_dg_naive_mmd.py``.

    python -m sug_tpu_torch.train_dg_naive_mmd --source modelnet \\
        --cfg tools/cfgs/cfgs_local/DG_baseline.yaml [--set Model (DGCNN|PTran|Pointnet|Pointnet2)] \\
        [--batch_size 64] [--num_points 1024] [--device cuda] [--fix_random_seed]

The ``Random`` splitter's ``TRAIN_BASE`` subset is the source, the other
the target; class-balanced batches with ``METHODS.CLASS_BALANCE``; the
criterion of ``OPTIMIZATION.CLS_LOSS`` (``make_criterion``); ``lr_g = lr_c``
the cosine schedule, ``lr_dis`` the dis schedule, the GRL's λ
``sin((epoch + 1) / epochs · π/2)``; a checkpoint every
``--ckpt_save_interval`` epochs. ``--device cpu`` runs the kernels' plain
versions on the CPU. A model the port does not train raises
``NotImplementedError``, an unknown ``CLASS_MMD`` name ``ValueError``.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional, Sequence

import numpy as np

from sug_tpu_torch.data.datasets import create_splitted_dataset
from sug_tpu_torch.data.sampler import BatchIterator, ClassBalancedBatchIterator
from sug_tpu_torch.engine.alternating_loop import run_alternating
from sug_tpu_torch.engine.alternating_trainer import AlternatingTrainer
from sug_tpu_torch.engine.checkpoint import save_train_checkpoint
from sug_tpu_torch.engine.dg_trainer import make_criterion
from sug_tpu_torch.engine.evaluation import eval_datasets
from sug_tpu_torch.engine.optim import cosine_lr, dis_lr_schedule
from sug_tpu_torch.utils.config import log_config_to_file, parser_config, resolve_seed
from sug_tpu_torch.utils.logging import open_run


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args, cfg = parser_config(argv)
    seed = resolve_seed(args, cfg)
    np.random.seed(seed)  # the Random splitter draws from numpy's global state
    model_name = cfg.get("Model", "Pointnet")
    opt_cfg = cfg["OPTIMIZATION"]
    num_class = cfg["DATASET"]["NUM_CLASS"]
    batch_size, num_points = args.batch_size, args.num_points
    trainer = AlternatingTrainer(model_name, num_class, mode="naive", cfg=cfg,
                                 weight_decay=float(opt_cfg["WEIGHT_DECAY"]), device=args.device,
                                 seed=seed, num_points=num_points)

    ckpt_dir, logger, writer = open_run(cfg, args.source, "log_train_dg_naive")
    log_config_to_file(cfg, logger=logger)

    data_root = cfg.get("DATA_ROOT")
    sc = cfg["DATASET_SPLITTER"]
    subsets = create_splitted_dataset(args.source, "train", config=sc, logger=logger,
                                      pc_num=num_points, model=model_name, data_root=data_root)
    src_ds, tgt_ds = subsets[sc["TRAIN_BASE"]], subsets[1 - sc["TRAIN_BASE"]]

    def make_iter(ds, s):
        if cfg["METHODS"].get("CLASS_BALANCE", False):
            return ClassBalancedBatchIterator(ds, batch_size, 10, seed=s)
        return BatchIterator(ds, batch_size, seed=s)

    names, eval_sets = eval_datasets(args.source, num_points, model_name, data_root)
    trainer.criterion = make_criterion(opt_cfg, src_ds, num_class, trainer.device)

    max_epochs = opt_cfg["NUM_EPOCHES"]
    base_lr, scaler = float(opt_cfg["LR"]), float(opt_cfg["LR_SCALER"])

    def schedule(epoch):
        lr_g = cosine_lr(base_lr, epoch, max_epochs)
        return (lr_g, lr_g, dis_lr_schedule(base_lr, scaler, epoch),
                math.sin((epoch + 1) / max_epochs * math.pi / 2))

    def save(trained_epoch):
        if trained_epoch % args.ckpt_save_interval == 0:
            path = save_train_checkpoint(ckpt_dir, args.source, trained_epoch, trainer.model,
                                         trainer.optimizer, args.max_ckpt_save_num)
            logger.info(f"Save current ckpt to {path}")

    return run_alternating(trainer, make_iter(src_ds, seed), make_iter(tgt_ds, seed + 1), eval_sets,
                           names, max_epochs, schedule, batch_size, logger, writer, save)


if __name__ == "__main__":
    since = time.time()
    main()
    dt = time.time() - since
    print("Training complete in {:.0f}m {:.0f}s".format(dt // 60, dt % 60))
