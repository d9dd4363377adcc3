"""The UDA comparison trainer (PointDAN-style): a labelled source and a real
unlabelled target dataset, GRL and node-MMD alternating updates; the port's
counterpart of ``train_uda.py``, with its single-dash flags.

    python -m sug_tpu_torch.train_uda -source scannet -target modelnet -b 64 -e 200 \\
        [-model_name (Pointnet|DGCNN|PTran)] [-datadir ./dataset/] [-device cuda] \\
        [-num_points 1024]

Seed 666; ``lr_g`` the cosine schedule of ``-lr`` and ``lr_c`` that of
``2·lr``, both over ``epochs + 50``; ``lr_dis`` the dis schedule of ``-lr``
and ``-scaler``; the GRL's λ ``sin((epoch + 1) / epochs · π/2)``; eval on
both test splits each epoch, no checkpoint. ``-device``/``--device`` and
``-num_points``/``--num_points`` are the port's own (``--device cpu`` runs
the kernels' plain versions on the CPU); ``-gpu`` and ``-models`` are read
and ignored, as in the JAX script. Metrics go to ``<tb_log_dir>/metrics.jsonl``.
"""

from __future__ import annotations

import argparse
import math
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np

from sug_tpu_torch.data.datasets import DATASET_LIST, create_single_dataset
from sug_tpu_torch.data.sampler import BatchIterator
from sug_tpu_torch.engine.alternating_loop import run_alternating
from sug_tpu_torch.engine.alternating_trainer import AlternatingTrainer
from sug_tpu_torch.engine.optim import cosine_lr, dis_lr_schedule
from sug_tpu_torch.utils.logging import MetricsWriter, create_logger

SEED = 666
REMAIN_EPOCHS = 50  # the cosine horizon's pad beyond -epochs


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="UDA baseline (PyTorch/CUDA port)")
    p.add_argument("-source", "-s", type=str, default="scannet")
    p.add_argument("-target", "-t", type=str, default="modelnet")
    p.add_argument("-batchsize", "-b", type=int, default=64)
    p.add_argument("-gpu", "-g", type=str, default="0")
    p.add_argument("-epochs", "-e", type=int, default=200)
    p.add_argument("-models", "-m", type=str, default="MDA")
    p.add_argument("-lr", type=float, default=0.0001)
    p.add_argument("-scaler", type=float, default=1.0)
    p.add_argument("-weight", type=float, default=1.0, help="weight of src loss")
    p.add_argument("-datadir", type=str, default="./dataset/")
    p.add_argument("-tb_log_dir", type=str, default="./logs")
    p.add_argument("-model_name", type=str, default="Pointnet")
    p.add_argument("-device", "--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("-num_points", "--num_points", type=int, default=1024)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = parse_args(argv)
    if args.source not in DATASET_LIST or args.target not in DATASET_LIST:
        raise ValueError(f"-source and -target must be among {DATASET_LIST}")
    np.random.seed(SEED)
    trainer = AlternatingTrainer(args.model_name, mode="uda", src_weight=args.weight,
                                 weight_decay=5e-4, device=args.device, seed=SEED,
                                 num_points=args.num_points)
    writer = MetricsWriter(args.tb_log_dir)
    logger = create_logger()
    data_root = (args.datadir if "data" in args.datadir
                 else os.path.join(args.datadir, "PointDA_data/"))

    def dataset(name, split):
        return create_single_dataset(name, split, pc_num=args.num_points, data_root=data_root)

    src_iter = BatchIterator(dataset(args.source, "train"), args.batchsize, seed=SEED)
    tgt_iter = BatchIterator(dataset(args.target, "train"), args.batchsize, seed=SEED + 1)
    eval_sets = {"source": dataset(args.source, "test"), "test1": dataset(args.target, "test")}
    horizon = args.epochs + REMAIN_EPOCHS

    def schedule(epoch):
        return (cosine_lr(args.lr, epoch, horizon), cosine_lr(args.lr * 2, epoch, horizon),
                dis_lr_schedule(args.lr, args.scaler, epoch),
                math.sin((epoch + 1) / args.epochs * math.pi / 2))

    return run_alternating(trainer, src_iter, tgt_iter, eval_sets,
                           {"source": args.source, "test1": args.target}, args.epochs, schedule,
                           args.batchsize, logger, writer)


if __name__ == "__main__":
    since = time.time()
    main()
    dt = time.time() - since
    print("Training complete in {:.0f}m {:.0f}s".format(dt // 60, dt % 60))
