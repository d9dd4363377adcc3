"""The source-only training loop: counterpart of
``sug_tpu/engine/source_loop.py`` on one device (no mesh, native loader or
multi-process).

KPConv's pyramid occupancy on the first train clouds is logged at
start-up (``check_neighbor_occupancy``, from MODEL_CFG, which the
classifier itself does not read: ROADMAP.md §3, R4). The whole source
train split, shuffled by epoch and augmented by the trainer; the cosine learning rate per epoch; eval on the source test split
and the two unseen datasets with best-accuracy tracking and the per-class
accuracy, its loss the trainer's criterion; a checkpoint every
``--ckpt_save_interval`` epochs. ``--resume`` restores the model and the
optimizer and continues at the saved epoch; ``--pretrained_model`` restores
the weights only.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from sug_tpu_torch import resolve_device
from sug_tpu_torch.data.datasets import create_single_dataset
from sug_tpu_torch.data.sampler import BatchIterator
from sug_tpu_torch.engine.checkpoint import load_checkpoint, save_train_checkpoint
from sug_tpu_torch.engine.evaluation import Evaluator, eval_epoch, eval_datasets
from sug_tpu_torch.engine.optim import cosine_lr
from sug_tpu_torch.engine.source_trainer import SourceTrainer
from sug_tpu_torch.models.kpconv import check_neighbor_occupancy
from sug_tpu_torch.utils.config import log_config_to_file, resolve_seed
from sug_tpu_torch.utils.logging import open_run


def run_source_training(args, cfg) -> Dict:
    """Train as ``args`` and ``cfg`` say. Returns ``{"best_test_acc": {name:
    [epoch, acc]}, "history": [per-epoch steps, eval batches, mean loss and
    ms per step]}``."""
    device = resolve_device(args.device)
    seed = resolve_seed(args, cfg)
    np.random.seed(seed)
    batch_size, num_points = args.batch_size, args.num_points

    ckpt_dir, logger, writer = open_run(cfg, args.source, "log_train_source")
    for key, val in vars(args).items():
        logger.info("{:16} {}".format(key, val))
    log_config_to_file(cfg, logger=logger)

    model_name = cfg.get("Model", "Pointnet")
    num_class = cfg["DATASET"]["NUM_CLASS"]
    data_root = cfg.get("DATA_ROOT")
    train_dataset = create_single_dataset(args.source, "train", pc_num=num_points,
                                          model=model_name, data_root=data_root)
    names, eval_sets = eval_datasets(args.source, num_points, model_name, data_root)
    logger.info(f"num_source_train: {len(train_dataset)}, "
                + ", ".join(f"{k}: {len(v)}" for k, v in eval_sets.items()))

    opt_cfg = cfg["OPTIMIZATION"]
    if model_name == "KPConv":
        check_neighbor_occupancy(train_dataset.pts, cfg.get("MODEL_CFG", None), logger=logger,
                                 device=device)
    trainer = SourceTrainer(model_name, num_class, float(opt_cfg["WEIGHT_DECAY"]), augment=True,
                            device=device, seed=seed, cfg=cfg)
    start_epoch = 0
    if args.resume:
        start_epoch = load_checkpoint(args.resume, trainer.model, trainer.optimizer)
        logger.info(f"Resumed from {args.resume} at epoch {start_epoch}")
    elif args.pretrained_model:
        load_checkpoint(args.pretrained_model, trainer.model)
        logger.info(f"Warm-started weights from {args.pretrained_model}")

    evaluator = Evaluator(trainer.eval_logits, num_class=num_class, device=trainer.device,
                          criterion=trainer.criterion)
    max_epoch = opt_cfg["NUM_EPOCHES"]
    base_lr = float(opt_cfg["LR"])
    best: Dict[str, List] = {k: [0, 0.0] for k in eval_sets}
    history: List[Dict] = []
    train_iter = BatchIterator(train_dataset, batch_size, shuffle=True, seed=seed)

    for epoch in range(start_epoch, max_epoch):
        since = time.time()
        lr = cosine_lr(base_lr, epoch, max_epoch)
        writer.add_scalar("lr", lr, epoch)
        train_iter.set_epoch(epoch)

        # the losses stay on the device and are fetched once per epoch
        pending = []
        t_epoch = time.perf_counter()
        for data, label in train_iter:
            pending.append((data.shape[0], trainer.train_step(data, label, lr)["loss"]))
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
        epoch_sec = time.perf_counter() - t_epoch
        n_seen = sum(bs for bs, _ in pending)
        loss = sum(float(l) * bs for bs, l in pending) / max(n_seen, 1)
        cps = n_seen / max(epoch_sec, 1e-9)
        logger.info(f"Train:{epoch} [{n_seen} /{len(train_dataset)}  loss: {loss:.4f}]  "
                    f"throughput: {cps:.0f} clouds/sec")
        writer.add_scalar("loss/train", loss, epoch)
        writer.add_scalar("perf/clouds_per_sec", cps, epoch)

        eval_batches = eval_epoch(evaluator, eval_sets, names, best, epoch, batch_size, writer,
                                  logger, cls_eval=True)

        trained_epoch = epoch + 1
        if trained_epoch % args.ckpt_save_interval == 0:
            path = save_train_checkpoint(ckpt_dir, args.source, trained_epoch, trainer.model,
                                         trainer.optimizer, args.max_ckpt_save_num)
            logger.info(f"Save current ckpt to {path}")
        history.append({"epoch": epoch, "steps": len(pending), "eval_batches": eval_batches,
                        "ms_per_step": epoch_sec / max(len(pending), 1) * 1000.0, "loss": loss})
        dt = time.time() - since
        logger.info("The {} epoch takes {:.0f}m {:.0f}s".format(epoch, dt // 60, dt % 60))

    writer.close()
    return {"best_test_acc": best, "history": history}
