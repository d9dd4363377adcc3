"""The DG training loop: counterpart of ``sug_tpu/engine/dg_loop.py`` on one
device (no mesh, native loader, profiler trace or multi-process).

KPConv's pyramid occupancy on the first source clouds is logged at start-up
(``check_neighbor_occupancy``, on the device: the FPS pyramid launches its
four FPS there). Per epoch: the cosine and dis learning rates, the GRL's λ
``sin((epoch + 1) / max_epoch · π/2)``, ``PURE_CLS_EPOCH`` gating of the MMD
losses, paired source/target split batches (shuffled by epoch), eval
on the source test split and the two unseen datasets with best-accuracy
tracking and a ``best`` export when test1 improves, and a periodic
checkpoint; ``--resume`` continues at the saved epoch.
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict, List

import numpy as np
import torch

from sug_tpu_torch import resolve_device
from sug_tpu_torch.data.datasets import DATASET_LIST, create_splitted_dataset
from sug_tpu_torch.data.sampler import BatchIterator, ClassBalancedBatchIterator
from sug_tpu_torch.engine.checkpoint import load_checkpoint, save_checkpoint, save_train_checkpoint
from sug_tpu_torch.engine.dg_trainer import DGTrainer, check_supported, make_criterion
from sug_tpu_torch.engine.evaluation import Evaluator, eval_epoch, eval_datasets
from sug_tpu_torch.engine.optim import cosine_lr, dis_lr_schedule
from sug_tpu_torch.models.kpconv import check_neighbor_occupancy
from sug_tpu_torch.utils.config import log_config_to_file, resolve_seed
from sug_tpu_torch.utils.logging import open_run

LOSS_KEYS = ("loss_cls", "loss_adv", "loss_geo", "loss_sem")
# a deformable KPConv's regularizer, logged and kept where the steps report it
REG_KEY = "loss_reg"


def _make_train_iter(dataset, cfg, batch_size: int, seed: int):
    if cfg.get("METHODS", {}).get("CLASS_BALANCE", False) or cfg.get("CLASS_BALANCE", False):
        return ClassBalancedBatchIterator(dataset, batch_size, class_per_batch=10, seed=seed)
    return BatchIterator(dataset, batch_size, shuffle=True, seed=seed)


def run_dg_training(args, cfg) -> Dict:
    """Train as ``args`` and ``cfg`` say. Returns ``{"best_test_acc": {name:
    [epoch, acc]}, "history": [per-epoch steps, eval batches, mean losses
    and ms per step]}``."""
    device = resolve_device(args.device)
    model_name = cfg.get("Model", "Pointnet")
    check_supported(cfg, model_name)
    seed = resolve_seed(args, cfg)
    np.random.seed(seed)  # the Random splitter draws from numpy's global state
    batch_size, num_points = args.batch_size, args.num_points

    ckpt_dir, logger, writer = open_run(cfg, args.source, "log_train_dg")
    logger.info("**********************Start logging**********************")
    for key, val in vars(args).items():
        logger.info("{:16} {}".format(key, val))
    log_config_to_file(cfg, logger=logger)
    logger.info(f"The source domain is set to: {args.source}")
    test_datasets = [d for d in DATASET_LIST if d != args.source]
    logger.info(f"The datasets used for testing: {test_datasets}")
    fixed_rot = cfg.get("DATASET", {}).get("FIXED_X_ROTATION", None)
    data_root = cfg.get("DATA_ROOT")

    split_configs = cfg["DATASET_SPLITTER"]
    if not isinstance(split_configs, (list, tuple)):
        split_configs = [split_configs]
    source_iters: List = []
    target_iters: List = []
    source_train_dataset = None
    for sc in split_configs:
        subsets = create_splitted_dataset(args.source, "train", config=sc, logger=logger,
                                          pc_num=num_points, model=model_name,
                                          data_root=data_root, fixed_x_rotation=fixed_rot)
        src, tgt = subsets[sc["TRAIN_BASE"]], subsets[1 - sc["TRAIN_BASE"]]
        source_train_dataset = source_train_dataset or src
        logger.info(f"Num of source train: {len(src)}, Num of target train: {len(tgt)}")
        source_iters.append(_make_train_iter(src, cfg, batch_size, seed))
        target_iters.append(_make_train_iter(tgt, cfg, batch_size, seed + 1))

    names, eval_sets = eval_datasets(args.source, num_points, model_name, data_root, fixed_rot)
    logger.info(f"batch_size: {batch_size}")
    if model_name == "KPConv" and source_train_dataset is not None:
        check_neighbor_occupancy(source_train_dataset.pts, cfg.get("MODEL_CFG", None),
                                 logger=logger, device=device)

    opt_cfg = cfg["OPTIMIZATION"]
    num_class = cfg["DATASET"]["NUM_CLASS"]
    trainer = DGTrainer(cfg, model_name=model_name, num_class=num_class, augment=True,
                        device=device, seed=seed, num_points=num_points)
    trainer.criterion = make_criterion(opt_cfg, source_train_dataset, num_class, trainer.device)
    start_epoch = 0
    if args.resume:
        start_epoch = load_checkpoint(args.resume, trainer.model, trainer.optimizer)
        logger.info(f"Resumed from {args.resume} at epoch {start_epoch}")

    evaluator = Evaluator(trainer.eval_logits, num_class=num_class, device=trainer.device,
                          criterion=trainer.criterion)
    max_epoch = opt_cfg["NUM_EPOCHES"]
    base_lr = float(opt_cfg["LR"])
    scaler = float(opt_cfg["LR_SCALER"])
    pure_cls_epoch = int(cfg["METHODS"].get("PURE_CLS_EPOCH", 0))
    mmd_weight = float(cfg["METHODS"].get("MMD_WEIGHT", 0.0))
    cls_eval = bool(opt_cfg.get("CLS_EVAL", True))
    best: Dict[str, List] = {k: [0, 0.0] for k in eval_sets}
    history: List[Dict] = []

    for epoch in range(start_epoch, max_epoch):
        since = time.time()
        lr_g = cosine_lr(base_lr, epoch, max_epoch)
        lr_c = lr_g
        lr_dis = dis_lr_schedule(base_lr, scaler, epoch)
        for tag, lr in (("lr_g", lr_g), ("lr_c", lr_c), ("lr_dis", lr_dis)):
            writer.add_scalar(tag, lr, epoch)
        grl_const = math.sin((epoch + 1) / max_epoch * math.pi / 2)
        mmd_on = epoch >= pure_cls_epoch and mmd_weight > 0

        idx = epoch % len(source_iters)
        src_iter, tgt_iter = source_iters[idx], target_iters[idx]
        src_iter.set_epoch(epoch)
        tgt_iter.set_epoch(epoch)

        # metrics stay on the device and are fetched once per epoch
        pending = []
        t_epoch = time.perf_counter()
        for (ds_, ls_), (dt_, lt_) in zip(src_iter, tgt_iter):
            metrics = trainer.train_step(ds_, ls_, dt_, lt_, lr_g, lr_c, lr_dis, mmd_on=mmd_on,
                                         grl_const=grl_const)
            pending.append((ds_.shape[0], metrics))
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
        epoch_sec = time.perf_counter() - t_epoch

        totals = {k: 0.0 for k in LOSS_KEYS}
        n_seen = 0
        for bs, metrics in pending:
            n_seen += bs
            for k in LOSS_KEYS + (REG_KEY,):
                if k in metrics:
                    totals[k] = totals.get(k, 0.0) + float(metrics[k]) * bs
        means = {k: v / max(n_seen, 1) for k, v in totals.items()}
        if pending:
            logger.info(f"Train Epoch {epoch} [{n_seen}] loss_cls {means['loss_cls']}")
            if REG_KEY in means:
                logger.info(f"loss_reg (the deformable KPConv regularizer): {means[REG_KEY]}")
                writer.add_scalar("loss/reg", means[REG_KEY], epoch)
            if mmd_on:
                logger.info(f"loss_adv: {means['loss_adv']} loss_geo_mmd {means['loss_geo']} "
                            f"loss_sem_mmd {means['loss_sem']}")
        for tag, k in (("loss/cls", "loss_cls"), ("loss/adv", "loss_adv"),
                       ("loss/mmd_geo", "loss_geo"), ("loss/mmd_sem", "loss_sem")):
            writer.add_scalar(tag, means[k], epoch)
        ms_per_step = epoch_sec / max(len(pending), 1) * 1000.0
        if n_seen:
            cps = 2 * n_seen / epoch_sec
            writer.add_scalar("perf/clouds_per_sec", cps, epoch)
            writer.add_scalar("perf/ms_per_step", ms_per_step, epoch)
            logger.info(f"throughput: {cps:.0f} clouds/sec ({ms_per_step:.1f} ms/step)")

        prev_best_t1 = best["test1"][1]
        eval_batches = eval_epoch(evaluator, eval_sets, names, best, epoch, batch_size, writer,
                                  logger, cls_eval)

        if best["test1"][1] > prev_best_t1:
            best_path = save_checkpoint(
                os.path.join(ckpt_dir, "best", f"{args.source}_best.pt"), trainer.model, epoch + 1,
                trainer.optimizer, extra={"best_acc": {k: v[1] for k, v in best.items()}})
            logger.info(f"New best test1 acc: exported {best_path}")
        trained_epoch = epoch + 1
        if trained_epoch % args.ckpt_save_interval == 0:
            path = save_train_checkpoint(ckpt_dir, args.source, trained_epoch, trainer.model,
                                         trainer.optimizer, args.max_ckpt_save_num)
            logger.info(f"Save current ckpt to {path}")
        history.append({"epoch": epoch, "steps": len(pending), "eval_batches": eval_batches,
                        "ms_per_step": ms_per_step, **means})
        dt = time.time() - since
        logger.info("The {} epoch takes {:.0f}m {:.0f}s".format(epoch, dt // 60, dt % 60))
        logger.info("****************Finished One Epoch****************")

    writer.close()
    return {"best_test_acc": best, "history": history}
