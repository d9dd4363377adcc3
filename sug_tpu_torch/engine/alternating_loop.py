"""The epoch loop of the alternating trainers behind ``train_uda`` and
``train_dg_naive_mmd``, the part the JAX package writes out in each script:
per epoch the learning rates and the GRL's λ from ``schedule``, paired
source/target batches (each iterator shuffled by epoch; the shorter ends the
epoch), the step's metrics fetched once per epoch, eval of every eval set
with best-accuracy tracking, and ``save(trained_epoch)`` after each epoch
where given.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

from sug_tpu_torch.engine.alternating_trainer import AlternatingTrainer
from sug_tpu_torch.engine.evaluation import Evaluator, eval_epoch

LOSS_KEYS = ("loss_s", "loss_adv", "loss_node")


def run_alternating(trainer: AlternatingTrainer, src_iter, tgt_iter, eval_sets: Mapping,
                    names: Mapping[str, str], epochs: int,
                    schedule: Callable[[int], Tuple[float, float, float, float]],
                    batch_size: int, logger, writer,
                    save: Optional[Callable[[int], None]] = None) -> Dict:
    """Train ``trainer`` for ``epochs`` epochs; ``schedule(epoch)`` gives
    (lr_g, lr_c, lr_dis, cons), ``names`` each eval set's dataset name.
    Returns ``{"best_test_acc": {name: [epoch, acc]}, "history": [per-epoch
    steps, eval batches, mean losses and ms per step]}``."""
    evaluator = Evaluator(trainer.eval_logits, num_class=trainer.num_class, device=trainer.device,
                          criterion=trainer.criterion)
    best: Dict[str, List] = {k: [0, 0.0] for k in eval_sets}
    history: List[Dict] = []
    for epoch in range(epochs):
        since = time.time()
        lr_g, lr_c, lr_dis, cons = schedule(epoch)
        for tag, value in (("lr_g", lr_g), ("lr_c", lr_c), ("lr_dis", lr_dis), ("cons", cons)):
            writer.add_scalar(tag, value, epoch)
        src_iter.set_epoch(epoch)
        tgt_iter.set_epoch(epoch)

        pending = []
        t_epoch = time.perf_counter()
        for (ds_, ls_), (dt_, lt_) in zip(src_iter, tgt_iter):
            metrics = trainer.train_step(ds_, ls_, dt_, lt_, lr_g, lr_c, lr_dis, cons)
            pending.append((ds_.shape[0], metrics))
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
        epoch_sec = time.perf_counter() - t_epoch
        n_seen = sum(bs for bs, _ in pending)
        means = {k: sum(float(m[k]) * bs for bs, m in pending) / max(n_seen, 1)
                 for k in LOSS_KEYS}
        logger.info(f"Train Epoch {epoch} [{n_seen}] loss_s {means['loss_s']} loss_adv: "
                    f"{means['loss_adv']} loss_node_adv {means['loss_node']} cons: {cons:.4f}")
        for k, v in means.items():
            writer.add_scalar(f"loss/{k}", v, epoch)
        ms_per_step = epoch_sec / max(len(pending), 1) * 1000.0
        if n_seen:
            writer.add_scalar("perf/clouds_per_sec", 2 * n_seen / epoch_sec, epoch)

        eval_batches = eval_epoch(evaluator, eval_sets, names, best, epoch, batch_size, writer,
                                  logger)

        if save is not None:
            save(epoch + 1)
        history.append({"epoch": epoch, "steps": len(pending), "eval_batches": eval_batches,
                        "ms_per_step": ms_per_step, **means})
        dt = time.time() - since
        logger.info("The {} epoch takes {:.0f}m {:.0f}s".format(epoch, dt // 60, dt % 60))
    writer.close()
    return {"best_test_acc": best, "history": history}
