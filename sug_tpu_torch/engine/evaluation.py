"""Evaluation: counterpart of ``sug_tpu/engine/evaluation.py``.

Overall, per-class and mean-class accuracy and the average loss (the
configured criterion's, per sample) over a loader. The last batch is
zero-padded to the first batch's size and a ``valid`` mask drops the pad
rows from every sum, as in the JAX package. ``eval_worker`` adds the
best-accuracy tracking of the training loop, ``eval_epoch`` runs it over the
training loops' three test sets (``eval_datasets``).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn

from sug_tpu_torch import resolve_device
from sug_tpu_torch.data.datasets import DATASET_LIST, PointCloudDataset, create_single_dataset
from sug_tpu_torch.data.sampler import BatchIterator
from sug_tpu_torch.losses.classification import cross_entropy


class Evaluator:
    """``apply_fn(data) -> logits`` must already ensemble heads if
    applicable; it runs under ``torch.no_grad()`` on ``device``.
    ``criterion(logits, labels)`` is a mean of per-sample terms (cross
    entropy by default); the eval loss applies it to each sample."""

    def __init__(self, apply_fn: Callable[[torch.Tensor], torch.Tensor],
                 num_class: int = 10, device="cuda", criterion=None):
        self.apply_fn = apply_fn
        self.num_class = num_class
        self.device = resolve_device(device)
        self.criterion = criterion or cross_entropy

    def _step(self, data, label, valid) -> Dict[str, torch.Tensor]:
        logits = self.apply_fn(data)
        per_sample = torch.func.vmap(lambda lg, lb: self.criterion(lg[None], lb[None]))(logits, label)
        loss_sum = torch.sum(per_sample * valid)
        correct = (torch.argmax(logits, dim=-1) == label).float() * valid
        onehot = Fn.one_hot(label, self.num_class).float() * valid[:, None]
        return {
            "loss_sum": loss_sum,
            "correct": torch.sum(correct),
            "count": torch.sum(valid),
            "cls_correct": torch.sum(onehot * correct[:, None], dim=0),
            "cls_count": torch.sum(onehot, dim=0),
        }

    @torch.no_grad()
    def run(self, batches: Iterable[Tuple[np.ndarray, np.ndarray]]) -> Dict:
        totals = None
        pad_to = None
        for data, label in batches:
            data, label = np.asarray(data), np.asarray(label)
            if pad_to is None:
                pad_to = data.shape[0]
            n = data.shape[0]
            valid = np.ones(pad_to, dtype=np.float32)
            if n < pad_to:
                pad = pad_to - n
                data = np.concatenate([data, np.zeros((pad,) + data.shape[1:], data.dtype)])
                label = np.concatenate([label, np.zeros(pad, label.dtype)])
                valid[n:] = 0.0
            m = self._step(
                torch.from_numpy(np.ascontiguousarray(data, dtype=np.float32)).to(self.device),
                torch.from_numpy(label.astype(np.int64)).to(self.device),
                torch.from_numpy(valid).to(self.device),
            )
            totals = m if totals is None else {k: totals[k] + m[k] for k in totals}
        if totals is None:
            raise ValueError("empty eval loader")
        totals = {k: v.cpu().numpy() for k, v in totals.items()}  # one transfer each
        cls_acc = totals["cls_correct"] / np.maximum(totals["cls_count"], 1.0)
        return {
            "overall_acc": float(totals["correct"] / totals["count"]),
            "avg_loss": float(totals["loss_sum"] / totals["count"]),
            "class_acc": cls_acc,
            "mean_class_acc": float(cls_acc[totals["cls_count"] > 0].mean()),
        }


def eval_worker(eval_dict: Dict, logger) -> Dict:
    """Evaluate one loader, update the best-accuracy tracker, and log the
    per-class accuracy when ``cls_eval``."""
    result = eval_dict["evaluator"].run(eval_dict["dataloader"])
    dataset, epoch = eval_dict["dataset"], eval_dict["epoch"]
    best_acc, best_epoch = eval_dict["best_target_acc"], eval_dict["best_target_acc_epoch"]
    logger.info(f"Current eval on: {dataset} {eval_dict['dataset_name']}")
    acc = result["overall_acc"]
    if acc > best_acc:
        best_acc, best_epoch = acc, epoch
    logger.info(f"On dataset {dataset} :{epoch} [overall_acc: {acc} Best Tar Acc: "
                f"{best_acc} on Source Train Epoch {best_epoch}]")
    if eval_dict.get("cls_eval", False):
        logger.info(f"Cls-wise eval: {result['class_acc']}")
        logger.info(f"compared eval: {acc} and avg: {result['mean_class_acc']}")
    return {"dataset": dataset, "epoch": epoch, "best_target_acc": best_acc,
            "best_target_acc_epoch": best_epoch, "cur_target_acc": acc}


def eval_datasets(source: str, num_points: int, model_name: str, data_root: Optional[str],
              fixed_x_rotation: Optional[bool] = None
              ) -> Tuple[Dict[str, str], Dict[str, PointCloudDataset]]:
    """The training loops' eval sets: the source's test split ("source") and
    the two other datasets' ("test1", "test2"). Returns ({key: dataset
    name}, {key: dataset})."""
    others = [d for d in DATASET_LIST if d != source]
    names = {"source": source, "test1": others[0], "test2": others[-1]}
    return names, {k: create_single_dataset(d, "test", pc_num=num_points, model=model_name,
                                            data_root=data_root,
                                            fixed_x_rotation=fixed_x_rotation)
                   for k, d in names.items()}


def eval_epoch(evaluator: Evaluator, eval_sets: Mapping[str, PointCloudDataset],
               names: Mapping[str, str], best: Dict[str, List], epoch: int, batch_size: int,
               writer, logger, cls_eval: bool = False) -> int:
    """``eval_worker`` on one unshuffled pass of every eval set after
    ``epoch``: ``best`` ({key: [epoch, acc]}) is updated in place and each
    set's ``_best_acc`` and ``_cur_acc`` scalars written. Returns the count
    of eval batches."""
    eval_batches = 0
    for name, dataset in eval_sets.items():
        loader = BatchIterator(dataset, batch_size, shuffle=False, drop_last=False)
        eval_batches += len(loader)
        result = eval_worker({
            "evaluator": evaluator, "dataloader": loader, "dataset": name,
            "dataset_name": names[name], "epoch": epoch, "best_target_acc": best[name][1],
            "best_target_acc_epoch": best[name][0], "cls_eval": cls_eval,
        }, logger)
        best[name] = [result["best_target_acc_epoch"], result["best_target_acc"]]
        tag = f"acc/{name}_{names[name]}"
        writer.add_scalar(tag + "_best_acc", result["best_target_acc"], epoch)
        writer.add_scalar(tag + "_cur_acc", result["cur_target_acc"], epoch)
    return eval_batches
