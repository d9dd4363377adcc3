"""The port's training front door, ``sug_tpu_torch.train_dg_single_gpu``, on
the CPU: one epoch of DGCNN DG training with ``DG_unified_loss.yaml`` on a
tiny synthetic PointDA tree (clouds of 128 points), then ``--resume`` from
its checkpoint, which continues at the next epoch with the optimizer's step
counts carried over; two epochs with ``--set METHODS.GRL True`` on the
stacked forward with the contrastive geo and max-hard sem alignments,
checking the GRL's λ each step receives. A model the port does not train
raises. PTran's run
through the same door is in ``test_torch_port_ptran_train.py``, PointNet's
(the shipped config as it stands) in ``test_torch_port_pointnet.py``."""

from __future__ import annotations

import glob
import math
import os

import numpy as np
import pytest
import torch

from sug_tpu_torch import train_dg_single_gpu
from sug_tpu_torch.data.datasets import DATASET_LIST, make_synthetic_pointda
from tests._torch_port_common import one_torch_thread  # noqa: F401  (autouse)

YAML = "tools/cfgs/cfgs_local/DG_unified_loss.yaml"
N_POINTS = 128


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """train/test dumps of the three datasets; the root's path contains
    "data", so the outputs go beside it as the JAX package puts them."""
    root = tmp_path_factory.mktemp("run") / "data" / "PointDA_data"
    for i, name in enumerate(DATASET_LIST):
        (root / name).mkdir(parents=True)
        for j, split in enumerate(("train", "test")):
            pts, labels = make_synthetic_pointda(num_per_class=4 if split == "train" else 2,
                                                 num_points=N_POINTS, seed=10 * i + j)
            np.save(root / name / f"{split}_pts.npy", pts)
            np.save(root / name / f"{split}_label.npy", labels)
    return root


def _argv(root, epochs, *extra):
    return ["--source", "modelnet", "--cfg", YAML, "--batch_size", "8",
            "--num_points", str(N_POINTS), "--device", "cpu", "--ckpt_save_interval", "1",
            "--fix_random_seed", *extra,
            "--set", "Model", "DGCNN", "DATA_ROOT", str(root), "OPTIMIZATION.NUM_EPOCHES", str(epochs)]


def test_train_one_epoch_then_resume(data_root):
    res = train_dg_single_gpu.main(_argv(data_root, 1))
    (epoch0,) = res["history"]
    # 40 modelnet train clouds split 20/20; class-balanced batches of 8
    assert epoch0["epoch"] == 0 and epoch0["steps"] == 2
    assert epoch0["eval_batches"] == 3 * math.ceil(20 / 8)
    for k in ("loss_cls", "loss_geo", "loss_sem"):
        assert math.isfinite(epoch0[k]) and epoch0[k] > 0, k
    assert set(res["best_test_acc"]) == {"source", "test1", "test2"}

    (ckpt,) = glob.glob(str(data_root / "output" / "**" / "modelnet_checkpoint_epoch_1.pt"),
                        recursive=True)
    payload = torch.load(ckpt, weights_only=True)
    assert payload["epoch"] == 1 and payload["optimizer"]["g"]["count"] == 2

    res = train_dg_single_gpu.main(_argv(data_root, 2, "--resume", ckpt))
    assert [h["epoch"] for h in res["history"]] == [1]
    (ckpt2,) = glob.glob(str(data_root / "output" / "**" / "modelnet_checkpoint_epoch_2.pt"),
                         recursive=True)
    assert torch.load(ckpt2, weights_only=True)["optimizer"]["dis"]["count"] == 4
    assert os.path.dirname(ckpt2) != os.path.dirname(ckpt)  # a second run's own folder


def test_grl_lambda_per_epoch(data_root, tmp_path, monkeypatch):
    """Every step of epoch e gets λ = sin((e + 1) / max_epoch · π/2)."""
    from sug_tpu_torch.engine.dg_trainer import DGTrainer

    cfg = tmp_path / "DG_grl_cl.yaml"
    cfg.write_text(f"_BASE_CONFIG_: {os.path.abspath(YAML)}\n"
                   "METHODS:\n"
                   "    GEO_MMD: [{NAME: CL, GEO_SCALE: 1}]\n"
                   "    SEM_MMD: [{NAME: MAX_HARD_MMD, SEM_SCALE: 1}]\n")
    monkeypatch.setenv("SUG_STACKED_FORWARD", "1")
    seen = []
    step = DGTrainer.train_step

    def recording_step(self, *args, **kwargs):
        seen.append((self.grl, kwargs["grl_const"]))
        return step(self, *args, **kwargs)

    monkeypatch.setattr(DGTrainer, "train_step", recording_step)
    argv = _argv(data_root, 2) + ["METHODS.GRL", "True"]
    argv[argv.index(YAML)] = str(cfg)
    res = train_dg_single_gpu.main(argv)
    assert [h["steps"] for h in res["history"]] == [2, 2]
    assert seen == [(True, math.sin(0.5 * math.pi / 2))] * 2 + [(True, 1.0)] * 2
    for h in res["history"]:
        for k in ("loss_cls", "loss_geo", "loss_sem"):
            assert math.isfinite(h[k]), (h["epoch"], k)


def test_other_models_raise(data_root):
    argv = _argv(data_root, 1)
    argv[argv.index("DGCNN")] = "KPConv"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_dg_single_gpu.main(argv)
