"""KPConv through the port's entry points on the CPU, on a tiny synthetic
PointDA tree (20 clouds a split, 128 points):

1. ``train_dg_single_gpu`` with ``DG_unified_loss_onedataset_modelnet_KPConv.yaml``
   as shipped, one epoch (``PURE_CLS_EPOCH`` 1: the classification losses
   alone) then ``--resume`` for a second (the MMD losses on), on the stacked
   forward, KPConv's default; the occupancy guard's line in the run's log;
2. ``infer --model KPConv --dg`` from its checkpoint, its predictions those
   of the loaded model's ensemble;
3. ``train_source --set Model KPConv`` one epoch, then ``infer`` without
   ``--dg`` from its checkpoint;
4. one step of the alternating trainer (uda) with KPConv, whose ``NetMDA``
   takes no MODEL_CFG, as the JAX trainer's.
"""

from __future__ import annotations

import glob
import math
import os

import numpy as np
import pytest
import torch

from sug_tpu_torch import infer, train_dg_single_gpu, train_source
from sug_tpu_torch.data.datasets import DATASET_LIST, PointCloudDataset, make_synthetic_pointda
from sug_tpu_torch.engine import dg_trainer as tdt
from sug_tpu_torch.engine.alternating_trainer import AlternatingTrainer
from tests._torch_port_common import one_torch_thread  # noqa: F401

CFGS = os.path.join(os.path.dirname(__file__), "..", "tools", "cfgs", "cfgs_local")
YAML = os.path.join(CFGS, "DG_unified_loss_onedataset_modelnet_KPConv.yaml")
SOURCE_YAML = os.path.join(CFGS, "direct_inference.yaml")
N = 128
LOSSES = ("loss_cls", "loss_adv", "loss_geo", "loss_sem")


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("kpconv_run") / "data" / "PointDA_data"
    for i, name in enumerate(DATASET_LIST):
        (root / name).mkdir(parents=True)
        for j, split in enumerate(("train", "test")):
            pts, labels = make_synthetic_pointda(num_per_class=2, num_points=N, seed=10 * i + j)
            np.save(root / name / f"{split}_pts.npy", pts)
            np.save(root / name / f"{split}_label.npy", labels)
    return root


def _checkpoint(root, epoch, tag="modelnet"):
    paths = glob.glob(str(root / "output" / "**" / f"{tag}_checkpoint_epoch_{epoch}.pt"),
                      recursive=True)
    return max(paths, key=os.path.getmtime)


def _argv(yaml, root, epochs, *extra, sets=()):
    return ["--source", "modelnet", "--cfg", yaml, "--batch_size", "10", "--num_points", str(N),
            "--device", "cpu", "--ckpt_save_interval", "1", "--fix_random_seed", *extra,
            "--set", "DATA_ROOT", str(root), "OPTIMIZATION.NUM_EPOCHES", str(epochs), *sets]


def _clouds(tmp_path, seed=9):
    raw, _ = make_synthetic_pointda(num_per_class=1, num_points=100, seed=seed)
    np.save(tmp_path / "clouds.npy", raw)
    return PointCloudDataset("modelnet", raw, np.zeros(len(raw)), num_points=N).pts


def test_shipped_config_trains_resumes_and_serves(data_root, tmp_path, monkeypatch):
    monkeypatch.delenv("SUG_KPCONV_STACKED", raising=False)
    monkeypatch.delenv("SUG_STACKED_FORWARD", raising=False)
    stacked_calls = []
    forward_stacked = tdt.DGTrainer._forward_stacked

    def counting(self, *args):
        stacked_calls.append(self.model_name)
        return forward_stacked(self, *args)

    monkeypatch.setattr(tdt.DGTrainer, "_forward_stacked", counting)
    res = train_dg_single_gpu.main(_argv(YAML, data_root, 1))
    (epoch0,) = res["history"]
    assert epoch0["epoch"] == 0 and epoch0["steps"] > 0
    assert len(stacked_calls) == epoch0["steps"] and set(stacked_calls) == {"KPConv"}
    assert math.isfinite(epoch0["loss_cls"]) and epoch0["loss_geo"] == 0.0  # PURE_CLS_EPOCH
    logs = glob.glob(str(data_root / "output" / "**" / "log_train_dg*.txt"), recursive=True)
    text = "".join(open(p).read() for p in logs)
    assert "KPConv pyramid occupancy (mean valid neighbors/level): L0=" in text

    ckpt = _checkpoint(data_root, 1)
    res = train_dg_single_gpu.main(_argv(YAML, data_root, 2, "--resume", ckpt))
    (epoch1,) = res["history"]
    assert epoch1["epoch"] == 1
    assert all(math.isfinite(epoch1[k]) for k in LOSSES) and epoch1["loss_geo"] > 0

    pts = _clouds(tmp_path)
    got = infer.main(["--ckpt", _checkpoint(data_root, 2), "--model", "KPConv", "--dg", "--pts",
                      str(tmp_path / "clouds.npy"), "--num_points", str(N), "--batch_size", "4",
                      "--device", "cpu"])
    model = infer.load_model("KPConv", _checkpoint(data_root, 2), torch.device("cpu"))
    with torch.no_grad():
        want = torch.argmax(infer.model_logits(model, torch.from_numpy(pts)), -1).numpy()
    np.testing.assert_array_equal(got["preds"], want)


def test_train_source_then_infer_without_dg(data_root, tmp_path):
    sets = ("Model", "KPConv", "EXTRA_TAG", "source_KPConv")
    res = train_source.main(_argv(SOURCE_YAML, data_root, 1, sets=sets))
    (epoch0,) = res["history"]
    assert epoch0["steps"] == 2 and math.isfinite(epoch0["loss"])
    ckpt = _checkpoint(data_root, 1)
    assert "source_KPConv" in ckpt
    pts = _clouds(tmp_path, seed=3)
    got = infer.main(["--ckpt", ckpt, "--model", "KPConv", "--pts", str(tmp_path / "clouds.npy"),
                      "--num_points", str(N), "--batch_size", "4", "--device", "cpu"])
    model = infer.load_model("KPConv", ckpt, torch.device("cpu"), dg=False)
    with torch.no_grad():
        want = torch.argmax(model(torch.from_numpy(pts))[0], -1).numpy()
    np.testing.assert_array_equal(got["preds"], want)


def test_alternating_step():
    """uda mode, one step: every loss finite, each of the three groups
    moved; MODEL_CFG does not reach the model (the defaults' capacities)."""
    cfg = {"MODEL_CFG": {"GRID_CAPACITIES": [128, 64, 32, 16, 8]}}
    tr = AlternatingTrainer("KPConv", mode="uda", cfg=cfg, augment=True, device="cpu", seed=0)
    assert tr.model.g.encoder.cfg["grid_capacities"] == (1024, 512, 256, 96, 48)
    pts, labels = make_synthetic_pointda(num_per_class=1, num_points=N, seed=5)
    before = {n: p.detach().clone() for n, p in tr.params}
    got = tr.train_step(pts[:4], labels[:4], pts[4:8], labels[4:8], 1e-3, 1e-3, 1e-3, 0.5)
    assert all(math.isfinite(float(v)) for v in got.values()), got
    moved = {n for n, p in tr.params if not torch.equal(p.detach(), before[n])}
    for prefix in ("g.", "c1.", "c2.", "attention_s.", "attention_t."):
        assert any(n.startswith(prefix) for n in moved), prefix
