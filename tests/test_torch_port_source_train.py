"""The source-only path of the port against the JAX package on the CPU.

1. Three ``SourceTrainer.train_step``s of the DGCNN classifier against the
   JAX ``SourceTrainer``'s, at lr 1e-4 with ``augment=False`` and head
   dropout off on both sides, on B=4 clouds of 128 points, the weights
   bridged from the port's init (BN stats randomised, a third of the BN
   scales negative): the loss and accuracy of every step, and after the
   first step every parameter's change and the Adam moments against
   JAX's.
2. ``train_source`` (``direct_inference.yaml``, PointNet, the shipped
   config's model) for one epoch on a tiny synthetic PointDA tree at
   ``--device cpu``, then ``--resume`` from its checkpoint, which continues
   at the next epoch with the optimizer's step count carried over; and
   ``--pretrained_model``, which takes the weights and not the optimizer.
3. ``infer`` without ``--dg`` serving the JAX DGCNN classifier's variables
   from an ``.npz``: its predictions equal the JAX predictor's argmax.

Tolerances, as ``tests/test_torch_port_dg_step.py`` holds the DG steps: the
first step's loss 1e-4 relative, its parameters' changes and moments 2e-2
relative L2 per leaf (the gradients' bound); after it Adam moves every parameter by
about ``lr·sign(g)``, so a gradient that is zero up to rounding steps
either way and the two runs drift apart, and steps 2 and 3 hold the loss to
2e-3 (the DG test's bound for its later steps' total).
"""

from __future__ import annotations

import glob
import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from sug_tpu.data.datasets import PointCloudDataset as JDataset
from sug_tpu.engine.source_trainer import SourceTrainer as JSourceTrainer
from sug_tpu.engine.source_trainer import SourceTrainState
from sug_tpu.models import make_classifier as j_make_classifier
from sug_tpu_torch import infer, train_source
from sug_tpu_torch.data.datasets import DATASET_LIST, make_synthetic_pointda
from sug_tpu_torch.engine.source_trainer import SourceTrainer
from sug_tpu_torch.models import make_classifier
from sug_tpu_torch.utils.jax_bridge import load_jax_variables
from tests._torch_port_common import (  # noqa: F401  (one_torch_thread is autouse)
    assert_rel_l2,
    jax_grads_by_name,
    one_torch_thread,
    port_weights_as_jax,
)
from tests.test_torch_port_classifiers import no_dropout

B, N = 4, 128
LR = 1e-4
YAML = "tools/cfgs/cfgs_local/direct_inference.yaml"


@pytest.fixture(scope="module")
def dgcnn_variables():
    port = make_classifier("DGCNN", generator=torch.Generator().manual_seed(0))
    return port_weights_as_jax(j_make_classifier("DGCNN", 10), port.state_dict(),
                               jnp.zeros((B, N, 3)), True)


def test_three_train_steps_match_jax(dgcnn_variables, monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    variables = dgcnn_variables
    pts, labels = make_synthetic_pointda(num_per_class=1, num_points=N, seed=4)
    data, label = pts[:B], labels[:B].astype(np.int32)
    jtr = JSourceTrainer("DGCNN", augment=False)
    state = SourceTrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                             opt_state=jtr._tx.init(variables["params"]),
                             step=jnp.zeros((), jnp.int32))
    tr = SourceTrainer("DGCNN", augment=False, device="cpu")
    load_jax_variables(tr.model, variables)
    no_dropout(tr.model)
    before = {n: p.detach().clone() for n, p in tr.params}
    for i in range(3):
        j_before = state.params
        state, want = jtr.train_step(state, data, label, jax.random.key(i), LR)
        got = tr.train_step(data, label, LR)
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   rtol=1e-4 if i == 0 else 2e-3, err_msg=f"step {i}")
        assert float(got["acc"]) == float(want["acc"]), i
        if i == 0:
            assert_rel_l2({n: (p.detach() - before[n]).numpy() for n, p in tr.params},
                          jax_grads_by_name(jax.tree.map(
                              lambda a, b: np.asarray(a) - np.asarray(b), state.params,
                              j_before)), 2e-2)
            names = [n for n, _ in tr.params]
            for key in ("mu", "nu"):
                moments = (m.numpy() for m in tr.optimizer.state["all"][key])
                assert_rel_l2(dict(zip(names, moments)),
                              jax_grads_by_name(getattr(state.opt_state[1], key)), 2e-2)
    assert int(state.step) == 3 and tr.optimizer.state["all"]["count"] == 3


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("source_run") / "data" / "PointDA_data"
    for i, name in enumerate(DATASET_LIST):
        (root / name).mkdir(parents=True)
        for j, split in enumerate(("train", "test")):
            pts, labels = make_synthetic_pointda(num_per_class=2, num_points=N, seed=10 * i + j)
            np.save(root / name / f"{split}_pts.npy", pts)
            np.save(root / name / f"{split}_label.npy", labels)
    return root


def _argv(root, epochs, *extra):
    return ["--source", "modelnet", "--cfg", YAML, "--batch_size", "8", "--num_points", str(N),
            "--device", "cpu", "--ckpt_save_interval", "1", "--fix_random_seed", *extra,
            "--set", "DATA_ROOT", str(root), "OPTIMIZATION.NUM_EPOCHES", str(epochs)]


def _checkpoint(root, epoch):
    (path,) = glob.glob(str(root / "output" / "**" / f"modelnet_checkpoint_epoch_{epoch}.pt"),
                        recursive=True)
    return path


def test_train_source_one_epoch_then_resume(data_root):
    res = train_source.main(_argv(data_root, 1))
    (epoch0,) = res["history"]
    # 20 modelnet train clouds in drop-last batches of 8; 20 test clouds per dataset
    assert epoch0["epoch"] == 0 and epoch0["steps"] == 2
    assert epoch0["eval_batches"] == 3 * math.ceil(20 / 8)
    assert math.isfinite(epoch0["loss"]) and epoch0["loss"] > 0
    assert set(res["best_test_acc"]) == {"source", "test1", "test2"}
    ckpt = _checkpoint(data_root, 1)
    payload = torch.load(ckpt, weights_only=True)
    assert payload["epoch"] == 1 and payload["optimizer"]["all"]["count"] == 2

    res = train_source.main(_argv(data_root, 2, "--resume", ckpt))
    assert [h["epoch"] for h in res["history"]] == [1]
    assert torch.load(_checkpoint(data_root, 2), weights_only=True)["optimizer"]["all"]["count"] == 4

    # the weights only: a fresh optimizer, from epoch 0
    res = train_source.main(_argv(data_root, 1, "--pretrained_model", ckpt))
    assert [h["epoch"] for h in res["history"]] == [0]


def test_infer_without_dg_matches_jax_predictor(dgcnn_variables, tmp_path):
    variables = jax.tree.map(np.copy, dgcnn_variables)
    jm = j_make_classifier("DGCNN", 10)
    apply = jax.jit(lambda v, x: jm.apply(v, x, False)[0])
    raw, _ = make_synthetic_pointda(num_per_class=1, num_points=100, seed=9)
    ds = JDataset("modelnet", raw, np.zeros(len(raw)), aug=False, num_points=N)
    # random heads send every cloud to one class: centre the logits
    variables["params"]["classifier"]["mlp3"]["bias"] -= np.asarray(
        apply(variables, jnp.asarray(ds.pts))).mean(0)
    want = np.asarray(jnp.argmax(apply(variables, jnp.asarray(ds.pts)), -1))
    assert len(np.unique(want)) > 1
    ckpt = tmp_path / "dgcnn_classifier.npz"
    np.savez(ckpt, **flatten_dict(variables, sep="/"))
    np.save(tmp_path / "clouds.npy", raw)
    res = infer.main(["--ckpt", str(ckpt), "--model", "DGCNN", "--pts",
                      str(tmp_path / "clouds.npy"), "--num_points", str(N), "--batch_size", "4",
                      "--device", "cpu"])
    np.testing.assert_array_equal(res["preds"], want)
