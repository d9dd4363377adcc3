"""The port's training data path and config against the JAX package's: the
shuffled and class-balanced batch iterators give the same batches for the
same seed and epoch, the ``Random`` split draws the same subsets and shares
its ``.pkl`` index cache, the class weights of a dataset agree, and
``--set`` overrides parse the same way, except a bool onto a float key,
which the port keeps a bool (it raises instead of widening to 1.0).
Everything here is exact: both sides run the same numpy code paths.
"""

from __future__ import annotations

import numpy as np
import pytest

from sug_tpu.data import datasets as jd
from sug_tpu.data import sampler as js
from sug_tpu.utils import config as jcfg
from sug_tpu_torch.data import datasets as td
from sug_tpu_torch.data import sampler as ts
from sug_tpu_torch.utils import config as tcfg

YAML = "tools/cfgs/cfgs_local/DG_unified_loss.yaml"


def _datasets(n=37, num_points=32, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, num_points, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=n)
    labels[:10] = np.arange(10)
    return (jd.PointCloudDataset("modelnet", pts, labels, num_points=num_points),
            td.PointCloudDataset("modelnet", pts, labels, num_points=num_points))


def _assert_same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for (pa, la), (pb, lb) in zip(a, b):
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(la, lb)


@pytest.mark.parametrize("epoch", [0, 3])
def test_shuffled_batches_match(epoch):
    jds, tds = _datasets()
    j_it = js.BatchIterator(jds, 8, shuffle=True, seed=11)
    t_it = ts.BatchIterator(tds, 8, shuffle=True, seed=11)
    j_it.set_epoch(epoch)
    t_it.set_epoch(epoch)
    assert len(t_it) == len(j_it) == 4
    _assert_same_batches(j_it, t_it)


def test_sequential_batches_match():
    jds, tds = _datasets()
    _assert_same_batches(js.BatchIterator(jds, 8, shuffle=False, drop_last=False),
                         ts.BatchIterator(tds, 8, shuffle=False, drop_last=False))


@pytest.mark.parametrize("epoch", [0, 2])
def test_class_balanced_batches_match(epoch):
    jds, tds = _datasets(seed=1)
    j_it = js.ClassBalancedBatchIterator(jds, 8, class_per_batch=10, seed=5)
    t_it = ts.ClassBalancedBatchIterator(tds, 8, class_per_batch=10, seed=5)
    j_it.set_epoch(epoch)
    t_it.set_epoch(epoch)
    _assert_same_batches(j_it, t_it)


@pytest.mark.parametrize("q", [None, 0.7, "adaptive"])
def test_dataset_class_weights_match(q):
    jds, tds = _datasets(seed=2)
    assert tds.cls_num_counter == jds.cls_num_counter
    np.testing.assert_array_equal(tds.cls_wights("DLSA", q), jds.cls_wights("DLSA", q))


def _dump(root, name="modelnet", n=40, seed=3):
    rng = np.random.default_rng(seed)
    (root / name).mkdir(parents=True, exist_ok=True)
    np.save(root / name / "train_pts.npy", rng.normal(size=(n, 32, 3)).astype(np.float32))
    np.save(root / name / "train_label.npy", np.arange(n) % 10)


SPLIT = {"METHOD": "Random", "SUBSET_FULLSIZE": False, "SAMPLE_RATE": 0.5, "TRAIN_BASE": 1,
         "RELOAD": True}


@pytest.mark.parametrize("fullsize", [False, True])
def test_random_split_matches_and_shares_its_cache(tmp_path, fullsize):
    root_j, root_t = tmp_path / "j", tmp_path / "t"
    _dump(root_j)
    _dump(root_t)
    cfg = {**SPLIT, "SUBSET_FULLSIZE": fullsize, "RELOAD": False}
    np.random.seed(9)
    want = jd.create_splitted_dataset("modelnet", "train", config=cfg, data_root=str(root_j),
                                      pc_num=32, model="DGCNN")
    np.random.seed(9)
    got = td.create_splitted_dataset("modelnet", "train", config=cfg, data_root=str(root_t),
                                     pc_num=32, model="DGCNN")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.pts, w.pts)
        np.testing.assert_array_equal(g.labels, w.labels)
    name = "size_1.5Random_0.5.pkl" if fullsize else "size_1.0Random_0.5.pkl"
    assert (root_j / "modelnet" / name).exists() and (root_t / "modelnet" / name).exists()
    # RELOAD reads the JAX package's cache, whatever the numpy state
    np.random.seed(123)
    again = td.create_splitted_dataset("modelnet", "train", config={**cfg, "RELOAD": True},
                                       data_root=str(root_j), pc_num=32, model="DGCNN")
    for g, w in zip(again, want):
        np.testing.assert_array_equal(g.pts, w.pts)


def test_other_splitters_are_not_ported(tmp_path):
    _dump(tmp_path)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        td.create_splitted_dataset("modelnet", config={**SPLIT, "METHOD": "Cluster"},
                                   data_root=str(tmp_path))


SETS = [
    ["Model", "DGCNN"],
    ["OPTIMIZATION.LR", "0.001", "OPTIMIZATION.NUM_EPOCHES", "3"],
    ["METHODS.MMD_WEIGHT", "0"],  # an int onto a float key widens to 0.0
    ["METHODS.CLASS_BALANCE", "False", "DATASET.FIXED_X_ROTATION", "False"],
    ["RANDOM_SEED", "7", "MODEL_CFG.BN_SEMANTICS", "global"],
    ["DATASET_SPLITTER", "SAMPLE_RATE:0.25,METHOD:Random"],
]


@pytest.mark.parametrize("sets", SETS, ids=[s[0] for s in SETS])
def test_set_overrides_match(sets, monkeypatch):
    # the JAX parser fills one module-wide config; give it a fresh one, as
    # the port's parser makes for every call
    monkeypatch.setattr(jcfg, "cfg", jcfg.ConfigDict(LOCAL_RANK=0))
    _, want = jcfg.parser_config(["--cfg", YAML, "--set", *sets])
    _, got = tcfg.parser_config(["--cfg", YAML, "--set", *sets])
    assert got == want
    assert type(got["METHODS"]["MMD_WEIGHT"]) is type(want["METHODS"]["MMD_WEIGHT"])


def test_set_bool_stays_bool():
    """A bool onto a float key raises in the port (the JAX package widens it
    to 1.0); onto a bool key it is set as a bool."""
    with pytest.raises(TypeError, match="bool"):
        tcfg.parser_config(["--cfg", YAML, "--set", "METHODS.MMD_WEIGHT", "True"])
    _, cfg = tcfg.parser_config(["--cfg", YAML, "--set", "METHODS.GRL", "True"])
    assert cfg["METHODS"]["GRL"] is True
    with pytest.raises(KeyError, match="NotFoundKey"):
        tcfg.parser_config(["--cfg", YAML, "--set", "METHODS.NO_SUCH_KEY", "1"])
