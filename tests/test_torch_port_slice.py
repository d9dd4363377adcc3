"""The slice end to end: NetMDA(DGCNN) eval forward and the port's ``infer``
against the JAX package on the CPU, with the same weights (``NetMDA.init``
plus randomised BN stats and signed BN scales, carried over through an
``.npz`` of the JAX variables and the weight bridge).

Tolerance of the forward: 1e-4 abs + 1e-4 rel. The two libraries order f32
sums differently in every matmul and reduction, and the differences pass
through four EdgeConv blocks, the SA-node, conv5 and the heads. ``infer``'s
predictions must equal the JAX predictor's argmax exactly, and its
accuracies the JAX ``Evaluator``'s; the average loss to 1e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from sug_tpu.data.datasets import PointCloudDataset as JDataset
from sug_tpu.data.datasets import create_single_dataset as j_create_single_dataset
from sug_tpu.data.sampler import BatchIterator as JBatchIterator
from sug_tpu.engine.evaluation import Evaluator as JEvaluator
from sug_tpu.models.net_mda import NetMDA as JNetMDA
from sug_tpu_torch import infer
from sug_tpu_torch.engine.checkpoint import load_checkpoint, save_checkpoint
from sug_tpu_torch.models.net_mda import NetMDA
from sug_tpu_torch.utils.jax_bridge import (
    load_jax_variables,
    state_dict_from_jax,
    torch_key,
    unflatten,
)
from tests._torch_port_common import randomize_variables, t

TOL = dict(rtol=1e-4, atol=1e-4)
N_POINTS = 128


def _clouds(seed, m):
    """Boxes of random aspect ratios, unit max-norm."""
    rng = np.random.default_rng(seed)
    pc = rng.uniform(-1, 1, size=(m, N_POINTS, 3)) * rng.uniform(0.1, 1.0, size=(m, 1, 3))
    pc /= np.linalg.norm(pc, axis=-1).max(axis=-1)[:, None, None]
    return pc.astype(np.float32)


@pytest.fixture(scope="module")
def jax_model():
    """NetMDA(DGCNN) with random weights whose predictions vary by cloud:
    random heads send every cloud to one class, so each head's output bias
    is shifted by minus its mean logits over a calibration set. Returns the
    model, its variables and its jitted eval ``apply(variables, pc, domain)``
    (jitted: eager flax runs the whole DGCNN several times slower)."""
    jm = JNetMDA(model_name="DGCNN", num_class=10)
    variables = jax.jit(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.zeros((2, N_POINTS, 3)), True, domain="both",
    ))()
    variables = randomize_variables(variables, seed=7)
    apply = jax.jit(lambda v, pc, domain=None: jm.apply(v, pc, False, domain=domain),
                    static_argnames="domain")
    out = apply(variables, jnp.asarray(_clouds(99, 16)))
    for head in ("c1", "c2"):
        logits = np.asarray(out["logits" + head[1]])
        variables["params"][head]["mlp3"]["bias"] -= logits.mean(axis=0)
    return jm, variables, apply


@pytest.fixture(scope="module")
def npz_ckpt(jax_model, tmp_path_factory):
    """The JAX variables as an .npz, written as the README shows."""
    path = tmp_path_factory.mktemp("ckpt") / "dgcnn.npz"
    np.savez(path, **flatten_dict(jax_model[1], sep="/"))
    return str(path)


@pytest.fixture(scope="module")
def port_model(npz_ckpt):
    model = NetMDA("DGCNN")
    assert load_checkpoint(npz_ckpt, model) is None
    return model.eval()


@pytest.mark.parametrize("domain", [None, "both"])
def test_net_mda_forward(jax_model, port_model, domain):
    _, variables, apply = jax_model
    pc = _clouds(0, 2)
    want = apply(variables, jnp.asarray(pc), domain=domain)
    with torch.no_grad():
        got = port_model(t(pc), domain=domain)
    keys = ["logits1", "logits2", "sem1", "sem2", "node_flat", "global_feat", "node_offset"]
    if domain == "both":
        keys += ["node_attn", "node_attn_t"]
    assert set(got) == set(want)
    assert got["node_flat"].shape == (2, 64 * 64)
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)


def test_infer_pts_matches_jax_predictor(jax_model, npz_ckpt, tmp_path):
    _, variables, apply = jax_model
    raw = _clouds(1, 6) * 3.0 + 0.5  # ingest normalises
    pts_file = tmp_path / "clouds.npy"
    np.save(pts_file, raw)
    out_file = tmp_path / "preds.npy"
    res = infer.main([
        "--ckpt", npz_ckpt, "--model", "DGCNN", "--dg", "--pts", str(pts_file),
        "--num_points", str(N_POINTS), "--batch_size", "4", "--device", "cpu",
        "--save", str(out_file),
    ])
    ds = JDataset("modelnet", raw, np.zeros(len(raw)), aug=False, num_points=N_POINTS)
    out = apply(variables, jnp.asarray(ds.pts))
    want = np.asarray(jnp.argmax((out["logits1"] + out["logits2"]) / 2.0, -1))
    assert len(np.unique(want)) > 1
    np.testing.assert_array_equal(res["preds"], want)
    np.testing.assert_array_equal(np.load(out_file), want)


def test_infer_dataset_matches_jax_evaluator(jax_model, npz_ckpt, tmp_path):
    jm, variables, _ = jax_model
    root = tmp_path / "PointDA"
    (root / "scannet").mkdir(parents=True)
    np.save(root / "scannet" / "test_pts.npy", _clouds(2, 20))
    np.save(root / "scannet" / "test_label.npy", np.arange(20) % 10)
    res = infer.main([
        "--ckpt", npz_ckpt, "--model", "DGCNN", "--dg", "--dataset", "scannet",
        "--split", "test", "--data_root", str(root), "--num_points", str(N_POINTS),
        "--batch_size", "8", "--device", "cpu",
    ])

    def apply_fn(params, batch_stats, data):
        out = jm.apply({"params": params, "batch_stats": batch_stats}, data, False)
        return (out["logits1"] + out["logits2"]) / 2.0

    ds = j_create_single_dataset("scannet", "test", model="DGCNN", data_root=str(root),
                                 pc_num=N_POINTS)
    want = JEvaluator(apply_fn).run(
        variables["params"], variables["batch_stats"],
        JBatchIterator(ds, 8, shuffle=False, drop_last=False),
    )
    assert 0.0 < want["overall_acc"] < 1.0
    assert res["overall_acc"] == want["overall_acc"]
    assert res["mean_class_acc"] == want["mean_class_acc"]
    np.testing.assert_array_equal(res["class_acc"], want["class_acc"])
    np.testing.assert_allclose(res["avg_loss"], want["avg_loss"], rtol=1e-5)


def test_bridge_fills_every_tensor_from_every_leaf(jax_model):
    flat = flatten_dict(jax_model[1])
    sd = state_dict_from_jax(jax_model[1])
    want = NetMDA("DGCNN").state_dict()
    assert set(sd) == set(want) and len(sd) == len(flat)
    for (_, *path), leaf in flat.items():
        got = sd[torch_key(tuple(path))].numpy()
        np.testing.assert_array_equal(got, leaf.T if path[-1] == "kernel" else leaf)
        assert got.shape == tuple(want[torch_key(tuple(path))].shape)


@pytest.mark.parametrize("edit", ["extra_leaf", "missing_leaf", "extra_collection"])
def test_bridge_leftovers_raise(jax_model, edit):
    flat = flatten_dict(jax_model[1], sep="/")
    if edit == "extra_leaf":
        flat["params/g/block1/unused"] = np.zeros(3, np.float32)
    elif edit == "missing_leaf":
        del flat["params/c1/mlp3/bias"]
    else:
        flat["cache/x"] = np.zeros(1, np.float32)
    error = KeyError if edit == "extra_collection" else RuntimeError
    with pytest.raises(error):
        load_jax_variables(NetMDA("DGCNN"), unflatten(flat))


def test_checkpoint_round_trip_is_exact(port_model, tmp_path):
    path = save_checkpoint(str(tmp_path / "run" / "dgcnn.pt"), port_model, epoch=7)
    fresh = NetMDA("DGCNN")
    assert load_checkpoint(path, fresh) == 7
    saved, loaded = port_model.state_dict(), fresh.state_dict()
    assert saved.keys() == loaded.keys()
    for k in saved:
        assert torch.equal(saved[k], loaded[k]), k


def test_infer_without_dg_is_not_ported(npz_ckpt):
    """Without ``--dg`` infer serves a standalone classifier
    (``tests/test_torch_port_source_train.py``), and refuses the twin-head
    model's variables: the classifier has no tensor for most of them."""
    with pytest.raises(RuntimeError, match="Unexpected key"):
        infer.main(["--ckpt", npz_ckpt, "--pts", "x.npy", "--device", "cpu"])


def test_other_backbones_are_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        NetMDA("KPConv")
