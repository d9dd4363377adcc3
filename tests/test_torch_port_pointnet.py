"""PointNet in the port (``sug_tpu_torch/models/pointnet.py``, ``TransformNet``
in ``models/layers.py``, ``NetMDA("Pointnet")``) against the JAX package on
the CPU, with the same weights (flax init, BN statistics randomised, a third
of the BN scales negative, bridged by ``utils/jax_bridge.py``):

1. ``TransformNet`` and ``PointNetGenerator`` in eval mode, and
   ``NetMDA("Pointnet")`` in eval and in train mode (the same FPS starts,
   dropout off): every output, and in train mode the BN running statistics
   (the ConvBNs over B·N rows, ``bn1`` over the B global features);
2. the slice as a whole: one DG ``_loss(train=False)`` at B=2 source + 2
   target clouds of 4096 points, half of them zero-padded from 2048 points as
   ``--num_points 4096`` pads PointDA's clouds. There the port's chamfer
   takes ``chamfer_tiled`` and its FPS the ``fps`` wrapper (their plain
   versions on the CPU), the JAX package its plain chamfer and FPS loop;
3. ``infer --model Pointnet --dg`` from an ``.npz`` of the JAX variables
   against the JAX predictor;
4. the shipped config as it stands (``Model: Pointnet``) through the training
   front door, ``--device cpu --num_points 128``, one epoch then ``--resume``.

The DG ``_loss(train=True)`` and ``train_step`` of PointNet against the JAX
``DGTrainer`` are the ``Pointnet`` cases of ``test_torch_port_dg_step.py``.

Tolerances. Outputs 1e-4 abs + 1e-4 rel in eval mode (f32 sums in another
order through the T-Nets' 1024-wide layers); in train mode 1e-3, and the
batch statistics 2e-2 relative L2 per leaf, the DG step tests' bounds (the
batch statistics of ``bn1`` come from 4 rows). The 4096-point losses to 1e-4
relative, the DG step tests' bound.
"""

from __future__ import annotations

import functools
import glob
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import bench
from sug_tpu.data.datasets import PointCloudDataset as JDataset
from sug_tpu.engine import dg_trainer as jdt
from sug_tpu.models.layers import TransformNet as JTransformNet
from sug_tpu.models.net_mda import NetMDA as JNetMDA
from sug_tpu.models.pointnet import PointNetGenerator as JGenerator
from sug_tpu_torch import infer, train_dg_single_gpu
from sug_tpu_torch.data.datasets import DATASET_LIST, PointCloudDataset, make_synthetic_pointda
from sug_tpu_torch.engine import dg_trainer as tdt
from sug_tpu_torch.models.layers import TransformNet
from sug_tpu_torch.models.net_mda import NetMDA
from sug_tpu_torch.models.pointnet import PointNetGenerator
from sug_tpu_torch.ops import geometry_kernels
from sug_tpu_torch.ops.geometry import chamfer_distance
from sug_tpu_torch.utils.jax_bridge import load_jax_variables, state_dict_from_jax, torch_key
from tests._torch_port_common import (
    assert_rel_l2,
    jax_stats_by_name,
    port_module,
    randomize_variables,
    t,
)
from tests.test_torch_port_dg_step import _assert_metrics, _identity_dropout
from tests._torch_port_common import one_torch_thread  # noqa: F401  (autouse)

B, N = 4, 128
TOL = dict(rtol=1e-4, atol=1e-4)
TRAIN_TOL = dict(rtol=1e-3, atol=1e-3)
REL_L2 = 2e-2
OUTPUTS = ("logits1", "logits2", "sem1", "sem2", "global_feat", "node_flat", "node_offset",
           "node_attn")
YAML = "tools/cfgs/cfgs_local/DG_unified_loss.yaml"


def _clouds(seed, b=B, n=N):
    rng = np.random.default_rng(seed)
    pc = rng.uniform(-1, 1, size=(b, n, 3)) * rng.uniform(0.2, 1.0, size=(b, 1, 3))
    pc /= np.linalg.norm(pc, axis=-1).max(axis=-1)[:, None, None]
    return pc.astype(np.float32)


def _init(module, *args, **kwargs):
    variables = jax.jit(lambda: module.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, *args, **kwargs))()
    return randomize_variables(variables, seed=3)


@pytest.mark.parametrize("c,k", [(3, 3), (64, 64)])
def test_transform_net(c, k):
    x = np.random.default_rng(c).normal(size=(2, N, c)).astype(np.float32)
    jm = JTransformNet(k)
    variables = _init(jm, jnp.asarray(x), False)
    assert set(variables["params"]) == {"ConvBN_0", "ConvBN_1", "ConvBN_2", "FCLayer_0",
                                        "FCLayer_1", "Dense_0"}
    want = jax.jit(lambda v, a: jm.apply(v, a, False))(variables, jnp.asarray(x))
    got = port_module(TransformNet(c, k), variables)(t(x))
    assert got.shape == (2, k, k)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_generator_eval():
    pc = _clouds(0)
    fps = np.array([5, 0, 127, 17])
    jm = JGenerator()
    variables = _init(jm, jnp.asarray(pc), False)
    want = jax.jit(lambda v, a, f: jm.apply(v, a, False, f))(variables, jnp.asarray(pc),
                                                             jnp.asarray(fps))
    got = port_module(PointNetGenerator(), variables)(t(pc), torch.from_numpy(fps))
    for g, w, shape in zip(got, want, ((B, 1024), (B, 64, 64), (B, 64, 3))):
        assert g.shape == shape
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)


@pytest.fixture(scope="module")
def jax_model():
    """NetMDA(Pointnet) with randomised variables whose predictions vary by
    cloud: each head's output bias is shifted by minus its mean logits over
    a calibration set. Returns the model, its variables and its jitted eval
    ``apply(variables, pc, domain)``."""
    jm = JNetMDA(model_name="Pointnet", num_class=10)
    variables = _init(jm, jnp.zeros((B, N, 3)), True, domain="both")
    apply = jax.jit(lambda v, pc, domain=None: jm.apply(v, pc, False, domain=domain),
                    static_argnames="domain")
    out = apply(variables, jnp.asarray(_clouds(99, 16)))
    for head in ("c1", "c2"):
        variables["params"][head]["mlp3"]["bias"] -= np.asarray(out["logits" + head[1]]).mean(0)
    return jm, variables, apply


def test_bridge_fills_every_pointnet_tensor(jax_model):
    flat = flatten_dict(jax_model[1])
    sd = state_dict_from_jax(jax_model[1])
    assert set(sd) == set(NetMDA("Pointnet").state_dict()) and len(sd) == len(flat)
    for key in ("g.trans_net2.convbn2.bn.running_var", "g.trans_net1.fc1.ln.weight",
                "g.trans_net2.dense0.bias", "g.conv5.dense0.weight", "g.bn1.running_mean",
                "g.sa_node.residual.bn.weight", "c1.mlp1.dense0.weight"):
        assert key in sd, key
    assert torch_key(("g", "trans_net1", "FCLayer_0", "Dense_0", "kernel")) == \
        "g.trans_net1.fc0.dense0.weight"
    assert NetMDA("Pointnet").c1.mlp1.dense0.bias is None  # the relu heads' mlp1 has no bias


def test_net_mda_eval(jax_model):
    _, variables, apply = jax_model
    pc = _clouds(1)
    want = apply(variables, jnp.asarray(pc), domain="both")
    model = NetMDA("Pointnet")
    load_jax_variables(model, variables)
    with torch.no_grad():
        got = model.eval()(t(pc), "both")
    assert set(got) == set(want)
    for k in OUTPUTS + ("node_attn_t",):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("domain", ["source", "target"])
def test_net_mda_train_mode(jax_model, monkeypatch, domain):
    jm, variables, _ = jax_model
    model = NetMDA("Pointnet")
    load_jax_variables(model, variables)
    _identity_dropout(monkeypatch, type("Heads", (), {"model": model}))
    pc = _clouds(2)
    fps = np.array([5, 0, 127, 17])
    want, updates = jax.jit(lambda v, p, f: jm.apply(
        v, p, True, domain=domain, fps_start=f, mutable=["batch_stats"],
        rngs={"dropout": jax.random.key(2)}))(variables, jnp.asarray(pc), jnp.asarray(fps))
    got = model.train()(t(pc), domain, torch.from_numpy(fps), torch.Generator().manual_seed(0))
    for k in OUTPUTS:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), err_msg=k,
                                   **TRAIN_TOL)
    assert_rel_l2({n: b.numpy() for n, b in model.named_buffers()},
                  jax_stats_by_name(updates["batch_stats"]), REL_L2)


def test_dg_loss_at_4096_points(jax_model):
    """The slice as a whole at ``--num_points 4096``: the routed chamfer and
    FPS inside one DG loss, against the JAX package's plain ones."""
    _, variables, _ = jax_model
    cfg = bench._make_cfg()
    raw, labels = make_synthetic_pointda(num_per_class=1, num_points=4096, seed=4)
    short, short_labels = make_synthetic_pointda(num_per_class=1, num_points=2048, seed=5)
    src = PointCloudDataset("modelnet", raw[:2], labels[:2], num_points=4096).pts
    tgt = PointCloudDataset("scannet", short[2:4], short_labels[2:4], num_points=4096).pts
    assert not tgt[:, 2048:].any()  # zero-padded, as PointDA's 2048-point clouds are
    batch = (src, labels[:2].astype(np.int64), tgt, short_labels[2:4].astype(np.int64))
    # mean2one truncates 1/mean to an integer: keep the geo weighting away from the jump
    geo = 1.0 / chamfer_distance(torch.from_numpy(src), torch.from_numpy(tgt)).mean().item()
    assert abs(geo - round(geo)) > 0.02, geo

    jtr = jdt.DGTrainer(cfg, model_name="Pointnet", augment=False)
    fn = jax.jit(functools.partial(jtr._loss, mmd_on=True, train=False))
    _, (_, want) = fn(variables["params"], variables["batch_stats"], *map(jnp.asarray, batch),
                      jax.random.key(0), 0.0)
    tr = tdt.DGTrainer(cfg, model_name="Pointnet", augment=False, device="cpu")
    load_jax_variables(tr.model, variables)
    geometry_kernels.min_dists.launches = geometry_kernels.fps.launches = 0
    with torch.no_grad():
        _, got = tr._loss(*(torch.from_numpy(a) for a in batch), mmd_on=True, train=False)
    assert "loss_geo" in got and "loss_sem" in got
    _assert_metrics(got, want)
    assert geometry_kernels.min_dists.launches == 0 and geometry_kernels.fps.launches == 0


def test_infer_pointnet_matches_jax_predictor(jax_model, tmp_path):
    _, variables, apply = jax_model
    ckpt = tmp_path / "pointnet.npz"
    np.savez(ckpt, **flatten_dict(variables, sep="/"))
    raw = _clouds(3, 6, 100) * 3.0 + 0.5  # padded to N, and ingest normalises
    np.save(tmp_path / "clouds.npy", raw)
    res = infer.main(["--ckpt", str(ckpt), "--model", "Pointnet", "--dg", "--pts",
                      str(tmp_path / "clouds.npy"), "--num_points", str(N), "--batch_size", "4",
                      "--device", "cpu"])
    ds = JDataset("modelnet", raw, np.zeros(len(raw)), aug=False, num_points=N)
    out = apply(variables, jnp.asarray(ds.pts))
    want = np.asarray(jnp.argmax((out["logits1"] + out["logits2"]) / 2.0, -1))
    assert len(np.unique(want)) > 1
    np.testing.assert_array_equal(res["preds"], want)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("pointnet_run") / "data" / "PointDA_data"
    for i, name in enumerate(DATASET_LIST):
        (root / name).mkdir(parents=True)
        for j, split in enumerate(("train", "test")):
            pts, labels = make_synthetic_pointda(num_per_class=4 if split == "train" else 2,
                                                 num_points=N, seed=10 * i + j)
            np.save(root / name / f"{split}_pts.npy", pts)
            np.save(root / name / f"{split}_label.npy", labels)
    return root


def test_shipped_config_trains_pointnet_then_resumes(data_root):
    def argv(epochs, *extra):
        return ["--source", "modelnet", "--cfg", YAML, "--batch_size", "8", "--num_points", str(N),
                "--device", "cpu", "--ckpt_save_interval", "1", "--fix_random_seed", *extra,
                "--set", "DATA_ROOT", str(data_root), "OPTIMIZATION.NUM_EPOCHES", str(epochs)]

    res = train_dg_single_gpu.main(argv(1))
    (epoch0,) = res["history"]
    assert epoch0["epoch"] == 0 and epoch0["steps"] == 2
    assert epoch0["eval_batches"] == 3 * math.ceil(20 / 8)
    for k in ("loss_cls", "loss_geo", "loss_sem"):
        assert math.isfinite(epoch0[k]) and epoch0[k] > 0, k
    (ckpt,) = glob.glob(str(data_root / "output" / "**" / "modelnet_checkpoint_epoch_1.pt"),
                        recursive=True)
    payload = torch.load(ckpt, weights_only=True)
    assert payload["optimizer"]["g"]["count"] == 2
    assert "g.trans_net2.dense0.weight" in payload["state"]  # the config's Model: Pointnet
    res = train_dg_single_gpu.main(argv(2, "--resume", ckpt))
    assert [h["epoch"] for h in res["history"]] == [1]
