"""PTran DG training in the port against the JAX package on the CPU, at the
transformer width 512 with clouds of 64 points (levels of 64, 16, 4, 1 and 1
points, k = 16, 16, 4, 1, 1) and B=4 source + 4 target clouds. The JAX side
runs its XLA vector attention (its default on the CPU); the port runs the
plain versions of its forward and backward ops. Weights are bridged from the
JAX init, BN statistics randomised, a third of the BN scales negative.

1. ``NetMDA("PTran")`` in train mode against flax ``apply`` with the same FPS
   starts and dropout off: every output, and the BN running statistics after
   the forward (TransitionDown's ConvBN over B·npoint·k rows, the channel
   attention's BN).
2. ``DGTrainer._loss(train=True)`` against
   ``sug_tpu.engine.dg_trainer.DGTrainer(model_name="PTran")`` with the FPS
   starts JAX draws: every metric, every parameter's gradient (MMD losses
   off for those, as in ``test_torch_port_dg_step.py``: the sigma=0.01 MMD
   kernel multiplies rounding by 5000), the new batch statistics.
3. One ``train_step`` with ``augment=False`` and the MMD losses off: the
   losses, the parameters after it and the batch statistics.
4. The optimizer's group masks on PTran's parameter names.
5. The front door: ``train_dg_single_gpu --set Model PTran --device cpu
   --num_points 64`` for one epoch, then ``--resume``. A trainer that built
   its model for the default 1024 points would raise at the first batch.

Tolerances. Outputs of the forward 1e-3 abs + 1e-3 rel: f32 sums in another
order through five attention levels and, in train mode, four TransitionDowns
whose batch statistics at the last levels come from 16 and 4 rows (measured
3.4e-4 on one of 2048 global features). Every loss 1e-4 relative. Gradients
and batch statistics in relative L2 per leaf at most 2e-2, the DGCNN step
test's bound (measured 2.3e-4). After one Adam step a parameter has moved by lr·sign(g) in
each of its two groups (g and dis), the same on both sides unless its
gradient is zero up to rounding, as that of a Dense bias before a train-mode
BN is: so no element may differ by more than 4.1·lr, at most 1e-3 of all
elements and 1% of any weight matrix by more than 1e-2·lr (measured 1.6e-4,
0.31% in ``transformer4.fc_delta2``, whose clouds are single points).
"""

from __future__ import annotations

import glob
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import bench
from sug_tpu.engine import dg_trainer as jdt
from sug_tpu.engine import optim as jo
from sug_tpu.engine.optim import ThreeGroupOptimizer as JOptimizer
from sug_tpu.models.net_mda import NetMDA as JNetMDA
from sug_tpu_torch import train_dg_single_gpu
from sug_tpu_torch.data.datasets import DATASET_LIST, make_synthetic_pointda
from sug_tpu_torch.engine import dg_trainer as tdt
from sug_tpu_torch.engine import optim as to
from sug_tpu_torch.models.net_mda import NetMDA
from sug_tpu_torch.utils.jax_bridge import load_jax_variables, torch_key
from tests._torch_port_common import (
    assert_rel_l2,
    jax_grads_by_name,
    jax_stats_by_name,
    randomize_variables,
    t,
)
from tests.test_torch_port_dg_step import (
    _assert_metrics,
    _both_losses,
    _identity_dropout,
    _torch_batch,
)
from tests._torch_port_common import one_torch_thread  # noqa: F401  (autouse)

B, N = 4, 64
FWD_TOL = dict(rtol=1e-3, atol=1e-3)
REL_L2 = 2e-2
LR = 1e-3
OUTPUTS = ("logits1", "logits2", "sem1", "sem2", "global_feat", "node_flat", "node_attn")
YAML = "tools/cfgs/cfgs_local/DG_unified_loss.yaml"


@pytest.fixture(scope="module")
def setup():
    """The JAX PTran trainer, its randomised variables and one batch pair."""
    cfg = bench._make_cfg()
    jtr = jdt.DGTrainer(cfg, model_name="PTran", augment=False)
    variables = jax.jit(lambda: jtr.model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.zeros((B, N, 3)), True, domain="both"))()
    variables = randomize_variables(variables, seed=5)
    assert variables["params"]["g"]["point_mix"]["kernel"].shape == (N // 16, 64)
    jtr.optimizer = JOptimizer(variables["params"], float(cfg["OPTIMIZATION"]["WEIGHT_DECAY"]))
    pts, labels = make_synthetic_pointda(num_per_class=1, num_points=N, seed=3)
    batch = (pts[:B], labels[:B].astype(np.int64), pts[-B:], labels[-B:].astype(np.int64))
    return cfg, jtr, variables, batch


def _port_trainer(setup):
    cfg, _, variables, _ = setup
    tr = tdt.DGTrainer(cfg, model_name="PTran", augment=False, device="cpu", num_points=N)
    load_jax_variables(tr.model, variables)
    return tr


def _jax_fps(key):
    """The FPS starts ``DGTrainer._forward_both`` draws from its key."""
    k_s, k_t, _, _ = jax.random.split(key, 4)
    return (torch.from_numpy(np.array(jax.random.randint(k_s, (B,), 0, N))),
            torch.from_numpy(np.array(jax.random.randint(k_t, (B,), 0, N))))


@pytest.mark.parametrize("domain", ["source", "target"])
def test_net_mda_ptran_train_mode(setup, monkeypatch, domain):
    _, _, variables, batch = setup
    model = NetMDA("PTran", num_points=N)
    load_jax_variables(model, variables)
    tr = type("Heads", (), {"model": model})
    _identity_dropout(monkeypatch, tr)
    pc = batch[0]
    fps = np.array([5, 0, 63, 17])
    jm = JNetMDA(model_name="PTran", num_class=10)
    want, updates = jax.jit(lambda v, p, f: jm.apply(
        v, p, True, domain=domain, fps_start=f, mutable=["batch_stats"],
        rngs={"dropout": jax.random.key(2)}))(variables, jnp.asarray(pc), jnp.asarray(fps))
    before = {n: b.clone() for n, b in model.named_buffers()}
    got = model.train()(t(pc), domain, torch.from_numpy(fps), torch.Generator().manual_seed(0))
    assert got["node_offset"] is None and got["global_feat"].shape == (B, 512)
    for name in OUTPUTS:
        np.testing.assert_allclose(got[name].detach().numpy(), np.asarray(want[name]),
                                   err_msg=name, **FWD_TOL)
    stats = {n: b.numpy() for n, b in model.named_buffers()}
    assert_rel_l2(stats, jax_stats_by_name(updates["batch_stats"]), REL_L2)
    # the forward moved the statistics of the layers it ran, and only those
    other = "attention_t" if domain == "source" else "attention_s"
    for n, b in model.named_buffers():
        assert torch.equal(b, before[n]) == n.startswith(other), n


def test_ptran_dg_loss_train_mode(setup, monkeypatch):
    _, jtr, variables, batch = setup
    tr = _port_trainer(setup)
    _identity_dropout(monkeypatch, tr)
    key = jax.random.key(7)
    out = _both_losses(jtr, tr, variables, batch, key, _jax_fps(key), train=True)
    for got, want, *_ in out.values():
        _assert_metrics(got, want)
    assert "loss_geo" in out[True][0] and "loss_sem" in out[True][0]
    _, _, g_grads, w_grads, _, _ = out[False]
    assert_rel_l2(g_grads, w_grads, REL_L2)
    assert_rel_l2(out[True][4], out[True][5], REL_L2)
    # every backbone weight the attention kernels take gets a gradient
    for name in ("fc_delta1", "fc_delta2", "fc_gamma1"):
        assert np.abs(g_grads[f"g.backbone.transformer1.{name}.weight"]).max() > 0


def test_ptran_train_step(setup, monkeypatch):
    _, jtr, variables, batch = setup
    tr = _port_trainer(setup)
    _identity_dropout(monkeypatch, tr)
    state = jdt.DGTrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                             opt_state=jtr.optimizer.init(variables["params"]),
                             step=jnp.zeros((), jnp.int32))
    key = jax.random.key(100)
    fps_s, fps_t = _jax_fps(key)
    state, want = jtr.train_step(state, *batch, key, LR, LR, LR, mmd_on=False)
    got = tr.train_step(*_torch_batch(batch), LR, LR, LR, mmd_on=False, fps_s=fps_s, fps_t=fps_t)
    _assert_metrics(got, want)
    assert int(state.step) == 1 and tr.optimizer.state["g"]["count"] == 1
    want_p = jax_grads_by_name(state.params)  # the same rename and transpose as for gradients
    beyond, total, worst_matrix, worst_diff = 0, 0, 0.0, 0.0
    for name, p in tr.params:
        diff = np.abs(p.detach().numpy() - want_p[name])
        beyond += int((diff > 1e-2 * LR).sum())
        total += diff.size
        worst_diff = max(worst_diff, float(diff.max()))
        if diff.ndim > 1:
            worst_matrix = max(worst_matrix, float((diff > 1e-2 * LR).mean()))
    print(f"after one step: {beyond / total:.2e} of all elements beyond 1e-2·lr, at most "
          f"{worst_matrix:.2%} of a weight matrix, largest difference {worst_diff / LR:.3f}·lr")
    assert beyond <= 1e-3 * total and worst_matrix <= 1e-2 and worst_diff <= 4.1 * LR
    assert_rel_l2({n: b.numpy() for n, b in tr.model.named_buffers()},
                  jax_stats_by_name(state.batch_stats), REL_L2)


def test_group_masks_on_ptran_names():
    jm = JNetMDA(model_name="PTran", num_class=10)
    variables = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.zeros((2, N, 3)), True, domain="both"))
    jmasks = {g: {torch_key(k): v for k, v in flatten_dict(m).items()}
              for g, m in jo.param_group_masks(variables["params"]).items()}
    names = [n for n, _ in NetMDA("PTran", num_points=N).named_parameters()]
    tmasks = {g: dict(zip(names, m)) for g, m in to.param_group_masks(names).items()}
    for group in to.GROUPS:
        assert tmasks[group] == jmasks[group], group
    for name in ("g.backbone.transformer1.fc_gamma2.weight", "g.backbone.td0.mlp0.dense0.weight",
                 "g.point_mix.weight"):
        assert tmasks["g"][name] and tmasks["dis"][name] and not tmasks["c"][name], name
    assert tmasks["c"]["c1.mlp2.dense0.weight"] and not tmasks["g"]["c1.mlp2.dense0.weight"]


def test_trainer_builds_the_model_for_num_points(setup):
    cfg = setup[0]
    tr = tdt.DGTrainer(cfg, model_name="PTran", device="cpu", num_points=N)
    assert tr.model.g.point_mix.in_features == N // 16
    with pytest.raises(ValueError, match="built for 1024 points"):
        tdt.DGTrainer(cfg, model_name="PTran", device="cpu").eval_logits(torch.zeros(1, N, 3))
    # KPConv's FPS pyramid: the node features have the tap level's N // 4
    # rows below 256 points, and the attentions take that width
    kp = tdt.DGTrainer({**cfg, "MODEL_CFG": {"PYRAMID": "fps"}}, model_name="KPConv",
                       device="cpu", num_points=N)
    assert kp.model.attention_s.dense0.in_features == N // 4 * 64


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ptran_run") / "data" / "PointDA_data"
    for i, name in enumerate(DATASET_LIST):
        (root / name).mkdir(parents=True)
        for j, split in enumerate(("train", "test")):
            pts, labels = make_synthetic_pointda(num_per_class=4 if split == "train" else 2,
                                                 num_points=N, seed=10 * i + j)
            np.save(root / name / f"{split}_pts.npy", pts)
            np.save(root / name / f"{split}_label.npy", labels)
    return root


def test_train_ptran_one_epoch_then_resume(data_root):
    def argv(epochs, *extra):
        return ["--source", "modelnet", "--cfg", YAML, "--batch_size", "8", "--num_points", str(N),
                "--device", "cpu", "--ckpt_save_interval", "1", "--fix_random_seed", *extra,
                "--set", "Model", "PTran", "DATA_ROOT", str(data_root),
                "OPTIMIZATION.NUM_EPOCHES", str(epochs)]

    res = train_dg_single_gpu.main(argv(1))
    (epoch0,) = res["history"]
    assert epoch0["epoch"] == 0 and epoch0["steps"] == 2
    assert epoch0["eval_batches"] == 3 * math.ceil(20 / 8)
    for k in ("loss_cls", "loss_geo", "loss_sem"):
        assert math.isfinite(epoch0[k]) and epoch0[k] > 0, k
    (ckpt,) = glob.glob(str(data_root / "output" / "**" / "modelnet_checkpoint_epoch_1.pt"),
                        recursive=True)
    payload = torch.load(ckpt, weights_only=True)
    assert payload["epoch"] == 1 and payload["optimizer"]["g"]["count"] == 2
    assert payload["state"]["g.point_mix.weight"].shape == (64, N // 16)

    res = train_dg_single_gpu.main(argv(2, "--resume", ckpt))
    assert [h["epoch"] for h in res["history"]] == [1]
    (ckpt2,) = glob.glob(str(data_root / "output" / "**" / "modelnet_checkpoint_epoch_2.pt"),
                         recursive=True)
    assert torch.load(ckpt2, weights_only=True)["optimizer"]["dis"]["count"] == 4
