"""The DG training step of the port (``sug_tpu_torch.engine.dg_trainer``)
against ``sug_tpu.engine.dg_trainer.DGTrainer`` on the CPU, for DGCNN and for
Pointnet (every test runs once per model), with ``bench.py``'s flagship
config (geo + sem soft-MMD with chamfer and KL
sample weights, target loss) and the DLSA ``ClassWeighting`` criterion, the
weights bridged from the JAX package's init (BN stats randomised, a third of
the BN scales negative). B=4 source + 4 target clouds of 128 points.

1. ``_loss(train=False)``: every metric and the gradient of every
   parameter, through the inverse of the weight bridge.
2. ``_loss(train=True)`` with the FPS starts JAX draws
   (``dg_trainer.py:190-193``) passed to the port, and dropout off on both
   sides (``flax.linen.Dropout.__call__`` patched to the identity inside the
   test, the port's rate set to 0): losses, gradients, new batch stats.
3. Three ``train_step``s with ``augment=False`` on the same batches and the
   same FPS starts: the losses of every step.

Tolerances. Every loss 1e-4 relative. Gradients and batch stats in relative
L2 error per leaf, at most 2e-2 (measured up to 7e-3): the f32 sums of two
libraries differ in order through four EdgeConv blocks, the SA-node, both
heads and three batch-statistics layers, and points near the ball query's
radius or near-tied in the FPS and kNN distances can select differently.
The gradients are compared with the MMD losses off: the sigma=0.01 MMD
kernel multiplies the rounding of each sample's zero self-distance by 5000,
which leaves the MMD gradients of the attention layers and of the SA-node's
BN at the level of that rounding in both packages (the MMD gradients are
held against JAX's on their own in ``test_torch_port_losses.py``). The first
``train_step`` is held to 1e-4; after it, Adam moves every parameter by
about ``lr * sign(g)``, so a gradient that is zero up to rounding (or up to
the MMD kernel's amplified rounding) steps either way and the two runs
drift apart: steps 2 and 3 hold the total loss to 2e-3 and each term to
3e-2 (measured 6.4e-4 and 1.95e-2, the classification term, which is small
beside the MMD terms). Parameters are compared through the gradient and
optimizer tests instead. PointNet's steps take the shipped config's learning
rate, 1e-4, where DGCNN's take 1e-3: PointNet max-pools every channel over
the points, so the gradient of a channel flows through one point, and a
weight that one step moved by ±lr on a rounding-level gradient switches
those points at the next. At 1e-3 the two runs part by 14% in the
classification term at step 3; at 1e-4 they hold the same bounds (measured
5.6e-4 and 5.6e-3).
"""

from __future__ import annotations

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from sug_tpu.data.datasets import PointCloudDataset as JDataset
from sug_tpu.engine import dg_trainer as jdt
from sug_tpu.engine.optim import ThreeGroupOptimizer as JOptimizer
from sug_tpu_torch.data.datasets import PointCloudDataset, make_synthetic_pointda
from sug_tpu_torch.engine import dg_trainer as tdt
from sug_tpu_torch.utils.jax_bridge import load_jax_variables
from tests._torch_port_common import (
    assert_leaves_close,
    assert_rel_l2,
    jax_grads_by_name,
    jax_stats_by_name,
    randomize_variables,
)
from tests._torch_port_common import one_torch_thread  # noqa: F401  (autouse)

B, N = 4, 128
LOSS_RTOL = 1e-4
REL_L2 = 2e-2
METRICS = ("loss_cls", "loss_adv", "loss_geo", "loss_sem", "loss_total")
OPT_CFG = {"CLS_LOSS": "ClassWeighting", "CLS_WEIGHT": "DLSA", "DLSA_Q": 0.4}
STEP_LR = {"DGCNN": 1e-3, "Pointnet": 1e-4}


@pytest.fixture(scope="module", params=["DGCNN", "Pointnet"])
def setup(request):
    """The JAX trainer of one model, its randomised variables, the batches,
    and the datasets the DLSA weights come from (class counts 1..10, so no
    two weights are equal)."""
    cfg = bench._make_cfg()
    model_name = request.param
    pts, labels = make_synthetic_pointda(num_per_class=10, num_points=N, seed=3)
    keep = np.concatenate([np.nonzero(labels == c)[0][:c + 1] for c in range(10)])
    jds = JDataset("modelnet", pts[keep], labels[keep], num_points=N, model=model_name)
    tds = PointCloudDataset("modelnet", pts[keep], labels[keep], num_points=N, model=model_name)
    jcrit = jdt.make_criterion(OPT_CFG, jds)
    jtr = jdt.DGTrainer(cfg, model_name=model_name, criterion=jcrit, augment=False)
    variables = jax.jit(lambda: jtr.model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.zeros((B, N, 3)), True, domain="both"))()
    variables = randomize_variables(variables, seed=5)
    jtr.optimizer = JOptimizer(variables["params"], float(cfg["OPTIMIZATION"]["WEIGHT_DECAY"]))
    batch = (jds.pts[:B], jds.labels[:B], jds.pts[-B:], jds.labels[-B:])
    return cfg, jtr, variables, batch, tds


def _port_trainer(setup):
    cfg, jtr, variables, _, tds = setup
    crit = tdt.make_criterion(OPT_CFG, tds)
    tr = tdt.DGTrainer(cfg, model_name=jtr.model_name, criterion=crit, augment=False,
                       device="cpu")
    load_jax_variables(tr.model, variables)
    return tr


def _torch_batch(batch):
    ds, ls, dt, lt = batch
    return (torch.from_numpy(ds), torch.from_numpy(ls).long(), torch.from_numpy(dt),
            torch.from_numpy(lt).long())


def _jax_fps(key):
    """The FPS starts ``DGTrainer._forward_both`` draws from its key."""
    k_s, k_t, _, _ = jax.random.split(key, 4)
    return (torch.from_numpy(np.asarray(jax.random.randint(k_s, (B,), 0, N))),
            torch.from_numpy(np.asarray(jax.random.randint(k_t, (B,), 0, N))))


def _identity_dropout(monkeypatch, tr):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    tr.model.c1.dropout_rate = 0.0
    tr.model.c2.dropout_rate = 0.0


def _assert_metrics(got, want):
    for k in METRICS:
        if k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL, atol=1e-6,
                                       err_msg=k)


def _port_grads(tr, total):
    """name -> gradient, zeros where the loss does not reach (JAX's value)."""
    return {n: np.zeros(tuple(p.shape), np.float32) if g is None else g.numpy()
            for (n, p), g in zip(tr.params, tr.grads(total))}


def _both_losses(jtr, tr, variables, batch, key, fps, train):
    """Metrics with the MMD losses on, and (metrics, grads) with them off,
    from both packages; the port's BN stats end as the MMD-on pass left them
    (in train mode both passes update them, so the MMD-off pass runs on a
    copy of the stats)."""
    out = {}
    for mmd_on in (True, False):
        fn = jax.jit(jax.value_and_grad(
            functools.partial(jtr._loss, mmd_on=mmd_on, train=train), has_aux=True))
        (_, (stats, want)), grads = fn(variables["params"], variables["batch_stats"],
                                       *map(jnp.asarray, batch), key, 0.0)
        saved = {n: b.clone() for n, b in tr.model.named_buffers()}
        total, got = tr._loss(*_torch_batch(batch), *fps, mmd_on=mmd_on, train=train)
        out[mmd_on] = (got, want, _port_grads(tr, total), jax_grads_by_name(grads),
                       {n: b.numpy().copy() for n, b in tr.model.named_buffers()},
                       jax_stats_by_name(stats))
        with torch.no_grad():
            for n, b in tr.model.named_buffers():
                b.copy_(saved[n])
    return out


def _check_weights_away_from_truncation(tr, batch):
    """mean2one truncates 1/mean to an integer: keep both SDA weightings of
    this batch away from the jump (printed), or a rounding difference would
    flip a weight."""
    from sug_tpu_torch.losses import mmd
    from sug_tpu_torch.ops.geometry import chamfer_distance

    ds, ls, dt, lt = batch
    with torch.no_grad():
        tr.model.eval()
        out_s, out_t = tr.model(ds), tr.model(dt)
    geo = 1.0 / chamfer_distance(ds, dt).mean().item()
    for head in ("logits1", "logits2"):
        ps = torch.softmax(out_s[head], 1)
        pt = torch.softmax(out_t[head], 1)
        ps = torch.cat([ps, mmd.one_hot_labels(ls) * 0.5], 1)
        pt = torch.cat([pt, mmd.one_hot_labels(lt) * 0.5], 1)
        ps = (ps + 1e-8) / torch.sum(ps + 1e-8)
        pt = (pt + 1e-8) / torch.sum(pt + 1e-8)
        sem = 1.0 / torch.sum(mmd.sym_kl_distance(ps, pt), 1).mean().item()
        print(f"mean2one 1/mean: geo {geo:.4f}, sem ({head}) {sem:.4f}")
        assert abs(sem - round(sem)) > 0.02
    assert abs(geo - round(geo)) > 0.02


def test_loss_eval_mode(setup):
    _, jtr, variables, batch, _ = setup
    tr = _port_trainer(setup)
    _check_weights_away_from_truncation(tr, _torch_batch(batch))
    out = _both_losses(jtr, tr, variables, batch, jax.random.key(0), (None, None), train=False)
    for mmd_on, (got, want, g_grads, w_grads, g_stats, w_stats) in out.items():
        _assert_metrics(got, want)
        # eval mode leaves the running stats alone, on both sides
        assert_leaves_close(g_stats, w_stats, rtol=0, atol_frac=0)
    assert "loss_geo" in out[True][0] and "loss_sem" in out[True][0]
    assert_rel_l2(out[False][2], out[False][3], REL_L2)


def test_loss_train_mode(setup, monkeypatch):
    _, jtr, variables, batch, _ = setup
    tr = _port_trainer(setup)
    _identity_dropout(monkeypatch, tr)
    key = jax.random.key(7)
    fps = _jax_fps(key)
    assert (fps[0] != 0).any()
    out = _both_losses(jtr, tr, variables, batch, key, fps, train=True)
    for got, want, *_ in out.values():
        _assert_metrics(got, want)
    _, _, g_grads, w_grads, g_stats, w_stats = out[False]
    assert_rel_l2(g_grads, w_grads, REL_L2)
    assert_rel_l2(out[True][4], out[True][5], REL_L2)


def test_three_train_steps(setup, monkeypatch):
    cfg, jtr, variables, batch, _ = setup
    tr = _port_trainer(setup)
    _identity_dropout(monkeypatch, tr)
    state = jdt.DGTrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                             opt_state=jtr.optimizer.init(variables["params"]),
                             step=jnp.zeros((), jnp.int32))
    lrs = (STEP_LR[jtr.model_name],) * 3
    tb = _torch_batch(batch)
    for i in range(3):
        key = jax.random.key(100 + i)
        state, want = jtr.train_step(state, *batch, key, *lrs, mmd_on=True)
        got = tr.train_step(*tb, *lrs, mmd_on=True, fps_s=_jax_fps(key)[0], fps_t=_jax_fps(key)[1])
        for k in METRICS:
            rtol = LOSS_RTOL if i == 0 else (2e-3 if k == "loss_total" else 3e-2)
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol, atol=1e-6,
                                       err_msg=f"step {i}: {k}")
    assert int(state.step) == 3 and tr.optimizer.state["g"]["count"] == 3


def test_unported_config_raises(setup, monkeypatch):
    """KPConv under bf16, deformable or not, raises; bf16 for DGCNN,
    Pointnet and PTran, GRL, the stacked forward, per-replica BN and every
    alignment the JAX trainer takes are accepted; an unknown alignment
    raises ``ValueError``, as it does in JAX."""
    cfg = setup[0]
    for model_name in ("DGCNN", "PTran"):
        assert tdt.DGTrainer({**cfg, "PRECISION": "bf16"}, model_name=model_name,
                             device="cpu").compute_dtype == torch.bfloat16
    deformable = ("simple", "resnetb_deformable")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdt.DGTrainer({**cfg, "PRECISION": "bf16", "MODEL_CFG": {"ARCHITECTURE": deformable}},
                      model_name="KPConv", device="cpu")
    monkeypatch.setenv("SUG_STACKED_FORWARD", "1")
    methods = cfg["METHODS"]
    for name in ("CL", "HARD_MMD", "MAX_HARD_MMD"):
        ok = {**cfg, "METHODS": {**methods, "GRL": True, "GEO_MMD": [{"NAME": name}],
                                 "SEM_MMD": [{"NAME": name}]},
              "MODEL_CFG": {"BN_SEMANTICS": "per_replica", "BN_GROUPS": 2}}
        tr = tdt.DGTrainer(ok, model_name="DGCNN", device="cpu")
        assert tr.grl and tr.bn_groups == 2
    bad = {**cfg, "METHODS": {**methods, "SEM_MMD": [{"NAME": "SOFTER_MMD"}]}}
    with pytest.raises(ValueError, match="Not supported MMD method SOFTER_MMD"):
        tdt.DGTrainer(bad, model_name="DGCNN", device="cpu")
