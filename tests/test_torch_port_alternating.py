"""The alternating trainer of the port (``engine/alternating_trainer.py``)
against ``sug_tpu.engine.alternating_trainer.AlternatingTrainer`` on the
CPU: one step of each mode, naive-MMD DGCNN with ``DG_baseline.yaml``'s
``METHODS`` and its FocalLoss criterion, and uda PointNet, at B=4 source +
4 target clouds of 128 points, with weights bridged from the port's init
(BN stats randomised, a third of the BN scales negative), phase B's FPS
starts the JAX step draws passed to the port, no augmentation, and head
dropout off on both sides.

1. Phase A's losses (``loss_s``, ``loss_adv``) and gradients, and phase
   B's loss (``loss_node``). The JAX step returns no gradients: phase A's
   are read from its ``g`` optimizer state, whose first Adam moment after
   one step from zero is ``(1 − β1)·(grad + wd·p)``.
2. The optimizer: the ``g`` and ``c`` groups' moments and counts against
   the JAX ``opt_g`` and ``opt_c`` states; the change of every ``c1``/``c2``
   parameter (moved by phase A alone) against JAX's; the change phase A
   made to every ``g`` parameter against the Adam step of the port's ``g``
   moments at ``lr_g``; the ``dis`` group's moments against phase B's own
   gradient on the parameters phase A left, and its change of every
   ``dis`` parameter against the Adam step of those moments at ``lr_dis``.
   The ``g`` leaves' change is not held to JAX's: a first Adam step moves
   an element by ``lr·sign(grad + wd·p)``, so one whose sum is zero up to
   rounding moves either way (4e-2 relative L2 on ``g.block3``'s kernel in
   the naive case); their moments are held to JAX's.
   The three learning rates differ, so a swapped rate shows. The port's
   phase B changes no ``c1``/``c2`` parameter and neither the ``g`` nor the
   ``c`` group's moments or count. The BN running statistics after the
   step's four updates against JAX's.
3. ``GroupAdam.step`` alone, as the alternating trainer calls it (``g``,
   then ``c`` on the parameters ``g`` left, then ``dis`` on a second
   gradient), three times against the JAX trainer's ``_masked_update`` on
   the leaves of ``tests/test_torch_port_optim.py``, with a weight decay
   large enough to move every update: parameters and every group's moments
   to that file's 1e-6.
4. ``train_dg_naive_mmd`` (``DG_baseline.yaml``, DGCNN) and ``train_uda``
   (PointNet) each for one epoch on a tiny synthetic PointDA tree at
   ``--device cpu``; the naive run's checkpoint holds all three groups.

Tolerances, the DG-step test's (``tests/test_torch_port_dg_step.py``, which
gives their causes): phase A's losses 1e-4 relative, its gradients, the
``g`` and ``c`` moments, the parameters' changes and the BN statistics 2e-2
relative L2 per leaf. The ``dis`` group's moments are held to the port's
own phase-B gradient at 1e-5 relative and 1e-6 of the leaf's largest
value absolute (the same f32 formula in another order, ``g + wd·p``
cancelling in an element or two); a parameter after a step, against itself before plus the Adam
step of the port's moments at 1e-6 relative (one f32 rounding of the sum)
and 1e-4 of the rate absolute (the step of an element whose decayed
gradient is near Adam's eps, 2e-5 of the rate apart at most here): a step
at a wrong rate is off by the rate's difference. Phase B runs on the parameters phase A's Adam step
left, which moves every parameter by about ``lr·sign(g)``: a gradient that
is zero up to rounding steps either way in the two packages, so phase B's
loss is held to the DG test's bound for its later steps, 2e-3. Phase B's
gradients are not compared: the sigma=0.01 MMD kernel turns the rounding
of the zero self-distance into gradient noise (ROADMAP.md §3).
"""

from __future__ import annotations

import copy
import glob
import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from sug_tpu.engine import alternating_trainer as jat
from sug_tpu.engine.dg_trainer import make_criterion as j_make_criterion
from sug_tpu.engine.optim import param_group_masks
from sug_tpu.models import bn as jbn
from sug_tpu.models.net_mda import NetMDA as JNetMDA
from sug_tpu_torch import train_dg_naive_mmd, train_uda
from sug_tpu_torch.data.datasets import DATASET_LIST, make_synthetic_pointda
from sug_tpu_torch.engine import alternating_trainer as tat
from sug_tpu_torch.engine.dg_trainer import make_criterion
from sug_tpu_torch.engine.optim import ADAM_EPS, BETA1, BETA2, ThreeGroupOptimizer
from sug_tpu_torch.models.net_mda import NetMDA
from sug_tpu_torch.utils.config import parser_config
from sug_tpu_torch.utils.jax_bridge import load_jax_variables
from tests._torch_port_common import (  # noqa: F401  (one_torch_thread is autouse)
    assert_rel_l2,
    jax_grads_by_name,
    jax_stats_by_name,
    one_torch_thread,
    port_weights_as_jax,
)
from tests.test_torch_port_optim import TOL, _torch_view, _tree

B, N = 4, 128
YAML = "tools/cfgs/cfgs_local/DG_baseline.yaml"
WD = 5e-4
LRS = (1e-4, 2e-4, 3e-4)  # lr_g at DG_baseline.yaml's LR; lr_c and lr_dis apart from it
CONS = 0.5
CASES = {"naive": "DGCNN", "uda": "Pointnet"}


def _batch(seed):
    pts, labels = make_synthetic_pointda(num_per_class=1, num_points=N, seed=seed)
    return pts[:B], labels[:B].astype(np.int32), pts[-B:], labels[-B:].astype(np.int32)


def _trainers(mode):
    """The JAX and the port trainer of ``mode`` on the same variables."""
    model_name = CASES[mode]
    kwargs = dict(model_name=model_name, mode=mode, augment=False, weight_decay=WD)
    jkwargs, tkwargs = dict(kwargs), dict(kwargs, device="cpu", num_points=N)
    if mode == "naive":
        _, cfg = parser_config(["--cfg", YAML])
        pts, labels = make_synthetic_pointda(num_per_class=2, num_points=N, seed=1)
        from sug_tpu.data.datasets import PointCloudDataset as JDataset
        from sug_tpu_torch.data.datasets import PointCloudDataset

        jkwargs.update(cfg=cfg, criterion=j_make_criterion(
            cfg["OPTIMIZATION"], JDataset("modelnet", pts, labels, num_points=N)))
        tkwargs.update(cfg=cfg, criterion=make_criterion(
            cfg["OPTIMIZATION"], PointCloudDataset("modelnet", pts, labels, num_points=N)))
    jtr = jat.AlternatingTrainer(**jkwargs)
    port = NetMDA(model_name, generator=torch.Generator().manual_seed(0), num_points=N)
    variables = port_weights_as_jax(JNetMDA(model_name=model_name, num_class=10),
                                    port.state_dict(), jnp.zeros((B, N, 3)), True,
                                    domain="both")
    jtr.masks = param_group_masks(variables["params"])
    tr = tat.AlternatingTrainer(**tkwargs)
    load_jax_variables(tr.model, variables)
    tr.model.c1.dropout_rate = tr.model.c2.dropout_rate = 0.0
    return jtr, tr, variables


@pytest.fixture(autouse=True)
def _jax_bn_state():
    yield
    jbn.reset_bn_groups()


@pytest.mark.parametrize("mode", list(CASES))
def test_one_step_matches_jax(mode, monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    jtr, tr, variables = _trainers(mode)
    params = variables["params"]
    zeros = jtr._tx.init(params)
    state = jat.AltTrainState(params, variables["batch_stats"], zeros, zeros, zeros,
                              jnp.zeros((), jnp.int32))
    batch = _batch(3)
    key = jax.random.key(7)
    jbn.set_bn_groups(jtr._bn_groups)  # as train_step does before it traces
    # the step itself, jitted without train_step's checkify wrapper (half the compile)
    state, want = jax.jit(jtr._step)(state, tuple(map(jnp.asarray, batch)), key,
                                     tuple(jnp.float32(x) for x in (*LRS, CONS)))
    fps = torch.tensor(np.asarray(jax.random.randint(jax.random.split(key, 5)[4], (B,), 0, N)))
    assert (fps != 0).any()

    recorded, phase_b = [], {}
    grads, loss_b = tr.grads, tr._loss_b

    def record_grads(loss):
        recorded.append(grads(loss))
        return recorded[-1]

    def snapshot_then_loss_b(*args):  # the state phase A left, before phase B
        phase_b["params"] = {n: p.detach().clone() for n, p in tr.params}
        phase_b["opt"] = copy.deepcopy({g: tr.optimizer.state[g] for g in ("g", "c")})
        return loss_b(*args)

    monkeypatch.setattr(tr, "grads", record_grads)
    monkeypatch.setattr(tr, "_loss_b", snapshot_then_loss_b)
    before = {n: p.detach().clone() for n, p in tr.params}
    got = tr.train_step(*batch, *LRS, CONS, fps=fps)

    for k in ("loss_s", "loss_adv", "loss_node"):
        print(f"{mode} {k}: port {float(got[k]):.7f}, JAX {float(want[k]):.7f}")
    for k in ("loss_s", "loss_adv"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(float(got["loss_node"]), float(want["loss_node"]), rtol=2e-3)
    # phase A's gradients, and JAX's from its g state's first moment
    mu = jax.tree.map(lambda m, p: np.asarray(m) / 0.1 - WD * np.asarray(p),
                      state.opt_g[1].mu, params)
    assert_rel_l2({n: np.zeros(tuple(p.shape), np.float32) if g is None else g.numpy()
                   for (n, p), g in zip(tr.params, recorded[0])}, jax_grads_by_name(mu), 2e-2)

    assert len(recorded) == 2  # phase A's gradients, then phase B's
    names = [n for n, _ in tr.params]
    masks, opt = tr.optimizer.masks, tr.optimizer.state
    after = {n: p.detach() for n, p in tr.params}
    for n in names:
        if n.startswith(("c1.", "c2.")):
            assert torch.equal(after[n], phase_b["params"][n]), n
    for group, st in phase_b["opt"].items():
        assert st["count"] == opt[group]["count"] == 1
        for key_ in ("mu", "nu"):
            assert all(torch.equal(a, b) for a, b in zip(st[key_], opt[group][key_]))

    def adam_step(mu, nu, lr):  # one Adam step from zero moments, as optax takes it
        return -lr * (mu / (1 - BETA1)) / (np.sqrt(nu / (1 - BETA2)) + ADAM_EPS)

    # the g and c groups against the JAX opt_g and opt_c states
    j_adam = {"g": state.opt_g[1], "c": state.opt_c[1], "dis": state.opt_dis[1]}
    for group in ("g", "c"):
        assert int(j_adam[group].count) == opt[group]["count"]
        for key_ in ("mu", "nu"):
            assert_rel_l2({n: m.numpy() for n, m in zip(names, opt[group][key_])},
                          jax_grads_by_name(getattr(j_adam[group], key_)), 2e-2)
    # c1/c2 move in phase A alone, against JAX's change
    j_moved = jax_grads_by_name(jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                                             state.params, params))
    c_names = [n for n, on in zip(names, masks["c"]) if on]
    assert_rel_l2({n: (after[n] - before[n]).numpy() for n in c_names},
                  {n: j_moved[n] for n in c_names}, 2e-2)
    # JAX's change of a g leaf adds phase B's dis step; phase A's, the step
    # of the g moments at lr_g
    for i, n in enumerate(names):
        if masks["g"][i]:
            np.testing.assert_allclose(
                phase_b["params"][n].numpy(),
                before[n].numpy() + adam_step(opt["g"]["mu"][i].numpy(),
                                              opt["g"]["nu"][i].numpy(), LRS[0]),
                rtol=1e-6, atol=1e-4 * LRS[0], err_msg=n)
    # dis: phase B's gradient on phase A's parameters, stepped at lr_dis
    assert int(j_adam["dis"].count) == opt["dis"]["count"] == 1
    for i, n in enumerate(names):
        g_b = (torch.zeros_like(after[n]) if recorded[1][i] is None else recorded[1][i])
        decayed = (g_b + WD * phase_b["params"][n]).numpy()
        mu, nu = opt["dis"]["mu"][i].numpy(), opt["dis"]["nu"][i].numpy()
        for got_m, want_m in ((mu, (1 - BETA1) * decayed), (nu, (1 - BETA2) * decayed ** 2)):
            np.testing.assert_allclose(got_m, want_m, rtol=1e-5,
                                       atol=1e-6 * np.abs(want_m).max(), err_msg=n)
        if masks["dis"][i]:
            np.testing.assert_allclose(after[n].numpy(),
                                       phase_b["params"][n].numpy() + adam_step(mu, nu, LRS[2]),
                                       rtol=1e-6, atol=1e-4 * LRS[2], err_msg=n)
    # the running statistics after s(A), t(A), s(B), t(B)
    want_stats = jax_stats_by_name(state.batch_stats)
    got_stats = tr.model.state_dict()
    assert_rel_l2({k: got_stats[k].numpy() for k in want_stats}, want_stats, 2e-2)


def test_group_steps_match_masked_optax():
    """``GroupAdam.step`` one group at a time, as the alternating trainer
    steps it, against the JAX trainer's ``_masked_update`` (run eagerly)."""
    rng = np.random.default_rng(1)
    params = _tree(rng)
    wd, (lr_g, lr_c, lr_dis) = 5e-2, (1e-2, 3e-2, 5e-3)
    jtr = jat.AlternatingTrainer(weight_decay=wd)
    jmasks = param_group_masks(params)
    jparams = jax.tree.map(jnp.asarray, params)
    jstates = {g: jtr._tx.init(jparams) for g in ("g", "c", "dis")}

    flat_p = _torch_view(flatten_dict(params))
    names = sorted(flat_p)
    tparams = [torch.tensor(flat_p[n]) for n in names]
    topt = ThreeGroupOptimizer(list(zip(names, tparams)), wd)

    def as_torch(tree):
        flat = _torch_view(flatten_dict(tree))
        return [torch.tensor(flat[n]) for n in names]

    for _ in range(3):
        grads_a, grads_b = _tree(rng), _tree(rng)
        for group, grads, lr in (("g", grads_a, lr_g), ("c", grads_a, lr_c),
                                 ("dis", grads_b, lr_dis)):
            jparams, jstates[group] = jtr._masked_update(
                jax.tree.map(jnp.asarray, grads), jstates[group], jparams, jmasks[group], lr)
            topt.step(as_torch(grads), {group: lr})

    want_p = _torch_view(flatten_dict(jax.tree.map(np.asarray, jparams)))
    for n, p in zip(names, tparams):
        np.testing.assert_allclose(p.numpy(), want_p[n], err_msg=n, **TOL)
    for group, jstate in jstates.items():
        assert int(jstate[1].count) == topt.state[group]["count"] == 3
        for key in ("mu", "nu"):
            want = _torch_view(flatten_dict(jax.tree.map(np.asarray, getattr(jstate[1], key))))
            for n, m in zip(names, topt.state[group][key]):
                np.testing.assert_allclose(m.numpy(), want[n], err_msg=f"{group}/{key}/{n}",
                                           **TOL)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("alternating_run") / "data" / "PointDA_data"
    for i, name in enumerate(DATASET_LIST):
        (root / name).mkdir(parents=True)
        for j, split in enumerate(("train", "test")):
            pts, labels = make_synthetic_pointda(num_per_class=2, num_points=N, seed=10 * i + j)
            np.save(root / name / f"{split}_pts.npy", pts)
            np.save(root / name / f"{split}_label.npy", labels)
    return root


def test_train_dg_naive_mmd_one_epoch(data_root):
    res = train_dg_naive_mmd.main([
        "--source", "modelnet", "--cfg", YAML, "--batch_size", "4", "--num_points", str(N),
        "--device", "cpu", "--ckpt_save_interval", "1", "--fix_random_seed",
        "--set", "DATA_ROOT", str(data_root), "OPTIMIZATION.NUM_EPOCHES", "1"])
    (epoch0,) = res["history"]
    # 20 modelnet train clouds split 10/10; class-balanced batches of 4
    assert epoch0["steps"] == 2 and epoch0["eval_batches"] == 3 * math.ceil(20 / 4)
    for k in ("loss_s", "loss_node"):
        assert math.isfinite(epoch0[k]) and epoch0[k] > 0, k
    assert math.isfinite(epoch0["loss_adv"]) and epoch0["loss_adv"] <= 0
    (ckpt,) = glob.glob(str(data_root / "output" / "**" / "modelnet_checkpoint_epoch_1.pt"),
                        recursive=True)
    optimizer = torch.load(ckpt, weights_only=True)["optimizer"]
    assert {g: optimizer[g]["count"] for g in ("g", "c", "dis")} == {"g": 2, "c": 2, "dis": 2}


def test_train_uda_one_epoch(data_root, tmp_path):
    res = train_uda.main(["-source", "scannet", "-target", "modelnet", "-b", "8", "-e", "1",
                          "-datadir", str(data_root), "-tb_log_dir", str(tmp_path / "logs"),
                          "-device", "cpu", "-num_points", str(N)])
    (epoch0,) = res["history"]
    assert epoch0["steps"] == 2 and epoch0["eval_batches"] == 2 * math.ceil(20 / 8)
    assert all(math.isfinite(epoch0[k]) for k in ("loss_s", "loss_adv", "loss_node"))
    assert set(res["best_test_acc"]) == {"source", "test1"}
    assert (tmp_path / "logs" / "metrics.jsonl").exists()


def test_unsupported_configs_raise():
    _, cfg = parser_config(["--cfg", YAML])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tat.AlternatingTrainer("Pointnet3", mode="naive", cfg=cfg, device="cpu")
    bad = {**cfg, "METHODS": {**cfg["METHODS"], "CLASS_MMD": [{"NAME": "CL"}]}}
    with pytest.raises(ValueError, match="Not supported MMD method CL"):
        tat.AlternatingTrainer("DGCNN", mode="naive", cfg=bad, device="cpu")
    with pytest.raises(ValueError, match="mode"):
        tat.AlternatingTrainer("DGCNN", mode="dg", device="cpu")
