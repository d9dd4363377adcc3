"""PointNet++ under the DG trainer of the port (``NetMDA("Pointnet2")`` in
``sug_tpu_torch.engine.dg_trainer``) against the JAX package's ``DGTrainer``
on the CPU, at B=4 source + 4 target clouds of 1024 points (the generator's
first FPS takes 512 of them), ``bench.py``'s config (geo + sem soft-MMD with
chamfer and KL sample weights, target loss), weights bridged from the port's
init into the JAX tree (BN stats randomised, a third of the BN scales
negative), the FPS starts JAX draws passed to the port, and head dropout
off on both sides.

1. ``_loss(train=True)`` on the sequential forward, the port in f32 and in
   f64 against the JAX package in f64: every loss with the MMD losses on
   and off, and with them off every parameter's gradient and the new BN
   running stats.
2. The same on the stacked forward (``SUG_STACKED_FORWARD=1``: one
   generator pass over both domains, every SA layer's BN in two groups), and
   with ``BN_SEMANTICS: per_replica``, ``BN_GROUPS: 2`` (the sequential
   forward, every BN of the model in two groups).
3. ``PRECISION: bf16`` raises ``NotImplementedError`` naming its ROADMAP
   item.

The JAX side in f64. Each SA layer's BN in train mode reduces over B·S·K
rows (65536 in ``sa1`` here), and its gradient sums terms of both signs
that cancel. XLA's CPU reductions add such rows into one f32 accumulator,
so the JAX package's own f32 result lies far from the exact one: on this
batch its loss_cls 1.2e-5 relative and its gradients up to 5.8e-2 relative
L2 from its f64 result, where the port's f32 (PyTorch sums in cascades)
lies 2.7e-7 and 3.3e-3 from it. Held to the JAX package's f32, the port
would be held to that rounding. So the reference is the JAX package in f64
(under ``jax.enable_x64``, f64 variables, its grouped BN reading
``float32`` as ``float64`` inside the test, ``_JnpF64``) on the same f32
clouds, so that FPS, the ball queries and the chamfer choose in f32 on
both sides, as in training, from the FPS starts JAX draws there.

Tolerances, the slice's: every loss 1e-5 relative (measured up to 1.5e-7 in
f32, 2.0e-8 in f64, where the port's cross entropy reads f32 logits);
gradients 1e-3 relative L2 per leaf in f64 (a leaf whose gradient is zero
up to rounding against 1e-2 of the largest; measured up to 8.8e-8), and in
f32 2e-2, the DG step tests' bound (measured up to 9.3e-3, the port's f32
rounding); BN statistics 1e-3 relative L2 (measured up to 4.0e-7). There is no kNN here whose
near ties could choose otherwise: FPS is exact in both packages, and a ball
query decides membership on ``d² > r²`` with the same f32 arithmetic, so
only a point within an ulp of a radius could fall on the other side (the
grouped indices are compared exactly in
``tests/test_torch_port_pointnet2.py``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from sug_tpu.engine import dg_trainer as jdt
from sug_tpu.models import bn as jbn
from sug_tpu_torch.engine import dg_trainer as tdt
from sug_tpu_torch.utils.jax_bridge import load_jax_variables
from tests._torch_port_common import (
    assert_rel_l2,
    jax_grads_by_name,
    jax_stats_by_name,
    port_weights_as_jax,
)
from tests.test_torch_port_dg_step import _identity_dropout, _port_grads
from tests._torch_port_common import one_torch_thread  # noqa: F401  (autouse)

B, N = 4, 1024
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-3
F32_GRAD_REL_L2 = 2e-2
STATS_REL_L2 = 1e-3
SEED = 0  # the port's initial weights, which the JAX variables take
METRICS = ("loss_cls", "loss_adv", "loss_geo", "loss_sem", "loss_total")


def _batch():
    """Two domains of 4 unit-scale clouds, labels and the JAX key."""
    rng = np.random.default_rng(4)
    clouds = []
    for _ in range(2):
        pc = rng.uniform(-1, 1, size=(B, N, 3)) * rng.uniform(0.3, 1.0, size=(B, 1, 3))
        clouds.append((pc / np.linalg.norm(pc, axis=-1).max(-1)[:, None, None]).astype(np.float32))
    ls, lt = np.array([0, 1, 2, 3], np.int32), np.array([0, 5, 2, 7], np.int32)
    key = jax.random.key(11)
    return (clouds[0], ls, clouds[1], lt), key


@functools.lru_cache(maxsize=None)
def _variables():
    port = tdt.NetMDA("Pointnet2", generator=torch.Generator().manual_seed(SEED))
    return port_weights_as_jax(jdt.NetMDA(model_name="Pointnet2", num_class=10),
                               port.state_dict(), jnp.zeros((B, N, 3)), True, domain="both")


@pytest.fixture(autouse=True)
def _jax_bn_state():
    yield
    jbn.reset_bn_groups()


def _trainers(cfg, monkeypatch):
    jtr = jdt.DGTrainer(cfg, model_name="Pointnet2", augment=False)
    jbn.set_bn_groups(jtr._bn_groups)  # as train_step does before it traces
    variables = _variables()
    tr = tdt.DGTrainer(cfg, model_name="Pointnet2", augment=False, device="cpu")
    load_jax_variables(tr.model, variables)
    _identity_dropout(monkeypatch, tr)
    return jtr, tr, variables


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


class _JnpF64:
    """``jax.numpy`` with ``float32`` read as ``float64``, for the JAX
    package's grouped BN (``sug_tpu/models/bn.py``), which casts its input
    to f32: in the f64 comparison it then computes in f64, as flax's BN
    does."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def _check_loss(cfg, monkeypatch):
    """The port's ``_loss(train=True)`` in f32 and in f64 against the JAX
    package's in f64, each from the same BN stats: every loss with the MMD
    losses on and off, and with them off every gradient and the new BN
    stats. Returns the port trainer."""
    jtr, tr, variables = _trainers(cfg, monkeypatch)
    batch, key = _batch()
    tbatch = (torch.from_numpy(batch[0]), torch.from_numpy(batch[1]).long(),
              torch.from_numpy(batch[2]), torch.from_numpy(batch[3]).long())
    initial = {n: b.clone() for n, b in tr.model.named_buffers()}
    want = {}
    with jax.enable_x64(), monkeypatch.context() as patch:
        patch.setattr(jbn, "jnp", _JnpF64())
        # the FPS starts the trainer draws from its key, drawn as int64 here
        fps = tuple(torch.from_numpy(np.array(jax.random.randint(k, (B,), 0, N)))
                    for k in jax.random.split(key, 4)[:2])
        v64 = _f64(variables)
        args = (v64["params"], v64["batch_stats"], *map(jnp.asarray, batch), key,
                jnp.float64(0.0))
        for mmd_on in (True, False):
            fn = functools.partial(jtr._loss, mmd_on=mmd_on, train=True)
            if mmd_on:
                _, (_, want[mmd_on]) = jax.jit(fn)(*args)
            else:
                (_, (stats, want[mmd_on])), grads = jax.jit(jax.value_and_grad(
                    fn, has_aux=True))(*args)
    for dtype, grad_bound in ((torch.float32, F32_GRAD_REL_L2), (torch.float64, GRAD_REL_L2)):
        tr.model.to(dtype)
        for mmd_on in (True, False):
            tr.model.load_state_dict(initial, strict=False)
            total, got = tr._loss(*tbatch, *fps, mmd_on=mmd_on, train=True)
            _assert_losses(got, want[mmd_on], f"{dtype}, mmd {mmd_on}")
        assert_rel_l2(_port_grads(tr, total), jax_grads_by_name(grads), grad_bound)
        assert_rel_l2({n: b.numpy() for n, b in tr.model.named_buffers()},
                      jax_stats_by_name(stats), STATS_REL_L2)
    return tr


def _assert_losses(got, want, what):
    for k in METRICS:
        if k in want:
            print(f"{what} {k}: {float(got[k])!r} vs {float(want[k])!r}")
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL, atol=1e-12,
                                       err_msg=f"{k} ({what})")


def test_loss_sequential(monkeypatch):
    monkeypatch.delenv("SUG_STACKED_FORWARD", raising=False)
    tr = _check_loss(bench._make_cfg(), monkeypatch)
    assert not tdt.stacked_forward("Pointnet2") and tr.bn_groups == 1


def test_loss_stacked(monkeypatch):
    monkeypatch.setenv("SUG_STACKED_FORWARD", "1")
    tr = _check_loss(bench._make_cfg(), monkeypatch)
    assert tdt.stacked_forward("Pointnet2") and tr.bn_groups == 1


def test_loss_bn_groups(monkeypatch):
    monkeypatch.delenv("SUG_STACKED_FORWARD", raising=False)
    cfg = dict(bench._make_cfg())
    cfg["MODEL_CFG"] = {"BN_SEMANTICS": "per_replica", "BN_GROUPS": 2}
    tr = _check_loss(cfg, monkeypatch)
    assert tr.bn_groups == 2
    assert {m.groups for m in tr.model.modules() if hasattr(m, "momentum_mode")} == {2}


def test_bf16_raises():
    cfg = bench._make_cfg()
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md \(item 16b\)"):
        tdt.DGTrainer({**cfg, "PRECISION": "bf16"}, model_name="Pointnet2", device="cpu")
