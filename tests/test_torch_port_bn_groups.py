"""Grouped (per-replica) BatchNorm of the port (``sug_tpu_torch.models.bn``)
against the JAX package's grouped ``sug_tpu.models.bn.BatchNorm`` and its
EdgeConv block on the CPU, and the port's ``configure_from_cfg`` against the
JAX one.

- ``BatchNorm`` at (B, N, C) = (8, 32, 16) with g = 2 and 4 groups in both
  momentum modes: the output, the gradient of a random linear loss with
  respect to the input and the parameters, and the running stats; eval
  mode, which runs the running stats through the grouped formula; a batch
  that g does not divide.
- The EdgeConv block, whose BN reads the kernel's sums, with 2 and 4 groups
  (momentum ``mean``, the JAX ``set_bn_groups``) and 2 sequential groups
  (the JAX ``set_stacked_bn``).
- ``configure_from_cfg`` on a table of configs and ``SUG_BN_GROUPS`` values.
- DGCNN's DG ``_loss(train=True)`` with ``MODEL_CFG.BN_SEMANTICS:
  per_replica`` and ``BN_GROUPS: 2`` (the sequential forward, 2 groups in
  every BN) against the JAX trainer's, as ``tests/test_torch_port_stacked.py``
  holds its GRL loss: every loss to 1e-4 relative and, with the MMD losses
  off, every gradient to 2e-2 relative L2.

Tolerance for the modules 1e-4 relative plus 1e-4 of each leaf's largest
|value|, as the train-mode module tests: the two libraries order the f32
sums differently.
"""

from __future__ import annotations

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench

from sug_tpu.models import bn as jbn
from sug_tpu.models.dgcnn import _EdgeConvBlock as JBlock
from sug_tpu_torch.models import bn as tbn
from sug_tpu_torch.models.dgcnn import EdgeConvBlock
from tests._torch_port_common import assert_leaves_close, port_module, t
from tests.test_torch_port_stacked import (
    _assert_losses_and_grads,
    _jax_trainer,
    _loss_pair,
    _port_loss,
    _port_trainer,
)
from tests.test_torch_port_train_modules import TOL, _compare, _init, _PortBN

B, N, C = 8, 32, 16


@pytest.fixture(autouse=True)
def _jax_bn_state():
    """The JAX package's trace-time BN state back at its default after each test."""
    yield
    jbn.reset_bn_groups()


class _JaxGroupedBN(fnn.Module):
    """The JAX package's grouped BatchNorm with the package's ``train``
    argument (auto-named ``BatchNorm_0``, as the factory places it)."""

    groups: int
    momentum_mode: str = "mean"

    @fnn.compact
    def __call__(self, x, train):
        return jbn.BatchNorm(groups=self.groups, use_running_average=not train,
                             momentum=0.9, epsilon=1e-5, momentum_mode=self.momentum_mode)(x)


def _grouped_port_bn(groups, mode):
    module = _PortBN(C)
    tbn.set_bn_groups(module, groups, mode)
    return module


def _x(seed, shape=(B, N, C)):
    rng = np.random.default_rng(seed)
    # a different offset per batch row, so each group has its own statistics
    offsets = rng.normal(0.0, 2.0, size=(shape[0],) + (1,) * (len(shape) - 1))
    return (offsets + 3.0 * rng.normal(size=shape)).astype(np.float32), rng


@pytest.mark.parametrize("mode", ["mean", "sequential"])
@pytest.mark.parametrize("groups", [2, 4])
def test_grouped_batchnorm_train(groups, mode):
    x, rng = _x(groups)
    jm = _JaxGroupedBN(groups, mode)
    variables = _init(jm, groups, jnp.asarray(x), False)
    cots = [rng.normal(size=x.shape).astype(np.float32)]
    _compare(jm, _grouped_port_bn(groups, mode), variables, [x], cots)


@pytest.mark.parametrize("groups", [2, 4])
def test_grouped_batchnorm_2d_train(groups):
    """A (B, C) input, as PointNet's ``bn1`` after the max over the points."""
    x, rng = _x(10 + groups, shape=(B, C))
    jm = _JaxGroupedBN(groups, "sequential")
    variables = _init(jm, 2, jnp.asarray(x), False)
    _compare(jm, _grouped_port_bn(groups, "sequential"), variables, [x],
             [rng.normal(size=x.shape).astype(np.float32)])


@pytest.mark.parametrize("groups", [2, 4])
def test_grouped_batchnorm_eval(groups):
    x, _ = _x(20 + groups)
    jm = _JaxGroupedBN(groups)
    variables = _init(jm, 3, jnp.asarray(x), False)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), False))
    module = port_module(_grouped_port_bn(groups, "mean"), variables)
    with torch.no_grad():
        got = module(t(x)).numpy()
    assert_leaves_close({"out": got}, {"out": want}, **TOL)


def test_indivisible_batch_raises():
    x, _ = _x(30, shape=(6, N, C))
    with pytest.raises(ValueError, match="not divisible by 4"):
        _grouped_port_bn(4, "mean").train()(t(x))
    jm = _JaxGroupedBN(4)
    variables = _init(jm, 4, jnp.zeros((8, N, C)), False)
    with pytest.raises(ValueError, match="not divisible by 4"):
        jm.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    block = EdgeConvBlock(C, 32).train()
    tbn.set_bn_groups(block, 4)
    with pytest.raises(ValueError, match="not divisible by 4"):
        block(t(x))


@pytest.mark.parametrize("groups,mode", [(2, "mean"), (4, "mean"), (2, "sequential")])
def test_grouped_edgeconv_block_train(groups, mode):
    x, rng = _x(40 + groups, shape=(B, 64, 3))
    jm = JBlock(64)
    variables = _init(jm, 5, jnp.asarray(x), False)
    cots = [rng.normal(size=(B, 64, 64)).astype(np.float32)]
    module = EdgeConvBlock(3, 64)
    tbn.set_bn_groups(module, groups, mode)
    # the JAX block reads its groups from the package's trace-time state
    if mode == "mean":
        jbn.set_bn_groups(groups)
        _compare(jm, module, variables, [x], cots)
        return
    jbn.set_stacked_bn(True)
    try:
        _compare(jm, module, variables, [x], cots)
    finally:
        jbn.set_stacked_bn(False)


def test_set_bn_groups_rejects_bad_values():
    module = _PortBN(C)
    with pytest.raises(ValueError, match=">= 1"):
        tbn.set_bn_groups(module, 0)
    with pytest.raises(ValueError, match="momentum_mode"):
        tbn.set_bn_groups(module, 2, "median")


# (id, cfg, SUG_BN_GROUPS or None, device count)
CFG_CASES = [
    ("no_model_cfg", {"METHODS": {}}, None, 1),
    ("cfg_none", None, None, 1),
    ("env_2", {"METHODS": {}}, "2", 1),
    ("env_1", {"METHODS": {}}, "1", 1),
    ("env_not_a_number", {"METHODS": {}}, "two", 1),
    ("model_cfg_without_semantics_env_3", {"MODEL_CFG": {"kp_method": "x"}}, "3", 1),
    ("global_over_env", {"MODEL_CFG": {"BN_SEMANTICS": "global"}}, "4", 1),
    ("per_replica_groups", {"MODEL_CFG": {"BN_SEMANTICS": "per_replica", "BN_GROUPS": 2}}, None, 1),
    ("per_replica_over_env", {"MODEL_CFG": {"BN_SEMANTICS": "per_replica", "BN_GROUPS": 4}},
     "2", 1),
    ("per_replica_devices", {"MODEL_CFG": {"BN_SEMANTICS": "per_replica"}}, None, 4),
    ("per_replica_one_device", {"MODEL_CFG": {"BN_SEMANTICS": "per_replica"}}, "8", 1),
    ("upper_case", {"MODEL_CFG": {"BN_SEMANTICS": "PER_REPLICA", "BN_GROUPS": 3}}, None, 1),
    ("unknown_semantics", {"MODEL_CFG": {"BN_SEMANTICS": "sync"}}, None, 1),
    ("model_cfg_not_a_mapping", {"MODEL_CFG": "per_replica"}, None, 1),
]


@pytest.mark.parametrize("cfg,env,devices", [c[1:] for c in CFG_CASES],
                         ids=[c[0] for c in CFG_CASES])
def test_configure_from_cfg_matches_jax(monkeypatch, cfg, env, devices):
    monkeypatch.delenv("SUG_BN_GROUPS", raising=False)
    if env is not None:
        monkeypatch.setenv("SUG_BN_GROUPS", env)
    try:
        want = jbn.configure_from_cfg(cfg, devices)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(" ")[0]):
            tbn.configure_from_cfg(cfg, devices)
        return
    assert tbn.configure_from_cfg(cfg, devices) == want


def test_loss_with_bn_groups(monkeypatch):
    monkeypatch.delenv("SUG_STACKED_FORWARD", raising=False)
    cfg = dict(bench._make_cfg())
    cfg["MODEL_CFG"] = {"BN_SEMANTICS": "per_replica", "BN_GROUPS": 2}
    jtr, variables = _jax_trainer(cfg, "DGCNN")
    tr = _port_trainer(cfg, "DGCNN", variables, monkeypatch)
    assert jtr._bn_groups == tr.bn_groups == 2
    out, initial = _loss_pair(jtr, tr, variables, 0.0)
    _assert_losses_and_grads(out)
    # the grouped statistics are not the global ones
    tbn.set_bn_groups(tr.model, 1)
    _, ungrouped = _port_loss(tr, initial, False, 0.0)
    assert abs(float(ungrouped["loss_cls"]) - float(out[False][0]["loss_cls"])) > 1e-4
