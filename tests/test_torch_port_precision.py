"""The port refuses the numerics it does not have, the bf16 policy, and takes
the BN groups the JAX package takes. Each case sets a config and an
environment, asks the JAX package what it would compute under them
(``sug_tpu.models.precision.compute_dtype()`` and the group count of
``sug_tpu.models.bn.configure_from_cfg``), and checks that the port's
``check_supported`` (or ``infer``) raises exactly where the JAX package
leaves f32, accepts the rest, and that the port's ``configure_from_cfg``
gives the JAX package's group count."""

from __future__ import annotations

import copy

import jax.numpy as jnp
import pytest

from sug_tpu.models import bn as jbn
from sug_tpu.models import precision as jprecision
from sug_tpu_torch import infer
from sug_tpu_torch.engine.dg_trainer import check_supported
from sug_tpu_torch.models.bn import configure_from_cfg
from sug_tpu_torch.utils.config import parser_config

YAML = "tools/cfgs/cfgs_local/DG_unified_loss.yaml"

# (id, config edit, env, the error the port raises or None, the entry point)
CASES = [
    ("optimization_bf16", {"OPTIMIZATION.PRECISION": "bf16"}, {}, NotImplementedError, "train"),
    ("env_bf16_over_f32", {"PRECISION": "f32"}, {"SUG_PRECISION": "bf16"}, NotImplementedError,
     "train"),
    ("env_bfloat16", {}, {"SUG_PRECISION": "bfloat16"}, NotImplementedError, "train"),
    ("env_bn_groups", {}, {"SUG_BN_GROUPS": "2"}, None, "train"),
    ("per_replica", {"MODEL_CFG.BN_SEMANTICS": "per_replica", "MODEL_CFG.BN_GROUPS": 2}, {},
     None, "train"),
    ("per_replica_bf16", {"MODEL_CFG.BN_SEMANTICS": "per_replica", "PRECISION": "bf16"}, {},
     NotImplementedError, "train"),
    ("env_bn_groups_under_global", {"MODEL_CFG.BN_SEMANTICS": "global"}, {"SUG_BN_GROUPS": "2"},
     None, "train"),
    ("env_bn_groups_one", {}, {"SUG_BN_GROUPS": "1"}, None, "train"),
    ("precision_none", {"PRECISION": "none"}, {}, None, "train"),
    ("precision_unknown", {"PRECISION": "fp8"}, {}, ValueError, "train"),
    ("shipped_config", {}, {}, None, "train"),
    ("infer_env_bf16", {}, {"SUG_PRECISION": "bf16"}, NotImplementedError, "infer"),
]


@pytest.fixture
def clean_state(monkeypatch):
    """No precision or BN-group env vars, and the JAX package's global
    policies back at their defaults after the case."""
    for var in ("SUG_PRECISION", "SUG_BN_GROUPS"):
        monkeypatch.delenv(var, raising=False)
    yield monkeypatch
    jprecision.set_compute_dtype(None)
    jbn.reset_bn_groups()


def _config(edits):
    _, cfg = parser_config(["--cfg", YAML])
    cfg = copy.deepcopy(cfg)
    for dotted, value in edits.items():
        *parents, leaf = dotted.split(".")
        node = cfg
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return cfg


def _jax_policy(cfg):
    """Whether the JAX package computes in f32 under ``cfg`` and the current
    environment, and its BN group count; raises as it raises."""
    jprecision.configure_from_cfg(cfg)
    groups = jbn.configure_from_cfg(cfg, 1)
    return jprecision.compute_dtype() is None, groups


@pytest.mark.parametrize("edits,env,error,entry", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_port_refuses_what_jax_computes_otherwise(clean_state, edits, env, error, entry):
    for var, value in env.items():
        clean_state.setenv(var, value)
    cfg = _config(edits)
    if error is ValueError:
        with pytest.raises(ValueError):
            _jax_policy(cfg)
        with pytest.raises(ValueError, match="unknown PRECISION"):
            check_supported(cfg, "DGCNN")
        return
    f32, groups = _jax_policy(cfg)
    assert f32 is (error is None)
    assert configure_from_cfg(cfg) == groups
    if entry == "infer":
        assert jprecision.compute_dtype() == jnp.bfloat16
        with pytest.raises(error, match="ROADMAP item 12"):
            infer.main(["--ckpt", "missing.pt", "--dg", "--pts", "missing.npy",
                        "--device", "cpu"])
    elif error is None:
        check_supported(cfg, "DGCNN")
    else:
        with pytest.raises(error, match="ROADMAP item 12"):
            check_supported(cfg, "DGCNN")
