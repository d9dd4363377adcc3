"""The port reads the precision policy and the BN groups as the JAX package
does. Each case sets a config and an environment, asks the JAX package what
it would compute under them (``sug_tpu.models.precision.compute_dtype()``
and the group count of ``sug_tpu.models.bn.configure_from_cfg``), and checks
that the port's ``check_supported`` accepts the config for DGCNN and for
PointNet, that the port's compute dtype (``models.precision.compute_dtype``,
which the trainer and ``infer`` read once and set on the model) is the JAX
one, bf16 or f32, that an unknown name raises ``ValueError`` in both, and
that the port's ``configure_from_cfg`` gives the JAX package's group count.
The ``infer`` case serves a checkpoint under ``SUG_PRECISION=bf16`` with
both models. PTran under each of the three triggers builds through the
trainer (``check_supported``, then ``DGTrainer``) and is served by ``infer``
with every ``Mixed`` module in bf16, its vector attention in its bf16 mode."""

from __future__ import annotations

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sug_tpu.models import bn as jbn
from sug_tpu.models import precision as jprecision
from sug_tpu_torch import infer
from sug_tpu_torch.engine.checkpoint import save_checkpoint
from sug_tpu_torch.engine.dg_trainer import DGTrainer, check_supported
from sug_tpu_torch.models.bn import configure_from_cfg
from sug_tpu_torch.models.net_mda import NetMDA
from sug_tpu_torch.models.precision import Mixed, compute_dtype
from sug_tpu_torch.utils.config import parser_config

YAML = "tools/cfgs/cfgs_local/DG_unified_loss.yaml"
MODELS = ("DGCNN", "Pointnet")
TORCH_DTYPE = {None: None, jnp.bfloat16: torch.bfloat16}

# (id, config edit, env, the error the port raises or None, the entry point)
CASES = [
    ("optimization_bf16", {"OPTIMIZATION.PRECISION": "bf16"}, {}, None, "train"),
    ("env_bf16_over_f32", {"PRECISION": "f32"}, {"SUG_PRECISION": "bf16"}, None, "train"),
    ("env_bfloat16", {}, {"SUG_PRECISION": "bfloat16"}, None, "train"),
    ("env_bn_groups", {}, {"SUG_BN_GROUPS": "2"}, None, "train"),
    ("per_replica", {"MODEL_CFG.BN_SEMANTICS": "per_replica", "MODEL_CFG.BN_GROUPS": 2}, {},
     None, "train"),
    ("per_replica_bf16", {"MODEL_CFG.BN_SEMANTICS": "per_replica", "PRECISION": "bf16"}, {},
     None, "train"),
    ("env_bn_groups_under_global", {"MODEL_CFG.BN_SEMANTICS": "global"}, {"SUG_BN_GROUPS": "2"},
     None, "train"),
    ("env_bn_groups_one", {}, {"SUG_BN_GROUPS": "1"}, None, "train"),
    ("precision_none", {"PRECISION": "none"}, {}, None, "train"),
    ("precision_unknown", {"PRECISION": "fp8"}, {}, ValueError, "train"),
    ("shipped_config", {}, {}, None, "train"),
    ("infer_env_bf16", {}, {"SUG_PRECISION": "bf16"}, None, "infer"),
]
# the three triggers of the policy, as (config edit, env)
TRIGGERS = {
    "precision": ({"PRECISION": "bf16"}, {}),
    "optimization_precision": ({"OPTIMIZATION.PRECISION": "bfloat16"}, {}),
    "env": ({}, {"SUG_PRECISION": "bf16"}),
}


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
    """The JAX package's compute dtype (None for f32) under ``cfg`` and the
    current environment, and its BN group count; raises as it raises."""
    jprecision.configure_from_cfg(cfg)
    groups = jbn.configure_from_cfg(cfg, 1)
    return jprecision.compute_dtype(), groups


def _serve(tmp_path, monkeypatch, model_name):
    """``infer.main`` on two clouds with a checkpoint of ``model_name``;
    returns the compute dtype of the model it served and its predictions."""
    ckpt = save_checkpoint(str(tmp_path / f"{model_name}.pt"),
                           NetMDA(model_name, generator=torch.Generator().manual_seed(0),
                                  num_points=128), 0)
    pts = tmp_path / "clouds.npy"
    np.save(pts, np.random.default_rng(0).normal(size=(2, 128, 3)).astype(np.float32))
    served, load = [], infer.load_model

    def recording(*args, **kwargs):
        model = load(*args, **kwargs)
        served.extend({m.compute_dtype for m in model.modules() if isinstance(m, Mixed)})
        return model

    monkeypatch.setattr(infer, "load_model", recording)
    result = infer.main(["--ckpt", ckpt, "--model", model_name, "--dg", "--pts", str(pts),
                         "--num_points", "128", "--batch_size", "2", "--device", "cpu"])
    return served, result["preds"]


@pytest.mark.parametrize("edits,env,error,entry", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_port_refuses_what_jax_computes_otherwise(clean_state, tmp_path, edits, env, error,
                                                  entry):
    for var, value in env.items():
        clean_state.setenv(var, value)
    cfg = _config(edits)
    if error is ValueError:
        with pytest.raises(ValueError):
            _jax_policy(cfg)
        for model_name in MODELS:
            with pytest.raises(ValueError, match="unknown PRECISION"):
                check_supported(cfg, model_name)
        return
    dtype, groups = _jax_policy(cfg)
    assert configure_from_cfg(cfg) == groups
    for model_name in MODELS:
        check_supported(cfg, model_name)
    assert compute_dtype(cfg) == TORCH_DTYPE[dtype]
    if entry == "infer":
        assert dtype == jnp.bfloat16
        for model_name in MODELS:
            served, preds = _serve(tmp_path, clean_state, model_name)
            assert served == [torch.bfloat16] and preds.shape == (2,)


# infer reads the environment alone, the trainer the config and the environment
@pytest.mark.parametrize("trigger,entry", [(t, "check_supported") for t in TRIGGERS]
                         + [("env", "infer")])
def test_ptran_under_bf16_raises(clean_state, tmp_path, trigger, entry):
    """PTran under bf16 through each trigger and entry point raises nothing,
    and computes in bf16 on every ``Mixed`` module (its attention blocks'
    projections among them)."""
    edits, env = TRIGGERS[trigger]
    for var, value in env.items():
        clean_state.setenv(var, value)
    cfg = _config(edits)
    assert _jax_policy(cfg)[0] == jnp.bfloat16
    if entry == "infer":
        served, preds = _serve(tmp_path, clean_state, "PTran")
        assert served == [torch.bfloat16] and preds.shape == (2,)
    else:  # the trainer's front door: check_supported reads the policy, the trainer sets it
        check_supported(cfg, "PTran")
        tr = DGTrainer(cfg, model_name="PTran", device="cpu")
        mixed = [m for m in tr.model.modules() if isinstance(m, Mixed)]
        assert tr.compute_dtype == torch.bfloat16
        assert {m.compute_dtype for m in mixed} == {torch.bfloat16}
        assert sum(type(m).__name__ == "VectorAttentionBlock" for m in mixed) == 5
