"""KPConv under the DG trainer of the port (``NetMDA("KPConv")`` in
``sug_tpu_torch.engine.dg_trainer``) against the JAX package's on the CPU:

1. one DG ``_loss(train=True)`` and its gradients at B=4 source + 4 target
   clouds of 512 points with the shipped
   ``DG_unified_loss_onedataset_modelnet_KPConv.yaml``'s losses
   (ClassWeighting with DLSA class weights, soft MMD with mean2one SDA
   weights, ADV_WEIGHT 0.5, the target loss), on the sequential and on the
   stacked forward;
2. the stacked-forward rule against the JAX trainer's, for every setting of
   ``SUG_KPCONV_STACKED``, ``SUG_STACKED_FORWARD`` and the BN groups, for
   KPConv and for DGCNN.

Both packages run on the JAX package's pyramids (``jax_on_pyramid``,
``replayed_pyramid``): a radius query within an ulp of a tie may otherwise
fall on either side (the pyramids themselves are held to their ties in
``tests/test_torch_port_kpconv.py``). The reference is the JAX package in
float64 (its ``InstanceNorm``, BN and contractions cast to f32, and its
kernel points are f32: ``jax_on_pyramid`` reads them as float64). The port
in float64 is held within 1e-9 relative in the losses and 1e-6 relative L2
in each gradient leaf, a leaf zero up to rounding against 1e-2 of the
largest (measured: 1e-15 in the losses; every leaf within 1e-11 but
``attention_t``'s first Dense, 1.2e-8); in float32 the losses within 1e-5
relative (measured up to 3.8e-7). The f32 gradients are not compared here:
with the MMD losses on, B=4 clouds a domain and the mean2one SDA weights
make them ill-conditioned, so that the JAX package's own f32 gradients lie
up to 0.40 relative L2 from its f64 ones (``attention_t``'s first Dense;
the heads' ``mlp1`` 0.26 and 0.40), and with the MMD off within 5.6e-5;
``tests/test_torch_port_kpconv_models.py`` holds the f32 gradients of the
generator.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sug_tpu.engine import dg_trainer as jdt
from sug_tpu.models import bn as jbn
from sug_tpu.models.net_mda import NetMDA as JNetMDA
from sug_tpu_torch.data.datasets import PointCloudDataset
from sug_tpu_torch.engine import dg_trainer as tdt
from sug_tpu_torch.utils.config import parser_config
from sug_tpu_torch.utils.jax_bridge import load_jax_variables
from tests._torch_port_common import (  # noqa: F401
    assert_rel_l2,
    one_torch_thread,
    port_weights_as_jax,
    t,
)
from tests.test_torch_port_kpconv_models import (
    as_port,
    grads_f64,
    jax_on_pyramid,
    jax_pyramid,
    replayed_pyramid,
    unit_clouds,
)

YAML = os.path.join(os.path.dirname(__file__), "..", "tools", "cfgs", "cfgs_local",
                    "DG_unified_loss_onedataset_modelnet_KPConv.yaml")
F64_REL = 1e-9
F64_GRAD_REL_L2 = 1e-6
LOSS_RTOL = 1e-5
METRICS = ("loss_cls", "loss_adv", "loss_geo", "loss_sem", "loss_total")


@pytest.fixture(autouse=True)
def _jax_bn_state():
    yield
    jbn.reset_bn_groups()


# 1. the DG loss ----------------------------------------------------------------------

B, N = 4, 512


def _cfg():
    _, cfg = parser_config(["--cfg", YAML])
    assert cfg["Model"] == "KPConv" and cfg["OPTIMIZATION"]["CLS_LOSS"] == "ClassWeighting"
    return cfg


def _source_dataset():
    """An unbalanced source split, so the DLSA class weights differ."""
    labels = np.repeat(np.arange(10), [9, 2, 5, 3, 7, 1, 4, 6, 2, 8])
    pts = unit_clouds(8, len(labels), 64)
    return PointCloudDataset("modelnet", pts, labels, num_points=64)


def _batch():
    clouds = unit_clouds(9, 2 * B, N)
    ls, lt = np.array([0, 1, 2, 5], np.int32), np.array([0, 4, 2, 7], np.int32)
    return clouds[:B], ls, clouds[B:], lt


@pytest.mark.parametrize("stacked", [False, True], ids=["sequential", "stacked"])
def test_dg_loss_and_gradients(stacked, monkeypatch):
    monkeypatch.setenv("SUG_KPCONV_STACKED", "1" if stacked else "0")
    monkeypatch.delenv("SUG_STACKED_FORWARD", raising=False)
    cfg = _cfg()
    ds = _source_dataset()
    jtr = jdt.DGTrainer(cfg, model_name="KPConv", augment=False,
                        criterion=jdt.make_criterion(cfg["OPTIMIZATION"], ds))
    tr = tdt.DGTrainer(cfg, model_name="KPConv", augment=False, device="cpu")
    tr.criterion = tdt.make_criterion(cfg["OPTIMIZATION"], ds)
    assert tdt.stacked_forward("KPConv") == stacked and tr.bn_groups == 1
    variables = port_weights_as_jax(jdt.NetMDA(model_name="KPConv"), tr.model.state_dict(),
                                    jnp.zeros((B, N, 3)), True, domain="both")
    load_jax_variables(tr.model, variables)
    initial = {n: b.clone() for n, b in tr.model.named_buffers()}

    batch = _batch()
    kp_cfg = tr.model.g.encoder.cfg
    clouds = [np.concatenate([batch[0], batch[2]])] if stacked else [batch[0], batch[2]]
    pyrs = [jax_pyramid(c, kp_cfg) for c in clouds]

    def fn(params, batch_stats, *data):
        loss = lambda p: jtr._loss(p, batch_stats, *data, jax.random.key(0),  # noqa: E731
                                   jnp.zeros(()), mmd_on=True, train=True)
        return jax.value_and_grad(lambda p: loss(p), has_aux=True)(params)

    (_, (_, want)), jgrads = jax_on_pyramid(fn, pyrs, variables["params"],
                                            variables["batch_stats"], *batch, f64=True)
    want_grads = grads_f64(jgrads)
    tbatch = (t(batch[0]), torch.from_numpy(batch[1]).long(), t(batch[2]),
              torch.from_numpy(batch[3]).long())
    for dtype in (torch.float64, torch.float32):
        tr.model.to(dtype).load_state_dict(initial, strict=False)
        data = [a.to(dtype) if a.is_floating_point() else a for a in tbatch]
        with replayed_pyramid(monkeypatch, *[as_port(p, dtype) for p in pyrs]):
            total, got = tr._loss(*data, mmd_on=True, train=True)
        grads = {n: (np.zeros(tuple(p.shape)) if g is None else g.double().numpy())
                 for (n, p), g in zip(tr.params, tr.grads(total))}
        for k in METRICS:
            print(f"{dtype} {k}: {float(got[k])!r} vs {float(want[k])!r}")
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=F64_REL if dtype == torch.float64 else LOSS_RTOL,
                                       atol=1e-12, err_msg=f"{k} ({dtype})")
        if dtype == torch.float64:
            assert_rel_l2(grads, want_grads, F64_GRAD_REL_L2)
    assert float(want["loss_geo"]) != 0.0 and float(want["loss_adv"]) != 0.0


# 2. the stacked-forward rule ---------------------------------------------------------

class _Chose(Exception):
    pass


@pytest.mark.parametrize("model_name", ["KPConv", "DGCNN"])
def test_stacked_rule_matches_jax(model_name, monkeypatch):
    """For every setting, which forward each trainer takes: the JAX
    trainer's ``_forward_both`` and the port's, stopped at their first call
    (the stacked forward or the per-domain model call)."""
    data = np.zeros((2, 64, 3), np.float32)

    def choice(trainer, call):
        try:
            call()
        except _Chose as e:
            return e.args[0]
        raise AssertionError("no forward was taken")

    def stop(name):
        def raiser(*args, **kwargs):
            raise _Chose(name)
        return raiser

    for groups in (1, 2):
        cfg = dict(_cfg())
        if groups == 2:
            cfg["MODEL_CFG"] = {"BN_SEMANTICS": "per_replica", "BN_GROUPS": 2}
        jtr = jdt.DGTrainer(cfg, model_name=model_name, augment=False)
        tr = tdt.DGTrainer(cfg, model_name=model_name, augment=False, device="cpu",
                           num_points=64)
        assert jtr._bn_groups == tr.bn_groups == groups
        monkeypatch.setattr(jtr, "_forward_stacked", stop("stacked"))
        monkeypatch.setattr(JNetMDA, "apply", stop("sequential"))
        monkeypatch.setattr(tr, "_forward_stacked", stop("stacked"))
        monkeypatch.setattr(type(tr.model), "__call__", stop("sequential"))
        for kp in (None, "0", "1"):
            for env in (None, "0", "1"):
                for name, value in (("SUG_KPCONV_STACKED", kp), ("SUG_STACKED_FORWARD", env)):
                    if value is None:
                        monkeypatch.delenv(name, raising=False)
                    else:
                        monkeypatch.setenv(name, value)
                want = choice(jtr, lambda: jtr._forward_both(
                    None, None, data, data, jax.random.key(0), 0.0, train=False))
                got = choice(tr, lambda: tr._forward_both(t(data), t(data), None, None, False))
                assert got == want, (model_name, groups, kp, env, got, want)
                if model_name == "KPConv" and groups == 1:
                    assert (want == "stacked") == (kp != "0" or env == "1")
        monkeypatch.undo()
