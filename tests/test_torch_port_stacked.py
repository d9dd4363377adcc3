"""The stacked both-domains forward, grouped BN in the DG trainer and the
gradient-reversal layer of the port against the JAX package's
``DGTrainer`` on the CPU, at B=4 source + 4 target clouds of 128 points,
with weights bridged from the JAX init (BN stats randomised, a third of the
BN scales negative), the FPS starts JAX draws passed to the port, and head
dropout off on both sides (a stacked step draws one mask over 2B rows, a
sequential one two over B, in both packages).

1. ``_forward_both`` with ``SUG_STACKED_FORWARD=1`` for DGCNN, Pointnet and
   PTran: node_flat, node_attn, global_feat, both heads' logits and mid
   features of each domain, and the new BN running stats; then the port's
   stacked forward against its own sequential one, the counterpart of
   ``tests/test_bn_semantics.py::TestStackedForward``.
2. DGCNN's ``_loss(train=True)`` with ``METHODS.GRL`` at λ = 0.7 on the
   stacked forward: every loss and, with the MMD losses off, every
   gradient; the sequential forward's GRL gradients against the stacked
   one's. (The same ``_loss`` with ``BN_SEMANTICS: per_replica`` is in
   ``tests/test_torch_port_bn_groups.py``.)

Tolerances. The JAX package holds its stacked forward to its sequential one
at 2e-5 (3e-4 for PTran, 1e-2 on PTran's node_attn,
``tests/test_bn_semantics.py:229-236``): one library against itself. Here
two libraries sum in different orders, and BNs over few rows amplify that
rounding: the CALayer's BN normalises each of 4096 features over the 4 rows
of a domain, PointNet's ``bn1`` each of 1024 over 4. So each output is held
in relative L2 error to 1e-3 (measured up to 3.8e-5; the largest entry
differs by up to 3.3e-4 of the largest |value|, on node_attn), and so is
each BN statistic. Losses 1e-4 relative and gradients 2e-2 relative L2 per
leaf with the MMD off, as ``tests/test_torch_port_dg_step.py`` holds the
sequential step, for the reasons it gives.

The weights are seeded (``SEED``), so the test is deterministic. A
neighbour chosen among near-tied distances is a rounding decision, and one
chosen otherwise moves an output past the bound: a few other seeds of
DGCNN's weights do that, and with them the port in f32 against itself in
f64 chooses other neighbours in a few rows and differs as much.
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
from tests.test_torch_port_dg_step import (
    REL_L2,
    _assert_metrics,
    _identity_dropout,
    _jax_fps,
    _port_grads,
)
from tests._torch_port_common import one_torch_thread  # noqa: F401  (autouse)

B, N = 4, 128
OUT_REL_L2 = 1e-3
OUTPUTS = ("node_flat", "node_attn", "global_feat", "logits1", "logits2", "sem1", "sem2")
GRL_LAMBDA = 0.7
SEED = 0  # the port's initial weights, which the JAX variables take


def _clouds(seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(-1, 1, size=(B, N, 3)).astype(np.float32) for _ in range(2))


@functools.lru_cache(maxsize=None)
def _variables(model_name):
    """A JAX variable tree of ``NetMDA(model_name)`` filled from the port's
    initial weights (the tree's shapes from tracing the JAX init, which
    spares compiling it), then randomised."""
    port = tdt.NetMDA(model_name, generator=torch.Generator().manual_seed(SEED), num_points=N)
    return port_weights_as_jax(jdt.NetMDA(model_name=model_name, num_class=10),
                               port.state_dict(), jnp.zeros((B, N, 3)), True, domain="both")


def _jax_trainer(cfg, model_name):
    jtr = jdt.DGTrainer(cfg, model_name=model_name, augment=False)
    jbn.set_bn_groups(jtr._bn_groups)  # as train_step does before it traces
    return jtr, _variables(model_name)


def _port_trainer(cfg, model_name, variables, monkeypatch):
    tr = tdt.DGTrainer(cfg, model_name=model_name, augment=False, device="cpu", num_points=N)
    load_jax_variables(tr.model, variables)
    _identity_dropout(monkeypatch, tr)
    return tr


@pytest.fixture(autouse=True)
def _jax_bn_state():
    yield
    jbn.reset_bn_groups()


def _rel_l2(got, want):
    return np.linalg.norm(np.asarray(got, np.float64) - want) / np.linalg.norm(want)


def _assert_outputs(got_pair, want_pair):
    for side, got, want in zip(("source", "target"), got_pair, want_pair):
        for k in OUTPUTS:
            err = _rel_l2(got[k].detach().numpy(), np.asarray(want[k]))
            assert err <= OUT_REL_L2, (side, k, err)


def _stats(tr):
    return {n: b.clone() for n, b in tr.model.named_buffers()}


@pytest.mark.parametrize("model_name", ["DGCNN", "Pointnet", "PTran"])
def test_stacked_forward_matches_jax(model_name, monkeypatch):
    monkeypatch.setenv("SUG_STACKED_FORWARD", "1")
    cfg = bench._make_cfg()
    jtr, variables = _jax_trainer(cfg, model_name)
    tr = _port_trainer(cfg, model_name, variables, monkeypatch)
    ds, dt = _clouds(0)
    key = jax.random.key(7)
    fn = jax.jit(functools.partial(jtr._forward_both, train=True))
    out_s, out_t, stats, _ = fn(variables["params"], variables["batch_stats"], jnp.asarray(ds),
                                jnp.asarray(dt), key, jnp.float32(0.0))
    with torch.no_grad():
        got = tr._forward_both(torch.from_numpy(ds), torch.from_numpy(dt), *_jax_fps(key), True)
    _assert_outputs(got, (out_s, out_t))
    assert_rel_l2({n: v.numpy() for n, v in _stats(tr).items()}, jax_stats_by_name(stats),
                  OUT_REL_L2)
    # every generator BN took two updates (source, then target), the heads none
    before = jax_stats_by_name(variables["batch_stats"])
    moved = {n for n, v in _stats(tr).items() if not np.array_equal(v, before[n])}
    assert moved == set(before)


@pytest.mark.parametrize("model_name", ["DGCNN", "Pointnet", "PTran"])
def test_stacked_matches_sequential(model_name, monkeypatch):
    """The port's stacked forward against its own sequential one: outputs
    and running stats (the generator's sequential momentum updates)."""
    cfg = bench._make_cfg()
    tr = tdt.DGTrainer(cfg, model_name=model_name, augment=False, device="cpu", num_points=N)
    _identity_dropout(monkeypatch, tr)
    initial = _stats(tr)
    ds, dt = (torch.from_numpy(c) for c in _clouds(1))
    fps = (torch.tensor([3, 0, 127, 64]), torch.tensor([5, 9, 1, 100]))
    outs, stats = {}, {}
    for flag in ("1", "0"):
        monkeypatch.setenv("SUG_STACKED_FORWARD", flag)
        tr.model.load_state_dict(initial, strict=False)
        with torch.no_grad():
            outs[flag] = tr._forward_both(ds, dt, *fps, True)
        stats[flag] = _stats(tr)
    for (got, want) in zip(outs["1"], outs["0"]):
        for k in OUTPUTS:
            assert _rel_l2(got[k].numpy(), want[k].numpy()) <= OUT_REL_L2, k
    assert_rel_l2({n: v.numpy() for n, v in stats["1"].items()},
                  {n: v.numpy() for n, v in stats["0"].items()}, OUT_REL_L2)
    assert all(m.groups == 1 for m in tr.model.modules() if hasattr(m, "momentum_mode"))


def _loss_batch():
    """The numpy batch, its tensors, the JAX key and the FPS starts it draws."""
    ds, dt = _clouds(2)
    ls, lt = np.array([0, 1, 2, 3], np.int32), np.array([0, 5, 2, 7], np.int32)
    key = jax.random.key(11)
    tbatch = (torch.from_numpy(ds), torch.from_numpy(ls).long(), torch.from_numpy(dt),
              torch.from_numpy(lt).long())
    return (ds, ls, dt, lt), tbatch, key, _jax_fps(key)


def _port_loss(tr, initial, mmd_on, grl):
    tr.model.load_state_dict(initial, strict=False)
    _, tbatch, _, fps = _loss_batch()
    return tr._loss(*tbatch, *fps, mmd_on=mmd_on, train=True, grl_const=grl)


def _loss_pair(jtr, tr, variables, grl):
    """(metrics, grads) of both packages with the MMD losses on and off,
    each pass from the same BN stats."""
    batch, _, key, _ = _loss_batch()
    initial = _stats(tr)
    out = {}
    args = (variables["params"], variables["batch_stats"], *map(jnp.asarray, batch), key,
            jnp.float32(grl))
    # the gradients only with the MMD losses off
    _, (_, want) = jax.jit(functools.partial(jtr._loss, mmd_on=True, train=True))(*args)
    out[True] = (_port_loss(tr, initial, True, grl)[1], want)
    fn = jax.jit(jax.value_and_grad(functools.partial(jtr._loss, mmd_on=False, train=True),
                                    has_aux=True))
    (_, (_, want)), grads = fn(*args)
    total, got = _port_loss(tr, initial, False, grl)
    out[False] = (got, want, _port_grads(tr, total), jax_grads_by_name(grads))
    return out, initial


def _assert_losses_and_grads(out):
    for got, want, *_ in out.values():
        _assert_metrics(got, want)
    assert_rel_l2(out[False][2], out[False][3], REL_L2)


def test_loss_with_grl(monkeypatch):
    """GRL on the stacked forward against JAX; the sequential forward's GRL
    against the stacked one (dropout off, the two differ by rounding)."""
    monkeypatch.setenv("SUG_STACKED_FORWARD", "1")
    cfg = dict(bench._make_cfg())
    cfg["METHODS"] = {**cfg["METHODS"], "GRL": True}
    jtr, variables = _jax_trainer(cfg, "DGCNN")
    tr = _port_trainer(cfg, "DGCNN", variables, monkeypatch)
    out, initial = _loss_pair(jtr, tr, variables, GRL_LAMBDA)
    _assert_losses_and_grads(out)
    stacked = out[False][2]
    monkeypatch.setenv("SUG_STACKED_FORWARD", "0")
    total, _ = _port_loss(tr, initial, False, GRL_LAMBDA)
    assert_rel_l2(_port_grads(tr, total), stacked, REL_L2)
    # the reversal reaches the generator: its gradients differ from λ = 0's
    total, _ = _port_loss(tr, initial, False, 0.0)
    name = "g.block1.conv_dense.weight"
    assert _rel_l2(stacked[name], _port_grads(tr, total)[name]) > 0.1
