"""The PointNet and DGCNN ``NetMDA`` slices of the port under the bf16 policy
(``PRECISION: bf16``) against the JAX package under the same policy on the
CPU, at B=8 source + 8 target clouds of 128 points, with weights bridged
from the JAX init (BN stats randomised, a third of the BN scales negative):
``_forward_both`` in eval mode (node_flat, node_attn, global_feat, both
heads' logits and mid features), one ``_loss`` in train mode with the FPS
starts JAX draws and dropout off (every loss with the MMD on and off, and
with it off every parameter's gradient). The JAX package's variables load
into the bf16 model as into an f32 one: the bridge carries f32 leaves.

Dtypes as on the JAX kernel route: the node features are f32 there (the
Pallas kernel returns f32; the JAX CPU route returns bf16), the mid features
bf16, the rest f32. DGCNN's JAX reference runs on the CPU through
``edgeconv_reduce_reference`` with an f32 ``u``, where the JAX kernel route
and the port round ``u`` to bf16, so inside the test that reference is
patched to round ``u`` first: the kernel route's forward.

Tolerance: each figure within the JAX package's own bf16-against-f32
distance D on the same inputs, each gradient leaf within its own, every D
under ``MAX_NOISE``, as ``test_torch_port_bf16.py`` states it, with the JAX
side rounding where the port rounds (no excess precision, one rounding in
the bf16 Denses) and the max over the points replaying the port's f32
choices in both packages. The setting keeps the gradient a smooth function
of the rounding, so that D measures the policy's rounding and not the
choices it flips. Its gradient is a sum over a piece of a piecewise
function: the max over the points, the activations' gates and the
neighbours each pick a piece, a bf16 ulp flips some of those choices, and
the gradient jumps with them (with random gates, clouds alike and 4 rows a
BN, PointNet's gradients move by 0.6 of their norm between bf16 and f32 in
the JAX package alone). So the maxima are replayed, every BN's and
LayerNorm's bias is raised by ``GATE_SHIFT``, which puts each activation's
input far from its kink, and the clouds differ in extent and position
(``_clouds``), so that the BN over a batch of per-cloud maxima, 8 rows,
normalises a spread and not a rounding.
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
from sug_tpu.engine import dg_trainer as jdt
from sug_tpu.models import dgcnn as jdgcnn
from sug_tpu.models import layers as jl
from sug_tpu.models import pointnet as jpointnet
from sug_tpu.models import precision as jprecision
from sug_tpu.ops import edgeconv_pallas as jep
from sug_tpu_torch.engine import dg_trainer as tdt
from sug_tpu_torch.models import dgcnn as tdgcnn
from sug_tpu_torch.models import layers as tl
from sug_tpu_torch.models import pointnet as tpointnet
from sug_tpu_torch.models.bn import BatchNorm
from sug_tpu_torch.utils.jax_bridge import load_jax_variables, state_dict_from_jax, torch_key
from tests._torch_port_common import jax_grads_by_name
from tests.test_torch_port_bf16 import (
    ReplayMax,
    _jax_policy_reset,  # noqa: F401  (autouse: the JAX policy back to f32 after each test)
    _leaves_within_floor,
    _rel,
    _within_floor,
    compile_no_excess,
    single_rounding_dense,
)
from tests.test_torch_port_dg_step import LOSS_RTOL
from tests.test_torch_port_stacked import OUT_REL_L2, _variables
from tests._torch_port_common import one_torch_thread  # noqa: F401  (autouse)

B, N = 8, 128
GATE_SHIFT = 3.0
OUTPUTS = ("node_flat", "node_attn", "global_feat", "logits1", "logits2", "sem1", "sem2")
# the JAX kernel route's dtypes under bf16 (node_flat: the Pallas kernel's f32)
BF16_OUTPUTS = ("sem1", "sem2")
EDGECONV_REFERENCE = jep.edgeconv_reduce_reference


def _clouds():
    """Source and target clouds (B, N, 3): the unit cube scaled per cloud
    and axis by 0.2 to 1 and moved by up to 0.5."""
    rng = np.random.default_rng(2)
    out = []
    for _ in range(2):
        c = rng.uniform(-1, 1, size=(B, N, 3))
        out.append((c * rng.uniform(0.2, 1.0, (B, 1, 3)) + rng.uniform(-0.5, 0.5, (B, 1, 3)))
                   .astype(np.float32))
    return out


def _batch():
    """The numpy batch, its tensors, the JAX key and the FPS starts
    ``DGTrainer._forward_both`` draws from it."""
    ds, dt = _clouds()
    rng = np.random.default_rng(4)
    ls, lt = (rng.integers(0, 10, B).astype(np.int32) for _ in range(2))
    key = jax.random.key(11)
    k_s, k_t, _, _ = jax.random.split(key, 4)
    fps = tuple(torch.from_numpy(np.asarray(jax.random.randint(k, (B,), 0, N))) for k in (k_s, k_t))
    tbatch = (torch.from_numpy(ds), torch.from_numpy(ls).long(), torch.from_numpy(dt),
              torch.from_numpy(lt).long())
    return (ds, ls, dt, lt), tbatch, key, fps


def _open_gates(variables, model):
    """``variables`` with GATE_SHIFT added to every norm's bias (the
    port's BatchNorm and LayerNorm biases, the EdgeConv blocks' bn_bias)."""
    modules = dict(model.named_modules())

    def leaf(path, value):
        names = tuple(k.key for k in path)
        key = torch_key(names)
        owner = modules.get(key.rpartition(".")[0])
        norm = isinstance(owner, (BatchNorm, torch.nn.LayerNorm)) and key.endswith(".bias")
        return value + GATE_SHIFT if norm or key.endswith(".bn_bias") else value

    return {**variables, "params": jax.tree_util.tree_map_with_path(leaf, variables["params"])}


def _round_u(x, u, v, k):
    """DGCNN's JAX CPU route with u rounded to bf16 first, as the Pallas
    kernel's values_bf16 mode and the port do."""
    return EDGECONV_REFERENCE(x, u.astype(jnp.bfloat16).astype(jnp.float32), v, k)


def _jax_runs(model_name, variables, precision, replay, monkeypatch):
    """JAX's eval-mode forward, train-mode losses (MMD on and off) and
    gradients (MMD off) under ``precision``, dropout off, each compiled
    without excess precision on the port's replayed maxima."""
    cfg = {**bench._make_cfg(), "PRECISION": precision or "f32"}
    jprecision.set_compute_dtype(precision)
    monkeypatch.setattr(jep, "edgeconv_reduce_reference",
                        _round_u if precision == "bf16" else EDGECONV_REFERENCE)
    jtr = jdt.DGTrainer(cfg, model_name=model_name, augment=False)
    batch, _, key, _ = _batch()
    params, stats = variables["params"], variables["batch_stats"]
    args = (params, stats, *map(jnp.asarray, batch), key, jnp.float32(0.0))
    with monkeypatch.context() as m:
        m.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        replay.replay("eval")
        fwd_args = (params, stats, jnp.asarray(batch[0]), jnp.asarray(batch[2]), key,
                    jnp.float32(0.0))
        out = compile_no_excess(functools.partial(jtr._forward_both, train=False),
                                *fwd_args)(*fwd_args)[:2]
        replay.replay("mmd_on")
        _, (_, metrics_on) = compile_no_excess(
            functools.partial(jtr._loss, mmd_on=True, train=True), *args)(*args)
        replay.replay("mmd_off")
        (_, (_, metrics_off)), grads = compile_no_excess(jax.value_and_grad(
            functools.partial(jtr._loss, mmd_on=False, train=True), has_aux=True), *args)(*args)
    return out, metrics_on, metrics_off, jax_grads_by_name(grads)


def _port_runs(tr, initial, replay, mode):
    """The port's eval forward and train-mode losses (MMD on, then off,
    with the off pass's total), each from the initial BN stats, with the
    maxima recorded (``mode`` "record") or replayed."""
    _, tbatch, _, fps = _batch()
    getattr(replay, mode)("eval")
    with torch.no_grad():
        out = tr._forward_both(tbatch[0], tbatch[2], None, None, False)
    metrics = []
    for mmd_on in (True, False):
        tr.model.load_state_dict(initial, strict=False)
        getattr(replay, mode)("mmd_on" if mmd_on else "mmd_off")
        total, m = tr._loss(*tbatch, *fps, mmd_on=mmd_on, train=True)
        metrics.append(m)
    return out, metrics, total


@pytest.mark.parametrize("model_name", ["Pointnet", "DGCNN"])
def test_slice_matches_jax_under_bf16(model_name, monkeypatch):
    cfg = {**bench._make_cfg(), "PRECISION": "bf16"}
    tr = tdt.DGTrainer(cfg, model_name=model_name, augment=False, device="cpu", num_points=N)
    assert tr.compute_dtype == torch.bfloat16
    variables = _open_gates(_variables(model_name), tr.model)
    load_jax_variables(tr.model, variables)
    bridged = state_dict_from_jax(variables)
    assert all(v.dtype == torch.float32 and torch.equal(v, bridged[k])
               for k, v in tr.model.state_dict().items())
    tr.model.c1.dropout_rate = tr.model.c2.dropout_rate = 0.0
    initial = {n: b.clone() for n, b in tr.model.named_buffers()}
    single_rounding_dense(monkeypatch)
    replay = ReplayMax()
    replay.patch(monkeypatch, [tl, tpointnet, tdgcnn], [jl, jpointnet, jdgcnn])

    # the port in f32 picks the maxima that every other run replays
    tr.model.set_compute_dtype(None)
    f32, _, _ = _port_runs(tr, initial, replay, "record")
    tr.model.set_compute_dtype(torch.bfloat16)
    want = {p: _jax_runs(model_name, variables, p, replay, monkeypatch) for p in ("bf16", None)}
    tr.model.load_state_dict(initial, strict=False)
    got, metrics, total = _port_runs(tr, initial, replay, "replay")

    for side, g, w16, w32 in zip(("source", "target"), got, want["bf16"][0], want[None][0]):
        for k in OUTPUTS:
            assert g[k].dtype == (torch.bfloat16 if k in BF16_OUTPUTS else torch.float32), k
            _within_floor(f"{model_name} {side} {k}", g[k].float(), w16[k], w32[k], OUT_REL_L2)
    # the policy is on: the port's bf16 logits are not its f32 ones
    assert _rel(got[0]["logits1"], f32[0]["logits1"].numpy()) > 1e-3

    for mmd_on, index, m in ((True, 1, metrics[0]), (False, 2, metrics[1])):
        for k, w16 in want["bf16"][index].items():
            _within_floor(f"{model_name} {k} (mmd {mmd_on})", m[k].item(), float(w16),
                          float(want[None][index][k]), LOSS_RTOL)
    grads = {n: np.zeros(tuple(p.shape), np.float32) if g is None else g.numpy()
             for (n, p), g in zip(tr.params, tr.grads(total))}
    assert all(p.dtype == torch.float32 for _, p in tr.params)
    _leaves_within_floor(f"{model_name} gradients (MMD off)", grads, want["bf16"][3],
                         want[None][3])
