"""PTran under the bf16 policy (``PRECISION: bf16``) in the port against the
JAX package under the same policy on the CPU, at the transformer width 512
(k = 16), weights bridged from the port's init into the JAX tree.

1. ``VectorAttentionBlock`` (64 -> 512 -> 64, bf16 input features as a
   TransitionDown hands them over): its output and the gradients of a
   random linear loss (every parameter, and the input), at a level that
   tiles (128 points), where the JAX block runs the Pallas kernel in
   interpret mode (``SUG_FUSED_VECATTN=interpret``, ``precise=False``), and
   at one that does not (32 points), where it runs its XLA route.
2. One PTran DG ``_loss(train=True)`` with the MMD losses off, at B=4 source
   + 4 target clouds of 128 points (levels of 128, 32, 8, 2 and 1 points):
   the losses and every parameter's gradient, the FPS starts JAX draws,
   dropout off.

Tolerance: the policy's noise floor, as ``test_torch_port_bf16.py`` states
it: each figure within the JAX package's own bf16-vs-f32 distance D on the
same inputs (its f32 run on the XLA route, true f32 on the CPU), each
gradient leaf within its own D, every D under ``MAX_NOISE``; the JAX side
compiled without excess precision, its bf16 Denses rounding once. Measured:
the block at 128 points within 0.2·D (output 4.1e-6 against D 9.0e-4, the
gradients as one vector 4.9e-4 against 3.6e-3).

Where the two packages round. The port runs the kernel route's roundings at
every level (ROADMAP.md §3); the JAX package runs them where N is a multiple
of 128 and its XLA route elsewhere, which rounds pos, att_in, the gamma
layers' outputs and v + pos to bf16 at every op
(``sug_tpu/models/ptran.py:133-162``). At the block's non-tiling level the
two round at different sets of points, each set about D from f32, so the
port is held there within √2·D of the JAX f32 result (two such sets of
roundings apart; measured up to 0.97·D) and within 2·D of the JAX bf16 one
(the triangle's bound). In the DG loss the JAX side takes the kernel route
at every level, as the port does: each level that does not tile runs the
Pallas kernel on its clouds padded to 128 points with points 10^3 away,
which no real point takes as a neighbour, and the padded rows' outputs are
dropped, so their cotangents are zero (``_padded_kernel``).

Why the DG loss is held to √2·D (``SATURATED``). Two bf16 runs whose f32
sums differ in order round apart wherever a sum lies within that difference
of a rounding boundary, and every later rounding widens the gap: a relative
difference δ flips a share δ/2^-8 of the next roundings, each by 2^-8, so
√(δ·2^-8) in relative L2, until the two runs differ as two independent sets
of roundings do, about √2·D. A BN output with its bias raised by 3 sits
near 3, where a bf16 step is 1/64 of the unit signal,
so each TransitionDown is such a widening: the two packages' features
agree to 2e-5 of their norm after the first block, 0.3·D after the first
TransitionDown and D after the fourth (measured on these inputs), and the
gradients, which flow back through all of them, lie about D apart (the
largest leaf 1.08·D, all leaves as one vector 1.0·D). A scalar loss's D is
one draw of that noise and may be small by chance (here 2.2e-4, where the
port's own bf16 loss lies 9.2e-4 from f32, and both packages' 2e-4 to
1.3e-3 on other batches), so the losses are held to the larger of √2·D and
one bf16 step, 2^-8 (``LOSS_BF16``).

The gradient is a sum over the pieces of a piecewise function, and a bf16
ulp flips some choices: the max over each TransitionDown's neighbours, and
the activations' gates. So, as in ``test_torch_port_bf16_slice.py``, both
packages replay the port's f32 choice of each of those maxima
(``ReplayNeighbourMax``), and every norm's bias is raised by 3
(``_open_gates``).
"""

from __future__ import annotations

import functools
import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from sug_tpu.engine import dg_trainer as jdt
from sug_tpu.models import precision as jprecision
from sug_tpu.models import ptran as jptran
from sug_tpu.ops import vector_attention_pallas as jvap
from sug_tpu_torch.engine import dg_trainer as tdt
from sug_tpu_torch.models import ptran as tptran
from sug_tpu_torch.models.layers import flax_init_
from sug_tpu_torch.utils.jax_bridge import load_jax_variables
from tests._torch_port_common import jax_grads_by_name
from tests.test_torch_port_bf16 import (
    MAX_NOISE,
    ZERO_LEAF,
    Dense,
    ReplayMax,
    _jax_policy_reset,  # noqa: F401  (autouse: the JAX policy back to f32 after each test)
    _leaves_within_floor,
    _rel,
    _With,
    _within_floor,
    compile_no_excess,
    single_rounding_dense,
)
from tests.test_torch_port_bf16_slice import _open_gates
from tests.test_torch_port_dg_step import REL_L2
from tests.test_torch_port_stacked import OUT_REL_L2, _variables
from tests._torch_port_common import one_torch_thread  # noqa: F401  (autouse)

B, N = 4, 128
D_POINTS, D_MODEL, K = 64, 512, 16
FAR = 1e3  # the padded points' distance from the cloud
SATURATED = math.sqrt(2.0)
LOSS_BF16 = 2.0**-8


@pytest.fixture(autouse=True)
def _single_rounding(monkeypatch):
    """The JAX bf16 Denses (the attention blocks', and ConvBN's, FCLayer's
    and CALayer's) add the bias before their one rounding, as the port's
    fused product does (``test_torch_port_bf16.Dense``)."""
    monkeypatch.setattr(jptran, "nn", _With(fnn, Dense=Dense))
    single_rounding_dense(monkeypatch)


class ReplayNeighbourMax(ReplayMax):
    """``ReplayMax`` over the neighbour axis (2): the max of each
    TransitionDown over its k neighbours."""

    axis = 2


# one trace per shape, shared by the levels padded to the same size and by
# both domains
FUSED = jax.jit(jvap.fused_vector_attention, static_argnums=(12,),
                static_argnames=("interpret", "precise"))


def _padded_kernel(xyz, q, key, val, *weights_and_k, interpret=False, precise=False):
    """``fused_vector_attention`` on clouds padded to a multiple of 128
    points: the padded points lie FAR away (each at its own distance), with
    zero features, and their rows are dropped from the result."""
    n = xyz.shape[1]
    pad = (-n) % jvap.TILE
    if pad:
        far = FAR * jnp.arange(1, pad + 1, dtype=jnp.float32)[None, :, None]
        xyz = jnp.concatenate([xyz, jnp.broadcast_to(far, (xyz.shape[0], pad, 3))], axis=1)
        q, key, val = (jnp.concatenate([t, jnp.zeros((t.shape[0], pad, t.shape[2]), t.dtype)],
                                       axis=1) for t in (q, key, val))
    return FUSED(xyz, q, key, val, *weights_and_k, interpret=interpret, precise=precise)[:, :n]


def _kernel_route_everywhere(monkeypatch):
    """The JAX blocks take the kernel route (in interpret mode) at every
    level, on padded clouds where the level does not tile."""
    monkeypatch.setattr(jptran, "_vecattn_mode", lambda n, d: ("interpret", False))
    monkeypatch.setattr(jvap, "fused_vector_attention", _padded_kernel)


# ---------------------------------------------------------------------------
# 1. the block
# ---------------------------------------------------------------------------


def _block_inputs(n, seed):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(B, n, 3))
    xyz = (xyz / np.linalg.norm(xyz, axis=-1).max(axis=1)[:, None, None]).astype(np.float32)
    feats = rng.normal(size=(B, n, D_POINTS)).astype(np.float32)
    feats = np.asarray(jnp.asarray(feats, jnp.bfloat16).astype(jnp.float32))  # bf16 values
    cot = rng.normal(size=(B, n, D_POINTS)).astype(np.float32)
    return xyz, feats, cot


def _block_params(block):
    """The JAX param tree of the port's block (Dense kernels transposed)."""
    params = {}
    for name, child in block.named_children():
        params[name] = {"kernel": child.weight.detach().numpy().T}
        if child.bias is not None:
            params[name]["bias"] = child.bias.detach().numpy()
    return params


def _jax_block(params, xyz, feats, cot, precision, monkeypatch):
    """The JAX block's output and (param grads, input grad) of
    sum(out * cot) under ``precision``: bf16 with the fused route chosen by
    ``SUG_FUSED_VECATTN=interpret`` and bf16 features, f32 on the XLA route."""
    jprecision.set_compute_dtype(precision)
    monkeypatch.setenv("SUG_FUSED_VECATTN", "interpret" if precision else "0")
    module = jptran.VectorAttentionBlock(D_POINTS, D_MODEL, K)
    x = jnp.asarray(feats, jnp.bfloat16 if precision else jnp.float32)

    def loss(p, xx):
        y = module.apply({"params": p}, jnp.asarray(xyz), xx)
        return jnp.sum(y.astype(jnp.float32) * cot), y

    fn = compile_no_excess(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True), params, x)
    (_, y), (g_params, g_x) = fn(params, x)
    grads = {f"{k}.{'weight' if leaf == 'kernel' else leaf}": np.asarray(v).T if leaf == "kernel"
             else np.asarray(v) for k, sub in g_params.items() for leaf, v in sub.items()}
    return np.asarray(y, np.float32), grads, np.asarray(g_x, np.float32)


@pytest.mark.parametrize("n", [128, 32], ids=["tiling-n128", "xla-route-n32"])
def test_block_under_bf16(n, monkeypatch):
    xyz, feats, cot = _block_inputs(n, seed=n)
    block = tptran.VectorAttentionBlock(D_POINTS, D_MODEL, K)
    gen = torch.Generator().manual_seed(n)
    flax_init_(block, gen)
    with torch.no_grad():
        for m in block.modules():
            if isinstance(m, torch.nn.Linear) and m.bias is not None:
                m.bias.normal_(0.0, 0.1, generator=gen)
    params = _block_params(block)
    want16 = _jax_block(params, xyz, feats, cot, "bf16", monkeypatch)
    want32 = _jax_block(params, xyz, feats, cot, None, monkeypatch)

    block.compute_dtype = torch.bfloat16
    x = torch.tensor(feats, dtype=torch.bfloat16, requires_grad=True)
    y = block(torch.from_numpy(xyz), x)
    assert y.dtype == torch.float32 and y.shape == (B, n, D_POINTS)
    torch.sum(y * torch.from_numpy(cot)).backward()
    assert x.grad.dtype == torch.bfloat16
    got = (y.detach().numpy(), {k: p.grad.numpy() for k, p in block.named_parameters()},
           x.grad.float().numpy())
    if n % jvap.TILE == 0:  # the same rounding points: within D of the JAX bf16 result
        _within_floor(f"block N={n} output", got[0], want16[0], want32[0], OUT_REL_L2)
        _within_floor(f"block N={n} input gradient", got[2], want16[2], want32[2], REL_L2)
        _leaves_within_floor(f"block N={n} gradients", got[1], want16[1], want32[1])
        return
    # the XLA route rounds at other points: the port within √2·D of the JAX f32 result
    for what, g, w16, w32 in (("output", got[0], want16[0], want32[0]),
                              ("input gradient", got[2], want16[2], want32[2])):
        d, from_f32, from_bf16 = _rel(w16, w32), _rel(g, w32), _rel(g, w16)
        print(f"block N={n} {what}: port vs JAX f32 {from_f32:.3e}, port vs JAX bf16 "
              f"{from_bf16:.3e}, JAX bf16 vs f32 (D) {d:.3e}")
        assert d < MAX_NOISE and from_f32 <= SATURATED * d and from_bf16 <= 2 * d, what
    top = max(np.linalg.norm(w) for w in want32[1].values())
    for name, w32 in want32[1].items():
        g, w16 = got[1][name].astype(np.float64), want16[1][name].astype(np.float64)
        if np.linalg.norm(w32) <= ZERO_LEAF * top:  # bg2: zero up to rounding
            assert max(np.linalg.norm(g), np.linalg.norm(w16)) <= 1e-2 * top, name
            continue
        scale = max(np.linalg.norm(w32), 1e-2 * top)
        d, from_f32 = np.linalg.norm(w16 - w32) / scale, np.linalg.norm(g - w32) / scale
        print(f"block N={n} {name}: port vs JAX f32 {from_f32:.3e}, D {d:.3e}")
        assert d < MAX_NOISE and from_f32 <= max(SATURATED * d, REL_L2), (name, from_f32, d)


# ---------------------------------------------------------------------------
# 2. the DG loss
# ---------------------------------------------------------------------------


def _batch():
    """Source and target clouds of different extents and positions, labels,
    the JAX key and the FPS starts ``_forward_both`` draws from it."""
    rng = np.random.default_rng(8)
    clouds = []
    for _ in range(2):
        c = rng.uniform(-1, 1, size=(B, N, 3))
        clouds.append((c * rng.uniform(0.2, 1.0, (B, 1, 3)) + rng.uniform(-0.5, 0.5, (B, 1, 3)))
                      .astype(np.float32))
    labels = [rng.integers(0, 10, B).astype(np.int32) for _ in range(2)]
    key = jax.random.key(12)
    k_s, k_t, _, _ = jax.random.split(key, 4)
    fps = tuple(torch.tensor(np.asarray(jax.random.randint(k, (B,), 0, N))) for k in (k_s, k_t))
    return (clouds[0], labels[0], clouds[1], labels[1]), key, fps


def _jax_loss(variables, precision, replay, monkeypatch):
    """JAX's train-mode metrics and gradients with the MMD off under
    ``precision`` (bf16 on the kernel route at every level, f32 on the XLA
    route), dropout off, compiled without excess precision, on the port's
    replayed maxima."""
    cfg = {**bench._make_cfg(), "PRECISION": precision or "f32"}
    jprecision.set_compute_dtype(precision)
    jtr = jdt.DGTrainer(cfg, model_name="PTran", augment=False)
    batch, key, _ = _batch()
    args = (variables["params"], variables["batch_stats"], *map(jnp.asarray, batch), key,
            jnp.float32(0.0))
    with monkeypatch.context() as m:
        m.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        if precision:
            _kernel_route_everywhere(m)
        else:
            m.setenv("SUG_FUSED_VECATTN", "0")
        replay.replay("loss")
        (_, (_, metrics)), grads = compile_no_excess(jax.value_and_grad(
            functools.partial(jtr._loss, mmd_on=False, train=True), has_aux=True), *args)(*args)
    return {k: float(v) for k, v in metrics.items()}, jax_grads_by_name(grads)


def test_ptran_dg_loss_under_bf16(monkeypatch):
    cfg = {**bench._make_cfg(), "PRECISION": "bf16"}
    tr = tdt.DGTrainer(cfg, model_name="PTran", augment=False, device="cpu", num_points=N)
    assert tr.compute_dtype == torch.bfloat16
    variables = _open_gates(_variables("PTran"), tr.model)
    load_jax_variables(tr.model, variables)
    tr.model.c1.dropout_rate = tr.model.c2.dropout_rate = 0.0
    initial = {n: b.clone() for n, b in tr.model.named_buffers()}
    replay = ReplayNeighbourMax()
    replay.patch(monkeypatch, [tptran], [jptran])
    batch, _, fps = _batch()
    tbatch = (torch.from_numpy(batch[0]), torch.from_numpy(batch[1]).long(),
              torch.from_numpy(batch[2]), torch.from_numpy(batch[3]).long())

    def port_loss(mode):
        tr.model.load_state_dict(initial, strict=False)
        getattr(replay, mode)("loss")
        total, metrics = tr._loss(*tbatch, *fps, mmd_on=False, train=True)
        grads = {n: np.zeros(tuple(p.shape), np.float32) if g is None else g.numpy()
                 for (n, p), g in zip(tr.params, tr.grads(total))}
        return {k: float(v.detach()) for k, v in metrics.items()}, grads

    # the port in f32 picks the maxima that every other run replays
    tr.model.set_compute_dtype(None)
    f32 = port_loss("record")
    tr.model.set_compute_dtype(torch.bfloat16)
    want = {p: _jax_loss(variables, p, replay, monkeypatch) for p in ("bf16", None)}
    got = port_loss("replay")
    # the policy is on: the port's bf16 gradients are not its f32 ones
    assert _rel(got[1]["g.backbone.transformer1.fc_gamma1.weight"],
                f32[1]["g.backbone.transformer1.fc_gamma1.weight"]) > 1e-3
    for k, w16 in want["bf16"][0].items():
        _within_floor(f"PTran {k}", got[0][k], w16, want[None][0][k], LOSS_BF16, SATURATED)
    assert all(p.dtype == torch.float32 for _, p in tr.params)
    _leaves_within_floor("PTran gradients (MMD off)", got[1], want["bf16"][1], want[None][1],
                         SATURATED)
