"""The bf16 policy (``PRECISION: bf16``) of the port against the JAX package
under the same policy on the CPU: the layers that follow it, a DG training
run through the front door, and the weight bridge.

1. ``ConvBN``, ``FCLayer``, ``CALayer``, ``TransformNet`` and the grouped
   ``BatchNorm`` against their flax counterparts on the same weights (BN
   statistics randomised, a third of the scales negative): the output in
   train mode, the input's gradient and the parameters' gradients of a
   random linear loss; each output's dtype equal to the JAX one. The
   bf16 ``BatchNorm`` keeps no f32 copy of its input for the backward.
2. ``train_dg_single_gpu --set PRECISION bf16`` trains DGCNN for three
   steps on the CPU (clouds of 64 points): finite losses, f32 params, the
   policy on the model.
The PointNet and DGCNN ``NetMDA`` slices against the JAX package under
bf16 are in ``test_torch_port_bf16_slice.py``, held by the same rule; there
the JAX package's variables load into a bf16 model as into an f32 one.

Tolerance: the policy's noise floor. For each compared quantity D is the
JAX package's own distance between its bf16 and its f32 result on the same
inputs (relative L2: each output, the gradients over all parameters as one
vector, and each gradient leaf against its own D), printed beside the
port's distance from the JAX bf16 result, which must be at most D, or at
most the f32 tolerance of the port's f32 tests where that is larger (the
losses 1e-4 relative, as ``test_torch_port_dg_step.py`` holds them; the
outputs 1e-3, as ``test_torch_port_stacked.py``; the gradients 2e-2): the
geo MMD, for one, moves by about 1e-6 between bf16 and f32, less than the
two packages' f32 sums differ. Every D must be under ``MAX_NOISE``, so
that a zero or a halved result fails. A gradient leaf is measured against
its own norm, or 1e-2 of the largest leaf's where that is larger. A leaf
whose f32 gradient is zero to f32 rounding (under 1e-4 of the largest
leaf: a Dense bias feeding a train-mode BN, which removes the mean) holds
only rounding; in both packages it must stay under 1e-2 of the largest.

Two bf16 results that round at different points each lie about D from
the f32 one, so about √2·D from each other; within D they agree only
where they round at the same points. So the JAX side here rounds where
the port does. Its functions are compiled with XLA's excess precision off
(``NO_EXCESS``): they round to bf16 at every op that flax's dtypes
declare, as JAX run op by op does (by default XLA on the CPU keeps f32
across some fused ops). Its bf16 Denses add the bias before the product's
one rounding (``single_rounding_dense``), as the port's fused product
does; flax's own Dense rounds the product, then the sum. And the max over
the points replays one set of choices in both packages (``ReplayMax``): a
bf16 ulp moves a near tie to another point, and the gradient of that
channel with it. The choices are the port's in f32, and both packages in
both precisions take them. ``test_torch_port_bf16_slice.py`` adds one
more: the activations' gates held open, since a flipped ReLU gate is
another such choice.
"""

from __future__ import annotations

import functools
import glob
import math
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen.dtypes import promote_dtype

from sug_tpu.models import bn as jbn
from sug_tpu.models import layers as jl
from sug_tpu.models import precision as jprecision
from sug_tpu_torch import train_dg_single_gpu
from sug_tpu_torch.data.datasets import DATASET_LIST, make_synthetic_pointda
from sug_tpu_torch.engine import dg_trainer as tdt
from sug_tpu_torch.models import bn as tbn
from sug_tpu_torch.models import layers as tl
from sug_tpu_torch.models.precision import Mixed, set_compute_dtype
from sug_tpu_torch.utils.jax_bridge import load_jax_variables
from tests._torch_port_common import jax_grads_by_name, randomize_variables
from tests.test_torch_port_dg_step import REL_L2

MAX_NOISE = 0.5  # D at or above it could not tell a halved result from a right one
ZERO_LEAF = 1e-4  # an f32 gradient leaf under this share of the largest is zero
NO_EXCESS = {"xla_allow_excess_precision": False}


@pytest.fixture(autouse=True)
def _jax_policy_reset():
    yield
    jprecision.set_compute_dtype(None)
    jbn.reset_bn_groups()


def compile_no_excess(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` with excess precision off."""
    return jax.jit(fn).lower(*args).compile(compiler_options=NO_EXCESS)


def _rel(got, want):
    got, want = (np.asarray(np.asarray(a, np.float32), np.float64) for a in (got, want))
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _vector(tree):
    return np.concatenate([np.asarray(tree[k], np.float64).ravel() for k in sorted(tree)])


def _within_floor(what, port, bf16, f32, f32_tol=0.0, factor=1.0):
    """The port's distance from the JAX bf16 result against the JAX
    package's own bf16-vs-f32 distance D (or ``f32_tol``, where larger),
    times ``factor``."""
    got, floor = _rel(port, bf16), _rel(bf16, f32)
    print(f"{what}: port vs JAX bf16 {got:.3e}, JAX bf16 vs f32 (D) {floor:.3e}")
    assert floor < MAX_NOISE, (what, floor)
    assert got <= max(factor * floor, f32_tol), (what, got, floor)


def _leaves_within_floor(what, port, bf16, f32, factor=1.0):
    """All gradients as one vector, then each leaf against its own D (times
    ``factor``), as the module docstring says."""
    _within_floor(f"{what}, all parameters", _vector(port), _vector(bf16), _vector(f32), REL_L2,
                  factor)
    top = max(np.linalg.norm(w) for w in f32.values())
    worst, loudest, zero = (0.0, 0.0, "", 0.0), (0.0, ""), []
    for n in sorted(f32):
        p, b, f = (np.asarray(t[n], np.float64) for t in (port, bf16, f32))
        if np.linalg.norm(f) <= ZERO_LEAF * top:
            zero.append(n)
            assert max(np.linalg.norm(p), np.linalg.norm(b)) <= 1e-2 * top, (what, n)
            continue
        scale = max(np.linalg.norm(f), 1e-2 * top)
        got, d = np.linalg.norm(p - b) / scale, np.linalg.norm(b - f) / scale
        assert d < MAX_NOISE, (what, n, d)
        assert got <= max(factor * d, REL_L2), (what, n, got, d)
        worst = max(worst, (got / max(d, REL_L2), got, n, d))
        loudest = max(loudest, (d, n))
    print(f"{what}, each leaf within its own D (closest: {worst[2]}, port vs JAX bf16 "
          f"{worst[1]:.3e}, D {worst[3]:.3e}; the largest D {loudest[0]:.3e}, {loudest[1]}); "
          f"zero to rounding in both: {len(zero)} leaves")


class ReplayMax:
    """One set of choices for the max over the points (``axis`` 1) in both
    packages. ``record(name)`` has the port's ``torch.amax`` note each
    call's argmax under ``name``; ``replay(name)`` has both packages take,
    call by call in the same order, each call's values at the noted argmax
    (and fails on a call of another shape). ``patch`` puts the two
    functions in the modules that take the max over the points."""

    axis = 1

    def __init__(self):
        self.records, self.calls, self.mode, self.pos = {}, [], None, 0

    def record(self, name):
        self.calls, self.mode = self.records.setdefault(name, []), "record"

    def replay(self, name):
        self.calls, self.mode, self.pos = self.records[name], "replay", 0

    def _next(self, shape):
        idx, a = self.calls[self.pos], self.axis
        assert idx.shape == tuple(shape[:a]) + (1,) + tuple(shape[a + 1:]), (idx.shape, shape,
                                                                               self.pos)
        self.pos += 1
        return idx

    def amax(self, x, dim):
        a = self.axis
        if self.mode == "record" and dim == a:
            self.calls.append(torch.argmax(x.detach(), dim=a, keepdim=True).numpy())
        elif self.mode == "replay" and dim == a:
            return torch.gather(x, a, torch.from_numpy(self._next(x.shape))).squeeze(a)
        return torch.amax(x, dim=dim)

    def max(self, x, axis=None, **kwargs):
        if self.mode == "replay" and axis == self.axis:
            return jnp.take_along_axis(x, jnp.asarray(self._next(x.shape)),
                                       axis=axis).squeeze(axis)
        return jnp.max(x, axis=axis, **kwargs)

    def patch(self, monkeypatch, port_modules, jax_modules):
        for m in port_modules:
            monkeypatch.setattr(m, "torch", _With(torch, amax=self.amax))
        for m in jax_modules:
            monkeypatch.setattr(m, "jnp", _With(jnp, max=self.max))


class Dense(fnn.Dense):
    """flax's ``Dense`` (same fields, params and auto-names) with the bias
    added in f32 before the product rounds to the compute dtype: one
    rounding, as the port's fused product rounds."""

    @fnn.compact
    def __call__(self, inputs):
        kernel = self.param("kernel", self.kernel_init, (jnp.shape(inputs)[-1], self.features),
                            self.param_dtype)
        bias = (self.param("bias", self.bias_init, (self.features,), self.param_dtype)
                if self.use_bias else None)
        inputs, kernel, bias = promote_dtype(inputs, kernel, bias, dtype=self.dtype)
        y = jax.lax.dot_general(inputs, kernel, (((inputs.ndim - 1,), (0,)), ((), ())),
                                precision=self.precision, preferred_element_type=jnp.float32)
        if bias is not None:
            y = y + bias.astype(jnp.float32)
        return y.astype(inputs.dtype)


def single_rounding_dense(monkeypatch):
    """The JAX layers that pass the policy's dtype (``sug_tpu/models/layers.py``:
    ConvBN, FCLayer, CALayer) build ``Dense`` above."""
    monkeypatch.setattr(jl, "nn", _With(fnn, Dense=Dense))


class _With:
    """``module`` with some attributes replaced."""

    def __init__(self, module, **replaced):
        self._module, self._replaced = module, replaced

    def __getattr__(self, name):
        return self._replaced[name] if name in self._replaced else getattr(self._module, name)


# (id, flax module factory, port module factory, input shape, apply args)
LAYERS = [
    ("ConvBN", lambda: jl.ConvBN(64), lambda: tl.ConvBN(32, 64), (4, 64, 32), (True,)),
    ("FCLayer", lambda: jl.FCLayer(256, use_bias=True), lambda: tl.FCLayer(512, 256, use_bias=True),
     (8, 512), ()),
    ("CALayer", lambda: jl.CALayer(), lambda: tl.CALayer(), (4, 4096), (True,)),
    ("TransformNet", lambda: jl.TransformNet(3), lambda: tl.TransformNet(3, 3), (4, 64, 3), (True,)),
    ("GroupedBN", lambda: jbn.BatchNorm(groups=2, use_running_average=False,
                                        dtype=jprecision.compute_dtype()),
     lambda: tbn.BatchNorm(48), (4, 64, 48), ()),
]


def _flax_run(make, variables, x, args, cot, precision):
    """Output and (param grads, input grad) of sum(out * cot) under the JAX
    policy ``precision``, compiled without excess precision; the grouped BN
    takes a bf16 input under bf16."""
    jprecision.set_compute_dtype(precision)
    module = make()
    x = jnp.asarray(x)
    if isinstance(module, jbn.BatchNorm) and precision:
        x = x.astype(jnp.bfloat16)

    def loss(params, xx):
        y, _ = module.apply({**variables, "params": params}, xx, *args, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * cot), y

    fn = compile_no_excess(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True),
                           variables["params"], x)
    (_, y), grads = fn(variables["params"], x)
    return y, grads


@pytest.mark.parametrize("name,jmake,tmake,shape,args", LAYERS, ids=[c[0] for c in LAYERS])
def test_layer_matches_flax_under_bf16(name, jmake, tmake, shape, args, monkeypatch):
    rng = np.random.default_rng(3)
    x = rng.normal(size=shape).astype(np.float32)
    jprecision.set_compute_dtype(None)
    variables = randomize_variables(jmake().init(jax.random.key(0), jnp.asarray(x), *args), 1)
    out_shape = jax.eval_shape(lambda: jmake().apply(variables, jnp.asarray(x), *args,
                                                     mutable=["batch_stats"])[0]).shape
    cot = rng.normal(size=out_shape).astype(np.float32)

    module = tmake()
    load_jax_variables(module, variables)
    module.train(bool(args))
    single_rounding_dense(monkeypatch)
    replay = ReplayMax()
    replay.patch(monkeypatch, [tl], [jl])  # the T-Net's max over the points
    initial = {n: b.clone() for n, b in module.named_buffers()}
    with torch.no_grad():
        replay.record("train")
        module(torch.from_numpy(x))
    module.load_state_dict(initial, strict=False)
    replay.replay("train")
    y16, (g16, gx16) = _flax_run(jmake, variables, x, args, cot, "bf16")
    replay.replay("train")
    y32, (g32, gx32) = _flax_run(jmake, variables, x, args, cot, None)
    replay.replay("train")
    tx = torch.from_numpy(x)
    if name == "GroupedBN":  # a BN in a bf16 ConvBN: bf16 in, bf16 out, 2 groups
        module.train(True)
        module.groups = 2
        tx = tx.to(torch.bfloat16)
        run = functools.partial(module, dtype=torch.bfloat16)
    else:
        set_compute_dtype(module, torch.bfloat16)
        run = module
    tx.requires_grad_()
    y = run(tx)
    (y.float() * torch.from_numpy(cot)).sum().backward()
    assert str(y.dtype).split(".")[-1] == str(y16.dtype), (y.dtype, y16.dtype)
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in module.parameters())
    _within_floor(f"{name} output", y.detach().float(), y16, y32)
    _within_floor(f"{name} input gradient", tx.grad.float(), gx16, gx32)
    port_grads = {n: p.grad.numpy() for n, p in module.named_parameters()}
    _leaves_within_floor(f"{name} gradients", port_grads, jax_grads_by_name(g16),
                         jax_grads_by_name(g32))


def test_bf16_batch_norm_keeps_no_f32_copy():
    """Train-mode BN of a bf16 (B·N, C) input keeps that bf16 input for its
    backward and no full-size f32 tensor; so does ConvBN around it."""
    x = torch.randn(4, 256, 64)
    for name, module, inp in (
        ("BatchNorm", lambda t: tbn.BatchNorm(64).train()(t, torch.bfloat16), x.to(torch.bfloat16)),
        ("ConvBN", tl.ConvBN(64, 64).train(), x),
    ):
        if isinstance(module, Mixed):
            set_compute_dtype(module, torch.bfloat16)
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append((t.dtype, t.numel())) or t, lambda t: t):
            module(inp.requires_grad_())
        full = [dtype for dtype, n in saved if n == x.numel()]
        assert torch.float32 not in full and torch.bfloat16 in full, (name, saved)


TRAIN_POINTS = 64  # the SA-node's 64 nodes and 64-point groups still fit


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("bf16") / "data" / "PointDA_data"
    for i, name in enumerate(DATASET_LIST):
        (root / name).mkdir(parents=True)
        for j, split in enumerate(("train", "test")):
            pts, labels = make_synthetic_pointda(num_per_class=4 if split == "train" else 1,
                                                 num_points=TRAIN_POINTS, seed=10 * i + j)
            np.save(root / name / f"{split}_pts.npy", pts)
            np.save(root / name / f"{split}_label.npy", labels)
    return root


def test_train_dg_bf16_three_steps(data_root, monkeypatch):
    """DGCNN through the training front door with ``--set PRECISION bf16``:
    three steps, finite losses, the policy on the model, f32 params."""
    trainers = []
    init = tdt.DGTrainer.__init__

    def recording(self, *args, **kwargs):
        init(self, *args, **kwargs)
        trainers.append(self)

    monkeypatch.setattr(tdt.DGTrainer, "__init__", recording)
    res = train_dg_single_gpu.main([
        "--source", "modelnet", "--cfg", "tools/cfgs/cfgs_local/DG_unified_loss.yaml",
        "--batch_size", "6", "--num_points", str(TRAIN_POINTS), "--device", "cpu",
        "--fix_random_seed",
        "--ckpt_save_interval", "1",
        "--set", "Model", "DGCNN", "DATA_ROOT", str(data_root), "OPTIMIZATION.NUM_EPOCHES", "1",
        "PRECISION", "bf16"])
    (epoch,) = res["history"]
    assert epoch["steps"] == 3
    for k in ("loss_cls", "loss_geo", "loss_sem"):
        assert math.isfinite(epoch[k]), k
    (tr,) = trainers
    assert tr.compute_dtype == torch.bfloat16
    assert {m.compute_dtype for m in tr.model.modules() if isinstance(m, Mixed)} == {torch.bfloat16}
    assert all(p.dtype == torch.float32 for p in tr.model.parameters())
    assert tr.optimizer.state["g"]["count"] == 3
    (ckpt,) = glob.glob(os.path.join(str(data_root), "output", "**", "*_epoch_1.pt"),
                        recursive=True)
    payload = torch.load(ckpt, weights_only=True)
    assert all(v.dtype == torch.float32 for v in payload["state"].values())
