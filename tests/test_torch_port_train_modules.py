"""The port's modules in train mode against flax ``apply(..., mutable=
["batch_stats"])`` with the same (bridged) weights on the CPU: BatchNorm,
the EdgeConv block, the SA-node (with JAX-drawn FPS starts) and CALayer.
Each is compared on its outputs, the gradient of a random linear loss with
respect to every parameter and the input, and the updated batch stats. BN
running stats are randomised and about a third of the BN scales are
negative, so the EdgeConv epilogue's ``amin`` branch and its cotangent run.

Tolerance 1e-4 relative, plus 1e-4 of each leaf's largest |value| absolute:
the two libraries order the f32 sums of matmuls, reductions and batch
statistics differently (over up to B·N·k = 5120 edges), and a gradient leaf
is a sum whose rounding scales with its largest terms.
"""

from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sug_tpu.models.adapt_node import SelfAdaptiveNodeModule as JSANode
from sug_tpu.models.dgcnn import _EdgeConvBlock as JBlock
from sug_tpu.models.layers import CALayer as JCALayer
from sug_tpu.ops import geometry as jg
from sug_tpu_torch.models.adapt_node import SelfAdaptiveNodeModule
from sug_tpu_torch.models.bn import BatchNorm
from sug_tpu_torch.models.dgcnn import EdgeConvBlock
from sug_tpu_torch.models.heads import ClassifierHead
from sug_tpu_torch.models.layers import CALayer
from sug_tpu_torch.ops import geometry as tg
from tests._torch_port_common import (
    assert_leaves_close,
    jax_grads_by_name,
    jax_stats_by_name,
    port_module,
    randomize_variables,
    t,
)

TOL = dict(rtol=1e-4, atol_frac=1e-4)


def _jax_train(module, variables, inputs, cots, extra=()):
    """Outputs, grads (params and the first input) and new batch stats of
    ``sum(outputs * cots)`` through a train-mode flax ``apply``."""

    def loss(params, x):
        outs, mut = module.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                 x, *inputs[1:], True, *extra, mutable=["batch_stats"])
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), (outs, mut["batch_stats"])

    fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
    (_, (outs, stats)), (g_params, g_x) = fn(variables["params"], inputs[0])
    return [np.asarray(o) for o in outs], jax_grads_by_name(g_params), np.asarray(g_x), \
        jax_stats_by_name(stats)


def _port_train(module, variables, inputs, cots, extra=()):
    module = port_module(module, variables).train()
    x = t(inputs[0]).requires_grad_()
    outs = module(x, *(t(a) for a in inputs[1:]), *extra)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum(torch.sum(o * t(c)) for o, c in zip(outs, cots))
    names = [n for n, _ in module.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in module.named_parameters()] + [x])
    return ([o.detach().numpy() for o in outs], {n: g.numpy() for n, g in zip(names, grads[:-1])},
            grads[-1].numpy(), {n: b.numpy() for n, b in module.named_buffers()})


def _compare(module_j, module_t, variables, inputs, cots, extra_j=(), extra_t=()):
    want = _jax_train(module_j, variables, inputs, cots, extra_j)
    got = _port_train(module_t, variables, inputs, cots, extra_t)
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        assert_leaves_close({"out": g}, {"out": w}, **TOL)
    assert_leaves_close(got[1], want[1], **TOL)
    assert_leaves_close({"d_input": got[2]}, {"d_input": want[2]}, **TOL)
    assert_leaves_close(got[3], want[3], **TOL)


def _init(module, seed, *args):
    variables = jax.jit(lambda: module.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, *args))()
    return randomize_variables(variables, seed=seed)


class _FlaxBN(fnn.Module):
    """``flax.linen.BatchNorm`` as the JAX package builds it (momentum 0.9,
    eps 1e-5), with the package's ``train`` argument."""

    @fnn.compact
    def __call__(self, x, train):
        return fnn.BatchNorm(use_running_average=not train, momentum=0.9, epsilon=1e-5)(x)


class _PortBN(torch.nn.Module):
    def __init__(self, features):
        super().__init__()
        self.bn = BatchNorm(features)  # flax's auto-name BatchNorm_0

    def forward(self, x):
        return self.bn(x)


def test_batchnorm_train_matches_flax():
    rng = np.random.default_rng(0)
    x = (2.0 + 3.0 * rng.normal(size=(4, 32, 16))).astype(np.float32)
    jm = _FlaxBN()
    variables = _init(jm, 1, jnp.asarray(x), False)
    cots = [rng.normal(size=x.shape).astype(np.float32)]
    _compare(jm, _PortBN(16), variables, [x], cots)


@pytest.mark.parametrize("c,f", [(3, 64), (64, 128)])
def test_edgeconv_block_train(c, f):
    rng = np.random.default_rng(c)
    x = rng.normal(size=(2, 128, c)).astype(np.float32)
    jm = JBlock(f)
    variables = _init(jm, 3, jnp.asarray(x), False)
    assert (variables["params"]["bn_scale"] < 0).any()
    cots = [rng.normal(size=(2, 128, f)).astype(np.float32)]
    _compare(jm, EdgeConvBlock(c, f), variables, [x], cots)


def test_sa_node_train_with_jax_fps_starts():
    rng = np.random.default_rng(5)
    pc = rng.uniform(-1, 1, size=(2, 256, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 256, 64)).astype(np.float32)
    jm = JSANode()
    variables = _init(jm, 6, jnp.asarray(feats), jnp.asarray(pc), False)
    fps_start = jax.random.randint(jax.random.key(7), (2,), 0, 256)
    assert int(fps_start[0]) != 0 or int(fps_start[1]) != 0
    cots = [rng.normal(size=s).astype(np.float32) for s in ((2, 256, 128), (2, 64, 64), (2, 64, 3))]
    _compare(jm, SelfAdaptiveNodeModule(64), variables, [feats, pc], cots,
             extra_j=(fps_start,), extra_t=(torch.from_numpy(np.asarray(fps_start)),))


def test_calayer_train():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(4, 4096)).astype(np.float32)
    jm = JCALayer()
    variables = _init(jm, 9, jnp.asarray(x), False)
    cots = [rng.normal(size=x.shape).astype(np.float32)]
    _compare(jm, CALayer(), variables, [x], cots)


@pytest.mark.parametrize("dup", [False, True], ids=["random", "duplicates"])
def test_farthest_point_sample_random_starts(dup):
    rng = np.random.default_rng(10)
    x = rng.uniform(-1, 1, size=(3, 256, 3)).astype(np.float32)
    if dup:
        x[:, 10] = x[:, 3]
    start = np.asarray(jax.random.randint(jax.random.key(11), (3,), 0, 256))
    want = np.asarray(jg.farthest_point_sample(jnp.asarray(x), 64, jnp.asarray(start)))
    got = tg.farthest_point_sample(torch.from_numpy(x), 64, torch.from_numpy(start)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] == start).all()


def test_head_dropout_draws_from_the_generator():
    """flax Dropout's semantics: keep with probability 1 - rate, scale kept
    units by 1 / (1 - rate); the masks follow the generator's seed."""
    head = ClassifierHead(10).train()
    x = torch.ones(8, 20000)
    a = head.dropout(x, torch.Generator().manual_seed(0))
    b = head.dropout(x, torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    kept = a != 0
    assert torch.all(a[kept] == 1.0 / 0.6)
    assert abs(kept.float().mean().item() - 0.6) < 0.01
    with pytest.raises(ValueError, match="Generator"):
        head(torch.ones(2, 1024))
    head.eval()
    assert torch.equal(head.dropout(x, None), x)


def test_augment_rotation_layout_and_jitter_clip():
    """``pc @ Rz`` with ``_rot_z``'s layout, then jitter clipped at 0.05."""
    from sug_tpu.ops.augment import _rot_z
    from sug_tpu_torch.ops.augment import augment_batch, rot_z

    angles = np.array([0.0, 0.7, 3.5, 6.2], np.float32)
    np.testing.assert_allclose(rot_z(torch.from_numpy(angles)).numpy(),
                               np.asarray(_rot_z(jnp.asarray(angles))), rtol=1e-6, atol=1e-7)
    pc = torch.from_numpy(np.random.default_rng(12).normal(size=(4, 256, 3)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    out = augment_batch(pc, gen)
    assert torch.equal(out, augment_batch(pc, torch.Generator().manual_seed(0)))
    # undo the rotation with the same draw: what is left is the clipped jitter
    angles = torch.rand(4, generator=torch.Generator().manual_seed(0)) * 2.0 * np.pi
    rotated = torch.einsum("bnc,bcd->bnd", pc, rot_z(angles))
    jitter = out - rotated
    assert jitter.abs().max() <= 0.05 + 1e-6 and jitter.abs().max() > 0.02
    assert abs(jitter.std().item() - 0.01) < 1e-3
