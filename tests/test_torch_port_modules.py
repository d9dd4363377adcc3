"""The port's modules against flax ``apply`` with the same (bridged) weights,
in eval mode on the CPU: the EdgeConv block, the SA-node, CALayer, the
classifier head and the DGCNN generator. BN running stats are randomised and
about a third of the BN scales are negative, so the ``amin`` branch of the
EdgeConv epilogue runs.

Tolerance 1e-4 abs + 1e-4 rel: the two libraries order f32 sums in matmuls
and reductions differently (the port also forms ``v = x @ (W2 - W1)`` where
flax contracts ``[-x, x]`` with W), and a few layers compound that.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sug_tpu.models.adapt_node import SelfAdaptiveNodeModule as JSANode
from sug_tpu.models.dgcnn import DGCNNGenerator as JGenerator
from sug_tpu.models.dgcnn import _EdgeConvBlock as JBlock
from sug_tpu.models.heads import ClassifierHead as JHead
from sug_tpu.models.layers import CALayer as JCALayer
from sug_tpu_torch.models.adapt_node import SelfAdaptiveNodeModule
from sug_tpu_torch.models.dgcnn import DGCNNGenerator, EdgeConvBlock
from sug_tpu_torch.models.heads import ClassifierHead
from sug_tpu_torch.models.layers import CALayer
from sug_tpu_torch.models.net_mda import NetMDA
from tests._torch_port_common import port_module, randomize_variables, t

TOL = dict(rtol=1e-4, atol=1e-4)


def _cloud(seed, b=2, n=128):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, size=(b, n, 3)).astype(np.float32)


def _init(module, *args):
    variables = jax.jit(lambda: module.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, *args
    ))()
    return randomize_variables(variables, seed=3)


def _apply(module, variables, *args):
    """Jitted eval ``apply``: eager flax is several times slower here."""
    return jax.jit(lambda v, *a: module.apply(v, *a, False))(variables, *args)


def _assert_close(got, want, name=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), err_msg=name, **TOL)


@pytest.mark.parametrize("c,f", [(3, 64), (64, 128)])
def test_edgeconv_block(c, f):
    rng = np.random.default_rng(c)
    x = rng.normal(size=(2, 128, c)).astype(np.float32)
    jm = JBlock(f)
    variables = _init(jm, jnp.asarray(x), False)
    assert (variables["params"]["bn_scale"] < 0).any()
    want = _apply(jm, variables, jnp.asarray(x))
    got = port_module(EdgeConvBlock(c, f), variables)(t(x))
    _assert_close(got, want)


def test_edgeconv_block_negative_slope_takes_amin():
    """With every BN slope negative the block output is lrelu(BN(amin))."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(1, 128, 8)).astype(np.float32)
    jm = JBlock(16)
    variables = _init(jm, jnp.asarray(x), False)
    variables["params"]["bn_scale"] = -np.abs(variables["params"]["bn_scale"])
    want = _apply(jm, variables, jnp.asarray(x))
    got = port_module(EdgeConvBlock(8, 16), variables)(t(x))
    _assert_close(got, want)


def test_sa_node():
    pc = _cloud(1, n=256)
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(2, 256, 64)).astype(np.float32)
    jm = JSANode()
    variables = _init(jm, jnp.asarray(feats), jnp.asarray(pc), False)
    want = _apply(jm, variables, jnp.asarray(feats), jnp.asarray(pc))
    got = port_module(SelfAdaptiveNodeModule(64), variables)(t(feats), t(pc))
    for name, g, w in zip(("output_fea", "node_fea", "node_offset"), got, want):
        _assert_close(g, w, name)


def test_calayer():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 4096)).astype(np.float32)
    jm = JCALayer()
    variables = _init(jm, jnp.asarray(x), False)
    want = _apply(jm, variables, jnp.asarray(x))
    _assert_close(port_module(CALayer(), variables)(t(x)), want)


def test_classifier_head():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 1024)).astype(np.float32)
    jm = JHead(10, dgcnn=True)
    variables = _init(jm, jnp.asarray(x), False)
    want = _apply(jm, variables, jnp.asarray(x))
    got = port_module(ClassifierHead(10), variables)(t(x))
    for name, g, w in zip(("logits", "mid"), got, want):
        _assert_close(g, w, name)


def test_dgcnn_generator():
    pc = _cloud(6, n=128)
    jm = JGenerator()
    variables = _init(jm, jnp.asarray(pc), False)
    want = _apply(jm, variables, jnp.asarray(pc))
    got = port_module(DGCNNGenerator(), variables)(t(pc))
    for name, g, w in zip(("global_feat", "node_fea", "node_offset"), got, want):
        _assert_close(g, w, name)


def test_net_mda_init_is_flax_lecun_normal():
    """Dense kernels as flax's lecun_normal (variance 1/fan_in, truncated at
    two standard deviations), biases zero."""
    torch.manual_seed(0)
    model = NetMDA("DGCNN")
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.Linear):
            bound = 2.0 * m.in_features**-0.5 / 0.87962566103423978
            assert m.weight.abs().max() <= bound * (1 + 1e-6), name
            assert m.bias is None or not m.bias.any(), name
    std = model.attention_s.dense0.weight.std().item()  # 512 x 4096 draws
    np.testing.assert_allclose(std, 4096**-0.5, rtol=0.02)


def test_train_mode_raises():
    """The stacked both-domains forward runs in train mode (its numerics are
    in tests/test_torch_port_stacked.py): 2B clouds in, the attended node
    features of each half, 2B rows of the rest, the BNs back at one group
    after it. Stacked halves and per-replica BN groups together raise."""
    from sug_tpu_torch.models.bn import GroupedNorm, set_bn_groups

    model = NetMDA("DGCNN").train()
    gen = torch.Generator().manual_seed(0)
    out = model(torch.rand(4, 32, 3, generator=gen), domain="stacked", generator=gen)
    assert out["node_attn"].shape == out["node_attn_t"].shape == (2, 64 * 64)
    assert out["node_flat"].shape == (4, 64 * 64) and out["logits1"].shape == (4, 10)
    norms = [m for m in model.modules() if isinstance(m, GroupedNorm)]
    assert len(norms) > 4 and all(m.groups == 1 for m in norms)
    set_bn_groups(model, 2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        model(torch.zeros(4, 32, 3), domain="stacked", generator=gen)
    with pytest.raises(ValueError, match="domain"):
        model(torch.zeros(4, 32, 3), domain="stacked_both")
