"""The port's PTran modules (sug_tpu_torch/models/ptran.py, the PTran heads
and ``NetMDA("PTran")``) against flax ``apply`` with the same (bridged)
weights, in eval mode on the CPU. The JAX side runs its XLA path (the
default on the CPU: f32 throughout, the per-edge tensors materialised); the
port runs the plain version of its vector-attention op. BN running stats are
randomised and about a third of the BN scales are negative.

Tolerance 1e-4 abs + 1e-4 rel: the two libraries order f32 sums differently
in every matmul and reduction (D=512 products per edge), and the
differences pass through five attention levels, four TransitionDowns and
the heads.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sug_tpu.models.heads import ClassifierHead as JHead
from sug_tpu.models.net_mda import NetMDA as JNetMDA
from sug_tpu.models.ptran import TransitionDown as JTransitionDown
from sug_tpu.models.ptran import VectorAttentionBlock as JBlock
from sug_tpu_torch.models.heads import ClassifierHead
from sug_tpu_torch.models.net_mda import NetMDA
from sug_tpu_torch.models.ptran import TransitionDown, VectorAttentionBlock
from tests._torch_port_common import port_module, randomize_variables, t
from tests._torch_port_common import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)
OUTPUTS = ("logits1", "logits2", "sem1", "sem2", "global_feat", "node_flat", "node_attn",
           "node_attn_t")


def _cloud(seed, b, n):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, size=(b, n, 3)).astype(np.float32)


def _init(module, *args):
    variables = jax.jit(lambda: module.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, *args
    ))()
    return randomize_variables(variables, seed=3)


def _close(got, want, name=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), err_msg=name, **TOL)


def test_vector_attention_block_d512():
    xyz = _cloud(0, 2, 128)
    feats = np.random.default_rng(1).normal(size=(2, 128, 32)).astype(np.float32)
    jm = JBlock(32, 512, 16)
    variables = _init(jm, jnp.asarray(xyz), jnp.asarray(feats))
    want = jax.jit(jm.apply)(variables, jnp.asarray(xyz), jnp.asarray(feats))
    with torch.no_grad():
        got = port_module(VectorAttentionBlock(32, 512, 16), variables)(t(xyz), t(feats))
    _close(got, want)


def test_transition_down_eval():
    xyz = _cloud(2, 2, 128)
    feats = np.random.default_rng(3).normal(size=(2, 128, 32)).astype(np.float32)
    jm = JTransitionDown(32, 16, (64, 64))
    variables = _init(jm, jnp.asarray(xyz), jnp.asarray(feats), False)
    assert (variables["params"]["mlp0"]["BatchNorm_0"]["scale"] < 0).any()
    want = jax.jit(lambda v, x, f: jm.apply(v, x, f, False))(
        variables, jnp.asarray(xyz), jnp.asarray(feats))
    got = port_module(TransitionDown(16, 32, (64, 64)), variables)(t(xyz), t(feats), 32)
    for name, g, w in zip(("new_xyz", "features"), got, want):
        _close(g, w, name)


@pytest.mark.parametrize("variant,flags,width",
                         [("relu", {}, 1024), ("ptran", {"ptran": True}, 512)])
def test_classifier_head_variants(variant, flags, width):
    x = np.random.default_rng(5).normal(size=(3, width)).astype(np.float32)
    jm = JHead(10, **flags)
    variables = _init(jm, jnp.asarray(x), False)
    want = jax.jit(lambda v, a: jm.apply(v, a, False))(variables, jnp.asarray(x))
    head = port_module(ClassifierHead(10, variant), variables)
    assert (head.mlp1 is None) == (variant == "ptran")
    for name, g, w in zip(("logits", "mid"), head(t(x)), want):
        _close(g, w, name)


def test_net_mda_ptran_forward_n1024():
    """The whole eval forward at PTran's full size per cloud: N=1024, five
    attention levels (N = 1024, 256, 64, 16, 4), the real (64, 64)
    ``point_mix``."""
    pc = _cloud(6, 2, 1024)
    jm = JNetMDA(model_name="PTran", num_class=10)
    variables = _init(jm, jnp.asarray(pc), False, "both")
    assert variables["params"]["g"]["point_mix"]["kernel"].shape == (64, 64)
    want = jax.jit(lambda v, p: jm.apply(v, p, False, domain="both"))(variables, jnp.asarray(pc))
    model = port_module(NetMDA("PTran"), variables)
    with torch.no_grad():
        got = model(t(pc), domain="both")
    assert set(got) == set(want) and got["node_offset"] is None and want["node_offset"] is None
    assert got["global_feat"].shape == (2, 512) and got["node_flat"].shape == (2, 64 * 64)
    for name in OUTPUTS:
        _close(got[name], want[name], name)


def test_generator_checks_the_cloud_size():
    model = NetMDA("PTran", num_points=128).eval()
    with pytest.raises(ValueError, match="built for 128 points"):
        model(torch.zeros(1, 256, 3))
