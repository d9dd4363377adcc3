"""The port's EdgeConv backward (``edgeconv_reduce_bwd`` and the autograd
Function ``EdgeConvReduce``) on the CPU, where both run the plain PyTorch
version, against the JAX package: ``jax.grad`` through the Pallas kernel's
custom VJP in interpret mode (N a multiple of 128, as
``tests/test_edgeconv_fused.py`` runs it) and through the plain reference
``edgeconv_reduce_reference``.

The cotangents of all four outputs are random. Tolerance on random inputs:
1e-5 relative, and 1e-5 of the largest |value| absolute: dU and dV are sums
of up to a few hundred f32 terms of both signs taken in different orders,
so their rounding scales with the terms, not with a sum that cancels.
JAX's ``jnp.max`` gradient splits exact ties evenly, so the reference is
compared on tie-free inputs only; on duplicate
points with integer values, where ``a`` ties exactly and every sum is exact,
the first-hit routing must match the Pallas kernel to 1e-6.

The CUDA kernel cannot run here; ``chip_smoke.py`` holds it against the
plain version on the card.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sug_tpu.ops.edgeconv_pallas import (
    edgeconv_reduce_reference,
    fused_cross_edgeconv_reduce as pallas_cross,
    fused_edgeconv_reduce as pallas_self,
)
from sug_tpu.ops.geometry import index_points, square_distance
from sug_tpu_torch.ops import edgeconv as te

RTOL = 1e-5


def _assert_close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * max(1.0, np.abs(want).max()),
                               err_msg=name)


# (b, s, n, c, f, k, cross): EdgeConv-block-like self-kNN at k=20, and the
# SA-node's S=64 queries with k=64
SHAPES = [
    (2, 128, 128, 3, 32, 20, False),
    (1, 128, 128, 16, 40, 20, False),
    (1, 64, 128, 3, 32, 64, True),
]
IDS = ["self-c3", "self-c16-ragged-f", "sa-node"]


def _inputs(seed, b, s, n, c, f, cross):
    rng = np.random.default_rng(seed)
    kv = rng.normal(size=(b, n, c)).astype(np.float32)
    q = rng.normal(size=(b, s, c)).astype(np.float32) if cross else kv
    u = rng.normal(size=(b, n, f)).astype(np.float32)
    v = rng.normal(size=(b, s, f)).astype(np.float32)
    cot = [rng.normal(size=(b, s, f)).astype(np.float32) for _ in range(4)]
    return q, kv, u, v, cot


@functools.lru_cache(maxsize=None)
def _reference_grads(shape, seed):
    """JAX's grads through the plain reference, once per shape."""
    b, s, n, c, f, k, cross = shape
    q, kv, u, v, cot = _inputs(seed, b, s, n, c, f, cross)
    fn = _reference if cross else (
        lambda q_, kv_, u_, v_, k_: edgeconv_reduce_reference(kv_, u_, v_, k_)[:4])
    return _jax_grads(fn, q, kv, u, v, cot, k)


def _jax_grads(fn, q, kv, u, v, cot, k):
    """(du, dv) of sum(outputs * cotangents) through ``fn``."""

    def loss(u_, v_):
        outs = fn(jnp.asarray(q), jnp.asarray(kv), u_, v_, k)
        return sum(jnp.sum(o * jnp.asarray(w)) for o, w in zip(outs[:4], cot))

    du, dv = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(u), jnp.asarray(v))
    return np.asarray(du), np.asarray(dv)


def _reference(q, kv, u, v, k):
    d = square_distance(q, kv)
    _, idx = jax.lax.top_k(-d, k)
    a = index_points(u, idx) + v[:, :, None, :]
    return jnp.max(a, 2), jnp.min(a, 2), jnp.sum(a, 2), jnp.sum(a * a, 2)


def _pallas(cross):
    if cross:
        return lambda q, kv, u, v, k: pallas_cross(q, kv, u, v, k, interpret=True)
    return lambda q, kv, u, v, k: pallas_self(kv, u, v, k, True)


def _port_plain(q, kv, u, v, cot, k):
    """The plain backward on the outputs of the port's forward."""
    tq, tkv, tu, tv = (torch.from_numpy(a) for a in (q, kv, u, v))
    amax, amin, _, _, idx = te.edgeconv_reduce(tq, tkv, tu, tv, k)
    du, dv = te.edgeconv_reduce_bwd(idx, tu, tv, amax, amin, *(torch.from_numpy(w) for w in cot))
    return du.numpy(), dv.numpy()


def _port_autograd(q, kv, u, v, cot, k):
    """``torch.autograd.grad`` through ``EdgeConvReduce``."""
    tu = torch.from_numpy(u).requires_grad_()
    tv = torch.from_numpy(v).requires_grad_()
    outs = te.EdgeConvReduce.apply(torch.from_numpy(q), torch.from_numpy(kv), tu, tv, k)
    loss = sum(torch.sum(o * torch.from_numpy(w)) for o, w in zip(outs[:4], cot))
    du, dv = torch.autograd.grad(loss, (tu, tv))
    return du.numpy(), dv.numpy()


@pytest.mark.parametrize("port", [_port_plain, _port_autograd], ids=["plain", "autograd"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_backward_matches_reference_grad(shape, port):
    b, s, n, c, f, k, cross = shape
    q, kv, u, v, cot = _inputs(0, b, s, n, c, f, cross)
    for name, g, w in zip(("du", "dv"), port(q, kv, u, v, cot, k), _reference_grads(shape, 0)):
        _assert_close(g, w, name)


@functools.lru_cache(maxsize=None)
def _pallas_grads(shape, seed):
    """JAX's grads through the Pallas kernel in interpret mode, once per shape."""
    b, s, n, c, f, k, cross = shape
    q, kv, u, v, cot = _inputs(seed, b, s, n, c, f, cross)
    return _jax_grads(_pallas(cross), q, kv, u, v, cot, k)


@pytest.mark.parametrize("port", [_port_plain, _port_autograd], ids=["plain", "autograd"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_backward_matches_pallas_interpret(shape, port):
    b, s, n, c, f, k, cross = shape
    q, kv, u, v, cot = _inputs(1, b, s, n, c, f, cross)
    for name, g, w in zip(("du", "dv"), port(q, kv, u, v, cot, k), _pallas_grads(shape, 1)):
        _assert_close(g, w, name)


@pytest.mark.parametrize("cross", [False, True], ids=["self", "sa-node"])
def test_first_hit_routing_on_exact_ties(cross):
    """Points 64 and 65 duplicate point 0, values included, and u, v and the
    cotangents are small integers: the replayed ``a`` ties exactly on many
    channels, every sum is exact, and the max/min cotangents must go to the
    first tied neighbour in idx order, as in the Pallas kernel."""
    b, s, n, c, f, k = (1, 64, 128, 3, 16, 64) if cross else (1, 128, 128, 3, 16, 20)
    rng = np.random.default_rng(2)
    kv = rng.normal(size=(b, n, c)).astype(np.float32)
    u = rng.integers(-3, 4, size=(b, n, f)).astype(np.float32)
    for dup in (64, 65):
        kv[:, dup] = kv[:, 0]
        u[:, dup] = u[:, 0]
    q = (kv[:, :s] + 0.01 * rng.normal(size=(b, s, c))).astype(np.float32) if cross else kv
    v = (np.zeros((b, s, f)) if cross else rng.integers(-3, 4, size=(b, s, f))).astype(np.float32)
    cot = [rng.integers(-4, 5, size=(b, s, f)).astype(np.float32) / 2 for _ in range(4)]

    tq, tkv, tu, tv = (torch.from_numpy(a) for a in (q, kv, u, v))
    amax, _, _, _, idx = te.edgeconv_reduce(tq, tkv, tu, tv, k)
    a = te.index_points(tu, idx) + tv[:, :, None, :]
    ties = ((a == amax[:, :, None, :]).sum(2) > 1).sum().item()
    assert ties > 100, ties  # the routing rule is exercised
    want = _jax_grads(_pallas(cross), q, kv, u, v, cot, k)
    for name, g, w in zip(("du", "dv"), _port_plain(q, kv, u, v, cot, k), want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=name)


def test_unused_outputs_get_zero_cotangents():
    """Only amax feeds the loss (the SA-node's use): autograd materialises
    zeros for the other three cotangents, and q/kv get no gradient."""
    q, kv, u, v, _ = _inputs(3, 1, 16, 64, 3, 8, cross=True)
    tq = torch.from_numpy(q).requires_grad_()
    tu = torch.from_numpy(u).requires_grad_()
    amax, amin, s1, s2, idx = te.fused_cross_edgeconv_reduce(tq, torch.from_numpy(kv), tu,
                                                             torch.from_numpy(v), 4)
    assert not idx.requires_grad
    gq, gu = torch.autograd.grad(amax.sum(), (tq, tu), allow_unused=True)
    assert gq is None
    zeros = torch.zeros_like(amax)
    want, _ = te.edgeconv_reduce_bwd_plain(idx, tu.detach(), torch.from_numpy(v), amax.detach(),
                                           amin.detach(), torch.ones_like(amax), zeros, zeros, zeros)
    assert torch.equal(gu, want)
    assert gu.sum().item() == amax.numel()  # one unit per query and channel


def test_backward_wrapper_validates_and_does_not_count_cpu_launches():
    q, kv, u, v, cot = _inputs(4, 1, 8, 16, 3, 4, cross=True)
    tq, tkv, tu, tv = (torch.from_numpy(a) for a in (q, kv, u, v))
    amax, amin, _, _, idx = te.edgeconv_reduce(tq, tkv, tu, tv, 4)
    args = [idx, tu, tv, amax, amin, *(torch.from_numpy(w) for w in cot)]
    before = te.edgeconv_reduce_bwd.launches
    te.edgeconv_reduce_bwd(*args)
    assert te.edgeconv_reduce_bwd.launches == before
    with pytest.raises(ValueError, match="int32"):
        te.edgeconv_reduce_bwd(idx.long(), *args[1:])
    with pytest.raises(TypeError, match="float32"):
        te.edgeconv_reduce_bwd(*args[:5], args[5].double(), *args[6:])
    with pytest.raises(ValueError, match="contiguous"):
        te.edgeconv_reduce_bwd(*args[:2], tv.transpose(1, 2).contiguous().transpose(1, 2), *args[3:])
    with pytest.raises(ValueError, match=r"\(B,S,F\)"):
        te.edgeconv_reduce_bwd(*args[:8], args[8][:, :4])
    with pytest.raises(ValueError, match="no path for device"):
        te.edgeconv_reduce_bwd(*(a.to("meta") for a in args))
