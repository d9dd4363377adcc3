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

The kernels' own plain versions run here too: ``key_csr_plain`` (each
cloud's key lists, stable), ``first_hits_plain`` (dV and the first-hit
positions, query-major) and ``du_by_key_plain`` (dU, key-major, in list
order) together make the ``key-major`` port below, held to the same
references. ``du_by_key_plain`` must also equal, bit for bit, a numpy loop
that walks the entries (s, j) in order and adds into dU from 0 in f32: the
order of adds the CUDA kernels repeat.

The CUDA kernels cannot run here; ``chip_smoke.py`` holds each against its
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


def _port_key_major(q, kv, u, v, cot, k):
    """The three plain versions of the kernels in turn on the outputs of the
    port's forward."""
    tq, tkv, tu, tv = (torch.from_numpy(a) for a in (q, kv, u, v))
    amax, amin, _, _, idx = te.edgeconv_reduce(tq, tkv, tu, tv, k)
    du, dv = te.edgeconv_reduce_bwd_stages_plain(idx, tu, tv, amax, amin,
                                                 *(torch.from_numpy(w) for w in cot))[:2]
    return du.numpy(), dv.numpy()


PORTS = [_port_plain, _port_autograd, _port_key_major]
PORT_IDS = ["plain", "autograd", "key-major"]


@pytest.mark.parametrize("port", PORTS, ids=PORT_IDS)
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


@pytest.mark.parametrize("port", PORTS, ids=PORT_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_backward_matches_pallas_interpret(shape, port):
    b, s, n, c, f, k, cross = shape
    q, kv, u, v, cot = _inputs(1, b, s, n, c, f, cross)
    for name, g, w in zip(("du", "dv"), port(q, kv, u, v, cot, k), _pallas_grads(shape, 1)):
        _assert_close(g, w, name)


@functools.lru_cache(maxsize=None)
def _tie_case(cross):
    """Inputs on which ``a`` ties exactly, and the Pallas kernel's grads."""
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
    return (q, kv, u, v, cot, k), _jax_grads(_pallas(cross), q, kv, u, v, cot, k)


@pytest.mark.parametrize("port", [_port_plain, _port_key_major], ids=["plain", "key-major"])
@pytest.mark.parametrize("cross", [False, True], ids=["self", "sa-node"])
def test_first_hit_routing_on_exact_ties(cross, port):
    """Points 64 and 65 duplicate point 0, values included, and u, v and the
    cotangents are small integers: the replayed ``a`` ties exactly on many
    channels, every sum is exact, and the max/min cotangents must go to the
    first tied neighbour in idx order, as in the Pallas kernel."""
    (q, kv, u, v, cot, k), want = _tie_case(cross)
    tq, tkv, tu, tv = (torch.from_numpy(a) for a in (q, kv, u, v))
    amax, _, _, _, idx = te.edgeconv_reduce(tq, tkv, tu, tv, k)
    a = te.index_points(tu, idx) + tv[:, :, None, :]
    ties = ((a == amax[:, :, None, :]).sum(2) > 1).sum().item()
    assert ties > 100, ties  # the routing rule is exercised
    for name, g, w in zip(("du", "dv"), port(q, kv, u, v, cot, k), want):
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
    # the kernels' own limits, checked before a launch on the card: the
    # forward's k (20, 64) and N up to the FPS kernel's 16384 pass
    te.check_bwd_kernel_limits(64, 4096, 16384, 256, 64)
    for bad in ((64, 64, 1024, 64, 256), (2, 64, te.MAX_BWD_KEYS + 1, 64, 20),
                (65536, 64, 1024, 64, 20)):
        with pytest.raises(ValueError, match=r"B=\d+, S=64, N=\d+, F=64, k=\d+"):
            te.check_bwd_kernel_limits(*bad)


def _hub_idx(b, s, n, k, seed):
    """A seeded (b, s, k) idx of distinct keys per row, with key 1 in every
    row (a hub, as a zero-padded cloud makes) and key n-1 in none."""
    rng = np.random.default_rng(seed)
    idx = np.stack([np.stack([np.concatenate([[1], rng.choice(np.r_[0, 2:n - 1], k - 1,
                                                               replace=False)])
                              for _ in range(s)]) for _ in range(b)])
    return torch.from_numpy(idx.astype(np.int32))


@pytest.mark.parametrize("shape", [(2, 48, 40, 20), (1, 16, 96, 64), (3, 30, 30, 29)],
                         ids=["self-k20", "cross-k64", "dense"])
def test_key_csr_plain_is_stable_and_complete(shape):
    """Every entry once, in its key's list, each list ascending in e; the
    offsets start at 0, end at S*k and count an empty key as empty."""
    b, s, n, k = shape
    idx = _hub_idx(b, s, n, k, 5)
    offsets, edges = te.key_csr_plain(idx, n)
    assert offsets.dtype == edges.dtype == torch.int32
    assert offsets.shape == (b, n + 1) and edges.shape == (b, s * k)
    assert (offsets[:, 0] == 0).all() and (offsets[:, -1] == s * k).all()
    flat = idx.reshape(b, -1)
    for c in range(b):
        assert sorted(edges[c].tolist()) == list(range(s * k))  # every entry once
        for key in range(n):
            lst = edges[c, offsets[c, key]:offsets[c, key + 1]].long()
            assert (flat[c, lst] == key).all()
            assert (lst[1:] > lst[:-1]).all()  # ascending e
        assert offsets[c, 2] - offsets[c, 1] == s  # the hub: every row
        assert offsets[c, n] == offsets[c, n - 1]  # the empty key


def _ordered_loop(idx, u, v, amax, amin, damax, damin, ds1, ds2):
    """dU and dV by walking (s, j) in order in numpy f32, first hits as the
    kernels find them, each sum from 0."""
    idx, u, v, amax, amin, damax, damin, ds1, ds2 = (
        t.numpy() for t in (idx, u, v, amax, amin, damax, damin, ds1, ds2))
    du, dv = np.zeros_like(u), np.zeros_like(v)
    zero = np.float32(0)
    for b in range(idx.shape[0]):
        for s in range(idx.shape[1]):
            hit_max = np.zeros(u.shape[-1], bool)
            hit_min = np.zeros(u.shape[-1], bool)
            for j, n in enumerate(idx[b, s]):
                a = u[b, n] + v[b, s]
                sel_max = ~hit_max & (a == amax[b, s])
                sel_min = ~hit_min & (a == amin[b, s])
                hit_max |= sel_max
                hit_min |= sel_min
                da = (((np.where(sel_max, damax[b, s], zero) + np.where(sel_min, damin[b, s], zero))
                       + ds1[b, s]) + (np.float32(2) * a) * ds2[b, s])
                du[b, n] += da
                dv[b, s] += da
    return du, dv


@pytest.mark.parametrize("case", ["self", "sa-node", "zero-padded", "exact-ties"])
def test_key_major_sums_in_the_kernels_order(case):
    """``du_by_key_plain`` and ``first_hits_plain``'s dv equal the ordered
    numpy loop bit for bit, on random inputs, on a zero-padded cloud (hub
    keys with some 100 entries) and on exact ties; and both agree with the
    plain scatter-add backward to the module's tolerance."""
    rng = np.random.default_rng(6)
    b, s, n, c, f, k = (1, 64, 128, 3, 16, 64) if case == "sa-node" else (2, 128, 128, 3, 16, 20)
    kv = rng.normal(size=(b, n, c)).astype(np.float32)
    if case == "zero-padded":
        kv[:, 24:] = 0.0
    u = rng.normal(size=(b, n, f)).astype(np.float32)
    v = rng.normal(size=(b, s, f)).astype(np.float32)
    if case == "exact-ties":
        u = rng.integers(-2, 3, size=u.shape).astype(np.float32)
        v = rng.integers(-2, 3, size=v.shape).astype(np.float32)
    q = (kv[:, :s] + 0.05 * rng.normal(size=(b, s, c))).astype(np.float32) if case == "sa-node" \
        else kv
    cot = [torch.from_numpy(rng.normal(size=(b, s, f)).astype(np.float32)) for _ in range(4)]
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    amax, amin, _, _, idx = te.edgeconv_reduce(torch.from_numpy(q), torch.from_numpy(kv), tu, tv, k)
    args = (idx, tu, tv, amax, amin, *cot)
    du, dv, offsets, _, jmax, _ = te.edgeconv_reduce_bwd_stages_plain(*args)
    want_du, want_dv = _ordered_loop(*args)
    assert np.array_equal(du.numpy(), want_du)
    assert np.array_equal(dv.numpy(), want_dv)
    longest = (offsets[:, 1:] - offsets[:, :-1]).max().item()
    if case == "zero-padded":
        assert longest >= 100, longest  # hub keys
    if case == "exact-ties":
        assert (jmax.long() > 0).any()  # a first hit past j=0
    plain_du, plain_dv = te.edgeconv_reduce_bwd_plain(*args)
    _assert_close(du.numpy(), plain_du.numpy(), "du")
    _assert_close(dv.numpy(), plain_dv.numpy(), "dv")
