"""The port's EdgeConv op (sug_tpu_torch/ops/edgeconv.py) on the CPU, where
the wrapper runs its plain PyTorch version, against the JAX package: its
plain reference ``edgeconv_reduce_reference`` and the Pallas kernel itself
in interpret mode (N a multiple of 128 there).

Neighbour indices must agree exactly against the plain reference, which
uses the same distance formula; exact ties (duplicate points) go to the
lowest index on both sides. Against the Pallas kernel the neighbour *sets*
must agree: it ranks by ``2 q.kv - |kv|^2`` from a three-pass bf16 dot, so
two near-equal distances may come out in the other order within the k list
(as ``tests/test_edgeconv_fused.py`` compares them too). Values to 1e-5
abs + 1e-5 rel: max/min pick the same f32 values, and the sums differ only
in the order of at most 64 f32 terms.

The CUDA kernel cannot run here; ``chip_smoke.py`` holds it against the
plain version on the card.
"""

from __future__ import annotations

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

TOL = dict(rtol=1e-5, atol=1e-5)
NAMES = ("amax", "amin", "s1", "s2")


def _inputs(seed, b, s, n, c, f, cross, dup=False):
    rng = np.random.default_rng(seed)
    kv = rng.normal(size=(b, n, c)).astype(np.float32)
    if dup:
        kv[:, 64] = kv[:, 0]
        kv[:, 65] = kv[:, 0]
    q = rng.normal(size=(b, s, c)).astype(np.float32) if cross else kv
    u = rng.normal(size=(b, n, f)).astype(np.float32)
    v = rng.normal(size=(b, s, f)).astype(np.float32)
    return q, kv, u, v


def _jax_cross_reference(q, kv, u, v, k):
    d = square_distance(q, kv)
    _, idx = jax.lax.top_k(-d, k)
    a = index_points(u, idx) + v[:, :, None, :]
    return jnp.max(a, 2), jnp.min(a, 2), jnp.sum(a, 2), jnp.sum(a * a, 2), idx


def _port(q, kv, u, v, k, cross):
    tq, tkv, tu, tv = (torch.from_numpy(a) for a in (q, kv, u, v))
    if cross:
        return te.fused_cross_edgeconv_reduce(tq, tkv, tu, tv, k)
    return te.fused_edgeconv_reduce(tkv, tu, tv, k)


def _compare(got, want, ordered=True):
    for name, g, w in zip(NAMES, got[:4], want[:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
    assert got[4].dtype == torch.int32
    g_idx, w_idx = got[4].numpy(), np.asarray(want[4])
    if not ordered:
        g_idx, w_idx = np.sort(g_idx, -1), np.sort(w_idx, -1)
    np.testing.assert_array_equal(g_idx, w_idx)


# (b, s, n, c, f, k, cross): block-1/-2-like self-kNN, and the SA-node's
# S=64 queries with k=64
SHAPES = [
    (2, 128, 128, 3, 64, 20, False),
    (2, 256, 256, 16, 32, 20, False),
    (2, 64, 256, 3, 64, 64, True),
]
IDS = ["self-c3", "self-c16", "sa-node"]


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plain_matches_reference(shape):
    b, s, n, c, f, k, cross = shape
    q, kv, u, v = _inputs(0, b, s, n, c, f, cross)
    if cross:
        want = _jax_cross_reference(*map(jnp.asarray, (q, kv, u, v)), k)
    else:
        want = edgeconv_reduce_reference(*map(jnp.asarray, (kv, u, v)), k)
    _compare(_port(q, kv, u, v, k, cross), want)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plain_matches_pallas_interpret(shape):
    b, s, n, c, f, k, cross = shape
    q, kv, u, v = _inputs(1, b, s, n, c, f, cross)
    if cross:
        want = pallas_cross(*map(jnp.asarray, (q, kv, u, v)), k, interpret=True)
    else:
        want = pallas_self(*map(jnp.asarray, (kv, u, v)), k, True)
    _compare(_port(q, kv, u, v, k, cross), want, ordered=False)


def test_duplicate_points_tie_break():
    """Exact duplicates tie; the lowest index wins, as in the Pallas kernel
    (tests/test_edgeconv_fused.py's tie case)."""
    q, kv, u, v = _inputs(2, 1, 128, 128, 4, 16, cross=False, dup=True)
    got = _port(q, kv, u, v, 4, cross=False)
    want_ref = edgeconv_reduce_reference(*map(jnp.asarray, (kv, u, v)), 4)
    want_pallas = pallas_self(*map(jnp.asarray, (kv, u, v)), 4, True)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want_ref[4]))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want_pallas[4]))
    np.testing.assert_array_equal(got[4].numpy()[0, 0, :3], [0, 64, 65])


def test_wrapper_validates_before_dispatch():
    q, kv, u, v = (torch.from_numpy(a) for a in _inputs(3, 1, 8, 16, 3, 4, cross=True))
    with pytest.raises(TypeError, match="float32"):
        te.edgeconv_reduce(q.double(), kv, u, v, 4)
    with pytest.raises(ValueError, match="contiguous"):
        te.edgeconv_reduce(q, kv, u.transpose(1, 2).contiguous().transpose(1, 2), v, 4)
    with pytest.raises(ValueError, match="shapes"):
        te.edgeconv_reduce(q, kv, u, v[:, :4], 4)
    with pytest.raises(ValueError, match="k <= N"):
        te.edgeconv_reduce(q, kv, u, v, 17)
    with pytest.raises(ValueError, match="no path for device"):
        te.edgeconv_reduce(*(a.to("meta") for a in (q, kv, u, v)), 4)


def test_cpu_path_does_not_count_launches():
    before = te.edgeconv_reduce.launches
    q, kv, u, v = _inputs(4, 1, 16, 32, 3, 8, cross=True)
    _port(q, kv, u, v, 4, cross=True)
    assert te.edgeconv_reduce.launches == before
