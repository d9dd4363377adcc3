"""Geometry ops of the port (sug_tpu_torch/ops/geometry.py) against
sug_tpu/ops/geometry.py on the CPU. Indices must agree exactly (both break
distance ties by the lowest index); values to 1e-5, the f32 rounding of
two libraries' reductions over at most a few hundred terms."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sug_tpu.ops import geometry as jg
from sug_tpu_torch.ops import geometry as tg

TOL = dict(rtol=1e-5, atol=1e-5)


def _cloud(seed, b=2, n=128, c=3, dup=False):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, size=(b, n, c)).astype(np.float32)
    if dup:  # exact duplicates create distance ties
        x[:, 10] = x[:, 3]
        x[:, 77] = x[:, 3]
        x[:, 40] = x[:, 41]
    return x


def test_square_distance():
    a, b = _cloud(0, n=96), _cloud(1, n=128)
    want = np.asarray(jg.square_distance(jnp.asarray(a), jnp.asarray(b)))
    got = tg.square_distance(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("dup", [False, True], ids=["random", "duplicates"])
@pytest.mark.parametrize("c", [3, 16])
def test_knn_indices(dup, c):
    x = _cloud(2, c=c, dup=dup)
    want = np.asarray(jg.knn_indices(jnp.asarray(x), 20))
    got = tg.knn_indices(torch.from_numpy(x), 20).numpy()
    np.testing.assert_array_equal(got, want)


def test_knn_duplicates_take_lowest_index():
    x = _cloud(3, dup=True)
    got = tg.knn_indices(torch.from_numpy(x), 3).numpy()
    # point 3 has twins 10 and 77 at distance 0: all three list 3, 10, 77
    for p in (3, 10, 77):
        np.testing.assert_array_equal(got[:, p], np.tile([3, 10, 77], (2, 1)))


def test_index_points():
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(2, 50, 5)).astype(np.float32)
    for shape in [(2, 7), (2, 7, 4)]:
        idx = rng.integers(0, 50, size=shape).astype(np.int32)
        want = np.asarray(jg.index_points(jnp.asarray(pts), jnp.asarray(idx)))
        got = tg.index_points(torch.from_numpy(pts), torch.from_numpy(idx).long()).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dup", [False, True], ids=["random", "duplicates"])
def test_farthest_point_sample(dup):
    x = _cloud(5, n=256, dup=dup)
    want = np.asarray(jg.farthest_point_sample(jnp.asarray(x), 64))
    got = tg.farthest_point_sample(torch.from_numpy(x), 64).numpy()
    np.testing.assert_array_equal(got, want)


def test_farthest_point_sample_first_max_on_ties():
    # a symmetric cloud: after the first centroid every later argmax has ties
    x = np.zeros((1, 8, 3), np.float32)
    x[0, :, 0] = [0, 1, -1, 1, -1, 2, -2, 2]
    want = np.asarray(jg.farthest_point_sample(jnp.asarray(x), 5))
    got = tg.farthest_point_sample(torch.from_numpy(x), 5).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("radius", [0.3, None], ids=["r0.3", "knn"])
def test_query_ball_point(radius):
    x = _cloud(6, n=256, dup=True)
    q = x[:, ::8] + np.float32(0.01)
    want = np.asarray(jg.query_ball_point(radius, 64, jnp.asarray(x), jnp.asarray(q)))
    got = tg.query_ball_point(radius, 64, torch.from_numpy(x), torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, want)


def test_query_ball_point_pads_with_first_and_empty_ball():
    x = _cloud(7, n=128)
    q = np.concatenate([x[:, :4], np.full((2, 1, 3), 50.0, np.float32)], axis=1)
    want = np.asarray(jg.query_ball_point(0.3, 64, jnp.asarray(x), jnp.asarray(q)))
    got = tg.query_ball_point(0.3, 64, torch.from_numpy(x), torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, -1] == 127).all()  # empty ball: clamped sentinel


def test_three_nn_interpolate():
    rng = np.random.default_rng(8)
    dense = _cloud(9, n=128)
    coarse = dense[:, :32] + rng.normal(0, 0.05, (2, 32, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 32, 16)).astype(np.float32)
    want = np.asarray(jg.three_nn_interpolate(*map(jnp.asarray, (dense, coarse, feats))))
    got = tg.three_nn_interpolate(*map(torch.from_numpy, (dense, coarse, feats))).numpy()
    np.testing.assert_allclose(got, want, **TOL)
