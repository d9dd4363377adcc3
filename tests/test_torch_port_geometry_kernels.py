"""The large-N geometry of the port (``sug_tpu_torch/ops/geometry_kernels.py``
and the routing and ``knn_blockwise`` of ``ops/geometry.py``) against
``sug_tpu/ops/pallas_kernels.py`` and ``sug_tpu/ops/geometry.py`` on the CPU.
The Pallas kernels run in interpret mode, as the JAX package's own tests run
them; the port's wrappers run their plain versions. The CUDA kernels are held
against those plain versions on the card by ``chip_smoke.py``.

Tolerances. Min-dists and chamfer values to 1e-5 relative to
``max(|q|² + |s|², 1)``: the expanded ``-2·q·s + |q|² + |s|²`` cancels, so
the rounding of a min scales with the squared norms, not with the min, and
the Pallas kernel adds its terms in another order (``q_sq - 2·cross +
s_sq``) from a (8, TQ) x (8, TS) dot. FPS and kNN indices exactly, index for
index: both sides break ties by the lowest index and add the same f32 terms
in the same order.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sug_tpu.ops import geometry as jg
from sug_tpu.ops import pallas_kernels as jpk
from sug_tpu_torch.ops import edgeconv as te
from sug_tpu_torch.ops import geometry as tg
from sug_tpu_torch.ops import geometry_kernels as gk

REL = 1e-5


def _clouds(seed, b, n, pad_to=None):
    """Clouds in the unit ball; ``pad_to`` zero-pads them as
    ``fit_num_points`` does, which makes thousands of exact ties."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1).max(axis=1)[:, None, None]
    if pad_to is not None:
        x = np.concatenate([x, np.zeros((b, pad_to - n, 3), np.float32)], axis=1)
    return x


def _assert_min_dists(got, want, q, s):
    """|got - want| within REL of max(|q|² + max_m |s|², 1), row by row."""
    scale = np.maximum((q**2).sum(-1) + (s**2).sum(-1).max(1)[:, None], 1.0)
    err = np.abs(np.asarray(got) - np.asarray(want)) / scale
    assert err.max() <= REL, err.max()


def test_min_dists_plain_against_pallas_tiles():
    """At tile multiples (the Pallas kernel's grid covers every point)."""
    q, s = _clouds(0, 2, 256), _clouds(1, 2, 512)
    want = jpk._min_dists_tiled(jnp.asarray(q), jnp.asarray(s), 128, 128)
    got = gk.min_dists_plain(torch.from_numpy(q), torch.from_numpy(s)).numpy()
    _assert_min_dists(got, want, q, s)
    # the wrapper on CPU tensors is the plain version, bit for bit
    assert np.array_equal(gk.min_dists(torch.from_numpy(q), torch.from_numpy(s)).numpy(), got)


@pytest.mark.parametrize("pad", [False, True], ids=["random", "zero_padded"])
def test_chamfer_4096_against_chamfer_pallas(pad):
    pc1 = _clouds(2, 2, 2048 if pad else 4096, pad_to=4096 if pad else None)
    pc2 = _clouds(3, 2, 4096)
    want = np.asarray(jpk.chamfer_pallas(jnp.asarray(pc1), jnp.asarray(pc2)))
    got = tg.chamfer_distance(torch.from_numpy(pc1), torch.from_numpy(pc2)).numpy()
    # a chamfer is a mean of mins, each within REL of max(|q|² + |s|², 1) <= 2
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * 2 * REL)
    scalar = tg.chamfer_distance(torch.from_numpy(pc1), torch.from_numpy(pc2), per_sample=False)
    np.testing.assert_allclose(scalar.item(), got.mean(), rtol=1e-6)


@pytest.mark.parametrize("n,m", [(2100, 2300), (2300, 2100)])
def test_chamfer_ragged_against_plain(n, m):
    """Above 2048 points at sizes no tile divides: the port's tiled chamfer
    against the JAX package's plain chamfer. ``chamfer_pallas`` drops the
    ragged tails there (ROADMAP.md §3), so it is not the reference."""
    pc1, pc2 = _clouds(4, 2, n), _clouds(5, 2, m)
    assert tg.chamfer_is_tiled(n, m)
    want = np.asarray(jg.chamfer_distance(jnp.asarray(pc1), jnp.asarray(pc2)))
    got = tg.chamfer_distance(torch.from_numpy(pc1), torch.from_numpy(pc2)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * 2 * REL)
    d1 = gk.min_dists(torch.from_numpy(pc1), torch.from_numpy(pc2)).numpy()
    assert d1.shape == (2, n)
    _assert_min_dists(d1, jnp.min(jg.square_distance(jnp.asarray(pc1), jnp.asarray(pc2)), 2),
                      pc1, pc2)


def test_pallas_min_dists_drops_the_ragged_tails():
    """The reproduction of a fault of the JAX package (ROADMAP.md §3): at
    N = M = 300 with tiles of 128, ``_min_dists_tiled`` never writes rows
    256-299 and never searches sources 256-299. The port's plain version,
    the contract of its kernel, is right there."""
    q, s = _clouds(11, 1, 300), _clouds(12, 1, 300)
    bad = np.asarray(jpk._min_dists_tiled(jnp.asarray(q), jnp.asarray(s), 128, 128))
    want = np.asarray(jnp.min(jg.square_distance(jnp.asarray(q), jnp.asarray(s)), 2))
    got = gk.min_dists(torch.from_numpy(q), torch.from_numpy(s)).numpy()
    _assert_min_dists(got, want, q, s)
    head = np.abs(bad[:, :256] - want[:, :256])
    assert head.max() > 1e-3  # rows it wrote miss the sources past 256
    assert not np.allclose(bad[:, 256:], want[:, 256:], equal_nan=False)  # rows it never wrote


@pytest.mark.parametrize("pad", [False, True], ids=["random", "zero_padded"])
def test_fps_against_fps_pallas(pad):
    xyz = _clouds(6, 2, 2048 if pad else 4096, pad_to=4096 if pad else None)
    start = np.array([17, 3000], np.int32)
    want = np.asarray(jpk.fps_pallas(jnp.asarray(xyz), 64, jnp.asarray(start)))
    got = tg.farthest_point_sample(torch.from_numpy(xyz), 64, torch.from_numpy(start)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gk.fps_plain(torch.from_numpy(xyz), 64,
                                               torch.from_numpy(start)).numpy(), want)


def test_routing_follows_the_jax_thresholds(monkeypatch):
    """The port's predicates against the JAX package's routing, observed by
    patching its backend to "tpu" and its large-N ops to sentinels."""
    routed = []

    def sentinel(name):
        def fn(*args, **kwargs):
            routed.append(name)
            return None
        return fn

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jpk, "chamfer_pallas", sentinel("chamfer"))
    monkeypatch.setattr(jg, "knn_blockwise", sentinel("knn"))
    for n, m in ((2048, 2048), (2049, 16), (16, 2049), (2048, 1)):
        routed.clear()
        jg.chamfer_distance(jnp.zeros((1, n, 3)), jnp.zeros((1, m, 3)))
        assert (routed == ["chamfer"]) == tg.chamfer_is_tiled(n, m), (n, m)
    for n in (4095, 4096, 4097):
        routed.clear()
        jg.knn_indices(jnp.zeros((1, n, 1)), 1)
        assert (routed == ["knn"]) == tg.knn_is_blockwise(n), n


def test_fps_leaves_the_jax_threshold(monkeypatch):
    """The JAX package takes its Pallas FPS on a TPU only from 4096 points and
    where npoint % 8 == 0 (below, its ``fori_loop`` is one compiled program);
    the port's ``farthest_point_sample`` takes the wrapper ``fps`` at every
    size (ROADMAP.md §3, deliberate differences). Observed by patching the
    JAX backend to "tpu" and both packages' FPS to sentinels."""
    routed = []

    def sentinel(name):
        def fn(xyz, npoint, start_idx=None):
            routed.append(name)
            return torch.zeros((xyz.shape[0], npoint), dtype=torch.long)
        return fn

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jpk, "fps_pallas", sentinel("pallas"))
    monkeypatch.setattr(gk, "fps", sentinel("port"))
    for n, npoint, pallas in ((4095, 8, False), (4096, 8, True), (4097, 8, True),
                              (4096, 7, False), (1024, 64, False), (16, 4, False)):
        routed.clear()
        jg.farthest_point_sample.__wrapped__(jnp.zeros((1, n, 3)), npoint)
        assert routed == (["pallas"] if pallas else []), (n, npoint)
        routed.clear()
        tg.farthest_point_sample(torch.zeros((1, n, 3)), npoint)
        assert routed == ["port"], (n, npoint)


def test_cpu_wrappers_launch_nothing():
    gk.min_dists.launches = gk.fps.launches = 0
    x = torch.from_numpy(_clouds(7, 2, 4096))
    tg.chamfer_distance(x, x)
    tg.farthest_point_sample(x, 64)
    gk.fps(x[:, :100].contiguous(), 8)
    assert gk.min_dists.launches == 0 and gk.fps.launches == 0


def test_min_dists_raises_on_grad():
    q = torch.from_numpy(_clouds(8, 1, 32)).requires_grad_()
    s = torch.from_numpy(_clouds(9, 1, 40))
    with pytest.raises(ValueError, match="requires grad"):
        gk.min_dists(q, s)
    with pytest.raises(ValueError, match="requires grad"):
        tg.chamfer_distance(s, torch.cat([q, q] * 40, dim=1))
    with pytest.raises(ValueError, match="batch sizes differ"):
        gk.min_dists(s, torch.zeros((2, 5, 3)))
    with pytest.raises(TypeError, match="float32"):
        gk.fps(s.half(), 4)


@pytest.mark.parametrize("start", [-1, 40], ids=["negative", "past_n"])
def test_fps_rejects_a_start_out_of_range(start):
    """On the CPU the wrapper checks the starts and raises; on the card the
    kernel checks them itself and stops with a device-side assert
    (``chip_smoke.py`` runs that in a child process), so it never reads past
    a cloud and the wrapper reads nothing back to the host."""
    xyz = torch.from_numpy(_clouds(13, 2, 40))
    with pytest.raises(ValueError, match=r"start_idx must lie in \[0, 40\)"):
        gk.fps(xyz, 4, torch.tensor([0, start]))


def test_knn_blockwise_against_jax():
    """Tiles of 128 over N=300 (a partial last tile), with duplicates."""
    rng = np.random.default_rng(10)
    x = rng.uniform(-1, 1, size=(2, 300, 3)).astype(np.float32)
    x[:, 10] = x[:, 3]
    x[:, 277] = x[:, 3]
    x[:, 140] = x[:, 141]
    want = np.asarray(jg.knn_blockwise(jnp.asarray(x), 20, 128))
    got = tg.knn_blockwise(torch.from_numpy(x), 20, tile=128).numpy()
    np.testing.assert_array_equal(got, want)
    # blockwise and the full sort agree
    np.testing.assert_array_equal(got, tg.smallest_k(tg.square_distance(
        torch.from_numpy(x), torch.from_numpy(x)), 20).numpy())


def test_cross_knn_blockwise_against_jax():
    """Above 4096 keys the cross kNN (the SA-node's, and the plain EdgeConv's)
    scans key tiles; on an integer lattice with duplicates every distance is
    exact, so it matches the JAX package's full ``top_k`` index for index."""
    rng = np.random.default_rng(14)
    kv = rng.integers(-6, 7, size=(2, 4100, 3)).astype(np.float32)
    q = np.ascontiguousarray(kv[:, 100:161])
    assert tg.knn_is_blockwise(kv.shape[1])
    d = jg.square_distance(jnp.asarray(q), jnp.asarray(kv))
    want = np.asarray(jax.lax.top_k(-d, 64)[1])
    tq, tkv = torch.from_numpy(q), torch.from_numpy(kv)
    np.testing.assert_array_equal(tg.cross_knn_indices(tq, tkv, 64).numpy(), want)
    u = torch.from_numpy(rng.normal(size=(2, 4100, 8)).astype(np.float32))
    v = torch.zeros((2, 61, 8))
    np.testing.assert_array_equal(te.edgeconv_reduce_plain(tq, tkv, u, v, 64)[4].numpy(), want)
