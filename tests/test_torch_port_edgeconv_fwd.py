"""The EdgeConv forward's two kernels (``select`` and ``gather`` of
``sug_tpu_torch/csrc/edgeconv_fwd.cu``) through what the CPU can run: the
plain version of each, and a test-side emulation of the select kernel's
streaming top-k.

- ``gather_reduce_plain`` (the gather kernel's plain version, a loop over j)
  against ``edgeconv_reduce_plain`` on the same idx, against the JAX
  package's ``edgeconv_reduce_reference`` and the Pallas kernel in interpret
  mode (values to 1e-5 abs + 1e-5 rel, as ``test_torch_port_edgeconv.py``
  holds them: max/min pick the same f32 values, the sums add the same k
  terms in another order), and bit for bit against an ordered f32 numpy
  loop.
- ``streaming_topk`` below repeats the select kernel's algorithm on a
  distance matrix: key tiles in order, each entry tested against the bar
  (the list's k-th pair) lexicographically, the survivors inserted by rank.
  It must give exactly the stable (d, j) sort's indices, at any tile size,
  for k from 1 to 64, on duplicates and on a zero-padded hub.
- The wrapper refuses k above the kernels' cap (and C above theirs) on the
  CPU too, before it dispatches.

The kernels themselves run only on the card, where ``chip_smoke.py`` holds
select to the plain kNN and gather bit for bit to ``gather_reduce_plain``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sug_tpu.ops.edgeconv_pallas import (
    edgeconv_reduce_reference,
    fused_cross_edgeconv_reduce as pallas_cross,
    fused_edgeconv_reduce as pallas_self,
)
from sug_tpu_torch.models.adapt_node import NSAMPLE
from sug_tpu_torch.models.dgcnn import K_NEIGHBORS
from sug_tpu_torch.ops import edgeconv as te
from sug_tpu_torch.ops.geometry import cross_knn_indices, square_distance

TOL = dict(rtol=1e-5, atol=1e-5)
NAMES = ("amax", "amin", "s1", "s2")


def _before(d, j, bd, bj):
    """(d, j) strictly before (bd, bj): the kernel's lexicographic test."""
    return d < bd or (d == bd and j < bj)


def streaming_topk(dist: np.ndarray, k: int, tile: int) -> np.ndarray:
    """The select kernel's top-k on a (S, N) f32 distance matrix: each
    query's sorted list of k pairs starts as the sentinel (+inf, -1); the
    keys come tile by tile; an entry that beats the bar at the start of the
    tile is a survivor, and each survivor, in ascending j, is inserted at its
    rank (the count of list entries before it) if it still beats the bar,
    the last pair dropping out. Slots left at the sentinel give N-1."""
    S, N = dist.shape
    out = np.empty((S, k), dtype=np.int64)
    for s in range(S):
        ld, lj = [np.float32(np.inf)] * k, [-1] * k
        for t0 in range(0, N, tile):
            bar = (ld[-1], lj[-1])
            survivors = [j for j in range(t0, min(N, t0 + tile)) if _before(dist[s, j], j, *bar)]
            for j in survivors:
                d = dist[s, j]
                if not _before(d, j, ld[-1], lj[-1]):
                    continue
                pos = sum(_before(ld[p], lj[p], d, j) for p in range(k))
                ld = ld[:pos] + [d] + ld[pos:-1]
                lj = lj[:pos] + [j] + lj[pos:-1]
        out[s] = [j if j >= 0 else N - 1 for j in lj]
    return out


def _clouds(kind, rng, b, n, c):
    """Seeded (b, n, c) f32 clouds: normal, an integer lattice with exact
    duplicates, or zero-padded past half the points (a hub of ties)."""
    if kind == "lattice":
        x = rng.integers(-3, 4, size=(b, n, c)).astype(np.float32)
        x[:, n // 2] = x[:, 0]
        return x
    x = rng.normal(size=(b, n, c)).astype(np.float32)
    if kind == "padded":
        x[:, n // 2:] = 0.0
    return x


def _distances(q, kv):
    return square_distance(torch.from_numpy(q), torch.from_numpy(kv)).numpy()


# (kind, S or None for self-kNN, N, C, k, tile)
TOPK_CASES = [
    ("normal", None, 150, 3, 20, 64),
    ("normal", None, 150, 16, 1, 64),
    ("normal", 40, 200, 3, 64, 64),
    ("normal", None, 130, 3, 32, 7),
    ("normal", None, 130, 8, 33, 1),
    ("lattice", None, 150, 3, 20, 64),
    ("lattice", 30, 160, 3, 64, 13),
    ("lattice", None, 96, 2, 64, 96),
    ("padded", None, 200, 3, 20, 64),
    ("padded", 64, 200, 3, 64, 64),
    ("padded", None, 200, 3, 50, 17),
    ("padded", None, 70, 3, 64, 200),
]


@pytest.mark.parametrize("case", TOPK_CASES,
                         ids=[f"{c[0]}-{'self' if c[1] is None else 'cross'}-k{c[4]}-tile{c[5]}"
                              for c in TOPK_CASES])
def test_streaming_topk_is_the_stable_sort(case):
    """The emulated select kernel gives the stable (d, j) sort's first k
    indices exactly, as does the port's kNN (``cross_knn_indices``), on the
    same f32 distances: ties (lattice duplicates, the zero-padded hub) go to
    the lowest index whatever the tile size."""
    kind, s, n, c, k, tile = case
    rng = np.random.default_rng(TOPK_CASES.index(case))
    kv = _clouds(kind, rng, 1, n, c)
    q = kv if s is None else np.ascontiguousarray(kv[:, n // 2 - s // 2:][:, :s])
    d = _distances(q, kv)[0]
    want = np.argsort(d, axis=-1, kind="stable")[:, :k]
    np.testing.assert_array_equal(streaming_topk(d, k, tile), want)
    np.testing.assert_array_equal(
        cross_knn_indices(torch.from_numpy(q), torch.from_numpy(kv), k)[0].numpy(), want)


@pytest.mark.parametrize("tile", [1, 5, 64])
def test_streaming_topk_random_ties(tile):
    """Distances drawn from a few values, so most entries tie, over k from
    1 to 64."""
    rng = np.random.default_rng(tile)
    d = rng.integers(0, 4, size=(6, 90)).astype(np.float32)
    for k in (1, 2, 17, 31, 32, 33, 63, 64):
        want = np.argsort(d, axis=-1, kind="stable")[:, :k]
        np.testing.assert_array_equal(streaming_topk(d, k, tile), want, err_msg=f"k={k}")


def test_streaming_topk_non_finite():
    """A +inf or NaN distance is never selected; -inf sorts first; a query
    with fewer than k finite distances gets N-1 in the slots left over, so
    idx stays in range (the handling of the earlier one-warp kernel)."""
    d = np.array([[3.0, np.nan, 1.0, np.inf, -np.inf, 1.0, np.nan, 2.0],
                  [np.nan] * 8,
                  [np.inf, 0.0, np.inf, np.inf, np.inf, np.inf, np.inf, np.inf]], np.float32)
    got = streaming_topk(d, 6, tile=3)
    np.testing.assert_array_equal(got, [[4, 2, 5, 7, 0, 7], [7] * 6, [1, 7, 7, 7, 7, 7]])


def _inputs(seed, b, s, n, c, f, cross, kind="normal"):
    rng = np.random.default_rng(seed)
    kv = _clouds(kind, rng, b, n, c)
    q = rng.normal(size=(b, s, c)).astype(np.float32) if cross else kv
    u = rng.normal(size=(b, n, f)).astype(np.float32)
    v = rng.normal(size=(b, s, f)).astype(np.float32)
    return q, kv, u, v


# (b, s, n, c, f, k, cross, kind): self-kNN as DGCNN's blocks, the SA-node's
# cross kNN, duplicates; N a multiple of 128 for the Pallas kernel
GATHER_SHAPES = [
    (2, 128, 128, 3, 64, 20, False, "normal"),
    (2, 256, 256, 16, 32, 20, False, "normal"),
    (2, 64, 256, 3, 64, 64, True, "normal"),
    (1, 128, 128, 4, 16, 20, False, "lattice"),
    (1, 64, 128, 3, 16, 64, True, "padded"),
]
GATHER_IDS = ["self-c3", "self-c16", "sa-node", "self-duplicates", "cross-zero-padded"]


def _port_gather(q, kv, u, v, k):
    tq, tkv, tu, tv = (torch.from_numpy(a) for a in (q, kv, u, v))
    idx = cross_knn_indices(tq, tkv, k).to(torch.int32)
    return te.gather_reduce_plain(idx, tu, tv), idx


@pytest.mark.parametrize("shape", GATHER_SHAPES, ids=GATHER_IDS)
def test_gather_plain_matches_edgeconv_plain_and_jax(shape):
    """On the plain kNN's idx, ``gather_reduce_plain`` agrees with
    ``edgeconv_reduce_plain`` (max and min exactly), with the JAX reference
    and with the Pallas kernel in interpret mode (neighbour sets there)."""
    b, s, n, c, f, k, cross, kind = shape
    q, kv, u, v = _inputs(5, b, s, n, c, f, cross, kind)
    got, idx = _port_gather(q, kv, u, v, k)
    plain = te.edgeconv_reduce_plain(*(torch.from_numpy(a) for a in (q, kv, u, v)), k)
    np.testing.assert_array_equal(plain[4].numpy(), idx.numpy())
    for name, g, w in zip(NAMES, got, plain[:4]):
        if name in ("amax", "amin"):
            np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name, **TOL)
    jq, jkv, ju, jv = map(jnp.asarray, (q, kv, u, v))
    if cross:
        pallas = pallas_cross(jq, jkv, ju, jv, k, interpret=True)
    else:
        ref = edgeconv_reduce_reference(jkv, ju, jv, k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref[4]))
        for name, g, w in zip(NAMES, got, ref[:4]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
        pallas = pallas_self(jkv, ju, jv, k, True)
    np.testing.assert_array_equal(np.sort(idx.numpy(), -1), np.sort(np.asarray(pallas[4]), -1))
    for name, g, w in zip(NAMES, got, pallas[:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)


@pytest.mark.parametrize("shape", GATHER_SHAPES[:3], ids=GATHER_IDS[:3])
def test_gather_plain_is_the_ordered_loop(shape):
    """``gather_reduce_plain`` bit for bit against a numpy f32 loop over j
    from 0, each product and add rounded on its own: the gather kernel's
    order, which the card holds it to bit for bit."""
    b, s, n, c, f, k, cross, _ = shape
    q, kv, u, v = _inputs(6, b, s, n, c, f, cross)
    got, idx = _port_gather(q, kv, u, v, k)
    a = np.take_along_axis(u[:, None], idx.numpy().astype(np.int64)[..., None], axis=2)
    a = (a + v[:, :, None, :]).astype(np.float32)  # (b, s, k, f)
    mx, mn = np.full_like(v, -np.inf), np.full_like(v, np.inf)
    s1, s2 = np.zeros_like(v), np.zeros_like(v)
    for j in range(k):
        aj = a[:, :, j]
        mx, mn = np.fmax(mx, aj), np.fmin(mn, aj)
        s1 = (s1 + aj).astype(np.float32)
        s2 = (s2 + (aj * aj).astype(np.float32)).astype(np.float32)
    for name, g, w in zip(NAMES, got, (mx, mn, s1, s2)):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_streaming_topk_feeds_the_gather():
    """The whole forward as the card runs it, select then gather, against
    ``edgeconv_reduce_plain``: the emulated top-k's idx into
    ``gather_reduce_plain``, on a zero-padded cloud at self-kNN."""
    q, kv, u, v = _inputs(7, 1, 96, 96, 3, 8, cross=False, kind="padded")
    d = _distances(q, kv)[0]
    idx = torch.from_numpy(streaming_topk(d, 20, tile=64)[None].astype(np.int32))
    got = te.gather_reduce_plain(idx, torch.from_numpy(u), torch.from_numpy(v))
    want = te.edgeconv_reduce_plain(*(torch.from_numpy(a) for a in (q, kv, u, v)), 20)
    np.testing.assert_array_equal(idx.numpy(), want[4].numpy())
    for name, g, w in zip(NAMES, got, want[:4]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name, **TOL)


def test_forward_limits_raise_before_dispatch():
    """k above the cap raises on the CPU as on the card, before the plain
    version runs and before any launch is counted; the callers' k (DGCNN's
    20, the SA-node's 64) and C (3 to 128) pass."""
    before = te.edgeconv_reduce.launches
    q, kv, u, v = (torch.from_numpy(a) for a in _inputs(8, 1, 8, 80, 3, 4, cross=True))
    with pytest.raises(ValueError, match=r"k <= 64.*B=1, S=8, N=80, C=3, F=4, k=65"):
        te.edgeconv_reduce(q, kv, u, v, te.MAX_FWD_K + 1)
    wide = torch.zeros((1, 80, te.MAX_FWD_C + 1))
    with pytest.raises(ValueError, match=r"C <= 512.*C=513"):
        te.edgeconv_reduce(wide[:, :8].contiguous(), wide, u, v, 4)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        te.edgeconv_reduce_stages(q, kv, u, v, 4)
    assert te.edgeconv_reduce.launches == before
    for shape in ((64, 1024, 1024, 3, 64, K_NEIGHBORS), (64, 4096, 4096, 128, 256, K_NEIGHBORS),
                  (64, 64, 4096, 3, 64, NSAMPLE), (4, 16384, 16384, 3, 64, 20)):
        te.check_fwd_kernel_limits(*shape)
    with pytest.raises(ValueError, match=r"B=65536"):
        te.check_fwd_kernel_limits(65536, 64, 1024, 3, 64, 20)
    assert te.edgeconv_reduce(q, kv, u, v, te.MAX_FWD_K)[4].shape == (1, 8, 64)
