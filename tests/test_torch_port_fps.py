"""Farthest point sampling in the port (``sug_tpu_torch/ops/geometry_kernels.py``
``fps``, ``fps_plan``; ``csrc/fps.cu``) through what the CPU can run.

- ``kernel_fps`` below repeats the CUDA kernel's split of the work in numpy:
  the team of W warps in each of C blocks that ``fps_plan`` picks, P points
  per thread (point ``r·T·P + t + j·T`` on thread t of block part r), each
  thread's first maximum over its points in ascending j, the warp's
  (value bits, index) reduction, the candidate slots by step parity (in every
  block of a cluster, with one block a step ahead of the others, as the
  barrier allows), the slots' reduction, the winner's coordinates from the
  slot its index names, and several small clouds' teams sharing one block's
  slots. On tie-heavy clouds (integer lattices with duplicates, zero-padded
  clouds, all points equal) it must give ``np.argmax``'s first maximum at
  every step, for N from 1 to 70000 and every team the launcher takes.
- The launcher's acceptance of a team, mirrored from ``csrc/fps.cu``, holds
  for ``fps_plan`` at every N up to 131072 and refuses N = 131073.
- ``farthest_point_sample`` reaches the wrapper ``fps`` at every N, and on
  the CPU still equals the JAX package's ``farthest_point_sample``.
- ``fps`` and ``min_dists`` take float64 CPU tensors through their plain
  versions.

The kernel itself runs only on the card, where ``chip_smoke.py`` holds it
index for index to ``fps_plain`` at the main paths' shapes.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sug_tpu.ops import geometry as jg
from sug_tpu_torch.ops import geometry as tg
from sug_tpu_torch.ops import geometry_kernels as gk

INT_MAX = np.iinfo(np.int32).max
NEG_ONE_BITS = np.float32(-1.0).view(np.int32)  # a point past the cloud's end
WARPS = (1, 2, 4, 8, 16, 32)
CLUSTERS = (1, 2, 4, 8)
SMALL_TEAM_BLOCK_WARPS = 4


def max_threads(p: int, smem: bool) -> int:
    """``max_threads<P, kSmem>`` of the kernel: its launch bound."""
    return 1024 if smem or p <= 8 else (512 if p == 16 else 256)


def teams_per_block(warps: int, cluster: int) -> int:
    return SMALL_TEAM_BLOCK_WARPS // warps if cluster == 1 and warps < SMALL_TEAM_BLOCK_WARPS else 1


def launchable(n: int, warps: int, cluster: int) -> bool:
    """Whether the launcher ``fps`` of ``csrc/fps.cu`` takes this team for an
    n-point cloud: a block part of at most 32 points a thread, P = 16 with
    more than 512 threads in shared memory, P = 32 only up to 256 threads."""
    t = 32 * warps
    per_part = -(-n // cluster)
    if cluster > 8 or per_part > 32 * t:
        return False
    p = gk.fps_points_per_thread(n, warps, cluster)
    smem = p == 16 and t > max_threads(16, False)
    return t * teams_per_block(warps, cluster) <= max_threads(p, smem)


def plain_fps(xyz: np.ndarray, npoint: int, start: np.ndarray) -> np.ndarray:
    """The contract in numpy: f32 distances summed (dx·dx + dy·dy) + dz·dz,
    the running minimum from 1e10, ``np.argmax``'s first maximum."""
    B, N, _ = xyz.shape
    dist = np.full((B, N), 1e10, np.float32)
    far = start.astype(np.int64).copy()
    out = np.empty((B, npoint), np.int64)
    for i in range(npoint):
        out[:, i] = far
        d = xyz - xyz[np.arange(B), far][:, None, :]
        sq = d * d
        dist = np.minimum(dist, (sq[..., 0] + sq[..., 1]) + sq[..., 2])
        far = np.argmax(dist, axis=1)
    return out


def _warp_reduce(bits: np.ndarray, idx: np.ndarray):
    """Two ``redux.sync`` over the last axis (the lanes): the max of the
    value bits, then the min of the indices whose bits equal it."""
    v = bits.max(axis=-1)
    i = np.where(bits == v[..., None], idx, INT_MAX).min(axis=-1)
    return v, i


class _Team:
    """One cloud's team: its points laid out as the threads hold them,
    [block part r, j, warp w, lane l] for point r·T·P + j·T + 32·w + l."""

    def __init__(self, cloud: np.ndarray, warps: int, cluster: int):
        n = cloud.shape[0]
        self.w, self.c = warps, cluster
        self.t = 32 * warps
        self.p = gk.fps_points_per_thread(n, warps, cluster)
        self.per_part = self.t * self.p
        size = cluster * self.per_part
        assert size >= n
        shape = (cluster, self.p, warps, 32)
        self.index = np.arange(size).reshape(shape)
        self.xyz = np.zeros((size, 3), np.float32)
        self.xyz[:n] = cloud
        self.xyz = self.xyz.reshape(shape + (3,))
        # -1 past the cloud's end: never the maximum
        self.dist = np.where(self.index < n, np.float32(1e10), np.float32(-1.0)).astype(np.float32)

    def candidates(self, c: np.ndarray, part: int):
        """Block part ``part``'s step: every thread updates its minima and
        keeps its first maximum over j; each warp reduces its lanes. Returns
        per warp (value bits, index, the owner lane's coordinates)."""
        d = self.xyz[part] - c
        sq = d * d
        self.dist[part] = np.fmin(self.dist[part], (sq[..., 0] + sq[..., 1]) + sq[..., 2])
        dist = self.dist[part]  # (P, W, 32)
        bj = np.argmax(dist, axis=0)  # the first j of the largest value: a strict > from -1
        bv = np.take_along_axis(dist, bj[None], axis=0)[0]  # (W, 32)
        empty = bv < 0
        bi = np.where(empty, INT_MAX, np.take_along_axis(self.index[part], bj[None], axis=0)[0])
        bxyz = np.take_along_axis(self.xyz[part], bj[None, ..., None], axis=0)[0]  # (W, 32, 3)
        bxyz[empty] = 0.0
        vw, iw = _warp_reduce(np.where(empty, NEG_ONE_BITS, bv.view(np.int32)), bi)
        owner = iw & 31  # the lane of point iw; lane 31 for an empty warp
        for w in range(self.w):
            if iw[w] != INT_MAX:
                assert self.index[part, :, w, owner[w]].tolist().count(iw[w]) == 1
        return vw, iw, bxyz[np.arange(self.w), owner]

    def slot_of(self, far: int) -> int:
        """The kernel's ``won``: the winner's block part, then its warp."""
        shift = self.per_part.bit_length() - 1
        return (far >> shift) * self.w + ((far & (self.t - 1)) >> 5)


def _read_slots(keys: np.ndarray, coords: np.ndarray, team: _Team, slot0: int):
    """Every warp's reduction of the team's slots: lane l takes slots l,
    l + 32, ... in order with the (value, index) test, then two redux."""
    nslots = team.w * team.c
    bits = np.full(32, NEG_ONE_BITS, np.int64)
    idx = np.full(32, INT_MAX, np.int64)
    for k in range(nslots):
        v, i = keys[slot0 + k]
        lane = k % 32
        if v > bits[lane] or (v == bits[lane] and i < idx[lane]):
            bits[lane], idx[lane] = v, i
    _, far = _warp_reduce(bits, idx)
    return int(far), coords[slot0 + team.slot_of(int(far))]


def kernel_fps(xyz: np.ndarray, npoint: int, start: np.ndarray, warps: int,
               cluster: int) -> np.ndarray:
    """The kernel's algorithm on (B, N, 3) f32 clouds with one team per cloud
    of ``warps`` warps in each of ``cluster`` blocks, teams below 4 warps
    sharing a block's slots."""
    B = xyz.shape[0]
    out = np.empty((B, npoint), np.int64)
    per_block = teams_per_block(warps, cluster)
    for b0 in range(0, B, per_block):
        clouds = range(b0, min(B, b0 + per_block))
        teams = {b: _Team(xyz[b], warps, cluster) for b in clouds}
        # slots by receiving block part, then step parity: the block's
        # slot_key and slot_xyz (cluster == 1: the teams of a block share them)
        keys = np.zeros((cluster, 2, 256, 2), np.int64)
        coords = np.zeros((cluster, 2, 256, 3), np.float32)
        far = {b: int(start[b]) for b in clouds}
        cen = {b: xyz[b, far[b]] for b in clouds}
        ahead = {}  # block part 0's candidates of the next step, stored early

        def store(b, team, step, part, cands):
            slot0 = 0 if cluster > 1 else (b - b0) * warps
            for w in range(warps):
                slot = slot0 + part * warps + w
                for receiver in range(cluster):
                    keys[receiver, step & 1, slot] = (cands[0][w], cands[1][w])
                    coords[receiver, step & 1, slot] = cands[2][w]

        for i in range(npoint):
            for b in clouds:
                out[b, i] = far[b]
            if i + 1 == npoint:
                break
            for b in clouds:  # every warp stores its candidate, then the barrier
                team = teams[b]
                for part in range(cluster):
                    if (b, part) in ahead:
                        cands = ahead.pop((b, part))
                    else:
                        cands = team.candidates(cen[b], part)
                    if team.w * team.c == 1:  # one warp: the owner lane's shuffles
                        assert cands[1][0] & 31 == cands[1][0] % 32
                        far[b], cen[b] = int(cands[1][0]), cands[2][0]
                        continue
                    store(b, team, i, part, cands)
            for b in clouds:
                team = teams[b]
                if team.w * team.c == 1:
                    continue
                slot0 = 0 if cluster > 1 else (b - b0) * warps
                # block part 0 reads first, runs its next step and stores it
                # (parity i + 1) before the other parts read parity i
                got = [_read_slots(keys[0, i & 1], coords[0, i & 1], team, slot0)]
                if cluster > 1 and i + 2 < npoint:
                    ahead[(b, 0)] = team.candidates(got[0][1], 0)
                    store(b, team, i + 1, 0, ahead[(b, 0)])
                got += [_read_slots(keys[r, i & 1], coords[r, i & 1], team, slot0)
                        for r in range(1, cluster)]
                assert all(g[0] == got[0][0] for g in got), got
                far[b], cen[b] = got[0]
                assert np.array_equal(cen[b], xyz[b, far[b]])
    return out


def _tie_clouds(kind: str, b: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "lattice":  # duplicates, and integer distances that tie
        return rng.integers(-3, 4, size=(b, n, 3)).astype(np.float32)
    if kind == "padded":  # the last half at the origin, as fit_num_points pads
        x = rng.normal(size=(b, n, 3)).astype(np.float32)
        x[:, (n + 1) // 2:] = 0.0
        return x
    return np.full((b, n, 3), 0.25, np.float32)  # all points equal


# N from 1 to 70000: a partial warp, a warp, a partial block part, several
# parts, the largest one-block cloud and clouds that need a cluster
SIZES = (1, 2, 17, 32, 33, 100, 255, 1000, 1024, 2049, 4100, 16384, 20000, 70000)
TEAMS = [(w, c) for c in CLUSTERS for w in WARPS]


@pytest.mark.parametrize("warps,cluster", TEAMS, ids=[f"w{w}-c{c}" for w, c in TEAMS])
def test_kernel_split_gives_the_first_maximum(warps, cluster):
    sizes = [n for n in SIZES if launchable(n, warps, cluster)]
    assert sizes
    for n in sizes:
        b = 5 if n <= 1024 else 2  # 5: teams of 1 and 2 warps fill a block and start a second
        npoint = min(n + 2, 12) if n <= 4100 else 6
        for seed, kind in enumerate(("lattice", "padded", "equal")):
            xyz = _tie_clouds(kind, b, n, seed)
            start = np.random.default_rng(seed + n).integers(0, n, size=b)
            want = plain_fps(xyz, npoint, start)
            got = kernel_fps(xyz, npoint, start, warps, cluster)
            np.testing.assert_array_equal(got, want, err_msg=f"{kind} N={n}")


@pytest.mark.parametrize("n", [16, 1000, 4096, 20000])
def test_plain_contract_is_fps_plain(n):
    """The numpy contract above is ``fps_plain``, index for index, on a
    lattice with duplicates; and the kernel's split on ``fps_plan``'s team."""
    xyz = _tie_clouds("lattice", 2, n, 3)
    start = np.array([0, n - 1])
    want = plain_fps(xyz, 8, start)
    got = gk.fps_plain(torch.from_numpy(xyz), 8, torch.from_numpy(start)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(kernel_fps(xyz, 8, start, *gk.fps_plan(n)), want)


def test_fps_plan_is_launchable_up_to_the_limit():
    for n in list(range(1, 4200)) + list(range(4200, gk.FPS_MAX_POINTS + 1, 97)) + [
            8192, 8193, 16384, 16385, 65536, gk.FPS_MAX_POINTS]:
        warps, cluster = gk.fps_plan(n)
        assert launchable(n, warps, cluster), (n, warps, cluster)
    assert not launchable(gk.FPS_MAX_POINTS + 1, *gk.fps_plan(gk.FPS_MAX_POINTS + 1))
    # a team the launcher refuses: 32 points a thread at 1024 threads
    assert not launchable(32768, 32, 1)


@pytest.mark.parametrize("n", [16, 256, 1024, 4095, 4096, 20000])
def test_farthest_point_sample_reaches_the_wrapper(monkeypatch, n):
    calls = []

    def sentinel(xyz, npoint, start_idx=None):
        calls.append((tuple(xyz.shape), npoint, xyz.is_contiguous()))
        return torch.zeros((xyz.shape[0], npoint), dtype=torch.long)

    monkeypatch.setattr(gk, "fps", sentinel)
    monkeypatch.setattr(gk, "fps_plain", None)  # not reached around the wrapper
    x = torch.zeros((2, n, 4))[..., :3]  # not contiguous: the router makes it so
    tg.farthest_point_sample(x, 4)
    assert calls == [((2, n, 3), 4, True)]


@pytest.mark.parametrize("n,npoint", [(1024, 64), (16, 4), (20000, 8)])
def test_farthest_point_sample_against_jax(n, npoint):
    rng = np.random.default_rng(n)
    x = rng.uniform(-1, 1, size=(2, n, 3)).astype(np.float32)
    x[:, n // 2] = x[:, 1]  # a duplicate
    start = rng.integers(0, n, size=2).astype(np.int32)
    want = np.asarray(jg.farthest_point_sample(jnp.asarray(x), npoint, jnp.asarray(start)))
    got = tg.farthest_point_sample(torch.from_numpy(x), npoint, torch.from_numpy(start)).numpy()
    np.testing.assert_array_equal(got, want)


def test_float64_on_the_cpu():
    """The plain versions in f64 (the precision witness of ROADMAP F2 runs a
    whole loss so); the CPU refuses other types, and so does the card
    anything but f32 (its check runs before any launch)."""
    rng = np.random.default_rng(21)
    x = rng.normal(size=(2, 300, 3))
    y = rng.normal(size=(2, 200, 3))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    assert tx.dtype == torch.float64
    got = gk.fps(tx, 16, torch.tensor([5, 7]))
    np.testing.assert_array_equal(got.numpy(), plain_fps(x, 16, np.array([5, 7])))
    d = gk.min_dists(tx, ty)
    assert d.dtype == torch.float64
    want = ((x[:, :, None, :] - y[:, None, :, :]) ** 2).sum(-1).min(-1)
    np.testing.assert_allclose(d.numpy(), want, rtol=1e-12, atol=1e-12)
    assert tg.chamfer_distance(tx, torch.cat([ty] * 11, 1)).dtype == torch.float64
    with pytest.raises(TypeError, match="float32"):
        gk.fps(tx.half(), 4)
    with pytest.raises(TypeError, match="query is torch.float64"):
        gk.min_dists(tx, ty.float())
