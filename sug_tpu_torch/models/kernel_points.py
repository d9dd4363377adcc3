"""Kernel-point dispositions for KPConv: the port's own copy of
``sug_tpu/models/kernel_points.py`` (numpy only), so that the port imports
nothing of the JAX package.

Spherical Lloyd relaxation (``kernel_point_disposition``, seed 42, cached in
process), the reference's gradient-descent optimizer
(``kernel_point_optimization_gd``) and the loader with its optional
load-time rotation and jitter (``load_kernels``), each drawing the same
numbers as the JAX package's and returning the same float32 array bit for
bit.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def kernel_point_disposition(
    num_kpoints: int = 15,
    dimension: int = 3,
    fixed: str = "center",
    radius: float = 1.0,
    seed: int = 42,
) -> np.ndarray:
    """Lloyd-optimized kernel point positions in the unit sphere, scaled to
    ``radius``. ``fixed='center'`` pins the first point at the origin.

    Returns (num_kpoints, dimension) float32.
    """
    rng = np.random.default_rng(seed)

    # initialize: random points in the sphere (rejection sampling)
    kp = np.zeros((num_kpoints, dimension))
    count = 1 if fixed == "center" else 0
    while count < num_kpoints:
        cand = rng.uniform(-1, 1, (num_kpoints * 4, dimension))
        cand = cand[np.sum(cand**2, axis=1) < 1.0]
        take = min(len(cand), num_kpoints - count)
        kp[count : count + take] = cand[:take]
        count += take

    # dense sample of the sphere volume for the Lloyd assignment step
    samples = rng.uniform(-1, 1, (30000, dimension))
    samples = samples[np.sum(samples**2, axis=1) < 1.0]

    for _ in range(120):
        d2 = np.sum((samples[:, None, :] - kp[None, :, :]) ** 2, axis=2)
        assign = np.argmin(d2, axis=1)
        for k in range(num_kpoints):
            if fixed == "center" and k == 0:
                continue
            sel = samples[assign == k]
            if len(sel):
                kp[k] = sel.mean(axis=0)
        if fixed == "verticals" and dimension == 3 and num_kpoints >= 3:
            kp[1] = [0, 0, kp[1][2]]
            kp[2] = [0, 0, kp[2][2]]

    # normalize so the mean distance-to-center of the non-fixed points is
    # ~0.66 of the radius (cells fill the sphere; matches the reference's
    # spherical_Lloyd normalization intent)
    norms = np.linalg.norm(kp[1:] if fixed == "center" else kp, axis=1)
    scale = 0.66 / max(np.mean(norms), 1e-9)
    kp = kp * scale
    if fixed == "center":
        kp[0] = 0.0
    return (kp * radius).astype(np.float32)


@functools.lru_cache(maxsize=None)
def kernel_point_optimization_gd(
    num_points: int = 15,
    dimension: int = 3,
    fixed: str = "center",
    num_kernels: int = 100,
    ratio: float = 0.66,
    seed: int = 42,
) -> np.ndarray:
    """Gradient-descent kernel-point optimization — the reference's
    ``kernel_point_optimization_debug`` (model/KPConv_kernels.py:268-414):
    inverse-square repulsion between points + a ``10 x`` radial attraction,
    normalized-gradient steps with clipping, run on ``num_kernels`` random
    candidates; the candidate with the lowest final max-gradient-norm wins.
    Deterministic (seeded) and fully vectorized over candidates; cached in
    process, as the Lloyd disposition is, since every KPConv layer asks
    for it.

    Returns (num_points, dimension) float32, unit-radius scale (mean radius of
    the movable points == ``ratio``).
    """
    rng = np.random.default_rng(seed)
    radius0, clip, thresh = 1.0, 0.05, 1e-5
    moving_factor, decay = 1e-2, 0.9995

    # uniform init inside the sphere of radius sqrt(0.5) (reference keeps
    # d2 < 0.5 * radius0^2, model/KPConv_kernels.py:304-310)
    kp = np.zeros((num_kernels, num_points, dimension))
    filled = 0
    while filled < num_kernels * num_points:
        cand = rng.uniform(-radius0, radius0, (num_kernels * num_points * 2, dimension))
        cand = cand[np.sum(cand**2, axis=1) < 0.5 * radius0**2]
        take = min(len(cand), num_kernels * num_points - filled)
        kp.reshape(-1, dimension)[filled : filled + take] = cand[:take]
        filled += take

    if fixed == "center":
        kp[:, 0, :] = 0.0
    if fixed == "verticals":
        kp[:, :3, :] = 0.0
        kp[:, 1, -1] += 2 * radius0 / 3
        kp[:, 2, -1] -= 2 * radius0 / 3

    old_norms = np.zeros((num_kernels, num_points))
    final_norms = np.zeros(num_kernels)
    for step in range(10000):
        diff = kp[:, :, None, :] - kp[:, None, :, :]
        d2 = np.sum(diff**2, axis=-1)
        # inter[p] = sum_q (kp[q]-kp[p]) / d^3: descent on `grads` pushes each
        # point AWAY from the others (repulsion) while the 10x radial term pulls
        # it inward (reference model/KPConv_kernels.py:340-345). Summing the
        # antisymmetric diff over axis=1 realizes the (q-p) orientation.
        inter = np.sum(diff / (d2[..., None] ** 1.5 + 1e-6), axis=1)
        grads = inter + 10.0 * kp
        if fixed == "verticals":
            grads[:, 1:3, :-1] = 0.0

        norms = np.sqrt(np.sum(grads**2, axis=-1))
        final_norms = np.max(norms, axis=1)
        movable = {"center": 1, "verticals": 3}.get(fixed, 0)
        if np.max(np.abs(old_norms[:, movable:] - norms[:, movable:])) < thresh:
            break
        old_norms = norms

        moving = np.minimum(moving_factor * norms, clip)
        moving[:, :movable] = 0.0
        kp -= moving[..., None] * grads / (norms[..., None] + 1e-6)
        moving_factor *= decay

    best = int(np.argmin(final_norms))
    points = kp[best]
    r = np.sqrt(np.sum(points**2, axis=-1))
    movable = {"center": 1, "verticals": 3}.get(fixed, 0)
    points = points * (ratio / max(np.mean(r[movable:] if movable else r), 1e-9))
    if fixed == "center":
        points[0] = 0.0
    return points.astype(np.float32)


def load_kernels(
    radius: float,
    num_kpoints: int = 15,
    dimension: int = 3,
    fixed: str = "center",
    method: str = "lloyd",
    random_init: bool = False,
    seed: int = 0,
) -> np.ndarray:
    """Disposition loader with the reference's load-time randomization.

    ``method``: 'lloyd' (spherical Lloyd, default — the reference switches to
    Lloyd for >30 points) or 'gd' (the gradient-descent optimizer).
    ``random_init=True`` reproduces ``load_kernels``'s per-model-instance
    randomization (model/KPConv_kernels.py:460-497): a random z-axis rotation
    (the reference's ``fixed != 'vertical'`` check never matches its own
    'verticals' spelling, so 3-D always takes the z-rotation branch) plus
    N(0, 0.01) jitter, applied BEFORE scaling to ``radius``.
    """
    if method == "gd":
        kp = kernel_point_optimization_gd(num_kpoints, dimension, fixed)
    else:
        kp = kernel_point_disposition(num_kpoints, dimension, fixed, radius=1.0)
    kp = np.array(kp, dtype=np.float64)

    if random_init:
        rng = np.random.default_rng(seed)
        theta = rng.random() * 2 * np.pi
        c, s = np.cos(theta), np.sin(theta)
        if dimension == 3:
            R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        else:
            R = np.array([[c, -s], [s, c]])
        kp = kp + rng.normal(scale=0.01, size=kp.shape)
        kp = kp @ R
    return (kp * radius).astype(np.float32)
