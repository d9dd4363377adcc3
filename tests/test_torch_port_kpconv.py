"""KPConv's rigid network in the port (``sug_tpu_torch/models/kpconv.py``,
``kernel_points.py``) against the JAX package on the CPU: the pieces below
the encoder.

1. ``kernel_points``: the Lloyd disposition, the gradient-descent optimizer
   and ``load_kernels`` with ``random_init``, bit for bit;
2. ``_morton3`` bit for bit, and its hierarchy;
3. ``grid_subsample_fixed`` on random clouds, at a capacity overflow, with
   an input ``valid`` mask, on voxel-face lattices (points on the faces and
   one ulp either side), with ``pre_sorted`` against the sorted path;
   ``build_pyramid`` with a misaligned ``grid_dl`` (the sort fallback) and
   at the defaults: valid masks equal, neighbour and pool idx/mask equal
   off ties, centroids held to their float64 voxel means;
4. ``radius_neighbors_masked`` as neighbour sets, on the same inputs;
5. ``KPConvOp`` for each influence and aggregation, values and the
   gradients of its weights and input features; masked ``instance_norm``;
   ``SimpleBlock`` and ``ResnetBottleneckBlock``, strided and not;
6. ``check_neighbor_occupancy``'s means, and the refusals: deformable
   blocks and ``pyramid="fps"`` now build, and bf16 raises
   ``NotImplementedError`` naming its ROADMAP item.

Tolerances, each with its cause:
- voxel assignments, masks and neighbour indices: equal. A neighbour row
  may differ only where a point lies within 1e-5·r² of the radius in d²
  (float64): there the two libraries' f32 distances fall either side;
- centroids: each within ``2·sqrt(N)·2^-24·max|P| / count`` of its
  float64 voxel mean, P the cloud's prefix sums. A centroid is a difference
  of two whole-cloud f32 prefix sums, and numpy, PyTorch and XLA sum them
  in three different orders (on random clouds their cumsums differ by
  6e-5 at |P| ≈ 500), so neither side is exact and the two differ by
  a few ulps of max|P|;
- the op, the norm and the blocks on identical inputs: 1e-5 abs + 1e-5
  rel for values, 1e-4 relative L2 for gradients (the libraries order the
  f32 sums of their contractions differently).
"""

from __future__ import annotations

import logging
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sug_tpu.models import kernel_points as jkp
from sug_tpu.models import kpconv as jk
from sug_tpu_torch.models import kernel_points as tkp
from sug_tpu_torch.models import kpconv as tk
from sug_tpu_torch.models.layers import flax_init_
from sug_tpu_torch.models.net_mda import NetMDA
from sug_tpu_torch.models.precision import set_compute_dtype
from sug_tpu_torch.utils.jax_bridge import load_jax_variables
from tests._torch_port_common import (  # noqa: F401
    jax_grads_by_name,
    one_torch_thread,
    port_weights_as_jax,
    t,
)

EPS32 = 2.0**-24
TIE_REL = 1e-5


def unit_clouds(rng, b, n, positive=False):
    pc = rng.normal(size=(b, n, 3))
    if positive:
        pc = np.abs(pc)
    pc /= np.max(np.linalg.norm(pc, axis=-1, keepdims=True), axis=1, keepdims=True)
    return pc.astype(np.float32)


# 1. kernel points -----------------------------------------------------------

@pytest.mark.parametrize("fixed", ["center", "verticals"])
def test_lloyd_disposition_bit_for_bit(fixed):
    np.testing.assert_array_equal(tkp.kernel_point_disposition(15, 3, fixed),
                                  jkp.kernel_point_disposition(15, 3, fixed))


@pytest.mark.parametrize("fixed", ["center", "verticals"])
def test_gd_optimizer_bit_for_bit(fixed):
    want = jkp.kernel_point_optimization_gd(15, 3, fixed, num_kernels=6, seed=3)
    np.testing.assert_array_equal(
        tkp.kernel_point_optimization_gd(15, 3, fixed, num_kernels=6, seed=3), want)


@pytest.mark.parametrize("random_init,seed", [(True, 11), (False, 0)])
def test_load_kernels_bit_for_bit(random_init, seed):
    """The Lloyd disposition rotated and jittered (``method="gd"`` runs the
    same steps on the optimizer's points, held above at a smaller size)."""
    kw = dict(random_init=random_init, seed=seed)
    np.testing.assert_array_equal(tkp.load_kernels(0.125, 15, 3, "center", **kw),
                                  jkp.load_kernels(0.125, 15, 3, "center", **kw))


# 2. Morton codes --------------------------------------------------------------

def test_morton3_bit_for_bit_and_hierarchical():
    rng = np.random.default_rng(0)
    v = rng.integers(0, 1024, (4096, 3)).astype(np.int32)
    v[:8] = [[0, 0, 0], [1023, 1023, 1023], [1, 0, 0], [0, 1, 0], [0, 0, 1], [1023, 0, 0],
             [0, 1023, 0], [0, 0, 1023]]
    got = tk._morton3(torch.from_numpy(v))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jk._morton3(jnp.asarray(v))))
    assert int(got.max()) < 1 << 30
    np.testing.assert_array_equal(tk._morton3(torch.from_numpy(v >> 1)).numpy(),
                                  got.numpy() >> 3)


# 3. grid subsampling and the pyramid -----------------------------------------

def morton_np(v):
    def spread(x):
        x = x & 0x3FF
        for shift, mask in ((16, 0x30000FF), (8, 0x300F00F), (4, 0x30C30C3), (2, 0x9249249)):
            x = (x | (x << shift)) & mask
        return x
    return (spread(v[..., 0]) << 2) | (spread(v[..., 1]) << 1) | spread(v[..., 2])


def voxel_means_f64(pc, dl, capacity, valid=None):
    """The float64 centroids and the valid mask that ``grid_subsample_fixed``
    should return, from an independent numpy reading of it: f32 voxel
    indices (a true f32 division), Morton keys, a stable sort, the
    stratified pick of ranks, and each voxel's mean in float64. Also the
    rounding scale of each centroid: ``2·sqrt(N)·2^-24·max|P| / count``."""
    B, N, _ = pc.shape
    R = 4.0
    K = int(2 * R / dl) + 2
    v = np.floor(pc / np.float32(dl)).astype(np.int64) + int(R / dl)
    key = morton_np(np.clip(v, 0, K - 1))
    if valid is not None:
        key = np.where(valid > 0, key, 1 << 30)
    out = np.zeros((B, capacity, 3))
    mask = np.zeros((B, capacity))
    scale = np.zeros((B, capacity))
    for b in range(B):
        order = np.argsort(key[b], kind="stable")
        k, p = key[b][order], pc[b][order].astype(np.float64)
        real = k < (1 << 30)
        prefix = np.max(np.abs(np.cumsum(p[real], axis=0)), initial=0.0)
        uniq, starts, counts = np.unique(k[real], return_index=True, return_counts=True)
        n_vox = len(uniq)
        i = np.arange(capacity)
        take = (i * n_vox) // capacity if n_vox > capacity else np.minimum(i, max(n_vox - 1, 0))
        for slot in range(min(n_vox, capacity)):
            r = take[slot]
            out[b, slot] = p[starts[r]:starts[r] + counts[r]].mean(0)
            scale[b, slot] = 2.0 * np.sqrt(N) * EPS32 * prefix / counts[r]
        mask[b, :min(n_vox, capacity)] = 1.0
        out[b, n_vox:] = (1e6 + 10.0 * np.arange(capacity, dtype=np.float32))[n_vox:, None]
    return out, mask, scale


def check_subsample(got, got_valid, want, want_valid, scale):
    np.testing.assert_array_equal(got_valid, want_valid)
    real = want_valid > 0
    err = np.abs(np.asarray(got, np.float64) - want).max(-1)
    assert (err[real] <= scale[real]).all(), (err[real].max(), scale[real].min())
    np.testing.assert_array_equal(np.asarray(got)[~real], want[~real])  # the sentinels
    return err[real].max()


def lattice_clouds(dl):
    """Points on voxel faces i·dl (as f32) and one ulp either side; one ulp
    from the face at 0 is a subnormal."""
    rng = np.random.default_rng(4)
    base = (rng.integers(-8, 8, (2, 80, 3)) * np.float32(dl)).astype(np.float32)
    up = np.nextafter(base, np.float32(np.inf))
    down = np.nextafter(base, np.float32(-np.inf))
    return np.concatenate([base, up, down], axis=1)


SUBSAMPLE_CASES = {
    "random": (lambda rng: unit_clouds(rng, 3, 512), 0.1, 384, None),
    "positive": (lambda rng: unit_clouds(rng, 2, 512, positive=True), 0.1, 256, None),
    "overflow": (lambda rng: unit_clouds(rng, 2, 512), 0.05, 64, None),
    "valid mask": (lambda rng: unit_clouds(rng, 2, 512), 0.2, 128,
                   lambda rng: (rng.random((2, 512)) < 0.6).astype(np.float32)),
    "empty cloud": (lambda rng: unit_clouds(rng, 2, 64), 0.2, 16,
                    lambda rng: np.stack([np.zeros(64), np.ones(64)]).astype(np.float32)),
    "lattice": (lambda rng: lattice_clouds(0.1), 0.1, 256, None),
    "lattice coarse": (lambda rng: lattice_clouds(0.1), 0.2, 128, None),
}


@pytest.mark.parametrize("case", list(SUBSAMPLE_CASES))
def test_grid_subsample_fixed(case):
    make, dl, cap, make_valid = SUBSAMPLE_CASES[case]
    rng = np.random.default_rng(1)
    pc = make(rng)
    valid = None if make_valid is None else make_valid(rng)
    want, want_valid, scale = voxel_means_f64(pc, dl, cap, valid)
    got, got_valid = tk.grid_subsample_fixed(t(pc), dl, cap, None if valid is None else t(valid))
    j_out, j_valid = jax.jit(lambda p, v: jk.grid_subsample_fixed(p, dl, cap, v))(
        pc, None if valid is None else jnp.asarray(valid))
    port_err = check_subsample(got.numpy(), got_valid.numpy(), want, want_valid, scale)
    # XLA on the CPU flushes subnormals to zero, so its floor puts a point one
    # ulp below 0 in voxel 0; PyTorch, numpy and the card keep IEEE subnormals
    flushed = np.where(np.abs(pc) < np.finfo(np.float32).tiny, np.float32(0), pc)
    want, want_valid, scale = voxel_means_f64(flushed, dl, cap, valid)
    jax_err = check_subsample(np.asarray(j_out), np.asarray(j_valid), want, want_valid, scale)
    print(f"{case}: centroids from float64, port {port_err:.3e}, JAX {jax_err:.3e}")


def test_pre_sorted_equals_sorted_path():
    """A level's output fed to the next, aligned level: the sort skipped and
    the sort run give the same centroids and masks bit for bit."""
    pc = t(unit_clouds(np.random.default_rng(2), 3, 1024))
    p1, v1 = tk.grid_subsample_fixed(pc, 0.1, 512)
    for pre_sorted in (False, True):
        out, valid = tk.grid_subsample_fixed(p1, 0.2, 256, v1, pre_sorted=pre_sorted)
        if pre_sorted:
            assert torch.equal(out, ref[0]) and torch.equal(valid, ref[1])
        ref = (out, valid)


def neighbour_rows_differ(s_pts, q_pts, radius, a, b, q_valid):
    """Valid query rows where two (idx, mask) pairs differ, each checked to
    be a radius tie: a point of the union of the two sets within
    ``TIE_REL``·r² of the radius (float64). Returns the count."""
    (ia, ma), (ib, mb) = [(np.asarray(i), np.asarray(m)) for i, m in (a, b)]
    rows = ((ma != mb) | ((ia != ib) & (ma > 0))).any(-1) & (q_valid > 0)
    s64, q64, r2 = s_pts.astype(np.float64), q_pts.astype(np.float64), radius**2
    for bi, qi in zip(*np.nonzero(rows)):
        sa = set(ia[bi, qi][ma[bi, qi] > 0]) ^ set(ib[bi, qi][mb[bi, qi] > 0])
        d2 = ((s64[bi, sorted(sa)] - q64[bi, qi]) ** 2).sum(-1)
        assert (np.abs(d2 - r2) <= TIE_REL * r2).all(), (bi, qi, d2, r2)
    return int(rows.sum())


def test_radius_neighbors_masked_sets():
    rng = np.random.default_rng(3)
    s = unit_clouds(rng, 2, 512)
    q = s[:, ::3].copy()
    for radius, k in ((0.125, 24), (0.25, 24), (0.5, 16), (2.0, 600)):
        got = tk.radius_neighbors_masked(radius, k, t(s), t(q))
        want = jax.jit(lambda a, b: jk.radius_neighbors_masked(radius, k, a, b))(s, q)
        assert got[0].shape == want[0].shape == (2, q.shape[1], min(k, 512))
        n = neighbour_rows_differ(s, q, radius, got, want, np.ones(q.shape[:2]))
        print(f"r={radius}, k={k}: {n} rows differ (each a radius tie)")


def compare_pyramids(pc, cfg_overrides):
    cfg = dict(jk.KPCONV_DEFAULTS, **cfg_overrides)
    want = jax.jit(lambda p: jk.build_pyramid(p, cfg))(pc)
    got = tk.build_pyramid(t(pc), tk.kpconv_config(cfg_overrides))
    r0 = cfg["grid_dl"] * cfg["conv_radius"]
    differ = 0
    for lvl in range(cfg["num_layers"]):
        np.testing.assert_array_equal(got["valid"][lvl].numpy(), np.asarray(want["valid"][lvl]))
        valid = np.asarray(want["valid"][lvl])
        jp, tp = np.asarray(want["points"][lvl]), got["points"][lvl].numpy()
        assert np.abs(jp - tp)[valid > 0].max() <= 1e-4
        # the neighbour and pool queries on JAX's points, so only the query differs
        for which, q_lvl in (("neighbors", lvl), ("pools", lvl + 1)):
            if which == "pools" and lvl + 1 == cfg["num_layers"]:
                continue
            k = np.asarray(want[which][lvl][0]).shape[-1]
            q_pts = np.asarray(want["points"][q_lvl])
            mine = tk.radius_neighbors_masked(r0 * 2**lvl, k, t(jp), t(q_pts))
            differ += neighbour_rows_differ(jp, q_pts, r0 * 2**lvl, mine, want[which][lvl],
                                            np.asarray(want["valid"][q_lvl]))
        # and each side's own pyramid: equal off ties
        assert np.abs(np.asarray(want["neighbors"][lvl][1]).sum(-1)
                      - got["neighbors"][lvl][1].numpy().sum(-1))[valid > 0].sum() <= 2
    return got, want, differ


@pytest.mark.parametrize("overrides", [{}, {"grid_dl": 0.03}], ids=["defaults", "misaligned dl"])
def test_build_pyramid(overrides):
    pc = unit_clouds(np.random.default_rng(5), 2, 1024)
    got, want, differ = compare_pyramids(pc, overrides)
    print(f"{overrides}: neighbour rows differing (ties): {differ}")
    # each level's centroids from its own input: within the prefix-sum bound
    cfg = tk.kpconv_config(overrides)
    for lvl in range(1, cfg["num_layers"]):
        prev, prev_valid = got["points"][lvl - 1].numpy(), got["valid"][lvl - 1].numpy()
        cap = got["points"][lvl].shape[1]
        ref, ref_valid, scale = voxel_means_f64(prev, cfg["grid_dl"] * 2**lvl, cap, prev_valid)
        check_subsample(got["points"][lvl].numpy(), got["valid"][lvl].numpy(), ref, ref_valid,
                        scale)


def test_occupancy_means_and_warnings(caplog):
    pc = unit_clouds(np.random.default_rng(6), 8, 1024)
    logger = logging.getLogger("kpconv-occupancy")
    with caplog.at_level(logging.INFO, logger="kpconv-occupancy"):
        got = tk.check_neighbor_occupancy(pc, {"NEIGHBOR_LIMITS": [24, 24, 16, 16, 8]},
                                          logger=logger)
    want = jk.check_neighbor_occupancy(pc, {"NEIGHBOR_LIMITS": [24, 24, 16, 16, 8]})
    np.testing.assert_allclose(got, want, rtol=1e-6)
    text = caplog.text
    assert "KPConv pyramid occupancy (mean valid neighbors/level): L0=" in text
    assert "SATURATES" in text  # K=16 at level 2 and K=8 at level 4 saturate


# 5. the op, the norm, the blocks -----------------------------------------------

def op_inputs(seed=7, b=2, n=256, cin=8):
    rng = np.random.default_rng(seed)
    s = unit_clouds(rng, b, n)
    q = s[:, : n // 2].copy()
    idx, mask = tk.radius_neighbors_masked(0.25, 16, t(s), t(q))
    x = rng.normal(size=(b, n, cin)).astype(np.float32)
    return s, q, idx.numpy(), mask.numpy(), x


def port_and_jax_grads(op, jop, jparams, args, x, cot):
    """The op's values and the gradients of sum(out · cot) for its weights
    and for x, in the port and in the JAX package; ``args`` are (q_pts,
    s_pts, idx, mask) as numpy."""
    xt = t(x).requires_grad_(True)
    out = op(t(args[0]), t(args[1]), torch.from_numpy(args[2]), t(args[3]), xt)
    (out * t(cot)).sum().backward()

    def f(params, xv, jargs):  # inputs as arguments: XLA folds constants slowly
        o = jop.apply({"params": params}, *jargs, xv)
        return jnp.sum(o * cot), o

    (_, jout), (jg, jgx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        jparams, x, [jnp.asarray(a) for a in args])
    return out.detach().numpy(), np.asarray(jout), xt.grad.numpy(), np.asarray(jgx), jg


def rel_l2(a, b):
    return np.linalg.norm(np.asarray(a, np.float64) - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("influence", ["constant", "linear", "gaussian"])
@pytest.mark.parametrize("aggregation", ["sum", "closest"])
def test_kpconv_op(influence, aggregation):
    s, q, idx, mask, x = op_inputs()
    radius, ext = 0.25, 0.12
    op = tk.KPConvOp(8, 12, ext, radius, 15, influence, aggregation)
    op.reset_parameters(torch.Generator().manual_seed(1))
    jop = jk.KPConvOp(12, ext, radius, 15, influence, aggregation)
    params = {"weights": op.weights.detach().numpy()}
    cot = np.random.default_rng(8).normal(size=(2, 128, 12)).astype(np.float32)
    got, want, gx, jgx, jg = port_and_jax_grads(op, jop, params, (q, s, idx, mask), x, cot)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert rel_l2(gx, jgx) <= 1e-4
    assert rel_l2(op.weights.grad.numpy(), np.asarray(jg["weights"])) <= 1e-4


def test_kpconv_op_weights_init_and_random_kernel_points():
    """flax's variance_scaling(1/3, fan_in, uniform) over (K, Cin, Cout):
    fan-in K·Cin; and kp_random_init's kernel points, seeded by kp_seed
    plus the crc32 of the JAX module path (``g/encoder/block{i}/KPConv``
    under NetMDA, ``encoder/block{i}/KPConv`` in the classifier), at each
    block's radius. ``test_torch_port_kpconv_models.py`` holds the whole
    NetMDA with kp_random_init against the JAX one."""
    op = tk.KPConvOp(32, 64, 0.06, 0.125)
    op.reset_parameters(torch.Generator().manual_seed(0))
    limit = (1.0 / (15 * 32)) ** 0.5
    w = op.weights.detach()
    assert w.abs().max() <= limit and w.abs().max() > 0.95 * limit
    assert abs(w.std().item() - limit / 3**0.5) < 0.05 * limit
    cfg = {"kp_random_init": True, "kp_seed": 3}
    arch = jk.KPCONV_DEFAULTS["architecture"]
    for encoder, prefix in ((tk.KPConvGenerator(cfg).encoder, "g/encoder"),
                            (tk.KPConvClassifier(model_cfg=cfg).encoder, "encoder")):
        for i in (0, 4, 13):
            seed = (3 + zlib.crc32(f"{prefix}/block{i}/KPConv".encode())) % (2**31)
            r = 0.125 * 2 ** sum("strided" in b for b in arch[:i])
            np.testing.assert_array_equal(
                getattr(encoder, f"block{i}").KPConv.kernel_points.numpy(),
                jkp.load_kernels(r, 15, 3, "center", random_init=True, seed=seed))


def test_instance_norm_masked():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(3, 64, 16)).astype(np.float32) * 3 + 1
    mask = (rng.random((3, 64)) < 0.7).astype(np.float32)
    mask[2] = 0.0  # a cloud with no valid row
    got = tk.instance_norm(t(x), t(mask)).numpy()
    want = np.asarray(jk.InstanceNorm().apply({}, jnp.asarray(x), jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert (got[mask == 0] == 0).all()


BLOCK_CASES = {
    "simple": ("simple", 1, 64, False),
    "resnetb unary shortcut": ("resnetb", 32, 64, False),
    "resnetb identity": ("resnetb", 64, 64, False),
    "resnetb strided": ("resnetb", 64, 64, True),
    "resnetb strided widening": ("resnetb", 32, 128, True),
}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_blocks(case):
    kind, cin, cout, strided = BLOCK_CASES[case]
    rng = np.random.default_rng(10)
    pc = unit_clouds(rng, 2, 256)
    cfg = tk.kpconv_config({"grid_capacities": (256, 96, 32, 16, 8)})
    pyr = tk.build_pyramid(t(pc), cfg)
    lvl_q = 1 if strided else 0
    idx, mask = pyr["pools"][0] if strided else pyr["neighbors"][0]
    s_pts, q_pts = pyr["points"][0].numpy(), pyr["points"][lvl_q].numpy()
    s_mask, q_mask = pyr["valid"][0].numpy(), pyr["valid"][lvl_q].numpy()
    x = rng.normal(size=(2, 256, cin)).astype(np.float32)
    radius, ext = 0.125, 0.06
    if kind == "simple":
        block = tk.SimpleBlock(cin, cout, radius, ext, cfg)
        jblock = jk.SimpleBlock(cout, radius, ext, dict(jk.KPCONV_DEFAULTS))
    else:
        block = tk.ResnetBottleneckBlock(cin, cout, radius, ext, cfg, strided=strided)
        jblock = jk.ResnetBottleneckBlock(cout, radius, ext, dict(jk.KPCONV_DEFAULTS),
                                          strided=strided)
    gen = torch.Generator().manual_seed(2)
    flax_init_(block, gen)
    tk.init_kpconv_weights_(block, gen)
    jargs = (jnp.asarray(q_pts), jnp.asarray(s_pts), jnp.asarray(idx.numpy()),
             jnp.asarray(mask.numpy()), jnp.zeros_like(jnp.asarray(x)))
    jkw = {"q_mask": jnp.asarray(q_mask)} if kind == "simple" else {
        "s_mask": jnp.asarray(s_mask), "q_mask": jnp.asarray(q_mask)}
    variables = port_weights_as_jax(jblock, block.state_dict(), *jargs, **jkw)
    load_jax_variables(block, variables)
    width = cout // 2 if kind == "simple" else cout
    cot = rng.normal(size=(2, q_pts.shape[1], width)).astype(np.float32) * q_mask[..., None]

    xt = t(x).requires_grad_(True)
    out = block(t(q_pts), t(s_pts), idx, mask, xt, t(s_mask), t(q_mask))
    (out * t(cot)).sum().backward()

    def f(params, xv, jargs, jkw):
        o = jblock.apply({"params": params}, *jargs[:4], xv, **jkw)
        return jnp.sum(o * cot), o

    (_, jout), (jg, jgx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        variables["params"], x, jargs, jkw)
    valid = q_mask > 0
    np.testing.assert_allclose(out.detach().numpy()[valid], np.asarray(jout)[valid], atol=1e-5,
                               rtol=1e-5)
    assert rel_l2(xt.grad.numpy(), np.asarray(jgx)) <= 1e-4
    want = jax_grads_by_name(jg)
    for name, p in block.named_parameters():
        assert rel_l2(p.grad.numpy(), want[name]) <= 1e-4, name


# 6. refusals ---------------------------------------------------------------------

def test_refusals_name_their_roadmap_items():
    """The FPS pyramid and deformable blocks build (any ``pyramid`` but
    "grid" is the FPS one, as in the JAX package); KPConv under bf16,
    deformable or not, names item 17c."""
    assert tk.kpconv_config({"pyramid": "fps"})["pyramid"] == "fps"
    arch = list(jk.KPCONV_DEFAULTS["architecture"])
    arch[3] = "resnetb_deformable"
    gen = tk.KPConvGenerator({"architecture": tuple(arch), "pyramid": "random"})
    assert gen.encoder.block3.KPConv.offset_conv is not None
    assert gen.encoder.block4.KPConv.offset_conv is None
    assert gen.node_rows(128) == 32 and gen.node_rows(1024) == 64
    with pytest.raises(NotImplementedError, match="item 17c"):
        set_compute_dtype(tk.KPConvClassifier(), torch.bfloat16)
    for cfg in ({"grid_capacities": (64, 32, 16, 8, 4)},
                {"pyramid": "fps", "architecture": tuple(arch)}):
        model = NetMDA("KPConv", model_cfg=cfg)
        with pytest.raises(NotImplementedError, match="item 17c"):
            model.set_compute_dtype(torch.bfloat16)
        model.set_compute_dtype(None)  # f32 stays allowed
