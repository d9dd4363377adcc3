"""Deformable KPConv in the port (``sug_tpu_torch/models/kpconv.py``)
against the JAX package on the CPU:

1. the deformable ``KPConvOp`` against flax's ``apply(...,
   mutable=["regularizers"])``: its output, the sown terms (min_d2 / ext²,
   the moved kernel points / ext, q_mask), the regularizer of those terms,
   and the gradients of ``weights``, ``offset_conv/weights``,
   ``offset_bias`` and the input features of ``sum(out · cot) +
   regularizer``, for the linear, gaussian and constant influences, the
   closest aggregation and the modulated op, on an FPS pyramid's pool
   queries (no mask) and on a grid pyramid's (pad query rows with no
   neighbour and the sown ``q_mask``);
2. ``p2p_fitting_regularizer`` against the JAX one over two layers, one
   masked and one not, its value and gradients in float64;
3. a deformable simple block on the grid pyramid and a deformable strided
   resnet block on the FPS pyramid, outputs, terms and gradients;
4. the strict bridge load of a deformable, modulated ``NetMDA`` tree:
   ``.../KPConv/offset_conv/weights`` and ``.../KPConv/offset_bias`` fill
   the port's names, and nothing is left over on either side.

Tolerances, as the rigid op's (``tests/test_torch_port_kpconv.py``): on
identical inputs the values within 1e-5 absolute + 1e-5 relative, the
gradients within 1e-4 relative L2 (the two libraries order the f32 sums of
their contractions differently); the regularizer in float64 within 1e-12.
The learned offsets make the in-range count and the nearest neighbour
depend on rounding only at ties (|sq_d − ext²| or a second nearest within
an ulp), which these random clouds do not hold.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sug_tpu.models import kpconv as jk
from sug_tpu.models.net_mda import NetMDA as JNetMDA
from sug_tpu_torch.models import kpconv as tk
from sug_tpu_torch.models.layers import flax_init_
from sug_tpu_torch.models.net_mda import NetMDA
from sug_tpu_torch.utils.jax_bridge import load_jax_variables, state_dict_from_jax
from tests._torch_port_common import (  # noqa: F401
    jax_grads_by_name,
    one_torch_thread,
    port_weights_as_jax,
    t,
)
from tests.test_torch_port_kpconv import unit_clouds

RADIUS, EXT = 0.25, 0.12
VALUE_TOL = 1e-5
GRAD_REL_L2 = 1e-4
F64_TOL = 1e-12
# the pyramids of the op inputs: the FPS one from given starts, the grid one
# with capacities that leave pad rows at level 1
FPS_CFG = {"pyramid": "fps"}
GRID_CFG = {"grid_capacities": (256, 256, 64, 32, 16)}
# influence, aggregation, modulated
OP_CASES = {
    "linear": ("linear", "sum", False),
    "gaussian": ("gaussian", "sum", False),
    "constant": ("constant", "sum", False),
    "closest": ("linear", "closest", False),
    "modulated": ("linear", "sum", True),
}


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def pool_inputs(pyramid, seed=7, cin=8):
    """Level 0 of a pyramid of 2 clouds of 256 points as the sources, level
    1 as the queries, their radius query at RADIUS, and random features:
    numpy (q, s, idx, mask, q_mask or None, x). The FPS pyramid's queries
    are all valid; the grid one's level 1 holds pad rows at far sentinels,
    whose neighbour masks are all zero."""
    rng = np.random.default_rng(seed)
    pc = unit_clouds(rng, 2, 256)
    if pyramid == "fps":
        pyr = tk.build_pyramid(t(pc), tk.kpconv_config(FPS_CFG), torch.tensor([3, 200]))
        q_mask = None
    else:
        pyr = tk.build_pyramid(t(pc), tk.kpconv_config(GRID_CFG))
        q_mask = pyr["valid"][1].numpy()
        assert 0 < q_mask.sum() < q_mask.size
    s, q = pyr["points"][0], pyr["points"][1]
    idx, mask = tk.radius_neighbors_masked(RADIUS, 16, s, q)
    x = rng.normal(size=(2, 256, cin)).astype(np.float32)
    return q.numpy(), s.numpy(), idx.numpy(), mask.numpy(), q_mask, x


def randomize_offset_bias(module, seed):
    """Every ``offset_bias`` of ``module`` drawn small and non-zero (flax
    inits them to zeros), so its path is exercised."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("offset_bias"):
                p.copy_(torch.from_numpy(rng.normal(0.0, 0.1, p.shape).astype(np.float32)))


def port_params_as_jax(module):
    """The port module's parameters as a flax params tree (numpy), by the
    bridge's names: ``a.b.weights`` -> ``{"a": {"b": {"weights": ...}}}``."""
    tree = {}
    for name, p in module.named_parameters():
        *parents, leaf = name.split(".")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = p.detach().numpy().copy()
    return tree


def sown_terms(sown):
    """A flax ``regularizers`` collection of one layer as the port's
    ``(min_d2, kp, q_mask or None)``."""
    return (np.asarray(sown["min_d2_over_ext2"][0]), np.asarray(sown["deformed_kp_over_ext"][0]),
            None if "q_mask" not in sown else np.asarray(sown["q_mask"][0]))


def check_terms(got, want, q_mask):
    """One op's terms: min_d2 on every row (zero on pad rows), the moved
    kernel points on the valid rows, the mask itself."""
    m, kp, qm = got
    wm, wkp, wqm = want
    np.testing.assert_allclose(m.detach().numpy(), wm, atol=VALUE_TOL, rtol=VALUE_TOL)
    rows = slice(None) if q_mask is None else q_mask > 0
    np.testing.assert_allclose(kp.detach().numpy()[rows], wkp[rows], atol=VALUE_TOL,
                               rtol=VALUE_TOL)
    if q_mask is None:
        assert qm is None and wqm is None
    else:
        np.testing.assert_array_equal(qm.numpy(), wqm)
        assert (m.detach().numpy()[q_mask == 0] == 0).all()


# 1. the deformable op ------------------------------------------------------------

@pytest.mark.parametrize("pyramid", ["fps", "grid"])
@pytest.mark.parametrize("case", list(OP_CASES))
def test_deformable_op(case, pyramid):
    influence, aggregation, modulated = OP_CASES[case]
    q, s, idx, mask, q_mask, x = pool_inputs(pyramid)
    op = tk.KPConvOp(8, 12, EXT, RADIUS, 15, influence, aggregation, deformable=True,
                     modulated=modulated, path="op")
    tk.init_kpconv_weights_(op, torch.Generator().manual_seed(1))
    randomize_offset_bias(op, 2)
    assert op.offset_conv.weights.shape == (15, 8, (4 if modulated else 3) * 15)
    params = port_params_as_jax(op)
    load_jax_variables(op, {"params": params})  # the strict names both ways
    jop = jk.KPConvOp(12, EXT, RADIUS, 15, influence, aggregation, deformable=True,
                      modulated=modulated)
    rng = np.random.default_rng(8)
    cot = rng.normal(size=(2, q.shape[1], 12)).astype(np.float32)
    if q_mask is not None:
        cot *= q_mask[..., None]

    xt = t(x).requires_grad_(True)
    terms = []
    out = op(t(q), t(s), torch.from_numpy(idx), t(mask), xt,
             None if q_mask is None else t(q_mask), terms)
    assert len(terms) == 1
    reg = tk.p2p_fitting_regularizer(terms)
    ((out * t(cot)).sum() + reg).backward()

    def f(params, xv, args, qm):
        o, state = jop.apply({"params": params}, *args, xv, q_mask=qm, mutable=["regularizers"])
        r = jk.p2p_fitting_regularizer(state["regularizers"])
        return jnp.sum(o * cot) + r, (o, state["regularizers"], r)

    (_, (jout, sown, jreg)), (jg, jgx) = jax.jit(
        jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        params, x, [jnp.asarray(a) for a in (q, s, idx, mask)],
        None if q_mask is None else jnp.asarray(q_mask))
    rows = slice(None) if q_mask is None else q_mask > 0
    np.testing.assert_allclose(out.detach().numpy()[rows], np.asarray(jout)[rows],
                               atol=VALUE_TOL, rtol=VALUE_TOL)
    check_terms(terms[0], sown_terms(sown), q_mask)
    np.testing.assert_allclose(reg.item(), float(jreg), rtol=VALUE_TOL)
    assert reg.item() > 0
    assert rel_l2(xt.grad, jgx) <= GRAD_REL_L2
    want = {"weights": jg["weights"], "offset_conv.weights": jg["offset_conv"]["weights"],
            "offset_bias": jg["offset_bias"]}
    for name, p in op.named_parameters():
        gap = rel_l2(p.grad, want[name])
        print(f"{case} {pyramid} {name}: {gap:.3e}")
        assert gap <= GRAD_REL_L2, name


def test_op_without_terms_is_the_same_op():
    """Without a ``terms`` list the op computes the same output (the
    regularizer's terms are only gathered where asked for), and the
    deformable op with zero offsets is the rigid op but for its count of
    in-range neighbours."""
    q, s, idx, mask, _, x = pool_inputs("fps")
    args = (t(q), t(s), torch.from_numpy(idx), t(mask), t(x))
    op = tk.KPConvOp(8, 12, EXT, RADIUS, deformable=True)
    tk.init_kpconv_weights_(op, torch.Generator().manual_seed(3))
    with torch.no_grad():
        a = op(*args)
        terms = []
        b = op(*args, None, terms)
        assert torch.equal(a, b) and len(terms) == 1
        op.offset_conv.weights.zero_()
        rigid = tk.KPConvOp(8, 12, EXT, RADIUS)
        rigid.weights.copy_(op.weights)
        moved = op(*args)
        fixed = rigid(*args)
    # the rigid op divides by every valid neighbour, the deformable one by
    # those within EXT of a kernel point: the same numerator
    nb = s[np.arange(2)[:, None, None], idx] - q[:, :, None]  # (B, Q, k, 3)
    kp = op.kernel_points.numpy()
    d2 = (nb**2).sum(-1)[..., None] - 2 * np.einsum("bqkc,pc->bqkp", nb, kp) + (kp**2).sum(-1)
    in_range = (d2 < EXT**2).any(-1) * mask
    ratio = np.maximum(mask.sum(-1), 1) / np.maximum(in_range.sum(-1), 1)
    np.testing.assert_allclose(moved.numpy(), fixed.numpy() * ratio[..., None], rtol=1e-5,
                               atol=1e-6)
    assert (ratio > 1).any()


# 2. the regularizer -------------------------------------------------------------------

def test_regularizer_masked_and_unmasked():
    """Two layers, the second with a q_mask, some kernel points close enough
    (within 1.2 ext) that the repulsive term is on: value and the gradients
    of min_d2 and the kernel points, float64 on both sides."""
    rng = np.random.default_rng(11)
    layers = []
    for q, masked in ((12, False), (9, True)):
        m = rng.uniform(0.0, 2.0, size=(2, q, 15))
        kp = rng.normal(0.0, 0.7, size=(2, q, 15, 3))
        qm = (rng.uniform(size=(2, q)) < 0.7).astype(np.float64) if masked else None
        if masked:
            m *= qm[..., None]
        layers.append((m, kp, qm))

    def jax_reg(leaves):
        sown = {}
        for i, (m, kp, qm) in enumerate(leaves):
            sown[f"block{i}"] = {"KPConv": {"min_d2_over_ext2": (m,),
                                            "deformed_kp_over_ext": (kp,)}}
            if qm is not None:
                sown[f"block{i}"]["KPConv"]["q_mask"] = (qm,)
        return jk.p2p_fitting_regularizer(sown)

    with jax.enable_x64():
        args = [(jnp.asarray(m), jnp.asarray(kp), None if qm is None else jnp.asarray(qm))
                for m, kp, qm in layers]
        want, jgrads = jax.value_and_grad(
            lambda a: jax_reg([(m, kp, qm) for (m, kp), (_, _, qm) in zip(a, args)]))(
            [(m, kp) for m, kp, _ in args])
    tensors = [(torch.from_numpy(m).requires_grad_(True), torch.from_numpy(kp).requires_grad_(True),
                None if qm is None else torch.from_numpy(qm)) for m, kp, qm in layers]
    got = tk.p2p_fitting_regularizer(tensors)
    got.backward()
    assert abs(got.item() - float(want)) <= F64_TOL * abs(float(want))
    for (m, kp, _), (jm, jkp) in zip(tensors, jgrads):
        np.testing.assert_allclose(m.grad.numpy(), np.asarray(jm), rtol=1e-10, atol=F64_TOL)
        np.testing.assert_allclose(kp.grad.numpy(), np.asarray(jkp), rtol=1e-10, atol=F64_TOL)
    # the repulsive term is on, and each term counts
    assert tk.p2p_fitting_regularizer([(tensors[0][0] * 0, tensors[0][1], None)]).item() > 0
    assert tk.p2p_fitting_regularizer(tensors, deform_fitting_power=2.0).item() == \
        pytest.approx(2 * got.item(), rel=1e-14)


# 3. the blocks --------------------------------------------------------------------

BLOCK_CASES = {
    # kind, pyramid, in, out, strided
    "simple on the grid pyramid": ("simple", "grid", 4, 32, False),
    "resnetb strided on the FPS pyramid": ("resnetb", "fps", 32, 64, True),
}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_deformable_blocks(case):
    kind, pyramid, cin, cout, strided = BLOCK_CASES[case]
    rng = np.random.default_rng(12)
    pc = unit_clouds(rng, 2, 256)
    overrides = dict(GRID_CFG if pyramid == "grid" else FPS_CFG, modulated=kind == "simple")
    cfg = tk.kpconv_config(overrides)
    jcfg = dict(jk.KPCONV_DEFAULTS, **overrides)
    pyr = tk.build_pyramid(t(pc), cfg, torch.tensor([0, 9]))
    lvl_q = 1 if strided else 0
    idx, mask = pyr["pools"][0] if strided else pyr["neighbors"][0]
    s_pts, q_pts = pyr["points"][0].numpy(), pyr["points"][lvl_q].numpy()
    valid = pyr["valid"]
    s_mask = None if valid is None else valid[0].numpy()
    q_mask = None if valid is None else valid[lvl_q].numpy()
    x = rng.normal(size=(2, 256, cin)).astype(np.float32)
    radius, ext = 0.125, 0.06
    if kind == "simple":
        block = tk.SimpleBlock(cin, cout, radius, ext, cfg, deformable=True)
        jblock = jk.SimpleBlock(cout, radius, ext, jcfg, deformable=True)
    else:
        block = tk.ResnetBottleneckBlock(cin, cout, radius, ext, cfg, strided=strided,
                                         deformable=True)
        jblock = jk.ResnetBottleneckBlock(cout, radius, ext, jcfg, strided=strided,
                                          deformable=True)
    gen = torch.Generator().manual_seed(2)
    flax_init_(block, gen)
    tk.init_kpconv_weights_(block, gen)
    randomize_offset_bias(block, 3)
    jq = None if q_mask is None else jnp.asarray(q_mask)
    jargs = (jnp.asarray(q_pts), jnp.asarray(s_pts), jnp.asarray(idx.numpy()),
             jnp.asarray(mask.numpy()), jnp.zeros_like(jnp.asarray(x)))
    jkw = {"q_mask": jq} if kind == "simple" else {
        "s_mask": None if s_mask is None else jnp.asarray(s_mask), "q_mask": jq}
    variables = port_weights_as_jax(jblock, block.state_dict(), *jargs, **jkw)
    load_jax_variables(block, variables)
    assert "offset_bias" in variables["params"]["KPConv"]
    width = cout // 2 if kind == "simple" else cout
    cot = rng.normal(size=(2, q_pts.shape[1], width)).astype(np.float32)
    if q_mask is not None:
        cot *= q_mask[..., None]

    xt = t(x).requires_grad_(True)
    terms = []
    out = block(t(q_pts), t(s_pts), idx, mask, xt, None if s_mask is None else t(s_mask),
                None if q_mask is None else t(q_mask), terms)
    reg = tk.p2p_fitting_regularizer(terms)
    ((out * t(cot)).sum() + reg).backward()

    def f(params, xv, jargs, jkw):
        o, state = jblock.apply({"params": params}, *jargs[:4], xv, **jkw,
                                mutable=["regularizers"])
        r = jk.p2p_fitting_regularizer(state["regularizers"])
        return jnp.sum(o * cot) + r, (o, state["regularizers"], r)

    (_, (jout, sown, jreg)), (jg, jgx) = jax.jit(
        jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(variables["params"], x, jargs, jkw)
    rows = slice(None) if q_mask is None else q_mask > 0
    np.testing.assert_allclose(out.detach().numpy()[rows], np.asarray(jout)[rows],
                               atol=VALUE_TOL, rtol=VALUE_TOL)
    check_terms(terms[0], sown_terms(sown["KPConv"]), q_mask)
    np.testing.assert_allclose(reg.item(), float(jreg), rtol=VALUE_TOL)
    assert rel_l2(xt.grad, jgx) <= GRAD_REL_L2
    want = jax_grads_by_name(jg)
    for name, p in block.named_parameters():
        assert rel_l2(p.grad, want[name]) <= GRAD_REL_L2, name


# 4. the bridge --------------------------------------------------------------------------

SLICE_ARCH = ["simple", "resnetb", "resnetb_strided", "resnetb", "resnetb", "resnetb_strided",
              "resnetb", "resnetb", "resnetb_strided", "resnetb_deformable",
              "resnetb_deformable", "resnetb_deformable_strided", "resnetb_deformable",
              "resnetb_deformable"]


def test_bridge_loads_deformable_tree_strictly():
    cfg = {"pyramid": "fps", "ARCHITECTURE": SLICE_ARCH, "first_feats_dim": 16,
           "MODULATED": True}
    port = NetMDA("KPConv", generator=torch.Generator().manual_seed(0), num_points=512,
                  model_cfg=cfg)
    randomize_offset_bias(port, 4)
    jmodel = JNetMDA(model_name="KPConv", model_cfg=cfg)
    variables = port_weights_as_jax(jmodel, port.state_dict(), jnp.zeros((2, 512, 3)), True,
                                    domain="both")
    deform = variables["params"]["g"]["encoder"]["block11"]["KPConv"]
    assert deform["offset_conv"]["weights"].shape == (15, 32, 60)
    assert deform["offset_bias"].shape == (60,)
    state = state_dict_from_jax(variables)
    names = [k for k in state if "offset" in k]
    assert len(names) == 2 * 5 and "g.encoder.block11.KPConv.offset_conv.weights" in names
    fresh = NetMDA("KPConv", num_points=512, model_cfg=cfg)
    load_jax_variables(fresh, variables)  # strict: nothing left over either way
    for name in names:
        assert torch.equal(fresh.state_dict()[name], port.state_dict()[name]), name
    with pytest.raises(RuntimeError, match="offset_bias"):
        del variables["params"]["g"]["encoder"]["block9"]["KPConv"]["offset_bias"]
        load_jax_variables(fresh, variables)
