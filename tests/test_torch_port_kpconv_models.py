"""KPConv's models in the port (``KPConvGenerator``, ``KPConvClassifier``,
``NetMDA("KPConv")`` with its ``KPConvHead``s) against the JAX package on
the CPU, with the JAX tree filled from the port's init (``load_jax_variables``
both ways through the bridge):

1. ``KPConvGenerator`` at a reduced size (B=2, N=256, capacities (256, 128,
   64, 32, 16), ``first_feats_dim`` 16): the forward on each package's own
   pyramid, then on the JAX pyramid replayed into the port
   (``replayed_pyramid``), forward and the parameters' gradients;
2. pad rows leak nowhere: with every pad query's neighbour set scrambled,
   the generator's global feature, node features and gradients are equal
   bit for bit, and more pad capacity leaves the global feature as it was;
3. ``KPConvClassifier`` at its defaults, B=2, N=128: logits and mid feature,
   and the gradients of a cross entropy on the replayed pyramid;
4. ``NetMDA("KPConv")`` with a ``MODEL_CFG`` (reduced capacities, six
   blocks, the gaussian influence, ``kp_random_init`` with a seed) in train
   mode, per domain and stacked, and its attentions' BN statistics, in
   float64 on the JAX pyramid (within 1e-9 relative L2; measured 1e-12).

Tolerances, each with its cause. On each package's own pyramid the
centroids differ by a few ulps of the prefix sums (three summation orders,
``tests/test_torch_port_kpconv.py``; XLA's even changes with whether the
cloud is a constant of the compiled function) and the 14 blocks of
instance norms carry that forward, most at the last levels, whose norms
run over 16 to 48 rows: features within 1e-3 relative L2 (measured up to
1.1e-4), and at 256 points one radius query at level 1 may fall on the
other side of a tie, which moves the final features by 1e-2 (the NetMDA
test's clouds do). So the exact checks run both packages on the JAX
package's pyramid: the port in float64 against the JAX package in float64
(``jax_on_pyramid``) within 1e-9 relative L2, values and gradients
(measured 2.4e-13); the port in f32 within 1e-4 relative L2 of it in
values (measured up to 2.5e-5 at full width) and of it per gradient leaf
(a leaf zero up to rounding against 1e-2 of the largest; measured up to
1.1e-4, the JAX package's own f32 gradients lying 8.6e-5 from its f64
ones).
"""

from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sug_tpu.models import bn as jbn
from sug_tpu.models import kpconv as jk
from sug_tpu.models import layers as jl
from sug_tpu.ops import geometry as jgeo
from sug_tpu.models import make_classifier as j_make_classifier
from sug_tpu.models.net_mda import NetMDA as JNetMDA
from sug_tpu_torch.models import kpconv as tk
from sug_tpu_torch.models import make_classifier
from sug_tpu_torch.models.net_mda import NetMDA
from sug_tpu_torch.utils.jax_bridge import load_jax_variables, torch_key
from tests.test_torch_port_pointnet2_dg import _JnpF64
from tests._torch_port_common import (  # noqa: F401
    assert_rel_l2,
    one_torch_thread,
    port_weights_as_jax,
    t,
)

SMALL = {"grid_capacities": (256, 128, 64, 32, 16), "first_feats_dim": 16}
OWN_PYRAMID_REL_L2 = 1e-3
REPLAYED_REL_L2 = 1e-4
F32_GRAD_REL_L2 = 1e-3
F64_REL_L2 = 1e-9


def unit_clouds(seed, b, n):
    rng = np.random.default_rng(seed)
    pc = rng.normal(size=(b, n, 3)) * rng.uniform(0.4, 1.0, size=(b, 1, 3))
    return (pc / np.linalg.norm(pc, axis=-1).max(-1)[:, None, None]).astype(np.float32)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def jax_pyramid(pc, cfg):
    """The JAX package's pyramid of ``pc`` (numpy trees, f32 points)."""
    return jax.tree.map(np.asarray, jax.jit(lambda p: jk.build_pyramid(p, cfg))(pc))


def as_port(pyr, dtype=torch.float32):
    """A JAX pyramid as the port's tensors: floats in ``dtype``, idx int64
    (the FPS pyramid's ``valid`` None)."""
    cast = lambda a: torch.from_numpy(np.array(a)).to(dtype)  # noqa: E731
    pairs = lambda key: [(torch.from_numpy(np.array(i)).long(), cast(m))  # noqa: E731
                         for i, m in pyr[key]]
    valid = None if pyr["valid"] is None else [cast(v) for v in pyr["valid"]]
    return {"points": [cast(p) for p in pyr["points"]], "valid": valid,
            "neighbors": pairs("neighbors"), "pools": pairs("pools")}


@contextlib.contextmanager
def replayed_pyramid(monkeypatch, *pyrs):
    """The port's encoder takes ``pyrs`` (the port's tensors), one a call in
    order, instead of building its own."""
    it = iter(pyrs)
    with monkeypatch.context() as patch:
        patch.setattr(tk, "build_pyramid", lambda *args: next(it))
        yield


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64)
                        if np.issubdtype(np.asarray(a).dtype, np.floating) else np.asarray(a), tree)


def jax_on_pyramid(fn, pyrs, *args, f64=False):
    """``jax.jit(fn)(*args)`` with the JAX encoder taking the pyramids of
    the list ``pyrs``, one a call in order, instead of building its own.
    With ``f64``, in float64: the floats of ``args`` and ``pyrs`` cast,
    ``kpconv.py``, the BN, the layers and the geometry ops reading
    ``float32`` as ``float64`` (``_JnpF64``: the ``InstanceNorm``, the BN
    and the attention's gate cast to f32, the contractions and the SDA
    weights' distances ask for f32 results) and the kernel points in
    float64 (``load_kernels`` returns f32, and the op squares them)."""
    modules = (jk, jbn, jl, jgeo)

    def wrapped(pyrs, *args):
        saved = jk.build_pyramid, jk.load_kernels, [m.jnp for m in modules]
        it = iter(pyrs)
        jk.build_pyramid = lambda *a, **k: next(it)
        if f64:
            for m in modules:
                m.jnp = _JnpF64()
            jk.load_kernels = lambda *a, **k: saved[1](*a, **k).astype(np.float64)
        try:
            return fn(*args)
        finally:
            jk.build_pyramid, jk.load_kernels = saved[:2]
            for m, np_ in zip(modules, saved[2]):
                m.jnp = np_

    if not f64:
        return jax.tree.map(np.asarray, jax.jit(wrapped)(pyrs, *args))
    with jax.enable_x64():
        return jax.tree.map(lambda a: np.asarray(a, np.float64),
                            jax.jit(wrapped)(_f64(pyrs), *_f64(args)))


def jax_f64_on_pyramid(loss, params, pc, pyr):
    """``jax.value_and_grad(loss, has_aux=True)(params, pc)`` in float64 on
    ``pyr`` (``jax_on_pyramid``)."""
    return jax_on_pyramid(jax.value_and_grad(loss, has_aux=True), [pyr], params, pc, f64=True)


def grads_f64(param_grads):
    """A JAX params gradient tree as the port's names, in float64
    (``jax_grads_by_name`` rounds to f32)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(param_grads)[0]:
        names = tuple(k.key for k in path)
        out[torch_key(names)] = np.asarray(leaf, np.float64).T if names[-1] == "kernel" else \
            np.asarray(leaf, np.float64)
    return out


def grads_f64_of(model, pyr, pc, loss, monkeypatch):
    return port_on_pyramid(model, pyr, pc, loss, torch.float64, monkeypatch)[1]


def port_on_pyramid(model, pyr, pc, loss, dtype, monkeypatch):
    """The port's outputs and parameter gradients of ``loss(outputs)`` in
    ``dtype`` on the replayed pyramid, as float64 numpy; the model is left
    in float32."""
    model.to(dtype).zero_grad()
    with replayed_pyramid(monkeypatch, as_port(pyr, dtype)):
        out = model(t(pc).to(dtype))
    loss(out).backward()
    grads = {n: p.grad.double().numpy() for n, p in model.named_parameters()}
    model.to(torch.float32)
    return [o.detach().double().numpy() for o in out if o is not None], grads


# 1. the generator -----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _generator():
    port = tk.KPConvGenerator(SMALL)
    tk.init_kpconv_weights_(port, torch.Generator().manual_seed(0))
    jgen = jk.KPConvGenerator(cfg=SMALL)
    variables = port_weights_as_jax(jgen, port.state_dict(), jnp.zeros((2, 256, 3)), True)
    load_jax_variables(port, variables)
    return port, jgen, variables


def test_generator_forward_and_gradients(monkeypatch):
    port, jgen, variables = _generator()
    pc = unit_clouds(0, 2, 256)
    cot = np.random.default_rng(1).normal(size=(2, port.encoder.out_dim))

    def f(params, pc):  # the clouds an argument: XLA would fold a constant pyramid for seconds
        g, node, _ = jgen.apply({"params": params}, pc, True)
        return jnp.sum(g * cot), (g, node)

    jg, jnode = jax.jit(f)(variables["params"], pc)[1]
    with torch.no_grad():
        g, node, off = port(t(pc))
    assert off is None and node.shape == (2, 64, 16) and g.shape == (2, 256)
    own = (rel_l2(g, jg), rel_l2(node, jnode))
    print(f"own pyramids: global {own[0]:.3e}, node {own[1]:.3e}")
    assert max(own) <= OWN_PYRAMID_REL_L2

    pyr = jax_pyramid(pc, dict(jk.KPCONV_DEFAULTS, **SMALL))
    (_, want), jgrads = jax_f64_on_pyramid(f, variables["params"], pc, pyr)
    want_grads = grads_f64(jgrads)
    for dtype, value_bound, grad_bound in ((torch.float64, F64_REL_L2, F64_REL_L2),
                                           (torch.float32, REPLAYED_REL_L2, F32_GRAD_REL_L2)):
        got, grads = port_on_pyramid(port, pyr, pc,
                                     lambda out: (out[0] * torch.from_numpy(cot)).sum(), dtype,
                                     monkeypatch)
        gaps = (rel_l2(got[0], want[0]), rel_l2(got[1], want[1]))
        print(f"{dtype} on the JAX pyramid: global {gaps[0]:.3e}, node {gaps[1]:.3e}")
        assert_rel_l2(grads, want_grads, grad_bound)
        assert max(gaps) <= value_bound


def test_pad_rows_do_not_leak(monkeypatch):
    """Pad queries' neighbour sets are noise that differs between devices;
    scrambling every one of them changes no output and no gradient, bit for
    bit. More capacity than voxels (only more pad rows) leaves the global
    feature as it was."""
    port, _, _ = _generator()
    pc = t(unit_clouds(2, 2, 256))
    rng = torch.Generator().manual_seed(3)
    ball = tk.radius_neighbors_masked

    def scrambled(radius, nsample, s_pts, q_pts):
        idx, mask = ball(radius, nsample, s_pts, q_pts)
        pad = (q_pts.abs() > 1e5).any(-1)[..., None].expand_as(idx)
        scrambled.rows += int(pad[..., 0].sum())
        noise_idx = torch.randint(0, s_pts.shape[1], idx.shape, generator=rng)
        noise_mask = (torch.rand(idx.shape, generator=rng) < 0.5).float()
        return torch.where(pad, noise_idx, idx), torch.where(pad, noise_mask, mask)

    scrambled.rows = 0
    outs = []
    for patched in (False, True):
        with monkeypatch.context() as patch:
            if patched:
                patch.setattr(tk, "radius_neighbors_masked", scrambled)
            port.zero_grad()
            g, node, _ = port(pc)
            g.square().sum().backward()
            outs.append((g.detach(), node, [p.grad.clone() for p in port.parameters()]))
    assert scrambled.rows > 0
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][2], outs[1][2]))

    small = t(unit_clouds(4, 1, 64) * 0.3)
    feats = []
    for caps in ((64, 48, 32, 24, 16), (64, 64, 64, 64, 64)):
        gen = tk.KPConvGenerator({"grid_capacities": caps, "grid_dl": 0.1,
                                  "first_feats_dim": 16})
        gen.load_state_dict(port.state_dict())
        pyr = tk.build_pyramid(small, gen.encoder.cfg)
        assert all(v.sum() < cap for v, cap in zip(pyr["valid"][1:], caps[1:]))
        with torch.no_grad():
            feats.append(gen(small)[0])
    torch.testing.assert_close(feats[0], feats[1], rtol=1e-6, atol=1e-6)


# 2. the classifier --------------------------------------------------------------

def test_classifier_defaults(monkeypatch):
    pc = unit_clouds(5, 2, 128)
    labels = np.array([3, 7])
    port = make_classifier("KPConv", generator=torch.Generator().manual_seed(0))
    assert isinstance(port, tk.KPConvClassifier) and port.encoder.cfg["first_feats_dim"] == 64
    jmodel = j_make_classifier("KPConv")
    variables = port_weights_as_jax(jmodel, port.state_dict(), jnp.zeros((2, 128, 3)), True)
    load_jax_variables(port, variables)

    def f(params, pc):
        logits, mid = jmodel.apply({"params": params}, pc, True)
        return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(2), labels]), (logits, mid)

    jlogits, jmid = jax.jit(f)(variables["params"], pc)[1]
    with torch.no_grad():
        logits, mid = port.eval()(t(pc))
    own = (rel_l2(logits, jlogits), rel_l2(mid, jmid))
    print(f"own pyramids: logits {own[0]:.3e}, mid {own[1]:.3e}")
    assert max(own) <= OWN_PYRAMID_REL_L2

    pyr = jax_pyramid(pc, dict(jk.KPCONV_DEFAULTS))
    (_, want), jgrads = jax_f64_on_pyramid(f, variables["params"], pc, pyr)
    want_grads = grads_f64(jgrads)
    loss = lambda out: torch.nn.functional.cross_entropy(out[0], torch.from_numpy(labels))  # noqa
    for dtype, value_bound in ((torch.float64, F64_REL_L2), (torch.float32, REPLAYED_REL_L2)):
        got, grads = port_on_pyramid(port.train(), pyr, pc, loss, dtype, monkeypatch)
        gaps = (rel_l2(got[0], want[0]), rel_l2(got[1], want[1]))
        print(f"{dtype} on the JAX pyramid: logits {gaps[0]:.3e}, mid {gaps[1]:.3e}")
        assert max(gaps) <= value_bound
    # the gradients in float64 only: at full width the first block's weights'
    # gradient is a sum over the points that cancels to 1e-3 of its terms, and
    # f32 keeps a tenth of it (the generator's test holds f32 gradients)
    assert_rel_l2(grads_f64_of(port, pyr, pc, loss, monkeypatch), want_grads, F64_REL_L2)


# 3. NetMDA ---------------------------------------------------------------------

# upper-case keys are read lower-cased, the defaults' own names as they are; six
# blocks, two of them strided, so the heads take the encoder's 256 channels
NET_CFG = {"GRID_CAPACITIES": [256, 128, 64, 32, 16], "KP_influence": "gaussian",
           "KP_RANDOM_INIT": True, "KP_SEED": 4,
           "ARCHITECTURE": ["simple", "resnetb", "resnetb_strided", "resnetb",
                            "resnetb_strided", "resnetb"]}
KEYS = ("logits1", "logits2", "sem1", "sem2", "global_feat", "node_flat", "node_attn",
        "node_attn_t")


def test_net_mda_per_domain_and_stacked(monkeypatch):
    """Train mode, per domain ("both": both attentions on the same clouds)
    and stacked (2B clouds, source half then target half), from the same
    weights and BN statistics, in float64 on both sides."""
    pcs = unit_clouds(6, 4, 256)
    port = NetMDA("KPConv", generator=torch.Generator().manual_seed(1), model_cfg=NET_CFG)
    cfg = port.g.encoder.cfg
    assert cfg["KP_influence"] == "gaussian" and cfg["grid_capacities"] == [256, 128, 64, 32, 16]
    assert cfg["kp_random_init"] and cfg["kp_seed"] == 4 and port.g.encoder.out_dim == 256
    jmodel = JNetMDA(model_name="KPConv", model_cfg=NET_CFG)
    variables = port_weights_as_jax(jmodel, port.state_dict(), jnp.zeros((2, 256, 3)), True,
                                    domain="both")
    for domain, pc in (("both", pcs[:2]), ("stacked", pcs)):
        load_jax_variables(port, variables)
        port.double().train()
        pyr = jax_pyramid(pc, cfg)
        want, stats = jax_on_pyramid(
            lambda v, p: jmodel.apply(v, p, True, domain=domain, mutable=["batch_stats"]),
            [pyr], variables, pc, f64=True)
        with torch.no_grad(), replayed_pyramid(monkeypatch, as_port(pyr, torch.float64)):
            got = port(t(pc).double(), domain)
        assert set(got) == set(want) and got["node_offset"] is None
        gaps = {k: rel_l2(got[k], want[k]) for k in KEYS}
        print(f"{domain}: {max(gaps.values()):.3e} ({max(gaps, key=gaps.get)})")
        assert max(gaps.values()) <= F64_REL_L2, gaps
        want_stats = grads_f64(stats["batch_stats"])  # the BN statistics, named as the port's
        assert want_stats
        for name, buf in port.named_buffers():
            if name in want_stats:
                assert rel_l2(buf, want_stats[name]) <= F64_REL_L2, name
    port.float()
