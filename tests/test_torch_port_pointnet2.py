"""PointNet++ in the port (``sug_tpu_torch/models/pointnet2.py``, the grouping
ops of ``ops/geometry.py``, ``maxpool1d_strided`` of ``models/layers.py``,
``NetMDA("Pointnet2")`` and the standalone classifier) against the JAX
package on the CPU, at B=2 to 4 clouds of 1024 points (the generator's
first FPS takes 512), with weights bridged from the port's init into the
JAX tree (BN stats randomised, a third of the BN scales negative):

1. ``sample_and_group`` at ``sa1``'s and ``sa2``'s shapes and
   ``sample_and_group_all``: the FPS indices and the grouped indices equal,
   the centroids and grouped features bit for bit;
2. ``maxpool1d_strided`` at the generator's (B, 512, 64) -> (B, 64, 64),
   forward and gradient (on exact ties too) bit for bit;
3. in eval mode ``SetAbstraction`` (with the node tap, and grouping all),
   ``SetAbstractionMSG`` (two branches), ``FeaturePropagation`` (3-NN and a
   one-point coarse level, with and without skip features),
   ``PointNet2MSGSegmenter``, ``PointNet2Generator`` and
   ``NetMDA("Pointnet2")``: every output;
4. ``PointNet2Classifier``: the eval forward, and the source-only loss
   (``SourceTrainer._loss``, dropout off) with every gradient, the port in
   f32 and in f64 against the JAX package in f64; the PointNet++ models
   refusing bf16.

Tolerances. Eval forwards 1e-4 abs + 1e-4 rel, as
``tests/test_torch_port_pointnet.py``'s (the two libraries order their f32
sums differently in every Dense and reduction). The train-mode loss as
``tests/test_torch_port_pointnet2_dg.py`` holds the DG loss, against the JAX
package in f64 for the reasons it gives (here its own f32 loss lies 3.2e-4
from its f64 one, the port's 2.8e-6: the classifier's BNs normalise each
feature over the 4 clouds): the loss to 1e-5 relative, the gradients to
1e-3 relative L2 per leaf in f64 and 2e-2 in f32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sug_tpu.models import make_classifier as j_make_classifier
from sug_tpu.models import pointnet2 as jp2
from sug_tpu.models.layers import maxpool1d_strided as j_maxpool
from sug_tpu.models.net_mda import NetMDA as JNetMDA
from sug_tpu.ops import geometry as jgeo
from sug_tpu_torch.engine.source_trainer import SourceTrainer
from sug_tpu_torch.models import make_classifier
from sug_tpu_torch.models import pointnet2 as tp2
from sug_tpu_torch.models.layers import maxpool1d_strided
from sug_tpu_torch.models.net_mda import NetMDA
from sug_tpu_torch.models.precision import set_compute_dtype
from sug_tpu_torch.ops import geometry as tgeo
from sug_tpu_torch.utils.jax_bridge import load_jax_variables
from tests._torch_port_common import (
    assert_rel_l2,
    jax_grads_by_name,
    port_weights_as_jax,
    t,
)
from tests._torch_port_common import one_torch_thread  # noqa: F401  (autouse)

N = 1024
TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-3
F32_GRAD_REL_L2 = 2e-2


def _clouds(seed, b, n=N):
    rng = np.random.default_rng(seed)
    pc = rng.uniform(-1, 1, size=(b, n, 3)) * rng.uniform(0.3, 1.0, size=(b, 1, 3))
    pc /= np.linalg.norm(pc, axis=-1).max(axis=-1)[:, None, None]
    return pc.astype(np.float32)


def _feats(seed, b, n, c):
    return np.random.default_rng(seed).normal(size=(b, n, c)).astype(np.float32)


def _bridged(port, jmodule, *init_args, **init_kwargs):
    """``port`` in eval mode and the JAX variables it was filled from: the
    port's initial weights in the JAX tree, randomised."""
    variables = port_weights_as_jax(jmodule, port.state_dict(), *init_args, **init_kwargs)
    load_jax_variables(port, variables)
    return port.eval(), variables


def _close(got, want):
    for g, w in zip(got, want):
        assert g.shape == tuple(w.shape)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("npoint,radius,nsample,n,c", [(512, 0.2, 32, N, 0), (128, 0.4, 64, 512, 16)])
def test_sample_and_group(npoint, radius, nsample, n, c):
    xyz = _clouds(1, 4, n)
    feats = _feats(2, 4, n, c) if c else None
    start = np.array([0, 7, n - 1, 300])
    want_xyz, want_feats, want_fps = jgeo.sample_and_group(
        npoint, radius, nsample, jnp.asarray(xyz), None if feats is None else jnp.asarray(feats),
        jnp.asarray(start), return_fps_idx=True)
    got_xyz, got_feats = tgeo.sample_and_group(npoint, radius, nsample, t(xyz),
                                               None if feats is None else t(feats),
                                               torch.from_numpy(start))
    fps = tgeo.farthest_point_sample(t(xyz), npoint, torch.from_numpy(start))
    np.testing.assert_array_equal(fps.numpy(), np.asarray(want_fps))
    groups = tgeo.query_ball_point(radius, nsample, t(xyz), got_xyz)
    np.testing.assert_array_equal(
        groups.numpy(), np.asarray(jgeo.query_ball_point(radius, nsample, jnp.asarray(xyz),
                                                         jnp.asarray(want_xyz))))
    # balls short of nsample pad with their first point: the ties the maxima see
    assert (groups == groups[..., :1]).sum(-1).max() > 1
    assert got_feats.shape == (4, npoint, nsample, 3 + c)
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    np.testing.assert_array_equal(got_feats.numpy(), np.asarray(want_feats))


@pytest.mark.parametrize("c", [0, 8])
def test_sample_and_group_all(c):
    xyz = _clouds(3, 2, 128)
    feats = _feats(4, 2, 128, c) if c else None
    want = jgeo.sample_and_group_all(jnp.asarray(xyz), None if feats is None else jnp.asarray(feats))
    got = tgeo.sample_and_group_all(t(xyz), None if feats is None else t(feats))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_maxpool1d_strided():
    x = _feats(5, 2, 512, 64)
    x[:, 9] = x[:, 8]  # exact ties inside a window
    r = _feats(6, 2, 64, 64)
    want, grad = jax.value_and_grad(lambda a: jnp.sum(j_maxpool(a, 3, 8) * r))(jnp.asarray(x))
    xt = t(x).requires_grad_()
    got = maxpool1d_strided(xt, 3, 8)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(j_maxpool(jnp.asarray(x), 3, 8)))
    assert got.shape == (2, 64, 64)
    np.testing.assert_allclose(float((got * t(r)).sum()), float(want), rtol=1e-6)
    (g,) = torch.autograd.grad((got * t(r)).sum(), xt)
    np.testing.assert_array_equal(g.numpy(), np.asarray(grad))


@pytest.mark.parametrize("group_all", [False, True])
def test_set_abstraction(group_all):
    xyz, feats = _clouds(7, 2, 512), _feats(8, 2, 512, 32)
    start = np.array([3, 500])
    if group_all:
        args = (None, None, None, (64, 128))
    else:
        args = (128, 0.4, 32, (64, 64, 128))
    jm = jp2.SetAbstraction(*args[:3], args[3], group_all=group_all)
    port, variables = _bridged(tp2.SetAbstraction(*args[:3], 3 + 32, args[3], group_all),
                               jm, jnp.asarray(xyz), jnp.asarray(feats), False, adapt=True)
    want = jax.jit(lambda v, a, f, s: jm.apply(v, a, f, False, adapt=True, fps_start=s))(
        variables, jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(start))
    with torch.no_grad():
        got = port(t(xyz), t(feats), adapt=True, fps_start=torch.from_numpy(start))
    _close(got, want)
    with torch.no_grad():
        _close(port(t(xyz), t(feats), fps_start=torch.from_numpy(start)), want[:2])


def test_set_abstraction_msg():
    xyz, feats = _clouds(9, 2), _feats(10, 2, N, 8)
    start = np.array([11, 1000])
    spec = (128, (0.1, 0.3), (16, 32), ((32, 64), (32, 48, 96)))
    jm = jp2.SetAbstractionMSG(*spec)
    port, variables = _bridged(tp2.SetAbstractionMSG(*spec[:3], 3 + 8, spec[3]), jm,
                               jnp.asarray(xyz), jnp.asarray(feats), False)
    want = jax.jit(lambda v, a, f, s: jm.apply(v, a, f, False, fps_start=s))(
        variables, jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(start))
    with torch.no_grad():
        got = port(t(xyz), t(feats), fps_start=torch.from_numpy(start))
    assert got[1].shape == (2, 128, 64 + 96)
    _close(got, want)


@pytest.mark.parametrize("s,skip", [(128, 16), (128, 0), (1, 16)])
def test_feature_propagation(s, skip):
    dense, coarse = _clouds(12, 2, 512), _clouds(13, 2, s)
    f_dense = _feats(14, 2, 512, skip) if skip else None
    f_coarse = _feats(15, 2, s, 24)
    jm = jp2.FeaturePropagation((64, 32))
    args = (jnp.asarray(dense), jnp.asarray(coarse), None if f_dense is None else jnp.asarray(f_dense),
            jnp.asarray(f_coarse))
    port, variables = _bridged(tp2.FeaturePropagation(skip + 24, (64, 32)), jm, *args, False)
    want = jax.jit(lambda v, *a: jm.apply(v, *a, False))(variables, *args)
    with torch.no_grad():
        got = port(t(dense), t(coarse), None if f_dense is None else t(f_dense), t(f_coarse))
    _close([got], [want])


def test_msg_segmenter():
    pc = _clouds(16, 2)
    jm = jp2.PointNet2MSGSegmenter()
    port, variables = _bridged(tp2.PointNet2MSGSegmenter(), jm, jnp.asarray(pc), False)
    want = jax.jit(lambda v, a: jm.apply(v, a, False))(variables, jnp.asarray(pc))
    with torch.no_grad():
        got = port(t(pc))
    assert got.shape == (2, N, 256)
    _close([got], [want])


def test_generator():
    pc = _clouds(17, 4)
    start = np.array([5, 0, N - 1, 640])
    jm = jp2.PointNet2Generator()
    port, variables = _bridged(tp2.PointNet2Generator(), jm, jnp.asarray(pc), False)
    want = jax.jit(lambda v, a, s: jm.apply(v, a, False, s))(variables, jnp.asarray(pc),
                                                             jnp.asarray(start))
    with torch.no_grad():
        got = port(t(pc), torch.from_numpy(start))
    assert got[2] is None and want[2] is None
    assert got[0].shape == (4, 1024) and got[1].shape == (4, 64, 64)
    _close(got[:2], want[:2])


def test_net_mda_eval():
    pc = _clouds(18, 4)
    start = np.array([9, 90, 900, 1])
    jm = JNetMDA(model_name="Pointnet2", num_class=10)
    port, variables = _bridged(NetMDA("Pointnet2", generator=torch.Generator().manual_seed(1)),
                               jm, jnp.asarray(pc), True, domain="both")
    want = jax.jit(lambda v, a, s: jm.apply(v, a, train=False, domain="both", fps_start=s))(
        variables, jnp.asarray(pc), jnp.asarray(start))
    with torch.no_grad():
        got = port(t(pc), "both", torch.from_numpy(start))
    assert got["node_offset"] is None and want["node_offset"] is None
    for k in ("logits1", "logits2", "sem1", "sem2", "global_feat", "node_flat", "node_attn",
              "node_attn_t"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)


@pytest.fixture(scope="module")
def classifier():
    """The JAX classifier, its variables and the port's on them."""
    jm = j_make_classifier("Pointnet2", 10)
    port = make_classifier("Pointnet2", generator=torch.Generator().manual_seed(2))
    variables = port_weights_as_jax(jm, port.state_dict(), jnp.zeros((4, N, 3)), True)
    return jm, variables


def test_classifier_eval(classifier):
    jm, variables = classifier
    pc = _clouds(19, 4)
    port = make_classifier("Pointnet2")
    load_jax_variables(port, variables)
    want = jax.jit(lambda v, a: jm.apply(v, a, False))(variables, jnp.asarray(pc))
    with torch.no_grad():
        got = port.eval()(t(pc))
    assert got[0].shape == (4, 10) and got[1].shape == (4, 1024)
    _close(got, want)


def test_classifier_source_loss(classifier, monkeypatch):
    import flax.linen as fnn

    jm, variables = classifier
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    pc, labels = _clouds(20, 4), np.array([1, 4, 4, 8], np.int32)

    def loss_fn(params, batch_stats, x):
        (logits, _), _ = jm.apply({"params": params, "batch_stats": batch_stats}, x, True,
                                  mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()

    tr = SourceTrainer("Pointnet2", augment=False, device="cpu")
    load_jax_variables(tr.model, variables)
    tr.model.dropout_rate = 0.0
    initial = {n: b.clone() for n, b in tr.model.named_buffers()}
    with jax.enable_x64():
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
        want, grads = jax.jit(jax.value_and_grad(loss_fn))(v64["params"], v64["batch_stats"],
                                                            jnp.asarray(pc))
    for dtype, grad_bound in ((torch.float32, F32_GRAD_REL_L2), (torch.float64, GRAD_REL_L2)):
        tr.model.to(dtype).load_state_dict(initial, strict=False)
        got, _ = tr._loss(t(pc), torch.from_numpy(labels).long())
        print(f"source-only loss, {dtype}: {float(got)!r} vs {float(want)!r}")
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
        names = [n for n, _ in tr.params]
        assert_rel_l2({n: g.numpy() for n, g in zip(names, tr.grads(got))},
                      jax_grads_by_name(grads), grad_bound)


def test_bf16_refused():
    for model in (make_classifier("Pointnet2"), NetMDA("Pointnet2"), tp2.PointNet2MSGSegmenter()):
        with pytest.raises(NotImplementedError, match=r"ROADMAP.md \(item 16b\)"):
            set_compute_dtype(model, torch.bfloat16)
        set_compute_dtype(model, None)  # f32 stays open
