"""The port's losses (sug_tpu_torch/losses/{classification,mmd}.py and
``geometry.chamfer_distance``) against sug_tpu.losses on the CPU: values,
and gradients with respect to the features (logits for the classification
losses, the features for the MMDs).

Tolerance 1e-5 relative + 1e-6 absolute on values and 1e-4 relative + 1e-6
absolute on gradients: both sides compute in f32 and differ only in the
order of sums. The MMD gradients are held to 1e-4 relative + 3e-5 absolute
(under 1% of their largest entry) at features of scale 0.1: the sigma=0.01
kernel multiplies the f32 rounding of each sample's zero self-distance
``diag - 2 ZZ^T + diag^T`` by 1/(2 sigma^2) = 5000, which two f32
implementations round differently (about 1e-5 here, 1e-4 at unit scale).
The class weights are host-side numpy in both packages and must agree to
1e-7.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sug_tpu.losses import classification as jc
from sug_tpu.losses import mmd as jm
from sug_tpu.ops import geometry as jg
from sug_tpu_torch.losses import classification as tc
from sug_tpu_torch.losses import mmd as tm
from sug_tpu_torch.ops import geometry as tg

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
MMD_GRAD = dict(rtol=1e-4, atol=3e-5)
B, C = 8, 10


def _logits(seed, scale=2.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.normal(size=(B, C))).astype(np.float32), rng.integers(0, C, size=B)


def _value_and_grad_both(jax_fn, torch_fn, *arrays):
    """(value, grad w.r.t. the first array) from both packages."""
    j_val, j_grad = jax.value_and_grad(lambda x0, *rest: jax_fn(x0, *rest))(
        *(jnp.asarray(a) for a in arrays))
    x0 = torch.from_numpy(arrays[0]).requires_grad_()
    t_val = torch_fn(x0, *(torch.from_numpy(np.asarray(a)) for a in arrays[1:]))
    (t_grad,) = torch.autograd.grad(t_val, x0)
    return (t_val.item(), t_grad.numpy()), (float(j_val), np.asarray(j_grad))


def _assert_both(got, want, grad_tol=GRAD):
    np.testing.assert_allclose(got[0], want[0], **VAL)
    np.testing.assert_allclose(got[1], want[1], **grad_tol)


@pytest.mark.parametrize("gamma,with_alpha", [(2.0, False), (0.0, True), (1.5, True)])
def test_focal_loss(gamma, with_alpha):
    logits, labels = _logits(0)
    alpha = np.random.default_rng(1).uniform(0.05, 0.2, size=C).astype(np.float32) if with_alpha else None
    got, want = _value_and_grad_both(
        lambda x, y: jc.focal_loss(x, y, gamma=gamma, alpha=None if alpha is None else jnp.asarray(alpha)),
        lambda x, y: tc.focal_loss(x, y, gamma=gamma, alpha=None if alpha is None else torch.from_numpy(alpha)),
        logits, labels.astype(np.int32),
    )
    _assert_both(got, want)


@pytest.mark.parametrize("weighting,q", [
    ("number_inverse", None), ("exp_inverse", None), ("DLSA", None), ("DLSA", 0.7),
    ("DLSA", "adaptive"), ("uniform", None),
])
def test_class_weights_with_a_zero_count_class(weighting, q):
    counts = [30, 5, 0, 12, 7, 40, 1, 9, 22, 3]
    want = jc.class_weights(counts, weighting, q=q, adaptive_q=isinstance(q, str))
    got = tc.class_weights(counts, weighting, q=q, adaptive_q=isinstance(q, str))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)
    if weighting != "uniform":
        assert got[2] == 0.0 and abs(got.sum() - 1.0) < 1e-6


def test_discrepancy():
    out1, _ = _logits(2)
    out2, _ = _logits(3)
    got, want = _value_and_grad_both(jc.discrepancy, tc.discrepancy, out1, out2)
    _assert_both(got, want)


def test_chamfer_distance():
    rng = np.random.default_rng(4)
    a = rng.uniform(-1, 1, size=(3, 128, 3)).astype(np.float32)
    b = rng.uniform(-1, 1, size=(3, 96, 3)).astype(np.float32)
    for per_sample in (True, False):
        want = np.asarray(jg.chamfer_distance(jnp.asarray(a), jnp.asarray(b), per_sample))
        got = tg.chamfer_distance(torch.from_numpy(a), torch.from_numpy(b), per_sample).numpy()
        np.testing.assert_allclose(got, want, **VAL)


def _mean2one_distances(seed):
    """Distances whose 1/mean sits well inside (2, 3): the truncation is 2
    on both sides, away from the jump at an integer."""
    d = np.random.default_rng(seed).uniform(0.2, 0.6, size=B).astype(np.float32)
    inv_mean = 1.0 / d.mean()
    print(f"mean2one: 1/mean = {inv_mean:.4f}")
    assert 2.1 < inv_mean < 2.9
    return d


@pytest.mark.parametrize("method", ["naive_inverse", "exp_inverse", "hist", "none", "mean2one"])
def test_distance2weights(method):
    d = _mean2one_distances(5)
    want = np.asarray(jm.distance2weights(jnp.asarray(d), method))
    got = tm.distance2weights(torch.from_numpy(d), method).numpy()
    np.testing.assert_allclose(got, want, **VAL)


def test_mean2one_truncation_quirk():
    """A mean distance above 1 truncates 1/mean to 0 and zeroes every
    weight, in both packages."""
    d = np.full(B, 1.5, np.float32)
    np.testing.assert_array_equal(tm.distance2weights(torch.from_numpy(d), "mean2one").numpy(),
                                  np.zeros(B, np.float32))
    np.testing.assert_array_equal(np.asarray(jm.distance2weights(jnp.asarray(d), "mean2one")),
                                  np.zeros(B, np.float32))


def _clouds_and_feats(seed, d=64):
    rng = np.random.default_rng(seed)
    pc_s = rng.uniform(-0.5, 0.5, size=(B, 128, 3)).astype(np.float32)
    pc_t = rng.uniform(-0.5, 0.5, size=(B, 128, 3)).astype(np.float32)
    fs = (0.1 * rng.normal(size=(B, d))).astype(np.float32)
    ft = (0.1 * rng.normal(size=(B, d))).astype(np.float32)
    ls, lt = rng.integers(0, C, size=B).astype(np.int32), rng.integers(0, C, size=B).astype(np.int32)
    return pc_s, pc_t, fs, ft, ls, lt


def test_geometric_weights():
    pc_s, pc_t, *_ = _clouds_and_feats(6)
    inv_mean = 1.0 / np.asarray(jg.chamfer_distance(jnp.asarray(pc_s), jnp.asarray(pc_t))).mean()
    print(f"geometric mean2one: 1/mean = {inv_mean:.4f}")
    assert abs(inv_mean - round(inv_mean)) > 0.1
    want = np.asarray(jm.geometric_weights(jnp.asarray(pc_s), jnp.asarray(pc_t)))
    got = tm.geometric_weights(torch.from_numpy(pc_s), torch.from_numpy(pc_t)).numpy()
    np.testing.assert_allclose(got, want, **VAL)


def test_prob_weights_soft():
    logits_s, ls = _logits(7)
    logits_t, lt = _logits(8)
    want = np.asarray(jm.prob_weights_soft(jnp.asarray(logits_s), jnp.asarray(logits_t),
                                           jnp.asarray(ls), jnp.asarray(lt), 0.5))
    got = tm.prob_weights_soft(torch.from_numpy(logits_s), torch.from_numpy(logits_t),
                               torch.from_numpy(ls), torch.from_numpy(lt), 0.5).numpy()
    np.testing.assert_allclose(got, want, **VAL)


def test_entropy_weights():
    rng = np.random.default_rng(9)
    ps = rng.dirichlet(np.ones(C), size=B).astype(np.float32)
    pt = rng.dirichlet(np.ones(C), size=B).astype(np.float32)
    want = np.asarray(jm.entropy_weights(jnp.asarray(ps), jnp.asarray(pt)))
    got = tm.entropy_weights(torch.from_numpy(ps), torch.from_numpy(pt)).numpy()
    np.testing.assert_allclose(got, want, **VAL)


MMD_CFGS = {
    "soft-geo": {"NAME": "SOFT_MMD", "LABEL_SCALE": 50, "GEO_WEIGHTS": "mean2one", "GEO_SCALE": 1},
    "soft-sem": {"NAME": "SOFT_MMD", "LABEL_SCALE": 5, "SEM_WEIGHTS": "mean2one", "LABEL_WEIGHT": 0.5},
    "off": {"NAME": "OFF"},
}


@pytest.mark.parametrize("name", list(MMD_CFGS))
def test_mmd_cal(name):
    cfg = MMD_CFGS[name]
    pc_s, pc_t, fs, ft, ls, lt = _clouds_and_feats(10, d=256)
    if name == "soft-sem":  # SDA weights from the heads' logits
        data_s, data_t = _logits(11)[0], _logits(12)[0]
    else:
        data_s, data_t = pc_s, pc_t

    def j_fn(fs_, ft_, ls_, lt_, ds_, dt_):
        return jm.mmd_cal(ls_, fs_, lt_, ft_, cfg, data_s=ds_, data_t=dt_)

    def t_fn(fs_, ft_, ls_, lt_, ds_, dt_):
        return tm.mmd_cal(ls_, fs_, lt_, ft_, cfg, data_s=ds_, data_t=dt_)

    got, want = _value_and_grad_both(j_fn, t_fn, fs, ft, ls, lt, data_s, data_t)
    assert want[0] != 0.0
    _assert_both(got, want, MMD_GRAD)


@pytest.mark.parametrize("biased", [True, False], ids=["biased", "unbiased"])
def test_mix_rbf_mmd2_with_weights_and_mask(biased):
    """``_mmd2``'s SDA ``sample_weights`` and subset ``mask`` together. The
    sigma=0.01 kernel is left out, so its rounding noise (see above) does not
    hide the weighting, and the gradients are held to the plain 1e-4."""
    _, _, fs, ft, *_ = _clouds_and_feats(14)
    rng = np.random.default_rng(15)
    w = rng.uniform(0.5, 1.5, size=B).astype(np.float32)
    mask = (np.arange(B) % 3 != 1).astype(np.float32)
    sigmas = (0.1, 1.0, 10.0, 100.0)
    got, want = _value_and_grad_both(
        lambda x, y, w_, m_: jm.mix_rbf_mmd2(x, y, sigmas, biased, sample_weights=w_, mask=m_),
        lambda x, y, w_, m_: tm.mix_rbf_mmd2(x, y, sigmas, biased, sample_weights=w_, mask=m_),
        fs, ft, w, mask,
    )
    assert want[0] != 0.0
    _assert_both(got, want)


def test_unported_mmd_raises():
    _, _, fs, ft, ls, lt = _clouds_and_feats(13)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.mmd_cal(torch.from_numpy(ls), torch.from_numpy(fs), torch.from_numpy(lt),
                   torch.from_numpy(ft), {"NAME": "HARD_MMD"})
