"""The port's losses (sug_tpu_torch/losses/{classification,mmd}.py and
``geometry.chamfer_distance``) and its gradient-reversal layer against
sug_tpu on the CPU: values, and gradients with respect to the features
(logits for the classification losses, the features for the MMDs). The
class-conditioned alignments (hard, max-hard, contrastive) run on labels
with no match, all matches and a mix; one DG ``_loss`` runs with the
contrastive geo and the hard sem alignment.

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

import functools

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
    """An unknown name raises ``ValueError``, as in the JAX package; so does
    CL, which the trainer dispatches and ``mmd_cal`` does not."""
    _, _, fs, ft, ls, lt = _clouds_and_feats(13)
    for name in ("NOT_AN_MMD", "CL"):
        with pytest.raises(ValueError, match=f"Not supported MMD method {name}"):
            jm.mmd_cal(jnp.asarray(ls), jnp.asarray(fs), jnp.asarray(lt), jnp.asarray(ft),
                       {"NAME": name})
        with pytest.raises(ValueError, match=f"Not supported MMD method {name}"):
            tm.mmd_cal(torch.from_numpy(ls), torch.from_numpy(fs), torch.from_numpy(lt),
                       torch.from_numpy(ft), {"NAME": name})


def _labels(case, seed):
    """Source and target labels with no match, every position matching, or a
    mix (classes repeat, so the max-hard quotas are not all one)."""
    rng = np.random.default_rng(seed)
    ls = rng.integers(0, 4, size=B).astype(np.int32)
    if case == "none":
        return ls, ((ls + 1 + rng.integers(0, 3, size=B)) % 4 + 4).astype(np.int32)
    if case == "all":
        return ls, ls.copy()
    lt = ls.copy()
    lt[::2] = rng.integers(0, 4, size=B // 2)
    assert (lt == ls).any() and (lt != ls).any()
    return ls, lt


LABEL_CASES = ["none", "all", "mix"]


@pytest.mark.parametrize("case", LABEL_CASES)
def test_class_overlap_masks(case):
    ls, lt = _labels(case, 20)
    want = [np.asarray(m) for m in jm._class_overlap_masks(jnp.asarray(ls), jnp.asarray(lt))]
    got = [m.numpy() for m in tm._class_overlap_masks(torch.from_numpy(ls), torch.from_numpy(lt))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].sum() == got[1].sum()


@pytest.mark.parametrize("case", LABEL_CASES)
@pytest.mark.parametrize("fn", ["hard_mmd", "max_hard_mmd", "contrastive_loss_weighted"])
def test_class_conditioned_alignments(fn, case):
    _, _, fs, ft, _, _ = _clouds_and_feats(21, d=64)
    ls, lt = _labels(case, 22)
    got, want = _value_and_grad_both(
        lambda x, y, a, b: getattr(jm, fn)(a, x, b, y),
        lambda x, y, a, b: getattr(tm, fn)(a, x, b, y),
        fs, ft, ls, lt,
    )
    if fn == "hard_mmd" and case == "none":
        assert want[0] == 0.0 and got[0] == 0.0
    _assert_both(got, want, MMD_GRAD)


def test_contrastive_loss_with_sample_weights():
    _, _, fs, ft, _, _ = _clouds_and_feats(23, d=64)
    ls, lt = _labels("mix", 24)
    w = np.random.default_rng(25).uniform(0.5, 1.5, size=B).astype(np.float32)
    got, want = _value_and_grad_both(
        lambda x, y, a, b, w_: jm.contrastive_loss_weighted(a, x, b, y, sample_weights=w_),
        lambda x, y, a, b, w_: tm.contrastive_loss_weighted(a, x, b, y, sample_weights=w_),
        fs, ft, ls, lt, w,
    )
    _assert_both(got, want)


@pytest.mark.parametrize("biased", [True, False], ids=["biased", "unbiased"])
def test_mix_rbf_mmd2_and_ratio(biased):
    """The variance-normalised MMD and its two parts, in float64 on both
    sides (JAX under ``jax.enable_x64``), to 1e-9 relative. The variance
    estimate is a difference of terms some 1e3 times larger than it: in f32
    each package lands within 1e-4 to 2e-2 of the float64 value, on its own
    side of it, so f32 against f32 would test the rounding, not the formula."""
    rng = np.random.default_rng(26)
    fs = rng.normal(size=(B, 64))
    ft = rng.normal(size=(B, 64)) + 0.5
    with jax.enable_x64(True):
        want = [float(v) for v in jm.mix_rbf_mmd2_and_ratio(jnp.asarray(fs), jnp.asarray(ft),
                                                            biased=biased)]
        j_grad = np.asarray(jax.grad(lambda x: jm.mix_rbf_mmd2_and_ratio(
            x, jnp.asarray(ft), biased=biased)[0])(jnp.asarray(fs)))
    x = torch.from_numpy(fs).requires_grad_()
    got = tm.mix_rbf_mmd2_and_ratio(x, torch.from_numpy(ft), biased=biased)
    (t_grad,) = torch.autograd.grad(got[0], x)
    assert want[2] > jm.MIN_VAR_EST  # the variance, not its floor
    np.testing.assert_allclose([float(v) for v in got], want, rtol=1e-9)
    np.testing.assert_allclose(t_grad.numpy(), j_grad, rtol=1e-9, atol=1e-9 * np.abs(j_grad).max())


@pytest.mark.parametrize("fn", ["linear_mmd2", "poly_mmd2"])
def test_linear_time_mmds(fn):
    _, _, fs, ft, *_ = _clouds_and_feats(27, d=32)
    fs, ft = 10.0 * fs, 10.0 * ft + 0.5
    got, want = _value_and_grad_both(getattr(jm, fn), getattr(tm, fn), fs, ft)
    _assert_both(got, want)


def test_grad_reverse():
    from sug_tpu.models.layers import grad_reverse as j_grl
    from sug_tpu_torch.models.layers import grad_reverse as t_grl

    rng = np.random.default_rng(28)
    x = rng.normal(size=(B, 16)).astype(np.float32)
    cot = rng.normal(size=(B, 16)).astype(np.float32)
    lambd = np.float32(0.7)
    (j_out, (j_gx, j_gl)) = (
        np.asarray(j_grl(jnp.asarray(x), lambd)),
        jax.grad(lambda x_, l_: jnp.sum(j_grl(x_, l_) * cot), argnums=(0, 1))(jnp.asarray(x),
                                                                            jnp.asarray(lambd)),
    )
    tx = torch.from_numpy(x).requires_grad_()
    out = t_grl(tx, 0.7)
    (t_gx,) = torch.autograd.grad(torch.sum(out * torch.from_numpy(cot)), tx)
    np.testing.assert_array_equal(out.detach().numpy(), j_out)
    np.testing.assert_array_equal(t_gx.numpy(), np.asarray(j_gx))
    assert float(j_gl) == 0.0  # no gradient for λ, on either side
    np.testing.assert_array_equal(t_gx.numpy(), -lambd * cot)


HARD_CFGS = {
    "hard-geo": {"NAME": "HARD_MMD", "LABEL_SCALE": 50, "GEO_WEIGHTS": "mean2one", "GEO_SCALE": 1},
    "hard-sem": {"NAME": "HARD_MMD", "SEM_WEIGHTS": "mean2one", "LABEL_WEIGHT": 0.5},
    "max-hard-geo": {"NAME": "MAX_HARD_MMD", "GEO_WEIGHTS": "mean2one"},
    "max-hard": {"NAME": "MAX_HARD_MMD"},
}


@pytest.mark.parametrize("name", list(HARD_CFGS))
def test_mmd_cal_hard(name):
    """``mmd_cal`` dispatches the hard MMDs (which read no SDA weights)."""
    cfg = HARD_CFGS[name]
    pc_s, pc_t, fs, ft, _, _ = _clouds_and_feats(29, d=256)
    ls, lt = _labels("mix", 30)
    data_s, data_t = (_logits(31)[0], _logits(32)[0]) if "sem" in name else (pc_s, pc_t)
    got, want = _value_and_grad_both(
        lambda x, y, a, b, d1, d2: jm.mmd_cal(a, x, b, y, cfg, data_s=d1, data_t=d2),
        lambda x, y, a, b, d1, d2: tm.mmd_cal(a, x, b, y, cfg, data_s=d1, data_t=d2),
        fs, ft, ls, lt, data_s, data_t,
    )
    assert want[0] != 0.0
    _assert_both(got, want, MMD_GRAD)


def test_dg_loss_with_cl_geo_and_hard_sem(monkeypatch):
    """One DGCNN ``_loss(train=False)`` of the trainer with ``GEO_MMD: CL``
    and ``SEM_MMD: HARD_MMD``, the weights bridged from the JAX init: every
    loss, port against JAX, to 1e-4 relative (as the DG step tests)."""
    import bench
    from sug_tpu.engine import dg_trainer as jdt
    from sug_tpu_torch.engine import dg_trainer as tdt
    from sug_tpu_torch.utils.jax_bridge import load_jax_variables
    from tests.test_torch_port_stacked import _clouds, _variables

    monkeypatch.delenv("SUG_STACKED_FORWARD", raising=False)
    cfg = dict(bench._make_cfg())
    cfg["METHODS"] = {**cfg["METHODS"], "GEO_MMD": [{"NAME": "CL", "GEO_SCALE": 1}],
                      "SEM_MMD": [{"NAME": "HARD_MMD", "SEM_SCALE": 1}]}
    variables = _variables("DGCNN")
    jtr = jdt.DGTrainer(cfg, model_name="DGCNN", augment=False)
    tr = tdt.DGTrainer(cfg, model_name="DGCNN", augment=False, device="cpu")
    load_jax_variables(tr.model, variables)
    ds, dt = _clouds(3)
    ls, lt = _labels("mix", 33)[0][:4], _labels("mix", 33)[1][:4]
    _, (_, want) = jax.jit(functools.partial(jtr._loss, mmd_on=True, train=False))(
        variables["params"], variables["batch_stats"], jnp.asarray(ds), jnp.asarray(ls),
        jnp.asarray(dt), jnp.asarray(lt), jax.random.key(0), jnp.float32(0.0))
    with torch.no_grad():
        _, got = tr._loss(torch.from_numpy(ds), torch.from_numpy(ls).long(), torch.from_numpy(dt),
                          torch.from_numpy(lt).long(), train=False)
    assert float(want["loss_geo"]) != 0.0 and float(want["loss_sem"]) != 0.0
    for k in ("loss_cls", "loss_geo", "loss_sem", "loss_total"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
