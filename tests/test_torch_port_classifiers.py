"""The standalone classifiers of the port (``models.make_classifier``:
``PointNetClassifier``, ``DGCNNClassifier``, ``PointTransformerClassifier``)
against the JAX package's on the CPU, at B=4 clouds of 128 points, with
weights bridged from the port's init (BN stats randomised, a third of the
BN scales negative) and head dropout off on both sides.

1. Eval-mode forward: logits and mid features of each classifier.
2. Train-mode forward: logits, mid features and the new BN running stats
   of each; for DGCNN and PointNet also every parameter's gradient of the
   cross entropy.
3. The bridge fills every tensor of each classifier, ``make_classifier``
   raises on an unknown name, KPConv under bf16, and ``set_compute_dtype(bf16)``
   reaches every ``Mixed`` layer of each classifier.

The PointNet++ classifier, which needs 512 points (its first FPS takes
512), and which refuses bf16, is held in ``tests/test_torch_port_pointnet2.py``
at 1024 points.

Tolerances. Forward logits and mid features 1e-4 abs + 1e-4 rel, as
``tests/test_torch_port_slice.py`` holds the DG forward: the two libraries
order their f32 sums differently in every matmul and reduction. Gradients
and batch statistics 2e-2 relative L2 per leaf, the DG-step test's bound
(``tests/test_torch_port_dg_step.py`` gives its causes: sums in another
order through four EdgeConv blocks or two T-Nets, and BNs over few rows).

The clouds are seeded, so the test is deterministic. A neighbour chosen
among near-tied distances is a rounding decision: the clouds of seed 1 hold
one in DGCNN's third cloud, where the JAX package's f32 kNN picks another
neighbour than the port's float64 forward, and its logits move by 1.6e-3
while the port's f32 stays within 5e-7 of its float64. The tests use other
seeds.
"""

from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sug_tpu.models import make_classifier as j_make_classifier
from sug_tpu_torch.losses.classification import cross_entropy
from sug_tpu_torch.models import CLASSIFIERS, make_classifier
from sug_tpu_torch.models.precision import Mixed, set_compute_dtype
from sug_tpu_torch.utils.jax_bridge import load_jax_variables, state_dict_from_jax
from tests._torch_port_common import (  # noqa: F401  (one_torch_thread is autouse)
    assert_rel_l2,
    jax_grads_by_name,
    jax_stats_by_name,
    one_torch_thread,
    port_weights_as_jax,
)

B, N = 4, 128
TOL = dict(rtol=1e-4, atol=1e-4)
REL_L2 = 2e-2
LABELS = np.array([0, 3, 5, 9], np.int32)
# the classifiers held here, at N points (PointNet++: tests/test_torch_port_pointnet2.py;
# KPConv, whose pyramid each package builds with its own f32 rounding and which refuses
# bf16: tests/test_torch_port_kpconv_models.py)
SMALL_CLASSIFIERS = tuple(c for c in CLASSIFIERS if c not in ("Pointnet2", "KPConv"))


def _clouds(seed):
    rng = np.random.default_rng(seed)
    pc = rng.uniform(-1, 1, size=(B, N, 3)) * rng.uniform(0.2, 1.0, size=(B, 1, 3))
    return (pc / np.linalg.norm(pc, axis=-1).max(axis=-1)[:, None, None]).astype(np.float32)


def no_dropout(model):
    """The port classifier with its head dropout off."""
    for m in model.modules():
        if hasattr(m, "dropout_rate"):
            m.dropout_rate = 0.0
    return model


@pytest.fixture(scope="module", params=SMALL_CLASSIFIERS)
def pair(request):
    """(name, JAX classifier, its variables, the port classifier on them)."""
    name = request.param
    port = make_classifier(name, generator=torch.Generator().manual_seed(0))
    jm = j_make_classifier(name, 10)
    variables = port_weights_as_jax(jm, port.state_dict(), jnp.zeros((B, N, 3)), True)
    load_jax_variables(port, variables)
    return name, jm, variables, port


def test_bridge_fills_every_tensor(pair):
    _, _, variables, port = pair
    assert set(state_dict_from_jax(variables)) == set(port.state_dict())


def test_eval_forward(pair):
    _, jm, variables, port = pair
    pc = _clouds(2)
    want = jax.jit(lambda v, x: jm.apply(v, x, False))(variables, jnp.asarray(pc))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(pc))
    for g, w, what in zip(got, want, ("logits", "mid")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=what, **TOL)


def test_train_forward_and_gradients(pair, monkeypatch):
    name, jm, variables, port = pair
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    pc = _clouds(3)

    def loss_fn(params, batch_stats, x):  # the clouds an argument: XLA folds constants
        (logits, mid), mut = jm.apply({"params": params, "batch_stats": batch_stats}, x, True,
                                      mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(logits, LABELS).mean()
        return loss, (logits, mid, mut["batch_stats"])

    with_grads = name != "PTran"
    args = (variables["params"], variables["batch_stats"], jnp.asarray(pc))
    if with_grads:
        (loss, (logits, mid, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            *args)
    else:
        loss, (logits, mid, stats) = jax.jit(loss_fn)(*args)
    model = no_dropout(port).train()
    got_logits, got_mid = model(torch.from_numpy(pc))
    got_loss = cross_entropy(got_logits, torch.from_numpy(LABELS).long())
    np.testing.assert_allclose(got_loss.item(), float(loss), rtol=1e-4)
    for g, w, what in ((got_logits, logits, "logits"), (got_mid, mid, "mid")):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), err_msg=what, **TOL)
    assert_rel_l2({n: b.numpy() for n, b in port.named_buffers()}, jax_stats_by_name(stats),
                  REL_L2)
    if with_grads:
        names = [n for n, _ in port.named_parameters()]
        got = torch.autograd.grad(got_loss, [p for _, p in port.named_parameters()])
        assert_rel_l2({n: g.numpy() for n, g in zip(names, got)}, jax_grads_by_name(grads),
                      REL_L2)
    load_jax_variables(port, variables)  # the running stats back for the other tests


def test_bf16_policy_reaches_every_mixed_layer(pair):
    name, _, _, _ = pair
    model = make_classifier(name)
    mixed = [m for m in model.modules() if isinstance(m, Mixed)]
    assert mixed
    set_compute_dtype(model, torch.bfloat16)
    assert {m.compute_dtype for m in mixed} == {torch.bfloat16}
    with torch.no_grad():
        logits, _ = model.eval()(torch.from_numpy(_clouds(4)))
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    set_compute_dtype(model, None)
    assert {m.compute_dtype for m in mixed} == {None}


@pytest.mark.parametrize("name,item", [("Pointnet3", None), ("KPConv", "item 17")])
def test_unported_classifiers_raise(name, item):
    """An unknown name raises as in JAX. KPConv's classifier is built (its
    rigid network); under the bf16 policy, not ported for it, it names its
    ROADMAP item (17c)."""
    if item is None:
        with pytest.raises(NotImplementedError, match=f"Unsupported model name {name}"):
            make_classifier(name)
        return
    model = make_classifier(name)
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md \\({item}c\\)"):
        set_compute_dtype(model, torch.bfloat16)
