"""The port's vector attention (sug_tpu_torch/ops/vector_attention.py) on the
CPU, where the wrapper runs its plain PyTorch version, against the JAX
package: its f32 reference ``vector_attention_reference(bf16_mm=False)``, the
Pallas kernel ``_fwd_pallas`` itself in interpret mode, and ``jax.grad`` of
the reference for the gradients.

Tolerances, each with its cause:
- against the f32 reference, 1e-5 relative to max(|reference|, 1): f32 on
  both sides, the same neighbours, sums over up to 512 products taken in
  another order (measured up to 4.3e-7);
- against the Pallas kernel in its precise mode with 3-pass MLP products,
  2e-5: that kernel gathers key and val through a bf16 hi/lo pair, which
  keeps 16 of f32's 24 mantissa bits (2^-17 relative), and its 3-pass
  products drop the lo·lo term (measured up to 6.1e-6);
- gradients, 1e-5 relative L2 per input: both sides differentiate the same
  f32 math, summing over every edge in another order; the softmax makes the
  true gradient of bg2 zero, so only its size is checked.

Neighbour indices must equal the reference's (the same distance formula, the
lowest index first among ties); against the Pallas kernel, whose distances
are 3-pass bf16 dots, the neighbour sets may differ only at near-ties.

The backward has its own file, ``test_torch_port_vector_attention_bwd.py``.
The CUDA kernel cannot run here; ``chip_smoke.py`` holds it against the
plain version on the card.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sug_tpu.ops.geometry import knn_indices
from sug_tpu.ops.vector_attention_pallas import _fwd_pallas, vector_attention_reference
from sug_tpu_torch.ops import vector_attention as tva

REF_TOL = 1e-5
PALLAS_TOL = 2e-5
GRAD_TOL = 1e-5
WEIGHTS = ("wd1", "bd1", "wd2", "bd2", "wg1", "bg1", "wg2", "bg2")


def _data(b, n, d, seed, dup=False):
    """xyz, q, key, val and the eight weights, seeded; weights scaled as
    lecun-normal inits (as tests/test_vector_attention_fused.py makes them)."""
    rng = np.random.default_rng(seed)

    def f32(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    xyz = f32(b, n, 3)
    if dup:
        xyz[:, 64] = xyz[:, 0]
        xyz[:, 65] = xyz[:, 0]
    s = d**-0.5
    return [xyz, f32(b, n, d), f32(b, n, d), f32(b, n, d),
            f32(3, d, scale=3**-0.5), f32(d, scale=0.1), f32(d, d, scale=s), f32(d, scale=0.1),
            f32(d, d, scale=s), f32(d, scale=0.1), f32(d, d, scale=s), f32(d, scale=0.1)]


def _port(args, k):
    return tva.vector_attention_fwd(*(torch.from_numpy(a) for a in args), k)


def _close(got, want, tol, name):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert err.max() <= tol, f"{name}: {err.max():.3e} relative (> {tol})"


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


@pytest.mark.parametrize("b,n,d,k", [(2, 128, 128, 5), (2, 256, 512, 16), (2, 100, 128, 16)],
                         ids=["n128-d128-k5", "n256-d512-k16", "ragged-n100-k16"])
def test_plain_matches_f32_reference(b, n, d, k):
    args = _data(b, n, d, seed=n + k)
    want = vector_attention_reference(*map(jnp.asarray, args), k, bf16_mm=False)
    out, m, l, idx = _port(args, k)
    assert out.shape == m.shape == l.shape == (b, n, d) and idx.shape == (b, n, k)
    assert idx.dtype == torch.int32
    _close(out.numpy(), want, REF_TOL, "out")
    np.testing.assert_array_equal(idx.numpy(), np.asarray(knn_indices(jnp.asarray(args[0]), k)))
    # l sums k terms exp(z - m) <= 1, one of them exactly 1
    assert (l >= 1.0).all() and (l <= k * (1 + 1e-6)).all()


def _pallas(args, k):
    """``_fwd_pallas`` as ``fused_vector_attention`` calls it: xyz and wd1
    padded to 128 lanes, the biases stacked into (8, D), and 1/sqrt(D)
    folded into Wg2 and bg2. Returns out, m, l and idx as (B, N, k)."""
    xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2 = map(jnp.asarray, args)
    s = 1.0 / jnp.sqrt(jnp.asarray(q.shape[-1], jnp.float32))
    xyzp = jnp.pad(xyz, ((0, 0), (0, 0), (0, 125)))
    wd1p = jnp.pad(wd1, ((0, 125), (0, 0)))
    bias = jnp.pad(jnp.stack([bd1, bd2, bg1, bg2 * s]), ((0, 4), (0, 0)))
    out, m, l, idx_t = _fwd_pallas(xyzp, q, key, val, wd1p, wd2, wg1, wg2 * s, bias, k,
                                   interpret=True, precise=True)
    return out, m, l, np.swapaxes(np.asarray(idx_t), 1, 2)


def _near_tie_flips(xyz, got_idx, want_idx, k):
    """Rows whose neighbour sets differ; every differing neighbour must be
    numerically tied with the k-th nearest (tests/test_vector_attention_fused.py)."""
    pts = np.asarray(xyz, np.float64)
    differ = np.zeros(got_idx.shape[:2], bool)
    for b in range(got_idx.shape[0]):
        d2 = ((pts[b][:, None, :] - pts[b][None, :, :]) ** 2).sum(-1)
        for n in range(got_idx.shape[1]):
            a, r = set(got_idx[b, n].tolist()), set(want_idx[b, n].tolist())
            if a == r:
                continue
            differ[b, n] = True
            kth = np.sort(d2[n])[k - 1]
            for j in a ^ r:
                assert abs(d2[n, j] - kth) < 1e-4 + 1e-4 * kth, f"non-tie flip at ({b},{n},{j})"
    return differ


@pytest.mark.parametrize("b,n,d,k", [(2, 128, 128, 8), (1, 256, 512, 16)],
                         ids=["n128-d128-k8", "n256-d512-k16"])
def test_plain_matches_pallas_interpret(monkeypatch, b, n, d, k):
    monkeypatch.setenv("SUG_VECATTN_F32_MM", "3pass")
    args = _data(b, n, d, seed=n + k + 1)
    want = _pallas(args, k)
    got = _port(args, k)
    differ = _near_tie_flips(args[0], got[3].numpy(), want[3], k)
    assert differ.mean() <= 0.005
    agree = ~differ
    for name, g, w in zip(("out", "m", "l"), got[:3], want[:3]):
        _close(g.numpy()[agree], np.asarray(w)[agree], PALLAS_TOL, name)


def test_duplicate_points_give_exact_idx():
    """Exact duplicates tie; the lowest index wins, in the reference's kNN and
    in the Pallas kernel alike."""
    args = _data(1, 128, 128, seed=2, dup=True)
    got = _port(args, 4)[3].numpy()
    np.testing.assert_array_equal(got, np.asarray(knn_indices(jnp.asarray(args[0]), 4)))
    np.testing.assert_array_equal(got, _pallas(args, 4)[3])
    np.testing.assert_array_equal(got[0, 0, :3], [0, 64, 65])


def test_gradients_match_jax_grad():
    args = _data(2, 64, 128, seed=3)
    k = 8
    cot = np.random.default_rng(9).normal(size=args[1].shape).astype(np.float32)

    def loss(*diff):
        return jnp.sum(vector_attention_reference(jnp.asarray(args[0]), *diff, k,
                                                  bf16_mm=False) * cot)

    want = jax.grad(loss, argnums=tuple(range(11)))(*map(jnp.asarray, args[1:]))
    xyz = torch.from_numpy(args[0]).requires_grad_(True)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args[1:]]
    out = tva.fused_vector_attention(xyz, *leaves, k)
    torch.sum(out * torch.from_numpy(cot)).backward()
    assert xyz.grad is None  # xyz only selects neighbours
    scale = max(np.linalg.norm(np.asarray(w)) for w in want)
    for name, leaf, w in zip(("q", "key", "val") + WEIGHTS, leaves, want):
        if name == "bg2":
            # a per-channel shift of every logit leaves the softmax unchanged
            assert np.linalg.norm(leaf.grad.numpy()) < 1e-5 * scale
            continue
        assert _rel_l2(leaf.grad.numpy(), w) <= GRAD_TOL, name


def test_wrapper_validates_before_dispatch():
    args = [torch.from_numpy(a) for a in _data(1, 16, 128, seed=4)]

    def call(i=None, value=None, k=4):
        a = list(args)
        if i is not None:
            a[i] = value
        return tva.vector_attention_fwd(*a, k)

    with pytest.raises(TypeError, match="float32"):
        call(1, args[1].double())
    with pytest.raises(ValueError, match="contiguous"):
        call(2, args[2].transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="shapes"):
        call(3, args[3][:, :8].contiguous())
    with pytest.raises(ValueError, match="shapes"):
        call(0, torch.zeros((1, 16, 4)))  # C must be 3
    with pytest.raises(ValueError, match="shapes"):
        call(6, args[6][:64].contiguous())
    with pytest.raises(ValueError, match="k <= min"):
        call(k=17)
    with pytest.raises(ValueError, match="k <= min"):
        call(k=0)
    with pytest.raises(ValueError, match="no path for device"):
        tva.vector_attention_fwd(*(a.to("meta") for a in args), 4)


def test_cpu_path_does_not_count_launches():
    before = tva.vector_attention_fwd.launches
    _port(_data(1, 16, 128, seed=5), 4)
    assert tva.vector_attention_fwd.launches == before


def _tf32(x):
    """The TF32 rounding of f32 values as ``cvt.rna.tf32.f32`` does it: to
    nearest (ties away from zero) on the float32 bits, 10 mantissa bits
    kept, the low 13 cleared."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _mm_tf32(a, w, passes):
    """a (rows, D) · w (D, D) as the kernels' tensor-core product: chunks of
    16 of the inner index in ascending order, each summed apart, lo·hi +
    hi·lo and then hi·hi of the split operands (``passes=3``) or hi·hi alone
    (``passes=1``, single-pass TF32), and added to one f32 accumulator. The
    sums round to nearest, where the tensor cores' sums inside a chunk
    round toward zero: this emulates the operand split and the chunk order,
    not that truncation."""
    a_hi, w_hi = _tf32(a), _tf32(w)
    a_lo, w_lo = _tf32(a - a_hi), _tf32(w - w_hi)
    acc = np.zeros((a.shape[0], w.shape[1]), np.float32)
    for k in range(0, a.shape[1], 16):
        s = slice(k, k + 16)
        part = a_hi[:, s] @ w_hi[s]
        if passes == 3:
            part = (a_lo[:, s] @ w_hi[s] + a_hi[:, s] @ w_lo[s]) + part
        acc += part
    return acc


def _edge_chain(args, idx, mm, dtype):
    """The forward's per-edge layers and softmax for the queries of ``idx``
    (Q, 16) in cloud 0, with the D×D products by ``mm``, in ``dtype``."""
    xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2 = (
        np.asarray(a, dtype) for a in args)
    xyz, q, key, val = xyz[0], q[0], key[0], val[0]
    n = np.repeat(np.arange(len(idx)), idx.shape[1])
    j = idx.reshape(-1)
    relu_d = np.maximum((xyz[n] - xyz[j]) @ wd1 + bd1, 0)
    t = {"pos": mm(relu_d, wd2) + bd2}
    t["att_in"] = (q[n] - key[j]) + t["pos"]
    t["relu_g"] = np.maximum(mm(t["att_in"], wg1) + bg1, 0)
    t["z"] = (mm(t["relu_g"], wg2) + bg2) * dtype(tva.softmax_scale(q.shape[-1]))
    z = t["z"].reshape(len(idx), idx.shape[1], -1)
    t["m"] = z.max(1)
    e = np.exp(z - t["m"][:, None])
    t["l"] = e.sum(1)
    t["out"] = (e * (val[j] + t["pos"]).reshape(z.shape)).sum(1) / t["l"]
    return t


def test_3xtf32_product_holds_the_card_limits():
    """Why the kernels take three TF32 products per f32 product: the three
    chained D×D layers at D=512, emulated in 3×TF32 on 384 edge rows (24
    queries × 16 neighbours), stay within ``chip_smoke.py``'s limits against
    a float64 run of the same f32 inputs (per-edge tensors VA_EDGE_TOL of
    max(|x|, rms), out/m/l VA_REL_TOL of max(|x|, 1)); single-pass TF32
    misses them by far."""
    from chip_smoke import VA_EDGE_TOL, VA_REL_TOL

    args = _data(1, 256, 512, seed=11)
    idx = _port(args, 16)[3].numpy()[0, :24]
    want = _edge_chain(args, idx, np.matmul, np.float64)
    errors = {}
    for passes in (3, 1):
        got = _edge_chain(args, idx, lambda a, w: _mm_tf32(a, w, passes), np.float32)
        err = {}
        for name in ("pos", "att_in", "relu_g", "z"):
            scale = np.maximum(np.abs(want[name]), np.sqrt(np.mean(want[name] ** 2)))
            err[name] = (np.abs(got[name] - want[name]) / scale).max() / VA_EDGE_TOL
        for name in ("out", "m", "l"):
            scale = np.maximum(np.abs(want[name]), 1.0)
            err[name] = (np.abs(got[name] - want[name]) / scale).max() / VA_REL_TOL
        errors[passes] = err
    assert max(errors[3].values()) <= 1.0, errors[3]
    assert max(errors[1].values()) > 10.0, errors[1]
