"""The EdgeConv kernels' ``values_bf16`` mode (the bf16 policy's) on the CPU,
where the port runs its plain versions, against the JAX package's Pallas
kernels in interpret mode with ``values_bf16=True``: the forward
(``fused_edgeconv_reduce`` / ``fused_cross_edgeconv_reduce``) and its custom
VJP, self-kNN at k=20 as DGCNN's blocks run it, the SA-node's cross kNN at
S=64, k=64, a ragged cross case (S=61, N=200) and duplicate lattice points.

Tolerances. Neighbour sets equal (selection stays f32 in both), and index
for index where every distance is exact (the lattice). amax and amin equal
bit for bit: both take the max/min of the same bf16-rounded ``u`` plus the
same ``v`` in one f32 add. s1, s2 to 1e-5 relative and 1e-5 of the largest
|value|: the same k f32 terms summed in another order. dU and dV likewise,
to 1e-5 of the largest |value|: sums of the same terms (for dU the bf16
rounding of each edge's cotangent) in another order. One allowance on dU:
XLA on the CPU may round an edge cotangent ``da`` an f32 ulp away from the
port's separately rounded ``damax·sel + damin·sel + ds1 + (2a)·ds2`` (it
may contract a product into the add), and where ``da`` lies within an ulp of
a bf16 rounding midpoint the two sides round it to neighbouring bf16 values
(some 3 to 8 of 10^5 terms here, one of which the Pallas kernel rounds the
other way). So a key with such a term may differ by up to the sum of those
terms' bf16 steps, and by the f32 tolerance everywhere else.

The plain versions against each other, bit for bit: ``gather_reduce_plain``
on ``edgeconv_reduce_plain``'s idx gives its amax and amin, and both take a
bf16 ``u`` and its f32 original alike; the backward's stage plains
(``key_csr_plain``, ``first_hits_plain``, ``du_by_key_plain``) give
``edgeconv_reduce_bwd_plain``'s dU (the same rounded terms added in entry
order), dV to the tolerance above (``torch.sum`` adds in its own order).
The CUDA kernels cannot run here; ``chip_smoke.py`` holds the gather, rows
and keys kernels bit for bit to these plain versions on the card.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sug_tpu.ops.edgeconv_pallas import (
    fused_cross_edgeconv_reduce as pallas_cross,
    fused_edgeconv_reduce as pallas_self,
)
from sug_tpu_torch.ops import edgeconv as te

RTOL = 1e-5
NAMES = ("amax", "amin", "s1", "s2")
# (b, s, n, c, f, k, cross, kind); N a multiple of 128 for the Pallas self
# kernel, ragged keys in the cross one
SHAPES = [
    (2, 128, 128, 16, 32, 20, False, "normal"),
    (1, 64, 128, 3, 32, 64, True, "normal"),
    (1, 61, 200, 3, 24, 64, True, "normal"),
    (1, 128, 128, 4, 16, 20, False, "lattice"),
]
IDS = ["self-k20", "sa-node", "ragged-cross", "self-duplicates"]


def _close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * max(1.0, np.abs(want).max()),
                               err_msg=name)


def _inputs(shape, seed=0):
    b, s, n, c, f, k, cross, kind = shape
    rng = np.random.default_rng(seed)
    if kind == "lattice":  # integer points, duplicates: every distance exact
        kv = rng.integers(-3, 4, size=(b, n, c)).astype(np.float32)
        kv[:, 64] = kv[:, 0]
    else:
        kv = rng.normal(size=(b, n, c)).astype(np.float32)
    q = (kv[:, :s] + 0.05 * rng.normal(size=(b, s, c))).astype(np.float32) if cross else kv
    u = rng.normal(size=(b, n, f)).astype(np.float32)
    v = (np.zeros((b, s, f)) if cross else rng.normal(size=(b, s, f))).astype(np.float32)
    cot = [rng.normal(size=(b, s, f)).astype(np.float32) for _ in range(4)]
    return q, kv, u, v, cot


@functools.lru_cache(maxsize=None)
def _pallas(shape):
    """The Pallas kernels' outputs and (du, dv) of sum(outputs * cot), in
    interpret mode with values_bf16, from one compile per shape."""
    *_, k, cross, _ = shape
    q, kv, u, v, cot = _inputs(shape)

    def loss(u_, v_, q_, kv_, cot_):  # q, kv and cot as arguments: no constant folding
        if cross:
            outs = pallas_cross(q_, kv_, u_, v_, k, interpret=True, values_bf16=True)
        else:
            outs = pallas_self(kv_, u_, v_, k, True, values_bf16=True)
        return sum(jnp.sum(o * w) for o, w in zip(outs[:4], cot_)), outs

    fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
    (_, outs), grads = fn(*map(jnp.asarray, (u, v, q, kv)), [jnp.asarray(w) for w in cot])
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _port(shape):
    """The port's forward and its gradients through ``EdgeConvReduce`` with
    values_bf16, on the plain versions."""
    k = shape[5]
    q, kv, u, v, cot = _inputs(shape)
    tu = torch.from_numpy(u).requires_grad_()
    tv = torch.from_numpy(v).requires_grad_()
    outs = te.EdgeConvReduce.apply(torch.from_numpy(q), torch.from_numpy(kv), tu, tv, k, True)
    loss = sum(torch.sum(o * torch.from_numpy(w)) for o, w in zip(outs[:4], cot))
    du, dv = torch.autograd.grad(loss, (tu, tv))
    return [o.detach().numpy() for o in outs], (du.numpy(), dv.numpy())


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_values_bf16_matches_pallas_interpret(shape):
    (want, (want_du, want_dv)), (got, (du, dv)) = _pallas(shape), _port(shape)
    idx, want_idx = got[4], want[4]
    if shape[-1] == "lattice":
        np.testing.assert_array_equal(idx, want_idx)
    else:
        np.testing.assert_array_equal(np.sort(idx, -1), np.sort(want_idx, -1))
    for name, g, w in zip(NAMES, got, want):
        if name in ("amax", "amin"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            _close(g, w, name)
    # the mode is on: the values are the bf16-rounded u, not u itself
    u = torch.from_numpy(_inputs(shape)[2])
    assert not torch.equal(te.round_bf16(u), u)
    assert du.dtype == np.float32
    np.testing.assert_array_less(np.abs(du - want_du), _du_tolerance(shape, got, want_du))
    _close(dv, want_dv, "dv")


def _du_tolerance(shape, got, want_du):
    """Per key: the f32 tolerance, plus the bf16 step of each of its edge
    cotangents that an f32 ulp either way would round to another bf16."""
    _, _, u, v, cot = _inputs(shape)
    idx, amax, amin = (torch.from_numpy(got[i]) for i in (4, 0, 1))
    da = te.edge_cotangents(idx, torch.from_numpy(u), torch.from_numpy(v), amax, amin,
                            *(torch.from_numpy(w) for w in cot), values_bf16=True)
    up, down = (te.round_bf16(torch.nextafter(da, torch.full_like(da, x)))
                for x in (float("inf"), float("-inf")))
    step = torch.where((up != down), (up - down).abs(), 0.0)
    fragile = te.scatter_keys(step, idx, u.shape[1]).numpy()
    return RTOL * max(1.0, np.abs(want_du).max()) + RTOL * np.abs(want_du) + fragile + 1e-30


@pytest.mark.parametrize("shape", SHAPES[:3], ids=IDS[:3])
def test_values_bf16_plains_agree(shape):
    """The plain versions of the mode against each other, bit for bit; a
    bf16 u and its f32 original give the same bits; and the mode differs
    from the f32 one."""
    k = shape[5]
    q, kv, u, v, cot = _inputs(shape)
    q, kv, u, v = (torch.from_numpy(a) for a in (q, kv, u, v))
    cot = [torch.from_numpy(w) for w in cot]
    plain = te.edgeconv_reduce_plain(q, kv, u, v, k, values_bf16=True)
    from_bf16 = te.edgeconv_reduce(q, kv, u.to(torch.bfloat16), v, k, values_bf16=True)
    gathered = te.gather_reduce_plain(plain[4], u, v, values_bf16=True)
    for name, p, b, g in zip(NAMES, plain, from_bf16, gathered):
        assert torch.equal(p, b), name
        if name in ("amax", "amin"):
            assert torch.equal(p, g), name
        else:
            _close(g.numpy(), p.numpy(), name)
    f32 = te.edgeconv_reduce_plain(q, kv, u, v, k)
    assert torch.equal(f32[4], plain[4]) and not torch.equal(f32[0], plain[0])

    args = (plain[4], u, v, plain[0], plain[1], *cot)
    du, dv = te.edgeconv_reduce_bwd_plain(*args, values_bf16=True)
    du_b, dv_b = te.edgeconv_reduce_bwd_plain(plain[4], u.to(torch.bfloat16), *args[2:],
                                              values_bf16=True)
    assert torch.equal(du, du_b) and torch.equal(dv, dv_b)
    assert du.dtype == dv.dtype == torch.float32
    sdu, sdv, *_ = te.edgeconv_reduce_bwd_stages_plain(*args, values_bf16=True)
    assert torch.equal(sdu, du)
    _close(sdv.numpy(), dv.numpy(), "dv")
    # dU sums the rounded cotangents, dV the unrounded ones
    da = te.edge_cotangents(*args, values_bf16=True)
    assert torch.equal(du, te.scatter_keys(te.round_bf16(da), plain[4], u.shape[1]))
    assert not torch.equal(du, te.scatter_keys(da, plain[4], u.shape[1]))


def test_values_bf16_dtype_rules():
    """A bf16 u only in values_bf16 mode, every other input f32 there (no
    f64), on both wrappers; du comes back f32, and bf16 through autograd
    where u was bf16."""
    shape = SHAPES[1]
    q, kv, u, v, cot = _inputs(shape)
    q, kv, u, v = (torch.from_numpy(a) for a in (q, kv, u, v))
    k = shape[5]
    with pytest.raises(TypeError, match="bfloat16"):
        te.edgeconv_reduce(q, kv, u.to(torch.bfloat16), v, k)
    with pytest.raises(TypeError, match="float32"):
        te.edgeconv_reduce(q.double(), kv.double(), u.double(), v.double(), k, values_bf16=True)
    with pytest.raises(TypeError, match="float32"):
        te.edgeconv_reduce(q, kv, u, v.to(torch.bfloat16), k, values_bf16=True)
    amax, amin, _, _, idx = te.edgeconv_reduce(q, kv, u, v, k, values_bf16=True)
    grads = [torch.from_numpy(w) for w in cot]
    with pytest.raises(TypeError, match="bfloat16"):
        te.edgeconv_reduce_bwd(idx, u.to(torch.bfloat16), v, amax, amin, *grads)
    ub = u.to(torch.bfloat16).requires_grad_()
    out = te.fused_cross_edgeconv_reduce(q, kv, ub, v, k, values_bf16=True)
    (du,) = torch.autograd.grad(out[0].sum(), ub)
    assert out[0].dtype == torch.float32 and du.dtype == torch.bfloat16
