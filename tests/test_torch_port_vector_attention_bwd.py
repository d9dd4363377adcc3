"""The port's vector-attention backward
(sug_tpu_torch/ops/vector_attention.py) on the CPU, where the wrapper runs
its plain PyTorch version ``vector_attention_bwd_plain``, against
``torch.autograd`` of the plain forward, ``jax.grad`` of the JAX package's
f32 reference, and the Pallas kernels ``_bwd_pallas`` themselves in
interpret mode.

Tolerances, each with its cause:
- against ``torch.autograd`` and ``jax.grad``, 1e-5 relative L2 per output:
  the same f32 math on the same neighbours, summed over every edge in
  another order (measured up to 4e-7);
- against the Pallas kernels in their precise mode with 3-pass products,
  2e-3 relative L2, the bound the JAX package's own test holds them to
  against its f32 reference: those kernels gather and scatter key and val
  through a bf16 hi/lo pair (2^-17 relative) and their 3-pass products drop
  the lo·lo term, and dq, dkey, dWg1 and dbg1 are sums of cotangents of both
  signs that cancel (measured 9.5e-4 on dq and dbg1, at most 1.7e-5 on the
  outputs without such a chain). Both sides are fed the Pallas forward's
  own idx, m, l and out;
- the softmax makes the true gradient of bg2 zero (a per-channel shift of
  every logit changes nothing), so dbg2 is held to 1e-5 of the largest
  gradient's norm, not relatively.

The CUDA kernels cannot run here; ``chip_smoke.py`` holds them against the
plain version on the card.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sug_tpu.ops.vector_attention_pallas import (
    _bwd_pallas,
    _fwd_pallas,
    vector_attention_reference,
)
from sug_tpu_torch.models.ptran import VectorAttentionBlock
from sug_tpu_torch.ops import vector_attention as tva
from tests.test_torch_port_vector_attention import _data, _rel_l2

TOL = 1e-5
PALLAS_TOL = 2e-3


def _tensors(args):
    return [torch.from_numpy(a) for a in args]


def _cotangent(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _plain_bwd(args, k, cot):
    """``vector_attention_bwd`` on the plain forward's own idx, m, l, out."""
    targs = _tensors(args)
    out, m, l, idx = tva.vector_attention_fwd(*targs, k)
    return tva.vector_attention_bwd(*targs, k, idx, m, l, out, torch.from_numpy(cot))


def _assert_grads(got, want, tol):
    scale = max(np.linalg.norm(np.asarray(w)) for w in want)
    for name, g, w in zip(tva.BWD_NAMES, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, name
        if name == "dbg2":
            assert np.linalg.norm(g) < 1e-5 * scale and np.linalg.norm(w) < 1e-5 * scale
            continue
        assert _rel_l2(g, w) <= tol, f"{name}: {_rel_l2(g, w):.3e}"


@pytest.mark.parametrize("b,n,d,k,dup", [(2, 64, 128, 8, False), (1, 48, 256, 16, False),
                                         (2, 100, 128, 5, True), (3, 3, 128, 3, False)],
                         ids=["n64-d128-k8", "n48-d256-k16", "dup-n100-k5", "n3-k3"])
def test_plain_bwd_matches_autograd(b, n, d, k, dup):
    """Also with duplicate points (0, 64, 65 of each cloud are each other's
    nearest neighbours) and with k below the kernel's 16 slots."""
    args = _data(b, n, d, seed=n + k, dup=dup)
    cot = _cotangent(args[1].shape, 1)
    leaves = [t.requires_grad_(True) for t in _tensors(args[1:])]
    out, _, _, idx = tva.vector_attention_fwd_plain(torch.from_numpy(args[0]), *leaves, k)
    if dup:
        assert idx[0, 0, :3].tolist() == [0, 64, 65]
    want = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    _assert_grads([g.numpy() for g in _plain_bwd(args, k, cot)], [w.numpy() for w in want], TOL)


def test_plain_bwd_matches_jax_grad():
    args = _data(2, 64, 128, seed=3)
    k = 8
    cot = _cotangent(args[1].shape, 9)

    def loss(*diff):
        return jnp.sum(vector_attention_reference(jnp.asarray(args[0]), *diff, k,
                                                  bf16_mm=False) * cot)

    want = jax.grad(loss, argnums=tuple(range(11)))(*map(jnp.asarray, args[1:]))
    _assert_grads([g.numpy() for g in _plain_bwd(args, k, cot)], want, TOL)


def test_plain_bwd_matches_pallas_interpret(monkeypatch):
    """``_bwd_pallas`` as ``_vecattn_bwd`` calls it, in the layouts
    ``fused_vector_attention`` builds: xyz and wd1 padded to 128 lanes, the
    biases stacked into (8, D), 1/sqrt(D) folded into Wg2 and bg2, idx as
    (B, k, N). Its dWg2 and dbg2 are gradients of the folded weights, so the
    port's are s times them."""
    monkeypatch.setenv("SUG_VECATTN_F32_MM", "3pass")
    b, n, d, k = 2, 128, 128, 8
    args = _data(b, n, d, seed=23)
    cot = _cotangent(args[1].shape, 13)
    xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2 = map(jnp.asarray, args)
    s = 1.0 / jnp.sqrt(jnp.asarray(d, jnp.float32))
    xyzp = jnp.pad(xyz, ((0, 0), (0, 0), (0, 125)))
    wd1p = jnp.pad(wd1, ((0, 125), (0, 0)))
    bias = jnp.pad(jnp.stack([bd1, bd2, bg1, bg2 * s]), ((0, 4), (0, 0)))
    out, m, l, idx_t = _fwd_pallas(xyzp, q, key, val, wd1p, wd2, wg1, wg2 * s, bias, k,
                                   interpret=True, precise=True)
    dq, dkey, dval, dwd1, dwd2, dwg1, dwg2, dbias = _bwd_pallas(
        idx_t, xyzp, q, key, val, wd1p, wd2, wg1, wg2 * s, bias, m, l, out, jnp.asarray(cot),
        interpret=True, precise=True)
    assert not np.asarray(dwd1[3:]).any()  # the padded lanes of xyz
    want = (dq, dkey, dval, dwd1[:3], dbias[0], dwd2, dbias[1], dwg1, dbias[2],
            dwg2 * s, dbias[3] * s)
    idx = torch.from_numpy(np.ascontiguousarray(np.swapaxes(np.asarray(idx_t), 1, 2)))
    saved = [torch.from_numpy(np.array(a)) for a in (m, l, out)]
    got = tva.vector_attention_bwd(*_tensors(args), k, idx, *saved, torch.from_numpy(cot))
    _assert_grads([g.numpy() for g in got], want, PALLAS_TOL)


def test_padded_neighbour_slots_would_count_twice():
    """The kernels give a query 16 slots and repeat slot 0 past k with zero
    weight. The formulas say why the weight must be zero: repeating an edge
    in idx (as a padded slot would) changes dkey, dval and the weight
    gradients."""
    args = _data(1, 16, 128, seed=6)
    targs = _tensors(args)
    k = 4
    out, m, l, idx = tva.vector_attention_fwd(*targs, k)
    cot = torch.from_numpy(_cotangent(out.shape, 2))
    want = tva.vector_attention_bwd_plain(*targs, k, idx, m, l, out, cot)
    padded = torch.cat([idx, idx[:, :, :1]], dim=2).contiguous()
    got = tva.vector_attention_bwd_plain(*targs, k + 1, padded, m, l, out, cot)
    for name in ("dkey", "dval", "dwg1", "dwd2"):
        i = tva.BWD_NAMES.index(name)
        assert _rel_l2(got[i].numpy(), want[i].numpy()) > 1e-2, name


def test_function_replays_the_saved_forward(monkeypatch):
    """The autograd Function hands its backward the forward's own idx, m, l
    and out (nothing is reselected), and xyz gets no gradient."""
    seen = {}
    real = tva.vector_attention_bwd

    def spy(*a):
        seen["args"] = a
        return real(*a)

    monkeypatch.setattr(tva, "vector_attention_bwd", spy)
    args = _data(1, 32, 128, seed=7)
    xyz = torch.from_numpy(args[0]).requires_grad_(True)
    leaves = [t.requires_grad_(True) for t in _tensors(args[1:])]
    out = tva.fused_vector_attention(xyz, *leaves, 6)
    cot = torch.from_numpy(_cotangent(out.shape, 3))
    (out * cot).sum().backward()
    want = tva.vector_attention_fwd_plain(*_tensors(args), 6)
    k, idx, m, l, saved_out, dout = seen["args"][12:]
    assert k == 6 and idx.dtype == torch.int32 and torch.equal(idx, want[3])
    for g, w in zip((saved_out, m, l), want[:3]):
        assert torch.equal(g, w)
    assert torch.equal(dout, cot) and xyz.grad is None
    assert all(leaf.grad is not None and leaf.grad.shape == leaf.shape for leaf in leaves)


def test_block_weight_gradients_land_in_torch_layout():
    """``VectorAttentionBlock`` hands the op transposed weights; autograd
    carries the (in, out) gradients back into ``layer.weight.grad`` in
    torch's (out, in) layout, equal to differentiating the plain forward."""
    torch.manual_seed(0)
    block = VectorAttentionBlock(32, 128, 8)
    xyz, feats = torch.randn(2, 40, 3), torch.randn(2, 40, 32)
    cot = torch.randn(2, 40, 32)
    (block(xyz, feats) * cot).sum().backward()
    got = {n: p.grad.clone() for n, p in block.named_parameters()}
    block.zero_grad()

    x = block.fc1(feats)
    weights = []
    for layer in (block.fc_delta1, block.fc_delta2, block.fc_gamma1, block.fc_gamma2):
        weights += [layer.weight.t(), layer.bias]
    res = tva.vector_attention_fwd_plain(xyz, block.w_qs(x), block.w_ks(x), block.w_vs(x),
                                         *weights, 8)[0]
    ((block.fc2(res) + feats) * cot).sum().backward()
    scale = max(p.grad.norm().item() for p in block.parameters())
    for n, p in block.named_parameters():
        assert got[n].shape == p.shape
        if n == "fc_gamma2.bias":
            assert got[n].norm().item() < 1e-5 * scale
            continue
        assert _rel_l2(got[n].numpy(), p.grad.numpy()) <= TOL, n


def test_bwd_wrapper_validates_before_dispatch():
    targs = _tensors(_data(1, 16, 128, seed=4))
    out, m, l, idx = tva.vector_attention_fwd(*targs, 4)
    saved = [idx, m, l, out, torch.ones_like(out)]

    def call(i, value, k=4):
        s = list(saved)
        s[i] = value
        return tva.vector_attention_bwd(*targs, k, *s)

    with pytest.raises(ValueError, match="idx must be"):
        call(0, idx.long())
    with pytest.raises(ValueError, match="idx must be"):
        call(0, idx, k=5)
    with pytest.raises(TypeError, match="m must be float32"):
        call(1, m.double())
    with pytest.raises(ValueError, match="dout must be contiguous"):
        call(4, out.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match=r"out must be \(B,N,D\)"):
        call(3, out[:, :8].contiguous())
    with pytest.raises(TypeError, match="float32"):
        tva.vector_attention_bwd(targs[0], targs[1].double(), *targs[2:], 4, *saved)
    with pytest.raises(ValueError, match="no path for device"):
        tva.vector_attention_bwd(*(t.to("meta") for t in targs), 4,
                                 *(t.to("meta") for t in saved))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tva.staged_edge_terms(*targs, 4, *saved)


def test_cpu_path_counts_no_launches():
    before = (tva.vector_attention_bwd.calls, dict(tva.vector_attention_bwd.launches))
    _plain_bwd(_data(1, 16, 128, seed=5), 4, _cotangent((1, 16, 128), 0))
    assert (tva.vector_attention_bwd.calls, tva.vector_attention_bwd.launches) == before
    assert set(before[1]) == {"edge", "wgrad", "thin", "scatter", "reduce"}


@pytest.mark.parametrize("n,d,want", [(1024, 512, 16), (256, 512, 64), (1000, 128, 65), (4, 512, 4096)])
def test_clouds_per_chunk(n, d, want):
    """The backward kernels stage nine (clouds·N·16, D) planes at a time."""
    assert tva.clouds_per_chunk(n, d) == want
    assert want * n * 16 * d <= tva.MAX_PLANE_FLOATS < (want + 1) * n * 16 * d
