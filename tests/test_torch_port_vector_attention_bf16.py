"""The bf16 mode of the port's vector attention
(sug_tpu_torch/ops/vector_attention.py, the TPU kernels' ``precise=False``)
on the CPU, where the wrappers run their plain PyTorch versions, against the
Pallas kernels ``_fwd_pallas`` and ``_bwd_pallas`` in interpret mode with
``precise=False``, at the smallest shapes that tile (B=2, N=128, D=128,
k=8): key and val in bf16, the weights f32, in the layouts
``fused_vector_attention`` builds (xyz and wd1 padded to 128 lanes, the
biases stacked, s = 1/sqrt(D) folded into Wg2 and bg2).

Tolerances, each with its cause. Both sides round the same operands to bf16
at the same points and multiply them exactly, but their f32 sums run in
another order, and where a sum lies within that order's rounding of a bf16
rounding boundary, the two round the next product's operand to neighbouring
bf16 values, 2^-8 of it apart (about 1e-3 of the operands here). So:
- forward, on the rows whose neighbour sets agree (near-tie flips allowed
  as in ``test_plain_matches_pallas_interpret``): out, m, l to FWD_TOL of
  max(|Pallas|, 1) element by element (one term of a 128-term product moved
  by 2^-8; measured up to 4.8e-4) and to FWD_REL_L2 relative L2 (the flips
  are rare; measured up to 9.0e-5). Rounding Wg2 before folding s into it,
  bf16(Wg2)·s in place of bf16(Wg2·s), moves every logit: m then lies 1.9e-3
  away in relative L2, and the test shows that it fails;
- backward, fed the Pallas forward's idx, m, l and out, each output in
  relative L2: dq, dkey, dWg1 and dbg1 to CANCEL_REL_L2 (sums of cotangents
  of both signs that cancel, where a relu gate switched by a flipped
  operand weighs most; measured up to 7.6e-3, against 4.4e-2 to 7.4e-2
  between the Pallas bf16 mode and the f32 version), the others to
  BWD_REL_L2 (measured up to 2.2e-4); dWg2 and dbg2 are the folded weights'
  gradients times s; the true gradient of bg2 is zero (a per-channel shift
  of every logit leaves the softmax unchanged), so dbg2 is held to 1e-3 of
  the largest gradient's norm, as the JAX package's own test holds it.

The CUDA kernels' bf16 instances cannot run here; ``chip_smoke.py`` holds
them against these plain versions on the card.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sug_tpu.ops.vector_attention_pallas import _bwd_pallas, _fwd_pallas
from sug_tpu_torch.ops import vector_attention as tva
from tests.test_torch_port_vector_attention import _data, _near_tie_flips, _rel_l2

B, N, D, K = 2, 128, 128, 8
FWD_TOL = 2e-3
FWD_REL_L2 = 5e-4
CANCEL_REL_L2 = 2e-2
CANCELLING = ("dq", "dkey", "dwg1", "dbg1")
BWD_REL_L2 = 1e-3


def _port_args(args):
    """The port's inputs: key and val in bf16, the rest f32."""
    return [torch.from_numpy(a).to(torch.bfloat16) if i in (2, 3) else torch.from_numpy(a)
            for i, a in enumerate(args)]


@pytest.fixture(scope="module")
def pallas():
    """The inputs, a cotangent, and the Pallas kernels' bf16 forward (out,
    m, l, idx as (B, N, k)) and backward (the port's ``BWD_NAMES``, dWg2 and
    dbg2 times s)."""
    args = _data(B, N, D, seed=31)
    cot = np.random.default_rng(32).normal(size=(B, N, D)).astype(np.float32)
    xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2 = map(jnp.asarray, args)
    key, val = key.astype(jnp.bfloat16), val.astype(jnp.bfloat16)
    s = 1.0 / jnp.sqrt(jnp.asarray(D, jnp.float32))
    xyzp = jnp.pad(xyz, ((0, 0), (0, 0), (0, 125)))
    wd1p = jnp.pad(wd1, ((0, 125), (0, 0)))
    bias = jnp.pad(jnp.stack([bd1, bd2, bg1, bg2 * s]), ((0, 4), (0, 0)))
    out, m, l, idx_t = _fwd_pallas(xyzp, q, key, val, wd1p, wd2, wg1, wg2 * s, bias, K,
                                   interpret=True, precise=False)
    dq, dkey, dval, dwd1, dwd2, dwg1, dwg2, dbias = _bwd_pallas(
        idx_t, xyzp, q, key, val, wd1p, wd2, wg1, wg2 * s, bias, m, l, out, jnp.asarray(cot),
        interpret=True, precise=False)
    assert not np.asarray(dwd1[3:]).any()  # the padded lanes of xyz
    grads = (dq, dkey.astype(jnp.bfloat16), dval.astype(jnp.bfloat16), dwd1[:3], dbias[0], dwd2,
             dbias[1], dwg1, dbias[2], dwg2 * s, dbias[3] * s)
    fwd = (*(np.asarray(a) for a in (out, m, l)), np.swapaxes(np.asarray(idx_t), 1, 2))
    return args, cot, fwd, [np.asarray(g, np.float32) for g in grads]


def _forward_errors(got, want, args):
    """Max relative error and relative L2 of out, m, l on the rows whose
    neighbour sets agree; the neighbour sets may differ at near ties only."""
    differ = _near_tie_flips(args[0], got[3].numpy(), want[3], K)
    assert differ.mean() <= 0.005
    agree = ~differ
    errors = {}
    for name, g, w in zip(("out", "m", "l"), got[:3], want[:3]):
        g, w = g.numpy()[agree], w[agree]
        errors[name] = (float((np.abs(g - w) / np.maximum(np.abs(w), 1.0)).max()), _rel_l2(g, w))
    return errors


def test_plain_fwd_matches_pallas_interpret(pallas):
    args, _, want, _ = pallas
    got = tva.vector_attention_fwd(*_port_args(args), K)
    assert all(t.dtype == torch.float32 for t in got[:3]) and got[3].dtype == torch.int32
    errors = _forward_errors(got, want, args)
    print(f"bf16 plain forward against the Pallas kernel (max rel, rel L2): {errors}")
    for name, (err, l2) in errors.items():
        assert err <= FWD_TOL and l2 <= FWD_REL_L2, (name, err, l2)


def test_fold_before_rounding_is_visible(pallas, monkeypatch):
    """bf16(Wg2)·s in place of bf16(Wg2·s) fails the forward's limits."""
    args, _, want, _ = pallas
    folded = tva.bf16_weights

    def round_then_fold(*weights):
        s = tva.softmax_scale(weights[6].shape[-1])
        return (*folded(*weights)[:6], weights[6].to(torch.bfloat16).to(torch.float32) * s,
                weights[7] * s)

    monkeypatch.setattr(tva, "bf16_weights", round_then_fold)
    errors = _forward_errors(tva.vector_attention_fwd(*_port_args(args), K), want, args)
    print(f"rounded before the fold (max rel, rel L2): {errors}")
    assert errors["m"][1] > FWD_REL_L2, errors


def test_plain_bwd_matches_pallas_interpret(pallas):
    args, cot, (out, m, l, idx), want = pallas
    saved = [torch.from_numpy(np.array(a, order="C")) for a in (idx, m, l, out)]
    got = tva.vector_attention_bwd(*_port_args(args), K, *saved, torch.from_numpy(cot))
    assert [g.dtype for g in got[:3]] == [torch.float32, torch.bfloat16, torch.bfloat16]
    assert all(g.dtype == torch.float32 for g in got[3:])
    scale = max(np.linalg.norm(w) for w in want)
    errors = {}
    for name, g, w in zip(tva.BWD_NAMES, got, want):
        g = g.to(torch.float32).numpy()
        assert g.shape == w.shape, name
        if name == "dbg2":
            assert np.linalg.norm(g) < 1e-3 * scale and np.linalg.norm(w) < 1e-3 * scale
            continue
        errors[name] = _rel_l2(g, w)
    print(f"bf16 plain backward against the Pallas kernels (relative L2): {errors}")
    for name, err in errors.items():
        assert err <= (CANCEL_REL_L2 if name in CANCELLING else BWD_REL_L2), (name, err)


def test_bf16_wrapper_validates_before_dispatch():
    """bf16 key and val (with q in f32 or bf16) select the bf16 mode; a
    mixed pair, a bf16 q or weight outside it and other dtypes are refused
    before any dispatch (meta tensors: no device path would take them)."""
    args = [torch.from_numpy(a) for a in _data(1, 16, 128, seed=33)]
    bf = torch.bfloat16

    def call(device, **dtypes):
        a = [t.to(dtypes.get(name, t.dtype)) for name, t in zip(tva.NAMES, args)]
        return tva.vector_attention_fwd(*(t.to(device) for t in a), 4)

    assert call("cpu", key=bf, val=bf)[0].dtype == torch.float32
    assert call("cpu", q=bf, key=bf, val=bf)[0].dtype == torch.float32
    with pytest.raises(ValueError, match="no path for device"):
        call("meta", q=bf, key=bf, val=bf)
    for bad in ({"key": bf}, {"val": bf}, {"q": bf}, {"key": bf, "val": bf, "wg2": bf},
                {"key": torch.float16, "val": torch.float16},
                {"key": bf, "val": bf, "xyz": bf}):
        with pytest.raises(TypeError, match="float32"):
            call("meta", **bad)


def test_bf16_cpu_path_counts_no_launches():
    """Through the autograd Function on the CPU: no launch counted; the
    gradients of the bf16 q, key and val come back bf16, the weights' f32."""
    args = _port_args(_data(1, 16, 128, seed=34))
    args[1] = args[1].to(torch.bfloat16)
    leaves = [a.requires_grad_(True) for a in args[1:]]
    before = (tva.vector_attention_fwd.launches, tva.vector_attention_bwd.calls,
              dict(tva.vector_attention_bwd.launches))
    tva.fused_vector_attention(args[0], *leaves, 4).sum().backward()
    assert before == (tva.vector_attention_fwd.launches, tva.vector_attention_bwd.calls,
                      tva.vector_attention_bwd.launches)
    assert [t.grad.dtype for t in leaves[:3]] == [torch.bfloat16] * 3
    assert all(t.grad.dtype == torch.float32 for t in leaves[3:])
