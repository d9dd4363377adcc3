"""Vector attention (Point Transformer): the CUDA forward and backward kernels,
their plain versions, the wrappers that dispatch between them, and the
autograd Function.

``vector_attention_fwd(xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2,
bg2, k)`` finds, for each point n of cloud b, its k nearest points in
``xyz[b]`` (itself included; f32 squared distance, the lowest index winning a
tie) and, over those neighbours j and per channel,

    pos_j = relu((xyz_n - xyz_j)·Wd1 + bd1)·Wd2 + bd2
    z_j   = (relu((q_n - key_j + pos_j)·Wg1 + bg1)·Wg2 + bg2) · s,  s = 1/sqrt(D)
    m = max_j z_j,  l = sum_j exp(z_j - m),  out = sum_j exp(z_j - m)(val_j + pos_j) / l

It returns out, m, l (B, N, D) f32 and idx (B, N, k) int32. It is the
counterpart of the TPU kernel ``_fwd_pallas`` behind ``fused_vector_attention``
(``sug_tpu/ops/vector_attention_pallas.py``), with that kernel's m and l (on
the logits scaled by s, which the Pallas wrapper folds into Wg2 and bg2), and
without its TPU layouts: idx is (B, N, k), not (B, k, N); xyz is not padded to
128 lanes; the biases are four vectors, not an (8, D) block. Weights are in
the (in, out) layout of flax's Dense kernels.

``vector_attention_bwd(..., k, idx, m, l, out, dout)`` is the counterpart of
``_bwd_pallas``: it replays every edge from the saved idx, m, l and out and
returns the gradients of q, key, val and the eight weights (``BWD_NAMES``);
xyz gets none.

On a CPU tensor a wrapper runs the plain PyTorch version; on a CUDA tensor it
launches the hand-written kernels (``csrc/vecattn_fwd.cu``,
``csrc/vecattn_bwd.cu``) or raises. ``fused_vector_attention`` wraps both in a
``torch.autograd.Function`` that returns ``out``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from sug_tpu_torch.ops import cuda_build
from sug_tpu_torch.ops.edgeconv import scatter_keys
from sug_tpu_torch.ops.geometry import index_points, knn_indices

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

MAX_K = 16
# the widths the CUDA kernels are built for (a block holds 1024/D queries)
KERNEL_WIDTHS = (128, 256, 512)
# The kernels stream each (D, D) weight into shared memory in chunks of rows,
# one bulk copy per chunk, which cannot pad; they take the weights with each
# row padded to D + WEIGHT_PAD floats (csrc/vecattn_tile.cuh, kWPad), so that
# their tensor-core fragment loads hit distinct banks.
WEIGHT_PAD = 8
NAMES = ("xyz", "q", "key", "val", "wd1", "bd1", "wd2", "bd2", "wg1", "bg1", "wg2", "bg2")
# the backward's outputs, in the order of the inputs they are gradients of
BWD_NAMES = tuple("d" + name for name in NAMES[1:])
# the staged per-edge planes of the backward kernels, in the order of
# csrc/vecattn_bwd.cu's ``Plane``
_PLANES = ("relu_d", "att_in", "relu_g", "dzs", "dh_g", "datt", "dvpos", "dpos", "dh_d")
# clouds are walked in chunks of at most this many staged floats per plane
# (rows·D with 16 rows per point): 16 clouds of 1024 points at D=512, nine
# planes of 512 MiB
MAX_PLANE_FLOATS = 1 << 27
WGRAD_SPLITS = 11  # K shares per weight gradient: 48 tiles · 11 = 4 blocks per SM at D=512
THIN_SPLITS = 256  # row shares of the (4, D) product


def softmax_scale(d: int) -> float:
    """s = 1/sqrt(D) rounded once to f32, as the kernel computes it."""
    return float(np.float32(1.0 / math.sqrt(d)))


def vector_attention_fwd_plain(xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2,
                               k: int) -> Outputs:
    """The plain PyTorch version: the f32 counterpart of
    ``vector_attention_reference(..., bf16_mm=False)``, with m and l.
    Materialises the (B, N, k, D) edge tensors."""
    idx = knn_indices(xyz, k)  # (B, N, k)
    delta = xyz[:, :, None, :] - index_points(xyz, idx)
    pos = torch.relu(torch.matmul(delta, wd1) + bd1)
    pos = torch.matmul(pos, wd2) + bd2
    att_in = q[:, :, None, :] - index_points(key, idx) + pos
    z = torch.relu(torch.matmul(att_in, wg1) + bg1)
    z = (torch.matmul(z, wg2) + bg2) * softmax_scale(q.shape[-1])
    m = torch.amax(z, dim=2)
    p = torch.exp(z - m[:, :, None, :])
    l = torch.sum(p, dim=2)
    out = torch.sum(p * (index_points(val, idx) + pos), dim=2) / l
    return out, m, l, idx.to(torch.int32)


def _check(args, k: int) -> None:
    xyz, q = args[0], args[1]
    for name, t in zip(NAMES, args):
        if t.dtype != torch.float32:
            raise TypeError(f"vector_attention: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"vector_attention: {name} must be contiguous")
        if t.device != xyz.device:
            raise ValueError(f"vector_attention: {name} is on {t.device}, xyz on {xyz.device}")
    if xyz.dim() != 3 or q.dim() != 3:
        raise ValueError(f"vector_attention: xyz and q must be rank 3, got "
                         f"{tuple(xyz.shape)} and {tuple(q.shape)}")
    (B, N), D = xyz.shape[:2], q.shape[-1]
    want = {"xyz": (B, N, 3), "q": (B, N, D), "key": (B, N, D), "val": (B, N, D),
            "wd1": (3, D), "bd1": (D,), "wd2": (D, D), "bd2": (D,),
            "wg1": (D, D), "bg1": (D,), "wg2": (D, D), "bg2": (D,)}
    bad = [f"{name} {tuple(t.shape)} (want {want[name]})"
           for name, t in zip(NAMES, args) if tuple(t.shape) != want[name]]
    if bad:
        raise ValueError(f"vector_attention: shapes must be xyz (B,N,3), q/key/val (B,N,D), "
                         f"wd1 (3,D), wd2/wg1/wg2 (D,D), biases (D,); got {', '.join(bad)}")
    if not 1 <= k <= min(N, MAX_K):
        raise ValueError(f"vector_attention: need 1 <= k <= min(N, {MAX_K}), got k={k}, N={N}")


def _padded(w: torch.Tensor) -> torch.Tensor:
    """A (D, D) weight as the kernels take it: rows of D + WEIGHT_PAD floats."""
    return torch.nn.functional.pad(w, (0, WEIGHT_PAD))


def _kernel_weights(args):
    """args[4:] (wd1 ... bg2) with the three (D, D) weights padded."""
    return [_padded(t) if i in (2, 4, 6) else t for i, t in enumerate(args[4:])]


def _launch(args, k: int) -> Outputs:
    B, N, _ = args[0].shape
    D = args[1].shape[-1]
    if D not in KERNEL_WIDTHS:
        raise ValueError(f"vector_attention: the CUDA kernel takes D in {KERNEL_WIDTHS}, "
                         f"got D={D}")
    misaligned = [name for name, t in zip(NAMES, args) if t.data_ptr() % 16]
    if misaligned:
        raise ValueError(f"vector_attention: the CUDA kernel needs 16-byte aligned tensors; "
                         f"{misaligned} are not")
    lib = cuda_build.library("vecattn_fwd", "vecattn_error_string", 16, 4)
    dev = args[0].device
    out, m, l = (torch.empty((B, N, D), dtype=torch.float32, device=dev) for _ in range(3))
    idx = torch.empty((B, N, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vecattn_fwd(*(t.data_ptr() for t in (*args[:4], *_kernel_weights(args),
                                                        out, m, l, idx)),
                              B, N, D, k, stream)
    if err != 0:
        raise RuntimeError(f"vecattn_fwd launch failed: {lib.vecattn_error_string(err).decode()} "
                           f"(B={B}, N={N}, D={D}, k={k}: N may be too large for the distance "
                           "rows in shared memory)")
    vector_attention_fwd.launches += 1
    return out, m, l, idx


def vector_attention_fwd(xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2,
                         k: int) -> Outputs:
    """kNN-k of ``xyz`` (B,N,3) + the delta and gamma MLPs + the per-channel
    softmax over neighbours: out, m, l (B,N,D) f32 and idx (B,N,k) int32.
    Every tensor f32 and contiguous, 1 <= k <= min(N, 16).

    CPU tensors go to the plain version, CUDA tensors to the kernel; a build
    or launch failure raises. ``vector_attention_fwd.launches`` counts kernel
    launches.
    """
    args = (xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2)
    _check(args, k)
    if xyz.device.type == "cpu":
        return vector_attention_fwd_plain(*args, k)
    if xyz.device.type != "cuda":
        raise ValueError(f"vector_attention: no path for device {xyz.device}")
    return _launch(args, k)


vector_attention_fwd.launches = 0


def edge_terms(xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2,
               idx, m, l, out, dout) -> Dict[str, torch.Tensor]:
    """The per-edge tensors of the backward, (B, N, k, D) each (``delta``
    (B, N, k, 3)): the forward replayed on ``idx`` and the cotangents of its
    layers, named as in the module's formulas."""
    s = softmax_scale(q.shape[-1])
    t = {"delta": xyz[:, :, None, :] - index_points(xyz, idx)}
    t["relu_d"] = torch.relu(torch.matmul(t["delta"], wd1) + bd1)
    pos = torch.matmul(t["relu_d"], wd2) + bd2
    t["att_in"] = q[:, :, None, :] - index_points(key, idx) + pos
    t["relu_g"] = torch.relu(torch.matmul(t["att_in"], wg1) + bg1)
    z = (torch.matmul(t["relu_g"], wg2) + bg2) * s
    alpha = torch.exp(z - m[:, :, None, :]) / l[:, :, None, :]
    del z
    t["dvpos"] = alpha * dout[:, :, None, :]
    del alpha
    t["dzs"] = t["dvpos"] * (index_points(val, idx) + pos - out[:, :, None, :]) * s
    del pos
    t["dh_g"] = (t["relu_g"] > 0) * torch.matmul(t["dzs"], wg2.t())
    t["datt"] = torch.matmul(t["dh_g"], wg1.t())
    t["dpos"] = t["datt"] + t["dvpos"]
    t["dh_d"] = (t["relu_d"] > 0) * torch.matmul(t["dpos"], wd2.t())
    return t


def reduce_edge_terms(t: Dict[str, torch.Tensor], idx: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The backward's outputs (``BWD_NAMES``) from ``edge_terms``: sums over
    the neighbours (dq), by key (dkey, dval) and over every edge (the weight
    and bias gradients)."""
    n_keys = t["datt"].shape[1]

    def outer(a, g):
        return torch.matmul(t[a].flatten(0, 2).t(), t[g].flatten(0, 2))

    def total(g):
        return t[g].sum(dim=(0, 1, 2))

    return (t["datt"].sum(dim=2), -scatter_keys(t["datt"], idx, n_keys),
            scatter_keys(t["dvpos"], idx, n_keys),
            outer("delta", "dh_d"), total("dh_d"), outer("relu_d", "dpos"), total("dpos"),
            outer("att_in", "dh_g"), total("dh_g"), outer("relu_g", "dzs"), total("dzs"))


def vector_attention_bwd_plain(xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2,
                               k: int, idx, m, l, out, dout) -> Tuple[torch.Tensor, ...]:
    """The plain PyTorch backward: the counterpart of ``_bwd_pallas``, on the
    given idx (B, N, k), m, l and out (``k`` is idx's last dimension; the
    wrapper checks it). Returns ``BWD_NAMES``. Materialises ten (B, N, k, D)
    edge tensors."""
    terms = edge_terms(xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2,
                       idx, m, l, out, dout)
    return reduce_edge_terms(terms, idx)


def _check_bwd(args, k: int, idx, m, l, out, dout) -> None:
    _check(args, k)
    xyz, q = args[0], args[1]
    (B, N), D = xyz.shape[:2], q.shape[-1]
    if idx.dtype != torch.int32 or tuple(idx.shape) != (B, N, k) or not idx.is_contiguous():
        raise ValueError(f"vector_attention_bwd: idx must be contiguous (B,N,k) = {(B, N, k)} "
                         f"int32, got {idx.dtype} {tuple(idx.shape)}")
    if idx.device != xyz.device:
        raise ValueError(f"vector_attention_bwd: idx is on {idx.device}, xyz on {xyz.device}")
    for name, t in zip(("m", "l", "out", "dout"), (m, l, out, dout)):
        if t.dtype != torch.float32:
            raise TypeError(f"vector_attention_bwd: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"vector_attention_bwd: {name} must be contiguous")
        if t.device != xyz.device:
            raise ValueError(f"vector_attention_bwd: {name} is on {t.device}, xyz on {xyz.device}")
        if tuple(t.shape) != (B, N, D):
            raise ValueError(f"vector_attention_bwd: {name} must be (B,N,D) = {(B, N, D)}, "
                             f"got {tuple(t.shape)}")


def _kernel_call(launcher: str, n_ptrs: int, n_ints: int, tensors, ints, dev) -> None:
    """One launch of ``csrc/vecattn_bwd.cu``'s ``vecattn_bwd_<launcher>`` on
    the current stream of ``dev``, counted; a refused launch raises."""
    name = f"vecattn_bwd_{launcher}"
    lib = cuda_build.library("vecattn_bwd", "vecattn_bwd_error_string", n_ptrs, n_ints, name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, name)(*(t.data_ptr() for t in tensors), *ints, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.vecattn_bwd_error_string(err).decode()} "
                           f"(sizes {ints})")
    vector_attention_bwd.launches[launcher] += 1


def clouds_per_chunk(N: int, D: int) -> int:
    """How many clouds the backward kernels stage at a time."""
    return max(1, MAX_PLANE_FLOATS // (N * MAX_K * D))


def _check_launch_bwd(args, idx, m, l, out, dout) -> None:
    D = args[1].shape[-1]
    if D not in KERNEL_WIDTHS:
        raise ValueError(f"vector_attention_bwd: the CUDA kernels take D in {KERNEL_WIDTHS}, "
                         f"got D={D}")
    named = zip(NAMES + ("idx", "m", "l", "out", "dout"), (*args, idx, m, l, out, dout))
    misaligned = [name for name, t in named if t.data_ptr() % 16]
    if misaligned:
        raise ValueError(f"vector_attention_bwd: the CUDA kernels need 16-byte aligned tensors; "
                         f"{misaligned} are not")


def _transposed(args):
    """Wd2ᵀ, Wg1ᵀ, Wg2ᵀ padded as the kernels take them."""
    return [_padded(args[i].t()) for i in (6, 8, 10)]


def _launch_edge(args, transposed, k: int, idx, m, l, out, dout, dq, planes, delta1) -> None:
    """The edge kernel on the clouds given: writes dq, the staged planes
    (9, rows, D) and [delta, 1] (rows, 4), rows = B·N·16. ``args[4:]`` and
    ``transposed`` (Wd2ᵀ, Wg1ᵀ, Wg2ᵀ) are the weights as the kernels take
    them (``_kernel_weights``, ``_transposed``)."""
    B, N, _ = args[0].shape
    _kernel_call("edge", 23, 4, (*args, *transposed, idx, m, l, out, dout, dq, planes, delta1),
                 (B, N, args[1].shape[-1], k), args[0].device)


def staged_edge_terms(xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2,
                      k: int, idx, m, l, out, dout):
    """What the edge kernel stages for the other backward kernels, for
    checking it against ``edge_terms``: dq (B,N,D) and the per-edge tensors
    by name, (B, N, 16, D) each and ``delta`` (B, N, 16, 3). The slots past k
    repeat slot 0's inputs and hold zero cotangents. CUDA tensors only, and
    at most one chunk of clouds (``MAX_PLANE_FLOATS``)."""
    args = (xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2)
    _check_bwd(args, k, idx, m, l, out, dout)
    (B, N), D = xyz.shape[:2], q.shape[-1]
    if xyz.device.type != "cuda" or B > clouds_per_chunk(N, D):
        raise ValueError(f"staged_edge_terms: needs CUDA tensors of at most "
                         f"{clouds_per_chunk(N, D)} clouds, got {B} on {xyz.device}")
    _check_launch_bwd(args, idx, m, l, out, dout)
    f32 = dict(dtype=torch.float32, device=xyz.device)
    dq = torch.empty((B, N, D), **f32)
    planes = torch.empty((len(_PLANES), B * N * MAX_K, D), **f32)
    delta1 = torch.empty((B * N * MAX_K, 4), **f32)
    _launch_edge((*args[:4], *_kernel_weights(args)), _transposed(args), k, idx, m, l, out, dout,
                 dq, planes, delta1)
    terms = {name: planes[i].view(B, N, MAX_K, D) for i, name in enumerate(_PLANES)}
    terms["delta"] = delta1.view(B, N, MAX_K, 4)[..., :3]
    return dq, terms


def _launch_bwd(args, k: int, idx, m, l, out, dout) -> Tuple[torch.Tensor, ...]:
    _check_launch_bwd(args, idx, m, l, out, dout)
    xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2 = args
    (B, N), D = xyz.shape[:2], q.shape[-1]
    dev = xyz.device
    f32 = dict(dtype=torch.float32, device=dev)
    weights, transposed = _kernel_weights(args), _transposed(args)
    dq, dkey, dval = (torch.empty((B, N, D), **f32) for _ in range(3))
    per_chunk = clouds_per_chunk(N, D)
    starts = range(0, B, per_chunk)
    max_rows = min(per_chunk, B) * N * MAX_K
    stage = torch.empty(len(_PLANES) * max_rows * D, **f32)
    delta1 = torch.empty((max_rows, 4), **f32)
    wpart = torch.empty((len(starts), WGRAD_SPLITS, 3, D + 1, D), **f32)
    tpart = torch.empty((len(starts), THIN_SPLITS, 4, D), **f32)
    for c, b0 in enumerate(starts):
        chunk = slice(b0, min(b0 + per_chunk, B))
        rows = (chunk.stop - b0) * N * MAX_K
        planes = stage[:len(_PLANES) * rows * D].view(len(_PLANES), rows, D)
        _launch_edge((xyz[chunk], q[chunk], key[chunk], val[chunk], *weights), transposed, k,
                     idx[chunk], m[chunk], l[chunk], out[chunk], dout[chunk], dq[chunk], planes,
                     delta1)
        _kernel_call("wgrad", 2, 3, (planes, wpart[c]), (rows, D, WGRAD_SPLITS), dev)
        _kernel_call("thin", 3, 3, (delta1, planes[_PLANES.index("dh_d")], tpart[c]),
                     (rows, D, THIN_SPLITS), dev)
        _kernel_call("scatter", 5, 4,
                     (idx[chunk], planes[_PLANES.index("datt")], planes[_PLANES.index("dvpos")],
                      dkey[chunk], dval[chunk]),
                     (chunk.stop - b0, N, D, k), dev)
    wsum = torch.empty((3, D + 1, D), **f32)  # dWg2, dWg1, dWd2, each over its bias gradient
    tsum = torch.empty((4, D), **f32)  # dWd1 over dbd1
    _kernel_call("reduce", 4, 3, (wpart, wsum, tpart, tsum),
                 (D, len(starts) * WGRAD_SPLITS, len(starts) * THIN_SPLITS), dev)
    vector_attention_bwd.calls += 1
    return (dq, dkey, dval, tsum[:3], tsum[3], wsum[2, :D], wsum[2, D], wsum[1, :D], wsum[1, D],
            wsum[0, :D], wsum[0, D])


def vector_attention_bwd(xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2,
                         k: int, idx, m, l, out, dout) -> Tuple[torch.Tensor, ...]:
    """Backward of ``vector_attention_fwd``'s ``out``: the forward's inputs,
    its idx (B,N,k) int32, m, l, out, and the cotangent dout (B,N,D), all
    contiguous; returns the gradients ``BWD_NAMES`` of q, key, val (B,N,D)
    and of the eight weights.

    CPU tensors go to the plain version, CUDA tensors to the kernels; a build
    or launch failure raises. ``vector_attention_bwd.calls`` counts the calls
    that went to the kernels and ``vector_attention_bwd.launches`` each
    kernel's launches: per chunk of clouds (``MAX_PLANE_FLOATS``) one each of
    edge, wgrad, thin and scatter, and one reduce per call.
    """
    args = (xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2)
    _check_bwd(args, k, idx, m, l, out, dout)
    if xyz.device.type == "cpu":
        return vector_attention_bwd_plain(*args, k, idx, m, l, out, dout)
    if xyz.device.type != "cuda":
        raise ValueError(f"vector_attention: no path for device {xyz.device}")
    return _launch_bwd(args, k, idx, m, l, out, dout)


vector_attention_bwd.calls = 0
vector_attention_bwd.launches = {"edge": 0, "wgrad": 0, "thin": 0, "scatter": 0, "reduce": 0}


class FusedVectorAttention(torch.autograd.Function):
    """``vector_attention_fwd``'s ``out`` with its backward. The forward saves
    its idx, m, l and out, so the backward replays the same neighbours and
    statistics. Gradients reach q, key, val and the weights; xyz only selects
    neighbours and feeds the parameter-free delta input, and gets none, as
    in ``_vecattn_bwd`` (``vector_attention_pallas.py:673-687``)."""

    @staticmethod
    def forward(ctx, xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2, k: int):
        args = (xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2)
        out, m, l, idx = vector_attention_fwd(*args, k)
        ctx.save_for_backward(*args, idx, m, l, out)
        ctx.k = k
        return out

    @staticmethod
    def backward(ctx, dout):
        *args, idx, m, l, out = ctx.saved_tensors
        grads = vector_attention_bwd(*args, ctx.k, idx, m, l, out, dout.contiguous())
        return (None, *grads, None)


def fused_vector_attention(xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2,
                           k: int) -> torch.Tensor:
    """The attention output (B, N, D) of ``vector_attention_fwd``, with
    gradients."""
    return FusedVectorAttention.apply(xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2,
                                      bg2, k)
