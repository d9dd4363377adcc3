"""Vector attention (Point Transformer): the CUDA forward kernel, its plain
version, the wrapper that dispatches between them, and the autograd Function.

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

On a CPU tensor the wrapper runs the plain PyTorch version; on a CUDA tensor
it launches the hand-written kernel (``csrc/vecattn_fwd.cu``) or raises.
``fused_vector_attention`` wraps it in a ``torch.autograd.Function`` that
returns ``out``; its backward differentiates the plain version on CPU tensors
and raises ``NotImplementedError`` on CUDA ones until the backward kernels are
ported (ROADMAP.md, slice 4).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from sug_tpu_torch.ops import cuda_build
from sug_tpu_torch.ops.geometry import index_points, knn_indices

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

MAX_K = 16
NAMES = ("xyz", "q", "key", "val", "wd1", "bd1", "wd2", "bd2", "wg1", "bg1", "wg2", "bg2")


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


def _launch(args, k: int) -> Outputs:
    B, N, _ = args[0].shape
    D = args[1].shape[-1]
    if D % 128 != 0 or D > 512:
        raise ValueError(f"vector_attention: the CUDA kernel takes D a multiple of 128 up to "
                         f"512, got D={D}")
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
        err = lib.vecattn_fwd(*(t.data_ptr() for t in (*args, out, m, l, idx)),
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


class FusedVectorAttention(torch.autograd.Function):
    """``vector_attention_fwd``'s ``out`` with its backward. Gradients reach q,
    key, val and the weights; xyz only selects neighbours and feeds the
    parameter-free delta input, and gets none, as in ``_vecattn_bwd``
    (``vector_attention_pallas.py:673-687``)."""

    @staticmethod
    def forward(ctx, xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2, k: int):
        args = (xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2)
        out, _, _, _ = vector_attention_fwd(*args, k)
        ctx.save_for_backward(*args)
        ctx.k = k
        return out

    @staticmethod
    def backward(ctx, dout):
        if dout.device.type != "cpu":
            raise NotImplementedError(
                "the vector-attention backward kernels are not ported yet (PTran training, "
                "slice 4 in ROADMAP.md); on the card only the forward runs"
            )
        xyz, *inputs = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in inputs]
            out, _, _, _ = vector_attention_fwd_plain(xyz, *leaves, ctx.k)
            grads = torch.autograd.grad(out, leaves, dout)
        return (None, *grads, None)


def fused_vector_attention(xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2,
                           k: int) -> torch.Tensor:
    """The attention output (B, N, D) of ``vector_attention_fwd``, with
    gradients (CPU only until slice 4)."""
    return FusedVectorAttention.apply(xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2,
                                      bg2, k)
