"""EdgeConv kNN-gather-reduce: the CUDA kernel, its plain version, and the
wrapper that dispatches between them.

``edgeconv_reduce(q, kv, u, v, k)`` finds, for each query ``q[b, s]``, its k
nearest keys in ``kv[b]`` (f32 squared distance, the lowest index winning a
tie), forms ``a_j = u[b, idx_j] + v[b, s]`` and returns the max, min, sum and
sum of squares of ``a_j`` over j, plus idx (B, S, k) int32. It is the
counterpart of the TPU kernel behind ``fused_edgeconv_reduce`` and
``fused_cross_edgeconv_reduce`` (``sug_tpu/ops/edgeconv_pallas.py``).

On a CPU tensor the wrapper runs the plain PyTorch version; on a CUDA tensor
it launches the hand-written kernel in ``csrc/edgeconv_fwd.cu`` or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from sug_tpu_torch.ops import cuda_build
from sug_tpu_torch.ops.geometry import index_points, smallest_k, square_distance

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

_CUDA_ERROR_INVALID_VALUE = 1


def edgeconv_reduce_plain(q, kv, u, v, k: int) -> Outputs:
    """The plain PyTorch version: the counterpart of
    ``edgeconv_reduce_reference``, with a query set that may differ from the
    key set."""
    idx = smallest_k(square_distance(q, kv), k)  # (B, S, k)
    a = index_points(u, idx) + v[:, :, None, :]  # (B, S, k, F)
    return (
        torch.amax(a, dim=2),
        torch.amin(a, dim=2),
        torch.sum(a, dim=2),
        torch.sum(a * a, dim=2),
        idx.to(torch.int32),
    )


def _check(q, kv, u, v, k: int) -> None:
    names = ("q", "kv", "u", "v")
    for name, t in zip(names, (q, kv, u, v)):
        if t.dtype != torch.float32:
            raise TypeError(f"edgeconv_reduce: {name} must be float32, got {t.dtype}")
        if t.dim() != 3:
            raise ValueError(f"edgeconv_reduce: {name} must be rank 3, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"edgeconv_reduce: {name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"edgeconv_reduce: {name} is on {t.device}, q on {q.device}")
    (B, S, C), (_, N, _), F = q.shape, kv.shape, u.shape[-1]
    if kv.shape != (B, N, C) or u.shape != (B, N, F) or v.shape != (B, S, F):
        raise ValueError(
            "edgeconv_reduce: shapes must be q (B,S,C), kv (B,N,C), u (B,N,F), "
            f"v (B,S,F); got {[tuple(t.shape) for t in (q, kv, u, v)]}"
        )
    if not 1 <= k <= N:
        raise ValueError(f"edgeconv_reduce: need 1 <= k <= N, got k={k}, N={N}")


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("edgeconv_fwd")
    if lib.edgeconv_fwd.argtypes is None:
        # every pointer and the stream as c_void_p: an undeclared pointer
        # argument would be passed as a 32-bit int and cut
        lib.edgeconv_fwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.edgeconv_fwd.restype = ctypes.c_int
        lib.edgeconv_error_string.argtypes = [ctypes.c_int]
        lib.edgeconv_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q, kv, u, v, k: int) -> Outputs:
    lib = _library()
    B, S, C = q.shape
    N, F = kv.shape[1], u.shape[-1]
    amax, amin, s1, s2 = (torch.empty((B, S, F), dtype=torch.float32, device=q.device)
                          for _ in range(4))
    idx = torch.empty((B, S, k), dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.edgeconv_fwd(
            q.data_ptr(), kv.data_ptr(), u.data_ptr(), v.data_ptr(),
            amax.data_ptr(), amin.data_ptr(), s1.data_ptr(), s2.data_ptr(), idx.data_ptr(),
            B, S, N, C, F, k, stream,
        )
    if err != 0:
        msg = lib.edgeconv_error_string(err).decode()
        if err == _CUDA_ERROR_INVALID_VALUE:
            msg += f" (B={B}, S={S}, N={N}, C={C}, F={F}, k={k}: N may be too large " \
                   "for one distance row per query in shared memory)"
        raise RuntimeError(f"edgeconv_fwd launch failed: {msg}")
    edgeconv_reduce.launches += 1
    return amax, amin, s1, s2, idx


def edgeconv_reduce(q, kv, u, v, k: int) -> Outputs:
    """kNN of ``q`` (B,S,C) against ``kv`` (B,N,C) + gather-reduce of ``u``
    (B,N,F) plus ``v`` (B,S,F): amax, amin, s1, s2 (B,S,F) f32 and idx
    (B,S,k) int32. Self-kNN passes ``q is kv`` (the point itself included).

    CPU tensors go to the plain version, CUDA tensors to the kernel; a build
    or launch failure raises. ``edgeconv_reduce.launches`` counts kernel
    launches.
    """
    _check(q, kv, u, v, k)
    if q.device.type == "cpu":
        return edgeconv_reduce_plain(q, kv, u, v, k)
    if q.device.type != "cuda":
        raise ValueError(f"edgeconv_reduce: no path for device {q.device}")
    return _launch(q, kv, u, v, k)


edgeconv_reduce.launches = 0


def fused_edgeconv_reduce(x, u, v, k: int) -> Outputs:
    """Self-kNN EdgeConv case: ``x`` (B,N,C) is both query and key set."""
    return edgeconv_reduce(x, x, u, v, k)


def fused_cross_edgeconv_reduce(q_pts, kv_pts, u, v, k: int) -> Outputs:
    """Cross-query case: S queries against N keys (the SA-node re-query)."""
    return edgeconv_reduce(q_pts, kv_pts, u, v, k)
