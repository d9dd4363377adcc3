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

The bf16 mode, the TPU kernels' ``precise=False`` (the ``PRECISION: bf16``
policy's; ``sug_tpu/models/ptran.py`` ``_vecattn_mode`` :51-89), is selected
by the dtype of key and val: bf16 key and val run it, f32 ones the f32 mode.
The weights stay f32 parameters; q may be f32 or, in the bf16 mode, bf16,
and is widened to f32. The mode rounds where the TPU kernels round:
- operands (``_cast_operands``, ``vector_attention_pallas.py:486-501``): key
  and val bf16; the four weights rounded to bf16 after s = 1/sqrt(D) is
  folded into Wg2 and bg2 (``fused_vector_attention`` :721-731), so the
  weight is bf16(Wg2·s), and bg2·s stays f32 (``bf16_weights``); xyz, q and
  the kNN distances f32;
- forward (``_fwd_kernel`` :181-267, ``_edge_forward`` :145-159): each MLP
  product rounds its left operand to bf16 and sums in f32 (``_bdot`` :76):
  bf16(delta)·Wd1 + bd1, bf16(relu_d)·Wd2 + bd2 = pos, att_in = q - key_j +
  pos in f32, bf16(att_in)·Wg1 + bg1, z = bf16(relu_g)·bf16(Wg2·s) + bg2·s;
  the softmax and ``out`` f32;
- backward (``_bwd_input_kernel`` :279-355, ``_bwd_weight_kernel``
  :358-449): the same replay; dz = dvpos·(val_j + pos - out), the gradient
  of the folded logits; bf16(dz)·Wg2ᵀ, bf16(dh_g)·Wg1ᵀ, bf16(dpos)·Wd2ᵀ;
  dq = Σ datt unrounded; dkey = Σ bf16(-datt) and dval = Σ bf16(dvpos)
  (:351-352), f32 sums returned as bf16 (``_vecattn_bwd`` :682-687); each
  weight gradient the product of two bf16-rounded operands (``_bdotT`` :85,
  :431), the bias gradients sums of the unrounded cotangents; dWg2 and dbg2
  are the folded weights' gradients times s, in f32, as JAX's autodiff
  takes them through the fold.

On a CPU tensor a wrapper runs the plain PyTorch version; on a CUDA tensor it
launches the hand-written kernels (``csrc/vecattn_fwd.cu``,
``csrc/vecattn_bwd.cu``, each with an f32 and a bf16 instance) or raises.
``fused_vector_attention`` wraps both in a ``torch.autograd.Function`` that
returns ``out``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from sug_tpu_torch.ops import cuda_build
from sug_tpu_torch.ops.edgeconv import round_bf16, scatter_keys
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
    """s = 1/sqrt(D) rounded once to f32, as the kernel computes it (and as
    the JAX wrapper's f32 ``1 / sqrt(D)`` gives it at D = 128, 256, 512)."""
    return float(np.float32(1.0 / math.sqrt(d)))


def is_bf16(key: torch.Tensor) -> bool:
    """Whether a call with this key runs the bf16 mode."""
    return key.dtype == torch.bfloat16


def bf16_weights(wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2):
    """The eight f32 weights as the bf16 mode takes them: the four matrices
    rounded to bf16 (bf16 tensors), Wg2 after s is folded in, bg2·s in f32,
    the other biases as they are (the module docstring's operands)."""
    s = softmax_scale(wg2.shape[-1])
    return (wd1.to(torch.bfloat16), bd1, wd2.to(torch.bfloat16), bd2, wg1.to(torch.bfloat16), bg1,
            (wg2 * s).to(torch.bfloat16), bg2 * s)


def _bdot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a rounded to bf16 times the bf16 w, summed in f32 (``_bdot``): two
    bf16 values multiply exactly in f32."""
    return torch.matmul(round_bf16(a), w.to(torch.float32))


def _mode(q, key, weights):
    """(the weights as the mode takes them, its product, the scale of the
    logits): f32 as given, ``torch.matmul`` and s; the bf16 mode's
    ``bf16_weights``, ``_bdot`` and 1 (s is folded into Wg2 and bg2)."""
    if is_bf16(key):
        return bf16_weights(*weights), _bdot, 1.0
    return tuple(weights), torch.matmul, softmax_scale(q.shape[-1])


def _forward_edges(xyz, q, key, idx, weights, mm, s):
    """The per-edge forward on ``idx``: delta, relu_d, pos, att_in, relu_g
    and the logits z, (B, N, k, D) each (delta (B, N, k, 3))."""
    wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2 = weights
    t = {"delta": xyz[:, :, None, :] - index_points(xyz, idx)}
    t["relu_d"] = torch.relu(mm(t["delta"], wd1) + bd1)
    t["pos"] = mm(t["relu_d"], wd2) + bd2
    t["att_in"] = q[:, :, None, :] - index_points(key, idx).to(torch.float32) + t["pos"]
    t["relu_g"] = torch.relu(mm(t["att_in"], wg1) + bg1)
    t["z"] = (mm(t["relu_g"], wg2) + bg2) * s
    return t


def vector_attention_fwd_plain(xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2,
                               k: int) -> Outputs:
    """The plain PyTorch version: the f32 counterpart of
    ``vector_attention_reference(..., bf16_mm=False)``, with m and l; with
    bf16 key and val, the bf16 mode's (the module docstring). Materialises
    the (B, N, k, D) edge tensors."""
    weights, mm, s = _mode(q, key, (wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2))
    idx = knn_indices(xyz, k)  # (B, N, k)
    t = _forward_edges(xyz, q.to(torch.float32), key, idx, weights, mm, s)
    m = torch.amax(t["z"], dim=2)
    p = torch.exp(t["z"] - m[:, :, None, :])
    l = torch.sum(p, dim=2)
    out = torch.sum(p * (index_points(val, idx).to(torch.float32) + t["pos"]), dim=2) / l
    return out, m, l, idx.to(torch.int32)


def _check(args, k: int) -> None:
    xyz, q = args[0], args[1]
    bf16 = is_bf16(args[2])
    for name, t in zip(NAMES, args):
        low = bf16 and (name in ("key", "val") or (name == "q" and t.dtype == torch.bfloat16))
        if t.dtype != (torch.bfloat16 if low else torch.float32):
            raise TypeError(f"vector_attention: {name} must be float32 (key and val both "
                            f"float32, or both bfloat16 for the bf16 mode, where q may be "
                            f"bfloat16 too), got {t.dtype}")
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
    """A (D, D) weight as the kernels take it: rows of D + WEIGHT_PAD elements."""
    return torch.nn.functional.pad(w, (0, WEIGHT_PAD))


def _weights(args):
    """args[4:] (wd1 ... bg2) as the call's mode takes them: as given, or
    ``bf16_weights``."""
    return bf16_weights(*args[4:]) if is_bf16(args[2]) else tuple(args[4:])


def _kernel_weights(weights):
    """``_weights`` as the kernels take them: the three (D, D) ones padded,
    wd1 in f32 (rounded to bf16 in the bf16 mode)."""
    weights = (weights[0].to(torch.float32), *weights[1:])
    return [_padded(t) if i in (2, 4, 6) else t for i, t in enumerate(weights)]


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
    lib = cuda_build.library("vecattn_fwd", "vecattn_error_string", 16, 5)
    dev = args[0].device
    out, m, l = (torch.empty((B, N, D), dtype=torch.float32, device=dev) for _ in range(3))
    idx = torch.empty((B, N, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vecattn_fwd(*(t.data_ptr() for t in (*args[:4], *_kernel_weights(_weights(args)),
                                                        out, m, l, idx)),
                              B, N, D, k, int(is_bf16(args[2])), stream)
    if err != 0:
        raise RuntimeError(f"vecattn_fwd launch failed: {lib.vecattn_error_string(err).decode()} "
                           f"(B={B}, N={N}, D={D}, k={k}, bf16={is_bf16(args[2])}: N may be too "
                           "large for the distance rows in shared memory)")
    vector_attention_fwd.launches += 1
    return out, m, l, idx


def vector_attention_fwd(xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2,
                         k: int) -> Outputs:
    """kNN-k of ``xyz`` (B,N,3) + the delta and gamma MLPs + the per-channel
    softmax over neighbours: out, m, l (B,N,D) f32 and idx (B,N,k) int32.
    Every tensor f32 and contiguous, 1 <= k <= min(N, 16); bf16 key and val
    (and q, which is widened to f32) run the bf16 mode.

    CPU tensors go to the plain version, CUDA tensors to the kernel; a build
    or launch failure raises. ``vector_attention_fwd.launches`` counts kernel
    launches.
    """
    args = (xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2)
    _check(args, k)
    args = _widened(args)
    if xyz.device.type == "cpu":
        return vector_attention_fwd_plain(*args, k)
    if xyz.device.type != "cuda":
        raise ValueError(f"vector_attention: no path for device {xyz.device}")
    return _launch(args, k)


vector_attention_fwd.launches = 0


def _widened(args):
    """args with a bf16 q widened to f32 (contiguous)."""
    if args[1].dtype == torch.float32:
        return args
    return (args[0], args[1].to(torch.float32), *args[2:])


def edge_terms(xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2,
               idx, m, l, out, dout) -> Dict[str, torch.Tensor]:
    """The per-edge tensors of the backward, (B, N, k, D) each (``delta``
    (B, N, k, 3)): the forward replayed on ``idx`` and the cotangents of its
    layers, named as in the module's formulas (in the bf16 mode ``dzs``
    holds dz, the folded logits' cotangent, and the products round as the
    module docstring says)."""
    weights, mm, s = _mode(q, key, (wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2))
    t = _forward_edges(xyz, q.to(torch.float32), key, idx, weights, mm, s)
    pos, z = t.pop("pos"), t.pop("z")
    alpha = torch.exp(z - m[:, :, None, :]) / l[:, :, None, :]
    del z
    t["dvpos"] = alpha * dout[:, :, None, :]
    del alpha
    t["dzs"] = t["dvpos"] * (index_points(val, idx).to(torch.float32) + pos
                             - out[:, :, None, :]) * s
    del pos
    _, _, wd2, _, wg1, _, wg2, _ = weights
    t["dh_g"] = (t["relu_g"] > 0) * mm(t["dzs"], wg2.t())
    t["datt"] = mm(t["dh_g"], wg1.t())
    t["dpos"] = t["datt"] + t["dvpos"]
    t["dh_d"] = (t["relu_d"] > 0) * mm(t["dpos"], wd2.t())
    return t


def reduce_edge_terms(t: Dict[str, torch.Tensor], idx: torch.Tensor,
                      bf16: bool = False) -> Tuple[torch.Tensor, ...]:
    """The backward's outputs (``BWD_NAMES``) from ``edge_terms``: sums over
    the neighbours (dq), by key (dkey, dval) and over every edge (the weight
    and bias gradients). ``bf16``: the terms are the bf16 mode's, whose
    scatters and outer products take their operands rounded to bf16, whose
    dkey and dval are bf16, and whose dWg2 and dbg2 are s times the folded
    weights' gradients."""
    n_keys = t["datt"].shape[1]
    rnd = round_bf16 if bf16 else (lambda x: x)

    def outer(a, g):
        return torch.matmul(rnd(t[a]).flatten(0, 2).t(), rnd(t[g]).flatten(0, 2))

    def total(g):
        return t[g].sum(dim=(0, 1, 2))

    dkey = -scatter_keys(rnd(t["datt"]), idx, n_keys)
    dval = scatter_keys(rnd(t["dvpos"]), idx, n_keys)
    dwg2, dbg2 = outer("relu_g", "dzs"), total("dzs")
    if bf16:
        s = softmax_scale(t["datt"].shape[-1])
        dkey, dval = dkey.to(torch.bfloat16), dval.to(torch.bfloat16)
        dwg2, dbg2 = dwg2 * s, dbg2 * s
    return (t["datt"].sum(dim=2), dkey, dval,
            outer("delta", "dh_d"), total("dh_d"), outer("relu_d", "dpos"), total("dpos"),
            outer("att_in", "dh_g"), total("dh_g"), dwg2, dbg2)


def vector_attention_bwd_plain(xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2,
                               k: int, idx, m, l, out, dout) -> Tuple[torch.Tensor, ...]:
    """The plain PyTorch backward: the counterpart of ``_bwd_pallas``, on the
    given idx (B, N, k), m, l and out (``k`` is idx's last dimension; the
    wrapper checks it), in the mode key's dtype selects. Returns
    ``BWD_NAMES``. Materialises ten (B, N, k, D) edge tensors."""
    terms = edge_terms(xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2,
                       idx, m, l, out, dout)
    return reduce_edge_terms(terms, idx, is_bf16(key))


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


def _transposed(weights):
    """Wd2ᵀ, Wg1ᵀ, Wg2ᵀ of ``_weights``, padded as the kernels take them."""
    return [_padded(weights[i].t()) for i in (2, 4, 6)]


def _launch_edge(args, transposed, k: int, idx, m, l, out, dout, dq, planes, delta1) -> None:
    """The edge kernel on the clouds given: writes dq, the staged planes
    (9, rows, D) and [delta, 1] (rows, 4), rows = B·N·16. ``args[4:]`` and
    ``transposed`` (Wd2ᵀ, Wg1ᵀ, Wg2ᵀ) are the weights as the kernels take
    them (``_kernel_weights``, ``_transposed``)."""
    B, N, _ = args[0].shape
    _kernel_call("edge", 23, 5, (*args, *transposed, idx, m, l, out, dout, dq, planes, delta1),
                 (B, N, args[1].shape[-1], k, int(is_bf16(args[2]))), args[0].device)


def staged_edge_terms(xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2,
                      k: int, idx, m, l, out, dout):
    """What the edge kernel stages for the other backward kernels, for
    checking it against ``edge_terms``: dq (B,N,D) and the per-edge tensors
    by name, (B, N, 16, D) each and ``delta`` (B, N, 16, 3). The slots past k
    repeat slot 0's inputs and hold zero cotangents. In the bf16 mode
    ``dzs`` holds dz and ``delta`` is rounded to bf16. CUDA tensors only,
    and at most one chunk of clouds (``MAX_PLANE_FLOATS``)."""
    args = (xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2)
    _check_bwd(args, k, idx, m, l, out, dout)
    args = _widened(args)
    (B, N), D = xyz.shape[:2], q.shape[-1]
    if xyz.device.type != "cuda" or B > clouds_per_chunk(N, D):
        raise ValueError(f"staged_edge_terms: needs CUDA tensors of at most "
                         f"{clouds_per_chunk(N, D)} clouds, got {B} on {xyz.device}")
    _check_launch_bwd(args, idx, m, l, out, dout)
    f32 = dict(dtype=torch.float32, device=xyz.device)
    dq = torch.empty((B, N, D), **f32)
    planes = torch.empty((len(_PLANES), B * N * MAX_K, D), **f32)
    delta1 = torch.empty((B * N * MAX_K, 4), **f32)
    weights = _weights(args)
    _launch_edge((*args[:4], *_kernel_weights(weights)), _transposed(weights), k, idx, m, l, out,
                 dout, dq, planes, delta1)
    terms = {name: planes[i].view(B, N, MAX_K, D) for i, name in enumerate(_PLANES)}
    terms["delta"] = delta1.view(B, N, MAX_K, 4)[..., :3]
    return dq, terms


def _launch_bwd(args, k: int, idx, m, l, out, dout) -> Tuple[torch.Tensor, ...]:
    _check_launch_bwd(args, idx, m, l, out, dout)
    xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2 = args
    (B, N), D = xyz.shape[:2], q.shape[-1]
    dev = xyz.device
    bf16 = int(is_bf16(key))
    f32 = dict(dtype=torch.float32, device=dev)
    weights = _weights(args)
    weights, transposed = _kernel_weights(weights), _transposed(weights)
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
        _kernel_call("wgrad", 2, 4, (planes, wpart[c]), (rows, D, WGRAD_SPLITS, bf16), dev)
        _kernel_call("thin", 3, 4, (delta1, planes[_PLANES.index("dh_d")], tpart[c]),
                     (rows, D, THIN_SPLITS, bf16), dev)
        _kernel_call("scatter", 5, 5,
                     (idx[chunk], planes[_PLANES.index("datt")], planes[_PLANES.index("dvpos")],
                      dkey[chunk], dval[chunk]),
                     (chunk.stop - b0, N, D, k, bf16), dev)
    wsum = torch.empty((3, D + 1, D), **f32)  # dWg2, dWg1, dWd2, each over its bias gradient
    tsum = torch.empty((4, D), **f32)  # dWd1 over dbd1
    _kernel_call("reduce", 4, 3, (wpart, wsum, tpart, tsum),
                 (D, len(starts) * WGRAD_SPLITS, len(starts) * THIN_SPLITS), dev)
    vector_attention_bwd.calls += 1
    dwg2, dbg2 = wsum[0, :D], wsum[0, D]
    if bf16:  # the folded weights' gradients, and dkey, dval in key's dtype
        s = softmax_scale(D)
        dkey, dval, dwg2, dbg2 = dkey.to(key.dtype), dval.to(key.dtype), dwg2 * s, dbg2 * s
    return (dq, dkey, dval, tsum[:3], tsum[3], wsum[2, :D], wsum[2, D], wsum[1, :D], wsum[1, D],
            dwg2, dbg2)


def vector_attention_bwd(xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2,
                         k: int, idx, m, l, out, dout) -> Tuple[torch.Tensor, ...]:
    """Backward of ``vector_attention_fwd``'s ``out``: the forward's inputs,
    its idx (B,N,k) int32, m, l, out, and the cotangent dout (B,N,D), all
    contiguous; returns the gradients ``BWD_NAMES`` of q (f32), key, val
    (B,N,D; bf16 in the bf16 mode) and of the eight weights (f32).

    CPU tensors go to the plain version, CUDA tensors to the kernels; a build
    or launch failure raises. ``vector_attention_bwd.calls`` counts the calls
    that went to the kernels and ``vector_attention_bwd.launches`` each
    kernel's launches: per chunk of clouds (``MAX_PLANE_FLOATS``) one each of
    edge, wgrad, thin and scatter, and one reduce per call.
    """
    args = (xyz, q, key, val, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2)
    _check_bwd(args, k, idx, m, l, out, dout)
    args = _widened(args)
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
    in ``_vecattn_bwd`` (``vector_attention_pallas.py:673-687``). In the bf16
    mode dkey and dval come back bf16, as ``_vecattn_bwd`` casts them."""

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
    gradients. A bf16 q (the bf16 mode's) is widened to f32 first, as the
    JAX wrapper does, so its gradient is rounded to bf16 on the way back."""
    return FusedVectorAttention.apply(xyz, q.to(torch.float32), key, val, wd1, bd1, wd2, bd2,
                                      wg1, bg1, wg2, bg2, k)
