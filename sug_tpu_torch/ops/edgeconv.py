"""EdgeConv kNN-gather-reduce: the CUDA kernels, their plain versions, and
the wrappers that dispatch between them.

``edgeconv_reduce(q, kv, u, v, k)`` finds, for each query ``q[b, s]``, its k
nearest keys in ``kv[b]`` (f32 squared distance, the lowest index winning a
tie), forms ``a_j = u[b, idx_j] + v[b, s]`` and returns the max, min, sum and
sum of squares of ``a_j`` over j, plus idx (B, S, k) int32. It is the
counterpart of the TPU kernel behind ``fused_edgeconv_reduce`` and
``fused_cross_edgeconv_reduce`` (``sug_tpu/ops/edgeconv_pallas.py``). On the
card it runs as two kernels: ``select`` (the kNN indices, a streaming top-k
over key tiles) and ``gather`` (the four reductions from idx);
``cross_knn_indices`` and ``gather_reduce_plain`` are their plain versions,
the latter in the kernel's order of adds.

``edgeconv_reduce_bwd`` is its backward, the counterpart of ``_bwd_pallas``:
it replays ``a_j`` from idx, routes the max/min cotangents to the first j
(in idx order) whose ``a_j`` equals amax/amin, and returns dU (summed over
each key's entries) and dV (summed per query). On the card it runs as three
kernels: ``csr`` (each cloud's key lists, in ascending entry id), ``rows``
(dV and the first-hit positions, query-major) and ``keys`` (dU, key-major);
``key_csr_plain``, ``first_hits_plain`` and ``du_by_key_plain`` are their
plain versions, in the kernels' order of adds. ``EdgeConvReduce`` joins the
forward and backward in one ``torch.autograd.Function``, as ``_fused_cross``
does with its custom VJP; ``fused_edgeconv_reduce`` and
``fused_cross_edgeconv_reduce`` call it.

``values_bf16`` is the mode the bf16 policy selects (``PRECISION: bf16``,
``models/precision.py``), the TPU kernel's flag of that name: ``u`` is
rounded to bf16 once (round to nearest even, or taken as it comes where it
is bf16), ``a_j = f32(bf16(u[idx_j])) + v`` in f32, and neighbour selection
and the four sums stay f32. Its backward replays that ``a_j``, sums dV from
the unrounded edge cotangents and dU from the cotangents rounded to bf16,
in f32 (``edgeconv_pallas.py:351-355``). On the card the gather, rows and
keys kernels then read u at 2 bytes an element. Every plain version takes
the flag too and stays the kernels' bit-for-bit specification. DGCNN's four
blocks and the SA-node's re-query (DGCNN and PointNet) select the mode under
the policy.

On a CPU tensor each wrapper runs its plain PyTorch version; on a CUDA tensor
it launches its hand-written kernels (``csrc/edgeconv_fwd.cu``,
``csrc/edgeconv_bwd.cu``) or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sug_tpu_torch.ops import cuda_build
from sug_tpu_torch.ops.geometry import cross_knn_indices, index_points

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
Reductions = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

_CUDA_ERROR_INVALID_VALUE = 1
# the forward kernels' limits (kMaxK and kMaxC in csrc/edgeconv_fwd.cu): each
# query's top-k list is two words per lane of a warp, and the select block
# keeps its 64 queries' coordinates in shared memory
MAX_FWD_K = 64
MAX_FWD_C = 512
# the backward kernels' limits (kMaxK and kMaxKeys in csrc/edgeconv_bwd.cu):
# jmax and jmin are uint8, with k meaning "no hit"; the csr kernel's cursor
# holds N ints of shared memory
MAX_BWD_K = 255
MAX_BWD_KEYS = 56 * 1024


def values(u: torch.Tensor, v: torch.Tensor, values_bf16: bool) -> torch.Tensor:
    """What ``a_j`` gathers, in v's dtype: u, or with ``values_bf16`` u
    rounded to bf16 (an exact cast where u is bf16 already)."""
    return u.to(torch.bfloat16).to(v.dtype) if values_bf16 else u


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (to nearest even) and back to its dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def edgeconv_reduce_plain(q, kv, u, v, k: int, values_bf16: bool = False) -> Outputs:
    """The plain PyTorch version: the counterpart of
    ``edgeconv_reduce_reference``, with a query set that may differ from the
    key set."""
    idx = cross_knn_indices(q, kv, k)  # (B, S, k)
    a = index_points(values(u, v, values_bf16), idx) + v[:, :, None, :]  # (B, S, k, F)
    return (
        torch.amax(a, dim=2),
        torch.amin(a, dim=2),
        torch.sum(a, dim=2),
        torch.sum(a * a, dim=2),
        idx.to(torch.int32),
    )


def gather_reduce_plain(idx, u, v, values_bf16: bool = False) -> Reductions:
    """The plain version of the ``gather`` kernel: from idx (B,S,k) int32, u
    (B,N,F) and v (B,S,F), amax, amin, s1 and s2 (B,S,F) of ``a_j = u[idx_j]
    + v`` (``values(u)`` with ``values_bf16``), each a loop over j from 0 with
    every product and add rounded on its own, so the kernel repeats them bit
    for bit. max and min skip a NaN, as the kernel's ``fmaxf`` and ``fminf``
    do."""
    a = index_points(values(u, v, values_bf16), idx) + v[:, :, None, :]  # (B, S, k, F)
    amax = torch.full_like(v, float("-inf"))
    amin = torch.full_like(v, float("inf"))
    s1, s2 = torch.zeros_like(v), torch.zeros_like(v)
    for j in range(idx.shape[2]):
        aj = a[:, :, j]
        amax, amin = torch.fmax(amax, aj), torch.fmin(amin, aj)
        s1, s2 = s1 + aj, s2 + aj * aj
    return amax, amin, s1, s2


def check_fwd_kernel_limits(B: int, S: int, N: int, C: int, F: int, k: int) -> None:
    """Raises ValueError, with the shape, where the forward kernels cannot
    run: k above ``MAX_FWD_K``, C above ``MAX_FWD_C``, or more than 65535
    clouds (the select grid's y). The wrapper checks it on every device, so
    a model that runs on the CPU also runs on the card."""
    if k > MAX_FWD_K or C > MAX_FWD_C or B > 65535:
        raise ValueError(f"edgeconv_reduce: the kernels take k <= {MAX_FWD_K}, C <= "
                         f"{MAX_FWD_C} and B <= 65535; got B={B}, S={S}, N={N}, C={C}, "
                         f"F={F}, k={k}")


def _check_dtype(fn: str, name: str, t, ref, values_bf16: bool) -> None:
    """f32 (or f64 on the CPU) like ``ref``; with ``values_bf16``, f32 only,
    and ``u`` may be bf16."""
    if values_bf16 and name == "u" and t.dtype == torch.bfloat16:
        return
    if t.dtype != torch.float32 and not (t.dtype == torch.float64 and t.device.type == "cpu"
                                         and not values_bf16):
        raise TypeError(f"{fn}: {name} must be float32 (or float64 on the CPU; with values_bf16 "
                        f"float32, u also bfloat16), got {t.dtype}")
    if t.dtype != ref.dtype:
        raise TypeError(f"{fn}: {name} is {t.dtype}, {'q' if fn == 'edgeconv_reduce' else 'v'} "
                        f"{ref.dtype}")


def _check(q, kv, u, v, k: int, values_bf16: bool = False) -> None:
    names = ("q", "kv", "u", "v")
    for name, t in zip(names, (q, kv, u, v)):
        _check_dtype("edgeconv_reduce", name, t, q, values_bf16)
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
    check_fwd_kernel_limits(B, S, N, C, F, k)


def _launch(q, kv, u, v, k: int, values_bf16: bool = False) -> Outputs:
    lib = cuda_build.library("edgeconv_fwd", "edgeconv_error_string", 9, 7)
    if values_bf16:
        u = u.to(torch.bfloat16)  # rounded once, read at 2 bytes by the gather kernel
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
            B, S, N, C, F, k, int(values_bf16), stream,
        )
    if err != 0:
        msg = (f"edgeconv_fwd launch failed: {lib.edgeconv_error_string(err).decode()} "
               f"(B={B}, S={S}, N={N}, C={C}, F={F}, k={k}, values_bf16={values_bf16})")
        raise (ValueError if err == _CUDA_ERROR_INVALID_VALUE else RuntimeError)(msg)
    edgeconv_reduce.launches += 1
    return amax, amin, s1, s2, idx


def edgeconv_reduce(q, kv, u, v, k: int, values_bf16: bool = False) -> Outputs:
    """kNN of ``q`` (B,S,C) against ``kv`` (B,N,C) + gather-reduce of ``u``
    (B,N,F) plus ``v`` (B,S,F): amax, amin, s1, s2 (B,S,F) f32 and idx
    (B,S,k) int32. Self-kNN passes ``q is kv`` (the point itself included).
    ``values_bf16`` (the bf16 policy's mode) gathers u rounded to bf16; u
    may then be bf16 or f32, every other input f32.

    CPU tensors (f32, or f64 in every input outside ``values_bf16``) go to
    the plain version, CUDA tensors (f32) to the kernels; a
    build or launch failure raises, and so does a shape beyond the kernels'
    limits (``check_fwd_kernel_limits``) on either device. One call launches
    the two kernels ``select`` and ``gather``, in either mode;
    ``edgeconv_reduce.launches`` counts calls.
    """
    _check(q, kv, u, v, k, values_bf16)
    if q.device.type == "cpu":
        return edgeconv_reduce_plain(q, kv, u, v, k, values_bf16)
    if q.device.type != "cuda":
        raise ValueError(f"edgeconv_reduce: no path for device {q.device}")
    return _launch(q, kv, u, v, k, values_bf16)


def edgeconv_reduce_stages(q, kv, u, v, k: int, values_bf16: bool = False) -> Outputs:
    """The forward kernels' outputs, for checking each against its plain
    version: idx (``select``), then amax, amin, s1, s2 (``gather``, from that
    idx). CUDA tensors only."""
    _check(q, kv, u, v, k, values_bf16)
    if q.device.type != "cuda":
        raise ValueError(f"edgeconv_reduce_stages: needs CUDA tensors, got {q.device}")
    amax, amin, s1, s2, idx = _launch(q, kv, u, v, k, values_bf16)
    return idx, amax, amin, s1, s2


edgeconv_reduce.launches = 0


def _edge_cotangent(a, sel_max, sel_min, damax, damin, ds1, ds2):
    """da = damax*selmax + damin*selmin + ds1 + 2*a*ds2, in the Pallas
    kernel's order of operations."""
    return damax * sel_max + damin * sel_min + ds1 + 2.0 * a * ds2


def edge_cotangents(idx, u, v, amax, amin, damax, damin, ds1, ds2,
                    values_bf16: bool = False) -> torch.Tensor:
    """The per-edge cotangents ``da`` (B, S, k, F) of the backward: the
    replayed ``a`` (from ``values(u)``), the max/min cotangents on the first
    j (in idx order) whose ``a`` hits amax/amin, and the sum terms."""
    a = index_points(values(u, v, values_bf16), idx) + v[:, :, None, :]  # the forward's add
    hit_max = a == amax[:, :, None, :]
    hit_min = a == amin[:, :, None, :]
    sel_max = hit_max & (torch.cumsum(hit_max, dim=2) == 1)
    sel_min = hit_min & (torch.cumsum(hit_min, dim=2) == 1)
    return _edge_cotangent(a, sel_max, sel_min,
                           *(t[:, :, None, :] for t in (damax, damin, ds1, ds2)))


def scatter_keys(da: torch.Tensor, idx: torch.Tensor, n_keys: int) -> torch.Tensor:
    """Sum (B, S, k, F) edge values into their keys: (B, n_keys, F)."""
    B, S, k, F = da.shape
    out = torch.zeros((B, n_keys, F), dtype=da.dtype, device=da.device)
    return out.scatter_add_(1, idx.reshape(B, S * k, 1).long().expand(-1, -1, F),
                            da.reshape(B, S * k, F))


def edgeconv_reduce_bwd_plain(idx, u, v, amax, amin, damax, damin, ds1, ds2,
                              values_bf16: bool = False):
    """The plain PyTorch backward: the counterpart of ``_bwd_pallas``.
    Materialises the (B, S, k, F) edge cotangents; with ``values_bf16`` dU
    sums them rounded to bf16, dV unrounded. du is in v's dtype."""
    da = edge_cotangents(idx, u, v, amax, amin, damax, damin, ds1, ds2, values_bf16)
    du_terms = round_bf16(da) if values_bf16 else da
    return scatter_keys(du_terms, idx, u.shape[1]), torch.sum(da, dim=2)


def _check_bwd(idx, u, v, amax, amin, damax, damin, ds1, ds2, values_bf16: bool = False) -> None:
    if idx.dtype != torch.int32 or idx.dim() != 3 or not idx.is_contiguous():
        raise ValueError(f"edgeconv_reduce_bwd: idx must be contiguous (B,S,k) int32, got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    B, S, k = idx.shape
    if u.dim() != 3 or u.shape[0] != B or not 1 <= k <= u.shape[1]:
        raise ValueError(f"edgeconv_reduce_bwd: u must be (B,N,F) with k <= N, got "
                         f"{tuple(u.shape)} for idx {tuple(idx.shape)}")
    F = u.shape[-1]
    names = ("u", "v", "amax", "amin", "damax", "damin", "ds1", "ds2")
    for name, t in zip(names, (u, v, amax, amin, damax, damin, ds1, ds2)):
        _check_dtype("edgeconv_reduce_bwd", name, t, v, values_bf16)
        if not t.is_contiguous():
            raise ValueError(f"edgeconv_reduce_bwd: {name} must be contiguous")
        if t.device != idx.device:
            raise ValueError(f"edgeconv_reduce_bwd: {name} is on {t.device}, idx on {idx.device}")
        if name != "u" and t.shape != (B, S, F):
            raise ValueError(f"edgeconv_reduce_bwd: {name} must be (B,S,F) = {(B, S, F)}, "
                             f"got {tuple(t.shape)}")


def key_csr_plain(idx: torch.Tensor, n_keys: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each cloud's key lists, the plain version of the ``csr`` kernel: from
    idx (B,S,k), offsets (B, n_keys+1) and edges (B, S*k) int32, where key
    n's list ``edges[b, offsets[b, n]:offsets[b, n+1]]`` holds the entry ids
    e = s*k + j with ``idx[b, s, j] == n``, in ascending e."""
    B = idx.shape[0]
    flat = idx.reshape(B, -1).long()
    edges = torch.sort(flat, dim=1, stable=True).indices.to(torch.int32)
    counts = torch.zeros((B, n_keys), dtype=torch.long, device=idx.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    offsets = torch.zeros((B, n_keys + 1), dtype=torch.long, device=idx.device)
    offsets[:, 1:] = torch.cumsum(counts, dim=1)
    return offsets.to(torch.int32), edges


def _first_hit(hit: torch.Tensor) -> torch.Tensor:
    """The first j along dim 2 where ``hit`` is set, k where none is: the
    count of leading misses."""
    return (torch.cumsum(hit, dim=2) == 0).sum(dim=2)


def first_hits_plain(idx, u, v, amax, amin, damax, damin, ds1, ds2, values_bf16: bool = False):
    """The plain version of the ``rows`` kernel: jmax and jmin (B,S,F) uint8,
    the first j whose replayed ``a_j`` equals amax (amin), k where none does,
    and dv (B,S,F), the edge cotangents (unrounded in either mode) summed in
    j order from 0."""
    a = index_points(values(u, v, values_bf16), idx) + v[:, :, None, :]  # the forward's add
    jmax = _first_hit(a == amax[:, :, None, :])
    jmin = _first_hit(a == amin[:, :, None, :])
    dv = torch.zeros_like(v)
    for j in range(idx.shape[2]):
        dv = dv + _edge_cotangent(a[:, :, j], jmax == j, jmin == j, damax, damin, ds1, ds2)
    return jmax.to(torch.uint8), jmin.to(torch.uint8), dv


def du_by_key_plain(offsets, edges, u, v, jmax, jmin, damax, damin, ds1, ds2, k: int,
                    values_bf16: bool = False):
    """The plain version of the ``keys`` kernel: du (B,N,F) in v's dtype,
    each key's edge cotangents (rounded to bf16 with ``values_bf16``) summed
    in the order of its list from 0. The lists are walked column by column
    up to the longest, L: L steps over (B, N, F)."""
    F = u.shape[-1]
    u = values(u, v, values_bf16)
    start, count = offsets[:, :-1].long(), (offsets[:, 1:] - offsets[:, :-1]).long()

    def rows(t, s):  # t[b, s[b, n], :] for each key n
        return torch.gather(t, 1, s[:, :, None].expand(-1, -1, F))

    du = torch.zeros_like(u)
    for col in range(int(count.max().item()) if count.numel() else 0):
        live = col < count  # (B, N)
        e = torch.gather(edges.long(), 1, torch.where(live, start + col, 0))
        s, j = e // k, (e % k)[:, :, None]
        a = u + rows(v, s)
        da = _edge_cotangent(a, rows(jmax, s).long() == j, rows(jmin, s).long() == j,
                             *(rows(t, s) for t in (damax, damin, ds1, ds2)))
        du = torch.where(live[:, :, None], du + (round_bf16(da) if values_bf16 else da), du)
    return du


def edgeconv_reduce_bwd_stages_plain(idx, u, v, amax, amin, damax, damin, ds1, ds2,
                                     values_bf16: bool = False):
    """The three plain versions in turn, as the kernels run: du, dv, offsets,
    edges, jmax, jmin, in the layout of ``edgeconv_reduce_bwd_stages``."""
    offsets, edges = key_csr_plain(idx, u.shape[1])
    jmax, jmin, dv = first_hits_plain(idx, u, v, amax, amin, damax, damin, ds1, ds2, values_bf16)
    du = du_by_key_plain(offsets, edges, u, v, jmax, jmin, damax, damin, ds1, ds2, idx.shape[2],
                         values_bf16)
    return du, dv, offsets, edges, jmax, jmin


def check_bwd_kernel_limits(B: int, S: int, N: int, F: int, k: int) -> None:
    """Raises ValueError, with the shape, where the backward kernels cannot
    run: k above ``MAX_BWD_K``, N above ``MAX_BWD_KEYS``, or more than 65535
    clouds (one csr block each, the rows and keys grids' y)."""
    if k > MAX_BWD_K or N > MAX_BWD_KEYS or B > 65535:
        raise ValueError(f"edgeconv_reduce_bwd: the kernels take k <= {MAX_BWD_K}, N <= "
                         f"{MAX_BWD_KEYS} and B <= 65535; got B={B}, S={S}, N={N}, F={F}, k={k}")


def _launch_bwd(idx, u, v, amax, amin, damax, damin, ds1, ds2, values_bf16: bool = False):
    """Launches the backward's three kernels; returns du, dv and the scratch
    (offsets, edges, jmax, jmin)."""
    B, S, k = idx.shape
    N, F = u.shape[1], u.shape[2]
    check_bwd_kernel_limits(B, S, N, F, k)
    lib = cuda_build.library("edgeconv_bwd", "edgeconv_bwd_error_string", 15, 6)
    if values_bf16:
        u = u.to(torch.bfloat16)  # as the forward rounded it
    du = torch.empty(u.shape, dtype=v.dtype, device=v.device)  # the kernels write every element
    dv = torch.empty_like(v)
    offsets = torch.empty((B, N + 1), dtype=torch.int32, device=idx.device)
    edges = torch.empty((B, S * k), dtype=torch.int32, device=idx.device)
    jmax, jmin = (torch.empty((B, S, F), dtype=torch.uint8, device=idx.device) for _ in range(2))
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream(idx.device).cuda_stream
        err = lib.edgeconv_bwd(
            idx.data_ptr(), u.data_ptr(), v.data_ptr(), amax.data_ptr(), amin.data_ptr(),
            damax.data_ptr(), damin.data_ptr(), ds1.data_ptr(), ds2.data_ptr(),
            du.data_ptr(), dv.data_ptr(), offsets.data_ptr(), edges.data_ptr(),
            jmax.data_ptr(), jmin.data_ptr(), B, S, N, F, k, int(values_bf16), stream,
        )
    if err != 0:
        msg = lib.edgeconv_bwd_error_string(err).decode()
        raise RuntimeError(f"edgeconv_bwd launch failed: {msg} (B={B}, S={S}, N={N}, F={F}, k={k}, "
                           f"values_bf16={values_bf16})")
    edgeconv_reduce_bwd.launches += 1
    return du, dv, (offsets, edges, jmax, jmin)


def edgeconv_reduce_bwd(idx, u, v, amax, amin, damax, damin, ds1, ds2,
                        values_bf16: bool = False):
    """Backward of ``edgeconv_reduce`` with respect to ``u`` and ``v``: idx
    (B,S,k) int32, u (B,N,F), and v, amax, amin and the four output
    cotangents (B,S,F), all f32 contiguous (or all f64 on the CPU); with
    ``values_bf16`` (the forward's mode) u may be bf16, the rest f32. Returns
    du (B,N,F) and dv (B,S,F), in v's dtype.

    CPU tensors go to the plain version, CUDA tensors to the kernels; a build
    or launch failure raises. One call launches the three kernels ``csr``,
    ``rows`` and ``keys``, in either mode; ``edgeconv_reduce_bwd.launches``
    counts calls.
    """
    args = (idx, u, v, amax, amin, damax, damin, ds1, ds2)
    _check_bwd(*args, values_bf16)
    if idx.device.type == "cpu":
        return edgeconv_reduce_bwd_plain(*args, values_bf16)
    if idx.device.type != "cuda":
        raise ValueError(f"edgeconv_reduce_bwd: no path for device {idx.device}")
    return _launch_bwd(*args, values_bf16)[:2]


def edgeconv_reduce_bwd_stages(idx, u, v, amax, amin, damax, damin, ds1, ds2,
                               values_bf16: bool = False):
    """The backward kernels' outputs, for checking each against its plain
    version: du, dv, then offsets and edges (``csr``), jmax and jmin
    (``rows``). CUDA tensors only."""
    args = (idx, u, v, amax, amin, damax, damin, ds1, ds2)
    _check_bwd(*args, values_bf16)
    if idx.device.type != "cuda":
        raise ValueError(f"edgeconv_reduce_bwd_stages: needs CUDA tensors, got {idx.device}")
    du, dv, scratch = _launch_bwd(*args, values_bf16)
    return (du, dv, *scratch)


edgeconv_reduce_bwd.launches = 0


class EdgeConvReduce(torch.autograd.Function):
    """``edgeconv_reduce`` with its backward: gradients reach ``u`` and ``v``;
    ``q`` and ``kv`` only select neighbours and get none, and idx is not
    differentiable (``_fused_bwd``, ``edgeconv_pallas.py:689-696``). With
    ``values_bf16`` u is rounded to bf16 once, here, and that bf16 u is
    saved for the backward; dU comes back in u's own dtype."""

    @staticmethod
    def forward(ctx, q, kv, u, v, k: int, values_bf16: bool = False):
        ctx.u_dtype, ctx.values_bf16 = u.dtype, values_bf16
        if values_bf16:
            u = u.to(torch.bfloat16)
        amax, amin, s1, s2, idx = edgeconv_reduce(q, kv, u, v, k, values_bf16)
        ctx.save_for_backward(idx, u, v, amax, amin)
        ctx.mark_non_differentiable(idx)
        return amax, amin, s1, s2, idx

    @staticmethod
    def backward(ctx, damax, damin, ds1, ds2, _didx):
        # autograd passes zeros for the outputs the loss does not use
        idx, u, v, amax, amin = ctx.saved_tensors
        du, dv = edgeconv_reduce_bwd(
            idx, u, v, amax, amin,
            *(g.contiguous() for g in (damax, damin, ds1, ds2)), ctx.values_bf16,
        )
        return None, None, du.to(ctx.u_dtype), dv, None, None


def fused_edgeconv_reduce(x, u, v, k: int, values_bf16: bool = False) -> Outputs:
    """Self-kNN EdgeConv case: ``x`` (B,N,C) is both query and key set."""
    return EdgeConvReduce.apply(x, x, u, v, k, values_bf16)


def fused_cross_edgeconv_reduce(q_pts, kv_pts, u, v, k: int, values_bf16: bool = False) -> Outputs:
    """Cross-query case: S queries against N keys (the SA-node re-query)."""
    return EdgeConvReduce.apply(q_pts, kv_pts, u, v, k, values_bf16)
