"""KPConv: counterpart of ``sug_tpu/models/kpconv.py``, on either of its
pyramids, rigid or deformable.

Channels-last (B, N, C) as in the JAX package. The pyramid is built without
gradients (the clouds are data). On the grid pyramid (``pyramid="grid"``,
the default) each level is a fixed-capacity voxel-grid subsample of the one
before (``grid_subsample_fixed``), its rows valid in front and pad rows at
far sentinels behind, with per-level masks; on the FPS pyramid (any other
``pyramid``) each level is the farthest-point sample of
``max(N // LEVEL_FRACTIONS[l], 4)`` points of the one before, through the
FPS kernel on the card, every row valid and no masks. The neighbourhoods
are masked fixed-K radius queries (``radius_neighbors_masked``). The
convolution (``KPConvOp``, rigid, or deformable with its ``offset_conv``
and optional modulations), the parameter-free ``instance_norm``, the
simple and resnet-bottleneck blocks, the 14-block encoder, the deformable
ops' fitting and repulsive regularizer (``p2p_fitting_regularizer``), the
DG generator (``KPConvGenerator``) and the standalone classifier
(``KPConvClassifier``) follow the JAX modules, and their submodules carry
the JAX tree's names (``encoder/block{i}/KPConv/weights``,
``.../KPConv/offset_conv/weights``, ``.../KPConv/offset_bias``,
``unary1/Dense_0`` as ``unary1.dense0``), so ``utils/jax_bridge.py`` loads
a JAX tree strictly. The network itself is plain PyTorch, as the JAX
package runs it as plain XLA; only the FPS pyramid reaches a kernel.

The deformable ops' regularizer terms, which the JAX ops sow into a
``regularizers`` collection, are appended to a list that each forward is
given (``terms``), one ``(min_d2 / ext², deformed_kp / ext, q_mask or
None)`` per deformable op in module order; no module keeps them.

Where the two devices may differ. Centroids are prefix-sum differences of a
whole-cloud f32 ``cumsum``, whose order of summation differs between the
CPU, the card and XLA, so a centroid moves by a few ulps; at the next level
``floor(c / dl)`` can then flip for a centroid on a voxel face, and a radius
query for a point at ``|d² − r²| ≈ 0``. The voxel index divides by ``dl``
as a 0-dim f32 tensor on the points' device, a true division as XLA's
(PyTorch's CUDA division by a host scalar multiplies by its reciprocal).
Pad rows sit at sentinels ``1e6 + 10·i``; between two sentinels the
distances are rounding noise of 1e12-sized terms, so a pad row's neighbours
are noise that differs between devices. Only valid rows are read: the
``instance_norm`` zeroes pad rows, ``_masked_mean`` and
``_sample_tensor_slices`` read valid rows alone.

Not ported here (ROADMAP.md): KPConv under the bf16 policy (item 17c),
refused through ``bf16_queued``.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn
from torch import nn

from sug_tpu_torch.models.kernel_points import load_kernels
from sug_tpu_torch.models.layers import Dense, flax_init_
from sug_tpu_torch.ops.geometry import farthest_point_sample, index_points, square_distance

BF16_QUEUED = "item 17c"

KPCONV_DEFAULTS = dict(
    num_class=10,
    first_subsampling_dl=0.05,
    conv_radius=2.5,
    deform_radius=6.0,
    in_feats_dim=1,
    KP_extent=1.2,
    KP_influence="linear",
    use_batch_norm=True,
    batch_norm_momentum=0.02,
    modulated=False,
    num_kernel_points=15,
    first_feats_dim=64,
    fixed_kernel_points="center",
    aggregation_mode="sum",
    num_layers=5,
    deform_fitting_power=1.0,
    kp_method="lloyd",  # or "gd", the reference's gradient-descent optimizer
    kp_random_init=False,  # the reference's load-time rotation and 0.01 jitter
    kp_seed=0,
    pyramid="grid",  # any other value builds the FPS pyramid
    grid_dl=0.05,
    grid_capacities=(1024, 512, 256, 96, 48),
    neighbor_limits=None,  # per-level override of NEIGHBOR_LIMITS
    architecture=(
        "simple",
        "resnetb",
        "resnetb_strided",
        "resnetb",
        "resnetb",
        "resnetb_strided",
        "resnetb",
        "resnetb",
        "resnetb_strided",
        "resnetb",
        "resnetb",
        "resnetb_strided",
        "resnetb",
        "resnetb",
    ),
)

# the FPS pyramid's level sizes: max(N // LEVEL_FRACTIONS[l], 4) points
LEVEL_FRACTIONS = (1, 4, 16, 32, 64)
# the per-level neighbour caps (MODEL_CFG.NEIGHBOR_LIMITS overrides them)
NEIGHBOR_LIMITS = (24, 24, 24, 24, 16)
# half-extent of the voxel frame: clouds are unit-normalised, so (-4, 4)
_GRID_R = 4.0


def _normalize_cfg(model_cfg) -> dict:
    """MODEL_CFG's keys mapped onto ``KPCONV_DEFAULTS``' names: a key that
    is not one of them is lower-cased (YAML configs write UPPERCASE)."""
    if not model_cfg:
        return {}
    return {k if k in KPCONV_DEFAULTS else k.lower(): v for k, v in dict(model_cfg).items()}


def kpconv_config(model_cfg=None) -> dict:
    """``KPCONV_DEFAULTS`` updated by ``model_cfg``. As in the JAX package,
    ``pyramid`` "grid" builds the grid pyramid and any other value the FPS
    one, and a block whose name holds "deform" is deformable."""
    return dict(KPCONV_DEFAULTS, **_normalize_cfg(model_cfg))


def _morton3(v: torch.Tensor) -> torch.Tensor:
    """The low 10 bits of 3 integer voxel coordinates (..., 3) interleaved
    into a Morton (Z-order) code below 2**30: ``_morton3(v >> 1) ==
    _morton3(v) >> 3``."""

    def spread(x):
        x = x & 0x3FF
        x = (x | (x << 16)) & 0x30000FF
        x = (x | (x << 8)) & 0x300F00F
        x = (x | (x << 4)) & 0x30C30C3
        x = (x | (x << 2)) & 0x9249249
        return x

    return (spread(v[..., 0]) << 2) | (spread(v[..., 1]) << 1) | spread(v[..., 2])


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x`` (B, M) or (B, M, C) gathered along axis 1 at ``idx`` (B, S)."""
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def grid_subsample_fixed(pc: torch.Tensor, dl: float, capacity: int,
                         valid: Optional[torch.Tensor] = None,
                         pre_sorted: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-capacity voxel-grid subsampling with segment-mean centroids:
    (B, N, 3) points in (-4, 4) -> (B, capacity, 3) centroids and their
    (B, capacity) float validity mask.

    Points are floor-quantised to voxels of side ``dl``; the voxels' Morton
    keys are sorted (stably, carrying x, y and z), and each occupied voxel's
    centroid is the difference of a whole-cloud prefix sum at its segment's
    ends over its count. Where more voxels are occupied than ``capacity``, a
    stratified pick over the Morton order keeps ``capacity`` of them. Slots
    beyond the occupied voxels are invalid and sit at the sentinels
    ``1e6 + 10·i``. ``valid`` (B, N) marks the real input rows; others take
    the pad key ``1 << 30`` and sort last. ``pre_sorted`` promises that the
    valid rows already lie in the Morton order of this grid (the output of
    the level below on the aligned 2x finer grid does) and skips the sort.
    """
    B, N, _ = pc.shape
    K = int(2 * _GRID_R / dl) + 2
    if K > 1024:
        raise ValueError(f"grid_subsample_fixed: dl={dl} gives {K} voxels/axis > the 10-bit "
                         "Morton budget; raise dl")
    f = pc.float()
    step = torch.tensor(dl, dtype=torch.float32, device=pc.device)
    v = torch.floor(f / step).to(torch.int32) + int(_GRID_R / dl)
    key = _morton3(torch.clamp(v, 0, K - 1))
    pad_key = 1 << 30
    if valid is not None:
        key = torch.where(valid > 0, key, pad_key)
    if pre_sorted:
        skey, sf = key, f
    else:
        skey, perm = torch.sort(key, dim=1, stable=True)
        sf = _take(f, perm)
    is_real = skey < pad_key
    w = is_real.float()
    is_first = torch.cat([torch.ones_like(is_real[:, :1]), skey[:, 1:] != skey[:, :-1]], 1) & is_real
    n_vox = is_first.sum(1)
    n_real = is_real.sum(1)

    # prefix sums with a leading zero: segment rows [s, e) sum to P[e] − P[s]
    P = torch.cat([f.new_zeros(B, 1, 3), torch.cumsum(sf * w[..., None], 1)], 1)
    Pw = torch.cat([f.new_zeros(B, 1), torch.cumsum(w, 1)], 1)

    # segment start rows in voxel-rank order; ranks >= n_vox hold N
    iota = torch.arange(N, device=pc.device)
    starts = torch.sort(torch.where(is_first, iota, N), dim=1).values
    i = torch.arange(capacity, device=pc.device)
    strat = (i[None, :] * n_vox[:, None]) // max(capacity, 1)
    head = torch.minimum(i[None, :], torch.clamp(n_vox[:, None] - 1, min=0))
    take = torch.where(n_vox[:, None] > capacity, strat, head)
    s_row = _take(starts, take)
    nxt_row = _take(starts, torch.clamp(take + 1, max=N - 1))
    e_row = torch.where(take + 1 < n_vox[:, None], nxt_row, n_real[:, None])
    s_row = torch.clamp(s_row, max=N)  # a cloud with no voxel: keep the gathers in bounds

    seg_sum = _take(P, e_row) - _take(P, s_row)
    cnt = _take(Pw, e_row) - _take(Pw, s_row)
    out = (seg_sum / torch.clamp(cnt, min=1.0)[..., None]).to(pc.dtype)
    out_valid = (i[None, :] < n_vox[:, None]).to(pc.dtype)
    sentinel = (1e6 + 10.0 * i.to(pc.dtype))[None, :, None]
    return torch.where(out_valid[..., None] > 0, out, sentinel), out_valid


def radius_neighbors_masked(radius: float, nsample: int, s_pts: torch.Tensor,
                            q_pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-K radius neighbours of ``q_pts`` (B, Q, 3) among ``s_pts``
    (B, S, 3): (idx (B, Q, K) int64, clamped in range; mask (B, Q, K) float
    0/1), K = min(nsample, S). The in-radius points (``d² <= r²``, r² in
    f32) are taken in ascending index order."""
    S = s_pts.shape[1]
    sqr = square_distance(q_pts, s_pts)
    r2 = torch.tensor(radius**2, dtype=sqr.dtype, device=sqr.device)
    iota = torch.arange(S, dtype=torch.int32, device=sqr.device)
    keys = torch.where(sqr > r2, S, iota)
    idx = torch.topk(keys, min(nsample, S), dim=-1, largest=False, sorted=True).values.long()
    return torch.clamp(idx, max=S - 1), (idx < S).float()


def build_pyramid(pc: torch.Tensor, cfg: dict,
                  fps_start: Optional[torch.Tensor] = None) -> Dict[str, List]:
    """The pyramid of (B, N, 3) clouds, without gradients: per level
    ``points`` (B, N_l, 3) and ``valid`` (B, N_l) masks, or None; per level
    ``neighbors`` (idx, mask) within ``dl · conv_radius · 2^l`` of each
    point of the level, and ``pools`` (idx, mask) within the same radius
    from each point of the next level.

    ``pyramid`` "grid": level l > 0 is the voxel-grid subsample of level
    l − 1 at ``grid_dl · 2^l``, capacity ``grid_capacities[l]``, and dl is
    ``grid_dl``; levels from 2 on skip their sort where the voxel offsets of
    the two grids halve exactly (``int(R / dl)``), else sort. Any other
    ``pyramid``: level l > 0 is the FPS of ``max(N // LEVEL_FRACTIONS[l],
    4)`` points of level l − 1, level 1 from ``fps_start`` (B,) (index 0
    where None), the later levels from index 0; dl is
    ``first_subsampling_dl``, and ``valid`` is None."""
    num_layers = cfg["num_layers"]
    grid = cfg["pyramid"] == "grid"
    dl = cfg["grid_dl"] if grid else cfg["first_subsampling_dl"]
    r0 = dl * cfg["conv_radius"]
    limits = cfg.get("neighbor_limits") or NEIGHBOR_LIMITS
    with torch.no_grad():
        points, valids = [pc], None
        if grid:
            caps = cfg["grid_capacities"]
            valids = [torch.ones(pc.shape[:2], dtype=pc.dtype, device=pc.device)]
            for lvl in range(1, num_layers):
                cap = min(int(caps[lvl]), points[-1].shape[1])
                aligned = int(_GRID_R / (dl * 2 ** (lvl - 1))) == 2 * int(_GRID_R / (dl * 2**lvl))
                p, v = grid_subsample_fixed(points[-1], dl * (2**lvl), cap, valid=valids[-1],
                                            pre_sorted=lvl >= 2 and aligned)
                points.append(p)
                valids.append(v)
        else:
            for lvl in range(1, num_layers):
                n_l = max(pc.shape[1] // LEVEL_FRACTIONS[lvl], 4)
                idx = farthest_point_sample(points[-1], n_l, fps_start if lvl == 1 else None)
                points.append(index_points(points[-1], idx))
        neighbors, pools = [], []
        for lvl in range(num_layers):
            r = r0 * (2**lvl)
            k = min(int(limits[lvl]), points[lvl].shape[1])
            neighbors.append(radius_neighbors_masked(r, k, points[lvl], points[lvl]))
            if lvl + 1 < num_layers:
                pools.append(radius_neighbors_masked(r, k, points[lvl], points[lvl + 1]))
    return {"points": points, "neighbors": neighbors, "pools": pools, "valid": valids}


def check_neighbor_occupancy(sample_pts, model_cfg=None, logger=None, batch: int = 8,
                             device="cpu") -> List[float]:
    """The start-up guard of the training loops: the configured pyramid of
    the first ``batch`` clouds of ``sample_pts`` (on ``device``; the FPS
    pyramid from index 0), and per level the mean count of valid neighbours
    of its valid points. Logs
    them, and, with a ``logger``, a warning for a starved level (mean
    below 4) or one that saturates its cap (above 0.95 of K). Returns the
    means."""
    cfg = kpconv_config(model_cfg)
    pc = torch.as_tensor(np.asarray(sample_pts[:batch], dtype=np.float32), device=device)
    pyr = build_pyramid(pc, cfg)
    limits = cfg.get("neighbor_limits") or NEIGHBOR_LIMITS
    means = []
    for lvl, (_, mask) in enumerate(pyr["neighbors"]):
        counts = mask.sum(-1).cpu().numpy()
        if pyr["valid"] is not None:  # the FPS pyramid's rows are all valid
            v = pyr["valid"][lvl].cpu().numpy() > 0
            counts = counts[v] if v.any() else counts
        means.append(float(counts.mean()))
    msg = ", ".join(f"L{i}={m:.1f}" for i, m in enumerate(means))
    (logger.info if logger is not None else print)(
        f"KPConv pyramid occupancy (mean valid neighbors/level): {msg}")
    for lvl, m in enumerate(means):
        k = min(int(limits[lvl]), pyr["points"][lvl].shape[1])
        if m < 4.0 and logger is not None:
            logger.warning(
                f"KPConv level {lvl} is STARVED (mean {m:.1f} neighbors < 4): convolutions see "
                "almost no support — raise MODEL_CFG.first_subsampling_dl (fps) / "
                "MODEL_CFG.grid_dl (grid) or recalibrate with tools/calibrate_kpconv.py")
        elif m > 0.95 * k and logger is not None:
            logger.warning(f"KPConv level {lvl} SATURATES its K={k} cap (mean {m:.1f}): "
                           "neighborhoods are truncated — raise MODEL_CFG.NEIGHBOR_LIMITS")
    return means


class KPConvOp(nn.Module):
    """The kernel-point convolution, rigid or deformable: (q_pts (B, Q, 3),
    s_pts (B, S, 3), neighbour idx and mask (B, Q, k), x (B, S,
    in_channels)) -> (B, Q, out_channels).

    The kernel points (a non-persistent buffer) are ``load_kernels`` at
    ``radius``; with ``kp_random_init`` their seed is ``kp_seed`` plus the
    crc32 of ``path``, the flax module path of the JAX op
    (``g/encoder/block{i}/KPConv`` under NetMDA, ``encoder/block{i}/KPConv``
    in the classifier). Each valid neighbour weighs into each kernel point
    by the influence of its distance (``sq_d = |n|² − 2 n·kp + |kp|²``,
    clamped at 0): ``constant``, ``linear`` (``1 − sqrt(max(sq_d, 1e-12)) /
    kp_extent``, at least 0) or ``gaussian`` (σ = 0.3 kp_extent); with
    ``closest`` aggregation only into its nearest kernel point. The
    influence-weighted neighbour features meet ``weights`` (K,
    in_channels, out_channels) and the sum is divided by the count of valid
    neighbours (at least 1). ``weights`` is drawn as flax's
    ``variance_scaling(1/3, "fan_in", "uniform")``: uniform within
    ``sqrt(1 / (K · in_channels))``.

    ``deformable``: a rigid ``offset_conv`` of the same neighbourhoods and
    ``x`` gives each query 3K outputs (4K with ``modulated``), plus
    ``offset_bias`` (zeros at init); the first 3K, times ``kp_extent``,
    move the kernel points per query, and with ``modulated`` 2·sigmoid of
    the last K scale each kernel point's weighted features. The
    normalising count keeps only the valid neighbours within ``kp_extent``
    of some moved kernel point. Where ``forward`` is given a list
    ``terms``, it appends the regularizer's terms: the squared distance of
    each moved kernel point to its nearest valid neighbour (zeroed on the
    pad rows of ``q_mask``) over ``kp_extent²``, the moved kernel points
    over ``kp_extent``, and ``q_mask`` (None off the grid pyramid). The
    offset conv's kernel points are seeded by its own path,
    ``{path}/offset_conv``."""

    def __init__(self, in_channels: int, out_channels: int, kp_extent: float, radius: float,
                 num_kpoints: int = 15, influence: str = "linear", aggregation: str = "sum",
                 fixed: str = "center", kp_method: str = "lloyd", kp_random_init: bool = False,
                 kp_seed: int = 0, path: str = "", deformable: bool = False,
                 modulated: bool = False):
        super().__init__()
        if influence not in ("constant", "linear", "gaussian"):
            raise ValueError(f"Unknown influence {influence}")
        if aggregation not in ("closest", "sum"):
            raise ValueError("aggregation must be 'closest' or 'sum'")
        self.kp_extent, self.influence, self.aggregation = kp_extent, influence, aggregation
        self.modulated = modulated
        seed = (int(kp_seed) + zlib.crc32(path.encode())) % (2**31) if kp_random_init else kp_seed
        kp = load_kernels(radius, num_kpoints, 3, fixed, method=kp_method,
                          random_init=kp_random_init, seed=seed)
        self.register_buffer("kernel_points", torch.from_numpy(kp), persistent=False)
        self.weights = nn.Parameter(torch.empty(num_kpoints, in_channels, out_channels))
        self.offset_conv = None
        if deformable:
            offset_dim = (4 if modulated else 3) * num_kpoints
            self.offset_conv = KPConvOp(in_channels, offset_dim, kp_extent, radius, num_kpoints,
                                        influence, aggregation, fixed, kp_method, kp_random_init,
                                        kp_seed, f"{path}/offset_conv")
            self.offset_bias = nn.Parameter(torch.zeros(offset_dim))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Draws ``weights`` from ``generator`` and zeroes ``offset_bias``;
        the offset conv's weights are its own (``init_kpconv_weights_``
        reaches it)."""
        K, cin, _ = self.weights.shape
        limit = (1.0 / (K * cin)) ** 0.5
        with torch.no_grad():
            self.weights.uniform_(-limit, limit, generator=generator)
            if self.offset_conv is not None:
                self.offset_bias.zero_()

    def forward(self, q_pts, s_pts, neighb_idx, neighb_mask, x, q_mask=None, terms=None):
        kp = self.kernel_points
        K = kp.shape[0]
        neighbors = index_points(s_pts, neighb_idx) - q_pts[:, :, None, :]  # (B, Q, k, 3)
        n_sq = torch.sum(neighbors**2, dim=-1)
        modulations = None
        if self.offset_conv is None:
            cross = torch.einsum("bqkc,pc->bqkp", neighbors, kp)
            kp_sq = torch.sum(kp**2, dim=-1)
        else:
            offsets = self.offset_conv(q_pts, s_pts, neighb_idx, neighb_mask, x) + self.offset_bias
            B, Q = offsets.shape[:2]
            if self.modulated:
                modulations = 2.0 * torch.sigmoid(offsets[..., 3 * K:])  # (B, Q, K)
            kp = offsets[..., :3 * K].reshape(B, Q, K, 3) * self.kp_extent + kp  # per query
            cross = torch.einsum("bqkc,bqpc->bqkp", neighbors, kp)
            kp_sq = torch.sum(kp**2, dim=-1)[:, :, None, :]
        # |n − kp|² expanded, as the JAX op computes it (its rounding decides
        # the minimum and the in-range test); torch.maximum splits a tie's
        # gradient as jnp.maximum does
        zero = n_sq.new_zeros(())
        sq_d = torch.maximum(n_sq[..., None] - 2.0 * cross + kp_sq, zero)  # (B, Q, k, K)
        if self.offset_conv is not None and terms is not None:
            far = sq_d.new_tensor(1e12)
            min_d2 = torch.amin(torch.where(neighb_mask[..., None] > 0, sq_d, far), dim=2)
            if q_mask is not None:
                min_d2 = min_d2 * q_mask[..., None]
            terms.append((min_d2 / self.kp_extent**2, kp / self.kp_extent, q_mask))
        if self.influence == "constant":
            weights = torch.ones_like(sq_d)
        elif self.influence == "linear":
            dist = torch.sqrt(torch.maximum(sq_d, sq_d.new_tensor(1e-12)))
            weights = torch.maximum(1.0 - dist / self.kp_extent, zero)
        else:
            sigma = self.kp_extent * 0.3
            weights = torch.exp(-sq_d / (2.0 * sigma**2))
        if self.aggregation == "closest":
            weights = weights * Fn.one_hot(torch.argmin(sq_d, dim=-1), K).to(sq_d.dtype)
        weights = weights * neighb_mask[..., None]  # (B, Q, k, K); padded slots weigh nothing

        neighb_x = index_points(x, neighb_idx) * neighb_mask[..., None]  # (B, Q, k, Cin)
        weighted = torch.einsum("bqkp,bqkc->bqpc", weights, neighb_x)  # (B, Q, K, Cin)
        if modulations is not None:
            weighted = weighted * modulations[..., None]
        B, Q = weighted.shape[:2]
        out = weighted.reshape(B, Q, -1) @ self.weights.reshape(-1, self.weights.shape[-1])
        count = neighb_mask
        if self.offset_conv is not None:  # only the neighbours some moved kernel point reaches
            in_range = torch.any(sq_d < sq_d.new_tensor(self.kp_extent**2), dim=-1)
            count = count * in_range.to(count.dtype)
        n_valid = torch.clamp(torch.sum(count, dim=-1), min=1.0)
        return out / n_valid[..., None]


def instance_norm(x: torch.Tensor, mask: Optional[torch.Tensor],
                  epsilon: float = 1e-5) -> torch.Tensor:
    """The JAX ``InstanceNorm``: per cloud and channel, (x − mean) / sqrt(var + eps)
    over the valid rows of ``mask`` (B, N) (at least one counted), pad rows
    zeroed; over every row where ``mask`` is None, the variance the
    population's as ``jnp.var``'s. No parameters."""
    if mask is None:
        mean = torch.mean(x, dim=1, keepdim=True)
        var = torch.var(x, dim=1, keepdim=True, correction=0)
        return (x - mean) * torch.rsqrt(var + epsilon)
    m = mask[..., None]
    n = torch.clamp(torch.sum(m, dim=1, keepdim=True), min=1.0)
    mean = torch.sum(x * m, dim=1, keepdim=True) / n
    var = torch.sum((x - mean) ** 2 * m, dim=1, keepdim=True) / n
    return (x - mean) * torch.rsqrt(var + epsilon) * m


class UnaryBlock(nn.Module):
    """Dense (no bias) + ``instance_norm`` + leaky relu (slope 0.1) unless
    ``no_relu``; its Dense is the JAX ``Dense_0``."""

    def __init__(self, in_dim: int, out_dim: int, no_relu: bool = False):
        super().__init__()
        self.dense0 = Dense(in_dim, out_dim, bias=False)
        self.no_relu = no_relu

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        x = instance_norm(self.dense0(x), mask)
        return x if self.no_relu else Fn.leaky_relu(x, 0.1)


def _op(cfg: dict, in_dim: int, out_dim: int, radius: float, kp_extent: float,
        path: str, deformable: bool) -> KPConvOp:
    return KPConvOp(in_dim, out_dim, kp_extent, radius, cfg["num_kernel_points"],
                    cfg["KP_influence"], cfg["aggregation_mode"], cfg["fixed_kernel_points"],
                    kp_method=cfg.get("kp_method", "lloyd"),
                    kp_random_init=cfg.get("kp_random_init", False),
                    kp_seed=cfg.get("kp_seed", 0), path=path, deformable=deformable,
                    modulated=cfg["modulated"])


class SimpleBlock(nn.Module):
    """KPConv to ``out_dim // 2`` channels + ``instance_norm`` + leaky relu.
    ``terms`` as ``KPConvOp``'s."""

    def __init__(self, in_dim: int, out_dim: int, radius: float, kp_extent: float, cfg: dict,
                 path: str = "", deformable: bool = False):
        super().__init__()
        self.KPConv = _op(cfg, in_dim, out_dim // 2, radius, kp_extent, f"{path}/KPConv",
                          deformable)

    def forward(self, q_pts, s_pts, idx, mask, x, s_mask, q_mask, terms=None):
        x = self.KPConv(q_pts, s_pts, idx, mask, x, q_mask, terms)
        return Fn.leaky_relu(instance_norm(x, q_mask), 0.1)


class ResnetBottleneckBlock(nn.Module):
    """``unary1`` to ``out_dim // 4`` (absent where the input has that
    width) -> KPConv -> norm, leaky relu -> ``unary2`` to ``out_dim`` (no
    relu), plus the shortcut: the input, max-pooled over the stride
    neighbourhood where ``strided`` (padded slots count as 0), through
    ``unary_shortcut`` (no relu) where its width is not ``out_dim``; then
    leaky relu. ``terms`` as ``KPConvOp``'s."""

    def __init__(self, in_dim: int, out_dim: int, radius: float, kp_extent: float, cfg: dict,
                 strided: bool = False, path: str = "", deformable: bool = False):
        super().__init__()
        mid = out_dim // 4
        self.strided = strided
        self.unary1 = UnaryBlock(in_dim, mid) if in_dim != mid else None
        self.KPConv = _op(cfg, mid, mid, radius, kp_extent, f"{path}/KPConv", deformable)
        self.unary2 = UnaryBlock(mid, out_dim, no_relu=True)
        self.unary_shortcut = (UnaryBlock(in_dim, out_dim, no_relu=True)
                               if in_dim != out_dim else None)

    def forward(self, q_pts, s_pts, idx, mask, x, s_mask, q_mask, terms=None):
        h = self.unary1(x, s_mask) if self.unary1 is not None else x
        h = self.KPConv(q_pts, s_pts, idx, mask, h, q_mask, terms)
        h = Fn.leaky_relu(instance_norm(h, q_mask), 0.1)
        h = self.unary2(h, q_mask)
        shortcut = x
        if self.strided:
            shortcut = torch.amax(index_points(x, idx) * mask[..., None], dim=2)
        if self.unary_shortcut is not None:
            shortcut = self.unary_shortcut(shortcut, q_mask)
        return Fn.leaky_relu(h + shortcut, 0.1)


class KPConvEncoder(nn.Module):
    """The 14-block encoder: (B, N, 3) clouds and the FPS pyramid's starts
    (B,) or None -> (final features (B, N_4, ``out_dim``), the block-2 tap
    (B, N_1, ``tap_dim``), detached, the final level's valid mask, the tap
    level's (both None on the FPS pyramid), and the deformable ops'
    regularizer terms in module order, a list of ``KPConvOp``'s tuples);
    1024 and 64 wide at the default ``first_feats_dim`` 64. Its input
    features are ones (``in_feats_dim`` wide). A block whose name holds
    "deform" is deformable. ``path`` is the JAX module path of the encoder
    (the kernel points' seed under ``kp_random_init``)."""

    bf16_queued = BF16_QUEUED

    def __init__(self, cfg: dict, path: str = "encoder"):
        super().__init__()
        self.cfg = cfg
        r = cfg["first_subsampling_dl"] * cfg["conv_radius"]
        ext_ratio = cfg["KP_extent"] / cfg["conv_radius"]
        out_dim = cfg["first_feats_dim"]
        in_dim = cfg["in_feats_dim"]
        self.strided = []
        for i, block in enumerate(cfg["architecture"]):
            strided, deformable = "strided" in block, "deform" in block
            name = f"block{i}"
            if block.startswith("simple"):
                module = SimpleBlock(in_dim, out_dim, r, r * ext_ratio, cfg, f"{path}/{name}",
                                     deformable)
                in_dim = out_dim // 2
            elif block.startswith("resnetb"):
                module = ResnetBottleneckBlock(in_dim, out_dim, r, r * ext_ratio, cfg,
                                               strided=strided, path=f"{path}/{name}",
                                               deformable=deformable)
                in_dim = out_dim
            else:
                raise ValueError(f"Unknown block {block}")
            self.add_module(name, module)
            self.strided.append(strided)
            if strided:
                r *= 2.0
                out_dim *= 2
        self.out_dim = in_dim
        self.tap_dim = cfg["first_feats_dim"]  # block 2's width

    def forward(self, pc: torch.Tensor, fps_start: Optional[torch.Tensor] = None):
        pyr = build_pyramid(pc, self.cfg, fps_start)
        valid = pyr["valid"] or [None] * len(pyr["points"])
        x = pc.new_ones(pc.shape[:2] + (self.cfg["in_feats_dim"],))
        lvl = 0
        tap = tap_mask = None
        terms: List[tuple] = []
        for i, strided in enumerate(self.strided):
            if strided:
                q_pts, q_mask = pyr["points"][lvl + 1], valid[lvl + 1]
                idx, mask = pyr["pools"][lvl]
            else:
                q_pts, q_mask = pyr["points"][lvl], valid[lvl]
                idx, mask = pyr["neighbors"][lvl]
            x = getattr(self, f"block{i}")(q_pts, pyr["points"][lvl], idx, mask, x, valid[lvl],
                                           q_mask, terms)
            if i == 2:  # the node tap of the DG model
                tap, tap_mask = x.detach(), q_mask
            if strided:
                lvl += 1
        return x, tap, valid[lvl], tap_mask, terms


def p2p_fitting_regularizer(terms, deform_fitting_power: float = 1.0,
                            repulse_extent: float = 1.2) -> torch.Tensor:
    """The deformable ops' fitting and repulsive losses, the JAX package's
    ``p2p_fitting_regularizer`` over the ``terms`` an encoder collected,
    ``(min_d2 (B, Q, K), kp (B, Q, K, 3), q_mask (B, Q) or None)`` per op:
    ``power · (2 · fitting + repulsive)``. Fitting: per op the mean of
    |min_d2|, or its sum over the valid rows of ``q_mask`` over their count
    (at least 1) times K. Repulsive: per op and query, the pair distances
    of its kernel points to the detached others (clamped at 1e-12 before
    the root), clipped as ``min(d − repulse_extent, 0)²``, the diagonal
    zeroed and summed over both axes; their mean over the queries (the
    masked mean with ``q_mask``) over K. The trainers call it with the
    defaults, whatever ``MODEL_CFG.deform_fitting_power`` says."""
    fitting = repulsive = 0.0
    for min_d2, kp, q_mask in terms:
        K = kp.shape[-2]
        zero = kp.new_zeros(())
        abs_d2 = torch.where(min_d2 >= 0, min_d2, -min_d2)  # jnp.abs: gradient +1 at 0
        d2 = torch.sum((kp[..., :, None, :] - kp.detach()[..., None, :, :]) ** 2, dim=-1)
        d = torch.sqrt(torch.maximum(d2, kp.new_tensor(1e-12)))  # (B, Q, K, K)
        clipped = torch.minimum(d - repulse_extent, zero) ** 2
        eye = torch.eye(K, dtype=torch.bool, device=kp.device)
        row_sums = torch.sum(torch.where(eye, zero, clipped), dim=(-1, -2))  # (B, Q)
        if q_mask is None:
            fitting = fitting + torch.mean(abs_d2)
            repulsive = repulsive + torch.mean(row_sums) / K
        else:
            n = torch.clamp(torch.sum(q_mask), min=1.0)
            fitting = fitting + torch.sum(abs_d2) / (n * K)
            repulsive = repulsive + torch.sum(row_sums * q_mask) / n / K
    return deform_fitting_power * (2.0 * fitting + repulsive)


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The mean of ``x`` (B, N, C) over the valid rows of ``mask`` (B, N),
    over every row where it is None."""
    if mask is None:
        return torch.mean(x, dim=1)
    m = mask[..., None]
    return torch.sum(x * m, dim=1) / torch.clamp(torch.sum(m, dim=1), min=1.0)


def _sample_tensor_slices(tap: torch.Tensor, mask: Optional[torch.Tensor],
                          n_out: int) -> torch.Tensor:
    """``n_out`` rows of each cloud's valid rows (which come first), strided
    over their count, or the first ones repeated from the last where fewer
    than ``n_out`` are valid. Where ``mask`` is None (the FPS pyramid),
    every ``max(N // n_out, 1)``-th row from the first, at most ``n_out``
    of them, as the JAX package slices: fewer where N < ``n_out``, and not
    the masked form's stride ``i · N // n_out``."""
    if mask is None:
        return tap[:, ::max(tap.shape[1] // n_out, 1)][:, :n_out]
    cnt = torch.sum(mask.long(), dim=1)
    i = torch.arange(n_out, device=tap.device)
    strided = (i[None, :] * cnt[:, None]) // n_out
    head = torch.minimum(i[None, :], torch.clamp(cnt[:, None] - 1, min=0))
    return _take(tap, torch.where(cnt[:, None] >= n_out, strided, head))


def init_kpconv_weights_(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Every ``KPConvOp``'s weights in ``module``, in module order, as
    ``KPConvOp.reset_parameters`` draws them from ``generator`` (CPU; None:
    torch's global one)."""
    for m in module.modules():
        if isinstance(m, KPConvOp):
            m.reset_parameters(generator)


class KPConvGenerator(nn.Module):
    """The DG generator: (B, N, 3) -> (global_feat (B, 1024), the (masked)
    mean of the final level; node_fea (B, ``node_rows(N)``, 64), strided
    valid rows of the block-2 tap; None). ``fps_start`` (B,) starts the FPS
    pyramid's first FPS (the grid pyramid samples no points). Where given a
    list ``terms``, the deformable ops' regularizer terms are appended to
    it. ``model_cfg`` is MODEL_CFG (None: the defaults)."""

    def __init__(self, model_cfg=None, path: str = "g"):
        super().__init__()
        self.encoder = KPConvEncoder(kpconv_config(model_cfg), f"{path}/encoder")

    def node_rows(self, num_points: int) -> int:
        """node_fea's rows for clouds of ``num_points``: 64, but on the FPS
        pyramid the tap level's ``max(N // 4, 4)`` rows where fewer."""
        if self.encoder.cfg["pyramid"] == "grid":
            return 64
        return min(64, max(num_points // LEVEL_FRACTIONS[1], 4))

    def forward(self, pc: torch.Tensor, fps_start: Optional[torch.Tensor] = None,
                terms: Optional[list] = None):
        feats, tap, final_mask, tap_mask, own = self.encoder(pc, fps_start)
        if terms is not None:
            terms.extend(own)
        return _masked_mean(feats, final_mask), _sample_tensor_slices(tap, tap_mask, 64), None


class KPConvClassifier(nn.Module):
    """The standalone classifier: the encoder, the masked mean, then
    ``fc1`` 256 (the mid feature, before its relu) -> ``fc2`` 64, relu ->
    ``fc3`` to ``num_class``. ``forward(pc, generator=None)`` returns
    (logits, mid_feature); it has no dropout. On the FPS pyramid its first
    FPS starts at index 0, and a deformable op's regularizer terms are not
    collected (the JAX trainers build their classifiers without MODEL_CFG).
    The constructor's ``generator`` (CPU) draws the initial weights."""

    def __init__(self, num_class: int = 10, model_cfg=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = KPConvEncoder(kpconv_config(model_cfg), "encoder")
        self.fc1 = Dense(self.encoder.out_dim, 256)
        self.fc2 = Dense(256, 64)
        self.fc3 = Dense(64, num_class)
        flax_init_(self, generator)
        init_kpconv_weights_(self, generator)

    def forward(self, pc: torch.Tensor, generator: Optional[torch.Generator] = None):
        feats, _, final_mask, _, _ = self.encoder(pc)
        mid_feature = self.fc1(_masked_mean(feats, final_mask))
        x = torch.relu(self.fc2(torch.relu(mid_feature)))
        return self.fc3(x), mid_feature
