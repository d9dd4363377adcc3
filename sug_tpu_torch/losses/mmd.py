"""MSA/SDA alignment losses: counterpart of ``sug_tpu/losses/mmd.py``: the
multi-kernel Gaussian MMD with its variance-ratio form, the linear and
polynomial linear-time MMDs, the class-conditioned soft, hard and max-hard
MMDs, the cosine contrastive alignment (``CL``), and the SDA sample
weights, geometric (chamfer) and semantic (KL), with the ``mmd_cal``
dispatch.

The hard and max-hard MMDs select their rows with {0, 1} masks and a
match-count normaliser, as the JAX package does, in place of the
reference's gathers: MMD is a set statistic, so the two agree.

Dtypes follow the JAX package under the bf16 policy, where the heads' mid
features are bf16: ``soft_mmd`` concatenates them with the f32 one-hot
labels, so its Gram is f32; ``hard_mmd``, the plain MMD (``OFF``) and the
contrastive loss compute in bf16; ``max_hard_mmd`` forms its kernel blocks
in bf16 and sums them under its f32 masks in f32 (ROADMAP.md §3 records
the bf16 ones as a fault of the JAX package against its own policy).

Two quirks of the reference are kept, as the JAX package keeps them:
``distance2weights(method="mean2one")`` truncates ``1/mean`` to an integer
before scaling, and ``prob_weights_soft`` normalises by the sum over the
whole batch tensor, not per row.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as Fn

from sug_tpu_torch.ops.geometry import chamfer_distance

MIN_VAR_EST = 1e-8
SIGMA_LIST = (0.01, 0.1, 1.0, 10.0, 100.0)
# every alignment the DG trainer takes as GEO_MMD/SEM_MMD NAME; CL is
# dispatched by the trainer, the rest by mmd_cal
PORTED_MMD = ("SOFT_MMD", "HARD_MMD", "MAX_HARD_MMD", "OFF", "CL")


def one_hot_labels(labels: torch.Tensor, num_class: int = 10) -> torch.Tensor:
    return Fn.one_hot(labels.long(), num_class).float()


def _mix_rbf_kernel(X: torch.Tensor, Y: torch.Tensor, sigma_list: Sequence[float]):
    """(K_XX, K_XY, K_YY) of the summed RBF kernels, from the
    ``diag − 2·ZZᵀ + diagᵀ`` exponent of the Gram matrix of ``[X; Y]``."""
    m = X.shape[0]
    Z = torch.cat([X, Y], dim=0)
    ZZT = Z @ Z.t()
    diag = torch.diagonal(ZZT)[:, None]
    exponent = diag - 2.0 * ZZT + diag.t()
    K = torch.zeros_like(ZZT)
    for sigma in sigma_list:
        K = K + torch.exp(-(1.0 / (2.0 * sigma**2)) * exponent)
    return K[:m, :m], K[:m, m:], K[m:, m:]


def _mmd2(K_XX, K_XY, K_YY, biased: bool = True,
          sample_weights: Optional[torch.Tensor] = None,
          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Biased or unbiased MMD² from the kernel blocks; ``sample_weights``
    (m,) scale the K_XY column sums (SDA), ``mask`` (m,) of {0, 1} selects
    a subset."""
    m_full = K_XX.shape[0]
    if mask is None:
        w = torch.ones(m_full, dtype=K_XX.dtype, device=K_XX.device)
        m = torch.tensor(float(m_full), dtype=K_XX.dtype, device=K_XX.device)
    else:
        w = mask.to(K_XX.dtype)
        m = torch.clamp(torch.sum(w), min=1.0)
    sum_diag_X = torch.sum(torch.diagonal(K_XX) * w)
    sum_diag_Y = torch.sum(torch.diagonal(K_YY) * w)
    Kt_XX_sum = w @ K_XX @ w - sum_diag_X
    Kt_YY_sum = w @ K_YY @ w - sum_diag_Y
    K_XY_sums_0 = w @ K_XY
    if sample_weights is not None:
        K_XY_sums_0 = sample_weights.reshape(-1) * K_XY_sums_0
    K_XY_sum = torch.sum(K_XY_sums_0 * w)
    if biased:
        return ((Kt_XX_sum + sum_diag_X) / (m * m) + (Kt_YY_sum + sum_diag_Y) / (m * m)
                - 2.0 * K_XY_sum / (m * m))
    return (Kt_XX_sum / (m * (m - 1.0)) + Kt_YY_sum / (m * (m - 1.0))
            - 2.0 * K_XY_sum / (m * m))


def mix_rbf_mmd2(X, Y, sigma_list: Sequence[float] = SIGMA_LIST, biased: bool = True,
                 sample_weights=None, mask=None) -> torch.Tensor:
    """Multi-kernel Gaussian MMD²."""
    K_XX, K_XY, K_YY = _mix_rbf_kernel(X, Y, sigma_list)
    return _mmd2(K_XX, K_XY, K_YY, biased=biased, sample_weights=sample_weights, mask=mask)


def _mmd2_and_variance(K_XX, K_XY, K_YY, biased: bool = False):
    """MMD² and its variance estimate (unmasked, unweighted)."""
    m = float(K_XX.shape[0])
    diag_X, diag_Y = torch.diagonal(K_XX), torch.diagonal(K_YY)
    sum_diag_X, sum_diag_Y = torch.sum(diag_X), torch.sum(diag_Y)
    sum_diag2_X, sum_diag2_Y = diag_X @ diag_X, diag_Y @ diag_Y

    Kt_XX_sums = torch.sum(K_XX, dim=1) - diag_X
    Kt_YY_sums = torch.sum(K_YY, dim=1) - diag_Y
    K_XY_sums_0 = torch.sum(K_XY, dim=0)
    K_XY_sums_1 = torch.sum(K_XY, dim=1)

    Kt_XX_sum, Kt_YY_sum = torch.sum(Kt_XX_sums), torch.sum(Kt_YY_sums)
    K_XY_sum = torch.sum(K_XY_sums_0)

    Kt_XX_2_sum = torch.sum(K_XX**2) - sum_diag2_X
    Kt_YY_2_sum = torch.sum(K_YY**2) - sum_diag2_Y
    K_XY_2_sum = torch.sum(K_XY**2)

    if biased:
        mmd2 = ((Kt_XX_sum + sum_diag_X) / (m * m) + (Kt_YY_sum + sum_diag_Y) / (m * m)
                - 2.0 * K_XY_sum / (m * m))
    else:
        mmd2 = (Kt_XX_sum / (m * (m - 1)) + Kt_YY_sum / (m * (m - 1))
                - 2.0 * K_XY_sum / (m * m))

    var_est = (
        2.0 / (m**2 * (m - 1.0) ** 2)
        * (2 * Kt_XX_sums @ Kt_XX_sums - Kt_XX_2_sum + 2 * Kt_YY_sums @ Kt_YY_sums - Kt_YY_2_sum)
        - (4.0 * m - 6.0) / (m**3 * (m - 1.0) ** 3) * (Kt_XX_sum**2 + Kt_YY_sum**2)
        + 4.0 * (m - 2.0) / (m**3 * (m - 1.0) ** 2)
        * (K_XY_sums_1 @ K_XY_sums_1 + K_XY_sums_0 @ K_XY_sums_0)
        - 4.0 * (m - 3.0) / (m**3 * (m - 1.0) ** 2) * K_XY_2_sum
        - (8 * m - 12) / (m**5 * (m - 1)) * K_XY_sum**2
        + 8.0 / (m**3 * (m - 1.0))
        * (1.0 / m * (Kt_XX_sum + Kt_YY_sum) * K_XY_sum
           - Kt_XX_sums @ K_XY_sums_1 - Kt_YY_sums @ K_XY_sums_0)
    )
    return mmd2, var_est


def mix_rbf_mmd2_and_ratio(X, Y, sigma_list: Sequence[float] = SIGMA_LIST, biased: bool = True):
    """(MMD² over the square root of its variance estimate, MMD², variance)."""
    mmd2, var_est = _mmd2_and_variance(*_mix_rbf_kernel(X, Y, sigma_list), biased=biased)
    return mmd2 / torch.sqrt(torch.clamp(var_est, min=MIN_VAR_EST)), mmd2, var_est


def linear_mmd2(f_of_X: torch.Tensor, f_of_Y: torch.Tensor) -> torch.Tensor:
    """Linear-time MMD with a linear kernel over consecutive pairs."""
    delta = f_of_X - f_of_Y
    return torch.mean(torch.sum(delta[:-1] * delta[1:], dim=1))


def poly_mmd2(f_of_X, f_of_Y, d: int = 2, alpha: float = 1.0, c: float = 2.0) -> torch.Tensor:
    """Linear-time MMD with the polynomial kernel ``(alpha·<x, y> + c)^d``."""
    K_XX = alpha * torch.sum(f_of_X[:-1] * f_of_X[1:], dim=1) + c
    K_YY = alpha * torch.sum(f_of_Y[:-1] * f_of_Y[1:], dim=1) + c
    K_XY = alpha * torch.sum(f_of_X[:-1] * f_of_Y[1:], dim=1) + c
    K_YX = alpha * torch.sum(f_of_Y[:-1] * f_of_X[1:], dim=1) + c
    return torch.mean(K_XX**d) + torch.mean(K_YY**d) - torch.mean(K_XY**d) - torch.mean(K_YX**d)


def soft_mmd(label_s, feat_s, label_t, feat_t, label_weight: float,
             sample_weights=None, num_class: int = 10) -> torch.Tensor:
    """Class-aware MMD: scaled one-hot labels concatenated onto the features."""
    fs = torch.cat([feat_s, one_hot_labels(label_s, num_class) * label_weight], 1)
    ft = torch.cat([feat_t, one_hot_labels(label_t, num_class) * label_weight], 1)
    return mix_rbf_mmd2(fs, ft, SIGMA_LIST, sample_weights=sample_weights)


def hard_mmd(label_s, feat_s, label_t, feat_t) -> torch.Tensor:
    """MMD over the batch positions whose source and target labels match."""
    mask = (label_s == label_t).to(feat_s.dtype)
    return mix_rbf_mmd2(feat_s, feat_t, SIGMA_LIST, mask=mask)


def _class_overlap_masks(label_s, label_t, num_class: int = 10):
    """Per-side {0, 1} masks that select, for each class c, the first
    min(n_s(c), n_t(c)) samples of that class by batch position: the two
    selections hold the same class multiset."""
    onehot_s = Fn.one_hot(label_s.long(), num_class)
    onehot_t = Fn.one_hot(label_t.long(), num_class)
    quota = torch.minimum(torch.sum(onehot_s, dim=0), torch.sum(onehot_t, dim=0))

    def side_mask(onehot, labels):
        rank = torch.sum((torch.cumsum(onehot, dim=0) - onehot) * onehot, dim=1)  # within the class
        return (rank < quota[labels.long()]).to(torch.float32)

    return side_mask(onehot_s, label_s), side_mask(onehot_t, label_t)


def max_hard_mmd(label_s, feat_s, label_t, feat_t, num_class: int = 10) -> torch.Tensor:
    """MMD between the greatest class-matched subsets of the two batches
    (``_class_overlap_masks``), normalised by their common size."""
    K_XX, K_XY, K_YY = _mix_rbf_kernel(feat_s, feat_t, SIGMA_LIST)
    # the masks are f32, as in the JAX package: bf16 kernel blocks promote to f32
    dtype = torch.promote_types(K_XX.dtype, torch.float32)
    mask_s, mask_t, K_XX, K_XY, K_YY = (t.to(dtype) for t in (
        *_class_overlap_masks(label_s, label_t, num_class), K_XX, K_XY, K_YY))
    m = torch.clamp(torch.sum(mask_s), min=1.0)
    diag_X = torch.diagonal(K_XX) * mask_s
    diag_Y = torch.diagonal(K_YY) * mask_t
    Kt_XX_sum = mask_s @ K_XX @ mask_s - torch.sum(diag_X)
    Kt_YY_sum = mask_t @ K_YY @ mask_t - torch.sum(diag_Y)
    K_XY_sum = mask_s @ K_XY @ mask_t
    return ((Kt_XX_sum + torch.sum(diag_X)) / (m * m) + (Kt_YY_sum + torch.sum(diag_Y)) / (m * m)
            - 2.0 * K_XY_sum / (m * m))


def contrastive_loss_weighted(label_s, feat_s, label_t, feat_t, margin: float = 0.2,
                              sample_weights=None) -> torch.Tensor:
    """Cosine-embedding contrastive alignment of paired rows: ``1 − cos``
    where the labels match, ``max(0, cos − margin)`` where they do not."""
    cos = torch.sum(feat_s * feat_t, dim=1) / (
        torch.linalg.vector_norm(feat_s, dim=1) * torch.linalg.vector_norm(feat_t, dim=1) + 1e-8)
    loss = torch.where(label_s == label_t, 1.0 - cos, torch.clamp(cos - margin, min=0.0))
    if sample_weights is not None:
        loss = sample_weights.reshape(-1) * loss
    return torch.mean(loss)


def distance2weights(distances: torch.Tensor, method: str = "naive_inverse") -> torch.Tensor:
    """Per-pair distances (B,) -> MMD cross-term weights (B,)."""
    d = distances.reshape(-1)
    if method == "naive_inverse":
        inv = 1.0 / (d + MIN_VAR_EST)
        return inv / torch.sum(inv)
    if method == "exp_inverse":
        e = torch.exp(-d)
        return e / torch.sum(e)
    if method == "hist":
        # 10 linear bins over [min, max]: weight 1.0 for the lowest bin down
        # to 0.1 for the highest
        lo, hi = torch.amin(d), torch.amax(d)
        edges = lo + (hi - lo) * torch.arange(1, 10, device=d.device, dtype=d.dtype) / 10.0
        bin_idx = torch.sum(d[:, None] >= edges[None, :], dim=1)
        return 1.0 - 0.1 * bin_idx.to(torch.float32)
    if method == "none":
        return d
    if method == "mean2one":
        # the reference's integer truncation of 1/mean, kept: a mean
        # distance above 1 zeroes every weight
        return d * torch.trunc(1.0 / torch.mean(d))
    raise ValueError(f"Unknown weighting method {method}")


def geometric_weights(pc_s: torch.Tensor, pc_t: torch.Tensor,
                      weighting: str = "mean2one") -> torch.Tensor:
    """SDA geometric weights from the per-pair chamfer distance of the raw
    (B, N, 3) clouds."""
    return distance2weights(chamfer_distance(pc_s, pc_t, per_sample=True), weighting)


def kl_div_elementwise(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """scipy.special.kl_div: ``x·log(x/y) − x + y``, elementwise."""
    return x * (torch.log(x) - torch.log(y)) - x + y


def sym_kl_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return 0.5 * kl_div_elementwise(x, y) + 0.5 * kl_div_elementwise(y, x)


def prob_weights_soft(pred_s, pred_t, label_s, label_t, label_weight: float,
                      weighting: str = "mean2one", num_class: int = 10) -> torch.Tensor:
    """SDA semantic weights: sym-KL between (softmax ++ scaled one-hot) rows
    of the detached logits."""
    ps = torch.softmax(pred_s.detach(), dim=1)
    pt = torch.softmax(pred_t.detach(), dim=1)
    ps = torch.cat([ps, one_hot_labels(label_s, num_class) * label_weight], 1)
    pt = torch.cat([pt, one_hot_labels(label_t, num_class) * label_weight], 1)
    # the reference's normalisation over the whole tensor, kept
    ps = (ps + MIN_VAR_EST) / torch.sum(ps + MIN_VAR_EST)
    pt = (pt + MIN_VAR_EST) / torch.sum(pt + MIN_VAR_EST)
    return distance2weights(torch.sum(sym_kl_distance(ps, pt), dim=1), weighting)


def probs_to_entropy(probs: torch.Tensor) -> torch.Tensor:
    return -torch.sum(probs * torch.log(probs + 1e-30), dim=1)


def entropy_weights(pred_s, pred_t, weighting: str = "exp_inverse") -> torch.Tensor:
    """SDA weights from the sym-KL of the per-row entropies."""
    dist = sym_kl_distance(probs_to_entropy(pred_s), probs_to_entropy(pred_t))
    return distance2weights(dist, weighting)


def cal_sample_weights(data_s, data_t, cfg: dict, label_s=None, label_t=None) -> torch.Tensor:
    if cfg.get("GEO_WEIGHTS"):
        return geometric_weights(data_s, data_t, weighting=cfg["GEO_WEIGHTS"])
    if cfg.get("ENTROPY_WEIGHTS"):
        return entropy_weights(data_s, data_t, weighting=cfg["ENTROPY_WEIGHTS"])
    if cfg.get("SEM_WEIGHTS"):
        return prob_weights_soft(data_s, data_t, label_s, label_t,
                                 cfg["LABEL_WEIGHT"], cfg["SEM_WEIGHTS"])
    raise ValueError("Not supported weighting operation")


def mmd_cal(label_s, feat_s, label_t, feat_t, cfg: dict, data_s=None, data_t=None,
            num_class: int = 10) -> torch.Tensor:
    """MMD dispatch on ``cfg["NAME"]``: ``SOFT_MMD`` (with SDA weights from
    ``data_s``/``data_t``: raw clouds for GEO_WEIGHTS, logits for
    SEM_WEIGHTS), ``HARD_MMD``, ``MAX_HARD_MMD`` or ``OFF`` (plain MMD);
    another name raises ``ValueError``. Only SOFT_MMD reads the weights, so
    the others do not compute them."""
    name = cfg["NAME"]
    if name == "SOFT_MMD":
        sample_weights = None
        if data_s is not None and (cfg.get("GEO_WEIGHTS") or cfg.get("SEM_WEIGHTS")):
            sample_weights = cal_sample_weights(data_s, data_t, cfg, label_s=label_s,
                                                label_t=label_t)
        return soft_mmd(label_s, feat_s, label_t, feat_t, float(cfg["LABEL_SCALE"]),
                        sample_weights=sample_weights, num_class=num_class)
    if name == "HARD_MMD":
        return hard_mmd(label_s, feat_s, label_t, feat_t)
    if name == "MAX_HARD_MMD":
        return max_hard_mmd(label_s, feat_s, label_t, feat_t, num_class)
    if name == "OFF":
        return mix_rbf_mmd2(feat_s, feat_t, SIGMA_LIST)
    raise ValueError(f"Not supported MMD method {name}")
