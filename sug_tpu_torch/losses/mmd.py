"""MSA/SDA alignment losses: counterpart of ``sug_tpu/losses/mmd.py`` for
what the DG step runs: the multi-kernel Gaussian MMD, the soft
(class-aware) MMD and the SDA sample weights, geometric (chamfer) and
semantic (KL), with the ``mmd_cal`` dispatch for ``SOFT_MMD`` and ``OFF``.

Two quirks of the reference are kept, as the JAX package keeps them:
``distance2weights(method="mean2one")`` truncates ``1/mean`` to an integer
before scaling, and ``prob_weights_soft`` normalises by the sum over the
whole batch tensor, not per row. HARD_MMD, MAX_HARD_MMD, CL and the
variance-ratio, linear and polynomial MMDs come with a later slice
(ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as Fn

from sug_tpu_torch.ops.geometry import chamfer_distance

MIN_VAR_EST = 1e-8
SIGMA_LIST = (0.01, 0.1, 1.0, 10.0, 100.0)
PORTED_MMD = ("SOFT_MMD", "OFF")


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


def soft_mmd(label_s, feat_s, label_t, feat_t, label_weight: float,
             sample_weights=None, num_class: int = 10) -> torch.Tensor:
    """Class-aware MMD: scaled one-hot labels concatenated onto the features."""
    fs = torch.cat([feat_s, one_hot_labels(label_s, num_class) * label_weight], 1)
    ft = torch.cat([feat_t, one_hot_labels(label_t, num_class) * label_weight], 1)
    return mix_rbf_mmd2(fs, ft, SIGMA_LIST, sample_weights=sample_weights)


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
    SEM_WEIGHTS) or ``OFF`` (plain MMD)."""
    name = cfg["NAME"]
    if name not in PORTED_MMD:
        raise NotImplementedError(
            f"MMD {name!r} is not ported yet (ported: {PORTED_MMD}); it is queued in ROADMAP.md"
        )
    sample_weights = None
    if data_s is not None and (cfg.get("GEO_WEIGHTS") or cfg.get("SEM_WEIGHTS")):
        sample_weights = cal_sample_weights(data_s, data_t, cfg, label_s=label_s, label_t=label_t)
    if name == "SOFT_MMD":
        return soft_mmd(label_s, feat_s, label_t, feat_t, float(cfg["LABEL_SCALE"]),
                        sample_weights=sample_weights, num_class=num_class)
    return mix_rbf_mmd2(feat_s, feat_t, SIGMA_LIST)
