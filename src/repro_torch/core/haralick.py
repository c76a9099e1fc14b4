"""The fourteen Haralick texture features (Haralick, Shanmugam & Dinstein
1973, paper ref [2]) computed from GLCMs, in PyTorch.

Counterpart of ``repro.core.haralick``: the same formulas, guards and
feature order, written over an explicit batch of matrices instead of vmap.

The features are computed in float64 and returned as float32. Several are
differences of nearly equal sums (f3, f12, f13); in float32 their value
would depend on the summation order, which differs between the CPU, the
card and the reference. In float64 they are the same on every device to
well below float32 rounding.

f1  Angular Second Moment (Energy)     f8  Sum Entropy
f2  Contrast                           f9  Entropy
f3  Correlation                        f10 Difference Variance
f4  Sum of Squares: Variance           f11 Difference Entropy
f5  Inverse Difference Moment          f12 Information Measure of Corr. 1
f6  Sum Average                        f13 Information Measure of Corr. 2
f7  Sum Variance                       f14 Max. Correlation Coefficient
"""

from __future__ import annotations

import torch

from repro_torch.kernels import mcc_kernel as _mcc
from repro_torch.obs import trace as _obs_trace

__all__ = ["haralick_features", "FEATURE_NAMES", "normalize_glcm"]

FEATURE_NAMES = (
    "asm_energy",
    "contrast",
    "correlation",
    "variance",
    "inverse_difference_moment",
    "sum_average",
    "sum_variance",
    "sum_entropy",
    "entropy",
    "difference_variance",
    "difference_entropy",
    "info_correlation_1",
    "info_correlation_2",
    "max_correlation_coefficient",
)

_EPS = 1e-12


def normalize_glcm(glcm: torch.Tensor) -> torch.Tensor:
    """Counts → joint probabilities (sum to 1)."""
    return glcm / glcm.sum(dim=(-2, -1), keepdim=True).clamp_min(_EPS)


def _entropy(p: torch.Tensor, dim) -> torch.Tensor:
    return -torch.sum(p * torch.log(p + _EPS), dim=dim)


def _select_indices(select: tuple[str, ...] | None) -> tuple[int, ...]:
    if select is None:
        return tuple(range(len(FEATURE_NAMES)))
    idx = []
    for name in select:
        if name not in FEATURE_NAMES:
            raise ValueError(
                f"unknown Haralick feature {name!r}; expected names from "
                f"{FEATURE_NAMES}"
            )
        idx.append(FEATURE_NAMES.index(name))
    if not idx:
        raise ValueError("select=() names no features")
    return tuple(idx)


def _features(p: torch.Tensor, select: tuple[int, ...]) -> torch.Tensor:
    """(N, L, L) normalized float64 GLCMs → (N, len(select)) features.

    f1–f13 are O(L²); f14's O(L³) eigensolve runs only when index 13 is
    selected.
    """
    n, L = p.shape[0], p.shape[-1]
    i = torch.arange(L, dtype=p.dtype, device=p.device)
    ii, jj = i[:, None], i[None, :]
    both = (-2, -1)

    px = p.sum(dim=2)  # (N, L) marginal over j
    py = p.sum(dim=1)  # (N, L) marginal over i
    mu_x = (i * px).sum(dim=1)
    mu_y = (i * py).sum(dim=1)
    sd_x = torch.sqrt(((i - mu_x[:, None]) ** 2 * px).sum(dim=1).clamp_min(0.0))
    sd_y = torch.sqrt(((i - mu_y[:, None]) ** 2 * py).sum(dim=1).clamp_min(0.0))

    # p_{x+y}(k), k = 0..2L-2  and  p_{x-y}(k), k = 0..L-1
    ii_i = torch.arange(L, device=p.device)
    sum_idx = (ii_i[:, None] + ii_i[None, :]).reshape(-1)
    diff_idx = (ii_i[:, None] - ii_i[None, :]).abs().reshape(-1)
    flat = p.reshape(n, -1)
    p_sum = torch.zeros(n, 2 * L - 1, dtype=p.dtype, device=p.device)
    p_sum.index_add_(1, sum_idx, flat)
    p_diff = torch.zeros(n, L, dtype=p.dtype, device=p.device)
    p_diff.index_add_(1, diff_idx, flat)

    f1 = (p**2).sum(dim=both)
    f2 = ((ii - jj) ** 2 * p).sum(dim=both)
    f3 = ((ii * jj * p).sum(dim=both) - mu_x * mu_y) / (sd_x * sd_y).clamp_min(_EPS)
    # A marginal that sits on one level has no variance, and f3 is 0/0: its
    # numerator is then cancellation noise (~1e-14) over the 1e-12 guard, a
    # value of up to ~0.1 that depends on the order of summation (CPU and
    # card disagree). The pairwise variance ½·Σ_ik (i-k)² p_i p_k is exactly
    # 0 for such a marginal (every term holds a zero factor), so those
    # matrices get f3 = 0 — the value of the exact numerator over the guard.
    d2 = (ii - jj) ** 2
    spread_x = ((px @ d2) * px).sum(dim=1) > 0
    spread_y = ((py @ d2) * py).sum(dim=1) > 0
    f3 = torch.where(spread_x & spread_y, f3, torch.zeros_like(f3))
    mu = (p * ii).sum(dim=both)  # Haralick's μ in f4 (mean of joint over i)
    f4 = ((ii - mu[:, None, None]) ** 2 * p).sum(dim=both)
    f5 = (p / (1.0 + (ii - jj) ** 2)).sum(dim=both)
    ks = torch.arange(2 * L - 1, dtype=p.dtype, device=p.device)
    f6 = (ks * p_sum).sum(dim=1)
    f8 = _entropy(p_sum, 1)
    f7 = ((ks - f6[:, None]) ** 2 * p_sum).sum(dim=1)
    f9 = _entropy(p, both)
    diff_mean = (i * p_diff).sum(dim=1)
    f10 = ((i - diff_mean[:, None]) ** 2 * p_diff).sum(dim=1)
    f11 = _entropy(p_diff, 1)

    # Information measures of correlation.
    hx = _entropy(px, 1)
    hy = _entropy(py, 1)
    hxy = f9
    pxy_outer = px[:, :, None] * py[:, None, :]
    hxy1 = -(p * torch.log(pxy_outer + _EPS)).sum(dim=both)
    hxy2 = -(pxy_outer * torch.log(pxy_outer + _EPS)).sum(dim=both)
    f12 = (hxy - hxy1) / torch.maximum(hx, hy).clamp_min(_EPS)
    f13 = torch.sqrt((1.0 - torch.exp(-2.0 * (hxy2 - hxy))).clamp_min(0.0))

    feats = [f1, f2, f3, f4, f5, f6, f7, f8, f9, f10, f11, f12, f13]

    if 13 in select:
        # f14: sqrt of the second-largest eigenvalue of Q, whose spectrum
        # equals that of the symmetric PSD matrix A Aᵀ, A = P/√(px py).
        # Up to L = 1024 a kernel solves it on the card (the CPU runs the
        # plain version); wider matrices take the plain version, eigvalsh
        # in chunks, on either device (``chunks`` eigvalsh calls). On the
        # card each reads its error code back, so there the span is also the
        # host's wait for the work queued before it; the kernel's launch
        # waits for nothing.
        kernel = L <= _mcc.MAX_LEVELS
        on_card = kernel and p.device.type == "cuda"
        chunks = 0 if on_card else _mcc.eigvalsh_chunks(n, L)
        with _obs_trace.get_tracer().span("haralick.eigvalsh", matrices=n,
                                          solver="kernel" if on_card else "eigvalsh",
                                          chunks=chunks):
            if kernel:
                second = _mcc.second_eigenvalue(p.contiguous(), px, py)
            else:
                second = _mcc.second_eigenvalue_plain(p, px, py)
        feats.append(torch.sqrt(second.clamp_min(0.0)))

    return torch.stack([feats[k] for k in select], dim=-1)


def haralick_features(
    glcm: torch.Tensor,
    *,
    assume_normalized: bool = False,
    select: tuple[str, ...] | None = None,
) -> torch.Tensor:
    """GLCM(s) → Haralick features, float32.

    Accepts (..., L, L); returns (..., n_feats). Raw counts are normalized
    unless ``assume_normalized``. ``select`` names a subset of
    :data:`FEATURE_NAMES` — output columns follow its order, and the O(L³)
    ``max_correlation_coefficient`` is skipped when not selected. The
    default ``None`` computes all 14 in canonical order.
    """
    idx = _select_indices(select)
    p = glcm.to(torch.float64)
    if not assume_normalized:
        p = normalize_glcm(p)
    flat = p.reshape((-1,) + tuple(p.shape[-2:]))
    feats = _features(flat, idx)
    return feats.reshape(tuple(p.shape[:-2]) + (len(idx),)).to(torch.float32)
