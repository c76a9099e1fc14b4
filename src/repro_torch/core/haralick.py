"""The fourteen Haralick texture features (Haralick, Shanmugam & Dinstein
1973, paper ref [2]) computed from GLCMs, in PyTorch.

Counterpart of ``repro.core.haralick``: the same formulas, guards and
feature order, written over an explicit batch of matrices instead of vmap.

The features are computed in float64 and returned as float32. Several are
differences of nearly equal sums (f3, f12, f13); in float32 their value
would depend on the summation order, which differs between the CPU, the
card and the reference. In float64 they are the same on every device to
well below float32 rounding.

Routes. ``haralick_features`` computes f1–f13 of float GLCMs with the
plain PyTorch formulas (``tail_kernel.f1_to_f13``, beside the kernel they
define). int32 counts, which plans hand it, take the tail instead, and
``tail_kernel.route`` says where it runs: on the card, within the kernel's
range of L, one ``haralick_tail`` launch computes f1–f13 from the counts
and writes the P and marginals f14 reads; on the CPU, and wider, the
kernel's plain version does. f14 (``_f14``) takes the route's solver:
the eigensolver kernel of ``mcc_kernel`` on the card, chunked eigvalsh
elsewhere.

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

from repro_torch.kernels import tail_kernel as _tail
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


def _f14(p: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """(N,) f14 of (N, L, L) normalized float64 GLCMs and their marginals.

    f14 is the sqrt of the second-largest eigenvalue of Q, whose spectrum
    equals that of the symmetric PSD matrix A Aᵀ, A = P/√(px py). The
    route's solver is a kernel on the card within its range of L, else
    eigvalsh in chunks (``chunks`` eigvalsh calls). On the card each reads
    its error code back, so there the span is also the host's wait for the
    work queued before it; the kernel's launch waits for nothing.
    """
    n = p.shape[0]
    route = _tail.route(p.device.type, p.shape[-1])
    with _obs_trace.get_tracer().span("haralick.eigvalsh", matrices=n, solver=route.solver,
                                      chunks=route.chunks(n)):
        second = route.f14_fn(p.contiguous(), px, py)
    return torch.sqrt(second.clamp_min(0.0))


def haralick_features(
    glcm: torch.Tensor,
    *,
    assume_normalized: bool = False,
    select: tuple[str, ...] | None = None,
    float32_step: bool = False,
) -> torch.Tensor:
    """GLCM(s) → Haralick features, float32.

    Accepts (..., L, L); returns (..., n_feats). Raw counts are normalized
    unless ``assume_normalized``. ``select`` names a subset of
    :data:`FEATURE_NAMES` — output columns follow its order, and the O(L³)
    ``max_correlation_coefficient`` is skipped when not selected. The
    default ``None`` computes all 14 in canonical order.

    int32 counts, as plans hand them, take the tail on
    ``tail_kernel.route``: on the card one kernel launch for f1–f13 and the
    P that f14 then reads, on the CPU and past the kernel's range its plain
    version, which gives the features of the same counts in float64 bit for
    bit. ``float32_step`` (int32 counts only) first normalizes them in
    float32, as a plan with ``normalize`` does. Any other GLCM is
    normalized in float64.
    """
    idx = _select_indices(select)
    lead, L = tuple(glcm.shape[:-2]), glcm.shape[-1]
    flat = glcm.reshape(-1, L, L)
    if glcm.dtype == torch.int32 and not assume_normalized:
        feats, p, px, py = _tail.route(flat.device.type, L).tail_fn(
            flat.contiguous(), float32_step=float32_step, with_p=13 in idx)
    elif float32_step:
        raise ValueError(f"float32_step normalizes int32 counts, got {glcm.dtype}"
                         + (" with assume_normalized" if assume_normalized else ""))
    else:
        p = flat.to(torch.float64)
        if not assume_normalized:
            p = normalize_glcm(p)
        feats, px, py = _tail.f1_to_f13(p)
    if 13 in idx:
        feats = torch.cat([feats, _f14(p, px, py)[:, None]], dim=1)
    if idx != tuple(range(feats.shape[1])):
        feats = feats[:, list(idx)]
    return feats.reshape(lead + (len(idx),)).to(torch.float32)
