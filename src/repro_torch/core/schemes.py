"""The CPU voting schemes, in PyTorch: the backends "scatter" and "onehot".

Counterpart of the 2-D/3-D global part of ``repro.core.schemes``:

  Scheme 1 (contended atomic voting)  → ``glcm_scatter_batch`` (``bincount``
                                         over the linearized ``ref*L+assoc``)
  Scheme 2 (R-copy privatized voting) → ``glcm_onehot`` / ``glcm_multi``
                                         (one-hot matmul ``RᵀA`` per copy)

Inputs are quantized int images, or — with ``quant=(lo, span)`` — raw
pixels binned on the fly by ``core.quantize.bin_values``, applied to the
sliced pair planes and never to the whole image. The batch is an explicit
leading dimension (the reference vmaps): a stack with one axis more than the
offset's rank is a batch. Votes whose level lies outside [0, L) are dropped,
as the reference's one-hot compare drops them.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantize import bin_values
from repro_torch.kernels.ref import DIRECTIONS_3D, glcm_offsets, pair_planes_nd

__all__ = [
    "glcm_scatter_batch",
    "glcm_onehot",
    "glcm_multi",
    "PAPER_PAIRS",
    "VOLUME_PAIRS",
]

# The paper's Table II / III parameter grid: d ∈ {1, 4}, θ ∈ {0°, 45°}.
PAPER_PAIRS: tuple[tuple[int, int], ...] = ((1, 0), (1, 45), (4, 0), (4, 45))

# All 13 unique 3-D directions at distance 1 (pairs for an ndim=3 spec).
VOLUME_PAIRS: tuple[tuple[int, int], ...] = tuple(
    (1, k) for k in range(len(DIRECTIONS_3D))
)


def _per_image(quant, b: int, nd: int, device):
    """(lo, span) as (B, 1, ..., 1) f32 tensors broadcasting over ``nd``
    spatial axes: each image of a stack is binned with its own range."""
    shape = (b,) + (1,) * nd
    lo = torch.as_tensor(quant[0], dtype=torch.float32, device=device)
    span = torch.as_tensor(quant[1], dtype=torch.float32, device=device)
    return lo.expand(b).reshape(shape), span.expand(b).reshape(shape)


def _levels_of(plane: torch.Tensor, levels: int, quant) -> torch.Tensor:
    """Pair-plane values → int64 levels (binned when ``quant`` is given)."""
    if quant is None:
        return plane.to(torch.int64)
    return bin_values(plane, levels, *quant).to(torch.int64)


def _as_stack(img: torch.Tensor, nd: int) -> tuple[torch.Tensor, bool]:
    if img.ndim == nd + 1:
        return img, True
    if img.ndim != nd:
        raise ValueError(
            f"expected a {nd}-D input or a batched {nd + 1}-D stack, got shape "
            f"{tuple(img.shape)}"
        )
    return img[None], False


def glcm_scatter_batch(
    stack: torch.Tensor,
    levels: int,
    offsets: tuple[tuple[int, ...], ...],
    *,
    quant=None,
) -> torch.Tensor:
    """Scheme 1 for a (B, *spatial) stack: one flat ``bincount`` over
    ``pos = (b·n_off + k)·L² + ref·L + assoc`` for all images and offsets.
    Returns (B, n_off, L, L) int32 counts."""
    b = stack.shape[0]
    n_off = len(offsets)
    cells = levels * levels
    nd = stack.ndim - 1
    if quant is not None:
        quant = _per_image(quant, b, nd, stack.device)
    base = torch.arange(b, device=stack.device).reshape((b,) + (1,) * nd) * (n_off * cells)
    parts = []
    for k, off in enumerate(offsets):
        assoc, ref = pair_planes_nd(stack, off)
        a = _levels_of(assoc, levels, quant)
        r = _levels_of(ref, levels, quant)
        valid = (a >= 0) & (a < levels) & (r >= 0) & (r < levels)
        parts.append((base + k * cells + r * levels + a)[valid])
    counts = torch.bincount(torch.cat(parts), minlength=b * n_off * cells)
    return counts.reshape(b, n_off, levels, levels).to(torch.int32)


def _onehot(v: torch.Tensor, levels: int) -> torch.Tensor:
    """(..., P) int → (..., P, L) f32 one-hot; a value outside [0, L) (the
    -1 pad included) gives an all-zero row, so its vote drops."""
    iota = torch.arange(levels, device=v.device)
    return (v[..., None] == iota).to(torch.float32)


def glcm_onehot(
    img: torch.Tensor,
    levels: int,
    offset: tuple[int, ...] = (0, 1),
    *,
    copies: int = 1,
    quant=None,
) -> torch.Tensor:
    """Scheme 2: the GLCM is the matmul ``RᵀA`` of the one-hot ref/assoc
    matrices. ``copies`` (the paper's R) splits the pair stream into R
    sub-streams with private (L, L) sub-accumulators, summed at the end.

    ``img`` is (*spatial) → (L, L) or (B, *spatial) → (B, L, L), float32
    counts (exact: every partial sum is an integer below 2²⁴ at the sizes
    this CPU path serves). Symmetric/normalize are the plan's tail.
    """
    if copies < 1:
        raise ValueError(f"copies (R) must be >= 1, got {copies}")
    nd = len(offset)
    stack, batched = _as_stack(img, nd)
    b = stack.shape[0]
    if quant is not None:
        quant = _per_image(quant, b, nd, stack.device)
    assoc, ref = pair_planes_nd(stack, offset)
    a = _levels_of(assoc, levels, quant).reshape(b, -1)
    r = _levels_of(ref, levels, quant).reshape(b, -1)
    pad = (-a.shape[1]) % copies
    if pad:  # dead votes pad the stream to a multiple of R
        a = torch.nn.functional.pad(a, (0, pad), value=-1)
        r = torch.nn.functional.pad(r, (0, pad), value=-1)
    A = _onehot(a.reshape(b, copies, -1), levels)  # (B, R, P/R, L)
    R = _onehot(r.reshape(b, copies, -1), levels)
    glcm = torch.einsum("bcpi,bcpj->bcij", R, A).sum(dim=1)  # Σ_ρ R_ρᵀ A_ρ
    return glcm if batched else glcm[0]


def glcm_multi(
    img: torch.Tensor,
    levels: int,
    pairs: tuple[tuple[int, int], ...] = PAPER_PAIRS,
    *,
    offsets: tuple[tuple[int, ...], ...] | None = None,
    copies: int = 1,
    quant=None,
) -> torch.Tensor:
    """GLCMs for several offsets: ``pairs`` are 2-D (d, θ) tuples;
    ``offsets`` (explicit (dy, dx) / (dz, dy, dx) tuples) overrides them.
    Returns (n_off, L, L), batch axis leading if present."""
    if offsets is None:
        offsets = tuple(glcm_offsets(d, t) for d, t in pairs)
    return torch.stack(
        [
            glcm_onehot(img, levels, off, copies=copies, quant=quant)
            for off in offsets
        ],
        dim=-3,
    )
