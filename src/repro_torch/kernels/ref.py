"""Offset tables and the plain scatter-add oracle, in PyTorch.

Counterpart of ``repro.kernels.ref``. Conventions (paper Eq. (2), row-major
addressing ``addr = y*N + x``):

    theta =   0° : (dy, dx) = ( 0, +d)
    theta =  45° : (dy, dx) = (+d, -d)
    theta =  90° : (dy, dx) = (+d,  0)
    theta = 135° : (dy, dx) = (+d, +d)

and the vote position (paper Eq. (3)): ``pos = f_ref * L + f_assoc`` — i.e.
``P[ref_level, assoc_level] += 1``.
"""

from __future__ import annotations

import torch

__all__ = [
    "OFFSETS",
    "PAPER_THETAS",
    "DIRECTIONS_3D",
    "glcm_offsets",
    "glcm_offsets_3d",
    "pair_planes",
    "pair_planes_nd",
    "glcm_reference",
    "glcm_reference_nd",
    "glcm_multi_reference",
    "histogram_reference",
    "onehot_count_reference",
]

# theta (degrees) -> (dy, dx) per paper Eq. (2)
OFFSETS: dict[int, tuple[int, int]] = {
    0: (0, 1),
    45: (1, -1),
    90: (1, 0),
    135: (1, 1),
}

# The paper's four in-plane angles (degrees).
PAPER_THETAS = (0, 45, 90, 135)

# The 13 unique 3-D co-occurrence directions, one per {v, -v} pair of the
# 26-neighborhood. 0..3 are the in-plane thetas (dz = 0) in OFFSETS order;
# 4..12 are the nine dz = +1 inter-slice offsets.
DIRECTIONS_3D: tuple[tuple[int, int, int], ...] = (
    (0, 0, 1),
    (0, 1, -1),
    (0, 1, 0),
    (0, 1, 1),
    (1, -1, -1),
    (1, -1, 0),
    (1, -1, 1),
    (1, 0, -1),
    (1, 0, 0),
    (1, 0, 1),
    (1, 1, -1),
    (1, 1, 0),
    (1, 1, 1),
)


def glcm_offsets(d: int, theta: int) -> tuple[int, int]:
    """Pixel offset (dy, dx) for distance ``d`` and direction ``theta``."""
    if d < 1:
        raise ValueError(f"distance d must be >= 1, got {d}")
    try:
        dy, dx = OFFSETS[theta]
    except KeyError:
        raise ValueError(f"theta must be one of {sorted(OFFSETS)}, got {theta}") from None
    return d * dy, d * dx


def glcm_offsets_3d(d: int, direction: int) -> tuple[int, int, int]:
    """Voxel offset (dz, dy, dx) for distance ``d`` and one of the 13 unique
    3-D directions (``DIRECTIONS_3D`` index; 0..3 are the in-plane thetas)."""
    if d < 1:
        raise ValueError(f"distance d must be >= 1, got {d}")
    if not (0 <= direction < len(DIRECTIONS_3D)):
        raise ValueError(
            f"3-D direction must be in [0, {len(DIRECTIONS_3D) - 1}], got {direction}"
        )
    dz, dy, dx = DIRECTIONS_3D[direction]
    return d * dz, d * dy, d * dx


def pair_planes_nd(
    img: torch.Tensor, offset: tuple[int, ...]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Aligned (assoc, ref) views for a per-axis ``offset`` over the trailing
    ``len(offset)`` axes; any component may be negative and leading batch
    dims are kept. The results are strided views of ``img``, not copies."""
    nd = len(offset)
    if img.ndim < nd:
        raise ValueError(f"expected (..., {nd} spatial axes), got shape {tuple(img.shape)}")
    dims = img.shape[-nd:]
    for delta, size in zip(offset, dims):
        if abs(delta) >= size:
            raise ValueError(f"offset {offset} exceeds image shape {tuple(img.shape)}")
    assoc_ix: list = [Ellipsis]
    ref_ix: list = [Ellipsis]
    for delta, size in zip(offset, dims):
        if delta >= 0:
            assoc_ix.append(slice(0, size - delta))
            ref_ix.append(slice(delta, size))
        else:
            assoc_ix.append(slice(-delta, size))
            ref_ix.append(slice(0, size + delta))
    return img[tuple(assoc_ix)], img[tuple(ref_ix)]


def pair_planes(img: torch.Tensor, d: int, theta: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Aligned (assoc, ref) views for the 2-D offset (d, theta) over the
    trailing two axes (paper Eq. (2)); leading batch dims are kept."""
    if img.ndim < 2:
        raise ValueError(f"expected (..., H, W) image, got shape {tuple(img.shape)}")
    return pair_planes_nd(img, glcm_offsets(d, theta))


def glcm_reference(
    img: torch.Tensor,
    levels: int,
    d: int = 1,
    theta: int = 0,
    *,
    symmetric: bool = False,
    normalize: bool = False,
    dtype=torch.float32,
) -> torch.Tensor:
    """Scheme-1 oracle for one (already quantized) image and the offset
    (d, theta). Returns (levels, levels); ``P[i, j]`` counts pairs with ref
    level ``i`` and associate level ``j`` (paper Eq. (3))."""
    return glcm_reference_nd(img, levels, glcm_offsets(d, theta), symmetric=symmetric,
                             normalize=normalize, dtype=dtype)


def glcm_multi_reference(
    img: torch.Tensor,
    levels: int,
    pairs: tuple[tuple[int, int], ...],
    **kw,
) -> torch.Tensor:
    """Stacked oracle GLCMs for several (d, theta) pairs → (len(pairs), L, L)."""
    return torch.stack([glcm_reference(img, levels, d, t, **kw) for d, t in pairs])


def glcm_reference_nd(
    img: torch.Tensor,
    levels: int,
    offset: tuple[int, ...],
    *,
    symmetric: bool = False,
    normalize: bool = False,
    dtype=torch.float32,
) -> torch.Tensor:
    """Scheme-1 oracle for one (already quantized) image: scatter-add voting
    for an explicit (dy, dx) / (dz, dy, dx) offset. Returns (levels, levels)."""
    assoc, ref = pair_planes_nd(img, offset)
    pos = (ref.to(torch.int64) * levels + assoc.to(torch.int64)).reshape(-1)
    flat = torch.zeros(levels * levels, dtype=dtype, device=img.device)
    flat.index_add_(0, pos, torch.ones(pos.shape, dtype=dtype, device=img.device))
    glcm = flat.reshape(levels, levels)
    if symmetric:
        glcm = glcm + glcm.T
    if normalize:
        glcm = glcm / glcm.sum().clamp_min(1)
    return glcm


def histogram_reference(values: torch.Tensor, levels: int, dtype=torch.float32) -> torch.Tensor:
    """Oracle for the histogram kernel (paper §II.A's 'image statistical
    histogram' analogy): counts of each level in ``values``, cast to int32
    as the kernel casts them (floats truncate toward zero).

    Only values in [0, levels) count, as in the kernel. ``repro``'s oracle
    scatters with JAX's wrapping indices instead, so there a -1 pad lands
    in bin ``levels - 1``; this one follows the kernel it checks.
    """
    v = values.reshape(-1).to(torch.int32).to(torch.int64)
    v = v[(v >= 0) & (v < levels)]
    out = torch.zeros((levels,), dtype=dtype, device=values.device)
    return out.index_add_(0, v, torch.ones(v.shape, dtype=dtype, device=values.device))


def onehot_count_reference(
    indices: torch.Tensor,
    num_classes: int,
    weights: torch.Tensor | None = None,
    dtype=torch.float32,
) -> torch.Tensor:
    """Oracle for the conflict-free counting primitive ``ops.onehot_count``:
    per-class (optionally weighted) counts over the last axis of
    ``indices``, leading axes kept. Only indices in [0, num_classes) count,
    as in the one-hot compare it checks (``repro``'s oracle wraps negative
    indices instead)."""
    idx = indices.to(torch.int32).to(torch.int64)
    flat = idx.reshape(-1, idx.shape[-1])
    if weights is None:
        w = torch.ones(flat.shape, dtype=dtype, device=idx.device)
    else:
        w = weights.reshape(flat.shape).to(dtype)
    keep = (flat >= 0) & (flat < num_classes)
    rows = torch.arange(flat.shape[0], device=idx.device)[:, None].expand(flat.shape)
    pos = (rows * num_classes + flat)[keep]
    counts = torch.zeros(flat.shape[0] * num_classes, dtype=dtype, device=idx.device)
    counts.index_add_(0, pos, w[keep])
    return counts.reshape(idx.shape[:-1] + (num_classes,))
