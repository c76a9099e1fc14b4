"""Public wrappers around the CUDA voting kernels.

Counterpart of ``repro.kernels.ops``:
``glcm_cuda`` ↔ ``glcm_pallas`` (pair planes, binning, pair-stream vote),
``glcm_cuda_multi`` ↔ ``glcm_pallas_multi`` (fused multi-offset image pass),
``glcm_cuda_volume`` ↔ ``glcm_pallas_volume`` (depth-slab volume pass) and
``glcm_cuda_windowed`` ↔ ``glcm_pallas_windowed`` (one GLCM per window)
and ``histogram`` ↔ ``histogram`` (exact level counts). On a CPU tensor
the kernels' plain versions compute the counts; on a CUDA tensor the
kernels do. ``onehot_count`` is plain PyTorch, as the reference's is plain
``jnp``: no kernel stands behind it.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantize import bin_values
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.glcm_kernel import (
    DEFAULT_CHUNK,
    DEFAULT_COPIES,
    DEFAULT_SLAB_D,
    glcm_fused,
    glcm_volume,
    glcm_vote,
    glcm_window,
)
from repro_torch.kernels.histogram_kernel import histogram as _histogram

__all__ = [
    "glcm_cuda",
    "glcm_cuda_multi",
    "glcm_cuda_volume",
    "glcm_cuda_windowed",
    "histogram",
    "one_hot",
    "onehot_count",
    "default_tile_h",
    "default_slab_d",
    "DEFAULT_CHUNK",
    "DEFAULT_COPIES",
]


def _bin_planes(planes, levels: int, quant, nd: int):
    """Bin each sliced pair plane (never the whole image); per-image (B,)
    params broadcast over the ``nd`` spatial axes."""
    lo, span = quant
    if torch.is_tensor(lo) and lo.ndim:
        lo = lo.reshape(lo.shape + (1,) * nd)
        span = span.reshape(span.shape + (1,) * nd)
    return tuple(bin_values(p, levels, lo, span) for p in planes)


def glcm_cuda(
    img: torch.Tensor,
    levels: int,
    d: int = 1,
    theta: int = 0,
    *,
    offset: tuple[int, ...] | None = None,
    chunk: int = DEFAULT_CHUNK,
    copies: int = DEFAULT_COPIES,
    quant=None,
) -> torch.Tensor:
    """GLCM of image(s) via the pair-stream voting kernel, int32 counts.

    Pair planes are strided slices of the input (paper Eq. (2)); with
    ``quant=(lo, span)`` they are binned on their way into the kernel, which
    never sees the spatial rank: (H, W) → (L, L), (B, H, W) → (B, L, L) in
    one launch, and with ``offset=(dz, dy, dx)`` volumes the same way.
    """
    off = tuple(int(v) for v in offset) if offset is not None else (
        _ref.glcm_offsets(d, theta)
    )
    nd = len(off)
    if img.ndim not in (nd, nd + 1):
        raise ValueError(
            f"expected a {nd}-D input or a batched {nd + 1}-D stack for "
            f"offset {off}, got shape {tuple(img.shape)}"
        )
    assoc, rf = _ref.pair_planes_nd(img, off)
    if quant is not None:
        assoc, rf = _bin_planes((assoc, rf), levels, quant, nd)
    lead = tuple(img.shape[:-nd])
    return glcm_vote(
        assoc.to(torch.int32).reshape(lead + (-1,)),
        rf.to(torch.int32).reshape(lead + (-1,)),
        levels=levels,
        chunk=chunk,
        copies=copies,
    )


def default_tile_h(offsets: tuple[tuple[int, int], ...]) -> int:
    """max(8, largest dy) rounded up to 8 — the reference's default."""
    max_dy = max((dy for dy, _ in offsets), default=1)
    return max(8, -(-max_dy // 8) * 8)


def glcm_cuda_multi(
    img: torch.Tensor,
    levels: int,
    pairs: tuple[tuple[int, int], ...],
    *,
    tile_h: int | None = None,
    copies: int = 1,
    quant=None,
) -> torch.Tensor:
    """Multi-offset GLCM in one image pass via the fused kernel, int32.

    ``pairs`` are (d, theta) tuples; (H, W) → (len(pairs), L, L), (B, H, W)
    → (B, len(pairs), L, L) in one launch. ``tile_h`` defaults to
    ``default_tile_h`` of the offsets.
    """
    offsets = tuple(_ref.glcm_offsets(d, t) for d, t in pairs)
    if tile_h is None:
        tile_h = default_tile_h(offsets)
    return glcm_fused(
        img, levels=levels, offsets=offsets, tile_h=tile_h, copies=copies, quant=quant
    )


def default_slab_d(offsets: tuple[tuple[int, int, int], ...]) -> int:
    """max(8, largest dz) rounded up to 8 — the reference's default."""
    max_dz = max((dz for dz, _, _ in offsets), default=1)
    return max(DEFAULT_SLAB_D, -(-max_dz // 8) * 8)


def glcm_cuda_volume(
    vol: torch.Tensor,
    levels: int,
    pairs: tuple[tuple[int, int], ...],
    *,
    offsets: tuple[tuple[int, int, int], ...] | None = None,
    slab_d: int | None = None,
    copies: int = 1,
    quant=None,
) -> torch.Tensor:
    """Multi-direction 3-D GLCM in one volume pass via the depth-slab kernel.

    ``pairs`` are (d, direction) tuples over the 13 unique 3-D directions
    (``ref.DIRECTIONS_3D``); ``offsets`` passes explicit (dz, dy, dx) voxel
    offsets instead. (D, H, W) → (len(pairs), L, L) int32, (B, D, H, W) →
    (B, len(pairs), L, L) in one launch. ``slab_d`` defaults to
    ``default_slab_d`` of the offsets.
    """
    if offsets is None:
        offsets = tuple(_ref.glcm_offsets_3d(d, k) for d, k in pairs)
    offsets = tuple(offsets)
    if slab_d is None:
        slab_d = default_slab_d(offsets)
    return glcm_volume(vol, levels=levels, offsets=offsets, slab_d=slab_d, copies=copies,
                       quant=quant)


def glcm_cuda_windowed(
    x: torch.Tensor,
    levels: int,
    pairs: tuple[tuple[int, int], ...],
    *,
    region_shape=None,
    stride=None,
    copies: int = 1,
    quant=None,
) -> torch.Tensor:
    """Per-window GLCMs via the window kernel, int32.

    ``x`` is an (H, W) / (B, H, W) image with ``region_shape`` and
    ``stride``, whose windows the kernel reads in place, or — without them —
    a (gh, gw, rh, rw) / (B, gh, gw, rh, rw) patch grid (the output of
    ``core.schemes.extract_regions``). The result appends (len(pairs), L, L)
    to the grid axes; the whole texture map is one launch.
    """
    offsets = tuple(_ref.glcm_offsets(d, t) for d, t in pairs)
    return glcm_window(x, levels=levels, offsets=offsets, region_shape=region_shape,
                       stride=stride, copies=copies, quant=quant)


def histogram(
    values: torch.Tensor,
    levels: int,
    *,
    chunk: int = DEFAULT_CHUNK,
    copies: int = DEFAULT_COPIES,
) -> torch.Tensor:
    """Exact (L,) int32 level counts of ``values`` (any shape) via the
    histogram kernel; -1 pads and values outside [0, L) are not counted."""
    return _histogram(values, levels=levels, chunk=chunk, copies=copies)


def one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """(..., n) one-hot of the integer ``idx`` in ``dtype``; an index outside
    [0, n) is all zeros. A comparison with an iota, as ``jax.nn.one_hot``
    computes it: ``F.one_hot`` reads its indices' range on the host (a
    data-dependent path that a fake tensor cannot take)."""
    return (idx[..., None] == torch.arange(n, dtype=idx.dtype, device=idx.device)).to(dtype)


def onehot_count(
    indices: torch.Tensor,
    num_classes: int,
    weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Conflict-free (optionally weighted) class counting over the last axis.

    The paper-derived primitive: instead of scatter-adding into a count
    vector (serialised under contention), build the one-hot matrix and
    reduce it. Shapes: indices (..., K) int → (..., C), float32 (the
    weights' dtype when weights are given); an index outside [0, C) counts
    nowhere.
    """
    idx = indices.to(torch.int32)
    if weights is not None:
        return (one_hot(idx, num_classes, weights.dtype) * weights[..., None]).sum(dim=-2)
    return one_hot(idx, num_classes, torch.float32).sum(dim=-2)
