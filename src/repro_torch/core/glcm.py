"""Public GLCM API — thin wrappers over the spec → plan → backend layer.

Counterpart of ``repro.core.glcm``:

    from repro_torch.core import glcm
    P = glcm.glcm(img, levels=32, d=1, theta=45)         # (L, L) on the card
    F = glcm.glcm_features(imgs, levels=32)              # (B, 4 offsets, 14)
    F = glcm.glcm_features(imgs, 32, device="cpu")       # same, on the CPU

Both entry points take a numpy array or a tensor — (H, W) or a (B, H, W)
stack, or with ``ndim=3`` a (D, H, W) volume or (B, D, H, W) stack — build
a frozen :class:`GLCMSpec` and run it through :func:`compile_plan`. With
``region="tiles" | "window"`` they give one result per region (a texture
map), the region grid between the batch and the pair axes.
``device=None`` means the current CUDA device, and without a card they
raise RuntimeError; only ``device="cpu"`` runs on the CPU. Results are
tensors on the plan's device: count-only ``glcm()`` gives exact int32 counts
(the reference gives float32, which rounds a cell past 2²⁴), normalized
matrices and features are float32.

Schemes: "scatter", "onehot", "blocked", "native" (NumPy counting on the
host), "cuda" (pair-stream vote kernel), "cuda_fused" (fused multi-offset
kernel; window kernel for regions), "cuda_volume" (depth-slab volume
kernel) or "auto" — the autotuner's stored winner for this (spec, shape,
device) when there is one (backend and knobs: ``chunk``, ``copies``,
``tile_h``, ``slab_d``, ``num_blocks``; see ``core.autotune``), else on
CUDA "cuda_volume" for volumes, "cuda_fused" for several pairs and "cuda"
for one; on the CPU "onehot".
"""

from __future__ import annotations

from typing import Literal

import torch

from repro_torch.core.plan import compile_plan
from repro_torch.core.schemes import PAPER_PAIRS, VOLUME_PAIRS
from repro_torch.core.spec import GLCMSpec

__all__ = [
    "glcm",
    "glcm_features",
    "GLCMSpec",
    "compile_plan",
    "Scheme",
    "PAPER_PAIRS",
    "VOLUME_PAIRS",
]

Scheme = Literal[
    "scatter", "onehot", "blocked", "native", "cuda", "cuda_fused", "cuda_volume", "auto"
]


def _check_ndim(image, ndim: int) -> None:
    if ndim == 2 and image.ndim not in (2, 3):
        raise ValueError(
            f"expected (H, W) image or (B, H, W) stack, got shape {tuple(image.shape)}"
        )
    if ndim == 3 and image.ndim not in (3, 4):
        raise ValueError(
            f"expected (D, H, W) volume or (B, D, H, W) stack, "
            f"got shape {tuple(image.shape)}"
        )


def glcm(
    image,
    levels: int,
    d: int = 1,
    theta: int = 0,
    *,
    scheme: Scheme = "auto",
    quantize: str | None = None,
    symmetric: bool = False,
    normalize: bool = False,
    copies: int = 1,
    num_blocks: int = 4,
    region: str = "global",
    region_shape: tuple[int, ...] | int | None = None,
    region_stride: tuple[int, ...] | int | None = None,
    ndim: int = 2,
    accum: str = "auto",
    device=None,
) -> torch.Tensor:
    """Gray-level co-occurrence matrix of image(s) or volume(s): exact int32
    counts, or float32 with ``normalize=True``.

    The reference returns float32 counts, which round a cell past 2²⁴ (a
    constant 4097 x 4098 image at d = 1 holds 16 785 409 pairs in one cell;
    float32 makes it 16 785 408). The port keeps the kernels' int32 counts,
    equal to the reference's values wherever those are exact.

    (H, W) input → (L, L); (B, H, W) input → (B, L, L). With ``ndim=3`` the
    input is a (D, H, W) volume (or stack) and ``theta`` names one of the 13
    unique 3-D directions. A region spec inserts the region grid before the
    matrix: (B, *grid, L, L). ``device=None`` runs on the card.
    """
    _check_ndim(image, ndim)
    spec = GLCMSpec(
        levels=levels,
        pairs=((d, theta),),
        scheme=scheme,
        quantize=quantize,
        symmetric=symmetric,
        normalize=normalize,
        copies=max(copies, 1),
        num_blocks=num_blocks,
        region=region,
        region_shape=region_shape,
        region_stride=region_stride,
        ndim=ndim,
        accum=accum,
    )
    return compile_plan(spec, tuple(image.shape), device=device)(image)[..., 0, :, :]


def glcm_features(
    image,
    levels: int,
    pairs: tuple[tuple[int, int], ...] = PAPER_PAIRS,
    *,
    scheme: Scheme = "auto",
    quantize: str | None = "uniform",
    region: str = "global",
    region_shape: tuple[int, ...] | int | None = None,
    region_stride: tuple[int, ...] | int | None = None,
    select: tuple[str, ...] | None = None,
    ndim: int = 2,
    accum: str = "auto",
    device=None,
) -> torch.Tensor:
    """Image(s)/volume(s) → Haralick features over ``pairs`` offsets.

    (H, W) input → (len(pairs), 14); (B, H, W) input → (B, len(pairs), 14);
    a region spec gives (B, *grid, len(pairs), 14), and ``ndim=3`` takes
    volumes with ``pairs`` over the 13 3-D directions.
    ``select`` names a feature subset (columns follow its order; the O(L³)
    ``max_correlation_coefficient`` solve is skipped when unselected).
    ``device=None`` runs on the card.
    """
    _check_ndim(image, ndim)
    spec = GLCMSpec(
        levels=levels, pairs=tuple(pairs), scheme=scheme, quantize=quantize,
        region=region, region_shape=region_shape, region_stride=region_stride,
        ndim=ndim, accum=accum,
    )
    features = True if select is None else tuple(select)
    return compile_plan(spec, tuple(image.shape), features=features, device=device)(image)
