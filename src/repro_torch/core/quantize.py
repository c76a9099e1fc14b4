"""Gray-level quantization — the paper's pre-processing stage, in PyTorch.

Counterpart of ``repro.core.quantize``, bit-exact with it:

* ``bin_values`` is the one affine-binning expression, with the same f32 op
  order (subtract, divide, multiply, floor, clip, int32). The CUDA image
  kernels (``csrc/glcm_march.cuh`` and the others) bin with the same order
  and IEEE division, so fused and unfused plans count the same votes.
* ``uniform_params`` gives the (lo, span) a fused consumer needs: python
  floats when the range is pinned, per-image (B,) reductions otherwise;
  ``repeat_params`` repeats per-image ranges over each image's regions, so
  every window of a texture map bins with its image's range.
* ``quantize_uniform`` short-circuits the provably-identity case (uint8,
  ``levels=256``, range (0, 255)) to a dtype cast.
* ``quantize_equalized`` is histogram-equalized binning over a 256-bin CDF.
"""

from __future__ import annotations

import torch

__all__ = [
    "PAPER_LEVELS",
    "quantize_uniform",
    "quantize_equalized",
    "assert_levels",
    "bin_values",
    "uniform_params",
    "repeat_params",
    "is_identity_quantize",
]

# Gray levels used throughout the paper.
PAPER_LEVELS = (8, 32)

_TINY = float(torch.finfo(torch.float32).tiny)


def assert_levels(levels: int) -> None:
    if not (2 <= levels <= 256):
        raise ValueError(f"levels must be in [2, 256], got {levels}")


def is_identity_quantize(
    dtype: torch.dtype, levels: int, vmin: float | None, vmax: float | None
) -> bool:
    """Whether uniform quantization is provably the identity map: uint8
    input, all 256 levels kept, and the pinned range exactly (0, 255)."""
    return (
        dtype == torch.uint8
        and levels == 256
        and vmin is not None
        and vmax is not None
        and float(vmin) == 0.0
        and float(vmax) == 255.0
    )


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def bin_values(x: torch.Tensor, levels: int, lo, span) -> torch.Tensor:
    """The uniform-binning expression: values → int32 levels in [0, levels).

    ``lo``/``span`` are python floats or tensors broadcastable against ``x``.
    Both become f32 tensors on ``x``'s device first: PyTorch's CUDA division
    by a python scalar multiplies by its reciprocal, which is not IEEE
    division and moves values that sit on a bin edge.
    """
    lo = _f32(lo, x.device)
    span = _f32(span, x.device)
    q = x.to(torch.float32) - lo
    q.div_(span).mul_(levels).floor_().clamp_(0, levels - 1)
    return q.to(torch.int32)


def uniform_params(
    image: torch.Tensor,
    *,
    vmin: float | None = None,
    vmax: float | None = None,
    batched: bool = False,
):
    """(lo, span) for ``bin_values`` — the fused-quantize parameters.

    With both bounds pinned the result is python floats (no device work).
    Otherwise the range comes from the data in f32: scalars for one image,
    per-image (B,) tensors when ``batched``. ``span`` is floored at the
    smallest normal f32 so a constant image bins to level 0. Integer input
    is reduced in its own dtype and only its extremes become f32 — the same
    values, since rounding to f32 keeps order — with no widened copy of the
    image.
    """
    if vmin is not None and vmax is not None:
        return float(vmin), max(float(vmax) - float(vmin), _TINY)
    integer = not (image.dtype.is_floating_point or image.dtype.is_complex
                   or image.dtype == torch.bool)
    x = image if integer else image.to(torch.float32)
    if batched:
        flat = x.reshape(x.shape[0], -1)
        lo = (flat.amin(dim=1).to(torch.float32) if vmin is None
              else _f32(vmin, x.device).expand(x.shape[0]))
        hi = (flat.amax(dim=1).to(torch.float32) if vmax is None
              else _f32(vmax, x.device).expand(x.shape[0]))
    else:
        lo = x.amin().to(torch.float32) if vmin is None else _f32(vmin, x.device)
        hi = x.amax().to(torch.float32) if vmax is None else _f32(vmax, x.device)
    span = (hi - lo).clamp_min(_TINY)
    return lo, span


def repeat_params(quant, n: int):
    """Per-image (lo, span) for a flat batch of ``n`` regions, image major:
    each entry of per-image (B,) tensors repeats over its image's n // B
    regions; python floats and 0-d tensors, shared by all, pass through."""
    lo, span = quant
    if torch.is_tensor(lo) and lo.ndim:
        reps = n // lo.shape[0]
        return lo.repeat_interleave(reps), span.repeat_interleave(reps)
    return lo, span


def quantize_uniform(
    image: torch.Tensor,
    levels: int,
    *,
    vmin: float | None = None,
    vmax: float | None = None,
) -> torch.Tensor:
    """Uniformly quantize one image into ``levels`` gray levels (int32 in
    ``[0, levels)``); the range is pinned by ``vmin``/``vmax`` or taken from
    the data."""
    assert_levels(levels)
    if is_identity_quantize(image.dtype, levels, vmin, vmax):
        return image.to(torch.int32)
    lo, span = uniform_params(image, vmin=vmin, vmax=vmax)
    return bin_values(image, levels, lo, span)


def quantize_equalized(image: torch.Tensor, levels: int, *, nbins: int = 256) -> torch.Tensor:
    """Histogram-equalized quantization of one image: bins hold ~equal pixel
    counts. The empirical CDF over ``nbins`` coarse bins maps each pixel to
    its quantile, which is split uniformly into ``levels`` bins."""
    assert_levels(levels)
    x = image.to(torch.float32)
    lo, hi = x.amin(), x.amax()
    span = (hi - lo).clamp_min(_TINY)
    idx = torch.floor((x - lo) / span * nbins).clamp_(0, nbins - 1).to(torch.int64)
    counts = torch.bincount(idx.reshape(-1), minlength=nbins).to(torch.float32)
    cdf = torch.cumsum(counts, dim=0)
    cdf = cdf / cdf[-1]
    quantile = cdf[idx]  # in (0, 1]
    q = torch.ceil(quantile * levels) - 1.0
    return q.clamp_(0, levels - 1).to(torch.int32)
