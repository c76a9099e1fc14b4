"""Synthetic texture images and volumes reproducing the paper's Fig. 1
regimes (numpy).

A copy of the generators of ``repro.data.images``, so that this package and
``chip_smoke.py`` need nothing of the reference package. The same (size or
shape, seed) gives the same array in both.

Fig 1(a): slow gray-level changes (high spatial correlation → vote
conflicts concentrate on few GLCM bins — the paper's worst case for
atomics). Fig 1(b): drastic changes (votes scatter — the easy case).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "smooth_texture",
    "random_texture",
    "image_stream",
    "texture_video",
    "smooth_volume",
    "random_volume",
    "volume_stream",
    "PAPER_SIZES",
]

PAPER_SIZES = (1024, 4096, 8192, 16384)


def smooth_texture(size: int, seed: int = 0) -> np.ndarray:
    """Fig 1(a) analogue: integrated noise → slowly varying field, uint8."""
    rng = np.random.default_rng(seed)
    # Coarse noise upsampled bilinearly → long-range correlation, O(size²).
    coarse = rng.normal(size=(max(size // 64, 2),) * 2)
    idx = np.linspace(0, coarse.shape[0] - 1, size)
    x0 = np.floor(idx).astype(int)
    x1 = np.minimum(x0 + 1, coarse.shape[0] - 1)
    fx = idx - x0
    rows = coarse[x0][:, x0] * (1 - fx)[None, :] + coarse[x0][:, x1] * fx[None, :]
    rows1 = coarse[x1][:, x0] * (1 - fx)[None, :] + coarse[x1][:, x1] * fx[None, :]
    img = rows * (1 - fx)[:, None] + rows1 * fx[:, None]
    img = img + 0.02 * rng.normal(size=img.shape)  # slight high-freq detail
    lo, hi = img.min(), img.max()
    return ((img - lo) / max(hi - lo, 1e-9) * 255).astype(np.uint8)


def random_texture(size: int, seed: int = 0) -> np.ndarray:
    """Fig 1(b) analogue: iid uniform gray levels, uint8."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(size, size)).astype(np.uint8)


def image_stream(kind: str, size: int, count: int, seed: int = 0):
    """Yield ``count`` images of one regime (for the streamed pipeline)."""
    gen = {"smooth": smooth_texture, "random": random_texture}[kind]
    for i in range(count):
        yield gen(size, seed=seed + i)


def texture_video(
    size: int,
    frames: int,
    *,
    seed: int = 0,
    shift: int = 3,
    change_at: int | None = None,
) -> np.ndarray:
    """A (frames, size, size) uint8 synthetic video for the temporal
    streaming workload: one texture panning ``shift`` pixels per frame
    (high frame-to-frame correlation — the regime where an incremental
    rolling-window GLCM pays off).

    The scene is the Fig 1(a) smooth field; at frame ``change_at`` (if
    given) it hard-cuts to the Fig 1(b) iid-noise regime, a scene change
    that shows up as a spike in the rolling window's contrast/entropy trace.
    """
    if frames < 1:
        raise ValueError("frames must be >= 1")
    scenes = [smooth_texture(size, seed=seed)]
    if change_at is not None:
        if not 0 < change_at < frames:
            raise ValueError(f"change_at must be in (0, {frames})")
        scenes.append(random_texture(size, seed=seed + 1))
    video = np.empty((frames, size, size), np.uint8)
    for t in range(frames):
        scene = scenes[-1] if change_at is not None and t >= change_at else scenes[0]
        video[t] = np.roll(scene, t * shift, axis=1)
    return video


def _shape3(shape) -> tuple[int, int, int]:
    if isinstance(shape, int):
        return (shape, shape, shape)
    d, h, w = (int(s) for s in shape)
    return d, h, w


def _upsample_linear(arr: np.ndarray, axis: int, size: int) -> np.ndarray:
    """1-D linear interpolation of ``arr`` along ``axis`` to ``size`` samples."""
    n = arr.shape[axis]
    idx = np.linspace(0, n - 1, size)
    x0 = np.floor(idx).astype(int)
    x1 = np.minimum(x0 + 1, n - 1)
    f = idx - x0
    bshape = [1] * arr.ndim
    bshape[axis] = size
    a0 = np.take(arr, x0, axis=axis)
    a1 = np.take(arr, x1, axis=axis)
    return a0 * (1 - f).reshape(bshape) + a1 * f.reshape(bshape)


def smooth_volume(shape, seed: int = 0) -> np.ndarray:
    """Fig 1(a) regime in 3-D: trilinearly upsampled coarse noise → a slowly
    varying (D, H, W) uint8 field (a CT-like stack; votes pile onto few bins,
    the conflict-heavy case). ``shape`` is (d, h, w) or an int (a cube)."""
    d, h, w = _shape3(shape)
    rng = np.random.default_rng(seed)
    coarse = rng.normal(size=tuple(max(s // 16, 2) for s in (d, h, w)))
    vol = coarse
    for axis, size in enumerate((d, h, w)):
        vol = _upsample_linear(vol, axis, size)
    vol = vol + 0.02 * rng.normal(size=vol.shape)  # slight high-freq detail
    lo, hi = vol.min(), vol.max()
    return ((vol - lo) / max(hi - lo, 1e-9) * 255).astype(np.uint8)


def random_volume(shape, seed: int = 0) -> np.ndarray:
    """Fig 1(b) regime in 3-D: iid uniform gray levels, (D, H, W) uint8."""
    d, h, w = _shape3(shape)
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(d, h, w)).astype(np.uint8)


def volume_stream(kind: str, shape, count: int, seed: int = 0):
    """Yield ``count`` volumes of one regime (for the streamed pipeline)."""
    gen = {"smooth": smooth_volume, "random": random_volume}[kind]
    for i in range(count):
        yield gen(shape, seed=seed + i)
