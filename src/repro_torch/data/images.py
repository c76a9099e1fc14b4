"""Synthetic texture images reproducing the paper's Fig. 1 regimes (numpy).

A copy of the 2-D generators of ``repro.data.images``, so that this package
and ``chip_smoke.py`` need nothing of the reference package. The same
(size, seed) gives the same image in both.

Fig 1(a): slow gray-level changes (high spatial correlation → vote
conflicts concentrate on few GLCM bins — the paper's worst case for
atomics). Fig 1(b): drastic changes (votes scatter — the easy case).
"""

from __future__ import annotations

import numpy as np

__all__ = ["smooth_texture", "random_texture", "PAPER_SIZES"]

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
