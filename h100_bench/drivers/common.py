"""What the drivers share: the entry point's keywords from a configuration,
the seeded order of a pool, and the pixels of one input."""

from __future__ import annotations

import numpy as np

__all__ = ["entry_kwargs", "order", "pixels", "chunk_note"]


def entry_kwargs(cfg: dict) -> dict:
    """``glcm_features``' keywords for configuration ``cfg``."""
    kw = dict(pairs=tuple(map(tuple, cfg["pairs"])), quantize=cfg["quantize"])
    if cfg["region"] != "global":
        kw.update(region=cfg["region"], region_shape=cfg["region_shape"],
                  region_stride=cfg["region_stride"])
    return kw


def order(n: int, seed: int) -> np.ndarray:
    """A seeded permutation of range(n): every seed visits the same pool."""
    return np.random.default_rng(int(seed) % (1 << 64)).permutation(n)


def pixels(cfg: dict) -> int:
    return cfg["image_size"] ** 2


def chunk_note(ends, pixels: int, t0: float, chunk_s: float = 3.0) -> str:
    """Mpx/s of the calls that ended in each ``chunk_s`` of the window."""
    n = int(max(ends, default=t0) - t0) // int(chunk_s) + 1
    counts = np.bincount(((np.asarray(ends) - t0) // chunk_s).astype(int), minlength=n)
    rates = " ".join(f"{c * pixels / chunk_s / 1e6:.1f}" for c in counts[:-1])
    return f"Mpx/s by {chunk_s:g} s of the window: {rates}"
