"""Seeded test images, made on the device in a few large calls.

The paper's two regimes (Fig. 1): a smooth texture (coarse Gaussian noise
upsampled bilinearly, slight high-frequency detail, stretched to 0..255:
votes pile onto few GLCM cells) and a random texture (iid uniform gray
levels: votes scatter). Even pool indices are smooth, odd ones random, so
every stack of consecutive images is half of each.
"""

from __future__ import annotations

import torch

__all__ = ["images"]

_CHUNK = 8  # smooth images made at once (float32 work arrays of 4 x the image)


def _interp(size: int, n: int, device) -> torch.Tensor:
    """(size, n) bilinear interpolation weights from n coarse samples."""
    idx = torch.linspace(0, n - 1, size, dtype=torch.float64, device=device)
    x0 = idx.floor().long()
    x1 = (x0 + 1).clamp_max(n - 1)
    fx = idx - x0
    w = torch.zeros(size, n, dtype=torch.float64, device=device)
    w.scatter_add_(1, x0[:, None], (1 - fx)[:, None])
    w.scatter_add_(1, x1[:, None], fx[:, None])
    return w.to(torch.float32)


def _smooth(n: int, size: int, gen: torch.Generator, device) -> torch.Tensor:
    c = max(size // 64, 2)
    w = _interp(size, c, device)
    out = torch.empty((n, size, size), dtype=torch.uint8, device=device)
    for s in range(0, n, _CHUNK):
        k = min(_CHUNK, n - s)
        coarse = torch.randn((k, c, c), generator=gen, device=device)
        img = w @ coarse @ w.T
        img += 0.02 * torch.randn((k, size, size), generator=gen, device=device)
        flat = img.view(k, -1)
        lo = flat.amin(1)[:, None, None]
        hi = flat.amax(1)[:, None, None]
        img = (img - lo) / (hi - lo).clamp_min(1e-9) * 255
        out[s:s + k] = img.to(torch.uint8)
    return out


def images(n: int, size: int, seed: int, device) -> torch.Tensor:
    """(n, size, size) uint8 on ``device``: even indices smooth, odd random."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 64))
    out = torch.empty((n, size, size), dtype=torch.uint8, device=device)
    n_smooth = (n + 1) // 2
    out[0::2] = _smooth(n_smooth, size, gen, device)
    out[1::2] = torch.randint(0, 256, (n - n_smooth, size, size), generator=gen,
                              dtype=torch.uint8, device=device)
    return out
