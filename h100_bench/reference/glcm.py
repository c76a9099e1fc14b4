"""The plain reference: quantization, co-occurrence counts and the 14
Haralick features, in plain PyTorch.

A frozen copy of the arithmetic the benchmark holds the program to. It
imports nothing of the program: the binning, the counting and the features
are written out again here from the paper's definitions (arXiv:1710.06189,
Eq. (2)-(3); Haralick, Shanmugam & Dinstein 1973), and it takes nothing the
program has made, only the raw images.

* ``bin_levels``: uniform quantization over each image's own range, in
  float32 with the op order subtract, divide, multiply, floor, clip.
* ``counts``: L x L counts per offset, ``P[ref, assoc] += 1`` with the
  associate at (y, x) and the reference at (y + dy, x + dx); a bincount of
  ``ref * L + assoc`` over the pairs that lie inside the image (or inside
  each window of a texture map).
* ``features``: the 14 features of each count matrix, normalised, in
  float64 (``dtype=torch.float32`` gives the control: the same formulas one
  precision lower).

Everything runs on whatever device its inputs are on, in blocks, so a
4096 x 4096 texture map fits beside the rest.
"""

from __future__ import annotations

import torch

__all__ = ["OFFSETS", "offsets", "bin_levels", "image_range", "counts",
           "window_counts", "features", "expected_features"]

# theta (degrees) -> (dy, dx) for distance 1 (paper Eq. (2)).
OFFSETS = {0: (0, 1), 45: (1, -1), 90: (1, 0), 135: (1, 1)}

_TINY = float(torch.finfo(torch.float32).tiny)
_EPS = 1e-12


def offsets(pairs) -> list[tuple[int, int]]:
    """(d, theta) pairs -> (dy, dx) pixel offsets."""
    return [(d * OFFSETS[t][0], d * OFFSETS[t][1]) for d, t in pairs]


def image_range(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, span) of one image in float32, span floored at the smallest
    normal float32 so that a constant image bins to level 0."""
    x = img.to(torch.float32)
    lo = x.amin()
    return lo, (x.amax() - lo).clamp_min(_TINY)


def bin_levels(img: torch.Tensor, levels: int, lo, span) -> torch.Tensor:
    """Values -> int64 levels in [0, levels): ((x - lo) / span) * L, floor,
    clip, with IEEE float32 division by a tensor."""
    lo = torch.as_tensor(lo, dtype=torch.float32, device=img.device)
    span = torch.as_tensor(span, dtype=torch.float32, device=img.device)
    q = img.to(torch.float32) - lo
    q = torch.floor(torch.div(q, span) * levels)
    return q.clamp(0, levels - 1).to(torch.int64)


def _planes(lv: torch.Tensor, dy: int, dx: int):
    """(assoc, ref) views of the pairs inside the last two axes."""
    h, w = lv.shape[-2:]
    ys = slice(0, h - dy) if dy >= 0 else slice(-dy, h)
    yr = slice(dy, h) if dy >= 0 else slice(0, h + dy)
    xs = slice(0, w - dx) if dx >= 0 else slice(-dx, w)
    xr = slice(dx, w) if dx >= 0 else slice(0, w + dx)
    return lv[..., ys, xs], lv[..., yr, xr]


def counts(lv: torch.Tensor, levels: int, offs) -> torch.Tensor:
    """(H, W) int64 levels -> (n_off, L, L) int64 counts."""
    out = []
    for dy, dx in offs:
        a, r = _planes(lv, dy, dx)
        idx = (r * levels + a).reshape(-1)
        out.append(torch.bincount(idx, minlength=levels * levels).view(levels, levels))
    return torch.stack(out)


def window_counts(lv: torch.Tensor, levels: int, offs, size: int, stride: int,
                  rows: int = 16) -> torch.Tensor:
    """(H, W) int64 levels -> (gh, gw, n_off, L, L) int64 counts of every
    size x size window at ``stride``, pairs counted inside each window;
    ``rows`` grid rows at a time."""
    h, w = lv.shape
    gh, gw = (h - size) // stride + 1, (w - size) // stride + 1
    n_off, cells = len(offs), levels * levels
    out = torch.empty((gh, gw, n_off, levels, levels), dtype=torch.int64, device=lv.device)
    for g0 in range(0, gh, rows):
        g1 = min(gh, g0 + rows)
        strip = lv[g0 * stride:(g1 - 1) * stride + size]
        win = strip.unfold(0, size, stride).unfold(1, size, stride)  # (n, gw, size, size)
        n_win = (g1 - g0) * gw
        win = win.reshape(n_win, size, size)
        slot = torch.arange(n_win, device=lv.device)[:, None, None]
        parts = []
        for k, (dy, dx) in enumerate(offs):
            a, r = _planes(win, dy, dx)
            parts.append(((slot * n_off + k) * cells + r * levels + a).reshape(-1))
        block = torch.bincount(torch.cat(parts), minlength=n_win * n_off * cells)
        out[g0:g1] = block.view(g1 - g0, gw, n_off, levels, levels)
    return out


def _entropy(p: torch.Tensor, dim) -> torch.Tensor:
    return -torch.sum(p * torch.log(p + _EPS), dim=dim)


def features(mats: torch.Tensor, dtype=torch.float64, block: int = 1 << 14) -> torch.Tensor:
    """(..., L, L) counts -> (..., 14) Haralick features in ``dtype``,
    ``block`` matrices at a time.

    f1 ASM, f2 contrast, f3 correlation, f4 sum of squares, f5 inverse
    difference moment, f6 sum average, f7 sum variance, f8 sum entropy, f9
    entropy, f10 difference variance, f11 difference entropy, f12 and f13
    the information measures of correlation, f14 the maximal correlation
    coefficient (the square root of the second largest eigenvalue of
    A A^T, A = P / sqrt(px py)). Guards: probabilities are counts over
    their sum (at least 1e-12), logs of p + 1e-12, and f3 is 0 where a
    marginal sits on one level (no variance: 0/0).
    """
    lead = mats.shape[:-2]
    L = mats.shape[-1]
    flat = mats.reshape(-1, L, L)
    out = torch.empty((flat.shape[0], 14), dtype=dtype, device=mats.device)
    for s in range(0, flat.shape[0], block):
        out[s:s + block] = _features(flat[s:s + block].to(dtype))
    return out.reshape(*lead, 14)


def _features(c: torch.Tensor) -> torch.Tensor:
    n, L = c.shape[0], c.shape[-1]
    p = c / c.sum(dim=(1, 2), keepdim=True).clamp_min(_EPS)
    i = torch.arange(L, dtype=p.dtype, device=p.device)
    ii, jj = i[:, None], i[None, :]
    px, py = p.sum(dim=2), p.sum(dim=1)
    mu_x, mu_y = (i * px).sum(1), (i * py).sum(1)
    sd_x = torch.sqrt(((i - mu_x[:, None]) ** 2 * px).sum(1).clamp_min(0.0))
    sd_y = torch.sqrt(((i - mu_y[:, None]) ** 2 * py).sum(1).clamp_min(0.0))

    # p_{x+y}(k), k = 0..2L-2, and p_{x-y}(k), k = 0..L-1, by scatter of
    # the flattened matrix over the index sums and differences.
    li = torch.arange(L, device=p.device)
    s_idx = (li[:, None] + li[None, :]).reshape(-1)
    d_idx = (li[:, None] - li[None, :]).abs().reshape(-1)
    flat = p.reshape(n, -1)
    p_sum = torch.zeros(n, 2 * L - 1, dtype=p.dtype, device=p.device).index_add_(1, s_idx, flat)
    p_diff = torch.zeros(n, L, dtype=p.dtype, device=p.device).index_add_(1, d_idx, flat)

    both = (1, 2)
    f1 = (p * p).sum(both)
    f2 = ((ii - jj) ** 2 * p).sum(both)
    f3 = ((ii * jj * p).sum(both) - mu_x * mu_y) / (sd_x * sd_y).clamp_min(_EPS)
    d2 = (ii - jj) ** 2
    spread = (((px @ d2) * px).sum(1) > 0) & (((py @ d2) * py).sum(1) > 0)
    f3 = torch.where(spread, f3, torch.zeros_like(f3))
    mu = (p * ii).sum(both)
    f4 = ((ii - mu[:, None, None]) ** 2 * p).sum(both)
    f5 = (p / (1.0 + (ii - jj) ** 2)).sum(both)
    ks = torch.arange(2 * L - 1, dtype=p.dtype, device=p.device)
    f6 = (ks * p_sum).sum(1)
    f7 = ((ks - f6[:, None]) ** 2 * p_sum).sum(1)
    f8 = _entropy(p_sum, 1)
    f9 = _entropy(p, both)
    d_mean = (i * p_diff).sum(1)
    f10 = ((i - d_mean[:, None]) ** 2 * p_diff).sum(1)
    f11 = _entropy(p_diff, 1)
    hx, hy = _entropy(px, 1), _entropy(py, 1)
    outer = px[:, :, None] * py[:, None, :]
    hxy1 = -(p * torch.log(outer + _EPS)).sum(both)
    hxy2 = -(outer * torch.log(outer + _EPS)).sum(both)
    f12 = (f9 - hxy1) / torch.maximum(hx, hy).clamp_min(_EPS)
    f13 = torch.sqrt((1.0 - torch.exp(-2.0 * (hxy2 - f9))).clamp_min(0.0))
    a = p / torch.sqrt(px[:, :, None].clamp_min(_EPS) * py[:, None, :].clamp_min(_EPS))
    second = torch.linalg.eigvalsh(a @ a.transpose(1, 2))[:, -2]
    f14 = torch.sqrt(second.clamp_min(0.0))
    return torch.stack([f1, f2, f3, f4, f5, f6, f7, f8, f9, f10, f11, f12, f13, f14], dim=1)


def expected_features(img: torch.Tensor, cfg: dict, dtype=torch.float64) -> torch.Tensor:
    """The features one image of configuration ``cfg`` must give: (n_off,
    14) for whole images, (gh, gw, n_off, 14) for a texture map; each image
    binned over its own range."""
    levels, offs = cfg["levels"], offsets(cfg["pairs"])
    lv = bin_levels(img, levels, *image_range(img))
    if cfg["region"] == "global":
        c = counts(lv, levels, offs)
    else:
        c = window_counts(lv, levels, offs, cfg["region_shape"], cfg["region_stride"])
    return features(c, dtype)
