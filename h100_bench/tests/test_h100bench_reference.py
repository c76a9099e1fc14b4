"""The plain reference against brute-force loops at tiny sizes."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from h100_bench.reference import glcm as ref

PAIRS = [[1, 0], [1, 45], [4, 0], [4, 45]]


def brute_levels(img: np.ndarray, levels: int) -> np.ndarray:
    lo = np.float32(img.min())
    span = max(np.float32(img.max()) - lo, np.float32(np.finfo(np.float32).tiny))
    out = np.empty(img.shape, np.int64)
    for y in range(img.shape[0]):
        for x in range(img.shape[1]):
            q = np.float32(np.float32(img[y, x]) - lo) / np.float32(span)
            out[y, x] = min(max(math.floor(np.float32(q * np.float32(levels))), 0), levels - 1)
    return out


def brute_counts(lv: np.ndarray, levels: int, offs) -> np.ndarray:
    h, w = lv.shape
    out = np.zeros((len(offs), levels, levels), np.int64)
    for k, (dy, dx) in enumerate(offs):
        for y in range(h):
            for x in range(w):
                if 0 <= y + dy < h and 0 <= x + dx < w:
                    out[k, lv[y + dy, x + dx], lv[y, x]] += 1
    return out


def brute_features(c: np.ndarray) -> dict:
    p = c / c.sum()
    L = p.shape[0]
    f = {"f1": 0.0, "f2": 0.0, "f5": 0.0, "f9": 0.0}
    for i in range(L):
        for j in range(L):
            f["f1"] += p[i, j] ** 2
            f["f2"] += (i - j) ** 2 * p[i, j]
            f["f5"] += p[i, j] / (1 + (i - j) ** 2)
            f["f9"] -= p[i, j] * math.log(p[i, j] + 1e-12)
    f["f6"] = sum(k * p[i, j] for i in range(L) for j in range(L) for k in [i + j])
    px, py = p.sum(1), p.sum(0)
    a = p / np.sqrt(np.maximum(px, 1e-12)[:, None] * np.maximum(py, 1e-12)[None, :])
    f["f14"] = math.sqrt(max(np.linalg.eigvalsh(a @ a.T)[-2], 0.0))
    return f


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_binning_matches_a_loop(seed):
    img = np.random.default_rng(seed).integers(3, 250, size=(9, 11)).astype(np.uint8)
    got = ref.bin_levels(torch.from_numpy(img), 32, *ref.image_range(torch.from_numpy(img)))
    np.testing.assert_array_equal(got.numpy(), brute_levels(img, 32))


def test_offsets_follow_the_paper():
    assert ref.offsets(PAIRS) == [(0, 1), (1, -1), (0, 4), (4, -4)]


@pytest.mark.parametrize("shape", [(9, 11), (12, 7)])
def test_counts_match_a_double_loop(shape):
    lv = np.random.default_rng(3).integers(0, 5, size=shape)
    got = ref.counts(torch.from_numpy(lv), 5, ref.offsets(PAIRS))
    np.testing.assert_array_equal(got.numpy(), brute_counts(lv, 5, ref.offsets(PAIRS)))


def test_window_counts_match_a_loop_per_window():
    lv = np.random.default_rng(4).integers(0, 6, size=(24, 20))
    size, stride = 8, 4
    got = ref.window_counts(torch.from_numpy(lv), 6, ref.offsets(PAIRS), size, stride, rows=2)
    gh, gw = (24 - size) // stride + 1, (20 - size) // stride + 1
    assert got.shape == (gh, gw, 4, 6, 6)
    for gy in range(gh):
        for gx in range(gw):
            win = lv[gy * stride:gy * stride + size, gx * stride:gx * stride + size]
            np.testing.assert_array_equal(got[gy, gx].numpy(),
                                          brute_counts(win, 6, ref.offsets(PAIRS)))


@pytest.mark.parametrize("seed", [5, 6])
def test_features_match_loops(seed):
    c = np.random.default_rng(seed).integers(0, 40, size=(7, 7)).astype(np.float64)
    got = ref.features(torch.from_numpy(c)).numpy()
    want = brute_features(c)
    for name, col in (("f1", 0), ("f2", 1), ("f5", 4), ("f6", 5), ("f9", 8), ("f14", 13)):
        assert got[col] == pytest.approx(want[name], rel=1e-12, abs=1e-14), name


def test_features_of_a_constant_matrix_have_no_correlation():
    c = torch.zeros(2, 4, 4, dtype=torch.int64)
    c[:, 2, 2] = 100
    got = ref.features(c)
    assert torch.all(got[:, 2] == 0) and torch.isfinite(got).all()


def test_control_precision_is_float32():
    c = torch.randint(0, 50, (3, 8, 8))
    assert ref.features(c, torch.float32).dtype == torch.float32
    assert ref.features(c).dtype == torch.float64
