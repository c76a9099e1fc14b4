"""The reference's public surface in repro_torch: Scheme 1 on one image
(``core.schemes.glcm_scatter``), the 2-D oracles (``kernels.ref.pair_planes``,
``glcm_reference``, ``glcm_multi_reference``), ``data.images.volume_stream``
and the ``GLCMStreamPlan`` re-export of ``core.plan``, each held to
``repro`` on the same numpy inputs: counts bit for bit, arrays equal.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import schemes as jschemes
from repro.data import images as jimages
from repro.kernels import ref as jref
from repro_torch.core import plan as tplan
from repro_torch.core import schemes as tschemes
from repro_torch.core.stream_state import GLCMStreamPlan
from repro_torch.data import images as timages
from repro_torch.kernels import ref as tref

PAPER_PAIRS = ((1, 0), (1, 45), (4, 0), (4, 45))
ALL_PAIRS = PAPER_PAIRS + ((2, 90), (3, 135))

# Names of the reference's modules that the port leaves out on purpose:
# the XLA accumulator dtype policy (uint16 or int32 scatter accumulators).
# The port counts in exact integers whatever ``spec.accum`` says.
NOT_PORTED = {"repro.core.schemes": {"count_dtype", "vote_dtypes"}}


def _levels(shape, levels, seed=0):
    return np.random.default_rng(seed).integers(0, levels, size=shape).astype(np.int32)


def _raw(shape, seed=0):
    """Float32 intensities: a smooth field (conflict-heavy) in [0, 255]."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(np.cumsum(rng.normal(size=shape), axis=-1), axis=-2)
    return ((x - x.min()) / np.ptp(x) * 255.0).astype(np.float32)


@pytest.mark.parametrize("module", ["core.schemes", "kernels.ref", "data.images", "core.plan"])
def test_public_names_match_reference(module):
    ref = importlib.import_module(f"repro.{module}")
    port = importlib.import_module(f"repro_torch.{module}")
    missing = set(ref.__all__) - set(port.__all__) - NOT_PORTED.get(ref.__name__, set())
    assert not missing
    assert all(hasattr(port, name) for name in port.__all__)


def test_plan_reexports_stream_plan():
    assert tplan.GLCMStreamPlan is GLCMStreamPlan
    from repro.core.plan import GLCMStreamPlan as JaxStreamPlan
    assert JaxStreamPlan.__name__ == tplan.GLCMStreamPlan.__name__


@pytest.mark.parametrize("levels", [8, 32])
@pytest.mark.parametrize("d,theta", ALL_PAIRS)
@pytest.mark.parametrize("symmetric,normalize", [(False, False), (True, False), (True, True)])
def test_glcm_scatter_one_image_equals_reference(levels, d, theta, symmetric, normalize):
    img = _levels((37, 41), levels, seed=levels + d)
    want = np.asarray(jschemes.glcm_scatter(jnp.asarray(img), levels, d, theta,
                                            symmetric=symmetric, normalize=normalize))
    got = tschemes.glcm_scatter(torch.from_numpy(img), levels, d, theta,
                                symmetric=symmetric, normalize=normalize)
    assert got.dtype == torch.float32 and got.shape == (levels, levels)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("batched", [False, True])
def test_glcm_scatter_quantized_equals_reference(batched):
    """Raw pixels binned on the pair planes: python-float ranges for one
    image, per-image (B,) ranges for a stack."""
    x = _raw((3, 33, 29), seed=5)
    if not batched:
        x = x[0]
    axes = tuple(range(x.ndim - 2, x.ndim))
    lo = x.min(axis=axes)
    span = np.maximum(x.max(axis=axes) - lo, np.float32(1e-6))
    tq = (float(lo), float(span)) if not batched else (torch.from_numpy(lo),
                                                        torch.from_numpy(span))
    jq = (float(lo), float(span)) if not batched else (jnp.asarray(lo), jnp.asarray(span))
    for d, theta in PAPER_PAIRS:
        want = np.asarray(jschemes.glcm_scatter(jnp.asarray(x), 32, d, theta, quant=jq))
        got = tschemes.glcm_scatter(torch.from_numpy(x), 32, d, theta, quant=tq)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("offset", [(0, 1), (2, -3), (1, 0, 1), (1, -1, -1), (2, 1, 0)])
def test_glcm_scatter_offset_and_batch_equal_reference(offset):
    shape = (2, 9, 11, 13) if len(offset) == 3 else (3, 17, 19)
    x = _levels(shape, 8, seed=len(offset))
    want = np.asarray(jschemes.glcm_scatter(jnp.asarray(x), 8, offset=offset, normalize=True))
    got = tschemes.glcm_scatter(torch.from_numpy(x), 8, offset=offset, normalize=True)
    assert got.shape == (shape[0], 8, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="offset must be"):
        tschemes.glcm_scatter(torch.from_numpy(x), 8, offset=(1,))


@pytest.mark.parametrize("shape", [(13, 17), (2, 13, 17), (2, 3, 13, 17)])
@pytest.mark.parametrize("d,theta", ALL_PAIRS)
def test_pair_planes_equal_reference(shape, d, theta):
    img = _levels(shape, 256, seed=d)
    ja, jr = jref.pair_planes(jnp.asarray(img), d, theta)
    ta, tr = tref.pair_planes(torch.from_numpy(img), d, theta)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_pair_planes_rejects_what_the_reference_rejects():
    for bad, args in ((np.zeros(5, np.int32), (1, 0)), (np.zeros((4, 4), np.int32), (4, 0)),
                      (np.zeros((4, 4), np.int32), (1, 30))):
        with pytest.raises(ValueError):
            jref.pair_planes(jnp.asarray(bad), *args)
        with pytest.raises(ValueError):
            tref.pair_planes(torch.from_numpy(bad), *args)


@pytest.mark.parametrize("levels", [8, 32, 256])
@pytest.mark.parametrize("symmetric,normalize", [(False, False), (True, False), (False, True)])
def test_glcm_reference_equals_reference(levels, symmetric, normalize):
    img = _levels((31, 27), levels, seed=levels)
    for d, theta in ALL_PAIRS:
        want = np.asarray(jref.glcm_reference(jnp.asarray(img), levels, d, theta,
                                              symmetric=symmetric, normalize=normalize))
        got = tref.glcm_reference(torch.from_numpy(img), levels, d, theta,
                                  symmetric=symmetric, normalize=normalize)
        np.testing.assert_array_equal(got.numpy(), want)


def test_glcm_multi_reference_equals_reference():
    img = _levels((29, 23), 16, seed=3)
    want = np.asarray(jref.glcm_multi_reference(jnp.asarray(img), 16, ALL_PAIRS, symmetric=True))
    got = tref.glcm_multi_reference(torch.from_numpy(img), 16, ALL_PAIRS, symmetric=True)
    assert got.shape == (len(ALL_PAIRS), 16, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    # the oracle and Scheme 1 agree
    for k, (d, t) in enumerate(ALL_PAIRS):
        one = tschemes.glcm_scatter(torch.from_numpy(img), 16, d, t, symmetric=True)
        np.testing.assert_array_equal(one.numpy(), got[k].numpy())


@pytest.mark.parametrize("kind", ["smooth", "random"])
@pytest.mark.parametrize("shape,count,seed", [((9, 20, 18), 3, 0), (16, 2, 5)])
def test_volume_stream_equals_reference(kind, shape, count, seed):
    got = list(timages.volume_stream(kind, shape, count, seed=seed))
    want = list(jimages.volume_stream(kind, shape, count, seed=seed))
    assert len(got) == len(want) == count
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
    with pytest.raises(KeyError):
        next(timages.volume_stream("noisy", shape, 1))


def test_glcm_scatter_drops_pad_votes_where_reference_wraps():
    """A level outside [0, L) (the -1 pad) never votes in the port, as in
    every kernel; the reference's scatter wraps it into another cell."""
    img = np.array([[0, 1, -1, 2], [3, 1, 2, 0]], np.int32)
    got = tschemes.glcm_scatter(torch.from_numpy(img), 4, 1, 0).numpy()
    valid = [(a, r) for row in img for a, r in zip(row[:-1], row[1:]) if a >= 0 and r >= 0]
    want = np.zeros((4, 4), np.float32)
    for a, r in valid:
        want[r, a] += 1
    np.testing.assert_array_equal(got, want)
    ref = np.asarray(jschemes.glcm_scatter(jnp.asarray(img), 4, 1, 0))
    assert ref.sum() == got.sum() + 2  # both pad pairs voted somewhere
