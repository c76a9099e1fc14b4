"""repro_torch.core.quantize against the JAX reference, bit for bit —
including values that sit exactly on bin edges."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import quantize as jq
from repro_torch.core import quantize as tq


def _edge_values(rng, shape, lo, span, levels):
    """f32 values in [lo, lo + span], a third of them exactly on bin edges."""
    x = (lo + rng.random(shape) * span).astype(np.float32)
    k = rng.integers(0, levels + 1, size=shape)
    edges = (np.float32(lo) + k.astype(np.float32) * np.float32(span / levels)).astype(np.float32)
    return np.where(rng.random(shape) < 1 / 3, edges, x).astype(np.float32)


@pytest.mark.parametrize("levels", [2, 8, 32, 256])
@pytest.mark.parametrize("lo,span", [(0.0, 255.0), (-3.5, 7.25), (10.0, 1e-3), (0.0, 1.0)])
def test_bin_values_scalar_range_bit_exact(levels, lo, span):
    rng = np.random.default_rng(levels)
    x = _edge_values(rng, (37, 29), lo, span, levels)
    want = np.asarray(jq.bin_values(jnp.asarray(x), levels, lo, span))
    got = tq.bin_values(torch.from_numpy(x), levels, lo, span).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("levels", [8, 32])
def test_bin_values_per_image_range_bit_exact(levels):
    rng = np.random.default_rng(7)
    x = np.stack([_edge_values(rng, (23, 19), lo, sp, levels)
                  for lo, sp in ((0.0, 255.0), (-1.0, 3.0), (5.0, 0.5))])
    lo, span = jq.uniform_params(jnp.asarray(x), batched=True)
    want = np.asarray(jq.bin_values(jnp.asarray(x), levels, lo[:, None, None],
                                    span[:, None, None]))
    tlo, tspan = tq.uniform_params(torch.from_numpy(x), batched=True)
    got = tq.bin_values(torch.from_numpy(x), levels, tlo[:, None, None], tspan[:, None, None])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("vmin,vmax", [(None, None), (0.0, None), (None, 200.0), (0.0, 255.0)])
@pytest.mark.parametrize("batched", [False, True])
def test_uniform_params_bit_exact(vmin, vmax, batched):
    rng = np.random.default_rng(3)
    x = (rng.random((3, 17, 13)) * 300 - 20).astype(np.float32)
    x[1] = 4.0  # a constant image: span floors at the smallest normal f32
    if not batched:
        x = x[0]
    want = jq.uniform_params(jnp.asarray(x), vmin=vmin, vmax=vmax, batched=batched)
    got = tq.uniform_params(torch.from_numpy(x), vmin=vmin, vmax=vmax, batched=batched)
    for g, w in zip(got, want):
        if isinstance(w, float):
            assert isinstance(g, float) and g == w
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.int32])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("vmin,vmax", [(None, None), (3.0, None), (None, 200.0)])
def test_uniform_params_integer_input_unchanged(dtype, batched, vmin, vmax):
    """Integer input is reduced in its own dtype, with no float32 copy of
    the image: (lo, span) are the same as those of the float32 reduction it
    replaces, and the reference's."""
    rng = np.random.default_rng(5)
    info = np.iinfo(dtype)
    x = rng.integers(max(int(info.min), -40000), min(int(info.max), 70000) + 1,
                     size=(3, 17, 13)).astype(dtype)
    if dtype == np.int32:
        x[0, 0, 0] = 2**30 + 1  # beyond the integers float32 holds exactly
    x[1] = 4  # a constant image: span floors at the smallest normal f32
    if not batched:
        x = x[0]
    got = tq.uniform_params(torch.from_numpy(x), vmin=vmin, vmax=vmax, batched=batched)
    old = tq.uniform_params(torch.from_numpy(x.astype(np.float32)), vmin=vmin, vmax=vmax,
                            batched=batched)
    want = jq.uniform_params(jnp.asarray(x), vmin=vmin, vmax=vmax, batched=batched)
    for g, o, w in zip(got, old, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == tuple(o.shape)
        np.testing.assert_array_equal(g.numpy(), o.numpy())
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_constant_image_span_floor():
    x = np.full((5, 5), 3.0, np.float32)
    lo, span = tq.uniform_params(torch.from_numpy(x))
    assert float(span) == float(np.finfo(np.float32).tiny)
    assert int(tq.quantize_uniform(torch.from_numpy(x), 8).max()) == 0


@pytest.mark.parametrize("levels", [2, 8, 32, 256])
@pytest.mark.parametrize("vrange", [None, (0, 255), (10, 100)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_quantize_uniform_bit_exact(levels, vrange, dtype):
    rng = np.random.default_rng(levels)
    x = rng.integers(0, 256, size=(31, 27)).astype(dtype)
    vmin, vmax = vrange if vrange else (None, None)
    want = np.asarray(jq.quantize_uniform(jnp.asarray(x), levels, vmin=vmin, vmax=vmax))
    got = tq.quantize_uniform(torch.from_numpy(x), levels, vmin=vmin, vmax=vmax).numpy()
    np.testing.assert_array_equal(got, want)


def test_identity_short_circuit():
    x = np.arange(256, dtype=np.uint8).reshape(16, 16)
    for dtype, want in ((torch.uint8, True), (torch.int32, False), (torch.float32, False)):
        assert tq.is_identity_quantize(dtype, 256, 0, 255) is want
    assert not tq.is_identity_quantize(torch.uint8, 128, 0, 255)
    assert not tq.is_identity_quantize(torch.uint8, 256, None, 255)
    assert not tq.is_identity_quantize(torch.uint8, 256, 0, 254)
    assert jq.is_identity_quantize(jnp.uint8, 256, 0, 255)
    got = tq.quantize_uniform(torch.from_numpy(x), 256, vmin=0, vmax=255)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), x.astype(np.int32))
    # the affine agrees with the cast it short-circuits
    lo, span = tq.uniform_params(torch.from_numpy(x), vmin=0, vmax=255)
    np.testing.assert_array_equal(tq.bin_values(torch.from_numpy(x), 256, lo, span).numpy(),
                                  x.astype(np.int32))


@pytest.mark.parametrize("levels", [2, 8, 32])
@pytest.mark.parametrize("kind", ["random", "smooth", "constant", "few_values"])
def test_quantize_equalized_bit_exact(levels, kind):
    rng = np.random.default_rng(11)
    if kind == "random":
        x = rng.integers(0, 256, size=(40, 33)).astype(np.uint8)
    elif kind == "smooth":
        x = np.cumsum(rng.normal(size=(40, 33)), axis=1).astype(np.float32)
    elif kind == "constant":
        x = np.full((12, 9), 7, np.uint8)
    else:
        x = rng.choice(np.array([3, 90, 200], np.uint8), size=(25, 25))
    want = np.asarray(jq.quantize_equalized(jnp.asarray(x), levels))
    got = tq.quantize_equalized(torch.from_numpy(x), levels).numpy()
    np.testing.assert_array_equal(got, want)


def test_assert_levels():
    for bad in (1, 257):
        with pytest.raises(ValueError):
            tq.assert_levels(bad)
    tq.assert_levels(2)
    tq.assert_levels(256)
