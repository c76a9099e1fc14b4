"""The level histogram and the one-hot class count of repro_torch against the
JAX reference.

The port's ``histogram`` (on the CPU, its plain version) is held count for
count to ``histogram_pallas`` in interpret mode, over input dtypes, -1 pads,
values outside [0, L) and ragged lengths; on an empty input the port
gives zeros where the reference refuses the empty grid. ``onehot_count``
is held to ``repro``'s within rtol 1e-6 (float32 sums in another order),
with and without weights and with leading axes. On negative values the
reference's oracle and its kernel disagree (JAX wraps a negative scatter
index); the port's oracle follows the kernel, and a test pins that. The
``cuda`` test holds the kernel to its plain version on the card and skips
where there is none.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import histogram as ops_histogram
from repro_torch.kernels import onehot_count
from repro_torch.kernels import ref
from repro_torch.kernels.histogram_kernel import histogram, histogram_plain

try:  # the reference needs JAX, which a machine with a card may not have
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels.histogram_kernel import histogram_pallas
except ImportError:
    jnp = None


@pytest.fixture(autouse=True)
def _reference(request):
    if jnp is None and "cuda" not in request.keywords:
        pytest.skip("needs JAX to run the reference")


def _values(rng, n, levels, dtype):
    """Values mostly in [0, L), with -1 pads and values outside [0, L) on
    both sides where the dtype holds them; floats carry fractions, negative
    ones included (they truncate toward zero)."""
    info = np.iinfo(dtype) if np.issubdtype(dtype, np.integer) else None
    lo = -3 if info is None else max(-3, int(info.min))
    hi = levels + 3 if info is None else min(levels + 3, int(info.max) + 1)
    v = rng.integers(lo, hi, size=n)
    if lo < 0:
        v[::7] = -1
    if info is None:
        return (v + rng.choice([0.0, 0.25, 0.5, 0.99], size=n)).astype(dtype)
    return v.astype(dtype)


def _pallas(v, levels, **kw):
    return np.asarray(histogram_pallas(jnp.asarray(v), levels=levels, interpret=True, **kw))


@pytest.mark.parametrize("dtype", [np.int8, np.uint8, np.int32, np.float32])
@pytest.mark.parametrize("levels", [1, 8, 32, 100])
@pytest.mark.parametrize("n", [1, 2047, 4097])
def test_histogram_equals_pallas(dtype, levels, n):
    rng = np.random.default_rng(levels * 31 + n)
    v = _values(rng, n, levels, dtype)
    want = _pallas(v, levels)
    got = ops_histogram(torch.from_numpy(v), levels)
    assert got.dtype == torch.int32 and got.shape == (levels,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(histogram_plain(torch.from_numpy(v), levels).numpy(), want)


@pytest.mark.parametrize("chunk,copies", [(2048, 4), (64, 1), (96, 3)])
def test_histogram_chunk_copies_and_shape(chunk, copies):
    rng = np.random.default_rng(chunk)
    v = rng.integers(-2, 18, size=(3, 5, 41)).astype(np.int32)
    want = _pallas(v, 16, chunk=chunk, copies=copies)
    got = histogram(torch.from_numpy(v), levels=16, chunk=chunk, copies=copies)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum() == ((v >= 0) & (v < 16)).sum()


def test_histogram_empty_input():
    """An empty input counts nothing. The reference's Pallas grid has no
    step to run then and refuses it; the port returns zeros."""
    for dtype in (torch.int32, torch.float32):
        got = ops_histogram(torch.empty(0, dtype=dtype), 8)
        assert torch.equal(got, torch.zeros(8, dtype=torch.int32))
    with pytest.raises(TypeError):
        _pallas(np.zeros(0, np.int32), 8)


def test_histogram_int64_input():
    v = np.array([0, 1, 1, 5, 7, -1, 8, 3], np.int64)
    np.testing.assert_array_equal(ops_histogram(torch.from_numpy(v), 8).numpy(),
                                  _pallas(v.astype(np.int32), 8))


def test_histogram_rejects_bad_arguments():
    v = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError, match="divisible"):
        ops_histogram(v, 8, chunk=10, copies=4)
    with pytest.raises(ValueError, match="divisible"):
        histogram_pallas(jnp.zeros(10, jnp.int32), levels=8, chunk=10, copies=4)
    with pytest.raises(ValueError, match=">= 1"):
        ops_histogram(v, 0)
    with pytest.raises(ValueError, match=">= 1"):
        ops_histogram(v, 8, copies=0)


def test_cpu_histogram_counts_no_launch():
    before = histogram.launches
    ops_histogram(torch.arange(10), 4)
    assert histogram.launches == before


def test_oracle_follows_the_kernel_on_negatives():
    """On -1 and other negatives ``repro``'s oracle wraps the index (JAX's
    negative-index scatter) while its kernel drops the value; the port's
    oracle equals the kernel."""
    v = np.array([0, 1, -1, -1, 3, 4, 7, -5, 2.7], np.float32)
    kernel = _pallas(v, 4)
    jax_oracle = np.asarray(jref.histogram_reference(jnp.asarray(v), 4))
    port_oracle = ref.histogram_reference(torch.from_numpy(v), 4)
    np.testing.assert_array_equal(kernel, [1, 1, 1, 1])
    np.testing.assert_array_equal(jax_oracle, [1, 1, 1, 3])
    np.testing.assert_array_equal(port_oracle.numpy(), kernel)
    # The same split for the one-hot class count's oracle.
    idx = np.array([[0, 2, -1, 3]])
    assert np.asarray(jref.onehot_count_reference(jnp.asarray(idx), 4))[0, 3] == 2
    np.testing.assert_array_equal(ref.onehot_count_reference(torch.from_numpy(idx), 4).numpy(),
                                  np.asarray(jops.onehot_count(jnp.asarray(idx), 4)))


def test_oracle_equals_pallas_in_range():
    rng = np.random.default_rng(5)
    v = rng.integers(0, 32, size=1000)
    np.testing.assert_array_equal(ref.histogram_reference(torch.from_numpy(v), 32).numpy(),
                                  np.asarray(jref.histogram_reference(jnp.asarray(v), 32)))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("shape", [(9,), (4, 7, 5)])
def test_onehot_count_equals_reference(weighted, shape):
    rng = np.random.default_rng(len(shape))
    idx = rng.integers(-1, 17, size=shape)
    w = rng.normal(size=shape).astype(np.float32) if weighted else None
    want = np.asarray(jops.onehot_count(jnp.asarray(idx), 16,
                                        None if w is None else jnp.asarray(w)))
    got = onehot_count(torch.from_numpy(idx), 16, None if w is None else torch.from_numpy(w))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape[:-1] + (16,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    oracle = ref.onehot_count_reference(torch.from_numpy(idx), 16,
                                        None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_histogram_equals_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    before = histogram.launches
    launched = 0
    for levels in (1, 8, 32, 256, 4096, 65536):
        for dtype in (np.int8, np.uint8, np.int32, np.int64, np.float32):
            v = torch.from_numpy(_values(rng, 100_003, levels, dtype)).to(dev)
            for chunk, copies in ((2048, 4), (96, 3)):
                got = histogram(v, levels=levels, chunk=chunk, copies=copies)
                assert torch.equal(got, histogram_plain(v, levels)), (levels, dtype, copies)
                launched += 1
    empty = histogram(torch.empty(0, dtype=torch.int32, device=dev), levels=8)
    assert torch.equal(empty, torch.zeros(8, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    assert histogram.launches == before + launched
