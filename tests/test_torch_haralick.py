"""repro_torch.core.haralick against the JAX reference.

Tolerances: f1–f13 within rtol 1e-5 and atol 1e-6; f14 within atol 1e-4,
since it comes from a different eigen-solver (and the reference's own
float32 features move by up to 1.9e-6 between program shapes).

The reference runs in float64 (``jax.enable_x64``) on the same counts: its
formulas are unchanged, but in float32 several features (f3, f9, f12, f13)
are differences of nearly equal sums whose rounding error alone exceeds
rtol 1e-5 at L = 32. The port computes in float64 and rounds once to
float32, so it is held to the reference's formulas, not to its rounding.
"""

import jax
import jax.numpy as jnp
from jax import experimental as jax_experimental
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import haralick as jh
from repro_torch.core import haralick as th
from repro_torch.kernels import mcc_kernel
from repro_torch.obs.trace import Tracer, set_tracer

RTOL, ATOL, F14_ATOL = 1e-5, 1e-6, 1e-4


def _assert_features_close(got, want, select=None):
    names = select or th.FEATURE_NAMES
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    for k, name in enumerate(names):
        if name == "max_correlation_coefficient":
            np.testing.assert_allclose(got[..., k], want[..., k], rtol=0, atol=F14_ATOL,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(got[..., k], want[..., k], rtol=RTOL, atol=ATOL,
                                       err_msg=name)


def _x64():
    """A context in which JAX computes in float64: ``jax.experimental.enable_x64``
    where it exists (older JAX), else ``jax.enable_x64``."""
    legacy = getattr(jax_experimental, "enable_x64", None)
    return legacy() if legacy is not None else jax.enable_x64(True)


def reference_features(counts, select=None, assume_normalized=False):
    """repro.core.haralick evaluated in float64, rounded to float32."""
    with _x64():
        f = jh.haralick_features(jnp.asarray(np.asarray(counts, np.float64)), select=select,
                                 assume_normalized=assume_normalized)
        return np.asarray(f).astype(np.float32)


def _glcm_counts(rng, levels, kind, n=3):
    """(n, L, L) count matrices: iid counts, or co-occurrences of smooth images."""
    if kind == "random":
        return rng.integers(0, 50, size=(n, levels, levels)).astype(np.float32)
    if kind == "sparse":
        m = rng.integers(0, 50, size=(n, levels, levels)) * (rng.random((n, levels, levels)) < 0.2)
        m[:, 0, 0] += 1
        return m.astype(np.float32)
    out = np.zeros((n, levels, levels), np.float32)
    for i in range(n):
        base = np.cumsum(rng.normal(size=(48, 48)), axis=1)
        base += np.cumsum(rng.normal(size=(48, 48)), axis=0)
        q = np.floor((base - base.min()) / (np.ptp(base) + 1e-9) * levels).clip(0, levels - 1)
        q = q.astype(np.int64)
        np.add.at(out[i], (q[1:, :-1], q[:-1, 1:]), 1)  # 45° pairs: out[ref, assoc]
    return out


@pytest.mark.parametrize("levels", [2, 8, 32])
@pytest.mark.parametrize("kind", ["random", "sparse", "smooth"])
def test_features_match_reference(levels, kind):
    rng = np.random.default_rng(levels)
    counts = _glcm_counts(rng, levels, kind)
    want = reference_features(counts)
    got = th.haralick_features(torch.from_numpy(counts))
    _assert_features_close(got.numpy(), want)


@pytest.mark.parametrize("select", [
    ("contrast",),
    ("entropy", "asm_energy"),
    ("max_correlation_coefficient", "correlation"),
    ("info_correlation_2", "sum_variance", "difference_entropy"),
])
def test_select_matches_reference(select):
    rng = np.random.default_rng(1)
    counts = _glcm_counts(rng, 8, "smooth", n=2)
    want = reference_features(counts, select=select)
    got = th.haralick_features(torch.from_numpy(counts), select=select)
    _assert_features_close(got.numpy(), want, select)


def test_symmetric_normalized_and_batched_shapes():
    rng = np.random.default_rng(2)
    counts = _glcm_counts(rng, 8, "random", n=6).reshape(2, 3, 8, 8)
    sym = counts + np.swapaxes(counts, -1, -2)
    p = sym / sym.sum(axis=(-2, -1), keepdims=True)
    want = reference_features(p, assume_normalized=True)
    got = th.haralick_features(torch.from_numpy(p.astype(np.float32)), assume_normalized=True)
    assert tuple(got.shape) == (2, 3, 14)
    _assert_features_close(got.numpy(), want)


def test_unknown_feature_names_raise():
    with pytest.raises(ValueError, match="unknown Haralick feature"):
        th.haralick_features(torch.ones(4, 4), select=("texture",))
    with pytest.raises(ValueError, match="names no features"):
        th.haralick_features(torch.ones(4, 4), select=())
    assert th.FEATURE_NAMES == jh.FEATURE_NAMES


def test_normalize_glcm_matches_reference():
    rng = np.random.default_rng(3)
    counts = _glcm_counts(rng, 8, "random")
    np.testing.assert_allclose(th.normalize_glcm(torch.from_numpy(counts)).numpy(),
                               np.asarray(jh.normalize_glcm(jnp.asarray(counts))),
                               rtol=1e-6, atol=0)


@pytest.fixture
def one_thread():
    """Bit-for-bit comparisons on one intra-op thread: a threaded BLAS or
    LAPACK call may split its sums differently from one call to the next
    on a busy host, and two calls then differ in their last bits."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("levels", [8, 40])
def test_f14_in_chunks_matches_reference(monkeypatch, one_thread, levels):
    # f14's plain eigensolve runs in chunks of matrices (cuSOLVER refuses a
    # texture map's whole batch); a ragged last chunk must not change any
    # feature. L = 8 reaches it through the wrapper's CPU branch, L = 40
    # directly.
    rng = np.random.default_rng(4)
    counts = _glcm_counts(rng, levels, "random", n=7)
    whole = th.haralick_features(torch.from_numpy(counts))
    monkeypatch.setattr(mcc_kernel, "EIG_CHUNK_ELEMENTS", 3 * levels * levels)
    calls = []
    eigvalsh = torch.linalg.eigvalsh
    monkeypatch.setattr(torch.linalg, "eigvalsh", lambda g: calls.append(len(g)) or eigvalsh(g))
    chunked = th.haralick_features(torch.from_numpy(counts))
    assert calls == [3, 3, 1]
    np.testing.assert_array_equal(chunked.numpy(), whole.numpy())
    _assert_features_close(chunked.numpy(), reference_features(counts))


def _todays_f14(counts):
    """f14 as the port computed it before its kernel: A, A Aᵀ and one
    eigvalsh over the whole batch, on the CPU."""
    p = th.normalize_glcm(torch.from_numpy(counts).to(torch.float64))
    px, py = p.sum(dim=2), p.sum(dim=1)
    a = p / torch.sqrt(px[:, :, None].clamp_min(1e-12) * py[:, None, :].clamp_min(1e-12))
    second = torch.linalg.eigvalsh(a @ a.transpose(-1, -2))[:, -2]
    return p, px, py, second


@pytest.mark.parametrize("levels", [2, 8, 32, 40])
@pytest.mark.parametrize("kind", ["random", "sparse", "smooth"])
def test_f14_on_the_cpu_is_todays_formula_bit_for_bit(one_thread, levels, kind):
    """The wrapper's CPU branch (L <= 32) and the plain version (L = 40)
    give the former formula's λ₂ and f14 exactly."""
    assert mcc_kernel._EPS == th._EPS  # the same clamp of the marginals
    counts = _glcm_counts(np.random.default_rng(levels + 5), levels, kind, n=5)
    p, px, py, want = _todays_f14(counts)
    assert torch.equal(mcc_kernel.second_eigenvalue(p, px, py), want)
    assert torch.equal(mcc_kernel.second_eigenvalue_plain(p, px, py), want)
    f14 = th.haralick_features(torch.from_numpy(counts),
                               select=("max_correlation_coefficient",))[:, 0]
    assert torch.equal(f14, torch.sqrt(want.clamp_min(0.0)).to(torch.float32))


def test_f14_routes_by_width(monkeypatch):
    """``_features`` calls the wrapper at L = 32 and L = 40 (the kernels'
    widths) and the plain version past ``MAX_LEVELS``; on the CPU every
    span reads ``solver="eigvalsh"`` with its ``chunks``."""
    calls = []
    wrapper = mcc_kernel.second_eigenvalue
    monkeypatch.setattr(mcc_kernel, "second_eigenvalue",
                        lambda p, px, py: calls.append(p.shape[-1]) or wrapper(p, px, py))
    tracer = Tracer(enabled=True)
    prev = set_tracer(tracer)
    try:
        monkeypatch.setattr(mcc_kernel, "MAX_LEVELS", 36)
        for levels in (32, 40):
            counts = _glcm_counts(np.random.default_rng(levels), levels, "random", n=2)
            th.haralick_features(torch.from_numpy(counts))
        monkeypatch.setattr(mcc_kernel, "MAX_LEVELS", 1024)
        counts = _glcm_counts(np.random.default_rng(40), 40, "random", n=2)
        th.haralick_features(torch.from_numpy(counts))
    finally:
        set_tracer(prev)
    assert calls == [32, 40]
    spans = [s for s in tracer.spans() if s.name == "haralick.eigvalsh"]
    assert [s.attrs for s in spans] == [{"matrices": 2, "solver": "eigvalsh", "chunks": 1}] * 3


def test_correlation_of_a_single_level_marginal_is_zero():
    # Every pair's reference level is 3 (a marginal with no variance): f3 is
    # 0/0, taken as 0 exactly rather than as rounding noise over the guard;
    # the other features still follow the reference.
    counts = np.zeros((2, 8, 8), np.float32)
    counts[0, 3, [1, 2, 5]] = (7, 11, 13)
    counts[1] = counts[0].T
    got = th.haralick_features(torch.from_numpy(counts)).numpy()
    np.testing.assert_array_equal(got[:, 2], 0.0)
    want = reference_features(counts)
    keep = [k for k in range(14) if k != 2]
    _assert_features_close(got[:, keep], want[:, keep],
                           select=tuple(th.FEATURE_NAMES[k] for k in keep))
