"""repro_torch's public API end to end on the CPU, against the JAX reference.

Counts are held exactly equal to ``repro``'s; features within rtol 1e-5 /
atol 1e-6 (f14 atol 1e-4) of the reference's formulas evaluated in float64
on the reference's own counts (see test_torch_haralick.py for why float64).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.glcm import glcm as jax_glcm
from repro.core.plan import compile_plan as jax_compile_plan
from repro.core.plan import plan_cache_stats as jax_plan_cache_stats
from repro.core.spec import GLCMSpec as JaxSpec
from repro_torch.core import backends
from repro_torch.core import plan as tplan
from repro_torch.core.glcm import glcm, glcm_features
from repro_torch.core.spec import GLCMSpec
from test_torch_haralick import reference_features

ROOT = Path(__file__).resolve().parents[1]
PAPER_PAIRS = ((1, 0), (1, 45), (4, 0), (4, 45))
SCHEMES = ("auto", "scatter", "onehot", "cuda", "cuda_fused")
RTOL, ATOL, F14_ATOL = 1e-5, 1e-6, 1e-4


def _images(levels, batched, raw, seed=0):
    """(3, 67, 61) or (67, 61): smooth and random textures. ``raw`` gives
    float32 intensities to quantize; else int32 levels in [0, L)."""
    rng = np.random.default_rng(seed + levels)
    imgs = []
    for i in range(3):
        if i == 1:
            base = rng.random((67, 61)) * 255.0
        else:
            base = np.cumsum(rng.normal(size=(67, 61)), axis=1)
            base += np.cumsum(rng.normal(size=(67, 61)), axis=0)
            base = (base - base.min()) / np.ptp(base) * 255.0
        imgs.append(base.astype(np.float32))
    x = np.stack(imgs)
    if not raw:
        x = np.floor(x / 256.0 * levels).astype(np.int32)
    return x if batched else x[0]


def _features_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got[..., :13], want[..., :13], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[..., 13], want[..., 13], rtol=0, atol=F14_ATOL)


@pytest.mark.parametrize("levels", [8, 32])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("quantize", [None, "uniform"])
def test_glcm_counts_equal_reference(levels, batched, quantize):
    img = _images(levels, batched, raw=quantize is not None)
    for d, theta in PAPER_PAIRS:
        want = np.asarray(jax_glcm(jnp.asarray(img), levels, d, theta, quantize=quantize))
        for scheme in SCHEMES:
            got = glcm(img, levels, d, theta, quantize=quantize, scheme=scheme, device="cpu")
            # Count-only results keep exact int32 counts (the reference: float32).
            assert got.dtype == torch.int32 and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{scheme} {d},{theta}")


@pytest.mark.parametrize("levels", [8, 32])
@pytest.mark.parametrize("symmetric,normalize", [(True, False), (False, True), (True, True)])
def test_glcm_symmetric_normalize(levels, symmetric, normalize):
    img = _images(levels, True, raw=True)
    want = np.asarray(jax_glcm(jnp.asarray(img), levels, 1, 45, quantize="uniform",
                               symmetric=symmetric, normalize=normalize))
    for scheme in ("auto", "cuda"):
        got = glcm(img, levels, 1, 45, quantize="uniform", symmetric=symmetric,
                   normalize=normalize, scheme=scheme, device="cpu").numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("levels", [8, 32])
@pytest.mark.parametrize("batched", [False, True])
def test_glcm_features_equal_reference(levels, batched):
    img = _images(levels, batched, raw=True)
    shape = tuple(img.shape)
    jspec = JaxSpec(levels=levels, pairs=PAPER_PAIRS, quantize="uniform")
    want_counts = np.asarray(jax_compile_plan(jspec, shape)(jnp.asarray(img)))
    want = reference_features(want_counts)
    spec = GLCMSpec.from_dict(dataclasses.asdict(jspec))
    for scheme in SCHEMES:
        counts = tplan.compile_plan(spec.replace(scheme=scheme), shape, device="cpu")(img)
        np.testing.assert_array_equal(counts.numpy(), want_counts, err_msg=scheme)
        got = glcm_features(img, levels, scheme=scheme, device="cpu")
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        _features_close(got.numpy(), want)


def test_glcm_features_select_and_quantize_modes():
    img = _images(8, True, raw=True)
    select = ("contrast", "max_correlation_coefficient", "entropy")
    jspec = JaxSpec(levels=8, pairs=PAPER_PAIRS, quantize="equalized")
    counts = np.asarray(jax_compile_plan(jspec, img.shape)(jnp.asarray(img)))
    spec = GLCMSpec.from_dict(dataclasses.asdict(jspec))
    np.testing.assert_array_equal(
        tplan.compile_plan(spec, img.shape, device="cpu")(img).numpy(), counts)
    want = reference_features(counts, select=select)
    got = glcm_features(img, 8, quantize="equalized", select=select, device="cpu")
    np.testing.assert_allclose(got.numpy()[..., [0, 2]], want[..., [0, 2]], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy()[..., 1], want[..., 1], rtol=0, atol=F14_ATOL)


def test_identity_quantize_plan():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(2, 40, 33)).astype(np.uint8)
    jspec = JaxSpec(levels=256, pairs=PAPER_PAIRS, quantize="uniform", vrange=(0, 255))
    want = np.asarray(jax_compile_plan(jspec, img.shape)(jnp.asarray(img)))
    spec = GLCMSpec.from_dict(dataclasses.asdict(jspec))
    for scheme in ("auto", "cuda", "cuda_fused", "scatter"):
        p = tplan.compile_plan(spec.replace(scheme=scheme), img.shape, device="cpu")
        assert p.fused_quantize
        np.testing.assert_array_equal(p(img).numpy(), want)


def test_volume_glcm_on_cpu():
    rng = np.random.default_rng(4)
    vol = rng.integers(0, 8, size=(2, 6, 11, 9)).astype(np.int32)
    for direction in (0, 4, 8, 12):
        want = np.asarray(jax_glcm(jnp.asarray(vol), 8, 1, direction, ndim=3))
        for scheme in ("auto", "scatter", "cuda"):
            got = glcm(vol, 8, 1, direction, ndim=3, scheme=scheme, device="cpu")
            np.testing.assert_array_equal(got.numpy(), want)


def test_auto_resolves_per_device():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    one = GLCMSpec(levels=8)
    many = GLCMSpec(levels=8, pairs=PAPER_PAIRS)
    assert backends.resolve_scheme(one, cpu) == "onehot"
    assert backends.resolve_scheme(many, cpu) == "onehot"
    assert backends.resolve_scheme(one, cuda) == "cuda"
    assert backends.resolve_scheme(many, cuda) == "cuda_fused"
    assert backends.resolve_scheme(many.replace(scheme="scatter"), cuda) == "scatter"
    assert backends.resolve_scheme(GLCMSpec(levels=8, pairs=((1, 4),), ndim=3),
                                   cuda) == "cuda_volume"
    assert tplan.compile_plan(many, (2, 9, 9), device="cpu").spec.scheme == "onehot"
    assert tplan.compile_plan(one, (9, 9), device="cpu").spec.scheme == "onehot"
    assert backends.available_backends() == (
        "blocked", "cuda", "cuda_fused", "cuda_volume", "native", "onehot", "scatter")


def test_plan_cache_hits_and_misses():
    limit = tplan.plan_cache_limit()
    tplan.plan_cache_clear()
    try:
        spec = GLCMSpec(levels=8, pairs=PAPER_PAIRS)
        p1 = tplan.compile_plan(spec, (2, 16, 16), device="cpu")
        p2 = tplan.compile_plan(spec, (2, 16, 16), device="cpu")
        assert p1 is p2
        tplan.compile_plan(spec, (16, 16), device="cpu")
        tplan.compile_plan(spec, (2, 16, 16), features=True, device="cpu")
        stats = tplan.plan_cache_stats()
        assert (stats["hits"], stats["misses"], stats["size"]) == (1, 3, 3)
        assert stats["hit_rate"] == pytest.approx(0.25)
        tplan.plan_cache_limit(2)
        assert tplan.plan_cache_stats()["evictions"] == 1
        assert tplan.compile_plan(spec, (2, 16, 16), device="cpu") is not p1  # evicted
        with pytest.raises(ValueError):
            tplan.plan_cache_limit(0)
    finally:
        tplan.plan_cache_limit(limit)
        tplan.plan_cache_clear()
    assert set(tplan.plan_cache_stats()) == set(jax_plan_cache_stats())


def test_entry_points_default_to_cuda():
    img = np.zeros((9, 9), np.int32)
    if torch.cuda.is_available():
        assert glcm(img, 8).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        glcm(img, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        glcm_features(img.astype(np.float32), 8)
    with pytest.raises(RuntimeError):
        tplan.compile_plan(GLCMSpec(levels=8), (9, 9))


def test_later_slices_raise_not_implemented():
    """Every slice of the port has come: none raises NotImplementedError."""
    spec = GLCMSpec(levels=8)
    # Temporal streams came with their slice: a stream plan compiles.
    stream = tplan.compile_plan(spec, (9, 9), device="cpu", temporal_window=4)
    assert stream.window == 4 and stream.shape == (9, 9)
    # The plan-contract analyzer came with its slice: a linted plan is clean.
    assert tplan.compile_plan(spec, (9, 9), device="cpu", check="lint").lint == ()
    # Regions came with their slice: a tiles plan compiles, with its grid.
    p = tplan.compile_plan(spec.replace(region="tiles", region_shape=3), (9, 9), device="cpu")
    assert p.grid == (3, 3)
    with pytest.raises(ValueError, match="check mode"):
        tplan.compile_plan(spec, (9, 9), device="cpu", check="strict")


def test_plan_input_checks_and_inputs():
    img = _images(8, True, raw=False)
    p = tplan.compile_plan(GLCMSpec(levels=8, pairs=PAPER_PAIRS), img.shape, device="cpu")
    np.testing.assert_array_equal(p(img).numpy(), p(torch.from_numpy(img)).numpy())
    with pytest.raises(ValueError, match="compiled for shape"):
        p(img[:, :-1])
    with pytest.raises(ValueError, match="exceeds input shape"):
        tplan.compile_plan(GLCMSpec(levels=8, pairs=((4, 90),)), (4, 9), device="cpu")
    with pytest.raises(ValueError, match="expected"):
        glcm(np.zeros((2, 2, 3, 3)), 8, device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        tplan.compile_plan(GLCMSpec(levels=8), (9, 9), device="meta")


def test_import_pulls_in_no_jax_and_no_reference():
    code = (
        "import sys; import repro_torch, repro_torch.core, repro_torch.kernels.ops; "
        "import repro_torch.models, repro_torch.configs, repro_torch.models.convert; "
        "import repro_torch.data.tokens, repro_torch.serve.engine, repro_torch.launch.serve; "
        "import chip_smoke; "
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')) "
        "or m == 'repro' or m.startswith('repro.')); "
        "assert not bad, bad; print('clean')"
    )
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT}"}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


@pytest.mark.parametrize("copies", [1, 3])
@pytest.mark.parametrize("quantized", [False, True])
def test_schemes_equal_reference(copies, quantized):
    from repro.core import schemes as jschemes
    from repro.kernels import ref as jref
    from repro_torch.core import schemes as tschemes
    from repro_torch.kernels import ref as tref

    img = _images(8, True, raw=quantized)
    quant = (np.float32(0.0), np.float32(255.0)) if quantized else None
    offsets = ((0, 1), (1, -1), (4, -4), (2, 3))
    want = np.asarray(jschemes.glcm_multi(jnp.asarray(img), 8, offsets=offsets, copies=copies,
                                          quant=quant))
    got = tschemes.glcm_multi(torch.from_numpy(img), 8, offsets=offsets, copies=copies,
                              quant=None if quant is None else (0.0, 255.0))
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jschemes.glcm_scatter_batch(jnp.asarray(img), 8, offsets, quant=quant))
    got = tschemes.glcm_scatter_batch(torch.from_numpy(img), 8, offsets,
                                      quant=None if quant is None else (0.0, 255.0))
    np.testing.assert_array_equal(got.numpy(), want)
    if not quantized:
        for off in offsets:
            np.testing.assert_array_equal(
                tref.glcm_reference_nd(torch.from_numpy(img[0]), 8, off).numpy(),
                np.asarray(jref.glcm_reference_nd(jnp.asarray(img[0]), 8, off)))


def test_require_capabilities():
    spec = GLCMSpec(levels=8)
    p = tplan.compile_plan(spec, (9, 9), require=("multi_offset_fused",), device="cpu")
    # First capable backend by name, leaving out the card's kernels on the CPU
    # (on CUDA they come first).
    assert p.spec.scheme == "onehot"
    assert backends.resolve_scheme(spec, torch.device("cuda"),
                                   require=("multi_offset_fused",)) == "cuda_fused"
    with pytest.raises(ValueError, match="lacks required capability"):
        tplan.compile_plan(spec.replace(scheme="scatter"), (9, 9),
                           require=("multi_offset_fused",), device="cpu")
    with pytest.raises(ValueError, match="lacks required capability 'volumetric'"):
        tplan.compile_plan(GLCMSpec(levels=8, pairs=((1, 4),), ndim=3, scheme="cuda_fused"),
                           (5, 9, 9), device="cpu")
    img = np.arange(81, dtype=np.int32).reshape(9, 9) % 8
    np.testing.assert_array_equal(
        p(img).numpy(), tplan.compile_plan(spec, (9, 9), device="cpu")(img).numpy())
