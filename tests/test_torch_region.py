"""Texture maps (``region="tiles" | "window"``) in repro_torch against the JAX
reference.

The window kernel's plain version is held count for count to the reference's
window kernel run in interpret mode on the reference's own patch extraction
— tiles and overlapping windows with a ragged edge, dy == rh - 1, dx < 0,
levels outside [0, L), and scalar and per-image quantization with values on
bin edges. The region schemes and the public entry points are held to
``repro`` end to end on the CPU: counts exactly, features within rtol 1e-5 /
atol 1e-6 (f14 atol 1e-4) of the reference's formulas in float64. The
``cuda`` test holds the window kernel to its plain version on the card and
skips where there is none.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import backends, schemes
from repro_torch.core import plan as tplan
from repro_torch.core.glcm import glcm, glcm_features
from repro_torch.core.quantize import uniform_params
from repro_torch.core.spec import GLCMSpec
from repro_torch.kernels import ops
from repro_torch.kernels.glcm_kernel import glcm_vote, glcm_window, glcm_window_plain

try:  # the reference needs JAX, which a machine with a card may not have
    import jax.numpy as jnp

    from repro.core import schemes as jschemes
    from repro.core.glcm import glcm as jax_glcm
    from repro.core.plan import compile_plan as jax_compile_plan
    from repro.core.spec import GLCMSpec as JaxSpec
    from repro.kernels import ops as jops
    from repro.kernels.glcm_kernel import glcm_window_pallas
    from test_torch_haralick import reference_features
except ImportError:
    jnp = None

PAPER_PAIRS = ((1, 0), (1, 45), (4, 0), (4, 45))
RTOL, ATOL, F14_ATOL = 1e-5, 1e-6, 1e-4
# (image size, region, stride): overlapping windows with a ragged edge,
# tiles whose edge does not divide (gathered), tiles that divide (reshaped).
GEOMETRIES = [
    ((67, 61), (16, 12), (5, 7)),
    ((67, 61), (16, 12), (16, 12)),
    ((64, 56), (8, 8), (8, 8)),
]


@pytest.fixture(autouse=True)
def _reference(request):
    if jnp is None and "cuda" not in request.keywords:
        pytest.skip("needs JAX to run the reference")


def _offsets(rh, rw):
    """dy == rh - 1, dx < 0, |dx| == rw - 1 and the paper's smallest pair."""
    return ((0, 1), (1, -1), (rh - 1, 2), (3, -(rw - 1)))


def _raw_images(rng, shape, levels):
    """(2, H, W) raw f32 images, a third of the values exactly on bin edges."""
    out = []
    for lo, span in ((0.0, 255.0), (-3.5, 7.25)):
        x = (lo + rng.random(shape) * span).astype(np.float32)
        edges = np.float32(lo) + rng.integers(0, levels + 1, size=shape).astype(
            np.float32) * np.float32(span / levels)
        out.append(np.where(rng.random(shape) < 1 / 3, edges, x).astype(np.float32))
    return np.stack(out)


def _smooth_images(levels, raw, shape=(67, 61), seed=0):
    """(2, H, W): a smooth and a random texture; raw f32 or int32 levels."""
    rng = np.random.default_rng(seed + levels)
    smooth = np.cumsum(rng.normal(size=shape), axis=1) + np.cumsum(rng.normal(size=shape), 0)
    smooth = (smooth - smooth.min()) / np.ptp(smooth) * 255.0
    x = np.stack([smooth, rng.random(shape) * 255.0]).astype(np.float32)
    return x if raw else np.floor(x / 256.0 * levels).astype(np.int32)


def _features_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got[..., :13], want[..., :13], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[..., 13], want[..., 13], rtol=0, atol=F14_ATOL)


# ---------------------------------------------------------------------------
# Kernel 3: plain version against the Pallas window kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("levels", [2, 8, 32, 256])
@pytest.mark.parametrize("size,region,stride", GEOMETRIES)
def test_window_plain_equals_pallas_int(levels, size, region, stride):
    rng = np.random.default_rng(levels + region[0])
    img = rng.integers(-2, levels + 2, size=(2,) + size).astype(np.int32)
    offsets = _offsets(*region)
    patches = jschemes.extract_regions(jnp.asarray(img), region, stride)
    want = np.asarray(glcm_window_pallas(patches, levels=levels, offsets=offsets,
                                         interpret=True))
    got = glcm_window_plain(torch.from_numpy(img), levels, offsets, region_shape=region,
                            stride=stride)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # The wrapper on a CPU tensor, from the image and from the patch grid.
    np.testing.assert_array_equal(
        glcm_window(torch.from_numpy(img), levels=levels, offsets=offsets,
                    region_shape=region, stride=stride, copies=3).numpy(), want)
    np.testing.assert_array_equal(
        glcm_window(torch.from_numpy(np.array(patches)), levels=levels,
                    offsets=offsets).numpy(), want)


@pytest.mark.parametrize("levels", [2, 8, 32, 256])
@pytest.mark.parametrize("per_image", [False, True])
@pytest.mark.parametrize("size,region,stride", GEOMETRIES[:2])
def test_window_plain_equals_pallas_quant(levels, per_image, size, region, stride):
    rng = np.random.default_rng(levels)
    img = _raw_images(rng, size, levels)
    offsets = _offsets(*region)
    if per_image:
        tq = uniform_params(torch.from_numpy(img), batched=True)
        jquant = (jnp.asarray(tq[0].numpy()), jnp.asarray(tq[1].numpy()))
    else:
        tq = jquant = (-3.5, 7.25)
    patches = jschemes.extract_regions(jnp.asarray(img), region, stride)
    want = np.asarray(glcm_window_pallas(patches, levels=levels, offsets=offsets,
                                         interpret=True, quant=jquant))
    got = glcm_window(torch.from_numpy(img), levels=levels, offsets=offsets,
                      region_shape=region, stride=stride, quant=tq)
    np.testing.assert_array_equal(got.numpy(), want)


def test_window_unbatched_and_orientation():
    # One 3 x 4 window, offset (0, 1): out[ref, assoc], a level outside [0, L)
    # drops its pair on either side.
    img = torch.tensor([[0, 1, 2, 3], [1, 1, 9, 1], [-1, 0, 0, 2]], dtype=torch.int32)
    got = glcm_window(img, levels=4, offsets=((0, 1),), region_shape=(3, 4))
    assert tuple(got.shape) == (1, 1, 1, 4, 4)
    want = np.zeros((4, 4), np.int32)
    for a, r in ((0, 1), (1, 2), (2, 3), (1, 1), (0, 0), (0, 2)):
        want[r, a] += 1
    np.testing.assert_array_equal(got[0, 0, 0].numpy(), want)
    jw = glcm_window_pallas(jnp.asarray(img.numpy()[None, None]), levels=4,
                            offsets=((0, 1),), interpret=True)
    np.testing.assert_array_equal(np.asarray(jw)[0, 0, 0], want)


@pytest.mark.parametrize("kwargs,match", [
    (dict(offsets=((16, 0),)), "does not fit region"),
    (dict(offsets=((-1, 0),)), "does not fit region"),
    (dict(offsets=((0, 12),)), "does not fit region"),
    (dict(offsets=((0, 1),), region_shape=(70, 12)), "exceeds input shape"),
    (dict(offsets=()), "offsets"),
    (dict(offsets=((0, 1),), levels=300), "levels"),
])
def test_window_rejects_bad_arguments(kwargs, match):
    kwargs = {"levels": 8, "region_shape": (16, 12), "stride": (5, 7), **kwargs}
    with pytest.raises(ValueError, match=match):
        glcm_window(torch.zeros((2, 67, 61), dtype=torch.int32), **kwargs)


def test_window_offset_errors_match_reference():
    patches = np.zeros((1, 2, 2, 16, 12), np.int32)
    for off in ((16, 0), (0, -12)):
        with pytest.raises(ValueError) as jerr:
            glcm_window_pallas(jnp.asarray(patches), levels=8, offsets=(off,), interpret=True)
        with pytest.raises(ValueError) as terr:
            glcm_window(torch.from_numpy(patches), levels=8, offsets=(off,))
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("quantized", [False, True])
def test_ops_windowed_equals_reference_ops(quantized):
    img = _smooth_images(8, raw=quantized)
    region, stride = (16, 12), (5, 7)
    if quantized:
        tq = uniform_params(torch.from_numpy(img), batched=True)
        jq = tuple(jnp.asarray(v.numpy()) for v in tq)
    else:
        tq = jq = None
    patches = jschemes.extract_regions(jnp.asarray(img), region, stride)
    want = np.asarray(jops.glcm_pallas_windowed(patches, 8, PAPER_PAIRS, interpret=True,
                                                quant=jq))
    got = ops.glcm_cuda_windowed(torch.from_numpy(img), 8, PAPER_PAIRS, region_shape=region,
                                 stride=stride, quant=tq)
    np.testing.assert_array_equal(got.numpy(), want)
    got = ops.glcm_cuda_windowed(torch.from_numpy(np.array(patches)), 8, PAPER_PAIRS,
                                 quant=tq)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# Region extraction and the region schemes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,region,stride", [
    ((2, 64, 56), (8, 8), (8, 8)),            # tiles that divide: reshape
    ((2, 67, 61), (16, 12), (16, 12)),        # tiles with a ragged edge
    ((67, 61), (16, 12), (5, 7)),             # windows, ragged strides
    ((2, 67, 61), (7, 9), (1, 1)),            # stride 1
    ((2, 11, 9, 13), (4, 3, 5), (4, 3, 5)),   # 3-D tiles, ragged
    ((11, 9, 13), (4, 3, 5), (2, 3, 4)),      # 3-D windows
    ((2, 8, 9, 10), (4, 3, 5), (4, 3, 5)),    # 3-D tiles that divide
])
def test_extract_regions_equals_reference(shape, region, stride):
    x = np.random.default_rng(len(shape)).integers(0, 100, size=shape).astype(np.int32)
    want = np.asarray(jschemes.extract_regions(jnp.asarray(x), region, stride))
    got = schemes.extract_regions(torch.from_numpy(x), region, stride)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_extract_regions_rejects_what_the_reference_rejects():
    x = torch.zeros((9, 9))
    with pytest.raises(ValueError, match="exceeds input shape"):
        schemes.extract_regions(x, (10, 3), (1, 1))
    with pytest.raises(ValueError, match="rank"):
        schemes.extract_regions(x, (3, 3), (1,))


@pytest.mark.parametrize("copies", [1, 3])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("region,stride", [((16, 12), (5, 7)), ((16, 12), (16, 12))])
def test_glcm_windowed_equals_reference(copies, quantized, region, stride):
    img = _smooth_images(8, raw=quantized)
    if quantized:
        tq = uniform_params(torch.from_numpy(img), batched=True)
        jq = tuple(jnp.asarray(v.numpy()) for v in tq)
    else:
        tq = jq = None
    want = np.asarray(jschemes.glcm_windowed(jnp.asarray(img), 8, PAPER_PAIRS, region, stride,
                                             copies=copies, quant=jq))
    got = schemes.glcm_windowed(torch.from_numpy(img), 8, PAPER_PAIRS, region, stride,
                                copies=copies, quant=tq)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# The region path end to end, device="cpu"
# ---------------------------------------------------------------------------

REGION_SPECS = [
    dict(region="tiles", region_shape=(16, 12)),
    dict(region="window", region_shape=(16, 12), region_stride=(5, 7)),
    dict(region="window", region_shape=8),
]


@pytest.mark.parametrize("region", REGION_SPECS)
@pytest.mark.parametrize("quantize", [None, "uniform", "equalized"])
@pytest.mark.parametrize("scheme", ["auto", "scatter", "onehot", "cuda", "cuda_fused"])
def test_region_counts_equal_reference(region, quantize, scheme):
    img = _smooth_images(8, raw=quantize is not None, shape=(64, 60))
    if region["region"] == "tiles":
        img = img[:, :64, :60]
    shape = tuple(img.shape)
    jspec = JaxSpec(levels=8, pairs=PAPER_PAIRS, quantize=quantize, **region)
    jplan = jax_compile_plan(jspec, shape)
    want = np.asarray(jplan(jnp.asarray(img)))
    spec = GLCMSpec.from_dict(dataclasses.asdict(jspec)).replace(scheme=scheme)
    p = tplan.compile_plan(spec, shape, device="cpu")
    assert p.grid == jplan.grid
    got = p(img)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape   # count-only
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("region", REGION_SPECS[:2])
@pytest.mark.parametrize("batched", [False, True])
def test_region_glcm_features_equal_reference(region, batched):
    img = _smooth_images(32, raw=True, shape=(64, 60))
    if not batched:
        img = img[0]
    shape = tuple(img.shape)
    jspec = JaxSpec(levels=32, pairs=PAPER_PAIRS, quantize="uniform", **region)
    want_counts = np.asarray(jax_compile_plan(jspec, shape)(jnp.asarray(img)))
    want = reference_features(want_counts)
    for scheme in ("auto", "cuda_fused", "cuda"):
        got = glcm_features(img, 32, scheme=scheme, device="cpu", **region)
        assert tuple(got.shape) == want.shape  # (..., *grid, n_pairs, 14)
        _features_close(got.numpy(), want)


@pytest.mark.parametrize("symmetric,normalize", [(False, False), (True, True)])
def test_region_glcm_single_pair(symmetric, normalize):
    img = _smooth_images(8, raw=True, shape=(64, 60))
    kw = dict(quantize="uniform", region="window", region_shape=(16, 12),
              region_stride=(5, 7), symmetric=symmetric, normalize=normalize)
    want = np.asarray(jax_glcm(jnp.asarray(img), 8, 1, 45, **kw))
    for scheme in ("auto", "cuda", "onehot"):
        got = glcm(img, 8, 1, 45, scheme=scheme, device="cpu", **kw)
        assert tuple(got.shape) == want.shape  # (B, gh, gw, L, L)
        np.testing.assert_array_equal(got.numpy(), want)


def test_region_plan_grid_and_validation():
    spec = GLCMSpec(levels=8, pairs=PAPER_PAIRS, region="window", region_shape=(16, 12),
                    region_stride=(5, 7))
    jspec = JaxSpec(levels=8, pairs=PAPER_PAIRS, region="window", region_shape=(16, 12),
                    region_stride=(5, 7))
    for shape in ((67, 61), (2, 67, 61), (16, 12), (20, 12)):
        assert (tplan.compile_plan(spec, shape, device="cpu").grid
                == jax_compile_plan(jspec, shape).grid)
    tiles = GLCMSpec(levels=8, region="tiles", region_shape=(16, 12))
    with pytest.raises(ValueError, match="not divisible"):
        tplan.compile_plan(tiles, (67, 60), device="cpu")
    with pytest.raises(ValueError, match="exceeds input shape"):
        tplan.compile_plan(spec, (15, 61), device="cpu")
    # Regions share their image's quantization: a region plan's windows
    # equal the global counts of windows binned with the image's range.
    img = _smooth_images(8, raw=True, shape=(64, 60))
    counts = tplan.compile_plan(spec.replace(quantize="uniform"), img.shape, device="cpu")(img)
    q = uniform_params(torch.from_numpy(img), batched=True)
    want = glcm_window_plain(torch.from_numpy(img), 8, spec.offsets(), region_shape=(16, 12),
                             stride=(5, 7), quant=q)
    np.testing.assert_array_equal(counts.numpy(), want.numpy())


def test_region_resolution_on_cuda():
    cuda = torch.device("cuda")
    many = GLCMSpec(levels=8, pairs=PAPER_PAIRS, region="tiles", region_shape=8)
    one = GLCMSpec(levels=8, region="window", region_shape=8)
    assert backends.resolve_scheme(many, cuda) == "cuda_fused"
    assert backends.resolve_scheme(one, cuda) == "cuda"
    assert backends.resolve_scheme(many, torch.device("cpu")) == "onehot"
    assert backends.get_backend("cuda_fused").caps.region_grid
    assert not backends.get_backend("cuda").caps.region_grid


def test_single_pair_regions_take_the_vote_fallback():
    # glcm(region=...) with one pair on the "cuda" backend extracts patches
    # and votes them as a flat batch through the pair-stream kernel's wrapper.
    img = _smooth_images(8, raw=True, shape=(64, 60))[0]
    got = glcm(img, 8, 1, 0, quantize="uniform", region="tiles", region_shape=(16, 12),
               scheme="cuda", device="cpu")
    want = np.asarray(jax_glcm(jnp.asarray(img), 8, 1, 0, quantize="uniform", region="tiles",
                               region_shape=(16, 12)))
    assert tuple(got.shape) == (4, 5, 8, 8)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.cuda
def test_vote_fallback_beyond_one_grid_on_card():
    # A single-pair texture map of 85 849 windows votes more streams than one
    # grid of the vote kernel holds (65 535): two launches, the CPU's counts.
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    img = _smooth_images(8, raw=True, shape=(300, 300))[0]
    kw = dict(quantize="uniform", region="window", region_shape=8, scheme="cuda")
    before = glcm_vote.launches
    got = glcm(img, 8, 1, 45, **kw)
    assert glcm_vote.launches == before + 2
    assert tuple(got.shape) == (293, 293, 8, 8)
    np.testing.assert_array_equal(got.cpu().numpy(), glcm(img, 8, 1, 45, device="cpu",
                                                          **kw).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [8, 32, 256])
def test_window_kernel_equals_plain_on_card(levels):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(levels)
    offsets = _offsets(16, 12)
    img = torch.from_numpy(
        rng.integers(-2, levels + 2, size=(2, 67, 61)).astype(np.int32)).to(dev)
    raw = torch.from_numpy(_raw_images(rng, (67, 61), levels)).to(dev)
    before = glcm_window.launches
    for region, stride in (((16, 12), (5, 7)), ((16, 12), None)):
        kw = dict(region_shape=region, stride=stride)
        got = glcm_window(img, levels=levels, offsets=offsets, copies=2, **kw)
        assert torch.equal(got, glcm_window_plain(img, levels, offsets, **kw))
        for quant in (uniform_params(raw, batched=True), (-3.5, 7.25)):
            got = glcm_window(raw, levels=levels, offsets=offsets, quant=quant, **kw)
            assert torch.equal(got, glcm_window_plain(raw, levels, offsets, quant=quant, **kw))
    assert glcm_window.launches == before + 6
