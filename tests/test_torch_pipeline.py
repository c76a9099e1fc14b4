"""The streamed pipeline of repro_torch against the JAX reference.

``pad_stack`` and ``coalesce_images`` are held to ``repro``'s exactly;
``GLCMStream`` keeps order at every prefetch depth; ``glcm_feature_stream``
gives, image for image, the features of ``repro``'s stream on the same
images — batch, region, volume and temporal modes, legacy keywords and
``spec=`` — held to the reference's formulas in float64 on the same counts
(rtol 1e-5 / atol 1e-6, f14 atol 1e-4) and, more loosely, to ``repro``'s own
float32 stream output (rtol 1e-4 / atol 1e-5: the float32 rounding of f3,
f9, f12 and f13 alone exceeds 1e-5 there), and raises on the same argument
errors. The ``cuda`` test drives the side-stream ``GLCMStream`` on the card
and skips where there is none.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import plan as tplan
from repro_torch.core.pipeline import GLCMStream, coalesce_images, glcm_feature_stream, pad_stack
from repro_torch.core.spec import GLCMSpec

try:  # the reference needs JAX, which a machine with a card may not have
    import jax.numpy as jnp

    from repro.core import pipeline as jpipe
    from repro.core.spec import GLCMSpec as JaxSpec
    from test_torch_haralick import reference_features
except ImportError:
    jnp = None

RTOL, ATOL, F14_ATOL = 1e-5, 1e-6, 1e-4
CPU = "cpu"
PAIRS = ((1, 0), (1, 45), (2, 90))


@pytest.fixture(autouse=True)
def _reference(request):
    if jnp is None and "cuda" not in request.keywords:
        pytest.skip("needs JAX to run the reference")


def _images(n=5, shape=(32, 28), seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.random(shape) * 255.0).astype(np.float32) for _ in range(n)]


def _counts_features_close(got, spec: GLCMSpec, images):
    """Each streamed feature tensor against the float64 reference features
    of the same image's counts (the port's counts, exact by the plan
    tests)."""
    counts = tplan.compile_plan(spec, images[0].shape, device=CPU)
    for g, im in zip(got, images):
        want = reference_features(counts(im).numpy())
        g = np.asarray(g)
        assert g.shape == want.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g[..., :13], want[..., :13], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g[..., 13], want[..., 13], rtol=0, atol=F14_ATOL)


def _close_to_reference(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g[..., :13], w[..., :13], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(g[..., 13], w[..., 13], rtol=0, atol=F14_ATOL)


# ---------------------------------------------------------------------------
# Batching helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,size", [(1, 1), (2, 4), (4, 4)])
def test_pad_stack_equals_reference(k, size):
    ims = _images(k)
    stack, n = pad_stack(ims, size)
    jstack, jn = jpipe.pad_stack(ims, size)
    assert n == jn == k
    np.testing.assert_array_equal(stack, jstack)


def test_pad_stack_rejects_bad_counts():
    for ims, size in (([], 2), (_images(3), 2)):
        with pytest.raises(ValueError, match="need 1"):
            pad_stack(ims, size)


@pytest.mark.parametrize("batch_size", [1, 2, 3, 7])
def test_coalesce_images_equals_reference(batch_size):
    ims = _images(5)
    got = list(coalesce_images(iter(ims), batch_size))
    want = list(jpipe.coalesce_images(iter(ims), batch_size))
    assert [k for _, k in got] == [k for _, k in want]
    for (s, _), (w, _) in zip(got, want):
        np.testing.assert_array_equal(s, w)
    with pytest.raises(ValueError, match="batch_size"):
        list(coalesce_images(iter(ims), 0))


# ---------------------------------------------------------------------------
# GLCMStream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prefetch", [1, 2, 3])
def test_stream_keeps_order(prefetch):
    ims = _images(7)
    outs = list(GLCMStream(lambda x: x.sum(), prefetch=prefetch, device=CPU)(ims))
    assert [float(o) for o in outs] == [float(torch.from_numpy(im).sum()) for im in ims]


def test_stream_empty_short_and_bad_prefetch():
    fn = lambda x: x.sum()  # noqa: E731
    assert list(GLCMStream(fn, prefetch=4, device=CPU)([])) == []
    assert len(list(GLCMStream(fn, prefetch=4, device=CPU)(_images(2)))) == 2
    with pytest.raises(ValueError, match="prefetch"):
        GLCMStream(fn, prefetch=0, device=CPU)


# ---------------------------------------------------------------------------
# glcm_feature_stream against repro's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch_size", [1, 3])
@pytest.mark.parametrize("prefetch", [1, 2])
def test_feature_stream_legacy_keywords(batch_size, prefetch):
    ims = _images(5)
    got = list(glcm_feature_stream(ims, 8, PAIRS, prefetch=prefetch, batch_size=batch_size,
                                   device=CPU))
    want = list(jpipe.glcm_feature_stream(ims, 8, PAIRS, prefetch=prefetch,
                                          batch_size=batch_size))
    _close_to_reference(got, want)
    _counts_features_close(got, GLCMSpec(levels=8, pairs=PAIRS, quantize="uniform",
                                         vrange=(0.0, 255.0)), ims)


def test_feature_stream_dynamic_range():
    ims = [im * 0.5 - 30.0 for im in _images(3, seed=2)]
    got = list(glcm_feature_stream(ims, 8, vmin=None, vmax=None, device=CPU))
    want = list(jpipe.glcm_feature_stream(ims, 8, vmin=None, vmax=None))
    _close_to_reference(got, want)


@pytest.mark.parametrize("batch_size", [1, 3])
def test_feature_stream_region_spec(batch_size):
    ims = _images(4, shape=(40, 36))
    kw = dict(levels=8, pairs=((1, 0), (1, 45)), quantize="uniform", region="window",
              region_shape=16, region_stride=10)
    spec = GLCMSpec(**kw)
    got = list(glcm_feature_stream(ims, spec=spec, batch_size=batch_size, device=CPU))
    want = list(jpipe.glcm_feature_stream(ims, spec=JaxSpec(**kw), batch_size=batch_size))
    assert got[0].shape == (3, 3, 2, 14)
    _close_to_reference(got, want)
    _counts_features_close(got, spec, ims)


@pytest.mark.parametrize("batch_size", [1, 3])
def test_feature_stream_volume_spec(batch_size):
    rng = np.random.default_rng(3)
    vols = [(rng.random((6, 12, 10)) * 255.0).astype(np.float32) for _ in range(4)]
    kw = dict(levels=8, pairs=((1, 0), (1, 8), (1, 12)), quantize="uniform", ndim=3)
    got = list(glcm_feature_stream(vols, spec=GLCMSpec(**kw), batch_size=batch_size,
                                   device=CPU))
    want = list(jpipe.glcm_feature_stream(vols, spec=JaxSpec(**kw), batch_size=batch_size))
    assert got[0].shape == (3, 14)
    _close_to_reference(got, want)
    _counts_features_close(got, GLCMSpec(**kw), vols)


def test_feature_stream_temporal_mode_against_reference():
    rng = np.random.default_rng(4)
    video = (rng.random((7, 24, 20)) * 255.0).astype(np.float32)
    kw = dict(levels=8, pairs=((1, 0), (1, 45)), quantize="uniform", vrange=(0.0, 255.0))
    got = list(glcm_feature_stream(iter(video), spec=GLCMSpec(**kw), temporal_window=3,
                                   device=CPU))
    want = list(jpipe.glcm_feature_stream(iter(video), spec=JaxSpec(**kw), temporal_window=3))
    _close_to_reference(got, want)
    counts = tplan.compile_plan(GLCMSpec(**kw), (24, 20), temporal_window=3,
                                device=CPU).rolling(video)
    want64 = reference_features(counts.numpy())
    got = torch.stack(got).numpy()
    np.testing.assert_allclose(got[..., :13], want64[..., :13], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[..., 13], want64[..., 13], rtol=0, atol=F14_ATOL)


def test_feature_stream_argument_errors():
    ims = _images(2)
    spec = GLCMSpec(levels=8)
    for kw in (dict(), dict(spec=spec, levels=8), dict(spec=spec, vmin=0.0),
               dict(spec=spec, pairs=PAIRS)):
        with pytest.raises(ValueError, match="spec="):
            glcm_feature_stream(ims, device=CPU, **kw)
        with pytest.raises(ValueError, match="spec="):
            jpipe.glcm_feature_stream(ims, **{k: (JaxSpec(levels=8) if k == "spec" else v)
                                              for k, v in kw.items()})
    with pytest.raises(ValueError, match="batch_size must be 1"):
        glcm_feature_stream(ims, 8, temporal_window=2, batch_size=2, device=CPU)
    with pytest.raises(ValueError, match="batch_size"):
        list(glcm_feature_stream(ims, 8, batch_size=0, device=CPU))


@pytest.mark.cuda
@pytest.mark.parametrize("prefetch", [1, 2, 3])
def test_side_stream_pipeline_on_card(prefetch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    ims = _images(7, shape=(96, 80))
    got = list(glcm_feature_stream(ims, 8, PAIRS, prefetch=prefetch))
    assert all(g.device.type == "cuda" for g in got)
    want = list(glcm_feature_stream(ims, 8, PAIRS, device=CPU))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=RTOL, atol=ATOL)
    # Items already on the card pass through; host items of a new shape
    # reallocate their staging buffers.
    host = [im.astype(np.int32) for im in ims[:2] + _images(1, shape=(50, 40))]
    mixed = [torch.from_numpy(host[0]).cuda()] + host[1:]
    outs = list(GLCMStream(lambda x: x.sum(), prefetch=prefetch)(mixed))
    assert [int(o) for o in outs] == [int(h.sum()) for h in host]
