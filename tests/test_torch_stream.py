"""The incremental temporal stream of repro_torch against the JAX reference.

Counterparts of ``tests/test_stream_state.py``, each held to ``repro``'s
``GLCMStreamPlan`` on the same frames (made with numpy from a seed): the
rolling window equals a recompute of the window and ``repro``'s rolling
counts exactly, for global, tile and window specs and every 2-D scheme;
symmetric/normalize act on the accumulated counts; fused quantization equals
streaming pre-quantized frames; warm-up gives partial sums; the ring wraps;
a mid-stream checkpoint resumes bit-identically. Features are held to the
reference's formulas in float64 on the same counts (rtol 1e-5 / atol 1e-6,
f14 atol 1e-4), not to its float32 features by equality: those move by up
to 1.9e-6 between the reference's own program shapes. The ``cuda`` test
runs a stream on the card against the CPU and skips where there is none.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import plan as tplan
from repro_torch.core.pipeline import glcm_feature_stream
from repro_torch.core.spec import GLCMSpec
from repro_torch.core.stream_state import GLCMStreamPlan, GLCMStreamState, init_state, stream_step
from repro_torch.kernels.glcm_kernel import glcm_fused, glcm_window

try:  # the reference needs JAX, which a machine with a card may not have
    import jax.numpy as jnp

    from repro.core.plan import compile_plan as jax_compile_plan
    from repro.core.spec import GLCMSpec as JaxSpec
    from test_torch_haralick import reference_features
except ImportError:
    jnp = None

LEVELS = 8
SHAPE = (20, 16)
WINDOW = 4
T = 3 * WINDOW + 2  # the ring wraps three times
PAIRS = ((1, 0), (1, 135))
RTOL, ATOL, F14_ATOL = 1e-5, 1e-6, 1e-4
CPU = "cpu"
REGIONS = {
    "global": {},
    "tiles": {"region": "tiles", "region_shape": (10, 8)},
    "window": {"region": "window", "region_shape": 12, "region_stride": 8},
}


@pytest.fixture(autouse=True)
def _reference(request):
    if jnp is None and "cuda" not in request.keywords:
        pytest.skip("needs JAX to run the reference")


def _video(t=T, shape=SHAPE, levels=LEVELS, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, levels, (t, *shape)).astype(np.int32)


def _windowed_sums(per_frame: np.ndarray, window: int) -> np.ndarray:
    """At step t, the exact sum of the last min(t+1, window) frames' counts."""
    return np.stack([per_frame[max(0, t + 1 - window): t + 1].sum(axis=0)
                     for t in range(per_frame.shape[0])])


def _per_frame_counts(spec: GLCMSpec, video: np.ndarray) -> np.ndarray:
    plan = tplan.compile_plan(spec, video.shape[1:], device=CPU)
    return np.stack([plan(f).numpy() for f in video])


def _stream(spec: GLCMSpec, **kw) -> GLCMStreamPlan:
    return tplan.compile_plan(spec, SHAPE, temporal_window=WINDOW, device=CPU, **kw)


def _jax_rolling(spec: GLCMSpec, video: np.ndarray, **kw) -> np.ndarray:
    jspec = JaxSpec(**{k: getattr(spec, k) for k in (
        "levels", "pairs", "quantize", "symmetric", "normalize", "vrange", "region",
        "region_shape", "region_stride")}, scheme="onehot")
    plan = jax_compile_plan(jspec, SHAPE, temporal_window=WINDOW, **kw)
    return np.asarray(plan.rolling(jnp.asarray(video)))


def _features_close(got, counts):
    got = np.asarray(got)
    want = reference_features(counts)
    np.testing.assert_allclose(got[..., :13], want[..., :13], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[..., 13], want[..., 13], rtol=0, atol=F14_ATOL)


# ---------------------------------------------------------------------------
# Bit-exactness: rolling window vs full recompute, and vs the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", ["onehot", "cuda_fused"])
@pytest.mark.parametrize("region", sorted(REGIONS))
def test_rolling_bit_exact_vs_recompute(region, scheme):
    video = _video()
    spec = GLCMSpec(levels=LEVELS, pairs=PAIRS, scheme=scheme, **REGIONS[region])
    plan = _stream(spec)
    got = plan.rolling(video)
    assert got.dtype == torch.int32 and plan.grid == spec.region_grid(*SHAPE)   # count-only
    ref = _windowed_sums(_per_frame_counts(spec, video), WINDOW)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), _jax_rolling(spec, video))


@pytest.mark.parametrize("scheme", ["scatter", "onehot", "blocked", "native", "cuda",
                                    "cuda_fused"])
def test_all_schemes_agree(scheme):
    """Every 2-D backend serves the stream path (the CUDA ones through their
    kernels' plain versions here); all equal the reference's counts."""
    video = _video(t=WINDOW + 3)
    spec = GLCMSpec(levels=LEVELS, pairs=PAIRS, scheme=scheme)
    plan = _stream(spec)
    assert plan.host_native == (scheme == "native")
    np.testing.assert_array_equal(plan.rolling(video).numpy(), _jax_rolling(spec, video))


def test_symmetric_normalize_tail_applies_to_accumulated_counts():
    video = _video()
    raw = GLCMSpec(levels=LEVELS, pairs=PAIRS, scheme="onehot")
    spec = raw.replace(symmetric=True, normalize=True)
    counts = _windowed_sums(_per_frame_counts(raw, video), WINDOW).astype(np.float64)
    sym = counts + np.swapaxes(counts, -1, -2)
    ref = sym / np.maximum(sym.sum(axis=(-1, -2), keepdims=True), 1.0)
    got = _stream(spec).rolling(video).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got, _jax_rolling(spec, video), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("scheme", ["onehot", "cuda_fused", "native"])
def test_fused_quantize_stream_matches_prequantized(scheme):
    rng = np.random.default_rng(3)
    raw = rng.random((WINDOW + 4, *SHAPE), dtype=np.float32) * 255.0
    spec = GLCMSpec(levels=LEVELS, pairs=PAIRS, scheme=scheme, quantize="uniform",
                    vrange=(0.0, 255.0))
    plan = _stream(spec)
    assert plan.fused_quantize
    got = plan.rolling(raw).numpy()
    pre = np.clip(np.floor(raw / 255.0 * LEVELS), 0, LEVELS - 1).astype(np.int32)
    want = _stream(GLCMSpec(levels=LEVELS, pairs=PAIRS, scheme="onehot")).rolling(pre)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(got, _jax_rolling(spec, raw))


def test_dynamic_range_and_uint8_identity_streams():
    """Per-frame data ranges (no vrange) and the uint8 levels=256 identity
    cast take the same fused paths as the reference."""
    rng = np.random.default_rng(4)
    raw = (rng.random((WINDOW + 2, *SHAPE), dtype=np.float32) * 90.0 - 20.0)
    spec = GLCMSpec(levels=LEVELS, pairs=PAIRS, scheme="cuda_fused", quantize="uniform")
    np.testing.assert_array_equal(_stream(spec).rolling(raw).numpy(), _jax_rolling(spec, raw))
    u8 = rng.integers(0, 256, (WINDOW + 2, *SHAPE)).astype(np.uint8)
    spec = GLCMSpec(levels=256, pairs=((1, 0),), scheme="cuda", quantize="uniform",
                    vrange=(0, 255))
    np.testing.assert_array_equal(_stream(spec).rolling(u8).numpy(), _jax_rolling(spec, u8))


def test_features_stream_against_float64_reference():
    video = _video()
    spec = GLCMSpec(levels=LEVELS, pairs=PAIRS, scheme="onehot", normalize=True)
    plan = _stream(spec, features=True)
    feats = plan.rolling(video)
    assert feats.shape == (T, len(PAIRS), 14)
    counts = _windowed_sums(_per_frame_counts(spec.replace(normalize=False), video), WINDOW)
    _features_close(feats, counts.astype(np.float64) / counts.sum(axis=(-1, -2), keepdims=True))


def test_online_stepping_equals_rolling():
    video = _video()
    spec = GLCMSpec(levels=LEVELS, pairs=PAIRS, scheme="onehot", normalize=True)
    plan = _stream(spec, features=True)
    rolled = plan.rolling(video)
    state = plan.init_state()
    for t, frame in enumerate(video):
        state, out = plan.update(state, frame)
        assert torch.equal(out, rolled[t])
    assert int(state.seen) == T and int(state.pos) == T % WINDOW


# ---------------------------------------------------------------------------
# Ring-buffer mechanics
# ---------------------------------------------------------------------------


def test_ring_wraparound_long_stream():
    rng = np.random.default_rng(1)
    deltas = rng.integers(0, 100, (23, 2, 5, 5)).astype(np.int32)
    window = 3
    state = init_state(window, (), 2, 5, device=CPU)
    ring = state.ring
    for t, d in enumerate(deltas):
        state = stream_step(state, torch.from_numpy(d), window)
        expect = deltas[max(0, t + 1 - window): t + 1].sum(axis=0)
        np.testing.assert_array_equal(state.counts.numpy(), expect)
        assert int(state.pos) == (t + 1) % window
        assert int(state.seen) == t + 1
        assert state.ring is ring  # allocated once, updated in place
    for f in ("counts", "ring", "pos", "seen"):
        assert getattr(state, f).dtype == torch.int32


def test_warmup_counts_are_partial_sums():
    video = _video(t=WINDOW - 1)
    spec = GLCMSpec(levels=LEVELS, pairs=PAIRS, scheme="onehot")
    per = _per_frame_counts(spec, video)
    np.testing.assert_array_equal(_stream(spec).rolling(video).numpy(), np.cumsum(per, axis=0))


def test_expiry_subtracts_below_zero_in_signed_int32():
    """Counts are signed: a delta larger than what it expires leaves the
    difference exact, and a stored negative delta round-trips."""
    state = init_state(2, (), 1, 2, device=CPU)
    for d in (5, -7, 3):
        state = stream_step(state, torch.full((1, 2, 2), d, dtype=torch.int32), 2)
    assert torch.equal(state.counts, torch.full((1, 2, 2), -4, dtype=torch.int32))


# ---------------------------------------------------------------------------
# Checkpoint / resume
# ---------------------------------------------------------------------------


def test_state_roundtrip_mid_stream(tmp_path):
    video = _video()
    spec = GLCMSpec(levels=LEVELS, pairs=PAIRS, scheme="onehot")
    plan = _stream(spec)
    full = plan.rolling(video).numpy()
    cut = WINDOW + 2  # past the first wraparound
    _, state = plan.rolling(video[:cut], return_state=True)

    sd = state.state_dict()
    assert all(isinstance(v, np.ndarray) for v in sd.values())
    revived = GLCMStreamState.from_state_dict({k: v.astype(np.float64) for k, v in sd.items()},
                                              device=CPU)
    for f in ("counts", "ring", "pos", "seen"):
        assert getattr(revived, f).dtype == torch.int32

    path = tmp_path / "stream.npz"
    state.save(path)
    loaded = GLCMStreamState.load(path, device=CPU)
    assert loaded.window == WINDOW
    tail = plan.rolling(video[cut:], init=loaded)
    np.testing.assert_array_equal(tail.numpy(), full[cut:])
    # The reference resumes from the port's checkpoint to the same counts.
    jspec = JaxSpec(levels=LEVELS, pairs=PAIRS, scheme="onehot")
    jplan = jax_compile_plan(jspec, SHAPE, temporal_window=WINDOW)
    from repro.core.stream_state import GLCMStreamState as JaxState

    jtail = jplan.rolling(jnp.asarray(video[cut:]), init=JaxState.load(path))
    np.testing.assert_array_equal(np.asarray(jtail), full[cut:])


# ---------------------------------------------------------------------------
# compile_plan surface
# ---------------------------------------------------------------------------


def test_compile_plan_validates_temporal_args():
    spec = GLCMSpec(levels=LEVELS, pairs=PAIRS, scheme="onehot")
    for bad in (0, -1, 2.0):
        with pytest.raises(ValueError, match="temporal_window"):
            tplan.compile_plan(spec, SHAPE, temporal_window=bad, device=CPU)
    with pytest.raises(ValueError, match="unbatched frames"):
        tplan.compile_plan(spec, (2, *SHAPE), temporal_window=WINDOW, device=CPU)
    # A temporal plan lints clean (its recorded update step and its carry).
    plan = tplan.compile_plan(spec, SHAPE, temporal_window=WINDOW, check="lint", device=CPU)
    assert isinstance(plan, GLCMStreamPlan) and plan.lint == ()


def test_stream_plans_cache_separately_from_batch_plans():
    tplan.plan_cache_clear()
    spec = GLCMSpec(levels=LEVELS, pairs=PAIRS, scheme="onehot")
    stream = _stream(spec)
    batch = tplan.compile_plan(spec, SHAPE, device=CPU)
    assert stream is not batch and isinstance(stream, GLCMStreamPlan)
    assert _stream(spec) is stream
    assert tplan.compile_plan(spec, SHAPE, temporal_window=WINDOW + 1, device=CPU) is not stream
    assert tplan.plan_cache_stats()["hits"] == 1


def test_rolling_and_update_reject_wrong_frame_shape():
    plan = _stream(GLCMSpec(levels=LEVELS, pairs=PAIRS, scheme="onehot"))
    with pytest.raises(ValueError, match="stream plan"):
        plan.rolling(np.zeros((5, 8, 8), np.int32))
    with pytest.raises(ValueError, match="stream plan"):
        plan.update(plan.init_state(), np.zeros((8, 8), np.int32))


def test_glcm_feature_stream_temporal_mode():
    video = _video()
    spec = GLCMSpec(levels=LEVELS, pairs=PAIRS, scheme="onehot", normalize=True)
    ref = _stream(spec, features=True).rolling(video)
    outs = list(glcm_feature_stream(iter(video), spec=spec, temporal_window=WINDOW,
                                    device=CPU))
    assert len(outs) == T
    assert torch.equal(torch.stack(outs), ref)
    with pytest.raises(ValueError, match="batch_size must be 1"):
        glcm_feature_stream(iter(video), spec=spec, temporal_window=WINDOW, batch_size=2,
                            device=CPU)


@pytest.mark.cuda
def test_stream_on_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    rng = np.random.default_rng(7)
    raw = (rng.random((T, 64, 48), dtype=np.float32) * 255.0)
    for region in sorted(REGIONS):
        kw = dict(REGIONS[region], region_shape=(16, 16)) if region == "tiles" else REGIONS[region]
        spec = GLCMSpec(levels=LEVELS, pairs=PAIRS, quantize="uniform", vrange=(0, 255), **kw)
        card = tplan.compile_plan(spec, (64, 48), temporal_window=WINDOW)
        assert card.spec.scheme == "cuda_fused"
        kernel = glcm_window if region != "global" else glcm_fused
        before = kernel.launches
        got = card.rolling(raw)
        assert kernel.launches == before + T
        want = tplan.compile_plan(spec.replace(scheme="cuda_fused"), (64, 48),
                                  temporal_window=WINDOW, device=CPU).rolling(raw)
        assert torch.equal(got.cpu(), want), region
