"""The host-native backend and the conflict analysis of repro_torch against the
JAX reference.

``native_counts``, ``quantize_stack`` and ``uniform_params_np`` equal
``repro``'s exactly (the same NumPy arithmetic); ``scheme="native"`` plans
equal ``onehot`` plans (counts exactly, features within rtol 1e-5 / atol
1e-6) and ``repro``'s native plans; the conflict functions are within 1e-6
of ``repro``'s (float32 sums in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import backends, conflicts, native
from repro_torch.core import plan as tplan
from repro_torch.core.schemes import VOLUME_PAIRS
from repro_torch.core.spec import GLCMSpec
from repro_torch.data.images import random_texture, smooth_texture

try:  # the reference needs JAX, which a machine with a card may not have
    import jax.numpy as jnp

    from repro.core import conflicts as jconflicts
    from repro.core import native as jnative
    from repro.core.plan import compile_plan as jax_compile_plan
    from repro.core.spec import GLCMSpec as JaxSpec
except ImportError:
    jnp = None

CPU = "cpu"


@pytest.fixture(autouse=True)
def _reference():
    if jnp is None:
        pytest.skip("needs JAX to run the reference")


def _imgs(seed, levels, shape=(2, 24, 28)):
    rng = np.random.default_rng(seed)
    return rng.integers(0, levels, size=shape).astype(np.int32)


def _raw(seed, shape=(3, 20, 20)):
    rng = np.random.default_rng(seed)
    return (rng.random(shape).astype(np.float32) * 300.0) - 50.0


@pytest.mark.parametrize("pinned", [False, True])
def test_uniform_params_and_quantize_stack_equal_reference(pinned):
    stack = _raw(2)
    vmin, vmax = (-50.0, 250.0) if pinned else (None, None)
    spec = GLCMSpec(levels=16, quantize="uniform")
    got = native.uniform_params_np(stack, vmin, vmax)
    want = jnative.uniform_params_np(stack, vmin, vmax)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    q = native.quantize_stack(stack, spec, got)
    np.testing.assert_array_equal(q, jnative.quantize_stack(stack, JaxSpec(levels=16), want))
    assert q.dtype == np.int64
    np.testing.assert_array_equal(native.quantize_stack(q, spec, None), q)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(region="tiles", region_shape=(8, 7)),
    dict(region="window", region_shape=10, region_stride=(4, 6)),
])
def test_native_counts_equal_reference(kw):
    imgs = _imgs(3, 8)
    pairs = ((1, 0), (1, 45), (2, 135))
    got = native.native_counts(imgs, GLCMSpec(levels=8, pairs=pairs, **kw), None)
    want = jnative.native_counts(imgs, JaxSpec(levels=8, pairs=pairs, **kw), None)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_counts_pairs_volume_equals_reference():
    vols = _imgs(1, 8, shape=(2, 6, 10, 12))
    offs = ((1, 0, 1), (1, -1, -1), (0, 1, 0))
    np.testing.assert_array_equal(native.counts_pairs(vols.astype(np.int64), 8, offs),
                                  jnative.counts_pairs(vols.astype(np.int64), 8, offs))


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("kw", [
    dict(quantize="uniform"),
    dict(quantize="uniform", symmetric=True, normalize=True),
    dict(quantize="equalized"),
    dict(quantize="uniform", vrange=(0.0, 255.0), region="tiles", region_shape=(20, 12)),
])
def test_native_plan_equals_onehot_plan(batched, kw):
    shape = (3, 40, 36) if batched else (40, 36)
    img = np.random.default_rng(4).random(shape, np.float32) * 255.0
    spec = GLCMSpec(levels=8, pairs=((1, 0), (1, 90)), scheme="native", **kw)
    plan = tplan.compile_plan(spec, shape, device=CPU)
    assert plan.host_native and plan.spec.scheme == "native"
    got = plan(img)
    # Count-only plans give int32 counts, normalized ones float32.
    want_dtype = torch.float32 if kw.get("normalize") else torch.int32
    assert got.dtype == want_dtype and got.device.type == "cpu"
    want = tplan.compile_plan(spec.replace(scheme="onehot"), shape, device=CPU)(img)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    jax_got = jax_compile_plan(JaxSpec(**{**kw, "levels": 8, "pairs": ((1, 0), (1, 90)),
                                         "scheme": "native"}), shape)(jnp.asarray(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_got), rtol=0, atol=1e-6)


def test_native_plan_uint8_identity_and_tensor_input():
    img = np.random.default_rng(5).integers(0, 256, (2, 30, 26)).astype(np.uint8)
    spec = GLCMSpec(levels=256, pairs=((1, 0),), scheme="native", quantize="uniform",
                    vrange=(0, 255))
    got = tplan.compile_plan(spec, img.shape, device=CPU)(torch.from_numpy(img))
    want = tplan.compile_plan(spec.replace(scheme="onehot"), img.shape, device=CPU)(img)
    assert torch.equal(got, want)


def test_native_plan_volume_and_features():
    vol = _imgs(5, 8, shape=(6, 12, 14))
    spec = GLCMSpec(levels=8, pairs=VOLUME_PAIRS[:4], scheme="native", ndim=3)
    got = tplan.compile_plan(spec, vol.shape, device=CPU)(vol)
    assert torch.equal(got, tplan.compile_plan(spec.replace(scheme="onehot"), vol.shape,
                                               device=CPU)(vol))
    imgs = _imgs(7, 8, shape=(2, 32, 32))
    spec = GLCMSpec(levels=8, pairs=((1, 0), (1, 45)), scheme="native")
    feats = tplan.compile_plan(spec, imgs.shape, features=True, device=CPU)(imgs)
    want = tplan.compile_plan(spec.replace(scheme="onehot"), imgs.shape, features=True,
                              device=CPU)(imgs)
    assert feats.shape == (2, 2, 14)
    np.testing.assert_allclose(feats.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_native_backend_registry_contract():
    b = backends.get_backend("native")
    assert b.caps.host_native and b.host_fn is native.native_counts
    spec = GLCMSpec(levels=8, pairs=((1, 0), (1, 45)))
    # "auto" never picks the host-native backend, not even by capability...
    assert backends.resolve_scheme(spec, torch.device("cpu")) == "onehot"
    assert backends.resolve_scheme(spec, torch.device("cpu"),
                                   require=("multi_offset_fused", "volumetric")) != "native"
    # ...unless host_native itself is required.
    assert backends.resolve_scheme(spec, torch.device("cpu"), require=("host_native",)) == "native"
    with pytest.raises(ValueError, match="host_native"):
        backends.register(backends.Backend(name="scratch", compute=b.compute,
                                           caps=backends.Capabilities(host_native=True)))
    with pytest.raises(ValueError, match="host_native"):
        backends.register(backends.Backend(name="scratch", compute=b.compute,
                                           host_fn=native.native_counts))
    assert "scratch" not in backends.available_backends()


def test_native_compute_through_the_registry_contract():
    """The backend's ``compute`` (what the temporal delta and the region
    fallback call) equals ``host_fn`` and keeps the input's device."""
    raw = _raw(6, shape=(2, 18, 22))
    spec = GLCMSpec(levels=8, pairs=((1, 0), (1, 135)), scheme="native", quantize="uniform")
    lo, span = native.uniform_params_np(raw)
    b = backends.get_backend("native")
    got = b.compute(torch.from_numpy(raw), spec,
                    quant=(torch.from_numpy(lo), torch.from_numpy(span)))
    assert got.dtype == torch.int32   # backends hand back exact int32 counts
    np.testing.assert_array_equal(got.numpy(), native.native_counts(raw, spec, (lo, span)))


def test_conflicts_equal_reference():
    smooth = smooth_texture(96).astype(np.int32)
    rand = random_texture(96).astype(np.int32)
    for img, levels, div in ((smooth, 8, 32), (rand, 8, 32), (smooth, 32, 8), (rand, 32, 8)):
        q = img // div
        for d, theta in ((1, 0), (2, 45)):
            p = conflicts.conflict_profile(q, levels, d, theta, device=CPU)
            jp = np.asarray(jconflicts.conflict_profile(jnp.asarray(q), levels, d, theta))
            np.testing.assert_allclose(p.numpy(), jp, rtol=0, atol=1e-6)
            np.testing.assert_allclose(float(conflicts.expected_collision_rate(p)),
                                       float(jconflicts.expected_collision_rate(jp)), atol=1e-6)
            np.testing.assert_allclose(
                float(conflicts.serialization_factor(p, 512)),
                float(jconflicts.serialization_factor(jnp.asarray(jp), 512)), rtol=1e-6)
        got = conflicts.analyze_image(q, levels, device=CPU)
        want = jconflicts.analyze_image(jnp.asarray(q), levels)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)


def test_conflict_analysis_separates_fig1_regimes():
    """The paper's §II.A: the smooth image collides more than the random
    one, and L = 32 less than L = 8."""
    smooth = smooth_texture(128).astype(np.int32)
    rand = random_texture(128).astype(np.int32)
    a8 = conflicts.analyze_image(smooth // 32, 8, device=CPU)
    b8 = conflicts.analyze_image(rand // 32, 8, device=CPU)
    b32 = conflicts.analyze_image(rand // 8, 32, device=CPU)
    assert a8["collision_rate"] > 3 * b8["collision_rate"]
    assert b8["collision_rate"] > b32["collision_rate"]
    assert b32["collision_rate"] < 3 * b32["uniform_baseline"]
