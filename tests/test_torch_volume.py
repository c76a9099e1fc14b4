"""Volumes (``ndim=3``) in repro_torch against the JAX reference.

The depth-slab kernel's plain version is held count for count to the
reference's volume kernel run in interpret mode — all 13 directions, d = 2,
a depth that is not a multiple of slab_d, dz == slab_d, levels outside
[0, L), and scalar and per-volume quantization with values on bin edges.
Scheme 3 (``glcm_blocked``), the volume entry points, 3-D regions, scheme
resolution, the registry's consistency checks and the volume generators are
held to ``repro`` on the CPU: counts exactly, features within rtol 1e-5 /
atol 1e-6 (f14 atol 1e-4) of the reference's formulas in float64. The
``cuda`` test holds the volume kernel to its plain version on the card and
skips where there is none.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import backends, schemes
from repro_torch.core import plan as tplan
from repro_torch.core.glcm import VOLUME_PAIRS, glcm, glcm_features
from repro_torch.core.quantize import uniform_params
from repro_torch.core.spec import GLCMSpec
from repro_torch.data import images as timages
from repro_torch.kernels import ops
from repro_torch.kernels.glcm_kernel import glcm_volume, glcm_volume_plain, launch_plan
from repro_torch.kernels.ref import DIRECTIONS_3D

try:  # the reference needs JAX, which a machine with a card may not have
    import jax.numpy as jnp

    from repro.core import backends as jbackends
    from repro.core import schemes as jschemes
    from repro.core.glcm import glcm as jax_glcm
    from repro.core.plan import compile_plan as jax_compile_plan
    from repro.core.spec import GLCMSpec as JaxSpec
    from repro.data import images as jimages
    from repro.kernels import ops as jops
    from repro.kernels.glcm_kernel import glcm_volume_pallas
    from test_torch_haralick import reference_features
except ImportError:
    jnp = None

RTOL, ATOL, F14_ATOL = 1e-5, 1e-6, 1e-4
D2 = tuple((2 * dz, 2 * dy, 2 * dx) for dz, dy, dx in DIRECTIONS_3D[4:9])
# (offsets, slab_d): the 13 directions with a ragged last slab, d = 2, and
# dz == slab_d with dy < 0.
OFFSET_CASES = [
    (DIRECTIONS_3D, 8),
    (D2, 2),
    (((3, -2, 1), (0, -1, 4), (3, 0, 0)), 3),
]


@pytest.fixture(autouse=True)
def _reference(request):
    if jnp is None and "cuda" not in request.keywords:
        pytest.skip("needs JAX to run the reference")


def _raw_volumes(rng, shape, levels):
    """(2, D, H, W) raw f32 volumes, a third of the values on bin edges."""
    out = []
    for lo, span in ((0.0, 255.0), (-3.5, 7.25)):
        x = (lo + rng.random(shape) * span).astype(np.float32)
        edges = np.float32(lo) + rng.integers(0, levels + 1, size=shape).astype(
            np.float32) * np.float32(span / levels)
        out.append(np.where(rng.random(shape) < 1 / 3, edges, x).astype(np.float32))
    return np.stack(out)


def _volumes(levels, raw, shape=(11, 9, 13)):
    """(2, D, H, W): a smooth and a random volume; raw f32 or int32 levels."""
    x = np.stack([timages.smooth_volume(shape, seed=levels),
                  timages.random_volume(shape, seed=levels)]).astype(np.float32)
    return x if raw else np.floor(x / 256.0 * levels).astype(np.int32)


def _features_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got[..., :13], want[..., :13], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[..., 13], want[..., 13], rtol=0, atol=F14_ATOL)


# ---------------------------------------------------------------------------
# Kernel 4: plain version against the Pallas depth-slab kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("levels", [2, 8, 32, 256])
@pytest.mark.parametrize("offsets,slab_d", OFFSET_CASES)
def test_volume_plain_equals_pallas_int(levels, offsets, slab_d):
    rng = np.random.default_rng(levels + slab_d)
    vol = rng.integers(-2, levels + 2, size=(2, 11, 9, 13)).astype(np.int32)
    want = np.asarray(glcm_volume_pallas(jnp.asarray(vol), levels=levels, offsets=offsets,
                                         slab_d=slab_d, interpret=True))
    got = glcm_volume_plain(torch.from_numpy(vol), levels, offsets)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    got = glcm_volume(torch.from_numpy(vol), levels=levels, offsets=offsets, slab_d=slab_d,
                      copies=3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("levels", [2, 8, 32, 256])
@pytest.mark.parametrize("per_volume", [False, True])
def test_volume_plain_equals_pallas_quant(levels, per_volume):
    rng = np.random.default_rng(levels)
    vol = _raw_volumes(rng, (11, 9, 13), levels)
    if per_volume:
        tq = uniform_params(torch.from_numpy(vol), batched=True)
        jq = (jnp.asarray(tq[0].numpy()), jnp.asarray(tq[1].numpy()))
    else:
        tq = jq = (-3.5, 7.25)
    want = np.asarray(glcm_volume_pallas(jnp.asarray(vol), levels=levels,
                                         offsets=DIRECTIONS_3D, interpret=True, quant=jq))
    got = glcm_volume(torch.from_numpy(vol), levels=levels, offsets=DIRECTIONS_3D, quant=tq)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("levels", [2, 8, 32, 256])
@pytest.mark.parametrize("per_volume", [False, True])
def test_volume_uint8_equals_float32_and_pallas(levels, per_volume):
    """uint8 raw volumes, as the kernel reads them without a float32 copy,
    count as their float32 values do, in the plain version and the
    reference kernel."""
    rng = np.random.default_rng(levels + 3)
    u8 = rng.integers(0, 256, size=(2, 11, 9, 13)).astype(np.uint8)
    u8[1, :4] = 200  # a flat slab
    t8, t32 = torch.from_numpy(u8), torch.from_numpy(u8.astype(np.float32))
    if per_volume:
        tq = uniform_params(t8, batched=True)
        jq = (jnp.asarray(tq[0].numpy()), jnp.asarray(tq[1].numpy()))
    else:
        tq = jq = (3.0, 200.0)
    want = np.asarray(glcm_volume_pallas(jnp.asarray(u8.astype(np.float32)), levels=levels,
                                         offsets=DIRECTIONS_3D, interpret=True, quant=jq))
    for x in (t8, t32):
        np.testing.assert_array_equal(glcm_volume_plain(x, levels, DIRECTIONS_3D, quant=tq).numpy(),
                                      want)
        got = glcm_volume(x, levels=levels, offsets=DIRECTIONS_3D, quant=tq)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("offsets,slab_d", [(DIRECTIONS_3D, 8), (((1, 0, 0), (0, 1, -1)), 1),
                                            (((2, 1, 1), (0, 0, 3)), 2)])
def test_volume_of_depth_one(offsets, slab_d):
    """A volume of depth 1: offsets with dz >= D leave no pair and count
    zero, as in the reference; in-plane offsets still count."""
    rng = np.random.default_rng(slab_d)
    vol = rng.integers(-1, 9, size=(2, 1, 7, 11)).astype(np.int32)
    want = np.asarray(glcm_volume_pallas(jnp.asarray(vol), levels=8, offsets=offsets,
                                         slab_d=slab_d, interpret=True))
    got = glcm_volume(torch.from_numpy(vol), levels=8, offsets=offsets, slab_d=slab_d)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("batched", [False, True])
def test_volume_uint8_entry_points_equal_float32_and_reference(batched):
    """The volume path end to end on uint8 (the generators' own dtype):
    counts equal the float32 volume's and the reference's; features equal
    the float32 volume's exactly."""
    u8 = np.stack([timages.smooth_volume((11, 9, 13), seed=4),
                   timages.random_volume((11, 9, 13), seed=4)])
    if not batched:
        u8 = u8[0]
    f32 = u8.astype(np.float32)
    jspec = JaxSpec(levels=32, pairs=VOLUME_PAIRS, quantize="uniform", ndim=3)
    want = np.asarray(jax_compile_plan(jspec, f32.shape)(jnp.asarray(f32)))
    spec = GLCMSpec.from_dict(dataclasses.asdict(jspec))
    for x in (u8, f32):
        got = tplan.compile_plan(spec, x.shape, device="cpu")(torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        glcm_features(u8, 32, VOLUME_PAIRS, ndim=3, device="cpu").numpy(),
        glcm_features(f32, 32, VOLUME_PAIRS, ndim=3, device="cpu").numpy())


def test_volume_unbatched_and_orientation():
    # (dz, dy, dx) = (1, -1, 0): the reference of (z, y, x) is (z+1, y-1, x);
    # out[ref, assoc], a level outside [0, L) drops its pair.
    vol = torch.tensor([[[0, 1], [2, 3]], [[1, 2], [3, 9]]], dtype=torch.int32)
    got = glcm_volume(vol, levels=4, offsets=((1, -1, 0),))
    want = np.zeros((1, 4, 4), np.int32)
    want[0, 1, 2] = want[0, 2, 3] = 1  # (2 → 1) and (3 → 2)
    np.testing.assert_array_equal(got.numpy(), want)
    jw = glcm_volume_pallas(jnp.asarray(vol.numpy()), levels=4, offsets=((1, -1, 0),),
                            interpret=True)
    np.testing.assert_array_equal(np.asarray(jw), want)


@pytest.mark.parametrize("offset,slab_d", [((9, 0, 0), 8), ((-1, 0, 0), 8),
                                           ((1, 9, 0), 8), ((0, 0, -13), 8)])
def test_volume_errors_match_reference(offset, slab_d):
    vol = np.zeros((2, 11, 9, 13), np.int32)
    with pytest.raises(ValueError) as jerr:
        glcm_volume_pallas(jnp.asarray(vol), levels=8, offsets=(offset,), slab_d=slab_d,
                           interpret=True)
    with pytest.raises(ValueError) as terr:
        glcm_volume(torch.from_numpy(vol), levels=8, offsets=(offset,), slab_d=slab_d)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("quantized", [False, True])
def test_ops_volume_equals_reference_ops(quantized):
    vol = _volumes(8, raw=quantized, shape=(10, 9, 13))
    if quantized:
        tq = uniform_params(torch.from_numpy(vol), batched=True)
        jq = tuple(jnp.asarray(v.numpy()) for v in tq)
    else:
        tq = jq = None
    pairs = ((1, 4), (2, 8), (1, 0), (2, 12))
    want = np.asarray(jops.glcm_pallas_volume(jnp.asarray(vol), 8, pairs, interpret=True,
                                              quant=jq))
    got = ops.glcm_cuda_volume(torch.from_numpy(vol), 8, pairs, quant=tq)
    np.testing.assert_array_equal(got.numpy(), want)
    for offsets, want_slab in ((DIRECTIONS_3D, 8), (((9, 0, 0),), 16), (((0, 0, 1),), 8)):
        assert ops.default_slab_d(offsets) == want_slab


# ---------------------------------------------------------------------------
# Scheme 3 and the volume path end to end, device="cpu"
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_blocks", [1, 2, 4])
@pytest.mark.parametrize("offset", [(0, 1), (1, -1), (2, 2), (1, -1, 1), (2, 0, -2)])
@pytest.mark.parametrize("batched", [False, True])
def test_glcm_blocked_equals_reference(num_blocks, offset, batched):
    rng = np.random.default_rng(num_blocks)
    shape = (16, 9, 13) if len(offset) == 3 else (16, 13)
    x = rng.integers(0, 8, size=(2,) + shape).astype(np.uint8)
    if not batched:
        x = x[0]
    want = np.asarray(jschemes.glcm_blocked(jnp.asarray(x), 8, offset=offset,
                                            num_blocks=num_blocks))
    got = schemes.glcm_blocked(torch.from_numpy(x), 8, offset=offset, num_blocks=num_blocks)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,pairs,num_blocks,match", [
    ((10, 13), ((1, 0),), 4, "image height 10 not divisible"),
    ((2, 9, 8, 8), ((1, 8),), 4, "volume depth 9 not divisible"),
    ((8, 13), ((4, 90),), 4, "halo 4 of offset"),
])
def test_blocked_validate_errors_match_reference(shape, pairs, num_blocks, match):
    ndim = 3 if len(shape) == 4 else 2
    jspec = JaxSpec(levels=8, pairs=pairs, scheme="blocked", num_blocks=num_blocks, ndim=ndim)
    with pytest.raises(ValueError, match=match) as jerr:
        jax_compile_plan(jspec, shape)
    spec = GLCMSpec.from_dict(dataclasses.asdict(jspec))
    with pytest.raises(ValueError, match=match) as terr:
        tplan.compile_plan(spec, shape, device="cpu")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="fused quantization"):
        backends.get_backend("blocked").compute(torch.zeros((1, 8, 8), dtype=torch.int32),
                                                GLCMSpec(levels=8), quant=(0.0, 1.0))


@pytest.mark.parametrize("quantize", [None, "uniform"])
@pytest.mark.parametrize("scheme", ["auto", "scatter", "onehot", "blocked", "cuda",
                                    "cuda_volume"])
def test_volume_counts_equal_reference(quantize, scheme):
    vol = _volumes(8, raw=quantize is not None, shape=(12, 9, 13))
    jspec = JaxSpec(levels=8, pairs=VOLUME_PAIRS, quantize=quantize, ndim=3, num_blocks=3)
    want = np.asarray(jax_compile_plan(jspec, vol.shape)(jnp.asarray(vol)))
    spec = GLCMSpec.from_dict(dataclasses.asdict(jspec)).replace(scheme=scheme)
    got = tplan.compile_plan(spec, vol.shape, device="cpu")(vol)
    assert got.dtype == torch.int32   # count-only plans keep exact int32 counts
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("batched", [False, True])
def test_volume_glcm_features_equal_reference(batched):
    vol = _volumes(32, raw=True)
    if not batched:
        vol = vol[0]
    jspec = JaxSpec(levels=32, pairs=VOLUME_PAIRS, quantize="uniform", ndim=3)
    want_counts = np.asarray(jax_compile_plan(jspec, vol.shape)(jnp.asarray(vol)))
    want = reference_features(want_counts)
    for scheme in ("auto", "cuda_volume", "scatter"):
        got = glcm_features(vol, 32, VOLUME_PAIRS, ndim=3, scheme=scheme, device="cpu")
        assert tuple(got.shape) == want.shape
        _features_close(got.numpy(), want)


def test_volume_glcm_single_direction():
    vol = _volumes(8, raw=True)
    for direction in (0, 4, 7, 12):
        want = np.asarray(jax_glcm(jnp.asarray(vol), 8, 1, direction, ndim=3,
                                   quantize="uniform"))
        for scheme in ("auto", "cuda_volume", "cuda"):
            got = glcm(vol, 8, 1, direction, ndim=3, quantize="uniform", scheme=scheme,
                       device="cpu")
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("region", [
    dict(region="tiles", region_shape=(3, 3, 4)),
    dict(region="window", region_shape=(4, 5, 6), region_stride=(2, 3, 4)),
])
@pytest.mark.parametrize("scheme", ["auto", "onehot", "scatter", "cuda", "cuda_volume"])
def test_volume_regions_equal_reference(region, scheme):
    vol = _volumes(8, raw=True, shape=(9, 9, 12))
    jspec = JaxSpec(levels=8, pairs=((1, 0), (1, 8), (1, 10)), quantize="uniform", ndim=3,
                    **region)
    jplan = jax_compile_plan(jspec, vol.shape)
    want = np.asarray(jplan(jnp.asarray(vol)))
    spec = GLCMSpec.from_dict(dataclasses.asdict(jspec)).replace(scheme=scheme)
    p = tplan.compile_plan(spec, vol.shape, device="cpu")
    assert p.grid == jplan.grid
    np.testing.assert_array_equal(p(vol).numpy(), want)
    if scheme == "auto":
        got = glcm_features(vol, 8, ((1, 0), (1, 8), (1, 10)), ndim=3, device="cpu", **region)
        _features_close(got.numpy(), reference_features(want))


# ---------------------------------------------------------------------------
# Resolution, capabilities and the registry
# ---------------------------------------------------------------------------


def test_volume_resolution():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    vol = GLCMSpec(levels=8, pairs=VOLUME_PAIRS, ndim=3)
    one = GLCMSpec(levels=8, pairs=((1, 7),), ndim=3)
    assert backends.resolve_scheme(vol, cuda) == "cuda_volume"
    assert backends.resolve_scheme(one, cuda) == "cuda_volume"
    assert backends.resolve_scheme(vol, cpu) == "onehot"
    region = GLCMSpec(levels=8, pairs=((1, 8),), ndim=3, region="tiles", region_shape=3)
    assert backends.resolve_scheme(region, cuda) == "cuda_volume"
    assert not backends.get_backend("cuda_volume").caps.region_grid


def test_rank_capabilities_refuse_with_reference_messages():
    cases = [  # (port scheme, reference scheme, ndim, shape)
        ("cuda_fused", "pallas_fused", 3, (4, 8, 8)),
        ("cuda_volume", "pallas_volume", 2, (8, 8)),
    ]
    for tname, jname, ndim, shape in cases:
        pairs = ((1, 8),) if ndim == 3 else ((1, 0),)
        with pytest.raises(ValueError) as jerr:
            jax_compile_plan(JaxSpec(levels=8, pairs=pairs, ndim=ndim, scheme=jname), shape)
        with pytest.raises(ValueError) as terr:
            tplan.compile_plan(GLCMSpec(levels=8, pairs=pairs, ndim=ndim, scheme=tname),
                               shape, device="cpu")
        assert str(terr.value) == str(jerr.value).replace(jname, tname)
    with pytest.raises(ValueError, match="serves only ndim=3") as terr:
        backends.get_backend("cuda_volume").validate(GLCMSpec(levels=8), (8, 8))
    with pytest.raises(ValueError) as jerr:
        jbackends.get_backend("pallas_volume").validate(JaxSpec(levels=8), (8, 8))
    assert str(terr.value) == str(jerr.value).replace("pallas_volume", "cuda_volume").replace(
        '"pallas"/"pallas_fused"', '"cuda"/"cuda_fused"')


@pytest.mark.parametrize("caps,kw,match", [
    (dict(region_grid=True), {}, "region_grid must match"),
    ({}, dict(region_compute=lambda *a, **k: None), "region_grid must match"),
    (dict(volume_only=True), {}, "volume_only requires"),
])
def test_register_consistency_checks(caps, kw, match):
    b = backends.Backend(name="scratch", compute=lambda *a, **k: None,
                         caps=backends.Capabilities(**caps), **kw)
    with pytest.raises(ValueError, match=match):
        backends.register(b)
    assert "scratch" not in backends.available_backends()


def test_volume_only_backends_and_registry():
    assert backends.available_backends() == (
        "blocked", "cuda", "cuda_fused", "cuda_volume", "native", "onehot", "scatter")
    vol_only = backends.get_backend("cuda_volume")
    assert backends.supports_ndim(vol_only, 3) and not backends.supports_ndim(vol_only, 2)
    # device_kernel is the port's counterpart of the reference's tpu_only:
    # a backend whose kernel only runs as such on its device
    fields = {"tpu_only" if f == "device_kernel" else f
              for f in dataclasses.asdict(backends.Capabilities())}
    assert fields <= set(dataclasses.asdict(jbackends.Capabilities()))


# ---------------------------------------------------------------------------
# Data generators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,seed", [((11, 9, 13), 0), (17, 3), ((4, 40, 33), 7)])
def test_volume_generators_equal_reference(shape, seed):
    np.testing.assert_array_equal(timages.smooth_volume(shape, seed=seed),
                                  jimages.smooth_volume(shape, seed=seed))
    np.testing.assert_array_equal(timages.random_volume(shape, seed=seed),
                                  jimages.random_volume(shape, seed=seed))


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [8, 32, 256])
def test_volume_kernel_equals_plain_on_card(levels):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(levels)
    vol = torch.from_numpy(
        rng.integers(-2, levels + 2, size=(2, 19, 23, 29)).astype(np.int32)).to(dev)
    raw = torch.from_numpy(_raw_volumes(rng, (19, 23, 29), levels)).to(dev)
    before = glcm_volume.launches
    for offsets, slab_d in OFFSET_CASES:
        got = glcm_volume(vol, levels=levels, offsets=offsets, slab_d=slab_d, copies=2)
        assert torch.equal(got, glcm_volume_plain(vol, levels, offsets))
        for quant in (uniform_params(raw, batched=True), (-3.5, 7.25)):
            got = glcm_volume(raw, levels=levels, offsets=offsets, slab_d=slab_d, quant=quant)
            assert torch.equal(got, glcm_volume_plain(raw, levels, offsets, quant=quant))
    assert glcm_volume.launches == before + 9


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [64, 128])
def test_volume_cluster_equals_plain_on_card(levels):
    """Over the 13 directions a set outgrows one block where the ring is
    large (L = 64: 208 KiB beside the ring of a 23 x 29 plane) or always
    (L = 128: 832 KiB): a cluster of blocks holds the counts of 7 of them
    and the rest vote with global atomics, bit for bit the plain version's
    as int32 levels, float32 and uint8."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(levels)
    shape = (2, 19, 23, 29)
    plan = launch_plan("glcm_volume", shape, DIRECTIONS_3D, levels=levels, split=8, kind=0)
    assert plan["shared_hist"] == 0 and plan["cluster"] in (2, 4, 8, 16)
    ints = rng.integers(-2, levels + 2, size=shape).astype(np.int32)
    u8 = rng.integers(0, 256, size=shape).astype(np.uint8)
    before = glcm_volume.launches
    for x in (torch.from_numpy(ints).to(dev), torch.from_numpy(u8).to(dev)):
        quant = None if x.dtype == torch.int32 else uniform_params(x, batched=True)
        xs = (x,) if quant is None else (x, x.float())
        for v in xs:
            got = glcm_volume(v, levels=levels, offsets=DIRECTIONS_3D, quant=quant)
            assert torch.equal(got, glcm_volume_plain(v, levels, DIRECTIONS_3D, quant=quant))
    assert glcm_volume.launches == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [32, 255, 256])
def test_volume_march_edges_on_card(levels):
    """The marching kernel's edges on the card: uint8 input with per-volume
    and scalar ranges, a depth of 1, dz == slab_d, out-of-range levels on
    the ring's edges and a slice of a stack."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(levels)
    extra = ((8, 1, -2), (0, -3, 5), (2, 2, 2))
    before = glcm_volume.launches
    for shape in ((1, 9, 40), (19, 23, 29)):
        u8 = torch.from_numpy(rng.integers(0, 256, size=(3,) + shape).astype(np.uint8)).to(dev)
        ints = rng.integers(0, levels, size=(3,) + shape).astype(np.int32)
        ints[..., 0], ints[..., -1], ints[..., 0, :] = -1, levels + 3, levels
        ints = torch.from_numpy(ints).to(dev)
        for offsets in (DIRECTIONS_3D, extra):
            for quant in (uniform_params(u8, batched=True), (3.0, 200.0)):
                got = glcm_volume(u8, levels=levels, offsets=offsets, quant=quant)
                assert torch.equal(got, glcm_volume_plain(u8, levels, offsets, quant=quant))
            for x in (ints, ints[1:]):
                got = glcm_volume(x, levels=levels, offsets=offsets)
                assert torch.equal(got, glcm_volume_plain(x, levels, offsets))
    assert glcm_volume.launches == before + 16
