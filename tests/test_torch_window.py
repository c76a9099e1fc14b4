"""The window kernel's input kinds against the JAX reference, and the
redesigned kernel against its plain version on the card.

``glcm_window`` reads uint8 as it is (the byte kind, binned through a table
of ``bin_values``), int32 levels as they are, and any other dtype as
float32. On the CPU its plain version counts a uint8 tensor with per-image
or scalar ``quant``; that is held count for count to ``repro``'s
``glcm_window_pallas`` in interpret mode on the same numpy uint8 input, and
the texture stream's uint8 frames (``compile_plan(region="window",
temporal_window=)``) are held to ``repro``'s rolling counts. The ``cuda``
tests hold the kernel, on uint8, float32 and int32-level input at
L in {2, 8, 32, 255, 256} and at odd L with 2 to 5 offsets, exactly to
``glcm_window_plain`` over the geometries its staged and direct paths take
apart, and check that a uint8
launch allocates nothing but its output; they skip where there is no card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import plan as tplan
from repro_torch.core.quantize import uniform_params
from repro_torch.core.spec import GLCMSpec
from repro_torch.kernels.glcm_kernel import glcm_window, glcm_window_plain

try:  # the reference needs JAX, which a machine with a card may not have
    import jax.numpy as jnp

    from repro.core import schemes as jschemes
    from repro.core.plan import compile_plan as jax_compile_plan
    from repro.core.spec import GLCMSpec as JaxSpec
    from repro.kernels.glcm_kernel import glcm_window_pallas
except ImportError:
    jnp = None

# (image size, region, stride): overlapping windows with a ragged edge, and
# tiles whose edge does not divide.
GEOMETRIES = [
    ((45, 39), (16, 12), (5, 7)),
    ((45, 39), (16, 12), (16, 12)),
]
LEVELS = [2, 8, 32, 255, 256]


@pytest.fixture(autouse=True)
def _reference(request):
    if jnp is None and "cuda" not in request.keywords:
        pytest.skip("needs JAX to run the reference")


def _offsets(rh, rw):
    """dy == rh - 1, dx < 0, |dx| == rw - 1 both ways, the paper's smallest pair."""
    return ((0, 1), (1, -1), (rh - 1, 2), (3, -(rw - 1)), (0, rw - 1))


def _uint8(rng, shape):
    return rng.integers(0, 256, size=shape, dtype=np.uint8)


# ---------------------------------------------------------------------------
# On the CPU: the uint8 route against the Pallas window kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("levels", LEVELS)
@pytest.mark.parametrize("per_image", [False, True])
@pytest.mark.parametrize("size,region,stride", GEOMETRIES)
def test_window_uint8_equals_pallas(levels, per_image, size, region, stride):
    rng = np.random.default_rng(levels + 7 * region[1] + per_image)
    img = _uint8(rng, (3,) + size)
    offsets = _offsets(*region)
    if per_image:
        tq = uniform_params(torch.from_numpy(img), batched=True)
        jquant = (jnp.asarray(tq[0].numpy()), jnp.asarray(tq[1].numpy()))
    else:
        tq = jquant = (3.0, 200.0)
    patches = jschemes.extract_regions(jnp.asarray(img), region, stride)
    want = np.asarray(glcm_window_pallas(patches, levels=levels, offsets=offsets,
                                         interpret=True, quant=jquant))
    x = torch.from_numpy(img)
    assert x.dtype == torch.uint8
    got = glcm_window_plain(x, levels, offsets, region_shape=region, stride=stride, quant=tq)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # The wrapper on a CPU uint8 tensor, from the image and from the patch grid.
    np.testing.assert_array_equal(
        glcm_window(x, levels=levels, offsets=offsets, region_shape=region, stride=stride,
                    quant=tq).numpy(), want)
    np.testing.assert_array_equal(
        glcm_window(torch.from_numpy(np.array(patches)), levels=levels, offsets=offsets,
                    quant=tq).numpy(), want)


@pytest.mark.parametrize("levels", [8, 32])
@pytest.mark.parametrize("region", [
    {"region": "window", "region_shape": 12, "region_stride": 8},
    {"region": "tiles", "region_shape": (7, 8)},
])
def test_texture_stream_uint8_frames_equal_reference(levels, region):
    # texture_video's frames are uint8; the stream plan hands them to the
    # window backend raw, with the spec's fixed range.
    rng = np.random.default_rng(levels)
    window, shape = 4, (28, 24)
    video = _uint8(rng, (3 * window + 1,) + shape)
    kw = dict(levels=levels, pairs=((1, 0), (1, 45), (4, 0)), quantize="uniform",
              vrange=(0, 255), **region)
    plan = tplan.compile_plan(GLCMSpec(scheme="cuda_fused", **kw), shape,
                              temporal_window=window, device="cpu")
    assert plan.fused_quantize
    got = plan.rolling(video).numpy()
    jplan = jax_compile_plan(JaxSpec(scheme="onehot", **kw), shape, temporal_window=window)
    np.testing.assert_array_equal(got, np.asarray(jplan.rolling(jnp.asarray(video))))
    # The same frames as float32 give the same counts.
    np.testing.assert_array_equal(got, plan.rolling(video.astype(np.float32)).numpy())


# ---------------------------------------------------------------------------
# On the card: the kernel against its plain version
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _input(rng, kind, shape, levels, dev):
    """(x, quant): uint8 or float32 raw values with per-image ranges, or int32
    levels with -1 pads and values >= L that must not vote."""
    if kind == "int32":
        x = rng.integers(-1, levels + 3, size=shape).astype(np.int32)
        x[..., ::7] = -1
        return torch.from_numpy(x).to(dev), None
    u8 = _uint8(rng, shape)
    x = torch.from_numpy(u8 if kind == "uint8" else u8.astype(np.float32) * 1.37 - 20.0)
    x = x.to(dev)
    return x, uniform_params(x, batched=True)


# (image size, region, stride, offsets or None for _offsets): a grid row
# shorter than a staged run (gw = 17: one full run and a short one), a grid
# smaller than the card's resident blocks, tiles, 64² windows at stride 8,
# 256² tiles.
CARD_GEOMETRIES = [
    ((45, 124), (16, 12), (5, 7), None),
    ((20, 19), (16, 12), (4, 7), None),
    ((45, 39), (16, 12), None, None),
    ((160, 136), (64, 64), (8, 8), ((0, 1), (1, -1), (0, 4), (4, -4), (63, -63))),
    ((512, 768), (256, 256), None, ((0, 1), (1, -1), (255, 0), (4, -255))),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["uint8", "float32", "int32"])
@pytest.mark.parametrize("levels", LEVELS)
def test_window_kernel_cases_on_card(kind, levels):
    dev = _card()
    rng = np.random.default_rng(levels)
    before = glcm_window.launches
    n = 0
    for size, region, stride, offsets in CARD_GEOMETRIES:
        offsets = offsets or _offsets(*region)
        x, quant = _input(rng, kind, (3,) + size, levels, dev)
        kw = dict(region_shape=region, stride=stride)
        want = glcm_window_plain(x, levels, offsets, quant=quant, **kw)
        for copies in (1, 2):
            got = glcm_window(x, levels=levels, offsets=offsets, quant=quant, copies=copies, **kw)
            assert torch.equal(got, want), (size, region, stride, copies)
        # A patch grid, and a slice of the batch (a non-zero storage offset).
        patches = x.unfold(1, region[0], (stride or region)[0]).unfold(
            2, region[1], (stride or region)[1]).contiguous()
        got = glcm_window(patches, levels=levels, offsets=offsets, quant=quant)
        assert torch.equal(got, want), (size, region, "patch grid")
        q1 = None if quant is None else (quant[0][1:], quant[1][1:])
        got = glcm_window(x[1:], levels=levels, offsets=offsets, quant=q1, **kw)
        assert torch.equal(got, want[1:]), (size, region, "slice")
        n += 4
    torch.cuda.synchronize()
    assert glcm_window.launches == before + n


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["uint8", "float32", "int32"])
@pytest.mark.parametrize("levels", [3, 5, 7])
def test_window_kernel_odd_slots_on_card(kind, levels):
    # At odd L a slot of n_off L x L int32 is whole 16-byte units, and so
    # staged, only when n_off is a multiple of 4; other slots take the
    # direct path. Both, overlapping and tiled, at every count of offsets.
    dev = _card()
    rng = np.random.default_rng(100 + levels)
    offsets = ((0, 1), (1, -1), (15, 3), (2, -11), (0, 11))
    x, quant = _input(rng, kind, (3, 45, 39), levels, dev)
    for n_off in (2, 3, 4, 5):
        for stride in ((5, 7), None):
            kw = dict(region_shape=(16, 12), stride=stride)
            want = glcm_window_plain(x, levels, offsets[:n_off], quant=quant, **kw)
            for copies in (1, 2):
                got = glcm_window(x, levels=levels, offsets=offsets[:n_off], quant=quant,
                                  copies=copies, **kw)
                assert torch.equal(got, want), (n_off, stride, copies)


@pytest.mark.cuda
def test_window_uint8_allocates_only_its_output_on_card():
    dev = _card()
    rng = np.random.default_rng(5)
    u8 = torch.from_numpy(_uint8(rng, (2, 1024, 1024))).to(dev)
    quant = uniform_params(u8, batched=True)
    offsets = ((0, 1), (1, -1), (0, 4), (4, -4))
    kw = dict(levels=32, offsets=offsets, region_shape=32, stride=16, quant=quant)
    want = glcm_window(u8.to(torch.float32), **kw)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    got = glcm_window(u8, **kw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - before
    assert torch.equal(got, want)
    out_bytes = got.numel() * 4
    assert out_bytes <= peak < out_bytes + 4096, (peak, out_bytes)
