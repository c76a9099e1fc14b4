"""The CUDA kernels' wrappers of repro_torch against the Pallas kernels.

On the CPU a wrapper computes its kernel's plain version; these tests hold
that version, count for count, against the reference kernels run in
interpret mode — with -1 padding, levels outside [0, L), dx < 0,
dy == tile_h, a height that is not a multiple of tile_h, and scalar and
per-image quantization. The ``cuda`` tests hold each kernel against its
plain version on the card and skip where there is none; f14's eigensolver
(``second_eigenvalue``) has no Pallas counterpart and is held to its plain
version only.
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.scopes import recording
from repro_torch.core.glcm import PAPER_PAIRS, glcm_features
from repro_torch.core.haralick import haralick_features
from repro_torch.core.plan import compile_plan
from repro_torch.core.quantize import uniform_params
from repro_torch.core.spec import GLCMSpec
from repro_torch.data.images import random_texture, smooth_texture
from repro_torch.kernels import build, ops
from repro_torch.kernels.glcm_kernel import (
    KIND_BYTE,
    KIND_FLOAT,
    glcm_fused,
    glcm_fused_plain,
    glcm_vote,
    glcm_vote_plain,
    launch_plan,
)
from repro_torch.kernels import mcc_kernel
from repro_torch.kernels.mcc_kernel import second_eigenvalue, second_eigenvalue_plain

try:  # the reference needs JAX, which a machine with a card may not have
    import jax.numpy as jnp

    from repro.core.plan import compile_plan as jax_compile_plan
    from repro.core.spec import GLCMSpec as JaxSpec
    from repro.kernels import ops as jops
    from repro.kernels.glcm_kernel import glcm_fused_pallas, glcm_vote_pallas
except ImportError:
    jnp = None

PAPER_OFFSETS = ((0, 1), (1, -1), (0, 4), (4, -4))


def _need_reference():
    if jnp is None:
        pytest.skip("needs JAX to run the reference kernels")


def _streams(rng, b, n, levels):
    """Pair streams with -1 pads and levels outside [0, L) on both sides."""
    a = rng.integers(-3, levels + 3, size=(b, n)).astype(np.int32)
    r = rng.integers(-3, levels + 3, size=(b, n)).astype(np.int32)
    a[:, n // 2: n // 2 + 7] = -1
    return a, r


@pytest.mark.parametrize("levels", [2, 8, 32, 256])
@pytest.mark.parametrize("b,n", [(1, 2048), (3, 3001)])
@pytest.mark.parametrize("copies", [1, 4])
def test_vote_plain_equals_pallas(levels, b, n, copies):
    _need_reference()
    rng = np.random.default_rng(levels * 100 + n)
    a, r = _streams(rng, b, n, levels)
    want = np.asarray(glcm_vote_pallas(jnp.asarray(a), jnp.asarray(r), levels=levels,
                                       copies=copies, interpret=True))
    got = glcm_vote(torch.from_numpy(a), torch.from_numpy(r), levels=levels, copies=copies)
    assert got.dtype == torch.int32 and tuple(got.shape) == (b, levels, levels)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        glcm_vote_plain(torch.from_numpy(a), torch.from_numpy(r), levels).numpy(), want)


def test_vote_unbatched_and_orientation():
    _need_reference()
    a = torch.tensor([0, 1, -1, 2, 9, 3], dtype=torch.int32)
    r = torch.tensor([3, -1, 4, 5, 1, 8], dtype=torch.int32)
    got = glcm_vote(a, r, levels=8)
    want = np.zeros((8, 8), np.int32)
    want[3, 0] = want[5, 2] = 1  # out[ref, assoc]; pairs with a side outside [0, 8) drop
    np.testing.assert_array_equal(got.numpy(), want)
    jw = glcm_vote_pallas(jnp.asarray(a.numpy()), jnp.asarray(r.numpy()), levels=8,
                          interpret=True)
    np.testing.assert_array_equal(np.asarray(jw), want)


def _raw_images(rng, b, h, w, levels):
    """Raw f32 images, a third of the values exactly on bin edges."""
    out = []
    for lo, span in ((0.0, 255.0), (-3.5, 7.25), (10.0, 1e-3))[:b]:
        x = (lo + rng.random((h, w)) * span).astype(np.float32)
        edges = np.float32(lo) + rng.integers(0, levels + 1, size=(h, w)).astype(
            np.float32) * np.float32(span / levels)
        out.append(np.where(rng.random((h, w)) < 1 / 3, edges, x).astype(np.float32))
    return np.stack(out)


@pytest.mark.parametrize("levels", [2, 8, 32, 256])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("offsets,tile_h", [
    (PAPER_OFFSETS, 8),
    (((8, 3), (8, -5), (0, -2), (3, 0)), 8),      # dy == tile_h, dx < 0
    (((1, -1), (2, 2)), 2),                        # small tiles: many row tiles
])
def test_fused_plain_equals_pallas_int(levels, b, offsets, tile_h):
    _need_reference()
    rng = np.random.default_rng(levels + b)
    h, w = 67, 61  # H not a multiple of tile_h, W odd
    img = rng.integers(-2, levels + 2, size=(b, h, w)).astype(np.int32)
    want = np.asarray(glcm_fused_pallas(jnp.asarray(img), levels=levels, offsets=offsets,
                                        tile_h=tile_h, interpret=True))
    got = glcm_fused(torch.from_numpy(img), levels=levels, offsets=offsets, tile_h=tile_h)
    assert got.dtype == torch.int32 and tuple(got.shape) == (b, len(offsets), levels, levels)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("levels", [2, 8, 32, 256])
@pytest.mark.parametrize("per_image", [False, True])
def test_fused_plain_equals_pallas_quant(levels, per_image):
    _need_reference()
    rng = np.random.default_rng(levels)
    img = _raw_images(rng, 3, 67, 61, levels)
    offsets = PAPER_OFFSETS + ((8, 3),)
    if per_image:
        tq = uniform_params(torch.from_numpy(img), batched=True)
        jquant = (jnp.asarray(tq[0].numpy()), jnp.asarray(tq[1].numpy()))
    else:
        tq = jquant = (-3.5, 7.25)
    want = np.asarray(glcm_fused_pallas(jnp.asarray(img), levels=levels, offsets=offsets,
                                        tile_h=8, interpret=True, quant=jquant))
    got = glcm_fused(torch.from_numpy(img), levels=levels, offsets=offsets, tile_h=8, quant=tq)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        glcm_fused_plain(torch.from_numpy(img), levels, offsets, quant=tq).numpy(), want)


@pytest.mark.parametrize("levels", [2, 8, 32, 256])
@pytest.mark.parametrize("per_image", [False, True])
def test_fused_uint8_equals_float32_and_pallas(levels, per_image):
    """uint8 raw images, as the kernel reads them without a float32 copy,
    count as their float32 values do, in the plain version and the
    reference kernel."""
    _need_reference()
    rng = np.random.default_rng(levels + 7)
    u8 = rng.integers(0, 256, size=(3, 67, 61)).astype(np.uint8)
    u8[1, :20] = 17  # a flat band
    offsets = PAPER_OFFSETS + ((8, 3),)
    t8, t32 = torch.from_numpy(u8), torch.from_numpy(u8.astype(np.float32))
    if per_image:
        tq = uniform_params(t8, batched=True)
        jquant = (jnp.asarray(tq[0].numpy()), jnp.asarray(tq[1].numpy()))
    else:
        tq = jquant = (3.0, 200.0)
    want = np.asarray(glcm_fused_pallas(jnp.asarray(u8.astype(np.float32)), levels=levels,
                                        offsets=offsets, tile_h=8, interpret=True, quant=jquant))
    for x in (t8, t32):
        np.testing.assert_array_equal(glcm_fused_plain(x, levels, offsets, quant=tq).numpy(), want)
        got = glcm_fused(x, levels=levels, offsets=offsets, tile_h=8, quant=tq)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("h", [1, 3, 8])
def test_fused_offsets_past_the_height(h):
    """dy >= H (allowed up to tile_h) leaves no pair: those offsets count
    zero, as in the reference; the others still count."""
    _need_reference()
    rng = np.random.default_rng(h)
    img = rng.integers(-1, 9, size=(2, h, 21)).astype(np.int32)
    offsets = ((0, 1), (1, -1), (4, 2), (8, -3))
    want = np.asarray(glcm_fused_pallas(jnp.asarray(img), levels=8, offsets=offsets, tile_h=8,
                                        interpret=True))
    got = glcm_fused(torch.from_numpy(img), levels=8, offsets=offsets, tile_h=8)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("batched", [False, True])
def test_uint8_entry_points_equal_float32_and_reference(batched):
    """glcm_features' path on uint8 images (the generators' own dtype):
    counts equal the float32 images' and the reference's; features equal
    the float32 images' exactly."""
    _need_reference()
    u8 = np.stack([smooth_texture(64, seed=2), random_texture(64, seed=2)])
    if not batched:
        u8 = u8[0]
    f32 = u8.astype(np.float32)
    jspec = JaxSpec(levels=32, pairs=PAPER_PAIRS, quantize="uniform")
    want = np.asarray(jax_compile_plan(jspec, f32.shape)(jnp.asarray(f32)))
    spec = GLCMSpec(levels=32, pairs=PAPER_PAIRS, quantize="uniform")
    for x in (u8, f32):
        got = compile_plan(spec, x.shape, device="cpu")(torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(glcm_features(u8, 32, device="cpu").numpy(),
                                  glcm_features(f32, 32, device="cpu").numpy())


def test_fused_unbatched():
    _need_reference()
    rng = np.random.default_rng(5)
    img = rng.integers(0, 8, size=(20, 13)).astype(np.int32)
    want = np.asarray(glcm_fused_pallas(jnp.asarray(img), levels=8, offsets=PAPER_OFFSETS,
                                        tile_h=8, interpret=True))
    got = glcm_fused(torch.from_numpy(img), levels=8, offsets=PAPER_OFFSETS)
    assert tuple(got.shape) == (4, 8, 8)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("levels", [8, 32])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("quantized", [False, True])
def test_ops_equal_reference_ops(levels, batched, quantized):
    _need_reference()
    rng = np.random.default_rng(levels)
    if quantized:
        img = _raw_images(rng, 3, 45, 39, levels)
    else:
        img = rng.integers(0, levels, size=(3, 45, 39)).astype(np.int32)
    if not batched:
        img = img[0]
    if quantized:
        tquant = uniform_params(torch.from_numpy(img), batched=batched)
        jquant = tuple(jnp.asarray(np.asarray(v)) for v in tquant)
    else:
        tquant = jquant = None
    pairs = ((1, 0), (1, 45), (4, 0), (4, 45))
    for d, t in pairs:
        want = np.asarray(jops.glcm_pallas(jnp.asarray(img), levels, d, t, interpret=True,
                                           quant=jquant))
        got = ops.glcm_cuda(torch.from_numpy(img), levels, d, t, quant=tquant)
        np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jops.glcm_pallas_multi(jnp.asarray(img), levels, pairs, interpret=True,
                                             quant=jquant))
    got = ops.glcm_cuda_multi(torch.from_numpy(img), levels, pairs, quant=tquant)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ops_volume_offset():
    _need_reference()
    rng = np.random.default_rng(9)
    vol = rng.integers(0, 8, size=(2, 6, 9, 7)).astype(np.int32)
    for off in ((1, -1, 1), (0, 1, -1), (1, 0, 0)):
        want = np.asarray(jops.glcm_pallas(jnp.asarray(vol), 8, offset=off, interpret=True))
        got = ops.glcm_cuda(torch.from_numpy(vol), 8, offset=off)
        np.testing.assert_array_equal(got.numpy(), want)


def test_default_tile_h_matches_reference():
    for offsets, want in ((PAPER_OFFSETS, 8), (((9, 0),), 16), (((0, 1),), 8)):
        assert ops.default_tile_h(offsets) == want


def test_cpu_tensors_never_count_launches():
    before = (glcm_vote.launches, glcm_fused.launches)
    img = torch.zeros((2, 9, 9), dtype=torch.int32)
    glcm_fused(img, levels=4, offsets=PAPER_OFFSETS)
    glcm_vote(img.reshape(2, -1), img.reshape(2, -1), levels=4)
    assert (glcm_vote.launches, glcm_fused.launches) == before


@pytest.mark.parametrize("kwargs,match", [
    (dict(offsets=((9, 0),), tile_h=8), "tile_h"),
    (dict(offsets=((-1, 0),), tile_h=8), "tile_h"),
    (dict(offsets=((0, 9),), tile_h=8), "width"),
    (dict(offsets=(), tile_h=8), "offsets"),
    (dict(offsets=((0, 1),), tile_h=8, levels=1), "levels"),
])
def test_fused_rejects_bad_arguments(kwargs, match):
    kwargs = {"levels": 8, **kwargs}
    with pytest.raises(ValueError, match=match):
        glcm_fused(torch.zeros((2, 10, 9), dtype=torch.int32), **kwargs)


@pytest.mark.parametrize("a_shape,r_shape,kw,match", [
    ((3, 10), (3, 11), {}, "equal"),
    ((2, 2, 2), (2, 2, 2), {}, "equal"),
    ((10,), (10,), dict(chunk=10, copies=3), "divisible"),
    ((10,), (10,), dict(levels=300), "levels"),
])
def test_vote_rejects_bad_arguments(a_shape, r_shape, kw, match):
    kw = {"levels": 8, **kw}
    with pytest.raises(ValueError, match=match):
        glcm_vote(torch.zeros(a_shape, dtype=torch.int32),
                  torch.zeros(r_shape, dtype=torch.int32), **kw)


def test_build_flags_keep_ieee_arithmetic():
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-prec-div=true" in flags and "-ftz=false" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert set(build.KERNELS) == {k.library for k in build.TABLE} == {
        "glcm_vote", "glcm_fused", "glcm_window", "glcm_volume", "histogram", "haralick_mcc",
        "haralick_tail"}
    for name in build.KERNELS:
        path = build.library_path(name)
        assert path.parent == build.BUILD_DIR and path.name.startswith(f"lib{name}-")
        assert (build.CSRC / f"{name}.cu").exists()
    for name in ("glcm_fused", "glcm_window", "glcm_volume", "histogram"):
        assert build.CSRC / "glcm_common.cuh" in build.sources(name)


def test_kernel_table_has_one_row_a_library():
    """Every ``csrc/*.cu`` library has exactly one row of the table, each
    row's wrapper counts its launches, and the roles split the wrappers into
    the counting kernels and the feature kernels."""
    assert sorted(k.library for k in build.TABLE) == sorted(p.stem for p in build.CSRC.glob("*.cu"))
    for k in build.TABLE:
        assert k.wrapper.__name__ == k.name and isinstance(k.wrapper.launches, int)
    assert build.wrappers() == tuple(k.wrapper for k in build.TABLE)
    assert {k.role for k in build.TABLE} == {"counts", "features"}
    assert [k.name for k in build.TABLE if k.role == "features"] == ["second_eigenvalue",
                                                                     "haralick_tail"]


def test_dispatch_takes_the_plain_version_in_its_scope_on_the_cpu():
    """The wrapper rule: the plain version inside ``kernel:<wrapper>`` on a
    CPU tensor, a launch on a CUDA one, and another device raises."""
    with recording() as rec:
        got = build.dispatch(glcm_vote, torch.zeros(2), lambda: "plain", lambda: "kernel")
    assert got == "plain" and rec.entered == ["kernel:glcm_vote"]
    with pytest.raises(ValueError, match="glcm_vote: unsupported device meta"):
        build.dispatch(glcm_vote, torch.zeros(2, device="meta"), lambda: "plain",
                       lambda: "kernel")


def test_library_path_hashes_included_headers(tmp_path, monkeypatch):
    # An edited header must give a new library name, or a stale library
    # built from the old header would be loaded. No compiler is called.
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("constexpr int kB = 1;\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert build.sources("k") == [tmp_path / "k.cu", tmp_path / "a.cuh", tmp_path / "b.cuh"]
    before = build.library_path("k")
    (tmp_path / "b.cuh").write_text("constexpr int kB = 2;\n")  # included through a.cuh
    after = build.library_path("k")
    assert after != before and after.name.startswith("libk-")
    (tmp_path / "b.cuh").write_text("constexpr int kB = 1;\n")
    assert build.library_path("k") == before


def test_build_without_nvcc_raises(monkeypatch):
    # No compiler on the path and none under CUDA_HOME: a build must raise,
    # never hand back a substitute (BUILD_DIR moves so no built library is found).
    monkeypatch.setattr(shutil, "which", lambda _: None)
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR / "test-no-nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(("glcm_vote",))


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [8, 32, 128, 255, 256])
def test_kernels_equal_plain_on_card(levels):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(levels)
    a, r = _streams(rng, 3, 100_003, levels)
    ta, tr = torch.from_numpy(a).to(dev), torch.from_numpy(r).to(dev)
    before = glcm_vote.launches
    for copies in (1, 4):
        got = glcm_vote(ta, tr, levels=levels, copies=copies)
        assert torch.equal(got, glcm_vote_plain(ta, tr, levels))
    assert glcm_vote.launches == before + 2

    img = torch.from_numpy(
        rng.integers(-2, levels + 2, size=(3, 131, 77)).astype(np.int32)).to(dev)
    offsets = PAPER_OFFSETS + ((8, 3),)
    got = glcm_fused(img, levels=levels, offsets=offsets, tile_h=8)
    assert torch.equal(got, glcm_fused_plain(img, levels, offsets))
    raw = torch.from_numpy(_raw_images(rng, 3, 131, 77, levels)).to(dev)
    for quant in (uniform_params(raw, batched=True), (-3.5, 7.25)):
        got = glcm_fused(raw, levels=levels, offsets=offsets, tile_h=8, quant=quant)
        assert torch.equal(got, glcm_fused_plain(raw, levels, offsets, quant=quant))


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [32, 255, 256])
def test_fused_march_edges_on_card(levels):
    """The marching kernel's edges on the card: uint8 input with per-image
    and scalar ranges, a width past one 4096-column strip that is not a
    multiple of 16 bytes, H < 1 + max dy, out-of-range levels on the strip
    edges and slices of a stack (16-byte aligned and not)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(levels)
    offsets = PAPER_OFFSETS + ((8, 3), (8, -7))
    before = glcm_fused.launches
    for h, w in ((3, 4129), (37, 513)):
        u8 = torch.from_numpy(rng.integers(0, 256, size=(3, h, w)).astype(np.uint8)).to(dev)
        for quant in (uniform_params(u8, batched=True), (3.0, 200.0)):
            got = glcm_fused(u8, levels=levels, offsets=offsets, quant=quant)
            assert torch.equal(got, glcm_fused_plain(u8, levels, offsets, quant=quant))
        ints = rng.integers(0, levels, size=(3, h, w)).astype(np.int32)
        ints[..., 0], ints[..., -1], ints[..., 0, :] = -1, levels + 3, levels
        ints[..., 4095 % w], ints[..., 4096 % w] = levels, -2
        ints = torch.from_numpy(ints).to(dev)
        for x in (ints, ints[1:]):
            assert torch.equal(glcm_fused(x, levels=levels, offsets=offsets),
                               glcm_fused_plain(x, levels, offsets))
        flat = torch.from_numpy(_raw_images(rng, 1, 1, 2 * h * w + 3, levels)[0, 0]).to(dev)
        odd = flat[3:].reshape(2, h, w)
        got = glcm_fused(odd, levels=levels, offsets=offsets, quant=(0.0, 255.0))
        assert torch.equal(got, glcm_fused_plain(odd, levels, offsets, quant=(0.0, 255.0)))
    assert glcm_fused.launches == before + 10


SKIMAGE_OFFSETS = ((0, 1), (1, -1), (1, 0), (1, 1))  # graycomatrix's 0, 45, 90, 135 at d = 1
MANY_OFFSETS = tuple((d * dy, d * dx) for d in range(1, 9) for dy, dx in SKIMAGE_OFFSETS)  # 32


def _textures(b, h, w, seed):
    """(b, h, w) uint8: smooth and random textures in turn."""
    make = (smooth_texture, random_texture)
    return np.stack([make[i % 2](max(h, w), seed=seed + i)[:h, :w] for i in range(b)])


@pytest.mark.cuda
@pytest.mark.parametrize("levels,offsets", [
    (128, SKIMAGE_OFFSETS), (128, PAPER_OFFSETS), (255, SKIMAGE_OFFSETS),
    (255, PAPER_OFFSETS), (256, SKIMAGE_OFFSETS), (256, PAPER_OFFSETS), (256, MANY_OFFSETS)])
def test_fused_cluster_equals_plain_on_card(levels, offsets):
    """Where one set of counts (n_off L² int32) outgrows a block's shared
    memory, a cluster of blocks holds half the offsets' counts and the rest
    vote with global atomics (32 offsets at L = 256: half of them, 4 MB, fit
    no cluster, so all vote with global atomics): bit for bit the plain
    version's on smooth and random images as uint8, float32 and int32
    levels, in batches of 1 and 9, at a height (1027) that no cluster size
    divides, so a cluster's share of an image leaves its blocks unequal
    spans and, at 9 images, crosses from one image to the next."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(levels + len(offsets))
    h, w = 1027, 777
    for b in (1, 9):
        plan = launch_plan("glcm_fused", (b, h, w), offsets, levels=levels,
                           split=ops.default_tile_h(offsets), kind=KIND_BYTE)
        assert plan["shared_hist"] == 0 and plan["copies"] == 1
        if len(offsets) == 32:
            assert plan["cluster"] == 0
        else:
            assert plan["cluster"] in (2, 4, 8, 16) and plan["grid"] % plan["cluster"] == 0
    u8 = torch.from_numpy(_textures(9, h, w, seed=levels)).to(dev)
    ints = rng.integers(-2, levels + 2, size=(9, h, w)).astype(np.int32)
    ints[..., 0], ints[..., -1] = -1, levels  # levels outside [0, L) on the ring's edges
    before = glcm_fused.launches
    for b in (1, 9):
        x = u8[:b]
        quant = uniform_params(x, batched=True)
        for img, q in ((x, quant), (x.float(), quant), (torch.from_numpy(ints[:b]).to(dev), None)):
            got = glcm_fused(img, levels=levels, offsets=offsets, quant=q)
            assert torch.equal(got, glcm_fused_plain(img, levels, offsets, quant=q))
    assert glcm_fused.launches == before + 6


# The parent's launch of the resident cells' count (8 x 4096² at L = 32, the
# paper's four offsets), read on an NVIDIA H100 80GB HBM3 before the cluster
# route was added.
L32_GEOMETRY = dict(blocks_per_sm=3, smem_bytes=41696, shared_hist=1, copies=1, runs=256,
                    tile_rows=1, grid=392)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", [KIND_BYTE, KIND_FLOAT])
def test_fused_shared_geometry_is_the_parents_on_card(kind):
    """Where one set fits a block, the count keeps its per-block shared
    sets and the geometry it had before clusters: the four cells that run
    the paper's L = 32 must not move."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    plan = launch_plan("glcm_fused", (8, 4096, 4096), PAPER_OFFSETS, levels=32,
                       split=ops.default_tile_h(PAPER_OFFSETS), kind=kind)
    assert {k: plan[k] for k in L32_GEOMETRY} == L32_GEOMETRY
    assert plan["cluster"] == 0


# ---------------------------------------------------------------------------
# f14's eigensolver (second_eigenvalue)
# ---------------------------------------------------------------------------

MCC_ATOL = 1e-12  # |Δλ₂| of the kernel against the plain version


def _mcc_counts(rng, levels, n=3):
    """Count matrices f14 meets, as ``_glcm_counts`` of the Haralick tests
    makes them (iid, sparse, co-occurrences of a smooth image), and those
    whose grams are of rank 1 and 2, zero, diagonal with a repeated
    eigenvalue, and with λ₁ ≈ λ₂ (two blocks)."""
    L = levels
    iid = rng.integers(0, 50, size=(n, L, L))
    sparse = rng.integers(0, 50, size=(n, L, L)) * (rng.random((n, L, L)) < 0.2)
    sparse[:, 0, 0] += 1
    smooth = np.zeros((n, L, L))
    for i in range(n):
        base = np.cumsum(rng.normal(size=(48, 48)), axis=1)
        base += np.cumsum(rng.normal(size=(48, 48)), axis=0)
        q = np.floor((base - base.min()) / (np.ptp(base) + 1e-9) * L).clip(0, L - 1)
        q = q.astype(np.int64)
        np.add.at(smooth[i], (q[1:, :-1], q[:-1, 1:]), 1)
    u, v = np.arange(1.0, L + 1), np.arange(L, 0.0, -1)
    w = np.arange(L) % 3 + 1.0
    blocks = np.zeros((L, L))
    h = L // 2
    blocks[:h, :h], blocks[h:, h:] = 1.0, 1.0 + 1e-9
    special = np.stack([np.outer(u, v), np.outer(u, v) + np.outer(w, w[::-1]),
                        np.zeros((L, L)), np.eye(L), np.diag(np.r_[3.0, 3.0, np.ones(L - 2)]),
                        blocks])
    return np.concatenate([iid, sparse, smooth, special]).astype(np.float64)


def _mcc_inputs(counts):
    p = counts.to(torch.float64)
    p = p / p.sum(dim=(-2, -1), keepdim=True).clamp_min(1e-12)
    return p, p.sum(dim=2), p.sum(dim=1)


def test_second_eigenvalue_checks_its_arguments():
    p, px, py = _mcc_inputs(torch.from_numpy(_mcc_counts(np.random.default_rng(0), 4)))
    with pytest.raises(ValueError, match=r"\(N, L, L\)"):
        second_eigenvalue(p[:, :, :3], px, py)
    with pytest.raises(ValueError, match="marginals"):
        second_eigenvalue(p, px[:, :3], py)
    before = second_eigenvalue.launches
    # On the CPU every width, dtype and layout takes the plain version.
    assert torch.equal(second_eigenvalue(p, px, py), second_eigenvalue_plain(p, px, py))
    assert second_eigenvalue.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [2, 3, 8, 16, 31, 32, 33, 64, 100, 256, 1024])
def test_second_eigenvalue_equals_plain_on_card(levels):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    counts = torch.from_numpy(_mcc_counts(np.random.default_rng(levels), levels))
    p, px, py = _mcc_inputs(counts.to("cuda"))
    before = second_eigenvalue.launches
    got = second_eigenvalue(p, px, py)
    assert second_eigenvalue.launches == before + 1
    want = second_eigenvalue_plain(p, px, py)
    assert got.dtype == torch.float64 and got.shape == want.shape
    assert float((got - want).abs().max()) <= MCC_ATOL
    cpu = second_eigenvalue(*(t.cpu() for t in (p, px, py)))
    assert float((got.cpu() - cpu).abs().max()) <= MCC_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["smooth", "random"])
def test_second_eigenvalue_texture_map_on_card(kind):
    """The texture map's 260 100 matrices of one seeded 4096² image (32²
    windows at stride 16, the paper's four pairs), in one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    make = smooth_texture if kind == "smooth" else random_texture
    img = torch.from_numpy(make(4096, seed=3).astype(np.float32)).to("cuda")
    spec = GLCMSpec(levels=32, pairs=PAPER_PAIRS, quantize="uniform", region="window",
                    region_shape=32, region_stride=16)
    counts = compile_plan(spec, tuple(img.shape), device="cuda")(img)
    p, px, py = _mcc_inputs((counts + counts.transpose(-1, -2)).reshape(-1, 32, 32))
    assert p.shape[0] == 260_100
    before = second_eigenvalue.launches
    got = second_eigenvalue(p, px, py)
    assert second_eigenvalue.launches == before + 1
    assert float((got - second_eigenvalue_plain(p, px, py)).abs().max()) <= MCC_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [8, 32, 64, 256])
def test_haralick_features_with_the_kernel_equal_plain_on_card(monkeypatch, levels):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    counts = torch.from_numpy(_mcc_counts(np.random.default_rng(levels + 1), levels)).to("cuda")
    before = second_eigenvalue.launches
    got = haralick_features(counts)
    assert second_eigenvalue.launches == before + 1
    monkeypatch.setattr(mcc_kernel, "second_eigenvalue", lambda p, px, py:
                        second_eigenvalue_plain(p, px, py))
    want = haralick_features(counts)
    assert float((got - want).abs().max()) <= 1e-7


@pytest.mark.cuda
def test_second_eigenvalue_raises_on_card():
    """Past L = 1024, on float32 and on a non-contiguous input the card
    raises and launches nothing: no fallback."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    rng = np.random.default_rng(33)
    wide = torch.zeros((1, 1025, 1025), dtype=torch.float64, device="cuda")
    q, qx, qy = _mcc_inputs(torch.from_numpy(_mcc_counts(rng, 32)).to("cuda"))
    before = second_eigenvalue.launches
    with pytest.raises(ValueError, match="L <= 1024"):
        second_eigenvalue(wide, wide[:, 0], wide[:, 0])
    with pytest.raises(ValueError, match="float64"):
        second_eigenvalue(q.float(), qx.float(), qy.float())
    with pytest.raises(ValueError, match="contiguous"):
        second_eigenvalue(q.transpose(-1, -2), qx, qy)
    assert second_eigenvalue.launches == before
