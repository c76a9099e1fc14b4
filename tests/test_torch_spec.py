"""repro_torch.core.spec / kernels.ref against the JAX reference: the same
offsets, region grids, strides and ValueErrors over a sweep of specs, and a
spec carried across as a dict of plain values."""

import dataclasses

import pytest

pytest.importorskip("torch")

from repro.core.spec import GLCMSpec as JaxSpec
from repro.kernels import ref as jref
from repro_torch.core.spec import GLCMSpec
from repro_torch.kernels import ref as tref

PAPER = ((1, 0), (1, 45), (4, 0), (4, 45))

VALID = [
    dict(levels=8),
    dict(levels=32, pairs=PAPER),
    dict(levels=256, pairs=[[2, 90], [3, 135]], scheme="cuda_fused"),
    dict(levels=16, pairs=PAPER, quantize="uniform", vrange=(0, 255)),
    dict(levels=16, quantize="uniform", vrange=(None, 10)),
    dict(levels=8, quantize="equalized", symmetric=True, normalize=True),
    dict(levels=8, copies=4, chunk=4096, tile_h=16, slab_d=8, batch_mode="unroll"),
    dict(levels=8, accum="int", num_blocks=2),
    dict(levels=8, pairs=PAPER, region="tiles", region_shape=16),
    dict(levels=8, pairs=((1, 0),), region="window", region_shape=(8, 6), region_stride=3),
    dict(levels=8, pairs=((1, 4), (2, 12)), ndim=3),
    dict(levels=8, pairs=((1, 0), (1, 8)), ndim=3, region="tiles", region_shape=(4, 8, 8)),
]

INVALID = [
    dict(levels=1),
    dict(levels=257),
    dict(levels=8, pairs=()),
    dict(levels=8, pairs=((0, 0),)),
    dict(levels=8, pairs=((1, 30),)),
    dict(levels=8, ndim=4),
    dict(levels=8, pairs=((1, 13),), ndim=3),
    dict(levels=8, quantize="log"),
    dict(levels=8, scheme=""),
    dict(levels=8, copies=0),
    dict(levels=8, num_blocks=0),
    dict(levels=8, accum="bf16"),
    dict(levels=8, batch_mode="vmap"),
    dict(levels=8, tile_h=0),
    dict(levels=8, copies=3, chunk=1024),
    dict(levels=8, region="rings"),
    dict(levels=8, region_shape=8),
    dict(levels=8, region="tiles"),
    dict(levels=8, region="tiles", region_shape=8, region_stride=2),
    dict(levels=8, pairs=((4, 0),), region="tiles", region_shape=4),
    dict(levels=8, region="window", region_shape=(8, 8, 8)),
    dict(levels=8, region="window", region_shape=(0, 8)),
]

DIMS = [(64, 64), (48, 33), (8, 6), (10, 32, 32), (3, 3)]


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("kw", VALID, ids=lambda kw: repr(kw)[:60])
def test_valid_specs_match(kw):
    js, ts = JaxSpec(**kw), GLCMSpec(**kw)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert ts.offsets() == js.offsets()
    assert ts.strides == js.strides
    assert ts.n_pairs == js.n_pairs
    for dims in DIMS:
        assert _outcome(lambda: ts.region_grid(*dims)) == _outcome(lambda: js.region_grid(*dims))
    assert _outcome(ts.single_pair) == _outcome(js.single_pair)


@pytest.mark.parametrize("kw", INVALID, ids=lambda kw: repr(kw)[:60])
def test_invalid_specs_raise_the_same(kw):
    want = _outcome(lambda: JaxSpec(**kw))
    assert want[0] == "ValueError"
    assert _outcome(lambda: GLCMSpec(**kw)) == want


@pytest.mark.parametrize("kw", VALID, ids=lambda kw: repr(kw)[:60])
def test_from_dict_of_reference_spec(kw):
    js = JaxSpec(**kw)
    ts = GLCMSpec.from_dict(dataclasses.asdict(js))
    assert ts == GLCMSpec(**kw)
    for f in dataclasses.fields(GLCMSpec):
        assert getattr(ts, f.name) == getattr(js, f.name), f.name
    assert hash(ts) == hash(GLCMSpec(**kw))


def test_from_dict_rejects_unknown_fields():
    with pytest.raises(ValueError, match="unknown GLCMSpec fields"):
        GLCMSpec.from_dict({"levels": 8, "colour": "red"})
    assert GLCMSpec.from_dict({"levels": 8}) == GLCMSpec(levels=8)


def test_replace_revalidates():
    ts = GLCMSpec(levels=8, pairs=PAPER)
    assert ts.replace(scheme="cuda").scheme == "cuda"
    with pytest.raises(ValueError):
        ts.replace(levels=1)


def test_offset_tables_match():
    assert tref.OFFSETS == jref.OFFSETS
    assert tref.DIRECTIONS_3D == jref.DIRECTIONS_3D
    for d in (1, 2, 5):
        for t in (0, 45, 90, 135):
            assert tref.glcm_offsets(d, t) == jref.glcm_offsets(d, t)
        for k in range(13):
            assert tref.glcm_offsets_3d(d, k) == jref.glcm_offsets_3d(d, k)
    for bad in ((0, 0), (1, 10)):
        assert _outcome(lambda: tref.glcm_offsets(*bad)) == _outcome(
            lambda: jref.glcm_offsets(*bad))
    assert _outcome(lambda: tref.glcm_offsets_3d(1, 13)) == _outcome(
        lambda: jref.glcm_offsets_3d(1, 13))
