"""The port's configs, parameter accounting, token data and logical sharding
against the reference, and the entry points' device contract, on the CPU.

* every config (and its reduced form) equals the reference's field for
  field (``dataclasses.asdict``); the registry, shapes and helpers too;
* ``describe`` of all ten archs counts the reference's parameters on the
  ``meta`` device (arctic-480b would take ~1.9 TB in float32);
* ``SyntheticTokens.batch_at`` is bit-identical to the reference's;
* ``constrain`` is the identity outside a ``logical_axis_rules`` context and
  raises inside one (not ported: ROADMAP item 18b);
* without a card, ``build_model``, ``Engine`` and ``batch_iterator`` raise
  unless given ``device="cpu"`` (no CPU fallback).
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.configs as jconfigs  # noqa: E402
from repro.configs.glcm_paper import CONFIG as JPAPER  # noqa: E402
from repro.data.tokens import SyntheticTokens as JTokens  # noqa: E402
from repro.models import describe as jdescribe  # noqa: E402
from repro.models.common import param_bytes as jparam_bytes  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.configs.glcm_paper import CONFIG as TPAPER  # noqa: E402
from repro_torch.data.tokens import SyntheticTokens, batch_iterator  # noqa: E402
from repro_torch.models import build_model, describe  # noqa: E402
from repro_torch.models.common import cast_tree, param_bytes, param_count  # noqa: E402
from repro_torch.models.model import model_module  # noqa: E402
from repro_torch.sharding.logical import active, constrain, logical_axis_rules  # noqa: E402


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_config_equals_reference(arch):
    want, got = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == dataclasses.asdict(want.reduced())
    for prop in ("head_dim_", "q_per_kv", "padded_vocab", "ssm_d_inner", "ssm_heads",
                 "attention_free", "sub_quadratic"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert [got.window_for_layer(i) for i in range(got.num_layers)] == \
        [want.window_for_layer(i) for i in range(want.num_layers)]
    for name, cell in jconfigs.SHAPES.items():
        assert tconfigs.applicable(got, tconfigs.SHAPES[name]) == jconfigs.applicable(want, cell)


def test_registry_shapes_and_paper_config_equal_reference():
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    for kind in ("train", "prefill", "decode"):
        assert dataclasses.asdict(tconfigs.smoke_cell(kind)) == \
            dataclasses.asdict(jconfigs.smoke_cell(kind))
    assert dataclasses.asdict(TPAPER) == dataclasses.asdict(JPAPER)
    with pytest.raises(KeyError):
        tconfigs.get_config("gpt-5")


@pytest.mark.parametrize("bad", [dict(num_heads=6, num_kv_heads=4),
                                 dict(family="moe", num_experts=0),
                                 dict(family="ssm", ssm_state=0),
                                 dict(is_encoder_decoder=True, encoder_layers=0)])
def test_validate_raises_like_reference(bad):
    base = tconfigs.get_config("smollm-135m")
    jbase = jconfigs.get_config("smollm-135m")
    with pytest.raises(ValueError):
        dataclasses.replace(jbase, **bad).validate()
    with pytest.raises(ValueError):
        dataclasses.replace(base, **bad).validate()


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_describe_counts_the_reference_parameters_on_meta(arch):
    """The reference's parameter count (its ``jax.eval_shape`` shapes, summed
    in Python integers), counted without storage. The reference's own
    ``describe`` multiplies each shape with ``jnp.prod`` in int32, which
    overflows on leaves past 2^31 elements (llava-next-34b, mixtral-8x7b,
    arctic-480b print 0.029B, -4.837B, 12.994B): equal to it elsewhere."""
    jcfg, cfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    shapes = jax.eval_shape(lambda: jbuild(jcfg).init(jax.random.key(0)))
    leaves = [math.prod(x.shape) for x in jax.tree.leaves(shapes)]
    n = sum(leaves)
    assert describe(cfg) == f"{cfg.name}: {n / 1e9:.3f}B params ({cfg.family})"
    if max(leaves) < 2 ** 31:
        assert describe(cfg) == jdescribe(jcfg)


def test_describe_builds_nothing():
    big = model_module(tconfigs.get_config("arctic-480b"), device="meta")
    assert all(p.is_meta for p in big.parameters())
    assert param_count(big) > 4.5e11


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-130m", "whisper-medium",
                                  "hymba-1.5b", "arctic-480b"])
def test_param_count_and_bytes_equal_reference(arch):
    jcfg, cfg = jconfigs.get_config(arch).reduced(), tconfigs.get_config(arch).reduced()
    params = jbuild(jcfg).init(jax.random.key(0))
    model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert param_count(model) == sum(int(x.size) for x in jax.tree.leaves(params))
    assert param_bytes(model) == jparam_bytes(params)
    cast_tree(model, torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())


def test_init_is_seeded_and_finite():
    cfg = tconfigs.get_config("hymba-1.5b").reduced()
    api = build_model(cfg, device="cpu")
    a = api.init(torch.Generator().manual_seed(3)).state_dict()
    b = api.init(torch.Generator().manual_seed(3)).state_dict()
    c = api.init(torch.Generator().manual_seed(4)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
    assert all(torch.isfinite(v).all() for v in a.values())
    wq = a["group_0.0.attn.wq"]          # std 1/sqrt(d), truncated at 2 std
    assert wq.abs().max() <= 2 / cfg.d_model ** 0.5 + 1e-6


@pytest.mark.parametrize("step", [0, 1, 17])
def test_synthetic_tokens_bit_identical_to_reference(step):
    kw = dict(vocab_size=50280, seq_len=64, global_batch=6, seed=11)
    want = JTokens(**kw).batch_at(step)["tokens"]
    got = SyntheticTokens(**kw).batch_at(step)["tokens"]
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(SyntheticTokens(**kw).batch_at(step, host_slice=slice(2, 4))
                                  ["tokens"], JTokens(**kw).batch_at(step,
                                                                     host_slice=slice(2, 4))
                                  ["tokens"])


def test_batch_iterator_prefetches_onto_the_device_in_order():
    ds = SyntheticTokens(256, 16, 2, seed=1)
    it = batch_iterator(ds, start_step=3, device="cpu", prefetch=2)
    for step in (3, 4, 5):
        got = next(it)["tokens"]
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), ds.batch_at(step)["tokens"])


def test_constrain_identity_outside_and_raises_inside_a_mesh_context():
    """The identity outside a rules context; inside one (a fake 2-rank world,
    a (2,) "data" mesh) a plain tensor is taken as replicated and placed by
    the rules, and a DTensor is redistributed."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_compat_mesh

    x = torch.arange(6.0).reshape(2, 3)
    assert constrain(x, "batch", None) is x and not active()
    dist.init_process_group("fake", store=FakeStore(), rank=1, world_size=2)
    try:
        mesh = make_compat_mesh((2,), ("data",), device_type="cpu")
        with logical_axis_rules(mesh, {"batch": "data"}):
            assert active()
            y = constrain(x, "batch", None)
            assert y.placements == (Shard(0),) and torch.equal(y.to_local(), x[1:])
            assert constrain(y, "batch", None) is y
            z = constrain(y, None, "batch")   # 3 columns do not divide: replicated
            assert z.placements == (Replicate(),) and tuple(z.shape) == (2, 3)
    finally:
        dist.destroy_process_group()
    assert not active()


def test_entry_points_need_a_card_unless_given_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card contract cannot show here")
    from repro_torch.serve.engine import Engine

    cfg = tconfigs.get_config("smollm-135m").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(batch_iterator(SyntheticTokens(256, 16, 2)))
