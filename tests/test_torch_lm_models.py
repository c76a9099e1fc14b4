"""The port's whole models against the reference's, every arch, on the CPU.

For each of the ten archs, reduced (``cfg.reduced()``): the reference's
parameters from ``api.init(jax.random.key(0))`` carried across by
``params_from_reference``, the same seeded numpy batch through both, float32.
Whole-model tolerance rtol 1e-4 / atol 1e-4 (logits of order 1; two to
four layers of einsums summed in another order): ``forward`` logits and aux,
``loss``, ``prefill``'s last logits and caches, three ``decode_step``s.
smollm also runs with the int8 KV cache (``kv_quant=True``), whose int8
values may differ by one step where a value sits on a rounding edge.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import param_count, tree_paths  # noqa: E402
from repro_torch.models.convert import load_reference_params, params_from_reference  # noqa: E402
from test_torch_lm_layers import close  # noqa: E402

TOL = 1e-4


def pair(arch, **over):
    """(reference cfg, api, params; port cfg, api, model with those params)."""
    jcfg = dataclasses.replace(jget(arch).reduced(), **over)
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    japi = jbuild(jcfg)
    params = japi.init(jax.random.key(0))
    api = build_model(cfg, device="cpu")
    model = api.init(torch.Generator().manual_seed(0))
    load_reference_params(model, jax.tree.map(np.asarray, params))
    return jcfg, japi, params, cfg, api, model


def make_batch(cfg, rng, b=2, t=16):
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)}
    if cfg.embeds_input and not cfg.is_encoder_decoder:
        batch["embeds"] = rng.normal(size=(b, t, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = rng.normal(size=(b, t, cfg.d_model)).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close_caches(got, want):
    """Caches: the port's structure is the reference's (lists of dicts of
    stacked tensors, or whisper's {"layers", "mpos"})."""
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    for path, leaf in flat_w:
        node = got
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        w = np.asarray(leaf)
        assert tuple(node.shape) == w.shape, path
        if w.dtype == np.int8:   # int8 KV: one rounding step at most
            assert np.abs(node.numpy().astype(np.int32) - w.astype(np.int32)).max() <= 1
        elif np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(node.numpy(), w)
        else:
            close(node, w, TOL, TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_prefill_decode_equal_reference(arch):
    jcfg, japi, params, cfg, api, model = pair(arch)
    assert param_count(model) == sum(int(x.size) for x in jax.tree.leaves(params))
    rng = np.random.default_rng(0)
    batch = make_batch(cfg, rng)
    b, t = batch["tokens"].shape

    with torch.no_grad():
        logits, aux = api.forward(model, batch)
        loss, metrics = api.loss(model, batch)
    jlogits, jaux = jax.jit(japi.forward)(params, _j(batch))
    assert tuple(logits.shape) == (b, t, cfg.padded_vocab)
    close(logits, jlogits, TOL, TOL)
    close(aux, jaux, TOL, TOL)
    jloss, jmetrics = jax.jit(japi.loss)(params, _j(batch))
    close(loss, jloss, TOL, TOL)
    close(metrics["nll"], jmetrics["nll"], TOL, TOL)

    last, caches = api.prefill(model, batch, s_cache=t + 4)
    jlast, jcaches = jax.jit(lambda p, bb: japi.prefill(p, bb, s_cache=t + 4))(params,
                                                                              _j(batch))
    close(last, jlast, TOL, TOL)
    _close_caches(caches, jcaches)
    step = jax.jit(japi.decode_step)
    for s in range(3):
        tok = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        pos = np.full((b,), t + s, np.int32)
        got, caches = api.decode_step(model, caches, tok, pos)
        want, jcaches = step(params, jcaches, jnp.asarray(tok), jnp.asarray(pos))
        close(got, want, TOL, TOL)
    _close_caches(caches, jcaches)


def test_kv_quant_prefill_and_decode_equal_reference():
    """int8 KV cache on smollm: int8 values and float32 scales, decode logits
    through the dequantized cache."""
    jcfg, japi, params, cfg, api, model = pair("smollm-135m", kv_quant=True)
    rng = np.random.default_rng(1)
    batch = make_batch(cfg, rng, t=12)
    last, caches = api.prefill(model, batch, s_cache=16)
    jlast, jcaches = jax.jit(lambda p, bb: japi.prefill(p, bb, s_cache=16))(params, _j(batch))
    assert caches[0]["k"].dtype == torch.int8 and caches[0]["k_scale"].dtype == torch.float32
    close(last, jlast, TOL, TOL)
    _close_caches(caches, jcaches)
    for s in range(3):
        tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        pos = np.full((2,), 12 + s, np.int32)
        got, caches = api.decode_step(model, caches, tok, pos)
        want, jcaches = jax.jit(japi.decode_step)(params, jcaches, jnp.asarray(tok),
                                                  jnp.asarray(pos))
        close(got, want, TOL, TOL)


def test_ring_cache_wraps_like_reference():
    """mixtral reduced: window 8, a 12-token prompt keeps the last 8 tokens
    at slot pos % 8, and decode keeps writing around the ring."""
    jcfg, japi, params, cfg, api, model = pair("mixtral-8x7b", capacity_factor=8.0)
    assert cfg.sliding_window == 8
    rng = np.random.default_rng(2)
    batch = make_batch(cfg, rng, t=12)
    _, caches = api.prefill(model, batch, s_cache=20)
    _, jcaches = jax.jit(lambda p, bb: japi.prefill(p, bb, s_cache=20))(params, _j(batch))
    assert tuple(caches[0]["k"].shape[2:3]) == (8,)
    _close_caches(caches, jcaches)
    for s in range(5):
        tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        pos = np.full((2,), 12 + s, np.int32)
        got, caches = api.decode_step(model, caches, tok, pos)
        want, jcaches = jax.jit(japi.decode_step)(params, jcaches, jnp.asarray(tok),
                                                  jnp.asarray(pos))
        close(got, want, TOL, TOL)
    _close_caches(caches, jcaches)


def test_init_caches_match_reference_shapes():
    for arch in ("hymba-1.5b", "whisper-medium", "mamba2-130m", "smollm-135m"):
        jcfg, cfg = jget(arch).reduced(), get_config(arch).reduced()
        want = jbuild(jcfg).init_caches(2, 24)
        got = build_model(cfg, device="cpu").init_caches(2, 24)
        for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                                jax.tree_util.tree_leaves(got)):
            assert tuple(g.shape) == tuple(w.shape), (arch, path)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_params_from_reference_raises_on_what_it_cannot_map():
    cfg = get_config("smollm-135m").reduced()
    tree = jax.tree.map(np.asarray, jbuild(jget("smollm-135m").reduced()).init(
        jax.random.key(0)))
    sd = params_from_reference(cfg, tree)
    assert "group_0.1.attn.wq" in sd and tuple(sd["group_0.1.attn.wq"].shape) == (64, 4, 16)
    assert {p for p, _ in tree_paths(build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0)))} == {k.replace(".", "/") for k in sd}
    extra = {**tree, "bogus": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match="bogus"):
        params_from_reference(cfg, extra)
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(KeyError, match="final_norm"):
        params_from_reference(cfg, missing)
    bad = jax.tree.map(lambda x: x, tree)
    bad["group_0"]["attn"]["wq"] = np.zeros((2, 64, 4, 8), np.float32)
    with pytest.raises(ValueError, match="wq"):
        params_from_reference(cfg, bad)
    deep = jax.tree.map(lambda x: x, tree)
    deep["group_0"]["attn"]["wq"] = np.zeros((3, 64, 4, 16), np.float32)  # a third layer
    with pytest.raises(KeyError, match="group_0.2"):
        params_from_reference(cfg, deep)


def test_params_from_reference_bfloat16_leaves():
    """bfloat16 parameters (llava's param_dtype) come across bit for bit."""
    jcfg = jget("llava-next-34b").reduced(param_dtype="bfloat16")
    cfg = get_config("llava-next-34b").reduced(param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.key(0)))
    sd = params_from_reference(cfg, tree)
    assert sd["embeddings.embed"].dtype == torch.bfloat16
    want = np.asarray(tree["embeddings"]["embed"]).astype(np.float32)
    np.testing.assert_array_equal(sd["embeddings.embed"].float().numpy(), want)
