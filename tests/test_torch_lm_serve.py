"""The port's LM serving engine against the reference's, on the CPU.

``Engine.generate`` (greedy) equals the reference ``Engine`` token for token
on smollm-135m reduced and on the three cache kinds of ``tests/test_serve.py``
(hymba: ring + SSM state + meta tokens; mamba2: SSM state; mixtral at
``capacity_factor=8.0``: MoE with ring caches), with the reference's
parameters carried across. Equality is asked only where it is well posed:
the reference's top-2 logit margin at every generated position exceeds
MARGIN (1e-3), ten times the whole-model tolerance of the port's logits
(1e-4). Also: greedy against repeated full forwards, EOS early stop,
temperature sampling reproducible by seed, ``perplexity`` within rtol 1e-4 of
the reference's, whisper served with encoder frames, and the engine's
errors. The card's form of these checks is ``tests/test_torch_lm_card.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro.serve.engine import perplexity as jperplexity  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.model import model_module  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig, perplexity  # noqa: E402
from test_torch_lm_models import pair  # noqa: E402

MARGIN = 1e-3


def _setup(arch):
    over = {"capacity_factor": 8.0} if get_config(arch).num_experts else {}
    return pair(arch, **over)


def _engine(cfg, model, **kw):
    return Engine(cfg, model, ServeConfig(**kw), device="cpu")


def _reference_margin(japi, params, out, t):
    """The reference's smallest top-2 logit margin over the positions that
    chose the generated tokens."""
    logits, _ = jax.jit(japi.forward)(params, {"tokens": jnp.asarray(out)})
    top2 = jax.lax.top_k(logits[:, t - 1:-1, :], 2)[0]
    return float(jnp.min(top2[..., 0] - top2[..., 1]))


@pytest.mark.parametrize("arch,b,t,new", [("smollm-135m", 2, 6, 5), ("mamba2-130m", 2, 5, 4),
                                          ("hymba-1.5b", 2, 5, 4), ("mixtral-8x7b", 2, 5, 4)])
def test_greedy_equals_reference_engine(arch, b, t, new):
    jcfg, japi, params, cfg, api, model = _setup(arch)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    want = JEngine(jcfg, params, JServeConfig(max_new_tokens=new, s_cache=24)).generate(prompts)
    margin = _reference_margin(japi, params, want, t)
    assert margin > MARGIN, f"ill-posed: the reference's top-2 margin is {margin}"
    got = _engine(cfg, model, max_new_tokens=new, s_cache=24).generate(prompts)
    assert got.dtype == want.dtype and got.shape == (b, t + new)
    np.testing.assert_array_equal(got, want)


def test_greedy_matches_full_forward():
    """The port's own form of the reference's test_greedy_matches_full_forward."""
    _, _, _, cfg, api, model = _setup("smollm-135m")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    out = _engine(cfg, model, max_new_tokens=5, s_cache=32).generate(prompts)
    toks = torch.from_numpy(prompts)
    with torch.no_grad():
        for _ in range(5):
            logits, _ = api.forward(model, {"tokens": toks})
            toks = torch.cat([toks, logits[:, -1].argmax(-1)[:, None].to(torch.int32)], 1)
    np.testing.assert_array_equal(out, toks.numpy())


def test_eos_early_stop():
    _, _, _, cfg, _, model = _setup("smollm-135m")
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 4)).astype(np.int32)
    first = int(_engine(cfg, model, max_new_tokens=1, s_cache=16).generate(prompts)[0, -1])
    out = _engine(cfg, model, max_new_tokens=6, s_cache=16, eos_id=first).generate(prompts)
    assert out.shape == (1, 10)
    assert (out[0, 4:] == first).all()  # EOS, then padding with EOS


def test_temperature_sampling_seeded():
    """Reproducible by seed (the port's own stream: not the reference's
    jax.random bits), and the seed matters."""
    _, _, _, cfg, _, model = _setup("smollm-135m")
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (4, 4)).astype(np.int32)

    def gen(seed):
        return _engine(cfg, model, max_new_tokens=8, s_cache=16, temperature=1.0,
                       seed=seed).generate(prompts)

    a, b, c = gen(7), gen(7), gen(8)
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()
    assert a.max() < cfg.vocab_size


def test_perplexity_equals_reference():
    jcfg, _, params, cfg, _, model = _setup("smollm-135m")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    got, want = perplexity(cfg, model, toks), jperplexity(jcfg, params, toks)
    assert got > 1.0 and np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_whisper_served_with_encoder_frames():
    """The reference engine feeds tokens only, so it cannot serve an
    encoder-decoder; the port's takes ``enc_embeds`` and equals repeated full
    forwards."""
    _, _, _, cfg, api, model = _setup("whisper-medium")
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab_size, (2, 4)).astype(np.int32)
    enc = rng.normal(size=(2, 10, cfg.d_model)).astype(np.float32)
    eng = _engine(cfg, model, max_new_tokens=4, s_cache=16)
    out = eng.generate(prompts, enc_embeds=enc)
    toks = torch.from_numpy(prompts)
    with torch.no_grad():
        for _ in range(4):
            logits, _ = api.forward(model, {"tokens": toks, "enc_embeds": enc})
            toks = torch.cat([toks, logits[:, -1].argmax(-1)[:, None].to(torch.int32)], 1)
    np.testing.assert_array_equal(out, toks.numpy())
    with pytest.raises(ValueError, match="enc_embeds"):
        eng.generate(prompts)


def test_engine_errors():
    _, _, _, cfg, _, model = _setup("smollm-135m")
    with pytest.raises(ValueError, match="cache"):
        _engine(cfg, model, max_new_tokens=20, s_cache=16).generate(np.zeros((1, 10), np.int32))
    eng = _engine(cfg, model, max_new_tokens=2, s_cache=16)
    with pytest.raises(ValueError, match="prompt ids"):
        eng.generate(np.full((1, 3), cfg.vocab_size, np.int32))
    with pytest.raises(ValueError, match="prompt ids"):
        eng.generate(np.full((1, 3), -1, np.int32))
    with pytest.raises(ValueError, match="live on meta"):
        Engine(cfg, model_module(cfg, device="meta"), ServeConfig(), device="cpu")


def test_launch_serve_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", "hymba-1.5b", "--device", "cpu", "--batch", "2",
                       "--max-new", "3"]) == 0
    assert "generated 6 tokens" in capsys.readouterr().out
