"""The ``lm`` phase's float32 card-vs-CPU check at reduced size (``cuda``
tests: they skip where there is no card, and need no JAX, so they run on
the card's machine).

Float32 compute and the same weights on both sides; TF32 is off by default
(``torch.backends.cuda.matmul.allow_tf32``), so the card and the CPU differ
only in summation order: logits and caches within CARD_ATOL = 1e-4 (logits of
order 1, two layers), and the greedy engine's tokens equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.model import model_module  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402

CARD_ATOL = 1e-4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the lm phase's card-vs-CPU check")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-135m", "hymba-1.5b"])
def test_card_prefill_and_decode_equal_cpu(arch):
    """Float32, the same weights: prefill logits and caches and three
    teacher-forced decode steps on the card within CARD_ATOL of the CPU."""
    _card()
    cfg = get_config(arch).reduced()
    cpu = build_model(cfg, device="cpu")
    card = build_model(cfg, device="cuda")
    m_cpu = cpu.init(torch.Generator().manual_seed(0))
    m_card = model_module(cfg, device=card.device)
    m_card.load_state_dict(m_cpu.state_dict())
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    want, wc = cpu.prefill(m_cpu, {"tokens": toks}, s_cache=44)
    got, gc = card.prefill(m_card, {"tokens": toks}, s_cache=44)
    assert (got.cpu() - want).abs().max() <= CARD_ATOL
    for s in range(3):
        nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        pos = np.full((2,), 40 + s, np.int32)
        want, wc = cpu.decode_step(m_cpu, wc, nxt, pos)
        got, gc = card.decode_step(m_card, gc, nxt, pos)
        assert (got.cpu() - want).abs().max() <= CARD_ATOL
    for w, g in zip(wc, gc):
        for k in w:
            assert (g[k].cpu().float() - w[k].float()).abs().max() <= CARD_ATOL, k


@pytest.mark.cuda
def test_card_engine_equals_cpu_engine():
    _card()
    cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(), moe_dispatch="gather")
    m_cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    m_card = model_module(cfg, device="cuda")
    m_card.load_state_dict(m_cpu.state_dict())
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    want = Engine(cfg, m_cpu, ServeConfig(max_new_tokens=6, s_cache=20),
                  device="cpu").generate(prompts)
    got = Engine(cfg, m_card, ServeConfig(max_new_tokens=6, s_cache=20)).generate(prompts)
    np.testing.assert_array_equal(got, want)
