"""Remat on the CPU: ``cfg.remat`` and the checkpointed chunk body of
``sdpa_chunked`` recompute activations in the backward pass and change no
result. Both equalities are exact (``torch.equal``): recomputation repeats
the same float32 ops on the same inputs.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention, build_model, transformer  # noqa: E402


def _setup(arch):
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)}
    if cfg.embeds_input and not cfg.is_encoder_decoder:
        batch["embeds"] = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    return cfg, model, batch


def _loss_and_grads(cfg, model, batch):
    model.zero_grad(set_to_none=True)
    loss, _ = build_model(cfg, device="cpu").loss(model, batch, chunk=8)
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()
                           if p.grad is not None}


def _assert_same(a, b):
    assert torch.equal(a[0], b[0])
    assert a[1].keys() == b[1].keys()
    for n, g in a[1].items():
        assert torch.equal(g, b[1][n]), n


@pytest.mark.parametrize("arch", ["smollm-135m", "hymba-1.5b", "whisper-medium"])
def test_remat_leaves_grads_unchanged(arch):
    """Loss and every gradient with ``remat=True`` equal those with
    ``remat=False``, bit for bit (T = 24 > chunk 8: the chunk body is
    checkpointed in both)."""
    cfg, model, batch = _setup(arch)
    _assert_same(_loss_and_grads(dataclasses.replace(cfg, remat=False), model, batch),
                 _loss_and_grads(dataclasses.replace(cfg, remat=True), model, batch))


def test_remat_recomputes_each_layer(monkeypatch):
    """With remat the backward pass runs each layer's body again; without
    it, once. Prefill (no grad) runs it once either way."""
    cfg, model, batch = _setup("smollm-135m")
    calls = []
    body = transformer.apply_layer

    def counting(*a, **k):
        calls.append(1)
        return body(*a, **k)

    monkeypatch.setattr(transformer, "apply_layer", counting)
    for remat, want in ((False, cfg.num_layers), (True, 2 * cfg.num_layers)):
        calls.clear()
        _loss_and_grads(dataclasses.replace(cfg, remat=remat), model, batch)
        assert len(calls) == want, (remat, len(calls))
    calls.clear()
    api = build_model(dataclasses.replace(cfg, remat=True), device="cpu")
    with torch.no_grad():
        api.forward(model, batch, chunk=8)
    assert len(calls) == cfg.num_layers


def test_checkpointed_chunk_body_equals_plain(monkeypatch):
    """``sdpa_chunked`` with T = 40 > chunk 8 (a padded last chunk, GQA,
    a sliding window): the output and the gradients of q, k and v with the
    chunk body under ``torch.utils.checkpoint`` equal those of the plain
    body, bit for bit, and the checkpointed body runs twice per chunk."""
    gen = torch.Generator().manual_seed(1)
    b, t, h, kv, d = 2, 40, 4, 2, 16
    q0, k0, v0 = (torch.randn((b, t, n, d), generator=gen) for n in (h, kv, kv))
    pos = torch.arange(t, dtype=torch.int32).expand(b, t)

    def run():
        q, k, v = (x.clone().requires_grad_(True) for x in (q0, k0, v0))
        y = attention.sdpa_chunked(q, k, v, pos, pos, causal=True, window=12, chunk=8)
        (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum().backward()
        return y.detach(), q.grad, k.grad, v.grad

    calls = []
    chunk_body = attention._chunk_body

    def counting(*a, **k):
        calls.append(1)
        return chunk_body(*a, **k)

    monkeypatch.setattr(attention, "_chunk_body", counting)
    checkpointed = run()
    assert len(calls) == 2 * 5   # 5 chunks, each recomputed in the backward
    monkeypatch.setattr(attention, "remat_call",
                        lambda enabled, fn, *a, **k: fn(*a, **k))
    calls.clear()
    plain = run()
    assert len(calls) == 5
    for x, y in zip(checkpointed, plain):
        assert torch.equal(x, y)
