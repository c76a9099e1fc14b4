"""Unified model API: ``build_model(cfg)`` → a ModelApi with the reference's
names (``repro.models.model``), on the card unless the caller asks for the
CPU:

    api = build_model(get_config("mixtral-8x7b").reduced(), device="cpu")
    model = api.init(torch.Generator().manual_seed(0))     # an nn.Module
    loss, metrics = api.loss(model, batch)                  # train
    logits, caches = api.prefill(model, batch)              # serving
    logits, caches = api.decode_step(model, caches, tok, pos)

``batch`` contents by family (torch tensors, or numpy arrays, which are
moved to the api's device):
  tokens-only archs:  {"tokens": (B, T) int}
  stub-frontend archs (llava/whisper): {"embeds"/"enc_embeds": (B,T,D),
                                        "tokens": (B,T)}

``prefill`` and ``decode_step`` run without autograd; ``decode_step``
updates ``caches`` in place. ``forward`` and ``loss`` keep autograd:
``launch.steps.make_train_step`` differentiates ``loss`` (with
``cfg.remat``, each layer is recomputed in the backward pass).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.models import encdec, transformer
from repro_torch.core.plan import resolve_device
from repro_torch.models.common import dtype_of


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: Any
    device: torch.device
    init: Callable[..., torch.nn.Module]
    loss: Callable[..., tuple[torch.Tensor, dict]]
    forward: Callable[..., tuple[torch.Tensor, torch.Tensor]]
    prefill: Callable[..., tuple[torch.Tensor, Any]]
    decode_step: Callable[..., tuple[torch.Tensor, Any]]
    init_caches: Callable[..., Any]


def model_module(cfg, *, device=None) -> torch.nn.Module:
    """The uninitialized parameter module of ``cfg`` (``device="meta"``
    builds shapes only)."""
    cls = encdec.EncDecLM if cfg.is_encoder_decoder else transformer.TransformerLM
    return cls(cfg, device=device)


def _on(dev: torch.device, x):
    return x.to(dev) if torch.is_tensor(x) else torch.as_tensor(np.asarray(x), device=dev)


def build_model(cfg, *, device=None) -> ModelApi:
    """``device=None`` means the current CUDA device and raises without a
    card; ``device="cpu"`` runs on the CPU."""
    cfg.validate()
    dev = resolve_device(device)
    if cfg.is_encoder_decoder:
        init_fn, loss_fn, fwd_fn = (encdec.init_encdec_params, encdec.encdec_loss,
                                    encdec.encdec_forward)
        prefill_fn, step_fn = encdec.encdec_prefill, encdec.encdec_decode_step

        def init_caches(batch, s_cache, t_enc=None):
            return encdec.init_encdec_caches(cfg, batch, s_cache, t_enc or s_cache,
                                             dtype_of(cfg.compute_dtype), dev)
    else:
        init_fn, loss_fn, fwd_fn = (transformer.init_lm_params, transformer.lm_loss,
                                    transformer.lm_forward)
        prefill_fn, step_fn = transformer.lm_prefill, transformer.lm_decode_step

        def init_caches(batch, s_cache, t_enc=None):
            # Meta tokens (hymba) live in the cache prefix.
            return transformer.init_decode_caches(cfg, batch, s_cache + cfg.meta_tokens,
                                                  dtype_of(cfg.compute_dtype), dev)

    def batch_on(b: dict) -> dict:
        return {k: _on(dev, v) for k, v in b.items()}

    def init(gen: torch.Generator) -> torch.nn.Module:
        return init_fn(cfg, gen, dev)

    @torch.no_grad()
    def prefill(p, b, **kw):
        return prefill_fn(cfg, p, batch_on(b), **kw)

    @torch.no_grad()
    def decode_step(p, c, t, pos):
        return step_fn(cfg, p, c, _on(dev, t), _on(dev, pos))

    return ModelApi(
        cfg=cfg,
        device=dev,
        init=init,
        loss=lambda p, b, **kw: loss_fn(cfg, p, batch_on(b), **kw),
        forward=lambda p, b, **kw: fwd_fn(cfg, p, batch_on(b), **kw),
        prefill=prefill,
        decode_step=decode_step,
        init_caches=init_caches,
    )


def describe(cfg) -> str:
    """Parameter count of ``cfg``, built on the ``meta`` device: no storage,
    so arctic-480b (~1.9 TB in float32) costs nothing."""
    cfg.validate()
    n = sum(p.numel() for p in model_module(cfg, device="meta").parameters())
    return f"{cfg.name}: {n/1e9:.3f}B params ({cfg.family})"
