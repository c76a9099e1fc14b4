"""Shared model utilities: initializers, dtype policy, parameter tooling.

The port's counterpart of ``repro.models.common``. Parameters live in
``nn.Module``s whose attribute names are the reference's dict keys, each
tensor in the reference's own layout (``wq`` is ``(d, h, dh)``), so a
reference path ``group_0/attn/wq`` is the port's ``group_0.<layer>.attn.wq``
(``models/convert.py``). Randomness comes from one explicit
``torch.Generator`` consumed in module-registration order (the counterpart
of the reference's ``split_keys``): initial values differ from JAX's random
bits, so parity goes through the converter, never through ``init``.
"""

from __future__ import annotations

import math

import torch
import torch.utils.checkpoint
from torch import nn

__all__ = ["cast_tree", "dense_init_", "dtype_of", "embed_init_", "init_module",
           "param_bytes", "param_count", "remat_call", "tree_paths"]


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def _truncated_normal(t: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], drawn in float32 on ``t``'s device."""
    out = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    return nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=gen)


@torch.no_grad()
def dense_init_(t: torch.Tensor, gen: torch.Generator, in_axis: int = 0) -> torch.Tensor:
    """Truncated-normal fan-in initialization (std = 1/sqrt(fan_in)), in place."""
    std = 1.0 / math.sqrt(t.shape[in_axis])
    return t.copy_(_truncated_normal(t, gen).mul_(std))


@torch.no_grad()
def embed_init_(t: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    return t.copy_(_truncated_normal(t, gen).mul_(0.02))


def init_module(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Fill every random parameter of ``module``: each submodule's
    ``_init(gen)``, in registration order. Deterministic parameters (norm
    scales, biases, SSM decay rates) are set where the module is built."""
    for m in module.modules():
        fn = getattr(m, "_init", None)
        if fn is not None:
            fn(gen)
    return module


def remat_call(enabled: bool, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, recomputed in the backward pass instead of
    keeping its activations when ``enabled`` and autograd is recording: the
    port's counterpart of the reference's ``jax.checkpoint``. Prefill and
    decode (no grad) call ``fn`` as it is."""
    if enabled and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return fn(*args, **kwargs)


def param_count(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


def param_bytes(params: nn.Module) -> int:
    return sum(p.numel() * p.element_size() for p in params.parameters())


def tree_paths(params: nn.Module) -> list[tuple[str, torch.Tensor]]:
    """Flatten to ("a/b/c", tensor) pairs, the reference's path form (a
    per-layer module keeps its index: ``group_0/3/attn/wq``)."""
    return [(k.replace(".", "/"), v) for k, v in params.state_dict().items()]


@torch.no_grad()
def cast_tree(params: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every floating parameter to ``dtype`` in place."""
    for p in params.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    return params
