"""Gradient compression for a slow cross-node axis: int8 quantization with
error feedback (1-bit-Adam-style residual correction).

The port's counterpart of ``repro.train.compression``, the same pure
functions over trees (nested dicts / lists of tensors): ``compress`` gives
per-leaf int8 values and a float32 scale, ``max|g| / 127``, the values
``round(g / scale)`` (half to even, as ``jnp.round``) clipped to ±127 —
bit-equal to the reference's on the CPU. Error feedback keeps the
quantization noise unbiased over steps: the residual ``g - Q(g)`` is added
to the next step's gradient before quantizing, so the applied updates
telescope to the true gradient sum.

    res = init_state(grads)
    q, scales, res = compress_grads(grads, res)   # quantize + residual
    # ... all-reduce q over the slow axis, then decompress ...
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils import _pytree as pytree

__all__ = ["init_state", "compress", "decompress", "compress_grads"]


def init_state(params: Any) -> Any:
    """Per-leaf float32 error-feedback residuals (zeros)."""
    return pytree.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params)


def _quant_leaf(g: torch.Tensor):
    # Divisors are tensors: a python divisor multiplies by its reciprocal
    # on the card.
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / torch.tensor(
        127.0, dtype=torch.float32, device=g.device)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def compress(tree: Any):
    """Tree of float tensors → (int8 tree, float32 scale tree)."""
    leaves, spec = pytree.tree_flatten(tree)
    qs, scales = zip(*(_quant_leaf(x.to(torch.float32)) for x in leaves))
    return pytree.tree_unflatten(list(qs), spec), pytree.tree_unflatten(list(scales), spec)


def decompress(q_tree: Any, scale_tree: Any, dtype=torch.float32) -> Any:
    return pytree.tree_map(lambda q, s: (q.to(torch.float32) * s).to(dtype),
                           q_tree, scale_tree)


def compress_grads(grads: Any, residual: Any):
    """Error-feedback compression step → (int8 grads, scales, new residual),
    where ``decompress(int8, scales) + new_residual == grads + residual`` up
    to float32 rounding (the telescoping invariant)."""
    corrected = pytree.tree_map(lambda g, r: g.to(torch.float32) + r, grads, residual)
    q, scales = compress(corrected)
    recon = decompress(q, scales)
    new_residual = pytree.tree_map(lambda c, d: c - d, corrected, recon)
    return q, scales, new_residual
