"""Core transformer layers: norms, embeddings, positions, MLP.

The port's counterpart of ``repro.models.layers``. Modules own the
parameters (the reference's dict keys as attribute names, the reference's
layouts); the apply functions are plain functions on tensors, shape-
polymorphic over leading batch/seq dims, computing in the input's dtype
with float32 normalization statistics. Every cast mirrors the reference's:
under bfloat16 the rounding points are part of what parity checks.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.models.common import (
    dense_init_,
    dtype_of,
    embed_init_,
    weight_einsum,
    weight_local,
)

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


class Norm(nn.Module):
    """rmsnorm: ``scale``; layernorm: ``scale``, ``bias``; layernorm_nonparam
    (OLMo): no parameters."""

    def __init__(self, cfg, dim: int | None = None, *, device=None):
        super().__init__()
        dim = dim or cfg.d_model
        if cfg.norm not in ("rmsnorm", "layernorm", "layernorm_nonparam"):
            raise ValueError(cfg.norm)
        if cfg.norm in ("rmsnorm", "layernorm"):
            self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))
        if cfg.norm == "layernorm":
            self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32, device=device))


def apply_norm(cfg, p: Norm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    # Cast point: statistics in float32, the result cast back to x's dtype.
    dt = x.dtype
    xf = x.float()
    if cfg.norm == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p.scale
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)  # jnp.var: population
        y = (xf - mu) * torch.rsqrt(var + eps)
        if cfg.norm == "layernorm":
            y = y * p.scale + p.bias
    return y.to(dt)


# ---------------------------------------------------------------------------
# Embeddings / unembedding (padded vocab)
# ---------------------------------------------------------------------------


class Embeddings(nn.Module):
    def __init__(self, cfg, *, device=None):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        self.embed = nn.Parameter(torch.empty(cfg.padded_vocab, cfg.d_model, dtype=dt,
                                              device=device))
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(torch.empty(cfg.d_model, cfg.padded_vocab, dtype=dt,
                                                    device=device))

    def _init(self, gen):
        embed_init_(self.embed, gen)
        if hasattr(self, "unembed"):
            dense_init_(self.unembed, gen, 0)


def embed_tokens(cfg, p: Embeddings, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    # Ids are always < vocab_size <= padded_vocab. Unlike the reference's
    # jnp.take, which clamps an out-of-range id silently, this indexing
    # raises on the CPU (and faults on the card): callers keep the contract
    # (``Engine.generate`` checks its prompts on the host).
    # On a mesh each rank looks its own tokens up in the whole table:
    # DTensor's lookup over a vocab-sharded table (a masked partial sum)
    # sizes its mask wrongly when the table is also sharded over the
    # tokens' batch axis, and torch 2.11 reuses one mask across calls.
    if isinstance(tokens, DTensor):
        return weight_local(lambda t, w: F.embedding(t.long(), w), tokens, p.embed,
                            tokens.placements).to(compute_dtype)
    return F.embedding(tokens.long(), p.embed).to(compute_dtype)


def unembed(cfg, p: Embeddings, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = weight_einsum("...d,vd->...v", x, p.embed.to(x.dtype))
    else:
        logits = weight_einsum("...d,dv->...v", x, p.unembed.to(x.dtype))
    # Mask padded vocab rows so they can never win / leak probability mass.
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(logits.shape[-1], device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e9)
    return logits


# ---------------------------------------------------------------------------
# Positions: RoPE (rotate-half) and sinusoidal absolute
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., T, H, D); positions: broadcastable to (..., T). Rotates in
    float32 and casts back (the reference's cast points)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)                 # (D/2,)
    angles = positions[..., None].float() * freqs                # (..., T, D/2)
    cos = torch.cos(angles)[..., None, :]                        # (..., T, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """Absolute sinusoidal embeddings (whisper-style stub positions), float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=positions.device)
                      / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# MLP: SwiGLU (llama-family) or GELU (whisper)
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    def __init__(self, cfg, d_ff: int | None = None, *, device=None):
        super().__init__()
        d_ff = d_ff or cfg.d_ff
        dt = dtype_of(cfg.param_dtype)
        d = cfg.d_model
        names = (("w_gate", (d, d_ff)), ("w_up", (d, d_ff)), ("w_down", (d_ff, d))) \
            if cfg.activation == "swiglu" else (("w_in", (d, d_ff)), ("w_out", (d_ff, d)))
        for name, shape in names:
            setattr(self, name, nn.Parameter(torch.empty(shape, dtype=dt, device=device)))

    def _init(self, gen):
        for p in self.parameters(recurse=False):
            dense_init_(p, gen, 0)


def apply_mlp(cfg, p: MLP, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    if cfg.activation == "swiglu":
        gate = weight_einsum("...d,df->...f", x, p.w_gate.to(dt))
        up = weight_einsum("...d,df->...f", x, p.w_up.to(dt))
        return weight_einsum("...f,fd->...d", F.silu(gate) * up, p.w_down.to(dt))
    # GELU: jax.nn.gelu defaults to the tanh approximation; F.gelu defaults
    # to erf, so the approximation is named here (whisper is the only user).
    h = F.gelu(weight_einsum("...d,df->...f", x, p.w_in.to(dt)), approximate="tanh")
    return weight_einsum("...f,fd->...d", h, p.w_out.to(dt))
