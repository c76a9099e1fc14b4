"""Encoder-decoder backbone (whisper-medium); the port's counterpart of
``repro.models.encdec``. The audio frontend (mel + conv) is a STUB: the
encoder consumes precomputed frame embeddings (B, T_enc, d_model).

Encoder: non-causal self-attention + GELU MLP, sinusoidal positions.
Decoder: causal self-attention + cross-attention + GELU MLP.
Decode caches: per-layer self KV (grows) + cross KV (static, built once),
stacked over the decoder's layers as in the reference; ``encdec_decode_step``
updates the self KV in place.

``cfg.remat`` wraps each encoder and decoder layer's body in
``torch.utils.checkpoint`` when autograd records, as the reference wraps
its scan bodies in ``jax.checkpoint``; prefill and decode are unchanged.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.attention import (
    Attention,
    cross_attention,
    output_proj,
    project_kv,
    project_q,
    sdpa_chunked,
    sdpa_direct,
)
from repro_torch.models.common import dtype_of, init_module, remat_call
from repro_torch.models.layers import (
    MLP,
    Embeddings,
    Norm,
    apply_mlp,
    apply_norm,
    embed_tokens,
    sinusoidal_positions,
    unembed,
)
from repro_torch.models.transformer import kv_cache, shard_friendly_xent, write_slot
from repro_torch.sharding.logical import constrain


class EncoderLayer(nn.Module):
    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.ln1 = Norm(cfg, device=device)
        self.attn = Attention(cfg, device=device)
        self.ln2 = Norm(cfg, device=device)
        self.mlp = MLP(cfg, device=device)


class DecoderLayer(nn.Module):
    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.ln1 = Norm(cfg, device=device)
        self.self_attn = Attention(cfg, device=device)
        self.ln2 = Norm(cfg, device=device)
        self.cross_attn = Attention(cfg, device=device)
        self.ln3 = Norm(cfg, device=device)
        self.mlp = MLP(cfg, device=device)


class EncDecLM(nn.Module):
    """embeddings, encoder / decoder (ModuleLists), enc_final, dec_final."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Embeddings(cfg, device=device)
        self.encoder = nn.ModuleList(EncoderLayer(cfg, device=device)
                                     for _ in range(cfg.encoder_layers))
        self.decoder = nn.ModuleList(DecoderLayer(cfg, device=device)
                                     for _ in range(cfg.num_layers))
        self.enc_final = Norm(cfg, device=device)
        self.dec_final = Norm(cfg, device=device)


def init_encdec_params(cfg, gen: torch.Generator, device=None) -> EncDecLM:
    return init_module(EncDecLM(cfg, device=device), gen)


def _positions(b: int, t: int, device) -> torch.Tensor:
    return torch.arange(t, dtype=torch.int32, device=device).expand(b, t)


def _encoder_layer(cfg, pi: EncoderLayer, x, pos, chunk: int):
    h = apply_norm(cfg, pi.ln1, x)
    q = project_q(cfg, pi.attn, h, None)
    k, v = project_kv(cfg, pi.attn, h, None)
    att = sdpa_chunked(q, k, v, pos, pos, causal=False, chunk=chunk)
    x = x + output_proj(pi.attn, att)
    x = x + apply_mlp(cfg, pi.mlp, apply_norm(cfg, pi.ln2, x))
    return constrain(x, "batch", "seq", None)


def encode(cfg, params: EncDecLM, enc_embeds: torch.Tensor, *, chunk: int = 1024):
    """Frame embeddings (B, T_enc, D) → encoder memory (B, T_enc, D)."""
    cdt = dtype_of(cfg.compute_dtype)
    b, t, _ = enc_embeds.shape
    pos = _positions(b, t, enc_embeds.device)
    x = enc_embeds.to(cdt) + sinusoidal_positions(pos, cfg.d_model).to(cdt)
    for pi in params.encoder:
        x = remat_call(cfg.remat, _encoder_layer, cfg, pi, x, pos, chunk)
    return apply_norm(cfg, params.enc_final, x)


def _embed_decoder(cfg, params, tok, cdt):
    b, td = tok.shape
    dpos = _positions(b, td, tok.device)
    x = embed_tokens(cfg, params.embeddings, tok, cdt)
    return x + sinusoidal_positions(dpos, cfg.d_model).to(cdt), dpos


def _decoder_layer(cfg, pi: DecoderLayer, x, dpos, memory, mpos, chunk: int):
    h = apply_norm(cfg, pi.ln1, x)
    q = project_q(cfg, pi.self_attn, h, None)
    k, v = project_kv(cfg, pi.self_attn, h, None)
    att = sdpa_chunked(q, k, v, dpos, dpos, causal=True, chunk=chunk)
    x = x + output_proj(pi.self_attn, att)
    h2 = apply_norm(cfg, pi.ln2, x)
    x = x + cross_attention(cfg, pi.cross_attn, h2, memory, dpos, mpos, chunk=chunk)
    x = x + apply_mlp(cfg, pi.mlp, apply_norm(cfg, pi.ln3, x))
    return constrain(x, "batch", "seq", None)


def encdec_forward(cfg, params: EncDecLM, batch: dict, *, chunk: int = 1024):
    """batch: enc_embeds (B,T_enc,D) + tokens (B,T_dec) → (logits, aux=0)."""
    cdt = dtype_of(cfg.compute_dtype)
    memory = encode(cfg, params, batch["enc_embeds"], chunk=chunk)
    memory = constrain(memory, "batch", None, None)
    mpos = _positions(memory.shape[0], memory.shape[1], memory.device)
    x, dpos = _embed_decoder(cfg, params, batch["tokens"], cdt)
    for pi in params.decoder:
        x = remat_call(cfg.remat, _decoder_layer, cfg, pi, x, dpos, memory, mpos, chunk)
    x = apply_norm(cfg, params.dec_final, x)
    return unembed(cfg, params.embeddings, x), torch.zeros((), dtype=torch.float32,
                                                           device=x.device)


def encdec_loss(cfg, params: EncDecLM, batch: dict, *, chunk: int = 1024):
    logits, aux = encdec_forward(cfg, params, batch, chunk=chunk)
    targets = batch["tokens"][:, 1:]
    nll = shard_friendly_xent(logits[:, :-1, :].float(), targets)
    return nll + aux, {"nll": nll, "aux": aux}


def encdec_prefill(cfg, params: EncDecLM, batch: dict, *, s_cache: int | None = None,
                   chunk: int = 1024):
    """Encode + decoder prefill. Caches: self KV (padded to s_cache) and the
    static cross KV of the encoder memory per layer."""
    cdt = dtype_of(cfg.compute_dtype)
    memory = encode(cfg, params, batch["enc_embeds"], chunk=chunk)
    memory = constrain(memory, "batch", None, None)
    b, tm = memory.shape[0], memory.shape[1]
    mpos = _positions(b, tm, memory.device)
    x, dpos = _embed_decoder(cfg, params, batch["tokens"], cdt)
    td = dpos.shape[1]
    sc = s_cache or td
    per_layer = []
    for pi in params.decoder:
        h = apply_norm(cfg, pi.ln1, x)
        q = project_q(cfg, pi.self_attn, h, None)
        k, v = project_kv(cfg, pi.self_attn, h, None)
        att = sdpa_chunked(q, k, v, dpos, dpos, causal=True, chunk=chunk)
        x = x + output_proj(pi.self_attn, att)
        cache = kv_cache(k, v, dpos, sc)
        h2 = apply_norm(cfg, pi.ln2, x)
        ck, cv = project_kv(cfg, pi.cross_attn, memory, None)
        qx = project_q(cfg, pi.cross_attn, h2, None)
        xatt = sdpa_chunked(qx, ck, cv, dpos, mpos, causal=False, chunk=chunk)
        x = x + output_proj(pi.cross_attn, xatt)
        x = x + apply_mlp(cfg, pi.mlp, apply_norm(cfg, pi.ln3, x))
        x = constrain(x, "batch", "seq", None)
        per_layer.append({**cache, "ck": ck, "cv": cv})
    x = apply_norm(cfg, params.dec_final, x)
    logits = unembed(cfg, params.embeddings, x[:, -1:, :])[:, 0, :]
    layers = {k: torch.stack([c[k] for c in per_layer]) for k in per_layer[0]}
    return logits, {"layers": layers, "mpos": mpos}


def encdec_decode_step(cfg, params: EncDecLM, caches: dict, token: torch.Tensor,
                       pos: torch.Tensor):
    """One decoder step against self + cross caches (self KV updated in place)."""
    cdt = dtype_of(cfg.compute_dtype)
    pos = pos.to(torch.int32)
    x = embed_tokens(cfg, params.embeddings, token, cdt)
    x = x + sinusoidal_positions(pos[:, None], cfg.d_model).to(cdt)
    mpos = caches["mpos"]
    for j, pi in enumerate(params.decoder):
        ci = {k: v[j] for k, v in caches["layers"].items()}
        h = apply_norm(cfg, pi.ln1, x)
        q = project_q(cfg, pi.self_attn, h, None)
        k1, v1 = project_kv(cfg, pi.self_attn, h, None)
        slot = torch.clamp(pos, max=ci["k"].shape[1] - 1).long()
        write_slot(ci["k"], slot, k1[:, 0])
        write_slot(ci["v"], slot, v1[:, 0])
        write_slot(ci["pos"], slot, pos)
        att = sdpa_direct(q, ci["k"], ci["v"], pos[:, None], ci["pos"], causal=True)
        x = x + output_proj(pi.self_attn, att)
        h2 = apply_norm(cfg, pi.ln2, x)
        qx = project_q(cfg, pi.cross_attn, h2, None)
        xatt = sdpa_direct(qx, ci["ck"], ci["cv"], pos[:, None], mpos, causal=False)
        x = x + output_proj(pi.cross_attn, xatt)
        x = x + apply_mlp(cfg, pi.mlp, apply_norm(cfg, pi.ln3, x))
    x = apply_norm(cfg, params.dec_final, x)
    logits = unembed(cfg, params.embeddings, x)[:, 0, :]
    return logits, caches


def init_encdec_caches(cfg, batch: int, s_cache: int, t_enc: int, dtype, device=None) -> dict:
    kvh, dh = cfg.num_kv_heads, cfg.head_dim_
    L = cfg.num_layers

    def zeros(t):
        return torch.zeros((L, batch, t, kvh, dh), dtype=dtype, device=device)

    return {
        "layers": {
            "k": zeros(s_cache), "v": zeros(s_cache),
            "pos": torch.full((L, batch, s_cache), -1, dtype=torch.int32, device=device),
            "ck": zeros(t_enc), "cv": zeros(t_enc),
        },
        "mpos": torch.zeros((batch, t_enc), dtype=torch.int32, device=device),
    }
