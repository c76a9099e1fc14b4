"""Attention: GQA projections + two SDPA paths.

The port's counterpart of ``repro.models.attention``, computed with plain
tensor ops that follow the reference's algorithm op for op (not
``F.scaled_dot_product_attention``, whose numerics and memory profile
differ):

``sdpa_chunked``  — online-softmax attention over KV chunks (the "flash"
    pattern): the (T×S) score matrix is never materialized; a Python loop
    over chunks replaces the reference's ``lax.scan``. When autograd
    records, each chunk's body runs under ``torch.utils.checkpoint``, as the
    reference's runs under ``jax.checkpoint``: the backward pass recomputes
    the chunk's float32 scores instead of keeping them (at smollm-135m's
    8 x 2048 one (B, KV, G, T, chunk) score tensor is 604 MB, and autograd
    would keep several per chunk and layer).

``sdpa_direct``   — unchunked masked attention for decode (T == 1..few):
    scores are (B, KV, G, T, S).

On a mesh (DTensor inputs, ``train.loop.train(mesh=)``) both paths run on
each rank's local shards (``_on_local_shards``): the online softmax's loop
holds no DTensor operator.

Masking is position-based: q_pos/k_pos are global token positions, so causal,
sliding-window (per-layer window), cache-validity and padding masks are all
the same predicate. k_pos < 0 marks invalid slots.

Cast points (bfloat16 compute), as in the reference: the QK product of two
bf16 operands is bf16, then widened to float32 for the scale, mask and
softmax; the softmax weights go back to ``v.dtype`` before the PV product;
the chunked loop keeps its running max, sum and accumulator in float32.
"""

from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

from repro_torch.models.common import dense_init_, dtype_of, remat_call, weight_einsum
from repro_torch.models.layers import apply_rope
from repro_torch.sharding.logical import constrain, restored

NEG_INF = -1e30


class Attention(nn.Module):
    """wq (d, h, dh), wk / wv (d, kv, dh), wo (h, dh, d)."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        d, h, kv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
        for name, shape in (("wq", (d, h, dh)), ("wk", (d, kv, dh)), ("wv", (d, kv, dh)),
                            ("wo", (h, dh, d))):
            setattr(self, name, nn.Parameter(torch.empty(shape, dtype=dt, device=device)))

    def _init(self, gen):
        for p in (self.wq, self.wk, self.wv, self.wo):
            dense_init_(p, gen, 0)   # wo too: fan-in over its first axis, as the reference


def project_q(cfg, p: Attention, x: torch.Tensor, positions) -> torch.Tensor:
    q = weight_einsum("btd,dhk->bthk", x, p.wq.to(x.dtype))
    if cfg.use_rope and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
    return q


def project_kv(cfg, p: Attention, x: torch.Tensor, positions):
    k = weight_einsum("bsd,dhk->bshk", x, p.wk.to(x.dtype))
    v = weight_einsum("bsd,dhk->bshk", x, p.wv.to(x.dtype))
    if cfg.use_rope and positions is not None:
        k = apply_rope(k, positions, cfg.rope_theta)
    return k, v


def output_proj(p: Attention, y: torch.Tensor) -> torch.Tensor:
    return weight_einsum("bthk,hkd->btd", y, p.wo.to(y.dtype))


def _mask(q_pos, k_pos, *, causal: bool, window) -> torch.Tensor:
    """(B, T, S) boolean validity; window <= 0 (or None) means unlimited."""
    qp = q_pos[:, :, None]
    kp = k_pos[:, None, :]
    ok = kp >= 0  # invalid/unwritten cache slots carry k_pos = -1
    if causal:
        ok = ok & (kp <= qp)
    if window is not None and window > 0:
        ok = ok & (qp - kp < window)
    return ok


def _split_heads(q: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """(B, T, H, D) → (B, T, KV, G, D) GQA grouping (no KV repetition)."""
    b, t, h, d = q.shape
    return q.reshape(b, t, kv_heads, h // kv_heads, d)


def _local_positions(pos, placements, mesh) -> torch.Tensor:
    """This rank's block of a global (B, T) position tensor, for a tensor
    whose dims 0 and 1 are that tensor's batch and sequence."""
    if isinstance(pos, DTensor):
        pos = pos.full_tensor()
    pl = [p if p.is_shard() and p.dim < 2 else Replicate() for p in placements]
    return distribute_tensor(pos, mesh, pl, src_data_rank=None).to_local()


def _on_local_shards(sdpa):
    """On a mesh (``q`` a DTensor), run an SDPA path on each rank's shards.

    q goes to ("batch", "seq", "heads", None) and k / v to ("batch", None,
    "heads", None) by the active rules: the K/V sequence gathered (the
    context layout) or heads split (heads_tp); q and k keep their heads
    sharded on the same mesh dims or on none, so each rank's GQA groups
    stay whole. Each rank then attends its queries to its keys with plain
    tensors (the rules suspended), and the result takes q's placements.
    The masked online softmax runs locally, so no DTensor operator sits in
    the chunk loop. K and V's gradients are summed over the ranks that
    hold other queries (``Partial`` where q is sharded and k is not)."""
    @functools.wraps(sdpa)
    def wrapped(q, k, v, q_pos, k_pos, **kw):
        if not isinstance(q, DTensor):
            return sdpa(q, k, v, q_pos, k_pos, **kw)
        q = constrain(q, "batch", "seq", "heads", None)
        k = constrain(k, "batch", None, "heads", None)
        v = constrain(v, "batch", None, "heads", None)
        mesh = q.device_mesh
        qp, kp = list(q.placements), list(k.placements)
        for m in range(mesh.ndim):
            if (qp[m] == Shard(2)) != (kp[m] == Shard(2)):
                qp[m] = Replicate() if qp[m] == Shard(2) else qp[m]
                kp[m] = Replicate() if kp[m] == Shard(2) else kp[m]
        q, k, v = q.redistribute(mesh, qp), k.redistribute(mesh, kp), v.redistribute(mesh, kp)
        gkv = [b if b.is_shard() else Partial() if a.is_shard() else Replicate()
               for a, b in zip(qp, kp)]
        with restored(None):
            y = sdpa(q.to_local(), k.to_local(grad_placements=gkv),
                     v.to_local(grad_placements=gkv), _local_positions(q_pos, qp, mesh),
                     _local_positions(k_pos, kp, mesh), **kw)
        return DTensor.from_local(y, mesh, qp, run_check=False)
    return wrapped


@_on_local_shards
def sdpa_direct(q, k, v, q_pos, k_pos, *, causal: bool = True, window=None) -> torch.Tensor:
    """q: (B,T,H,D), k/v: (B,S,KV,D), *_pos: (B,T)/(B,S) → (B,T,H,D)."""
    b, t, h, d = q.shape
    kv = k.shape[2]
    qg = _split_heads(q, kv)
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k).float() * scale
    s = constrain(s, "batch", "heads", None, None, "kv_seq")
    ok = _mask(q_pos, k_pos, causal=causal, window=window)  # (B,T,S)
    s = torch.where(ok[:, None, None, :, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    y = torch.einsum("bkgts,bskd->btkgd", w.to(v.dtype), v)
    return y.reshape(b, t, h, d)


def _chunk_body(qg, kb, vb, q_pos, pb, m, l, acc, *, scale: float, causal: bool, window):
    """One KV chunk of the online softmax: (m, l, acc) → their update."""
    s = torch.einsum("btkgd,bskd->bkgts", qg, kb).float() * scale
    s = constrain(s, "batch", "heads", None, "seq", None)
    ok = _mask(q_pos, pb, causal=causal, window=window)
    s = torch.where(ok[:, None, None, :, :], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p_ = torch.exp(s - m_new[..., None])
    l = l * alpha + p_.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.einsum(
        "bkgts,bskd->bkgtd", p_.to(vb.dtype), vb).float()
    return m_new, l, acc


@_on_local_shards
def sdpa_chunked(q, k, v, q_pos, k_pos, *, causal: bool = True, window=None,
                 chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV chunks (flash pattern, tensor ops)."""
    b, t, h, d = q.shape
    kv = k.shape[2]
    s_len = k.shape[1]
    if s_len <= chunk:
        return sdpa_direct(q, k, v, q_pos, k_pos, causal=causal, window=window)

    pad = (-s_len) % chunk
    if pad:  # padded keys carry k_pos = -1: masked like unwritten cache slots
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=-1)
    n = k.shape[1] // chunk

    qg = constrain(_split_heads(q, kv), "batch", "seq", "heads", None, None)
    scale = 1.0 / math.sqrt(d)
    g = h // kv
    m = constrain(torch.full((b, kv, g, t), NEG_INF, dtype=torch.float32, device=q.device),
                  "batch", "heads", None, "seq")
    l = constrain(torch.zeros((b, kv, g, t), dtype=torch.float32, device=q.device),
                  "batch", "heads", None, "seq")
    acc = constrain(torch.zeros((b, kv, g, t, d), dtype=torch.float32, device=q.device),
                    "batch", "heads", None, "seq", None)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        kb = constrain(k[:, sl], "batch", None, "heads", None)
        vb = constrain(v[:, sl], "batch", None, "heads", None)
        m, l, acc = remat_call(True, _chunk_body, qg, kb, vb, q_pos, k_pos[:, sl], m, l, acc,
                               scale=scale, causal=causal, window=window)
    y = acc / torch.clamp(l, min=1e-30)[..., None]
    y = y.permute(0, 3, 1, 2, 4)  # (B, T, KV, G, D)
    return y.reshape(b, t, h, d).to(q.dtype)


def self_attention(cfg, p: Attention, x, positions, *, window=None, chunk: int = 1024):
    """Full self-attention block for train/prefill (causal)."""
    q = project_q(cfg, p, x, positions)
    k, v = project_kv(cfg, p, x, positions)
    y = sdpa_chunked(q, k, v, positions, positions, causal=True, window=window, chunk=chunk)
    return output_proj(p, y)


def cross_attention(cfg, p: Attention, x, memory, q_positions, m_positions, *,
                    chunk: int = 1024):
    """Encoder-decoder cross attention (non-causal, no window)."""
    q = project_q(cfg, p, x, None)  # whisper: no rope
    k, v = project_kv(cfg, p, memory, None)
    y = sdpa_chunked(q, k, v, q_positions, m_positions, causal=False, chunk=chunk)
    return output_proj(p, y)
