"""Decoder-only LM assembly for dense / MoE / SSM / hybrid families.

The port's counterpart of ``repro.models.transformer``. Layers are organized
into **groups** of structurally-identical layers, as in the reference; where
the reference stacks a group's params on a leading axis and runs them with
``lax.scan``, the port keeps one module per layer in an ``nn.ModuleList``
(``group_{i}``) and loops over it. Heterogeneous stacks (hymba:
full-attention layers at {0, mid, last} between SWA runs) become multiple
groups run in sequence. ``cfg.remat`` wraps each layer's body in
``torch.utils.checkpoint`` when autograd records (``lm_forward`` under
training), as the reference wraps its scan body in ``jax.checkpoint``:
the backward pass recomputes a layer's activations instead of keeping them.
Prefill and decode run without grad and are unchanged. ``cfg.scan_unroll``
is a compile-time concern of the reference and does nothing here.

Cache layout per group (decode), stacked over the group's layers as in the
reference:
  attention: k/v (C, B, S_cache, KV, Dh), pos (C, B, S_cache) int32 with -1
             for unwritten slots; ring caches (SWA) use S_cache = window and
             slot = position mod window. With ``cfg.kv_quant``: int8 k/v and
             float32 k_scale/v_scale (C, B, S_cache, KV).
  ssm:       conv (C, B, K-1, CH), ssd (C, B, H, P, N).
(C = layers in group.) ``lm_decode_step`` writes the new token's entries
into these tensors IN PLACE and returns the same list (the reference returns
new arrays; under ``jit`` XLA updates its buffers in place too).

Positions are int32, as in the reference; index tensors are int64 where
torch's indexing asks for it, with equal values.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Any

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (
    Attention,
    _local_positions,
    output_proj,
    project_kv,
    project_q,
    sdpa_chunked,
    sdpa_direct,
    self_attention,
)
from repro_torch.models.common import (
    dtype_of,
    embed_init_,
    init_module,
    model_split,
    over_model,
    remat_call,
    whole_weight,
)
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
from repro_torch.models.moe import MoE, apply_moe
from repro_torch.sharding.logical import constrain, restored

FULL_WINDOW = 0  # sentinel: window<=0 disables the sliding-window mask


def shard_friendly_xent(lg: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy whose gold-logit extraction partitions over a
    vocab-sharded logits tensor: an iota-compare-select sum, as the
    reference's. A gather along the sharded vocab dim would replicate the
    full float32 logits on every rank; the select keeps the vocab sharded
    and sums to a small all-reduce. Off a mesh it equals the gather bit for
    bit: each row sums one logit and zeros."""
    logz = torch.logsumexp(lg, dim=-1)
    iota = torch.arange(lg.shape[-1], device=lg.device)
    gold = torch.where(iota == targets[..., None], lg, 0.0).sum(dim=-1)
    return (logz - gold).mean()


@dataclasses.dataclass(frozen=True)
class LayerGroup:
    kind: str                  # "dense" | "moe" | "ssm" | "hybrid"
    count: int
    window: int | None         # None = full attention
    first_layer: int           # global index of first layer


def build_groups(cfg) -> tuple[LayerGroup, ...]:
    fam = cfg.family
    kind = {"dense": "dense", "vlm": "dense", "audio": "dense",
            "moe": "moe", "ssm": "ssm", "hybrid": "hybrid"}[fam]
    L = cfg.num_layers
    if not (cfg.global_first_last and cfg.sliding_window):
        return (LayerGroup(kind, L, cfg.sliding_window, 0),)
    mid, last = L // 2, L - 1
    groups: list[LayerGroup] = [LayerGroup(kind, 1, None, 0)]
    if mid - 1 > 0:
        groups.append(LayerGroup(kind, mid - 1, cfg.sliding_window, 1))
    groups.append(LayerGroup(kind, 1, None, mid))
    if last - mid - 1 > 0:
        groups.append(LayerGroup(kind, last - mid - 1, cfg.sliding_window, mid + 1))
    groups.append(LayerGroup(kind, 1, None, last))
    return tuple(groups)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class Layer(nn.Module):
    def __init__(self, cfg, kind: str, *, device=None):
        super().__init__()
        self.ln1 = Norm(cfg, device=device)
        if kind in ("dense", "moe"):
            self.attn = Attention(cfg, device=device)
            self.ln2 = Norm(cfg, device=device)
            if kind == "moe":
                self.moe = MoE(cfg, device=device)
            else:
                self.mlp = MLP(cfg, device=device)
        elif kind == "ssm":
            self.mamba = ssm_mod.Mamba(cfg, device=device)
        elif kind == "hybrid":
            self.attn = Attention(cfg, device=device)
            self.mamba = ssm_mod.Mamba(cfg, device=device)
            # Per-branch output RMSNorm scales + learned combine (hymba §3).
            self.bnorm_a = nn.Parameter(torch.ones(cfg.d_model, dtype=torch.float32,
                                                   device=device))
            self.bnorm_m = nn.Parameter(torch.ones(cfg.d_model, dtype=torch.float32,
                                                   device=device))
            self.ln2 = Norm(cfg, device=device)
            self.mlp = MLP(cfg, device=device)
        else:
            raise ValueError(kind)


class TransformerLM(nn.Module):
    """embeddings, final_norm, meta (hymba), group_{i} = ModuleList of Layer."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Embeddings(cfg, device=device)
        self.final_norm = Norm(cfg, device=device)
        if cfg.meta_tokens:
            self.meta = nn.Parameter(torch.empty(cfg.meta_tokens, cfg.d_model,
                                                 dtype=dtype_of(cfg.param_dtype), device=device))
        self.groups = build_groups(cfg)
        for i, g in enumerate(self.groups):
            setattr(self, f"group_{i}",
                    nn.ModuleList(Layer(cfg, g.kind, device=device) for _ in range(g.count)))

    def _init(self, gen):
        if self.cfg.meta_tokens:
            embed_init_(self.meta, gen)

    def group(self, i: int) -> nn.ModuleList:
        return getattr(self, f"group_{i}")


def init_lm_params(cfg, gen: torch.Generator, device=None) -> TransformerLM:
    return init_module(TransformerLM(cfg, device=device), gen)


# ---------------------------------------------------------------------------
# Layer bodies
# ---------------------------------------------------------------------------


def _rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + 1e-5)
    return (y * scale).to(x.dtype)


def apply_layer(cfg, kind: str, p: Layer, x, positions, window, aux, *, chunk: int = 1024):
    """Train/prefill layer body. Returns (x, aux)."""
    h = apply_norm(cfg, p.ln1, x)
    if kind in ("dense", "moe"):
        x = x + self_attention(cfg, p.attn, h, positions, window=window, chunk=chunk)
        h2 = apply_norm(cfg, p.ln2, x)
        if kind == "moe":
            y, a = apply_moe(cfg, p.moe, h2)
            aux = aux + a
        else:
            y = apply_mlp(cfg, p.mlp, h2)
        return x + y, aux
    if kind == "ssm":
        return x + ssm_mod.apply_mamba(cfg, p.mamba, h), aux
    if kind == "hybrid":
        att = self_attention(cfg, p.attn, h, positions, window=window, chunk=chunk)
        mam = ssm_mod.apply_mamba(cfg, p.mamba, h)
        x = x + 0.5 * (_rms(att, p.bnorm_a) + _rms(mam, p.bnorm_m))
        x = x + apply_mlp(cfg, p.mlp, apply_norm(cfg, p.ln2, x))
        return x, aux
    raise ValueError(kind)


# --- cache-producing / cache-consuming variants -----------------------------


def _quantize_kv(x):
    """(..., Dh) → (int8 values, f32 per-(token,head) scales)."""
    xf = x.float()
    scale = torch.clamp(torch.amax(torch.abs(xf), dim=-1), min=1e-8) / 127.0
    q = torch.round(xf / scale[..., None]).to(torch.int8)   # half to even, as jnp.round
    return q, scale


def _dequantize_kv(q, scale, dtype):
    return (q.float() * scale[..., None]).to(dtype)


def _cache_from_kv(k, v, positions, s_cache: int, quant: bool) -> dict:
    """One layer's decode cache (S_cache slots) holding k / v (B, S, KV, Dh)
    at ``positions`` (B, S): a full cache keeps them at the head, a ring
    cache (S_cache < S) the last S_cache tokens at slot position mod S_cache."""
    b, s, kvh, dh = k.shape
    kc = torch.zeros((b, s_cache, kvh, dh), dtype=k.dtype, device=k.device)
    vc = torch.zeros_like(kc)
    pc = torch.full((b, s_cache), -1, dtype=torch.int32, device=k.device)
    if s_cache >= s:   # full cache: place at the head
        kc[:, :s] = k
        vc[:, :s] = v
        pc[:, :s] = positions.to(torch.int32)
    else:              # ring cache: keep last s_cache tokens at slot pos % W
        keep_p = positions[:, s - s_cache:].to(torch.int32)
        slots = (keep_p % s_cache).long()                       # (B, W)
        bidx = torch.arange(b, device=k.device)[:, None]
        kc[bidx, slots] = k[:, s - s_cache:]
        vc[bidx, slots] = v[:, s - s_cache:]
        pc[bidx, slots] = keep_p
    if quant:
        kq, ks = _quantize_kv(kc)
        vq, vs = _quantize_kv(vc)
        return {"k": kq, "k_scale": ks, "v": vq, "v_scale": vs, "pos": pc}
    return {"k": kc, "v": vc, "pos": pc}


# Logical axes of a layer's cache entries, (B, S_cache, ...).
_CACHE_AXES = {"k": ("batch", "kv_seq", "heads", None), "v": ("batch", "kv_seq", "heads", None),
               "k_scale": ("batch", "kv_seq", "heads"), "v_scale": ("batch", "kv_seq", "heads"),
               "pos": ("batch", "kv_seq")}


def kv_cache(k, v, positions, s_cache: int, quant: bool = False) -> dict:
    """:func:`_cache_from_kv`; on a mesh (``k`` a DTensor) each rank builds
    its batch rows' cache from the whole sequence (K/V gathered as the
    attention gathers them), and each entry is then placed by its logical
    axes (the sequence over "model" in the context layout, KV heads in
    heads_tp): the layout ``cache_specs`` gives."""
    if not isinstance(k, DTensor):
        return _cache_from_kv(k, v, positions, s_cache, quant)
    k = constrain(k, "batch", None, "heads", None)
    v = constrain(v, "batch", None, "heads", None)
    mesh, pl = k.device_mesh, k.placements
    with restored(None):
        cache = _cache_from_kv(k.to_local(), v.to_local(), _local_positions(positions, pl, mesh),
                               s_cache, quant)
    return {name: constrain(DTensor.from_local(
                t, mesh, [p if not p.is_shard() or p.dim < t.ndim else Replicate() for p in pl],
                run_check=False), *_CACHE_AXES[name])
            for name, t in cache.items()}


def _block_offset(t: DTensor, dim: int) -> int:
    """Where this rank's block of ``t``'s dim ``dim`` starts: DTensor's
    ``torch.chunk`` split over each mesh dim that shards it, in mesh order."""
    size, off, coord = t.shape[dim], 0, t.device_mesh.get_coordinate()
    for m, p in enumerate(t.placements):
        if p.is_shard(dim):
            chunk = -(-size // t.device_mesh.size(m))
            off += coord[m] * chunk
            size = max(min(chunk, size - coord[m] * chunk), 0)
    return off


def write_slot(cache: torch.Tensor, slot: torch.Tensor, val: torch.Tensor) -> None:
    """``cache[b, slot[b]] = val[b]`` for every row b, in place. On a mesh
    (``cache`` a DTensor, its batch and sequence dims possibly sharded) each
    rank writes the rows it holds into its own block of slots: a slot outside
    the block keeps its value (a masked write, so the shapes stay static)."""
    if not isinstance(cache, DTensor):
        cache[torch.arange(cache.shape[0], device=cache.device), slot] = val
        return
    mesh, cpl = cache.device_mesh, cache.placements
    rep = [Replicate()] * mesh.ndim

    def rows(t, pl):
        t = t if isinstance(t, DTensor) else DTensor.from_local(t, mesh, rep, run_check=False)
        return t.redistribute(mesh, pl).to_local()
    val = rows(val, [p if not p.is_shard() or p.dim == 0 else
                     Shard(p.dim - 1) if p.dim >= 2 else Replicate() for p in cpl])
    slot = rows(slot, [p if p.is_shard(0) else Replicate() for p in cpl])
    local = cache.to_local()
    s_loc = local.shape[1]
    rel = slot - _block_offset(cache, 1)
    inside = ((rel >= 0) & (rel < s_loc)).reshape((-1,) + (1,) * (val.ndim - 1))
    bidx = torch.arange(local.shape[0], device=local.device)
    idx = rel.clamp(0, s_loc - 1)
    local[bidx, idx] = torch.where(inside, val.to(local.dtype), local[bidx, idx])


def _attn_prefill(cfg, p, h, positions, window, s_cache, *, chunk=1024):
    """Self-attention that also emits the layer's KV cache."""
    q = project_q(cfg, p, h, positions)
    k, v = project_kv(cfg, p, h, positions)
    y = sdpa_chunked(q, k, v, positions, positions, causal=True, window=window, chunk=chunk)
    return output_proj(p, y), kv_cache(k, v, positions, s_cache, cfg.kv_quant)


def _attn_decode(cfg, p, h1, pos, cache, window):
    """One-step attention against (and updating, in place) one layer's cache.
    h1 (B,1,D); pos (B,) current position. With cfg.kv_quant the cache holds
    int8 values + f32 scales, dequantized for the attention einsums."""
    q = project_q(cfg, p, h1, pos[:, None])
    k1, v1 = project_kv(cfg, p, h1, pos[:, None])
    s_cache = cache["k"].shape[1]
    slot = (pos % s_cache if window else torch.clamp(pos, max=s_cache - 1)).long()
    write_slot(cache["pos"], slot, pos.to(torch.int32))
    if cfg.kv_quant:
        kq1, ks1 = _quantize_kv(k1[:, 0])
        vq1, vs1 = _quantize_kv(v1[:, 0])
        write_slot(cache["k"], slot, kq1)
        write_slot(cache["k_scale"], slot, ks1)
        write_slot(cache["v"], slot, vq1)
        write_slot(cache["v_scale"], slot, vs1)
        kc = _dequantize_kv(cache["k"], cache["k_scale"], h1.dtype)
        vc = _dequantize_kv(cache["v"], cache["v_scale"], h1.dtype)
    else:
        write_slot(cache["k"], slot, k1[:, 0])
        write_slot(cache["v"], slot, v1[:, 0])
        kc, vc = cache["k"], cache["v"]
    y = sdpa_direct(q, kc, vc, pos[:, None], cache["pos"], causal=True, window=window)
    return output_proj(p, y)


def _conv_tail(cfg, pm, h):
    """The last K-1 conv inputs (for decode continuation after prefill): the
    in_proj of the last K-1 positions only. On a mesh each "model" rank
    projects its own last rows, and an all-gather over "model" gives every
    rank the sequence's last K-1 (those of the last rank, or of several when
    a rank holds fewer), for its batch rows."""
    rows = cfg.ssm_conv - 1
    if not isinstance(h, DTensor):
        return ssm_mod._in_proj(cfg, pm, h[:, -rows:])[1]
    mesh, split = h.device_mesh, model_split(h)
    w = SimpleNamespace(in_proj=whole_weight(pm.in_proj, h))
    with restored(None):
        tail = ssm_mod._in_proj(cfg, w, h.to_local()[:, -rows:])[1]
        if split is not None:
            # Every rank keeps the gathered tails whole: its gradient is its own.
            tails = over_model(tail[None], mesh, Shard(0), Replicate(), grad=Replicate())
            tail = tails.transpose(0, 1).reshape(tail.shape[0], -1, tail.shape[2])[:, -rows:]
    return DTensor.from_local(tail, mesh, [p if p.is_shard(0) else Replicate()
                                           for p in h.placements], run_check=False)


def apply_layer_prefill(cfg, kind, p, x, positions, window, s_cache, aux, *, chunk=1024):
    h = apply_norm(cfg, p.ln1, x)
    cache: dict[str, Any] = {}
    if kind in ("dense", "moe"):
        att, cache_a = _attn_prefill(cfg, p.attn, h, positions, window, s_cache, chunk=chunk)
        cache.update(cache_a)
        x = x + att
        h2 = apply_norm(cfg, p.ln2, x)
        if kind == "moe":
            y, a = apply_moe(cfg, p.moe, h2)
            aux = aux + a
        else:
            y = apply_mlp(cfg, p.mlp, h2)
        return x + y, cache, aux
    if kind == "ssm":
        y, state = ssm_mod.apply_mamba(cfg, p.mamba, h, return_state=True)
        return x + y, {"conv": _conv_tail(cfg, p.mamba, h), "ssd": state}, aux
    if kind == "hybrid":
        att, cache_a = _attn_prefill(cfg, p.attn, h, positions, window, s_cache, chunk=chunk)
        mam, state = ssm_mod.apply_mamba(cfg, p.mamba, h, return_state=True)
        cache.update(cache_a)
        cache["conv"] = _conv_tail(cfg, p.mamba, h)
        cache["ssd"] = state
        x = x + 0.5 * (_rms(att, p.bnorm_a) + _rms(mam, p.bnorm_m))
        x = x + apply_mlp(cfg, p.mlp, apply_norm(cfg, p.ln2, x))
        return x, cache, aux
    raise ValueError(kind)


def apply_layer_decode(cfg, kind, p, x1, pos, cache, window):
    """One decode step of one layer; ``cache`` holds this layer's views of
    the group's stacked tensors and is updated in place."""
    h = apply_norm(cfg, p.ln1, x1)
    if kind in ("dense", "moe"):
        x1 = x1 + _attn_decode(cfg, p.attn, h, pos, cache, window)
        h2 = apply_norm(cfg, p.ln2, x1)
        if kind == "moe":
            y, _ = apply_moe(cfg, p.moe, h2)
        else:
            y = apply_mlp(cfg, p.mlp, h2)
        return x1 + y
    if kind == "ssm":
        return x1 + ssm_mod.mamba_decode_(cfg, p.mamba, h, cache)
    if kind == "hybrid":
        att = _attn_decode(cfg, p.attn, h, pos, cache, window)
        mam = ssm_mod.mamba_decode_(cfg, p.mamba, h, cache)
        x1 = x1 + 0.5 * (_rms(att, p.bnorm_a) + _rms(mam, p.bnorm_m))
        return x1 + apply_mlp(cfg, p.mlp, apply_norm(cfg, p.ln2, x1))
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Whole-model forward
# ---------------------------------------------------------------------------


def _window_arg(g: LayerGroup):
    return g.window if g.window else None


def _embed_inputs(cfg, params: TransformerLM, batch, compute_dtype):
    """tokens and/or embeds → (x, positions, n_prefix). Meta tokens (hymba)
    are prepended; positions are global token indices."""
    if "embeds" in batch:
        x = batch["embeds"].to(compute_dtype)
    else:
        x = embed_tokens(cfg, params.embeddings, batch["tokens"], compute_dtype)
    b, t = x.shape[0], x.shape[1]
    n_prefix = 0
    if cfg.meta_tokens:
        meta = params.meta.to(compute_dtype)
        x = torch.cat([meta.expand((b,) + meta.shape), x], dim=1)
        n_prefix = cfg.meta_tokens
        t = t + n_prefix
    positions = torch.arange(t, dtype=torch.int32, device=x.device).expand(b, t)
    if not cfg.use_rope:
        x = x + sinusoidal_positions(positions, cfg.d_model).to(compute_dtype)
    return constrain(x, "batch", "seq", None), positions, n_prefix


def lm_forward(cfg, params: TransformerLM, batch: dict, *, chunk: int = 1024):
    """Full causal forward → (logits (B,T,V), aux_loss). T excludes meta."""
    cdt = dtype_of(cfg.compute_dtype)
    x, positions, n_prefix = _embed_inputs(cfg, params, batch, cdt)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, g in enumerate(params.groups):
        for layer in params.group(i):
            x, aux = remat_call(cfg.remat, apply_layer, cfg, g.kind, layer, x, positions,
                                _window_arg(g), aux, chunk=chunk)
            x = constrain(x, "batch", "seq", None)
    x = apply_norm(cfg, params.final_norm, x)
    if n_prefix:
        x = x[:, n_prefix:, :]
    return unembed(cfg, params.embeddings, x), aux


def lm_loss(cfg, params: TransformerLM, batch: dict, *, chunk: int = 1024):
    """Next-token cross-entropy (shift-by-one inside). batch: tokens (B,T)
    [+ embeds (B,T,D) for stub-frontend archs, in which case tokens are the
    targets aligned with embeds]."""
    logits, aux = lm_forward(cfg, params, batch, chunk=chunk)
    targets = batch["tokens"][:, 1:]
    lg = constrain(logits[:, :-1, :].float(), "batch", None, "vocab")
    nll = shard_friendly_xent(lg, targets)
    return nll + aux, {"nll": nll, "aux": aux}


def lm_prefill(cfg, params: TransformerLM, batch: dict, *, s_cache: int | None = None,
               chunk: int = 1024):
    """Forward + cache build. Returns (last-token logits (B,V), caches)."""
    cdt = dtype_of(cfg.compute_dtype)
    x, positions, n_prefix = _embed_inputs(cfg, params, batch, cdt)
    total = x.shape[1]
    caches = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    # ``s_cache`` counts RAW token positions; the meta-token prefix (hymba)
    # occupies additional slots in full (non-ring) caches.
    full_sc = (s_cache or (total - n_prefix)) + n_prefix
    for i, g in enumerate(params.groups):
        sc = max(g.window if g.window else full_sc, 1)
        per_layer = []
        for layer in params.group(i):
            x, cache, aux = apply_layer_prefill(cfg, g.kind, layer, x, positions,
                                                _window_arg(g), sc, aux, chunk=chunk)
            x = constrain(x, "batch", "seq", None)
            per_layer.append(cache)
        caches.append({k: torch.stack([c[k] for c in per_layer]) for k in per_layer[0]})
    x = apply_norm(cfg, params.final_norm, x)
    logits = unembed(cfg, params.embeddings, x[:, -1:, :])[:, 0, :]
    return logits, caches


def lm_decode_step(cfg, params: TransformerLM, caches: list, token: torch.Tensor,
                   pos: torch.Tensor):
    """One decode step. token (B,1) int; pos (B,) = index of `token` in the
    raw sequence (meta-token offset applied internally). Returns
    (logits (B,V), caches), the caches updated in place."""
    cdt = dtype_of(cfg.compute_dtype)
    x = embed_tokens(cfg, params.embeddings, token, cdt)
    gpos = pos.to(torch.int32) + cfg.meta_tokens
    if not cfg.use_rope:
        x = x + sinusoidal_positions(gpos[:, None], cfg.d_model).to(cdt)
    for i, g in enumerate(params.groups):
        for j, layer in enumerate(params.group(i)):
            layer_cache = {k: v[j] for k, v in caches[i].items()}
            x = apply_layer_decode(cfg, g.kind, layer, x, gpos, layer_cache, _window_arg(g))
    x = apply_norm(cfg, params.final_norm, x)
    logits = unembed(cfg, params.embeddings, x)[:, 0, :]
    return logits, caches


def init_decode_caches(cfg, batch: int, s_cache: int, dtype, device=None) -> list:
    """Empty caches for all groups."""
    caches = []
    kvh, dh = cfg.num_kv_heads, cfg.head_dim_
    for g in build_groups(cfg):
        c: dict[str, Any] = {}
        if g.kind in ("dense", "moe", "hybrid"):
            sc = g.window if g.window else s_cache
            shape = (g.count, batch, sc, kvh, dh)
            if cfg.kv_quant:
                c["k"] = torch.zeros(shape, dtype=torch.int8, device=device)
                c["v"] = torch.zeros(shape, dtype=torch.int8, device=device)
                c["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
                c["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
            else:
                c["k"] = torch.zeros(shape, dtype=dtype, device=device)
                c["v"] = torch.zeros(shape, dtype=dtype, device=device)
            c["pos"] = torch.full(shape[:3], -1, dtype=torch.int32, device=device)
        if g.kind in ("ssm", "hybrid"):
            st = ssm_mod.init_mamba_cache(cfg, batch, dtype, device)
            c["conv"] = torch.zeros((g.count,) + st["conv"].shape, dtype=dtype, device=device)
            c["ssd"] = torch.zeros((g.count,) + st["ssd"].shape, dtype=torch.float32,
                                   device=device)
        caches.append(c)
    return caches
