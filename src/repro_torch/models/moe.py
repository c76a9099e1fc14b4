"""Mixture-of-Experts layer (mixtral 8e / arctic 128e, top-2).

The port's counterpart of ``repro.models.moe``. Token→expert assignment
counting is a histogram with write conflicts, the pathology the paper
studies for GLCM voting; as in the reference:

  * router load statistics     → ``kernels.ops.onehot_count`` (one-hot
    reduce instead of a contended scatter);
  * capacity-slot positions    → cumulative one-hot sums (prefix votes);
  * dispatch/combine           → one-hot matmuls ("einsum") or an indexed
    gather ("gather").

Two dispatch strategies (cfg.moe_dispatch), both per batch row (GShard
groups); the reference's ``vmap`` over rows is a leading batch axis here:
  "einsum"  dense dispatch: D ∈ {0,1}^(T·K×E×C) one-hot tensor, X_e = Dᵀ·X.
  "gather"  experts gather their tokens by computed slot indices.

Differences from the reference, each handled here:
  * ``torch.topk`` does not promise the reference's tie order
    (``jax.lax.top_k`` breaks ties toward the lower index). Router
    probabilities of real inputs have no ties; parity inputs have none.
  * The reference's gather dispatch writes with ``.at[...].set(mode="drop")``.
    Its over-capacity rows aim at a sentinel row ``E·C`` that lies inside the
    buffer (so nothing is dropped by "drop" itself), and the sentinel is cut
    off before the experts run. The port masks those rows onto the same
    in-bounds sentinel, never past the end of the buffer: torch would raise
    (CPU) or write out of bounds (card) where JAX drops.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels.ops import one_hot, onehot_count
from repro_torch.models.common import (
    dense_init_,
    dtype_of,
    local_weight,
    model_shard_dim,
    model_split,
    over_model,
    whole_weight,
)
from repro_torch.models.layers import MLP, apply_mlp
from repro_torch.sharding.logical import restored

NEG_INF = -1e9


class MoE(nn.Module):
    """router (d, e) float32, w_gate / w_up (e, d, f), w_down (e, f, d);
    arctic's dense residual FFN as ``dense``."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
        self.router = nn.Parameter(torch.empty(d, e, dtype=torch.float32, device=device))
        self.w_gate = nn.Parameter(torch.empty(e, d, f, dtype=dt, device=device))
        self.w_up = nn.Parameter(torch.empty(e, d, f, dtype=dt, device=device))
        self.w_down = nn.Parameter(torch.empty(e, f, d, dtype=dt, device=device))
        if cfg.moe_dense_residual:  # arctic: dense FFN in parallel with the MoE
            self.dense = MLP(cfg, d_ff=cfg.dense_residual_ff, device=device)

    def _init(self, gen):
        dense_init_(self.router, gen, 0)
        for p in (self.w_gate, self.w_up, self.w_down):
            dense_init_(p, gen, 1)


def _capacity(cfg, tokens: int) -> int:
    cap = int(tokens * cfg.num_experts_per_tok * cfg.capacity_factor / cfg.num_experts)
    return max(cap, cfg.num_experts_per_tok)


def _router(cfg, router: torch.Tensor, x: torch.Tensor):
    """x (B,T,D) → top-k expert ids (B,T,K), renormalized gates (B,T,K) float32,
    router probabilities (B,T,E)."""
    logits = torch.einsum("btd,de->bte", x.float(), router)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, ids = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    gates = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return ids, gates, probs


def _aux(cfg, top1_counts: torch.Tensor, p_e: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balancing aux loss: E * mean_b Σ_e f_e · p̄_e, where
    f_e is the fraction of a row's tokens whose TOP-1 lands on e."""
    f_e = top1_counts / torch.clamp(top1_counts.sum(-1, keepdim=True), min=1.0)
    return cfg.num_experts * torch.mean(torch.sum(f_e * p_e, dim=-1))


def route(cfg, p: MoE, x: torch.Tensor):
    """x (B,T,D) → top-k expert ids (B,T,K), gates (B,T,K), aux loss, load.

    Load statistics use the paper's conflict-free counting primitive.
    """
    ids, gates, probs = _router(cfg, p.router, x)
    # f_e counted conflict-free.
    top1_counts = onehot_count(ids[..., :1].reshape(x.shape[0], -1), cfg.num_experts)
    aux = _aux(cfg, top1_counts, probs.mean(dim=1))
    load = onehot_count(ids.reshape(-1)[None, :], cfg.num_experts)[0]
    return ids, gates.to(x.dtype), aux, load


def _slot_positions(ids_onehot: torch.Tensor) -> torch.Tensor:
    """Position of each (token, k) vote within its expert's queue: an
    exclusive prefix-sum of one-hot votes over the flattened (T·K) axis.
    ids_onehot: (..., T*K, E) → (..., T*K) int32 slots."""
    prefix = torch.cumsum(ids_onehot, dim=-2) - ids_onehot
    return torch.sum(prefix * ids_onehot, dim=-1).to(torch.int32)


def _experts_mlp(cfg, p: MoE, xe: torch.Tensor) -> torch.Tensor:
    """Batched expert FFN: xe (B, E, C, D) → (B, E, C, D)."""
    dt = xe.dtype
    gate = torch.einsum("becd,edf->becf", xe, p.w_gate.to(dt))
    up = torch.einsum("becd,edf->becf", xe, p.w_up.to(dt))
    return torch.einsum("becf,efd->becd", F.silu(gate) * up, p.w_down.to(dt))


def _dispatch(cfg, x, ids_f, slots, cap):
    """Each vote's token into its (expert, slot) of the (B, E, C, D) buffer
    (zeros where no vote lands; over-capacity votes land nowhere), and what
    :func:`_combine` needs to bring the slots back. x (B,T,D); ids_f, slots
    (B, T*K)."""
    bsz, _, d = x.shape
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    keep = slots < cap                                  # capacity overflow drops
    xrep = torch.repeat_interleave(x, k, dim=1)         # (B, T*K, D): jnp.repeat
    if cfg.moe_dispatch == "einsum":
        # Dispatch tensor D (B, T*K, E, C) — one-hot over (expert, slot).
        eh = one_hot(ids_f, e, x.dtype)
        slot_oh = one_hot(torch.where(keep, slots, cap), cap, x.dtype)   # a dropped vote: none
        disp = eh[..., :, None] * slot_oh[..., None, :]
        return torch.einsum("btec,btd->becd", disp, xrep), (keep, disp)
    # Over-capacity rows go to the in-bounds sentinel row e*cap (see the
    # module docstring), which is cut off before the experts run.
    flat_slot = torch.where(keep, ids_f.to(torch.int32) * cap + slots,
                            torch.full_like(slots, e * cap)).long()
    bidx = torch.arange(bsz, device=x.device)[:, None]
    buf = torch.zeros((bsz, e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[bidx, flat_slot] = xrep
    return buf[:, : e * cap].reshape(bsz, e, cap, d), (keep, flat_slot)


def _combine(cfg, ye, gates_f, how, t):
    """The experts' slots (B, E, C, D) back to the tokens (B, T, D), each
    vote weighted by its gate (zero where it dropped)."""
    bsz, e, cap, d = ye.shape
    k = cfg.num_experts_per_tok
    keep, route_ = how
    gb = torch.where(keep, gates_f, torch.zeros_like(gates_f)).to(ye.dtype)
    if cfg.moe_dispatch == "einsum":
        comb = route_ * gb[..., None, None]
        y = torch.einsum("btec,becd->btd", comb, ye)                     # (B, T*K, D)
        return y.reshape(bsz, t, k, d).sum(dim=2)
    bidx = torch.arange(bsz, device=ye.device)[:, None]
    back = torch.cat([ye.reshape(bsz, e * cap, d),
                      torch.zeros((bsz, 1, d), dtype=ye.dtype, device=ye.device)], dim=1)
    back = back[bidx, route_]
    return (back * gb[..., None]).reshape(bsz, t, k, d).sum(dim=2)


def apply_moe(cfg, p: MoE, x: torch.Tensor):
    """x (B,T,D) → (y (B,T,D), aux_loss). Capacity-dropped tokens pass
    through the residual (and arctic's dense branch) only."""
    if isinstance(x, DTensor):
        return _moe_on_mesh(cfg, p, x)
    bsz, t, d = x.shape
    ids, gates, aux, _ = route(cfg, p, x)
    k = cfg.num_experts_per_tok
    cap = _capacity(cfg, t)
    ids_f = ids.reshape(bsz, t * k)
    slots = _slot_positions(one_hot(ids_f, cfg.num_experts, torch.int32))      # (B, T*K)
    xe, how = _dispatch(cfg, x, ids_f, slots, cap)
    y = _combine(cfg, _experts_mlp(cfg, p, xe), gates.reshape(bsz, t * k), how, t)
    if cfg.moe_dense_residual:
        y = y + apply_mlp(cfg, p.dense, x)
    return y, aux * cfg.router_aux_coef


def _moe_on_mesh(cfg, p: MoE, x: DTensor):
    """The layer on a mesh, as the reference's partitioned program runs it.
    ``x`` arrives with its sequence over "model" (or whole on every "model"
    rank: a decode token, a sequence that does not divide). Each rank routes
    and dispatches only its own tokens into a (B, E, C, D) buffer of its
    batch rows; routing and capacity stay per batch row over the whole
    sequence: a vote's slot is its rank-local position plus the votes of the
    same row and expert on the earlier "model" ranks (an all-gather of a
    (B, E) count), so the same votes drop as in one process, and the aux
    loss's statistics are sums over "model". The experts run where the
    reference's spec puts their weights:

    * experts over "model" (arctic, ``shard_experts``): the buffer is reduced
      to each rank's E/m experts (reduce-scatter), they run there, and their
      slots are all-gathered back;
    * d_ff over "model" (mixtral): the buffer is summed whole on every rank
      (all-reduce), each rank runs its d_ff slice of every expert, and the
      partial outputs are summed (all-reduce).

    Each rank then combines its own tokens. The experts' weights are the
    rank's "model" shard, gathered over "data" only (FSDP)."""
    mesh = x.device_mesh
    split = model_split(x)
    bsz, t, d = x.shape
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    cap = _capacity(cfg, t)
    router = whole_weight(p.router, x)
    ew = SimpleNamespace(w_gate=local_weight(p.w_gate, x), w_up=local_weight(p.w_up, x),
                         w_down=local_weight(p.w_down, x))
    sharded = model_shard_dim(p.w_gate)   # 0: experts over "model"; 2: d_ff; None
    with restored(None):
        xl = x.to_local()
        b_loc, t_loc = xl.shape[:2]
        ids, gates, probs = _router(cfg, router, xl)
        top1 = onehot_count(ids[..., :1].reshape(b_loc, -1), e)          # (B, E)
        ids_f = ids.reshape(b_loc, t_loc * k)
        eh = one_hot(ids_f, e, torch.int32)
        slots = _slot_positions(eh)
        if split is not None:
            rank, ranks = split
            # The row's votes for each expert on every "model" rank; a vote's
            # slot counts those of the ranks before this one.
            every = over_model(eh.sum(dim=1)[None], mesh, Shard(0), Replicate())   # (m, B, E)
            before = torch.arange(ranks, device=xl.device) < rank
            offset = (every * before[:, None, None].to(every.dtype)).sum(dim=0)
            slots = slots + (eh * offset[:, None, :]).sum(dim=-1).to(torch.int32)
            top1 = over_model(top1, mesh, Partial(), Replicate(), grad=Replicate())
        aux = _aux(cfg, top1, probs.sum(dim=1) / t)
        xe, how = _dispatch(cfg, xl, ids_f, slots, cap)                   # (B, E, C, D)
        # The buffer is a sum over "model" of each rank's votes (or, where
        # every rank holds the whole sequence, the same on every rank). Each
        # rank takes its experts' slots, or the whole buffer, which every rank
        # then uses for its own share of the work: its d_ff slice, or its
        # tokens. Where the buffer was the same everywhere, only its gradient
        # is summed.
        src = Partial() if split is not None else Replicate()
        if sharded == 0:
            xe = over_model(xe, mesh, src, Shard(1))
        elif sharded is not None or split is not None:
            xe = over_model(xe, mesh, src, Replicate())
        ye = _experts_mlp(cfg, ew, xe)
        # The slots come back whole to every rank, which combines its tokens
        # (or, where it holds the whole sequence, all of them, as every rank does).
        grad = None if split is not None else Replicate()
        if sharded == 0:
            ye = over_model(ye, mesh, Shard(1), Replicate(), grad=grad)
        elif sharded is not None:
            ye = over_model(ye, mesh, Partial(), Replicate(), grad=grad)
        y = _combine(cfg, ye, gates.to(xl.dtype).reshape(b_loc, t_loc * k), how, t_loc)
        y = DTensor.from_local(y, mesh, x.placements, run_check=False)
    # The aux loss: a mean over batch rows (each batch shard's mean over the
    # shards), and over "model" the sum of each rank's share of p̄_e.
    shards = math.prod(mesh.size(m) for m, pl in enumerate(x.placements) if pl.is_shard(0))
    aux = DTensor.from_local(aux * cfg.router_aux_coef / shards, mesh,
                             [Partial() if pl.is_shard() else Replicate() for pl in x.placements],
                             run_check=False)
    if cfg.moe_dense_residual:
        y = y + apply_mlp(cfg, p.dense, x)
    return y, aux


def moe_dense_oracle(cfg, p: MoE, x: torch.Tensor) -> torch.Tensor:
    """Compute-everything oracle: every expert runs every token, outputs are
    one-hot-combined: y = Σ_k gate_k · FFN_{id_k}(x). No capacity drops."""
    ids, gates, _, _ = route(cfg, p, x)
    dt = x.dtype

    def one_expert(ee):
        gate = torch.einsum("btd,df->btf", x, p.w_gate[ee].to(dt))
        up = torch.einsum("btd,df->btf", x, p.w_up[ee].to(dt))
        return torch.einsum("btf,fd->btd", F.silu(gate) * up, p.w_down[ee].to(dt))

    all_out = torch.stack([one_expert(ee) for ee in range(cfg.num_experts)])  # (E,B,T,D)
    y = torch.zeros_like(x)
    for kk in range(cfg.num_experts_per_tok):
        sel_oh = F.one_hot(ids[..., kk], cfg.num_experts).to(dt)            # (B,T,E)
        sel = torch.einsum("ebtd,bte->btd", all_out, sel_oh)
        y = y + gates[..., kk, None].to(dt) * sel
    if cfg.moe_dense_residual:
        y = y + apply_mlp(cfg, p.dense, x)
    return y
