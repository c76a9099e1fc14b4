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

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ops import onehot_count
from repro_torch.models.common import dense_init_, dtype_of, on_batch_shards, weight_einsum
from repro_torch.models.layers import MLP, apply_mlp

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


def route(cfg, p: MoE, x: torch.Tensor):
    """x (B,T,D) → top-k expert ids (B,T,K), gates (B,T,K), aux loss, load.

    Load statistics use the paper's conflict-free counting primitive.
    """
    logits = weight_einsum("btd,de->bte", x.float(), p.router)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, ids = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    gates = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # Switch-style load-balancing aux loss: E * Σ_e f_e · p̄_e, where f_e is
    # the fraction of tokens whose TOP-1 lands on e (counted conflict-free).
    top1_counts = onehot_count(ids[..., :1].reshape(x.shape[0], -1), cfg.num_experts)
    f_e = top1_counts / torch.clamp(top1_counts.sum(-1, keepdim=True), min=1.0)
    p_e = probs.mean(dim=1)
    aux = cfg.num_experts * torch.mean(torch.sum(f_e * p_e, dim=-1))
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


# On a mesh the layer runs on each rank's batch shard with the whole
# sequence (routing and capacity are per batch row over its sequence) and
# every expert's whole weights; the aux loss comes back Partial over the
# batch shards. The experts are stored sharded by their specs and gathered
# for the layer, as FSDP does: DTensor refuses the layer's own operators
# (arctic's ``aten.index_put_``, the backward of mixtral's dispatch
# ``aten.view``).
@on_batch_shards
def apply_moe(cfg, p: MoE, x: torch.Tensor):
    """x (B,T,D) → (y (B,T,D), aux_loss). Capacity-dropped tokens pass
    through the residual (and arctic's dense branch) only."""
    bsz, t, d = x.shape
    ids, gates, aux, _ = route(cfg, p, x)
    k = cfg.num_experts_per_tok
    e = cfg.num_experts
    cap = _capacity(cfg, t)
    ids_f = ids.reshape(bsz, t * k)
    gates_f = gates.reshape(bsz, t * k)
    eh = F.one_hot(ids_f, e).to(torch.int32)           # (B, T*K, E)
    slots = _slot_positions(eh)                         # (B, T*K)
    keep = slots < cap                                  # capacity overflow drops
    gb = torch.where(keep, gates_f, torch.zeros_like(gates_f))
    xrep = torch.repeat_interleave(x, k, dim=1)         # (B, T*K, D): jnp.repeat

    if cfg.moe_dispatch == "einsum":
        # Dispatch tensor D (B, T*K, E, C) — one-hot over (expert, slot).
        slot_oh = F.one_hot(torch.where(keep, slots, cap).long(), cap + 1).to(x.dtype)[..., :cap]
        disp = eh.to(x.dtype)[..., :, None] * slot_oh[..., None, :]
        xe = torch.einsum("btec,btd->becd", disp, xrep)
        ye = _experts_mlp(cfg, p, xe)
        comb = disp * gb[..., None, None].to(x.dtype)
        y = torch.einsum("btec,becd->btd", comb, ye)                     # (B, T*K, D)
        y = y.reshape(bsz, t, k, d).sum(dim=2)
    else:
        # Over-capacity rows go to the in-bounds sentinel row e*cap (see the
        # module docstring), which is cut off before the experts run.
        flat_slot = torch.where(keep, ids_f.to(torch.int32) * cap + slots,
                                torch.full_like(slots, e * cap)).long()
        bidx = torch.arange(bsz, device=x.device)[:, None]
        buf = torch.zeros((bsz, e * cap + 1, d), dtype=x.dtype, device=x.device)
        buf[bidx, flat_slot] = xrep
        ye = _experts_mlp(cfg, p, buf[:, : e * cap].reshape(bsz, e, cap, d))
        back = torch.cat([ye.reshape(bsz, e * cap, d),
                          torch.zeros((bsz, 1, d), dtype=x.dtype, device=x.device)], dim=1)
        back = back[bidx, flat_slot]
        y = (back * gb[..., None].to(x.dtype)).reshape(bsz, t, k, d).sum(dim=2)

    if cfg.moe_dense_residual:
        y = y + apply_mlp(cfg, p.dense, x)
    return y, aux * cfg.router_aux_coef


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
