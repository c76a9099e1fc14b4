"""Mamba-2 mixer with the SSD (state-space duality) algorithm
[arXiv:2405.21060], plus the O(1)-state decode step.

The port's counterpart of ``repro.models.ssm``. The chunked SSD form:
within a chunk the recurrence is a masked (attention-like) matmul; across
chunks a linear recurrence carries the (heads, head_dim, state) tensor, here
a Python loop over chunks in place of the reference's ``lax.scan``.

Layout conventions (n_groups = 1):
  x   (B, T, H, P)   heads H = d_inner / head_dim, P = head_dim
  dt  (B, T, H)      softplus-discretized step sizes
  A   (H,)           negative decay rates (A = -exp(A_log))
  B,C (B, T, N)      shared across heads (one group), N = ssm_state

The SSD einsums run in float32 (the reference's
``preferred_element_type=float32``; ``Δt·x`` is float32 by promotion).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.common import (
    dense_init_,
    dtype_of,
    model_index,
    model_split,
    over_model,
    whole_module,
)
from repro_torch.sharding.logical import constrain, restored

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., L) per-step log-decays → (..., L, L) lower-triangular
    segment sums S[i, j] = Σ_{k=j+1..i} a_k (i ≥ j), -inf above diagonal."""
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    l = a.shape[-1]
    lower = torch.ones((l, l), dtype=torch.bool, device=a.device).tril()
    return torch.where(lower, diff, NEG_INF)


def ssd_chunked(x, dt, a, b_mat, c_mat, *, chunk: int, initial_state=None, enter=None):
    """Returns (y (B,T,H,P), final_state (B,H,P,N)).

    ``enter``, for a block of a longer sequence (one "model" rank's on a
    mesh), gives the state entering the block: it is called with the block's
    final state from a zero start and its total decay (B,H), and the block's
    chunks then take that state into their entering states, their outputs and
    the final state (``initial_state`` is then the caller's concern)."""
    bsz, t, h, p = x.shape
    n = b_mat.shape[-1]
    if t % chunk:
        raise ValueError(f"seq len {t} must be a multiple of ssm_chunk {chunk}")
    c = t // chunk

    xd = constrain((x * dt[..., None]).reshape(bsz, c, chunk, h, p),
                   "batch", "seq", None, None, None)             # Δt·x
    la = (dt * a[None, None, :]).reshape(bsz, c, chunk, h)       # per-step log decay
    la = constrain(la.permute(0, 3, 1, 2), "batch", None, "seq", None)  # (B,H,C,L)
    bm = constrain(b_mat.reshape(bsz, c, chunk, n), "batch", "seq", None, None)
    cm = constrain(c_mat.reshape(bsz, c, chunk, n), "batch", "seq", None, None)

    la_cs = torch.cumsum(la, dim=-1)                             # (B,H,C,L)

    # 1. Intra-chunk ("diagonal") output: masked attention-like matmul.
    decay_mat = torch.exp(_segsum(la))                           # (B,H,C,L,L)
    y_diag = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp",
                          cm.float(), bm.float(), decay_mat, xd.float())

    # 2. Per-chunk final states.
    decay_states = torch.exp(la_cs[..., -1:] - la_cs)            # (B,H,C,L)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", bm.float(), decay_states, xd.float())

    # 3. Inter-chunk linear recurrence over chunks; emits the state ENTERING
    # each chunk.
    chunk_decay = torch.exp(la_cs[..., -1])                      # (B,H,C)
    state = (initial_state.float() if initial_state is not None and enter is None
             else torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device))
    state = constrain(state, "batch", None, None, None)
    prev = []
    for i in range(c):
        prev.append(state)
        state = state * chunk_decay[:, :, i, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)                       # (B,C,H,P,N)
    if enter is not None:
        # The entering state s decays through the earlier chunks of the block
        # into each chunk's entering state, and through all of them into the
        # final state.
        la_chunk = la_cs[..., -1]                                # (B,H,C)
        through = torch.exp(torch.cumsum(la_chunk, dim=-1) - la_chunk)
        total = torch.exp(la_chunk.sum(-1))                      # (B,H)
        s_in = enter(state, total)                               # (B,H,P,N)
        prev_states = prev_states + s_in[:, None] * through.permute(0, 2, 1)[..., None, None]
        state = state + s_in * total[..., None, None]

    # 4. State → output within each chunk.
    state_decay_out = torch.exp(la_cs)                           # (B,H,C,L)
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", cm.float(), prev_states, state_decay_out)

    y = constrain(y_diag + y_off, "batch", "seq", None, None, None)
    y = y.reshape(bsz, t, h, p)
    return y.to(x.dtype), state


def ssd_reference(x, dt, a, b_mat, c_mat, *, initial_state=None):
    """Naive step-by-step recurrence (oracle for tests)."""
    bsz, t, h, p = x.shape
    n = b_mat.shape[-1]
    s = (initial_state.float() if initial_state is not None
         else torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device))
    ys = []
    for i in range(t):
        dec = torch.exp(dt[:, i, :] * a[None, :])                # (B,H)
        upd = torch.einsum("bhp,bn->bhpn", x[:, i] * dt[:, i, :, None], b_mat[:, i])
        s = s * dec[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", s, c_mat[:, i]))
    return torch.stack(ys, dim=1).to(x.dtype), s


def ssd_decode_step(state, x1, dt1, a, b1, c1):
    """One-token recurrent update. state (B,H,P,N); x1 (B,H,P); dt1 (B,H);
    b1/c1 (B,N) → (y (B,H,P), new_state)."""
    dec = torch.exp(dt1 * a[None, :])
    upd = torch.einsum("bhp,bn->bhpn", x1 * dt1[..., None], b1)
    new_state = state * dec[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, c1)
    return y.to(x1.dtype), new_state


# ---------------------------------------------------------------------------
# Full Mamba-2 mixer block
# ---------------------------------------------------------------------------


def _dims(cfg):
    d_in = cfg.ssm_d_inner
    h = cfg.ssm_heads
    n = cfg.ssm_state
    conv_ch = d_in + 2 * n  # conv runs over [x, B, C] jointly
    return d_in, h, n, conv_ch


class Mamba(nn.Module):
    def __init__(self, cfg, *, device=None):
        super().__init__()
        dt_ = dtype_of(cfg.param_dtype)
        d, (d_in, h, n, conv_ch) = cfg.d_model, _dims(cfg)
        f32 = dict(dtype=torch.float32, device=device)
        self.in_proj = nn.Parameter(torch.empty(d, 2 * d_in + 2 * n + h, dtype=dt_, device=device))
        self.conv_w = nn.Parameter(torch.empty(cfg.ssm_conv, conv_ch, dtype=dt_, device=device))
        self.conv_b = nn.Parameter(torch.zeros(conv_ch, dtype=dt_, device=device))
        # A = -exp(A_log) ∈ [-16, -1]
        self.A_log = nn.Parameter(torch.log(torch.linspace(1.0, 16.0, h, **f32)))
        self.D = nn.Parameter(torch.ones(h, **f32))
        self.dt_bias = nn.Parameter(torch.log(torch.expm1(torch.full((h,), 0.01, **f32))))
        self.gate_norm = nn.Parameter(torch.ones(d_in, **f32))
        self.out_proj = nn.Parameter(torch.empty(d_in, d, dtype=dt_, device=device))

    @torch.no_grad()
    def _init(self, gen):
        dense_init_(self.in_proj, gen, 0)
        w = torch.empty(self.conv_w.shape, dtype=torch.float32, device=self.conv_w.device)
        self.conv_w.copy_(0.1 * w.normal_(generator=gen))
        dense_init_(self.out_proj, gen, 0)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 halo: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv over time. xbc (B,T,CH); w (K,CH). ``halo``
    (B,K-1,CH) holds the K-1 inputs before the first (zeros when None)."""
    k = w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0)) if halo is None else torch.cat([halo, xbc], dim=1)
    out = torch.zeros_like(xbc)
    for i in range(k):  # K=4: shifted adds
        out = out + pad[:, i: i + xbc.shape[1], :] * w[i][None, None, :]
    return out + b[None, None, :]


def _split_in(cfg, proj):
    d_in, h, n, _ = _dims(cfg)
    return torch.split(proj, [d_in, d_in, n, n, h], dim=-1)   # z, xc, B, C, dt


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0); F.softplus switches to x above
    # its threshold.
    return torch.logaddexp(x, torch.zeros_like(x))


def _gated_rmsnorm(y, z, scale, dtype):
    """Mamba2's norm-before-out_proj: RMSNorm of y·silu(z), float32 statistics."""
    y = y * F.silu(z)
    yf = y.float()
    return (yf * torch.rsqrt(torch.mean(yf * yf, -1, keepdim=True) + 1e-5) * scale).to(dtype)


def apply_mamba(cfg, p: Mamba, u: torch.Tensor, *, initial_state=None, return_state=False):
    """u: (B, T, d_model) → (B, T, d_model) [, final ssd state (B, H, P, N)]."""
    if isinstance(u, DTensor):
        return _mixer_on_mesh(cfg, p, u, initial_state=initial_state, return_state=return_state)
    out, final_state = _mixer(cfg, p, u, initial_state=initial_state)
    return (out, final_state) if return_state else out


def _in_proj(cfg, p, u):
    """u (B,T,D) → z (B,T,d_in), the conv inputs [x, B, C] (B,T,CH), raw dt (B,T,H)."""
    proj = torch.einsum("btd,de->bte", u, p.in_proj.to(u.dtype))
    z, xc, bm, cm, dt_raw = _split_in(cfg, proj)
    return z, torch.cat([xc, bm, cm], dim=-1), dt_raw


def _ssm(cfg, p, xbc, dt_raw, dtype, *, initial_state=None, enter=None):
    """The conv's output (B,T,CH), after its SiLU, and raw dt → the SSD's
    output with the D skip (B,T,d_in), final state."""
    bsz, t, _ = xbc.shape
    d_in, h, n, _ = _dims(cfg)
    xc, bm, cm = torch.split(F.silu(xbc), [d_in, n, n], dim=-1)
    x = xc.reshape(bsz, t, h, cfg.ssm_head_dim)
    dt = _softplus(dt_raw.float() + p.dt_bias)
    a = -torch.exp(p.A_log)

    # Pad the sequence to a chunk multiple. Padded steps carry dt = 0
    # (decay exp(0·A) = 1, update 0·x·B = 0) so the final state is exact.
    chunk = min(cfg.ssm_chunk, t)
    pad = (-t) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, pad))
    y, final_state = ssd_chunked(x, dt, a, bm.float(), cm.float(), chunk=chunk,
                                 initial_state=initial_state, enter=enter)
    if pad:
        y = y[:, :t]
        x = x[:, :t]
    y = y + x * p.D[None, None, :, None].to(x.dtype)
    return y.reshape(bsz, t, d_in), final_state


def _out_proj(p, y, z, dtype):
    y = _gated_rmsnorm(y, z, p.gate_norm, dtype)
    return torch.einsum("bte,ed->btd", y, p.out_proj.to(dtype))


def _mixer(cfg, p: Mamba, u: torch.Tensor, *, initial_state=None):
    """The mixer on one device: (out, final state)."""
    z, xbc, dt_raw = _in_proj(cfg, p, u)
    xbc = _causal_conv(xbc, p.conv_w.to(u.dtype), p.conv_b.to(u.dtype))
    y, final_state = _ssm(cfg, p, xbc, dt_raw, u.dtype, initial_state=initial_state)
    return _out_proj(p, y, z, u.dtype), final_state


def _mixer_on_mesh(cfg, p: Mamba, u: DTensor, *, initial_state=None, return_state=False):
    """The mixer on a mesh, sequence-parallel over "model" as the reference's
    partitioned program runs it (the SSD's chunk axis over "seq"): each rank
    projects its own tokens; the causal conv takes its K-1-row halo from the
    previous "model" rank; the SSD runs the rank's chunks from a zero state,
    and an all-gather of each rank's (final state, total decay) gives the
    state entering the rank's block (``initial_state`` decayed through the
    earlier ranks plus their states). Where the rank's block is not a whole
    number of chunks (the reference's ``constrain`` then leaves the chunk axis
    unsharded) the conv and the SSD run on the gathered sequence and each rank
    keeps its block. Weights are whole (the reference keeps them replicated
    over "model"); the final state comes out replicated over "model"."""
    mesh = u.device_mesh
    split = model_split(u)
    pm = whole_module(p, u)
    batch_pl = [pl if pl.is_shard(0) else Replicate() for pl in u.placements]
    s0 = initial_state
    if isinstance(s0, DTensor):
        s0 = constrain(s0, "batch", None, None, None)
        # Each "model" rank takes it into its own block's states.
        s0 = s0.to_local(grad_placements=[Partial() if split and i == model_index(mesh) else pl
                                          for i, pl in enumerate(s0.placements)])
    k = cfg.ssm_conv
    with restored(None):
        z, xbc, dt_raw = _in_proj(cfg, pm, u.to_local())
        t_loc = xbc.shape[1]
        chunk = min(cfg.ssm_chunk, u.shape[1])
        w, b = pm.conv_w.to(u.dtype), pm.conv_b.to(u.dtype)
        if split is not None and t_loc % chunk == 0 and t_loc >= k - 1:
            rank, ranks = split
            tails = over_model(xbc[None, :, t_loc - (k - 1):], mesh, Shard(0), Replicate())
            halo = tails[rank - 1] * float(rank > 0)     # rank 0: zeros
            xbc = _causal_conv(xbc, w, b, halo)

            def enter(state, decay):
                # Every rank's (state from zero, total decay), then the state
                # entering each rank: s_{r+1} = s_r · decay_r + state_r.
                bsz, h, hp, n = state.shape
                both = torch.cat([state.reshape(bsz, h, hp * n), decay[..., None]], dim=-1)
                every = over_model(both[None], mesh, Shard(0), Replicate())
                # Every rank takes each rank's term, masked (so that each
                # rank's backward pass runs the all-gather's, as collectives
                # must), and keeps its own.
                s = s0.float() if s0 is not None else torch.zeros_like(state)
                mine = torch.zeros_like(state)
                for r in range(ranks):
                    mine = mine + s * float(r == rank)
                    s = s * every[r, ..., -1, None, None] + every[r, ..., :-1].reshape(state.shape)
                return mine
            y, final_state = _ssm(cfg, pm, xbc, dt_raw, u.dtype, enter=enter)
        else:
            if split is not None:   # the gathered sequence; each rank keeps its block
                xbc = over_model(xbc, mesh, Shard(1), Replicate())
                dt_raw = over_model(dt_raw, mesh, Shard(1), Replicate())
            xbc = _causal_conv(xbc, w, b)
            y, final_state = _ssm(cfg, pm, xbc, dt_raw, u.dtype, initial_state=s0)
            if split is not None:
                y = y[:, split[0] * t_loc:(split[0] + 1) * t_loc]
        out = DTensor.from_local(_out_proj(pm, y, z, u.dtype), mesh, u.placements,
                                 run_check=False)
    if not return_state:
        return out
    if split is None:
        return out, DTensor.from_local(final_state, mesh, batch_pl, run_check=False)
    # The last rank's final state is the sequence's; the others add zeros.
    last = final_state * float(split[0] == split[1] - 1)
    pl = [Partial() if i == model_index(mesh) else q for i, q in enumerate(batch_pl)]
    return out, DTensor.from_local(last, mesh, pl, run_check=False).redistribute(mesh, batch_pl)


def init_mamba_cache(cfg, batch: int, dtype, device=None) -> dict:
    d_in, h, n, conv_ch = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype, device=device),
        "ssd": torch.zeros((batch, h, cfg.ssm_head_dim, n), dtype=torch.float32, device=device),
    }


def apply_mamba_decode(cfg, p: Mamba, u1: torch.Tensor, cache: dict):
    """One-token decode. u1: (B, 1, d_model) → (B, 1, d_model), new cache
    (new tensors; the caller stores them)."""
    bsz = u1.shape[0]
    d_in, h, n, conv_ch = _dims(cfg)
    proj = torch.einsum("btd,de->bte", u1, p.in_proj.to(u1.dtype))
    z, xc, bm, cm, dt_raw = _split_in(cfg, proj)
    xbc_t = torch.cat([xc, bm, cm], dim=-1)[:, 0]                 # (B, CH)

    # Rolling conv window: [cache (K-1), current] → conv output at t.
    win = torch.cat([cache["conv"], xbc_t[:, None, :]], dim=1)    # (B,K,CH)
    w = p.conv_w.to(u1.dtype)
    conv_out = torch.einsum("bkc,kc->bc", win, w) + p.conv_b.to(u1.dtype)
    conv_out = F.silu(conv_out)
    new_conv = win[:, 1:, :]

    xc1, bm1, cm1 = torch.split(conv_out, [d_in, n, n], dim=-1)
    x1 = xc1.reshape(bsz, h, cfg.ssm_head_dim)
    dt1 = _softplus(dt_raw[:, 0].float() + p.dt_bias)
    a = -torch.exp(p.A_log)
    y1, new_ssd = ssd_decode_step(cache["ssd"], x1, dt1, a, bm1.float(), cm1.float())
    y1 = y1 + x1 * p.D[None, :, None].to(x1.dtype)
    y1 = y1.reshape(bsz, 1, d_in)
    y1 = _gated_rmsnorm(y1, z, p.gate_norm, u1.dtype)
    out = torch.einsum("bte,ed->btd", y1, p.out_proj.to(u1.dtype))
    return out, {"conv": new_conv, "ssd": new_ssd}


def mamba_decode_(cfg, p: Mamba, u1: torch.Tensor, cache: dict) -> torch.Tensor:
    """:func:`apply_mamba_decode` that writes the new conv window and SSD
    state into ``cache`` in place and returns the output. On a mesh (``u1``
    a DTensor) each rank steps its batch rows, held with the same batch
    sharding in ``u1`` and the cache, with the whole weights."""
    if not isinstance(u1, DTensor):
        out, st = apply_mamba_decode(cfg, p, u1, cache)
        cache["conv"].copy_(st["conv"])
        cache["ssd"].copy_(st["ssd"])
        return out
    u1 = constrain(u1, "batch", None, None)
    local = {}
    for name in ("conv", "ssd"):
        if tuple(cache[name].placements) != tuple(u1.placements):
            raise ValueError(f"the {name} cache's batch rows {cache[name].placements} are "
                             f"not the input's {u1.placements}")
        local[name] = cache[name].to_local()
    with restored(None):
        out, st = apply_mamba_decode(cfg, whole_module(p, u1), u1.to_local(), local)
        local["conv"].copy_(st["conv"])
        local["ssd"].copy_(st["ssd"])
    return DTensor.from_local(out, u1.device_mesh, u1.placements, run_check=False)
