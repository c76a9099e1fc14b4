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
from torch.distributed.tensor import DTensor

from repro_torch.models.common import (
    dense_init_,
    dtype_of,
    on_batch_shards,
    weight_einsum,
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


def ssd_chunked(x, dt, a, b_mat, c_mat, *, chunk: int, initial_state=None):
    """Returns (y (B,T,H,P), final_state (B,H,P,N))."""
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
    state = (initial_state.float() if initial_state is not None
             else torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device))
    state = constrain(state, "batch", None, None, None)
    prev = []
    for i in range(c):
        prev.append(state)
        state = state * chunk_decay[:, :, i, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)                       # (B,C,H,P,N)

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


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time. xbc (B,T,CH); w (K,CH)."""
    k = w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
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
    return _mixer(cfg, p, u, initial_state=initial_state, return_state=return_state)


# On a mesh the mixer runs on each rank's batch shard with the whole
# sequence and the whole weights; the initial state comes in and the final
# state goes out with the same batch sharding. The causal conv and the
# chunked scan run along the sequence, and torch 2.11's DTensor cannot pad a
# sharded sequence (``aten.constant_pad_nd``).
@on_batch_shards
def _mixer(cfg, p: Mamba, u: torch.Tensor, *, initial_state=None, return_state=False):
    bsz, t, _ = u.shape
    d_in, h, n, conv_ch = _dims(cfg)
    proj = weight_einsum("btd,de->bte", u, p.in_proj.to(u.dtype))
    z, xc, bm, cm, dt_raw = _split_in(cfg, proj)

    xbc = _causal_conv(torch.cat([xc, bm, cm], dim=-1), p.conv_w.to(u.dtype),
                       p.conv_b.to(u.dtype))
    xbc = F.silu(xbc)
    xc, bm, cm = torch.split(xbc, [d_in, n, n], dim=-1)

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
                                 initial_state=initial_state)
    if pad:
        y = y[:, :t]
        x = x[:, :t]
    y = y + x * p.D[None, None, :, None].to(x.dtype)
    y = y.reshape(bsz, t, d_in)
    y = _gated_rmsnorm(y, z, p.gate_norm, u.dtype)
    out = weight_einsum("bte,ed->btd", y, p.out_proj.to(u.dtype))
    if return_state:
        return out, final_state
    return out


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
