"""Optimizers (homegrown, not ``torch.optim``): AdamW and Adafactor, plus
gradient clipping and LR schedules.

The port's counterpart of ``repro.train.optimizer``: the same public names,
the reference's formulas in its order, in float32, with the schedule and the
bias corrections float32 tensors of the step. ``torch.optim.AdamW`` is not
used: it orders the bias correction and the decay differently (so rounds
differently) and has no Adafactor with these rules.

**The reference's leaf view.** The reference updates each leaf of its
parameter tree, and its layer groups are stacked on a leading axis
(``group_{i}/ln1/scale`` is ``(C, d)``); the port keeps one module per layer.
Several rules read the stacked leaf: weight decay applies to leaves of rank
>= 2 (so a stacked norm scale is decayed), Adafactor factors its second
moment over the last two axes of the leaf (a stacked ``(C, d)`` norm scale
is factored across layers) and clips the RMS of the whole leaf's update, and
leaves over ``_CHUNKED_UPDATE_BYTES`` are updated layer by layer. So the
update runs over the reference's leaves, never the per-layer tensors: the
per-layer parameters of a group are gathered under their reference path
(``models.convert.reference_groups``), stacked for the update, and the
results written back in place. That grouping is what keeps the two packages
equal. hymba's single-layer groups are ``(1, d)``: decayed, not factored.

Parameters are an ``nn.Module`` (the models; ``grads`` then maps parameter
names to tensors, or is ``None`` for the parameters' ``.grad``) or a nested
dict of tensors (``grads`` of the same structure). Optimizer state is a dict
in the reference's layout — ``{"step", "mu", "nu"}`` / ``{"step", "v"}``,
moments as nested dicts keyed by the reference's paths, stacked leaves
stacked — so it equals the reference's state leaf for leaf and checkpoints
in its layout. ``*_update(cfg, grads, state, params)`` updates the
parameters and the state **in place** (under ``torch.no_grad``), the port's
counterpart of the reference's donated buffers, and returns
``(params, state, {"grad_norm", "lr"})``.

Scalars enter the math as float32 tensors on the parameters' device, never
as python divisors: ``scalar / tensor`` multiplies by a reciprocal in
PyTorch, and on the card so does ``tensor / scalar``.

**On a mesh** (``train.loop.train(..., mesh=)``) the parameters are DTensors
and the state is placed by ``sharding.partition.optimizer_state_specs``
over the same leaf view; the update runs under
``implicit_replication()``. A gradient comes back ``Partial`` where its
parameter is replicated over a mesh dim the activations are sharded over;
:meth:`_Leaf.grad` reduces it once, to its parameter's placements, before
the norm and the update read it, so the global norm is the norm of the
summed gradient and never a sum over local shards.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.models.convert import flatten_paths, is_stacked, nest_paths, reference_groups

__all__ = ["AdafactorConfig", "AdamWConfig", "adafactor_init", "adafactor_update",
           "adamw_init", "adamw_update", "clip_by_global_norm", "cosine_schedule",
           "global_norm", "make_optimizer"]

Params = Any


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1) -> Callable[[torch.Tensor], torch.Tensor]:
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        dev = step.device
        warm = base_lr * torch.minimum(step / _f32(max(warmup, 1), dev), _f32(1.0, dev))
        prog = torch.clamp((step - warmup) / _f32(max(total - warmup, 1), dev), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr


# ---------------------------------------------------------------------------
# The leaf view
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Leaf:
    """One reference leaf: its path, the tensors that make it (one per layer
    when ``stacked``) and their gradients."""

    path: str
    params: list[torch.Tensor]
    grads: list[torch.Tensor | None]
    stacked: bool

    def value(self) -> torch.Tensor:
        return torch.stack(self.params) if self.stacked else self.params[0]

    def grad(self) -> torch.Tensor:
        gs = [torch.zeros_like(p) if g is None else _placed_like(g, p)
              for g, p in zip(self.grads, self.params)]
        return torch.stack(gs) if self.stacked else gs[0]

    @property
    def shape(self) -> tuple[int, ...]:
        lead = (len(self.params),) if self.stacked else ()
        return lead + tuple(self.params[0].shape)

    def write(self, new: torch.Tensor) -> None:
        for p, part in zip(self.params, new.unbind(0) if self.stacked else (new,)):
            p.copy_(part)


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient on its parameter's placements (a ``Partial`` one
    summed over the ranks that hold it)."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _leaves(params: Params, grads=None) -> list[_Leaf]:
    if isinstance(params, nn.Module):
        out = []
        for path, named in reference_groups(params).items():
            gs = [p.grad if grads is None else grads.get(name) for name, p in named]
            out.append(_Leaf(path, [p for _, p in named], gs, is_stacked(path)))
        return out
    gflat = dict(flatten_paths(grads)) if grads is not None else {}
    return [_Leaf(path, [p], [gflat.get(path)], False) for path, p in flatten_paths(params)]


def _at(tree: dict, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _device(leaves: list[_Leaf]) -> torch.device:
    return leaves[0].params[0].device


def _norm(gs: list[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(g.to(torch.float32))) for g in gs])))


def _norm_and_clip(gs: list[torch.Tensor], max_norm: float):
    norm = _norm(gs)
    scale = torch.minimum(_f32(1.0, norm.device),
                          _f32(max_norm, norm.device) / torch.clamp(norm, min=1e-9))
    return [(g.to(torch.float32) * scale).to(g.dtype) for g in gs], norm


def global_norm(tree) -> torch.Tensor:
    """The float32 L2 norm over every leaf of a (nested dict) tree."""
    return _norm([g for _, g in flatten_paths(tree)])


def clip_by_global_norm(grads, max_norm: float):
    """``(clipped tree, norm)``: every leaf scaled by min(1, max_norm / norm)."""
    flat = dict(flatten_paths(grads))
    clipped, norm = _norm_and_clip(list(flat.values()), max_norm)
    return nest_paths(dict(zip(flat, clipped))), norm


def _lr(lr, step: torch.Tensor) -> torch.Tensor:
    return lr(step) if callable(lr) else _f32(lr, step.device)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0


def adamw_init(params: Params) -> dict:
    leaves = _leaves(params)
    dev = _device(leaves)
    zeros = lambda leaf: torch.zeros(leaf.shape, dtype=torch.float32, device=dev)  # noqa: E731
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "mu": nest_paths({leaf.path: zeros(leaf) for leaf in leaves}),
        "nu": nest_paths({leaf.path: zeros(leaf) for leaf in leaves}),
    }


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state: dict, params: Params):
    leaves = _leaves(params, grads)
    gs, gnorm = _norm_and_clip([leaf.grad() for leaf in leaves], cfg.max_grad_norm)
    step = state["step"] + 1
    lr = _lr(cfg.lr, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(_f32(b1, step.device), stepf)
    bc2 = 1 - torch.pow(_f32(b2, step.device), stepf)
    eps = _f32(cfg.eps, step.device)
    for leaf, g in zip(leaves, gs):
        m_t, v_t = _at(state["mu"], leaf.path), _at(state["nu"], leaf.path)
        p = leaf.value()
        gf = g.to(torch.float32)
        m = b1 * m_t + (1 - b1) * gf
        v = b2 * v_t + (1 - b2) * gf * gf
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + eps)
        if cfg.weight_decay and p.ndim >= 2:  # decay matrices, not norms/bias
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        leaf.write((p.to(torch.float32) - lr * delta).to(p.dtype))
        m_t.copy_(m)
        v_t.copy_(v)
    state["step"].copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no momentum — Shazeer & Stern 2018)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 1e-3
    decay: float = 0.8           # \hat{\beta}_2 exponent: 1 - step^-decay
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


# Stacked leaves above this size are updated layer by layer, as the
# reference's lax.map over the leading axis: the factoring, the RMS clip and
# the decay then see one layer's slice.
_CHUNKED_UPDATE_BYTES = 256 << 20


def _chunk_leading(shape) -> bool:
    return len(shape) >= 3 and shape[0] > 1 and math.prod(shape) * 4 > _CHUNKED_UPDATE_BYTES


def adafactor_init(params: Params) -> dict:
    leaves = _leaves(params)
    dev = _device(leaves)
    zeros = lambda shape: torch.zeros(shape, dtype=torch.float32, device=dev)  # noqa: E731

    def st(shape):
        if _factored(shape):
            return {"vr": zeros(shape[:-1]),                  # row stats
                    "vc": zeros(shape[:-2] + shape[-1:])}     # col stats
        return {"v": zeros(shape)}

    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "v": nest_paths({leaf.path: st(leaf.shape) for leaf in leaves})}


def _adafactor_leaf(cfg: AdafactorConfig, g, v: dict, p, beta2, lr):
    """One leaf's update → (new param, new state), the reference's formulas."""
    dev = g.device
    eps = _f32(cfg.eps, dev)
    gf = g.to(torch.float32)
    g2 = gf * gf + eps
    if _factored(p.shape):
        vr = beta2 * v["vr"] + (1 - beta2) * g2.mean(dim=-1)
        vc = beta2 * v["vc"] + (1 - beta2) * g2.mean(dim=-2)
        # rank-1 reconstruction of the preconditioner
        r = vr / torch.maximum(vr.mean(dim=-1, keepdim=True), eps)
        upd = gf * torch.rsqrt(r)[..., None] * torch.rsqrt(torch.maximum(vc, eps))[..., None, :]
        new_v = {"vr": vr, "vc": vc}
    else:
        vv = beta2 * v["v"] + (1 - beta2) * g2
        upd = gf * torch.rsqrt(torch.maximum(vv, eps))
        new_v = {"v": vv}
    # update clipping (RMS <= clip_threshold)
    rms = torch.sqrt(torch.mean(torch.square(upd)) + _f32(1e-30, dev))
    upd = upd / torch.maximum(_f32(1.0, dev), rms / _f32(cfg.clip_threshold, dev))
    if cfg.weight_decay and p.ndim >= 2:
        upd = upd + cfg.weight_decay * p.to(torch.float32)
    return (p.to(torch.float32) - lr * upd).to(p.dtype), new_v


@torch.no_grad()
def adafactor_update(cfg: AdafactorConfig, grads, state: dict, params: Params):
    leaves = _leaves(params, grads)
    gs, gnorm = _norm_and_clip([leaf.grad() for leaf in leaves], cfg.max_grad_norm)
    step = state["step"] + 1
    lr = _lr(cfg.lr, step)
    beta2 = 1.0 - torch.pow(step.to(torch.float32), _f32(-cfg.decay, step.device))
    for leaf, g in zip(leaves, gs):
        v = _at(state["v"], leaf.path)
        p = leaf.value()
        if _chunk_leading(leaf.shape):
            new_p = torch.empty_like(p)
            for j in range(p.shape[0]):
                new_p[j], vj = _adafactor_leaf(cfg, g[j], {k: t[j] for k, t in v.items()},
                                               p[j], beta2, lr)
                for k, t in vj.items():
                    v[k][j].copy_(t)
        else:
            new_p, nv = _adafactor_leaf(cfg, g, v, p, beta2, lr)
            for k, t in nv.items():
                v[k].copy_(t)
        leaf.write(new_p)
    state["step"].copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# Unified facade
# ---------------------------------------------------------------------------


def make_optimizer(name: str, lr=None, total_steps: int = 10000):
    sched = cosine_schedule(lr or (3e-4 if name == "adamw" else 1e-3),
                            warmup=min(500, total_steps // 10 + 1),
                            total=total_steps)
    if name == "adamw":
        return AdamWConfig(lr=sched), adamw_init, adamw_update
    if name == "adafactor":
        return AdafactorConfig(lr=sched), adafactor_init, adafactor_update
    raise ValueError(f"unknown optimizer {name!r}")
