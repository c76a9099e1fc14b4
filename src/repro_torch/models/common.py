"""Shared model utilities: initializers, dtype policy, parameter tooling.

The port's counterpart of ``repro.models.common``. Parameters live in
``nn.Module``s whose attribute names are the reference's dict keys, each
tensor in the reference's own layout (``wq`` is ``(d, h, dh)``), so a
reference path ``group_0/attn/wq`` is the port's ``group_0.<layer>.attn.wq``
(``models/convert.py``). Randomness comes from one explicit
``torch.Generator`` consumed in module-registration order (the counterpart
of the reference's ``split_keys``): initial values differ from JAX's random
bits, so parity goes through the converter, never through ``init``.
"""

from __future__ import annotations

import functools
import math
from types import SimpleNamespace

import torch
import torch.utils.checkpoint
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.sharding import logical

__all__ = ["cast_tree", "dense_init_", "dtype_of", "embed_init_", "init_module",
           "on_batch_shards", "param_bytes", "param_count", "remat_call", "tree_paths",
           "weight_einsum", "weight_local", "whole_module", "whole_weight"]


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def _truncated_normal(t: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], drawn in float32 on ``t``'s device."""
    out = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    return nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=gen)


@torch.no_grad()
def dense_init_(t: torch.Tensor, gen: torch.Generator, in_axis: int = 0) -> torch.Tensor:
    """Truncated-normal fan-in initialization (std = 1/sqrt(fan_in)), in place."""
    std = 1.0 / math.sqrt(t.shape[in_axis])
    return t.copy_(_truncated_normal(t, gen).mul_(std))


@torch.no_grad()
def embed_init_(t: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    return t.copy_(_truncated_normal(t, gen).mul_(0.02))


def init_module(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Fill every random parameter of ``module``: each submodule's
    ``_init(gen)``, in registration order. Deterministic parameters (norm
    scales, biases, SSM decay rates) are set where the module is built."""
    for m in module.modules():
        fn = getattr(m, "_init", None)
        if fn is not None:
            fn(gen)
    return module


def remat_call(enabled: bool, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, recomputed in the backward pass instead of
    keeping its activations when ``enabled`` and autograd is recording: the
    port's counterpart of the reference's ``jax.checkpoint``. Prefill and
    decode (no grad) call ``fn`` as it is. The recomputation runs under the
    logical-axis rules of the forward call: the backward pass of CUDA
    tensors runs on autograd's device thread, which does not see the
    calling thread's rules."""
    if enabled and torch.is_grad_enabled():
        ctx = logical.current()

        def body(*a, **kw):
            with logical.restored(ctx):
                return fn(*a, **kw)
        return torch.utils.checkpoint.checkpoint(body, *args, use_reentrant=False, **kwargs)
    return fn(*args, **kwargs)


def param_count(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


def param_bytes(params: nn.Module) -> int:
    return sum(p.numel() * p.element_size() for p in params.parameters())


def tree_paths(params: nn.Module) -> list[tuple[str, torch.Tensor]]:
    """Flatten to ("a/b/c", tensor) pairs, the reference's path form (a
    per-layer module keeps its index: ``group_0/3/attn/wq``)."""
    return [(k.replace(".", "/"), v) for k, v in params.state_dict().items()]


@torch.no_grad()
def cast_tree(params: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every floating parameter to ``dtype`` in place."""
    for p in params.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    return params


def _subscripts(eq: str, ndims: tuple[int, ...]) -> tuple[list[str], str]:
    """The operands' subscripts and the output's, "..." spelled out."""
    ins, out = eq.replace(" ", "").split("->")
    ins = ins.split(",")
    spare = [c for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZ" if c not in eq]
    ell = "".join(spare[:max(n - len(x.replace("...", "")) for x, n in zip(ins, ndims))])
    ins = [x.replace("...", ell[len(ell) - (n - len(x.replace("...", ""))):]) if "..." in x
           else x for x, n in zip(ins, ndims)]
    return ins, out.replace("...", ell)


def whole_weight(w: torch.Tensor, x: DTensor) -> torch.Tensor:
    """The whole weight ``w`` (gathered) as a plain tensor on each rank of
    ``x``'s mesh, for computing on the rank's shard of ``x``. Its gradient
    is the sum over the ranks that hold other shards of ``x`` (``Partial``
    on the mesh dims ``x`` is sharded over), as DTensor's own operators
    would give it."""
    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim
    w = (w.redistribute(mesh, rep) if isinstance(w, DTensor)
         else DTensor.from_local(w, mesh, rep, run_check=False))
    return w.to_local(grad_placements=[Partial() if pl.is_shard() else Replicate()
                                       for pl in x.placements])


def whole_module(module: nn.Module, x: DTensor) -> SimpleNamespace:
    """``module``'s parameters as :func:`whole_weight` tensors under the same
    attribute names (its submodules likewise), for running a layer's plain
    code on the rank's shard of ``x``."""
    ns = SimpleNamespace(**{n: whole_weight(w, x)
                            for n, w in module.named_parameters(recurse=False)})
    for n, child in module.named_children():
        setattr(ns, n, whole_module(child, x))
    return ns


def on_batch_shards(apply):
    """A layer ``apply(cfg, p, x, **kw)`` that, on a mesh (``x`` a DTensor),
    runs on each rank's batch shard with the whole sequence (``x`` constrained
    to ("batch", None, None)) and the whole weights (:func:`whole_module`),
    the rules suspended (a DTensor keyword argument, such as an initial
    state, likewise takes its batch rows). Each output with dims takes
    ``x``'s placements; a 0-dim output, a mean over batch rows, becomes the
    rank's local mean over the number of batch shards, ``Partial`` over
    them. Off a mesh it is ``apply``."""
    @functools.wraps(apply)
    def wrapped(cfg, p, x, **kw):
        if not isinstance(x, DTensor):
            return apply(cfg, p, x, **kw)
        x = logical.constrain(x, "batch", None, None)
        # A DTensor keyword (the mixer's initial state) takes x's batch rows.
        kw = {k: logical.constrain(v, "batch", *(None,) * (v.ndim - 1)).to_local()
              if isinstance(v, DTensor) else v for k, v in kw.items()}
        with logical.restored(None):
            out = apply(cfg, whole_module(p, x), x.to_local(), **kw)
        mesh = x.device_mesh
        shards = math.prod(mesh.size(m) for m, pl in enumerate(x.placements) if pl.is_shard())
        mean = [Partial() if pl.is_shard() else Replicate() for pl in x.placements]

        def place(t):
            if t.ndim == 0:
                return DTensor.from_local(t / shards, mesh, mean, run_check=False)
            return DTensor.from_local(t, mesh, x.placements, run_check=False)
        return tuple(map(place, out)) if isinstance(out, tuple) else place(out)
    return wrapped


def weight_local(fn, x: DTensor, w: torch.Tensor, placements) -> DTensor:
    """``fn(x, w)`` on a mesh, computed on each rank's shard of ``x`` with
    the whole weight (:func:`whole_weight`), the result placed by
    ``placements`` (``x``'s shards mapped onto the result's dims)."""
    return DTensor.from_local(fn(x.to_local(), whole_weight(w, x)), x.device_mesh, placements,
                              run_check=False)


def weight_einsum(eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, x, w)`` of an activation ``x`` and a weight ``w``.

    Off a mesh it is that einsum. On a mesh (``x`` a DTensor, no dim it
    contracts sharded) it runs through :func:`weight_local` and keeps
    ``x``'s sharding: DTensor's einsum folds the batch and sequence dims
    into one, and torch 2.11's DTensor cannot view two dims sharded over
    different mesh dims (batch over "data", sequence over "model") as one."""
    if not isinstance(x, DTensor):
        return torch.einsum(eq, x, w)
    (xs, _), out = _subscripts(eq, (x.ndim, w.ndim))
    placements = []
    for pl in x.placements:
        if pl.is_partial() or (pl.is_shard() and xs[pl.dim] not in out):
            return torch.einsum(eq, x, w)
        placements.append(Shard(out.index(xs[pl.dim])) if pl.is_shard() else Replicate())
    return weight_local(lambda a, b: torch.einsum(eq, a, b), x, w, placements)
