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

import math
from types import SimpleNamespace

import torch
import torch.utils.checkpoint
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.sharding import logical
from repro_torch.sharding.partition import MODEL_AXIS

__all__ = ["cast_tree", "dense_init_", "dtype_of", "embed_init_", "init_module",
           "local_weight", "model_index", "model_shard_dim", "model_split", "over_model",
           "param_bytes", "param_count", "remat_call", "tree_paths", "weight_einsum",
           "weight_local", "whole_module", "whole_weight"]


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


def model_index(mesh) -> int | None:
    """The index of ``mesh``'s "model" dim when it has one of more than one rank."""
    names = tuple(mesh.mesh_dim_names or ())
    if MODEL_AXIS not in names or mesh.size(names.index(MODEL_AXIS)) == 1:
        return None
    return names.index(MODEL_AXIS)


def model_split(x: DTensor) -> tuple[int, int] | None:
    """``(rank, ranks)`` over ``x``'s mesh dim "model" when ``x``'s sequence
    (dim 1) is sharded over it, each rank holding one block in rank order;
    None when every "model" rank holds the whole sequence (a sequence that
    does not divide, a decode token, or no "model" dim of more than one rank)."""
    mesh = x.device_mesh
    i = model_index(mesh)
    if i is None or not x.placements[i].is_shard(1):
        return None
    return mesh.get_local_rank(i), mesh.size(i)


def model_shard_dim(w: torch.Tensor) -> int | None:
    """The dim of the weight ``w`` that its placement shards over "model", or None."""
    if not isinstance(w, DTensor):
        return None
    i = model_index(w.device_mesh)
    return None if i is None or not w.placements[i].is_shard() else w.placements[i].dim


def over_model(t: torch.Tensor, mesh, src, dst, grad=None) -> torch.Tensor:
    """A collective over ``mesh``'s "model" dim on a plain tensor: ``t``, this
    rank's piece of a tensor placed ``src`` over "model", redistributed to
    ``dst``; this rank's piece of the result as a plain tensor (Shard → Replicate
    is an all-gather, Partial → Replicate an all-reduce, Partial → Shard a
    reduce-scatter, Replicate → Shard a local slice). It is DTensor's own
    redistribution, so autograd carries it and ``launch.cost`` counts it.
    ``grad`` is the placement of the result's gradient: by default ``dst``,
    except that a replicated result is taken as ``Partial``, each rank using its
    copy for its own share of the work; pass ``Replicate()`` where every rank
    computes the same thing from it."""
    sub = mesh[MODEL_AXIS]
    if grad is None:
        grad = Partial() if dst.is_replicate() else dst
    return DTensor.from_local(t, sub, [src], run_check=False).redistribute(
        sub, [dst]).to_local(grad_placements=[grad])


def local_weight(w: torch.Tensor, x: DTensor) -> torch.Tensor:
    """This rank's "model" shard of the weight ``w`` (the reference's spec
    places it), gathered over every other mesh dim (FSDP's "data"), as a plain
    tensor for computing on the rank's shard of ``x``. A weight not sharded
    over "model" comes whole (:func:`whole_weight`). The gradient keeps the
    shard over "model" and is a sum over the ranks that hold other shards of
    ``x`` elsewhere."""
    mesh = x.device_mesh
    i = model_index(mesh)
    if model_shard_dim(w) is None:
        return whole_weight(w, x)
    keep = [w.placements[m] if m == i else Replicate() for m in range(mesh.ndim)]
    grad = [w.placements[m] if m == i else Partial() if pl.is_shard() else Replicate()
            for m, pl in enumerate(x.placements)]
    return w.redistribute(mesh, keep).to_local(grad_placements=grad)


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
