"""Logical-axis sharding constraints inside model code.

The port's counterpart of ``repro.sharding.logical``. Model code calls
``constrain(x, "batch", "seq", None)`` with LOGICAL axis names at the same
points as the reference; a launcher activates a mapping to physical mesh
axes for the duration of a step:

    with logical_axis_rules(mesh, default_rules(mesh)), implicit_replication():
        loss, _ = api.loss(model, batch)

Outside such a context (the CPU tests, ``Engine`` on one card)
``constrain`` is the identity, so the model stays mesh-agnostic. Inside one
it redistributes a DTensor to the placements its logical axes map to on the
context's ``DeviceMesh`` (the counterpart of ``with_sharding_constraint``),
and takes a plain tensor as replicated on that mesh first.

Plain tensors that meet DTensors elsewhere in the model (``positions``, the
rotary tables, the ``aux`` and optimizer scalars, the padded-vocab mask) are
handled by ``torch.distributed.tensor.experimental.implicit_replication()``
around the whole step (``train.loop.on_mesh``), not by a wrap at each site:
each such tensor is built from a DTensor's ``.shape``, which is global, so
it holds the same global value on every rank, which is what implicit
replication assumes; and the model code stays as it is off a mesh, where a
wrap at each site would have to branch on whether a mesh is active. Code
that runs on each rank's local shards (the attention core, the weight
einsums) suspends the rules with ``restored(None)``.
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.sharding.partition import axis_size

_tls = threading.local()

__all__ = ["active", "constrain", "current", "default_rules", "logical_axis_rules", "restored"]


def default_rules(mesh) -> dict:
    batch = ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)
    return {
        "batch": batch,
        "seq": "model",       # context parallelism: Q-sequence over model
        "heads": None,        # heads_tp layout flips seq→None, heads→model
        "kv_seq": "model",    # decode KV cache sequence (flash-decoding)
        "ff": "model",
        "vocab": "model",
        "experts": "model",   # expert-parallel MoE buffers
        "tokens": batch + ("model",),  # flattened B·T token dim (MoE dispatch)
        "fsdp": "data",
    }


@contextlib.contextmanager
def logical_axis_rules(mesh, rules: dict | None = None):
    """Activate ``rules`` (logical name → mesh axes; default
    :func:`default_rules`) on the ``DeviceMesh`` ``mesh`` for the calling
    thread."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = (mesh, rules or default_rules(mesh))
    try:
        yield
    finally:
        _tls.ctx = prev


def active() -> bool:
    return getattr(_tls, "ctx", None) is not None


def current():
    """The calling thread's ``(mesh, rules)``, or None outside a context."""
    return getattr(_tls, "ctx", None)


@contextlib.contextmanager
def restored(ctx):
    """Run with ``ctx`` (a :func:`current` value; None suspends the rules,
    for code that runs on each rank's local shards)."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    try:
        yield
    finally:
        _tls.ctx = prev


def _placements_for(mesh, rules: dict, shape, axes) -> tuple:
    """DTensor placements of a tensor of ``shape`` whose dims carry the
    logical ``axes``: a dim that does not divide by its mapped mesh axes
    stays unsharded (the reference's rule, e.g. batch 1, a short decode
    token dim)."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    owner: dict[str, str] = {}
    for dim, a in enumerate(axes):
        phys = rules.get(a) if a is not None else None
        if phys is None or shape[dim] % axis_size(mesh, phys):
            continue
        for name in phys if isinstance(phys, tuple) else (phys,):
            if name in owner:
                raise ValueError(f"constrain{tuple(axes)}: mesh axis {name!r} maps both "
                                 f"{owner[name]!r} and {a!r}")
            owner[name] = a
            out[names.index(name)] = Shard(dim)
    return tuple(out)


def constrain(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """Constrain ``x``'s sharding by logical axis names (None = unsharded
    dim). The identity outside a ``logical_axis_rules`` context; inside
    one, a DTensor redistributed to the placements ``axes`` map to (a plain
    tensor is taken as replicated on the context's mesh first)."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        return x
    mesh, rules = ctx
    if len(axes) != x.ndim:
        raise ValueError(f"constrain: {len(axes)} axes for ndim {x.ndim}")
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    want = _placements_for(mesh, rules, x.shape, axes)
    return x if tuple(x.placements) == want else x.redistribute(mesh, want)
