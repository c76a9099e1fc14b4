"""Logical-axis sharding constraints inside model code.

The port's counterpart of ``repro.sharding.logical``, reduced to what the
model code calls. Model code calls ``constrain(x, "batch", "seq", None)``
with LOGICAL axis names at the same points as the reference; a launcher
activates a mapping to physical mesh axes for the duration of a step:

    with logical_axis_rules(mesh, rules):
        ...

Outside such a context (the CPU tests, ``Engine`` on one card)
``constrain`` is the identity, so the model stays mesh-agnostic. Inside one
it raises ``NotImplementedError``: mapping logical axes onto a device mesh
(DTensor placements) is the training slice's work (ROADMAP item 18b), and a
silent no-op under a mesh would hide that nothing is sharded.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_tls = threading.local()

__all__ = ["active", "constrain", "logical_axis_rules"]


@contextlib.contextmanager
def logical_axis_rules(mesh, rules: dict | None = None):
    """Activate ``rules`` (logical name → mesh axes) on ``mesh`` for the
    calling thread."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = (mesh, rules or {})
    try:
        yield
    finally:
        _tls.ctx = prev


def active() -> bool:
    return getattr(_tls, "ctx", None) is not None


def constrain(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """Constrain ``x``'s sharding by logical axis names (None = unsharded
    dim). The identity outside a ``logical_axis_rules`` context."""
    if getattr(_tls, "ctx", None) is None:
        return x
    raise NotImplementedError(
        f"constrain{tuple(axes)} under a logical_axis_rules context: logical-axis "
        "sharding on a mesh is not ported yet (ROADMAP item 18b, training)"
    )
