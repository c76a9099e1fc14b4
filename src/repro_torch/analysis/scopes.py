"""Named scopes of a plan's run, for the plan-contract analyzer.

The reference lints a traced jaxpr, in which two boundaries are visible as
primitives: ``pallas_call`` (a kernel body, which lives in VMEM and
registers) and ``pure_callback`` (a round trip through the host). A PyTorch
plan is eager and launches its kernels through ``ctypes``, so the analyzer
records a run instead (:mod:`repro_torch.analysis.op_lint`), and the code
marks those boundaries itself with :func:`scope`:

* ``kernel:<name>`` — around each plain version a kernel wrapper computes
  on a CPU tensor in place of its kernel (the ``pallas_call`` boundary);
* ``host`` — around the host-native backend's NumPy round trip
  (``pure_callback``);
* ``tail`` — around the Haralick features of a plan's tail, which the port
  computes in float64 on purpose.

This module imports only the standard library: the core and kernel modules
import it, so it must not import the rest of :mod:`repro_torch.analysis`.
When no recording is active on the calling thread, :func:`scope` costs one
thread-local lookup and returns a shared no-op context.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

__all__ = ["Recording", "recording", "scope"]

_LOCAL = threading.local()
_NULL = contextlib.nullcontext()


@dataclasses.dataclass
class Recording:
    """The scope state of one recorded run on one thread: the open scopes,
    innermost last, and every scope entered, in order."""

    stack: list[str] = dataclasses.field(default_factory=list)
    entered: list[str] = dataclasses.field(default_factory=list)


class _Scope:
    __slots__ = ("_rec", "_name")

    def __init__(self, rec: Recording, name: str):
        self._rec = rec
        self._name = name

    def __enter__(self):
        self._rec.stack.append(self._name)
        self._rec.entered.append(self._name)
        return self

    def __exit__(self, *exc) -> bool:
        self._rec.stack.pop()
        return False


def scope(name: str):
    """A context naming the code it runs as ``name`` in the active
    recording of this thread; a no-op when nothing records."""
    rec = getattr(_LOCAL, "rec", None)
    if rec is None:
        return _NULL
    return _Scope(rec, name)


@contextlib.contextmanager
def recording():
    """Record the scopes this thread enters until the block ends; yields the
    :class:`Recording`. Recordings do not nest."""
    if getattr(_LOCAL, "rec", None) is not None:
        raise RuntimeError("a scope recording is already active on this thread")
    rec = Recording()
    _LOCAL.rec = rec
    try:
        yield rec
    finally:
        _LOCAL.rec = None
