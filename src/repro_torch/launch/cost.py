"""The rank's cost of one program: flops, bytes, collective bytes and memory,
counted by running it once under a dispatch mode.

The port's counterpart of what the reference reads from XLA after an
ahead-of-time compile (``compiled.cost_analysis()``, ``memory_analysis()``
and the HLO text's collectives, ``repro.launch.roofline``). PyTorch has no
such compile, so :class:`CostMode` watches every aten op the program runs:

* **The rank's local ops, not the global op.** On a mesh the program's
  tensors are DTensors. The mode declines any op that has a DTensor among
  its types, so DTensor runs it and the mode then sees the local op on the
  rank's shards (and the ``_c10d_functional`` collectives DTensor issues,
  with local shapes). ``torch.utils.flop_counter.FlopCounterMode`` sits above
  DTensor and counts the global op instead.
* **Only the program's ops.** Metadata queries (``prim.device``, which a
  fake tensor answers through the dispatcher and a real one does not) are
  left out. So is shape inference: DTensor's sharding propagator runs an op
  once on global fake tensors to learn its output's shape, the first time it
  meets an op signature (it caches the answer). Those ops are left out
  (``ShardingPropagator._propagate_tensor_meta_non_cached`` is wrapped while
  the mode is active), so a count does not depend on what ran before.
* **Flops** are ``flop_counter.flop_registry``'s price of each local op: the
  matmul-class ops (mm, bmm, addmm, baddbmm, convolution, the fused
  attentions). Elementwise ops cost no flops here; XLA counts them.
* **Bytes** are each op's input bytes plus its output bytes: eager PyTorch
  fuses nothing, so every op reads its inputs and writes its outputs. Views
  (outputs that alias an input) and ``empty*`` (which write nothing) move no
  bytes. Collectives count under collective bytes only.
* **Collective bytes** are the output bytes of each ``_c10d_functional``
  collective, under the reference's five names.
* **Memory** comes from the rank's live storages: every storage the
  arguments hold or an op creates is live until the last tensor on it dies
  (a weak reference to the storage tells). ``peak_bytes`` is the most that
  was live at once, ``argument_bytes`` what the arguments held at the start,
  ``output_bytes`` the storages of the outputs that are not arguments', and
  ``temp_bytes`` = peak - arguments.

The same mode runs on fake tensors (``launch.steps.lower_cell``: nothing is
allocated) and on real ones (``chip_smoke.py``'s calibration), and the two
counts agree exactly for the same program.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

__all__ = ["COLLECTIVES", "CostMode", "CostRecord", "measure"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

# ``_c10d_functional`` / ``_dtensor`` op names → the reference's (HLO) names.
_COLLECTIVE_OF = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
# Functional ops that move no data: the wait for a collective's result, and
# the wrap of a result that needs grad as an ``AsyncCollectiveTensor`` (torch
# 2.13 issues it for a collective's output on real tensors).
_NO_TRAFFIC = frozenset({"wait_tensor", "_wrap_tensor_autograd"})
_NO_BYTES = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                       "new_empty_strided"})


@dataclasses.dataclass
class CostRecord:
    """One run's counts on this rank (bytes are bytes, flops are flops)."""

    flops: float
    bytes_accessed: float
    coll_bytes: dict
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    peak_bytes: int
    ops: int

    def costs(self) -> dict:
        """The counts that must agree exactly between two runs of one program."""
        return {"flops": self.flops, "bytes_accessed": self.bytes_accessed,
                "coll_bytes": dict(self.coll_bytes)}


@functools.lru_cache(maxsize=None)
def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    """The tensors of a tree; a module gives its parameters and buffers."""
    out = []
    for x in tree_leaves(tree):
        if isinstance(x, torch.nn.Module):
            out.extend(x.parameters())
            out.extend(x.buffers())
        elif isinstance(x, torch.Tensor):
            out.append(x)
    return out


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


_shape_inference = threading.local()


@contextlib.contextmanager
def _skip_shape_inference():
    """Mark the sharding propagator's fake runs while the body runs."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = "_propagate_tensor_meta_non_cached"
    orig = ShardingPropagator.__dict__.get(name)
    if orig is None:
        raise RuntimeError(f"this torch's ShardingPropagator has no {name}: the count "
                           "cannot tell shape inference from the rank's ops")

    @functools.wraps(orig)
    def wrapped(self, *a, **kw):
        _shape_inference.depth = getattr(_shape_inference, "depth", 0) + 1
        try:
            return orig(self, *a, **kw)
        finally:
            _shape_inference.depth -= 1

    setattr(ShardingPropagator, name, wrapped)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


class CostMode(TorchDispatchMode):
    """Counts the rank's ops while active; see the module docstring."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.coll = {c: 0 for c in COLLECTIVES}
        self._lock = threading.Lock()
        self._storages: dict[int, tuple[weakref.ref, int]] = {}
        self.live = 0
        self.peak = 0
        self.argument_bytes = 0
        self._args: set[int] = set()

    # -- memory ------------------------------------------------------------

    def _freed(self, key: int, _ref) -> None:
        with self._lock:
            entry = self._storages.pop(key, None)
            if entry is not None:
                self.live -= entry[1]

    def _track(self, t: torch.Tensor) -> int | None:
        """Register ``t``'s storage if new; returns its key."""
        st = t.untyped_storage()
        key = id(st)
        with self._lock:
            entry = self._storages.get(key)
            if entry is not None and entry[0]() is st:
                return key
            n = st.nbytes()
            self._storages[key] = (weakref.ref(st, functools.partial(self._freed, key)), n)
            self.live += n
            self.peak = max(self.peak, self.live)
        return key

    def hold(self, args) -> None:
        """Register the arguments' storages (their local shards) as live."""
        for t in _tensors(args):
            key = self._track(_local(t))
            if key not in self._args:
                self._args.add(key)
                self.argument_bytes += self._storages[key][1]

    def record(self, outputs) -> CostRecord:
        keys = {id(_local(t).untyped_storage()) for t in _tensors(outputs)}
        out_bytes = sum(self._storages[k][1] for k in keys - self._args if k in self._storages)
        return CostRecord(flops=float(self.flops), bytes_accessed=float(self.bytes),
                          coll_bytes=dict(self.coll), argument_bytes=self.argument_bytes,
                          output_bytes=out_bytes, temp_bytes=self.peak - self.argument_bytes,
                          peak_bytes=self.peak, ops=self.ops)

    # -- dispatch ----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # DTensor runs it; its local ops come back here
        out = func(*args, **kwargs)
        if getattr(_shape_inference, "depth", 0) or func.namespace == "prim":
            return out          # shape inference, or a metadata query (prim.device)
        ins = _tensors((args, kwargs))
        for t in ins:                 # a storage made before the mode (a buffer)
            self._track(t)
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        self.ops += 1
        name = func._overloadpacket.__name__
        ns = func.namespace
        if ns in ("_c10d_functional", "_dtensor") and name in _COLLECTIVE_OF:
            self.coll[_COLLECTIVE_OF[name]] += sum(_nbytes(t) for t in outs)
            return out
        if ns == "_c10d_functional":
            if name not in _NO_TRAFFIC:
                raise NotImplementedError(f"collective {func} has no reference name")
            return out
        if func._overloadpacket in flop_registry:
            self.flops += flop_registry[func._overloadpacket](*args, **kwargs, out_val=out)
        if not _is_view(func) and name not in _NO_BYTES:
            self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        return out


def measure(fn, *args):
    """``(fn(*args), CostRecord)`` of one run of ``fn`` on this rank."""
    with _skip_shape_inference(), CostMode() as mode:
        mode.hold(args)
        out = fn(*args)
        rec = mode.record(out)
    return out, rec
