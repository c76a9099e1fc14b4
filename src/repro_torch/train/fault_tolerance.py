"""Fault tolerance for training; the port's counterpart of
``repro.train.fault_tolerance``.

1. **Checkpoint/restart** — step-atomic checkpoints with COMMIT markers
   (``train.checkpoint``); a restarted job calls ``resume_or_init``, which
   restores the latest committed step (torn writes are invisible), and
   fast-forwards the data deterministically (``DeterministicSkipSampler``:
   batch k is a pure function of (seed, k), so skipping is O(1)).
2. **Straggler mitigation** — ``StepWatchdog`` keeps a rolling median of
   step times; a step slower than ``threshold x`` the median calls back.
   Its ``clock`` is injectable (``time.perf_counter`` by default), so a
   test drives it with a fake clock instead of sleeping.
3. **Preemption-safe shutdown** — SIGTERM/SIGINT flips a flag checked each
   step: finish the step, checkpoint synchronously, exit cleanly.

4. **Elastic re-meshing** — ``reshard_tree`` places a global tree (a
   restored checkpoint, or DTensors of another mesh) onto a new mesh's
   shardings; ``resume_or_init(shardings=)`` restores straight onto them.
"""

from __future__ import annotations

import signal
import time
from collections import deque
from collections.abc import Callable
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.sharding.partition import distribute
from repro_torch.train import checkpoint as ckpt

__all__ = ["resume_or_init", "reshard_tree", "StepWatchdog", "GracefulShutdown",
           "DeterministicSkipSampler"]


def resume_or_init(directory, init_fn: Callable[[], Any], shardings: Any = None, *,
                   device=None) -> tuple[int, Any]:
    """(start_step, state). Restores the latest committed checkpoint onto
    ``device`` (default: the card), or by ``shardings`` onto their mesh,
    or calls ``init_fn`` at step 0."""
    step = ckpt.latest_step(directory)
    if step is None:
        return 0, init_fn()
    return ckpt.restore(directory, step, shardings=shardings, device=device)


def reshard_tree(tree: Any, shardings: Any) -> Any:
    """Re-place a global tree onto a new mesh's shardings (a tree of
    ``NamedSharding`` of the same structure). A leaf may be a tensor or an
    array holding the global value on every rank, or a DTensor of any mesh,
    which is gathered first (``full_tensor()``, a collective of its own
    mesh: every rank calls this with the same tree). The new leaves own
    their memory: the optimizer updates its state in place, so a re-placed
    tree must share no storage with the tree it came from."""
    if isinstance(tree, dict):
        return {k: reshard_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(reshard_tree(v, s) for v, s in zip(tree, shardings, strict=True))
    if isinstance(tree, DTensor):
        tree = tree.full_tensor()
    elif not torch.is_tensor(tree):
        tree = torch.from_numpy(np.array(tree))
    return distribute(tree.detach().to(shardings.mesh.device_type, copy=True), shardings)


class StepWatchdog:
    """Detects straggler steps: keeps a rolling median of step times and
    fires ``on_straggler(step, dt, median)`` when dt > threshold x median."""

    def __init__(self, threshold: float = 2.5, window: int = 50,
                 warmup: int = 5,
                 on_straggler: Callable[[int, float, float], None] | None = None,
                 clock: Callable[[], float] = time.perf_counter):
        self.threshold = threshold
        self.times: deque[float] = deque(maxlen=window)
        self.warmup = warmup
        self.clock = clock
        self.on_straggler = on_straggler or (
            lambda s, dt, med: print(
                f"[watchdog] step {s}: {dt*1e3:.0f}ms > "
                f"{self.threshold}×median ({med*1e3:.0f}ms) — straggler"))
        self._t0: float | None = None
        self._count = 0
        self.stragglers: list[int] = []

    def start(self) -> None:
        self._t0 = self.clock()

    def stop(self, step: int) -> float:
        dt = self.clock() - self._t0
        self._count += 1
        if self._count > self.warmup and len(self.times) >= 5:
            med = float(np.median(self.times))
            if dt > self.threshold * med:
                self.stragglers.append(step)
                self.on_straggler(step, dt, med)
        self.times.append(dt)
        return dt


class GracefulShutdown:
    """SIGTERM/SIGINT → finish the current step, checkpoint, exit cleanly."""

    def __init__(self):
        self.requested = False
        self._prev = {}

    def install(self) -> "GracefulShutdown":
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._prev[sig] = signal.signal(sig, self._handler)
        return self

    def _handler(self, signum, frame):  # noqa: ARG002
        self.requested = True

    def uninstall(self) -> None:
        for sig, h in self._prev.items():
            signal.signal(sig, h)


class DeterministicSkipSampler:
    """Batch k is a pure function of (seed, k): restart at any step without
    replaying the data stream (O(1) skip). The numpy generator is the
    reference's, so the batches are its, bit for bit."""

    def __init__(self, seed: int, make_batch: Callable[[np.random.Generator], Any]):
        self.seed = seed
        self.make_batch = make_batch

    def batch_at(self, step: int) -> Any:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        return self.make_batch(rng)
