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

Elastic re-meshing (the reference's ``reshard_tree``) waits for the port's
mesh slice (ROADMAP Queue 1 item B).
"""

from __future__ import annotations

import signal
import time
from collections import deque
from collections.abc import Callable
from typing import Any

import numpy as np

from repro_torch.train import checkpoint as ckpt

__all__ = ["resume_or_init", "StepWatchdog", "GracefulShutdown", "DeterministicSkipSampler"]


def resume_or_init(directory, init_fn: Callable[[], Any], shardings: Any = None, *,
                   device=None) -> tuple[int, Any]:
    """(start_step, state). Restores the latest committed checkpoint onto
    ``device`` (default: the card) or calls ``init_fn`` at step 0."""
    step = ckpt.latest_step(directory)
    if step is None:
        return 0, init_fn()
    return ckpt.restore(directory, step, shardings=shardings, device=device)


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
