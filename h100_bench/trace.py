"""The traced run: the benchmark's own spans and one profiled slice of the
window, reduced to what the per-layer metrics read.

``Spans`` records a span around each call the benchmark makes into a layer
of the program (``bench.call``, ``bench.readback``, ``bench.next``,
``bench.submit``, ``bench.poll``, ``bench.wait``) into the program's ``Tracer`` and, so that
the device timeline can be labelled with it, as a profiler annotation. Off,
it is a shared no-op.

``Slice`` runs ``torch.profiler`` (host and device activity) from the
window's start until ``seconds`` have passed at a call boundary, or until
the window ends, and reduces the events to a summary: every device
operation by name (seconds, count), the busy seconds (the union of the
device operations' intervals), the traced window's seconds, and the
``breakdown`` of the result line.
"""

from __future__ import annotations

import contextlib
import time

import torch

from h100_bench.roofline import short_name

__all__ = ["Spans", "Slice"]

_NOOP = contextlib.nullcontext()


class Spans:
    """Benchmark spans into ``tracer`` (the program's ``obs.trace.Tracer``)
    and the profiler, or nothing when ``tracer`` is None."""

    def __init__(self, tracer=None):
        self.tracer = tracer

    def __call__(self, name: str):
        if self.tracer is None:
            return _NOOP
        return self._both(name)

    @contextlib.contextmanager
    def _both(self, name: str):
        with self.tracer.span(name), torch.profiler.record_function(name):
            yield


class Slice:
    """One profiled slice of the window (see the module docstring)."""

    def __init__(self, enabled: bool, seconds: float | None, device: torch.device):
        self.enabled = enabled
        self.seconds = seconds
        self.device = device
        self.prof = None
        self.calls = 0
        self.summary = None

    def start(self) -> None:
        if not self.enabled:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def tick(self, calls: int = 1) -> None:
        """Count ``calls`` completed calls; stop once the slice is long enough."""
        if self.prof is None:
            return
        self.calls += calls
        if self.seconds is not None and time.perf_counter() - self.t0 >= self.seconds:
            self.stop()

    def stop(self) -> None:
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        window_s = time.perf_counter() - self.t0
        prof, self.prof = self.prof, None
        prof.__exit__(None, None, None)
        self.summary = summarize(prof.profiler.kineto_results.events(), window_s, self.calls)


def _union(intervals) -> tuple[float, list[tuple[int, int]]]:
    """Total nanoseconds covered by ``intervals`` and the merged list."""
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), [(s, e) for s, e in merged]


def _innermost(spans, t: int) -> str | None:
    """The name of the shortest span in ``spans`` (start, end, name) that
    holds time ``t``."""
    best = None
    for s, e, name in spans:
        if s <= t <= e and (best is None or e - s < best[0]):
            best = (e - s, name)
    return None if best is None else best[1]


def summarize(events, window_s: float, calls: int) -> dict:
    """Reduce the profiler's events to the slice's summary."""
    dev, bench, host_ops = [], [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in events:
        s, d, name = e.start_ns(), e.duration_ns(), e.name()
        if name.startswith("bench."):
            # The annotation is recorded twice: on the host, and on the
            # device around the work it launched; only the host's is a span.
            if e.device_type() != cuda:
                bench.append((s, s + d, name))
        elif e.device_type() == cuda:
            if not getattr(e, "is_user_annotation", lambda: False)():
                dev.append((s, s + d, short_name(name)))
        elif d > 0:
            host_ops.append((s, s + d, name))
    dev.sort()
    ops: dict[str, list] = {}
    for s, e, name in dev:
        entry = ops.setdefault(name, [0.0, 0])
        entry[0] += (e - s) * 1e-9
        entry[1] += 1
    busy_ns, merged = _union((s, e) for s, e, _ in dev)
    gaps = []
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        gaps.append((s1 - e0, e0, s1))
    gaps.sort(reverse=True)
    idle = []
    for g, e0, s1 in gaps[:10]:
        mid = (e0 + s1) // 2
        label = " / ".join(x for x in (_innermost(bench, mid), _innermost(host_ops, mid)) if x)
        nxt = next((n for s, _, n in dev if s >= s1), "")
        idle.append([f"{label or 'outside bench spans'} -> {nxt}", g * 1e-9])
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "window_s": window_s,
        "busy_s": busy_ns * 1e-9,
        "calls": calls,
        "ops": {k: {"s": v[0], "n": v[1]} for k, v in ops.items()},
        "breakdown": {"device_ops": [[k, v[0]] for k, v in top], "idle_gaps": idle},
    }
