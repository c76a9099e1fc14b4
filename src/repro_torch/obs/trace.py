"""Thread-safe span tracer with Chrome ``trace_event`` export.

Counterpart of ``repro.obs.trace``. The port's global tracer is its own,
apart from the reference's, and is switched on by the same ``REPRO_TRACE=1``.
The module imports only the standard library; it reaches torch (see
"One clock with the device trace" below) only once torch is loaded.

A :class:`Tracer` records **spans** — named intervals with attributes —
into a bounded ring buffer.  Spans come from two sources:

* ``with tracer.span("name", key=val) as sp:`` — a live, nested context
  manager: the span's parent is whatever span is open on the *same
  thread*, its times come from the tracer's clock, and ``sp.set(k=v)``
  attaches attributes discovered mid-span.
* ``tracer.add_span("name", t0, t1, parent=..., corr=...)`` — a
  retrospective span recorded from explicit timestamps (the serving
  engine measures phase times with its own injected clock anyway, so it
  records the whole request tree after the fact, at zero cost to the
  untraced hot path).  Returns the span id for parent linkage.

``corr`` is a correlation id: every span of one request carries the
request's ticket, so a single ``submit()`` is traceable end-to-end as one
span tree (``repro_torch.obs.report`` groups by it; the Chrome export emits
correlated spans as async ``b``/``e`` events on a per-request track).

**Disabled is the default and is free.**  ``tracer.span()`` on a disabled
tracer returns a shared no-op context manager (no allocation beyond the
kwargs dict, no clock read, no lock); ``tracer.enabled`` is a plain
attribute so hot paths guard with ``if tr.enabled:``.  The global tracer
(:func:`get_tracer`) starts disabled unless ``REPRO_TRACE=1`` is set;
:func:`set_tracer` injects a live one (tests, ``chip_smoke.py``'s serve phase).

The clock is injectable (``Tracer(clock=...)``) and must be monotonic;
everything downstream (export, report) works in relative time, so a
virtual warp clock (``chip_smoke.py``'s replay) traces exactly like
``time.monotonic``.

**One clock with the device trace.**  ``torch.profiler`` stamps its events
in Unix nanoseconds; the tracer's clock is monotonic.  Two things tie them:

* While a torch profiler records, every live ``span()`` of an enabled
  tracer also opens a profiler range of the same name (torch's
  ``_RecordFunctionFast``, its cheapest range), so the profiler's timeline
  shows the program's spans beside the aten ops and kernels they issued.
  The check costs nothing when tracing is off (``span()`` returns the no-op
  first) and looks torch up in ``sys.modules``: a process that never loaded
  torch has no profiler to mirror into, and this module never imports it.
* Spans recorded after the fact (``add_span``: the engine's request tree,
  ``plan.compile``, ``autotune.*``) get no range; instead a tracer on
  ``time.monotonic`` or ``time.perf_counter`` keeps one anchor pair read back
  to back when it is built, ``anchor = (time.time_ns(), clock())``, so any
  tracer time ``t`` is Unix ns ``anchor[0] + (t - anchor[1]) * 1e9``.
  ``to_dict()`` exports it as ``clock_anchor``: ``unix_ns`` and the anchor's
  ``ts_us`` on the document's own relative timeline; ``python -m
  repro_torch.obs.report trace.json --chrome OUT --onto PROF`` reads it to
  add the trace's spans to a profiler's Chrome export.  A tracer on any
  other (injected, possibly virtual) clock has ``anchor = None`` and exports
  no ``clock_anchor``.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import sys
import threading
import time

__all__ = ["Span", "Tracer", "get_tracer", "set_tracer"]


@dataclasses.dataclass(frozen=True)
class Span:
    """One recorded interval (or instant, when ``t0 == t1`` and
    ``instant``): times are raw tracer-clock seconds."""

    id: int
    name: str
    t0: float
    t1: float
    tid: str
    parent: int | None = None
    corr: object = None
    attrs: dict = dataclasses.field(default_factory=dict)
    instant: bool = False

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


class _NoopSpan:
    """The disabled-tracer fast path: one shared instance, every method a
    no-op.  ``__slots__ = ()`` so even attribute writes fail fast."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NOOP = _NoopSpan()

# Clocks whose relation to Unix time a tracer can anchor (see the docstring).
_ANCHORED_CLOCKS = (time.monotonic, time.perf_counter)


def _profiler_range(name: str):
    """An open torch profiler range named ``name`` while a profiler records
    in this process, else None."""
    torch = sys.modules.get("torch")
    if torch is None or not torch._C._autograd._profiler_enabled():
        return None
    rng = torch._C._profiler._RecordFunctionFast(name)
    rng.__enter__()
    return rng


class _LiveSpan:
    """Context-manager handle for one open span of an enabled tracer."""

    __slots__ = ("_tr", "name", "attrs", "id", "parent", "t0", "_range")

    def __init__(self, tracer: Tracer, name: str, attrs: dict):
        self._tr = tracer
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        tr = self._tr
        stack = tr._stack()
        self.parent = stack[-1] if stack else None
        self.id = next(tr._ids)
        self._range = _profiler_range(self.name)
        self.t0 = tr.clock()
        stack.append(self.id)
        return self

    def __exit__(self, etype, evalue, tb):
        tr = self._tr
        t1 = tr.clock()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        stack = tr._stack()
        if self.id in stack:
            # pop through self: un-exited inner ids (generator spans that
            # never closed) must not leak as parents of later spans
            del stack[stack.index(self.id):]
        if etype is not None:
            self.attrs.setdefault("error", f"{etype.__name__}: {evalue}")
        tr._append(Span(
            id=self.id, name=self.name, t0=self.t0, t1=t1,
            tid=threading.current_thread().name, parent=self.parent,
            attrs=self.attrs,
        ))
        return False

    def set(self, **attrs):
        self.attrs.update(attrs)
        return self


class Tracer:
    """Bounded-ring span recorder; see the module docstring.

    ``capacity`` bounds retained spans (oldest dropped first — a
    long-lived server cannot leak trace memory); ``clock`` is any
    monotonic ``() -> float`` seconds source. ``anchor`` is the
    ``(unix_ns, clock seconds)`` pair of a ``time.monotonic`` or
    ``time.perf_counter`` clock, else None.
    """

    def __init__(self, *, enabled: bool = False, clock=time.monotonic,
                 capacity: int = 65536):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.enabled = bool(enabled)
        self.clock = clock
        self.anchor = (time.time_ns(), clock()) if clock in _ANCHORED_CLOCKS else None
        self.capacity = int(capacity)
        self._buf: list[Span] = []
        self._head = 0                      # ring insertion point
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._tls = threading.local()
        self.dropped = 0                    # spans evicted by the ring

    # -- recording ---------------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _append(self, span: Span) -> None:
        with self._lock:
            if len(self._buf) < self.capacity:
                self._buf.append(span)
            else:
                self._buf[self._head] = span
                self._head = (self._head + 1) % self.capacity
                self.dropped += 1

    def span(self, name: str, **attrs):
        """Open a nested span (context manager).  Disabled → shared no-op."""
        if not self.enabled:
            return _NOOP
        return _LiveSpan(self, name, attrs)

    def add_span(self, name: str, t0: float, t1: float, *,
                 parent: int | None = None, corr: object = None,
                 tid: str | None = None, **attrs) -> int:
        """Record a span from explicit tracer-clock timestamps; returns its
        id (pass as ``parent=`` to build trees).  No-op (returns 0) when
        disabled."""
        if not self.enabled:
            return 0
        sid = next(self._ids)
        self._append(Span(
            id=sid, name=name, t0=float(t0), t1=float(t1),
            tid=tid if tid is not None else threading.current_thread().name,
            parent=parent, corr=corr, attrs=attrs,
        ))
        return sid

    def event(self, name: str, **attrs) -> int:
        """Record an instant event at the current clock time."""
        if not self.enabled:
            return 0
        sid = next(self._ids)
        now = self.clock()
        self._append(Span(
            id=sid, name=name, t0=now, t1=now,
            tid=threading.current_thread().name,
            parent=(self._stack() or [None])[-1], attrs=attrs, instant=True,
        ))
        return sid

    # -- inspection --------------------------------------------------------

    def spans(self) -> tuple[Span, ...]:
        """Snapshot of retained spans in recording order."""
        with self._lock:
            return tuple(self._buf[self._head:] + self._buf[:self._head])

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._head = 0
            self.dropped = 0

    # -- export ------------------------------------------------------------

    def to_dict(self) -> dict:
        """The native trace document (µs, relative to the earliest span),
        with ``clock_anchor`` when the tracer has an anchor."""
        spans = self.spans()
        base = min((s.t0 for s in spans), default=0.0)
        doc = {
            "format": "repro-trace-v1",
            "dropped": self.dropped,
            "spans": [
                {
                    "id": s.id, "name": s.name,
                    "ts_us": round((s.t0 - base) * 1e6, 3),
                    "dur_us": round(s.dur * 1e6, 3),
                    "tid": s.tid, "parent": s.parent, "corr": s.corr,
                    "attrs": s.attrs, "instant": s.instant,
                }
                for s in spans
            ],
        }
        if self.anchor is not None:
            unix_ns, t = self.anchor
            doc["clock_anchor"] = {"unix_ns": unix_ns, "ts_us": round((t - base) * 1e6, 3)}
        return doc

    def save(self, path: str) -> None:
        """Write the native trace JSON (``repro_torch.obs.report`` reads it and
        converts to Chrome format with ``--chrome``)."""
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh, indent=1)
            fh.write("\n")

    def to_chrome(self) -> dict:
        """Chrome ``trace_event`` JSON (dict): complete ``X`` events for
        plain spans, async ``b``/``e`` pairs (one track per correlation id)
        for request-correlated spans, ``i`` instants for events.  Loadable
        in Perfetto; ``args`` carry span/parent ids so
        ``repro_torch.obs.report`` can rebuild exact trees from the export."""
        spans = self.spans()
        base = min((s.t0 for s in spans), default=0.0)
        tids = {name: i + 1 for i, name in enumerate(
            sorted({s.tid for s in spans}))}
        events: list[dict] = [
            {"ph": "M", "name": "process_name", "pid": 1, "tid": 0, "ts": 0,
             "args": {"name": "repro-glcm"}},
        ]
        for name, tid in tids.items():
            events.append({"ph": "M", "name": "thread_name", "pid": 1,
                           "tid": tid, "ts": 0, "args": {"name": name}})
        for s in spans:
            ts = round((s.t0 - base) * 1e6, 3)
            dur = round(s.dur * 1e6, 3)
            args = {**s.attrs, "span_id": s.id}
            if s.parent is not None:
                args["parent_id"] = s.parent
            common = {"name": s.name, "pid": 1, "tid": tids[s.tid]}
            if s.instant:
                events.append({**common, "ph": "i", "ts": ts, "s": "t",
                               "args": args})
            elif s.corr is not None:
                args["corr"] = s.corr
                ident = str(s.corr)
                events.append({**common, "ph": "b", "cat": "request",
                               "id": ident, "ts": ts, "args": args})
                events.append({**common, "ph": "e", "cat": "request",
                               "id": ident, "ts": round(ts + dur, 3)})
            else:
                events.append({**common, "ph": "X", "cat": "span", "ts": ts,
                               "dur": dur, "args": args})
        events.sort(key=lambda e: (e.get("ts", 0), e["ph"] != "b"))
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save_chrome(self, path: str) -> None:
        """Write Chrome-trace JSON (open in Perfetto / chrome://tracing)."""
        with open(path, "w") as fh:
            json.dump(self.to_chrome(), fh, indent=1)
            fh.write("\n")


def _env_enabled() -> bool:
    return os.environ.get("REPRO_TRACE", "").lower() in ("1", "true", "yes")


_GLOBAL = Tracer(enabled=_env_enabled())


def get_tracer() -> Tracer:
    """The process-global tracer consulted by instrumented layers
    (compile_plan, GLCMEngine's default).  Disabled unless
    ``REPRO_TRACE=1`` was set at import or :func:`set_tracer` installed a
    live one."""
    return _GLOBAL


def set_tracer(tracer: Tracer) -> Tracer:
    """Install ``tracer`` as the global tracer; returns the previous one
    (restore it in a ``finally`` in tests/benchmarks)."""
    global _GLOBAL
    prev = _GLOBAL
    _GLOBAL = tracer
    return prev
