"""Prometheus-style metrics: labeled counters, gauges, histograms.

Counterpart of ``repro.obs.metrics``, standard library only. The port keeps
a registry of its own, apart from the reference's, with the same series
names (``repro_serve_*``, ``repro_plan_*``), so dashboards built on one read
the other.

A :class:`MetricsRegistry` holds metric *families* (one name, one type,
one help string) of *series* (one per label combination):

    reg = get_registry()
    reg.counter("repro_serve_submitted_total", workload="default").inc()
    reg.histogram("repro_serve_phase_ms", phase="launch").observe(3.2)
    print(reg.to_prometheus())          # text exposition format
    snap = reg.snapshot()               # JSON-able dict

Series handles are plain objects with a per-instance lock — cache them on
hot paths (``self.m_served = reg.counter(...)``) so a dispatch costs one
``inc()``.  ``get_registry()`` returns the process-global registry that
the instrumented layers (plan cache, serving engine) write to;
``registry.clear()`` resets it between tests.

Histograms use fixed cumulative ``le`` buckets (Prometheus semantics:
each bucket counts observations ≤ its bound, ``+Inf`` counts all).  The
default bucket ladder suits millisecond latencies; pass ``buckets=`` at
first creation for other scales (µs, ratios).
"""

from __future__ import annotations

import bisect
import threading

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
]

DEFAULT_BUCKETS = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, float("inf"),
)


class Counter:
    """Monotonically increasing value; ``inc(n)`` with n >= 0."""

    __slots__ = ("_v", "_lock")

    def __init__(self):
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counters only go up; inc({n})")
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        return self._v


class Gauge:
    """A value that goes up and down (queue depth, open streams)."""

    __slots__ = ("_v", "_lock")

    def __init__(self):
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        return self._v


class Histogram:
    """Fixed-bucket histogram with Prometheus cumulative-``le`` semantics."""

    __slots__ = ("bounds", "_counts", "_sum", "_n", "_lock")

    def __init__(self, buckets=DEFAULT_BUCKETS):
        bounds = tuple(float(b) for b in buckets)
        if not bounds or any(a >= b for a, b in zip(bounds, bounds[1:])):
            raise ValueError(
                f"histogram buckets must be strictly ascending, got {buckets!r}")
        if bounds[-1] != float("inf"):
            bounds = bounds + (float("inf"),)
        self.bounds = bounds
        self._counts = [0] * len(bounds)
        self._sum = 0.0
        self._n = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        idx = bisect.bisect_left(self.bounds, float(v))
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._n += 1

    @property
    def count(self) -> int:
        return self._n

    @property
    def sum(self) -> float:
        return self._sum

    def cumulative(self) -> list[tuple[float, int]]:
        """[(le_bound, cumulative_count), ...] ending at (+Inf, count)."""
        out, total = [], 0
        with self._lock:
            for bound, c in zip(self.bounds, self._counts):
                total += c
                out.append((bound, total))
        return out


class _Family:
    __slots__ = ("kind", "help", "buckets", "series")

    def __init__(self, kind: str, help: str, buckets=None):
        self.kind = kind
        self.help = help
        self.buckets = buckets
        self.series: dict[tuple, object] = {}


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_value(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(float(v))


def _fmt_labels(pairs, extra=()) -> str:
    items = list(pairs) + list(extra)
    if not items:
        return ""
    body = ",".join(
        '{}="{}"'.format(
            k, str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
        )
        for k, v in items
    )
    return "{" + body + "}"


def _fmt_le(bound: float) -> str:
    return "+Inf" if bound == float("inf") else _fmt_value(bound)


class MetricsRegistry:
    """Thread-safe family/series store with text + JSON exposition."""

    def __init__(self):
        self._fams: dict[str, _Family] = {}
        self._lock = threading.Lock()

    def _series(self, name: str, kind: str, help: str, labels: dict,
                factory, buckets=None):
        key = _label_key(labels)
        with self._lock:
            fam = self._fams.get(name)
            if fam is None:
                fam = self._fams[name] = _Family(kind, help, buckets)
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} is a {fam.kind}, requested as {kind}")
            if help and not fam.help:
                fam.help = help
            metric = fam.series.get(key)
            if metric is None:
                metric = fam.series[key] = factory(fam)
            return metric

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._series(name, "counter", help, labels, lambda fam: Counter())

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._series(name, "gauge", help, labels, lambda fam: Gauge())

    def histogram(self, name: str, help: str = "", buckets=None,
                  **labels) -> Histogram:
        """Buckets are a family property: the first creation fixes them
        (default :data:`DEFAULT_BUCKETS`); later calls reuse the family's."""
        return self._series(
            name, "histogram", help, labels,
            lambda fam: Histogram(fam.buckets or DEFAULT_BUCKETS),
            buckets=tuple(buckets) if buckets is not None else None,
        )

    def clear(self) -> None:
        with self._lock:
            self._fams.clear()

    # -- exposition --------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able dump: {name: {type, help, series: [{labels, ...}]}}."""
        out: dict = {}
        with self._lock:
            fams = list(self._fams.items())
        for name, fam in fams:
            series = []
            for key, metric in sorted(fam.series.items()):
                labels = dict(key)
                if fam.kind == "histogram":
                    series.append({
                        "labels": labels,
                        "count": metric.count,
                        "sum": metric.sum,
                        "buckets": {
                            _fmt_le(b): c for b, c in metric.cumulative()
                        },
                    })
                else:
                    series.append({"labels": labels, "value": metric.value})
            out[name] = {"type": fam.kind, "help": fam.help, "series": series}
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (scrape-ready)."""
        lines: list[str] = []
        with self._lock:
            fams = list(self._fams.items())
        for name, fam in sorted(fams):
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for key, metric in sorted(fam.series.items()):
                if fam.kind == "histogram":
                    for bound, cum in metric.cumulative():
                        lines.append(
                            f"{name}_bucket"
                            f"{_fmt_labels(key, [('le', _fmt_le(bound))])}"
                            f" {cum}"
                        )
                    lines.append(
                        f"{name}_sum{_fmt_labels(key)} {_fmt_value(metric.sum)}")
                    lines.append(
                        f"{name}_count{_fmt_labels(key)} {metric.count}")
                else:
                    lines.append(
                        f"{name}{_fmt_labels(key)} {_fmt_value(metric.value)}")
        return "\n".join(lines) + ("\n" if lines else "")


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global registry the instrumented layers write to."""
    return _REGISTRY
