"""Trace-file summarizer / converter / validator.

Counterpart of ``repro.obs.report``, standard library only; it reads the
traces of either package (one format, ``repro-trace-v1``).

    PYTHONPATH=src python -m repro_torch.obs.report trace.json             # summary
    PYTHONPATH=src python -m repro_torch.obs.report trace.json --chrome out.json
    PYTHONPATH=src python -m repro_torch.obs.report trace.json --validate
    PYTHONPATH=src python -m repro_torch.obs.report trace.json --request 42
    PYTHONPATH=src python -m repro_torch.obs.report trace.json --chrome out.json --onto prof.json

Reads either format — the native ``repro-trace-v1`` JSON written by
:meth:`Tracer.save`, or Chrome ``trace_event`` JSON written by
:meth:`Tracer.save_chrome` (auto-detected; the Chrome export embeds
span/parent ids in ``args``, so per-request span trees survive the round
trip).  The summary answers "where did the time go": a per-span-name
phase breakdown, the longest spans, the dispatch timeline
(bucket/occupancy/deadline per launch), and one span tree per request
correlation id — queue wait, padding, launch, readback.

``--chrome`` converts a native trace to Chrome JSON (Perfetto-loadable);
``--validate`` structurally checks a Chrome trace (required keys,
non-negative consistent ts/dur, matched ``b``/``e`` and balanced ``B``/
``E`` pairs, ``X`` events carrying ``dur``) and exits nonzero on
problems — ``chip_smoke.py``'s serve phase checks its trace this way.
With ``--onto PROF``, ``--chrome`` writes the Chrome trace that
``torch.profiler`` exported (``export_chrome_trace``) with the native
trace's spans added on the profiler's clock, through the trace's
``clock_anchor`` (:mod:`repro_torch.obs.trace`): the spans recorded after
the fact, such as the engine's request trees, then sit beside the device
work of the same moments in one Perfetto timeline.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

__all__ = ["load_trace", "onto_profile", "summarize", "validate_chrome"]


@dataclasses.dataclass
class SpanRec:
    """Format-independent span row (times in µs, trace-relative)."""

    id: int
    name: str
    ts_us: float
    dur_us: float
    tid: str = "main"
    parent: int | None = None
    corr: object = None
    attrs: dict = dataclasses.field(default_factory=dict)
    instant: bool = False

    @property
    def end_us(self) -> float:
        return self.ts_us + self.dur_us


# ---------------------------------------------------------------------------
# loading (native repro-trace-v1 OR Chrome trace_event JSON)
# ---------------------------------------------------------------------------


def _from_native(doc: dict) -> list[SpanRec]:
    return [
        SpanRec(
            id=int(s["id"]), name=s["name"], ts_us=float(s["ts_us"]),
            dur_us=float(s["dur_us"]), tid=str(s.get("tid", "main")),
            parent=s.get("parent"), corr=s.get("corr"),
            attrs=dict(s.get("attrs") or {}),
            instant=bool(s.get("instant", False)),
        )
        for s in doc.get("spans", [])
    ]


def _from_chrome(doc: dict) -> list[SpanRec]:
    spans: list[SpanRec] = []
    open_async: dict[tuple, list[dict]] = {}
    synth = [10**9]  # fallback ids for events without args.span_id

    def _mk(ev: dict, dur: float, instant: bool = False) -> SpanRec:
        args = dict(ev.get("args") or {})
        sid = args.pop("span_id", None)
        parent = args.pop("parent_id", None)
        corr = args.pop("corr", ev.get("id"))
        if sid is None:
            synth[0] += 1
            sid = synth[0]
        return SpanRec(
            id=int(sid), name=ev.get("name", "?"),
            ts_us=float(ev.get("ts", 0.0)), dur_us=float(dur),
            tid=str(ev.get("tid", "main")), parent=parent,
            corr=corr if ev.get("ph") in ("b", "e") else None,
            attrs=args, instant=instant,
        )

    for ev in doc.get("traceEvents", []):
        ph = ev.get("ph")
        if ph == "X":
            spans.append(_mk(ev, ev.get("dur", 0.0)))
        elif ph == "i":
            spans.append(_mk(ev, 0.0, instant=True))
        elif ph == "b":
            key = (ev.get("cat"), str(ev.get("id")), ev.get("name"))
            open_async.setdefault(key, []).append(ev)
        elif ph == "e":
            key = (ev.get("cat"), str(ev.get("id")), ev.get("name"))
            stack = open_async.get(key)
            if stack:
                begin = stack.pop()
                spans.append(_mk(
                    begin, float(ev.get("ts", 0.0)) - float(begin.get("ts", 0.0))
                ))
    spans.sort(key=lambda s: s.ts_us)
    return spans


def load_trace(path: str) -> list[SpanRec]:
    """Load a trace file of either format into uniform span rows."""
    with open(path) as fh:
        doc = json.load(fh)
    if isinstance(doc, dict) and doc.get("format") == "repro-trace-v1":
        return _from_native(doc)
    if isinstance(doc, dict) and "traceEvents" in doc:
        return _from_chrome(doc)
    if isinstance(doc, list):  # bare Chrome event array form
        return _from_chrome({"traceEvents": doc})
    raise ValueError(
        f"{path}: neither a repro-trace-v1 document nor Chrome trace JSON")


# ---------------------------------------------------------------------------
# native → Chrome conversion
# ---------------------------------------------------------------------------


def chrome_from_native(doc: dict) -> dict:
    """Convert a ``repro-trace-v1`` document to Chrome trace JSON."""
    from repro_torch.obs.trace import Span, Tracer

    tr = Tracer(enabled=True, capacity=max(1, len(doc.get("spans", []) or [1])))
    for s in _from_native(doc):
        tr._append(Span(
            id=s.id, name=s.name, t0=s.ts_us * 1e-6,
            t1=(s.ts_us + s.dur_us) * 1e-6, tid=s.tid, parent=s.parent,
            corr=s.corr, attrs=s.attrs, instant=s.instant,
        ))
    return tr.to_chrome()


def onto_profile(doc: dict, profile: dict) -> dict:
    """``torch.profiler``'s Chrome trace ``profile`` (``ts`` in µs after its
    ``baseTimeNanoseconds``) with the spans of the native document ``doc``
    added as a process of their own, moved onto the profiler's clock by
    ``doc``'s ``clock_anchor``."""
    native = isinstance(doc, dict) and doc.get("format") == "repro-trace-v1"
    anchor = doc.get("clock_anchor") if native else None
    if anchor is None:
        raise ValueError("only a native trace with a clock_anchor (a tracer on "
                         "time.monotonic or time.perf_counter) has the profiler's clock")
    events = profile["traceEvents"]
    shift = (anchor["unix_ns"] - int(profile.get("baseTimeNanoseconds", 0))) / 1e3
    shift -= anchor["ts_us"]
    pid = 1 + max((e["pid"] for e in events if isinstance(e.get("pid"), int)), default=0)
    ours = []
    for ev in chrome_from_native(doc)["traceEvents"]:
        ev["pid"] = pid
        if ev["ph"] != "M":
            ev["ts"] = round(ev["ts"] + shift, 3)
        ours.append(ev)
    return {**profile, "traceEvents": events + ours}


# ---------------------------------------------------------------------------
# Chrome-trace structural validation
# ---------------------------------------------------------------------------


def validate_chrome(doc) -> list[str]:
    """Structural problems of a Chrome trace document ([] = clean)."""
    problems: list[str] = []
    if isinstance(doc, list):
        events = doc
    elif isinstance(doc, dict):
        events = doc.get("traceEvents")
        if not isinstance(events, list):
            return ["top-level 'traceEvents' list is missing"]
    else:
        return [f"trace document must be a dict or list, got {type(doc).__name__}"]
    if not events:
        problems.append("'traceEvents' is empty")
    async_open: dict[tuple, int] = {}
    sync_stacks: dict[object, list[str]] = {}
    for i, ev in enumerate(events):
        where = f"event[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        name = ev.get("name")
        if ph is None or name is None:
            problems.append(f"{where}: missing required key 'ph' or 'name'")
            continue
        ts = ev.get("ts")
        if ph != "M":
            if not isinstance(ts, (int, float)):
                problems.append(f"{where} ({ph} {name!r}): 'ts' missing or non-numeric")
                continue
            if ts < 0:
                problems.append(f"{where} ({ph} {name!r}): negative ts {ts}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)):
                problems.append(f"{where} (X {name!r}): complete event missing 'dur'")
            elif dur < 0:
                problems.append(f"{where} (X {name!r}): negative dur {dur}")
        elif ph in ("b", "e"):
            if "id" not in ev:
                problems.append(f"{where} ({ph} {name!r}): async event missing 'id'")
                continue
            key = (ev.get("cat"), str(ev["id"]), name)
            if ph == "b":
                async_open[key] = async_open.get(key, 0) + 1
            else:
                n = async_open.get(key, 0)
                if n == 0:
                    problems.append(
                        f"{where} (e {name!r} id={ev['id']}): 'e' without matching 'b'")
                else:
                    async_open[key] = n - 1
        elif ph in ("B", "E"):
            stack = sync_stacks.setdefault(ev.get("tid"), [])
            if ph == "B":
                stack.append(name)
            elif not stack:
                problems.append(f"{where} (E {name!r}): 'E' without open 'B'")
            else:
                stack.pop()
    for (cat, ident, name), n in async_open.items():
        if n:
            problems.append(
                f"async 'b' {name!r} (cat={cat}, id={ident}): {n} unmatched")
    for tid, stack in sync_stacks.items():
        if stack:
            problems.append(f"tid {tid}: {len(stack)} unterminated 'B' event(s)")
    return problems


# ---------------------------------------------------------------------------
# summary
# ---------------------------------------------------------------------------


def _pctl(vals: list[float], q: float) -> float:
    if not vals:
        return 0.0
    s = sorted(vals)
    idx = min(len(s) - 1, int(round(q * (len(s) - 1))))
    return s[idx]


def _fmt_attrs(attrs: dict, keys=("workload", "bucket", "occupancy",
                                  "deadline", "scheme", "backend")) -> str:
    shown = {k: attrs[k] for k in keys if k in attrs}
    return " ".join(f"{k}={v}" for k, v in shown.items())


def request_trees(spans: list[SpanRec]) -> dict[object, list[SpanRec]]:
    """Spans grouped by correlation id (insertion-ordered), roots first."""
    trees: dict[object, list[SpanRec]] = {}
    for s in spans:
        if s.corr is not None:
            trees.setdefault(s.corr, []).append(s)
    for group in trees.values():
        group.sort(key=lambda s: (s.parent is not None, s.ts_us))
    return trees


def _render_tree(group: list[SpanRec], out: list[str]) -> None:
    by_parent: dict[int | None, list[SpanRec]] = {}
    ids = {s.id for s in group}
    for s in group:
        parent = s.parent if s.parent in ids else None
        by_parent.setdefault(parent, []).append(s)

    def emit(parent, depth):
        for s in sorted(by_parent.get(parent, []), key=lambda s: s.ts_us):
            pad = "  " * depth
            out.append(
                f"    {pad}{s.name:<{max(1, 24 - 2 * depth)}} "
                f"{s.dur_us / 1e3:9.3f} ms  @+{s.ts_us / 1e3:.3f} ms"
                f"  {_fmt_attrs(s.attrs)}".rstrip()
            )
            emit(s.id, depth + 1)

    emit(None, 0)


def summarize(spans: list[SpanRec], top: int = 10,
              request: object = None) -> str:
    """Human-readable trace summary (see the module docstring)."""
    out: list[str] = []
    if not spans:
        return "empty trace (0 spans)\n"
    t_lo = min(s.ts_us for s in spans)
    t_hi = max(s.end_us for s in spans)
    wall = (t_hi - t_lo) / 1e3
    trees = request_trees(spans)
    out.append(
        f"trace: {len(spans)} spans, {len(trees)} request(s), "
        f"wall {wall:.3f} ms")

    out.append("")
    out.append("per-phase breakdown (by span name):")
    out.append(f"  {'name':<26} {'count':>6} {'total ms':>10} "
               f"{'mean ms':>9} {'p95 ms':>9} {'% wall':>7}")
    agg: dict[str, list[float]] = {}
    for s in spans:
        if not s.instant:
            agg.setdefault(s.name, []).append(s.dur_us)
    for name, durs in sorted(agg.items(), key=lambda kv: -sum(kv[1])):
        total = sum(durs)
        share = 100.0 * total / max(t_hi - t_lo, 1e-9)
        out.append(
            f"  {name:<26} {len(durs):>6} {total / 1e3:>10.3f} "
            f"{total / len(durs) / 1e3:>9.3f} {_pctl(durs, 0.95) / 1e3:>9.3f} "
            f"{share:>6.1f}%")

    out.append("")
    out.append(f"top {top} spans by duration:")
    for s in sorted((s for s in spans if not s.instant),
                    key=lambda s: -s.dur_us)[:top]:
        corr = f" corr={s.corr}" if s.corr is not None else ""
        out.append(
            f"  {s.name:<26} {s.dur_us / 1e3:9.3f} ms  @+{s.ts_us / 1e3:.3f} ms"
            f"{corr}  {_fmt_attrs(s.attrs)}".rstrip())

    dispatches = [s for s in spans if s.name == "glcm.dispatch"]
    if dispatches:
        out.append("")
        out.append(f"dispatch timeline ({len(dispatches)} launches):")
        for s in sorted(dispatches, key=lambda s: s.ts_us):
            out.append(
                f"  @+{s.ts_us / 1e3:10.3f} ms  {s.dur_us / 1e3:9.3f} ms  "
                f"{_fmt_attrs(s.attrs)}")

    if trees:
        out.append("")
        roots = {
            corr: next((s for s in group if s.parent is None
                        or s.parent not in {g.id for g in group}), group[0])
            for corr, group in trees.items()
        }
        e2e = [r.dur_us for r in roots.values()]
        out.append(
            f"requests: {len(trees)} trees; e2e p50={_pctl(e2e, 0.5) / 1e3:.3f} ms "
            f"p95={_pctl(e2e, 0.95) / 1e3:.3f} ms "
            f"max={max(e2e) / 1e3:.3f} ms")
        if request is not None:
            keys = [c for c in trees if str(c) == str(request)]
            if not keys:
                out.append(f"  request {request!r}: not in this trace")
            else:
                out.append(f"  span tree of request {request!r}:")
                _render_tree(trees[keys[0]], out)
        else:
            corr = next(iter(trees))
            out.append(f"  example span tree (request {corr!r}; "
                       f"--request ID for another):")
            _render_tree(trees[corr], out)
    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Summarize, convert, or validate a repro trace file.")
    ap.add_argument("trace", help="native repro-trace-v1 or Chrome trace JSON")
    ap.add_argument("--chrome", metavar="OUT",
                    help="convert to Chrome trace JSON at OUT and exit")
    ap.add_argument("--onto", metavar="PROF",
                    help="with --chrome: add the trace's spans to torch.profiler's "
                         "Chrome trace PROF, on its clock")
    ap.add_argument("--validate", action="store_true",
                    help="structurally validate Chrome trace JSON; exit 1 on problems")
    ap.add_argument("--top", type=int, default=10,
                    help="longest-span rows in the summary (default 10)")
    ap.add_argument("--request", default=None,
                    help="render the span tree of this correlation id")
    args = ap.parse_args(argv)

    with open(args.trace) as fh:
        doc = json.load(fh)

    if args.validate:
        if isinstance(doc, dict) and doc.get("format") == "repro-trace-v1":
            doc = chrome_from_native(doc)  # validate what we WOULD export
        problems = validate_chrome(doc)
        if problems:
            print(f"{args.trace}: INVALID — {len(problems)} problem(s):")
            for p in problems:
                print(f"  {p}")
            return 1
        n = len(doc if isinstance(doc, list) else doc["traceEvents"])
        print(f"{args.trace}: OK ({n} events)")
        return 0

    if args.chrome:
        if args.onto:
            with open(args.onto) as fh:
                profile = json.load(fh)
            try:
                chrome = onto_profile(doc, profile)
            except ValueError as exc:
                print(f"{args.trace}: {exc}", file=sys.stderr)
                return 2
        elif isinstance(doc, dict) and doc.get("format") == "repro-trace-v1":
            chrome = chrome_from_native(doc)
        elif isinstance(doc, (dict, list)) and (
                isinstance(doc, list) or "traceEvents" in doc):
            chrome = doc if isinstance(doc, dict) else {"traceEvents": doc}
        else:
            print(f"{args.trace}: not a convertible trace document",
                  file=sys.stderr)
            return 2
        with open(args.chrome, "w") as fh:
            json.dump(chrome, fh, indent=1)
            fh.write("\n")
        n = len(chrome["traceEvents"])
        print(f"wrote {n} Chrome trace events to {args.chrome}")
        return 0

    print(summarize(load_trace(args.trace), top=args.top,
                    request=args.request), end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
