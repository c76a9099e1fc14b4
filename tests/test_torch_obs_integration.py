"""Observability threaded through repro_torch: a submit() correlation id
traceable end to end as one span tree, per-phase dispatch stats, the flight
recorder firing on shed/dispatch failures, plan-cache instrumentation, and
the ``repro_torch.obs.report`` CLI.

Counterparts of ``tests/test_obs_integration.py``, on the CPU
(``device="cpu"``), the plan-lint test included (``check="lint"`` records a
``plan.lint`` span and observes ``repro_plan_lint_ms``). The reference's
autotune test's counterpart is in ``test_torch_autotune.py``. One more test
holds the port's engine to the reference engine: the same traffic on the
same virtual clock gives the same span trees and the same ``repro_serve_*``
series.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.pipeline import glcm_feature_stream
from repro_torch.core.plan import compile_plan, plan_cache_clear
from repro_torch.core.spec import GLCMSpec
from repro_torch.obs import report as obs_report
from repro_torch.obs.metrics import get_registry
from repro_torch.obs.trace import Tracer, set_tracer
from repro_torch.serve.engine import GLCMEngine as _Engine
from repro_torch.serve.engine import GLCMServeConfig, QueueFullError

try:  # the reference engine needs JAX, which a machine with a card may not have
    from repro.obs.metrics import get_registry as ref_get_registry
    from repro.obs.trace import Tracer as RefTracer
    from repro.serve.engine import GLCMEngine as RefEngine
    from repro.serve.engine import GLCMServeConfig as RefConfig
except ImportError:
    RefEngine = None

RNG = np.random.default_rng(3)
SHAPE = (32, 32)
IMGS = RNG.random((16, *SHAPE), np.float32)


def GLCMEngine(cfg, **kw):
    return _Engine(cfg, device="cpu", **kw)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, ms):
        self.t += ms * 1e-3


def _cfg(**kw):
    kw.setdefault("levels", 8)
    kw.setdefault("image_shape", SHAPE)
    kw.setdefault("pairs", ((1, 0),))
    return GLCMServeConfig(**kw)


@pytest.fixture
def tracer():
    """A live tracer installed globally (so compile_plan spans are captured
    too), restored afterwards."""
    tr = Tracer(enabled=True)
    prev = set_tracer(tr)
    yield tr
    set_tracer(prev)


# ---------------------------------------------------------------------------
# end-to-end request span trees
# ---------------------------------------------------------------------------


def test_submit_correlation_id_traceable_end_to_end(tracer):
    """One submit() ticket = one span tree: queue wait, padding, launch
    (device-synced), readback — every span carrying the ticket as its
    correlation id, children linked to the request root."""
    clock = FakeClock()
    eng = GLCMEngine(_cfg(batch_size=4), clock=clock, tracer=tracer)
    tickets = []
    for i in range(4):
        tickets.append(eng.submit(IMGS[i]))
        clock.advance(1.0)

    spans = tracer.spans()
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)

    # submit() marked each arrival with an instant carrying the ticket
    assert [s.attrs["ticket"] for s in by_name["glcm.submit"]] == tickets

    # one request tree per ticket, phases parented to the root
    roots = {s.corr: s for s in by_name["glcm.request"]}
    assert sorted(roots) == sorted(tickets)
    for t in tickets:
        root = roots[t]
        children = [s for s in spans
                    if s.parent == root.id and s.corr == t]
        names = {s.name for s in children}
        assert names == {"glcm.queue_wait", "glcm.pad", "glcm.launch",
                         "glcm.readback"}
        phases = {s.name: s for s in children}
        # contiguous phase boundaries: wait→pad→launch→readback
        assert root.t0 == phases["glcm.queue_wait"].t0
        assert phases["glcm.queue_wait"].t1 == phases["glcm.pad"].t0
        assert phases["glcm.pad"].t1 == phases["glcm.launch"].t0
        assert phases["glcm.launch"].t1 == phases["glcm.readback"].t0
        assert phases["glcm.readback"].t1 == root.t1
        # the launch duration is device-synced
        assert phases["glcm.launch"].attrs["synced"] is True
        assert phases["glcm.launch"].attrs["backend"]

    # plus one batch-level dispatch tree on the engine's own track
    (disp,) = by_name["glcm.dispatch"]
    assert disp.attrs["occupancy"] == 4
    disp_children = [s for s in spans if s.parent == disp.id]
    assert {s.name for s in disp_children} == {"glcm.pad", "glcm.launch",
                                               "glcm.readback"}

    # results still served normally
    assert eng.result(tickets[0]).shape[0] == 1


def test_untraced_engine_records_no_spans():
    tr = Tracer(enabled=False)
    eng = GLCMEngine(_cfg(batch_size=2), tracer=tr)
    eng.submit(IMGS[0])
    eng.submit(IMGS[1])
    assert len(tr) == 0


def test_deadline_dispatch_spans_marked(tracer):
    clock = FakeClock()
    eng = GLCMEngine(_cfg(batch_size=8, max_wait_ms=5.0), clock=clock,
                     tracer=tracer)
    t = eng.submit(IMGS[0])
    clock.advance(6.0)
    eng.poll()
    root = next(s for s in tracer.spans()
                if s.name == "glcm.request" and s.corr == t)
    assert root.attrs["deadline"] is True
    assert root.attrs["occupancy"] == 1


def test_stream_push_span_carries_stream_correlation(tracer):
    eng = GLCMEngine(_cfg(batch_size=2, temporal_window=2), tracer=tracer)
    sid = eng.open_stream()
    eng.push(sid, IMGS[0])
    eng.push(sid, IMGS[1])
    pushes = [s for s in tracer.spans() if s.name == "glcm.stream_push"]
    assert len(pushes) == 2
    assert {s.corr for s in pushes} == {f"stream-{sid}"}
    assert pushes[-1].attrs["frames_seen"] == 2


# ---------------------------------------------------------------------------
# per-phase stats and metrics
# ---------------------------------------------------------------------------


def test_stats_expose_per_phase_dispatch_breakdown():
    eng = GLCMEngine(_cfg(batch_size=2))
    eng.submit(IMGS[0])
    eng.submit(IMGS[1])
    w = eng.stats()["workloads"][0]
    for phase in ("pad_ms", "launch_ms", "readback_ms"):
        assert w[phase]["n"] == 1, phase
        assert w[phase]["p50"] >= 0.0
    st = eng.stats()
    assert st["flight_records"] >= 1  # dispatch record always kept
    assert st["incidents"] == 0


def test_serve_metrics_populate_global_registry():
    reg = get_registry()
    reg.clear()
    eng = GLCMEngine(_cfg(batch_size=2))  # registers fresh series
    eng.submit(IMGS[0])
    eng.submit(IMGS[1])
    snap = reg.snapshot()
    by_labels = {tuple(sorted(s["labels"].items())): s["value"]
                 for s in snap["repro_serve_submitted_total"]["series"]}
    assert by_labels[(("workload", "default"),)] == 2
    assert snap["repro_serve_served_total"]["series"][0]["value"] == 2
    assert snap["repro_serve_batches_total"]["series"][0]["value"] == 1
    phase_series = snap["repro_serve_phase_ms"]["series"]
    phases = {s["labels"]["phase"] for s in phase_series}
    assert phases == {"queue", "pad", "launch", "readback"}
    # scrape-ready exposition includes the histogram series
    assert "repro_serve_phase_ms_bucket" in reg.to_prometheus()


# ---------------------------------------------------------------------------
# flight recorder incidents
# ---------------------------------------------------------------------------


def test_queue_full_dumps_flight_recorder():
    eng = GLCMEngine(_cfg(batch_size=8, max_queue_depth=2))
    eng.submit(IMGS[0])
    eng.submit(IMGS[1])
    with pytest.raises(QueueFullError):
        eng.submit(IMGS[2])
    inc = eng.last_incident
    assert inc is not None
    assert "QueueFullError" in inc["reason"]
    assert inc["records"][-1]["kind"] == "shed"
    assert eng.stats()["incidents"] == 1


def test_dispatch_error_dumps_flight_recorder(monkeypatch):
    eng = GLCMEngine(_cfg(batch_size=2))
    eng.submit(IMGS[0])  # queued, no dispatch yet

    def boom(w, bucket):
        raise RuntimeError("device fell over")

    monkeypatch.setattr(eng, "_plan_for", boom)
    with pytest.raises(RuntimeError, match="device fell over"):
        eng.submit(IMGS[1])  # fills the batch → dispatch → failure
    inc = eng.last_incident
    assert inc is not None and "dispatch error" in inc["reason"]
    err = inc["records"][-1]
    assert err["kind"] == "dispatch_error"
    assert err["tickets"] == [0, 1]


# ---------------------------------------------------------------------------
# plan-cache instrumentation
# ---------------------------------------------------------------------------


def test_plan_compile_and_cache_hit_instrumented(tracer):
    plan_cache_clear()
    reg = get_registry()
    reg.clear()
    spec = GLCMSpec(levels=8, pairs=((1, 0),))
    compile_plan(spec, (16, 16), device="cpu")   # miss → plan.compile span
    compile_plan(spec, (16, 16), device="cpu")   # hit → plan.cache_hit event
    names = [s.name for s in tracer.spans()]
    assert "plan.compile" in names
    assert "plan.cache_hit" in names
    comp = next(s for s in tracer.spans() if s.name == "plan.compile")
    assert comp.attrs["scheme"] == "onehot"  # the RESOLVED scheme, not "auto"
    assert comp.attrs["shape"] == "(16, 16)"
    assert comp.attrs["kind"] == "plan"
    snap = reg.snapshot()
    lookups = {s["labels"]["result"]: s["value"]
               for s in snap["repro_plan_cache_lookups_total"]["series"]}
    assert lookups == {"miss": 1, "hit": 1}
    assert snap["repro_plan_compile_ms"]["series"][0]["count"] == 1


def test_stream_plan_compile_and_cache_hit_instrumented(tracer):
    plan_cache_clear()
    reg = get_registry()
    reg.clear()
    spec = GLCMSpec(levels=8, pairs=((1, 0),))
    for _ in range(3):
        compile_plan(spec, (16, 16), temporal_window=4, device="cpu")
    comp = [s for s in tracer.spans() if s.name == "plan.compile"]
    hits = [s for s in tracer.spans() if s.name == "plan.cache_hit"]
    assert len(comp) == 1 and comp[0].attrs["kind"] == "stream" and len(hits) == 2
    snap = reg.snapshot()
    lookups = {s["labels"]["result"]: s["value"]
               for s in snap["repro_plan_cache_lookups_total"]["series"]}
    assert lookups == {"miss": 1, "hit": 2}


def test_plan_lint_still_not_implemented(tracer):
    """``check="lint"`` is instrumented as in the reference: one
    ``plan.lint`` span with its ``findings`` and ``ms``, one observation of
    ``repro_plan_lint_ms{scheme}``; a later linted lookup replays the cached
    verdict and records neither again."""
    plan_cache_clear()
    reg = get_registry()
    reg.clear()
    spec = GLCMSpec(levels=8, pairs=((1, 0),))
    compile_plan(spec, (16, 16), check="lint", device="cpu")
    lint = [s for s in tracer.spans() if s.name == "plan.lint"]
    assert len(lint) == 1
    assert lint[0].dur >= 0.0 and lint[0].attrs["findings"] == 0
    assert lint[0].attrs["scheme"] == "onehot" and lint[0].attrs["ms"] >= 0.0
    series = reg.snapshot()["repro_plan_lint_ms"]["series"]
    assert [(s["labels"], s["count"]) for s in series] == [({"scheme": "onehot"}, 1)]
    compile_plan(spec, (16, 16), check="lint", device="cpu")
    assert len([s for s in tracer.spans() if s.name == "plan.lint"]) == 1
    assert reg.snapshot()["repro_plan_lint_ms"]["series"][0]["count"] == 1


# ---------------------------------------------------------------------------
# spans of the main path: plan calls and the host pipeline
# ---------------------------------------------------------------------------

# What a batch plan's call records into the global tracer, in order of
# their ends: f14's eigensolver inside the tail, the tail inside the run.
PLAN_CALL = ("plan.prepare", "plan.count", "haralick.eigvalsh", "plan.tail", "plan.run")
MAIN_SPEC = GLCMSpec(levels=8, pairs=((1, 0), (1, 45)), quantize="uniform")


def _uint8(n, shape=SHAPE, seed=5):
    return np.random.default_rng(seed).integers(0, 256, (n, *shape), np.uint8)


@pytest.mark.parametrize("shape", [(3, *SHAPE), SHAPE])
def test_plan_call_records_run_prepare_count_tail(tracer, shape):
    """A plan call is one ``plan.run`` (batch, scheme) whose children are,
    in order, ``plan.prepare``, ``plan.count`` (hist, copies: the plain
    version's count on the CPU) and ``plan.tail`` (matrices, solver: the
    PyTorch tail on the CPU), all inside it; f14's ``haralick.eigvalsh`` (matrices, solver: the plain version's
    eigvalsh on the CPU, chunks: one call of it) lies inside the tail."""
    plan = compile_plan(MAIN_SPEC, shape, features=True, device="cpu")
    tracer.clear()
    plan(_uint8(1, shape)[0])
    spans = tracer.spans()
    assert tuple(s.name for s in spans) == PLAN_CALL
    prep, count, eig, tail, run = spans
    batch = shape[0] if len(shape) == 3 else 1
    assert run.parent is None and run.attrs == {"batch": batch, "scheme": plan.spec.scheme}
    assert {s.parent for s in (prep, count, tail)} == {run.id} and eig.parent == tail.id
    assert prep.attrs == {} and count.attrs == {"hist": "plain", "copies": 0}
    assert tail.attrs == {"matrices": 2 * batch, "solver": "plain"}
    assert eig.attrs == {"matrices": 2 * batch, "solver": "eigvalsh", "chunks": 1}
    assert run.t0 <= prep.t0 <= prep.t1 <= count.t0 <= count.t1 <= tail.t0 <= tail.t1 <= run.t1
    assert tail.t0 <= eig.t0 <= eig.t1 <= tail.t1


def test_disabled_tracer_records_no_main_path_span_and_reads_no_clock():
    """Off, the plan's, the tail's and the pipeline's spans read no clock,
    record nothing and open no profiler range."""
    reads = []

    def clock():
        reads.append(1)
        return 0.0

    off = Tracer(enabled=False, clock=clock)
    prev = set_tracer(off)
    try:
        plan = compile_plan(MAIN_SPEC, (2, *SHAPE), features=True, device="cpu")
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            plan(_uint8(2))
            out = list(glcm_feature_stream(list(_uint8(3)), spec=MAIN_SPEC, batch_size=2,
                                           device="cpu"))
    finally:
        set_tracer(prev)
    assert len(out) == 3 and len(off) == 0 and reads == []
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not [n for n in names if n.startswith(("plan.", "pipeline.", "haralick."))]


def test_feature_stream_records_one_coalesce_a_stack(tracer):
    """On the CPU the stream stacks and calls the plan: one
    ``pipeline.coalesce`` and one ``plan.run`` a stack, the last stack
    padded; there is no staging and no join."""
    out = list(glcm_feature_stream(list(_uint8(5)), spec=MAIN_SPEC, batch_size=2,
                                   device="cpu"))
    assert len(out) == 5
    by = {}
    for s in tracer.spans():
        by.setdefault(s.name, []).append(s)
    assert [s.attrs["images"] for s in by["pipeline.coalesce"]] == [2, 2, 1]
    assert [s.attrs["batch"] for s in by["plan.run"]] == [2, 2, 2]
    assert "pipeline.stage" not in by and "pipeline.join" not in by


@pytest.mark.cuda
def test_feature_stream_on_card_records_stage_and_join_a_stack(tracer):
    """On the card each stack is also staged into pinned memory and joined:
    one ``pipeline.stage`` (its bytes) and one ``pipeline.join`` a stack."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    imgs = list(_uint8(6, (96, 80)))
    out = [o.cpu() for o in glcm_feature_stream(imgs, spec=MAIN_SPEC, batch_size=2)]
    assert len(out) == 6
    by = {}
    for s in tracer.spans():
        by.setdefault(s.name, []).append(s)
    assert [s.attrs["images"] for s in by["pipeline.coalesce"]] == [2, 2, 2]
    assert [s.attrs["bytes"] for s in by["pipeline.stage"]] == [2 * 96 * 80] * 3
    assert len(by["pipeline.join"]) == 3 and len(by["plan.run"]) == 3


# ---------------------------------------------------------------------------
# report CLI
# ---------------------------------------------------------------------------


def _traced_engine_run(tracer):
    clock = FakeClock()
    eng = GLCMEngine(_cfg(batch_size=2), clock=clock, tracer=tracer)
    for i in range(4):
        eng.submit(IMGS[i])
        clock.advance(1.0)
    eng.flush()


def test_report_cli_summarizes_native_trace(tracer, tmp_path, capsys):
    _traced_engine_run(tracer)
    path = tmp_path / "trace.json"
    tracer.save(str(path))
    assert obs_report.main([str(path)]) == 0
    out = capsys.readouterr().out
    assert "per-phase breakdown" in out
    assert "glcm.request" in out
    assert "dispatch timeline" in out
    assert "example span tree" in out


def test_report_cli_renders_requested_tree(tracer, tmp_path, capsys):
    _traced_engine_run(tracer)
    path = tmp_path / "trace.json"
    tracer.save(str(path))
    assert obs_report.main([str(path), "--request", "2"]) == 0
    out = capsys.readouterr().out
    assert "span tree of request" in out and "glcm.queue_wait" in out


def test_report_cli_converts_and_validates_chrome(tracer, tmp_path, capsys):
    _traced_engine_run(tracer)
    native = tmp_path / "trace.json"
    chrome = tmp_path / "chrome.json"
    tracer.save(str(native))
    assert obs_report.main([str(native), "--chrome", str(chrome)]) == 0
    doc = json.loads(chrome.read_text())
    assert obs_report.validate_chrome(doc) == []
    # --validate accepts both formats (native is converted first)
    assert obs_report.main([str(chrome), "--validate"]) == 0
    assert obs_report.main([str(native), "--validate"]) == 0
    capsys.readouterr()


def test_report_cli_validate_fails_on_broken_trace(tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "name": "a", "ts": 1}]}))  # X without dur
    assert obs_report.main([str(bad), "--validate"]) == 1
    assert "INVALID" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# parity with the reference engine
# ---------------------------------------------------------------------------


def _replay(engine_cls, cfg, tracer, clock):
    """Mixed traffic on a virtual clock that only moves when told: full
    batches, a deadline launch, a flush and a shed."""
    eng = engine_cls(cfg, clock=clock, tracer=tracer)
    for i in range(5):
        eng.submit(IMGS[i], priority=i % 2)
        clock.advance(0.5)
    clock.advance(3.0)
    eng.poll()
    eng.pause()
    for i in range(3):
        eng.submit(IMGS[i])
    with pytest.raises(Exception, match="max_queue_depth"):
        eng.submit(IMGS[3])
    eng.resume()
    eng.flush()
    return eng


# What the port's plans record into its global tracer: the spans of a plan
# call, which the reference has not, and the plan cache's, which the
# reference records into its own global tracer, here left off.
PORT_ONLY = ("plan.compile", "plan.cache_hit") + PLAN_CALL


def _without(doc, names):
    """``doc`` less the spans named in ``names``, ids and parents
    renumbered in order from 1."""
    kept = [s for s in doc["spans"] if s["name"] not in names]
    new_id = {old: i for i, old in enumerate(sorted(s["id"] for s in kept), 1)}
    for s in kept:
        s["id"] = new_id[s["id"]]
        s["parent"] = new_id[s["parent"]] if s["parent"] is not None else None
    return {**doc, "spans": kept}


def test_engine_traces_and_series_match_reference():
    """The port's engine, on its tracer installed as the global one (as an
    engine on the default tracer is), records the reference engine's
    document plus the spans of ``PORT_ONLY``; without them, every span,
    attribute and parent link is the reference's."""
    if RefEngine is None:
        pytest.skip("needs JAX to run the reference engine")
    kw = dict(levels=8, image_shape=SHAPE, pairs=((1, 0),), batch_size=2,
              max_wait_ms=2.0, max_queue_depth=3)
    docs, series, incidents = [], [], []
    for engine_cls, cfg, tracer_cls, registry in (
            (GLCMEngine, GLCMServeConfig(**kw), Tracer, get_registry()),
            (RefEngine, RefConfig(**kw), RefTracer, ref_get_registry())):
        registry.clear()
        clock = FakeClock()
        tr = tracer_cls(enabled=True, clock=clock)
        prev = set_tracer(tr) if tracer_cls is Tracer else None
        try:
            eng = _replay(engine_cls, cfg, tr, clock)
        finally:
            if prev is not None:
                set_tracer(prev)
        doc = tr.to_dict()
        if tracer_cls is Tracer:
            assert {s["name"] for s in doc["spans"]} >= set(PLAN_CALL)
        doc = _without(doc, PORT_ONLY)
        for s in doc["spans"]:
            s["attrs"].pop("backend", None)  # scheme names are per package
        docs.append(doc)
        # on a clock that never moves inside a dispatch every phase is 0 ms,
        # so the whole repro_serve_* exposition is deterministic
        series.append([ln for ln in registry.to_prometheus().splitlines()
                       if "repro_serve_" in ln])
        inc = eng.last_incident
        incidents.append((inc["reason"], [r["kind"] for r in inc["records"]]))
    assert docs[0] == docs[1]
    assert series[0] == series[1] and any("repro_serve_phase_ms_bucket" in ln
                                          for ln in series[0])
    assert incidents[0] == incidents[1]
