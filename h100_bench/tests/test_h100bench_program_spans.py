"""The readers of the program's own spans (``h100_bench/program_spans.py``),
on synthetic spans in a ``Tracer``, and on the CPU end to end: a tiny traced
run of each cell they read reports them."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from h100_bench import program_spans as ps
from h100_bench import stats
from h100_bench.run import _module
from repro_torch.obs.trace import Tracer, set_tracer

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
READERS = {m["name"]: m for m in BENCH["per_layer"] if m["source"] == "program_span"}
NEW = ("tail_host_ms", "plan_host_ms", "coalesce_ms.host", "stage_ms.host", "join_ms.host",
       "queue_wait_ms.serve")
MS = 1e-3


@pytest.fixture
def tracer():
    tr = Tracer(enabled=True, capacity=4096)
    prev = set_tracer(tr)
    yield tr
    set_tracer(prev)


def _call(tr, t0, run_ms, tail_ms, eig_ms=0.0, prep_ms=0.1):
    """One plan call at ``t0`` s: plan.run with its prepare, count and tail,
    the tail ending with f14's eigvalsh."""
    run = tr.add_span("plan.run", t0, t0 + run_ms * MS, batch=8, scheme="cuda_fused")
    tr.add_span("plan.prepare", t0, t0 + prep_ms * MS, parent=run)
    tr.add_span("plan.count", t0 + prep_ms * MS, t0 + 2 * prep_ms * MS, parent=run)
    t1 = t0 + run_ms * MS
    tail = tr.add_span("plan.tail", t1 - tail_ms * MS, t1, parent=run, matrices=32)
    tr.add_span("haralick.eigvalsh", t1 - eig_ms * MS, t1, parent=tail, matrices=32)
    return run


def _resident(tr):
    """Warm-up calls, then three calls inside bench.call spans, then a call
    after the window (the reference check's time)."""
    _call(tr, 0.0, 900.0, 800.0)
    _call(tr, 1.0, 700.0, 600.0)
    for k, (run_ms, tail_ms, eig_ms) in enumerate([(4.0, 3.0, 1.0), (5.0, 1.0, 0.5),
                                                   (9.0, 2.0, 0.5)]):
        t0 = 10.0 + k
        tr.add_span("bench.call", t0, t0 + 0.05)
        _call(tr, t0 + 0.001, run_ms, tail_ms, eig_ms)
        tr.add_span("bench.readback", t0 + 0.05, t0 + 0.06)
    _call(tr, 20.0, 500.0, 100.0)


def test_window_leaves_out_spans_before_and_after_the_bench_spans(tracer):
    _resident(tracer)
    spans = ps.window_spans()
    assert [s.t0 for s in spans if s.name == "plan.run"] == [10.001, 11.001, 12.001]
    assert {s.name for s in spans} == {"bench.call", "bench.readback", "plan.run",
                                       "plan.prepare", "plan.count", "plan.tail",
                                       "haralick.eigvalsh"}


def test_resident_readers_take_medians_a_call(tracer):
    _resident(tracer)
    # each tail less its own eigvalsh: 3 - 1, 1 - 0.5, 2 - 0.5
    assert ps.tail_host_ms(None) == pytest.approx(1.5)
    # own time a call: 4 - 3, 5 - 1, 9 - 2; each run less its own tail only
    assert ps.plan_host_ms(None) == pytest.approx(4.0)


def test_plan_host_ms_subtracts_only_its_own_tail(tracer):
    tracer.add_span("bench.call", 0.0, 1.0)
    run = _call(tracer, 0.1, 6.0, 5.0)
    other = tracer.add_span("plan.run", 0.2, 0.2 + 10 * MS)  # a run with no tail
    tracer.add_span("plan.tail", 0.3, 0.3 + 1 * MS, parent=run + 100)  # another run's
    assert run != other
    assert ps.plan_host_ms(None) == pytest.approx(stats.percentile([1.0, 10.0], 50))


def test_tail_host_ms_subtracts_only_its_own_eigvalsh(tracer):
    tracer.add_span("bench.call", 0.0, 1.0)
    _call(tracer, 0.1, 6.0, 5.0, 2.0)
    _call(tracer, 0.2, 9.0, 8.0)  # a tail with an empty eigvalsh
    tail = tracer.add_span("plan.tail", 0.3, 0.3 + 4 * MS)  # a tail with none
    tracer.add_span("haralick.eigvalsh", 0.4, 0.4 + 1 * MS, parent=tail + 100)  # another's
    assert ps.tail_host_ms(None) == pytest.approx(4.0)  # median of 3, 8 and 4


def test_host_readers_take_medians_a_stack(tracer):
    tracer.add_span("bench.next", 0.0, 5.0)
    for k, (co, st, jo) in enumerate([(30, 20, 1), (50, 10, 2), (40, 30, 3)]):
        t = 1.0 + k
        tracer.add_span("pipeline.coalesce", t, t + co * MS, images=8)
        tracer.add_span("pipeline.stage", t + 0.1, t + 0.1 + st * MS, bytes=8 << 24)
        tracer.add_span("pipeline.join", t + 0.2, t + 0.2 + jo * MS)
    assert ps.coalesce_ms(None) == pytest.approx(40.0)
    assert ps.stage_ms(None) == pytest.approx(20.0)
    assert ps.join_ms(None) == pytest.approx(2.0)


def test_queue_wait_is_the_95th_percentile(tracer):
    tracer.add_span("bench.submit", 0.0, 0.001)
    waits = [float(w) for w in range(1, 101)]
    for k, w in enumerate(waits):
        root = tracer.add_span("glcm.request", 0.01 * k, 0.01 * k + 0.5, corr=k)
        tracer.add_span("glcm.queue_wait", 0.01 * k, 0.01 * k + w * MS, parent=root, corr=k)
    tracer.add_span("bench.poll", 2.0, 2.001)
    assert ps.queue_wait_ms(None) == pytest.approx(stats.percentile(waits, 95))


@pytest.mark.parametrize("name", NEW)
def test_reader_is_none_without_its_spans(tracer, name):
    read = _module("metrics", name).read
    assert read(None) is None  # no bench span: no window
    tracer.add_span("bench.call", 0.0, 1.0)
    tracer.add_span("plan.compile", 0.1, 0.2)
    assert read(None) is None
    assert READERS[name]["unit"] == "ms" and len(READERS[name]["workloads"]) == 1


_TRACED = r'''
import json, sys
sys.path.insert(0, ROOT)
from h100_bench import run
run._environment()
TINY = {"config": {"image_size": 64},
        "traffic": {"pool": 16, "rate": 30.0, "max_wait_ms": 40.0, "warmup": 1}}
for cell in CELLS:
    r = run.run(cell, 2**41 + 3, 0.6, True, device="cpu", overrides=TINY)
    print(json.dumps({"cell": cell, "correct": r["correct"], "metrics": r["metrics"]}),
          flush=True)
'''


@pytest.fixture(scope="module")
def traced():
    cells = sorted({c for m in READERS.values() for c in m["workloads"]})
    code = f"ROOT = {str(ROOT)!r}\nCELLS = {cells!r}\n" + _TRACED
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, cwd=ROOT,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return {x["cell"]: x for x in map(json.loads, proc.stdout.splitlines()) if "cell" in x}


@pytest.mark.parametrize("name", NEW)
def test_traced_cpu_run_reports_the_reader_where_the_cpu_has_its_spans(traced, name):
    """On the CPU the host stream neither stages nor joins: those two
    readers find nothing there and their metrics are left out."""
    (cell,) = READERS[name]["workloads"]
    r = traced[cell]
    assert r["correct"] is True
    if name in ("stage_ms.host", "join_ms.host"):
        assert name not in r["metrics"]
    else:
        assert r["metrics"][name]["value"] > 0 and r["metrics"][name]["unit"] == "ms"
