"""The arrival schedule, the trace reduction and the metric readers, on
synthetic inputs."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from h100_bench import arrivals, roofline, stats, trace
from h100_bench.reference import glcm as ref
from h100_bench.run import _module

HERE = Path(__file__).resolve().parents[1]
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
SERVE = json.loads((HERE / "workloads" / "serve-4096-bursty.json").read_text())
BURSTY = dict(burst_factor=SERVE["burst_factor"], burst_s=SERVE["burst_s"],
              period_s=SERVE["period_s"])


@pytest.mark.parametrize("seed", [0, 2**33 + 5, 2**62 + 1])
def test_schedule_is_seeded_and_repeats(seed):
    a = arrivals.schedule(12, SERVE["rate"], seed, **BURSTY)
    b = arrivals.schedule(12, SERVE["rate"], seed, **BURSTY)
    np.testing.assert_array_equal(a, b)
    assert np.all(np.diff(a) >= 0) and a[0] >= 0 and a[-1] < 12


def test_every_seed_offers_the_same_work_in_another_order():
    runs = [arrivals.schedule(12, SERVE["rate"], s, **BURSTY) for s in (1, 2, 3)]
    assert len({len(r) for r in runs}) == 1
    assert not np.array_equal(runs[0], runs[1])
    counts = [np.histogram(r, bins=[0, 4, 6, 10, 12])[0] for r in runs]
    for c in counts[1:]:
        np.testing.assert_array_equal(c, counts[0])
    quiet, burst = counts[0][0], counts[0][1]
    assert burst / 2 == pytest.approx(SERVE["burst_factor"] * quiet / 4, rel=0.05)


def test_steady_schedule_has_the_rate():
    due = arrivals.schedule(10, 50.0, 9)
    assert len(due) == 500


def test_percentile_is_numpys_default():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 50) == pytest.approx(np.percentile(xs, 50))
    assert stats.percentile(xs, 95) == pytest.approx(np.percentile(xs, 95))


@pytest.mark.parametrize("name,short", [
    ("void march_kernel<unsigned char, unsigned char, true>(unsigned char const*, float "
     "const*, int*, glcm::march::Geometry, glcm::march::Offsets)", "march_kernel"),
    ("void (anonymous namespace)::staged_kernel<unsigned char>(unsigned char const*)",
     "staged_kernel"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float> >(float)",
     "reduce_kernel"),
    ("Memcpy HtoD (Pinned -> Device)", "Memcpy HtoD (Pinned -> Device)"),
])
def test_short_names(name, short):
    assert roofline.short_name(name) == short


class _Event:
    def __init__(self, name, start, dur, cuda, annotation=False):
        self._v = (name, start, dur, cuda, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[3] else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._v[4]


def test_summary_of_a_slice():
    ev = [
        _Event("bench.call", 0, 1000, False, True),
        _Event("bench.call", 100, 900, True, True),       # the device's copy of it
        _Event("aten::amin", 50, 100, False),
        _Event("void march_kernel<int>(int)", 100, 300, True),
        _Event("reduce_kernel", 300, 200, True),           # overlaps the first
        _Event("Memcpy DtoH (Device -> Pageable)", 900, 100, True),
    ]
    s = trace.summarize(ev, 2e-6, 1)
    assert s["busy_s"] == pytest.approx(500e-9)
    assert s["ops"]["march_kernel"] == {"s": pytest.approx(300e-9), "n": 1}
    assert "bench.call" not in s["ops"]
    assert s["breakdown"]["idle_gaps"][0][0].startswith("bench.call")
    assert s["breakdown"]["idle_gaps"][0][1] == pytest.approx(400e-9)


def _rec(ops, calls=4, **kw):
    cfg = json.loads((HERE / "configs" / "paper-2d-4096-L32.json").read_text())
    return {"config": cfg, "traffic": {"batch": 8}, "pixels": 0, "elapsed_s": 1.0,
            "peak_bytes": 0, "base_bytes": 0, "setup_s": 1.0,
            "trace": {"ops": ops, "calls": calls, "busy_s": 0.25, "window_s": 1.0}, **kw}


def test_roofline_reader_counts_launches_against_the_frozen_bound():
    rec = _rec({"march_kernel": {"s": 4e-3, "n": 4}, "reduce_kernel": {"s": 1e-3, "n": 8},
                "Memcpy HtoD (Pinned -> Device)": {"s": 2e-3, "n": 4}})
    nbytes, ops = roofline.fused_work(8, 4096, 4096, 1, 32, ref.offsets(rec["config"]["pairs"]))
    assert nbytes == 8 * 4096**2 + 8 * 8 + 8 * 4 * 32 * 32 * 4
    want = 100 * 4 * roofline.bound_s(nbytes, ops) / 4e-3
    assert _module("metrics", "glcm_fused_roofline").read(rec) == pytest.approx(want)
    assert _module("metrics", "tail_device_ms").read(rec) == pytest.approx(0.25)
    assert _module("metrics", "launches_per_call").read(rec) == pytest.approx(4.0)
    assert _module("metrics", "h2d_ms_per_stack").read(rec) == pytest.approx(4.0)
    assert _module("metrics", "idle_share.resident").read(rec) == pytest.approx(75.0)
    assert _module("metrics", "glcm_window_roofline").read(rec) is None


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_readers_find_nothing_without_a_trace(metric):
    rec = _rec({}, calls=0)
    rec["trace"] = None
    assert _module("metrics", metric).read(rec) is None


def test_serving_readers():
    eng = {"pad_ms": {"p50": 45.0, "n": 3}, "batch_occupancy": {8: {8: 2}, 4: {3: 2}}}
    rec = _rec({}, engine=eng, latencies_ms=list(range(1, 101)))
    assert _module("metrics", "pad_ms.serve").read(rec) == 45.0
    assert _module("metrics", "occupancy.serve").read(rec) == pytest.approx(100 * 22 / 24)
    assert _module("metrics", "p95_ms").read(rec) == pytest.approx(95.05)
    assert _module("metrics", "p50_ms").read(rec) == pytest.approx(50.5)


def test_run_seconds_fit_a_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
