"""The harness end to end at a tiny size on the CPU: the contract's result
line, ``correct`` false under the control and under each fault the cells
can have, and nothing of JAX or the JAX package loaded.

The runs happen in one fresh interpreter (``_SCENARIOS``), so that its
``sys.modules`` holds only what the harness and the port loaded.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("features-4096-resident", "texture-map-4096", "features-4096-host",
         "serve-4096-bursty")
FAULTS = ("alter", "half", "swap")

_SCENARIOS = r'''
import json, sys
sys.path.insert(0, ROOT)
from h100_bench import run
run._environment()
import torch
import repro_torch.core.backends as backends
import repro_torch.core.plan as plan

TINY = {"config": {"image_size": 64},
        "traffic": {"pool": 16, "rate": 30.0, "max_wait_ms": 40.0, "warmup": 1}}
# The control's gap grows with the counts a matrix holds: at 64 x 64 it
# reads ~2e-6, under the limits set at 4096 x 4096 (where it reads 1.4e-4,
# and 0.08 on a map). These sizes are the smallest at which it reads above
# them on the CPU (2.0e-5 to 2.6e-5 for whole images, 4.7e-4 for maps).
CONTROL = {"config": {"image_size": 1024},
           "traffic": {"pool": 2, "batch": 2, "rate": 4.0, "max_wait_ms": 100.0,
                       "warmup": 1}}
CONTROL_MAP = {"config": {"image_size": 256}, "traffic": {"pool": 2, "warmup": 1}}
compute_regions = backends.compute_regions
haralick = plan.haralick_features


def fault(kind):
    """Break the timed path underneath the entry points."""
    def regions(backend, img_batch, spec, quant=None):
        out = compute_regions(backend, img_batch, spec, quant=quant)
        axis = 0 if out.shape[0] > 1 else 1          # images, or a map's grid rows
        n = out.shape[axis]
        if kind == "half":                           # half the batch left out
            keep = out.narrow(axis, 0, (n + 1) // 2)
            out = torch.cat([keep, keep], dim=axis).narrow(axis, 0, n)
        else:                                        # answers to the wrong inputs
            out = out.flip(axis)
        return out

    def altered(mats, **kw):                         # an answer altered where made
        out = haralick(mats, **kw).clone()
        out.view(-1, out.shape[-1])[0] += 1e-3
        return out

    plan.haralick_features = altered if kind == "alter" else haralick
    backends.compute_regions = compute_regions if kind in (None, "alter") else regions


for cell in CELLS:
    for kind in (None, "control") + FAULTS:
        fault(None if kind == "control" else kind)
        over = TINY
        if kind == "control":
            over = CONTROL_MAP if cell.startswith("texture") else CONTROL
        r = run.run(cell, 2**40 + 17, 0.6, kind is None, device="cpu", overrides=over,
                    control=kind == "control")
        print(json.dumps({"cell": cell, "kind": kind, "result": r}), flush=True)
fault(None)
print(json.dumps({"forbidden": run.loaded_forbidden(),
                  "modules": sorted({m.split(".")[0] for m in sys.modules})}), flush=True)
'''


@pytest.fixture(scope="module")
def scenarios():
    code = (f"ROOT = {str(ROOT)!r}\nCELLS = {CELLS!r}\nFAULTS = {FAULTS!r}\n" + _SCENARIOS)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    runs = {(x["cell"], x["kind"]): x["result"] for x in lines if "cell" in x}
    return runs, lines[-1]


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_is_the_contracts(scenarios, cell):
    r = scenarios[0][(cell, None)]
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                       "checks"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes", "busy_s",
                                "window_s"}
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("kind", ("control",) + FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_are_not_correct(scenarios, cell, kind):
    r = scenarios[0][(cell, kind)]
    assert r["correct"] is False, r["checks"]


def test_nothing_of_jax_or_the_jax_package_is_loaded(scenarios):
    last = scenarios[1]
    assert last["forbidden"] == []
    assert "repro_torch" in last["modules"] and "torch" in last["modules"]
    assert not {"jax", "jaxlib", "flax", "repro", "benchmarks"} & set(last["modules"])


def test_command_without_a_card_exits_nonzero_and_prints_nothing():
    proc = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload", CELLS[0], "--seed", str(2**33),
         "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_command_without_the_program_exits_nonzero(tmp_path):
    shutil.copytree(ROOT / "h100_bench", tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
        timeout=300, env=env)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
