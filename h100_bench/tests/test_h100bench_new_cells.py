"""The L = 256 and smooth-only cells through the harness at a tiny size on
the CPU: ``correct`` with the program, false under the control and under a
fault planted in the count or in f14's solve; and the smooth-only pool.

The runs happen in one fresh interpreter (``_SCENARIOS``), as in
``test_h100bench_run.py``, so that the harness's environment stays there.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from h100_bench import data
from h100_bench.run import _module

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("features-4096-L256", "features-4096-smooth")
FAULTS = ("count", "f14")

_SCENARIOS = r'''
import json, sys
sys.path.insert(0, ROOT)
from h100_bench import run
run._environment()
import torch
import repro_torch.core.backends as backends
import repro_torch.kernels.mcc_kernel as mcc

TINY = {"config": {"image_size": 64}, "traffic": {"pool": 4, "batch": 4, "warmup": 1}}
# The control's gap grows with the image (PERF.md: at 4096 x 4096 on the
# card it reads 3.6e-5 at L = 256 and 7.6e-6 on smooth stacks, against
# limits of 1e-6 and 6e-7). On the CPU the smooth cell's reads 1.8e-6 at
# 64 x 64 already; the L = 256 cell's 1.2e-6 at 64 and 1.1e-6 at 128, within
# 20 % of its limit, and 1.6e-6 at 256, where the test takes it.
CONTROL = {"features-4096-L256": {"config": {"image_size": 256},
                                  "traffic": {"pool": 2, "batch": 2, "warmup": 1}},
           "features-4096-smooth": {"config": {"image_size": 64},
                                    "traffic": {"pool": 2, "batch": 2, "warmup": 1}}}
compute_regions = backends.compute_regions
second = mcc.second_eigenvalue


def fault(kind):
    """Break the count (the votes of the upper half of the reference levels
    lost, as a lost band of the counts would) or f14's solve (its eigenvalue
    off by one part in a thousand)."""
    def regions(backend, img_batch, spec, quant=None):
        out = compute_regions(backend, img_batch, spec, quant=quant).clone()
        out[..., spec.levels // 2:, :] = 0
        return out

    backends.compute_regions = regions if kind == "count" else compute_regions
    mcc.second_eigenvalue = ((lambda p, px, py: second(p, px, py) * 1.001) if kind == "f14"
                             else second)


for cell in CELLS:
    for kind in (None, "control") + FAULTS:
        fault(None if kind == "control" else kind)
        over = CONTROL[cell] if kind == "control" else TINY
        r = run.run(cell, 2**40 + 17, 0.6, kind is None, device="cpu", overrides=over,
                    control=kind == "control")
        print(json.dumps({"cell": cell, "kind": kind, "result": r}), flush=True)
fault(None)
print(json.dumps({"forbidden": run.loaded_forbidden()}), flush=True)
'''


@pytest.fixture(scope="module")
def scenarios():
    code = f"ROOT = {str(ROOT)!r}\nCELLS = {CELLS!r}\nFAULTS = {FAULTS!r}\n" + _SCENARIOS
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    runs = {(x["cell"], x["kind"]): x["result"] for x in lines if "cell" in x}
    return runs, lines[-1]


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_is_correct_and_reports_the_cells_metrics(scenarios, cell):
    r = scenarios[0][(cell, None)]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]
    assert r["checks"]["feature_err"]["value"] < 1e-7  # float32 rounding
    # On the CPU only the program's spans have something to read.
    want = {"f14_host_ms.L256"} if cell == "features-4096-L256" else set()
    assert set(r["metrics"]) == want


@pytest.mark.parametrize("kind", ("control",) + FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_are_not_correct(scenarios, cell, kind):
    r = scenarios[0][(cell, kind)]
    assert r["correct"] is False, r["checks"]
    assert r["checks"]["feature_err"]["value"] > r["checks"]["feature_err"]["limit"]


def test_nothing_of_jax_is_loaded(scenarios):
    assert scenarios[1]["forbidden"] == []


def _roughness(img: torch.Tensor) -> float:
    """Mean absolute step between horizontal neighbours, in gray levels."""
    x = img.to(torch.float32)
    return float((x[:, 1:] - x[:, :-1]).abs().mean())


def test_roughness_tells_the_two_textures_apart():
    imgs = data.images(6, 256, 2**40 + 3, "cpu")
    assert all(_roughness(im) < 8 for im in imgs[0::2])   # smooth
    assert all(_roughness(im) > 60 for im in imgs[1::2])  # random


@pytest.mark.parametrize("seed", [1, 2**33 + 5, 2**40 + 17])
def test_the_smooth_drivers_pool_holds_only_smooth_images(seed):
    loop = _module("drivers", "closed_loop_smooth")
    ctx = types.SimpleNamespace(
        cfg={"image_size": 256, "levels": 32, "pairs": [[1, 0], [1, 45], [4, 0], [4, 45]],
             "quantize": "uniform", "region": "global"},
        traffic={"batch": 2, "pool": 4, "warmup": 1}, seed=seed, device=torch.device("cpu"))
    st = loop.setup(ctx)
    assert st.pool.shape == (4, 2, 256, 256) and st.pool.dtype == torch.uint8
    assert all(_roughness(im) < 8 for im in st.pool.reshape(-1, 256, 256))
    assert sorted(st.order.tolist()) == list(range(4))  # the order visits the whole pool
    assert st.pixels == 2 * 256 * 256
    again = loop.setup(ctx)
    assert torch.equal(again.pool, st.pool) and np.array_equal(again.order, st.order)
