"""The port's dry-run machinery end to end on a small fake mesh: the
counterpart of ``tests/test_dryrun_small.py``.

Each fake world (backend "fake", every collective returns at once and moves
nothing) runs in a ``python -c`` child of its own:

* smollm-135m, mixtral-8x7b, mamba2-130m and whisper-medium, reduced to 2
  layers (vocab 256), × train / prefill / decode cells on a (4, 2) world:
  ``build_cell`` + ``lower_cell`` give flops > 0, memory >= 0 and a dict of
  the five collectives; mixtral again with ``grad_accum=2`` (its batch taken
  as two microbatches);
* ``_probe_costs`` at depths (4, 8) against the full-depth count of a
  12-layer reduced smollm: flops, bytes, collective bytes and memory
  exactly equal (eager counting has no rolled loop to undercount);
* ``run_cell`` of smollm-135m × decode_32k on the 256-rank production mesh
  into a temporary report directory, rendered by ``report.md_table``;
* ``perf.main`` for the job "H3-int8-kv-hymba" (hymba-1.5b × decode_32k
  with the int8 KV cache): one report, tagged `__kvq`.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = str(Path(__file__).resolve().parents[1] / "src")

SMALL = textwrap.dedent(
    """
    import dataclasses, json
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell, lower_cell

    mesh = make_host_mesh((4, 2), ("data", "model"))
    out = {}
    cases = [(a, 1) for a in ("smollm-135m", "mixtral-8x7b", "mamba2-130m",
                              "whisper-medium")] + [("mixtral-8x7b", 2)]
    for arch, accum in cases:
        cfg = get_config(arch).reduced(vocab_size=256, num_layers=2)
        cfg = dataclasses.replace(cfg, grad_accum=accum)
        cells = [ShapeCell("t", "train", 32, 8)]
        if accum == 1:
            cells += [ShapeCell("p", "prefill", 32, 8), ShapeCell("d", "decode", 32, 8)]
        for cell in cells:
            prog = build_cell(cfg, cell, mesh)
            rec = lower_cell(prog, mesh)
            out[f"{arch}/{accum}/{cell.name}"] = {
                "flops": rec.flops, "temp": rec.temp_bytes, "peak": rec.peak_bytes,
                "coll": rec.coll_bytes,
                "batch": [list(v.shape) for v in prog.args[-1].values()]
                         if cell.kind == "train" else None}
    print(json.dumps(out))
    """
)

PROBES = textwrap.dedent(
    """
    import json
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh((4, 2), ("data", "model"))
    cfg = get_config("smollm-135m").reduced(vocab_size=256, num_layers=12)
    cell = ShapeCell("t", "train", 32, 8)
    full = dryrun._cell_costs(cfg, cell, mesh)
    probe = dryrun._probe_costs(cfg, cell, mesh)
    print(json.dumps({"full": full, "probe": probe}))
    """
)

RUN_CELL = textwrap.dedent(
    """
    import sys
    from pathlib import Path
    from repro_torch.launch import dryrun, report
    dryrun.REPORTS = Path(sys.argv[1])
    dryrun.start_fake_world(256)
    row = dryrun.run_cell("smollm-135m", "decode_32k", False, device="cpu", verbose=False)
    rows = report.load("single16x16", reports=Path(sys.argv[1]))
    print(report.md_table(rows))
    print(report.collectives_table(rows))
    """
)


PERF = textwrap.dedent(
    """
    import sys
    from pathlib import Path
    from repro_torch.launch import dryrun, perf, report
    dryrun.REPORTS = Path(sys.argv[1])
    assert perf.main(["--only", "H3-int8-kv-hymba", "--device", "cpu"]) == 0
    print(report.md_table(report.load("single16x16", tagged=True, reports=Path(sys.argv[1]))))
    """
)


def _child(script: str, *argv: str) -> str:
    env = {"PYTHONPATH": SRC, "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, "-c", script, *argv], capture_output=True, text=True,
                       timeout=600, env=env)
    assert r.returncode == 0, f"stdout:\n{r.stdout[-3000:]}\nstderr:\n{r.stderr[-3000:]}"
    return r.stdout


def test_dryrun_machinery_small_mesh():
    out = json.loads(_child(SMALL).strip().splitlines()[-1])
    assert len(out) == 4 * 3 + 1
    for key, rec in out.items():
        assert rec["flops"] > 0, key
        assert rec["temp"] >= 0 and rec["peak"] > 0, key
        assert set(rec["coll"]) == {"all-gather", "all-reduce", "reduce-scatter",
                                    "all-to-all", "collective-permute"}, key
        assert sum(rec["coll"].values()) > 0, key   # 8 ranks: something moves
    # grad_accum=2: the batch comes as two microbatches of 4 rows.
    assert out["mixtral-8x7b/2/t"]["batch"] == [[2, 4, 32]]
    assert out["mixtral-8x7b/1/t"]["batch"] == [[8, 32]]


def test_probe_extrapolation_is_exact():
    out = json.loads(_child(PROBES).strip().splitlines()[-1])
    (f, b, c, m), (pf, pb, pc, pm) = out["full"], out["probe"]
    assert pf == f and pb == b and pc == c
    assert pm == m   # the peak too: its place in the step does not move with depth


def test_run_cell_report(tmp_path):
    text = _child(RUN_CELL, str(tmp_path))
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["smollm-135m__decode_32k__single16x16.json"]
    row = json.loads((tmp_path / files[0]).read_text())
    assert row["status"] == "ok" and row["chips"] == 256 and row["probes"]
    assert row["fits_80gb_hbm"] is True and row["hlo_flops"] > 0
    assert "| smollm-135m | decode_32k |" in text and "| ✓ |" in text
    assert text.count("| smollm-135m | decode_32k |") == 2


def test_perf_job_writes_a_tagged_report(tmp_path):
    text = _child(PERF, str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "hymba-1.5b__decode_32k__single16x16__kvq.json"]
    row = json.loads((tmp_path / "hymba-1.5b__decode_32k__single16x16__kvq.json").read_text())
    assert row["status"] == "ok" and row["hlo_bytes"] > 0
    assert "| hymba-1.5b | decode_32k/kvq |" in text
