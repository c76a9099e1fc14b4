"""Run one cell of the benchmark once and print its result line.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``: it names a
configuration (``h100_bench/configs/<config>.json``: the deployment) and a
traffic mix (``h100_bench/workloads/<traffic>.json``: the driver and its
parameters). The driver (``h100_bench/drivers/<driver>.py``) makes the
inputs from the seed on the card and warms up (set-up), runs the measured
window, and says which answers the window produced for which inputs. Once
the window has closed, its peak memory read and the program's state freed,
every answer is compared with the plain reference. Each metric of the cell
is read from the run's record by ``h100_bench/metrics/<metric>.py``: with
``--trace 0`` its end-to-end metrics, with ``--trace 1`` its per-layer
metrics, from a traced run (the program's ``Tracer`` on, ``torch.profiler``
over a slice of the window).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: every number compared beside its limit,
also printed as the last lines of standard error. Without a CUDA card, or
with fewer cards than the cell asks for, it exits with code 2 and prints no
result; with ``jax``, ``jaxlib``, ``flax``, ``repro`` or ``benchmarks``
loaded once the window has closed, with code 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def _environment() -> None:
    """Where the program keeps its caches: inside the checkout, at fixed
    paths; the autotuner's store is a file of this run's TMPDIR that no
    tuning writes, so "auto" is the untuned rule. One intra-op thread:
    the load comes from one process with few threads, so that neighbours
    on a shared host move the host-side copies less."""
    os.environ["OMP_NUM_THREADS"] = "1"
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    store = Path(os.environ.get("TMPDIR") or build) / "h100_bench_autotune.json"
    store.unlink(missing_ok=True)
    os.environ["REPRO_TORCH_AUTOTUNE_PATH"] = str(store)
    os.environ["USE_FLAX"] = "0"
    os.environ.pop("REPRO_TRACE", None)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def _load(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as fh:
        return json.load(fh)


def _module(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"h100_bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as fh:
        return json.load(fh)


def cell(name: str, bench: dict | None = None) -> dict:
    """The cell's entry of BENCHMARK.json, with its configuration and
    traffic files loaded."""
    bench = benchmark() if bench is None else bench
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{[w['name'] for w in bench['workloads']]}")
    entry = dict(found[0])
    entry["cfg"] = _load("configs", entry["config"])
    entry["traffic_file"] = _load("workloads", entry["traffic"])
    return entry


def metrics_of(bench: dict, name: str, trace: bool) -> list[dict]:
    """The metrics a run of cell ``name`` reports."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


class Ctx:
    """What a driver is given: the configuration and traffic, the spec, the
    device, the seed, the benchmark's spans and the profiled slice."""

    def __init__(self, cfg: dict, traffic: dict, device, seed: int, trace: bool):
        from repro_torch.core.spec import GLCMSpec
        from repro_torch.obs import trace as obs_trace

        from h100_bench.drivers.common import entry_kwargs
        from h100_bench.trace import Slice, Spans

        self.cfg, self.traffic, self.device, self.seed = cfg, traffic, device, seed
        self.spec = GLCMSpec(levels=cfg["levels"], **entry_kwargs(cfg))
        tracer = obs_trace.Tracer(enabled=trace, capacity=1 << 20)
        obs_trace.set_tracer(tracer)
        self.span = Spans(tracer if trace else None)
        self.slice = Slice(trace, traffic.get("trace_seconds"), device)

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)


def run(name: str, seed: int, seconds: float, trace: bool, *, device=None,
        overrides: dict | None = None, control: bool = False) -> dict:
    """One run of cell ``name``: the result object (see the module
    docstring). ``device="cpu"`` and ``overrides`` ({"config": {...},
    "traffic": {...}} merged into the files) serve the tests; ``control``
    judges the control in the program's place."""
    import torch

    torch.set_num_threads(1)
    t_torch = time.perf_counter()
    from h100_bench import check

    bench = benchmark()
    entry = cell(name, bench)
    overrides = overrides or {}
    cfg = {**entry["cfg"], **overrides.get("config", {})}
    traffic = {**entry["traffic_file"], **overrides.get("traffic", {})}
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=dev)
    t_card = time.perf_counter()
    ctx = Ctx(cfg, traffic, dev, seed, trace)
    driver = _module("drivers", traffic["driver"])

    t_inputs = time.perf_counter()
    state = driver.setup(ctx)
    ctx.sync()
    t_end = time.perf_counter()
    setup_s = t_end - T_START
    setup_note = (f"set-up {setup_s:.3f} s: torch imported {t_torch - T_START:.3f} s, "
                  f"card {t_card - t_torch:.3f} s, repro_torch imported and spec "
                  f"{t_inputs - t_card:.3f} s, inputs and warm-up {t_end - t_inputs:.3f} s")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0

    out = driver.window(ctx, state, seconds)
    ctx.sync()
    ctx.slice.stop()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # The program's state goes before the reference runs.
    driver.release(state)
    from repro_torch.core.plan import plan_cache_clear

    plan_cache_clear()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    answers = out["answers"]
    keys = sorted({k for k, _ in answers})
    inputs = driver.inputs(state, keys)
    expected = check.reference(inputs, cfg, dev)
    ctrl = check.reference(inputs, cfg, dev, torch.float32) if control else None
    err = check.compare(answers, expected, ctrl) if answers else float("inf")
    missing = out["attempted"] - out["failed"] - len(answers)
    checks = {
        "feature_err": {"value": err, "limit": traffic["checks"]["feature_err"]},
        "missing": {"value": missing, "limit": 0},
        "failed": {"value": out["failed"], "limit": 0},
    }
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and bool(answers)

    rec = {
        "cell": name, "config": cfg, "traffic": traffic, "setup_s": setup_s,
        "peak_bytes": peak, "base_bytes": base, "trace": ctx.slice.summary,
        **{k: v for k, v in out.items() if k != "answers"},
    }
    metrics = {}
    for m in metrics_of(bench, name, trace):
        value = _module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    devinfo = {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    if trace and ctx.slice.summary is not None:
        devinfo["busy_s"] = ctx.slice.summary["busy_s"]
        devinfo["window_s"] = ctx.slice.summary["window_s"]
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": devinfo}
    if trace and ctx.slice.summary is not None:
        result["breakdown"] = ctx.slice.summary["breakdown"]
    result["checks"] = checks
    for line in (setup_note, *out.get("notes", ())):
        print(line, file=sys.stderr)
    return result


def loaded_forbidden() -> list[str]:
    """Modules loaded whose top-level name is one the benchmark may not load."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def emit(result: dict) -> None:
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch

    entry = cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"needs {entry['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = loaded_forbidden()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
