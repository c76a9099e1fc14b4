"""Find the knee of the serving cell: the highest steady Poisson rate whose
backlog does not grow over a window.

    python3 h100_bench/sweep.py --workload serve-4096-bursty --seed 7 \
        --seconds 8 --rates 60,80,100,120,140

Set-up is the cell's own (its configuration, pool and engine). It first
times ``--batches`` full-batch dispatches (pad + launch + readback: the
submit call that fills a batch) and sets the deadline to twice their
median. Then, for each rate, it runs the cell's open loop with steady
arrivals (no bursts) for ``--seconds`` and prints one JSON line: the rate,
the requests due and served, the backlog (due but not served) at half
and at the end of the window, p50 and p95 latency from the due time, and
the engine's batches. A rate whose backlog at the end exceeds its backlog
at half time by more than a batch is past the knee.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from h100_bench import run  # noqa: E402


def backlog(done, t: float) -> int:
    return sum(1 for due, end in done if due <= t < end)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="serve-4096-bursty")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rates", default="60,80,100,120,140")
    ap.add_argument("--batches", type=int, default=12)
    ap.add_argument("--device", default=None)
    ap.add_argument("--image-size", type=int, default=None)
    args = ap.parse_args(argv)
    run._environment()
    import torch

    from h100_bench import stats
    from repro_torch.serve.engine import GLCMEngine

    entry = run.cell(args.workload)
    cfg = dict(entry["cfg"])
    if args.image_size:
        cfg["image_size"] = args.image_size
    traffic = dict(entry["traffic_file"])
    dev = torch.device(args.device or "cuda")
    ctx = run.Ctx(cfg, traffic, dev, args.seed, False)
    driver = run._module("drivers", traffic["driver"])
    st = driver.setup(ctx)

    eng = GLCMEngine(st.engine.cfg, device=dev)
    batch, times = traffic["batch"], []
    for b in range(args.batches):
        for i in range(batch - 1):
            eng.submit(st.host[(b * batch + i) % len(st.host)])
        t0 = time.perf_counter()
        eng.submit(st.host[(b * batch + batch - 1) % len(st.host)])
        times.append((time.perf_counter() - t0) * 1e3)
    full_ms = stats.percentile(times, 50)
    s = eng.stats()["workloads"][0]
    print(json.dumps({"full_batch_ms": times, "full_batch_ms_p50": full_ms,
                      "pad_ms_p50": s["pad_ms"]["p50"], "launch_ms_p50": s["launch_ms"]["p50"],
                      "readback_ms_p50": s["readback_ms"]["p50"],
                      "max_wait_ms": 2 * full_ms}), flush=True)

    scfg = type(st.engine.cfg)(**{**st.engine.cfg.__dict__, "max_wait_ms": 2 * full_ms})
    for rate in (float(r) for r in args.rates.split(",")):
        st.engine = GLCMEngine(scfg, device=dev)
        ctx.traffic = {**traffic, "rate": rate, "burst_factor": 1.0, "burst_s": 0.0,
                       "period_s": None}
        out = driver.window(ctx, st, args.seconds)
        lat = out["latencies_ms"]
        e = out["engine"]
        print(json.dumps({
            "rate": rate, "due": out["attempted"], "served": len(lat),
            "backlog_half": backlog(out["done"], args.seconds / 2),
            "backlog_end": backlog(out["done"], args.seconds),
            "p50_ms": stats.percentile(lat, 50) if lat else None,
            "p95_ms": stats.percentile(lat, 95) if lat else None,
            "late_ms_p95": stats.percentile(out["late_ms"], 95) if out["late_ms"] else None,
            "batches": e["batches"], "deadline_dispatches": e["deadline_dispatches"],
            "occupancy": e["batch_occupancy"], "elapsed_s": out["elapsed_s"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
