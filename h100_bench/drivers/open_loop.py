"""Open loop into one ``GLCMEngine``: independent users of a texture
service.

Set-up makes ``pool`` images on the device from the seed, copies them once
to pageable host memory, builds the engine (the configuration's spec,
``batch`` with its power-of-two buckets, ``max_wait_ms``) and warms every
bucket on them through the engine's own API. The window's arrivals come from
``h100_bench.arrivals`` (the traffic's ``rate``, ``burst_factor``,
``burst_s``, ``period_s``): each request is submitted when it is due, and
between arrivals the loop sleeps until the next arrival or the engine's
``next_deadline()`` and polls. A request's latency runs from when it was
due to when the call that completed it returned, its features in host
memory. Once the last arrival is in, the loop waits for every request, up
to a minute past the window.
"""

from __future__ import annotations

import math
import time
import types

import numpy as np

from h100_bench import arrivals, data, stats
from h100_bench.drivers import common
from repro_torch.core.plan import bucket_sizes
from repro_torch.serve.engine import GLCMEngine, GLCMServeConfig

GRACE_S = 60.0


def setup(ctx):
    cfg, t = ctx.cfg, ctx.traffic
    size, pool = cfg["image_size"], t["pool"]
    dev_imgs = data.images(pool, size, ctx.seed, ctx.device)
    host = dev_imgs.cpu().numpy()
    del dev_imgs
    scfg = GLCMServeConfig(spec=ctx.spec, image_shape=(size, size), batch_size=t["batch"],
                           features=True, max_wait_ms=t["max_wait_ms"],
                           max_results=1 << 20, stats_window=1 << 20)
    warm = GLCMEngine(scfg, device=ctx.device)
    for b in bucket_sizes(t["batch"]):
        warm.map([host[j % pool] for j in range(b)])
    rng = np.random.default_rng(int(ctx.seed) % (1 << 64))
    return types.SimpleNamespace(host=host, engine=GLCMEngine(scfg, device=ctx.device),
                                 picks=rng.integers(0, pool, size=1 << 20))


def window(ctx, st, seconds: float) -> dict:
    t = ctx.traffic
    due = arrivals.schedule(seconds, t["rate"], ctx.seed, burst_factor=t["burst_factor"],
                            burst_s=t["burst_s"], period_s=t["period_s"])
    eng, n = st.engine, len(due)
    pending: dict[int, tuple[int, int]] = {}  # ticket -> (arrival, image)
    answers, latencies, done, late, notes = [], [], [], [], []
    failed = seen = j = 0
    ctx.slice.start()
    t0 = time.monotonic()

    def collect():
        nonlocal seen
        new = eng.batches_dispatched - seen
        if not new:
            return
        now = time.monotonic()
        for entry in list(eng.dispatch_log)[-new:]:
            for tk in entry["tickets"]:
                k, img = pending.pop(tk)
                answers.append((img, eng.result(tk)))
                latencies.append((now - t0 - due[k]) * 1e3)
                done.append((due[k], now - t0))
        seen = eng.batches_dispatched

    while j < n or pending:
        now = time.monotonic()
        if now - t0 > seconds + GRACE_S:
            notes.append(f"{len(pending)} requests still pending {GRACE_S} s past the window")
            break
        if j < n and t0 + due[j] <= now:
            late.append((now - t0 - due[j]) * 1e3)
            img = int(st.picks[j])
            j += 1
            try:
                with ctx.span("bench.submit"):
                    tk = eng.submit(st.host[img])
            except Exception as exc:  # counted as failed; the loop goes on
                failed += 1
                notes.append(f"submit failed: {exc!r}")
                continue
            pending[tk] = (j - 1, img)
            collect()
            continue
        try:
            with ctx.span("bench.poll"):
                eng.poll()
                if j >= n and pending and eng.next_deadline() is None:
                    eng.flush()
        except Exception as exc:  # the requests it held never come
            notes.append(f"dispatch failed: {exc!r}")
        collect()
        deadline = eng.next_deadline()
        nxt = min(t0 + due[j] if j < n else math.inf,
                  deadline if deadline is not None else math.inf)
        wait = nxt - time.monotonic()
        if math.isfinite(wait) and wait > 0:
            with ctx.span("bench.wait"):
                time.sleep(wait)
    elapsed = time.monotonic() - t0
    period = t["period_s"] or seconds
    by = {}
    for d, end in done:
        by.setdefault(int(d // period), []).append((end - d) * 1e3)
    notes.append(f"p95 ms by {period:g} s of arrivals: " + " ".join(
        f"{stats.percentile(v, 95):.1f}" for _, v in sorted(by.items())))
    if late:
        notes.insert(0, f"generator ran late by p50 {stats.percentile(late, 50):.3f} ms, "
                        f"p95 {stats.percentile(late, 95):.3f} ms, max {max(late):.3f} ms "
                        f"over {len(late)} arrivals")
    return {"attempted": n, "failed": failed, "answers": answers, "elapsed_s": elapsed,
            "pixels": len(answers) * common.pixels(ctx.cfg),
            "latencies_ms": latencies, "late_ms": late, "done": done,
            "engine": eng.stats()["workloads"][0], "notes": notes}


def release(st) -> None:
    st.engine = None


def inputs(st, keys) -> dict:
    import torch

    return {k: torch.from_numpy(st.host[k]) for k in keys}
