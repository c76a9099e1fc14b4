"""Closed loop, one caller, inputs resident on the device.

Set-up makes ``pool`` inputs on the device from the seed, each a stack of
``batch`` images (or one image where ``batch`` is 1), and warms the entry
point on them. In the window the caller calls ``repro_torch.glcm_features``
on the next input of a seeded order of the pool and reads the features back
to the host before its next call.
"""

from __future__ import annotations

import time
import types

import repro_torch
from h100_bench import data
from h100_bench.drivers import common


def setup(ctx):
    cfg, t = ctx.cfg, ctx.traffic
    size, batch, pool = cfg["image_size"], t["batch"], t["pool"]
    imgs = data.images(pool * batch, size, ctx.seed, ctx.device)
    imgs = imgs.view((pool, batch, size, size) if batch > 1 else (pool, size, size))
    kw = common.entry_kwargs(cfg)

    def call(x):
        return repro_torch.glcm_features(x, cfg["levels"], device=ctx.device, **kw)

    for i in range(t["warmup"]):
        call(imgs[i % pool]).cpu()
    return types.SimpleNamespace(pool=imgs, call=call, order=common.order(pool, ctx.seed),
                                 pixels=batch * common.pixels(cfg))


def window(ctx, st, seconds: float) -> dict:
    answers, ends, notes, failed, k = [], [], [], 0, 0
    ctx.slice.start()
    t0 = time.perf_counter()
    end = t0 + seconds
    while time.perf_counter() < end:
        i = int(st.order[k % len(st.order)])
        k += 1
        try:
            with ctx.span("bench.call"):
                out = st.call(st.pool[i])
            with ctx.span("bench.readback"):
                host = out.cpu().numpy()
        except Exception as exc:  # counted as failed; the window goes on
            failed += 1
            notes.append(f"call {k - 1} failed: {exc!r}")
            continue
        answers.append((i, host))
        ends.append(time.perf_counter())
        ctx.slice.tick()
    elapsed = time.perf_counter() - t0
    notes.append(common.chunk_note(ends, st.pixels, t0))
    return {"attempted": k, "failed": failed, "answers": answers, "elapsed_s": elapsed,
            "pixels": len(answers) * st.pixels, "notes": notes[:3]}


def release(st) -> None:
    st.call = None


def inputs(st, keys) -> dict:
    return {k: st.pool[k] for k in keys}
