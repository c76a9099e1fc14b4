"""Closed loop over a host stream: the paper's Scheme 3.

Set-up makes ``pool`` images on the device from the seed and copies them
once to pageable host memory. In the window ``repro_torch.glcm_feature_stream``
runs over those host images, in a seeded order cycled over the pool, with
the configuration's spec, ``prefetch`` and ``batch_size=batch``; each
result is read back to the host as it is yielded. Images are fed until the
window's time is up, at a whole stack, so no stack is padded.
"""

from __future__ import annotations

import time
import types

import repro_torch
from h100_bench import data
from h100_bench.drivers import common


def _stream(ctx, images):
    return repro_torch.glcm_feature_stream(
        images, spec=ctx.spec, prefetch=ctx.traffic["prefetch"],
        batch_size=ctx.traffic["batch"], device=ctx.device)


def setup(ctx):
    cfg, t = ctx.cfg, ctx.traffic
    dev_imgs = data.images(t["pool"], cfg["image_size"], ctx.seed, ctx.device)
    host = dev_imgs.cpu().numpy()
    del dev_imgs
    st = types.SimpleNamespace(host=host, order=common.order(t["pool"], ctx.seed),
                               pixels=common.pixels(cfg))
    warm = [host[i % t["pool"]] for i in range(t["warmup"] * t["batch"])]
    for out in _stream(ctx, warm):
        out.cpu()
    return st


def window(ctx, st, seconds: float) -> dict:
    batch = ctx.traffic["batch"]
    fed: list[int] = []
    ctx.slice.start()
    t0 = time.perf_counter()
    end = t0 + seconds

    def feed():
        k = 0
        while k % batch or time.perf_counter() < end:
            i = int(st.order[k % len(st.order)])
            fed.append(i)
            k += 1
            yield st.host[i]

    answers, ends, notes, failed = [], [], [], 0
    it = _stream(ctx, feed())
    while True:
        try:
            with ctx.span("bench.next"):
                out = next(it)
        except StopIteration:
            break
        except Exception as exc:  # the stream is broken: the rest never comes
            failed += 1
            notes.append(f"stream failed after {len(answers)} results: {exc!r}")
            break
        with ctx.span("bench.readback"):
            host = out.cpu().numpy()
        answers.append((fed[len(answers)], host))
        ends.append(time.perf_counter())
        ctx.slice.tick()
    elapsed = time.perf_counter() - t0
    notes.append(common.chunk_note(ends, st.pixels, t0))
    return {"attempted": len(fed), "failed": failed, "answers": answers,
            "elapsed_s": elapsed, "pixels": len(answers) * st.pixels, "notes": notes}


def release(st) -> None:
    pass


def inputs(st, keys) -> dict:
    import torch

    return {k: torch.from_numpy(st.host[k]) for k in keys}
