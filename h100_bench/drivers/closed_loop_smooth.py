"""Closed loop, one caller, inputs resident on the device, every image a
smooth texture.

The same loop as ``closed_loop`` (its window, release and inputs), on a
pool made only of ``data``'s smooth textures: adjacent pixels are alike, so
the votes of every offset pile onto the GLCM's diagonal band.
"""

from __future__ import annotations

import types

import torch

import repro_torch
from h100_bench import data
from h100_bench.drivers import common
from h100_bench.drivers.closed_loop import inputs, release, window

__all__ = ["setup", "window", "release", "inputs"]


def setup(ctx):
    cfg, t = ctx.cfg, ctx.traffic
    size, batch, pool = cfg["image_size"], t["batch"], t["pool"]
    gen = torch.Generator(device=ctx.device).manual_seed(int(ctx.seed) % (1 << 64))
    imgs = data._smooth(pool * batch, size, gen, ctx.device)
    imgs = imgs.view((pool, batch, size, size) if batch > 1 else (pool, size, size))
    kw = common.entry_kwargs(cfg)

    def call(x):
        return repro_torch.glcm_features(x, cfg["levels"], device=ctx.device, **kw)

    for i in range(t["warmup"]):
        call(imgs[i % pool]).cpu()
    return types.SimpleNamespace(pool=imgs, call=call, order=common.order(pool, ctx.seed),
                                 pixels=batch * common.pixels(cfg))
