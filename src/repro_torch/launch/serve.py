"""Serving driver: batched generation with the LM engine, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --batch 4 --prompt-len 8 --max-new 16 [--full] [--device cpu]

``--full`` runs the published config (default: ``cfg.reduced()``); the
weights and prompts are random, from seed 0.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.models import build_model
from repro_torch.serve.engine import Engine, ServeConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=ARCHS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the CPU")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    api = build_model(cfg, device=args.device)
    model = api.init(torch.Generator(api.device).manual_seed(0))
    eng = Engine(cfg, model, ServeConfig(
        max_new_tokens=args.max_new, temperature=args.temperature,
        s_cache=args.prompt_len + args.max_new + cfg.meta_tokens + 8), device=api.device)

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    enc = (rng.normal(size=(args.batch, args.prompt_len, cfg.d_model)).astype(np.float32)
           if cfg.is_encoder_decoder else None)
    t0 = time.perf_counter()
    out = eng.generate(prompts, enc_embeds=enc)   # ends in a copy to the host
    dt = time.perf_counter() - t0
    toks = args.batch * args.max_new
    where = torch.cuda.get_device_name(api.device) if api.device.type == "cuda" else "cpu"
    print(f"[serve] {cfg.name} on {where}: generated {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s, batch={args.batch})")
    print("[serve] sample continuations:", out[:2, args.prompt_len:].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
