"""End-to-end training entry point, on the card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 200 [--full] [--ckpt-dir DIR] [--device cpu]

``--reduced`` (the default) runs the CPU-scale smoke config; ``--full`` the
published config. The model trains from a seeded init on synthetic tokens
(``data.tokens.SyntheticTokens``) on one process; ``train.loop.train(...,
mesh=)`` is the sharded entry, called by every rank of a mesh.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.core.plan import resolve_device
from repro_torch.train.loop import TrainLoopConfig, train


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=ARCHS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the CPU")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[train] arch={cfg.name} reduced={args.reduced} device={where}")
    out = train(cfg, TrainLoopConfig(
        total_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, grad_accum=args.grad_accum,
        seed=args.seed), device=dev)
    hist = out["history"]
    print(f"[train] done: loss {hist[0]['loss']:.4f} → {hist[-1]['loss']:.4f} "
          f"over {len(hist)} logged steps; stragglers={out['stragglers']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
