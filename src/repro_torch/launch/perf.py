"""Perf hillclimbing — re-runs the chosen cells with their optimization
variants through the dry run and writes tagged reports next to the
baselines (``reports/dryrun_torch/``).

    PYTHONPATH=src python -m repro_torch.launch.perf [--only H1] [--device cpu]

The port's counterpart of ``repro.launch.perf``, with its nine jobs, their
overrides and their tags. It starts the dry run's fake world of 256 ranks
(``launch.dryrun.start_fake_world``).

H1 arctic-480b × train_4k   (paper-representative: MoE dispatch IS the
   paper's large-L voting problem) — einsum (conflict-free one-hot
   dispatch) vs indexed gather.
H2 whisper-medium × prefill_32k (most collective-bound) — the hoisted
   memory gather, and head-TP attention (16 heads == 16 model shards).
H3 llava-next-34b × decode_32k (worst roofline fraction / memory-bound) —
   bf16 KV cache vs int8+scales (kv_quant); likewise hymba and arctic.
"""

from __future__ import annotations

import argparse

from repro_torch.launch.dryrun import run_cell, start_fake_world
from repro_torch.launch.mesh import required_devices

JOBS = [
    # (name, arch, shape, overrides, tag)
    ("H1-einsum-dispatch", "arctic-480b", "train_4k",
     {"moe_dispatch": "einsum"}, "einsum"),
    ("H2-hoisted-memory-gather", "whisper-medium", "prefill_32k",
     {}, "hoisted"),
    ("H3-int8-kv", "llava-next-34b", "decode_32k",
     {"kv_quant": True}, "kvq"),
    ("H3-int8-kv-hymba", "hymba-1.5b", "decode_32k",
     {"kv_quant": True}, "kvq"),
    # fixes found by the baseline sweep:
    ("SSD-scan-sharding-fix", "hymba-1.5b", "train_4k", {}, "ssdfix"),
    ("mixtral-gather-train", "mixtral-8x7b", "train_4k", {}, "gather"),
    ("mixtral-gather-prefill", "mixtral-8x7b", "prefill_32k", {}, "gather"),
    ("H2-heads-tp", "whisper-medium", "prefill_32k", {}, "headstp"),
    ("H3-arctic-kvq", "arctic-480b", "decode_32k",
     {"kv_quant": True}, "kvq"),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    start_fake_world(required_devices(multi_pod=False))
    for name, arch, shape, overrides, tag in JOBS:
        if args.only and args.only not in name:
            continue
        print(f"\n=== {name} ===")
        run_cell(arch, shape, False, overrides=overrides, tag=tag, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
