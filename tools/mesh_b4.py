#!/usr/bin/env python3
"""Training steps of the archs whose MoE layer or Mamba2 mixer is sharded
over "model" (mesh row B4), on a (2, 2) ("data", "model") mesh of 4 gloo
ranks that share one NVIDIA card (NCCL refuses two ranks on one card).

    python3 tools/mesh_b4.py [--src DIR]

Each arch of ``ARCHS`` (with its cuts of depth) runs ``train(mesh=)`` for
``STEPS`` steps of seeded ``SyntheticTokens`` (``BATCH`` x ``SEQ``) at its
published widths and ``grad_accum``, then one more step under
``CommDebugMode`` (:func:`train_counted`, which ``chip_smoke.py``'s mesh
phase also uses). It prints one JSON line per arch: the losses, rank 0's
synchronised ms a step (the median after the first), tokens/s, each rank's
peak allocation, the collectives of one step by kind, and each rank's
kernel launches (none: this path runs plain PyTorch). ``--src`` is the
``src`` directory of the tree to measure (default: this checkout's), so
that two trees are compared in one call on one card: unpack the other with
``git archive`` and alternate the two.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
MESH_SHAPE = (2, 2)
# arch: config overrides (the cuts). mixtral-8x7b at full width, one of its
# 32 layers: four ranks of 47B parameters do not fit one card.
ARCHS = {"mamba2-130m": {}, "mixtral-8x7b": {"num_layers": 1}}
STEPS = 3
BATCH = 8
SEQ = 1024
# The wait for a world's ranks, and their gloo timeout: mixtral's four steps
# of four microbatches take ~130 s over gloo.
RANK_TIMEOUT_S = 600


def train_counted(cfg, loop, mesh, device) -> tuple[dict, dict]:
    """``train(cfg, loop, mesh=)`` on ``device``, then one more step of the
    run's data (its batch at ``loop.total_steps``) under ``CommDebugMode``:
    (train's result, {"losses", "step_ms", "grad_norms", "peak_gb",
    "counted_step_ms", "collectives"}). The step times are synchronised;
    ``peak_gb`` is the run's peak allocation on the card."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.data.tokens import SyntheticTokens
    from repro_torch.launch.steps import make_train_step
    from repro_torch.train.loop import on_mesh, shard_batch, train

    hist: list[dict] = []
    torch.cuda.reset_peak_memory_stats()
    res = train(cfg, loop, mesh=mesh, device=device, log_fn=lambda s, m: hist.append(m))
    peak = torch.cuda.max_memory_allocated()
    step, _ = make_train_step(dataclasses.replace(cfg, grad_accum=loop.grad_accum),
                              total_steps=loop.total_steps, device=device)
    batch = SyntheticTokens(cfg.vocab_size, seq_len=loop.seq_len,
                            global_batch=loop.global_batch, seed=loop.seed).batch_at(loop.total_steps)
    comm = CommDebugMode()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with comm, on_mesh(cfg, mesh):
        step(res["params"], res["opt"], shard_batch(cfg, batch, mesh, device,
                                                    accum=loop.grad_accum))
    torch.cuda.synchronize()
    return res, {"losses": [h["loss"] for h in hist],
                 "step_ms": [h["step_time_s"] * 1e3 for h in hist],
                 "grad_norms": [h.get("grad_norm") for h in hist],
                 "peak_gb": peak / 1e9,
                 "counted_step_ms": (time.perf_counter() - t0) * 1e3,
                 "collectives": {str(k): v for k, v in comm.get_comm_counts().items()}}


def _args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--arch", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()


def _rank(args) -> None:
    """One rank (a child process of :func:`main`): writes ``args.out``."""
    sys.path.insert(0, args.src)
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels.glcm_kernel import glcm_fused, glcm_volume, glcm_vote, glcm_window
    from repro_torch.kernels.histogram_kernel import histogram
    from repro_torch.launch.mesh import make_compat_mesh
    from repro_torch.train.loop import TrainLoopConfig

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{args.store}", rank=args.rank,
                            world_size=WORLD, timeout=timedelta(seconds=RANK_TIMEOUT_S))
    try:
        cfg = dataclasses.replace(get_config(args.arch), **ARCHS[args.arch])
        mesh = make_compat_mesh(MESH_SHAPE, ("data", "model"))
        loop = TrainLoopConfig(total_steps=STEPS, log_every=1, seq_len=SEQ,
                               global_batch=BATCH, grad_accum=cfg.grad_accum)
        kernels = (glcm_vote, glcm_fused, glcm_window, glcm_volume, histogram)
        for k in kernels:
            k.launches = 0
        res, out = train_counted(cfg, loop, mesh, dev)
        out.update(params=sum(p.numel() for p in res["params"].parameters()),
                   grad_accum=cfg.grad_accum,
                   launches={k.__name__: k.launches for k in kernels})
        Path(args.out).write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _stop(procs) -> None:
    """Kill each rank's process group (a rank's own children included)."""
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()


def _run_arch(args, arch: str, work: Path) -> dict:
    store = work / f"{arch}.store"
    store.unlink(missing_ok=True)
    outs = [work / f"{arch}.rank{r}.json" for r in range(WORLD)]
    t0 = time.perf_counter()
    # Each rank in a session of its own, so that stopping this tool stops
    # every process it started (see main's SIGTERM handler).
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--src", args.src, "--arch", arch, "--rank", str(r),
         "--store", str(store), "--out", str(outs[r])], start_new_session=True)
        for r in range(WORLD)]
    try:
        codes = [p.wait(timeout=RANK_TIMEOUT_S) for p in procs]
    finally:
        _stop(procs)
    if codes != [0] * WORLD:
        raise SystemExit(f"{arch}: ranks exited {codes}")
    ranks = [json.loads(o.read_text()) for o in outs]
    r0 = ranks[0]
    if any(r["losses"] != r0["losses"] for r in ranks):
        raise SystemExit(f"{arch}: the ranks' losses differ")
    if not all(map(math.isfinite, r0["losses"])):
        raise SystemExit(f"{arch}: losses {r0['losses']}")
    med = statistics.median(r0["step_ms"][1:])
    return {"arch": arch, "cuts": ARCHS[arch], "src": args.src, "mesh": list(MESH_SHAPE),
            "batch": BATCH, "seq": SEQ, "steps": STEPS,
            "grad_accum": r0["grad_accum"], "params": r0["params"],
            "losses": r0["losses"], "step_ms": r0["step_ms"], "median_step_ms": med,
            "tokens_per_s": BATCH * SEQ / (med / 1e3),
            "peak_gb_per_rank": [r["peak_gb"] for r in ranks],
            "collectives_of_one_step": r0["collectives"],
            "launches_per_rank": [r["launches"] for r in ranks],
            "seconds": time.perf_counter() - t0}


def _terminate(signum, frame):
    raise SystemExit(128 + signum)


def main(argv=None) -> int:
    args = _args(argv)
    if args.rank is not None:
        _rank(args)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("mesh_b4: no CUDA device available", file=sys.stderr)
        return 2
    signal.signal(signal.SIGTERM, _terminate)   # unwinds through _run_arch's _stop
    card = _smi()
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        for arch in ARCHS:
            line = {"card": card, **_run_arch(args, arch, Path(tmp))}
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
