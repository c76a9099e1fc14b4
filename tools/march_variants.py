#!/usr/bin/env python3
"""Time variants of the marching GLCM kernel side by side on one NVIDIA card.

    python3 tools/march_variants.py [--baseline DIR] [--reps N]

Each variant is ``src/repro_torch/csrc/glcm_march.cuh`` with a few text
replacements (VARIANTS and DIAGNOSTICS below), built with nvcc into
``build/march_variants/<name>/`` beside ``glcm_fused.cu`` and
``glcm_volume.cu``. Every variant but a diagnostic is checked exactly
against the plain PyTorch versions, and each is timed with CUDA events on
the main-path inputs of ``chip_smoke.py``: ``glcm_fused`` on the 8 x 4096² stack (4 smooth, then 4
random textures; float32 and uint8, L = 32, PAPER_PAIRS) and
``glcm_volume`` on the two 256 x 512 x 512 volumes (smooth, random; the 13
directions), each half alone and whole. The variants run in turns (all of
them, then all again in reverse order) so that drift on the card falls on
every variant alike.

``--baseline DIR`` also times the kernels of another checkout's
``src/repro_torch/csrc`` (for example a ``git archive`` of an older commit),
called through their C interface without the input-kind argument: float32
raw values or int32 levels only.

Prints the card (``nvidia-smi`` name and power limit), each variant's
ptxas registers and spills, and one JSON line per variant with the lower of
its two times per input, in ms.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.quantize import uniform_params  # noqa: E402
from repro_torch.data.images import (  # noqa: E402
    random_texture,
    random_volume,
    smooth_texture,
    smooth_volume,
)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import glcm_kernel as gk  # noqa: E402
from repro_torch.kernels.ref import DIRECTIONS_3D  # noqa: E402

OUT = ROOT / "build" / "march_variants"
PAPER_OFFSETS = ((0, 1), (1, -1), (0, 4), (4, -4))
LEVELS = 32

# The vote's inner loop as shipped: one shared atomicAdd per vote.
_PLAIN = """#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        const int r = level_at<Lv>(rw, i);
        if (r < levels && (voting >> i & 1u)) atomicAdd(hk + r * levels + a[i], 1);
      }
"""

VARIANTS = {
    "shipped": [],
    # Each thread keeps one pending (cell, count) per offset over its run and
    # adds the count when the cell changes or the run ends.
    "run_coalesced": [(_PLAIN, """int pend = -1, cnt = 0;
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        const int r = level_at<Lv>(rw, i);
        if (r < levels && (voting >> i & 1u)) {
          const int cell = r * levels + a[i];
          if (cell != pend) {
            if (cnt) atomicAdd(hk + pend, cnt);
            pend = cell;
            cnt = 0;
          }
          ++cnt;
        }
      }
      if (cnt) atomicAdd(hk + pend, cnt);
""")],
    # The lanes of a warp that vote the same cell elect one lane, which adds
    # their number.
    "warp_match": [(_PLAIN, """#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        const int r = level_at<Lv>(rw, i);
        const bool ok = r < levels && (voting >> i & 1u);
        const int key = ok ? r * levels + a[i] : -1 - static_cast<int>(threadIdx.x & 31);
        const unsigned peers = __match_any_sync(__activemask(), key);
        if (ok && (threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(hk + key, __popc(peers));
      }
""")],
    # Two blocks per SM (128 registers a thread) instead of three (80).
    "two_blocks_per_sm": [("__launch_bounds__(kThreads, 3)", "__launch_bounds__(kThreads, 2)")],
}

# Diagnostics, not kernels: each leaves out part of the work, so its counts
# are wrong and are not checked. What the shipped kernel spends on the part
# left out is the difference of the times.
DIAGNOSTICS = {
    # Every vote computed, none added: the sub-histograms stay zero.
    "no_atomics": [(_PLAIN, """int sink = 0;
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        const int r = level_at<Lv>(rw, i);
        if (r < levels && (voting >> i & 1u)) sink += r * levels + a[i];
      }
      if (sink == -1) atomicAdd(hk, 1);
""")],
    # The ring is loaded and binned, nothing votes.
    "no_votes": [("if (j > ahead) vote<Lv>(ring, mine, g, offs, j - ahead - 1, za, zb, y0);",
                  "")],
}


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def build_all(baseline: Path | None) -> dict:
    """Compile every variant (and the baseline) at once; {name: dir}."""
    shutil.rmtree(OUT, ignore_errors=True)
    dirs, procs = {}, {}
    for name, reps in {**VARIANTS, **DIAGNOSTICS}.items():
        d = dirs[name] = OUT / name
        d.mkdir(parents=True)
        for f in build.CSRC.iterdir():
            text = f.read_text()
            if f.name == "glcm_march.cuh":
                for old, new in reps:
                    if old not in text:
                        raise SystemExit(f"variant {name}: text not found in {f.name}")
                    text = text.replace(old, new)
            (d / f.name).write_text(text)
    if baseline is not None:
        d = dirs["baseline"] = OUT / "baseline"
        shutil.copytree(baseline, d)
    for name, d in dirs.items():
        for k in ("glcm_fused", "glcm_volume"):
            procs[(name, k)] = subprocess.Popen(
                [build.nvcc(), *build.NVCC_FLAGS, "-o", str(d / f"lib{k}.so"), str(d / f"{k}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for (name, k), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}/{k}:\n{log}")
        regs = sorted({ln.split("Used")[1].split(",")[0].strip() for ln in log.splitlines()
                       if "Used" in ln})
        spills = sorted({ln.strip() for ln in log.splitlines() if "spill" in ln})
        print(json.dumps({"variant": name, "kernel": k, "registers": regs,
                          "spills": spills[-1:] if spills else []}), flush=True)
    return dirs


def inputs() -> dict:
    dev = torch.device("cuda", 0)
    stack = torch.from_numpy(np.stack(
        [smooth_texture(4096, seed=s) for s in range(4)]
        + [random_texture(4096, seed=s) for s in range(4)])).to(dev)
    vol = torch.from_numpy(np.stack([smooth_volume((256, 512, 512), seed=0),
                                     random_volume((256, 512, 512), seed=0)])).to(dev)
    cases = {}
    for part, sl in (("smooth", slice(0, 4)), ("random", slice(4, 8)), ("all", slice(None))):
        for kind, x in (("float32", stack[sl].float()), ("uint8", stack[sl])):
            cases[f"fused_{kind}_{part}"] = ("glcm_fused", x, uniform_params(x, batched=True))
    for part, sl in (("smooth", slice(0, 1)), ("random", slice(1, 2)), ("all", slice(None))):
        x = vol[sl].float()
        cases[f"volume_float32_{part}"] = ("glcm_volume", x, uniform_params(x, batched=True))
    cases["volume_uint8_all"] = ("glcm_volume", vol, uniform_params(vol, batched=True))
    return cases


def runner(libs: dict, case, baseline: bool):
    """A call of the variant's kernel on one input, returning its counts."""
    kernel, x, quant = case
    if not baseline:
        def go():
            build.load = lambda name: libs[name]
            if kernel == "glcm_fused":
                return gk.glcm_fused(x, levels=LEVELS, offsets=PAPER_OFFSETS, tile_h=8,
                                     quant=quant)
            return gk.glcm_volume(x, levels=LEVELS, offsets=DIRECTIONS_3D, slab_d=8, quant=quant)
        return go
    xf = x.float().contiguous()
    b = x.shape[0]
    q = gk._quant_block(quant, b, x.device)
    offsets = PAPER_OFFSETS if kernel == "glcm_fused" else DIRECTIONS_3D
    out = torch.zeros((b, len(offsets), LEVELS, LEVELS), dtype=torch.int32, device=x.device)
    cols = [(ctypes.c_int * len(offsets))(*c) for c in zip(*offsets)]
    fn = getattr(libs[kernel], f"{kernel}_launch")
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * (x.ndim + 3)
                   + [ctypes.c_void_p] * len(cols) + [ctypes.c_int, ctypes.c_void_p])
    stream = torch.cuda.current_stream().cuda_stream

    def go():
        out.zero_()
        code = fn(xf.data_ptr(), q.data_ptr(), out.data_ptr(), *x.shape, LEVELS, 1, 8,
                  *(ctypes.addressof(c) for c in cols), len(offsets), stream)
        if code:
            raise RuntimeError(f"baseline {kernel} launch failed: CUDA error {code}")
        return out
    return go


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, help="csrc directory of another checkout")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("march_variants: needs an NVIDIA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dirs = build_all(args.baseline)
    libs = {name: {k: ctypes.CDLL(str(d / f"lib{k}.so")) for k in ("glcm_fused", "glcm_volume")}
            for name, d in dirs.items()}
    cases = inputs()
    times = {name: {} for name in libs}
    order = list(libs) + list(reversed(list(libs)))
    for c, case in cases.items():
        kernel, x, quant = case
        want = (gk.glcm_fused_plain(x, LEVELS, PAPER_OFFSETS, quant=quant)
                if kernel == "glcm_fused"
                else gk.glcm_volume_plain(x, LEVELS, DIRECTIONS_3D, quant=quant))
        for name in order:
            go = runner(libs[name], case, name == "baseline")
            if name not in DIAGNOSTICS and not torch.equal(go(), want):
                raise SystemExit(f"{name}: {c} differs from the plain version")
            reps = args.reps if kernel == "glcm_fused" else max(1, args.reps // 2)
            t = cuda_ms(go, reps)
            times[name][c] = min(times[name].get(c, t), t)
    for name, t in times.items():
        print(json.dumps({"variant": name, "diagnostic": name in DIAGNOSTICS, "ms": t}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
