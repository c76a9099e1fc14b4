#!/usr/bin/env python3
"""Time variants of the window GLCM kernel side by side on one NVIDIA card.

    python3 tools/window_variants.py [--baseline DIR] [--reps N]

Each variant is ``src/repro_torch/csrc/glcm_window.cu`` with a few text
replacements (VARIANTS and DIAGNOSTICS below) and a copy count R, built with
nvcc into ``build/window_variants/<name>/``. Every variant but a diagnostic
is checked exactly against ``glcm_window_plain``, and each is timed with CUDA
events on the texture map of ``chip_smoke.py`` — 32 x 32 windows at stride
16 over a 4096² image, L = 32, PAPER_PAIRS — on the smooth and the random
texture, each as float32 and as uint8 (the generators' own dtype). The
variants run in turns (all of them, then all again in reverse order) so that
drift on the card falls on every variant alike.

``--baseline DIR`` also times the kernel of another checkout's
``src/repro_torch/csrc`` (for example a ``git archive`` of an older commit),
called through its C interface without the input-kind argument: on float32
input, and on a float32 copy of the uint8 image made outside the timing.

Prints the card (``nvidia-smi`` name and power limit), each variant's ptxas
registers and spills, its launch (path, blocks per SM, shared bytes), and
one JSON line per variant with the lower of its two times per input, in ms;
last, the time of ``zero_`` on a tensor of the output's size (the card's
write floor as one library call reaches it).
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
from repro_torch.data.images import random_texture, smooth_texture  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import glcm_kernel as gk  # noqa: E402

OUT = ROOT / "build" / "window_variants"
PAPER_OFFSETS = ((0, 1), (1, -1), (0, 4), (4, -4))
LEVELS, WINDOW, STRIDE = 32, 32, 16

_RUN = "constexpr int kRunWindows = 16;"
_SLOTS = "constexpr int kSlots = 2;"
_VOTE = "if ((m >> i & 1u) && r < levels) atomicAdd(hk + r * levels + a[i], 1);"
_BOUNDS = "__launch_bounds__(kThreads, 4)"
_WAIT = "if (threadIdx.x == 0) bulk_wait_read<kSlots - 2>();"
_WAIT_ALL = "if (threadIdx.x == 0) bulk_wait_all();"
_COPY = """  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;"
               :: "l"(dst), "r"(s), "r"(bytes), "l"(policy) : "memory");"""
_CALL = "vote_window(stage, slot"
_STORE = "if (threadIdx.x == 0) bulk_store(dst, slot, static_cast<unsigned>(slot_len) * 4u);"
_FENCE = "fence_async_shared();  //"
# The slot stored by the block's threads with 16-byte stores, no bulk copy
# to fence or wait for.
_PLAIN = [(_STORE, "for (int c = threadIdx.x; c < slot_len / 4; c += kThreads) "
                   "reinterpret_cast<int4*>(dst)[c] = reinterpret_cast<const int4*>(slot)[c];"),
          (_FENCE, "//"), (_WAIT, ""), (_WAIT_ALL, "")]

# name: (text replacements, copies R)
VARIANTS = {
    "shipped": ([], 1),
    # Two private sets per slot, merged before the store.
    "copies_2": ([], 2),
    # The slot stored by the block's threads with 16-byte stores.
    "plain_stores": (_PLAIN, 1),
    # Windows staged at once along a grid row.
    "run_1": ([(_RUN, "constexpr int kRunWindows = 1;")], 1),
    "run_4": ([(_RUN, "constexpr int kRunWindows = 4;")], 1),
    "run_8": ([(_RUN, "constexpr int kRunWindows = 8;")], 1),
    # Three or four output slots: up to two or three stores in flight a block.
    "slots_3": ([(_SLOTS, "constexpr int kSlots = 3;")], 1),
    "slots_4": ([(_SLOTS, "constexpr int kSlots = 4;")], 1),
    # Plain stores at five blocks per SM (at most 48 registers a thread).
    "plain_stores_5": (_PLAIN + [(_BOUNDS, "__launch_bounds__(kThreads, 5)")], 1),
    # Four bulk copies of a quarter slot each, from four threads (L = 32).
    "split_store_4": ([(_STORE, "if (threadIdx.x < 4) bulk_store(dst + threadIdx.x * (slot_len / 4), "
                                "slot + threadIdx.x * (slot_len / 4), slot_len);"),
                       (_WAIT, _WAIT.replace("== 0", "< 4")),
                       (_WAIT_ALL, _WAIT_ALL.replace("== 0", "< 4"))], 1),
    # The bulk copy without the L2 evict-first policy.
    "no_evict_first": ([(_COPY, """  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(s), "r"(bytes) : "memory");""")], 1),
    # Runs of 4 windows at 6 blocks per SM (at most 40 registers a thread).
    "run_4_six_blocks": ([(_RUN, "constexpr int kRunWindows = 4;"),
                          (_BOUNDS, "__launch_bounds__(kThreads, 6)")], 1),
}

# Diagnostics, not kernels: each leaves out part of the work, so its counts
# are wrong and are not checked. What the shipped kernel spends on the part
# left out is the difference of the times.
DIAGNOSTICS = {
    # Every vote computed, none added: the slots stay zero.
    "no_atomics": ([(_VOTE, "if ((m >> i & 1u) && r == levels + a[i]) atomicAdd(hk, 1);")], 1),
    # The counts are never stored: staging and voting alone.
    "no_store": ([(_STORE, "")], 1),
    # No proxy fence before the bulk copy (its ordering is then not
    # guaranteed): what the fence costs.
    "no_fence": ([(_FENCE, "//")], 1),
    # Nothing votes: staging, zeroing, barriers and the stores alone.
    "no_votes": ([(_CALL, "if (false) " + _CALL)], 1),
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
    for name, (reps, _) in {**VARIANTS, **DIAGNOSTICS}.items():
        d = dirs[name] = OUT / name
        d.mkdir(parents=True)
        for f in build.CSRC.iterdir():
            text = f.read_text()
            if f.name == "glcm_window.cu":
                for old, new in reps:
                    if old not in text:
                        raise SystemExit(f"variant {name}: text not found in {f.name}")
                    text = text.replace(old, new)
            (d / f.name).write_text(text)
    if baseline is not None:
        d = dirs["baseline"] = OUT / "baseline"
        shutil.copytree(baseline, d)
    for name, d in dirs.items():
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(d / "libglcm_window.so"),
             str(d / "glcm_window.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        regs = [ln.split("Used")[1].split(",")[0].strip() for ln in log.splitlines()
                if "Used" in ln]
        spills = sorted({ln.strip() for ln in log.splitlines() if "spill" in ln})
        print(json.dumps({"variant": name, "registers": regs,
                          "spills": spills[-1:] if spills else []}), flush=True)
    return dirs


def inputs() -> dict:
    dev = torch.device("cuda", 0)
    cases = {}
    for part, img in (("smooth", smooth_texture(4096, seed=0)),
                      ("random", random_texture(4096, seed=0))):
        u8 = torch.from_numpy(np.ascontiguousarray(img, dtype=np.uint8)).to(dev)
        for kind, x in (("float32", u8.float()), ("uint8", u8)):
            cases[f"{kind}_{part}"] = (x, uniform_params(x))
    return cases


def runner(lib, case, copies: int, baseline: bool):
    """A call of the variant's kernel on one input, returning its counts."""
    x, quant = case
    kw = dict(levels=LEVELS, offsets=PAPER_OFFSETS, region_shape=WINDOW, stride=STRIDE)
    if not baseline:
        def go():
            build.load = lambda name: lib
            return gk.glcm_window(x, quant=quant, copies=copies, **kw)
        return go
    xf = x.float().contiguous()
    windows, _ = gk._windows(xf[None], WINDOW, STRIDE)
    b, gh, gw, rh, rw = windows.shape
    q = gk._quant_block(quant, b, x.device)
    n = len(PAPER_OFFSETS)
    out = torch.empty((b, gh, gw, n, LEVELS, LEVELS), dtype=torch.int32, device=x.device)
    dy = (ctypes.c_int * n)(*(o[0] for o in PAPER_OFFSETS))
    dx = (ctypes.c_int * n)(*(o[1] for o in PAPER_OFFSETS))
    fn = lib.glcm_window_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 4
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])
    stream = torch.cuda.current_stream().cuda_stream

    def go():
        code = fn(xf.data_ptr(), q.data_ptr(), out.data_ptr(), b, gh, gw, rh, rw,
                  *windows.stride()[:4], LEVELS, copies, ctypes.addressof(dy),
                  ctypes.addressof(dx), n, stream)
        if code:
            raise RuntimeError(f"baseline launch failed: CUDA error {code}")
        return out[0]
    return go


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, help="csrc directory of another checkout")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("window_variants: needs an NVIDIA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dirs = build_all(args.baseline)
    libs = {name: ctypes.CDLL(str(d / "libglcm_window.so")) for name, d in dirs.items()}
    copies = {name: r for name, (_, r) in {**VARIANTS, **DIAGNOSTICS}.items()}
    load = build.load
    for name, lib in libs.items():
        if name != "baseline":
            build.load = lambda _, lib=lib: lib
            plan = gk.launch_plan("glcm_window", (1, 4096, 4096), PAPER_OFFSETS,
                                  levels=LEVELS, region_shape=WINDOW, stride=STRIDE,
                                  copies=copies[name])
            print(json.dumps({"variant": name, "launch_plan": plan}), flush=True)
    cases = inputs()
    times = {name: {} for name in libs}
    order = list(libs) + list(reversed(list(libs)))
    for c, case in cases.items():
        want = gk.glcm_window_plain(case[0], LEVELS, PAPER_OFFSETS, region_shape=WINDOW,
                                    stride=STRIDE, quant=case[1])
        for name in order:
            go = runner(libs[name], case, copies.get(name, 1), name == "baseline")
            if name not in DIAGNOSTICS and not torch.equal(go(), want):
                raise SystemExit(f"{name}: {c} differs from the plain version")
            t = cuda_ms(go, args.reps)
            times[name][c] = min(times[name].get(c, t), t)
        del want
    build.load = load
    for name, t in times.items():
        print(json.dumps({"variant": name, "diagnostic": name in DIAGNOSTICS, "ms": t}),
              flush=True)
    # The write floor as the card reaches it: zero_ of a tensor of the
    # output's size (65 025 x 4 x 32 x 32 int32, 1.07 GB), no reads.
    out = torch.empty((255 * 255 * 4 * LEVELS * LEVELS,), dtype=torch.int32, device="cuda")
    print(json.dumps({"reference": "zero_ of the output", "bytes": out.numel() * 4,
                      "ms": min(cuda_ms(out.zero_, args.reps) for _ in range(2))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
