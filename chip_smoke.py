#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``device``: the card (``nvidia-smi`` name and power limit), torch, CUDA.
2. ``build``: compile every CUDA source of the package with nvcc for
   sm_90a (in parallel) and print each kernel's registers and shared memory.
3. ``kernel_check``: each kernel against its plain PyTorch version on the
   card, exact equality, at L in {8, 32, 64, 128, 256}, with -1 padding,
   out-of-range levels, a ragged height, dy == tile_h, an odd width and
   scalar and per-image quantization.
4. ``main_path``: the entry points at the paper's sizes — glcm_features of
   an 8 x 4096 x 4096 float32 stack (4 smooth + 4 random textures) over
   PAPER_PAIRS at L = 32, and glcm of one 16384 x 16384 smooth texture at
   L = 32, d = 1, theta = 45 with uniform quantization. Launch counts are
   set to 0 just before each entry point and read just after it.
5. ``checks``: resolved schemes, launch counts, kernel counts equal to the
   plain versions' on the main-path inputs, features against the features of
   the plain counts computed on the CPU, and the 16384² vote total.
6. ``timing``: CUDA-event times of each kernel, its plain version and (vote
   kernel) ``torch.bincount`` at the main-path shapes, the bound of each
   kernel, and glcm_features images/s end to end.

Then the ``kernels`` line, and last ``{"ok": true, "device": {...}}``. Any
failure raises and exits non-zero; so does a machine without a card, or a
directory holding this script and nothing else of the repo.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.glcm import PAPER_PAIRS, glcm, glcm_features  # noqa: E402
from repro_torch.core.haralick import haralick_features  # noqa: E402
from repro_torch.core.plan import compile_plan  # noqa: E402
from repro_torch.core.quantize import bin_values, uniform_params  # noqa: E402
from repro_torch.core.spec import GLCMSpec  # noqa: E402
from repro_torch.data.images import random_texture, smooth_texture  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.glcm_kernel import (  # noqa: E402
    glcm_fused,
    glcm_fused_plain,
    glcm_vote,
    glcm_vote_plain,
)
from repro_torch.kernels.ops import default_tile_h  # noqa: E402
from repro_torch.kernels.ref import glcm_offsets, pair_planes_nd  # noqa: E402

# NVIDIA H100 SXM data sheet: device memory rate and the float32 rate outside
# the tensor cores (the table has no int32 rate; the kernels' integer adds
# and binning arithmetic are counted against it).
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

LEVELS = 32
FEATURE_RTOL, FEATURE_ATOL, F14_ATOL = 1e-5, 1e-6, 1e-4
DEV = torch.device("cuda", 0)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of ``fn`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    reports = build.build()
    seconds = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in text.splitlines()
               if "Compiling entry function" in ln or "Used" in ln or "spill" in ln]
        for name, text in reports.items()
    }
    emit({"phase": "build", "seconds": seconds, "ptxas": ptxas})


def _edge_values(rng, shape, lo: float, span: float, levels: int) -> np.ndarray:
    """Raw f32 values of which a quarter lie exactly on bin edges."""
    x = (lo + rng.random(shape) * span).astype(np.float32)
    edges = (lo + rng.integers(0, levels + 1, size=shape) * (span / levels)).astype(np.float32)
    mask = rng.random(shape) < 0.25
    return np.where(mask, edges, x).astype(np.float32)


def phase_kernel_check() -> None:
    rng = np.random.default_rng(1234)
    cases = 0
    for levels in (8, 32, 64, 128, 256):
        # glcm_vote: -1 pads and values outside [0, L) on both sides.
        a = rng.integers(-3, levels + 3, size=(3, 200_003)).astype(np.int32)
        r = rng.integers(-3, levels + 3, size=(3, 200_003)).astype(np.int32)
        a[:, -1000:] = -1
        ta, tr = torch.from_numpy(a).to(DEV), torch.from_numpy(r).to(DEV)
        want = glcm_vote_plain(ta, tr, levels)
        for copies, chunk in ((1, 2048), (4, 2048), (2, 64)):
            got = glcm_vote(ta, tr, levels=levels, copies=copies, chunk=chunk)
            require(torch.equal(got, want), f"glcm_vote L={levels} R={copies} chunk={chunk}")
            cases += 1
        got1 = glcm_vote(ta[1], tr[1], levels=levels)
        require(torch.equal(got1, want[1]), f"glcm_vote 1-D L={levels}")
        cases += 1

        # glcm_fused: ragged H (not a multiple of tile_h), odd W, dy == tile_h,
        # dx < 0, every paper pair.
        offsets = tuple(glcm_offsets(d, t) for d, t in PAPER_PAIRS) + ((8, 3), (8, -7), (0, 5))
        h, w = 1027, 513
        ints = rng.integers(-2, levels + 2, size=(3, h, w)).astype(np.int32)
        ti = torch.from_numpy(ints).to(DEV)
        want = glcm_fused_plain(ti, levels, offsets)
        for copies in (1, 3):
            got = glcm_fused(ti, levels=levels, offsets=offsets, tile_h=8, copies=copies)
            require(torch.equal(got, want), f"glcm_fused int L={levels} R={copies}")
            cases += 1
        raw = np.stack([_edge_values(rng, (h, w), lo, sp, levels)
                        for lo, sp in ((0.0, 255.0), (-3.5, 7.25), (10.0, 1e-3))])
        traw = torch.from_numpy(raw).to(DEV)
        quant = uniform_params(traw, batched=True)  # per-image (B,) ranges
        want = glcm_fused_plain(traw, levels, offsets, quant=quant)
        got = glcm_fused(traw, levels=levels, offsets=offsets, tile_h=8, quant=quant)
        require(torch.equal(got, want), f"glcm_fused per-image quant L={levels}")
        scalar = (-3.5, 7.25)  # python floats shared by all images
        want = glcm_fused_plain(traw, levels, offsets, quant=scalar)
        got = glcm_fused(traw, levels=levels, offsets=offsets, tile_h=8, quant=scalar)
        require(torch.equal(got, want), f"glcm_fused scalar quant L={levels}")
        cases += 2
    torch.cuda.synchronize()
    emit({"phase": "kernel_check", "cases": cases, "levels": [8, 32, 64, 128, 256],
          "exact": True})


def make_inputs():
    t0 = time.perf_counter()
    stack = np.stack([smooth_texture(4096, seed=s) for s in range(4)]
                     + [random_texture(4096, seed=s) for s in range(4)]).astype(np.float32)
    big = smooth_texture(16384, seed=11).astype(np.float32)
    stack_t = torch.from_numpy(stack).to(DEV)
    big_t = torch.from_numpy(big).to(DEV)
    torch.cuda.synchronize()
    emit({"phase": "inputs", "seconds": time.perf_counter() - t0,
          "stack": list(stack_t.shape), "stack_bytes": stack_t.numel() * 4,
          "image": list(big_t.shape), "image_bytes": big_t.numel() * 4})
    return stack_t, big_t


def phase_main_path(stack: torch.Tensor, big: torch.Tensor) -> dict:
    out = {}
    glcm_vote.launches = glcm_fused.launches = 0
    t0 = time.perf_counter()
    feats = glcm_features(stack, LEVELS)
    torch.cuda.synchronize()
    out["features_s"] = time.perf_counter() - t0
    out["features_launches"] = {"glcm_fused": glcm_fused.launches,
                                "glcm_vote": glcm_vote.launches}

    glcm_vote.launches = glcm_fused.launches = 0
    t0 = time.perf_counter()
    mat = glcm(big, LEVELS, d=1, theta=45, quantize="uniform")
    torch.cuda.synchronize()
    out["glcm_s"] = time.perf_counter() - t0
    out["glcm_launches"] = {"glcm_fused": glcm_fused.launches,
                            "glcm_vote": glcm_vote.launches}
    emit({"phase": "main_path", **out,
          "features_shape": list(feats.shape), "glcm_shape": list(mat.shape)})
    out["feats"], out["mat"] = feats, mat
    return out


def phase_checks(stack, big, main) -> dict:
    feats, mat = main["feats"], main["mat"]
    fused_spec = GLCMSpec(levels=LEVELS, pairs=PAPER_PAIRS, quantize="uniform")
    vote_spec = GLCMSpec(levels=LEVELS, pairs=((1, 45),), quantize="uniform")
    fused_scheme = compile_plan(fused_spec, tuple(stack.shape), features=True).spec.scheme
    vote_scheme = compile_plan(vote_spec, tuple(big.shape)).spec.scheme
    require(fused_scheme == "cuda_fused", f"glcm_features resolved to {fused_scheme}")
    require(vote_scheme == "cuda", f"glcm resolved to {vote_scheme}")
    require(main["features_launches"]["glcm_fused"] > 0, "glcm_features never launched glcm_fused")
    require(main["glcm_launches"]["glcm_vote"] > 0, "glcm never launched glcm_vote")

    # Fused kernel vs plain on the main-path stack.
    offsets = tuple(glcm_offsets(d, t) for d, t in PAPER_PAIRS)
    quant = uniform_params(stack, batched=True)
    counts = glcm_fused(stack, levels=LEVELS, offsets=offsets,
                        tile_h=default_tile_h(offsets), quant=quant)
    plain = glcm_fused_plain(stack, LEVELS, offsets, quant=quant)
    fused_err = max_abs_err(counts, plain)
    require(fused_err == 0, f"glcm_fused differs from plain by {fused_err}")
    plan_counts = compile_plan(fused_spec, tuple(stack.shape))(stack)
    require(torch.equal(plan_counts, counts.to(torch.float32)), "plan counts != kernel counts")
    want = haralick_features(plain.cpu().to(torch.float32)).numpy()
    got = feats.cpu().numpy()
    b, h, w = stack.shape
    require(np.isfinite(got).all() and got.shape == (b, len(offsets), 14),
            "features not finite or of the wrong shape")
    f_err = float(np.abs(got[..., :13] - want[..., :13]).max())
    f14_err = float(np.abs(got[..., 13] - want[..., 13]).max())
    require(np.allclose(got[..., :13], want[..., :13], rtol=FEATURE_RTOL, atol=FEATURE_ATOL),
            f"features f1-f13 differ (max abs {f_err})")
    require(np.allclose(got[..., 13], want[..., 13], rtol=0, atol=F14_ATOL),
            f"feature f14 differs (max abs {f14_err})")
    votes_per_offset = [int(v) for v in counts.sum(dim=(0, 2, 3)).tolist()]
    require(votes_per_offset == [b * (h - dy) * (w - abs(dx)) for dy, dx in offsets],
            "fused vote totals")

    # Vote kernel vs plain on the 16384² streams glcm() built.
    lo, span = uniform_params(big)
    assoc, ref = pair_planes_nd(big, glcm_offsets(1, 45))
    a = bin_values(assoc, LEVELS, lo, span).reshape(1, -1)
    r = bin_values(ref, LEVELS, lo, span).reshape(1, -1)
    vcounts = glcm_vote(a, r, levels=LEVELS, copies=1)
    vplain = glcm_vote_plain(a, r, LEVELS)
    vote_err = max_abs_err(vcounts, vplain)
    require(vote_err == 0, f"glcm_vote differs from plain by {vote_err}")
    total = int(vcounts.to(torch.int64).sum().item())
    expect = (big.shape[0] - 1) * (big.shape[1] - 1)
    require(total == expect, f"vote total {total} != {expect}")
    require(torch.equal(mat, vcounts[0].to(torch.float32)), "glcm() != kernel counts")
    require(bool(torch.isfinite(mat).all()), "glcm() not finite")
    out = {"fused_scheme": fused_scheme, "vote_scheme": vote_scheme,
           "fused_max_abs_err": fused_err, "vote_max_abs_err": vote_err,
           "features_max_abs_err_f1_f13": f_err, "features_max_abs_err_f14": f14_err,
           "vote_total": total, "fused_votes_per_offset": votes_per_offset}
    emit({"phase": "checks", **out})
    out.update(quant=quant, offsets=offsets, a=a, r=r)
    return out


def phase_timing(stack, big, chk) -> dict:
    offsets, quant, a, r = chk["offsets"], chk["quant"], chk["a"], chk["r"]
    tile_h = default_tile_h(offsets)
    b, h, w = stack.shape
    n = a.shape[1]
    t = {}
    t["fused_ms"] = cuda_ms(lambda: glcm_fused(stack, levels=LEVELS, offsets=offsets,
                                               tile_h=tile_h, quant=quant), reps=10)
    t["fused_plain_ms"] = cuda_ms(lambda: glcm_fused_plain(stack, LEVELS, offsets,
                                                           quant=quant), reps=3)
    t["vote_ms"] = cuda_ms(lambda: glcm_vote(a, r, levels=LEVELS, copies=1), reps=10)
    t["vote_plain_ms"] = cuda_ms(lambda: glcm_vote_plain(a, r, LEVELS), reps=3)
    pos = (r.to(torch.int64) * LEVELS + a.to(torch.int64)).reshape(-1)
    t["vote_library_ms"] = cuda_ms(
        lambda: torch.bincount(pos, minlength=LEVELS * LEVELS), reps=3)
    del pos

    # Bounds: each input read once, each output written once, over the
    # memory rate; operations over the scalar rate; the larger wins.
    fused_votes = sum(b * (h - dy) * (w - abs(dx)) for dy, dx in offsets)
    fused_bytes = stack.numel() * 4 + b * 2 * 4 + b * len(offsets) * LEVELS**2 * 4
    fused_ops = 5 * stack.numel() + fused_votes  # binning once per pixel, one add per vote
    vote_bytes = 2 * n * 4 + LEVELS**2 * 4
    vote_ops = n
    t["fused_bound_ms"] = max(fused_bytes / HBM_BYTES_PER_S, fused_ops / SCALAR_OPS_PER_S) * 1e3
    t["fused_bound_by"] = ("bytes" if fused_bytes / HBM_BYTES_PER_S
                           >= fused_ops / SCALAR_OPS_PER_S else "operations")
    t["vote_bound_ms"] = max(vote_bytes / HBM_BYTES_PER_S, vote_ops / SCALAR_OPS_PER_S) * 1e3
    t["vote_bound_by"] = ("bytes" if vote_bytes / HBM_BYTES_PER_S
                          >= vote_ops / SCALAR_OPS_PER_S else "operations")

    # End to end: glcm_features on the resident stack, host clock + sync.
    glcm_features(stack, LEVELS)
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        glcm_features(stack, LEVELS)
    torch.cuda.synchronize()
    t["features_images_per_s"] = reps * b / (time.perf_counter() - t0)

    # The same stack as uint8, as smooth_texture/random_texture give it: the
    # fused path widens it to f32 before the kernel (range and launch).
    u8 = stack.to(torch.uint8)
    spec = GLCMSpec(levels=LEVELS, pairs=PAPER_PAIRS, quantize="uniform")
    require(torch.equal(compile_plan(spec, tuple(u8.shape))(u8),
                        compile_plan(spec, tuple(stack.shape))(stack)),
            "uint8 stack counts != float32 stack counts")
    t["fused_uint8_ms"] = cuda_ms(
        lambda: glcm_fused(u8, levels=LEVELS, offsets=offsets, tile_h=tile_h,
                           quant=uniform_params(u8, batched=True)), reps=10)
    glcm_features(u8, LEVELS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        glcm_features(u8, LEVELS)
    torch.cuda.synchronize()
    t["features_uint8_images_per_s"] = reps * b / (time.perf_counter() - t0)
    emit({"phase": "timing", **t})
    return t


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this script needs an NVIDIA card",
              file=sys.stderr)
        return 2
    phase_device()
    phase_build()
    phase_kernel_check()
    stack, big = make_inputs()
    main_run = phase_main_path(stack, big)
    chk = phase_checks(stack, big, main_run)
    t = phase_timing(stack, big, chk)
    kernels = [
        {"name": "glcm_vote", "route": "cuda", "source": "src/repro_torch/csrc/glcm_vote.cu",
         "replaces": "src/repro/kernels/glcm_kernel.py:151",
         "launches": main_run["glcm_launches"]["glcm_vote"],
         "max_abs_err": chk["vote_max_abs_err"], "ms": t["vote_ms"],
         "plain_ms": t["vote_plain_ms"], "bound_ms": t["vote_bound_ms"],
         "bound_by": t["vote_bound_by"], "library_ms": t["vote_library_ms"]},
        {"name": "glcm_fused", "route": "cuda", "source": "src/repro_torch/csrc/glcm_fused.cu",
         "replaces": "src/repro/kernels/glcm_kernel.py:539",
         "launches": main_run["features_launches"]["glcm_fused"],
         "max_abs_err": chk["fused_max_abs_err"], "ms": t["fused_ms"],
         "plain_ms": t["fused_plain_ms"], "bound_ms": t["fused_bound_ms"],
         "bound_by": t["fused_bound_by"], "library_ms": None},
    ]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
