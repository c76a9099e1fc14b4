#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``device``: the card (``nvidia-smi`` name and power limit), torch, CUDA.
2. ``build``: compile every CUDA source of the package with nvcc for
   sm_90a (in parallel) and print each kernel's registers and shared memory,
   and the launches glcm_fused, glcm_volume and glcm_window make on the main
   path at L = 32 (blocks per SM, shared bytes, ring geometry or staged
   path, grid).
3. ``kernel_check``: each kernel against its plain PyTorch version on the
   card, exact equality, at L in {8, 32, 64, 128, 255, 256}, with -1
   padding, out-of-range levels, a ragged height, dy == tile_h, an odd width
   and scalar and per-image quantization; windows overlapping and tiled,
   with dx < 0, |dx| == rw - 1 and dy == rh - 1, a grid row that leaves a
   run short, uint8 input with per-image and scalar ranges, slices and
   patch grids; volumes with a ragged depth, all 13
   directions, d = 2 and dz == slab_d; and the marching kernels' edges:
   uint8 input, a width past one strip, H < 1 + max dy, a depth of 1,
   out-of-range levels on strip and ring edges, slices of a stack.
4. ``main_path``: the entry points at the paper's sizes — glcm_features of
   an 8 x 4096 x 4096 float32 stack (4 smooth + 4 random textures) over
   PAPER_PAIRS at L = 32; glcm of one 16384 x 16384 smooth texture at
   L = 32, d = 1, theta = 45 with uniform quantization; the texture map
   (glcm_features of the first 4096² smooth texture in 32 x 32 windows at
   stride 16, 255 x 255 windows, all 14 features) and glcm of one random
   4096² texture in 256 x 256 tiles; and the volumes (glcm_features of a
   smooth and a random 256 x 512 x 512 float32 volume over the 13 3-D
   directions, and glcm of the smooth one in direction 7). Launch counts
   are set to 0 just before each entry point and read just after it.
5. ``checks``: resolved schemes, launch counts, kernel counts equal to the
   plain versions' on the main-path inputs, features against the features of
   the plain counts computed on the CPU, and the vote totals.
6. ``timing``: CUDA-event times of each kernel, its plain version and
   ``torch.bincount`` of the pre-built linearised index (where it fits) at
   the main-path shapes (glcm_fused and glcm_volume also on the smooth and
   the random half, and glcm_fused on the stack as uint8, with its peak
   allocation, and on it at L = 256 over scikit-image's four offsets, the
   count of features-4096-L256, exact, with the cluster size its launch
   plan reports; glcm_window on the smooth and the random texture, each as
   float32 and as its uint8 original, with the uint8 launch's peak
   allocation), the bound of each kernel, glcm_features images/s, windows/s
   and voxels/s end to end, and the Haralick tail alone. Then ``mcc``:
   f14's eigensolver (``second_eigenvalue``) against its plain version
   within 1e-12 on the texture map's 260 100 matrices of the smooth and the
   random texture, one launch each; its CUDA-event ms beside
   its bound (float64 operations over 33.5 TFLOP/s against 2.27 GB over the
   memory rate), the plain version and the chunked ``torch.linalg.eigvalsh``
   it replaces; a launch allocates only its output. The main path must
   launch it once each for glcm_features, the texture map and the volumes.
   Then the one-block kernel for L > 32 on the 32 L = 256 matrices of 8
   images at distance 1 in four directions, against its plain version
   within 1e-12, with its ms beside its bound and the plain version's.
   ``python3 chip_smoke.py mcc`` builds it and runs this phase alone.
   Then ``tail``: f1-f13 (``haralick_tail``) against its plain version on
   the same 260 100 matrices, the 32 of a features-4096 call (also after
   the plan's float32 step) and the 32 of an L = 256 call: f1, f2 and
   f4-f12 within 1e-12 and f3 within 1e-9 of each feature's largest
   magnitude, f13 squared within 1e-12, P and its marginals within
   L 2^-53, one launch each and twice the same bits; its
   CUDA-event ms with and without P beside its bound (bytes over the
   memory rate) and the plain version's ms; a launch allocates only its
   outputs. The main path must launch it once each for glcm_features, the
   texture map and the volumes. ``python3 chip_smoke.py tail`` builds it and
   runs this phase alone.
7. ``histogram``: ``kernels.histogram`` on the 16384² image binned to
   L = 32 (the contended case) and on the random stack[4] binned to
   L = 256, with launch counts, exact against the plain version and
   ``torch.bincount``, and the kernel, plain and ``torch.bincount`` times.
8. ``temporal``: ``glcm_feature_stream(temporal_window=16)`` over
   ``texture_video(4096, 32, change_at=16)`` (global spec, PAPER_PAIRS,
   L = 32): launches (one ``glcm_fused`` per frame, nothing else), window
   counts bit for bit against per-frame plain counts summed before the ring
   fills, when it is full and after the scene change, features against the
   CPU's; the per-frame latency of the incremental step against the
   recompute of a 16-frame window in one batched call.
9. ``texture_stream``: the texture map (32² windows at stride 16) as a
   counts-only temporal stream with an 8-frame ring (8.5 GB) over the same
   frames: one ``glcm_window`` per frame, each uint8 frame read as it is
   (one launch on a frame allocates only its counts), exact at two steps,
   the per-step latency, the peak device memory and a step's own peak.
10. ``pipeline``: ``glcm_feature_stream`` over 32 float32 4096² host images
    (the 8 of the stack, 4 times) at prefetch 1 and 2 and batch size 1 and
    8: side-stream copies from pinned buffers, features against
    ``glcm_features``, images/s and the overlap gain, and the times of one
    host memcpy into pinned memory and of one host-to-device copy.
11. ``serve`` (serve-mixed-4096): one ``GLCMEngine`` on the card serving
    four workloads in the mix of ``benchmarks/serve_load.py`` (55 / 25 / 15
    / 5 %): 4096² uint8 images (PAPER_PAIRS features → glcm_fused), the
    same images equalized (one pair, raw counts → glcm_vote), 1024² float32
    crops as texture maps (32² windows at stride 16 → glcm_window) and the
    256 x 512 x 512 volumes (13 directions → glcm_volume). After a warm-up,
    a zero-gap prefix of 64 requests calibrates the mean service time; 96
    requests of a seeded bursty trace then replay on a warp clock at 50 %
    offered load, with a deadline and without one, each under a live
    tracer with one rolling-window session of 24 video frames interleaved,
    closed after frame 17 and resumed from its checkpoint. Checks: results against
    direct batch-1 calls of the engine's route and of the plain "scatter"
    route (no kernel), counts bit for bit and features within the
    tolerances, pushes against the stream plan's rolling
    window, kernel launches against dispatched batches, ``launch_ms``
    against the CUDA-event time of the same plan call, the saved Chrome
    trace, the Prometheus series and a shed. Prints per-workload
    latencies, the pad / launch / readback split, throughput per mode and
    the launch share of the replay.
12. ``lint`` (the plan-contract analyzer, ``repro_torch.analysis``): (a)
    ``run_audit(device="cuda")`` over the whole registry — the reference's 14
    cases on every backend that serves them, each plan recorded once on the
    card — must find nothing and error nowhere, with all three self-checks
    firing (a pre-quantize plan shows its int image, an mcc plan its
    eigendecomposition, a plain version on the card trips
    ``device-kernel-launches``); the one-hot schemes' integer votes under
    ``accum="int"`` (int8 one-hots through ``torch._int_mm``) count bit for
    bit as "scatter" on the card. (b) ``compile_plan(..., check="lint")`` of
    the main path's untuned plans at the paper's sizes (features-4096,
    glcm-16384, texture-map-4096, volume-2x256x512x512, stream-4096-w16) must
    be clean, and a recorded call of each must show its kernel's launch and
    no other (with features, also f14's ``second_eigenvalue``); each plan's
    ``repro_plan_lint_ms`` is printed beside the CUDA-event time of one
    plain call of it. (c) Two scratch backends on the
    card must make the lint raise ``PlanContractError`` with exactly their
    rule: one that hands a CUDA tensor to a plain version
    (``device-kernel-launches``), one that calls ``.item()`` on a device
    count (``no-host-callback``).
13. ``autotune``: ``core.autotune`` on the card with ``trials=3`` for
    main-path workloads at the paper's sizes (``AUTOTUNE_WORKLOADS``:
    features-4096 with features, and glcm-16384), one line each: every candidate's
    µs, every skip and its reason, the winner, and the µs of the untuned
    "auto" choice's candidate. Checks: ``compile_plan`` of the "auto" spec
    returns a plan whose ``tuned`` is the winner and whose spec carries its
    knobs; its launch counts show the winner's kernel; its counts equal the
    untuned plan's and the plain "scatter" route's bit for bit on the
    main-path input, features within the tolerances; a fresh
    ``python3 -c`` process resolves features-4096 to the same winner from
    the sidecar and records no ``autotune.candidate`` span; the
    ``autotune.*`` spans and ``repro_autotune_candidate_us`` series are
    there. Reported, not gated: tuned against untuned plan in 5 alternating
    CUDA-event pairs on the smooth input and on the tuner's random sample,
    and the ``copies`` sweep of ``glcm_vote`` (the paper's Table III) on the
    smooth 16384² image and on a random 4096² one.
14. ``distributed``: multi-rank sharding (``core.distributed``). The parent
    bins the 16384² smooth image, the smooth 256 x 512 x 512 volume, both
    volumes and the first 4096² texture to L = 32 (uniform, each over its
    own range) into uint8 level files, frees its stacks, and starts 4 gloo
    ranks (``torch.multiprocessing.spawn``, a ``FileStore``) that share
    cuda:0 and memmap the files: ``glcm_sharded`` of the image at d = 1,
    theta = 45 and d = 4, theta = 90 (halos of 1 and 4 rows) and of the
    volume by depth in direction 7 and (d = 2, direction 9) (halos of 1 and
    2 slices); ``glcm_sharded_batch`` of the two volumes on a (2, 2) mesh
    (batch over "data", depth over "model"); the texture map in 256² tiles
    (4 grid rows a rank); ``glcm_auto_sharded`` of the first image case;
    and the 32² windows at stride 16, whose 255-row grid must raise on
    every rank. Each rank's launch counts must show exactly one launch of
    the case's kernel (``glcm_fused``, ``glcm_volume`` or ``glcm_window``)
    and nothing else, its counts int32 on the card. Each rank also counts
    the input the call gave its kernel (the extended shard, its halo read
    straight from the file here; or its block of rows) by the kernel and by
    its plain version on the card, which must agree. One process counts
    each whole input on the card by the kernel and by the plain version,
    which must agree; every rank's counts equal those plain counts bit for
    bit. Then a 1-rank NCCL group on the card runs the first image case.
    Printed per case and rank: the first call, 3 whole calls (host clock
    after a sync) and one traced call's stages (the block's read and copy
    to the card, the halo exchange, the kernel, the all_reduce; host ms and
    CUDA-event ms); and the one-process call and kernel.

15. ``lm`` (the LM model core and its serving engine, ``repro_torch.models``
    and ``serve.engine.Engine``; plain PyTorch on the card, no kernel of
    ``csrc``): smollm-135m at full width as published (30 layers, d 576, 9 /
    3 heads, d_ff 1536, vocab 49 152, float32 parameters from a seeded
    ``torch.Generator`` on the card, bfloat16 compute): prefill 8 x 4096
    (CUDA events, tokens/s, peak allocation), ``Engine.generate`` at B = 8
    and 64 with 512-token prompts and 64 new tokens (prefill ms and each
    decode step's ms by CUDA events, decode tokens/s, and one step's kernel
    launches and busy time from ``torch.profiler`` beside its aten ops). Checks
    (``LM_*`` tolerances): float32 on the card against float32 on the CPU
    with the same weights (prefill at B = 1, T = 1100, the chunked path with a
    padded last chunk, and three teacher-forced decode steps); a float32
    greedy ``Engine.generate`` whose every step's logits match one forward
    over the generated sequence and whose every token is that forward's
    argmax; bfloat16 against float32 prefill logits. mamba2-130m at full
    width: prefill 4 x 2048, 16 decode steps, the greedy check in float32.
    The other families reduced (hybrid, MoE with both dispatches and arctic's
    dense residual, encoder-decoder, the int8 KV cache): one
    ``Engine.generate`` each on the card against the same call on the CPU.
    ``python3 chip_smoke.py lm`` runs the device and ``lm`` phases alone.

16. ``train`` (single-process LM training, ``repro_torch.train`` and
    ``launch.steps.make_train_step``; plain PyTorch on the card, no kernel of
    ``csrc``): smollm-135m at full width (float32 master parameters,
    bfloat16 compute, ``remat`` on, AdamW) through the entry point itself,
    ``train.loop.train`` with 8 steps of 8 x 2048 tokens and a checkpoint at
    step 4, then ``train`` again to 10 steps on the same directory, which
    resumes at step 5. Printed: the median step ms after the first step and
    tokens/s, the peak allocation, the first and last loss, one step's
    kernel launches and device-busy ms (``torch.profiler``), the phase's
    seconds. Checks (``TRAIN_*`` tolerances): finite losses, the last below
    the first; float32 on the card against float32 on the CPU at B = 1,
    T = 256 (the loss, every gradient, the parameters after one AdamW step);
    remat on against off on the card; the resumed run restores the saved
    parameters bit for bit; TF32 off. ``python3 chip_smoke.py train`` runs
    the device and ``train`` phases alone.

17. ``mesh`` (the LM sharded on a device mesh, ``repro_torch.sharding`` on
    DTensor and ``train.loop.train(mesh=)``; plain PyTorch on the card, no
    kernel of ``csrc``). First a probe line: each functional collective
    DTensor issues (all_gather_into_tensor, reduce_scatter_tensor,
    all_reduce, all_to_all_single) on CUDA tensors over its own 4-rank gloo
    world, as it is and routed through the c10d call
    (``sharding.gloo_cuda``, which every CUDA mesh over gloo installs); every
    routed one must work. Then 4 gloo ranks (``torch.multiprocessing.spawn``,
    a ``FileStore``) share cuda:0 on a (2, 2) ("data", "model") mesh: (a)
    smollm-135m as published (float32 master weights, bfloat16 compute,
    remat on, AdamW) through ``train(mesh=)``, 4 steps of 8 x 2048 tokens from
    the train phase's seed, a checkpoint at step 2: every step's loss within
    ``MESH_LOSS_RTOL`` of one process's on the card; printed: the median step
    ms after the first, tokens/s, each rank's peak allocation, the
    collectives of one more step by kind and count (``CommDebugMode``), and
    the local shapes of ``embeddings/embed`` (vocab over "model") and of a
    batch (batch over "data", sequence over "model"), and one more step
    under ``torch.profiler`` on every rank: its wall ms, the ms its kernels
    kept the card busy and the ms its host spent in collectives; (b) float32
    at 2 x 256 on the mesh against one process on the card (loss, every
    gradient, one AdamW step, ``TRAIN_*`` tolerances, the small-gradient elements apart
    counted); (c) the step-2 checkpoint restored onto a (4, 1) mesh (through
    ``train``, and by ``restore(shardings=)`` for a bit-for-bit check of
    every leaf), re-placed onto (1, 4) by ``reshard_tree`` (bit for bit) and
    restored onto one process, one further step on each within
    ``MESH_LOSS_RTOL`` of the run's; (d) the run's first step on a 1-rank
    NCCL world with a (1, 1) mesh; (e) no launch of a ``csrc`` kernel in the
    parent or any rank; (f) the other archs (``MESH_ARCHS``, reduced, float32:
    olmo, whisper in both layouts, mamba2, hymba, internlm2, llava,
    smollm-360m, mixtral, arctic): the loss and every gradient on the mesh
    against one process on the card, and ``train(mesh=)`` with
    ``grad_accum=2`` (reduced smollm) giving one process's loss within
    ``MESH_LOSS_RTOL``; (g) mesh row B4, the MoE layer and the Mamba2 mixer
    sharded over "model": mamba2-130m as published and mixtral-8x7b at full
    width cut to one layer (``MESH_B4_CHECK``), float32 on the mesh against
    one process on the card (loss, every gradient, one AdamW step,
    ``TRAIN_*`` tolerances; the ranks first, then one process), then, in
    the same world, two bfloat16 steps of each at 8 x 1024 (one microbatch)
    through ``train(mesh=)`` by ``tools/mesh_b4.py``'s ``train_counted`` (ms
    a step, tokens/s, peak a rank, collectives of one step by kind; no
    kernel of ``csrc`` launched on any rank). ``python3 chip_smoke.py mesh`` runs the device and
    ``mesh`` phases alone.
18. ``dryrun`` (``repro_torch.launch``: ``build_cell``, ``lower_cell``,
    ``cost``, ``roofline``, ``dryrun``; plain PyTorch, no kernel of
    ``csrc``). (a) The dry run itself, three children at once:
    ``python -m repro_torch.launch.dryrun --arch smollm-135m --mesh single``
    (train_4k, prefill_32k, decode_32k), ``--arch mixtral-8x7b --shape
    train_4k`` (grad_accum 4: the batch taken as microbatches) and ``--arch
    mamba2-130m --shape train_4k``, each on a fake world of 256 ranks with
    fake CUDA tensors (nothing allocated), probes at depths (4, 8); each
    cell's roofline line from its report under ``reports/dryrun_torch/``,
    every cell fitting 80 GB, and a ``b4`` line with the flops and collective
    bytes a rank of mixtral's and mamba2's train_4k, each within
    ``DRYRUN_B4_FLOPS``. (b) Calibration, in a spawned 1-rank
    NCCL world on a (1, 1) mesh: smollm-135m as published, seeded, with real
    weights on the card, for ``CALIB_CELLS`` (train at 8 x 2048, decode at
    B = 64 against a 4096-slot cache): ``lower_cell`` on fake tensors, then
    the same program for real under the same counting mode (``launch.cost``):
    flops, bytes and collective bytes must be equal exactly, and the
    predicted peak (plus what the process held beyond the arguments) within
    ``CALIB_PEAK_RTOL`` of ``max_memory_allocated``;
    then the real program timed without the mode (CUDA events) beside
    ``t_compute``, ``t_memory`` and its share of bf16 peak
    (``model_flops / (ms · PEAK_FLOPS)``), with the card's name and power
    limit. ``python3 chip_smoke.py dryrun`` runs the device and ``dryrun``
    phases alone.

The store of autotuner winners is ``build/autotune.json``
(``REPRO_TORCH_AUTOTUNE_PATH``), deleted before any plan is compiled, so
every phase before ``autotune`` runs the untuned "auto" choice.

Each phase prints its seconds (``phase_seconds``).

Then the ``kernels`` line, and last ``{"ok": true, "device": {...}}``. Any
failure raises and exits non-zero; so does a machine without a card, or a
directory holding this script and nothing else of the repo.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing
from torch.distributed.tensor import DTensor
from torch.distributed.tensor import zeros as dtensor_zeros

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.append(str(ROOT / "tools"))

from mesh_b4 import ARCHS as B4_ARCHS  # noqa: E402
from mesh_b4 import train_counted  # noqa: E402
from repro_torch.analysis import audit, op_lint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import ShapeCell  # noqa: E402
from repro_torch.core import autotune  # noqa: E402
from repro_torch.core import backends as _backends  # noqa: E402
from repro_torch.core.backends import compute_regions  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    glcm_auto_sharded,
    glcm_sharded,
    glcm_sharded_batch,
)
from repro_torch.core.glcm import PAPER_PAIRS, VOLUME_PAIRS, glcm, glcm_features  # noqa: E402
from repro_torch.core.pipeline import coalesce_images, glcm_feature_stream  # noqa: E402
from repro_torch.core.haralick import haralick_features  # noqa: E402
from repro_torch.core.plan import compile_plan  # noqa: E402
from repro_torch.core.quantize import bin_values, quantize_uniform, uniform_params  # noqa: E402
from repro_torch.core.schemes import extract_regions  # noqa: E402
from repro_torch.core.spec import GLCMSpec  # noqa: E402
from repro_torch.data.images import (  # noqa: E402
    random_texture,
    random_volume,
    smooth_texture,
    smooth_volume,
    texture_video,
)
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.glcm_kernel import (  # noqa: E402
    KIND_BYTE,
    KIND_FLOAT,
    glcm_fused,
    glcm_fused_plain,
    glcm_volume,
    glcm_volume_plain,
    glcm_vote,
    glcm_vote_plain,
    glcm_window,
    glcm_window_plain,
    launch_plan,
)
from repro_torch.kernels.histogram_kernel import histogram, histogram_plain  # noqa: E402
from repro_torch.kernels.mcc_kernel import (  # noqa: E402
    EIG_CHUNK_ELEMENTS,
    second_eigenvalue,
    second_eigenvalue_plain,
)
from repro_torch.kernels.ops import default_slab_d, default_tile_h  # noqa: E402
from repro_torch.kernels.tail_kernel import haralick_tail, haralick_tail_plain  # noqa: E402
from repro_torch.launch.mesh import make_compat_mesh, make_host_mesh  # noqa: E402
from repro_torch.models import build_model, describe  # noqa: E402
from repro_torch.models.common import param_count  # noqa: E402
from repro_torch.models.convert import reference_tree  # noqa: E402
from repro_torch.models.model import model_module  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.data.tokens import SyntheticTokens  # noqa: E402
from repro_torch.models.convert import load_reference_tree  # noqa: E402
from repro_torch.sharding import gloo_cuda  # noqa: E402
from repro_torch.train import checkpoint as train_ckpt  # noqa: E402
from repro_torch.train.fault_tolerance import reshard_tree  # noqa: E402
from repro_torch.train.loop import (  # noqa: E402
    TrainLoopConfig,
    on_mesh,
    shard_batch,
    shard_params,
    state_shardings,
    train,
)
from repro_torch.train.optimizer import adamw_init, adamw_update, make_optimizer  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    DIRECTIONS_3D,
    glcm_offsets,
    glcm_offsets_3d,
    pair_planes_nd,
)
from repro_torch.obs.metrics import get_registry  # noqa: E402
from repro_torch.obs.report import load_trace, validate_chrome  # noqa: E402
from repro_torch.obs.trace import Tracer, set_tracer  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    Engine,
    GLCMEngine,
    GLCMServeConfig,
    QueueFullError,
    ServeConfig,
)

# NVIDIA H100 SXM data sheet: device memory rate and the float32 rate outside
# the tensor cores (the table has no int32 rate; the kernels' integer adds
# and binning arithmetic are counted against it).
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
FP64_OPS_PER_S = 33.5e12  # float64 outside the tensor cores (f14's eigensolver)

LEVELS = 32
FEATURE_RTOL, FEATURE_ATOL, F14_ATOL = 1e-5, 1e-6, 1e-4
DEV = torch.device("cuda", 0)

# The texture map (benchmarks/texture_map.py's geometry at the paper's size)
# and the volumes of the main path.
WINDOW, WINDOW_STRIDE, TILE = 32, 16, 256
STACK_SHAPE = (8, 4096, 4096)  # 4 smooth + 4 random textures
VOLUME_SHAPE = (256, 512, 512)
VOLUME_DIRECTION = 7

# The streams: texture_video(4096, 32, change_at=16), a 16-frame global
# window and an 8-frame texture-map window; the pipeline's 32 host images.
VIDEO_FRAMES, VIDEO_CHANGE, STREAM_WINDOW, TEXTURE_WINDOW = 32, 16, 16, 8
PIPELINE_IMAGES = 32


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


def exact_counts(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Both int32 and equal, with no cast: a float32 copy of either side
    would round a cell past 2**24 and hide a difference there."""
    return a.dtype == b.dtype == torch.int32 and torch.equal(a, b)


def reset_launches() -> None:
    for k in build.wrappers():
        k.launches = 0


def launches() -> dict:
    return {k.__name__: k.launches for k in build.wrappers()}


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time for the work in ms, and what bounds it: each input
    read once and each output written once over the memory rate, against the
    operations over the scalar rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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
    # The launches the redesigned kernels make on the main path (L = 32):
    # blocks per SM, shared memory, ring geometry, grid, registers.
    offsets = tuple(glcm_offsets(d, t) for d, t in PAPER_PAIRS)
    plans = {
        "glcm_fused_float32": launch_plan("glcm_fused", STACK_SHAPE, offsets, levels=LEVELS,
                                          split=default_tile_h(offsets), kind=KIND_FLOAT),
        "glcm_fused_uint8": launch_plan("glcm_fused", STACK_SHAPE, offsets, levels=LEVELS,
                                        split=default_tile_h(offsets), kind=KIND_BYTE),
        "glcm_volume_float32": launch_plan("glcm_volume", (2,) + VOLUME_SHAPE, DIRECTIONS_3D,
                                           levels=LEVELS, split=default_slab_d(DIRECTIONS_3D),
                                           kind=KIND_FLOAT),
    }
    for name, kind in (("float32", KIND_FLOAT), ("uint8", KIND_BYTE)):
        plans[f"glcm_window_{name}"] = launch_plan(
            "glcm_window", (1,) + STACK_SHAPE[1:], offsets, levels=LEVELS, region_shape=WINDOW,
            stride=WINDOW_STRIDE, kind=kind)
    emit({"phase": "build", "seconds": seconds, "ptxas": ptxas, "launch_plans_L32": plans})


def _edge_values(rng, shape, lo: float, span: float, levels: int) -> np.ndarray:
    """Raw f32 values of which a quarter lie exactly on bin edges."""
    x = (lo + rng.random(shape) * span).astype(np.float32)
    edges = (lo + rng.integers(0, levels + 1, size=shape) * (span / levels)).astype(np.float32)
    mask = rng.random(shape) < 0.25
    return np.where(mask, edges, x).astype(np.float32)


def phase_kernel_check() -> None:
    rng = np.random.default_rng(1234)
    cases = march_cases = 0
    for levels in CHECK_LEVELS:
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
        cases += _check_window(rng, levels) + _check_volume(rng, levels)
        march_cases += _check_march(rng, levels)
    cases += _check_window_odd_slots(rng)
    hist_cases = _check_histogram(rng)
    torch.cuda.synchronize()
    emit({"phase": "kernel_check", "cases": cases + march_cases + hist_cases,
          "levels": list(CHECK_LEVELS), "march_edge_cases": march_cases,
          "histogram_cases": hist_cases, "histogram_levels": list(HISTOGRAM_LEVELS),
          "exact": True})


# L = 255 is the largest L with uint8 ring levels (sentinel 255); L = 256
# takes uint16 levels.
CHECK_LEVELS = (8, 32, 64, 128, 255, 256)


def _edge_levels(rng, shape, levels: int, strip: int = 4096) -> np.ndarray:
    """int32 levels with values outside [0, L) on the first and last rows and
    columns and on both sides of a strip boundary (column `strip`)."""
    x = rng.integers(0, levels, size=shape).astype(np.int32)
    x[..., 0], x[..., -1] = -1, levels + 5
    x[..., 0, :], x[..., -1, :] = -7, levels
    if shape[-1] > strip:
        x[..., strip - 1], x[..., strip] = levels, -1
    return x


def _check_march(rng, levels: int) -> int:
    """glcm_fused and glcm_volume at the edges of their marching rings:
    uint8 raw input with per-image and scalar ranges; a width past one
    4096-column strip that is not a multiple of 16 bytes; H < 1 + max dy;
    out-of-range levels on the strip and ring edges; slices of a stack (a
    non-zero storage offset, 16-byte aligned and not); a volume of depth 1
    and dz == slab_d."""
    cases = 0

    def same(got, want, what):
        nonlocal cases
        require(torch.equal(got, want), f"{what} L={levels}")
        cases += 1

    offsets = tuple(glcm_offsets(d, t) for d, t in PAPER_PAIRS) + ((8, 3), (8, -7), (0, 5))
    for h, w in ((3, 4129), (37, 513)):  # H = 3 < 1 + max dy = 9
        u8 = torch.from_numpy(rng.integers(0, 256, size=(3, h, w), dtype=np.uint8)).to(DEV)
        for quant in (uniform_params(u8, batched=True), (3.0, 200.0)):
            same(glcm_fused(u8, levels=levels, offsets=offsets, quant=quant),
                 glcm_fused_plain(u8, levels, offsets, quant=quant), f"fused uint8 {h}x{w}")
        same(glcm_fused(u8[1:], levels=levels, offsets=offsets, quant=(3.0, 200.0)),
             glcm_fused_plain(u8[1:], levels, offsets, quant=(3.0, 200.0)),
             f"fused uint8 slice {h}x{w}")
        ints = torch.from_numpy(_edge_levels(rng, (3, h, w), levels)).to(DEV)
        for x in (ints, ints[1:]):
            same(glcm_fused(x, levels=levels, offsets=offsets),
                 glcm_fused_plain(x, levels, offsets), f"fused edge levels {h}x{w}")
        flat = torch.from_numpy(_edge_values(rng, (2 * h * w + 3,), -3.5, 7.25, levels)).to(DEV)
        odd = flat[3:].reshape(2, h, w)  # rows 4-byte aligned, not 16
        same(glcm_fused(odd, levels=levels, offsets=offsets, quant=(-3.5, 7.25)),
             glcm_fused_plain(odd, levels, offsets, quant=(-3.5, 7.25)), f"fused offset {h}x{w}")
    extra = tuple(glcm_offsets_3d(2, k) for k in (4, 8, 12)) + ((8, 1, -2), (0, -3, 5))
    for d, h, w in ((1, 9, 40), (19, 23, 29)):
        u8 = torch.from_numpy(rng.integers(0, 256, size=(3, d, h, w), dtype=np.uint8)).to(DEV)
        ints = torch.from_numpy(_edge_levels(rng, (3, d, h, w), levels)).to(DEV)
        for offs in (DIRECTIONS_3D, extra):  # extra: dz == slab_d = 8
            for quant in (uniform_params(u8, batched=True), (3.0, 200.0)):
                same(glcm_volume(u8, levels=levels, offsets=offs, quant=quant),
                     glcm_volume_plain(u8, levels, offs, quant=quant), f"volume uint8 d={d}")
            same(glcm_volume(u8[1:], levels=levels, offsets=offs, quant=(3.0, 200.0)),
                 glcm_volume_plain(u8[1:], levels, offs, quant=(3.0, 200.0)),
                 f"volume uint8 slice d={d}")
            for x in (ints, ints[1:]):
                same(glcm_volume(x, levels=levels, offsets=offs),
                     glcm_volume_plain(x, levels, offs), f"volume edge levels d={d}")
    return cases


HISTOGRAM_LEVELS = (1, 8, 32, 256, 4096, 65536)


def _hist_values(rng, n: int, levels: int, dtype) -> np.ndarray:
    """Values mostly in [0, L) with -1 pads and values outside [0, L) on both
    sides where the dtype holds them; floats carry fractions, negative ones
    included (they truncate toward zero)."""
    info = np.iinfo(dtype) if np.issubdtype(dtype, np.integer) else None
    lo = -3 if info is None else max(-3, int(info.min))
    hi = levels + 3 if info is None else min(levels + 3, int(info.max) + 1)
    v = rng.integers(lo, hi, size=n)
    if lo < 0:
        v[::7] = -1
    if info is None:
        return (v + rng.choice([0.0, 0.25, 0.5, 0.99], size=n)).astype(dtype)
    return v.astype(dtype)


def _check_histogram(rng) -> int:
    """histogram against its plain version: every L of HISTOGRAM_LEVELS
    (65536 takes the global-atomics path), lengths that are not a multiple
    of the chunk, an empty input, -1 and other out-of-range values, five
    input dtypes, and R = 4 / R = 3 with chunks 2048 / 96."""
    cases = 0
    for levels in HISTOGRAM_LEVELS:
        for dtype in (np.int8, np.uint8, np.int32, np.int64, np.float32):
            for n in (1, 2047, 1_000_003):
                v = torch.from_numpy(_hist_values(rng, n, levels, dtype)).to(DEV)
                want = histogram_plain(v, levels)
                for chunk, copies in ((2048, 4), (96, 3)):
                    got = histogram(v, levels=levels, chunk=chunk, copies=copies)
                    require(torch.equal(got, want),
                            f"histogram L={levels} {dtype.__name__} n={n} R={copies}")
                    cases += 1
        empty = histogram(torch.empty(0, dtype=torch.int32, device=DEV), levels=levels)
        require(torch.equal(empty, torch.zeros(levels, dtype=torch.int32, device=DEV)),
                f"histogram of an empty input, L={levels}")
        cases += 1
    return cases


def _check_window(rng, levels: int) -> int:
    """glcm_window against its plain version: overlapping windows with a
    ragged edge and tiles, a grid row of 17 windows (a full staged run and
    a short one), dy == rh - 1, dx < 0 and |dx| == rw - 1, out-of-range
    levels, float32 and uint8 input with scalar and per-image quantization,
    slices of the batch, and extracted patch grids (int32, uint8)."""
    cases = 0

    def same(got, want, what):
        nonlocal cases
        require(torch.equal(got, want), f"glcm_window {what} L={levels}")
        cases += 1

    offsets = tuple(glcm_offsets(d, t) for d, t in PAPER_PAIRS) + (
        (15, 3), (0, -11), (7, -5), (2, 11))
    for h, w in ((45, 39), (45, 124)):  # (45 - 16) % 5 and (39 - 12) % 7 are not 0
        ints = torch.from_numpy(
            rng.integers(-2, levels + 2, size=(3, h, w)).astype(np.int32)).to(DEV)
        raw = torch.from_numpy(np.stack([_edge_values(rng, (h, w), lo, sp, levels) for lo, sp
                                         in ((0.0, 255.0), (-3.5, 7.25), (1.0, 3.0))])).to(DEV)
        u8 = torch.from_numpy(rng.integers(0, 256, size=(3, h, w), dtype=np.uint8)).to(DEV)
        for region, stride in (((16, 12), (5, 7)), ((16, 12), None)):
            kw = dict(region_shape=region, stride=stride)
            want = glcm_window_plain(ints, levels, offsets, **kw)
            for copies in (1, 3):
                same(glcm_window(ints, levels=levels, offsets=offsets, copies=copies, **kw),
                     want, f"int {h}x{w} {region}/{stride} R={copies}")
            same(glcm_window(ints[1:], levels=levels, offsets=offsets, **kw), want[1:],
                 f"int slice {h}x{w} {region}/{stride}")
            for x in (raw, u8):
                for quant in (uniform_params(x, batched=True), (-3.5, 7.25)):
                    same(glcm_window(x, levels=levels, offsets=offsets, quant=quant, **kw),
                         glcm_window_plain(x, levels, offsets, quant=quant, **kw),
                         f"{x.dtype} quant {h}x{w} {region}/{stride}")
            same(glcm_window(u8[1:], levels=levels, offsets=offsets, quant=(3.0, 200.0), **kw),
                 glcm_window_plain(u8[1:], levels, offsets, quant=(3.0, 200.0), **kw),
                 f"uint8 slice {h}x{w} {region}/{stride}")
        patches = extract_regions(ints, (16, 12), (5, 7))
        same(glcm_window(patches, levels=levels, offsets=offsets),
             glcm_window_plain(ints, levels, offsets, region_shape=(16, 12), stride=(5, 7)),
             f"patch grid {h}x{w}")
        q8 = uniform_params(u8, batched=True)
        same(glcm_window(extract_regions(u8, (16, 12), (5, 7)), levels=levels, offsets=offsets,
                         quant=q8),
             glcm_window_plain(u8, levels, offsets, region_shape=(16, 12), stride=(5, 7),
                               quant=q8), f"uint8 patch grid {h}x{w}")
    return cases


def _check_window_odd_slots(rng) -> int:
    """glcm_window against its plain version at odd L, where a slot of
    n_off L x L int32 is whole 16-byte units (staged path) only when n_off
    is a multiple of 4, and is otherwise stored by the direct path:
    L in {3, 5, 7} with 2 to 5 offsets, overlapping windows and tiles,
    int32 levels, float32 and uint8 input."""
    cases = 0
    offsets = ((0, 1), (1, -1), (15, 3), (2, -11), (0, 11))
    for levels in (3, 5, 7):
        ints = torch.from_numpy(
            rng.integers(-1, levels + 2, size=(3, 45, 39)).astype(np.int32)).to(DEV)
        u8 = torch.from_numpy(rng.integers(0, 256, size=(3, 45, 39), dtype=np.uint8)).to(DEV)
        raw = u8.to(torch.float32) * 0.37 - 5.0
        for n_off in (2, 3, 4, 5):
            for region, stride in (((16, 12), (5, 7)), ((16, 12), None)):
                kw = dict(region_shape=region, stride=stride)
                for x in (ints, raw, u8):
                    quant = None if x is ints else uniform_params(x, batched=True)
                    for copies in (1, 2):
                        got = glcm_window(x, levels=levels, offsets=offsets[:n_off],
                                          quant=quant, copies=copies, **kw)
                        want = glcm_window_plain(x, levels, offsets[:n_off], quant=quant, **kw)
                        require(torch.equal(got, want),
                                f"glcm_window {x.dtype} L={levels} n_off={n_off} "
                                f"{region}/{stride} R={copies}")
                        cases += 1
    return cases


def _check_volume(rng, levels: int) -> int:
    """glcm_volume against its plain version: a depth that is not a multiple
    of slab_d, all 13 directions, d = 2, dz == slab_d, out-of-range levels,
    scalar and per-image quantization."""
    cases = 0
    d, h, w = 19, 23, 29
    ints = torch.from_numpy(
        rng.integers(-2, levels + 2, size=(2, d, h, w)).astype(np.int32)).to(DEV)
    raw = torch.from_numpy(np.stack([_edge_values(rng, (d, h, w), lo, sp, levels)
                                     for lo, sp in ((0.0, 255.0), (-3.5, 7.25))])).to(DEV)
    extra = tuple(glcm_offsets_3d(2, k) for k in (4, 8, 12)) + ((8, 1, -2), (0, -3, 5))
    for offsets, slab_d in ((DIRECTIONS_3D, 8), (extra, 8), (DIRECTIONS_3D, 3)):
        want = glcm_volume_plain(ints, levels, offsets)
        for copies in (1, 2):
            got = glcm_volume(ints, levels=levels, offsets=offsets, slab_d=slab_d,
                              copies=copies)
            require(torch.equal(got, want), f"glcm_volume int L={levels} slab_d={slab_d} "
                                            f"R={copies}")
            cases += 1
        for quant in (uniform_params(raw, batched=True), (-3.5, 7.25)):
            want = glcm_volume_plain(raw, levels, offsets, quant=quant)
            got = glcm_volume(raw, levels=levels, offsets=offsets, slab_d=slab_d, quant=quant)
            require(torch.equal(got, want), f"glcm_volume quant L={levels} slab_d={slab_d}")
            cases += 1
    return cases


def make_inputs():
    t0 = time.perf_counter()
    stack = np.stack([smooth_texture(4096, seed=s) for s in range(4)]
                     + [random_texture(4096, seed=s) for s in range(4)]).astype(np.float32)
    big = smooth_texture(16384, seed=11).astype(np.float32)
    vol = np.stack([smooth_volume(VOLUME_SHAPE, seed=0),
                    random_volume(VOLUME_SHAPE, seed=0)]).astype(np.float32)
    stack_t = torch.from_numpy(stack).to(DEV)
    big_t = torch.from_numpy(big).to(DEV)
    vol_t = torch.from_numpy(vol).to(DEV)
    torch.cuda.synchronize()
    emit({"phase": "inputs", "seconds": time.perf_counter() - t0,
          "stack": list(stack_t.shape), "stack_bytes": stack_t.numel() * 4,
          "image": list(big_t.shape), "image_bytes": big_t.numel() * 4,
          "volumes": list(vol_t.shape), "volume_bytes": vol_t.numel() * 4})
    return stack_t, big_t, vol_t


def _drive(out: dict, name: str, fn):
    """Run one entry point with every launch count set to 0 just before it
    and read just after it; host seconds to the end of its device work."""
    reset_launches()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    out[f"{name}_s"] = time.perf_counter() - t0
    out[f"{name}_launches"] = launches()
    return result


def phase_main_path(stack: torch.Tensor, big: torch.Tensor, vol: torch.Tensor) -> dict:
    out = {}
    feats = _drive(out, "features", lambda: glcm_features(stack, LEVELS))
    mat = _drive(out, "glcm", lambda: glcm(big, LEVELS, d=1, theta=45, quantize="uniform"))
    # texture-map-4096: one GLCM per 32 x 32 window at stride 16, all 14
    # features; the peak memory is the feature tail's.
    torch.cuda.reset_peak_memory_stats(DEV)
    texture = _drive(out, "texture", lambda: glcm_features(
        stack[0], LEVELS, region="window", region_shape=WINDOW, region_stride=WINDOW_STRIDE))
    out["texture_peak_bytes"] = torch.cuda.max_memory_allocated(DEV)
    tiles = _drive(out, "tiles", lambda: glcm(
        stack[4], LEVELS, d=1, theta=0, quantize="uniform", region="tiles", region_shape=TILE))
    # volume-2x256x512x512: all 13 directions, and one direction alone.
    vfeats = _drive(out, "volume", lambda: glcm_features(vol, LEVELS, VOLUME_PAIRS, ndim=3))
    vmat = _drive(out, "volume_glcm", lambda: glcm(
        vol[0], LEVELS, theta=VOLUME_DIRECTION, ndim=3, quantize="uniform"))
    # f1-f13 and f14 at L = 32: one launch of the tail kernel and one of the
    # eigensolver a call with features.
    for kernel in ("haralick_tail", "second_eigenvalue"):
        n = {p: out[f"{p}_launches"][kernel] for p in ("features", "texture", "volume")}
        require(all(k == 1 for k in n.values()), f"{kernel} launched {n} times; expected once a call")
    emit({"phase": "main_path", **out,
          "features_shape": list(feats.shape), "glcm_shape": list(mat.shape),
          "texture_shape": list(texture.shape), "tiles_shape": list(tiles.shape),
          "volume_shape": list(vfeats.shape), "volume_glcm_shape": list(vmat.shape)})
    out.update(feats=feats, mat=mat, texture=texture, tiles=tiles, vfeats=vfeats, vmat=vmat)
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
    require(exact_counts(plan_counts, counts), "plan counts != kernel counts")
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
    require(exact_counts(mat, vcounts[0]), "glcm() != kernel counts")
    # Cells past 2**24, where a float32 copy of the counts would round.
    past_2_24 = int((vcounts >= 2**24).sum().item())
    out = {"fused_scheme": fused_scheme, "vote_scheme": vote_scheme,
           "fused_max_abs_err": fused_err, "vote_max_abs_err": vote_err,
           "features_max_abs_err_f1_f13": f_err, "features_max_abs_err_f14": f14_err,
           "vote_total": total, "vote_cells_past_2_24": past_2_24,
           "fused_votes_per_offset": votes_per_offset}
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
    t.update(_halves("fused", stack, quant, lambda x, q: glcm_fused(
        x, levels=LEVELS, offsets=offsets, tile_h=tile_h, quant=q), reps=10))
    t["fused_plain_ms"] = cuda_ms(lambda: glcm_fused_plain(stack, LEVELS, offsets,
                                                           quant=quant), reps=3)
    t["vote_ms"] = cuda_ms(lambda: glcm_vote(a, r, levels=LEVELS, copies=1), reps=10)
    t["vote_plain_ms"] = cuda_ms(lambda: glcm_vote_plain(a, r, LEVELS), reps=3)
    pos = (r.to(torch.int64) * LEVELS + a.to(torch.int64)).reshape(-1)
    t["vote_library_ms"] = cuda_ms(
        lambda: torch.bincount(pos, minlength=LEVELS * LEVELS), reps=3)
    del pos

    # Bounds (see bound()).
    fused_votes = sum(b * (h - dy) * (w - abs(dx)) for dy, dx in offsets)
    fused_bytes = stack.numel() * 4 + b * 2 * 4 + b * len(offsets) * LEVELS**2 * 4
    fused_ops = 5 * stack.numel() + fused_votes  # binning once per pixel, one add per vote
    vote_bytes = 2 * n * 4 + LEVELS**2 * 4
    vote_ops = n
    t["fused_bound_ms"], t["fused_bound_by"] = bound(fused_bytes, fused_ops)
    t["vote_bound_ms"], t["vote_bound_by"] = bound(vote_bytes, vote_ops)

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
    # kernel reads it as it is. The range reduction is timed on its own.
    u8 = stack.to(torch.uint8)
    spec = GLCMSpec(levels=LEVELS, pairs=PAPER_PAIRS, quantize="uniform")
    require(torch.equal(compile_plan(spec, tuple(u8.shape))(u8),
                        compile_plan(spec, tuple(stack.shape))(stack)),
            "uint8 stack counts != float32 stack counts")
    q8 = uniform_params(u8, batched=True)
    t["uniform_params_uint8_ms"] = cuda_ms(lambda: uniform_params(u8, batched=True), reps=10)
    fused8 = lambda x, q: glcm_fused(x, levels=LEVELS, offsets=offsets,  # noqa: E731
                                     tile_h=tile_h, quant=q)
    require(torch.equal(fused8(u8, q8), glcm_fused(stack, levels=LEVELS, offsets=offsets,
                                                  tile_h=tile_h, quant=quant)),
            "glcm_fused on the uint8 stack != on the float32 stack")
    # No float32 copy of the stack: the launch allocates less than one.
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(DEV)
    torch.cuda.reset_peak_memory_stats(DEV)
    fused8(u8, q8)
    torch.cuda.synchronize()
    t["fused_uint8_peak_bytes"] = torch.cuda.max_memory_allocated(DEV) - before
    t["stack_float32_bytes"] = u8.numel() * 4
    require(t["fused_uint8_peak_bytes"] < t["stack_float32_bytes"],
            f"glcm_fused on uint8 allocated {t['fused_uint8_peak_bytes']} bytes")
    t["fused_uint8_ms"] = cuda_ms(lambda: fused8(u8, q8), reps=10)
    t.update(_halves("fused_uint8", u8, q8, fused8, reps=10))
    t["fused_uint8_bound_ms"], t["fused_uint8_bound_by"] = bound(
        u8.numel() + b * 2 * 4 + b * len(offsets) * LEVELS**2 * 4, fused_ops)
    t["fused_uint8_plain_ms"] = cuda_ms(lambda: glcm_fused_plain(u8, LEVELS, offsets, quant=q8),
                                        reps=3)
    t["fused_uint8_max_abs_err"] = max_abs_err(
        fused8(u8, q8), glcm_fused_plain(u8, LEVELS, offsets, quant=q8))
    require(t["fused_uint8_max_abs_err"] == 0, "glcm_fused on the uint8 stack != plain")
    glcm_features(u8, LEVELS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        glcm_features(u8, LEVELS)
    torch.cuda.synchronize()
    t["features_uint8_images_per_s"] = reps * b / (time.perf_counter() - t0)

    # The count of features-4096-L256: the uint8 stack at L = 256 over
    # scikit-image's four offsets, one set of 1 MB that no block holds.
    wide = tuple(glcm_offsets(1, theta) for theta in (0, 45, 90, 135))
    fused256 = lambda x, q: glcm_fused(x, levels=256, offsets=wide,  # noqa: E731
                                       tile_h=default_tile_h(wide), quant=q)
    t["fused_L256_cluster"] = launch_plan("glcm_fused", tuple(u8.shape), wide, levels=256,
                                          split=default_tile_h(wide), kind=KIND_BYTE)["cluster"]
    require(torch.equal(fused256(u8, q8), glcm_fused_plain(u8, 256, wide, quant=q8)),
            "glcm_fused at L = 256 != plain")
    t["fused_L256_ms"] = cuda_ms(lambda: fused256(u8, q8), reps=10)
    t.update(_halves("fused_L256", u8, q8, fused256, reps=10))
    emit({"phase": "timing", **t})
    return t


def _halves(name: str, x: torch.Tensor, quant, fn, reps: int) -> dict:
    """Times ``fn(x[part], quant[part])`` on the smooth and the random half
    of a main-path input (its first and second half along the batch)."""
    half = x.shape[0] // 2
    out = {}
    for part, sl in (("smooth", slice(0, half)), ("random", slice(half, None))):
        xs, qs = x[sl], (quant[0][sl], quant[1][sl])
        out[f"{name}_{part}_ms"] = cuda_ms(lambda: fn(xs, qs), reps=reps)
    return out


def _features_err(got: torch.Tensor, counts: torch.Tensor, what: str) -> tuple[float, float]:
    """Hold features from the card to those of ``counts`` computed on the
    CPU, within PR 11's tolerances; return the largest f1-f13 and f14 gaps."""
    want = haralick_features(counts.cpu().to(torch.float32)).numpy()
    got = got.cpu().numpy()
    require(np.isfinite(got).all() and got.shape == want.shape,
            f"{what}: features not finite or of shape {got.shape} != {want.shape}")
    f_err = float(np.abs(got[..., :13] - want[..., :13]).max())
    f14_err = float(np.abs(got[..., 13] - want[..., 13]).max())
    require(np.allclose(got[..., :13], want[..., :13], rtol=FEATURE_RTOL, atol=FEATURE_ATOL),
            f"{what}: features f1-f13 differ (max abs {f_err})")
    require(np.allclose(got[..., 13], want[..., 13], rtol=0, atol=F14_ATOL),
            f"{what}: feature f14 differs (max abs {f14_err})")
    return f_err, f14_err


def _only(counts: dict, kernels: tuple[str, ...], what: str) -> None:
    for name, n in counts.items():
        require((n > 0) == (name in kernels),
                f"{what}: {name} launched {n} times; expected launches of {kernels} only")


def phase_texture_checks(stack, main) -> dict:
    img, rnd = stack[0], stack[4]
    spec = GLCMSpec(levels=LEVELS, pairs=PAPER_PAIRS, quantize="uniform", region="window",
                    region_shape=WINDOW, region_stride=WINDOW_STRIDE)
    plan = compile_plan(spec, tuple(img.shape), features=True)
    require(plan.spec.scheme == "cuda_fused" and plan.backend.caps.region_grid,
            f"texture map resolved to {plan.spec.scheme}")
    grid = tuple((n - WINDOW) // WINDOW_STRIDE + 1 for n in img.shape)
    require(plan.grid == grid, f"texture grid {plan.grid} != {grid}")
    tspec = GLCMSpec(levels=LEVELS, pairs=((1, 0),), quantize="uniform", region="tiles",
                     region_shape=TILE)
    tplan = compile_plan(tspec, tuple(rnd.shape))
    require(tplan.spec.scheme == "cuda" and not tplan.backend.caps.region_grid,
            f"tiles resolved to {tplan.spec.scheme}")
    _only(main["texture_launches"], ("glcm_window", "haralick_tail", "second_eigenvalue"),
          "texture map")
    _only(main["tiles_launches"], ("glcm_vote",), "tiles")

    # Window kernel vs plain on the texture map's image and range.
    offsets = tuple(glcm_offsets(d, t) for d, t in PAPER_PAIRS)
    quant = uniform_params(img)
    kw = dict(region_shape=(WINDOW, WINDOW), stride=(WINDOW_STRIDE, WINDOW_STRIDE))
    counts = glcm_window(img, levels=LEVELS, offsets=offsets, quant=quant, **kw)
    plain = glcm_window_plain(img, LEVELS, offsets, quant=quant, **kw)
    window_err = max_abs_err(counts, plain)
    require(window_err == 0, f"glcm_window differs from plain by {window_err}")
    require(tuple(counts.shape) == grid + (len(offsets), LEVELS, LEVELS), "window counts shape")
    require(exact_counts(compile_plan(spec, tuple(img.shape))(img), counts),
            "texture plan counts != kernel counts")
    per_window = counts.to(torch.int64).sum(dim=(-2, -1))  # (gh, gw, n_off)
    expect = torch.tensor([(WINDOW - dy) * (WINDOW - abs(dx)) for dy, dx in offsets],
                          device=DEV)
    require(bool((per_window == expect).all()), "window vote totals")
    del plain, per_window
    f_err, f14_err = _features_err(main["texture"], counts, "texture map")

    # Tiles: the generic fallback votes each 256² tile's pair stream.
    lo, span = uniform_params(rnd)
    tiles = extract_regions(rnd, (TILE, TILE), (TILE, TILE)).reshape(-1, TILE, TILE)
    assoc, ref = pair_planes_nd(tiles, glcm_offsets(1, 0))
    a = bin_values(assoc, LEVELS, lo, span).reshape(tiles.shape[0], -1)
    r = bin_values(ref, LEVELS, lo, span).reshape(tiles.shape[0], -1)
    tplain = glcm_vote_plain(a, r, LEVELS)
    require(exact_counts(main["tiles"].reshape(tplain.shape), tplain),
            "tiles counts != glcm_vote_plain")
    require(bool((tplain.to(torch.int64).sum(dim=(1, 2)) == TILE * (TILE - 1)).all()),
            "tile vote totals")
    out = {"texture_scheme": plan.spec.scheme, "texture_grid": list(plan.grid),
           "tiles_scheme": tplan.spec.scheme, "tiles_grid": list(tplan.grid),
           "window_max_abs_err": window_err, "texture_features_max_abs_err_f1_f13": f_err,
           "texture_features_max_abs_err_f14": f14_err,
           "texture_windows": grid[0] * grid[1]}
    emit({"phase": "checks", "path": "texture-map-4096", **out})
    out.update(offsets=offsets, quant=quant, counts=counts)
    return out


def phase_volume_checks(vol, main) -> dict:
    spec = GLCMSpec(levels=LEVELS, pairs=VOLUME_PAIRS, quantize="uniform", ndim=3)
    one = GLCMSpec(levels=LEVELS, pairs=((1, VOLUME_DIRECTION),), quantize="uniform", ndim=3)
    scheme = compile_plan(spec, tuple(vol.shape), features=True).spec.scheme
    one_scheme = compile_plan(one, tuple(vol[0].shape)).spec.scheme
    require(scheme == "cuda_volume" and one_scheme == "cuda_volume",
            f"volumes resolved to {scheme}, {one_scheme}")
    _only(main["volume_launches"], ("glcm_volume", "haralick_tail", "second_eigenvalue"),
          "volume features")
    _only(main["volume_glcm_launches"], ("glcm_volume",), "volume glcm")

    offsets = DIRECTIONS_3D
    slab_d = default_slab_d(offsets)
    quant = uniform_params(vol, batched=True)
    counts = glcm_volume(vol, levels=LEVELS, offsets=offsets, slab_d=slab_d, quant=quant)
    plain = glcm_volume_plain(vol, LEVELS, offsets, quant=quant)
    volume_err = max_abs_err(counts, plain)
    require(volume_err == 0, f"glcm_volume differs from plain by {volume_err}")
    require(exact_counts(compile_plan(spec, tuple(vol.shape))(vol), counts),
            "volume plan counts != kernel counts")
    b, d, h, w = vol.shape
    votes = counts.to(torch.int64).sum(dim=(-2, -1))  # (B, 13)
    expect = torch.tensor([(d - dz) * (h - abs(dy)) * (w - abs(dx)) for dz, dy, dx in offsets],
                          device=DEV)
    require(bool((votes == expect).all()), "volume vote totals")
    f_err, f14_err = _features_err(main["vfeats"], counts, "volume features")

    off7 = glcm_offsets_3d(1, VOLUME_DIRECTION)
    q0 = uniform_params(vol[0])
    one_plain = glcm_volume_plain(vol[:1], LEVELS, (off7,), quant=q0)[0, 0]
    require(exact_counts(main["vmat"], one_plain),
            "volume glcm() != glcm_volume_plain")
    require(int(one_plain.to(torch.int64).sum()) == (d - off7[0]) * (h - abs(off7[1]))
            * (w - abs(off7[2])), "direction-7 vote total")
    out = {"volume_scheme": scheme, "volume_glcm_scheme": one_scheme,
           "volume_max_abs_err": volume_err, "volume_features_max_abs_err_f1_f13": f_err,
           "volume_features_max_abs_err_f14": f14_err,
           "volume_votes_per_direction": votes[0].tolist()}
    emit({"phase": "checks", "path": "volume-2x256x512x512", **out})
    out.update(offsets=offsets, slab_d=slab_d, quant=quant, counts=counts)
    return out


def _host_seconds(fn, reps: int) -> float:
    """Mean host seconds per call of ``fn``, to the end of its device work,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def phase_texture_timing(stack, chk) -> dict:
    img, offsets, quant = stack[0], chk["offsets"], chk["quant"]
    kw = dict(region_shape=(WINDOW, WINDOW), stride=(WINDOW_STRIDE, WINDOW_STRIDE))
    t = {}
    t["window_ms"] = cuda_ms(lambda: glcm_window(img, levels=LEVELS, offsets=offsets,
                                                 quant=quant, **kw), reps=10)
    t["window_plain_ms"] = cuda_ms(lambda: glcm_window_plain(img, LEVELS, offsets,
                                                             quant=quant, **kw), reps=3)
    # The same image as its uint8 original (smooth_texture's own dtype), read
    # as it is: the same range, so the same counts, and a launch that
    # allocates nothing but its output.
    u8 = img.to(torch.uint8)
    q8 = uniform_params(u8)
    window8 = lambda x, q: glcm_window(x, levels=LEVELS, offsets=offsets,  # noqa: E731
                                       quant=q, **kw)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(DEV)
    torch.cuda.reset_peak_memory_stats(DEV)
    counts8 = window8(u8, q8)
    torch.cuda.synchronize()
    t["window_uint8_peak_bytes"] = torch.cuda.max_memory_allocated(DEV) - before
    t["window_out_bytes"] = counts8.numel() * 4
    require(t["window_uint8_peak_bytes"] - t["window_out_bytes"] < 65536,
            f"glcm_window on uint8 allocated {t['window_uint8_peak_bytes']} bytes beside "
            f"its {t['window_out_bytes']}-byte output")
    plain8 = glcm_window_plain(u8, LEVELS, offsets, quant=q8, **kw)
    t["window_uint8_max_abs_err"] = max_abs_err(counts8, plain8)
    require(t["window_uint8_max_abs_err"] == 0, "glcm_window on uint8 differs from plain")
    require(torch.equal(counts8, chk["counts"]), "glcm_window uint8 counts != float32 counts")
    del counts8, plain8
    t["window_uint8_ms"] = cuda_ms(lambda: window8(u8, q8), reps=10)
    t["window_uint8_plain_ms"] = cuda_ms(lambda: glcm_window_plain(u8, LEVELS, offsets,
                                                                   quant=q8, **kw), reps=3)
    # The random texture (stack[4]), float32 and uint8: the kernel's time on
    # both kinds of texture.
    rnd = stack[4]
    rnd8 = rnd.to(torch.uint8)
    qr, qr8 = uniform_params(rnd), uniform_params(rnd8)
    t["window_random_ms"] = cuda_ms(lambda: window8(rnd, qr), reps=10)
    t["window_uint8_random_ms"] = cuda_ms(lambda: window8(rnd8, qr8), reps=10)
    # torch.bincount of the linearised (window, k, ref, assoc) index, built
    # outside the timed region.
    windows = img.unfold(0, WINDOW, WINDOW_STRIDE).unfold(1, WINDOW, WINDOW_STRIDE)
    levels = bin_values(windows.reshape(-1, WINDOW, WINDOW), LEVELS, *quant).to(torch.int64)
    n_win, n_off = levels.shape[0], len(offsets)
    win = torch.arange(n_win, device=DEV)[:, None, None]
    parts = []
    for k, off in enumerate(offsets):
        a, r = pair_planes_nd(levels, off)
        parts.append(((win * n_off + k) * LEVELS**2 + r * LEVELS + a).reshape(-1))
    pos = torch.cat(parts)
    del parts, levels
    minlength = n_win * n_off * LEVELS**2
    require(torch.equal(torch.bincount(pos, minlength=minlength).to(torch.int32),
                        chk["counts"].reshape(-1)), "texture bincount != kernel counts")
    t["window_library_ms"] = cuda_ms(lambda: torch.bincount(pos, minlength=minlength), reps=3)
    votes = pos.numel()
    del pos
    nbytes = img.numel() * 4 + 2 * 4 + minlength * 4
    t["window_bound_ms"], t["window_bound_by"] = bound(nbytes, 5 * img.numel() + votes)
    t["window_uint8_bound_ms"], t["window_uint8_bound_by"] = bound(
        nbytes - img.numel() * 3, 5 * img.numel() + votes)

    # End to end, and the Haralick tail alone on the same counts.
    texture = lambda: glcm_features(img, LEVELS, region="window", region_shape=WINDOW,  # noqa: E731
                                    region_stride=WINDOW_STRIDE)
    seconds = _host_seconds(texture, reps=3)
    t["texture_s"] = seconds
    t["texture_windows_per_s"] = n_win / seconds
    spec = GLCMSpec(levels=LEVELS, pairs=PAPER_PAIRS, quantize="uniform", region="window",
                    region_shape=WINDOW, region_stride=WINDOW_STRIDE)
    counts = compile_plan(spec, tuple(img.shape))(img)
    t["texture_tail_s"] = _host_seconds(lambda: haralick_features(counts), reps=2)
    emit({"phase": "timing", "path": "texture-map-4096", **t})
    return t


# ---------------------------------------------------------------------------
# f14's eigensolver (second_eigenvalue)
# ---------------------------------------------------------------------------

MCC_ATOL = 1e-12  # |delta lambda_2| of the kernel against the plain version


def _mcc_inputs(counts: torch.Tensor):
    """Counts -> normalized float64 P and its marginals, as the tail has them."""
    p = counts.to(torch.float64)
    p = p / p.sum(dim=(-2, -1), keepdim=True).clamp_min(1e-12)
    return p, p.sum(dim=2), p.sum(dim=1)


def _mcc_err(p, px, py, what: str) -> float:
    """Launch once, exactly once, and hold the kernel to the plain version."""
    before = second_eigenvalue.launches
    got = second_eigenvalue(p, px, py)
    require(second_eigenvalue.launches == before + 1, f"{what}: launches")
    err = float((got - second_eigenvalue_plain(p, px, py)).abs().max())
    require(err <= MCC_ATOL, f"{what}: |delta lambda_2| {err} > {MCC_ATOL}")
    return err


def phase_mcc(smooth: torch.Tensor, rnd: torch.Tensor) -> dict:
    """second_eigenvalue against its plain version on the texture map's
    260 100 matrices of a smooth and a random 4096² image, each in one
    launch; its CUDA-event ms beside its bound, the plain version (A, G,
    chunked eigvalsh) and eigvalsh alone on the chunks, there and on 32 of
    the smooth matrices (a call of features-4096); the allocation of one
    launch. (The ``cuda`` tests of ``tests/test_torch_kernels.py`` hold it
    at every L and on edge cases.)"""
    out = {}
    spec = GLCMSpec(levels=LEVELS, pairs=PAPER_PAIRS, quantize="uniform", region="window",
                    region_shape=WINDOW, region_stride=WINDOW_STRIDE)
    plan = compile_plan(spec, tuple(smooth.shape))
    chunk = EIG_CHUNK_ELEMENTS // LEVELS**2

    def time_both(name, p, px, py):
        out[f"{name}_ms"] = cuda_ms(lambda: second_eigenvalue(p, px, py), reps=10)
        out[f"{name}_plain_ms"] = cuda_ms(lambda: second_eigenvalue_plain(p, px, py), reps=3)
        a = p / torch.sqrt(px[:, :, None].clamp_min(1e-12) * py[:, None, :].clamp_min(1e-12))
        gram = a @ a.transpose(-1, -2)
        del a
        out[f"{name}_library_ms"] = cuda_ms(
            lambda: [torch.linalg.eigvalsh(g)[:, -2] for g in gram.split(chunk)], reps=3)

    for name, img in (("smooth", smooth), ("random", rnd)):
        counts = plan(img)
        counts = counts + counts.transpose(-1, -2)  # the tail's symmetric GLCMs
        p, px, py = _mcc_inputs(counts.reshape(-1, LEVELS, LEVELS))
        del counts
        out[f"{name}_max_abs_err"] = _mcc_err(p, px, py, f"second_eigenvalue map {name}")
        time_both(name, p, px, py)
        if name == "smooth":
            time_both("batch32", *(t[:32].contiguous() for t in (p, px, py)))
    n = p.shape[0]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(DEV)
    torch.cuda.reset_peak_memory_stats(DEV)
    second_eigenvalue(p, px, py)
    torch.cuda.synchronize()
    out["peak_bytes"] = torch.cuda.max_memory_allocated(DEV) - before
    require(out["peak_bytes"] <= n * 8 + 65536,
            f"second_eigenvalue allocated {out['peak_bytes']} bytes for an {n * 8}-byte output")
    L = LEVELS
    nbytes = n * (L * L + 2 * L + 1) * 8
    # G (symmetric: its upper triangle), the reduction, 53 bisection steps
    flop = n * (L * L * (L + 1) + 4 * L**3 / 3 + 3 * L * 53)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flop / FP64_OPS_PER_S
    out.update(matrices=n, bytes=nbytes, flop=flop, bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "float64 operations")

    # The wide kernel (one block a matrix): scikit-image's L = 256 at
    # distance 1 in four directions, 8 images of each texture as one call of
    # features-4096-L256 has them (32 matrices), against the plain version.
    wide = GLCMSpec(levels=256, pairs=((1, 0), (1, 45), (1, 90), (1, 135)), quantize="uniform")
    stack = torch.stack([smooth, rnd] * 4)
    counts = compile_plan(wide, tuple(stack.shape))(stack)
    p, px, py = _mcc_inputs(counts.reshape(-1, 256, 256))
    out["wide_max_abs_err"] = _mcc_err(p, px, py, "second_eigenvalue L=256")
    out["wide_ms"] = cuda_ms(lambda: second_eigenvalue(p, px, py), reps=10)
    out["wide_plain_ms"] = cuda_ms(lambda: second_eigenvalue_plain(p, px, py), reps=3)
    n = p.shape[0]
    w_bytes, w_flop = n * (256 * 256 + 1) * 8, n * (4 * 256**3 / 3 + 3 * 256 * 53)
    out["wide_bound_ms"] = max(w_bytes / HBM_BYTES_PER_S, w_flop / FP64_OPS_PER_S) * 1e3
    emit({"phase": "mcc", **out})
    return out


def phase_mcc_alone() -> dict:
    """``python3 chip_smoke.py mcc``: build haralick_mcc (its ptxas lines),
    then the phase on the first smooth and the first random texture."""
    reports = build.build(("haralick_mcc",))
    emit({"phase": "build", "ptxas": {n: [ln.strip() for ln in r.splitlines()
                                          if "entry" in ln or "Used" in ln or "spill" in ln]
                                      for n, r in reports.items()}})
    smooth = torch.from_numpy(smooth_texture(4096, seed=0).astype(np.float32)).to(DEV)
    rnd = torch.from_numpy(random_texture(4096, seed=0).astype(np.float32)).to(DEV)
    return phase_mcc(smooth, rnd)


# ---------------------------------------------------------------------------
# f1-f13 (haralick_tail)
# ---------------------------------------------------------------------------

# The kernel against the plain version: a feature's gap over its largest
# magnitude. f3 is a difference of sums of order mu_x mu_y over sd_x sd_y,
# which a texture-map window can bring down to ~1e-3 (9.2e-11 on a smooth
# map); f13 = sqrt(1 - exp(-2 d)) magnifies the rounding of d without bound
# near d = 0, so its square is held instead.
TAIL_RTOL = 1e-12  # f1, f2, f4-f12 and f13 squared
TAIL_RTOL_F3 = 1e-9
TAIL_P_ULP = 2.0**-53  # P, px and py within L of these: a marginal sums L entries


def _tail_err(counts: torch.Tensor, what: str, float32_step: bool = False) -> dict:
    """Launch once, exactly once, again with the same bits, and hold the
    kernel to the plain version: each feature's gap over its largest
    magnitude, and P, px and py."""
    before = haralick_tail.launches
    got = haralick_tail(counts, float32_step=float32_step, with_p=True)
    require(haralick_tail.launches == before + 1, f"{what}: launches")
    again = haralick_tail(counts, float32_step=float32_step, with_p=True)
    require(all(torch.equal(a, b) for a, b in zip(got, again)), f"{what}: two launches differ")
    want = haralick_tail_plain(counts, float32_step=float32_step, with_p=True)
    scale = want[0].abs().amax(dim=0).clamp_min(1e-300)
    rel = [float(r) for r in (got[0] - want[0]).abs().amax(dim=0) / scale]
    f13_sq = float((got[0][:, 12] ** 2 - want[0][:, 12] ** 2).abs().max())
    p_err = max(float((g - w).abs().max()) for g, w in zip(got[1:], want[1:]))
    p_tol = counts.shape[-1] * TAIL_P_ULP
    require(max(rel[:2] + rel[3:12] + [f13_sq]) <= TAIL_RTOL and rel[2] <= TAIL_RTOL_F3,
            f"{what}: features apart by {rel} of their largest magnitudes, f13^2 by {f13_sq}")
    require(p_err <= p_tol, f"{what}: P, px, py apart by {p_err} > {p_tol}")
    return {"rel_err": rel, "f13_squared_err": f13_sq, "p_max_abs_err": p_err}


def _tail_bytes(n: int, levels: int, with_p: bool) -> int:
    """Bytes a launch must move: the int32 counts in, 13 float64 features
    out and, with f14, P, px and py out."""
    return n * levels * levels * 4 + n * 13 * 8 + (n * (levels**2 + 2 * levels) * 8 if with_p else 0)


def phase_tail(smooth: torch.Tensor, rnd: torch.Tensor) -> dict:
    """haralick_tail against its plain version on the texture map's 260 100
    matrices of a smooth and a random 4096² image and on the 32 matrices of
    a call of features-4096 (8 images, 4 smooth and 4 random), with and
    without the plan's float32 step, and on the 32 L = 256 matrices of a
    call of features-4096-L256; each one launch, twice the same bits. Its
    CUDA-event ms beside its bound (bytes) and the plain version's ms; a
    launch allocates only its outputs. (The ``cuda`` tests of
    ``tests/test_torch_tail_kernel.py`` hold it at every L and on edge
    cases.)"""
    out = {}
    spec = GLCMSpec(levels=LEVELS, pairs=PAPER_PAIRS, quantize="uniform", region="window",
                    region_shape=WINDOW, region_stride=WINDOW_STRIDE)
    plan = compile_plan(spec, tuple(smooth.shape))
    stack = torch.stack([smooth, rnd] * 4)
    batch = compile_plan(GLCMSpec(levels=LEVELS, pairs=PAPER_PAIRS, quantize="uniform"),
                         tuple(stack.shape))(stack).reshape(-1, LEVELS, LEVELS)
    wide = GLCMSpec(levels=256, pairs=((1, 0), (1, 45), (1, 90), (1, 135)), quantize="uniform")
    cases = (("smooth", plan(smooth).reshape(-1, LEVELS, LEVELS)),
             ("random", plan(rnd).reshape(-1, LEVELS, LEVELS)),
             ("batch32", batch),
             ("wide", compile_plan(wide, tuple(stack.shape))(stack).reshape(-1, 256, 256)))
    for name, counts in cases:
        n, L = counts.shape[0], counts.shape[-1]
        out[f"{name}_check"] = _tail_err(counts, f"haralick_tail {name}")
        if name == "batch32":
            out["batch32_float32_step_check"] = _tail_err(counts, "haralick_tail batch32 float32",
                                                          float32_step=True)
        for with_p in (True, False):
            key = name if with_p else f"{name}_no_p"
            out[f"{key}_ms"] = cuda_ms(lambda: haralick_tail(counts, with_p=with_p), reps=10)
            out[f"{key}_plain_ms"] = cuda_ms(
                lambda: haralick_tail_plain(counts, with_p=with_p), reps=3)
            nbytes = _tail_bytes(n, L, with_p)
            out[f"{key}_bytes"] = nbytes
            out[f"{key}_bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        out[f"{name}_matrices"] = n
    counts = cases[1][1]
    n = counts.shape[0]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(DEV)
    torch.cuda.reset_peak_memory_stats(DEV)
    haralick_tail(counts, with_p=True)
    torch.cuda.synchronize()
    out["peak_bytes"] = torch.cuda.max_memory_allocated(DEV) - before
    outputs = n * (13 + LEVELS**2 + 2 * LEVELS) * 8
    require(out["peak_bytes"] <= outputs + 4 * 2**21,  # the allocator's 2 MiB rounding
            f"haralick_tail allocated {out['peak_bytes']} bytes for {outputs} bytes of outputs")
    emit({"phase": "tail", **out})
    return out


def phase_tail_alone() -> dict:
    """``python3 chip_smoke.py tail``: build haralick_tail (its ptxas lines),
    then the phase on the first smooth and the first random texture."""
    reports = build.build(("haralick_tail",))
    emit({"phase": "build", "ptxas": {n: [ln.strip() for ln in r.splitlines()
                                          if "entry" in ln or "Used" in ln or "spill" in ln]
                                      for n, r in reports.items()}})
    smooth = torch.from_numpy(smooth_texture(4096, seed=0).astype(np.float32)).to(DEV)
    rnd = torch.from_numpy(random_texture(4096, seed=0).astype(np.float32)).to(DEV)
    return phase_tail(smooth, rnd)


def _volume_index(vol, offsets, quant) -> torch.Tensor:
    """The linearised (volume, k, ref, assoc) index of every in-bounds pair,
    one int64 per pair (about 14 GB at the main path's shape)."""
    b = vol.shape[0]
    lo, span = (v.reshape(b, 1, 1, 1) for v in quant)
    levels = bin_values(vol, LEVELS, lo, span)
    sizes = [b * math.prod(s - abs(o) for s, o in zip(vol.shape[1:], off)) for off in offsets]
    pos = torch.empty(sum(sizes), dtype=torch.int64, device=DEV)
    vidx = torch.arange(b, device=DEV).reshape(b, 1, 1, 1)
    at = 0
    for k, (off, n) in enumerate(zip(offsets, sizes)):
        a, r = pair_planes_nd(levels, off)
        pos[at:at + n] = ((vidx * len(offsets) + k) * LEVELS**2
                          + r.to(torch.int64) * LEVELS + a).reshape(-1)
        at += n
    return pos


def phase_volume_timing(vol, chk) -> dict:
    offsets, slab_d, quant = chk["offsets"], chk["slab_d"], chk["quant"]
    b = vol.shape[0]
    t = {}
    volume = lambda x, q: glcm_volume(x, levels=LEVELS, offsets=offsets,  # noqa: E731
                                      slab_d=slab_d, quant=q)
    t["volume_ms"] = cuda_ms(lambda: volume(vol, quant), reps=5)
    t.update(_halves("volume", vol, quant, volume, reps=5))
    t["volume_plain_ms"] = cuda_ms(lambda: glcm_volume_plain(vol, LEVELS, offsets, quant=quant),
                                   reps=2)
    minlength = b * len(offsets) * LEVELS**2
    try:
        pos = _volume_index(vol, offsets, quant)
    except torch.cuda.OutOfMemoryError as err:
        t["volume_library_ms"] = None
        t["volume_library_null_reason"] = f"index does not fit on the card: {err}"
        votes = int(chk["counts"].to(torch.int64).sum())
    else:
        require(torch.equal(torch.bincount(pos, minlength=minlength).to(torch.int32),
                            chk["counts"].reshape(-1)), "volume bincount != kernel counts")
        t["volume_library_ms"] = cuda_ms(lambda: torch.bincount(pos, minlength=minlength),
                                         reps=3)
        t["volume_index_bytes"] = pos.numel() * 8
        votes = pos.numel()
        del pos
    nbytes = vol.numel() * 4 + b * 2 * 4 + minlength * 4
    t["volume_bound_ms"], t["volume_bound_by"] = bound(nbytes, 5 * vol.numel() + votes)

    features = lambda: glcm_features(vol, LEVELS, VOLUME_PAIRS, ndim=3)  # noqa: E731
    seconds = _host_seconds(features, reps=3)
    t["volume_s"] = seconds
    t["volume_voxels_per_s"] = vol.numel() / seconds
    spec = GLCMSpec(levels=LEVELS, pairs=VOLUME_PAIRS, quantize="uniform", ndim=3)
    counts = compile_plan(spec, tuple(vol.shape))(vol)
    t["volume_tail_s"] = _host_seconds(lambda: haralick_features(counts), reps=3)
    emit({"phase": "timing", "path": "volume-2x256x512x512", **t})
    return t


# ---------------------------------------------------------------------------
# The histogram kernel, the temporal streams and the pipeline
# ---------------------------------------------------------------------------


def phase_histogram(stack, big) -> dict:
    """kernels.histogram on the 16384² smooth image binned to L = 32 and on
    the random stack[4] binned to L = 256 (the binning is input set-up)."""
    inputs = {}
    for name, img, levels in (("big", big, LEVELS), ("stack4", stack[4], 256)):
        inputs[name] = (bin_values(img, levels, *uniform_params(img)), levels)
    out = {}
    counts = {name: _drive(out, f"histogram_{name}", lambda v=v, n=n: ops.histogram(v, n))
              for name, (v, n) in inputs.items()}
    require(out["histogram_big_launches"]["histogram"] == 1
            and out["histogram_stack4_launches"]["histogram"] == 1,
            "histogram main path did not launch the kernel once per call")
    for name, (v, levels) in inputs.items():
        plain = histogram_plain(v, levels)
        err = max_abs_err(counts[name], plain)
        require(err == 0, f"histogram {name} differs from plain by {err}")
        require(torch.equal(torch.bincount(v.reshape(-1), minlength=levels).to(torch.int32),
                            counts[name]), f"histogram {name} != torch.bincount")
        require(int(counts[name].to(torch.int64).sum()) == v.numel(), f"histogram {name} total")
        out[f"histogram_{name}_max_abs_err"] = err
        out[f"histogram_{name}_ms"] = cuda_ms(lambda: ops.histogram(v, levels), reps=10)
        out[f"histogram_{name}_plain_ms"] = cuda_ms(lambda: histogram_plain(v, levels), reps=3)
        out[f"histogram_{name}_library_ms"] = cuda_ms(
            lambda: torch.bincount(v.reshape(-1), minlength=levels), reps=3)
        # Each value read once (4 B) and the (L,) counts written once; one
        # compare and one add per value.
        out[f"histogram_{name}_bound_ms"], out[f"histogram_{name}_bound_by"] = bound(
            v.numel() * 4 + levels * 4, 2 * v.numel())
        out[f"histogram_{name}_values"] = v.numel()
    emit({"phase": "histogram", **out})
    return out


def _window_sum(per_frame: torch.Tensor, t: int, window: int) -> torch.Tensor:
    return per_frame[max(0, t + 1 - window): t + 1].sum(dim=0)


def phase_temporal(frames_dev) -> dict:
    """stream-4096-w16: the global temporal stream through glcm_feature_stream
    (features) and a counts-only stream plan (exactness and step latency)."""
    spec = GLCMSpec(levels=LEVELS, pairs=PAPER_PAIRS, quantize="uniform", vrange=(0, 255))
    out = {}
    host_frames = [f for f in frames_dev.cpu().numpy()]
    feats = _drive(out, "stream_features", lambda: torch.stack(list(
        glcm_feature_stream(host_frames, spec=spec, temporal_window=STREAM_WINDOW))))
    _only(out["stream_features_launches"], ("glcm_fused", "haralick_tail", "second_eigenvalue"),
          "temporal stream")
    require(out["stream_features_launches"]["glcm_fused"] == VIDEO_FRAMES,
            f"temporal stream launched glcm_fused {out['stream_features_launches']} times")

    # Per-frame counts of the plain fused version, summed over each window.
    offsets = tuple(glcm_offsets(d, t) for d, t in PAPER_PAIRS)
    per_frame = torch.stack([
        glcm_fused_plain(f[None], LEVELS, offsets, quant=(0.0, 255.0))[0].to(torch.int64)
        for f in frames_dev])
    plan = compile_plan(spec, tuple(frames_dev.shape[1:]), temporal_window=STREAM_WINDOW)
    require(plan.spec.scheme == "cuda_fused", f"stream resolved to {plan.spec.scheme}")
    checked = (STREAM_WINDOW // 2 - 1, STREAM_WINDOW - 1, VIDEO_CHANGE + 4)
    state = plan.init_state()
    f_err = f14_err = 0.0
    for t, frame in enumerate(frames_dev):
        state, _ = plan.update(state, frame)
        if t in checked:
            want = _window_sum(per_frame, t, STREAM_WINDOW)
            require(torch.equal(state.counts.to(torch.int64), want),
                    f"temporal counts at step {t} != plain window sum")
            e, e14 = _features_err(feats[t], want, f"temporal features at step {t}")
            f_err, f14_err = max(f_err, e), max(f14_err, e14)
    out["stream_checked_steps"] = list(checked)
    out["stream_features_max_abs_err_f1_f13"] = f_err
    out["stream_features_max_abs_err_f14"] = f14_err

    # Latency: the incremental counts step (median over the frames after the
    # ring filled), the same step with features, and the recompute of a
    # window as one batched call summed over its frames.
    def step_latency(p) -> float:
        st = p.init_state()
        times = []
        for t, frame in enumerate(frames_dev):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, o = p.update(st, frame)
            torch.cuda.synchronize()
            if t >= STREAM_WINDOW:
                times.append(time.perf_counter() - t0)
        return float(np.median(times))

    out["stream_step_ms"] = step_latency(plan) * 1e3
    fplan = compile_plan(spec, tuple(frames_dev.shape[1:]), features=True,
                         temporal_window=STREAM_WINDOW)
    out["stream_features_step_ms"] = step_latency(fplan) * 1e3
    window = frames_dev[VIDEO_CHANGE:VIDEO_CHANGE + STREAM_WINDOW]
    batch = compile_plan(spec, tuple(window.shape))
    out["stream_recompute_ms"] = _host_seconds(lambda: batch(window).sum(dim=0), reps=5) * 1e3
    out["stream_incremental_vs_recompute"] = out["stream_recompute_ms"] / out["stream_step_ms"]
    emit({"phase": "temporal", "path": "stream-4096-w16", **out})
    return out


def phase_texture_stream(frames_dev) -> dict:
    """texture-stream-4096-w8: the texture map as a counts-only stream with
    an 8-frame ring, exact at two steps; its per-step latency and peak
    memory. Everything it allocates is freed before it returns."""
    spec = GLCMSpec(levels=LEVELS, pairs=PAPER_PAIRS, quantize="uniform", vrange=(0, 255),
                    region="window", region_shape=WINDOW, region_stride=WINDOW_STRIDE)
    offsets = tuple(glcm_offsets(d, t) for d, t in PAPER_PAIRS)
    kw = dict(region_shape=(WINDOW, WINDOW), stride=(WINDOW_STRIDE, WINDOW_STRIDE))
    out = {}
    # The frames are uint8; one window launch on a frame reads it as it is
    # and allocates its counts and nothing else (no float32 copy).
    require(frames_dev.dtype == torch.uint8, f"video frames are {frames_dev.dtype}")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(DEV)
    torch.cuda.reset_peak_memory_stats(DEV)
    one = glcm_window(frames_dev[0], levels=LEVELS, offsets=offsets, quant=(0.0, 255.0), **kw)
    torch.cuda.synchronize()
    out["texture_stream_launch_peak_bytes"] = torch.cuda.max_memory_allocated(DEV) - before
    out["texture_stream_counts_bytes"] = one.numel() * 4
    require(out["texture_stream_launch_peak_bytes"] - one.numel() * 4 < 65536,
            f"glcm_window on a uint8 frame allocated {out['texture_stream_launch_peak_bytes']}"
            f" bytes beside its {one.numel() * 4}-byte counts")
    del one
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(DEV)
    base = torch.cuda.memory_allocated(DEV)  # the peak is the stream's own
    plan = compile_plan(spec, tuple(frames_dev.shape[1:]), temporal_window=TEXTURE_WINDOW)
    require(plan.spec.scheme == "cuda_fused" and plan.backend.caps.region_grid,
            f"texture stream resolved to {plan.spec.scheme}")
    state = plan.init_state()
    out["texture_stream_ring_bytes"] = state.ring.numel() * 4
    checked = (TEXTURE_WINDOW - 1, VIDEO_CHANGE + 4)
    times = []
    reset_launches()
    step_peak_at = TEXTURE_WINDOW + 1  # a steady step after the first peak is read
    for t, frame in enumerate(frames_dev):
        torch.cuda.synchronize()
        if t == step_peak_at:
            torch.cuda.reset_peak_memory_stats(DEV)
            step_base = torch.cuda.memory_allocated(DEV)
        t0 = time.perf_counter()
        state, counts = plan.update(state, frame)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del counts
        if t == checked[0]:  # the ring is full: the steady state's peak
            out["texture_stream_peak_bytes"] = torch.cuda.max_memory_allocated(DEV) - base
        if t == step_peak_at:  # what one step allocates above the state
            out["texture_stream_step_peak_bytes"] = (torch.cuda.max_memory_allocated(DEV)
                                                     - step_base)
        if t in checked:
            want = torch.zeros_like(state.counts, dtype=torch.int64)
            for f in frames_dev[max(0, t + 1 - TEXTURE_WINDOW): t + 1]:
                want += glcm_window_plain(f, LEVELS, offsets, quant=(0.0, 255.0), **kw)
            require(torch.equal(state.counts.to(torch.int64), want),
                    f"texture stream counts at step {t} != plain window sum")
            del want
    out["texture_stream_launches"] = launches()
    _only(out["texture_stream_launches"], ("glcm_window",), "texture stream")
    require(out["texture_stream_launches"]["glcm_window"] == VIDEO_FRAMES,
            "texture stream: not one glcm_window launch per frame")
    out["texture_stream_checked_steps"] = list(checked)
    out["texture_stream_step_ms"] = float(np.median(times[TEXTURE_WINDOW:])) * 1e3
    out["texture_stream_first_step_ms"] = times[0] * 1e3
    out["texture_stream_windows"] = math.prod(plan.grid)
    del state, plan
    torch.cuda.empty_cache()
    emit({"phase": "texture_stream", "path": "texture-stream-4096-w8", **out})
    return out


def phase_pipeline(stack, features) -> dict:
    """pipeline-32x4096: glcm_feature_stream over 32 host images at prefetch
    1 and 2 and batch size 1 and 8, after one warm-up run."""
    host = stack.cpu().numpy()
    images = [host[i % host.shape[0]] for i in range(PIPELINE_IMAGES)]
    spec = GLCMSpec(levels=LEVELS, pairs=PAPER_PAIRS, quantize="uniform")
    out = {}

    def run(prefetch: int, batch_size: int) -> list:
        return list(glcm_feature_stream(images, spec=spec, prefetch=prefetch,
                                        batch_size=batch_size))

    run(2, 1)  # warm-up: plans and pinned host memory
    run(2, 8)
    torch.cuda.synchronize()
    for batch_size in (1, 8):
        for prefetch in (1, 2):
            name = f"pipeline_b{batch_size}_p{prefetch}"
            got = _drive(out, name, lambda: run(prefetch, batch_size))
            require(len(got) == PIPELINE_IMAGES, f"{name}: {len(got)} results")
            expect = -(-PIPELINE_IMAGES // batch_size)
            require(out[f"{name}_launches"]["glcm_fused"] == expect,
                    f"{name}: glcm_fused launched {out[f'{name}_launches']} times")
            for i, g in enumerate(got):
                want = features[i % host.shape[0]]
                require(g.shape == want.shape and bool(torch.isfinite(g).all()),
                        f"{name}: result {i} of shape {tuple(g.shape)}")
                require(torch.allclose(g[..., :13], want[..., :13], rtol=FEATURE_RTOL,
                                       atol=FEATURE_ATOL)
                        and torch.allclose(g[..., 13], want[..., 13], rtol=0, atol=F14_ATOL),
                        f"{name}: result {i} differs from glcm_features")
            out[f"{name}_images_per_s"] = PIPELINE_IMAGES / out[f"{name}_s"]
        out[f"pipeline_b{batch_size}_overlap_gain"] = (
            out[f"pipeline_b{batch_size}_p2_images_per_s"]
            / out[f"pipeline_b{batch_size}_p1_images_per_s"])

    # The host side alone: grouping 32 images into stacks of 8 (np.stack),
    # one image's memcpy into pinned memory and its copy to the device.
    t0 = time.perf_counter()
    for _ in coalesce_images(images, 8):
        pass
    out["pipeline_coalesce_ms_per_stack"] = (time.perf_counter() - t0) / (
        PIPELINE_IMAGES // 8) * 1e3
    pinned = torch.empty(host.shape[1:], dtype=torch.float32, pin_memory=True)
    src = torch.from_numpy(host[0])
    t0 = time.perf_counter()
    for _ in range(5):
        pinned.copy_(src)
    out["pipeline_pinned_memcpy_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    dst = torch.empty(host.shape[1:], dtype=torch.float32, device=DEV)
    out["pipeline_h2d_ms"] = cuda_ms(lambda: dst.copy_(pinned, non_blocking=True), reps=10)
    out["pipeline_image_bytes"] = pinned.numel() * 4
    emit({"phase": "pipeline", "path": "pipeline-32x4096", **out})
    return out


# ---------------------------------------------------------------------------
# serve-mixed-4096: the serving engine on the card
# ---------------------------------------------------------------------------

# benchmarks/serve_load.py's mix and method at the paper's sizes: (name,
# spec, request shape, features, batch size, traffic share, kernel). The
# engine names workload 0 "default"; the table's names are the others'.
SERVE_WORKLOADS = (
    ("uniform4096", GLCMSpec(levels=LEVELS, pairs=PAPER_PAIRS, quantize="uniform",
                             vrange=(0, 255)), STACK_SHAPE[1:], True, 8, 0.55, "glcm_fused"),
    ("equalized4096", GLCMSpec(levels=LEVELS, pairs=((1, 0),), quantize="equalized"),
     STACK_SHAPE[1:], False, 8, 0.25, "glcm_vote"),
    ("window1024", GLCMSpec(levels=LEVELS, pairs=PAPER_PAIRS, quantize="uniform",
                            region="window", region_shape=WINDOW, region_stride=WINDOW_STRIDE),
     (1024, 1024), True, 8, 0.15, "glcm_window"),
    ("volume256", GLCMSpec(levels=LEVELS, pairs=VOLUME_PAIRS, quantize="uniform", ndim=3),
     VOLUME_SHAPE, True, 2, 0.05, "glcm_volume"),
)
SERVE_REQUESTS, SERVE_CALIBRATION, SERVE_LOAD = 96, 64, 0.5
SERVE_BATCH_FILL = 8  # the deadline: 8 x 4 workloads x the mean service time
SESSION_FRAMES, SESSION_CUT, SESSION_EVERY = 24, 17, 4  # a push after every 4th arrival


def make_trace(n: int, seed: int = 0) -> list[tuple[float, int, int]]:
    """serve_load.py's seeded, wall-clock-free trace: n rows of (gap,
    workload index, priority), gaps in mean-service units; exponential
    inter-arrivals, the middle third at 3x rate, workloads drawn by their
    traffic share, ~20 % priority 1."""
    rng = np.random.default_rng(seed)
    shares = np.asarray([w[5] for w in SERVE_WORKLOADS])
    rows = []
    for i in range(n):
        rate = 3.0 if n // 3 <= i < 2 * n // 3 else 1.0
        gap = float(rng.exponential(1.0 / rate))
        wid = int(rng.choice(len(SERVE_WORKLOADS), p=shares))
        prio = int(rng.random() < 0.2)
        rows.append((gap, wid, prio))
    return rows


class WarpClock:
    """``time.monotonic`` plus a jumpable offset: compute still takes real
    time, waits for the next arrival or deadline are jumps."""

    def __init__(self):
        self.offset = 0.0

    def __call__(self) -> float:
        return time.monotonic() + self.offset

    def jump_to(self, t: float) -> None:
        now = self()
        if t > now:
            self.offset += t - now


def _serve_engine(max_wait_ms, clock=None, tracer=None) -> GLCMEngine:
    _, spec0, shape0, feats0, batch0, _, _ = SERVE_WORKLOADS[0]
    eng = GLCMEngine(GLCMServeConfig(
        spec=spec0, image_shape=shape0, batch_size=batch0, features=feats0,
        temporal_window=STREAM_WINDOW, max_wait_ms=max_wait_ms, max_results=100_000),
        clock=clock, tracer=tracer)
    for name, spec, shape, feats, batch, _, _ in SERVE_WORKLOADS[1:]:
        eng.register(spec, shape, features=feats, batch_size=batch, name=name)
    eng.warmup()
    return eng


class _Session:
    """One rolling-window video session pushed between arrivals: a frame
    after every ``SESSION_EVERY``-th arrival, closed after frame
    ``SESSION_CUT`` and resumed from its ``state_dict()``."""

    def __init__(self, eng: GLCMEngine, frames: np.ndarray):
        self.eng, self.frames = eng, frames
        self.sid = eng.open_stream()
        self.outputs, self.push_ms, self.states = [], [], {}

    def after_arrival(self, i: int) -> None:
        if i % SESSION_EVERY != SESSION_EVERY - 1:
            return
        f = i // SESSION_EVERY
        t0 = time.perf_counter()
        self.outputs.append(self.eng.push(self.sid, self.frames[f]))
        self.push_ms.append((time.perf_counter() - t0) * 1e3)
        if f == SESSION_CUT:
            state = self.eng.close_stream(self.sid)
            self.states[f] = state
            self.sid = self.eng.open_stream(state=state.state_dict())

    def close(self) -> None:
        self.states[len(self.outputs) - 1] = self.eng.close_stream(self.sid)


def _replay(max_wait_ms, trace, unit_s: float, pools, *, traced=False, frames=None) -> dict:
    """serve_load.py's event-driven replay: arrivals (and deadlines that fall
    before them) are clock jumps, dispatch compute takes real time. With
    ``traced``, under a live tracer on the same clock, installed globally.
    Launch counts are set to 0 after the warm-up and read after the final
    flush."""
    clock = WarpClock()
    tracer = prev = None
    if traced:
        tracer = Tracer(enabled=True, clock=clock)
        prev = set_tracer(tracer)
    try:
        eng = _serve_engine(max_wait_ms, clock=clock, tracer=tracer)
        session = _Session(eng, frames) if frames is not None else None
        reset_launches()
        drawn = [0] * len(pools)
        tickets = []
        start = due = clock()
        for i, (gap, w, prio) in enumerate(trace):
            due += gap * unit_s
            while True:  # every deadline that falls before the next arrival
                nd = eng.next_deadline()
                if nd is None or nd > due:
                    break
                clock.jump_to(nd)
                eng.poll()
            clock.jump_to(due)
            k = drawn[w] % len(pools[w])
            drawn[w] += 1
            tickets.append((eng.submit(pools[w][k], workload=w, priority=prio), w, k))
            if session is not None:
                session.after_arrival(i)
        eng.flush()
        span_s = clock() - start
        if session is not None:
            session.close()
        counts = launches()
    finally:
        if tracer is not None:
            set_tracer(prev)
    lat = np.concatenate([eng.latencies(w, "e2e") for w in range(len(pools))])
    return {"eng": eng, "stats": eng.stats(), "launches": counts, "span_s": span_s,
            "tracer": tracer,
            "session": session, "results": [(eng.result(t), w, k) for t, w, k in tickets],
            "throughput_rps": lat.size / span_s, "e2e_p50_ms": float(np.percentile(lat, 50)),
            "e2e_p99_ms": float(np.percentile(lat, 99)), "requests": int(lat.size)}


def _direct(pools, scheme: str | None = None) -> list[list[np.ndarray]]:
    """Each pooled request through a direct batch-1 plan call: by the route
    the engine resolves (``scheme=None``) or by ``scheme``."""
    out = []
    for (_, spec, shape, feats, _, _, _), pool in zip(SERVE_WORKLOADS, pools):
        plan = compile_plan(spec if scheme is None else spec.replace(scheme=scheme),
                            (1, *shape), features=feats)
        out.append([plan(torch.from_numpy(x[None]).to(DEV))[0].cpu().numpy() for x in pool])
    return out


def _check_results(replay: dict, direct, what: str) -> dict:
    """Served results against direct batch-1 calls of the same requests:
    counts bit for bit, features within the tolerances; the largest gaps
    per workload."""
    gaps = {}
    for got, w, k in replay["results"]:
        name, feats = SERVE_WORKLOADS[w][0], SERVE_WORKLOADS[w][3]
        want = direct[w][k]
        require(got.shape == want.shape and np.isfinite(got).all(),
                f"{what} {name}: result of shape {got.shape} != {want.shape}")
        g = gaps.setdefault(name, {"bit_identical": True, "max_abs_f1_f13": 0.0,
                                   "max_abs_f14": 0.0, "checked": 0})
        g["checked"] += 1
        if not feats:
            require(np.array_equal(got, want), f"{what} {name}: counts differ")
            continue
        g["bit_identical"] &= bool(np.array_equal(got, want))
        g["max_abs_f1_f13"] = max(g["max_abs_f1_f13"],
                                  float(np.abs(got[..., :13] - want[..., :13]).max()))
        g["max_abs_f14"] = max(g["max_abs_f14"], float(np.abs(got[..., 13] - want[..., 13]).max()))
        require(np.allclose(got[..., :13], want[..., :13], rtol=FEATURE_RTOL, atol=FEATURE_ATOL),
                f"{what} {name}: features f1-f13 differ")
        require(np.allclose(got[..., 13], want[..., 13], rtol=0, atol=F14_ATOL),
                f"{what} {name}: feature f14 differs")
    return gaps


def _check_launches(replay: dict, pushes: int, what: str) -> None:
    st = replay["stats"]["workloads"]
    for w, (name, *_, kernel) in enumerate(SERVE_WORKLOADS):
        require(st[w]["batches"] > 0, f"{what} {name}: no batch dispatched")
        want = st[w]["batches"] + (pushes if w == 0 else 0)
        require(replay["launches"][kernel] == want,
                f"{what} {name}: {kernel} launched {replay['launches'][kernel]} times for "
                f"{st[w]['batches']} batches and {pushes if w == 0 else 0} pushes")
    require(replay["launches"]["histogram"] == 0, f"{what}: histogram launched")


class _EventTimedPlan:
    """A bucket plan whose calls are bracketed by CUDA events (recorded, not
    waited on: the engine's own sync is what is checked)."""

    def __init__(self, plan):
        self.plan, self.events = plan, []

    def __getattr__(self, name):
        return getattr(self.plan, name)

    def __call__(self, x):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.plan(x)
        end.record()
        self.events.append((start, end))
        return out

    def ms(self) -> list[float]:
        torch.cuda.synchronize()
        return [start.elapsed_time(end) for start, end in self.events]


def _check_launch_sync(pools) -> dict:
    """Full batches of the uniform4096 and window1024 workloads through
    event-timed plans: each dispatch's ``launch_ms`` (host clock, H2D copy,
    plan call and device sync) is at least the CUDA-event time of that very
    plan call. Then a shed: a workload with ``max_queue_depth=1``,
    registered while the engine is paused."""
    eng = _serve_engine(None)
    out = {}
    for w in (0, 2):
        name, batch = SERVE_WORKLOADS[w][0], SERVE_WORKLOADS[w][4]
        wl = eng._workloads[w]
        timed = _EventTimedPlan(eng._plan_for(wl, batch))
        wl.plans[batch] = timed
        for _ in range(2):
            for x in pools[w][:batch]:
                eng.submit(x, workload=w)
        event_ms = timed.ms()
        launch_ms = list(wl.launch_ms)
        require(len(event_ms) == len(launch_ms) == 2, f"{name}: {len(launch_ms)} dispatches")
        require(all(lm >= em > 0 for lm, em in zip(launch_ms, event_ms)),
                f"{name}: launch_ms {launch_ms} below the plan call's event time {event_ms}")
        out[name] = {"launch_ms": launch_ms, "plan_event_ms": event_ms}
    eng.pause()
    name, spec, shape, feats, _, _, _ = SERVE_WORKLOADS[1]
    wid = eng.register(spec, shape, features=feats, max_queue_depth=1, name="shed")
    eng.submit(pools[1][0], workload=wid)
    try:
        eng.submit(pools[1][1], workload=wid)
        shed = False
    except QueueFullError:
        shed = True
    inc = eng.last_incident
    require(shed and inc is not None and "QueueFullError" in inc["reason"]
            and inc["records"][-1]["kind"] == "shed", "no QueueFullError incident recorded")
    eng.resume()
    eng.flush()
    out["shed_incident"] = inc["reason"]
    return out


def _workload_summary(st: dict) -> dict:
    out = {}
    for w, (name, *_) in enumerate(SERVE_WORKLOADS):
        s = st["workloads"][w]
        out[name] = {
            "served": s["served"], "batches": s["batches"],
            "deadline_dispatches": s["deadline_dispatches"],
            "batch_occupancy": {str(b): {str(k): n for k, n in h.items()}
                                for b, h in s["batch_occupancy"].items()},
            **{f"{kind}_p50_ms": s[f"{kind}_ms"]["p50"] for kind in ("e2e", "queue", "service")},
            **{f"{kind}_p99_ms": s[f"{kind}_ms"]["p99"] for kind in ("e2e", "queue", "service")},
            **{f"{phase}_p50_ms": s[f"{phase}_ms"]["p50"]
               for phase in ("pad", "launch", "readback")},
        }
    return out


def phase_serve(stack, vol, video: np.ndarray) -> dict:
    """serve-mixed-4096: see the module docstring (phase 11)."""
    t0 = time.perf_counter()
    u8 = stack.to(torch.uint8).cpu().numpy()
    pools = [list(u8), list(u8), list(stack[:, :1024, :1024].cpu().numpy()),
             list(vol.cpu().numpy())]
    frames = video[:SESSION_FRAMES]
    out = {"inputs_s": time.perf_counter() - t0}

    # Calibrate: a zero-gap prefix through the engine without a deadline.
    cal = _replay(None, make_trace(SERVE_CALIBRATION, seed=1), 0.0, pools)
    mean_service_s = 1.0 / cal["throughput_rps"]
    max_wait_ms = SERVE_BATCH_FILL * len(SERVE_WORKLOADS) * mean_service_s * 1e3
    out.update(mean_service_ms=mean_service_s * 1e3, max_wait_ms=max_wait_ms,
               calibration_rps=cal["throughput_rps"])
    del cal

    trace = make_trace(SERVE_REQUESTS)
    unit_s = mean_service_s / SERVE_LOAD
    # Both modes carry the live tracer and the session, so that they differ
    # only in the deadline.
    get_registry().clear()
    cont = _replay(max_wait_ms, trace, unit_s, pools, traced=True, frames=frames)
    tracer = cont["tracer"]
    prom = get_registry().to_prometheus()
    fixed = _replay(None, trace, unit_s, pools, traced=True, frames=frames)

    # Checks: results, pushes, launches, the trace and the metrics. The
    # served results against batch-1 calls of the engine's own route (the
    # cross-bucket identity), then against the plain "scatter" route on the
    # card, which runs none of the kernels: each kernel at the serve shapes
    # (batched vote streams, 1024² window grids) against a plain version.
    for ref, scheme in (("batch1", None), ("plain", "scatter")):
        direct = _direct(pools, scheme)
        for mode, r in (("continuous", cont), ("fixed", fixed)):
            out[f"results_vs_{ref}_{mode}"] = _check_results(
                r, direct, f"{mode} vs {ref} ({scheme or 'engine route'})")
        del direct
    eng = cont["eng"]
    rolled = eng.stream_plan.rolling(frames)
    counts = compile_plan(eng.spec, tuple(frames.shape[1:]),
                          temporal_window=STREAM_WINDOW).rolling(frames)
    for mode, r in (("continuous", cont), ("fixed", fixed)):
        session = r["session"]
        require(len(session.outputs) == SESSION_FRAMES,
                f"{mode}: {len(session.outputs)} pushes")
        for t, got in enumerate(session.outputs):
            require(np.array_equal(got, rolled[t].cpu().numpy()),
                    f"{mode}: push {t} != the stream plan's rolling window")
        for t, state in session.states.items():
            require(exact_counts(state.counts, counts[t]),
                    f"{mode}: session counts after frame {t} != rolling counts")
        _check_launches(r, len(session.outputs), mode)
    del rolled, counts
    session = cont["session"]
    trace_path = ROOT / "build" / "serve_trace.json"
    trace_path.parent.mkdir(exist_ok=True)
    tracer.save_chrome(str(trace_path))
    problems = validate_chrome(json.loads(trace_path.read_text()))
    require(not problems, f"serve trace: {problems[:5]}")
    roots = [s for s in load_trace(str(trace_path)) if s.name == "glcm.request"]
    require(sorted(s.corr for s in roots) == sorted(range(cont["requests"])),
            f"{len(roots)} glcm.request trees for {cont['requests']} tickets")
    for name in ["default"] + [w[0] for w in SERVE_WORKLOADS[1:]]:
        for series in (f'repro_serve_served_total{{workload="{name}"}}',
                       f'repro_serve_phase_ms_count{{phase="launch",workload="{name}"}}'):
            require(series in prom, f"Prometheus text lacks {series}")
    out["launch_sync"] = _check_launch_sync(pools)

    st = cont["stats"]
    launch_s = sum(s["launch_ms"]["mean"] * s["launch_ms"]["n"]
                   for s in st["workloads"].values()) * 1e-3
    out.update(
        workloads=_workload_summary(st),
        workloads_fixed=_workload_summary(fixed["stats"]),
        modes={mode: {k: r[k] for k in ("throughput_rps", "e2e_p50_ms", "e2e_p99_ms",
                                        "requests", "span_s")}
               | {"batches": r["stats"]["batches_dispatched"]}
               for mode, r in (("continuous", cont), ("fixed", fixed))},
        launch_share=launch_s / cont["span_s"],
        launches_continuous=cont["launches"], launches_fixed=fixed["launches"],
        session_push_ms=session.push_ms,
        session_push_p50_ms=float(np.median(session.push_ms)),
        session_push_p50_ms_fixed=float(np.median(fixed["session"].push_ms)),
        trace_spans=len(tracer), trace_requests=len(roots), trace_events_file=str(
            trace_path.relative_to(ROOT)),
        plan_cache=st["plan_cache"])
    emit({"phase": "serve", "path": "serve-mixed-4096", **out})
    return out


# The autotune phase: the store, the trials per candidate and the workloads
# (name, spec, features) in the order they are tuned; each workload's shape
# and inputs are the main path's. Tuning all four main-path workloads took
# 972 s on an H100, 781 s of it the volumes' plain candidates (PERF.md §6),
# so the phase tunes the first two: features-4096 (97 s) and glcm-16384
# (50 s), whose winner is not the untuned choice.
# The main path's plans at the paper's sizes, linted on the card: name, spec,
# shape, features, temporal window, the input dtype of the main path, and
# the one kernel a call launches.
LINT_PLANS = (
    ("features-4096", GLCMSpec(levels=LEVELS, pairs=PAPER_PAIRS, quantize="uniform"),
     STACK_SHAPE, True, None, torch.float32, "glcm_fused"),
    ("glcm-16384", GLCMSpec(levels=LEVELS, pairs=((1, 45),), quantize="uniform"),
     (16384, 16384), False, None, torch.float32, "glcm_vote"),
    ("texture-map-4096", GLCMSpec(levels=LEVELS, pairs=PAPER_PAIRS, quantize="uniform",
                                  region="window", region_shape=WINDOW,
                                  region_stride=WINDOW_STRIDE),
     STACK_SHAPE[1:], True, None, torch.float32, "glcm_window"),
    ("volume-2x256x512x512", GLCMSpec(levels=LEVELS, pairs=VOLUME_PAIRS, quantize="uniform",
                                      ndim=3),
     (2,) + VOLUME_SHAPE, True, None, torch.float32, "glcm_volume"),
    ("stream-4096-w16", GLCMSpec(levels=LEVELS, pairs=PAPER_PAIRS, quantize="uniform",
                                 vrange=(0, 255)),
     STACK_SHAPE[1:], True, STREAM_WINDOW, torch.uint8, "glcm_fused"),
)
LINT_DIRTY_SHAPE = (2, 480, 512)  # no side equal to L: counts never look like an image


def _lint_ms_sum() -> float:
    """The summed ``repro_plan_lint_ms`` observations of every scheme."""
    fam = get_registry().snapshot().get("repro_plan_lint_ms", {"series": []})
    return sum(s["sum"] for s in fam["series"])


def _plain_fused_on_card(img, spec, quant=None):
    """A backend that claims the card's kernels but counts with the fused
    kernel's plain version on the CUDA tensor (a quiet fallback)."""
    return glcm_fused_plain(img, spec.levels, spec.offsets(), quant=quant)


def _item_on_card(img, spec, quant=None):
    """A backend that launches the fused kernel, then reads a device count
    on the host (a hidden sync)."""
    offsets = spec.offsets()
    counts = glcm_fused(img, levels=spec.levels, offsets=offsets,
                        tile_h=default_tile_h(offsets), quant=quant)
    require(counts.sum().item() > 0, "the dirty backend counted nothing")
    return counts


def _dirty_lint(name: str, compute, rule: str) -> dict:
    """Register ``compute`` as a device-kernel backend and require the lint
    of its plan on the card to raise with exactly ``rule``."""
    _backends.register(_backends.Backend(
        name=name, compute=compute,
        caps=_backends.Capabilities(multi_offset_fused=True, fused_quantize=True,
                                    device_kernel=True)))
    try:
        spec = GLCMSpec(levels=LEVELS, pairs=PAPER_PAIRS, quantize="uniform", scheme=name)
        try:
            compile_plan(spec, LINT_DIRTY_SHAPE, check="lint")
        except op_lint.PlanContractError as err:
            rules = sorted({f.rule for f in err.findings})
        else:
            rules = []
    finally:
        _backends.unregister(name)
    require(rules == [rule], f"dirty backend {name} fired {rules}, expected [{rule!r}]")
    return {"backend": name, "fired": rules}


def phase_lint() -> dict:
    """See the module docstring (phase 12)."""
    out = {}
    # (a) The registry audit on the card, and integer votes on the card.
    t0 = time.perf_counter()
    report = audit.run_audit(device=DEV)
    out["audit_s"] = time.perf_counter() - t0
    out.update(audit_checked=len(report.checked), audit_skipped=len(report.skipped),
               audit_findings=len(report.findings), audit_errors=len(report.errors),
               audit_self_checks=report.self_checks)
    if not report.ok:
        emit({"phase": "lint", "audit_report": report.to_dict()})
    require(report.ok, f"audit on the card: {len(report.findings)} finding(s), "
                       f"{len(report.errors)} error(s)")
    require(report.self_checks == ["dirty-int-image", "dirty-eigh", "dirty-plain-on-card"],
            f"audit self-checks fired: {report.self_checks}")
    gen = torch.Generator(device=DEV).manual_seed(19)
    int_votes = {}
    for case in audit.audit_cases():
        if case.spec.accum != "int" or case.temporal_window is not None:
            continue
        x = torch.randint(-1, case.spec.levels, case.shape, generator=gen, device=DEV,
                          dtype=torch.int32)
        want = compile_plan(case.spec.replace(scheme="scatter"), case.shape)(x)
        for scheme in ("onehot", "blocked"):
            for copies in (1, 3):
                spec = case.spec.replace(scheme=scheme, copies=copies)
                if audit._serves(_backends.get_backend(scheme), case) is not None:
                    continue
                err = float((compile_plan(spec, case.shape)(x) - want).abs().max())
                require(err == 0, f"{scheme} int votes differ from scatter on {case.name}")
                int_votes[f"{case.name}/{scheme}/R{copies}"] = err
    out["int_votes_max_abs_err"] = int_votes

    # (b) The main path's plans, linted at the paper's sizes.
    plans = {}
    for name, spec, shape, features, window, dtype, kernel in LINT_PLANS:
        before = _lint_ms_sum()
        plan = compile_plan(spec, shape, features=features, temporal_window=window,
                            check="lint")
        lint_ms = _lint_ms_sum() - before
        require(plan.lint == (), f"{name}: lint findings {plan.lint}")
        require(not plan.tuned, f"{name}: the plan is tuned; lint the untuned one")
        record = op_lint.record_plan(plan, dtype)
        kernels = (kernel, "haralick_tail", "second_eigenvalue") if features else (kernel,)
        _only(record.launches, kernels, f"{name} lint record")
        require(all(record.launches[k] == 1 for k in kernels), f"{name}: {record.launches}")
        if dtype != torch.float32:  # the main path's own input dtype, linted too
            require(op_lint.lint_plan(plan, dtype=dtype) == (),
                    f"{name}: findings on {dtype} input")
        x = op_lint.lint_input(plan, dtype)
        if window is None:
            call_ms = cuda_ms(lambda: plan(x), reps=3)
        else:
            state = plan.init_state()
            call_ms = cuda_ms(lambda: plan.update(state, x), reps=3)
        plans[name] = {"scheme": plan.spec.scheme, "lint_ms": lint_ms, "call_ms": call_ms,
                       "lint_over_call": lint_ms / call_ms, "ops": len(record.ops),
                       "launches": {k: n for k, n in record.launches.items() if n}}
        del x, record
    out["plans"] = plans

    # (c) Dirty backends on the card must make the lint raise.
    out["dirty"] = [
        _dirty_lint("_smoke_plain_on_card", _plain_fused_on_card, "device-kernel-launches"),
        _dirty_lint("_smoke_item_on_card", _item_on_card, "no-host-callback"),
    ]
    emit({"phase": "lint", **out})
    return out


AUTOTUNE_PATH = ROOT / "build" / "autotune.json"
AUTOTUNE_TRIALS = 3
AUTOTUNE_WORKLOADS = (
    ("features-4096", GLCMSpec(levels=LEVELS, pairs=PAPER_PAIRS, quantize="uniform"), True),
    ("glcm-16384", GLCMSpec(levels=LEVELS, pairs=((1, 45),), quantize="uniform"), False),
)
COPIES_SWEEP = (1, 2, 4, 8, 16, 32)


def _winner_kernels(spec: GLCMSpec) -> tuple[str, ...]:
    """The kernel a plan of this resolved global 2-D spec launches (none for
    the plain backends)."""
    return {"cuda": ("glcm_vote",), "cuda_fused": ("glcm_fused",)}.get(spec.scheme, ())


def _event_ms(plan, x) -> float:
    """One call of ``plan(x)`` between CUDA events, host work included."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    plan(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _alternating(untuned, tuned, x, pairs: int = 5) -> dict:
    """Untuned and tuned plan on ``x`` in ``pairs`` CUDA-event pairs, the
    order alternating (untuned first in even pairs), after a warm-up each."""
    _event_ms(untuned, x)
    _event_ms(tuned, x)
    ms = {"untuned": [], "tuned": []}
    for i in range(pairs):
        order = (("untuned", untuned), ("tuned", tuned))
        for side, plan in (order if i % 2 == 0 else order[::-1]):
            ms[side].append(_event_ms(plan, x))
    return {**{f"{k}_ms": v for k, v in ms.items()},
            **{f"{k}_median_ms": float(np.median(v)) for k, v in ms.items()}}


def _fresh_process_choice(index: int, shape) -> dict:
    """What a fresh interpreter resolves ``AUTOTUNE_WORKLOADS[index]`` at
    ``shape`` to, from the sidecar alone, and the ``autotune.*`` spans it
    recorded."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import chip_smoke\n"
        "from repro_torch.obs.trace import Tracer, set_tracer\n"
        "tr = Tracer(enabled=True)\n"
        "set_tracer(tr)\n"
        f"_, spec, features = chip_smoke.AUTOTUNE_WORKLOADS[{index}]\n"
        f"plan = chip_smoke.compile_plan(spec, {tuple(shape)!r}, features=features)\n"
        "tuned = None if plan.tuned is None else [plan.tuned.backend, dict(plan.tuned.knobs)]\n"
        "spans = [s.name for s in tr.spans() if s.name.startswith('autotune.')]\n"
        "print(json.dumps({'scheme': plan.spec.scheme, 'tuned': tuned, 'autotune_spans': spans}))\n"
    )
    env = dict(os.environ, REPRO_TORCH_AUTOTUNE_PATH=str(AUTOTUNE_PATH))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                       timeout=300)
    require(r.returncode == 0, f"fresh process failed: {r.stderr[-2000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def _tune_one(name, spec, features, x, smooth) -> dict:
    """Tune one workload, then check and time what ``compile_plan`` serves."""
    shape = tuple(x.shape)
    untuned = compile_plan(spec, shape, features=features)
    untuned_counts = compile_plan(spec, shape)
    require(untuned.tuned is None and untuned_counts.tuned is None,
            f"{name}: a winner was stored before tuning")
    t0 = time.perf_counter()
    report: dict = {}
    choice = autotune.autotune(spec, shape, features=features, trials=AUTOTUNE_TRIALS,
                               report=report)
    tune_s = time.perf_counter() - t0
    base = [r for r in report["measured"]
            if spec.replace(scheme=r["backend"], **r["knobs"]) == untuned.spec]
    require(len(base) == 1, f"{name}: the untuned choice {untuned.spec.scheme} was not "
                            f"measured once ({len(base)} rows)")
    winner = min(report["measured"], key=lambda r: r["us"])

    tuned = compile_plan(spec, shape, features=features)
    tuned_counts = compile_plan(spec, shape)
    for p in (tuned, tuned_counts):
        require(p.tuned == choice, f"{name}: plan.tuned {p.tuned} != winner {choice}")
        require(p.spec == choice.apply(spec), f"{name}: plan spec {p.spec} lacks the knobs")
    kernels = _winner_kernels(tuned.spec)
    reset_launches()
    got = tuned(x)
    torch.cuda.synchronize()
    counts_run = launches()
    _only(counts_run, kernels + (("haralick_tail", "second_eigenvalue") if features else ()),
          f"{name}: tuned plan")
    for kernel in kernels:
        require(counts_run[kernel] > 0, f"{name}: tuned plan never launched {kernel}")
    counts = tuned_counts(x)
    require(torch.equal(counts, untuned_counts(x)), f"{name}: tuned counts != untuned counts")
    plain = compile_plan(spec.replace(scheme="scatter"), shape)(x)
    require(torch.equal(counts, plain), f"{name}: tuned counts != plain scatter counts")
    del plain
    out = {}
    if features:
        want = untuned(x).cpu().numpy()
        have = got.cpu().numpy()
        require(np.isfinite(have).all() and have.shape == want.shape,
                f"{name}: tuned features not finite or of shape {have.shape}")
        require(np.allclose(have[..., :13], want[..., :13], rtol=FEATURE_RTOL,
                            atol=FEATURE_ATOL), f"{name}: tuned features f1-f13 differ")
        require(np.allclose(have[..., 13], want[..., 13], rtol=0, atol=F14_ATOL),
                f"{name}: tuned feature f14 differs")
        out["features_max_abs_diff"] = float(np.abs(have - want).max())
    del got, counts

    sample = autotune._sample_input(spec, shape, DEV)
    out.update(
        workload=name, shape=list(shape), features=bool(features), tune_s=tune_s,
        candidates=report["measured"], skipped=report["skipped"],
        winner={"backend": choice.backend, "knobs": dict(choice.knobs), "us": winner["us"]},
        untuned={"backend": untuned.spec.scheme, "knobs": base[0]["knobs"],
                 "us": base[0]["us"]},
        tuned_launches=counts_run,
        tuned_vs_untuned_smooth=_alternating(untuned, tuned, smooth),
        tuned_vs_untuned_sample=_alternating(untuned, tuned, sample),
    )
    del sample
    emit({"phase": "autotune", **out})
    return out


def _copies_sweep(stack, big) -> dict:
    """``glcm_vote`` over the binned (1, 45) pair streams of the smooth
    16384² image and of the random stack[4], at each R of COPIES_SWEEP
    (CUDA-event means), each result exact against R = 1."""
    out = {}
    for name, img, reps in (("smooth_16384", big, 10), ("random_4096", stack[4], 20)):
        lo, span = uniform_params(img)
        assoc, ref = pair_planes_nd(img, glcm_offsets(1, 45))
        a = bin_values(assoc, LEVELS, lo, span).reshape(1, -1)
        r = bin_values(ref, LEVELS, lo, span).reshape(1, -1)
        want = glcm_vote(a, r, levels=LEVELS, copies=1)
        ms = {}
        for copies in COPIES_SWEEP:
            require(torch.equal(glcm_vote(a, r, levels=LEVELS, copies=copies), want),
                    f"glcm_vote R={copies} on {name} differs from R=1")
            ms[str(copies)] = cuda_ms(lambda: glcm_vote(a, r, levels=LEVELS, copies=copies),
                                      reps=reps)
        out[name] = {"pairs": a.shape[1], "ms_by_copies": ms}
        del a, r, want
    return out


def phase_autotune(stack, big) -> dict:
    """The main path's workloads tuned on the card: see the module
    docstring (phase 12)."""
    t0 = time.perf_counter()
    AUTOTUNE_PATH.unlink(missing_ok=True)
    autotune.autotune_clear()
    require(autotune.store_path() == AUTOTUNE_PATH, f"store at {autotune.store_path()}")
    inputs = {  # (main-path input, smooth input of the same shape)
        "features-4096": (stack, torch.cat([stack[:4], stack[:4]])),
        "glcm-16384": (big, big),
    }
    tracer = Tracer(enabled=True)
    prev = set_tracer(tracer)
    get_registry().clear()
    try:
        runs = [_tune_one(name, spec, feats, *inputs[name])
                for name, spec, feats in AUTOTUNE_WORKLOADS]
    finally:
        set_tracer(prev)
    spans = tracer.spans()
    n_measured = sum(len(r["candidates"]) for r in runs)
    n_skipped = sum(len(r["skipped"]) for r in runs)
    count = {k: sum(s.name == k for s in spans)
             for k in ("autotune.run", "autotune.candidate", "autotune.skipped")}
    require(count == {"autotune.run": len(runs), "autotune.candidate": n_measured,
                      "autotune.skipped": n_skipped}, f"autotune spans {count}")
    series = get_registry().snapshot()["repro_autotune_candidate_us"]["series"]
    require(sum(s["count"] for s in series) == n_measured,
            "repro_autotune_candidate_us does not count every candidate")
    require("repro_autotune_candidate_us_bucket" in get_registry().to_prometheus(),
            "Prometheus text lacks repro_autotune_candidate_us")

    fresh = _fresh_process_choice(0, tuple(inputs[AUTOTUNE_WORKLOADS[0][0]][0].shape))
    want = [runs[0]["winner"]["backend"], runs[0]["winner"]["knobs"]]
    require(fresh["tuned"] == want, f"fresh process resolved {fresh['tuned']}, not {want}")
    require(not fresh["autotune_spans"], f"fresh process measured: {fresh['autotune_spans']}")
    out = {"store": str(AUTOTUNE_PATH.relative_to(ROOT)),
           "entries": len(json.loads(AUTOTUNE_PATH.read_text())),
           "workloads": [r["workload"] for r in runs],
           "tune_s": {r["workload"]: r["tune_s"] for r in runs},
           "spans": count, "fresh_process": fresh,
           "copies_sweep": _copies_sweep(stack, big),
           "seconds": time.perf_counter() - t0}
    emit({"phase": "autotune", **out})
    return out


# The distributed phase: DIST_WORLD gloo ranks sharing the card, their inputs
# as uint8 level files each rank memmaps, and the cases. Each case is
# (name, the call every rank makes, the kernel that counts it).
DIST_WORLD = 4
DIST_DIR = ROOT / "build" / "distributed"
DIST_IMAGE_PAIRS = ((1, 45), (4, 90))                 # halos of 1 and 4 rows
DIST_VOLUME_PAIRS = ((1, VOLUME_DIRECTION), (2, 9))   # halos of 1 and 2 slices
DIST_TILES = GLCMSpec(levels=LEVELS, pairs=((1, 0),), region="tiles", region_shape=TILE)
DIST_WINDOWS = GLCMSpec(levels=LEVELS, pairs=((1, 0),), region="window",
                        region_shape=WINDOW, region_stride=WINDOW_STRIDE)
DIST_TIMED_CALLS = 3


def _volume_spec(d: int, k: int) -> GLCMSpec:
    return GLCMSpec(levels=LEVELS, pairs=((d, k),), ndim=3)


def _dist_load(name: str) -> np.ndarray:
    return np.load(DIST_DIR / f"{name}.npy", mmap_mode="r")


def _dist_rows(x, lo: int, n: int) -> torch.Tensor:
    """Slices [lo, lo + n) of ``x``'s leading axis as int32 levels on the
    card, -1 for those past its end."""
    block = torch.from_numpy(np.array(x[lo: lo + n])).to(DEV).to(torch.int32)
    pad = block.new_full((n - block.shape[0], *block.shape[1:]), -1)
    return torch.cat([block, pad])


def _halo_check(x, spec: GLCMSpec, index: int, n: int, plain):
    """The shard check of a halo case: rank ``index`` of ``n``'s extended
    shard of ``x`` — its block and the next d0 slices, read here straight
    from the input — counted by the plan's ``local_partial`` hook (the
    kernel, as the sharded call runs it) and by ``plain``."""
    def check():
        plan = compile_plan(spec, tuple(x.shape), require=("sharded_partial",), device=DEV)
        off = plan.spec.offsets()[0]
        local_n = x.shape[0] // n
        ext = _dist_rows(x, index * local_n, local_n + off[0])[None]
        return (plan.backend.local_partial(ext, LEVELS, off, local_n)[0],
                plain(ext, LEVELS, (off,))[0, 0])
    return check


def _block_check(x, spec: GLCMSpec, lo: int, hi: int, plain):
    """The shard check of a case without a halo (the texture map's block of
    rows, the auto cross-check's block and gather): rows [lo, hi) of ``x``
    counted by the plan's region route (the kernel) and by ``plain``."""
    def check():
        plan = compile_plan(spec, tuple(x.shape), require=("sharded_partial",), device=DEV)
        block = _dist_rows(x, lo, min(hi, x.shape[0]) - lo)[None]
        got = compute_regions(plan.backend, block, plan.spec)[0, ..., 0, :, :]
        return got.to(torch.int32), plain(block)[0]
    return check


def _dist_cases(mesh, mesh22, rank: int):
    """The cases every rank runs, in order: (name, the call, the kernel that
    counts it, this rank's shard check)."""
    image, volume = _dist_load("image"), _dist_load("volume")
    for d, t in DIST_IMAGE_PAIRS:
        spec = GLCMSpec(levels=LEVELS, pairs=((d, t),))
        yield (f"image_d{d}_t{t}",
               lambda d=d, t=t: glcm_sharded(image, LEVELS, d, t, mesh, device=DEV),
               "glcm_fused", _halo_check(image, spec, rank, DIST_WORLD, glcm_fused_plain))
    for d, k in DIST_VOLUME_PAIRS:
        spec = _volume_spec(d, k)
        yield (f"volume_d{d}_k{k}",
               lambda spec=spec: glcm_sharded(volume, mesh=mesh, spec=spec, device=DEV),
               "glcm_volume", _halo_check(volume, spec, rank, DIST_WORLD, glcm_volume_plain))
    volumes = _dist_load("volumes")
    spec = _volume_spec(1, VOLUME_DIRECTION)
    bi, ri = divmod(rank, 2)  # the (2, 2) mesh's ("data", "model") coordinates
    yield ("volumes_batch",
           lambda: glcm_sharded_batch(volumes, mesh=mesh22, device=DEV, spec=spec),
           "glcm_volume", _halo_check(volumes[bi], spec, ri, 2, glcm_volume_plain))
    texture = _dist_load("texture")
    per = (texture.shape[0] // TILE) // DIST_WORLD  # grid rows a rank owns
    yield ("tiles", lambda: glcm_sharded(texture, mesh=mesh, spec=DIST_TILES, device=DEV),
           "glcm_window",
           _block_check(texture, DIST_TILES, rank * per * TILE, (rank + 1) * per * TILE,
                        lambda b: glcm_window_plain(b, LEVELS, ((0, 1),),
                                                    region_shape=TILE)[..., 0, :, :]))
    d, t = DIST_IMAGE_PAIRS[0]
    n0 = image.shape[0]
    lo, hi = rank * n0 // DIST_WORLD, (rank + 1) * n0 // DIST_WORLD + glcm_offsets(d, t)[0]
    yield ("auto", lambda: glcm_auto_sharded(image, LEVELS, d, t, mesh, device=DEV),
           "glcm_fused",
           _block_check(image, GLCMSpec(levels=LEVELS, pairs=((d, t),)), lo, hi,
                        lambda b: glcm_fused_plain(b, LEVELS, (glcm_offsets(d, t),))[:, 0]))


def _stage_times(fn) -> dict:
    """One call of ``fn`` under a live tracer: each ``distributed.*`` stage's
    host ms (it closes after a synchronize) and CUDA-event ms."""
    tracer = Tracer(enabled=True)
    prev = set_tracer(tracer)
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        set_tracer(prev)
    return {s.name.removeprefix("distributed."): {"host_ms": s.dur * 1e3,
                                                  "device_ms": s.attrs.get("device_ms")}
            for s in tracer.spans() if s.name.startswith("distributed.")}


def _dist_case(name: str, fn, kernel: str, check, rank: int) -> dict:
    """Run one case on this rank: the counted first call (its result saved
    for the parent), the shard check (this rank's kernel input counted by
    the kernel and by its plain version, which must agree), a traced call
    and DIST_TIMED_CALLS whole calls."""
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = fn()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    runs = launches()
    want = {k: int(k == kernel) for k in runs}
    require(runs == want, f"rank {rank} {name}: launches {runs}, expected {want}")
    require(got.device.type == "cuda" and got.dtype == torch.int32,
            f"rank {rank} {name}: counts {got.dtype} on {got.device}")
    np.save(DIST_DIR / f"{name}_r{rank}.npy", got.cpu().numpy())
    kernel_counts, plain_counts = check()
    shard_err = int((kernel_counts.to(torch.int64) - plain_counts.to(torch.int64)).abs().max())
    require(shard_err == 0, f"rank {rank} {name}: {kernel} on the rank's shard differs "
            f"from its plain version by {shard_err}")
    stages = _stage_times(fn)
    call_ms = []
    for _ in range(DIST_TIMED_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        call_ms.append((time.perf_counter() - t0) * 1e3)
    return {"launches": runs, "shard_max_abs_err": shard_err, "first_call_ms": first_ms,
            "call_ms": call_ms, "stages": stages}


def _dist_rank(rank: int) -> None:
    """One gloo rank of the distributed phase on cuda:0 (the target of
    ``torch.multiprocessing.spawn``); writes ``rank<r>.json``."""
    torch.cuda.set_device(DEV)
    dist.init_process_group("gloo", init_method=f"file://{DIST_DIR / 'gloo.store'}",
                            rank=rank, world_size=DIST_WORLD, timeout=timedelta(seconds=60))
    try:
        mesh = make_host_mesh((DIST_WORLD,), ("data",))
        mesh22 = make_host_mesh((2, 2), ("data", "model"))
        out = {name: _dist_case(name, fn, kernel, check, rank)
               for name, fn, kernel, check in _dist_cases(mesh, mesh22, rank)}
        try:
            glcm_sharded(_dist_load("texture"), mesh=mesh, spec=DIST_WINDOWS, device=DEV)
            out["window_error"] = None
        except ValueError as e:  # the indivisible grid must raise, on every rank
            out["window_error"] = str(e)
        (DIST_DIR / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _distributed_inputs(stack, big, vol) -> dict:
    """The phase's inputs as uint8 level files, each binned once to L = 32 by
    the port's uniform quantizer over its own range."""
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    DIST_DIR.mkdir(parents=True)
    arrays = {"image": big, "volume": vol[0], "texture": stack[0]}
    for name, x in arrays.items():
        np.save(DIST_DIR / f"{name}.npy",
                quantize_uniform(x, LEVELS).to(torch.uint8).cpu().numpy())
    np.save(DIST_DIR / "volumes.npy", torch.stack(
        [quantize_uniform(v, LEVELS) for v in vol]).to(torch.uint8).cpu().numpy())
    return {name: list(_dist_load(name).shape) for name in (*arrays, "volumes")}


def _one_process() -> dict:
    """Each case's counts by one process on the card over the whole input:
    the case's kernel and its plain version, which must agree bit for bit
    (the plain counts are what the ranks are held against); and the
    one-process call of the first image case (read, copy, kernel)."""
    def on_card(name):
        return torch.from_numpy(np.load(DIST_DIR / f"{name}.npy")).to(DEV).to(torch.int32)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    image = on_card("image")
    d, t = DIST_IMAGE_PAIRS[0]
    ops.glcm_cuda_multi(image, LEVELS, ((d, t),))
    torch.cuda.synchronize()
    timing = {"one_process_call_ms": (time.perf_counter() - t0) * 1e3,
              "one_process_kernel_ms": cuda_ms(
                  lambda: ops.glcm_cuda_multi(image, LEVELS, ((d, t),)), reps=5)}
    got, want = {}, {}
    for d, t in DIST_IMAGE_PAIRS:
        name = f"image_d{d}_t{t}"
        got[name] = ops.glcm_cuda_multi(image, LEVELS, ((d, t),))[0]
        want[name] = glcm_fused_plain(image[None], LEVELS, (glcm_offsets(d, t),))[0, 0]
    first = "image_d{}_t{}".format(*DIST_IMAGE_PAIRS[0])  # auto's pair
    got["auto"], want["auto"] = got[first], want[first]
    del image
    volume = on_card("volume")
    for d, k in DIST_VOLUME_PAIRS:
        name = f"volume_d{d}_k{k}"
        got[name] = ops.glcm_cuda_volume(volume, LEVELS, ((d, k),))[0]
        want[name] = glcm_volume_plain(volume[None], LEVELS, (glcm_offsets_3d(d, k),))[0, 0]
    del volume
    volumes = on_card("volumes")
    got["volumes_batch"] = ops.glcm_cuda_volume(volumes, LEVELS, ((1, VOLUME_DIRECTION),))[:, 0]
    want["volumes_batch"] = glcm_volume_plain(
        volumes, LEVELS, (glcm_offsets_3d(1, VOLUME_DIRECTION),))[:, 0]
    del volumes
    texture = on_card("texture")
    got["tiles"] = glcm_window(texture, levels=LEVELS, offsets=((0, 1),),
                               region_shape=TILE)[..., 0, :, :]
    want["tiles"] = glcm_window_plain(texture, LEVELS, ((0, 1),),
                                      region_shape=TILE)[..., 0, :, :]
    del texture
    for name in want:
        err = int((got[name].to(torch.int64) - want[name].to(torch.int64)).abs().max())
        require(err == 0, f"{name}: one process's kernel differs from its plain version by {err}")
    want = {k: v.cpu().numpy() for k, v in want.items()}
    del got
    torch.cuda.empty_cache()  # the ranks share the card
    return want, timing


def _assemble(name: str, blocks: list[np.ndarray]) -> np.ndarray:
    """The rank results of one case as the one-process array: whole outputs
    must agree on every rank (every rank of a row group for the batch);
    the texture map's blocks concatenate in rank order."""
    if name == "tiles":
        return np.concatenate(blocks)
    if name == "volumes_batch":  # (2, 2) mesh: rank r holds volume r // 2
        for r in (1, 3):
            require(np.array_equal(blocks[r], blocks[r - 1]),
                    f"{name}: ranks {r - 1} and {r} of a row group differ")
        return np.concatenate([blocks[0], blocks[2]])
    for r in range(1, len(blocks)):
        require(np.array_equal(blocks[r], blocks[0]), f"{name}: rank {r} differs from rank 0")
    return blocks[0]


def _nccl_one_rank(want: np.ndarray) -> dict:
    """The first image case on a 1-rank NCCL group on the card: the
    collectives' device-tensor route (the all_reduce; one rank has no halo
    to exchange)."""
    dist.init_process_group("nccl", init_method=f"file://{DIST_DIR / 'nccl.store'}",
                            rank=0, world_size=1, timeout=timedelta(seconds=60))
    try:
        require(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
        mesh = make_compat_mesh((1,), ("data",))
        image = _dist_load("image")
        d, t = DIST_IMAGE_PAIRS[0]
        out = _dist_case(f"image_d{d}_t{t}_nccl",
                         lambda: glcm_sharded(image, LEVELS, d, t, mesh, device=DEV),
                         "glcm_fused",
                         _halo_check(image, GLCMSpec(levels=LEVELS, pairs=((d, t),)), 0, 1,
                                     glcm_fused_plain), 0)
        got = np.load(DIST_DIR / f"image_d{d}_t{t}_nccl_r0.npy")
        require(np.array_equal(got, want), "1-rank NCCL counts differ from one process")
    finally:
        dist.destroy_process_group()
    return out


def phase_distributed(shapes: dict) -> dict:
    """Multi-rank sharding (``core.distributed``): DIST_WORLD gloo ranks on
    cuda:0 run every case of ``_dist_cases``; each rank's counts are held bit
    for bit against one process counting the whole input on the card; see the
    module docstring (phase 13)."""
    t_phase = time.perf_counter()
    want, timing = _one_process()
    t0 = time.perf_counter()
    torch.multiprocessing.spawn(_dist_rank, nprocs=DIST_WORLD, join=True)
    spawn_s = time.perf_counter() - t0
    ranks = [json.loads((DIST_DIR / f"rank{r}.json").read_text()) for r in range(DIST_WORLD)]
    cases = {}
    for name in want:
        blocks = [np.load(DIST_DIR / f"{name}_r{r}.npy") for r in range(DIST_WORLD)]
        got = _assemble(name, blocks)
        require(got.shape == want[name].shape, f"{name}: shape {got.shape} != {want[name].shape}")
        err = int(np.abs(got.astype(np.int64) - want[name].astype(np.int64)).max())
        require(err == 0, f"{name}: sharded counts differ from one process by {err}")
        cases[name] = {"shape": list(got.shape), "max_abs_err": err,
                       "ranks": [r[name] for r in ranks]}
        emit({"phase": "distributed", "case": name, **cases[name]})
    grid = (shapes["texture"][0] - WINDOW) // WINDOW_STRIDE + 1
    expect = f"region grid extent {grid} not divisible by {DIST_WORLD} shards"
    errors = [r["window_error"] for r in ranks]
    require(errors == [expect] * DIST_WORLD, f"indivisible window grid: {errors}")
    d, t = DIST_IMAGE_PAIRS[0]
    nccl = _nccl_one_rank(want[f"image_d{d}_t{t}"])
    out = {"world": DIST_WORLD, "inputs": shapes, "cases": list(cases), "window_error": expect,
           "nccl_one_rank": nccl, "spawn_s": spawn_s, **timing,
           "sharded_launches_per_rank": {
               k: [sum(r[c]["launches"][k] for c in cases) for r in ranks]
               for k in ("glcm_fused", "glcm_volume", "glcm_window")},
           "seconds": time.perf_counter() - t_phase}
    emit({"phase": "distributed", **out})
    shutil.rmtree(DIST_DIR)
    return out


# ---------------------------------------------------------------------------
# lm: the LM model core and its serving engine (ROADMAP item 18)
# ---------------------------------------------------------------------------

# smollm-135m at full width, as published (bfloat16 compute, float32
# parameters): prefill 8 x 4096 (sdpa_chunked over 4 chunks of 1024), then
# Engine.generate at B = 8 and 64 with 512-token prompts and 64 new tokens.
LM_ARCH = "smollm-135m"
LM_PREFILL = (8, 4096)
LM_GENERATE = ((8, 512, 64), (64, 512, 64))        # (B, prompt, new)
LM_S_CACHE = 640
# Check 1: float32 compute, the same weights on the card and on the CPU,
# prefill at B = 1, T = 1100 (the chunked path with a padded last chunk) and
# three teacher-forced decode steps; logits within LM_F32_ATOL + LM_F32_RTOL
# of the largest |logit| (the summation order differs, every op is float32).
LM_CHECK_T = 1100
LM_F32_ATOL, LM_F32_RTOL = 1e-4, 1e-4
# Check 2: Engine.generate greedy in float32 on the card against one forward
# over the generated sequence: every step's logits within LM_F32_ATOL +
# LM_F32_RTOL · max|logit|, every chosen token the forward's argmax or within
# that tolerance of its max.
LM_GREEDY = (4, 256, 16)
# Check 3: bfloat16 compute against float32 on the card, the prefill logits
# at B = 1, T = LM_CHECK_T: max |Δ| / max |logit| below LM_BF16_REL.
LM_BF16_REL = 0.05
# mamba2-130m at full width: prefill 4 x 2048, 16 decode steps, check 2 in
# float32.
LM_SSM_ARCH = "mamba2-130m"
LM_SSM = (4, 2048, 16)
# The other families, reduced (cfg.reduced()): one Engine.generate each on
# the card and on the CPU, the same weights; logits within LM_REDUCED_ATOL,
# tokens equal (or, where they part, the CPU's top-2 margin at that step
# within the tolerance).
LM_REDUCED = (
    ("hybrid", "hymba-1.5b", {}),
    ("moe_einsum", "mixtral-8x7b", {"moe_dispatch": "einsum"}),
    ("moe_gather", "mixtral-8x7b", {"moe_dispatch": "gather"}),
    ("moe_gather_dense_residual", "arctic-480b", {}),
    ("encdec", "whisper-medium", {}),
    ("kv_quant", "smollm-135m", {"kv_quant": True}),
)
LM_REDUCED_GEN = (2, 12, 8)                         # (B, prompt, new); windows are 8
LM_REDUCED_ATOL = 1e-4


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


def _copy_model(cfg, model, device):
    """The same weights in a new module on ``device``."""
    out = model_module(cfg, device=device)
    out.load_state_dict(model.state_dict())
    return out


class _EngineRecorder:
    """Wraps an engine's prefill and decode step: CUDA-event ms of each call
    (on the card) and, with ``keep``, the logits each call returned."""

    def __init__(self, eng: Engine, keep: bool):
        self.timed = eng.device.type == "cuda"
        self.calls: list[tuple[str, object, object]] = []
        self.logits: list[torch.Tensor] = []
        for attr, kind in (("_prefill", "prefill"), ("_step", "step")):
            setattr(eng, attr, self._wrap(getattr(eng, attr), kind, keep))

    def _wrap(self, fn, kind, keep):
        def call(*args):
            if self.timed:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            out = fn(*args)
            if self.timed:
                ev[1].record()
                self.calls.append((kind, *ev))
            if keep:
                self.logits.append(out[0])
            return out
        return call

    def ms(self) -> dict:
        torch.cuda.synchronize()
        got = {"prefill": [], "step": []}
        for kind, start, end in self.calls:
            got[kind].append(start.elapsed_time(end))
        return got


def _generate(cfg, model, b: int, t: int, new: int, *, seed: int, keep: bool,
              device=None, enc=False):
    """One Engine.generate of seeded prompts on ``device`` (default the
    card); returns (prompts, out, recorder, host seconds, enc_embeds)."""
    device = device or DEV
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    enc_embeds = (rng.normal(size=(b, t, cfg.d_model)).astype(np.float32) if enc else None)
    eng = Engine(cfg, model, ServeConfig(max_new_tokens=new, s_cache=t + new), device=device)
    rec = _EngineRecorder(eng, keep)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.generate(prompts, enc_embeds=enc_embeds)   # ends in a copy to the host
    return prompts, out, rec, time.perf_counter() - t0, enc_embeds


def _greedy_vs_forward(cfg, model, b: int, t: int, new: int, seed: int) -> dict:
    """Check 2: every step's logits of a greedy Engine.generate against one
    full forward over the generated sequence; each chosen token is the
    forward's argmax or within the tolerance of its max."""
    prompts, out, rec, _, _ = _generate(cfg, model, b, t, new, seed=seed, keep=True)
    api = build_model(cfg, device=DEV)
    with torch.no_grad():
        full, _ = api.forward(model, {"tokens": out})
    v = cfg.vocab_size   # the padded ids' logits are -1e9 on both sides
    want = full[:, t - 1: t + new, :v].float()                # (B, 1 + new, V)
    got = torch.stack(rec.logits, dim=1)[..., :v].float()   # prefill, then the steps
    tol = LM_F32_ATOL + LM_F32_RTOL * float(want.abs().max())
    err = float((got - want).abs().max())
    chosen = torch.from_numpy(out[:, t:]).long().to(DEV)
    fw = want[:, :new]
    gap = float((fw.amax(-1) - fw.gather(-1, chosen[..., None])[..., 0]).max())
    argmax_equal = int((fw.argmax(-1) == chosen).sum())
    require(err <= tol, f"{cfg.name}: decode logits differ from the forward by {err} > {tol}")
    require(gap <= tol, f"{cfg.name}: a greedy token is {gap} below the forward's max (> {tol})")
    return {"shape": [b, t, new], "max_abs_err": err, "tol": tol, "token_gap": gap,
            "argmax_equal": argmax_equal, "tokens": b * new}


def _decode_launches(api, model, b: int, t: int) -> dict:
    """Kernels one decode step launches (torch.profiler's CUDA events) and
    the aten ops it dispatches (``op_lint.record_call``), at batch ``b``
    after a ``t``-token prefill."""
    rng = np.random.default_rng(5)
    toks = rng.integers(0, api.cfg.vocab_size, (b, t)).astype(np.int32)
    _, caches = api.prefill(model, {"tokens": toks}, s_cache=t + 4)
    tok = torch.zeros((b, 1), dtype=torch.int32, device=DEV)
    pos = torch.full((b,), t, dtype=torch.int32, device=DEV)
    api.decode_step(model, caches, tok, pos)                  # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        api.decode_step(model, caches, tok, pos + 1)
        torch.cuda.synchronize()
    device_events = [e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    # One stream: the kernels' summed durations are the card's busy time.
    busy_ms = sum(e.time_range.elapsed_us() for e in device_events) / 1e3
    span_ms = (max(e.time_range.end for e in device_events)
               - min(e.time_range.start for e in device_events)) / 1e3 if device_events else 0.0
    ops = op_lint.record_call(api.decode_step, model, caches, tok, pos + 2).ops
    return {"launches_per_step": len(device_events) if device_events else None,
            "kernel_names": len({e.name for e in device_events}),
            "profiled_step_busy_ms": busy_ms, "profiled_step_span_ms": span_ms,
            "aten_ops_per_step": len(ops),
            "aten_ops_on_card": sum("cuda" in op.in_devices + op.devices for op in ops)}


def _lm_full_width() -> dict:
    """smollm-135m at full width: prefill, generation, checks 1-3."""
    cfg = get_config(LM_ARCH)
    api = build_model(cfg, device=DEV)
    model = api.init(torch.Generator(DEV).manual_seed(0))
    out = {"arch": cfg.name, "params": param_count(model), "describe": describe(cfg),
           "compute_dtype": cfg.compute_dtype}
    rng = np.random.default_rng(1)

    # Prefill 8 x 4096 (bfloat16 compute): CUDA events, tokens/s, peak.
    b, t = LM_PREFILL
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)).to(DEV)
    api.prefill(model, {"tokens": toks}, s_cache=t)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = cuda_ms(lambda: api.prefill(model, {"tokens": toks}, s_cache=t), reps=2, warmup=0)
    out["prefill"] = {"shape": [b, t], "ms": ms, "tokens_per_s": b * t / ms * 1e3,
                      "peak_bytes": torch.cuda.max_memory_allocated(),
                      "peak_above_weights_bytes": torch.cuda.max_memory_allocated() - base}
    del toks
    emit({"phase": "lm", "what": "prefill", **out["prefill"]})

    # Engine.generate at B = 8 and 64: prefill ms, ms per decode step.
    out["generate"] = []
    for gb, gt, new in LM_GENERATE:
        _generate(cfg, model, gb, gt, 4, seed=2, keep=False)            # warm-up
        _, gen, rec, host_s, _ = _generate(cfg, model, gb, gt, new, seed=3, keep=False)
        got = rec.ms()
        steps = got["step"]
        require(gen.shape == (gb, gt + new), f"generate shape {gen.shape}")
        require(int(gen.max()) < cfg.vocab_size and int(gen.min()) >= 0, "generated ids")
        row = {"shape": [gb, gt, new], "s_cache": gt + new, "prefill_ms": got["prefill"][0],
               "decode_steps": len(steps), "step_ms_median": float(np.median(steps)),
               "step_ms_min": min(steps), "step_ms_max": max(steps),
               "decode_tokens_per_s": gb * len(steps) / sum(steps) * 1e3,
               "generate_host_s": host_s,
               **_decode_launches(api, model, gb, gt)}
        out["generate"].append(row)
        emit({"phase": "lm", "what": "generate", **row})

    # Check 1: float32 on the card against float32 on the CPU.
    cfg32 = _f32(cfg)
    api32, cpu32 = build_model(cfg32, device=DEV), build_model(cfg32, device="cpu")
    cpu_model = _copy_model(cfg32, model, "cpu")
    toks = rng.integers(0, cfg.vocab_size, (1, LM_CHECK_T)).astype(np.int32)
    t0 = time.perf_counter()
    want, want_c = cpu32.prefill(cpu_model, {"tokens": toks}, s_cache=LM_CHECK_T + 3)
    cpu_s = time.perf_counter() - t0
    got, got_c = api32.prefill(model, {"tokens": toks}, s_cache=LM_CHECK_T + 3)
    v = cfg.vocab_size
    errs = [float((got.cpu() - want).abs().max())]
    tols = [LM_F32_ATOL + LM_F32_RTOL * float(want[:, :v].abs().max())]
    for s in range(3):   # teacher-forced: the same next tokens on both sides
        nxt = rng.integers(0, cfg.vocab_size, (1, 1)).astype(np.int32)
        pos = np.full((1,), LM_CHECK_T + s, np.int32)
        want, want_c = cpu32.decode_step(cpu_model, want_c, nxt, pos)
        got, got_c = api32.decode_step(model, got_c, nxt, pos)
        errs.append(float((got.cpu() - want).abs().max()))
        tols.append(LM_F32_ATOL + LM_F32_RTOL * float(want[:, :v].abs().max()))
    for e, tol, what in zip(errs, tols, ("prefill", "decode 1", "decode 2", "decode 3")):
        require(e <= tol, f"{cfg.name} float32 card vs CPU, {what}: {e} > {tol}")
    out["check_f32_card_vs_cpu"] = {"t": LM_CHECK_T, "max_abs_err": errs, "tol": tols,
                                    "cpu_prefill_s": cpu_s}
    del cpu_model, want_c, got_c

    # Check 2: greedy generation against one forward, float32 on the card.
    out["check_greedy_vs_forward"] = _greedy_vs_forward(cfg32, model, *LM_GREEDY, seed=4)

    # Check 3: bfloat16 compute against float32, both on the card.
    lb, _ = api.prefill(model, {"tokens": toks}, s_cache=LM_CHECK_T)
    l32, _ = api32.prefill(model, {"tokens": toks}, s_cache=LM_CHECK_T)
    rel = float((lb.float() - l32).abs().max() / l32[:, :v].abs().max())
    require(rel < LM_BF16_REL, f"{cfg.name} bfloat16 vs float32 prefill: {rel} >= {LM_BF16_REL}")
    out["check_bf16_vs_f32"] = {"t": LM_CHECK_T, "max_rel_err": rel, "tol": LM_BF16_REL}
    emit({"phase": "lm", "what": "checks", "arch": cfg.name,
          **{k: out[k] for k in ("check_f32_card_vs_cpu", "check_greedy_vs_forward",
                                 "check_bf16_vs_f32")}})
    return out


def _lm_ssm() -> dict:
    """mamba2-130m at full width: prefill and decode times (bfloat16), then
    check 2 in float32."""
    cfg = get_config(LM_SSM_ARCH)
    api = build_model(cfg, device=DEV)
    model = api.init(torch.Generator(DEV).manual_seed(0))
    b, t, new = LM_SSM
    _generate(cfg, model, b, t, 2, seed=6, keep=False)                     # warm-up
    _, gen, rec, host_s, _ = _generate(cfg, model, b, t, new, seed=7, keep=False)
    got = rec.ms()
    out = {"arch": cfg.name, "params": param_count(model), "shape": [b, t, new],
           "prefill_ms": got["prefill"][0], "prefill_tokens_per_s": b * t / got["prefill"][0] * 1e3,
           "step_ms_median": float(np.median(got["step"])),
           "decode_tokens_per_s": b * len(got["step"]) / sum(got["step"]) * 1e3,
           "generate_host_s": host_s,
           "check_greedy_vs_forward": _greedy_vs_forward(_f32(cfg), model, b, t, new, seed=8)}
    emit({"phase": "lm", "what": "ssm", **out})
    return out


def _hold_generation(name, t, got_out, got_logits, want_out, want_logits) -> dict:
    """The card's generation against the CPU's: logits within
    LM_REDUCED_ATOL up to the first step whose tokens part (if any), where
    the CPU's top-2 margin must be within the tolerance too."""
    got_tok, want_tok = got_out[:, t:], want_out[:, t:]
    parted = np.nonzero((got_tok != want_tok).any(axis=0))[0]
    last = int(parted[0]) if parted.size else got_tok.shape[1]
    err = max(float((g.cpu().float() - w.float()).abs().max())
              for g, w in zip(got_logits[: last + 1], want_logits[: last + 1]))
    require(err <= LM_REDUCED_ATOL, f"{name}: card vs CPU logits differ by {err}")
    margin = None
    if parted.size:
        top2 = want_logits[last].float().topk(2, dim=-1).values
        margin = float((top2[:, 0] - top2[:, 1]).min())
        require(margin <= LM_REDUCED_ATOL, f"{name}: tokens part at step {last} "
                f"with a CPU top-2 margin of {margin}")
    return {"max_abs_err": err, "tokens_equal": not parted.size, "parted_at": None
            if not parted.size else last, "margin_at_part": margin}


def _lm_reduced() -> dict:
    """The other families, reduced: one Engine.generate each, card vs CPU."""
    out = {}
    b, t, new = LM_REDUCED_GEN
    for name, arch, over in LM_REDUCED:
        cfg = get_config(arch).reduced(**over)
        cpu_model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        dev_model = _copy_model(cfg, cpu_model, DEV)
        enc = cfg.is_encoder_decoder
        _, want, want_rec, _, _ = _generate(cfg, cpu_model, b, t, new, seed=9, keep=True,
                                            device=torch.device("cpu"), enc=enc)
        _, got, got_rec, _, _ = _generate(cfg, dev_model, b, t, new, seed=9, keep=True,
                                          enc=enc)
        require(got.shape == (b, t + new), f"{name}: shape {got.shape}")
        out[name] = {"arch": cfg.name, "dispatch": cfg.moe_dispatch if cfg.num_experts else None,
                     "kv_quant": cfg.kv_quant,
                     **_hold_generation(name, t, got, got_rec.logits, want, want_rec.logits)}
        if cfg.kv_quant:
            _, caches = build_model(cfg, device=DEV).prefill(dev_model, {"tokens": got[:, :t]})
            require(caches[0]["k"].dtype == torch.int8, f"{name}: cache not int8")
    emit({"phase": "lm", "what": "reduced", "cases": out})
    return out


def phase_lm() -> dict:
    """The LM model core and its serving engine on the card (see the module
    docstring, phase 15)."""
    t0 = time.perf_counter()
    settings = {
        "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "allow_bf16_reduced_precision_reduction":
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
    }
    # The float32 checks compare float32 arithmetic: TF32 must be off (the
    # default; library code flips no global flag).
    require(not settings["allow_tf32"] and settings["float32_matmul_precision"] == "highest",
            f"float32 matmuls would run in TF32: {settings}")
    emit({"phase": "lm", "what": "settings", **settings})
    out = {"settings": settings, "smollm": _lm_full_width(), "mamba2": _lm_ssm(),
           "reduced": _lm_reduced()}
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    emit({"phase": "lm", "seconds": out["seconds"]})
    return out


# ---------------------------------------------------------------------------
# train: single-process LM training (ROADMAP Queue 1 item A)
# ---------------------------------------------------------------------------

# smollm-135m at full width as published (float32 parameters, bfloat16
# compute, remat on, AdamW), through train.loop.train: 8 steps of 8 x 2048
# tokens with a checkpoint at step 4, then on to 10 steps from that
# checkpoint (resuming at step 5).
TRAIN_ARCH = "smollm-135m"
TRAIN_LOOP = dict(total_steps=8, seq_len=2048, global_batch=8, ckpt_every=4, log_every=1)
TRAIN_RESUME_STEPS = 10
TRAIN_DIR = ROOT / "build" / "train_ckpt"
# Float32 card vs CPU at B = 1, T = 256, the same weights: the loss within
# TRAIN_LOSS_RTOL; each parameter's gradient within TRAIN_GRAD_RTOL of that
# parameter's max |g| plus TRAIN_GRAD_FLOOR of the model's (summation order
# differs over 30 layers); after one AdamW step each parameter within
# TRAIN_PARAM_ATOL wherever its gradient exceeds that gradient tolerance on
# the CPU. Where it does not, the step's sign can differ between the two
# (Adam's first update is about lr · sign(g)): those elements within 2 · lr
# plus TRAIN_PARAM_ATOL, and counted.
TRAIN_CHECK = (1, 256)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL, TRAIN_GRAD_FLOOR = 1e-4, 1e-5
TRAIN_PARAM_ATOL = 1e-6
# Remat on vs off on the card, bfloat16 compute at B = 2, T = 2048 (fits
# without remat): each gradient within TRAIN_REMAT_RTOL of its max |g| (the
# recomputation repeats the same kernels on the same inputs).
TRAIN_REMAT = (2, 2048)
TRAIN_REMAT_RTOL = 1e-6


def _grads(api, model, batch) -> tuple[float, dict]:
    model.zero_grad(set_to_none=True)
    loss, _ = api.loss(model, batch)
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().clone() for n, p in model.named_parameters()
                         if p.grad is not None}


def _grad_gaps(got: dict, want: dict) -> tuple[float, dict]:
    """The largest ratio max |Δ| / (that parameter's tolerance) and, per
    parameter, the gradient tolerance."""
    top = max(float(w.abs().max()) for w in want.values())
    tols, worst = {}, 0.0
    for n, w in want.items():
        tols[n] = TRAIN_GRAD_RTOL * float(w.abs().max()) + TRAIN_GRAD_FLOOR * top
        worst = max(worst, float((got[n].to(w.device) - w).abs().max()) / tols[n])
    return worst, tols


def _adamw_gaps(got: dict, want: dict, grads: dict, tols: dict, lr: float):
    """After one AdamW step from the same weights: the largest gap where the
    gradient exceeds its tolerance (within TRAIN_PARAM_ATOL), the largest
    elsewhere (within 2 · lr + TRAIN_PARAM_ATOL: the step's sign can differ
    there) and how many elements there are apart by more than the strict
    tolerance. ``got`` / ``want`` / ``grads`` map names to CPU tensors."""
    strict_err, loose_err, loose = 0.0, 0.0, 0
    for n, q in want.items():
        d = (got[n] - q.detach()).abs()
        sure = grads[n].abs() > tols[n]
        if bool(sure.any()):
            strict_err = max(strict_err, float(d[sure].max()))
        if bool((~sure).any()):
            loose_err = max(loose_err, float(d[~sure].max()))
            loose += int((d[~sure] > TRAIN_PARAM_ATOL).sum())
    require(strict_err <= TRAIN_PARAM_ATOL, f"AdamW step: params differ by {strict_err}")
    require(loose_err <= 2 * lr + TRAIN_PARAM_ATOL,
            f"AdamW step: small-gradient params differ by {loose_err} > 2 lr")
    return strict_err, loose_err, loose


def _train_f32_parity(cfg) -> dict:
    """Float32 card vs CPU: the loss, every gradient, one AdamW step."""
    cfg32 = _f32(cfg)
    b, t = TRAIN_CHECK
    cpu_api, dev_api = build_model(cfg32, device="cpu"), build_model(cfg32, device=DEV)
    cpu_model = cpu_api.init(torch.Generator().manual_seed(2))
    dev_model = _copy_model(cfg32, cpu_model, DEV)
    batch = SyntheticTokens(cfg.vocab_size, seq_len=t, global_batch=b, seed=3).batch_at(0)
    want_loss, want = _grads(cpu_api, cpu_model, batch)
    got_loss, got = _grads(dev_api, dev_model, batch)
    require(set(got) == set(want), "card and CPU differ in which parameters have gradients")
    loss_err = abs(got_loss - want_loss)
    require(math.isfinite(got_loss) and loss_err <= TRAIN_LOSS_RTOL * abs(want_loss),
            f"float32 loss: card {got_loss} vs CPU {want_loss}")
    grad_ratio, tols = _grad_gaps(got, want)
    require(grad_ratio <= 1.0, f"float32 gradients: {grad_ratio} x the tolerance")
    ocfg = make_optimizer("adamw", total_steps=TRAIN_LOOP["total_steps"])[0]
    _, _, om = adamw_update(ocfg, None, adamw_init(cpu_model), cpu_model)
    adamw_update(ocfg, None, adamw_init(dev_model), dev_model)
    lr = float(om["lr"])
    strict_err, loose_err, loose = _adamw_gaps(
        {n: p.detach().cpu() for n, p in dev_model.named_parameters()},
        dict(cpu_model.named_parameters()), want, tols, lr)
    out = {"shape": [b, t], "loss_cpu": want_loss, "loss_card": got_loss, "loss_abs_err": loss_err,
           "grad_err_over_tol": grad_ratio, "step_lr": lr, "param_max_abs_err": strict_err,
           "small_grad_param_max_abs_err": loose_err, "small_grad_params_apart": loose,
           "params": param_count(cpu_model)}
    del cpu_model, dev_model, got, want
    return out


def _train_remat_check(cfg) -> dict:
    """Remat on vs off on the card: the same gradients."""
    b, t = TRAIN_REMAT
    batch = SyntheticTokens(cfg.vocab_size, seq_len=t, global_batch=b, seed=4).batch_at(0)
    model = build_model(cfg, device=DEV).init(torch.Generator(DEV).manual_seed(5))
    grads, peaks = {}, {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        torch.cuda.reset_peak_memory_stats()
        _, grads[remat] = _grads(build_model(c, device=DEV), model, batch)
        peaks[remat] = torch.cuda.max_memory_allocated() / 1e9
    worst = 0.0
    for n, g in grads[False].items():
        d = float((grads[True][n] - g).abs().max())
        worst = max(worst, d / max(float(g.abs().max()), 1e-30))
    require(worst <= TRAIN_REMAT_RTOL, f"remat changes the gradients by {worst} relative")
    model.zero_grad(set_to_none=True)
    del model, grads
    return {"shape": [b, t], "max_rel_err": worst, "peak_gb_remat_off": peaks[False],
            "peak_gb_remat_on": peaks[True]}


def _train_step_profile(cfg, model, opt) -> dict:
    """One training step's kernel launches and device-busy ms
    (torch.profiler), after a warm-up step, at the loop's batch."""
    step, _ = make_train_step(cfg, total_steps=TRAIN_LOOP["total_steps"], device=DEV)
    ds = SyntheticTokens(cfg.vocab_size, seq_len=TRAIN_LOOP["seq_len"],
                         global_batch=TRAIN_LOOP["global_batch"], seed=6)
    model, opt, _ = step(model, opt, ds.batch_at(0))
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step(model, opt, ds.batch_at(1))
        torch.cuda.synchronize()
    device_events = [e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in device_events) / 1e3
    span_ms = (max(e.time_range.end for e in device_events)
               - min(e.time_range.start for e in device_events)) / 1e3 if device_events else 0.0
    return {"launches_per_step": len(device_events) if device_events else None,
            "kernel_names": len({e.name for e in device_events}),
            "profiled_step_busy_ms": busy_ms, "profiled_step_span_ms": span_ms}


def _saved_params(step: int) -> dict:
    """The checkpoint's parameter arrays, read with numpy alone."""
    src = TRAIN_DIR / f"step_{step:09d}"
    manifest = json.loads((src / "manifest.json").read_text())
    return {m["path"]: np.load(src / "arrays" / f"{m['idx']}.npy")
            for m in manifest["leaves"] if m["path"].startswith("/params/")}


def phase_train() -> dict:
    """Single-process LM training on the card (see the module docstring,
    phase 16)."""
    t0 = time.perf_counter()
    require(not torch.backends.cuda.matmul.allow_tf32
            and torch.get_float32_matmul_precision() == "highest",
            "float32 matmuls would run in TF32")
    cfg = get_config(TRAIN_ARCH)
    require(cfg.remat and cfg.optimizer == "adamw" and cfg.compute_dtype == "bfloat16"
            and cfg.param_dtype == "float32", f"{cfg.name}: not the published training setup")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    out = {"arch": cfg.name, "loop": TRAIN_LOOP}

    hist: list[dict] = []
    torch.cuda.reset_peak_memory_stats()
    first = train(cfg, TrainLoopConfig(ckpt_dir=str(TRAIN_DIR), **TRAIN_LOOP),
                  log_fn=lambda s, m: hist.append({"step": s, **m}))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in hist]
    require(all(math.isfinite(v) for v in losses), f"non-finite losses {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    step_ms = [h["step_time_s"] * 1e3 for h in hist[1:]]
    med = float(np.median(step_ms))
    tokens = TRAIN_LOOP["global_batch"] * TRAIN_LOOP["seq_len"]
    out.update(first_loss=losses[0], last_loss=losses[-1], losses=losses,
               first_step_ms=hist[0]["step_time_s"] * 1e3, step_ms=step_ms,
               median_step_ms=med, tokens_per_s=tokens / (med / 1e3), peak_gb=peak_gb,
               grad_norms=[h["grad_norm"] for h in hist], stragglers=first["stragglers"])
    emit({"phase": "train", "what": "loop", **out})

    # Resume: the checkpoint at step 4, restored bit for bit, then on to 10.
    saved_at = train_ckpt.latest_step(TRAIN_DIR)
    require(saved_at == TRAIN_LOOP["ckpt_every"], f"latest checkpoint at {saved_at}")
    restored = train(cfg, TrainLoopConfig(
        **{**TRAIN_LOOP, "total_steps": saved_at + 1}, ckpt_dir=str(TRAIN_DIR)))["params"]
    saved = _saved_params(saved_at)
    back = dict(train_ckpt._flatten_with_paths(reference_tree(restored), "/params"))
    require(set(back) == set(saved), "restored parameter paths != saved")
    for k, arr in saved.items():
        require(np.array_equal(back[k].cpu().numpy(), arr), f"restored {k} != saved")
    del restored, back, saved
    rhist: list[dict] = []
    resumed = train(cfg, TrainLoopConfig(**{**TRAIN_LOOP, "total_steps": TRAIN_RESUME_STEPS},
                                         ckpt_dir=str(TRAIN_DIR)),
                    log_fn=lambda s, m: rhist.append({"step": s, **m}))
    require(rhist and rhist[0]["step"] >= saved_at + 1, f"resumed at {rhist[:1]}")
    require(all(math.isfinite(h["loss"]) for h in rhist), "non-finite resumed losses")
    out["resume"] = {"from_step": saved_at, "first_step": rhist[0]["step"],
                     "losses": [h["loss"] for h in rhist], "restored_bit_equal": True}
    emit({"phase": "train", "what": "resume", **out["resume"]})

    out["profile"] = _train_step_profile(cfg, resumed["params"], resumed["opt"])
    out["profile"]["device_idle_share"] = 1 - out["profile"]["profiled_step_busy_ms"] / med
    emit({"phase": "train", "what": "profile", **out["profile"]})
    del first, resumed
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    torch.cuda.empty_cache()

    out["f32_parity"] = _train_f32_parity(cfg)
    emit({"phase": "train", "what": "f32_parity", **out["f32_parity"]})
    out["remat"] = _train_remat_check(cfg)
    emit({"phase": "train", "what": "remat", **out["remat"]})
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    emit({"phase": "train", "seconds": out["seconds"]})
    return out


# ---------------------------------------------------------------------------
# mesh: the LM sharded on a device mesh (ROADMAP Queue 1 item B)
# ---------------------------------------------------------------------------

# smollm-135m as published on a (2, 2) ("data", "model") mesh of MESH_WORLD
# gloo ranks that share cuda:0 (NCCL refuses two ranks on one card):
# float32 master weights, bfloat16 compute, remat on, AdamW, through
# train.loop.train(mesh=) with the train phase's loop seed, MESH_LOOP steps of
# 8 x 2048 tokens and a checkpoint at step 2. Every step's loss within
# MESH_LOSS_RTOL of one process's on the card: bfloat16 compute, and each rank's
# GEMMs have other shapes than one process's, so other summation orders.
MESH_WORLD = 4
MESH_SHAPE = (2, 2)
MESH_DIR = ROOT / "build" / "mesh"
MESH_LOOP = dict(total_steps=4, seq_len=2048, global_batch=8, ckpt_every=2, log_every=1)
# Sound runs on the card read at most 9.5e-6; a planted fault (each rank
# updating on its own shard's gradient, the all-reduce of every replicated
# weight's gradient dropped) reads 8.6e-4, 4.7e-3 and 4.5e-3 at steps 2-4
# (PERF.md).
MESH_LOSS_RTOL = 1e-4
# (b) Float32 on the mesh against one process on the card at B = 2, T = 256,
# the same weights: the loss, every gradient and one AdamW step within the
# train phase's TRAIN_* tolerances.
MESH_CHECK = (2, 256)
# (c) Elastic re-meshing: the step-2 checkpoint restored onto (4, 1) (through
# train(mesh=), and by restore(shardings=) for the bit-for-bit check) and
# re-placed by reshard_tree onto (1, 4); one further step on each.
MESH_ELASTIC = ((4, 1), (1, 4))
# (f) The other archs, reduced, float32: the loss and every gradient on the
# mesh against one process on the card (TRAIN_* tolerances); and
# grad_accum > 1, which the mesh still refuses.
MESH_ARCHS = (("olmo-1b", "context"), ("whisper-medium", "context"),
              ("whisper-medium", "heads_tp"), ("mamba2-130m", "context"),
              ("hymba-1.5b", "context"), ("internlm2-1.8b", "context"),
              ("llava-next-34b", "context"), ("smollm-360m", "context"),
              ("mixtral-8x7b", "context"), ("arctic-480b", "context"))
MESH_ARCH_BATCH = (4, 64)
# One step of reduced smollm with grad_accum 2: two microbatches of 8 rows.
MESH_ACCUM = TrainLoopConfig(total_steps=1, grad_accum=2)
MESH_TIMEOUT_S = 600
# (g) Mesh row B4, the MoE layer and the Mamba2 mixer sharded over "model":
# float32 on the mesh against one process on the card, from the same seeded
# weights, the loss, every gradient and one AdamW step (TRAIN_* tolerances).
# mamba2-130m as published at 2 x 512 (a chunk of 256 a "model" rank: the
# conv halo and the state combine; reduced hymba in (f) takes the rule that
# runs the SSD whole); mixtral-8x7b at full width, one layer
# of 32 (float32: 6.9 GB of weights with the embeddings, 28 GB for one
# process with its gradients and AdamW's moments; the ranks hold a quarter of
# the weights each and gather only their d_ff half of the experts). The
# ranks run first, rank 0 keeping the gathered results on the host, then one
# process on rank 0 while the others wait.
# The cuts are tools/mesh_b4.py's ARCHS.
MESH_B4_CHECK = (("mamba2-130m", (2, 512)), ("mixtral-8x7b", (2, 256)))
# Then, in the same world, steps of each at full width through train(mesh=)
# (bfloat16 compute, the published optimizer), by tools/mesh_b4.py's
# train_counted: ms a step, tokens/s, peak a rank, collectives of one more
# step by kind. Two steps of 8 x 1024 in one microbatch here, for the
# script's time (a mixtral step of four microbatches takes ~35 s over gloo,
# its weights' collectives repeated in each); the tool itself runs three
# steps at the published grad_accum, and compares two trees.
MESH_B4_STEPS = TrainLoopConfig(total_steps=2, log_every=1, seq_len=1024, global_batch=8)
# Host spans of a profiled step that are collectives: the functional ops
# DTensor issues (routed through c10d), c10d's own, gloo's.
MESH_COLLECTIVE_SPANS = ("_c10d_functional::", "c10d::", "gloo:")
# The probe: each functional collective DTensor issues, alone, on CUDA
# tensors over a 4-rank gloo world of its own (one that kills its process
# must not take the phase down with it), beside the c10d call.
MESH_PROBE = r'''
import sys, torch, torch.distributed as dist
from datetime import timedelta
rank, store, op, route, src = sys.argv[1:6]
D = torch.device("cuda", 0)
torch.cuda.set_device(D)
dist.init_process_group("gloo", init_method="file://" + store, rank=int(rank), world_size=4,
                        timeout=timedelta(seconds=60))
if route == "1":
    sys.path.insert(0, src)
    from repro_torch.sharding.gloo_cuda import route_functional_collectives
    route_functional_collectives()
x = torch.arange(8.0, device=D) + int(rank)
F, gn = torch.ops._c10d_functional, dist.group.WORLD.group_name
if op == "all_gather_into_tensor":
    out, want = F.all_gather_into_tensor(x, 4, gn), torch.arange(8.0).repeat(4) + torch.arange(4.0).repeat_interleave(8)
elif op == "reduce_scatter_tensor":
    out, want = F.reduce_scatter_tensor(x, "sum", 4, gn), (4 * torch.arange(8.0) + 6)[2 * int(rank): 2 * int(rank) + 2]
elif op == "all_reduce":
    out, want = F.all_reduce(x, "sum", gn), 4 * torch.arange(8.0) + 6
else:
    out = F.all_to_all_single(x, [2] * 4, [2] * 4, gn)
    want = torch.cat([torch.arange(8.0)[2 * int(rank): 2 * int(rank) + 2] + r for r in range(4)])
out = F.wait_tensor(out)
assert torch.equal(out.cpu(), want), (out, want)
dist.destroy_process_group()
'''


def _probe_collectives() -> dict:
    """Each functional collective on CUDA tensors over its own 4-rank gloo
    world, as DTensor issues it and routed through the c10d call
    (``sharding.gloo_cuda``): "ok", or how the ranks ended."""
    work = MESH_DIR / "probe"
    work.mkdir(parents=True, exist_ok=True)
    runs = {}
    for op in gloo_cuda.ROUTED:
        for route in ("0", "1"):
            store = work / f"{op}.{route}.store"
            store.unlink(missing_ok=True)
            runs[op, route] = [subprocess.Popen(
                [sys.executable, "-c", MESH_PROBE, str(r), str(store), op, route,
                 str(ROOT / "src")], stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
                for r in range(MESH_WORLD)]
    out = {}
    for (op, route), procs in runs.items():
        codes = []
        for p in procs:
            try:
                p.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                p.communicate()
            codes.append(p.returncode)
        verdict = ("ok" if codes == [0] * MESH_WORLD else
                   f"signal {-min(codes)}" if min(codes) < 0 else f"exit codes {codes}")
        out.setdefault(op, {})["routed" if route == "1" else "functional"] = verdict
    return out


def _mesh_tokens() -> SyntheticTokens:
    """The run's data: the train phase's loop seed."""
    return SyntheticTokens(get_config(LM_ARCH).vocab_size, seq_len=MESH_LOOP["seq_len"],
                           global_batch=MESH_LOOP["global_batch"], seed=0)


def _mesh_one_step(cfg, model, opt, mesh, step: int) -> float:
    """One training step at ``step`` of the run's data on ``mesh``; its loss."""
    step_fn, _ = make_train_step(cfg, total_steps=MESH_LOOP["total_steps"], device=DEV)
    with on_mesh(cfg, mesh):
        _, _, m = step_fn(model, opt, shard_batch(cfg, _mesh_tokens().batch_at(step), mesh, DEV))
    return float(m["loss"].full_tensor())


def _union_ms(spans) -> float:
    """The length of the union of ``(start, end)`` spans in µs, in ms."""
    total, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def _mesh_step_profile(cfg, model, opt, mesh) -> dict:
    """One more step of this rank under torch.profiler: its wall ms, the ms
    its kernels kept the card busy, and the ms its host spent in collectives
    (the union of the ``MESH_COLLECTIVE_SPANS`` spans on every thread)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        _mesh_one_step(cfg, model, opt, mesh, MESH_LOOP["total_steps"] + 1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    kernels = [e.time_range for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    coll = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
            and e.name.startswith(MESH_COLLECTIVE_SPANS)]
    return {"wall_ms": wall_ms, "kernels": len(kernels),
            "card_busy_ms": _union_ms((r.start, r.end) for r in kernels),
            "collective_ms": _union_ms((e.time_range.start, e.time_range.end) for e in coll)}


def _mesh_saved(step: int) -> dict:
    """The checkpoint's arrays by path, read with numpy alone."""
    src = MESH_DIR / "ckpt" / f"step_{step:09d}"
    manifest = json.loads((src / "manifest.json").read_text())
    return {m["path"]: np.load(src / "arrays" / f"{m['idx']}.npy") for m in manifest["leaves"]}


def _mesh_bit_equal(state, saved: dict) -> int:
    """How many leaves of ``state`` (DTensors, gathered) differ from the saved
    arrays; 0 when every one is bit for bit the saved array."""
    got = dict(train_ckpt._flatten_with_paths(state))
    require(set(got) == set(saved), "restored paths != saved paths")
    bad = 0
    for path, arr in saved.items():
        leaf = got[path].full_tensor() if hasattr(got[path], "full_tensor") else got[path]
        t = leaf.detach().cpu()
        raw = t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 else t.numpy()
        bad += int(raw.dtype != arr.dtype or not np.array_equal(raw, arr))
    return bad


def _mesh_f32_parity(cfg, mesh) -> dict:
    """(b) Float32 on the mesh against one process on the card: the loss,
    every gradient, one AdamW step."""
    cfg32 = _f32(cfg)
    b, t = MESH_CHECK
    api = build_model(cfg32, device=DEV)
    ref = api.init(torch.Generator(DEV).manual_seed(2))
    batch = SyntheticTokens(cfg.vocab_size, seq_len=t, global_batch=b, seed=3).batch_at(0)
    want_loss, want = _grads(api, ref, batch)
    want = {n: g.cpu() for n, g in want.items()}
    model = shard_params(cfg32, _copy_model(cfg32, ref, DEV), mesh)
    with on_mesh(cfg32, mesh):
        loss, _ = api.loss(model, shard_batch(cfg32, batch, mesh, DEV))
        loss.backward()
    got_loss = float(loss.detach().full_tensor())
    got = {n: p.grad.full_tensor().cpu() for n, p in model.named_parameters()
           if p.grad is not None}
    require(set(got) == set(want), "mesh and one process differ in which parameters have grads")
    loss_err = abs(got_loss - want_loss)
    require(math.isfinite(got_loss) and loss_err <= TRAIN_LOSS_RTOL * abs(want_loss),
            f"mesh float32 loss {got_loss} vs one process {want_loss}")
    grad_ratio, tols = _grad_gaps(got, want)
    require(grad_ratio <= 1.0, f"mesh float32 gradients: {grad_ratio} x the tolerance")
    ocfg, oinit, _ = make_optimizer("adamw", total_steps=MESH_LOOP["total_steps"])
    _, _, om = adamw_update(ocfg, None, adamw_init(ref), ref)
    opt = reshard_tree(oinit(model), state_shardings(cfg32, oinit, mesh)["opt"])
    with on_mesh(cfg32, mesh):
        adamw_update(ocfg, None, opt, model)
    lr = float(om["lr"])
    strict_err, loose_err, loose = _adamw_gaps(
        {n: p.detach().full_tensor().cpu() for n, p in model.named_parameters()},
        {n: p.detach().cpu() for n, p in ref.named_parameters()}, want, tols, lr)
    return {"shape": [b, t], "loss_one_process": want_loss, "loss_mesh": got_loss,
            "loss_abs_err": loss_err, "grad_err_over_tol": grad_ratio, "step_lr": lr,
            "param_max_abs_err": strict_err, "small_grad_param_max_abs_err": loose_err,
            "small_grad_params_apart": loose}


def _mesh_elastic(cfg) -> dict:
    """(c) The step-2 checkpoint onto (4, 1) and (1, 4): bit for bit, then
    one further step on each."""
    saved_at = train_ckpt.latest_step(MESH_DIR / "ckpt")
    saved = _mesh_saved(saved_at)
    oinit = make_optimizer(cfg.optimizer)[1]
    s1, s2 = MESH_ELASTIC
    mesh1 = make_compat_mesh(s1, ("data", "model"))
    mesh2 = make_compat_mesh(s2, ("data", "model"))
    _, state1 = train_ckpt.restore(MESH_DIR / "ckpt", saved_at,
                                   shardings=state_shardings(cfg, oinit, mesh1))
    state2 = reshard_tree(state1, state_shardings(cfg, oinit, mesh2))
    out = {"from_step": saved_at,
           "leaves": len(saved),
           f"{s1}_leaves_differing": _mesh_bit_equal(state1, saved),
           f"{s2}_leaves_differing": _mesh_bit_equal(state2, saved)}
    del state1
    # One further step: on s1 through train(mesh=), which resumes from the
    # checkpoint by restore(shardings=); on s2 from the re-placed state.
    hist: list[dict] = []
    train(cfg, TrainLoopConfig(**{**MESH_LOOP, "total_steps": saved_at + 2},
                               ckpt_dir=str(MESH_DIR / "ckpt")),
          mesh=mesh1, device=DEV, log_fn=lambda s, m: hist.append({"step": s, **m}))
    require([h["step"] for h in hist] == [saved_at + 1], f"{s1} resumed at {hist}")
    out[f"{s1}_loss"] = hist[0]["loss"]
    model = shard_params(cfg, model_module(cfg, device=DEV), mesh2)
    load_reference_tree(model, state2["params"])
    out[f"{s2}_loss"] = _mesh_one_step(cfg, model, state2["opt"], mesh2, saved_at + 1)
    out[f"{s2}_local_tokens"] = list(shard_batch(cfg, _mesh_tokens().batch_at(0), mesh2, DEV)
                                     ["tokens"].to_local().shape)
    return out


def _mesh_archs(mesh) -> dict:
    """(f) Each of MESH_ARCHS reduced in float32: loss and gradients on the
    mesh against one process on the card; a step with grad_accum 2."""
    b, t = MESH_ARCH_BATCH
    out = {}
    for arch, layout in MESH_ARCHS:
        cfg = dataclasses.replace(get_config(arch).reduced(), attn_layout=layout)
        api = build_model(cfg, device=DEV)
        ref = api.init(torch.Generator(DEV).manual_seed(7))
        batch = SyntheticTokens(cfg.vocab_size, seq_len=t, global_batch=b, seed=8).batch_at(0)
        if cfg.embeds_input:
            batch["enc_embeds" if cfg.is_encoder_decoder else "embeds"] = torch.randn(
                b, t, cfg.d_model, generator=torch.Generator(DEV).manual_seed(9), device=DEV)
        want_loss, want = _grads(api, ref, batch)
        want = {n: g.cpu() for n, g in want.items()}
        model = shard_params(cfg, _copy_model(cfg, ref, DEV), mesh)
        with on_mesh(cfg, mesh):
            loss, _ = api.loss(model, shard_batch(cfg, batch, mesh, DEV))
            loss.backward()
        got_loss = float(loss.detach().full_tensor())
        got = {n: p.grad.full_tensor().cpu() for n, p in model.named_parameters()
               if p.grad is not None}
        require(set(got) == set(want), f"{arch}: mesh and one process differ in gradients")
        ratio, _ = _grad_gaps(got, want)
        out[f"{arch}/{layout}"] = {"loss_rel_err": abs(got_loss - want_loss) / abs(want_loss),
                                   "grad_err_over_tol": ratio}
    hist = train(get_config(LM_ARCH).reduced(), MESH_ACCUM, mesh=mesh, device=DEV)["history"]
    out["grad_accum_2"] = {"loss": hist[0]["loss"]}
    return out


def _mesh_rank(rank: int) -> None:
    """One gloo rank of the mesh phase (the target of
    ``torch.multiprocessing.spawn``); writes ``rank<r>.json``."""
    torch.cuda.set_device(DEV)
    dist.init_process_group("gloo", init_method=f"file://{MESH_DIR / 'gloo.store'}", rank=rank,
                            world_size=MESH_WORLD, timeout=timedelta(seconds=MESH_TIMEOUT_S))
    try:
        (MESH_DIR / f"rank{rank}.json").write_text(json.dumps(_mesh_rank_run(rank)))
    finally:
        dist.destroy_process_group()


def _mesh_rank_run(rank: int) -> dict:
    cfg = get_config(LM_ARCH)
    mesh = make_compat_mesh(MESH_SHAPE, ("data", "model"))
    reset_launches()
    out = {"rank": rank, "coord": list(mesh.get_coordinate())}
    # (a) The run: train(mesh=), a checkpoint at step 2; then the collectives
    # of one step (a fifth step, after the run's four).
    res, run = train_counted(cfg, TrainLoopConfig(ckpt_dir=str(MESH_DIR / "ckpt"), **MESH_LOOP),
                             mesh, DEV)
    out.update({k: run[k] for k in ("peak_gb", "losses", "step_ms", "grad_norms",
                                    "counted_step_ms", "collectives")})
    model, opt = res["params"], res["opt"]
    tokens = shard_batch(cfg, _mesh_tokens().batch_at(0), mesh, DEV)["tokens"]
    embed = model.embeddings.embed
    out["local_shapes"] = {
        "embeddings/embed": [list(embed.shape), list(embed.to_local().shape),
                             [str(p) for p in embed.placements]],
        "tokens": [list(tokens.shape), list(tokens.to_local().shape),
                   [str(p) for p in tokens.placements]]}
    # Where a step's time goes (a sixth step, profiled on every rank).
    out["profile"] = _mesh_step_profile(cfg, model, opt, mesh)
    del model, opt, res, embed, tokens
    torch.cuda.empty_cache()
    out["f32_parity"] = _mesh_f32_parity(cfg, mesh)
    out["elastic"] = _mesh_elastic(cfg)
    out["archs"] = _mesh_archs(mesh)
    out["launches"] = launches()
    return out


def _b4_cfg(arch: str):
    return dataclasses.replace(get_config(arch), compute_dtype="float32",
                               param_dtype="float32", **B4_ARCHS[arch])


def _b4_batch(cfg, b: int, t: int) -> dict:
    return SyntheticTokens(cfg.vocab_size, seq_len=t, global_batch=b, seed=3).batch_at(0)


def _gathered(tensors: dict, keep: bool) -> dict | None:
    """Each DTensor gathered (every rank takes part) and moved to the host
    where ``keep``, one at a time: a full-width layer's whole tensors do not
    fit the card four times over."""
    out = {}
    for n, t in tensors.items():
        whole = t.full_tensor()
        if keep:
            out[n] = whole.cpu()
        del whole
    return out if keep else None


def _own_shards(model: torch.nn.Module) -> torch.nn.Module:
    """Each DTensor parameter on a copy of its local shard: a shard that is a
    view of the whole initial tensor would keep all of it alive."""
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        model.get_submodule(owner)._parameters[leaf] = torch.nn.Parameter(
            DTensor.from_local(p.detach().to_local().clone(), p.device_mesh, p.placements,
                               run_check=False), requires_grad=p.requires_grad)
    return model


def _sharded_zeros(tree, shardings):
    """A tree of zeros placed by ``shardings``, made shard by shard (the
    optimizer's state of a full-width layer, without its whole tensors)."""
    if isinstance(tree, dict):
        return {k: _sharded_zeros(v, shardings[k]) for k, v in tree.items()}
    return dtensor_zeros(tuple(tree.shape), dtype=tree.dtype, device_mesh=shardings.mesh,
                         placements=shardings.placements)


def _b4_mesh_step(cfg, mesh, b: int, t: int, keep: bool):
    """(g) The loss, every gradient and one AdamW step of ``cfg`` on the mesh
    from the seeded weights; on the host where ``keep``."""
    api = build_model(cfg, device=DEV)
    model = _own_shards(shard_params(cfg, api.init(torch.Generator(DEV).manual_seed(2)), mesh))
    torch.cuda.empty_cache()
    with on_mesh(cfg, mesh):
        loss, _ = api.loss(model, shard_batch(cfg, _b4_batch(cfg, b, t), mesh, DEV))
        loss.backward()
    torch.cuda.empty_cache()
    out = {"loss": float(loss.detach().full_tensor()),
           "grads": _gathered({n: p.grad for n, p in model.named_parameters()}, keep)}
    ocfg, oinit, _ = make_optimizer("adamw", total_steps=MESH_LOOP["total_steps"])
    opt = _sharded_zeros(oinit(model_module(cfg, device="meta")),
                         state_shardings(cfg, oinit, mesh)["opt"])
    with on_mesh(cfg, mesh):
        adamw_update(ocfg, None, opt, model)
    out["params"] = _gathered({n: p.detach() for n, p in model.named_parameters()}, keep)
    return out


def _b4_compare(cfg, got: dict, b: int, t: int) -> dict:
    """(g) One process on the card from the same weights, held against the
    mesh's ``got`` (compared on the card: the other ranks hold nothing)."""
    api = build_model(cfg, device=DEV)
    ref = api.init(torch.Generator(DEV).manual_seed(2))
    want_loss, want = _grads(api, ref, _b4_batch(cfg, b, t))
    for n, p in ref.named_parameters():   # the step reads the copies: one set in memory
        p.grad = want[n]
    ocfg, _, _ = make_optimizer("adamw", total_steps=MESH_LOOP["total_steps"])
    _, _, om = adamw_update(ocfg, None, adamw_init(ref), ref)
    lr = float(om["lr"])
    require(set(got["grads"]) == set(want), f"{cfg.name}: mesh and one process differ in grads")
    grad_ratio, tols = _grad_gaps(got["grads"], want)
    strict_err, loose_err, loose = _adamw_gaps(
        {n: q.to(DEV) for n, q in got["params"].items()},
        {n: p.detach() for n, p in ref.named_parameters()}, want, tols, lr)
    return {"shape": [b, t], "layers": cfg.num_layers, "params": param_count(ref),
            "loss_one_process": want_loss, "loss_mesh": got["loss"],
            "loss_abs_err": abs(got["loss"] - want_loss), "grad_err_over_tol": grad_ratio,
            "step_lr": lr, "param_max_abs_err": strict_err,
            "small_grad_param_max_abs_err": loose_err, "small_grad_params_apart": loose}


def _b4_rank(rank: int) -> None:
    """One gloo rank of (g) (the target of ``torch.multiprocessing.spawn``):
    each parity case on the mesh, then one process on rank 0 while the others
    wait; then the steps of each arch. Rank 0 writes ``b4.json``: the parity
    cases, the steps (each rank's peak) and each rank's kernel launches."""
    torch.cuda.set_device(DEV)
    dist.init_process_group("gloo", init_method=f"file://{MESH_DIR / 'b4.store'}", rank=rank,
                            world_size=MESH_WORLD, timeout=timedelta(seconds=MESH_TIMEOUT_S))
    try:
        reset_launches()
        mesh = make_compat_mesh(MESH_SHAPE, ("data", "model"))
        out = {}
        for arch, (b, t) in MESH_B4_CHECK:
            cfg = _b4_cfg(arch)
            t0 = time.perf_counter()
            got = _b4_mesh_step(cfg, mesh, b, t, keep=rank == 0)
            torch.cuda.empty_cache()
            dist.barrier()
            if rank == 0:
                t1 = time.perf_counter()
                out[f"{arch}/{b}x{t}"] = {**_b4_compare(cfg, got, b, t), "mesh_s": t1 - t0,
                                          "one_process_s": time.perf_counter() - t1}
                del got
                torch.cuda.empty_cache()
            dist.barrier()
        steps = {}
        for arch in B4_ARCHS:
            cfg = dataclasses.replace(get_config(arch), grad_accum=MESH_B4_STEPS.grad_accum,
                                      **B4_ARCHS[arch])
            t0 = time.perf_counter()
            res, run = train_counted(cfg, MESH_B4_STEPS, mesh, DEV)
            run["params"] = param_count(res["params"])
            del res
            torch.cuda.empty_cache()
            peaks = [None] * MESH_WORLD
            dist.all_gather_object(peaks, run.pop("peak_gb"))
            steps[arch] = {**run, "peak_gb_per_rank": peaks, "seconds": time.perf_counter() - t0}
        runs = [None] * MESH_WORLD
        dist.all_gather_object(runs, launches())
        if rank == 0:
            (MESH_DIR / "b4.json").write_text(json.dumps(
                {"parity": out, "steps": steps, "launches_per_rank": runs}))
    finally:
        dist.destroy_process_group()


def _mesh_nccl_one_rank(cfg) -> dict:
    """(d) The run's first step on a 1-rank NCCL world with a (1, 1) mesh."""
    dist.init_process_group("nccl", init_method=f"file://{MESH_DIR / 'nccl.store'}",
                            rank=0, world_size=1, timeout=timedelta(seconds=MESH_TIMEOUT_S))
    try:
        require(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
        mesh = make_compat_mesh((1, 1), ("data", "model"))
        hist: list[dict] = []
        train(cfg, TrainLoopConfig(**{**MESH_LOOP, "total_steps": 1}), mesh=mesh, device=DEV,
              log_fn=lambda s, m: hist.append(m))
    finally:
        dist.destroy_process_group()
    return {"loss": hist[0]["loss"], "step_ms": hist[0]["step_time_s"] * 1e3}


def phase_mesh() -> dict:
    """The LM sharded on a device mesh (see the module docstring, phase 17)."""
    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    require(cfg.remat and cfg.optimizer == "adamw" and cfg.compute_dtype == "bfloat16"
            and cfg.param_dtype == "float32", f"{cfg.name}: not the published training setup")
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    MESH_DIR.mkdir(parents=True)
    reset_launches()

    probe = _probe_collectives()
    probe_line = {"phase": "mesh", "what": "probe", "world": MESH_WORLD, "backend": "gloo",
                  "tensors": DEV.type, "collectives": probe,
                  "routed_through_c10d": list(gloo_cuda.ROUTED)}
    emit(probe_line)
    require(all(v["routed"] == "ok" for v in probe.values()),
            f"a routed collective fails over gloo: {probe}")

    # One process on the card: the run's losses, then the resume below.
    hist: list[dict] = []
    train(cfg, TrainLoopConfig(**MESH_LOOP), device=DEV,
          log_fn=lambda s, m: hist.append({"step": s, **m}))
    want = [h["loss"] for h in hist]
    torch.cuda.empty_cache()  # the ranks share the card

    t0 = time.perf_counter()
    torch.multiprocessing.spawn(_mesh_rank, nprocs=MESH_WORLD, join=True)
    spawn_s = time.perf_counter() - t0
    ranks = [json.loads((MESH_DIR / f"rank{r}.json").read_text()) for r in range(MESH_WORLD)]

    # (a) The run: its line first, then its checks.
    got = ranks[0]["losses"]
    loss_rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    step_ms = [r["step_ms"][1:] for r in ranks]
    med = float(np.median(step_ms[0]))
    tokens = MESH_LOOP["global_batch"] * MESH_LOOP["seq_len"]
    shapes = ranks[0]["local_shapes"]
    b, t = MESH_LOOP["global_batch"], MESH_LOOP["seq_len"]
    profiles = [r["profile"] for r in ranks]
    run = {"arch": cfg.name, "mesh": list(MESH_SHAPE), "axes": ["data", "model"],
           "loop": MESH_LOOP, "losses": got, "losses_one_process": want,
           "loss_rel_err": loss_rel, "loss_rtol": MESH_LOSS_RTOL,
           "first_step_ms": ranks[0]["step_ms"][0],
           "step_ms": step_ms[0], "median_step_ms": med, "tokens_per_s": tokens / (med / 1e3),
           "one_process_median_step_ms": float(np.median([h["step_time_s"] * 1e3
                                                           for h in hist[1:]])),
           "peak_gb_per_rank": [r["peak_gb"] for r in ranks],
           "collectives_of_one_step": ranks[0]["collectives"],
           "counted_step_ms": ranks[0]["counted_step_ms"],
           "profiled_step": {
               "per_rank": profiles,
               "card_busy_ms_all_ranks": sum(p["card_busy_ms"] for p in profiles),
               "collective_share_per_rank": [p["collective_ms"] / p["wall_ms"]
                                             for p in profiles]},
           "local_shapes": {"rank0": shapes, "coords": [r["coord"] for r in ranks]},
           "spawn_s": spawn_s}
    emit({"phase": "mesh", "what": "run", **run})
    for r in ranks:
        require(r["losses"] == got, f"rank {r['rank']}: losses differ from rank 0")
        require(r["launches"] == {k: 0 for k in r["launches"]},
                f"rank {r['rank']} launched a kernel of csrc: {r['launches']}")
    require(len(got) == len(want) and all(map(math.isfinite, got)), f"mesh losses {got}")
    require(max(loss_rel) <= MESH_LOSS_RTOL,
            f"mesh losses {got} vs one process {want}: {max(loss_rel)} > {MESH_LOSS_RTOL}")
    require(shapes["tokens"][1] == [b // MESH_SHAPE[0], t // MESH_SHAPE[1]],
            f"local batch {shapes['tokens']}")
    require(shapes["embeddings/embed"][1] == [cfg.padded_vocab // MESH_SHAPE[1], cfg.d_model],
            f"local embedding {shapes['embeddings/embed']}")

    # (b) Float32 parity (checked in every rank).
    emit({"phase": "mesh", "what": "f32_parity", **ranks[0]["f32_parity"]})

    # (c) Elastic re-meshing: the ranks' two meshes, then one process.
    el = ranks[0]["elastic"]
    for r in ranks:
        require(r["elastic"] == el, f"rank {r['rank']}: elastic results differ from rank 0")
    s1, s2 = (str(s) for s in MESH_ELASTIC)
    require(el[f"{s1}_leaves_differing"] == 0 and el[f"{s2}_leaves_differing"] == 0,
            f"re-meshed checkpoint differs: {el}")
    step_loss = got[el["from_step"] + 1]
    saved = _mesh_saved(el["from_step"])
    _, back = train_ckpt.restore(MESH_DIR / "ckpt", el["from_step"], device=DEV)
    el["one_process_leaves_differing"] = _mesh_bit_equal(back, saved)
    del back, saved
    rhist: list[dict] = []
    train(cfg, TrainLoopConfig(**{**MESH_LOOP, "total_steps": el["from_step"] + 2},
                               ckpt_dir=str(MESH_DIR / "ckpt")),
          device=DEV, log_fn=lambda s, m: rhist.append({"step": s, **m}))
    el["one_process_loss"] = rhist[0]["loss"]
    el["mesh_loss_at_step"] = step_loss
    for k in (f"{s1}_loss", f"{s2}_loss", "one_process_loss"):
        require(abs(el[k] - step_loss) <= MESH_LOSS_RTOL * abs(step_loss),
                f"elastic {k} {el[k]} vs the run's {step_loss}")
    require(el["one_process_leaves_differing"] == 0, "one-process restore differs from saved")
    emit({"phase": "mesh", "what": "elastic", **el})
    torch.cuda.empty_cache()

    # (f) The other archs.
    archs = ranks[0]["archs"]
    accum = archs.pop("grad_accum_2")
    accum["one_process_loss"] = train(get_config(LM_ARCH).reduced(), MESH_ACCUM,
                                      device=DEV)["history"][0]["loss"]
    require(abs(accum["loss"] - accum["one_process_loss"])
            <= MESH_LOSS_RTOL * abs(accum["one_process_loss"]),
            f"grad_accum 2 on the mesh against one process: {accum}")
    for name, res in archs.items():
        require(res["loss_rel_err"] <= TRAIN_LOSS_RTOL and res["grad_err_over_tol"] <= 1.0,
                f"{name} on the mesh against one process: {res}")
    emit({"phase": "mesh", "what": "archs", "shape": list(MESH_ARCH_BATCH), **archs,
          "grad_accum_2": accum})

    # (d) A 1-rank NCCL world.
    nccl = _mesh_nccl_one_rank(cfg)
    require(abs(nccl["loss"] - want[0]) <= MESH_LOSS_RTOL * abs(want[0]),
            f"NCCL (1, 1) loss {nccl['loss']} vs one process {want[0]}")
    emit({"phase": "mesh", "what": "nccl_one_rank", "mesh": [1, 1], **nccl})

    # (g) Row B4: the MoE layer and the mixer sharded over "model".
    torch.cuda.empty_cache()
    torch.multiprocessing.spawn(_b4_rank, nprocs=MESH_WORLD, join=True)
    b4 = json.loads((MESH_DIR / "b4.json").read_text())
    for name, res in b4["parity"].items():
        emit({"phase": "mesh", "what": "b4_parity", "case": name, "card": _smi(), **res})
        require(math.isfinite(res["loss_mesh"])
                and res["loss_abs_err"] <= TRAIN_LOSS_RTOL * abs(res["loss_one_process"]),
                f"{name} on the mesh: loss {res['loss_mesh']} vs {res['loss_one_process']}")
        require(res["grad_err_over_tol"] <= 1.0, f"{name} gradients: {res['grad_err_over_tol']} "
                "x the tolerance")
        require(res["param_max_abs_err"] <= TRAIN_PARAM_ATOL
                and res["small_grad_param_max_abs_err"] <= 2 * res["step_lr"] + TRAIN_PARAM_ATOL,
                f"{name}: the AdamW step on the mesh differs: {res}")
    require(len(b4["parity"]) == len(MESH_B4_CHECK), f"B4 cases {sorted(b4['parity'])}")
    loop = MESH_B4_STEPS
    for arch, st in b4["steps"].items():
        med = statistics.median(st["step_ms"][1:])
        emit({"phase": "mesh", "what": "b4_steps", "card": _smi(), "arch": arch,
              "cuts": B4_ARCHS[arch], "mesh": list(MESH_SHAPE), "batch": loop.global_batch,
              "seq": loop.seq_len, "steps": loop.total_steps, "grad_accum": loop.grad_accum,
              "median_step_ms": med, "tokens_per_s": loop.global_batch * loop.seq_len / (med / 1e3),
              **st})
        require(all(map(math.isfinite, st["losses"])), f"{arch} steps: losses {st['losses']}")
    require(sorted(b4["steps"]) == sorted(B4_ARCHS), f"B4 steps for {sorted(b4['steps'])}")

    # (e) No kernel of csrc on this path: this process's, (g)'s ranks'.
    runs = launches()
    require(runs == {k: 0 for k in runs}, f"the mesh phase launched a kernel of csrc: {runs}")
    require(all(r == runs for r in b4["launches_per_rank"]),
            f"(g)'s ranks launched a kernel of csrc: {b4['launches_per_rank']}")
    out = {"launches": runs, "rank_launches": [r["launches"] for r in ranks],
           "b4_rank_launches": b4["launches_per_rank"], "seconds": time.perf_counter() - t_phase}
    emit({"phase": "mesh", **out})
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    return {**run, **out}


# ---------------------------------------------------------------------------
# 18. dryrun: the dry run on a fake world, and its count held to a real run
# ---------------------------------------------------------------------------

DRYRUN_RUNS = (("--arch", "smollm-135m", "--mesh", "single"),
               ("--arch", "mixtral-8x7b", "--shape", "train_4k", "--mesh", "single"),
               ("--arch", "mamba2-130m", "--shape", "train_4k", "--mesh", "single"))
# Row B4: the flops a rank counts of the cells whose MoE layer or mixer the
# 16 "model" ranks no longer repeat (9.587e15 and 5.478e13 when they did).
DRYRUN_B4_FLOPS = {"mixtral-8x7b×train_4k": 2.4e15, "mamba2-130m×train_4k": 1.37e13}
DRYRUN_REPORTS = ROOT / "reports" / "dryrun_torch"
DRYRUN_TIMEOUT_S = 600
CALIB_ARCH = "smollm-135m"
CALIB_CELLS = (ShapeCell("calib_train", "train", 2048, 8),
               ShapeCell("calib_decode", "decode", 4096, 64))
CALIB_DIR = ROOT / "build" / "calib"
CALIB_REPS = 3
# The predicted peak (launch.cost's live storages) against the caching
# allocator's max_memory_allocated of the same program: the allocator rounds
# every block up and keeps workspaces (cuBLAS's) the count does not see; the
# memory the process held beyond the arguments before the run is added to
# the prediction. The readings this limit was set from (PERF.md §6, PR 23):
# train -0.18 %, decode -0.00001 %.
CALIB_PEAK_RTOL = 0.02


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def _dryrun_children() -> dict:
    """(a) The dry run's two commands, run at once, each in its own process
    (its own fake world); their reports' rows."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    shutil.rmtree(DRYRUN_REPORTS, ignore_errors=True)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", *argv],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for argv in DRYRUN_RUNS]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DRYRUN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    for argv, p, text in zip(DRYRUN_RUNS, procs, outs):
        if p.returncode != 0:
            print(text[-6000:], file=sys.stderr, flush=True)
        require(p.returncode == 0, f"dryrun {' '.join(argv)} exited {p.returncode}")
    rows = [json.loads(f.read_text()) for f in sorted(DRYRUN_REPORTS.glob("*.json"))]
    return {"rows": rows, "seconds": seconds,
            "tables": [t[t.index("=== ROOFLINE TABLE ==="):] for t in outs]}


def _calib_values(cfg, cell, api):
    """Real global arguments for the calibration cell: seeded weights,
    AdamW's fresh state and a seeded batch, or empty caches and tokens."""
    model = api.init(torch.Generator(DEV).manual_seed(0))
    if cell.kind == "train":
        batch = SyntheticTokens(cfg.vocab_size, seq_len=cell.seq_len,
                                global_batch=cell.global_batch, seed=0).batch_at(0)
        return (model, adamw_init(model), {k: torch.as_tensor(v) for k, v in batch.items()})
    g = torch.Generator().manual_seed(1)
    caches = api.init_caches(cell.global_batch, cell.seq_len)
    token = torch.randint(0, cfg.vocab_size, (cell.global_batch, 1), generator=g,
                          dtype=torch.int32)
    pos = torch.full((cell.global_batch,), cell.seq_len // 2, dtype=torch.int32)
    return (model, caches, token, pos)


def _calib_rank(rank: int) -> None:
    """(b) The calibration's 1-rank NCCL world (the target of
    ``torch.multiprocessing.spawn``); writes ``calib.json``."""
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.cost import measure
    from repro_torch.launch.steps import build_cell, lower_cell, place_args, run_program

    torch.cuda.set_device(DEV)
    dist.init_process_group("nccl", init_method=f"file://{CALIB_DIR / 'nccl.store'}", rank=0,
                            world_size=1, timeout=timedelta(seconds=MESH_TIMEOUT_S))
    out = {}
    try:
        require(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
        mesh = make_compat_mesh((1, 1), ("data", "model"))
        cfg = get_config(CALIB_ARCH)
        api = build_model(cfg, device=DEV)
        for cell in CALIB_CELLS:
            prog = build_cell(cfg, cell, mesh)
            before = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            fake = lower_cell(prog, mesh)
            fake_s = time.perf_counter() - t0
            require(torch.cuda.memory_allocated() == before, "lower_cell allocated on the card")
            placed = place_args(prog, _calib_values(cfg, cell, api))
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            real = measure(lambda *a: run_program(prog, mesh, a), *placed)[1]   # outputs freed
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()

            def step():
                run_program(prog, mesh, placed)
            ms = cuda_ms(step, CALIB_REPS)
            del step
            roof = rl.build_roofline(cfg, cell, "calib1x1", 1, fake)
            out[cell.name] = {
                "fake": dataclasses.asdict(fake), "real": dataclasses.asdict(real),
                "costs_equal": fake.costs() == real.costs(),
                "lower_s": fake_s, "held_bytes": held,
                "held_over_arguments": held - real.argument_bytes,
                "predicted_peak_bytes": fake.peak_bytes, "max_memory_allocated": peak,
                # What the process held beyond the arguments (the previous
                # cell's cuBLAS workspace) is live under the program too.
                "peak_rel_err": (fake.peak_bytes + held - real.argument_bytes - peak) / peak,
                "ms": ms, "t_compute_ms": roof.t_compute * 1e3,
                "t_memory_ms": roof.t_memory * 1e3,
                "t_collective_ms": roof.t_collective * 1e3,
                "model_flops": roof.model_flops,
                "share_of_bf16_peak": roof.model_flops / (ms / 1e3 * rl.PEAK_FLOPS),
                "counted_flops_share": fake.flops / (ms / 1e3 * rl.PEAK_FLOPS)}
            del placed, prog
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    (CALIB_DIR / "calib.json").write_text(json.dumps(out))


def phase_dryrun() -> dict:
    """The dry run (see the module docstring, phase 18)."""
    t_phase = time.perf_counter()
    smi = _smi()
    reset_launches()
    shutil.rmtree(CALIB_DIR, ignore_errors=True)
    CALIB_DIR.mkdir(parents=True)
    # (b) first, so its timings share the host with nothing else.
    t0 = time.perf_counter()
    torch.multiprocessing.spawn(_calib_rank, nprocs=1, join=True)
    calib_s = time.perf_counter() - t0
    calib = json.loads((CALIB_DIR / "calib.json").read_text())
    dry = _dryrun_children()

    cells = {}
    for r in dry["rows"]:
        cells[f"{r['arch']}×{r['shape']}"] = {
            k: r[k] for k in ("t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
                              "useful_ratio", "roofline_fraction", "hlo_flops", "hlo_bytes",
                              "coll_bytes", "model_flops", "fits_80gb_hbm", "probes", "run_s")}
        cells[f"{r['arch']}×{r['shape']}"]["peak_gb"] = r["memory"]["per_device_gb"]
        emit({"phase": "dryrun", "what": "cell", "cell": f"{r['arch']}×{r['shape']}",
              "mesh": r["mesh"], **cells[f"{r['arch']}×{r['shape']}"]})
    want = {"smollm-135m×train_4k", "smollm-135m×prefill_32k", "smollm-135m×decode_32k",
            *DRYRUN_B4_FLOPS}
    require(set(cells) == want, f"dry-run cells {sorted(cells)}")
    for name, c in cells.items():
        require(c["hlo_flops"] > 0 and c["model_flops"] > 0, f"{name}: no flops counted")
        require(c["fits_80gb_hbm"], f"{name}: {c['peak_gb']} GB a rank does not fit")
    emit({"phase": "dryrun", "what": "b4", "card": smi,
          **{name: {"flops_per_rank": cells[name]["hlo_flops"],
                    "coll_bytes_per_rank": cells[name]["coll_bytes"], "limit_flops": limit}
             for name, limit in DRYRUN_B4_FLOPS.items()}})
    for name, limit in DRYRUN_B4_FLOPS.items():
        require(cells[name]["hlo_flops"] <= limit,
                f"{name}: {cells[name]['hlo_flops']:.4g} flops a rank > {limit:.4g}")
    print("\n".join(dry["tables"]), flush=True)
    emit({"phase": "dryrun", "what": "dryrun_seconds", "seconds": dry["seconds"]})

    for name, c in calib.items():
        line = {k: v for k, v in c.items() if k not in ("fake", "real")}
        line.update({"flops": c["fake"]["flops"], "bytes": c["fake"]["bytes_accessed"],
                     "coll_bytes": c["fake"]["coll_bytes"],
                     "real_flops": c["real"]["flops"], "real_bytes": c["real"]["bytes_accessed"],
                     "real_coll_bytes": c["real"]["coll_bytes"],
                     "argument_bytes": c["fake"]["argument_bytes"],
                     "real_argument_bytes": c["real"]["argument_bytes"],
                     "real_peak_bytes": c["real"]["peak_bytes"]})
        emit({"phase": "dryrun", "what": "calibration", "cell": name, "arch": CALIB_ARCH,
              "card": smi, **line})
        require(c["costs_equal"], f"{name}: fake and real counts differ: {c['fake']} "
                f"vs {c['real']}")
        require(abs(c["peak_rel_err"]) <= CALIB_PEAK_RTOL,
                f"{name}: predicted peak {c['predicted_peak_bytes']} vs measured "
                f"{c['max_memory_allocated']} ({c['peak_rel_err']:+.3f})")
    runs = launches()
    require(runs == {k: 0 for k in runs}, f"the dryrun phase launched a kernel of csrc: {runs}")
    out = {"card": smi, "calib_seconds": calib_s, "dryrun_seconds": dry["seconds"],
           "share_of_bf16_peak": {k: c["share_of_bf16_peak"] for k, c in calib.items()},
           "launches": runs, "seconds": time.perf_counter() - t_phase}
    emit({"phase": "dryrun", **out})
    shutil.rmtree(CALIB_DIR, ignore_errors=True)
    return out


def _drop_tensors(*results: dict) -> None:
    """Free the tensors the phases' results hold; keep their numbers."""
    def holds_tensor(v):
        return torch.is_tensor(v) or (isinstance(v, tuple) and any(map(torch.is_tensor, v)))

    for res in results:
        for key in [k for k, v in res.items() if holds_tensor(v)]:
            del res[key]


def timed(name: str, fn, *args):
    """Run one phase and print its seconds on a line of their own."""
    t0 = time.perf_counter()
    result = fn(*args)
    emit({"phase_seconds": name, "seconds": time.perf_counter() - t0})
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this script needs an NVIDIA card",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    alone = {"lm": phase_lm, "train": phase_train, "mesh": phase_mesh, "dryrun": phase_dryrun,
             "mcc": phase_mcc_alone, "tail": phase_tail_alone}
    if len(sys.argv) == 2 and sys.argv[1] in alone:   # a phase alone
        timed("device", phase_device)
        timed(sys.argv[1], alone[sys.argv[1]])
        emit({"phase_seconds": "total", "seconds": time.perf_counter() - t_start})
        return 0
    # Every plan before the autotune phase is untuned: a store of this run's
    # own, empty until that phase.
    os.environ["REPRO_TORCH_AUTOTUNE_PATH"] = str(AUTOTUNE_PATH)
    AUTOTUNE_PATH.unlink(missing_ok=True)
    timed("device", phase_device)
    timed("build", phase_build)
    timed("kernel_check", phase_kernel_check)
    stack, big, vol = timed("inputs", make_inputs)
    main_run = timed("main_path", phase_main_path, stack, big, vol)
    chk = timed("checks", phase_checks, stack, big, main_run)
    tchk = timed("texture_checks", phase_texture_checks, stack, main_run)
    vchk = timed("volume_checks", phase_volume_checks, vol, main_run)
    t = timed("timing", phase_timing, stack, big, chk)
    t.update(timed("texture_timing", phase_texture_timing, stack, tchk))
    t.update(timed("volume_timing", phase_volume_timing, vol, vchk))
    mcc = timed("mcc", phase_mcc, stack[0], stack[4])
    ftail = timed("tail", phase_tail, stack[0], stack[4])
    for chk_out in (tchk, vchk):  # free the counts; keep the numbers
        chk_out.pop("counts")
    h = timed("histogram", phase_histogram, stack, big)
    t0 = time.perf_counter()
    video = texture_video(4096, VIDEO_FRAMES, change_at=VIDEO_CHANGE)
    frames = torch.from_numpy(video).to(DEV)
    emit({"phase_seconds": "video", "seconds": time.perf_counter() - t0})
    temporal = timed("temporal", phase_temporal, frames)
    ts = timed("texture_stream", phase_texture_stream, frames)
    del frames
    timed("pipeline", phase_pipeline, stack, main_run["feats"])
    timed("serve", phase_serve, stack, vol, video)
    timed("lint", phase_lint)
    timed("autotune", phase_autotune, stack, big)
    shapes = timed("distributed_inputs", _distributed_inputs, stack, big, vol)
    # The ranks share the card: free the parent's stacks first.
    _drop_tensors(main_run, chk, t)
    del stack, big, vol
    torch.cuda.empty_cache()
    sharded = timed("distributed", phase_distributed, shapes)["sharded_launches_per_rank"]
    timed("lm", phase_lm)
    timed("train", phase_train)
    timed("mesh", phase_mesh)
    timed("dryrun", phase_dryrun)
    emit({"phase_seconds": "total", "seconds": time.perf_counter() - t_start})
    runs = {name: main_run[f"{path}_launches"][name] for path, name in (
        ("features", "glcm_fused"), ("texture", "glcm_window"))}
    runs["glcm_vote"] = sum(main_run[f"{p}_launches"]["glcm_vote"] for p in ("glcm", "tiles"))
    runs["glcm_volume"] = sum(main_run[f"{p}_launches"]["glcm_volume"]
                              for p in ("volume", "volume_glcm"))
    runs["histogram"] = sum(h[f"histogram_{p}_launches"]["histogram"] for p in ("big", "stack4"))
    kernels = [
        {"name": "glcm_vote", "route": "cuda", "source": "src/repro_torch/csrc/glcm_vote.cu",
         "replaces": "src/repro/kernels/glcm_kernel.py:151",
         "launches": runs["glcm_vote"],
         "max_abs_err": chk["vote_max_abs_err"], "ms": t["vote_ms"],
         "plain_ms": t["vote_plain_ms"], "bound_ms": t["vote_bound_ms"],
         "bound_by": t["vote_bound_by"], "library_ms": t["vote_library_ms"]},
        {"name": "glcm_fused", "route": "cuda", "source": "src/repro_torch/csrc/glcm_fused.cu",
         "replaces": "src/repro/kernels/glcm_kernel.py:539",
         "launches": runs["glcm_fused"],
         "sharded_launches_per_rank": sharded["glcm_fused"],
         "max_abs_err": chk["fused_max_abs_err"], "ms": t["fused_ms"],
         "plain_ms": t["fused_plain_ms"], "bound_ms": t["fused_bound_ms"],
         "bound_by": t["fused_bound_by"], "library_ms": None},
        # The same kernel on uint8 input (read as it is): the temporal
        # stream's frames, one launch a frame.
        {"name": "glcm_fused_uint8", "route": "cuda",
         "source": "src/repro_torch/csrc/glcm_fused.cu",
         "replaces": "src/repro/kernels/glcm_kernel.py:539",
         "launches": temporal["stream_features_launches"]["glcm_fused"],
         "max_abs_err": t["fused_uint8_max_abs_err"], "ms": t["fused_uint8_ms"],
         "plain_ms": t["fused_uint8_plain_ms"], "bound_ms": t["fused_uint8_bound_ms"],
         "bound_by": t["fused_uint8_bound_by"], "library_ms": None},
        {"name": "glcm_window", "route": "cuda",
         "source": "src/repro_torch/csrc/glcm_window.cu",
         "replaces": "src/repro/kernels/glcm_kernel.py:299",
         "launches": runs["glcm_window"],
         "sharded_launches_per_rank": sharded["glcm_window"],
         "max_abs_err": tchk["window_max_abs_err"], "ms": t["window_ms"],
         "plain_ms": t["window_plain_ms"], "bound_ms": t["window_bound_ms"],
         "bound_by": t["window_bound_by"], "library_ms": t["window_library_ms"]},
        # The same kernel on uint8 input (read as it is): the texture stream's
        # frames; its library call is torch.bincount of the same index.
        {"name": "glcm_window_uint8", "route": "cuda",
         "source": "src/repro_torch/csrc/glcm_window.cu",
         "replaces": "src/repro/kernels/glcm_kernel.py:299",
         "launches": ts["texture_stream_launches"]["glcm_window"],
         "max_abs_err": t["window_uint8_max_abs_err"], "ms": t["window_uint8_ms"],
         "plain_ms": t["window_uint8_plain_ms"], "bound_ms": t["window_uint8_bound_ms"],
         "bound_by": t["window_uint8_bound_by"], "library_ms": t["window_library_ms"]},
        {"name": "glcm_volume", "route": "cuda",
         "source": "src/repro_torch/csrc/glcm_volume.cu",
         "replaces": "src/repro/kernels/glcm_kernel.py:440",
         "launches": runs["glcm_volume"],
         "sharded_launches_per_rank": sharded["glcm_volume"],
         "max_abs_err": vchk["volume_max_abs_err"], "ms": t["volume_ms"],
         "plain_ms": t["volume_plain_ms"], "bound_ms": t["volume_bound_ms"],
         "bound_by": t["volume_bound_by"], "library_ms": t["volume_library_ms"]},
        {"name": "histogram", "route": "cuda", "source": "src/repro_torch/csrc/histogram.cu",
         "replaces": "src/repro/kernels/histogram_kernel.py:37",
         "launches": runs["histogram"],
         "max_abs_err": max(h["histogram_big_max_abs_err"], h["histogram_stack4_max_abs_err"]),
         "ms": h["histogram_big_ms"], "plain_ms": h["histogram_big_plain_ms"],
         "bound_ms": h["histogram_big_bound_ms"], "bound_by": h["histogram_big_bound_by"],
         "library_ms": h["histogram_big_library_ms"]},
        # f14's eigensolver on the texture map's 260 100 matrices (smooth);
        # its library call is the chunked eigvalsh it replaces.
        {"name": "second_eigenvalue", "route": "cuda",
         "source": "src/repro_torch/csrc/haralick_mcc.cu", "replaces": None,
         "launches": main_run["texture_launches"]["second_eigenvalue"],
         "max_abs_err": max(mcc["smooth_max_abs_err"], mcc["random_max_abs_err"]),
         "ms": mcc["smooth_ms"], "plain_ms": mcc["smooth_plain_ms"],
         "bound_ms": mcc["bound_ms"], "bound_by": mcc["bound_by"],
         "library_ms": mcc["smooth_library_ms"]},
        # f1-f13 on the texture map's 260 100 matrices (random), P, px and
        # py written for f14; no library call computes them.
        {"name": "haralick_tail", "route": "cuda",
         "source": "src/repro_torch/csrc/haralick_tail.cu", "replaces": None,
         "launches": main_run["texture_launches"]["haralick_tail"],
         "max_rel_err": max(max(ftail[f"{c}_check"]["rel_err"]) for c in ("smooth", "random")),
         "ms": ftail["random_ms"], "plain_ms": ftail["random_plain_ms"],
         "bound_ms": ftail["random_bound_ms"], "bound_by": "bytes", "library_ms": None},
    ]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
