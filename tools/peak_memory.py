#!/usr/bin/env python3
"""Peak device memory of the window kernel's launch and of a texture-stream
step, for the checkout this script lives in.

    python3 tools/peak_memory.py

On one NVIDIA card: the texture map's geometry (32 x 32 windows at stride
16, PAPER_PAIRS, L = 32) over frames of ``texture_video(4096, 10)`` (uint8).
Prints the card (``nvidia-smi`` name and power limit) and one JSON line:

- ``launch_peak_bytes``: ``max_memory_allocated`` above what was allocated
  before one ``glcm_window`` call on a uint8 frame with a fixed range,
  beside ``counts_bytes``, the size of its output;
- ``step_peak_bytes``: the same around one ``plan.update`` of a counts-only
  temporal plan with an 8-frame ring, once the ring is full.

It uses only what every version of the port has (``glcm_window``,
``compile_plan(temporal_window=)``), so a copy of it placed in an older
checkout's ``tools/`` measures that checkout the same way. That is why it
stays beside ``chip_smoke.py``, which measures the same two peaks but only
for its own checkout: it is how a change's allocations are compared with
its parent's in one call.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.plan import compile_plan  # noqa: E402
from repro_torch.core.spec import GLCMSpec  # noqa: E402
from repro_torch.data.images import texture_video  # noqa: E402
from repro_torch.kernels.glcm_kernel import glcm_window  # noqa: E402
from repro_torch.kernels.ref import glcm_offsets  # noqa: E402

PAPER_PAIRS = ((1, 0), (1, 45), (4, 0), (4, 45))
LEVELS, WINDOW, STRIDE, RING = 32, 32, 16, 8


def peak_above(fn) -> tuple[int, object]:
    """Bytes allocated at the peak of ``fn()`` above what was allocated
    before it, and its result."""
    dev = torch.device("cuda", 0)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    result = fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated(dev) - before, result


def main() -> int:
    if not torch.cuda.is_available():
        print("peak_memory: needs an NVIDIA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    frames = torch.from_numpy(texture_video(4096, RING + 2)).to("cuda")
    offsets = tuple(glcm_offsets(d, t) for d, t in PAPER_PAIRS)
    kw = dict(levels=LEVELS, offsets=offsets, region_shape=WINDOW, stride=STRIDE,
              quant=(0.0, 255.0))
    glcm_window(frames[0], **kw)  # build and load the kernel first
    launch, counts = peak_above(lambda: glcm_window(frames[0], **kw))
    counts_bytes = counts.numel() * 4
    del counts
    spec = GLCMSpec(levels=LEVELS, pairs=PAPER_PAIRS, quantize="uniform", vrange=(0, 255),
                    region="window", region_shape=WINDOW, region_stride=STRIDE)
    plan = compile_plan(spec, tuple(frames.shape[1:]), temporal_window=RING)
    state = plan.init_state()
    for frame in frames[:RING]:
        state, _ = plan.update(state, frame)
    step, _ = peak_above(lambda: plan.update(state, frames[RING]))
    print(json.dumps({"frame_dtype": str(frames.dtype), "counts_bytes": counts_bytes,
                      "launch_peak_bytes": launch, "step_peak_bytes": step}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
