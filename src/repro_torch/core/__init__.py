"""repro_torch.core — GLCM computation as a library, in PyTorch.

Execution layer (spec → plan → backend), as in ``repro.core``:
  spec      GLCMSpec, the frozen description of one GLCM workload
  backends  the scheme registry (scatter / onehot / blocked / native /
            cuda / cuda_fused / cuda_volume) — the only place scheme names
            are dispatched
  plan      compile_plan: spec + shape + device → one cached plan (or, with
            temporal_window=, one cached stream plan); plan-cache counters,
            build-time histogram and spans in repro_torch.obs; bucket_sizes /
            pick_bucket, the launch sizes of a batched server (serve.engine)
  autotune  the persisted autotuner: measures each eligible backend and its
            knobs for one workload on one device and stores the winner,
            which "auto" then resolves to (python -m repro_torch.core.autotune)
  distributed  multi-rank sharding over torch.distributed: rows/depth with a
            halo exchange and one all_reduce, or the window grid
            (glcm_sharded / glcm_sharded_batch / glcm_auto_sharded)

Modules:
  glcm          public API (glcm / glcm_features)
  pipeline      streamed processing: GLCMStream (pinned buffers and a side
                copy stream, the paper's Fig. 3) and glcm_feature_stream
  stream_state  exact rolling-window temporal GLCM state and stream plans
  schemes       paper Schemes 1–3 in PyTorch (bincount / one-hot matmul /
                blocks with a halo) and the region extraction
  native        NumPy counting on the host (the "native" backend)
  conflicts     the paper's §II.A vote-conflict analysis
  haralick      the 14 Haralick texture features
  quantize      gray-level quantization (uniform / equalized)

Importing needs neither a card nor nvcc: the CUDA kernels are built and
loaded at their first launch.
"""

from repro_torch.core import (
    autotune,
    backends,
    conflicts,
    distributed,
    haralick,
    native,
    pipeline,
    plan,
    quantize,
    schemes,
    spec,
    stream_state,
)
from repro_torch.core.glcm import PAPER_PAIRS, VOLUME_PAIRS, glcm, glcm_features
from repro_torch.core.pipeline import GLCMStream, glcm_feature_stream
from repro_torch.core.plan import compile_plan
from repro_torch.core.spec import GLCMSpec
from repro_torch.core.stream_state import GLCMStreamPlan, GLCMStreamState

__all__ = [
    "glcm",
    "glcm_features",
    "GLCMSpec",
    "compile_plan",
    "glcm_feature_stream",
    "GLCMStream",
    "GLCMStreamPlan",
    "GLCMStreamState",
    "PAPER_PAIRS",
    "VOLUME_PAIRS",
    "spec",
    "plan",
    "autotune",
    "backends",
    "distributed",
    "schemes",
    "haralick",
    "quantize",
    "pipeline",
    "stream_state",
    "native",
    "conflicts",
]
