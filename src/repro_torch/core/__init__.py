"""repro_torch.core — GLCM computation as a library, in PyTorch.

Execution layer (spec → plan → backend), as in ``repro.core``:
  spec      GLCMSpec, the frozen description of one GLCM workload
  backends  the scheme registry (scatter / onehot / blocked / cuda /
            cuda_fused / cuda_volume) — the only place scheme names are
            dispatched
  plan      compile_plan: spec + shape + device → one cached plan

Modules:
  glcm      public API (glcm / glcm_features)
  schemes   paper Schemes 1–3 in PyTorch (bincount / one-hot matmul /
            blocks with a halo) and the region extraction
  haralick  the 14 Haralick texture features
  quantize  gray-level quantization (uniform / equalized)

Importing needs neither a card nor nvcc: the CUDA kernels are built and
loaded at their first launch.
"""

from repro_torch.core import backends, haralick, plan, quantize, schemes, spec
from repro_torch.core.glcm import PAPER_PAIRS, VOLUME_PAIRS, glcm, glcm_features
from repro_torch.core.plan import compile_plan
from repro_torch.core.spec import GLCMSpec

__all__ = [
    "glcm",
    "glcm_features",
    "GLCMSpec",
    "compile_plan",
    "PAPER_PAIRS",
    "VOLUME_PAIRS",
    "spec",
    "plan",
    "backends",
    "schemes",
    "haralick",
    "quantize",
]
