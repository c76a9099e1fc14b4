"""repro_torch — the GLCM library ported to PyTorch and CUDA for Hopper.

A second package beside the JAX reference ``repro``; it imports torch and
nothing of JAX or of ``repro``. The public entry points run on the card
unless the caller passes ``device="cpu"``:

    from repro_torch import glcm, glcm_features, glcm_feature_stream
    F = glcm_features(stack, 32)                  # (B, 4, 14) on the card
    for f in glcm_feature_stream(frames, 32, temporal_window=16):
        ...                                       # rolling-window features

Layout mirrors the reference: ``core`` (spec, plan, autotune, backends,
schemes, quantize, haralick, glcm, pipeline, stream_state, native,
conflicts, distributed; ``repro_torch.autotune`` is ``core.autotune``, the
persisted autotuner behind ``scheme="auto"``; ``repro_torch.distributed`` is
``core.distributed``, the sharded GLCM over ``torch.distributed``),
``launch`` (device meshes for it),
``serve`` (``GLCMEngine``, the continuous-batching texture-feature server),
``obs`` (tracer, metrics registry, flight recorder and the
``python -m repro_torch.obs.report`` trace CLI), ``analysis`` (the
plan-contract analyzer behind ``compile_plan(check="lint")`` and the
``python -m repro_torch.analysis.audit`` registry audit), ``kernels`` (CUDA kernel
wrappers with their plain PyTorch versions, the nvcc build, offset tables
and oracles) and ``data`` (synthetic textures and videos). CUDA sources
live in ``csrc``.
"""

from repro_torch.core import (
    GLCMSpec,
    autotune,
    distributed,
    GLCMStream,
    compile_plan,
    glcm,
    glcm_feature_stream,
    glcm_features,
)

__all__ = ["GLCMSpec", "GLCMStream", "autotune", "compile_plan", "distributed", "glcm",
           "glcm_feature_stream", "glcm_features"]
