"""repro_torch — the GLCM library ported to PyTorch and CUDA for Hopper.

A second package beside the JAX reference ``repro``; it imports torch and
nothing of JAX or of ``repro``. The public entry points run on the card
unless the caller passes ``device="cpu"``:

    from repro_torch import glcm, glcm_features
    F = glcm_features(stack, 32)                  # (B, 4, 14) on the card

Layout mirrors the reference: ``core`` (spec, plan, backends, schemes,
quantize, haralick, glcm), ``kernels`` (CUDA kernel wrappers with their
plain PyTorch versions, the nvcc build, offset tables) and ``data``
(synthetic textures). CUDA sources live in ``csrc``.
"""

from repro_torch.core import GLCMSpec, compile_plan, glcm, glcm_features

__all__ = ["GLCMSpec", "compile_plan", "glcm", "glcm_features"]
