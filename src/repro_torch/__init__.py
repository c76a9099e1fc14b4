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
``launch`` (device meshes for it; ``launch.serve``, the LM serving driver),
``serve`` (``GLCMEngine``, the continuous-batching texture-feature server, and
``Engine`` / ``ServeConfig`` / ``perplexity``, LM generation),
``obs`` (tracer, metrics registry, flight recorder and the
``python -m repro_torch.obs.report`` trace CLI), ``analysis`` (the
plan-contract analyzer behind ``compile_plan(check="lint")`` and the
``python -m repro_torch.analysis.audit`` registry audit), ``kernels`` (CUDA kernel
wrappers with their plain PyTorch versions, the nvcc build, offset tables
and oracles), ``data`` (synthetic textures and videos; ``data.tokens``, the
seekable synthetic LM token stream), ``configs`` (the ten LM architecture
configs, ``get_config``) and ``models`` (the LM model core: ``build_model``,
``describe``, ``models.convert`` for the reference's parameters;
``sharding.logical.constrain`` marks its sharding points). CUDA sources
live in ``csrc``.

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, ServeConfig
    api = build_model(get_config("smollm-135m"))          # on the card
    model = api.init(torch.Generator(api.device).manual_seed(0))
    out = Engine(api.cfg, model, ServeConfig(max_new_tokens=64, s_cache=640)
                 ).generate(prompts)                      # (B, T + 64) ids
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
