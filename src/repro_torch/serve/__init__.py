"""repro_torch.serve — the LM generation engine (``Engine``, ``ServeConfig``,
``perplexity``) and the GLCM texture-feature server (``GLCMEngine``) on the
card; counterpart of ``repro.serve``."""

from repro_torch.serve.engine import (
    Engine,
    GLCMEngine,
    GLCMServeConfig,
    QueueFullError,
    ServeConfig,
    perplexity,
)

__all__ = ["Engine", "GLCMEngine", "GLCMServeConfig", "QueueFullError", "ServeConfig",
           "perplexity"]
