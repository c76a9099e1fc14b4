"""repro_torch.serve — the GLCM texture-feature server (``GLCMEngine``) on the
card; counterpart of ``repro.serve``."""

from repro_torch.serve.engine import GLCMEngine, GLCMServeConfig, QueueFullError

__all__ = ["GLCMEngine", "GLCMServeConfig", "QueueFullError"]
