"""The paper's own experiment configuration (Tables II/III, Figs 4/5)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GLCMPaperConfig:
    gray_levels: tuple[int, ...] = (8, 32)                    # Table II/III
    distances: tuple[int, ...] = (1, 4)
    thetas: tuple[int, ...] = (0, 45)
    resolutions: tuple[int, ...] = (1024, 4096, 8192, 16384)  # Table III
    copies: tuple[int, ...] = (1, 2, 4, 8)                    # R sweep, Eq. (6)
    block_size: int = 512                                      # best for L=32
    num_streams: int = 2                                       # Scheme 3


CONFIG = GLCMPaperConfig()
