"""Config registry: ``get_config("<arch-id>")`` / ``--arch <id>``; the port's
copy of ``repro.configs``."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import SHAPES, ShapeCell, applicable, smoke_cell

# arch-id → module (one module per assigned architecture).
_REGISTRY: dict[str, str] = {
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "llava-next-34b": "repro_torch.configs.llava_next_34b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
}

ARCHS = tuple(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    try:
        mod = importlib.import_module(_REGISTRY[name])
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; available: {', '.join(ARCHS)}") from None
    cfg: ModelConfig = mod.CONFIG
    cfg.validate()
    return cfg


__all__ = ["ARCHS", "get_config", "ModelConfig", "SHAPES", "ShapeCell",
           "applicable", "smoke_cell"]
