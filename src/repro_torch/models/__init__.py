"""Composable model stack, the port's counterpart of ``repro.models``:
attention (GQA/SWA/flash-chunked), MoE (conflict-free one-hot dispatch — the
paper primitive), Mamba2 SSD, Hymba hybrid, whisper enc-dec, the unified
``build_model`` API and ``convert`` (the reference's parameters carried
across)."""

from repro_torch.models.model import ModelApi, build_model, describe

__all__ = ["ModelApi", "build_model", "describe"]
