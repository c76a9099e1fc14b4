"""The benchmark's plain reference (see ``reference.glcm``)."""

from h100_bench.reference.glcm import expected_features

__all__ = ["expected_features"]
