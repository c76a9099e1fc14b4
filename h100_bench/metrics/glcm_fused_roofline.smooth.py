"""glcm_fused_roofline.smooth: glcm_fused's share of its bound on stacks of
smooth images only, at L = 32 (the same reader as glcm_fused_roofline)."""

from h100_bench.metrics.glcm_fused_roofline import read  # noqa: F401
