"""glcm_fused_roofline.L256: glcm_fused's share of its bound at L = 256,
where no sub-histogram fits in shared memory and the kernel votes with
global atomics (the same reader as glcm_fused_roofline)."""

from h100_bench.metrics.glcm_fused_roofline import read  # noqa: F401
