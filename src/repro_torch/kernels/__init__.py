"""CUDA kernels for the GLCM hot spots, each beside its plain PyTorch version.

  glcm_kernel       the pair-stream vote kernel (glcm_vote), the fused
                    multi-offset kernel (glcm_fused), the per-window kernel
                    (glcm_window) and the depth-slab volume kernel
                    (glcm_volume), with launch counts
  histogram_kernel  the level-histogram kernel (histogram), with its count
  mcc_kernel        f14's eigensolver (second_eigenvalue: the second-largest
                    eigenvalue of each Haralick Q matrix), with its count
  tail_kernel       f1–f13 of the Haralick features from int32 counts
                    (haralick_tail), with its count, their plain PyTorch
                    formulas (f1_to_f13), and the route that says which
                    implementation computes the features (route)
  ops               public wrappers: pair planes + binning + vote
                    (glcm_cuda), the fused pass (glcm_cuda_multi), texture
                    maps (glcm_cuda_windowed), volumes (glcm_cuda_volume),
                    level counts (histogram) and the plain one-hot class
                    count (onehot_count)
  build             the kernel table (TABLE: each wrapper, its library and
                    role), the launch seam every wrapper goes through
                    (dispatch, launch), nvcc build of csrc/*.cu at first
                    use, ctypes loading
  ref               offset tables and the plain scatter-add oracles
"""

__all__ = ["histogram", "onehot_count"]


def __getattr__(name: str):
    # Resolved at first use: ``ops`` imports ``core``, which imports
    # ``kernels.ref`` through this package, so an import here would be
    # circular.
    if name in __all__:
        from repro_torch.kernels import ops

        return getattr(ops, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
