"""CUDA kernels for the GLCM hot spots, each beside its plain PyTorch version.

  glcm_kernel  the pair-stream vote kernel (glcm_vote), the fused
               multi-offset kernel (glcm_fused), the per-window kernel
               (glcm_window) and the depth-slab volume kernel (glcm_volume),
               with launch counts
  ops          public wrappers: pair planes + binning + vote (glcm_cuda), the
               fused pass (glcm_cuda_multi), texture maps
               (glcm_cuda_windowed) and volumes (glcm_cuda_volume)
  build        nvcc build of csrc/*.cu at first use, ctypes loading
  ref          offset tables and the plain scatter-add oracle
"""
