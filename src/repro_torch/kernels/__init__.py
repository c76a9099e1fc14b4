"""CUDA kernels for the GLCM hot spots, each beside its plain PyTorch version.

  glcm_kernel  the pair-stream vote kernel (glcm_vote) and the fused
               multi-offset kernel (glcm_fused), with launch counts
  ops          public wrappers: pair planes + binning + vote (glcm_cuda), and
               the fused pass (glcm_cuda_multi)
  build        nvcc build of csrc/*.cu at first use, ctypes loading
  ref          offset tables and the plain scatter-add oracle
"""
