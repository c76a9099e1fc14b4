// Device helpers shared by the kernels of repro_torch (glcm_fused.cu,
// glcm_window.cu, glcm_volume.cu, histogram.cu; haralick_mcc.cu takes
// device_attr, haralick_tail.cu allow_smem). Each kernel source is its own
// shared library; this header is compiled into each of them, and
// kernels/build.py hashes it with every source that includes it.

#pragma once

#include <cuda_runtime.h>

namespace glcm {

// Uniform binning of one raw float32 value with the f32 op order of
// repro_torch.core.quantize.bin_values — subtract, divide, multiply, floor,
// clip, int — through the _rn intrinsics, so the division is IEEE and
// nothing is contracted into an FMA: bin edges land where PyTorch puts them.
__device__ __forceinline__ int bin_level(float v, float lo, float span, int levels) {
  float q = floorf(__fmul_rn(__fdiv_rn(__fsub_rn(v, lo), span), static_cast<float>(levels)));
  q = fminf(fmaxf(q, 0.0f), static_cast<float>(levels - 1));
  return static_cast<int>(q);
}

// The level at element i: an int32 level as stored, or a raw float32 value
// binned in registers with (lo, span).
template <bool kQuant>
__device__ __forceinline__ int level_at(const void* img, long long i, float lo, float span,
                                        int levels) {
  if (kQuant) return bin_level(__ldg(static_cast<const float*>(img) + i), lo, span, levels);
  return __ldg(static_cast<const int*>(img) + i);
}

// Whether a level votes: one unsigned compare drops every value outside
// [0, L), the -1 pad included, as the TPU kernels' one-hot compare does.
__device__ __forceinline__ bool votes(int level, int levels) {
  return static_cast<unsigned>(level) < static_cast<unsigned>(levels);
}

inline int device_attr(cudaDeviceAttr attr) {
  int dev = 0, value = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&value, attr, dev);
  return value;
}

// Opt `kernel` into `smem` bytes of dynamic shared memory; above 48 KiB a
// launch without this is refused.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace glcm
