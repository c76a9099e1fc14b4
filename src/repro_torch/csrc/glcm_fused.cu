// Fused multi-offset GLCM for Hopper (sm_90a), behind a plain C interface.
//
// Replaces the TPU kernel repro/kernels/glcm_kernel.py::glcm_fused_pallas
// (_fused_kernel, with _bin_tile / _quant_block for fused quantization):
// one pass over a (B, H, W) stack votes the GLCMs of every (dy, dx) offset
// into (B, n_off, L, L) int32 counts, out[b, k, ref, assoc] += 1, where the
// associate is the pixel at (y, x) and the reference the pixel at
// (y + dy, x + dx).
//
// Input: pre-quantized int32 levels, or raw float32 values plus a (B, 2)
// float32 (lo, span) per image. Raw values are binned in registers with the
// f32 op order of repro_torch.core.quantize.bin_values — subtract, divide,
// multiply, floor, clip, int — using the _rn intrinsics (glcm::bin_level in
// glcm_common.cuh), so the division is IEEE and nothing is contracted into
// an FMA: bin edges land exactly where the reference puts them. The
// quantized image is never written.
//
// Design (the paper's Scheme 2): the grid is (row-tile blocks, B). A block
// walks row tiles of tile_h rows of its image; a thread loads its pixel once,
// and for every offset reads the partner pixel straight from device memory,
// with bounds checks in place of the TPU kernel's halo tile: rows past H vote
// neither as associate nor as reference, and 0 <= x + dx < W. Votes go to
// `copies` (R) private sets of n_off L x L sub-histograms in shared memory
// (lane l uses copy l % R; sets sit n_off*L*L+1 words apart, off the same
// banks); at block exit they are merged into the output with global
// atomicAdd. The wrapper zeroes the output. A level outside [0, L) does not
// vote, as the TPU kernel's one-hot compare drops it.
//
// What bounds it: the image is read once from device memory (the partner
// reads hit L1/L2); the shared-memory atomics, n_off per pixel, serialise
// where many lanes vote one cell (smooth images), which R relieves.
//
// Large L: n_off*L*L int32 is 16 KiB at L = 32 and 4 offsets, but 1 MiB at
// L = 256. When not even one set fits in a block's shared memory, the kernel
// votes straight into the output with global atomics. Otherwise R is
// lowered to the number of sets that fit; R never changes the counts.

#include <cuda_runtime.h>

#include "glcm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOffsets = 64;

struct Offsets {
  int n;
  int dy[kMaxOffsets];
  int dx[kMaxOffsets];
};

template <bool kQuant, bool kShared>
__global__ void __launch_bounds__(kThreads)
fused_kernel(const void* __restrict__ img, const float* __restrict__ quant,
             int* __restrict__ out, int height, int width, int levels, int copies,
             int tile_h, Offsets offs) {
  extern __shared__ int hist[];
  const int cells = levels * levels;
  const int n_off = offs.n;
  const int set_stride = n_off * cells + 1;
  const int b = blockIdx.y;
  int* out_b = out + static_cast<long long>(b) * n_off * cells;

  if (kShared) {
    for (int i = threadIdx.x; i < copies * set_stride; i += blockDim.x) hist[i] = 0;
    __syncthreads();
  }
  int* mine = kShared ? hist + (threadIdx.x % 32 % copies) * set_stride : out_b;

  float lo = 0.0f, span = 1.0f;
  if (kQuant) {
    lo = quant[2 * b];
    span = quant[2 * b + 1];
  }
  const long long base = static_cast<long long>(b) * height * width;
  const int tiles = (height + tile_h - 1) / tile_h;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int y_end = min((t + 1) * tile_h, height);
    for (int y = t * tile_h; y < y_end; ++y) {
      for (int x = threadIdx.x; x < width; x += blockDim.x) {
        const int a = glcm::level_at<kQuant>(
            img, base + static_cast<long long>(y) * width + x, lo, span, levels);
        if (!glcm::votes(a, levels)) continue;
        for (int k = 0; k < n_off; ++k) {
          const int yy = y + offs.dy[k];
          const int xx = x + offs.dx[k];
          if (yy >= height || xx < 0 || xx >= width) continue;
          const int r = glcm::level_at<kQuant>(
              img, base + static_cast<long long>(yy) * width + xx, lo, span, levels);
          if (!glcm::votes(r, levels)) continue;
          atomicAdd(mine + k * cells + r * levels + a, 1);
        }
      }
    }
  }

  if (kShared) {
    __syncthreads();
    for (int c = threadIdx.x; c < n_off * cells; c += blockDim.x) {
      int v = 0;
      for (int k = 0; k < copies; ++k) v += hist[k * set_stride + c];
      if (v) atomicAdd(out_b + c, v);
    }
  }
}

template <bool kQuant, bool kShared>
int launch(const void* img, const float* quant, int* out, int batch, int height, int width,
           int levels, int copies, int tile_h, const Offsets& offs, size_t smem,
           cudaStream_t s) {
  auto kernel = fused_kernel<kQuant, kShared>;
  const cudaError_t e = glcm::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (per_sm < 1) per_sm = 1;
  const int sms = glcm::device_attr(cudaDevAttrMultiProcessorCount);
  const int tiles = (height + tile_h - 1) / tile_h;
  long long gx = (static_cast<long long>(per_sm) * sms + batch - 1) / batch;
  if (gx > tiles) gx = tiles;
  dim3 grid(static_cast<unsigned>(gx), batch);
  kernel<<<grid, kThreads, smem, s>>>(img, quant, out, height, width, levels, copies, tile_h,
                                      offs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Votes a (batch, height, width) stack into out (batch, n_off, levels,
// levels) int32, which the caller has zeroed. `img` holds int32 levels when
// `quant` is null, else float32 raw values binned with quant[2b], quant[2b+1]
// = (lo, span) of image b. Offsets need 0 <= dy[k] <= tile_h and
// |dx[k]| < width (the wrapper checks). Launches on `stream` and does not
// synchronise. Returns cudaGetLastError() (0 = launched).
int glcm_fused_launch(const void* img, const float* quant, int* out, int batch, int height,
                      int width, int levels, int copies, int tile_h, const int* dy,
                      const int* dx, int n_off, void* stream) {
  if (batch < 0 || batch > 65535 || height < 0 || width < 0 || levels < 1 || copies < 1 ||
      tile_h < 1 || n_off < 1 || n_off > kMaxOffsets) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || height == 0 || width == 0) return 0;
  cudaGetLastError();  // start from a clean error state
  Offsets offs;
  offs.n = n_off;
  for (int k = 0; k < n_off; ++k) {
    offs.dy[k] = dy[k];
    offs.dx[k] = dx[k];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long set_bytes = (static_cast<long long>(n_off) * levels * levels + 1) * 4;
  const int max_smem = glcm::device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  const int fit = static_cast<int>(max_smem / set_bytes);
  const bool q = quant != nullptr;
  if (fit >= 1) {
    const int r = copies < fit ? copies : fit;
    const size_t smem = static_cast<size_t>(r * set_bytes);
    return q ? launch<true, true>(img, quant, out, batch, height, width, levels, r, tile_h,
                                  offs, smem, s)
             : launch<false, true>(img, quant, out, batch, height, width, levels, r, tile_h,
                                   offs, smem, s);
  }
  return q ? launch<true, false>(img, quant, out, batch, height, width, levels, 1, tile_h, offs,
                                 0, s)
           : launch<false, false>(img, quant, out, batch, height, width, levels, 1, tile_h,
                                  offs, 0, s);
}

const char* glcm_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
