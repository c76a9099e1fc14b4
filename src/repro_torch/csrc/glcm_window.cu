// Per-window multi-offset GLCMs (texture maps) for Hopper (sm_90a), behind
// a plain C interface.
//
// Replaces the TPU kernel repro/kernels/glcm_kernel.py::glcm_window_pallas
// (_window_kernel): one GLCM per window of every offset, pairs never
// crossing a window, out[b, i, j, k, ref, assoc] += 1, where the associate
// is the pixel at (y, x) of window (i, j) and the reference the pixel at
// (y + dy, x + dx) of the same window. Offsets need 0 <= dy < rh and
// |dx| < rw.
//
// Input: a (B, gh, gw, rh, rw) window grid described by four element
// strides over one buffer, innermost stride 1. For windows of an image that
// is the (B, H, W) image itself — window (i, j) starts at (i*sh, j*sw) — so
// the kernel reads each window in place and no patch is copied (with 32 x 32
// windows at stride 16, patches would copy every pixel four times). An
// extracted, contiguous patch grid is the same description with other
// strides. Values are int32 levels, or raw float32 plus a (B, 2) float32
// (lo, span) per image: every window of an image bins with that image's
// range, in registers, by glcm::bin_level.
//
// Design: one block per window (a 1-D grid over B * gh * gw windows, image
// major). The block votes its window's intra-window pairs into `copies` (R)
// private sets of n_off L x L sub-histograms in shared memory (lane l uses
// copy l % R; sets n_off*L*L+1 words apart) and then writes its window's
// whole output slot with plain, coalesced stores. The slot belongs to that
// block alone, as the TPU kernel's output block belongs to one grid cell:
// no global atomic, and no zero fill — the wrapper allocates the output
// with torch.empty.
//
// What bounds it: the output. At the texture-map size (65 025 windows of
// 32 x 32, four offsets, L = 32) the counts are 1.07 GB of int32 against a
// 67 MB image, so the floor is writing the counts once; the kernel writes
// each count once and reads the image through L1/L2.
//
// Large L: when not even one set fits in a block's shared memory
// (n_off * L * L int32 above 227 KiB, e.g. L = 256), the block zeroes its
// own slot, synchronises, and votes into it with global atomics. Otherwise
// R is lowered to the number of sets that fit; R never changes the counts.

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

struct Windows {
  int n_win;                  // windows per image, gh * gw
  int gw;                     // windows per grid row
  int rh, rw;                 // window extent
  long long image_stride;     // elements between images
  long long grid_row_stride;  // elements between windows (i, j) and (i + 1, j)
  long long grid_col_stride;  // elements between windows (i, j) and (i, j + 1)
  long long row_stride;       // elements between rows of one window
};

template <bool kQuant, bool kShared>
__global__ void __launch_bounds__(kThreads)
window_kernel(const void* __restrict__ img, const float* __restrict__ quant,
              int* __restrict__ out, Windows g, int levels, int copies, Offsets offs) {
  extern __shared__ int hist[];
  const int cells = levels * levels;
  const int n_off = offs.n;
  const int slot_len = n_off * cells;
  const int set_stride = slot_len + 1;
  const long long window = blockIdx.x;  // b * n_win + i * gw + j
  const int b = static_cast<int>(window / g.n_win);
  const int w = static_cast<int>(window - static_cast<long long>(b) * g.n_win);
  const int gi = w / g.gw;
  const int gj = w - gi * g.gw;
  int* slot = out + window * slot_len;

  if (kShared) {
    for (int i = threadIdx.x; i < copies * set_stride; i += blockDim.x) hist[i] = 0;
  } else {
    for (int i = threadIdx.x; i < slot_len; i += blockDim.x) slot[i] = 0;
  }
  __syncthreads();
  int* mine = kShared ? hist + (threadIdx.x % 32 % copies) * set_stride : slot;

  float lo = 0.0f, span = 1.0f;
  if (kQuant) {
    lo = quant[2 * b];
    span = quant[2 * b + 1];
  }
  const long long base = b * g.image_stride + gi * g.grid_row_stride + gj * g.grid_col_stride;
  const int pixels = g.rh * g.rw;
  for (int p = threadIdx.x; p < pixels; p += blockDim.x) {
    const int y = p / g.rw;
    const int x = p - y * g.rw;
    const int a = glcm::level_at<kQuant>(img, base + y * g.row_stride + x, lo, span, levels);
    if (!glcm::votes(a, levels)) continue;
    for (int k = 0; k < n_off; ++k) {
      const int yy = y + offs.dy[k];
      const int xx = x + offs.dx[k];
      if (yy >= g.rh || xx < 0 || xx >= g.rw) continue;
      const int r = glcm::level_at<kQuant>(img, base + yy * g.row_stride + xx, lo, span, levels);
      if (!glcm::votes(r, levels)) continue;
      atomicAdd(mine + k * cells + r * levels + a, 1);
    }
  }

  if (kShared) {
    __syncthreads();
    for (int c = threadIdx.x; c < slot_len; c += blockDim.x) {
      int v = 0;
      for (int k = 0; k < copies; ++k) v += hist[k * set_stride + c];
      slot[c] = v;
    }
  }
}

template <bool kQuant, bool kShared>
int launch(const void* img, const float* quant, int* out, long long blocks, const Windows& g,
           int levels, int copies, const Offsets& offs, size_t smem, cudaStream_t s) {
  auto kernel = window_kernel<kQuant, kShared>;
  const cudaError_t e = glcm::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(img, quant, out, g, levels,
                                                              copies, offs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Votes the (batch, gh, gw, rh, rw) window grid of `img` — element (b, i, j,
// y, x) at b*image_stride + i*grid_row_stride + j*grid_col_stride +
// y*row_stride + x — into out (batch, gh, gw, n_off, levels, levels) int32.
// Every element of `out` is written; the caller need not zero it. `img`
// holds int32 levels when `quant` is null, else float32 raw values binned
// with quant[2b], quant[2b+1] = (lo, span) of image b. Offsets need
// 0 <= dy[k] < rh and |dx[k]| < rw (the wrapper checks). Launches on
// `stream` and does not synchronise. Returns cudaGetLastError() (0 =
// launched).
int glcm_window_launch(const void* img, const float* quant, int* out, int batch, int gh, int gw,
                       int rh, int rw, long long image_stride, long long grid_row_stride,
                       long long grid_col_stride, long long row_stride, int levels, int copies,
                       const int* dy, const int* dx, int n_off, void* stream) {
  if (batch < 0 || gh < 0 || gw < 0 || rh < 1 || rw < 1 || levels < 1 || copies < 1 ||
      n_off < 1 || n_off > kMaxOffsets) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = static_cast<long long>(batch) * gh * gw;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // start from a clean error state
  Offsets offs;
  offs.n = n_off;
  for (int k = 0; k < n_off; ++k) {
    offs.dy[k] = dy[k];
    offs.dx[k] = dx[k];
  }
  Windows g{gh * gw, gw, rh, rw, image_stride, grid_row_stride, grid_col_stride, row_stride};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long set_bytes = (static_cast<long long>(n_off) * levels * levels + 1) * 4;
  const int max_smem = glcm::device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  const int fit = static_cast<int>(max_smem / set_bytes);
  const bool q = quant != nullptr;
  if (fit >= 1) {
    const int r = copies < fit ? copies : fit;
    const size_t smem = static_cast<size_t>(r * set_bytes);
    return q ? launch<true, true>(img, quant, out, blocks, g, levels, r, offs, smem, s)
             : launch<false, true>(img, quant, out, blocks, g, levels, r, offs, smem, s);
  }
  return q ? launch<true, false>(img, quant, out, blocks, g, levels, 1, offs, 0, s)
           : launch<false, false>(img, quant, out, blocks, g, levels, 1, offs, 0, s);
}

const char* glcm_window_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
