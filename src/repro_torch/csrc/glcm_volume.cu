// Multi-direction 3-D GLCMs of volumes for Hopper (sm_90a), behind a plain
// C interface.
//
// Replaces the TPU kernel repro/kernels/glcm_kernel.py::glcm_volume_pallas
// (_volume_kernel): one pass over a (B, D, H, W) stack votes the GLCMs of
// every (dz, dy, dx) offset into (B, n_off, L, L) int32 counts,
// out[b, k, ref, assoc] += 1, where the associate is the voxel at (z, y, x)
// and the reference the voxel at (z + dz, y + dy, x + dx). Offsets need
// 0 <= dz (dy and dx may be negative: the dz = +1 directions of the 13).
//
// Input: int32 levels, or raw float32 plus a (B, 2) float32 (lo, span) per
// volume, binned in registers by glcm::bin_level (the op order of
// repro_torch.core.quantize.bin_values, IEEE division). The quantized
// volume is never written.
//
// Design: the fused image kernel (glcm_fused.cu) with a depth axis. The unit
// of work is (depth slab of slab_d slices) x (tile of kTileRows rows); the
// grid is (units, volume), flattened to one dimension with `per_volume`
// blocks per volume, each walking the units of its volume with a stride.
// A thread loads its voxel once and, for every offset, reads the partner
// voxel straight from device memory with bounds checks in place of the TPU
// kernel's padded next-slab halo and roll: z + dz < D, 0 <= y + dy < H,
// 0 <= x + dx < W. Depth is not padded, so no padding ever reaches a vote.
// Votes go to `copies` (R) private sets of n_off L x L sub-histograms in
// shared memory (lane l uses copy l % R; sets n_off*L*L+1 words apart),
// merged into the output with global atomicAdd at block exit; the wrapper
// zeroes the output. slab_d only splits the work: it never changes the
// counts.
//
// What bounds it: the volume is read once from device memory (537 MB for
// two 256 x 512 x 512 float32 volumes); partner reads hit L1/L2. Per voxel
// it does up to 13 partner reads, 13 binnings and 13 shared-memory atomics,
// which serialise where neighbouring voxels share a level (smooth volumes).
//
// Shared memory: 13 offsets x 32² x 4 B = 52 KiB per set at L = 32, above
// the 48 KiB default, so the kernel is opted in with cudaFuncSetAttribute;
// four sets fit in 227 KiB. One set is 208 KiB at L = 64. At L >= 128 not
// even one set fits, and the kernel votes with global atomics straight into
// the output.

#include <cuda_runtime.h>

#include "glcm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 8;
constexpr int kMaxOffsets = 64;

struct Offsets {
  int n;
  int dz[kMaxOffsets];
  int dy[kMaxOffsets];
  int dx[kMaxOffsets];
};

template <bool kQuant, bool kShared>
__global__ void __launch_bounds__(kThreads)
volume_kernel(const void* __restrict__ img, const float* __restrict__ quant,
              int* __restrict__ out, int depth, int height, int width, int levels, int copies,
              int slab_d, int per_volume, Offsets offs) {
  extern __shared__ int hist[];
  const int cells = levels * levels;
  const int n_off = offs.n;
  const int set_stride = n_off * cells + 1;
  const int b = blockIdx.x / per_volume;
  const int first = blockIdx.x - b * per_volume;
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
  const long long plane = static_cast<long long>(height) * width;
  const long long base = static_cast<long long>(b) * depth * plane;
  const int row_tiles = (height + kTileRows - 1) / kTileRows;
  const long long units =
      static_cast<long long>((depth + slab_d - 1) / slab_d) * row_tiles;
  for (long long u = first; u < units; u += per_volume) {
    const int slab = static_cast<int>(u / row_tiles);
    const int tile = static_cast<int>(u - static_cast<long long>(slab) * row_tiles);
    const int z_end = min((slab + 1) * slab_d, depth);
    const int y_end = min((tile + 1) * kTileRows, height);
    for (int z = slab * slab_d; z < z_end; ++z) {
      for (int y = tile * kTileRows; y < y_end; ++y) {
        for (int x = threadIdx.x; x < width; x += blockDim.x) {
          const long long i = base + z * plane + static_cast<long long>(y) * width + x;
          const int a = glcm::level_at<kQuant>(img, i, lo, span, levels);
          if (!glcm::votes(a, levels)) continue;
          for (int k = 0; k < n_off; ++k) {
            const int zz = z + offs.dz[k];
            const int yy = y + offs.dy[k];
            const int xx = x + offs.dx[k];
            if (zz >= depth || yy < 0 || yy >= height || xx < 0 || xx >= width) continue;
            const int r = glcm::level_at<kQuant>(
                img, base + zz * plane + static_cast<long long>(yy) * width + xx, lo, span,
                levels);
            if (!glcm::votes(r, levels)) continue;
            atomicAdd(mine + k * cells + r * levels + a, 1);
          }
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
int launch(const void* img, const float* quant, int* out, int batch, int depth, int height,
           int width, int levels, int copies, int slab_d, const Offsets& offs, size_t smem,
           cudaStream_t s) {
  auto kernel = volume_kernel<kQuant, kShared>;
  const cudaError_t e = glcm::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (per_sm < 1) per_sm = 1;
  const int sms = glcm::device_attr(cudaDevAttrMultiProcessorCount);
  const long long units = static_cast<long long>((depth + slab_d - 1) / slab_d) *
                          ((height + kTileRows - 1) / kTileRows);
  long long per_volume = (static_cast<long long>(per_sm) * sms + batch - 1) / batch;
  if (per_volume > units) per_volume = units;
  if (per_volume * batch > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(per_volume * batch), kThreads, smem, s>>>(
      img, quant, out, depth, height, width, levels, copies, slab_d,
      static_cast<int>(per_volume), offs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Votes a (batch, depth, height, width) stack into out (batch, n_off,
// levels, levels) int32, which the caller has zeroed. `img` holds int32
// levels when `quant` is null, else float32 raw values binned with
// quant[2b], quant[2b+1] = (lo, span) of volume b. Offsets need
// 0 <= dz[k] <= slab_d, |dy[k]| < height and |dx[k]| < width (the wrapper
// checks). Launches on `stream` and does not synchronise. Returns
// cudaGetLastError() (0 = launched).
int glcm_volume_launch(const void* img, const float* quant, int* out, int batch, int depth,
                       int height, int width, int levels, int copies, int slab_d,
                       const int* dz, const int* dy, const int* dx, int n_off, void* stream) {
  if (batch < 0 || depth < 0 || height < 0 || width < 0 || levels < 1 || copies < 1 ||
      slab_d < 1 || n_off < 1 || n_off > kMaxOffsets) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || depth == 0 || height == 0 || width == 0) return 0;
  cudaGetLastError();  // start from a clean error state
  Offsets offs;
  offs.n = n_off;
  for (int k = 0; k < n_off; ++k) {
    offs.dz[k] = dz[k];
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
    return q ? launch<true, true>(img, quant, out, batch, depth, height, width, levels, r,
                                  slab_d, offs, smem, s)
             : launch<false, true>(img, quant, out, batch, depth, height, width, levels, r,
                                   slab_d, offs, smem, s);
  }
  return q ? launch<true, false>(img, quant, out, batch, depth, height, width, levels, 1, slab_d,
                                 offs, 0, s)
           : launch<false, false>(img, quant, out, batch, depth, height, width, levels, 1,
                                  slab_d, offs, 0, s);
}

const char* glcm_volume_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
