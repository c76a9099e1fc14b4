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
// Input: int32 levels, or raw float32 or uint8 values plus a (B, 2) float32
// (lo, span) per volume, binned once per voxel by glcm::bin_level (the op
// order of repro_torch.core.quantize.bin_values, IEEE division; uint8 is
// read as it is and converted exactly). The quantized volume is never
// written to device memory.
//
// What bounds it: the volume is read once (537 MB for two 256 x 512 x 512
// float32 volumes, 0.16 ms at 3.35 TB/s). The work is 13 votes per voxel,
// each a few integer operations and one shared-memory atomicAdd; on the
// H100 the atomics and the instructions around them take the time, not the
// bytes (PERF.md).
//
// Design (glcm_march.cuh): the first port read each partner voxel from
// device memory and binned it again, 14 reads, 14 IEEE divisions and 13
// atomics per voxel. Here a block owns a strip x row tile of each plane and
// marches down the depth: the binned plane-tiles within max dz (with their
// halo rows and columns) sit in a shared-memory ring, so each voxel is
// loaded with 16-byte loads and binned once (a uint8 volume through a
// 256-entry table), and the next plane is loaded into a spare slot while
// the current one votes, with one barrier per plane. A thread votes a run of
// 16 consecutive voxels from aligned shared loads, one shared atomic per
// vote. At L = 32 a set of 13 sub-histograms is 52 KiB and the ring ~16
// KiB, so three blocks fit on an SM; at L = 64 one set (208 KiB) fits
// beside a small ring; where none does, a cluster of blocks holds the
// counts of half the directions across its shared memory (L = 128: 7 of
// them, 448 KiB over 4 blocks) and the rest vote with global atomics; past
// what a cluster holds the kernel votes with global atomics alone. slab_d only bounds
// how finely the depth is split between blocks: it never changes the
// counts.

#include <cuda_runtime.h>

#include "glcm_march.cuh"

namespace {

using glcm::march::kMaxOffsets;

// Validates the arguments and fills the offsets; false on a bad argument.
bool offsets_of(int batch, int depth, int height, int width, int levels, int copies, int slab_d,
                const int* dz, const int* dy, const int* dx, int n_off,
                glcm::march::Offsets& offs) {
  if (batch < 0 || depth < 0 || height < 0 || width < 0 || levels < 1 || levels > 65535 ||
      copies < 1 || slab_d < 1 || n_off < 1 || n_off > kMaxOffsets) {
    return false;
  }
  offs.n = n_off;
  for (int k = 0; k < n_off; ++k) {
    if (dz[k] < 0) return false;
    offs.dz[k] = dz[k];
    offs.dy[k] = dy[k];
    offs.dx[k] = dx[k];
  }
  return true;
}

}  // namespace

extern "C" {

// Votes a (batch, depth, height, width) stack into out (batch, n_off,
// levels, levels) int32, which the caller has zeroed. `kind` says what
// `img` holds: 0 int32 levels (quant null), 1 float32 or 2 uint8 raw values
// binned with quant[2b], quant[2b+1] = (lo, span) of volume b. Offsets need
// 0 <= dz[k] <= slab_d, |dy[k]| < height and |dx[k]| < width (the wrapper
// checks). Launches on `stream` and does not synchronise. Returns
// cudaGetLastError() (0 = launched); cudaErrorInvalidConfiguration when the
// offsets' halo does not fit in shared memory.
int glcm_volume_launch(const void* img, int kind, const float* quant, int* out, int batch,
                       int depth, int height, int width, int levels, int copies, int slab_d,
                       const int* dz, const int* dy, const int* dx, int n_off, void* stream) {
  glcm::march::Offsets offs;
  if (!offsets_of(batch, depth, height, width, levels, copies, slab_d, dz, dy, dx, n_off, offs) ||
      (kind == glcm::march::kLevels) != (quant == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || depth == 0 || height == 0 || width == 0) return 0;
  cudaGetLastError();  // start from a clean error state
  return glcm::march::run(img, kind, quant, out, batch, depth, height, width, levels, copies,
                          slab_d, offs, static_cast<cudaStream_t>(stream), nullptr);
}

// The launch glcm_volume_launch would make for these arguments, without
// launching: info[0..12] = blocks per SM, shared bytes, shared
// sub-histograms (1/0), copies, runs per row, rows per tile, planes per
// step, ring slots, grid blocks, planes per block, registers, local bytes,
// blocks a cluster (0: no cluster).
int glcm_volume_plan(int kind, int batch, int depth, int height, int width, int levels,
                     int copies, int slab_d, const int* dz, const int* dy, const int* dx,
                     int n_off, int* info) {
  glcm::march::Offsets offs;
  if (!offsets_of(batch, depth, height, width, levels, copies, slab_d, dz, dy, dx, n_off, offs) ||
      batch == 0 || depth == 0 || height == 0 || width == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaGetLastError();
  return glcm::march::run(nullptr, kind, nullptr, nullptr, batch, depth, height, width, levels,
                          copies, slab_d, offs, nullptr, info);
}

const char* glcm_volume_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
