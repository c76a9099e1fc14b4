// Fused multi-offset GLCM for Hopper (sm_90a), behind a plain C interface.
//
// Replaces the TPU kernel repro/kernels/glcm_kernel.py::glcm_fused_pallas
// (_fused_kernel, with _bin_tile / _quant_block for fused quantization):
// one pass over a (B, H, W) stack votes the GLCMs of every (dy, dx) offset
// into (B, n_off, L, L) int32 counts, out[b, k, ref, assoc] += 1, where the
// associate is the pixel at (y, x) and the reference the pixel at
// (y + dy, x + dx).
//
// Input: int32 levels, or raw float32 or uint8 values plus a (B, 2) float32
// (lo, span) per image. Raw values are binned once per pixel with the f32
// op order of repro_torch.core.quantize.bin_values — subtract, divide,
// multiply, floor, clip, int — using the _rn intrinsics (glcm::bin_level in
// glcm_common.cuh), so the division is IEEE and nothing is contracted into
// an FMA: bin edges land exactly where the reference puts them. uint8 (the
// paper's 8-bit images) is read as it is, a quarter of the bytes of
// float32, and converted to float exactly. The quantized image is never
// written.
//
// What bounds it: the image is read once (537 MB for 8 x 4096² float32,
// 0.16 ms at 3.35 TB/s; 134 MB as uint8, 0.04 ms). The work is n_off votes
// per pixel, each a few integer operations and one shared-memory atomicAdd;
// on the H100 the atomics and the instructions around them take the time,
// not the bytes (PERF.md), and float32 input adds one IEEE division per
// pixel.
//
// Design (glcm_march.cuh, the image as a stack of one-row planes): the
// first port read each pixel 1 + n_off times from memory and binned every
// read. Here a block owns a column strip (up to 4096 pixels) and marches
// down the rows with a ring of the binned rows within max dy (with their
// halo columns) in shared memory: each pixel is loaded with 16-byte loads
// and binned once (uint8 through a 256-entry table of the binning), and the
// next row is loaded into a spare slot while the current one votes, with
// one barrier per row. A thread votes a run of 16 consecutive pixels from
// aligned shared loads, one shared atomic per vote. Votes go to `copies`
// (R) private sub-histogram sets in shared memory, merged with global
// atomics at block exit. Where not even one set fits beside the ring
// (L = 256, or 128 with 4 offsets: 1 MB and 256 KB against 227 KB a
// block), a cluster of blocks holds the counts of half the offsets across
// its shared memory (4 blocks of 128 KB at L = 256), each vote sent to the
// block that owns its reference row, while the other half vote with global
// atomics; each pixel is still marched once. Only a set too large for any
// cluster (16 offsets at L = 256) is voted with global atomics alone.
// tile_h only bounds how finely the rows are split between blocks: it
// never changes the counts.

#include <cuda_runtime.h>

#include "glcm_march.cuh"

namespace {

using glcm::march::kMaxOffsets;

// Validates the arguments and fills the offsets as (dz, dy, dx) =
// (dy, 0, dx) of a stack of one-row planes; false on a bad argument.
bool offsets_of(int batch, int height, int width, int levels, int copies, int tile_h,
                const int* dy, const int* dx, int n_off, glcm::march::Offsets& offs) {
  if (batch < 0 || height < 0 || width < 0 || levels < 1 || levels > 65535 || copies < 1 ||
      tile_h < 1 || n_off < 1 || n_off > kMaxOffsets) {
    return false;
  }
  offs.n = n_off;
  for (int k = 0; k < n_off; ++k) {
    if (dy[k] < 0) return false;
    offs.dz[k] = dy[k];
    offs.dy[k] = 0;
    offs.dx[k] = dx[k];
  }
  return true;
}

}  // namespace

extern "C" {

// Votes a (batch, height, width) stack into out (batch, n_off, levels,
// levels) int32, which the caller has zeroed. `kind` says what `img` holds:
// 0 int32 levels (quant null), 1 float32 or 2 uint8 raw values binned with
// quant[2b], quant[2b+1] = (lo, span) of image b. Offsets need
// 0 <= dy[k] <= tile_h and |dx[k]| < width (the wrapper checks). Launches
// on `stream` and does not synchronise. Returns cudaGetLastError()
// (0 = launched); cudaErrorInvalidConfiguration when the offsets' halo does
// not fit in shared memory.
int glcm_fused_launch(const void* img, int kind, const float* quant, int* out, int batch,
                      int height, int width, int levels, int copies, int tile_h, const int* dy,
                      const int* dx, int n_off, void* stream) {
  glcm::march::Offsets offs;
  if (!offsets_of(batch, height, width, levels, copies, tile_h, dy, dx, n_off, offs) ||
      (kind == glcm::march::kLevels) != (quant == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || height == 0 || width == 0) return 0;
  cudaGetLastError();  // start from a clean error state
  return glcm::march::run(img, kind, quant, out, batch, height, 1, width, levels, copies, tile_h,
                          offs, static_cast<cudaStream_t>(stream), nullptr);
}

// The launch glcm_fused_launch would make for these arguments, without
// launching: info as glcm_volume_plan gives it.
int glcm_fused_plan(int kind, int batch, int height, int width, int levels, int copies,
                    int tile_h, const int* dy, const int* dx, int n_off, int* info) {
  glcm::march::Offsets offs;
  if (!offsets_of(batch, height, width, levels, copies, tile_h, dy, dx, n_off, offs) ||
      batch == 0 || height == 0 || width == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaGetLastError();
  return glcm::march::run(nullptr, kind, nullptr, nullptr, batch, height, 1, width, levels,
                          copies, tile_h, offs, nullptr, info);
}

const char* glcm_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
