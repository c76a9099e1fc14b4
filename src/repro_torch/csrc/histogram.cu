// Exact level histogram for Hopper (sm_90a), behind a plain C interface.
//
// Replaces the TPU kernel repro/kernels/histogram_kernel.py::histogram_pallas
// (_hist_kernel): flat int32 values -> (L,) int32 counts, out[v] += 1 for
// every value v in [0, L). Any other value (the -1 pad included) is not
// counted, as the TPU kernel's one-hot compare drops it.
//
// Design (the paper's Scheme 2, as in glcm_vote.cu): the TPU kernel counts
// by a one-hot compare and sum per chunk and carries its (1, L) accumulator
// across sequential grid steps. Blocks of a GPU grid run in any order, so
// each block instead walks its chunks in a grid-stride loop, counting into
// `copies` (R) private L-bin sub-histograms in shared memory with atomicAdd,
// and merges them into the output with global atomicAdd when it exits. Lane
// l of a warp counts into copy l % R, so R splits the conflicts of lanes
// that count the same level; copies sit L+1 words apart, so one level of
// different copies falls in different banks. One unsigned compare drops
// every value outside [0, L) before any atomic. The wrapper zeroes the
// output and never launches on an empty input.
//
// What bounds it: each value is 4 bytes read once, so the floor is the
// input bytes over the memory rate. On a smooth image many lanes of a warp
// count the same level and the shared-memory atomics serialise, which R
// relieves; warp-aggregated counting (__match_any_sync) and vectorised
// loads are later work.
//
// Large L: R is lowered to the number of copies that fit in a block's
// shared memory (opted in above 48 KiB); when not even one copy fits
// (L above ~58 000), the kernel counts straight into the output with
// global atomics. R never changes the counts.

#include <cuda_runtime.h>

#include "glcm_common.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
histogram_kernel(const int* __restrict__ values, int* __restrict__ out, long long n,
                 int levels, int copies, int chunk) {
  extern __shared__ int hist[];
  const int copy_stride = levels + 1;

  if (kShared) {
    for (int i = threadIdx.x; i < copies * copy_stride; i += blockDim.x) hist[i] = 0;
    __syncthreads();
  }
  int* mine = kShared ? hist + (threadIdx.x % 32 % copies) * copy_stride : out;

  const long long step = static_cast<long long>(gridDim.x) * chunk;
  for (long long start = static_cast<long long>(blockIdx.x) * chunk; start < n;
       start += step) {
    const long long end = min(start + chunk, n);
    for (long long i = start + threadIdx.x; i < end; i += blockDim.x) {
      const int v = __ldg(values + i);
      if (glcm::votes(v, levels)) atomicAdd(mine + v, 1);
    }
  }

  if (kShared) {
    __syncthreads();
    for (int c = threadIdx.x; c < levels; c += blockDim.x) {
      int v = 0;
      for (int k = 0; k < copies; ++k) v += hist[k * copy_stride + c];
      if (v) atomicAdd(out + c, v);
    }
  }
}

}  // namespace

extern "C" {

// Counts n int32 values into out (levels,) int32, which the caller has
// zeroed. Launches on `stream` and does not synchronise. Returns
// cudaGetLastError() (0 = launched).
int histogram_launch(const int* values, int* out, long long n, int levels, int copies,
                     int chunk, void* stream) {
  if (n < 0 || levels < 1 || copies < 1 || chunk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  cudaGetLastError();  // start from a clean error state
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long copy_bytes = (static_cast<long long>(levels) + 1) * 4;
  const int max_smem = glcm::device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  const long long fit = max_smem / copy_bytes;
  const int sms = glcm::device_attr(cudaDevAttrMultiProcessorCount);
  const long long chunks = (n + chunk - 1) / chunk;

  if (fit >= 1) {
    const int r = copies < fit ? copies : static_cast<int>(fit);
    const size_t smem = static_cast<size_t>(r * copy_bytes);
    cudaError_t e = glcm::allow_smem(histogram_kernel<true>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, histogram_kernel<true>, kThreads,
                                                  smem);
    if (per_sm < 1) per_sm = 1;
    long long gx = static_cast<long long>(per_sm) * sms;
    if (gx > chunks) gx = chunks;
    histogram_kernel<true><<<static_cast<unsigned>(gx), kThreads, smem, s>>>(
        values, out, n, levels, r, chunk);
  } else {
    long long gx = 4LL * sms;
    if (gx > chunks) gx = chunks;
    histogram_kernel<false><<<static_cast<unsigned>(gx), kThreads, 0, s>>>(
        values, out, n, levels, 1, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* histogram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
