// Pair-stream GLCM voting for Hopper (sm_90a), behind a plain C interface.
//
// Replaces the TPU kernel repro/kernels/glcm_kernel.py::glcm_vote_pallas
// (_vote_kernel / _vote_matmul): (B, N) int32 assoc/ref streams -> (B, L, L)
// int32 counts, out[b, ref, assoc] += 1 for every pair whose two levels lie
// in [0, L). Any other value (the -1 pad included) does not vote, as the
// TPU kernel's one-hot compare drops it.
//
// Design (the paper's Scheme 2): the TPU kernel votes by one-hot matmul
// because the TPU has no fast atomics and carries its accumulator across
// sequential grid steps. Blocks of a GPU grid run in any order, so each
// block instead votes its slice of one image's stream into `copies` (R)
// private L x L sub-histograms in shared memory with atomicAdd and merges
// them into the output with global atomicAdd when it exits. Lane l of a
// warp votes into copy l % R, so R splits the conflicts of lanes that vote
// the same cell; copies sit L*L+1 words apart, so one cell of different
// copies falls in different banks. The wrapper zeroes the output.
//
// What bounds it: each vote reads 8 bytes, so the floor is the stream bytes
// over the memory rate; on smooth images many lanes hit one cell and the
// shared-memory atomics serialise, which R relieves.
//
// Large L: one L*L int32 copy exceeds a block's shared memory above L = 238
// (256 KiB at L = 256). When even one copy does not fit, the kernel votes
// straight into the output with global atomics. Otherwise R is lowered to
// the number of copies that fit; R never changes the counts.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
vote_kernel(const int* __restrict__ assoc, const int* __restrict__ ref,
            int* __restrict__ out, long long n, int levels, int copies,
            int chunk) {
  extern __shared__ int hist[];
  const int cells = levels * levels;
  const int copy_stride = cells + 1;
  const int b = blockIdx.y;
  int* out_b = out + static_cast<long long>(b) * cells;

  if (kShared) {
    for (int i = threadIdx.x; i < copies * copy_stride; i += blockDim.x) hist[i] = 0;
    __syncthreads();
  }
  int* mine = kShared ? hist + (threadIdx.x % 32 % copies) * copy_stride : out_b;

  const int* a_row = assoc + static_cast<long long>(b) * n;
  const int* r_row = ref + static_cast<long long>(b) * n;
  const long long step = static_cast<long long>(gridDim.x) * chunk;
  for (long long start = static_cast<long long>(blockIdx.x) * chunk; start < n;
       start += step) {
    const long long end = min(start + chunk, n);
    for (long long i = start + threadIdx.x; i < end; i += blockDim.x) {
      const int a = __ldg(a_row + i);
      const int r = __ldg(r_row + i);
      if (static_cast<unsigned>(a) < static_cast<unsigned>(levels) &&
          static_cast<unsigned>(r) < static_cast<unsigned>(levels)) {
        atomicAdd(mine + r * levels + a, 1);
      }
    }
  }

  if (kShared) {
    __syncthreads();
    for (int c = threadIdx.x; c < cells; c += blockDim.x) {
      int v = 0;
      for (int k = 0; k < copies; ++k) v += hist[k * copy_stride + c];
      if (v) atomicAdd(out_b + c, v);
    }
  }
}

int device_attr(cudaDeviceAttr attr) {
  int dev = 0, value = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&value, attr, dev);
  return value;
}

}  // namespace

extern "C" {

// Votes (batch, n) int32 streams into out (batch, levels, levels) int32,
// which the caller has zeroed. Launches on `stream` and does not
// synchronise. Returns cudaGetLastError() (0 = launched).
int glcm_vote_launch(const int* assoc, const int* ref, int* out, int batch,
                     long long n, int levels, int copies, int chunk,
                     void* stream) {
  if (batch < 0 || n < 0 || levels < 1 || copies < 1 || chunk < 1 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || n == 0) return 0;
  cudaGetLastError();  // start from a clean error state
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long copy_bytes = (static_cast<long long>(levels) * levels + 1) * 4;
  const int max_smem = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  const int fit = static_cast<int>(max_smem / copy_bytes);
  const int sms = device_attr(cudaDevAttrMultiProcessorCount);
  const long long chunks = (n + chunk - 1) / chunk;

  if (fit >= 1) {
    const int r = copies < fit ? copies : fit;
    const size_t smem = static_cast<size_t>(r * copy_bytes);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(vote_kernel<true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vote_kernel<true>, kThreads, smem);
    if (per_sm < 1) per_sm = 1;
    long long gx = (static_cast<long long>(per_sm) * sms + batch - 1) / batch;
    if (gx > chunks) gx = chunks;
    dim3 grid(static_cast<unsigned>(gx), batch);
    vote_kernel<true><<<grid, kThreads, smem, s>>>(assoc, ref, out, n, levels, r, chunk);
  } else {
    long long gx = (4LL * sms + batch - 1) / batch;
    if (gx > chunks) gx = chunks;
    dim3 grid(static_cast<unsigned>(gx), batch);
    vote_kernel<false><<<grid, kThreads, 0, s>>>(assoc, ref, out, n, levels, 1, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* glcm_vote_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
