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
// the kernel reads each window in place and no patch is copied. An
// extracted, contiguous patch grid is the same description with other
// strides. Values are int32 levels, or raw float32 or uint8 values plus a
// (B, 2) float32 (lo, span) per image: every window of an image bins with
// that image's range, by glcm::bin_level (uint8 through a 256-entry table
// of it, glcm_march.cuh's Binner). A level outside [0, L), the -1 pad
// included, never votes.
//
// What bounds it: the output. At the texture-map size (65 025 windows of
// 32 x 32 at stride 16, four offsets, L = 32) the counts are 1.07 GB of
// int32 against a 67 MB image (17 MB as uint8): the floor is writing the
// counts once, 0.32 ms at 3.35 TB/s. The votes (3 633 a window, 236 M in
// all) are fewer than the fused kernel's. On the H100 the kernel's two
// halves each take most of its time alone — the stores of the slots, and
// the staging and votes — and overlap (PERF.md, tools/window_variants.py).
//
// Design (the staged path). Blocks are persistent, one per resident slot;
// block p takes the p-th of equal contiguous spans of the windows (image,
// grid row, grid column order) and walks them in runs of up to kRunWindows
// windows along one grid row. A run's pixels — rh rows of
// (n - 1) * sw + rw columns, where neighbouring windows overlap (sw < rw) —
// are loaded once (16-byte loads of float32 and int32 where aligned, 4-byte
// loads of uint8), binned once, and kept in shared memory as uint8 levels
// with a no-vote sentinel (255 >= L) for int32 levels outside [0, L). Where
// windows do not overlap (stride >= width, or a patch grid) a run is one
// window. The vote loop then reads shared memory only: a thread takes four
// consecutive associates of a window row in one funnel-shifted 32-bit read
// and each offset's four references in another, masks the lanes whose pair
// leaves the window, and adds one shared atomicAdd per vote.
//
// Two shared slots (kSlots) of n_off L x L int32 alternate between
// windows: window w votes into one slot while the store of window w - 1
// drains from the other. The store is one asynchronous bulk copy shared ->
// global (cp.async.bulk ... bulk_group, evict-first in L2) issued by one
// thread, which waits only until the copy has read its slot
// (wait_group.read) before that slot is zeroed again, one window later.
// Each window's slot belongs to it alone, as the TPU kernel's output block
// belongs to one grid cell: no global atomic and no zero fill of the output
// — the wrapper allocates it with torch.empty. `copies` (R) private sets per
// slot are merged into the first before the store; R never changes the
// counts.
//
// The direct path, where two slots and the stage do not fit in a block's
// shared memory (n_off * L * L int32 above ~110 KiB, e.g. L = 256, or
// windows too large to stage), or where a slot is not whole 16-byte units
// for the bulk copy (odd L with n_off not a multiple of 4): one block per
// window reads and bins its pixels straight from device memory, votes into
// `copies` shared sets if one fits and then stores them, or else zeroes its
// own output slot, synchronises, and votes into it with global atomics.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "glcm_march.cuh"

namespace {

using glcm::march::Binner;
using glcm::march::kByte;
using glcm::march::kFloat;
using glcm::march::kLevels;

constexpr int kThreads = 256;
constexpr int kMaxOffsets = 64;
constexpr int kRunWindows = 16;  // windows a block stages at once along a grid row
constexpr int kSlots = 2;       // shared output slots a block cycles through
constexpr int kLutBytes = 256;  // after the stage: the levels of the 256 uint8 values

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

// The staged path's shared-memory layout: [slot 0][slot 1][stage][table],
// each slot `copies` sets of set_len int32.
struct Stage {
  int run;          // windows per run (1 where windows do not overlap in a row)
  int pitch;        // bytes per staged row, a multiple of 16
  int front;        // bytes before staged row 0 (reads at dx < 0 stay inside)
  int stage_bytes;  // front + rh * pitch + the pad after the last row
  int set_len;      // int32 a set: n_off * L * L, a multiple of 4
  int copies;
  long long total;  // windows in all, batch * gh * gw
};

// --- asynchronous bulk store (sm_90) ----------------------------------------

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from shared `src` to global `dst`, marked evict-first in L2: the counts
// are written once and not read again by this kernel.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(src));
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;"
               :: "l"(dst), "r"(s), "r"(bytes), "l"(policy) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Until all but the `kPending` newest bulk stores this thread issued have
// read their shared sources.
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" :: "n"(kPending) : "memory");
}

// Until every bulk store this thread issued is complete.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// --- the staged path --------------------------------------------------------

// The four staged levels from byte `at` of the stage on (at may be
// negative or past a row: the masked lanes read the pads), as one word.
__device__ __forceinline__ unsigned four_levels(const unsigned char* stage, int at) {
  const unsigned* w = reinterpret_cast<const unsigned*>(stage) + (at >> 2);
  return __funnelshift_r(w[0], w[1], (at & 3) * 8);
}

// Loads and bins the run's rh x width pixels from img[base] on into the
// stage, four columns a unit: one aligned vector load where the unit is
// whole (16 bytes of float32 or int32, 4 of uint8), else one load a value.
template <typename In>
__device__ __forceinline__ void load_stage(const In* __restrict__ img, long long base,
                                           long long row_stride, int rh, int width, int pitch,
                                           unsigned char* stage, const Binner<uint8_t>& bn) {
  const int per_row = (width + 3) >> 2;
  const int units = rh * per_row;
  for (int u = threadIdx.x; u < units; u += kThreads) {
    const int y = u / per_row;
    const int c = (u - y * per_row) * 4;
    const In* p = img + base + y * row_stride + c;
    In v[4];
    if (c + 4 <= width && (reinterpret_cast<uintptr_t>(p) & (4 * sizeof(In) - 1)) == 0) {
      if constexpr (sizeof(In) == 4) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
        const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (std::is_same<In, float>::value) v[e] = __uint_as_float(w[e]);
          else v[e] = static_cast<In>(w[e]);
        }
      } else {
        const unsigned q = __ldg(reinterpret_cast<const unsigned*>(p));
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = static_cast<In>((q >> (8 * e)) & 0xffu);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = c + e < width ? __ldg(p + e) : In(0);
    }
    unsigned word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const unsigned lv = c + e < width ? glcm::march::level<In, uint8_t>(v[e], bn) : 0xffu;
      word |= lv << (8 * e);
    }
    reinterpret_cast<unsigned*>(stage + y * pitch)[c >> 2] = word;
  }
}

// Votes the window whose first staged column is `col` into `mine`.
__device__ __forceinline__ void vote_window(const unsigned char* stage, int* mine,
                                            const Windows& g, const Stage& st,
                                            const Offsets& offs, int levels, int col) {
  const int cells = levels * levels;
  const int per_row = (g.rw + 3) >> 2;
  const int items = g.rh * per_row;
  for (int v = threadIdx.x; v < items; v += kThreads) {
    const int y = v / per_row;
    const int x0 = (v - y * per_row) * 4;
    const int at = y * st.pitch + col + x0;
    const unsigned aw = four_levels(stage, at);
    int a[4];
    unsigned voting = 0;  // bit i: associate x0 + i lies in the window and votes
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = (aw >> (8 * i)) & 0xff;
      voting |= static_cast<unsigned>(x0 + i < g.rw && a[i] < levels) << i;
    }
    if (!voting) continue;
    for (int k = 0; k < offs.n; ++k) {
      const int dy = offs.dy[k], dx = offs.dx[k];
      if (y + dy >= g.rh) continue;
      // Lanes i with 0 <= x0 + i + dx < rw: bits [lo, hi).
      const int lo = min(4, max(0, -x0 - dx));
      const int hi = max(0, min(4, g.rw - x0 - max(dx, 0)));
      const unsigned m = voting & ((1u << hi) - 1u) & ~((1u << lo) - 1u);
      if (!m) continue;
      const unsigned rl = four_levels(stage, at + dy * st.pitch + dx);
      int* hk = mine + k * cells;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = (rl >> (8 * i)) & 0xff;
        if ((m >> i & 1u) && r < levels) atomicAdd(hk + r * levels + a[i], 1);
      }
    }
  }
}

template <typename In>
__global__ void __launch_bounds__(kThreads, 4)
staged_kernel(const In* __restrict__ img, const float* __restrict__ quant, int* __restrict__ out,
              const Windows g, const Stage st, const int levels, const Offsets offs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int slot_ints = st.copies * st.set_len;
  int* slots = reinterpret_cast<int*>(smem);
  unsigned char* stage = smem + kSlots * slot_ints * 4 + st.front;
  uint8_t* lut = smem + kSlots * slot_ints * 4 + st.stage_bytes;
  const int slot_len = offs.n * levels * levels;
  const long long first = blockIdx.x * st.total / gridDim.x;
  const long long last = (blockIdx.x + 1) * st.total / gridDim.x;

  const int4 zero = make_int4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < slot_ints / 4; i += kThreads) {
    reinterpret_cast<int4*>(slots)[i] = zero;
  }
  Binner<uint8_t> bn{0.0f, 1.0f, levels, lut};
  int image = -1, j0 = 0, s = 0;
  long long run_end = first;
  for (long long w = first; w < last; ++w) {
    const int b = static_cast<int>(w / g.n_win);
    const int wi = static_cast<int>(w - static_cast<long long>(b) * g.n_win);
    const int i = wi / g.gw;
    const int j = wi - i * g.gw;
    if (w == run_end) {
      // A new run: the stage was last read before the previous barrier.
      if (b != image) {
        float lo = 0.0f, span = 1.0f;
        if constexpr (!std::is_same<In, int>::value) {
          lo = quant[2 * b];
          span = quant[2 * b + 1];
        }
        bn = glcm::march::make_binner<In, uint8_t>(lo, span, levels, lut);
        if constexpr (std::is_same<In, uint8_t>::value) __syncthreads();  // the table
        image = b;
      }
      const int m = static_cast<int>(min(static_cast<long long>(min(st.run, g.gw - j)),
                                         last - w));
      run_end = w + m;
      j0 = j;
      const long long base = b * g.image_stride + i * g.grid_row_stride + j * g.grid_col_stride;
      load_stage<In>(img, base, g.row_stride, g.rh,
                     static_cast<int>((m - 1) * g.grid_col_stride) + g.rw, st.pitch, stage, bn);
    }
    __syncthreads();  // the stage and slot s are ready
    int* slot = slots + s * slot_ints;
    vote_window(stage, slot + (threadIdx.x % 32 % st.copies) * st.set_len, g, st, offs, levels,
                static_cast<int>((j - j0) * g.grid_col_stride));
    if (st.copies > 1) {
      __syncthreads();
      for (int c = threadIdx.x; c < slot_len; c += kThreads) {
        int v = slot[c];
        for (int r = 1; r < st.copies; ++r) v += slot[r * st.set_len + c];
        slot[c] = v;
      }
    }
    fence_async_shared();  // this thread's votes, visible to the bulk copy
    // The store of window w + 1 - kSlots has read the slot window w + 1 takes.
    if (threadIdx.x == 0) bulk_wait_read<kSlots - 2>();
    __syncthreads();  // slot s holds window w's counts; the next slot is free
    int* dst = out + w * slot_len;
    if (threadIdx.x == 0) bulk_store(dst, slot, static_cast<unsigned>(slot_len) * 4u);
    s = s + 1 == kSlots ? 0 : s + 1;
    int4* next = reinterpret_cast<int4*>(slots + s * slot_ints);
    for (int c = threadIdx.x; c < slot_ints / 4; c += kThreads) next[c] = zero;
  }
  if (threadIdx.x == 0) bulk_wait_all();
}

// --- the direct path --------------------------------------------------------

template <typename In>
__device__ __forceinline__ int direct_level(const In* img, long long i, float lo, float span,
                                            int levels) {
  if constexpr (std::is_same<In, int>::value) return __ldg(img + i);
  else return glcm::bin_level(static_cast<float>(__ldg(img + i)), lo, span, levels);
}

template <typename In, bool kShared>
__global__ void __launch_bounds__(kThreads)
direct_kernel(const In* __restrict__ img, const float* __restrict__ quant, int* __restrict__ out,
              Windows g, int levels, int copies, Offsets offs) {
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
  if constexpr (!std::is_same<In, int>::value) {
    lo = quant[2 * b];
    span = quant[2 * b + 1];
  }
  const long long base = b * g.image_stride + gi * g.grid_row_stride + gj * g.grid_col_stride;
  const int pixels = g.rh * g.rw;
  for (int p = threadIdx.x; p < pixels; p += blockDim.x) {
    const int y = p / g.rw;
    const int x = p - y * g.rw;
    const int a = direct_level<In>(img, base + y * g.row_stride + x, lo, span, levels);
    if (!glcm::votes(a, levels)) continue;
    for (int k = 0; k < n_off; ++k) {
      const int yy = y + offs.dy[k];
      const int xx = x + offs.dx[k];
      if (yy >= g.rh || xx < 0 || xx >= g.rw) continue;
      const int r = direct_level<In>(img, base + yy * g.row_stride + xx, lo, span, levels);
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

// --- host side --------------------------------------------------------------

// What a launch would be, for reports: filled when `info` is given.
enum Info : int {
  kPath, kBlocksPerSm, kSmem, kCopies, kRun, kGrid, kRegisters, kLocalBytes, kInfoLen
};
// kPath: 0 staged, 1 direct into shared sets, 2 direct with global atomics.

inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

// The staged layout for `g`, or false where it does not fit or a slot is
// not whole 16-byte units: `copies` is lowered to the sets that fit, then
// the run halved, down to one set and one window.
bool plan_stage(const Windows& g, int levels, int copies, int n_off, long long total,
                int max_smem, Stage& st) {
  if (levels > 255) return false;  // uint8 levels with sentinel 255
  st.set_len = n_off * levels * levels;
  if (st.set_len % 4 != 0) return false;  // one bulk copy stores 16-byte units
  const bool overlap = g.grid_col_stride > 0 && g.grid_col_stride < g.rw;
  st.run = overlap ? kRunWindows : 1;
  st.copies = copies;
  st.total = total;
  st.front = round_up(g.rw + 3, 16);
  for (;;) {
    const long long width = (st.run - 1) * g.grid_col_stride + g.rw;
    const long long pitch = (width + 15) / 16 * 16;
    const long long stage = st.front + g.rh * pitch + round_up(g.rw + 8, 16);
    const long long need = 1LL * kSlots * st.copies * st.set_len * 4 + stage + kLutBytes;
    if (need <= max_smem) {
      st.pitch = static_cast<int>(pitch);
      st.stage_bytes = static_cast<int>(stage);
      return true;
    }
    if (st.copies > 1) --st.copies;
    else if (st.run > 1) st.run /= 2;
    else return false;
  }
}

template <typename Kernel>
int report(Kernel kernel, int path, int per_sm, int smem, int copies, int run, long long grid,
           int* info) {
  cudaFuncAttributes attr;
  cudaFuncGetAttributes(&attr, kernel);
  const int values[kInfoLen] = {path, per_sm, smem, copies, run, static_cast<int>(grid),
                                attr.numRegs, static_cast<int>(attr.localSizeBytes)};
  for (int i = 0; i < kInfoLen; ++i) info[i] = values[i];
  return static_cast<int>(cudaGetLastError());
}

template <typename In>
int launch_staged(const void* img, const float* quant, int* out, const Windows& g,
                  const Stage& st, int levels, const Offsets& offs, cudaStream_t s, int* info) {
  auto kernel = staged_kernel<In>;
  const int smem = kSlots * st.copies * st.set_len * 4 + st.stage_bytes + kLutBytes;
  const cudaError_t e = glcm::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (per_sm < 1) per_sm = 1;
  const long long slots =
      static_cast<long long>(per_sm) * glcm::device_attr(cudaDevAttrMultiProcessorCount);
  const long long grid = st.total < slots ? st.total : slots;
  if (info != nullptr) {
    return report(kernel, 0, per_sm, smem, st.copies, st.run, grid, info);
  }
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, s>>>(
      static_cast<const In*>(img), quant, out, g, st, levels, offs);
  return static_cast<int>(cudaGetLastError());
}

template <typename In, bool kShared>
int launch_direct(const void* img, const float* quant, int* out, long long blocks,
                  const Windows& g, int levels, int copies, const Offsets& offs, size_t smem,
                  cudaStream_t s, int* info) {
  auto kernel = direct_kernel<In, kShared>;
  const cudaError_t e = glcm::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (info != nullptr) {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    return report(kernel, kShared ? 1 : 2, per_sm, static_cast<int>(smem), copies, 1, blocks,
                  info);
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      static_cast<const In*>(img), quant, out, g, levels, copies, offs);
  return static_cast<int>(cudaGetLastError());
}

template <typename In>
int run(const void* img, const float* quant, int* out, long long total, const Windows& g,
        int levels, int copies, const Offsets& offs, cudaStream_t s, int* info) {
  const int max_smem = glcm::device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  Stage st;
  if (plan_stage(g, levels, copies, offs.n, total, max_smem, st)) {
    return launch_staged<In>(img, quant, out, g, st, levels, offs, s, info);
  }
  const long long set_bytes = (static_cast<long long>(offs.n) * levels * levels + 1) * 4;
  const int fit = static_cast<int>(max_smem / set_bytes);
  if (fit >= 1) {
    const int r = copies < fit ? copies : fit;
    return launch_direct<In, true>(img, quant, out, total, g, levels, r, offs,
                                   static_cast<size_t>(r * set_bytes), s, info);
  }
  return launch_direct<In, false>(img, quant, out, total, g, levels, 1, offs, 0, s, info);
}

int dispatch(const void* img, int kind, const float* quant, int* out, int batch, int gh, int gw,
             int rh, int rw, long long image_stride, long long grid_row_stride,
             long long grid_col_stride, long long row_stride, int levels, int copies,
             const int* dy, const int* dx, int n_off, cudaStream_t s, int* info) {
  if (batch < 0 || gh < 0 || gw < 0 || rh < 1 || rw < 1 || levels < 1 || copies < 1 ||
      n_off < 1 || n_off > kMaxOffsets || (kind == kLevels) != (quant == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = static_cast<long long>(batch) * gh * gw;
  if (total == 0) return info != nullptr ? static_cast<int>(cudaErrorInvalidValue) : 0;
  if (total > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // start from a clean error state
  Offsets offs;
  offs.n = n_off;
  for (int k = 0; k < n_off; ++k) {
    if (dy[k] < 0 || dy[k] >= rh || dx[k] <= -rw || dx[k] >= rw) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    offs.dy[k] = dy[k];
    offs.dx[k] = dx[k];
  }
  const Windows g{gh * gw, gw, rh, rw, image_stride, grid_row_stride, grid_col_stride,
                  row_stride};
  switch (kind) {
    case kLevels: return run<int>(img, quant, out, total, g, levels, copies, offs, s, info);
    case kFloat: return run<float>(img, quant, out, total, g, levels, copies, offs, s, info);
    case kByte: return run<uint8_t>(img, quant, out, total, g, levels, copies, offs, s, info);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Votes the (batch, gh, gw, rh, rw) window grid of `img` — element (b, i, j,
// y, x) at b*image_stride + i*grid_row_stride + j*grid_col_stride +
// y*row_stride + x — into out (batch, gh, gw, n_off, levels, levels) int32.
// Every element of `out` is written; the caller need not zero it. `kind`
// says what `img` holds: 0 int32 levels (quant null), 1 float32 or 2 uint8
// raw values binned with quant[2b], quant[2b+1] = (lo, span) of image b.
// Offsets need 0 <= dy[k] < rh and |dx[k]| < rw. Launches on `stream` and
// does not synchronise. Returns cudaGetLastError() (0 = launched).
int glcm_window_launch(const void* img, int kind, const float* quant, int* out, int batch,
                       int gh, int gw, int rh, int rw, long long image_stride,
                       long long grid_row_stride, long long grid_col_stride,
                       long long row_stride, int levels, int copies, const int* dy,
                       const int* dx, int n_off, void* stream) {
  return dispatch(img, kind, quant, out, batch, gh, gw, rh, rw, image_stride, grid_row_stride,
                  grid_col_stride, row_stride, levels, copies, dy, dx, n_off,
                  static_cast<cudaStream_t>(stream), nullptr);
}

// The launch glcm_window_launch would make for these arguments (the
// strides of a (batch, H, W) image or a patch grid), without launching:
// info[0..7] = path (0 staged, 1 direct into shared sets, 2 direct with
// global atomics), blocks per SM, shared bytes, copies, windows per run,
// grid, registers, local bytes.
int glcm_window_plan(int kind, int batch, int gh, int gw, int rh, int rw,
                     long long image_stride, long long grid_row_stride,
                     long long grid_col_stride, long long row_stride, int levels, int copies,
                     const int* dy, const int* dx, int n_off, int* info) {
  const float unit[2] = {0.0f, 1.0f};
  return dispatch(nullptr, kind, kind == kLevels ? nullptr : unit, nullptr, batch, gh, gw, rh,
                  rw, image_stride, grid_row_stride, grid_col_stride, row_stride, levels,
                  copies, dy, dx, n_off, nullptr, info);
}

const char* glcm_window_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
