// f1-f13 of the Haralick features for Hopper (sm_90a), behind a plain C
// interface: for a batch of L x L int32 GLCM counts, 2 <= L <= 1024, the
// normalized joint probabilities P and the thirteen O(L^2) features of
// core/haralick.py in float64; where f14 is asked for, also P and its
// marginals px, py, which f14's eigensolver (haralick_mcc.cu) reads.
//
// Replaces no TPU kernel. The reference computes these features with jnp
// over the whole batch (src/repro/core/haralick.py); the port did the same
// in PyTorch: about 140 elementwise, reduce and index_add_ launches on
// float64 copies of every matrix. On a texture map's 260 100 matrices that
// took ~43 ms of a ~58 ms map on the H100; on the 32 matrices of a stack of
// 8 images, ~2 ms of the host's dispatch a call.
//
// Arithmetic: the PyTorch tail's, step for step (kernels/tail_kernel.py's
// plain version). The count total is exact (an integer sum in float64, below
// 2^53). Mode 0, counts the features normalize themselves:
// p = c / max(total, 1e-12) in float64. Mode 1, after the plan's float32
// normalization: p32 = float(c) / float(max(total, 1)) in float32 (IEEE
// division; a total below 2^24 is exact in float32), then
// p = p32 / max(sum p32, 1e-12) in float64. Then the marginals, the means
// and variances, p_{x+y} and p_{x-y}, and f1-f13 with every guard of
// core/haralick.py: 1e-12 inside each log, the clamps, and f3 = 0 unless
// each marginal holds mass on two levels or more (for non-negative counts
// that is the test (px @ d2 * px).sum() > 0 makes). A log whose term has a
// zero factor is skipped: the term is exactly 0 there too. Every sum takes
// a fixed order and no atomics, so two launches on the same counts give the
// same bits; the warp sums are butterflies, after which every lane holds
// the same bits.
//
// L <= 32 (haralick_tail_kernel): one warp a matrix, kWarps warps a block.
//   1. The warp reads the matrix's counts coalesced, element lane + 32 k
//      into register k, every load in flight at once, and sums them.
//   2. It scales them into P in its shared tile, rows at the odd stride
//      kStride, so that a lane a row and a lane a column both read without
//      bank conflicts, and, with f14, stores P coalesced.
//   3. Lane i sums row i (px_i) and column i (py_i), anti-diagonals i and
//      i + 32 (p_{x+y}) and diagonal i (p_{x-y}), and walks row i for the
//      per-entry sums: f1, sum i j p, the entropy f9 and HXY1 and HXY2,
//      which share one log(px_i py_j + 1e-12).
//   4. Warp sums of the level terms give the features; lane 0 stores them.
// 32 < L <= 1024 (haralick_tail_wide_kernel): one block a matrix; a 256 x
// 256 matrix of counts is 256 KiB, more than shared memory holds, so the
// block passes over the counts in L2, recomputing P from them each pass:
// the total (and, in mode 1, the sum of p32); px a warp a row; py, p_{x+y}
// and p_{x-y} into shared memory, a level a thread, consecutive threads on
// consecutive levels so that each row is read coalesced, and the rows split
// among groups of threads whose partial sums a level adds in order; the
// per-entry sums a thread an entry; then the level sums.
//
// Both kernels turn a count into P with a reciprocal and one exact FMA
// correction instead of an IEEE division (see scaled): the same bits, and
// on a texture map ~0.8 ms of ~2.6 ms less.
//
// What bounds it: it reads N L^2 int32 and writes 13 N doubles, with f14
// also N (L^2 + 2 L) doubles of P, px and py. On a texture map's 260 100
// 32 x 32 matrices with f14 that is 1.07 GB in and 2.16 GB out, 0.96 ms at
// 3.35 TB/s. Its float64 work is at most two logs an entry (f9's and the
// one HXY1 and HXY2 share) and a few dozen operations more; a libdevice log
// is ~20 float64 operations, so a map's dense random matrices need ~0.7 ms
// of the H100's 33.5 TFLOP/s outside the tensor cores: the bytes bound it
// unless the logs' latency is not hidden. Keeping P on chip, each count is
// read once; where the PyTorch tail wrote and read float64 copies of P
// dozens of times, this kernel writes P once, and only where f14 needs it.

#include <cuda_runtime.h>

#include "glcm_common.cuh"

namespace {

constexpr int kMax = 32;            // the largest L of the warp kernel: a lane a row
constexpr int kStride = kMax + 1;   // tile row stride in doubles: odd, no bank conflicts
constexpr int kWarps = 4;           // warps a block of the warp kernel
constexpr int kWideMax = 1024;      // the largest L of the block kernel
constexpr int kSums = 12;           // the most sums a block reduces at once
constexpr int kFeatures = 13;
constexpr unsigned kFull = 0xffffffffu;
constexpr double kEps = 1e-12;      // core/haralick.py's _EPS

struct alignas(16) WarpTile {
  double p[kMax * kStride];  // P, row r at r * kStride
  double py[kMax];           // the column marginal, read by every lane
};

__device__ __forceinline__ double warp_sum(double x) {
  // Butterfly: both lanes of a pair add the same two values, so every lane
  // ends with the same sum, bit for bit.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// p log(p + 1e-12), the term of an entropy; 0 where p is 0, as there.
__device__ __forceinline__ double plogp(double p) {
  return p != 0.0 ? p * log(p + kEps) : 0.0;
}

// A count before the float64 division: the count itself (mode 0) or its
// float32 probability p32 (mode 1).
template <int kMode>
__device__ __forceinline__ double unscaled(int c, float t32) {
  if (kMode == 0) return static_cast<double>(c);
  return static_cast<double>(__fdiv_rn(__int2float_rn(c), t32));
}

// The count as P: its unscaled value over s, correctly rounded, from
// rs = 1 / s (correctly rounded): q = a rs is within an ulp of a / s, the
// residual a - q s is exact in an FMA, and one correction step rounds the
// quotient correctly (Markstein's theorem), as IEEE division does, for a
// fraction of its cost.
template <int kMode>
__device__ __forceinline__ double scaled(int c, float t32, double s, double rs) {
  const double a = unscaled<kMode>(c, t32);
  const double q = a * rs;
  return fma(fma(-q, s, a), rs, q);
}

// The features from the matrix's sums, in FEATURE_NAMES' order.
struct Sums {
  double mu_x, mu_y, var_x, var_y, hx, hy;  // of the marginals
  bool spread;                              // both marginals on >= 2 levels
  double f1, sij, hxy, hxy1, hxy2;          // of the entries (sij = sum i j p)
  double f6, f7, f8sum;                     // of p_{x+y} (f8sum = sum p log p)
  double f2, f5, f10, f11sum;               // of p_{x-y}
};

__device__ __forceinline__ void store_features(const Sums& s, double* __restrict__ out) {
  const double sd = fmax(sqrt(fmax(s.var_x, 0.0)) * sqrt(fmax(s.var_y, 0.0)), kEps);
  out[0] = s.f1;
  out[1] = s.f2;
  out[2] = s.spread ? (s.sij - s.mu_x * s.mu_y) / sd : 0.0;
  out[3] = s.var_x;  // f4: sum (i - mu)^2 p with Haralick's mu = mu_x
  out[4] = s.f5;
  out[5] = s.f6;
  out[6] = s.f7;
  out[7] = -s.f8sum;
  out[8] = s.hxy;
  out[9] = s.f10;
  out[10] = -s.f11sum;
  out[11] = (s.hxy - s.hxy1) / fmax(fmax(s.hx, s.hy), kEps);
  out[12] = sqrt(fmax(1.0 - exp(-2.0 * (s.hxy2 - s.hxy)), 0.0));
}

// One warp a matrix (see the file's note). feats (n, 13); with p_out, also
// P (n, L, L), px_out and py_out (n, L).
template <int kMode>
__global__ void __launch_bounds__(kWarps * 32)
haralick_tail_kernel(const int* __restrict__ counts, double* __restrict__ feats,
                     double* __restrict__ p_out, double* __restrict__ px_out,
                     double* __restrict__ py_out, long long n, int levels) {
  __shared__ WarpTile tiles[kWarps];
  const int lane = threadIdx.x & 31;
  const long long m = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (m >= n) return;  // the whole warp: nothing below synchronizes the block
  WarpTile& w = tiles[threadIdx.x >> 5];
  const int L = levels, size = L * L;
  const int* c = counts + m * size;

  // 1. The counts, element e = lane + 32 k in v[k] (0 past the matrix).
  int v[kMax];
#pragma unroll
  for (int k = 0; k < kMax; ++k) {
    const int e = lane + 32 * k;
    v[k] = e < size ? __ldg(c + e) : 0;
  }
  double total = 0.0;  // exact: at most 2^41
#pragma unroll
  for (int k = 0; k < kMax; ++k) total += v[k];
  total = warp_sum(total);
  float t32 = 0.0f;
  double s;
  if (kMode == 0) {
    s = fmax(total, kEps);
  } else {
    t32 = __double2float_rn(fmax(total, 1.0));
    double part = 0.0;
#pragma unroll
    for (int k = 0; k < kMax; ++k) part += unscaled<1>(v[k], t32);
    s = fmax(warp_sum(part), kEps);
  }
  const double rs = 1.0 / s;

  // 2. P into the tile and, with f14, to p_out. (r, col) is element e's.
  double* pm = p_out != nullptr ? p_out + m * size : nullptr;
  int r = lane / L, col = lane - (lane / L) * L;
  const int dr = 32 / L, dc = 32 - (32 / L) * L;
#pragma unroll
  for (int k = 0; k < kMax; ++k) {
    if (lane + 32 * k < size) {
      const double p = scaled<kMode>(v[k], t32, s, rs);
      w.p[r * kStride + col] = p;
      if (pm != nullptr) pm[lane + 32 * k] = p;
    }
    r += dr;
    col += dc;
    if (col >= L) {
      col -= L;
      ++r;
    }
  }
  __syncwarp();

  // 3. Lane i: row i, column i and the per-entry sums of row i.
  const bool in = lane < L;
  const double lv = lane;  // the level
  double px = 0.0, py = 0.0;
  if (in) {
    for (int j = 0; j < L; ++j) px += w.p[lane * kStride + j];
    for (int j = 0; j < L; ++j) py += w.p[j * kStride + lane];
    w.py[lane] = py;
    if (pm != nullptr) {
      px_out[m * L + lane] = px;
      py_out[m * L + lane] = py;
    }
  }
  __syncwarp();
  double f1 = 0.0, rj = 0.0, hxy = 0.0, hxy1 = 0.0, hxy2 = 0.0;
  if (in) {
    for (int j = 0; j < L; ++j) {
      const double p = w.p[lane * kStride + j];
      const double q = px * w.py[j];
      f1 += p * p;
      rj += static_cast<double>(j) * p;
      if (p != 0.0 || q != 0.0) {
        const double lq = log(q + kEps);
        hxy1 -= p * lq;
        hxy2 -= q * lq;
      }
      hxy -= plogp(p);
    }
  }
  // p_{x+y}(k) for k = lane and lane + 32; p_{x-y}(k) for k = lane.
  double ps0 = 0.0, ps1 = 0.0, pd = 0.0;
  for (int a = max(0, lane - L + 1); a <= min(lane, L - 1); ++a) {
    ps0 += w.p[a * kStride + lane - a];
  }
  for (int a = max(0, lane + 32 - L + 1); a <= min(lane + 32, L - 1); ++a) {
    ps1 += w.p[a * kStride + lane + 32 - a];
  }
  if (in) {
    for (int a = 0; a + lane < L; ++a) {
      pd += w.p[a * kStride + a + lane];
      if (lane > 0) pd += w.p[(a + lane) * kStride + a];
    }
  }

  // 4. The sums over levels and entries.
  Sums t;
  t.mu_x = warp_sum(lv * px);
  t.mu_y = warp_sum(lv * py);
  t.hx = -warp_sum(plogp(px));
  t.hy = -warp_sum(plogp(py));
  t.spread = __popc(__ballot_sync(kFull, px > 0.0)) > 1 && __popc(__ballot_sync(kFull, py > 0.0)) > 1;
  t.var_x = warp_sum((lv - t.mu_x) * (lv - t.mu_x) * px);
  t.var_y = warp_sum((lv - t.mu_y) * (lv - t.mu_y) * py);
  t.f1 = warp_sum(f1);
  t.sij = warp_sum(lv * rj);
  t.hxy = warp_sum(hxy);
  t.hxy1 = warp_sum(hxy1);
  t.hxy2 = warp_sum(hxy2);
  const double k1 = lane + 32;
  t.f6 = warp_sum(lv * ps0 + k1 * ps1);
  t.f7 = warp_sum((lv - t.f6) * (lv - t.f6) * ps0 + (k1 - t.f6) * (k1 - t.f6) * ps1);
  t.f8sum = warp_sum(plogp(ps0) + plogp(ps1));
  const double dmean = warp_sum(lv * pd);
  t.f2 = warp_sum(lv * lv * pd);
  t.f5 = warp_sum(pd / (1.0 + lv * lv));
  t.f10 = warp_sum((lv - dmean) * (lv - dmean) * pd);
  t.f11sum = warp_sum(plogp(pd));
  if (lane == 0) store_features(t, feats + m * kFeatures);
}

// x[d] summed over the block for each d: every thread returns the same
// bits. red holds kSums * 32 doubles.
template <int D>
__device__ __forceinline__ void block_sums(double (&x)[D], double* red) {
  static_assert(D <= kSums, "red holds kSums sums");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
#pragma unroll
  for (int d = 0; d < D; ++d) x[d] = warp_sum(x[d]);
  __syncthreads();  // red is free
  if (lane == 0) {
#pragma unroll
    for (int d = 0; d < D; ++d) red[d * 32 + warp] = x[d];
  }
  __syncthreads();
#pragma unroll
  for (int d = 0; d < D; ++d) x[d] = warp_sum(lane < warps ? red[d * 32 + lane] : 0.0);
}

// One block a matrix (see the file's note). Dynamic shared memory: px, py
// (L each), p_{x+y} (2 L), p_{x-y} (L), kSums * 32 doubles of sums and a
// partial sum a thread.
template <int kMode>
__global__ void __launch_bounds__(kWideMax)
haralick_tail_wide_kernel(const int* __restrict__ counts, double* __restrict__ feats,
                          double* __restrict__ p_out, double* __restrict__ px_out,
                          double* __restrict__ py_out, int levels) {
  extern __shared__ double wide[];
  const int L = levels, size = L * L, t = threadIdx.x, nt = blockDim.x;
  const int lane = t & 31, warp = t >> 5, warps = nt >> 5;
  const long long m = blockIdx.x;
  const int* c = counts + m * size;
  double* px = wide;
  double* py = px + L;
  double* ps = py + L;
  double* pd = ps + 2 * L;
  double* red = pd + L;
  double* part = red + kSums * 32;

  // The total, and in mode 1 the sum of p32.
  double x1[1] = {0.0};
  for (int e = t; e < size; e += nt) x1[0] += __ldg(c + e);
  block_sums(x1, red);
  float t32 = 0.0f;
  double s;
  if (kMode == 0) {
    s = fmax(x1[0], kEps);
  } else {
    t32 = __double2float_rn(fmax(x1[0], 1.0));
    x1[0] = 0.0;
    for (int e = t; e < size; e += nt) x1[0] += unscaled<1>(__ldg(c + e), t32);
    block_sums(x1, red);
    s = fmax(x1[0], kEps);
  }
  const double rs = 1.0 / s;
  auto P = [&](int r, int j) { return scaled<kMode>(__ldg(c + r * L + j), t32, s, rs); };

  // A sum over rows for each of n levels, the threads of a level splitting
  // the rows into groups g = 0, 1, ... that the level adds in order; at(r,
  // k) is level k's term of row r (0 outside the matrix). Consecutive
  // threads take consecutive levels, so each row's terms are read
  // coalesced.
  auto level_sums = [&](int n, double* dst, auto at) {
    const int groups = max(1, nt / n);
    if (groups == 1) {
      for (int k = t; k < n; k += nt) {
        double a = 0.0;
        for (int r = 0; r < L; ++r) a += at(r, k);
        dst[k] = a;
      }
      return;
    }
    if (t < groups * n) {
      const int g = t / n, k = t - g * n;
      double a = 0.0;
      for (int r = g; r < L; r += groups) a += at(r, k);
      part[t] = a;
    }
    __syncthreads();
    for (int k = t; k < n; k += nt) {
      double a = 0.0;
      for (int g = 0; g < groups; ++g) a += part[g * n + k];
      dst[k] = a;
    }
    __syncthreads();  // part is free
  };

  // px a warp a row; py, p_{x+y} and p_{x-y} by level.
  for (int r = warp; r < L; r += warps) {
    double a = 0.0;
    for (int j = lane; j < L; j += 32) a += P(r, j);
    a = warp_sum(a);
    if (lane == 0) px[r] = a;
  }
  level_sums(L, py, [&](int r, int j) { return P(r, j); });
  level_sums(2 * L - 1, ps, [&](int r, int k) {
    return k - r >= 0 && k - r < L ? P(r, k - r) : 0.0;
  });
  level_sums(L, pd, [&](int r, int k) {  // row r's entry k right of the diagonal, and k left
    return (r + k < L ? P(r, r + k) : 0.0) + (k > 0 && r >= k ? P(r, r - k) : 0.0);
  });
  __syncthreads();

  // The per-entry sums, a thread an entry: f1, sum i j p, f9, HXY1, HXY2.
  double x5[5] = {0.0, 0.0, 0.0, 0.0, 0.0};
  double* pm = p_out != nullptr ? p_out + m * size : nullptr;
  for (int e = t; e < size; e += nt) {
    const int r = e / L, j = e - r * L;
    const double p = P(r, j);
    if (pm != nullptr) pm[e] = p;
    const double q = px[r] * py[j];
    x5[0] += p * p;
    x5[1] += static_cast<double>(r) * static_cast<double>(j) * p;
    if (p != 0.0 || q != 0.0) {
      const double lq = log(q + kEps);
      x5[3] -= p * lq;
      x5[4] -= q * lq;
    }
    x5[2] -= plogp(p);
  }
  if (pm != nullptr) {
    for (int i = t; i < L; i += nt) {
      px_out[m * L + i] = px[i];
      py_out[m * L + i] = py[i];
    }
  }
  block_sums(x5, red);

  // The level sums: those that need no mean, then those that do.
  double y[kSums] = {};
  for (int i = t; i < 2 * L - 1; i += nt) {
    const double lv = i;
    if (i < L) {
      y[0] += lv * px[i];
      y[1] += lv * py[i];
      y[2] += plogp(px[i]);
      y[3] += plogp(py[i]);
      y[4] += px[i] > 0.0 ? 1.0 : 0.0;
      y[5] += py[i] > 0.0 ? 1.0 : 0.0;
      y[8] += lv * pd[i];
      y[9] += lv * lv * pd[i];
      y[10] += pd[i] / (1.0 + lv * lv);
      y[11] += plogp(pd[i]);
    }
    y[6] += lv * ps[i];
    y[7] += plogp(ps[i]);
  }
  block_sums(y, red);
  Sums u;
  u.mu_x = y[0];
  u.mu_y = y[1];
  u.hx = -y[2];
  u.hy = -y[3];
  u.spread = y[4] > 1.0 && y[5] > 1.0;
  u.f6 = y[6];
  u.f8sum = y[7];
  const double dmean = y[8];
  u.f2 = y[9];
  u.f5 = y[10];
  u.f11sum = y[11];
  double z[4] = {0.0, 0.0, 0.0, 0.0};
  for (int i = t; i < 2 * L - 1; i += nt) {
    const double lv = i;
    if (i < L) {
      z[0] += (lv - u.mu_x) * (lv - u.mu_x) * px[i];
      z[1] += (lv - u.mu_y) * (lv - u.mu_y) * py[i];
      z[3] += (lv - dmean) * (lv - dmean) * pd[i];
    }
    z[2] += (lv - u.f6) * (lv - u.f6) * ps[i];
  }
  block_sums(z, red);
  u.var_x = z[0];
  u.var_y = z[1];
  u.f7 = z[2];
  u.f10 = z[3];
  u.f1 = x5[0];
  u.sij = x5[1];
  u.hxy = x5[2];
  u.hxy1 = x5[3];
  u.hxy2 = x5[4];
  if (t == 0) store_features(u, feats + m * kFeatures);
}

}  // namespace

extern "C" {

// f1-f13 of n matrices of counts (n, L, L), contiguous int32 on the card,
// into feats (n, 13) float64; with p (n, L, L), px and py (n, L) float64
// (all three or none), also P and its marginals. mode 0: P = counts over
// their total in float64; mode 1: after the float32 normalization first.
// 2 <= L <= 1024. Launches on `stream`, allocates nothing and does not
// synchronise. Returns cudaGetLastError() (0 = launched).
int haralick_tail_launch(const int* counts, double* feats, double* p, double* px, double* py,
                         long long n, int levels, int mode, void* stream) {
  if (n < 0 || levels < 2 || levels > kWideMax || (mode != 0 && mode != 1) ||
      (p == nullptr) != (px == nullptr) || (p == nullptr) != (py == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  cudaGetLastError();  // start from a clean error state
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (levels <= kMax) {
    const long long blocks = (n + kWarps - 1) / kWarps;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned grid = static_cast<unsigned>(blocks);
    if (mode == 0) {
      haralick_tail_kernel<0><<<grid, kWarps * 32, 0, s>>>(counts, feats, p, px, py, n, levels);
    } else {
      haralick_tail_kernel<1><<<grid, kWarps * 32, 0, s>>>(counts, feats, p, px, py, n, levels);
    }
  } else {
    if (n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned grid = static_cast<unsigned>(n);
    const int threads = levels * levels >= 16384 ? kWideMax : 256;
    const size_t smem = (5 * static_cast<size_t>(levels) + kSums * 32 + threads) * sizeof(double);
    if (mode == 0) {
      glcm::allow_smem(haralick_tail_wide_kernel<0>, smem);
      haralick_tail_wide_kernel<0><<<grid, threads, smem, s>>>(counts, feats, p, px, py, levels);
    } else {
      glcm::allow_smem(haralick_tail_wide_kernel<1>, smem);
      haralick_tail_wide_kernel<1><<<grid, threads, smem, s>>>(counts, feats, p, px, py, levels);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* haralick_tail_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
