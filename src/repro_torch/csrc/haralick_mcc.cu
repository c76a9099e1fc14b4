// f14's eigensolver for Hopper (sm_90a), behind a plain C interface: the
// second-largest eigenvalue of G = A A^T, A = P / sqrt(px py), for a batch
// of L x L joint probabilities P with their marginals, 2 <= L <= 1024 (one
// warp a matrix up to L = 32, one block a matrix past it).
//
// Replaces no TPU kernel. The reference computes f14 (the maximal
// correlation coefficient) with jnp.linalg.eigvalsh over the whole batch
// (src/repro/core/haralick.py:119); the port did the same with
// torch.linalg.eigvalsh, which on the card is cuSOLVER's batched divide and
// conquer: every eigenvalue of each matrix, sized for large matrices, over
// chunks of at most 16 384 matrices (cuSOLVER refuses a texture map's
// 260 100), each chunk reading its error code back. f14 needs one
// eigenvalue of a 32 x 32 matrix, and this kernel computes just that.
//
// Design: a block of kWarps warps takes kWarps * per_warp matrices. Each
// warp brings per_warp of them, one after another, through steps 1-3, lane
// i owning row i, into the block's shared tridiagonal matrices; then warp w
// solves matrices kCount w .. kCount w + kCount - 1 of the block in step 4.
// The launch takes per_warp = 4 where the grid still fills the card at 4,
// and fewer for a small batch, whose reductions then spread over more
// warps; each matrix's arithmetic is the same whatever per_warp is.
//   1. P is read a row a load, every row in flight at once, scaled into
//      A = P / sqrt(px py) with the clamp of core/haralick.py (px, py at
//      least 1e-12, so a zero marginal gives a zero row, never a NaN) and
//      stored transposed in the warp's shared tile.
//   2. Lane i forms row i of G = A A^T in registers, one column of A at a
//      time (read by all lanes at once), so no row of A is ever held in
//      registers. G never reaches device memory; neither does A.
//   3. Householder reduction of G to tridiagonal form, no eigenvectors
//      (LAPACK dsytd2's steps): at step k lane k stores its row, which is
//      G's column k, in shared memory; the reflector comes from it; lane i
//      computes its element of p = tau G v from its row, the dot products
//      are warp shuffles, and the symmetric rank-2 update G -= v w^T + w v^T
//      runs in each lane's registers with v and w read from shared memory.
//      Column blocks left of the step, where v and w are zero, are skipped.
//   4. The second-largest eigenvalue of each tridiagonal matrix by Sturm
//      counts (LAPACK dlaebz's recurrence and pivot guard, dstebz's widened
//      Gershgorin interval), kGroup lanes a matrix: each round the group
//      counts at kGroup points that cut the interval into kGroup + 1, and a
//      ballot keeps the piece that holds the eigenvalue. kRounds fixed
//      rounds shrink it below 2^-53 of itself, with no lane diverging.
// Lanes and rows past L hold zeros and stay zero; the reduction and the
// counts run over the L x L matrix itself.
//
// Wider matrices, 32 < L <= 1024 (mcc_wide_kernel): one block of 1024
// threads a matrix, on G = A A^T as the caller formed it (a float64 GEMM),
// reduced in place in device memory, where a 256 x 256 G (512 KiB) stays in
// L2. The block is `parts` groups of `cols` threads (cols the power of two
// at least L and 32): thread (c, q) owns column c in group q and walks rows
// j = k + 1 + q, k + 1 + q + parts, ..., so each warp reads and writes 32
// consecutive doubles of a row. The same dsytd2 steps as in
// step 3: the reflector from row k (G's column k), p = tau G v as partial
// sums that the q = 0 threads add in a fixed order, the dot products as
// block sums that every thread ends with bit for bit, and the rank-2
// update, one row per thread and step. Then step 4 with the whole block:
// each round the 1024 threads count at 1024 points, and the first warp
// ballot that holds the eigenvalue's point sets the piece kept; 6 rounds.
// It replaces cuSOLVER's eigvalsh of every eigenvalue, one matrix after
// another (2 ms a 256 x 256 matrix on the H100, its host waiting).
//
// What bounds it: per matrix it reads L^2 + 2L doubles and writes one (a
// texture map's 260 100 32 x 32 matrices: 2.27 GB, 0.68 ms at 3.35 TB/s);
// its float64 work is L^2 (L + 1) for G (symmetric: its upper triangle),
// (4/3) L^3 for the reduction and about 3 L flop a bisection step to 53
// bits for one eigenvalue (21.5 GFLOP a map, 0.64 ms at the H100's 33.5
// TFLOP/s outside the tensor cores), so the bytes bound it. A warp
// instruction does the same work in every lane, so the reduction's updates
// still cost a whole row a step, and the counts kGroup points a step where
// bisection would count at one: fewer steps in a chain of dependent
// operations, which is what bounds a warp here, for more operations.

#include <cfloat>

#include <cuda_runtime.h>

#include "glcm_common.cuh"

namespace {

constexpr int kMax = 32;           // the largest L: one lane a row
constexpr int kStride = kMax + 2;  // tile row stride in doubles: 16-byte rows
constexpr int kWarps = 4;          // warps a block
constexpr int kGroup = 8;          // lanes that count for one matrix
constexpr int kCount = 32 / kGroup;  // matrices a warp counts for
constexpr unsigned kFull = 0xffffffffu;
constexpr double kEps = 1e-12;     // core/haralick.py's _EPS

// Rounds of (kGroup + 1)-section that shrink an interval below 2^-53 of itself.
constexpr int rounds_for(int sections) {
  int r = 0;
  for (double w = 1.0; w < 9007199254740992.0; w *= sections) ++r;
  return r;
}
constexpr int kRounds = rounds_for(kGroup + 1);  // 17

struct alignas(16) WarpTile {
  double tile[kMax * kStride];  // A transposed: column c of A at c * kStride
  double col[kMax];             // row (= column) k of G at step k
  double v[kMax];               // the Householder vector
  double w[kMax];               // w = p + K v
  double rx[kMax];              // 1 / sqrt(px), px clamped
};

__device__ __forceinline__ double warp_sum(double x) {
  // Butterfly: both lanes of a pair add the same two values, so every lane
  // ends with the same sum, bit for bit.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ double group_min(double x) {
#pragma unroll
  for (int o = kGroup / 2; o > 0; o >>= 1) x = fmin(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ double group_max(double x) {
#pragma unroll
  for (int o = kGroup / 2; o > 0; o >>= 1) x = fmax(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ double2 pair_at(const double* base, int j) {
  return *reinterpret_cast<const double2*>(base + j);
}

// 1 / q to within an ulp or two: the approximate reciprocal and two Newton
// steps. IEEE division would take its slow path on a zero dividend, which
// every split of the tridiagonal matrix (e = 0) gives the Sturm count. The
// callers' |q| are normal numbers, so nothing is flushed.
__device__ __forceinline__ double reciprocal(double q) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(q));
  r = fma(r, fma(-q, r, 1.0), r);
  return fma(r, fma(-q, r, 1.0), r);
}

// Steps 1-3 for one matrix: its tridiagonal form into dq.
__device__ __forceinline__ void tridiagonalize(const double* __restrict__ p,
                                               const double* __restrict__ px,
                                               const double* __restrict__ py, long long mat,
                                               int L, int lane, WarpTile& s, double2* dq) {
  // 1. P a row a load, scaled into A = P * (1 / sqrt(px)) * (1 / sqrt(py)),
  //    stored transposed: tile row c holds column c of A.
  const double* pm = p + mat * L * L;
  const bool row = lane < L;
  s.rx[lane] = row ? 1.0 / sqrt(fmax(__ldg(px + mat * L + lane), kEps)) : 0.0;
  {
    double buf[kMax];
#pragma unroll
    for (int r = 0; r < kMax; ++r) buf[r] = (row && r < L) ? __ldg(pm + r * L + lane) : 0.0;
    const double ry = row ? 1.0 / sqrt(fmax(__ldg(py + mat * L + lane), kEps)) : 0.0;
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kMax; ++r) s.tile[lane * kStride + r] = buf[r] * ry * s.rx[r];
  }
  __syncwarp();

  // 2. Row `lane` of G = A A^T, one column of A at a time: lane i adds
  //    A[i][c] A[j][c] to G[i][j] for every j. Lane j adds the same products
  //    in the same order to G[j][i], so G is symmetric bit for bit.
  double g[kMax];
#pragma unroll
  for (int j = 0; j < kMax; ++j) g[j] = 0.0;
#pragma unroll
  for (int c = 0; c < kMax; ++c) {
    const double* col_c = s.tile + c * kStride;
    const double a_ic = col_c[lane];
#pragma unroll
    for (int j = 0; j < kMax; j += 2) {
      const double2 a_jc = pair_at(col_c, j);
      g[j] = fma(a_ic, a_jc.x, g[j]);
      g[j + 1] = fma(a_ic, a_jc.y, g[j + 1]);
    }
  }

  // 3. Householder reduction to tridiagonal form (d_k, e_k).
  double e2_prev = 0.0;  // e_{k-1}^2
  for (int k = 0; k < L; ++k) {
    if (lane == k) {
#pragma unroll
      for (int j = 0; j < kMax; j += 2) {
        *reinterpret_cast<double2*>(s.col + j) = make_double2(g[j], g[j + 1]);
      }
    }
    __syncwarp();
    const double dk = s.col[k];
    double ek = 0.0;
    if (k + 2 < L) {
      const double xi = lane > k ? s.col[lane] : 0.0;  // column k below the diagonal
      const double alpha = s.col[k + 1];
      const double sigma = warp_sum(lane > k + 1 ? xi * xi : 0.0);
      ek = alpha;
      if (sigma != 0.0) {  // else the column is reduced already: H = I
        const double beta = -copysign(sqrt(alpha * alpha + sigma), alpha);
        const double tau = (beta - alpha) * reciprocal(beta);
        const double scale = reciprocal(alpha - beta);
        const double vi = lane == k + 1 ? 1.0 : (lane > k + 1 ? xi * scale : 0.0);
        ek = beta;
        s.v[lane] = vi;
        __syncwarp();
        // p = tau G v over the columns right of k, four at a time.
        double acc0 = 0.0, acc1 = 0.0;
#pragma unroll
        for (int j = 0; j < kMax; j += 4) {
          if (j + 3 > k) {
            const double2 v0 = pair_at(s.v, j), v1 = pair_at(s.v, j + 2);
            acc0 = fma(g[j], v0.x, acc0);
            acc1 = fma(g[j + 1], v0.y, acc1);
            acc0 = fma(g[j + 2], v1.x, acc0);
            acc1 = fma(g[j + 3], v1.y, acc1);
          }
        }
        const double pi = lane > k ? tau * (acc0 + acc1) : 0.0;
        const double wi = pi - 0.5 * tau * warp_sum(pi * vi) * vi;
        s.w[lane] = wi;
        __syncwarp();
#pragma unroll
        for (int j = 0; j < kMax; j += 4) {
          if (j + 3 > k) {
#pragma unroll
            for (int t = j; t < j + 4; t += 2) {
              const double2 vv = pair_at(s.v, t);
              const double2 ww = pair_at(s.w, t);
              g[t] = fma(-vi, ww.x, fma(-wi, vv.x, g[t]));
              g[t + 1] = fma(-vi, ww.y, fma(-wi, vv.y, g[t + 1]));
            }
          }
        }
      }
    } else if (k + 2 == L) {
      ek = s.col[k + 1];
    }
    if (lane == 0) dq[k] = make_double2(dk, e2_prev);
    e2_prev = ek * ek;
    __syncwarp();
  }
}

// Four blocks an SM, as many as their shared memory allows: at most 128
// registers a thread, which the kernel fits without spilling.
__global__ void __launch_bounds__(kWarps * 32, 4)
mcc_eig_kernel(const double* __restrict__ p, const double* __restrict__ px,
               const double* __restrict__ py, double* __restrict__ out, long long n,
               int levels, int per_warp) {
  __shared__ WarpTile tiles[kWarps];
  __shared__ double2 tri[kWarps * kCount][kMax + 1];  // (d_j, e_{j-1}^2) of each matrix
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_block = kWarps * per_warp;
  const long long base = static_cast<long long>(blockIdx.x) * per_block;
  const int L = levels;

#pragma unroll 1
  for (int m = warp; m < per_block; m += kWarps) {
    if (base + m < n) {
      tridiagonalize(p, px, py, base + m, L, lane, tiles[warp], tri[m]);
    } else {  // past the batch's end: a zero matrix, whose answer is not written
      tri[m][lane] = make_double2(0.0, 0.0);
    }
  }
  __syncthreads();
  if (warp >= per_warp) return;

  // 4. Sturm multisection for the eigenvalue of index L - 2 (ascending) of
  //    the block's matrix m: it lies at or below x exactly when L - 1
  //    eigenvalues do.
  const int grp = lane / kGroup, sub = lane % kGroup;
  const int m = kCount * warp + grp;
  const double2* dq = tri[m];
  double lo = DBL_MAX, hi = -DBL_MAX, e2 = 0.0;
  for (int j = sub; j < L; j += kGroup) {
    const double2 q = dq[j];
    const double r = sqrt(q.y) + (j + 1 < L ? sqrt(dq[j + 1].y) : 0.0);
    lo = fmin(lo, q.x - r);
    hi = fmax(hi, q.x + r);
    e2 = fmax(e2, q.y);
  }
  lo = group_min(lo);
  hi = group_max(hi);
  const double pivmin = DBL_MIN * fmax(1.0, group_max(e2));
  const double fudge = 2.1 * fmax(fabs(lo), fabs(hi)) * DBL_EPSILON * L + 4.2 * pivmin;
  lo -= fudge;
  hi += fudge;
  for (int round = 0; round < kRounds; ++round) {
    const double x = lo + (sub + 1) * ((hi - lo) / (kGroup + 1));
    int count = 0;  // eigenvalues <= x
    double q = 1.0;
#pragma unroll 4
    for (int j = 0; j < L; ++j) {
      const double2 dj = dq[j];
      q = (dj.x - dj.y * reciprocal(q)) - x;
      if (fabs(q) < pivmin) q = -pivmin;
      count += q <= 0.0;
    }
    const unsigned ballot = __ballot_sync(kFull, count >= L - 1);
    const unsigned at_or_above = (ballot >> (grp * kGroup)) & ((1u << kGroup) - 1);
    const int f = at_or_above ? __ffs(at_or_above) - 1 : kGroup;  // first point at or above
    const double x_f = __shfl_sync(kFull, x, grp * kGroup + (f & (kGroup - 1)));
    const double x_before = __shfl_sync(kFull, x, grp * kGroup + ((f - 1) & (kGroup - 1)));
    if (f < kGroup) hi = x_f;
    if (f > 0) lo = x_before;
  }
  if (sub == 0 && base + m < n) out[base + m] = 0.5 * (lo + hi);
}

constexpr int kWideThreads = 1024;  // threads of a block of mcc_wide_kernel
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWideMax = kWideThreads;  // the largest L: a column a thread at least
constexpr int kWideRounds = rounds_for(kWideThreads + 1);  // 6
constexpr int kBatch = 8;  // rows of G a thread loads at once

// What mcc_wide_kernel keeps in shared memory, after its `cols` doubles of
// v and of w.
struct WideShared {
  double part[kWideThreads];   // partial sums of p = tau G v
  double red[kWideWarps];      // a block sum's warp sums
  unsigned ballot[kWideWarps];  // a round's warp ballots
};

// x summed over the block: every thread returns the same bits.
__device__ __forceinline__ double block_sum(double x, WideShared& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_sum(x);
  __syncthreads();  // red is free
  if (lane == 0) s.red[warp] = x;
  __syncthreads();
  return warp_sum(s.red[lane]);
}

__device__ __forceinline__ double block_min(double x, WideShared& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmin(x, __shfl_xor_sync(kFull, x, o));
  __syncthreads();
  if (lane == 0) s.red[warp] = x;
  __syncthreads();
  x = s.red[lane];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmin(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ double block_max(double x, WideShared& s) {
  return -block_min(-x, s);
}

// One block a matrix: gram (n, L, L) holds G = A A^T, which the kernel
// overwrites; out[m] = lambda_2 of matrix m. cols is the smallest power of
// two >= max(L, 32); dynamic shared memory: 2 * cols doubles, WideShared and
// L double2.
__global__ void __launch_bounds__(kWideThreads, 1)
mcc_wide_kernel(double* __restrict__ gram, double* __restrict__ out, int L, int cols) {
  extern __shared__ __align__(16) double wide[];
  double* v = wide;
  double* w = v + cols;
  WideShared& s = *reinterpret_cast<WideShared*>(w + cols);
  double2* dq = reinterpret_cast<double2*>(&s + 1);  // (d_j, e_{j-1}^2)
  const int t = threadIdx.x;
  const int parts = kWideThreads / cols;
  const int c = t % cols, q = t / cols;
  const bool col = c < L;
  double* G = gram + static_cast<long long>(blockIdx.x) * L * L;

  // Householder reduction to tridiagonal form (d_k, e_k), as in step 3.
  double e2_prev = 0.0;
  for (int k = 0; k < L; ++k) {
    const double dk = G[static_cast<long long>(k) * L + k];
    double ek = 0.0;
    if (k + 2 < L) {
      const double alpha = G[static_cast<long long>(k) * L + k + 1];
      const double xc = (q == 0 && col && c > k) ? G[static_cast<long long>(k) * L + c] : 0.0;
      const double sigma = block_sum(c > k + 1 ? xc * xc : 0.0, s);
      ek = alpha;
      if (sigma != 0.0) {  // else the column is reduced already: H = I
        const double beta = -copysign(sqrt(alpha * alpha + sigma), alpha);
        const double tau = (beta - alpha) * reciprocal(beta);
        const double scale = reciprocal(alpha - beta);
        ek = beta;
        if (q == 0) v[c] = c == k + 1 ? 1.0 : (c > k + 1 && col ? xc * scale : 0.0);
        __syncthreads();
        // Thread (c, q)'s part of p_c = tau sum_j G[j][c] v_j, j > k, its
        // rows kBatch at a time, so that their loads are in flight at once.
        double acc[4] = {};
        if (col && c > k) {
          int j = k + 1 + q;
#pragma unroll 1
          for (; j + (kBatch - 1) * parts < L; j += kBatch * parts) {
            double g[kBatch];
#pragma unroll
            for (int u = 0; u < kBatch; ++u) g[u] = G[static_cast<long long>(j + u * parts) * L + c];
#pragma unroll
            for (int u = 0; u < kBatch; ++u) acc[u % 4] = fma(g[u], v[j + u * parts], acc[u % 4]);
          }
          for (; j < L; j += parts) acc[0] = fma(G[static_cast<long long>(j) * L + c], v[j], acc[0]);
        }
        s.part[t] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
        __syncthreads();
        double pc = 0.0;
        if (q == 0 && col && c > k) {
          for (int r = 0; r < parts; ++r) pc += s.part[r * cols + c];
          pc *= tau;
        }
        const double vc = v[c];
        const double kk = block_sum(q == 0 ? pc * vc : 0.0, s);
        if (q == 0) w[c] = pc - 0.5 * tau * kk * vc;
        __syncthreads();
        // G -= v w^T + w v^T on the rows j > k, columns c > k, kBatch rows
        // loaded before any is stored.
        if (col && c > k) {
          const double wc = w[c];
          int j = k + 1 + q;
#pragma unroll 1
          for (; j + (kBatch - 1) * parts < L; j += kBatch * parts) {
            double g[kBatch];
#pragma unroll
            for (int u = 0; u < kBatch; ++u) g[u] = G[static_cast<long long>(j + u * parts) * L + c];
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              const int r = j + u * parts;
              G[static_cast<long long>(r) * L + c] = fma(-vc, w[r], fma(-wc, v[r], g[u]));
            }
          }
          for (; j < L; j += parts) {
            double* gj = G + static_cast<long long>(j) * L + c;
            *gj = fma(-vc, w[j], fma(-wc, v[j], *gj));
          }
        }
        __syncthreads();  // the next step reads the updated rows
      }
    } else if (k + 2 == L) {
      ek = G[static_cast<long long>(k) * L + k + 1];
    }
    if (t == 0) dq[k] = make_double2(dk, e2_prev);
    e2_prev = ek * ek;
  }
  __syncthreads();

  // Step 4 with the whole block: Sturm multisection for the eigenvalue of
  // index L - 2 (ascending), at kWideThreads points a round.
  double lo = DBL_MAX, hi = -DBL_MAX, e2 = 0.0;
  for (int j = t; j < L; j += kWideThreads) {
    const double2 d = dq[j];
    const double r = sqrt(d.y) + (j + 1 < L ? sqrt(dq[j + 1].y) : 0.0);
    lo = fmin(lo, d.x - r);
    hi = fmax(hi, d.x + r);
    e2 = fmax(e2, d.y);
  }
  lo = block_min(lo, s);
  hi = block_max(hi, s);
  const double pivmin = DBL_MIN * fmax(1.0, block_max(e2, s));
  const double fudge = 2.1 * fmax(fabs(lo), fabs(hi)) * DBL_EPSILON * L + 4.2 * pivmin;
  lo -= fudge;
  hi += fudge;
  for (int round = 0; round < kWideRounds; ++round) {
    const double step = (hi - lo) / (kWideThreads + 1);
    const double x = lo + (t + 1) * step;
    int count = 0;  // eigenvalues <= x
    double qq = 1.0;
#pragma unroll 4
    for (int j = 0; j < L; ++j) {
      const double2 dj = dq[j];
      qq = (dj.x - dj.y * reciprocal(qq)) - x;
      if (fabs(qq) < pivmin) qq = -pivmin;
      count += qq <= 0.0;
    }
    const unsigned ballot = __ballot_sync(kFull, count >= L - 1);
    if ((t & 31) == 0) s.ballot[t >> 5] = ballot;
    __syncthreads();
    int f = kWideThreads;  // the first point at or above the eigenvalue
    for (int i = 0; i < kWideWarps; ++i) {
      if (s.ballot[i]) {
        f = i * 32 + __ffs(s.ballot[i]) - 1;
        break;
      }
    }
    __syncthreads();  // the ballots are read before the next round writes them
    const double x_f = lo + (f + 1) * step, x_before = lo + f * step;
    if (f < kWideThreads) hi = x_f;
    if (f > 0) lo = x_before;
  }
  if (t == 0) out[blockIdx.x] = 0.5 * (lo + hi);
}

}  // namespace

extern "C" {

// lambda_2 of G = A A^T for n matrices: p (n, L, L), px and py (n, L), all
// contiguous float64 on the card, into out (n,) float64. 2 <= L <= 32.
// Launches on `stream`, allocates nothing and does not synchronise.
// Returns cudaGetLastError() (0 = launched).
int haralick_mcc_launch(const double* p, const double* px, const double* py, double* out,
                        long long n, int levels, void* stream) {
  if (n < 0 || levels < 2 || levels > kMax) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaGetLastError();  // start from a clean error state
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mcc_eig_kernel, kWarps * 32, 0);
  const long long resident = static_cast<long long>(per_sm > 0 ? per_sm : 1) *
                             glcm::device_attr(cudaDevAttrMultiProcessorCount);
  int per_warp = kCount;  // as many as a warp counts for, while the card stays full
  while (per_warp > 1 && n < resident * kWarps * per_warp) per_warp /= 2;
  const long long per_block = static_cast<long long>(kWarps) * per_warp;
  const long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  mcc_eig_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(p, px, py, out, n, levels, per_warp);
  return static_cast<int>(cudaGetLastError());
}

// lambda_2 of each of the n Gram matrices G = A A^T in gram (n, L, L),
// contiguous float64 on the card, which the kernel overwrites, into out (n,)
// float64; 32 < L <= 1024. Launches on `stream`, allocates nothing and does
// not synchronise. Returns cudaGetLastError() (0 = launched).
int haralick_mcc_wide_launch(double* gram, double* out, long long n, int levels, void* stream) {
  if (n < 0 || n > 0x7fffffffLL || levels <= kMax || levels > kWideMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  cudaGetLastError();  // start from a clean error state
  int cols = 32;
  while (cols < levels) cols *= 2;
  const size_t smem = 2 * cols * sizeof(double) + sizeof(WideShared) + levels * sizeof(double2);
  mcc_wide_kernel<<<static_cast<unsigned>(n), kWideThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(gram, out, levels, cols);
  return static_cast<int>(cudaGetLastError());
}

const char* haralick_mcc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
