// The marching-ring GLCM kernel shared by glcm_volume.cu and glcm_fused.cu.
//
// Counts (B, n_off, L, L) int32 GLCMs, out[b, k, ref, assoc] += 1, of a
// (B, D, H, W) stack over (dz, dy, dx) offsets with dz >= 0: the associate is
// the cell at (z, y, x), the reference the cell at (z + dz, y + dy, x + dx).
// A volume is such a stack; an image stack (B, H, W) is one with D = H, H = 1
// and offsets (dy, 0, dx), so both kernels march the same way.
//
// Ring. A block owns a strip of `runs` * 16 columns x `tile_rows` rows of
// each plane (a plane-tile) and walks down the depth axis, `planes` planes
// per step. It keeps a ring of binned plane-tiles in shared memory, each
// with halo rows (hy_lo above, hy_hi below) and halo columns (hl left, hr
// right, multiples of 16): each input value is read from device memory and
// binned once per ring fill, with the op order of glcm::bin_level (uint8 by
// a 256-entry table of it). A cell outside the input, or an int32 level
// outside [0, L), holds a no-vote sentinel (the level type's largest value,
// >= L), so the vote loop has no bounds checks. Levels are uint8 for
// L <= 255 and uint16 for L = 256, where a uint8 sentinel would be level 255.
//
// Steps. Step t votes the batches of planes t .. t + ahead (ahead planes
// cover max dz) while batch t + ahead + 1 is loaded into the one spare slot
// no vote of the step reads, so a step needs one barrier and no registers
// hold loads across the vote; other resident blocks hide the load latency.
// A load unit is the 16 values of a row from a column that is a multiple
// of 16 on: one to four aligned 16-byte loads where the row allows it (else
// one load per value), its 16 levels one or two aligned shared stores. (A
// unit of 16 bytes, 4 float32 values, cost a float32 ring three times the
// decoding and stores and spilled registers; PERF.md.)
//
// Votes. A thread votes a run of 16 consecutive cells of one row: its
// associates come in one aligned 16-byte shared load, each offset's
// references in two, funnel-shifted by the offset's byte shift (the same
// for every thread, so the shift never diverges), and each vote is one
// shared atomicAdd. Aggregating equal votes first was measured on the H100
// and lost on smooth and random inputs alike (PERF.md): a run that
// keeps a pending (cell, count) costs more compares and branches than the
// shared atomics it saves, and __match_any_sync costs far more. A remote
// or global add costs far more than a shared one, so the cluster variant
// does send a run of equal votes as one add of its length (send_run).
//
// Counts go to one of three places, chosen by plan() from the set's bytes
// (n_off L x L int32) alone; the wrapper zeroes the output.
// - Shared (kShared): `copies` (the paper's R) private sets of
//   sub-histograms in shared memory (lane l uses set l % R; sets
//   n_off*L*L+1 words apart), merged into the output with global atomicAdd
//   when the block exits. R never changes the counts.
// - Cluster (kCluster): where not even one set fits beside the ring, the
//   counts of the first half of the offsets (`held`) are spread over the
//   shared memory of a cluster of C blocks (the smallest of 2, 4, 8, and
//   16 where the card allows it, whose slices fit), and the other half vote
//   with global atomics: the SM-to-SM network and the L2 share the votes.
//   Block q of the cluster holds the reference rows r = q mod C, so a
//   vote's owner is r & (C - 1) and its word (r >> log2 C) * L + a (no
//   division). Each pixel is still marched once; a run of equal votes is
//   one red.shared::cluster (or one global atomicAdd) of its length. Every
//   block zeroes its slice and the cluster syncs before the first vote;
//   after an image's last, it syncs again and each block adds its slice's
//   non-zero words into the output with global atomicAdd (several clusters
//   may share an image).
// - Global (kGlobal): where no cluster holds even half the set (32
//   offsets at L = 256), every vote is a global atomicAdd into the output.
//
// Work split: the plane-tiles of one image, unit-major (strip, row tile)
// then depth, are cut into equal spans of at least `split` planes (tile_h or
// slab_d), one span per block and at most one block per resident slot on
// the card; a span that crosses from one unit to the next starts a new ring.
// A cluster (kCluster) takes an equal share of all images' plane-tiles, one
// cluster per resident cluster slot (cudaOccupancyMaxActiveClusters: at
// L = 256, a block's 128 KB slice leaves one block an SM), and cuts its share of
// each image it meets into one span a block; between two images it syncs,
// flushes, zeroes its slices and syncs again.

#pragma once

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "glcm_common.cuh"

namespace glcm {
namespace march {

constexpr int kThreads = 256;
constexpr int kRun = 16;       // x cells a thread votes per row (a 16-byte run of uint8)
constexpr int kMaxUnits = 2;   // load units a thread issues before it stores them
constexpr int kMaxOffsets = 64;
constexpr int kLutBytes = 512;  // after the ring: the levels of the 256 uint8 values
constexpr int kMaxCluster = 16;  // 8 is the portable limit; 16 where the card allows it

// Where a block's votes go (the kernel's third template argument).
enum Hist : int { kGlobal = 0, kShared = 1, kCluster = 2 };

// How the input holds its values (the wrappers pass this code).
enum Kind : int { kLevels = 0, kFloat = 1, kByte = 2 };

struct Offsets {
  int n;
  int dz[kMaxOffsets];
  int dy[kMaxOffsets];
  int dx[kMaxOffsets];
};

struct Geometry {
  int batch, depth, height, width, levels, copies;
  int max_dz, hy_lo, hy_hi, hl, hr;  // halo planes, rows and columns
  int runs, tile_rows, planes;       // runs per tile row, rows per tile, planes per step
  int slots;                         // ring plane-tiles: planes * (2 + ceil(max_dz / planes))
  int ring_rows, ring_w;             // rows of a ring plane-tile, cells of a ring row
  int unit_row;                      // load units per ring row
  int strips, row_tiles, per_image, shared_hist;
  int cluster, cluster_shift, band;  // blocks a cluster (0: none), log2 of it, rows a block holds
  int held;                          // offsets whose counts the cluster holds (the rest: global)
  long long span;                    // plane-tiles per block (kCluster: per cluster)
  int hist_bytes, ring_bytes, smem;
};

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }
inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

template <typename Lv>
__device__ __forceinline__ Lv sentinel() {
  return static_cast<Lv>(~0u);
}

__device__ __forceinline__ unsigned word(const uint4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}

__device__ __forceinline__ void set_word(uint4& q, int i, unsigned w) {
  if (i == 0) q.x = w;
  else if (i == 1) q.y = w;
  else if (i == 2) q.z = w;
  else q.w = w;
}

template <typename In>
__device__ __forceinline__ unsigned bits_of(In v) {
  if constexpr (std::is_same<In, float>::value) return __float_as_uint(v);
  else return static_cast<unsigned>(v);
}

// A load unit's kRun values as a thread holds them: kRun * sizeof(In)
// bytes, one to four 16-byte words.
template <typename In>
struct Held {
  uint4 v[sizeof(In)];
};

// Value e of a unit (e is a constant once loops unroll).
template <typename In>
__device__ __forceinline__ In element(const Held<In>& h, int e) {
  if constexpr (sizeof(In) == 1) {
    return static_cast<In>((word(h.v[0], e >> 2) >> ((e & 3) * 8)) & 0xffu);
  } else if constexpr (std::is_same<In, float>::value) {
    return __uint_as_float(word(h.v[e >> 2], e & 3));
  } else {
    return static_cast<In>(word(h.v[e >> 2], e & 3));
  }
}

template <typename In>
__device__ __forceinline__ void put(Held<In>& h, int e, In v) {
  if constexpr (sizeof(In) == 1) {
    const int i = e >> 2, s = (e & 3) * 8;
    set_word(h.v[0], i, (word(h.v[0], i) & ~(0xffu << s)) | (bits_of(v) << s));
  } else {
    set_word(h.v[e >> 2], e & 3, bits_of(v));
  }
}

// How a block bins raw values: a float32 value by glcm::bin_level; a uint8
// value by a lookup among the block's 256 levels of bin_level(float(v))
// (uint8 converts to float exactly, as bin_values' cast does), which takes
// the division out of the per-value work; int32 levels as they are, the
// sentinel outside [0, L).
template <typename Lv>
struct Binner {
  float lo, span;
  int levels;
  const Lv* lut;  // 256 levels, after the ring
};

template <typename In, typename Lv>
__device__ __forceinline__ Lv level(In v, const Binner<Lv>& bn) {
  if constexpr (std::is_same<In, int>::value) {
    return votes(v, bn.levels) ? static_cast<Lv>(v) : sentinel<Lv>();
  } else if constexpr (std::is_same<In, uint8_t>::value) {
    return bn.lut[v];
  } else {
    return static_cast<Lv>(bin_level(v, bn.lo, bn.span, bn.levels));
  }
}

// The block's binner; for uint8 input, thread v bins the value v into the
// table.
template <typename In, typename Lv>
__device__ __forceinline__ Binner<Lv> make_binner(float lo, float span, int levels, Lv* lut) {
  static_assert(kThreads == 256, "one thread per uint8 value");
  if constexpr (std::is_same<In, uint8_t>::value) {
    lut[threadIdx.x] = static_cast<Lv>(bin_level(static_cast<float>(threadIdx.x), lo, span,
                                                 levels));
  }
  return Binner<Lv>{lo, span, levels, lut};
}

// One load unit: the kRun values of one ring row from a column that is a
// multiple of kRun on, so that its cells are aligned shared stores.
struct Unit {
  long long src;  // element index of its first value (read unless blank)
  int ring;       // ring index of its first cell
  int n;          // values inside the input (<= 0: nothing to load or store)
  bool blank;     // a plane past the depth: store sentinels
};

// Where unit `idx` of a step lies, packed as (plane s << 24) | (ring row
// << 12) | (unit j of the row): computed once per thread, so that a step
// does no division to find its units (plan() keeps each field in range).
__device__ __forceinline__ unsigned unit_code(const Geometry& g, int idx) {
  const int per_plane = g.ring_rows * g.unit_row;
  const int s = idx / per_plane;
  const int rem = idx - s * per_plane;
  const int row = rem / g.unit_row;
  return (static_cast<unsigned>(s) << 24) | (row << 12) | (rem - row * g.unit_row);
}

// The unit with `code` of the step whose first plane is `z0` and first ring
// slot `slot0`, for the item at column x0 and row y0 whose loaded columns
// are [xa, xb).
__device__ __forceinline__ Unit decode(const Geometry& g, int b, unsigned code, int z0,
                                       int z_limit, int slot0, int x0, int y0, int xa, int xb) {
  Unit u;
  u.n = 0;
  const int s = static_cast<int>(code >> 24);
  const int row = static_cast<int>((code >> 12) & 0xfffu);
  const int x = xa + static_cast<int>(code & 0xfffu) * kRun;
  const int z = z0 + s;
  const int y = y0 - g.hy_lo + row;
  if (z >= z_limit || y < 0 || y >= g.height) return u;
  u.n = min(kRun, xb - x);
  u.blank = z >= g.depth;
  u.ring = ((slot0 + s) * g.ring_rows + row) * g.ring_w + x - x0 + g.hl;
  u.src = ((static_cast<long long>(b) * g.depth + z) * g.height + y) * g.width + x;
  return u;
}

// A unit's values: 16-byte loads where they are whole and aligned, else one
// load per value (rows of a width that is not a multiple of 16 bytes).
template <typename In>
__device__ __forceinline__ Held<In> fetch(const In* img, const Unit& u) {
  Held<In> h;
#pragma unroll
  for (int m = 0; m < static_cast<int>(sizeof(In)); ++m) h.v[m] = make_uint4(0u, 0u, 0u, 0u);
  if (u.n <= 0 || u.blank) return h;
  const In* p = img + u.src;
  if (u.n == kRun && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
    for (int m = 0; m < static_cast<int>(sizeof(In)); ++m) {
      h.v[m] = __ldg(reinterpret_cast<const uint4*>(p) + m);
    }
    return h;
  }
#pragma unroll
  for (int e = 0; e < kRun; ++e) {
    if (e < u.n) put<In>(h, e, __ldg(p + e));
  }
  return h;
}

// Bins a unit's values and writes its kRun cells (sentinels past the input)
// as aligned 16-byte shared stores.
template <typename In, typename Lv>
__device__ __forceinline__ void store(Lv* ring, const Unit& u, const Held<In>& h,
                                      const Binner<Lv>& bn) {
  constexpr int kPer = 4 / sizeof(Lv);  // levels per word
  constexpr int kWords = kRun / kPer;   // 4 or 8
  if (u.n <= 0) return;
  unsigned w[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) w[i] = 0;
#pragma unroll
  for (int e = 0; e < kRun; ++e) {
    const Lv lv = (e < u.n && !u.blank) ? level<In, Lv>(element<In>(h, e), bn) : sentinel<Lv>();
    w[e / kPer] |= static_cast<unsigned>(lv) << (8 * sizeof(Lv) * (e % kPer));
  }
  uint4* dst = reinterpret_cast<uint4*>(ring + u.ring);
#pragma unroll
  for (int i = 0; i < kWords; i += 4) dst[i / 4] = make_uint4(w[i], w[i + 1], w[i + 2], w[i + 3]);
}

// The kRun levels of a ring row from cell `cell` on, as kRun * sizeof(Lv)
// / 4 words: aligned 16-byte loads of the window around them, funnel-shifted
// by the cell's byte offset within 16 (the same for every lane of a block,
// so the switch never diverges).
template <typename Lv, int kW>
__device__ __forceinline__ void shifted(const unsigned (&v)[kW + 4], int o4, int sh,
                                        unsigned (&out)[kW]) {
#define GLCM_SHIFT(O4)                                                    \
  _Pragma("unroll") for (int m = 0; m < kW; ++m) {                        \
    out[m] = __funnelshift_r(v[m + (O4)], v[m + (O4) + 1], sh);           \
  }
  switch (o4) {
    case 0: GLCM_SHIFT(0) break;
    case 1: GLCM_SHIFT(1) break;
    case 2: GLCM_SHIFT(2) break;
    default: GLCM_SHIFT(3) break;
  }
#undef GLCM_SHIFT
}

template <typename Lv>
__device__ __forceinline__ int level_at(const unsigned* w, int i) {
  if constexpr (sizeof(Lv) == 1) return (w[i >> 2] >> ((i & 3) * 8)) & 0xff;
  else return (w[i >> 1] >> ((i & 1) * 16)) & 0xffff;
}

// `n` votes into word `word` of the cluster's set, held by block `rank` of
// the cluster: `word` is the shared-memory address in this block, which is
// the same in every block of the cluster.
__device__ __forceinline__ void cluster_add(unsigned word, unsigned rank, int n) {
  asm volatile(
      "{\n\t.reg .u32 remote;\n\t"
      "mapa.shared::cluster.u32 remote, %0, %1;\n\t"
      "red.relaxed.cluster.shared::cluster.add.u32 [remote], %2;\n\t}"
      :: "r"(word), "r"(rank), "r"(n) : "memory");
}

// Sends one offset's votes of a run as few adds: a run of equal (ref,
// assoc) cells is one add of its length. kRemote: into the cluster's set,
// whose band for this offset starts at shared address `hk_s` in every block;
// else into the image's L x L counts of this offset at `hk` (global).
template <typename Lv, bool kRemote>
__device__ __forceinline__ void send_run(const unsigned* rw, const int* a, unsigned voting,
                                         int levels, unsigned hk_s, int* hk, int shift,
                                         int owner) {
  int pr = -1, pa = 0, n = 0;
  auto flush = [&]() {
    if (!n) return;
    if constexpr (kRemote) {
      cluster_add(hk_s + 4u * static_cast<unsigned>((pr >> shift) * levels + pa),
                  static_cast<unsigned>(pr & owner), n);
    } else {
      atomicAdd(hk + pr * levels + pa, n);
    }
  };
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    const int r = level_at<Lv>(rw, i);
    if (r < levels && (voting >> i & 1u)) {
      if (r != pr || a[i] != pa) {
        flush();
        pr = r;
        pa = a[i];
        n = 0;
      }
      ++n;
    }
  }
  flush();
}

// Votes the planes of step `step` of the item [za, zb) from the ring into
// `mine` (a block's set, the output or, kCluster, the cluster's set; then
// the offsets past g.held go to `out_b`, the image's output).
template <typename Lv, int kHist>
__device__ __forceinline__ void vote(const Lv* ring, int* mine, int* out_b, const Geometry& g,
                                     const Offsets& offs, int step, int za, int zb, int y0) {
  constexpr int kW = kRun * sizeof(Lv) / 4;  // words of one run
  const int per_plane = g.tile_rows * g.runs;
  const int items = g.planes * per_plane;
  const int levels = g.levels;
  // Words between two offsets' histograms: a whole L x L, or a cluster
  // block's band of reference rows.
  const int cells = kHist == kCluster ? g.band * levels : levels * levels;
  const unsigned mine_s = kHist == kCluster ? static_cast<unsigned>(__cvta_generic_to_shared(mine))
                                            : 0u;
  const int shift = g.cluster_shift;
  const int owner = g.cluster - 1;
  for (int v = threadIdx.x; v < items; v += kThreads) {
    const int s = v / per_plane;
    const int rem = v - s * per_plane;
    const int row = rem / g.runs;
    const int run = rem - row * g.runs;
    const int rel = step * g.planes + s;
    if (za + rel >= zb || y0 + row >= g.height) continue;
    const int slot = rel % g.slots;
    const int c0 = g.hl + run * kRun;  // the run's first ring column
    const uint4* arow = reinterpret_cast<const uint4*>(
        ring + (slot * g.ring_rows + row + g.hy_lo) * g.ring_w + c0);
    unsigned aw[kW];
#pragma unroll
    for (int m = 0; m < kW / 4; ++m) {
      const uint4 t = arow[m];
      aw[4 * m] = t.x;
      aw[4 * m + 1] = t.y;
      aw[4 * m + 2] = t.z;
      aw[4 * m + 3] = t.w;
    }
    int a[kRun];
    unsigned voting = 0;  // bit i: cell i of the run is an associate that votes
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      a[i] = level_at<Lv>(aw, i);
      voting |= static_cast<unsigned>(a[i] < levels) << i;
    }
    if (!voting) continue;
    for (int k = 0; k < offs.n; ++k) {
      int rs = slot + offs.dz[k];
      if (rs >= g.slots) rs -= g.slots;
      const int byte = (c0 + offs.dx[k]) * static_cast<int>(sizeof(Lv));
      const unsigned char* rrow = reinterpret_cast<const unsigned char*>(
          ring + (rs * g.ring_rows + row + g.hy_lo + offs.dy[k]) * g.ring_w);
      const uint4* win = reinterpret_cast<const uint4*>(rrow + (byte & ~15));
      unsigned v4[kW + 4];
#pragma unroll
      for (int m = 0; m < kW / 4 + 1; ++m) {
        const uint4 t = win[m];
        v4[4 * m] = t.x;
        v4[4 * m + 1] = t.y;
        v4[4 * m + 2] = t.z;
        v4[4 * m + 3] = t.w;
      }
      unsigned rw[kW];
      shifted<Lv, kW>(v4, (byte & 15) >> 2, (byte & 3) * 8, rw);
      if constexpr (kHist == kCluster) {
        if (k < g.held) {
          send_run<Lv, true>(rw, a, voting, levels, mine_s + 4u * static_cast<unsigned>(k * cells),
                             nullptr, shift, owner);
        } else {
          send_run<Lv, false>(rw, a, voting, levels, 0u, out_b + k * levels * levels, 0, 0);
        }
      } else {
        int* hk = mine + k * cells;
#pragma unroll
        for (int i = 0; i < kRun; ++i) {
          const int r = level_at<Lv>(rw, i);
          if (r < levels && (voting >> i & 1u)) atomicAdd(hk + r * levels + a[i], 1);
        }
      }
    }
  }
}

// The block's binner for image b: its (lo, span) from `quant`.
template <typename In, typename Lv>
__device__ __forceinline__ Binner<Lv> image_binner(const float* quant, int b, int levels,
                                                   Lv* lut) {
  float lo = 0.0f, span = 1.0f;
  if constexpr (!std::is_same<In, int>::value) {
    lo = quant[2 * b];
    span = quant[2 * b + 1];
  }
  return make_binner<In, Lv>(lo, span, levels, lut);
}

// Marches the plane-tiles [f, f_end) of image b (unit-major, then depth)
// and votes them into `mine`; a span that crosses from one unit to the
// next starts a new ring.
template <typename In, typename Lv, int kHist>
__device__ __forceinline__ void march_span(const In* __restrict__ img, Lv* ring, int* mine,
                                           int* out_b, const Geometry& g, const Offsets& offs,
                                           const Binner<Lv>& bn, const unsigned (&code)[kMaxUnits],
                                           int b, long long f, long long f_end) {
  const int sw = g.runs * kRun;
  const int ahead = g.slots / g.planes - 2;  // steps a vote reads beyond its own
  const int units = g.planes * g.ring_rows * g.unit_row;
  while (f < f_end) {
    const long long unit = f / g.depth;
    const int za = static_cast<int>(f - unit * g.depth);
    const int zb = static_cast<int>(min(static_cast<long long>(g.depth), za + (f_end - f)));
    const int x0 = static_cast<int>(unit % g.strips) * sw;
    const int y0 = static_cast<int>(unit / g.strips) * g.tile_rows;
    const int xa = max(0, x0 - g.hl);  // the loaded columns [xa, xb)
    const int xb = min(g.width, x0 + sw + g.hr);
    const int z_limit = zb + g.max_dz;  // planes from here on are never read
    const int steps = (zb - za + g.planes - 1) / g.planes;

    // Every cell starts as a sentinel: the columns and rows outside the
    // input are never written again in this item.
    uint4* ring4 = reinterpret_cast<uint4*>(ring);
    for (int i = threadIdx.x; i < g.ring_bytes / 16; i += kThreads) {
      ring4[i] = make_uint4(~0u, ~0u, ~0u, ~0u);
    }
    __syncthreads();

    // Batch j (the planes from za + j * planes on) goes to ring slots from
    // (j % (ahead + 2)) * planes. Step t votes batches t .. t + ahead while
    // batch t + ahead + 1 is loaded and binned into the one slot that no
    // vote of the step reads: one barrier per step.
    for (int j = 0; j <= ahead + steps; ++j) {
      if (j < ahead + steps) {
        const int z0 = za + j * g.planes;
        const int slot0 = (j % (ahead + 2)) * g.planes;
        Held<In> q[kMaxUnits];  // all loads in flight before the first store
#pragma unroll
        for (int t = 0; t < kMaxUnits; ++t) {
          if (static_cast<int>(threadIdx.x) + t * kThreads < units) {
            q[t] = fetch(img, decode(g, b, code[t], z0, z_limit, slot0, x0, y0, xa, xb));
          }
        }
#pragma unroll
        for (int t = 0; t < kMaxUnits; ++t) {
          if (static_cast<int>(threadIdx.x) + t * kThreads < units) {
            const Unit u = decode(g, b, code[t], z0, z_limit, slot0, x0, y0, xa, xb);
            store<In, Lv>(ring, u, q[t], bn);
          }
        }
        for (int idx = threadIdx.x + kMaxUnits * kThreads; idx < units; idx += kThreads) {
          const Unit v = decode(g, b, unit_code(g, idx), z0, z_limit, slot0, x0, y0, xa, xb);
          store<In, Lv>(ring, v, fetch(img, v), bn);
        }
      }
      if (j > ahead) vote<Lv, kHist>(ring, mine, out_b, g, offs, j - ahead - 1, za, zb, y0);
      if (j >= ahead) __syncthreads();
    }
    f += zb - za;
  }
}

template <typename In, typename Lv, int kHist>
__global__ void __launch_bounds__(kThreads, 3)
march_kernel(const In* __restrict__ img, const float* __restrict__ quant, int* __restrict__ out,
             const Geometry g, const Offsets offs) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* hist = reinterpret_cast<int*>(smem);
  Lv* ring = reinterpret_cast<Lv*>(smem + g.hist_bytes);
  Lv* lut = reinterpret_cast<Lv*>(smem + g.hist_bytes + g.ring_bytes);
  const int cells = g.levels * g.levels;
  const long long total = static_cast<long long>(g.strips) * g.row_tiles * g.depth;
  unsigned code[kMaxUnits];
#pragma unroll
  for (int t = 0; t < kMaxUnits; ++t) code[t] = unit_code(g, threadIdx.x + t * kThreads);

  if constexpr (kHist == kCluster) {
    // The cluster marches the plane-tiles [w, w_end) of the flattened
    // (image, plane-tile) sequence; each image's share is cut into one
    // span a block. The slices are zeroed, and zero again after each
    // image's flush, before any block votes: the cluster barriers order it.
    cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int band_cells = g.band * g.levels;
    for (int i = threadIdx.x; i < g.hist_bytes / 4; i += kThreads) hist[i] = 0;
    cluster.sync();
    long long w = static_cast<long long>(blockIdx.x / g.cluster) * g.span;
    const long long w_end = min(total * g.batch, w + g.span);
    while (w < w_end) {
      const int b = static_cast<int>(w / total);
      const long long fa = w - b * total;
      const long long fb = min(total, fa + (w_end - w));
      const long long per = (fb - fa + g.cluster - 1) / g.cluster;
      const long long f = min(fb, fa + rank * per);
      // The table is rewritten only once every thread has passed the
      // barrier after the last image's votes.
      const Binner<Lv> bn = image_binner<In, Lv>(quant, b, g.levels, lut);
      int* out_b = out + static_cast<long long>(b) * offs.n * cells;
      march_span<In, Lv, kHist>(img, ring, hist, out_b, g, offs, bn, code, b, f,
                                min(fb, f + per));
      cluster.sync();  // every vote on image b is in
      for (int c = threadIdx.x; c < g.held * band_cells; c += kThreads) {
        const int v = hist[c];
        if (!v) continue;
        hist[c] = 0;
        const int k = c / band_cells;
        const int row = (c - k * band_cells) / g.levels;
        const int a = c - k * band_cells - row * g.levels;
        const int r = (row << g.cluster_shift) + rank;  // < L: only a vote wrote v
        atomicAdd(out_b + k * cells + r * g.levels + a, v);
      }
      cluster.sync();  // no block votes into a slice before it is zero again
      w += fb - fa;
    }
  } else {
    const int set_stride = offs.n * cells + 1;
    const int b = blockIdx.x / g.per_image;
    const int part = blockIdx.x - b * g.per_image;
    int* out_b = out + static_cast<long long>(b) * offs.n * cells;
    const Binner<Lv> bn = image_binner<In, Lv>(quant, b, g.levels, lut);
    // The sub-histograms and the uint8 table are made visible by the
    // barrier after the first ring fill.
    if constexpr (kHist == kShared) {
      for (int i = threadIdx.x; i < g.copies * set_stride; i += kThreads) hist[i] = 0;
    }
    int* mine = kHist == kShared ? hist + (threadIdx.x % 32 % g.copies) * set_stride : out_b;
    const long long f = static_cast<long long>(part) * g.span;
    march_span<In, Lv, kHist>(img, ring, mine, out_b, g, offs, bn, code, b, f,
                              min(total, f + g.span));

    if constexpr (kHist == kShared) {
      __syncthreads();
      for (int c = threadIdx.x; c < offs.n * cells; c += kThreads) {
        int v = 0;
        for (int r = 0; r < g.copies; ++r) v += hist[r * set_stride + c];
        if (v) atomicAdd(out_b + c, v);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Chooses the ring for `g` (whose batch, dims, levels and copies are set):
// the widest strip and the most rows and planes per step (about one run per
// thread) whose load units a thread issues at once, shrunk until the ring
// fits in `max_smem` bytes; then where the votes go: the sub-histogram sets
// that fit beside it, else the smallest cluster whose slices of half the
// offsets' counts fit beside it (launch() falls back to global atomics
// where the card will not run that cluster), else global atomics.
// Returns false when no ring fits (a halo too large for shared memory).
inline bool plan(Geometry& g, const Offsets& o, int max_smem) {
  const int lv_size = g.levels > 255 ? 2 : 1;
  int min_dy = 0, max_dy = 0, min_dx = 0, max_dx = 0;
  g.max_dz = 0;
  for (int k = 0; k < o.n; ++k) {
    g.max_dz = std::max(g.max_dz, o.dz[k]);
    min_dy = std::min(min_dy, o.dy[k]);
    max_dy = std::max(max_dy, o.dy[k]);
    min_dx = std::min(min_dx, o.dx[k]);
    max_dx = std::max(max_dx, o.dx[k]);
  }
  g.hy_lo = -min_dy;
  g.hy_hi = max_dy;
  g.hl = ceil_div(-min_dx, kRun) * kRun;
  g.hr = ceil_div(max_dx, kRun) * kRun;
  int runs = std::min(ceil_div(g.width, kRun), kThreads);
  int rows = std::min(g.height, std::max(1, kThreads / runs));
  int planes = std::min(g.depth, std::max(1, kThreads / (runs * rows)));
  for (;;) {
    const int ring_w = g.hl + runs * kRun + g.hr;
    const int unit_row = ceil_div(std::min(g.width, ring_w), kRun);
    const int ring_rows = rows + g.hy_lo + g.hy_hi;
    const int slots = planes * (2 + ceil_div(g.max_dz, planes));
    // 16 bytes past the last row: a vote's 16-byte window may reach them.
    const long long ring_bytes =
        static_cast<long long>(slots) * ring_rows * ring_w * lv_size + 16;
    const long long units = static_cast<long long>(planes) * ring_rows * unit_row;
    const bool issued = units <= kThreads * kMaxUnits || (planes == 1 && rows == 1);
    const bool coded = ring_rows < 4096 && unit_row < 4096;  // unit_code's fields
    if (issued && coded && ring_bytes + kLutBytes <= max_smem) {
      g.runs = runs;
      g.tile_rows = rows;
      g.planes = planes;
      g.slots = slots;
      g.ring_rows = ring_rows;
      g.ring_w = ring_w;
      g.unit_row = unit_row;
      g.ring_bytes = static_cast<int>(ring_bytes);
      break;
    }
    if (planes > 1) {
      planes = (planes + 1) / 2;
    } else if (rows > 1) {
      rows = (rows + 1) / 2;
    } else if (runs > 1) {
      runs = (runs + 1) / 2;
    } else {
      return false;
    }
  }
  g.strips = ceil_div(g.width, g.runs * kRun);
  g.row_tiles = ceil_div(g.height, g.tile_rows);
  const long long set_bytes = (static_cast<long long>(o.n) * g.levels * g.levels + 1) * 4;
  const long long fit = (max_smem - g.ring_bytes - kLutBytes) / set_bytes;
  g.shared_hist = fit >= 1;
  g.copies = g.shared_hist ? static_cast<int>(std::min(static_cast<long long>(g.copies), fit)) : 1;
  g.hist_bytes = g.shared_hist ? static_cast<int>((g.copies * set_bytes + 15) / 16 * 16) : 0;
  g.cluster = g.cluster_shift = g.band = g.held = 0;
  // A cluster holds the counts of half the offsets; the other half vote
  // with global atomics. A remote shared add and an L2 atomic go at about
  // the same rate on the H100 (PERF.md), and they take separate paths, so
  // the two halves run side by side.
  const int held = (o.n + 1) / 2;
  for (int shift = 1; !g.shared_hist && (1 << shift) <= kMaxCluster; ++shift) {
    const int band = ceil_div(g.levels, 1 << shift);  // reference rows a block holds
    const long long slice = (static_cast<long long>(held) * band * g.levels * 4 + 15) / 16 * 16;
    if (slice + g.ring_bytes + kLutBytes <= max_smem) {
      g.cluster = 1 << shift;
      g.cluster_shift = shift;
      g.band = band;
      g.held = held;
      g.hist_bytes = static_cast<int>(slice);
      break;
    }
  }
  g.smem = g.hist_bytes + g.ring_bytes + kLutBytes;
  return true;
}

// The global-atomic variant of a planned geometry.
inline void without_cluster(Geometry& g) {
  g.cluster = g.cluster_shift = g.band = g.held = 0;
  g.hist_bytes = 0;
  g.smem = g.ring_bytes + kLutBytes;
}

// Returned by launch<..., kCluster> when the card cannot run the cluster.
constexpr int kNoCluster = -1;

// What a launch would be, for reports: filled by run() when `info` is given.
enum Info : int {
  kBlocksPerSm, kSmem, kSharedHist, kCopies, kRuns, kTileRows, kPlanes, kSlots, kGrid, kSpan,
  kRegisters, kLocalBytes, kClusterSize, kInfoLen
};

// A launch of kThreads-thread blocks in clusters of `cluster` along x.
inline cudaLaunchConfig_t launch_config(cudaLaunchAttribute* dims, int cluster, int smem,
                                        cudaStream_t s) {
  dims->id = cudaLaunchAttributeClusterDimension;
  dims->val.clusterDim.x = static_cast<unsigned>(cluster);
  dims->val.clusterDim.y = 1;
  dims->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = s;
  cfg.attrs = dims;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename In, typename Lv, int kHist>
int launch(const In* img, const float* quant, int* out, Geometry g, const Offsets& o, int split,
           cudaStream_t s, int* info) {
  auto kernel = march_kernel<In, Lv, kHist>;
  const cudaError_t e = allow_smem(kernel, static_cast<size_t>(g.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, g.smem);
  if (per_sm < 1) per_sm = 1;
  // Blocks resident at once, and the unit blocks come in (a cluster).
  long long slots = static_cast<long long>(per_sm) * device_attr(cudaDevAttrMultiProcessorCount);
  const long long unit = kHist == kCluster ? g.cluster : 1;
  cudaLaunchAttribute dims;
  cudaLaunchConfig_t cfg = launch_config(&dims, static_cast<int>(unit), g.smem, s);
  if constexpr (kHist == kCluster) {
    int clusters = 0;
    if (g.cluster > 8 &&
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) !=
            cudaSuccess) {
      cudaGetLastError();
      return kNoCluster;
    }
    cfg.gridDim = dim3(g.cluster);
    if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess || clusters < 1) {
      cudaGetLastError();
      return kNoCluster;
    }
    slots = static_cast<long long>(clusters) * g.cluster;
  }
  const long long total = static_cast<long long>(g.strips) * g.row_tiles * g.depth;
  // At most one block per resident slot: a second wave would double the time.
  long long grid = 0;
  if constexpr (kHist == kCluster) {
    // Each resident cluster takes an equal share of all images' plane-tiles.
    const long long work = total * g.batch;
    g.span = std::max(static_cast<long long>(split) * g.cluster, ceil_div(work, slots / unit));
    grid = ceil_div(work, g.span) * unit;
    g.per_image = 0;
  } else {
    const long long want = std::max(1LL, slots / g.batch);
    g.span = std::max(static_cast<long long>(split), ceil_div(total, want));
    const long long per_image = ceil_div(total, g.span);
    grid = per_image * g.batch;
    g.per_image = static_cast<int>(per_image);
  }
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (info != nullptr) {
    cudaFuncAttributes fa;
    cudaFuncGetAttributes(&fa, kernel);
    const int values[kInfoLen] = {per_sm, g.smem, g.shared_hist, g.copies, g.runs, g.tile_rows,
                                  g.planes, g.slots, static_cast<int>(grid),
                                  static_cast<int>(ceil_div(g.span, unit)), fa.numRegs,
                                  static_cast<int>(fa.localSizeBytes), g.cluster};
    for (int i = 0; i < kInfoLen; ++i) info[i] = values[i];
    return static_cast<int>(cudaGetLastError());
  }
  const unsigned blocks = static_cast<unsigned>(grid);
  if constexpr (kHist == kCluster) {
    cfg.gridDim = dim3(blocks);
    return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, img, quant, out, g, o));
  } else {
    kernel<<<blocks, kThreads, g.smem, s>>>(img, quant, out, g, o);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename In, typename Lv>
int launch_lv(const void* img, const float* quant, int* out, Geometry g, const Offsets& o,
              int split, cudaStream_t s, int* info) {
  const In* x = static_cast<const In*>(img);
  if (g.shared_hist) return launch<In, Lv, kShared>(x, quant, out, g, o, split, s, info);
  if (g.cluster) {
    const int e = launch<In, Lv, kCluster>(x, quant, out, g, o, split, s, info);
    if (e != kNoCluster) return e;
    without_cluster(g);
  }
  return launch<In, Lv, kGlobal>(x, quant, out, g, o, split, s, info);
}

template <typename In>
int launch_in(const void* img, const float* quant, int* out, const Geometry& g, const Offsets& o,
              int split, cudaStream_t s, int* info) {
  return g.levels > 255 ? launch_lv<In, uint16_t>(img, quant, out, g, o, split, s, info)
                        : launch_lv<In, uint8_t>(img, quant, out, g, o, split, s, info);
}

// Plans and launches (or, with `info`, only reports) one march over a
// (batch, depth, height, width) input of kind `kind`. Returns a CUDA error
// code, cudaErrorInvalidConfiguration when no ring fits in shared memory.
inline int run(const void* img, int kind, const float* quant, int* out, int batch, int depth,
               int height, int width, int levels, int copies, int split, const Offsets& o,
               cudaStream_t s, int* info) {
  Geometry g = {};
  g.batch = batch;
  g.depth = depth;
  g.height = height;
  g.width = width;
  g.levels = levels;
  g.copies = copies;
  if (!plan(g, o, device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin))) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  switch (kind) {
    case kLevels: return launch_in<int>(img, quant, out, g, o, split, s, info);
    case kFloat: return launch_in<float>(img, quant, out, g, o, split, s, info);
    case kByte: return launch_in<uint8_t>(img, quant, out, g, o, split, s, info);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace march
}  // namespace glcm
