// The destriping bilinear pair for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (pyimcom_tpu_torch/ops/bilinear_cuda.py).
//
// K3 bilinear_gather  replaces the JAX package's device gathers
//     bilinear_gather_device and bilinear_gather_weighted_device
//     (pyimcom_tpu/ops/bilinear.py:33-57; the weighted one is also
//     _gather_weighted in pyimcom_tpu/ops/destripe_device.py:26-45), which
//     XLA runs as gathers inside the destripe cost's lax.scan over SCA pairs.
//     Each query (xf, yf) reads the four taps of a (ny, nx) image around
//     (floor(xf), floor(yf)), bilinear weights w_k; with a gain map g, the
//     taps are gain-weighted and normalised, sum_k w_k g_k v_k / norm with
//     norm = sum_k w_k g_k (norm <= 0 taken as 1).  A query is in bounds iff
//     0 <= floor(xf) < nx - 1 and 0 <= floor(yf) < ny - 1; out of bounds,
//     and at a NaN position, the value is 0.  The result is written, or
//     added into the caller's accumulator (one destripe pair adds straight
//     into its target's row).
// K4 bilinear_scatter_adjoint  replaces bilinear_scatter_adjoint_device
//     (pyimcom_tpu/ops/bilinear.py:60-71, an XLA scatter-add) and, with a
//     gain, the image cotangent that jax.value_and_grad takes through
//     _gather_weighted: each in-bounds value v adds v w_k (v w_k g_k / norm
//     with a gain) into the four taps of the output grid.  It is the exact
//     adjoint of K3 with respect to the image.
//
// Both are templated on the type of the positions: double, or float for
// pair maps stored at half the width (the JAX package's
// PYIMCOM_DESTRIPE_MAP_DTYPE=f32, pyimcom_tpu/imdestripe.py:477-520, whose
// device route casts the maps back to float64,
// pyimcom_tpu/ops/destripe_device.py:100-103).  A position is read at its
// stored width and widened to double at once, which is exact: the tap
// floor, the weights, the image and gain loads and the sums are float64 in
// both forms, so a float form gives the numbers of the double form on the
// widened positions.  The float form reads 8 bytes of positions a query
// instead of 16.
//
// What bounds them on this card: bytes.  A query does ~30 f64 operations
// against 24-48 bytes of its own streams (xf, yf, the value, the
// accumulator) plus its taps; at 4088^2 queries a launch moves ~0.5-0.8 GB
// against ~0.5 GFLOP.  The taps of neighbouring queries are neighbouring
// pixels (a pair map is a near-affine shift and roll of the grid).
//
// K3 is one thread a query in grid-stride loops: the image and gain rows
// come through L1/L2 about once, the streams are read and written coalesced.
//
// K4 on a 2-D query grid (a destripe pair's: the target's pixel grid) is
// owner-writes over a per-pair plan.  Every query adds into the four pixels
// around its floor tap, so scattering from the queries' side needs f64
// atomics: the tiled body (commit 6691642) zeroed a box in shared memory,
// added there with CAS loops (this card has no f64 add in shared memory)
// and flushed the box with f64 atomicAdd into an output the caller had
// zeroed; neighbouring boxes overlap, so the output (beyond the 50 MB L2)
// was written by the memset and then read and written again, ~24 bytes a
// pixel where one store is 8, and its float32-position form (8 bytes less
// a query) took the float64 form's time.  Here one CTA owns a 32 x 32 tile
// of the OUTPUT and writes each of its pixels once.  The queries that add
// into a tile are those whose floor tap lies in its 33 x 33 window of tap
// cells (the tile, and one cell above and to the left); a pair map is built
// once and read unchanged by every CG iteration, so the plan that names
// them is built once a pair, on the card (the plan kernel near the end of
// this file, one pass over the positions and no host synchronisation:
// ops/bilinear_cuda.build_adjoint_plan), and reused by every launch: for
// each tile its first and last query row and, for each band of kBand query
// rows from the first, the span of columns [lo, hi] that holds
// its contributing queries (one 32-bit word a band; ~0.7-0.9 MB a 4088^2
// pair, r = staged / contributing queries 1.0 at a 0 degree roll and 1.12
// at 45; a bounding box of columns gives r 1.96 at 45, k4_variants.py).
// A persistent grid walks the tiles (tile blockIdx.x + k gridDim.x), each in
// chunks of at most kChunk window queries: a chunk's row segments come from
// the plan (its words and first spans prefetched a tile or two ahead); the
// CTA stages the chunk's values and positions, and on a tile's first chunk
// its gain with a 1-pixel halo, in shared memory with cp.async (a warp a
// row segment, its lanes along the columns); then it takes each staged
// query's tap, keeps those in the window, divides its value by the norm of
// its gain-weighted weights (K3's arithmetic), counts the queries by cell
// with 32-bit shared atomics, places them by cell (an exclusive scan of the
// counts), sorts each cell's few entries by staging order, and each thread
// sums the products of the 3 x 3 cells of its 2 x 2 pixels, each cell's
// queries in staging order.  No f64 atomic anywhere, no zero fill (a fresh
// output is allocated with torch.empty and every pixel stored once; with
// `accumulate` each pixel is read, added to and written once), and the sums
// are taken in a fixed order: two launches give the same bits.  What
// bounds it: the bytes it stages -- values and positions (16 or 24 bytes a
// staged query), the gain with its halo, the output once -- which a body
// doing nothing else moves in 0.22 / 0.25 ms on a 4088^2 pair (float32 /
// float64 positions; H100 80GB HBM3 at 700 W, k4_variants.py loads_only),
// and the chunk's compute between barriers, which overlaps the copies only
// across CTAs: four CTAs an SM (64 registers, one staging buffer; two
// buffers, which overlap a CTA's own copies and work, fit two CTAs an SM
// and are slower).  Shared memory is laid out against bank conflicts along
// the lines of cells that a warp's queries follow at any roll (the
// kCellPitch and kGainPitch notes).

// A 1-D stream (qny == 1), or a grid wider than 65535 columns (the plan
// keeps columns in 16 bits), has no plan: it takes the tiled body, unchanged
// but for its counter.  That body takes the queries in tiles of their own
// grid (1 x 1024 of a stream, 32 x 32 of a grid), 256 threads a tile: the
// CTA reduces the bounding box of its in-bounds taps and, if that box fits
// kBoxCap doubles, zeroes an accumulator box in shared memory, adds its
// queries' four contributions there with shared-memory atomics and flushes
// the box's nonzero pixels with global atomicAdd; a tile whose box does not
// fit adds its queries straight into device memory.  Each of its tiles that
// holds a query in bounds counts itself in a device counter
// (off_plan_tiles), so a caller can see K4 work off the planned route.

#include <algorithm>
#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// The tap (ix, iy) = (floor(x), floor(y)) of a query; false out of bounds
// (a NaN position fails every comparison).
__device__ __forceinline__ bool tap_floor(double x, double y, int nx, int ny, int* ix, int* iy) {
  const double fx0 = floor(x), fy0 = floor(y);
  if (!(fx0 >= 0.0 && fx0 < nx - 1 && fy0 >= 0.0 && fy0 < ny - 1)) return false;
  *ix = static_cast<int>(fx0);
  *iy = static_cast<int>(fy0);
  return true;
}

// The bilinear weights of the four taps at fractions (fx, fy).
__device__ __forceinline__ void bilinear_weights(double fx, double fy, double w[4]) {
  w[0] = (1.0 - fx) * (1.0 - fy);
  w[1] = fx * (1.0 - fy);
  w[2] = (1.0 - fx) * fy;
  w[3] = fx * fy;
}

// The flat index of a query's tap and its four weights; false out of bounds.
__device__ __forceinline__ bool query_taps(double x, double y, int nx, int ny, int* i00,
                                           double w[4]) {
  int ix, iy;
  if (!tap_floor(x, y, nx, ny, &ix, &iy)) return false;
  bilinear_weights(x - ix, y - iy, w);
  *i00 = iy * nx + ix;
  return true;
}

template <typename Pos>
__global__ void gather_kernel(const double* __restrict__ image, const double* __restrict__ gain,
                              int ny, int nx, const Pos* __restrict__ xf,
                              const Pos* __restrict__ yf, long long n, double* out,
                              int accumulate) {
  for (long long q = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; q < n;
       q += static_cast<long long>(gridDim.x) * blockDim.x) {
    int i;
    double w[4];
    double val = 0.0;
    if (query_taps(static_cast<double>(xf[q]), static_cast<double>(yf[q]), nx, ny, &i, w)) {
      const double v0 = __ldg(image + i), v1 = __ldg(image + i + 1);
      const double v2 = __ldg(image + i + nx), v3 = __ldg(image + i + nx + 1);
      if (gain != nullptr) {
        const double a0 = w[0] * __ldg(gain + i), a1 = w[1] * __ldg(gain + i + 1);
        const double a2 = w[2] * __ldg(gain + i + nx), a3 = w[3] * __ldg(gain + i + nx + 1);
        double norm = a0 + a1 + a2 + a3;
        norm = norm > 0.0 ? norm : 1.0;
        val = (a0 * v0 + a1 * v1 + a2 * v2 + a3 * v3) / norm;
      } else {
        val = w[0] * v0 + w[1] * v1 + w[2] * v2 + w[3] * v3;
      }
    }
    out[q] = accumulate ? out[q] + val : val;
  }
}

// K4's off-plan body (the tiled one).  A tile is kTileQueries queries: 32 x 32 of a
// 2-D query grid, 1 x 1024 of one row.  kBoxCap is the f64 slots of a tile's accumulator box
// in shared memory (24 KB): a 32 x 32 tile rolled by 45 degrees at the same
// pixel scale touches a 46 x 46 box, so boxes fit up to a local scale of
// ~1.2 at any roll (a box's pitch takes up to 15 more columns where they
// fit).
constexpr int kAdjThreads = 256;
constexpr int kTileQueries = 1024;
constexpr int kPerThread = kTileQueries / kAdjThreads;
constexpr int kWarps = kAdjThreads / 32;
constexpr int kBoxCap = 3072;

// The bilinear weights of a query's taps, scaled by the gain taps where
// given, and its value over their norm; shared by both routes of the
// off-plan body so they add the same products (the planned body takes its
// gain taps from shared memory in the same order of operations).
__device__ __forceinline__ double adjoint_weights(double fx, double fy, double v,
                                                  const double* __restrict__ gain, int i, int nx,
                                                  double w[4]) {
  bilinear_weights(fx, fy, w);
  if (gain != nullptr) {
    w[0] *= __ldg(gain + i);
    w[1] *= __ldg(gain + i + 1);
    w[2] *= __ldg(gain + i + nx);
    w[3] *= __ldg(gain + i + nx + 1);
    const double norm = w[0] + w[1] + w[2] + w[3];
    v = v / (norm > 0.0 ? norm : 1.0);
  }
  return v;
}

__device__ __forceinline__ int warp_min(int a) {
  for (int o = 16; o > 0; o >>= 1) a = min(a, __shfl_xor_sync(0xffffffffu, a, o));
  return a;
}

__device__ __forceinline__ int warp_max(int a) {
  for (int o = 16; o > 0; o >>= 1) a = max(a, __shfl_xor_sync(0xffffffffu, a, o));
  return a;
}

// One CTA a tile of TILE_W query columns by kTileQueries / TILE_W rows of the
// (qny, qnx) query grid, tiles numbered row-major in blockIdx.x.  In a 32 x
// 32 tile each warp takes blocks of 8 x 4 queries, whose taps are a compact
// patch (the gain taps come through few L1 lines); in one row, runs of 32.
// The CTA reads its queries, reduces the bounding box of their in-bounds
// taps, and takes the shared route (zero the box in shared memory, add each
// query's four contributions there with shared-memory atomics, flush the
// nonzero pixels with global atomics, row by row) or, where the box
// outgrows kBoxCap, the global route (each query's four adds straight into
// device memory).  A tile with a query in bounds adds one to off_plan_tiles.
template <int TILE_W, typename Pos>
__global__ void __launch_bounds__(kAdjThreads, 4)
    adjoint_tile_kernel(const double* __restrict__ values, const double* __restrict__ gain,
                        int ny, int nx, const Pos* __restrict__ xf,
                        const Pos* __restrict__ yf, int qny, int qnx, double* out,
                        unsigned long long* __restrict__ off_plan_tiles) {
  constexpr int TILE_H = kTileQueries / TILE_W;
  extern __shared__ double acc[];
  __shared__ int red[4][kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int tiles_x = (qnx + TILE_W - 1) / TILE_W;
  const int r0 = (blockIdx.x / tiles_x) * TILE_H, c0 = (blockIdx.x % tiles_x) * TILE_W;

  // the tile's queries (a NaN position off the grid) and their taps' box
  double x[kPerThread], y[kPerThread], v[kPerThread];
  int x_lo = INT_MAX, x_hi = INT_MIN, y_lo = INT_MAX, y_hi = INT_MIN;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int f = t + k * kAdjThreads;
    const int qr = TILE_W == 32 ? r0 + (f >> 7) * 4 + (lane >> 3) : r0;
    const int qc = TILE_W == 32 ? c0 + ((f >> 5) & 3) * 8 + (lane & 7) : c0 + f;
    x[k] = __longlong_as_double(0x7ff8000000000000LL);
    y[k] = v[k] = 0.0;
    if (qr < qny && qc < qnx) {
      const long long q = static_cast<long long>(qr) * qnx + qc;
      x[k] = static_cast<double>(xf[q]);
      y[k] = static_cast<double>(yf[q]);
      v[k] = values[q];
    }
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    int ix, iy;
    if (tap_floor(x[k], y[k], nx, ny, &ix, &iy)) {
      x_lo = min(x_lo, ix);
      x_hi = max(x_hi, ix);
      y_lo = min(y_lo, iy);
      y_hi = max(y_hi, iy);
    }
  }
  x_lo = warp_min(x_lo);
  x_hi = warp_max(x_hi);
  y_lo = warp_min(y_lo);
  y_hi = warp_max(y_hi);
  if (lane == 0) {
    red[0][warp] = x_lo;
    red[1][warp] = x_hi;
    red[2][warp] = y_lo;
    red[3][warp] = y_hi;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    x_lo = min(x_lo, red[0][w]);
    x_hi = max(x_hi, red[1][w]);
    y_lo = min(y_lo, red[2][w]);
    y_hi = max(y_hi, red[3][w]);
  }
  if (x_lo > x_hi) return;  // no query of the tile is in bounds
  if (t == 0) atomicAdd(off_plan_tiles, 1ull);
  const int bw = x_hi - x_lo + 2, bh = y_hi - y_lo + 2;

  if (static_cast<long long>(bw) * bh > kBoxCap) {
    // the global route
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      int ix, iy;
      if (!tap_floor(x[k], y[k], nx, ny, &ix, &iy)) continue;
      const int i = iy * nx + ix;
      double w[4];
      const double vv = adjoint_weights(x[k] - ix, y[k] - iy, v[k], gain, i, nx, w);
      atomicAdd(out + i, vv * w[0]);
      atomicAdd(out + i + 1, vv * w[1]);
      atomicAdd(out + i + nx, vv * w[2]);
      atomicAdd(out + i + nx + 1, vv * w[3]);
    }
    return;
  }

  // the shared route.  An 8-byte word w sits on bank pair w % 16; with the
  // pitch = 12 (mod 16), the words of a warp's taps (a rolled 8 x 4 patch)
  // share a pair at most 4 at a time at any roll, twice the least (a pitch
  // of bw | 1 can put a 45-degree run of 32 on one pair, as a bank
  // count found).  Where that does not fit, the pitch is bw.  Box pixel p
  // is row p / bw: (p + 0.5) / bw in f32 lies 0.5 / bw from an integer, far
  // above its rounding error while bw * bh <= kBoxCap.
  int pitch = bw + ((12 - bw) & 15);
  if (pitch * bh > kBoxCap) pitch = bw;
  const int npix = bw * bh;
  const float inv_bw = 1.0f / bw;
  for (int p = t; p < npix; p += kAdjThreads) {
    const int r = static_cast<int>((p + 0.5f) * inv_bw);
    acc[r * pitch + p - r * bw] = 0.0;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    int ix, iy;
    if (!tap_floor(x[k], y[k], nx, ny, &ix, &iy)) continue;
    double w[4];
    const double vv = adjoint_weights(x[k] - ix, y[k] - iy, v[k], gain, iy * nx + ix, nx, w);
    const int s = (iy - y_lo) * pitch + ix - x_lo;
    atomicAdd(acc + s, vv * w[0]);
    atomicAdd(acc + s + 1, vv * w[1]);
    atomicAdd(acc + s + pitch, vv * w[2]);
    atomicAdd(acc + s + pitch + 1, vv * w[3]);
  }
  __syncthreads();
  for (int p = t; p < npix; p += kAdjThreads) {
    const int r = static_cast<int>((p + 0.5f) * inv_bw), c = p - r * bw;
    const double a = acc[r * pitch + c];
    if (a != 0.0) atomicAdd(out + (y_lo + r) * nx + x_lo + c, a);
  }
}

template <int TILE_W, typename Pos>
void launch_adjoint(const double* values, const double* gain, int ny, int nx, const Pos* xf,
                    const Pos* yf, int qny, int qnx, double* out,
                    unsigned long long* off_plan_tiles, cudaStream_t stream) {
  constexpr int TILE_H = kTileQueries / TILE_W;
  constexpr int smem = kBoxCap * static_cast<int>(sizeof(double));
  const long long tiles =
      static_cast<long long>((qny + TILE_H - 1) / TILE_H) * ((qnx + TILE_W - 1) / TILE_W);
  adjoint_tile_kernel<TILE_W, Pos><<<static_cast<unsigned>(tiles), kAdjThreads, smem, stream>>>(
      values, gain, ny, nx, xf, yf, qny, qnx, out, off_plan_tiles);
}

// ---- K4's planned body ------------------------------------------------------
// A CTA of kPlanThreads owns a kOwn x kOwn tile of the output; its window is
// the kCellSide x kCellSide tap cells from one above and one left of the
// tile (a query adds into its tap's pixel and the pixels below and right).
// The plan of tile t: rows[2t], rows[2t + 1] its first and last query row;
// spans[ptr[t] + k] the columns lo | hi << 16 of band k, query rows
// rows[2t] + kBand k ... + kBand - 1 (clipped to the last), lo > hi for a
// band without a contributing query.  A chunk is at most kChunk queries of
// a group of kGroupBands bands, expanded into row segments, in band, row
// and column order: the staging order.
constexpr int kOwn = 32;
constexpr int kCellSide = kOwn + 1;
// the cells' row pitch in the count and start arrays: a warp's queries run
// along a line of cells, and with a pitch of 33 an anti-diagonal line
// (step 33 - 1 = 32) puts every lane's count on one bank; with 38 a line at
// any angle puts at most 6 of a warp's cells on one bank (at most 23 at 33)
constexpr int kCellPitch = 38;
constexpr int kCells = kCellSide * kCellPitch;
constexpr int kGainSide = kOwn + 2;
// the gain window's row pitch in doubles: with 34, a warp's queries along a
// line at -30 degrees read their gain taps 8 to a bank pair; with 36 at most
// 4 at any angle
constexpr int kGainPitch = 36;
constexpr int kBand = 4;
constexpr int kPlanThreads = 256;
constexpr int kChunk = 1280;
constexpr int kChunkPerThread = kChunk / kPlanThreads;
constexpr int kGroupBands = 16;
constexpr int kSegs = kGroupBands * kBand;
constexpr int kCellsPerThread = (kCells + kPlanThreads - 1) / kPlanThreads;
constexpr int kPixPerThread = kOwn * kOwn / kPlanThreads;
// one staging buffer: a CTA stages a chunk, then computes it, and four CTAs
// an SM overlap one another's copies and work (a second buffer, the next
// chunk's copies in flight while one computes, fits two CTAs an SM and took
// 0.538 / 0.518 ms against 0.383 / 0.380 on the first destripe pair, f64 /
// f32 positions; H100 80GB HBM3 at 700 W)
constexpr int kMinBlocks = 4;
static_assert(kSegs == 64, "warp 0 expands a group's segments, two a lane");
static_assert(kCells < 2048 && kChunk <= 2048, "a cell and its slot share one int");
static_assert(kChunk % kPlanThreads == 0 && kChunk <= 65536, "staging indices are 16-bit");
static_assert(kPixPerThread == 4 && kPlanThreads == 256 && kOwn == 32,
              "a thread a 2 x 2 block of pixels");

// The dynamic shared memory of the planned body (bytes): the staging
// buffer (the values, then x, then y), the gain window, the cell
// counts (then, scanned in place, the cells' starts), the staging indices
// in cell order, a group's segments, the warp sums of the scan, the chunk
// counts, and the plan prefetched ahead of the walk: the words (first and
// last query row, first band and one past the last) of kWordSlots tiles
// and the first band group's spans of kSpanSlots tiles.
constexpr int kWordSlots = 3, kSpanSlots = 2;
template <typename Pos>
struct PlanLayout {
  static constexpr int kStageBytes =
      kChunk * static_cast<int>(sizeof(double) + 2 * sizeof(Pos));
  static constexpr int kGainBytes = kGainSide * kGainPitch * static_cast<int>(sizeof(double));
  static constexpr int kGain = kStageBytes;
  static constexpr int kCount = kGain + kGainBytes;
  static constexpr int kOrder = kCount + 4 * (kCells + 1);
  static constexpr int kSegRow = kOrder + 2 * kChunk;
  static constexpr int kSegLo = kSegRow + 4 * kSegs;
  static constexpr int kSegPre = kSegLo + 4 * kSegs;
  static constexpr int kWarpSum = kSegPre + 4 * (kSegs + 1);
  static constexpr int kDesc = kWarpSum + 4 * (kPlanThreads / 32);
  static constexpr int kWords = kDesc + 4 * 2;
  static constexpr int kSpans = kWords + 4 * 4 * kWordSlots;
  static constexpr int kBytes = kSpans + 4 * kGroupBands * kSpanSlots;
};

template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(N)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A chunk of a CTA's walk (the same in every thread).
struct Chunk {
  int tile;   // the output tile; -1: the walk has ended
  int group;  // its band group
  int e0;     // the chunk's first query among the group's
  int n;      // its queries
  int total;  // the group's queries
  int nb;     // the tile's bands
  int tseq;   // its tile's ordinal in the walk (the prefetched plan's slots)
};

__device__ __forceinline__ bool last_of_tile(const Chunk& c) {
  return c.e0 + kChunk >= c.total && (c.group + 1) * kGroupBands >= c.nb;
}

__device__ __forceinline__ Chunk next_chunk(const Chunk& c, int tiles) {
  Chunk s = c;
  if (c.e0 + kChunk < c.total) {
    s.e0 = c.e0 + kChunk;
  } else if ((c.group + 1) * kGroupBands < c.nb) {
    s.group = c.group + 1;
    s.e0 = 0;
  } else {
    s.tile = c.tile + static_cast<int>(gridDim.x);
    if (s.tile >= tiles) s.tile = -1;
    s.group = 0;
    s.e0 = 0;
    s.tseq = c.tseq + 1;
  }
  return s;
}

// The address of word j of tile t's plan: its first and last query row,
// its first band's index in spans and one past its last.
__device__ __forceinline__ const int* tile_word(const int* rows, const int* ptr, int t, int j) {
  return j < 2 ? rows + 2 * t + j : ptr + t + j - 2;
}

// Start the copies of the plan a tile or two ahead of tile c.tile (warp 0;
// the CTA's tiles are gridDim.x apart): the words of the tile two ahead and
// the first band group's spans of the next (whose words came a tile ago).
template <typename Pos>
__device__ void prefetch_plan(const Chunk& c, char* smem, const int* __restrict__ rows,
                              const int* __restrict__ ptr, const unsigned* __restrict__ spans,
                              int tiles) {
  using L = PlanLayout<Pos>;
  int* words = reinterpret_cast<int*>(smem + L::kWords);
  unsigned* sp = reinterpret_cast<unsigned*>(smem + L::kSpans);
  const int lane = threadIdx.x;
  const int t1 = c.tile + static_cast<int>(gridDim.x), t2 = t1 + static_cast<int>(gridDim.x);
  if (t1 < tiles) {
    const int* w1 = words + 4 * ((c.tseq + 1) % kWordSlots);
    if (lane < min(kGroupBands, w1[3] - w1[2]))
      cp_async<4>(sp + kGroupBands * ((c.tseq + 1) % kSpanSlots) + lane, spans + w1[2] + lane);
  }
  if (t2 < tiles && lane < 4)
    cp_async<4>(words + 4 * ((c.tseq + 2) % kWordSlots) + lane, tile_word(rows, ptr, t2, lane));
}

// Expand chunk c's band group into its row segments (warp 0, from its
// tile's prefetched words and, for the first group, spans; a row segment is
// one query row of a band, its span's columns) with their exclusive prefix
// counts, and fill in c's counts (every thread, after the barrier).
template <typename Pos>
__device__ void describe(Chunk& c, char* smem, const unsigned* __restrict__ spans) {
  using L = PlanLayout<Pos>;
  int* seg_row = reinterpret_cast<int*>(smem + L::kSegRow);
  int* seg_lo = reinterpret_cast<int*>(smem + L::kSegLo);
  int* seg_pre = reinterpret_cast<int*>(smem + L::kSegPre);
  int* desc = reinterpret_cast<int*>(smem + L::kDesc);
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int* tw = reinterpret_cast<const int*>(smem + L::kWords) + 4 * (c.tseq % kWordSlots);
    const unsigned* first =
        reinterpret_cast<const unsigned*>(smem + L::kSpans) + kGroupBands * (c.tseq % kSpanSlots);
    const int row_lo = tw[0], row_hi = tw[1];
    const int p0 = tw[2], nb = tw[3] - p0;
    int w[2], r[2], l[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int sg = 2 * lane + i;
      const int k = c.group * kGroupBands + sg / kBand;
      const int qr = row_lo + k * kBand + sg % kBand;
      w[i] = r[i] = l[i] = 0;
      if (k < nb && qr <= row_hi) {
        const unsigned sp = c.group == 0 ? first[k] : spans[p0 + k];
        const int lo = static_cast<int>(sp & 0xffffu), hi = static_cast<int>(sp >> 16);
        if (lo <= hi) {
          w[i] = hi - lo + 1;
          r[i] = qr;
          l[i] = lo;
        }
      }
    }
    const int mine = w[0] + w[1];
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    seg_row[2 * lane] = r[0];
    seg_row[2 * lane + 1] = r[1];
    seg_lo[2 * lane] = l[0];
    seg_lo[2 * lane + 1] = l[1];
    seg_pre[2 * lane] = incl - mine;
    seg_pre[2 * lane + 1] = incl - mine + w[0];
    if (lane == 31) {
      seg_pre[kSegs] = incl;
      desc[0] = incl;
      desc[1] = nb;
    }
  }
  __syncthreads();
  c.total = desc[0];
  c.nb = desc[1];
  c.n = max(0, min(kChunk, c.total - c.e0));
}

// Start the copies of chunk c into its staging buffer (warp w the row
// segments w, w + 8, ..., its lanes along the columns), and, on its tile's
// first chunk, of the tile's gain window (the pixels on the image).
template <typename Pos>
__device__ void issue(const Chunk& c, char* smem, const double* __restrict__ values,
                      const double* __restrict__ gain, int ny, int nx,
                      const Pos* __restrict__ xf, const Pos* __restrict__ yf, int qnx,
                      int tiles_x) {
  using L = PlanLayout<Pos>;
  double* sv = reinterpret_cast<double*>(smem);
  Pos* sx = reinterpret_cast<Pos*>(smem + kChunk * sizeof(double));
  Pos* sy = sx + kChunk;
  const int* seg_row = reinterpret_cast<const int*>(smem + L::kSegRow);
  const int* seg_lo = reinterpret_cast<const int*>(smem + L::kSegLo);
  const int* seg_pre = reinterpret_cast<const int*>(smem + L::kSegPre);
  const int lane = threadIdx.x & 31, e_hi = c.e0 + c.n;
  for (int sg = threadIdx.x >> 5; sg < kSegs; sg += kPlanThreads / 32) {
    const int p0 = seg_pre[sg];
    const int a = max(p0, c.e0), b = min(seg_pre[sg + 1], e_hi);
    if (a >= b) continue;
    // query e of the group lies at base + e of the grid
    const long long base = static_cast<long long>(seg_row[sg]) * qnx + seg_lo[sg] - p0;
    for (int e = a + lane; e < b; e += 32) {
      const int el = e - c.e0;
      cp_async<8>(sv + el, values + base + e);
      cp_async<static_cast<int>(sizeof(Pos))>(sx + el, xf + base + e);
      cp_async<static_cast<int>(sizeof(Pos))>(sy + el, yf + base + e);
    }
  }
  if (gain != nullptr && c.group == 0 && c.e0 == 0) {
    double* sg = reinterpret_cast<double*>(smem + L::kGain);
    const int wy = (c.tile / tiles_x) * kOwn - 1, wx = (c.tile % tiles_x) * kOwn - 1;
    for (int r = threadIdx.x >> 5; r < kGainSide; r += kPlanThreads / 32) {
      const int gy = wy + r;
      if (gy < 0 || gy >= ny) continue;
      for (int i = lane; i < kGainSide; i += 32)
        if (wx + i >= 0 && wx + i < nx)
          cp_async<8>(sg + r * kGainPitch + i, gain + static_cast<long long>(gy) * nx + wx + i);
    }
  }
}

// Add chunk c's products into each thread's pixel sums acc: the 2 x 2
// pixels (2 (threadIdx.x / 16) + i / 2, 2 (threadIdx.x % 16) + i % 2) of
// the tile.
template <typename Pos>
__device__ void compute(const Chunk& c, char* smem, bool weighted, int ny, int nx, int tiles_x,
                        double acc[kPixPerThread]) {
  using L = PlanLayout<Pos>;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  double* sv = reinterpret_cast<double*>(smem);
  const Pos* sx = reinterpret_cast<const Pos*>(smem + kChunk * sizeof(double));
  const Pos* sy = sx + kChunk;
  const double* sg = reinterpret_cast<const double*>(smem + L::kGain);
  int* cnt = reinterpret_cast<int*>(smem + L::kCount);
  int* start = cnt;  // after step 2
  unsigned short* order = reinterpret_cast<unsigned short*>(smem + L::kOrder);
  int* wsum = reinterpret_cast<int*>(smem + L::kWarpSum);
  // the window's first tap cell
  const int wy = (c.tile / tiles_x) * kOwn - 1, wx = (c.tile % tiles_x) * kOwn - 1;

  // 1. each staged query's tap; those in the window get their value over
  //    the gain norm (in place) and a place among their cell's (a 32-bit
  //    shared atomic: the order within a cell is fixed in step 4)
  int place[kChunkPerThread];  // cell | slot << 11, -1 outside the window
#pragma unroll
  for (int j = 0; j < kChunkPerThread; ++j) {
    const int el = t + j * kPlanThreads;
    place[j] = -1;
    if (el < c.n) {
      const double x = static_cast<double>(sx[el]), y = static_cast<double>(sy[el]);
      int ix, iy;
      if (tap_floor(x, y, nx, ny, &ix, &iy)) {
        const int cy = iy - wy, cx = ix - wx;
        if (static_cast<unsigned>(cy) < kCellSide && static_cast<unsigned>(cx) < kCellSide) {
          if (weighted) {
            const double* g = sg + cy * kGainPitch + cx;
            double w[4];
            bilinear_weights(x - ix, y - iy, w);
            w[0] *= g[0];
            w[1] *= g[1];
            w[2] *= g[kGainPitch];
            w[3] *= g[kGainPitch + 1];
            const double norm = w[0] + w[1] + w[2] + w[3];
            sv[el] = sv[el] / (norm > 0.0 ? norm : 1.0);
          }
          const int cc = cy * kCellPitch + cx;
          place[j] = cc | (atomicAdd(cnt + cc, 1) << 11);
        }
      }
    }
  }
  __syncthreads();

  // 2. where each cell's queries start: an exclusive scan of the counts in
  //    place, kCellsPerThread consecutive cells a thread (the kernel zeroes
  //    them again after the chunk)
  {
    int loc[kCellsPerThread], sum = 0;
#pragma unroll
    for (int i = 0; i < kCellsPerThread; ++i) {
      const int cc = t * kCellsPerThread + i;
      loc[i] = cc < kCells ? cnt[cc] : 0;
      sum += loc[i];
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    int run = incl - sum;
    for (int w = 0; w < warp; ++w) run += wsum[w];
#pragma unroll
    for (int i = 0; i < kCellsPerThread; ++i) {
      const int cc = t * kCellsPerThread + i;
      if (cc < kCells) start[cc] = run;
      run += loc[i];
    }
    if (t == kPlanThreads - 1) start[kCells] = run;
  }
  __syncthreads();

  // 3. each window query's staging index at its place
#pragma unroll
  for (int j = 0; j < kChunkPerThread; ++j)
    if (place[j] >= 0)
      order[start[place[j] & 2047] + (place[j] >> 11)] =
          static_cast<unsigned short>(t + j * kPlanThreads);
  __syncthreads();

  // 4. each cell's few queries in staging order (insertion sort)
  for (int cc = t; cc < kCells; cc += kPlanThreads) {
    const int lo = start[cc], hi = start[cc + 1];
    for (int a = lo + 1; a < hi; ++a) {
      const unsigned short key = order[a];
      int b = a - 1;
      while (b >= lo && order[b] > key) {
        order[b + 1] = order[b];
        --b;
      }
      order[b + 1] = key;
    }
  }
  __syncthreads();

  // 5. each thread's 2 x 2 pixels (rows 2 pa + dy, columns 2 pb + dx) take
  //    the products of their 3 x 3 cells: each cell's queries once, in
  //    staging order, the cells row-major (a pixel's four give it w3, w2,
  //    w1, then w0, its own tap's)
  const int pa = t >> 4, pb = t & 15;
  double gp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    gp[i] = weighted ? sg[(2 * pa + (i >> 1) + 1) * kGainPitch + 2 * pb + (i & 1) + 1] : 1.0;
#pragma unroll
  for (int ry = 0; ry < 3; ++ry) {
#pragma unroll
    for (int rx = 0; rx < 3; ++rx) {
      // the cell's tap is the block's pixel (ry - 1, rx - 1): it gives w0 to
      // that pixel, w1 to the one right, w2 below, w3 below right
      const int cc = (2 * pa + ry) * kCellPitch + 2 * pb + rx;
      const double ix = wx + 2 * pb + rx, iy = wy + 2 * pa + ry;
      const int hi = start[cc + 1];
      for (int e = start[cc]; e < hi; ++e) {
        const int q = order[e];
        const double fx = static_cast<double>(sx[q]) - ix, fy = static_cast<double>(sy[q]) - iy;
        const double v = sv[q];
        if (ry >= 1 && rx >= 1) {
          const double w = (1.0 - fx) * (1.0 - fy);
          acc[(ry - 1) * 2 + rx - 1] += v * (weighted ? w * gp[(ry - 1) * 2 + rx - 1] : w);
        }
        if (ry >= 1 && rx <= 1) {
          const double w = fx * (1.0 - fy);
          acc[(ry - 1) * 2 + rx] += v * (weighted ? w * gp[(ry - 1) * 2 + rx] : w);
        }
        if (ry <= 1 && rx >= 1) {
          const double w = (1.0 - fx) * fy;
          acc[ry * 2 + rx - 1] += v * (weighted ? w * gp[ry * 2 + rx - 1] : w);
        }
        if (ry <= 1 && rx <= 1) {
          const double w = fx * fy;
          acc[ry * 2 + rx] += v * (weighted ? w * gp[ry * 2 + rx] : w);
        }
      }
    }
  }
}

// One CTA a tile at a time, tiles blockIdx.x + k gridDim.x, each walked in
// chunks (next_chunk): stage a chunk, compute it, then expand the next
// chunk's segments and start its copies.
template <typename Pos>
__global__ void __launch_bounds__(kPlanThreads, kMinBlocks)
    planned_adjoint_kernel(const double* __restrict__ values, const double* __restrict__ gain,
                           int ny, int nx, const Pos* __restrict__ xf,
                           const Pos* __restrict__ yf, int qnx, const int* __restrict__ rows,
                           const int* __restrict__ ptr, const unsigned* __restrict__ spans,
                           double* __restrict__ out, int accumulate) {
  using L = PlanLayout<Pos>;
  extern __shared__ __align__(16) char smem[];
  const int tiles_x = (nx + kOwn - 1) / kOwn;
  const int tiles = ((ny + kOwn - 1) / kOwn) * tiles_x;
  int* cnt = reinterpret_cast<int*>(smem + L::kCount);
  for (int i = threadIdx.x; i <= kCells; i += kPlanThreads) cnt[i] = 0;
  double acc[kPixPerThread];
#pragma unroll
  for (int i = 0; i < kPixPerThread; ++i) acc[i] = 0.0;

  Chunk cur{static_cast<int>(blockIdx.x), 0, 0, 0, 0, 0, 0};
  if (threadIdx.x < 32) {
    // the first tile's words and first spans, and the next tile's words
    int* words = reinterpret_cast<int*>(smem + L::kWords);
    unsigned* sp = reinterpret_cast<unsigned*>(smem + L::kSpans);
    const int lane = threadIdx.x, t1 = cur.tile + static_cast<int>(gridDim.x);
    if (lane < 4) words[lane] = *tile_word(rows, ptr, cur.tile, lane);
    if (lane >= 4 && lane < 8 && t1 < tiles) words[lane] = *tile_word(rows, ptr, t1, lane - 4);
    __syncwarp();
    if (lane < min(kGroupBands, words[3] - words[2])) sp[lane] = spans[words[2] + lane];
    __syncwarp();
    prefetch_plan<Pos>(cur, smem, rows, ptr, spans, tiles);
  }
  describe<Pos>(cur, smem, spans);
  issue<Pos>(cur, smem, values, gain, ny, nx, xf, yf, qnx, tiles_x);
  cp_async_commit();
  __syncthreads();  // the segments are the next describe's
  while (cur.tile >= 0) {
    Chunk nxt = next_chunk(cur, tiles);
    cp_async_wait<0>();
    __syncthreads();
    if (cur.n > 0) compute<Pos>(cur, smem, gain != nullptr, ny, nx, tiles_x, acc);
    if (last_of_tile(cur)) {
      // one store a pixel; into `out`, one read-add-write (none on a tile
      // without a band: it adds nothing)
      const int r0 = (cur.tile / tiles_x) * kOwn, c0 = (cur.tile % tiles_x) * kOwn;
#pragma unroll
      for (int i = 0; i < kPixPerThread; ++i) {
        const int r = r0 + 2 * (threadIdx.x >> 4) + (i >> 1);
        const int col = c0 + 2 * (threadIdx.x & 15) + (i & 1);
        if (r < ny && col < nx && !(accumulate && cur.nb == 0)) {
          double* o = out + static_cast<long long>(r) * nx + col;
          *o = accumulate ? *o + acc[i] : acc[i];
        }
        acc[i] = 0.0;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i <= kCells; i += kPlanThreads) cnt[i] = 0;
    // the next chunk's segments and copies (on a new tile, the plan a tile
    // or two ahead of it prefetched; those copies land with the chunk's)
    if (nxt.tile >= 0) {
      describe<Pos>(nxt, smem, spans);
      if (nxt.tile != cur.tile && threadIdx.x < 32)
        prefetch_plan<Pos>(nxt, smem, rows, ptr, spans, tiles);
      issue<Pos>(nxt, smem, values, gain, ny, nx, xf, yf, qnx, tiles_x);
    }
    cp_async_commit();
    cur = nxt;
  }
}

template <typename Pos>
int scatter_planned(const double* values, const double* gain, int ny, int nx, const Pos* xf,
                    const Pos* yf, int qnx, const int* rows, const int* ptr,
                    const unsigned* spans, double* out, int accumulate, void* stream) {
  const long long tiles = static_cast<long long>((ny + kOwn - 1) / kOwn) *
                          ((nx + kOwn - 1) / kOwn);
  if (tiles <= 0) return static_cast<int>(cudaGetLastError());
  if (tiles > INT_MAX || qnx > 65535) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = PlanLayout<Pos>::kBytes;
  cudaFuncSetAttribute(planned_adjoint_kernel<Pos>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  int dev = 0, nsm = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, planned_adjoint_kernel<Pos>, kPlanThreads,
                                                smem);
  const int grid = static_cast<int>(
      std::min<long long>(tiles, static_cast<long long>(std::max(per, 1)) * std::max(nsm, 1)));
  planned_adjoint_kernel<Pos><<<grid, kPlanThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      values, gain, ny, nx, xf, yf, qnx, rows, ptr, spans, out, accumulate);
  return static_cast<int>(cudaGetLastError());
}

int blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < (1LL << 20) ? b : (1LL << 20));
}

// ---- K4's plan, built on the card --------------------------------------------
// The plan of a (qny, qnx) query grid on the (ny, nx) output (the planned
// body's note above; ops/bilinear_cuda.build_adjoint_plan), in one C entry:
// a fill of the scratch, one pass over the positions and two small kernels
// over the tiles, with no host synchronisation.  A query in bounds adds
// into the tile of its floor tap's pixel and, where the tap's other pixels
// fall in another tile, the tile below, right and below-right (plan_tiles:
// four slots, -1 for none).  Along a row a slot's tile holds for a run of
// columns (a pair map is near-affine), so the pass reduces only at a run's
// first query (its column into the tile's ring entry of this row, and the
// row into the tile's first and last row) and at its last (its column),
// as the plain version (build_adjoint_plan_plain) reduces one entry a run.
// A band's columns are those of its rows, so the pass keeps each tile's
// columns a row -- in a ring of kRing rows (row mod kRing), since a tile's
// first row is not known until the pass ends -- and the spans kernel takes
// a band's span as the extremes of its rows' entries: the plan of the two
// passes this replaces (commit 379dcb5: rows, a read-back of the most
// bands of a tile, then columns a band) word for word, reading the
// positions once.  A tile whose rows span kRing or more (a map shrunk by
// ~0.2 or more) would wrap its ring: it gets no band and counts as
// overflowed (meta[3]); the wrapper reads the count at its first read-back
// and runs K4 over such a plan's positions by the off-plan body
// (bilinear_cuda.plan_route).
//
// The pass: a warp takes kPlanSegQ consecutive queries of a row, loads all
// their positions first (kPlanSegQ / 32 loads of x and of y a lane in
// flight), and finds each query's left and right neighbours' tiles by
// shuffles, lane 31's right neighbour from the next 32 (the segment's ends
// count as a run's ends: a redundant extreme, no divergent reload).  Its
// atomics are what it costs beyond its loads (k4_variants.py, a synthetic
// 4088^2 pair at a roll of 0, f64 / f32 positions, H100 80GB HBM3, 700 W):
// without them it built the plan in 0.131 / 0.095 ms against 0.193 / 0.170
// with them, without its tiles' row atomics alone in 0.152 / 0.136.  So
// where a slot-0 (1) run of a tile follows the left neighbour's slot-2 (3)
// run of the same tile -- a tile's first column, at any roll -- its start
// is left to that run, and that run's end to it: half the atomics, the
// same extremes (an atomic at every run's start and end: 0.217 / 0.197).
// Segments of 128 queries were no faster (0.187 / 0.164 at 0, 0.194 /
// 0.170 at 45 against 0.189 / 0.170), a ring of 128 rows 0.014 ms faster (a
// smaller fill) but short of the rows a map shrunk 0.3x spreads a tile
// over; a block of 8 rows gathering its tiles' rows in a table in shared
// memory (compare-and-swap, one flush a tile) was slower at every roll.  The counts kernel takes kPlanScan tiles a block: each tile's rows
// and band count, a block scan of the counts (ptr, local), the block's
// sum; the spans kernel takes a warp a tile: its first band from the
// blocks' sums before it, then each band's span from the ring, the window,
// and the last tile the bands in all.  The scratch starts from byte fills
// (0x7f7f7f7f above any row or column, -1 below).
constexpr int kRing = 256;          // rows of a tile's ring (a power of two)
constexpr int kPlanSegQ = 256;      // queries of a row a warp takes
constexpr int kPlanScan = 2048;     // tiles of a counts block
constexpr int kPlanScanPer = kPlanScan / kThreads;
static_assert((kRing & (kRing - 1)) == 0 && kPlanSegQ % 32 == 0, "ring and segment shape");
static_assert(kPlanScanPer * kThreads == kPlanScan, "a counts block's tiles");

template <typename Pos>
__device__ __forceinline__ int plan_tiles(Pos xv, Pos yv, int ny, int nx, int tiles_x,
                                          int t[4]) {
  t[0] = t[1] = t[2] = t[3] = -1;
  int ix, iy;
  if (!tap_floor(static_cast<double>(xv), static_cast<double>(yv), nx, ny, &ix, &iy)) return 0;
  const int ty0 = iy / kOwn, tx0 = ix / kOwn, ty1 = (iy + 1) / kOwn, tx1 = (ix + 1) / kOwn;
  const bool down = ty1 != ty0, right = tx1 != tx0;
  t[0] = ty0 * tiles_x + tx0;
  if (down) t[1] = ty1 * tiles_x + tx0;
  if (right) t[2] = ty0 * tiles_x + tx1;
  if (down && right) t[3] = ty1 * tiles_x + tx1;
  return 1 + down + right + (down && right);
}

// The pass over the positions: lo = [row_lo (T), ring_lo (T kRing)], hi =
// [row_hi (T), ring_hi (T kRing)], the incidences added into *pairs.
template <typename Pos>
__global__ void __launch_bounds__(kThreads)
    plan_pass_kernel(const Pos* __restrict__ xf, const Pos* __restrict__ yf, int qny, int qnx,
                     int ny, int nx, int T, int* __restrict__ lo, int* __restrict__ hi,
                     unsigned long long* __restrict__ pairs) {
  constexpr int kChunks = kPlanSegQ / 32;
  __shared__ int warp_sums[kThreads / 32];
  const int tiles_x = (nx + kOwn - 1) / kOwn, lane = threadIdx.x & 31;
  const int segs_x = (qnx + kPlanSegQ - 1) / kPlanSegQ;
  const long long segs = static_cast<long long>(qny) * segs_x;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  int* ring_lo = lo + T;
  int* ring_hi = hi + T;
  int count = 0;
  for (long long w = blockIdx.x * (kThreads / 32LL) + (threadIdx.x >> 5); w < segs;
       w += warps) {
    const int qr = static_cast<int>(w / segs_x);
    const int c0 = static_cast<int>(w - static_cast<long long>(qr) * segs_x) * kPlanSegQ;
    const Pos* xr = xf + static_cast<long long>(qr) * qnx;
    const Pos* yr = yf + static_cast<long long>(qr) * qnx;
    Pos xv[kChunks], yv[kChunks];
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = c0 + 32 * j + lane;
      xv[j] = c < qnx ? xr[c] : Pos(-1);
      yv[j] = c < qnx ? yr[c] : Pos(-1);
    }
    int t[kChunks][4];
#pragma unroll
    for (int j = 0; j < kChunks; ++j) count += plan_tiles(xv[j], yv[j], ny, nx, tiles_x, t[j]);
    const int rr = qr & (kRing - 1);
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      // each slot's tile at the query's left and right neighbours (the
      // segment's ends: -2, a run's end)
      int left[4], right[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        left[k] = __shfl_up_sync(0xffffffffu, t[j][k], 1);
        right[k] = __shfl_down_sync(0xffffffffu, t[j][k], 1);
        const int prev = j > 0 ? __shfl_sync(0xffffffffu, t[j > 0 ? j - 1 : 0][k], 31) : -2;
        const int next =
            j + 1 < kChunks ? __shfl_sync(0xffffffffu, t[j + 1 < kChunks ? j + 1 : j][k], 0) : -2;
        if (lane == 0) left[k] = prev;
        if (lane == 31) right[k] = next;
      }
      const int c = c0 + 32 * j + lane;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int tk = t[j][k];
        if (tk < 0) continue;
        // a slot-0 (1) run of a tile that the left neighbour's slot-2 (3)
        // run of the same tile precedes leaves its first column and its
        // row to that run; a slot-2 (3) run that the right neighbour's
        // slot-0 (1) run of the same tile follows leaves its last column
        // to that run: half the atomics, the same extremes
        const bool start = tk != left[k] && !(k < 2 && left[k < 2 ? k + 2 : k] == tk);
        const bool end = tk != right[k] && !(k >= 2 && right[k >= 2 ? k - 2 : k] == tk);
        if (start) {
          atomicMin(ring_lo + tk * kRing + rr, c);
          atomicMin(lo + tk, qr);
          atomicMax(hi + tk, qr);
        }
        if (end) atomicMax(ring_hi + tk * kRing + rr, c);
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) count += __shfl_xor_sync(0xffffffffu, count, o);
  if (lane == 0) warp_sums[threadIdx.x >> 5] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    if (total) atomicAdd(pairs, static_cast<unsigned long long>(total));
  }
}

// Each tile's words -- rows[2t], rows[2t + 1] its first and last query row
// ((0, -1) without a query), ptr[t] its first band among its block's (an
// exclusive scan of the band counts) -- and the block's bands in bsum[b]; a
// tile whose rows span kRing or more gets no band and adds one to
// *overflow.
__global__ void __launch_bounds__(kThreads)
    plan_counts_kernel(const int* __restrict__ lo, const int* __restrict__ hi, int T,
                       int* __restrict__ rows, int* __restrict__ ptr, int* __restrict__ bsum,
                       unsigned long long* __restrict__ overflow) {
  __shared__ int warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int base = blockIdx.x * kPlanScan + threadIdx.x * kPlanScanPer;
  int nb[kPlanScanPer], sum = 0, over = 0;
#pragma unroll
  for (int k = 0; k < kPlanScanPer; ++k) {
    const int t = base + k;
    nb[k] = 0;
    if (t >= T) continue;
    const int a = lo[t], b = hi[t];
    const bool live = b >= 0;
    rows[2 * t] = live ? a : 0;
    rows[2 * t + 1] = live ? b : -1;
    if (live && b - a >= kRing)
      ++over;
    else if (live)
      nb[k] = (b - a) / kBand + 1;
    sum += nb[k];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int run = incl - sum, total = 0;
  for (int w = 0; w < kThreads / 32; ++w) {
    if (w < warp) run += warp_sums[w];
    total += warp_sums[w];
  }
#pragma unroll
  for (int k = 0; k < kPlanScanPer; ++k) {
    if (base + k < T) ptr[base + k] = run;
    run += nb[k];
  }
  if (threadIdx.x == 0) bsum[blockIdx.x] = total;
  for (int o = 16; o > 0; o >>= 1) over += __shfl_xor_sync(0xffffffffu, over, o);
  if (lane == 0 && over) atomicAdd(overflow, static_cast<unsigned long long>(over));
}

// A warp a tile: ptr[t] made global (the sums of the counts blocks before
// its own), each band's span lo | hi << 16 at spans[ptr[t] + k] (0xffff | 0
// without a query) from the extremes of its rows' ring entries (a lane a
// row, the band's kBand lanes reduced by shuffles), its staged
// queries (rows times columns) added into *window; the last tile writes
// ptr[T] and the bands in all (*bands).
__global__ void __launch_bounds__(kThreads)
    plan_spans_kernel(const int* __restrict__ lo, const int* __restrict__ hi, int T,
                      const int* __restrict__ rows, int* __restrict__ ptr,
                      const int* __restrict__ bsum, unsigned* __restrict__ spans,
                      long long* __restrict__ bands, unsigned long long* __restrict__ window) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (t >= T) return;
  const int b = t / kPlanScan;
  int before = 0;
  for (int i = lane; i < b; i += 32) before += bsum[i];
  for (int o = 16; o > 0; o >>= 1) before += __shfl_xor_sync(0xffffffffu, before, o);
  const int r0 = rows[2 * t], r1 = rows[2 * t + 1];
  const int nb = r1 >= 0 && r1 - r0 < kRing ? (r1 - r0) / kBand + 1 : 0;
  const int p0 = before + ptr[t];
  const int* ring_lo = lo + T + static_cast<long long>(t) * kRing;
  const int* ring_hi = hi + T + static_cast<long long>(t) * kRing;
  // a lane a row, a band the extremes of kBand lanes' rows
  static_assert(32 % kBand == 0 && kBand == 4, "a band is 4 lanes of a warp");
  long long win = 0;
  const int nrows = nb ? r1 - r0 + 1 : 0;
  for (int base = 0; base < nrows; base += 32) {
    const int i = base + lane, r = r0 + i;
    int a = i < nrows ? ring_lo[r & (kRing - 1)] : INT_MAX;
    int z = i < nrows ? ring_hi[r & (kRing - 1)] : -1;
#pragma unroll
    for (int o = 1; o < kBand; o <<= 1) {
      a = min(a, __shfl_xor_sync(0xffffffffu, a, o));
      z = max(z, __shfl_xor_sync(0xffffffffu, z, o));
    }
    if ((lane & (kBand - 1)) == 0 && i < nrows) {
      const int k = i / kBand, first = r0 + kBand * k, last = min(first + kBand - 1, r1);
      if (z < 0) {
        a = 0xffff;
        z = 0;
      } else {
        win += static_cast<long long>(last - first + 1) * (z - a + 1);
      }
      spans[p0 + k] = static_cast<unsigned>(a) | (static_cast<unsigned>(z) << 16);
    }
  }
  for (int o = 16; o > 0; o >>= 1) win += __shfl_xor_sync(0xffffffffu, win, o);
  __syncwarp();
  if (lane == 0) {
    ptr[t] = p0;
    if (win) atomicAdd(window, static_cast<unsigned long long>(win));
    if (t == T - 1) {
      ptr[T] = p0 + nb;
      *bands = p0 + nb;
    }
  }
}

// A grid of at most 8 blocks of kThreads an SM (every thread resident).
int resident_blocks(long long n) {
  int dev = 0, nsm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  return std::min(blocks_for(n), 8 * std::max(nsm, 1));
}

// The plan: scratch (2, T (kRing + 1) + T / kPlanScan + 1) int32 (the rows
// and rings, the counts blocks' sums), rows (T, 2), ptr (T + 1) and spans
// (at least T ceil(min(qny, kRing) / kBand)) int32 written (the plan's),
// meta (4,) int64 written: the incidences, the bands, the window and the
// tiles that overflowed their ring.
template <typename Pos>
int plan(const Pos* xf, const Pos* yf, int qny, int qnx, int ny, int nx, int* scratch, int* rows,
         int* ptr, unsigned* spans, long long* meta, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int T = ((ny + kOwn - 1) / kOwn) * ((nx + kOwn - 1) / kOwn);
  if (T <= 0 || static_cast<long long>(T) * kRing >= INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long ring = static_cast<long long>(T) * (kRing + 1);
  const int nblk = (T + kPlanScan - 1) / kPlanScan;
  int* lo = scratch;
  int* hi = scratch + ring;
  int* bsum = hi + ring;
  cudaMemsetAsync(lo, 0x7f, sizeof(int) * ring, s);
  cudaMemsetAsync(hi, 0xff, sizeof(int) * ring, s);
  cudaMemsetAsync(meta, 0, 4 * sizeof(long long), s);
  auto* m = reinterpret_cast<unsigned long long*>(meta);
  const long long segs = static_cast<long long>(qny) * ((qnx + kPlanSegQ - 1) / kPlanSegQ);
  if (segs > 0)
    plan_pass_kernel<Pos><<<resident_blocks(segs * 32), kThreads, 0, s>>>(
        xf, yf, qny, qnx, ny, nx, T, lo, hi, m);
  plan_counts_kernel<<<nblk, kThreads, 0, s>>>(lo, hi, T, rows, ptr, bsum, m + 3);
  plan_spans_kernel<<<(T + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, s>>>(
      lo, hi, T, rows, ptr, bsum, spans, meta + 1, m + 2);
  return static_cast<int>(cudaGetLastError());
}

template <typename Pos>
int gather(const double* image, const double* gain, int ny, int nx, const Pos* xf, const Pos* yf,
           long long n, double* out, int accumulate, void* stream) {
  if (n > 0) {
    gather_kernel<Pos><<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        image, gain, ny, nx, xf, yf, n, out, accumulate);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename Pos>
int scatter_stream(const double* values, const double* gain, int ny, int nx, const Pos* xf,
                   const Pos* yf, int qny, int qnx, double* out,
                   unsigned long long* off_plan_tiles, void* stream) {
  if (qny > 0 && qnx > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (qny == 1)
      launch_adjoint<kTileQueries, Pos>(values, gain, ny, nx, xf, yf, qny, qnx, out,
                                        off_plan_tiles, s);
    else
      launch_adjoint<32, Pos>(values, gain, ny, nx, xf, yf, qny, qnx, out, off_plan_tiles, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K3.  image, gain (ny, nx) f64 (gain may be NULL: no gain); xf, yf, out (n,)
// f64; all contiguous, on the device of `stream`; ny * nx < 2**31.  With
// `accumulate` the value is added into out, else written.  Returns
// cudaGetLastError() after the launch.
int bilinear_gather(const double* image, const double* gain, int ny, int nx, const double* xf,
                    const double* yf, long long n, double* out, int accumulate, void* stream) {
  return gather<double>(image, gain, ny, nx, xf, yf, n, out, accumulate, stream);
}

// K3 on float32 positions xf, yf; everything else as bilinear_gather.
int bilinear_gather_f32(const double* image, const double* gain, int ny, int nx, const float* xf,
                        const float* yf, long long n, double* out, int accumulate,
                        void* stream) {
  return gather<float>(image, gain, ny, nx, xf, yf, n, out, accumulate, stream);
}

// K4, planned.  values, xf, yf f64 on a (qny, qnx) query grid, row-major,
// qnx <= 65535; gain (ny, nx) f64 or NULL; rows (T, 2), ptr (T + 1) int32
// and spans int32 the plan of these positions for the T = ceil(ny / 32)
// ceil(nx / 32) tiles of the output (ops/bilinear_cuda.build_adjoint_plan);
// out (ny, nx) f64: written whole, or with `accumulate` added into.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for too wide a
// grid).
int bilinear_scatter_adjoint(const double* values, const double* gain, int ny, int nx,
                             const double* xf, const double* yf, int qny, int qnx,
                             const int* rows, const int* ptr, const unsigned* spans, double* out,
                             int accumulate, void* stream) {
  (void)qny;
  return scatter_planned<double>(values, gain, ny, nx, xf, yf, qnx, rows, ptr, spans, out,
                                 accumulate, stream);
}

// K4, planned, on float32 positions xf, yf; everything else as
// bilinear_scatter_adjoint.
int bilinear_scatter_adjoint_f32(const double* values, const double* gain, int ny, int nx,
                                 const float* xf, const float* yf, int qny, int qnx,
                                 const int* rows, const int* ptr, const unsigned* spans,
                                 double* out, int accumulate, void* stream) {
  (void)qny;
  return scatter_planned<float>(values, gain, ny, nx, xf, yf, qnx, rows, ptr, spans, out,
                                accumulate, stream);
}

// K4 off the plan (the tiled body), for a 1-D stream (qny = 1: tiles of 1 x
// 1024 queries) or a grid wider than the plan's columns (32 x 32 tiles).
// values, xf, yf f64 on the (qny, qnx) query grid; gain (ny, nx) f64 or
// NULL; out (ny, nx) f64, to which the kernel adds (the caller zeroes it);
// off_plan_tiles one counter on the device, to which each tile holding a
// query in bounds adds one.  Returns cudaGetLastError() after the launch.
int bilinear_scatter_adjoint_stream(const double* values, const double* gain, int ny, int nx,
                                    const double* xf, const double* yf, int qny, int qnx,
                                    double* out, unsigned long long* off_plan_tiles,
                                    void* stream) {
  return scatter_stream<double>(values, gain, ny, nx, xf, yf, qny, qnx, out, off_plan_tiles,
                                stream);
}

// K4 off the plan on float32 positions; everything else as
// bilinear_scatter_adjoint_stream.
int bilinear_scatter_adjoint_stream_f32(const double* values, const double* gain, int ny,
                                        int nx, const float* xf, const float* yf, int qny,
                                        int qnx, double* out,
                                        unsigned long long* off_plan_tiles, void* stream) {
  return scatter_stream<float>(values, gain, ny, nx, xf, yf, qny, qnx, out, off_plan_tiles,
                               stream);
}

// K4's plan of f64 positions xf, yf on a (qny, qnx) query grid, row-major,
// for the T = ceil(ny / 32) ceil(nx / 32) tiles of the (ny, nx) output:
// scratch (2 (T (256 + 1) + T / 2048 + 1)) int32; rows (T, 2), ptr (T + 1)
// and spans (at least T ceil(min(qny, 256) / 4)) int32 written, the plan;
// meta (4,) int64 written: the (tile, query) incidences, the bands, the
// window and the tiles whose rows span 256 or more (none: the plan is
// whole).  Enqueues its work on `stream` and returns cudaGetLastError()
// without waiting for it.
int bilinear_adjoint_plan(const double* xf, const double* yf, int qny, int qnx, int ny, int nx,
                          int* scratch, int* rows, int* ptr, unsigned* spans, long long* meta,
                          void* stream) {
  return plan<double>(xf, yf, qny, qnx, ny, nx, scratch, rows, ptr, spans, meta, stream);
}

// The plan of float32 positions; everything else as bilinear_adjoint_plan.
int bilinear_adjoint_plan_f32(const float* xf, const float* yf, int qny, int qnx, int ny,
                              int nx, int* scratch, int* rows, int* ptr, unsigned* spans,
                              long long* meta, void* stream) {
  return plan<float>(xf, yf, qny, qnx, ny, nx, scratch, rows, ptr, spans, meta, stream);
}

}  // extern "C"
