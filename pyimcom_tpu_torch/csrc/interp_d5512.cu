// D5512 interpolation kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (pyimcom_tpu_torch/ops/interp_cuda.py).
//
// K1  interp_d5512_dense   replaces the Pallas TPU kernel
//     pyimcom_tpu/ops/interp_pallas.py::_kernel (via interp2d_dense_pallas):
//     R images, R x Nq scattered queries, zero off-grid.
// K2  sweep_d5512_scatter  replaces interp_pallas.py::interp2d_dense_pairs_pallas
//     fused with the pool / -B/2 scatters of
//     pyimcom_tpu/ops/assemble.py::sweep_pool_scan and sweep_b_scan: each
//     query is formed from the f64 coordinate tables, interpolated, and
//     added where it lands.
//
// What bounds them on this card.  Every query reads a 10x10 f64 patch
// (800 bytes) of one image and spends ~420 f64 flops on it.  A launch
// touches at most a few tens of MB of images, which stay resident in the
// 50 MB L2, so a kernel that reads each patch element on its own is bound
// by the L1 / shared-memory path (128 bytes a clock an SM, fewer where a
// warp's reads fall on many cache lines or on one bank), not by HBM or the
// FP64 units.
//
// K1 (interp_dense_warp_kernel).  Its callers send lattices in row-major
// order: PSF sampling pushes the output grid through the WCS chain (a
// rotated, near-affine lattice about one sample apart; most of it falls off
// the PSF image), star and galaxy injection an axis-aligned lattice 6
// samples apart (mostly off the image too).  The least a launch must move
// is x, y and the result, 24 bytes a query, and the images once; against
// that stand 100 patch reads a query, 8 bytes each.  Timed on the main
// path's own launches, the one-thread-a-query kernel this replaces spends
// most of a PSF-sampling launch on the on-grid queries' patch reads, and
// those run at a few lanes a cache line: a warp of 32 consecutive queries
// lies along a slanted line and its loads touch ~20-30 lines each.  The
// design cuts the load instructions and gathers a warp's lanes:
// * A warp takes a run of 32 queries of one image, a lane one query.  Where
//   the caller gives the lattice's row length (PSF sampling does), the run
//   is 8 x 4 neighbouring lattice points, a compact patch of the image, not
//   a slanted line; else it is 32 consecutive queries (the injection
//   lattices, 6 samples apart and axis-aligned, measured faster so).  No
//   host planner: the run follows from the warp's index.  Queries off the
//   grid (or NaN) give 0 and read nothing.
// * A lane reads each patch row as six 16-byte pairs (five where the row
//   starts on an even column) against its ten taps shifted to those twelve
//   samples, where the image rows are 16-byte aligned: 60 load instructions
//   a query, not 100.  The extra samples (in the row, finite) add exact
//   zeros, so each query keeps the order sum_a wy[a] (sum_b wx[b] img) of
//   K2 and the plain version.
// * The patches are read through L1 / L2, not staged: staging the box of a
//   run's patches in shared memory with cp.async cost at least what it saved
//   on every captured launch, at every budget from 2 to 20 KB a warp and
//   for boxes of a block's run, of a warp's run and of a lattice patch.
//
// Also measured and not kept: four neighbouring queries a thread walking
// their shared patch rows once (45 reads a query: 255 registers, lanes four
// queries apart on even more cache lines; 1.3-1.8x slower than the kernel
// it replaces); window rows padded to +-1 bank so that a slanted run is
// conflict-free (slower: no 16-byte copies, larger windows); two or four
// runs a warp (T = 256, 512) with their x and y loaded ahead; fewer
// registers for more warps (spills).
//
// K2 is built around the locality of the sweep's queries, so that the
// patches come from shared memory:
//
// * Pool mode (sweep_pool_kernel).  The host cuts every row's (i1, i2)
//   rectangle into tiles of at most 1024 queries (interp_cuda.sweep_tiles).
//   The queries of a tile are differences of two small pixel patches, so
//   they fall in one window of the overlap image.  A block takes a tile,
//   finds the window of its valid queries, copies it into shared memory with
//   8-byte cp.async loads, and interpolates every query from there.  A tile
//   whose window exceeds the shared-memory budget reads its patches from L2
//   instead and adds one to a counter (l2_tiles).
// * B mode (sweep_b_kernel).  A row pairs one input pixel i1 with the
//   stamp's output grid, an exact integer lattice of n2f x n2f points (the
//   planner raises if the tables do not hold one).  So qx depends only on
//   the output column and qy
//   only on the output row: a block takes one i1, computes n2f x-tap and
//   n2f y-tap sets once, stages the window that the grid covers, forms the
//   horizontal sums for each needed image row and output column once, then
//   the vertical sum for each output pixel.  Both sums keep the summation
//   order of K1's sum_a wy[a] (sum_b wx[b] img).
//
// Index arithmetic inside a query is 32-bit.  Within one launch every
// destination receives at most one query (the planner's rows partition the
// pool and -B/2; tests/test_torch_assemble.py checks it on a real group),
// so the sum does not depend on the order of the adds.  K2 still adds with
// atomicAdd: its result is unused, so it compiles to a reduction that the
// SM issues and forgets, where a plain add must first wait for its load from
// HBM (the pool and -B/2 outgrow L2).
//
// Launch shape: K2 runs 384 threads, at most 85 registers each, so that two
// blocks share an SM together with two 110 KB pool windows.  K1 runs
// blocks of kK1Threads threads (T = kK1Threads queries, one run a warp),
// chosen by timing the main path's captured launches (chip_smoke.py,
// k1_main_path).

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// D5512 coefficients (pyimcom_tpu/ops/interp.py D5512_EVEN / D5512_ODD),
// highest power of fh^2 first.  Row k gives taps w[k] and w[9-k].
__constant__ double kEven[5][5] = {
    {+1.651881673372979740e-05, -3.145538007199505447e-04, +1.793518183780194427e-03,
     -2.904014557029917318e-03, +6.187591260980151433e-04},
    {-1.146756217210629335e-04, +2.883845374976550142e-03, -1.857047531896089884e-02,
     +3.147734488597204311e-02, -6.753293626461192439e-03},
    {+3.256838096371517067e-04, -9.702063770653997568e-03, +8.678848026470635524e-02,
     -1.659182651092198924e-01, +3.620560878249733799e-02},
    {-4.541830837949564726e-04, +1.494862093737218955e-02, -1.668775957435094937e-01,
     +5.879306056792649171e-01, -1.367845996704077915e-01},
    {+2.266560930061513573e-04, -7.815848920941316502e-03, +9.686607348538181506e-02,
     -4.505856722239036105e-01, +6.067135256905490381e-01},
};
__constant__ double kOdd[5][5] = {
    {-3.486978652054735998e-06, +6.753750285320532433e-05, -3.871378836550175566e-04,
     +6.279918076641771273e-04, -1.338434614116611838e-04},
    {+3.121412120355294799e-05, -8.040343683015897672e-04, +5.209574765466357636e-03,
     -8.847326408846412429e-03, +1.898674086370833597e-03},
    {-1.243658986204533102e-04, +3.804930695189636097e-03, -3.434861846914529643e-02,
     +6.581033749134083954e-02, -1.436476114189205733e-02},
    {+2.894406669584551734e-04, -9.794291009695265532e-03, +1.104231510875857830e-01,
     -3.906954914039130755e-01, +9.092432925988773451e-02},
    {-4.336085507644610966e-04, +1.537862263741893339e-02, -1.925091434770601628e-01,
     +8.993141455798455697e-01, -1.213035309579723942e+00},
};

constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 2;  // blocks an SM must hold: caps registers at 85
// shared-memory window of a pool tile: two blocks fit on one SM
constexpr int kPoolWindowBytes = 110 * 1024;

// K1's block: T = kK1Threads queries, a run of 32 a warp
constexpr int kK1Threads = 128;

// The ten D5512 taps for the phase fh = q - floor(q) - 0.5 (Horner in fh^2).
__device__ __forceinline__ void d5512_taps(double fh, double w[10]) {
  const double fh2 = fh * fh;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    double e = kEven[k][0];
    double o = kOdd[k][0];
#pragma unroll
    for (int c = 1; c < 5; ++c) {
      e = e * fh2 + kEven[k][c];
      o = o * fh2 + kOdd[k][c];
    }
    o *= fh;
    w[k] = e + o;
    w[9 - k] = e - o;
  }
}

// True iff the query's 10x10 patch lies inside an (ny, nx) image:
// 4 <= floor(q) < n - 5 on both axes (false for NaN).
__device__ __forceinline__ bool on_grid(double fx, double fy, int ny, int nx) {
  return fx >= 4.0 && fx < static_cast<double>(nx - 5) &&
         fy >= 4.0 && fy < static_cast<double>(ny - 5);
}

// sum_a wy[a] (sum_b wx[b] p[a * stride + b]) of the patch whose corner is p.
template <typename Load>
__device__ __forceinline__ double patch_sum(const double* p, int stride, const double wx[10],
                                            const double wy[10], Load load) {
  double acc = 0.0;
#pragma unroll
  for (int a = 0; a < 10; ++a) {
    const double* row = p + a * stride;
    double s = 0.0;
#pragma unroll
    for (int b = 0; b < 10; ++b) s += wx[b] * load(row + b);
    acc += wy[a] * s;
  }
  return acc;
}

struct LoadGlobal {
  __device__ double operator()(const double* p) const { return __ldg(p); }
};
struct LoadShared {
  __device__ double operator()(const double* p) const { return *p; }
};

__device__ __forceinline__ void cp_async8(double* smem, const double* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}

// Copy rows [y0, y0 + wy) x columns [x0, x0 + wx) of img (row length nx)
// into win (row length wx): one warp per row, neighbouring lanes on
// neighbouring columns.
__device__ void stage_window(double* win, const double* __restrict__ img, int nx, int x0,
                             int y0, int wx, int wy) {
  const int lane = threadIdx.x & 31;
  for (int a = threadIdx.x >> 5; a < wy; a += kWarps) {
    const double* src = img + (y0 + a) * nx + x0;
    for (int b = lane; b < wx; b += 32) cp_async8(win + a * wx + b, src + b);
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
}

// Block-wide [lo, hi] of ints; threads without a value pass INT_MAX / INT_MIN.
// `box` is 4 ints of shared memory: x lo, x hi, y lo, y hi.
__device__ void block_bounds(int* box, int xlo, int xhi, int ylo, int yhi) {
  if (threadIdx.x == 0) {
    box[0] = INT_MAX;
    box[1] = INT_MIN;
    box[2] = INT_MAX;
    box[3] = INT_MIN;
  }
  __syncthreads();
  xlo = __reduce_min_sync(0xffffffffu, xlo);
  xhi = __reduce_max_sync(0xffffffffu, xhi);
  ylo = __reduce_min_sync(0xffffffffu, ylo);
  yhi = __reduce_max_sync(0xffffffffu, yhi);
  if ((threadIdx.x & 31) == 0) {
    if (xlo <= xhi) {
      atomicMin(box + 0, xlo);
      atomicMax(box + 1, xhi);
    }
    if (ylo <= yhi) {
      atomicMin(box + 2, ylo);
      atomicMax(box + 3, yhi);
    }
  }
  __syncthreads();
}

// sum_a wy[a] (sum_b wx[b] img[fy - 4 + a][fx - 4 + b]) read through L1 /
// L2 with 16-byte loads: the image rows must be 16-byte aligned (nx even,
// img on 16 bytes).  Each patch row is read as six pairs from the even
// column at or before fx - 4 (the sixth only where fx - 4 is odd), against
// ten taps shifted to those twelve samples: the extra samples (in the row,
// finite) add exact zeros, so the sum and its order are the ten-tap ones.
__device__ __forceinline__ double patch_sum_pairs(const double* __restrict__ img, int nx,
                                                  int fx, int fy, const double wx[10],
                                                  const double wy[10]) {
  const int c0 = fx - 4;
  const bool odd = c0 & 1;
  double w[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const double even_tap = j < 10 ? wx[j] : 0.0;
    const double odd_tap = j >= 1 && j <= 10 ? wx[j - 1] : 0.0;
    w[j] = odd ? odd_tap : even_tap;
  }
  const double2* p = reinterpret_cast<const double2*>(img + (fy - 4) * nx + (c0 & ~1));
  const int pitch = nx / 2;
  double acc = 0.0;
#pragma unroll
  for (int a = 0; a < 10; ++a) {
    const double2* row = p + a * pitch;
    double s = 0.0;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const double2 v = k < 5 || odd ? __ldg(row + k) : make_double2(0.0, 0.0);
      s += w[2 * k] * v.x;
      s += w[2 * k + 1] * v.y;
    }
    acc += wy[a] * s;
  }
  return acc;
}

// The query of lane `lane` in run t of an image of nq queries, or -1: the
// 32 consecutive queries [32 t, 32 t + 32), or, for a lattice of rows of
// n > 0 queries (nq / n rows), its 8 x 4 points at columns [8 tc, 8 tc + 8)
// and rows [4 tr, 4 tr + 4), t = tr * ctiles + tc.
__device__ __forceinline__ long long run_query(long long t, int lane, long long nq, int n,
                                               long long ctiles) {
  if (n == 0) {
    const long long q = t * 32 + lane;
    return q < nq ? q : -1;
  }
  const long long tr = t / ctiles;
  const long long c = (t - tr * ctiles) * 8 + (lane & 7);
  const long long row = tr * 4 + (lane >> 3);
  return c < n && row * n < nq ? row * n + c : -1;
}

// Warp w of the grid takes run t = w % runs of image r = w / runs
// (run_query), a lane one query; its patch is read in 16-byte pairs where
// `pairs` (nx even, images on 16 bytes), else sample by sample.
__global__ void __launch_bounds__(kK1Threads)
interp_dense_warp_kernel(const double* __restrict__ images, int ny, int nx,
                         const double* __restrict__ x, const double* __restrict__ y,
                         long long nq, int n, long long ctiles, long long runs,
                         long long nruns, bool pairs, double* __restrict__ out) {
  const long long w = static_cast<long long>(blockIdx.x) * (kK1Threads / 32) + (threadIdx.x >> 5);
  if (w >= nruns) return;
  const long long r = w / runs;
  const long long q = run_query(w - r * runs, threadIdx.x & 31, nq, n, ctiles);
  if (q < 0) return;
  const long long i = r * nq + q;
  const double qx = x[i], qy = y[i];
  const double fxd = floor(qx), fyd = floor(qy);
  double v = 0.0;
  if (on_grid(fxd, fyd, ny, nx)) {
    double wxt[10], wyt[10];
    d5512_taps(qx - fxd - 0.5, wxt);
    d5512_taps(qy - fyd - 0.5, wyt);
    const int fx = static_cast<int>(fxd), fy = static_cast<int>(fyd);
    const double* img = images + static_cast<size_t>(r) * ny * nx;
    v = pairs ? patch_sum_pairs(img, nx, fx, fy, wxt, wyt)
              : patch_sum(img + (fy - 4) * nx + (fx - 4), nx, wxt, wyt, LoadGlobal());
  }
  out[i] = v;
}

// Row metadata of both modes (int32): imeta [i1_start, i2_start, w2, off,
// nval]; pool dmeta [dst_base0, w2, stride, off, nval], B dmeta [dst_base,
// col0, off, nval].  Query j < nval of a row sits at f = off + j and compares
// table entries i1 = i1_start + f / w2, i2 = i2_start + f % w2.  A tile
// [row, u0, v0, nu, nv] holds the queries f = u * w2 + v of its row with
// u0 <= u < u0 + nu, v0 <= v < v0 + nv.  Destinations outside [0, dst_len)
// and indices outside the tables or the stack are dropped (the reference's
// scatter mode="drop").
struct Tile {
  int row, u0, v0, nu, nv;
};

__device__ __forceinline__ Tile load_tile(const int* __restrict__ tiles) {
  const int* t = tiles + 5 * blockIdx.x;
  return Tile{t[0], t[1], t[2], t[3], t[4]};
}

// Pool mode: value j of a row lands at dst_base0 + (g / w2) * stride + g % w2,
// g = off + j (dmeta's own w2 and off).
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sweep_pool_kernel(double* __restrict__ dst, int dst_len, const double* __restrict__ combined,
                  int K, int ny, int nx, const double* __restrict__ xt,
                  const double* __restrict__ yt, int L, const int* __restrict__ ks,
                  const int* __restrict__ imeta, const int* __restrict__ dmeta,
                  const int* __restrict__ tiles, double inv_scale, double off_grid,
                  unsigned long long* __restrict__ l2_tiles) {
  extern __shared__ double win[];
  __shared__ int box[4];
  const Tile t = load_tile(tiles);
  const int* im = imeta + 5 * t.row;
  const int* pm = dmeta + 5 * t.row;
  const int k = ks[t.row];
  if (k < 0 || k >= K) return;
  const int w2 = max(im[2], 1);
  const int pw2 = max(pm[1], 1);
  const int nval = min(im[4], pm[4]);
  const int nq = t.nu * t.nv;
  const double* img = combined + static_cast<size_t>(k) * ny * nx;

  // the query q of the tile: its position, or false when it adds nothing
  auto query = [&](int q, double& x, double& y, int& d) {
    const int a = q / t.nv;
    const int f = (t.u0 + a) * w2 + t.v0 + (q - a * t.nv);
    const int j = f - im[3];
    if (j < 0 || j >= nval) return false;
    const int g = pm[3] + j;
    const int gq = g / pw2;
    d = pm[0] + gq * pm[2] + (g - gq * pw2);
    if (d < 0 || d >= dst_len) return false;
    const int fq = f / w2;
    const int i1 = im[0] + fq;
    const int i2 = im[1] + (f - fq * w2);
    if (i1 < 0 || i1 >= L || i2 < 0 || i2 >= L) return false;
    x = (xt[i1] - xt[i2]) * inv_scale + off_grid;
    y = (yt[i1] - yt[i2]) * inv_scale + off_grid;
    return on_grid(floor(x), floor(y), ny, nx);
  };

  // the window of the tile's valid queries
  int xlo = INT_MAX, xhi = INT_MIN, ylo = INT_MAX, yhi = INT_MIN;
  for (int q = threadIdx.x; q < nq; q += kThreads) {
    double x, y;
    int d;
    if (!query(q, x, y, d)) continue;
    const int fx = static_cast<int>(floor(x));
    const int fy = static_cast<int>(floor(y));
    xlo = min(xlo, fx);
    xhi = max(xhi, fx);
    ylo = min(ylo, fy);
    yhi = max(yhi, fy);
  }
  block_bounds(box, xlo, xhi, ylo, yhi);
  if (box[0] > box[1]) return;  // no query of the tile adds anything
  const int x0 = box[0] - 4, y0 = box[2] - 4;
  const int wx = box[1] - box[0] + 10, wy = box[3] - box[2] + 10;
  const bool staged = wx * wy * static_cast<int>(sizeof(double)) <= kPoolWindowBytes;
  if (staged) {
    stage_window(win, img, nx, x0, y0, wx, wy);
  } else if (threadIdx.x == 0) {
    atomicAdd(l2_tiles, 1ull);
  }

  for (int q = threadIdx.x; q < nq; q += kThreads) {
    double x, y;
    int d;
    if (!query(q, x, y, d)) continue;
    const double fx = floor(x), fy = floor(y);
    double wxt[10], wyt[10];
    d5512_taps(x - fx - 0.5, wxt);
    d5512_taps(y - fy - 0.5, wyt);
    const int ix = static_cast<int>(fx) - 4, iy = static_cast<int>(fy) - 4;
    const double v = staged
        ? patch_sum(win + (iy - y0) * wx + (ix - x0), wx, wxt, wyt, LoadShared())
        : patch_sum(img + iy * nx + ix, nx, wxt, wyt, LoadGlobal());
    atomicAdd(dst + d, v);
  }
}

// B mode: value j of a row lands at dst_base + (g % m) * n_pad + col0 + g / m,
// g = off + j (dmeta's off), m = n2f^2.  Query f = off + j pairs table entry
// i1 = i1_start + f / m with output pixel p = f % m of the row's lattice,
// whose origin is table entry i2_start: (xt[i2_start] + p % n2f,
// yt[i2_start] + p / n2f).  The planner (interp_cuda.sweep_tiles) raises
// unless the tables hold exactly that lattice, so this is the same as
// reading the tables at i2_start + p.  A block takes one tile: one i1 (u0)
// and the output pixels [v0, v0 + nv) it pairs with.
//
// Shared memory (host-sized, interp_cuda.b_window): x taps (n2f, 10), y taps
// (n2f, 10), horizontal sums (wmax, n2f), the window (wmax, wmax) in
// doubles, then the x and y floors (n2f each; INT_MIN off the grid).  The
// floors of n2f lattice points spread over (n2f - 1) |inv_scale| samples
// differ by at most floor((n2f - 1) |inv_scale|) + 2, rounding included, so
// with the 10-tap guard a window never exceeds wmax = that + 10 samples on
// either axis.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sweep_b_kernel(double* __restrict__ dst, int dst_len, const double* __restrict__ combined,
               int K, int ny, int nx, const double* __restrict__ xt,
               const double* __restrict__ yt, int L, const int* __restrict__ ks,
               const int* __restrict__ imeta, const int* __restrict__ dmeta,
               const int* __restrict__ tiles, double inv_scale, double off_grid, int n_pad,
               int n2f, int wmax) {
  extern __shared__ double sm[];
  __shared__ int box[4];
  double* tx = sm;
  double* ty = tx + n2f * 10;
  double* hs = ty + n2f * 10;
  double* win = hs + wmax * n2f;
  int* fxs = reinterpret_cast<int*>(win + wmax * wmax);
  int* fys = fxs + n2f;

  const Tile t = load_tile(tiles);
  const int* im = imeta + 5 * t.row;
  const int* bm = dmeta + 4 * t.row;
  const int k = ks[t.row];
  const int m = n2f * n2f;
  const int i2s = im[1];
  const int u = t.u0;
  const int i1 = im[0] + u;
  if (k < 0 || k >= K || i2s < 0 || i2s + m > L || i1 < 0 || i1 >= L) return;
  // outputs p of this i1 that are queries of the row: off <= u m + p < off + nval
  const int nval = min(im[4], bm[3]);
  const int plo = max(t.v0, im[3] - u * m);
  const int phi = min(t.v0 + t.nv, im[3] + nval - u * m);
  if (plo >= phi) return;
  const int rlo = plo / n2f, rhi = (phi - 1) / n2f;
  const int clo = rlo == rhi ? plo % n2f : 0;
  const int chi = rlo == rhi ? (phi - 1) % n2f : n2f - 1;
  const double X0 = xt[i2s], Y0 = yt[i2s];
  const double x1 = xt[i1], y1 = yt[i1];
  const double* img = combined + static_cast<size_t>(k) * ny * nx;

  // taps of the needed columns (threads [0, n2f)) and rows ([n2f, 2 n2f))
  int xlo = INT_MAX, xhi = INT_MIN, ylo = INT_MAX, yhi = INT_MIN;
  for (int s = threadIdx.x; s < 2 * n2f; s += kThreads) {
    const bool col = s < n2f;
    const int c = col ? s : s - n2f;
    if (col ? (c < clo || c > chi) : (c < rlo || c > rhi)) continue;
    const double q = col ? (x1 - (X0 + c)) * inv_scale + off_grid
                         : (y1 - (Y0 + c)) * inv_scale + off_grid;
    const double fq = floor(q);
    const int n = col ? nx : ny;
    int* fl = col ? fxs : fys;
    if (!(fq >= 4.0 && fq < static_cast<double>(n - 5))) {
      fl[c] = INT_MIN;
      continue;
    }
    d5512_taps(q - fq - 0.5, (col ? tx : ty) + c * 10);
    fl[c] = static_cast<int>(fq);
    if (col) {
      xlo = min(xlo, fl[c]);
      xhi = max(xhi, fl[c]);
    } else {
      ylo = min(ylo, fl[c]);
      yhi = max(yhi, fl[c]);
    }
  }
  block_bounds(box, xlo, xhi, ylo, yhi);
  // no column or no row on the grid: every output of this i1 is 0
  if (box[0] > box[1] || box[2] > box[3]) return;
  const int x0 = box[0] - 4, y0 = box[2] - 4;
  const int wx = box[1] - box[0] + 10, wy = box[3] - box[2] + 10;

  stage_window(win, img, nx, x0, y0, wx, wy);
  // horizontal sums: window row a, output column c; a thread keeps one
  // column's taps in registers and walks a stride of rows
  const int ncol = chi - clo + 1;
  const int nrg = kThreads / ncol;
  if (threadIdx.x < nrg * ncol) {
    const int c = clo + threadIdx.x % ncol;
    if (fxs[c] != INT_MIN) {
      double w[10];
#pragma unroll
      for (int b = 0; b < 10; ++b) w[b] = tx[c * 10 + b];
      const int cx = fxs[c] - 4 - x0;
      for (int a = threadIdx.x / ncol; a < wy; a += nrg) {
        const double* row = win + a * wx + cx;
        double s = 0.0;
#pragma unroll
        for (int b = 0; b < 10; ++b) s += w[b] * row[b];
        hs[a * n2f + c] = s;
      }
    }
  }
  __syncthreads();
  // vertical sums and the scatter
  for (int p = plo + threadIdx.x; p < phi; p += kThreads) {
    const int r = p / n2f, c = p - r * n2f;
    if (fxs[c] == INT_MIN || fys[r] == INT_MIN) continue;
    const int g = bm[2] + u * m + p - im[3];
    const int gq = g / m;
    const int d = bm[0] + (g - gq * m) * n_pad + bm[1] + gq;
    if (d < 0 || d >= dst_len) continue;
    const double* col = hs + (fys[r] - 4 - y0) * n2f + c;
    const double* w = ty + r * 10;
    double acc = 0.0;
#pragma unroll
    for (int a = 0; a < 10; ++a) acc += w[a] * col[a * n2f];
    atomicAdd(dst + d, acc);
  }
}

}  // namespace

extern "C" {

// images (R, ny, nx), x / y / out (R, nq); all f64, contiguous, on the device
// of `stream`.  n > 0: the queries of an image are a lattice of rows of n
// (n must divide nq), and a warp takes 8 x 4 of its points; n == 0: 32
// consecutive queries.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a bad n or more than 2^31 - 1 blocks).
int interp_d5512_dense(const double* images, int R, int ny, int nx, const double* x,
                       const double* y, long long nq, int n, double* out, void* stream) {
  if (n < 0 || (n > 0 && nq % n != 0)) return static_cast<int>(cudaErrorInvalidValue);
  if (R <= 0 || nq <= 0) return static_cast<int>(cudaGetLastError());
  constexpr int kWarpsK1 = kK1Threads / 32;
  const long long ctiles = n > 0 ? (n + 7) / 8 : 0;
  const long long runs = n > 0 ? ctiles * ((nq / n + 3) / 4) : (nq + 31) / 32;
  const long long nruns = runs * R;
  const long long blocks = (nruns + kWarpsK1 - 1) / kWarpsK1;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const bool pairs = (nx & 1) == 0 && (reinterpret_cast<uintptr_t>(images) & 15) == 0;
  interp_dense_warp_kernel<<<static_cast<unsigned int>(blocks), kK1Threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      images, ny, nx, x, y, nq, n, ctiles, runs, nruns, pairs, out);
  return static_cast<int>(cudaGetLastError());
}

// Shared-memory bytes a B-mode block needs for n2f and a window of at most
// wmax x wmax samples.
size_t sweep_b_smem_bytes(int n2f, int wmax) {
  return sizeof(double) * (static_cast<size_t>(n2f) * 20 + static_cast<size_t>(wmax) * n2f +
                           static_cast<size_t>(wmax) * wmax) +
         sizeof(int) * 2 * static_cast<size_t>(n2f);
}

// dst (dst_len,) f64, updated in place; combined (K, ny, nx) f64; xt / yt (L,)
// f64; ks (nrows,) int32; imeta (nrows, 5) int32; dmeta (nrows, 5) in mode 0
// (pool) or (nrows, 4) in mode 1 (B), int32; tiles (ntiles, 5) int32, one
// block each; l2_tiles one counter on the device (mode 0).  Mode 1 needs
// n_pad, n2f and wmax.  Returns cudaGetLastError() after the launch.
int sweep_d5512_scatter(double* dst, int dst_len, const double* combined, int K, int ny,
                        int nx, const double* xt, const double* yt, int L, const int* ks,
                        const int* imeta, const int* dmeta, const int* tiles, int ntiles,
                        double inv_scale, double off_grid, int mode, int n_pad, int n2f,
                        int wmax, unsigned long long* l2_tiles, void* stream) {
  if (ntiles <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    cudaFuncSetAttribute(sweep_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kPoolWindowBytes);
    sweep_pool_kernel<<<ntiles, kThreads, kPoolWindowBytes, s>>>(
        dst, dst_len, combined, K, ny, nx, xt, yt, L, ks, imeta, dmeta, tiles, inv_scale,
        off_grid, l2_tiles);
  } else {
    const size_t smem = sweep_b_smem_bytes(n2f, wmax);
    cudaFuncSetAttribute(sweep_b_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    sweep_b_kernel<<<ntiles, kThreads, smem, s>>>(dst, dst_len, combined, K, ny, nx, xt, yt, L,
                                                  ks, imeta, dmeta, tiles, inv_scale, off_grid,
                                                  n_pad, n2f, wmax);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
