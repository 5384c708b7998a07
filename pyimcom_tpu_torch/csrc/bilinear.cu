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
// K4 takes the queries in tiles of their own grid (32 x 32 of a 2-D query
// grid, 1 x 1024 of a 1-D stream), 256 threads a tile, four queries a
// thread.  One thread a query with four f64 atomicAdds into device memory
// issues ~56M atomics a 4088^2 pair, each warp-wide one spread over up to 32
// cache lines of a tilted line through the output.  Instead a tile of a
// rotated grid covers a compact patch of the output: the CTA reduces the
// bounding box of its in-bounds taps, and if that box fits kBoxCap doubles
// it zeroes an accumulator box in shared memory, adds its queries' four
// contributions there with shared-memory atomics (a compare-and-swap loop
// on this card: it has no f64 add in shared memory), and flushes the box's
// nonzero pixels to the output with global atomicAdd, row-major and
// coalesced: about one global atomic a touched output pixel.  The gain taps
// come through L1, each warp's 8 x 4 block of queries reading a compact
// patch.  A tile whose box does not fit (wild or NaN-ridden positions, a
// 1-D stream over many rows) adds its queries straight into device memory,
// and counts itself in a device counter (global_tiles).  Either way sums are
// taken in no fixed order.  What is left bounds it by bytes: the streams
// (24 B a query), the gain, and the output zeroed by the caller, then read
// and written back by the flush's atomics (it outgrows the 50 MB L2).

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

// K4's tiling.  A tile is kTileQueries queries: 32 x 32 of a 2-D query grid,
// 1 x 1024 of one row.  kBoxCap is the f64 slots of a tile's accumulator box
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
// given, and its value over their norm; shared by both routes so they add
// the same products.
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
// device memory, and one count in global_tiles).
template <int TILE_W, typename Pos>
__global__ void __launch_bounds__(kAdjThreads, 4)
    adjoint_tile_kernel(const double* __restrict__ values, const double* __restrict__ gain,
                        int ny, int nx, const Pos* __restrict__ xf,
                        const Pos* __restrict__ yf, int qny, int qnx, double* out,
                        unsigned long long* __restrict__ global_tiles) {
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
  const int bw = x_hi - x_lo + 2, bh = y_hi - y_lo + 2;

  if (static_cast<long long>(bw) * bh > kBoxCap) {
    // the global route
    if (t == 0) atomicAdd(global_tiles, 1ull);
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
  // of bw | 1 can put a 45-degree run of 32 on one pair; k4_variants.py
  // bank_pairs() counts both).  Where that does not fit, the pitch is bw.  Box pixel p is row p / bw: (p + 0.5) / bw in f32
  // lies 0.5 / bw from an integer, far above its rounding error while
  // bw * bh <= kBoxCap.
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
                    unsigned long long* global_tiles, cudaStream_t stream) {
  constexpr int TILE_H = kTileQueries / TILE_W;
  constexpr int smem = kBoxCap * static_cast<int>(sizeof(double));
  const long long tiles =
      static_cast<long long>((qny + TILE_H - 1) / TILE_H) * ((qnx + TILE_W - 1) / TILE_W);
  adjoint_tile_kernel<TILE_W, Pos><<<static_cast<unsigned>(tiles), kAdjThreads, smem, stream>>>(
      values, gain, ny, nx, xf, yf, qny, qnx, out, global_tiles);
}

int blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < (1LL << 20) ? b : (1LL << 20));
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
int scatter_adjoint(const double* values, const double* gain, int ny, int nx, const Pos* xf,
                    const Pos* yf, int qny, int qnx, double* out,
                    unsigned long long* global_tiles, void* stream) {
  if (qny > 0 && qnx > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (qny == 1)
      launch_adjoint<kTileQueries, Pos>(values, gain, ny, nx, xf, yf, qny, qnx, out,
                                        global_tiles, s);
    else
      launch_adjoint<32, Pos>(values, gain, ny, nx, xf, yf, qny, qnx, out, global_tiles, s);
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

// K4.  values, xf, yf f64 on a (qny, qnx) query grid, row-major (a 1-D
// stream is one row, qny = 1); gain (ny, nx) f64 or NULL; out (ny, nx) f64,
// to which the kernel adds (the caller zeroes it); global_tiles one counter
// on the device, to which each tile that takes the global route adds one.
// A 2-D grid is cut into 32 x 32 tiles, one row into 1 x 1024.  Returns
// cudaGetLastError() after the launch.
int bilinear_scatter_adjoint(const double* values, const double* gain, int ny, int nx,
                             const double* xf, const double* yf, int qny, int qnx, double* out,
                             unsigned long long* global_tiles, void* stream) {
  return scatter_adjoint<double>(values, gain, ny, nx, xf, yf, qny, qnx, out, global_tiles,
                                 stream);
}

// K4 on float32 positions xf, yf; everything else as bilinear_scatter_adjoint.
int bilinear_scatter_adjoint_f32(const double* values, const double* gain, int ny, int nx,
                                 const float* xf, const float* yf, int qny, int qnx,
                                 double* out, unsigned long long* global_tiles, void* stream) {
  return scatter_adjoint<float>(values, gain, ny, nx, xf, yf, qny, qnx, out, global_tiles,
                                stream);
}

}  // extern "C"
