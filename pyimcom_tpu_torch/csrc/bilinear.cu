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
// What bounds them on this card: bytes.  A query does ~30 f64 operations
// against 32-48 bytes of its own streams (xf, yf, the value, the
// accumulator) plus its taps; at 4088^2 queries a launch moves ~0.5-0.8 GB
// against ~0.5 GFLOP.  The taps of neighbouring queries are neighbouring
// pixels (a pair map is a near-affine shift of the grid), so the image and
// gain rows come through L1/L2 about once; the streams are read and written
// coalesced, one thread a query.  K4 adds with f64 atomicAdd in device memory
// (resolved in L2): neighbouring threads hit the same source pixels, which
// serialises some adds; its sums are taken in no fixed order.  This first
// version is the simple form: one thread a query, grid-stride loops.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// The flat index of tap (x0, y0) and the four weights of a query; false out
// of bounds (a NaN position fails every comparison).
__device__ __forceinline__ bool query_taps(double x, double y, int nx, int ny, int* i00,
                                           double w[4]) {
  const double fx0 = floor(x), fy0 = floor(y);
  if (!(fx0 >= 0.0 && fx0 < nx - 1 && fy0 >= 0.0 && fy0 < ny - 1)) return false;
  const double fx = x - fx0, fy = y - fy0;
  w[0] = (1.0 - fx) * (1.0 - fy);
  w[1] = fx * (1.0 - fy);
  w[2] = (1.0 - fx) * fy;
  w[3] = fx * fy;
  *i00 = static_cast<int>(fy0) * nx + static_cast<int>(fx0);
  return true;
}

__global__ void gather_kernel(const double* __restrict__ image, const double* __restrict__ gain,
                              int ny, int nx, const double* __restrict__ xf,
                              const double* __restrict__ yf, long long n, double* out,
                              int accumulate) {
  for (long long q = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; q < n;
       q += static_cast<long long>(gridDim.x) * blockDim.x) {
    int i;
    double w[4];
    double val = 0.0;
    if (query_taps(xf[q], yf[q], nx, ny, &i, w)) {
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

__global__ void adjoint_kernel(const double* __restrict__ values, const double* __restrict__ gain,
                               int ny, int nx, const double* __restrict__ xf,
                               const double* __restrict__ yf, long long n, double* out) {
  for (long long q = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; q < n;
       q += static_cast<long long>(gridDim.x) * blockDim.x) {
    int i;
    double w[4];
    if (!query_taps(xf[q], yf[q], nx, ny, &i, w)) continue;
    double v = values[q];
    if (gain != nullptr) {
      w[0] *= __ldg(gain + i);
      w[1] *= __ldg(gain + i + 1);
      w[2] *= __ldg(gain + i + nx);
      w[3] *= __ldg(gain + i + nx + 1);
      const double norm = w[0] + w[1] + w[2] + w[3];
      v = v / (norm > 0.0 ? norm : 1.0);
    }
    atomicAdd(out + i, v * w[0]);
    atomicAdd(out + i + 1, v * w[1]);
    atomicAdd(out + i + nx, v * w[2]);
    atomicAdd(out + i + nx + 1, v * w[3]);
  }
}

int blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < (1LL << 20) ? b : (1LL << 20));
}

}  // namespace

extern "C" {

// K3.  image, gain (ny, nx) f64 (gain may be NULL: no gain); xf, yf, out (n,)
// f64; all contiguous, on the device of `stream`; ny * nx < 2**31.  With
// `accumulate` the value is added into out, else written.  Returns
// cudaGetLastError() after the launch.
int bilinear_gather(const double* image, const double* gain, int ny, int nx, const double* xf,
                    const double* yf, long long n, double* out, int accumulate, void* stream) {
  if (n > 0) {
    gather_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        image, gain, ny, nx, xf, yf, n, out, accumulate);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4.  values, xf, yf (n,) f64; gain (ny, nx) f64 or NULL; out (ny, nx) f64,
// to which the kernel adds (the caller zeroes it).  Returns
// cudaGetLastError() after the launch.
int bilinear_scatter_adjoint(const double* values, const double* gain, int ny, int nx,
                             const double* xf, const double* yf, long long n, double* out,
                             void* stream) {
  if (n > 0) {
    adjoint_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        values, gain, ny, nx, xf, yf, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
