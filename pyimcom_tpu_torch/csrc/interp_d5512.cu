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
//     atomically added where it lands.
//
// What bounds them on this card.  Every query reads a 10x10 f64 patch
// (800 bytes) of one overlap image of ~0.55-0.72 MB (263^2 or 299^2 doubles)
// and spends ~250 f64 flops on it.  A launch touches at most a few tens of
// MB of images, which stay resident in the 50 MB L2, so the loads are served
// from L2 and the kernels are bound by L2-to-SM bandwidth and load latency,
// not by HBM or the FP64 units.
//
// What the design does about it.  The TPU kernel expanded each query's taps
// into a banded (Q, ny) weight matrix so that the gather became an MXU
// matmul, because TPU gathers are slow.  On Hopper a gather from L2 is cheap,
// so each thread reads its own patch directly: one thread per query, the
// patch rows are 10 consecutive doubles, the phase, taps and sum are f64
// (no int32/f32 phase split), and neighbouring threads usually hit
// neighbouring patches of the same image.  No shared-memory tiling, tensor
// cores or TMA yet: staging image tiles in shared memory is later work.

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

constexpr int kThreads = 256;

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

// Interpolate one (ny, nx) image at (qx, qy).  The query is valid iff
// 4 <= floor(q) < n - 5 on both axes; invalid (or NaN) queries give 0.
__device__ __forceinline__ double d5512_point(const double* __restrict__ img,
                                              int ny, int nx, double qx, double qy) {
  const double fx = floor(qx);
  const double fy = floor(qy);
  if (!(fx >= 4.0 && fx < static_cast<double>(nx - 5) &&
        fy >= 4.0 && fy < static_cast<double>(ny - 5))) {
    return 0.0;
  }
  double wx[10], wy[10];
  d5512_taps(qx - fx - 0.5, wx);
  d5512_taps(qy - fy - 0.5, wy);
  const double* p = img + (static_cast<long long>(fy) - 4) * nx + (static_cast<long long>(fx) - 4);
  double acc = 0.0;
#pragma unroll
  for (int a = 0; a < 10; ++a) {
    const double* row = p + static_cast<long long>(a) * nx;
    double s = 0.0;
#pragma unroll
    for (int b = 0; b < 10; ++b) s += wx[b] * __ldg(row + b);
    acc += wy[a] * s;
  }
  return acc;
}

__global__ void interp_dense_kernel(const double* __restrict__ images, int ny, int nx,
                                    const double* __restrict__ x,
                                    const double* __restrict__ y,
                                    long long nq, long long total,
                                    double* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long r = t / nq;
  out[t] = d5512_point(images + r * ny * nx, ny, nx, x[t], y[t]);
}

// mode 0 (pool):  dmeta rows [dst_base0, w2, stride, off, nval]
//                 value j lands at dst_base0 + (f // w2) * stride + f % w2
// mode 1 (-B/2):  dmeta rows [dst_base, col0, off, nval]
//                 value j lands at dst_base + (f % m) * n_pad + col0 + f // m
// imeta rows [i1_start, i2_start, w2, off, nval]: query j of a row compares
// table entries i1 = i1_start + f // w2 and i2 = i2_start + f % w2, f = off + j.
// Destinations outside [0, dst_len) and indices outside the tables or the
// stack are dropped (the reference's scatter mode="drop").
__global__ void sweep_kernel(double* __restrict__ dst, long long dst_len,
                             const double* __restrict__ combined, int K, int ny, int nx,
                             const double* __restrict__ xt,
                             const double* __restrict__ yt, long long L,
                             const int* __restrict__ ks,
                             const int* __restrict__ imeta,
                             const int* __restrict__ dmeta,
                             long long nrows, int bucket, double inv_scale,
                             double off_grid, int mode, int n_pad, int m) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= nrows * bucket) return;
  const long long r = t / bucket;
  const int j = static_cast<int>(t - r * bucket);
  const int* im = imeta + 5 * r;
  if (j >= im[4]) return;

  long long d;
  if (mode == 0) {
    const int* pm = dmeta + 5 * r;
    if (j >= pm[4]) return;
    const long long f = static_cast<long long>(pm[3]) + j;
    const int w2 = max(pm[1], 1);
    d = pm[0] + (f / w2) * pm[2] + f % w2;
  } else {
    const int* bm = dmeta + 4 * r;
    if (j >= bm[3]) return;
    const long long f = static_cast<long long>(bm[2]) + j;
    d = bm[0] + (f % m) * n_pad + bm[1] + f / m;
  }
  if (d < 0 || d >= dst_len) return;

  const int k = ks[r];
  const int w2 = max(im[2], 1);
  const long long f = static_cast<long long>(im[3]) + j;
  const long long i1 = im[0] + f / w2;
  const long long i2 = im[1] + f % w2;
  if (k < 0 || k >= K || i1 < 0 || i1 >= L || i2 < 0 || i2 >= L) return;

  const double qx = (xt[i1] - xt[i2]) * inv_scale + off_grid;
  const double qy = (yt[i1] - yt[i2]) * inv_scale + off_grid;
  const double v = d5512_point(combined + static_cast<long long>(k) * ny * nx, ny, nx, qx, qy);
  atomicAdd(dst + d, v);
}

unsigned int blocks_for(long long total) {
  return static_cast<unsigned int>((total + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// images (R, ny, nx), x / y / out (R, nq); all f64, contiguous, on the device
// of `stream`.  Returns cudaGetLastError() after the launch.
int interp_d5512_dense(const double* images, int R, int ny, int nx, const double* x,
                       const double* y, long long nq, double* out, void* stream) {
  const long long total = static_cast<long long>(R) * nq;
  if (total > 0) {
    interp_dense_kernel<<<blocks_for(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        images, ny, nx, x, y, nq, total, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// dst (dst_len,) f64, updated in place; combined (K, ny, nx) f64; xt / yt (L,)
// f64; ks (nrows,) int32; imeta (nrows, 5) int32; dmeta (nrows, 5) in mode 0
// or (nrows, 4) in mode 1, int32.  Returns cudaGetLastError() after the launch.
int sweep_d5512_scatter(double* dst, long long dst_len, const double* combined, int K,
                        int ny, int nx, const double* xt, const double* yt, long long L,
                        const int* ks, const int* imeta, const int* dmeta, long long nrows,
                        int bucket, double inv_scale, double off_grid, int mode, int n_pad,
                        int m, void* stream) {
  const long long total = nrows * bucket;
  if (total > 0) {
    sweep_kernel<<<blocks_for(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        dst, dst_len, combined, K, ny, nx, xt, yt, L, ks, imeta, dmeta, nrows, bucket,
        inv_scale, off_grid, mode, n_pad, m);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
