// D5512 and G4460 interpolation kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (pyimcom_tpu_torch/ops/interp_cuda.py).
//
// Every kernel is a template on the tap count T of its family: T = 10
// (D5512, patch from floor(q) - 4, valid iff 4 <= floor(q) < n - 5) or T = 8
// (G4460, patch from floor(q) - 3, valid iff 3 <= floor(q) < n - 4); the C
// entries interp_<family>_dense and sweep_<family>_scatter instantiate them.
// The D5512 forms are the ones described below; the G4460 forms are the same
// code with an 8 x 8 patch (64 reads and ~300 flops a query).
//
// K1  interp_d5512_dense   replaces the Pallas TPU kernel
//     pyimcom_tpu/ops/interp_pallas.py::_kernel (via interp2d_dense_pallas):
//     R images, R x Nq scattered queries, zero off-grid.
//     interp_g4460_dense replaces the XLA form of the same contract for the
//     8-tap family, pyimcom_tpu/ops/interp.py::interp2d_dense(..., "G4460")
//     (the JAX package has no Pallas G4460 kernel).
// K2  sweep_d5512_scatter  replaces interp_pallas.py::interp2d_dense_pairs_pallas
//     fused with the pool / -B/2 scatters of
//     pyimcom_tpu/ops/assemble.py::sweep_pool_scan and sweep_b_scan: each
//     query is formed from the f64 coordinate tables, interpolated, and
//     added where it lands.  sweep_g4460_scatter replaces the XLA sweep of
//     pyimcom_tpu/ops/assemble.py::sweep_scatter_scan with kern "G4460"
//     (interp.py::interp2d_dense_pairs).
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
//   on every captured launch of PSF sampling and injection, at every budget
//   from 2 to 20 KB a warp and for boxes of a block's run, of a warp's run
//   and of a lattice patch.
//
// Also measured and not kept: four neighbouring queries a thread walking
// their shared patch rows once (45 reads a query: 255 registers, lanes four
// queries apart on even more cache lines; 1.3-1.8x slower than the kernel
// it replaces); window rows padded to +-1 bank so that a slanted run is
// conflict-free (slower: no 16-byte copies, larger windows); two or four
// runs a warp (T = 256, 512) with their x and y loaded ahead; fewer
// registers for more warps (spills).
//
// K1 on a canvas lattice (interp_canvas_kernel), the split-PSF wing
// canvas.  Its launches are the opposite of PSF sampling's: the points are
// a lattice clipped to a mosaic block's footprint, nearly all on the grid,
// ~0.94 block pixels apart (each sample read by ~70 queries), and a
// production block's padded image (2572^2 f64, 52.9 MB) outgrows the 50 MB
// L2 (the covering block's, 1.07 GB, twenty times).  The caller knows the
// lattice (CanvasGeometry keeps each block's canvas-row segments,
// interp_cuda.CanvasSegments), which scattered runs of 32 threw away: a
// run was a slanted line of the block image, its lanes on other cache
// lines at every roll.  What held the runs body there (chip_smoke.py's
// wing_canvas_production, H100 80GB HBM3, 700 W): on the covering launch x,
// y and the result alone took 1.39 ms of its 3.69 (every query moved off
// the grid), the patch reads the rest; and it lost most where a warp's 32
// points run across the image's rows: a production block took 0.241 ms at
// a roll of 0, 0.379 at 45 and 0.456 at 90.  So a CTA takes a 32 x 32 tile
// of the lattice (the host's canvas_tiles, from the segments; smaller
// where the points lie so far apart that a tile's window would outgrow
// kCanvasWindow), loads its
// points' positions into shared memory, reduces their floors to a window,
// stages the window with bulk copies on an mbarrier and computes every
// query from shared memory: 64 eight-byte reads a query, in K1's order, so
// the result is the runs body's bit for bit.  What bounds it: those reads,
// 512 bytes a query at 128 bytes a clock an SM -- 2.32 ms for the covering
// launch's 151.9M queries at 1.98 GHz against its bytes bound of 1.41 --
// and the CTA's chain of segments, positions, reduction and staged window,
// which only the 4 CTAs an SM overlap: without its compute the body still
// took 0.120 / 0.122 / 0.162 ms of its 0.201 / 0.260 / 0.220 on a
// production block at 0 / 45 / 90 degrees (the runs body 0.242 / 0.377 /
// 0.449; k1_variants.py, H100 80GB HBM3, 700 W).  It gains least where
// that chain is not hidden: on the covering launch (its windows read from
// HBM; 3.77 against 3.69 ms in chip_smoke.py's run) and on config 3's
// 14400-point canvas (22 tiles; 0.0141 against 0.0087, a loss).  Measured
// and not kept (k1_variants.py, same card and block, ms at 0 / 45 / 90): 3
// CTAs an SM with 80 registers 0.231 / 0.298 / 0.245; 2 CTAs with 128
// registers, no spill, 0.296 / 0.371 / 0.307; the tile's queries one at a
// time 0.243 / 0.307 / 0.266; no staging (the tile's patches through L1 /
// L2) 0.298 / 0.437 / 0.321; the first design (warps of 8 x 4 points, rows
// 64 bytes apart, the positions in registers: 136 bytes of spills) 0.340
// at 0 (chip_smoke.py); a persistent CTA an SM walking 32 x 64 tiles through
// two buffers, 8 warps preparing the next tile while 24 computed, slower
// than this body at every roll, the covering launch too (its workers'
// compute could not keep up with one CTA's warps).
//
// K2 (sweep_pool_kernel, sweep_b_kernel).  What bounds it on this card.  A
// pool query reads an 8 x 8 (G4460) or 10 x 10 (D5512) patch -- 512 or 800
// bytes -- and spends ~165 / ~220 f64 operations on it; its bytes bound is
// its destination and the images once (G4460 bench group 1: 26.0M queries,
// 0.184 ms).  Its patches come from shared memory, at 128 bytes a clock an
// SM: 4 clocks a G4460 query at best, ~0.4 ms for that group, more than
// twice the bytes bound, so the shared-memory load rate, not HBM or the FP64
// units (~2.6 clocks a query), is what a patch-reading design is held to.
// clock64 counters in a copy of the kernel this replaces (commit 910c170: a
// block a tile of <= 1024 queries, two 110 KB windows an SM) put 23 % of a
// block in a first pass over every query for its window, 17 % in staging
// it (8-byte cp.async, then a barrier) and 60 % in the patch loads, whose
// lanes fall on random banks: its 8-byte loads take 2.5x the wavefronts
// they need (counted on the captured tiles).  B spent a block's life on one
// i1 in four serial steps of similar length (taps and bounds 32 %, staging
// 24 %, horizontal sums 23 %, vertical sums 21 %).  Both measured with
// clock64 counters in a copy of that kernel on the G4460 bench group's
// captured launches (H100 80GB HBM3, 700 W).
//
// * Pool mode.  One persistent block an SM (512 threads) walks the tiles
//   (block b: tiles b, b + grid, ...), each cut into pieces of at most 1024
//   queries and 64 i1 whose window fits a slot (halving the i1 range; a
//   single i1 whose window does not fit reads from L2 with the rest of its
//   tile and counts in l2_tiles).  Warps are specialised: warp 0 finds the
//   piece after next from the extremes of its table entries (pool_next: no
//   pass over the queries; qpos is monotone) and keeps those entries in
//   shared memory; warps 1-2 stage the next piece's window into the other
//   of two 98 KB slots with Hopper's bulk copies (one per row, whole 16-byte
//   pairs into rows padded a double on either side, completion on an
//   mbarrier; a TMA tensor map cannot take the stack, whose rows are nx
//   doubles, not a multiple of 16 bytes for odd nx); the other 13 warps
//   compute the current piece -- decode each query once (position from the
//   tables, destination, window offset, bank = offset mod 16, ranked among
//   the piece's queries of its bank by ballots and one shared atomic a
//   bank and warp), place it in (rank, bank) order so that 16 consecutive
//   queries fall on 16 distinct banks, then compute in that order and add
//   with atomicAdd.  A piece costs the workers two barriers of their own
//   (a named barrier) and the block one.
// * B mode.  A row pairs input pixel i1 with the stamp's output grid, an
//   exact n2f x n2f integer lattice (the planner raises if the tables do
//   not hold one), so qx depends only on the output column and qy only on
//   the output row.  A block takes a run of up to 8 consecutive i1 of a row
//   (interp_cuda.sweep_tiles; each i1 keeps its own queries of the row, so
//   a run may start or end inside the lattice; where a launch has few i1,
//   the planner shortens the runs until it has four tiles an SM) and cuts
//   it into sub-runs
//   whose union window fits (one warp scans the i1's extreme columns and
//   rows): it stages that window once, computes all the sub-run's tap sets
//   in one pass, then for each i1 forms the horizontal sums (a half-warp a
//   column, lanes over window rows at an odd pitch: distinct banks) into one
//   of two buffers and, after one barrier, the vertical sums, while the
//   next i1 fills the other buffer.  Both sums keep the summation order of
//   K1's sum_a wy[a] (sum_b wx[b] img).  Supported lattices: every one
//   whose single i1 fits two buffers beside its window in a block's 227 KB
//   takes a run layout (b_layout); the rest (n2f 54 at 2.13 samples an
//   output pixel, n2f 44 at 2.84, ...) take the compact layout, whose
//   bytes are those of commit 910c170's one-i1 body, so every lattice that
//   body launched launches (tests/test_torch_assemble.py checks n2f <= 160,
//   wmax <= 260).  What fits neither raises in the wrapper.
// * No tensor cores: each query has its own patch and its own taps (pool),
//   or each i1 its own tap sets (B), so no operand is shared that wgmma or
//   DMMA could use.
//
// Measured and not kept (each a variant of this file timed on the captured
// launches of the G4460 bench group and the production group, unless
// said): computing the pool
// queries in the order they were decoded, without the bank sort (as slow as
// the kernel this replaces); one staging warp, not two; 448 or 576 threads
// (fewer workers, or a register cap that spills); 80 KB slots (more
// pieces); B runs of 1 or 16 i1; B blocks of 384 threads (faster on the
// production group's G4460 rows, slower on the D5512 bench group); B
// blocks of one an SM everywhere (kept only for large windows, b_layout).
// In design: a producer warp that stages with 16-byte cp.async (its loads
// could not keep up with the workers); the workers staging the next window
// themselves (issuing the copies held them up); a flush of each piece's
// results in query order for coalesced adds (slower than adding from the
// compute loop); one block of 384 threads with one slot, two an SM;
// a piece that continues a tile taking its metadata and i2 entries from
// the piece before (slower on the G4460 groups).
//
// D5512 takes the same bodies: on the bench group and the production group,
// pool and B, its 10-tap instance is faster than commit 910c170's too.
// Slower than that body: the pool where the PSFs are oversampled 8x (the
// windows of its tiles fill a slot and are cut into more pieces), held in
// ROADMAP.md queue 3 (chip_smoke.py's piff_block times it).
//
// Index arithmetic inside a query is 32-bit.  Within one launch every
// destination receives at most one query (the planner's rows partition the
// pool and -B/2; tests/test_torch_assemble.py checks it on a real group),
// so the sum does not depend on the order of the adds.  K2 still adds with
// atomicAdd: its result is unused, so it compiles to a reduction that the
// SM issues and forgets, where a plain add must first wait for its load from
// HBM (the pool and -B/2 outgrow L2).
//
// Launch shape: K1 runs blocks of kK1Threads threads (T = kK1Threads
// queries, one run a warp), chosen by timing the main path's captured
// launches (chip_smoke.py, k1_main_path); K2's below.

#include <algorithm>
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

// G4460 coefficients (pyimcom_tpu/ops/interp.py G4460_EVEN / G4460_ODD), the
// same layout: row k gives taps w[k] and w[7-k].
__constant__ double kG4460Even[4][5] = {
    {-1.945235823911159925e-05, +1.055874006170703754e-03, -8.118995675262492134e-03,
     +1.453840359289597893e-02, -3.143522062829661335e-03},
    {+8.999088401166260235e-05, -5.148137838987351493e-03, +6.069481712095783216e-02,
     -1.235960532055178779e-01, +2.718540716184886588e-02},
    {-1.540666237308310749e-04, +9.123606051920359755e-03, -1.334507380042637137e-01,
     +5.336865231190287551e-01, -1.252224819511615628e-01},
    {+8.351472709485021652e-05, -5.031103870555608815e-03, +8.087359556892606549e-02,
     -4.246267565082386120e-01, +6.011801467479378491e-01},
};
__constant__ double kG4460Odd[4][5] = {
    {+7.260754694387638895e-06, -2.904202176384821071e-04, +2.238241587784505285e-03,
     -4.005111027206044276e-03, +8.423052633873124011e-04},
    {-4.631632696889089514e-05, +1.991059241797971720e-03, -2.378440273076087505e-02,
     +4.853753882315355733e-02, -1.053588105750352319e-02},
    {+1.308916996808606444e-04, -5.896228276277161624e-03, +8.761981577498251239e-02,
     -3.533315658835169404e-01, +8.255813013281140811e-02},
    {-2.118650110726590574e-04, +9.766034727710315444e-03, -1.596037936464457796e-01,
     +8.453409395243187685e-01, -1.200891120242346455e+00},
};

// The geometry of a family of TAPS taps: the patch of a query q starts at
// floor(q) - kLo, and the query is valid iff kLo <= floor(q) < n - kHi.
// kPitch is the stride (doubles) of one output column's or row's tap set in
// the B kernel's shared memory.  Neighbouring threads load neighbouring tap
// sets once each: 80 bytes apart for D5512 (four lanes a bank pair, the
// layout its kernel was timed with), and for G4460 72 bytes (9 doubles),
// where 64 bytes (8) would put every other lane on one bank pair; 9 reaches
// the two wavefronts that 32 eight-byte loads need at best.
template <int TAPS>
struct Family;
template <>
struct Family<10> {
  static constexpr int kLo = 4, kHi = 5, kPitch = 10;
};
template <>
struct Family<8> {
  static constexpr int kLo = 3, kHi = 4, kPitch = 9;
};

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

// The eight G4460 taps for the phase fh (Horner in fh^2).
__device__ __forceinline__ void g4460_taps(double fh, double w[8]) {
  const double fh2 = fh * fh;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    double e = kG4460Even[k][0];
    double o = kG4460Odd[k][0];
#pragma unroll
    for (int c = 1; c < 5; ++c) {
      e = e * fh2 + kG4460Even[k][c];
      o = o * fh2 + kG4460Odd[k][c];
    }
    o *= fh;
    w[k] = e + o;
    w[7 - k] = e - o;
  }
}

template <int TAPS>
__device__ __forceinline__ void taps(double fh, double* w) {
  if constexpr (TAPS == 10) {
    d5512_taps(fh, w);
  } else {
    g4460_taps(fh, w);
  }
}

// True iff the query's patch lies inside an (ny, nx) image:
// kLo <= floor(q) < n - kHi on both axes (false for NaN).
template <int TAPS>
__device__ __forceinline__ bool on_grid(double fx, double fy, int ny, int nx) {
  constexpr double lo = Family<TAPS>::kLo;
  constexpr int hi = Family<TAPS>::kHi;
  return fx >= lo && fx < static_cast<double>(nx - hi) &&
         fy >= lo && fy < static_cast<double>(ny - hi);
}

// sum_a wy[a] (sum_b wx[b] p[a * stride + b]) of the patch whose corner is p.
template <int TAPS, typename Load>
__device__ __forceinline__ double patch_sum(const double* p, int stride, const double* wx,
                                            const double* wy, Load load) {
  double acc = 0.0;
#pragma unroll
  for (int a = 0; a < TAPS; ++a) {
    const double* row = p + a * stride;
    double s = 0.0;
#pragma unroll
    for (int b = 0; b < TAPS; ++b) s += wx[b] * load(row + b);
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

// sum_a wy[a] (sum_b wx[b] img[fy - kLo + a][fx - kLo + b]) read through L1 /
// L2 with 16-byte loads: the image rows must be 16-byte aligned (nx even,
// img on 16 bytes).  Each patch row is read as TAPS / 2 + 1 pairs from the
// even column at or before fx - kLo (the last only where fx - kLo is odd),
// against the taps shifted to those TAPS + 2 samples: the extra samples (in
// the row, since fx - kLo + TAPS = fx + kHi + 1 <= nx - 1, and finite) add
// exact zeros, so the sum and its order are the TAPS-tap ones.
template <int TAPS>
__device__ __forceinline__ double patch_sum_pairs(const double* __restrict__ img, int nx,
                                                  int fx, int fy, const double* wx,
                                                  const double* wy) {
  constexpr int lo = Family<TAPS>::kLo;
  constexpr int np = TAPS / 2 + 1;
  const int c0 = fx - lo;
  const bool odd = c0 & 1;
  double w[2 * np];
#pragma unroll
  for (int j = 0; j < 2 * np; ++j) {
    const double even_tap = j < TAPS ? wx[j] : 0.0;
    const double odd_tap = j >= 1 && j <= TAPS ? wx[j - 1] : 0.0;
    w[j] = odd ? odd_tap : even_tap;
  }
  const double2* p = reinterpret_cast<const double2*>(img + (fy - lo) * nx + (c0 & ~1));
  const int pitch = nx / 2;
  double acc = 0.0;
#pragma unroll
  for (int a = 0; a < TAPS; ++a) {
    const double2* row = p + a * pitch;
    double s = 0.0;
#pragma unroll
    for (int k = 0; k < np; ++k) {
      const double2 v = k < np - 1 || odd ? __ldg(row + k) : make_double2(0.0, 0.0);
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
template <int TAPS>
__global__ void __launch_bounds__(kK1Threads)
interp_dense_warp_kernel(const double* __restrict__ images, int ny, int nx,
                         const double* __restrict__ x, const double* __restrict__ y,
                         long long nq, int n, long long ctiles, long long runs,
                         long long nruns, bool pairs, double* __restrict__ out) {
  constexpr int lo = Family<TAPS>::kLo;
  const long long w = static_cast<long long>(blockIdx.x) * (kK1Threads / 32) + (threadIdx.x >> 5);
  if (w >= nruns) return;
  const long long r = w / runs;
  const long long q = run_query(w - r * runs, threadIdx.x & 31, nq, n, ctiles);
  if (q < 0) return;
  const long long i = r * nq + q;
  const double qx = x[i], qy = y[i];
  const double fxd = floor(qx), fyd = floor(qy);
  double v = 0.0;
  if (on_grid<TAPS>(fxd, fyd, ny, nx)) {
    double wxt[TAPS], wyt[TAPS];
    taps<TAPS>(qx - fxd - 0.5, wxt);
    taps<TAPS>(qy - fyd - 0.5, wyt);
    const int fx = static_cast<int>(fxd), fy = static_cast<int>(fyd);
    const double* img = images + static_cast<size_t>(r) * ny * nx;
    v = pairs ? patch_sum_pairs<TAPS>(img, nx, fx, fy, wxt, wyt)
              : patch_sum<TAPS>(img + (fy - lo) * nx + (fx - lo), nx, wxt, wyt, LoadGlobal());
  }
  out[i] = v;
}

// ---------------------------------------------------------------------------
// K2
// ---------------------------------------------------------------------------

// Launch shape of K2, chosen by timing the main path's captured launches
// (chip_smoke.py, k2_main_path).  Pool: one persistent block an SM of
// kPoolThreads threads, of which kPoolProducers warps produce, with two
// window slots of kPoolSlot doubles each (interp_cuda.POOL_SLOT_DOUBLES).
// B: blocks of kBThreads threads taking runs of at most kBRun i1
// (interp_cuda.B_RUN), in kBBlockSmem bytes of shared memory where the
// lattice allows (two blocks an SM), else in up to kBBlockSmemOne.
constexpr int kPoolThreads = 512;
constexpr int kPoolSlot = 12544;                  // doubles of one window slot (even)
constexpr int kPoolCap = 1024;                    // queries of a piece on the shared route
constexpr int kPoolProducers = 3;                 // warp 0 finds pieces, the others stage
constexpr int kPoolWork = kPoolThreads - 32 * kPoolProducers;   // threads that compute
constexpr int kBThreads = 256;
constexpr int kBMinBlocks = 2;
constexpr int kBRun = 8;                          // most i1 a B block stages together
constexpr size_t kBBlockSmem = 114688;            // two blocks an SM
constexpr size_t kBBlockSmemOne = 232448;         // one block: all a block may have (sm_90)
static_assert(kPoolSlot % 2 == 0, "a slot holds 16-byte pairs");
static_assert(kPoolProducers >= 2, "a warp finds the pieces, at least one stages them");
static_assert(kBRun >= 1 && kBRun <= 32, "a B run is scanned by one warp");

__device__ __forceinline__ void cp_async8(double* smem, const double* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async16(double* smem, const double* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A query's position on the overlap image: (a - b) inv_scale + off_grid as
// one fused multiply-add.  It is monotone in a and in b, so the positions of
// a set of queries lie between those of its extreme table entries; the
// windows below rest on that, and the queries use the same function.
__device__ __forceinline__ double qpos(double a, double b, double s, double off) {
  return __fma_rn(a - b, s, off);
}

// A window: samples [y0, y0 + wy) x [x0, x0 + wx) of image k at row pitch
// `pitch` (of nx's parity), from double `shift` of its slot (2 pad + the
// parity of the first sample's offset in the stack), so that every row
// starts on the parity of its source and copies as 16-byte pairs.  With
// pad 1 a row has a double to spare on either side (pitch >= wx + 1), so
// that it copies as whole pairs from the even sample at or before its
// first to the odd one at or after its last.
struct Window {
  int x0, y0, wx, wy, pitch, shift;
};

__device__ __forceinline__ Window make_window(int fxlo, int fxhi, int fylo, int fyhi, int lo,
                                              int taps, long long k, int ny, int nx, int cpar,
                                              int pad) {
  Window w;
  w.x0 = fxlo - lo;
  w.y0 = fylo - lo;
  w.wx = fxhi - fxlo + taps;
  w.wy = fyhi - fylo + taps;
  w.pitch = w.wx + pad + ((w.wx + pad ^ nx) & 1);
  w.shift = 2 * pad +
            static_cast<int>((k * ny * nx + static_cast<long long>(w.y0) * nx + w.x0 + cpar) & 1);
  return w;
}

__device__ __forceinline__ int window_doubles(const Window& w) { return w.shift + w.wy * w.pitch; }

// Issue the cp.async copies of window w of image k into `slot` (16-byte
// aligned) by the block's `nthreads` threads: a warp a row, each row as
// 16-byte pairs with an 8-byte head and tail where its ends are odd, or,
// with `pairs` false (a window at the pitch of its own width), element by
// element.  The caller commits and waits.
__device__ void stage_window(double* slot, const double* __restrict__ combined, long long k,
                             int ny, int nx, const Window& w, int nthreads, bool pairs) {
  const int lane = threadIdx.x & 31;
  for (int a = threadIdx.x >> 5; a < w.wy; a += nthreads >> 5) {
    const long long g = (k * ny + w.y0 + a) * static_cast<long long>(nx) + w.x0;
    const double* src = combined + g;
    double* dstp = slot + w.shift + a * w.pitch;
    if (!pairs) {
      for (int i = lane; i < w.wx; i += 32) cp_async8(dstp + i, src + i);
      continue;
    }
    const int e0 = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 3) & 1);
    const int npair = (w.wx - e0) >> 1;
    for (int i = lane; i < npair + 2; i += 32) {
      if (i < npair) {
        cp_async16(dstp + e0 + 2 * i, src + e0 + 2 * i);
      } else if (i == npair) {
        if (e0) cp_async8(dstp, src);
      } else if ((w.wx - e0) & 1) {
        cp_async8(dstp + w.wx - 1, src + w.wx - 1);
      }
    }
  }
}

// Hopper's bulk copies (the TMA engine, without a tensor map: the stack's
// rows are nx doubles, not a multiple of 16 bytes for odd nx) with their
// completion counted on an mbarrier in shared memory.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(arrivals)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned phase) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(phase)
      : "memory");
}
__device__ __forceinline__ void bulk_copy(double* dst, const double* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Part `part` of `parts` of window w (made with pad 1) of image k into
// `slot` (16-byte aligned) by one warp: each of its rows as one bulk copy
// of whole 16-byte pairs (lane a row),
// from the even sample at or before its first (into the pad before it, or
// the pad after the row above) to the odd one at or after its last; the
// copies complete on `bar` (one arrival a part), whose expected bytes are
// set first.  A row's
// pairs lie inside the stack: an image row of the stack starts or ends on
// an odd double only where a neighbouring row, or the stack's 16-byte
// aligned allocation, holds the other half of the pair.
__device__ void stage_window_bulk(double* slot, const double* __restrict__ combined,
                                  long long k, int ny, int nx, const Window& w,
                                  unsigned long long* bar, int part, int parts) {
  const int lane = threadIdx.x & 31;
  unsigned bytes = 0;
  for (int a = lane + 32 * part; a < w.wy; a += 32 * parts) {
    const double* src = combined + (k * ny + w.y0 + a) * static_cast<long long>(nx) + w.x0;
    const int e0 = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 3) & 1);
    bytes += 16u * static_cast<unsigned>((w.wx + e0 + 1) >> 1);
  }
  bytes = __reduce_add_sync(0xffffffffu, bytes);
  // the generic reads of the slot's last window come before these writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (lane == 0) mbar_expect(bar, bytes);
  __syncwarp();
  for (int a = lane + 32 * part; a < w.wy; a += 32 * parts) {
    const double* src = combined + (k * ny + w.y0 + a) * static_cast<long long>(nx) + w.x0;
    const int e0 = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 3) & 1);
    bulk_copy(slot + w.shift + a * w.pitch - e0, src - e0,
              16u * static_cast<unsigned>((w.wx + e0 + 1) >> 1), bar);
  }
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

__device__ __forceinline__ Tile load_tile(const int* __restrict__ tiles, int i) {
  const int* t = tiles + 5 * i;
  return Tile{t[0], t[1], t[2], t[3], t[4]};
}

// One piece of a pool tile -- its i1 entries u in [ua, ub) -- with its
// row's metadata and its window.  k < 0: the piece adds nothing; tile < 0:
// the block's walk is over.  route 1: read from L2 (the window outgrows a
// slot even for one i1, or the tile is not the planner's: v outside w2 or
// wider than kPoolV).
struct PoolPiece {
  int tile, ua, ub;
  Tile t;
  int k, i1s, i2s, w2, off, nval, pbase, pw2, pstride, poff;
  int route;
  Window w;
};

constexpr int kPoolU = 64;   // most i1 entries of a piece
constexpr int kPoolV = 64;   // most i2 entries of a tile on the shared route

// A piece's table entries: x, y of i1 entries i1_start + ua + a (a <
// kPoolU) and of i2 entries i2_start + v0 + b (b < kPoolV); NaN outside the
// tables (such queries are off the grid).
struct PoolTables {
  double x1[kPoolU], y1[kPoolU], x2[kPoolV], y2[kPoolV];
};

// Warp-wide extremes (min x, max x, min y, max y) of n table entries; NaN
// entries are skipped, and none gives +inf, -inf.
__device__ __forceinline__ void warp_extremes(const double* x, const double* y, int n,
                                              double e[4]) {
  const double inf = __longlong_as_double(0x7ff0000000000000LL);
  e[0] = inf;
  e[1] = -inf;
  e[2] = inf;
  e[3] = -inf;
  for (int i = threadIdx.x & 31; i < n; i += 32) {
    e[0] = fmin(e[0], x[i]);
    e[1] = fmax(e[1], x[i]);
    e[2] = fmin(e[2], y[i]);
    e[3] = fmax(e[3], y[i]);
  }
  for (int o = 16; o; o >>= 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const double v = __shfl_xor_sync(0xffffffffu, e[j], o);
      e[j] = (j & 1) ? fmax(e[j], v) : fmin(e[j], v);
    }
  }
}

// The next piece (tile `tile`, from u = ua; ua < 0: the tile's first) into
// *out and its table entries into *tab, computed by one warp: the tile's
// queries up to kPoolCap and kPoolU i1 entries, halved in u until their
// window fits a slot.  The window comes from the extremes of the piece's
// table entries, clipped to the family's valid range: by qpos's
// monotonicity it holds every query on the grid.
template <int TAPS>
__device__ void pool_next(PoolPiece* out, PoolTables* tab, int tile, int ua, int ntiles,
                          const int* __restrict__ tiles, const int* __restrict__ ks,
                          const int* __restrict__ imeta, const int* __restrict__ dmeta, int K,
                          int ny, int nx, const double* __restrict__ xt,
                          const double* __restrict__ yt, int L, double s, double off,
                          int cpar) {
  constexpr int lo = Family<TAPS>::kLo, hi = Family<TAPS>::kHi;
  const int lane = threadIdx.x & 31;
  PoolPiece p;
  p.tile = tile < ntiles ? tile : -1;
  p.k = -1;
  p.route = 0;
  if (p.tile >= 0) {
    p.t = load_tile(tiles, tile);
    const int* im = imeta + 5 * p.t.row;
    const int* pm = dmeta + 5 * p.t.row;
    p.i1s = im[0];
    p.i2s = im[1];
    p.w2 = max(im[2], 1);
    p.off = im[3];
    p.nval = min(im[4], pm[4]);
    p.pbase = pm[0];
    p.pw2 = max(pm[1], 1);
    p.pstride = pm[2];
    p.poff = pm[3];
    const int k = ks[p.t.row];
    p.ua = ua < 0 ? p.t.u0 : ua;
    const int end = p.t.u0 + max(p.t.nu, 0);
    p.ub = min(end, p.ua + min(kPoolU, max(kPoolCap / max(p.t.nv, 1), 1)));
    if (p.t.nv > 0 && p.ua < end && k >= 0 && k < K) p.k = k;
    if (p.t.v0 < 0 || p.t.v0 + p.t.nv > p.w2 || p.t.nv > kPoolV) p.route = 1;
    if (p.route == 1) p.ub = end;
  }
  if (p.k >= 0 && p.route == 0) {
    const double nan = __longlong_as_double(0x7ff8000000000000LL);
    for (int b = lane; b < p.t.nv; b += 32) {
      const int i = p.i2s + p.t.v0 + b;
      const bool in = i >= 0 && i < L;
      tab->x2[b] = in ? xt[i] : nan;
      tab->y2[b] = in ? yt[i] : nan;
    }
    for (int a = lane; a < p.ub - p.ua; a += 32) {
      const int i = p.i1s + p.ua + a;
      const bool in = i >= 0 && i < L;
      tab->x1[a] = in ? xt[i] : nan;
      tab->y1[a] = in ? yt[i] : nan;
    }
    __syncwarp();
    double e2[4];
    warp_extremes(tab->x2, tab->y2, p.t.nv, e2);
    for (;;) {
      double e1[4];
      warp_extremes(tab->x1, tab->y1, p.ub - p.ua, e1);
      // an empty or all-NaN range fails the first tests
      bool live = e1[0] <= e1[1] && e1[2] <= e1[3] && e2[0] <= e2[1] && e2[2] <= e2[3];
      double fxl = 0, fxh = -1, fyl = 0, fyh = -1;
      if (live) {
        const double xa = qpos(e1[0], e2[1], s, off), xb = qpos(e1[1], e2[0], s, off);
        const double ya = qpos(e1[2], e2[3], s, off), yb = qpos(e1[3], e2[2], s, off);
        fxl = fmax(floor(fmin(xa, xb)), static_cast<double>(lo));
        fxh = fmin(floor(fmax(xa, xb)), static_cast<double>(nx - hi - 1));
        fyl = fmax(floor(fmin(ya, yb)), static_cast<double>(lo));
        fyh = fmin(floor(fmax(ya, yb)), static_cast<double>(ny - hi - 1));
        live = fxl <= fxh && fyl <= fyh;
      }
      if (!live) {
        p.k = -1;            // no query of the piece is on the grid
        break;
      }
      p.w = make_window(static_cast<int>(fxl), static_cast<int>(fxh), static_cast<int>(fyl),
                        static_cast<int>(fyh), lo, TAPS, p.k, ny, nx, cpar, 1);
      if (window_doubles(p.w) <= kPoolSlot) break;
      if (p.ub - p.ua == 1) {
        p.route = 1;                       // the rest of the tile, from L2
        p.ub = p.t.u0 + p.t.nu;
        break;
      }
      p.ub = p.ua + (p.ub - p.ua + 1) / 2;
    }
  }
  if (lane == 0) *out = p;
  __syncwarp();
}

// Query q of a piece on the shared route (u = ua + q / nv, v = v0 + q % nv,
// inside the row's w2): its position from the piece's tables and its
// destination, or false when it adds nothing.
template <int TAPS>
__device__ __forceinline__ bool pool_query(const PoolPiece& p, const PoolTables& tab, int q,
                                           int dst_len, int ny, int nx, double s, double off,
                                           double& x, double& y, int& d) {
  const int a = q / p.t.nv;
  const int b = q - a * p.t.nv;
  const int u = p.ua + a;
  const int f = u * p.w2 + p.t.v0 + b;
  const int j = f - p.off;
  if (j < 0 || j >= p.nval) return false;
  if (p.pw2 == p.w2 && p.poff == p.off) {
    d = p.pbase + u * p.pstride + p.t.v0 + b;     // g = f: g / w2 = u, g % w2 = v0 + b
  } else {
    const int g = p.poff + j;
    const int gq = g / p.pw2;
    d = p.pbase + gq * p.pstride + (g - gq * p.pw2);
  }
  if (d < 0 || d >= dst_len) return false;
  x = qpos(tab.x1[a], tab.x2[b], s, off);
  y = qpos(tab.y1[a], tab.y2[b], s, off);
  return on_grid<TAPS>(floor(x), floor(y), ny, nx);
}

// Query q of any piece, from the tables in global memory (the L2 route).
template <int TAPS>
__device__ __forceinline__ bool pool_query_l2(const PoolPiece& p, int q, int dst_len,
                                              const double* __restrict__ xt,
                                              const double* __restrict__ yt, int L, int ny,
                                              int nx, double s, double off, double& x,
                                              double& y, int& d) {
  const int a = q / p.t.nv;
  const int f = (p.ua + a) * p.w2 + p.t.v0 + (q - a * p.t.nv);
  const int j = f - p.off;
  if (j < 0 || j >= p.nval) return false;
  const int g = p.poff + j;
  const int gq = g / p.pw2;
  d = p.pbase + gq * p.pstride + (g - gq * p.pw2);
  if (d < 0 || d >= dst_len) return false;
  const int fq = f / p.w2;
  const int i1 = p.i1s + fq;
  const int i2 = p.i2s + (f - fq * p.w2);
  if (i1 < 0 || i1 >= L || i2 < 0 || i2 >= L) return false;
  x = qpos(xt[i1], xt[i2], s, off);
  y = qpos(yt[i1], yt[i2], s, off);
  return on_grid<TAPS>(floor(x), floor(y), ny, nx);
}

__device__ __forceinline__ void work_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"r"(kPoolWork) : "memory");
}

// Pool mode: value j of a row lands at dst_base0 + (g / w2) * stride + g % w2,
// g = off + j (dmeta's own w2 and off).
//
// Persistent blocks walk the tiles (block b takes tiles b, b + grid, ...),
// each cut into pieces (pool_next).  While the workers (the warps after the
// kPoolProducers producers) compute piece i from one slot, warps 1.. stage
// piece i + 1's window into the other slot with bulk copies, and warp 0
// finds piece i + 2 and then waits for the copies; a block barrier ends the
// step.  The workers take a piece on the shared route in three parts, a
// barrier of theirs between them:
//   decode  each query once, into registers: its position (from the piece's
//           tables), its destination, its window offset, and its bank
//           (offset mod 16) ranked among the piece's queries of that bank;
//   order   each valid query to its place in (rank, bank) order, so that 16
//           consecutive ones fall on 16 distinct banks;
//   compute in that order: taps, the 8-byte patch loads from the window, an
//           f64 atomicAdd to the destination.
// Shared memory: the two slots, then x, y (doubles), the window offset and
// the destination (ints) of kPoolCap queries in that order.
template <int TAPS>
__global__ void __launch_bounds__(kPoolThreads, 1)
sweep_pool_kernel(double* __restrict__ dst, int dst_len, const double* __restrict__ combined,
                  int K, int ny, int nx, const double* __restrict__ xt,
                  const double* __restrict__ yt, int L, const int* __restrict__ ks,
                  const int* __restrict__ imeta, const int* __restrict__ dmeta,
                  const int* __restrict__ tiles, int ntiles, double inv_scale, double off_grid,
                  unsigned long long* __restrict__ l2_tiles) {
  constexpr int lo = Family<TAPS>::kLo;
  constexpr int kWork = kPoolWork;
  constexpr int kKeys = (kPoolCap + kWork - 1) / kWork;
  extern __shared__ __align__(16) double sm[];
  __shared__ PoolPiece pieces[3];
  __shared__ PoolTables tabs[3];
  __shared__ int cnt[16];
  __shared__ unsigned long long bar;
  double* qx = sm + 2 * kPoolSlot;
  double* qy = qx + kPoolCap;
  int* qo = reinterpret_cast<int*>(qy + kPoolCap);
  int* qd = qo + kPoolCap;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = threadIdx.x - 32 * kPoolProducers;   // a worker's index
  // the parity of the stack's first double on 16 bytes
  const int cpar = static_cast<int>((reinterpret_cast<uintptr_t>(combined) >> 3) & 1);
  if (static_cast<int>(blockIdx.x) >= ntiles) return;

  // the first two pieces and the first window
  unsigned phase = 0;                 // the mbarrier's phase (warp 0 waits)
  if (warp == 0) {
    if (lane == 0) mbar_init(&bar, kPoolProducers - 1);
    __syncwarp();
    pool_next<TAPS>(&pieces[0], &tabs[0], blockIdx.x, -1, ntiles, tiles, ks, imeta, dmeta, K,
                    ny, nx, xt, yt, L, inv_scale, off_grid, cpar);
  } else if (c >= 0 && c < 16) {
    cnt[c] = 0;
  }
  __syncthreads();
  if (warp < kPoolProducers) {
    const PoolPiece& p0 = pieces[0];
    const bool staged = p0.k >= 0 && p0.route == 0;
    if (staged && warp > 0)
      stage_window_bulk(sm, combined, p0.k, ny, nx, p0.w, &bar, warp - 1, kPoolProducers - 1);
    if (warp == 0) {
      if (staged) {
        mbar_wait(&bar, phase);
        phase ^= 1;
      }
      const bool more = p0.ub < p0.t.u0 + p0.t.nu;
      pool_next<TAPS>(&pieces[1], &tabs[1], more ? p0.tile : p0.tile + gridDim.x,
                      more ? p0.ub : -1, ntiles, tiles, ks, imeta, dmeta, K, ny, nx, xt, yt, L,
                      inv_scale, off_grid, cpar);
    }
  }
  __syncthreads();

  for (int i = 0;; ++i) {
    const int s = i % 3, slot_i = i & 1;
    const PoolPiece p = pieces[s];
    if (p.tile < 0) break;
    if (warp < kPoolProducers) {
      // the next piece's window into the other slot (warps 1..), the piece
      // after it (warp 0)
      const PoolPiece& n = pieces[(i + 1) % 3];
      const bool staged = n.tile >= 0 && n.k >= 0 && n.route == 0;
      if (staged && warp > 0)
        stage_window_bulk(sm + (slot_i ^ 1) * kPoolSlot, combined, n.k, ny, nx, n.w, &bar,
                          warp - 1, kPoolProducers - 1);
      if (warp == 0) {
        if (n.tile >= 0) {
          const bool more = n.ub < n.t.u0 + n.t.nu;
          pool_next<TAPS>(&pieces[(i + 2) % 3], &tabs[(i + 2) % 3],
                          more ? n.tile : n.tile + gridDim.x, more ? n.ub : -1, ntiles, tiles,
                          ks, imeta, dmeta, K, ny, nx, xt, yt, L, inv_scale, off_grid, cpar);
        } else if (lane == 0) {
          pieces[(i + 2) % 3].tile = -1;
        }
        if (staged) {
          mbar_wait(&bar, phase);
          phase ^= 1;
        }
      }
    } else {
      if (p.k >= 0 && p.route == 1) {
        // from L2, in query order
        if (c == 0) atomicAdd(l2_tiles, 1ull);
        const double* img = combined + static_cast<size_t>(p.k) * ny * nx;
        const int nq = (p.ub - p.ua) * p.t.nv;
        for (int q = c; q < nq; q += kWork) {
          double x, y;
          int d;
          if (!pool_query_l2<TAPS>(p, q, dst_len, xt, yt, L, ny, nx, inv_scale, off_grid, x, y,
                                   d))
            continue;
          const double fx = floor(x), fy = floor(y);
          double wxt[TAPS], wyt[TAPS];
          taps<TAPS>(x - fx - 0.5, wxt);
          taps<TAPS>(y - fy - 0.5, wyt);
          const int ix = static_cast<int>(fx) - lo, iy = static_cast<int>(fy) - lo;
          atomicAdd(dst + d, patch_sum<TAPS>(img + iy * nx + ix, nx, wxt, wyt, LoadGlobal()));
        }
      } else if (p.k >= 0) {
        const PoolTables& tab = tabs[s];
        const double* slot = sm + slot_i * kPoolSlot;
        const int nq = (p.ub - p.ua) * p.t.nv;
        // decode: every query once, kept in registers; its bank ranked
        // among the piece's (the lanes of one bank found from four ballots)
        double qxr[kKeys], qyr[kKeys];
        int qor[kKeys], qdr[kKeys], keys[kKeys];
#pragma unroll
        for (int it = 0; it < kKeys; ++it) {
          const int q = c + it * kWork;
          const bool ok = q < nq && pool_query<TAPS>(p, tab, q, dst_len, ny, nx, inv_scale,
                                                     off_grid, qxr[it], qyr[it], qdr[it]);
          int bank = 0;
          if (ok) {
            qor[it] = p.w.shift +
                      (static_cast<int>(floor(qyr[it])) - lo - p.w.y0) * p.w.pitch +
                      (static_cast<int>(floor(qxr[it])) - lo - p.w.x0);
            bank = qor[it] & 15;
          }
          unsigned same = __ballot_sync(0xffffffffu, ok);
#pragma unroll
          for (int bit = 0; bit < 4; ++bit) {
            const unsigned set = __ballot_sync(0xffffffffu, (bank >> bit) & 1);
            same &= (bank >> bit) & 1 ? set : ~set;
          }
          const int leader = ok ? __ffs(same) - 1 : lane;
          int first = 0;
          if (ok && lane == leader) first = atomicAdd(&cnt[bank], __popc(same));
          first = __shfl_sync(0xffffffffu, first, leader);
          keys[it] = ok ? ((first + __popc(same & ((1u << lane) - 1u))) << 4 | bank) : -1;
        }
        work_barrier();
        // order: each query to its place in (rank, bank) order
        int cb[16];
#pragma unroll
        for (int b = 0; b < 16; ++b) cb[b] = cnt[b];
        int nvalid = 0;
#pragma unroll
        for (int b = 0; b < 16; ++b) nvalid += cb[b];
#pragma unroll
        for (int it = 0; it < kKeys; ++it) {
          if (keys[it] < 0) continue;
          const int rank = keys[it] >> 4, bank = keys[it] & 15;
          int pos = 0;
#pragma unroll
          for (int b = 0; b < 16; ++b) pos += min(cb[b], rank) + (b < bank && cb[b] > rank);
          qx[pos] = qxr[it];
          qy[pos] = qyr[it];
          qo[pos] = qor[it];
          qd[pos] = qdr[it];
        }
        work_barrier();
        // compute, bank by bank
        for (int e = c; e < nvalid; e += kWork) {
          const double x = qx[e], y = qy[e];
          const double fx = floor(x), fy = floor(y);
          double wxt[TAPS], wyt[TAPS];
          taps<TAPS>(x - fx - 0.5, wxt);
          taps<TAPS>(y - fy - 0.5, wyt);
          atomicAdd(dst + qd[e],
                    patch_sum<TAPS>(slot + qo[e], p.w.pitch, wxt, wyt, LoadShared()));
        }
        if (c < 16) cnt[c] = 0;   // read by every worker before the last barrier
      }
    }
    __syncthreads();
  }
}

// B mode: value j of a row lands at dst_base + (g % m) * n_pad + col0 + g / m,
// g = off + j (dmeta's off), m = n2f^2.  Query f = off + j pairs table entry
// i1 = i1_start + f / m with output pixel p = f % m of the row's lattice,
// whose origin is table entry i2_start: (xt[i2_start] + p % n2f,
// yt[i2_start] + p / n2f).  The planner (interp_cuda.sweep_tiles) raises
// unless the tables hold exactly that lattice, so this is the same as
// reading the tables at i2_start + p.  A tile is a run of i1 of one row (u0,
// nu) with the output pixels [v0, v0 + nv) they pair with; each i1 keeps
// those of its own that are queries of the row.
//
// A block takes a run and cuts it into sub-runs of at most `run` i1 whose
// union window fits `wcap` doubles (one warp finds them from each i1's
// extreme lattice columns and rows, qpos being monotone).  A sub-run
// stages its window once and computes all its tap sets at once (a barrier);
// then for each i1 the horizontal sums (window row a, output column c) go
// to one of two buffers, a barrier, and the vertical sums to the
// destinations, while the next i1's horizontal sums fill the other buffer:
// one barrier an i1 and two a sub-run.  Both sums keep the order of
// sum_a wy[a] (sum_b wx[b] img).
//
// Shared memory (b_layout), all of it dynamic: the window (wcap doubles),
// x taps and y taps (run, n2f, kPitch), the horizontal sums (nbuf, wmax,
// n2f), the x and y floors (run, n2f each; INT_MIN off the grid or not
// needed), then the sub-run's head (BHead) and its i1 (BI1, run).  The
// floors of n2f lattice points spread over (n2f - 1) |inv_scale| samples
// differ by at most floor((n2f - 1) |inv_scale|) + 2, rounding included,
// so one i1's window never exceeds wmax = that + TAPS samples on either
// axis.  The compact layout, for the lattices whose one i1 does not fit
// beside two buffers, is the one the B body of commit 910c170 took: one
// i1 a sub-run, one buffer, a window of wmax x wmax at the pitch of its
// own width (8-byte copies), and the head and i1 kept in the buffer until
// the horizontal sums overwrite it (two more barriers an i1).  Its bytes
// are that body's, so every lattice that body launched launches here.
struct BI1 {
  double x1, y1;                     // the i1's table entry
  int plo, phi;                      // its outputs [plo, phi)
  int clo, chi, rlo, rhi;            // their lattice columns and rows
  int fxlo, fxhi, fylo, fyhi;        // their floors on the grid (fxlo > fxhi: none)
};
struct BHead {
  Window w;                          // the sub-run's union window
  int nsub;                          // its i1 (negative: none on the grid)
  int pad;
};
static_assert(sizeof(BHead) % 8 == 0 && sizeof(BI1) % 8 == 0, "8-byte aligned");

// The shared-memory layout of a B-mode block: the most i1 a sub-run may
// hold (run), the window's doubles (wcap), the horizontal-sum buffers
// (nbuf), whether the window is compact and the bytes.
struct BLayout {
  int run, wcap, nbuf, compact;
  size_t bytes;
};

template <int TAPS>
__global__ void __launch_bounds__(kBThreads, kBMinBlocks)
sweep_b_kernel(double* __restrict__ dst, int dst_len, const double* __restrict__ combined,
               int K, int ny, int nx, const double* __restrict__ xt,
               const double* __restrict__ yt, int L, const int* __restrict__ ks,
               const int* __restrict__ imeta, const int* __restrict__ dmeta,
               const int* __restrict__ tiles, double inv_scale, double off_grid, int n_pad,
               int n2f, int wmax, BLayout lay) {
  constexpr int lo = Family<TAPS>::kLo, hi = Family<TAPS>::kHi;
  constexpr int pitch = Family<TAPS>::kPitch;
  extern __shared__ __align__(16) double sm[];
  const int run = lay.run, wcap = lay.wcap;
  const bool compact = lay.compact != 0;
  double* win = sm;
  double* tx = win + wcap;
  double* ty = tx + run * n2f * pitch;
  double* hs = ty + run * n2f * pitch;
  const int hsz = compact ? max(wmax * n2f, static_cast<int>((sizeof(BHead) + sizeof(BI1)) / 8))
                          : lay.nbuf * wmax * n2f;
  int* fxs = reinterpret_cast<int*>(hs + hsz);
  int* fys = fxs + run * n2f;
  BHead* head = compact ? reinterpret_cast<BHead*>(hs) : reinterpret_cast<BHead*>(fys + run * n2f);
  BI1* gi = reinterpret_cast<BI1*>(head + 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const Tile t = load_tile(tiles, blockIdx.x);
  const int* im = imeta + 5 * t.row;
  const int* bm = dmeta + 4 * t.row;
  const int k = ks[t.row];
  const int m = n2f * n2f;
  const int i2s = im[1];
  if (k < 0 || k >= K || i2s < 0 || i2s + m > L) return;
  const int nval = min(im[4], bm[3]);
  const double X0 = xt[i2s], Y0 = yt[i2s];
  const int end = t.u0 + t.nu;
  const int cpar = static_cast<int>((reinterpret_cast<uintptr_t>(combined) >> 3) & 1);

  for (int ua = t.u0; ua < end;) {
    if (warp == 0) {
      // lane j: i1 u = ua + j, its outputs, rows, columns and floors
      const int u = ua + lane;
      const int i1 = im[0] + u;
      BI1 g;
      g.plo = max(t.v0, im[3] - u * m);
      g.phi = min(t.v0 + t.nv, im[3] + nval - u * m);
      g.fxlo = 1;
      g.fxhi = 0;
      g.fylo = 1;
      g.fyhi = 0;
      const bool in_run = u < end;
      if (in_run && i1 >= 0 && i1 < L && g.plo < g.phi) {
        g.rlo = g.plo / n2f;
        g.rhi = (g.phi - 1) / n2f;
        g.clo = g.rlo == g.rhi ? g.plo % n2f : 0;
        g.chi = g.rlo == g.rhi ? (g.phi - 1) % n2f : n2f - 1;
        g.x1 = xt[i1];
        g.y1 = yt[i1];
        const double xa = qpos(g.x1, X0 + g.clo, inv_scale, off_grid);
        const double xb = qpos(g.x1, X0 + g.chi, inv_scale, off_grid);
        const double ya = qpos(g.y1, Y0 + g.rlo, inv_scale, off_grid);
        const double yb = qpos(g.y1, Y0 + g.rhi, inv_scale, off_grid);
        const double fxl = fmax(floor(fmin(xa, xb)), static_cast<double>(lo));
        const double fxh = fmin(floor(fmax(xa, xb)), static_cast<double>(nx - hi - 1));
        const double fyl = fmax(floor(fmin(ya, yb)), static_cast<double>(lo));
        const double fyh = fmin(floor(fmax(ya, yb)), static_cast<double>(ny - hi - 1));
        if (fxl <= fxh && fyl <= fyh) {
          g.fxlo = static_cast<int>(fxl);
          g.fxhi = static_cast<int>(fxh);
          g.fylo = static_cast<int>(fyl);
          g.fyhi = static_cast<int>(fyh);
        }
      }
      const bool has = g.fxlo <= g.fxhi;
      // the union of lanes 0..j (inclusive scan)
      int xl = has ? g.fxlo : INT_MAX, xh = has ? g.fxhi : INT_MIN;
      int yl = has ? g.fylo : INT_MAX, yh = has ? g.fyhi : INT_MIN;
      for (int o = 1; o < 32; o <<= 1) {
        const int a0 = __shfl_up_sync(0xffffffffu, xl, o), a1 = __shfl_up_sync(0xffffffffu, xh, o);
        const int a2 = __shfl_up_sync(0xffffffffu, yl, o), a3 = __shfl_up_sync(0xffffffffu, yh, o);
        if (lane >= o) {
          xl = min(xl, a0);
          xh = max(xh, a1);
          yl = min(yl, a2);
          yh = max(yh, a3);
        }
      }
      bool fits = in_run && lane < run;
      Window w{};
      if (xl <= xh) {
        w = make_window(xl, xh, yl, yh, lo, TAPS, k, ny, nx, cpar, 0);
        if (compact) {
          w.pitch = w.wx;
          w.shift = 0;
        }
        fits = fits && window_doubles(w) <= wcap;
      }
      // the leading lanes that fit; lane 0 always does (wcap >= one i1's window)
      const unsigned ok = __ballot_sync(0xffffffffu, fits);
      const int n = max(ok == 0xffffffffu ? 32 : __ffs(~ok) - 1, 1);
      if (lane < n) gi[lane] = g;
      if (lane == n - 1) {
        head->w = w;
        head->nsub = xl <= xh ? n : -n;    // negative: no i1 of the sub-run is on the grid
      }
    }
    __syncthreads();
    const int nsub = head->nsub;
    const int n = abs(nsub);
    if (nsub < 0) {
      ua += n;
      __syncthreads();   // every thread has read the head before warp 0 rewrites it
      continue;
    }
    const Window w = head->w;
    stage_window(win, combined, k, ny, nx, w, kBThreads, !compact);
    cp_async_commit();
    // the sub-run's tap sets: (i1 j, axis, column or row c)
    for (int item = threadIdx.x; item < n * 2 * n2f; item += kBThreads) {
      const int j = item / (2 * n2f);
      const int rem = item - j * 2 * n2f;
      const bool col = rem < n2f;
      const int c = col ? rem : rem - n2f;
      const BI1& g = gi[j];
      int* fl = (col ? fxs : fys) + j * n2f;
      const bool need = g.fxlo <= g.fxhi &&
                        (col ? (c >= g.clo && c <= g.chi) : (c >= g.rlo && c <= g.rhi));
      const double q = need ? (col ? qpos(g.x1, X0 + c, inv_scale, off_grid)
                                   : qpos(g.y1, Y0 + c, inv_scale, off_grid))
                            : 0.0;
      const double fq = floor(q);
      const int nn = col ? nx : ny;
      if (!need || !(fq >= lo && fq < static_cast<double>(nn - hi))) {
        fl[c] = INT_MIN;
        continue;
      }
      taps<TAPS>(q - fq - 0.5, (col ? tx : ty) + (j * n2f + c) * pitch);
      fl[c] = static_cast<int>(fq);
    }
    // the first i1, read before the horizontal sums may overwrite it (compact)
    const BI1 g0 = gi[0];
    cp_async_wait<0>();
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      const BI1 g = j == 0 ? g0 : gi[j];
      const int u = ua + j;
      double* h = hs + (lay.nbuf == 2 ? (j & 1) * wmax * n2f : 0);
      const bool has = g.fxlo <= g.fxhi;
      const int ncol = g.chi - g.clo + 1;
      const int wyj = g.fyhi - g.fylo + TAPS;
      // horizontal sums: window row a of this i1's rows, output column c; a
      // half-warp takes one column (its taps in registers) and 16 rows at a
      // time, which an odd window pitch puts on 16 distinct banks
      if (has) {
        for (int cc = threadIdx.x >> 4; cc < ncol; cc += kBThreads >> 4) {
          const int c = g.clo + cc;
          const int fx = fxs[j * n2f + c];
          if (fx == INT_MIN) continue;
          double wv[TAPS];
#pragma unroll
          for (int b = 0; b < TAPS; ++b) wv[b] = tx[(j * n2f + c) * pitch + b];
          const double* base = win + w.shift + (g.fylo - lo - w.y0) * w.pitch + (fx - lo - w.x0);
          for (int a = threadIdx.x & 15; a < wyj; a += 16) {
            const double* row = base + a * w.pitch;
            double s = 0.0;
#pragma unroll
            for (int b = 0; b < TAPS; ++b) s += wv[b] * row[b];
            h[a * n2f + c] = s;
          }
        }
      }
      __syncthreads();
      // vertical sums and the scatter
      if (has) {
        for (int p = g.plo + threadIdx.x; p < g.phi; p += kBThreads) {
          const int r = p / n2f, c = p - r * n2f;
          const int fx = fxs[j * n2f + c], fy = fys[j * n2f + r];
          if (fx == INT_MIN || fy == INT_MIN) continue;
          const int gg = bm[2] + u * m + p - im[3];
          const int gq = gg / m;
          const int d = bm[0] + (gg - gq * m) * n_pad + bm[1] + gq;
          if (d < 0 || d >= dst_len) continue;
          const double* colp = h + (fy - g.fylo) * n2f + c;
          const double* wv = ty + (j * n2f + r) * pitch;
          double acc = 0.0;
#pragma unroll
          for (int a = 0; a < TAPS; ++a) acc += wv[a] * colp[a * n2f];
          atomicAdd(dst + d, acc);
        }
      }
      // one buffer: the next i1's horizontal sums (or, compact, the next
      // head) wait for these vertical sums
      if (lay.nbuf == 1) __syncthreads();
    }
    ua += n;
  }
}

// ---------------------------------------------------------------------------
// K1 on a canvas lattice
// ---------------------------------------------------------------------------

// The canvas body's launch shape: a CTA of kCanvasThreads threads takes a
// tile of kCanvasRows x kCanvasCols canvas points, kCanvasPer a thread, in
// kCanvasPer steps of 8 rows (of 8 columns where the tile is transposed);
// a half-warp takes 16 neighbouring points of one canvas row (of one
// column, transposed: the host picks the lattice direction that runs
// closer to the image's rows), so that its patch reads fall on 16
// neighbouring samples of one window row, and window rows start 8 doubles
// (mod 16) apart, so that those of a half-warp along a diagonal fall on
// distinct banks too.  kCanvasSmem bytes of shared memory a CTA, so that
// kCanvasMinBlocks CTAs an SM overlap one another's staging and compute:
// the mbarrier, the window reduction, each row's first segment, the
// segments of the tile, the tile's positions (x, then y, a slot a point),
// and the window (kCanvasWindow doubles).
constexpr int kCanvasThreads = 256;
constexpr int kCanvasRows = 32, kCanvasCols = 32;
constexpr int kCanvasSegs = 64;                   // most segments a tile (the planner's cut)
constexpr int kCanvasPer = kCanvasRows * kCanvasCols / kCanvasThreads;
constexpr int kCanvasMinBlocks = 4;
constexpr int kCanvasSmem = 57344;
constexpr int kCanvasXY = 16 + 16 + 4 * kCanvasRows + 16 * kCanvasSegs;
constexpr int kCanvasHead = kCanvasXY + 16 * kCanvasRows * kCanvasCols;
constexpr int kCanvasWindow = (kCanvasSmem - kCanvasHead) / 8;
static_assert(kCanvasPer * kCanvasThreads == kCanvasRows * kCanvasCols &&
                  kCanvasRows == 32 && kCanvasCols == 32 && kCanvasThreads == 256 &&
                  kCanvasPer == 4,
              "a half-warp 16 points of a row, a step 8 rows of 32");
static_assert(kCanvasXY % 16 == 0 && kCanvasHead % 16 == 0, "16-byte aligned regions");

// The step-`i` point of this thread: its row and column in the tile.
__device__ __forceinline__ void canvas_point(int i, bool transpose, int* r, int* c) {
  const int w = static_cast<int>(threadIdx.x) >> 5, lane = threadIdx.x & 31;
  const int along = 16 * (w & 1) + (lane & 15), across = 8 * i + 2 * (w >> 1) + (lane >> 4);
  *r = transpose ? along : across;
  *c = transpose ? across : along;
}

// The floors (fx, fy) of this block's queries on the grid (positions sx,
// sy: a slot a point), reduced to their extremes in red[0..3] (min fx, max
// fx, min fy, max fy; INT_MAX ... where there is none); ends with a barrier.
template <int TAPS>
__device__ __forceinline__ void canvas_extremes(const int* q, const double* sx,
                                                const double* sy, int ny, int nx, int* red) {
  if (threadIdx.x < 4) red[threadIdx.x] = (threadIdx.x & 1) ? INT_MIN : INT_MAX;
  __syncthreads();
  int e[4] = {INT_MAX, INT_MIN, INT_MAX, INT_MIN};
#pragma unroll
  for (int i = 0; i < kCanvasPer; ++i) {
    if (q[i] < 0) continue;
    const int slot = i * kCanvasThreads + threadIdx.x;
    const double fxd = floor(sx[slot]), fyd = floor(sy[slot]);
    if (!on_grid<TAPS>(fxd, fyd, ny, nx)) continue;
    const int fx = static_cast<int>(fxd), fy = static_cast<int>(fyd);
    e[0] = min(e[0], fx);
    e[1] = max(e[1], fx);
    e[2] = min(e[2], fy);
    e[3] = max(e[3], fy);
  }
  for (int o = 16; o; o >>= 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int v = __shfl_xor_sync(0xffffffffu, e[j], o);
      e[j] = (j & 1) ? max(e[j], v) : min(e[j], v);
    }
  }
  if ((threadIdx.x & 31) == 0 && e[0] != INT_MAX) {
    atomicMin(red, e[0]);
    atomicMax(red + 1, e[1]);
    atomicMin(red + 2, e[2]);
    atomicMax(red + 3, e[3]);
  }
  __syncthreads();
}

// Query (qx, qy): 0 off the grid, else its patch from the staged window `w`
// (win non-null) or read through L1 / L2 (in 16-byte pairs where `pairs`),
// in K1's order sum_a wy[a] (sum_b wx[b] img).
template <int TAPS>
__device__ __forceinline__ double canvas_value(double qx, double qy, const double* win,
                                               const Window& w, const double* __restrict__ img,
                                               int ny, int nx, bool pairs) {
  constexpr int lo = Family<TAPS>::kLo;
  const double fxd = floor(qx), fyd = floor(qy);
  if (!on_grid<TAPS>(fxd, fyd, ny, nx)) return 0.0;
  double wxt[TAPS], wyt[TAPS];
  taps<TAPS>(qx - fxd - 0.5, wxt);
  taps<TAPS>(qy - fyd - 0.5, wyt);
  const int fx = static_cast<int>(fxd), fy = static_cast<int>(fyd);
  if (win != nullptr)
    return patch_sum<TAPS>(win + w.shift + (fy - lo - w.y0) * w.pitch + (fx - lo - w.x0),
                           w.pitch, wxt, wyt, LoadShared());
  return pairs ? patch_sum_pairs<TAPS>(img, nx, fx, fy, wxt, wyt)
               : patch_sum<TAPS>(img + (fy - lo) * nx + (fx - lo), nx, wxt, wyt, LoadGlobal());
}

// One CTA a tile of the canvas lattice (tiles (T, 5) int32: its first
// segment s0, its segments ns, its first canvas row, its first column and
// its columns, at most kCanvasCols).  A
// segment (seg (S, 4) int32) is a run of consecutive columns of one canvas
// row: [row, first column, its first query, its queries]; a tile's segments
// are those of its rows, in row and column order.  The CTA finds each of its
// points' query from the segments, loads x and y into shared memory,
// reduces the floors of the queries on the grid to a window and stages it
// into shared memory with bulk copies on an mbarrier (a warp a share of its
// rows), then computes every query from the window.  The host cuts tiles
// small enough for their windows to fit kCanvasWindow (canvas_tiles, from
// the lattice's step); a window that still outgrows it reads its patches
// through L1 / L2, as does every query where `stage` is false (an image
// not on 16 bytes).
template <int TAPS>
__global__ void __launch_bounds__(kCanvasThreads, kCanvasMinBlocks)
interp_canvas_kernel(const double* __restrict__ img, int ny, int nx,
                     const double* __restrict__ x, const double* __restrict__ y,
                     const int* __restrict__ seg, const int* __restrict__ tiles, bool stage,
                     bool transpose, double* __restrict__ out) {
  constexpr int lo = Family<TAPS>::kLo;
  extern __shared__ __align__(16) char smem[];
  auto* bar = reinterpret_cast<unsigned long long*>(smem);
  int* red = reinterpret_cast<int*>(smem + 16);
  int* rowseg = reinterpret_cast<int*>(smem + 32);
  int* sseg = rowseg + kCanvasRows;
  double* sx = reinterpret_cast<double*>(smem + kCanvasXY);
  double* sy = sx + kCanvasRows * kCanvasCols;
  double* win = reinterpret_cast<double*>(smem + kCanvasHead);
  const int t = threadIdx.x, warp = t >> 5;
  const int* td = tiles + 5 * static_cast<long long>(blockIdx.x);
  const int s0 = td[0], ns = td[1], row0 = td[2], c0 = td[3], ncols = td[4];
  if (t < kCanvasRows) rowseg[t] = -1;
  if (t == 0) mbar_init(bar, kCanvasThreads / 32);
  __syncthreads();
  for (int j = t; j < ns; j += kCanvasThreads) {
    const int* s = seg + 4 * (static_cast<long long>(s0) + j);
#pragma unroll
    for (int k = 0; k < 4; ++k) sseg[4 * j + k] = s[k];
    if (j == 0 || s[-4] != s[0]) rowseg[s[0] - row0] = j;
  }
  __syncthreads();

  // each point's query (-1: none); its position into its slot
  int q[kCanvasPer];
#pragma unroll
  for (int i = 0; i < kCanvasPer; ++i) {
    int r, c;
    canvas_point(i, transpose, &r, &c);
    q[i] = -1;
    if (c >= ncols) r = -1;
    c += c0;
    for (int j = r >= 0 ? rowseg[r] : -1; j >= 0 && j < ns && sseg[4 * j] == row0 + r; ++j) {
      const int first = sseg[4 * j + 1];
      if (c >= first && c < first + sseg[4 * j + 3]) {
        q[i] = sseg[4 * j + 2] + (c - first);
        break;
      }
    }
    const int slot = i * kCanvasThreads + t;
    sx[slot] = q[i] >= 0 ? x[q[i]] : 0.0;
    sy[slot] = q[i] >= 0 ? y[q[i]] : 0.0;
  }

  canvas_extremes<TAPS>(q, sx, sy, ny, nx, red);
  Window w{0, 0, 0, 0, 0, 0};
  bool staged = false;
  if (red[0] != INT_MAX && stage) {
    w = make_window(red[0], red[1], red[2], red[3], lo, TAPS, 0, ny, nx, 0, 1);
    if ((nx & 1) == 0) w.pitch += (24 - (w.pitch & 15)) & 15;
    staged = window_doubles(w) <= kCanvasWindow;
  }
  if (staged) {
    stage_window_bulk(win, img, 0, ny, nx, w, bar, warp, kCanvasThreads / 32);
    mbar_wait(bar, 0);
  }
  const bool pairs = (nx & 1) == 0 && (reinterpret_cast<uintptr_t>(img) & 15) == 0;
#pragma unroll
  for (int i = 0; i < kCanvasPer; ++i) {
    if (q[i] < 0) continue;
    const int slot = i * kCanvasThreads + t;
    out[q[i]] = canvas_value<TAPS>(sx[slot], sy[slot], staged ? win : nullptr, w, img, ny, nx,
                                   pairs);
  }
}

// Within `budget` bytes: the largest run (at most kBRun) whose tap sets,
// floors, head and i1 fit beside two buffers and one i1's window, the
// window taking the rest; run 0 where one i1 does not fit.
template <int TAPS>
BLayout b_layout_within(int n2f, int wmax, size_t budget) {
  const size_t per_i1 =
      static_cast<size_t>(n2f) * (2 * Family<TAPS>::kPitch * 8 + 2 * 4) + sizeof(BI1);
  const size_t fixed = static_cast<size_t>(2) * wmax * n2f * 8 + sizeof(BHead);
  // one i1's window: wmax rows at a pitch of at most wmax + 1, and the shift
  const size_t wmin = (static_cast<size_t>(wmax) * (wmax + 1) + 2) & ~static_cast<size_t>(1);
  BLayout l{0, 0, 2, 0, 0};
  for (int r = kBRun; r >= 1; --r) {
    if (fixed + r * per_i1 + wmin * 8 <= budget) {
      l.run = r;
      l.wcap = static_cast<int>(((budget - fixed - r * per_i1) / 8) & ~static_cast<size_t>(1));
      l.bytes = fixed + r * per_i1 + static_cast<size_t>(l.wcap) * 8;
      break;
    }
  }
  return l;
}

// The layout a launch takes: two blocks an SM (kBBlockSmem) where their
// window holds a sub-run of two i1 with room to spare -- one i1's window
// grown by two lattice steps, an i1 sitting one input pixel, about (wmax -
// TAPS - 1) / (n2f - 1) samples, from the next -- else one block an SM
// (kBBlockSmemOne), whose window holds longer runs (measured on the main
// path: lattices whose one i1 window nearly fills the smaller budget, as
// the Piff bench group's PSFs oversampled 8x, run faster so; the bench and
// production groups as two); else the compact layout, whose bytes may
// exceed kBBlockSmemOne (the wrapper raises before it launches).
template <int TAPS>
BLayout b_layout(int n2f, int wmax) {
  const BLayout two = b_layout_within<TAPS>(n2f, wmax, kBBlockSmem);
  const double step = static_cast<double>(wmax - TAPS - 1) / std::max(n2f - 1, 1);
  if (two.run >= 2 && (wmax + 2.0 * step) * (wmax + 1) + 2 <= two.wcap) return two;
  const BLayout one = b_layout_within<TAPS>(n2f, wmax, kBBlockSmemOne);
  if (one.run >= 1) return one;
  const size_t hs = std::max(static_cast<size_t>(wmax) * n2f,
                             (sizeof(BHead) + sizeof(BI1)) / 8);
  const int wcap = wmax * wmax;
  return BLayout{1, wcap, 1, 1,
                 8 * (static_cast<size_t>(wcap) + 2 * n2f * Family<TAPS>::kPitch + hs) +
                     sizeof(int) * 2 * static_cast<size_t>(n2f)};
}

template <int TAPS>
size_t b_smem_bytes(int n2f, int wmax) {
  return b_layout<TAPS>(n2f, wmax).bytes;
}

constexpr size_t kPoolSmem = sizeof(double) * (static_cast<size_t>(2) * kPoolSlot +
                                               2 * static_cast<size_t>(kPoolCap)) +
                             sizeof(int) * 2 * static_cast<size_t>(kPoolCap);

template <int TAPS>
int launch_dense(const double* images, int R, int ny, int nx, const double* x,
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
  interp_dense_warp_kernel<TAPS><<<static_cast<unsigned int>(blocks), kK1Threads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      images, ny, nx, x, y, nq, n, ctiles, runs, nruns, pairs, out);
  return static_cast<int>(cudaGetLastError());
}

template <int TAPS>
int launch_canvas(const double* images, int ny, int nx, const double* x, const double* y,
                  const int* seg, const int* tiles, int ntiles, int transpose, double* out,
                  void* stream) {
  if (ntiles <= 0) return static_cast<int>(cudaGetLastError());
  cudaFuncSetAttribute(interp_canvas_kernel<TAPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kCanvasSmem);
  const bool stage = (reinterpret_cast<uintptr_t>(images) & 15) == 0;
  interp_canvas_kernel<TAPS><<<ntiles, kCanvasThreads, kCanvasSmem,
                               static_cast<cudaStream_t>(stream)>>>(
      images, ny, nx, x, y, seg, tiles, stage, transpose != 0, out);
  return static_cast<int>(cudaGetLastError());
}

template <int TAPS>
int launch_sweep(double* dst, int dst_len, const double* combined, int K, int ny, int nx,
                 const double* xt, const double* yt, int L, const int* ks, const int* imeta,
                 const int* dmeta, const int* tiles, int ntiles, double inv_scale,
                 double off_grid, int mode, int n_pad, int n2f, int wmax,
                 unsigned long long* l2_tiles, void* stream) {
  if (ntiles <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    cudaFuncSetAttribute(sweep_pool_kernel<TAPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(kPoolSmem));
    int dev = 0, nsm = 0, per = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, sweep_pool_kernel<TAPS>, kPoolThreads,
                                                  kPoolSmem);
    const int grid = std::min(ntiles, std::max(per, 1) * std::max(nsm, 1));
    sweep_pool_kernel<TAPS><<<grid, kPoolThreads, kPoolSmem, s>>>(
        dst, dst_len, combined, K, ny, nx, xt, yt, L, ks, imeta, dmeta, tiles, ntiles,
        inv_scale, off_grid, l2_tiles);
  } else {
    const BLayout l = b_layout<TAPS>(n2f, wmax);
    cudaFuncSetAttribute(sweep_b_kernel<TAPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(l.bytes));
    sweep_b_kernel<TAPS><<<ntiles, kBThreads, l.bytes, s>>>(
        dst, dst_len, combined, K, ny, nx, xt, yt, L, ks, imeta, dmeta, tiles, inv_scale,
        off_grid, n_pad, n2f, wmax, l);
  }
  return static_cast<int>(cudaGetLastError());
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
  return launch_dense<10>(images, R, ny, nx, x, y, nq, n, out, stream);
}

// The same with the 8-tap G4460 family.
int interp_g4460_dense(const double* images, int R, int ny, int nx, const double* x,
                       const double* y, long long nq, int n, double* out, void* stream) {
  return launch_dense<8>(images, R, ny, nx, x, y, nq, n, out, stream);
}

// K1 on a canvas lattice: one image (ny, nx), x / y / out (nq,) f64,
// contiguous, on the device of `stream`; seg (S, 4) int32, the queries'
// segments [canvas row, first column, first query, queries] in row and
// column order, covering the queries once; tiles (ntiles, 5) int32 [first
// segment, segments, first row, first column, columns] of at most 64
// segments, 32 rows and 32 columns each (interp_cuda.canvas_tiles);
// transpose: a half-warp takes 16 points of a canvas column, not of a row.
// Returns cudaGetLastError() after the launch.
int interp_d5512_dense_canvas(const double* image, int ny, int nx, const double* x,
                              const double* y, const int* seg, const int* tiles, int ntiles,
                              int transpose, double* out, void* stream) {
  return launch_canvas<10>(image, ny, nx, x, y, seg, tiles, ntiles, transpose, out, stream);
}

// The same with the 8-tap G4460 family.
int interp_g4460_dense_canvas(const double* image, int ny, int nx, const double* x,
                              const double* y, const int* seg, const int* tiles, int ntiles,
                              int transpose, double* out, void* stream) {
  return launch_canvas<8>(image, ny, nx, x, y, seg, tiles, ntiles, transpose, out, stream);
}

// dst (dst_len,) f64, updated in place; combined (K, ny, nx) f64; xt / yt (L,)
// f64; ks (nrows,) int32; imeta (nrows, 5) int32; dmeta (nrows, 5) in mode 0
// (pool) or (nrows, 4) in mode 1 (B), int32; tiles (ntiles, 5) int32, one
// block each; l2_tiles one counter on the device (mode 0).  Mode 1 needs
// n_pad, n2f and wmax (interp_cuda.b_window).  Returns cudaGetLastError()
// after the launch.
int sweep_d5512_scatter(double* dst, int dst_len, const double* combined, int K, int ny,
                        int nx, const double* xt, const double* yt, int L, const int* ks,
                        const int* imeta, const int* dmeta, const int* tiles, int ntiles,
                        double inv_scale, double off_grid, int mode, int n_pad, int n2f,
                        int wmax, unsigned long long* l2_tiles, void* stream) {
  return launch_sweep<10>(dst, dst_len, combined, K, ny, nx, xt, yt, L, ks, imeta, dmeta,
                          tiles, ntiles, inv_scale, off_grid, mode, n_pad, n2f, wmax,
                          l2_tiles, stream);
}

// The same with the 8-tap G4460 family.
int sweep_g4460_scatter(double* dst, int dst_len, const double* combined, int K, int ny,
                        int nx, const double* xt, const double* yt, int L, const int* ks,
                        const int* imeta, const int* dmeta, const int* tiles, int ntiles,
                        double inv_scale, double off_grid, int mode, int n_pad, int n2f,
                        int wmax, unsigned long long* l2_tiles, void* stream) {
  return launch_sweep<8>(dst, dst_len, combined, K, ny, nx, xt, yt, L, ks, imeta, dmeta,
                         tiles, ntiles, inv_scale, off_grid, mode, n_pad, n2f, wmax,
                         l2_tiles, stream);
}

// Shared-memory bytes of a B-mode block of the family with `taps` taps (10:
// D5512, 8: G4460) for n2f and a window of at most wmax x wmax samples; 0
// for another tap count.
size_t interp_b_smem_bytes(int taps, int n2f, int wmax) {
  if (taps == 10) return b_smem_bytes<10>(n2f, wmax);
  if (taps == 8) return b_smem_bytes<8>(n2f, wmax);
  return 0;
}

}  // extern "C"
