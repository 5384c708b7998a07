"""
Destriping: removal of correlated row-stripe noise before coaddition.

Counterpart of pyimcom_tpu/imdestripe.py (reference src/pyimcom/imdestripe.py,
Laliotis et al. 2026).  Each exposure's stripe parameters (one offset per
detector row, optionally plus per-amplifier column blocks) are fit by
minimizing

    eps = sum_A sum_pixels f( I_A - P_A(params) - J_A )

where J_A is the (destriped) overlap prediction interpolated from the
neighboring exposures, and f is a quadratic / absolute / Huber penalty.
The minimization is nonlinear conjugate gradient with an exact quadratic
line search, wall-time checkpointing, and pickle restart.

The cost and its exact gradient are always the device-resident
:class:`~pyimcom_tpu_torch.ops.destripe_device.DestripeCost` on the
problem's device (the card unless the caller asks for the CPU): the pair
gathers are the hand-written CUDA kernels K3 and K4 on the card
(ops/bilinear_cuda.py), their plain PyTorch versions on the CPU.  The JAX
package's second, host-only route (per-target NumPy cost and gradient, its
fork pool, PYIMCOM_DESTRIPE_WORKERS) is not ported: it is a CPU-backend form
whose gradient only approximates the gain term.

The pair maps' storage is chosen by keywords of :class:`DestripeProblem`
and :func:`main`, the counterparts of the JAX package's environment
switches: ``map_dtype="f32"`` (PYIMCOM_DESTRIPE_MAP_DTYPE) builds them at
half the width, and ``memmap=True`` (PYIMCOM_DESTRIPE_MEMMAP) spills them to
memory-mapped files in a temporary directory and keeps them off the card:
they are streamed up pair by pair from the files' pages
(``DestripeCost(map_store="host")``).

    python -m pyimcom_tpu_torch.imdestripe cfg.json     # on the card
"""

from __future__ import annotations

import glob
import os
import pickle
import re
import tempfile
import time

import numpy as np
import torch

from .config import Config, Settings as Stn
from .device import DTYPE, resolve_device
from .fitsio import HDUList, Header, ImageHDU, fits_read, fits_write
from .ops import bilinear
from .ops.destripe_device import DestripeCost
from .utils import compareutils
from .wcsutil import WCS


# ---------------------------------------------------------------------------
# bilinear resampling between SCAs (reference-compatible wrappers)
# ---------------------------------------------------------------------------

def _on(device, a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float64), dtype=DTYPE, device=device)


def interpolate_image_bilinear(image_B, image_A, interpolated_image, mask=None,
                               device="cuda"):
    """Interpolate SCA B onto SCA A's grid (reference imdestripe.py:972),
    gain-weighted by B's g_eff, or the `mask` array without a gain; on
    `device` (K3 on the card)."""
    dev = resolve_device(device)
    xf, yf, _ = compareutils.map_sca2sca(image_A.w, image_B.w, pad=0,
                                         nside=image_A.image.shape[-1])
    if mask is not None and isinstance(mask, np.ndarray):
        out = bilinear.bilinear_gather(_on(dev, mask), _on(dev, xf), _on(dev, yf))
    else:
        out = bilinear.bilinear_gather(_on(dev, image_B.image), _on(dev, xf), _on(dev, yf),
                                       _on(dev, image_B.g_eff))
    interpolated_image[:] = out.cpu().numpy().reshape(image_A.image.shape)


def transpose_interpolate(image_A, wcs_A, image_B, original_image, device="cuda"):
    """Adjoint interpolation from A's grid back onto B (imdestripe.py:1001),
    without a gain; on `device` (K4 on the card)."""
    dev = resolve_device(device)
    xf, yf, _ = compareutils.map_sca2sca(wcs_A, image_B.w, pad=0,
                                         nside=image_A.shape[-1])
    out = bilinear.bilinear_scatter_adjoint(_on(dev, image_A.reshape(xf.shape)), _on(dev, xf),
                                            _on(dev, yf), image_B.image.shape)
    original_image[:] = out.cpu().numpy()


# ---------------------------------------------------------------------------
# effective gain and masks
# ---------------------------------------------------------------------------

def compute_g_eff(wcs_, shape):
    """
    Effective gain from the WCS Jacobian: 1 / (|det d(ra,dec)/d(x,y)| cos dec)
    -- pixels covering less sky get more weight (reference Sca_img.__init__,
    imdestripe.py:273-311; central differences on a 1-pixel-padded grid).
    """
    ny, nx = shape
    yy, xx = np.mgrid[-1:ny + 1, -1:nx + 1].astype(np.float64)
    ra, dec = wcs_.pix2world(xx.ravel(), yy.ravel())
    ra = ra.reshape(ny + 2, nx + 2)
    dec = dec.reshape(ny + 2, nx + 2)
    dra_dx = (ra[1:-1, 2:] - ra[1:-1, :-2]) / 2
    dra_dy = (ra[2:, 1:-1] - ra[:-2, 1:-1]) / 2
    ddec_dx = (dec[1:-1, 2:] - dec[1:-1, :-2]) / 2
    ddec_dy = (dec[2:, 1:-1] - dec[:-2, 1:-1]) / 2
    det = dra_dx * ddec_dy - dra_dy * ddec_dx
    return 1.0 / (np.abs(det) * np.cos(np.deg2rad(dec[1:-1, 1:-1])))


def apply_object_mask(image, mask=None, threshold_m=0.0, threshold_c=0.3,
                      inplace=False, type="fits"):
    """
    Bright-object mask: pixels above threshold_m*median + threshold_c,
    dilated 5x5 (reference apply_object_mask, imdestripe.py:781-873).  The
    'jwst' type uses robust sigma-clipped background estimation with
    two-level seeded region growing.

    Returns (masked image, boolean mask of MASKED pixels).
    """
    from scipy.ndimage import binary_dilation, binary_propagation

    if mask is not None and isinstance(mask, np.ndarray):
        neighbor_mask = mask
    else:
        if type == "jwst":
            valid = np.isfinite(image)
            if not np.any(valid):
                neighbor_mask = np.zeros_like(image, dtype=bool)
            else:
                vals = image[valid]
                for _ in range(3):
                    bkg = np.median(vals)
                    sigma = 1.4826 * np.median(np.abs(vals - bkg))
                    if sigma <= 0:
                        break
                    keep = np.abs(vals - bkg) < 3.0 * sigma
                    if np.count_nonzero(keep) < 100:
                        break
                    vals = vals[keep]
                bkg = np.median(vals)
                sigma = 1.4826 * np.median(np.abs(vals - bkg))
                if not np.isfinite(sigma) or sigma <= 0:
                    sigma = np.std(vals) if vals.size > 1 else 0.0
                resid = np.where(valid, image - bkg, 0.0)
                seed = valid & (resid >= max(threshold_c, 6.0 * sigma))
                grow = valid & (resid >= max(0.5 * threshold_c, 2.5 * sigma))
                grown = binary_propagation(seed, mask=grow)
                neighbor_mask = binary_dilation(
                    grown, structure=np.ones((3, 3), bool), iterations=2)
        else:
            high = image >= threshold_m * np.median(image) + threshold_c
            neighbor_mask = binary_dilation(high, structure=np.ones((5, 5), bool))

    if inplace:
        image[neighbor_mask] = 0
        return image, neighbor_mask
    return np.where(neighbor_mask, 0, image), neighbor_mask


def compute_boundary_continuity_penalty(destriped_image, mask, amp_cols,
                                        col_boundary_const, chunk_width=50,
                                        chunk_height=100):
    """
    Penalty for mean-level discontinuities of the destriped image across
    amplifier column-block boundaries, accumulated over row chunks
    (reference compute_boundary_continuity_penalty, imdestripe.py:1413-1490).
    """
    if not amp_cols or amp_cols <= 0 or col_boundary_const <= 0:
        return 0.0
    n_rows, n_cols = destriped_image.shape
    n_blocks = n_cols // amp_cols
    pen = 0.0
    for b in range(1, n_blocks):
        lo = max(b * amp_cols - chunk_width, 0)
        hi = min(b * amp_cols + chunk_width, n_cols)
        for c0 in range(0, n_rows, 4 * chunk_height):
            c1 = min(c0 + chunk_height, n_rows)
            lv = destriped_image[c0:c1, lo:b * amp_cols]
            rv = destriped_image[c0:c1, b * amp_cols:hi]
            lm = mask[c0:c1, lo:b * amp_cols]
            rm = mask[c0:c1, b * amp_cols:hi]
            if not (np.any(lm) and np.any(rm)):
                continue
            pen += (np.mean(lv[lm]) - np.mean(rv[rm])) ** 2
    return col_boundary_const * pen


def boundary_continuity_penalty_grad_image(destriped_image, mask, amp_cols,
                                           col_boundary_const, chunk_width=50,
                                           chunk_height=100):
    """
    d(penalty)/d(destriped_image): for each chunk pair the penalty is
    kappa * (mean(lv[lm]) - mean(rv[rm]))^2, so the gradient places
    +2*kappa*d/N_l on masked left pixels and -2*kappa*d/N_r on masked right
    pixels.  (The reference carries this penalty in the cost only,
    imdestripe.py:1413-1490; here it also steers the CG direction so the
    COLBOUNDARY knob is functional.)
    """
    g = np.zeros_like(destriped_image)
    if not amp_cols or amp_cols <= 0 or col_boundary_const <= 0:
        return g
    n_rows, n_cols = destriped_image.shape
    n_blocks = n_cols // amp_cols
    for b in range(1, n_blocks):
        lo = max(b * amp_cols - chunk_width, 0)
        hi = min(b * amp_cols + chunk_width, n_cols)
        for c0 in range(0, n_rows, 4 * chunk_height):
            c1 = min(c0 + chunk_height, n_rows)
            lm = mask[c0:c1, lo:b * amp_cols]
            rm = mask[c0:c1, b * amp_cols:hi]
            if not (np.any(lm) and np.any(rm)):
                continue
            lv = destriped_image[c0:c1, lo:b * amp_cols]
            rv = destriped_image[c0:c1, b * amp_cols:hi]
            d = np.mean(lv[lm]) - np.mean(rv[rm])
            coef = 2.0 * col_boundary_const * d
            g[c0:c1, lo:b * amp_cols] += coef * lm / lm.sum()
            g[c0:c1, b * amp_cols:hi] -= coef * rm / rm.sum()
    return g


# ---------------------------------------------------------------------------
# stripe parameter model
# ---------------------------------------------------------------------------

def forward_par(params: np.ndarray, shape, amp_cols: int = None) -> np.ndarray:
    """
    Stripe image from parameters: params[:ny] broadcast along rows; with
    `amp_cols`, the remaining params are per-column-block offsets
    (reference Parameters.forward_par, imdestripe.py:670).
    """
    ny, nx = shape
    img = np.broadcast_to(params[:ny, None], (ny, nx)).copy()
    if amp_cols:
        nblk = nx // amp_cols
        for b in range(nblk):
            img[:, b * amp_cols:(b + 1) * amp_cols] += params[ny + b]
    return img


def transpose_par(img: np.ndarray, cfg=None) -> np.ndarray:
    """Adjoint of forward_par: row sums (+ column-block sums if enabled)."""
    row = np.sum(img, axis=1)
    amp_cols = getattr(cfg, "amp_cols", None) if cfg is not None else None
    if amp_cols:
        nblk = img.shape[1] // amp_cols
        col = np.array([np.sum(img[:, b * amp_cols:(b + 1) * amp_cols])
                        for b in range(nblk)])
        return np.concatenate([row, col])
    return row


def n_params(shape, amp_cols=None) -> int:
    ny, nx = shape
    return ny + (nx // amp_cols if amp_cols else 0)


# ---------------------------------------------------------------------------
# penalty functions
# ---------------------------------------------------------------------------

def penalty(r: np.ndarray, model: str, hub: float = 1.0):
    """(f(r), f'(r)) for the configured cost model."""
    if model in (None, "quadratic"):
        return 0.5 * r * r, r
    if model == "absolute":
        return np.abs(r), np.sign(r)
    if model == "huber_loss":
        a = np.abs(r)
        f = np.where(a <= hub, 0.5 * r * r, hub * (a - 0.5 * hub))
        fp = np.where(a <= hub, r, hub * np.sign(r))
        return f, fp
    raise ValueError(f"unknown cost model {model!r}")


# ---------------------------------------------------------------------------
# SCA container
# ---------------------------------------------------------------------------

class Sca_img:
    """One exposure: image, WCS, effective gain, mask, and stripe params."""

    def __init__(self, image, wcs, g_eff=None, name="", mask=None):
        self.image = np.asarray(image, dtype=np.float64)
        self.w = wcs
        self.name = name
        if g_eff is None:
            g_eff = np.ones_like(self.image)
        self.g_eff = np.asarray(g_eff, dtype=np.float64)
        self.mask = (np.ones(self.image.shape, dtype=bool) if mask is None
                     else np.asarray(mask, dtype=bool))

    @classmethod
    def from_file(cls, path, cfg=None, name="", indata_type="fits",
                  add_objmask=True, use_wcs_gain=True, obsid=None, scaid=None):
        """
        Load one destriping input (reference Sca_img.__init__,
        imdestripe.py:210-330): FITS (WCS-bearing HDU) or Roman L2 ASDF;
        effective gain from the WCS Jacobian (or a GAINDIR flat); optional
        lab-noise frame (DSNOISEFILE) and bright-object mask.
        """
        if indata_type == "asdf" or path.endswith(".asdf"):
            from .asdfio import GWCS, asdf_read

            tree = asdf_read(path)
            w = GWCS(tree["roman"]["meta"]["wcs"])
            image = np.asarray(tree["roman"]["data"], dtype=np.float64)
        else:
            hdus = fits_read(path)
            hdr = None
            for h in hdus:
                if "CTYPE1" in h.header:
                    hdr = h.header
                    break
            w = WCS.from_header(hdr)
            data_hdu = hdus["SCI"] if indata_type == "jwst" else hdus[0]
            image = np.asarray(data_hdu.data, dtype=np.float64)

        gaindir = getattr(cfg, "gaindir", False) if cfg is not None else False
        if gaindir:
            gf = fits_read(f"{gaindir}/{Stn.RomanFilters[cfg.use_filter]}_geff.fits")
            g_eff = np.asarray(gf[int(scaid) - 1].data, dtype=np.float64)
        elif use_wcs_gain:
            g_eff = compute_g_eff(w, image.shape)
        else:
            g_eff = None

        # optional lab-noise frame (reference apply_noise, imdestripe.py:359)
        noisefile = getattr(cfg, "ds_noisefile", False) if cfg is not None else False
        if noisefile and obsid is not None:
            nf = fits_read(f"{noisefile}{obsid}_{scaid}.fits")
            frame = np.asarray(nf[0].data, dtype=np.float64) * 1.458 * 50
            ny, nx = image.shape
            image = image + frame[4:ny + 4, 4:nx + 4]

        mask = np.ones(image.shape, dtype=bool)
        if add_objmask:
            thr = (15.0, 5.0) if indata_type == "jwst" else (0.0, 0.3)
            _, obj = apply_object_mask(image, threshold_m=thr[0],
                                       threshold_c=thr[1], type=indata_type)
            mask &= ~obj
        return cls(image, w, g_eff=g_eff, name=name, mask=mask)

    def destriped(self, params, amp_cols=None):
        return self.image - forward_par(params, self.image.shape, amp_cols)


# ---------------------------------------------------------------------------
# the problem: cost and gradient over the exposure set
# ---------------------------------------------------------------------------

def to_memmap(arr, directory, tag):
    """`arr` copied into the memory-mapped file `directory`/`tag`.dat, which
    is returned (the JAX package's DestripeProblem._to_memmap)."""
    path = os.path.join(directory, tag + ".dat")
    mm = np.memmap(path, dtype=arr.dtype, mode="w+", shape=arr.shape)
    mm[...] = arr
    mm.flush()
    return mm


class DestripeProblem:
    """
    The destriping optimization problem over a set of overlapping SCAs.

    Parameters
    ----------
    scas : list of Sca_img
    neighbors : dict i -> list of j (overlap fraction above threshold)
    cost_model : 'quadratic' | 'absolute' | 'huber_loss'
    device : where the cost and gradient run ("cuda" by default; "cpu" runs
        the plain versions of the kernels).
    map_dtype : "f64" (default) or "f32": the width at which the pair maps
        are built and stored (the JAX package's PYIMCOM_DESTRIPE_MAP_DTYPE).
    memmap : spill the maps to memory-mapped files in a temporary directory
        (:attr:`map_dir`, removed with the problem; the JAX package's
        PYIMCOM_DESTRIPE_MEMMAP) and keep them off the device: the cost
        streams them up pair by pair (``map_store="host"``).

    The pixel mappings of every (target, reference) pair are built on the
    host (compareutils.map_sca2sca, at `map_dtype`) and go with the images,
    gains and masks into :attr:`device_cost`, a
    :class:`~pyimcom_tpu_torch.ops.destripe_device.DestripeCost`.
    :attr:`times` holds the host seconds of the map build (``maps_s``) and of
    the upload (``upload_s``).
    """

    def __init__(self, scas, neighbors, cost_model="quadratic", hub_thresh=1.0,
                 amp_cols=None, mask=None, col_boundary_const=0.0, device="cuda",
                 map_dtype="f64", memmap=False):
        dev = resolve_device(device)
        map_dt = {"f32": np.float32, "f64": np.float64}[map_dtype]
        self.scas = scas
        self.neighbors = neighbors
        self.cost_model = cost_model
        self.hub = hub_thresh
        self.amp_cols = amp_cols
        self.col_boundary_const = col_boundary_const or 0.0
        self.npar_each = [n_params(s.image.shape, amp_cols) for s in scas]
        self.offsets = np.concatenate([[0], np.cumsum(self.npar_each)])
        self.mask = mask  # optional list of bool arrays (True = use pixel)
        pairs = [(i, j) for i, js in sorted(neighbors.items()) for j in js]
        self.map_dir = (tempfile.TemporaryDirectory(prefix="pyimcom_destripe_maps_")
                        if memmap else None)
        t0 = time.perf_counter()
        maps = []
        for i, j in pairs:
            xf, yf, _inb = compareutils.map_sca2sca(scas[i].w, scas[j].w, pad=0,
                                                    dtype=map_dt,
                                                    nside=scas[i].image.shape[-1])
            if memmap:
                xf = to_memmap(xf, self.map_dir.name, f"xf_{i}_{j}")
                yf = to_memmap(yf, self.map_dir.name, f"yf_{i}_{j}")
            maps.append((xf, yf))
        t1 = time.perf_counter()
        self.device_cost = DestripeCost(
            np.stack([s.image for s in scas]), np.stack([s.g_eff for s in scas]),
            np.stack(mask) if mask is not None else None, pairs,
            [m[0] for m in maps], [m[1] for m in maps], amp_cols=amp_cols,
            cost_model=cost_model, hub=hub_thresh,
            col_boundary_const=self.col_boundary_const,
            bmasks=[mask[i] if mask is not None else scas[i].mask
                    for i in range(len(scas))],
            device=dev, map_dtype=map_dtype, map_store="host" if memmap else "device")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.times = {"maps_s": t1 - t0, "upload_s": time.perf_counter() - t1}

    def split(self, params):
        return [params[self.offsets[i]:self.offsets[i + 1]]
                for i in range(len(self.scas))]

    def cost(self, params) -> float:
        return self.device_cost.cost(params)

    def cost_and_grad(self, params):
        return self.device_cost.cost_and_grad(params)

    def gradient(self, params) -> np.ndarray:
        """
        d eps / d params: the exact gradient of the whole cost, by autograd
        through the device cost (the pair gathers' adjoint is K4 on the
        card); reference residual_function, imdestripe.py:1231-1410.
        """
        return self.device_cost.cost_and_grad(params)[1]


# ---------------------------------------------------------------------------
# nonlinear conjugate gradient with checkpoint/restart
# ---------------------------------------------------------------------------

def linear_search_quadratic(problem, params, d, g):
    """
    Exact line search for the quadratic cost: the gradient is affine in the
    step, so one trial gradient determines the minimizer
    (reference linear_search_quadratic, imdestripe.py:1882-1997):

        alpha* = alpha_max (-d.g) / (d.(g(alpha_max) - g)).
    """
    eta = 0.1
    a_test = -eta * float(np.dot(g, d)) / (float(np.dot(d, d)) + 1e-12)
    a_max = 1.0 if a_test <= 0 else a_test * 10
    g_trial = problem.gradient(params + a_max * d)
    denom = float(np.dot(d, g_trial - g)) + 1e-12
    alpha = a_max * (-float(np.dot(d, g))) / denom
    g_new = g + (alpha / a_max) * (g_trial - g)
    return params + alpha * d, g_new, alpha


def linear_search_general(problem, params, d, g, n_iter: int = 100,
                          rel_tol: float = 1e-3):
    """
    Bisection + secant root find of d_cost(alpha) = g(alpha).d for
    non-quadratic costs (reference linear_search_general,
    imdestripe.py:1673-1880).
    """
    eta = 0.1
    d_cost0 = float(np.dot(g, d))
    d_cost_tol = abs(d_cost0) * rel_tol
    a_test = -eta * d_cost0 / (float(np.dot(d, d)) + 1e-12)
    if a_test <= 0:
        a_min, a_max = -0.9, 1.0
    else:
        a_min, a_max = a_test * 1e-4, a_test * 10

    def d_cost(a):
        return float(np.dot(problem.gradient(params + a * d), d))

    f_min = d_cost(a_min)
    f_max = d_cost(a_max)
    # grow the bracket if the root is not enclosed
    grow = 0
    while f_min * f_max > 0 and grow < 8:
        a_max *= 4.0
        f_max = d_cost(a_max)
        grow += 1

    a = 0.5 * (a_min + a_max)
    method = "bisection"
    for _ in range(n_iter):
        fa = d_cost(a)
        if abs(fa) < d_cost_tol:
            break
        # secant proposal from the bracket endpoints
        if abs(f_max - f_min) > 1e-300:
            a_sec = a_max - f_max * (a_max - a_min) / (f_max - f_min)
        else:
            a_sec = a
        if f_min * fa <= 0:
            a_max, f_max = a, fa
        else:
            a_min, f_min = a, fa
        if a_min < a_sec < a_max:
            a, method = a_sec, "secant"
        else:
            a, method = 0.5 * (a_min + a_max), "bisection"
        if a_max - a_min < 1e-14 * max(1.0, abs(a)):
            break
    new_params = params + a * d
    return new_params, problem.gradient(new_params), a


_CSV_HEADER = ["iteration", "norm", "convergence_rate", "step_size",
               "gradient_magnitude", "d_cost", "cost", "iter_minutes",
               "ls_minutes", "mse", "parameter_change"]


def conjugate_gradient(problem: DestripeProblem, params0=None, maxiter: int = 30,
                       tol: float = 1e-8, beta_model: str = "PR",
                       restart_file: str = None, time_limit: float = None,
                       log=print, csv_file: str = None):
    """
    Minimize the destriping cost with nonlinear conjugate gradient.

    Beta updates: 'FR' (Fletcher-Reeves), 'PR' (Polak-Ribiere with restart),
    'HS' (Hestenes-Stiefel), 'DY' (Dai-Yuan) -- reference
    imdestripe.py:2147-2162.  The line search is the one-gradient exact
    solve for the quadratic cost and bisection+secant otherwise
    (reference :1673-1997).  Supports pickle checkpoint/restart, a wall-time
    watchdog, and the per-iteration cg_log.csv (reference :2093-2109,
    2228-2244).
    """
    import csv

    t_start = time.time()
    ntot = problem.offsets[-1]
    params = np.zeros(ntot) if params0 is None else np.array(params0, dtype=np.float64)
    it0 = 0
    g = d = None

    if restart_file and os.path.exists(restart_file):
        with open(restart_file, "rb") as f:
            state = pickle.load(f)
        params = state["params"]
        g = state["g"]
        d = state["d"]
        it0 = state["iteration"] + 1
        log(f"restarted CG from {restart_file} at iteration {it0}")

    if g is None:
        g = problem.gradient(params)
        d = -g

    if csv_file and it0 == 0:
        with open(csv_file, "w", newline="") as f:
            csv.writer(f).writerow(_CSV_HEADER)

    history = []
    for it in range(it0, maxiter):
        t_iter = time.time()
        gnorm = float(np.dot(g, g))
        if np.sqrt(gnorm) < tol:
            log(f"CG converged at iteration {it}: |g| = {np.sqrt(gnorm):.3e}")
            break

        t_ls = time.time()
        if problem.cost_model in (None, "quadratic") \
                and not (problem.amp_cols and problem.col_boundary_const > 0):
            new_params, g_new, tstar = linear_search_quadratic(problem, params, d, g)
        else:
            new_params, g_new, tstar = linear_search_general(problem, params, d, g)
        ls_min = (time.time() - t_ls) / 60.0
        step_size = float(np.linalg.norm(new_params - params))
        params = new_params

        if beta_model == "FR":
            beta = float(np.dot(g_new, g_new) / max(gnorm, 1e-300))
        elif beta_model == "PR":
            beta = max(0.0, float(np.dot(g_new, g_new - g) / max(gnorm, 1e-300)))
        elif beta_model == "HS":
            beta = float(np.dot(g_new, g_new - g)
                         / (np.dot(-d, g_new - g) + 1e-300))
        elif beta_model == "DY":
            beta = float(np.dot(g_new, g_new)
                         / (np.dot(-d, g_new - g) + 1e-300))
        else:
            raise ValueError(f"Unknown method for CG direction update: {beta_model}")
        d = -g_new + beta * d
        conv_rate = (np.sqrt(gnorm) - np.linalg.norm(g_new)) / max(np.sqrt(gnorm), 1e-300)
        g = g_new
        e_now = problem.cost(params)
        history.append({"iteration": it, "cost": e_now, "gnorm": np.sqrt(gnorm),
                        "step": tstar, "beta": beta, "t": time.time() - t_start})
        log(f"CG iter {it}: cost = {e_now:.6e}  |g| = {np.sqrt(gnorm):.3e} "
            f"step = {tstar:.3e} beta = {beta:.3f}")
        if csv_file:
            with open(csv_file, "a", newline="") as f:
                csv.writer(f).writerow(
                    [it + 1, np.sqrt(gnorm), conv_rate, step_size,
                     float(np.linalg.norm(g)), float(np.dot(g, d)), e_now,
                     (time.time() - t_iter) / 60.0, ls_min,
                     float(np.mean(g ** 2)), step_size])

        if restart_file:
            with open(restart_file + ".tmp", "wb") as f:
                pickle.dump({"params": params, "g": g, "d": d, "iteration": it,
                             "history": history}, f)
            os.replace(restart_file + ".tmp", restart_file)
        if time_limit is not None and time.time() - t_start > time_limit:
            log(f"CG wall-time limit reached at iteration {it}; checkpointed")
            break

    return params, history


# ---------------------------------------------------------------------------
# the run from a configuration
# ---------------------------------------------------------------------------

def get_scas(cfg, indata_type=None, add_objmask=True, use_wcs_gain=True):
    """
    Load destriping input SCAs named by the DSOBSFILE glob (FITS or Roman
    L2 ASDF; reference get_scas, imdestripe.py:905-969) with effective gain
    from the WCS Jacobian, optional GAINDIR flats, DSNOISEFILE noise frames,
    and bright-object masks.
    """
    scas = []
    names = []
    pattern = cfg.ds_obsfile
    for f in sorted(glob.glob(pattern)):
        m = re.search(r"(\w\d+)_(\d+)_(\d+)", os.path.basename(f))
        if not m:
            continue
        itype = indata_type or ("asdf" if f.endswith(".asdf") else "fits")
        scas.append(Sca_img.from_file(
            f, cfg=cfg, name=m.group(0), indata_type=itype,
            add_objmask=add_objmask, use_wcs_gain=use_wcs_gain,
            obsid=m.group(2), scaid=m.group(3)))
        names.append(m.group(0))
    return scas, names


def main(cfg: Config, maxiter=None, out_path=None, indata_type=None,
         add_objmask=True, use_wcs_gain=True, device="cuda", map_dtype="f64", memmap=False):
    """
    Full destriping run from a configuration (reference main,
    imdestripe.py:2295-2438): find overlaps (cached ovmat.npy), fit stripe
    parameters with nonlinear CG + per-iteration cg_log.csv, write destriped
    FITS triplets (DS image, original, params).  The cost and gradient run
    on `device` (the card unless the caller asks for the CPU); `map_dtype`
    and `memmap` choose the pair maps' storage (DestripeProblem).
    """
    device = resolve_device(device)   # before the host work: no card raises here
    scas, names = get_scas(cfg, indata_type=indata_type,
                           add_objmask=add_objmask, use_wcs_gain=use_wcs_gain)
    if len(scas) < 2:
        raise RuntimeError("destriping needs at least two overlapping exposures")

    outdir = out_path or cfg.ds_outpath or "."
    os.makedirs(outdir, exist_ok=True)

    # overlap matrix, cached on disk (reference imdestripe.py:2369-2377)
    ovfile = os.path.join(outdir, "ovmat.npy")
    if os.path.exists(ovfile):
        ov = np.load(ovfile)
        if ov.shape != (len(scas), len(scas)):
            ov = None
    else:
        ov = None
    if ov is None:
        ov = compareutils.get_overlap_matrix([s.w for s in scas], subsamp=16,
                                             nside=scas[0].image.shape[-1])
        np.save(ovfile, ov)
    neighbors = {i: [j for j in range(len(scas)) if j != i and ov[i, j] > 0.1]
                 for i in range(len(scas))}

    problem = DestripeProblem(
        scas, neighbors, cost_model=cfg.cost_model or "quadratic",
        hub_thresh=cfg.hub_thresh or 1.0, amp_cols=cfg.amp_cols,
        mask=[s.mask for s in scas] if add_objmask else None,
        col_boundary_const=getattr(cfg, "col_boundary_const", 0.0), device=device,
        map_dtype=map_dtype, memmap=memmap)
    params, history = conjugate_gradient(
        problem, maxiter=maxiter or (cfg.cg_maxiter or 10),
        tol=cfg.cg_tol or 1e-8,
        beta_model=getattr(cfg, "cg_model", None) or "PR",
        restart_file=(cfg.ds_restart or None),
        time_limit=getattr(cfg, "ds_time_limit", None),
        csv_file=os.path.join(outdir, "cg_log.csv"))

    ps = problem.split(params)
    for s, p, name in zip(scas, ps, names):
        hdr = Header(s.w.to_header())
        hdus = HDUList([
            ImageHDU(s.destriped(p, cfg.amp_cols).astype(np.float32), header=hdr),
            ImageHDU(s.image.astype(np.float32), name="ORIG"),
            ImageHDU(p.astype(np.float32), name="PARAMS"),
        ])
        fits_write(os.path.join(outdir, f"{cfg.ds_outstem or 'ds'}_{name}.fits"), hdus)
    return params, history


def _profiled_main(cfgfile):
    """CLI entry with cProfile + peak-memory reporting (reference
    imdestripe.__main__, imdestripe.py:2440-2457; memory_profiler is not in
    this environment, so peak RSS comes from resource.getrusage)."""
    import cProfile
    import pstats
    import resource

    cfg = Config(cfgfile)
    outdir = cfg.ds_outpath or "."
    os.makedirs(outdir, exist_ok=True)
    prof = cProfile.Profile()
    prof.enable()
    try:
        main(cfg)
    finally:
        prof.disable()
        with open(os.path.join(outdir, "profile_results.txt"), "w") as f:
            pstats.Stats(prof, stream=f).sort_stats("cumulative").print_stats(60)
        peak_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
        with open(os.path.join(outdir, "memory_profile_results.txt"), "w") as f:
            f.write(f"peak RSS: {peak_mb:.1f} MB\n")
        print(f"imdestripe: peak RSS {peak_mb:.1f} MB; profile written to "
              f"{outdir}/profile_results.txt", flush=True)



if __name__ == "__main__":
    # python -m pyimcom_tpu_torch.imdestripe <config.json>
    import sys

    _profiled_main(sys.argv[1])
