"""
Piff PSF model ingestion without the `piff` package, drawn on a device.

Counterpart of pyimcom_tpu/utils/piffutils.py (reference
src/pyimcom/utils/piffutils.py).  The file reader, the writer and the
Legendre quadrature are host copies of the JAX package's code; the drawing
(:meth:`PiffPSFModel.draw`) runs the port's separable-grid interpolation
(``ops.interp.grid_interp``, D5512) in float64 on an explicit device, the
card by default.  :func:`draw_models` draws S stamps, of one model or of
several, with one interpolation: a block draws the PSFs of a whole PSF group
in one call.

Supported subset (the standard Roman/DES configuration):

* PSF type ``Simple`` / ``SimplePSF`` -- one model + one interpolant.
* Model ``PixelGrid(scale, size, centered)`` -- the PSF is a ``size x size``
  grid of free pixel values with grid spacing ``scale`` (native pixels in
  this module's convention), rendered by band-limited interpolation (the
  D5512 10x10 kernel where Piff renders with GalSim's ``Lanczos(7)``).
* Interpolant ``BasisPolynomial(order)`` over chip coordinates normalized to
  u = (x - (nside-1)/2) / ((nside-1)/2), v likewise: the PixelGrid parameter
  vector at a position is q @ basis(u, v) with monomial basis
  {u^i v^j : i + j <= order}, column-major in (i, j) with j (v) outermost.

File layout read (written by piff's fitsio serialization):

* HDU ``psf``: single-row table with column ``type``.
* HDU ``psf/model``: columns ``type``, ``scale``, ``size`` (and optional
  ``centered``, ``interp`` -- accepted, interpolation always D5512 here).
* HDU ``psf/interp``: columns ``type``, ``order``.
* HDU ``psf/interp/solution``: column ``q``, either with TDIM metadata or
  with NPARAM/NBASIS header keys, reshaped to (nparam, nbasis).

Multi-chip files may repeat this layout under ``psf_{chipnum}/...``
prefixes; single-solution files are used for every chip.

`write_piff_file` produces files in this exact subset.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import roots_legendre

from ..config import Settings as Stn
from ..device import DTYPE, resolve_device
from ..fitsio import HDUList, Header, ImageHDU, TableHDU, fits_read, fits_write


def _basis_exponents(order: int):
    """Monomial exponents (i, j) with i + j <= order, j (v) outermost."""
    return [(i, j) for j in range(order + 1) for i in range(order + 1 - j)]


def _table_value(hdu, col, default=None):
    try:
        val = hdu[col]
    except (KeyError, TypeError):
        return default
    arr = np.asarray(val)
    if arr.ndim >= 1 and arr.shape[0] >= 1:
        v = arr.reshape(-1)[0] if arr.dtype.kind != "U" else arr[0]
    else:
        v = arr
    if isinstance(v, bytes):
        v = v.decode()
    return v


class PiffPSFModel:
    """
    A Piff PSF solution, loaded from its FITS serialization and rendered
    without the piff package (reference PiffPSFModel, piffutils.py:19-96).

    Parameters
    ----------
    psf_file : str -- path to the ``.piff`` FITS file.
    sca : int -- SCA/chip number (1-based); files with per-chip solutions
        use the ``psf_{sca-1}`` HDU prefix, single-solution files apply to
        every chip.
    nside : int -- chip size in pixels (normalization of the interpolation
        coordinates).
    """

    def __init__(self, psf_file, sca, nside: int = Stn.sca_nside):
        self.sca = sca
        self.nside = nside
        hdus = fits_read(psf_file)
        names = {h.name for h in hdus if h.name}
        prefix = "psf"
        if f"psf_{sca - 1}/model" in names:
            prefix = f"psf_{sca - 1}"
        if f"{prefix}/model" not in names:
            raise ValueError(f"{psf_file}: no '{prefix}/model' HDU; not a "
                             "supported Piff file")

        model = hdus[f"{prefix}/model"]
        mtype = str(_table_value(model, "type", "PixelGrid"))
        if "PixelGrid" not in mtype:
            raise NotImplementedError(
                f"Piff model type {mtype!r} not supported (PixelGrid only)")
        self.scale = float(_table_value(model, "scale", 1.0))
        self.size = int(_table_value(model, "size"))

        interp = hdus[f"{prefix}/interp"]
        itype = str(_table_value(interp, "type", "BasisPolynomial"))
        if "Polynomial" not in itype:
            raise NotImplementedError(
                f"Piff interp type {itype!r} not supported "
                "(BasisPolynomial only)")
        self.order = int(_table_value(interp, "order", 0))
        self.exponents = _basis_exponents(self.order)

        sol = hdus[f"{prefix}/interp/solution"]
        if hasattr(sol, "names") and "q" in getattr(sol, "names", []):
            q = np.asarray(sol["q"], dtype=np.float64).reshape(-1)
            npar = sol.header.get("NPARAM")
            nbas = sol.header.get("NBASIS")
            tdim = sol.header.get("TDIM1")
            if npar and nbas:
                q = q.reshape(int(npar), int(nbas))
            elif tdim:
                dims = [int(t) for t in str(tdim).strip("() ").split(",")]
                q = q.reshape(dims[::-1])
            else:
                q = q.reshape(-1, len(self.exponents))
        else:  # image-HDU fallback
            q = np.asarray(sol.data, dtype=np.float64)
        if q.shape[0] == len(self.exponents) and q.shape[0] != self.size ** 2:
            q = q.T  # stored (nbasis, nparam)
        if q.shape != (self.size ** 2, len(self.exponents)):
            raise ValueError(
                f"Piff solution shape {q.shape} does not match "
                f"size^2={self.size ** 2} x nbasis={len(self.exponents)}")
        self.q = q

    def basis(self, x, y):
        """Interpolation basis vector at chip position (x, y), 0-based."""
        half = (self.nside - 1) / 2.0
        u = (x - half) / half
        v = (y - half) / half
        return np.array([u ** i * v ** j for (i, j) in self.exponents])

    def params(self, x, y):
        """PixelGrid pixel values at chip position (x, y): (size, size)."""
        return (self.q @ self.basis(x, y)).reshape(self.size, self.size)

    def draw(self, x, y, stamp_size=48, oversamp=8, normbox=None, device="cuda"):
        """
        Oversampled PSF stamp at chip position (x, y), float32.

        Same contract as the reference draw (piffutils.py:45-96): the stamp
        has ``stamp_size*oversamp`` samples per side with flux per SAMPLE
        (sums to ~1/oversamp^2 per native pixel), centered at
        ((n-1)/2, (n-1)/2).  One stamp of :func:`draw_models`.
        """
        return draw_models([self], [x], [y], stamp_size=stamp_size, oversamp=oversamp,
                           normbox=normbox, device=device)[0]


def draw_inputs(grids, scale, stamp_size=48, oversamp=8, normbox=None, device="cuda"):
    """
    The interpolation inputs of S PixelGrid parameter grids (S, size, size)
    of spacing `scale`, on `device`: the grids padded by INTERP_PAD guard
    pixels (S, size+2*INTERP_PAD, ...) and the JAX draw's query axis, one
    row a grid (S, stamp_size*oversamp), both float64.  `normbox` normalizes
    each grid so that its central normbox x normbox native-pixel region sums
    to 1.
    """
    from ..psfgrp import INTERP_PAD

    dev = resolve_device(device)
    grids = np.asarray(grids, dtype=np.float64)
    S, size = grids.shape[0], grids.shape[-1]
    if normbox is not None:
        c = (size - 1) / 2.0
        lo = int(np.ceil(c - normbox / 2.0))
        hi = int(np.floor(c + normbox / 2.0)) + 1
        grids = np.stack([g / np.sum(g[lo:hi, lo:hi]) for g in grids])

    ns = stamp_size * oversamp
    ctr_out = (ns - 1) / 2.0
    ctr_grid = (size - 1) / 2.0
    ax = (np.arange(ns) - ctr_out) / (oversamp * scale) + ctr_grid + INTERP_PAD
    pad = torch.as_tensor(np.pad(grids, ((0, 0), (INTERP_PAD, INTERP_PAD),
                                         (INTERP_PAD, INTERP_PAD))), dtype=DTYPE, device=dev)
    q = torch.as_tensor(ax, dtype=DTYPE, device=dev)[None, :].expand(S, ns)
    return pad, q


def draw_grids(grids, scale, stamp_size=48, oversamp=8, normbox=None, device="cuda"):
    """
    Render S PixelGrid parameter grids (S, size, size) of spacing `scale` as
    oversampled stamps (S, stamp_size*oversamp, ...) float32: one f64 D5512
    grid interpolation of :func:`draw_inputs` on `device`, division by
    oversamp^2.
    """
    from ..ops.interp import grid_interp

    pad, q = draw_inputs(grids, scale, stamp_size, oversamp, normbox, device)
    vals = grid_interp(pad, q, q)
    return (vals / oversamp ** 2).cpu().numpy().astype(np.float32)


def draw_models(models, x, y, stamp_size=48, oversamp=8, normbox=None, device="cuda"):
    """One stamp per (model, position): models[s] drawn at (x[s], y[s]), as
    a list of float32 stamps.  A model may repeat (S positions of one
    model).  Models of one grid size and spacing are drawn in one
    interpolation; each stamp's values do not depend on the others."""
    out = [None] * len(models)
    groups = {}
    for s, m in enumerate(models):
        groups.setdefault((m.size, m.scale), []).append(s)
    for (_size, scale), idx in groups.items():
        grids = np.stack([models[s].params(x[s], y[s]) for s in idx])
        for s, stamp in zip(idx, draw_grids(grids, scale, stamp_size, oversamp,
                                            normbox, device)):
            out[s] = stamp
    return out


def write_piff_file(fname, q, size, order, scale=1.0, chipnums=None):
    """
    Write a PixelGrid+BasisPolynomial solution in the supported Piff
    layout.  `q` is (size*size, nbasis), or a dict chipnum -> q for
    per-chip solutions.
    """
    def solution_hdus(prefix, qq):
        nb = len(_basis_exponents(order))
        if qq.shape != (size * size, nb):
            raise ValueError(f"q shape {qq.shape} != ({size * size}, {nb})")
        mod = TableHDU(data={"type": np.array(["PixelGrid"]),
                             "scale": np.array([scale]),
                             "size": np.array([size]),
                             "centered": np.array([1])},
                       name=f"{prefix}/model")
        itp = TableHDU(data={"type": np.array(["BasisPolynomial"]),
                             "order": np.array([order])},
                       name=f"{prefix}/interp")
        sol = TableHDU(data={"q": qq.reshape(1, -1)},
                       name=f"{prefix}/interp/solution")
        sol.header["NPARAM"] = size * size
        sol.header["NBASIS"] = nb
        return [mod, itp, sol]

    hdus = [ImageHDU(np.zeros((1,), dtype=np.float32)),
            TableHDU(data={"type": np.array(["Simple"])}, name="psf")]
    if isinstance(q, dict):
        for chip, qq in q.items():
            hdus += solution_hdus(f"psf_{chip}", np.asarray(qq))
    else:
        hdus += solution_hdus("psf", np.asarray(q))
    fits_write(fname, HDUList(hdus))


def psf_stamps_to_legendre_cube(draw_fn, lorder: int, nside: int = 4088):
    """
    Convert a per-position PSF drawing function into a Legendre coefficient
    cube by Gauss-Legendre quadrature over the chip (the conversion the
    reference performs for Piff models, piffutils.py:98-213).

    draw_fn : callable (x, y) -> 2D PSF stamp at chip position (x, y).
    lorder : Legendre order per axis; the cube has (lorder+1)^2 planes.
    """
    from scipy.special import eval_legendre

    xL, wL = roots_legendre(lorder + 1)
    xg, yg = (a.ravel() for a in np.meshgrid(xL, xL))
    wg = np.outer(wL, wL).ravel()
    npoly = (lorder + 1) ** 2
    lrange = np.arange(lorder + 1)

    cube = None
    for i in range(npoly):
        x = nside / 2.0 * (1 + xg[i])
        y = nside / 2.0 * (1 + yg[i])
        stamp = np.asarray(draw_fn(x, y), dtype=np.float64)
        if cube is None:
            cube = np.zeros((npoly,) + stamp.shape)
        lpw = np.outer(eval_legendre(lrange, yg[i]),
                       eval_legendre(lrange, xg[i])).ravel()
        cube += wg[i] * np.tensordot(lpw, stamp, axes=0)
    lnorm = np.outer(lrange + 0.5, lrange + 0.5).ravel()
    return cube * lnorm[:, None, None]


def piff_to_legendre(psf_file, sca, stamp_size=128, oversamp=6,
                     legendre_order=5, normbox=None, device="cuda"):
    """Draw a Piff solution over the chip and fit the Legendre cube
    (reference piff_to_legendre, piffutils.py:98-213): the stamps at the
    (legendre_order+1)^2 quadrature points in one batched draw on `device`,
    the quadrature on the host in float64."""
    model = PiffPSFModel(psf_file, sca)
    xL, _ = roots_legendre(legendre_order + 1)
    xg, yg = (model.nside / 2.0 * (1 + a.ravel()) for a in np.meshgrid(xL, xL))
    stamps = draw_models([model] * len(xg), xg, yg, stamp_size=stamp_size,
                         oversamp=oversamp, normbox=normbox, device=device)
    drawn = {(x, y): s for x, y, s in zip(xg, yg, stamps)}
    return psf_stamps_to_legendre_cube(lambda x, y: drawn[(x, y)], legendre_order,
                                       nside=model.nside).astype(np.float32)


def piff_to_legendre_multi(psf_file, out_file, format="L2_2506", chips=None,
                           stamp_size=128, oversamp=6, legendre_order=5,
                           normbox=None, device="cuda"):
    """
    Convert a Piff file to a PyIMCOM Legendre-cube PSF input file
    (reference piff_to_legendre_multi, piffutils.py:230-320; L2_2506
    layout: primary header + one image HDU per SCA), drawing on `device`.
    """
    if format != "L2_2506":
        raise ValueError(f"piff_to_legendre_multi: Bad format: {format}")

    ns = stamp_size * oversamp
    xmin = (ns - oversamp) // 2
    placeholder = np.zeros(((legendre_order + 1) ** 2, ns, ns),
                           dtype=np.float32)
    placeholder[0, xmin:xmin + oversamp, xmin:xmin + oversamp] = \
        1.0 / oversamp ** 2

    nsca = np.shape(Stn.SCAFov)[0]
    chips = list(range(1, nsca + 1)) if chips is None else chips
    coefs = [placeholder] * nsca
    for i in chips:
        coefs[i - 1] = piff_to_legendre(
            psf_file, i, stamp_size=stamp_size, oversamp=oversamp,
            legendre_order=legendre_order, normbox=normbox, device=device)

    hdr = Header()
    hdr["CFORMAT"] = "Legendre basis"
    hdr["PORDER"] = legendre_order
    hdr["NCOEF"] = (legendre_order + 1) ** 2
    hdr["SRC"] = str(psf_file)
    hdr["NSCA"] = nsca
    hdr["OVSAMP"] = oversamp
    hdus = [ImageHDU(np.zeros((1,), dtype=np.float32), header=hdr)]
    for i in range(1, nsca + 1):
        h = ImageHDU(coefs[i - 1])
        h.header["SCA"] = i
        hdus.append(h)
    fits_write(out_file, HDUList(hdus))
