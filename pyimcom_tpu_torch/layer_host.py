"""
Host helpers of the input layers: file names and science frames, seeds and
1/f noise frames, the star grid, the analytic galaxy profiles, masks and the
cached cube's SCIWCS header.

The port's copy of the jax-free helpers of ``pyimcom_tpu/layer.py``, so
that the port imports nothing of the JAX package; keep the two in step.
The injectors and the layer dispatch that use them are in :mod:`.layer`.
"""

from __future__ import annotations

import functools
from os.path import exists

import numpy as np

from .config import Settings as Stn
from .fitsio import ImageHDU, fits_read


# ---------------------------------------------------------------------------
# input file name broker
# ---------------------------------------------------------------------------

def get_sca_imagefile(path, idsca, obsdata, format_, extraargs=None):
    """
    Input file name for an (obsid, SCA) pair.

    Formats: 'L2_fits' (this framework's native FITS L2 layout),
    'L2_2506' (reference ASDF layout -- name resolution only),
    'anlsim', 'dc2_imsim' (reference FITS layouts; layer.py:1128-1171).
    """
    scastr = f"{idsca[1]:d}" if idsca[1] != -1 else "{:d}"
    filter_ = obsdata if isinstance(obsdata, str) else Stn.RomanFilters[obsdata["filter"][idsca[0]]]
    typ = (extraargs or {}).get("type")

    if format_ in ("L2_fits", "L2_2506"):
        ext = "fits" if format_ == "L2_fits" else "asdf"
        out = f"{path}/sim_L2_{filter_:s}_{idsca[0]:d}_{scastr:s}.{ext}"
        if typ == "mask":
            out = f"{path}/sim_L2_{filter_:s}_{idsca[0]:d}_{scastr:s}_mask.fits" \
                if format_ == "L2_fits" else out
        elif typ == "labnoise":
            out = f"{path}/labnoise/slope_{idsca[0]:d}_{scastr:s}.fits"
        elif typ == "truth":
            out = f"{path}/truth/Roman_WAS_truth_{filter_:s}_{idsca[0]:d}_{scastr:s}.fits"
        elif typ == "noise":
            out = f"{path}/sim_L2_{filter_:s}_{idsca[0]:d}_{scastr:s}_noise.{ext}"
        return out

    if format_ == "anlsim":
        out = f"{path}/simple/Roman_WAS_simple_model_{filter_:s}_{idsca[0]:d}_{scastr:s}.fits"
        if typ == "labnoise":
            out = f"{path}/labnoise/slope_{idsca[0]:d}_{scastr:s}.fits"
        return out

    if format_ == "dc2_imsim":
        out = f"{path}/simple/dc2_{filter_:s}_{idsca[0]:d}_{scastr:s}.fits"
        if typ == "truth":
            out = f"{path}/truth/dc2_{filter_:s}_{idsca[0]:d}_{scastr:s}.fits"
        elif typ == "labnoise":
            out = f"{path}/labnoise/slope_{idsca[0]:d}_{scastr:s}.fits"
        return out

    return None


def check_if_idsca_exists(cfg, obsdata, idsca):
    """Return (exists, filename) for an observation/SCA pair."""
    fname = get_sca_imagefile(cfg.inpath, idsca, obsdata, cfg.informat)
    return (fname is not None and exists(fname)), fname


def read_sci_frame(filename, format_):
    """Science layer from an input file (sky-subtracted where applicable)."""
    if format_ in ("dc2_imsim", "anlsim"):
        hdus = fits_read(filename)
        sci = hdus["SCI"]
        return np.asarray(sci.data, dtype=np.float32) - float(sci.header["SKY_MEAN"])
    if format_ == "L2_fits":
        hdus = fits_read(filename)
        return np.asarray(hdus[0].data, dtype=np.float32)
    if format_ == "L2_2506":
        # Roman L2 ASDF layout (reference layer.py:1256-1264): the science
        # array lives at roman/data, already in electrons
        from .asdfio import asdf_read

        tree = asdf_read(filename)
        return np.asarray(tree["roman"]["data"], dtype=np.float32)
    raise ValueError(f"unknown input format {format_!r}")


# ---------------------------------------------------------------------------
# synthetic noise layers
# ---------------------------------------------------------------------------

def layer_seed(q: int, idsca) -> int:
    """Deterministic RNG seed (matches reference layer.py:1301)."""
    return 1000000 * (18 * q + idsca[1]) + idsca[0]


def noise_1f_frame(seed: int) -> np.ndarray:
    """
    1/f read-noise frame, independent per output channel, serpentine channel
    read order (reference CplxNoise.noise_1f_frame, layer.py:870-913).
    """
    this_array = np.zeros((4096, 4096), dtype=np.float32)
    rng = np.random.default_rng(seed)
    len_ = 8192 * 128

    freq = np.linspace(0, 1 - 1.0 / len_, len_)
    freq[len_ // 2:] -= 1.0
    amp = (1.0e-99 + np.abs(freq * len_)) ** (-0.5)
    amp[0] = 0.0
    for ch in range(32):
        ftsignal = rng.normal(size=(len_,)) + 1j * rng.normal(size=(len_,))
        ftsignal *= amp
        block = np.fft.fft(ftsignal).real[: len_ // 2] / np.sqrt(2.0)
        block -= np.mean(block)
        xmin = ch * 128
        cols = block.reshape((4096, 128))
        this_array[:, xmin:xmin + 128] = cols if ch % 2 == 0 else cols[:, ::-1]
    return this_array[4:4092, 4:4092]


# ---------------------------------------------------------------------------
# injection grid
# ---------------------------------------------------------------------------

def generate_star_grid(res, mywcs, scapar=None):
    """
    HEALPix injection grid covering one SCA (reference layer.py:742-789).

    Returns (ipix, x, y, ra_deg, dec_deg).
    """
    from .sphere import healpix_patch

    scapar = scapar or {"nside": Stn.sca_nside, "pix_arcsec": 0.11}
    degree = np.pi / 180.0
    sidelength = scapar["nside"] * scapar["pix_arcsec"] / 3600 * degree
    radius = sidelength

    cpos = (scapar["nside"] - 1) / 2
    cw = mywcs.all_pix2world(np.array([[cpos, cpos]]), 0)[0]
    grid = healpix_patch(res, cw[0] * degree, cw[1] * degree, radius)
    px, py = mywcs.all_world2pix(grid["rapix"] / degree, grid["decpix"] / degree, 0)
    return grid["ipix"], px, py, grid["rapix"] / degree, grid["decpix"] / degree


# ---------------------------------------------------------------------------
# extended-object (galaxy) injection
# ---------------------------------------------------------------------------

def _shear_matrix(e1, e2):
    """Distortion-convention shear matrix [[1+e1, e2], [e2, 1-e1]]/sqrt(1-e^2)."""
    e2n = e1 * e1 + e2 * e2
    if e2n >= 1.0:
        raise ValueError("shear magnitude must be < 1")
    return np.array([[1 + e1, e2], [e2, 1 - e1]]) / np.sqrt(1.0 - e2n)


def _shear_expm(s1, s2):
    """Area-preserving shear exp([[s1, s2], [s2, -s1]])."""
    from scipy.linalg import expm

    return expm(np.array([[s1, s2], [s2, -s1]]))


def galaxy_ft(u, v, profile_n: float, hlr_arcsec: float, M_sky: np.ndarray,
              A_samp2sky: np.ndarray):
    """
    Fourier transform (on the sample grid) of a unit-flux galaxy whose
    profile is defined and sheared in *sky* coordinates, so all exposures
    inject a consistently oriented object regardless of roll angle.

    profile_n : Sersic index; 0.5 (Gaussian) and 1.0 (exponential) have
        closed forms -- the cases the reference test suite exercises.
    hlr_arcsec : half-light radius on the sky.
    M_sky : 2x2 shape/shear transformation in sky coordinates.
    A_samp2sky : 2x2 matrix mapping sample offsets to sky arcsec (the local
        WCS Jacobian per oversampled pixel).

    u, v : frequencies in cycles/sample.  The sheared profile's FT is the
    circular FT evaluated at M^T A^{-T} k.
    """
    kx = 2 * np.pi * u
    ky = 2 * np.pi * v
    AinvT = np.linalg.inv(A_samp2sky).T
    kxs = AinvT[0, 0] * kx + AinvT[0, 1] * ky  # cycles*2pi / arcsec
    kys = AinvT[1, 0] * kx + AinvT[1, 1] * ky
    kxp = M_sky[0, 0] * kxs + M_sky[1, 0] * kys
    kyp = M_sky[0, 1] * kxs + M_sky[1, 1] * kys
    k2 = kxp ** 2 + kyp ** 2
    if abs(profile_n - 0.5) < 1e-12:
        sigma = hlr_arcsec / np.sqrt(2 * np.log(2))
        return np.exp(-0.5 * k2 * sigma ** 2)
    if abs(profile_n - 1.0) < 1e-12:
        r0 = hlr_arcsec / 1.678346990
        return (1.0 + k2 * r0 ** 2) ** -1.5
    # general Sersic index: radially symmetric profile -> Hankel-transform
    # table (unit flux, Re = 1), evaluated at k*Re
    kq = np.sqrt(k2) * hlr_arcsec
    ktab, Ftab = _sersic_ft_table(round(float(profile_n), 4))
    return np.interp(np.clip(kq, 0, ktab[-1]), ktab, Ftab)


@functools.lru_cache(maxsize=16)
def _sersic_ft_table(n: float, kmax: float = 400.0, nk: int = 4096):
    """
    Hankel transform F(k) = 2 pi int I(r) J0(k r) r dr of a unit-flux
    Sersic-n profile with half-light radius Re = 1, tabulated on
    k in [0, kmax] (k in radians per Re).  The reference delegates general
    n to GalSim's Sersic class; this is the GalSim-free equivalent for the
    gsext injection layers.
    """
    from scipy.special import gammaincinv, j0

    b = float(gammaincinv(2 * n, 0.5))
    # log-spaced radial grid covering the extended Sersic wings
    r = np.geomspace(1e-5, 60.0 * max(1.0, n), 6000)
    prof = np.exp(-b * (r ** (1.0 / n)))
    w = prof * r
    k = np.linspace(0.0, kmax, nk)
    # trapezoid weights on the log grid
    dr = np.empty_like(r)
    dr[1:-1] = 0.5 * (r[2:] - r[:-2])
    dr[0] = 0.5 * (r[1] - r[0])
    dr[-1] = 0.5 * (r[-1] - r[-2])
    base = w * dr
    F = np.array([np.sum(base * j0(kk * r)) for kk in k])
    return k, F / F[0]


def parse_gsext_args(arglist):
    """Parse 'gsext' morphology arguments: n=, hlr=, shape=a:b, shear=a:b,
    rot=deg, seed=int (reference GalSimInject argument conventions)."""
    out = {"n": 0.5, "hlr": 0.1, "shape": (0.0, 0.0), "shear": None,
           "rot": None, "seed": None}
    for a in arglist:
        if "=" not in a:
            continue
        k, v = a.split("=", 1)
        k = k.strip().lower()
        if k in ("n", "hlr", "rot"):
            out[k] = float(v)
        elif k == "seed":
            out["seed"] = int(v)
        elif k in ("shape", "g"):
            p = v.split(":")
            out["shape"] = (float(p[0]), float(p[1]))
        elif k == "shear":
            p = v.split(":")
            out["shear"] = (float(p[0]), float(p[1]))
    return out


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------

class Mask:
    """Permanent / cosmic-ray / file masks (reference layer.py:916-1082)."""

    @staticmethod
    def randmask(idsca, pcut, hitinfo=None):
        """Pseudorandom cosmic-ray mask: True = good pixel."""
        from scipy.signal import convolve

        seed = 100000000 + idsca[0]
        rng = np.random.default_rng(seed)
        pad = 10
        g = rng.uniform(size=(18, 2 * pad + Stn.sca_nside, 2 * pad + Stn.sca_nside))[idsca[1] - 1]
        crhits = np.where(g < pcut, 1.0, 0.0)
        if hitinfo is None:
            sm = convolve(crhits, np.ones((3, 3)), mode="same")[pad:-pad, pad:-pad]
            return sm < 0.5

    @staticmethod
    def load_permanent_mask(block):
        """Permanent mask from the config PMASK file; True = usable pixel."""
        if block.cfg.permanent_mask is None:
            print("No permanent mask")
            return None
        hdus = fits_read(block.cfg.permanent_mask)
        data = hdus[0].data
        if hdus[0].header.get("GOODVAL") == 0:
            pm = data == 0
        else:
            pm = data != 0
        print("Permanent mask loaded -->", np.count_nonzero(pm), "good pixels")
        return pm

    @staticmethod
    def load_mask_from_maskfile(cfg, obsdata, idsca):
        """Per-exposure mask file; True = good pixel."""
        without_maskfiles = ["dc2_sim", "anlsim"]
        if cfg.informat in without_maskfiles:
            return np.ones((Stn.sca_nside, Stn.sca_nside), dtype=bool)
        filename = get_sca_imagefile(cfg.inpath, idsca, obsdata, cfg.informat,
                                     extraargs={"type": "mask"})
        if filename is not None and filename.endswith(".fits") and exists(filename):
            hdus = fits_read(filename)
            try:
                return hdus["MASK"].data == 0
            except KeyError:
                return hdus[0].data == 0
        return np.ones((Stn.sca_nside, Stn.sca_nside), dtype=bool)

    @staticmethod
    def load_cr_mask(inimage):
        """Cosmic-ray mask for an exposure (True = good), or None."""
        config = inimage.blk.cfg
        if config.cr_mask_rate > 0:
            cr_mask = Mask.randmask(inimage.idsca, config.cr_mask_rate)
            try:
                idx = config.extrainput.index("labnoise")
            except ValueError:
                pass
            else:
                cr_mask = np.logical_and(
                    cr_mask, np.abs(inimage.indata[idx]) < config.labnoisethreshold)
            return cr_mask
        return None


def _sciwcs_hdu(inimage, src_file):
    """
    SCIWCS HDU recording the science WCS of a cached layer cube, so
    downstream stages (wing subtraction) can map pixels without the
    original exposure (reference layer.py:1500-1529).  FITS-style WCS
    objects serialize their header cards (WCSTYPE='FITS'); GWCS records
    the source ASDF path (WCSTYPE='GWCS', WCSSRC) for re-reading, in
    place of the reference's ancillary ``*_wcs.asdf`` copy.
    """
    from .fitsio import Header

    inwcs = getattr(inimage, "inwcs", None)
    if inwcs is None:
        return None
    if hasattr(inwcs, "to_header"):
        hdu = ImageHDU(np.zeros((1, 1), dtype=np.uint8),
                       header=Header(inwcs.to_header()), name="SCIWCS")
        hdu.header["WCSTYPE"] = "FITS"
        return hdu
    src = getattr(inimage, "infile", None) or src_file
    if not src:
        return None
    hdu = ImageHDU(np.zeros((1, 1), dtype=np.uint8), name="SCIWCS")
    hdu.header["WCSTYPE"] = "GWCS"
    hdu.header["WCSSRC"] = str(src)
    return hdu
