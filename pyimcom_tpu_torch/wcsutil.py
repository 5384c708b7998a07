"""
World coordinate systems (self-contained; no astropy).

The port's copy of ``pyimcom_tpu/wcsutil.py``, so that the port imports
nothing of the JAX package; keep the two in step.  The JAX form of the
output projection (``stg_projection_jax``) has the port's own form,
:func:`stg_projection_torch`, on float64 torch tensors.

Implements the FITS celestial WCS chain (Calabretta & Greisen 2002) for the
projections the coaddition pipeline uses:

* ``STG`` -- stereographic; the output mosaic projection
  (reference coadd.py:1699-1707 builds RA---STG / DEC--STG).
* ``TAN`` -- gnomonic; common for input SCA images.
* ``ARC`` -- zenithal equidistant; used by the synthetic test survey
  (reference tests/pyimcom/test_pyimcom.py:380-409).
* ``TAN-SIP`` -- gnomonic with SIP distortion polynomials (forward A/B, and
  inverse AP/BP or Newton iteration), for L2-like products
  (reference wcsutil.py:459-592 approximates GWCS this way).

All transforms are vectorized numpy on the host; :func:`stg_projection_torch`
gives a closed form of the output projection for device code.

Conventions: pixel coordinates are 0-indexed throughout the package
(`origin=0` in the astropy sense); angles in degrees.
"""

from __future__ import annotations

import numpy as np

DEG = np.pi / 180.0


# ---------------------------------------------------------------------------
# spherical rotations (native <-> celestial)
# ---------------------------------------------------------------------------

def _native_to_celestial(phi, colat, crval, lonpole):
    """
    Rotate native (phi, colatitude) to celestial (ra, dec); degrees in/out
    except colat in radians.  Uses atan2 forms throughout -- arcsin of a
    near-unit sine loses ~4 digits near the native pole, which matters at
    the sub-microarcsecond round-trip level the coadd geometry relies on.
    """
    ap, dp, pp = crval[0] * DEG, crval[1] * DEG, lonpole * DEG
    dphi = phi * DEG - pp
    st, ct = np.cos(colat), np.sin(colat)  # sin(theta), cos(theta) with theta=90deg-colat
    zc = st * np.sin(dp) + ct * np.cos(dp) * np.cos(dphi)
    xc = st * np.cos(dp) - ct * np.sin(dp) * np.cos(dphi)
    yc = -ct * np.sin(dphi)
    dec = np.arctan2(zc, np.hypot(xc, yc))
    ra = ap + np.arctan2(yc, xc)
    return (ra / DEG) % 360.0, dec / DEG


def _celestial_to_native(ra, dec, crval, lonpole):
    """Rotate celestial (ra, dec; degrees) to native (phi degrees, colat radians)."""
    ap, dp, pp = crval[0] * DEG, crval[1] * DEG, lonpole * DEG
    ra = np.asarray(ra, dtype=np.float64) * DEG
    dec = np.asarray(dec, dtype=np.float64) * DEG
    zn = np.sin(dec) * np.sin(dp) + np.cos(dec) * np.cos(dp) * np.cos(ra - ap)
    xn = np.sin(dec) * np.cos(dp) - np.cos(dec) * np.sin(dp) * np.cos(ra - ap)
    yn = -np.cos(dec) * np.sin(ra - ap)
    colat = np.arctan2(np.hypot(xn, yn), zn)  # = 90deg - theta, well-conditioned
    phi = pp + np.arctan2(yn, xn)
    return phi / DEG, colat


# ---------------------------------------------------------------------------
# zenithal projections (native <-> intermediate plane).  The radial variable
# is the colatitude in radians, avoiding 90deg-theta cancellation.
# ---------------------------------------------------------------------------

def _colat_to_R(colat, code):
    """Radius in intermediate-plane degrees from colatitude in radians."""
    if code == "TAN":
        return np.tan(colat) / DEG
    if code == "STG":
        return 2.0 * np.tan(colat / 2.0) / DEG
    if code == "ARC":
        return colat / DEG
    raise ValueError(f"unsupported projection {code}")


def _R_to_colat(R, code):
    """Colatitude in radians from intermediate-plane radius in degrees."""
    R = np.asarray(R, dtype=np.float64)
    if code == "TAN":
        return np.arctan(R * DEG)
    if code == "STG":
        return 2.0 * np.arctan(R * DEG / 2.0)
    if code == "ARC":
        return R * DEG
    raise ValueError(f"unsupported projection {code}")


def _plane_to_native(x, y, code):
    phi = np.arctan2(x, -y) / DEG
    R = np.hypot(x, y)
    return phi, _R_to_colat(R, code)


def _native_to_plane(phi, colat, code):
    R = _colat_to_R(colat, code)
    p = phi * DEG
    return R * np.sin(p), -R * np.cos(p)


# ---------------------------------------------------------------------------
# SIP polynomial helpers
# ---------------------------------------------------------------------------

def _sip_eval(coeffs: dict, u, v):
    """Evaluate a SIP polynomial sum_{p,q} c[p,q] u^p v^q."""
    out = np.zeros_like(np.asarray(u, dtype=np.float64))
    for (p, q), c in coeffs.items():
        out = out + c * u ** p * v ** q
    return out


class WCS:
    """
    Celestial WCS: linear CD matrix + zenithal projection + optional SIP.

    Parameters
    ----------
    ctype : (str, str), e.g. ("RA---STG", "DEC--STG")
    crval : (ra0, dec0) degrees
    crpix : (x0, y0) reference pixel, 0-indexed
    cd    : (2, 2) CD matrix in degrees/pixel
    lonpole : native longitude of the celestial pole, degrees
    sip_a, sip_b : forward SIP coefficient dicts {(p, q): coeff} (optional)
    sip_ap, sip_bp : inverse SIP coefficient dicts (optional)
    """

    def __init__(self, ctype=("RA---TAN", "DEC--TAN"), crval=(0.0, 0.0),
                 crpix=(0.0, 0.0), cd=None, lonpole=180.0,
                 sip_a=None, sip_b=None, sip_ap=None, sip_bp=None):
        self.ctype = tuple(ctype)
        self.code = self.ctype[0][-3:]
        if self.ctype[0].endswith("-SIP"):
            self.code = self.ctype[0][5:8]
        self.crval = np.asarray(crval, dtype=np.float64)
        self.crpix = np.asarray(crpix, dtype=np.float64)
        self.cd = np.asarray(cd, dtype=np.float64) if cd is not None else np.eye(2)
        self.cdinv = np.linalg.inv(self.cd)
        self.lonpole = float(lonpole)
        self.sip_a = sip_a or {}
        self.sip_b = sip_b or {}
        self.sip_ap = sip_ap or {}
        self.sip_bp = sip_bp or {}

    # ----- constructors -----------------------------------------------------

    @classmethod
    def from_header(cls, hdr) -> "WCS":
        """Build from FITS header keywords (CDj_i or CDELT, SIP A_p_q etc.)."""
        ctype = (str(hdr["CTYPE1"]).strip(), str(hdr["CTYPE2"]).strip())
        crval = (float(hdr["CRVAL1"]), float(hdr["CRVAL2"]))
        crpix = (float(hdr["CRPIX1"]) - 1.0, float(hdr["CRPIX2"]) - 1.0)
        if "CD1_1" in hdr:
            cd = np.array([[hdr.get("CD1_1", 0.0), hdr.get("CD1_2", 0.0)],
                           [hdr.get("CD2_1", 0.0), hdr.get("CD2_2", 0.0)]], dtype=np.float64)
        else:
            cd = np.diag([float(hdr.get("CDELT1", 1.0)), float(hdr.get("CDELT2", 1.0))])
            if "PC1_1" in hdr:
                pc = np.array([[hdr.get("PC1_1", 1.0), hdr.get("PC1_2", 0.0)],
                               [hdr.get("PC2_1", 0.0), hdr.get("PC2_2", 1.0)]], dtype=np.float64)
                cd = np.diag([float(hdr.get("CDELT1", 1.0)), float(hdr.get("CDELT2", 1.0))]) @ pc
        lonpole = float(hdr.get("LONPOLE", 180.0))

        def read_sip(prefix):
            order_key = f"{prefix}_ORDER"
            if order_key not in hdr:
                return {}
            coeffs = {}
            order = int(hdr[order_key])
            for p in range(order + 1):
                for q in range(order + 1 - p):
                    key = f"{prefix}_{p}_{q}"
                    if key in hdr:
                        coeffs[(p, q)] = float(hdr[key])
            return coeffs

        return cls(ctype=ctype, crval=crval, crpix=crpix, cd=cd, lonpole=lonpole,
                   sip_a=read_sip("A"), sip_b=read_sip("B"),
                   sip_ap=read_sip("AP"), sip_bp=read_sip("BP"))

    def to_header(self) -> dict:
        """FITS header cards (CRPIX 1-indexed per the FITS convention)."""
        cards = {
            "WCSAXES": 2,
            "CTYPE1": self.ctype[0], "CTYPE2": self.ctype[1],
            "CRVAL1": float(self.crval[0]), "CRVAL2": float(self.crval[1]),
            "CRPIX1": float(self.crpix[0]) + 1.0, "CRPIX2": float(self.crpix[1]) + 1.0,
            "CD1_1": float(self.cd[0, 0]), "CD1_2": float(self.cd[0, 1]),
            "CD2_1": float(self.cd[1, 0]), "CD2_2": float(self.cd[1, 1]),
            "LONPOLE": self.lonpole,
            "RADESYS": "ICRS",
        }
        for prefix, coeffs in [("A", self.sip_a), ("B", self.sip_b),
                               ("AP", self.sip_ap), ("BP", self.sip_bp)]:
            if coeffs:
                cards[f"{prefix}_ORDER"] = max(p + q for (p, q) in coeffs)
                for (p, q), c in coeffs.items():
                    cards[f"{prefix}_{p}_{q}"] = c
        return cards

    # ----- transforms -------------------------------------------------------

    def pix2world(self, x, y):
        """Pixel (0-indexed) -> (ra, dec) degrees."""
        u = np.asarray(x, dtype=np.float64) - self.crpix[0]
        v = np.asarray(y, dtype=np.float64) - self.crpix[1]
        if self.sip_a or self.sip_b:
            du = _sip_eval(self.sip_a, u, v)
            dv = _sip_eval(self.sip_b, u, v)
            u, v = u + du, v + dv
        xi = self.cd[0, 0] * u + self.cd[0, 1] * v
        eta = self.cd[1, 0] * u + self.cd[1, 1] * v
        phi, theta = _plane_to_native(xi, eta, self.code)
        return _native_to_celestial(phi, theta, self.crval, self.lonpole)

    def world2pix(self, ra, dec):
        """(ra, dec) degrees -> pixel (0-indexed)."""
        phi, theta = _celestial_to_native(ra, dec, self.crval, self.lonpole)
        xi, eta = _native_to_plane(phi, theta, self.code)
        u = self.cdinv[0, 0] * xi + self.cdinv[0, 1] * eta
        v = self.cdinv[1, 0] * xi + self.cdinv[1, 1] * eta
        if self.sip_a or self.sip_b:
            if self.sip_ap or self.sip_bp:
                u0 = u + _sip_eval(self.sip_ap, u, v)
                v0 = v + _sip_eval(self.sip_bp, u, v)
            else:
                u0, v0 = u, v
            # Newton refinement of u0 + A(u0,v0) = u
            for _ in range(6):
                fu = u0 + _sip_eval(self.sip_a, u0, v0) - u
                fv = v0 + _sip_eval(self.sip_b, u0, v0) - v
                eps = 1e-5
                j00 = (_sip_eval(self.sip_a, u0 + eps, v0) - _sip_eval(self.sip_a, u0 - eps, v0)) / (2 * eps) + 1
                j01 = (_sip_eval(self.sip_a, u0, v0 + eps) - _sip_eval(self.sip_a, u0, v0 - eps)) / (2 * eps)
                j10 = (_sip_eval(self.sip_b, u0 + eps, v0) - _sip_eval(self.sip_b, u0 - eps, v0)) / (2 * eps)
                j11 = (_sip_eval(self.sip_b, u0, v0 + eps) - _sip_eval(self.sip_b, u0, v0 - eps)) / (2 * eps) + 1
                det = j00 * j11 - j01 * j10
                u0 = u0 - (j11 * fu - j01 * fv) / det
                v0 = v0 - (-j10 * fu + j00 * fv) / det
            u, v = u0, v0
        return u + self.crpix[0], v + self.crpix[1]

    # astropy-compatible entry points (origin must be 0) ---------------------

    def all_pix2world(self, *args):
        """all_pix2world(xy, 0) or all_pix2world(x, y, 0); degrees."""
        if len(args) == 2:
            xy = np.atleast_2d(np.asarray(args[0], dtype=np.float64))
            ra, dec = self.pix2world(xy[:, 0], xy[:, 1])
            return np.stack([ra, dec], axis=-1)
        x, y, _origin = args
        return self.pix2world(x, y)

    def all_world2pix(self, *args):
        """all_world2pix(radec, 0) or all_world2pix(ra, dec, 0); degrees."""
        if len(args) == 2:
            radec = np.atleast_2d(np.asarray(args[0], dtype=np.float64))
            x, y = self.world2pix(radec[:, 0], radec[:, 1])
            return np.stack([x, y], axis=-1)
        ra, dec, _origin = args
        return self.world2pix(ra, dec)

    def pixel_to_world_values(self, x, y):
        return self.pix2world(x, y)

    def world_to_pixel_values(self, ra, dec):
        return self.world2pix(ra, dec)


# ---------------------------------------------------------------------------
# approximation of arbitrary pixel<->world maps by TAN-SIP
# ---------------------------------------------------------------------------

def fit_wcs_sip(pix2world_fn, nside: int, order: int = 3, ngrid: int = 24,
                ctr=None) -> "WCS":
    """
    Approximate an arbitrary pixel->world mapping with a TAN-SIP WCS fit by
    least squares over an ngrid x ngrid sample of the detector (the
    reference's GWCS -> 'ASTROPY+' approximation, wcsutil.py:459-592; the
    error-map refinement can be layered on the returned object by comparing
    against `pix2world_fn` where sub-milli-pixel accuracy is needed).

    pix2world_fn : callable (x, y) -> (ra, dec) in degrees, vectorized.
    nside : detector side length in pixels.
    order : SIP polynomial order.
    """
    half = (nside - 1) / 2.0
    if ctr is None:
        ctr = (half, half)
    g = np.linspace(0, nside - 1, ngrid)
    gx, gy = np.meshgrid(g, g)
    ra, dec = pix2world_fn(gx.ravel(), gy.ravel())
    ra0, dec0 = pix2world_fn(np.array([ctr[0]]), np.array([ctr[1]]))
    ra0, dec0 = float(np.atleast_1d(ra0)[0]), float(np.atleast_1d(dec0)[0])

    # project samples to the TAN plane about (ra0, dec0)
    base = WCS(ctype=("RA---TAN", "DEC--TAN"), crval=(ra0, dec0),
               crpix=ctr, cd=np.eye(2) * 1e-5, lonpole=180.0)
    phi, colat = _celestial_to_native(ra, dec, base.crval, base.lonpole)
    xi, eta = _native_to_plane(phi, colat, "TAN")  # degrees

    u = gx.ravel() - ctr[0]
    v = gy.ravel() - ctr[1]

    # linear CD fit first
    Alin = np.stack([u, v], axis=1)
    cd_row1, *_ = np.linalg.lstsq(Alin, xi, rcond=None)
    cd_row2, *_ = np.linalg.lstsq(Alin, eta, rcond=None)
    cd = np.array([cd_row1, cd_row2])
    cdinv = np.linalg.inv(cd)

    # SIP fit on the residuals in pixel units
    up = cdinv[0, 0] * xi + cdinv[0, 1] * eta
    vp = cdinv[1, 0] * xi + cdinv[1, 1] * eta
    terms = [(p, q) for p in range(order + 1) for q in range(order + 1 - p)
             if p + q >= 2]
    M = np.stack([u ** p * v ** q for (p, q) in terms], axis=1)
    ca, *_ = np.linalg.lstsq(M, up - u, rcond=None)
    cb, *_ = np.linalg.lstsq(M, vp - v, rcond=None)
    sip_a = {t: c for t, c in zip(terms, ca)}
    sip_b = {t: c for t, c in zip(terms, cb)}

    return WCS(ctype=("RA---TAN-SIP", "DEC--TAN-SIP"), crval=(ra0, dec0),
               crpix=ctr, cd=cd, lonpole=180.0, sip_a=sip_a, sip_b=sip_b)


class SIPCorrectedWCS:
    """
    TAN-SIP approximation of an arbitrary pixel->world mapping WITH the
    error-map refinement (the reference's 'ASTROPY+' mode,
    wcsutil.py:459-592): the residual between the true mapping and the SIP
    fit is tabulated on a pixel grid as (dx, dy) offsets

        xbar == x + errmap[0](y, x),  ybar == y + errmap[1](y, x)

    where (xbar, ybar) are the SIP-frame coordinates of the true (x, y).
    pix2world evaluates the SIP WCS at the shifted position; world2pix
    inverts by `niter` fixed-point iterations (reference default 3).  The
    error map is bilinearly interpolated and linearly extrapolated `n_pad`
    pixels beyond the chip using the slope over the outer `a` pixels
    (reference LocWCS.err_interp, wcsutil.py:380-430).

    Parameters
    ----------
    pix2world_fn : callable (x, y) -> (ra, dec) degrees, vectorized -- the
        exact mapping (e.g. a GWCS evaluation).
    nside : detector side length in pixels.
    order : SIP polynomial order (reference uses 2 for GWCS conversion).
    err_step : error-map sampling step in pixels (1 = the reference's
        full-resolution map; coarser trades memory for interpolation error
        on sub-err_step distortion scales).
    """

    def __init__(self, pix2world_fn, nside: int, order: int = 2,
                 ngrid: int = 100, err_step: int = 8, a: int = 8,
                 n_pad: int = None, niter: int = 3):
        self.nside = nside
        self.niter = niter
        self.approx = fit_wcs_sip(pix2world_fn, nside, order=order,
                                  ngrid=ngrid)

        if n_pad is None:
            n_pad = nside // 2
        coords = np.arange(0, nside, err_step, dtype=np.float64)
        if coords[-1] != nside - 1:
            coords = np.append(coords, nside - 1)
        ng = len(coords)
        gx, gy = np.meshgrid(coords, coords)
        ra, dec = pix2world_fn(gx.ravel(), gy.ravel())
        xbar, ybar = self.approx.world2pix(ra, dec)
        err = np.zeros((2, ng, ng))
        err[0] = xbar.reshape(ng, ng) - gx
        err[1] = ybar.reshape(ng, ng) - gy

        # pad with linear extrapolation n_pad pixels beyond each edge
        ia = min(a // err_step + 1, ng - 1)
        co = np.concatenate([[coords[0] - n_pad], coords,
                             [coords[-1] + n_pad]])
        d = np.pad(err, ((0, 0), (1, 1), (1, 1)))
        grad = n_pad / (coords[ia] - coords[0])
        d[:, :, 0] = d[:, :, 1] + grad * (d[:, :, 1] - d[:, :, 1 + ia])
        d[:, :, -1] = d[:, :, -2] + grad * (d[:, :, -2] - d[:, :, -2 - ia])
        d[:, 0, :] = d[:, 1, :] + grad * (d[:, 1, :] - d[:, 1 + ia, :])
        d[:, -1, :] = d[:, -2, :] + grad * (d[:, -2, :] - d[:, -2 - ia, :])
        self._err_coords = co
        self._err = d

    def _err_eval(self, x, y):
        """Bilinear (dx, dy) at positions (x, y), linearly extrapolated."""
        co = self._err_coords
        ix = np.clip(np.searchsorted(co, x) - 1, 0, len(co) - 2)
        iy = np.clip(np.searchsorted(co, y) - 1, 0, len(co) - 2)
        fx = (x - co[ix]) / (co[ix + 1] - co[ix])
        fy = (y - co[iy]) / (co[iy + 1] - co[iy])
        d = self._err
        out = []
        for k in range(2):
            v00 = d[k][iy, ix]
            v10 = d[k][iy, ix + 1]
            v01 = d[k][iy + 1, ix]
            v11 = d[k][iy + 1, ix + 1]
            out.append((1 - fy) * ((1 - fx) * v00 + fx * v10)
                       + fy * ((1 - fx) * v01 + fx * v11))
        return out[0], out[1]

    def pix2world(self, x, y):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        dx, dy = self._err_eval(x, y)
        return self.approx.pix2world(x + dx, y + dy)

    def world2pix(self, ra, dec):
        xb, yb = self.approx.world2pix(ra, dec)
        x, y = np.array(xb, dtype=np.float64), np.array(yb, dtype=np.float64)
        for _ in range(self.niter):
            dx, dy = self._err_eval(x, y)
            x = xb - dx
            y = yb - dy
        return x, y

    # astropy-compatible entry points (origin must be 0) ---------------------

    all_pix2world = WCS.all_pix2world
    all_world2pix = WCS.all_world2pix
    pixel_to_world_values = pix2world
    world_to_pixel_values = world2pix


class PyIMCOM_WCS(WCS):
    """
    Reference-API-compatible wrapper name (reference wcsutil.py:419): accepts
    a FITS header dict, an existing WCS, or any object/callable providing
    the exact pixel->world mapping -- the latter is converted to the
    error-map-corrected TAN-SIP approximation ('ASTROPY+' mode).
    """

    def __new__(cls, source, nside: int = None, **kwargs):
        if isinstance(source, WCS) or isinstance(source, dict) \
                or hasattr(source, "get"):
            return super().__new__(cls)
        # GWCS-like object or bare callable -> corrected approximation
        if hasattr(source, "pix2world"):
            fn = source.pix2world
        elif callable(source):
            fn = source
        else:
            raise TypeError("PyIMCOM_WCS accepts a header, WCS, GWCS-like "
                            "object, or pixel->world callable")
        from .config import Settings as Stn

        return SIPCorrectedWCS(fn, nside or Stn.sca_nside, **kwargs)

    def __init__(self, source, nside: int = None, **kwargs):
        if isinstance(source, WCS):
            self.__dict__.update(source.__dict__)
        elif isinstance(source, dict) or hasattr(source, "get"):
            w = WCS.from_header(source)
            self.__dict__.update(w.__dict__)
        # else: __new__ returned a SIPCorrectedWCS; __init__ not called


# ---------------------------------------------------------------------------
# derivatives and pixel areas
# ---------------------------------------------------------------------------

def local_partial_pixel_derivatives2(wcs: WCS, x: float, y: float, dx: float = 1.0):
    """
    Pole-safe two-sided Jacobian d(world)/d(pixel) at (x, y): the RA row is
    scaled by cos(dec) so both rows are in proper angular degrees/pixel
    (cf. reference wcsutil.py:637-686).
    """
    ras, decs = wcs.pix2world(np.array([x + dx, x - dx, x, x]),
                              np.array([y, y, y + dx, y - dx]))
    dec0 = np.mean(decs)
    cosd = np.cos(dec0 * DEG)
    dra = (np.unwrap(ras * DEG) / DEG)
    jac = np.empty((2, 2))
    jac[0, 0] = (dra[0] - dra[1]) / (2 * dx) * cosd
    jac[0, 1] = (dra[2] - dra[3]) / (2 * dx) * cosd
    jac[1, 0] = (decs[0] - decs[1]) / (2 * dx)
    jac[1, 1] = (decs[2] - decs[3]) / (2 * dx)
    return jac


def get_pix_area(wcs: WCS, x, y, dx: float = 0.5):
    """
    Solid angle of pixels at positions (x, y) in steradians, from the local
    Jacobian determinant (cf. reference wcsutil.py:688-737).
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    ra_px, dec_px = wcs.pix2world(x + dx, y)
    ra_mx, dec_mx = wcs.pix2world(x - dx, y)
    ra_py, dec_py = wcs.pix2world(x, y + dx)
    ra_my, dec_my = wcs.pix2world(x, y - dx)
    dec0 = (dec_px + dec_mx + dec_py + dec_my) / 4.0
    cosd = np.cos(dec0 * DEG)

    def wrap(d):
        return (d + 180.0) % 360.0 - 180.0

    j00 = wrap(ra_px - ra_mx) / (2 * dx) * cosd
    j01 = wrap(ra_py - ra_my) / (2 * dx) * cosd
    j10 = (dec_px - dec_mx) / (2 * dx)
    j11 = (dec_py - dec_my) / (2 * dx)
    return np.abs(j00 * j11 - j01 * j10) * DEG ** 2


# ---------------------------------------------------------------------------
# output projection helpers
# ---------------------------------------------------------------------------

def make_block_wcs(cfg, ibx: int, iby: int) -> WCS:
    """
    Output WCS for mosaic block (ibx, iby): stereographic projection about
    the mosaic center, CRPIX placed so all blocks share one projection
    (cf. reference coadd.py:1699-1707).
    """
    crpix1 = (cfg.NsideP + 1) / 2.0 - cfg.Nside * (ibx - (cfg.nblock - 1) / 2.0)
    crpix2 = (cfg.NsideP + 1) / 2.0 - cfg.Nside * (iby - (cfg.nblock - 1) / 2.0)
    return WCS(ctype=("RA---STG", "DEC--STG"),
               crval=(cfg.ra, cfg.dec),
               crpix=(crpix1 - 1.0, crpix2 - 1.0),  # internal 0-indexed
               cd=np.diag([-cfg.dtheta, cfg.dtheta]),
               lonpole=cfg.lonpole)


def stg_projection_torch(crval, crpix, cdelt, lonpole):
    """
    Closed-form stereographic pixel<->world maps for device code, the JAX
    package's ``stg_projection_jax`` term for term on torch tensors.

    Returns (pix2world, world2pix), both mapping float64 tensors (any shape)
    in degrees, computed on the device of the tensors they are given.
    """
    import math

    import torch

    ap, dp, pp = crval[0] * DEG, crval[1] * DEG, lonpole * DEG

    def pix2world(x, y):
        xi = cdelt[0] * (x - crpix[0]) * DEG
        eta = cdelt[1] * (y - crpix[1]) * DEG
        R = torch.hypot(xi, eta)
        dphi = torch.atan2(xi, -eta) - pp
        colat = 2.0 * torch.atan(R / 2.0)
        st, ct = torch.cos(colat), torch.sin(colat)
        zc = st * math.sin(dp) + ct * math.cos(dp) * torch.cos(dphi)
        xc = st * math.cos(dp) - ct * math.sin(dp) * torch.cos(dphi)
        yc = -ct * torch.sin(dphi)
        dec = torch.atan2(zc, torch.hypot(xc, yc))
        ra = ap + torch.atan2(yc, xc)
        return torch.remainder(ra / DEG, 360.0), dec / DEG

    def world2pix(ra, dec):
        ra = ra * DEG
        dec = dec * DEG
        zn = (torch.sin(dec) * math.sin(dp)
              + torch.cos(dec) * math.cos(dp) * torch.cos(ra - ap))
        xn = (torch.sin(dec) * math.cos(dp)
              - torch.cos(dec) * math.sin(dp) * torch.cos(ra - ap))
        yn = -torch.cos(dec) * torch.sin(ra - ap)
        colat = torch.atan2(torch.hypot(xn, yn), zn)
        phi = pp + torch.atan2(yn, xn)
        R = 2.0 * torch.tan(colat / 2.0)
        xi = R * torch.sin(phi)
        eta = -R * torch.cos(phi)
        return xi / DEG / cdelt[0] + crpix[0], eta / DEG / cdelt[1] + crpix[1]

    return pix2world, world2pix
