"""
Configuration and instrument settings.

The port's copy of ``pyimcom_tpu/config.py``, so that the port imports
nothing of the JAX package; keep the two in step.

JSON keyword schema is compatible with the reference PyIMCOM configuration
files (reference: src/pyimcom/config.py:381-599), so existing survey configs
can be used unchanged.  The implementation here is a declarative schema table
rather than hand-written per-key parsing.

Classes
-------
Timer      : wall-clock timer.
Settings   : Roman WFI instrument constants (JWST NIRCam switchable).
fpaCoords  : focal-plane-assembly coordinate helpers.
Config     : configuration object with JSON round-trip.
"""

from __future__ import annotations

import json
import os
from time import perf_counter

import numpy as np

ARCSEC = np.pi / 180.0 / 3600.0
DEGREE = np.pi / 180.0

JWST = os.environ.get("INSTRUMENT", "WFI") == "NIRCAM"


class Timer:
    """Wall-clock timer; calling the instance returns elapsed seconds."""

    def __init__(self) -> None:
        self.tstart = perf_counter()

    def __call__(self, reset: bool = False) -> float:
        tnow = perf_counter()
        dt = tnow - self.tstart
        if reset:
            self.tstart = tnow
        return dt


class Settings:
    """Instrument constants for the Roman WFI (cf. reference config.py:74-177)."""

    hdu_with_wcs = "SCI"

    degree = DEGREE
    arcmin = DEGREE / 60.0
    arcsec = ARCSEC

    RomanFilters = ["W146", "F184", "H158", "J129", "Y106", "Z087", "R062", "PRSM", "DARK", "GRSM", "K213"]
    QFilterNative = [1.155, 1.456, 1.250, 1.021, 0.834, 0.689, 0.491, 1.009, 0.000, 1.159, 1.685]

    # linear obscuration of the telescope
    obsc = 0.31

    # SCA parameters
    pixscale_native = 0.11 * ARCSEC
    sca_nside = 4088  # active pixels per side
    sca_ctrpix = (sca_nside - 1) / 2
    sca_sidelength = sca_nside * pixscale_native

    # SCA field-of-view centers in 'WFI local' field angles (degrees);
    # SCAFov[i] = (X, Y) of SCA #(i+1).
    SCAFov = np.array(
        [
            [-0.071, -0.037], [-0.071, 0.109], [-0.070, 0.240],
            [-0.206, -0.064], [-0.206, 0.083], [-0.206, 0.213],
            [-0.341, -0.129], [-0.341, 0.018], [-0.342, 0.147],
            [0.071, -0.037], [0.071, 0.109], [0.070, 0.240],
            [0.206, -0.064], [0.206, 0.083], [0.206, 0.213],
            [0.341, -0.129], [0.341, 0.018], [0.342, 0.147],
        ]
    )

    @classmethod
    def jwst(cls):
        """Switch the class constants to JWST NIRCam values."""
        cls.sca_nside = 2048
        short = ["F070W", "F090W", "F115W", "F140M", "F150W", "F150W2", "F162M", "F164N",
                 "F182M", "F187N", "F200W", "F210M", "F212N"]
        long = ["F250M", "F277W", "F300M", "F322W2", "F323N", "F335M", "F356W", "F360M",
                "F405N", "F410M", "F430M", "F444W", "F460M", "F466N", "F470N", "F480M"]
        cls.RomanFilters = short + long
        cls.pixscale_short_native = 0.031 * ARCSEC
        cls.pixscale_long_native = 0.062 * ARCSEC


if JWST:  # pragma: no cover
    Settings.jwst()


class fpaCoords:
    """Focal plane coordinate data for the Roman WFI (cf. reference config.py:180-261)."""

    xfpa = np.array([-22.14, -22.29, -22.44, -66.42, -66.92, -67.42, -110.70, -111.48, -112.64,
                     22.14, 22.29, 22.44, 66.42, 66.92, 67.42, 110.70, 111.48, 112.64])
    yfpa = np.array([12.15, -37.03, -82.06, 20.90, -28.28, -73.06, 42.20, -6.98, -51.06,
                     12.15, -37.03, -82.06, 20.90, -28.28, -73.06, 42.20, -6.98, -51.06])
    Rfpa = 151.07129575137697
    sca_orient = np.array([-1, -1, 1] * 6, dtype=np.int16)
    pixsize = 0.01  # mm
    nside = 4088

    @classmethod
    def pix2fpa(cls, sca, x, y):
        """Convert pixel (x, y) on SCA `sca` (1..18) to focal plane coords in mm."""
        if np.amin(sca) < 1 or np.amax(sca) > 18:
            raise ValueError(f"Invalid SCA in fpaCoords.pix2fpa, range={np.amin(sca):d},{np.amax(sca):d}")
        orient = cls.sca_orient[np.asarray(sca) - 1]
        return (
            cls.xfpa[np.asarray(sca) - 1] + cls.pixsize * (x - (cls.nside - 1) / 2.0) * orient,
            cls.yfpa[np.asarray(sca) - 1] + cls.pixsize * (y - (cls.nside - 1) / 2.0) * orient,
        )


# Declarative schema: attribute -> (JSON key, default, required)
# A default of _REQ means the key must be present.
_REQ = object()

_DEFAULT_CONFIG = {
    # SECTION I: input files
    "OBSFILE": _REQ,
    "INDATA": _REQ,          # [path, format]
    "FILTER": _REQ,          # int filter index
    "INPSF": _REQ,           # [path, format, oversamp]
    "INPSFDRAW": (None, None, None),
    "PSFSPLIT": "",
    "PORDER_IMSUBTRACT": -1,
    # SECTION II: masks and layers
    "PMASK": None,
    "CMASK": 0.0,
    "EXTRAINPUT": [],
    "LABNOISETHRESHOLD": 3.0,
    # SECTION III: area to coadd
    "CTR": _REQ,             # [ra, dec] degrees
    "LONPOLE": 180.0,
    "BLOCK": _REQ,           # nblock
    "OUTSIZE": _REQ,         # [n1, n2, dtheta_arcsec]
    # SECTION IV: postage stamps
    "FADE": 3,
    "PAD": 0,
    "PADSIDES": "auto",
    "STOP": 0,
    # SECTION V: outputs
    "OUTMAPS": "USKTN",
    "OUT": _REQ,
    "TEMPFILE": "",
    "INLAYERCACHE": "",
    # SECTION VI: target output PSF(s)
    "NOUT": 1,
    "OUTPSF": "AIRYOBSC",
    "EXTRASMOOTH": 1.5 / 2.355,
    # SECTION VII: building linear systems
    "NPIXPSF": 48,
    "PSFCIRC": False,
    "PSFNORM": False,
    "AMPPEN": (0.0, 0.0),
    "FLATPEN": 0.0,
    "PSFINTERP": "D5512",
    "INPAD": 1.055,
    # SECTION VIII: solving linear systems
    "LAKERNEL": "Cholesky",
    "ITERRTOL": 1.5e-3,
    "ITERMAX": 30,
    "EMPIRNQC": False,
    "KAPPAC": [1e-5, 1e-4, 1e-3],
    "SOLVERPREC": "auto",
    "UCMIN": 1e-6,
    "SMAX": 0.5,
    # SECTION IX: destriping
    "DSMODEL": [None, None],
    "DSOUT": [None, None],
    "CGMODEL": [None, None, None],
    "DSCOST": [None, None, None],
    "DSOBSFILE": None,
    "DSNOISEFILE": False,
    "DSRESTART": None,
    "GAINDIR": False,
    "AMPCOLS": [None, 0.0],
    # SECTION X: pass-throughs
    "TILESCHM": "Not_specified",
    "RERUN": "Not_specified",
    "MOSAIC": -1,
}


class Config:
    """
    Coaddition configuration with JSON file interface.

    Parameters
    ----------
    cfg_file : str or dict or None
        Path to a JSON file, the JSON text itself, or a dict.  None builds an
        empty config (caller must fill required attributes and call the
        instance to compute derived quantities).
    inmode : str or None
        'block' reads the configuration back from a coadded block FITS file
        (CONFIG HDU), matching reference config.py:383-391.
    """

    def __init__(self, cfg_file=None, inmode=None) -> None:
        if inmode == "block":
            from .fitsio import fits_read
            hdus = fits_read(cfg_file)
            for h in hdus:
                if h.header.get("EXTNAME") == "CONFIG":
                    text = "\n".join(str(r) for r in h.data["text"])
                    self._from_dict(json.loads(text))
                    self()
                    return
            raise ValueError("no CONFIG HDU found in " + str(cfg_file))

        self.cfg_file = cfg_file
        if cfg_file is None:
            cfg_dict = {}
        elif isinstance(cfg_file, dict):
            cfg_dict = dict(cfg_file)
        else:
            try:
                with open(cfg_file) as f:
                    cfg_dict = json.load(f)
            except (OSError, FileNotFoundError):
                cfg_dict = json.loads(cfg_file)
        if cfg_dict:
            self._from_dict(cfg_dict)
            self()

    # ----- schema-driven parsing -------------------------------------------

    def _from_dict(self, cfg_dict: dict) -> None:
        raw = {}
        for key, default in _DEFAULT_CONFIG.items():
            if default is _REQ:
                if key not in cfg_dict:
                    raise KeyError(f"Config: required key {key} missing")
                raw[key] = cfg_dict[key]
            else:
                raw[key] = cfg_dict.get(key, default)
        self._raw = dict(cfg_dict)  # keep originals for round-trip

        # unpack into attributes (names match the reference public API)
        self.obsfile = raw["OBSFILE"]
        self.inpath, self.informat = raw["INDATA"]
        self.use_filter = raw["FILTER"]
        self.inpsf_path, self.inpsf_format, self.inpsf_oversamp = raw["INPSF"]
        self.inpsfdraw_path, self.inpsfdraw_format, self.inpsfdraw_oversamp = raw["INPSFDRAW"]
        self.psfsplit = raw["PSFSPLIT"]
        self.porder_imsubtract = raw["PORDER_IMSUBTRACT"]

        self.permanent_mask = raw["PMASK"]
        self.cr_mask_rate = raw["CMASK"]
        self.extrainput = [None] + list(raw["EXTRAINPUT"])
        self.labnoisethreshold = raw["LABNOISETHRESHOLD"]

        self.ra, self.dec = raw["CTR"]
        self.lonpole = float(raw["LONPOLE"])
        self.nblock = raw["BLOCK"]
        self.n1, self.n2, self.dtheta = raw["OUTSIZE"]
        if self.n1 % 2 != 0:
            raise ValueError("n1 must be even: PSF computations are in 2x2 stamp groups")
        self.dtheta /= 3600.0  # arcsec -> degrees

        self.fade_kernel = raw["FADE"]
        self.postage_pad = raw["PAD"]
        self.pad_sides = raw["PADSIDES"]
        self.stoptile = raw["STOP"]

        self.outmaps = raw["OUTMAPS"]
        self.outstem = raw["OUT"]
        self.tempfile = raw["TEMPFILE"] or None
        self.inlayercache = raw["INLAYERCACHE"] or None

        self.n_out = raw["NOUT"]
        self.outpsf = raw["OUTPSF"]
        self.sigmatarget = raw["EXTRASMOOTH"]
        if self.n_out > 1:
            self.outpsf_extra = [cfg_dict.get(f"OUTPSF{j + 1}", "AIRYOBSC") for j in range(1, self.n_out)]
            self.sigmatarget_extra = [
                cfg_dict.get(f"EXTRASMOOTH{j + 1}", 1.5 / 2.355) for j in range(1, self.n_out)
            ]

        self.npixpsf = raw["NPIXPSF"]
        self.psf_circ = raw["PSFCIRC"]
        self.psf_norm = raw["PSFNORM"]
        self.amp_penalty = raw["AMPPEN"]
        self.flat_penalty = raw["FLATPEN"]
        self.psf_interp = raw["PSFINTERP"]
        self.instamp_pad = raw["INPAD"] * ARCSEC

        self.linear_algebra = raw["LAKERNEL"]
        self.iter_rtol = raw["ITERRTOL"]
        self.iter_max = raw["ITERMAX"]
        self.no_qlt_ctrl = raw["EMPIRNQC"]
        self.kappaC_arr = np.array(raw["KAPPAC"], dtype=np.float64)
        self.solver_prec = raw["SOLVERPREC"]
        self.uctarget = raw["UCMIN"]
        self.sigmamax = raw["SMAX"]

        self.ds_model, self.ds_rows = raw["DSMODEL"]
        self.ds_outpath, self.ds_outstem = raw["DSOUT"]
        self.cg_model, self.cg_maxiter, self.cg_tol = raw["CGMODEL"]
        self.cost_model, self.cost_prior, self.hub_thresh = raw["DSCOST"]
        self.ds_obsfile = raw["DSOBSFILE"]
        self.ds_noisefile = raw["DSNOISEFILE"]
        self.ds_restart = raw["DSRESTART"]
        self.gaindir = raw["GAINDIR"]
        self.col_pars = raw["AMPCOLS"]
        self.amp_cols = self.col_pars[0]
        self.col_boundary_const = self.col_pars[1]

        self.tileschm = raw["TILESCHM"]
        self.rerun = raw["RERUN"]
        self.mosaic = raw["MOSAIC"]

    def __call__(self) -> None:
        """Compute / refresh derived quantities (cf. reference config.py:412-449)."""
        if self.psfsplit:
            self.psfsplit_r1 = float(self.psfsplit[0])
            self.psfsplit_r2 = float(self.psfsplit[1])
            self.psfsplit_epsilon = float(self.psfsplit[2])
            self.psfsplit_bin2x2 = len(self.psfsplit) > 3 and bool(self.psfsplit[3])

        self.n_inframe = len(self.extrainput)

        self.Nside = self.n1 * self.n2
        self.NsideP = self.Nside + self.postage_pad * self.n2 * 2
        self.n1P = self.n1 + self.postage_pad * 2
        self.n2f = self.n2 + self.fade_kernel * 2

        if self.linear_algebra == "Empirical":
            self.outmaps = self.outmaps.replace("T", "")
            if self.no_qlt_ctrl:
                self.outmaps = self.outmaps.replace("U", "").replace("S", "")
            elif "U" not in self.outmaps and "S" not in self.outmaps:
                self.no_qlt_ctrl = True
        if self.linear_algebra == "Empirical" or self.kappaC_arr.size == 1:
            self.outmaps = self.outmaps.replace("K", "")

        if getattr(self, "cost_model", None) is not None:
            self.resid_model = {
                "quadratic": "quad_prime",
                "absolute": "abs_prime",
                "huber_loss": "hub_prime",
            }.get(self.cost_model)

    # ----- round trip -------------------------------------------------------

    def to_dict(self) -> dict:
        """Serialize back to a JSON-compatible dictionary."""
        d = {
            "OBSFILE": self.obsfile,
            "INDATA": [self.inpath, self.informat],
            "FILTER": self.use_filter,
            "INPSF": [self.inpsf_path, self.inpsf_format, self.inpsf_oversamp],
            "CTR": [self.ra, self.dec],
            "LONPOLE": self.lonpole,
            "BLOCK": self.nblock,
            "OUTSIZE": [self.n1, self.n2, self.dtheta * 3600.0],
            "FADE": self.fade_kernel,
            "PAD": self.postage_pad,
            "PADSIDES": self.pad_sides,
            "STOP": self.stoptile,
            "OUTMAPS": self.outmaps,
            "OUT": self.outstem,
            "NOUT": self.n_out,
            "OUTPSF": self.outpsf,
            "EXTRASMOOTH": self.sigmatarget,
            "NPIXPSF": self.npixpsf,
            "PSFCIRC": self.psf_circ,
            "PSFNORM": self.psf_norm,
            "AMPPEN": list(self.amp_penalty),
            "FLATPEN": self.flat_penalty,
            "PSFINTERP": self.psf_interp,
            "INPAD": self.instamp_pad / ARCSEC,
            "LAKERNEL": self.linear_algebra,
            "KAPPAC": list(np.asarray(self.kappaC_arr, dtype=float)),
            "UCMIN": self.uctarget,
            "SMAX": self.sigmamax,
            "EXTRAINPUT": [x for x in self.extrainput[1:]],
            "TILESCHM": self.tileschm,
            "RERUN": self.rerun,
            "MOSAIC": self.mosaic,
        }
        if self.permanent_mask is not None:
            d["PMASK"] = self.permanent_mask
        if self.cr_mask_rate:
            d["CMASK"] = self.cr_mask_rate
        if self.tempfile:
            d["TEMPFILE"] = self.tempfile
        if self.inlayercache:
            d["INLAYERCACHE"] = self.inlayercache
        if self.psfsplit:
            d["PSFSPLIT"] = self.psfsplit
        if self.linear_algebra == "Iterative":
            d["ITERRTOL"] = self.iter_rtol
            d["ITERMAX"] = self.iter_max
        if self.linear_algebra == "Empirical":
            d["EMPIRNQC"] = self.no_qlt_ctrl
        if self.n_out > 1:
            for j in range(1, self.n_out):
                d[f"OUTPSF{j + 1}"] = self.outpsf_extra[j - 1]
                d[f"EXTRASMOOTH{j + 1}"] = self.sigmatarget_extra[j - 1]
        return d

    def to_file(self, fname=None) -> str:
        """Write the configuration to a JSON file; return the JSON text."""
        text = json.dumps(self.to_dict(), indent=2)
        if fname is not None:
            with open(fname, "w") as f:
                f.write(text)
        return text


# ---------------------------------------------------------------------------
# interactive configuration builder
# ---------------------------------------------------------------------------

_PROMPT_HELP = {
    "OBSFILE": "input observation list (FITS table)",
    "INDATA": "input file directory and format, e.g. /data L2_fits",
    "FILTER": "filter index (0=Y106 .. per Settings.RomanFilters)",
    "INPSF": "PSF directory, format, oversampling, e.g. /psf L2_fits 8",
    "CTR": "mosaic center RA DEC in degrees",
    "BLOCK": "blocks per mosaic side (nblock)",
    "OUTSIZE": "n1 n2 dtheta_arcsec (stamps/block, px/stamp, output scale)",
    "OUT": "output stem for block files",
    "EXTRAINPUT": "extra layers, comma separated (e.g. whitenoise1,cstar14)",
    "PSFSPLIT": "r1 r2 epsilon [bin2x2] -- empty for no PSF splitting",
    "LAKERNEL": "solver: Cholesky | Eigen | Iterative | Empirical",
    "KAPPAC": "kappa/C nodes, space separated",
    "INLAYERCACHE": "input-layer cache stem (empty to disable)",
}


def _parse_like(default, text: str):
    """Parse `text` with the same type/shape as `default`."""
    if isinstance(default, bool):
        return text.strip().lower() in ("1", "true", "yes", "y")
    if isinstance(default, int):
        return int(text)
    if isinstance(default, float):
        return float(text)
    if isinstance(default, (list, tuple)):
        parts = text.replace(",", " ").split()
        out = []
        for p in parts:
            try:
                out.append(int(p))
            except ValueError:
                try:
                    out.append(float(p))
                except ValueError:
                    out.append(None if p.lower() == "none" else p)
        return out
    return text


def build_config_interactive(input_fn=input, output=print, outfile=None):
    """
    Terminal interface to build a configuration from scratch
    (reference Config._build_config, config.py:632-1102): walks the keyword
    schema section by section; empty input keeps the default, required keys
    re-prompt until provided.  Returns the built Config (written to
    `outfile` when given).
    """
    output("### pyimcom_tpu configuration builder ###")
    output("### enter nothing to accept the [default] ###\n")
    cfg_dict = {}
    for key, default in _DEFAULT_CONFIG.items():
        required = default is _REQ
        hint = _PROMPT_HELP.get(key, "")
        shown = "required" if required else f"default: {default!r}"
        while True:
            text = input_fn(f"{key} ({hint}; {shown}): " if hint
                            else f"{key} ({shown}): ").strip()
            if not text:
                if required:
                    output(f"  {key} is required.")
                    continue
                break
            try:
                if required:
                    # infer shape from the key's documented form
                    if key in ("OBSFILE", "OUT"):
                        cfg_dict[key] = text
                    elif key == "FILTER":
                        cfg_dict[key] = int(text)
                    elif key == "BLOCK":
                        cfg_dict[key] = int(text)
                    elif key in ("INDATA",):
                        cfg_dict[key] = text.split()
                    elif key == "INPSF":
                        p, f, ov = text.split()
                        cfg_dict[key] = [p, f, int(ov)]
                    elif key == "CTR":
                        cfg_dict[key] = [float(v) for v in text.split()]
                    elif key == "OUTSIZE":
                        a, b, c = text.split()
                        cfg_dict[key] = [int(a), int(b), float(c)]
                    else:
                        cfg_dict[key] = text
                elif key == "EXTRAINPUT":
                    # Config prepends the SCI layer (None) itself
                    cfg_dict[key] = [s.strip() for s in text.split(",")
                                     if s.strip()]
                else:
                    cfg_dict[key] = _parse_like(default, text)
                break
            except (ValueError, TypeError) as e:
                output(f"  could not parse: {e}")
    cfg = Config(cfg_dict)
    cfg()
    if outfile:
        with open(outfile, "w") as f:
            f.write(cfg.to_file(None))
        output(f"configuration written to {outfile}")
    return cfg


#: matplotlib rc parameters for report figures; use as
#: ``with mpl.rc_context(config.format_axis_pars):``
#: (reference config.py:1236-1249)
format_axis_pars = {
    "font.family": "serif",
    "mathtext.fontset": "dejavuserif",
    "font.size": 12,
    "text.latex.preamble": r"\usepackage{amsmath}",
    "xtick.major.pad": 2,
    "ytick.major.pad": 2,
    "xtick.major.size": 6,
    "ytick.major.size": 6,
    "xtick.minor.size": 3,
    "ytick.minor.size": 3,
    "axes.linewidth": 2,
    "axes.labelpad": 1,
}


def format_axis(ax, grid_on=True):
    """House style for one figure panel (reference config.py:1252-1275)."""
    ax.minorticks_on()
    if grid_on:
        ax.grid(visible=True, which="major", linestyle=":")
    ax.tick_params(axis="both", which="both", direction="out")
    ax.xaxis.set_ticks_position("both")
    ax.yaxis.set_ticks_position("both")
    ax.patch.set_alpha(0.0)


if __name__ == "__main__":
    # python -m pyimcom_tpu_torch.config [outfile.json]
    import sys as _sys

    build_config_interactive(
        outfile=_sys.argv[1] if len(_sys.argv) > 1 else None)
