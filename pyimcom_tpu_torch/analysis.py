"""
Output-side analysis API: block readers, mosaics, weight maps, noise and
star statistics.

The port's copy of ``pyimcom_tpu/analysis.py``, so that the port imports
nothing of the JAX package; keep the two in step.

Counterpart of reference src/pyimcom/analysis.py (OutImage/Mosaic/Suite/
NoiseAnal/StarsAnal).  Reads block FITS files (compressed or not) through
the framework's own FITS layer, decodes the log-quantized quality maps via
their bel-unit headers, and implements the padding-stamp halo exchange
between adjacent blocks.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from .compress import ReadFile
from .config import Config
from .fitsio import fits_read

_UNIT_PREFIX = {"": 1.0, "m": 1e-3, "u": 1e-6, "n": 1e-9, "d": 1e-1, "c": 1e-2}


def unit_to_bels(unit: str) -> float:
    """
    Bels per integer count from a UNIT string like '-0.2mB' or '5uB'
    (reference diagnostics/outimage_utils/helper.py:19).
    """
    m = re.match(r"^([+-]?[0-9.]+)([a-z]?)B$", unit.strip())
    if not m:
        raise ValueError(f"cannot parse unit {unit!r}")
    return float(m.group(1)) * _UNIT_PREFIX[m.group(2)]


def decode_quality_map(data: np.ndarray, unit: str) -> np.ndarray:
    """Decode a log-quantized (u)int16 map to linear values."""
    bels = unit_to_bels(unit)
    coef = 1.0 / bels  # counts per bel
    out = np.power(10.0, np.asarray(data, dtype=np.float64) * bels).astype(np.float32)
    if data.dtype in (np.dtype("uint16"), np.dtype(">u2")):
        a_min, a_max = 0, 65535
    else:
        a_min, a_max = -32768, 32767
    a_zero = a_min if coef > 0 else a_max
    out[data == a_zero] = 0.0
    return out


class OutImage:
    """
    Wrapper for one coadded block file.

    Parameters
    ----------
    fpath : path to the block FITS file (plain or compressed).
    cfg : optional Config (read from the CONFIG HDU if omitted).
    """

    MAP_HDUS = ["FIDELITY", "SIGMA", "KAPPA", "INWTSUM", "EFFCOVER"]

    @staticmethod
    def get_hdu_names(outmaps: str):
        names = ["PRIMARY", "CONFIG", "INDATA", "INWEIGHT", "INWTFLAT"]
        for flag, name in zip("USKTN", OutImage.MAP_HDUS):
            if flag in outmaps:
                names.append(name)
        return names

    def __init__(self, fpath, cfg: Config = None, hdu_names=None):
        self.fpath = str(fpath)
        self.cfg = cfg
        if cfg is None:
            self.cfg = Config(self.fpath, inmode="block")
            self.header = None
        self.cfg()
        self.hdu_names = hdu_names or OutImage.get_hdu_names(self.cfg.outmaps)

        hdr = fits_read(self.fpath)["CONFIG"].header
        if "BLOCKX" in hdr and "BLOCKY" in hdr:
            self.ibx = int(hdr["BLOCKX"])
            self.iby = int(hdr["BLOCKY"])
        else:
            stem = Path(self.fpath).stem
            if stem.endswith("_map"):
                stem = stem[:-4]
            self.ibx, self.iby = map(int, stem.split("_")[-2:])

    # ----- loading ----------------------------------------------------------

    def load(self):
        if not hasattr(self, "hdu_list"):
            self.hdu_list = ReadFile(self.fpath)
        return self.hdu_list

    def unload(self):
        if hasattr(self, "hdu_list"):
            del self.hdu_list

    def save(self, fpath=None):
        from .fitsio import fits_write

        fits_write(fpath or self.fpath, self.load())

    @staticmethod
    def get_last_line(fname):
        with open(fname) as f:
            last = ""
            for line in f:
                last = line
        return last

    def get_time_consump(self) -> float:
        """Block wall time parsed from the job log (reference analysis.py:166)."""
        fname = self.fpath.replace(".fits", ".out")
        try:
            m = re.match(r"finished at t = ([0-9.]+) s", OutImage.get_last_line(fname))
            return float(m.group(1))
        except (FileNotFoundError, AttributeError):
            return np.nan

    # ----- data access ------------------------------------------------------

    def layer_index(self, layer: str) -> int:
        """Index of a named layer in EXTRAINPUT (SCI = index 0)."""
        if layer in (None, "SCI", "sci"):
            return 0
        for i, spec in enumerate(self.cfg.extrainput):
            if spec is not None and spec.split(",")[0].lower() == layer.lower():
                return i
        raise KeyError(f"layer {layer!r} not found")

    def get_coadded_layer(self, layer, j_out: int = 0) -> np.ndarray:
        """One coadded layer image, (NsideP, NsideP)."""
        idx = layer if isinstance(layer, (int, np.integer)) else self.layer_index(layer)
        return np.asarray(self.load()[0].data[j_out, idx])

    def get_T_weightmap(self, j_out: int = 0) -> np.ndarray:
        """(n_inimage, n1P, n1P) total-weight map per input exposure."""
        data = self.load()["INWEIGHT"].data
        return np.asarray(data[j_out])

    def get_mean_coverage(self, padding: bool = False) -> float:
        tw = self.get_T_weightmap(0)
        pad = self.cfg.postage_pad
        if not padding and pad > 0:
            tw = tw[:, pad:-pad, pad:-pad]
        return float(np.mean(np.sum(tw.astype(bool), axis=0)))

    def get_output_map(self, outmap: str, j_out=0) -> np.ndarray:
        """Decode a quality map (FIDELITY/SIGMA/KAPPA/INWTSUM/EFFCOVER)."""
        assert outmap in OutImage.MAP_HDUS, f"map {outmap!r} not supported"
        hdu = self.load()[outmap]
        unit = str(hdu.header["UNIT"])
        sl = np.s_[j_out] if j_out is not None else np.s_[:]
        return decode_quality_map(np.asarray(hdu.data[sl]), unit)

    def get_weight_map(self, noise_layer) -> np.ndarray:
        """
        Inverse-variance weight map from a coadded noise layer and the Sigma
        map (reference analysis.py:539-563).
        """
        noise_image = self.get_coadded_layer(noise_layer)
        Sigma = self.get_output_map("SIGMA")
        scale = np.sum(np.square(noise_image))
        corr_var = (scale / np.sum(Sigma)) * Sigma
        with np.errstate(divide="ignore"):
            w = 1.0 / corr_var
        w[~np.isfinite(w)] = 0.0
        return w

    # ----- padding-stamp halo exchange --------------------------------------

    def _update_hdu_data(self, neighbor: "OutImage", direction: str,
                         add_mode: bool = True) -> None:
        """
        Merge the shared padding-stamp region from an adjacent block
        (reference analysis.py:394-537).  The TPU-native mosaic runner maps
        this onto a halo exchange over the block mesh; here it is the
        post-pass form operating on files.
        """
        from .outmaps import compress_map, trapezoid

        assert direction in ("left", "right", "bottom", "top")
        cfg = self.cfg
        NsideP = cfg.NsideP
        width = cfg.postage_pad * cfg.n2
        fk = cfg.fade_kernel
        me = self.load()
        ur = neighbor.load()

        if direction == "left":
            my_sl = np.s_[:, :, :, 0:width + fk]
            ur_sl = np.s_[:, :, :, NsideP - width * 2:NsideP - width + fk]
        elif direction == "right":
            my_sl = np.s_[:, :, :, NsideP - width - fk:NsideP]
            ur_sl = np.s_[:, :, :, width - fk:width * 2]
        elif direction == "bottom":
            my_sl = np.s_[:, :, 0:width + fk, :]
            ur_sl = np.s_[:, :, NsideP - width * 2:NsideP - width + fk, :]
        else:
            my_sl = np.s_[:, :, NsideP - width - fk:NsideP, :]
            ur_sl = np.s_[:, :, width - fk:width * 2, :]

        me[0].data = np.array(me[0].data)
        me[0].data[my_sl] = me[0].data[my_sl] * add_mode + ur[0].data[ur_sl]

        # INWEIGHT: copy the neighbor's better-covered padding stamps
        n1P = cfg.n1P
        pad = cfg.postage_pad
        my_ids = list(zip(me["INDATA"]["obsid"], me["INDATA"]["sca"]))
        ur_ids = list(zip(ur["INDATA"]["obsid"], ur["INDATA"]["sca"]))
        me["INWEIGHT"].data = np.array(me["INWEIGHT"].data)
        for idsca in set(my_ids) & set(ur_ids):
            mi = my_ids.index(idsca)
            ui = ur_ids.index(idsca)
            if direction == "left":
                msl = np.s_[:, mi, :, 0:pad]
                usl = np.s_[:, ui, :, n1P - pad * 2:n1P - pad]
            elif direction == "right":
                msl = np.s_[:, mi, :, n1P - pad:n1P]
                usl = np.s_[:, ui, :, pad:pad * 2]
            elif direction == "bottom":
                msl = np.s_[:, mi, 0:pad, :]
                usl = np.s_[:, ui, n1P - pad * 2:n1P - pad, :]
            else:
                msl = np.s_[:, mi, n1P - pad:n1P, :]
                usl = np.s_[:, ui, pad:pad * 2, :]
            me["INWEIGHT"].data[msl] = ur["INWEIGHT"].data[usl]

        n_out, n_inimage = me["INWEIGHT"].data.shape[:2]
        me["INWTFLAT"].data = np.transpose(
            me["INWEIGHT"].data, axes=(0, 2, 1, 3)).reshape(
            (n_out * n1P, n_inimage * n1P))

        # quality maps: fade, add, re-encode
        for outmap in [n for n in self.hdu_names[5:]]:
            my_maps = self.get_output_map(outmap, None)
            ur_maps = neighbor.get_output_map(outmap, None)
            if direction == "left":
                if add_mode:
                    trapezoid(my_maps, fk, False, (0, 0, width - fk, 0), "L")
                    trapezoid(ur_maps, fk, False, (0, 0, 0, width - fk), "R")
                msl = np.s_[:, :, 0:width + fk]
                usl = np.s_[:, :, NsideP - width * 2:NsideP - width + fk]
            elif direction == "right":
                if add_mode:
                    trapezoid(my_maps, fk, False, (0, 0, 0, width - fk), "R")
                    trapezoid(ur_maps, fk, False, (0, 0, width - fk, 0), "L")
                msl = np.s_[:, :, NsideP - width - fk:NsideP]
                usl = np.s_[:, :, width - fk:width * 2]
            elif direction == "bottom":
                if add_mode:
                    trapezoid(my_maps, fk, False, (width - fk, 0, 0, 0), "B")
                    trapezoid(ur_maps, fk, False, (0, width - fk, 0, 0), "T")
                msl = np.s_[:, 0:width + fk, :]
                usl = np.s_[:, NsideP - width * 2:NsideP - width + fk, :]
            else:
                if add_mode:
                    trapezoid(my_maps, fk, False, (0, width - fk, 0, 0), "T")
                    trapezoid(ur_maps, fk, False, (width - fk, 0, 0, 0), "B")
                msl = np.s_[:, NsideP - width - fk:NsideP, :]
                usl = np.s_[:, width - fk:width * 2, :]

            unit = str(me[outmap].header["UNIT"])
            coef = round(1.0 / unit_to_bels(unit) * np.log10(10.0))
            dtype = np.uint16 if me[outmap].data.dtype in (
                np.dtype("uint16"), np.dtype(">u2")) else np.int16
            me[outmap].data = np.array(me[outmap].data)
            me[outmap].data[msl] = compress_map(
                my_maps[msl] * add_mode + ur_maps[usl], coef, dtype)


class _BlkGrp:
    """
    Shared analyses over a group of coadded blocks (reference _BlkGrp,
    analysis.py:1087-1392): consumption map, coverage map, mosaic-wide
    noise power spectra binned by coverage, and the star-moment catalog,
    each persisted next to the output stem.  Subclasses supply
    ``_block_items()`` -> [(index, OutImage)] and ``_map_shape``.
    """

    padding = False  # include postage-pad region in noise spectra?

    def __call__(self, overwrite: bool = False):
        """Run all analyses (reference _BlkGrp.__call__, analysis.py:1108)."""
        self.get_consump_map(overwrite=overwrite)
        self.get_coverage_map(overwrite=overwrite)
        self.get_noise_power_spectra(overwrite=overwrite)
        self.get_star_catalog(overwrite=overwrite)

    def get_consump_map(self, overwrite: bool = False) -> np.ndarray:
        """Per-block wall-time consumption parsed from the job logs,
        cached as <stem>_Consump.npy (reference analysis.py:1128-1163)."""
        import os

        fname = self.stem + "_Consump.npy"
        if not overwrite and os.path.exists(fname):
            self.consump_map = np.load(fname)
            return self.consump_map
        self.consump_map = np.zeros(self._map_shape)
        for idx, oi in self._block_items():
            try:
                self.consump_map[idx] = oi.get_time_consump()
            except (FileNotFoundError, KeyError):
                self.consump_map[idx] = np.nan
        np.save(fname, self.consump_map)
        return self.consump_map

    def get_coverage_map(self, overwrite: bool = False) -> np.ndarray:
        """Per-block mean-coverage map, cached as <stem>_Coverage.npy
        (reference _BlkGrp.get_coverage_map, analysis.py:1165-1200)."""
        import os

        fname = self.stem + "_Coverage.npy"
        if not overwrite and os.path.exists(fname):
            self.coverage_map = np.load(fname)
            return self.coverage_map
        self.coverage_map = np.zeros(self._map_shape)
        for idx, oi in self._block_items():
            self.coverage_map[idx] = oi.get_mean_coverage()
        np.save(fname, self.coverage_map)
        return self.coverage_map

    def get_noise_power_spectra(self, bins: int = 5,
                                overwrite: bool = False):
        """
        Noise power spectra of every noise layer averaged over the whole
        block group, with 1D spectra accumulated per mean-coverage bin
        (reference _BlkGrp.get_noise_power_spectra, analysis.py:1202-1307).

        Persists <stem>_NoisePS.npz with ps2d_all (n_noise, L//8, L//8),
        ps1d_all (n_noise, bins, L//16, 2) and wavenumbers (cycles/arcsec).
        """
        import os

        fname = self.stem + "_NoisePS.npz"
        if not overwrite and os.path.exists(fname):
            with np.load(fname) as f:
                self.ps2d_all = f["ps2d_all"]
                self.ps1d_all = f["ps1d_all"]
                self.wavenumbers = f["wavenumbers"]
            return self.ps2d_all, self.ps1d_all, self.wavenumbers

        cfg = self.cfg
        noiseinput = [lay for lay in (cfg.extrainput[1:] or [])
                      if lay and "noise" in lay]
        n_innoise = len(noiseinput)

        cov = self.get_coverage_map()
        mc_max = cov.max() + 1e-12
        mc_min = cov.min() - 1e-12
        coverage_idx = ((cov - mc_min) / (mc_max - mc_min)
                        * bins).astype(np.uint8)
        unique, counts = np.unique(coverage_idx, return_counts=True)

        L = (cfg.NsideP if self.padding else cfg.Nside) // 8 * 8
        self.ps2d_all = np.zeros((n_innoise, L // 8, L // 8))
        self.ps1d_all = np.zeros((n_innoise, bins + 1, L // 16, 2))
        self.wavenumbers = NoiseAnal.get_wavenumbers(L, L // 16)
        # cycles/output px -> cycles/arcsec
        self.wavenumbers = self.wavenumbers / (cfg.dtheta * 3600.0)

        n_blk = 0
        for idx, oi in self._block_items():
            n_blk += 1
            for inl, layer in enumerate(noiseinput):
                na = NoiseAnal(oi, layer)
                na(padding=self.padding)
                self.ps2d_all[inl] += na.ps2d
                self.ps1d_all[inl, coverage_idx[idx]] += na.ps1d
                na.clear()
            oi.unload()
        if n_blk:
            self.ps2d_all /= n_blk
        for bi, count in zip(unique, counts):
            self.ps1d_all[:, bi] /= count
        self.ps1d_all = self.ps1d_all[:, :bins]
        np.savez(fname, ps2d_all=self.ps2d_all, ps1d_all=self.ps1d_all,
                 wavenumbers=self.wavenumbers)
        return self.ps2d_all, self.ps1d_all, self.wavenumbers

    def get_star_catalog(self, layer: str = "cstar14",
                         overwrite: bool = False) -> dict:
        """
        Star-moment catalog over the block group, written to
        <stem>_StarCat.fits (reference _BlkGrp.get_star_catalog,
        analysis.py:1309-1371).
        """
        import os

        from .fitsio import HDUList, ImageHDU, TableHDU, fits_read, fits_write

        outfile = self.stem + "_StarCat.fits"
        if not overwrite and os.path.exists(outfile):
            t = fits_read(outfile)["STARCAT"]
            self.star_cat = {k: np.asarray(t.data[k])
                             for k in t.data.dtype.names}
            return self.star_cat
        cols = None
        for idx, oi in self._block_items():
            cat = StarsAnal(oi, layer=layer).catalog()
            n = len(cat["ipix"])
            iby, ibx = idx if isinstance(idx, tuple) else (0, idx)
            cat["ibx"] = np.full(n, ibx, dtype=np.int32)
            cat["iby"] = np.full(n, iby, dtype=np.int32)
            if cols is None:
                cols = {k: [v] for k, v in cat.items()}
            else:
                for k, v in cat.items():
                    cols[k].append(v)
            oi.unload()
        data = {k: np.concatenate(v) for k, v in (cols or {}).items()}
        data = {k: (v.astype(np.int16) if v.dtype == bool else v)
                for k, v in data.items()}
        t = TableHDU(data=data, name="STARCAT")
        t.header["LAYER"] = layer[:60]
        fits_write(outfile, HDUList([ImageHDU(None), t]))
        self.star_cat = data
        return data

    def clear(self):
        """Free analysis products (reference _BlkGrp.clear)."""
        for attr in ("consump_map", "coverage_map", "ps2d_all", "ps1d_all",
                     "wavenumbers", "star_cat"):
            if hasattr(self, attr):
                delattr(self, attr)


class Mosaic(_BlkGrp):
    """
    A grid of OutImage blocks from one mosaic run.

    Parameters
    ----------
    stem : output stem (files are <stem>_XX_YY.fits).
    nblock : blocks per side (read from the first block config if omitted).
    """

    padding = False

    def __init__(self, stem, nblock=None, suffix=".fits"):
        self.stem = str(stem)
        self.suffix = suffix
        first = self._path(0, 0)
        cfg = Config(first, inmode="block")
        self.cfg = cfg
        self.nblock = nblock or cfg.nblock
        self.images = {}

    def _path(self, ibx, iby):
        return f"{self.stem}_{ibx:02d}_{iby:02d}{self.suffix}"

    def __getitem__(self, key):
        ibx, iby = key
        if key not in self.images:
            self.images[key] = OutImage(self._path(ibx, iby), cfg=None)
        return self.images[key]

    def share_padding_stamps(self):
        """
        Halo exchange of padding stamps between all adjacent block pairs
        (reference Mosaic.share_padding_stamps, analysis.py:1429-1467).
        Blocks are modified in memory; call save() per image to persist.
        """
        nb = self.nblock
        for ibx in range(nb):
            for iby in range(nb):
                me = self[ibx, iby]
                if ibx > 0:
                    me._update_hdu_data(self[ibx - 1, iby], "left")
                if ibx < nb - 1:
                    me._update_hdu_data(self[ibx + 1, iby], "right")
                if iby > 0:
                    me._update_hdu_data(self[ibx, iby - 1], "bottom")
                if iby < nb - 1:
                    me._update_hdu_data(self[ibx, iby + 1], "top")

    @property
    def _map_shape(self):
        return (self.nblock, self.nblock)

    def _block_items(self):
        for iby in range(self.nblock):
            for ibx in range(self.nblock):
                yield (iby, ibx), self[ibx, iby]

    def mean_coverage_map(self):
        """(nblock, nblock) grid of per-block mean coverages."""
        out = np.zeros((self.nblock, self.nblock))
        for ibx in range(self.nblock):
            for iby in range(self.nblock):
                out[iby, ibx] = self[ibx, iby].get_mean_coverage()
        return out


class Suite(_BlkGrp):
    """
    A prime-hashed subset of one mosaic's blocks (the Paper IV
    hyperparameter-sweep pattern, where only nrun blocks of each
    configuration are coadded; reference Suite, analysis.py:1470-1506).
    Block ib lives at divmod(ib * prime % nblock^2, nblock).
    """

    padding = True  # suite blocks are isolated; keep the pad region

    def __init__(self, stem, prime: int = 691, nrun: int = 16,
                 suffix: str = ".fits", nblock=None):
        self.stem = str(stem)
        self.suffix = suffix
        self.prime = prime
        self.nrun = nrun
        self.images = {}
        # suite member 0 always lives at (0, 0)
        first = Config(self._path(0, 0), inmode="block")
        self.cfg = first
        self.nblock = nblock or first.nblock

    def block_index(self, ib: int):
        """(ibx, iby) of suite member ib (reference analysis.py:1502)."""
        return divmod(ib * self.prime % self.nblock ** 2, self.nblock)

    def _path(self, ibx, iby):
        return f"{self.stem}_{ibx:02d}_{iby:02d}{self.suffix}"

    def __getitem__(self, ib: int):
        if ib not in self.images:
            ibx, iby = self.block_index(ib)
            self.images[ib] = OutImage(self._path(ibx, iby), cfg=None)
        return self.images[ib]

    @property
    def _map_shape(self):
        return (self.nrun,)

    def _block_items(self):
        for ib in range(self.nrun):
            yield ib, self[ib]


class StarsAnal:
    """
    Star-moment catalogs from injected-grid layers
    (reference StarsAnal, analysis.py:852-1127; galsim HSM replaced by
    utils.moments adaptive moments + standardized fourth moments).
    """

    COLUMNS = ["ipix", "x", "y", "amp", "sigma", "e1", "e2",
               "M40", "M31", "M22", "M13", "M04", "converged"]

    def __init__(self, outimage: OutImage, layer="cstar14", win: int = 10):
        self.outimage = outimage
        self.layer = layer
        self.win = win

    def catalog(self) -> dict:
        """Measure every truth-grid star on this block; returns a column dict."""
        import re as _re

        from .truthcats import block_truth_positions
        from .utils.moments import find_adaptive_moments, fourth_moments

        oi = self.outimage
        img = oi.get_coadded_layer(self.layer)
        m = _re.search(r"(\d+)$", self.layer.split(",")[0])
        res = int(m.group(1))
        pos = block_truth_positions(oi.cfg, oi.ibx, oi.iby, res)
        cols = {k: [] for k in StarsAnal.COLUMNS}
        pad = oi.cfg.postage_pad * oi.cfg.n2
        w = self.win
        for i in range(len(pos["ipix"])):
            x = pos["x"][i] - 0  # block pixel coords (incl. padding region)
            y = pos["y"][i]
            ix, iy = int(round(x)), int(round(y))
            if not (w <= ix < img.shape[1] - w and w <= iy < img.shape[0] - w):
                continue
            sub = np.asarray(img[iy - w:iy + w + 1, ix - w:ix + w + 1], dtype=np.float64)
            mom = find_adaptive_moments(sub)
            cols["ipix"].append(int(pos["ipix"][i]))
            cols["x"].append(x)
            cols["y"].append(y)
            cols["amp"].append(mom.moments_amp)
            cols["sigma"].append(mom.moments_sigma)
            cols["e1"].append(mom.observed_e1 if mom.converged else np.nan)
            cols["e2"].append(mom.observed_e2 if mom.converged else np.nan)
            if mom.converged:
                m4 = fourth_moments(sub, mom)
                for k in ("M40", "M31", "M22", "M13", "M04"):
                    cols[k].append(m4[k])
            else:
                for k in ("M40", "M31", "M22", "M13", "M04"):
                    cols[k].append(np.nan)
            cols["converged"].append(bool(mom.converged))
        return {k: np.asarray(v) for k, v in cols.items()}


class NoiseAnal:
    """
    Noise power spectra of coadded noise layers
    (reference NoiseAnal, analysis.py:565-850).

    Calling the instance reproduces the reference pipeline: physical
    normalization per layer type, 8x8-binned 2D spectrum (`ps2d`), and the
    azimuthally averaged 1D spectrum with standard errors (`ps1d`).
    """

    # lab-noise normalization constants (reference analysis.py:567-607)
    tfr = 3.08
    gain = 1.458
    ABstd = 3.631e-20
    h = 6.62607015e-27
    m_ab = 23.9
    AREA = {"Y106": 7006.0, "J129": 7111.0, "H158": 7340.0,
            "F184": 4840.0, "K213": 4654.0, "W146": 22085.0}

    def __init__(self, outimage: OutImage, layer="whitenoise1"):
        self.outimage = outimage
        self.layer = layer

    @classmethod
    def get_norm(cls, layer: str, L: int, filtername: str, s_out: float):
        """Physical norm for the 2D spectrum (reference analysis.py:618-660)."""
        if layer.startswith(("white", "1f")):
            return (L / s_out) ** 2
        if layer.startswith("lab"):
            return (cls.tfr / cls.gain * cls.ABstd / cls.h
                    * cls.AREA[filtername] * 10 ** (-0.4 * cls.m_ab)
                    * s_out ** 2)
        return float(L) ** 2  # generic: per-pixel variance units

    @staticmethod
    def azimuthal_average(image, nradbins: int):
        """Radial profile (mean, standard error) of a centered 2D image
        (reference analysis.py:661-707)."""
        from scipy import ndimage

        ny, nx = image.shape
        yy, xx = np.mgrid[:ny, :nx]
        r = np.hypot(xx - nx / 2, yy - ny / 2)
        rbin = (nradbins * r / r.max()).astype(int)
        ridx = np.arange(1, rbin.max() + 1)[:nradbins]
        mean = ndimage.mean(image, labels=rbin, index=ridx)
        std = ndimage.standard_deviation(image, labels=rbin, index=ridx)
        npix = ndimage.sum(np.ones_like(image), labels=rbin, index=ridx)
        return mean, std / np.sqrt(np.maximum(npix, 1))

    @staticmethod
    def tukey_window(shape, alpha: float = 0.9):
        """Separable 2D Tukey (tapered-cosine) window (the reference uses
        skimage.filters.window(('tukey', alpha)),
        noise_diagnostics.py:429-433)."""
        from scipy.signal.windows import tukey

        return np.outer(tukey(shape[0], alpha), tukey(shape[1], alpha))

    @staticmethod
    def get_wavenumbers(window_length: int, num_radial_bins: int):
        """Azimuthally averaged |k| per radial bin, cycles/output px
        (reference noise_diagnostics.py:445-469)."""
        k = np.fft.fftshift(np.fft.fftfreq(window_length))
        kx, ky = np.meshgrid(k, k)
        kmean, _ = NoiseAnal.azimuthal_average(np.hypot(kx, ky),
                                               num_radial_bins)
        return kmean

    def __call__(self, padding: bool = False, win: bool = False,
                 alpha: float = 0.9, bin_flag: int = 1):
        """Measure ps2d (8x8-binned 2D spectrum when bin_flag=1, unbinned
        when 0) and ps1d ((nradbins, 2): mean, err) of the configured layer
        (reference analysis.py:745-808); `win` applies a Tukey(`alpha`)
        window before the FFT with the matching power-spectrum
        renormalization (reference noise_diagnostics.py:399-443).  Also
        sets `wavenumbers` (cycles/px at each radial bin)."""
        cfg = self.outimage.cfg
        L = cfg.NsideP
        indata = np.asarray(self.outimage.get_coadded_layer(self.layer),
                            dtype=np.float64)
        if not padding and cfg.postage_pad > 0:
            bdpad = cfg.n2 * cfg.postage_pad
            indata = indata[bdpad:-bdpad, bdpad:-bdpad]
            L = cfg.Nside
        s_out = cfg.dtheta * 3600.0
        from .config import Settings as Stn

        Lcut = L // 8 * 8
        norm = NoiseAnal.get_norm(self.layer, Lcut,
                                  Stn.RomanFilters[cfg.use_filter], s_out)
        indata = indata[:Lcut, :Lcut]
        if win:
            w = NoiseAnal.tukey_window((Lcut, Lcut), alpha)
            norm = norm * np.average(w ** 2)
            indata = indata * w
        ps = np.empty((Lcut, Lcut), dtype=np.float64)
        rps = np.square(np.abs(np.fft.fftshift(
            np.fft.rfft2(indata), 0))) / norm
        ps[:, Lcut // 2:] = rps[:, :-1]
        ps[1:, :Lcut // 2] = rps[Lcut - 1:0:-1, Lcut // 2:0:-1]
        ps[0, :Lcut // 2] = rps[0, Lcut // 2:0:-1]
        if bin_flag:
            self.ps2d = np.average(ps.reshape(Lcut // 8, 8, Lcut // 8, 8),
                                   axis=(1, 3))
        else:
            self.ps2d = ps
        nradbins = (Lcut // 16) * (1 if bin_flag else 8)
        mean, err = NoiseAnal.azimuthal_average(self.ps2d, nradbins)
        self.ps1d = np.stack([mean, err], axis=-1)
        self.wavenumbers = NoiseAnal.get_wavenumbers(Lcut, nradbins)
        return self

    def clear(self):
        for attr in ("ps2d", "ps1d"):
            if hasattr(self, attr):
                delattr(self, attr)

    def power_spectrum(self, nbins: int = 32, L: int = None):
        """
        Azimuthally averaged 2D power spectrum of the noise layer.

        Returns (k centers [cycles/pixel], P(k)).
        """
        img = self.outimage.get_coadded_layer(self.layer)
        if L is not None:
            img = img[:L, :L]
        n = img.shape[0]
        ft = np.fft.rfft2(img - img.mean())
        p2 = np.abs(ft) ** 2 / n ** 2
        ky = np.fft.fftfreq(n)[:, None]
        kx = np.fft.rfftfreq(n)[None, :]
        kk = np.hypot(ky, kx)
        bins = np.linspace(0, 0.5 * np.sqrt(2), nbins + 1)
        which = np.digitize(kk.ravel(), bins) - 1
        pk = np.zeros(nbins)
        kc = 0.5 * (bins[1:] + bins[:-1])
        for b in range(nbins):
            sel = which == b
            if np.any(sel):
                pk[b] = np.mean(p2.ravel()[sel])
        return kc, pk
