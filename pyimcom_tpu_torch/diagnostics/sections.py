"""
Standard report sections: mosaic image, layer statistics, simulated-star
quality, and noise diagnostics.

The port's copy of ``pyimcom_tpu/diagnostics/sections.py``, so that the port imports
nothing of the JAX package; keep the two in step.

Counterparts of reference diagnostics/mosaicimage.py, layer_diagnostics.py,
stars.py, and noise_diagnostics.py, operating through the OutImage API.
"""

from __future__ import annotations

import glob

import numpy as np

from ..analysis import NoiseAnal, OutImage
from ..utils.moments import find_adaptive_moments
from .report import ReportSection


def _blocks_of(report):
    """All block files sharing the report's stem."""
    fname = report.fname
    stem = fname[:-11]
    return sorted(glob.glob(stem + "_[0-9][0-9]_[0-9][0-9].fits"))


class MosaicImage(ReportSection):
    """Grayscale mosaic rendering of the science layer."""

    def build(self):
        import matplotlib.pyplot as plt

        blocks = _blocks_of(self.report)
        imgs = {}
        for b in blocks:
            oi = OutImage(b)
            imgs[(oi.ibx, oi.iby)] = oi.get_coadded_layer(0)
        if not imgs:
            return
        nb = max(max(k) for k in imgs) + 1
        nside = next(iter(imgs.values())).shape[0]
        canvas = np.zeros((nb * nside, nb * nside), dtype=np.float32)
        for (ibx, iby), im in imgs.items():
            canvas[iby * nside:(iby + 1) * nside, ibx * nside:(ibx + 1) * nside] = im
        fig, ax = plt.subplots(figsize=(8, 8))
        v = np.percentile(canvas, 99.5)
        ax.imshow(np.arcsinh(canvas / max(v / 100, 1e-12)), origin="lower",
                  cmap="gray")
        ax.set_title("Mosaic science layer (asinh stretch)")
        self.figures.append(fig)
        self.add_datablock("MOSAICSTATS",
                           f"nblocks {len(imgs)}\nmax {canvas.max():.6e}\n"
                           f"p99 {np.percentile(canvas, 99):.6e}")


class LayerReport(ReportSection):
    """
    Mosaic-wide percentile statistics of every coadded layer (reference
    diagnostics/layer_diagnostics.py:67-180): the unique (pad-trimmed) area
    of every block is pooled and the reference's 13 percentiles --
    0, 0.01, 0.1, 1, 5, 25, 50, 75, 95, 99, 99.9, 99.99, 100 -- are
    measured per layer.
    """

    PCTILES = [0, 0.01, 0.1, 1, 5, 25, 50, 75, 95, 99, 99.9, 99.99, 100]

    def build(self, nblockmax: int = 100):
        import matplotlib.pyplot as plt

        blocks = _blocks_of(self.report)[:nblockmax ** 2]
        oi0 = OutImage(self.report.fname)
        cfg = oi0.cfg
        nlayer = cfg.n_inframe
        d = cfg.postage_pad * cfg.n2  # unique-area trim
        chunks = [[] for _ in range(nlayer)]
        for b in blocks:
            oi = OutImage(b)
            for il in range(nlayer):
                img = np.asarray(oi.get_coadded_layer(il), np.float32)
                if d > 0:
                    img = img[d:-d, d:-d]
                chunks[il].append(img.ravel())
            oi.unload()
        rows = []
        for il in range(nlayer):
            pct = np.percentile(np.concatenate(chunks[il]), self.PCTILES)
            chunks[il] = None
            name = cfg.extrainput[il] or "SCI"
            rows.append((name, *pct))
        fig, ax = plt.subplots(figsize=(10.5, 0.5 + 0.4 * nlayer))
        ax.axis("off")
        show = [1, 5, 25, 50, 75, 95, 99]  # table subset; datablock has all
        tab = [["layer"] + [f"p{p:g}" for p in show]] + [
            [r[0]] + [f"{r[1 + self.PCTILES.index(p)]:.3e}" for p in show]
            for r in rows]
        ax.table(cellText=tab, loc="center")
        ax.set_title(f"Layer percentiles ({len(blocks)} blocks, "
                     "unique areas)")
        self.figures.append(fig)
        text = "PCTILES " + " ".join(f"{p:g}" for p in self.PCTILES) + "\n"
        text += "\n".join(" ".join(str(x) for x in r) for r in rows)
        self.add_datablock("LAYERPERCENTILES", text)


class SimulatedStar(ReportSection):
    """Adaptive moments of injected-grid stars vs the target PSF."""

    def __init__(self, report, layer="cstar14"):
        super().__init__(report)
        self.layer = layer

    def build(self):
        import matplotlib.pyplot as plt

        oi = OutImage(self.report.fname)
        try:
            img = oi.get_coadded_layer(self.layer)
        except KeyError:
            return
        # find local maxima above threshold as star candidates
        thr = 0.2 * img.max()
        win = 8
        results = []
        work = img.copy()
        for _ in range(20):
            iy, ix = np.unravel_index(np.argmax(work), work.shape)
            if work[iy, ix] < thr:
                break
            y0, y1 = max(0, iy - win), min(img.shape[0], iy + win + 1)
            x0, x1 = max(0, ix - win), min(img.shape[1], ix + win + 1)
            if y1 - y0 > 2 * win - 2 and x1 - x0 > 2 * win - 2:
                m = find_adaptive_moments(img[y0:y1, x0:x1])
                if m.converged:
                    results.append((ix, iy, m.moments_sigma, m.observed_e1,
                                    m.observed_e2, m.moments_amp))
            work[y0:y1, x0:x1] = 0.0
        if not results:
            return
        res = np.array(results)
        target_sigma = (oi.cfg.sigmatarget * 0.11 / (oi.cfg.dtheta * 3600))
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.hist(res[:, 2], bins=10)
        ax.axvline(target_sigma, color="r", ls="--", label="target sigma")
        ax.set_xlabel("adaptive sigma [output px]")
        ax.legend()
        ax.set_title(f"Simulated stars ({self.layer}): {len(res)} measured")
        self.figures.append(fig)
        self.add_datablock(
            "STARMOMENTS",
            f"nstars {len(res)}\nsigma_mean {res[:, 2].mean():.6f}\n"
            f"sigma_target {target_sigma:.6f}\n"
            f"e1_mean {res[:, 3].mean():.2e}\ne2_mean {res[:, 4].mean():.2e}")


class NoiseReport(ReportSection):
    """
    Mosaic-wide noise power spectra (reference
    diagnostics/noise_diagnostics.py:56-709).

    For every block of the mosaic (up to `nblockmax` per side) this measures
    the Tukey-windowed power spectrum of each injected noise layer over the
    block's unique region, writes a per-block `*_ps.fits` (2D spectra +
    CONFIG copy + P1D_TABLE with wavenumber calibration), averages them into
    `*_ps_avg.fits`, renders the reference's 4-panel overview figure, and
    records per-layer variances; the per-block files are finally bundled
    into a `*_blockps*.tar` like the reference.

    Parameters (reference NoiseReport.build kwargs)
    ----------
    nblockmax : max blocks per side to consume.
    bin_flag : 1 = 8x8-bin the 2D spectra (auto-disabled for tiny blocks),
        0 = unbinned.
    alpha : Tukey window parameter; <=0 disables windowing.
    tarfiles : bundle + remove the per-block spectra files.
    """

    #: effective collecting areas [cm^2] per Roman filter index
    #: (reference noise_diagnostics.py:49-50)
    AREA_ARRAY = [22085, 4840, 7340, 7111, 7006, 6635, 9011, 0, 0, 0, 4654]

    def __init__(self, report, nblockmax=100, bin_flag=1, alpha=0.9,
                 tarfiles=True):
        super().__init__(report)
        self.nblockmax = nblockmax
        self.bin_flag = bin_flag
        self.alpha = alpha
        self.tarfiles = tarfiles

    @staticmethod
    def find_noise_layers(extrainput):
        """{layer name: input-frame index} for every noise layer, insertion
        order (reference noise_diagnostics.py:252-270)."""
        import re

        noiselayers = {}
        for i, lay in enumerate(extrainput):
            s = str(lay)
            for pat in (r"^whitenoise(\d+)$", r"^1fnoise(\d+)$",
                        r"^labnoise$", r"^noise,(\S+)$"):
                m = re.match(pat, s)
                if m:
                    noiselayers[m[0]] = i
        return noiselayers

    def _block_spectra(self, oi, noiselayers, bin_flag, win):
        """Per-layer (ps2d_all, ps1d_all) of one block, reference norm
        ((L/s_out)^2; lab noise converted to uJy/arcsec^2 first,
        noise_diagnostics.py:296-336)."""
        from ..config import Settings as Stn

        cfg = oi.cfg
        L = self.L
        bdpad = cfg.n2 * cfg.postage_pad
        s_out = cfg.dtheta * 3600.0
        s_in = Stn.pixscale_native * 648000.0 / np.pi
        filter_ = Stn.RomanFilters[cfg.use_filter][0]
        h_jy = 6.62607015e-27 * 1e29
        tfr, gain = 3.08, 1.458
        B0, B1, t_exp = 0.38, 4.65 if filter_ == "K" else 0.0, 139.8
        area = self.AREA_ARRAY[cfg.use_filter]
        whitenoisekey = next((k for k in noiselayers
                              if k.startswith("whitenoise")), None)

        NLK = list(noiselayers)
        nl = len(NLK)
        nb2 = 8 if bin_flag else 1
        ps2d_all = np.zeros((nl, L // nb2, L // nb2))
        nradbins = (L // 16) * (1 if bin_flag else 8)
        ps1d_all = np.zeros((nl, nradbins, 4))
        wavenumbers = NoiseAnal.get_wavenumbers(L, nradbins)
        for i_layer, key in enumerate(NLK):
            sl = noiselayers[key]
            indata = np.asarray(oi.get_coadded_layer(sl), dtype=np.float64)[
                bdpad:L + bdpad, bdpad:L + bdpad]
            norm = (L / s_out) ** 2
            if "lab" in key:
                norm_LN = (s_in ** 2) * area * tfr / (h_jy * gain)
                if filter_ == "K" and whitenoisekey is not None:
                    wn = np.asarray(oi.get_coadded_layer(
                        noiselayers[whitenoisekey]), dtype=np.float64)[
                        bdpad:L + bdpad, bdpad:L + bdpad]
                    indata = indata + wn * np.sqrt((B1 - B0) / t_exp) \
                        * tfr / gain
                indata = indata / norm_LN
            if win:
                w = NoiseAnal.tukey_window(indata.shape, self.alpha)
                norm = norm * np.average(w ** 2)
                indata = indata * w
            ps = np.square(np.abs(np.fft.fftshift(
                np.fft.fft2(indata)))) / norm
            if bin_flag:
                ps = np.average(ps.reshape(L // 8, 8, L // 8, 8),
                                axis=(1, 3))
            mean, err = NoiseAnal.azimuthal_average(ps, nradbins)
            ps2d_all[i_layer] = ps
            ps1d_all[i_layer, :, 0] = wavenumbers
            ps1d_all[i_layer, :, 1] = mean
            ps1d_all[i_layer, :, 2] = err
            ps1d_all[i_layer, :, 3] = sl
        return ps2d_all, ps1d_all

    def build(self):
        import os

        import matplotlib.colors as colors
        import matplotlib.pyplot as plt

        from ..config import Settings as Stn
        from ..fitsio import (HDUList, ImageHDU, TableHDU, fits_read,
                              fits_write)

        blocks = _blocks_of(self.report)
        if not blocks:
            return
        datastem = self.report.outstem + "_noise"
        win = self.alpha > 0
        bin_flag = self.bin_flag
        self.psfiles = []
        first = True
        total_2d = total_1d = None
        n_used = 0
        for b in blocks:
            oi = OutImage(b)
            if max(oi.ibx, oi.iby) >= self.nblockmax:
                continue
            cfg = oi.cfg
            if first:
                first = False
                noiselayers = self.find_noise_layers(cfg.extrainput)
                if not noiselayers:
                    return
                self.NLK = list(noiselayers)
                self.noiselayers = noiselayers
                L = cfg.Nside
                # snap to a multiple of 16 (8x8 binning + radial pairs);
                # tiny blocks disable binning (reference :236-244)
                if L >= 32:
                    L = (L // 16) * 16
                else:
                    L = (L // 2) * 2
                    bin_flag = 0
                self.L = L
                self.s_out = cfg.dtheta * 3600.0
                filter_ = Stn.RomanFilters[cfg.use_filter][0]
                configdata = np.asarray(
                    fits_read(b)["CONFIG"].data["text"])
            ps2d_all, ps1d_all = self._block_spectra(
                oi, noiselayers, bin_flag, win)
            n_used += 1
            if total_2d is None:
                total_2d = np.zeros_like(ps2d_all)
                total_1d = np.zeros_like(ps1d_all)
            total_2d += ps2d_all
            total_1d += ps1d_all

            blockid = f"{filter_}_{oi.ibx:02d}_{oi.iby:02d}"
            if win:
                blockid += f"_alpha_{self.alpha}"
            if bin_flag == 0:
                blockid += "_nobin"
            self.suffix = blockid[len(filter_) + 6:]
            hdu = ImageHDU(ps2d_all.astype(np.float32))
            hdu.header["INSTEM"] = self.report.fname[:-11]
            hdu.header["MEANCOVG"] = float(oi.get_mean_coverage())
            hdu.header["NLAYERS"] = len(noiselayers)
            for il, key in enumerate(self.NLK):
                hdu.header[f"LAYER{il:02d}"] = key
            hdu.header["AREAUNIT"] = "arcsec**2"
            p1 = ps1d_all.reshape(-1, 4)
            tab = TableHDU(data={
                "Wavenumber": p1[:, 0].astype(np.float32),
                "Power": p1[:, 1].astype(np.float32),
                "Error": p1[:, 2].astype(np.float32),
                "NoiseLayerID": p1[:, 3].astype(np.int16)},
                name="P1D_TABLE")
            cfgtab = TableHDU(data={"text": configdata}, name="CONFIG")
            fname = f"{datastem}_{blockid}_ps.fits"
            fits_write(fname, HDUList([hdu, cfgtab, tab]))
            self.psfiles.append(fname)

        if n_used == 0:
            return
        # ---- mosaic average (reference average_spectra, :562-633) --------
        total_2d /= n_used
        total_1d /= n_used
        avg = ImageHDU(total_2d.astype(np.float32))
        src = fits_read(self.psfiles[0])[0].header
        for key in (["INSTEM", "NLAYERS"]
                    + [f"LAYER{il:02d}" for il in range(len(self.NLK))]
                    + ["AREAUNIT"]):
            avg.header[key] = src[key]
        p1 = total_1d.reshape(-1, 4)
        tab = TableHDU(data={
            "Wavenumber": p1[:, 0].astype(np.float32),
            "Power": p1[:, 1].astype(np.float32),
            "Error": p1[:, 2].astype(np.float32),
            "NoiseLayerID": p1[:, 3].astype(np.int16)}, name="P1D_TABLE")
        avgfile = f"{datastem}_{filter_}{self.suffix}_ps_avg.fits"
        fits_write(avgfile, HDUList([avg, tab]))

        # ---- overview figure (reference gen_overview_fig, :636-709) ------
        outslab = [None] * 4
        for il, key in enumerate(self.NLK):
            if key.startswith("whitenoise"):
                outslab[0] = il
            if key.startswith("1fnoise"):
                outslab[1] = il
            if key.startswith("labnoise"):
                outslab[2] = il
            if key.startswith("noise,") and "b" in key:
                outslab[3] = il
        ntypes = ["white", "1/f", "lab", "simulated"]
        vmax = [0.01, 0.3, 0.05, 5e-5]
        um = 0.5 / self.s_out
        fig = plt.figure(figsize=(9, 5.5))
        for k in range(4):
            if outslab[k] is None:
                continue
            ax = fig.add_subplot(2, 2, k + 1)
            ax.set_title(f"Power spectrum: {ntypes[k]} noise")
            ax.set_xlabel("u [cycles/arcsec]")
            ax.set_ylabel("v [cycles/arcsec]")
            data = total_2d[outslab[k]]
            im = ax.imshow(data, cmap="gnuplot", aspect=1,
                           interpolation="nearest", origin="lower",
                           extent=(-um, um, -um, um),
                           norm=colors.LogNorm(vmin=vmax[k] / 300.0,
                                               vmax=vmax[k] * 1.0000001,
                                               clip=True))
            fig.colorbar(im, ax=ax, location="right")
        fig.tight_layout()
        self.figures.append(fig)

        # 1D spectra figure (all layers, wavenumber-calibrated)
        f1, a1 = plt.subplots(figsize=(7, 4.5))
        for il, key in enumerate(self.NLK):
            a1.errorbar(total_1d[il, 1:, 0] / self.s_out,
                        total_1d[il, 1:, 1], yerr=total_1d[il, 1:, 2],
                        fmt="o-", ms=3, label=key)
        a1.set_xlabel("k [cycles/arcsec]")
        a1.set_ylabel("P(k)")
        a1.set_yscale("log")
        a1.legend(fontsize=7)
        a1.set_title(f"Mosaic-average noise spectra ({n_used} blocks)")
        self.figures.append(f1)

        # ---- machine-readable variances (reference :127-135) -------------
        lines = [f"nblocks {n_used}"]
        for il, key in enumerate(self.NLK):
            name = str(cfg.extrainput[self.noiselayers[key]])
            lines.append(f"LAYER{il:02d} {name:24s} "
                         f"{np.average(total_2d[il]) / self.s_out ** 2:11.5E}")
            lines.append(f"{key} ps1d "
                         + " ".join(f"{v:.5e}" for v in total_1d[il, :, 1]))
        lines.append(f"AVGFILE {os.path.basename(avgfile)}")

        # ---- tarball (reference :138-151) --------------------------------
        if self.tarfiles and self.psfiles:
            import tarfile

            tarname = f"{datastem}_blockps{self.suffix}.tar"
            with tarfile.open(tarname, "w") as tf:
                for f in self.psfiles:
                    tf.add(f, arcname=os.path.basename(f))
            for f in self.psfiles:
                os.remove(f)
            lines.append(f"TARFILE {os.path.basename(tarname)}")
            lines.extend(f"BUNDLED {os.path.basename(f)}"
                         for f in self.psfiles)
        self.add_datablock("NOISEPOWER", "\n".join(lines))


class DynamicRange(ReportSection):
    """Noise/coverage histograms + star dynamic-range profiles
    (reference diagnostics/dynrange.py via stars.py)."""

    def build(self):
        import matplotlib.pyplot as plt

        from .starsdata import gen_dynrange_data

        fname = self.report.fname
        stem = fname[:-11]

        def infile(ibx, iby):
            return f"{stem}_{ibx:02d}_{iby:02d}.fits"

        out = gen_dynrange_data(infile, self.report.outstem)
        if out["COUNTBLOCK"] == 0:
            return
        lines = [f"countblock {out['COUNTBLOCK']}"]
        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
        for ax, key, label in ((axes[0], "SQRTS", "noise amplification"),
                               (axes[1], "NEFF", "effective coverage")):
            if out[key] is None:
                continue
            h = np.loadtxt(out[key])
            ax.bar(h[:, 0], h[:, 1], width=h[1, 0] - h[0, 0])
            ax.set_xlabel(label)
            pk, off = out[key + "_HEADER"]
            lines.append(f"{key} peak {pk:.0f} offscale_pct {off:.4f}")
        self.figures.append(fig)
        if out["DYNRANGE"] is not None:
            prof = np.loadtxt(out["DYNRANGE"])
            fig2, ax2 = plt.subplots(figsize=(6, 4))
            for i, q in enumerate((1, 5, 25, 50, 75, 95, 99)):
                ax2.semilogy(prof[:, 0], np.abs(prof[:, 2 + i]) + 1e-12,
                             label=f"p{q}")
            ax2.set_xlabel("radius [px]")
            ax2.legend(fontsize=6)
            ax2.set_title("star profile percentiles")
            self.figures.append(fig2)
            lines.append("dynrange rows " + str(prof.shape[0]))
        self.add_datablock("DYNRANGE", "\n".join(lines))


class StarCube(ReportSection):
    """Noiseless injected-star cube moments + fidelity histogram
    (reference diagnostics/starcube_nonoise.py via stars.py)."""

    def build(self):
        import matplotlib.pyplot as plt

        from .starsdata import gen_starcube_nonoise

        fname = self.report.fname
        stem = fname[:-11]

        def infile(ibx, iby):
            return f"{stem}_{ibx:02d}_{iby:02d}.fits"

        out = gen_starcube_nonoise(infile, self.report.outstem)
        if out["STARCAT"] is None:
            return
        cat = np.loadtxt(out["STARCAT"]).reshape(-1, 22)
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.scatter(cat[:, 14], cat[:, 15], s=4)
        ax.set_xlabel("g1")
        ax.set_ylabel("g2")
        ax.set_title(f"noiseless star shapes (n={len(cat)})")
        self.figures.append(fig)
        self.add_datablock(
            "STARCUBE",
            f"nstars {len(cat)}\nsigma_med {np.median(cat[:, 13]):.6f}\n"
            f"g1_med {np.median(cat[:, 14]):.2e}\n"
            f"g2_med {np.median(cat[:, 15]):.2e}\n"
            f"fid_med_dB {np.median(cat[:, 20]):.2f}")


class RowStability(ReportSection):
    """
    Row-stability diagnostics of destriped exposures (reference
    diagnostics/noise/stability.py): heatmap + mean/std band of per-exposure
    row-median profiles, grouped by SCA.

    Parameters
    ----------
    directory : directory of destriped FITS exposures (imdestripe output);
        when None the section is skipped (coadd-only reports).
    pattern : regex with group(1) = observation name and group(2) = SCA.
    """

    def __init__(self, report, directory=None,
                 pattern=r"ds_(\w+_\d+)_(\d+)\.fits$"):
        super().__init__(report)
        self.directory = directory
        self.pattern = pattern

    def build(self):
        import os
        import re

        import matplotlib.pyplot as plt

        from .stability import row_stability_stats

        if not self.directory or not os.path.isdir(self.directory):
            return
        from ..fitsio import fits_read

        pat = re.compile(self.pattern)
        by_sca = {}
        for fn in sorted(os.listdir(self.directory)):
            m = pat.search(fn)
            if not m:
                continue
            img = np.asarray(fits_read(os.path.join(self.directory, fn))[0].data,
                             dtype=np.float64)
            by_sca.setdefault(m.group(2), []).append(np.median(img, axis=1))

        lines = []
        for sca, profiles in sorted(by_sca.items()):
            rp = np.array(profiles)
            stats = row_stability_stats(rp)
            fig, axes = plt.subplots(2, 1, figsize=(8, 7), sharex=True)
            axes[0].imshow(rp, aspect="auto", origin="lower",
                           interpolation="nearest", cmap="RdBu_r")
            axes[0].set_ylabel("exposure")
            axes[0].set_title(f"SCA {sca}: row stability "
                              f"(rms drift {stats['rms_drift']:.3e})")
            rows = np.arange(rp.shape[1])
            axes[1].plot(rows, stats["mean_profile"], lw=0.8)
            axes[1].fill_between(rows,
                                 stats["mean_profile"] - stats["std_profile"],
                                 stats["mean_profile"] + stats["std_profile"],
                                 alpha=0.4)
            axes[1].set_xlabel("detector row")
            fig.tight_layout()
            self.figures.append(fig)
            lines.append(f"{sca} {rp.shape[0]} {stats['rms_drift']:.6e} "
                         f"{stats['max_drift']:.6e}")
        if lines:
            self.add_datablock("ROWSTABILITY",
                               "sca n_exposures rms_drift max_drift\n"
                               + "\n".join(lines))
