"""
Row-stability diagnostics for destriped exposures.

The port's copy of ``pyimcom_tpu/diagnostics/stability.py``, so that the port imports
nothing of the JAX package; keep the two in step.

Counterpart of reference src/pyimcom/diagnostics/noise/stability.py:11-43:
load per-exposure row-median profiles from a directory of FITS images and
summarize their stability (heatmap + mean +/- std band), flagging rows whose
level drifts between exposures -- the observable the destriper is supposed
to flatten.
"""

from __future__ import annotations

import os
import re

import numpy as np

from ..fitsio import fits_read


def load_row_profiles(directory: str, name_pattern: str):
    """
    Row-median profiles of every FITS file in `directory` whose name matches
    `name_pattern` (a regex with one group naming the observation).

    Returns (row_profiles (n_images, n_rows), obsnames).
    """
    pat = re.compile(name_pattern)
    profiles = []
    obsnames = []
    for fn in sorted(os.listdir(directory)):
        m = pat.match(fn)
        if not m:
            continue
        image = np.asarray(fits_read(os.path.join(directory, fn))[0].data,
                           dtype=np.float64)
        profiles.append(np.median(image, axis=1))
        obsnames.append(m.group(1))
    return np.array(profiles), obsnames


def row_stability_stats(row_profiles: np.ndarray) -> dict:
    """
    Stability summary of row profiles over exposures: per-row mean/std,
    the global drift metric, and the worst rows.
    """
    mean_profile = np.mean(row_profiles, axis=0)
    std_profile = np.std(row_profiles, axis=0)
    worst = np.argsort(std_profile)[::-1][:10]
    return {
        "mean_profile": mean_profile,
        "std_profile": std_profile,
        "rms_drift": float(np.sqrt(np.mean(std_profile ** 2))),
        "max_drift": float(std_profile.max()) if std_profile.size else 0.0,
        "worst_rows": worst,
    }


def plot_row_stability_summary(row_profiles: np.ndarray, SCA: str,
                               outfile: str = None, pdf=None):
    """
    Heatmap of the row-median profiles plus the mean +/- std band
    (reference plot_row_stability_summary, stability.py:43+).  Saves to
    `outfile` or appends a page to an open PdfPages `pdf`.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n_images, n_rows = row_profiles.shape
    stats = row_stability_stats(row_profiles)

    fig, axes = plt.subplots(2, 1, figsize=(8, 8), sharex=True)
    im = axes[0].imshow(row_profiles, aspect="auto", origin="lower",
                        interpolation="nearest", cmap="RdBu_r")
    axes[0].set_ylabel("exposure")
    axes[0].set_title(f"SCA {SCA}: row median profiles "
                      f"(rms drift {stats['rms_drift']:.2e})")
    fig.colorbar(im, ax=axes[0], label="row median")

    rows = np.arange(n_rows)
    axes[1].plot(rows, stats["mean_profile"], lw=0.8, label="mean")
    axes[1].fill_between(rows,
                         stats["mean_profile"] - stats["std_profile"],
                         stats["mean_profile"] + stats["std_profile"],
                         alpha=0.4, label="+/- std over exposures")
    axes[1].set_xlabel("detector row")
    axes[1].set_ylabel("row median")
    axes[1].legend(loc="best", fontsize=8)
    fig.tight_layout()
    if pdf is not None:
        pdf.savefig(fig)
    elif outfile:
        fig.savefig(outfile, dpi=120)
    plt.close(fig)
    return stats
