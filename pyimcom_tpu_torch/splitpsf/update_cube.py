"""
Iteration bookkeeping for the PSF-splitting loop.

The port's copy of ``pyimcom_tpu/splitpsf/update_cube.py`` (host file
handling only); keep the two in step.

Counterpart of reference src/pyimcom/splitpsf/update_cube.py: after a wing
subtraction pass produces *_subI.fits images, atomically swap them into the
input-layer cache, archive the previous iteration, and advance the
``_iter.txt`` counter / ``_oldcfg.json`` config history.
"""

from __future__ import annotations

import glob
import json
import os
import shutil


def get_iteration(inlayercache: str) -> int:
    """Current iteration counter (0 if none recorded)."""
    iterfile = inlayercache + "_iter.txt"
    if os.path.exists(iterfile):
        with open(iterfile) as f:
            return int(f.read().split()[0])
    return 0


def update(cfg, subI_suffix: str = "_subI.fits", archive: bool = True) -> int:
    """
    Swap wing-subtracted images into the cache; returns the new iteration.

    For each cached layer file <cache>_OBSID_SCA.fits with a sibling
    <cache>_OBSID_SCA<subI_suffix>, the subtracted file replaces the cached
    one (atomically, via os.replace); the previous file is archived to
    <cache>.iterN/ when `archive`.
    """
    cache = cfg.inlayercache
    if not cache:
        raise ValueError("update_cube requires INLAYERCACHE to be set")
    it = get_iteration(cache)

    arch_dir = f"{cache}.iter{it}"
    sub_files = sorted(glob.glob(cache + "_*" + subI_suffix))
    if sub_files and archive:
        os.makedirs(arch_dir, exist_ok=True)

    n_swapped = 0
    for sub in sub_files:
        orig = sub[: -len(subI_suffix)] + ".fits"
        if not os.path.exists(orig):
            continue
        if archive:
            shutil.copy2(orig, os.path.join(arch_dir, os.path.basename(orig)))
        os.replace(sub, orig)
        n_swapped += 1

    # advance counter and append config history
    with open(cache + "_iter.txt.tmp", "w") as f:
        f.write(f"{it + 1}\n")
    os.replace(cache + "_iter.txt.tmp", cache + "_iter.txt")

    oldcfg = cache + "_oldcfg.json"
    history = []
    if os.path.exists(oldcfg):
        with open(oldcfg) as f:
            try:
                history = json.load(f)
            except json.JSONDecodeError:
                history = []
    history.append({"iteration": it, "config": cfg.to_dict()})
    with open(oldcfg + ".tmp", "w") as f:
        json.dump(history, f, indent=1)
    os.replace(oldcfg + ".tmp", oldcfg)

    print(f"update_cube: swapped {n_swapped} files; iteration -> {it + 1}")
    return it + 1


def main(cfgfile):
    """python -m pyimcom_tpu_torch.splitpsf.update_cube <config.json>
    (reference update_cube CLI, update_cube.py:43-136)."""
    from ..config import Config

    return update(Config(cfgfile))


if __name__ == "__main__":
    import sys

    main(sys.argv[1])
