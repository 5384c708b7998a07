#!/usr/bin/env python3
"""
Warm bench-block phase times of one or more checkouts of pyimcom_tpu_torch
on one CUDA GPU, run alternately so that they share the card and the host.

    python3 block_phases.py [ROOT ...] [--rounds 2] [--warm 3]

Each ROOT is the top directory of a checkout (default: this one), for
example an earlier commit unpacked with ``git archive`` into a git-ignored
directory.  The runs go A B ... then ... B A (``--rounds`` passes, every
other one reversed), each in a fresh process that imports ROOT's
``pyimcom_tpu_torch`` and ``tests/survey_fixture_torch``, builds the bench
survey of chip_smoke.py (BASELINE.json configs[0]: 8 exposures, cstar14,
block 1, 16 stamps, single-kappa Cholesky) under ROOT/.smoke_work_phases,
runs one cold block and ``--warm`` warm blocks, and prints one JSON line:
the card, the cold and warm blocks' seconds, and each warm block's host
seconds and CUDA-event milliseconds per phase (``Block.phase_times()``).
The last line holds, per ROOT, the medians over all its warm blocks.
Exits 2 without a CUDA GPU.
"""

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

# the phases whose medians the summary line gives
PHASES = ("block.inputs", "psf.sample_group", "stamp.plan", "stamp.sweep",
          "stamp.assembleA", "stamp.solve")


def gpu_name_and_power():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def one(root: Path, warm: int) -> None:
    """Cold then `warm` warm bench blocks with ROOT's package; one JSON line."""
    sys.path[0:1] = [str(root), str(root / "tests")]   # in place of this file's directory
    import torch

    if not torch.cuda.is_available():
        sys.exit(2)
    from survey_fixture_torch import build_survey

    from pyimcom_tpu_torch import coadd

    work = root / ".smoke_work_phases"
    shutil.rmtree(work, ignore_errors=True)
    cfg = build_survey(work, n_obs=8, extrainput=["cstar14"])

    def run(suffix):
        d = dict(cfg, OUT=cfg["OUT"] + suffix)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blk = coadd.Block(cfg=coadd.Config(d), this_sub=1, device="cuda")
        torch.cuda.synchronize()
        return time.perf_counter() - t0, blk.phase_times()

    cold_s, _ = run("_cold")
    runs = [run(f"_warm{i}") for i in range(warm)]
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({
        "root": str(root), "gpu": gpu_name_and_power(), "cold_s": cold_s,
        "block_s": [t for t, _ in runs],
        "phases": [{k: {"host_s": v["host_s"], "device_ms": v["device_ms"], "calls": v["calls"]}
                    for k, v in ph.items()} for _, ph in runs]}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one is not None:
        one(a.one.resolve(), a.warm)
        return 0
    roots = [r.resolve() for r in a.roots] or [Path(__file__).resolve().parent]
    order = [r for i in range(a.rounds) for r in (roots if i % 2 == 0 else roots[::-1])]
    got = {str(r): [] for r in roots}
    for root in order:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one",
                               str(root), "--warm", str(a.warm)],
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        got[str(root)].append(json.loads(line))

    def med(xs):
        return statistics.median(xs) if xs else None

    summary = {}
    for root, recs in got.items():
        phases = [ph for rec in recs for ph in rec["phases"]]
        summary[root] = {
            "warm_blocks": len(phases),
            "block_s": med([t for rec in recs for t in rec["block_s"]]),
            "host_s": {k: med([ph[k]["host_s"] for ph in phases if k in ph]) for k in PHASES},
            "device_ms": {k: med([ph[k]["device_ms"] for ph in phases if k in ph])
                          for k in PHASES}}
    print(json.dumps({"gpu": got[str(roots[0])][0]["gpu"], "order": [str(r) for r in order],
                      "median": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
