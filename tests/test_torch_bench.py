"""The port's bench entry, pyimcom_tpu_torch.bench, against bench.py.

On the reduced survey of test_torch_block.py (4 stamps of block 1): the
reference's bench.run_region (its device group engine on one device) and
the port's run_region on the CPU give outputs within
test_torch_block.compare_outputs_f32's bounds (science to 1e-8 of its scale
or one float32 ulp, maps to 1 LSB), and so the same SL1 to 1e-9 and U/C
medians within one FIDELITY step (a factor 10**(1/5000)).  The port's
quality_check equals bench.quality_check on the same files; the line has
bench.py's four keys; vs_baseline is taken from .bench_cpu_baseline.json
only for a fixture of the recorded geometry (bench._fixture_key); the
entry prints one such line.
"""

import json
from pathlib import Path

import pytest
import torch

import bench as ref_bench
from test_torch_block import compare_outputs_f32, reference_block, small_survey  # noqa: F401
from pyimcom_tpu_torch import bench

torch.set_num_threads(1)
KEYS = {"metric", "value", "unit", "vs_baseline"}
LSB = 10 ** (1 / 5000)          # one step of the FIDELITY encoding


@pytest.fixture(scope="module")
def blocks(small_survey, reference_block):
    """(reference output, the port's bench_block result) at 4 stamps: the
    reference's run_region is test_torch_block.reference_block, made once
    for the session."""
    ref_out = reference_block
    port = bench.bench_block(dict(small_survey, OUT=small_survey["OUT"] + "_bport"),
                             device="cpu", stop=4, warmup=False)
    return ref_out, port


def test_quality_check_equals_reference(blocks):
    ref_out, (_line, blk, _SL1, _uc) = blocks
    for path in (ref_out, blk.outstem + ".fits"):
        assert bench.quality_check(path) == ref_bench.quality_check(path)


def test_bench_block_matches_reference(blocks):
    ref_out, (line, blk, SL1, uc) = blocks
    compare_outputs_f32(ref_out, blk.outstem + ".fits")
    SL1_ref, uc_ref = ref_bench.quality_check(ref_out)
    assert abs(SL1 - SL1_ref) < 1e-9, (SL1, SL1_ref)
    assert uc_ref / LSB <= uc <= uc_ref * LSB, (uc, uc_ref)
    assert blk.nrun == 4 and len(blk.stamp_stats) == 4
    assert set(line) == KEYS and line["metric"] == "blocks/hour" and line["value"] > 0
    assert f"SL1={SL1:.5f}" in line["unit"] and "4/16 stamps" in line["unit"]
    assert " on cpu " in line["unit"]


def test_vs_baseline_only_for_the_recorded_fixture():
    from survey_fixture_torch import CONFIG_TEMPLATE

    record = json.loads((Path(bench.REPO) / ".bench_cpu_baseline.json").read_text())
    cfg = dict(CONFIG_TEMPLATE, EXTRAINPUT=["cstar14"])        # the bench survey
    assert bench.fixture_key(cfg) == ref_bench._fixture_key(cfg) == record["fixture_key"]
    assert bench.cpu_baseline(cfg) == record
    line = bench.line(2.0, 16, 1.0, 3e-7, "cpu", bench.cpu_baseline(cfg))
    assert set(line) == KEYS
    assert line["vs_baseline"] == pytest.approx(line["value"] / (3600.0 / record["t_block_cpu"]),
                                                rel=1e-12)
    other = dict(cfg, INPAD=0.3)
    assert bench.cpu_baseline(other) is None
    assert bench.line(2.0, 16, 1.0, 3e-7, "cpu", None)["vs_baseline"] is None


def test_entry_prints_the_line(small_survey, tmp_path, monkeypatch, capsys):
    """`python -m pyimcom_tpu_torch.bench --device cpu --stop 2` on the
    reduced survey (its cfg.json in the entry's work directory): a cold and
    a measured run, then one JSON line as its last output."""
    work = tmp_path / "work"
    (work / "bench").mkdir(parents=True)
    cfg = dict(small_survey, OUT=small_survey["OUT"] + "_entry")
    (work / "bench" / "cfg.json").write_text(json.dumps(cfg))
    monkeypatch.setattr(bench, "WORK", work)
    assert bench.main(["--device", "cpu", "--stop", "2"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    line = json.loads(last)
    assert set(line) == KEYS and line["value"] > 0 and "2/16 stamps" in line["unit"]
    assert line["vs_baseline"] is None           # the reduced survey is not the record's
