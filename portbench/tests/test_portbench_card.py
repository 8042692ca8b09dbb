"""On the card, at each cell's own size: the control and the planted faults
come out not correct, and a sound run of the program on the same seed is
correct. Run there with ``python3 -m pytest -m cuda portbench/tests``."""

from __future__ import annotations

import pytest
import torch

from portbench import calibrate, harness

SEED = 2_345_678_901


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["geom-b8", "flow-b8"])
def test_the_control_and_the_faults_come_out_not_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.benchmark = True
    cell = harness.load_cell(name)
    rows = calibrate.calibrate(cell, [SEED], 1, torch.device("cuda"), emit=lambda s: None)
    by = {r["kind"]: r for r in rows}

    def fails(row):
        return any(row[k] > lim for k, lim in cell.limits.items() if k in row)

    assert not fails(by["program"]), by["program"]
    assert fails(by["control_fp8_ref"]), by["control_fp8_ref"]
    assert fails(by["half_batch"]), by["half_batch"]
    assert fails(by["unchanged"]), by["unchanged"]
