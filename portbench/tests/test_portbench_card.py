"""On the card, at each cell's own size: the control and the planted faults
come out not correct, and a sound run of the program on the same seed is
correct; and on a step run op by op, the convolutions' device time by
kernel name (``trace.CONV_KERNELS``, what a replayed step is read by) is
the device time of the kernels that the convolution and matrix-product ops
launch. Run there with ``python3 -m pytest -m cuda portbench/tests``."""

from __future__ import annotations

import pytest
import torch

from portbench import calibrate, feeds, harness
from portbench.trace import CONV_KERNELS, MATRIX_OPS

SEED = 2_345_678_901
CELLS = ["geom-b8", "flow-b8", "depth-b8"]


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.benchmark = True


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_and_the_faults_come_out_not_correct(name):
    need_card()
    cell = harness.load_cell(name)
    rows = calibrate.calibrate(cell, [SEED], 1, torch.device("cuda"), emit=lambda s: None)
    by = {r["kind"]: r for r in rows}

    def fails(row):
        return any(row[k] > lim for k, lim in cell.limits.items() if k in row)

    assert not fails(by["program"]), by["program"]
    assert fails(by["control_fp8_ref"]), by["control_fp8_ref"]
    assert fails(by["half_batch"]), by["half_batch"]
    assert fails(by["unchanged"]), by["unchanged"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_convolutions_by_kernel_name_are_the_matrix_ops_kernels(name):
    need_card()
    cell = harness.load_cell(name)
    dev = torch.device("cuda")
    weights = harness.make_weights(harness.parameter_shapes(cell.reference, cell.cfg), SEED, dev)
    feed = feeds.make_feed(cell.traffic, cell.cfg, SEED, dev)
    _, _, step = harness.build_program(cell.cfg, weights, dev)
    for i in range(2):  # cuDNN's autotuning
        step.eager(feed.next(), i)
    trace = harness.traced(step.eager, feed, 2, 2)
    by_op = trace.op_seconds(MATRIX_OPS)
    assert by_op > 0
    assert trace.device_seconds(CONV_KERNELS) == pytest.approx(by_op, rel=0.03)
