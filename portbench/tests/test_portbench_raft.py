"""The RAFT configuration's files: ``kitti_raft`` names ``RaftReference``,
whose parameters name every parameter of the port's RAFT model; the
lookup's reader (``corr_lookup_device_ms``) on hand-built traces; and on
the card, at the cell's own size, the control and the planted faults come
out not correct while a sound run of the program on the same seed is
correct. Card tests: ``python3 -m pytest -m cuda portbench/tests``."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from portbench import calibrate, harness
from portbench.trace import STEP_SPAN, Trace

SEED = 2_345_678_901


def ev(name, start, end, device=False):
    return SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if device else DeviceType.CPU,
        time_range=SimpleNamespace(start=start, end=end), thread=1,
        is_user_annotation=False, self_device_time_total=0.0)


def ctx(trace):
    return SimpleNamespace(spans={}, trace=trace, calls=None, cfg={}, device_name="cpu")


def test_the_raft_cell_names_its_reference_and_its_weights_fit_the_port():
    cell = harness.load_cell("raft-b8")
    assert (cell.reference.__module__, cell.reference.__name__) == (
        "portbench.reference.raft", "RaftReference")
    assert [m["name"] for m in cell.per_layer if m["name"] == "corr_lookup_device_ms"]
    cfg = dict(cell.cfg, img_hw=[128, 128], batch_size=2, compute_dtype="float32")
    shapes = harness.parameter_shapes(cell.reference, cfg)
    weights = harness.make_weights(shapes, SEED, "cpu")
    model, _, _ = harness.build_program(cfg, weights, "cpu")  # raises on a name that misses
    assert sum(k.startswith("raft.") for k in shapes) == sum(
        k.startswith("raft.") for k, _ in model.named_parameters())


@pytest.mark.parametrize("kernels,want", [
    (("void cudnn::bilinear_sampler_fw_4d<float, float>(x)",
      "void cudnn::bilinear_sampler_bw_4d<float, float>(x)"), 0.045),  # (30 + 60) us over 2 steps
    (("void at::native::(anonymous namespace)::grid_sampler_2d_kernel<float, int>(x)",
      "void at::native::(anonymous namespace)::grid_sampler_2d_backward_kernel<float, int>(x)"),
     0.045),
    (("corr_lookup_fwd_kernel", "corr_lookup_bwd_kernel"), 0.045),
    (("void elementwise_kernel<mul>(x)", "void cudnn::engines_precompiled::scalePackedTensor_kernel"
      "<float, float>(long, float*, float)"), None),
])
def test_corr_lookup_device_ms(kernels, want):
    """The lookup's kernels by name, a step; nothing to read without them."""
    events = [ev(STEP_SPAN, 0, 100), ev(STEP_SPAN, 100, 200),
              ev(kernels[0], 10, 40, device=True), ev(kernels[1], 120, 180, device=True),
              ev("sm90_xmma_fprop_implicit_gemm_bf16", 50, 90, device=True)]
    got = harness.load_reader("corr_lookup_device_ms")(ctx(Trace(events, steps=2)))
    assert got == (None if want is None else pytest.approx(want))
    assert harness.load_reader("corr_lookup_device_ms")(ctx(None)) is None


@pytest.mark.cuda
def test_the_control_and_the_faults_come_out_not_correct_for_raft():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.benchmark = True
    cell = harness.load_cell("raft-b8")
    rows = calibrate.calibrate(cell, [SEED], 1, torch.device("cuda"), emit=lambda s: None)
    by = {r["kind"]: r for r in rows}

    def fails(row):
        return any(row[k] > lim for k, lim in cell.limits.items() if k in row)

    assert not fails(by["program"]), by["program"]
    assert fails(by["control_fp8_ref"]), by["control_fp8_ref"]
    assert fails(by["half_batch"]), by["half_batch"]
    assert fails(by["unchanged"]), by["unchanged"]
