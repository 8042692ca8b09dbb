"""The per-layer metric readers on a small recorded trace: two steps of
hand-placed host ops and device activities, whose metrics are worked out
by hand."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import harness
from portbench.flops import KernelCalls, bound_s, corr_bytes, corr_flops
from portbench.trace import Trace


def ev(name, start, end, device=False, self_dev=0.0, thread=1):
    return SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if device else DeviceType.CPU,
        time_range=SimpleNamespace(start=start, end=end), thread=thread,
        is_user_annotation=False, self_device_time_total=self_dev)


def recorded():
    """Two steps over 0..1000 us; device busy 100-300 (conv), 400-450
    (corr fwd), 450-500 (ssim fwd), 600-700 (mul), 800-900 (conv)."""
    return [
        ev("portbench.step", 0, 500), ev("portbench.step", 500, 1000),
        ev("aten::cudnn_convolution", 50, 120, self_dev=200.0),
        ev("aten::convolution_backward", 700, 790, self_dev=100.0),
        ev("aten::mul", 550, 590, self_dev=100.0),
        ev("cudaLaunchKernel", 60, 61), ev("cudaLaunchKernel", 380, 381),
        ev("cudaLaunchKernel", 430, 431), ev("cudaLaunchKernel", 560, 561),
        ev("cudaLaunchKernel", 710, 711),
        ev("aten::copy_", 320, 390),
        ev("void cudnn_conv_kernel<float>(float*)", 100, 300, device=True),
        ev("void corr_fwd_kernel<__nv_bfloat16>(x)", 400, 450, device=True),
        ev("void ssim_fwd_kernel<__nv_bfloat16>(x)", 450, 500, device=True),
        ev("void elementwise_kernel<mul>(x)", 600, 700, device=True),
        ev("void cudnn_dgrad_kernel(x)", 800, 900, device=True),
    ]


def ctx(trace, calls=None, spans=None):
    return SimpleNamespace(spans=spans or {}, trace=trace, calls=calls or KernelCalls(),
                           cfg={"compute_dtype": "bfloat16"}, device_name="NVIDIA H100 80GB HBM3")


def test_trace_sums():
    t = Trace(recorded(), steps=2)
    assert t.window_s == pytest.approx(1000e-6)
    assert t.busy_s == pytest.approx(500e-6)
    assert t.launch_calls == 5
    assert t.device_seconds(("corr_fwd_kernel",)) == pytest.approx(50e-6)
    gaps = dict(t.idle_gaps())
    # the innermost host op open at each gap's middle: 350, 550, 750
    assert gaps == pytest.approx({"aten::copy_": 100e-6, "aten::mul": 100e-6,
                                  "aten::convolution_backward": 100e-6})


def test_readers():
    t = Trace(recorded(), steps=2)
    calls = KernelCalls()
    calls.add("correlation", "fwd", corr_flops(2, 8, 16, 32, 4), (2, 8, 16, 32, 4, 2))
    c = ctx(t, calls, spans={"step": [0.01, 0.03]})
    read = {n: harness.load_reader(n)(c) for n in (
        "host_ms_per_step", "launch_calls_per_step", "conv_device_ms", "other_device_ms",
        "idle_share", "cost_volume_roofline", "ssim_roofline", "loader_wait_ms")}
    assert read["host_ms_per_step"] == pytest.approx(20.0)
    assert read["launch_calls_per_step"] == pytest.approx(2.5)
    assert read["conv_device_ms"] == pytest.approx(0.15)  # (200 + 100) us over 2 steps
    # all 500 us less 300 conv less 100 hand-written, over 2 steps
    assert read["other_device_ms"] == pytest.approx(0.05)
    assert read["idle_share"] == pytest.approx(0.5)
    fwd_bytes, _ = corr_bytes(2, 8, 16, 32, 4, 2)
    want = bound_s(fwd_bytes, corr_flops(2, 8, 16, 32, 4), "bfloat16", "NVIDIA H100 80GB HBM3")
    assert read["cost_volume_roofline"] == pytest.approx(100 * want / 25e-6)
    assert read["ssim_roofline"] is None  # no SSIM call recorded: no bound
    assert read["loader_wait_ms"] is None


def test_readers_without_a_trace_return_nothing():
    c = ctx(None)
    for name in ("launch_calls_per_step", "conv_device_ms", "other_device_ms", "idle_share",
                 "cost_volume_roofline", "ssim_roofline", "host_ms_per_step"):
        assert harness.load_reader(name)(c) is None
