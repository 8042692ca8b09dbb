"""The per-layer metric readers on a small recorded trace: two steps of
hand-placed host ops and device activities, whose metrics are worked out
by hand; and the device time by kernel name on a replayed step's kernels."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import harness
from portbench.flops import KernelCalls, bound_s, corr_bytes, corr_flops
from portbench.trace import STEP_SPAN, Trace


def ev(name, start, end, device=False, self_dev=0.0, thread=1):
    return SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if device else DeviceType.CPU,
        time_range=SimpleNamespace(start=start, end=end), thread=thread,
        is_user_annotation=False, self_device_time_total=self_dev)


def recorded():
    """Two steps over 0..1000 us; device busy 100-300 (conv forward),
    400-450 (corr fwd), 450-500 (ssim fwd), 600-700 (mul), 800-900 (conv
    data gradient)."""
    return [
        ev("portbench.step", 0, 500), ev("portbench.step", 500, 1000),
        ev("aten::cudnn_convolution", 50, 120, self_dev=200.0),
        ev("aten::convolution_backward", 700, 790, self_dev=100.0),
        ev("aten::mul", 550, 590, self_dev=100.0),
        ev("cudaLaunchKernel", 60, 61), ev("cudaLaunchKernel", 380, 381),
        ev("cudaLaunchKernel", 430, 431), ev("cudaLaunchKernel", 560, 561),
        ev("cudaLaunchKernel", 710, 711),
        ev("aten::copy_", 320, 390),
        ev("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64",
           100, 300, device=True),
        ev("void corr_fwd_kernel<__nv_bfloat16>(x)", 400, 450, device=True),
        ev("void ssim_fwd_kernel<__nv_bfloat16>(x)", 450, 500, device=True),
        ev("void elementwise_kernel<mul>(x)", 600, 700, device=True),
        ev("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize64x64x64",
           800, 900, device=True),
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
    assert read["conv_device_ms"] == pytest.approx(0.15)  # (200 + 100) us by name, over 2 steps
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


# kernels of a replayed geom step, by the names the profiler gives them on an
# H100 (cuDNN's and cuBLAS's among them), with their device time in us
REPLAYED = [
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x256x64", 40,
     "conv"),
    ("sm90_xmma_wgrad_indexed_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", 30, "conv"),
    ("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nchw", 25, "conv"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16, __nv_bfloat16, float>", 9,
     "conv"),
    ("void nhwcToNchwKernel<__nv_bfloat16, __nv_bfloat16, float, true, false>", 7, "conv"),
    ("void nhwcAddPaddingKernel<__nv_bfloat16, __nv_bfloat16, float, true>", 6, "conv"),
    ("nvjet_tst_64x8_64x16_4x1_v_bz_TNT", 4, "conv"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_64x64_64x4_tn_align8>", 3,
     "conv"),
    ("void convolve_common_engine_float_NHWC<__nv_bfloat16, __nv_bfloat16, 128, 5, 5, 3, 3, 3>", 2,
     "conv"),
    ("Memset (Device)", 2, "conv"),
    ("void warp_gather_kernel<unsigned char, __nv_bfloat16>(unsigned char const*, float*)", 11,
     "hand"),
    ("void corr_fwd_kernel<__nv_bfloat16>(x)", 13, "hand"),
    ("void ssim_bwd_kernel<__nv_bfloat16>(x)", 5, "hand"),
    ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl<add>>", 50, "other"),
    ("void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float, MeanOps>>", 20, "other"),
    ("void at::native::batch_norm_collect_statistics_channels_last_kernel<float>", 8, "other"),
    ("void at::native::(anonymous namespace)::reflection_pad2d_out_kernel<c10::BFloat16>", 6,
     "other"),
    ("void at::native::unrolled_elementwise_kernel<direct_copy_kernel_cuda>", 4, "other"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<FusedAdamMathFunctor>", 3,
     "other"),
]


def replayed(steps=2):
    """``steps`` replays: one graph launch each, the kernels back to back."""
    events, t = [], 0.0
    for _ in range(steps):
        step_start = t
        events.append(ev("cudaGraphLaunch", t + 1, t + 2))
        for name, us, _ in REPLAYED:
            events.append(ev(name, t + 5, t + 5 + us, device=True))
            t += us
        events.append(ev(STEP_SPAN, step_start, t + 10))
        t += 10
    return Trace(events, steps)


@pytest.mark.parametrize("steps", [1, 2])
def test_a_replayed_steps_device_time_by_kernel_name(steps):
    """Under a CUDA graph no op launches the kernels: the convolutions and
    matrix products are found by name, and with the hand-written kernels
    and the rest they make up the traced device time."""
    c = ctx(replayed(steps))
    conv = harness.load_reader("conv_device_ms")(c)
    other = harness.load_reader("other_device_ms")(c)
    want = {k: 1e-3 * sum(us for _, us, kind in REPLAYED if kind == k)
            for k in ("conv", "hand", "other")}
    assert conv == pytest.approx(want["conv"])
    assert other == pytest.approx(want["other"])
    total = 1e3 * c.trace.device_seconds() / steps
    assert conv + other + want["hand"] == pytest.approx(total)


def warp_trace(us, kernel="void warp_gather_kernel<unsigned char, __nv_bfloat16>(x)"):
    return Trace([ev(STEP_SPAN, 0, 100), ev(kernel, 10, 10 + us, device=True)], steps=1)


@pytest.mark.parametrize("impl,want_bytes", [
    # two forward calls of 1000 and 4000 pixels, the second with a backward:
    # "pallas_fused" 43 bytes a pixel a forward (source 3, coordinates 8,
    # values and weight sum 8 in bf16, planes 24), its backward elementwise;
    # "pallas" 19 a forward pixel, 27 a backward one (cotangents 8, gradients 8)
    ("pallas_fused", 43 * 5000), ("pallas", 19 * 5000 + 27 * 4000)])
def test_warp_gather_roofline(impl, want_bytes):
    calls = KernelCalls()
    calls.add("warp", "fwd", 60 * 1000, (1000,))
    calls.add("warp", "fwd", 60 * 4000, (4000,))
    calls.add("warp", "bwd", 90 * 4000, (4000,))
    c = ctx(warp_trace(20.0), calls)
    c.cfg = {"compute_dtype": "bfloat16", "warp_impl": impl, "warp_bf16": True}
    got = harness.load_reader("warp_gather_roofline")(c)
    # memory-bound at these counts: 105 operations a pixel at the f32 peak
    # take a tenth of the bytes' time
    assert got == pytest.approx(100 * want_bytes / 3.35e12 / 20e-6)
    assert 0 < got < 100


def test_warp_gather_roofline_reads_nothing_off_the_kernels_route():
    calls = KernelCalls()
    calls.add("warp", "fwd", 60 * 1000, (1000,))
    for cfg in ({"warp_impl": "xla", "warp_bf16": True},
                {"warp_impl": "pallas", "warp_bf16": False}):
        c = ctx(warp_trace(20.0), calls)
        c.cfg = dict(cfg, compute_dtype="bfloat16")
        assert harness.load_reader("warp_gather_roofline")(c) is None
    c = ctx(Trace([ev(STEP_SPAN, 0, 100)], steps=1), calls)  # no kernel ran
    c.cfg = {"compute_dtype": "bfloat16", "warp_impl": "pallas_fused", "warp_bf16": True}
    assert harness.load_reader("warp_gather_roofline")(c) is None
