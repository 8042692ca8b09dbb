"""The reflection pad's reader (``reflect_pad_device_ms``) on hand-built
traces: it reads ATen's pad kernels, which the parent of the port's own
pair ran, and the port's ``reflect_pad`` kernels alike, and nothing on a
trace with neither; and the cells that declare it."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import harness
from portbench.trace import STEP_SPAN, Trace


def ev(name, start, end, device=False):
    return SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if device else DeviceType.CPU,
        time_range=SimpleNamespace(start=start, end=end), thread=1,
        is_user_annotation=False, self_device_time_total=0.0)


def ctx(trace):
    return SimpleNamespace(spans={}, trace=trace, calls=None, cfg={}, device_name="cpu")


@pytest.mark.parametrize("kernels,want", [
    (("void at::native::(anonymous namespace)::reflection_pad2d_out_kernel<c10::BFloat16>(x)",
      "void at::native::(anonymous namespace)::reflection_pad2d_backward_out_kernel"
      "<c10::BFloat16>(x)"), 0.045),  # (30 + 60) us over 2 steps
    (("void reflect_pad_fwd_kernel<__nv_bfloat16, 8>(Chunk<__nv_bfloat16, 8> const*, x)",
      "void reflect_pad_bwd_kernel<__nv_bfloat16, 8>(Chunk<__nv_bfloat16, 8> const*, x)"),
     0.045),
    (("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16>(x)",
      "void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl<add>>"), None),
])
def test_reflect_pad_device_ms(kernels, want):
    """The pad's kernels by name, a step; nothing to read without them."""
    events = [ev(STEP_SPAN, 0, 100), ev(STEP_SPAN, 100, 200),
              ev(kernels[0], 10, 40, device=True), ev(kernels[1], 120, 180, device=True),
              ev("sm90_xmma_fprop_implicit_gemm_bf16", 50, 90, device=True)]
    read = harness.load_reader("reflect_pad_device_ms")
    got = read(ctx(Trace(events, steps=2)))
    assert got == (None if want is None else pytest.approx(want))
    assert read(ctx(None)) is None


@pytest.mark.parametrize("cell,declared", [("geom-b8", True), ("depth-b8", True),
                                           ("flow-b8", False), ("raft-b8", False)])
def test_the_cells_with_a_depth_decoder_declare_the_pad(cell, declared):
    names = [m["name"] for m in harness.load_cell(cell).per_layer]
    assert ("reflect_pad_device_ms" in names) == declared
