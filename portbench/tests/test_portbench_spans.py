"""The readers of the port's program spans (``portbench/spans.py``) on
hand-built traces, whose self times, idle overlaps and op counts are worked
out by hand, and on a real CPU profiler session."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from portbench import harness
from portbench.spans import busy_within
from portbench.trace import STEP_SPAN, Trace

LAYERS = ("networks", "loss_graph", "backward", "optimizer")
READERS = [f"{layer}_{kind}" for kind in ("host_ms", "idle_ms") for layer in LAYERS] + [
    "loss_graph_ops_per_step"]


def ev(name, start, end, device=False, thread=1):
    return SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if device else DeviceType.CPU,
        time_range=SimpleNamespace(start=start, end=end), thread=thread,
        is_user_annotation=False, self_device_time_total=0.0)


def one_step(t0):
    """A step over t0..t0+1000 us. Self times: net.depth 100; the loss graph
    480 (train_step.forward 280, loss.recon 100, loss.terms 100); backward
    200; optimizer 180. Device busy 50-120, 250-280, 450-650, 900-1000."""
    host = [
        (STEP_SPAN, 0, 1000), ("train_step", 10, 990), ("train_step.forward", 20, 600),
        ("net.depth", 30, 130), ("aten::cudnn_convolution", 30, 100), ("aten::empty", 31, 32),
        ("aten::sub", 150, 160),  # in the forward's own time: a loss-graph op
        ("loss.recon", 200, 300), ("aten::mul", 210, 220), ("aten::add", 230, 240),
        ("aten::empty", 231, 232),  # inside aten::add: not top level
        ("loss.terms", 400, 500), ("aten::mean", 400, 420),
        ("train_step.backward", 600, 800), ("aten::zeros", 605, 606),
        ("train_step.optimizer", 800, 980), ("Optimizer.step#Adam.step", 810, 970),
        ("aten::_foreach_add_", 820, 830),
        ("cudaLaunchKernel", 215, 216),
    ]
    device = [("conv", 50, 120), ("mul", 250, 280), ("mean", 450, 650), ("adam", 900, 1000)]
    return ([ev(n, t0 + s, t0 + e) for n, s, e in host]
            + [ev(n, t0 + s, t0 + e, device=True) for n, s, e in device]
            + [ev("aten::add", t0 + 700, t0 + 750, thread=2)])  # autograd's thread


def ctx(trace):
    return SimpleNamespace(spans={}, trace=trace, calls=None, cfg={}, device_name="cpu")


def read_all(c):
    return {n: harness.load_reader(n)(c) for n in READERS}


def test_readers_on_a_hand_built_trace():
    t = Trace(one_step(0) + one_step(1000), steps=2)
    got = read_all(ctx(t))
    assert got["networks_host_ms"] == pytest.approx(0.100)
    assert got["loss_graph_host_ms"] == pytest.approx(0.480)
    assert got["backward_host_ms"] == pytest.approx(0.200)
    assert got["optimizer_host_ms"] == pytest.approx(0.180)
    # net.depth 30-130 less 50-120; the forward's own 20-30, 130-200,
    # 300-400, 500-600 less 500-600, loss.recon less 250-280, loss.terms
    # less 450-500; backward less 600-650; optimizer less 900-980
    assert got["networks_idle_ms"] == pytest.approx(0.030)
    assert got["loss_graph_idle_ms"] == pytest.approx((180 + 70 + 50) / 1e3)
    assert got["backward_idle_ms"] == pytest.approx(0.150)
    assert got["optimizer_idle_ms"] == pytest.approx(0.100)
    # aten::sub, aten::mul, aten::add, aten::mean
    assert got["loss_graph_ops_per_step"] == pytest.approx(4.0)


def test_readers_without_spans_read_nothing():
    """A program that marks no spans, or no trace at all: no reading."""
    plain = [e for e in one_step(0) if e.name in (STEP_SPAN, "aten::mul") or
             e.device_type != DeviceType.CPU]
    assert all(v is None for v in read_all(ctx(Trace(plain, steps=1))).values())
    assert all(v is None for v in read_all(ctx(None)).values())


def test_a_layer_without_spans_reads_nothing():
    """A trace with the train step's spans but no network span (the flow
    step of an older program, say): the networks' readers give nothing,
    the others read."""
    t = Trace([e for e in one_step(0) if not e.name.startswith("net.")], steps=1)
    got = read_all(ctx(t))
    assert got["networks_host_ms"] is None and got["networks_idle_ms"] is None
    # the convolution now sits in the forward's own time
    assert got["loss_graph_host_ms"] == pytest.approx(0.580)
    assert got["loss_graph_ops_per_step"] == pytest.approx(5.0)


@pytest.mark.parametrize("s,e,want", [(0, 40, 0), (0, 60, 10), (55, 65, 10), (100, 300, 70),
                                      (240, 270, 20), (260, 500, 20), (700, 800, 0)])
def test_busy_within(s, e, want):
    segs = [[50, 100], [200, 250], [260, 280]]
    assert busy_within(segs, s, e) == pytest.approx(want)


def test_readers_on_a_cpu_profiler_session():
    """Real events: the port's spans around ATen ops, two steps under
    ``torch.profiler`` on the CPU (no device activity, so every span's self
    time is idle)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from unsupervised_depth_opticalflow_egomotion_torch.utils.profiler import span

    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(2):
            with record_function(STEP_SPAN), span("train_step", i):
                with span("train_step.forward"):
                    with span("net.depth"):
                        y = x @ x
                    with span("loss.terms"):
                        loss = (y * 2.0).sum()
                    loss = loss + 1.0
                with span("train_step.optimizer"):
                    x.add_(0.0)
    t = Trace(prof.events(), steps=2)
    got = read_all(ctx(t))
    assert all(v is not None and v > 0 for k, v in got.items() if not k.startswith("backward"))
    assert got["backward_host_ms"] is None
    for layer in ("networks", "loss_graph", "optimizer"):
        assert got[f"{layer}_idle_ms"] == pytest.approx(got[f"{layer}_host_ms"])
    # aten::mul and aten::sum in loss.terms, aten::add in the forward's own time
    assert got["loss_graph_ops_per_step"] == pytest.approx(3.0)
    steps = [e - s for s, e, n in t.host if n == STEP_SPAN]
    assert sum(got[f"{layer}_host_ms"] for layer in ("networks", "loss_graph", "optimizer")) \
        <= 1e-3 * sum(steps) / 2
