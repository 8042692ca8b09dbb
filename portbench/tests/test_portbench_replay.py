"""The reader of the train step's graph replays (``graph_replay_share``) on
hand-built traces: the ``train_step.replay`` spans over the harness's steps,
and nothing to read where no step replayed."""

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


def step(t0, replay=True):
    """A step over t0..t0+100 us whose train step replays its graph (or,
    with ``replay`` False, runs op by op)."""
    inner = ("train_step.replay", 20, 90) if replay else ("train_step.forward", 20, 90)
    host = [(STEP_SPAN, 0, 100), ("train_step", 10, 95), inner, ("cudaGraphLaunch", 30, 40)]
    return ([ev(n, t0 + s, t0 + e) for n, s, e in host]
            + [ev("corr_fwd_kernel", t0 + 40, t0 + 90, device=True)])


@pytest.mark.parametrize("replays,want", [((True, True, True), 1.0),
                                          ((False, True, True, True), 0.75),
                                          ((False, False), None)])
def test_graph_replay_share(replays, want):
    """The replay spans over the steps; no reading without a replay."""
    events = [e for i, r in enumerate(replays) for e in step(100 * i, r)]
    got = harness.load_reader("graph_replay_share")(ctx(Trace(events, steps=len(replays))))
    assert got == (None if want is None else pytest.approx(want))


def test_graph_replay_share_without_a_trace():
    assert harness.load_reader("graph_replay_share")(ctx(None)) is None
