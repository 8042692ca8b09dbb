"""The port's program spans in a traced session, by layer.

The port marks its training step with ``torch.profiler`` ranges
(``utils/profiler.span`` of the port): ``train_step`` around a step, and
nested in it ``train_step.draws``, ``train_step.forward``,
``train_step.backward``, ``train_step.allreduce`` and
``train_step.optimizer``; in ``train_step.forward`` the networks
(``net.depth``, ``net.pose``, ``net.pyramid``, ``net.pwc``) and the parts of
the loss graph (``loss.recon``, ``loss.flow_warps``, ``loss.masks``,
``loss.terms``, ``loss.sampled``). They sit in ``Trace.host`` (the step
thread's host events) beside the ATen ops.

A span's self time is its interval less the intervals of the program spans
nested in it. Each layer is a set of spans:

- networks: ``net.*``;
- loss graph: ``train_step.forward`` (its self time: the Python between the
  networks and the loss parts, and the weighted sum) and ``loss.*``;
- backward: ``train_step.backward`` (on the card, the step thread's wait
  for autograd's device thread);
- optimizer: ``train_step.optimizer``.

A program that marks no spans (an older one) gives no reading: the readers
return None.
"""

from __future__ import annotations

import bisect
from functools import lru_cache

PREFIXES = ("train_step.", "net.", "loss.")
LAYERS = {
    "networks": lambda n: n.startswith("net."),
    "loss_graph": lambda n: n == "train_step.forward" or n.startswith("loss."),
    "backward": lambda n: n == "train_step.backward",
    "optimizer": lambda n: n == "train_step.optimizer",
}


def is_span(name: str) -> bool:
    return name == "train_step" or name.startswith(PREFIXES)


class ProgramSpans:
    """Self intervals of every program span and the innermost enclosing
    host event of every host event, from ``trace.host``."""

    def __init__(self, trace):
        # parents before their children: by start, the longer first, a span
        # before an op of the same interval
        host = sorted(trace.host, key=lambda h: (h[0], -h[1], not is_span(h[2])))
        self.parent = []  # the innermost enclosing event's name, or None
        self.self_intervals = []  # (name, [(start, end), ...]) a program span
        stack = []  # open events: [end, name, index into self_intervals or -1]
        for s, e, name in host:
            while stack and stack[-1][0] <= s:
                stack.pop()
            self.parent.append(stack[-1][1] if stack else None)
            if is_span(name):
                # cut this span out of the nearest enclosing span's self time
                for entry in reversed(stack):
                    if entry[2] >= 0:
                        _cut(self.self_intervals[entry[2]][1], s, e)
                        break
                self.self_intervals.append((name, [(s, e)]))
                stack.append([e, name, len(self.self_intervals) - 1])
            else:
                stack.append([e, name, -1])
        self.names = [h[2] for h in host]


def _cut(intervals: list, s: float, e: float) -> None:
    """Remove [s, e] from the last of ``intervals`` (children come in order,
    so the child lies in the last piece)."""
    a, b = intervals.pop()
    if a < s:
        intervals.append((a, s))
    if e < b:
        intervals.append((e, b))


@lru_cache(maxsize=4)
def program_spans(trace) -> ProgramSpans | None:
    ps = ProgramSpans(trace)
    return ps if ps.self_intervals else None


def busy_within(segments, s: float, e: float) -> float:
    """Time (us) in [s, e] covered by ``segments`` (sorted, disjoint)."""
    i = bisect.bisect_right(segments, [s, float("inf")]) - 1
    i = max(i, 0)
    busy = 0.0
    while i < len(segments) and segments[i][0] < e:
        a, b = segments[i]
        busy += max(0.0, min(b, e) - max(a, s))
        i += 1
    return busy


def _layer(ctx, layer: str):
    """The trace's program spans and the self intervals of ``layer``'s
    spans; None when the trace has no span of the layer."""
    t = ctx.trace
    if t is None or not t.steps:
        return None
    ps = program_spans(t)
    member = LAYERS[layer]
    if ps is None or not any(member(name) for name, _ in ps.self_intervals):
        return None
    return ps, [iv for name, ivs in ps.self_intervals if member(name) for iv in ivs]


def host_ms(ctx, layer: str) -> float | None:
    """The layer's host self time a step, in ms."""
    got = _layer(ctx, layer)
    if got is None:
        return None
    return sum(e - s for s, e in got[1]) / 1e3 / ctx.trace.steps


def idle_ms(ctx, layer: str) -> float | None:
    """Device idle time a step (ms) while the layer's spans are the innermost
    program spans open: the exact overlap of the device's idle gaps with the
    spans' self intervals."""
    got = _layer(ctx, layer)
    if got is None:
        return None
    segs = ctx.trace.segments
    idle = sum((e - s) - busy_within(segs, s, e) for s, e in got[1])
    return idle / 1e3 / ctx.trace.steps


def ops_per_step(ctx, layer: str) -> float | None:
    """Top-level ATen ops a step that the layer's spans dispatch: host
    events named ``aten::*`` whose innermost enclosing event is one of the
    layer's spans."""
    got = _layer(ctx, layer)
    if got is None:
        return None
    ps, member = got[0], LAYERS[layer]
    n = sum(1 for name, parent in zip(ps.names, ps.parent)
            if name.startswith("aten::") and parent is not None and is_span(parent)
            and member(parent))
    return n / ctx.trace.steps
