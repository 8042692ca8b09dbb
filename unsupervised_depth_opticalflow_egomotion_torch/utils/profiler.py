"""Program spans and device traces.

``span(name)`` marks a region of the program (the training step's phases,
the networks, the parts of the loss graph) as a range of a ``torch.profiler``
session, on the same clock as the card's activity, so that a trace can say
which part of the program the host was in while the card waited. Outside a
session it does nothing: one read of a flag, no torch call, no sync.

``device_trace(logdir)`` runs such a session over the enclosed region and
writes it as a Chrome trace, spans included.

Time first and profile last: a ``torch.profiler`` session slows the host
side of the steps that come after it in the same process, so a timing taken
after a trace reads slow.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.autograd import profiler as _autograd_profiler

from .device import resolve_device

_OFF = contextlib.nullcontext()


def span(name: str, args=None):
    """A context that records ``name`` (with ``args``, as text) as a range of
    the running profiler session; a shared no-op context when none runs."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name, None if args is None else str(args))


@contextlib.contextmanager
def device_trace(logdir: str, device=None):
    """A ``torch.profiler`` trace of the enclosed region, host ops, program
    spans and (on CUDA, the default) the card's kernels, written as a Chrome
    trace to ``<logdir>/trace.json`` (chrome://tracing, Perfetto). Returns
    the path through the context's target."""
    dev = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    with torch.profiler.profile(activities=activities) as prof:
        yield path
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(path)
