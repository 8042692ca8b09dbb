"""Wall-clock checkpoints and device traces.

Port of the JAX package's ``utils/profiler.py``: the same checkpoint API,
synchronised with ``torch.cuda.synchronize`` on the tracked device in place
of ``jax.effects_barrier``, and a context over ``torch.profiler`` that
writes a Chrome trace.

Time first and profile last: a ``torch.profiler`` session slows the host
side of the steps that come after it in the same process, so a timing taken
after a trace reads slow.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from .device import resolve_device


class Profiler:
    """Named wall-clock checkpoints; call ``report()`` for a summary.

    ``device`` (default: CUDA) is the device whose pending work a
    checkpoint waits for; on the CPU there is none to wait for.
    """

    def __init__(self, silent: bool = False, device=None):
        self.silent = silent
        self.device = resolve_device(device)
        self.timings: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._last = time.time()

    def reset(self):
        self._last = time.time()

    def report(self, name: str, sync: bool = True):
        """Record elapsed time since the previous checkpoint under ``name``."""
        if sync and self.device.type == "cuda":
            # finish the queued device work so the interval is attributable
            torch.cuda.synchronize(self.device)
        now = time.time()
        dt = now - self._last
        self.timings[name] = self.timings.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1
        self._last = now
        if not self.silent:
            print(f"[profiler] {name}: {dt * 1000:.2f} ms")
        return dt

    def summary(self) -> str:
        lines = []
        for name, total in sorted(self.timings.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:>24}: total {total:8.3f}s  avg {total / n * 1e3:8.2f}ms  n={n}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str, device=None):
    """A ``torch.profiler`` trace of the enclosed region, host ops and (on
    CUDA, the default) the card's kernels, written as a Chrome trace to
    ``<logdir>/trace.json`` (chrome://tracing, Perfetto). Returns the path
    through the context's target."""
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
