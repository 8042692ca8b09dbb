"""What the per-layer metrics read from one ``torch.profiler`` session.

The session covers a steady span of whole steps (CPU and CUDA activities).
From it: every device activity (kernels, copies, fills) with its interval,
the CPU ops with the device time of the kernels each launched, the host's
launch API calls, and the host op that was running in each idle gap of the
device.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from torch.autograd import DeviceType

# host-side CUDA calls that put work on the device
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchCooperativeKernel", "cudaGraphLaunch", "cuGraphLaunch")
STEP_SPAN = "portbench.step"
# CPU ops whose kernels are the networks' dense work
MATRIX_OPS = ("aten::cudnn_convolution", "aten::convolution_backward",
              "aten::cudnn_convolution_transpose", "aten::mm", "aten::bmm", "aten::addmm",
              "aten::baddbmm", "aten::addbmm", "aten::_int_mm")
# the same work by kernel name, for a step that dispatches no op (a CUDA
# graph's replay): parts of the names of the cuDNN, cuBLAS and CUTLASS
# kernels that the MATRIX_OPS launch (read off op-by-op traced steps of the
# geom, flow and depth cells on an H100, torch 2.11, CUDA 12.8), cuDNN's
# layout kernels among them, and the device memsets, two thirds of which
# are the convolutions' (cuDNN's workspace and accumulators); no other
# kernel's name holds one
CONV_KERNELS = ("xmma", "gemm", "gemv", "nvjet", "cutlass", "splitKreduce", "convolve", "winograd",
                "fft2d", "dgrad", "wgrad", "fprop", "nchwToNhwc", "nhwcToNchw", "nhwcAddPadding",
                "tensorTransform", "Memset")


class Trace:
    def __init__(self, events, steps: int):
        self.steps = steps
        host_keys = {e.name for e in events if e.device_type == DeviceType.CPU}
        # a range annotated on the device spans kernels that are counted
        # already and bears the name of its host range: left out
        self.device = sorted(
            ((e.time_range.start, e.time_range.end, e.name) for e in events
             if e.device_type != DeviceType.CPU and not getattr(e, "is_user_annotation", False)
             and e.name not in host_keys),
            key=lambda t: t[0])
        cpu = [e for e in events if e.device_type == DeviceType.CPU]
        self.op_device_us = defaultdict(float)
        for e in cpu:
            self.op_device_us[e.name] += e.self_device_time_total
        self.launch_calls = sum(1 for e in cpu if e.name in LAUNCH_CALLS)
        steps_spans = [e for e in cpu if e.name == STEP_SPAN]
        thread = steps_spans[0].thread if steps_spans else None
        self.host = sorted(((e.time_range.start, e.time_range.end, e.name) for e in cpu
                            if e.thread == thread and e.name not in LAUNCH_CALLS),
                           key=lambda t: t[0])
        start = min(e.time_range.start for e in steps_spans) if steps_spans else (
            self.device[0][0] if self.device else 0.0)
        end = max([t[1] for t in self.device] + [e.time_range.end for e in steps_spans] + [start])
        self.window_us = end - start
        self.segments = self._union()

    def _union(self):
        segs = []
        for s, e, _ in self.device:
            if segs and s <= segs[-1][1]:
                segs[-1][1] = max(segs[-1][1], e)
            else:
                segs.append([s, e])
        return segs

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.segments) / 1e6

    @property
    def window_s(self) -> float:
        return self.window_us / 1e6

    def device_seconds(self, names=None) -> float:
        """Device time (s) of the activities whose name contains one of
        ``names`` (all activities when None), summed."""
        return sum(e - s for s, e, n in self.device
                   if names is None or any(k in n for k in names)) / 1e6

    def op_seconds(self, ops) -> float:
        """Device time (s) of the kernels launched by the CPU ops ``ops``."""
        return sum(self.op_device_us.get(o, 0.0) for o in ops) / 1e6

    def top_device_ops(self, n: int = 10) -> list:
        by = defaultdict(float)
        for s, e, name in self.device:
            by[name.replace("void ", "", 1)[:120]] += (e - s) / 1e6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle time (s) of the device between its busy segments, by the
        innermost host op open at each gap's middle."""
        starts = [h[0] for h in self.host]
        steps = [(s, e) for s, e, n in self.host if n == STEP_SPAN]
        by = defaultdict(float)
        for (_, e0), (s1, _) in zip(self.segments, self.segments[1:]):
            mid = (e0 + s1) / 2
            i = bisect.bisect_right(starts, mid) - 1
            # ops nest, so the latest-started op still open is the innermost;
            # past a few hundred closed ones, the host is between ops
            name = next((self.host[j][2] for j in range(i, max(i - 400, -1), -1)
                         if self.host[j][1] >= mid and self.host[j][2] != STEP_SPAN), None)
            if name is None:
                name = ("(between ops in a step)" if any(s <= mid <= e for s, e in steps)
                        else "(between steps)")
            by[name] += (s1 - e0) / 1e6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]
