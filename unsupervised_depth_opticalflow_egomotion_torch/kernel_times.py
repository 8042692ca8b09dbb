"""Time the CUDA kernels of one tree of this package, by their public wrappers.

    python3 unsupervised_depth_opticalflow_egomotion_torch/kernel_times.py [--root DIR] [--label NAME]

Needs one CUDA card. Imports the package from DIR (default: the checkout
that holds this file), so that two trees can be timed in turns in one run
on one card: unpack a parent commit into a directory that .gitignore lists
(``git archive``) and run parent, this tree, this tree, parent. Only the
wrappers' public functions are called, so both trees take the same calls.

Prints one JSON line with a row per wrapper and shape: ``warp_gather``,
``warp_gather_nograd`` and the re-gather backward ``warp_gather_backward``
at every shape the train steps give them; the cost volume's forward and
backward (``corr_backward``: df1 and df2) at the five PWC levels;
``ssim_fwd`` (three bf16 scales and f32 at full size) and ``ssim_bwd``
(three scales); ``splat_mass`` at the four flow scales from a random +-4 px
flow, and at full size from a smooth flow of a few pixels and a near-zero
one (``splat_flow``). Each row has ``ms`` (20 back-to-back wrapper calls
between CUDA events, as ``chip_smoke.py`` phase 3 times them) and
``device_ms`` (the same 20 calls captured once in a CUDA graph and replayed
between events); the row of each wrapper's coarsest shape also has
``host_us``: a host clock over 1,000 wrapper calls, the host time of one
call (the least of five rounds). ``host_parts_us`` times, the same way,
pieces of a launch path that do not depend on the tree: the stream handle
through a ``torch.cuda.Stream`` object and without one; a launch's tensor's
card, its compare with the current device and that card's stream, as
``cuda_lib`` takes them; one ``get_device``; one output allocation. Inputs
are made from a fixed seed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

WARP_SHAPES = [  # (source dtype, B, H, W): the geom, flow and depth steps' warps
    ("uint8", 16, 256, 832), ("bfloat16", 16, 128, 416), ("bfloat16", 16, 64, 208),
    ("bfloat16", 16, 32, 104), ("bfloat16", 8, 256, 832), ("bfloat16", 8, 128, 416),
    ("bfloat16", 8, 64, 208),
]
SSIM_SHAPES = [(8, 256, 832), (8, 128, 416), (8, 64, 208)]  # bf16, C = 3
CORR_LEVELS = [(64, 208, 32), (32, 104, 64), (16, 52, 96), (8, 26, 128), (4, 13, 196)]  # B = 16
SPLAT_SHAPES = [(8, 256, 832), (8, 128, 416), (8, 64, 208), (8, 32, 104)]  # bf16 flow
HOST_CALLS = 1000
HOST_ROUNDS = 5


def splat_flow(b: int, h: int, w: int, kind: str, gen):
    """An f32 flow [B,H,W,2] on the CPU: "random", uniform in +-4 px;
    "smooth", a field of a few pixels that varies over tens of pixels (as a
    trained PWC's), plus a little noise; "zero", near-zero (as at init)."""
    import torch

    if kind == "random":
        return 8.0 * torch.rand(b, h, w, 2, generator=gen) - 4.0
    if kind == "zero":
        return 1e-3 * torch.randn(b, h, w, 2, generator=gen)
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    field = torch.stack([3.0 * torch.sin(yy / 17 + xx / 29), 2.0 * torch.cos(xx / 23)], -1)
    return field[None] + 0.3 * torch.randn(b, h, w, 2, generator=gen)


def _events_ms(fn, iters: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def _host_us(fn) -> float:
    """Host time of one call: the host clock over HOST_CALLS calls, read
    before the final synchronize (the device work of a call at the coarsest
    shape is shorter than its host work, so the queue never fills); the
    least of HOST_ROUNDS such rounds, since the host's other work only ever
    adds to it."""
    import torch

    best = float("inf")
    for _ in range(HOST_ROUNDS):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return best / HOST_CALLS * 1e6


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    root = str(Path(args.root).resolve())
    sys.path[0] = root  # the package of that tree, not this file's directory

    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_times: needs a CUDA card")
    from unsupervised_depth_opticalflow_egomotion_torch.ops import cost_volume as cv
    from unsupervised_depth_opticalflow_egomotion_torch.ops import cuda_lib
    from unsupervised_depth_opticalflow_egomotion_torch.ops import splat as sp
    from unsupervised_depth_opticalflow_egomotion_torch.ops import ssim as ss
    from unsupervised_depth_opticalflow_egomotion_torch.ops import warp as wp

    if not cuda_lib.__file__.startswith(root):
        sys.exit(f"kernel_times: imported {cuda_lib.__file__}, not from {root}")
    cuda_lib.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    out = {"root": args.label or root, "device": torch.cuda.get_device_name(0),
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
               capture_output=True, text=True, timeout=60).stdout.strip(),
           "rows": []}

    def row(kernel, shape, call, host):
        r = {"kernel": kernel, "shape": shape, "ms": _events_ms(call), "device_ms": _graph_ms(call)}
        if host:
            r["host_us"] = _host_us(call)
        out["rows"].append(r)

    for sdt, b, h, w in WARP_SHAPES:
        u8 = torch.randint(0, 256, (b, h, w, 3), generator=gen, dtype=torch.uint8)
        src = u8.to(dev) if sdt == "uint8" else (u8.float() / 255.0).to(dev, torch.bfloat16)
        yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
        ix = (xx + 6.0 * torch.rand(b, h, w, generator=gen) - 3.0).float().contiguous().to(dev)
        iy = (yy + 6.0 * torch.rand(b, h, w, generator=gen) - 3.0).float().contiguous().to(dev)
        g_rgb = torch.randn(b, h, w, 3, generator=gen).to(dev, torch.bfloat16)
        g_w = torch.randn(b, h, w, 1, generator=gen).to(dev, torch.bfloat16)
        shape = f"{sdt}[{b},{h},{w},3]->bfloat16"
        host = (b, h, w) == (16, 32, 104)
        for name, fn in (("warp_gather", wp.warp_gather), ("warp_gather_nograd", wp.warp_gather_nograd)):
            row(name, shape, lambda: fn(src, ix, iy, torch.bfloat16), host)
        row("warp_gather_bwd", shape, lambda: wp.warp_gather_backward(src, ix, iy, g_rgb, g_w), host)
    for h, w, c in CORR_LEVELS:
        f1, f2 = ((0.5 * torch.randn(16, h, w, c, generator=gen)).to(dev, torch.bfloat16)
                  for _ in range(2))
        g = torch.randn(16, h, w, 81, generator=gen).to(dev, torch.bfloat16)
        shape, host = f"bfloat16[16,{h},{w},{c}]", (h, w) == (4, 13)
        row("corr_fwd", shape, lambda: cv.corr_forward(f1, f2, 4), host)
        row("corr_bwd_df1+df2", shape, lambda: cv.corr_backward(g, f1, f2, 4), host)
    for (b, h, w), dts in [*((s, "bfloat16") for s in SSIM_SHAPES), (SSIM_SHAPES[0], "float32")]:
        dt = getattr(torch, dts)
        x = torch.rand(b, h, w, 3, generator=gen)
        y = (x + 0.2 * torch.randn(b, h, w, 3, generator=gen)).clamp(0, 1)
        x, y = x.to(dev, dt), y.to(dev, dt)
        g = torch.randn(b, h, w, 3, generator=gen).to(dev, dt)
        shape, host = f"{dts}[{b},{h},{w},3]", (h, w) == (64, 208)
        row("ssim_fwd", shape, lambda: ss.ssim_forward(x, y), host)
        if dts == "bfloat16":
            row("ssim_bwd", shape, lambda: ss.ssim_backward(x, y, g), host)
    for (b, h, w), kind in [*((s, "random") for s in SPLAT_SHAPES),
                            (SPLAT_SHAPES[0], "smooth"), (SPLAT_SHAPES[0], "zero")]:
        flow = splat_flow(b, h, w, kind, gen).to(dev, torch.bfloat16)
        row("splat_mass", f"bfloat16[{b},{h},{w},2] {kind}", lambda: sp.splat_mass(flow),
            (h, w) == (32, 104))
    small = torch.empty((16, 32, 104, 3), device=dev, dtype=torch.bfloat16)

    def current_device():  # cuda_lib._current_device
        return torch._C._cuda_getDevice()

    def raw_stream(index):  # cuda_lib._raw_stream
        return torch._C._cuda_getCurrentRawStream(index)

    def tensors_card():  # what a launch adds to find its tensors' card
        index = small.get_device()
        return raw_stream(index) if index == current_device() else None

    out["host_parts_us"] = {
        "torch.cuda.current_stream().cuda_stream": _host_us(
            lambda: torch.cuda.current_stream().cuda_stream),
        "torch._C._cuda_getCurrentRawStream": _host_us(
            lambda: torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())),
        "tensor's card, compare, its stream": _host_us(tensors_card),
        "get_device": _host_us(small.get_device),
        "new_empty bf16 [16,32,104,3]": _host_us(lambda: small.new_empty(small.shape)),
    }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
