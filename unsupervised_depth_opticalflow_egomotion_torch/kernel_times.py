"""Time the warp-gather and SSIM-backward kernels of one tree of this package.

    python3 unsupervised_depth_opticalflow_egomotion_torch/kernel_times.py [--root DIR] [--label NAME]

Needs one CUDA card. Imports the package from DIR (default: the checkout
that holds this file), so that two trees can be timed in turns in one run
on one card: unpack a parent commit into a directory that .gitignore lists
(``git archive``) and run parent, this tree, this tree, parent. Only the
wrappers' public functions are called, so both trees take the same calls.

Prints one JSON line: for ``warp_gather`` (and ``warp_gather_nograd``) at
every shape the train steps give it and ``ssim_bwd`` at its three scales,
``ms`` (20 back-to-back wrapper calls between CUDA events, as
``chip_smoke.py`` phase 3 times them), ``device_ms`` (the same 20 calls
captured once in a CUDA graph and replayed between events), and, at the
coarsest shape, ``host_us``: a host clock over 1,000 wrapper calls, the
host time of one call. ``host_parts_us`` times, the same way, pieces of a
launch path that do not depend on the tree: the stream handle through a
``torch.cuda.Stream`` object and without one, and one output allocation.
Inputs are made from a fixed seed.
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
HOST_CALLS = 1000


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
    shape is shorter than its host work, so the queue never fills)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / HOST_CALLS * 1e6


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
    from unsupervised_depth_opticalflow_egomotion_torch.ops import cuda_lib
    from unsupervised_depth_opticalflow_egomotion_torch.ops import ssim as ss
    from unsupervised_depth_opticalflow_egomotion_torch.ops import warp as wp

    if not cuda_lib.__file__.startswith(root):
        sys.exit(f"kernel_times: imported {cuda_lib.__file__}, not from {root}")
    cuda_lib.build_all(["warp_gather", "ssim"])
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    out = {"root": args.label or root, "device": torch.cuda.get_device_name(0),
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
               capture_output=True, text=True, timeout=60).stdout.strip(),
           "rows": []}
    for sdt, b, h, w in WARP_SHAPES:
        u8 = torch.randint(0, 256, (b, h, w, 3), generator=gen, dtype=torch.uint8)
        src = u8.to(dev) if sdt == "uint8" else (u8.float() / 255.0).to(dev, torch.bfloat16)
        yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
        ix = (xx + 6.0 * torch.rand(b, h, w, generator=gen) - 3.0).float().contiguous().to(dev)
        iy = (yy + 6.0 * torch.rand(b, h, w, generator=gen) - 3.0).float().contiguous().to(dev)
        for name, fn in (("warp_gather", wp.warp_gather), ("warp_gather_nograd", wp.warp_gather_nograd)):
            call = lambda: fn(src, ix, iy, torch.bfloat16)  # noqa: E731
            row = {"kernel": name, "shape": f"{sdt}[{b},{h},{w},3]->bfloat16",
                   "ms": _events_ms(call), "device_ms": _graph_ms(call)}
            if (b, h, w) == (16, 32, 104):
                row["host_us"] = _host_us(call)
            out["rows"].append(row)
    for b, h, w in SSIM_SHAPES:
        x = torch.rand(b, h, w, 3, generator=gen)
        y = (x + 0.2 * torch.randn(b, h, w, 3, generator=gen)).clamp(0, 1)
        x, y = x.to(dev, torch.bfloat16), y.to(dev, torch.bfloat16)
        g = torch.randn(b, h, w, 3, generator=gen).to(dev, torch.bfloat16)
        call = lambda: ss.ssim_backward(x, y, g)  # noqa: E731
        row = {"kernel": "ssim_bwd", "shape": f"bfloat16[{b},{h},{w},3]",
               "ms": _events_ms(call), "device_ms": _graph_ms(call)}
        if (h, w) == (64, 208):
            row["host_us"] = _host_us(call)
        out["rows"].append(row)
    small = torch.empty((16, 32, 104, 3), device=dev, dtype=torch.bfloat16)
    out["host_parts_us"] = {
        "torch.cuda.current_stream().cuda_stream": _host_us(
            lambda: torch.cuda.current_stream().cuda_stream),
        "torch._C._cuda_getCurrentRawStream": _host_us(
            lambda: torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())),
        "new_empty bf16 [16,32,104,3]": _host_us(lambda: small.new_empty(small.shape)),
    }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
