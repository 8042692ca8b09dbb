"""Profile one tree's train steps and its 3x3 coordinate products on one CUDA card.

    python3 unsupervised_depth_opticalflow_egomotion_torch/step_profile.py [--root DIR] [--label NAME]

Imports the package from DIR (default: the checkout that holds this file),
as ``kernel_times.py`` does, so that two trees can be profiled in turns in
one run on one card: unpack a parent commit into a directory that
.gitignore lists (``git archive``) and run parent, this tree, this tree,
parent.

- ``steps``: the geom and the depth step under the default ``Config`` (b8,
  256x832, bf16, uint8 frames, weights from seed 0): three warm-up steps,
  five steps on the host clock, then two profiled steps. Per step: ms on the
  host clock, device ms (the kernels' device time), kernel launches, and
  device ms and launches by launching op, the ``bmm`` row among them.
- ``products``: the three coordinate products at the geom step's shapes
  (2B = 16 images at 256x832, f32) through the tree's own functions:
  ``geometry.pixel2cam`` (the back-projection), ``geometry.cam2pixel_px``
  (the projection) and ``masks.epipolar_map``, forward and backward to the
  inputs that have a gradient in the step. Each is timed with CUDA events
  (20 calls: ``fwd_ms``, ``fwd_bwd_ms``; at a few dozen launches a call
  this is the host's time) and profiled once for the device time and the
  launches of its kernels (``*_device_ms``, ``*_launches``).

Prints one JSON line, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

B, H, W = 8, 256, 832


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


def _profile(fn, n: int):
    """(device ms, launches, {op: [device ms, launches]}) per call of ``fn``
    over ``n`` profiled calls; ops by the device time of the kernels they
    launch (self time), the kernels counted as device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    host_keys = {e.key for e in events if e.device_type == DeviceType.CPU}
    kernels = [e for e in events if e.device_type != DeviceType.CPU
               and not getattr(e, "is_user_annotation", False) and e.key not in host_keys]
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0), key=lambda e: -e.self_device_time_total)
    by_op = {e.key: [round(e.self_device_time_total / 1e3 / n, 4), e.count // n]
             for e in ops if e in ops[:16] or e.key == "aten::bmm"}
    return (round(sum(e.self_device_time_total for e in kernels) / 1e3 / n, 4),
            sum(e.count for e in kernels) // n, by_op)


def _batch(dev):
    import numpy as np
    import torch

    rng = np.random.RandomState(0)
    images = torch.from_numpy((rng.rand(B, 3 * H, W, 3) * 255).astype(np.uint8))
    K = np.array([[241.0, 0, W / 2], [0, 245.0, H / 2], [0, 0, 1]], np.float32)
    K_ms = np.stack([np.diag([1 / 2**s, 1 / 2**s, 1.0]).astype(np.float32) @ K for s in range(3)])
    K_inv_ms = np.stack([np.linalg.inv(k) for k in K_ms]).astype(np.float32)
    tile = lambda x: torch.from_numpy(np.tile(x[None], (B, 1, 1, 1)))  # noqa: E731
    return tuple(t.to(dev) for t in (images, tile(K_ms), tile(K_inv_ms)))


def steps(dev) -> dict:
    import torch

    from unsupervised_depth_opticalflow_egomotion_torch.config import Config
    from unsupervised_depth_opticalflow_egomotion_torch.parallel import init_state, make_train_step

    torch.backends.cudnn.benchmark = True
    out = {}
    batch = _batch(dev)
    for mode in ("geom", "depth"):
        cfg = Config(img_hw=(H, W), batch_size=B, mode=mode)
        model, opt = init_state(cfg)
        step = make_train_step(model, cfg, opt)
        for _ in range(3):
            step(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            step(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 5 * 1e3
        device_ms, launches, by_op = _profile(lambda: step(batch), 2)
        out[mode] = {"ms": round(ms, 2), "device_ms": device_ms, "launches": launches,
                     "by_op": by_op}
        del model, opt, step
        torch.cuda.empty_cache()
    return out


def products(dev) -> dict:
    import torch

    from unsupervised_depth_opticalflow_egomotion_torch.ops import geometry, masks

    b = 2 * B
    gen = torch.Generator().manual_seed(0)
    k = torch.tensor([[241.0, 0, W / 2], [0, 245.0, H / 2], [0, 0, 1]])
    k_inv = torch.linalg.inv(k).expand(b, 3, 3).contiguous().to(dev)
    depth = (1.0 + 10.0 * torch.rand(b, H, W, generator=gen)).to(dev).requires_grad_(True)
    cam = geometry.pixel2cam(depth.detach(), k_inv).requires_grad_(True)
    pose = (0.05 * torch.randn(b, 6, generator=gen)).to(dev).requires_grad_(True)
    proj = (k.to(dev) @ geometry.pose_vec2mat(pose.detach())).requires_grad_(True)
    flow = (2.0 * torch.randn(b, H, W, 2, generator=gen)).to(dev).requires_grad_(True)
    k_full = k.expand(b, 3, 3).contiguous().to(dev)
    calls = {
        "pixel2cam": (lambda: geometry.pixel2cam(depth, k_inv), (depth,)),
        "cam2pixel_px": (lambda: geometry.cam2pixel_px(cam, proj), (cam, proj)),
        "epipolar_map": (lambda: masks.epipolar_map(pose, flow, k_full, k_inv), (pose, flow)),
    }
    out = {}
    for name, (fwd, inputs) in calls.items():
        g = torch.randn(fwd().shape, generator=gen).to(dev)

        def fwd_bwd():
            for x in inputs:
                x.grad = None
            fwd().backward(g)

        row = {"fwd_ms": round(_events_ms(fwd), 4), "fwd_bwd_ms": round(_events_ms(fwd_bwd), 4)}
        for label, fn in (("fwd", fwd), ("fwd_bwd", fwd_bwd)):
            row[f"{label}_device_ms"], row[f"{label}_launches"], _ = _profile(fn, 1)
        out[name] = row
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    root = str(Path(args.root).resolve())
    sys.path[0] = root  # the package of that tree, not this file's directory

    import torch

    if not torch.cuda.is_available():
        sys.exit("step_profile: needs a CUDA card")
    from unsupervised_depth_opticalflow_egomotion_torch.ops import cuda_lib

    if not cuda_lib.__file__.startswith(root):
        sys.exit(f"step_profile: imported {cuda_lib.__file__}, not from {root}")
    cuda_lib.build_all()
    dev = torch.device("cuda")
    out = {"root": args.label or root, "device": torch.cuda.get_device_name(0),
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
               capture_output=True, text=True, timeout=60).stdout.strip(),
           "products": products(dev), "steps": steps(dev)}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
