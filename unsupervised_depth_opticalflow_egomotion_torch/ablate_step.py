"""Decompose the geom train step's time by loss terms and by bare networks, on one CUDA card.

    python -m unsupervised_depth_opticalflow_egomotion_torch.ablate_step

The port of ``scripts/ablate_step.py``. At ``bench.py``'s shape (b8 256x832
bf16, the default ``Config``, weights from seed 0) and on its batch (uint8
frames: the input of the step ``bench.py`` times, where the JAX script feeds
float frames), it times

- for each of the JAX script's nine subsets of the loss pack (``SUBSETS``,
  the same names and keys): the geom forward in train mode, then the
  gradient of the subset's summed means to the parameters;
- the three bare networks, fwd+bwd (the gradient of the sum of their
  outputs) and fwd-only: ``depth_net`` on 3B frames, ``fpyramid`` on both
  of 2 x 2B frames and ``pwc`` on their features, and ``pose_net`` on the
  frames stacked by channel.

Why the numbers differ from the JAX script's: XLA prunes from each subset's
compiled gradient the forward that the subset does not need; eager PyTorch
runs the whole forward every time. So every subset here pays the whole
forward, and what differs between subsets is the backward (autograd runs
only the part of the graph the subset's losses reach). The JAX script also
sums the gradients' magnitudes to force them; here the card's completion is
waited for instead.

Each entry gets ``host_ms``: the mean time of ``ITERS`` calls after a
warm-up, between CUDA events (the step's wall time on the card's stream,
the host's launches included), and ``device_ms``: the kernels' device time
of one call under ``torch.profiler``, taken after every timed call (a
profiler session slows the host side of later calls). Prints one JSON line
with the card's name and power limit; a table goes to stderr.
"""

from __future__ import annotations

import json
import sys

import torch

from .bench import Bench, Settings, card_line
from .utils import resolve_device

ITERS = 20  # timed calls an entry, as the JAX script's

ALL = [
    "loss_depth_pixel", "loss_depth_smooth", "loss_flow_pixel",
    "loss_flow_ssim", "loss_flow_smooth", "loss_flow_consis",
    "loss_depth_flow_consis", "loss_epipolar",
]
SUBSETS = {
    "all-live": ALL,
    "depth-only (pixel+smooth)": ["loss_depth_pixel", "loss_depth_smooth"],
    "flow-only (4 terms)": [
        "loss_flow_pixel", "loss_flow_ssim", "loss_flow_smooth", "loss_flow_consis"
    ],
    "geom-only (dfc+epipolar)": ["loss_depth_flow_consis", "loss_epipolar"],
    "flow_pixel only": ["loss_flow_pixel"],
    "depth_pixel only": ["loss_depth_pixel"],
    "all minus smooths": [
        k for k in ALL if k not in ("loss_depth_smooth", "loss_flow_smooth")
    ],
    "all minus ssim": [k for k in ALL if k != "loss_flow_ssim"],
    "all minus consis": [k for k in ALL if k != "loss_flow_consis"],
}


def subset_grad(model, batch, keys) -> None:
    """The geom forward in train mode, then the gradient of the sum of the
    subset's means, into the parameters' ``.grad``."""
    model.zero_grad(set_to_none=True)
    pack, _ = model.forward_geom(*batch)
    sum(pack[k].mean() for k in keys).backward()


def network_fns(model, batch) -> dict:
    """The bare networks of the JAX script, each a function of the model
    returning the sum of its outputs (f32): on the first frame of each
    stack, in the compute dtype."""
    h = batch[0].shape[1] // 3
    img = (batch[0][:, :h].float() / 255.0).to(model.dtype)
    img3 = torch.cat([img, img, img], 0)
    img2 = torch.cat([img, img], 0)
    hw = (h, img.shape[2])

    def depth():
        return sum(d.float().sum() for d in model.depth_net(img3))

    def flow():
        flows = model.pwc_model(model.fpyramid(img2), model.fpyramid(img2), hw)
        return sum(f.float().sum() for f in flows)

    def pose():
        return model.pose_net(torch.cat([img, img, img], -1)).float().sum()

    return {"depth_net 3B": depth, "fpyramid+pwc 2x2B": flow, "pose_net": pose}


def entries(model, batch) -> dict:
    """Every entry's call, by the JAX script's names."""
    out = {name: (lambda keys=keys: subset_grad(model, batch, keys))
           for name, keys in SUBSETS.items()}

    def fwd_bwd(fn):
        model.zero_grad(set_to_none=True)
        fn().backward()

    def fwd_only(fn):
        with torch.no_grad():
            fn()

    for name, fn in network_fns(model, batch).items():
        out[f"{name} fwd+bwd"] = lambda fn=fn: fwd_bwd(fn)
        out[f"{name} fwd-only"] = lambda fn=fn: fwd_only(fn)
    return out


def host_ms(fn, iters: int) -> float:
    """Mean ms of ``iters`` calls after a warm-up call, between CUDA events."""
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


def device_ms(fn) -> float:
    """The kernels' device time (ms) of one call, from ``torch.profiler``
    tracing the card alone (no host ops to record and sort: a short
    session)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ms = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type != DeviceType.CPU and not getattr(e, "is_user_annotation", False)) / 1e3
    if not ms > 0:
        raise RuntimeError("the profiler recorded no device time")
    return ms


def run(iters: int = ITERS, device=None) -> list[dict]:
    """The entries' host ms (all timed first) and device ms (profiled after)
    at ``bench.py``'s default ``Config``, on a card."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError("ablate_step times on a CUDA card")
    bench = Bench(Settings().config(), device)
    torch.backends.cudnn.benchmark = True
    calls = entries(bench.model, bench.batch)
    rows = [{"name": name, "host_ms": round(host_ms(fn, iters), 3)} for name, fn in calls.items()]
    for row in rows:
        row["device_ms"] = round(device_ms(calls[row["name"]]), 3)
    return rows


def main() -> None:
    rows = run()
    smi = card_line()
    for r in rows:
        print(f"{r['name']:32s} {r['host_ms']:8.1f} ms host {r['device_ms']:8.1f} ms device",
              file=sys.stderr)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "iters": ITERS, "entries": rows}), flush=True)


if __name__ == "__main__":
    main()
