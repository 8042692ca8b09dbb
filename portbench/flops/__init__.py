"""The benchmark's frozen yardstick: the kernels' operation and byte counts,
the card's peak rates, and a counter the plain reference reports its calls to.

Copied from the port at commit 6d2cb1d (``ops/flops.py`` for the formulas,
``utils/hardware.py`` for the peaks, ``chip_smoke.py`` phase 3 for the bytes
of each launch) and kept here, so that a later change to the port cannot move
the measure it is held to.

Counting rules (as ``ops/flops.py`` states them): each function counts the
work it needs at its shapes, whatever route computes it. The cost volume
counts ``corr_flops`` forward and once more for each input that takes a
gradient; SSIM 70 a forward element and 150 a backward one; the warp of a
three-channel data source 60 an output pixel forward and 90 backward; the
bilinear splat 20 a source pixel, with no backward. A backward is counted
only when it runs (the inputs pass through an identity whose backward counts),
so a function whose output feeds no loss adds only its forward.

Bytes of one launch (each input read once, each output written once, ``esz``
the element size): ``corr_fwd`` 2 P C + 81 P, each of ``corr_bwd_df1`` and
``corr_bwd_df2`` 81 P + 2 P C, with P the pixels of the batch; ``ssim_fwd``
3 N and ``ssim_bwd`` 5 N, with N the elements; the warp-gather kernels
(``warp_bytes``) over N output pixels of a three-channel source of as many
pixels. The cost volume's operations run at the peak of its input type;
SSIM's and the warp's at the f32 peak (CUDA cores).

The warp's three kernels (the port's ``csrc/warp_gather.cu``) at their
operations an output pixel: ``warp_gather``, the forward that also writes
the six derivative planes, 105 (its backward is elementwise on the planes);
``warp_gather_nograd`` 60 and ``warp_gather_bwd`` 90, the forward and the
re-gather backward of ``warp_impl="pallas"``. The reference's ``warp`` calls
count 60 forward and 90 backward whatever the route (the FLOP count above).
"""

from __future__ import annotations

import torch

WARP_NOGRAD_FLOPS_PER_PIXEL = 60
WARP_BWD_FLOPS_PER_PIXEL = 90
SSIM_FWD_FLOPS = 70
SSIM_BWD_FLOPS = 150
SPLAT_FLOPS_PER_PIXEL = 20
# a warp-gather kernel's operations an output pixel, by kernel
WARP_KERNEL_FLOPS_PER_PIXEL = {"warp_gather": 105,
                               "warp_gather_nograd": WARP_NOGRAD_FLOPS_PER_PIXEL,
                               "warp_gather_bwd": WARP_BWD_FLOPS_PER_PIXEL}

# NVIDIA H100 SXM data sheet, dense rates: HBM3 3.35 TB/s; bf16 989 TFLOP/s
# (tensor cores); f32 67 TFLOP/s (CUDA cores)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "flops": {"bfloat16": 989e12, "float32": 67e12}},
}
ELEMENT_SIZE = {"bfloat16": 2, "float32": 4}


def peaks(device_name: str) -> dict | None:
    """The peak rates of a card by the name CUDA gives it, or None."""
    return PEAKS.get(device_name)


def valid_shifts(h: int, w: int, md: int) -> int:
    """Shift-pixel pairs of the cost volume that land inside the frame."""
    return sum(h - abs(d) for d in range(-md, md + 1)) * sum(
        w - abs(d) for d in range(-md, md + 1))


def corr_flops(b: int, h: int, w: int, c: int, md: int = 4) -> int:
    """One launch of the cost volume's forward, df1 or df2."""
    return 2 * b * valid_shifts(h, w, md) * c


def corr_bytes(b: int, h: int, w: int, c: int, md: int, esz: int) -> tuple[int, int]:
    """(forward, each backward half) bytes of one cost-volume launch."""
    pix, nd = b * h * w, (2 * md + 1) ** 2
    return 2 * pix * c * esz + pix * nd * esz, pix * nd * esz + 2 * pix * c * esz


def warp_bytes(kernel: str, pixels: int, esz: int) -> int:
    """Bytes of one launch of the warp-gather ``kernel`` over ``pixels``
    output pixels: the source's three channels at one byte each (the frames
    as they come, uint8: the least a route can read) and the coordinates
    (two f32) read; the three values and the weight sum written at ``esz``;
    ``warp_gather`` also writes six f32 derivative planes; ``warp_gather_bwd``
    reads the four cotangents at ``esz`` in place of writing the values, and
    writes two f32 coordinate gradients."""
    n = pixels
    extra = {"warp_gather": 24 * n, "warp_gather_nograd": 0, "warp_gather_bwd": 8 * n}[kernel]
    return 3 * n + 8 * n + 4 * n * esz + extra


def bound_s(nbytes: float, flops: float, flops_dtype: str, device_name: str) -> float:
    """The least time (s) the card could take: the larger of the bytes over
    the memory rate and the operations over the peak of their type."""
    p = PEAKS[device_name]
    return max(nbytes / p["hbm_bytes_per_s"], flops / p["flops"][flops_dtype])


class KernelCalls:
    """The reference's calls of the kernels' functions in one step: FLOPs by
    function, and each call's shapes (for the rooflines' bounds)."""

    def __init__(self):
        self.flops: dict[str, int] = {}
        self.calls: list[tuple] = []  # (function, phase, shape tuple)

    def add(self, name: str, phase: str, flops: int, shape: tuple) -> None:
        key = name if phase == "fwd" else f"{name} backward"
        self.flops[key] = self.flops.get(key, 0) + int(flops)
        self.calls.append((name, phase, tuple(shape)))

    @property
    def total(self) -> int:
        return sum(self.flops.values())


class _CountBackward(torch.autograd.Function):
    """The identity on its tensors; its backward records the function's
    backward call."""

    @staticmethod
    def forward(ctx, calls, name, flops, shape, *tensors):
        ctx.calls, ctx.name, ctx.flops, ctx.shape = calls, name, flops, shape
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        ctx.calls.add(ctx.name, "bwd", ctx.flops, ctx.shape)
        return (None, None, None, None, *grads)


def counted(calls: KernelCalls | None, name: str, fwd: int, bwd: int, shape, *tensors):
    """Record ``name``'s forward now and its backward when it runs; returns
    ``tensors``, those that take a gradient passed through the counting
    identity. With ``calls`` None, ``tensors`` as they are."""
    if calls is None:
        return tensors
    calls.add(name, "fwd", fwd, shape)
    grad = [i for i, t in enumerate(tensors) if t.requires_grad]
    if not bwd or not grad or not torch.is_grad_enabled():
        return tensors
    passed = _CountBackward.apply(calls, name, bwd, tuple(shape), *(tensors[i] for i in grad))
    out = list(tensors)
    for i, t in zip(grad, passed):
        out[i] = t
    return tuple(out)
