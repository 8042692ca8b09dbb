"""FLOP counts of the kernels' functions, and a context that counts them in a run.

The CUDA kernels of ``csrc/`` are launched through ctypes, where
``torch.utils.flop_counter.FlopCounterMode`` does not see them, and their
plain versions are elementwise work that it does not count. So this module
holds one formula for each kernel (the FLOPs of a launch at given sizes, from
which ``chip_smoke.py`` computes the kernels' bounds), and ``counting()``,
which adds up the work of the functions that the kernels compute while a
step runs (``bench.py``'s ``flops_per_step`` is this count plus
``FlopCounterMode``'s).

Inside a ``counting()`` block each function adds its count for the shapes it
is called on, whichever route computes it: the kernel on a CUDA tensor, its
plain version on a CPU tensor, or the plain route that ``pwc_corr``,
``ssim_impl`` and ``warp_impl`` = "xla" pick. So the count reads the same
work whatever implements it.

- ``correlation`` (``cost_volume.correlation``): forward ``corr_flops``
  (2 x the multiply-adds of the shifts that land inside the frame); the
  backward ``corr_flops`` for each of f1 and f2 that takes a gradient (df1,
  df2).
- ``ssim`` (``ssim.ssim``): forward ``SSIM_FWD_FLOPS`` an element, backward
  ``SSIM_BWD_FLOPS`` an element.
- ``warp`` (``warp.grid_sample_with_weight`` of a 3-channel data source):
  forward the values and the weight sum (``WARP_NOGRAD_FLOPS_PER_PIXEL`` an
  output pixel), backward the coordinate VJP (``WARP_BWD_FLOPS_PER_PIXEL``).
  The fused form's derivative planes are its way to that VJP, not more of
  the function's work, so all three forms and the plain sampler count alike.
- ``splat`` (``splat.occlusion_mask_from_flow``, bilinear taps): forward
  ``SPLAT_FLOPS_PER_PIXEL`` a source pixel; it has no backward.
- ``int8_conv`` (``int8_conv.conv_i32_card``, under ``encoder_int8`` on
  the card): the int8 GEMM of the im2col columns, 2 M N K at the
  convolution's K (``torch._int_mm`` pads K to a multiple of 8; the padding
  is not counted). ``FlopCounterMode`` has no count for ``torch._int_mm``,
  and counts the plain route's int64 matmul (the same 2 M N K) and the
  straight-through backward's float convolution itself.

A backward is counted when it runs (the function's inputs pass through an
identity whose backward counts), so a function whose output feeds no loss
adds only its forward. Outside a ``counting()`` block nothing changes.
"""

from __future__ import annotations

import contextlib

import torch

# per output pixel, warp_gather: tap weights, 3 values, 6 derivatives, weight sum
WARP_FLOPS_PER_PIXEL = 105
WARP_NOGRAD_FLOPS_PER_PIXEL = 60  # tap weights, 3 values, weight sum
WARP_BWD_FLOPS_PER_PIXEL = 90  # tap weights, 6 derivatives contracted, weight-sum term
SSIM_FWD_FLOPS = 70  # per element: five 9-tap sums, the map
SSIM_BWD_FLOPS = 150  # per element: the statistics again, four planes, four 9-tap sums
SPLAT_FLOPS_PER_PIXEL = 20  # per source pixel


def valid_shifts(h: int, w: int, md: int) -> int:
    """Shift-pixel pairs of the cost volume that land inside the frame."""
    return sum(h - abs(d) for d in range(-md, md + 1)) * sum(
        w - abs(d) for d in range(-md, md + 1)
    )


def corr_flops(b: int, h: int, w: int, c: int, md: int = 4) -> int:
    """One launch of ``corr_fwd``, ``corr_bwd_df1`` or ``corr_bwd_df2``:
    a multiply and an add per channel of every in-frame shift."""
    return 2 * b * valid_shifts(h, w, md) * c


def warp_gather_flops(pixels: int) -> int:
    return WARP_FLOPS_PER_PIXEL * pixels


def warp_gather_nograd_flops(pixels: int) -> int:
    return WARP_NOGRAD_FLOPS_PER_PIXEL * pixels


def warp_gather_bwd_flops(pixels: int) -> int:
    return WARP_BWD_FLOPS_PER_PIXEL * pixels


def ssim_fwd_flops(elements: int) -> int:
    return SSIM_FWD_FLOPS * elements


def ssim_bwd_flops(elements: int) -> int:
    return SSIM_BWD_FLOPS * elements


def splat_mass_flops(pixels: int) -> int:
    return SPLAT_FLOPS_PER_PIXEL * pixels


class KernelFlops:
    """The counts of one ``counting()`` block, by function ("correlation",
    "ssim", "warp", "splat", "int8_conv"; a backward as "<name> backward")."""

    def __init__(self):
        self.by_function: dict[str, int] = {}

    def add(self, name: str, flops: int) -> None:
        self.by_function[name] = self.by_function.get(name, 0) + int(flops)

    @property
    def total(self) -> int:
        return sum(self.by_function.values())


_open: KernelFlops | None = None


@contextlib.contextmanager
def counting():
    """Count the kernels' functions until the block closes; yields the
    ``KernelFlops`` that holds the counts."""
    global _open
    prev, _open = _open, KernelFlops()
    try:
        yield _open
    finally:
        _open = prev


def active() -> bool:
    return _open is not None


def count(name: str, flops: int) -> None:
    """Add ``flops`` to ``name`` in the open count, if one is open."""
    if _open is not None:
        _open.add(name, flops)


class _CountBackward(torch.autograd.Function):
    """The identity on its tensors; its backward adds the function's
    backward count to the count that was open at the forward."""

    @staticmethod
    def forward(ctx, counter, name, flops, *tensors):
        ctx.counter, ctx.name, ctx.flops = counter, name, flops
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        ctx.counter.add(ctx.name + " backward", ctx.flops)
        return (None, None, None, *grads)


def counted(name: str, fwd: int, bwd: int, *tensors):
    """Count ``name``'s forward (``fwd``) now and its backward (``bwd``)
    when it runs; returns ``tensors``, those that take a gradient passed
    through the counting identity. Outside ``counting()``, ``tensors`` as
    they are."""
    counter = _open
    if counter is None:
        return tensors
    counter.add(name, fwd)
    grad = [i for i, t in enumerate(tensors) if t.requires_grad]
    if not bwd or not grad or not torch.is_grad_enabled():
        return tensors
    passed = _CountBackward.apply(counter, name, bwd, *(tensors[i] for i in grad))
    out = list(tensors)
    for i, t in zip(grad, passed):
        out[i] = t
    return tuple(out)
