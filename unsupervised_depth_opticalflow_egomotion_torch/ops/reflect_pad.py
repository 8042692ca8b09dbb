"""Reflection pad of one pixel on each side of an NHWC tensor, and its kernels.

The input of the depth decoder's reflection-padded 3x3 convolutions
(``models/layers.py`` ``ReflectConv3x3``). No Pallas kernel is behind it:
the JAX package builds the halo from slices, which XLA fuses.

- ``reflect_pad_nhwc``: on a CUDA tensor the forward and the backward
  launch csrc/reflect_pad.cu (``REFLECT_PAD_FWD``, ``REFLECT_PAD_BWD``) on
  the tensor as it lies in memory, so the padded tensor is NHWC-contiguous
  and a convolution hands it to cuDNN channels-last; the backward sums the
  (at most four) cotangents of a source pixel in f32 and rounds once, with
  no atomics. On a CPU tensor it runs ``reflect_pad_plain`` under autograd.
- ``reflect_pad_plain``: ATen's reflection pad on the NCHW view, as the
  port computed it before the kernels; the CPU route and the card tests'
  yardstick.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .cuda_lib import DTYPE_CODE, CudaKernel, check_cuda_tensor

_P = ctypes.c_void_p
_I = ctypes.c_int

REFLECT_PAD_FWD = CudaKernel("reflect_pad", "reflect_pad_fwd", [_P, _P, _I, _I, _I, _I, _I])
REFLECT_PAD_BWD = CudaKernel("reflect_pad", "reflect_pad_bwd", [_P, _P, _I, _I, _I, _I, _I])


def reflect_pad_plain(x: torch.Tensor) -> torch.Tensor:
    """[B,H,W,C] -> [B,H+2,W+2,C], reflecting the border pixel's neighbour."""
    return F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect").permute(0, 2, 3, 1)


def _check(name: str, t: torch.Tensor, pad: int) -> int:
    """Validate the kernel's input ``t``: the unpadded tensor (``pad`` 0) or
    the padded one's cotangent (``pad`` 2). Returns its card's index."""
    dev = check_cuda_tensor(name, t, (torch.bfloat16, torch.float32))
    if t.dim() != 4 or min(t.shape[1], t.shape[2]) < 2 + pad:
        raise ValueError(f"reflect_pad: {name} must be [B,H,W,C] with H, W >= {2 + pad}, "
                         f"got {tuple(t.shape)}")
    b, h, w, c = t.shape
    if b * (h + 2 - pad) * (w + 2 - pad) * c >= 2**31:
        raise ValueError(f"reflect_pad: {tuple(t.shape)} pads to 2^31 elements or more")
    return dev


def reflect_pad_forward(x: torch.Tensor) -> torch.Tensor:
    """The forward kernel's launch on a contiguous CUDA tensor [B,H,W,C]."""
    dev = _check("x", x, 0)
    b, h, w, c = x.shape
    out = x.new_empty((b, h + 2, w + 2, c))
    REFLECT_PAD_FWD(dev, x.data_ptr(), out.data_ptr(), DTYPE_CODE[x.dtype], b, h, w, c)
    return out


def reflect_pad_backward(g: torch.Tensor) -> torch.Tensor:
    """The backward kernel's launch: the cotangent [B,H+2,W+2,C] of the padded
    tensor (contiguous, on the card) -> the input's gradient [B,H,W,C]."""
    dev = _check("g", g, 2)
    b, h, w, c = g.shape
    dx = g.new_empty((b, h - 2, w - 2, c))
    REFLECT_PAD_BWD(dev, g.data_ptr(), dx.data_ptr(), DTYPE_CODE[g.dtype], b, h - 2, w - 2, c)
    return dx


class ReflectPad(torch.autograd.Function):
    """The pad with the gather-form backward; saves nothing."""

    @staticmethod
    def forward(ctx, x):
        return reflect_pad_forward(x)

    @staticmethod
    def backward(ctx, g):
        return reflect_pad_backward(g.contiguous())


def reflect_pad_nhwc(x: torch.Tensor) -> torch.Tensor:
    """[B,H,W,C] -> [B,H+2,W+2,C]: the kernels on a CUDA tensor (made
    contiguous first), the plain version on a CPU one."""
    if x.device.type == "cpu":
        return reflect_pad_plain(x)
    return ReflectPad.apply(x.contiguous())
