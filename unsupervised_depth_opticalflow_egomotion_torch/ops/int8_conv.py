"""Dynamic-range int8 convolution with straight-through gradients.

Port of the JAX package's ``ops/int8_conv.py`` (the depth encoder's convs
under ``Config.encoder_int8``), in its arithmetic:

- activations quantise per tensor and weights per output channel, both
  symmetric: s = max(absmax, 1e-8) / 127, q = round-half-even(x / s)
  clipped to +-127, in f32;
- the convolution accumulates the int8 products in int32, and the result
  is rescaled in f32 by ``sx * sk`` and cast to the compute dtype;
- the backward is straight-through: the float convolution's VJP at the
  dequantised operands (``q * s`` in f32, cast to the compute dtype), the
  cotangent cast to that dtype, and dk cast to f32 (the parameter's dtype).

The int32 accumulators come from one lowering (the JAX package chooses
between two TPU lowerings of the same integers; the port has no switch):
int8 im2col (K = kh * kw * Cin in (kh, kw, Cin) order, zero-padded to a
multiple of 8: the 7x7 stem's 147 becomes 152), then on the card one
``torch._int_mm``, an int8 tensor-core GEMM with int32 accumulation. The
JAX package computes this with ``lax.conv_general_dilated``, outside any
Pallas kernel. On CPU tensors the same columns go through an exact int64
``torch.matmul`` (``conv_i32_plain``), the card path's oracle.

Activations are NHWC and weights torch's [O, I, kh, kw], as ``models/
layers.Conv``'s.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class CallCount:
    """Calls of the card path's int8 GEMM, counted where ``torch._int_mm``
    is called and nowhere else, so a run can show that its convolutions
    went through it."""

    def __init__(self):
        self.launches = 0


INT_MM = CallCount()


def quant_act(x: torch.Tensor):
    """Per-tensor symmetric int8: (q, s), q = round(x / s), s = absmax / 127."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / s), -127.0, 127.0)
    return q.to(torch.int8), s


def quant_weight(w: torch.Tensor):
    """Per-output-channel symmetric int8 of an [O, I, kh, kw] weight: (q, s[O])."""
    wf = w.float()
    s = torch.clamp(wf.abs().amax(dim=(1, 2, 3)), min=1e-8) / 127.0
    q = torch.clamp(torch.round(wf / s[:, None, None, None]), -127.0, 127.0)
    return q.to(torch.int8), s


def _im2col(xq: torch.Tensor, kernel: int, stride: int, padding: int):
    """[B*Ho*Wo, kernel*kernel*Cin] int8 columns of NHWC ``xq`` (zero
    padding), and (B, Ho, Wo)."""
    xp = F.pad(xq, (0, 0, padding, padding, padding, padding))
    b, hp, wp, c = xp.shape
    ho, wo = (hp - kernel) // stride + 1, (wp - kernel) // stride + 1
    sb, sh, sw, sc = xp.stride()
    cols = xp.as_strided((b, ho, wo, kernel, kernel, c),
                         (sb, sh * stride, sw * stride, sh, sw, sc))
    return cols.reshape(b * ho * wo, kernel * kernel * c), (b, ho, wo)


def _weight_rows(wq: torch.Tensor) -> torch.Tensor:
    """[O, kh*kw*I] rows of an [O, I, kh, kw] weight, in the columns' order."""
    return wq.permute(0, 2, 3, 1).reshape(wq.shape[0], -1)


def conv_i32_plain(xq, wq, stride: int, padding: int) -> torch.Tensor:
    """The exact int32 accumulators (NHWC) by an int64 matmul."""
    cols, (b, ho, wo) = _im2col(xq, wq.shape[-1], stride, padding)
    acc = torch.matmul(cols.long(), _weight_rows(wq).long().t())
    return acc.to(torch.int32).view(b, ho, wo, -1)


def conv_i32_card(xq, wq, stride: int, padding: int) -> torch.Tensor:
    """The int32 accumulators (NHWC) on the card: im2col and one
    ``torch._int_mm``. Its shape rules: K and N multiples of 8 (K is
    zero-padded; N is a ResNet width), more than 16 rows (padded)."""
    if not (xq.is_cuda and wq.is_cuda):
        raise ValueError("conv_i32_card: expected CUDA tensors")
    cols, (b, ho, wo) = _im2col(xq, wq.shape[-1], stride, padding)
    rows = _weight_rows(wq)
    m, k = cols.shape
    if rows.shape[0] % 8:
        raise ValueError(f"int8 conv: {rows.shape[0]} output channels, not a multiple of 8")
    pad_k, pad_m = -k % 8, max(17 - m, 0)
    if pad_k or pad_m:
        cols = F.pad(cols, (0, pad_k, 0, pad_m))
        rows = F.pad(rows, (0, pad_k))
    acc = torch._int_mm(cols, rows.contiguous().t())
    INT_MM.launches += 1
    return acc[:m].view(b, ho, wo, -1)


def conv_i32(xq, wq, stride: int, padding: int) -> torch.Tensor:
    """The card path on CUDA tensors, the plain version on CPU tensors."""
    if xq.is_cuda:
        return conv_i32_card(xq, wq, stride, padding)
    return conv_i32_plain(xq, wq, stride, padding)


class _Int8Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding):
        xq, sx = quant_act(x)
        wq, sw = quant_weight(w)
        y = conv_i32(xq, wq, stride, padding).float() * (sx * sw)
        ctx.save_for_backward(xq, sx, wq, sw)
        ctx.conf = (stride, padding, x.dtype)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        xq, sx, wq, sw = ctx.saved_tensors
        stride, padding, dt = ctx.conf
        # the dequantised operands are the points the forward multiplied
        xdq = (xq.float() * sx).to(dt).permute(0, 3, 1, 2)
        wdq = (wq.float() * sw[:, None, None, None]).to(dt)
        dx, dw, _ = torch.ops.aten.convolution_backward(
            g.to(dt).permute(0, 3, 1, 2), xdq, wdq, None, [stride] * 2, [padding] * 2,
            [1, 1], False, [0, 0], 1, [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False],
        )
        dx = None if dx is None else dx.permute(0, 2, 3, 1)
        return dx, None if dw is None else dw.float(), None, None


def int8_conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 1) -> torch.Tensor:
    """NHWC conv with an int8 forward and a straight-through backward.

    ``x`` [B, H, W, Cin] in the compute dtype (bf16 / f32), ``w`` the f32
    [Co, Cin, k, k] parameter; symmetric ``padding``. Output in ``x.dtype``.
    """
    return _Int8Conv.apply(x, w, stride, padding)
