"""SSIM over 3x3 mean windows (NHWC), and its CUDA kernels.

Port of the JAX package's ``ops/ssim.py`` and of the fused Pallas kernels in
``ops/pallas/ssim_fused.py``. 3x3 average-pool statistics with stride 1 and
zero padding 1, divisor 9 at every pixel (torch AvgPool2d counts the padded
zeros), C1=0.01^2, C2=0.03^2, statistics in f32 (bf16 statistics cancel
catastrophically in smooth regions and give a NaN gradient), the map in the
input's type.

``Config.ssim_impl`` selects the implementation:

- "pallas" (the default): on CUDA tensors the forward and the closed-form
  backward launch csrc/ssim.cu (``SSIM_FWD``, ``SSIM_BWD``) at every scale;
  on CPU tensors it runs ``ssim_plain`` under autograd. The kernels take 1
  to 4 channels; an image of more goes to them as B·C one-channel images
  (the channels do not mix), one copy in and one out.
- "xla": ``ssim_plain`` under autograd on every device.

``ssim_backward_plain`` is the kernel backward's plain version: the same
closed form (not autograd of the plain map), written with the same pooling.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import flops
from .cuda_lib import DTYPE_CODE, CudaKernel, check_cuda_tensor

_P = ctypes.c_void_p
_I = ctypes.c_int

SSIM_FWD = CudaKernel("ssim", "ssim_fwd", [_P, _P, _P, _I, _I, _I, _I, _I])
SSIM_BWD = CudaKernel("ssim", "ssim_bwd", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I])

C1 = 0.01**2
C2 = 0.03**2


def _avg3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 box mean of NHWC ``x`` with zero padding and divisor 9."""
    y = F.avg_pool2d(
        x.permute(0, 3, 1, 2), 3, stride=1, padding=1, count_include_pad=True
    )
    return y.permute(0, 2, 3, 1)


def _terms(x: torch.Tensor, y: torch.Tensor):
    """(m1, m2, a, b1, c, e) of the SSIM map: s = (b1 a) / (e c), all f32."""
    m1 = _avg3x3(x)
    m2 = _avg3x3(y)
    sigma_x = _avg3x3(x * x) - m1 * m1
    sigma_y = _avg3x3(y * y) - m2 * m2
    sigma_xy = _avg3x3(x * y) - m1 * m2
    a = 2 * sigma_xy + C2
    b1 = 2 * m1 * m2 + C1
    c = sigma_x + sigma_y + C2
    e = m1 * m1 + m2 * m2 + C1
    return m1, m2, a, b1, c, e


def ssim_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-pixel SSIM map of two NHWC images, f32 statistics, input dtype out."""
    _, _, a, b1, c, e = _terms(x.float(), y.float())
    return ((b1 * a) / (e * c)).to(x.dtype)


def ssim_backward_plain(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor):
    """Plain PyTorch version of the backward kernel: (dx, dy) for cotangent
    ``g`` by the closed-form adjoint (the 1/9 zero-padded box filter is its
    own adjoint), f32 throughout, results in the input dtype."""
    xf, yf = x.float(), y.float()
    m1, m2, a, b1, c, e = _terms(xf, yf)
    d = e * c
    u = g.float() / d
    v = -u * (b1 * a) / d
    gab = u * (a - b1)
    hce = v * (c - e)
    q1 = _avg3x3(2 * m2 * gab + 2 * m1 * hce)
    q2 = _avg3x3(2 * m1 * gab + 2 * m2 * hce)
    q3 = _avg3x3(v * e)
    q5 = _avg3x3(2 * u * b1)
    dx = q1 + 2 * xf * q3 + yf * q5
    dy = q2 + 2 * yf * q3 + xf * q5
    return dx.to(x.dtype), dy.to(y.dtype)


def _check_pair(x: torch.Tensor, y: torch.Tensor) -> int:
    dev = check_cuda_tensor("x", x, (torch.bfloat16, torch.float32))
    check_cuda_tensor("y", y, (x.dtype,), x.shape, dev)
    if x.dim() != 4:
        raise ValueError(f"ssim: expected [B,H,W,C], got {tuple(x.shape)}")
    return dev


def to_planes(t: torch.Tensor) -> torch.Tensor:
    """[B,H,W,C] -> [B*C,H,W,1]: each channel as an image of its own."""
    b, h, w, c = t.shape
    return t.permute(0, 3, 1, 2).reshape(b * c, h, w, 1).contiguous()


def from_planes(t: torch.Tensor, c: int) -> torch.Tensor:
    """The inverse of ``to_planes`` for ``c`` channels."""
    bc, h, w, _ = t.shape
    return t.reshape(bc // c, c, h, w).permute(0, 2, 3, 1).contiguous()


def ssim_forward(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """SSIM map: the kernel on CUDA tensors, the plain version on CPU."""
    if x.is_cpu:
        return ssim_plain(x, y)
    return ssim_forward_kernel(x, y)


def ssim_forward_kernel(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The forward kernel's launch; more than 4 channels go as planes."""
    dev = _check_pair(x, y)
    c = x.shape[3]
    if c > 4:  # the kernel's channel template takes 1 to 4
        return from_planes(ssim_forward_kernel(to_planes(x), to_planes(y)), c)
    out = torch.empty_like(x)
    SSIM_FWD(dev, x.data_ptr(), y.data_ptr(), out.data_ptr(), DTYPE_CODE[x.dtype], *x.shape)
    return out


def ssim_backward(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor):
    """(dx, dy) of the SSIM map for cotangent ``g`` (input dtype): the kernel
    on CUDA tensors, the plain closed form on CPU."""
    if x.is_cpu:
        return ssim_backward_plain(x, y, g)
    return ssim_backward_kernel(x, y, g)


def ssim_backward_kernel(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor):
    """The backward kernel's launch; more than 4 channels go as planes."""
    dev = _check_pair(x, y)
    check_cuda_tensor("g", g, (x.dtype,), x.shape, dev)
    c = x.shape[3]
    if c > 4:
        dx, dy = ssim_backward_kernel(to_planes(x), to_planes(y), to_planes(g))
        return from_planes(dx, c), from_planes(dy, c)
    dx = torch.empty_like(x)
    dy = torch.empty_like(y)
    SSIM_BWD(
        dev, x.data_ptr(), y.data_ptr(), g.data_ptr(), dx.data_ptr(), dy.data_ptr(),
        DTYPE_CODE[x.dtype], *x.shape,
    )
    return dx, dy


class SSIM(torch.autograd.Function):
    """The SSIM map with the closed-form backward; saves only x and y."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        return ssim_forward(x, y)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        # the cotangent is cast to the input dtype first, as the JAX wrapper does
        return ssim_backward(x, y, g.to(x.dtype).contiguous())


def ssim_route(impl: str, device: torch.device) -> str:
    """Which SSIM ``impl`` runs on ``device``: "kernel" or "plain"."""
    if impl not in ("xla", "pallas"):
        raise ValueError(f"ssim_impl must be 'xla' or 'pallas', got {impl!r}")
    return "kernel" if impl == "pallas" and torch.device(device).type == "cuda" else "plain"


def ssim(x: torch.Tensor, y: torch.Tensor, impl: str = "xla") -> torch.Tensor:
    """Per-pixel SSIM map under ``Config.ssim_impl`` routing (counted by
    ``flops.counting()`` whatever the route)."""
    if flops.active():
        n = x.numel()
        x, y = flops.counted("ssim", flops.ssim_fwd_flops(n), flops.ssim_bwd_flops(n), x, y)
    if ssim_route(impl, x.device) == "kernel":
        return SSIM.apply(x.contiguous(), y.contiguous())
    return ssim_plain(x, y)
