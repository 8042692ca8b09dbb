"""PWC correlation cost volume (NHWC), and its CUDA kernels.

Port of the JAX package's ``ops/cost_volume.py`` and of the Pallas kernels
in ``ops/pallas/correlation_fused.py`` and ``ops/pallas/correlation.py``.
Entry (i, j) of the last dim is mean_c f1[y, x, c] * f2[y + i - md,
x + j - md, c] with zero padding outside f2, row-major over (i, j) (the
reference's pwc_tf.py:97-106).

``correlation`` is the autograd entry used by the PWC decoder at every
level; ``impl`` is ``Config.pwc_corr``:

- "fused" (the default): on CUDA tensors the forward and the backward launch
  csrc/correlation.cu (``CORR_FWD``, ``CORR_BWD_DF1``, ``CORR_BWD_DF2``); on
  CPU tensors they run the plain versions below.
- "pallas": the forward kernel (``CORR_FWD``) with the plain 81-shift
  backward, as the JAX package's ``correlation_pallas`` has a forward kernel
  and an XLA backward.
- "xla": ``correlation_plain`` under autograd on every device.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import flops
from .cuda_lib import DTYPE_CODE, CudaKernel, check_cuda_tensor

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, _P, _P, _I, _I, _I, _I, _I, _I]

CORR_FWD = CudaKernel("correlation", "corr_fwd", _ARGS)
CORR_BWD_DF1 = CudaKernel("correlation", "corr_bwd_df1", _ARGS)
CORR_BWD_DF2 = CudaKernel("correlation", "corr_bwd_df2", _ARGS)


def _shifts(md: int):
    n = 2 * md + 1
    return [(i, j) for i in range(n) for j in range(n)]


def correlation_plain(f1: torch.Tensor, f2: torch.Tensor, md: int = 4) -> torch.Tensor:
    """Plain PyTorch cost volume [B,H,W,C] x2 -> [B,H,W,(2md+1)^2].

    Products and sums in f32, result in the input dtype (as the kernel).
    """
    if f1.shape != f2.shape:
        raise ValueError(f"correlation: {tuple(f1.shape)} vs {tuple(f2.shape)}")
    _, h, w, c = f1.shape
    f1f = f1.float()
    f2p = F.pad(f2.float(), (0, 0, md, md, md, md))
    cv = [
        (f1f * f2p[:, i : i + h, j : j + w]).sum(-1) * (1.0 / c)
        for i, j in _shifts(md)
    ]
    return torch.stack(cv, dim=-1).to(f1.dtype)


def correlation_backward_plain(g, f1, f2, md: int = 4):
    """Plain PyTorch VJP of the cost volume: (df1, df2), f32 sums."""
    _, h, w, c = f1.shape
    gf = g.float()
    f1f = f1.float()
    f2p = F.pad(f2.float(), (0, 0, md, md, md, md))
    df1 = torch.zeros_like(f1f)
    df2p = torch.zeros_like(f2p)
    for d, (i, j) in enumerate(_shifts(md)):
        gd = gf[..., d : d + 1]
        df1 += gd * f2p[:, i : i + h, j : j + w]
        df2p[:, i : i + h, j : j + w] += gd * f1f
    df2 = df2p[:, md : md + h, md : md + w]
    return (df1 / c).to(f1.dtype), (df2 / c).to(f2.dtype)


def _check(name, t, shape, device=None) -> int:
    return check_cuda_tensor(name, t, (torch.bfloat16, torch.float32), shape, device)


def corr_forward(f1: torch.Tensor, f2: torch.Tensor, md: int = 4) -> torch.Tensor:
    """Cost volume forward: the kernel on CUDA tensors, plain on CPU."""
    if f1.device.type == "cpu":
        return correlation_plain(f1, f2, md)
    b, h, w, c = f1.shape
    dev = _check("f1", f1, None)
    _check("f2", f2, f1.shape, dev)
    if f2.dtype != f1.dtype:
        raise TypeError(f"correlation: dtypes {f1.dtype} vs {f2.dtype}")
    n = (2 * md + 1) ** 2
    out = torch.empty((b, h, w, n), device=f1.device, dtype=f1.dtype)
    CORR_FWD(dev, f1.data_ptr(), f2.data_ptr(), out.data_ptr(), DTYPE_CODE[f1.dtype],
             b, h, w, c, md)
    return out


def corr_backward(g: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor, md: int = 4):
    """Cost volume VJP (df1, df2): the kernels on CUDA tensors, plain on CPU."""
    if f1.device.type == "cpu":
        return correlation_backward_plain(g, f1, f2, md)
    b, h, w, c = f1.shape
    n = (2 * md + 1) ** 2
    dev = _check("f1", f1, None)
    _check("f2", f2, f1.shape, dev)
    _check("g", g, (b, h, w, n), dev)
    if not (g.dtype == f1.dtype == f2.dtype):
        raise TypeError(f"correlation bwd: dtypes {g.dtype}, {f1.dtype}, {f2.dtype}")
    code = DTYPE_CODE[f1.dtype]
    df1 = torch.empty_like(f1)
    df2 = torch.empty_like(f2)
    CORR_BWD_DF1(dev, g.data_ptr(), f2.data_ptr(), df1.data_ptr(), code, b, h, w, c, md)
    CORR_BWD_DF2(dev, g.data_ptr(), f1.data_ptr(), df2.data_ptr(), code, b, h, w, c, md)
    return df1, df2


class Correlation(torch.autograd.Function):
    """Cost volume with the kernel backward (df1 and df2 gather forms)."""

    @staticmethod
    def forward(ctx, f1, f2, md):
        ctx.save_for_backward(f1, f2)
        ctx.md = md
        return corr_forward(f1, f2, md)

    @staticmethod
    def backward(ctx, g):
        f1, f2 = ctx.saved_tensors
        df1, df2 = corr_backward(g.to(f1.dtype).contiguous(), f1, f2, ctx.md)
        return df1, df2, None


class CorrelationPlainBackward(torch.autograd.Function):
    """Cost volume with the kernel forward and the plain 81-shift backward."""

    @staticmethod
    def forward(ctx, f1, f2, md):
        ctx.save_for_backward(f1, f2)
        ctx.md = md
        return corr_forward(f1, f2, md)

    @staticmethod
    def backward(ctx, g):
        f1, f2 = ctx.saved_tensors
        df1, df2 = correlation_backward_plain(g, f1, f2, ctx.md)
        return df1, df2, None


CORR_IMPLS = ("fused", "pallas", "xla")


def correlation(
    f1: torch.Tensor, f2: torch.Tensor, md: int = 4, impl: str = "fused"
) -> torch.Tensor:
    """NHWC cost volume [B,H,W,(2md+1)^2] under ``Config.pwc_corr`` routing
    (counted by ``flops.counting()`` whatever the route)."""
    if impl not in CORR_IMPLS:
        raise ValueError(f"pwc_corr must be one of {CORR_IMPLS}, got {impl!r}")
    if flops.active():
        n = flops.corr_flops(*f1.shape, md)
        f1, f2 = flops.counted("correlation", n, n * (f1.requires_grad + f2.requires_grad), f1, f2)
    if impl == "xla":
        return correlation_plain(f1, f2, md)
    fn = Correlation if impl == "fused" else CorrelationPlainBackward
    return fn.apply(f1.contiguous(), f2.contiguous(), md)
