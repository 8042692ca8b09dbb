"""Shared conv building blocks on NHWC tensors (port of ``models/layers.py``).

Activations stay NHWC as in the JAX package; a conv views its input as
NCHW (a channels-last tensor, which cuDNN takes without a copy) and hands
back NHWC. Parameters keep torch's layouts and the reference's state_dict
names ([O, I, kh, kw] conv weights, BatchNorm weight/bias/running_*).

Precision follows flax's ``dtype``: parameters are f32, and each conv casts
its input and parameters to the module's compute dtype (explicit casts, no
autocast). BatchNorm statistics are f32.

Padding is explicit and symmetric (torch-style), never 'SAME'.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..ops.int8_conv import int8_conv
from ..ops.reflect_pad import reflect_pad_nhwc


class Conv(nn.Module):
    """Conv2d on NHWC tensors with torch-style symmetric padding.

    ``kernel`` and ``padding`` take an int (square) or a (rows, columns)
    pair, as ``nn.Conv2d`` does. ``init`` picks the reference's effective
    initialisation: "torch" = Conv2d's default kaiming-uniform(a=sqrt(5)),
    i.e. U(+-1/sqrt(fan_in)), with zero bias; "kaiming_out" =
    kaiming-normal(fan_out) (ResNet).
    ``int8`` runs the forward in int8 with a straight-through backward
    (``ops/int8_conv.py``; no bias, no dilation).
    """

    def __init__(self, cin, cout, kernel=3, stride=1, padding=1, dilation=1,
                 bias=True, init="torch", dtype=torch.float32, int8=False):
        super().__init__()
        if int8 and (bias or dilation != 1):
            raise ValueError("an int8 conv takes no bias and no dilation")
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        self.weight = nn.Parameter(torch.empty(cout, cin, kh, kw))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.init, self.dtype, self.int8 = init, dtype, int8

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        o, i, kh, kw = self.weight.shape
        if self.init == "kaiming_out":
            std = math.sqrt(2.0 / (o * kh * kw))
            self.weight.copy_(torch.randn(self.weight.shape, generator=gen) * std)
        else:
            bound = 1.0 / math.sqrt(i * kh * kw)
            self.weight.copy_(torch.rand(self.weight.shape, generator=gen) * 2 * bound - bound)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if self.int8:
            return int8_conv(x.to(dt), self.weight, self.stride, self.padding)
        y = F.conv2d(
            x.to(dt).permute(0, 3, 1, 2),
            self.weight.to(dt),
            None if self.bias is None else self.bias.to(dt),
            self.stride, self.padding, self.dilation,
        )
        return y.permute(0, 2, 3, 1)


class Linear(nn.Module):
    """Dense layer (torch weight layout [O, I]) in the compute dtype."""

    def __init__(self, cin, cout, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))
        self.dtype = dtype

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        self.weight.copy_(torch.rand(self.weight.shape, generator=gen) * 2 * bound - bound)
        self.bias.zero_()

    def forward(self, x):
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def conv_lrelu(cin, cout, kernel=3, stride=1, padding=1, dilation=1, dtype=torch.float32):
    """Conv2d + LeakyReLU(0.1) as ``Sequential`` (state_dict name ``<n>.0``)."""
    return nn.Sequential(
        Conv(cin, cout, kernel, stride, padding, dilation, dtype=dtype),
        nn.LeakyReLU(0.1),
    )


class ReflectConv3x3(nn.Module):
    """Reflection-padded 3x3 conv (monodepth2's Conv3x3; weights at ``.conv``).
    On the card the pad is ``ops/reflect_pad.py``'s kernel pair, whose
    NHWC-contiguous output the conv hands to cuDNN channels-last."""

    def __init__(self, cin, cout, dtype=torch.float32):
        super().__init__()
        self.conv = Conv(cin, cout, 3, 1, 0, dtype=dtype)

    def forward(self, x):
        return self.conv(reflect_pad_nhwc(x))


class _AllReduceSum(torch.autograd.Function):
    """The sum over a process group, whose backward sums the cotangent over
    the group: each rank's sums feed every rank's statistics, so each
    rank's gradient of them is the sum of every rank's cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class BatchNorm(nn.Module):
    """BatchNorm over the channel (last) axis with flax's semantics.

    Train mode: batch mean and the BIASED variance E[x^2]-E[x]^2 (clipped
    at 0) in f32; the running statistics update as
    ra = 0.9 * ra + 0.1 * stat, for the variance with the biased batch
    variance as flax does (torch's BatchNorm2d uses the unbiased one).
    eps 1e-5. Normalization in f32, result in the compute dtype.

    With a process ``group`` (``parallel/mesh.sync_batch_norm``) the train
    statistics are those of the group's global batch, as a ``jit`` over
    the JAX package's mesh computes them: the f32 per-channel sums of x and
    x^2 and the element count go through one all-reduce a layer, which
    carries the gradient. Every rank then updates the same running
    statistics.
    """

    def __init__(self, c, momentum=0.9, eps=1e-5, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.group = None

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        del gen
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def _global_stats(self, xf, dims):
        c = xf.shape[-1]
        sums = torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                          xf.new_full((1,), xf.numel() // c)])
        sums = _AllReduceSum.apply(sums, self.group)
        mean = sums[:c] / sums[-1]
        return mean, torch.clamp(sums[c:-1] / sums[-1] - mean * mean, min=0.0)

    def forward(self, x):
        if self.training:
            xf = x.float()
            dims = tuple(range(x.dim() - 1))
            if self.group is None:
                mean = xf.mean(dims)
                var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
            else:
                mean, var = self._global_stats(xf, dims)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1.0 - m) * mean)
                self.running_var.mul_(m).add_((1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x.float() - mean) * mul + self.bias).to(self.dtype)


def max_pool_3x3_s2_p1(x):
    """torch MaxPool2d(kernel_size=3, stride=2, padding=1) on NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


@contextlib.contextmanager
def module_mode(module: nn.Module, training: bool):
    """``module`` and every submodule in train (True) or eval mode for the
    duration; each one's own mode comes back after."""
    modes = [(m, m.training) for m in module.modules()]
    module.train(training)
    try:
        yield
    finally:
        for m, was in modes:
            m.training = was


def init_weights(module: nn.Module, gen: torch.Generator) -> None:
    """Initialise every layer of ``module`` in a fixed order from ``gen``."""
    for m in module.modules():
        if isinstance(m, (Conv, Linear, BatchNorm)):
            m.reset_parameters(gen)
