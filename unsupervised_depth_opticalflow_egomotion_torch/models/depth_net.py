"""Monodepth2-style depth network: ResNet-18 encoder + skip decoder (NHWC).

Port of the JAX package's ``models/depth_net.py`` in its logical (unpacked)
form. The JAX flags ``packed_convs`` / ``packed_encoder`` / ``packed_stem``
only change TPU layouts over an identical parameter tree; here they are
accepted and change nothing. ``encoder_int8`` runs every encoder conv (the
7x7 stem, both 3x3 convs of each BasicBlock, the 1x1 downsample) in int8
with a straight-through backward (``ops/int8_conv.py``), over the same
parameters.

Input normalisation (x - 0.45) / 0.225; sigmoid disparity heads at
``num_scales`` scales (and ``extra_head_scales`` coarser ones for the loss
base scale), returned fine to coarse. Module names follow the
reference state_dict: ``encoder.encoder.{conv1,bn1,layer1..4}``,
``decoder.upconvs.<i>.<j>.conv.conv``, ``decoder.dispconvs.<s>.conv``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.interp import upsample2x_bilinear
from .layers import BatchNorm, Conv, ReflectConv3x3, max_pool_3x3_s2_p1

_DEC_CH = (16, 32, 64, 128, 256)
_ENC_CH = (64, 64, 128, 256, 512)


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride=1, dtype=torch.float32, int8=False):
        super().__init__()
        kw = dict(bias=False, init="kaiming_out", dtype=dtype, int8=int8)
        self.conv1 = Conv(cin, cout, 3, stride, 1, **kw)
        self.bn1 = BatchNorm(cout, dtype=dtype)
        self.conv2 = Conv(cout, cout, 3, 1, 1, **kw)
        self.bn2 = BatchNorm(cout, dtype=dtype)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                Conv(cin, cout, 1, stride, 0, **kw), BatchNorm(cout, dtype=dtype)
            )

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNet18(nn.Module):
    def __init__(self, dtype=torch.float32, int8=False):
        super().__init__()
        self.conv1 = Conv(3, 64, 7, 2, 3, bias=False, init="kaiming_out", dtype=dtype, int8=int8)
        self.bn1 = BatchNorm(64, dtype=dtype)
        cin = 64
        for li, cout in enumerate((64, 128, 256, 512), start=1):
            stride = 1 if li == 1 else 2
            layer = nn.Sequential(
                BasicBlock(cin, cout, stride, dtype, int8), BasicBlock(cout, cout, 1, dtype, int8)
            )
            setattr(self, f"layer{li}", layer)
            cin = cout

    def forward(self, img):
        """Returns the 5 monodepth2 skip features."""
        x = (img - 0.45) / 0.225
        f0 = F.relu(self.bn1(self.conv1(x)))
        f1 = self.layer1(max_pool_3x3_s2_p1(f0))
        f2 = self.layer2(f1)
        f3 = self.layer3(f2)
        f4 = self.layer4(f3)
        return f0, f1, f2, f3, f4


class ResnetEncoder(nn.Module):
    def __init__(self, dtype=torch.float32, int8=False):
        super().__init__()
        self.encoder = ResNet18(dtype, int8)

    def forward(self, img):
        return self.encoder(img)


class ConvBlock(nn.Module):
    """ReflectConv3x3 + ELU (weights at ``.conv.conv``)."""

    def __init__(self, cin, cout, dtype=torch.float32):
        super().__init__()
        self.conv = ReflectConv3x3(cin, cout, dtype)

    def forward(self, x):
        return F.elu(self.conv(x))


class DepthDecoder(nn.Module):
    """Skip decoder with sigmoid disparity heads; ``upconvs[i]`` is scale 4-i.

    ``dispconvs[s]`` is the head of scale s: ``num_scales`` heads, then
    ``extra_head_scales`` coarser ones (the loss base scale's, the JAX
    package's ``ReflectConv3x3_x{s}``).
    """

    def __init__(self, num_scales=3, dtype=torch.float32, extra_head_scales=0):
        super().__init__()
        self.num_scales = num_scales
        self.num_heads = num_scales + extra_head_scales
        if self.num_heads > 5:
            raise ValueError(f"at most 5 disparity heads; got {self.num_heads}")
        ups = []
        cin = _ENC_CH[-1]
        for scale in range(4, -1, -1):
            c0 = ConvBlock(cin, _DEC_CH[scale], dtype)
            skip = _ENC_CH[scale - 1] if scale > 0 else 0
            c1 = ConvBlock(_DEC_CH[scale] + skip, _DEC_CH[scale], dtype)
            ups.append(nn.ModuleList([c0, c1]))
            cin = _DEC_CH[scale]
        self.upconvs = nn.ModuleList(ups)
        self.dispconvs = nn.ModuleList(
            [ReflectConv3x3(_DEC_CH[s], 1, dtype) for s in range(self.num_heads)]
        )

    def forward(self, features, min_scale: int = 0):
        """The disparities of scales ``min_scale`` .. ``num_heads - 1``, fine
        to coarse; the decoder stops at ``min_scale`` (the finer segment feeds
        nothing then)."""
        outputs = {}
        x = features[-1]
        for i, scale in enumerate(range(4, min_scale - 1, -1)):
            x = upsample2x_bilinear(self.upconvs[i][0](x))
            if scale > 0:
                x = torch.cat([x, features[scale - 1]], dim=-1)
            x = self.upconvs[i][1](x)
            if scale < self.num_heads:
                outputs[scale] = torch.sigmoid(self.dispconvs[scale](x))
        return [outputs[s] for s in range(min_scale, self.num_heads)]


class DepthNet(nn.Module):
    """Encoder + decoder; returns the disparity pyramid [full, 1/2, 1/4, ...]
    (from scale ``min_scale`` when it is given)."""

    def __init__(self, num_scales=3, packed=True, packed_encoder=False,
                 packed_stem=False, encoder_int8=False, dtype=torch.float32,
                 extra_head_scales=0):
        super().__init__()
        if encoder_int8 and (packed_encoder or packed_stem):
            # as the JAX package's encoder: both rewrite the same convs
            raise ValueError("encoder int8 and packed modes are exclusive")
        del packed, packed_encoder, packed_stem  # TPU layouts, same math
        self.encoder = ResnetEncoder(dtype, encoder_int8)
        self.decoder = DepthDecoder(num_scales, dtype, extra_head_scales)

    def forward(self, img, min_scale: int = 0):
        if min(img.shape[1], img.shape[2]) < 64:
            raise ValueError(f"DepthNet needs input >= 64 px per side; got {tuple(img.shape)}")
        return self.decoder(self.encoder(img), min_scale)
