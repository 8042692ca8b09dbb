"""DANet-style position and channel attention on NHWC tensors.

Port of the JAX package's ``models/attention.py`` (the reference's
structures/attention.py, PAM_Module and CAM_Module). Each module adds
``gamma`` times its attention output to its input; ``gamma`` is a learnable
scalar that starts at 0, so a new module is the identity. The products are
plain matmuls (the JAX package computes them as einsums, outside any
kernel). Names ``query_conv``, ``key_conv``, ``value_conv`` and ``gamma``
follow the reference.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import Conv


class PositionAttention(nn.Module):
    """Spatial self-attention over the H*W positions of ``channels``-wide
    features (PAM_Module, attention.py:18-50)."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        inner = max(channels // 8, 1)
        self.query_conv = Conv(channels, inner, 1, 1, 0, dtype=dtype)
        self.key_conv = Conv(channels, inner, 1, 1, 0, dtype=dtype)
        self.value_conv = Conv(channels, channels, 1, 1, 0, dtype=dtype)
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        b, h, w, c = x.shape
        q = self.query_conv(x).reshape(b, h * w, -1)
        k = self.key_conv(x).reshape(b, h * w, -1)
        v = self.value_conv(x).reshape(b, h * w, c)
        attn = torch.softmax(q @ k.transpose(1, 2), dim=-1)  # [B,N,N]
        return self.gamma * (attn @ v).reshape(b, h, w, c) + x


class ChannelAttention(nn.Module):
    """Channel self-attention (CAM_Module, attention.py:53-83)."""

    def __init__(self):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        b, h, w, c = x.shape
        flat = x.reshape(b, h * w, c)
        energy = flat.transpose(1, 2) @ flat  # [B,C,C]
        attn = torch.softmax(energy.amax(dim=-1, keepdim=True) - energy, dim=-1)
        return self.gamma * (flat @ attn.transpose(1, 2)).reshape(b, h, w, c) + x
