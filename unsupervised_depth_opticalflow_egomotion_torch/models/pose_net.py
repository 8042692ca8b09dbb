"""Pose regressor: 7-conv CNN + spatial self-attention refinement (NHWC).

Port of the JAX package's ``models/pose_net.py``: strided conv stack
16-32-64-128-256-256-256 with ReLU, a 1x1 head to 6*(N-1) channels, and the
attention refinement (Q/K/V linear maps over the flattened spatial dim,
softmax over axis 1, four refine convs) whose mean-pooled output is added
as a delta; both branches scale by 0.01.

The Q/K/V ``Linear`` layers are sized to the flattened conv-tower output
(about H/128 x W/128 positions), so the module is built for one input
size: ``img_hw``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv, Linear

_SPECS = ((16, 7, 3), (32, 5, 2), (64, 3, 1), (128, 3, 1), (256, 3, 1), (256, 3, 1), (256, 3, 1))


def tower_hw(img_hw) -> tuple[int, int]:
    """Spatial size of the stride-2 conv tower's output for ``img_hw``."""
    h, w = img_hw
    for _, k, p in _SPECS:
        h = (h + 2 * p - k) // 2 + 1
        w = (w + 2 * p - k) // 2 + 1
    return h, w


class PoseNet(nn.Module):
    def __init__(self, img_hw, num_input_frames=3, dtype=torch.float32):
        super().__init__()
        self.num_input_frames = num_input_frames
        n_out = 6 * (num_input_frames - 1)
        convs, cin = [], 3 * num_input_frames
        for ch, k, p in _SPECS:
            convs.append(Conv(cin, ch, k, 2, p, dtype=dtype))
            cin = ch
        self.net = nn.ModuleList(convs)
        self.pose_conv = Conv(cin, n_out, 1, 1, 0, dtype=dtype)
        th, tw = tower_hw(img_hw)
        n_sp = th * tw
        self.query_fc = Linear(n_sp, n_sp, dtype)
        self.key_fc = Linear(n_sp, n_sp, dtype)
        self.value_fc = Linear(n_sp, n_sp, dtype)
        self.refine_net = nn.ModuleList(
            [Conv(2 * n_out, n_out, 1, 1, 0, dtype=dtype)]
            + [Conv(n_out, n_out, 3, 1, 1, dtype=dtype) for _ in range(3)]
        )
        self.refine_pose_conv = Conv(n_out, n_out, 1, 1, 0, dtype=dtype)

    def forward(self, imgs):
        """Channel-stacked frames [B,H,W,3N] -> [B, N-1, 6] pose vectors."""
        x = imgs
        for conv in self.net:
            x = F.relu(conv(x))
        base = self.pose_conv(x)
        b, h, w, c = base.shape
        # [B, C, N] layout, as the reference's channel attention
        flat = base.reshape(b, h * w, c).transpose(1, 2)
        query = self.query_fc(flat)
        key = self.key_fc(flat)
        value = self.value_fc(flat)
        energy = query @ key.transpose(1, 2)  # [B,C,C]
        attended = torch.softmax(energy, dim=1) @ value
        y = torch.cat([flat, attended], dim=1).transpose(1, 2).reshape(b, h, w, 2 * c)
        for conv in self.refine_net:
            y = F.relu(conv(y))
        y = self.refine_pose_conv(y)
        k = self.num_input_frames - 1
        delta = 0.01 * y.mean(dim=(1, 2)).reshape(-1, k, 6)
        return 0.01 * base.mean(dim=(1, 2)).reshape(-1, k, 6) + delta
