"""Pose regressor from normalized optical flow (the legacy model family).

Port of the JAX package's ``models/flowpose_net.py`` (the reference's
structures/flowposenet.py): seven stride-2 convs with ReLU over the
2-channel flow, a 1x1 head to six values, a global mean, scaled by 0.01.
Layer names ``conv1`` ... ``conv7`` and ``pose_pred`` follow the reference.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import Conv

# (output channels, kernel, padding) of conv1 ... conv7, each stride 2
_SPECS = ((16, 7, 3), (32, 5, 2), (64, 3, 1), (128, 3, 1), (256, 3, 1), (256, 3, 1), (256, 3, 1))


class FlowPoseNet(nn.Module):
    def __init__(self, dtype=torch.float32):
        super().__init__()
        cin = 2
        for i, (ch, k, p) in enumerate(_SPECS, start=1):
            setattr(self, f"conv{i}", Conv(cin, ch, k, 2, p, dtype=dtype))
            cin = ch
        self.pose_pred = Conv(cin, 6, 1, 1, 0, dtype=dtype)

    def forward(self, flow):
        """Flow [B,H,W,2] (divided by the image size) -> pose vectors [B,6]."""
        x = flow
        for i in range(1, len(_SPECS) + 1):
            x = torch.relu(getattr(self, f"conv{i}")(x))
        return 0.01 * self.pose_pred(x).mean(dim=(1, 2))
