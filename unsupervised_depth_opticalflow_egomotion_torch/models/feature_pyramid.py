"""Six-level siamese feature encoder for the flow network (NHWC).

Port of the JAX package's ``models/feature_pyramid.py``: pairs of
(stride-2, stride-1) 3x3 convs with LeakyReLU(0.1), channels
16-32-64-96-128-196, returning the six stride-1 outputs at 1/2 ... 1/64
resolution. ``packed`` is a TPU layout flag (same math), accepted and unused.
State_dict names ``conv1.0`` ... ``conv12.0`` follow the reference.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import conv_lrelu

_CHANNELS = (16, 32, 64, 96, 128, 196)


class FeaturePyramid(nn.Module):
    def __init__(self, packed=True, dtype=torch.float32):
        super().__init__()
        del packed
        cin = 3
        for lvl, ch in enumerate(_CHANNELS):
            setattr(self, f"conv{2 * lvl + 1}", conv_lrelu(cin, ch, stride=2, dtype=dtype))
            setattr(self, f"conv{2 * lvl + 2}", conv_lrelu(ch, ch, stride=1, dtype=dtype))
            cin = ch

    def forward(self, img):
        feats = []
        x = img
        for lvl in range(len(_CHANNELS)):
            x = getattr(self, f"conv{2 * lvl + 1}")(x)
            x = getattr(self, f"conv{2 * lvl + 2}")(x)
            feats.append(x)
        return tuple(feats)
