"""PWC-Net style coarse-to-fine flow decoder (NHWC).

Port of the JAX package's ``models/pwc_decoder.py``:
  level 6:    corr only -> dense block -> flow6
  level 5..2: warp(feat2, up(flow)) -> corr -> cat(corr, feat1, upflow)
              -> dense block -> flow += upflow
  context:    dilated conv chain (1,2,4,8,16,1) refining flow2
Outputs 4 flows at [H,W], [H/2,W/2], [H/4,W/4], [H/8,W/8] (x4 scaling).

Every cost volume goes to the correlation kernel (ops/cost_volume.py); the
``corr_impl`` names of the JAX package are accepted and route the same way.
The feature warp samples float activations and needs a gradient to the
source, so it runs the plain sampler (ops/warp.py), as the JAX package
keeps it on XLA. State_dict names ``conv<l>_<j>.0``, ``predict_flow<l>``,
``dc_conv<k>`` follow the reference.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.cost_volume import correlation
from ..ops.interp import resize_bilinear, upsample2x_bilinear
from ..ops.warp import warp_flow
from .layers import Conv, conv_lrelu

_DD = (128, 128, 96, 64, 32)
_FEAT_CH = {6: 196, 5: 128, 4: 96, 3: 64, 2: 32}
_CONTEXT = ((128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1))


class PWCDecoder(nn.Module):
    def __init__(self, md=4, corr_impl="fused", dtype=torch.float32):
        super().__init__()
        if corr_impl not in ("fused", "pallas", "xla"):
            raise ValueError(f"unknown corr_impl {corr_impl!r}")
        self.md = md
        nd = (2 * md + 1) ** 2
        for lvl in (6, 5, 4, 3, 2):
            cin = nd if lvl == 6 else nd + _FEAT_CH[lvl] + 2
            ins = (cin, _DD[0], _DD[0] + _DD[1], _DD[1] + _DD[2], _DD[2] + _DD[3])
            for j in range(5):
                setattr(self, f"conv{lvl}_{j}", conv_lrelu(ins[j], _DD[j], dtype=dtype))
            setattr(self, f"predict_flow{lvl}", Conv(_DD[3] + _DD[4], 2, dtype=dtype))
        cin = 2 + _DD[4]
        for k, (ch, d) in enumerate(_CONTEXT, start=1):
            setattr(self, f"dc_conv{k}", conv_lrelu(cin, ch, padding=d, dilation=d, dtype=dtype))
            cin = ch
        self.dc_conv7 = Conv(cin, 2, dtype=dtype)

    def _dense(self, lvl, x):
        c = lambda j: getattr(self, f"conv{lvl}_{j}")  # noqa: E731
        x0 = c(0)(x)
        x1 = c(1)(x0)
        x2 = c(2)(torch.cat([x0, x1], -1))
        x3 = c(3)(torch.cat([x1, x2], -1))
        x4 = c(4)(torch.cat([x2, x3], -1))
        flow = getattr(self, f"predict_flow{lvl}")(torch.cat([x3, x4], -1))
        return flow, x4

    def forward(self, feats1, feats2, img_hw):
        h, w = int(img_hw[0]), int(img_hw[1])
        if h % 64 or w % 64:
            raise ValueError(f"PWC levels need H, W divisible by 64; got {img_hw}")
        md = self.md
        flow, _ = self._dense(6, correlation(feats1[5], feats2[5], md))
        flows = {6: flow}
        x4 = None
        for lvl in (5, 4, 3, 2):
            up_flow = upsample2x_bilinear(flows[lvl + 1]) * 2.0
            feat1, feat2 = feats1[lvl - 1], feats2[lvl - 1]
            warped = warp_flow(feat2, up_flow, use_mask=False)
            corr = correlation(feat1, warped, md)
            flow, x4 = self._dense(lvl, torch.cat([corr, feat1, up_flow], -1))
            flows[lvl] = flow + up_flow
        x = torch.cat([flows[2], x4], -1)
        for k in range(1, 7):
            x = getattr(self, f"dc_conv{k}")(x)
        flow2 = flows[2] + self.dc_conv7(x)
        return [
            resize_bilinear(flow2 * 4.0, (h, w)),
            resize_bilinear(flows[3] * 4.0, (h // 2, w // 2)),
            resize_bilinear(flows[4] * 4.0, (h // 4, w // 4)),
            resize_bilinear(flows[5] * 4.0, (h // 8, w // 8)),
        ]
