"""RAFT's all-pairs correlation pyramid and its lookup (NHWC).

Port of the authors' ``core/corr.py`` ``CorrBlock`` (Teed & Deng, ECCV
2020). ``corr_pyramid`` takes the two feature maps [P,h,w,C] (cast to f32
by the caller, as RAFT does) and gives ``levels`` volumes
[P*h*w, 1, h_l, w_l]: the dot product of every pixel of the first map with
every pixel of the second over sqrt(C) (one batched matrix product), then
2x2 average pools of the second map's axes. ``corr_lookup`` samples, for
each pixel of the first map, a (2r+1) x (2r+1) window around its
coordinates in the second map at every level (coordinates / 2^l there),
bilinear with ``align_corners=True`` and zeros outside, and concatenates
the windows: [P,h,w,levels*(2r+1)^2] in f32.

The taps keep ``CorrBlock``'s order: its window is
``stack(meshgrid(dy, dx))`` added to (x, y), so tap (a, b) of a level,
channel a*(2r+1) + b, samples at (x + d_a, y + d_b) with d = -r..r.

The lookup is plain PyTorch (``F.grid_sample``) on every device (on the
card torch runs this sampling, bilinear with zeros outside and
``align_corners=True``, on cuDNN's ``bilinear_sampler_{fw,bw}_4d``); a
kernel would replace ``corr_lookup`` alone.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor, levels: int) -> list:
    """The all-pairs volume of ``fmap1`` against ``fmap2`` ([P,h,w,C]) and
    its ``levels - 1`` pooled levels, each [P*h*w, 1, h_l, w_l]."""
    p, h, w, c = fmap1.shape
    corr = torch.matmul(fmap1.reshape(p, h * w, c), fmap2.reshape(p, h * w, c).transpose(1, 2))
    corr = (corr / math.sqrt(c)).reshape(p * h * w, 1, h, w)
    out = [corr]
    for _ in range(levels - 1):
        corr = F.avg_pool2d(corr, 2, stride=2)
        out.append(corr)
    return out


def corr_lookup(pyramid: list, coords: torch.Tensor, radius: int) -> torch.Tensor:
    """The windows of ``pyramid`` around ``coords`` [P,h,w,2] (x, y pixel
    coordinates in the second map at level 0): [P,h,w,levels*(2r+1)^2]."""
    p, h, w, _ = coords.shape
    n = 2 * radius + 1
    d = torch.linspace(-radius, radius, n, device=coords.device, dtype=torch.float32)
    delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1)  # (a, b) -> (d_a, d_b)
    centre = coords.float().reshape(p * h * w, 1, 1, 2)
    out = []
    for lvl, corr in enumerate(pyramid):
        hl, wl = corr.shape[-2:]
        at = centre / 2 ** lvl + delta
        grid = torch.stack([2.0 * at[..., 0] / (wl - 1) - 1.0,
                            2.0 * at[..., 1] / (hl - 1) - 1.0], dim=-1)
        taps = F.grid_sample(corr, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
        out.append(taps.reshape(p, h, w, n * n))
    return torch.cat(out, dim=-1)
