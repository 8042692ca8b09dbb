"""RAFT, the recurrent all-pairs flow network (NHWC).

Port of the authors' ``core/{raft,extractor,update,corr}.py`` (Teed & Deng,
"RAFT: Recurrent All-Pairs Field Transforms for Optical Flow", ECCV 2020,
arXiv 2003.12039) at the published widths, on ``layers.Conv`` and
``layers.BatchNorm``; module and parameter names follow RAFT's own
state_dict (``fnet.*``, ``cnet.*``, ``update_block.encoder.convc1``,
``update_block.gru.convz1``, ``update_block.flow_head.conv1``,
``update_block.mask.0``, ...).

- ``fnet``: the feature encoder, a 7x7 stride-2 stem and three stages of
  two residual blocks (64, 96, 128 channels) with instance norm, to 256
  channels at 1/8 resolution. ``cnet``: the context encoder, the same with
  BatchNorm, to 128 hidden (tanh) and 128 context (ReLU) channels.
- The correlation pyramid and its lookup: ``ops/corr_pyramid.py`` (4
  levels, radius 4: 324 channels).
- ``update_block``: the motion encoder, the separable ConvGRU (1x5 then
  5x1 convs, hidden size 128), the flow head and the mask head (x0.25);
  the flow moves by the head's delta each iteration, and is upsampled x8
  by the convex combination of its 3x3 neighbourhood under a 9-tap
  softmax mask.

Frames come as [0, 1] NHWC and are normalised as 2x - 1. The convolutions
compute in the module's dtype; the feature maps are cast to f32 before the
correlation, and the pyramid, the lookup, the coordinates and the flows
stay f32 (a bf16 coordinate has 0.5 px of resolution at 104 px). The
start coordinates are detached at every iteration, as RAFT does.

Departures from the authors' code:

- ``flows_of_triplet`` runs the feature encoder once over the 3B frames
  (exact: instance norm is per sample) and the context encoder once over
  the B centre frames, whose output serves both pairs (centre -> left,
  centre -> right). RAFT calls it once a pair on the pair's first frame:
  the outputs are identical, and with torch's BatchNorm only the
  running-variance update's unbiased factor would differ.
- BatchNorm is ``layers.BatchNorm`` (flax's: the running variance moves
  with the biased batch variance), and the downsampling shortcut's norm is
  ``norm3`` alone (RAFT registers it also as ``downsample.1``).
- Initialisation draws every conv bias as 0.
- Dropout is 0 (the published KITTI setting), so the encoders have none.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.corr_pyramid import corr_lookup, corr_pyramid
from ..utils.profiler import span
from .layers import BatchNorm, Conv

TRAIN_ITERS = 12  # update iterations of a training step
TEST_ITERS = 24  # at inference (RAFT's KITTI evaluation)
GAMMA = 0.8  # iteration i of N weighs GAMMA ** (N - 1 - i) in the sequence loss
CORR_LEVELS = 4
CORR_RADIUS = 4
FEATURE_DIM = 256
HIDDEN_DIM = 128
CONTEXT_DIM = 128


class InstanceNorm(nn.Module):
    """``nn.InstanceNorm2d`` (no affine, eps 1e-5, biased variance) on NHWC:
    statistics in f32, result in the compute dtype. No parameters."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype

    def forward(self, x):
        xf = x.float()
        var, mean = torch.var_mean(xf, dim=(1, 2), keepdim=True, unbiased=False)
        return ((xf - mean) * torch.rsqrt(var + 1e-5)).to(self.dtype)


def _norm(kind: str, c: int, dtype):
    return InstanceNorm(dtype) if kind == "instance" else BatchNorm(c, dtype=dtype)


class ResidualBlock(nn.Module):
    def __init__(self, cin, cout, norm, stride, dtype):
        super().__init__()
        self.conv1 = Conv(cin, cout, 3, stride, 1, init="kaiming_out", dtype=dtype)
        self.conv2 = Conv(cout, cout, 3, 1, 1, init="kaiming_out", dtype=dtype)
        self.norm1 = _norm(norm, cout, dtype)
        self.norm2 = _norm(norm, cout, dtype)
        self.downsample = None
        if stride != 1:
            self.norm3 = _norm(norm, cout, dtype)
            self.downsample = nn.Sequential(
                Conv(cin, cout, 1, stride, 0, init="kaiming_out", dtype=dtype))

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.norm3(self.downsample(x))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    def __init__(self, output_dim, norm, dtype):
        super().__init__()
        self.conv1 = Conv(3, 64, 7, 2, 3, init="kaiming_out", dtype=dtype)
        self.norm1 = _norm(norm, 64, dtype)
        cin, layers = 64, []
        for dim, stride in ((64, 1), (96, 2), (128, 2)):
            layers.append(nn.Sequential(ResidualBlock(cin, dim, norm, stride, dtype),
                                        ResidualBlock(dim, dim, norm, 1, dtype)))
            cin = dim
        self.layer1, self.layer2, self.layer3 = layers
        self.conv2 = Conv(128, output_dim, 1, 1, 0, init="kaiming_out", dtype=dtype)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class BasicMotionEncoder(nn.Module):
    def __init__(self, dtype):
        super().__init__()
        planes = CORR_LEVELS * (2 * CORR_RADIUS + 1) ** 2
        self.convc1 = Conv(planes, 256, 1, 1, 0, dtype=dtype)
        self.convc2 = Conv(256, 192, 3, 1, 1, dtype=dtype)
        self.convf1 = Conv(2, 128, 7, 1, 3, dtype=dtype)
        self.convf2 = Conv(128, 64, 3, 1, 1, dtype=dtype)
        self.conv = Conv(64 + 192, 128 - 2, 3, 1, 1, dtype=dtype)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=-1)))
        return torch.cat([out, flow.to(out.dtype)], dim=-1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden, inp, dtype):
        super().__init__()
        c = hidden + inp
        for gate in "zrq":
            setattr(self, f"conv{gate}1", Conv(c, hidden, (1, 5), 1, (0, 2), dtype=dtype))
            setattr(self, f"conv{gate}2", Conv(c, hidden, (5, 1), 1, (2, 0), dtype=dtype))

    def _half(self, h, x, k):
        hx = torch.cat([h, x], dim=-1)
        z = torch.sigmoid(getattr(self, f"convz{k}")(hx))
        r = torch.sigmoid(getattr(self, f"convr{k}")(hx))
        q = torch.tanh(getattr(self, f"convq{k}")(torch.cat([r * h, x], dim=-1)))
        return (1 - z) * h + z * q

    def forward(self, h, x):
        return self._half(self._half(h, x, 1), x, 2)


class FlowHead(nn.Module):
    def __init__(self, dtype):
        super().__init__()
        self.conv1 = Conv(HIDDEN_DIM, 256, 3, 1, 1, dtype=dtype)
        self.conv2 = Conv(256, 2, 3, 1, 1, dtype=dtype)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    def __init__(self, dtype):
        super().__init__()
        self.encoder = BasicMotionEncoder(dtype)
        self.gru = SepConvGRU(HIDDEN_DIM, 128 + HIDDEN_DIM, dtype)
        self.flow_head = FlowHead(dtype)
        self.mask = nn.Sequential(Conv(HIDDEN_DIM, 256, 3, 1, 1, dtype=dtype), nn.ReLU(),
                                  Conv(256, 64 * 9, 1, 1, 0, dtype=dtype))

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=-1))
        return net, 0.25 * self.mask(net), self.flow_head(net)


def pixel_coords(p: int, h: int, w: int, device) -> torch.Tensor:
    """[P,h,w,2] f32 (x, y) of every pixel: RAFT's ``coords_grid``."""
    yy, xx = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32), indexing="ij")
    return torch.stack([xx, yy], dim=-1).expand(p, h, w, 2)


def upsample_flow(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[P,h,w,2] flow at 1/8 -> [P,8h,8w,2] f32: output pixel (8y+i, 8x+j)
    is the softmax(mask channels k*64 + i*8 + j, over the 9 taps k) mean of
    8 x flow's zero-padded 3x3 neighbourhood of (y, x), tap k at
    (k // 3 - 1, k % 3 - 1): RAFT's ``upsample_flow``."""
    p, h, w, _ = flow.shape
    m = torch.softmax(mask.float().reshape(p, h, w, 9, 8, 8), dim=3)
    f = F.pad(8.0 * flow, (0, 0, 1, 1, 1, 1))
    taps = torch.stack([f[:, ky:ky + h, kx:kx + w] for ky in range(3) for kx in range(3)], dim=3)
    up = (m[..., None] * taps[:, :, :, :, None, None, :]).sum(dim=3)  # [P,h,w,8,8,2]
    return up.permute(0, 1, 3, 2, 4, 5).reshape(p, 8 * h, 8 * w, 2)


class RAFT(nn.Module):
    """RAFT at the published widths. ``iters`` / ``test_iters``: the update
    iterations of training (``flows_of_triplet``) and of inference
    (``forward``)."""

    def __init__(self, dtype=torch.float32, iters: int = TRAIN_ITERS,
                 test_iters: int = TEST_ITERS):
        super().__init__()
        self.dtype, self.iters, self.test_iters = dtype, iters, test_iters
        self.fnet = BasicEncoder(FEATURE_DIM, "instance", dtype)
        self.cnet = BasicEncoder(HIDDEN_DIM + CONTEXT_DIM, "batch", dtype)
        self.update_block = BasicUpdateBlock(dtype)

    def _context(self, img):
        ctx = self.cnet(2.0 * img.float() - 1.0)
        return torch.tanh(ctx[..., :HIDDEN_DIM]), torch.relu(ctx[..., HIDDEN_DIM:])

    def _refine(self, fmap1, fmap2, net, inp, iters: int, every: bool = True) -> list:
        """The x8 upsampled flows [P,H,W,2] f32 after each iteration (the
        last alone unless ``every``)."""
        with span("net.raft.corr"):
            pyramid = corr_pyramid(fmap1, fmap2, CORR_LEVELS)
        p, h, w, _ = fmap1.shape
        coords0 = pixel_coords(p, h, w, fmap1.device)
        coords1 = coords0
        flows = []
        for i in range(iters):
            with span("net.raft.iter", i):
                coords1 = coords1.detach()
                corr = corr_lookup(pyramid, coords1, CORR_RADIUS)
                net, mask, delta = self.update_block(net, inp, corr, coords1 - coords0)
                coords1 = coords1 + delta.float()
                if every or i == iters - 1:
                    flows.append(upsample_flow(coords1 - coords0, mask))
        return flows

    def flows_of_triplet(self, img_l, img, img_r) -> list:
        """The 2B flows (centre -> left, then centre -> right) after each of
        ``iters`` iterations, from [0, 1] frames [B,H,W,3]."""
        b = img.shape[0]
        with span("net.raft.fnet"):
            feats = self.fnet(2.0 * torch.cat([img_l, img, img_r], 0).float() - 1.0).float()
        f_l, f_c, f_r = feats[:b], feats[b:2 * b], feats[2 * b:]
        with span("net.raft.cnet"):
            net, inp = self._context(img)
        return self._refine(torch.cat([f_c, f_c], 0), torch.cat([f_l, f_r], 0),
                            torch.cat([net, net], 0), torch.cat([inp, inp], 0), self.iters)

    def forward(self, img1, img2) -> torch.Tensor:
        """The flow [B,H,W,2] f32 from ``img1`` to ``img2`` ([0, 1] frames)
        after ``test_iters`` iterations."""
        b = img1.shape[0]
        feats = self.fnet(2.0 * torch.cat([img1, img2], 0).float() - 1.0).float()
        net, inp = self._context(img1)
        return self._refine(feats[:b], feats[b:], net, inp, self.test_iters, every=False)[-1]
