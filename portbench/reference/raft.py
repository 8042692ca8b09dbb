"""Plain float32 reference of the flow stage with RAFT as its network.

Written for the benchmark from the authors' RAFT (Teed & Deng, ECCV 2020,
arXiv 2003.12039; their ``core/{raft,extractor,update,corr}.py`` and
``utils/utils.py``), NCHW as theirs, in plain PyTorch and float32, with
nothing imported from the port: the feature encoder (instance norm, 256
channels at 1/8), the context encoder (BatchNorm, 128 hidden + 128
context), the all-pairs correlation volume over sqrt(256) pooled into 4
levels, its radius-4 lookup by ``grid_sample`` (``align_corners=True``,
zeros outside, ``CorrBlock``'s tap order), the update block (motion
encoder, separable ConvGRU with 1x5 and 5x1 convs, flow head, mask head
x0.25), 12 iterations with the start coordinates detached in each, and
the convex x8 upsampling by ``F.unfold`` under a 9-tap softmax mask.

The objective is the flow stage's (``joint.py``'s pieces, as
``JointReference`` scores the finest PWC scale): for each iteration's
full-resolution flows of the pairs centre -> left and centre -> right, the
masked photometric and SSIM terms of both warps, the second-order
smoothness of both flows and the forward-backward consistency, under
nearest-splat occlusion and the configuration's weights; iteration i of N
weighs 0.8 ** (N - 1 - i) (RAFT's sequence loss, gamma 0.8).

Departures from the paper and the authors' code:

- the objective is the self-supervised flow loss above, in place of
  RAFT's supervised L1 against ground truth;
- the feature encoder runs once over the 3B frames (left, centre, right)
  and the context encoder once over the B centre frames, whose output
  serves both pairs; the authors' per-pair call gives the same outputs,
  since instance norm is per sample and the pairs share their first frame;
- BatchNorm's running variance moves with the biased batch variance
  (flax's rule, which the port keeps), not torch's unbiased one;
- no dropout (the published KITTI setting is 0) and no mixed precision:
  every tensor is float32, the correlation's matrix product included.

``fake_quant`` (the control) rounds the frames and every convolution's
input, weight and output of RAFT (the depth and pose networks do not run);
the correlation's matrix product is left in f32, as RAFT leaves it.
``calls`` records the warp and SSIM calls of all 12 loss evaluations.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .joint import (_UNSUPPORTED, WEIGHTS, all_zero, flow_consis, flow_smooth, flow_warp,
                    nearest_mass, photometric, ssim_loss)
from .nets import DepthNet, PoseNet

TERMS = ("loss_flow_pixel", "loss_flow_ssim", "loss_flow_smooth", "loss_flow_consis")
ITERS, GAMMA, LEVELS, RADIUS = 12, 0.8, 4, 4


class Conv2d(nn.Module):
    """``nn.Conv2d`` (NCHW, square or (rows, columns) kernel) with the
    control's rounding."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0):
        super().__init__()
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        self.weight = nn.Parameter(torch.zeros(cout, cin, kh, kw))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.stride, self.padding = stride, padding
        self.fake_quant = None

    def forward(self, x):
        w, q = self.weight, self.fake_quant
        if q is not None:
            x, w = q(x), q(w)
        y = F.conv2d(x, w, self.bias, self.stride, self.padding)
        return y if q is None else q(y)


class BatchNorm2d(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(0.1 * mean)
            self.running_var.mul_(0.9).add_(0.1 * var)
        y = (x - mean[:, None, None]) * torch.rsqrt(var[:, None, None] + 1e-5)
        return y * self.weight[:, None, None] + self.bias[:, None, None]


class InstanceNorm2d(nn.Module):
    def forward(self, x):
        return F.instance_norm(x, eps=1e-5)


def norm(kind, c):
    return InstanceNorm2d() if kind == "instance" else BatchNorm2d(c)


class ResidualBlock(nn.Module):
    def __init__(self, cin, planes, kind, stride=1):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 3, stride, 1)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1)
        self.norm1, self.norm2 = norm(kind, planes), norm(kind, planes)
        self.downsample = None
        if stride != 1:
            self.norm3 = norm(kind, planes)
            self.downsample = nn.Sequential(Conv2d(cin, planes, 1, stride))

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.norm3(self.downsample(x))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    def __init__(self, output_dim, kind):
        super().__init__()
        self.norm1 = norm(kind, 64)
        self.conv1 = Conv2d(3, 64, 7, 2, 3)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, kind), ResidualBlock(64, 64, kind))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, kind, 2), ResidualBlock(96, 96, kind))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, kind, 2),
                                    ResidualBlock(128, 128, kind))
        self.conv2 = Conv2d(128, output_dim, 1)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class BasicMotionEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.convc1 = Conv2d(LEVELS * (2 * RADIUS + 1) ** 2, 256, 1)
        self.convc2 = Conv2d(256, 192, 3, padding=1)
        self.convf1 = Conv2d(2, 128, 7, padding=3)
        self.convf2 = Conv2d(128, 64, 3, padding=1)
        self.conv = Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden_dim=128, input_dim=192 + 128):
        super().__init__()
        c = hidden_dim + input_dim
        self.convz1 = Conv2d(c, hidden_dim, (1, 5), padding=(0, 2))
        self.convr1 = Conv2d(c, hidden_dim, (1, 5), padding=(0, 2))
        self.convq1 = Conv2d(c, hidden_dim, (1, 5), padding=(0, 2))
        self.convz2 = Conv2d(c, hidden_dim, (5, 1), padding=(2, 0))
        self.convr2 = Conv2d(c, hidden_dim, (5, 1), padding=(2, 0))
        self.convq2 = Conv2d(c, hidden_dim, (5, 1), padding=(2, 0))

    def forward(self, h, x):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz1(hx))
        r = torch.sigmoid(self.convr1(hx))
        q = torch.tanh(self.convq1(torch.cat([r * h, x], dim=1)))
        h = (1 - z) * h + z * q
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz2(hx))
        r = torch.sigmoid(self.convr2(hx))
        q = torch.tanh(self.convq2(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q


class FlowHead(nn.Module):
    def __init__(self, input_dim=128, hidden_dim=256):
        super().__init__()
        self.conv1 = Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = Conv2d(hidden_dim, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    def __init__(self, hidden_dim=128):
        super().__init__()
        self.encoder = BasicMotionEncoder()
        self.gru = SepConvGRU(hidden_dim, 128 + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask = nn.Sequential(Conv2d(128, 256, 3, padding=1), nn.ReLU(),
                                  Conv2d(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, 0.25 * self.mask(net), self.flow_head(net)


def coords_grid(batch, ht, wd, device):
    yy, xx = torch.meshgrid(torch.arange(ht, device=device), torch.arange(wd, device=device),
                            indexing="ij")
    return torch.stack([xx, yy], dim=0).float()[None].repeat(batch, 1, 1, 1)


def bilinear_sampler(img, coords):
    """``grid_sample`` at pixel coordinates (x, y), ``align_corners=True``."""
    h, w = img.shape[-2:]
    xgrid, ygrid = coords.split([1, 1], dim=-1)
    grid = torch.cat([2 * xgrid / (w - 1) - 1, 2 * ygrid / (h - 1) - 1], dim=-1)
    return F.grid_sample(img, grid, align_corners=True)


class CorrBlock:
    def __init__(self, fmap1, fmap2, num_levels=LEVELS, radius=RADIUS):
        self.num_levels, self.radius = num_levels, radius
        batch, dim, ht, wd = fmap1.shape
        corr = torch.matmul(fmap1.view(batch, dim, ht * wd).transpose(1, 2),
                            fmap2.view(batch, dim, ht * wd)) / math.sqrt(dim)
        corr = corr.reshape(batch * ht * wd, 1, ht, wd)
        self.corr_pyramid = [corr]
        for _ in range(num_levels - 1):
            corr = F.avg_pool2d(corr, 2, stride=2)
            self.corr_pyramid.append(corr)

    def __call__(self, coords):
        r = self.radius
        coords = coords.permute(0, 2, 3, 1)
        batch, h1, w1, _ = coords.shape
        out = []
        for i, corr in enumerate(self.corr_pyramid):
            dx = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
            dy = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
            delta = torch.stack(torch.meshgrid(dy, dx, indexing="ij"), dim=-1)
            centroid = coords.reshape(batch * h1 * w1, 1, 1, 2) / 2 ** i
            sampled = bilinear_sampler(corr, centroid + delta.view(1, 2 * r + 1, 2 * r + 1, 2))
            out.append(sampled.view(batch, h1, w1, -1))
        return torch.cat(out, dim=-1).permute(0, 3, 1, 2).contiguous().float()


def upsample_flow(flow, mask):
    """[N,2,H,W] -> [N,2,8H,8W] by the convex combination of 3x3 neighbours."""
    n, _, h, w = flow.shape
    mask = torch.softmax(mask.view(n, 1, 9, 8, 8, h, w), dim=2)
    up = F.unfold(8 * flow, [3, 3], padding=1).view(n, 2, 9, 1, 1, h, w)
    up = torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(n, 2, 8 * h, 8 * w)


class RAFT(nn.Module):
    def __init__(self, iters=ITERS):
        super().__init__()
        self.iters = iters
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(128 + 128, "batch")
        self.update_block = BasicUpdateBlock(128)

    def forward(self, img_l, img, img_r):
        """NCHW [0, 1] frames -> every iteration's flows [2B,2,H,W] of the
        pairs centre -> left, centre -> right."""
        b = img.shape[0]
        fmaps = self.fnet(2 * torch.cat([img_l, img, img_r], 0) - 1)
        f_l, f_c, f_r = fmaps[:b], fmaps[b:2 * b], fmaps[2 * b:]
        corr_fn = CorrBlock(torch.cat([f_c, f_c], 0), torch.cat([f_l, f_r], 0))
        net, inp = torch.split(self.cnet(2 * img - 1), [128, 128], dim=1)
        net, inp = torch.tanh(net).repeat(2, 1, 1, 1), torch.relu(inp).repeat(2, 1, 1, 1)
        coords0 = coords_grid(2 * b, f_c.shape[2], f_c.shape[3], img.device)
        coords1 = coords0
        preds = []
        for _ in range(self.iters):
            coords1 = coords1.detach()
            corr = corr_fn(coords1)
            net, up_mask, delta = self.update_block(net, inp, corr, coords1 - coords0)
            coords1 = coords1 + delta
            preds.append(upsample_flow(coords1 - coords0, up_mask))
        return preds


class RaftReference(nn.Module):
    """RAFT under the port's state_dict names (``raft.*``) and the flow
    stage's sequence loss. The depth and pose networks are held, unused,
    since the port's model holds them. ``calls`` and ``fake_quant`` as in
    ``JointReference``; ``iters`` the update iterations (12 published)."""

    def __init__(self, cfg: dict, fake_quant=None, iters: int = ITERS):
        super().__init__()
        for key in _UNSUPPORTED:
            if cfg.get(key):
                raise NotImplementedError(f"the reference does not implement {key}={cfg[key]!r}")
        if (cfg["mode"], cfg.get("flow_net"), cfg["num_scales"], cfg["flow_occ_impl"]) != (
                "flow", "raft", 1, "splat_nn"):
            raise NotImplementedError("the RAFT reference implements mode flow, flow_net raft, "
                                      "num_scales 1 and flow_occ_impl splat_nn")
        self.cfg = cfg
        self.depth_net = DepthNet(cfg["num_scales"])
        self.pose_net = PoseNet(tuple(cfg["img_hw"]), cfg["num_input_frames"])
        self.raft = RAFT(iters)
        self.fake_quant = fake_quant
        if fake_quant is not None:
            for m in self.modules():
                if isinstance(m, Conv2d):
                    m.fake_quant = fake_quant

    def weights(self) -> dict:
        return {k: float(self.cfg[WEIGHTS[k]]) for k in TERMS}

    def loss_pack(self, images, K_ms, K_inv_ms, calls=None) -> dict:
        h = images.shape[1] // 3
        frames = images.float() / 255.0
        if self.fake_quant is not None:
            frames = self.fake_quant(frames)
        l, c, r = frames[:, :h], frames[:, h:2 * h], frames[:, 2 * h:]
        nchw = [x.permute(0, 3, 1, 2) for x in (l, c, r)]
        preds = self.raft(*nchw)
        pack = {k: 0.0 for k in TERMS}
        for i, pred in enumerate(preds):
            weight = GAMMA ** (len(preds) - 1 - i)
            for k, v in self.objective(l, c, r, pred.permute(0, 2, 3, 1), calls).items():
                pack[k] = pack[k] + weight * v
        return pack

    @staticmethod
    def objective(l, c, r, flows2, calls):
        """The flow stage's terms of one scale for the 2B flows (bwd, fwd)."""
        b = c.shape[0]
        warped = flow_warp(torch.cat([l, r], 0), flows2, calls)
        from_l, from_r = warped[:b], warped[b:]
        bwd, fwd = flows2[:b], flows2[b:]
        occ = nearest_mass(-flows2.detach()).clamp(0.0, 1.0)
        occ_bwd, occ_fwd = occ[:b], occ[b:]
        mask_fwd = (1 - all_zero(from_r)) * occ_fwd
        mask_bwd = (1 - all_zero(from_l)) * occ_bwd
        return {
            "loss_flow_pixel": photometric([c], [from_l], [mask_bwd])
            + photometric([c], [from_r], [mask_fwd]),
            "loss_flow_ssim": ssim_loss([c], [from_r], [mask_fwd], calls)
            + ssim_loss([c], [from_l], [mask_bwd], calls),
            "loss_flow_smooth": flow_smooth([fwd], [c]) + flow_smooth([bwd], [c]),
            "loss_flow_consis": flow_consis([fwd], [bwd], [occ_fwd]),
        }
