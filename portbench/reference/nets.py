"""Plain float32 reference of the three networks the training step runs.

Written for the benchmark from the architecture the port implements at
commit 6d2cb1d (``models/{depth_net,pose_net,feature_pyramid,pwc_decoder,
layers}.py``), in plain PyTorch: no kernel, no cast to a lower precision,
nothing imported from the port. Tensors are NHWC as the port's; each
convolution views them as NCHW. Module and parameter names are the port's
state_dict names, so one set of weights, keyed by name, loads into both.

- ``DepthNet``: ResNet-18 encoder on (x - 0.45) / 0.225 (BatchNorm with the
  batch's biased variance, running statistics ra = 0.9 ra + 0.1 stat, eps
  1e-5), a skip decoder of reflection-padded 3x3 convs with ELU and x2
  bilinear upsampling, sigmoid disparity heads at three scales.
- ``PoseNet``: seven stride-2 convs with ReLU, a 1x1 head, and the attention
  refinement over the flattened positions; both branches scaled by 0.01.
- ``FeaturePyramid`` and ``PWCDecoder``: six levels of (stride 2, stride 1)
  3x3 convs with LeakyReLU(0.1); the coarse-to-fine decoder with an 81-shift
  cost volume (mean over channels, zero padding), a warp of the second
  features by the upsampled flow, dense blocks and the dilated context net.

``fake_quant`` (the control's lower precision): a function applied to every
convolution's and dense layer's input, weight and output.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..flops import corr_flops, counted

_ENC_CH = (64, 64, 128, 256, 512)
_DEC_CH = (16, 32, 64, 128, 256)


class Conv(nn.Module):
    def __init__(self, cin, cout, kernel=3, stride=1, padding=1, dilation=1, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.fake_quant = None

    def forward(self, x):
        w = self.weight
        x = x.permute(0, 3, 1, 2)
        if self.fake_quant is not None:
            x, w = self.fake_quant(x), self.fake_quant(w)
        y = F.conv2d(x, w, self.bias, self.stride, self.padding, self.dilation)
        if self.fake_quant is not None:
            y = self.fake_quant(y)
        return y.permute(0, 2, 3, 1)


class Linear(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.fake_quant = None

    def forward(self, x):
        w = self.weight
        if self.fake_quant is not None:
            x, w = self.fake_quant(x), self.fake_quant(w)
            return self.fake_quant(F.linear(x, w, self.bias))
        return F.linear(x, w, self.bias)


class BatchNorm(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        var, mean = torch.var_mean(x, dim=(0, 1, 2), unbiased=False)
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(0.1 * mean)
            self.running_var.mul_(0.9).add_(0.1 * var)
        return (x - mean) * torch.rsqrt(var + 1e-5) * self.weight + self.bias


def up2(x):
    """x2 bilinear upsampling (half-pixel centres) of NHWC ``x``."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def resize(x, hw):
    """Bilinear resize (half-pixel centres, no antialiasing) of NHWC ``x``."""
    if tuple(x.shape[1:3]) == tuple(hw):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def sample(img, coords):
    """Bilinear sample NHWC ``img`` at normalized ``coords`` [B,Ho,Wo,2]
    (pixel 0 at -1, the last at +1; zeros outside)."""
    y = F.grid_sample(img.permute(0, 3, 1, 2), coords, mode="bilinear",
                      padding_mode="zeros", align_corners=True)
    return y.permute(0, 2, 3, 1)


def flow_coords(flow):
    _, h, w, _ = flow.shape
    yy, xx = torch.meshgrid(torch.arange(h, device=flow.device, dtype=flow.dtype),
                            torch.arange(w, device=flow.device, dtype=flow.dtype), indexing="ij")
    x = xx + flow[..., 0]
    y = yy + flow[..., 1]
    return torch.stack([2.0 * x / (w - 1) - 1.0, 2.0 * y / (h - 1) - 1.0], dim=-1)


def correlation(f1, f2, md, calls=None):
    """Cost volume [B,H,W,(2md+1)^2]: entry (i, j) is the channel mean of
    f1[y, x] * f2[y + i - md, x + j - md], zero outside f2."""
    b, h, w, c = f1.shape
    n = corr_flops(b, h, w, c, md)
    k = int(f1.requires_grad) + int(f2.requires_grad)
    f1, f2 = counted(calls, "correlation", n, n * k, (b, h, w, c, md, k), f1, f2)
    f2p = F.pad(f2, (0, 0, md, md, md, md))
    cv = [(f1 * f2p[:, i:i + h, j:j + w]).mean(-1)
          for i in range(2 * md + 1) for j in range(2 * md + 1)]
    return torch.stack(cv, dim=-1)


# ------------------------------------------------------------------ depth
class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = Conv(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(cout)
        self.conv2 = Conv(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(Conv(cin, cout, 1, stride, 0, bias=False),
                                            BatchNorm(cout))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class ResNet18(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = Conv(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        cin = 64
        for li, cout in enumerate((64, 128, 256, 512), start=1):
            stride = 1 if li == 1 else 2
            setattr(self, f"layer{li}", nn.Sequential(BasicBlock(cin, cout, stride),
                                                      BasicBlock(cout, cout, 1)))
            cin = cout

    def forward(self, img):
        x = (img - 0.45) / 0.225
        f0 = F.relu(self.bn1(self.conv1(x)))
        pooled = F.max_pool2d(f0.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        f1 = self.layer1(pooled)
        f2 = self.layer2(f1)
        f3 = self.layer3(f2)
        return f0, f1, f2, f3, self.layer4(f3)


class ResnetEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = ResNet18()

    def forward(self, img):
        return self.encoder(img)


class ReflectConv3x3(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = Conv(cin, cout, 3, 1, 0)

    def forward(self, x):
        x = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
        return self.conv(x.permute(0, 2, 3, 1))


class ConvBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = ReflectConv3x3(cin, cout)

    def forward(self, x):
        return F.elu(self.conv(x))


class DepthDecoder(nn.Module):
    def __init__(self, num_scales):
        super().__init__()
        self.num_scales = num_scales
        ups, cin = [], _ENC_CH[-1]
        for scale in range(4, -1, -1):
            skip = _ENC_CH[scale - 1] if scale > 0 else 0
            ups.append(nn.ModuleList([ConvBlock(cin, _DEC_CH[scale]),
                                      ConvBlock(_DEC_CH[scale] + skip, _DEC_CH[scale])]))
            cin = _DEC_CH[scale]
        self.upconvs = nn.ModuleList(ups)
        self.dispconvs = nn.ModuleList([ReflectConv3x3(_DEC_CH[s], 1) for s in range(num_scales)])

    def forward(self, feats):
        out, x = {}, feats[-1]
        for i, scale in enumerate(range(4, -1, -1)):
            x = up2(self.upconvs[i][0](x))
            if scale > 0:
                x = torch.cat([x, feats[scale - 1]], dim=-1)
            x = self.upconvs[i][1](x)
            if scale < self.num_scales:
                out[scale] = torch.sigmoid(self.dispconvs[scale](x))
        return [out[s] for s in range(self.num_scales)]


class DepthNet(nn.Module):
    def __init__(self, num_scales):
        super().__init__()
        self.encoder = ResnetEncoder()
        self.decoder = DepthDecoder(num_scales)

    def forward(self, img):
        return self.decoder(self.encoder(img))


# ------------------------------------------------------------------- pose
_POSE = ((16, 7, 3), (32, 5, 2), (64, 3, 1), (128, 3, 1), (256, 3, 1), (256, 3, 1), (256, 3, 1))


class PoseNet(nn.Module):
    def __init__(self, img_hw, num_frames=3):
        super().__init__()
        self.k = num_frames - 1
        n_out, cin = 6 * self.k, 3 * num_frames
        convs = []
        h, w = img_hw
        for ch, k, p in _POSE:
            convs.append(Conv(cin, ch, k, 2, p))
            cin = ch
            h, w = (h + 2 * p - k) // 2 + 1, (w + 2 * p - k) // 2 + 1
        self.net = nn.ModuleList(convs)
        self.pose_conv = Conv(cin, n_out, 1, 1, 0)
        self.query_fc = Linear(h * w, h * w)
        self.key_fc = Linear(h * w, h * w)
        self.value_fc = Linear(h * w, h * w)
        self.refine_net = nn.ModuleList([Conv(2 * n_out, n_out, 1, 1, 0)]
                                        + [Conv(n_out, n_out, 3, 1, 1) for _ in range(3)])
        self.refine_pose_conv = Conv(n_out, n_out, 1, 1, 0)

    def forward(self, imgs):
        x = imgs
        for conv in self.net:
            x = F.relu(conv(x))
        base = self.pose_conv(x)
        b, h, w, c = base.shape
        flat = base.reshape(b, h * w, c).transpose(1, 2)
        q, k, v = self.query_fc(flat), self.key_fc(flat), self.value_fc(flat)
        attended = torch.softmax(q @ k.transpose(1, 2), dim=1) @ v
        y = torch.cat([flat, attended], dim=1).transpose(1, 2).reshape(b, h, w, 2 * c)
        for conv in self.refine_net:
            y = F.relu(conv(y))
        y = self.refine_pose_conv(y)
        return (0.01 * base.mean(dim=(1, 2)) + 0.01 * y.mean(dim=(1, 2))).reshape(-1, self.k, 6)


# ------------------------------------------------------------------- flow
def conv_lrelu(cin, cout, stride=1, padding=1, dilation=1):
    return nn.Sequential(Conv(cin, cout, 3, stride, padding, dilation), nn.LeakyReLU(0.1))


class FeaturePyramid(nn.Module):
    CH = (16, 32, 64, 96, 128, 196)

    def __init__(self):
        super().__init__()
        cin = 3
        for lvl, ch in enumerate(self.CH):
            setattr(self, f"conv{2 * lvl + 1}", conv_lrelu(cin, ch, stride=2))
            setattr(self, f"conv{2 * lvl + 2}", conv_lrelu(ch, ch))
            cin = ch

    def forward(self, img):
        feats, x = [], img
        for lvl in range(len(self.CH)):
            x = getattr(self, f"conv{2 * lvl + 2}")(getattr(self, f"conv{2 * lvl + 1}")(x))
            feats.append(x)
        return feats


_DD = (128, 128, 96, 64, 32)
_FEAT = {6: 196, 5: 128, 4: 96, 3: 64, 2: 32}
_CONTEXT = ((128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1))


class PWCDecoder(nn.Module):
    def __init__(self, md=4):
        super().__init__()
        self.md = md
        nd = (2 * md + 1) ** 2
        for lvl in (6, 5, 4, 3, 2):
            cin = nd if lvl == 6 else nd + _FEAT[lvl] + 2
            ins = (cin, _DD[0], _DD[0] + _DD[1], _DD[1] + _DD[2], _DD[2] + _DD[3])
            for j in range(5):
                setattr(self, f"conv{lvl}_{j}", conv_lrelu(ins[j], _DD[j]))
            setattr(self, f"predict_flow{lvl}", Conv(_DD[3] + _DD[4], 2))
        cin = 2 + _DD[4]
        for k, (ch, d) in enumerate(_CONTEXT, start=1):
            setattr(self, f"dc_conv{k}", conv_lrelu(cin, ch, padding=d, dilation=d))
            cin = ch
        self.dc_conv7 = Conv(cin, 2)

    def _dense(self, lvl, x):
        c = lambda j: getattr(self, f"conv{lvl}_{j}")  # noqa: E731
        x0 = c(0)(x)
        x1 = c(1)(x0)
        x2 = c(2)(torch.cat([x0, x1], -1))
        x3 = c(3)(torch.cat([x1, x2], -1))
        x4 = c(4)(torch.cat([x2, x3], -1))
        return getattr(self, f"predict_flow{lvl}")(torch.cat([x3, x4], -1)), x4

    def forward(self, feats1, feats2, hw, calls=None):
        h, w = hw
        flows = {6: self._dense(6, correlation(feats1[5], feats2[5], self.md, calls))[0]}
        x4 = None
        for lvl in (5, 4, 3, 2):
            up = up2(flows[lvl + 1]) * 2.0
            f1 = feats1[lvl - 1]
            warped = sample(feats2[lvl - 1], flow_coords(up))
            corr = correlation(f1, warped, self.md, calls)
            flow, x4 = self._dense(lvl, torch.cat([corr, f1, up], -1))
            flows[lvl] = flow + up
        x = torch.cat([flows[2], x4], -1)
        for k in range(1, 7):
            x = getattr(self, f"dc_conv{k}")(x)
        flow2 = flows[2] + self.dc_conv7(x)
        return [resize(flow2 * 4.0, (h, w)), resize(flows[3] * 4.0, (h // 2, w // 2)),
                resize(flows[4] * 4.0, (h // 4, w // 4)), resize(flows[5] * 4.0, (h // 8, w // 8))]
