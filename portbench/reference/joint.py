"""Plain float32 reference of the joint model's training objective.

Written for the benchmark from the objective the port implements at commit
6d2cb1d (``models/joint.py`` ``forward_geom`` and ``forward_flow``,
``ops/{losses,masks,geometry,inverse_warp_multi,splat,ssim}.py``), in plain
PyTorch and float32, with nothing imported from the port. It covers what the
benchmark's configurations state: the geom objective without the optional
losses (depth SSIM and consistency, triangulation, PnP, eight-point) and the
flow objective with nearest-splat or bilinear-splat occlusion, both at loss
base scale 0. Any other setting raises.

The photometric inputs are the frames in [0, 1]; every warp of a frame is a
bilinear sample with zeros outside (``nets.sample``), and its validity mask
is the sample of an all-ones plane (a weight sum of at least 0.9999). The
sigmoid disparity stands in for depth in the reconstruction, as in the
published objective.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..flops import (SPLAT_FLOPS_PER_PIXEL, SSIM_BWD_FLOPS, SSIM_FWD_FLOPS,
                     WARP_BWD_FLOPS_PER_PIXEL, WARP_NOGRAD_FLOPS_PER_PIXEL, counted)
from .nets import Conv, DepthNet, FeaturePyramid, Linear, PoseNet, PWCDecoder, sample

WEIGHTS = {  # loss pack key -> configuration key of its weight
    "loss_flow_pixel": "w_flow_pixel", "loss_flow_ssim": "w_flow_ssim",
    "loss_flow_smooth": "w_flow_smooth", "loss_flow_consis": "w_flow_consis",
    "loss_depth_pixel": "w_depth_pixel", "loss_depth_ssim": "w_depth_ssim",
    "loss_depth_smooth": "w_depth_smooth", "loss_depth_consis": "w_depth_consis",
    "loss_depth_flow_consis": "w_depth_flow_consis", "loss_epipolar": "w_epipolar",
    "loss_triangle": "w_triangle", "loss_pnp": "w_pnp", "loss_eight_point": "w_8point",
}
_UNSUPPORTED = ("enable_depth_ssim", "enable_depth_consis", "enable_triangle", "enable_pnp",
                "enable_eight_point", "loss_base_scale", "depth_smooth_norm", "fix_flow",
                "fix_depth", "fix_pose")


# ------------------------------------------------------------------ pieces
def absj(x):
    """|x| with derivative +1 at 0, as the objective defines it."""
    return torch.where(x >= 0, x, -x)


def bmean(x):
    return x.mean(dim=(1, 2, 3))


def area(x, hw):
    b, h, w, c = x.shape
    nh, nw = hw
    return x.reshape(b, nh, h // nh, nw, w // nw, c).mean(dim=(2, 4))


def pyramid(img, n, mode):
    h, w = img.shape[1], img.shape[2]
    if mode == "area":
        return [area(img, (h >> s, w >> s)) for s in range(n)]
    out = []
    for s in range(n):
        y = img if s == 0 else F.interpolate(img.permute(0, 3, 1, 2), size=(h >> s, w >> s),
                                             mode="bilinear", align_corners=False)
        out.append(y if s == 0 else y.permute(0, 2, 3, 1))
    return out


def grid(h, w, device):
    yy, xx = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32), indexing="ij")
    return xx, yy


def warp_frame(src, coords, calls):
    """A frame sampled at normalized coords, and the weight sum of the taps."""
    n = coords.shape[0] * coords.shape[1] * coords.shape[2]
    (coords,) = counted(calls, "warp", WARP_NOGRAD_FLOPS_PER_PIXEL * n,
                        WARP_BWD_FLOPS_PER_PIXEL * n, (n,), coords)
    ones = torch.ones_like(src[..., :1])
    out = sample(torch.cat([src, ones], -1), coords)
    return out[..., :3], out[..., 3:]


def flow_warp(src, flow, calls):
    """The frame warped backwards by ``flow``, zeroed where the taps' weight
    sum is under 0.9999."""
    _, h, w, _ = flow.shape
    xx, yy = grid(h, w, flow.device)
    coords = torch.stack([2.0 * (xx + flow[..., 0]) / (w - 1) - 1.0,
                          2.0 * (yy + flow[..., 1]) / (h - 1) - 1.0], -1)
    val, wsum = warp_frame(src, coords, calls)
    return val * (wsum >= 0.9999).float()


def ssim_map(x, y, calls):
    n = x.numel()
    x, y = counted(calls, "ssim", SSIM_FWD_FLOPS * n, SSIM_BWD_FLOPS * n, tuple(x.shape), x, y)

    def avg(t):
        # a contiguous NCHW input: on CUDA, avg_pool2d's backward of the
        # channels-last view of an NHWC tensor gave gradients hundreds of
        # times the CPU's (torch 2.11)
        y = F.avg_pool2d(t.permute(0, 3, 1, 2).contiguous(), 3, 1, 1, count_include_pad=True)
        return y.permute(0, 2, 3, 1)

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m1, m2 = avg(x), avg(y)
    sx = avg(x * x) - m1 * m1
    sy = avg(y * y) - m2 * m2
    sxy = avg(x * y) - m1 * m2
    return ((2 * m1 * m2 + c1) * (2 * sxy + c2)) / ((m1 * m1 + m2 * m2 + c1) * (sx + sy + c2))


def photometric(imgs, warped, masks):
    return sum(bmean(absj(i - w) * m) / (bmean(m) + 1e-12) for i, w, m in zip(imgs, warped, masks))


def ssim_loss(imgs, warped, masks, calls):
    out = 0
    for i, w, m in zip(imgs, warped, masks):
        s = ssim_map(i * m, w * m, calls)
        out = out + bmean(torch.clamp((1.0 - s) / 2.0, 0.0, 1.0)) / (bmean(m) + 1e-12)
    return out


def disp_smooth(img, disps):
    h, w = img.shape[1], img.shape[2]
    wx = torch.exp(-(img[:, :, :-1] - img[:, :, 1:]).abs().mean(-1, keepdim=True))
    wy = torch.exp(-(img[:, :-1] - img[:, 1:]).abs().mean(-1, keepdim=True))
    out = 0
    for disp in disps:
        d = disp if disp.shape[1] == h else F.interpolate(
            disp.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
            align_corners=False).permute(0, 2, 3, 1)
        out = out + bmean(absj(d[:, :, :-1] - d[:, :, 1:]) * wx) + bmean(absj(d[:, :-1] - d[:, 1:]) * wy)
    return out


def flow_smooth(flows, imgs):
    out = 0
    for flow, img in zip(flows, imgs):
        f = flow / 20.0
        wx = torch.exp(-10.0 * (img[:, :, 1:] - img[:, :, :-1]).abs().mean(-1, keepdim=True))
        wy = torch.exp(-10.0 * (img[:, 1:] - img[:, :-1]).abs().mean(-1, keepdim=True))
        dx, dy = f[:, :, 1:] - f[:, :, :-1], f[:, 1:] - f[:, :-1]
        dx2, dy2 = dx[:, :, 1:] - dx[:, :, :-1], dy[:, 1:] - dy[:, :-1]
        out = out + (bmean(wx[:, :, 1:] * absj(dx2)) + bmean(wy[:, 1:] * absj(dy2))) / 2.0
    return out


def unit(flow):
    return flow / (torch.sqrt((flow * flow).sum(-1, keepdim=True) + 1e-12) + 1e-12)


def flow_consis(fwds, bwds, occs):
    out = 0
    for f, b, o in zip(fwds, bwds, occs):
        m = 1.0 - o
        out = out + bmean(absj(unit(f) + unit(b).detach()) * m) / (bmean(m) + 1e-12)
    return out


def norm2(v):
    return torch.sqrt((v * v).sum(-1, keepdim=True)) + 1e-12


def all_zero(x):
    return (x == 0).all(dim=-1, keepdim=True).float()


# ---------------------------------------------------------------- geometry
def euler(angle):
    x, y, z = angle[:, 0], angle[:, 1], angle[:, 2]
    o, i = torch.zeros_like(x), torch.ones_like(x)
    rz = torch.stack([z.cos(), -z.sin(), o, z.sin(), z.cos(), o, o, o, i], 1).reshape(-1, 3, 3)
    ry = torch.stack([y.cos(), o, y.sin(), o, i, o, -y.sin(), o, y.cos()], 1).reshape(-1, 3, 3)
    rx = torch.stack([i, o, o, o, x.cos(), -x.sin(), o, x.sin(), x.cos()], 1).reshape(-1, 3, 3)
    return rx @ ry @ rz


def apply(m, p):
    """[B,3,k] (or [B,3,k+1], a constant column last) at every point [B,H,W,k]
    -> [B,H,W,3], as elementwise products (no matrix product)."""
    k = p.shape[-1]
    m5 = m[:, None, None]
    out = m5[..., 0] * p[..., :1]
    for j in range(1, k):
        out = out + m5[..., j] * p[..., j:j + 1]
    return out + m5[..., k] if m.shape[-1] > k else out


def rigid_projection(depth, pose, K):
    """(normalized coords with out-of-frame axes at 2, valid, rigid flow)."""
    b, h, w, _ = depth.shape
    xx, yy = grid(h, w, depth.device)
    pix = torch.stack([xx, yy, torch.ones_like(xx)], -1).expand(b, h, w, 3)
    cam = apply(torch.linalg.inv(K), pix) * depth
    rt = torch.cat([euler(pose[:, 3:]), pose[:, :3, None]], 2)
    pts = apply(K @ rt, cam)
    z = torch.clamp(pts[..., 2], min=1e-3)
    xp, yp = pts[..., 0] / z, pts[..., 1] / z
    xn, yn = 2.0 * xp / (w - 1) - 1.0, 2.0 * yp / (h - 1) - 1.0
    xn = torch.where(xn.abs() > 1.0, torch.full_like(xn, 2.0), xn)
    yn = torch.where(yn.abs() > 1.0, torch.full_like(yn, 2.0), yn)
    coords = torch.stack([xn, yn], -1)
    valid = (coords.abs().amax(-1) <= 1.0).float()[..., None]
    return coords, valid, torch.stack([xp - xx, yp - yy], -1)


def epipolar_map(pose, flow, K_inv):
    b, h, w, _ = flow.shape
    t = pose[:, :3]
    o = torch.zeros_like(t[:, 0])
    tx = torch.stack([o, -t[:, 2], t[:, 1], t[:, 2], o, -t[:, 0], -t[:, 1], t[:, 0], o],
                     1).reshape(-1, 3, 3)
    fm = K_inv.transpose(1, 2) @ (tx @ euler(pose[:, 3:])) @ K_inv
    xx, yy = grid(h, w, flow.device)
    p1 = torch.stack([xx, yy], -1).expand(b, h, w, 2)
    line = apply(fm, p1)
    p2 = torch.cat([p1 + flow, torch.ones_like(flow[..., :1])], -1)
    dist = absj((p2 * line).sum(-1)) / (torch.sqrt(line[..., 0] ** 2 + line[..., 1] ** 2) + 1e-6)
    return dist[..., None]


def nearest_mass(flow):
    """Each source pixel's unit mass to its nearest target (half to even)."""
    b, h, w, _ = flow.shape
    xx, yy = grid(h, w, flow.device)
    tx, ty = torch.round(xx + flow[..., 0]), torch.round(yy + flow[..., 1])
    return scatter(tx, ty, torch.ones_like(tx), b, h, w)


def bilinear_mass(flow, calls):
    b, h, w, _ = flow.shape
    counted(calls, "splat", SPLAT_FLOPS_PER_PIXEL * b * h * w, 0, (b * h * w,))
    xx, yy = grid(h, w, flow.device)
    tx, ty = xx + flow[..., 0], yy + flow[..., 1]
    x0, y0 = torch.floor(tx), torch.floor(ty)
    fx, fy = tx - x0, ty - y0
    return sum(scatter(x0 + dx, y0 + dy, wt, b, h, w) for dx, dy, wt in (
        (0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)), (0, 1, (1 - fx) * fy), (1, 1, fx * fy)))


def scatter(tx, ty, val, b, h, w):
    inb = (tx >= 0) & (tx <= w - 1) & (ty >= 0) & (ty <= h - 1)
    idx = ty.clamp(0, h - 1).long() * w + tx.clamp(0, w - 1).long()
    idx = idx + torch.arange(b, device=tx.device).view(b, 1, 1) * (h * w)
    out = torch.zeros(b * h * w, device=tx.device)
    out.index_add_(0, idx.reshape(-1), (val * inb).reshape(-1))
    return out.reshape(b, h, w, 1)


# -------------------------------------------------------------------- model
class JointReference(nn.Module):
    """The four networks under the port's state_dict names, and the loss
    pack of the configuration's mode. ``calls`` (``flops.KernelCalls``)
    records the kernels' functions when given. ``fake_quant`` rounds the
    frames and every convolution's and dense layer's inputs, weights and
    outputs (the control)."""

    def __init__(self, cfg: dict, fake_quant=None):
        super().__init__()
        for key in _UNSUPPORTED:
            if cfg.get(key):
                raise NotImplementedError(f"the reference does not implement {key}={cfg[key]!r}")
        if cfg["mode"] not in ("geom", "flow"):
            raise NotImplementedError(f"the reference does not implement mode {cfg['mode']!r}")
        if cfg["mode"] == "flow" and cfg["flow_occ_impl"] not in ("splat_nn", "splat"):
            raise NotImplementedError(f"flow_occ_impl {cfg['flow_occ_impl']!r}")
        self.cfg = cfg
        self.depth_net = DepthNet(cfg["num_scales"])
        self.pose_net = PoseNet(tuple(cfg["img_hw"]), cfg["num_input_frames"])
        self.fpyramid = FeaturePyramid()
        self.pwc_model = PWCDecoder()
        self.fake_quant = fake_quant
        if fake_quant is not None:
            for m in self.modules():
                if isinstance(m, (Conv, Linear)):
                    m.fake_quant = fake_quant

    def weights(self) -> dict:
        cfg = self.cfg
        return {k: float(cfg[v]) for k, v in WEIGHTS.items()}

    def loss_pack(self, images, K_ms, K_inv_ms, calls=None) -> dict:
        h = images.shape[1] // 3
        frames = images.float() / 255.0
        if self.fake_quant is not None:
            frames = self.fake_quant(frames)
        l, c, r = frames[:, :h], frames[:, h:2 * h], frames[:, 2 * h:]
        if self.cfg["mode"] == "flow":
            return self._flow(l, c, r, calls)
        return self._geom(l, c, r, K_ms, K_inv_ms, calls)

    def _flows(self, l, c, r, calls):
        b, hw = c.shape[0], (c.shape[1], c.shape[2])
        feats = self.fpyramid(torch.cat([l, c, r], 0))
        f_cc = [torch.cat([f[b:2 * b], f[b:2 * b]], 0) for f in feats]
        f_lr = [torch.cat([f[:b], f[2 * b:]], 0) for f in feats]
        return self.pwc_model(f_cc, f_lr, hw, calls)

    def _flow(self, l, c, r, calls):
        ns, b = self.cfg["num_scales"], c.shape[0]
        flows2 = self._flows(l, c, r, calls)
        n = len(flows2)
        lp, cp, rp = (pyramid(x, n, "area") for x in (l, c, r))
        warped = [flow_warp(torch.cat([a, z], 0), f, calls) for a, z, f in zip(lp, rp, flows2)]
        from_l, from_r = [w[:b] for w in warped], [w[b:] for w in warped]
        bwd, fwd = [f[:b] for f in flows2], [f[b:] for f in flows2]
        if self.cfg["flow_occ_impl"] == "splat_nn":
            mass = [nearest_mass(-f.detach()) for f in flows2]
        else:
            mass = [bilinear_mass(-f.detach(), calls) for f in flows2]
        occ = [m.clamp(0.0, 1.0) for m in mass]
        occ_bwd, occ_fwd = [o[:b] for o in occ], [o[b:] for o in occ]
        mask_fwd = [(1 - all_zero(w)) * o for w, o in zip(from_r, occ_fwd)]
        mask_bwd = [(1 - all_zero(w)) * o for w, o in zip(from_l, occ_bwd)]
        return {
            "loss_flow_pixel": photometric(cp[:ns], from_l[:ns], mask_bwd[:ns])
            + photometric(cp[:ns], from_r[:ns], mask_fwd[:ns]),
            "loss_flow_ssim": ssim_loss(cp[:ns], from_r[:ns], mask_fwd[:ns], calls)
            + ssim_loss(cp[:ns], from_l[:ns], mask_bwd[:ns], calls),
            "loss_flow_smooth": flow_smooth(fwd[:ns], cp[:ns]) + flow_smooth(bwd[:ns], cp[:ns]),
            "loss_flow_consis": flow_consis(fwd[:ns], bwd[:ns], occ_fwd[:ns]),
        }

    def _geom(self, l, c, r, K_ms, K_inv_ms, calls):
        cfg = self.cfg
        ns, b = cfg["num_scales"], c.shape[0]
        K, K_inv = K_ms[:, 0].float(), K_inv_ms[:, 0].float()
        disp_all = self.depth_net(torch.cat([l, c, r], 0))
        disp_l, disp, disp_r = ([d[i * b:(i + 1) * b] for d in disp_all] for i in range(3))
        poses = self.pose_net(torch.cat([l, c, r], -1))
        pose2 = torch.cat([poses[:, 0], poses[:, 1]], 0)  # bwd, fwd
        flows2 = self._flows(l, c, r, calls)[:ns]
        bwd, fwd = [f[:b] for f in flows2], [f[b:] for f in flows2]
        cp, lp, rp = (pyramid(x, ns, "bilinear") for x in (c, l, r))
        K2 = torch.cat([K, K], 0)
        src2 = torch.cat([l, r], 0)
        h0 = c.shape[1]

        recs, valids, fds, dyns = [], [], [], []
        for d, f in zip(disp, flows2):
            hs, ws = d.shape[1], d.shape[2]
            Ks = torch.cat([K2[:, :2] / (h0 / hs), K2[:, 2:]], 1)
            coords, valid, rigid = rigid_projection(torch.cat([d, d], 0), pose2, Ks)
            recs.append(warp_frame(area(src2, (hs, ws)), coords, calls)[0])
            valids.append(valid)
            bound = cfg["flow_consist_alpha"] * (norm2(f) ** 2 + norm2(rigid) ** 2) + cfg["flow_consist_beta"]
            diff = absj(rigid - f)
            fds.append(diff)
            dyns.append((norm2(diff) ** 2 < bound).float().detach())
        rec_l, rec_r = [x[:b] for x in recs], [x[b:] for x in recs]

        def tex(rec, src):
            return [((i - w).abs().mean(-1, keepdim=True) < (i - s).abs().mean(-1, keepdim=True)).float()
                    for i, w, s in zip(cp, rec, src)]

        tex_bwd, tex_fwd = tex(rec_l, lp), tex(rec_r, rp)
        warped = [flow_warp(torch.cat([a, z], 0), f, calls) for a, z, f in zip(lp, rp, flows2)]
        from_l, from_r = [w[:b] for w in warped], [w[b:] for w in warped]
        occ_bwd, occ_fwd, val_bwd, val_fwd = [], [], [], []
        for i, wl, wr in zip(cp, from_l, from_r):
            val_fwd.append(1 - all_zero(wr))
            val_bwd.append(1 - all_zero(wl))
            dl = (i - wl).abs().mean(-1, keepdim=True)
            dr = (i - wr).abs().mean(-1, keepdim=True)
            wgt = ((1.0 - torch.softmax(torch.cat([dl, dr], -1), -1)) > 0.48).float().detach()
            occ_bwd.append(wgt[..., :1])
            occ_fwd.append(wgt[..., 1:])
        fd_bwd, fd_fwd = [x[:b] for x in fds], [x[b:] for x in fds]
        dyn_bwd, dyn_fwd = [x[:b] for x in dyns], [x[b:] for x in dyns]
        dist = epipolar_map(pose2, flows2[0], torch.cat([K_inv, K_inv], 0))

        def prod(*ps):
            out = []
            for ms in zip(*ps):
                m = ms[0]
                for o in ms[1:]:
                    m = m * o
                out.append(m)
            return out

        fwd_mask, bwd_mask = prod(val_fwd, occ_fwd, dyn_fwd), prod(val_bwd, occ_bwd, dyn_bwd)
        fwd_vo, bwd_vo = prod(val_fwd, occ_fwd), prod(val_bwd, occ_bwd)
        zero = torch.zeros(b, device=c.device)
        w_dyn = cfg["dyna_photo_weight"]
        return {
            "loss_depth_pixel": photometric(cp, rec_l, prod(bwd_mask, tex_bwd))
            + photometric(cp, rec_r, prod(fwd_mask, tex_fwd)),
            "loss_depth_ssim": zero,
            "loss_depth_smooth": disp_smooth(c, disp) + disp_smooth(l, disp_l) + disp_smooth(r, disp_r),
            "loss_depth_consis": zero,
            "loss_flow_pixel": photometric(cp, from_l, prod(bwd_vo, dyn_bwd))
            + photometric(cp, from_r, prod(fwd_vo, dyn_fwd))
            + w_dyn * photometric(cp, from_l, prod(bwd_vo, [1 - m for m in dyn_bwd]))
            + w_dyn * photometric(cp, from_r, prod(fwd_vo, [1 - m for m in dyn_fwd])),
            "loss_flow_ssim": ssim_loss(cp, from_l, bwd_vo, calls) + ssim_loss(cp, from_r, fwd_vo, calls),
            "loss_flow_smooth": flow_smooth(fwd, cp) + flow_smooth(bwd, cp),
            "loss_flow_consis": flow_consis(fwd, bwd, occ_fwd),
            "loss_depth_flow_consis": bmean(fd_bwd[0] * bwd_mask[0]) / (bmean(bwd_mask[0]) + 1e-12)
            + bmean(fd_fwd[0] * fwd_mask[0]) / (bmean(fwd_mask[0]) + 1e-12),
            "loss_epipolar": bmean(dist[:b]) + bmean(dist[b:]),
            "loss_triangle": zero,
            "loss_pnp": zero,
            "loss_eight_point": zero,
        }
