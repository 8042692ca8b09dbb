"""Plain float32 reference of the depth stage's training objective.

Written for the benchmark from the objective the port implements at commit
081cc9f (``models/joint.py`` ``forward_depth``,
``ops/{inverse_warp_multi,geometry,masks,losses}.py``), in plain PyTorch
and float32, with nothing imported from the port. It covers what the
benchmark's depth configuration states: every ``enable_*`` off and loss
base scale 0 (depth SSIM and depth consistency are zeros). Any other
setting raises.

The depth net runs once over the 3B triplet (left, centre, right), so its
BatchNorm statistics are the triplet's; PoseNet takes the channel-stacked
triplet and gives the centre -> left pose (``[:, 0]``) and the centre ->
right pose (``[:, 1]``). At each scale of the disparity pyramid each side
frame, area-resized, is sampled at the rigid projection of the centre
frame's pixels (the sigmoid disparity standing in for depth, K scaled to
the level), one warp call a side; its mask is the projection's validity
times the texture mask (the reconstruction beats the unwarped side frame).
The loss is the masked photometric error of both directions plus the
edge-aware disparity smoothness of all three frames. The pieces are the
joint reference's (``joint.py``, ``nets.py``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .joint import (_UNSUPPORTED, WEIGHTS, area, disp_smooth, photometric, pyramid,
                    rigid_projection, warp_frame)
from .nets import Conv, DepthNet, FeaturePyramid, Linear, PoseNet, PWCDecoder

TERMS = ("loss_depth_pixel", "loss_depth_ssim", "loss_depth_smooth", "loss_depth_consis")


class DepthReference(nn.Module):
    """The depth and pose networks under the port's state_dict names, and
    the depth stage's loss pack. The flow networks are held, unused, since
    the port's model holds them: they take no gradient on either side.
    ``calls`` and ``fake_quant`` as in ``JointReference``."""

    def __init__(self, cfg: dict, fake_quant=None):
        super().__init__()
        for key in _UNSUPPORTED:
            if cfg.get(key):
                raise NotImplementedError(f"the reference does not implement {key}={cfg[key]!r}")
        if cfg["mode"] != "depth":
            raise NotImplementedError(f"the depth reference does not implement mode "
                                      f"{cfg['mode']!r}")
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
        return {k: float(self.cfg[WEIGHTS[k]]) for k in TERMS}

    def loss_pack(self, images, K_ms, K_inv_ms, calls=None) -> dict:
        ns = self.cfg["num_scales"]
        h = images.shape[1] // 3
        frames = images.float() / 255.0
        if self.fake_quant is not None:
            frames = self.fake_quant(frames)
        l, c, r = frames[:, :h], frames[:, h:2 * h], frames[:, 2 * h:]
        b = c.shape[0]
        K = K_ms[:, 0].float()
        disp_all = self.depth_net(torch.cat([l, c, r], 0))
        disp_l, disp, disp_r = ([d[i * b:(i + 1) * b] for d in disp_all] for i in range(3))
        poses = self.pose_net(torch.cat([l, c, r], -1))
        pose_bwd, pose_fwd = poses[:, 0], poses[:, 1]
        cp, lp, rp = (pyramid(x, ns, "bilinear") for x in (c, l, r))

        def reconstruct(src, src_pyr, pose):
            """The side frame sampled at the centre's rigid projection at
            each scale, and each sample's mask: validity times texture."""
            recs, masks = [], []
            for d, i, s in zip(disp, cp, src_pyr):
                hs, ws = d.shape[1], d.shape[2]
                Ks = torch.cat([K[:, :2] / (h / hs), K[:, 2:]], 1)
                coords, valid, _ = rigid_projection(d, pose, Ks)
                rec = warp_frame(area(src, (hs, ws)), coords, calls)[0]
                tex = ((i - rec).abs().mean(-1, keepdim=True)
                       < (i - s).abs().mean(-1, keepdim=True)).float()
                recs.append(rec)
                masks.append(valid * tex)
            return recs, masks

        zero = torch.zeros(b, device=c.device)
        return {
            "loss_depth_pixel": photometric(cp, *reconstruct(l, lp, pose_bwd))
            + photometric(cp, *reconstruct(r, rp, pose_fwd)),
            "loss_depth_ssim": zero,
            "loss_depth_smooth": disp_smooth(c, disp) + disp_smooth(l, disp_l)
            + disp_smooth(r, disp_r),
            "loss_depth_consis": zero,
        }
