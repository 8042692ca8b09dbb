"""Joint depth / optical-flow / ego-motion model and its geom loss graph.

Port of the JAX package's ``models/joint.py`` for the geom objective
(``forward_geom``): the flagship joint objective with dynamic-region masks,
epipolar distance maps and cross-task consistency. One ``nn.Module`` hosts
the four sub-networks under the reference's state_dict names
(``depth_net``, ``pose_net``, ``fpyramid``, ``pwc_model``).

The model is built from a ``Config`` and has no defaults of its own, so it
cannot drift from the configuration the way the JAX module's defaults do.
BatchNorm runs in batch-statistics mode when the module is in ``train()``
mode and updates its running statistics in place.

Not ported yet (they raise ``NotImplementedError``): ``forward_flow``,
``forward_depth``, the sampled geometric losses (``enable_triangle``,
``enable_pnp``, ``enable_eight_point``), ``enable_depth_consis`` and
``loss_base_scale > 0`` (ROADMAP.md, queue 1).

NOTE (preserved reference behaviour): the sigmoid disp pyramid is used
directly as "depth" in the reconstruction.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..config import Config
from ..ops import losses as L
from ..ops import masks as M
from ..ops.interp import image_pyramid
from ..ops.inverse_warp_multi import multiscale_recon_dynamic
from ..ops.ssim import ssim_route
from ..ops.warp import warp_flow
from .depth_net import DepthNet
from .feature_pyramid import FeaturePyramid
from .pose_net import PoseNet
from .pwc_decoder import PWCDecoder


def split_stack(images: torch.Tensor, dtype=None):
    """Vertically stacked 3-frame image [B,3H,W,3] -> (img_l, img, img_r).

    uint8 input is normalized to [0, 1] in f32 and then cast to ``dtype``.
    """
    if images.dtype == torch.uint8:
        tgt = dtype if dtype is not None else torch.float32
        images = (images.float() / 255.0).to(tgt)
    elif dtype is not None:
        images = images.to(dtype)
    h = images.shape[1] // 3
    return images[:, :h], images[:, h : 2 * h], images[:, 2 * h :]


def split_stack_raw(images: torch.Tensor):
    """Raw uint8 frame triplet if the stack is uint8, else None."""
    if images.dtype != torch.uint8:
        return None
    h = images.shape[1] // 3
    return images[:, :h], images[:, h : 2 * h], images[:, 2 * h :]


def _split3(x: torch.Tensor):
    b = x.shape[0] // 3
    return x[:b], x[b : 2 * b], x[2 * b :]


def compute_dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


class JointModel(nn.Module):
    # JAX JointModel fixes these two (joint.py:96-97); Config has no field
    rigid_thres = 0.5
    inlier_thres = 0.1

    def __init__(self, cfg: Config):
        super().__init__()
        unported = [
            name
            for name in ("enable_triangle", "enable_pnp", "enable_eight_point",
                         "enable_depth_consis")
            if getattr(cfg, name)
        ]
        if cfg.loss_base_scale:
            unported.append("loss_base_scale")
        if unported:
            raise NotImplementedError(
                f"not ported yet: {', '.join(unported)} (ROADMAP.md, queue 1)"
            )
        self.cfg = cfg
        self.dtype = dtype = compute_dtype(cfg)
        self.depth_net = DepthNet(
            cfg.num_scales, cfg.packed_convs, cfg.packed_encoder, cfg.packed_stem,
            cfg.encoder_int8, dtype,
        )
        self.pose_net = PoseNet(cfg.img_hw, cfg.num_input_frames, dtype)
        self.fpyramid = FeaturePyramid(cfg.packed_convs, dtype)
        self.pwc_model = PWCDecoder(corr_impl=cfg.pwc_corr, dtype=dtype)

    def forward_flow(self, *args, **kw):
        raise NotImplementedError("flow mode is not ported yet (ROADMAP.md, queue 1)")

    def forward_depth(self, *args, **kw):
        raise NotImplementedError("depth mode is not ported yet (ROADMAP.md, queue 1)")

    def forward_geom(self, images, K_ms, K_inv_ms, with_masks: bool = False):
        """Geom loss pack (dict of [B] vectors) and, ``with_masks``, the masks.

        ``images`` is the [B,3H,W,3] frame stack (uint8 or float), ``K_ms`` /
        ``K_inv_ms`` the [B,S,3,3] intrinsics pyramids.
        """
        cfg = self.cfg
        ns = cfg.num_scales
        ssim_impl = cfg.ssim_impl
        ssim_route(ssim_impl, images.device)
        K, K_inv = K_ms[:, 0], K_inv_ms[:, 0]
        raw = split_stack_raw(images)
        img_l, img, img_r = split_stack(images, self.dtype)
        hw = (img.shape[1], img.shape[2])
        b = img.shape[0]

        # depth on all three frames in one 3B pass (BN stats over the triplet)
        disp_all = self.depth_net(torch.cat([img_l, img, img_r], 0))[:ns]
        disp_l, disp, disp_r = (list(t) for t in zip(*(_split3(d) for d in disp_all)))

        poses = self.pose_net(torch.cat([img_l, img, img_r], -1))
        pose_fwd, pose_bwd = poses[:, 1], poses[:, 0]

        # one 3B feature pass + one 2B decoder pass (bwd first, fwd second)
        feats_all = self.fpyramid(torch.cat([img_l, img, img_r], 0))
        feat_l, feat, feat_r = zip(*(_split3(f) for f in feats_all))
        feat_cc = tuple(torch.cat([c, c], 0) for c in feat)
        feat_lr = tuple(torch.cat(p, 0) for p in zip(feat_l, feat_r))
        flows_both = self.pwc_model(feat_cc, feat_lr, hw)[:ns]
        flows_bwd = [f[:b] for f in flows_both]
        flows_fwd = [f[b:] for f in flows_both]

        img_pyr = image_pyramid(img, ns)
        img_l_pyr = image_pyramid(img_l, ns)
        img_r_pyr = image_pyramid(img_r, ns)

        def cat2(x, y):
            return torch.cat([x, y], 0)

        def split2(x):
            return x[:b], x[b:]

        # both warp directions go through the gathers as one 2B problem
        pose2 = cat2(pose_bwd, pose_fwd)
        K2 = cat2(K, K)
        flows2 = [cat2(fb, ff) for fb, ff in zip(flows_bwd, flows_fwd)]

        # depth/pose reconstruction + dynamic masks from one projection/scale
        rec2, valid_to2, _, fd2, dyn2, _ = multiscale_recon_dynamic(
            cat2(img_l, img_r), K2, [cat2(d, d) for d in disp], pose2, flows2,
            cfg.flow_consist_alpha, cfg.flow_consist_beta,
            ref_img_u8=cat2(raw[0], raw[2]) if raw is not None else None,
        )
        rec_l, rec_r = zip(*(split2(x) for x in rec2))
        tex_bwd = M.texture_masks(img_pyr, rec_l, img_l_pyr)
        tex_fwd = M.texture_masks(img_pyr, rec_r, img_r_pyr)

        # flow reconstruction of the centre frame (raw uint8 rows at scale 0)
        warped2 = []
        for s, (il, ir, f2) in enumerate(zip(img_l_pyr, img_r_pyr, flows2)):
            src = cat2(raw[0], raw[2]) if s == 0 and raw is not None else cat2(il, ir)
            warped2.append(
                warp_flow(src, f2, use_mask=True, out_dtype=self.dtype, src_is_data=True)
            )
        warped_from_l, warped_from_r = zip(*(split2(x) for x in warped2))
        occ_bwd, occ_fwd, valid_bwd, valid_fwd = M.occlusion_weights(
            warped_from_l, img_pyr, warped_from_r
        )

        fd_bwd, fd_fwd = (list(t) for t in zip(*(split2(x) for x in fd2)))
        dyn_bwd, dyn_fwd = (list(t) for t in zip(*(split2(x) for x in dyn2)))

        # epipolar distance maps + rigid masks (top scale)
        dist_bwd, dist_fwd = split2(M.epipolar_map(pose2, flows2[0], K2, cat2(K_inv, K_inv)))

        fwd_mask = M.fuse_masks(valid_fwd, occ_fwd, dyn_fwd)
        bwd_mask = M.fuse_masks(valid_bwd, occ_bwd, dyn_bwd)
        fwd_mask_tex = M.fuse_masks(fwd_mask, tex_fwd)
        bwd_mask_tex = M.fuse_masks(bwd_mask, tex_bwd)
        fwd_valid_occ = M.fuse_masks(valid_fwd, occ_fwd)
        bwd_valid_occ = M.fuse_masks(valid_bwd, occ_bwd)
        fwd_vo_rigid = M.fuse_masks(fwd_valid_occ, dyn_fwd)
        bwd_vo_rigid = M.fuse_masks(bwd_valid_occ, dyn_bwd)
        fwd_vo_dyna = M.fuse_masks(fwd_valid_occ, [1 - m for m in dyn_fwd])
        bwd_vo_dyna = M.fuse_masks(bwd_valid_occ, [1 - m for m in dyn_bwd])

        zero = torch.zeros((images.shape[0],), device=images.device)
        w_dyn = cfg.dyna_photo_weight
        norm = cfg.depth_smooth_norm
        loss_pack = {
            "loss_depth_pixel": L.photometric_loss(img_pyr, rec_l, bwd_mask_tex)
            + L.photometric_loss(img_pyr, rec_r, fwd_mask_tex),
            "loss_depth_ssim": (
                L.ssim_loss(img_pyr, rec_l, bwd_mask_tex, ssim_impl)
                + L.ssim_loss(img_pyr, rec_r, fwd_mask_tex, ssim_impl)
                if cfg.enable_depth_ssim
                else zero
            ),
            "loss_depth_smooth": L.disp_smooth_loss(img, disp, norm)
            + L.disp_smooth_loss(img_l, disp_l, norm)
            + L.disp_smooth_loss(img_r, disp_r, norm),
            "loss_depth_consis": zero,
            "loss_flow_pixel": L.photometric_loss(img_pyr, warped_from_l, bwd_vo_rigid)
            + L.photometric_loss(img_pyr, warped_from_r, fwd_vo_rigid)
            + w_dyn * L.photometric_loss(img_pyr, warped_from_l, bwd_vo_dyna)
            + w_dyn * L.photometric_loss(img_pyr, warped_from_r, fwd_vo_dyna),
            "loss_flow_ssim": L.ssim_loss(img_pyr, warped_from_l, bwd_valid_occ, ssim_impl)
            + L.ssim_loss(img_pyr, warped_from_r, fwd_valid_occ, ssim_impl),
            "loss_flow_smooth": L.flow_smooth_loss(flows_fwd, img_pyr)
            + L.flow_smooth_loss(flows_bwd, img_pyr),
            "loss_flow_consis": L.flow_consis_loss(flows_fwd, flows_bwd, occ_fwd),
            "loss_depth_flow_consis": L.depth_flow_consis_loss(fd_bwd, bwd_mask, 1)
            + L.depth_flow_consis_loss(fd_fwd, fwd_mask, 1),
            "loss_epipolar": L.epipolar_loss(dist_bwd, dyn_bwd[0])
            + L.epipolar_loss(dist_fwd, dyn_fwd[0]),
            "loss_triangle": zero,
            "loss_pnp": zero,
            "loss_eight_point": zero,
        }

        aux = {}
        if with_masks:
            rigid_fwd, inlier_fwd, _ = M.rigid_masks(
                dist_fwd, self.rigid_thres, self.inlier_thres
            )
            aux = {
                "occ_fwd_mask": occ_fwd[0],
                "rigid_fwd_mask": rigid_fwd,
                "inlier_fwd_mask": inlier_fwd,
                "dyna_fwd_mask": dyn_fwd[0],
                "valid_fwd_mask": split2(valid_to2[0])[1],
                "fwd_mask": fwd_mask[0],
                "texture_mask_fwd": tex_fwd[0],
                "pred_disp": disp[0],
                "pred_flow_fwd": flows_fwd[0],
            }
        return loss_pack, aux
