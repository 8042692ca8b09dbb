"""Joint depth / optical-flow / ego-motion model and its three loss graphs.

Port of the JAX package's ``models/joint.py``: ``forward_flow`` (the
photometric flow objective with forward-splat or diff-weight occlusion),
``forward_depth`` (depth + pose reconstruction) and ``forward_geom`` (the
flagship joint objective with dynamic-region masks, epipolar distance maps
and cross-task consistency). One ``nn.Module`` hosts the four sub-networks
under the reference's state_dict names (``depth_net``, ``pose_net``,
``fpyramid``, ``pwc_model``).

The model is built from a ``Config`` and has no defaults of its own, so it
cannot drift from the configuration the way the JAX module's defaults do.
BatchNorm runs in batch-statistics mode when the module is in ``train()``
mode and updates its running statistics in place.

Not ported yet (they raise ``NotImplementedError``): the sampled geometric
losses (``enable_triangle``, ``enable_pnp``, ``enable_eight_point``),
``enable_depth_consis`` in geom mode and ``loss_base_scale > 0``
(ROADMAP.md, queue 1).

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
from ..ops.inverse_warp_multi import multiscale_recon_dynamic, multiscale_reconstruction
from ..ops.splat import occlusion_mask_from_flow
from ..ops.ssim import ssim_route
from ..ops.warp import WarpRoute, warp_flow
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


MODES = ("flow", "depth", "geom")
# Config.flow_occ_impl -> taps of occlusion_mask_from_flow
_OCC_TAPS = {
    "splat": "bilinear",
    "splat_xla": "bilinear_xla",
    "splat_nn": "nearest",
    "splat_nn_half": "nearest_half",
}


def compute_dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


class JointModel(nn.Module):
    # JAX JointModel fixes these two (joint.py:96-97); Config has no field
    rigid_thres = 0.5
    inlier_thres = 0.1

    def __init__(self, cfg: Config):
        super().__init__()
        if cfg.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {cfg.mode!r}")
        if cfg.flow_occ_impl not in (*_OCC_TAPS, "diff_weights"):
            raise ValueError(f"unknown flow_occ_impl {cfg.flow_occ_impl!r}")
        ssim_route(cfg.ssim_impl, "cpu")  # validates the name
        unported = [
            name
            for name in ("enable_triangle", "enable_pnp", "enable_eight_point")
            if getattr(cfg, name)
        ]
        if cfg.enable_depth_consis and cfg.mode == "geom":
            unported.append("enable_depth_consis in geom mode")
        if cfg.loss_base_scale:
            unported.append("loss_base_scale")
        if unported:
            raise NotImplementedError(
                f"not ported yet: {', '.join(unported)} (ROADMAP.md, queue 1)"
            )
        self.cfg = cfg
        self.dtype = dtype = compute_dtype(cfg)
        self.warp_route = WarpRoute(cfg.warp_impl, cfg.warp_bf16)
        self.depth_net = DepthNet(
            cfg.num_scales, cfg.packed_convs, cfg.packed_encoder, cfg.packed_stem,
            cfg.encoder_int8, dtype,
        )
        self.pose_net = PoseNet(cfg.img_hw, cfg.num_input_frames, dtype)
        self.fpyramid = FeaturePyramid(cfg.packed_convs, dtype)
        self.pwc_model = PWCDecoder(corr_impl=cfg.pwc_corr, dtype=dtype)

    def _flow_warps(self, raw, img_l_pyr, img_r_pyr, flows2):
        """The centre frame reconstructed from both neighbours by the flows
        (2B: bwd, fwd), raw uint8 rows at scale 0; per scale (from_l, from_r)."""
        b = flows2[0].shape[0] // 2
        out = []
        for s, (il, ir, f2) in enumerate(zip(img_l_pyr, img_r_pyr, flows2)):
            if s == 0 and raw is not None:
                src = torch.cat([raw[0], raw[2]], 0)
            else:
                src = torch.cat([il, ir], 0)
            w2 = warp_flow(src, f2, use_mask=True, out_dtype=self.dtype,
                           src_is_data=True, route=self.warp_route)
            out.append((w2[:b], w2[b:]))
        return zip(*out)

    def forward_flow(self, images, K_ms, K_inv_ms):
        """Flow loss pack (dict of [B] vectors): pixel, SSIM, smoothness and
        forward/backward consistency over ``num_scales`` of the 4 flow scales.

        The K pyramids are unused (the objective is purely photometric). No
        BatchNorm module runs. ``cfg.flow_occ_impl`` picks the occlusion
        model: the forward-splat masks ("splat" = the splat kernel,
        "splat_xla", "splat_nn", "splat_nn_half"), or the reference's soft
        "diff_weights".
        """
        del K_ms, K_inv_ms
        cfg = self.cfg
        ns = cfg.num_scales
        ssim_impl = cfg.ssim_impl
        raw = split_stack_raw(images)
        img_l, img, img_r = split_stack(images, self.dtype)
        hw = (img.shape[1], img.shape[2])
        b = img.shape[0]

        # one 3B feature pass + one 2B decoder pass (bwd first, fwd second)
        feats_all = self.fpyramid(torch.cat([img_l, img, img_r], 0))
        feat_l, feat, feat_r = zip(*(_split3(f) for f in feats_all))
        feat_cc = tuple(torch.cat([c, c], 0) for c in feat)
        feat_lr = tuple(torch.cat(p, 0) for p in zip(feat_l, feat_r))
        flows_both = self.pwc_model(feat_cc, feat_lr, hw)
        flows_bwd = [f[:b] for f in flows_both]
        flows_fwd = [f[b:] for f in flows_both]

        # the flow objective uses area pyramids
        n = len(flows_fwd)
        img_l_pyr = image_pyramid(img_l, n, mode="area")
        img_pyr = image_pyramid(img, n, mode="area")
        img_r_pyr = image_pyramid(img_r, n, mode="area")
        warped_from_l, warped_from_r = self._flow_warps(raw, img_l_pyr, img_r_pyr, flows_both)

        smooth = L.flow_smooth_loss(flows_fwd[:ns], img_pyr[:ns]) + L.flow_smooth_loss(
            flows_bwd[:ns], img_pyr[:ns]
        )
        if cfg.flow_occ_impl == "diff_weights":
            diff_bwd, diff_fwd, w_bwd, w_fwd = M.diff_weights(
                warped_from_l, img_pyr, warped_from_r
            )
            return {
                "loss_flow_pixel": L.masked_diff_loss(diff_fwd[:ns], w_fwd[:ns])
                + L.masked_diff_loss(diff_bwd[:ns], w_bwd[:ns]),
                "loss_flow_ssim": L.ssim_loss(img_pyr[:ns], warped_from_r[:ns], w_fwd[:ns], ssim_impl)
                + L.ssim_loss(img_pyr[:ns], warped_from_l[:ns], w_bwd[:ns], ssim_impl),
                "loss_flow_smooth": smooth,
                "loss_flow_consis": L.flow_consis_loss(flows_fwd[:ns], flows_bwd[:ns], w_fwd[:ns]),
            }

        # forward-splat ones along the approximate inverse flow (-flow);
        # pixels receiving no mass are occluded
        taps = _OCC_TAPS[cfg.flow_occ_impl]
        occ_fwd = [occlusion_mask_from_flow(-f, taps) for f in flows_fwd]
        occ_bwd = [occlusion_mask_from_flow(-f, taps) for f in flows_bwd]
        valid_fwd = [1.0 - M.all_zero(wr).to(wr.dtype) for wr in warped_from_r]
        valid_bwd = [1.0 - M.all_zero(wl).to(wl.dtype) for wl in warped_from_l]
        mask_fwd = M.fuse_masks(valid_fwd, occ_fwd)
        mask_bwd = M.fuse_masks(valid_bwd, occ_bwd)
        return {
            "loss_flow_pixel": L.photometric_loss(img_pyr[:ns], warped_from_l[:ns], mask_bwd[:ns])
            + L.photometric_loss(img_pyr[:ns], warped_from_r[:ns], mask_fwd[:ns]),
            "loss_flow_ssim": L.ssim_loss(img_pyr[:ns], warped_from_r[:ns], mask_fwd[:ns], ssim_impl)
            + L.ssim_loss(img_pyr[:ns], warped_from_l[:ns], mask_bwd[:ns], ssim_impl),
            "loss_flow_smooth": smooth,
            "loss_flow_consis": L.flow_consis_loss(flows_fwd[:ns], flows_bwd[:ns], occ_fwd[:ns]),
        }

    def forward_depth(self, images, K_ms, K_inv_ms):
        """Depth loss pack (dict of [B] vectors): pixel and smoothness, and
        SSIM / depth consistency when their ``enable_*`` flags are set."""
        del K_inv_ms
        cfg = self.cfg
        ns = cfg.num_scales
        K = K_ms[:, 0]
        img_l, img, img_r = split_stack(images, self.dtype)

        # depth on all three frames in one 3B pass (BN stats over the triplet)
        disp_all = self.depth_net(torch.cat([img_l, img, img_r], 0))[:ns]
        disp_l, disp, disp_r = (list(t) for t in zip(*(_split3(d) for d in disp_all)))
        poses = self.pose_net(torch.cat([img_l, img, img_r], -1))
        pose_fwd, pose_bwd = poses[:, 1], poses[:, 0]

        img_pyr = image_pyramid(img, ns)
        img_l_pyr = image_pyramid(img_l, ns)
        img_r_pyr = image_pyramid(img_r, ns)

        consis = cfg.enable_depth_consis
        rec_l, valid_l, pdepth_l, cdepth_l = multiscale_reconstruction(
            img_l, K, disp, disp_l, pose_bwd, sample_ref_depth=consis, route=self.warp_route
        )
        rec_r, valid_r, pdepth_r, cdepth_r = multiscale_reconstruction(
            img_r, K, disp, disp_r, pose_fwd, sample_ref_depth=consis, route=self.warp_route
        )
        mask_bwd = M.fuse_masks(valid_l, M.texture_masks(img_pyr, rec_l, img_l_pyr))
        mask_fwd = M.fuse_masks(valid_r, M.texture_masks(img_pyr, rec_r, img_r_pyr))

        zero = torch.zeros((images.shape[0],), device=images.device)
        norm = cfg.depth_smooth_norm
        return {
            "loss_depth_pixel": L.photometric_loss(img_pyr, rec_l, mask_bwd)
            + L.photometric_loss(img_pyr, rec_r, mask_fwd),
            "loss_depth_smooth": L.disp_smooth_loss(img, disp, norm)
            + L.disp_smooth_loss(img_l, disp_l, norm)
            + L.disp_smooth_loss(img_r, disp_r, norm),
            "loss_depth_ssim": (
                L.ssim_loss(img_pyr, rec_l, mask_bwd, cfg.ssim_impl)
                + L.ssim_loss(img_pyr, rec_r, mask_fwd, cfg.ssim_impl)
                if cfg.enable_depth_ssim
                else zero
            ),
            "loss_depth_consis": (
                L.depth_consis_loss(pdepth_l, cdepth_l, mask_bwd)
                + L.depth_consis_loss(pdepth_r, cdepth_r, mask_fwd)
                if consis
                else zero
            ),
        }

    def forward_geom(self, images, K_ms, K_inv_ms, with_masks: bool = False):
        """Geom loss pack (dict of [B] vectors) and, ``with_masks``, the masks.

        ``images`` is the [B,3H,W,3] frame stack (uint8 or float), ``K_ms`` /
        ``K_inv_ms`` the [B,S,3,3] intrinsics pyramids.
        """
        cfg = self.cfg
        ns = cfg.num_scales
        ssim_impl = cfg.ssim_impl
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
            route=self.warp_route,
        )
        rec_l, rec_r = zip(*(split2(x) for x in rec2))
        tex_bwd = M.texture_masks(img_pyr, rec_l, img_l_pyr)
        tex_fwd = M.texture_masks(img_pyr, rec_r, img_r_pyr)

        # flow reconstruction of the centre frame (raw uint8 rows at scale 0)
        warped_from_l, warped_from_r = self._flow_warps(raw, img_l_pyr, img_r_pyr, flows2)
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
