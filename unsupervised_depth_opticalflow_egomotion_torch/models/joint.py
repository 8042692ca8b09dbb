"""Joint depth / optical-flow / ego-motion model and its three loss graphs.

Port of the JAX package's ``models/joint.py``: ``forward_flow`` (the
photometric flow objective with forward-splat or diff-weight occlusion),
``forward_depth`` (depth + pose reconstruction) and ``forward_geom`` (the
flagship joint objective with dynamic-region masks, epipolar distance maps
and cross-task consistency). One ``nn.Module`` hosts the four sub-networks
under the reference's state_dict names (``depth_net``, ``pose_net``,
``fpyramid``, ``pwc_model``), and the four inference methods of the eval
path (``infer_disp``, ``infer_depth``, ``inference_flow``, ``infer_pose``).
Under ``Config.flow_net="raft"`` (flow mode alone) RAFT (``models/raft.py``,
at ``raft``) takes the place of ``fpyramid`` and ``pwc_model``, and the flow
objective scores each of its iterations (RAFT's sequence loss).

The model is built from a ``Config`` and has no defaults of its own, so it
cannot drift from the configuration the way the JAX module's defaults do.
BatchNorm runs in batch-statistics mode when the module is in ``train()``
mode and updates its running statistics in place.

Every option of the JAX objective is ported: the depth consistency in depth
and geom modes, the loss base scale (the whole loss pyramid ``ls`` octaves
below the input, on the depth net's extra coarse heads) and the sampled
geometric losses of geom mode (triangulation, PnP and RANSAC-F eight-point
consistency). One sampled match set feeds all three, and the caller draws
its indices (``draw_samples``), so the card and the CPU can be given the same
draws. ``encoder_int8`` runs the depth encoder's convs in int8
(``models/depth_net.py``, ``ops/int8_conv.py``).

The training forwards mark their networks (``net.depth``, ``net.pose``,
``net.pyramid``, ``net.pwc``; RAFT's ``net.raft.fnet``, ``net.raft.cnet``,
``net.raft.corr`` and ``net.raft.iter`` with the iteration's index) and the
parts of the loss graph (``loss.recon``, ``loss.flow_warps``,
``loss.masks``, ``loss.terms``, ``loss.sampled``; ``loss.iter`` with the
index around each of RAFT's iterations' objective) as program spans
(``utils/profiler.span``), each once a call (an iteration's once an
iteration); the inference methods mark nothing.

NOTE (preserved reference behaviour): the sigmoid disp pyramid is used
directly as "depth" in the reconstruction.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn

from ..config import Config
from ..ops import losses as L
from ..ops import masks as M
from ..ops.geometry import disp2depth, fundamental_from_pose, projection_matrices
from ..ops.interp import image_pyramid, resize_area
from ..ops.inverse_warp_multi import multiscale_recon_dynamic, multiscale_reconstruction
from ..ops.pnp import batched_pnp
from ..ops.ransac import batched_ransac_fundamental
from ..ops.sampling import draw_indices, sample_matches, top_ratio_count
from ..ops.splat import occlusion_mask_from_flow
from ..ops.ssim import ssim_route
from ..ops.triangulation import midpoint_triangulate, register_depth, reproject
from ..ops.warp import WarpRoute, warp_flow
from ..utils.profiler import span
from .depth_net import DepthNet
from .feature_pyramid import FeaturePyramid
from .layers import module_mode
from .pose_net import PoseNet
from .pwc_decoder import PWCDecoder
from .raft import GAMMA, RAFT


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
FLOW_NETS = ("pwc", "raft")
# Config.flow_occ_impl -> taps of occlusion_mask_from_flow
_OCC_TAPS = {
    "splat": "bilinear",
    "splat_xla": "bilinear_xla",
    "splat_nn": "nearest",
    "splat_nn_half": "nearest_half",
}


def compute_dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def needs_samples(cfg: Config) -> bool:
    """Whether the geom objective samples matches (a geometric loss is on)."""
    return cfg.mode == "geom" and (
        cfg.enable_triangle or cfg.enable_pnp or cfg.enable_eight_point
    )


def _loss_frames(frames, ls: int):
    """The frames at the loss base scale (area-resized ``ls`` octaves down)."""
    if not ls:
        return frames
    h, w = frames[0].shape[1], frames[0].shape[2]
    return tuple(resize_area(f, (h >> ls, w >> ls)) for f in frames)


def _check_flow_net(cfg: Config) -> None:
    """RAFT trains in flow mode alone, with one output resolution."""
    if cfg.flow_net not in FLOW_NETS:
        raise ValueError(f"flow_net must be one of {FLOW_NETS}, got {cfg.flow_net!r}")
    if cfg.flow_net != "raft":
        return
    if cfg.mode != "flow":
        raise ValueError(f"flow_net='raft' trains in mode 'flow' alone, not {cfg.mode!r}")
    if cfg.loss_base_scale != 0 or cfg.num_scales != 1:
        raise ValueError("flow_net='raft' scores one full-resolution flow: it needs "
                         f"loss_base_scale 0 and num_scales 1, got {cfg.loss_base_scale} "
                         f"and {cfg.num_scales}")
    if min(cfg.img_hw) < 128:
        # the pyramid's coarsest level is 1/64 of the frame, and the lookup
        # normalises by its size less one
        raise ValueError(f"flow_net='raft' needs img_hw of at least 128 x 128, "
                         f"got {tuple(cfg.img_hw)}")


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
        ls = cfg.loss_base_scale
        if ls < 0 or (ls and ls + cfg.num_scales > 4):
            raise ValueError(
                "loss_base_scale + num_scales must be <= 4 (the PWC decoder "
                f"emits 4 flow scales); got {ls} + {cfg.num_scales}"
            )
        _check_flow_net(cfg)
        self.cfg = cfg
        self.dtype = dtype = compute_dtype(cfg)
        self.warp_route = WarpRoute(cfg.warp_impl, cfg.warp_bf16)
        self.depth_net = DepthNet(
            cfg.num_scales, cfg.packed_convs, cfg.packed_encoder, cfg.packed_stem,
            cfg.encoder_int8, dtype, extra_head_scales=ls,
        )
        self.pose_net = PoseNet(cfg.img_hw, cfg.num_input_frames, dtype)
        if cfg.flow_net == "raft":
            self.raft = RAFT(dtype)
        else:
            self.fpyramid = FeaturePyramid(cfg.packed_convs, dtype)
            self.pwc_model = PWCDecoder(corr_impl=cfg.pwc_corr, dtype=dtype)

    # ------------------------------------------------------------------ infer
    # The four inference methods of the JAX JointModel (joint.py:174-192). Each
    # runs in eval mode (BatchNorm on its running statistics, as the JAX
    # ``depth_net(img, False)``) and without autograd, whatever mode the model
    # is in; the modules' modes are restored after. Inputs are float NHWC
    # frames in [0, 1], cast to the compute dtype; outputs are f32.
    @contextlib.contextmanager
    def _inference(self):
        with module_mode(self, False), torch.no_grad():
            yield

    def infer_disp(self, img):
        """Raw full-resolution sigmoid disparity [B,H,W,1]."""
        with self._inference():
            return self.depth_net(img.to(self.dtype))[0].float()

    def infer_depth(self, img):
        """Bounded depth from the full-resolution disparity head
        (the reference's model_geometry.py:289-292)."""
        return disp2depth(self.infer_disp(img))

    def inference_flow(self, img1, img2):
        """Full-resolution forward flow [B,H,W,2] (model_geometry.py:294-298):
        the feature pyramid on each image, then the PWC decoder; under
        ``flow_net="raft"`` RAFT's last flow at its inference iterations."""
        with self._inference():
            if self.cfg.flow_net == "raft":
                return self.raft(img1, img2)
            hw = (img1.shape[1], img1.shape[2])
            f1 = self.fpyramid(img1.to(self.dtype))
            f2 = self.fpyramid(img2.to(self.dtype))
            return self.pwc_model(f1, f2, hw)[0].float()

    def infer_pose(self, imgs):
        """[B, N-1, 6] pose vectors from channel-stacked frames [B,H,W,3N]."""
        with self._inference():
            return self.pose_net(imgs.to(self.dtype)).float()

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
        "diff_weights". With ``loss_base_scale`` ls the flows of scales
        ls..3 are scored against the frames area-resized ls octaves down, and
        no warp samples the uint8 frames.

        Under ``flow_net="raft"`` the objective scores each of RAFT's
        iterations' full-resolution flows (scale 0 alone), and the packs are
        summed with weights ``GAMMA ** (N - 1 - i)`` (RAFT's sequence loss);
        its context encoder's BatchNorm runs.
        """
        del K_ms, K_inv_ms
        if self.cfg.flow_net == "raft":
            return self._raft_sequence_loss(images)
        ls = self.cfg.loss_base_scale
        raw = split_stack_raw(images) if ls == 0 else None
        frames = split_stack(images, self.dtype)
        img_l, img, img_r = frames
        hw = (img.shape[1], img.shape[2])

        # one 3B feature pass + one 2B decoder pass (bwd first, fwd second)
        with span("net.pyramid"):
            feats_all = self.fpyramid(torch.cat([img_l, img, img_r], 0))
        with span("net.pwc"):
            feat_l, feat, feat_r = zip(*(_split3(f) for f in feats_all))
            feat_cc = tuple(torch.cat([c, c], 0) for c in feat)
            feat_lr = tuple(torch.cat(p, 0) for p in zip(feat_l, feat_r))
            flows_both = self.pwc_model(feat_cc, feat_lr, hw)[ls:]
        return self._flow_objective(raw, frames, flows_both)

    def _raft_sequence_loss(self, images):
        """RAFT's flows after each iteration (from the f32 frames), each
        scored by the flow objective at full resolution, weighted
        GAMMA ** (N - 1 - i)."""
        frames32 = split_stack(images, torch.float32)
        flows = self.raft.flows_of_triplet(*frames32)
        raw = split_stack_raw(images)
        frames = tuple(f.to(self.dtype) for f in frames32)
        n, pack = len(flows), {}
        for i, flow in enumerate(flows):
            with span("loss.iter", i):
                weight = GAMMA ** (n - 1 - i)
                for k, v in self._flow_objective(raw, frames, [flow]).items():
                    pack[k] = pack[k] + weight * v if k in pack else weight * v
        return pack

    def _flow_objective(self, raw, frames, flows_both):
        """The flow objective's loss pack for the 2B flows ``flows_both``
        (bwd first, fwd second; finest first, from scale ``loss_base_scale``)
        of the frame triplet ``frames`` (and its ``raw`` uint8 rows, or
        None)."""
        cfg = self.cfg
        ns = cfg.num_scales
        ls = cfg.loss_base_scale
        ssim_impl = cfg.ssim_impl
        b = flows_both[0].shape[0] // 2
        flows_bwd = [f[:b] for f in flows_both]
        flows_fwd = [f[b:] for f in flows_both]

        # the flow objective uses area pyramids
        img_l, img, img_r = _loss_frames(frames, ls)
        n = len(flows_fwd)
        img_l_pyr = image_pyramid(img_l, n, mode="area")
        img_pyr = image_pyramid(img, n, mode="area")
        img_r_pyr = image_pyramid(img_r, n, mode="area")
        smooth = L.flow_smooth_loss(flows_fwd[:ns], img_pyr[:ns]) + L.flow_smooth_loss(
            flows_bwd[:ns], img_pyr[:ns]
        )
        diff_weights = cfg.flow_occ_impl == "diff_weights"
        with span("loss.flow_warps"):
            warped_from_l, warped_from_r = self._flow_warps(raw, img_l_pyr, img_r_pyr, flows_both)
            if diff_weights:
                diff_bwd, diff_fwd, w_bwd, w_fwd = M.diff_weights(
                    warped_from_l, img_pyr, warped_from_r
                )
            else:
                # forward-splat ones along the approximate inverse flow
                # (-flow); pixels receiving no mass are occluded
                taps = _OCC_TAPS[cfg.flow_occ_impl]
                occ_fwd = [occlusion_mask_from_flow(-f, taps) for f in flows_fwd]
                occ_bwd = [occlusion_mask_from_flow(-f, taps) for f in flows_bwd]

        if diff_weights:
            with span("loss.terms"):
                return {
                    "loss_flow_pixel": L.masked_diff_loss(diff_fwd[:ns], w_fwd[:ns])
                    + L.masked_diff_loss(diff_bwd[:ns], w_bwd[:ns]),
                    "loss_flow_ssim": L.ssim_loss(img_pyr[:ns], warped_from_r[:ns], w_fwd[:ns],
                                                  ssim_impl)
                    + L.ssim_loss(img_pyr[:ns], warped_from_l[:ns], w_bwd[:ns], ssim_impl),
                    "loss_flow_smooth": smooth,
                    "loss_flow_consis": L.flow_consis_loss(flows_fwd[:ns], flows_bwd[:ns],
                                                           w_fwd[:ns]),
                }

        with span("loss.masks"):
            valid_fwd = [1.0 - M.all_zero(wr).to(wr.dtype) for wr in warped_from_r]
            valid_bwd = [1.0 - M.all_zero(wl).to(wl.dtype) for wl in warped_from_l]
            mask_fwd = M.fuse_masks(valid_fwd, occ_fwd)
            mask_bwd = M.fuse_masks(valid_bwd, occ_bwd)
        with span("loss.terms"):
            return {
                "loss_flow_pixel": L.photometric_loss(img_pyr[:ns], warped_from_l[:ns],
                                                      mask_bwd[:ns])
                + L.photometric_loss(img_pyr[:ns], warped_from_r[:ns], mask_fwd[:ns]),
                "loss_flow_ssim": L.ssim_loss(img_pyr[:ns], warped_from_r[:ns], mask_fwd[:ns],
                                              ssim_impl)
                + L.ssim_loss(img_pyr[:ns], warped_from_l[:ns], mask_bwd[:ns], ssim_impl),
                "loss_flow_smooth": smooth,
                "loss_flow_consis": L.flow_consis_loss(flows_fwd[:ns], flows_bwd[:ns],
                                                       occ_fwd[:ns]),
            }

    def forward_depth(self, images, K_ms, K_inv_ms):
        """Depth loss pack (dict of [B] vectors): pixel and smoothness, and
        SSIM / depth consistency when their ``enable_*`` flags are set. With
        ``loss_base_scale`` ls: the disparities of scales ls..ls+ns-1, K at
        scale ls and the frames area-resized ls octaves down."""
        del K_inv_ms
        cfg = self.cfg
        ns = cfg.num_scales
        ls = cfg.loss_base_scale
        K = K_ms[:, ls]
        img_l, img, img_r = split_stack(images, self.dtype)

        # depth on all three frames in one 3B pass (BN stats over the triplet)
        with span("net.depth"):
            disp_all = self.depth_net(torch.cat([img_l, img, img_r], 0), ls)
        disp_l, disp, disp_r = (list(t) for t in zip(*(_split3(d) for d in disp_all)))
        with span("net.pose"):
            poses = self.pose_net(torch.cat([img_l, img, img_r], -1))
        pose_fwd, pose_bwd = poses[:, 1], poses[:, 0]

        img_l, img, img_r = _loss_frames((img_l, img, img_r), ls)
        img_pyr = image_pyramid(img, ns)
        img_l_pyr = image_pyramid(img_l, ns)
        img_r_pyr = image_pyramid(img_r, ns)

        consis = cfg.enable_depth_consis
        with span("loss.recon"):
            rec_l, valid_l, pdepth_l, cdepth_l = multiscale_reconstruction(
                img_l, K, disp, disp_l, pose_bwd, sample_ref_depth=consis, route=self.warp_route
            )
            rec_r, valid_r, pdepth_r, cdepth_r = multiscale_reconstruction(
                img_r, K, disp, disp_r, pose_fwd, sample_ref_depth=consis, route=self.warp_route
            )
            tex_bwd = M.texture_masks(img_pyr, rec_l, img_l_pyr)
            tex_fwd = M.texture_masks(img_pyr, rec_r, img_r_pyr)
        with span("loss.masks"):
            mask_bwd = M.fuse_masks(valid_l, tex_bwd)
            mask_fwd = M.fuse_masks(valid_r, tex_fwd)

        with span("loss.terms"):
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

    def draw_samples(self, generator: torch.Generator, batch_size: int, hw=None):
        """The index draws of one geom step's sampled losses, int64 on the
        CPU from ``generator`` (None when no geometric loss is on):
        "bwd" / "fwd" [B, geometric_num] pick the kept matches of each
        direction (in score order, uniform with replacement), and with the
        eight-point loss "8_bwd" / "8_fwd" [B, ransac_iters, 8] pick each
        RANSAC hypothesis's minimal sample. ``hw`` is the input's
        [H, W] (default ``img_hw``)."""
        cfg = self.cfg
        if not needs_samples(cfg):
            return None
        h, w = cfg.img_hw if hw is None else hw
        ls = cfg.loss_base_scale
        kept = top_ratio_count((h >> ls) * (w >> ls), cfg.geometric_ratio)
        num = cfg.geometric_num
        out = {d: draw_indices(generator, (batch_size, num), kept) for d in ("bwd", "fwd")}
        if cfg.enable_eight_point:
            for d in ("bwd", "fwd"):
                out["8_" + d] = draw_indices(generator, (batch_size, cfg.ransac_iters, 8), num)
        return out

    def forward_geom(self, images, K_ms, K_inv_ms, with_masks: bool = False, draws=None):
        """Geom loss pack (dict of [B] vectors) and, ``with_masks``, the masks.

        ``images`` is the [B,3H,W,3] frame stack (uint8 or float), ``K_ms`` /
        ``K_inv_ms`` the [B,S,3,3] intrinsics pyramids. ``draws`` are the
        index tensors of ``draw_samples`` on the images' device; they are
        required when a geometric loss is on. With ``loss_base_scale`` ls
        every loss-side quantity lives ls octaves down (K at scale ls, the
        disparities and flows of scales ls..ls+ns-1, area-resized frames).
        """
        cfg = self.cfg
        ns = cfg.num_scales
        ls = cfg.loss_base_scale
        ssim_impl = cfg.ssim_impl
        if needs_samples(cfg) and draws is None:
            # a fixed fallback draw would repeat the sampled set every step
            # and silently bias the geometric losses
            raise ValueError(
                "forward_geom requires `draws` (JointModel.draw_samples) when "
                "triangle/pnp/eight_point losses are enabled"
            )
        K, K_inv = K_ms[:, ls], K_inv_ms[:, ls]
        raw = split_stack_raw(images) if ls == 0 else None
        img_l, img, img_r = split_stack(images, self.dtype)
        hw = (img.shape[1], img.shape[2])
        b = img.shape[0]

        # depth on all three frames in one 3B pass (BN stats over the triplet)
        with span("net.depth"):
            disp_all = self.depth_net(torch.cat([img_l, img, img_r], 0), ls)
        disp_l, disp, disp_r = (list(t) for t in zip(*(_split3(d) for d in disp_all)))

        with span("net.pose"):
            poses = self.pose_net(torch.cat([img_l, img, img_r], -1))
        pose_fwd, pose_bwd = poses[:, 1], poses[:, 0]

        # one 3B feature pass + one 2B decoder pass (bwd first, fwd second)
        with span("net.pyramid"):
            feats_all = self.fpyramid(torch.cat([img_l, img, img_r], 0))
        with span("net.pwc"):
            feat_l, feat, feat_r = zip(*(_split3(f) for f in feats_all))
            feat_cc = tuple(torch.cat([c, c], 0) for c in feat)
            feat_lr = tuple(torch.cat(p, 0) for p in zip(feat_l, feat_r))
            flows_both = self.pwc_model(feat_cc, feat_lr, hw)[ls : ls + ns]
        flows_bwd = [f[:b] for f in flows_both]
        flows_fwd = [f[b:] for f in flows_both]

        img_l, img, img_r = _loss_frames((img_l, img, img_r), ls)
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
        consis = cfg.enable_depth_consis
        with span("loss.recon"):
            rec2, valid_to2, pdepth2, cdepth2, fd2, dyn2, fds2 = multiscale_recon_dynamic(
                cat2(img_l, img_r), K2, [cat2(d, d) for d in disp],
                [cat2(dl, dr) for dl, dr in zip(disp_l, disp_r)], pose2, flows2,
                cfg.flow_consist_alpha, cfg.flow_consist_beta, sample_ref_depth=consis,
                ref_img_u8=cat2(raw[0], raw[2]) if raw is not None else None,
                route=self.warp_route,
            )
            rec_l, rec_r = zip(*(split2(x) for x in rec2))
            tex_bwd = M.texture_masks(img_pyr, rec_l, img_l_pyr)
            tex_fwd = M.texture_masks(img_pyr, rec_r, img_r_pyr)

        # flow reconstruction of the centre frame (raw uint8 rows at scale 0)
        with span("loss.flow_warps"):
            warped_from_l, warped_from_r = self._flow_warps(raw, img_l_pyr, img_r_pyr, flows2)
            occ_bwd, occ_fwd, valid_bwd, valid_fwd = M.occlusion_weights(
                warped_from_l, img_pyr, warped_from_r
            )

        with span("loss.masks"):
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

        with span("loss.terms"):
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
                "loss_depth_consis": (
                    L.depth_consis_loss([x[:b] for x in pdepth2], [x[:b] for x in cdepth2],
                                        bwd_mask_tex)
                    + L.depth_consis_loss([x[b:] for x in pdepth2], [x[b:] for x in cdepth2],
                                          fwd_mask_tex)
                    if consis
                    else zero
                ),
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

        if needs_samples(cfg):
            with span("loss.sampled"):
                # one sampled set per direction (2B: bwd, fwd) feeds all three
                # geometric losses: the top geometric_ratio of the top-scale
                # matches by flow-consistency score, then the drawn indices
                disp0 = cat2(disp[0], disp[0])
                m2, d2 = sample_matches(
                    torch.cat([draws["bwd"], draws["fwd"]]), flows2[0], disp0, fds2[0],
                    cfg.geometric_ratio,
                )
                K_inv2 = cat2(K_inv, K_inv)
                geo = {}
                if cfg.enable_triangle:
                    geo["loss_triangle"] = self._triangle_loss(
                        m2, pose2, K2, K_inv2, disp0, cat2(disp_l[0], disp_r[0])
                    )
                if cfg.enable_pnp:
                    geo["loss_pnp"] = self._pnp_loss(m2, d2, pose2, K2, K_inv2)
                if cfg.enable_eight_point:
                    geo["loss_eight_point"] = self._eight_point_loss(
                        torch.cat([draws["8_bwd"], draws["8_fwd"]]), m2, pose2, K_inv2
                    )
                for k, v in geo.items():
                    loss_pack[k] = v[:b] + v[b:]

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

    def _pnp_loss(self, match, depth_sampled, pose, K, K_inv):
        """PnP-consistency pose loss [B] (the reference's model_geometry.py:
        473-530): the Gauss-Newton PnP pose of the sampled matches, whose 3D
        points are the back-projected pixels scaled by the sampled
        DISPARITY (the reference's quirk, kept), against the predicted pose.
        The solver's inputs are detached, as the reference's OpenCV call's
        are, so gradients pull the pose net toward the estimate."""
        match = match.float()
        pix = torch.cat([match[..., :2], torch.ones_like(match[..., :1])], dim=-1)
        pts3d = (pix @ K_inv.float().transpose(1, 2)) * depth_sampled.float()
        # [B,6] = [tvec | rvec], the pose vector's layout
        pred = batched_pnp(pts3d.detach(), match[..., 2:].detach(), K.float())
        pose = pose.float()
        pos_l = (pred[:, :3] - pose[:, :3]).abs()
        rot_l = (pred[:, 3:] - pose[:, 3:]).abs()
        return (pos_l + self.cfg.pose_beta * rot_l).mean(dim=1)

    def _eight_point_loss(self, idx8, match, pose, K_inv):
        """Fundamental-matrix consistency loss [B] (model_geometry.py:548-566,
        with the JAX package's fixes): F from the detached sampled matches by
        batched RANSAC eight-point, against F(pose) = K^-T [t]x R K^-1, both
        unit-Frobenius, the estimate's sign aligned to the prediction,
        smooth-L1."""
        match = match.detach().float()
        F_hat = batched_ransac_fundamental(idx8, match[..., :2], match[..., 2:], thres=0.1)[0]
        F_pred = fundamental_from_pose(pose.float(), K_inv.float())
        F_pred = F_pred / (torch.linalg.matrix_norm(F_pred)[:, None, None] + 1e-12)
        sign = torch.sign((F_hat * F_pred.detach()).sum((1, 2), keepdim=True))
        sign = torch.where(sign == 0, torch.ones_like(sign), sign)
        diff = F_pred - sign * F_hat
        ad = diff.abs()
        huber = torch.where(ad < 1.0, 0.5 * diff * diff, ad - 0.5)
        return huber.mean(dim=(1, 2))

    def _triangle_loss(self, match, pose, K, K_inv, disp1, disp2):
        """Triangulated-depth registration loss [B] (model_geometry.py:
        670-683): midpoint-triangulate the matches under the predicted pose,
        register each frame's disparity map on the triangulated depths and
        score the registered samples."""
        P1, P2 = projection_matrices(pose.float(), K.float())
        points = midpoint_triangulate(match, K_inv.float(), P1, P2)
        c1, d1 = reproject(P1, points)
        c2, d2 = reproject(P2, points)
        _, inter1 = register_depth(disp1, c1, d1)
        _, inter2 = register_depth(disp2, c2, d2)
        return L.triangulation_loss(d1, inter1) + L.triangulation_loss(d2, inter2)
