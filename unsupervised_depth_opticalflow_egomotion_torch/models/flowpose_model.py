"""Flow-to-pose model family (legacy): pose regressed from normalized flow.

Port of the JAX package's ``models/flowpose_model.py`` (the reference's
model_flowposenet.py): a frozen flow network gives the dense flow,
``FlowPoseNet`` regresses the 6-DoF pose from the flow divided by the image
size, and the objective is SC-SfMLearner's pairwise loss: 0.15 L1 + 0.85
DSSIM reconstruction through ``inverse_warp2``, a depth geometry
consistency term (model_flowposenet.py:79-103) and edge-aware disparity
smoothness (:20-66).

The flow reaches the loss only as data (the JAX ``stop_gradient``), so the
flow nets run without autograd here: their parameters get no gradient and
an optimizer leaves them as they were. ``ssim_impl`` routes the SSIM map as
``Config.ssim_impl`` does: "pallas" (the default) launches the SSIM
kernels on CUDA tensors; the plain version runs on the CPU.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.geometry import inverse_warp2
from ..ops.interp import resize_area
from ..ops.ssim import ssim, ssim_route
from .depth_net import DepthNet
from .feature_pyramid import FeaturePyramid
from .flowpose_net import FlowPoseNet
from .layers import module_mode
from .pwc_decoder import PWCDecoder


def pairwise_loss(tgt_img, ref_img, tgt_depth, ref_depth, pose, K, ssim_impl: str = "pallas"):
    """(reconstruction [B], geometry consistency [B]) means
    (model_flowposenet.py:79-103)."""
    warped, _, projected_depth, computed_depth = inverse_warp2(
        ref_img, tgt_depth, ref_depth, pose, K
    )
    diff_img = (tgt_img - warped).abs()
    diff_depth = ((computed_depth - projected_depth).abs()
                  / (computed_depth + projected_depth).abs()).clamp(0.0, 1.0)
    ssim_map = (0.5 * (1.0 - ssim(tgt_img, warped, ssim_impl))).clamp(0.0, 1.0)
    diff_img = 0.15 * diff_img + 0.85 * ssim_map
    return diff_img.float().mean(dim=(1, 2, 3)), diff_depth.float().mean(dim=(1, 2, 3))


def edge_aware_smoothness(disps, img, max_scales: int = 1):
    """Quartically down-weighted multiscale edge-aware smoothness, a scalar
    (model_flowposenet.py:20-59)."""
    total = 0.0
    weight = 1.0
    for disp in disps[:max_scales]:
        im = resize_area(img, (disp.shape[1], disp.shape[2]))
        wx = torch.exp(-(im[:, :-1] - im[:, 1:]).abs().mean(-1, keepdim=True))
        wy = torch.exp(-(im[:, :, :-1] - im[:, :, 1:]).abs().mean(-1, keepdim=True))
        sx = (disp[:, :-1] - disp[:, 1:]).abs() * wx
        sy = (disp[:, :, :-1] - disp[:, :, 1:]).abs() * wy
        total = total + (sx.float().mean() + sy.float().mean()) * weight
        weight /= 4.0
    return total


class FlowPoseModel(nn.Module):
    """Frozen flow nets, ``FlowPoseNet`` and a single-scale depth net, under
    ``JointModel``'s sub-module names (``fpyramid``, ``pwc_model``,
    ``depth_net``) and the reference's ``flow_pose_net``."""

    def __init__(self, dtype=torch.float32, ssim_impl: str = "pallas"):
        super().__init__()
        ssim_route(ssim_impl, "cpu")  # validates the name
        self.dtype = dtype
        self.ssim_impl = ssim_impl
        self.fpyramid = FeaturePyramid(dtype=dtype)
        self.pwc_model = PWCDecoder(dtype=dtype)
        self.flow_pose_net = FlowPoseNet(dtype=dtype)
        self.depth_net = DepthNet(num_scales=1, dtype=dtype)

    def _flow(self, img1, img2):
        hw = (img1.shape[1], img1.shape[2])
        with torch.no_grad():
            return self.pwc_model(self.fpyramid(img1), self.fpyramid(img2), hw)[0]

    def _pose(self, flow, hw):
        wdiv = torch.tensor([hw[1], hw[0]], dtype=flow.dtype, device=flow.device)
        return self.flow_pose_net(flow / wdiv)

    # The inference methods run in eval mode and without autograd, whatever
    # mode the model is in; the modules' modes are restored after. Inputs
    # are float NHWC frames in [0, 1].
    def inference_flow(self, img1, img2):
        """Full-resolution forward flow [B,H,W,2], f32."""
        with module_mode(self, False), torch.no_grad():
            return self._flow(img1.to(self.dtype), img2.to(self.dtype)).float()

    def infer_pose(self, img1, img2):
        """[B,6] pose from the image-size-normalized flow
        (model_flowposenet.py:124-130)."""
        with module_mode(self, False), torch.no_grad():
            img1, img2 = img1.to(self.dtype), img2.to(self.dtype)
            return self._pose(self._flow(img1, img2), img1.shape[1:3]).float()

    def infer_depth(self, img):
        """The full-resolution sigmoid disparity [B,H,W,1] (the JAX
        ``infer_depth``), f32."""
        with module_mode(self, False), torch.no_grad():
            return self.depth_net(img.to(self.dtype))[0].float()

    def forward_train(self, images, K_ms, K_inv_ms, train: bool = True):
        """Pairwise SC-SfMLearner loss pack (dict of [B] vectors) on a
        two-frame stack [B,2H,W,3] of float frames; ``K_ms`` [B,S,3,3] (scale
        0 is used). ``train`` runs the depth net's BatchNorm on batch
        statistics, one call a frame, each updating the running statistics
        in turn (the JAX ``depth_net(img, train)`` twice)."""
        del K_inv_ms
        K = K_ms[:, 0]
        h = images.shape[1] // 2
        img1 = images[:, :h].to(self.dtype)
        img2 = images[:, h:].to(self.dtype)
        with module_mode(self.depth_net, train):
            disp1 = self.depth_net(img1)
            disp2 = self.depth_net(img2)
        pose12 = self._pose(self._flow(img1, img2), (h, images.shape[2]))
        rec, geo = pairwise_loss(img1, img2, disp1[0], disp2[0], pose12, K, self.ssim_impl)
        smooth = edge_aware_smoothness(disp1, img1) + edge_aware_smoothness(disp2, img2)
        return {
            "loss_depth_pixel": rec,
            "loss_depth_consis": geo,
            "loss_depth_smooth": smooth.expand(rec.shape),
        }
