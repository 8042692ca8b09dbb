"""Occlusion / texture / rigid mask computation over NHWC pyramids.

Port of the JAX package's ``ops/masks.py``; ``.detach()`` stands in for
``stop_gradient``.
"""

from __future__ import annotations

import torch

from .geometry import fundamental_from_pose
from .warp import pixel_grid


def abs_(x: torch.Tensor) -> torch.Tensor:
    """|x| with the JAX package's derivative at 0 (+1, jax.lax.abs's rule;
    torch.abs gives 0). Exact zeros do occur in the loss graph: second
    differences of a bilinearly upsampled flow, equal neighbours of an
    upsampled disparity."""
    return torch.where(x >= 0, x, -x)


def flow_norm(flow: torch.Tensor) -> torch.Tensor:
    """L2 norm over the flow channel + 1e-12 -> [B,H,W,1]."""
    return torch.sqrt((flow * flow).sum(-1, keepdim=True)) + 1e-12


def flow_normalization(flow: torch.Tensor) -> torch.Tensor:
    """Unit-norm flow, in f32 with the epsilon inside the radical (a finite
    gradient at an exactly-zero flow pixel)."""
    f32 = flow.float()
    n = torch.sqrt((f32 * f32).sum(-1, keepdim=True) + 1e-12)
    return (f32 / (n + 1e-12)).to(flow.dtype)


def all_zero(x: torch.Tensor) -> torch.Tensor:
    return (x == 0).all(dim=-1, keepdim=True)


def occlusion_weights(warped_from_l, imgs, warped_from_r):
    """Hard occlusion weights + validity masks from photometric diffs.

    Per scale: weight = 1 - softmax over the (left-diff, right-diff) pair,
    thresholded > 0.48 and detached; validity = any channel of the
    flow-warped image non-zero. Returns (weight_bwd, weight_fwd, valid_bwd,
    valid_fwd) pyramids of [B,H,W,1].
    """
    weight_bwd, weight_fwd, valid_bwd, valid_fwd = [], [], [], []
    for img_from_l, img, img_from_r in zip(warped_from_l, imgs, warped_from_r):
        valid_fwd.append(1.0 - all_zero(img_from_r).to(img.dtype))
        valid_bwd.append(1.0 - all_zero(img_from_l).to(img.dtype))
        diff_l = (img - img_from_l).abs().mean(-1, keepdim=True)
        diff_r = (img - img_from_r).abs().mean(-1, keepdim=True)
        weight = 1.0 - torch.softmax(torch.cat([diff_l, diff_r], -1), dim=-1)
        weight = (weight > 0.48).to(img.dtype).detach()
        weight_bwd.append(weight[..., 0:1])
        weight_fwd.append(weight[..., 1:2])
    return weight_bwd, weight_fwd, valid_bwd, valid_fwd


def diff_weights(warped_from_l, imgs, warped_from_r):
    """Soft occlusion weights of the reference's flow-only mode
    (``flow_occ_impl="diff_weights"``).

    weight = 2*exp(-(w-0.5)^2/0.03) * valid, where w = 1 - softmax over the
    (left-diff, right-diff) pair, detached. Returns (diff_bwd, diff_fwd,
    weight_bwd, weight_fwd) pyramids; the diffs are channel-mean photometric
    residuals and carry a gradient.
    """
    diff_bwd, diff_fwd, weight_bwd, weight_fwd = [], [], [], []
    for img_from_l, img, img_from_r in zip(warped_from_l, imgs, warped_from_r):
        valid_fwd = 1.0 - all_zero(img_from_r).to(img.dtype)
        valid_bwd = 1.0 - all_zero(img_from_l).to(img.dtype)
        diff_l = abs_(img - img_from_l).mean(-1, keepdim=True)
        diff_r = abs_(img - img_from_r).mean(-1, keepdim=True)
        weight = (1.0 - torch.softmax(torch.cat([diff_l, diff_r], -1), dim=-1)).detach()
        weight = 2.0 * torch.exp(-((weight - 0.5) ** 2) / 0.03)
        weight_bwd.append(weight[..., 0:1] * valid_bwd)
        weight_fwd.append(weight[..., 1:2] * valid_fwd)
        diff_bwd.append(diff_l)
        diff_fwd.append(diff_r)
    return diff_bwd, diff_fwd, weight_bwd, weight_fwd


def texture_masks(imgs, warped, sources):
    """1 where the warped image beats the unwarped source photometrically."""
    out = []
    for img, img_w, img_s in zip(imgs, warped, sources):
        m = (img - img_w).abs().mean(-1, keepdim=True) < (img - img_s).abs().mean(
            -1, keepdim=True
        )
        out.append(m.to(img.dtype))
    return out


def epipolar_map(pose_vec, flow, intrinsics, intrinsics_inv):
    """Per-pixel point-to-epipolar-line distance [B,H,W,1] (f32)."""
    del intrinsics
    b, h, w, _ = flow.shape
    flow = flow.float()
    grid = pixel_grid(h, w, device=flow.device)[None]
    f = fundamental_from_pose(pose_vec.float(), intrinsics_inv.float())
    ones = torch.ones((b, h, w, 1), device=flow.device)
    p1h = torch.cat([grid.expand(b, h, w, 2), ones], dim=-1)
    p2h = torch.cat([grid + flow, ones], dim=-1)
    epi_line = torch.einsum("bij,bhwj->bhwi", f, p1h)
    a, bb = epi_line[..., 0], epi_line[..., 1]
    dist_div = torch.sqrt(a * a + bb * bb) + 1e-6
    geom_dist = abs_((p2h * epi_line).sum(-1))
    return (geom_dist / dist_div)[..., None]


def rigid_masks(dist_map, rigid_thres: float = 0.5, inlier_thres: float = 0.1):
    """(rigid, inlier, score) masks from an epipolar distance map, detached."""
    rigid = (dist_map < rigid_thres).to(dist_map.dtype).detach()
    inlier = (dist_map < inlier_thres).to(dist_map.dtype).detach()
    score = (rigid / (1.0 + dist_map)).detach()
    return rigid, inlier, score


def fuse_masks(*mask_pyramids):
    """Elementwise product of any number of mask pyramids."""
    out = []
    for masks in zip(*mask_pyramids):
        m = masks[0]
        for other in masks[1:]:
            m = m * other
        out.append(m)
    return out
