"""Self-supervision losses over NHWC pyramids (port of ``ops/losses.py``).

Every function returns a per-batch-item vector [B] (sum over scales); the
train step weights and means them. Reductions run in f32.

The disparity smoothness uses the direct upsample-then-difference form
(the JAX package's ``_disp_smooth_naive``); the JAX package evaluates the
same sum in a folded form for the TPU's layout, and the two are equal
(tests/test_torch_ops.py holds this port against the folded form).
"""

from __future__ import annotations

import torch

from .interp import resize_bilinear
from .masks import abs_, flow_normalization
from .ssim import ssim


def _bmean(x: torch.Tensor) -> torch.Tensor:
    """Mean over all but the batch dim, in f32."""
    return x.float().mean(dim=(1, 2, 3))


def _sum_scales(per_scale) -> torch.Tensor:
    return torch.stack(per_scale, dim=1).sum(dim=1)


def photometric_loss(imgs, warped, masks) -> torch.Tensor:
    """Masked L1 photometric loss."""
    per_scale = []
    for img, img_w, mask in zip(imgs, warped, masks):
        divider = _bmean(mask)
        per_scale.append(_bmean(abs_(img - img_w) * mask) / (divider + 1e-12))
    return _sum_scales(per_scale)


def masked_diff_loss(diffs, masks) -> torch.Tensor:
    """Masked mean of precomputed residuals (the flow-only objective under
    ``flow_occ_impl="diff_weights"``)."""
    per_scale = []
    for diff, mask in zip(diffs, masks):
        divider = _bmean(mask)
        per_scale.append(_bmean(diff * mask) / (divider + 1e-12))
    return _sum_scales(per_scale)


def ssim_loss(imgs, warped, masks, impl: str = "xla") -> torch.Tensor:
    """Masked DSSIM: SSIM computed on mask-multiplied images."""
    per_scale = []
    for img, img_w, mask in zip(imgs, warped, masks):
        divider = _bmean(mask)
        s = ssim(img * mask, img_w * mask, impl)
        loss = torch.clamp((1.0 - s) / 2.0, 0.0, 1.0)
        per_scale.append(_bmean(loss) / (divider + 1e-12))
    return _sum_scales(per_scale)


def disp_smooth_loss(img, disps, normalize: bool = False) -> torch.Tensor:
    """Edge-aware first-order disparity smoothness at full image resolution.

    Each scale's disp is bilinearly upsampled to the image size before
    differencing. ``normalize`` divides each disp by its per-image spatial
    mean first (``Config.depth_smooth_norm``).
    """
    h, w = img.shape[1], img.shape[2]
    gx = (img[:, :, :-1] - img[:, :, 1:]).abs().mean(-1, keepdim=True)
    gy = (img[:, :-1] - img[:, 1:]).abs().mean(-1, keepdim=True)
    wx = torch.exp(-gx)
    wy = torch.exp(-gy)
    per_scale = []
    for disp in disps:
        if normalize:
            disp = disp / (disp.mean(dim=(1, 2, 3), keepdim=True) + 1e-7)
        d = resize_bilinear(disp, (h, w))
        dgx = abs_(d[:, :, :-1] - d[:, :, 1:]) * wx
        dgy = abs_(d[:, :-1] - d[:, 1:]) * wy
        per_scale.append(_bmean(dgx) + _bmean(dgy))
    return _sum_scales(per_scale)


def _grads(x):
    return x[:, :, 1:] - x[:, :, :-1], x[:, 1:] - x[:, :-1]


def flow_smooth_loss(flows, imgs) -> torch.Tensor:
    """Second-order edge-aware flow smoothness on flow/20."""
    per_scale = []
    for flow, img in zip(flows, imgs):
        f = flow / 20.0
        igx, igy = _grads(img)
        wx = torch.exp(-10.0 * igx.abs().mean(-1, keepdim=True))
        wy = torch.exp(-10.0 * igy.abs().mean(-1, keepdim=True))
        dx, dy = _grads(f)
        dx2, _ = _grads(dx)
        _, dy2 = _grads(dy)
        err = _bmean(wx[:, :, 1:] * abs_(dx2)) + _bmean(wy[:, 1:] * abs_(dy2))
        per_scale.append(err / 2.0)
    return _sum_scales(per_scale)


def flow_consis_loss(fwd_flows, bwd_flows, occ_masks) -> torch.Tensor:
    """Forward/backward consistency on normalized flows; the backward term is
    detached and the mask inverted (occluded regions drive it)."""
    per_scale = []
    for fwd, bwd, occ in zip(fwd_flows, bwd_flows, occ_masks):
        fwd_n = flow_normalization(fwd)
        bwd_n = flow_normalization(bwd).detach()
        mask = 1.0 - occ
        divider = _bmean(mask)
        per_scale.append(_bmean(abs_(fwd_n + bwd_n) * mask) / (divider + 1e-12))
    return _sum_scales(per_scale)


def depth_consis_loss(predicted_depths, computed_depths, masks) -> torch.Tensor:
    """Scale-consistent depth loss |c-p|/(c+p), clamped to [0, 1]."""
    per_scale = []
    for pred, comp, mask in zip(predicted_depths, computed_depths, masks):
        divider = _bmean(mask)
        diff = torch.clamp(abs_(comp - pred) / abs_(comp + pred), 0.0, 1.0)
        per_scale.append(_bmean(diff * mask) / (divider + 1e-12))
    return _sum_scales(per_scale)


def depth_flow_consis_loss(flow_diffs, masks, scales: int = 1) -> torch.Tensor:
    """|rigid_flow - flow| under a mask, top ``scales`` scales."""
    per_scale = []
    for s in range(scales):
        divider = _bmean(masks[s])
        per_scale.append(_bmean(flow_diffs[s] * masks[s]) / (divider + 1e-12))
    return _sum_scales(per_scale)


def epipolar_loss(dist_map, rigid_mask) -> torch.Tensor:
    """Unmasked mean epipolar distance (the reference computes the masked
    mean, then overwrites it with the unmasked one; reproduced)."""
    del rigid_mask
    return _bmean(dist_map)
