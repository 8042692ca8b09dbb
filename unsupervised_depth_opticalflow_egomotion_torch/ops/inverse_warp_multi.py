"""Multi-scale depth/pose reconstruction of the centre frame, alone
(``multiscale_reconstruction``, depth mode) and with the dynamic-region
masks (``multiscale_recon_dynamic``, geom mode); port of
``ops/inverse_warp_multi.py``."""

from __future__ import annotations

import torch

from .geometry import inverse_warp2, rigid_projection
from .interp import resize_area
from .masks import abs_, flow_norm
from .warp import DEFAULT_ROUTE, WarpRoute, grid_sample


def _scale_K(intrinsics, downscale):
    return torch.cat([intrinsics[:, 0:2] / downscale, intrinsics[:, 2:]], dim=1)


def multiscale_recon_dynamic(
    ref_img, intrinsics, depths, depths_ref, pose, flows, alpha: float, beta: float,
    sample_ref_depth: bool = False, ref_img_u8=None, route: WarpRoute = DEFAULT_ROUTE,
):
    """Reconstruction + dynamic-region masks from ONE projection per scale.

    Per scale: area-resize the source, project (depth, pose, K/2^s) once,
    gather the source at the projected coords (the warp-gather kernel: the
    source is a camera frame), and compare the rigid flow with the predicted
    flow: bound = alpha*(|f|^2+|r|^2)+beta, mask = |f-r|^2 < bound and
    score = 1/(1e-4+|f-r|), both detached. ``ref_img_u8`` is the raw uint8
    full-resolution source, gathered at scale 0 with 1/255 folded in. With
    ``sample_ref_depth`` the source depth ``depths_ref`` is sampled at the
    same coords (>= 1e-3): a one-channel network output, which needs a
    gradient to the source, so the plain sampler takes it while the frame
    stays on the kernel.

    Returns (recs, valids, pdepths, cdepths, flow_diffs, dyn_masks, scores);
    ``pdepths`` holds None per scale without ``sample_ref_depth``.
    """
    h0 = ref_img.shape[1]
    recs, valids, pdepths, cdepths = [], [], [], []
    flow_diffs, dyn_masks, scores = [], [], []
    for depth, depth_ref, flow in zip(depths, depths_ref, flows):
        h, w = depth.shape[1], depth.shape[2]
        ref_scaled = resize_area(ref_img, (h, w))
        coords, valid, cdepth, rigid = rigid_projection(
            depth, pose, _scale_K(intrinsics, h0 / h)
        )
        if h == h0 and ref_img_u8 is not None:
            recs.append(grid_sample(ref_img_u8, coords, out_dtype=ref_img.dtype, route=route))
        else:
            recs.append(grid_sample(ref_scaled, coords, src_is_data=True, route=route))
        pdepths.append(
            torch.clamp(grid_sample(depth_ref.to(ref_scaled.dtype), coords), min=1e-3)
            if sample_ref_depth
            else None
        )
        valids.append(valid.to(ref_scaled.dtype))
        cdepths.append(cdepth)

        bound = alpha * (flow_norm(flow) ** 2 + flow_norm(rigid) ** 2) + beta
        diff = abs_(rigid - flow)
        dn = flow_norm(diff)
        flow_diffs.append(diff)
        dyn_masks.append((dn**2 < bound).to(flow.dtype).detach())
        scores.append((1.0 / (1e-4 + dn)).detach())
    return recs, valids, pdepths, cdepths, flow_diffs, dyn_masks, scores


def multiscale_reconstruction(
    ref_img, intrinsics, depths, depths_ref, pose, sample_ref_depth: bool = True,
    route: WarpRoute = DEFAULT_ROUTE,
):
    """Reconstruct the target at every scale of the depth pyramid.

    ``ref_img`` [B,H,W,3] is the source frame, ``intrinsics`` [B,3,3] at full
    resolution, ``depths`` / ``depths_ref`` pyramids of [B,h,w,1] target /
    source depth, ``pose`` [B,6] target->source. Returns four pyramids
    (reconstructed_img, valid_mask, projected_depth, computed_depth).
    """
    h0 = ref_img.shape[1]
    recs, valids, pdepths, cdepths = [], [], [], []
    for depth, depth_ref in zip(depths, depths_ref):
        h, w = depth.shape[1], depth.shape[2]
        rec, valid, pdepth, cdepth = inverse_warp2(
            resize_area(ref_img, (h, w)), depth, depth_ref, pose,
            _scale_K(intrinsics, h0 / h), sample_ref_depth=sample_ref_depth, route=route,
        )
        recs.append(rec)
        valids.append(valid)
        pdepths.append(pdepth)
        cdepths.append(cdepth)
    return recs, valids, pdepths, cdepths
