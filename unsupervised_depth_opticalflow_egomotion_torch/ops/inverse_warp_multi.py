"""Multi-scale depth/pose reconstruction of the centre frame with the
dynamic-region masks (port of ``ops/inverse_warp_multi.py``)."""

from __future__ import annotations

import torch

from .geometry import rigid_projection
from .interp import resize_area
from .masks import abs_, flow_norm
from .warp import grid_sample


def _scale_K(intrinsics, downscale):
    return torch.cat([intrinsics[:, 0:2] / downscale, intrinsics[:, 2:]], dim=1)


def multiscale_recon_dynamic(
    ref_img, intrinsics, depths, pose, flows, alpha: float, beta: float,
    ref_img_u8=None,
):
    """Reconstruction + dynamic-region masks from ONE projection per scale.

    Per scale: area-resize the source, project (depth, pose, K/2^s) once,
    gather the source at the projected coords (the warp-gather kernel: the
    source is a camera frame), and compare the rigid flow with the predicted
    flow: bound = alpha*(|f|^2+|r|^2)+beta, mask = |f-r|^2 < bound and
    score = 1/(1e-4+|f-r|), both detached. ``ref_img_u8`` is the raw uint8
    full-resolution source, gathered at scale 0 with 1/255 folded in.

    Returns (recs, valids, cdepths, flow_diffs, dyn_masks, scores).
    """
    h0 = ref_img.shape[1]
    recs, valids, cdepths = [], [], []
    flow_diffs, dyn_masks, scores = [], [], []
    for depth, flow in zip(depths, flows):
        h, w = depth.shape[1], depth.shape[2]
        ref_scaled = resize_area(ref_img, (h, w))
        coords, valid, cdepth, rigid = rigid_projection(
            depth, pose, _scale_K(intrinsics, h0 / h)
        )
        if h == h0 and ref_img_u8 is not None:
            recs.append(grid_sample(ref_img_u8, coords, out_dtype=ref_img.dtype))
        else:
            recs.append(grid_sample(ref_scaled, coords, src_is_data=True))
        valids.append(valid.to(ref_scaled.dtype))
        cdepths.append(cdepth)

        bound = alpha * (flow_norm(flow) ** 2 + flow_norm(rigid) ** 2) + beta
        diff = abs_(rigid - flow)
        dn = flow_norm(diff)
        flow_diffs.append(diff)
        dyn_masks.append((dn**2 < bound).to(flow.dtype).detach())
        scores.append((1.0 / (1e-4 + dn)).detach())
    return recs, valids, cdepths, flow_diffs, dyn_masks, scores
