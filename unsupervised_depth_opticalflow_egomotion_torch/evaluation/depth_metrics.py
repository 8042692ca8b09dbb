"""Eigen-protocol depth metrics (host-side numpy).

The port's own copy of the JAX package's ``evaluation/depth_metrics.py``.
Mirrors the reference's core/evaluation/evaluate_depth.py and
evaluation_utils.py: mask gt in (min_depth, max_depth), Garg crop (KITTI),
per-image median scaling, then AbsRel/SqRel/RMSE/RMSElog (log10 for NYU) and
threshold accuracies a1-a3.
"""

from __future__ import annotations

import numpy as np


def compute_errors(gt: np.ndarray, pred: np.ndarray, nyu: bool = False):
    thresh = np.maximum(gt / pred, pred / gt)
    a1 = (thresh < 1.25).mean()
    a2 = (thresh < 1.25**2).mean()
    a3 = (thresh < 1.25**3).mean()

    rmse = np.sqrt(((gt - pred) ** 2).mean())
    rmse_log = np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean())
    log10 = np.mean(np.abs(np.log10(gt) - np.log10(pred)))
    abs_rel = np.mean(np.abs(gt - pred) / gt)
    sq_rel = np.mean(((gt - pred) ** 2) / gt)

    second = log10 if nyu else rmse_log
    return abs_rel, sq_rel, rmse, second, a1, a2, a3


def eval_depth(gt_depths, pred_depths, min_depth=1e-3, max_depth=80, nyu=False):
    """Mean metrics over a list of (gt, pred) depth maps."""
    n = len(pred_depths)
    acc = np.zeros((n, 7), np.float64)
    for i in range(n):
        gt = gt_depths[i].astype(np.float64)
        pred = pred_depths[i].astype(np.float64)
        mask = np.logical_and(gt > min_depth, gt < max_depth)
        if not nyu:
            gh, gw = gt.shape
            crop = np.array(
                [0.40810811 * gh, 0.99189189 * gh, 0.03594771 * gw, 0.96405229 * gw]
            ).astype(np.int32)
            crop_mask = np.zeros_like(mask)
            crop_mask[crop[0] : crop[1], crop[2] : crop[3]] = 1
            mask = np.logical_and(mask, crop_mask)
        gt_m = gt[mask]
        pred_m = pred[mask]
        pred_m *= np.median(gt_m) / np.median(pred_m)
        pred_m = np.clip(pred_m, min_depth, max_depth)
        gt_m = np.clip(gt_m, min_depth, max_depth)
        acc[i] = compute_errors(gt_m, pred_m, nyu=nyu)
    means = acc.mean(0)
    return list(means)
