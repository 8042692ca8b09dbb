"""KITTI flow benchmark metrics: EPE (all/noc/occ/move/static) + Fl rates.

The port's own copy of the JAX package's ``evaluation/flow_metrics.py``.
Mirrors the reference's core/evaluation/evaluate_flow.py:53-174, with the GT
loading fan-out on a process pool. The pool's workers are spawned, not
forked: the caller may already hold a CUDA context and loader threads
(the training CLI's interleaved eval), which a forked child would inherit
half-copied. They read PNGs and touch neither.
"""

from __future__ import annotations

import functools
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

from .flow_io import read_flow_png


def _read_flow_gt_worker(dir_gt: str, i: int):
    flow_true = read_flow_png(os.path.join(dir_gt, "flow_occ", str(i).zfill(6) + "_10.png"))
    flow_noc = read_flow_png(os.path.join(dir_gt, "flow_noc", str(i).zfill(6) + "_10.png"))
    return flow_true, flow_noc[:, :, 2]


def load_gt_flow_kitti(gt_dataset_dir: str, mode: str, num_workers: int = 5):
    """Load (gt_flows, noc_masks) lists for kitti_2012 (194) or kitti_2015 (200)."""
    if mode == "kitti_2012":
        num_gt = 194
    elif mode == "kitti_2015":
        num_gt = 200
    else:
        raise ValueError(f"Mode {mode} not found.")
    fun = functools.partial(_read_flow_gt_worker, gt_dataset_dir)
    with ProcessPoolExecutor(num_workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        results = list(pool.map(fun, range(num_gt), chunksize=10))
    gt_flows = [r[0] for r in results]
    noc_masks = [r[1] for r in results]
    return gt_flows, noc_masks


def calculate_error_rate(epe_map, gt_flow, mask):
    """Fl outlier rate: EPE > 3px AND > 5% of GT magnitude."""
    bad = np.logical_and(
        epe_map * mask > 3,
        epe_map * mask / np.maximum(np.sqrt(np.sum(np.square(gt_flow), axis=2)), 1e-10)
        > 0.05,
    )
    return bad.sum() / mask.sum()


def eval_flow_avg(gt_flows, noc_masks, pred_flows, img_hw, moving_masks=None):
    """Average flow metrics over the benchmark.

    pred_flows are [h,w,2] at the training resolution ``img_hw``; each is
    value-rescaled and resized to the GT resolution before scoring
    (evaluate_flow.py:105-112). Returns a dict of metrics.
    """
    error = error_noc = error_occ = error_move = error_static = error_rate = 0.0
    error_move_rate = error_static_rate = 0.0
    num = len(gt_flows)

    for i, (gt_flow, noc_mask, pred_flow) in enumerate(
        zip(gt_flows, noc_masks, pred_flows)
    ):
        H, W = gt_flow.shape[0:2]
        pred = np.copy(pred_flow)
        pred[:, :, 0] = pred[:, :, 0] / img_hw[1] * W
        pred[:, :, 1] = pred[:, :, 1] / img_hw[0] * H
        flo_pred = cv2.resize(pred, (W, H), interpolation=cv2.INTER_LINEAR)

        epe_map = np.sqrt(
            np.sum(np.square(flo_pred[:, :, 0:2] - gt_flow[:, :, 0:2]), axis=2)
        )
        valid = gt_flow[:, :, 2]
        error += np.sum(epe_map * valid) / np.sum(valid)
        error_noc += np.sum(epe_map * noc_mask) / np.sum(noc_mask)
        error_occ += np.sum(epe_map * (valid - noc_mask)) / max(
            np.sum(valid - noc_mask), 1.0
        )
        error_rate += calculate_error_rate(epe_map, gt_flow[:, :, 0:2], valid)

        if moving_masks is not None:
            move_mask = moving_masks[i]
            error_move_rate += calculate_error_rate(
                epe_map, gt_flow[:, :, 0:2], valid * move_mask
            )
            error_static_rate += calculate_error_rate(
                epe_map, gt_flow[:, :, 0:2], valid * (1.0 - move_mask)
            )
            error_move += np.sum(epe_map * valid * move_mask) / np.sum(valid * move_mask)
            error_static += np.sum(epe_map * valid * (1.0 - move_mask)) / np.sum(
                valid * (1.0 - move_mask)
            )

    metrics = {
        "epe": error / num,
        "epe_noc": error_noc / num,
        "epe_occ": error_occ / num,
        "fl": error_rate / num,
    }
    if moving_masks is not None:
        metrics.update(
            {
                "epe_move": error_move / num,
                "epe_static": error_static / num,
                "fl_move": error_move_rate / num,
                "fl_static": error_static_rate / num,
            }
        )
    return metrics


def format_flow_metrics(metrics: dict) -> str:
    keys = list(metrics)
    header = ", ".join(f"{k:>10}" for k in keys)
    vals = ", ".join(f"{metrics[k]:10.4f}" for k in keys)
    return header + "\n" + vals
