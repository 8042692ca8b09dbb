"""Motion-mask segmentation metrics + KITTI-2015 object-map GT loading.

The port's own copy of the JAX package's ``evaluation/mask_metrics.py``.
Mirrors the reference's core/evaluation/evaluate_mask.py (itself adapted from
py_img_seg_eval): pixel accuracy, mean accuracy, mean IU, frequency-weighted
IU, computed here with vectorized confusion counts instead of per-class
python loops. The GT loading pool spawns its workers, as
``flow_metrics.load_gt_flow_kitti`` does and for its reason.
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


def _read_mask_gt_worker(gt_dataset_dir: str, idx: int):
    m = cv2.imread(
        os.path.join(gt_dataset_dir, "obj_map", str(idx).zfill(6) + "_10.png"), -1
    )
    return m


def load_gt_mask(gt_dataset_dir: str, num_gt: int = 200, num_workers: int = 5):
    """Binary moving-object masks for KITTI-2015 (evaluate_mask.py:195-213)."""
    fun = functools.partial(_read_mask_gt_worker, gt_dataset_dir)
    with ProcessPoolExecutor(num_workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        results = list(pool.map(fun, range(num_gt), chunksize=10))
    gt_masks = []
    for m in results:
        m = m.astype(np.float64)
        m[m > 0.0] = 1.0
        gt_masks.append(m)
    return gt_masks


def _confusion(pred: np.ndarray, gt: np.ndarray):
    """Per-class intersection/support counts over the union of classes."""
    classes = np.union1d(np.unique(pred), np.unique(gt))
    n_ii = np.array([np.sum((pred == c) & (gt == c)) for c in classes], np.float64)
    t_i = np.array([np.sum(gt == c) for c in classes], np.float64)
    p_i = np.array([np.sum(pred == c) for c in classes], np.float64)
    gt_classes = np.array([c in np.unique(gt) for c in classes])
    return classes, n_ii, t_i, p_i, gt_classes


def pixel_accuracy(pred: np.ndarray, gt: np.ndarray) -> float:
    _, n_ii, t_i, _, in_gt = _confusion(pred, gt)
    denom = t_i[in_gt].sum()
    return float(n_ii[in_gt].sum() / denom) if denom else 0.0


def mean_accuracy(pred: np.ndarray, gt: np.ndarray) -> float:
    _, n_ii, t_i, _, in_gt = _confusion(pred, gt)
    acc = np.where(t_i[in_gt] > 0, n_ii[in_gt] / np.maximum(t_i[in_gt], 1), 0.0)
    return float(np.mean(acc)) if acc.size else 0.0


def mean_IU(pred: np.ndarray, gt: np.ndarray):
    _, n_ii, t_i, p_i, in_gt = _confusion(pred, gt)
    union = t_i + p_i - n_ii
    iu = np.where(union > 0, n_ii / np.maximum(union, 1), 0.0)
    iu_gt = iu[in_gt]
    return (float(np.mean(iu_gt)) if iu_gt.size else 0.0), iu


def frequency_weighted_IU(pred: np.ndarray, gt: np.ndarray) -> float:
    _, n_ii, t_i, p_i, in_gt = _confusion(pred, gt)
    union = t_i + p_i - n_ii
    iu = np.where(union > 0, n_ii / np.maximum(union, 1), 0.0)
    total = t_i[in_gt].sum()
    if not total:
        return 0.0
    return float(np.sum(t_i[in_gt] * iu[in_gt]) / total)


def eval_mask(pred_masks, gt_masks):
    """Average segmentation metrics of predicted motion masks vs GT.

    pred_masks are float maps at any resolution; each is bilinearly resized to
    the GT size and thresholded at 0.5 (evaluate_mask.py:216-252).
    Returns (pixel_acc, mean_acc, mean_iu, fw_iu).
    """
    pa = ma = miu = fwiu = 0.0
    n = len(gt_masks)
    for pred, gt in zip(pred_masks, gt_masks):
        H, W = gt.shape[:2]
        p = cv2.resize(pred.astype(np.float32), (W, H), interpolation=cv2.INTER_LINEAR)
        p = (p >= 0.5).astype(np.float64)
        pa += pixel_accuracy(p, gt)
        ma += mean_accuracy(p, gt)
        miu += mean_IU(p, gt)[0]
        fwiu += frequency_weighted_IU(p, gt)
    return pa / n, ma / n, miu / n, fwiu / n
