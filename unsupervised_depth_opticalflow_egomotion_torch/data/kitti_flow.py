"""KITTI flow 2012/2015 evaluation datasets.

The port's own copy of the JAX package's ``data/kitti_flow.py``.
Mirrors the reference's core/dataset/kitti_2012.py / kitti_2015.py: image
pairs ``image_2/{i:06d}_10.png`` / ``_11.png`` stacked vertically, resized to
the training resolution, no flip; intrinsics from the per-frame calib file
(P_rect_02 / P2), rescaled.
"""

from __future__ import annotations

import os

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

from ..evaluation.calib import get_scaled_intrinsic_matrix
from .loader import rescale_intrinsics


class KittiFlowEval:
    """Iterable of (stacked pair image [2H,W,3], K, K_inv) numpy samples."""

    def __init__(self, data_dir: str, mode: str = "kitti_2015", img_hw=(256, 832)):
        self.data_dir = data_dir
        self.img_hw = tuple(img_hw)
        self.num_total = 194 if mode == "kitti_2012" else 200

    def __len__(self):
        return self.num_total

    def __getitem__(self, idx: int):
        name = str(idx).zfill(6)
        img1 = cv2.imread(os.path.join(self.data_dir, "image_2", name + "_10.png"))
        img2 = cv2.imread(os.path.join(self.data_dir, "image_2", name + "_11.png"))
        hw_orig = (img1.shape[0], img1.shape[1])
        h, w = self.img_hw
        img1 = cv2.resize(img1, (w, h)) / 255.0
        img2 = cv2.resize(img2, (w, h)) / 255.0
        img = np.concatenate([img1, img2], axis=0).astype(np.float32)

        calib = os.path.join(self.data_dir, "calib_cam_to_cam", name + ".txt")
        if os.path.isfile(calib):
            K = get_scaled_intrinsic_matrix(calib, 1.0, 1.0)
            K = rescale_intrinsics(K, hw_orig, self.img_hw).astype(np.float32)
        else:
            K = np.eye(3, dtype=np.float32)
        return img, K, np.linalg.inv(K).astype(np.float32)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
