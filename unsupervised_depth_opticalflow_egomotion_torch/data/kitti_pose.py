"""KITTI odometry pose-eval snippets.

The port's own copy of the JAX package's ``data/kitti_pose.py``.
Mirrors the reference's core/dataset/kitti_pose.py: for each sequence, yields
3-frame snippets with ground-truth poses compensated to the first frame.
"""

from __future__ import annotations

import glob
import os

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


class KittiPoseEval:
    def __init__(self, root: str, sequences=("09",), seq_length: int = 3, step: int = 1):
        self.root = root
        self.seq_length = seq_length
        self.samples = []
        demi = (seq_length - 1) // 2
        shift = np.arange(-demi, demi + 1) * step
        for seq in sequences:
            seq_dir = os.path.join(root, "sequences", seq)
            poses = np.genfromtxt(os.path.join(root, "poses", f"{seq}.txt")).astype(
                np.float64
            ).reshape(-1, 3, 4)
            imgs = sorted(glob.glob(os.path.join(seq_dir, "image_2", "*.png")))
            for tgt in range(demi, len(imgs) - demi):
                idxs = shift + tgt
                self.samples.append(
                    {"imgs": [imgs[i] for i in idxs], "poses": poses[idxs]}
                )

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i: int):
        s = self.samples[i]
        imgs = [cv2.imread(p).astype(np.float32) for p in s["imgs"]]
        poses = s["poses"].copy()
        first = poses[0]
        poses[:, :, -1] -= first[:, -1]
        compensated = np.linalg.inv(first[:, :3]) @ poses
        return {"imgs": imgs, "poses": compensated}

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
