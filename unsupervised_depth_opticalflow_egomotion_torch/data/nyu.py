"""NYUv2 training-data preparation (``dataset: nyu``).

The port's own copy of ``NyuPrep`` from the JAX package's ``data/nyu.py``.
The reference imports ``nyu_v2.py`` (core/dataset/__init__.py:7,
train.py:111-121) but the file is absent from its repository, so this module
supplies the prep: 3-frame vertical stacks from per-scene frame dirs with a
stride (the reference calls prepare_data_mp(..., stride=10)), in the
train.txt format the shared ``KittiPreparedDataset`` reads. NYU has
constant intrinsics; a synthetic calib line is written per scene. The NYU
depth evaluation belongs to the eval slice and is not ported yet.
"""

from __future__ import annotations

import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

# standard NYUv2 RGB intrinsics (Silberman toolbox)
NYU_K = np.array(
    [[518.8579, 0.0, 325.5824], [0.0, 519.4696, 253.7362], [0.0, 0.0, 1.0]],
    np.float32,
)


def _write_calib(path: str) -> None:
    K = NYU_K
    vals = " ".join(
        str(v)
        for v in [K[0, 0], 0.0, K[0, 2], 0.0, 0.0, K[1, 1], K[1, 2], 0.0, 0.0, 0.0, 1.0, 0.0]
    )
    with open(path, "w") as f:
        f.write(f"P: {vals}\n")


def _process_scene(args):
    scene, data_dir, output_dir, stride = args
    frame_dir = os.path.join(data_dir, scene)
    frames = sorted(
        f for f in os.listdir(frame_dir) if f.endswith((".jpg", ".png", ".ppm"))
    )
    dump = os.path.join(output_dir, scene)
    os.makedirs(dump, exist_ok=True)
    _write_calib(os.path.join(dump, "calib.txt"))
    lines = []
    for n in range(0, len(frames) - 2 * stride):
        ids = [n, n + stride, n + 2 * stride]
        imgs = [cv2.imread(os.path.join(frame_dir, frames[i])) for i in ids]
        if any(im is None for im in imgs):
            continue
        stacked = np.concatenate(imgs, axis=0)
        name = f"{n:06d}.png"
        cv2.imwrite(os.path.join(dump, name), stacked)
        lines.append(f"{os.path.join(scene, name)} {os.path.join(scene, 'calib.txt')}\n")
    with open(os.path.join(dump, "train.txt"), "w") as f:
        f.writelines(lines)
    return scene, len(lines)


class NyuPrep:
    """3-frame stack preparation over NYU scene directories."""

    def __init__(self, data_dir: str, test_scenes=()):
        self.data_dir = data_dir
        self.test_scenes = set(test_scenes)

    def prepare(self, output_dir: str, stride: int = 10, num_workers: int = 8) -> str:
        index = os.path.join(output_dir, "train.txt")
        if os.path.isfile(index):
            return index
        os.makedirs(output_dir, exist_ok=True)
        scenes = [
            d
            for d in sorted(os.listdir(self.data_dir))
            if os.path.isdir(os.path.join(self.data_dir, d)) and d not in self.test_scenes
        ]
        jobs = [(s, self.data_dir, output_dir, stride) for s in scenes]
        with ProcessPoolExecutor(max_workers=num_workers) as pool:
            results = list(pool.map(_process_scene, jobs))
        with open(index, "w") as out:
            for scene, _n in results:
                with open(os.path.join(output_dir, scene, "train.txt")) as f:
                    out.write(f.read())
        return index
