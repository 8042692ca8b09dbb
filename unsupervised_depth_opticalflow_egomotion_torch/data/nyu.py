"""NYUv2 training-data preparation (``dataset: nyu``) and depth evaluation.

The port's own copy of the JAX package's ``data/nyu.py``.
The reference imports ``nyu_v2.py`` (core/dataset/__init__.py:7,
train.py:111-121) but the file is absent from its repository, so this module
supplies the prep: 3-frame vertical stacks from per-scene frame dirs with a
stride (the reference calls prepare_data_mp(..., stride=10)), in the
train.txt format the shared ``KittiPreparedDataset`` reads. NYU has
constant intrinsics; a synthetic calib line is written per scene. The depth
evaluation reads the labeled test split (``load_nyu_test_data``) and scores
it with the log10 metrics (``test_nyu_depth``).
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


def load_nyu_test_data(data_dir: str):
    """(images [N,3,H,W], depths [N,H,W]) from the labeled NYU test split
    (test.py:210-218)."""
    import h5py
    import scipy.io as sio

    data = h5py.File(os.path.join(data_dir, "nyu_depth_v2_labeled.mat"), "r")
    splits = sio.loadmat(os.path.join(data_dir, "splits.mat"))
    test = np.array(splits["testNdxs"]).squeeze(1)
    images = np.transpose(data["images"], [0, 1, 3, 2])
    depths = np.transpose(data["depths"], [0, 2, 1])
    return images[test - 1], depths[test - 1]


def test_nyu_depth(cfg, disp_fn, test_images, test_gt_depths, batch_size: int = 8):
    """NYU depth eval: center crop, resize, infer, score with log10 metrics
    (test.py:220-250). ``disp_fn`` maps a float32 numpy batch [b,H,W,3] to
    the sigmoid disparity [b,H,W,1] (``eval_tasks.make_inference_fns``)."""
    from ..evaluation import eval_depth

    crop_imgs, crop_depths = [], []
    for i in range(test_images.shape[0]):
        crop_imgs.append(test_images[i][:, 45:472, 41:602])
        crop_depths.append(test_gt_depths[i][45:472, 41:602])

    h, w = cfg.img_hw
    disps = []
    for i0 in range(0, len(crop_imgs), batch_size):
        group = crop_imgs[i0 : i0 + batch_size]
        batch = np.stack(
            [
                cv2.resize(np.transpose(im, [1, 2, 0]).astype(np.float32), (w, h)) / 255.0
                for im in group
            ]
        )
        sigma = np.asarray(disp_fn(batch))[..., 0]
        # sigma trains as depth; the reference scores 1/resize(infer_depth)
        # = affine(sigma) (test.py:197-206,236) -- see eval_tasks.test_eigen_depth
        d = 1.0 / (0.01 + (10.0 - 0.01) * sigma)
        disps.extend(d[i] for i in range(d.shape[0]))

    pred_depths = []
    for disp, gt in zip(disps, crop_depths):
        gh, gw = gt.shape
        pred_depths.append(1.0 / cv2.resize(disp, (gw, gh)))
    return eval_depth(crop_depths, pred_depths, nyu=True)
