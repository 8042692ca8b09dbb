"""Offline KITTI preparation: 3-frame vertical stacks + train.txt index.

The port's own copy of the JAX package's ``data/kitti_prep.py``. Host-side
re-design of the reference's core/dataset/kitti_raw.py and kitti_odo.py: a
process pool fans out over drive folders, each worker writes vertically
concatenated 3-frame PNGs and a per-folder index that is merged at the end; calibration files are copied alongside. Static frames and eigen test
scenes are skipped for the raw split (kitti_raw.py:56-74).

Deliberate fix vs the reference: odometry prep also writes *3-frame* stacks
(the reference writes 2-frame stacks there, kitti_odo.py:22-26, which its own
training loader then mis-splits into thirds -- a latent bug).
"""

from __future__ import annotations

import os
import shutil
from concurrent.futures import ProcessPoolExecutor

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def _imread(path):
    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return img


def _imwrite(path, img):
    cv2.imwrite(path, img)


def _process_raw_folder(args):
    folder, static_ids, data_dir, output_dir, stride = args
    image_path = os.path.join(data_dir, folder, "image_02/data")
    dump_path = os.path.join(output_dir, folder)
    os.makedirs(dump_path, exist_ok=True)
    lines = []
    frames = sorted(f for f in os.listdir(image_path) if f.endswith(".png"))
    date = folder.split("/")[0]
    for n in range(len(frames) - 2 * stride):
        ids = [n, n + stride, n + 2 * stride]
        if any("%.10d" % i in static_ids for i in ids):
            continue
        imgs = [_imread(os.path.join(image_path, "%.10d.png" % i)) for i in ids]
        stacked = np.concatenate(imgs, axis=0)
        out_name = "%.10d.png" % n
        _imwrite(os.path.join(dump_path, out_name), stacked)
        lines.append(
            "%s %s\n"
            % (os.path.join(folder, out_name), os.path.join(date, "calib_cam_to_cam.txt"))
        )
    with open(os.path.join(dump_path, "train.txt"), "w") as f:
        f.writelines(lines)
    return folder, len(lines)


class KittiRawPrep:
    """Training-data preparation for the KITTI raw (eigen) split."""

    def __init__(self, data_dir: str, static_frames_txt: str, test_scenes_txt: str):
        self.data_dir = data_dir
        self.static_frames_txt = static_frames_txt
        self.test_scenes_txt = test_scenes_txt

    def collect_static_frames(self) -> dict[str, list[str]]:
        static: dict[str, list[str]] = {}
        with open(self.static_frames_txt) as f:
            for line in f:
                date, drive, frame_id = line.strip().split(" ")
                static.setdefault(os.path.join(date, drive), []).append(
                    "%.10d" % int(frame_id)
                )
        return static

    def collect_test_scenes(self) -> list[str]:
        with open(self.test_scenes_txt) as f:
            return [line.strip() for line in f]

    def prepare(self, output_dir: str, stride: int = 1, num_workers: int = 8) -> str:
        """Idempotent: skips work if train.txt already exists."""
        index = os.path.join(output_dir, "train.txt")
        if os.path.isfile(index):
            return index
        os.makedirs(output_dir, exist_ok=True)
        static_frames = self.collect_static_frames()
        test_scenes = self.collect_test_scenes()

        jobs = []
        for date in sorted(os.listdir(self.data_dir)):
            date_dir = os.path.join(self.data_dir, date)
            if not os.path.isdir(date_dir):
                continue
            for drive in sorted(os.listdir(date_dir)):
                folder = os.path.join(date, drive)
                if not os.path.isdir(os.path.join(date_dir, drive)):
                    continue
                # drive name sans "_sync" suffix vs test scene list
                if drive[:-5] in test_scenes:
                    continue
                jobs.append(
                    (folder, static_frames.get(folder, []), self.data_dir, output_dir, stride)
                )

        with ProcessPoolExecutor(max_workers=num_workers) as pool:
            results = list(pool.map(_process_raw_folder, jobs))

        with open(index, "w") as out:
            for folder, _count in results:
                sub = os.path.join(output_dir, folder, "train.txt")
                with open(sub) as f:
                    out.write(f.read())

        for date in sorted(os.listdir(self.data_dir)):
            calib = os.path.join(self.data_dir, date, "calib_cam_to_cam.txt")
            if os.path.isfile(calib):
                os.makedirs(os.path.join(output_dir, date), exist_ok=True)
                shutil.copy(calib, os.path.join(output_dir, date, "calib_cam_to_cam.txt"))
        return index


def _process_odo_folder(args):
    seq, data_dir, output_dir, stride = args
    image_path = os.path.join(data_dir, "sequences", seq, "image_2")
    if not os.path.isdir(image_path):
        image_path = os.path.join(data_dir, seq, "image_2")
    dump_path = os.path.join(output_dir, seq)
    os.makedirs(dump_path, exist_ok=True)
    frames = sorted(f for f in os.listdir(image_path) if f.endswith(".png"))
    lines = []
    for n in range(len(frames) - 2 * stride):
        ids = [n, n + stride, n + 2 * stride]
        imgs = [_imread(os.path.join(image_path, "%.6d.png" % i)) for i in ids]
        stacked = np.concatenate(imgs, axis=0)
        out_name = "%.6d.png" % n
        _imwrite(os.path.join(dump_path, out_name), stacked)
        lines.append("%s %s\n" % (os.path.join(seq, out_name), os.path.join(seq, "calib.txt")))
    with open(os.path.join(dump_path, "train.txt"), "w") as f:
        f.writelines(lines)
    # copy calib
    for cand in (
        os.path.join(data_dir, "sequences", seq, "calib.txt"),
        os.path.join(data_dir, seq, "calib.txt"),
    ):
        if os.path.isfile(cand):
            shutil.copy(cand, os.path.join(dump_path, "calib.txt"))
            break
    return seq, len(lines)


class KittiOdoPrep:
    """Training-data preparation for KITTI odometry sequences 00-08."""

    TRAIN_SEQS = ("00", "01", "02", "03", "04", "05", "06", "07", "08")

    def __init__(self, data_dir: str, sequences=TRAIN_SEQS):
        self.data_dir = data_dir
        self.sequences = sequences

    def prepare(self, output_dir: str, stride: int = 1, num_workers: int = 8) -> str:
        index = os.path.join(output_dir, "train.txt")
        if os.path.isfile(index):
            return index
        os.makedirs(output_dir, exist_ok=True)
        jobs = [(s, self.data_dir, output_dir, stride) for s in self.sequences]
        with ProcessPoolExecutor(max_workers=num_workers) as pool:
            results = list(pool.map(_process_odo_folder, jobs))
        with open(index, "w") as out:
            for seq, _count in results:
                with open(os.path.join(output_dir, seq, "train.txt")) as f:
                    out.write(f.read())
        return index
