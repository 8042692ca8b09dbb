"""Export eigen-split ground-truth depth maps from KITTI velodyne scans.

Produces the ``gt_depths.npz`` consumed by the depth eval harness
(eval_tasks.test_eigen_depth), with the standard eigen protocol (role of
the reference's data/eigen/export_gt_depth.py; the port's own copy of the
JAX package's ``data/export_gt_depth.py``): project each test frame's
velodyne points through the rectified cam2 chain, keep points in front of the
camera, z-buffer duplicates to the minimum depth.

Run:
    python -m unsupervised_depth_opticalflow_egomotion_torch.data.export_gt_depth \
        --raw_dir /data/kitti/kitti_raw --split_file ./data/eigen/test_files.txt \
        --out ./data/eigen/gt_depths.npz
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def read_calib_file(path: str) -> dict:
    data = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, value = line.split(":", 1)
            try:
                data[key.strip()] = np.array([float(x) for x in value.split()])
            except ValueError:
                pass
    return data


def load_velodyne_points(path: str) -> np.ndarray:
    points = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    points[:, 3] = 1.0  # homogeneous
    return points


def velo_to_depth_map(velo: np.ndarray, cam2cam: dict, velo2cam_d: dict, im_shape):
    """Project velodyne points -> sparse depth map for rectified cam 2."""
    # velodyne -> unrectified cam0
    velo2cam = np.hstack(
        [velo2cam_d["R"].reshape(3, 3), velo2cam_d["T"].reshape(3, 1)]
    )
    velo2cam = np.vstack([velo2cam, [0, 0, 0, 1]])
    # rectification + projection for cam2
    R_rect = np.eye(4)
    R_rect[:3, :3] = cam2cam["R_rect_00"].reshape(3, 3)
    P_rect = cam2cam["P_rect_02"].reshape(3, 4)
    P_velo2im = P_rect @ R_rect @ velo2cam

    velo = velo[velo[:, 0] >= 0, :]  # points in front of the car
    pts2d = (P_velo2im @ velo.T).T
    depth = pts2d[:, 2]
    pts2d = pts2d[:, :2] / depth[:, None]

    h, w = im_shape
    # round to pixel (KITTI convention: 1-based minus 1)
    u = np.round(pts2d[:, 0]) - 1
    v = np.round(pts2d[:, 1]) - 1
    valid = (u >= 0) & (u < w) & (v >= 0) & (v < h) & (depth > 0)
    u, v, depth = u[valid].astype(int), v[valid].astype(int), depth[valid]

    depth_map = np.zeros((h, w), np.float32)
    # z-buffer: keep the nearest point per pixel
    order = np.argsort(-depth)  # far first, near overwrites
    depth_map[v[order], u[order]] = depth[order]
    return depth_map


def export(raw_dir: str, split_file: str, out_path: str):
    with open(split_file) as f:
        lines = [l.strip().split(" ") for l in f if l.strip()]
    depths = []
    for parts in lines:
        folder, frame_id = parts[0], parts[1]
        date = folder.split("/")[0]
        calib_dir = os.path.join(raw_dir, date)
        cam2cam = read_calib_file(os.path.join(calib_dir, "calib_cam_to_cam.txt"))
        velo2cam = read_calib_file(os.path.join(calib_dir, "calib_velo_to_cam.txt"))
        velo_path = os.path.join(
            raw_dir, folder, "velodyne_points", "data", f"{int(frame_id):010d}.bin"
        )
        im_shape = (
            int(cam2cam["S_rect_02"][1]),
            int(cam2cam["S_rect_02"][0]),
        )
        velo = load_velodyne_points(velo_path)
        depths.append(velo_to_depth_map(velo, cam2cam, velo2cam, im_shape))
    np.savez_compressed(out_path, data=np.array(depths, dtype=object))
    print(f"wrote {len(depths)} depth maps to {out_path}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--raw_dir", required=True)
    ap.add_argument("--split_file", default="./data/eigen/test_files.txt")
    ap.add_argument("--out", default="./data/eigen/gt_depths.npz")
    args = ap.parse_args()
    export(args.raw_dir, args.split_file, args.out)
