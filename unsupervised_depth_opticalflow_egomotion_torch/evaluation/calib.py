"""KITTI calibration parsing (host-side numpy).

The port's own copy of the JAX package's ``evaluation/calib.py``; mirrors
the reference's core/evaluation/evaluate_flow.py:9-51.
"""

from __future__ import annotations

import numpy as np


def read_raw_calib_file(filepath: str) -> dict:
    data = {}
    with open(filepath) as f:
        for line in f.readlines():
            key, value = line.split(":", 1)
            try:
                data[key] = np.array([float(x) for x in value.split()])
            except ValueError:
                pass
    return data


def load_intrinsics_raw(calib_file: str) -> np.ndarray:
    filedata = read_raw_calib_file(calib_file)
    P_rect = filedata["P_rect_02"] if "P_rect_02" in filedata else filedata["P2"]
    return np.reshape(P_rect, (3, 4))[:3, :3]


def scale_intrinsics(mat: np.ndarray, sx: float, sy: float) -> np.ndarray:
    out = np.copy(mat)
    out[0, 0] *= sx
    out[0, 2] *= sx
    out[1, 1] *= sy
    out[1, 2] *= sy
    return out


def get_scaled_intrinsic_matrix(calib_file: str, zoom_x: float, zoom_y: float) -> np.ndarray:
    intrinsics = scale_intrinsics(load_intrinsics_raw(calib_file), zoom_x, zoom_y)
    intrinsics[0, 1] = 0.0
    intrinsics[1, 0] = 0.0
    intrinsics[2, 0] = 0.0
    intrinsics[2, 1] = 0.0
    return intrinsics
