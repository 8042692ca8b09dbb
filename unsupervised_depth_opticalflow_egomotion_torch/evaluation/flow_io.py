"""Flow / disparity I/O and Middlebury flow colorization.

The port's own copy of the JAX package's ``evaluation/flow_io.py``.
Functional equivalents of the reference's core/evaluation/flowlib.py
(read_flow_png :107-128, write_flow_png :131-145, .flo read/write :63-106 +
:147-163, disparity I/O :332-376, flow_to_image :258-296,
compute_color/make_color_wheel :444-540), vectorized with cv2/numpy instead
of the row-by-row pypng loops.

KITTI PNG encoding: uint16 RGB with u = (R - 2^15)/64, v = (G - 2^15)/64,
valid = B. Middlebury .flo: f32 magic 202021.25, int32 (w, h), row-major
interleaved (u, v) f32. KITTI disparity PNG: uint16 single channel / 256.
"""

from __future__ import annotations

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

UNKNOWN_FLOW_THRESH = 1e7
FLO_MAGIC = 202021.25


def read_flo(filename: str) -> np.ndarray:
    """Read a Middlebury .flo file -> [H,W,2] float32 (flowlib.py:63-83)."""
    with open(filename, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != np.float32(FLO_MAGIC):
            raise ValueError(f"{filename}: invalid .flo magic {magic!r}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    if data.size != 2 * w * h:
        raise ValueError(f"{filename}: truncated .flo payload")
    return data.reshape(h, w, 2)


def write_flo(flow: np.ndarray, filename: str) -> None:
    """Write [H,W,2] flow as a Middlebury .flo file (flowlib.py:147-163)."""
    h, w = flow.shape[:2]
    with open(filename, "wb") as f:
        np.asarray([FLO_MAGIC], np.float32).tofile(f)
        np.asarray([w], np.int32).tofile(f)
        np.asarray([h], np.int32).tofile(f)
        np.ascontiguousarray(flow[..., :2], dtype=np.float32).tofile(f)


def read_disp_png(file_name: str) -> np.ndarray:
    """Read a KITTI 16-bit disparity PNG -> [H,W] float (flowlib.py:332-348)."""
    raw = cv2.imread(file_name, cv2.IMREAD_UNCHANGED)
    if raw is None:
        raise FileNotFoundError(file_name)
    if raw.ndim == 3:
        raw = raw[:, :, -1]  # cv2 loads BGR; channel 0 of the PNG is last
    return raw.astype(np.float64) / 256.0


def write_disp_png(disp: np.ndarray, file_name: str) -> None:
    """Write [H,W] disparity as a KITTI 16-bit PNG (disp * 256 as uint16)."""
    out = np.clip(np.asarray(disp, np.float64) * 256.0, 0, 2**16 - 1)
    cv2.imwrite(file_name, out.astype(np.uint16))


def disp_to_flowfile(disp: np.ndarray, filename: str) -> None:
    """Store a disparity map as a .flo file with v = 0 (flowlib.py:350-376)."""
    h, w = disp.shape[:2]
    data = np.dstack([disp.astype(np.float32), np.zeros((h, w), np.float32)])
    write_flo(data, filename)


def read_flow_png(flow_file: str) -> np.ndarray:
    """Read a KITTI flow PNG -> [H,W,3] float64 (u, v, valid)."""
    raw = cv2.imread(flow_file, cv2.IMREAD_UNCHANGED)
    if raw is None:
        raise FileNotFoundError(flow_file)
    rgb = raw[:, :, ::-1].astype(np.float64)  # cv2 loads BGR
    flow = np.zeros_like(rgb)
    flow[:, :, 2] = rgb[:, :, 2]
    invalid = rgb[:, :, 2] == 0
    flow[:, :, 0:2] = (rgb[:, :, 0:2] - 2**15) / 64.0
    flow[invalid, 0] = 0
    flow[invalid, 1] = 0
    return flow


def write_flow_png(path: str, flow_u: np.ndarray, flow_v: np.ndarray, valid=None):
    """Write (u, v) flow as a KITTI 16-bit submission PNG
    (core/visualize/flow_utils.py:51-79)."""
    h, w = flow_u.shape
    out = np.ones((h, w, 3), np.float64)
    out[:, :, 0] = np.clip(flow_u * 64.0 + 2**15, 0, 2**16 - 1)
    out[:, :, 1] = np.clip(flow_v * 64.0 + 2**15, 0, 2**16 - 1)
    if valid is not None:
        out[:, :, 2] = valid
    out16 = out.astype(np.uint16)
    cv2.imwrite(path, out16[:, :, ::-1])  # back to BGR for cv2


def make_color_wheel() -> np.ndarray:
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros([ncols, 3])
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(0, RY) / RY)
    col += RY
    wheel[col : col + YG, 0] = 255 - np.floor(255 * np.arange(0, YG) / YG)
    wheel[col : col + YG, 1] = 255
    col += YG
    wheel[col : col + GC, 1] = 255
    wheel[col : col + GC, 2] = np.floor(255 * np.arange(0, GC) / GC)
    col += GC
    wheel[col : col + CB, 1] = 255 - np.floor(255 * np.arange(0, CB) / CB)
    wheel[col : col + CB, 2] = 255
    col += CB
    wheel[col : col + BM, 2] = 255
    wheel[col : col + BM, 0] = np.floor(255 * np.arange(0, BM) / BM)
    col += BM
    wheel[col : col + MR, 2] = 255 - np.floor(255 * np.arange(0, MR) / MR)
    wheel[col : col + MR, 0] = 255
    return wheel


_WHEEL = make_color_wheel()


def compute_color(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    h, w = u.shape
    img = np.zeros([h, w, 3])
    nan_idx = np.isnan(u) | np.isnan(v)
    u = np.where(nan_idx, 0, u)
    v = np.where(nan_idx, 0, v)
    ncols = _WHEEL.shape[0]
    rad = np.sqrt(u**2 + v**2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1) + 1
    k0 = np.floor(fk).astype(int)
    k1 = k0 + 1
    k1[k1 == ncols + 1] = 1
    f = fk - k0
    for i in range(3):
        tmp = _WHEEL[:, i]
        col0 = tmp[k0 - 1] / 255
        col1 = tmp[k1 - 1] / 255
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] *= 0.75
        img[:, :, i] = np.uint8(np.floor(255 * col * (1 - nan_idx)))
    return img


def flow_to_image(flow: np.ndarray, verbose: bool = False) -> np.ndarray:
    """Flow [H,W,2+] -> Middlebury color image uint8 [H,W,3]."""
    u = flow[:, :, 0].copy()
    v = flow[:, :, 1].copy()
    unknown = (np.abs(u) > UNKNOWN_FLOW_THRESH) | (np.abs(v) > UNKNOWN_FLOW_THRESH)
    u[unknown] = 0
    v[unknown] = 0
    rad = np.sqrt(u**2 + v**2)
    maxrad = max(-1, np.max(rad))
    u = u / (maxrad + np.finfo(float).eps)
    v = v / (maxrad + np.finfo(float).eps)
    img = compute_color(u, v)
    img[np.repeat(unknown[:, :, None], 3, axis=2)] = 0
    return np.uint8(img)


def resize_flow(flow: np.ndarray, new_hw) -> np.ndarray:
    """Resize [H,W,2] flow with value rescaling
    (core/visualize/flow_utils.py:82-90)."""
    h, w = flow.shape[:2]
    nh, nw = new_hw
    out = cv2.resize(flow, (nw, nh), interpolation=cv2.INTER_LINEAR)
    out[:, :, 0] *= nw / w
    out[:, :, 1] *= nh / h
    return out
