"""Debug drawing: correspondences and epipolar lines on images.

The port's own copy of the JAX package's ``visualize/debug.py``: the
reference's Visualizer_debug helpers (core/visualize/visualizer.py:94-226)
that sanity-check the two-view estimators, on numpy and cv2 (matplotlib,
headless, for the 3-D ray plot only).
"""

from __future__ import annotations

import os

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def _to_u8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.max() <= 1.0:
        img = img * 255
    return np.ascontiguousarray(img.astype(np.uint8))


def draw_correspondences(img1, img2, matches, num: int = 50, seed: int = 0):
    """Side-by-side pair with match lines. matches [N,4] (x1,y1,x2,y2)."""
    img1 = _to_u8(img1)
    img2 = _to_u8(img2)
    h, w = img1.shape[:2]
    canvas = np.concatenate([img1, img2], axis=1)
    rng = np.random.RandomState(seed)
    idx = rng.choice(len(matches), size=min(num, len(matches)), replace=False)
    for i in idx:
        x1, y1, x2, y2 = matches[i]
        color = tuple(int(c) for c in rng.randint(0, 255, 3))
        cv2.circle(canvas, (int(x1), int(y1)), 2, color, -1)
        cv2.circle(canvas, (int(x2) + w, int(y2)), 2, color, -1)
        cv2.line(canvas, (int(x1), int(y1)), (int(x2) + w, int(y2)), color, 1)
    return canvas


def draw_epipolar_lines(img1, img2, F, points1, num: int = 20, seed: int = 0):
    """Epipolar lines of points1 (in img1) drawn on img2. F [3,3]."""
    img1 = _to_u8(img1)
    img2 = _to_u8(img2)
    h, w = img2.shape[:2]
    canvas = img2.copy()
    rng = np.random.RandomState(seed)
    idx = rng.choice(len(points1), size=min(num, len(points1)), replace=False)
    for i in idx:
        x, y = points1[i][:2]
        a, b, c = np.asarray(F) @ np.array([x, y, 1.0])
        color = tuple(int(v) for v in rng.randint(0, 255, 3))
        if abs(b) > 1e-9:
            p0 = (0, int(-c / b))
            p1 = (w - 1, int(-(c + a * (w - 1)) / b))
        else:
            p0 = (int(-c / a), 0)
            p1 = (int(-c / a), h - 1)
        cv2.line(canvas, p0, p1, color, 1)
    return canvas


def save_debug_pair(dump_dir, name, canvas):
    os.makedirs(dump_dir, exist_ok=True)
    cv2.imwrite(os.path.join(dump_dir, f"{name}.png"), canvas)


def _camera_ray(K, RT, point2d, length: float = 100.0, n: int = 1000):
    """World-frame points along the back-projected ray of a pixel.

    RT = [R|t] (world->cam); the ray leaves the camera center C = -R^T t in
    direction R^T K^-1 [x, y, 1] (visualizer.py:197-208). Returns
    ([n,3] points, [3] unit direction).
    """
    K_inv = np.linalg.inv(np.asarray(K, np.float64))
    RT = np.asarray(RT, np.float64)
    R, t = RT[:, :3], RT[:, 3]
    d = R.T @ (K_inv @ np.array([point2d[0], point2d[1], 1.0]))
    d = d / (np.linalg.norm(d) + 1e-12)
    origin = -R.T @ t
    ts = np.linspace(0.0, length, n)
    return origin[None] + ts[:, None] * d[None], d


def plot_two_rays(match, P1, P2, out_path=None, ax=None):
    """3-D plot of the two back-projected rays of a correspondence.

    ``match`` = (x1, y1, x2, y2); P1/P2 are 3x4 projection matrices sharing
    K (P1 = K[I|0]). The triangulation sanity-check of the reference's
    ``visualize_two_rays`` (visualizer.py:197-226): near-parallel rays (dot
    ~ 1) mean an ill-conditioned midpoint triangulation. Returns the ray
    dot product; writes a PNG when ``out_path`` is given (requires
    matplotlib, headless Agg).
    """
    P1 = np.asarray(P1, np.float64)
    P2 = np.asarray(P2, np.float64)
    K = P1[:, :3]  # P1 has identity rotation and zero translation
    K_inv = np.linalg.inv(K)
    RT1, RT2 = K_inv @ P1, K_inv @ P2
    x1, y1, x2, y2 = match
    pts1, d1 = _camera_ray(K, RT1, (x1, y1))
    pts2, d2 = _camera_ray(K, RT2, (x2, y2))
    dot = float(np.dot(d1, d2))

    if out_path is not None or ax is not None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = None
        if ax is None:
            fig = plt.figure()
            ax = fig.add_subplot(projection="3d")
        ax.plot3D(pts1[:, 0], pts1[:, 1], pts1[:, 2], c="g")
        ax.plot3D(pts2[:, 0], pts2[:, 1], pts2[:, 2], c="r")
        ax.scatter(*pts1[0], c="r")
        ax.scatter(*pts2[0], c="r")
        ax.set_title(f"ray dot = {dot:.6f}")
        if out_path is not None and fig is not None:
            os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
            fig.savefig(out_path)
            plt.close(fig)
    return dot
