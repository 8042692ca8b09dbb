"""Debug visualization: colormapped depth/disp, masks, flow images.

The port's own copy of the JAX package's ``visualize/visualizer.py``.
Covers the live surface of the reference's core/visualize/visualizer.py --
tensor->colormapped arrays for logging (:49-61), disp color dumps (:171-180)
-- using matplotlib colormaps when available and a grayscale fallback
otherwise.
"""

from __future__ import annotations

import os

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

from ..evaluation.flow_io import flow_to_image


def _colormap(arr: np.ndarray, cmap: str = "magma") -> np.ndarray:
    """Normalize a [H,W] array to a uint8 [H,W,3] colormapped image."""
    a = np.asarray(arr, np.float64)
    a = (a - a.min()) / (a.max() - a.min() + 1e-12)
    try:
        import matplotlib

        rgba = matplotlib.colormaps[cmap](a)
        return (rgba[..., :3] * 255).astype(np.uint8)
    except Exception:
        g = (a * 255).astype(np.uint8)
        return np.stack([g, g, g], axis=-1)


def save_disp_color_img(disp: np.ndarray, path: str, cmap: str = "magma") -> None:
    img = _colormap(np.squeeze(disp), cmap)
    cv2.imwrite(path, img[:, :, ::-1])


class Visualizer:
    """Dumps mask/depth/flow debug images for a train step."""

    def __init__(self, dump_dir: str):
        self.dump_dir = dump_dir
        os.makedirs(dump_dir, exist_ok=True)

    def save_mask(self, mask: np.ndarray, name: str) -> None:
        m = np.squeeze(np.asarray(mask))
        cv2.imwrite(
            os.path.join(self.dump_dir, f"{name}.png"), (255 * m).astype(np.uint8)
        )

    def save_disp(self, disp: np.ndarray, name: str, cmap: str = "magma") -> None:
        save_disp_color_img(np.asarray(disp), os.path.join(self.dump_dir, f"{name}.png"), cmap)

    def save_flow(self, flow: np.ndarray, name: str) -> None:
        img = flow_to_image(np.asarray(flow))
        cv2.imwrite(os.path.join(self.dump_dir, f"{name}.png"), img[:, :, ::-1])

    def save_image(self, img: np.ndarray, name: str) -> None:
        arr = np.asarray(img)
        if arr.max() <= 1.0:
            arr = arr * 255
        cv2.imwrite(os.path.join(self.dump_dir, f"{name}.png"), arr.astype(np.uint8))


def dump_mask_pack(aux: dict, center_image: np.ndarray, out_dir: str, step: int,
                   logger=None) -> str:
    """Write the geom forward's debug mask pack as PNGs (+ TB images).

    Mirrors the reference's 10-image training dump (train.py:177-209): the
    seven fused/intermediate masks, colormapped disp, flow color wheel, and
    the input center frame, all for batch item 0. ``aux`` is
    ``forward_geom(with_masks=True)``'s aux dict of [B,...] arrays.
    """
    step_dir = os.path.join(out_dir, f"step_{step:08d}")
    viz = Visualizer(step_dir)
    for name in (
        "occ_fwd_mask", "rigid_fwd_mask", "inlier_fwd_mask", "dyna_fwd_mask",
        "valid_fwd_mask", "fwd_mask", "texture_mask_fwd",
    ):
        if name in aux:
            viz.save_mask(np.asarray(aux[name])[0], name)
    if "pred_disp" in aux:
        viz.save_disp(np.asarray(aux["pred_disp"])[0], "pred_disp")
    if "pred_flow_fwd" in aux:
        viz.save_flow(np.asarray(aux["pred_flow_fwd"])[0], "pred_flow_fwd")
    if center_image is not None:
        viz.save_image(np.asarray(center_image), "center_image")
    if logger is not None:
        for name in ("fwd_mask", "dyna_fwd_mask", "occ_fwd_mask"):
            if name in aux:
                m = np.asarray(aux[name])[0]
                logger.add_image(step, f"masks/{name}", (255 * np.squeeze(m)).astype(np.uint8))
        if "pred_disp" in aux:
            logger.add_image(step, "pred/disp", _colormap(np.squeeze(np.asarray(aux["pred_disp"])[0])))
        if "pred_flow_fwd" in aux:
            logger.add_image(step, "pred/flow_fwd", flow_to_image(np.asarray(aux["pred_flow_fwd"])[0]))
    return step_dir
