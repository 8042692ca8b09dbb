from .debug import (
    draw_correspondences,
    draw_epipolar_lines,
    plot_two_rays,
    save_debug_pair,
)
from .visualizer import Visualizer, dump_mask_pack, save_disp_color_img

__all__ = [
    "draw_correspondences",
    "draw_epipolar_lines",
    "plot_two_rays",
    "save_debug_pair",
    "Visualizer",
    "dump_mask_pack",
    "save_disp_color_img",
]
