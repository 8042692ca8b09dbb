"""KITTI metric harnesses (host-side numpy): the port's own copies of the JAX
package's ``evaluation/``."""

from .calib import get_scaled_intrinsic_matrix, load_intrinsics_raw
from .depth_metrics import compute_errors, eval_depth
from .flow_io import (
    disp_to_flowfile,
    flow_to_image,
    read_disp_png,
    read_flo,
    read_flow_png,
    resize_flow,
    write_disp_png,
    write_flo,
    write_flow_png,
)
from .flow_metrics import (
    calculate_error_rate,
    eval_flow_avg,
    format_flow_metrics,
    load_gt_flow_kitti,
)
from .mask_metrics import eval_mask, load_gt_mask
from .odom_eval import (
    KittiEvalOdom,
    compute_snippet_pose_error,
    scale_lse_solver,
    umeyama_alignment,
)

__all__ = [
    "get_scaled_intrinsic_matrix",
    "load_intrinsics_raw",
    "compute_errors",
    "eval_depth",
    "disp_to_flowfile",
    "flow_to_image",
    "read_disp_png",
    "read_flo",
    "read_flow_png",
    "resize_flow",
    "write_disp_png",
    "write_flo",
    "write_flow_png",
    "calculate_error_rate",
    "eval_flow_avg",
    "format_flow_metrics",
    "load_gt_flow_kitti",
    "eval_mask",
    "load_gt_mask",
    "KittiEvalOdom",
    "compute_snippet_pose_error",
    "scale_lse_solver",
    "umeyama_alignment",
]
