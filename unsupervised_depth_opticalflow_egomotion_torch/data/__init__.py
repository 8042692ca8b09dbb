"""Host-side data preparation, input pipeline and eval datasets (the port's
copies)."""

from .kitti_flow import KittiFlowEval
from .kitti_pose import KittiPoseEval
from .kitti_prep import KittiOdoPrep, KittiRawPrep
from .loader import (
    BatchLoader,
    KittiPreparedDataset,
    multiscale_intrinsics,
    read_cam_intrinsic,
    rescale_intrinsics,
)
from .native_loader import NativeBatchLoader, make_loader
from .nyu import NyuPrep, load_nyu_test_data, test_nyu_depth

__all__ = [
    "KittiFlowEval",
    "KittiPoseEval",
    "KittiOdoPrep",
    "KittiRawPrep",
    "NyuPrep",
    "load_nyu_test_data",
    "test_nyu_depth",
    "BatchLoader",
    "NativeBatchLoader",
    "make_loader",
    "KittiPreparedDataset",
    "multiscale_intrinsics",
    "read_cam_intrinsic",
    "rescale_intrinsics",
]
