"""Host-side data preparation and input pipeline (the port's copies)."""

from .kitti_prep import KittiOdoPrep, KittiRawPrep
from .loader import (
    BatchLoader,
    KittiPreparedDataset,
    multiscale_intrinsics,
    read_cam_intrinsic,
    rescale_intrinsics,
)
from .native_loader import NativeBatchLoader, make_loader
from .nyu import NyuPrep

__all__ = [
    "KittiOdoPrep",
    "KittiRawPrep",
    "NyuPrep",
    "BatchLoader",
    "NativeBatchLoader",
    "make_loader",
    "KittiPreparedDataset",
    "multiscale_intrinsics",
    "read_cam_intrinsic",
    "rescale_intrinsics",
]
