"""PyTorch network modules (NHWC activations, reference state_dict names)."""

from .depth_net import DepthDecoder, DepthNet, ResnetEncoder
from .feature_pyramid import FeaturePyramid
from .joint import JointModel, split_stack
from .pose_net import PoseNet
from .pwc_decoder import PWCDecoder

__all__ = [
    "DepthDecoder",
    "DepthNet",
    "ResnetEncoder",
    "FeaturePyramid",
    "JointModel",
    "split_stack",
    "PoseNet",
    "PWCDecoder",
]
