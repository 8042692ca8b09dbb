"""PyTorch network modules (NHWC activations, reference state_dict names)."""

from .attention import ChannelAttention, PositionAttention
from .depth_net import DepthDecoder, DepthNet, ResnetEncoder
from .feature_pyramid import FeaturePyramid
from .flowpose_model import FlowPoseModel
from .flowpose_net import FlowPoseNet
from .joint import JointModel, split_stack
from .pose_net import PoseNet
from .pwc_decoder import PWCDecoder
from .triangulation_pose import TriangulationPoseModel

__all__ = [
    "ChannelAttention",
    "PositionAttention",
    "DepthDecoder",
    "DepthNet",
    "ResnetEncoder",
    "FeaturePyramid",
    "FlowPoseModel",
    "FlowPoseNet",
    "JointModel",
    "split_stack",
    "PoseNet",
    "PWCDecoder",
    "TriangulationPoseModel",
]
