from .checkpoint import CheckpointManager, graft_params, opt_layout_tag
from .device import resolve_device
from .jax_weights import load_jax_variables
from .logging import MetricLogger

__all__ = [
    "CheckpointManager",
    "graft_params",
    "opt_layout_tag",
    "resolve_device",
    "load_jax_variables",
    "MetricLogger",
]
