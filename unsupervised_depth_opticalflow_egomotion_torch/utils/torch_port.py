"""Import checkpoints of the reference's ``Model_geometry`` into the port.

The counterpart of the JAX package's ``utils/torch_port.py``, which maps a
reference state_dict onto flax variables. The port's modules carry the
reference's state_dict names and layouts, so no mapping is needed: strip
DataParallel's ``module.`` prefix, drop the ``num_batches_tracked``
counters (the port's BatchNorm has flax's fixed momentum and keeps none),
and load strictly, so that a missing name, an unknown one or a wrong shape
raises.

The state_dict may come straight from ``torch.load(...)['model_state_dict']``
(values: tensors or anything ``numpy.asarray`` takes).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def strip_module_prefix(state_dict: Mapping) -> dict:
    """Remove torch DataParallel's ``module.`` name prefix."""
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in state_dict.items()}


def load_model_geometry(model: torch.nn.Module, state_dict: Mapping) -> None:
    """Load a reference ``Model_geometry`` state_dict into the port's
    ``JointModel`` strictly (RuntimeError on a missing or unknown name or a
    wrong shape)."""
    sd = {
        k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        for k, v in strip_module_prefix(state_dict).items()
        if not k.endswith("num_batches_tracked")
    }
    model.load_state_dict(sd, strict=True)
