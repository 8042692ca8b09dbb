"""Host batches onto the card: the single-card counterpart of the JAX
package's ``parallel/mesh.py:make_global_batch``."""

from __future__ import annotations

import numpy as np
import torch


def to_device_batch(batch, device) -> tuple:
    """A host batch (numpy arrays) as tensors on ``device``.

    On CUDA each array goes through pinned host memory and is copied with
    ``non_blocking=True``, so the host does not wait for the transfer (the
    copy is ordered on the current stream before the step that reads it);
    nothing synchronizes. On the CPU the arrays are wrapped without a copy.
    """
    dev = torch.device(device)
    out = []
    for x in batch:
        t = torch.from_numpy(np.ascontiguousarray(x))
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        out.append(t)
    return tuple(out)
