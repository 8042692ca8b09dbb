"""Training observability: console loss lines, scalar history, pickle dump.

The port's own copy of the JAX package's ``utils/logging.py``. Replaces the reference's tensorboardX observer + Visualizer pair
(the reference's train.py:177-209, core/visualize/visualizer.py:63-92) with a
dependency-light recorder: scalars go to an in-memory history that is
periodically pickled to ``<model_dir>/log.pkl`` (same artifact name the
reference writes), and to TensorBoard if tensorboardX happens to be
installed.
"""

from __future__ import annotations

import os
import pickle
import time
from collections import defaultdict


class MetricLogger:
    def __init__(self, model_dir: str, log_dump_name: str = "log.pkl"):
        self.model_dir = model_dir
        os.makedirs(model_dir, exist_ok=True)
        self.dump_path = os.path.join(model_dir, log_dump_name)
        self.history: dict[str, list] = defaultdict(list)
        self._t0 = time.time()
        self._tb = None
        try:  # optional
            from tensorboardX import SummaryWriter  # type: ignore

            self._tb = SummaryWriter(model_dir)
        except Exception:
            pass

    def add_scalars(self, step: int, scalars: dict) -> None:
        for k, v in scalars.items():
            self.history[k].append((step, float(v)))
            if self._tb is not None:
                self._tb.add_scalar(k, float(v), step)

    def add_eval(self, step: int, name: str, values) -> None:
        """An interleaved eval's metrics, kept as given under ``eval/<name>``."""
        self.history[f"eval/{name}"].append((step, values))

    def add_image(self, step: int, name: str, img: "object") -> None:
        """TB image ([H,W] or [H,W,3] uint8); no-op without tensorboardX."""
        if self._tb is None:
            return
        import numpy as np

        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        self._tb.add_image(name, arr.transpose(2, 0, 1), step)

    def print_losses(self, step: int, total_steps: int, scalars: dict) -> None:
        elapsed = time.time() - self._t0
        parts = ", ".join(f"{k.removeprefix('loss_')}={v:.4f}" for k, v in scalars.items())
        print(f"[{step}/{total_steps}] ({elapsed:.0f}s) {parts}", flush=True)

    def dump(self) -> None:
        with open(self.dump_path, "wb") as f:
            pickle.dump(dict(self.history), f)

    def close(self) -> None:
        self.dump()
        if self._tb is not None:
            self._tb.close()
