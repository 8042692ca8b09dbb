"""Checkpoints of a training run: step-indexed ``torch.save`` files, a schema
sidecar, and the parameter graft of the staged flow -> depth -> geom init.

The port's counterpart of the JAX package's ``utils/checkpoint.py`` (orbax
there), with its semantics:

- ``<dir>/<step>.pt`` holds the step, the model's ``state_dict`` (parameters
  and buffers: the BatchNorm running statistics) and the optimizer's, as CPU
  copies; a save writes a temporary name and renames it, so a run that is
  cut leaves no half file. At most ``max_to_keep`` steps are kept.
- ``<dir>/schema.json`` records ``SCHEMA_VERSION``, the optimizer layout tag
  and the caller's metadata (mode, img_hw).
- A torch Adam ``state_dict`` indexes its state by the position of each
  parameter among the trainable ones, and the ``fix_*`` flags decide which
  are trainable: a checkpoint saved under other flags would load its
  moments into the wrong tensors without an error. ``restore`` refuses a
  layout mismatch from the sidecar before it loads anything.
- ``restore_params`` reads the model's tensors alone, whatever the layout;
  ``graft_params`` copies the parameters whose name and shape match, and
  no buffer: the JAX CLI grafts ``params`` and keeps ``batch_stats`` and the
  optimizer state fresh (the repository's train.py:149-156).
"""

from __future__ import annotations

import json
import os
import re
from typing import Mapping, Optional

import torch

SCHEMA_VERSION = 1
_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def opt_layout_tag(fix_flow: bool = False, fix_depth: bool = False,
                   fix_pose: bool = False) -> str:
    """The optimizer-state layout of a run: which networks are frozen, since
    that decides the parameter positions the Adam state is indexed by."""
    frozen = [
        n
        for n, f in [("flow", fix_flow), ("depth", fix_depth), ("pose", fix_pose)]
        if f
    ]
    return "adam:frozen=" + "+".join(frozen) if frozen else "adam:all"


def _cpu_copy(obj):
    """``obj`` (nested dicts / lists of tensors) with every tensor copied to
    the host."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _cpu_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu_copy(v) for v in obj)
    return obj


class CheckpointManager:
    """Step-indexed checkpoints in a local directory, at most ``max_to_keep``."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep

    # -- schema sidecar -------------------------------------------------
    @property
    def _schema_path(self) -> str:
        return os.path.join(self.directory, "schema.json")

    def save_meta(self, meta: dict) -> None:
        meta = {"schema_version": SCHEMA_VERSION, **meta}
        tmp = f"{self._schema_path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1, sort_keys=True)
        os.replace(tmp, self._schema_path)

    def load_meta(self) -> Optional[dict]:
        """The schema sidecar, or None when there is none."""
        if not os.path.exists(self._schema_path):
            return None
        with open(self._schema_path) as f:
            return json.load(f)

    # -- steps -------------------------------------------------------------
    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def steps(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        found = (_STEP_FILE.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _resolve(self, step: Optional[int]) -> int:
        step = step if step is not None else self.latest_step()
        if step is None or not os.path.exists(self.path(step)):
            raise FileNotFoundError(f"no checkpoint found in {self.directory}")
        return step

    # -- save / restore --------------------------------------------------
    def save(self, step: int, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
             meta: Optional[dict] = None) -> str:
        """Save CPU copies of ``model`` and ``optimizer`` at ``step``; keep
        the newest ``max_to_keep`` steps; record ``meta`` in the sidecar."""
        os.makedirs(self.directory, exist_ok=True)
        state = {
            "step": int(step),
            "model": _cpu_copy(model.state_dict()),
            "optimizer": _cpu_copy(optimizer.state_dict()),
        }
        path = self.path(step)
        tmp = f"{path}.tmp{os.getpid()}"
        torch.save(state, tmp)
        os.replace(tmp, path)
        for old in self.steps()[: -self.max_to_keep]:
            os.remove(self.path(old))
        if meta is not None:
            self.save_meta(meta)
        return path

    def load(self, step: Optional[int] = None) -> dict:
        """The raw saved state of ``step`` (default: the latest), on the CPU."""
        step = self._resolve(step)
        return torch.load(self.path(step), map_location="cpu", weights_only=True)

    def restore_params(self, step: Optional[int] = None) -> dict[str, torch.Tensor]:
        """The model's saved tensors alone (parameters and buffers), whatever
        the optimizer layout: what a stage graft reads."""
        return self.load(step)["model"]

    def restore(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                step: Optional[int] = None, expect_opt_layout: Optional[str] = None) -> int:
        """Load ``step`` (default: the latest) into ``model`` and
        ``optimizer`` in place; returns the restored step.

        With ``expect_opt_layout`` (see :func:`opt_layout_tag`) the sidecar's
        layout is checked before anything is loaded.
        """
        step = self._resolve(step)
        meta = self.load_meta()
        if (
            expect_opt_layout is not None
            and meta is not None
            and meta.get("opt_layout") not in (None, expect_opt_layout)
        ):
            raise RuntimeError(
                f"[checkpoint] {self.directory} step {step} was saved with "
                f"optimizer layout {meta['opt_layout']!r} but this run uses "
                f"{expect_opt_layout!r} (different fix_flow/fix_depth/fix_pose "
                "flags). Restore with a model and optimizer built from the "
                "checkpoint's freezing flags, then graft the params "
                "(utils.graft_params), or use restore_params()."
            )
        state = self.load(step)
        model.load_state_dict(state["model"])
        capturable = [g.get("capturable", False) for g in optimizer.param_groups]
        optimizer.load_state_dict(state["optimizer"])
        # a step that captured a CUDA graph saves its Adam capturable, with
        # the step counts on the card (parallel.train_step): keep the flag as
        # the optimizer holds it, and the step counts where that flag keeps
        # them (the parameters' device if capturable, else the CPU)
        for group, was in zip(optimizer.param_groups, capturable):
            if "capturable" not in group:
                continue
            group["capturable"] = was
            for p in group["params"]:
                st = optimizer.state.get(p, {})
                if "step" in st:
                    st["step"] = st["step"].to(p.device if was else "cpu")
        return int(state["step"])


def graft_params(model: torch.nn.Module, donor: Mapping[str, torch.Tensor]) -> list[str]:
    """Copy the donor's tensors onto ``model``'s parameters wherever name and
    shape match; returns the names copied.

    Buffers (BatchNorm running statistics) are never copied, unknown donor
    keys are ignored, and parameters without a match keep their values: the
    JAX package's ``graft_params`` over ``state.params``.
    """
    copied = []
    with torch.no_grad():
        for name, p in model.named_parameters():
            d = donor.get(name)
            if d is not None and d.shape == p.shape:
                p.copy_(d)
                copied.append(name)
    return copied
