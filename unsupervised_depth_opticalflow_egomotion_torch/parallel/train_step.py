"""The training step: loss graph -> gradients -> Adam.

Port of the JAX package's ``parallel/train_step.py`` for the geom objective,
with the same four entry points:

- ``build_model(cfg, device)``: the ``JointModel`` built from ``Config``,
  its weights initialised from ``cfg.seed`` by an explicit
  ``torch.Generator``, on ``device`` (CUDA unless the caller passes "cpu").
- ``make_optimizer(cfg, model)``: Adam at ``cfg.lr`` (torch's defaults equal
  optax.adam's) over the trainable parameters, with the optional global-norm
  clip applied in the step. The ``fix_*`` flags freeze parameters by the
  JAX package's substring labels (pwc/fpyramid, depth, pose); frozen
  parameters still run forward and their BatchNorm statistics still update.
- ``init_state(cfg, device)``: the model and its optimizer.
- ``make_train_step(model, cfg, optimizer)``: one step on a batch
  ``(images, K_ms, K_inv_ms)``; returns the metrics (the mean of every loss
  in the pack and the weighted ``loss_total``).

The model and the optimizer state are updated in place; BatchNorm running
statistics update during the forward, as flax's mutable ``batch_stats``.
"""

from __future__ import annotations

import torch

from ..config import Config, loss_weights
from ..models.joint import JointModel
from ..models.layers import init_weights
from ..ops.ssim import ssim_route
from ..utils.device import resolve_device


def build_model(cfg: Config, device=None) -> JointModel:
    """``JointModel`` from ``cfg``, initialised from ``cfg.seed``, in train mode.

    Raises when CUDA is absent unless ``device="cpu"``, and for
    ``ssim_impl="pallas"`` on CUDA (that SSIM kernel is not ported yet).
    """
    dev = resolve_device(device)
    if cfg.mode != "geom":
        raise NotImplementedError(
            f"mode={cfg.mode!r} is not ported yet; only 'geom' (ROADMAP.md, queue 1)"
        )
    ssim_route(cfg.ssim_impl, dev)
    model = JointModel(cfg)
    init_weights(model, torch.Generator().manual_seed(cfg.seed))
    return model.to(dev).train()


def freeze_label(cfg: Config, name: str) -> str:
    """'frozen' or 'train' for a parameter name (train.py:64-80 semantics)."""
    if cfg.fix_flow and ("pwc" in name or "fpyramid" in name):
        return "frozen"
    if cfg.fix_depth and "depth" in name:
        return "frozen"
    if cfg.fix_pose and "pose" in name:
        return "frozen"
    return "train"


def make_optimizer(cfg: Config, model: JointModel) -> torch.optim.Optimizer:
    """Adam over the trainable parameters; frozen ones stop taking gradients."""
    params = []
    for name, p in model.named_parameters():
        if freeze_label(cfg, name) == "frozen":
            p.requires_grad_(False)
        else:
            params.append(p)
    return torch.optim.Adam(params, lr=cfg.lr)


def init_state(cfg: Config, device=None):
    """(model, optimizer) ready for ``make_train_step``."""
    model = build_model(cfg, device)
    return model, make_optimizer(cfg, model)


def clip_by_global_norm(params, max_norm: float) -> None:
    """optax.clip_by_global_norm on the gradients, in place and on device:
    g -> g * max_norm / ||g|| when ||g|| >= max_norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
    )
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))


def make_train_step(model: JointModel, cfg: Config, optimizer: torch.optim.Optimizer):
    """One geom training step: ``step(batch) -> metrics`` (device scalars)."""
    weights = loss_weights(cfg)
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def train_step(batch):
        images, K_ms, K_inv_ms = batch
        loss_pack, _ = model.forward_geom(images, K_ms, K_inv_ms)
        total = torch.zeros((), device=images.device)
        metrics = {}
        for k, v in loss_pack.items():
            m = v.mean()
            metrics[k] = m.detach()
            total = total + weights[k] * m
        metrics["loss_total"] = total.detach()
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        if cfg.grad_clip_norm > 0:
            clip_by_global_norm(params, cfg.grad_clip_norm)
        optimizer.step()
        return metrics

    return train_step
