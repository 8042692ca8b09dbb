"""The training step: loss graph -> gradients -> Adam.

Port of the JAX package's ``parallel/train_step.py`` for the three training
modes (``cfg.mode``: flow | depth | geom), with the same four entry points:

- ``build_model(cfg, device)``: the ``JointModel`` built from ``Config``,
  its weights initialised from ``cfg.seed`` by an explicit
  ``torch.Generator``, on ``device`` (CUDA unless the caller passes "cpu").
- ``make_optimizer(cfg, model)``: Adam at ``cfg.lr`` (torch's defaults equal
  optax.adam's) over the trainable parameters, with the optional global-norm
  clip applied in the step. The ``fix_*`` flags freeze parameters by the
  JAX package's substring labels (pwc/fpyramid, depth, pose; ``fix_flow``
  also RAFT's, ``raft.*``); frozen parameters still run forward and their
  BatchNorm statistics still update.
- ``init_state(cfg, device)``: the model and its optimizer.
- ``make_train_step(model, cfg, optimizer, group=None)``: one step on a
  batch ``(images, K_ms, K_inv_ms)``; returns the metrics (the mean of
  every loss in the pack and the weighted ``loss_total``).

The step marks its phases as program spans (``utils/profiler.span``:
``train_step`` and, nested in it, ``train_step.draws`` / ``.forward`` /
``.backward`` / ``.allreduce`` / ``.optimizer``), which a profiler session
records and which cost one flag read each outside a session.

On a card, one process and no sampled losses, the step is one CUDA graph
(``TrainStep``): the first two calls run op by op on a side stream (they
warm up cuDNN's autotuning and Adam's state), the third captures the same
code (forward, weighted sum, ``backward()``, ``optimizer.step()``) and
replays it, and every later call copies its batch into the graph's input
buffers and replays (spans ``train_step.capture`` and
``train_step.replay`` inside ``train_step``). At the capture Adam turns
``capturable`` (its step counts move to the card). The CPU, a process group
(NCCL's all-reduce) and the sampled losses (CPU-drawn indices each step)
keep the step op by op, with torch's default Adam.

Data parallel (``group``, a ``torch.distributed`` process group; the JAX
step under a mesh, train_step.py:270-277): each rank steps its shard of the
global batch on its own replica. BatchNorm takes the global batch's
statistics, the gradients are averaged over the ranks before the clip (as
optax clips the global gradient), and the metrics returned are the world's
means (``parallel/mesh.py``). The sampled losses' draws are the global
batch's, of which each rank keeps its own rows.

The geom objective's sampled losses (``enable_triangle`` / ``enable_pnp`` /
``enable_eight_point``) draw random indices every step. The JAX CLI splits
``PRNGKey(cfg.seed + 1)`` once a step (train.py:226, 253); jax.random's bits
cannot be reproduced here, so the port draws step ``s``'s indices from a CPU
``torch.Generator`` seeded from ``(cfg.seed, s)`` (``step_generator``) and
copies them to the card without blocking (about B x 6000 + B x 800
integers a direction). The card and the CPU get the same draws for the
same step, and a resumed run replays them exactly with no saved generator
state.

The model and the optimizer state are updated in place; BatchNorm running
statistics update during the forward, as flax's mutable ``batch_stats``.
A mode trains the networks it runs: flow mode the feature pyramid and the
PWC decoder (no BatchNorm module runs, so every running statistic stays as
it was) or RAFT (whose context encoder's BatchNorm runs), depth mode the
depth and pose networks. The other networks get no gradient; Adam skips
them and keeps no moments for them, which leaves them where optax's zero
gradient leaves them.
"""

from __future__ import annotations

import contextlib

import torch

from ..config import Config, loss_weights
from ..models.joint import JointModel, needs_samples
from ..models.layers import init_weights
from ..utils.device import resolve_device
from ..utils.profiler import span
from .mesh import all_reduce_gradients, all_reduce_metrics, rank_and_world, sync_batch_norm


def build_model(cfg: Config, device=None) -> JointModel:
    """``JointModel`` from ``cfg``, initialised from ``cfg.seed``, in train mode.

    Raises when CUDA is absent unless ``device="cpu"``.
    """
    dev = resolve_device(device)
    model = JointModel(cfg)
    init_weights(model, torch.Generator().manual_seed(cfg.seed))
    return model.to(dev).train()


def freeze_label(cfg: Config, name: str) -> str:
    """'frozen' or 'train' for a parameter name (train.py:64-80 semantics)."""
    if cfg.fix_flow and ("pwc" in name or "fpyramid" in name or name.startswith("raft.")):
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


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of step ``step``'s draws, seeded from (seed, step)."""
    return torch.Generator().manual_seed(((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))


def step_draws(model: JointModel, step: int, batch, rank: int = 0, world: int = 1) -> dict | None:
    """Step ``step``'s index draws (``JointModel.draw_samples``) on the
    batch's device, copied from pinned memory without blocking; None when
    the objective samples nothing. ``batch`` is rank ``rank``'s shard of a
    global batch ``world`` times its size: the draws are the global batch's
    (as one process draws them), and the rank keeps its own rows."""
    images = batch[0]
    h, b = images.shape[1] // 3, images.shape[0]
    gen = step_generator(model.cfg.seed, step)
    draws = model.draw_samples(gen, b * world, (h, images.shape[2]))
    if draws is not None and world > 1:
        draws = {k: v[rank * b:(rank + 1) * b] for k, v in draws.items()}
    if draws is None or images.device.type != "cuda":
        return draws
    return {k: v.pin_memory().to(images.device, non_blocking=True) for k, v in draws.items()}


def _forward(model: JointModel, cfg: Config, batch, draws=None):
    """The loss pack (dict of [B] vectors) of ``cfg.mode`` on ``batch``."""
    if cfg.mode == "flow":
        return model.forward_flow(*batch)
    if cfg.mode == "depth":
        return model.forward_depth(*batch)
    return model.forward_geom(*batch, draws=draws)[0]


def make_train_step(model: JointModel, cfg: Config, optimizer: torch.optim.Optimizer,
                    group=None) -> "TrainStep":
    """One training step of ``cfg.mode``: ``step(batch, step=None) ->
    metrics`` (device scalars). ``step`` (the number of steps taken before
    this one) seeds the draws of the sampled geom losses, and must be given
    when they are on. With a process ``group``, ``batch`` is this rank's
    shard of the global batch, and the step is the global batch's."""
    weights = loss_weights(cfg)
    params = [p for g in optimizer.param_groups for p in g["params"]]
    sampled = needs_samples(cfg)
    rank, world = rank_and_world(group)
    sync_batch_norm(model, group)

    def body(batch, step):
        if sampled and step is None:
            raise ValueError("the sampled geom losses need the step number to draw from")
        draws = None
        if sampled:
            with span("train_step.draws"):
                draws = step_draws(model, step, batch, rank, world)
        with span("train_step.forward"):
            loss_pack = _forward(model, cfg, batch, draws)
            total = torch.zeros((), device=batch[0].device)
            metrics = {}
            for k, v in loss_pack.items():
                m = v.mean()
                metrics[k] = m.detach()
                total = total + weights[k] * m
            metrics["loss_total"] = total.detach()
        with span("train_step.backward"):
            optimizer.zero_grad(set_to_none=True)
            total.backward()
        if group is not None:
            with span("train_step.allreduce"):
                all_reduce_gradients(params, group)
                metrics = all_reduce_metrics(metrics, group)
        with span("train_step.optimizer"):
            if cfg.grad_clip_norm > 0:
                clip_by_global_norm(params, cfg.grad_clip_norm)
            optimizer.step()
        return metrics

    return TrainStep(body, optimizer, graphable=group is None and not sampled)


# calls of a graphed step that run op by op before the one that captures
WARMUP_CALLS = 2


class TrainStep:
    """The training step: op by op, or on a card as one CUDA graph.

    The graph is used when the batch lies on a card and the step has no
    process group and no sampled losses. Calls 0 and 1 then run ``eager``
    on a side stream; call 2 captures ``eager``'s body into a
    ``torch.cuda.CUDAGraph`` over input buffers that copy its batch, and
    replays it; every later call copies its batch into those buffers and
    replays. The metrics are one tensor inside the graph, which the next
    replay overwrites: each call returns views of its own clone. After the
    capture a batch of another shape, dtype or device than the captured one
    is refused (``ValueError``). Adam turns ``capturable`` at the capture.

    The graph holds the addresses of the model's parameters and buffers and
    of Adam's state: neither the model nor the optimizer may be rebound
    after the third call (no ``load_state_dict``, no new parameter tensor).
    A new step on the same model and optimizer warms up and captures
    afresh; the old one's graph and memory pool go with the old object
    (its gradients with the new step's first ``zero_grad``).
    """

    def __init__(self, body, optimizer, graphable: bool):
        self._body = body
        self.optimizer = optimizer
        self.graphable = graphable
        self.body_runs = 0  # calls that ran the body on the host (eager, or the capture)
        self.warm_calls = 0
        self.stream = None
        self.graph = None
        self.static_in = None  # the graph's input buffers
        self.static_out = None  # the graph's metrics, stacked
        self.keys = None

    def eager(self, batch, step=None) -> dict:
        """The step op by op on the current stream: what the graph captures."""
        self.body_runs += 1
        with span("train_step", step):
            return self._body(batch, step)

    def __call__(self, batch, step=None) -> dict:
        if not (self.graphable and _on_card(batch)):
            return self.eager(batch, step)
        if self.graph is not None:
            return self._replay(batch, step)
        if self.warm_calls < WARMUP_CALLS:
            self.warm_calls += 1
            if self.stream is None:
                self.stream = _new_stream(batch[0].device)
            with _side_stream(self.stream):
                return self.eager(batch, step)
        return self._capture(batch, step)

    def _check_fits(self, batch):
        """Refuse a batch that the graph's input buffers cannot take as it
        is (``copy_`` would broadcast or convert it)."""
        def sig(ts):
            return [(tuple(t.shape), t.dtype, t.device) for t in ts]

        if sig(batch) != sig(self.static_in):
            raise ValueError(f"the step's CUDA graph was captured for batches {sig(self.static_in)}, "
                             f"not {sig(batch)}")

    def _capture(self, batch, step) -> dict:
        with span("train_step", step), span("train_step.capture"):
            self.static_in = tuple(t.clone() for t in batch)
            _make_capturable(self.optimizer)
            # backward() then allocates the gradients from the graph's pool
            self.optimizer.zero_grad(set_to_none=True)

            def captured():
                self.body_runs += 1
                metrics = self._body(self.static_in, step)
                return list(metrics), torch.stack(list(metrics.values()))

            self.graph, (self.keys, self.static_out) = _capture(captured, self.stream)
            return self._launch()

    def _replay(self, batch, step) -> dict:
        self._check_fits(batch)
        with span("train_step", step), span("train_step.replay"):
            for buf, t in zip(self.static_in, batch):
                buf.copy_(t)
            return self._launch()

    def _launch(self) -> dict:
        self.graph.replay()
        return dict(zip(self.keys, self.static_out.clone().unbind()))


def _on_card(batch) -> bool:
    return batch[0].is_cuda


def _make_capturable(optimizer):
    """Adam ``capturable``, its step counts on the parameters' device, so
    that a CUDA graph can hold ``optimizer.step()``."""
    for group in optimizer.param_groups:
        group["capturable"] = True
        for p in group["params"]:
            state = optimizer.state.get(p, {})
            if "step" in state:
                state["step"] = state["step"].to(p.device)


def _new_stream(device):
    return torch.cuda.Stream(device)


@contextlib.contextmanager
def _side_stream(stream):
    """The block's work on ``stream``, after the current stream's work so
    far and before its work to come."""
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        yield
    current.wait_stream(stream)


def _capture(fn, stream):
    """``fn()`` captured on ``stream`` into a new CUDA graph: (graph, what
    ``fn`` returned). Only this thread's unsafe calls break the capture (a
    data loader's threads may go on meanwhile)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
        out = fn()
    return graph, out
