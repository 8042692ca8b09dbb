"""Process groups and the collectives of data-parallel training.

Port of the JAX package's ``parallel/mesh.py``. There, one ``data`` mesh
spans every chip, the batch is sharded over it, the parameters are
replicated, and XLA inserts the gradient all-reduce. Here every rank is one
process with one card and the full replica of the model; the global batch
is sharded over the ranks (each feeds its ``batch_size // world`` items
through ``parallel/batch.to_device_batch``: no global array is assembled,
so the JAX ``make_global_batch`` and ``local_replica`` have no
counterpart), and the train step reduces explicitly
(``parallel/train_step.py``):

- BatchNorm's per-channel sums in train mode, so that its statistics are
  those of the global batch (``models/layers.py``, ``sync_batch_norm``);
- the gradients, as one flat buffer per dtype, before the global-norm clip
  (``all_reduce_gradients``);
- the metrics, which become the world's means (``all_reduce_metrics``).

Each of these is a mean over the ranks. With equal shards that is the mean
over the global batch, since every loss of the pack is a mean over items.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..models.layers import BatchNorm
from ..utils.device import resolve_device

# Every rank waits while rank 0 saves a checkpoint or runs the interleaved
# eval. A KITTI eval runs for minutes (reading the flow GT alone takes about
# two minutes on the synthetic trees of chip_smoke.py's eval phase), longer
# than NCCL's default timeout of ten minutes.
GROUP_TIMEOUT = datetime.timedelta(hours=2)


def under_torchrun() -> bool:
    """Whether torchrun (or another launcher of its contract) started this
    process: it sets RANK and WORLD_SIZE."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def distributed_init(
    coordinator_address: str = "",
    num_processes: int = 0,
    process_id: int = -1,
    device=None,
    backend: str | None = None,
) -> torch.device:
    """Join the process group of a data-parallel run; returns this rank's
    device.

    - Under torchrun: RANK, WORLD_SIZE, LOCAL_RANK and MASTER_ADDR /
      MASTER_PORT (``env://``). A group is made even for one process, as
      torchrun was asked for one.
    - Otherwise with ``num_processes`` > 1: the JAX flags, as ``tcp://``
      init at ``coordinator_address`` with rank ``process_id``. A JAX
      process may hold several chips; a rank here holds one card, so launch
      one process per card. The card is LOCAL_RANK where it is set, else
      ``process_id`` modulo the visible cards.
    - A no-op when a group exists already (the caller made it) or with
      neither: one process.

    ``device`` (default: CUDA) picks the card or the CPU; on CUDA without an
    index the rank takes its local card and makes it current. ``backend``
    is NCCL on the card and gloo on the CPU unless the caller names one.
    The group's timeout is ``GROUP_TIMEOUT``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dist.is_initialized():
        dev = resolve_device(dev)
        if dev.type == "cuda" and dev.index is None:  # the card the caller made current
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if under_torchrun():
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_RANK", 0))
        init_method = "env://"
    elif num_processes > 1:
        if not coordinator_address or not 0 <= process_id < num_processes:
            raise ValueError(
                f"num_processes={num_processes} needs coordinator_address (host:port) and "
                f"a process_id in [0, {num_processes}); got {coordinator_address!r}, {process_id}"
            )
        rank, world = process_id, num_processes
        local = int(os.environ.get("LOCAL_RANK", -1))
        init_method = f"tcp://{coordinator_address}"
    else:
        return resolve_device(dev)
    if dev.type == "cuda" and dev.index is None:
        if local < 0:
            local = process_id % max(torch.cuda.device_count(), 1)
        dev = torch.device("cuda", local)
    dev = resolve_device(dev)
    kwargs = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        kwargs["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=GROUP_TIMEOUT, **kwargs)
    return dev


def world_group():
    """The default group when one exists, else None (one process)."""
    return dist.group.WORLD if dist.is_initialized() else None


def rank_and_world(group) -> tuple[int, int]:
    """(rank, world size) in ``group``; (0, 1) for None."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def sync_batch_norm(model: torch.nn.Module, group) -> None:
    """Every BatchNorm of ``model`` takes its train-mode statistics over
    ``group``'s global batch (None: over its own input)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group


def _buckets(tensors):
    """``tensors`` grouped by dtype, in order."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    return by_dtype.values()


def all_reduce_gradients(params, group) -> None:
    """Average the gradients of ``params`` over ``group``, in place: one
    flat buffer per dtype, summed, divided by the world size. Parameters
    without a gradient (networks the mode does not run) are left out, on
    every rank alike."""
    world = dist.get_world_size(group)
    for grads in _buckets([p.grad for p in params if p.grad is not None]):
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        flat.div_(world)
        for g, v in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(v.view_as(g))


def all_reduce_metrics(metrics: dict, group) -> dict:
    """The world's mean of each scalar metric, as one collective."""
    world = dist.get_world_size(group)
    flat = torch.stack([v.float() for v in metrics.values()])
    dist.all_reduce(flat, group=group)
    flat.div_(world)
    return dict(zip(metrics, flat.unbind()))


def check_replicas(module: torch.nn.Module, group) -> None:
    """Raise on every rank unless ``module``'s parameters and buffers equal
    rank 0's bit for bit: each dtype's tensors as one flat buffer,
    broadcast from rank 0 and compared."""
    state = list(module.state_dict().values())
    differ = torch.zeros((), dtype=torch.float32, device=state[0].device)
    for tensors in _buckets(state):
        mine = torch.cat([t.reshape(-1) for t in tensors])
        ref = mine.clone()
        dist.broadcast(ref, src=dist.get_global_rank(group, 0), group=group)
        differ += (mine != ref).sum()
    dist.all_reduce(differ, group=group)
    if differ.item():
        raise RuntimeError(
            f"the ranks start from different parameters or buffers ({int(differ.item())} "
            "elements differ from rank 0's): the same seed, checkpoint and stage init "
            "must reach every rank"
        )
