"""Ranks of a two-process gloo group on the CPU, for tests/test_torch_parallel.py.

``spawn_ranks`` starts ``world`` spawned processes that meet through a
``FileStore`` (no TCP port), each runs ``job(rank, world, *args)`` and
saves its return value to ``<out>/rank<r>.pt``. The jobs import the port
and torch only (no JAX); they compare full models in the ranks and return
summaries, so that little is written to disk.
"""

from __future__ import annotations

import contextlib
import io
import multiprocessing
import os

import numpy as np
import torch
import torch.distributed as dist

H, W = 64, 128


def batch(b: int, seed: int = 0):
    """``b`` uint8 frame stacks at 64x128 and their intrinsics pyramids."""
    rng = np.random.RandomState(seed)
    images = (rng.rand(b, 3 * H, W, 3) * 255).astype(np.uint8)
    K = np.array([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]], np.float32)
    K_ms = np.stack([np.diag([1 / 2**s, 1 / 2**s, 1.0]).astype(np.float32) @ K for s in range(3)])
    K_inv_ms = np.stack([np.linalg.inv(k) for k in K_ms]).astype(np.float32)
    return images, np.tile(K_ms[None], (b, 1, 1, 1)), np.tile(K_inv_ms[None], (b, 1, 1, 1))


def shard(arrays, rank: int, world: int):
    """Rank ``rank``'s rows of each array (equal shards)."""
    b = arrays[0].shape[0] // world
    return tuple(a[rank * b:(rank + 1) * b] for a in arrays)


def _entry(rank, world, store_path, out, job, args):
    torch.set_num_threads(2)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        torch.save(job(rank, world, *args), os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(job, args, out: str, world: int = 2, timeout: float = 600.0) -> list:
    """Run ``job`` on ``world`` spawned ranks; returns their results by rank
    (the result files are removed once read)."""
    os.makedirs(out, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(r, world, os.path.join(out, "store"), out, job, args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not alive, f"ranks still running after {timeout} s: {alive}"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"rank exit codes {codes}"
    results = []
    for r in range(world):
        path = os.path.join(out, f"rank{r}.pt")
        results.append(torch.load(path, weights_only=False))
        os.remove(path)
    return results


def step_record(model, opt, metrics) -> dict:
    """What a train step left: metrics, gradients, parameters and buffers,
    Adam's moments."""
    named = dict(model.named_parameters())
    return dict(
        metrics={k: float(v) for k, v in metrics.items()},
        grads={k: None if p.grad is None else p.grad.clone() for k, p in named.items()},
        after={k: v.clone() for k, v in model.state_dict().items()},
        mu={k: opt.state[p]["exp_avg"].clone() for k, p in named.items() if p in opt.state},
        nu={k: opt.state[p]["exp_avg_sq"].clone() for k, p in named.items() if p in opt.state},
    )


def one_process_step(kw) -> dict:
    """The port's one-process step on the global batch (no group)."""
    from unsupervised_depth_opticalflow_egomotion_torch.config import Config
    from unsupervised_depth_opticalflow_egomotion_torch.parallel import init_state, make_train_step

    cfg = Config(**kw)
    model, opt = init_state(cfg, "cpu")
    metrics = make_train_step(model, cfg, opt)(
        tuple(torch.from_numpy(x) for x in batch(cfg.batch_size)), 0)
    return step_record(model, opt, metrics)


def differing_from_rank0(tensors) -> int:
    """Elements of ``tensors`` (in order) that differ from rank 0's, summed
    over the ranks: one flat buffer broadcast from rank 0."""
    mine = torch.cat([t.reshape(-1).float() for t in tensors])
    ref = mine.clone()
    dist.broadcast(ref, src=0)
    n = (mine != ref).sum().reshape(1).float()
    dist.all_reduce(n)
    return int(n.item())


def compare(got: dict, want: dict, nets, lr: float) -> dict:
    """Errors of a step record against another, for the tests' tolerances:
    the metrics of both; per (moment, network) the relative L2 error of the
    gradients and Adam's moments; per network the largest parameter
    difference and the share of entries off by more than 0.1 lr; the
    largest running-statistic difference over the tensor's max-abs; the
    parameters of the other networks equal in both; the same parameters
    without a gradient."""
    stats = ("running_mean", "running_var")
    out = {"metrics": (got["metrics"], want["metrics"]), "rel": {}, "params": {}}
    for what in ("grads", "mu", "nu"):
        for net in nets:
            ks = [k for k, v in want[what].items() if k.startswith(net + ".") and v is not None]
            a = torch.cat([got[what][k].flatten() for k in ks])
            b = torch.cat([want[what][k].flatten() for k in ks])
            out["rel"][what, net] = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
    for net in nets:
        ks = [k for k in want["after"] if k.startswith(net + ".") and not k.endswith(stats)]
        d = torch.cat([(got["after"][k] - want["after"][k]).flatten() for k in ks])
        out["params"][net] = (d.abs().max().item() / lr, (d.abs() > 0.1 * lr).float().mean().item())
    out["stats"] = max(((got["after"][k] - v).abs().max() / v.abs().max().clamp_min(1e-30)).item()
                       for k, v in want["after"].items() if k.endswith(stats))
    out["others_equal"] = all(
        torch.equal(got["after"][k], v) for k, v in want["after"].items()
        if not k.startswith(tuple(n + "." for n in nets)) and not k.endswith(stats))
    out["same_grads"] = ({k for k, v in got["grads"].items() if v is None}
                         == {k for k, v in want["grads"].items() if v is None})
    return out


def steps_job(rank, world, configs, nets, keep):
    """One train step of each ``Config`` keyword set on this rank's shard of
    the global batch (step number 0), in the world group. Every rank
    counts the elements of its metrics, state and Adam moments that differ
    from rank 0's, and checks that the networks the mode does not train
    kept their parameters; rank 0 also compares its step with the one-process step
    on the global batch (``compare``), and returns the record of the
    configurations named in ``keep`` (the networks they train, their
    running statistics and the metrics)."""
    from unsupervised_depth_opticalflow_egomotion_torch.config import Config
    from unsupervised_depth_opticalflow_egomotion_torch.parallel import init_state, make_train_step

    out = {}
    for name, kw in configs.items():
        cfg = Config(**kw)
        model, opt = init_state(cfg, "cpu")
        before = {k: v.clone() for k, v in model.state_dict().items()}
        local = shard(batch(cfg.batch_size), rank, world)
        step = make_train_step(model, cfg, opt, dist.group.WORLD)
        rec = step_record(model, opt, step(tuple(torch.from_numpy(x) for x in local), 0))
        same = [torch.tensor(list(rec["metrics"].values())), *rec["after"].values(),
                *rec["mu"].values(), *rec["nu"].values()]
        trained = tuple(n + "." for n in nets[name])
        out[name] = {"differing": differing_from_rank0(same), "untouched": all(
            torch.equal(v, before[k]) for k, v in rec["after"].items()
            if not k.startswith(trained) and not k.endswith(("running_mean", "running_var")))}
        if rank == 0:
            out[name]["vs_one_process"] = compare(rec, one_process_step(kw), nets[name], cfg.lr)
            if name in keep:
                out[name]["record"] = {
                    "metrics": rec["metrics"],
                    "mu": {k: v for k, v in rec["mu"].items() if k.startswith(trained)},
                    "after": {k: v for k, v in rec["after"].items()
                              if k.startswith(trained)
                              or k.endswith(("running_mean", "running_var"))},
                }
    return out


def bn_job(rank, world, x, g, weight, bias):
    """The synchronised BatchNorm on this rank's rows of ``x``: output, the
    gradients of its input and (summed over the ranks) of its parameters,
    the running statistics."""
    from unsupervised_depth_opticalflow_egomotion_torch.models.layers import BatchNorm

    bn = BatchNorm(x.shape[-1])
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
    bn.group = dist.group.WORLD
    xs = shard((x,), rank, world)[0].clone().requires_grad_()
    y = bn(xs)
    (y * shard((g,), rank, world)[0]).sum().backward()
    grads = torch.stack([bn.weight.grad, bn.bias.grad])
    dist.all_reduce(grads)
    return dict(y=y.detach(), dx=xs.grad, dweight=grads[0], dbias=grads[1],
                running_mean=bn.running_mean.clone(), running_var=bn.running_var.clone())


def draws_job(rank, world, kw, b, steps):
    """``step_draws`` of this rank's shard, at each step number."""
    from unsupervised_depth_opticalflow_egomotion_torch.config import Config
    from unsupervised_depth_opticalflow_egomotion_torch.models.joint import JointModel
    from unsupervised_depth_opticalflow_egomotion_torch.parallel.train_step import step_draws

    model = JointModel(Config(**kw))
    local = tuple(torch.from_numpy(x) for x in shard(batch(b), rank, world))
    return {s: step_draws(model, s, local, rank, world) for s in steps}


def cli_job(rank, world, kw, resume_to):
    """The training CLI on this rank: the two refusals a two-rank group
    raises, then a run and a resume. Records what each rank wrote (saves,
    loggers, config dumps), printed, and reduced (each step's local metrics
    and their world means), and its final state."""
    from unsupervised_depth_opticalflow_egomotion_torch import train as cli
    from unsupervised_depth_opticalflow_egomotion_torch.config import Config
    from unsupervised_depth_opticalflow_egomotion_torch.parallel import train_step
    from unsupervised_depth_opticalflow_egomotion_torch.utils import CheckpointManager, MetricLogger

    refusals = {}
    for bad in ({"num_devices": 3}, {"batch_size": 3}):
        try:
            cli.train(Config(**{**kw, **bad}), device="cpu")
        except ValueError as e:
            refusals[next(iter(bad))] = str(e)

    writes = {"save": 0, "logger": 0, "dump": 0}
    reduced = []
    originals = (CheckpointManager.save, MetricLogger.__init__, Config.dump,
                 train_step.all_reduce_metrics)

    def counting(key, fn):
        def wrapped(*a, **k):
            writes[key] += 1
            return fn(*a, **k)
        return wrapped

    def recording(metrics, group):
        out = originals[3](metrics, group)
        reduced.append(({k: float(v) for k, v in metrics.items()},
                        {k: float(v) for k, v in out.items()}))
        return out

    CheckpointManager.save = counting("save", originals[0])
    MetricLogger.__init__ = counting("logger", originals[1])
    Config.dump = counting("dump", originals[2])
    train_step.all_reduce_metrics = recording
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            _, _, step = cli.train(Config(**kw), device="cpu")
            model, _, step2 = cli.train(Config(**{**kw, "num_iterations": resume_to,
                                                   "resume": True}), device="cpu")
    finally:
        (CheckpointManager.save, MetricLogger.__init__, Config.dump,
         train_step.all_reduce_metrics) = originals
    return dict(refusals=refusals, writes=writes, reduced=reduced, printed=printed.getvalue(),
                steps=(step, step2), differing=differing_from_rank0(model.state_dict().values()))
