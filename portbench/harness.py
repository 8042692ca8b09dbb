"""One run of one benchmark cell: set-up, the measured window, the traced
span, and the check against the plain reference.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: a configuration
(``configs/<config>.json``, the port's ``Config`` as it is run, and the
plain reference it is checked against) under a traffic mix
(``traffic/<traffic>.json``). Its limits are in ``limits/<cell>.json`` and
each per-layer metric is read by ``metrics/<metric>.py``; all are found by
name. A new configuration comes in as files and entries, with no edit here:

- ``configs/<config>.json``: the ``Config`` fields under ``"config"``, and
  under ``"reference"`` its reference class, ``"<module>.<Class>"`` of
  ``reference/`` (default ``"joint.JointReference"``);
- ``reference/<module>.py``: that class, to the contract in
  ``reference/__init__.py``, where no existing class computes the objective;
- ``limits/<cell>.json``: the numbers its check compares, each with its
  limit (``python3 -m portbench.calibrate``);
- ``traffic/<traffic>.json``, where no existing traffic mix fits;
- ``metrics/<metric>.py``, one reader for each new per-layer metric;
- its entries in ``BENCHMARK.json``: the configuration, its cells, and
  its new metrics.

Which model the port builds for a configuration is the port's business
(``init_state(Config)``).

The timed path is the port's training step,
``parallel.make_train_step(model, cfg, optimizer)`` on the model and Adam
state of ``parallel.init_state(cfg, device)``, with weights the harness
draws from the seed. Set-up drives that same step through its first
``checked_steps`` steps (which also warm up every shape) on batches whose
rows all differ, and keeps what the check compares: each step's loss, the
first gradient's norm by leaf (from Adam's first moment after one step), and
the norms of each leaf's change and of each BatchNorm statistic's change
after the checked steps. The window then times the same step, and after it
(the program freed) the reference runs the checked steps from the same
weights on the same batches.
"""

from __future__ import annotations

import gc
import hashlib
import importlib.util
import json
import math
import os
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch
from torch.utils.flop_counter import FlopCounterMode

from unsupervised_depth_opticalflow_egomotion_torch.config import Config
from unsupervised_depth_opticalflow_egomotion_torch.parallel import init_state, make_train_step

from . import check, feeds
from .flops import KernelCalls, peaks
from .reference.step import leaf_norms, reference_steps
from .trace import STEP_SPAN, Trace

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
DEFAULT_REFERENCE = "joint.JointReference"


# ------------------------------------------------------------------ the cell
def load_cell(name: str) -> SimpleNamespace:
    """The cell ``name`` of BENCHMARK.json with its files, and the metrics
    it reports."""
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    with open(ROOT / conf["file"]) as f:
        conf_file = json.load(f)
    with open(PKG / "limits" / f"{name}.json") as f:
        limits = json.load(f)

    def mine(metrics):
        return [m for m in metrics if "workloads" not in m or name in m["workloads"]]

    return SimpleNamespace(
        name=name, cfg=conf_file["config"],
        reference=reference_class(conf_file.get("reference", DEFAULT_REFERENCE), conf["file"]),
        traffic=feeds.load_traffic(work["traffic"]), limits=limits,
        end_to_end=mine(bench["end_to_end"]), per_layer=mine(bench["per_layer"]))


def reference_class(name: str, source: str):
    """The class ``"<module>.<Class>"`` of ``reference/`` that the
    configuration file ``source`` names."""
    module, _, cls = name.rpartition(".")
    try:
        found = getattr(importlib.import_module(f"{__package__}.reference.{module}"), cls)
    except (ImportError, AttributeError, ValueError) as e:
        raise ValueError(f"{source}: reference {name!r} is no class of portbench/reference/ "
                         f"({e})") from e
    if not isinstance(found, type):
        raise ValueError(f"{source}: reference {name!r} is no class of portbench/reference/")
    return found


def port_config(cfg: dict) -> Config:
    return Config(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()})


def batch_shapes(cfg: dict) -> tuple:
    b, (h, w), ns = cfg["batch_size"], cfg["img_hw"], cfg["num_scales"]
    return (b, 3 * h, w, 3), (b, ns, 3, 3)


# ------------------------------------------------------------------- weights
def parameter_shapes(reference, cfg: dict) -> dict:
    with torch.device("meta"):
        ref = reference(cfg)
    return {k: tuple(p.shape) for k, p in ref.named_parameters()}


def make_weights(shapes: dict, seed: int, device) -> dict:
    """Every parameter from one uniform draw on ``device``: a convolution's
    or dense layer's weight U(+-1/sqrt(fan_in)), a BatchNorm scale 1, every
    bias 0."""
    gen = torch.Generator(device=device).manual_seed(seed)
    mats = [(k, s) for k, s in shapes.items() if len(s) >= 2]
    u = torch.rand(sum(math.prod(s) for _, s in mats), generator=gen, device=device)
    out, o = {}, 0
    for k, s in mats:
        n = math.prod(s)
        bound = 1.0 / math.sqrt(math.prod(s[1:]))
        out[k] = ((u[o:o + n] * 2.0 - 1.0) * bound).view(s)
        o += n
    for k, s in shapes.items():
        if len(s) == 1:
            out[k] = torch.ones(s, device=device) if k.endswith("weight") else torch.zeros(s, device=device)
    return out


# --------------------------------------------------------------- FLOP count
def count_flops(reference, cfg: dict) -> tuple[int, KernelCalls]:
    """One step's FLOPs, counted on the reference class ``reference`` over
    meta tensors: the matrix work (``FlopCounterMode``) plus the kernels'
    functions (the frozen formulas); and the kernels' calls with their
    shapes."""
    img, k = batch_shapes(cfg)
    calls = KernelCalls()
    with torch.device("meta"):
        ref = reference(cfg)
        batch = (torch.empty(img, dtype=torch.uint8), torch.ones(k), torch.ones(k))
    with FlopCounterMode(display=False) as matrix:
        pack = ref.loss_pack(*batch, calls=calls)
        w = ref.weights()
        sum(w[key] * v.mean() for key, v in pack.items()).backward()
    return matrix.get_total_flops() + calls.total, calls


def cached_count(reference, cfg: dict) -> tuple[int, KernelCalls]:
    """``count_flops``, kept in ``.cache/`` inside the checkout under a hash
    of the configuration, of the reference class's name and of the files
    the count runs, so that only a checkout's first run of a cell pays for
    it."""
    h = hashlib.sha256(json.dumps(cfg, sort_keys=True).encode())
    h.update(f"{reference.__module__}.{reference.__qualname__}".encode())
    for f in sorted([*(PKG / "reference").glob("*.py"), PKG / "flops" / "__init__.py",
                     Path(__file__)]):
        h.update(f.read_bytes())
    path = PKG / ".cache" / f"flops-{h.hexdigest()[:24]}.json"
    calls = KernelCalls()
    if path.exists():
        with open(path) as f:
            got = json.load(f)
        calls.flops = got["flops"]
        calls.calls = [(n, p, tuple(s)) for n, p, s in got["calls"]]
        return got["total"], calls
    total, calls = count_flops(reference, cfg)
    path.parent.mkdir(exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    with open(tmp, "w") as f:
        json.dump({"total": total, "flops": calls.flops, "calls": calls.calls}, f)
    os.replace(tmp, path)
    return total, calls


# ------------------------------------------------------------------ program
def build_program(cfg: dict, weights: dict, device):
    """The port's model, optimizer and training step, with ``weights``."""
    pcfg = port_config(cfg)
    model, optimizer = init_state(pcfg, device)
    result = model.load_state_dict(weights, strict=False)
    missing = [k for k in result.missing_keys if "running_" not in k]
    if missing or result.unexpected_keys:
        raise KeyError(f"weights do not fit the port's model: missing {missing[:5]}, "
                       f"unexpected {result.unexpected_keys[:5]}")
    return model, optimizer, make_train_step(model, pcfg, optimizer)


def checked_steps(model, optimizer, step, batches) -> dict:
    """Drive ``step`` through ``batches`` and keep what the check compares
    (as ``reference_steps`` returns it)."""
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    buffers = dict(model.named_buffers())
    bn_start = {k: b.detach().clone() for k, b in buffers.items()}
    beta1 = optimizer.param_groups[0]["betas"][0]
    losses, names, grad, terms = [], None, None, {}
    for i, batch in enumerate(batches):
        metrics = step(batch, i)
        losses.append(metrics["loss_total"])
        if names is None:
            terms = {k: v for k, v in metrics.items() if k != "loss_total"}
            names = [k for k, p in params.items() if "exp_avg" in optimizer.state.get(p, {})]
            grad = leaf_norms(optimizer.state[params[k]]["exp_avg"] / (1.0 - beta1)
                              for k in names).cpu() if names else torch.zeros(0)
    change = leaf_norms(params[k] - start[k] for k in names).cpu() if names else torch.zeros(0)
    bn_names = sorted(buffers)
    bn_change = leaf_norms(buffers[k] - bn_start[k] for k in bn_names).cpu()
    return {"losses": [float(v) for v in losses], "names": names or [], "grad": grad,
            "change": change, "bn_names": bn_names, "bn_change": bn_change,
            "terms": {k: float(v) for k, v in terms.items()}}


# ------------------------------------------------------------------- window
def window(step, feed, seconds: float, first: int, device) -> dict:
    """Steps for ``seconds`` of the host clock; a CUDA event after each; one
    sync at the end. Spans: "loader" (the call that takes the batch) and
    "step" (the step call), host seconds each."""
    cuda = torch.device(device).type == "cuda"
    events = []
    spans = {"loader": [], "step": []}
    metrics = None
    if cuda:
        torch.cuda.synchronize()
        events.append(torch.cuda.Event(enable_timing=True))
        events[0].record()
    t0 = time.perf_counter()
    i = first
    while time.perf_counter() - t0 < seconds:
        a = time.perf_counter()
        batch = feed.next()
        b = time.perf_counter()
        metrics = step(batch, i)
        c = time.perf_counter()
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        spans["loader"].append(b - a)
        spans["step"].append(c - b)
        i += 1
    if cuda:
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    gaps = [events[j].elapsed_time(events[j + 1]) for j in range(len(events) - 1)]
    last = float(metrics["loss_total"]) if metrics is not None else float("nan")
    return {"steps": i - first, "seconds": elapsed, "gaps_ms": gaps, "spans": spans,
            "last_loss": last, "next": i}


def traced(step, feed, steps: int, first: int) -> Trace:
    """``steps`` whole steps under the profiler (CPU and CUDA), after a sync."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(first, first + steps):
            with record_function(STEP_SPAN):
                step(feed.next(), i)
        torch.cuda.synchronize()
    return Trace(prof.events(), steps)


class Phases:
    """Seconds since ``t_start`` at the end of each phase, on standard error."""

    def __init__(self, t_start: float):
        self.t_start = t_start

    def done(self, name: str) -> float:
        t = time.perf_counter() - self.t_start
        print(f"portbench: {name} done at {t:.2f} s", file=sys.stderr, flush=True)
        return t


def percentile(values, q: int) -> float:
    """The q-th percentile (Python's exclusive method)."""
    return statistics.quantiles(values, n=100)[q - 1]


def load_reader(metric: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", PKG / "metrics" / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------- run
def run(cell: SimpleNamespace, seed: int, seconds: float, trace: bool, t_start: float,
        device="cuda") -> dict:
    """One run of ``cell`` (``load_cell``); returns the result line's dict
    (without ``device`` when ``device`` is not a card), the check's numbers
    last."""
    cfg, traffic = cell.cfg, cell.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    phases = Phases(t_start)
    if cuda:
        torch.backends.cudnn.benchmark = True  # one input shape, as the training CLI
    flops_per_step, calls = cached_count(cell.reference, cfg)
    phases.done("count")
    weights = make_weights(parameter_shapes(cell.reference, cfg), seed, dev)
    feed = feeds.make_feed(traffic, cfg, seed, dev)
    try:
        sync()
        phases.done("inputs")
        model, optimizer, step = build_program(cfg, weights, dev)
        sync()
        phases.done("program")
        n_checked = int(traffic["checked_steps"])
        mine = checked_steps(model, optimizer, step, [feed.next() for _ in range(n_checked)])
        sync()
        setup_s = phases.done("checked_steps")

        win = window(step, feed, seconds, n_checked, dev)
        phases.done("window")
        tr = None
        if trace:
            tr = traced(step, feed, int(traffic["trace_steps"]), win["next"])
            phases.done("trace")
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        del model, optimizer, step
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        batches = feed.checked(n_checked)
        ref = reference_steps(cell.reference, cfg, weights, batches, dev)
        phases.done("reference")
        numbers = check.compare(mine, ref, cell.limits)
        if traffic["feed"] == "loader":
            numbers["loader_gap"] = {"value": check.batch_mismatch(feed.taken, batches),
                                     "limit": cell.limits["loader_gap"]}
    finally:
        feed.close()
    numbers["window_loss_finite"] = {
        "value": 1.0 if math.isfinite(win["last_loss"]) else 0.0, "limit": 1.0}
    failed = sum(not check.holds(k, v) for k, v in numbers.items())

    b = cfg["batch_size"]
    steps_per_s = win["steps"] / win["seconds"]
    # attempted: the steps run; failed: the check's numbers outside their limits
    out = {"correct": failed == 0, "attempted": win["steps"] + n_checked, "failed": failed}
    if trace:
        ctx = SimpleNamespace(spans=win["spans"] if traffic["feed"] == "loader" else
                              {"step": win["spans"]["step"]},
                              trace=tr, calls=calls, cfg=cfg,
                              device_name=torch.cuda.get_device_name(dev) if cuda else "cpu")
        metrics = {}
        for m in cell.per_layer:
            v = load_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["metrics"] = metrics
        out["breakdown"] = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
    else:
        card = peaks(torch.cuda.get_device_name(dev)) if cuda else None
        values = {
            "frames_per_s": steps_per_s * b,
            "step_ms_p95": percentile(win["gaps_ms"], 95) if len(win["gaps_ms"]) >= 2 else None,
            "mfu": flops_per_step * steps_per_s / card["flops"]["bfloat16"] if card else None,
            "setup_s": setup_s,
        }
        out["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                          for m in cell.end_to_end if values.get(m["name"]) is not None}
    if cuda:
        out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
                         "memory_peak_bytes": peak}
        if trace:
            out["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
    out["flops_per_step"] = flops_per_step
    out["check"] = numbers
    return out
