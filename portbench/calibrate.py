"""The readings that a cell's limits are set from, in one process.

    python3 -m portbench.calibrate --workload <name> --seeds 12 --controls 3 --out <file>

For each seed: the program's checked steps against the reference's (the
lower readings). For the first ``--controls`` seeds also the control and the
planted faults against the same reference (the upper readings):

- ``control_fp8_ref``: the control, the configuration's next lower
  precision wherever the program computes bf16: the reference itself with
  the frames and every convolution's and dense layer's inputs, weights and
  outputs rounded to float8 e4m3.
- ``control_int8`` (modes that run the depth encoder): the program's own
  lower path, ``encoder_int8``, for the record: it covers 20 of the step's
  convolutions and none of the loss graph.
- ``program_f32``: the program with ``compute_dtype`` float32, which shows
  how much of the program's gap is its bf16 compute.
- ``half_batch``: the program's step on the first half of each batch's rows.
- ``unchanged``: a step that computes the loss and leaves the state
  (parameters, Adam, BatchNorm statistics) as it was.

Prints one JSON line per reading, and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from unsupervised_depth_opticalflow_egomotion_torch.config import loss_weights
from unsupervised_depth_opticalflow_egomotion_torch.parallel.train_step import _forward

from . import check, feeds
from .harness import (build_program, checked_steps, load_cell, make_weights, parameter_shapes,
                      port_config)
from .reference.step import fp8_fake_quant, reference_steps


def half_batch(step):
    def broken(batch, i=None):
        b = batch[0].shape[0] // 2
        return step(tuple(t[:b] for t in batch), i)
    return broken


def unchanged(model, cfg):
    pcfg = port_config(cfg)
    weights = loss_weights(pcfg)

    def broken(batch, i=None):
        buffers = [b.clone() for b in model.buffers()]
        with torch.no_grad():
            pack = _forward(model, pcfg, batch)
            for b, saved in zip(model.buffers(), buffers):
                b.copy_(saved)  # the forward's BatchNorm statistics undone
        return {"loss_total": sum(weights[k] * v.float().mean() for k, v in pack.items())}
    return broken


def program_readings(cfg, weights, batches, device, fault=None) -> dict:
    model, optimizer, step = build_program(cfg, weights, device)
    if fault == "half_batch":
        step = half_batch(step)
    elif fault == "unchanged":
        step = unchanged(model, cfg)
    mine = checked_steps(model, optimizer, step, batches)
    del model, optimizer, step
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return mine


def calibrate(cell, seeds, n_controls: int, device, emit=print) -> list:
    cfg = cell.cfg
    n = int(cell.traffic["checked_steps"])
    shapes = parameter_shapes(cell.reference, cfg)
    int8_control = cfg["mode"] in ("geom", "depth")
    rows = []
    for k, seed in enumerate(seeds):
        weights = make_weights(shapes, seed, device)
        feed = feeds.make_feed(cell.traffic, cfg, seed, device)
        batches = feed.checked(n)
        ref = reference_steps(cell.reference, cfg, weights, batches, device)
        runs = [("program", lambda: program_readings(cfg, weights, batches, device))]
        if k < n_controls:
            # the look: the program's own f32 path against the reference
            runs.append(("program_f32", lambda: program_readings(
                dict(cfg, compute_dtype="float32"), weights, batches, device)))
            if int8_control:
                runs.append(("control_int8", lambda: program_readings(
                    dict(cfg, encoder_int8=True), weights, batches, device)))
            runs.append(("control_fp8_ref", lambda: reference_steps(
                cell.reference, cfg, weights, batches, device, fake_quant=fp8_fake_quant)))
            runs.append(("half_batch", lambda: program_readings(
                cfg, weights, batches, device, "half_batch")))
            runs.append(("unchanged", lambda: program_readings(
                cfg, weights, batches, device, "unchanged")))
        for kind, fn in runs:
            mine = fn()
            row = {"cell": cell.name, "seed": seed, "kind": kind, **check.readings(mine, ref),
                   "terms1": {k: [v, ref["terms"].get(k)] for k, v in mine.get("terms", {}).items()
                              if v or ref["terms"].get(k)}}
            rows.append(row)
            emit(json.dumps(row))
        del weights, feed, batches
        gc.collect()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=2_200_000_000)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cudnn.benchmark = True
    cell = load_cell(args.workload)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    rows = calibrate(cell, seeds, args.controls, torch.device("cuda"),
                     emit=lambda s: print(s, flush=True))
    with open(args.out, "w") as f:
        f.write("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
