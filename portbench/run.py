"""Run one benchmark cell once and print its result as one JSON line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics (and ``device.busy_s`` /
``window_s`` and a ``breakdown``) from a traced span after the window. The
check's numbers, each beside its limit, come last in the line and as the
last lines of standard error. Exits non-zero, printing no result, without a
CUDA card, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "unsupervised_depth_opticalflow_egomotion_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("portbench: no CUDA card", file=sys.stderr)
        return 2
    from portbench.harness import load_cell, run

    out = run(load_cell(args.workload), args.seed, args.seconds, bool(args.trace), T_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    for k, v in out["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
