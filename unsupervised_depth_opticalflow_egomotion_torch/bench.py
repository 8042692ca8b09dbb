"""Benchmark of the port: the train step's frames/s on one CUDA card, one JSON line.

    python -m unsupervised_depth_opticalflow_egomotion_torch.bench

The port of the repository's ``bench.py``: the same settings, ``Config``,
batch, metric string and keys, on one card. Needs a CUDA card (``Bench``
takes ``device="cpu"`` for the tests, through the kernels' plain versions).

Settings, from the environment, with ``bench.py``'s defaults and meanings:
``BENCH_BATCH`` (8), ``BENCH_MODE`` (geom | flow | depth), ``BENCH_FLOW_OCC``
(``Config.flow_occ_impl``, unset: the Config's), ``BENCH_LOSS_SCALE`` (0),
``BENCH_WARP_IMPL`` (pallas_fused), ``BENCH_WARP_BF16`` (1),
``BENCH_PACKED_ENCODER`` / ``BENCH_PACKED_STEM`` (0; accepted, and they
change nothing in the port: ``models/depth_net.py``), ``BENCH_WARP_GUARD``
(1; the port's gathers have no window to guard) and ``BENCH_INT8`` (0).

The step: ``Config(img_hw=(256, 832), compute_dtype="bfloat16", ...)``,
weights from the port's seed-0 initialisation (``parallel.init_state``),
uint8 frames ``[B, 3H, W, 3]`` from ``np.random.RandomState(0)`` and the K
pyramid of fx 241, fy 245. One step counts the FLOPs, ``WARMUP_STEPS`` warm
up (cuDNN picks its algorithms), then ``iters`` steps are timed on the host
clock; fetching the last ``loss_total`` forces completion.

The line: ``metric`` (``bench.py``'s string for the same settings, with its
literal ``b8``), ``value`` (frames/s on the card: this process's one card),
``unit``, ``vs_baseline`` (against ``bench.py``'s 40 frames/s anchor, derived
in BASELINE.md for the reference on an A100), ``flops_per_step`` and ``mfu``
(the FLOPs a second over the card's dense bf16 peak, ``utils/hardware.py``;
no ``mfu`` for a device that table lacks).

``flops_per_step`` is one step's count of two parts: ``FlopCounterMode``'s
count of the matrix work (convolutions forward and backward, matrix
products, the int8 encoder's int64 matmul on the CPU), and ``ops/flops.py``'s
count of the hand-written kernels' functions (cost volume, SSIM, warp
gather, splat), whichever route computes them, and of the int8 encoder's
``torch._int_mm`` under ``BENCH_INT8=1`` on the card (at the convolution's
own K, not the padded one: the same count as the CPU's). It
counts no elementwise work (activations, BatchNorm, the loss graph's
masks, the optimizer), where XLA's ``cost_analysis`` in ``bench.py`` counts
all of it: the two packages' ``flops_per_step`` and ``mfu`` measure different
things and are not to be compared.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from .config import Config
from .ops import flops as kernel_flops
from .parallel import init_state, make_train_step
from .utils import resolve_device
from .utils.hardware import peaks

BASELINE_A100_FPS = 40.0  # bench.py's anchor (BASELINE.md, "Reference throughput")
HW = (256, 832)
WARMUP_STEPS = 2


@dataclass(frozen=True)
class Settings:
    """``bench.py``'s environment settings, parsed as it parses them."""

    batch_size: int = 8
    mode: str = "geom"
    flow_occ: str = ""
    loss_scale: int = 0
    warp_impl: str = "pallas_fused"
    warp_bf16: bool = True
    packed_encoder: bool = False
    packed_stem: bool = False
    warp_guard: bool = True
    encoder_int8: bool = False

    @classmethod
    def from_env(cls, env=None) -> "Settings":
        env = os.environ if env is None else env
        return cls(
            batch_size=int(env.get("BENCH_BATCH", "8")),
            mode=env.get("BENCH_MODE", "geom"),
            flow_occ=env.get("BENCH_FLOW_OCC", ""),
            loss_scale=int(env.get("BENCH_LOSS_SCALE", "0")),
            warp_impl=env.get("BENCH_WARP_IMPL", "pallas_fused"),
            warp_bf16=bool(int(env.get("BENCH_WARP_BF16", "1"))),
            packed_encoder=bool(int(env.get("BENCH_PACKED_ENCODER", "0"))),
            packed_stem=bool(int(env.get("BENCH_PACKED_STEM", "0"))),
            warp_guard=bool(int(env.get("BENCH_WARP_GUARD", "1"))),
            encoder_int8=bool(int(env.get("BENCH_INT8", "0"))),
        )

    def config(self) -> Config:
        return Config(
            img_hw=HW, mode=self.mode, compute_dtype="bfloat16",
            batch_size=self.batch_size, loss_base_scale=self.loss_scale,
            warp_impl=self.warp_impl, warp_bf16=self.warp_bf16, warp_guard=self.warp_guard,
            packed_encoder=self.packed_encoder, packed_stem=self.packed_stem,
            encoder_int8=self.encoder_int8,
            **({"flow_occ_impl": self.flow_occ} if self.flow_occ else {}),
        )

    def metric(self) -> str:
        """``bench.py``'s metric string, its tag logic and literal ``b8``."""
        tag = f", loss_scale={self.loss_scale}" if self.loss_scale else ""
        if self.mode != "geom":
            tag += f", mode={self.mode}"
            if self.flow_occ:
                tag += f", occ={self.flow_occ}"
        return f"frames/sec/chip joint depth+flow+pose fwd-bwd (b8 256x832 bf16{tag})"


def make_batch(batch_size: int, h: int, w: int, device) -> tuple:
    """``bench.py``'s batch: uint8 frames [B, 3h, w, 3] from RandomState(0)
    and the [B, 3, 3, 3] K and K^-1 pyramids (fx 241, fy 245, halved a scale)."""
    rng = np.random.RandomState(0)
    images = (rng.rand(batch_size, 3 * h, w, 3) * 255).astype(np.uint8)
    K = np.array([[241.0, 0, w / 2], [0, 245.0, h / 2], [0, 0, 1]], np.float32)
    K_ms = np.stack([np.diag([1 / 2**s, 1 / 2**s, 1.0]).astype(np.float32) @ K for s in range(3)])
    K_inv_ms = np.stack([np.linalg.inv(k) for k in K_ms])
    tile = lambda x: np.tile(x[None], (batch_size, 1, 1, 1))  # noqa: E731
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                 for x in (images, tile(K_ms), tile(K_inv_ms)))


def _uncounted(*args, **kwargs) -> int:
    return 0


# the card's int8 convolutions count their GEMMs themselves (``ops/
# int8_conv.py``, at the unpadded K), so ``FlopCounterMode`` must not count
# ``torch._int_mm`` where torch has a formula for it
MATRIX_MAPPING = {torch.ops.aten._int_mm: _uncounted}


class Bench:
    """One configuration's model, optimizer, step and batch on a device; the
    step number goes on across ``run`` calls (it seeds the sampled losses'
    draws)."""

    def __init__(self, cfg: Config, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model, self.optimizer = init_state(cfg, self.device)
        self.train_step = make_train_step(self.model, cfg, self.optimizer)
        self.batch = make_batch(cfg.batch_size, *cfg.img_hw, self.device)
        self.steps = 0
        self.metrics = None
        self.seconds_per_step = None  # of the last run's timed steps

    def step(self) -> dict:
        self.metrics = self.train_step(self.batch, self.steps)
        self.steps += 1
        return self.metrics

    def count_flops(self) -> tuple[int, int]:
        """One step under ``FlopCounterMode`` and ``ops/flops.counting()``:
        (the matrix work's FLOPs, the kernels' functions' FLOPs)."""
        with FlopCounterMode(display=False, custom_mapping=MATRIX_MAPPING) as matrix, \
                kernel_flops.counting() as kernels:
            self.step()
            float(self.metrics["loss_total"])
        return matrix.get_total_flops(), kernels.total


def run(bench: Bench, metric: str, iters: int = 20, count_flops: bool = True) -> dict:
    """Time ``iters`` train steps of ``bench`` (after the FLOP count and the
    warm-up; its model goes on training from where it stands) and return
    ``bench.py``'s line as a dict, under ``metric`` (``Settings.metric()``)."""
    if bench.device.type == "cuda":
        torch.backends.cudnn.benchmark = True  # one input shape, as the training CLI
    counted = bench.count_flops() if count_flops else None
    for _ in range(WARMUP_STEPS):
        bench.step()
    float(bench.metrics["loss_total"])
    t0 = time.perf_counter()
    for _ in range(iters):
        bench.step()
    float(bench.metrics["loss_total"])
    bench.seconds_per_step = (time.perf_counter() - t0) / iters

    steps_per_s = 1.0 / bench.seconds_per_step
    fps = steps_per_s * bench.cfg.batch_size
    line = {
        "metric": metric,
        "value": round(fps, 2),
        "unit": "frames/s/chip",
        "vs_baseline": round(fps / BASELINE_A100_FPS, 3),
    }
    if counted is not None:
        total = float(sum(counted))
        line["flops_per_step"] = total
        card = peaks(torch.cuda.get_device_name(bench.device)) if bench.device.type == "cuda" else None
        if card is not None:
            line["mfu"] = round(total * steps_per_s / card.flops["bfloat16"], 4)
    return line


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main() -> None:
    settings = Settings.from_env()
    device = resolve_device()  # raises without a card
    print(f"bench: {torch.cuda.get_device_name(device)} | nvidia-smi: {card_line()}",
          file=sys.stderr, flush=True)
    print(json.dumps(run(Bench(settings.config(), device), settings.metric())), flush=True)


if __name__ == "__main__":
    main()
