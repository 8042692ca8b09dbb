"""Peak rates of the cards the port is measured on, by the name CUDA gives them.

The port's own counterpart of ``bench.py``'s ``PEAK_FLOPS`` table (there keyed
by TPU device kind). One place for the numbers that turn a measured time into
a share of the card: ``bench.py``'s ``mfu`` (the step's FLOPs per second over
the dense bf16 peak) and the kernels' bounds (``bound_ms``: the larger of the
bytes over the memory rate and the operations over the peak of their type).

NVIDIA H100 SXM data sheet: HBM3 3.35 TB/s; dense bf16 (tensor cores) 989
TFLOP/s; f32 (CUDA cores) 67 TFLOP/s.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Peaks:
    """A card's memory rate (bytes/s) and dense FLOP/s by input type."""

    hbm_bytes_per_s: float
    flops: dict


PEAKS = {
    "NVIDIA H100 80GB HBM3": Peaks(3.35e12, {"bfloat16": 989e12, "float32": 67e12}),
}


def peaks(device_name: str) -> Peaks | None:
    """The table's entry for a card (``torch.cuda.get_device_name()``), or
    None for a device it does not list (a CPU, another card)."""
    return PEAKS.get(device_name)


def bound_ms(nbytes: float, flops: float, dtype: str, device_name: str) -> tuple[float, str]:
    """The least time (ms) the card could take to move ``nbytes`` and do
    ``flops`` operations on inputs of ``dtype``, and which of the two bounds
    it ("bytes" or "operations"). Raises for a card the table lacks."""
    p = peaks(device_name)
    if p is None:
        raise KeyError(f"no peak rates for {device_name!r}: add it to utils/hardware.PEAKS")
    t_bytes = nbytes / p.hbm_bytes_per_s * 1e3
    t_ops = flops / p.flops[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
