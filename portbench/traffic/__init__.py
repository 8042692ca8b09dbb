"""The one traffic generator: frame stacks and intrinsics from a seed.

A traffic mix is a JSON file beside this module, named by the cell's
``traffic``; this module reads it. The frames follow ``chip_smoke.py``'s
``_prepared_dataset`` at commit 6d2cb1d (copied, frozen): each stack is a
smooth random texture (per channel a sum of ``waves`` sinusoids with spatial
frequencies in ``freq`` and a random phase, stretched to 0..255) seen three
times, shifted by a whole-pixel motion of at most ``max_shift_px`` from frame
to frame, stacked vertically as a prepared KITTI sample [3H, W, 3] uint8.
Added to the copy: each stack's contrast about mid-grey is drawn from
``contrast``, so that the rows of a batch differ in brightness range as
driving frames do (and a step that drops rows, or takes the batch's
statistics over a part of it, reads otherwise).
The intrinsics are its calibration line (fx, fy, the image centre), in the
per-scale pyramid the loader makes (rows 0 and 1 halved a scale) with their
inverses.

Every draw comes from one ``torch.Generator`` seeded from ``--seed``, so a
seed gives the same stacks on every run; every seed gives stacks of the same
sizes.
"""

from __future__ import annotations

import json
import struct
import zlib
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


def load(name: str) -> dict:
    with open(HERE / f"{name}.json") as f:
        return json.load(f)


def stacks(n: int, h: int, w: int, tex: dict, gen: torch.Generator, device) -> torch.Tensor:
    """``n`` uint8 frame stacks [n, 3h, w, 3] on ``device``."""
    m, waves = int(tex["margin"]), int(tex["waves"])
    lo, hi = tex["freq"]
    shift = int(tex["max_shift_px"])
    if shift > m // 2:
        raise ValueError("max_shift_px must leave the crops inside the margin")
    fy = torch.rand((n, 3, waves), generator=gen, device=device) * (hi - lo) + lo
    fx = torch.rand((n, 3, waves), generator=gen, device=device) * (hi - lo) + lo
    ph = torch.rand((n, 3, waves), generator=gen, device=device) * 6.3
    d = torch.randint(-shift, shift + 1, (n, 2), generator=gen, device=device)
    c_lo, c_hi = tex["contrast"]
    contrast = (torch.rand(n, generator=gen, device=device) * (c_hi - c_lo) + c_lo).tolist()
    yy = torch.arange(h + 2 * m, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w + 2 * m, device=device, dtype=torch.float32)[None, :]
    out = torch.empty((n, 3 * h, w, 3), dtype=torch.uint8, device=device)
    for i in range(n):
        t = torch.zeros((3, h + 2 * m, w + 2 * m), device=device)
        for c in range(3):
            for k in range(waves):
                t[c] += torch.sin(fy[i, c, k] * yy + fx[i, c, k] * xx + ph[i, c, k])
        t = 0.5 + ((t - t.min()) / (t.max() - t.min()) - 0.5) * contrast[i]
        t = t * 255.0
        dy, dx = int(d[i, 0]), int(d[i, 1])
        frames = [t[:, m + k * dy:m + k * dy + h, m + k * dx:m + k * dx + w] for k in (-1, 0, 1)]
        out[i] = torch.cat(frames, 1).permute(1, 2, 0).to(torch.uint8)
    return out


def intrinsics(h: int, w: int, num_scales: int, fx: float, fy: float):
    """(K_ms, K_inv_ms) [num_scales, 3, 3] float32 for a calibration line."""
    K = np.array([[fx, 0.0, w / 2], [0.0, fy, h / 2], [0.0, 0.0, 1.0]])
    K_ms, K_inv = [], []
    for s in range(num_scales):
        k = K.copy()
        k[:2] /= 2 ** s
        K_ms.append(k)
        K_inv.append(np.linalg.inv(k))
    return (torch.from_numpy(np.stack(K_ms).astype(np.float32)),
            torch.from_numpy(np.stack(K_inv).astype(np.float32)))


def write_png(path: str, rgb: np.ndarray) -> None:
    """An 8-bit RGB PNG, filter 0, zlib level 1 (``chip_smoke.py``'s writer)."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + chunk(b"IEND", b""))
