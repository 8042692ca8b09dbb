"""Resize primitives with the exact sampling semantics the loss graph needs.

Port of the JAX package's ``ops/interp.py`` (NHWC tensors throughout):

- ``resize_bilinear``: half-pixel-centred bilinear without antialiasing
  (torch ``F.interpolate(mode='bilinear', align_corners=False)``), in the
  closed form for power-of-two ratios (the only ones the training graph
  uses).
- ``resize_area``: adaptive average pooling; for integer ratios an exact
  k x k block mean.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pow2_ratio(src: int, dst: int) -> int | None:
    """Return k for dst == src * 2**k (k<0 = downsample), else None."""
    if src <= 0 or dst <= 0:
        return None
    big, small = (dst, src) if dst >= src else (src, dst)
    if big % small:
        return None
    r = big // small
    if r & (r - 1):
        return None
    return r.bit_length() - 1 if dst >= src else -(r.bit_length() - 1)


def _edge_shifts(y: torch.Tensor, axis: int):
    """(y[i-1], y[i+1]) along ``axis`` with the edges clamped."""
    m = y.shape[axis]
    lo = torch.cat([y.narrow(axis, 0, 1), y.narrow(axis, 0, m - 1)], axis)
    hi = torch.cat([y.narrow(axis, 1, m - 1), y.narrow(axis, m - 1, 1)], axis)
    return lo, hi


def _interleave(phases, axis: int) -> torch.Tensor:
    st = torch.stack(phases, dim=axis + 1)
    shape = list(phases[0].shape)
    shape[axis] *= len(phases)
    return st.reshape(shape)


def _axis_up_pow2(y: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """Factor-n (n = 2**k) half-pixel bilinear upsample along ``axis``.

    Output o = n*i + p samples source coordinate i + f_p with
    f_p = (p + 0.5 - n/2)/n: a fixed 2-tap blend per phase.
    """
    lo, hi = _edge_shifts(y, axis)
    phases = []
    for p in range(n):
        f = (p + 0.5 - n / 2.0) / n
        nb, af = (lo, -f) if f < 0 else (hi, f)
        phases.append(y * (1.0 - af) + nb * af)
    return _interleave(phases, axis)


def _axis_down_pow2(y: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """Factor-1/n half-pixel bilinear downsample: the mean of the two middle
    elements of each n-block."""
    c0 = n // 2 - 1
    idx = torch.arange(c0, y.shape[axis], n, device=y.device)
    a = y.index_select(axis, idx)
    b = y.index_select(axis, idx + 1)
    return (a + b) * 0.5


def resize_bilinear(x: torch.Tensor, hw) -> torch.Tensor:
    """Bilinear resize (align_corners=False, no antialias) of NHWC ``x``."""
    _, h, w, _ = x.shape
    nh, nw = int(hw[0]), int(hw[1])
    if (nh, nw) == (h, w):
        return x
    kh, kw = _pow2_ratio(h, nh), _pow2_ratio(w, nw)
    if kh is None or kw is None:
        y = F.interpolate(
            x.permute(0, 3, 1, 2), size=(nh, nw), mode="bilinear",
            align_corners=False, antialias=False,
        )
        return y.permute(0, 2, 3, 1)
    y = x
    for axis, k in ((1, kh), (2, kw)):
        if k > 0:
            y = _axis_up_pow2(y, axis, 1 << k)
        elif k < 0:
            y = _axis_down_pow2(y, axis, 1 << -k)
    return y


def resize_area(x: torch.Tensor, hw) -> torch.Tensor:
    """Area (block-mean) downsample of NHWC ``x`` by integer factors."""
    b, h, w, c = x.shape
    nh, nw = int(hw[0]), int(hw[1])
    if (nh, nw) == (h, w):
        return x
    if h % nh or w % nw:
        raise NotImplementedError(
            f"resize_area needs integer factors; got {(h, w)} -> {(nh, nw)}"
        )
    kh, kw = h // nh, w // nw
    return x.reshape(b, nh, kh, nw, kw, c).sum(dim=(2, 4)) / (kh * kw)


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear upsample (align_corners=False) of NHWC ``x``: output row
    2i = 0.75*y[i] + 0.25*y[i-1], row 2i+1 = 0.75*y[i] + 0.25*y[i+1]
    (edges clamped), then the same along columns."""

    def axis_up(y, axis):
        lo, hi = _edge_shifts(y, axis)
        return _interleave([0.75 * y + 0.25 * lo, 0.75 * y + 0.25 * hi], axis)

    return axis_up(axis_up(x, 1), 2)


def image_pyramid(img: torch.Tensor, num_scales: int, mode: str = "bilinear"):
    """Multi-scale pyramid [full, 1/2, 1/4, ...] of an NHWC image."""
    h, w = img.shape[1], img.shape[2]
    fn = resize_bilinear if mode == "bilinear" else resize_area
    return [fn(img, (h // (2**s), w // (2**s))) for s in range(num_scales)]
