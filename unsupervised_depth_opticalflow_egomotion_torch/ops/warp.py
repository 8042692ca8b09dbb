"""Bilinear sampling and flow warping (NHWC), and the warp-gather kernel.

Port of the JAX package's ``ops/warp.py``. Normalized coordinates in
[-1, 1] map to pixels with the align_corners=True ("exact") convention:
pixel 0 at -1, pixel N-1 at +1. Bilinear taps, zeros padding, and the
pre-clipped patch-start weight form (``_pos_weights``): the 2x2 patch
starts at clip(floor(i), 0, size-2) and each patch position carries the
weight of whichever in-bounds tap lands on it.

Two samplers:

- ``warp_gather`` (the kernel): every 3-channel DATA source (a uint8 camera
  frame, or a float image declared with ``src_is_data``). On a CUDA tensor
  it launches csrc/warp_gather.cu; on a CPU tensor it runs
  ``warp_gather_plain``. Its forward also returns the analytic derivative
  planes, so ``WarpGather``'s backward is elementwise; gradients flow to
  the coordinates only (the source is data).
- ``_sample_plain``: float activation sources (the PWC feature warps), which
  need a gradient to the source; plain PyTorch on every device, as the JAX
  package keeps them on XLA.

``warp_flow(use_mask=True)``'s validity mask is computed analytically from
the weight sum (the sample of an all-ones image), and uint8 sources fold
1/255 into the weights after the gather.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_lib import DTYPE_CODE, CudaKernel, check_cuda_tensor

_P = ctypes.c_void_p
_I = ctypes.c_int

WARP_GATHER = CudaKernel(
    "warp_gather", "warp_gather",
    [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I],
)


def pixel_grid(h: int, w: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """[H,W,2] grid of (x, y) pixel coordinates."""
    yy, xx = torch.meshgrid(
        torch.arange(h, device=device, dtype=dtype),
        torch.arange(w, device=device, dtype=dtype),
        indexing="ij",
    )
    return torch.stack([xx, yy], dim=-1)


def normalize_coords(coords_px: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Pixel coords [..., 2] (x, y) -> normalized [-1, 1] (align_corners=True)."""
    gx = 2.0 * coords_px[..., 0] / max(w - 1, 1) - 1.0
    gy = 2.0 * coords_px[..., 1] / max(h - 1, 1) - 1.0
    return torch.stack([gx, gy], dim=-1)


def _pos_weights(i: torch.Tensor, size: int):
    """Pre-clipped patch-start bilinear weights along one axis.

    Returns (start int64 in [0, size-2], w0, w1, dw0, dw1): the weights of
    patch positions start / start+1 under zeros padding and their
    derivatives with respect to ``i`` (floor contributes zero).
    """
    i0 = torch.floor(i)
    frac = i - i0
    inb_lo = (i0 >= 0) & (i0 <= size - 1)
    inb_hi = (i0 >= -1) & (i0 <= size - 2)
    start = torch.clamp(i0, 0.0, float(size - 2))

    def pos(k):
        p = start + k
        sel_lo = (inb_lo & (p == i0)).to(i.dtype)
        sel_hi = (inb_hi & (p == i0 + 1)).to(i.dtype)
        return sel_lo * (1.0 - frac) + sel_hi * frac, sel_hi - sel_lo

    (w0, dw0), (w1, dw1) = pos(0.0), pos(1.0)
    return start.long(), w0, w1, dw0, dw1


def _gather_taps(src: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor):
    """The 2x2 patch [B,Ho,Wo,C] x4 (00, 01, 10, 11) at patch starts ys/xs."""
    b, h, w, c = src.shape
    flat = src.reshape(b * h * w, c)
    base = (
        torch.arange(b, device=src.device).view(b, 1, 1) * (h * w) + ys * w + xs
    ).reshape(-1)
    shape = ys.shape + (c,)
    return tuple(
        flat.index_select(0, base + off).reshape(shape) for off in (0, 1, w, w + 1)
    )


def warp_gather_plain(src, ix, iy, out_dtype):
    """Plain PyTorch version of the warp-gather kernel (same outputs)."""
    _, h, w, _ = src.shape
    scale = 1.0 / 255.0 if src.dtype == torch.uint8 else 1.0
    ys, wy0, wy1, dwy0, dwy1 = _pos_weights(iy.float(), h)
    xs, wx0, wx1, dwx0, dwx1 = _pos_weights(ix.float(), w)
    a00, a01, a10, a11 = (t.float() for t in _gather_taps(src, ys, xs))
    e = lambda t: t[..., None]  # noqa: E731
    row0 = e(wx0) * a00 + e(wx1) * a01
    row1 = e(wx0) * a10 + e(wx1) * a11
    val = e(wy0) * row0 + e(wy1) * row1
    dx = e(wy0) * (e(dwx0) * a00 + e(dwx1) * a01) + e(wy1) * (
        e(dwx0) * a10 + e(dwx1) * a11
    )
    dy = e(dwy0) * row0 + e(dwy1) * row1
    rgb = (val * scale).to(out_dtype)
    wsum = e((wy0 + wy1) * (wx0 + wx1)).to(out_dtype)
    dplanes = torch.cat([dx * scale, dy * scale], dim=-1)
    return rgb, wsum, dplanes


def warp_gather(src, ix, iy, out_dtype):
    """Bilinear sample a 3-channel image [B,H,W,3] at pixel coords ix/iy.

    ``ix``/``iy`` are f32 [B,Ho,Wo]. Returns (rgb [B,Ho,Wo,3] and
    weight_sum [B,Ho,Wo,1] in ``out_dtype``, derivative planes f32
    [B,Ho,Wo,6] = d(rgb)/dix, d(rgb)/diy). uint8 sources are scaled by
    1/255. CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    if src.device.type == "cpu":
        return warp_gather_plain(src, ix, iy, out_dtype)
    b, h, w, c = src.shape
    _, ho, wo = ix.shape
    check_cuda_tensor("src", src, (torch.uint8, torch.bfloat16, torch.float32))
    if c != 3 or ix.shape[0] != b:
        raise ValueError(f"warp_gather: src {tuple(src.shape)}, coords {tuple(ix.shape)}")
    check_cuda_tensor("ix", ix, (torch.float32,), (b, ho, wo))
    check_cuda_tensor("iy", iy, (torch.float32,), (b, ho, wo))
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"warp_gather: out_dtype {out_dtype}")
    rgb = torch.empty((b, ho, wo, 3), device=src.device, dtype=out_dtype)
    wsum = torch.empty((b, ho, wo, 1), device=src.device, dtype=out_dtype)
    dplanes = torch.empty((b, ho, wo, 6), device=src.device, dtype=torch.float32)
    WARP_GATHER(
        src.data_ptr(), DTYPE_CODE[src.dtype], ix.data_ptr(), iy.data_ptr(),
        rgb.data_ptr(), wsum.data_ptr(), dplanes.data_ptr(),
        DTYPE_CODE[out_dtype], b, h, w, ho, wo,
    )
    return rgb, wsum, dplanes


def warp_coord_vjp(dplanes, g_rgb, g_w, ix, iy, h: int, w: int):
    """Elementwise coordinate VJP of ``warp_gather`` (the TPU package's
    ``_warp_u8_fused_bwd``): the rgb cotangent against the derivative
    planes, plus the weight-sum cotangent from the analytic weights."""
    dix = diy = None
    if g_rgb is not None:
        g = g_rgb.float()
        dix = (g * dplanes[..., 0:3]).sum(-1)
        diy = (g * dplanes[..., 3:6]).sum(-1)
    if g_w is not None:
        _, wy0, wy1, dwy0, dwy1 = _pos_weights(iy, h)
        _, wx0, wx1, dwx0, dwx1 = _pos_weights(ix, w)
        gw = g_w[..., 0].float()
        ex = gw * (wy0 + wy1) * (dwx0 + dwx1)
        ey = gw * (dwy0 + dwy1) * (wx0 + wx1)
        dix = ex if dix is None else dix + ex
        diy = ey if diy is None else diy + ey
    return dix, diy


class WarpGather(torch.autograd.Function):
    """``warp_gather`` with the elementwise coordinate backward."""

    @staticmethod
    def forward(ctx, src, ix, iy, out_dtype):
        rgb, wsum, dplanes = warp_gather(src, ix, iy, out_dtype)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(dplanes, ix, iy)
        ctx.src_hw = (src.shape[1], src.shape[2])
        return rgb, wsum

    @staticmethod
    def backward(ctx, g_rgb, g_w):
        dplanes, ix, iy = ctx.saved_tensors
        dix, diy = warp_coord_vjp(dplanes, g_rgb, g_w, ix, iy, *ctx.src_hw)
        return None, dix, diy, None


def _sample_plain(img, ix, iy, dtype, scale):
    """Differentiable bilinear sample (source and coordinate gradients)."""
    _, h, w, _ = img.shape
    ys, wy0, wy1, _, _ = _pos_weights(iy, h)
    xs, wx0, wx1, _, _ = _pos_weights(ix, w)
    t00, t01, t10, t11 = (t.to(dtype) for t in _gather_taps(img, ys, xs))
    wy0, wy1, wx0, wx1 = (t.to(dtype)[..., None] for t in (wy0, wy1, wx0, wx1))
    out = (
        t00 * (wy0 * wx0 * scale)
        + t01 * (wy0 * wx1 * scale)
        + t10 * (wy1 * wx0 * scale)
        + t11 * (wy1 * wx1 * scale)
    )
    return out, (wy0 + wy1) * (wx0 + wx1)


def grid_sample_with_weight(img, coords, out_dtype=None, src_is_data=False):
    """Bilinear sample NHWC ``img`` at normalized ``coords`` [B,Ho,Wo,2].

    Returns (sampled [B,Ho,Wo,C], weight_sum [B,Ho,Wo,1]). 3-channel data
    sources (uint8, or float with ``src_is_data``) go to the warp-gather
    kernel; other sources take the differentiable plain sampler.
    """
    _, h, w, c = img.shape
    is_u8 = img.dtype == torch.uint8
    if is_u8:
        dtype = out_dtype if out_dtype is not None else torch.bfloat16
    else:
        dtype = img.dtype if out_dtype is None else out_dtype
    coords = coords.float()
    ix = (coords[..., 0] + 1.0) * 0.5 * (w - 1)
    iy = (coords[..., 1] + 1.0) * 0.5 * (h - 1)
    if c == 3 and (is_u8 or src_is_data):
        return WarpGather.apply(
            img.detach().contiguous(), ix.contiguous(), iy.contiguous(), dtype
        )
    return _sample_plain(img, ix, iy, dtype, 1.0 / 255.0 if is_u8 else 1.0)


def grid_sample(img, coords, out_dtype=None, src_is_data=False):
    """Bilinear sample (see ``grid_sample_with_weight``), values only."""
    return grid_sample_with_weight(img, coords, out_dtype, src_is_data)[0]


def flow_coords(flow: torch.Tensor) -> torch.Tensor:
    """Normalized sampling coords [B,H,W,2] for a backward flow warp (f32)."""
    _, h, w, _ = flow.shape
    grid = pixel_grid(h, w, device=flow.device)[None]
    return normalize_coords(grid + flow.float(), h, w)


def warp_flow(x, flow, use_mask: bool = False, out_dtype=None, src_is_data=False):
    """Backward-warp NHWC ``x`` by optical flow [B,H,W,2].

    With ``use_mask`` the result is multiplied by the hard validity mask
    (weight sum >= 0.9999), computed analytically from the tap weights.
    """
    out, weight = grid_sample_with_weight(
        x, flow_coords(flow), out_dtype=out_dtype, src_is_data=src_is_data
    )
    if use_mask:
        mask = torch.logical_not(weight < 0.9999).to(out.dtype)
        return out * mask
    return out
