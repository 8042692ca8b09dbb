"""Bilinear sampling and flow warping (NHWC), and the warp-gather kernel.

Port of the JAX package's ``ops/warp.py``. Normalized coordinates in
[-1, 1] map to pixels with the align_corners=True ("exact") convention:
pixel 0 at -1, pixel N-1 at +1. Bilinear taps, zeros padding, and the
pre-clipped patch-start weight form (``_pos_weights``): the 2x2 patch
starts at clip(floor(i), 0, size-2) and each patch position carries the
weight of whichever in-bounds tap lands on it.

Two samplers:

- the warp-gather kernels (csrc/warp_gather.cu): every 3-channel DATA source
  (a uint8 camera frame, or a float image declared with ``src_is_data``);
  gradients flow to the coordinates only (the source is data). On a CUDA
  tensor each wrapper launches its kernel; on a CPU tensor it runs its plain
  version. ``WarpRoute.impl`` (``Config.warp_impl``) picks the form:
  "pallas_fused" = ``WarpGather``: the forward (``WARP_GATHER``) also writes
  the analytic derivative planes, so the backward is elementwise;
  "pallas" = ``WarpRegather``: the forward (``WARP_GATHER_NOGRAD``) writes
  no planes and saves only the source and the coordinates, and the backward
  kernel (``WARP_GATHER_BWD``) gathers the taps again; "xla" = the plain
  sampler below on every device. ``WarpRoute.bf16=False``
  (``Config.warp_bf16``) sends float data sources to the plain sampler and
  keeps the kernel for uint8 ones.
- ``_sample_plain``: float activation sources (the PWC feature warps), which
  need a gradient to the source; plain PyTorch on every device, as the JAX
  package keeps them on XLA.

``warp_flow(use_mask=True)``'s validity mask is computed analytically from
the weight sum (the sample of an all-ones image), and uint8 sources fold
1/255 into the weights after the gather.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from .cuda_lib import DTYPE_CODE, CudaKernel, check_cuda_tensor

_P = ctypes.c_void_p
_I = ctypes.c_int

WARP_GATHER = CudaKernel(
    "warp_gather", "warp_gather",
    [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I],
)
WARP_GATHER_NOGRAD = CudaKernel(
    "warp_gather", "warp_gather_nograd",
    [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I],
)
WARP_GATHER_BWD = CudaKernel(
    "warp_gather", "warp_gather_bwd",
    [_P, _I, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I],
    optional=(4, 5),  # g_rgb, g_w
)

WARP_IMPLS = ("xla", "pallas", "pallas_fused")


@dataclass(frozen=True)
class WarpRoute:
    """``Config.warp_impl`` and ``Config.warp_bf16``, as the samplers take them."""

    impl: str = "pallas_fused"
    bf16: bool = True

    def __post_init__(self):
        if self.impl not in WARP_IMPLS:
            raise ValueError(f"warp_impl must be one of {WARP_IMPLS}, got {self.impl!r}")


DEFAULT_ROUTE = WarpRoute()


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


def _check_gather_args(src, ix, iy, dtype) -> None:
    """Validate the tensors of a warp-gather launch (``dtype``: the type of
    the outputs, or of the cotangents)."""
    b, _, _, c = src.shape
    check_cuda_tensor("src", src, (torch.uint8, torch.bfloat16, torch.float32))
    if c != 3 or ix.dim() != 3 or ix.shape[0] != b:
        raise ValueError(f"warp_gather: src {tuple(src.shape)}, coords {tuple(ix.shape)}")
    check_cuda_tensor("ix", ix, (torch.float32,))
    check_cuda_tensor("iy", iy, (torch.float32,), ix.shape)
    if dtype not in (torch.bfloat16, torch.float32) or (
        src.dtype == torch.float32 and dtype != torch.float32
    ):
        raise TypeError(f"warp_gather: dtype {dtype} with a {src.dtype} source")


def warp_gather(src, ix, iy, out_dtype):
    """Bilinear sample a 3-channel image [B,H,W,3] at pixel coords ix/iy.

    ``ix``/``iy`` are f32 [B,Ho,Wo]. Returns (rgb [B,Ho,Wo,3] and
    weight_sum [B,Ho,Wo,1] in ``out_dtype``, derivative planes f32
    [B,Ho,Wo,6] = d(rgb)/dix, d(rgb)/diy). uint8 sources are scaled by
    1/255. CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    if src.is_cpu:
        return warp_gather_plain(src, ix, iy, out_dtype)
    _check_gather_args(src, ix, iy, out_dtype)
    b, h, w, _ = src.shape
    _, ho, wo = ix.shape
    rgb = src.new_empty((b, ho, wo, 3), dtype=out_dtype)
    wsum = src.new_empty((b, ho, wo, 1), dtype=out_dtype)
    dplanes = src.new_empty((b, ho, wo, 6), dtype=torch.float32)
    WARP_GATHER(
        src.data_ptr(), DTYPE_CODE[src.dtype], ix.data_ptr(), iy.data_ptr(),
        rgb.data_ptr(), wsum.data_ptr(), dplanes.data_ptr(),
        DTYPE_CODE[out_dtype], b, h, w, ho, wo,
    )
    return rgb, wsum, dplanes


def warp_gather_nograd(src, ix, iy, out_dtype):
    """``warp_gather`` without the derivative planes: (rgb, weight_sum)."""
    if src.is_cpu:
        return warp_gather_plain(src, ix, iy, out_dtype)[:2]
    _check_gather_args(src, ix, iy, out_dtype)
    b, h, w, _ = src.shape
    _, ho, wo = ix.shape
    rgb = src.new_empty((b, ho, wo, 3), dtype=out_dtype)
    wsum = src.new_empty((b, ho, wo, 1), dtype=out_dtype)
    WARP_GATHER_NOGRAD(
        src.data_ptr(), DTYPE_CODE[src.dtype], ix.data_ptr(), iy.data_ptr(),
        rgb.data_ptr(), wsum.data_ptr(), DTYPE_CODE[out_dtype], b, h, w, ho, wo,
    )
    return rgb, wsum


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


def warp_gather_backward_plain(src, ix, iy, g_rgb, g_w):
    """Plain PyTorch version of the re-gather backward kernel: the
    elementwise VJP fed by the plain forward's derivative planes."""
    _, h, w, _ = src.shape
    dplanes = warp_gather_plain(src, ix, iy, torch.float32)[2]
    dix, diy = warp_coord_vjp(dplanes, g_rgb, g_w, ix, iy, h, w)
    if dix is None:
        dix, diy = torch.zeros_like(ix), torch.zeros_like(iy)
    return dix, diy


def warp_gather_backward(src, ix, iy, g_rgb, g_w):
    """Coordinate VJP (dix, diy f32 [B,Ho,Wo]) of ``warp_gather_nograd`` for
    the cotangents ``g_rgb`` [B,Ho,Wo,3] and ``g_w`` [B,Ho,Wo,1] (either may
    be None), by gathering the taps again. CUDA tensors launch the kernel;
    CPU tensors take the plain version."""
    if src.is_cpu:
        return warp_gather_backward_plain(src, ix, iy, g_rgb, g_w)
    given = [g for g in (g_rgb, g_w) if g is not None]
    if not given:
        return torch.zeros_like(ix), torch.zeros_like(iy)
    _check_gather_args(src, ix, iy, given[0].dtype)
    b, h, w, _ = src.shape
    _, ho, wo = ix.shape
    for name, g, ch in (("g_rgb", g_rgb, 3), ("g_w", g_w, 1)):
        if g is not None:
            check_cuda_tensor(name, g, (given[0].dtype,), (b, ho, wo, ch))
    dix = torch.empty_like(ix)
    diy = torch.empty_like(iy)
    WARP_GATHER_BWD(
        src.data_ptr(), DTYPE_CODE[src.dtype], ix.data_ptr(), iy.data_ptr(),
        None if g_rgb is None else g_rgb.data_ptr(),
        None if g_w is None else g_w.data_ptr(),
        DTYPE_CODE[given[0].dtype], dix.data_ptr(), diy.data_ptr(), b, h, w, ho, wo,
    )
    return dix, diy


class WarpRegather(torch.autograd.Function):
    """``warp_gather_nograd`` with the re-gather coordinate backward; saves
    the source and the coordinates, and no derivative planes."""

    @staticmethod
    def forward(ctx, src, ix, iy, out_dtype):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(src, ix, iy)
        return warp_gather_nograd(src, ix, iy, out_dtype)

    @staticmethod
    def backward(ctx, g_rgb, g_w):
        src, ix, iy = ctx.saved_tensors
        g_rgb, g_w = (None if g is None else g.contiguous() for g in (g_rgb, g_w))
        dix, diy = warp_gather_backward(src, ix, iy, g_rgb, g_w)
        return None, dix, diy, None


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


def grid_sample_with_weight(
    img, coords, out_dtype=None, src_is_data=False, route: WarpRoute = DEFAULT_ROUTE
):
    """Bilinear sample NHWC ``img`` at normalized ``coords`` [B,Ho,Wo,2].

    Returns (sampled [B,Ho,Wo,C], weight_sum [B,Ho,Wo,1]). 3-channel data
    sources (uint8, or float with ``src_is_data``) go to the warp-gather
    kernels as ``route`` says (see the module docstring); other sources take
    the differentiable plain sampler.
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
    if c == 3 and route.impl != "xla" and (is_u8 or (src_is_data and route.bf16)):
        fn = WarpGather if route.impl == "pallas_fused" else WarpRegather
        return fn.apply(img.detach().contiguous(), ix.contiguous(), iy.contiguous(), dtype)
    return _sample_plain(img, ix, iy, dtype, 1.0 / 255.0 if is_u8 else 1.0)


def grid_sample(img, coords, out_dtype=None, src_is_data=False, route: WarpRoute = DEFAULT_ROUTE):
    """Bilinear sample (see ``grid_sample_with_weight``), values only."""
    return grid_sample_with_weight(img, coords, out_dtype, src_is_data, route)[0]


def flow_coords(flow: torch.Tensor) -> torch.Tensor:
    """Normalized sampling coords [B,H,W,2] for a backward flow warp (f32)."""
    _, h, w, _ = flow.shape
    grid = pixel_grid(h, w, device=flow.device)[None]
    return normalize_coords(grid + flow.float(), h, w)


def warp_flow(
    x, flow, use_mask: bool = False, out_dtype=None, src_is_data=False,
    route: WarpRoute = DEFAULT_ROUTE,
):
    """Backward-warp NHWC ``x`` by optical flow [B,H,W,2].

    With ``use_mask`` the result is multiplied by the hard validity mask
    (weight sum >= 0.9999), computed analytically from the tap weights.
    """
    out, weight = grid_sample_with_weight(
        x, flow_coords(flow), out_dtype=out_dtype, src_is_data=src_is_data, route=route
    )
    if use_mask:
        mask = torch.logical_not(weight < 0.9999).to(out.dtype)
        return out * mask
    return out
