"""Forward splatting for occlusion reasoning (NHWC), and the splat kernel.

Port of the JAX package's ``ops/splat.py`` and of the windowed Pallas kernel
in ``ops/pallas/splat_window.py``. ``occlusion_mask_from_flow`` splats an
image of ones along a flow; pixels that receive ~0 mass are occluded in the
target. Targets are computed in f32 whatever the flow's dtype.

- ``splat_mass`` (the kernel): the unit-mass bilinear splat. On a CUDA tensor
  it makes one call of csrc/splat.cu (``SPLAT_MASS``: it zero-fills an f32
  plane, splats into it, summing each source tile's taps in a shared-memory
  window first, and casts a bf16 flow's mass from it); on a CPU tensor it
  runs ``splat_mass_plain``.
  It is exact at any displacement, so the JAX package's window guard has
  no counterpart.
  Atomic sums are taken in an order that changes from run to run: the mass
  agrees with the plain version to f32 rounding (about 1e-5 of a mass that
  reaches a few units), not bit for bit.
- ``forward_splat`` and ``forward_splat_nearest_mass``: plain PyTorch
  scatter-adds on every device, as the JAX package keeps them on XLA.
"""

from __future__ import annotations

import ctypes

import torch

from . import flops
from .cuda_lib import DTYPE_CODE, CudaKernel, check_cuda_tensor
from .warp import pixel_grid

_P = ctypes.c_void_p
_I = ctypes.c_int

SPLAT_MASS = CudaKernel("splat", "splat_mass", [_P, _I, _P, _P, _I, _I, _I])

OCC_TAPS = ("bilinear", "bilinear_xla", "nearest", "nearest_half")


def _targets(flow: torch.Tensor):
    """f32 target coordinates (tx, ty) [B,H,W] of every source pixel."""
    _, h, w, _ = flow.shape
    grid = pixel_grid(h, w, device=flow.device)[None]
    f32 = flow.float()
    return grid[..., 0] + f32[..., 0], grid[..., 1] + f32[..., 1]


def _scatter_add(out_flat, xi, yi, contrib, h: int, w: int):
    """out_flat[b*h*w + yi*w + xi] += contrib for in-frame (xi, yi); the
    rest is dropped. ``contrib`` is [B,H,W,C]; ``out_flat`` is [B*H*W, C]."""
    b = xi.shape[0]
    inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
    idx = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
    idx = idx + torch.arange(b, device=xi.device).view(b, 1, 1) * (h * w)
    contrib = contrib * inb[..., None].to(contrib.dtype)
    out_flat.index_add_(0, idx.reshape(-1), contrib.reshape(-1, contrib.shape[-1]))


def forward_splat(values: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinearly splat ``values`` [B,H,W,C] along ``flow`` [B,H,W,2].

    out[y + fy, x + fx] += w_tap * values[y, x] over the four bilinear taps;
    out-of-frame mass is dropped. Sums in f32, result in ``values.dtype``.
    """
    b, h, w, c = values.shape
    tx, ty = _targets(flow)
    x0, y0 = torch.floor(tx), torch.floor(ty)
    fx, fy = (tx - x0)[..., None], (ty - y0)[..., None]
    vals = values.float()
    out = torch.zeros((b * h * w, c), device=values.device, dtype=torch.float32)
    _scatter_add(out, x0, y0, vals * ((1 - fx) * (1 - fy)), h, w)
    _scatter_add(out, x0 + 1, y0, vals * (fx * (1 - fy)), h, w)
    _scatter_add(out, x0, y0 + 1, vals * ((1 - fx) * fy), h, w)
    _scatter_add(out, x0 + 1, y0 + 1, vals * (fx * fy), h, w)
    return out.reshape(b, h, w, c).to(values.dtype)


def forward_splat_nearest_mass(flow: torch.Tensor) -> torch.Tensor:
    """Unit-mass coverage [B,H,W,1]: each source pixel goes to its single
    nearest target pixel (round half to even, as jnp.round)."""
    b, h, w, _ = flow.shape
    tx, ty = _targets(flow)
    out = torch.zeros((b * h * w, 1), device=flow.device, dtype=torch.float32)
    ones = torch.ones((b, h, w, 1), device=flow.device, dtype=torch.float32)
    _scatter_add(out, torch.round(tx), torch.round(ty), ones, h, w)
    return out.reshape(b, h, w, 1).to(flow.dtype)


def splat_mass_plain(flow: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the splat kernel: bilinear mass [B,H,W,1]."""
    b, h, w, _ = flow.shape
    return forward_splat(torch.ones((b, h, w, 1), device=flow.device, dtype=flow.dtype), flow)


def splat_mass(flow: torch.Tensor) -> torch.Tensor:
    """Unit-mass bilinear splat [B,H,W,1] of ``flow`` [B,H,W,2] in its dtype:
    the kernel on CUDA tensors, the plain version on CPU. No gradient."""
    if flow.device.type == "cpu":
        return splat_mass_plain(flow)
    dev = check_cuda_tensor("flow", flow, (torch.bfloat16, torch.float32))
    if flow.dim() != 4 or flow.shape[-1] != 2:
        raise ValueError(f"splat_mass: expected [B,H,W,2], got {tuple(flow.shape)}")
    b, h, w, _ = flow.shape
    mass = flow.new_empty((b, h, w, 1))
    # the f32 plane the taps are summed in: the output itself for an f32 flow
    plane = mass if flow.dtype == torch.float32 else flow.new_empty((b, h, w), dtype=torch.float32)
    SPLAT_MASS(dev, flow.data_ptr(), DTYPE_CODE[flow.dtype], plane.data_ptr(), mass.data_ptr(),
               b, h, w)
    return mass


def occlusion_mask_from_flow(flow: torch.Tensor, taps: str = "bilinear") -> torch.Tensor:
    """Occlusion mask [B,H,W,1]: splatted mass clamped to [0, 1], detached.

    ``taps``: "bilinear" (the splat kernel on the card), "bilinear_xla" (the
    plain four-tap scatter on every device), "nearest" (single-tap coverage),
    "nearest_half" (planes larger than 64x64 splat on a half-resolution grid,
    2x2-mean flow / 2, and the mask is nearest-upsampled).
    """
    if taps not in OCC_TAPS:
        raise ValueError(f"taps must be one of {OCC_TAPS}, got {taps!r}")
    b, h, w, _ = flow.shape
    flow = flow.detach()
    if taps == "nearest_half" and h % 2 == 0 and w % 2 == 0 and h * w > 4096:
        fhalf = flow.reshape(b, h // 2, 2, w // 2, 2, 2).float().mean(dim=(2, 4)) * 0.5
        mask = forward_splat_nearest_mass(fhalf.to(flow.dtype)).clamp(0.0, 1.0)
        return mask.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    if taps in ("nearest", "nearest_half"):
        mass = forward_splat_nearest_mass(flow)
        return mass.clamp(0.0, 1.0)
    flops.count("splat", flops.splat_mass_flops(b * h * w))  # the kernel's function, any route
    if taps == "bilinear":
        mass = splat_mass(flow.contiguous())
    else:
        mass = splat_mass_plain(flow)
    return mass.clamp(0.0, 1.0)
