"""SSIM over 3x3 mean windows (NHWC), port of the JAX package's ``ops/ssim.py``.

3x3 average-pool statistics with stride 1 and zero padding 1, divisor 9 at
every pixel (torch AvgPool2d counts the padded zeros), C1=0.01^2,
C2=0.03^2, statistics in f32 (bf16 statistics cancel catastrophically in
smooth regions and give a NaN gradient).

``Config.ssim_impl`` selects the implementation. "xla" is the plain version
below on every device. "pallas" names the fused SSIM kernel of the JAX
package (ops/pallas/ssim_fused.py), which this port has not written for the
card yet: it runs the plain version on CPU tensors, as the JAX package does
off the TPU, and raises for CUDA tensors rather than substitute the plain
version there.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _avg3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 box mean of NHWC ``x`` with zero padding and divisor 9."""
    y = F.avg_pool2d(
        x.permute(0, 3, 1, 2), 3, stride=1, padding=1, count_include_pad=True
    )
    return y.permute(0, 2, 3, 1)


def ssim_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-pixel SSIM map of two NHWC images, f32 statistics, input dtype out."""
    dt = x.dtype
    x = x.float()
    y = y.float()
    c1 = 0.01**2
    c2 = 0.03**2
    mu_x = _avg3x3(x)
    mu_y = _avg3x3(y)
    sigma_x = _avg3x3(x * x) - mu_x * mu_x
    sigma_y = _avg3x3(y * y) - mu_y * mu_y
    sigma_xy = _avg3x3(x * y) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x * mu_x + mu_y * mu_y + c1) * (sigma_x + sigma_y + c2)
    return (num / den).to(dt)


def ssim_route(impl: str, device: torch.device) -> str:
    """Which SSIM implementation ``impl`` runs on ``device``: "plain", or raise."""
    if impl not in ("xla", "pallas"):
        raise ValueError(f"ssim_impl must be 'xla' or 'pallas', got {impl!r}")
    if impl == "pallas" and torch.device(device).type == "cuda":
        raise NotImplementedError(
            "ssim_impl='pallas' needs the SSIM kernel on the card, which is "
            "not ported yet (ROADMAP.md, kernel queue: ops/pallas/ssim_fused.py); "
            "set ssim_impl='xla' to run the plain SSIM map"
        )
    return "plain"


def ssim(x: torch.Tensor, y: torch.Tensor, impl: str = "xla") -> torch.Tensor:
    """Per-pixel SSIM map under ``Config.ssim_impl`` routing."""
    ssim_route(impl, x.device)
    return ssim_plain(x, y)
