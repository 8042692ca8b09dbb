"""PnP on the tensor's device: 6-DoF pose from 3D-2D correspondences by
Gauss-Newton.

Port of the JAX package's ``ops/pnp.py``: a fixed-iteration Gauss-Newton on
the reprojection residual in the axis-angle + translation parameters,
optionally inside fixed-shape RANSAC hypothesis scoring. Every function is
batched over a leading batch dimension. The 2N x 6 Jacobian of each step is
``torch.func.jacfwd`` under ``torch.func.vmap``, as the JAX package takes
``jax.jacfwd`` under ``vmap``; the 6x6 normal equations are solved with
``torch.linalg.solve_ex``, which leaves its error code on the device (the
checked ``solve`` would wait for the card on every call).
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrix [..., 3, 3], differentiable at 0.

    R = I + A [r]x + B [r]x^2 with A = sin(t)/t and B = (1 - cos(t))/t^2,
    and their series below an angle of 1e-4, each branch evaluated at a safe
    angle so that the unused one keeps a finite derivative.
    """
    # [..., 1], not 0-dim: under torch.func's jvp a 0-dim tensor divided by
    # a Python float comes out float64
    theta_sq = (rvec * rvec).sum(-1, keepdim=True)
    small = theta_sq < 1e-8
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    A = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / safe_sq)
    x, y, z = rvec[..., 0], rvec[..., 1], rvec[..., 2]
    zero = torch.zeros_like(x)
    K = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1).reshape(
        *rvec.shape[:-1], 3, 3
    )
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + A[..., None] * K + B[..., None] * (K @ K)


def _residuals(params, pts3d, pts2d, K):
    """Reprojection residuals [..., N, 2] for params [..., 6] = [rvec | tvec]."""
    R = rodrigues(params[..., :3])
    cam = pts3d @ R.transpose(-1, -2) + params[..., None, 3:]
    z = torch.clamp(cam[..., 2:3], min=1e-6)
    proj = (cam / z) @ K.transpose(-1, -2)
    return proj[..., :2] - pts2d


def _flat_residuals(params, pts3d, pts2d, K):
    return _residuals(params, pts3d, pts2d, K).reshape(-1)


_jacobian = vmap(jacfwd(_flat_residuals))  # [B,6] ... -> [B,2N,6]


def pnp_gauss_newton(pts3d, pts2d, K, init_params=None, num_iters: int = 10):
    """Solve PnP for a batch of correspondence sets.

    pts3d [B,N,3] (target-frame 3D points), pts2d [B,N,2], K [B,3,3].
    Returns params [B,6] = [rvec | tvec] minimizing the reprojection error,
    from ``init_params`` (default zeros) after ``num_iters`` steps.
    """
    b = pts3d.shape[0]
    params = (
        torch.zeros((b, 6), dtype=pts3d.dtype, device=pts3d.device)
        if init_params is None
        else init_params
    )
    damp = 1e-6 * torch.eye(6, dtype=pts3d.dtype, device=pts3d.device)
    for _ in range(num_iters):
        J = _jacobian(params, pts3d, pts2d, K)
        r = _flat_residuals(params, pts3d, pts2d, K).reshape(b, -1)
        Jt = J.transpose(1, 2)
        delta = torch.linalg.solve_ex(Jt @ J + damp, (Jt @ r[..., None]))[0]
        params = params - delta[..., 0]
    return params


def pnp_ransac(idx, pts3d, pts2d, K, thres: float = 1.0, num_gn_iters: int = 10):
    """Fixed-shape RANSAC-PnP: the hypothesis with the most reprojection
    inliers (error < ``thres`` px), refined on every correspondence.

    pts3d [B,N,3], pts2d [B,N,2], K [B,3,3]; ``idx`` [B,iters,S] the drawn
    minimal samples. Returns (params [B,6] = [rvec | tvec], inliers [B,N]).
    """
    b, iters, s = idx.shape
    n = pts3d.shape[1]

    def pick(x):
        flat = idx.reshape(b, iters * s, 1).expand(-1, -1, x.shape[-1])
        return torch.gather(x, 1, flat).reshape(b * iters, s, x.shape[-1])

    K_rep = K.repeat_interleave(iters, dim=0)
    hyps = pnp_gauss_newton(pick(pts3d), pick(pts2d), K_rep, num_iters=num_gn_iters)
    hyps = hyps.reshape(b, iters, 6)
    errs = torch.linalg.vector_norm(
        _residuals(hyps, pts3d[:, None].expand(-1, iters, n, 3),
                   pts2d[:, None].expand(-1, iters, n, 2), K[:, None]),
        dim=-1,
    )  # [B,iters,N]
    inliers = errs < thres
    best = torch.argmax(inliers.sum(-1), dim=1)
    rows = torch.arange(b, device=pts3d.device)
    params = pnp_gauss_newton(pts3d, pts2d, K, init_params=hyps[rows, best],
                              num_iters=num_gn_iters)
    return params, inliers[rows, best]


def batched_pnp(pts3d, pts2d, K, num_iters: int = 10):
    """Gauss-Newton PnP over the batch: [B,N,3], [B,N,2], [B,3,3] -> [B,6]
    in the reference's ``pnp()`` layout, [tvec | rvec] (the pose vector's)."""
    params = pnp_gauss_newton(pts3d, pts2d, K, num_iters=num_iters)
    return torch.cat([params[:, 3:], params[:, :3]], dim=1)
