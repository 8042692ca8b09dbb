"""Midpoint triangulation and depth registration, batched on the device.

Port of the JAX package's ``ops/triangulation.py`` (the reference's
model_geometry.py:569-683). Medians average the two middle values of an
even count, as ``jnp.median`` does (``torch.median`` would return the lower).
"""

from __future__ import annotations

import torch

from .warp import grid_sample


def midpoint_triangulate(match, K_inv, P1, P2):
    """Midpoint triangulation of matches [B,N,4] (x1, y1, x2, y2) under
    K_inv [B,3,3] and projection matrices P1, P2 [B,3,4].

    Returns homogeneous points [B,N,4].
    """
    b, n, _ = match.shape
    RT1 = K_inv @ P1
    RT2 = K_inv @ P2
    ones = torch.ones((b, n, 1), dtype=match.dtype, device=match.device)
    pts1 = torch.cat([match[..., :2], ones], dim=-1)
    pts2 = torch.cat([match[..., 2:], ones], dim=-1)

    def rays(RT, pts):
        Rt = RT[:, :, :3].transpose(1, 2)
        d = pts @ (Rt @ K_inv).transpose(1, 2)
        d = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-12)
        origin = -(Rt @ RT[:, :, 3:])[..., 0]  # [B,3]
        return d, origin

    ray1_dir, ray1_origin = rays(RT1, pts1)
    ray2_dir, ray2_origin = rays(RT2, pts2)

    dir_cross = torch.linalg.cross(ray1_dir, ray2_dir, dim=-1)
    denom = 1.0 / ((dir_cross * dir_cross).sum(-1, keepdim=True) + 1e-12)
    origin_vec = (ray2_origin - ray1_origin)[:, None, :].expand_as(ray1_dir)
    a1 = (torch.linalg.cross(origin_vec, ray2_dir, dim=-1) * dir_cross).sum(-1, keepdim=True) * denom
    a2 = (torch.linalg.cross(origin_vec, ray1_dir, dim=-1) * dir_cross).sum(-1, keepdim=True) * denom
    p1 = ray1_origin[:, None, :] + a1 * ray1_dir
    p2 = ray2_origin[:, None, :] + a2 * ray2_dir
    return torch.cat([0.5 * (p1 + p2), ones], dim=-1)


def reproject(P, points_h):
    """Project homogeneous points [B,N,4] through P [B,3,4]: (pixel coords
    [B,N,2], depth [B,N,1])."""
    p = points_h @ P.transpose(1, 2)
    return p[..., :2] / (p[..., 2:3] + 1e-12), p[..., 2:3]


def scale_adapt(depth1, depth2, eps: float = 1e-12):
    """Least-squares scale a with depth1 ~ a * depth2, over dim 1 (detached)."""
    A = ((depth1**2) / (depth2**2 + eps)).sum(1)
    C = (depth1 / (depth2 + eps)).sum(1)
    return (C / (A + eps)).detach()


def affine_adapt(depth1, depth2, use_translation: bool = True, eps: float = 1e-12):
    """Least-squares affine (a, b) with depth1 ~ a * depth2 + b (detached)."""
    a_scale = scale_adapt(depth1, depth2, eps)
    if not use_translation:
        return a_scale, torch.zeros_like(a_scale)
    A = ((depth1**2) / (depth2**2 + eps)).sum(1)
    B = (depth1 / (depth2**2 + eps)).sum(1)
    C = (depth1 / (depth2 + eps)).sum(1)
    D = (1.0 / (depth2**2 + eps)).sum(1)
    E = (1.0 / (depth2 + eps)).sum(1)
    cond = B * B - A * D
    a = (B * E - D * C) / (cond + 1e-12)
    b = (B * C - A * E) / (cond + 1e-12)
    valid = (cond.abs() > 1e-4).to(a.dtype)
    return (a * valid + a_scale * (1 - valid)).detach(), (b * valid).detach()


def median(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The median over ``dim`` (kept as size 1 then dropped), the mean of the
    two middle values for an even count."""
    s = torch.sort(x, dim=dim).values
    n = x.shape[dim]
    hi = s.narrow(dim, n // 2, 1)
    if n % 2:
        return hi.squeeze(dim)
    return ((s.narrow(dim, n // 2 - 1, 1) + hi) / 2).squeeze(dim)


def register_depth(depth_pred, coord_tri, depth_tri):
    """Median- and affine-register a dense depth map against triangulated
    points.

    depth_pred [B,H,W,1], coord_tri [B,N,2] (pixels), depth_tri [B,N,1].
    Returns (registered dense depth, registered sampled depth [B,N,1]). The
    one-channel map takes the plain sampler (gradients to the map and to the
    coordinates), at coordinates clamped to the frame.
    """
    b, h, w, _ = depth_pred.shape
    n = depth_tri.shape[1]
    gx = 2.0 * coord_tri[..., 0] / (w - 1.0) - 1.0
    gy = 2.0 * coord_tri[..., 1] / (h - 1.0) - 1.0
    coords = torch.stack([gx.clamp(-1, 1), gy.clamp(-1, 1)], dim=-1)
    depth_inter = grid_sample(depth_pred, coords.reshape(b, n, 1, 2)).reshape(b, n, 1)

    scale = (median(depth_inter, 1) / (median(depth_tri, 1) + 1e-12)).detach()  # [B,1]
    sd_inter = depth_inter / (scale[:, None] + 1e-12)
    sd_pred = depth_pred / (scale[:, None, None] + 1e-12)

    a, b_ = affine_adapt(sd_inter, depth_tri, use_translation=False)
    aff_inter = a[:, None] * sd_inter + b_[:, None]
    aff_pred = a[:, None, None] * sd_pred + b_[:, None, None]
    return aff_pred, aff_inter
