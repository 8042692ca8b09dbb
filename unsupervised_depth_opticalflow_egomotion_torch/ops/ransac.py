"""Batched RANSAC fundamental-matrix estimation on the tensor's device.

Port of the JAX package's ``ops/ransac.py``. Hypotheses are normalized
8-point solutions from drawn minimal samples; each is scored by the Sampson
distance of every correspondence, and the one with the most inliers wins
(the first of equal counts, as ``jnp.argmax``). Every function is batched
over leading dimensions, so ``ransac_fundamental`` solves the B x iters
hypotheses as one batched 9x9 SVD and one batched 3x3 SVD, with no loop.

F is unique only up to sign (the SVD's singular vectors are); the Sampson
distance and the eight-point loss, which aligns signs, do not see it.
"""

from __future__ import annotations

import math

import torch


def _normalize_points(pts):
    """Hartley normalization of pts [..., N, 2]: zero mean, mean distance
    sqrt(2). Returns (normalized points, T [..., 3, 3])."""
    mean = pts.mean(dim=-2, keepdim=True)
    centered = pts - mean
    scale = math.sqrt(2.0) / (torch.linalg.vector_norm(centered, dim=-1).mean(-1) + 1e-12)
    zero, one = torch.zeros_like(scale), torch.ones_like(scale)
    mx, my = mean[..., 0, 0], mean[..., 0, 1]
    T = torch.stack(
        [scale, zero, -scale * mx, zero, scale, -scale * my, zero, zero, one], dim=-1
    ).reshape(*scale.shape, 3, 3)
    return centered * scale[..., None, None], T


def eight_point(p1, p2):
    """Normalized 8-point fundamental matrix from >= 8 correspondences.

    p1, p2 [..., N, 2] pixel coords -> F [..., 3, 3] (rank 2, unit Frobenius
    norm), with p2^T F p1 = 0.
    """
    p1n, T1 = _normalize_points(p1)
    p2n, T2 = _normalize_points(p2)
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    A = torch.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, torch.ones_like(x1)], dim=-1
    )
    vt = torch.linalg.svd(A, full_matrices=True)[2]
    F = vt[..., -1, :].reshape(*A.shape[:-2], 3, 3)
    # rank-2 projection
    u, s, vt2 = torch.linalg.svd(F)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    F = (u * s[..., None, :]) @ vt2
    F = T2.transpose(-1, -2) @ F @ T1
    return F / (torch.linalg.matrix_norm(F)[..., None, None] + 1e-12)


def sampson_distance(F, p1, p2):
    """Sampson epipolar distance [..., N] of correspondences p1, p2
    [..., N, 2] under F [..., 3, 3]."""
    ones = torch.ones_like(p1[..., :1])
    x1 = torch.cat([p1, ones], dim=-1)
    x2 = torch.cat([p2, ones], dim=-1)
    Fx1 = x1 @ F.transpose(-1, -2)
    Ftx2 = x2 @ F
    num = (x2 * Fx1).sum(-1) ** 2
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2 + 1e-12
    return num / den


def ransac_fundamental(idx, p1, p2, thres: float = 0.1):
    """RANSAC-F for one correspondence set: p1, p2 [N,2], ``idx`` [iters, 8]
    the drawn minimal samples. Returns (F [3,3], inlier mask [N]).
    ``thres`` is on the Sampson distance (inliers: distance < thres^2)."""
    F, inliers = batched_ransac_fundamental(idx[None], p1[None], p2[None], thres)
    return F[0], inliers[0]


def batched_ransac_fundamental(idx, p1, p2, thres: float = 0.1):
    """RANSAC-F over a batch: p1, p2 [B,N,2], ``idx`` [B,iters,8] ->
    (F [B,3,3], inliers [B,N])."""
    b, iters, k = idx.shape
    flat = idx.reshape(b, iters * k, 1).expand(-1, -1, 2)
    p1s = torch.gather(p1, 1, flat).reshape(b, iters, k, 2)
    p2s = torch.gather(p2, 1, flat).reshape(b, iters, k, 2)
    Fs = eight_point(p1s, p2s)  # [B,iters,3,3]
    dists = sampson_distance(Fs, p1[:, None], p2[:, None])  # [B,iters,N]
    inliers = dists < thres**2
    best = torch.argmax(inliers.sum(-1), dim=1)  # the first maximum
    rows = torch.arange(b, device=p1.device)
    return Fs[rows, best], inliers[rows, best]
