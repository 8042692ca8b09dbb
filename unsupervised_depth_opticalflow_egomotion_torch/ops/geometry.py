"""Projective geometry (NHWC), port of the JAX package's ``ops/geometry.py``.

- Euler rotation R = Rx @ Ry @ Rz; pose vec [tx, ty, tz, rx, ry, rz] -> [B,3,4]
- projection clamps Z at 1e-3 and pushes out-of-frame normalized coords to
  2, so the zero-padded sampler returns 0 and the valid mask is false
- rigid flow = projected pixel coords - identity grid
- E = [t]x R and F = K^-T E K^-1

All coordinate math runs in f32 whatever the compute dtype. The 3x3
products over every pixel are elementwise multiply-adds (``map_points``),
not ``einsum``: on CUDA an einsum runs them as f32 cuBLAS ``bmm`` with K = 3,
whose backward is many times slower than the bytes it moves.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .warp import DEFAULT_ROUTE, WarpRoute, grid_sample, pixel_grid


def euler2mat(angle: torch.Tensor) -> torch.Tensor:
    """Euler angles [B,3] (x, y, z, radians) -> rotation matrices [B,3,3]."""
    x, y, z = angle[:, 0], angle[:, 1], angle[:, 2]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    cosz, sinz = torch.cos(z), torch.sin(z)
    zmat = torch.stack(
        [cosz, -sinz, zeros, sinz, cosz, zeros, zeros, zeros, ones], dim=1
    ).reshape(-1, 3, 3)
    cosy, siny = torch.cos(y), torch.sin(y)
    ymat = torch.stack(
        [cosy, zeros, siny, zeros, ones, zeros, -siny, zeros, cosy], dim=1
    ).reshape(-1, 3, 3)
    cosx, sinx = torch.cos(x), torch.sin(x)
    xmat = torch.stack(
        [ones, zeros, zeros, zeros, cosx, -sinx, zeros, sinx, cosx], dim=1
    ).reshape(-1, 3, 3)
    return xmat @ ymat @ zmat


def quat2mat(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion tail [B,3] (w fixed to 1 before normalization) -> [B,3,3]."""
    q = torch.cat([torch.ones_like(quat[:, :1]), quat], dim=1)
    q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    w, x, y, z = q.unbind(1)
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack(
        [
            w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
            2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
            2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
        ],
        dim=1,
    ).reshape(-1, 3, 3)


def pose_vec2mat(vec: torch.Tensor, rotation_mode: str = "euler") -> torch.Tensor:
    """6-DoF pose [B,6] ([t | r], Euler angles or a quaternion tail) ->
    transform [B,3,4]."""
    rot = euler2mat(vec[:, 3:]) if rotation_mode == "euler" else quat2mat(vec[:, 3:])
    return torch.cat([rot, vec[:, :3, None]], dim=2)


def disp2depth(disp: torch.Tensor, min_depth: float = 0.1, max_depth: float = 100.0) -> torch.Tensor:
    """Sigmoid disparity -> bounded depth (the reference's model_geometry.py:282-287)."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    return 1.0 / (min_disp + (max_disp - min_disp) * disp)


class _PointMap(torch.autograd.Function):
    """out[..., i] = sum_j m[b,i,j] p[..., j] over the k channels of ``p``,
    plus m[b,i,k] when ``m`` has a column more than ``p`` has channels.

    ``p`` is [B,H,W,k], or [H,W,k] when the batch shares it (a pixel grid).
    The forward is a broadcast multiply-add a channel, summed in the order
    of the JAX package's einsum (another order flips a hard-mask pixel in
    tests/test_torch_geom.py). The backward is one product and one
    reduction a gradient; autograd of the forward would make a reduction a
    column.
    """

    @staticmethod
    def forward(ctx, m, p):
        ctx.save_for_backward(m, p)
        k = p.shape[-1]
        m5 = m[:, None, None]  # [B,1,1,3,c]
        out = m5[..., 0] * p[..., :1]
        for j in range(1, k):
            out.addcmul_(m5[..., j], p[..., j : j + 1])
        if m.shape[-1] > k:  # last, as the einsum's sum plus the column
            out.add_(m5[..., k])
        return out

    @staticmethod
    def backward(ctx, g):
        m, p = ctx.saved_tensors
        k = p.shape[-1]
        gm = gp = None
        if ctx.needs_input_grad[0]:
            # the constant column's gradient in the same reduction: p gets a 1
            ph = F.pad(p, (0, 1), value=1.0) if m.shape[-1] > k else p
            gm = (g[..., :, None] * ph[..., None, :]).sum((1, 2))
        if ctx.needs_input_grad[1]:
            gp = (g[..., :, None] * m[:, None, None, :, :k]).sum(-2)
            if p.dim() == 3:
                gp = gp.sum(0)
        return gm, gp


def map_points(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """[B,3,k] or [B,3,k+1] (a constant column last) times every point of
    ``p`` ([B,H,W,k] or [H,W,k]) -> [B,H,W,3], as f32 multiply-adds over the
    last axis."""
    return _PointMap.apply(m.float(), p.float())


def pixel2cam(depth: torch.Tensor, intrinsics_inv: torch.Tensor) -> torch.Tensor:
    """Backproject depth [B,H,W] with K_inv [B,3,3] -> cam points [B,H,W,3]
    (K_inv times the homogeneous pixel (x, y, 1), times the depth)."""
    _, h, w = depth.shape
    rays = map_points(intrinsics_inv, pixel_grid(h, w, device=depth.device))
    return rays * depth.float()[..., None]


def _project(cam_coords: torch.Tensor, proj: torch.Tensor):
    """cam points [B,H,W,3] through [B,3,4] -> (x/z, y/z, clamped z)."""
    pts = map_points(proj, cam_coords)
    z = torch.clamp(pts[..., 2], min=1e-3)
    return pts[..., 0] / z, pts[..., 1] / z, z


def _normalize_zeros(xp, yp, h: int, w: int) -> torch.Tensor:
    """Pixel coords -> normalized [B,H,W,2]; out-of-frame axes pushed to 2."""
    x_norm = 2.0 * xp / (w - 1) - 1.0
    y_norm = 2.0 * yp / (h - 1) - 1.0
    x_norm = torch.where(x_norm.abs() > 1.0, torch.full_like(x_norm, 2.0), x_norm)
    y_norm = torch.where(y_norm.abs() > 1.0, torch.full_like(y_norm, 2.0), y_norm)
    return torch.stack([x_norm, y_norm], dim=-1)


def cam2pixel_norm(cam_coords: torch.Tensor, proj: torch.Tensor):
    """(normalized coords [B,H,W,2] with zeros padding, computed depth [B,H,W,1])."""
    _, h, w, _ = cam_coords.shape
    xp, yp, z = _project(cam_coords, proj)
    return _normalize_zeros(xp, yp, h, w), z[..., None]


def cam2pixel_px(cam_coords: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """Raw pixel coords [B,H,W,2] (no normalization, Z clamp 1e-3)."""
    xp, yp, _ = _project(cam_coords, proj)
    return torch.stack([xp, yp], dim=-1)


def rigid_projection(depth, pose, intrinsics):
    """One depth+pose projection, all consumers served (zeros padding).

    Returns (coords [B,H,W,2] normalized with the out-of-frame->2 trick,
    valid [B,H,W,1] f32, computed_depth [B,H,W,1], rigid_flow [B,H,W,2]).
    """
    _, h, w, _ = depth.shape
    # inv_ex: linalg.inv's kernel without its error check, a sync on CUDA
    k_inv = torch.linalg.inv_ex(intrinsics)[0]
    cam_coords = pixel2cam(depth[..., 0], k_inv)
    proj = intrinsics @ pose_vec2mat(pose.float())
    xp, yp, z = _project(cam_coords, proj)
    coords = _normalize_zeros(xp, yp, h, w)
    valid = (coords.abs().amax(dim=-1) <= 1.0).float()[..., None]
    rigid = torch.stack([xp, yp], dim=-1) - pixel_grid(h, w, device=depth.device)[None]
    return coords, valid, z[..., None], rigid


def rigid_sample_coords(depth, pose, intrinsics):
    """The projection half of ``inverse_warp2``: (coords [B,H,W,2], valid
    [B,H,W,1] f32, computed_depth [B,H,W,1])."""
    coords, valid, computed_depth, _ = rigid_projection(depth, pose, intrinsics)
    return coords, valid, computed_depth


def inverse_warp2(
    img, depth, ref_depth, pose, intrinsics, sample_ref_depth: bool = True,
    route: WarpRoute = DEFAULT_ROUTE,
):
    """Depth+pose inverse warp of a source image onto the target plane.

    ``img`` [B,H,W,3] is the source frame, ``depth`` the target depth and
    ``ref_depth`` the source depth [B,H,W,1], ``pose`` [B,6] target->source.
    Returns (projected_img, valid_mask [B,H,W,1], projected_depth (>= 1e-3,
    or None without ``sample_ref_depth``), computed_depth).
    """
    coords, valid, computed_depth = rigid_sample_coords(depth, pose, intrinsics)
    valid = valid.to(img.dtype)
    if not sample_ref_depth:
        # img is a camera frame by contract: the data-source kernels apply
        projected_img = grid_sample(img, coords, src_is_data=True, route=route)
        return projected_img, valid, None, computed_depth
    # img and ref_depth are sampled at the same coords as one 4-channel
    # source; ref_depth is network output and needs a gradient to the source,
    # so this is the plain sampler, never the kernel
    sampled = grid_sample(torch.cat([img, ref_depth.to(img.dtype)], dim=-1), coords)
    projected_depth = torch.clamp(sampled[..., 3:], min=1e-3)
    return sampled[..., :3], valid, projected_depth, computed_depth


def calculate_rigid_flow(depth, pose, intrinsics) -> torch.Tensor:
    """Rigid flow [B,H,W,2] induced by depth [B,H,W,1] and pose [B,6]."""
    return rigid_projection(depth, pose, intrinsics)[3]


def skew_symmetric(t: torch.Tensor) -> torch.Tensor:
    """Translation [B,3] -> cross-product matrices [B,3,3]."""
    x, y, z = t[:, 0], t[:, 1], t[:, 2]
    zeros = torch.zeros_like(x)
    return torch.stack([zeros, -z, y, z, zeros, -x, -y, x, zeros], dim=1).reshape(-1, 3, 3)


def essential_matrix(pose_vec: torch.Tensor) -> torch.Tensor:
    """E = [t]x R from a 6-DoF pose vector [B,6]."""
    return skew_symmetric(pose_vec[:, :3]) @ euler2mat(pose_vec[:, 3:])


def fundamental_from_pose(pose_vec, intrinsics_inv) -> torch.Tensor:
    """F = K^-T [t]x R K^-1."""
    e = essential_matrix(pose_vec)
    return intrinsics_inv.transpose(1, 2) @ e @ intrinsics_inv


def projection_matrices(pose_vec, intrinsics):
    """P1 = K [I|0], P2 = K [R|t]."""
    b = intrinsics.shape[0]
    iden = torch.cat(
        [torch.eye(3, device=intrinsics.device), torch.zeros(3, 1, device=intrinsics.device)],
        dim=-1,
    )[None].expand(b, 3, 4).to(intrinsics.dtype)
    return intrinsics @ iden, intrinsics @ pose_vec2mat(pose_vec)
