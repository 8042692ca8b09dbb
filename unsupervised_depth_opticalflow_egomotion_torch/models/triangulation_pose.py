"""Legacy two-view pipeline: flow -> fundamental matrix -> pose -> triangulated depth.

Port of the JAX package's ``models/triangulation_pose.py`` (the reference's
model_triangulate_pose.py and model_depth_pose.py). The flow and depth nets
run on the tensors' device; the geometry is batched and fixed-shape:

- correspondences: the drawn pixels of the dense flow (``build_matches``);
- fundamental matrix: RANSAC eight-point (``ops/ransac.py``);
- pose: E = K^T F K, SVD -> four candidate [R|t], chirality vote by the
  triangulated depths' signs (model_depth_pose.py:239-275);
- structure: midpoint triangulation and ray-angle weights.

The draws are explicit, as the geom step's are (``ops/sampling.py``): three
index tensors (``draw_two_view``) that the caller may pass, so the card and
the CPU, or the JAX package's own draws, can be given the same samples.
Without them every call draws from a CPU generator seeded with 0, the JAX
model's fixed ``PRNGKey(0)``. ``two_view_geometry`` is the geometric half
on its own, a function of a flow, so it can be fed an exact rigid flow.

SVD's singular vectors are unique only up to sign, so the four candidates
may come in another order than the JAX package's; the chosen [R|t] is the
same wherever the vote has a unique maximum.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.geometry import disp2depth
from ..ops.ransac import batched_ransac_fundamental
from ..ops.sampling import build_matches, draw_indices
from ..ops.triangulation import midpoint_triangulate, register_depth, reproject
from .depth_net import DepthNet
from .feature_pyramid import FeaturePyramid
from .layers import module_mode
from .pwc_decoder import PWCDecoder

VERIFY_POINTS = 200  # matches of the chirality vote (triangulation_pose.py:175)


def _identity_rt(b: int, like: torch.Tensor) -> torch.Tensor:
    """[I|0] as [B,3,4]."""
    iden = torch.eye(3, 4, dtype=like.dtype, device=like.device)
    return iden[None].expand(b, 3, 4)


def essential_from_fundamental(F, K):
    """E = K^T F K (model_depth_pose.py:245-246)."""
    return K.transpose(1, 2) @ F @ K


def _verify_rt(match, K_inv, P1, P2):
    """Chirality score [B]: how many of the matches [B,N,4] triangulate to a
    positive depth in both views (model_depth_pose.py:227-237)."""
    points = midpoint_triangulate(match, K_inv, P1, P2)  # [B,N,4]
    d1 = (points @ P1.transpose(1, 2))[..., 2]
    d2 = (points @ P2.transpose(1, 2))[..., 2]
    return ((d1 > 0) & (d2 > 0)).float().sum(1)


def _pose_candidates(F, K):
    """The four [R|t] of E = K^T F K: (P1 [B,3,4], Rts [B,4,3,4], P2s
    [B,4,3,4]) in the order [R1|t1, R2|t1, R1|t2, R2|t2]."""
    b = F.shape[0]
    U, _, Vh = torch.linalg.svd(essential_from_fundamental(F, K))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=F.dtype, device=F.device).expand(b, 3, 3)
    R1 = U @ W @ Vh
    R1 = torch.sign(torch.linalg.det(R1))[:, None, None] * R1
    R2 = U @ W.transpose(1, 2) @ Vh
    R2 = torch.sign(torch.linalg.det(R2))[:, None, None] * R2
    t1 = U[:, :, 2:3]
    t2 = -t1
    Rts = torch.stack([torch.cat(rt, -1) for rt in ((R1, t1), (R2, t1), (R1, t2), (R2, t2))], 1)
    return K @ _identity_rt(b, K), Rts, K[:, None] @ Rts


def pose_from_fundamental(F, K, verify_match):
    """Recover (P1, P2) from F by the essential matrix's SVD and a four-way
    chirality vote (the first of equal maxima, as ``jnp.argmax``).

    F, K [B,3,3]; verify_match [B,M,4] the correspondences of the vote.
    Returns (P1 [B,3,4], P2 [B,3,4], Rt [B,3,4]).
    """
    P1, Rts, P2s = _pose_candidates(F, K)
    K_inv = torch.linalg.inv(K)
    with torch.no_grad():
        votes = torch.stack([_verify_rt(verify_match, K_inv, P1, P2s[:, i]) for i in range(4)], 1)
    best = torch.argmax(votes, dim=1)
    rows = torch.arange(F.shape[0], device=F.device)
    return P1, P2s[rows, best], Rts[rows, best]


def ray_angle_weights(match, K, P1, P2, thres: float = 0.001):
    """Validity [B,N,1] (1 = well-conditioned ray pair) of the triangulation
    rays: the cosine of the ray / baseline-normal angle must exceed
    ``thres`` (model_depth_pose.py:123-150). No gradient."""
    b, n, _ = match.shape
    K_inv = torch.linalg.inv(K)
    RT1 = K_inv @ P1
    RT2 = K_inv @ P2
    ones = torch.ones((b, n, 1), dtype=match.dtype, device=match.device)
    pts1 = torch.cat([match[..., :2], ones], -1)
    pts2 = torch.cat([match[..., 2:], ones], -1)

    def rays(RT, pts):
        Rt = RT[:, :, :3].transpose(1, 2)
        d = pts @ (Rt @ K_inv).transpose(1, 2)
        d = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-12)
        origin = -(Rt @ RT[:, :, 3:])[..., 0]
        return d, origin

    ray1_dir, ray1_origin = rays(RT1, pts1)
    ray2_dir, ray2_origin = rays(RT2, pts2)
    p1p2 = (ray1_origin - ray2_origin)[:, None, :]
    verline = (ray2_origin[:, None, :] + (p1p2 * ray2_dir).sum(-1, keepdim=True) * ray2_dir
               - ray1_origin[:, None, :])
    cosv = (ray1_dir * verline).sum(-1, keepdim=True) / (
        (torch.linalg.vector_norm(ray1_dir, dim=-1, keepdim=True) + 1e-12)
        * (torch.linalg.vector_norm(verline, dim=-1, keepdim=True) + 1e-12)
    )
    return (cosv > thres).to(match.dtype).detach()


def draw_two_view(batch_size: int, hw, ransac_points: int, ransac_iters: int,
                  generator: torch.Generator | None = None) -> dict:
    """The three index draws of one two-view call, int64 on the CPU:
    "sample" [B, ransac_points] picks the pixels in [0, H*W), "ransac"
    [B, ransac_iters, 8] each hypothesis's minimal sample among them, and
    "verify" [B, 200] the matches of the chirality vote. Without
    ``generator``, a new one seeded with 0: every such call draws the same."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    h, w = hw
    return {
        "sample": draw_indices(gen, (batch_size, ransac_points), h * w),
        "ransac": draw_indices(gen, (batch_size, ransac_iters, 8), ransac_points),
        "verify": draw_indices(gen, (batch_size, VERIFY_POINTS), ransac_points),
    }


def _take(x, idx):
    """x [B,N,C] at the indices idx [B,M] -> [B,M,C]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def two_view_geometry(flow, K, K_inv, draws, inlier_thres: float = 0.1):
    """The geometric half of the two-view inference on the flow [B,H,W,2]
    and the draws (``draw_two_view``, on the flow's device): RANSAC-F on the
    sampled matches, the pose by the chirality vote, and the midpoint
    triangulation of the sampled matches.

    Returns (Rt [B,3,4], P2 [B,3,4], sel [B,P,4] the sampled matches,
    tri_depth [B,P,1] their triangulated depths in the first view).
    """
    sel = _take(build_matches(flow), draws["sample"])
    F, _ = batched_ransac_fundamental(draws["ransac"], sel[..., :2], sel[..., 2:], inlier_thres)
    P1, P2, Rt = pose_from_fundamental(F, K, _take(sel, draws["verify"]))
    _, tri_depth = reproject(P1, midpoint_triangulate(sel, K_inv, P1, P2))
    return Rt, P2, sel, tri_depth


class TriangulationPoseModel(nn.Module):
    """Flow and depth nets with two-view geometric pose and structure.

    The sub-modules carry ``JointModel``'s names (``fpyramid``,
    ``pwc_model``, ``depth_net``), so the joint model's parameters and
    BatchNorm buffers load into it by prefix.
    """

    def __init__(self, num_scales: int = 3, ransac_iters: int = 100, ransac_points: int = 6000,
                 inlier_thres: float = 0.1, dtype=torch.float32):
        super().__init__()
        self.ransac_iters = ransac_iters
        self.ransac_points = ransac_points
        self.inlier_thres = inlier_thres
        self.dtype = dtype
        self.fpyramid = FeaturePyramid(dtype=dtype)
        self.pwc_model = PWCDecoder(dtype=dtype)
        self.depth_net = DepthNet(num_scales=num_scales, dtype=dtype)

    def draw(self, batch_size: int, hw, generator: torch.Generator | None = None) -> dict:
        """``draw_two_view`` at this model's ``ransac_points`` and ``ransac_iters``."""
        return draw_two_view(batch_size, hw, self.ransac_points, self.ransac_iters, generator)

    def _forward(self, img1, img2, K, K_inv, draws):
        hw = (img1.shape[1], img1.shape[2])
        f1 = self.fpyramid(img1.to(self.dtype))
        f2 = self.fpyramid(img2.to(self.dtype))
        flow = self.pwc_model(f1, f2, hw)[0].float()
        # the depth net on its running statistics, as the JAX
        # depth_net(img, False) (triangulation_pose.py:163-164)
        with module_mode(self.depth_net, False):
            disp1 = self.depth_net(img1.to(self.dtype))[0].float()
            disp2 = self.depth_net(img2.to(self.dtype))[0].float()
        if draws is None:
            draws = self.draw(img1.shape[0], hw)
        draws = {k: v.to(flow.device) for k, v in draws.items()}
        Rt, P2, sel, tri_depth = two_view_geometry(flow, K.float(), K_inv.float(), draws,
                                                   self.inlier_thres)
        return flow, disp1, disp2, Rt, P2, (sel, tri_depth)

    def inference(self, img1, img2, K, K_inv, draws=None):
        """Two-view inference (the reference's test.py:33,64), in eval mode
        and without autograd; the modules' modes are restored after.

        img1, img2 [B,H,W,3] float frames in [0, 1]; K, K_inv [B,3,3];
        ``draws`` as ``draw`` makes them (default: seed 0). Returns (flow
        [B,H,W,2], disp1, disp2 [B,H,W,1], Rt [B,3,4], P2 [B,3,4], (sel
        [B,P,4], tri_depth [B,P,1])), f32.
        """
        with module_mode(self, False), torch.no_grad():
            return self._forward(img1, img2, K, K_inv, draws)

    def triangulation_depth_loss(self, img1, img2, K, K_inv, draws=None):
        """Triangulated-depth registration loss [B] on the sampled matches
        (model_depth_pose.py:331-380's core objective): the first frame's
        depth registered on the triangulated depths, weighted by the rays'
        conditioning. Differentiable in the depth net, whose BatchNorm runs
        on its running statistics as in ``inference``."""
        _, disp1, _, _, P2, (sel, _) = self._forward(img1, img2, K, K_inv, draws)
        K, K_inv = K.float(), K_inv.float()
        P1 = K @ _identity_rt(K.shape[0], K)
        weights = ray_angle_weights(sel, K, P1, P2)
        c1, d1 = reproject(P1, midpoint_triangulate(sel, K_inv, P1, P2))
        _, inter1 = register_depth(disp2depth(disp1), c1, d1)
        per_point = (1.0 - inter1 / (d1 + 1e-12)) ** 2 * weights
        denom = weights.mean(dim=(1, 2)) + 1e-12
        return per_point.mean(dim=(1, 2)) / denom
