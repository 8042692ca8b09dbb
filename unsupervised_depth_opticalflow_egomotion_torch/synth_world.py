"""Synthetic multi-plane world with exact GT depth / flow / pose.

The port's own copy of the repository's numpy-only ``scripts/synth_world.py``
(the port imports nothing outside its package); the same generator, the
same files for the same arguments.

Generates KITTI-prepared-format training data (vertically stacked 3-frame
PNGs + calib.txt + train.txt, the layout of data/kitti_prep.py) from scenes
that are geometrically exact: each scene is a textured ground plane plus
floating textured rectangles; every frame is rendered by sampling each
plane's texture through its own plane-to-image homography with z-buffer
compositing, so the three views are pixel-accurate projections of one rigid
world and the photometric objective's optimum is the true geometry.

GT (center-frame depth, center->right / center->left flow, both 6-DoF poses)
is saved per held-out sample for interleaved eval during long training runs
(``python -m unsupervised_depth_opticalflow_egomotion_torch.train_synth_long``).

    python -m unsupervised_depth_opticalflow_egomotion_torch.synth_world \
        --out <dir> --n_train 240 --n_eval 8
"""

from __future__ import annotations

import os

import numpy as np


def _smooth_texture(rng, h, w, octaves=4):
    """Multi-octave random RGB texture in [0,1] with fine detail (needs cv2).

    The finest octaves are essential: with only smooth blobs the photometric
    objective has weak gradients everywhere (aperture problem) and the flow
    stage diverges -- observed as NaN flows within 50 steps at 256x832.
    """
    import cv2

    img = np.zeros((h, w, 3), np.float32)
    for o in range(octaves):
        s = 2 ** (octaves - o)
        small = rng.rand(max(2, h // s), max(2, w // s), 3).astype(np.float32)
        img += cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR) / (o + 1)
    # surface-attached high-frequency detail (consistent across views: it
    # lives in texture space, not pixel space)
    img += 0.35 * rng.rand(h, w, 3).astype(np.float32)
    img += 0.35 * cv2.resize(
        rng.rand(h // 2, w // 2, 3).astype(np.float32), (w, h),
        interpolation=cv2.INTER_LINEAR,
    )
    img -= img.min()
    img /= img.max() + 1e-6
    return img


def _euler_to_R(rx, ry, rz):
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (Rz @ Ry @ Rx).astype(np.float64)


class Plane:
    """Textured world plane: points X with n . X = d (camera-0 frame).

    ``vel`` (world units / frame step) makes the plane an independently
    moving object: at frame k its material points sit at X0 + k*vel. Exact
    GT flow for moving planes follows the material point, not the camera
    (see exact_flow); the dynamic-region masks and epipolar terms the geom
    objective carries exist precisely for such pixels
    (model_geometry.py:685-713).
    """

    def __init__(self, normal, dist, tex, tex_origin, tex_axes, tex_scale, vel=None):
        self.n = np.asarray(normal, np.float64)
        self.n /= np.linalg.norm(self.n)
        self.d = float(dist)
        self.tex = tex
        self.origin = np.asarray(tex_origin, np.float64)  # world point of tex (0,0)
        self.axes = np.asarray(tex_axes, np.float64)  # [2,3] world dirs of tex u,v
        self.scale = float(tex_scale)  # world units per texel
        self.bounds = (tex.shape[1], tex.shape[0])  # (u_max, v_max) texels
        self.vel = np.zeros(3) if vel is None else np.asarray(vel, np.float64)

    def at_frame(self, k):
        """Plane with its origin advanced k motion steps (n.X = d shifts by
        n . k*vel)."""
        if k == 0 or not self.vel.any():
            return self
        shift = k * self.vel
        return Plane(
            self.n, self.d + float(self.n @ shift), self.tex,
            self.origin + shift, self.axes, self.scale, self.vel,
        )


def render(planes, K, R, t, hw, frame_k=0, want_hits=False):
    """Render the camera (R, t: world->cam, X_cam = R X + t) over planes.

    ``frame_k`` advances each plane by k of its own motion steps (static
    planes are unaffected). Returns (img [H,W,3], depth [H,W]) with z-buffer
    compositing; pixels hitting no plane get depth=inf and black. With
    ``want_hits`` also returns (pid [H,W] int32 plane index or -1,
    X [H,W,3] world hit points) for exact-GT flow of moving objects.
    """
    h, w = hw
    Kinv = np.linalg.inv(K)
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    rays_px = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3).astype(np.float64)
    # cam-frame ray dirs -> world dirs; cam center in world: C = -R^T t
    dirs = (Kinv @ rays_px.T).T @ R  # world-frame directions (row vecs)
    C = -R.T @ t

    img = np.zeros((h * w, 3), np.float32)
    zbuf = np.full(h * w, np.inf, np.float64)
    pid = np.full(h * w, -1, np.int32)
    Xhit = np.zeros((h * w, 3), np.float64)
    for idx, p0 in enumerate(planes):
        p = p0.at_frame(frame_k)
        denom = dirs @ p.n
        lam = (p.d - C @ p.n) / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        X = C[None] + lam[:, None] * dirs  # world hit points
        z_cam = (X @ R.T + t)[:, 2]
        u = ((X - p.origin) @ p.axes[0]) / p.scale
        v = ((X - p.origin) @ p.axes[1]) / p.scale
        ok = (
            (lam > 0)
            & (z_cam > 0.1)
            & (u >= 0)
            & (v >= 0)
            & (u < p.bounds[0] - 1)
            & (v < p.bounds[1] - 1)
            & (z_cam < zbuf)
        )
        ui = np.clip(u[ok].astype(np.int64), 0, p.bounds[0] - 2)
        vi = np.clip(v[ok].astype(np.int64), 0, p.bounds[1] - 2)
        fu = (u[ok] - ui)[:, None].astype(np.float32)
        fv = (v[ok] - vi)[:, None].astype(np.float32)
        t00 = p.tex[vi, ui]
        t01 = p.tex[vi, ui + 1]
        t10 = p.tex[vi + 1, ui]
        t11 = p.tex[vi + 1, ui + 1]
        img[ok] = (1 - fv) * ((1 - fu) * t00 + fu * t01) + fv * ((1 - fu) * t10 + fu * t11)
        zbuf[ok] = z_cam[ok]
        pid[ok] = idx
        Xhit[ok] = X[ok]
    if want_hits:
        return (
            img.reshape(h, w, 3),
            zbuf.reshape(h, w),
            pid.reshape(h, w),
            Xhit.reshape(h, w, 3),
        )
    return img.reshape(h, w, 3), zbuf.reshape(h, w)


def make_scene(rng, hw, n_movers=0):
    """Random scene: ground plane + 2-3 floating fronto-ish billboards.

    ``n_movers`` of the billboards get an independent world velocity
    (KITTI-like: dominant lateral/longitudinal object motion) -- their
    pixels violate the rigid-scene assumption exactly the way real traffic
    does, exercising the dynamic-region masks and the epipolar terms.
    """
    h, w = hw
    planes = []
    # ground: normal ~(0,-1,0), camera 1.6m above
    gtex = _smooth_texture(rng, 1024, 1024)
    planes.append(
        Plane(
            normal=[0.0, -1.0, 0.0],
            dist=-1.6,
            tex=gtex,
            tex_origin=[-40.0, 1.6, 0.0],
            tex_axes=[[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
            tex_scale=80.0 / 1024,
        )
    )
    # far backdrop wall
    btex = _smooth_texture(rng, 512, 1024)
    zb = 55.0 + 20 * rng.rand()
    planes.append(
        Plane(
            normal=[0.0, 0.0, -1.0],
            dist=-zb,
            tex=btex,
            tex_origin=[-60.0, -25.0, zb],
            tex_axes=[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
            tex_scale=120.0 / 1024,
        )
    )
    # floating billboards (create parallax + occlusion boundaries)
    n_boards = rng.randint(2, 4)
    movers = set(rng.choice(n_boards, size=min(n_movers, n_boards), replace=False))
    for bi in range(n_boards):
        z0 = 8.0 + 25.0 * rng.rand()
        x0 = (rng.rand() - 0.5) * 0.8 * z0
        y0 = -2.5 * rng.rand()
        size = 2.0 + 4.0 * rng.rand()
        tex = _smooth_texture(rng, 256, 256)
        vel = None
        if bi in movers:
            # car-like: mostly lateral or longitudinal, 0.15-0.7 m/frame
            vel = np.array(
                [
                    (0.15 + 0.55 * rng.rand()) * (1 if rng.rand() < 0.5 else -1),
                    0.0,
                    0.5 * rng.randn(),
                ]
            )
        planes.append(
            Plane(
                normal=[0.0, 0.0, -1.0],
                dist=-z0,
                tex=tex,
                tex_origin=[x0, y0, z0],
                tex_axes=[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
                tex_scale=size / 256,
                vel=vel,
            )
        )
    return planes


def make_motion(rng):
    """KITTI-like ego-motion: dominant forward step + small rot/lateral."""
    dt = 0.8 + 0.8 * rng.rand()  # meters per frame
    t_step = np.array([0.05 * rng.randn(), 0.02 * rng.randn(), dt])
    r_step = np.array([0.004 * rng.randn(), 0.01 * rng.randn(), 0.002 * rng.randn()])
    return r_step, t_step


def pose_mats(r_step, t_step, k):
    """world->cam (R, t) after k motion steps (cam0 = identity)."""
    R_step = _euler_to_R(*r_step)
    R = np.eye(3)
    t = np.zeros(3)
    for _ in range(k):
        # new cam pose: X_cam' = R_step (X_cam - t_step)  (camera moves by
        # t_step/R_step in its own frame)
        R, t = R_step @ R, R_step @ (t - t_step)
    return R, t


def relative_pose(Ra, ta, Rb, tb):
    """tgt(a)->src(b) transform: X_b = R X_a + t (matches pose_vec2mat use)."""
    R = Rb @ Ra.T
    t = tb - R @ ta
    return R, t


def exact_flow_and_occ(planes, K, R_to, t_to, pid, Xhit, depth_to, dk):
    """Exact GT flow center->target following MATERIAL points, plus masks.

    For a center-frame pixel hitting plane p at world point X, the same
    material point dk frames later is X + dk*vel_p; its target-frame pixel is
    K(R_to (X + dk vel) + t_to). Returns (flow [H,W,2], occ [H,W] bool
    visible-in-target, dyn [H,W] bool moving-object pixel).

    Occlusion: the projected point's target-camera depth is compared with
    the target view's rendered z-buffer at the landing pixel (nearest
    sample, 0.25 m + 2% relative tolerance); a nearer surface there means
    the point is occluded.
    """
    h, w = pid.shape
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    vel = np.stack([p.vel for p in planes])  # [P,3]
    hit = pid >= 0
    Xm = Xhit + dk * vel[np.clip(pid, 0, None)] * hit[..., None]
    Xc = Xm @ R_to.T + t_to
    z = np.maximum(Xc[..., 2], 1e-6)
    pb = Xc @ K.T
    px = pb[..., 0] / z
    py = pb[..., 1] / z
    flow = np.stack([px - xs, py - ys], -1).astype(np.float32)

    xi = np.clip(np.round(px).astype(np.int64), 0, w - 1)
    yi = np.clip(np.round(py).astype(np.int64), 0, h - 1)
    z_seen = depth_to[yi, xi]
    visible = hit & np.isfinite(z_seen) & (z < z_seen + 0.25 + 0.02 * z)
    inb = (px >= 0) & (px < w - 1) & (py >= 0) & (py < h - 1)
    dyn = hit & (np.abs(vel[np.clip(pid, 0, None)]).sum(-1) > 0)
    return flow, visible & inb, dyn


def rigid_flow_from_depth(depth, K, R, t):
    """Exact flow of the camera-a image under (R,t) to camera-b, [H,W,2]."""
    h, w = depth.shape
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    pix = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3).astype(np.float64)
    X = (np.linalg.inv(K) @ pix.T).T * depth.reshape(-1, 1)
    Xb = X @ R.T + t
    pb = (K @ Xb.T).T
    pb = pb[:, :2] / np.maximum(pb[:, 2:3], 1e-6)
    flow = pb - pix[:, :2]
    return flow.reshape(h, w, 2).astype(np.float32)


def generate(out_dir, n_train=240, n_eval=8, hw=(256, 832), seed=0, n_movers=0):
    """Write a prepared-format dataset + eval GT npz files.

    ``n_movers`` > 0 adds that many independently-moving billboards per
    scene (exact GT follows the material points; eval npz gains
    ``dyn_mask``/``noc_mask``).
    """
    import cv2

    h, w = hw
    os.makedirs(os.path.join(out_dir, "scenes"), exist_ok=True)
    eval_dir = os.path.join(out_dir, "eval_gt")
    os.makedirs(eval_dir, exist_ok=True)
    fx = 0.58 * w
    fy = 1.92 * h / 2
    K = np.array([[fx, 0, w / 2], [0, fy, h / 2], [0, 0, 1]], np.float64)
    with open(os.path.join(out_dir, "calib.txt"), "w") as f:
        f.write(
            f"P_rect_02: {fx} 0.0 {w / 2} 0.0 0.0 {fy} {h / 2} 0.0 0.0 0.0 1.0 0.0\n"
        )

    rng = np.random.RandomState(seed)
    lines = []
    for i in range(n_train + n_eval):
        planes = make_scene(rng, hw, n_movers=n_movers)
        r_step, t_step = make_motion(rng)
        is_eval = i >= n_train
        frames, depths, mats = [], [], []
        hits = None
        for k in range(3):
            R, t = pose_mats(r_step, t_step, k)
            if is_eval and k == 1:
                img, depth, pid, Xhit = render(
                    planes, K, R, t, hw, frame_k=k, want_hits=True
                )
                hits = (pid, Xhit)
            else:
                img, depth = render(planes, K, R, t, hw, frame_k=k)
            frames.append(img)
            depths.append(depth)
            mats.append((R, t))
        stack = (np.concatenate(frames, axis=0) * 255).astype(np.uint8)
        if not is_eval:
            name = f"scenes/{i:06d}.png"
            cv2.imwrite(os.path.join(out_dir, name), stack[..., ::-1])
            lines.append(f"{name} calib.txt\n")
        else:
            j = i - n_train
            # GT for the CENTER frame (index 1)
            Rc, tc = mats[1]
            Rr, tr = mats[2]
            Rl, tl = mats[0]
            R_fwd, t_fwd = relative_pose(Rc, tc, Rr, tr)
            R_bwd, t_bwd = relative_pose(Rc, tc, Rl, tl)
            d_c = depths[1]
            finite = np.isfinite(d_c)
            d_c = np.where(finite, d_c, 1e3)
            pid, Xhit = hits
            flow_fwd, noc_fwd, dyn = exact_flow_and_occ(
                planes, K, Rr, tr, pid, Xhit, depths[2], dk=1
            )
            flow_bwd, noc_bwd, _ = exact_flow_and_occ(
                planes, K, Rl, tl, pid, Xhit, depths[0], dk=-1
            )
            np.savez_compressed(
                os.path.join(eval_dir, f"{j:03d}.npz"),
                img_l=(frames[0] * 255).astype(np.uint8),
                img_c=(frames[1] * 255).astype(np.uint8),
                img_r=(frames[2] * 255).astype(np.uint8),
                depth=d_c.astype(np.float32),
                valid=finite,
                flow_fwd=flow_fwd,
                flow_bwd=flow_bwd,
                noc_mask=noc_fwd,
                dyn_mask=dyn,
                R_fwd=R_fwd,
                t_fwd=t_fwd,
                R_bwd=R_bwd,
                t_bwd=t_bwd,
                K=K,
            )
    with open(os.path.join(out_dir, "train.txt"), "w") as f:
        f.writelines(lines)
    print(f"wrote {len(lines)} train stacks + {n_eval} eval GT to {out_dir}")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--n_train", type=int, default=240)
    ap.add_argument("--n_eval", type=int, default=8)
    ap.add_argument("--hw", type=int, nargs=2, default=[256, 832])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n_movers", type=int, default=0,
                    help="independently-moving billboards per scene")
    a = ap.parse_args()
    generate(a.out, a.n_train, a.n_eval, tuple(a.hw), a.seed, a.n_movers)
