"""Evaluation tasks: KITTI flow 2012/2015, eigen depth, odometry pose.

The port's counterpart of the JAX package's ``eval_tasks.py``. Inference
runs in batches on the model's device (the reference feeds single images);
the metric protocols are the JAX package's, bit for bit (Garg crop + median
scaling for depth, flow value-rescaling to GT resolution,
snippet-compensated ATE/RE for pose). The tasks are host-side numpy and
take the inference closures of ``make_inference_fns``, which move each
numpy batch to the card and return numpy; the flow tasks take the legacy
two-view inference (``make_two_view_inference_fn`` over a
``TriangulationPoseModel``) in its place when given ``two_view_fn``.
"""

from __future__ import annotations

import contextlib
import glob
import os

import numpy as np
import torch

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

from .config import Config
from .data.kitti_flow import KittiFlowEval
from .data.kitti_pose import KittiPoseEval
from .evaluation import compute_snippet_pose_error, eval_depth, eval_flow_avg, write_flow_png
from .evaluation.flow_io import resize_flow
from .ops.geometry import pose_vec2mat
from .utils.device import resolve_device

def _batched(items, batch_size):
    for i in range(0, len(items), batch_size):
        yield items[i : i + batch_size]


@contextlib.contextmanager
def full_precision():
    """f32 convolutions and matmuls without TF32 for the duration, as the JAX
    eval asks for full precision (test.py:56). The previous settings come
    back after, so an interleaved eval leaves the training step's as they
    were."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def make_inference_fns(model, device=None):
    """(flow_fn, disp_fn, pose_fn) over ``model`` (a ``JointModel``, moved to
    ``device``: CUDA unless ``device="cpu"``; raises without a card).

    Each takes float32 numpy batches (NHWC frames in [0, 1]), moves them to
    the device, runs the model's inference method under
    ``torch.inference_mode()`` and ``full_precision()``, and returns numpy:
    ``flow_fn(img1, img2)`` -> [b,H,W,2], ``disp_fn(img)`` -> [b,H,W,1],
    ``pose_fn(imgs)`` ([b,H,W,9]) -> [b,2,6]. The closures read the model's
    tensors at each call: a model that takes new weights needs no new
    closures.
    """
    dev = resolve_device(device)
    model.to(dev)

    def run(method, *arrays):
        with torch.inference_mode(), full_precision():
            args = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev) for a in arrays]
            return method(*args).cpu().numpy()

    return (
        lambda img1, img2: run(model.inference_flow, img1, img2),
        lambda img: run(model.infer_disp, img),
        lambda imgs: run(model.infer_pose, imgs),
    )


def make_two_view_inference_fn(tv_model, device=None):
    """The legacy two-view inference over ``tv_model`` (a
    ``TriangulationPoseModel``, moved to ``device``: CUDA unless
    ``device="cpu"``; raises without a card): ``fn(img1, img2, K, K_inv)``
    on float32 numpy batches returns numpy (flow [b,H,W,2], disp1, disp2
    [b,H,W,1], Rt [b,3,4]), run under ``torch.inference_mode()`` and
    ``full_precision()`` with the model's default draws (seed 0)."""
    dev = resolve_device(device)
    tv_model.to(dev)

    def fn(img1, img2, K, K_inv):
        with torch.inference_mode(), full_precision():
            args = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
                    for a in (img1, img2, K, K_inv)]
            flow, disp1, disp2, Rt, _, _ = tv_model.inference(*args)
            return tuple(t.cpu().numpy() for t in (flow, disp1, disp2, Rt))

    return fn


def predict_flows(cfg: Config, flow_fn, mode: str, batch_size: int = 8, two_view_fn=None):
    """Run flow inference over a KITTI flow benchmark -> list of [h,w,2].

    With ``two_view_fn`` the flow comes from the legacy two-view pipeline
    (the reference's test.py:33,64: ``model.inference(img1, img2, K,
    K_inv)`` in the non-geom branch). Samples are decoded batch by batch so
    only one batch is resident on the host at a time.
    """
    dataset = KittiFlowEval(
        cfg.gt_2012_dir if mode == "kitti_2012" else cfg.gt_2015_dir,
        mode=mode,
        img_hw=cfg.img_hw,
    )
    flows = []
    for group_idx in _batched(list(range(len(dataset))), batch_size):
        group = [dataset[i] for i in group_idx]
        imgs = np.stack([s[0] for s in group])  # [b, 2H, W, 3]
        h = imgs.shape[1] // 2
        if two_view_fn is not None:
            K = np.stack([s[1] for s in group])
            K_inv = np.stack([s[2] for s in group])
            flow = np.asarray(two_view_fn(imgs[:, :h], imgs[:, h:], K, K_inv)[0])
        else:
            flow = np.asarray(flow_fn(imgs[:, :h], imgs[:, h:]))
        flows.extend(flow[i] for i in range(flow.shape[0]))
    return flows


def test_kitti_flow(cfg: Config, flow_fn, gt_flows, noc_masks, mode: str,
                    moving_masks=None, submission_dir: str | None = None, two_view_fn=None):
    """Flow benchmark eval; optionally writes 16-bit submission PNGs
    (test.py:267-312). ``two_view_fn`` as in ``predict_flows``."""
    flows = predict_flows(cfg, flow_fn, mode, two_view_fn=two_view_fn)
    if submission_dir:
        os.makedirs(submission_dir, exist_ok=True)
        for i, f in enumerate(flows):
            H, W = gt_flows[i].shape[:2]
            f_sub = resize_flow(f.copy(), (H, W))
            write_flow_png(
                os.path.join(submission_dir, f"{str(i).zfill(6)}_10.png"),
                f_sub[:, :, 0],
                f_sub[:, :, 1],
            )
    return eval_flow_avg(gt_flows, noc_masks, flows, cfg.img_hw, moving_masks=moving_masks)


# Decoded+resized uint8 test frames, keyed by (path, h, w): interleaved
# training evals hit the same 697 PNGs every test_interval; caching the
# resized uint8 (~0.6 MB/frame) avoids re-decoding them each time while
# holding 3x less than a f32 copy would.
_EIGEN_DECODE_CACHE: dict = {}


def test_eigen_depth(cfg: Config, disp_fn, batch_size: int = 8):
    """Eigen-split depth eval (test.py:102-132), streamed batch by batch.

    CONVENTION (subtle but load-bearing, the JAX package's eval_tasks.py:
    135-151): the joint objective trains the sigmoid head's output as DEPTH
    directly (model_geometry.py:798-801 feeds disp_list into inverse_warp2's
    depth slot), and the reference's eval chain inverts twice --
    ``infer_depth`` returns 1/(0.01+9.99*sigma) (disp2depth,
    model_geometry.py:282-292) and ``resize_depths`` inverts that AGAIN
    (test.py:88-99) -- so the scored depth is affine in the raw sigma,
    CONSISTENT with training. Scoring 1/(sigma+1e-4) instead gives an
    anti-correlated depth map. The chain here is the reference's: resize
    infer_depth's output to GT, then 1/(x + 1e-4), then Garg crop + median
    scaling.
    """
    files_txt = cfg.eigen_test_files_txt or "./data/eigen/test_files.txt"
    gt_npz = cfg.eigen_gt_depths_npz or "./data/eigen/gt_depths.npz"
    with open(files_txt) as f:
        paths = []
        for line in f:
            path1, idx = line.strip().split(" ")[:2]
            paths.append(
                os.path.join(cfg.raw_base_dir, path1, "image_02/data", str(idx) + ".png")
            )
    h, w = cfg.img_hw

    def _decode(path):
        key = (path, h, w)
        img = _EIGEN_DECODE_CACHE.get(key)
        if img is None:
            img = cv2.resize(cv2.imread(path), (w, h))  # uint8
            _EIGEN_DECODE_CACHE[key] = img
        return img

    gt_depths = np.load(gt_npz, allow_pickle=True)["data"]
    per_image = []
    i = 0
    for group in _batched(paths, batch_size):
        batch = np.stack([_decode(p) for p in group]).astype(np.float32) / 255.0
        sigma = np.asarray(disp_fn(batch))[..., 0]
        # infer_depth's bounded transform (disp2depth with min 0.1 max 100)
        d = 1.0 / (0.01 + (10.0 - 0.01) * sigma)
        for j in range(d.shape[0]):
            gt = gt_depths[i]
            gh, gw = gt.shape
            disp_r = cv2.resize(d[j], (gw, gh))
            per_image.append(eval_depth([gt], [1.0 / (disp_r + 1e-4)]))
            i += 1
    return list(np.mean(np.asarray(per_image, np.float64), axis=0))


def _pose_mats(pvecs: np.ndarray) -> np.ndarray:
    """Pose vectors [n,6] -> the warp transforms [n,3,4] in float64."""
    return pose_vec2mat(torch.from_numpy(np.asarray(pvecs, np.float32))).numpy().astype(np.float64)


def test_pose_odom(cfg: Config, pose_fn, batch_size: int = 8):
    """5-frame-snippet ATE/RE over odometry sequences (test.py:135-176).

    Returns (mean, std) arrays of [ATE, RE].
    """
    dataset = KittiPoseEval(cfg.kitti_odom_dir, cfg.sequences, 3)
    h, w = cfg.img_hw
    errors = []

    samples = list(dataset)
    for group in _batched(samples, batch_size):
        stacks = []
        for s in group:
            imgs = [cv2.resize(im, (w, h)).astype(np.float32) for im in s["imgs"]]
            stacks.append(np.concatenate(imgs, axis=2) / 255.0)
        poses = np.asarray(pose_fn(np.stack(stacks)))  # [b, 2, 6]

        for s, pvecs in zip(group, poses):
            snippet = np.concatenate(
                [pvecs[0].reshape(1, 6), np.zeros((1, 6), np.float32), pvecs[1].reshape(1, 6)]
            )
            inv_mats = _pose_mats(snippet)
            rot = np.linalg.inv(inv_mats[:, :, :3])
            tr = -rot @ inv_mats[:, :, -1:]
            mats = np.concatenate([rot, tr], axis=-1)
            first_inv = inv_mats[0]
            final = first_inv[:, :3] @ mats
            final[:, :, -1:] += first_inv[:, -1:]
            errors.append(compute_snippet_pose_error(s["poses"], final))

    errors = np.asarray(errors, np.float64)
    return errors.mean(0), errors.std(0)


def export_trajectory(cfg: Config, pose_fn, seq: str, out_txt: str, batch_size: int = 8):
    """Chain per-snippet relative poses into a full KITTI trajectory txt.

    Feeds consecutive 3-frame snippets through ``pose_fn``, uses the
    center->right relative pose of each snippet to integrate a global
    trajectory, and writes the 3x4 rows in KITTI odometry format so
    ``evaluation.KittiEvalOdom.eval`` can score it against the GT poses.
    """
    seq_dir = os.path.join(cfg.kitti_odom_dir, "sequences", seq, "image_2")
    frames = sorted(glob.glob(os.path.join(seq_dir, "*.png")))
    h, w = cfg.img_hw

    rel_mats = []
    snippets = []
    for i in range(1, len(frames) - 1):
        snippets.append((frames[i - 1], frames[i], frames[i + 1]))

    def _motion_from_pvec(pvec_row):
        """Camera motion 3x4 from a warp pose vector (invert the transform)."""
        inv = _pose_mats(pvec_row)[0]
        R = np.linalg.inv(inv[:, :3])
        t = -R @ inv[:, 3:]
        return np.concatenate([R, t], axis=1)

    first_bwd = None
    for group_start in range(0, len(snippets), batch_size):
        group = snippets[group_start : group_start + batch_size]
        stack = []
        for paths in group:
            imgs = [
                cv2.resize(cv2.imread(p), (w, h)).astype(np.float32) / 255.0
                for p in paths
            ]
            stack.append(np.concatenate(imgs, axis=2))
        poses = np.asarray(pose_fn(np.stack(stack)))  # [b,2,6]
        for pvec in poses:
            if first_bwd is None:
                # the first snippet's bwd pose gives frame1->frame0 motion;
                # its inverse is the frame0->frame1 edge, closing the
                # one-frame gap at the head of the trajectory
                M = np.eye(4)
                M[:3] = _motion_from_pvec(pvec[0:1])
                first_bwd = np.linalg.inv(M)[:3]
            # fwd pose maps center->right; invert to get the camera motion
            rel_mats.append(_motion_from_pvec(pvec[1:2]))

    # integrate: pose_0 = I; pose_1 = inv(first bwd); pose_{i+1} = pose_i @ rel_i
    rel_mats = ([first_bwd] if first_bwd is not None else []) + rel_mats
    global_poses = [np.eye(4)]
    for rel in rel_mats:
        T = np.eye(4)
        T[:3] = rel
        global_poses.append(global_poses[-1] @ T)
    lines = []
    for P in global_poses:
        lines.append(" ".join(f"{v:.9e}" for v in P[:3].reshape(-1)))
    os.makedirs(os.path.dirname(os.path.abspath(out_txt)), exist_ok=True)
    with open(out_txt, "w") as f:
        f.write("\n".join(lines) + "\n")
    return out_txt


def test_single_image(img_path: str, disp_fn, training_hw, save_dir: str = "./"):
    """Depth demo on one image (test.py:252-264)."""
    from .visualize import save_disp_color_img

    img = cv2.imread(img_path)
    h, w = img.shape[:2]
    resized = cv2.resize(img, (training_hw[1], training_hw[0])).astype(np.float32) / 255.0
    sigma = np.asarray(disp_fn(resized[None]))[0, ..., 0]
    # the reference demo colormaps infer_depth's output (bounded disparity
    # 1/(0.01+9.99*sigma), test.py:252-264) -- sigma itself trains as depth
    disp = 1.0 / (0.01 + (10.0 - 0.01) * sigma)
    disp_resized = cv2.resize(disp, (w, h))
    os.makedirs(save_dir, exist_ok=True)
    save_disp_color_img(disp_resized, os.path.join(save_dir, "demo.png"))
    return 1.0 / (1e-6 + disp_resized)
