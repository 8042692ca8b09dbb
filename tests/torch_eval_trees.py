"""Small synthetic trees in the layouts the eval tasks read, made from a seed
with numpy and written with cv2: KITTI flow 2012/2015, the raw eigen split
with its ``gt_depths.npz``, one odometry sequence and the labeled NYU test
split. Shared by the port's eval tests."""

import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from unsupervised_depth_opticalflow_egomotion_torch.evaluation import write_flow_png  # noqa: E402


def texture(rng, h, w):
    """A smooth random uint8 texture [h, w, 3] (sums of sinusoids)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    tex = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        for _ in range(3):
            fy, fx = rng.uniform(0.05, 0.4, 2)
            tex[..., c] += np.sin(fy * yy + fx * xx + rng.uniform(0, 6.3))
    tex = (tex - tex.min()) / (tex.max() - tex.min() + 1e-6)
    return (255 * tex).astype(np.uint8)


def kitti_flow_tree(root: str, n: int, hw=(24, 48), seed: int = 0) -> str:
    """``n`` pairs: image_2/{i}_10.png and _11.png, flow_occ and flow_noc
    (16-bit flow PNGs; noc's valid pixels a subset of occ's), obj_map
    (uint16 object ids, 0 = background)."""
    rng = np.random.RandomState(seed)
    for sub in ("image_2", "flow_occ", "flow_noc", "obj_map"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    h, w = hw
    for i in range(n):
        name = f"{i:06d}_10.png"
        cv2.imwrite(os.path.join(root, "image_2", name), texture(rng, h, w))
        cv2.imwrite(os.path.join(root, "image_2", f"{i:06d}_11.png"), texture(rng, h, w))
        u = rng.uniform(-6, 6, (h, w))
        v = rng.uniform(-4, 4, (h, w))
        valid = (rng.rand(h, w) > 0.2).astype(np.float64)
        noc = valid * (rng.rand(h, w) > 0.3)
        write_flow_png(os.path.join(root, "flow_occ", name), u, v, valid)
        write_flow_png(os.path.join(root, "flow_noc", name), u, v, noc)
        obj = (rng.rand(h, w) > 0.7).astype(np.uint16) * rng.randint(1, 4, (h, w)).astype(np.uint16)
        cv2.imwrite(os.path.join(root, "obj_map", name), obj)
    return root


def eigen_tree(root: str, n: int, hw=(30, 100), seed: int = 0) -> tuple[str, str, str]:
    """``n`` frames under a raw_base_dir layout
    (<date>/<drive>/image_02/data/<idx>.png), the test list and
    ``gt_depths.npz`` (sparse depth maps in (1, 80) m, zero elsewhere).
    Returns (raw_base_dir, test_files.txt, gt_depths.npz)."""
    rng = np.random.RandomState(seed)
    raw = os.path.join(root, "raw")
    drive = "2011_09_26/2011_09_26_drive_0002_sync"
    data = os.path.join(raw, drive, "image_02", "data")
    os.makedirs(data, exist_ok=True)
    h, w = hw
    lines, depths = [], []
    for i in range(n):
        idx = f"{i:010d}"
        cv2.imwrite(os.path.join(data, idx + ".png"), texture(rng, h, w))
        lines.append(f"{drive} {idx} l\n")
        depth = rng.uniform(1.0, 80.0, (h, w)) * (rng.rand(h, w) > 0.5)
        depths.append(depth.astype(np.float32))
    files_txt = os.path.join(root, "test_files.txt")
    with open(files_txt, "w") as f:
        f.writelines(lines)
    gt_npz = os.path.join(root, "gt_depths.npz")
    arr = np.empty(n, dtype=object)
    arr[:] = depths
    np.savez_compressed(gt_npz, data=arr)
    return raw, files_txt, gt_npz


def odom_tree(root: str, n: int, hw=(24, 48), seed: int = 0, step_m: float = 0.5) -> str:
    """Sequence 09 of ``n`` frames (sequences/09/image_2) and poses/09.txt: a
    camera moving ``step_m`` along z a frame while it turns slowly about y."""
    rng = np.random.RandomState(seed)
    seq = os.path.join(root, "sequences", "09", "image_2")
    os.makedirs(seq, exist_ok=True)
    os.makedirs(os.path.join(root, "poses"), exist_ok=True)
    lines = []
    for i in range(n):
        cv2.imwrite(os.path.join(seq, f"{i:06d}.png"), texture(rng, *hw))
        a = 0.01 * i
        P = np.array([[np.cos(a), 0, np.sin(a), 0.1 * np.sin(a) * i],
                      [0, 1, 0, 0.02 * i],
                      [-np.sin(a), 0, np.cos(a), step_m * i]])
        lines.append(" ".join(f"{v:.9e}" for v in P.reshape(-1)))
    with open(os.path.join(root, "poses", "09.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return root


def nyu_tree(root: str, n: int, seed: int = 0) -> str:
    """nyu_depth_v2_labeled.mat ([N,3,W,H] images, [N,W,H] depths) of ``n``
    frames at 480x640 and splits.mat naming every frame a test frame."""
    import h5py
    import scipy.io as sio

    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    with h5py.File(os.path.join(root, "nyu_depth_v2_labeled.mat"), "w") as f:
        f["images"] = rng.randint(0, 255, (n, 3, 640, 480), np.uint8)
        f["depths"] = rng.uniform(1.0, 5.0, (n, 640, 480)).astype(np.float32)
    sio.savemat(os.path.join(root, "splits.mat"),
                {"testNdxs": np.arange(1, n + 1, dtype=np.int64)[:, None]})
    return root
