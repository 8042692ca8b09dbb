"""Full KITTI odometry benchmark scorer + snippet ATE/RE (host-side numpy).

The port's own copy of the JAX package's ``evaluation/odom_eval.py``.
Mirrors the reference's core/evaluation/eval_odom.py: per-100m..800m segment
translational/rotational errors after alignment -- Sim(3) Umeyama (default),
rotation-only SE(3) Umeyama, or the translation-only least-squares scale mode
(eval_odom.py:259-280) -- plus the 5-frame-snippet ATE/RE used for the README
pose table (test.py:179-194), x/z trajectory plots (eval_odom.py:198-228)
and per-segment-length error plots. Plotting is optional (matplotlib gated).
"""

from __future__ import annotations

import copy
import importlib.util
import os

import numpy as np

SEGMENT_LENGTHS = (100, 200, 300, 400, 500, 600, 700, 800)


def scale_lse_solver(X: np.ndarray, Y: np.ndarray) -> float:
    """Least-squares scale s minimizing |s*X - Y|."""
    return np.sum(X * Y) / np.sum(X**2)


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = False):
    """Sim(m) alignment of point sets x, y [m, n] (Umeyama 1991).

    Returns (r, t, c) (eval_odom.py:22-69).
    """
    assert x.shape == y.shape
    m, n = x.shape
    mean_x = x.mean(axis=1)
    mean_y = y.mean(axis=1)
    sigma_x = 1.0 / n * (np.linalg.norm(x - mean_x[:, None]) ** 2)
    cov_xy = (y - mean_y[:, None]) @ (x - mean_x[:, None]).T / n
    u, d, v = np.linalg.svd(cov_xy)
    s = np.eye(m)
    if np.linalg.det(u) * np.linalg.det(v) < 0.0:
        s[m - 1, m - 1] = -1
    r = u @ s @ v
    c = 1 / sigma_x * np.trace(np.diag(d) @ s) if with_scale else 1.0
    t = mean_y - c * (r @ mean_x)
    return r, t, c


def compute_snippet_pose_error(gt: np.ndarray, pred: np.ndarray):
    """Scale-aligned ATE + RE of an N-frame snippet [N,3,4] (test.py:179-194)."""
    snippet_length = gt.shape[0]
    scale_factor = np.sum(gt[:, :, -1] * pred[:, :, -1]) / np.sum(pred[:, :, -1] ** 2)
    ATE = np.linalg.norm((gt[:, :, -1] - scale_factor * pred[:, :, -1]).reshape(-1))
    RE = 0.0
    for gt_pose, pred_pose in zip(gt, pred):
        R = gt_pose[:, :3] @ np.linalg.inv(pred_pose[:, :3])
        s = np.linalg.norm(
            [R[0, 1] - R[1, 0], R[1, 2] - R[2, 1], R[0, 2] - R[2, 0]]
        )
        c = np.trace(R) - 1
        RE += np.arctan2(s, c)
    return ATE / snippet_length, RE / snippet_length


class KittiEvalOdom:
    """Segment-error scorer over full trajectory txt files."""

    def __init__(self):
        self.lengths = list(SEGMENT_LENGTHS)
        self.step_size = 10

    def load_poses(self, file_name: str) -> dict:
        poses = {}
        with open(file_name) as f:
            for cnt, line in enumerate(f.readlines()):
                vals = [float(i) for i in line.split(" ")]
                with_idx = len(vals) == 13
                P = np.eye(4)
                for row in range(3):
                    for col in range(4):
                        P[row, col] = vals[row * 4 + col + with_idx]
                poses[vals[0] if with_idx else cnt] = P
        return poses

    def trajectory_distances(self, poses: dict) -> list:
        dist = [0.0]
        keys = sorted(poses.keys())
        for i in range(len(keys) - 1):
            d = poses[keys[i]][:3, 3] - poses[keys[i + 1]][:3, 3]
            dist.append(dist[i] + float(np.linalg.norm(d)))
        return dist

    @staticmethod
    def rotation_error(pose_error: np.ndarray) -> float:
        d = 0.5 * (np.trace(pose_error[:3, :3]) - 1.0)
        return float(np.arccos(max(min(d, 1.0), -1.0)))

    @staticmethod
    def translation_error(pose_error: np.ndarray) -> float:
        return float(np.linalg.norm(pose_error[:3, 3]))

    def _last_frame(self, dist, first_frame, length):
        for i in range(first_frame, len(dist)):
            if dist[i] > dist[first_frame] + length:
                return i
        return -1

    def calc_sequence_errors(self, poses_gt: dict, poses_result: dict) -> list:
        err = []
        dist = self.trajectory_distances(poses_gt)
        for first_frame in range(0, len(poses_gt), self.step_size):
            for length in self.lengths:
                last_frame = self._last_frame(dist, first_frame, length)
                if (
                    last_frame == -1
                    or last_frame not in poses_result
                    or first_frame not in poses_result
                ):
                    continue
                delta_gt = np.linalg.inv(poses_gt[first_frame]) @ poses_gt[last_frame]
                delta_res = (
                    np.linalg.inv(poses_result[first_frame]) @ poses_result[last_frame]
                )
                pose_error = np.linalg.inv(delta_res) @ delta_gt
                err.append(
                    [
                        first_frame,
                        self.rotation_error(pose_error) / length,
                        self.translation_error(pose_error) / length,
                        length,
                    ]
                )
        return err

    @staticmethod
    def scale_optimization(gt: dict, pred: dict) -> dict:
        """Translation-only alignment: rescale every predicted position by
        the least-squares scale factor vs GT (eval_odom.py:259-280)."""
        pred_updated = copy.deepcopy(pred)
        xyz_pred = np.asarray([pred[i][:3, 3] for i in pred])
        xyz_ref = np.asarray([gt[i][:3, 3] for i in pred])
        scale = scale_lse_solver(xyz_pred, xyz_ref)
        for i in pred_updated:
            pred_updated[i][:3, 3] *= scale
        return pred_updated

    def compute_segment_error(self, seq_errs: list) -> dict:
        """Average (t_err, r_err) per segment length (eval_odom.py:230-261)."""
        avg = {}
        for length in self.lengths:
            errs = [(e[2], e[1]) for e in seq_errs if e[3] == length]
            avg[length] = (
                [float(np.mean([x[0] for x in errs])), float(np.mean([x[1] for x in errs]))]
                if errs
                else []
            )
        return avg

    def eval_poses(self, poses_gt: dict, poses_result: dict,
                   alignment: str = "7dof", plot_dir: str | None = None,
                   seq: str | None = None):
        """First-frame-compensate, align, and score.

        ``alignment``: "7dof" = Sim(3) Umeyama with scale (the reference's
        live path), "6dof" = SE(3) Umeyama without scale, "scale" =
        translation-only least-squares rescale (eval_odom.py:259-280).
        Returns (t_err, r_err) in (fraction/m, rad/m); with ``plot_dir``
        also writes the trajectory and per-segment error plots.
        """
        poses_gt = copy.deepcopy(poses_gt)
        poses_result = copy.deepcopy(poses_result)

        idx_0 = sorted(poses_result.keys())[0]
        pred_0 = poses_result[idx_0]
        gt_0 = poses_gt[idx_0]
        for cnt in poses_result:
            poses_result[cnt] = np.linalg.inv(pred_0) @ poses_result[cnt]
            poses_gt[cnt] = np.linalg.inv(gt_0) @ poses_gt[cnt]

        if alignment == "scale":
            poses_result = self.scale_optimization(poses_gt, poses_result)
        elif alignment in ("7dof", "6dof"):
            xyz_result = np.stack([poses_result[c][:3, 3] for c in poses_result], 1)
            xyz_gt = np.stack([poses_gt[c][:3, 3] for c in poses_result], 1)
            r, t, scale = umeyama_alignment(xyz_result, xyz_gt, alignment == "7dof")
            align = np.eye(4)
            align[:3, :3] = r
            align[:3, 3] = t
            for cnt in poses_result:
                poses_result[cnt][:3, 3] *= scale
                poses_result[cnt] = align @ poses_result[cnt]
        else:
            raise ValueError(f"unknown alignment {alignment!r}")

        seq_err = self.calc_sequence_errors(poses_gt, poses_result)
        if plot_dir is not None:
            self.plot_path(seq or "seq", poses_gt, poses_result, plot_dir)
            self.plot_errors(seq or "seq", seq_err, plot_dir)
        if not seq_err:
            return float("nan"), float("nan")
        r_err = float(np.mean([e[1] for e in seq_err]))
        t_err = float(np.mean([e[2] for e in seq_err]))
        return t_err, r_err

    def plot_path(self, seq: str, poses_gt: dict, poses_result: dict,
                  out_dir: str) -> str:
        """Bird's-eye x/z trajectory plot (eval_odom.py:198-228)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure()
        ax = plt.gca()
        ax.set_aspect("equal")
        for label, poses in (("Ground Truth", poses_gt), ("Ours", poses_result)):
            xz = np.asarray(
                [[poses[i][0, 3], poses[i][2, 3]] for i in sorted(poses.keys())]
            )
            plt.plot(xz[:, 0], xz[:, 1], label=label)
        plt.legend(loc="upper right", prop={"size": 20})
        plt.xlabel("x (m)", fontsize=20)
        plt.ylabel("z (m)", fontsize=20)
        fig.set_size_inches(10, 10)
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"sequence_{seq}.pdf")
        plt.savefig(path, bbox_inches="tight", pad_inches=0)
        plt.close(fig)
        return path

    def plot_errors(self, seq: str, seq_err: list, out_dir: str) -> str:
        """Average t_err/r_err per segment length, the KITTI benchmark's
        standard error plot."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        avg = self.compute_segment_error(seq_err)
        lengths = [l for l in self.lengths if avg[l]]
        t = [avg[l][0] * 100 for l in lengths]
        r = [avg[l][1] / np.pi * 180 * 100 for l in lengths]
        fig, axes = plt.subplots(1, 2, figsize=(12, 5))
        axes[0].plot(lengths, t, "bs-")
        axes[0].set_xlabel("Path Length (m)")
        axes[0].set_ylabel("Translation Error (%)")
        axes[1].plot(lengths, r, "bs-")
        axes[1].set_xlabel("Path Length (m)")
        axes[1].set_ylabel("Rotation Error (deg/100m)")
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"errors_{seq}.pdf")
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
        return path

    def eval(self, gt_txt: str, result_txt: str, seq: str | None = None,
             alignment: str = "7dof", plot: bool = True):
        """CLI-compatible entry: score txt files, print the standard summary,
        and (like the reference, eval_odom.py:285-343) drop trajectory/error
        plots next to the result file where matplotlib is installed."""
        poses_result = self.load_poses(result_txt)
        poses_gt = self.load_poses(gt_txt)
        if plot and importlib.util.find_spec("matplotlib") is None:
            print("plots skipped: matplotlib is not installed")
            plot = False
        plot_dir = (
            os.path.join(os.path.dirname(os.path.abspath(result_txt)), "plot_path")
            if plot
            else None
        )
        t_err, r_err = self.eval_poses(
            poses_gt, poses_result, alignment=alignment, plot_dir=plot_dir, seq=seq
        )
        print("Sequence: " + str(seq))
        print("Translational error (%): ", t_err * 100)
        print("Rotational error (deg/100m): ", r_err / np.pi * 180 * 100)
        return t_err, r_err
