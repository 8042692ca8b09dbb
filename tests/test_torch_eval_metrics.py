"""The port's metric harnesses, eval datasets and ``disp2depth`` against the
JAX package's, function by function, on the same seeded numpy inputs.

Both sides are host-side numpy copies of one another (the port imports
nothing of the JAX package), so the results must agree to rtol 1e-12: only
a change of the arithmetic would move them.
"""

import os

import numpy as np
import pytest
import torch

from torch_eval_trees import kitti_flow_tree, odom_tree
from unsupervised_depth_opticalflow_egomotion_torch import data as tdata
from unsupervised_depth_opticalflow_egomotion_torch import evaluation as tev
from unsupervised_depth_opticalflow_egomotion_torch.ops import geometry as tgeo
from unsupervised_depth_opticalflow_egomotion_tpu import data as jdata
from unsupervised_depth_opticalflow_egomotion_tpu import evaluation as jev
from unsupervised_depth_opticalflow_egomotion_tpu.ops import geometry as jgeo

pytestmark = pytest.mark.quick
torch.set_num_threads(2)

RTOL = 1e-12


def _same(got, want):
    """Equal to RTOL, element by element, through nested tuples, lists and dicts."""
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                                   rtol=RTOL, atol=0)


@pytest.fixture(scope="module")
def flow_tree(tmp_path_factory):
    """200 pairs at 24x48: enough for kitti_2015 (200) and kitti_2012 (194)."""
    return kitti_flow_tree(str(tmp_path_factory.mktemp("kflow")), 200)


def _depth_pairs(rng, n=3, h=40, w=120):
    gts = [rng.uniform(0.5, 90.0, (h, w)) * (rng.rand(h, w) > 0.3) for _ in range(n)]
    preds = [g * rng.uniform(0.5, 1.5, (h, w)) + rng.uniform(0.1, 2.0, (h, w)) for g in gts]
    return gts, preds


@pytest.mark.parametrize("nyu", [False, True], ids=["kitti", "nyu"])
def test_depth_metrics(nyu):
    """compute_errors on masked values, and eval_depth (Garg crop and
    median scaling for KITTI, log10 for NYU)."""
    rng = np.random.RandomState(0)
    gts, preds = _depth_pairs(rng)
    gt, pred = gts[0][gts[0] > 0], preds[0][gts[0] > 0]
    _same(tev.compute_errors(gt, pred, nyu=nyu), jev.compute_errors(gt, pred, nyu=nyu))
    _same(tev.eval_depth(gts, preds, nyu=nyu), jev.eval_depth(gts, preds, nyu=nyu))


def _flows(rng, n=3, h=30, w=50, img_hw=(16, 32)):
    gt = []
    for _ in range(n):
        g = np.zeros((h, w, 3))
        g[..., :2] = rng.uniform(-20, 20, (h, w, 2))
        g[..., 2] = rng.rand(h, w) > 0.2
        gt.append(g)
    noc = [g[..., 2] * (rng.rand(h, w) > 0.3) for g in gt]
    # predictions at img_hw near the GT scaled down, some pixels far off
    pred = []
    for g in gt:
        p = np.stack([np.resize(g[..., 0], img_hw) * img_hw[1] / w,
                      np.resize(g[..., 1], img_hw) * img_hw[0] / h], -1)
        pred.append((p + rng.normal(0, 2.0, p.shape)).astype(np.float32))
    moving = [(rng.rand(h, w) > 0.6).astype(np.float64) for _ in range(n)]
    return gt, noc, pred, moving


def test_calculate_error_rate():
    rng = np.random.RandomState(1)
    gt, noc, _, _ = _flows(rng)
    epe = rng.uniform(0, 8, gt[0].shape[:2])
    _same(tev.calculate_error_rate(epe, gt[0][..., :2], noc[0]),
          jev.calculate_error_rate(epe, gt[0][..., :2], noc[0]))


@pytest.mark.parametrize("moving", [False, True], ids=["all", "moving_masks"])
def test_eval_flow_avg_and_format(moving):
    """EPE all/noc/occ, Fl, and with moving masks the move/static split;
    the printed table is the same text."""
    rng = np.random.RandomState(2)
    gt, noc, pred, masks = _flows(rng)
    kw = {"moving_masks": masks} if moving else {}
    got = tev.eval_flow_avg(gt, noc, pred, (16, 32), **kw)
    want = jev.eval_flow_avg(gt, noc, pred, (16, 32), **kw)
    _same(got, want)
    assert len(got) == (8 if moving else 4)
    assert tev.format_flow_metrics(got) == jev.format_flow_metrics(want)


@pytest.mark.parametrize("mode", ["kitti_2012", "kitti_2015"])
def test_load_gt_flow_kitti(flow_tree, mode):
    """194 / 200 GT flows and noc masks through each package's process pool
    (the port's spawns its workers)."""
    got = tev.load_gt_flow_kitti(flow_tree, mode, num_workers=2)
    want = jev.load_gt_flow_kitti(flow_tree, mode, num_workers=2)
    assert len(got[0]) == len(got[1]) == (194 if mode == "kitti_2012" else 200)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_load_gt_mask_and_eval_mask(flow_tree):
    """The binary moving-object masks, and the four segmentation scores of
    predicted masks against them."""
    got = tev.load_gt_mask(flow_tree, num_gt=12, num_workers=2)
    want = jev.load_gt_mask(flow_tree, num_gt=12, num_workers=2)
    assert len(got) == 12 and set(np.unique(got[0])) == {0.0, 1.0}
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    rng = np.random.RandomState(3)
    preds = [rng.rand(16, 32).astype(np.float32) for _ in got]
    _same(tev.eval_mask(preds, got), jev.eval_mask(preds, want))


def test_pose_alignment_and_snippet_error():
    """umeyama_alignment with and without scale, scale_lse_solver and the
    5-frame snippet ATE/RE."""
    rng = np.random.RandomState(4)
    x = rng.randn(3, 40)
    y = 1.7 * (np.linalg.qr(rng.randn(3, 3))[0] @ x) + rng.randn(3, 1) + 0.01 * rng.randn(3, 40)
    for with_scale in (False, True):
        _same(tev.umeyama_alignment(x, y, with_scale), jev.umeyama_alignment(x, y, with_scale))
    _same(tev.scale_lse_solver(x, y), jev.scale_lse_solver(x, y))
    gt = np.concatenate([np.linalg.qr(rng.randn(5, 3, 3))[0], rng.randn(5, 3, 1)], -1)
    pred = gt + 0.05 * rng.randn(5, 3, 4)
    _same(tev.compute_snippet_pose_error(gt, pred), jev.compute_snippet_pose_error(gt, pred))


def test_kitti_eval_odom(tmp_path):
    """The segment scorer on a 300 m trajectory with drift, under each
    alignment, and the txt entry point (without plots)."""
    rng = np.random.RandomState(5)
    n = 301
    gt_lines, pred_lines = [], []
    for i in range(n):
        a = 0.002 * i
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        t = np.array([5 * np.sin(a), 0.0, 1.0 * i])
        gt_lines.append(" ".join(f"{v:.9e}" for v in np.hstack([R, t[:, None]]).reshape(-1)))
        tp = 0.8 * t + 0.01 * i * rng.randn(3)
        pred_lines.append(" ".join(f"{v:.9e}" for v in np.hstack([R, tp[:, None]]).reshape(-1)))
    gt_txt, res_txt = tmp_path / "gt.txt", tmp_path / "res.txt"
    gt_txt.write_text("\n".join(gt_lines))
    res_txt.write_text("\n".join(pred_lines))
    t_od, j_od = tev.KittiEvalOdom(), jev.KittiEvalOdom()
    gt_p, res_p = t_od.load_poses(str(gt_txt)), t_od.load_poses(str(res_txt))
    for alignment in ("7dof", "6dof", "scale"):
        got = t_od.eval_poses(gt_p, res_p, alignment=alignment)
        assert np.isfinite(got).all()
        _same(got, j_od.eval_poses(gt_p, res_p, alignment=alignment))
    _same(t_od.compute_segment_error(t_od.calc_sequence_errors(gt_p, res_p)),
          j_od.compute_segment_error(j_od.calc_sequence_errors(gt_p, res_p)))
    _same(t_od.eval(str(gt_txt), str(res_txt), seq="09", plot=False),
          j_od.eval(str(gt_txt), str(res_txt), seq="09", plot=False))


@pytest.mark.parametrize("mode", ["kitti_2012", "kitti_2015"])
def test_kitti_flow_eval_samples(flow_tree, mode):
    """KittiFlowEval: length by mode, and samples (stacked pair, K, K^-1) with
    and without a calib file (K rescaled with the port's rescale_intrinsics)."""
    calib = os.path.join(flow_tree, "calib_cam_to_cam")
    os.makedirs(calib, exist_ok=True)
    with open(os.path.join(calib, "000001.txt"), "w") as f:
        f.write("P_rect_02: 721.5 0.0 609.6 44.9 0.0 721.5 172.9 0.2 0.0 0.0 1.0 0.003\n")
    got = tdata.KittiFlowEval(flow_tree, mode, img_hw=(16, 32))
    want = jdata.KittiFlowEval(flow_tree, mode, img_hw=(16, 32))
    assert len(got) == len(want) == (194 if mode == "kitti_2012" else 200)
    for i in (0, 1, 193):
        for a, b in zip(got[i], want[i]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert got[0][0].shape == (32, 32, 3) and not np.array_equal(got[1][1], np.eye(3))


def test_kitti_pose_eval_samples(tmp_path):
    """KittiPoseEval: 3-frame snippets with first-frame-compensated GT poses."""
    root = odom_tree(str(tmp_path / "odom"), 7)
    got = tdata.KittiPoseEval(root, ("09",), 3)
    want = jdata.KittiPoseEval(root, ("09",), 3)
    assert len(got) == len(want) == 5
    for i in range(len(got)):
        g, w = got[i], want[i]
        assert [p for p in got.samples[i]["imgs"]] == want.samples[i]["imgs"]
        for a, b in zip(g["imgs"], w["imgs"]):
            np.testing.assert_array_equal(a, b)
        _same(g["poses"], w["poses"])


def test_calib():
    """The raw calib parsing and the scaled intrinsics."""
    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
        f.write("calib_time: 09-Jan-2012 13:57:47\n"
                "P_rect_02: 721.5 0.1 609.6 44.9 0.2 721.5 172.9 0.2 0.3 0.4 1.0 0.003\n")
    try:
        _same(tev.load_intrinsics_raw(f.name), jev.load_intrinsics_raw(f.name))
        _same(tev.get_scaled_intrinsic_matrix(f.name, 0.5, 0.25),
              jev.get_scaled_intrinsic_matrix(f.name, 0.5, 0.25))
    finally:
        os.remove(f.name)


def test_disp2depth():
    """Sigmoid disparity -> depth in [0.1, 100], f32 against the JAX op."""
    disp = np.random.RandomState(6).rand(2, 8, 16, 1).astype(np.float32)
    disp[0, 0, 0, 0], disp[0, 0, 1, 0] = 0.0, 1.0
    got = tgeo.disp2depth(torch.from_numpy(disp)).numpy()
    want = np.asarray(jgeo.disp2depth(disp))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0, 0, 0, 0] == pytest.approx(100.0) and got[0, 0, 1, 0] == pytest.approx(0.1)
