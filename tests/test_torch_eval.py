"""The port's evaluation and inference against the JAX package's, on the CPU
at 64x128 in f32: the four inference methods of ``JointModel``, every eval
task of ``eval_tasks`` (and NYU's), and the port's eval CLI for every task.

The weights are the JAX package's initialisation carried across by
``load_jax_variables``, with seeded non-trivial BatchNorm running statistics
(an eval that used batch statistics would not match). Each JAX inference
function compiles once: every batch here has four items (one for the demo).
"""

import copy
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_eval_trees import eigen_tree, kitti_flow_tree, nyu_tree, odom_tree
from unsupervised_depth_opticalflow_egomotion_torch import eval_tasks as ttasks
from unsupervised_depth_opticalflow_egomotion_torch import test as tcli
from unsupervised_depth_opticalflow_egomotion_torch.config import Config
from unsupervised_depth_opticalflow_egomotion_torch.data import KittiFlowEval as TFlowEval
from unsupervised_depth_opticalflow_egomotion_torch.data import nyu as tnyu
from unsupervised_depth_opticalflow_egomotion_torch.evaluation import (
    format_flow_metrics as tformat_flow_metrics,
    load_gt_flow_kitti as tload_gt_flow_kitti,
    read_flow_png,
)
from unsupervised_depth_opticalflow_egomotion_torch.parallel import build_model, make_optimizer
from unsupervised_depth_opticalflow_egomotion_torch.utils import CheckpointManager, load_jax_variables
from unsupervised_depth_opticalflow_egomotion_tpu import eval_tasks as jtasks
from unsupervised_depth_opticalflow_egomotion_tpu.config import Config as JConfig
from unsupervised_depth_opticalflow_egomotion_tpu.data import KittiFlowEval as JFlowEval
from unsupervised_depth_opticalflow_egomotion_tpu.data import nyu as jnyu
from unsupervised_depth_opticalflow_egomotion_tpu.evaluation.flow_metrics import _read_flow_gt_worker
from unsupervised_depth_opticalflow_egomotion_tpu.parallel import init_state

pytestmark = pytest.mark.quick
torch.set_num_threads(2)

H, W = 64, 128
B = 4  # every batch of the tasks below
REPO = Path(__file__).resolve().parents[1]
MODEL = dict(img_hw=(H, W), compute_dtype="float32")


def _bn_stats(batch_stats, seed=0):
    """The running statistics replaced by seeded values far from (0, 1)."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = getattr(path[-1], "key", "")
        if name == "mean":
            return jnp.asarray(rng.normal(0.0, 0.3, x.shape), x.dtype)
        return jnp.asarray(rng.uniform(0.3, 3.0, x.shape), x.dtype)

    return jax.tree_util.tree_map_with_path(leaf, batch_stats)


@pytest.fixture(scope="module")
def nets():
    """(JAX model, its variables, JAX inference fns, port model, port fns)."""
    jmodel, state = init_state(JConfig(**MODEL), jax.random.PRNGKey(0))
    variables = {"params": state.params, "batch_stats": _bn_stats(state.batch_stats)}
    model = build_model(Config(**MODEL), "cpu")
    load_jax_variables(model, variables["params"], variables["batch_stats"])
    return (jmodel, variables, jtasks.make_inference_fns(jmodel, variables), model,
            ttasks.make_inference_fns(model, "cpu"))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The synthetic KITTI / NYU trees and a YAML that names them all."""
    root = tmp_path_factory.mktemp("evaltrees")
    flow = kitti_flow_tree(str(root / "kflow"), 200)
    raw, files_txt, gt_npz = eigen_tree(str(root / "eigen"), B)
    odom = odom_tree(str(root / "odom"), B + 2)
    nyu = nyu_tree(str(root / "nyu"), B)
    yaml = root / "eval.yaml"
    yaml.write_text(
        f"img_hw: [{H}, {W}]\ngt_2012_dir: {flow}\ngt_2015_dir: {flow}\n"
        f"raw_base_dir: {raw}\neigen_test_files_txt: {files_txt}\n"
        f"eigen_gt_depths_npz: {gt_npz}\nkitti_odom_dir: {odom}\nnyu_test_dir: {nyu}\n"
    )
    return {"flow": flow, "raw": raw, "files_txt": files_txt, "gt_npz": gt_npz,
            "odom": odom, "nyu": nyu, "yaml": str(yaml)}


def _cfgs(trees):
    kw = dict(img_hw=(H, W), gt_2015_dir=trees["flow"], gt_2012_dir=trees["flow"],
              raw_base_dir=trees["raw"], eigen_test_files_txt=trees["files_txt"],
              eigen_gt_depths_npz=trees["gt_npz"], kitti_odom_dir=trees["odom"],
              sequences=("09",))
    return JConfig(**kw), Config(**kw)


def _imgs(c=3, seed=0):
    return np.random.RandomState(seed).rand(B, H, W, c).astype(np.float32)


# ------------------------------------------------------- inference methods


def test_infer_disp_and_depth(nets):
    """Disparity to 2e-5 absolute (tests/test_torch_models.py); the bounded
    depth as its inverse 0.01 + 9.99 disp, to 9.99 x 2e-5."""
    jmodel, variables, (_, jdisp, _), model, _ = nets
    img = _imgs()
    x = torch.from_numpy(img)
    disp = model.infer_disp(x)
    assert disp.shape == (B, H, W, 1)
    np.testing.assert_allclose(disp.numpy(), np.asarray(jdisp(jnp.asarray(img))), atol=2e-5)
    want = jax.jit(lambda v, a: jmodel.apply(v, a, method=jmodel.infer_depth))(variables, img)
    depth = model.infer_depth(x).numpy()
    assert depth.min() >= 0.1 - 1e-6 and depth.max() <= 100.0 + 1e-4
    np.testing.assert_allclose(1.0 / depth, 1.0 / np.asarray(want), atol=9.99 * 2e-5)


def test_inference_flow(nets):
    """Full-resolution forward flow to 1e-4 px (tests/test_torch_models.py)."""
    _, _, (jflow, _, _), model, _ = nets
    a, b = _imgs(seed=1), _imgs(seed=2)
    got = model.inference_flow(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (B, H, W, 2)
    np.testing.assert_allclose(got, np.asarray(jflow(jnp.asarray(a), jnp.asarray(b))), atol=1e-4)


def test_infer_pose(nets):
    """[B, 2, 6] pose vectors to 1e-6 (tests/test_torch_models.py)."""
    _, _, (_, _, jpose), model, _ = nets
    imgs = _imgs(9, seed=3)
    got = model.infer_pose(torch.from_numpy(imgs)).numpy()
    assert got.shape == (B, 2, 6)
    np.testing.assert_allclose(got, np.asarray(jpose(jnp.asarray(imgs))), atol=1e-6)


def test_inference_runs_in_eval_mode_and_restores_the_mode(nets):
    """On a model in train mode the methods use the running statistics,
    leave them untouched, keep no graph, and leave the model in train mode."""
    model = copy.deepcopy(nets[3]).train()
    img = torch.from_numpy(_imgs(seed=4))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = model.infer_disp(img.requires_grad_())
    assert model.training and all(m.training for m in model.modules())
    assert not got.requires_grad
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    torch.testing.assert_close(got, model.eval().infer_disp(img), rtol=0, atol=0)
    with torch.no_grad():
        batch_stats = model.train().depth_net(img)[0]  # batch statistics
    assert (batch_stats - got).abs().max() > 1e-3


# ------------------------------------------------------------ eval tasks


def _limited(cls):
    """The real flow eval dataset over the first B pairs of a tree."""
    def make(d, mode, img_hw):
        ds = cls(d, mode=mode, img_hw=img_hw)
        ds.num_total = B
        return ds
    return make


def test_kitti_flow_task(nets, trees, tmp_path, monkeypatch):
    """test_kitti_flow with moving masks and submission PNGs, on the first
    four pairs of the tree: the EPEs (means of norms of flows that agree to
    1e-4 px) to 1e-4; each Fl rate to 1e-3, which allows a few pixels that
    sit at the 3 px / 5 % threshold to fall the other way."""
    _, _, (jflow, _, _), _, (tflow, _, _) = nets
    monkeypatch.setattr(jtasks, "KittiFlowEval", _limited(JFlowEval))
    monkeypatch.setattr(ttasks, "KittiFlowEval", _limited(TFlowEval))
    jcfg, tcfg = _cfgs(trees)
    pairs = [_read_flow_gt_worker(trees["flow"], i) for i in range(B)]
    gt, noc = [p[0] for p in pairs], [p[1] for p in pairs]
    moving = [(gt[i][..., 0] > 0).astype(np.float64) for i in range(B)]
    kw = dict(moving_masks=moving)
    want = jtasks.test_kitti_flow(jcfg, jflow, gt, noc, "kitti_2015",
                                  submission_dir=str(tmp_path / "j"), **kw)
    got = ttasks.test_kitti_flow(tcfg, tflow, gt, noc, "kitti_2015",
                                 submission_dir=str(tmp_path / "t"), **kw)
    assert list(got) == list(want) and len(got) == 8
    for k in got:
        tol = 1e-3 if k.startswith("fl") else 1e-4
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j")) and len(names) == B
    for n in names:  # 16-bit PNGs: 1/64 px steps
        a, b = read_flow_png(str(tmp_path / "t" / n)), read_flow_png(str(tmp_path / "j" / n))
        np.testing.assert_allclose(a, b, atol=1 / 64 + 1e-4)


def test_eigen_depth_task(nets, trees):
    """test_eigen_depth over four frames: the error means to 1e-4 relative
    (disparities that agree to 2e-5, scored after median scaling); the
    threshold accuracies to 1e-3 (a pixel at a threshold may flip)."""
    _, _, (_, jdisp, _), _, (_, tdisp, _) = nets
    jcfg, tcfg = _cfgs(trees)
    want = jtasks.test_eigen_depth(jcfg, jdisp)
    got = ttasks.test_eigen_depth(tcfg, tdisp)
    np.testing.assert_allclose(got[:4], want[:4], rtol=1e-4)
    np.testing.assert_allclose(got[4:], want[4:], atol=1e-3)


def test_pose_task_and_trajectory(nets, trees, tmp_path):
    """test_pose_odom (ATE, RE means and spreads) and export_trajectory over
    a 6-frame sequence (4 snippets): pose vectors that agree to 1e-6 of
    values near 1e-3 give ATE/RE to 1e-3 relative and trajectories to 1e-6
    m."""
    _, _, (_, _, jpose), _, (_, _, tpose) = nets
    jcfg, tcfg = _cfgs(trees)
    for g, w in zip(ttasks.test_pose_odom(tcfg, tpose), jtasks.test_pose_odom(jcfg, jpose)):
        assert np.all(np.isfinite(g))
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-9)
    jtasks.export_trajectory(jcfg, jpose, "09", str(tmp_path / "j.txt"))
    ttasks.export_trajectory(tcfg, tpose, "09", str(tmp_path / "t.txt"))
    got, want = np.loadtxt(tmp_path / "t.txt"), np.loadtxt(tmp_path / "j.txt")
    assert got.shape == (B + 2, 12)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_single_image_demo(nets, trees, tmp_path):
    """The demo's depth map at the source size, from one frame: to 1e-4
    relative (its inverse is affine in a disparity that agrees to 2e-5)."""
    _, _, (_, jdisp, _), _, (_, tdisp, _) = nets
    img = os.path.join(trees["flow"], "image_2", "000000_10.png")
    want = jtasks.test_single_image(img, jdisp, (H, W), str(tmp_path / "j"))
    got = ttasks.test_single_image(img, tdisp, (H, W), str(tmp_path / "t"))
    assert got.shape == (24, 48) and os.path.isfile(tmp_path / "t" / "demo.png")
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_nyu_depth_task(nets, trees):
    """load_nyu_test_data and test_nyu_depth (log10 metrics), as the eigen
    task: error means to 1e-4 relative, accuracies to 1e-3."""
    _, _, (_, jdisp, _), _, (_, tdisp, _) = nets
    imgs, depths = tnyu.load_nyu_test_data(trees["nyu"])
    jimgs, jdepths = jnyu.load_nyu_test_data(trees["nyu"])
    np.testing.assert_array_equal(imgs, jimgs)
    np.testing.assert_array_equal(depths, jdepths)
    jcfg, tcfg = _cfgs(trees)
    want = jnyu.test_nyu_depth(jcfg, jdisp, jimgs, jdepths)
    got = tnyu.test_nyu_depth(tcfg, tdisp, imgs, depths)
    np.testing.assert_allclose(got[:4], want[:4], rtol=1e-4)
    np.testing.assert_allclose(got[4:], want[4:], atol=1e-3)


# ------------------------------------------------------------- eval CLI


@pytest.fixture(scope="module")
def checkpoint(nets, tmp_path_factory):
    """A checkpoint of the port's training CLI holding the nets' weights and
    their non-trivial BatchNorm statistics."""
    model = nets[3]
    ckpt = str(tmp_path_factory.mktemp("run") / "ckpt")
    CheckpointManager(ckpt).save(7, model, make_optimizer(Config(**MODEL), model))
    return ckpt


TASK_ARGS = {
    "kitti_flow_2015": ["--write_submission"],
    "kitti_flow_2012": [],
    "kitti_depth": [],
    "kitti_pose": ["--export_trajectory"],
    "nyu_depth": [],
    "demo": [],
}


@pytest.mark.parametrize("task", list(TASK_ARGS))
def test_eval_cli(task, nets, trees, checkpoint, tmp_path, capsys):
    """``run`` of the port's eval CLI on the CPU for every task, from the
    checkpoint: the metrics it prints are those of the eval tasks on the
    nets' weights (the restore took the BatchNorm statistics), and its
    files are written."""
    args = ["-c", trees["yaml"], "--task", task, "--pretrained_model", checkpoint,
            "--result_dir", str(tmp_path), *TASK_ARGS[task]]
    if task == "demo":
        args += ["--image_path", os.path.join(trees["flow"], "image_2", "000001_10.png")]
    tcli.run(tcli.parse_args(args), device="cpu")
    out = capsys.readouterr().out
    assert f"restored checkpoint from {checkpoint}" in out
    _, tcfg = _cfgs(trees)
    _, disp_fn, pose_fn = nets[4]
    if task.startswith("kitti_flow"):
        mode = "kitti_2012" if task.endswith("2012") else "kitti_2015"
        assert f"[EVAL] [{mode}]" in out
        header, values = out.strip().splitlines()[-2:]
        assert header.split(", ")[0].strip() == "epe"
        assert len(values.split(",")) == (8 if mode == "kitti_2015" else 4)
        assert all(np.isfinite(float(v)) for v in values.split(","))
        if mode == "kitti_2015":
            assert len(os.listdir(tmp_path / "submission")) == 200
    elif task == "kitti_depth":
        res = ttasks.test_eigen_depth(tcfg, disp_fn)
        names = ["abs_rel", "sq_rel", "rms", "log_rms", "a1", "a2", "a3"]
        assert ", ".join(f"{n}={v:.4f}" for n, v in zip(names, res)) in out
    elif task == "kitti_pose":
        mean_err, _ = ttasks.test_pose_odom(tcfg, pose_fn)
        assert "mean \t {:10.4f}, {:10.4f}".format(*mean_err) in out
        assert np.loadtxt(tmp_path / "09_pred.txt").shape == (B + 2, 12)
        assert "Sequence: 09" in out
    elif task == "nyu_depth":
        assert out.strip().splitlines()[-1].startswith("abs_rel=")
        assert "log10=" in out
    else:
        assert os.path.isfile(tmp_path / "demo.png")
        assert f"Depth prediction saved in {tmp_path}" in out


def test_inference_fns_default_to_cuda(nets):
    """make_inference_fns runs on the card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttasks.make_inference_fns(copy.deepcopy(nets[3]))


def test_eval_cli_two_view(nets, trees, checkpoint, tmp_path, capsys, monkeypatch):
    """``--mode two_view`` runs on the CPU from the checkpoint: the flow task
    through ``TriangulationPoseModel`` on the joint model's flow and depth
    nets, here on the first four pairs; its flow is the joint model's, so
    it prints the metrics of the geom-mode flow task. (Held against the JAX
    package in tests/test_torch_two_view.py.)"""
    monkeypatch.setattr(ttasks, "KittiFlowEval", _limited(TFlowEval))
    tcli.run(tcli.parse_args(["-c", trees["yaml"], "--mode", "two_view", "--task",
                              "kitti_flow_2012", "--pretrained_model", checkpoint,
                              "--result_dir", str(tmp_path)]), device="cpu")
    out = capsys.readouterr().out
    assert f"restored checkpoint from {checkpoint}" in out and "[EVAL] [kitti_2012]" in out
    _, tcfg = _cfgs(trees)
    gt, noc = tload_gt_flow_kitti(trees["flow"], "kitti_2012")
    want = ttasks.test_kitti_flow(tcfg, nets[4][0], gt, noc, "kitti_2012")
    assert out.strip().endswith(tformat_flow_metrics(want).strip())


def test_eval_entry_point_raises_without_a_card(trees, tmp_path):
    """``python -m ...test`` runs on the card and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the entry point would evaluate")
    out = subprocess.run(
        [sys.executable, "-m", "unsupervised_depth_opticalflow_egomotion_torch.test",
         "-c", trees["yaml"], "--task", "kitti_depth", "--result_dir", str(tmp_path / "r")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert not (tmp_path / "r").exists()
