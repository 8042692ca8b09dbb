"""The port's training CLI on the CPU at 64x128, b2, f32, on a synthetic
prepared dataset: a geom run with saves, a resume and mask dumps; the flow
mode's occlusion schedule; the flow -> depth -> geom hand-off; the
interleaved evaluation on synthetic KITTI trees; and the data-parallel
settings that one process cannot run, which raise."""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_eval_trees import eigen_tree, kitti_flow_tree, odom_tree
from unsupervised_depth_opticalflow_egomotion_torch import train as cli
from unsupervised_depth_opticalflow_egomotion_torch.config import Config
from unsupervised_depth_opticalflow_egomotion_torch.data import KittiPreparedDataset, make_loader
from unsupervised_depth_opticalflow_egomotion_torch.parallel import (
    build_model,
    init_state,
    make_train_step,
    to_device_batch,
)
from unsupervised_depth_opticalflow_egomotion_torch.utils import CheckpointManager

pytestmark = pytest.mark.quick
torch.set_num_threads(2)
cv2 = pytest.importorskip("cv2")

H, W = 64, 128
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """The verify recipe's dataset: 8 stacked 3x64x128 PNGs, calib, train.txt."""
    root = tmp_path_factory.mktemp("prepared")
    (root / "d").mkdir()
    rng = np.random.RandomState(0)
    (root / "calib.txt").write_text(
        "P_rect_02: 100.0 0.0 64.0 0.0 0.0 100.0 32.0 0.0 0.0 0.0 1.0 0.0\n"
    )
    lines = []
    for i in range(8):
        cv2.imwrite(str(root / "d" / f"{i:06d}.png"), rng.randint(0, 255, (3 * H, W, 3), np.uint8))
        lines.append(f"d/{i:06d}.png calib.txt\n")
    (root / "train.txt").write_text("".join(lines))
    return str(root)


def _cfg(prepared, model_dir, **kw):
    base = dict(img_hw=(H, W), batch_size=2, num_iterations=3, num_workers=2,
                log_interval=1, test_interval=0, save_interval=2,
                compute_dtype="float32", prepared_base_dir=prepared,
                model_dir=str(model_dir))
    base.update(kw)
    return Config(**base)


def _adam_steps(opt) -> set:
    return {int(s["step"]) for s in opt.state_dict()["state"].values()}


def test_geom_run_saves_resumes_and_dumps(prepared, tmp_path, capsys):
    """3 steps with a save at 2, then a resume to 10: the checkpoints (at
    most 5 kept), log.pkl, config.json and the mask dump of step 10
    (10 x log_interval); the first step's metrics are those of
    make_train_step on the loader's first batch."""
    cfg = _cfg(prepared, tmp_path)
    model, opt, step = cli.train(cfg, device="cpu")
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    assert step == 3 and ckpt.steps() == [2, 3] and _adam_steps(opt) == {3}
    with open(tmp_path / "config.json") as f:
        assert json.load(f) == json.loads(json.dumps(cfg.to_dict(), default=list))
    with open(tmp_path / "log.pkl", "rb") as f:
        log = pickle.load(f)
    assert [s for s, _ in log["loss_total"]] == [1, 2, 3]
    assert ckpt.load_meta()["opt_layout"] == "adam:all"
    assert "input pipeline: NativeBatchLoader" in capsys.readouterr().out

    ref_model, ref_opt = init_state(cfg, "cpu")
    dataset = KittiPreparedDataset(prepared, num_scales=3, img_hw=(H, W), num_iterations=6,
                                   seed=0, cache_decoded_bytes=cfg.decode_cache_bytes,
                                   uint8_images=True)
    first = next(iter(make_loader(dataset, 2, impl="auto", shuffle=True, num_workers=2, seed=0)))
    metrics = make_train_step(ref_model, cfg, ref_opt)(to_device_batch(first, "cpu"))
    assert {k: log[k][0] for k in metrics} == {k: (1, float(v)) for k, v in metrics.items()}

    model, opt, step = cli.train(cfg.replace(resume=True, num_iterations=10), device="cpu")
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "[10/10]" in out and "training done" in out
    assert step == 10 and ckpt.steps() == [3, 4, 6, 8, 10] and _adam_steps(opt) == {10}
    assert model.training
    dump = tmp_path / "images" / "step_00000010"
    assert sorted(p.name for p in dump.iterdir()) == sorted(
        f"{n}.png" for n in ("occ_fwd_mask", "rigid_fwd_mask", "inlier_fwd_mask",
                             "dyna_fwd_mask", "valid_fwd_mask", "fwd_mask",
                             "texture_mask_fwd", "pred_disp", "pred_flow_fwd", "center_image"))
    assert not (tmp_path / "images" / "step_00000003").exists()


def test_mask_dump_leaves_model_statistics_and_optimizer(prepared, tmp_path):
    """The dump runs a copy in eval mode: the model stays in train mode, its
    parameters and BatchNorm statistics and the optimizer are untouched."""
    cfg = _cfg(prepared, tmp_path, compute_dtype="bfloat16")
    model, opt = init_state(cfg, "cpu")
    dataset = KittiPreparedDataset(prepared, img_hw=(H, W), num_iterations=2, uint8_images=True)
    batch_np = next(iter(make_loader(dataset, 2, impl="python", num_workers=1)))
    batch = to_device_batch(batch_np, "cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    eval_model = build_model(cfg.replace(compute_dtype="float32"), "cpu").eval()
    cli.dump_masks(eval_model, model, batch, batch_np, str(tmp_path / "images"), 20, None)
    assert model.training and not eval_model.training and not opt.state
    after = model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert len(list((tmp_path / "images" / "step_00000020").iterdir())) == 10


def test_flow_occlusion_schedule_switches(prepared, tmp_path, capsys):
    """splat_nn for step 1, then the bilinear splat from step 1 on (>=), on
    the same parameters and optimizer; a resume past the boundary switches
    at its first step."""
    cfg = _cfg(prepared, tmp_path, mode="flow", num_iterations=2, flow_occ_switch_step=1)
    model, opt, _ = cli.train(cfg, device="cpu")
    out = capsys.readouterr().out
    assert out.count("occlusion schedule") == 1
    assert "[1] occlusion schedule: switching to flow_occ_impl=splat" in out
    assert model.cfg.flow_occ_impl == "splat" and _adam_steps(opt) == {2}
    model, opt, _ = cli.train(cfg.replace(resume=True, num_iterations=3), device="cpu")
    assert "[2] occlusion schedule: switching to flow_occ_impl=splat" in capsys.readouterr().out
    assert _adam_steps(opt) == {3}
    cli.train(cfg.replace(model_dir=str(tmp_path / "nn"), flow_occ_switch_step=0,
                          num_iterations=1), device="cpu")
    assert "occlusion schedule" not in capsys.readouterr().out


def test_flow_depth_geom_handoff(prepared, tmp_path, capsys):
    """Flow, then depth from the flow stage, then geom from both (no step:
    its step-0 save is the grafted state). Geom takes every parameter of the
    depth stage (whose flow networks are the flow stage's) and none of its
    BatchNorm statistics, and a fresh optimizer."""
    flow_dir, depth_dir, geom_dir = (tmp_path / n for n in ("flow", "depth", "geom"))
    cli.train(_cfg(prepared, flow_dir, mode="flow", num_iterations=1), device="cpu")
    cli.train(_cfg(prepared, depth_dir, mode="depth", num_iterations=1,
                   flow_pretrained_model=str(flow_dir / "ckpt")), device="cpu")
    geom_cfg = _cfg(prepared, geom_dir, num_iterations=0,
                    flow_pretrained_model=str(flow_dir / "ckpt"),
                    depth_pretrained_model=str(depth_dir / "ckpt"))
    cli.train(geom_cfg, device="cpu")
    out = capsys.readouterr().out
    assert f"grafted params from {flow_dir / 'ckpt'}" in out
    assert f"grafted params from {depth_dir / 'ckpt'}" in out

    flow = CheckpointManager(str(flow_dir / "ckpt")).load()
    depth = CheckpointManager(str(depth_dir / "ckpt")).load()
    geom = CheckpointManager(str(geom_dir / "ckpt")).load()
    assert geom["step"] == 0 and not geom["optimizer"]["state"]
    fresh = build_model(geom_cfg, "cpu")
    params = {k for k, _ in fresh.named_parameters()}
    buffers = {k for k, _ in fresh.named_buffers()}
    fresh = fresh.state_dict()
    for k in params:
        assert torch.equal(geom["model"][k], depth["model"][k]), k
        if k.startswith(("fpyramid.", "pwc_model.")):
            assert torch.equal(depth["model"][k], flow["model"][k]), k
    assert not torch.equal(flow["model"]["pwc_model.predict_flow2.weight"],
                           fresh["pwc_model.predict_flow2.weight"])
    moved = [k for k in buffers if not torch.equal(depth["model"][k], fresh[k])]
    assert moved
    for k in buffers:
        assert torch.equal(geom["model"][k], fresh[k]), k


@pytest.fixture(scope="module")
def eval_trees(tmp_path_factory):
    """Config overrides naming synthetic KITTI eval trees: 200 flow pairs
    (2015; 2012 reads the first 194), four eigen frames, a 6-frame sequence."""
    root = tmp_path_factory.mktemp("evaltrees")
    flow = kitti_flow_tree(str(root / "kflow"), 200)
    raw, files_txt, gt_npz = eigen_tree(str(root / "eigen"), 4)
    return {"gt_2012_dir": flow, "gt_2015_dir": flow, "raw_base_dir": raw,
            "eigen_test_files_txt": files_txt, "eigen_gt_depths_npz": gt_npz,
            "kitti_odom_dir": odom_tree(str(root / "odom"), 6)}


@pytest.fixture(scope="module")
def undisturbed(prepared, tmp_path_factory):
    """mode -> (log.pkl, final state_dict) of a 2-step run without evals."""
    runs = {}

    def get(mode):
        if mode not in runs:
            out = tmp_path_factory.mktemp(f"plain_{mode}")
            model, _, _ = cli.train(_cfg(prepared, out, mode=mode, num_iterations=2),
                                    device="cpu")
            with open(out / "log.pkl", "rb") as f:
                runs[mode] = (pickle.load(f), model.state_dict())
        return runs[mode]

    return get


EVAL_CASES = {  # id: (the eval data named, mode, the record in log.pkl)
    "test_interval-gt_2012_dir": (("gt_2012_dir",), "geom", "kitti_2012"),
    "test_interval-gt_2015_dir": (("gt_2015_dir",), "geom", "kitti_2015"),
    "test_interval-raw_base_dir": (
        ("raw_base_dir", "eigen_test_files_txt", "eigen_gt_depths_npz"), "geom", "eigen_depth"),
    "test_interval-mode-kitti_odom_dir": (("kitti_odom_dir",), "depth", "pose_odom"),
}


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_interleaved_eval(prepared, eval_trees, undisturbed, tmp_path, case, capsys):
    """Two steps with test_interval 1 and one eval data set named: the eval
    runs once, before step 2, and log.pkl holds its record under the JAX
    CLI's name; the losses and the final parameters, BatchNorm statistics
    included, equal those of the same run without evals."""
    names, mode, record = EVAL_CASES[case]
    kw = {k: eval_trees[k] for k in names}
    model, _, step = cli.train(_cfg(prepared, tmp_path, mode=mode, num_iterations=2,
                                    test_interval=1, **kw), device="cpu")
    assert step == 2
    with open(tmp_path / "log.pkl", "rb") as f:
        log = pickle.load(f)
    evals = {k: v for k, v in log.items() if k.startswith("eval/")}
    assert list(evals) == [f"eval/{record}"] and [s for s, _ in evals[f"eval/{record}"]] == [1]
    values = evals[f"eval/{record}"][0][1]
    if record.startswith("kitti"):
        assert len(values) == (8 if record == "kitti_2015" else 4)
        assert all(np.isfinite(v) for v in values.values())
    elif record == "eigen_depth":
        assert len(values) == 7 and np.all(np.isfinite(values))
    else:
        assert [len(v) for v in values] == [2, 2] and np.all(np.isfinite(values))
    assert capsys.readouterr().out.count("[EVAL 1]") == 1
    plain_log, plain_sd = undisturbed(mode)
    assert {k: v for k, v in log.items() if not k.startswith("eval/")} == plain_log
    assert all(torch.equal(v, plain_sd[k]) for k, v in model.state_dict().items())


def test_flow_mode_runs_no_depth_or_pose_eval(prepared, eval_trees, tmp_path, capsys):
    """Flow mode evaluates flow alone: with the eigen and odometry data named
    and test_interval 1, no eval runs and none is recorded."""
    kw = {k: eval_trees[k] for k in ("raw_base_dir", "eigen_test_files_txt",
                                     "eigen_gt_depths_npz", "kitti_odom_dir")}
    cli.train(_cfg(prepared, tmp_path, mode="flow", num_iterations=2, test_interval=1, **kw),
              device="cpu")
    with open(tmp_path / "log.pkl", "rb") as f:
        assert not [k for k in pickle.load(f) if k.startswith("eval/")]
    assert "[EVAL" not in capsys.readouterr().out


@pytest.mark.parametrize("overrides", [
    {"num_devices": 2},
    {"num_processes": 2},
    {"coordinator_address": "localhost:1234"},
    {"loss_base_scale": 1},
    {"enable_pnp": True},
], ids=lambda o: "-".join(o))
def test_unported_paths_raise(prepared, tmp_path, overrides):
    """The paths that raised NotImplementedError while data parallel and
    the loss options were not ported (the name is kept). In one process,
    ``num_devices`` 2 names a group of two ranks that does not exist, and
    ``num_processes`` 2 without a coordinator and a process id cannot join
    one: both raise ValueError before a step. A coordinator address alone
    is ignored, as in the JAX package (it takes ``num_processes`` > 1), and
    the loss base scale and the PnP loss train: two steps of the CLI save
    finite losses with the option's loss non-zero."""
    cfg = _cfg(prepared, tmp_path, num_iterations=2, **overrides)
    if "num_devices" in overrides or "num_processes" in overrides:
        match = "torchrun" if "num_devices" in overrides else "coordinator_address"
        with pytest.raises(ValueError, match=match):
            cli.train(cfg, device="cpu")
        assert not (tmp_path / "ckpt").exists()
        return
    _, _, step = cli.train(cfg, device="cpu")
    assert step == 2 and CheckpointManager(str(tmp_path / "ckpt")).steps() == [2]
    with open(tmp_path / "log.pkl", "rb") as f:
        log = pickle.load(f)
    loss = "loss_pnp" if "enable_pnp" in overrides else "loss_total"
    values = [v for _, v in log[loss]]
    assert len(values) == 2 and all(np.isfinite(values)) and values[0] != 0


def test_module_entry_point_raises_without_a_card(prepared, tmp_path):
    """``python -m ...train`` runs on the card and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the entry point would train")
    yaml = tmp_path / "tiny.yaml"
    yaml.write_text(f"mode: geom\nimg_hw: [{H}, {W}]\nbatch_size: 2\ntest_interval: 0\n"
                    f"prepared_base_dir: {prepared}\n")
    out = subprocess.run(
        [sys.executable, "-m", "unsupervised_depth_opticalflow_egomotion_torch.train",
         "-c", str(yaml), "--model_dir", str(tmp_path / "out"), "--num_iterations", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert not (tmp_path / "out" / "ckpt").exists()
