"""Evaluation CLI of the port: the tasks and flags of the repository's
``test.py`` (the JAX package's eval CLI, test.py:27-136), on one CUDA card.

    python -m unsupervised_depth_opticalflow_egomotion_torch.test \\
        -c configs/kitti_geom.yaml --task kitti_depth \\
        --pretrained_model <model_dir>/ckpt --result_dir results/

Tasks: kitti_depth | kitti_flow_2012 | kitti_flow_2015 | kitti_pose |
nyu_depth | demo. The model is built in f32 (``compute_dtype="float32"``)
and runs its inference without TF32; ``--pretrained_model`` names a
checkpoint directory of the port's training CLI, whose latest step file
gives the parameters and the BatchNorm running statistics (no optimizer is
read). It runs on the card and raises without one; ``run(args,
device="cpu")`` runs the plain versions of the kernels on the CPU.

``--mode two_view`` loads the checkpoint as a geom model and scores the
flow tasks with the legacy two-view pipeline (``TriangulationPoseModel``:
flow -> RANSAC-F -> pose, on the joint model's flow and depth nets, its
``ransac_iters`` and ``ransac_points``); the other tasks use the joint
model, as the repository's ``test.py`` does.
"""

from __future__ import annotations

import argparse
import os

from . import eval_tasks
from .config import load_config
from .data import nyu
from .evaluation import KittiEvalOdom, format_flow_metrics, load_gt_flow_kitti, load_gt_mask
from .models import TriangulationPoseModel
from .parallel import build_model
from .utils import CheckpointManager, resolve_device

TASKS = ("kitti_depth", "kitti_flow_2012", "kitti_flow_2015", "kitti_pose", "nyu_depth", "demo")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="PyTorch/CUDA TrianFlow-style testing")
    parser.add_argument("-c", "--config_file", default=None)
    parser.add_argument(
        "--mode", default="geom", choices=["flow", "depth", "geom", "two_view"],
        help="two_view = legacy TrianFlow pipeline: flow -> RANSAC-F -> pose "
        "(reference test.py:33,64 non-geom branch)",
    )
    parser.add_argument("--task", default="kitti_depth", choices=TASKS)
    parser.add_argument("--image_path", default=None, help="for --task demo")
    parser.add_argument("--pretrained_model", default=None, help="checkpoint dir")
    parser.add_argument("--result_dir", default="./results")
    parser.add_argument("--write_submission", action="store_true")
    parser.add_argument("--export_trajectory", action="store_true")
    return parser.parse_args(argv)


def two_view_model(model, cfg) -> TriangulationPoseModel:
    """``TriangulationPoseModel`` on the joint model's flow and depth nets:
    its parameters and BatchNorm buffers, loaded strictly. The depth net's
    extra coarse heads of ``loss_base_scale`` are left out (the two-view
    model reads the ``num_scales`` heads only)."""
    tv = TriangulationPoseModel(cfg.num_scales, cfg.ransac_iters, cfg.ransac_points)
    extra = tuple(f"depth_net.decoder.dispconvs.{s}."
                  for s in range(cfg.num_scales, cfg.num_scales + cfg.loss_base_scale))
    sd = {k: v for k, v in model.state_dict().items()
          if k.startswith(("fpyramid.", "pwc_model.", "depth_net.")) and not k.startswith(extra)}
    tv.load_state_dict(sd, strict=True)
    return tv


def run(args: argparse.Namespace, device=None) -> None:
    """Evaluate ``args.task``; prints its metrics as the JAX CLI does."""
    dev = resolve_device(device)
    cfg = load_config(
        args.config_file, mode="geom" if args.mode == "two_view" else args.mode,
        model_dir=args.result_dir,
        compute_dtype="float32",  # eval in full precision
    )
    os.makedirs(args.result_dir, exist_ok=True)

    model = build_model(cfg, dev)
    if args.pretrained_model:
        model.load_state_dict(CheckpointManager(args.pretrained_model).restore_params())
        print(f"restored checkpoint from {args.pretrained_model}")
    flow_fn, disp_fn, pose_fn = eval_tasks.make_inference_fns(model, dev)
    two_view_fn = None
    if args.mode == "two_view":
        two_view_fn = eval_tasks.make_two_view_inference_fn(two_view_model(model, cfg), dev)

    if args.task == "kitti_depth":
        res = eval_tasks.test_eigen_depth(cfg, disp_fn)
        names = ["abs_rel", "sq_rel", "rms", "log_rms", "a1", "a2", "a3"]
        print(", ".join(f"{n}={v:.4f}" for n, v in zip(names, res)))
    elif args.task in ("kitti_flow_2012", "kitti_flow_2015"):
        mode = "kitti_2012" if args.task == "kitti_flow_2012" else "kitti_2015"
        gt_dir = cfg.gt_2012_dir if mode == "kitti_2012" else cfg.gt_2015_dir
        gt_flows, noc_masks = load_gt_flow_kitti(gt_dir, mode)
        moving = load_gt_mask(gt_dir) if mode == "kitti_2015" else None
        sub_dir = os.path.join(args.result_dir, "submission") if args.write_submission else None
        m = eval_tasks.test_kitti_flow(
            cfg, flow_fn, gt_flows, noc_masks, mode, moving_masks=moving,
            submission_dir=sub_dir, two_view_fn=two_view_fn,
        )
        print(f"[EVAL] [{mode}]")
        print(format_flow_metrics(m))
    elif args.task == "nyu_depth":
        if not cfg.nyu_test_dir:
            raise SystemExit(
                "--task nyu_depth needs cfg.nyu_test_dir pointing at a dir with "
                "nyu_depth_v2_labeled.mat + splits.mat"
            )
        test_images, test_depths = nyu.load_nyu_test_data(cfg.nyu_test_dir)
        res = nyu.test_nyu_depth(cfg, disp_fn, test_images, test_depths)
        names = ["abs_rel", "sq_rel", "rms", "log10", "a1", "a2", "a3"]
        print(", ".join(f"{n}={v:.4f}" for n, v in zip(names, res)))
    elif args.task == "kitti_pose":
        mean_err, std_err = eval_tasks.test_pose_odom(cfg, pose_fn)
        print("Results")
        print("\t {:>10}, {:>10}".format("ATE", "RE"))
        print("mean \t {:10.4f}, {:10.4f}".format(*mean_err))
        print("std \t {:10.4f}, {:10.4f}".format(*std_err))
        if args.export_trajectory:
            for seq in cfg.sequences:
                out_txt = os.path.join(args.result_dir, f"{seq}_pred.txt")
                eval_tasks.export_trajectory(cfg, pose_fn, seq, out_txt)
                gt_txt = os.path.join(cfg.kitti_odom_dir, "poses", f"{seq}.txt")
                if os.path.isfile(gt_txt):
                    KittiEvalOdom().eval(gt_txt, out_txt, seq=seq)
    elif args.task == "demo":
        if not args.image_path:
            raise SystemExit("--image_path required for demo")
        eval_tasks.test_single_image(args.image_path, disp_fn, cfg.img_hw, args.result_dir)
        print(f"Depth prediction saved in {args.result_dir}")


def main(argv=None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
