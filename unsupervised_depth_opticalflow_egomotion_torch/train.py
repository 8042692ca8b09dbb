"""Training CLI of the port: flow / depth / geom modes on one CUDA card.

    python -m unsupervised_depth_opticalflow_egomotion_torch.train \\
        -c configs/kitti_geom.yaml --mode geom --model_dir ckpt/

The flags and semantics of the repository's ``train.py`` (the JAX package's
CLI, train.py:49-332):

- the prepared dataset (``prepared_base_dir``), prepared from the raw
  download when it has no ``train.txt``; the threaded host input pipeline,
  the native decoder where it builds (``loader_impl``);
- ``--resume`` from the latest step (or ``--iter_start``), the optimizer
  layout checked before anything is loaded, the data stream restarted for
  the steps that are left;
- the staged init: ``flow_pretrained_model``, then
  ``depth_pretrained_model``, copy every parameter whose name and shape
  match the stage checkpoint, and no BatchNorm statistic;
- flow mode's occlusion schedule (``flow_occ_switch_step``);
- geom mode's mask dumps every ``10 * log_interval`` steps;
- the interleaved evaluation every ``test_interval`` steps (train.py:79-119):
  KITTI flow 2012 / 2015 where ``gt_2012_dir`` / ``gt_2015_dir`` are set,
  and in depth and geom modes the eigen depth (``raw_base_dir``) and the
  odometry pose (``kitti_odom_dir``) evals, recorded in ``log.pkl`` under
  ``eval/kitti_2012``, ``eval/kitti_2015``, ``eval/eigen_depth`` and
  ``eval/pose_odom``. It runs an f32 copy of the model (built once) that
  takes the model's parameters and BatchNorm statistics at each eval, so
  the model, its statistics and the optimizer are left as they were;
- step-indexed checkpoints in ``<model_dir>/ckpt``, ``log.pkl`` and
  ``config.json`` in ``--model_dir``.

It runs on the card and raises without one; ``train(cfg, device="cpu")``
runs the plain versions of the kernels on the CPU. Not ported yet, and
refused with ``NotImplementedError``: more than one device or process
(ROADMAP.md queue 1, item 7).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from . import eval_tasks
from .config import Config, load_config
from .data import KittiOdoPrep, KittiPreparedDataset, KittiRawPrep, NyuPrep, make_loader
from .evaluation import load_gt_flow_kitti, load_gt_mask
from .parallel import build_model, init_state, make_train_step, to_device_batch
from .parallel.train_step import step_draws
from .utils import CheckpointManager, MetricLogger, graft_params, opt_layout_tag, resolve_device
from .visualize import dump_mask_pack


def prepare_data(cfg: Config) -> str:
    data_dir = cfg.prepared_base_dir
    if os.path.exists(os.path.join(data_dir, "train.txt")):
        return data_dir
    if not cfg.raw_base_dir or not os.path.isdir(cfg.raw_base_dir):
        raise FileNotFoundError(
            f"no prepared dataset at {data_dir!r} (missing train.txt) and "
            f"raw_base_dir={cfg.raw_base_dir!r} does not exist -- set "
            "prepared_base_dir to an existing prepared dataset or "
            "raw_base_dir to the KITTI raw download to prepare one"
        )
    if cfg.dataset == "kitti_depth":
        KittiRawPrep(cfg.raw_base_dir, cfg.static_frames_txt, cfg.test_scenes_txt).prepare(
            data_dir, num_workers=cfg.num_workers
        )
    elif cfg.dataset == "kitti_odo":
        KittiOdoPrep(cfg.raw_base_dir).prepare(data_dir, num_workers=cfg.num_workers)
    elif cfg.dataset == "nyu":
        NyuPrep(cfg.raw_base_dir).prepare(
            data_dir, stride=cfg.nyu_stride, num_workers=cfg.num_workers
        )
    else:
        raise NotImplementedError(cfg.dataset)
    return data_dir


def refuse_unported(cfg: Config) -> None:
    """Raise for what the JAX CLI would do and the port cannot yet."""
    if cfg.num_devices > 1 or cfg.num_processes > 1 or cfg.coordinator_address:
        raise NotImplementedError(
            "data parallel training over more than one device or process is not "
            "ported yet (ROADMAP.md queue 1, item 7); the port trains on one card"
        )


def load_eval_context(cfg: Config) -> dict:
    """The KITTI flow GT of the interleaved evals, read once (train.py:186-195):
    flows and non-occluded masks of the benchmarks named, and 2015's moving
    masks. Empty when ``test_interval`` is 0: no eval runs."""
    ctx = {}
    if not cfg.test_interval:
        return ctx
    if cfg.gt_2012_dir:
        ctx["gt_flows_2012"], ctx["noc_masks_2012"] = load_gt_flow_kitti(
            cfg.gt_2012_dir, "kitti_2012"
        )
    if cfg.gt_2015_dir:
        ctx["gt_flows_2015"], ctx["noc_masks_2015"] = load_gt_flow_kitti(
            cfg.gt_2015_dir, "kitti_2015"
        )
        ctx["gt_masks_2015"] = load_gt_mask(cfg.gt_2015_dir)
    return ctx


def run_interleaved_eval(cfg: Config, infer_fns, logger, step: int, eval_ctx: dict) -> None:
    """The evals of train.py:79-119 through the eval model's inference
    closures; each is printed and recorded with ``logger.add_eval``."""
    flow_fn, disp_fn, pose_fn = infer_fns
    if eval_ctx.get("gt_flows_2012") is not None:
        m = eval_tasks.test_kitti_flow(
            cfg, flow_fn, eval_ctx["gt_flows_2012"], eval_ctx["noc_masks_2012"], "kitti_2012"
        )
        print(f"[EVAL {step}] KITTI2012: {m}")
        logger.add_eval(step, "kitti_2012", m)
    if eval_ctx.get("gt_flows_2015") is not None:
        m = eval_tasks.test_kitti_flow(
            cfg,
            flow_fn,
            eval_ctx["gt_flows_2015"],
            eval_ctx["noc_masks_2015"],
            "kitti_2015",
            moving_masks=eval_ctx.get("gt_masks_2015"),
        )
        print(f"[EVAL {step}] KITTI2015: {m}")
        logger.add_eval(step, "kitti_2015", m)
    if cfg.mode in ("depth", "geom") and cfg.raw_base_dir:
        try:
            m = eval_tasks.test_eigen_depth(cfg, disp_fn)
            print(f"[EVAL {step}] eigen depth (absrel sqrel rms logrms a1 a2 a3): {m}")
            logger.add_eval(step, "eigen_depth", m)
        except FileNotFoundError as e:
            print(f"[EVAL {step}] eigen depth skipped: {e}")
    # pose eval for odometry runs (the reference never evals pose mid-training;
    # without this an odometry-preset geom run has no in-training pose signal)
    if cfg.mode in ("depth", "geom") and cfg.kitti_odom_dir:
        try:
            mean_err, std_err = eval_tasks.test_pose_odom(cfg, pose_fn)
            print(
                f"[EVAL {step}] pose ATE={mean_err[0]:.4f}+-{std_err[0]:.4f} "
                f"RE={mean_err[1]:.4f}+-{std_err[1]:.4f}"
            )
            logger.add_eval(step, "pose_odom", (mean_err, std_err))
        except FileNotFoundError as e:
            print(f"[EVAL {step}] pose eval skipped: {e}")


def stage_init(model: torch.nn.Module, cfg: Config) -> None:
    """The staged flow -> depth -> geom init: graft the parameters of each
    stage checkpoint that is set, flow first (train.py:149-156)."""
    for stage_dir in (cfg.flow_pretrained_model, cfg.depth_pretrained_model):
        if stage_dir:
            graft_params(model, CheckpointManager(stage_dir).restore_params())
            print(f"grafted params from {stage_dir}")


def dump_masks(eval_model, model, batch, batch_np, out_dir: str, step: int, logger) -> None:
    """The geom forward's masks of the batch's first item, in f32, in eval
    mode and with no grad, by a copy of the model (``eval_model``, built in
    f32) that takes the model's parameters and BatchNorm statistics: the
    model, its statistics and the optimizer are left as they were."""
    eval_model.load_state_dict(model.state_dict())
    # a fixed draw: the masks do not read the sampled losses
    draws = step_draws(eval_model, 0, tuple(x[:1] for x in batch))
    with torch.no_grad():
        _, aux = eval_model.forward_geom(*(x[:1] for x in batch), with_masks=True, draws=draws)
    aux = {k: v.float().cpu().numpy() for k, v in aux.items()}
    h = batch_np[0].shape[1] // 3
    center = batch_np[0][0, h : 2 * h]
    if center.dtype == np.uint8:
        center = center.astype(np.float32) / 255.0
    dump_mask_pack(aux, center, out_dir, step, logger)


def train(cfg: Config, device=None):
    """Train ``cfg.mode`` to ``cfg.num_iterations`` steps; returns (model,
    optimizer, step)."""
    refuse_unported(cfg)
    dev = resolve_device(device)
    # the GT first: before the card's context and the loader's threads exist
    eval_ctx = load_eval_context(cfg)
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = True  # one input shape for the whole run
    print(f"devices: [{dev}]" + (f" {torch.cuda.get_device_name(dev)}" if dev.type == "cuda" else ""))

    model, optimizer = init_state(cfg, dev)
    ckpt = CheckpointManager(os.path.join(cfg.model_dir, "ckpt"))
    layout = opt_layout_tag(cfg.fix_flow, cfg.fix_depth, cfg.fix_pose)
    ckpt_meta = {"opt_layout": layout, "mode": cfg.mode, "img_hw": list(cfg.img_hw)}
    start_step = 0
    if cfg.resume:
        step = cfg.iter_start if cfg.iter_start > 0 else None
        start_step = ckpt.restore(model, optimizer, step, expect_opt_layout=layout)
        print(f"resumed from step {start_step}")
    else:
        stage_init(model, cfg)
    step_fn = make_train_step(model, cfg, optimizer)

    data_dir = prepare_data(cfg)
    dataset = KittiPreparedDataset(
        data_dir,
        num_scales=cfg.num_scales,
        img_hw=cfg.img_hw,
        num_iterations=(cfg.num_iterations - start_step) * cfg.batch_size,
        seed=cfg.seed,
        cache_decoded_bytes=cfg.decode_cache_bytes,
        uint8_images=True,
    )
    loader = make_loader(
        dataset,
        cfg.batch_size,
        impl=cfg.loader_impl,
        shuffle=True,
        num_workers=cfg.num_workers,
        seed=cfg.seed,
    )
    print(f"input pipeline: {type(loader).__name__}")

    logger = MetricLogger(cfg.model_dir)
    cfg.dump(os.path.join(cfg.model_dir, "config.json"))
    # one f32 copy of the model, built once, for the mask dumps and the
    # interleaved evals
    dumps = cfg.mode == "geom" and cfg.log_interval
    eval_model = infer_fns = None
    if dumps or cfg.test_interval:
        eval_model = build_model(cfg.replace(compute_dtype="float32"), dev).eval()
        infer_fns = eval_tasks.make_inference_fns(eval_model, dev)

    # flow-mode occlusion schedule: splat_nn for the bulk of training, the
    # 4-tap bilinear splat for the tail
    occ_switch = (
        cfg.flow_occ_switch_step
        if cfg.mode == "flow" and cfg.flow_occ_impl != "splat"
        else 0
    )

    step = start_step
    for batch_np in loader:
        if step >= cfg.num_iterations:
            break
        # >= (not ==): a resume landing past the boundary must still switch
        if occ_switch and step >= occ_switch:
            occ_switch = 0
            cfg_tail = cfg.replace(flow_occ_impl="splat")
            model.cfg = cfg_tail  # the forward reads its routes from model.cfg
            step_fn = make_train_step(model, cfg_tail, optimizer)
            print(f"[{step}] occlusion schedule: switching to flow_occ_impl=splat")
        if cfg.test_interval and step % cfg.test_interval == 0 and step > start_step:
            eval_model.load_state_dict(model.state_dict())
            run_interleaved_eval(cfg, infer_fns, logger, step, eval_ctx)

        batch = to_device_batch(batch_np, dev)
        metrics = step_fn(batch, step)
        step += 1

        if step % cfg.log_interval == 0:
            # the only host copy of the metrics: a sync at log steps alone
            scalars = {k: float(v) for k, v in metrics.items()}
            logger.add_scalars(step, scalars)
            logger.print_losses(step, cfg.num_iterations, scalars)
        if dumps and step % (10 * cfg.log_interval) == 0:
            dump_masks(eval_model, model, batch, batch_np,
                       os.path.join(cfg.model_dir, "images"), step, logger)
        if cfg.save_interval and step % cfg.save_interval == 0:
            ckpt.save(step, model, optimizer, meta=ckpt_meta)
            logger.dump()

    ckpt.save(step, model, optimizer, meta=ckpt_meta)
    logger.close()
    print("training done")
    return model, optimizer, step


def main(argv=None):
    parser = argparse.ArgumentParser(description="PyTorch/CUDA TrianFlow-style training")
    parser.add_argument("-c", "--config_file", default=None)
    parser.add_argument("--mode", default=None, choices=["flow", "depth", "geom"])
    parser.add_argument("--model_dir", default=None)
    parser.add_argument("--prepared_base_dir", default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--num_iterations", type=int, default=None)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--resume", action="store_true", default=None)
    parser.add_argument("--iter_start", type=int, default=None)
    parser.add_argument("--flow_pretrained_model", default=None)
    parser.add_argument("--depth_pretrained_model", default=None)
    parser.add_argument("--fix_flow", action="store_true", default=None)
    parser.add_argument("--fix_depth", action="store_true", default=None)
    parser.add_argument("--fix_pose", action="store_true", default=None)
    parser.add_argument("--num_devices", type=int, default=None)
    parser.add_argument("--compute_dtype", default=None)
    parser.add_argument("--flow_occ_impl", default=None,
                        choices=["splat", "splat_nn", "splat_nn_half", "diff_weights"])
    parser.add_argument("--flow_occ_switch_step", type=int, default=None,
                        help="flow mode: switch flow_occ_impl -> splat at this "
                             "step (occlusion schedule; 0 = never)")
    parser.add_argument("--loss_base_scale", type=int, default=None,
                        help="half-resolution loss dial: the loss pyramid this "
                             "many octaves below the input")
    parser.add_argument("--coordinator_address", default=None)
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    args = parser.parse_args(argv)

    overrides = {k: v for k, v in vars(args).items() if k != "config_file"}
    cfg = load_config(args.config_file, **overrides)
    os.makedirs(cfg.model_dir, exist_ok=True)
    train(cfg)


if __name__ == "__main__":
    main()
