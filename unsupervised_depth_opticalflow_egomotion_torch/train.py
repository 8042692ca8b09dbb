"""Training CLI of the port: flow / depth / geom modes on CUDA cards.

    python -m unsupervised_depth_opticalflow_egomotion_torch.train \\
        -c configs/kitti_geom.yaml --mode geom --model_dir ckpt/
    torchrun --nproc_per_node <cards> -m unsupervised_depth_opticalflow_egomotion_torch.train \\
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
- flow mode's network (``--flow_net``: the PWC pyramid and decoder, or
  RAFT with ``--num_scales 1``; the port's own flags);
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

Data parallel (train.py:126-136 of the JAX CLI): one process per card,
each a rank of a ``torch.distributed`` group (``parallel/mesh.py``), joined
under torchrun or through the JAX flags ``coordinator_address`` /
``num_processes`` / ``process_id``. ``num_devices`` 0 means every rank of
the group; N > 0 must equal the group's size. ``batch_size`` is global and
must divide by the number of ranks; each rank reads its stride of
``train.txt`` at ``batch_size // world`` items a step. Rank 0 alone prints,
logs, writes ``config.json``, the checkpoints and the mask dumps, and runs
the interleaved eval; the other ranks wait at a barrier meanwhile. Every
rank restores the same checkpoint on ``--resume``, and the run checks that
all ranks start from equal parameters and buffers. Started without torchrun
on a host with more than one card, and with ``num_devices`` 0, it raises
rather than train on one card.

It runs on the card and raises without one; ``train(cfg, device="cpu")``
runs the plain versions of the kernels on the CPU (under a gloo group made
by the caller, one rank of a CPU data-parallel run).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from . import eval_tasks
from .config import Config, load_config
from .data import KittiOdoPrep, KittiPreparedDataset, KittiRawPrep, NyuPrep, make_loader
from .evaluation import load_gt_flow_kitti, load_gt_mask
from .parallel import build_model, distributed_init, init_state, make_train_step, to_device_batch
from .parallel.mesh import check_replicas, rank_and_world, under_torchrun, world_group
from .parallel.train_step import step_draws
from .utils import CheckpointManager, MetricLogger, graft_params, opt_layout_tag
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


def refuse_one_of_many_cards(cfg: Config, device) -> None:
    """``num_devices`` 0 means every card, as in the JAX CLI: started as one
    process (no torchrun, no group, ``num_processes`` <= 1) on a host with
    more than one card, raise rather than train on one of them."""
    if (cfg.num_devices or cfg.num_processes > 1 or under_torchrun() or dist.is_initialized()
            or torch.device("cuda" if device is None else device).type != "cuda"):
        return
    cards = torch.cuda.device_count()
    if cards > 1:
        raise RuntimeError(
            f"num_devices=0 trains on every card, and this host has {cards}: launch one "
            f"process per card with `torchrun --nproc_per_node {cards} -m "
            "unsupervised_depth_opticalflow_egomotion_torch.train ...`, or pass "
            "`--num_devices 1` to train on one card"
        )


def check_world(cfg: Config, world: int) -> int:
    """The per-rank batch; raises unless ``num_devices`` (0: all) matches the
    group and the global batch divides by it."""
    if cfg.num_devices and cfg.num_devices != world:
        raise ValueError(
            f"num_devices={cfg.num_devices} but the process group has {world} rank(s), one "
            f"card each: launch with `torchrun --nproc_per_node {cfg.num_devices}`, or pass "
            f"`--num_devices {world}` (0 = every rank)"
        )
    if cfg.batch_size % world:
        raise ValueError(f"global batch {cfg.batch_size} must divide by the {world} ranks")
    return cfg.batch_size // world


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


def stage_init(model: torch.nn.Module, cfg: Config, say=print) -> None:
    """The staged flow -> depth -> geom init: graft the parameters of each
    stage checkpoint that is set, flow first (train.py:149-156)."""
    for stage_dir in (cfg.flow_pretrained_model, cfg.depth_pretrained_model):
        if stage_dir:
            graft_params(model, CheckpointManager(stage_dir).restore_params())
            say(f"grafted params from {stage_dir}")


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
    optimizer, step). Joins the process group first (a no-op for one
    process, or when the caller made the group)."""
    refuse_one_of_many_cards(cfg, device)
    dev = distributed_init(cfg.coordinator_address, cfg.num_processes, cfg.process_id, device)
    group = world_group()
    rank, world = rank_and_world(group)
    local_bsz = check_world(cfg, world)
    is_main = rank == 0
    say = print if is_main else (lambda *a, **k: None)

    def barrier():
        if group is not None:
            dist.barrier(group)

    # the GT first: before the loader's threads (and, in one process, the
    # card's context) exist
    eval_ctx = load_eval_context(cfg) if is_main else {}
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = True  # one input shape for the whole run
    name = f" {torch.cuda.get_device_name(dev)}" if dev.type == "cuda" else ""
    ranks = f" x {world} ranks ({dist.get_backend(group)})" if group is not None else ""
    say(f"devices: [{dev}]{name}{ranks}")

    model, optimizer = init_state(cfg, dev)
    ckpt = CheckpointManager(os.path.join(cfg.model_dir, "ckpt"))
    layout = opt_layout_tag(cfg.fix_flow, cfg.fix_depth, cfg.fix_pose)
    ckpt_meta = {"opt_layout": layout, "mode": cfg.mode, "img_hw": list(cfg.img_hw)}
    start_step = 0
    if cfg.resume:
        step = cfg.iter_start if cfg.iter_start > 0 else None
        start_step = ckpt.restore(model, optimizer, step, expect_opt_layout=layout)
        say(f"resumed from step {start_step}")
    else:
        stage_init(model, cfg, say)
    if group is not None:
        check_replicas(model, group)
    step_fn = make_train_step(model, cfg, optimizer, group)

    if is_main:
        prepare_data(cfg)
    barrier()
    dataset = KittiPreparedDataset(
        cfg.prepared_base_dir,
        num_scales=cfg.num_scales,
        img_hw=cfg.img_hw,
        num_iterations=(cfg.num_iterations - start_step) * local_bsz,
        seed=cfg.seed,
        cache_decoded_bytes=cfg.decode_cache_bytes,
        uint8_images=True,
        shard_id=rank,
        num_shards=world,
    )
    loader = make_loader(
        dataset,
        local_bsz,
        impl=cfg.loader_impl,
        shuffle=True,
        num_workers=cfg.num_workers,
        seed=cfg.seed,
    )
    say(f"input pipeline: {type(loader).__name__}")

    logger = eval_model = infer_fns = None
    dumps = cfg.mode == "geom" and cfg.log_interval
    if is_main:
        logger = MetricLogger(cfg.model_dir)
        cfg.dump(os.path.join(cfg.model_dir, "config.json"))
        # one f32 copy of the model, built once, for the mask dumps and the
        # interleaved evals
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
            step_fn = make_train_step(model, cfg_tail, optimizer, group)
            say(f"[{step}] occlusion schedule: switching to flow_occ_impl=splat")
        if cfg.test_interval and step % cfg.test_interval == 0 and step > start_step:
            if is_main:
                eval_model.load_state_dict(model.state_dict())
                run_interleaved_eval(cfg, infer_fns, logger, step, eval_ctx)
            barrier()

        batch = to_device_batch(batch_np, dev)
        metrics = step_fn(batch, step)
        step += 1

        if step % cfg.log_interval == 0 and is_main:
            # the only host copy of the metrics: a sync at log steps alone
            scalars = {k: float(v) for k, v in metrics.items()}
            logger.add_scalars(step, scalars)
            logger.print_losses(step, cfg.num_iterations, scalars)
        if dumps and step % (10 * cfg.log_interval) == 0 and is_main:
            dump_masks(eval_model, model, batch, batch_np,
                       os.path.join(cfg.model_dir, "images"), step, logger)
        if cfg.save_interval and step % cfg.save_interval == 0:
            if is_main:
                ckpt.save(step, model, optimizer, meta=ckpt_meta)
                logger.dump()
            barrier()

    if is_main:
        ckpt.save(step, model, optimizer, meta=ckpt_meta)
        logger.close()
    barrier()
    say("training done")
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
    parser.add_argument("--flow_net", default=None, choices=["pwc", "raft"],
                        help="flow mode's network: the PWC pyramid and decoder, or "
                             "RAFT (with --num_scales 1)")
    parser.add_argument("--num_scales", type=int, default=None)
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
    try:
        train(cfg)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
