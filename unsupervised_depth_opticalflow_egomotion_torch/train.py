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
- step-indexed checkpoints in ``<model_dir>/ckpt``, ``log.pkl`` and
  ``config.json`` in ``--model_dir``.

It runs on the card and raises without one; ``train(cfg, device="cpu")``
runs the plain versions of the kernels on the CPU. Not ported yet, and
refused with ``NotImplementedError``: the interleaved evaluation (ROADMAP.md
queue 1, item 3) and more than one device or process (item 7).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .config import Config, load_config
from .data import KittiOdoPrep, KittiPreparedDataset, KittiRawPrep, NyuPrep, make_loader
from .parallel import build_model, init_state, make_train_step, to_device_batch
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
    evals = [name for name in ("gt_2012_dir", "gt_2015_dir") if getattr(cfg, name)]
    if cfg.mode in ("depth", "geom"):  # train.py:86-97: depth and pose evals
        evals += [name for name in ("raw_base_dir", "kitti_odom_dir") if getattr(cfg, name)]
    if cfg.test_interval > 0 and evals:
        raise NotImplementedError(
            f"interleaved evaluation (test_interval={cfg.test_interval} with "
            f"{', '.join(evals)}) is not ported yet (ROADMAP.md queue 1, item 3); "
            "set test_interval: 0"
        )
    if cfg.num_devices > 1 or cfg.num_processes > 1 or cfg.coordinator_address:
        raise NotImplementedError(
            "data parallel training over more than one device or process is not "
            "ported yet (ROADMAP.md queue 1, item 7); the port trains on one card"
        )


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
    with torch.no_grad():
        _, aux = eval_model.forward_geom(*(x[:1] for x in batch), with_masks=True)
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
    eval_model = None
    if cfg.mode == "geom" and cfg.log_interval:
        eval_model = build_model(cfg.replace(compute_dtype="float32"), dev).eval()

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

        batch = to_device_batch(batch_np, dev)
        metrics = step_fn(batch)
        step += 1

        if step % cfg.log_interval == 0:
            # the only host copy of the metrics: a sync at log steps alone
            scalars = {k: float(v) for k, v in metrics.items()}
            logger.add_scalars(step, scalars)
            logger.print_losses(step, cfg.num_iterations, scalars)
        if eval_model is not None and step % (10 * cfg.log_interval) == 0:
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
                        help="half-resolution loss dial (not ported: raises "
                             "when set)")
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
