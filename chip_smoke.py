#!/usr/bin/env python3
"""Build and drive the PyTorch port on one NVIDIA GPU; fail on any fault.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with one CUDA card (it
uses card 0). Phases, in order; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi).
2. build: nvcc builds every kernel in
   unsupervised_depth_opticalflow_egomotion_torch/csrc/ for sm_90a, one
   process per source, in parallel.
3. kernels: each of the eleven kernels against its plain PyTorch version on
   the card, at every shape and dtype that the train steps of phase 5 give
   it (b8, 256x832: the geom and flow warps and the cost volumes run on
   2B = 16 images, the depth warps, the SSIM maps and the splats on 8, the
   depth decoder's reflection pads on 3B = 24),
   forward and backward, plus cases on no path (f32, five SSIM channels,
   smooth and near-zero splat flows, flows of more than 128 px), and timed
   with CUDA events beside the plain version, a PyTorch library call where
   one computes the same function,
   and the least time the card could take. A kernel and its library call
   get two times: "ms", 20 back-to-back calls between events (a short
   kernel shows its wrapper's host time there), and "device_ms", the same
   20 calls captured once in a CUDA graph and replayed between events (the
   device time alone). Each kernel records the argument
   signatures (dtype codes and sizes) it was launched with; phase 5 fails if
   a train step launches a kernel with a signature that this phase did not
   hold against the plain version. The f32 shapes of the CLI's geom mask
   dump (phase 6) are held here too, and so are the half-size bf16 warps
   and SSIM planes and the flow-mode splats of loss_base_scale=1, the
   cost volume of phase 8's one-pair f32 flow inference, and phase 9's f32
   launches (the cost volume at B = 8, eval_flow's, and the SSIM map and
   its backward at [8,256,832,3]), and the f32 reflection pads of the
   depth nets' inference and of FlowPoseModel's step.
4. parity: one train step with the kernels on the card against the plain
   versions on the CPU, at 64x128 b2 in f32 (TF32 off), from the same seed
   and the same draws: the geom step under the default Config, a flow step
   under flow_occ_impl="splat" and a depth step; the geom step with the
   triangulation, PnP, eight-point and depth consistency losses (each
   nonzero on both sides); the geom step under encoder_int8 (the int8
   depth net's gradient to INT8_GRAD_TOL); and the geom, flow ("splat")
   and depth steps at loss_base_scale=1.
5. train: the train steps at b8 256x832 bf16 on uint8 frames. The geom step
   under the default Config, the flow step under flow_occ_impl="splat" and
   the depth step through the bench module's ``run`` (bench.py's settings:
   a FLOP-count step, warm-up, 20 timed steps; bench.py's line with
   flops_per_step and mfu, and a short profile of one step at the end);
   the geom step under ssim_impl="xla" (timed in the same call, for
   comparison) and again through ``run`` without and with the FLOP-count
   step, in turns; the geom step under warp_impl="pallas" (bench.py's
   BENCH_WARP_IMPL=pallas: its FLOP count must be the default's); the flow
   step under the default "splat_nn"; the geom step under warp_impl="pallas",
   pwc_corr="pallas";
   the geom step with the four optional losses (w_8point 0.001) and at
   loss_base_scale=1 (timed, a frames/s line each and their ratio to the
   default geom step's); the geom step under encoder_int8 through ``run``
   (bench.py's BENCH_INT8=1: its FLOP count must be the default's, its
   frames/s ratio; 20 int8 GEMMs a step, and the card's int32 accumulators
   of every conv of a forward equal to the exact int64 version's); the flow
   ("splat") and depth steps at
   loss_base_scale=1. Every run zeroes the launch
   counts just before and reads them just after, and checks finite losses,
   moved parameters of the networks the mode trains, bit-equal parameters of
   the others, the exact launch count of every kernel, and that every
   launch had a signature checked in phase 3.
6. cli: the training entry point (``train.py`` of the port) at the default
   Config (b8 256x832 bf16, uint8 frames) on a synthetic prepared dataset
   of PNGs in a temporary directory: flow 3 steps through the
   occlusion switch, depth 2 steps in a subprocess (``python3 -m``), geom 8
   steps grafted from both, a resume of geom to 10 steps with a mask dump.
   Checks the graft, the restored tensors, checkpoints, dumps, finite
   losses and the launch signatures; prints which loader ran and why (the
   machine's image libraries), the CLI's steady geom frames/s beside phase
   5's, and the loader's samples/s alone. It runs after phase 5's timed
   steps and before phase 5's profiles.
7. eval: evaluation and inference from phase 6's geom checkpoint, on
   synthetic trees in KITTI's layouts at 375x1242 (flow 2015 and 2012,
   the raw eigen split, odometry sequence 09), in the same temporary
   directory: the eval CLI (``python3 -m ...test``) for kitti_flow_2012,
   kitti_depth, kitti_pose with the trajectory export and demo, and for
   kitti_flow_2015 with submission PNGs through this script's
   ``eval_cli_2015`` mode (``test.main`` with its flow task timed end to
   end and its launches counted: the eval_flow path of the cost-volume
   forward, f32, B = 8, 5 launches a batch, every signature one phase 3
   held), as subprocesses started together, each of which must exit 0 and
   print its metrics; meanwhile in this process one geom run of the
   training CLI with interleaved eval of the eigen split and odometry (its
   log.pkl must hold the two records; the flow sets are the eval CLI's, so
   no GT is read twice), each task timed where the CLI calls it; then the
   card's inference against the CPU's on 16 flow pairs (their GT read by
   the loaders' per-item readers), eigen frames and pose snippets, outputs
   and metrics within EVAL_TOL, TF32 on against off on the card, and a
   device-resident batch of each inference. Every launch of the phase must
   have a signature that phase 3 held. Runs before phase 5's profiles.
8. synth: ``train_synth_long`` at b8 256x832 bf16 on a generated synthetic
   world (16 train stacks, 4 eval frames) in the same temporary directory:
   flow 20 steps through the occlusion switch, depth 20 steps, geom 20
   steps grafted from both with the four optional losses, and a resume of
   geom through ``python3 -m``. Checks finite losses, the sampled losses
   nonzero at every logged geom step and the depth consistency nonzero
   exactly where the depth photometric loss (the same dynamic mask) is, the
   synth_eval records before and after each stage, the mask dump, the
   checkpoints and the launch signatures of the in-process stages. Phase
   9's subprocesses and phase 10's (a) and (c) run beside it.
9. two_view: the legacy two-view and flow-to-pose families, from phase 6's
   geom checkpoint and on phase 7's trees, in the same temporary directory:
   the eval CLI's ``--mode two_view`` for kitti_flow_2015 and
   kitti_flow_2012 (subprocesses, started when phase 7 ends and run beside
   phase 8; each must exit 0, print its metrics and
   give the EPEs of phase 7's geom-mode task within 1e-5 relative, plus
   half the printed last digit: the same PWC forward); meanwhile
   ``TriangulationPoseModel`` at b8 256x832 f32 (ransac_points 6000, 100
   iterations, the same draws) on the card against the CPU: flow and
   disparity within EVAL_TOL, and the geometric half on the exact rigid
   flow of a known depth and pose within 1e-2 of R and 0.999 of the
   translation's direction on both devices; ``FlowPoseModel``'s
   forward_train card against CPU at 64x128 b2 f32 (losses to 1e-3
   relative + 1e-7, gradients stated); and its training at b8 256x832 f32
   with Adam (finite losses, the depth net and FlowPoseNet move, the flow
   nets bit-equal, exact launch counts, a frames/s line). Runs after phase
   8; its profile comes last.
10. dp: data-parallel training (parallel/mesh.py), in the same temporary
   directory ((a) and (c) spawned when phase 7 ends, beside phase 8; their
   checks here): (a) two ranks of a gloo group on card 0 (NCCL refuses two
   ranks on one device), spawned, at 64x128 f32 (TF32 off), the global
   batch b4 and the same draws: a geom step with the four optional losses
   (the sampled ones weighted 0, as phase 4 compares the gradient without
   them), a flow ("splat") and a depth step; each rank's metrics,
   gradients, parameters, running statistics and Adam moments against one
   process on the global batch (phase 4's tolerances, _dp_compare), and
   the two ranks bit-equal; (b) the training CLI through ``torchrun
   --nproc_per_node 1`` (this script's ``dp_torchrun`` mode: ``train`` for
   8 geom steps, then ``main`` resuming to 10) in a one-process NCCL group
   on phase 6's PNGs at the default Config: exact launch counts, every
   signature held in phase 3, its steady frames/s beside phase 6's, and
   the default geom step in this process without and with a one-process
   NCCL group, timed in turns (the step's own cost of the group); (c) the
   training CLI on two spawned gloo ranks on card 0, geom at b8 global, 3
   steps: the logged losses the world means of the ranks' local ones, rank
   0 alone wrote ckpt/, log.pkl and config.json and printed, and the ranks
   end with bit-equal parameters and buffers. Runs after phase 9.
11. bench: ``python3 -m unsupervised_depth_opticalflow_egomotion_torch.bench``
   as a subprocess with the default settings: its standard output exactly
   one JSON line with bench.py's keys, metric bench.py's default string,
   0 < mfu <= 1, and flops_per_step phase 5's count in this process.
12. ablate: the step ablation (``ablate_step.run``, the port of
   scripts/ablate_step.py) at full width, 5 timed calls an entry, every
   launch's signature one that phase 3 held.
13. profiles: phase 5's geom, ssim_impl="xla", flow and depth steps and
   phase 9's FlowPoseModel step, after every timed run (a profiler session
   slows the host side of later steps).

The last three lines of standard output are the card's name and power
limit, one JSON object with a row per kernel (its launches, times, device
times and bound on the first of the paths geom, flow, depth, geom_regather,
eval_flow, geom_all, geom_ls1, flow_ls1, depth_ls1, two_view, flowpose,
geom_int8, dp that launches it, named in "path", and the same for every
path under
"by_path"), and
{"ok": true, "device": {...}}. Details (per-shape kernel table, compiler
report, profiles) go to chiprun_out/chip_smoke/.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

OUT_DIR = os.path.join("chiprun_out", "chip_smoke")
_TPU = "unsupervised_depth_opticalflow_egomotion_tpu/ops/pallas/"
# the paths that the kernel table reports, in the order in which a kernel's
# row picks its path: the train paths of phase 5 (geom_regather is the geom
# step under warp_impl="pallas", pwc_corr="pallas"; geom_all the geom step
# with the triangulation, PnP, eight-point and depth consistency losses;
# geom_ls1, flow_ls1 and depth_ls1 the steps at loss_base_scale=1, flow
# under "splat"; a "step" is a train step) and phase 7's eval_flow (the f32
# flow inference of the KITTI 2015 eval; a "step" is a batch of 8 pairs), and
# phase 9's two_view (TriangulationPoseModel's inference, f32; a "step" is a
# batch of 8 pairs) and flowpose (a FlowPoseModel train step, f32, b8); then
# geom_int8 (phase 5's geom step under encoder_int8) and dp (phase 10's
# training CLI in a one-process NCCL group under torchrun, geom at b8), which
# launch the kernels at the geom step's shapes
PATHS = ("geom", "flow", "depth", "geom_regather", "eval_flow", "geom_all", "geom_ls1",
         "flow_ls1", "depth_ls1", "two_view", "flowpose", "geom_int8", "dp")
CHECKED: dict[str, set] = {}  # kernel -> launch signatures held in phase 3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    """Print ``msg``, and keep it in OUT_DIR/log.txt (for a runner that
    returns only the end of the output)."""
    print(msg, flush=True)
    with open(os.path.join(OUT_DIR, "log.txt"), "a") as f:
        f.write(msg + "\n")


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured once in a
    CUDA graph, replayed ``replays`` times between events. No host work
    falls between the launches, so a short kernel's time is its own and not
    its wrapper's. A capture that fails raises (a fault of the run)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (iters * replays)
    del graph
    return ms


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def elem_ratio(got, ref, rtol: float, floor: float) -> float:
    """Largest |got - ref| / (rtol |ref| + floor) over the elements."""
    got, ref = got.float(), ref.float()
    return ((got - ref).abs() / (rtol * ref.abs() + floor)).max().item()


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    """The card's least time for the bytes and the operations (the peaks of
    utils/hardware.py, by the card's name)."""
    import torch

    from unsupervised_depth_opticalflow_egomotion_torch.utils.hardware import bound_ms

    return bound_ms(nbytes, flops, dtype, torch.cuda.get_device_name(0))


def path_kernels():
    """The eleven CUDA kernels of the train steps, by name: (kernel, the TPU
    kernel it replaces, or None for the reflection pad pair, which the port
    added)."""
    from unsupervised_depth_opticalflow_egomotion_torch.ops import cost_volume as cv
    from unsupervised_depth_opticalflow_egomotion_torch.ops import reflect_pad as rp
    from unsupervised_depth_opticalflow_egomotion_torch.ops import splat as sp
    from unsupervised_depth_opticalflow_egomotion_torch.ops import ssim as ss
    from unsupervised_depth_opticalflow_egomotion_torch.ops import warp as wp

    return {
        "warp_gather": (wp.WARP_GATHER, _TPU + "warp_window.py:166"),
        "warp_gather_nograd": (wp.WARP_GATHER_NOGRAD, _TPU + "warp_window.py:429"),
        "warp_gather_bwd": (wp.WARP_GATHER_BWD, _TPU + "warp_window.py:289"),
        "corr_fwd": (cv.CORR_FWD, _TPU + "correlation_fused.py:38"),
        "corr_bwd_df1": (cv.CORR_BWD_DF1, _TPU + "correlation_fused.py:52"),
        "corr_bwd_df2": (cv.CORR_BWD_DF2, _TPU + "correlation_fused.py:65"),
        "ssim_fwd": (ss.SSIM_FWD, _TPU + "ssim_fused.py:63"),
        "ssim_bwd": (ss.SSIM_BWD, _TPU + "ssim_fused.py:95"),
        "splat_mass": (sp.SPLAT_MASS, _TPU + "splat_window.py:64"),
        "reflect_pad_fwd": (rp.REFLECT_PAD_FWD, None),
        "reflect_pad_bwd": (rp.REFLECT_PAD_BWD, None),
    }


# ------------------------------------------------------------------ phases


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    return smi


def phase_build():
    from unsupervised_depth_opticalflow_egomotion_torch.ops import cuda_lib

    t0 = time.perf_counter()
    reports = cuda_lib.build_all()
    dt = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        for name, rep in reports.items():
            f.write(f"--- {name}.cu\n{rep}\n")
    built = ", ".join(sorted(reports)) or "none (already built)"
    log(f"build: {built} in {dt:.1f} s (nvcc {' '.join(cuda_lib.NVCC_FLAGS)})")
    for name in cuda_lib.sources():
        cuda_lib.load(name)


def _warp_coords(b, h, w, gen, dev):
    """Smooth motion of a few pixels plus noise; some taps leave the frame."""
    import torch

    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    ph = torch.rand(b, 1, 1, generator=gen) * 6.28
    ix = xx + 8.0 * torch.sin(yy / 23.0 + ph) + 2.0 * torch.rand(b, h, w, generator=gen) - 0.69
    iy = yy + 5.0 * torch.cos(xx / 31.0 + ph) + 2.0 * torch.rand(b, h, w, generator=gen) - 0.83
    return ix.float().contiguous().to(dev), iy.float().contiguous().to(dev)


def _decoder_pads(h: int, w: int, heads: int, min_scale: int) -> list:
    """The inputs (H, W, C) of the depth decoder's reflection-padded 3x3
    convolutions, one a launch, in a call on h x w frames with ``heads``
    disparity heads down to ``min_scale`` (models/depth_net.py's
    DepthDecoder): at each scale the block before the upsampling, the block
    after the skip concatenation, and the scale's head."""
    from unsupervised_depth_opticalflow_egomotion_torch.models.depth_net import _DEC_CH, _ENC_CH

    out, cin = [], _ENC_CH[-1]
    for scale in range(4, min_scale - 1, -1):
        hs, ws = h >> scale, w >> scale
        out.append((hs // 2, ws // 2, cin))
        out.append((hs, ws, _DEC_CH[scale] + (_ENC_CH[scale - 1] if scale else 0)))
        if scale < heads:
            out.append((hs, ws, _DEC_CH[scale]))
        cin = _DEC_CH[scale]
    return out


def phase_kernels():
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F

    from unsupervised_depth_opticalflow_egomotion_torch.kernel_times import splat_flow
    from unsupervised_depth_opticalflow_egomotion_torch.ops import cost_volume as cv
    from unsupervised_depth_opticalflow_egomotion_torch.ops import flops as fl
    from unsupervised_depth_opticalflow_egomotion_torch.ops import reflect_pad as rp
    from unsupervised_depth_opticalflow_egomotion_torch.ops import splat as sp
    from unsupervised_depth_opticalflow_egomotion_torch.ops import ssim as ss
    from unsupervised_depth_opticalflow_egomotion_torch.ops import warp as wp

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    rows = []  # one per (kernel, shape)

    for k, _ in path_kernels().values():
        k.seen.clear()
    # warp: (source dtype, B, H, W, launches per step by path); out bf16 as on
    # the paths. The geom and flow steps warp both directions as one 2B = 16
    # problem, from the uint8 frames at scale 0 (geom: the rigid and the flow
    # reconstruction; flow: all four flow scales); the depth step warps each
    # neighbour on its own (B = 8, two a scale) from bf16 frames. Plus one
    # f32 case with TF32 off, and the f32 warps of the CLI's geom mask dump
    # (one item: 2B = 2, f32 out; on no path of the table: checked, not
    # summed).
    # At loss_base_scale=1 no warp samples the uint8 frames: the geom and
    # flow steps warp bf16 frames at 128x416 and below (2B = 16), the depth
    # step at 128x416 and below (B = 8).
    both = {"geom": 2, "flow": 1, "geom_all": 2}
    half = {**both, "geom_ls1": 2, "flow_ls1": 1}
    cases = [
        ("uint8", 16, 256, 832, both), ("bfloat16", 16, 128, 416, half),
        ("bfloat16", 16, 64, 208, half),
        ("bfloat16", 16, 32, 104, {"flow": 1, "geom_ls1": 2, "flow_ls1": 1}),
        ("bfloat16", 8, 256, 832, {"depth": 2}),
        ("bfloat16", 8, 128, 416, {"depth": 2, "depth_ls1": 2}),
        ("bfloat16", 8, 64, 208, {"depth": 2, "depth_ls1": 2}),
        ("bfloat16", 8, 32, 104, {"depth_ls1": 2}),
        ("float32", 16, 256, 832, {}),
        ("uint8", 2, 256, 832, {}, "float32"), ("float32", 2, 128, 416, {}),
        ("float32", 2, 64, 208, {}),
    ]
    for sdt, b, h, w, per_step, *out in cases:
        regather = {"geom_regather": per_step["geom"]} if "geom" in per_step else {}
        u8 = torch.randint(0, 256, (b, h, w, 3), generator=gen, dtype=torch.uint8)
        src = u8.to(dev) if sdt == "uint8" else (u8.float() / 255.0).to(dev, getattr(torch, sdt))
        odt = getattr(torch, out[0] if out else "float32" if sdt == "float32" else "bfloat16")
        ix, iy = _warp_coords(b, h, w, gen, dev)
        got = wp.warp_gather(src, ix, iy, odt)
        want = wp.warp_gather_plain(src, ix, iy, odt)
        tol = 1e-5 if odt == torch.float32 else 4e-3  # one bf16 ulp of a value <= 1
        errs = [max_err(got[0], want[0]), max_err(got[1], want[1]), max_err(got[2], want[2])]
        # backward: the coordinate VJP from the kernel's derivative planes
        g_rgb = torch.randn(b, h, w, 3, generator=gen).to(dev, odt)
        g_w = torch.randn(b, h, w, 1, generator=gen).to(dev, odt)
        vk = wp.warp_coord_vjp(got[2], g_rgb, g_w, ix, iy, h, w)
        vp = wp.warp_coord_vjp(want[2], g_rgb, g_w, ix, iy, h, w)
        scale = max(vp[0].abs().max().item(), vp[1].abs().max().item(), 1.0)
        bwd_err = max(max_err(vk[0], vp[0]), max_err(vk[1], vp[1]))
        ok = errs[0] <= tol and errs[1] <= tol and errs[2] <= 1e-5 and bwd_err <= 1e-5 * scale
        n = b * h * w
        esz = src.element_size()
        osz = torch.empty((), dtype=odt).element_size()
        nbytes = src.numel() * esz + 8 * n + 4 * n * osz + 24 * n
        b_ms, b_by = bound(nbytes, fl.warp_gather_flops(n), "float32")
        fwd = lambda: wp.warp_gather(src, ix, iy, odt)  # noqa: E731
        plain_ms = cuda_ms(lambda: wp.warp_gather_plain(src, ix, iy, odt), 3)
        # yardsticks, never used by the port: grid_sample of an f32 NCHW copy
        # of the source at the same points (values only; it takes no uint8),
        # and its coordinate backward fed the rgb cotangent (no weight-sum
        # term), for the re-gather backward
        src_nchw = src.permute(0, 3, 1, 2).float().contiguous()
        grid = torch.stack([ix / (w - 1) * 2 - 1, iy / (h - 1) * 2 - 1], -1)
        lib = lambda: F.grid_sample(src_nchw, grid, mode="bilinear",  # noqa: E731
                                    padding_mode="zeros", align_corners=True)
        g_nchw = g_rgb.permute(0, 3, 1, 2).float().contiguous()
        lib_bwd = lambda: torch.ops.aten.grid_sampler_2d_backward(  # noqa: E731
            g_nchw, src_nchw, grid, 0, 0, True, [False, True])
        lib_ms, lib_dev = cuda_ms(lib, 20), graph_ms(lib)
        rows.append(dict(
            kernel="warp_gather", shape=f"{sdt}[{b},{h},{w},3]->{str(odt)[6:]}",
            per_step=per_step, max_abs_err=max(errs[:2]), deriv_err=errs[2],
            bwd_err=bwd_err, tol=tol, ok=ok, ms=cuda_ms(fwd, 20), device_ms=graph_ms(fwd),
            plain_ms=plain_ms, library_ms=lib_ms, library_device_ms=lib_dev,
            bound_ms=b_ms, bound_by=b_by,
        ))
        # warp_impl="pallas": the forward without derivative planes and the
        # re-gather backward, at the same points and cotangents
        got_n = wp.warp_gather_nograd(src, ix, iy, odt)
        err_n = max(max_err(got_n[0], want[0]), max_err(got_n[1], want[1]))
        b_ms, b_by = bound(src.numel() * esz + 8 * n + 4 * n * osz,
                           fl.warp_gather_nograd_flops(n), "float32")
        fwd_n = lambda: wp.warp_gather_nograd(src, ix, iy, odt)  # noqa: E731
        rows.append(dict(
            kernel="warp_gather_nograd", shape=f"{sdt}[{b},{h},{w},3]->{str(odt)[6:]}",
            per_step=regather, max_abs_err=err_n, tol=tol, ok=err_n <= tol,
            ms=cuda_ms(fwd_n, 20), device_ms=graph_ms(fwd_n), plain_ms=plain_ms,
            library_ms=lib_ms, library_device_ms=lib_dev, bound_ms=b_ms, bound_by=b_by,
        ))
        bk = wp.warp_gather_backward(src, ix, iy, g_rgb, g_w)
        bp = wp.warp_gather_backward_plain(src, ix, iy, g_rgb, g_w)
        err_b = max(max_err(bk[0], bp[0]), max_err(bk[1], bp[1]))
        for ga, gb in ((None, g_w), (g_rgb, None)):  # one cotangent absent
            one = wp.warp_gather_backward(src, ix, iy, ga, gb)
            one_p = wp.warp_gather_backward_plain(src, ix, iy, ga, gb)
            err_b = max(err_b, max_err(one[0], one_p[0]), max_err(one[1], one_p[1]))
        b_ms, b_by = bound(src.numel() * esz + 8 * n + 4 * n * osz + 8 * n,
                           fl.warp_gather_bwd_flops(n), "float32")
        bwd = lambda: wp.warp_gather_backward(src, ix, iy, g_rgb, g_w)  # noqa: E731
        rows.append(dict(
            kernel="warp_gather_bwd", shape=f"{sdt}[{b},{h},{w},3] g {str(odt)[6:]}",
            per_step=regather, max_abs_err=err_b, tol=1e-5 * scale, ok=err_b <= 1e-5 * scale,
            ms=cuda_ms(bwd, 20), device_ms=graph_ms(bwd),
            plain_ms=cuda_ms(lambda: wp.warp_gather_backward_plain(src, ix, iy, g_rgb, g_w), 3),
            library_ms=cuda_ms(lib_bwd, 20), library_device_ms=graph_ms(lib_bwd),
            bound_ms=b_ms, bound_by=b_by,
        ))
        del src_nchw, g_nchw, grid

    # correlation: the five PWC levels of the 2B decoder batch, bf16 ("train":
    # the train paths); f32 checks (on no path) at the finest level and at
    # the coarsest, where the tiles' last channel chunk is partial and pixel
    # rows are 8-byte aligned; the five levels of the CLI's f32 mask dump and
    # of an eval's last short batch (B = 2: KITTI 2012's 194 = 24 x 8 + 2);
    # and the five levels of the eval's f32 flow inference at B = 8
    # ("eval": the forward alone, on the eval_flow path, and on phase 9's
    # two_view inference and FlowPoseModel step, which run the same f32 PWC
    # forward on 8 pairs), and at B = 1 (the synthetic world's eval of phase
    # 8 infers one pair at a time)
    levels = [(4, 13, 196), (8, 26, 128), (16, 52, 96), (32, 104, 64), (64, 208, 32)]
    cases = [(h, w, c, "bfloat16", "train", 16) for h, w, c in levels] + [
        (64, 208, 32, "float32", None, 16), (4, 13, 196, "float32", None, 16)] + [
        (h, w, c, "float32", None, bb) for h, w, c in levels for bb in (2, 1)] + [
        (h, w, c, "float32", "eval", 8) for h, w, c in levels]
    train_corr = {"geom": 1, "flow": 1, "geom_all": 1, "geom_ls1": 1, "flow_ls1": 1}
    # at loss_base_scale=1 the finest flow (the 64x208 level's) feeds no
    # loss: its cost volume is computed, but autograd launches no backward
    no_ls1 = {"geom_ls1": 0, "flow_ls1": 0}
    for h, w, c, dts, on_path, b in cases:
        md, nd = 4, 81
        dt = getattr(torch, dts)
        f1 = (0.5 * torch.randn(b, h, w, c, generator=gen)).to(dev, dt)
        f2 = (0.5 * torch.randn(b, h, w, c, generator=gen)).to(dev, dt)
        g = torch.randn(b, h, w, nd, generator=gen).to(dev, dt)
        out = cv.corr_forward(f1, f2, md)
        df1, df2 = cv.corr_backward(g, f1, f2, md)
        pout = cv.correlation_plain(f1, f2, md)
        p1, p2 = cv.correlation_backward_plain(g, f1, f2, md)
        rel = 1e-5 if dt == torch.float32 else 8e-3  # two bf16 ulps of the largest value
        esz = f1.element_size()
        pix = b * h * w
        corr_flops = fl.corr_flops(b, h, w, c, md)  # each of the three kernels
        runs = {
            "corr_fwd": (out, pout, lambda: cv.corr_forward(f1, f2, md),
                         lambda: cv.correlation_plain(f1, f2, md),
                         2 * pix * c * esz + pix * nd * esz),
            "corr_bwd_df1": (df1, p1, lambda: cv.CORR_BWD_DF1(
                g.get_device(), g.data_ptr(), f2.data_ptr(), torch.empty_like(f1).data_ptr(),
                cv.DTYPE_CODE[dt], b, h, w, c, md),
                lambda: cv.correlation_backward_plain(g, f1, f2, md),
                pix * nd * esz + 2 * pix * c * esz),
            "corr_bwd_df2": (df2, p2, lambda: cv.CORR_BWD_DF2(
                g.get_device(), g.data_ptr(), f1.data_ptr(), torch.empty_like(f1).data_ptr(),
                cv.DTYPE_CODE[dt], b, h, w, c, md),
                None, pix * nd * esz + 2 * pix * c * esz),
        }
        plain_bwd_ms = cuda_ms(runs["corr_bwd_df1"][3], 3) / 2  # both halves in one call
        for name, (k_out, p_out, k_fn, p_fn, nbytes) in runs.items():
            scale = max(p_out.float().abs().max().item(), 1e-6)
            err = max_err(k_out, p_out)
            b_ms, b_by = bound(nbytes, corr_flops, dts)
            rows.append(dict(
                kernel=name, shape=f"{dts}[{b},{h},{w},{c}]",
                # pwc_corr="pallas" and the eval launch the forward kernel only
                per_step=({**train_corr, **({"geom_regather": 1} if name == "corr_fwd" else
                                            no_ls1 if h == 64 else {})}
                          if on_path == "train" else
                          {"eval_flow": 1, "two_view": 1, "flowpose": 1}
                          if on_path == "eval" and name == "corr_fwd" else {}),
                max_abs_err=err, tol=rel * scale, ok=err <= rel * scale,
                ms=cuda_ms(k_fn, 20), device_ms=graph_ms(k_fn),
                plain_ms=cuda_ms(p_fn, 3) if name == "corr_fwd" else plain_bwd_ms,
                library_ms=None, library_device_ms=None, bound_ms=b_ms, bound_by=b_by,
            ))
    # SSIM: the three loss scales of one warp direction (B = 8), bf16, and
    # checks on no path: f32, and five channels (more than the kernels take:
    # the wrapper lays them out as one-channel images). Images in [0, 1] that
    # differ by noise, a third of the pixels zeroed in both (as the loss's
    # mask products do). Value, both gradients, and the border ring (where
    # the zero padding acts) on its own.
    # The CLI's f32 mask dump takes the three scales of one item (B = 1). At
    # loss_base_scale=1 the planes are half the size: 128x416 down to 32x104.
    # FlowPoseModel's pairwise loss (phase 9) takes one full-size f32 map of
    # B = 8, forward and backward.
    three = {"geom": 2, "flow": 2, "geom_regather": 2, "geom_all": 2}
    three_half = {**three, "geom_ls1": 2, "flow_ls1": 2}
    cases = [(256, 832, 3, "bfloat16", three, 8), (128, 416, 3, "bfloat16", three_half, 8),
             (64, 208, 3, "bfloat16", three_half, 8),
             (32, 104, 3, "bfloat16", {"geom_ls1": 2, "flow_ls1": 2}, 8),
             (256, 832, 3, "float32", {"flowpose": 1}, 8),
             (64, 208, 5, "bfloat16", {}, 8)] + [
             (h, w, 3, "float32", {}, 1) for h, w in ((256, 832), (128, 416), (64, 208))]
    for h, w, c, dts, per_step, b in cases:
        dt = getattr(torch, dts)
        x = torch.rand(b, h, w, c, generator=gen)
        y = (x + 0.2 * torch.randn(b, h, w, c, generator=gen)).clamp(0, 1)
        keep = (torch.rand(b, h, w, 1, generator=gen) > 0.33).float()
        x, y = (x * keep).to(dev, dt), (y * keep).to(dev, dt)
        g = torch.randn(b, h, w, c, generator=gen).to(dev, dt)
        s_k = ss.ssim_forward(x, y)
        dx_k, dy_k = ss.ssim_backward(x, y, g)
        s_p = ss.ssim_plain(x, y)
        dx_p, dy_p = ss.ssim_backward_plain(x, y, g)
        f32 = dt == torch.float32
        # f32: the same sums in another order; gradients to 1e-4 of the largest
        # (they grow where both windows are nearly empty and the denominator
        # nears C1 C2). bf16: the same bf16 inputs, f32 intermediates on both
        # sides, one bf16 rounding of the result: 8e-3 on the map, and each
        # gradient element to one bf16 ulp of its own value (8e-3 relative)
        # plus 1e-5 of the largest for the elements near zero, where the f32
        # sums cancel.
        tol_s = 1e-5 if f32 else 8e-3
        gscale = max(dx_p.float().abs().max().item(), dy_p.float().abs().max().item(), 1.0)
        g_rtol, g_floor = (0.0, 1e-4 * gscale) if f32 else (8e-3, 1e-5 * gscale)
        ring = torch.ones(h, w, dtype=torch.bool, device=dev)
        ring[1:-1, 1:-1] = False
        err_s = max_err(s_k, s_p)
        err_g = max(max_err(dx_k, dx_p), max_err(dy_k, dy_p))
        ring_s = max_err(s_k[:, ring], s_p[:, ring])
        ring_g = max(max_err(dx_k[:, ring], dx_p[:, ring]), max_err(dy_k[:, ring], dy_p[:, ring]))
        # the ring's elements are among the frame's: one ratio covers both
        ratio_g = max(elem_ratio(dx_k, dx_p, g_rtol, g_floor), elem_ratio(dy_k, dy_p, g_rtol, g_floor))
        n = x.numel()
        esz = x.element_size()
        fb_ms, fb_by = bound(3 * n * esz, fl.ssim_fwd_flops(n), "float32")
        bb_ms, bb_by = bound(5 * n * esz, fl.ssim_bwd_flops(n), "float32")
        s_fn = lambda: ss.ssim_forward(x, y)  # noqa: E731
        b_fn = lambda: ss.ssim_backward(x, y, g)  # noqa: E731
        rows.append(dict(
            kernel="ssim_fwd", shape=f"{dts}[{b},{h},{w},{c}]", per_step=per_step,
            max_abs_err=err_s, ring_err=ring_s, tol=tol_s, ok=err_s <= tol_s and ring_s <= tol_s,
            ms=cuda_ms(s_fn, 20), device_ms=graph_ms(s_fn),
            plain_ms=cuda_ms(lambda: ss.ssim_plain(x, y), 3),
            library_ms=None, library_device_ms=None, bound_ms=fb_ms, bound_by=fb_by,
        ))
        rows.append(dict(
            kernel="ssim_bwd", shape=f"{dts}[{b},{h},{w},{c}]", per_step=per_step,
            max_abs_err=err_g, ring_err=ring_g, tol=g_floor, rtol=g_rtol, tol_ratio=ratio_g,
            ok=ratio_g <= 1.0, ms=cuda_ms(b_fn, 20), device_ms=graph_ms(b_fn),
            plain_ms=cuda_ms(lambda: ss.ssim_backward_plain(x, y, g), 3),
            library_ms=None, library_device_ms=None, bound_ms=bb_ms, bound_by=bb_by,
        ))
        del x, y, g, s_k, s_p, dx_k, dy_k, dx_p, dy_p

    # splat: the four flow scales of one direction (B = 8), bf16 as on the
    # path, random flows of +-4 px; at full size, timed but on no path, a
    # smooth flow of a few pixels (as a trained PWC's) and a near-zero one
    # (as at init), an f32 check, and an f32 flow whose displacements pass
    # 128 px and leave the frame on every side, where a window without the
    # kernel's global atomics would drop mass. The f32 atomics sum in an
    # order that changes from run to run: 1e-5 of the largest mass in f32;
    # bf16 adds the one rounding of the output. A random flow piles mass up
    # (a largest mass above 1.5 shows that the case tests the sums).
    # (flow_ls1: the three flow scales from 128x416 down)
    two = {"flow": 2}
    two_half = {"flow": 2, "flow_ls1": 2}
    cases = [(256, 832, "bfloat16", two, "random"), (128, 416, "bfloat16", two_half, "random"),
             (64, 208, "bfloat16", two_half, "random"), (32, 104, "bfloat16", two_half, "random"),
             (256, 832, "bfloat16", {}, "smooth"), (256, 832, "bfloat16", {}, "zero"),
             (256, 832, "float32", {}, "random"), (256, 832, "float32", {}, "far")]
    for h, w, dts, per_step, kind in cases:
        b, dt = 8, getattr(torch, dts)
        flow = splat_flow(b, h, w, "random" if kind == "far" else kind, gen)
        if kind == "far":
            jump = torch.rand(b, h, w, 1, generator=gen) < 0.33
            big = (3.0 * torch.rand(b, h, w, 2, generator=gen) - 1.5) * torch.tensor([w, h])
            flow = torch.where(jump, big, flow)
        flow = flow.to(dev, dt)
        m_k = sp.splat_mass(flow)
        m_p = sp.splat_mass_plain(flow)
        scale = max(m_p.float().max().item(), 1.0)
        tol = (1e-5 if dt == torch.float32 else 8e-3) * scale
        err = max_err(m_k, m_p)
        n = b * h * w
        # the function's bytes: the flow read once, the mass written once in
        # the flow's type (the kernel's f32 plane is scratch)
        b_ms, b_by = bound(n * 3 * flow.element_size(), fl.splat_mass_flops(n), "float32")
        sp_fn = lambda: sp.splat_mass(flow)  # noqa: E731
        rows.append(dict(
            kernel="splat_mass", shape=f"{dts}[8,{h},{w},2] {kind}",
            per_step=per_step, max_abs_err=err, tol=tol,
            ok=err <= tol and (scale > 1.5 or kind in ("smooth", "zero")),
            ms=cuda_ms(sp_fn, 20), device_ms=graph_ms(sp_fn),
            plain_ms=cuda_ms(lambda: sp.splat_mass_plain(flow), 3),
            library_ms=None, library_device_ms=None, bound_ms=b_ms, bound_by=b_by,
        ))

    # reflect_pad: the depth decoder's inputs, one a reflection-padded 3x3
    # conv (_decoder_pads). A case is one decoder call: (dtype, frames,
    # heads, min_scale, calls a step by path). The geom and depth steps run
    # it once on 3B = 24 bf16 frames, forward and backward (13 inputs; at
    # loss_base_scale=1 a fourth head and no scale 0: 11); FlowPoseModel's
    # step twice on B = 8 f32 with one head (11 inputs each); the two-view
    # inference twice on 8 f32 frames, forward only, as the eigen eval's
    # batches of 8; and on no path of the table, forward only in f32, the
    # mask dump's one item (3 frames) and the synthetic world's eval (one
    # frame). Forward bit for bit; the gradient sums at most four
    # cotangents in f32 in another order than ATen's atomics: within 2^-20
    # of their magnitudes, plus in bf16 one rounding (2^-8 |ref|). Timed
    # beside the plain version (ATen's pad of the NCHW view), ATen's pad of
    # an NCHW-contiguous tensor and the bound (input and output once).
    geom_depth = {"geom": 1, "depth": 1, "geom_all": 1, "geom_regather": 1}
    ls1 = {"geom_ls1": 1, "depth_ls1": 1}
    cases = [("bfloat16", 24, 3, 0, geom_depth, geom_depth), ("bfloat16", 24, 4, 1, ls1, ls1),
             ("float32", 8, 1, 0, {"flowpose": 2}, {"flowpose": 2}),
             ("float32", 8, 3, 0, {"two_view": 2}, {}),
             ("float32", 3, 3, 0, {}, {}), ("float32", 1, 3, 0, {}, {})]
    pads = {}  # (dtype, B, H, W, C) -> (forward, backward launches a step by path)
    for dts, b, heads, min_scale, per_fwd, per_bwd in cases:
        for h, w, c in _decoder_pads(256, 832, heads, min_scale):
            fwd_n, bwd_n = pads.setdefault((dts, b, h, w, c), ({}, {}))
            for counts, per in ((fwd_n, per_fwd), (bwd_n, per_bwd)):
                for path, n in per.items():
                    counts[path] = counts.get(path, 0) + n
    pad_bwd = torch.ops.aten.reflection_pad2d_backward
    for (dts, b, h, w, c), (per_fwd, per_bwd) in pads.items():
        dt = getattr(torch, dts)
        x = torch.randn(b, h, w, c, generator=gen).to(dev, dt)
        g = torch.randn(b, h + 2, w + 2, c, generator=gen).to(dev, dt)
        got, want = rp.reflect_pad_forward(x), rp.reflect_pad_plain(x)
        err = max_err(got, want)
        dx = rp.reflect_pad_backward(g).float()
        x_nchw = x.permute(0, 3, 1, 2)
        want_g, magnitude = (pad_bwd(cot.permute(0, 3, 1, 2), x_nchw.float(), [1, 1, 1, 1])
                             .permute(0, 2, 3, 1) for cot in (g.float(), g.float().abs()))
        rtol = 2.0**-8 if dt == torch.bfloat16 else 0.0
        diff = (dx - want_g).abs()
        ratio = (diff / (2.0**-20 * magnitude + rtol * want_g.abs()).clamp_min(1e-30)
                 ).max().item()
        err_g = diff.max().item()
        del got, want, dx, want_g, magnitude, diff
        b_ms, b_by = bound((x.numel() + g.numel()) * x.element_size(), 0.0, dts)
        x_c, g_c = x_nchw.contiguous(), g.permute(0, 3, 1, 2).contiguous()
        runs = {
            "reflect_pad_fwd": (per_fwd, lambda: rp.reflect_pad_forward(x),
                                lambda: rp.reflect_pad_plain(x),
                                lambda: F.pad(x_c, (1, 1, 1, 1), mode="reflect"),
                                dict(max_abs_err=err, tol=0.0, ok=err == 0.0)),
            "reflect_pad_bwd": (per_bwd, lambda: rp.reflect_pad_backward(g),
                                lambda: pad_bwd(g.permute(0, 3, 1, 2), x_nchw, [1, 1, 1, 1]),
                                lambda: pad_bwd(g_c, x_c, [1, 1, 1, 1]),
                                dict(max_abs_err=err_g, tol=2.0**-20, rtol=rtol,
                                     tol_ratio=ratio, ok=ratio <= 1.0)),
        }
        for name, (per_step, k_fn, p_fn, lib, check) in runs.items():
            rows.append(dict(
                kernel=name, shape=f"{dts}[{b},{h},{w},{c}]", per_step=per_step, **check,
                ms=cuda_ms(k_fn, 20), device_ms=graph_ms(k_fn), plain_ms=cuda_ms(p_fn, 20),
                library_ms=cuda_ms(lib, 20), library_device_ms=graph_ms(lib),
                bound_ms=b_ms, bound_by=b_by,
            ))
        del x, g, x_c, g_c

    # the int8 geom step and the data-parallel CLI launch what the geom step does
    for r in rows:
        if "geom" in r["per_step"]:
            r["per_step"] = {**r["per_step"], "geom_int8": r["per_step"]["geom"],
                             "dp": r["per_step"]["geom"]}
    torch.cuda.synchronize()
    for name, (k, _) in path_kernels().items():
        CHECKED[name] = set(k.seen)
    with open(os.path.join(OUT_DIR, "kernels.json"), "w") as f:
        json.dump(rows, f, indent=1)
    for r in rows:
        lib = "-" if r["library_ms"] is None else (
            f"{r['library_ms']:.4f} (device {r['library_device_ms']:.4f})")
        tol = f"{r['tol']:.3g}"
        if "tol_ratio" in r:
            tol += f" + {r['rtol']:g} |ref| by element, worst ratio {r['tol_ratio']:.3g}"
        log(f"kernel {r['kernel']:18s} {r['shape']:34s} err {r['max_abs_err']:.3g} "
            f"(tol {tol}) {'ok' if r['ok'] else 'MISMATCH'}  ms {r['ms']:.4f} "
            f"device {r['device_ms']:.4f} plain {r['plain_ms']:.4f} lib {lib} "
            f"bound {r['bound_ms']:.4f} ({r['bound_by']})")
    bad = [f"{r['kernel']} {r['shape']}" for r in rows if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    return rows


def _batch(b, h, w, dev):
    """bench.py's batch (the bench module's ``make_batch``) on ``dev``."""
    from unsupervised_depth_opticalflow_egomotion_torch.bench import make_batch

    return make_batch(b, h, w, dev)


NETS = {"flow": ("fpyramid", "pwc_model"), "depth": ("depth_net", "pose_net"),
        "geom": ("depth_net", "pose_net", "fpyramid", "pwc_model")}


# the geom losses that sample matches (ill-conditioned at init: see phase_parity)
SAMPLED = ("loss_triangle", "loss_pnp", "loss_eight_point")
GEO_LOSSES = {"enable_triangle": True, "enable_pnp": True, "enable_eight_point": True,
              "enable_depth_consis": True}


def phase_parity():
    """Kernels on the card vs plain versions on the CPU, through one whole
    train step at 64x128 b2 f32 (TF32 off), same weights, batch and draws:
    the geom step under the default Config, a flow step ("splat") and a depth
    step; the geom step with the four optional losses; and the geom, flow
    ("splat") and depth steps at loss_base_scale=1.

    Losses to 1e-3 relative + 1e-7 (tests/test_torch_geom.py), 3e-3 at
    loss_base_scale=1 (an 8x16 coarsest scale, where one hard-mask pixel
    that flips moves a loss by ~2e-3: tests/test_torch_synth.py) and 5e-3
    for the depth consistency. The sampled losses are ill-conditioned in f32
    at init (tests/test_torch_synth.py, SAMPLED_TOL): triangulation to 3e-2
    and PnP to 0.2 of the batch's max, the eight-point loss to its range;
    the gradient compared is then that of the weighted total without them."""
    import torch

    from unsupervised_depth_opticalflow_egomotion_torch.config import Config, loss_weights
    from unsupervised_depth_opticalflow_egomotion_torch.parallel import init_state
    from unsupervised_depth_opticalflow_egomotion_torch.parallel.train_step import step_draws

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for kw in ({"mode": "geom"}, {"mode": "flow", "flow_occ_impl": "splat"}, {"mode": "depth"},
               {"mode": "geom", **GEO_LOSSES}, {"mode": "geom", "encoder_int8": True},
               {"mode": "geom", "loss_base_scale": 1},
               {"mode": "flow", "flow_occ_impl": "splat", "loss_base_scale": 1},
               {"mode": "depth", "loss_base_scale": 1}):
        cfg = Config(img_hw=(64, 128), batch_size=2, compute_dtype="float32", **kw)
        weights = loss_weights(cfg)
        res = {}
        for dev in ("cpu", "cuda"):
            model, _ = init_state(cfg, dev)
            batch = _batch(2, 64, 128, dev)
            if cfg.mode == "geom":
                pack = model.forward_geom(*batch, draws=step_draws(model, 0, batch))[0]
            else:
                pack = (model.forward_flow if cfg.mode == "flow" else model.forward_depth)(*batch)
            sum(weights[k] * v.mean() for k, v in pack.items() if k not in SAMPLED).backward()
            res[dev] = (
                {k: v.detach().cpu().numpy() for k, v in pack.items()},
                {k: p.grad.detach().float().cpu() for k, p in model.named_parameters()
                 if p.grad is not None},
            )
        (p_cpu, g_cpu), (p_gpu, g_gpu) = res["cpu"], res["cuda"]
        rtol = 3e-3 if cfg.loss_base_scale else 1e-3
        worst_loss, loss_ok = 0.0, set(p_cpu) == set(p_gpu)  # worst: error over tolerance
        for k, want in p_cpu.items():
            got, scale = p_gpu[k], max(abs(want).max(), 1e-7)
            if k == "loss_eight_point":
                loss_ok &= bool(((got >= 0) & (got <= 2 / 9)).all())
                continue
            tol = {"loss_triangle": 3e-2 * scale, "loss_pnp": 0.2 * scale}.get(
                k, (5e-3 if k == "loss_depth_consis" else rtol) * abs(want) + 1e-7)
            loss_ok &= bool((abs(got - want) <= tol).all())
            worst_loss = max(worst_loss, float((abs(got - want) / tol).max()))
        worst_grad = 0.0  # relative L2 error over its tolerance
        for net in NETS[cfg.mode]:
            ks = [k for k in g_cpu if k.startswith(net + ".")]
            a = torch.cat([g_gpu[k].flatten() for k in ks])
            b = torch.cat([g_cpu[k].flatten() for k in ks])
            tol = INT8_GRAD_TOL if cfg.encoder_int8 and net == "depth_net" else 2e-2
            worst_grad = max(worst_grad, ((a - b).norm() / b.norm()).item() / tol)
        same_nets = set(g_cpu) == set(g_gpu)
        name = " ".join(f"{k}={v}" for k, v in kw.items() if k != "mode" and k not in GEO_LOSSES)
        name += " +triangle,pnp,eight_point,depth_consis" if "enable_pnp" in kw else ""
        sampled = ", ".join(f"{k} {p_gpu[k].mean():.4g} vs {p_cpu[k].mean():.4g}"
                            for k in SAMPLED if k in p_cpu and abs(p_cpu[k]).max() > 0)
        log(f"parity {cfg.mode} {name} 64x128 f32 card vs cpu: worst loss error "
            f"{worst_loss:.3g} of its tolerance ({rtol:g} relative + 1e-7), worst gradient "
            f"rel L2 err {worst_grad:.3g} of its tolerance (2e-2"
            + (f", the int8 depth net's {INT8_GRAD_TOL:g})" if cfg.encoder_int8 else ")")
            + (f"; sampled losses card vs cpu: {sampled}" if sampled else ""))
        if not (loss_ok and worst_grad <= 1.0 and same_nets):
            fail(f"the card's {cfg.mode} {name} step disagrees with the plain CPU step")
        # the optional losses are held live: at init the dynamic mask keeps
        # pixels, so the depth consistency it gates is nonzero on both sides
        if "enable_pnp" in kw:
            dead = sorted({k for k in (*SAMPLED, "loss_depth_consis") for p in (p_cpu, p_gpu)
                           if not (abs(p[k]) > 0).all()})
            if dead:
                fail(f"the {cfg.mode} {name} step: an optional loss is zero: {dead}")


# encoder_int8 (phase 4): an activation whose f32 value differs by rounding
# between the card and the CPU can round to the next int8 level, and the
# steps add up through the encoder, so the depth net's gradient is held to
# 0.1 relative L2 (on the CPU a 1e-6 relative perturbation of the weights
# moves it by 3.7e-2; the float depth net's by 1.9e-4)
INT8_GRAD_TOL = 0.1


WATCH = {"depth_net": "depth_net.encoder.encoder.conv1.weight",
         "pose_net": "pose_net.pose_conv.weight",
         # the coarsest PWC level feeds every flow scale (at loss_base_scale=1
         # the finest head, predict_flow2, feeds no loss and stays put)
         "fpyramid": "fpyramid.conv1.0.weight", "pwc_model": "pwc_model.conv6_0.0.weight"}


def _start(name, overrides, group=None):
    """Model, optimizer and batch of Config(b8 256x832 bf16, **overrides) on
    uint8 frames, on the default device (CUDA); the step in ``group``."""
    import torch

    from unsupervised_depth_opticalflow_egomotion_torch.config import Config
    from unsupervised_depth_opticalflow_egomotion_torch.parallel import init_state, make_train_step

    b, h, w = 8, 256, 832
    cfg = Config(img_hw=(h, w), batch_size=b, **overrides)
    if cfg.compute_dtype != "bfloat16":
        fail("the train phase expects the default compute_dtype, bfloat16")
    model, opt = init_state(cfg)
    return {
        "name": name, "cfg": cfg, "model": model, "step": make_train_step(model, cfg, opt, group),
        "batch": _batch(b, h, w, torch.device("cuda")), "steps": 0,
        "before": {k: p.detach().clone() for k, p in model.named_parameters()},
    }


def _start_bench(name, settings):
    """A run of the bench module's step (``bench.Bench``) for ``settings``
    (``bench.Settings``: the environment settings of ``python -m
    ...bench``), on the card."""
    from unsupervised_depth_opticalflow_egomotion_torch import bench

    b = bench.Bench(settings.config())
    return {
        "name": name, "cfg": b.cfg, "model": b.model, "step": b.train_step, "batch": b.batch,
        "bench": b, "metric": settings.metric(),
        "before": {k: p.detach().clone() for k, p in b.model.named_parameters()},
    }


def _zero_counts():
    """Every kernel's launch count and signatures zeroed (the card idle
    first); returns the kernels by name."""
    import torch

    kernels = {n: k for n, (k, _) in path_kernels().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
        k.seen.clear()
    return kernels


def _check_run(run, kernels, metrics, per_step, steps, timing) -> dict:
    """After ``steps`` runs of the step's body (``TrainStep.body_runs``: its
    calls op by op and its graph's capture; a replay launches nothing from
    the host) of ``run`` since ``_zero_counts``: finite
    losses, moved parameters of the networks the mode trains, bit-equal
    parameters of the others, the exact launch count of every kernel
    (``per_step``: kernel -> launches a step; the others must stay at
    zero), and every launch's signature one that phase 3 held against the
    plain version. Returns the launches."""
    import torch

    name = run["name"]
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in kernels.items()}
    values = {k: float(v) for k, v in metrics.items()}
    if not all(math.isfinite(v) for v in values.values()):
        fail(f"{name}: non-finite losses: {values}")
    before, after = run["before"], dict(run["model"].named_parameters())
    trained = NETS[run["cfg"].mode]
    still = [WATCH[n] for n in trained if torch.equal(before[WATCH[n]], after[WATCH[n]])]
    if still:
        fail(f"{name}: parameters did not move: {still}")
    strayed = [k for k, v in before.items()
               if not k.startswith(tuple(n + "." for n in trained)) and not torch.equal(v, after[k])]
    if strayed:
        fail(f"{name}: parameters of networks the mode does not train moved: {strayed[:5]}")
    want = {n: per_step.get(n, 0) * steps for n in kernels}
    if launches != want:
        fail(f"{name}: kernel launches {launches}, expected {want}")
    unchecked = {n: sorted(k.seen - CHECKED[n]) for n, k in kernels.items() if k.seen - CHECKED[n]}
    if unchecked:
        fail(f"{name}: launches with signatures (dtype codes, sizes) that the kernels phase "
             f"did not hold against the plain version: {unchecked}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    log(f"train {name}: {steps} body runs, {timing}peak memory {peak_gb:.2f} GiB, "
        f"launches/step {json.dumps(per_step)}, losses {json.dumps(values)}")
    return launches


def _drive(run, per_step, warmup, timed):
    """``warmup + timed`` train steps of ``run``, checked by ``_check_run``
    (the launch counts zeroed just before, read just after). Returns
    (launches, ms per step or None, peak GiB, the body's runs)."""
    import torch

    step, batch = run["step"], run["batch"]
    kernels = _zero_counts()
    runs0 = step.body_runs
    for _ in range(warmup):
        metrics = step(batch, run["steps"])  # the step number seeds the sampled losses' draws
        run["steps"] += 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        metrics = step(batch, run["steps"])
        run["steps"] += 1
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / timed * 1e3 if timed else None
    timing = f"{timed} timed steps, {ms:.1f} ms/step, " if timed else ""
    runs = step.body_runs - runs0
    launches = _check_run(run, kernels, metrics, per_step, runs, timing)
    return launches, ms, torch.cuda.max_memory_allocated() / 2**30, runs


def _bench_drive(run, per_step, iters, count_flops):
    """``bench.run`` of ``run`` (``_start_bench``): the FLOP-count step if
    ``count_flops``, the warm-up and ``iters`` timed steps, checked by
    ``_check_run``. Returns (bench.py's line, launches, the step body's
    runs, ms per step, peak GiB)."""
    import torch

    from unsupervised_depth_opticalflow_egomotion_torch import bench

    b = run["bench"]
    kernels = _zero_counts()
    runs0 = b.train_step.body_runs
    line = bench.run(b, run["metric"], iters, count_flops=count_flops)
    ms = b.seconds_per_step * 1e3
    count = " after a FLOP-count step" if count_flops else ""
    runs = b.train_step.body_runs - runs0
    launches = _check_run(run, kernels, b.metrics, per_step, runs,
                          f"{iters} timed steps{count} (bench.run), {ms:.1f} ms/step, ")
    return line, launches, runs, ms, torch.cuda.max_memory_allocated() / 2**30


def _metric_line(metric, ms, smi):
    import torch

    log(json.dumps({
        "metric": metric, "value": round(8 / ms * 1e3, 2), "unit": "frames/s/chip",
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "ms_per_step": round(ms, 2),
    }))


def phase_train(smi: str):
    """Every train path at full width. The geom (default Config), flow
    ("splat") and depth steps go through the bench module's ``run``
    (``bench.py``'s settings, FLOP count and line); the others through
    ``_drive``. All timed runs come before the first profile: profiling
    slows the host side of the steps that come after it. The geom step is
    timed in turns with ssim_impl="xla" (default, xla, xla, default) and
    without and with the FLOP-count step before its timed steps, so that
    host drift within the call shows. Returns the launches of each path's
    first run, the bench lines of geom, flow and depth, and the profiles to
    run once every timed run (the later phases' too) is done."""
    import torch

    from unsupervised_depth_opticalflow_egomotion_torch.bench import Settings

    torch.backends.cudnn.benchmark = True
    corr = {"corr_fwd": 5, "corr_bwd_df1": 5, "corr_bwd_df2": 5}
    ssim = {"ssim_fwd": 6, "ssim_bwd": 6}
    # the depth decoder's pads, forward and backward: 13 inputs, 11 at
    # loss_base_scale=1 (phase 3)
    pad = {"reflect_pad_fwd": 13, "reflect_pad_bwd": 13}
    pad_ls1 = {"reflect_pad_fwd": 11, "reflect_pad_bwd": 11}
    by_path = {}  # path -> (launches by kernel, the step body's runs) of its first run
    lines = {}  # path -> bench.py's line of its first run

    def drive(run, per_step, warmup, timed, path=None):
        launches, ms, peak, runs = _drive(run, per_step, warmup, timed)
        if path is not None:
            by_path[path] = (launches, runs)
        return ms, peak

    def bench_drive(run, per_step, iters, count_flops, path=None):
        line, launches, steps, ms, peak = _bench_drive(run, per_step, iters, count_flops)
        if path is not None:
            by_path[path] = (launches, steps)
            lines[path] = line
            log(json.dumps({**line, "path": path, "device": torch.cuda.get_device_name(0),
                            "nvidia_smi": smi, "ms_per_step": ms}))
        return ms, peak

    geom_k = {"warp_gather": 6, **corr, **ssim, **pad}
    xla_k = {"warp_gather": 6, **corr, **pad}
    geom = _start_bench("geom default", Settings())
    xla = _start("geom ssim_impl=xla", {"ssim_impl": "xla"})
    ms_g, gb_g = bench_drive(geom, geom_k, 20, True, "geom")
    ms_x, gb_x = drive(xla, xla_k, 3, 10)
    ms_x2, _ = drive(xla, xla_k, 0, 5)
    # the FLOP-count step (a FlopCounterMode session) must not slow the
    # timed steps after it: without it, with it, without it
    turns = [(c, bench_drive(geom, geom_k, 10, c)[0]) for c in (False, True, False)]
    ms_g2 = turns[0][1]
    log("geom step through bench.run, in turns: " + ", ".join(
        f"{ms:.2f} ms/step {'after' if c else 'without'} the FLOP-count step"
        for c, ms in [(True, ms_g), *turns]) + f" (20, then 10 timed steps each) | nvidia-smi: {smi}")
    # BENCH_WARP_IMPL=pallas: the gathers without planes and the re-gather
    # backward; the FLOP count reads the same work as the default route's
    run = _start_bench("geom BENCH_WARP_IMPL=pallas", Settings(warp_impl="pallas"))
    line = _bench_drive(run, {"warp_gather_nograd": 6, "warp_gather_bwd": 6, **corr, **ssim,
                              **pad}, 5, True)[0]
    if line["flops_per_step"] != lines["geom"]["flops_per_step"]:
        fail(f"geom BENCH_WARP_IMPL=pallas: flops_per_step {line['flops_per_step']}, the "
             f"default route's {lines['geom']['flops_per_step']}")
    log(f"geom BENCH_WARP_IMPL=pallas through bench.run: {json.dumps(line)}")
    del run
    torch.cuda.empty_cache()

    flow_k = {"warp_gather": 4, **corr, **ssim, "splat_mass": 8}
    flow = _start_bench("flow splat", Settings(mode="flow", flow_occ="splat"))
    ms_f, _ = bench_drive(flow, flow_k, 20, True, "flow")
    depth = _start_bench("depth", Settings(mode="depth"))
    ms_d, _ = bench_drive(depth, {"warp_gather": 6, **pad}, 20, True, "depth")

    # the geom step with the four optional losses (the eight-point loss at
    # the weight configs/kitti_geom.yaml names as stable), and at
    # loss_base_scale=1: the kernels of the default geom step. The sampled
    # losses and the source depth of the depth consistency run on no kernel,
    # so the launch counts are the default's too, but at ls=1: there every
    # warp samples bf16 frames, and the finest flow feeds no loss, so its
    # cost volume's backward is not launched (4 launches of each half a
    # step, not 5)
    corr_ls1 = {"corr_fwd": 5, "corr_bwd_df1": 4, "corr_bwd_df2": 4}
    ratios = []
    for name, path, overrides, per_step in (
        ("geom +triangle,pnp,eight_point,depth_consis", "geom_all",
         {**GEO_LOSSES, "w_8point": 0.001}, geom_k),
        ("geom loss_base_scale=1", "geom_ls1", {"loss_base_scale": 1},
         {**geom_k, **corr_ls1, **pad_ls1}),
    ):
        run = _start(name, overrides)
        ms, _ = drive(run, per_step, 3, 5, path)
        _metric_line(f"frames/sec {name} fwd-bwd (b8 256x832 bf16, PyTorch port)", ms, smi)
        ratios.append(f"{name} {ms_g / ms:.3f}x")
        del run
        torch.cuda.empty_cache()
    # encoder_int8 (BENCH_INT8=1): every encoder conv in int8 on torch._int_mm
    # (20 a step, all in the forward: the straight-through backward is the
    # float conv's); the im2col GEMMs do the convs' multiply-adds, so the
    # FLOP count is the default's (the card pads the stem's K: not counted)
    from unsupervised_depth_opticalflow_egomotion_torch.ops import int8_conv as ti8

    run = _start_bench("geom encoder_int8", Settings(encoder_int8=True))
    mm_before = ti8.INT_MM.launches
    ms, _ = bench_drive(run, geom_k, 10, True, "geom_int8")
    steps = by_path["geom_int8"][1]
    if ti8.INT_MM.launches - mm_before != 20 * steps:
        fail(f"geom encoder_int8: {ti8.INT_MM.launches - mm_before} int8 GEMMs in {steps} "
             "body runs, expected 20 a step")
    if lines["geom_int8"]["flops_per_step"] != lines["geom"]["flops_per_step"]:
        fail(f"geom encoder_int8: flops_per_step {lines['geom_int8']['flops_per_step']}, the "
             f"default's {lines['geom']['flops_per_step']}")
    ratios.append(f"geom encoder_int8 {ms_g / ms:.3f}x")
    _int8_accumulators(run)
    del run
    torch.cuda.empty_cache()
    log(f"frames/s against the default geom step's {8 / ms_g * 1e3:.2f} in this call: "
        + ", ".join(ratios))
    for name, path, overrides, per_step in (
        ("flow splat_nn", None, {"mode": "flow"}, {"warp_gather": 4, **corr, **ssim}),
        ("flow splat loss_base_scale=1", "flow_ls1",
         {"mode": "flow", "flow_occ_impl": "splat", "loss_base_scale": 1},
         {"warp_gather": 3, **corr_ls1, **ssim, "splat_mass": 6}),
        ("depth loss_base_scale=1", "depth_ls1", {"mode": "depth", "loss_base_scale": 1},
         {"warp_gather": 6, **pad_ls1}),
        ("geom warp_impl=pallas pwc_corr=pallas", "geom_regather",
         {"warp_impl": "pallas", "pwc_corr": "pallas"},
         {"warp_gather_nograd": 6, "warp_gather_bwd": 6, "corr_fwd": 5, **ssim, **pad}),
    ):
        run = _start(name, overrides)
        drive(run, per_step, 2, 0, path)
        del run
        torch.cuda.empty_cache()

    def profiles():
        dev_g, n_g = _profile(geom["name"], geom["step"], geom["batch"], ms_g, verbose=True)
        dev_x, n_x = _profile(xla["name"], xla["step"], xla["batch"], ms_x, verbose=False)
        _profile(flow["name"], flow["step"], flow["batch"], ms_f, verbose=True)
        _profile(depth["name"], depth["step"], depth["batch"], ms_d, verbose=True)
        log(f"geom step, ssim_impl=pallas vs xla in this call: {ms_g:.1f} vs {ms_x:.1f} ms/step "
            f"(20 and 10 timed steps), then {ms_g2:.1f} vs {ms_x2:.1f} (10 and 5, in the other "
            f"order); {n_g} vs {n_x} kernel launches/step, device time {dev_g:.1f} vs "
            f"{dev_x:.1f} ms/step, peak memory {gb_g:.2f} vs {gb_x:.2f} GiB")

    return by_path, lines, ms_g, profiles


def _int8_accumulators(run) -> None:
    """The card's int8 convolutions in one forward of ``run``'s model, at the
    step's shapes (3B = 24 frames), against the exact int64 version on the
    CPU, on the first frame of each input: the int32 accumulators must be
    equal."""
    import torch

    from unsupervised_depth_opticalflow_egomotion_torch.ops import int8_conv as ti8

    seen = []
    card = ti8.conv_i32

    def record(xq, wq, stride, padding):
        acc = card(xq, wq, stride, padding)
        seen.append((xq, wq, stride, padding, acc))
        return acc

    ti8.conv_i32 = record
    try:
        with torch.no_grad():
            run["model"].forward_geom(*run["batch"])
    finally:
        ti8.conv_i32 = card
    t0 = time.perf_counter()
    bad = [f"{tuple(xq.shape)} k{tuple(wq.shape)} s{st}" for xq, wq, st, pad, acc in seen
           if not torch.equal(acc[:1].cpu(), ti8.conv_i32_plain(xq[:1].cpu(), wq.cpu(), st, pad))]
    if len(seen) != 20 or bad:
        fail(f"geom encoder_int8: {len(seen)} int8 convs in a forward (expected 20); the card's "
             f"int32 accumulators differ from the int64 version's at {bad}")
    log(f"geom encoder_int8: the card's int32 accumulators of all 20 convs of a forward equal "
        f"the exact int64 version's on the first of their 24 frames "
        f"({time.perf_counter() - t0:.1f} s on the CPU)")


CLI_STACKS = 16  # synthetic prepared dataset of the CLI phase


def _write_png(path: str, rgb) -> None:
    """An 8-bit RGB PNG (filter type 0) written with the standard library."""
    import struct
    import zlib

    import numpy as np

    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + chunk(b"IEND", b""))


def _prepared_dataset(root: str, h: int, w: int) -> None:
    """CLI_STACKS stacks [3h, w, 3] of a smooth random texture that moves a
    few pixels from frame to frame, a calib file and train.txt: the layout
    of a prepared KITTI dataset."""
    import numpy as np

    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    rng = np.random.RandomState(0)
    m = 8
    yy, xx = np.mgrid[0:h + 2 * m, 0:w + 2 * m].astype(np.float32)
    lines = []
    for i in range(CLI_STACKS):
        tex = np.zeros((h + 2 * m, w + 2 * m, 3), np.float32)
        for c in range(3):
            for _ in range(4):
                fy, fx = rng.uniform(0.01, 0.12, 2)
                tex[..., c] += np.sin(fy * yy + fx * xx + rng.uniform(0, 6.3))
        tex = (tex - tex.min()) / (tex.max() - tex.min()) * 255.0
        dy, dx = rng.randint(-3, 4, 2)
        frames = [tex[m + k * dy:m + k * dy + h, m + k * dx:m + k * dx + w] for k in (-1, 0, 1)]
        _write_png(os.path.join(root, "d", f"{i:06d}.png"),
                   np.concatenate(frames, 0).astype(np.uint8))
        lines.append(f"d/{i:06d}.png calib.txt\n")
    with open(os.path.join(root, "calib.txt"), "w") as f:
        f.write(f"P_rect_02: 241.0 0.0 {w / 2} 0.0 0.0 245.0 {h / 2} 0.0 0.0 0.0 1.0 0.0\n")
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.writelines(lines)


def _image_decoding() -> tuple[str, str]:
    """Which of three cases the machine is in for decoding the stacks: (a)
    the native loader builds (g++ with the libpng and libjpeg headers), (b)
    only cv2 is there (the Python loader), (c) neither."""
    import importlib.util
    import shutil

    from unsupervised_depth_opticalflow_egomotion_torch.data import native_loader

    facts = (f"cv2 {'present' if importlib.util.find_spec('cv2') else 'absent'}, "
             f"png.h {'present' if os.path.exists('/usr/include/png.h') else 'absent'}, "
             f"jpeglib.h {'present' if os.path.exists('/usr/include/jpeglib.h') else 'absent'}, "
             f"g++ {'present' if shutil.which('g++') else 'absent'}")
    if native_loader.load_lib() is not None:
        return "a", facts
    return ("b" if importlib.util.find_spec("cv2") else "c"), facts


def phase_cli(smi: str, geom_ms: float, root: str) -> float:
    """The port's training entry point at b8 256x832 bf16 on PNGs on disk:
    flow 3 steps through the occlusion switch (the splat kernel launches),
    depth 2 steps from the flow stage in a subprocess (``python3 -m
    ...train``), geom 8 steps grafted from both, and a resume of geom to 10
    steps that dumps the masks. Checks the graft (parameters from the
    donors, BatchNorm statistics fresh), the restored tensors against the
    saved ones, finite logged losses, checkpoints and dumps, and that every
    in-process launch had a signature phase 3 held. Prints the loader that
    ran, the CLI's steady geom frames/s beside phase 5's, and the loader's
    samples/s alone. Returns the CLI's steady geom frames/s."""
    import pickle

    import torch

    from unsupervised_depth_opticalflow_egomotion_torch import train as cli
    from unsupervised_depth_opticalflow_egomotion_torch.config import load_config
    from unsupervised_depth_opticalflow_egomotion_torch.data import KittiPreparedDataset, make_loader
    from unsupervised_depth_opticalflow_egomotion_torch.parallel import init_state
    from unsupervised_depth_opticalflow_egomotion_torch.utils import CheckpointManager, MetricLogger

    t_start = time.perf_counter()
    b, h, w = 8, 256, 832
    data = os.path.join(root, "prepared")
    _prepared_dataset(data, h, w)
    log(f"cli: {CLI_STACKS} stacks written in {time.perf_counter() - t_start:.1f} s")
    yaml_path = os.path.join(root, "cli.yaml")
    with open(yaml_path, "w") as f:
        f.write(f"img_hw: [{h}, {w}]\nbatch_size: {b}\ntest_interval: 0\nlog_interval: 2\n"
                f"save_interval: 4\nprepared_base_dir: {data}\n")
    case, facts = _image_decoding()
    if case == "c":
        fail(f"cli: no image decoder for the loader ({facts})")
    dirs = {n: os.path.join(root, n) for n in ("flow", "depth", "geom")}
    ckpts = {n: os.path.join(d, "ckpt") for n, d in dirs.items()}
    kernels = {n: k for n, (k, _) in path_kernels().items()}
    log_times: dict[int, float] = {}

    def finite_log(model_dir):
        with open(os.path.join(model_dir, "log.pkl"), "rb") as f:
            hist = pickle.load(f)
        bad = {k: v for k, vals in hist.items() for _, v in vals if not math.isfinite(v)}
        if not hist or bad:
            fail(f"cli: {model_dir}: no logged losses or non-finite ones: {bad}")

    def run(name, **overrides):
        """One in-process CLI run; launch counts zeroed before, read after."""
        t0 = time.perf_counter()
        cfg = load_config(yaml_path, **overrides)
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
            k.seen.clear()
        model, opt, step = cli.train(cfg)
        torch.cuda.synchronize()
        launches = {n: k.launches for n, k in kernels.items()}
        unchecked = {n: sorted(k.seen - CHECKED[n]) for n, k in kernels.items() if k.seen - CHECKED[n]}
        if unchecked:
            fail(f"cli {name}: launches with signatures that the kernels phase did not hold "
                 f"against the plain version: {unchecked}")
        finite_log(cfg.model_dir)
        if CheckpointManager(os.path.join(cfg.model_dir, "ckpt")).latest_step() != step:
            fail(f"cli {name}: no checkpoint of step {step}")
        log(f"cli {name}: {step} steps in {time.perf_counter() - t0:.1f} s, launches "
            f"{json.dumps({n: v for n, v in launches.items() if v})}")
        return cfg, model, opt, step, launches

    # flow, through the occlusion switch at step 2 (>=): one splat step
    _, model, _, _, launches = run("flow", mode="flow", model_dir=dirs["flow"], num_iterations=3,
                                   flow_occ_switch_step=2)
    if launches["splat_mass"] != 8 or model.cfg.flow_occ_impl != "splat":
        fail(f"cli flow: the occlusion switch ran {launches['splat_mass']} splats, expected 8")
    del model
    # depth, grafted from the flow stage, through the module entry point
    cmd = [sys.executable, "-m", "unsupervised_depth_opticalflow_egomotion_torch.train",
           "-c", yaml_path, "--mode", "depth", "--model_dir", dirs["depth"],
           "--num_iterations", "2", "--flow_pretrained_model", ckpts["flow"]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    with open(os.path.join(OUT_DIR, "cli_depth_subprocess.txt"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0 or "training done" not in proc.stdout:
        fail(f"cli depth: python3 -m ...train exited {proc.returncode}: {proc.stderr[-2000:]}")
    finite_log(dirs["depth"])
    if CheckpointManager(ckpts["depth"]).latest_step() != 2:
        fail("cli depth: no checkpoint of step 2")
    log(f"cli depth: python3 -m unsupervised_depth_opticalflow_egomotion_torch.train exited 0 "
        f"in {time.perf_counter() - t0:.1f} s ({' '.join(cmd[3:])})")

    # the graft of geom's staged init: every parameter from the depth stage
    # (its flow networks from the flow stage), every BatchNorm buffer fresh
    geom_cfg = load_config(yaml_path, mode="geom", model_dir=dirs["geom"], num_iterations=8,
                           flow_pretrained_model=ckpts["flow"],
                           depth_pretrained_model=ckpts["depth"])
    flow_sd = CheckpointManager(ckpts["flow"]).restore_params()
    depth_sd = CheckpointManager(ckpts["depth"]).restore_params()
    model, _ = init_state(geom_cfg)
    fresh = {k: v.cpu().clone() for k, v in model.named_buffers()}
    cli.stage_init(model, geom_cfg)
    wrong = [k for k, p in model.named_parameters() if not torch.equal(p.cpu(), depth_sd[k])
             or (k.startswith(("fpyramid.", "pwc_model.")) and not torch.equal(depth_sd[k], flow_sd[k]))]
    moved = [k for k in fresh if not torch.equal(depth_sd[k], fresh[k])]
    grafted_bufs = [k for k, v in model.named_buffers() if not torch.equal(v.cpu(), fresh[k])]
    if wrong or not moved or grafted_bufs:
        fail(f"cli graft: parameters unlike the donors' {wrong[:5]}, BatchNorm buffers taken "
             f"{grafted_bufs[:5]} (of {len(moved)} the depth stage moved)")
    del model

    # geom, timed between the log steps, whose metrics' host copy syncs
    original = MetricLogger.add_scalars

    def timed(self, step, scalars):
        log_times[step] = time.perf_counter()
        original(self, step, scalars)

    MetricLogger.add_scalars = timed
    try:
        _, model, _, step, launches = run(
            "geom", mode="geom", model_dir=dirs["geom"], num_iterations=8,
            flow_pretrained_model=ckpts["flow"], depth_pretrained_model=ckpts["depth"])
    finally:
        MetricLogger.add_scalars = original
    per_step = {"warp_gather": 6, "corr_fwd": 5, "corr_bwd_df1": 5, "corr_bwd_df2": 5,
                "ssim_fwd": 6, "ssim_bwd": 6, "reflect_pad_fwd": 13, "reflect_pad_bwd": 13}
    # 8 steps: two op by op, the graph's capture, five replays
    want = {n: per_step.get(n, 0) * 3 for n in kernels}
    if launches != want:
        fail(f"cli geom: kernel launches {launches}, expected {want}")
    # steps 3-4 and 7-8: the windows without a checkpoint save (at 4 and 8,
    # each after its step's log)
    window = (log_times[4] - log_times[2]) + (log_times[8] - log_times[6])
    cli_fps = 4 * b / window
    del model

    # resume: the restored tensors equal the saved ones; then to step 10,
    # logging every step, so that step 10 dumps the masks
    mgr = CheckpointManager(ckpts["geom"])
    saved = mgr.load(8)
    model, opt = init_state(geom_cfg)
    if mgr.restore(model, opt, 8, expect_opt_layout="adam:all") != 8:
        fail("cli resume: restored another step than 8")
    got_opt = opt.state_dict()["state"]
    bad = [k for k, v in model.state_dict().items() if not torch.equal(v.cpu(), saved["model"][k])]
    bad += [f"adam {i}.{k}" for i, st in saved["optimizer"]["state"].items()
            for k, v in st.items() if not torch.equal(got_opt[i][k].cpu(), v)]
    if bad or {int(st["step"]) for st in got_opt.values()} != {8}:
        fail(f"cli resume: restored tensors unlike the saved ones: {bad[:5]}")
    del model, opt
    _, model, opt, step, _ = run("geom resume", mode="geom", model_dir=dirs["geom"],
                                 num_iterations=10, resume=True, log_interval=1)
    adam_steps = {int(st["step"]) for st in opt.state_dict()["state"].values()}
    dump = os.path.join(dirs["geom"], "images", "step_00000010")
    n_png = len([n for n in os.listdir(dump) if n.endswith(".png")]) if os.path.isdir(dump) else 0
    if step != 10 or adam_steps != {10} or n_png != 10 or not model.training:
        fail(f"cli resume: step {step}, Adam steps {adam_steps}, {n_png} mask images")
    del model, opt

    # the loader alone, as the CLI builds it (decode cache warm after the
    # first pass over the stacks)
    cfg = load_config(yaml_path)
    ds = KittiPreparedDataset(data, num_scales=cfg.num_scales, img_hw=(h, w),
                              num_iterations=48 * b, seed=cfg.seed,
                              cache_decoded_bytes=cfg.decode_cache_bytes, uint8_images=True)
    loader = make_loader(ds, b, impl=cfg.loader_impl, shuffle=True,
                         num_workers=cfg.num_workers, seed=cfg.seed)
    if case == "a" and type(loader).__name__ != "NativeBatchLoader":
        fail("cli: the native loader builds here but the CLI did not take it")
    batches = iter(loader)
    for _ in range(2 * CLI_STACKS // b):
        next(batches)
    t0 = time.perf_counter()
    n = sum(x[0].shape[0] for x in batches)
    loader_sps = n / (time.perf_counter() - t0)

    log(f"cli: image decoding here: {facts}: case ({case}); input pipeline "
        f"{type(loader).__name__} ({cfg.num_workers} workers)")
    log(f"cli: geom steady {cli_fps:.2f} frames/s through the entry point (steps 3-4 and 7-8, "
        f"from PNGs on disk) against phase 5's {b / geom_ms * 1e3:.2f} frames/s on one "
        f"device-resident batch, in this call | nvidia-smi: {smi}")
    log(f"cli: loader alone {loader_sps:.1f} samples/s ({n} samples, b{b} {h}x{w} uint8) "
        f"| nvidia-smi: {smi}")
    log(f"cli: phase {time.perf_counter() - t_start:.1f} s")
    return cli_fps


EVAL_HW = (375, 1242)  # KITTI's frame size
EVAL_DISTINCT = 8  # distinct frames of each kind; the others are hard links to them
EIGEN_FRAMES = 64
ODOM_FRAMES = 34  # 32 snippets: four batches of 8
SUBSET = 16  # flow pairs, eigen frames and pose snippets held card against CPU
# card (kernels, TF32 off) against CPU (plain versions), f32, the same
# checkpoint and inputs (PERF.md section 2): per-sample outputs to an
# absolute tolerance; the metrics to a relative one; the Fl rates may differ
# only by pixels whose EPE lies, on the CPU, within the two devices' flow
# difference of the 3 px / 5 % threshold
EVAL_TOL = {"flow": 1e-3, "disp": 1e-4, "pose": 1e-5, "metric": 1e-3, "pose_metric": 1e-2}


def _link(src: str, dst: str) -> None:
    try:
        os.link(src, dst)
    except OSError:
        import shutil

        shutil.copyfile(src, dst)


def _smooth(rng, h, w, cells=32):
    """A smooth random field [h, w] in about [-1, 1]."""
    import cv2
    import numpy as np

    coarse = rng.uniform(-1, 1, (h // cells + 2, w // cells + 2)).astype(np.float32)
    return cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC)


def _frame(rng, h, w):
    import numpy as np

    rgb = np.stack([_smooth(rng, h, w, 24) + 0.3 * _smooth(rng, h, w, 6) for _ in range(3)], -1)
    return (255 * (rgb - rgb.min()) / (rgb.max() - rgb.min())).astype(np.uint8)


def _eval_trees(root: str) -> dict:
    """Synthetic trees in KITTI's layouts at 375x1242, from seed 0:
    flow 2015 (200 pairs with flow_occ, flow_noc, obj_map), flow 2012 (194
    pairs), the raw eigen layout with its test list and gt_depths.npz
    (EIGEN_FRAMES frames; sparse depths in (1, 80) m), odometry sequence 09
    (ODOM_FRAMES frames, 4 m a frame while turning slowly) with
    poses/09.txt, and the subsets held card against CPU (the first 16 eigen
    frames; an 18-frame sequence of 16 snippets). EVAL_DISTINCT frames of
    each kind are distinct; the others are hard links to them."""
    import cv2
    import numpy as np

    from unsupervised_depth_opticalflow_egomotion_torch.evaluation import write_flow_png

    rng = np.random.RandomState(0)
    h, w = EVAL_HW
    t = {k: os.path.join(root, k) for k in ("kitti2015", "kitti2012", "raw", "odom", "odom16")}
    for sub in ("image_2", "flow_occ", "flow_noc", "obj_map"):
        os.makedirs(os.path.join(t["kitti2015"], sub))
    os.makedirs(os.path.join(t["kitti2012"], "image_2"))
    for sub in ("flow_occ", "flow_noc"):
        os.makedirs(os.path.join(t["kitti2012"], sub))
    files = lambda i: [os.path.join(s, f"{i:06d}_{k}.png") for s, k in (  # noqa: E731
        ("image_2", 10), ("image_2", 11), ("flow_occ", 10), ("flow_noc", 10), ("obj_map", 10))]
    rows = np.arange(h)[:, None]
    for i in range(EVAL_DISTINCT):
        f = [os.path.join(t["kitti2015"], p) for p in files(i)]
        tex = _frame(rng, h + 16, w + 16)
        dy, dx = rng.randint(-6, 7, 2)
        cv2.imwrite(f[0], tex[8:8 + h, 8:8 + w])
        cv2.imwrite(f[1], tex[8 + dy:8 + dy + h, 8 + dx:8 + dx + w])
        u, v = 20.0 * _smooth(rng, h, w) - dx, 8.0 * _smooth(rng, h, w) - dy
        valid = ((rows > h // 3) & (rng.rand(h, w) > 0.2)).astype(np.float64)
        noc = valid * (np.abs(_smooth(rng, h, w)) < 0.8)
        write_flow_png(f[2], u, v, valid)
        write_flow_png(f[3], u, v, noc)
        obj = np.zeros((h, w), np.uint16)
        y0, x0 = rng.randint(h // 3, h - 80), rng.randint(0, w - 200)
        obj[y0:y0 + 80, x0:x0 + 200] = 1 + i % 3
        cv2.imwrite(f[4], obj)
    for i in range(EVAL_DISTINCT, 200):
        for a, b in zip(files(i % EVAL_DISTINCT), files(i)):
            _link(os.path.join(t["kitti2015"], a), os.path.join(t["kitti2015"], b))
    for i in range(194):
        for a, b in zip(files(i % EVAL_DISTINCT)[:4], files(i)[:4]):
            _link(os.path.join(t["kitti2015"], a), os.path.join(t["kitti2012"], b))

    drive = "2011_09_26/2011_09_26_drive_0001_sync"
    data = os.path.join(t["raw"], drive, "image_02", "data")
    os.makedirs(data)
    depths = []
    for i in range(EVAL_DISTINCT):
        cv2.imwrite(os.path.join(data, f"{i:010d}.png"), _frame(rng, h, w))
        sparse = (rows > h // 3) & (rng.rand(h, w) < 0.05)
        depths.append((rng.uniform(1.0, 80.0, (h, w)) * sparse).astype(np.float32))
    for i in range(EVAL_DISTINCT, EIGEN_FRAMES):
        _link(os.path.join(data, f"{i % EVAL_DISTINCT:010d}.png"), os.path.join(data, f"{i:010d}.png"))
    lines = [f"{drive} {i:010d} l\n" for i in range(EIGEN_FRAMES)]
    t["eigen_txt"], t["eigen16_txt"] = (os.path.join(root, n) for n in ("eigen.txt", "eigen16.txt"))
    for path, n in ((t["eigen_txt"], EIGEN_FRAMES), (t["eigen16_txt"], SUBSET)):
        with open(path, "w") as f:
            f.writelines(lines[:n])
    gt = np.empty(EIGEN_FRAMES, dtype=object)
    gt[:] = [depths[i % EVAL_DISTINCT] for i in range(EIGEN_FRAMES)]  # pickled once each
    t["eigen_npz"] = os.path.join(root, "gt_depths.npz")
    np.savez(t["eigen_npz"], data=gt)

    poses = []
    for i in range(ODOM_FRAMES):
        a = 0.01 * i
        poses.append(np.array([[np.cos(a), 0, np.sin(a), 20 * (1 - np.cos(a))],
                               [0, 1, 0, 0.05 * i], [-np.sin(a), 0, np.cos(a), 4.0 * i]]))
    for key, n in (("odom", ODOM_FRAMES), ("odom16", SUBSET + 2)):
        seq = os.path.join(t[key], "sequences", "09", "image_2")
        os.makedirs(seq)
        os.makedirs(os.path.join(t[key], "poses"))
        for i in range(n):
            src = os.path.join(t["odom"], "sequences", "09", "image_2", f"{i % EVAL_DISTINCT:06d}.png")
            if key == "odom" and i < EVAL_DISTINCT:
                cv2.imwrite(src, _frame(rng, h, w))
            else:
                _link(src, os.path.join(seq, f"{i:06d}.png"))
        with open(os.path.join(t[key], "poses", "09.txt"), "w") as f:
            f.write("".join(" ".join(f"{x:.9e}" for x in p.reshape(-1)) + "\n" for p in poses[:n]))
    t["demo"] = os.path.join(t["kitti2015"], "image_2", "000003_10.png")
    return t


def _fl_outliers(gt, pred, img_hw):
    """eval_flow_avg's resize of ``pred`` to the GT, its EPE map and the Fl
    outlier map (EPE > 3 px and > 5 % of |gt|) over the valid pixels."""
    import cv2
    import numpy as np

    H, W = gt.shape[:2]
    p = np.copy(pred)
    p[:, :, 0] = p[:, :, 0] / img_hw[1] * W
    p[:, :, 1] = p[:, :, 1] / img_hw[0] * H
    flo = cv2.resize(p, (W, H), interpolation=cv2.INTER_LINEAR)
    epe = np.sqrt(np.sum(np.square(flo - gt[:, :, :2]), axis=2))
    mag = np.maximum(np.sqrt(np.sum(np.square(gt[:, :, :2]), axis=2)), 1e-10)
    valid = gt[:, :, 2] > 0
    return flo, epe, mag, valid & (epe > 3) & (epe / mag > 0.05)


def _recording(fn, outputs: list):
    def call(*args):
        out = fn(*args)
        outputs.append(out)
        return out
    return call


def _tf32_fns(model):
    """The inference methods on the card with TF32 allowed (what PyTorch does
    for cuDNN's f32 convolutions by default): the measurement of what the
    eval's full_precision() changes."""
    import numpy as np
    import torch

    def run(method, *arrays):
        prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            with torch.inference_mode():
                args = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda() for a in arrays]
                return method(*args).cpu().numpy()
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev

    return (lambda a, b: run(model.inference_flow, a, b), lambda x: run(model.infer_disp, x),
            lambda x: run(model.infer_pose, x))


EVAL_TASKS = {  # the eval CLI's tasks of phase 7: extra flags, what the output must show
    "kitti_flow_2015": (["--write_submission"], "[EVAL] [kitti_2015]"),
    "kitti_flow_2012": ([], "[EVAL] [kitti_2012]"),
    "kitti_depth": ([], "abs_rel="),
    "kitti_pose": (["--export_trajectory"], "Sequence: 09"),
    "demo": ([], "Depth prediction saved in"),
}


def _timed_calls(wrapped: list, kernels: dict):
    """Replace each (module, name) of ``wrapped`` by a call that records
    its result, its seconds (the card idle before and after) and the
    kernel launches it made; returns (results, seconds, launches) by name
    and a function that puts the originals back."""
    import torch

    originals = {n: getattr(m, n) for m, n in wrapped}
    results, spans, launches = {}, {}, {}

    def timed(name):
        def call(*args, **kw):
            torch.cuda.synchronize()
            before = {n: k.launches for n, k in kernels.items()}
            t1 = time.perf_counter()
            results[name] = originals[name](*args, **kw)
            torch.cuda.synchronize()
            spans[name] = time.perf_counter() - t1
            launches[name] = {n: k.launches - before[n] for n, k in kernels.items()}
            return results[name]
        return call

    for m, n in wrapped:
        setattr(m, n, timed(n))

    def restore():
        for m, n in wrapped:
            setattr(m, n, originals[n])

    return (results, spans, launches), restore


def _eval_cli_worker(out_json: str, *argv) -> None:
    """Phase 7's eval CLI for kitti_flow_2015, the process that ``python3
    chip_smoke.py eval_cli_2015 <json> <CLI args>`` starts: ``test.main``
    (what ``python3 -m ...test`` runs) with the flow task timed where the
    CLI calls it (end to end: PNG decode, inference, metrics, the
    submission PNGs) and the kernels' launches and signatures counted;
    those go to ``out_json``."""
    from unsupervised_depth_opticalflow_egomotion_torch import eval_tasks
    from unsupervised_depth_opticalflow_egomotion_torch import test as eval_cli

    kernels = {n: k for n, (k, _) in path_kernels().items()}
    for k in kernels.values():
        k.launches = 0
        k.seen.clear()
    (_, spans, launches), restore = _timed_calls([(eval_tasks, "test_kitti_flow")], kernels)
    try:
        eval_cli.main(list(argv))
    finally:
        restore()
    with open(out_json, "w") as f:
        json.dump({"seconds": spans["test_kitti_flow"], "launches": launches["test_kitti_flow"],
                   "all_launches": {n: k.launches for n, k in kernels.items()},
                   "seen": {n: sorted(k.seen) for n, k in kernels.items()}}, f)


def _gt_subset(gt_dir: str) -> tuple:
    """The first SUBSET items of KITTI 2015's GT as the eval's loaders read
    them (``load_gt_flow_kitti``'s and ``load_gt_mask``'s per-item readers):
    flows, non-occluded masks, binary moving masks."""
    import numpy as np

    from unsupervised_depth_opticalflow_egomotion_torch.evaluation.flow_metrics import (
        _read_flow_gt_worker,
    )
    from unsupervised_depth_opticalflow_egomotion_torch.evaluation.mask_metrics import (
        _read_mask_gt_worker,
    )

    flows, nocs = zip(*(_read_flow_gt_worker(gt_dir, i) for i in range(SUBSET)))
    moving = [(_read_mask_gt_worker(gt_dir, i) > 0).astype(np.float64) for i in range(SUBSET)]
    return list(flows), list(nocs), moving


def _eval_training_cli(root: str, dirs: dict, kernels: dict) -> dict:
    """One geom run of the training CLI, 2 steps with test_interval 1 and
    the eigen split and odometry named for its interleaved eval (the KITTI
    flow sets are the eval CLI's: the CLI reads no flow GT here): log.pkl
    must hold one finite record of each eval at step 1 and finite losses,
    and the launches must be the two steps'. Each task of the eval is timed
    where the CLI calls it (end to end: PNG decode, inference, metrics).
    Returns the tasks' seconds."""
    import pickle

    import numpy as np

    from unsupervised_depth_opticalflow_egomotion_torch import eval_tasks
    from unsupervised_depth_opticalflow_egomotion_torch import train as cli
    from unsupervised_depth_opticalflow_egomotion_torch.config import load_config

    t0 = time.perf_counter()
    for k in kernels.values():
        k.launches = 0
    eval_tasks._EIGEN_DECODE_CACHE.clear()
    cfg = load_config(os.path.join(root, "cli.yaml"), mode="geom", num_iterations=2,
                      test_interval=1, model_dir=os.path.join(root, "geom_eval"), **dirs)
    (_, spans, _), restore = _timed_calls(
        [(cli, "run_interleaved_eval"), (eval_tasks, "test_eigen_depth"),
         (eval_tasks, "test_pose_odom")], kernels)
    try:
        cli.train(cfg)
    finally:
        restore()
    with open(os.path.join(cfg.model_dir, "log.pkl"), "rb") as f:
        hist = pickle.load(f)
    evals = {k: v for k, v in hist.items() if k.startswith("eval/")}
    names = ["eval/eigen_depth", "eval/pose_odom"]
    values = [np.asarray(list(v[0][1].values()) if isinstance(v[0][1], dict) else v[0][1],
                         np.float64) for v in evals.values()]
    if sorted(evals) != sorted(names) or any(len(v) != 1 or v[0][0] != 1 for v in evals.values()) \
            or not all(np.isfinite(v).all() for v in values):
        fail(f"eval: the training CLI's log.pkl holds the eval records {evals}, expected one "
             f"finite record at step 1 of each of {names}")
    losses = [x for k, v in hist.items() if not k.startswith("eval/") for _, x in v]
    if not losses or not all(math.isfinite(x) for x in losses):
        fail(f"eval: the training CLI's losses are missing or not finite: {losses}")
    per_step = {"warp_gather": 6, "corr_fwd": 5, "corr_bwd_df1": 5, "corr_bwd_df2": 5,
                "ssim_fwd": 6, "ssim_bwd": 6, "reflect_pad_fwd": 13, "reflect_pad_bwd": 13}
    want = {n: 2 * per_step.get(n, 0) for n in kernels}
    # the eigen eval: the depth decoder's 13 pads on each batch of 8 frames
    want["reflect_pad_fwd"] += 13 * EIGEN_FRAMES // 8
    got = {n: k.launches for n, k in kernels.items()}
    if got != want:
        fail(f"eval: the training CLI with interleaved eval launched {got}, expected {want}")
    log(f"eval: training CLI, geom 2 steps with test_interval 1 and the eval data sets eigen "
        f"and odometry: {time.perf_counter() - t0:.1f} s (the eval "
        f"{spans['run_interleaved_eval']:.1f} s); log.pkl records "
        + "; ".join(f"{k} {np.round(v, 4).tolist()}" for k, v in zip(evals, values)))
    return spans


def _eval_card_vs_cpu(cfg, t: dict, sd: dict, gt: tuple):
    """The card's inference (kernels, TF32 off) against the CPU's (plain
    versions) on SUBSET flow pairs, eigen frames and pose snippets through
    the eval's entry points, and the card with TF32 allowed. Returns the
    card's model and inference closures."""
    import numpy as np

    from unsupervised_depth_opticalflow_egomotion_torch import eval_tasks
    from unsupervised_depth_opticalflow_egomotion_torch.data import KittiFlowEval
    from unsupervised_depth_opticalflow_egomotion_torch.evaluation import eval_flow_avg
    from unsupervised_depth_opticalflow_egomotion_torch.parallel import build_model

    t0 = time.perf_counter()
    models, fns = {}, {}
    for dev in ("cpu", "cuda"):
        models[dev] = build_model(cfg, dev)
        models[dev].load_state_dict(sd)
        fns[dev] = eval_tasks.make_inference_fns(models[dev], dev)
    fns["tf32"] = _tf32_fns(models["cuda"])
    ds = KittiFlowEval(t["kitti2015"], "kitti_2015", cfg.img_hw)
    pairs = np.stack([ds[i][0] for i in range(SUBSET)])
    h = pairs.shape[1] // 2
    gt_flows, noc, moving = (x[:SUBSET] for x in gt)
    cfg16 = cfg.replace(eigen_test_files_txt=t["eigen16_txt"], kitti_odom_dir=t["odom16"])
    res = {}
    for dev, (flow_fn, disp_fn, pose_fn) in fns.items():
        flows = np.concatenate([flow_fn(pairs[i:i + 8, :h], pairs[i:i + 8, h:])
                                for i in range(0, SUBSET, 8)])
        disps, poses = [], []
        depth = eval_tasks.test_eigen_depth(cfg16, _recording(disp_fn, disps))
        pose = eval_tasks.test_pose_odom(cfg16, _recording(pose_fn, poses))
        res[dev] = dict(flows=flows, disps=np.concatenate(disps), poses=np.concatenate(poses),
                        flow=eval_flow_avg(gt_flows, noc, list(flows), cfg.img_hw, moving),
                        depth=depth, pose=pose)
    c, g = res["cpu"], res["cuda"]
    errs = {k: float(np.abs(g[k] - c[k]).max()) for k in ("flows", "disps", "poses")}
    rel = lambda a, b: float(np.max(np.abs(np.asarray(a) - np.asarray(b))  # noqa: E731
                                    / np.maximum(np.abs(np.asarray(b)), 1e-12)))
    epe_keys = [k for k in c["flow"] if k.startswith("epe")]
    fl_keys = [k for k in c["flow"] if k.startswith("fl")]
    m_err = {"epe": rel([g["flow"][k] for k in epe_keys], [c["flow"][k] for k in epe_keys]),
             "depth": rel(g["depth"][:4], c["depth"][:4]),
             "ate_re": rel(np.concatenate(g["pose"]), np.concatenate(c["pose"]))}
    # Fl: every pixel whose outlier status differs sits at the threshold
    flips = stray = 0
    for i in range(SUBSET):
        flo_c, epe_c, mag, out_c = _fl_outliers(gt_flows[i], c["flows"][i], cfg.img_hw)
        flo_g, _, _, out_g = _fl_outliers(gt_flows[i], g["flows"][i], cfg.img_hw)
        d = np.sqrt(np.sum(np.square(flo_g - flo_c), axis=2)) + 1e-6
        near = (np.abs(epe_c - 3) <= d) | (np.abs(epe_c - 0.05 * mag) <= d)
        flips += int((out_c != out_g).sum())
        stray += int(((out_c != out_g) & ~near).sum())
    fl_diff = max(abs(g["flow"][k] - c["flow"][k]) for k in fl_keys)
    tf = res["tf32"]
    log(f"eval card vs cpu (f32, TF32 off, {SUBSET} flow pairs, eigen frames and pose snippets at "
        f"{cfg.img_hw[0]}x{cfg.img_hw[1]}): max |diff| flow {errs['flows']:.3g} px (tol "
        f"{EVAL_TOL['flow']}), disparity {errs['disps']:.3g} (tol {EVAL_TOL['disp']}), pose "
        f"vector {errs['poses']:.3g} (tol {EVAL_TOL['pose']}); relative: EPEs {m_err['epe']:.3g}, "
        f"AbsRel..RMSlog {m_err['depth']:.3g} (tol {EVAL_TOL['metric']}), ATE/RE mean and std "
        f"{m_err['ate_re']:.3g} (tol {EVAL_TOL['pose_metric']}); Fl rates differ by at most "
        f"{fl_diff:.3g}: {flips} pixels flipped, {stray} of them away from the threshold; "
        f"card epe {g['flow']['epe']:.6f} fl {g['flow']['fl']:.6f} abs_rel {g['depth'][0]:.6f} "
        f"ate {g['pose'][0][0]:.6f} ({time.perf_counter() - t0:.1f} s)")
    log(f"eval TF32 on vs off on the card ({SUBSET}-sample subsets): epe {tf['flow']['epe']:.6f} vs "
        f"{g['flow']['epe']:.6f} ({rel(tf['flow']['epe'], g['flow']['epe']):.3g} relative), "
        f"abs_rel {tf['depth'][0]:.6f} vs {g['depth'][0]:.6f} "
        f"({rel(tf['depth'][0], g['depth'][0]):.3g}), max |diff| flow "
        f"{float(np.abs(tf['flows'] - g['flows']).max()):.3g} px, disparity "
        f"{float(np.abs(tf['disps'] - g['disps']).max()):.3g}")
    if (errs["flows"] > EVAL_TOL["flow"] or errs["disps"] > EVAL_TOL["disp"]
            or errs["poses"] > EVAL_TOL["pose"] or m_err["epe"] > EVAL_TOL["metric"]
            or m_err["depth"] > EVAL_TOL["metric"] or m_err["ate_re"] > EVAL_TOL["pose_metric"]
            or stray):
        fail("eval: the card's inference disagrees with the CPU's")
    return models["cuda"], fns["cuda"]


def phase_eval(smi: str, root: str):
    """Phase 7: evaluation and inference on the card, from the geom
    checkpoint that the CLI phase left in ``root``. Returns the eval_flow
    path's (launches by kernel, batches) and the YAML that names the
    synthetic trees."""
    import torch

    from unsupervised_depth_opticalflow_egomotion_torch import eval_tasks
    from unsupervised_depth_opticalflow_egomotion_torch.config import load_config
    from unsupervised_depth_opticalflow_egomotion_torch.utils import CheckpointManager

    t_start = time.perf_counter()
    t = _eval_trees(os.path.join(root, "eval"))
    log(f"eval: synthetic KITTI trees ({EVAL_HW[0]}x{EVAL_HW[1]}: flow 2015 200 pairs, 2012 194, "
        f"eigen {EIGEN_FRAMES} frames, odometry {ODOM_FRAMES} frames) written in "
        f"{time.perf_counter() - t_start:.1f} s")
    dirs = {"gt_2015_dir": t["kitti2015"], "gt_2012_dir": t["kitti2012"], "raw_base_dir": t["raw"],
            "eigen_test_files_txt": t["eigen_txt"], "eigen_gt_depths_npz": t["eigen_npz"],
            "kitti_odom_dir": t["odom"]}
    eval_yaml = os.path.join(root, "eval.yaml")
    with open(eval_yaml, "w") as f:
        f.write("".join(f"{k}: {v}\n" for k, v in dirs.items()))
    ckpt = os.path.join(root, "geom", "ckpt")
    kernels = {n: k for n, (k, _) in path_kernels().items()}
    for k in kernels.values():
        k.seen.clear()

    # the eval CLI's five tasks in subprocesses, started together
    # (kitti_flow_2015 through this script's eval_cli_2015 mode, which times
    # its flow task and counts its launches: the eval_flow path); in this
    # process meanwhile the training CLI's interleaved eval, then the card
    # against the CPU
    procs = {}
    flow_json = os.path.join(root, "eval_cli_kitti_flow_2015.json")
    try:
        for task, (extra, _) in EVAL_TASKS.items():
            if task == "demo":
                extra = extra + ["--image_path", t["demo"]]
            out = open(os.path.join(OUT_DIR, f"eval_cli_{task}.txt"), "w")
            args = ["-c", eval_yaml, "--task", task, "--pretrained_model", ckpt,
                    "--result_dir", os.path.join(root, "results", task), *extra]
            cmd = ([sys.executable, os.path.abspath(__file__), "eval_cli_2015", flow_json, *args]
                   if task == "kitti_flow_2015" else
                   [sys.executable, "-m", "unsupervised_depth_opticalflow_egomotion_torch.test",
                    *args])
            procs[task] = (subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT), out)
        spans = _eval_training_cli(
            root, {k: dirs[k] for k in ("raw_base_dir", "eigen_test_files_txt",
                                        "eigen_gt_depths_npz", "kitti_odom_dir")}, kernels)
        gt = _gt_subset(t["kitti2015"])

        cfg = load_config(eval_yaml, compute_dtype="float32")
        model, _ = _eval_card_vs_cpu(cfg, t, CheckpointManager(ckpt).restore_params(), gt)
        del gt
        gen = torch.Generator(device="cuda").manual_seed(0)
        a, b = (torch.rand(8, *cfg.img_hw, 3, device="cuda", generator=gen) for _ in range(2))
        s9 = torch.rand(8, *cfg.img_hw, 9, device="cuda", generator=gen)
        with torch.inference_mode(), eval_tasks.full_precision():
            dev_ms = {"flow pairs": cuda_ms(lambda: model.inference_flow(a, b), 10),
                      "depth frames": cuda_ms(lambda: model.infer_disp(a), 10),
                      "pose snippets": cuda_ms(lambda: model.infer_pose(s9), 10)}
        torch.cuda.synchronize()

        for task, (proc, out) in procs.items():
            rc = proc.wait(timeout=900)
            out.close()
            with open(out.name) as f:
                text = f.read()
            if rc != 0 or EVAL_TASKS[task][1] not in text:
                fail(f"eval cli {task}: exited {rc}: {text[-2000:]}")
            how = ("python3 chip_smoke.py eval_cli_2015 (test.main)" if task == "kitti_flow_2015"
                   else "python3 -m unsupervised_depth_opticalflow_egomotion_torch.test")
            log(f"eval cli {task}: {how} exited 0 (waited for until "
                f"{time.perf_counter() - t_start:.1f} s into the phase): "
                f"{' | '.join(text.strip().splitlines()[-3:])}")
    finally:
        _stop(procs)
    # the eval_flow path: the kitti_flow_2015 CLI's flow task, on the card
    with open(flow_json) as f:
        rec = json.load(f)
    launches = rec["launches"]
    want = {n: 5 * 25 if n == "corr_fwd" else 0 for n in kernels}
    if launches != want or rec["all_launches"] != want:
        fail(f"eval_flow: kernel launches {launches} (the process's {rec['all_launches']}), "
             f"expected {want}")
    unchecked = {n: sig for n, sig in ((n, {tuple(x) for x in v} - CHECKED[n])
                                       for n, v in rec["seen"].items()) if sig}
    if unchecked:
        fail(f"eval_flow: launches with signatures that the kernels phase did not hold: {unchecked}")
    # throughput: each task end to end (PNG decode, inference, metrics) as
    # the CLIs ran it on the card (the flow task with its submission PNGs),
    # under contention: the five eval CLIs and the training CLI share the
    # host and the card, so these are not the throughput of a task run
    # alone (as before this script overlapped them); and a device-resident
    # batch of 8
    e2e = {"flow pairs": 200 / rec["seconds"],
           "depth frames": EIGEN_FRAMES / spans["test_eigen_depth"],
           "pose snippets": (ODOM_FRAMES - 2) / spans["test_pose_odom"]}
    for name in e2e:
        log(f"eval throughput {name}/s: {e2e[name]:.1f} end to end under contention (PNG "
            f"decode, inference, metrics, beside the five eval CLIs and the training CLI; not "
            f"a task alone), {8 / dev_ms[name] * 1e3:.1f} on a "
            f"device-resident batch of 8 ({dev_ms[name]:.2f} ms a batch, CUDA events over 10 "
            f"batches), f32 TF32 off {cfg.img_hw[0]}x{cfg.img_hw[1]} | nvidia-smi: {smi}")
    n_sub = len(os.listdir(os.path.join(root, "results", "kitti_flow_2015", "submission")))
    if n_sub != 200 or not os.path.isfile(os.path.join(root, "results", "demo", "demo.png")):
        fail(f"eval cli: {n_sub} submission PNGs (expected 200) or no demo.png")
    unchecked = {n: sorted(k.seen - CHECKED[n]) for n, k in kernels.items() if k.seen - CHECKED[n]}
    if unchecked:
        fail(f"eval: launches with signatures (dtype codes, sizes) that the kernels phase did "
             f"not hold against the plain version: {unchecked}")
    log(f"eval: phase {time.perf_counter() - t_start:.1f} s")
    return (launches, 25), eval_yaml


SYNTH_STEPS = 20  # a stage of phase 8
SYNTH_LOSSES = ["--enable_losses", "triangle,pnp,eight_point,depth_consis",
                "--set", "w_8point=0.001"]


def phase_synth(root: str):
    """The synthetic-world learning script (``train_synth_long`` of the port)
    at 256x832 b8 bf16 on a generated world of 16 train stacks and 4 eval
    frames: flow 20 steps through the occlusion switch (at step 10), depth 20
    steps, geom 20 steps grafted from both with the four optional losses,
    in this process, then a resume of geom to 25 steps through ``python3 -m``.
    Checks finite losses, the geom stage's optional losses (sampled: nonzero
    at every logged step; depth consistency: nonzero where its mask is not
    empty), curves.jsonl with a synth_eval record before the first step and
    at the last, the geom mask dump, the checkpoints, and that every launch
    of the in-process stages had a signature phase 3 held."""
    import torch

    from unsupervised_depth_opticalflow_egomotion_torch import synth_world
    from unsupervised_depth_opticalflow_egomotion_torch import train_synth_long as tsl

    t_start = time.perf_counter()
    world = os.path.join(root, "synth_world")
    synth_world.generate(world, n_train=16, n_eval=4, hw=(256, 832), seed=0)
    t_gen = time.perf_counter() - t_start
    kernels = {n: k for n, (k, _) in path_kernels().items()}
    for k in kernels.values():
        k.launches = 0
        k.seen.clear()
    common = ["--data", world, "--batch", "8", "--log_every", "5",
              "--eval_every", str(SYNTH_STEPS), "--image_every", str(SYNTH_STEPS)]
    out = {m: os.path.join(root, f"synth_{m}") for m in ("flow", "depth", "geom")}
    steps = str(SYNTH_STEPS)
    stages = [
        ("flow", ["--mode", "flow", "--flow_occ_switch_step", "10"]),
        ("depth", ["--mode", "depth"]),
        ("geom", ["--mode", "geom", "--graft_flow", os.path.join(out["flow"], "ckpt"),
                  "--graft_depth", os.path.join(out["depth"], "ckpt"), *SYNTH_LOSSES]),
    ]
    times = {}
    for mode, extra in stages:
        t0 = time.perf_counter()
        _, step = tsl.main(common + ["--out", out[mode], "--steps", steps, *extra])
        times[mode] = time.perf_counter() - t0
        if step != SYNTH_STEPS:
            fail(f"synth {mode}: stopped at step {step} (non-finite loss?)")
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in kernels.items()}
    unchecked = {n: sorted(k.seen - CHECKED[n]) for n, k in kernels.items() if k.seen - CHECKED[n]}
    if unchecked:
        fail(f"synth: launches with signatures that the kernels phase did not hold: {unchecked}")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "unsupervised_depth_opticalflow_egomotion_torch.train_synth_long",
         *common, "--out", out["geom"], "--mode", "geom", "--steps", str(SYNTH_STEPS + 5),
         "--resume", *SYNTH_LOSSES],
        capture_output=True, text=True, timeout=600,
    )
    times["geom resume (python3 -m)"] = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, "synth_resume.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0 or f"resumed from step {SYNTH_STEPS}" not in proc.stdout:
        fail(f"synth: the resume exited {proc.returncode}: {proc.stderr[-2000:]}")

    summary = {}
    for mode in ("flow", "depth", "geom"):
        recs = [json.loads(line) for line in open(os.path.join(out[mode], "curves.jsonl"))]
        evals = {r["step"]: r["eval"] for r in recs if "eval" in r}
        last = SYNTH_STEPS + 5 if mode == "geom" else SYNTH_STEPS
        if sorted(evals) != sorted({0, SYNTH_STEPS, last}):
            fail(f"synth {mode}: synth_eval at steps {sorted(evals)}, expected 0, {last}")
        losses = [r for r in recs if "loss_total" in r]
        if not losses or not all(math.isfinite(v) for r in losses for k, v in r.items()
                                 if k.startswith("loss")):
            fail(f"synth {mode}: non-finite or missing losses")
        keys = {"flow": ("flow_epe",), "depth": ("depth_absrel", "pose_ate", "pose_ate_zero"),
                "geom": ("flow_epe", "depth_absrel", "pose_ate", "pose_ate_zero")}[mode]
        summary[mode] = {s: {k: round(evals[s][k], 4) for k in keys} for s in (0, last)}
        # the in-process stage's last log (the resume's covers its start-up)
        summary[mode]["fps_last"] = next(r["fps"] for r in losses if r["step"] == SYNTH_STEPS)
        if mode == "geom":
            # the sampled losses read no mask: nonzero at every logged step.
            # The depth consistency is gated by the dynamic mask, which the
            # depth photometric loss reads too; in this short chain the rigid
            # flow of a 20-step depth stage often disagrees with the optical
            # flow everywhere, the mask is empty and both are zero (phase 4
            # holds the loss live at init), so it must be nonzero exactly
            # where the photometric loss is
            bad = [r["step"] for r in losses
                   if not all(abs(r[k]) > 0 for k in SAMPLED)
                   or (r["loss_depth_consis"] == 0) != (r["loss_depth_pixel"] == 0)]
            if bad:
                fail(f"synth geom: an optional loss is zero at logged steps {bad}: {losses}")
            summary[mode]["logged_steps_depth_mask_empty"] = sorted(
                r["step"] for r in losses if r["loss_depth_pixel"] == 0)
            dump = os.path.join(out[mode], "images", f"step_{SYNTH_STEPS:08d}", "fwd_mask.png")
            if not os.path.exists(dump):
                fail("synth geom: no mask dump")
        ckpts = sorted(int(f[:-3]) for f in os.listdir(os.path.join(out[mode], "ckpt"))
                       if f.endswith(".pt"))
        if ckpts[-1] != last:
            fail(f"synth {mode}: checkpoints {ckpts}")
    log(f"synth: world of 16 stacks + 4 eval frames at 256x832 generated in {t_gen:.1f} s; "
        f"stage seconds {json.dumps({k: round(v, 1) for k, v in times.items()})}; "
        f"launches of the in-process stages {json.dumps(launches)}")
    log(f"synth: synth_eval before and after each stage (loss-free check, not a learning "
        f"claim at {SYNTH_STEPS} steps; fps_last under contention, beside phase 9's eval CLIs "
        f"and phase 10's spawned ranks): {json.dumps(summary)}")
    log(f"synth: phase {time.perf_counter() - t_start:.1f} s")


TWO_VIEW_TASKS = {"kitti_flow_2015": "[EVAL] [kitti_2015]", "kitti_flow_2012": "[EVAL] [kitti_2012]"}
FLOWPOSE_STEPS = (2, 10)  # warm-up, timed


def _printed_flow_metrics(text: str) -> dict:
    """The metrics block the eval CLI prints last (format_flow_metrics)."""
    header, values = text.strip().splitlines()[-2:]
    return dict(zip([k.strip() for k in header.split(",")], [float(v) for v in values.split(",")]))


def _rigid_scene(b, h, w, gen):
    """A rigid two-view scene: depth with relief (4-10 m, a smooth random
    field per item), a pose each (0.3-0.9 m forward, up to 0.3 m sideways,
    rotations up to 0.03 rad), K as the train phases'. Returns (depth
    [B,H,W,1], pose [B,6], K, K_inv [B,3,3]) on the CPU."""
    import torch
    import torch.nn.functional as F

    coarse = torch.rand(b, 1, h // 32 + 2, w // 32 + 2, generator=gen)
    field = F.interpolate(coarse, size=(h, w), mode="bicubic", align_corners=False)
    lo = field.amin(dim=(2, 3), keepdim=True)
    hi = field.amax(dim=(2, 3), keepdim=True)
    depth = (4.0 + 6.0 * (field - lo) / (hi - lo)).permute(0, 2, 3, 1).contiguous()
    t = torch.rand(b, 3, generator=gen) * torch.tensor([0.6, 0.1, 0.6]) - torch.tensor([0.3, 0.05, -0.3])
    r = 0.06 * torch.rand(b, 3, generator=gen) - 0.03
    K = torch.tensor([[241.0, 0, w / 2], [0, 245.0, h / 2], [0, 0, 1]]).expand(b, 3, 3).contiguous()
    return depth, torch.cat([t, r], 1), K, torch.linalg.inv(K)


def _flowpose_parity():
    """One forward_train step of FlowPoseModel, card against CPU, at 64x128
    b2 f32 (TF32 off), the same weights (seeded nonzero FlowPoseNet biases,
    so the warp is not the identity) and frames. Losses to 1e-3 relative +
    1e-7 (as phase 4), the gradients of depth_net and flow_pose_net stated
    and held to 2e-2 relative L2 (phase 4's bar)."""
    import copy

    import torch

    from unsupervised_depth_opticalflow_egomotion_torch.models import FlowPoseModel
    from unsupervised_depth_opticalflow_egomotion_torch.models.layers import init_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = FlowPoseModel()
    init_weights(cpu, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in cpu.flow_pose_net.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    images, K_ms, K_inv = _batch(2, 64, 128, "cpu")
    stack = images[:, :2 * 64].float() / 255.0  # the first two frames
    res = {}
    for dev, model in (("cpu", cpu), ("cuda", copy.deepcopy(cpu).cuda())):
        pack = model.forward_train(stack.to(dev), K_ms.to(dev), K_inv.to(dev))
        sum(v.mean() for v in pack.values()).backward()
        res[dev] = ({k: v.detach().cpu() for k, v in pack.items()},
                    {k: p.grad.cpu() for k, p in model.named_parameters() if p.grad is not None})
    (p_cpu, g_cpu), (p_gpu, g_gpu) = res["cpu"], res["cuda"]
    worst = max(float(((p_gpu[k] - v).abs() / (1e-3 * v.abs() + 1e-7)).max()) for k, v in p_cpu.items())
    grads = {}
    for net in ("depth_net", "flow_pose_net"):
        ks = [k for k in g_cpu if k.startswith(net + ".")]
        a = torch.cat([g_gpu[k].flatten() for k in ks])
        b = torch.cat([g_cpu[k].flatten() for k in ks])
        grads[net] = float((a - b).norm() / b.norm())
    log(f"two_view: FlowPoseModel forward_train 64x128 b2 f32 card vs cpu: worst loss error "
        f"{worst:.3g} of its tolerance (1e-3 relative + 1e-7), gradient rel L2 err "
        + ", ".join(f"{k} {v:.3g}" for k, v in grads.items()) + " (tol 2e-2); losses card "
        + json.dumps({k: [round(float(x), 6) for x in v] for k, v in p_gpu.items()}))
    if worst > 1.0 or max(grads.values()) > 2e-2 or set(g_cpu) != set(g_gpu) \
            or any(k.startswith(("fpyramid.", "pwc_model.")) for k in g_gpu):
        fail("two_view: the card's FlowPoseModel step disagrees with the CPU's")


def _held(kernels: dict, what: str) -> None:
    """Fail if a launch since the last clear of ``seen`` had a signature that
    the kernels phase did not hold against the plain version."""
    unchecked = {n: sorted(k.seen - CHECKED[n]) for n, k in kernels.items() if k.seen - CHECKED[n]}
    if unchecked:
        fail(f"two_view: {what}: launches with signatures that the kernels phase did not hold "
             f"against the plain version: {unchecked}")


def _start_two_view_cli(root: str, eval_yaml: str) -> dict:
    """Phase 9's subprocesses: the eval CLI's ``--mode two_view`` for both
    flow tasks, from phase 6's geom checkpoint on phase 7's trees. Started
    when phase 7 ends, so that they run beside phase 8; ``phase_two_view``
    checks them."""
    ckpt = os.path.join(root, "geom", "ckpt")
    procs = {}
    try:
        for task in TWO_VIEW_TASKS:
            out = open(os.path.join(OUT_DIR, f"two_view_cli_{task}.txt"), "w")
            cmd = [sys.executable, "-m", "unsupervised_depth_opticalflow_egomotion_torch.test",
                   "-c", eval_yaml, "--mode", "two_view", "--task", task,
                   "--pretrained_model", ckpt, "--result_dir", os.path.join(root, "two_view", task)]
            procs[task] = (subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT), out)
    except BaseException:
        _stop(procs)
        raise
    return procs


def _stop(procs: dict) -> None:
    """Kill the subprocesses of ``procs`` that still run; close their logs."""
    for proc, out in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()


def phase_two_view(smi: str, root: str, eval_yaml: str, procs: dict) -> dict:
    """Phase 9: the legacy two-view and flow-to-pose families on the card.
    The eval CLI's ``--mode two_view`` for both flow tasks (``procs``,
    started before phase 8) from phase 6's geom checkpoint on phase 7's
    trees, whose EPEs must be the geom-mode tasks' of phase 7 (the same PWC
    forward); meanwhile, in this process: the two-view model at b8 256x832 f32 on the
    card against the CPU (the nets' half on 8 of the tree's pairs; the
    geometric half on the exact rigid flow of a known depth and pose, both
    devices against the truth), ``FlowPoseModel``'s forward_train card
    against CPU at 64x128, and its training at b8 256x832 f32 with Adam.
    Returns the launches of the two_view (inference batches) and flowpose
    (train steps) paths, and the profile of the FlowPoseModel step to take
    once every timed run is done."""
    import copy

    import numpy as np
    import torch

    from unsupervised_depth_opticalflow_egomotion_torch import eval_tasks
    from unsupervised_depth_opticalflow_egomotion_torch import test as eval_cli
    from unsupervised_depth_opticalflow_egomotion_torch.config import load_config
    from unsupervised_depth_opticalflow_egomotion_torch.data import KittiFlowEval
    from unsupervised_depth_opticalflow_egomotion_torch.models import FlowPoseModel
    from unsupervised_depth_opticalflow_egomotion_torch.models import triangulation_pose as tp
    from unsupervised_depth_opticalflow_egomotion_torch.models.layers import init_weights
    from unsupervised_depth_opticalflow_egomotion_torch.ops.geometry import (
        calculate_rigid_flow,
        pose_vec2mat,
    )
    from unsupervised_depth_opticalflow_egomotion_torch.parallel import build_model
    from unsupervised_depth_opticalflow_egomotion_torch.utils import CheckpointManager

    t_start = time.perf_counter()
    ckpt = os.path.join(root, "geom", "ckpt")
    kernels = {n: k for n, (k, _) in path_kernels().items()}
    by_path = {}
    try:
        # the two-view model on the geom checkpoint, card and CPU, f32
        cfg = load_config(eval_yaml, mode="geom", compute_dtype="float32")
        joint = build_model(cfg, "cpu")
        joint.load_state_dict(CheckpointManager(ckpt).restore_params())
        tv_cpu = eval_cli.two_view_model(joint, cfg)
        tv = copy.deepcopy(tv_cpu).cuda()
        del joint
        h, w = cfg.img_hw
        ds = KittiFlowEval(cfg.gt_2015_dir, "kitti_2015", cfg.img_hw)
        group = [ds[i] for i in range(8)]
        pairs = np.stack([s[0] for s in group])
        K = torch.from_numpy(np.stack([s[1] for s in group]))
        K_inv = torch.from_numpy(np.stack([s[2] for s in group]))
        img1, img2 = (torch.from_numpy(np.ascontiguousarray(x)) for x in (pairs[:, :h], pairs[:, h:]))
        draws = tv.draw(8, (h, w))
        with torch.inference_mode(), eval_tasks.full_precision():
            t0 = time.perf_counter()
            want = tv_cpu.inference(img1, img2, K, K_inv, draws=draws)
            cpu_s = time.perf_counter() - t0
            args = [x.cuda() for x in (img1, img2, K, K_inv)]
            got = tv.inference(*args, draws=draws)  # warm-up
            torch.cuda.synchronize()
            for k in kernels.values():
                k.launches = 0
                k.seen.clear()
            n_tv = 3
            t0 = time.perf_counter()
            for _ in range(n_tv):
                got = tv.inference(*args, draws=draws)
            torch.cuda.synchronize()
            tv_ms = (time.perf_counter() - t0) / n_tv * 1e3
            by_path["two_view"] = ({n: k.launches for n, k in kernels.items()}, n_tv)
            err_flow = max_err(got[0].cpu(), want[0])
            err_disp = max(max_err(got[1].cpu(), want[1]), max_err(got[2].cpu(), want[2]))

            # the geometric half on an exact rigid flow, both devices
            depth, pose, Kr, Kr_inv = _rigid_scene(8, h, w, torch.Generator().manual_seed(3))
            flow = calculate_rigid_flow(depth, pose, Kr)
            T = pose_vec2mat(pose)
            rigid = {}
            for dev in ("cpu", "cuda"):
                d = {k: v.to(dev) for k, v in draws.items()}
                rigid[dev] = tp.two_view_geometry(flow.to(dev), Kr.to(dev), Kr_inv.to(dev), d)[0].cpu()
        r_err = {d: float((rt[:, :, :3] - T[:, :, :3]).abs().max()) for d, rt in rigid.items()}
        cos = {d: float(((rt[:, :, 3] * T[:, :, 3]).sum(-1)
                         / (rt[:, :, 3].norm(dim=-1) * T[:, :, 3].norm(dim=-1))).min())
               for d, rt in rigid.items()}
        log(f"two_view: b8 {h}x{w} f32 (TF32 off), ransac_points {tv.ransac_points}, "
            f"{tv.ransac_iters} iterations, the same draws: nets' half card vs cpu max |diff| flow "
            f"{err_flow:.3g} px (tol {EVAL_TOL['flow']}), disparity {err_disp:.3g} (tol "
            f"{EVAL_TOL['disp']}); geometric half on the exact rigid flow of a known depth and "
            f"pose: max |R - R_true| card {r_err['cuda']:.3g} cpu {r_err['cpu']:.3g} (tol 1e-2), "
            f"min cos(t, t_true) card {cos['cuda']:.6f} cpu {cos['cpu']:.6f} (bar 0.999), card "
            f"vs cpu |Rt| {float((rigid['cuda'] - rigid['cpu']).abs().max()):.3g}")
        log(f"two_view: inference {tv_ms:.1f} ms a batch of 8 on the card (device-resident, "
            f"{n_tv} batches, host clock), {cpu_s:.1f} s on the CPU | nvidia-smi: {smi}")
        if err_flow > EVAL_TOL["flow"] or err_disp > EVAL_TOL["disp"] \
                or max(r_err.values()) > 1e-2 or min(cos.values()) <= 0.999:
            fail("two_view: the card's two-view inference disagrees with the CPU's or the truth")
        # the PWC forward, and the depth decoder's 13 pads on each frame of the pairs
        tv_step = {"corr_fwd": 5, "reflect_pad_fwd": 26}
        want_tv = {n: tv_step.get(n, 0) * n_tv for n in kernels}
        if by_path["two_view"][0] != want_tv:
            fail(f"two_view: kernel launches {by_path['two_view'][0]}, expected {want_tv}")
        _held(kernels, "two_view inference")
        del tv, tv_cpu

        _flowpose_parity()

        # FlowPoseModel training at full width: the flow nets frozen (no
        # autograd), Adam over the depth net and FlowPoseNet
        model = FlowPoseModel()
        init_weights(model, torch.Generator().manual_seed(0))
        model = model.cuda().train()
        opt = torch.optim.Adam(model.parameters(), lr=1e-4)
        images, K_ms, K_inv_ms = _batch(8, h, w, torch.device("cuda"))
        stack = images[:, :2 * h].float() / 255.0
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        warmup, timed = FLOWPOSE_STEPS
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
            k.seen.clear()

        def train_step(_=None):
            opt.zero_grad(set_to_none=True)
            pack = model.forward_train(stack, K_ms, K_inv_ms)
            total = sum(v.mean() for v in pack.values())
            total.backward()
            opt.step()
            return total.detach()

        losses = []
        for i in range(warmup + timed):
            if i == warmup:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            losses.append(train_step())
        torch.cuda.synchronize()
        fp_ms = (time.perf_counter() - t0) / timed * 1e3
        launches = {n: k.launches for n, k in kernels.items()}
        by_path["flowpose"] = (launches, warmup + timed)
        values = [float(x) for x in losses]
        after = dict(model.named_parameters())
        moved = {net: not torch.equal(before[name], after[name]) for net, name in (
            ("depth_net", "depth_net.encoder.encoder.conv1.weight"),
            ("flow_pose_net", "flow_pose_net.conv1.weight"))}
        strayed = [k for k, v in before.items()
                   if k.startswith(("fpyramid.", "pwc_model.")) and not torch.equal(v, after[k])]
        per_step = {"corr_fwd": 5, "ssim_fwd": 1, "ssim_bwd": 1, "reflect_pad_fwd": 22,
                    "reflect_pad_bwd": 22}
        want_fp = {n: per_step.get(n, 0) * (warmup + timed) for n in kernels}
        log(f"two_view: FlowPoseModel train b8 {h}x{w} f32 (TF32 off): {warmup + timed} steps, {timed} timed, "
            f"{fp_ms:.1f} ms/step, launches/step {json.dumps(per_step)}, losses {values[0]:.5f} -> "
            f"{values[-1]:.5f}, moved {json.dumps(moved)}")
        _metric_line(f"frames/sec FlowPoseModel forward_train fwd-bwd (b8 {h}x{w} f32, PyTorch port)",
                     fp_ms, smi)
        if not all(math.isfinite(v) for v in values) or not all(moved.values()) or strayed:
            fail(f"two_view: FlowPoseModel training: losses {values}, moved {moved}, flow nets "
                 f"moved {strayed[:5]}")
        if launches != want_fp:
            fail(f"two_view: FlowPoseModel kernel launches {launches}, expected {want_fp}")
        _held(kernels, "FlowPoseModel training")
        # the CLI: each flow task's EPEs against the geom-mode task's of phase 7
        for task, marker in TWO_VIEW_TASKS.items():
            proc, out = procs[task]
            rc = proc.wait(timeout=900)
            out.close()
            with open(out.name) as f:
                text = f.read()
            if rc != 0 or marker not in text:
                fail(f"two_view cli {task}: exited {rc}: {text[-2000:]}")
            with open(os.path.join(OUT_DIR, f"eval_cli_{task}.txt")) as f:
                geom = _printed_flow_metrics(f.read())
            got = _printed_flow_metrics(text)
            # printed with four decimals: 1e-5 relative plus half the last digit
            bad = {k: (got[k], geom[k]) for k in geom if k.startswith("epe")
                   and abs(got[k] - geom[k]) > 1e-5 * abs(geom[k]) + 5e-5}
            log(f"two_view cli {task}: python3 -m unsupervised_depth_opticalflow_egomotion_torch.test "
                f"--mode two_view exited 0: {json.dumps(got)}; geom mode (phase 7) "
                f"{json.dumps(geom)}")
            if bad or set(got) != set(geom):
                fail(f"two_view cli {task}: EPEs unlike the geom-mode task's: {bad}")
    finally:
        _stop(procs)
    log(f"two_view: phase {time.perf_counter() - t_start:.1f} s")
    return by_path, lambda: _profile("flowpose f32", train_step, None, fp_ms, verbose=True)


# ------------------------------------------------------------ phase 10: dp

DP_STEPS = {  # (a): one step of each on two ranks against one process (b4 64x128 f32)
    # the sampled losses are computed and compared, but weighted 0: at init
    # their gradients follow f32 rounding (as in phase 4, which compares the
    # gradient of the total without them)
    "geom +triangle,pnp,eight_point,depth_consis": {
        "mode": "geom", **GEO_LOSSES, "w_triangle": 0.0, "w_pnp": 0.0, "w_8point": 0.0},
    "flow splat": {"mode": "flow", "flow_occ_impl": "splat"},
    "depth": {"mode": "depth"},
}
DP_TIMEOUT = 600  # s, for each group of ranks


def _dp_entry(rank, world, store, out, job, args):
    """A spawned rank on card 0: a gloo group through a FileStore, then
    ``job``; its result to ``<out>/rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.set_num_threads(2)  # four ranks share the host's cores while (a) and (c) run
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        torch.save(job(rank, world, *args), os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _start_ranks(job, args, out: str, world: int = 2):
    """Start ``job`` on ``world`` spawned ranks of one gloo group on card 0
    (NCCL refuses two ranks on one device); ``_join_ranks`` waits for them."""
    import multiprocessing

    os.makedirs(out, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_dp_entry,
                         args=(r, world, os.path.join(out, "store"), out, job, args))
             for r in range(world)]
    for p in procs:
        p.start()
    return job, out, procs, time.monotonic() + DP_TIMEOUT


def _join_ranks(handle) -> list:
    """The ranks' results by rank; fails unless every rank exited 0 in time."""
    import torch

    job, out, procs, deadline = handle
    for p in procs:
        p.join(max(deadline - time.monotonic(), 1.0))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * len(procs):
        fail(f"dp: ranks of {job.__name__} exited {codes}")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(len(procs))]


def _step_record(model, opt, metrics) -> dict:
    """Metrics, gradients, the state after the step and Adam's moments, on
    the CPU."""
    named = dict(model.named_parameters())
    return {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": {k: p.grad.float().cpu() for k, p in named.items() if p.grad is not None},
        "after": {k: v.cpu().clone() for k, v in model.state_dict().items()},
        "mu": {k: opt.state[p]["exp_avg"].cpu() for k, p in named.items() if p in opt.state},
        "nu": {k: opt.state[p]["exp_avg_sq"].cpu() for k, p in named.items() if p in opt.state},
    }


def _dp_step_config(kw):
    from unsupervised_depth_opticalflow_egomotion_torch.config import Config

    return Config(img_hw=(64, 128), batch_size=4, compute_dtype="float32", **kw)


def _dp_steps_job(rank, world):
    """(a) on one rank: a step of each of DP_STEPS on its rows of the global
    b4 batch, TF32 off."""
    import torch
    import torch.distributed as dist

    from unsupervised_depth_opticalflow_egomotion_torch.parallel import init_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name, kw in DP_STEPS.items():
        cfg = _dp_step_config(kw)
        model, opt = init_state(cfg, "cuda:0")
        b = cfg.batch_size // world
        local = tuple(x[rank * b:(rank + 1) * b] for x in _batch(cfg.batch_size, 64, 128, "cuda:0"))
        metrics = make_train_step(model, cfg, opt, dist.group.WORLD)(local, 0)
        out[name] = _step_record(model, opt, metrics)
    return out


def _dp_cli_job(rank, world, yaml_path, model_dir, steps):
    """(c) on one rank: the training CLI (``train.train``) on card 0, geom at
    the YAML's b8 (global). Records each rank's writes (checkpoint saves,
    loggers, config dumps), its printed output, each step's local metrics
    and their world means, and its final state."""
    import contextlib

    from unsupervised_depth_opticalflow_egomotion_torch import train as cli
    from unsupervised_depth_opticalflow_egomotion_torch.config import Config, load_config
    from unsupervised_depth_opticalflow_egomotion_torch.parallel import train_step
    from unsupervised_depth_opticalflow_egomotion_torch.utils import CheckpointManager, MetricLogger

    writes = {"save": 0, "logger": 0, "dump": 0}
    reduced = []
    originals = (CheckpointManager.save, MetricLogger.__init__, Config.dump,
                 train_step.all_reduce_metrics)

    def counting(key, fn):
        def wrapped(*a, **k):
            writes[key] += 1
            return fn(*a, **k)
        return wrapped

    def recording(metrics, group):
        out = originals[3](metrics, group)
        reduced.append(({k: float(v) for k, v in metrics.items()},
                        {k: float(v) for k, v in out.items()}))
        return out

    CheckpointManager.save = counting("save", originals[0])
    MetricLogger.__init__ = counting("logger", originals[1])
    Config.dump = counting("dump", originals[2])
    train_step.all_reduce_metrics = recording
    printed = os.path.join(os.path.dirname(model_dir), f"rank{rank}_stdout.txt")
    try:
        with open(printed, "w") as f, contextlib.redirect_stdout(f):
            cfg = load_config(yaml_path, mode="geom", model_dir=model_dir, num_iterations=steps,
                              log_interval=1, save_interval=0)
            model, _, step = cli.train(cfg, device="cuda:0")
    finally:
        (CheckpointManager.save, MetricLogger.__init__, Config.dump,
         train_step.all_reduce_metrics) = originals
    with open(printed) as f:
        text = f.read()
    return {"writes": writes, "reduced": reduced, "printed": text, "step": step,
            "state": {k: v.cpu().clone() for k, v in model.state_dict().items()}}


def _dp_torchrun_worker(yaml_path: str, model_dir: str, out_json: str) -> None:
    """(b), the process torchrun starts: the training CLI's ``train`` for 8
    geom steps (it joins the NCCL group from torchrun's environment), then
    ``main`` (the command line) resuming to 10 and leaving the group. The
    launch counts and signatures and the log steps' times go to
    ``out_json``."""
    from unsupervised_depth_opticalflow_egomotion_torch import train as cli
    from unsupervised_depth_opticalflow_egomotion_torch.config import load_config
    from unsupervised_depth_opticalflow_egomotion_torch.utils import MetricLogger

    kernels = {n: k for n, (k, _) in path_kernels().items()}
    for k in kernels.values():
        k.launches = 0
        k.seen.clear()
    log_times = {}
    original = MetricLogger.add_scalars

    def timed(self, step, scalars):
        log_times[step] = time.perf_counter()
        original(self, step, scalars)

    MetricLogger.add_scalars = timed
    cli.train(load_config(yaml_path, mode="geom", model_dir=model_dir, num_iterations=8))
    cli.main(["-c", yaml_path, "--mode", "geom", "--model_dir", model_dir,
              "--num_iterations", "10", "--resume"])
    with open(out_json, "w") as f:
        json.dump({"launches": {n: k.launches for n, k in kernels.items()},
                   "seen": {n: sorted(k.seen) for n, k in kernels.items()},
                   "log_times": log_times}, f)


def _dp_compare(got: dict, want: dict, mode: str) -> list:
    """Phase 4's tolerances, rank against one process, and the update's:
    losses 1e-3 relative + 1e-7 (depth consistency 5e-3; triangulation
    3e-2 and PnP 0.2 of the batch's value, the eight-point loss within its
    range); gradients and Adam's first moment per network 2e-2 relative
    L2, the second moment (the gradient squared) 4e-2; the parameters
    within 2 lr, under 2 % of a network's entries off by more than 0.1 lr
    (Adam's first update is +-lr), those of the other networks bit-equal;
    the running statistics to 1e-4 of each tensor's max-abs. Returns what
    disagrees."""
    import torch

    from unsupervised_depth_opticalflow_egomotion_torch.config import Config

    bad = []
    for k, w in want["metrics"].items():
        g = got["metrics"][k]
        if k == "loss_eight_point":
            ok = 0 < g <= 2 / 9 and 0 < w <= 2 / 9
        else:
            rtol = {"loss_triangle": 3e-2, "loss_pnp": 0.2, "loss_depth_consis": 5e-3}.get(k, 1e-3)
            ok = abs(g - w) <= rtol * abs(w) + 1e-7
        if not ok:
            bad.append(f"{k} {g:.6g} vs {w:.6g}")
    if set(got["grads"]) != set(want["grads"]):
        bad.append("other parameters got gradients")
    for what, tol in (("grads", 2e-2), ("mu", 2e-2), ("nu", 4e-2)):
        for net in NETS[mode]:
            ks = [k for k in want[what] if k.startswith(net + ".")]
            a = torch.cat([got[what][k].flatten() for k in ks])
            b = torch.cat([want[what][k].flatten() for k in ks])
            err = ((a - b).norm() / b.norm()).item()
            if not err <= tol:
                bad.append(f"{what} {net} rel L2 {err:.3g}")
    lr = Config().lr
    stats = ("running_mean", "running_var")
    for k, w in want["after"].items():
        if k.endswith(stats) and (got["after"][k] - w).abs().max() > 1e-4 * w.abs().max():
            bad.append(k)
        elif not k.startswith(tuple(n + "." for n in NETS[mode])) and not k.endswith(stats) \
                and not torch.equal(got["after"][k], w):
            bad.append(k)
    for net in NETS[mode]:
        ks = [k for k in want["after"] if k.startswith(net + ".") and not k.endswith(stats)]
        d = torch.cat([(got["after"][k] - want["after"][k]).flatten() for k in ks])
        if d.abs().max() > 2.0 * lr * 1.001 or (d.abs() > 0.1 * lr).float().mean() >= 0.02:
            bad.append(f"{net} parameters")
    return bad


def _dp_group_cost(smi: str, root: str) -> None:
    """(b), the step's own cost of the group: the default geom step in this
    process without and with a one-process NCCL group, in turns."""
    import torch
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(root, "nccl_store"), 1),
                            rank=0, world_size=1, device_id=torch.device("cuda", 0))
    try:
        geom_k = {"warp_gather": 6, "corr_fwd": 5, "corr_bwd_df1": 5, "corr_bwd_df2": 5,
                  "ssim_fwd": 6, "ssim_bwd": 6, "reflect_pad_fwd": 13, "reflect_pad_bwd": 13}
        runs = {"plain": _start("dp geom default, no group", {}),
                "group": _start("dp geom default, one-process NCCL group", {},
                                dist.group.WORLD)}
        ms = {"plain": [], "group": []}
        order = ("plain", "group", "group", "plain")
        for key in order:
            ms[key].append(_drive(runs[key], geom_k, 2, 5)[1])
        log(f"dp (b): the default geom step in this process, b8 256x832 bf16, without and with "
            f"a one-process NCCL group, in turns ({', '.join(order)}; 5 timed steps each): "
            + ", ".join(f"{ms[k][i]:.1f}" for k, i in zip(order, (0, 0, 1, 1)))
            + f" ms/step; means {statistics.mean(ms['plain']):.1f} and "
            f"{statistics.mean(ms['group']):.1f}, the group "
            f"{statistics.mean(ms['group']) / statistics.mean(ms['plain']):.3f}x the time "
            f"| nvidia-smi: {smi}")
    finally:
        dist.destroy_process_group()
    del runs
    torch.cuda.empty_cache()


def start_dp_ranks(root: str) -> dict:
    """Phase 10's (c) and (a): their spawned ranks, started when phase 7
    ends so that they run beside phase 8 (neither is timed); ``phase_dp``
    joins and checks them."""
    c_dir = os.path.join(root, "dp_gloo")
    return {"t0": time.perf_counter(), "model_dir": os.path.join(c_dir, "run"),
            "c": _start_ranks(_dp_cli_job, (os.path.join(root, "cli.yaml"),
                                            os.path.join(c_dir, "run"), 3), c_dir),
            "a": _start_ranks(_dp_steps_job, (), os.path.join(root, "dp_steps"))}


def stop_dp_ranks(ranks: dict) -> None:
    """Kill the ranks of ``start_dp_ranks`` that still run."""
    for key in ("a", "c"):
        for p in ranks[key][2]:
            if p.is_alive():
                p.kill()
                p.join()


def phase_dp(smi: str, root: str, cli_fps: float, ranks: dict) -> tuple:
    """Data parallel: (a) two gloo ranks on card 0 against one process,
    (b) the training CLI under torchrun in a one-process NCCL group on
    phase 6's PNGs, timed beside phase 6, (c) the training CLI on two gloo
    ranks on card 0; (a) and (c) are ``ranks`` (``start_dp_ranks``, run
    beside phase 8). Returns the dp path's (launches, steps)."""
    import torch

    from unsupervised_depth_opticalflow_egomotion_torch.parallel import init_state, make_train_step
    from unsupervised_depth_opticalflow_egomotion_torch.utils import CheckpointManager

    t_start = time.perf_counter()
    torch.cuda.empty_cache()
    yaml_path = os.path.join(root, "cli.yaml")
    model_dir = ranks["model_dir"]
    # (a): one process's steps, then the ranks'
    wants = {}
    for name, kw in DP_STEPS.items():
        cfg = _dp_step_config(kw)
        model, opt = init_state(cfg)
        wants[name] = _step_record(model, opt, make_train_step(model, cfg, opt)(
            _batch(cfg.batch_size, 64, 128, torch.device("cuda")), 0))
        del model, opt
    a_out = _join_ranks(ranks["a"])
    log(f"dp (a), (c): started {t_start - ranks['t0']:.1f} s before this phase, beside phase 8")
    for name, want in wants.items():
        cfg = _dp_step_config(DP_STEPS[name])
        bad = [f"rank 1 differs from rank 0: {k}" for k in ("metrics", "after", "mu", "nu")
               if a_out[0][name][k].keys() != a_out[1][name][k].keys() or any(
                   not (v == a_out[1][name][k][n] if isinstance(v, float) else
                        torch.equal(v, a_out[1][name][k][n]))
                   for n, v in a_out[0][name][k].items())]
        bad += _dp_compare(a_out[0][name], want, cfg.mode)
        if bad:
            fail(f"dp (a) {name}: two ranks against one process: {bad[:8]}")
        log(f"dp (a) {name}: two gloo ranks on card 0 (b2 each) match one process on the "
            f"global b4 64x128 f32 (TF32 off), and each other bit for bit")
    torch.cuda.empty_cache()
    r0, r1 = _join_ranks(ranks["c"])
    _dp_check_cli(r0, r1, model_dir)
    del r0, r1

    # (b), timed
    run_dir, out_json = os.path.join(root, "dp_torchrun"), os.path.join(root, "dp_torchrun.json")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
           os.path.abspath(__file__), "dp_torchrun", yaml_path, run_dir, out_json]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=DP_TIMEOUT)
    with open(os.path.join(OUT_DIR, "dp_torchrun.txt"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0 or proc.stdout.count("training done") != 2:
        fail(f"dp (b): torchrun exited {proc.returncode}: {proc.stderr[-2000:]}")
    if "x 1 ranks (nccl)" not in proc.stdout or "resumed from step 8" not in proc.stdout:
        fail("dp (b): the CLI did not report a one-process NCCL group and the resume")
    with open(out_json) as f:
        rec = json.load(f)
    launches = rec["launches"]
    per_step = {"warp_gather": 6, "corr_fwd": 5, "corr_bwd_df1": 5, "corr_bwd_df2": 5,
                "ssim_fwd": 6, "ssim_bwd": 6, "reflect_pad_fwd": 13, "reflect_pad_bwd": 13}
    want = {n: per_step.get(n, 0) * 10 for n in launches}
    if launches != want:
        fail(f"dp (b): kernel launches {launches}, expected {want}")
    unchecked = {n: sig for n, sig in ((n, {tuple(x) for x in v} - CHECKED[n])
                                       for n, v in rec["seen"].items()) if sig}
    if unchecked:
        fail(f"dp (b): launches with signatures that the kernels phase did not hold: {unchecked}")
    if CheckpointManager(os.path.join(run_dir, "ckpt")).latest_step() != 10:
        fail("dp (b): no checkpoint of step 10")
    t = {int(k): v for k, v in rec["log_times"].items()}
    dp_fps = 4 * 8 / ((t[4] - t[2]) + (t[8] - t[6]))
    log(f"dp (b): torchrun --nproc_per_node 1: the CLI in a one-process NCCL group, 8 geom "
        f"steps and a resume to 10 in {time.perf_counter() - t0:.1f} s; steady {dp_fps:.2f} "
        f"frames/s (steps 3-4 and 7-8) against phase 6's {cli_fps:.2f} without a group "
        f"({dp_fps / cli_fps:.3f}x) | nvidia-smi: {smi}")

    _dp_group_cost(smi, root)
    log(f"dp: phase {time.perf_counter() - t_start:.1f} s")
    return launches, 10


def _dp_check_cli(r0: dict, r1: dict, model_dir: str) -> None:
    """(c)'s checks on the two ranks' records."""
    import pickle

    import torch

    from unsupervised_depth_opticalflow_egomotion_torch.utils import CheckpointManager

    bad = []
    if (r0["step"], r1["step"]) != (3, 3):
        bad.append(f"steps {r0['step']}, {r1['step']}")
    if r0["writes"] != {"save": 1, "logger": 1, "dump": 1} or any(r1["writes"].values()):
        bad.append(f"writes rank 0 {r0['writes']}, rank 1 {r1['writes']}")
    if (r1["printed"] or "training done" not in r0["printed"]
            or "x 2 ranks (gloo)" not in r0["printed"]):
        bad.append("rank 0 alone prints, and names the two-rank gloo group")
    if CheckpointManager(os.path.join(model_dir, "ckpt")).steps() != [3] or not all(
            os.path.exists(os.path.join(model_dir, n)) for n in ("log.pkl", "config.json")):
        bad.append("ckpt/3, log.pkl and config.json")
    means = []
    for (l0, m0), (l1, m1) in zip(r0["reduced"], r1["reduced"]):
        if m0 != m1 or any(abs(m0[k] - (l0[k] + l1[k]) / 2) > 1e-6 * abs(m0[k]) for k in m0):
            bad.append("a step's metrics are not the two ranks' mean on both")
        means.append(m0)
    with open(os.path.join(model_dir, "log.pkl"), "rb") as f:
        hist = pickle.load(f)
    if len(means) != 3 or {k: [v for _, v in vals] for k, vals in hist.items()} != {
            k: [m[k] for m in means] for k in means[0]}:
        bad.append("log.pkl holds other losses than the world means")
    if any(not torch.equal(v, r1["state"][k]) for k, v in r0["state"].items()):
        bad.append("the ranks' parameters or buffers differ")
    if bad:
        fail(f"dp (c): the CLI on two gloo ranks: {bad}")
    log(f"dp (c): the CLI on two gloo ranks on card 0, geom b8 global (b4 each) 256x832 bf16, "
        f"3 steps (beside (a)): losses the world means (loss_total {means[-1]['loss_total']:.4f}), rank 0 alone "
        "wrote ckpt/, log.pkl and config.json and printed, the ranks end bit-equal")


def phase_bench(smi: str, geom_line: dict) -> None:
    """Phase 11: ``python3 -m unsupervised_depth_opticalflow_egomotion_torch.bench``
    as a subprocess, with the default settings (no BENCH_* variable). Its
    standard output must be exactly one JSON line with bench.py's keys,
    ``metric`` bench.py's default string, 0 < mfu <= 1, and
    ``flops_per_step`` phase 5's count of the same Config in this process."""
    from unsupervised_depth_opticalflow_egomotion_torch.bench import Settings

    t0 = time.perf_counter()
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    proc = subprocess.run(
        [sys.executable, "-m", "unsupervised_depth_opticalflow_egomotion_torch.bench"],
        capture_output=True, text=True, timeout=600, env=env)
    with open(os.path.join(OUT_DIR, "bench.txt"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        fail(f"bench: python3 -m ...bench exited {proc.returncode}: {proc.stderr[-2000:]}")
    out = proc.stdout.splitlines()
    try:
        line = json.loads(out[0]) if len(out) == 1 else None
    except json.JSONDecodeError:
        line = None
    keys = {"metric", "value", "unit", "vs_baseline", "flops_per_step", "mfu"}
    if not isinstance(line, dict) or set(line) != keys:
        fail(f"bench: standard output is not one JSON line with the keys {sorted(keys)}: "
             f"{proc.stdout[-2000:]!r}")
    if line["metric"] != Settings().metric():
        fail(f"bench: metric {line['metric']!r}, expected bench.py's {Settings().metric()!r}")
    if not 0 < line["mfu"] <= 1:
        fail(f"bench: mfu {line['mfu']} outside (0, 1]")
    if line["flops_per_step"] != geom_line["flops_per_step"]:
        fail(f"bench: flops_per_step {line['flops_per_step']} against phase 5's "
             f"{geom_line['flops_per_step']} for the same Config")
    log(json.dumps(line))
    log(f"bench: python3 -m unsupervised_depth_opticalflow_egomotion_torch.bench exited 0 in "
        f"{time.perf_counter() - t0:.1f} s: {line['value']} frames/s against phase 5's "
        f"{geom_line['value']} in process, flops_per_step equal to phase 5's "
        f"({line['flops_per_step']:.6g}) | "
        + next((x for x in proc.stderr.splitlines() if x.startswith("bench: ")), smi))


ABLATE_ITERS = 5  # timed calls of each ablation entry


def phase_ablate(smi: str) -> None:
    """The step ablation (``ablate_step.run``) at full width, after every
    timed run and before the profiles; every launch's signature one that
    phase 3 held."""
    from unsupervised_depth_opticalflow_egomotion_torch import ablate_step

    kernels = _zero_counts()
    rows = ablate_step.run(ABLATE_ITERS)
    unchecked = {n: sorted(k.seen - CHECKED[n]) for n, k in kernels.items() if k.seen - CHECKED[n]}
    if unchecked:
        fail(f"ablate: launches with signatures that the kernels phase did not hold: {unchecked}")
    for r in rows:
        log(f"ablate {r['name']:32s} {r['host_ms']:8.1f} ms host {r['device_ms']:8.1f} ms device")
    log(json.dumps({"ablate": rows, "iters": ABLATE_ITERS, "nvidia_smi": smi}))


def _profile(name, step, batch, step_ms: float, verbose: bool):
    """Device time by kernel and by launching op over two profiled steps;
    the busy share is the kernels' device time over the unprofiled step.
    Returns (device ms per step, kernel launches per step)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = 2
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step(batch)
        torch.cuda.synchronize()
    events = prof.key_averages()
    # a kernel appears twice: as a device event, and in the self device time
    # of the op that launched it; count the device events for the total. A
    # range annotated on the device (the optimizer's step) spans kernels that
    # are counted already, and stretches with the host: leave it out (it
    # bears the name of its host-side range, which no kernel does).
    host_keys = {e.key for e in events if e.device_type == DeviceType.CPU}
    kernels = sorted((e for e in events if e.device_type != DeviceType.CPU
                      and not getattr(e, "is_user_annotation", False)
                      and e.key not in host_keys),
                     key=lambda e: -e.self_device_time_total)
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU),
                 key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    n_launch = sum(e.count for e in kernels) // n
    fname = "profile_" + "".join(c if c.isalnum() else "_" for c in name) + ".txt"
    with open(os.path.join(OUT_DIR, fname), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=80))
    log(f"profile {name}: kernels {busy_ms:.1f} ms/step on the device, {busy_ms / step_ms:.1%} "
        f"of the unprofiled {step_ms:.1f} ms step; {n_launch} kernel launches/step")
    ours = [e for e in kernels if any(
        t in e.key for t in ("warp_gather", "corr_", "ssim_", "splat_"))]
    log(f"  hand-written kernels: {sum(e.self_device_time_total for e in ours) / 1e3 / n:.2f} "
        f"ms/step in {sum(e.count for e in ours) // n} launches")
    if not verbose:
        return busy_ms, n_launch
    for title, rows in (("ops by the device time of their kernels", ops[:12]),
                        ("kernels", kernels[:10])):
        log(f"  {title}:")
        for e in rows:
            log(f"  {e.self_device_time_total / 1e3 / n:8.2f} ms/step  x{e.count // n:<5d} {e.key[:80]}")
    return busy_ms, n_launch


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    import unsupervised_depth_opticalflow_egomotion_torch  # noqa: F401  (fails outside the repo)

    os.makedirs(OUT_DIR, exist_ok=True)
    open(os.path.join(OUT_DIR, "log.txt"), "w").close()
    t_start = time.perf_counter()
    spent = {}  # phase -> seconds

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        spent[name] = time.perf_counter() - t0
        return out

    smi = timed("device", phase_device)
    timed("build", phase_build)
    rows = timed("kernels", phase_kernels)
    timed("parity", phase_parity)
    by_path, lines, ms_geom, profiles = timed("train", phase_train, smi)
    # the runs' directories are large: a temporary one, removed afterwards
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        cli_fps = timed("cli", phase_cli, smi, ms_geom, root)
        by_path["eval_flow"], eval_yaml = timed("eval", phase_eval, smi, root)
        # phase 9's subprocesses and phase 10's spawned ranks, beside phase 8
        tv_procs = _start_two_view_cli(root, eval_yaml)
        dp_ranks = start_dp_ranks(root)
        try:
            timed("synth", phase_synth, root)
            tv_paths, flowpose_profile = timed("two_view", phase_two_view, smi, root, eval_yaml,
                                               tv_procs)
            by_path["dp"] = timed("dp", phase_dp, smi, root, cli_fps, dp_ranks)
        finally:
            _stop(tv_procs)
            stop_dp_ranks(dp_ranks)
        by_path.update(tv_paths)
        timed("bench", phase_bench, smi, lines["geom"])
        timed("ablate", phase_ablate, smi)
        timed("profiles", lambda: (profiles(), flowpose_profile()))
    log("seconds by phase: " + ", ".join(f"{k} {v:.1f}" for k, v in spent.items()))

    table = []
    for name, (kernel, replaces) in path_kernels().items():
        mine = [r for r in rows if r["kernel"] == name]
        paths = {}
        for path in PATHS:
            on_path = [(r, r["per_step"][path]) for r in mine if r["per_step"].get(path)]
            launches, steps = by_path[path]
            # the per-shape rows of phase 3 must account for every launch
            if sum(n for _, n in on_path) * steps != launches[name]:
                fail(f"kernel {name}: the kernels phase attributes {sum(n for _, n in on_path)} "
                     f"launches a step to the {path} path, which made {launches[name]} in {steps}")
            if not on_path:
                continue

            def per_step_sum(key):
                if any(r[key] is None for r, _ in on_path):
                    return None
                return round(sum(r[key] * n for r, n in on_path), 4)

            paths[path] = {
                "launches": launches[name], "steps": steps,
                "ms": per_step_sum("ms"), "device_ms": per_step_sum("device_ms"),
                "plain_ms": per_step_sum("plain_ms"),
                "bound_ms": per_step_sum("bound_ms"),
                "bound_by": max(on_path, key=lambda rn: rn[0]["bound_ms"] * rn[1])[0]["bound_by"],
                "library_ms": per_step_sum("library_ms"),
                "library_device_ms": per_step_sum("library_device_ms"),
            }
        if not paths:
            fail(f"kernel {name} was not launched on any path")
        first = next(iter(paths))
        table.append({
            "name": name, "route": "cuda", "source": kernel.source, "replaces": replaces,
            "path": first, **paths[first],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "by_path": paths,
        })
    log(f"total {time.perf_counter() - t_start:.1f} s; a kernel's launches are those of the "
        "run of its path, and its times are per train step of that path (per batch of 8 "
        "pairs on eval_flow and two_view; each shape's time times its launches a step)")
    log(smi)
    log(json.dumps({"kernels": table}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["dp_torchrun"]:  # phase 10 (b): the process torchrun starts
        _dp_torchrun_worker(*sys.argv[2:])
    elif sys.argv[1:2] == ["eval_cli_2015"]:  # phase 7: the eval CLI for kitti_flow_2015
        _eval_cli_worker(*sys.argv[2:])
    else:
        main()
