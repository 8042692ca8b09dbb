#!/usr/bin/env python3
"""Build and drive the PyTorch port on one NVIDIA GPU; fail on any fault.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with one CUDA card (it
uses card 0). Phases, in order; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi).
2. build: nvcc builds every kernel in
   unsupervised_depth_opticalflow_egomotion_torch/csrc/ for sm_90a, one
   process per source, in parallel.
3. kernels: each of the nine kernels against its plain PyTorch version on
   the card, at every shape and dtype that the train steps of phase 5 give
   it (b8, 256x832: the geom and flow warps and the cost volumes run on
   2B = 16 images, the depth warps, the SSIM maps and the splats on 8),
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
   hold against the plain version.
4. parity: one train step with the kernels on the card against the plain
   versions on the CPU, at 64x128 b2 in f32 (TF32 off), from the same seed:
   the geom step under the default Config, a flow step under
   flow_occ_impl="splat" and a depth step.
5. train: the train steps at b8 256x832 bf16 on uint8 frames. The geom step
   under the default Config (warm-up, then timed steps, a frames/s line in
   bench.py's shape, a short profile of one step); the same step under
   ssim_impl="xla" (timed in the same call, for comparison); the flow step
   under flow_occ_impl="splat" (timed, its own frames/s line and profile)
   and under the default "splat_nn"; the depth step (timed briefly, and
   profiled); the geom step under warp_impl="pallas", pwc_corr="pallas". Every run zeroes the launch
   counts just before and reads them just after, and checks finite losses,
   moved parameters of the networks the mode trains, bit-equal parameters of
   the others, the exact launch count of every kernel, and that every
   launch had a signature checked in phase 3.

The last three lines of standard output are the card's name and power
limit, one JSON object with a row per kernel (its launches, times, device
times and bound on the first of the paths geom, flow, depth, geom_regather
that launches it, named in "path", and the same for every path under
"by_path"), and
{"ok": true, "device": {...}}. Details (per-shape kernel table, compiler
report, profiles) go to chiprun_out/chip_smoke/.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense FLOP/s by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "uint8": 67e12}
OUT_DIR = os.path.join("chiprun_out", "chip_smoke")
WARP_FLOPS_PER_PIXEL = 105  # tap weights, 3 values, 6 derivatives, weight sum
WARP_NOGRAD_FLOPS_PER_PIXEL = 60  # tap weights, 3 values, weight sum
WARP_BWD_FLOPS_PER_PIXEL = 90  # tap weights, 6 derivatives contracted, weight-sum term
SSIM_FWD_FLOPS = 70  # per element: five 9-tap sums, the map
SSIM_BWD_FLOPS = 150  # per element: the statistics again, four planes, four 9-tap sums
SPLAT_FLOPS_PER_PIXEL = 20
_TPU = "unsupervised_depth_opticalflow_egomotion_tpu/ops/pallas/"
# the train paths of phase 5 that the kernel table reports, in the order in
# which a kernel's row picks its path; geom_regather is the geom step under
# warp_impl="pallas", pwc_corr="pallas"
PATHS = ("geom", "flow", "depth", "geom_regather")
CHECKED: dict[str, set] = {}  # kernel -> launch signatures held in phase 3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


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


def valid_shifts(h: int, w: int, md: int) -> int:
    """Shift-pixel pairs of the cost volume that land inside the frame."""
    return sum(h - abs(d) for d in range(-md, md + 1)) * sum(
        w - abs(d) for d in range(-md, md + 1)
    )


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def path_kernels():
    """The nine CUDA kernels of the train steps, by name: (kernel, the TPU
    kernel it replaces)."""
    from unsupervised_depth_opticalflow_egomotion_torch.ops import cost_volume as cv
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


def phase_kernels():
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F

    from unsupervised_depth_opticalflow_egomotion_torch.kernel_times import splat_flow
    from unsupervised_depth_opticalflow_egomotion_torch.ops import cost_volume as cv
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
    # f32 case with TF32 off (on no path: checked, not summed).
    both = {"geom": 2, "flow": 1}
    cases = [
        ("uint8", 16, 256, 832, both), ("bfloat16", 16, 128, 416, both),
        ("bfloat16", 16, 64, 208, both), ("bfloat16", 16, 32, 104, {"flow": 1}),
        ("bfloat16", 8, 256, 832, {"depth": 2}), ("bfloat16", 8, 128, 416, {"depth": 2}),
        ("bfloat16", 8, 64, 208, {"depth": 2}),
        ("float32", 16, 256, 832, {}),
    ]
    for sdt, b, h, w, per_step in cases:
        regather = {"geom_regather": per_step["geom"]} if "geom" in per_step else {}
        u8 = torch.randint(0, 256, (b, h, w, 3), generator=gen, dtype=torch.uint8)
        src = u8.to(dev) if sdt == "uint8" else (u8.float() / 255.0).to(dev, getattr(torch, sdt))
        odt = torch.float32 if sdt == "float32" else torch.bfloat16
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
        b_ms, b_by = bound(nbytes, WARP_FLOPS_PER_PIXEL * n, "float32")
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
                           WARP_NOGRAD_FLOPS_PER_PIXEL * n, "float32")
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
                           WARP_BWD_FLOPS_PER_PIXEL * n, "float32")
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

    # correlation: the five PWC levels of the 2B decoder batch, bf16; f32
    # checks (on no path) at the finest level and at the coarsest, where the
    # tiles' last channel chunk is partial and pixel rows are 8-byte aligned
    levels = [(4, 13, 196), (8, 26, 128), (16, 52, 96), (32, 104, 64), (64, 208, 32)]
    cases = [(h, w, c, "bfloat16", True) for h, w, c in levels] + [
        (64, 208, 32, "float32", False), (4, 13, 196, "float32", False)]
    for h, w, c, dts, on_path in cases:
        b, md, nd = 16, 4, 81
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
        macs = b * valid_shifts(h, w, md) * c
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
            b_ms, b_by = bound(nbytes, 2 * macs, dts)
            rows.append(dict(
                kernel=name, shape=f"{dts}[16,{h},{w},{c}]",
                # pwc_corr="pallas" launches the forward kernel only
                per_step=({"geom": 1, "flow": 1, **({"geom_regather": 1} if name == "corr_fwd" else {})}
                          if on_path else {}),
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
    three = {"geom": 2, "flow": 2, "geom_regather": 2}
    cases = [(256, 832, 3, "bfloat16", three), (128, 416, 3, "bfloat16", three),
             (64, 208, 3, "bfloat16", three), (256, 832, 3, "float32", {}),
             (64, 208, 5, "bfloat16", {})]
    for h, w, c, dts, per_step in cases:
        b, dt = 8, getattr(torch, dts)
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
        fb_ms, fb_by = bound(3 * n * esz, SSIM_FWD_FLOPS * n, "float32")
        bb_ms, bb_by = bound(5 * n * esz, SSIM_BWD_FLOPS * n, "float32")
        s_fn = lambda: ss.ssim_forward(x, y)  # noqa: E731
        b_fn = lambda: ss.ssim_backward(x, y, g)  # noqa: E731
        rows.append(dict(
            kernel="ssim_fwd", shape=f"{dts}[8,{h},{w},{c}]", per_step=per_step,
            max_abs_err=err_s, ring_err=ring_s, tol=tol_s, ok=err_s <= tol_s and ring_s <= tol_s,
            ms=cuda_ms(s_fn, 20), device_ms=graph_ms(s_fn),
            plain_ms=cuda_ms(lambda: ss.ssim_plain(x, y), 3),
            library_ms=None, library_device_ms=None, bound_ms=fb_ms, bound_by=fb_by,
        ))
        rows.append(dict(
            kernel="ssim_bwd", shape=f"{dts}[8,{h},{w},{c}]", per_step=per_step,
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
    two = {"flow": 2}
    cases = [(256, 832, "bfloat16", two, "random"), (128, 416, "bfloat16", two, "random"),
             (64, 208, "bfloat16", two, "random"), (32, 104, "bfloat16", two, "random"),
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
        b_ms, b_by = bound(n * 3 * flow.element_size(), SPLAT_FLOPS_PER_PIXEL * n, "float32")
        sp_fn = lambda: sp.splat_mass(flow)  # noqa: E731
        rows.append(dict(
            kernel="splat_mass", shape=f"{dts}[8,{h},{w},2] {kind}",
            per_step=per_step, max_abs_err=err, tol=tol,
            ok=err <= tol and (scale > 1.5 or kind in ("smooth", "zero")),
            ms=cuda_ms(sp_fn, 20), device_ms=graph_ms(sp_fn),
            plain_ms=cuda_ms(lambda: sp.splat_mass_plain(flow), 3),
            library_ms=None, library_device_ms=None, bound_ms=b_ms, bound_by=b_by,
        ))

    torch.cuda.synchronize()
    for name, (k, _) in path_kernels().items():
        CHECKED[name] = set(k.seen)
    with open(os.path.join(OUT_DIR, "kernels.json"), "w") as f:
        json.dump(rows, f, indent=1)
    for r in rows:
        lib = "-" if r["library_ms"] is None else (
            f"{r['library_ms']:.4f} (device {r['library_device_ms']:.4f})")
        tol = f"{r['tol']:.3g}"
        if r.get("rtol"):
            tol += f" + {r['rtol']:g} |ref| by element, worst ratio {r['tol_ratio']:.3g}"
        log(f"kernel {r['kernel']:18s} {r['shape']:34s} err {r['max_abs_err']:.3g} "
            f"(tol {tol}) {'ok' if r['ok'] else 'MISMATCH'}  ms {r['ms']:.4f} "
            f"device {r['device_ms']:.4f} plain {r['plain_ms']:.4f} lib {lib} "
            f"bound {r['bound_ms']:.4f} ({r['bound_by']})")
    bad = [f"{r['kernel']} {r['shape']}" for r in rows if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    return rows


def _batch(b, h, w, dev, seed=0):
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    images = torch.from_numpy((rng.rand(b, 3 * h, w, 3) * 255).astype(np.uint8))
    K = np.array([[241.0, 0, w / 2], [0, 245.0, h / 2], [0, 0, 1]], np.float32)
    K_ms = np.stack([np.diag([1 / 2**s, 1 / 2**s, 1.0]).astype(np.float32) @ K for s in range(3)])
    K_inv_ms = np.stack([np.linalg.inv(k) for k in K_ms]).astype(np.float32)
    tile = lambda x: torch.from_numpy(np.tile(x[None], (b, 1, 1, 1)))  # noqa: E731
    return tuple(t.to(dev) for t in (images, tile(K_ms), tile(K_inv_ms)))


NETS = {"flow": ("fpyramid", "pwc_model"), "depth": ("depth_net", "pose_net"),
        "geom": ("depth_net", "pose_net", "fpyramid", "pwc_model")}


def phase_parity():
    """Kernels on the card vs plain versions on the CPU, through one whole
    train step at 64x128 b2 f32 (TF32 off), same weights and batch: the geom
    step under the default Config, a flow step ("splat") and a depth step."""
    import torch

    from unsupervised_depth_opticalflow_egomotion_torch.config import Config
    from unsupervised_depth_opticalflow_egomotion_torch.parallel import init_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for kw in ({"mode": "geom"}, {"mode": "flow", "flow_occ_impl": "splat"}, {"mode": "depth"}):
        cfg = Config(img_hw=(64, 128), batch_size=2, compute_dtype="float32", **kw)
        res = {}
        for dev in ("cpu", "cuda"):
            model, opt = init_state(cfg, dev)
            metrics = make_train_step(model, cfg, opt)(_batch(2, 64, 128, dev))
            res[dev] = (
                {k: float(v) for k, v in metrics.items()},
                {k: p.grad.detach().float().cpu() for k, p in model.named_parameters()
                 if p.grad is not None},
            )
        (m_cpu, g_cpu), (m_gpu, g_gpu) = res["cpu"], res["cuda"]
        # the tolerance of tests/test_torch_geom.py: 1e-3 relative + 1e-7 absolute
        loss_ok = all(abs(m_gpu[k] - m_cpu[k]) <= 1e-3 * abs(m_cpu[k]) + 1e-7 for k in m_cpu)
        worst_loss = max(abs(m_gpu[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-7) for k in m_cpu)
        worst_grad = 0.0
        for net in NETS[cfg.mode]:
            ks = [k for k in g_cpu if k.startswith(net + ".")]
            a = torch.cat([g_gpu[k].flatten() for k in ks])
            b = torch.cat([g_cpu[k].flatten() for k in ks])
            worst_grad = max(worst_grad, ((a - b).norm() / b.norm()).item())
        same_nets = set(g_cpu) == set(g_gpu)
        log(f"parity {cfg.mode} 64x128 f32 card vs cpu: loss rel err {worst_loss:.3g} "
            f"(tol 1e-3 + 1e-7 abs), gradient rel L2 err {worst_grad:.3g} (tol 2e-2), "
            f"loss_total {m_gpu['loss_total']:.6f}")
        if not (loss_ok and worst_grad <= 2e-2 and same_nets):
            fail(f"the card's {cfg.mode} step disagrees with the plain CPU step")


WATCH = {"depth_net": "depth_net.encoder.encoder.conv1.weight",
         "pose_net": "pose_net.pose_conv.weight",
         "fpyramid": "fpyramid.conv1.0.weight", "pwc_model": "pwc_model.predict_flow2.weight"}


def _start(name, overrides):
    """Model, optimizer and batch of Config(b8 256x832 bf16, **overrides) on
    uint8 frames, on the default device (CUDA)."""
    import torch

    from unsupervised_depth_opticalflow_egomotion_torch.config import Config
    from unsupervised_depth_opticalflow_egomotion_torch.parallel import init_state, make_train_step

    b, h, w = 8, 256, 832
    cfg = Config(img_hw=(h, w), batch_size=b, **overrides)
    if cfg.compute_dtype != "bfloat16":
        fail("the train phase expects the default compute_dtype, bfloat16")
    model, opt = init_state(cfg)
    return {
        "name": name, "cfg": cfg, "model": model, "step": make_train_step(model, cfg, opt),
        "batch": _batch(b, h, w, torch.device("cuda")),
        "before": {k: p.detach().clone() for k, p in model.named_parameters()},
    }


def _drive(run, per_step, warmup, timed):
    """``warmup + timed`` train steps of ``run``. The launch counts are zeroed
    just before and read just after; checks finite losses, moved parameters
    of the networks the mode trains, bit-equal parameters of the others, and
    the exact launch count of every kernel (``per_step``: kernel -> launches
    a step; the others must stay at zero), and that every launch had a
    signature that phase 3 held against the plain version. Returns
    (launches, ms per step or None, peak GiB)."""
    import torch

    name, step, batch = run["name"], run["step"], run["batch"]
    kernels = {n: k for n, (k, _) in path_kernels().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
        k.seen.clear()
    for _ in range(warmup):
        metrics = step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        metrics = step(batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
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
    want = {n: per_step.get(n, 0) * (warmup + timed) for n in kernels}
    if launches != want:
        fail(f"{name}: kernel launches {launches}, expected {want}")
    unchecked = {n: sorted(k.seen - CHECKED[n]) for n, k in kernels.items() if k.seen - CHECKED[n]}
    if unchecked:
        fail(f"{name}: launches with signatures (dtype codes, sizes) that the kernels phase "
             f"did not hold against the plain version: {unchecked}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    ms = dt / timed * 1e3 if timed else None
    timing = f"{timed} timed steps, {ms:.1f} ms/step, " if timed else ""
    log(f"train {name}: {warmup + timed} steps, {timing}peak memory {peak_gb:.2f} GiB, "
        f"launches/step {json.dumps(per_step)}, losses {json.dumps(values)}")
    return launches, ms, peak_gb


def _metric_line(metric, ms, smi):
    import torch

    log(json.dumps({
        "metric": metric, "value": round(8 / ms * 1e3, 2), "unit": "frames/s/chip",
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "ms_per_step": round(ms, 2),
    }))


def phase_train(smi: str):
    """Every train path at full width. All timed runs come before the first
    profile: profiling slows the host side of the steps that come after it.
    The two geom configurations are timed in turns (default, xla, xla,
    default) so that host drift within the call shows."""
    import torch

    torch.backends.cudnn.benchmark = True
    corr = {"corr_fwd": 5, "corr_bwd_df1": 5, "corr_bwd_df2": 5}
    ssim = {"ssim_fwd": 6, "ssim_bwd": 6}
    by_path = {}  # path -> (launches by kernel, steps) of its first run

    def drive(run, per_step, warmup, timed, path=None):
        launches, ms, peak = _drive(run, per_step, warmup, timed)
        if path is not None:
            by_path[path] = (launches, warmup + timed)
        return ms, peak

    geom_k = {"warp_gather": 6, **corr, **ssim}
    xla_k = {"warp_gather": 6, **corr}
    geom = _start("geom default", {})
    xla = _start("geom ssim_impl=xla", {"ssim_impl": "xla"})
    ms_g, gb_g = drive(geom, geom_k, 3, 10, "geom")
    _metric_line("frames/sec joint depth+flow+pose fwd-bwd (b8 256x832 bf16, PyTorch port)",
                 ms_g, smi)
    ms_x, gb_x = drive(xla, xla_k, 3, 10)
    ms_x2, _ = drive(xla, xla_k, 0, 5)
    ms_g2, _ = drive(geom, geom_k, 0, 5)

    flow_k = {"warp_gather": 4, **corr, **ssim, "splat_mass": 8}
    flow = _start("flow splat", {"mode": "flow", "flow_occ_impl": "splat"})
    ms_f, _ = drive(flow, flow_k, 3, 5, "flow")
    _metric_line("frames/sec flow-mode fwd-bwd (b8 256x832 bf16, flow_occ_impl=splat, "
                 "PyTorch port)", ms_f, smi)
    depth = _start("depth", {"mode": "depth"})
    ms_d, _ = drive(depth, {"warp_gather": 6}, 2, 3, "depth")
    for name, path, overrides, per_step in (
        ("flow splat_nn", None, {"mode": "flow"}, {"warp_gather": 4, **corr, **ssim}),
        ("geom warp_impl=pallas pwc_corr=pallas", "geom_regather",
         {"warp_impl": "pallas", "pwc_corr": "pallas"},
         {"warp_gather_nograd": 6, "warp_gather_bwd": 6, "corr_fwd": 5, **ssim}),
    ):
        run = _start(name, overrides)
        drive(run, per_step, 2, 0, path)
        del run
        torch.cuda.empty_cache()

    dev_g, n_g = _profile(geom["name"], geom["step"], geom["batch"], ms_g, verbose=True)
    dev_x, n_x = _profile(xla["name"], xla["step"], xla["batch"], ms_x, verbose=False)
    _profile(flow["name"], flow["step"], flow["batch"], ms_f, verbose=True)
    _profile(depth["name"], depth["step"], depth["batch"], ms_d, verbose=False)
    log(f"geom step, ssim_impl=pallas vs xla in this call: {ms_g:.1f} vs {ms_x:.1f} ms/step "
        f"(10 timed steps each), then {ms_g2:.1f} vs {ms_x2:.1f} (5 each, in the other order); "
        f"{n_g} vs {n_x} kernel launches/step, device time {dev_g:.1f} vs {dev_x:.1f} ms/step, "
        f"peak memory {gb_g:.2f} vs {gb_x:.2f} GiB")
    return by_path


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
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    rows = phase_kernels()
    phase_parity()
    by_path = phase_train(smi)

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
            fail(f"kernel {name} was not launched on any train path")
        first = next(iter(paths))
        table.append({
            "name": name, "route": "cuda", "source": kernel.source, "replaces": replaces,
            "path": first, **paths[first],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "by_path": paths,
        })
    log(f"total {time.perf_counter() - t_start:.1f} s; a kernel's launches are those of the "
        "run of its path, and its times are per train step of that path (each shape's time "
        "times its launches a step)")
    log(smi)
    log(json.dumps({"kernels": table}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
