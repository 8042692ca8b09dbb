#!/usr/bin/env python3
"""Build and drive the PyTorch port on one NVIDIA GPU; fail on any fault.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with one CUDA card (it
uses card 0). Phases, in order; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi).
2. build: nvcc builds every kernel in
   unsupervised_depth_opticalflow_egomotion_torch/csrc/ for sm_90a, one
   process per source, in parallel.
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes and dtypes of the geom train step (b8, 256x832: the warps and
   cost volumes run on 2B = 16 images), forward and backward, and timed with
   CUDA events beside the plain version, a PyTorch library call where one
   computes the same function, and the least time the card could take.
4. parity: the geom loss pack and one step's gradients with the kernels on
   the card against the plain versions on the CPU, at 64x128 b2 in f32
   (TF32 off), from the same seed.
5. train: the geom train step at b8 256x832 bf16, ssim_impl="xla", on
   uint8 frames: warm-up steps, then timed steps; losses finite, parameters
   moved, every kernel launched. The launch counts are zeroed just before
   this phase and read just after. Prints a frames/s line in bench.py's
   shape, and a short profile of one step.

The last three lines of standard output are the card's name and power
limit, one JSON object with a row per kernel, and
{"ok": true, "device": {...}}. Details (per-shape kernel table, compiler
report, profile) go to chiprun_out/chip_smoke/.
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


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


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
    """The CUDA kernels of the geom step, by name."""
    from unsupervised_depth_opticalflow_egomotion_torch.ops import cost_volume as cv
    from unsupervised_depth_opticalflow_egomotion_torch.ops import warp as wp

    return {"warp_gather": wp.WARP_GATHER, "corr_fwd": cv.CORR_FWD,
            "corr_bwd_df1": cv.CORR_BWD_DF1, "corr_bwd_df2": cv.CORR_BWD_DF2}


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

    from unsupervised_depth_opticalflow_egomotion_torch.ops import cost_volume as cv
    from unsupervised_depth_opticalflow_egomotion_torch.ops import warp as wp

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    rows = []  # one per (kernel, shape)

    # warp: (source dtype, H, W, launches per step); out bf16 as on the path,
    # plus one f32 case with TF32 off (not on the path: checked, not summed)
    cases = [
        ("uint8", 256, 832, 2), ("bfloat16", 128, 416, 2), ("bfloat16", 64, 208, 2),
        ("float32", 256, 832, 0),
    ]
    for sdt, h, w, per_step in cases:
        b = 16
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
        ms = cuda_ms(lambda: wp.warp_gather(src, ix, iy, odt), 20)
        plain_ms = cuda_ms(lambda: wp.warp_gather_plain(src, ix, iy, odt), 3)
        # yardstick, never used by the port: grid_sample of an f32 NCHW copy
        # of the source at the same points (values only; it takes no uint8)
        src_nchw = src.permute(0, 3, 1, 2).float().contiguous()
        grid = torch.stack([ix / (w - 1) * 2 - 1, iy / (h - 1) * 2 - 1], -1)
        lib_ms = cuda_ms(
            lambda: F.grid_sample(src_nchw, grid, mode="bilinear", padding_mode="zeros",
                                  align_corners=True), 20)
        rows.append(dict(
            kernel="warp_gather", shape=f"{sdt}[16,{h},{w},3]->{str(odt)[6:]}",
            per_step=per_step, max_abs_err=max(errs[:2]), deriv_err=errs[2],
            bwd_err=bwd_err, tol=tol, ok=ok, ms=ms, plain_ms=plain_ms,
            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
        ))

    # correlation: the five PWC levels of the 2B decoder batch, bf16
    levels = [(4, 13, 196), (8, 26, 128), (16, 52, 96), (32, 104, 64), (64, 208, 32)]
    cases = [(h, w, c, "bfloat16", 1) for h, w, c in levels] + [(64, 208, 32, "float32", 0)]
    for h, w, c, dts, per_step in cases:
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
                g.data_ptr(), f2.data_ptr(), torch.empty_like(f1).data_ptr(),
                cv.DTYPE_CODE[dt], b, h, w, c, md),
                lambda: cv.correlation_backward_plain(g, f1, f2, md),
                pix * nd * esz + 2 * pix * c * esz),
            "corr_bwd_df2": (df2, p2, lambda: cv.CORR_BWD_DF2(
                g.data_ptr(), f1.data_ptr(), torch.empty_like(f1).data_ptr(),
                cv.DTYPE_CODE[dt], b, h, w, c, md),
                None, pix * nd * esz + 2 * pix * c * esz),
        }
        plain_bwd_ms = cuda_ms(runs["corr_bwd_df1"][3], 3) / 2  # both halves in one call
        for name, (k_out, p_out, k_fn, p_fn, nbytes) in runs.items():
            scale = max(p_out.float().abs().max().item(), 1e-6)
            err = max_err(k_out, p_out)
            b_ms, b_by = bound(nbytes, 2 * macs, dts)
            rows.append(dict(
                kernel=name, shape=f"{dts}[16,{h},{w},{c}]", per_step=per_step,
                max_abs_err=err, tol=rel * scale, ok=err <= rel * scale,
                ms=cuda_ms(k_fn, 20),
                plain_ms=cuda_ms(p_fn, 3) if name == "corr_fwd" else plain_bwd_ms,
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
            ))
    torch.cuda.synchronize()
    with open(os.path.join(OUT_DIR, "kernels.json"), "w") as f:
        json.dump(rows, f, indent=1)
    for r in rows:
        lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"kernel {r['kernel']:13s} {r['shape']:32s} err {r['max_abs_err']:.3g} "
            f"(tol {r['tol']:.3g}) {'ok' if r['ok'] else 'MISMATCH'}  ms {r['ms']:.4f} "
            f"plain {r['plain_ms']:.4f} lib {lib} bound {r['bound_ms']:.4f} ({r['bound_by']})")
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


def phase_parity():
    """Kernels on the card vs plain versions on the CPU, through the whole
    geom step at 64x128 b2 f32 (TF32 off), same weights and batch."""
    import torch

    from unsupervised_depth_opticalflow_egomotion_torch.config import Config
    from unsupervised_depth_opticalflow_egomotion_torch.parallel import init_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config(img_hw=(64, 128), batch_size=2, compute_dtype="float32", ssim_impl="xla")
    res = {}
    for dev in ("cpu", "cuda"):
        model, opt = init_state(cfg, dev)
        metrics = make_train_step(model, cfg, opt)(_batch(2, 64, 128, dev))
        res[dev] = (
            {k: float(v) for k, v in metrics.items()},
            {k: p.grad.detach().float().cpu() for k, p in model.named_parameters()},
        )
    (m_cpu, g_cpu), (m_gpu, g_gpu) = res["cpu"], res["cuda"]
    # the tolerance of tests/test_torch_geom.py: 1e-3 relative + 1e-7 absolute
    loss_ok = all(abs(m_gpu[k] - m_cpu[k]) <= 1e-3 * abs(m_cpu[k]) + 1e-7 for k in m_cpu)
    worst_loss = max(abs(m_gpu[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-7) for k in m_cpu)
    worst_grad = 0.0
    for net in ("depth_net", "pose_net", "fpyramid", "pwc_model"):
        ks = [k for k in g_cpu if k.startswith(net + ".")]
        a = torch.cat([g_gpu[k].flatten() for k in ks])
        b = torch.cat([g_cpu[k].flatten() for k in ks])
        worst_grad = max(worst_grad, ((a - b).norm() / b.norm()).item())
    log(f"parity 64x128 f32 card vs cpu: loss rel err {worst_loss:.3g} (tol 1e-3 + 1e-7 abs), "
        f"gradient rel L2 err {worst_grad:.3g} (tol 2e-2), loss_total {m_gpu['loss_total']:.6f}")
    if not (loss_ok and worst_grad <= 2e-2):
        fail("the card's geom step disagrees with the plain CPU step")


def phase_train(smi: str):
    import torch

    from unsupervised_depth_opticalflow_egomotion_torch.config import Config
    from unsupervised_depth_opticalflow_egomotion_torch.parallel import init_state, make_train_step

    torch.backends.cudnn.benchmark = True
    b, h, w = 8, 256, 832
    cfg = Config(img_hw=(h, w), batch_size=b, compute_dtype="bfloat16", ssim_impl="xla")
    model, opt = init_state(cfg)  # the default device: CUDA
    step = make_train_step(model, cfg, opt)
    batch = _batch(b, h, w, torch.device("cuda"))
    watch = {k: p.detach().clone() for k, p in model.named_parameters()
             if k.endswith(("conv1.weight", "predict_flow2.weight", "pose_conv.weight"))}
    kernels = path_kernels()
    per_step = {"warp_gather": 6, "corr_fwd": 5, "corr_bwd_df1": 5, "corr_bwd_df2": 5}
    warmup, timed = 3, 10
    torch.cuda.reset_peak_memory_stats()

    for k in kernels.values():
        k.launches = 0
    for _ in range(warmup):
        metrics = step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        metrics = step(batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}

    values = {k: float(v) for k, v in metrics.items()}
    if not all(math.isfinite(v) for v in values.values()):
        fail(f"non-finite losses: {values}")
    moved = [k for k, v in watch.items() if not torch.equal(v, dict(model.named_parameters())[k])]
    if len(moved) != len(watch):
        fail(f"parameters did not move: {sorted(set(watch) - set(moved))}")
    want = {n: c * (warmup + timed) for n, c in per_step.items()}
    if launches != want:
        fail(f"kernel launches {launches}, expected {want}")
    fps = timed * b / dt
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    log(f"train: {timed} steps in {dt:.3f} s, {dt / timed * 1e3:.1f} ms/step, "
        f"peak memory {peak_gb:.1f} GiB, losses {json.dumps(values)}")
    log(json.dumps({
        "metric": "frames/sec joint depth+flow+pose fwd-bwd "
        "(b8 256x832 bf16, ssim_impl=xla, PyTorch port)",
        "value": round(fps, 2), "unit": "frames/s/chip",
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "ms_per_step": round(dt / timed * 1e3, 2),
    }))
    _profile(step, batch, dt / timed * 1e3)
    return launches


def _profile(step, batch, step_ms: float):
    """Device time by kernel and by launching op over two profiled steps;
    the busy share is the kernels' device time over the unprofiled step."""
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
    # of the op that launched it; count the device events for the total
    kernels = sorted((e for e in events if e.device_type != DeviceType.CPU),
                     key=lambda e: -e.self_device_time_total)
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU),
                 key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    with open(os.path.join(OUT_DIR, "profile.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=80))
    log(f"profile: kernels {busy_ms:.1f} ms/step on the device, {busy_ms / step_ms:.1%} of the "
        f"unprofiled {step_ms:.1f} ms step; {sum(e.count for e in kernels) // n} kernel launches/step")
    for title, rows in (("ops by the device time of their kernels", ops[:12]),
                        ("kernels", kernels[:8])):
        log(f"  {title}:")
        for e in rows:
            log(f"  {e.self_device_time_total / 1e3 / n:8.2f} ms/step  x{e.count // n:<5d} {e.key[:80]}")


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
    launches = phase_train(smi)

    table = []
    for name, kernel in path_kernels().items():
        on_path = [r for r in rows if r["kernel"] == name and r["per_step"]]
        mine = [r for r in rows if r["kernel"] == name]

        def per_step_sum(key):
            if any(r[key] is None for r in on_path):
                return None
            return round(sum(r[key] * r["per_step"] for r in on_path), 4)

        b_by = max(on_path, key=lambda r: r["bound_ms"] * r["per_step"])["bound_by"]
        table.append({
            "name": name, "route": "cuda", "source": kernel.source,
            "replaces": {
                "warp_gather": "unsupervised_depth_opticalflow_egomotion_tpu/ops/pallas/warp_window.py:166",
                "corr_fwd": "unsupervised_depth_opticalflow_egomotion_tpu/ops/pallas/correlation_fused.py:38",
                "corr_bwd_df1": "unsupervised_depth_opticalflow_egomotion_tpu/ops/pallas/correlation_fused.py:52",
                "corr_bwd_df2": "unsupervised_depth_opticalflow_egomotion_tpu/ops/pallas/correlation_fused.py:65",
            }[name],
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": per_step_sum("ms"), "plain_ms": per_step_sum("plain_ms"),
            "bound_ms": per_step_sum("bound_ms"), "bound_by": b_by,
            "library_ms": per_step_sum("library_ms"),
        })
    log(f"total {time.perf_counter() - t_start:.1f} s; kernel times are per train step "
        "(each shape times its launches per step)")
    log(smi)
    log(json.dumps({"kernels": table}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
