"""The port's benchmark entry point against the repository's ``bench.py``, and
its FLOP count, on the CPU.

- For a table of ``BENCH_*`` settings, ``bench.py``'s ``main()`` runs with
  the JAX package's ``init_state``, ``make_optimizer`` and
  ``make_train_step`` replaced (no JAX compile: the step records its batch)
  and ``jax.config.update`` made a no-op (no compile cache is pointed
  anywhere); the port's settings must give the same ``Config`` field by
  field, the same batch bit for bit and the same metric string.
- ``run`` at 64x128 b2 f32 through the kernels' plain versions: one line
  with ``bench.py``'s keys, no ``mfu`` (no peak for a CPU), a finite loss.
- The FLOP count: the same under every route of the kernels' functions and
  with or without ``encoder_int8``; the kernels' share is the hand-computed
  formula of each function at one shape; a convolution counts 2 x its
  multiply-adds forward and again for each gradient; the int8 conv's GEMM
  2 M N K at the conv's own K, counted once.
"""

import dataclasses
import importlib.util
import json
import math
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import unsupervised_depth_opticalflow_egomotion_tpu.parallel as jparallel
from unsupervised_depth_opticalflow_egomotion_torch import bench
from unsupervised_depth_opticalflow_egomotion_torch.config import Config
from unsupervised_depth_opticalflow_egomotion_torch.models.layers import Conv
from unsupervised_depth_opticalflow_egomotion_torch.ops import flops
from unsupervised_depth_opticalflow_egomotion_torch.ops import int8_conv as ti8
from unsupervised_depth_opticalflow_egomotion_torch.ops.cost_volume import correlation
from unsupervised_depth_opticalflow_egomotion_torch.ops.splat import occlusion_mask_from_flow
from unsupervised_depth_opticalflow_egomotion_torch.ops.ssim import ssim
from unsupervised_depth_opticalflow_egomotion_torch.ops.warp import WarpRoute, grid_sample_with_weight

pytestmark = pytest.mark.quick
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(img_hw=(64, 128), batch_size=2, compute_dtype="float32")

SETTINGS = {
    "default": {},
    "flow splat": {"BENCH_MODE": "flow", "BENCH_FLOW_OCC": "splat"},
    "depth": {"BENCH_MODE": "depth"},
    "loss scale 1": {"BENCH_LOSS_SCALE": "1"},
    "warp pallas": {"BENCH_WARP_IMPL": "pallas"},
    "warp bf16 off": {"BENCH_WARP_BF16": "0"},
    "int8": {"BENCH_INT8": "1"},
    "packed encoder": {"BENCH_PACKED_ENCODER": "1"},
    "batch 2": {"BENCH_BATCH": "2"},
}


def _jax_bench():
    spec = importlib.util.spec_from_file_location("_repo_bench", REPO / "bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", list(SETTINGS))
def test_settings_config_batch_metric_match_jax_bench(name, monkeypatch, capsys):
    for var in ("BENCH_BATCH", "BENCH_MODE", "BENCH_FLOW_OCC", "BENCH_LOSS_SCALE",
                "BENCH_WARP_IMPL", "BENCH_WARP_BF16", "BENCH_PACKED_ENCODER",
                "BENCH_PACKED_STEM", "BENCH_WARP_GUARD", "BENCH_INT8"):
        monkeypatch.delenv(var, raising=False)
    for var, value in SETTINGS[name].items():
        monkeypatch.setenv(var, value)
    seen = {}

    def init_state(cfg, key):
        seen["cfg"] = cfg
        return None, types.SimpleNamespace(params=None)

    def make_train_step(model, cfg, tx):
        def step(state, batch, key):
            seen["batch"] = [np.asarray(x) for x in batch]
            return state, {"loss_total": np.float32(0.0)}
        return step

    monkeypatch.setattr(jparallel, "init_state", init_state)
    monkeypatch.setattr(jparallel, "make_optimizer", lambda cfg, params: None)
    monkeypatch.setattr(jparallel, "make_train_step", make_train_step)
    monkeypatch.setattr(jax.config, "update", lambda *args, **kw: None)
    _jax_bench().main()
    want_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    settings = bench.Settings.from_env()
    cfg = settings.config()
    got, want = dataclasses.asdict(cfg), dataclasses.asdict(seen["cfg"])
    assert list(got) == list(want)
    for field, value in want.items():
        assert got[field] == value, field
    batch = bench.make_batch(cfg.batch_size, *cfg.img_hw, "cpu")
    assert len(batch) == len(seen["batch"]) == 3
    for g, w in zip(batch, seen["batch"]):
        assert g.numpy().dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g.numpy(), w)
    assert settings.metric() == want_line["metric"]


@pytest.mark.parametrize("settings", [bench.Settings(), bench.Settings(mode="flow", flow_occ="splat"),
                                      bench.Settings(mode="depth")], ids=["geom", "flow", "depth"])
def test_run_on_cpu(settings):
    """One line with bench.py's keys; flops counted, no mfu on a CPU."""
    cfg = settings.config().replace(**SMALL)
    b = bench.Bench(cfg, "cpu")
    line = bench.run(b, settings.metric(), iters=1)
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "flops_per_step"}
    assert line["metric"] == settings.metric() and line["unit"] == "frames/s/chip"
    assert line["value"] > 0 and line["flops_per_step"] > 0
    assert math.isfinite(float(b.metrics["loss_total"]))
    assert b.steps == 1 + bench.WARMUP_STEPS + 1
    assert set(bench.run(b, settings.metric(), iters=1, count_flops=False)) == {
        "metric", "value", "unit", "vs_baseline"}


def test_entry_point_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main()


def _count(**kw) -> tuple[int, int]:
    return bench.Bench(Config(**{**SMALL, "batch_size": 1, **kw}), "cpu").count_flops()


def test_flops_equal_across_routes_and_int8():
    """The geom step's count under every warp_impl x ssim_impl x pwc_corr,
    and under encoder_int8 (the im2col int8 product does the conv's
    multiply-adds), is the default's."""
    want = _count()
    assert want[0] > 0 and want[1] > 0
    for warp_impl in ("pallas_fused", "pallas", "xla"):
        for ssim_impl in ("pallas", "xla"):
            for pwc_corr in ("fused", "pallas", "xla"):
                got = _count(warp_impl=warp_impl, ssim_impl=ssim_impl, pwc_corr=pwc_corr)
                assert got == want, (warp_impl, ssim_impl, pwc_corr)
    assert _count(encoder_int8=True) == want
    assert _count(warp_bf16=False) == want


def _rand(*shape, gen, grad=False):
    return torch.rand(*shape, generator=gen).requires_grad_(grad)


@pytest.mark.parametrize("function", ["correlation", "ssim", "warp", "splat"])
def test_kernel_share_is_the_formula(function):
    """Each function at one shape, forward and backward, by hand: the
    correlation's in-frame shifts at 8x16 with md 4 are
    (9 x 8 - 20) x (9 x 16 - 20) = 52 x 124."""
    gen = torch.Generator().manual_seed(0)
    with flops.counting() as got:
        if function == "correlation":  # B 2, C 4; df1 and df2
            for impl in ("fused", "pallas", "xla"):
                f1, f2 = _rand(2, 8, 16, 4, gen=gen, grad=True), _rand(2, 8, 16, 4, gen=gen, grad=True)
                correlation(f1, f2, 4, impl).sum().backward()
            one = 2 * 2 * (52 * 124) * 4
            want = {"correlation": 3 * one, "correlation backward": 3 * 2 * one}
        elif function == "ssim":  # [2, 8, 16, 3]; the target takes no gradient
            for impl in ("pallas", "xla"):
                x, y = _rand(2, 8, 16, 3, gen=gen, grad=True), _rand(2, 8, 16, 3, gen=gen)
                ssim(x, y, impl).sum().backward()
            n = 2 * 8 * 16 * 3
            want = {"ssim": 2 * 70 * n, "ssim backward": 2 * 150 * n}
        elif function == "warp":  # uint8 [2, 8, 16, 3] at [2, 6, 10] points
            src = torch.randint(0, 256, (2, 8, 16, 3), generator=gen, dtype=torch.uint8)
            for impl in ("pallas_fused", "pallas", "xla"):
                coords = (2 * _rand(2, 6, 10, 2, gen=gen) - 1).requires_grad_(True)
                rgb, wsum = grid_sample_with_weight(src, coords, route=WarpRoute(impl))
                (rgb.float().sum() + wsum.float().sum()).backward()
                # a feature map is no data source: not the kernels' function
                feat = _rand(2, 8, 16, 3, gen=gen, grad=True)
                grid_sample_with_weight(feat, coords.detach(), route=WarpRoute(impl))[0].sum().backward()
            with torch.no_grad():  # no backward without a graph
                grid_sample_with_weight(src, coords)
            n = 2 * 6 * 10
            want = {"warp": 4 * 60 * n, "warp backward": 3 * 90 * n}
        else:  # bilinear splat of a [2, 8, 16, 2] flow, both routes; no backward
            flow = 4 * _rand(2, 8, 16, 2, gen=gen, grad=True) - 2
            for taps in ("bilinear", "bilinear_xla", "nearest"):
                occlusion_mask_from_flow(flow, taps)
            want = {"splat": 2 * 20 * 2 * 8 * 16}
    assert got.by_function == want
    assert not flops.active()


@pytest.mark.parametrize("input_grad", [False, True])
def test_conv_counts_twice_its_macs_each_way(input_grad):
    conv = Conv(5, 7, kernel=3, stride=2, padding=1, bias=False)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.rand(2, 16, 24, 5).requires_grad_(input_grad)
    macs = 2 * 8 * 12 * 7 * 5 * 3 * 3  # [2, 8, 12] outputs, 7 channels, 5 x 3 x 3 taps
    with FlopCounterMode(display=False) as fwd:
        y = conv(x)
    with FlopCounterMode(display=False) as bwd:
        y.sum().backward()
    assert fwd.get_total_flops() == 2 * macs
    assert bwd.get_total_flops() == 2 * macs * (2 if input_grad else 1)


def test_int8_conv_counts_its_own_k():
    """The 7x7 stem's int8 GEMM (K = 7 x 7 x 3 = 147, which the card pads to
    152) is 2 M N K at K = 147: ``gemm_flops`` (the card route's count) and
    ``FlopCounterMode``'s count of the plain route, which adds nothing to
    ``ops/flops.py``'s (counted once)."""
    gen = torch.Generator().manual_seed(0)
    xq = torch.randint(-127, 128, (2, 16, 24, 3), generator=gen, dtype=torch.int8)
    wq = torch.randint(-127, 128, (8, 3, 7, 7), generator=gen, dtype=torch.int8)
    want = 2 * (2 * 8 * 12) * 8 * 147
    assert ti8.gemm_flops(xq, wq, 2, 3) == want
    with FlopCounterMode(display=False, custom_mapping=bench.MATRIX_MAPPING) as matrix, \
            flops.counting() as kernels:
        acc = ti8.conv_i32(xq, wq, 2, 3)
    assert acc.shape == (2, 8, 12, 8)
    assert matrix.get_total_flops() == want and kernels.by_function == {}
