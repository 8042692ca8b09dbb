"""A whole run of each cell on the CPU at 64x128, b8, through the port's
plain kernel routes; the reference against the port; the check's faults;
and the imports a run leaves loaded.

The port runs here in f32 (``compute_dtype``), so that a sound run reads
far inside the cell's limits and a broken one far outside them; the cells
themselves run bf16 on the card, where the limits were read.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import calibrate, check, feeds, harness
from portbench.reference.step import reference_steps

ROOT = Path(harness.__file__).resolve().parents[1]
CELLS = ("geom-b8", "flow-b8", "depth-b8")
SEED = 12  # the seed the loss-pack tolerance below was read at


def tiny(name: str):
    cell = harness.load_cell(name)
    cell.cfg = dict(cell.cfg, img_hw=[64, 128], compute_dtype="float32")
    cell.traffic = dict(cell.traffic, pool_batches=3)
    return cell


@pytest.mark.parametrize("name", CELLS)
def test_reference_loss_pack_and_gradients_match_the_port(name):
    from unsupervised_depth_opticalflow_egomotion_torch.parallel.train_step import _forward

    cell = tiny(name)
    dev = torch.device("cpu")
    weights = harness.make_weights(harness.parameter_shapes(cell.reference, cell.cfg), SEED, dev)
    batch = feeds.make_feed(cell.traffic, cell.cfg, SEED, dev).batch(0)
    model, _, _ = harness.build_program(cell.cfg, weights, dev)
    ref = cell.reference(cell.cfg)
    ref.load_state_dict(weights, strict=False)
    ref.train()
    mine, theirs = _forward(model, harness.port_config(cell.cfg), batch), ref.loss_pack(*batch)
    assert set(mine) == set(theirs)
    w = ref.weights()
    for k in theirs:
        # hard masks (occlusion, texture, dynamic, the frame's border) flip a
        # few of the 8192 pixels at f32 rounding: a few 1e-3 of a term here
        torch.testing.assert_close(mine[k].float(), theirs[k], rtol=1e-2, atol=1e-7)
    sum(w[k] * v.mean() for k, v in mine.items()).backward()
    sum(w[k] * v.mean() for k, v in theirs.items()).backward()
    p_ref = dict(ref.named_parameters())
    for k, p in model.named_parameters():
        if p.grad is None:
            assert p_ref[k].grad is None, k
            continue
        g, r = p.grad, p_ref[k].grad
        assert (g - r).norm() <= 2e-2 * r.norm() + 1e-9, k


@pytest.mark.parametrize("name", CELLS)
def test_a_run_is_correct_and_reports_its_metrics(name):
    cell = tiny(name)
    out = harness.run(cell, SEED, 0.3, False, time.perf_counter(), device="cpu")
    assert out["correct"], out["check"]
    assert list(out)[-1] == "check"
    assert {"frames_per_s", "setup_s"} <= set(out["metrics"])
    assert set(out["check"]) == set(cell.limits) | {"window_loss_finite"}


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_step_comes_out_not_correct(name, fault, monkeypatch):
    cell = tiny(name)

    def broken(model, cfg, optimizer, group=None):
        step = harness_make_train_step(model, cfg, optimizer, group)
        if fault == "half_batch":
            return calibrate.half_batch(step)
        return calibrate.unchanged(model, cell.cfg)

    harness_make_train_step = harness.make_train_step
    monkeypatch.setattr(harness, "make_train_step", broken)
    out = harness.run(cell, SEED, 0.3, False, time.perf_counter(), device="cpu")
    assert not out["correct"], out["check"]


def test_the_check_reads_a_state_left_unchanged_as_one():
    ref = {"losses": [1.0, 0.9], "names": ["a", "b"], "grad": torch.tensor([1.0, 2.0]),
           "change": torch.tensor([0.1, 0.2]), "bn_names": [], "bn_change": torch.zeros(0)}
    mine = {"losses": [1.0, 1.0], "names": [], "grad": torch.zeros(0), "change": torch.zeros(0),
            "bn_names": [], "bn_change": torch.zeros(0)}
    got = check.readings(mine, ref)
    assert got["grad_gap"] == 1.0 and got["change_gap"] == 1.0


@pytest.mark.parametrize("name", CELLS)
def test_reference_steps_are_deterministic(name):
    cell = tiny(name)
    dev = torch.device("cpu")
    weights = harness.make_weights(harness.parameter_shapes(cell.reference, cell.cfg), SEED, dev)
    batches = feeds.make_feed(cell.traffic, cell.cfg, SEED, dev).checked(2)
    a = reference_steps(cell.reference, cell.cfg, weights, batches, dev)
    b = reference_steps(cell.reference, cell.cfg, weights, batches, dev)
    assert a["losses"] == b["losses"] and torch.equal(a["grad"], b["grad"])


def test_a_run_loads_no_jax():
    code = (
        "import sys, time, json; sys.path.insert(0, %r)\n"
        "from portbench import harness, run as r\n"
        "cell = harness.load_cell('flow-b8')\n"
        "cell.cfg = dict(cell.cfg, img_hw=[64, 128], batch_size=2)\n"
        "cell.traffic = dict(cell.traffic, pool_batches=3)\n"
        "harness.run(cell, 5, 0.1, False, time.perf_counter(), device='cpu')\n"
        "print(json.dumps(r.forbidden_modules()))\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_compared_whole(monkeypatch):
    from portbench import run as r

    monkeypatch.setitem(sys.modules, "unsupervised_depth_opticalflow_egomotion_tpu_like", sys)
    assert r.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert r.forbidden_modules() == ["jax"]


def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "geom-b8",
                          "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_frozen_flop_count_at_the_cells_shapes():
    # the port's bench.py counted 3.954532424352e12 (geom) and 1.94747538944e12
    # (flow, "splat"; the cell's "splat_nn" has no splat kernel function to
    # count); depth's as the test below
    def count(name):
        cell = harness.load_cell(name)
        return harness.count_flops(cell.reference, cell.cfg)

    geom, _ = count("geom-b8")
    flow, calls = count("flow-b8")
    depth, depth_calls = count("depth-b8")
    assert geom == 3954532424352
    assert flow == pytest.approx(1.94747538944e12, rel=1e-4)
    assert {c[0] for c in calls.calls} == {"correlation", "warp", "ssim"}
    assert depth == 2007150740160
    # six warps a step: each side frame at three scales, with their backwards
    assert [c[:2] for c in depth_calls.calls] == [("warp", "fwd")] * 6 + [("warp", "bwd")] * 6


@pytest.mark.parametrize("name", CELLS)
def test_the_reference_counts_the_flops_the_port_counts(name):
    """The reference's count on meta tensors equals the port's own count of
    one eager step (``bench.Bench.count_flops``) at 64x128 b2."""
    from unsupervised_depth_opticalflow_egomotion_torch import bench

    cell = harness.load_cell(name)
    cfg = dict(cell.cfg, img_hw=[64, 128], batch_size=2, compute_dtype="float32")
    ours, _ = harness.count_flops(cell.reference, cfg)
    assert ours == sum(bench.Bench(harness.port_config(cfg), "cpu").count_flops())


def loader_cell():
    """geom-b8's configuration fed by the port's loader from PNGs (the
    ``pngs`` traffic and its limits; not a cell of BENCHMARK.json yet)."""
    cell = tiny("geom-b8")
    cell.traffic = dict(feeds.load_traffic("pngs"), stacks=12)
    with open(ROOT / "portbench" / "limits" / "geom-b8-pngs.json") as f:
        cell.limits = json.load(f)
    return cell


def test_the_loader_cell_reads_the_files_the_reference_decodes():
    out = harness.run(loader_cell(), SEED, 0.3, False, time.perf_counter(), device="cpu")
    assert out["check"]["loader_gap"]["value"] == 0.0
    assert out["correct"], out["check"]


def test_a_loader_batch_altered_where_it_is_produced_comes_out_not_correct(monkeypatch):
    real = feeds.to_device_batch

    def altered(batch, device):
        images, *rest = batch
        images = images.copy()
        images[0, 0, 0, 0] ^= 1
        return real((images, *rest), device)

    monkeypatch.setattr(feeds, "to_device_batch", altered)
    out = harness.run(loader_cell(), SEED, 0.3, False, time.perf_counter(), device="cpu")
    assert out["check"]["loader_gap"]["value"] > 0 and not out["correct"]
