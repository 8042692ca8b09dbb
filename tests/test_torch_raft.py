"""RAFT in the port (``models/raft.py``, ``ops/corr_pyramid.py``,
``forward_flow`` under ``flow_net="raft"``) against the benchmark's plain
reference (``portbench/reference/raft.py``), on the CPU.

Seeded random weights (the benchmark's draw, ``harness.make_weights``) load
by name into both; 128x128 b2 frames of the ``resident`` traffic; three
update iterations through the models' ``iters`` argument. 128 rows and
columns: the pyramid's coarsest level is 1/64 of the frame, and the lookup
normalises by its size less one (the port refuses less). Compared: every
iteration's upsampled flow, the loss pack, each leaf's first gradient, the
BatchNorm statistics after one step, the lookup against a direct bilinear
evaluation of the volume, and the 3B feature pass against per-pair calls.

The tolerances are f32's: the two sides sum in other orders (NHWC against
NCHW convolutions, the SSIM map's plain form against avg_pool), and a bf16
port fails them (``test_port_against_the_reference`` runs both).
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import feeds
from portbench.harness import make_weights, parameter_shapes, port_config
from portbench.reference.raft import RaftReference
from unsupervised_depth_opticalflow_egomotion_torch.config import Config, loss_weights
from unsupervised_depth_opticalflow_egomotion_torch.models import JointModel
from unsupervised_depth_opticalflow_egomotion_torch.models.joint import split_stack
from unsupervised_depth_opticalflow_egomotion_torch.models.layers import Conv, init_weights
from unsupervised_depth_opticalflow_egomotion_torch.models.raft import RAFT
from unsupervised_depth_opticalflow_egomotion_torch.ops.corr_pyramid import (corr_lookup,
                                                                              corr_pyramid)
from unsupervised_depth_opticalflow_egomotion_torch.parallel import train_step as tts
from unsupervised_depth_opticalflow_egomotion_torch.utils.checkpoint import CheckpointManager
from unsupervised_depth_opticalflow_egomotion_torch.utils.jax_weights import model_table

pytestmark = pytest.mark.quick
torch.set_num_threads(4)

REPO = Path(__file__).resolve().parents[1]
ITERS, SEED, HW, B = 3, 12345, (128, 128), 2
# relative gaps; f32 reads (seed 12345) and a bf16 port's reads in brackets
TOL = {
    "flow": 1e-4,  # the flows' difference over their norm (f32 3e-6; bf16 1e-2)
    "loss": 1e-3,  # each loss vector's, elementwise (f32 5e-5, SSIM; bf16 0.17)
    # a leaf's gradient difference over the larger of its norm and the
    # median leaf's: the median leaf (f32 1.5e-5; bf16 0.078) and the worst
    # (f32 4.6e-3, the context encoder's first layers, whose BatchNorm over
    # 2 x 16 x 16 positions amplifies rounding; bf16 0.53)
    "grad_median": 1e-3,
    "grad_worst": 0.03,
    "bn": 1e-5,  # each BatchNorm statistic's difference over its norm (f32 2e-7; bf16 2.6e-3)
}


def raft_cfg(compute_dtype="float32"):
    with open(REPO / "portbench" / "configs" / "kitti_raft.json") as f:
        cfg = json.load(f)["config"]
    return dict(cfg, img_hw=list(HW), batch_size=B, compute_dtype=compute_dtype)


def pair(dtype="float32"):
    """The port's model and the reference, three iterations, the same
    weights; and a batch."""
    cfg = raft_cfg(compute_dtype=dtype)
    weights = make_weights(parameter_shapes(RaftReference, cfg), SEED, "cpu")
    model = tts.build_model(port_config(cfg), "cpu")
    model.raft = RAFT(model.dtype, iters=ITERS)
    ref = RaftReference(cfg, iters=ITERS)
    for m in (model, ref):
        missing = m.load_state_dict(weights, strict=False).missing_keys
        assert not [k for k in missing if "running_" not in k]
    traffic = dict(feeds.load_traffic("resident"), pool_batches=1)
    batch = feeds.make_feed(traffic, cfg, 7, "cpu").next()
    return cfg, model.train(), ref.train(), batch


def rel(a, b):
    return float((a.float() - b).norm() / b.norm())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_against_the_reference(dtype):
    """Every iteration's flow, the loss pack, the first gradient and the
    BatchNorm statistics after the step agree in f32; a bf16 port is
    outside the flows' and the losses' tolerances."""
    cfg, model, ref, batch = pair(dtype)
    h = HW[0]
    frames = batch[0].float() / 255.0
    with torch.no_grad():  # on copies: the step below starts from the loaded statistics
        flows = copy.deepcopy(model.raft).flows_of_triplet(*split_stack(batch[0], torch.float32))
        want = copy.deepcopy(ref.raft)(*(frames[:, i * h:(i + 1) * h].permute(0, 3, 1, 2)
                                         for i in range(3)))
    assert len(flows) == len(want) == ITERS
    flow_gaps = [rel(f, w.permute(0, 2, 3, 1)) for f, w in zip(flows, want)]
    pack, want_pack = model.forward_flow(*batch), ref.loss_pack(*batch)
    assert pack.keys() == want_pack.keys()
    loss_gaps = [float(((pack[k].detach().float() - v.detach()).abs() / v.detach().abs()).max())
                 for k, v in want_pack.items()]
    if dtype == "bfloat16":
        assert max(flow_gaps) > TOL["flow"] and max(loss_gaps) > TOL["loss"]
        return
    assert max(flow_gaps) < TOL["flow"], flow_gaps
    assert max(loss_gaps) < TOL["loss"], loss_gaps
    w = loss_weights(port_config(cfg))
    sum(w[k] * v.mean() for k, v in pack.items()).backward()
    sum(w[k] * v.mean() for k, v in want_pack.items()).backward()
    mine, theirs = dict(model.named_parameters()), dict(ref.named_parameters())
    names = [k for k, p in theirs.items() if p.grad is not None]
    assert names and all(k.startswith("raft.") for k in names)
    assert {k for k, p in mine.items() if p.grad is not None} == set(names)
    norms = {k: float(theirs[k].grad.norm()) for k in names}
    median = float(np.median(list(norms.values())))
    gaps = sorted(float((mine[k].grad - theirs[k].grad).norm()) / max(norms[k], median)
                  for k in names)
    assert gaps[len(gaps) // 2] < TOL["grad_median"] and gaps[-1] < TOL["grad_worst"], gaps[-3:]
    buffers, want_buffers = dict(model.named_buffers()), dict(ref.named_buffers())
    moved = [k for k in want_buffers if k.startswith("raft.cnet")]
    assert len(moved) == 2 * 15  # the context encoder's 15 BatchNorms: mean and variance
    for k in moved:
        assert rel(buffers[k], want_buffers[k]) < TOL["bn"], k


def direct_lookup(pyr, coords, r):
    """Each window tap as the four-neighbour bilinear sum of the volume,
    zeros outside, tap (a, b) at (x + a - r, y + b - r) / 2^l."""
    p, h, w, _ = coords.shape
    out = np.zeros((p * h * w, len(pyr), 2 * r + 1, 2 * r + 1))
    c = coords.reshape(-1, 2).double().numpy()
    for lvl, vol in enumerate(pyr):
        v = vol[:, 0].double().numpy()
        hl, wl = v.shape[1:]
        for a in range(2 * r + 1):
            for b in range(2 * r + 1):
                x, y = c[:, 0] / 2 ** lvl + a - r, c[:, 1] / 2 ** lvl + b - r
                x0, y0 = np.floor(x), np.floor(y)
                for dx in (0, 1):
                    for dy in (0, 1):
                        xi, yi = x0 + dx, y0 + dy
                        wt = (1 - np.abs(x - xi)) * (1 - np.abs(y - yi))
                        inside = (xi >= 0) & (xi < wl) & (yi >= 0) & (yi < hl)
                        val = v[np.arange(len(c)), np.clip(yi, 0, hl - 1).astype(int),
                                np.clip(xi, 0, wl - 1).astype(int)]
                        out[:, lvl, a, b] += np.where(inside, wt * val, 0.0)
    return torch.from_numpy(out.reshape(p, h, w, -1))


def test_pyramid_and_lookup_against_a_direct_evaluation():
    """The volume is the scaled dot products, each level the 2x2 mean of
    the last; the lookup is the bilinear window of every level in
    ``CorrBlock``'s tap order, zeros outside (coordinates in and out of
    the frame, none on a pixel centre)."""
    g = torch.Generator().manual_seed(3)
    f1, f2 = (torch.randn(2, 8, 12, 16, generator=g) for _ in range(2))
    pyr = corr_pyramid(f1, f2, 3)
    dots = torch.einsum("pyxc,pijc->pyxij", f1.double(), f2.double()) / 4.0
    assert torch.allclose(pyr[0].reshape(2, 8, 12, 8, 12).double(), dots, atol=1e-5)
    pooled = dots.reshape(2 * 96, 4, 2, 6, 2).mean(dim=(2, 4))
    assert torch.allclose(pyr[1][:, 0].double(), pooled, atol=1e-5)
    assert [tuple(v.shape) for v in pyr] == [(192, 1, 8, 12), (192, 1, 4, 6), (192, 1, 2, 3)]
    coords = torch.rand(2, 8, 12, 2, generator=g) * torch.tensor([16.0, 12.0]) - 2.0 + 0.013
    got = corr_lookup(pyr, coords, 2)
    assert got.shape == (2, 8, 12, 3 * 25) and got.dtype == torch.float32
    assert torch.allclose(got.double(), direct_lookup(pyr, coords, 2), atol=1e-5)


def test_triplet_feature_pass_equals_per_pair_calls():
    """One feature pass over the 3B frames gives each frame the features of
    RAFT's per-pair calls (instance norm is per sample); one context pass
    over the B centre frames gives what a pass over both pairs' first
    frames gives, BatchNorm statistics included (biased variance)."""
    raft = RAFT(torch.float32, iters=1)
    init_weights(raft, torch.Generator().manual_seed(1))
    twin = copy.deepcopy(raft)
    g = torch.Generator().manual_seed(2)
    l, c, r = (torch.rand(2, 128, 128, 3, generator=g) for _ in range(3))
    with torch.no_grad():
        trip = raft.fnet(2 * torch.cat([l, c, r]) - 1)
        pair_bwd = raft.fnet(2 * torch.cat([c, l]) - 1)  # (image1, image2) of c -> l
        pair_fwd = raft.fnet(2 * torch.cat([c, r]) - 1)
        once = raft._context(c)
        both = twin._context(torch.cat([c, c]))
    for got, want in ((trip[2:4], pair_bwd[:2]), (trip[:2], pair_bwd[2:]),
                      (trip[2:4], pair_fwd[:2]), (trip[4:], pair_fwd[2:])):
        assert torch.allclose(got, want, atol=1e-5)
    for x, y in zip(once, both):
        assert torch.allclose(torch.cat([x, x]), y, atol=1e-5)
    for x, y in zip(raft.cnet.buffers(), twin.cnet.buffers()):
        assert torch.allclose(x, y, atol=1e-6)


@pytest.mark.parametrize("overrides,match", [
    ({"mode": "depth"}, "mode 'flow' alone"),
    ({"mode": "geom"}, "mode 'flow' alone"),
    ({"num_scales": 3}, "num_scales 1"),
    ({"loss_base_scale": 1}, "loss_base_scale 0"),
    ({"img_hw": (64, 128)}, "at least 128"),
    ({"flow_net": "pwcnet"}, "flow_net must be one of"),
])
def test_raft_settings_it_cannot_run_raise(overrides, match):
    kw = dict(mode="flow", flow_net="raft", num_scales=1, img_hw=HW, batch_size=B)
    with pytest.raises(ValueError, match=match):
        JointModel(Config(**dict(kw, **overrides)))


def test_inference_flow_and_the_model_it_holds():
    """RAFT in place of the PWC networks, the depth and pose networks held;
    ``inference_flow`` gives [B,H,W,2] f32 after its inference iterations,
    and leaves the model in train mode with its statistics as they were."""
    cfg = Config(mode="flow", flow_net="raft", num_scales=1, img_hw=HW, batch_size=B,
                 compute_dtype="float32")
    model = tts.build_model(cfg, "cpu")
    assert not hasattr(model, "fpyramid") and not hasattr(model, "pwc_model")
    assert hasattr(model, "depth_net") and hasattr(model, "pose_net")
    assert model.raft.iters == 12 and model.raft.test_iters == 24
    model.raft.test_iters = 2
    stats = {k: v.clone() for k, v in model.named_buffers()}
    flow = model.inference_flow(torch.rand(B, *HW, 3), torch.rand(B, *HW, 3))
    assert flow.shape == (B, *HW, 2) and flow.dtype == torch.float32
    assert torch.isfinite(flow).all() and model.training
    assert all(torch.equal(v, stats[k]) for k, v in model.named_buffers())


@pytest.mark.parametrize("kernel,padding", [(3, 1), ((1, 5), (0, 2)), ((5, 1), (2, 0))])
def test_conv_takes_square_and_rectangular_kernels(kernel, padding):
    """A square conv keeps its parameters' names and shapes and its result;
    a 1x5 or 5x1 conv is ``F.conv2d`` with its (rows, columns) padding."""
    conv = Conv(6, 4, kernel, 1, padding)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
    assert [(k, tuple(p.shape)) for k, p in conv.named_parameters()] == [
        ("weight", (4, 6, kh, kw)), ("bias", (4,))]
    x = torch.randn(2, 9, 11, 6)
    want = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias, 1, padding)
    assert torch.equal(conv(x), want.permute(0, 2, 3, 1))


def test_fix_flow_freezes_raft_and_a_checkpoint_round_trips(tmp_path):
    """``fix_flow`` freezes every ``raft.*`` parameter and nothing of the
    depth and pose networks; a RAFT model's checkpoint restores its
    parameters, statistics and Adam state; the JAX weight table refuses a
    model with RAFT."""
    base = dict(mode="flow", flow_net="raft", num_scales=1, img_hw=HW, batch_size=B,
                compute_dtype="float32")
    frozen = Config(**base, fix_flow=True)
    model = tts.build_model(frozen, "cpu")
    labels = {k: tts.freeze_label(frozen, k) for k, _ in model.named_parameters()}
    assert all((v == "frozen") == k.startswith("raft.") for k, v in labels.items())
    assert any(v == "frozen" for v in labels.values())

    cfg = Config(**base)
    model, opt = tts.init_state(cfg, "cpu")
    model.raft.iters = 1
    traffic = dict(feeds.load_traffic("resident"), pool_batches=1)
    batch = feeds.make_feed(traffic, raft_cfg(), 7, "cpu").next()
    tts.make_train_step(model, cfg, opt)(batch, 0)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save(1, model, opt, meta={"mode": "flow"})
    twin, twin_opt = tts.init_state(cfg.replace(seed=5), "cpu")
    assert ckpt.restore(twin, twin_opt) == 1
    for (k, a), b in zip(model.state_dict().items(), twin.state_dict().values()):
        assert torch.equal(a, b), k
    states = zip(opt.state_dict()["state"].values(), twin_opt.state_dict()["state"].values())
    assert all(torch.equal(a["exp_avg"], b["exp_avg"]) for a, b in states)
    with pytest.raises(TypeError, match="RAFT"):
        model_table(model)


def test_training_cli_takes_flow_net_raft(tmp_path, monkeypatch):
    """``--flow_net raft --num_scales 1`` trains flow mode's RAFT through the
    CLI (on the CPU here): one step, a checkpoint of ``raft.*`` and the
    configuration it ran."""
    cv2 = pytest.importorskip("cv2")
    root = tmp_path / "prepared"
    (root / "d").mkdir(parents=True)
    (root / "calib.txt").write_text(
        "P_rect_02: 100.0 0.0 64.0 0.0 0.0 100.0 64.0 0.0 0.0 0.0 1.0 0.0\n")
    rng = np.random.RandomState(0)
    for i in range(4):
        cv2.imwrite(str(root / "d" / f"{i:06d}.png"), rng.randint(0, 255, (3 * HW[0], HW[1], 3),
                                                                  np.uint8))
    (root / "train.txt").write_text("".join(f"d/{i:06d}.png calib.txt\n" for i in range(4)))
    (tmp_path / "tiny.yaml").write_text(
        f"img_hw: [{HW[0]}, {HW[1]}]\nnum_workers: 1\nlog_interval: 1\ntest_interval: 0\n"
        "save_interval: 0\nloader_impl: python\n")
    from unsupervised_depth_opticalflow_egomotion_torch import train as cli

    ran = {}

    def on_cpu(cfg):
        ran["out"] = train(cfg, device="cpu")

    train = cli.train
    monkeypatch.setattr(cli, "train", on_cpu)
    out = tmp_path / "run"
    cli.main(["-c", str(tmp_path / "tiny.yaml"), "--mode", "flow", "--flow_net", "raft",
              "--num_scales", "1", "--model_dir", str(out), "--prepared_base_dir", str(root),
              "--batch_size", "2", "--num_iterations", "1", "--compute_dtype", "float32"])
    model, _, step = ran["out"]
    assert step == 1 and model.cfg.flow_net == "raft" and model.raft.iters == 12
    saved = CheckpointManager(str(out / "ckpt")).restore_params()
    assert any(k.startswith("raft.update_block.gru.convz1") for k in saved)
    assert json.loads((out / "config.json").read_text())["flow_net"] == "raft"
