"""The slice's models and scripts against the JAX package, on the CPU.

- the geom loss pack with the triangulation, PnP, eight-point and depth
  consistency losses on, and the gradients of the four networks, against
  the JAX ``forward_geom`` on the same weights, batch and draws;
- the three modes at ``loss_base_scale=1`` (the depth net's extra coarse
  head) and the refusal of ``loss_base_scale + num_scales > 4``;
- the extra head's weights carried to the JAX tree and back, and kept by a
  stage graft from an ``ls=0`` checkpoint;
- the port's ``synth_world.generate`` and ``train_synth_long.synth_eval``
  against ``scripts/``'s, and short CPU runs of ``train_synth_long``.

Config(img_hw=(64, 128), batch_size=2, compute_dtype="float32",
ssim_impl="xla") on uint8 frames. The port's weights are made from the seed
and carried to the JAX tree (``jax_variables``), so no JAX init compiles;
one JAX program compiles per configuration.
"""

import importlib.util
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsupervised_depth_opticalflow_egomotion_torch import synth_world as t_world
from unsupervised_depth_opticalflow_egomotion_torch import train_synth_long as t_synth
from unsupervised_depth_opticalflow_egomotion_torch.config import Config, loss_weights
from unsupervised_depth_opticalflow_egomotion_torch.models.joint import JointModel
from unsupervised_depth_opticalflow_egomotion_torch.ops.sampling import top_ratio_count
from unsupervised_depth_opticalflow_egomotion_torch.parallel import build_model
from unsupervised_depth_opticalflow_egomotion_torch.parallel.train_step import step_draws
from unsupervised_depth_opticalflow_egomotion_torch.utils import CheckpointManager, graft_params
from unsupervised_depth_opticalflow_egomotion_torch.utils.jax_weights import (
    jax_state_dict,
    jax_variables,
    load_jax_variables,
)
from unsupervised_depth_opticalflow_egomotion_tpu.config import Config as JConfig
from unsupervised_depth_opticalflow_egomotion_tpu.ops import geometry as jg
from unsupervised_depth_opticalflow_egomotion_tpu.parallel import build_model as j_build_model

pytestmark = pytest.mark.quick
torch.set_num_threads(2)
cv2 = pytest.importorskip("cv2")

REPO = Path(__file__).resolve().parents[1]
H, W, B = 64, 128, 2
BASE = dict(img_hw=(H, W), batch_size=B, compute_dtype="float32", ssim_impl="xla")
GEO = dict(enable_triangle=True, enable_pnp=True, enable_eight_point=True,
           enable_depth_consis=True)
NETS = ("depth_net", "pose_net", "fpyramid", "pwc_model")
SAMPLED = ("loss_triangle", "loss_pnp", "loss_eight_point")


def _batch():
    rng = np.random.RandomState(0)
    images = (rng.rand(B, 3 * H, W, 3) * 255).astype(np.uint8)
    K = np.array([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]], np.float32)
    K_ms = np.stack([np.diag([1 / 2**s, 1 / 2**s, 1.0]).astype(np.float32) @ K for s in range(3)])
    K_inv_ms = np.stack([np.linalg.inv(k) for k in K_ms]).astype(np.float32)
    return images, np.tile(K_ms[None], (B, 1, 1, 1)), np.tile(K_inv_ms[None], (B, 1, 1, 1))


def _jax_draws(key, cfg: Config) -> dict:
    """forward_geom's draws, made as the JAX package makes them:
    split(rng, 4), randint(k, (b, num), 0, n) a direction, and for the
    eight-point loss split(k8, B) then randint(key, (iters, 8), 0, num)."""
    k_bwd, k_fwd, k8_bwd, k8_fwd = jax.random.split(key, 4)
    ls = cfg.loss_base_scale
    kept = top_ratio_count((H >> ls) * (W >> ls), cfg.geometric_ratio)
    num = cfg.geometric_num
    out = {d: jax.random.randint(k, (B, num), 0, kept) for d, k in (("bwd", k_bwd), ("fwd", k_fwd))}
    for d, k in (("8_bwd", k8_bwd), ("8_fwd", k8_fwd)):
        out[d] = jnp.stack([jax.random.randint(kk, (cfg.ransac_iters, 8), 0, num)
                            for kk in jax.random.split(k, B)])
    return {k: torch.from_numpy(np.asarray(v)).long() for k, v in out.items()}


def _jax_forward(jmodel, mode):
    def fwd(variables, images, K_ms, K_inv_ms, key):
        kw = dict(train=True, mutable=["batch_stats"])
        if mode == "geom":
            (pack, _), _ = jmodel.apply(variables, images, K_ms, K_inv_ms, rng=key,
                                        method=jmodel.forward_geom, **kw)
        elif mode == "flow":
            pack, _ = jmodel.apply(variables, images, K_ms, K_inv_ms, rng=key,
                                   method=jmodel.forward_flow, **kw)
        else:
            pack, _ = jmodel.apply(variables, images, K_ms, K_inv_ms,
                                   method=jmodel.forward_depth, **kw)
        return pack
    return fwd


def _port_pack(model, mode, batch, draws=None):
    tb = tuple(torch.from_numpy(x) for x in batch)
    if mode == "geom":
        return model.forward_geom(*tb, draws=draws)[0]
    return model.forward_flow(*tb) if mode == "flow" else model.forward_depth(*tb)


# ------------------------------------------------ the geom pack, all losses


@pytest.fixture(scope="module")
def geo():
    """One JAX value_and_grad (its pack as aux) and the port's forward and
    backward, on the port's seed weights, the batch and the JAX draws. The
    gradient is that of the weighted total without the three sampled losses
    (ill-conditioned at init, see SAMPLED_TOL; their gradients are held on a
    well-conditioned scene below)."""
    cfg = Config(**BASE, **GEO)
    model = build_model(cfg, "cpu")
    params, stats = jax_variables(model)
    jmodel = j_build_model(JConfig(**BASE, **GEO))
    weights = loss_weights(cfg)
    batch = _batch()
    key = jax.random.PRNGKey(1)
    fwd = _jax_forward(jmodel, "geom")

    def total(pack):
        return sum(weights[k] * v.mean() for k, v in pack.items() if k not in SAMPLED)

    def jtotal(p):
        pack = fwd({"params": p, "batch_stats": stats}, *batch, key)
        return total(pack), pack

    (_, jpack), jgrads = jax.jit(jax.value_and_grad(jtotal, has_aux=True))(params)
    pack = _port_pack(model, "geom", batch, _jax_draws(key, cfg))
    total(pack).backward()
    return dict(
        pack={k: v.detach().numpy() for k, v in pack.items()},
        jpack={k: np.asarray(v) for k, v in jpack.items()},
        grads={k: p.grad for k, p in model.named_parameters()},
        jgrads=jax_state_dict(jgrads, stats),
    )


# loss -> (rtol, atol). The first eight as tests/test_torch_geom.py (hard-mask
# pixels that flip with f32 rounding). Depth consistency rides the same
# masks at a larger per-pixel weight (its clamped ratio reaches 1 where a
# pixel flips).
PACK_TOL = {"loss_depth_consis": (5e-3, 1e-7)}
# The sampled losses are ill-conditioned in f32 at init: the flows are
# ~1e-4 px, so the flow-consistency scores saturate and the top-30 % order,
# and with it 98 % of the sampled matches, follows rounding; the two views
# barely move, so triangulation and PnP are near-degenerate and the RANSAC
# winner is a toss. A float64 run of the sampling and the three losses on the
# port's f32 flows, disparities and poses (this test's weights and batch)
# lands 1.25e-2 (triangle), 5e-2 (PnP) and 0.56 (eight-point) of the
# batch's max from the f32 runs, as far as the two packages are from each
# other. Triangle and PnP are held to those distances, rounded up; the
# eight-point loss only to its range (a unit-Frobenius difference after the
# sign alignment: at most 1/9 a direction), since the JAX package's own value
# moves by 0.015 between two compiles of this forward. The loss code itself
# is held to 1e-4 on a well-conditioned scene in the next test.
SAMPLED_TOL = {"loss_triangle": 3e-2, "loss_pnp": 0.2}
assert set(SAMPLED) == set(SAMPLED_TOL) | {"loss_eight_point"}


def test_geom_pack_with_every_optional_loss(geo):
    want, got = geo["jpack"], geo["pack"]
    assert set(got) == set(want)
    live = [k for k, v in want.items() if np.abs(v).max() > 0]
    assert len(live) == 12, live
    for k, w in want.items():
        if k in SAMPLED_TOL:
            assert np.abs(got[k] - w).max() <= SAMPLED_TOL[k] * np.abs(w).max(), (k, got[k], w)
        elif k == "loss_eight_point":
            for v in (got[k], w):
                assert np.isfinite(v).all() and (v >= 0).all() and (v <= 2 / 9).all(), (got[k], w)
        else:
            rtol, atol = PACK_TOL.get(k, (1e-3, 1e-7))
            np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol, err_msg=k)


def test_sampled_losses_on_a_two_view_scene():
    """The three sampled losses of JointModel on the matches of a rigid scene
    seen by two cameras (30 % outliers; the eight-point draws made as the
    JAX package makes them), scored against a predicted pose away from the
    true one, against the JAX methods on the same inputs: the losses to 1e-4
    relative, and their gradients to the matches, the pose and the disparity
    maps at the tolerances stated below. The eight-point loss
    to 1e-5 absolute: its RANSAC estimate of F is held to 1e-4 absolute
    (tests/test_torch_geometric.py), and the loss sums 0.5 d^2 over F's
    entries."""
    rng = np.random.RandomState(40)
    n, iters = 600, 40
    K = np.array([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1]], np.float32)
    K_inv = np.linalg.inv(K).astype(np.float32)
    true = np.array([[0.3, -0.05, 0.6, 0.01, 0.03, -0.005],
                     [-0.4, 0.02, 0.5, -0.02, 0.01, 0.01]])
    pix = np.stack([rng.uniform(0, W - 1, (B, n)), rng.uniform(0, H - 1, (B, n))], -1)
    depth = rng.uniform(3, 15, (B, n, 1))
    X = np.einsum("ij,bnj->bni", K_inv, np.concatenate([pix, np.ones((B, n, 1))], -1)) * depth
    T = np.asarray(jg.pose_vec2mat(jnp.asarray(true, jnp.float32)), np.float64)
    p2 = np.einsum("ij,bnj->bni", K, np.einsum("bij,bnj->bni", T[:, :, :3], X) + T[:, None, :, 3])
    p2 = p2[..., :2] / p2[..., 2:]
    bad = rng.rand(B, n) < 0.3
    p2[bad] += rng.uniform(-15, 15, (int(bad.sum()), 2))
    f32 = np.float32
    match = np.concatenate([pix, p2], -1).astype(f32)
    pose = (true + rng.uniform(-0.05, 0.05, true.shape)).astype(f32)
    disp1, disp2 = (rng.uniform(0.2, 0.8, (B, H, W, 1)).astype(f32) for _ in range(2))
    Kb, Kib = np.tile(K[None], (B, 1, 1)), np.tile(K_inv[None], (B, 1, 1))
    jkey = jax.random.PRNGKey(41)
    idx8 = np.stack([np.asarray(jax.random.randint(k, (iters, 8), 0, n))
                     for k in jax.random.split(jkey, B)])
    model = JointModel(Config(**BASE, **GEO, ransac_iters=iters))
    jmodel = j_build_model(JConfig(**BASE, **GEO, ransac_iters=iters))

    def jlosses(match, pose, disp1, disp2):
        call = lambda m, *a: jmodel.apply({}, *a, method=m)  # noqa: E731
        return (call(jmodel._triangle_loss, match, pose, Kb, Kib, disp1, disp2),
                call(jmodel._pnp_loss, match, depth.astype(f32), pose, Kb, Kib),
                call(jmodel._eight_point_loss, jkey, match, pose, Kib))

    def tlosses(match, pose, disp1, disp2):
        T_ = torch.from_numpy
        return (model._triangle_loss(match, pose, T_(Kb), T_(Kib), disp1, disp2),
                model._pnp_loss(match, T_(depth.astype(f32)), pose, T_(Kb), T_(Kib)),
                model._eight_point_loss(T_(idx8), match, pose, T_(Kib)))

    inputs = (match, pose, disp1, disp2)
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda *a: (lambda ls: (sum(v.sum() for v in ls), ls))(jlosses(*a)),
        argnums=(0, 1, 2, 3), has_aux=True))(*map(jnp.asarray, inputs))
    want = want[1]
    tin = [torch.from_numpy(x).requires_grad_() for x in inputs]
    got = tlosses(*tin)
    sum(v.sum() for v in got).backward()
    for name, g, w in zip(SAMPLED, got, want):
        w = np.asarray(w)
        assert np.abs(w).min() > 1e-3, name
        atol = 1e-5 if name == "loss_eight_point" else 0.0
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-4, atol=atol, err_msg=name)
    # gradients, relative L2: the triangulation's gradient to the matches and
    # the pose is ill-conditioned in f32 (nearly parallel rays); a float64 run
    # of the port's triangulation loss on these inputs lands 1.3-1.8 % from
    # both f32 runs' match gradients (the packages are 1.0 % apart), so 3e-2
    # there; the disparity maps take bilinear weights alone, 2e-3
    for name, t, w, tol in zip(("match", "pose", "disp1", "disp2"), tin, jgrads,
                               (3e-2, 3e-2, 2e-3, 2e-3)):
        g, w = t.grad.numpy(), np.asarray(w)
        assert np.linalg.norm(g - w) <= tol * np.linalg.norm(w), name


# ------------------------------------------------------- loss_base_scale=1


@pytest.fixture(scope="module")
def ls1():
    """The three modes at loss_base_scale=1 on one ls=1 model's weights:
    the port's packs and the JAX packs (flow under the splat occlusion)."""
    batch = _batch()
    out = {}
    for mode in ("flow", "depth", "geom"):
        kw = dict(BASE, mode=mode, loss_base_scale=1, flow_occ_impl="splat")
        model = build_model(Config(**kw), "cpu")
        params, stats = jax_variables(model)
        jmodel = j_build_model(JConfig(**kw))
        jpack = jax.jit(_jax_forward(jmodel, mode))(
            {"params": params, "batch_stats": stats}, *batch, jax.random.PRNGKey(1))
        with torch.no_grad():
            pack = _port_pack(model, mode, batch)
        out[mode] = ({k: v.numpy() for k, v in pack.items()},
                     {k: np.asarray(v) for k, v in jpack.items()})
    return out


@pytest.mark.parametrize("mode", ["flow", "depth", "geom"])
def test_loss_base_scale_packs(ls1, mode):
    """Every key per batch item, to 3e-3 relative (+1e-7 absolute): the
    losses live one octave down, so the coarsest scale is 8x16 px and a hard
    mask pixel that flips with f32 rounding moves a loss by ~2e-3 of its
    value (a 1e-6 relative change of K moves the port's own depth-mode
    photometric loss by 6.7e-4 here); 1e-3 at full scale in
    tests/test_torch_geom.py."""
    got, want = ls1[mode]
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=3e-3, atol=1e-7, err_msg=k)
    assert all(np.isfinite(v).all() for v in got.values())


def test_loss_base_scale_refuses_more_scales_than_the_decoder_has():
    cfg = Config(**BASE, loss_base_scale=2, num_scales=3)
    with pytest.raises(ValueError, match="loss_base_scale"):
        JointModel(cfg)
    jmodel = j_build_model(JConfig(**BASE, loss_base_scale=2, num_scales=3))
    batch = tuple(jnp.asarray(x) for x in _batch())
    with pytest.raises(ValueError, match="loss_base_scale"):
        jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), *batch, train=False,
                                           method=jmodel.forward_depth))


def test_extra_head_weights_both_ways():
    """An ls=1 model's tree equals the JAX ls=1 tree (names and shapes, the
    extra head as ReflectConv3x3_x3), and comes back bit for bit."""
    cfg = Config(**BASE, loss_base_scale=1)
    model = build_model(cfg, "cpu")
    params, stats = jax_variables(model)
    jmodel = j_build_model(JConfig(**BASE, loss_base_scale=1))
    batch = tuple(jnp.asarray(x) for x in _batch())
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), *batch, train=False,
                                                method=jmodel.forward_geom))
    for tree, want in ((params, shapes["params"]), (stats, shapes["batch_stats"])):
        assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(want)
        assert jax.tree_util.tree_all(jax.tree_util.tree_map(
            lambda a, s: a.shape == s.shape, tree, want))
    assert "ReflectConv3x3_x3" in params["depth_net"]["DepthDecoder_0"]
    back = build_model(cfg.replace(seed=1), "cpu")
    load_jax_variables(back, params, stats)
    for k, v in model.state_dict().items():
        assert torch.equal(v, back.state_dict()[k]), k


def test_graft_from_ls0_keeps_the_extra_head(tmp_path):
    """A loss_base_scale=1 geom model grafted from an ls=0 depth checkpoint
    takes every parameter the donor has and keeps its extra head at init."""
    donor = build_model(Config(**BASE, mode="depth", seed=3), "cpu")
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, donor, torch.optim.Adam(donor.parameters()))
    model = build_model(Config(**BASE, loss_base_scale=1), "cpu")
    head = model.depth_net.decoder.dispconvs[3].conv.weight.clone()
    copied = graft_params(model, ckpt.restore_params())
    assert len(copied) == len(list(donor.named_parameters()))
    assert "depth_net.decoder.dispconvs.3.conv.weight" not in copied
    assert torch.equal(model.depth_net.decoder.dispconvs[3].conv.weight, head)
    assert torch.equal(model.depth_net.decoder.dispconvs[0].conv.weight,
                       donor.depth_net.decoder.dispconvs[0].conv.weight)


def test_step_draws_replay_and_refusal():
    """A step's draws depend on (seed, step) alone, so a resume replays them;
    forward_geom refuses to run the sampled losses without draws."""
    model = build_model(Config(**BASE, **GEO), "cpu")
    batch = tuple(torch.from_numpy(x) for x in _batch())
    a, b, c = step_draws(model, 5, batch), step_draws(model, 5, batch), step_draws(model, 6, batch)
    assert set(a) == {"bwd", "fwd", "8_bwd", "8_fwd"}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["bwd"], c["bwd"])
    assert a["bwd"].shape == (B, 6000) and int(a["bwd"].max()) < top_ratio_count(H * W, 0.3)
    with pytest.raises(ValueError, match="draws"):
        model.forward_geom(*batch)


# ------------------------------------------------------ the synthetic world


def _load_script(name):
    """A module of scripts/ by path; train_synth_long sets a JAX compilation
    cache directory at import, which is put back."""
    cache = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(f"_script_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jax.config.update("jax_compilation_cache_dir", cache)
    return mod


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("world")
    t_world.generate(str(root / "port"), n_train=2, n_eval=1, hw=(H, W), seed=0, n_movers=1)
    _load_script("synth_world").generate(str(root / "script"), n_train=2, n_eval=1,
                                         hw=(H, W), seed=0, n_movers=1)
    return root


def test_synth_world_writes_the_scripts_files(world):
    files = sorted(str(p.relative_to(world / "script")) for p in (world / "script").rglob("*")
                   if p.is_file())
    assert files == sorted(str(p.relative_to(world / "port")) for p in (world / "port").rglob("*")
                           if p.is_file())
    assert len(files) == 5  # calib, train.txt, 2 stacks, 1 eval npz
    for f in files:
        a, b = world / "port" / f, world / "script" / f
        if f.endswith(".npz"):
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
        else:
            assert a.read_bytes() == b.read_bytes(), f


@pytest.mark.parametrize("rotating", [False, True])
def test_synth_eval_equals_the_scripts(world, rotating):
    """Fixed numpy flows, disparities and poses: every metric to 1e-12. With
    rotating poses the pose ATE / RE hold to 1e-9 relative: each package
    turns the pose vectors into f32 matrices with its own sin, cos and 3x3
    products, which differ in the last bit (3.5e-11 of the ATE here)."""
    eval_set = t_synth.load_eval_set(str(world / "port"))
    rng = np.random.RandomState(30)
    flow = rng.uniform(-3, 3, (1, H, W, 2)).astype(np.float32)
    disp = rng.uniform(0.05, 0.9, (1, H, W, 1)).astype(np.float32)
    pose = rng.uniform(-0.2, 0.2, (1, 2, 6)).astype(np.float32)
    if not rotating:
        pose[..., 3:] = 0.0
    fns = (lambda a, b: flow, lambda a: disp)
    got = t_synth.synth_eval(eval_set, *fns, pose_fn=lambda x: pose)
    want = _load_script("train_synth_long").synth_eval(eval_set, *fns, pose_fn=lambda x: pose)
    assert set(got) == set(want) and {"flow_epe_dyn", "pose_ate_zero"} <= set(got)
    for k, w in want.items():
        rtol = 1e-9 if rotating and k in ("pose_ate", "pose_re") else 1e-12
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=1e-12, err_msg=k)


def test_train_synth_long_stages_and_resume(world, tmp_path):
    """Two flow steps through the occlusion switch, then two geom steps
    grafted from it with the four optional losses, then a resume to step 3:
    finite losses, synth_eval before and after, the mask dump and the
    checkpoints."""
    common = ["--data", str(world / "port"), "--hw", str(H), str(W), "--batch", "2",
              "--log_every", "1", "--eval_every", "2", "--image_every", "2"]
    flow_dir, geom_dir = tmp_path / "flow", tmp_path / "geom"
    t_synth.main(common + ["--out", str(flow_dir), "--mode", "flow", "--steps", "2",
                           "--flow_occ_switch_step", "1"], device="cpu")
    geom = common + ["--out", str(geom_dir), "--mode", "geom",
                     "--enable_losses", "triangle,pnp,eight_point,depth_consis"]
    t_synth.main(geom + ["--steps", "2", "--graft_flow", str(flow_dir / "ckpt")], device="cpu")
    _, step = t_synth.main(geom + ["--steps", "3", "--resume", "--no-device_data"], device="cpu")
    assert step == 3
    recs = [json.loads(line) for line in (geom_dir / "curves.jsonl").read_text().splitlines()]
    evals = [r for r in recs if "eval" in r]
    assert [r["step"] for r in evals] == [0, 2, 3]
    assert {"flow_epe", "depth_absrel", "pose_ate", "pose_ate_zero"} <= set(evals[0]["eval"])
    assert all("masks" in r for r in evals)
    losses = [r for r in recs if "loss_total" in r]
    assert [r["step"] for r in losses] == [1, 2, 3]
    for r in losses:
        assert all(np.isfinite(v) for k, v in r.items() if k.startswith("loss"))
        assert all(r[k] != 0 for k in ("loss_triangle", "loss_pnp", "loss_eight_point",
                                       "loss_depth_consis"))
    assert (geom_dir / "images" / "step_00000002" / "fwd_mask.png").exists()
    assert CheckpointManager(str(geom_dir / "ckpt")).steps() == [2, 3]
    flow_recs = (flow_dir / "curves.jsonl").read_text()
    assert '"eval"' in flow_recs and os.path.exists(flow_dir / "ckpt" / "2.pt")
