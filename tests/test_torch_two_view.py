"""The port's legacy two-view pipeline against the JAX package's, on the CPU
in f32 at 64x128: the pose-from-F estimators, ``TriangulationPoseModel``
(its inference and its triangulation loss), the KITTI flow task with the
two-view inference, the eval CLI's ``--mode two_view``, and the debug
drawing.

Weights are the port's initialisation from its seed, with seeded BatchNorm
running statistics far from (0, 1), carried to the JAX tree by
``jax_variables``. The draws are ``jax.random``'s, made as the JAX model
makes them (triangulation_pose.py:166-175, sampling.py ``random_sample``,
ransac.py:81,94) and given to the port as index tensors.

At the nets' initialisation the flow is below 1e-2 px: every minimal
sample is nearly degenerate, F follows f32 rounding in both packages and
so do the pose and the triangulated depths. There the flow, the
disparities and the sampled matches are held against JAX, and the
geometric outputs as the geometric half of the model's own flow. The
geometry is held against JAX on exact rigid flows of a scene with relief
(depths 4-10 m), where it is well conditioned: [R|t] to 1e-4, the
triangulated depths and the loss to 1e-4 relative, and R to 1e-2 of the
truth with cos(t, t_true) > 0.999 (tests/test_triangulation_pose.py).
"""

import copy
import os
from typing import Any

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_eval_trees import kitti_flow_tree
from unsupervised_depth_opticalflow_egomotion_torch import eval_tasks as ttasks
from unsupervised_depth_opticalflow_egomotion_torch import test as tcli
from unsupervised_depth_opticalflow_egomotion_torch import visualize as tvis
from unsupervised_depth_opticalflow_egomotion_torch.config import Config
from unsupervised_depth_opticalflow_egomotion_torch.data import KittiFlowEval as TFlowEval
from unsupervised_depth_opticalflow_egomotion_torch.models import triangulation_pose as ttp
from unsupervised_depth_opticalflow_egomotion_torch.parallel import build_model, make_optimizer
from unsupervised_depth_opticalflow_egomotion_torch.utils import CheckpointManager
from unsupervised_depth_opticalflow_egomotion_torch.utils.jax_weights import jax_variables
from unsupervised_depth_opticalflow_egomotion_tpu import eval_tasks as jtasks
from unsupervised_depth_opticalflow_egomotion_tpu.config import Config as JConfig
from unsupervised_depth_opticalflow_egomotion_tpu.data import KittiFlowEval as JFlowEval
from unsupervised_depth_opticalflow_egomotion_tpu.evaluation import load_gt_mask
from unsupervised_depth_opticalflow_egomotion_tpu.evaluation.flow_metrics import _read_flow_gt_worker
from unsupervised_depth_opticalflow_egomotion_tpu.models import triangulation_pose as jtp
from unsupervised_depth_opticalflow_egomotion_tpu.models.depth_net import DepthNet as JDepthNet
from unsupervised_depth_opticalflow_egomotion_tpu.ops import geometry as jg
from unsupervised_depth_opticalflow_egomotion_tpu.ops import ransac as jr
from unsupervised_depth_opticalflow_egomotion_tpu.ops import sampling as js
from unsupervised_depth_opticalflow_egomotion_tpu.ops import triangulation as jt
from unsupervised_depth_opticalflow_egomotion_tpu.visualize import debug as jdebug

pytestmark = pytest.mark.quick
torch.set_num_threads(2)

H, W = 64, 128
B = 8  # the eval's batch: one JAX compile serves the model and the task tests
ITERS, POINTS = 5, 256
MODEL = dict(img_hw=(H, W), compute_dtype="float32", ransac_iters=ITERS, ransac_points=POINTS)
KEY = jax.random.PRNGKey(0)  # the JAX model's fixed key (triangulation_pose.py:166)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, want, tol):
    """Max error relative to the reference's max-abs."""
    got, want = _np(got), _np(want)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def jax_draws(key, b, n, points=POINTS, iters=ITERS):
    """The JAX model's three draws as the port's index tensors."""
    return {
        "sample": _t(np.asarray(jax.random.randint(key, (b, points), 0, n)).astype(np.int64)),
        "ransac": _t(np.stack([np.asarray(jax.random.randint(k, (iters, 8), 0, points))
                               for k in jax.random.split(key, b)]).astype(np.int64)),
        "verify": _t(np.asarray(jax.random.randint(key, (b, ttp.VERIFY_POINTS), 0, points))
                     .astype(np.int64)),
    }


def _intrinsics(b):
    K = np.array([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]], np.float32)
    K = np.tile(K[None], (b, 1, 1))
    return K, np.linalg.inv(K).astype(np.float32)


def _smooth(rng, shape):
    """A smooth random field in [0, 1] over [H, W] (sums of sinusoids)."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    f = np.zeros(shape + (H, W))
    for _ in range(4):
        fy, fx = rng.uniform(0.02, 0.12, 2)
        f += np.sin(fy * yy + fx * xx + rng.uniform(0, 6.3, shape + (1, 1)))
    return (f - f.min()) / (f.max() - f.min())


@pytest.fixture(scope="module")
def scene():
    """A rigid two-view scene [2 items]: the exact rigid flow of a depth map
    with relief (4-10 m) under a pose each, K, and the true [R|t]."""
    rng = np.random.RandomState(0)
    depth = (4.0 + 6.0 * _smooth(rng, (2,)))[..., None].astype(np.float32)
    pose = np.array([[0.5, 0.05, 0.1, 0.01, -0.04, 0.02],
                     [-0.3, 0.1, 0.4, -0.02, 0.03, 0.01]], np.float32)
    K, K_inv = _intrinsics(2)
    flow, T = jax.jit(lambda d, p, k: (jg.calculate_rigid_flow(d, p, k), jg.pose_vec2mat(p)))(
        depth, pose, K)
    flow, T = np.asarray(flow), np.asarray(T)
    return dict(pose=pose, K=K, K_inv=K_inv, flow=flow, R=T[:, :, :3], t=T[:, :, 3])


def _against_truth(Rt, R, t):
    Rt = _np(Rt)
    np.testing.assert_allclose(Rt[:, :, :3], R, atol=1e-2)
    cos = (Rt[:, :, 3] * t).sum(-1) / (np.linalg.norm(Rt[:, :, 3], axis=-1) * np.linalg.norm(t, axis=-1))
    assert (cos > 0.999).all(), cos


def _bn_stats(model, seed=1):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.3 * torch.randn(buf.shape, generator=g))
            elif name.endswith("running_var"):
                buf.copy_(0.3 + 2.7 * torch.rand(buf.shape, generator=g))


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """(port joint model, its checkpoint dir, port two-view model, JAX
    two-view model, its variables, the jitted JAX inference)."""
    cfg = Config(**MODEL)
    joint = build_model(cfg, "cpu")
    _bn_stats(joint)
    ckpt = str(tmp_path_factory.mktemp("run") / "ckpt")
    CheckpointManager(ckpt).save(3, joint, make_optimizer(cfg, joint))
    tv = tcli.two_view_model(joint, cfg)
    params, stats = jax_variables(tv)
    jm = jtp.TriangulationPoseModel(ransac_iters=ITERS, ransac_points=POINTS)
    variables = {"params": params, "batch_stats": stats}
    jinf = jax.jit(lambda v, a, b, K, Ki: jm.apply(v, a, b, K, Ki, method=jm.inference))
    return joint, ckpt, tv, jm, variables, jinf


# ------------------------------------------------------------- estimators


def test_essential_from_fundamental(scene):
    """E = K^T F K against JAX (1e-5 relative), and proportional to the true
    E = [t]x R."""
    K = scene["K"]
    E_true = np.asarray(jg.essential_matrix(jnp.asarray(scene["pose"])))
    F = np.einsum("bji,bjk,bkl->bil", scene["K_inv"], E_true, scene["K_inv"]).astype(np.float32)
    got = ttp.essential_from_fundamental(_t(F), _t(K))
    _rel(got, jtp.essential_from_fundamental(jnp.asarray(F), jnp.asarray(K)), 1e-5)
    ratio = _np(got) / E_true
    ratio = ratio[np.abs(E_true) > 1e-3]
    assert np.std(ratio) / abs(np.mean(ratio)) < 1e-3


def test_pose_from_fundamental(scene):
    """F of 128 exact matches of the scene (the JAX eight-point) -> [R|t]:
    R within 1e-2 of the truth and cos(t) > 0.999 on both sides, and the
    port's [R|t] and P2 against JAX's to 1e-4."""
    match = js.build_matches(jnp.asarray(scene["flow"]))[:, ::64]  # [2,128,4]

    @jax.jit
    def want(match, K):
        F = jax.vmap(jr.eight_point)(match[..., :2], match[..., 2:])
        return F, jtp.pose_from_fundamental(F, K, match)

    F, (jP1, jP2, jRt) = want(match, scene["K"])
    P1, P2, Rt = ttp.pose_from_fundamental(_t(F), _t(scene["K"]), _t(match))
    _against_truth(Rt, scene["R"], scene["t"])
    _against_truth(jRt, scene["R"], scene["t"])
    np.testing.assert_allclose(_np(Rt), np.asarray(jRt), atol=1e-4)
    _rel(P1, jP1, 1e-6)
    _rel(P2, jP2, 1e-4)


def test_ray_angle_weights(scene):
    """The rays' validity under the true pose: equal to JAX's, and nearly
    all rays well conditioned (a real baseline)."""
    match = js.build_matches(jnp.asarray(scene["flow"]))[:, ::16]
    K = jnp.asarray(scene["K"])
    P1 = K @ jnp.eye(3, 4)[None]
    P2 = K @ jnp.concatenate([scene["R"], scene["t"][..., None]], -1)
    want = jax.jit(jtp.ray_angle_weights)(match, K, P1, P2)
    got = ttp.ray_angle_weights(_t(match), _t(K), _t(P1), _t(P2))
    assert got.shape == (2, match.shape[1], 1)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert float(got.mean()) > 0.9


def _jax_geometry(key, flow, K, K_inv):
    """The JAX model's geometric half, line for line
    (triangulation_pose.py:166-180)."""
    matches = js.build_matches(flow)
    b, n, _ = matches.shape
    sel, _ = js.random_sample(key, matches, jnp.zeros((b, n, 1)), POINTS)
    F, _ = jr.batched_ransac_fundamental(key, sel[..., :2], sel[..., 2:], iters=ITERS, thres=0.1)
    verify, _ = js.random_sample(key, sel, jnp.zeros((b, POINTS, 1)), 200)
    P1, P2, Rt = jtp.pose_from_fundamental(F, K, verify)
    _, tri_depth = jt.reproject(P1, jt.midpoint_triangulate(sel, K_inv, P1, P2))
    return Rt, P2, sel, tri_depth


def test_geometry_on_rigid_flow(scene):
    """The geometric half on the scene's exact rigid flow with JAX's draws:
    [R|t] to 1e-4 and the truth; P2, the sampled matches and the
    triangulated depths to 1e-4 relative."""
    K, K_inv, flow = (jnp.asarray(scene[k]) for k in ("K", "K_inv", "flow"))
    want = jax.jit(_jax_geometry)(KEY, flow, K, K_inv)
    got = ttp.two_view_geometry(_t(flow), _t(K), _t(K_inv), jax_draws(KEY, 2, H * W))
    _against_truth(got[0], scene["R"], scene["t"])
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), atol=1e-4)
    for g, w in zip(got[1:], want[1:]):
        _rel(g, w, 1e-4)
    assert float(got[3].min()) > 0  # the chirality vote chose the depths in front


def test_draws():
    """The default draws: seed 0 every call, in range; a generator of the
    caller's draws otherwise."""
    a = ttp.draw_two_view(2, (H, W), POINTS, ITERS)
    b = ttp.draw_two_view(2, (H, W), POINTS, ITERS)
    assert {k: v.shape for k, v in a.items()} == {
        "sample": (2, POINTS), "ransac": (2, ITERS, 8), "verify": (2, ttp.VERIFY_POINTS)}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert int(a["sample"].max()) < H * W and int(a["ransac"].max()) < POINTS
    c = ttp.draw_two_view(2, (H, W), POINTS, ITERS, torch.Generator().manual_seed(5))
    assert not torch.equal(a["sample"], c["sample"])


# ------------------------------------------------------------------ model


def _frames(seed):
    rng = np.random.RandomState(seed)
    return rng.rand(B, H, W, 3).astype(np.float32), rng.rand(B, H, W, 3).astype(np.float32)


def test_inference_against_jax(nets):
    """``inference`` at the nets' initialisation with JAX's draws: flow to
    1e-4 px, disparities to 2e-5, the sampled matches to 1e-4 px; [R|t],
    P2 and the triangulated depths are the geometric half of the model's
    own flow (at a flow below 1e-2 px F follows rounding: module
    docstring). The
    model runs in eval mode and leaves its mode and statistics as they
    were."""
    _, _, tv, _, variables, jinf = nets
    a, b = _frames(0)
    K, K_inv = _intrinsics(B)
    want = jinf(variables, a, b, K, K_inv)
    draws = jax_draws(KEY, B, H * W)
    model = copy.deepcopy(tv).train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = model.inference(_t(a), _t(b), _t(K), _t(K_inv), draws=draws)
    assert model.training and all(m.training for m in model.modules())
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    assert float(np.abs(np.asarray(want[0])).max()) < 1e-2  # the degenerate regime
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), atol=1e-4)
    np.testing.assert_allclose(_np(got[1]), np.asarray(want[1]), atol=2e-5)
    np.testing.assert_allclose(_np(got[2]), np.asarray(want[2]), atol=2e-5)
    np.testing.assert_allclose(_np(got[5][0]), np.asarray(want[5][0]), atol=1e-4)
    geo = ttp.two_view_geometry(got[0], _t(K), _t(K_inv), draws)
    for g, w in zip((got[3], got[4], *got[5]), geo):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert got[3].shape == (B, 3, 4) and got[5][1].shape == (B, POINTS, 1)
    R = _np(got[3])[:, :, :3]
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.tile(np.eye(3), (B, 1, 1)), atol=1e-4)
    # without draws: the seed-0 draws of ``draw``
    default = tv.inference(_t(a), _t(b), _t(K), _t(K_inv))
    again = tv.inference(_t(a), _t(b), _t(K), _t(K_inv), draws=tv.draw(B, (H, W)))
    torch.testing.assert_close(default[3], again[3], rtol=0, atol=0)


class _NoFeatures(fnn.Module):
    def __call__(self, img):
        return None


class _FixedFlow(fnn.Module):
    """Stands in for the JAX PWC decoder: returns a given flow."""

    flow: Any

    def __call__(self, f1, f2, hw):
        return (self.flow,)


class _JRigid(jtp.TriangulationPoseModel):
    """The JAX two-view model with the flow nets replaced by a given flow;
    the depth net and the geometry are its own."""

    flow: Any = None

    def setup(self):
        self.fpyramid = _NoFeatures()
        self.pwc = _FixedFlow(self.flow)
        self.depth_net = JDepthNet(num_scales=self.num_scales, dtype=self.dtype)


def test_inference_and_loss_on_rigid_flow(nets, scene):
    """The whole model with the flow nets replaced by the scene's rigid flow
    in both packages (the depth net and the geometry their own):
    ``inference`` [R|t] to 1e-4 (and the truth), P2, the sampled matches
    and the triangulated depths to 1e-4 relative, disparities to 2e-5;
    ``triangulation_depth_loss`` to 1e-4 relative (nonzero)."""
    _, _, tv, _, variables, _ = nets
    flow, K, K_inv = scene["flow"], scene["K"], scene["K_inv"]
    a, b = (x[:2] for x in _frames(1))
    jm = _JRigid(ransac_iters=ITERS, ransac_points=POINTS, flow=jnp.asarray(flow))
    jvars = {"params": {"depth_net": variables["params"]["depth_net"]},
             "batch_stats": variables["batch_stats"]}

    @jax.jit
    def run(v):
        return (jm.apply(v, a, b, K, K_inv, method=jm.inference),
                jm.apply(v, a, b, K, K_inv, method=jm.triangulation_depth_loss))

    want, want_loss = run(jvars)
    model = copy.deepcopy(tv)
    model.fpyramid.forward = lambda img: None
    model.pwc_model.forward = lambda f1, f2, hw: [_t(flow)]
    draws = jax_draws(KEY, 2, H * W)
    got = model.inference(_t(a), _t(b), _t(K), _t(K_inv), draws=draws)
    _against_truth(got[3], scene["R"], scene["t"])
    np.testing.assert_allclose(_np(got[3]), np.asarray(want[3]), atol=1e-4)
    np.testing.assert_allclose(_np(got[1]), np.asarray(want[1]), atol=2e-5)
    for g, w in ((got[4], want[4]), (got[5][0], want[5][0]), (got[5][1], want[5][1])):
        _rel(g, w, 1e-4)
    loss = model.triangulation_depth_loss(_t(a), _t(b), _t(K), _t(K_inv), draws=draws)
    assert (np.asarray(want_loss) > 0).all()
    np.testing.assert_allclose(_np(loss), np.asarray(want_loss), rtol=1e-4)


def test_two_view_model_from_joint_at_loss_base_scale():
    """Under loss_base_scale the joint depth net's extra coarse heads are
    left out; the two-view model's disparities are the joint model's."""
    cfg = Config(**MODEL, loss_base_scale=1)
    joint = build_model(cfg, "cpu")
    _bn_stats(joint, seed=2)
    assert len(joint.depth_net.decoder.dispconvs) == cfg.num_scales + 1
    tv = tcli.two_view_model(joint, cfg)
    a, b = _frames(2)
    K, K_inv = _intrinsics(B)
    got = tv.inference(*map(_t, (a[:2], b[:2], K[:2], K_inv[:2])))
    torch.testing.assert_close(got[1], joint.infer_disp(_t(a[:2])), rtol=0, atol=0)
    torch.testing.assert_close(got[0], joint.inference_flow(_t(a[:2]), _t(b[:2])), rtol=0, atol=0)


# ---------------------------------------------------------- eval and CLI


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return kitti_flow_tree(str(tmp_path_factory.mktemp("kflow")), 200)


def _limited(cls, n=B):
    """The real flow eval dataset over the first ``n`` pairs of a tree."""
    def make(d, mode, img_hw):
        ds = cls(d, mode=mode, img_hw=img_hw)
        ds.num_total = n
        return ds
    return make


def _jax_two_view_fn(nets):
    """The JAX two-view inference of ``make_two_view_inference_fn`` (the
    jitted ``inference`` with its default key), on the fixture's compile."""
    *_, variables, jinf = nets
    return lambda img1, img2, K, K_inv: jinf(variables, img1, img2, K, K_inv)[:4]


def _jax_flow_metrics(nets, tree, monkeypatch, gt, noc, moving):
    monkeypatch.setattr(jtasks, "KittiFlowEval", _limited(JFlowEval))
    jcfg = JConfig(img_hw=(H, W), gt_2015_dir=tree)
    return jtasks.test_kitti_flow(jcfg, None, gt, noc, "kitti_2015", moving_masks=moving,
                                  two_view_fn=_jax_two_view_fn(nets))


def test_kitti_flow_task_two_view(nets, tree, monkeypatch):
    """test_kitti_flow with ``two_view_fn`` on the first 8 pairs (moving
    masks on): EPEs to 1e-4, Fl rates to 1e-3 (PERF.md section 2)."""
    tv = nets[2]
    monkeypatch.setattr(ttasks, "KittiFlowEval", _limited(TFlowEval))
    pairs = [_read_flow_gt_worker(tree, i) for i in range(B)]
    gt, noc = [p[0] for p in pairs], [p[1] for p in pairs]
    moving = [(g[..., 0] > 0).astype(np.float64) for g in gt]
    want = _jax_flow_metrics(nets, tree, monkeypatch, gt, noc, moving)
    tcfg = Config(img_hw=(H, W), gt_2015_dir=tree)
    got = ttasks.test_kitti_flow(tcfg, None, gt, noc, "kitti_2015", moving_masks=moving,
                                 two_view_fn=ttasks.make_two_view_inference_fn(tv, "cpu"))
    assert list(got) == list(want) and len(got) == 8
    for k in got:
        assert abs(got[k] - want[k]) <= (1e-3 if k.startswith("fl") else 1e-4), (k, got, want)


def test_two_view_inference_fn(nets):
    """make_two_view_inference_fn: numpy (flow, disp1, disp2, Rt) of the
    model's inference with its default draws; CUDA unless asked for the
    CPU."""
    tv = nets[2]
    a, b = _frames(3)
    K, K_inv = _intrinsics(B)
    out = ttasks.make_two_view_inference_fn(tv, "cpu")(a, b, K, K_inv)
    want = tv.inference(*map(_t, (a, b, K, K_inv)))
    assert [o.shape for o in out] == [(B, H, W, 2), (B, H, W, 1), (B, H, W, 1), (B, 3, 4)]
    for o, w in zip(out, want[:4]):
        np.testing.assert_array_equal(o, _np(w))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ttasks.make_two_view_inference_fn(copy.deepcopy(tv))


def test_eval_cli_two_view_against_jax(nets, tree, tmp_path, monkeypatch, capsys):
    """``python -m ...test --mode two_view --task kitti_flow_2015`` on the
    CPU from the joint checkpoint (``run(args, device="cpu")``), on the first
    8 pairs: the metrics it prints are JAX's two-view flow task's on the
    same weights, to 1e-4 (EPE) and 1e-3 (Fl) plus the print's rounding."""
    _, ckpt, *_ = nets
    yaml = tmp_path / "eval.yaml"
    yaml.write_text(f"img_hw: [{H}, {W}]\ngt_2015_dir: {tree}\nransac_iters: {ITERS}\n"
                    f"ransac_points: {POINTS}\n")
    monkeypatch.setattr(ttasks, "KittiFlowEval", _limited(TFlowEval))
    tcli.run(tcli.parse_args(["-c", str(yaml), "--mode", "two_view", "--task", "kitti_flow_2015",
                              "--pretrained_model", ckpt, "--result_dir", str(tmp_path / "r")]),
             device="cpu")
    out = capsys.readouterr().out
    assert f"restored checkpoint from {ckpt}" in out and "[EVAL] [kitti_2015]" in out
    header, values = out.strip().splitlines()[-2:]
    got = dict(zip([h.strip() for h in header.split(",")], [float(v) for v in values.split(",")]))
    pairs = [_read_flow_gt_worker(tree, i) for i in range(200)]
    gt, noc = [p[0] for p in pairs], [p[1] for p in pairs]
    want = _jax_flow_metrics(nets, tree, monkeypatch, gt, noc, load_gt_mask(tree))
    assert len(got) == 8
    for k, v in got.items():
        assert abs(v - want[k]) <= (1e-3 if k.startswith("fl") else 1e-4) + 5e-5, (k, got, want)


# ------------------------------------------------------------ debug drawing


def test_debug_drawing(scene, tmp_path):
    """The debug drawings equal the JAX package's pixel for pixel; the ray
    plot's dot product and PNG."""
    rng = np.random.RandomState(4)
    img1, img2 = rng.rand(H, W, 3), rng.rand(H, W, 3)
    match = ttp.build_matches(_t(scene["flow"])).numpy()[0, ::37]
    t = scene["t"][0]
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    F = scene["K_inv"][0].T @ tx @ scene["R"][0] @ scene["K_inv"][0]  # the true F
    canvas = tvis.draw_correspondences(img1, img2, match, num=30)
    np.testing.assert_array_equal(canvas, jdebug.draw_correspondences(img1, img2, match, num=30))
    assert canvas.shape == (H, 2 * W, 3) and canvas.dtype == np.uint8
    lines = tvis.draw_epipolar_lines(img1, img2, F, match[:, :2], num=10)
    np.testing.assert_array_equal(lines, jdebug.draw_epipolar_lines(img1, img2, F, match[:, :2], num=10))
    assert (lines != np.ascontiguousarray((img2 * 255).astype(np.uint8))).any()
    tvis.save_debug_pair(str(tmp_path), "pair", canvas)
    assert os.path.isfile(tmp_path / "pair.png")
    K = scene["K"][0]
    P1 = K @ np.eye(3, 4)
    P2 = K @ np.concatenate([scene["R"][0], scene["t"][0][:, None]], -1)
    dot = tvis.plot_two_rays(match[3], P1, P2, out_path=str(tmp_path / "rays.png"))
    assert dot == jdebug.plot_two_rays(match[3], P1, P2) and 0.9 < dot < 1.0
    assert os.path.isfile(tmp_path / "rays.png")
