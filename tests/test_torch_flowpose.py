"""The port's flow-to-pose model family and attention modules against the
JAX package's, on the CPU in f32 at 64x128: ``FlowPoseNet``,
``PositionAttention`` and ``ChannelAttention`` (``gamma`` nonzero: at 0
both are the identity, which is all the JAX package's own test holds),
``FlowPoseModel``'s inference methods and its ``forward_train`` objective
with gradients and BatchNorm statistics, and the weights carried both ways.

Weights are the port's initialisation from its seed, with seeded nonzero
biases in ``FlowPoseNet`` (at zero biases the pose of the initialised flow
nets' near-zero flow is near zero too, and the warp is the identity) and
seeded BatchNorm running
statistics, carried to the JAX tree by ``jax_variables``. Tolerances:
the nets 1e-5 (1e-5 relative to the largest value for the pose), the loss
pack 1e-4 relative, the gradients of ``depth_net`` and ``flow_pose_net``
1e-3 relative L2 (tests/test_torch_geom.py), the running statistics 1e-5.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsupervised_depth_opticalflow_egomotion_torch.models import (
    ChannelAttention,
    FlowPoseModel,
    PositionAttention,
    TriangulationPoseModel,
)
from unsupervised_depth_opticalflow_egomotion_torch.models.layers import init_weights
from unsupervised_depth_opticalflow_egomotion_torch.utils.jax_weights import (
    jax_variables,
    load_jax_variables,
)
from unsupervised_depth_opticalflow_egomotion_tpu.models import attention as jatt
from unsupervised_depth_opticalflow_egomotion_tpu.models import flowpose_model as jfm
from unsupervised_depth_opticalflow_egomotion_tpu.models import flowpose_net as jfn

pytestmark = pytest.mark.quick
torch.set_num_threads(2)

B, H, W = 2, 64, 128


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, want, tol):
    got, want = _np(got), np.asarray(want)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30), (
        np.abs(got - want).max(), np.abs(want).max())


def _seeded(model, seed=0):
    """``model`` initialised from ``seed``, its FlowPoseNet biases and its
    BatchNorm running statistics set to seeded values."""
    init_weights(model, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    net = getattr(model, "flow_pose_net", None)
    with torch.no_grad():
        for name, p in net.named_parameters() if net is not None else ():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
        for name, t in model.named_buffers():
            if name.endswith("running_mean"):
                t.copy_(0.3 * torch.randn(t.shape, generator=g))
            elif name.endswith("running_var"):
                t.copy_(0.3 + 2.7 * torch.rand(t.shape, generator=g))
    return model


def _variables(model):
    params, stats = jax_variables(model)
    return {"params": params, "batch_stats": stats} if stats else {"params": params}


def _pair(seed=0):
    rng = np.random.RandomState(seed)
    return rng.rand(B, H, W, 3).astype(np.float32), rng.rand(B, H, W, 3).astype(np.float32)


def _k_pyramid():
    K = np.array([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]], np.float32)
    K_ms = np.stack([np.diag([0.5**s, 0.5**s, 1.0]).astype(np.float32) @ K for s in range(3)])
    K_inv = np.stack([np.linalg.inv(k) for k in K_ms]).astype(np.float32)
    return np.tile(K_ms[None], (B, 1, 1, 1)), np.tile(K_inv[None], (B, 1, 1, 1))


# ------------------------------------------------------------ the modules


def test_flowpose_net():
    """[B,6] pose vectors of a normalized flow, to 1e-5 of the largest."""
    holder = _seeded(FlowPoseModel())
    net = holder.flow_pose_net
    flow = (0.05 * np.random.RandomState(1).randn(B, H, W, 2)).astype(np.float32)
    params = jax_variables(holder)[0]["flow_pose_net"]
    want = jfn.FlowPoseNet().apply({"params": params}, jnp.asarray(flow))
    got = net(_t(flow))
    assert got.shape == (B, 6)
    _rel(got, want, 1e-5)


@pytest.mark.parametrize("kind", ["position", "channel"])
def test_attention(kind):
    """Each attention module at gamma 0.7 (nonzero: at 0 it is the
    identity) to 1e-5; at gamma 0 the identity."""
    x = (0.3 * np.random.RandomState(2).rand(B, 8, 16, 32)).astype(np.float32)
    if kind == "position":
        mod, jmod = PositionAttention(32), jatt.PositionAttention()
        init_weights(mod, torch.Generator().manual_seed(3))
    else:
        mod, jmod = ChannelAttention(), jatt.ChannelAttention()
    torch.testing.assert_close(mod(_t(x)), _t(x), rtol=0, atol=0)
    with torch.no_grad():
        mod.gamma.fill_(0.7)
    want = jmod.apply(_variables(mod), jnp.asarray(x))
    got = mod(_t(x))
    assert float(np.abs(np.asarray(want) - x).max()) > 1e-2  # the attention term counts
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


# ------------------------------------------------------------- the model


@pytest.fixture(scope="module")
def model():
    return _seeded(FlowPoseModel())


@pytest.fixture(scope="module")
def jax_run(model):
    """JAX's infer_pose and infer_depth on one pair, and forward_train's
    gradients, loss pack and BatchNorm statistics on a stack of another,
    from one compile: (inputs, pose, disp, grads, pack, stats)."""
    jm = jfm.FlowPoseModel()
    v = _variables(model)
    a, b = _pair(3)
    images = np.concatenate(_pair(4), 1)
    K_ms, K_inv = _k_pyramid()

    @jax.jit
    def run(params):
        def total(p):
            pack, state = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, images, K_ms,
                                   K_inv, train=True, method=jm.forward_train,
                                   mutable=["batch_stats"])
            return sum(x.mean() for x in pack.values()), (pack, state)

        grads, (pack, state) = jax.grad(total, has_aux=True)(params)
        w = {"params": params, "batch_stats": v["batch_stats"]}
        return (jm.apply(w, a, b, method=jm.infer_pose), jm.apply(w, a, method=jm.infer_depth),
                grads, pack, state["batch_stats"])

    return ((a, b, images, K_ms, K_inv), *run(v["params"]))


def test_infer_pose_and_depth(model, jax_run):
    """``infer_pose`` to 1e-5 of the largest pose value, ``infer_depth``
    (the disparity, on the running statistics) to 2e-5; both in eval mode,
    leaving the model's mode as it was."""
    (a, b, *_), want_pose, want_disp, *_ = jax_run
    m = copy.deepcopy(model).train()
    pose = m.infer_pose(_t(a), _t(b))
    disp = m.infer_depth(_t(a))
    assert m.training and all(x.training for x in m.modules())
    assert pose.shape == (B, 6) and float(pose.abs().max()) > 1e-3
    _rel(pose, want_pose, 1e-5)
    np.testing.assert_allclose(_np(disp), np.asarray(want_disp), atol=2e-5)
    assert not pose.requires_grad and not disp.requires_grad


def _grads_by_name(model, grads, stats):
    """JAX gradients carried to the port's parameter names."""
    holder = copy.deepcopy(model)
    load_jax_variables(holder, grads, stats)
    return dict(holder.named_parameters())


def test_forward_train(model, jax_run):
    """One train call of the pairwise objective against JAX: the loss pack
    to 1e-4 relative, the gradients of the depth net and FlowPoseNet to 1e-3
    relative L2, the flow nets' gradients none (JAX: exactly zero), the
    depth net's running statistics after the call (two updates in turn) to
    1e-5."""
    (_, _, images, K_ms, K_inv), _, _, jgrads, jpack, jstats = jax_run
    v = _variables(model)
    m = copy.deepcopy(model).train()
    pack = m.forward_train(_t(images), _t(K_ms), _t(K_inv))
    assert sorted(pack) == sorted(jpack)
    for k, x in pack.items():
        assert x.shape == (B,) and float(x.detach().abs().min()) > 0
        np.testing.assert_allclose(_np(x), np.asarray(jpack[k]), rtol=1e-4, atol=1e-7)
    sum(x.mean() for x in pack.values()).backward()
    want = _grads_by_name(model, jgrads, v["batch_stats"])
    for net in ("depth_net", "flow_pose_net"):
        names = [k for k, _ in m.named_parameters() if k.startswith(net + ".")]
        got = torch.cat([dict(m.named_parameters())[k].grad.flatten() for k in names])
        ref = torch.cat([want[k].detach().flatten() for k in names])
        assert float(ref.norm()) > 0
        assert float((got - ref).norm() / ref.norm()) <= 1e-3, net
    for k, p in m.named_parameters():
        if k.startswith(("fpyramid.", "pwc_model.")):
            assert p.grad is None and float(want[k].detach().abs().max()) == 0.0, k
    stats = copy.deepcopy(model)
    load_jax_variables(stats, v["params"], jstats)
    bufs = dict(stats.named_buffers())
    for k, t in m.named_buffers():
        np.testing.assert_allclose(_np(t), _np(bufs[k]), atol=1e-5)
        assert not torch.equal(t, dict(model.named_buffers())[k])


def test_forward_train_ssim_routes():
    """On the CPU both SSIM routes run the plain map: equal packs; an
    unknown route is refused."""
    m = _seeded(FlowPoseModel(ssim_impl="xla")).eval()
    m2 = copy.deepcopy(m)
    m2.ssim_impl = "pallas"
    a, b = _pair(5)
    K_ms, K_inv = _k_pyramid()
    args = (_t(np.concatenate([a, b], 1)), _t(K_ms), _t(K_inv))
    p1, p2 = m.forward_train(*args, train=False), m2.forward_train(*args, train=False)
    for k in p1:
        torch.testing.assert_close(p1[k], p2[k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="ssim_impl"):
        FlowPoseModel(ssim_impl="fused")


# ----------------------------------------------------------- the weights


def _models():
    return {
        "two_view": lambda: TriangulationPoseModel(num_scales=3),
        "flowpose": FlowPoseModel,
        "position": lambda: PositionAttention(16),
        "channel": ChannelAttention,
    }


@pytest.mark.parametrize("kind", list(_models()))
def test_weights_round_trip(kind):
    """Port -> JAX tree -> a fresh port model: every tensor bit-equal; the
    tree has exactly the expected groups; a leaf left over or missing is
    refused."""
    make = _models()[kind]
    src = _seeded(make(), seed=7)
    if hasattr(src, "gamma"):
        with torch.no_grad():
            src.gamma.fill_(0.25)
    params, stats = jax_variables(src)
    groups = {"two_view": ["depth_net", "fpyramid", "pwc"],
              "flowpose": ["depth_net", "flow_pose_net", "fpyramid", "pwc"],
              "position": ["gamma", "key_conv", "query_conv", "value_conv"],
              "channel": ["gamma"]}[kind]
    assert sorted(params) == groups
    assert sorted(stats) == (["depth_net"] if "depth_net" in groups else [])
    if kind == "flowpose":
        assert sorted(params["flow_pose_net"]) == [f"Conv_{i}" for i in range(8)]
        assert sorted(params["depth_net"]["DepthDecoder_0"]).count("ReflectConv3x3_0") == 1
        assert "ReflectConv3x3_1" not in params["depth_net"]["DepthDecoder_0"]
    dst = _seeded(make(), seed=8)
    load_jax_variables(dst, params, stats)
    for k, t in src.state_dict().items():
        assert torch.equal(t, dst.state_dict()[k]), k
    extra = copy.deepcopy(params)
    extra["stray"] = {"kernel": np.zeros((1, 1, 1, 1), np.float32)}
    with pytest.raises(ValueError, match="unmapped"):
        load_jax_variables(dst, extra, stats)
    missing = copy.deepcopy(params)
    missing.pop(groups[0])
    with pytest.raises(KeyError):
        load_jax_variables(dst, missing, stats)


def test_weights_refuse_an_unknown_model():
    with pytest.raises(TypeError, match="no JAX weight table"):
        jax_variables(torch.nn.Linear(2, 2))
