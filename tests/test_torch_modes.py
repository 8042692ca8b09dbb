"""The flow and depth training modes of the port against the JAX package.

``forward_flow`` under each of the five ``flow_occ_impl`` values and
``forward_depth`` (default, ``enable_depth_ssim``, ``enable_depth_consis``):
the loss pack on the same weights and batch; then one train step in flow
mode ("splat") and one in depth mode: metrics, gradients, Adam moments,
parameter updates and BatchNorm statistics, with the networks a mode does
not run left bit-equal.

Config(img_hw=(64, 128), batch_size=2, compute_dtype="float32") on uint8
frames, on the CPU, under the default ``ssim_impl="pallas"``. The port's
kernels run their plain versions here; the JAX package runs its exact XLA
forms. The weights are JAX-initialised once (the parameter tree does not
depend on the mode) with the five PWC flow heads scaled up, so that the
flows reach a few pixels and the occlusion masks are not trivially one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from unsupervised_depth_opticalflow_egomotion_torch.config import Config
from unsupervised_depth_opticalflow_egomotion_torch.parallel import (
    build_model,
    init_state,
    make_optimizer,
    make_train_step,
)
from unsupervised_depth_opticalflow_egomotion_torch.utils.jax_weights import (
    jax_state_dict,
    load_jax_variables,
)
from unsupervised_depth_opticalflow_egomotion_tpu.config import Config as JConfig
from unsupervised_depth_opticalflow_egomotion_tpu.parallel import build_model as j_build_model
from unsupervised_depth_opticalflow_egomotion_tpu.parallel import init_state as j_init_state
from unsupervised_depth_opticalflow_egomotion_tpu.parallel import (
    make_optimizer as j_make_optimizer,
)
from unsupervised_depth_opticalflow_egomotion_tpu.parallel import (
    make_train_step as j_make_train_step,
)
from unsupervised_depth_opticalflow_egomotion_tpu.parallel.train_step import TrainState

pytestmark = pytest.mark.parity
torch.set_num_threads(2)

H, W, B = 64, 128, 2
BASE = dict(img_hw=(H, W), batch_size=B, compute_dtype="float32")
FLOW_HEAD_SCALE = 1500.0
NETS = {"flow": ("fpyramid", "pwc_model"), "depth": ("depth_net", "pose_net")}


def _batch():
    rng = np.random.RandomState(0)
    images = (rng.rand(B, 3 * H, W, 3) * 255).astype(np.uint8)
    K = np.array([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]], np.float32)
    K_ms = np.stack([np.diag([1 / 2**s, 1 / 2**s, 1.0]).astype(np.float32) @ K for s in range(3)])
    K_inv_ms = np.stack([np.linalg.inv(k) for k in K_ms]).astype(np.float32)
    return images, np.tile(K_ms[None], (B, 1, 1, 1)), np.tile(K_inv_ms[None], (B, 1, 1, 1))


@pytest.fixture(scope="module")
def weights():
    """(params, batch_stats) as host arrays, flow heads scaled."""
    _, state = j_init_state(JConfig(**BASE), jax.random.PRNGKey(0))
    params, stats = (jax.tree_util.tree_map(np.asarray, x) for x in (state.params, state.batch_stats))
    pwc = {k: dict(v) for k, v in params["pwc"].items()}
    for name, block in pwc.items():
        if name.startswith("DenseFlowBlock"):
            block["Conv_0"] = jax.tree_util.tree_map(lambda v: v * FLOW_HEAD_SCALE, block["Conv_0"])
    return {**params, "pwc": pwc}, stats


def _jax_pack(kw, weights):
    params, stats = weights
    jmodel = j_build_model(JConfig(**BASE, **kw))
    if kw["mode"] == "flow":
        fn = lambda v, *b: jmodel.apply(v, *b, method=jmodel.forward_flow)  # noqa: E731
    else:
        fn = lambda v, *b: jmodel.apply(  # noqa: E731
            v, *b, train=True, method=jmodel.forward_depth, mutable=["batch_stats"]
        )[0]
    pack = jax.jit(fn)({"params": params, "batch_stats": stats}, *_batch())
    return {k: np.asarray(v) for k, v in pack.items()}


def _port_model(kw, weights):
    cfg = Config(**BASE, **kw)
    model = build_model(cfg, "cpu")
    load_jax_variables(model, *weights)
    return cfg, model


def _port_pack(kw, weights):
    _, model = _port_model(kw, weights)
    tbatch = tuple(torch.from_numpy(x) for x in _batch())
    fwd = model.forward_flow if kw["mode"] == "flow" else model.forward_depth
    with torch.no_grad():
        return {k: v.numpy() for k, v in fwd(*tbatch).items()}


def _assert_packs_match(got, want, live):
    """Every key, per batch item, 1e-3 relative + 1e-7 absolute: the hard
    masks (validity ``1 - all(warped == 0)``, the 0.9999 weight threshold,
    texture) flip single pixels at f32 rounding between the packages, and a
    flipped pixel moves a loss by ~1e-4 of its value at 64x128. The depth
    consistency ratio |c-p|/(c+p) is heavy-tailed (it is clamped at 1 on
    single pixels): one flipped pixel of the texture mask moves that loss by
    4e-4 of its value (measured by perturbing the frames by 1e-7), so it is
    held to 3e-3."""
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape == (B,)
        rtol = 3e-3 if k == "loss_depth_consis" else 1e-3
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=1e-7, err_msg=k)
    assert sorted(k for k, v in want.items() if np.abs(v).max() > 0) == sorted(live)


@pytest.mark.parametrize(
    "occ", ["splat", "splat_xla", "splat_nn", "splat_nn_half", "diff_weights"]
)
def test_forward_flow_matches_jax(weights, occ):
    kw = dict(mode="flow", flow_occ_impl=occ)
    got, want = _port_pack(kw, weights), _jax_pack(kw, weights)
    _assert_packs_match(
        got, want, ["loss_flow_consis", "loss_flow_pixel", "loss_flow_smooth", "loss_flow_ssim"]
    )


@pytest.mark.parametrize(
    "flags,live",
    [
        ({}, ["loss_depth_pixel", "loss_depth_smooth"]),
        ({"enable_depth_ssim": True}, ["loss_depth_pixel", "loss_depth_smooth", "loss_depth_ssim"]),
        ({"enable_depth_consis": True},
         ["loss_depth_consis", "loss_depth_pixel", "loss_depth_smooth"]),
    ],
)
def test_forward_depth_matches_jax(weights, flags, live):
    kw = dict(mode="depth", **flags)
    _assert_packs_match(_port_pack(kw, weights), _jax_pack(kw, weights), live)


def _rel_err(got, want):
    got, want = got.detach().numpy(), want.numpy()
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module", params=["flow", "depth"])
def step(request, weights):
    """One JAX train step and one step of the port in ``mode``."""
    mode = request.param
    kw = dict(mode=mode, flow_occ_impl="splat")
    params, stats = weights
    batch = _batch()
    jcfg = JConfig(**BASE, **kw)
    jmodel = j_build_model(jcfg)
    unravel = ravel_pytree(params)[1]
    tx = j_make_optimizer(jcfg, params)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)  # the step donates its state
    state = TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                       batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
                       opt_state=tx.init(jparams))
    new_state, jmetrics = j_make_train_step(jmodel, jcfg, tx)(state, batch, jax.random.PRNGKey(1))
    adam = new_state.opt_state[0]  # optax.flatten(adam): moments of the raveled params
    j = dict(
        metrics={k: float(v) for k, v in jmetrics.items()},
        # after one step mu = (1 - b1) g and nu = (1 - b2) g^2, b1 = 0.9
        grads=jax_state_dict(unravel(adam.mu / 0.1), stats),
        mu=jax_state_dict(unravel(adam.mu), stats),
        nu=jax_state_dict(unravel(adam.nu), stats),
        after=jax_state_dict(
            jax.tree_util.tree_map(np.asarray, new_state.params),
            jax.tree_util.tree_map(np.asarray, new_state.batch_stats),
        ),
    )
    cfg, model = _port_model(kw, weights)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = make_optimizer(cfg, model)
    metrics = make_train_step(model, cfg, opt)(tuple(torch.from_numpy(x) for x in batch))
    named = dict(model.named_parameters())
    t = dict(
        metrics={k: float(v) for k, v in metrics.items()},
        grads={k: p.grad for k, p in named.items()},
        mu={k: opt.state[p].get("exp_avg") for k, p in named.items()},
        nu={k: opt.state[p].get("exp_avg_sq") for k, p in named.items()},
        after={k: v.clone() for k, v in model.state_dict().items()},
    )
    return mode, before, t, j


def test_step_metrics_match_jax(step):
    """The step's loss means and the weighted loss_total; 1e-3 relative +
    1e-7 absolute, as the loss packs."""
    _, _, t, j = step
    assert set(t["metrics"]) == set(j["metrics"])
    for k, want in j["metrics"].items():
        np.testing.assert_allclose(t["metrics"][k], want, rtol=1e-3, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("moment", ["grads", "mu", "nu"])
def test_step_gradients_and_adam_moments(step, moment):
    """The networks the mode trains: per network the relative L2 error under
    2e-2; per tensor the max error under 0.2 of the tensor's max-abs, the
    median tensor under 5e-3 (the tolerances of tests/test_torch_geom.py;
    tensors with a max-abs under 1e-9 are left out of the per-tensor check).
    The second moment squares the gradient, so its relative error is twice
    the gradient's: its median is held to 1e-2.
    The other networks get no gradient: torch.optim.Adam keeps no moments
    for them where optax.adam keeps zeros."""
    mode, _, t, j = step
    trained = [k for k in t[moment] if k.startswith(tuple(n + "." for n in NETS[mode]))]
    others = [k for k in t[moment] if k not in trained]
    assert trained and others
    for k in others:
        assert t[moment][k] is None
        assert not j[moment][k].any()
    for net in NETS[mode]:
        ks = [k for k in trained if k.startswith(net + ".")]
        got = torch.cat([t[moment][k].flatten() for k in ks])
        want = torch.cat([j[moment][k].flatten() for k in ks])
        assert ((got - want).norm() / want.norm()).item() < 2e-2, net
    errs = {k: _rel_err(t[moment][k], j[moment][k]) for k in trained
            if j[moment][k].abs().max() >= 1e-9}
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    assert worst[0][1] < 0.2, worst
    assert np.median(list(errs.values())) < (1e-2 if moment == "nu" else 5e-3), worst


def test_step_parameters_and_batch_stats(step):
    """Untouched networks come out bit-equal to what went in, in both
    packages. In flow mode no BatchNorm module runs, so every running
    statistic is bit-equal too; in depth mode they match to 1e-4 of each
    tensor's max-abs. Trained parameters: Adam's first update is
    lr * g / (|g| + 1e-8), i.e. +-lr wherever |g| >> 1e-8, so an update
    differs only where a gradient entry changes sign or is ~1e-8: every
    entry within 2 lr, and under 2 % of a network's entries off by more
    than 0.1 lr."""
    mode, before, t, j = step
    lr = Config().lr
    for k, v in before.items():
        if not k.startswith(tuple(n + "." for n in NETS[mode])):
            assert torch.equal(t["after"][k], v), k
            assert torch.equal(j["after"][k], v), k
    stats = [k for k in before if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 40
    if mode == "depth":
        for k in stats:
            assert not torch.equal(t["after"][k], before[k]), k
            assert _rel_err(t["after"][k], j["after"][k]) < 1e-4, k
    for net in NETS[mode]:
        ks = [k for k in dict(before) if k.startswith(net + ".") and k not in stats
              and not k.endswith("num_batches_tracked")]
        got = torch.cat([(t["after"][k] - before[k]).flatten() for k in ks])
        want = torch.cat([(j["after"][k] - before[k]).flatten() for k in ks])
        assert got.abs().max() > 0.5 * lr
        assert (got - want).abs().max() <= 2.0 * lr * 1.001
        assert ((got - want).abs() > 0.1 * lr).float().mean() < 0.02, net


def test_geom_step_under_ssim_pallas_equals_xla_on_cpu():
    """On CPU tensors ``ssim_impl="pallas"`` runs the plain SSIM map, as
    "xla" does: one geom step gives bit-equal metrics and parameters."""
    batch = tuple(torch.from_numpy(x) for x in _batch())
    out = []
    for impl in ("pallas", "xla"):
        cfg = Config(**BASE, ssim_impl=impl)
        model, opt = init_state(cfg, "cpu")
        metrics = make_train_step(model, cfg, opt)(batch)
        out.append((metrics, model.state_dict()))
    assert Config().ssim_impl == "pallas"
    for k, v in out[0][0].items():
        assert torch.equal(v, out[1][0][k]), k
    for k, v in out[0][1].items():
        assert torch.equal(v, out[1][1][k]), k
