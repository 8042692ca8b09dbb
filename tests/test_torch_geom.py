"""The whole slice: the port's geom loss pack, gradients, BatchNorm statistics
and Adam moments after one step, against the JAX package's ``forward_geom``
and ``make_train_step`` on the same weights and batch.

Config(img_hw=(64, 128), batch_size=2, compute_dtype="float32",
ssim_impl="xla") on uint8 frames, on the CPU. The port's kernels run their
plain versions here; the JAX package runs its exact XLA forms.
"""

import jax
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from unsupervised_depth_opticalflow_egomotion_torch.config import Config
from unsupervised_depth_opticalflow_egomotion_torch.parallel import (
    build_model,
    make_optimizer,
    make_train_step,
)
from unsupervised_depth_opticalflow_egomotion_torch.utils.jax_weights import (
    jax_state_dict,
    load_jax_variables,
)
from unsupervised_depth_opticalflow_egomotion_tpu.config import Config as JConfig
from unsupervised_depth_opticalflow_egomotion_tpu.parallel import init_state
from unsupervised_depth_opticalflow_egomotion_tpu.parallel import (
    make_optimizer as j_make_optimizer,
)
from unsupervised_depth_opticalflow_egomotion_tpu.parallel import (
    make_train_step as j_make_train_step,
)

pytestmark = pytest.mark.parity
torch.set_num_threads(2)

H, W, B = 64, 128, 2
CFG = dict(img_hw=(H, W), batch_size=B, compute_dtype="float32", ssim_impl="xla")


def _batch():
    rng = np.random.RandomState(0)
    images = (rng.rand(B, 3 * H, W, 3) * 255).astype(np.uint8)
    K = np.array([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]], np.float32)
    K_ms = np.stack([np.diag([1 / 2**s, 1 / 2**s, 1.0]).astype(np.float32) @ K for s in range(3)])
    K_inv_ms = np.stack([np.linalg.inv(k) for k in K_ms]).astype(np.float32)
    return images, np.tile(K_ms[None], (B, 1, 1, 1)), np.tile(K_inv_ms[None], (B, 1, 1, 1))


def run_both():
    """One JAX forward_geom and one JAX train step, and the port's forward
    and train step, on the same JAX-initialised weights and batch."""
    batch = _batch()
    jcfg = JConfig(**CFG)
    jmodel, state = init_state(jcfg, jax.random.PRNGKey(0))
    # host copies: the JAX step donates (deletes) the state it is given
    params, stats0 = (jax.tree_util.tree_map(np.asarray, x) for x in (state.params, state.batch_stats))
    unravel = ravel_pytree(state.params)[1]
    fwd = jax.jit(lambda v, *b: jmodel.apply(
        v, *b, train=True, method=jmodel.forward_geom, mutable=["batch_stats"]
    ))
    (jpack, _), jstats = fwd({"params": state.params, "batch_stats": state.batch_stats}, *batch)
    tx = j_make_optimizer(jcfg, state.params)
    new_state, jmetrics = j_make_train_step(jmodel, jcfg, tx)(state, batch, jax.random.PRNGKey(1))
    adam = new_state.opt_state[0]  # optax.flatten(adam): moments of the raveled params
    j = dict(
        pack={k: np.asarray(v) for k, v in jpack.items()},
        stats=jax_state_dict(params, jstats["batch_stats"]),
        metrics={k: float(v) for k, v in jmetrics.items()},
        # after one step mu = (1 - b1) g and nu = (1 - b2) g^2, b1 = 0.9
        grads=jax_state_dict(unravel(adam.mu / 0.1), stats0),
        mu=jax_state_dict(unravel(adam.mu), stats0),
        nu=jax_state_dict(unravel(adam.nu), stats0),
        step_stats=jax_state_dict(params, new_state.batch_stats),
    )

    cfg = Config(**CFG)
    model = build_model(cfg, "cpu")
    tbatch = tuple(torch.from_numpy(x) for x in batch)
    load_jax_variables(model, params, stats0)
    with torch.no_grad():
        pack, _ = model.forward_geom(*tbatch)
    fwd_stats = {k: v.clone() for k, v in model.state_dict().items()}
    load_jax_variables(model, params, stats0)  # undo the forward's BN update
    opt = make_optimizer(cfg, model)
    metrics = make_train_step(model, cfg, opt)(tbatch)
    named = dict(model.named_parameters())
    t = dict(
        pack={k: v.numpy() for k, v in pack.items()},
        stats=fwd_stats,
        metrics={k: float(v) for k, v in metrics.items()},
        grads={k: p.grad.clone() for k, p in named.items()},
        mu={k: opt.state[p]["exp_avg"].clone() for k, p in named.items()},
        nu={k: opt.state[p]["exp_avg_sq"].clone() for k, p in named.items()},
        step_stats={k: v.clone() for k, v in model.state_dict().items()},
    )
    return t, j


@pytest.fixture(scope="module")
def both():
    return run_both()


def test_loss_pack_matches_forward_geom(both):
    """Every key, per batch item. Tolerance 1e-3 relative (+1e-7 absolute):
    the hard masks (texture, occlusion, dynamic) compare photometric and
    flow residuals that differ by f32 rounding between the packages, and a
    pixel that flips moves a loss by ~1e-4 of its value at 64x128. The
    epipolar distance is ~1e-5 at init and rides the same rounding."""
    t, j = both
    assert set(t["pack"]) == set(j["pack"])
    for k, want in j["pack"].items():
        assert t["pack"][k].shape == want.shape == (B,)
        np.testing.assert_allclose(t["pack"][k], want, rtol=1e-3, atol=1e-7, err_msg=k)
    live = [k for k, v in j["pack"].items() if np.abs(v).max() > 0]
    assert len(live) == 8, live


def test_metrics_match_train_step(both):
    """The step's means and the weighted loss_total; tolerance as above."""
    t, j = both
    assert set(t["metrics"]) == set(j["metrics"])
    for k, want in j["metrics"].items():
        np.testing.assert_allclose(t["metrics"][k], want, rtol=1e-3, atol=1e-7, err_msg=k)


def _rel_err(got, want):
    got, want = got.detach().numpy(), want.numpy()
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("moment", ["grads", "mu", "nu"])
def test_gradients_and_adam_moments(both, moment):
    """Gradients (JAX's from its first Adam moment) and both Adam moments.

    Per network, the relative L2 error under 2e-2. Tensor by tensor, the max
    error relative to the tensor's max-abs under 0.2, and the median tensor
    under 5e-3. The step is ill-conditioned in f32 at init, in both
    packages: the flows are ~1e-4 px, so the flow consistency loss
    normalises near-zero vectors, and the deepest encoder layers backpropagate
    through BatchNorm over 48 values per channel. A float64 run of the port
    is as far from either f32 run on those tensors as the two packages are
    from each other. Tensors whose gradient is zero up to rounding (max-abs
    under 1e-9, e.g. PoseNet's query bias, which the softmax cancels) are
    left out of the per-tensor check.
    """
    t, j = both
    names = list(t[moment])
    assert len(names) == len(j[moment]) - 40  # the port's params; no running stats
    for net in ("depth_net", "pose_net", "fpyramid", "pwc_model"):
        ks = [k for k in names if k.startswith(net + ".")]
        got = torch.cat([t[moment][k].flatten() for k in ks])
        want = torch.cat([j[moment][k].flatten() for k in ks])
        assert ((got - want).norm() / want.norm()).item() < 2e-2, net
    errs = {k: _rel_err(t[moment][k], j[moment][k]) for k in names
            if j[moment][k].abs().max() >= 1e-9}
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    assert worst[0][1] < 0.2, worst
    assert np.median(list(errs.values())) < 5e-3, worst


def test_batch_stats_after_forward_and_step(both):
    """The running mean/var updated with flax's momentum 0.9 and the biased
    batch variance; 1e-4 relative to each tensor's max-abs."""
    t, j = both
    keys = [k for k in j["stats"] if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 40
    for which in ("stats", "step_stats"):
        for k in keys:
            assert _rel_err(t[which][k], j[which][k]) < 1e-4, (which, k)
