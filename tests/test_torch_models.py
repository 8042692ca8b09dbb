"""The port's four networks against the JAX package's, on JAX-initialised
weights carried across by ``load_jax_variables``, at 64x128 in f32 on the
CPU. Also the weight round trip JAX -> port -> JAX.

Tolerances are stated per test: the two packages run the same f32 convs
through different libraries (XLA vs oneDNN), which sum in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsupervised_depth_opticalflow_egomotion_torch.config import Config
from unsupervised_depth_opticalflow_egomotion_torch.parallel import build_model
from unsupervised_depth_opticalflow_egomotion_torch.utils.jax_weights import (
    jax_state_dict,
    load_jax_variables,
)
from unsupervised_depth_opticalflow_egomotion_tpu.config import Config as JConfig
from unsupervised_depth_opticalflow_egomotion_tpu.parallel import init_state
from unsupervised_depth_opticalflow_egomotion_tpu.utils.torch_port import port_model_geometry

pytestmark = pytest.mark.model
torch.set_num_threads(2)

H, W = 64, 128
CFG = dict(img_hw=(H, W), batch_size=2, compute_dtype="float32", ssim_impl="xla")


@pytest.fixture(scope="module")
def nets():
    jmodel, state = init_state(JConfig(**CFG), jax.random.PRNGKey(0))
    variables = {"params": state.params, "batch_stats": state.batch_stats}

    def port():
        model = build_model(Config(**CFG), "cpu")
        load_jax_variables(model, state.params, state.batch_stats)
        return model

    return jmodel, variables, port


def _img(c=3, seed=0):
    return np.random.RandomState(seed).rand(2, H, W, c).astype(np.float32)


def _run(jmodel, variables, fn, *args, mutable=False):
    return jax.jit(
        lambda v, *a: jmodel.apply(v, *a, method=fn, mutable=mutable)
    )(variables, *args)


@pytest.mark.parametrize("train", [False, True])
def test_depth_net(nets, train):
    """Disparity pyramid (sigmoid, in [0, 1]) to 2e-5 absolute, and in train
    mode the updated BatchNorm running statistics to 1e-5 relative."""
    jmodel, variables, port = nets
    img = _img()
    out = _run(jmodel, variables, lambda m, x: m.depth_net(x, train), jnp.asarray(img),
               mutable=["batch_stats"] if train else False)
    want, new_stats = out if train else (out, None)
    model = port()
    model.depth_net.train(train)
    with torch.no_grad():
        got = model.depth_net(torch.from_numpy(img))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)
    if train:
        stats = jax.tree_util.tree_map(np.asarray, dict(variables["batch_stats"]))
        stats["depth_net"] = jax.tree_util.tree_map(np.asarray, new_stats["batch_stats"]["depth_net"])
        want_sd = jax_state_dict(variables["params"], stats)
        sd = model.state_dict()
        keys = [k for k in sd if k.endswith(("running_mean", "running_var"))]
        assert len(keys) == 2 * 20
        for k in keys:
            np.testing.assert_allclose(sd[k].numpy(), want_sd[k].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_pose_net(nets):
    """Pose [B, 2, 6] (0.01-scaled, ~1e-3) to 1e-6 absolute; the attention
    Linear layers are sized by img_hw (1 position at 64x128)."""
    jmodel, variables, port = nets
    imgs = _img(9, seed=1)
    want = _run(jmodel, variables, lambda m, x: m.pose_net(x), jnp.asarray(imgs))
    with torch.no_grad():
        got = port().pose_net(torch.from_numpy(imgs))
    assert got.shape == (2, 2, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_feature_pyramid_and_pwc_decoder(nets):
    """The six features to 1e-5 relative; the four flows from the JAX
    features to 1e-4 absolute (pixel units; 25 chained convs and four
    warps of the features, with the cost volumes in between)."""
    jmodel, variables, port = nets
    img1, img2 = _img(seed=2), _img(seed=3)
    jf1 = _run(jmodel, variables, lambda m, x: m.fpyramid(x), jnp.asarray(img1))
    jf2 = _run(jmodel, variables, lambda m, x: m.fpyramid(x), jnp.asarray(img2))
    model = port()
    with torch.no_grad():
        f1 = model.fpyramid(torch.from_numpy(img1))
    assert len(f1) == 6
    for g, w in zip(f1, jf1):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    want = _run(jmodel, variables, lambda m, a, b: m.pwc(a, b, (H, W)), jf1, jf2)
    with torch.no_grad():
        got = model.pwc_model(
            tuple(torch.from_numpy(np.asarray(f)) for f in jf1),
            tuple(torch.from_numpy(np.asarray(f)) for f in jf2),
            (H, W),
        )
    assert [tuple(g.shape) for g in got] == [(2, H >> s, W >> s, 2) for s in range(4)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_weight_round_trip(nets):
    """JAX init -> load_jax_variables -> port state_dict -> the JAX package's
    port_model_geometry gives back the original tree exactly (bit-equal)."""
    _, variables, port = nets
    sd = {k: v.numpy() for k, v in port().state_dict().items()}
    back = port_model_geometry(sd, num_scales=3)
    for name in ("params", "batch_stats"):
        want = jax.tree_util.tree_flatten_with_path(dict(variables[name]))
        got = jax.tree_util.tree_flatten_with_path(back[name])
        assert [jax.tree_util.keystr(p) for p, _ in got[0]] == [
            jax.tree_util.keystr(p) for p, _ in want[0]
        ]
        for (p, g), (_, w) in zip(got[0], want[0]):
            assert g.dtype == np.float32 and g.shape == w.shape, jax.tree_util.keystr(p)
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=jax.tree_util.keystr(p))


def test_load_rejects_unmapped_variables(nets):
    _, variables, port = nets
    params = dict(variables["params"])
    params["extra"] = {"kernel": np.zeros((1,), np.float32)}
    with pytest.raises(ValueError, match="unmapped"):
        load_jax_variables(port(), params, variables["batch_stats"])
