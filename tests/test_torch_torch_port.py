"""Import of reference ``Model_geometry`` checkpoints into the port
(``utils/torch_port.py``), on reference-form state_dicts made from the
port's own weights: DataParallel's ``module.`` prefix on every name and a
``num_batches_tracked`` counter beside every BatchNorm, as the reference's
checkpoints carry them. No reference checkpoint is in the repository."""

import jax
import numpy as np
import pytest
import torch

from unsupervised_depth_opticalflow_egomotion_torch.config import Config
from unsupervised_depth_opticalflow_egomotion_torch.parallel import build_model
from unsupervised_depth_opticalflow_egomotion_torch.utils.jax_weights import jax_variables
from unsupervised_depth_opticalflow_egomotion_torch.utils.torch_port import (
    load_model_geometry,
    strip_module_prefix,
)
from unsupervised_depth_opticalflow_egomotion_tpu.utils import torch_port as jtp

pytestmark = pytest.mark.quick
torch.set_num_threads(2)

CFG = dict(img_hw=(64, 128), batch_size=2, compute_dtype="float32")


@pytest.fixture(scope="module")
def source():
    """A model from another seed, with BatchNorm statistics away from their
    initial zeros and ones."""
    model = build_model(Config(**CFG, seed=7), "cpu")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            buf.copy_(torch.rand(buf.shape, generator=gen) + (0.5 if "var" in name else -0.5))
    return model


def _reference_form(model) -> dict:
    sd = {}
    for k, v in model.state_dict().items():
        sd["module." + k] = v.clone()
        if k.endswith(".running_var"):
            sd["module." + k.replace("running_var", "num_batches_tracked")] = torch.tensor(123)
    return sd


def test_strip_module_prefix_as_jax():
    sd = {"module.a.weight": 1, "b.bias": 2, "x.module.c": 3}
    assert strip_module_prefix(sd) == jtp.strip_module_prefix(sd) == {
        "a.weight": 1, "b.bias": 2, "x.module.c": 3}


@pytest.mark.parametrize("as_numpy", [False, True])
def test_reference_dict_loads_bit_equal(source, as_numpy):
    """Tensors or numpy arrays (``torch.load`` of a checkpoint, or a
    converted one): every parameter and statistic bit-equal; the counters
    are dropped (the port's BatchNorm keeps none)."""
    ref = _reference_form(source)
    assert sum(k.endswith("num_batches_tracked") for k in ref) == 20
    if as_numpy:
        ref = {k: v.numpy() for k, v in ref.items()}
    model = build_model(Config(**CFG), "cpu")
    load_model_geometry(model, ref)
    want = source.state_dict()
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_jax_port_of_the_reference_dict_equals_jax_variables(source):
    """The JAX package's ``port_model_geometry`` of the same reference-form
    dict (after its own ``strip_module_prefix``) gives the trees that
    ``jax_variables`` makes from the port's model, bit-equal."""
    ref = {k: v.numpy() for k, v in _reference_form(source).items()}
    back = jtp.port_model_geometry(jtp.strip_module_prefix(ref), num_scales=3)
    params, stats = jax_variables(source)
    for got, want in ((back["params"], params), (back["batch_stats"], stats)):
        g = jax.tree_util.tree_flatten_with_path(got)[0]
        w = jax.tree_util.tree_flatten_with_path(want)[0]
        assert [jax.tree_util.keystr(p) for p, _ in g] == [jax.tree_util.keystr(p) for p, _ in w]
        for (p, a), (_, b) in zip(g, w):
            np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(p))


@pytest.mark.parametrize("fault", ["missing", "shape", "unknown"])
def test_load_raises_on_a_mismatched_dict(source, fault):
    """A missing name, a wrong shape or an unknown name raises (a strict
    load), and names the key."""
    ref = _reference_form(source)
    key = "module.depth_net.encoder.encoder.layer2.0.conv1.weight"
    if fault == "missing":
        del ref[key]
    elif fault == "shape":
        ref[key] = ref[key][:, :-1]
    else:
        key = "module.depth_net.encoder.encoder.fc.weight"
        ref[key] = torch.zeros(3)
    with pytest.raises(RuntimeError, match=key[len("module."):].replace(".", r"\.")):
        load_model_geometry(build_model(Config(**CFG), "cpu"), ref)
