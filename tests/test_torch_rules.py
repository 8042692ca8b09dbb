"""Rules of the PyTorch port that hold without a card, and its train step on
the CPU.

The port imports neither JAX nor the JAX package; its entry points default
to CUDA and raise without it unless the caller passes ``device="cpu"``;
what it has not ported yet raises rather than runs something else; every
kernel-selecting ``Config`` value is validated.
"""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

from unsupervised_depth_opticalflow_egomotion_torch import config as tconfig
from unsupervised_depth_opticalflow_egomotion_torch.models.joint import JointModel
from unsupervised_depth_opticalflow_egomotion_torch.ops import cuda_lib
from unsupervised_depth_opticalflow_egomotion_torch.ops.ssim import ssim_route
from unsupervised_depth_opticalflow_egomotion_torch.parallel import (
    build_model,
    init_state,
    make_train_step,
)
from unsupervised_depth_opticalflow_egomotion_torch.parallel.train_step import (
    clip_by_global_norm,
)
from unsupervised_depth_opticalflow_egomotion_tpu import config as jconfig

pytestmark = pytest.mark.quick
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "unsupervised_depth_opticalflow_egomotion_torch"
H, W = 64, 128


def _cfg(**kw):
    base = dict(img_hw=(H, W), batch_size=2, compute_dtype="float32", ssim_impl="xla")
    base.update(kw)
    return tconfig.Config(**base)


def test_import_pulls_in_no_jax():
    """Every module of the package, imported in a fresh interpreter."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import unsupervised_depth_opticalflow_egomotion_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'optax', 'unsupervised_depth_opticalflow_egomotion_tpu')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith(p.__name__)]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_source_imports_nothing_of_jax():
    forbidden = ("jax", "jaxlib", "flax", "optax", "unsupervised_depth_opticalflow_egomotion_tpu")
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 20
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in forbidden, f"{f}: imports {n}"


def test_config_copy_equals_jax_config():
    """Same fields, defaults and loss weights as the JAX package's Config,
    but for the port's own fields (``PORT_ONLY_FIELDS``), whose defaults
    select what the JAX package runs."""
    tf = [(f.name, f.default) for f in dataclasses.fields(tconfig.Config)
          if f.name not in tconfig.PORT_ONLY_FIELDS]
    jf = [(f.name, f.default) for f in dataclasses.fields(jconfig.Config)]
    assert tf == jf
    assert tconfig.Config().flow_net == "pwc"
    assert tconfig.Config().ssim_impl == "pallas"
    assert tconfig.loss_weights(tconfig.Config()) == jconfig.loss_weights(jconfig.Config())
    with pytest.raises(ValueError):
        tconfig.Config(img_hw=(100, 128))


@pytest.mark.parametrize("preset", sorted(p.name for p in (REPO / "configs").glob("*.yaml")))
def test_load_config_copy_equals_jax(preset):
    """Each YAML preset, with an override, gives the same Config in both."""
    path = str(REPO / "configs" / preset)
    got = tconfig.load_config(path, batch_size=2)
    want = jconfig.load_config(path, batch_size=2)
    assert {k: getattr(got, k) for k in tconfig.PORT_ONLY_FIELDS} == {"flow_net": "pwc"}
    assert {k: v for k, v in dataclasses.asdict(got).items()
            if k not in tconfig.PORT_ONLY_FIELDS} == dataclasses.asdict(want)
    assert got.batch_size == 2


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(_cfg())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_state(_cfg(), "cuda")


def test_ssim_pallas_raises_for_cuda():
    """The routing of ssim_impl (the test keeps the name it had when 'pallas'
    raised for CUDA): 'pallas' is the SSIM kernel on a CUDA device and the
    plain map on CPU tensors; 'xla' is the plain map everywhere; an unknown
    name raises, also when the model is built; and no line of the port
    raises NotImplementedError for an SSIM implementation any more."""
    assert ssim_route("pallas", torch.device("cpu")) == "plain"
    assert ssim_route("xla", torch.device("cuda")) == "plain"
    assert ssim_route("pallas", torch.device("cuda")) == "kernel"
    with pytest.raises(ValueError):
        ssim_route("fused", torch.device("cpu"))
    with pytest.raises(ValueError):
        JointModel(_cfg(ssim_impl="fused"))
    build_model(_cfg(ssim_impl="pallas"), "cpu")
    for f in sorted(PKG.rglob("*.py")):
        for line in f.read_text().splitlines():
            assert not ("NotImplementedError" in line and "ssim" in line), f"{f}: {line}"


# option -> (mode, the loss it switches on)
_OPTION_LOSS = {
    "enable_triangle": ("geom", "loss_triangle"),
    "enable_pnp": ("geom", "loss_pnp"),
    "enable_eight_point": ("geom", "loss_eight_point"),
    "enable_depth_consis": ("geom", "loss_depth_consis"),
    "loss_base_scale": ("geom", "loss_total"),
    "encoder_int8": ("depth", "loss_depth_pixel"),
}


@pytest.mark.parametrize(
    "flag",
    [
        {"enable_triangle": True},
        {"enable_pnp": True},
        {"enable_eight_point": True},
        {"enable_depth_consis": True},
        {"loss_base_scale": 1},
        {"encoder_int8": True},
    ],
)
def test_unported_options_raise(flag):
    """The name is kept from when these six options raised: now each builds
    and trains. Two CPU steps on one batch with the same draws: the
    option's loss is finite and non-zero, and the first step moved it
    (through the parameters alone)."""
    (name,) = flag
    mode, loss = _OPTION_LOSS[name]
    cfg = _cfg(mode=mode, **flag)
    model, opt = init_state(cfg, "cpu")
    step = make_train_step(model, cfg, opt)
    m1, m2 = step(_batch(), 0), step(_batch(), 0)
    assert all(torch.isfinite(v) for v in (*m1.values(), *m2.values()))
    assert float(m1[loss]) != 0 and float(m1[loss]) != float(m2[loss]), (m1[loss], m2[loss])


def test_unported_modes_raise():
    """What raises at build time (the test keeps the name it had when only
    geom mode was ported): all three modes build, with depth consistency and
    the loss base scale too; an unknown mode or kernel-selecting value, or a
    loss base scale past the decoder's four flow scales, or ``encoder_int8``
    with a packed encoder segment (exclusive in the JAX package too), raises
    ValueError; ``encoder_int8`` builds in every mode."""
    for mode in ("flow", "depth", "geom"):
        assert build_model(_cfg(mode=mode), "cpu").cfg.mode == mode
        JointModel(_cfg(mode=mode, enable_depth_consis=True))
        JointModel(_cfg(mode=mode, loss_base_scale=1))
        JointModel(_cfg(mode=mode, encoder_int8=True))
    for bad in (
        {"mode": "stereo"}, {"flow_occ_impl": "splat_cuda"}, {"warp_impl": "windowed"},
        {"pwc_corr": "cudnn"}, {"loss_base_scale": 2}, {"loss_base_scale": -1},
        {"encoder_int8": True, "packed_encoder": True}, {"encoder_int8": True, "packed_stem": True},
    ):
        with pytest.raises(ValueError):
            JointModel(_cfg(**bad))


def test_kernel_sources_and_counters():
    assert cuda_lib.sources() == ["correlation", "reflect_pad", "splat", "ssim", "warp_gather"]
    from unsupervised_depth_opticalflow_egomotion_torch.ops import (
        cost_volume,
        reflect_pad,
        splat,
        ssim,
        warp,
    )

    kernels = (warp.WARP_GATHER, warp.WARP_GATHER_NOGRAD, warp.WARP_GATHER_BWD,
               cost_volume.CORR_FWD, cost_volume.CORR_BWD_DF1, cost_volume.CORR_BWD_DF2,
               ssim.SSIM_FWD, ssim.SSIM_BWD, splat.SPLAT_MASS,
               reflect_pad.REFLECT_PAD_FWD, reflect_pad.REFLECT_PAD_BWD)
    assert len({(k.library, k.symbol) for k in kernels}) == 11
    assert all(isinstance(k.launches, int) for k in kernels)
    assert all((REPO / k.source).is_file() for k in kernels)
    for k in kernels:  # every C entry is defined in its source
        assert f'extern "C" int {k.symbol}(' in (REPO / k.source).read_text(), k.symbol


def test_kernel_launch_signature():
    """A launch is told apart by its integer arguments (dtype codes, sizes)
    and by which pointers were given, not by the addresses; nothing is
    recorded before a launch."""
    from unsupervised_depth_opticalflow_egomotion_torch.ops import ssim, warp

    assert ssim.SSIM_FWD.seen == set() and ssim.SSIM_FWD.launches == 0
    a = ssim.SSIM_FWD.signature(1000, 2000, 3000, 1, 8, 256, 832, 3)
    b = ssim.SSIM_FWD.signature(4000, 5000, 6000, 1, 8, 256, 832, 3)
    assert a == b == (1, 8, 256, 832, 3)
    assert a != ssim.SSIM_FWD.signature(1000, 2000, 3000, 2, 8, 256, 832, 3)
    both = warp.WARP_GATHER_BWD.signature(1, 0, 2, 3, 4, 5, 1, 6, 7, 16, 64, 208, 64, 208)
    only_w = warp.WARP_GATHER_BWD.signature(1, 0, 2, 3, None, 5, 1, 6, 7, 16, 64, 208, 64, 208)
    assert both != only_w and both[-2:] == (True, True) and only_w[-2:] == (False, True)


@pytest.mark.parametrize("mode", ["flow", "depth"])
def test_train_step_modes_on_cpu(mode):
    """Two steps in flow and depth mode with the global-norm clip: finite
    losses, the mode's networks move, the others stay bit-equal."""
    cfg = _cfg(mode=mode, grad_clip_norm=1.0, ssim_impl="pallas", flow_occ_impl="splat")
    model, opt = init_state(cfg, "cpu")
    step = make_train_step(model, cfg, opt)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for _ in range(2):
        metrics = step(_batch())
        assert all(torch.isfinite(v) for v in metrics.values())
    after = model.state_dict()
    moved = {k for k in before if not torch.equal(before[k], after[k])}
    flow = {k for k in before if k.startswith(("pwc_model.", "fpyramid."))}
    if mode == "flow":
        assert flow <= moved and moved <= flow
    else:
        assert not flow & moved
        assert {"depth_net.encoder.encoder.conv1.weight", "pose_net.pose_conv.weight",
                "depth_net.encoder.encoder.bn1.running_var"} <= moved


def _batch(b=2):
    rng = np.random.RandomState(0)
    images = torch.from_numpy((rng.rand(b, 3 * H, W, 3) * 255).astype(np.uint8))
    K = np.array([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]], np.float32)
    K_ms = np.stack([np.diag([1 / 2**s, 1 / 2**s, 1.0]).astype(np.float32) @ K for s in range(3)])
    K_inv_ms = np.stack([np.linalg.inv(k) for k in K_ms]).astype(np.float32)
    tile = lambda x: torch.from_numpy(np.tile(x[None], (b, 1, 1, 1)))  # noqa: E731
    return images, tile(K_ms), tile(K_inv_ms)


@pytest.mark.parametrize("fix_flow", [False, True])
def test_train_step_on_cpu(fix_flow):
    """Two steps: finite losses, parameters and BatchNorm statistics move;
    with fix_flow the PWC/feature-pyramid parameters stay put."""
    cfg = _cfg(fix_flow=fix_flow, grad_clip_norm=1.0)
    model, opt = init_state(cfg, "cpu")
    step = make_train_step(model, cfg, opt)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for _ in range(2):
        metrics = step(_batch())
        assert all(torch.isfinite(v) for v in metrics.values())
    after = model.state_dict()
    moved = {k for k in before if not torch.equal(before[k], after[k])}
    assert "depth_net.encoder.encoder.bn1.running_var" in moved
    assert "pose_net.pose_conv.weight" in moved
    flow = {k for k in before if k.startswith(("pwc_model.", "fpyramid."))}
    assert (flow & moved == set()) if fix_flow else (flow <= moved)


def test_clip_by_global_norm_matches_optax():
    rng = np.random.RandomState(0)
    grads = [rng.randn(3, 4).astype(np.float32), rng.randn(5).astype(np.float32)]
    for max_norm in (0.5, 100.0):
        params = [torch.zeros(g.shape, requires_grad=True) for g in grads]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        clip_by_global_norm(params, max_norm)
        want, _ = optax.clip_by_global_norm(max_norm).update(grads, None)
        for p, w in zip(params, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6)
