"""The port's SSIM module against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions: the SSIM
map (``ssim_plain``) and the closed-form backward (``ssim_backward_plain``,
the twin of the CUDA backward kernel). The JAX side runs its XLA form
(``ssim_xla`` and its ``jax.vjp``) and its fused Pallas kernels in interpret
mode, called directly (``_ssim_fwd_pallas`` / ``_ssim_bwd_pallas`` on NCHW
arrays) on a plane of 200x256 = 51,200 pixels: below 50,000 pixels the JAX
wrapper takes the XLA form and its kernel would never run. Inputs come from
a numpy seed and go to both packages.

The CUDA kernels themselves are held against the same plain versions on the
card by ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsupervised_depth_opticalflow_egomotion_torch.ops import losses as tl
from unsupervised_depth_opticalflow_egomotion_torch.ops import ssim as ts
from unsupervised_depth_opticalflow_egomotion_tpu.ops import losses as jl
from unsupervised_depth_opticalflow_egomotion_tpu.ops.pallas import ssim_fused as jsf
from unsupervised_depth_opticalflow_egomotion_tpu.ops.ssim import ssim_xla

pytestmark = pytest.mark.kernels
torch.set_num_threads(2)

SHAPE = (1, 200, 256, 3)


def _inputs(seed=0, shape=SHAPE):
    """Two images in [0, 1] that differ by noise, a third of the pixels zeroed
    in both (as the loss's mask products do), and a cotangent."""
    rng = np.random.RandomState(seed)
    x = rng.rand(*shape).astype(np.float32)
    y = np.clip(x + 0.2 * rng.randn(*shape), 0, 1).astype(np.float32)
    keep = (rng.rand(*shape[:3], 1) > 0.33).astype(np.float32)
    return x * keep, y * keep, rng.randn(*shape).astype(np.float32)


def _nchw(a):
    return jnp.transpose(a, (0, 3, 1, 2))


def _nhwc(a):
    return np.transpose(np.asarray(a.astype(jnp.float32)), (0, 2, 3, 1))


def _jax(form, x, y, g, dtype=jnp.float32):
    """(s, dx, dy) from the JAX package, as f32 numpy NHWC."""
    xj, yj, gj = (jnp.asarray(a).astype(dtype) for a in (x, y, g))
    if form == "xla":
        s, vjp = jax.vjp(ssim_xla, xj, yj)
        dx, dy = vjp(gj)
        return tuple(np.asarray(a.astype(jnp.float32)) for a in (s, dx, dy))
    s = jsf._ssim_fwd_pallas(_nchw(xj), _nchw(yj), True)
    dx, dy = jsf._ssim_bwd_pallas(_nchw(xj), _nchw(yj), _nchw(gj), True)
    return _nhwc(s), _nhwc(dx), _nhwc(dy)


def _port(x, y, g, dtype=torch.float32):
    xt, yt, gt = (torch.from_numpy(a).to(dtype) for a in (x, y, g))
    s = ts.ssim_forward(xt, yt)
    dx, dy = ts.ssim_backward(xt, yt, gt)
    assert s.dtype == dx.dtype == dy.dtype == dtype
    return tuple(a.float().numpy() for a in (s, dx, dy))


def _ring(a):
    """The border rows and columns of an NHWC array, flattened."""
    return np.concatenate([a[:, 0].ravel(), a[:, -1].ravel(), a[:, :, 0].ravel(), a[:, :, -1].ravel()])


@pytest.mark.parametrize("form", ["xla", "pallas_interpret"])
def test_ssim_plain_and_closed_form_match_jax_f32(form):
    """Map 1e-5 (values in [-1, 1]); gradients 1e-4 relative to the largest
    gradient (the same f32 sums in another order; gradients grow where both
    windows are nearly empty and the denominator nears C1 C2). The border
    ring, where the box filter's zero padding acts, is checked on its own."""
    x, y, g = _inputs()
    got, want = _port(x, y, g), _jax(form, x, y, g)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    np.testing.assert_allclose(_ring(got[0]), _ring(want[0]), atol=1e-5)
    for a, b in zip(got[1:], want[1:]):
        scale = max(np.abs(b).max(), 1.0)
        assert np.abs(b).max() > 0.1
        np.testing.assert_allclose(a, b, atol=1e-4 * scale)
        np.testing.assert_allclose(_ring(a), _ring(b), atol=1e-4 * scale)


@pytest.mark.parametrize("form", ["xla", "pallas_interpret"])
def test_ssim_bf16_matches_jax(form):
    """bf16 inputs and cotangent (the same bf16 values on both sides), f32
    statistics, bf16 out. Against the JAX kernel, which like the port applies
    the closed form to the bf16 cotangent, the results differ by one bf16
    rounding: 8e-3 on the map, and each gradient element to one bf16 ulp of
    its own value (8e-3 relative) plus 1e-5 of the largest gradient for the
    elements near zero, where the f32 sums cancel. A bound scaled by the
    largest gradient alone would be about a typical gradient's size. JAX's
    autodiff of the XLA form rounds its intermediates to bf16 at other
    places: the map to 8e-3, the gradients to 3e-2 of the largest."""
    x, y, g = _inputs(1)
    got = _port(x, y, g, torch.bfloat16)
    want = _jax(form, x, y, g, jnp.bfloat16)
    np.testing.assert_allclose(got[0], want[0], atol=8e-3)
    for a, b in zip(got[1:], want[1:]):
        scale = max(np.abs(b).max(), 1.0)
        if form == "pallas_interpret":
            np.testing.assert_allclose(a, b, rtol=8e-3, atol=1e-5 * scale)
        else:
            np.testing.assert_allclose(a, b, atol=3e-2 * scale)


def test_closed_form_matches_autograd_of_plain_map():
    """The kernel backward's plain version against torch autograd of
    ``ssim_plain`` on an odd-sized frame: 1e-4 of the largest gradient."""
    x, y, g = _inputs(2, (2, 37, 53, 3))
    xt, yt = (torch.from_numpy(a).requires_grad_(True) for a in (x, y))
    (ts.ssim_plain(xt, yt) * torch.from_numpy(g)).sum().backward()
    dx, dy = ts.ssim_backward_plain(xt.detach(), yt.detach(), torch.from_numpy(g))
    for a, b in ((dx, xt.grad), (dy, yt.grad)):
        torch.testing.assert_close(a, b, atol=1e-4 * max(b.abs().max().item(), 1.0), rtol=0)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_ssim_routing_on_cpu(impl):
    """On CPU tensors both ``ssim_impl`` values run the plain map under
    autograd and count no launch; an unknown name raises."""
    x, y, g = _inputs(3, (1, 8, 16, 3))
    counts = (ts.SSIM_FWD.launches, ts.SSIM_BWD.launches)
    xt, yt = (torch.from_numpy(a).requires_grad_(True) for a in (x, y))
    out = ts.ssim(xt, yt, impl)
    (out * torch.from_numpy(g)).sum().backward()
    assert torch.equal(out, ts.ssim_plain(xt, yt))
    assert xt.grad is not None and (ts.SSIM_FWD.launches, ts.SSIM_BWD.launches) == counts
    assert ts.ssim_route(impl, torch.device("cpu")) == "plain"
    assert ts.ssim_route("pallas", torch.device("cuda")) == "kernel"
    assert ts.ssim_route("xla", torch.device("cuda")) == "plain"
    with pytest.raises(ValueError):
        ts.ssim(xt, yt, "fused")


def test_ssim_loss_matches_jax():
    """The masked DSSIM over a 3-scale pyramid (mask products outside the
    SSIM map, as in the JAX package) under ``ssim_impl="pallas"``: 1e-5."""
    rng = np.random.RandomState(4)
    shapes = [(2, 32, 64), (2, 16, 32), (2, 8, 16)]
    imgs = [rng.rand(*s, 3).astype(np.float32) for s in shapes]
    warped = [rng.rand(*s, 3).astype(np.float32) for s in shapes]
    masks = [(rng.rand(*s, 1) > 0.4).astype(np.float32) for s in shapes]
    want = np.asarray(jl.ssim_loss(*([jnp.asarray(a) for a in p] for p in (imgs, warped, masks))))
    got = tl.ssim_loss(*([torch.from_numpy(a) for a in p] for p in (imgs, warped, masks)), "pallas")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
