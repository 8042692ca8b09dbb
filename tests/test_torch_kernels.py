"""The port's warp-gather and correlation modules against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs its Pallas kernels in interpret mode (``interpret=True``,
``_FORCE_INTERPRET``) and its XLA forms, as the JAX package's own kernel
tests do. Inputs come from a numpy seed and go to both packages.

The CUDA kernels themselves are held against the same plain versions on the
card by ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsupervised_depth_opticalflow_egomotion_torch.ops import cost_volume as tcv
from unsupervised_depth_opticalflow_egomotion_torch.ops import warp as tw
from unsupervised_depth_opticalflow_egomotion_tpu.ops import cost_volume as jcv
from unsupervised_depth_opticalflow_egomotion_tpu.ops import warp as jw
from unsupervised_depth_opticalflow_egomotion_tpu.ops.pallas import correlation_fused as jcf
from unsupervised_depth_opticalflow_egomotion_tpu.ops.pallas.warp_window import (
    warp_gather_bf16x3,
    warp_gather_u8rgb,
)

pytestmark = pytest.mark.kernels
torch.set_num_threads(2)

B, H, W = 2, 16, 128


def _coords(seed=0):
    """Pixel coords for B2 16x128: local motion, 60..200 px horizontal motion
    (in frame up to 127 px, out of frame beyond) and other out-of-frame
    points; none of them integers, where the floor's derivative is ambiguous."""
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    ix = np.broadcast_to(xx, (B, H, W)) + rng.uniform(-3, 3, (B, H, W))
    iy = np.broadcast_to(yy, (B, H, W)) + rng.uniform(-3, 3, (B, H, W))
    far = rng.rand(B, H, W) < 0.3
    ix = np.where(far, ix + rng.choice([-1, 1], (B, H, W)) * rng.uniform(60, 200, (B, H, W)), ix)
    # keep every coordinate at least 0.01 px off an integer
    ix, iy = (np.floor(a) + np.clip(a - np.floor(a), 0.01, 0.99) for a in (ix, iy))
    ix, iy = ix.astype(np.float32), iy.astype(np.float32)
    assert (np.abs(ix - np.round(ix)) > 1e-4).all() and (np.abs(iy - np.round(iy)) > 1e-4).all()
    assert (ix < 0).any() and (ix > W - 1).any() and (iy < 0).any() and (iy > H - 1).any()
    assert (np.abs(ix - xx) > 128).any() and ((np.abs(ix - xx) > 100) & (ix > 0) & (ix < W - 1)).any()
    return ix, iy


def _sources(seed=1):
    rng = np.random.RandomState(seed)
    u8 = rng.randint(0, 256, (B, H, W, 3), np.uint8)
    # bf16-representable float image: both packages see the same values
    f = torch.from_numpy(rng.rand(B, H, W, 3).astype(np.float32)).bfloat16().float().numpy()
    return u8, f


def _port_warp(src_t, ix, iy, cot_rgb, cot_w):
    """Port: values + coordinate VJP through WarpGather (plain on CPU)."""
    ixt = torch.from_numpy(ix).requires_grad_(True)
    iyt = torch.from_numpy(iy).requires_grad_(True)
    rgb, wsum = tw.WarpGather.apply(src_t, ixt, iyt, torch.float32)
    loss = (rgb * torch.from_numpy(cot_rgb)).sum() + (wsum * torch.from_numpy(cot_w)).sum()
    loss.backward()
    return rgb.detach().numpy(), wsum.detach().numpy(), ixt.grad.numpy(), iyt.grad.numpy()


def _jax_warp(gather, src, ix, iy, cot_rgb, cot_w):
    def loss(a, b):
        rgb, wsum = gather(src, a, b, out_dtype=jnp.float32, interpret=True, fused=True)
        return jnp.sum(rgb * cot_rgb) + jnp.sum(wsum * cot_w), (rgb, wsum)

    (_, (rgb, wsum)), (gx, gy) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(ix), jnp.asarray(iy)
    )
    return [np.asarray(t) for t in (rgb, wsum, gx, gy)]


@pytest.mark.parametrize("src_kind", ["uint8", "bfloat16"])
def test_warp_plain_matches_jax_kernel(src_kind):
    """Values, weight sum and coordinate VJP (incl. the weight-sum cotangent)
    against the JAX windowed kernel in interpret mode (fused=True). At 16x128
    the kernel's window covers the whole source, so it is exact at any
    motion. Tolerance 1e-5: both sum the same f32 terms in another order;
    the outputs are in [0, 1] and the derivatives in [-1, 1] per cotangent."""
    ix, iy = _coords()
    u8, f = _sources()
    rng = np.random.RandomState(2)
    cot_rgb = rng.randn(B, H, W, 3).astype(np.float32)
    cot_w = rng.randn(B, H, W, 1).astype(np.float32)
    if src_kind == "uint8":
        got = _port_warp(torch.from_numpy(u8), ix, iy, cot_rgb, cot_w)
        want = _jax_warp(warp_gather_u8rgb, jnp.asarray(u8), ix, iy, cot_rgb, cot_w)
    else:
        got = _port_warp(torch.from_numpy(f).bfloat16(), ix, iy, cot_rgb, cot_w)
        want = _jax_warp(
            warp_gather_bf16x3, jnp.asarray(f).astype(jnp.bfloat16), ix, iy, cot_rgb, cot_w
        )
    for name, g, w in zip(("rgb", "wsum", "d/dix", "d/diy"), got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, err_msg=name)
    assert np.abs(want[2]).max() > 0.1  # the VJP is not trivially zero


@pytest.mark.parametrize("src_kind", ["uint8", "float32"])
def test_grid_sample_matches_jax_xla(src_kind):
    """The port's sampler (3-channel data source -> WarpGather) against the
    JAX package's exact XLA form on the same normalized coordinates, values
    and coordinate gradients. Tolerance 1e-5 (f32 rounding order)."""
    ix, iy = _coords(3)
    u8, f = _sources(4)
    src = u8 if src_kind == "uint8" else f
    coords = np.stack([2 * ix / (W - 1) - 1, 2 * iy / (H - 1) - 1], -1).astype(np.float32)
    cot = np.random.RandomState(5).randn(B, H, W, 3).astype(np.float32)

    def jloss(c):
        out, wsum = jw.grid_sample_with_weight(
            jnp.asarray(src), c, out_dtype=jnp.float32, src_is_data=True
        )
        return jnp.sum(out * cot), (out, wsum)

    (_, (jout, jwsum)), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(coords))
    ct = torch.from_numpy(coords).requires_grad_(True)
    out, wsum = tw.grid_sample_with_weight(
        torch.from_numpy(src), ct, out_dtype=torch.float32, src_is_data=True
    )
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5)
    np.testing.assert_allclose(wsum.detach().numpy(), np.asarray(jwsum), atol=1e-5)
    np.testing.assert_allclose(ct.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-3)


def test_warp_wrapper_cpu_takes_plain_version():
    """A CPU tensor runs the plain version and never counts a launch."""
    ix, iy = _coords()
    u8, _ = _sources()
    before = tw.WARP_GATHER.launches
    rgb, wsum, dplanes = tw.warp_gather(
        torch.from_numpy(u8), torch.from_numpy(ix), torch.from_numpy(iy), torch.float32
    )
    assert tw.WARP_GATHER.launches == before
    assert rgb.shape == (B, H, W, 3) and wsum.shape == (B, H, W, 1)
    assert dplanes.shape == (B, H, W, 6) and dplanes.dtype == torch.float32


def _corr_inputs(seed=0, c=16):
    rng = np.random.RandomState(seed)
    shape = (2, 8, 16, c)  # 8 x 16 = 128 px: the fused kernel's own gate
    f1, f2 = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    cot = rng.randn(2, 8, 16, 81).astype(np.float32)
    return f1, f2, cot


def _port_corr(f1, f2, cot):
    a = torch.from_numpy(f1).requires_grad_(True)
    b = torch.from_numpy(f2).requires_grad_(True)
    out = tcv.correlation(a, b, 4)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), a.grad.numpy(), b.grad.numpy()


@pytest.mark.parametrize("jax_form", ["fused_kernel", "xla"])
def test_correlation_plain_matches_jax(jax_form):
    """Forward and VJP at md=4 on a 128-px level, against the JAX fused Pallas
    kernels (_FORCE_INTERPRET) and the XLA formulation. Tolerances: forward
    1e-5, VJP 1e-4 (f32 sums of 16 resp. 81x16 products in another order)."""
    f1, f2, cot = _corr_inputs()
    corr = jcv.correlation if jax_form == "xla" else (lambda a, b, md: jcf.correlation_fused(a, b, md))

    def jloss(a, b):
        out = corr(a, b, 4)
        return jnp.sum(out * cot), out

    old = jcf._FORCE_INTERPRET
    jcf._FORCE_INTERPRET = jax_form == "fused_kernel"
    try:
        (_, jout), (j1, j2) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(f1), jnp.asarray(f2)
        )
    finally:
        jcf._FORCE_INTERPRET = old
    out, d1, d2 = _port_corr(f1, f2, cot)
    assert out.shape == (2, 8, 16, 81)
    np.testing.assert_allclose(out, np.asarray(jout), atol=1e-5)
    np.testing.assert_allclose(d1, np.asarray(j1), atol=1e-4)
    np.testing.assert_allclose(d2, np.asarray(j2), atol=1e-4)


def test_correlation_wrapper_cpu_takes_plain_version():
    f1, f2, cot = _corr_inputs(1, c=4)
    counts = [k.launches for k in (tcv.CORR_FWD, tcv.CORR_BWD_DF1, tcv.CORR_BWD_DF2)]
    _port_corr(f1, f2, cot)
    assert [k.launches for k in (tcv.CORR_FWD, tcv.CORR_BWD_DF1, tcv.CORR_BWD_DF2)] == counts
