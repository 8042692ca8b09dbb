"""The port's forward-splat module against the JAX package.

On the CPU the port's ``splat_mass`` runs its plain PyTorch version (a
four-tap ``index_add_``); the JAX side runs its XLA scatter-add forms and its
windowed Pallas splat kernel in interpret mode. Inputs come from a numpy
seed and go to both packages. Tolerance 1e-5 throughout: the same f32 tap
weights summed in another order, on a mass of a few units.

The CUDA kernel itself is held against the same plain version on the card
by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsupervised_depth_opticalflow_egomotion_torch.ops import splat as ts
from unsupervised_depth_opticalflow_egomotion_tpu.ops import splat as js
from unsupervised_depth_opticalflow_egomotion_tpu.ops.pallas.splat_window import splat_mass_window

pytestmark = pytest.mark.kernels
torch.set_num_threads(2)


def _flow(b=2, h=64, w=160, scale=5.0, seed=0, far=False):
    """A flow of a few pixels whose targets stay off exact halves (where
    round-half-to-even decides the nearest tap); with ``far`` a third of the
    pixels move up to 1.5 frame sizes, past any window and out of frame."""
    rng = np.random.RandomState(seed)
    f = rng.uniform(-scale, scale, (b, h, w, 2))
    if far:
        jump = rng.rand(b, h, w, 1) < 0.33
        f = np.where(jump, rng.uniform(-1.5, 1.5, (b, h, w, 2)) * [w, h], f)
    frac = f - np.floor(f)
    f = (np.floor(f) + np.where(np.abs(frac - 0.5) < 1e-3, 0.51, frac)).astype(np.float32)
    assert (np.abs(f - np.floor(f) - 0.5) > 1e-4).all()
    return f


def test_forward_splat_matches_jax():
    """Three-channel values along a small and a large-displacement flow."""
    rng = np.random.RandomState(1)
    for far in (False, True):
        flow = _flow(seed=2, far=far)
        vals = rng.rand(2, 64, 160, 3).astype(np.float32)
        want = np.asarray(js.forward_splat(jnp.asarray(vals), jnp.asarray(flow)))
        got = ts.forward_splat(torch.from_numpy(vals), torch.from_numpy(flow)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
    if far:
        assert want.sum() < 0.9 * vals.sum()  # mass did leave the frame


def test_nearest_mass_matches_jax():
    for far in (False, True):
        flow = _flow(seed=3, far=far)
        want = np.asarray(js.forward_splat_nearest_mass(jnp.asarray(flow)))
        got = ts.forward_splat_nearest_mass(torch.from_numpy(flow)).numpy()
        assert got.shape == (2, 64, 160, 1)
        np.testing.assert_array_equal(got, want)  # integer counts


def test_splat_mass_matches_jax_window_kernel():
    """``splat_mass`` (plain on the CPU) against the JAX Pallas kernel in
    interpret mode, on a smooth flow inside the kernel's coverage, and on a
    flow with targets straddling every frame edge."""
    flow = _flow(seed=4)
    edge = flow.copy()
    edge[:, :4, :, 1] -= 3.5
    edge[:, -4:, :, 1] += 3.5
    edge[:, :, :4, 0] -= 3.5
    edge[:, :, -4:, 0] += 3.5
    before = ts.SPLAT_MASS.launches
    for f in (flow, edge):
        want = np.asarray(splat_mass_window(jnp.asarray(f), interpret=True))
        got = ts.splat_mass(torch.from_numpy(f)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
    assert ts.SPLAT_MASS.launches == before  # a CPU tensor counts no launch
    assert got.max() > 1.5 and got.min() < 0.5


def test_splat_mass_large_displacement_matches_xla_scatter():
    """Displacements past 128 px, where the JAX kernel's window would drop
    mass: against the XLA scatter only. The port's form has no window."""
    flow = _flow(h=64, w=384, seed=5, far=True)
    assert (np.abs(flow[..., 0]) > 128).any()
    ones = jnp.ones((2, 64, 384, 1), jnp.float32)
    want = np.asarray(js.forward_splat(ones, jnp.asarray(flow)))
    got = ts.splat_mass(torch.from_numpy(flow)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("taps", ["bilinear", "bilinear_xla", "nearest", "nearest_half"])
@pytest.mark.parametrize("hw", [(64, 160), (32, 64)])
def test_occlusion_mask_matches_jax(taps, hw):
    """All four ``taps``, on a plane above and one below the 4096-pixel
    switch of "nearest_half"; the mask is clamped to [0, 1] and carries no
    gradient."""
    flow = _flow(h=hw[0], w=hw[1], seed=6)
    want = np.asarray(js.occlusion_mask_from_flow(jnp.asarray(flow), taps))
    ft = torch.from_numpy(flow).requires_grad_(True)
    got = ts.occlusion_mask_from_flow(ft, taps)
    assert not got.requires_grad and got.shape == (2, *hw, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert 0.0 <= got.min() and got.max() <= 1.0 and 0.05 < got.mean() < 0.999
    with pytest.raises(ValueError):
        ts.occlusion_mask_from_flow(ft, "trilinear")
