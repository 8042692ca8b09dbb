"""The port's loss-graph ops against the JAX package's, on the CPU in f32.

Resize, geometry, sampling of float activations, SSIM, masks, losses and the
multiscale reconstruction: the same numpy inputs go through both packages.
Unless a test says otherwise the tolerance is 1e-5 absolute / 1e-5 relative:
both run the same f32 formulas, summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsupervised_depth_opticalflow_egomotion_torch.ops import geometry as tg
from unsupervised_depth_opticalflow_egomotion_torch.ops import interp as ti
from unsupervised_depth_opticalflow_egomotion_torch.ops import losses as tl
from unsupervised_depth_opticalflow_egomotion_torch.ops import masks as tm
from unsupervised_depth_opticalflow_egomotion_torch.ops import ssim as ts
from unsupervised_depth_opticalflow_egomotion_torch.ops import warp as tw
from unsupervised_depth_opticalflow_egomotion_torch.ops.inverse_warp_multi import (
    multiscale_recon_dynamic as t_recon,
)
from unsupervised_depth_opticalflow_egomotion_tpu.ops import geometry as jg
from unsupervised_depth_opticalflow_egomotion_tpu.ops import interp as ji
from unsupervised_depth_opticalflow_egomotion_tpu.ops import losses as jl
from unsupervised_depth_opticalflow_egomotion_tpu.ops import masks as jm
from unsupervised_depth_opticalflow_egomotion_tpu.ops import warp as jw
from unsupervised_depth_opticalflow_egomotion_tpu.ops.inverse_warp_multi import (
    multiscale_recon_dynamic as j_recon,
)
from unsupervised_depth_opticalflow_egomotion_tpu.ops.ssim import ssim_xla

pytestmark = pytest.mark.quick
torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


def _rand(*shape, seed=0, lo=0.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(np.float32)


def _intrinsics(b, h, w):
    K = np.array([[0.6 * w, 0, w / 2], [0, 0.6 * w, h / 2], [0, 0, 1]], np.float32)
    K = np.tile(K[None], (b, 1, 1))
    return K, np.linalg.inv(K).astype(np.float32)


def _pose(b, seed=0):
    rng = np.random.RandomState(seed)
    return np.concatenate(
        [rng.uniform(-0.3, 0.3, (b, 3)), rng.uniform(-0.05, 0.05, (b, 3))], 1
    ).astype(np.float32)


@pytest.mark.parametrize("hw", [(16, 32), (64, 128), (4, 8), (24, 40)])
def test_resize_bilinear(hw):
    """Power-of-two up/down ratios take the closed form; (24, 40) a generic one."""
    x = _rand(2, 8, 16, 3)
    _close(ti.resize_bilinear(_t(x), hw), ji.resize_bilinear(jnp.asarray(x), hw))


def test_resize_area_upsample_pyramid():
    x = _rand(2, 16, 32, 3, seed=1)
    _close(ti.resize_area(_t(x), (4, 8)), ji.resize_area(jnp.asarray(x), (4, 8)))
    _close(ti.upsample2x_bilinear(_t(x)), ji.upsample2x_bilinear(jnp.asarray(x)))
    for mode in ("bilinear", "area"):
        for a, b in zip(ti.image_pyramid(_t(x), 3, mode), ji.image_pyramid(jnp.asarray(x), 3, mode)):
            _close(a, b)


def test_rigid_projection_and_epipolar_geometry():
    """The Z clamp at 1e-3 and the out-of-frame -> 2 trick included: the pose
    and depths put some points out of frame and some behind the camera."""
    b, h, w = 2, 16, 32
    depth = _rand(b, h, w, 1, seed=2, lo=-0.2, hi=2.0)
    pose = _pose(b)
    K, K_inv = _intrinsics(b, h, w)
    got = tg.rigid_projection(_t(depth), _t(pose), _t(K))
    want = jg.rigid_projection(jnp.asarray(depth), jnp.asarray(pose), jnp.asarray(K))
    coords = np.asarray(want[0])
    assert (coords == 2.0).any() and (np.abs(coords) <= 1.0).any()
    assert (np.asarray(want[2]) == np.float32(1e-3)).any()
    for a, bb in zip(got, want):
        _close(a, bb, rtol=1e-4, atol=1e-4)
    _close(tg.fundamental_from_pose(_t(pose), _t(K_inv)),
           jg.fundamental_from_pose(jnp.asarray(pose), jnp.asarray(K_inv)))
    for a, bb in zip(tg.projection_matrices(_t(pose), _t(K)),
                     jg.projection_matrices(jnp.asarray(pose), jnp.asarray(K))):
        _close(a, bb, rtol=1e-5, atol=1e-4)


def test_cam2pixel():
    """Normalized (zeros padding) and raw pixel projections of backprojected
    points, some behind the camera (Z clamp) and some out of frame."""
    b, h, w = 2, 16, 32
    depth = _rand(b, h, w, seed=15, lo=-0.2, hi=2.0)
    K, K_inv = _intrinsics(b, h, w)
    proj = np.asarray(jnp.matmul(jnp.asarray(K), jg.pose_vec2mat(jnp.asarray(_pose(b, 3)))))
    jcam = jg.pixel2cam(jnp.asarray(depth), jnp.asarray(K_inv))
    cam = tg.pixel2cam(_t(depth), _t(K_inv))
    _close(cam, jcam)
    got = tg.cam2pixel_norm(_t(np.asarray(jcam)), _t(proj))
    want = jg.cam2pixel_norm(jcam, jnp.asarray(proj))
    assert (np.asarray(want[0]) == 2.0).any() and (np.asarray(want[1]) == np.float32(1e-3)).any()
    for a, bb in zip(got, want):
        _close(a, bb, rtol=1e-4, atol=1e-4)
    _close(tg.cam2pixel_px(_t(np.asarray(jcam)), _t(proj)), jg.cam2pixel_px(jcam, jnp.asarray(proj)),
           rtol=1e-4, atol=1e-3)


def test_feature_warp_grads_match_jax():
    """The PWC feature warp: float activations, gradients to the source AND
    the flow (the plain sampler). Tolerance 1e-4 on gradients (sums of up
    to four taps times 32 channels)."""
    x = _rand(2, 8, 16, 32, seed=3, lo=-1, hi=1)
    flow = _rand(2, 8, 16, 2, seed=4, lo=-3, hi=3)
    cot = _rand(2, 8, 16, 32, seed=5, lo=-1, hi=1)
    jval, jvjp = jax.vjp(lambda a, f: jw.warp_flow(a, f), jnp.asarray(x), jnp.asarray(flow))
    jgx, jgf = jvjp(jnp.asarray(cot))
    xt, ft = _t(x).requires_grad_(True), _t(flow).requires_grad_(True)
    out = tw.warp_flow(xt, ft)
    (out * _t(cot)).sum().backward()
    _close(out, jval)
    _close(xt.grad, jgx, rtol=1e-4, atol=1e-4)
    _close(ft.grad, jgf, rtol=1e-4, atol=1e-4)


def test_warp_flow_mask_uint8():
    """uint8 data source with the analytic validity mask and 1/255 folded in."""
    src = np.random.RandomState(6).randint(0, 256, (2, 8, 16, 3), np.uint8)
    flow = _rand(2, 8, 16, 2, seed=7, lo=-4, hi=4)
    got = tw.warp_flow(_t(src), _t(flow), use_mask=True, out_dtype=torch.float32)
    want = jw.warp_flow(jnp.asarray(src), jnp.asarray(flow), True, out_dtype=jnp.float32)
    assert (np.asarray(want) == 0).any()
    _close(got, want)


def test_ssim_plain_and_routing():
    x, y = _rand(2, 12, 20, 3, seed=8), _rand(2, 12, 20, 3, seed=9)
    _close(ts.ssim(_t(x), _t(y), "xla"), ssim_xla(jnp.asarray(x), jnp.asarray(y)))
    # "pallas" runs the plain version on CPU tensors, as JAX does off the TPU
    _close(ts.ssim(_t(x), _t(y), "pallas"), ssim_xla(jnp.asarray(x), jnp.asarray(y)))


def test_masks():
    b, h, w = 2, 8, 16
    img = _rand(b, h, w, 3, seed=10)
    wl = _rand(b, h, w, 3, seed=11) * (np.random.RandomState(1).rand(b, h, w, 1) > 0.2)
    wr = _rand(b, h, w, 3, seed=12)
    src = _rand(b, h, w, 3, seed=13)
    got = tm.occlusion_weights([_t(wl)], [_t(img)], [_t(wr)])
    want = jm.occlusion_weights([jnp.asarray(wl)], [jnp.asarray(img)], [jnp.asarray(wr)])
    for a, bb in zip(got, want):
        _close(a[0], bb[0])
    _close(tm.texture_masks([_t(img)], [_t(wl)], [_t(src)])[0],
           jm.texture_masks([jnp.asarray(img)], [jnp.asarray(wl)], [jnp.asarray(src)])[0])
    flow = _rand(b, h, w, 2, seed=14, lo=-3, hi=3)
    pose = _pose(b, 1)
    K, K_inv = _intrinsics(b, h, w)
    dist = tm.epipolar_map(_t(pose), _t(flow), _t(K), _t(K_inv))
    jdist = jm.epipolar_map(jnp.asarray(pose), jnp.asarray(flow), jnp.asarray(K), jnp.asarray(K_inv))
    _close(dist, jdist, rtol=1e-4, atol=1e-5)
    for a, bb in zip(tm.rigid_masks(_t(np.asarray(jdist))), jm.rigid_masks(jdist)):
        _close(a, bb)
    _close(tm.flow_normalization(_t(flow)), jm.flow_normalization(jnp.asarray(flow)))


def _pyr(seed, b=2, h=16, w=32, c=3, lo=0.0, hi=1.0, n=3):
    return [_rand(b, h >> s, w >> s, c, seed=seed + s, lo=lo, hi=hi) for s in range(n)]


@pytest.mark.parametrize("normalize", [False, True])
def test_disp_smooth_naive_equals_jax_folded(normalize):
    """The port's upsample-then-difference form against the JAX package's
    folded form (scales 1-2) and direct form (scale 0): equal sums.
    Tolerance 1e-5 relative (the folded form sums in another order)."""
    img = _rand(2, 16, 32, 3, seed=20)
    disps = _pyr(21, c=1, lo=0.05, hi=1.0)
    got = tl.disp_smooth_loss(_t(img), [_t(d) for d in disps], normalize)
    want = jl.disp_smooth_loss(jnp.asarray(img), [jnp.asarray(d) for d in disps], normalize)
    _close(got, want)


def test_losses():
    imgs, warped = _pyr(30), _pyr(40)
    masks = [(m > 0.3).astype(np.float32) for m in _pyr(50, c=1)]
    T = lambda xs: [_t(x) for x in xs]  # noqa: E731
    J = lambda xs: [jnp.asarray(x) for x in xs]  # noqa: E731
    _close(tl.photometric_loss(T(imgs), T(warped), T(masks)),
           jl.photometric_loss(J(imgs), J(warped), J(masks)))
    _close(tl.ssim_loss(T(imgs), T(warped), T(masks), "xla"),
           jl.ssim_loss(J(imgs), J(warped), J(masks)))
    fwd, bwd = _pyr(60, c=2, lo=-5, hi=5), _pyr(70, c=2, lo=-5, hi=5)
    _close(tl.flow_smooth_loss(T(fwd), T(imgs)), jl.flow_smooth_loss(J(fwd), J(imgs)))
    _close(tl.flow_consis_loss(T(fwd), T(bwd), T(masks)),
           jl.flow_consis_loss(J(fwd), J(bwd), J(masks)))
    _close(tl.depth_flow_consis_loss(T(fwd), T(masks), 1),
           jl.depth_flow_consis_loss(J(fwd), J(masks), 1))
    _close(tl.epipolar_loss(T(masks)[0], None), jl.epipolar_loss(J(masks)[0], None))


def test_multiscale_recon_dynamic():
    """Reconstruction (uint8 source at scale 0, float pyramid below), validity,
    computed depth, flow differences and the detached dynamic masks/scores.
    Tolerance 1e-4: projected coordinates carry f32 rounding into the taps."""
    b, h, w = 2, 16, 32
    raw = np.random.RandomState(80).randint(0, 256, (b, h, w, 3), np.uint8)
    ref = raw.astype(np.float32) / 255.0
    depths = _pyr(81, c=1, lo=0.5, hi=2.0)
    flows = _pyr(90, c=2, lo=-2, hi=2)
    pose = _pose(b, 2)
    K, _ = _intrinsics(b, h, w)
    got = t_recon(_t(ref), _t(K), [_t(d) for d in depths], [_t(d) for d in depths], _t(pose),
                  [_t(f) for f in flows], 0.01, 0.5, ref_img_u8=_t(raw))
    want = j_recon(jnp.asarray(ref), jnp.asarray(K), [jnp.asarray(d) for d in depths],
                   [jnp.asarray(d) for d in depths], jnp.asarray(pose),
                   [jnp.asarray(f) for f in flows], 0.01, 0.5, ref_img_u8=jnp.asarray(raw))
    assert got[2] == want[2] == [None] * len(depths)  # no sampled source depth
    recs, valids, _, cdepths, fds, dyns, scores = want
    for g, ws in zip(got[:2] + got[3:], (recs, valids, cdepths, fds, dyns, scores)):
        for a, bb in zip(g, ws):
            _close(a, bb, rtol=1e-4, atol=1e-4)
