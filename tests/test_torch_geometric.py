"""The port's geometric ops against the JAX package's, on the CPU in f32.

Sampling, RANSAC-F, PnP, triangulation, the triangulation loss, the
quaternion pose and rigid flow, and the multiscale reconstruction with the
sampled source depth. Random draws are made with ``jax.random`` exactly as
the JAX package makes them, and the port is given the drawn indices, so both
packages use the same samples. Tolerances, unless a test says otherwise:
sampling exact (ties included), F to 1e-4 absolute up to sign, Sampson
distances to 1e-4 relative, PnP parameters to 1e-4, triangulated points and
registered depths to 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unsupervised_depth_opticalflow_egomotion_torch.ops import geometry as tg
from unsupervised_depth_opticalflow_egomotion_torch.ops import losses as tl
from unsupervised_depth_opticalflow_egomotion_torch.ops import pnp as tp
from unsupervised_depth_opticalflow_egomotion_torch.ops import ransac as tr
from unsupervised_depth_opticalflow_egomotion_torch.ops import sampling as ts
from unsupervised_depth_opticalflow_egomotion_torch.ops import triangulation as tt
from unsupervised_depth_opticalflow_egomotion_torch.ops.inverse_warp_multi import (
    multiscale_recon_dynamic as t_recon,
)
from unsupervised_depth_opticalflow_egomotion_tpu.ops import geometry as jg
from unsupervised_depth_opticalflow_egomotion_tpu.ops import losses as jl
from unsupervised_depth_opticalflow_egomotion_tpu.ops import pnp as jp
from unsupervised_depth_opticalflow_egomotion_tpu.ops import ransac as jr
from unsupervised_depth_opticalflow_egomotion_tpu.ops import sampling as js
from unsupervised_depth_opticalflow_egomotion_tpu.ops import triangulation as jt
from unsupervised_depth_opticalflow_egomotion_tpu.ops.inverse_warp_multi import (
    multiscale_recon_dynamic as j_recon,
)

pytestmark = pytest.mark.quick
torch.set_num_threads(2)

B, H, W = 2, 64, 128


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=1e-4, atol=1e-6):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol, atol=atol)


def _rel(got, want, tol=1e-4):
    """Max error relative to the reference's max-abs."""
    got, want = _np(got), np.asarray(want)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def _same_up_to_sign(got, want, atol=1e-4):
    """F [..., 3, 3] equal up to a sign per matrix."""
    got, want = _np(got), np.asarray(want)
    s = np.sign((got * want).sum((-2, -1), keepdims=True))
    np.testing.assert_allclose(got * s, want, atol=atol)


def _intrinsics(b, h, w):
    K = np.array([[0.6 * w, 0, w / 2], [0, 0.6 * w, h / 2], [0, 0, 1]], np.float32)
    return np.tile(K[None], (b, 1, 1)), np.tile(np.linalg.inv(K)[None], (b, 1, 1)).astype(np.float32)


def _pose(b, seed=0):
    rng = np.random.RandomState(seed)
    return np.concatenate(
        [rng.uniform(-0.3, 0.3, (b, 3)), rng.uniform(-0.05, 0.05, (b, 3))], 1
    ).astype(np.float32)


def _two_view(n, seed=0, noise=0.0, outliers=0.0):
    """Correspondences [B,n,2] x2 of a random rigid scene seen by two cameras
    (depths 4-20), and the 3D points in the first camera [B,n,3]."""
    rng = np.random.RandomState(seed)
    K, K_inv = _intrinsics(B, H, W)
    pose = _pose(B, seed)
    pix = np.stack([rng.uniform(0, W - 1, (B, n)), rng.uniform(0, H - 1, (B, n))], -1)
    depth = rng.uniform(4, 20, (B, n, 1))
    X = np.einsum("bij,bnj->bni", K_inv, np.concatenate([pix, np.ones((B, n, 1))], -1)) * depth
    T = np.asarray(jg.pose_vec2mat(jnp.asarray(pose)))
    Xc = np.einsum("bij,bnj->bni", T[:, :, :3], X) + T[:, None, :, 3]
    p2 = np.einsum("bij,bnj->bni", K, Xc)
    p2 = p2[..., :2] / p2[..., 2:]
    p2 = p2 + noise * rng.randn(*p2.shape)
    bad = rng.rand(B, n) < outliers
    p2[bad] += rng.uniform(-20, 20, (int(bad.sum()), 2))
    f = np.float32
    return pix.astype(f), p2.astype(f), X.astype(f), K, K_inv, pose


# ---------------------------------------------------------------- sampling


def test_build_matches():
    flow = np.random.RandomState(1).uniform(-3, 3, (B, 8, 16, 2)).astype(np.float32)
    _close(ts.build_matches(_t(flow)), js.build_matches(jnp.asarray(flow)), 0, 0)


@pytest.mark.parametrize("ties", [False, True])
def test_top_ratio_sample(ties):
    """Exact: the kept matches, their depths and scores in score order. With
    ``ties`` the scores are the saturated 1/(1e-4 + |f - r|) of a flow that
    equals the rigid flow on most pixels, so many scores are equal and the
    order among them must be the lower index first, as jax.lax.top_k's."""
    rng = np.random.RandomState(2)
    n = 512
    match = rng.rand(B, n, 4).astype(np.float32)
    depth = rng.rand(B, n, 1).astype(np.float32)
    diff = rng.rand(B, n).astype(np.float32)
    if ties:
        diff[rng.rand(B, n) < 0.7] = 0.0
        diff = np.round(diff, 1)
    scores = (1.0 / (1e-4 + diff)).astype(np.float32)
    got = ts.top_ratio_sample(_t(match), _t(depth), _t(scores), 0.3)
    want = js.top_ratio_sample(jnp.asarray(match), jnp.asarray(depth), jnp.asarray(scores), 0.3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_sample_matches_with_jax_draws():
    """The full two-stage sampler at 64x128, the draws of forward_geom's
    ``randint(k, (b, num), 0, n)``: exact."""
    rng = np.random.RandomState(3)
    flow = rng.uniform(-2, 2, (B, H, W, 2)).astype(np.float32)
    depth = rng.rand(B, H, W, 1).astype(np.float32)
    scores = (1.0 / (1e-4 + np.round(rng.rand(B, H, W, 1), 2))).astype(np.float32)
    key = jax.random.PRNGKey(7)
    kept = ts.top_ratio_count(H * W, 0.3)
    idx = np.asarray(jax.random.randint(key, (B, 6000), 0, kept))
    want = js.sample_matches(key, *map(jnp.asarray, (flow, depth, scores)), 0.3, 6000)
    got = ts.sample_matches(_t(idx), _t(flow), _t(depth), _t(scores), 0.3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


# ------------------------------------------------------------------ RANSAC


def test_normalize_points_and_eight_point():
    """Normalized 8-point over a [B, 5] batch of minimal samples and over
    all correspondences; F up to sign."""
    p1, p2, *_ = _two_view(200, seed=4, noise=0.3)
    sel = np.random.RandomState(5).randint(0, 200, (B, 5, 8))
    s1 = np.take_along_axis(p1[:, None], sel[..., None], 2)
    s2 = np.take_along_axis(p2[:, None], sel[..., None], 2)
    pn, T = tr._normalize_points(_t(p1))
    for b in range(B):
        jpn, jT = jr._normalize_points(jnp.asarray(p1[b]))
        _close(pn[b], jpn, 1e-5, 1e-5)
        _close(T[b], jT, 1e-5, 1e-5)
    want = jax.vmap(jax.vmap(jr.eight_point))(jnp.asarray(s1), jnp.asarray(s2))
    _same_up_to_sign(tr.eight_point(_t(s1), _t(s2)), want)
    want = jax.vmap(jr.eight_point)(jnp.asarray(p1), jnp.asarray(p2))
    _same_up_to_sign(tr.eight_point(_t(p1), _t(p2)), want)


def test_sampson_distance():
    p1, p2, *_ = _two_view(300, seed=6, noise=0.5, outliers=0.2)
    F = np.asarray(jax.vmap(jr.eight_point)(jnp.asarray(p1), jnp.asarray(p2)))
    want = jax.vmap(jr.sampson_distance)(jnp.asarray(F), jnp.asarray(p1), jnp.asarray(p2))
    _close(tr.sampson_distance(_t(F), _t(p1), _t(p2)), want, 1e-4, 1e-9)


def test_batched_ransac_fundamental_with_jax_draws():
    """RANSAC-F with outliers and the draws of ``split(k8, B)`` then
    ``randint(key, (iters, 8), 0, n)``: F up to sign and the inlier mask."""
    n, iters = 400, 50
    p1, p2, *_ = _two_view(n, seed=8, noise=0.2, outliers=0.3)
    key = jax.random.PRNGKey(11)
    idx = np.stack([
        np.asarray(jax.random.randint(k, (iters, 8), 0, n)) for k in jax.random.split(key, B)
    ])
    jF, jin = jr.batched_ransac_fundamental(key, jnp.asarray(p1), jnp.asarray(p2), iters=iters)
    F, inl = tr.batched_ransac_fundamental(_t(idx), _t(p1), _t(p2))
    _same_up_to_sign(F, jF)
    np.testing.assert_array_equal(_np(inl), np.asarray(jin))
    F1, in1 = tr.ransac_fundamental(_t(idx[0]), _t(p1[0]), _t(p2[0]))
    _same_up_to_sign(F1, jF[0])
    np.testing.assert_array_equal(_np(in1), np.asarray(jin[0]))


# --------------------------------------------------------------------- PnP


def test_rodrigues_and_residuals():
    rv = np.random.RandomState(9).uniform(-0.5, 0.5, (6, 3)).astype(np.float32)
    rv[0] = 0.0
    rv[1] = 1e-5
    _close(tp.rodrigues(_t(rv)), jax.vmap(jp.rodrigues)(jnp.asarray(rv)), 1e-5, 1e-6)
    _, p2, X, K, _, _ = _two_view(50, seed=10)
    params = np.random.RandomState(11).uniform(-0.1, 0.1, (B, 6)).astype(np.float32)
    want = jax.vmap(jp._residuals)(*map(jnp.asarray, (params, X, p2, K)))
    _close(tp._residuals(_t(params), _t(X), _t(p2), _t(K)), want, 1e-4, 1e-3)


@pytest.mark.parametrize("at_zero", [True, False])
def test_jacobian_matches_jax_jacfwd(at_zero):
    """The 2N x 6 Jacobian of the residuals, at the zero initialization (the
    series branch of rodrigues) and away from it, against jax.jacfwd."""
    _, p2, X, K, _, _ = _two_view(40, seed=12)
    params = np.zeros((B, 6), np.float32) if at_zero else _pose(B, 13)[:, [3, 4, 5, 0, 1, 2]]
    want = jax.vmap(lambda p, a, b, k: jax.jacfwd(
        lambda q: jp._residuals(q, a, b, k).reshape(-1))(p))(*map(jnp.asarray, (params, X, p2, K)))
    _rel(tp._jacobian(_t(params), _t(X), _t(p2), _t(K)), want, 1e-5)


def test_pnp_gauss_newton_and_batched_pnp():
    """Noisy correspondences: the Gauss-Newton parameters to 1e-4, and
    batched_pnp's [tvec | rvec] layout."""
    _, p2, X, K, _, pose = _two_view(300, seed=14, noise=0.3)
    want = jax.vmap(jp.pnp_gauss_newton)(*map(jnp.asarray, (X, p2, K)))
    got = tp.pnp_gauss_newton(_t(X), _t(p2), _t(K))
    _close(got, want, 1e-4, 1e-4)
    bp = tp.batched_pnp(_t(X), _t(p2), _t(K))
    _close(bp, jp.batched_pnp(*map(jnp.asarray, (X, p2, K))), 1e-4, 1e-4)
    # the estimate is the pose that made the views (Euler ~ axis-angle here)
    _close(bp, pose, 0, 2e-2)


def test_pnp_ransac_with_jax_draws():
    n, iters = 200, 20
    _, p2, X, K, _, _ = _two_view(n, seed=15, noise=0.2, outliers=0.3)
    keys = jax.random.split(jax.random.PRNGKey(16), B)
    idx = np.stack([np.asarray(jax.random.randint(k, (iters, 6), 0, n)) for k in keys])
    jpar, jin = jax.vmap(lambda k, a, b, kk: jp.pnp_ransac(k, a, b, kk, iters=iters))(
        keys, *map(jnp.asarray, (X, p2, K)))
    par, inl = tp.pnp_ransac(_t(idx), _t(X), _t(p2), _t(K))
    _close(par, jpar, 1e-4, 1e-4)
    np.testing.assert_array_equal(_np(inl), np.asarray(jin))


# ---------------------------------------------------------- triangulation


def _tri_inputs(n=256, seed=17):
    p1, p2, X, K, K_inv, pose = _two_view(n, seed=seed, noise=0.2)
    match = np.concatenate([p1, p2], -1)
    P1, P2 = (np.asarray(x) for x in jg.projection_matrices(jnp.asarray(pose), jnp.asarray(K)))
    return match, K, K_inv, P1, P2, X


def test_midpoint_triangulate_and_reproject():
    match, K, K_inv, P1, P2, X = _tri_inputs()
    want = jt.midpoint_triangulate(*map(jnp.asarray, (match, K_inv, P1, P2)))
    pts = tt.midpoint_triangulate(*map(_t, (match, K_inv, P1, P2)))
    _rel(pts, want)
    for P in (P1, P2):
        for g, w in zip(tt.reproject(_t(P), _t(np.asarray(want))),
                        jt.reproject(jnp.asarray(P), want)):
            _rel(g, w)


def test_scale_and_affine_adapt():
    rng = np.random.RandomState(18)
    d1 = rng.uniform(1, 5, (B, 100, 1)).astype(np.float32)
    d2 = (2.0 * d1 + 0.3 + 0.05 * rng.randn(B, 100, 1)).astype(np.float32)
    _rel(tt.scale_adapt(_t(d1), _t(d2)), jt.scale_adapt(jnp.asarray(d1), jnp.asarray(d2)))
    for tr_ in (True, False):
        got = tt.affine_adapt(_t(d1), _t(d2), use_translation=tr_)
        want = jt.affine_adapt(jnp.asarray(d1), jnp.asarray(d2), use_translation=tr_)
        for g, w in zip(got, want):
            _close(g, w, 1e-4, 1e-5)


@pytest.mark.parametrize("n", [6000, 5999])
def test_median_averages_the_middle_pair(n):
    x = np.random.RandomState(19).rand(B, n, 1).astype(np.float32)
    np.testing.assert_array_equal(_np(tt.median(_t(x), 1)), np.asarray(jnp.median(jnp.asarray(x), axis=1)))


def test_register_depth():
    """The dense and the sampled registered depths (the sampler's gradient to
    the map and to the coordinates rides along in the loss-pack test)."""
    match, K, K_inv, P1, P2, _ = _tri_inputs(6000 // 10 * 10)
    pts = np.asarray(jt.midpoint_triangulate(*map(jnp.asarray, (match, K_inv, P1, P2))))
    coord, depth = (np.asarray(x) for x in jt.reproject(jnp.asarray(P2), jnp.asarray(pts)))
    disp = np.random.RandomState(20).uniform(0.2, 0.8, (B, H, W, 1)).astype(np.float32)
    got = tt.register_depth(_t(disp), _t(coord), _t(depth))
    want = jt.register_depth(jnp.asarray(disp), jnp.asarray(coord), jnp.asarray(depth))
    for g, w in zip(got, want):
        _rel(g, w)


def test_triangulation_loss():
    rng = np.random.RandomState(21)
    tri, pred = (rng.uniform(1, 3, (B, 500, 1)).astype(np.float32) for _ in range(2))
    _close(tl.triangulation_loss(_t(tri), _t(pred)),
           jl.triangulation_loss(jnp.asarray(tri), jnp.asarray(pred)), 1e-5, 1e-7)


# --------------------------------------------------------------- geometry


def test_quat2mat_and_quaternion_pose():
    q = np.random.RandomState(22).uniform(-0.5, 0.5, (4, 3)).astype(np.float32)
    _close(tg.quat2mat(_t(q)), jg.quat2mat(jnp.asarray(q)), 1e-6, 1e-6)
    vec = np.concatenate([np.random.RandomState(23).rand(4, 3), q], 1).astype(np.float32)
    for mode in ("euler", "quat"):
        _close(tg.pose_vec2mat(_t(vec), mode), jg.pose_vec2mat(jnp.asarray(vec), mode), 1e-6, 1e-6)


def test_calculate_rigid_flow():
    depth = np.random.RandomState(24).uniform(1, 10, (B, 16, 32, 1)).astype(np.float32)
    K, _ = _intrinsics(B, 16, 32)
    pose = _pose(B, 25)
    _close(tg.calculate_rigid_flow(_t(depth), _t(pose), _t(K)),
           jg.calculate_rigid_flow(*map(jnp.asarray, (depth, pose, K))), 1e-4, 1e-4)


def test_multiscale_recon_dynamic_samples_the_source_depth():
    """``sample_ref_depth``: the projected source depth of every scale (the
    port samples the one-channel map on the plain sampler, the JAX package
    as a fourth channel of the frame), the reconstructions and the rest of
    the outputs. Tolerance 1e-4: projected coordinates carry f32 rounding
    into the taps."""
    b, h, w = 2, 16, 32
    raw = np.random.RandomState(26).randint(0, 256, (b, h, w, 3), np.uint8)
    ref = raw.astype(np.float32) / 255.0
    rng = np.random.RandomState(27)
    depths = [rng.uniform(0.5, 2, (b, h >> s, w >> s, 1)).astype(np.float32) for s in range(3)]
    depths_ref = [rng.uniform(0.5, 2, d.shape).astype(np.float32) for d in depths]
    flows = [rng.uniform(-2, 2, (b, h >> s, w >> s, 2)).astype(np.float32) for s in range(3)]
    pose = _pose(b, 28)
    K, _ = _intrinsics(b, h, w)
    got = t_recon(_t(ref), _t(K), [_t(d) for d in depths], [_t(d) for d in depths_ref],
                  _t(pose), [_t(f) for f in flows], 0.01, 0.5, sample_ref_depth=True,
                  ref_img_u8=_t(raw))
    want = jax.jit(lambda *a: j_recon(*a[:6], 0.01, 0.5, sample_ref_depth=True, ref_img_u8=a[6]))(
        jnp.asarray(ref), jnp.asarray(K), [jnp.asarray(d) for d in depths],
        [jnp.asarray(d) for d in depths_ref], jnp.asarray(pose),
        [jnp.asarray(f) for f in flows], jnp.asarray(raw))
    assert len(got) == len(want) == 7
    for g, ws in zip(got, want):
        for a, bb in zip(g, ws):
            _close(a, bb, 1e-4, 1e-4)
