"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and skip without one. This file imports
neither JAX nor the JAX package, so it also runs on a machine that has only
PyTorch; there, skip the JAX-bound ``tests/conftest.py``:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import copy
import os

# cuBLAS's deterministic workspace, read once when the process first uses
# cuBLAS (the graphed step's test compares with deterministic algorithms)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np
import pytest
import torch

from unsupervised_depth_opticalflow_egomotion_torch.config import Config
from unsupervised_depth_opticalflow_egomotion_torch.ops import cost_volume as tcv
from unsupervised_depth_opticalflow_egomotion_torch.ops import reflect_pad as trp
from unsupervised_depth_opticalflow_egomotion_torch.ops import splat as tsp
from unsupervised_depth_opticalflow_egomotion_torch.ops import ssim as tss
from unsupervised_depth_opticalflow_egomotion_torch.ops import warp as tw
from unsupervised_depth_opticalflow_egomotion_torch.parallel import (
    init_state,
    make_optimizer,
    make_train_step,
)
from unsupervised_depth_opticalflow_egomotion_torch.parallel import train_step as tts
from unsupervised_depth_opticalflow_egomotion_torch.parallel.train_step import WARMUP_CALLS

pytestmark = [pytest.mark.kernels, pytest.mark.cuda]

B, H, W = 2, 16, 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _coords(seed):
    """Pixel coords with local and >128 px motion, some out of frame, none
    within 0.01 px of an integer (where the floor's derivative is ambiguous)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    ix = xx + rng.uniform(-3, 3, (B, H, W))
    iy = yy + rng.uniform(-3, 3, (B, H, W))
    far = rng.rand(B, H, W) < 0.3
    ix = np.where(far, ix + rng.choice([-1, 1], (B, H, W)) * rng.uniform(60, 200, (B, H, W)), ix)
    ix, iy = (np.floor(a) + np.clip(a - np.floor(a), 0.01, 0.99) for a in (ix, iy))
    return ix.astype(np.float32), iy.astype(np.float32)


@pytest.mark.parametrize(
    "src_dtype,out_dtype,tol",
    [
        (torch.uint8, torch.float32, 1e-5),
        (torch.uint8, torch.bfloat16, 8e-3),  # one bf16 rounding of values <= 1
        (torch.bfloat16, torch.bfloat16, 8e-3),
        (torch.float32, torch.float32, 1e-5),
    ],
)
def test_warp_kernel_matches_plain_on_card(cuda, src_dtype, out_dtype, tol):
    """rgb, weight sum (tol) and f32 derivative planes (1e-5), one launch;
    then the coordinate VJP of ``WarpGather`` on the card against the plain
    version's on the CPU (1e-4 relative to its largest value)."""
    ix, iy = _coords(6)
    rng = np.random.RandomState(7)
    u8 = rng.randint(0, 256, (B, H, W, 3), np.uint8)
    src_cpu = torch.from_numpy(u8)
    if src_dtype != torch.uint8:
        src_cpu = (src_cpu.float() / 255.0).to(src_dtype)
    src = src_cpu.to(cuda)
    ixt, iyt = torch.from_numpy(ix).to(cuda), torch.from_numpy(iy).to(cuda)
    before = tw.WARP_GATHER.launches
    got = tw.warp_gather(src, ixt, iyt, out_dtype)
    torch.cuda.synchronize()
    assert tw.WARP_GATHER.launches == before + 1
    want = tw.warp_gather_plain(src, ixt, iyt, out_dtype)
    for g, w, t in zip(got, want, (tol, tol, 1e-5)):
        torch.testing.assert_close(g.float(), w.float(), atol=t, rtol=0)

    cot = torch.from_numpy(rng.randn(B, H, W, 3).astype(np.float32))
    cot_w = torch.from_numpy(rng.randn(B, H, W, 1).astype(np.float32))
    grads = []
    for dev in (cuda, torch.device("cpu")):
        a = torch.from_numpy(ix).to(dev).requires_grad_(True)
        b = torch.from_numpy(iy).to(dev).requires_grad_(True)
        rgb, wsum = tw.WarpGather.apply(src_cpu.to(dev), a, b, out_dtype)
        ((rgb.float() * cot.to(dev)).sum() + (wsum.float() * cot_w.to(dev)).sum()).backward()
        grads.append((a.grad.cpu(), b.grad.cpu()))
    for g, w in zip(*grads):
        scale = max(w.abs().max().item(), 1.0)
        torch.testing.assert_close(g, w, atol=1e-4 * scale, rtol=0)


def _on_card(x, cuda, dtype, offset):
    """``x`` as a contiguous tensor on the card; with ``offset``, one element
    past an allocation's start, so that its rows lose their 16-byte alignment."""
    t = torch.from_numpy(x).to(cuda, dtype)
    if not offset:
        return t
    flat = torch.empty(t.numel() + 1, device=cuda, dtype=dtype)
    return flat[1:].view(t.shape).copy_(t)


# (H, W, C): a small level; the five PWC levels of the decoder (C = 196 has a
# partial channel chunk and 8-byte pixel rows); a level smaller than the
# tiles' halo; an odd C, which takes scalar loads
CORR_SHAPES = [(8, 16, 32), (4, 13, 196), (8, 26, 128), (16, 52, 96), (32, 104, 64),
               (64, 208, 32), (3, 5, 12), (7, 35, 3)]


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("hwc", CORR_SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_correlation_kernels_match_plain_on_card(cuda, dtype, tol, hwc, offset):
    """Forward, df1 and df2 at md=4, B=2, at every shape the tiles can get
    wrong, from aligned and from misaligned addresses. bf16: the kernel and
    the plain version both multiply and sum in f32 and round once to bf16
    (one ulp, ~1e-2 relative to the largest value)."""
    h, w, c = hwc
    rng = np.random.RandomState(8)
    f1, f2 = (rng.randn(2, h, w, c).astype(np.float32) for _ in range(2))
    cot = rng.randn(2, h, w, 81).astype(np.float32)
    a, b, g = (_on_card(x, cuda, dtype, offset) for x in (f1, f2, cot))
    counts = [k.launches for k in (tcv.CORR_FWD, tcv.CORR_BWD_DF1, tcv.CORR_BWD_DF2)]
    out = tcv.corr_forward(a, b, 4)
    df1, df2 = tcv.corr_backward(g, a, b, 4)
    torch.cuda.synchronize()
    assert [k.launches for k in (tcv.CORR_FWD, tcv.CORR_BWD_DF1, tcv.CORR_BWD_DF2)] == [
        c + 1 for c in counts
    ]
    want = tcv.correlation_plain(a, b, 4)
    w1, w2 = tcv.correlation_backward_plain(g, a, b, 4)
    for x, y in ((out, want), (df1, w1), (df2, w2)):
        scale = y.float().abs().max().item()
        torch.testing.assert_close(x.float(), y.float(), atol=tol * max(scale, 1.0), rtol=0)


# (B, H, W, Ho, Wo): widths 13 and 127; outputs of another size than the
# source; odd pixel counts, so that blocks start off 16-byte boundaries
WARP_EDGES = [(3, 9, 13, 9, 13), (2, 11, 127, 11, 127), (3, 16, 40, 7, 13),
              (1, 5, 127, 33, 29)]


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("shape", WARP_EDGES)
@pytest.mark.parametrize(
    "src_dtype,out_dtype,tol",
    [
        (torch.uint8, torch.float32, 1e-5),
        (torch.uint8, torch.bfloat16, 8e-3),  # one bf16 rounding of values <= 1
        (torch.bfloat16, torch.bfloat16, 8e-3),
        (torch.float32, torch.float32, 1e-5),
    ],
)
def test_warp_gather_edges_on_card(cuda, src_dtype, out_dtype, tol, shape, offset):
    """The forward with derivative planes at ragged sizes, from a source and
    coordinates one element off their allocation (``offset``): rgb and
    weight sum (tol) and the f32 planes (1e-5) against the plain version."""
    b, h, w, ho, wo = shape
    rng = np.random.RandomState(14)
    u8 = rng.randint(0, 256, (b, h, w, 3), np.uint8)
    src = _on_card(u8 if src_dtype == torch.uint8 else u8 / 255.0, cuda, src_dtype, offset)
    ix = rng.uniform(-3, w + 2, (b, ho, wo))
    iy = rng.uniform(-3, h + 2, (b, ho, wo))
    # none within 0.01 px of an integer (where the floor's derivative is ambiguous)
    ix, iy = (np.floor(a) + np.clip(a - np.floor(a), 0.01, 0.99) for a in (ix, iy))
    ixt, iyt = (_on_card(a, cuda, torch.float32, offset) for a in (ix, iy))
    assert not offset or src.data_ptr() % 16 and ixt.data_ptr() % 16
    before = tw.WARP_GATHER.launches
    got = tw.warp_gather(src, ixt, iyt, out_dtype)
    torch.cuda.synchronize()
    assert tw.WARP_GATHER.launches == before + 1
    want = tw.warp_gather_plain(src, ixt, iyt, out_dtype)
    assert [tuple(t.shape) for t in got] == [(b, ho, wo, 3), (b, ho, wo, 1), (b, ho, wo, 6)]
    for g, wt, t in zip(got, want, (tol, tol, 1e-5)):
        assert g.dtype == wt.dtype and g.is_contiguous()
        torch.testing.assert_close(g.float(), wt.float(), atol=t, rtol=0)


@pytest.mark.parametrize(
    "src_dtype,out_dtype,tol",
    [
        (torch.uint8, torch.float32, 1e-5),
        (torch.uint8, torch.bfloat16, 8e-3),  # one bf16 rounding of values <= 1
        (torch.bfloat16, torch.bfloat16, 8e-3),
        (torch.float32, torch.float32, 1e-5),
    ],
)
def test_warp_regather_kernels_match_plain_on_card(cuda, src_dtype, out_dtype, tol):
    """The forward without derivative planes (rgb and weight sum, tol) and
    the re-gather backward kernel (f32 dix, diy; 1e-4 relative to the largest
    value: the same f32 products summed in another order) against their plain
    versions, one launch each, with both cotangents, with one, and through
    ``WarpRegather`` against ``WarpGather``."""
    ix, iy = _coords(9)
    rng = np.random.RandomState(10)
    src = torch.from_numpy(rng.randint(0, 256, (B, H, W, 3), np.uint8))
    if src_dtype != torch.uint8:
        src = (src.float() / 255.0).to(src_dtype)
    src = src.to(cuda)
    ixt, iyt = torch.from_numpy(ix).to(cuda), torch.from_numpy(iy).to(cuda)
    counts = [k.launches for k in (tw.WARP_GATHER, tw.WARP_GATHER_NOGRAD, tw.WARP_GATHER_BWD)]
    got = tw.warp_gather_nograd(src, ixt, iyt, out_dtype)
    want = tw.warp_gather_plain(src, ixt, iyt, out_dtype)
    for g, w in zip(got, want[:2]):
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=0)
    g_rgb = torch.from_numpy(rng.randn(B, H, W, 3).astype(np.float32)).to(cuda, out_dtype)
    g_w = torch.from_numpy(rng.randn(B, H, W, 1).astype(np.float32)).to(cuda, out_dtype)
    for a, b in ((g_rgb, g_w), (g_rgb, None), (None, g_w)):
        gk = tw.warp_gather_backward(src, ixt, iyt, a, b)
        gp = tw.warp_gather_backward_plain(src, ixt, iyt, a, b)
        for x, y in zip(gk, gp):
            assert x.dtype == torch.float32
            scale = max(y.abs().max().item(), 1.0)
            torch.testing.assert_close(x, y, atol=1e-4 * scale, rtol=0)
    torch.cuda.synchronize()
    now = [k.launches for k in (tw.WARP_GATHER, tw.WARP_GATHER_NOGRAD, tw.WARP_GATHER_BWD)]
    assert now == [counts[0], counts[1] + 1, counts[2] + 3]

    grads = []
    for fn in (tw.WarpRegather, tw.WarpGather):
        a = ixt.clone().requires_grad_(True)
        b = iyt.clone().requires_grad_(True)
        rgb, wsum = fn.apply(src, a, b, out_dtype)
        ((rgb * g_rgb).float().sum() + (wsum * g_w).float().sum()).backward()
        grads.append((a.grad, b.grad))
    for x, y in zip(*grads):
        torch.testing.assert_close(x, y, atol=1e-4 * max(y.abs().max().item(), 1.0), rtol=0)


def _ssim_inputs(shape, seed):
    """Two images in [0, 1] that differ by noise, and a cotangent; a third of
    the pixels are zeroed in both, as the loss's mask products do."""
    rng = np.random.RandomState(seed)
    x = rng.rand(*shape).astype(np.float32)
    y = np.clip(x + 0.2 * rng.randn(*shape), 0, 1).astype(np.float32)
    keep = (rng.rand(*shape[:3], 1) > 0.33).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    return x * keep, y * keep, g


# (B, H, W, C, offset): odd sizes; widths that are not a multiple of the
# backward's 30-pixel tile (53, 208, 61) or of the forward's 256-element
# (f32: 128) tile row (13, 127: 39 and 381 elements); frames smaller than
# a tile (3 x 5; 5 x 3; 9 x 13); heights that are not a multiple of the
# tiles' 32 rows (37, 33); the smallest path scale (64 x 208); C = 1, 4 and
# 5 (more than the kernels take: one-channel images); and inputs one
# element off their allocation
SSIM_SHAPES = [(2, 37, 53, 3, False), (1, 16, 128, 3, False), (2, 5, 3, 1, False),
               (1, 3, 5, 3, False), (2, 64, 208, 3, False), (1, 31, 61, 4, False),
               (2, 37, 53, 3, True), (1, 3, 5, 3, True), (1, 9, 13, 3, False),
               (2, 33, 127, 3, True), (1, 37, 127, 1, False), (2, 9, 13, 4, True),
               (2, 11, 13, 5, False), (1, 37, 127, 5, True)]


@pytest.mark.parametrize("shape", SSIM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssim_kernels_match_plain_on_card(cuda, shape, dtype):
    """The SSIM map and both gradients of the closed-form backward against
    their plain versions, odd sizes included, whole frame and border ring.

    f32: 1e-5 on the map (values in [-1, 1]); gradients 1e-4 relative to the
    largest value (they reach ~1e3 where both windows are nearly empty: the
    denominator falls to C1 C2). bf16: inputs and cotangent are the same
    bf16 values on both sides and every intermediate is f32, so the results
    differ by one bf16 rounding: 8e-3 on the map, and each gradient element
    to one bf16 ulp of its own value (8e-3 relative) plus 1e-5 of the
    largest gradient for the elements near zero, where the f32 sums cancel.
    """
    *shape, offset = shape
    x, y, g = (_on_card(a, cuda, dtype, offset) for a in _ssim_inputs(shape, 11))
    counts = (tss.SSIM_FWD.launches, tss.SSIM_BWD.launches)
    s = tss.ssim_forward(x, y)
    dx, dy = tss.ssim_backward(x, y, g)
    torch.cuda.synchronize()
    assert (tss.SSIM_FWD.launches, tss.SSIM_BWD.launches) == (counts[0] + 1, counts[1] + 1)
    assert s.dtype == dx.dtype == dy.dtype == dtype
    ws = tss.ssim_plain(x, y)
    wdx, wdy = tss.ssim_backward_plain(x, y, g)
    f32 = dtype == torch.float32
    ring = torch.ones(shape[1:3], dtype=torch.bool, device=cuda)
    ring[1:-1, 1:-1] = False
    for sel in (slice(None), ring):
        torch.testing.assert_close(s.float()[:, sel], ws.float()[:, sel],
                                   atol=1e-5 if f32 else 8e-3, rtol=0)
        for got, want in ((dx, wdx), (dy, wdy)):
            got, want = got.float()[:, sel], want.float()[:, sel]
            scale = max(want.abs().max().item(), 1.0)
            if f32:
                torch.testing.assert_close(got, want, atol=1e-4 * scale, rtol=0)
            else:
                torch.testing.assert_close(got, want, atol=1e-5 * scale, rtol=8e-3)

    # through autograd: ssim(impl="pallas") on the card equals the closed form
    xr, yr = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    (tss.ssim(xr, yr, "pallas").float() * g.float()).sum().backward()
    torch.testing.assert_close(xr.grad, dx)
    torch.testing.assert_close(yr.grad, dy)


def _splat_flow(b, h, w, seed, kind):
    """A flow [B,H,W,2]: "random", uniform in +-4 px; "smooth", a field of
    a few px that varies over tens of pixels (as a trained PWC's), plus a
    little noise; "zero", near-zero (as at init); "far", random with a
    third of the pixels moving up to 1.5 frame widths, so that targets
    leave the frame on every side; "mixed", uniform in +-9 px, on both
    sides of the kernel's 7 px between its gather and its scatter of far
    sources (and exactly at it); "nonfinite", random with NaN and +-inf
    elements."""
    rng = np.random.RandomState(seed)
    flow = rng.uniform(-4, 4, (b, h, w, 2))
    if kind == "smooth":
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        field = np.stack([3 * np.sin(yy / 17 + xx / 29), 2 * np.cos(xx / 23)], -1)
        flow = field[None] + 0.3 * rng.randn(b, h, w, 2)
    elif kind == "zero":
        flow = 1e-3 * rng.randn(b, h, w, 2)
    elif kind == "far":
        jump = rng.rand(b, h, w, 1) < 0.33
        flow = np.where(jump, rng.uniform(-1.5, 1.5, (b, h, w, 2)) * [w, h], flow)
    elif kind == "mixed":
        flow = rng.uniform(-9, 9, (b, h, w, 2))
        flow[0, 0, :4, 0] = [7.0, -7.0, 7.001, 8.0]
    elif kind == "nonfinite":
        flow[0, 1, 2, 0], flow[0, 2, 3, 1], flow[-1, h // 2, w // 2, 0] = np.nan, np.inf, -np.inf
    return flow.astype(np.float32)


@pytest.mark.parametrize("kind,offset", [("random", False), ("smooth", True), ("zero", False),
                                         ("far", False), ("mixed", True), ("nonfinite", True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bhw", [(3, 37, 53), (2, 301, 451)])
def test_splat_kernel_matches_plain_on_card(cuda, kind, offset, dtype, bhw):
    """The mass [B,H,W,1] against the plain scatter, from flows of every
    kind, some one element off their allocation, at two odd B x H x W: 3 x
    37 x 53 (below 2^18 source pixels: a thread per source) and 2 x 301 x
    451 (the window splat, with ragged tiles). A non-finite target drops its
    mass: the plain version gets those pixels moved far out of the frame (it
    cannot index with a NaN). The kernel sums f32 atomics in an order that
    changes from run to run: 1e-5 relative to the largest mass in f32; bf16
    adds the output's one rounding (8e-3 relative)."""
    b, h, w = bhw
    flow = _on_card(_splat_flow(b, h, w, 12, kind), cuda, dtype, offset)
    if kind == "far":
        t = flow.float() + tw.pixel_grid(h, w, device=cuda)[None]
        assert (t[..., 0] < -1).any() and (t[..., 0] > w).any()
        assert (t[..., 1] < -1).any() and (t[..., 1] > h).any()
    before = tsp.SPLAT_MASS.launches
    got = tsp.splat_mass(flow)
    torch.cuda.synchronize()
    assert tsp.SPLAT_MASS.launches == before + 1
    finite = torch.isfinite(flow.float())
    want = tsp.splat_mass_plain(torch.where(finite, flow, torch.full_like(flow, -1e6)))
    assert torch.isfinite(got).all() and (kind == "nonfinite") != bool(finite.all())
    assert got.shape == (b, h, w, 1) and got.dtype == dtype
    scale = max(want.float().max().item(), 1.0)
    tol = 1e-5 if dtype == torch.float32 else 8e-3
    torch.testing.assert_close(got.float(), want.float(), atol=tol * scale, rtol=0)
    mask = tsp.occlusion_mask_from_flow(flow, "bilinear")
    assert tsp.SPLAT_MASS.launches == before + 2
    assert mask.min() >= 0 and mask.max() <= 1 and not mask.requires_grad


# the decoder's coarsest and two of its finer inputs, as [B,H,W,C]; a C that
# is not a multiple of 8 (bf16 takes it element by element, f32 as 16-byte
# chunks); the least H and W (2), and 3x3, where a source pixel gathers
# nine cotangents
RP_SHAPES = [(2, 8, 26, 512), (2, 128, 416, 96), (2, 256, 832, 16), (2, 7, 9, 12),
             (3, 2, 2, 8), (2, 3, 3, 5)]


@pytest.mark.parametrize("layout", ["contiguous", "channels_first", "offset"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", RP_SHAPES)
def test_reflect_pad_kernels_match_plain_on_card(cuda, shape, dtype, layout):
    """The pad and its gradient against the plain version, on an NHWC input
    that is contiguous, lies channels-first behind an NHWC view (the wrapper
    copies it), or lies one element off its allocation (not 16-byte
    aligned: the kernels take it element by element). The forward is the
    plain one bit for bit, with and without autograd. The gradient sums at
    most four terms (nine at 3x3) in f32, in another order than the plain
    version's atomics, each sum rounding up to eight times: within 2^-20 of
    the sum of their magnitudes, plus in bf16 one rounding of the f32 sum
    (2^-8 relative)."""
    b, h, w, c = shape
    gen = torch.Generator().manual_seed(h * w + c)
    x0 = torch.randn(shape, generator=gen)
    if layout == "channels_first":
        x = x0.permute(0, 3, 1, 2).contiguous().to(cuda, dtype).permute(0, 2, 3, 1)
    elif layout == "offset":
        x = torch.empty(x0.numel() + 1, device=cuda, dtype=dtype)[1:].view(shape)
        x.copy_(x0)
    else:
        x = x0.to(cuda, dtype)
    g = torch.randn((b, h + 2, w + 2, c), generator=gen).to(cuda, dtype)
    before = (trp.REFLECT_PAD_FWD.launches, trp.REFLECT_PAD_BWD.launches)
    xg = x.detach().requires_grad_()
    y = trp.reflect_pad_nhwc(xg)
    y.backward(g)
    with torch.no_grad():
        y_nograd = trp.reflect_pad_nhwc(x)
    torch.cuda.synchronize()
    assert (trp.REFLECT_PAD_FWD.launches, trp.REFLECT_PAD_BWD.launches) == (
        before[0] + 2, before[1] + 1)
    want = trp.reflect_pad_plain(x)
    assert y.is_contiguous() and y.dtype == dtype and not y_nograd.requires_grad
    assert torch.equal(y, want) and torch.equal(y_nograd, want)
    grads = []
    for cot in (g.float(), g.float().abs()):
        x32 = x.detach().to(torch.float32, copy=True).requires_grad_()
        trp.reflect_pad_plain(x32).backward(cot)
        grads.append(x32.grad)
    want_g, magnitude = grads
    tol = 2.0**-20 * magnitude + (2.0**-8 * want_g.abs() if dtype == torch.bfloat16 else 0.0)
    assert xg.grad.dtype == dtype and xg.grad.shape == shape
    err = (xg.grad.float() - want_g).abs()
    assert (err <= tol).all(), float((err - tol).max())


def _batch(b, h, w, dev, seed=0):
    rng = np.random.RandomState(seed)
    images = torch.from_numpy((rng.rand(b, 3 * h, w, 3) * 255).astype(np.uint8))
    K = np.array([[100.0, 0, w / 2], [0, 100.0, h / 2], [0, 0, 1]], np.float32)
    K_ms = np.stack([np.diag([1 / 2**s, 1 / 2**s, 1.0]).astype(np.float32) @ K for s in range(3)])
    K_inv_ms = np.stack([np.linalg.inv(k) for k in K_ms]).astype(np.float32)
    tile = lambda x: torch.from_numpy(np.tile(x[None], (b, 1, 1, 1)))  # noqa: E731
    return tuple(t.to(dev) for t in (images, tile(K_ms), tile(K_inv_ms)))


DECODER_PADS = {"reflect_pad_fwd": 13, "reflect_pad_bwd": 13}


@pytest.mark.parametrize(
    "overrides,launched",
    [
        ({}, {"warp_gather": 6, "corr_fwd": 5, "corr_bwd_df1": 5, "corr_bwd_df2": 5,
              "ssim_fwd": 6, "ssim_bwd": 6, **DECODER_PADS}),
        ({"warp_impl": "pallas", "pwc_corr": "pallas", "ssim_impl": "xla"},
         {"warp_gather_nograd": 6, "warp_gather_bwd": 6, "corr_fwd": 5, **DECODER_PADS}),
        ({"mode": "flow", "flow_occ_impl": "splat"},
         {"warp_gather": 4, "corr_fwd": 5, "corr_bwd_df1": 5, "corr_bwd_df2": 5,
          "ssim_fwd": 6, "ssim_bwd": 6, "splat_mass": 8}),
        ({"mode": "depth", "enable_depth_ssim": True},
         {"warp_gather": 6, "ssim_fwd": 6, "ssim_bwd": 6, **DECODER_PADS}),
    ],
)
def test_default_config_trains_on_card(cuda, overrides, launched):
    """``init_state(Config(...))`` with the default kernel routing no longer
    raises: one step at 64x128 b2 bf16 has finite losses and launches exactly
    the kernels of its configuration (all others stay at zero). The depth
    decoder pads the input of each of its 13 convolutions (10 blocks, 3
    heads at ``num_scales`` 3) once forward and once backward; the flow
    step builds no depth net."""
    kernels = {
        "warp_gather": tw.WARP_GATHER, "warp_gather_nograd": tw.WARP_GATHER_NOGRAD,
        "warp_gather_bwd": tw.WARP_GATHER_BWD, "corr_fwd": tcv.CORR_FWD,
        "corr_bwd_df1": tcv.CORR_BWD_DF1, "corr_bwd_df2": tcv.CORR_BWD_DF2,
        "ssim_fwd": tss.SSIM_FWD, "ssim_bwd": tss.SSIM_BWD, "splat_mass": tsp.SPLAT_MASS,
        "reflect_pad_fwd": trp.REFLECT_PAD_FWD, "reflect_pad_bwd": trp.REFLECT_PAD_BWD,
    }
    cfg = Config(img_hw=(64, 128), batch_size=2, **overrides)
    assert cfg.compute_dtype == "bfloat16"
    model, opt = init_state(cfg)
    before = {n: k.launches for n, k in kernels.items()}
    metrics = make_train_step(model, cfg, opt)(_batch(2, 64, 128, cuda))
    torch.cuda.synchronize()
    assert all(torch.isfinite(v) for v in metrics.values())
    got = {n: k.launches - before[n] for n, k in kernels.items()}
    assert got == {n: launched.get(n, 0) for n in kernels}


def test_cuda_tensor_never_takes_the_plain_version(cuda):
    """A CUDA tensor the kernel cannot take raises; it is not sent to the
    plain version. (More than four SSIM channels are taken: they go to the
    kernels as one-channel images, test_ssim_kernels_match_plain_on_card.)"""
    src = torch.zeros((1, 4, 4, 3), dtype=torch.float16, device=cuda)
    ix = torch.zeros((1, 4, 4), device=cuda)
    with pytest.raises(TypeError):
        tw.warp_gather(src, ix, ix, torch.float32)
    f = torch.zeros((1, 4, 4, 8), dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError):
        tcv.corr_forward(f, f, 4)
    with pytest.raises(TypeError):
        tw.warp_gather_nograd(src, ix, ix, torch.float32)
    with pytest.raises(TypeError):
        tss.ssim_forward(f, f)
    with pytest.raises(TypeError):
        tss.ssim_backward(f, f, f)
    with pytest.raises(ValueError):  # the launch's tensors on two devices
        tss.ssim_forward(f.float(), f.float().cpu())
    with pytest.raises(TypeError):
        tsp.splat_mass(torch.zeros((1, 4, 4, 2), dtype=torch.float16, device=cuda))
    with pytest.raises(TypeError):
        trp.reflect_pad_nhwc(f)


@pytest.mark.parametrize("b,h,w,cin,cout,k,s", [
    (6, 64, 128, 3, 64, 7, 2), (6, 16, 32, 64, 128, 3, 2), (6, 16, 32, 64, 64, 3, 1),
    (6, 16, 32, 64, 128, 1, 2), (1, 2, 4, 256, 512, 3, 2),
], ids=["stem", "3x3_s2", "3x3", "1x1_s2", "few_rows"])
def test_int8_conv_card_accumulators_equal_the_exact_version(cuda, b, h, w, cin, cout, k, s):
    """``torch._int_mm`` on int8 im2col (K padded to a multiple of 8, fewer
    than 17 rows padded) gives the int64 version's accumulators exactly,
    and the int8 conv's output and STE gradients on the card match the
    same conv's on the CPU (its plain accumulators): the output bit-equal,
    the gradients to 1e-5 of their max-abs (cuDNN against oneDNN)."""
    from unsupervised_depth_opticalflow_egomotion_torch.ops import int8_conv as ti8

    gen = torch.Generator().manual_seed(k * 10 + s)
    x = torch.randn(b, h, w, cin, generator=gen)
    wt = torch.randn(cout, cin, k, k, generator=gen) * 0.1
    xq, _ = ti8.quant_act(x)
    wq, _ = ti8.quant_weight(wt)
    p = (k - 1) // 2
    before = ti8.INT_MM.launches
    acc = ti8.conv_i32(xq.to(cuda), wq.to(cuda), s, p)
    assert ti8.INT_MM.launches == before + 1 and acc.dtype == torch.int32
    assert torch.equal(acc.cpu(), ti8.conv_i32_plain(xq, wq, s, p))
    res = []
    for dev in (cuda, torch.device("cpu")):
        xt, wtt = x.to(dev).requires_grad_(), wt.to(dev).requires_grad_()
        y = ti8.int8_conv(xt, wtt, s, p)
        y.backward(torch.ones_like(y))
        res.append([t.detach().cpu() for t in (y, xt.grad, wtt.grad)])
    assert torch.equal(res[0][0], res[1][0])
    for a, b_ in zip(res[0][1:], res[1][1:]):
        assert (a - b_).abs().max() <= 1e-5 * b_.abs().max()


def test_int8_conv_card_counts_its_own_k(cuda):
    """The card's int8 stem GEMM (K 147, padded to 152 for ``torch._int_mm``)
    counts 2 M N K at K = 147 in ``ops/flops.py``, and nothing under the
    bench's ``FlopCounterMode`` mapping: the CPU route's count."""
    from torch.utils.flop_counter import FlopCounterMode

    from unsupervised_depth_opticalflow_egomotion_torch.bench import MATRIX_MAPPING
    from unsupervised_depth_opticalflow_egomotion_torch.ops import flops
    from unsupervised_depth_opticalflow_egomotion_torch.ops import int8_conv as ti8

    gen = torch.Generator().manual_seed(0)
    xq = torch.randint(-127, 128, (2, 16, 24, 3), generator=gen, dtype=torch.int8)
    wq = torch.randint(-127, 128, (8, 3, 7, 7), generator=gen, dtype=torch.int8)
    counts = []
    for dev in (cuda, torch.device("cpu")):
        with FlopCounterMode(display=False, custom_mapping=MATRIX_MAPPING) as matrix, \
                flops.counting() as kernels:
            ti8.conv_i32(xq.to(dev), wq.to(dev), 2, 3)
        counts.append((matrix.get_total_flops(), kernels.by_function))
    want = 2 * (2 * 8 * 12) * 8 * 147
    assert counts == [(0, {"int8_conv": want}), (want, {})]


@pytest.fixture
def deterministic(cuda):
    """Deterministic algorithms on both sides of a comparison: cuDNN's
    default algorithms, no autotuning, and torch's deterministic kernels in
    place of its atomic-add backward ones. Two op-by-op runs from one state
    then agree bit for bit; without them, six geom steps at 64x128 drift by
    0.12 in the depth net's change (NVIDIA H100, PERF.md section 6)."""
    was = (torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic,
           torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    # warn_only: the kernels with no deterministic form run as they are
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield cuda
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = was[:2]
    torch.use_deterministic_algorithms(was[2], warn_only=was[3])


@pytest.mark.parametrize("overrides", [{"mode": "flow"}, {"mode": "geom"},
                                       {"mode": "geom", "encoder_int8": True}])
def test_graphed_step_follows_the_eager_step(deterministic, overrides):
    """Six steps on six batches at 64x128 b2 bf16 from the same weights,
    graphed (two op by op, the capture, three replays) and op by op, whose
    Adam turns capturable at the same call as the graph's (the flag changes
    Adam's rounding): every step's losses and, after the six, every
    parameter and buffer are bit-equal. The batches' losses differ, so a
    replay that read the captured batch would fail. Each call's metrics are
    new tensors with new values."""
    cuda = deterministic
    cfg = Config(img_hw=(64, 128), batch_size=2, **overrides)
    model, opt = init_state(cfg)
    twin = copy.deepcopy(model)
    twin_opt = make_optimizer(cfg, twin)
    step = make_train_step(model, cfg, opt)
    eager = make_train_step(twin, cfg, twin_opt).eager
    # another seed and contrast each, so that batches' losses differ
    batches = [(((b[0].float() * (0.3 + 0.14 * seed)).to(torch.uint8)), *b[1:])
               for seed, b in ((s, _batch(2, 64, 128, cuda, s)) for s in range(6))]
    got = []
    for i, batch in enumerate(batches):
        if i == WARMUP_CALLS:
            tts._make_capturable(twin_opt)
        got.append(step(batch, i))
        want = eager(batch, i)
        assert all(g["capturable"] == (i >= WARMUP_CALLS) for g in opt.param_groups), i
        assert got[-1].keys() == want.keys()
        for k in want:
            assert torch.equal(got[-1][k], want[k]), (i, k, float(got[-1][k]), float(want[k]))
        if i > WARMUP_CALLS:
            assert any(not torch.isclose(want[k], captured[k], rtol=5e-3) for k in want), i
        if i == WARMUP_CALLS:
            captured = {k: v.clone() for k, v in want.items()}
    torch.cuda.synchronize()
    assert step.graph is not None and step.body_runs == WARMUP_CALLS + 1
    assert all(st["step"].is_cuda for st in opt.state.values())
    for (k, a), b in zip(model.state_dict().items(), twin.state_dict().values()):
        assert torch.equal(a, b), k
    totals = [g["loss_total"] for g in got]
    assert len({t.data_ptr() for t in totals}) == len(totals)
    assert len({float(t) for t in totals}) == len(totals)


def test_replayed_steps_in_a_profiler_session(cuda):
    """Each replayed step shows one ``train_step.replay`` span and one graph
    launch, and the hand-written kernels it replays appear by name among
    the device activities."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = Config(img_hw=(64, 128), batch_size=2, mode="flow")
    model, opt = init_state(cfg)
    step = make_train_step(model, cfg, opt)
    batch = _batch(2, 64, 128, cuda)
    for i in range(3):
        step(batch, i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(3, 5):
            step(_batch(2, 64, 128, cuda, i), i)
        torch.cuda.synchronize()
    host = [e.name for e in prof.events() if e.device_type == DeviceType.CPU]
    device = {e.name for e in prof.events() if e.device_type != DeviceType.CPU}
    assert host.count("train_step") == host.count("train_step.replay") == 2
    assert "train_step.capture" not in host and "train_step.forward" not in host
    assert sum(n in ("cudaGraphLaunch", "cuGraphLaunch") for n in host) == 2
    for kernel in ("warp_gather_kernel", "corr_fwd_kernel", "corr_bwd_kernel",
                   "ssim_fwd_kernel", "ssim_bwd_kernel"):
        assert any(kernel in n for n in device), kernel


def test_raft_graphed_step_agrees_with_the_eager_step_within_the_cells_limits(cuda):
    """The ``raft-b8`` cell's step (b8 256x832 bf16, 12 iterations) from
    the cell's weights and frames: five steps graphed (two op by op, the
    capture, two replays) against five op by op on a fresh copy of the same
    state. ``grid_sampler_2d``'s backward adds atomically and has no
    deterministic form, so the two are compared as the benchmark compares
    the program with its reference (``portbench/check.py``): every number
    of the cell's limits holds, and the graph replayed."""
    import gc

    from portbench import check, feeds, harness

    torch.backends.cudnn.benchmark = True
    cell = harness.load_cell("raft-b8")
    seed = 2_900_000_011
    weights = harness.make_weights(harness.parameter_shapes(cell.reference, cell.cfg), seed,
                                   cuda)
    feed = feeds.make_feed(cell.traffic, cell.cfg, seed, cuda)
    batches = feed.checked(5)
    got = {}
    for how in ("graphed", "eager"):
        model, opt, step = harness.build_program(cell.cfg, weights, cuda)
        run = step if how == "graphed" else step.eager
        got[how] = harness.checked_steps(model, opt, run, batches)
        if how == "graphed":
            assert step.graph is not None and step.body_runs == WARMUP_CALLS + 1
        del model, opt, step, run
        gc.collect()
        torch.cuda.empty_cache()
    numbers = check.compare(got["graphed"], got["eager"], cell.limits)
    assert all(check.holds(k, v) for k, v in numbers.items()), numbers
    assert all(np.isfinite(got["graphed"]["losses"]))
