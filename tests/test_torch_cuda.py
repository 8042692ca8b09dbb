"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and skip without one. This file imports
neither JAX nor the JAX package, so it also runs on a machine that has only
PyTorch; there, skip the JAX-bound ``tests/conftest.py``:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from unsupervised_depth_opticalflow_egomotion_torch.ops import cost_volume as tcv
from unsupervised_depth_opticalflow_egomotion_torch.ops import warp as tw

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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_correlation_kernels_match_plain_on_card(cuda, dtype, tol):
    """Forward, df1 and df2 at md=4 on an 8x16 level with C=32. bf16: the
    kernel and the plain version both multiply and sum in f32 and round once
    to bf16 (one ulp, ~1e-2 relative to the largest value)."""
    rng = np.random.RandomState(8)
    f1, f2 = (rng.randn(2, 8, 16, 32).astype(np.float32) for _ in range(2))
    cot = rng.randn(2, 8, 16, 81).astype(np.float32)
    a, b, g = (torch.from_numpy(x).to(cuda, dtype) for x in (f1, f2, cot))
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


def test_cuda_tensor_never_takes_the_plain_version(cuda):
    """A CUDA tensor the kernel cannot take raises; it is not sent to the
    plain version."""
    src = torch.zeros((1, 4, 4, 3), dtype=torch.float16, device=cuda)
    ix = torch.zeros((1, 4, 4), device=cuda)
    with pytest.raises(TypeError):
        tw.warp_gather(src, ix, ix, torch.float32)
    f = torch.zeros((1, 4, 4, 8), dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError):
        tcv.corr_forward(f, f, 4)
