"""The port's kernel launch path, without a card: which device and stream a
launch goes to, the device check of a launch's tensors, and the SSIM
kernels' route for more than four channels.

The CUDA runtime is stood in for: ``cuda_lib``'s current-device, raw-stream
and device-context getters are monkeypatched, and a kernel's ctypes function
is replaced by a Python function that records its arguments or computes the
plain version on the tensors behind the pointers it is given.
"""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

from unsupervised_depth_opticalflow_egomotion_torch.ops import cuda_lib
from unsupervised_depth_opticalflow_egomotion_torch.ops import ssim as tss

pytestmark = pytest.mark.quick
torch.set_num_threads(2)

_P, _I = ctypes.c_void_p, ctypes.c_int


class StandIn:
    """A tensor's face as ``check_cuda_tensor`` sees it, on CUDA device ``index``."""

    def __init__(self, index, dtype=torch.float32, shape=(1, 4, 4, 3), cuda=True):
        self.is_cuda, self.index, self.dtype, self.shape = cuda, index, dtype, torch.Size(shape)
        self.device = f"cuda:{index}" if cuda else "cpu"

    def get_device(self):
        return self.index if self.is_cuda else -1

    def is_contiguous(self):
        return True


@pytest.fixture
def runtime(monkeypatch):
    """Device 0 is current; device d's current stream is 1000 + d. Records
    the devices whose context a launch entered."""
    entered = []

    @contextlib.contextmanager
    def context(index):
        entered.append(index)
        yield

    monkeypatch.setattr(cuda_lib, "_current_device", lambda: 0)
    monkeypatch.setattr(cuda_lib, "_raw_stream", lambda index: 1000 + index)
    monkeypatch.setattr(cuda_lib, "_device_context", context)
    return entered


def test_check_cuda_tensor_returns_the_card_and_refuses_a_second_one():
    f32 = (torch.float32,)
    assert cuda_lib.check_cuda_tensor("a", StandIn(1), f32) == 1
    assert cuda_lib.check_cuda_tensor("b", StandIn(1), f32, None, 1) == 1
    with pytest.raises(ValueError, match="cuda:0.*cuda:1"):
        cuda_lib.check_cuda_tensor("b", StandIn(0), f32, None, 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_lib.check_cuda_tensor("b", StandIn(0, cuda=False), f32, None, 0)
    with pytest.raises(TypeError):
        cuda_lib.check_cuda_tensor("b", StandIn(1, torch.float16), f32, None, 1)
    with pytest.raises(ValueError, match="shape"):
        cuda_lib.check_cuda_tensor("b", StandIn(1), f32, (1, 4, 4, 1), 1)


@pytest.mark.parametrize("device", [0, 1, 3])
def test_launch_takes_the_stream_of_the_tensors_device(runtime, device):
    """A launch gets the current stream of the device it is given; it enters
    that device's context exactly when the device is not the current one;
    it counts once and records its signature."""
    kernel = cuda_lib.CudaKernel("ssim", "ssim_fwd", [_P, _P, _P, _I, _I, _I, _I, _I])
    calls = []
    kernel._fn = lambda *args: calls.append(args) or 0
    kernel(device, 11, 12, 13, 1, 2, 8, 16, 3)
    assert calls == [(11, 12, 13, 1, 2, 8, 16, 3, 1000 + device)]
    assert runtime == ([] if device == 0 else [device])
    assert kernel.launches == 1 and kernel.seen == {(1, 2, 8, 16, 3)}


def test_launch_error_raises_and_counts_nothing(runtime):
    kernel = cuda_lib.CudaKernel("splat", "splat_mass", [_P, _I, _P, _P, _I, _I, _I])
    kernel._fn = lambda *args: 1  # cudaErrorInvalidValue
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        kernel(2, 1, 1, 2, 3, 1, 4, 4)
    assert kernel.launches == 0 and not kernel.seen and runtime == [2]


def _tensor_at(ptr: int, shape) -> torch.Tensor:
    """The f32 CPU memory at ``ptr`` as a tensor of ``shape`` (no copy)."""
    n = int(np.prod(shape))
    return torch.from_numpy(np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr))).view(shape)


@pytest.fixture
def plain_ssim_kernels(runtime, monkeypatch):
    """The SSIM wrappers' kernel route on CPU tensors, which stand for
    tensors on card 1: the device check passes them, and each kernel is a
    stand-in that computes the plain version behind the pointers. Returns
    the two stand-in kernels."""
    def check(name, t, dtypes, shape=None, device=None):
        assert device in (None, 1), f"{name}: checked against card {device}"
        assert t.dtype in dtypes and t.is_contiguous()
        assert shape is None or t.shape == tuple(shape)
        return 1

    def fwd(x, y, out, dtype, b, h, w, c, stream):
        s = tss.ssim_plain(_tensor_at(x, (b, h, w, c)), _tensor_at(y, (b, h, w, c)))
        _tensor_at(out, (b, h, w, c)).copy_(s)
        return 0

    def bwd(x, y, g, dx, dy, dtype, b, h, w, c, stream):
        shape = (b, h, w, c)
        gx, gy = tss.ssim_backward_plain(*(_tensor_at(p, shape) for p in (x, y, g)))
        _tensor_at(dx, shape).copy_(gx)
        _tensor_at(dy, shape).copy_(gy)
        return 0

    kernels = []
    for name, fn, argtypes in (("SSIM_FWD", fwd, tss.SSIM_FWD._argtypes[:-1]),
                               ("SSIM_BWD", bwd, tss.SSIM_BWD._argtypes[:-1])):
        k = cuda_lib.CudaKernel("ssim", name.lower(), argtypes)
        k._fn = fn
        monkeypatch.setattr(tss, name, k)
        kernels.append(k)
    monkeypatch.setattr(tss, "check_cuda_tensor", check)
    return kernels


@pytest.mark.parametrize("c", [3, 5, 7])
def test_ssim_kernel_route_takes_any_channel_count(plain_ssim_kernels, runtime, c):
    """Any channel count goes through the kernels: the forward and the
    backward each make one launch, on B*C one-channel images when C > 4,
    and the map and both gradients equal the plain versions on the whole
    tensor. The launches go to the tensors' card (1), not the current one
    (0)."""
    fwd, bwd = plain_ssim_kernels
    rng = np.random.RandomState(c)
    shape = (2, 9, 13, c)
    x, y, g = (torch.from_numpy(rng.rand(*shape).astype(np.float32)) for _ in range(3))
    s = tss.ssim_forward_kernel(x, y)
    dx, dy = tss.ssim_backward_kernel(x, y, g)
    kernel_c, images = (1, 2 * c) if c > 4 else (c, 2)
    assert fwd.seen == {(2, images, 9, 13, kernel_c)} and fwd.launches == 1
    assert bwd.seen == {(2, images, 9, 13, kernel_c)} and bwd.launches == 1
    assert runtime == [1, 1]
    torch.testing.assert_close(s, tss.ssim_plain(x, y), atol=1e-6, rtol=0)
    wdx, wdy = tss.ssim_backward_plain(x, y, g)
    torch.testing.assert_close(dx, wdx, atol=1e-5, rtol=0)
    torch.testing.assert_close(dy, wdy, atol=1e-5, rtol=0)
    assert s.shape == dx.shape == dy.shape == shape and s.is_contiguous()


def test_planes_round_trip():
    x = torch.arange(2 * 3 * 4 * 6, dtype=torch.float32).reshape(2, 3, 4, 6)
    p = tss.to_planes(x)
    assert p.shape == (12, 3, 4, 1) and torch.equal(p[7, ..., 0], x[1, ..., 1])
    assert torch.equal(tss.from_planes(p, 6), x)
