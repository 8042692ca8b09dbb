"""The port's host input pipeline against the JAX package's, bit for bit.

The same tiny prepared directory (stacked PNGs at 3x80x176, resized to
64x128) goes through both packages' ``KittiPreparedDataset`` and loaders:
every item, every batch of the threaded ``BatchLoader`` and of the native
``NativeBatchLoader`` must be equal, images, intrinsics and their inverses.
The port builds its native library into its own ``_build/``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from unsupervised_depth_opticalflow_egomotion_torch.data import loader as tloader
from unsupervised_depth_opticalflow_egomotion_torch.data import native_loader as tnative
from unsupervised_depth_opticalflow_egomotion_torch.parallel import to_device_batch
from unsupervised_depth_opticalflow_egomotion_tpu.data import loader as jloader
from unsupervised_depth_opticalflow_egomotion_tpu.data import native_loader as jnative

pytestmark = pytest.mark.quick
torch.set_num_threads(2)
cv2 = pytest.importorskip("cv2")

HW = (64, 128)
PKG = Path(__file__).resolve().parents[1] / "unsupervised_depth_opticalflow_egomotion_torch"


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """8 stacked PNGs of 3x80x176 (resized to 64x128 on load) + calib."""
    root = tmp_path_factory.mktemp("prepared")
    rng = np.random.RandomState(0)
    (root / "calib.txt").write_text(
        "P_rect_02: 120.0 0.0 88.0 0.0 0.0 121.0 40.0 0.0 0.0 0.0 1.0 0.0\n"
    )
    lines = []
    for i in range(8):
        cv2.imwrite(str(root / f"{i:06d}.png"), rng.randint(0, 255, (240, 176, 3), np.uint8))
        lines.append(f"{i:06d}.png calib.txt\n")
    (root / "train.txt").write_text("".join(lines))
    return str(root)


def _datasets(prepared, seed, cache):
    kw = dict(num_scales=3, img_hw=HW, num_iterations=24, seed=seed,
              cache_decoded_bytes=cache, uint8_images=True)
    return (tloader.KittiPreparedDataset(prepared, **kw),
            jloader.KittiPreparedDataset(prepared, **kw))


def _assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,cache", [(0, 0), (3, 1 << 30)])
def test_dataset_items_equal_jax(prepared, seed, cache):
    """Every virtual index draws the same stack, flip and intrinsics pyramid;
    both flips occur."""
    tds, jds = _datasets(prepared, seed, cache)
    flips = set()
    for idx in range(len(jds)):
        got, want = tds[idx], jds[idx]
        _assert_same(got, want)
        assert got[0].shape == (3 * HW[0], HW[1], 3) and got[1].shape == (3, 3, 3)
        rng = np.random.RandomState(jds.seed + idx)  # the item's draws
        rng.randint(jds.count())
        flips.add(bool(rng.rand() > 0.5))
    assert flips == {True, False}
    # the float mode of the dataset too (item 0)
    kw = dict(num_scales=3, img_hw=HW, num_iterations=4, seed=seed)
    _assert_same(tloader.KittiPreparedDataset(prepared, **kw)[0],
                 jloader.KittiPreparedDataset(prepared, **kw)[0])


@pytest.mark.parametrize("seed", [0, 3])
def test_batch_loader_stream_equals_jax(prepared, seed):
    tds, jds = _datasets(prepared, seed, 0)
    kw = dict(shuffle=True, num_workers=3, prefetch=2, seed=seed)
    got = list(tloader.BatchLoader(tds, 4, **kw))
    want = list(jloader.BatchLoader(jds, 4, **kw))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        _assert_same(g, w)


@pytest.mark.parametrize("seed", [0, 3])
def test_native_loader_stream_equals_jax(prepared, seed):
    """The port's ctypes front end over its own build of the library gives
    the JAX NativeBatchLoader's stream, and ``make_loader("auto")`` picks it
    (both libraries build here)."""
    assert tnative.load_lib() is not None and jnative.load_lib() is not None
    so = Path(tnative.ensure_built())
    assert so.parent == PKG / "_build" and so.name.startswith("libkittidata-")
    assert Path(tnative.SOURCE) == PKG.parent / "native" / "kitti_data_service.cc"
    tds, jds = _datasets(prepared, seed, 1 << 30)
    kw = dict(shuffle=True, num_workers=3, prefetch=2, seed=seed)
    loader = tnative.make_loader(tds, 4, impl="auto", **kw)
    assert isinstance(loader, tnative.NativeBatchLoader)
    got = list(loader)
    want = list(jnative.NativeBatchLoader(jds, 4, **kw))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        _assert_same(g, w)
    assert isinstance(tnative.make_loader(tds, 4, impl="python", **kw), tloader.BatchLoader)
    with pytest.raises(ValueError):
        tnative.make_loader(tds, 4, impl="cuda")


def test_native_build_failure_gives_none(prepared, monkeypatch, tmp_path):
    """A library that cannot be built (here: no compiler) is None, and
    ``auto`` then gives the Python loader; nothing is left in the build dir."""
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert tnative.ensure_built() is None
    assert tnative.load_lib() is None
    assert list((tmp_path / "_build").iterdir()) == []
    ds = tloader.KittiPreparedDataset(prepared, img_hw=HW, uint8_images=True)
    assert isinstance(tnative.make_loader(ds, 2, impl="auto"), tloader.BatchLoader)


def test_to_device_batch_on_cpu():
    """On the CPU the arrays are wrapped, not copied; a flipped view is made
    contiguous."""
    a = np.arange(24, dtype=np.uint8).reshape(2, 3, 4)
    b = np.ones((2, 3), np.float32)[:, ::-1]
    ta, tb = to_device_batch((a, b), "cpu")
    assert ta.data_ptr() == a.ctypes.data and ta.dtype == torch.uint8
    np.testing.assert_array_equal(tb.numpy(), b)
