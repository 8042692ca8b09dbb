"""ctypes front-end for the native host data service (native/kitti_data_service.cc).

The port's own copy of the JAX package's ``data/native_loader.py``. The
library is built from the repository's ``native/kitti_data_service.cc`` with
g++ into the port's ``_build/`` (listed in .gitignore), with the flags and
libraries of ``native/Makefile``, which writes into the JAX package instead.
Building needs the libpng and libjpeg headers; where they are missing,
``make_loader(impl="auto")`` gives the Python loader.

``NativeBatchLoader`` is a drop-in for ``loader.BatchLoader`` over a
``KittiPreparedDataset`` in uint8 mode: the C++ service (pthread worker pool +
ring of preallocated batch buffers) does the expensive decode/split/resize/
flip/pack work, while sample selection, flip RNG, and intrinsics stay in
Python so the emitted sample stream is semantically identical to the pure-
Python loader's (same ``RandomState(seed+idx)`` draws, same calib parsing;
only the bilinear resize differs, by at most 1 uint8 LSB from cv2 -- pinned
in tests/test_native_loader.py).

It is the counterpart of the reference's torch DataLoader worker pool (the
reference's train.py:125, core/dataset/kitti_prepared.py:50-66): decoding in
native threads keeps input off the thread that launches the device's work.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from .loader import multiscale_intrinsics, read_cam_intrinsic, rescale_intrinsics

SOURCE = Path(__file__).resolve().parents[2] / "native" / "kitti_data_service.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# native/Makefile:6-7
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-march=native", "-shared")
LDLIBS = ("-lpng16", "-ljpeg", "-lz", "-lpthread")
_lib = None


def lib_path() -> Path:
    """Where the library of this source and these flags is built."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXXFLAGS + LDLIBS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libkittidata-{digest}.so"


def ensure_built(quiet: bool = True) -> str | None:
    """Return the shared-library path, building it with g++ if needed.

    Returns None when the library is absent and cannot be built (no source,
    no g++, or no libpng / libjpeg headers) -- callers fall back to the
    Python loader.
    """
    if not SOURCE.exists():
        return None
    so = lib_path()
    if so.exists():
        return str(so)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp{os.getpid()}.so")
    try:
        subprocess.run(
            [os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", str(tmp), str(SOURCE), *LDLIBS],
            check=True,
            capture_output=quiet,
        )
    except (OSError, subprocess.CalledProcessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, so)
    return str(so)


def load_lib():
    """Load (once) and return the ctypes handle, or None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    path = ensure_built()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:  # built on another machine: its libpng / libjpeg are not here
        return None
    lib.kds_create.restype = ctypes.c_void_p
    lib.kds_create.argtypes = [ctypes.c_int] * 5 + [ctypes.c_long]
    lib.kds_submit.restype = ctypes.c_int
    lib.kds_submit.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.kds_wait.restype = ctypes.POINTER(ctypes.c_ubyte)
    lib.kds_wait.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.kds_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.kds_destroy.argtypes = [ctypes.c_void_p]
    lib.kds_last_error.restype = ctypes.c_char_p
    lib.kds_last_error.argtypes = [ctypes.c_void_p]
    lib.kds_probe.restype = ctypes.c_int
    lib.kds_probe.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    _lib = lib
    return lib


def probe(path: str) -> tuple[int, int]:
    """(height, width) of an image file from its header only."""
    lib = load_lib()
    if lib is None:
        raise RuntimeError("native data service unavailable")
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.kds_probe(path.encode(), ctypes.byref(h), ctypes.byref(w)) != 0:
        raise RuntimeError(f"probe failed: {path}")
    return h.value, w.value


class NativeBatchLoader:
    """BatchLoader-compatible iterator backed by the C++ data service.

    Yields ``(images[B,3h,w,3] uint8, K_ms[B,S,3,3], K_inv_ms[B,S,3,3])``
    exactly like ``BatchLoader`` over a uint8 ``KittiPreparedDataset``.
    ``prefetch`` batches are in flight inside the native ring at any time.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 4,
        prefetch: int = 4,
        seed: int = 0,
        drop_last: bool = True,
    ):
        if not getattr(dataset, "uint8_images", False):
            raise ValueError("NativeBatchLoader requires uint8_images=True")
        if load_lib() is None:
            raise RuntimeError(
                "native data service unavailable (g++ could not build "
                f"{SOURCE}: are the libpng and libjpeg headers installed?)"
            )
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.seed = seed
        self.drop_last = drop_last
        self._K_cache: dict[str, tuple[np.ndarray, np.ndarray]] = {}

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    # -- sample-stream replication of KittiPreparedDataset.__getitem__ -------
    def _plan(self, idx: int):
        """(image_file, calib_file, flip) for virtual index ``idx`` -- the
        same RandomState draws as loader.py:123-126,144."""
        ds = self.dataset
        rng = np.random.RandomState(ds.seed + idx)
        if ds.num_iterations is not None:
            idx = rng.randint(ds.count())
        data = ds.data_list[idx]
        flip = rng.rand() > 0.5
        return data["image_file"], data["cam_intrinsic_file"], flip

    def _intrinsics(self, image_file: str, calib_file: str):
        key = image_file + "|" + calib_file
        cached = self._K_cache.get(key)
        if cached is None:
            H, W = probe(image_file)
            K = read_cam_intrinsic(calib_file)
            K = rescale_intrinsics(K, (H // 3, W), self.dataset.img_hw)
            cached = multiscale_intrinsics(K, self.dataset.num_scales)
            self._K_cache[key] = cached
        return cached

    def __iter__(self):
        lib = load_lib()
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed).shuffle(order)
        n_batches = len(self)
        h, w = self.dataset.img_hw
        svc = lib.kds_create(
            self.num_workers, self.prefetch + 1, self.batch_size, h, w,
            int(getattr(self.dataset, "_cache_budget", 0)),
        )
        if not svc:
            raise RuntimeError("kds_create failed")
        try:
            plans = []
            for t in range(n_batches):
                idxs = order[t * self.batch_size : (t + 1) * self.batch_size]
                plans.append([self._plan(int(i)) for i in idxs])

            def submit(ticket):
                plan = plans[ticket]
                paths = (ctypes.c_char_p * self.batch_size)(
                    *[p[0].encode() for p in plan]
                )
                flips = (ctypes.c_int * self.batch_size)(
                    *[int(p[2]) for p in plan]
                )
                if lib.kds_submit(svc, ticket, paths, flips) != 0:
                    raise RuntimeError("kds_submit failed")

            in_flight = min(self.prefetch, n_batches)
            for t in range(in_flight):
                submit(t)
            for t in range(n_batches):
                ptr = lib.kds_wait(svc, t)
                if not ptr:
                    raise RuntimeError(
                        "native loader failed: "
                        + lib.kds_last_error(svc).decode(errors="replace")
                    )
                buf = np.ctypeslib.as_array(
                    ptr, shape=(self.batch_size, 3 * h, w, 3)
                )
                images = buf.copy()  # owned; slot recycles after release
                lib.kds_release(svc, t)
                if in_flight < n_batches:
                    submit(in_flight)
                    in_flight += 1
                Ks = [self._intrinsics(p[0], p[1]) for p in plans[t]]
                K_ms = np.stack([k[0] for k in Ks])
                K_inv_ms = np.stack([k[1] for k in Ks])
                yield images, K_ms, K_inv_ms
        finally:
            lib.kds_destroy(svc)


def make_loader(dataset, batch_size, *, impl="auto", **kw):
    """Loader factory: ``impl`` in {"python", "native", "auto"}.

    "auto" uses the native service when the library is present/buildable and
    the dataset ships uint8 frames; otherwise the Python BatchLoader.
    """
    from .loader import BatchLoader

    if impl not in ("python", "auto", "native"):
        raise ValueError(f"unknown loader impl {impl!r}")
    if impl == "native" or (
        impl == "auto"
        and getattr(dataset, "uint8_images", False)
        and load_lib() is not None
    ):
        return NativeBatchLoader(dataset, batch_size, **kw)
    return BatchLoader(dataset, batch_size, **kw)
