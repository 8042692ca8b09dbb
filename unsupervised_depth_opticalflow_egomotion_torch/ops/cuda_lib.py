"""Build, load and launch the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with nvcc
for ``sm_90a`` into its own shared library under ``_build/`` (listed in
.gitignore), named by a hash of its source, at first use; the library is
loaded with ctypes. ``build_all`` starts one nvcc per source at once. Every
C entry takes its tensors as raw pointers, the CUDA stream last, launches
on that stream and returns ``cudaGetLastError()``.

A ``CudaKernel`` is one C entry: its ctypes binding and a plain integer
``launches`` count, incremented where the kernel is launched and nowhere
else, so a run can show that its main path went through the kernel. It also
keeps the set of argument signatures it was launched with (``seen``), so a
run can show that every shape and dtype its path gave the kernel was one
that had been held against the plain version.

A launch goes to the card its tensors lie on: ``check_cuda_tensor`` returns
a tensor's device index and refuses the tensors of one launch that lie on
different cards, and ``CudaKernel`` takes that index first, launches on the
current stream of that device, and enters the device's context only when it
is not the current one.
"""

from __future__ import annotations

import ctypes
import hashlib
import operator
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# ctypes codes of the tensor dtypes the kernels take (csrc/*.cu: DType)
DTYPE_CODE = {torch.uint8: 0, torch.bfloat16: 1, torch.float32: 2}

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def sources() -> list[str]:
    """Names of every kernel source in csrc/."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def build_all(names=None) -> dict[str, str]:
    """Compile every (given) source not built yet, one nvcc each, in parallel.

    Returns {name: ptxas report} for the sources compiled by this call.
    Raises with the compiler's output if any build fails.
    """
    names = sources() if names is None else list(names)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = _lib_path(n).with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    reports, failed = {}, []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {n}.cu (exit {proc.returncode})\n{out}")
            continue
        os.replace(tmp, _lib_path(n))
        reports[n] = out
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        build_all([name])
        _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return _LIBS[name]


class CudaKernel:
    """One C entry of a csrc library, with its launch count.

    ``optional`` names the positions of the pointer arguments that may be
    None (a null pointer): whether each was given is part of the signature.
    The ctypes binding is made at the first call; a call costs the argument
    conversions, the current device and its stream, and the signature.
    """

    def __init__(self, library: str, symbol: str, argtypes: list, optional: tuple = ()):
        self.library = library
        self.symbol = symbol
        self.source = f"unsupervised_depth_opticalflow_egomotion_torch/csrc/{library}.cu"
        self._argtypes = [*argtypes, ctypes.c_void_p]  # + stream
        # every C entry takes at least two integers, so this returns a tuple
        self._pick_ints = operator.itemgetter(
            *(i for i, t in enumerate(argtypes) if t is ctypes.c_int))
        self._optional = tuple(optional)
        self._fn = None
        self.launches = 0
        self.seen: set[tuple] = set()

    def __call__(self, device: int, *args) -> None:
        """Launch with ``args`` on CUDA device ``device`` (the index of the
        card the launch's tensors lie on), on its current stream."""
        fn = self._fn
        if fn is None:
            fn = getattr(load(self.library), self.symbol)
            fn.argtypes = self._argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        if device == _current_device():
            err = fn(*args, _raw_stream(device))
        else:
            with _device_context(device):
                err = fn(*args, _raw_stream(device))
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err} at launch")
        self.launches += 1
        self.seen.add(self.signature(*args))

    def signature(self, *args) -> tuple:
        """The integer arguments of a launch (dtype codes and sizes), then for
        each optional pointer whether it was given: what tells two launches
        apart."""
        sig = self._pick_ints(args)
        if self._optional:
            sig += tuple(args[i] is not None for i in self._optional)
        return sig


def _current_device() -> int:
    return torch._C._cuda_getDevice()


def _raw_stream(device: int) -> int:
    """The handle of the current CUDA stream of ``device``, without building
    a ``torch.cuda.Stream`` object."""
    return torch._C._cuda_getCurrentRawStream(device)


_device_context = torch.cuda.device  # makes a device current for a block


def check_cuda_tensor(name: str, t: torch.Tensor, dtypes, shape=None, device=None) -> int:
    """Validate a tensor handed to a kernel (device, dtype, shape, layout)
    and return the index of its card. ``device``: the card of the launch's
    other tensors, which this one must share."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    index = t.get_device()
    if device is not None and index != device:
        raise ValueError(f"{name}: on cuda:{index}, the launch's other tensors on cuda:{device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if shape is not None and t.shape != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    return index
