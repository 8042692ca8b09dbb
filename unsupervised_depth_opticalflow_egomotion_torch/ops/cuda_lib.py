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
"""

from __future__ import annotations

import ctypes
import hashlib
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
    """One C entry of a csrc library, with its launch count."""

    def __init__(self, library: str, symbol: str, argtypes: list):
        self.library = library
        self.symbol = symbol
        self.source = f"unsupervised_depth_opticalflow_egomotion_torch/csrc/{library}.cu"
        self._argtypes = [*argtypes, ctypes.c_void_p]  # + stream
        self._fn = None
        self.launches = 0
        self.seen: set[tuple] = set()

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(load(self.library), self.symbol)
            fn.argtypes = self._argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err} at launch")
        self.launches += 1
        self.seen.add(self.signature(*args))

    def signature(self, *args) -> tuple:
        """The integer arguments of a launch (dtype codes and sizes), and for
        each pointer whether it was given: what tells two launches apart."""
        return tuple(
            a if t is ctypes.c_int else a is not None for a, t in zip(args, self._argtypes)
        )


def check_cuda_tensor(name: str, t: torch.Tensor, dtypes, shape=None) -> None:
    """Validate a tensor handed to a kernel (device, dtype, shape, layout)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
