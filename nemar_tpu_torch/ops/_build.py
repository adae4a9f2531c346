"""Build the package's CUDA kernels with nvcc; locate Triton's cache.

The CUDA sources under ``nemar_tpu_torch/csrc/`` have a plain C interface.
At first use they are compiled, all in one nvcc call, into one shared
library under ``nemar_tpu_torch/_build/`` (listed in ``.gitignore``), named by
a hash of the sources and flags, and loaded with ``ctypes``. A rebuild
happens only when a source or a flag changes. The library is written under a
temporary name and renamed into place, so processes that build at the same
time never load a half-written file.

Nothing here runs at import time: this module is imported on machines
without CUDA, where only the ops' plain PyTorch versions run.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    """nvcc from $CUDA_HOME, else from PATH, else the toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libnemar_kernels_{digest.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the library if it is not built yet; (path, seconds spent).

    nvcc's output, ptxas's per-kernel register and spill counts included,
    is kept beside the library as ``<name>.log``.
    """
    path = library_path()
    if path.exists():
        return path, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sorted(CSRC_DIR.glob("*.cu")))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, path)
    return path, seconds


@functools.cache
def _library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.nemar_cuda_error_string.argtypes = [ctypes.c_int]
    lib.nemar_cuda_error_string.restype = ctypes.c_char_p
    return lib


def c_function(name: str, argtypes: list):
    """A launcher of the library, with its argument types declared.

    Pointers and the stream must be declared ``ctypes.c_void_p``: undeclared,
    ctypes would pass them as 32-bit ints and cut them.
    """
    fn = getattr(_library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never runs)."""
    if code != 0:
        msg = _library().nemar_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def import_triton():
    """Import triton, with its kernel cache under the build directory."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton

    return triton
