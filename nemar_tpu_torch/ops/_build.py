"""Build the package's CUDA kernels with nvcc; locate Triton's cache.

The CUDA sources under ``nemar_tpu_torch/csrc/`` have a plain C interface.
At first use each ``.cu`` is compiled by its own nvcc process, all started
together, and the objects are linked into one shared library under
``nemar_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash of
the sources (headers included) and flags, and loaded with ``ctypes``. A rebuild
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
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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

    One nvcc per source, all running at once, then one link. nvcc's
    output, ptxas's per-kernel register and spill counts included, is kept
    beside the library as ``<name>.log``.
    """
    path = library_path()
    if path.exists():
        return path, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{path.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        obj = BUILD_DIR / f"{stem}.{src.stem}.o"
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src, obj, proc))
    log, failed = [], []
    for src, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{out[-3000:]}")
    tmp = path.with_name(f"{stem}.tmp.so")
    if not failed:
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)],
                              capture_output=True, text=True)
        log.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append(f"link ({link.returncode}):\n{link.stderr[-3000:]}")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    path.with_suffix(".log").write_text("".join(log))
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
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
