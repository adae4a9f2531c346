"""Build the package's CUDA kernels with nvcc and load their PyTorch operators.

The CUDA sources under ``nemar_tpu_torch/csrc/`` are kernels behind plain C
launchers (``*.cu``) and the PyTorch operators that call them
(``ops.cpp``, ``torch.ops.nemar.*``, one per kernel). At first use each
source is compiled by its own nvcc process, all started together (the
``.cpp`` against PyTorch's ATen and c10 headers), and the objects are linked
into one shared library under ``nemar_tpu_torch/_build/`` (listed in
``.gitignore``), linked to PyTorch's ``c10``, ``c10_cuda`` and
``torch_cpu``, named by a hash of the sources (headers included), the flags
and PyTorch's version, and loaded with ``torch.ops.load_library``, which
registers the operators. A rebuild happens only when one of those changes.
The library is written under a temporary name and renamed into place, so
processes that build at the same time never load a half-written file.

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
TORCH_DIR = Path(torch.__file__).resolve().parent
CPP_FLAGS = ("-std=c++20", "-O3", "-Xcompiler", "-fPIC", "-I", str(TORCH_DIR / "include"),
             f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}")
TORCH_LIBS = ("-L", str(TORCH_DIR / "lib"), "-lc10", "-lc10_cuda", "-ltorch_cpu",
              "-Xlinker", "-rpath", "-Xlinker", str(TORCH_DIR / "lib"))


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


def _compiled() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cpp"))


def _sources() -> list[Path]:
    return _compiled() + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join((*NVCC_FLAGS, *CPP_FLAGS, torch.__version__)).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libnemar_kernels_{digest.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the library if it is not built yet; (path, seconds spent).

    One nvcc per ``.cu`` and ``.cpp``, all running at once, then one link. nvcc's
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
    for src in _compiled():
        obj = BUILD_DIR / f"{stem}.{src.stem}.o"
        flags = CPP_FLAGS if src.suffix == ".cpp" else NVCC_FLAGS
        proc = subprocess.Popen([nvcc, *flags, "-c", "-o", str(obj), str(src)],
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
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                               *(str(o) for _, o, _ in jobs), *TORCH_LIBS],
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
def _library() -> Path:
    path, _ = build()
    torch.ops.load_library(str(path))
    return path


# ctypes types of the C launchers' arguments, by the letter ``cfn`` takes
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong,
           "f": ctypes.c_float}


@functools.cache
def cfn(name: str, sig: str):
    """The library's C launcher ``name`` (the band forms' stages, which have
    no PyTorch operator), through ctypes: ``sig`` its arguments' types, one
    letter each (p pointer, i int, l long long, f float), the stream last
    included; it returns an int CUDA error code."""
    fn = getattr(ctypes.CDLL(str(_library())), name)
    fn.argtypes = [_CTYPES[k] for k in sig]
    fn.restype = ctypes.c_int
    return fn


def launch(name: str, sig: str, *args) -> None:
    """Call the C launcher ``name`` with ``args`` (tensors as their data
    pointers) on PyTorch's current stream; raise on a CUDA error."""
    vals = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    code = cfn(name, sig + "p")(*vals, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code}")


@functools.cache
def op(name: str):
    """The operator ``torch.ops.nemar.<name>`` (its default overload), built
    and registered at the first call."""
    _library()
    return getattr(torch.ops.nemar, name).default
