"""ctypes binding for the native data-path kernels (native/augment.cpp).

The reference's input hot loops live in torch's C++ (SURVEY.md §3.3); ours
live in libnemar_native.so: fused crop+flip+normalize+collate and bilinear
resize over uint8 images. Falls back to numpy transparently when the
library isn't built (build with: make -C native).

The two are not bit-identical: the library computes ``x * (2/255) - 1``
(one fused multiply-add where the compiler contracts it), numpy ``x / 127.5
- 1``, an ulp apart for most values. So every process of a run must take
the same one: the library is opened once per process under a lock (a
thread that asks while another opens it waits for it, where it used to take
numpy for that item), and built into a temporary file that is renamed into
place (a process never opens a half-written library that another is
building). The worker loader opens it in its parent before the workers
start (``grain_loader.py``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_LIB = None
_TRIED = False
_LOCK = threading.Lock()

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_SO_PATH = os.path.join(_NATIVE_DIR, "libnemar_native.so")


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _LOCK:
        if not _TRIED:
            _LIB = _open()
            _TRIED = True
    return _LIB


def _open():
    if not os.path.exists(_SO_PATH):
        # best-effort build (toolchain is available in dev images), under a
        # name of this process's, then renamed into place
        tmp = f"{os.path.basename(_SO_PATH)}.{os.getpid()}.tmp"
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR, f"TARGET={tmp}"], capture_output=True,
                timeout=120, check=True,
            )
            os.replace(os.path.join(_NATIVE_DIR, tmp), _SO_PATH)
        except Exception:
            if os.path.exists(os.path.join(_NATIVE_DIR, tmp)):
                os.remove(os.path.join(_NATIVE_DIR, tmp))
            return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
        lib.crop_flip_norm_u8.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ]
        lib.batch_crop_flip_norm_u8.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
        ]
        lib.resize_bilinear_u8.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        return lib
    except OSError:
        return None


def native_available() -> bool:
    return _load() is not None


def crop_flip_norm(img_u8: np.ndarray, y0: int, x0: int, ch: int, cw: int,
                   flip: bool) -> np.ndarray:
    """uint8 HWC -> float32 [-1,1] HWC crop (+flip), one fused pass."""
    img_u8 = np.ascontiguousarray(img_u8)
    h, w, c = img_u8.shape
    lib = _load()
    if lib is None:
        view = img_u8[y0 : y0 + ch, x0 : x0 + cw]
        if flip:
            view = view[:, ::-1]
        return view.astype(np.float32) / 127.5 - 1.0
    out = np.empty((ch, cw, c), np.float32)
    lib.crop_flip_norm_u8(
        img_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, c, y0, x0, ch, cw, int(flip),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


def batch_crop_flip_norm(imgs_u8: np.ndarray, y0: np.ndarray, x0: np.ndarray,
                         flips: np.ndarray, ch: int, cw: int,
                         num_threads: int = 4) -> np.ndarray:
    """(N,H,W,C) uint8 -> (N,ch,cw,C) float32 batch, fused + threaded."""
    imgs_u8 = np.ascontiguousarray(imgs_u8)
    n, h, w, c = imgs_u8.shape
    lib = _load()
    y0 = np.ascontiguousarray(y0, np.int32)
    x0 = np.ascontiguousarray(x0, np.int32)
    flips = np.ascontiguousarray(flips, np.uint8)
    if lib is None:
        out = np.empty((n, ch, cw, c), np.float32)
        for i in range(n):
            out[i] = crop_flip_norm(imgs_u8[i], int(y0[i]), int(x0[i]), ch, cw,
                                    bool(flips[i]))
        return out
    out = np.empty((n, ch, cw, c), np.float32)
    lib.batch_crop_flip_norm_u8(
        imgs_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, h, w, c,
        y0.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        x0.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        flips.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ch, cw,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        num_threads,
    )
    return out


def resize_bilinear(img_u8: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """uint8 HWC bilinear resize (half-pixel centers)."""
    img_u8 = np.ascontiguousarray(img_u8)
    h, w, c = img_u8.shape
    lib = _load()
    if lib is None:
        from PIL import Image

        pil = Image.fromarray(img_u8.squeeze() if c == 1 else img_u8)
        arr = np.asarray(pil.resize((ow, oh), Image.BILINEAR))
        return arr[:, :, None] if arr.ndim == 2 else arr
    out = np.empty((oh, ow, c), np.uint8)
    lib.resize_bilinear_u8(
        img_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, c, oh, ow,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out


def _selftest():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (40, 50, 3), np.uint8)
    got = crop_flip_norm(img, 3, 5, 16, 20, True)
    ref = img[3:19, 5:25][:, ::-1].astype(np.float32) / 127.5 - 1.0
    assert np.allclose(got, ref, atol=1e-6), np.abs(got - ref).max()

    imgs = rng.integers(0, 256, (4, 40, 50, 3), np.uint8)
    y0 = np.array([0, 1, 2, 3]); x0 = np.array([5, 4, 3, 2])
    flips = np.array([0, 1, 0, 1])
    got = batch_crop_flip_norm(imgs, y0, x0, flips, 16, 20, num_threads=2)
    for i in range(4):
        v = imgs[i, y0[i] : y0[i] + 16, x0[i] : x0[i] + 20]
        if flips[i]:
            v = v[:, ::-1]
        assert np.allclose(got[i], v.astype(np.float32) / 127.5 - 1.0, atol=1e-6)

    r = resize_bilinear(img, 20, 25)
    assert r.shape == (20, 25, 3)
    print(f"native_ops selftest OK (native={'yes' if native_available() else 'NO (numpy fallback)'})")


if __name__ == "__main__":
    _selftest()
