"""Misc utilities (reference util/util.py), this package's copy of
``nemar_tpu/utils/util.py``."""

from __future__ import annotations

import os

import numpy as np
from PIL import Image


def tensor2im(arr, imtype=np.uint8) -> np.ndarray:
    """[-1,1] NHWC (or HWC) array -> uint8 HWC image.

    Reference tensor2im converts CHW torch tensors; layout here is NHWC
    (first batch element taken, like the reference).
    """
    arr = np.asarray(arr)
    if arr.ndim == 4:
        arr = arr[0]
    if arr.ndim != 3:
        raise ValueError(f"expected HWC image, got shape {arr.shape}")
    if arr.shape[2] == 1:
        arr = np.repeat(arr, 3, axis=2)
    img = (np.clip(arr.astype(np.float32), -1.0, 1.0) + 1.0) / 2.0 * 255.0
    return img.astype(imtype)


def save_image(image_numpy: np.ndarray, image_path: str, aspect_ratio: float = 1.0):
    """uint8 HWC numpy -> PNG/JPG on disk (reference save_image)."""
    image_pil = Image.fromarray(image_numpy)
    h, w, _ = image_numpy.shape
    if aspect_ratio > 1.0:
        image_pil = image_pil.resize((int(w * aspect_ratio), h), Image.BICUBIC)
    if aspect_ratio < 1.0:
        image_pil = image_pil.resize((w, int(h / aspect_ratio)), Image.BICUBIC)
    image_pil.save(image_path)


def diagnose_network(net, name="network"):
    """Mean absolute value of parameters (reference diagnose_network): the
    mean over the parameters of ``net`` (an ``nn.Module``) of each one's
    mean |value|."""
    leaves = [p.detach().cpu().numpy() for p in net.parameters()]
    if not leaves:
        print(f"{name}: no parameters")
        return 0.0
    mean = float(np.mean([float(abs(np.asarray(x)).mean()) for x in leaves]))
    print(f"{name}: mean abs param {mean}")
    return mean


def mkdirs(paths):
    if isinstance(paths, (list, tuple)):
        for path in paths:
            os.makedirs(path, exist_ok=True)
    else:
        os.makedirs(paths, exist_ok=True)


def mkdir(path):
    os.makedirs(path, exist_ok=True)
