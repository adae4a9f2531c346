"""Dataset base + preprocessing pipeline (reference data/base_dataset.py).

Reimplements the reference's get_params/get_transform semantics
(SURVEY.md §3.1): ``--preprocess {resize_and_crop, crop, scale_width,
scale_width_and_crop, none}``, shared random crop/flip params so A and B
receive the SAME geometric augmentation, normalization to [-1, 1].

PIL + numpy only (no torchvision); output is HWC float32 in [-1, 1] —
NHWC after collation, the TPU-native layout.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np
from PIL import Image


class BaseDataset(ABC):
    def __init__(self, opt):
        self.opt = opt
        self.root = opt.dataroot
        self._epoch = 0

    @staticmethod
    def modify_commandline_options(parser, is_train):
        return parser

    def set_epoch(self, epoch: int):
        """Advance the augmentation stream (loaders call this per epoch)."""
        self._epoch = int(epoch)

    def item_rng(self, index: int) -> np.random.Generator:
        """Deterministic per-(seed, epoch, index) generator for __getitem__
        param draws. A shared mutable stream would re-draw identical crops in
        every worker process of the worker loader (``grain_loader.py``) and
        make thread-loader runs depend on arrival order; keying on the item
        index makes draws identical for any worker count."""
        return np.random.default_rng(
            (getattr(self.opt, "seed", 0), self._epoch, index)
        )

    @abstractmethod
    def __len__(self):
        ...

    @abstractmethod
    def __getitem__(self, index):
        ...


def get_params(opt, size, rng: np.random.Generator):
    """One random crop/flip draw, shared by A and B (reference get_params)."""
    w, h = size
    new_h, new_w = h, w
    if opt.preprocess == "resize_and_crop":
        new_h = new_w = opt.load_size
    elif opt.preprocess == "scale_width_and_crop":
        new_w = opt.load_size
        new_h = opt.load_size * h // w

    x = int(rng.integers(0, max(0, new_w - opt.crop_size) + 1))
    y = int(rng.integers(0, max(0, new_h - opt.crop_size) + 1))
    flip = bool(rng.random() > 0.5)
    return {"crop_pos": (x, y), "flip": flip}


def get_transform(opt, params=None, grayscale=False, method=Image.BICUBIC,
                  convert=True):
    """Compose the preprocessing pipeline (reference get_transform).

    Returns fn: PIL.Image -> HWC float32 numpy in [-1, 1].

    The crop+flip+normalize tail runs through the native C++ kernel
    (native/augment.cpp, one fused pass into the batch dtype) when the
    library is built; the numpy path is the bit-identical fallback.
    """
    steps = []
    if grayscale:
        steps.append(lambda img: img.convert("L"))
    else:
        steps.append(lambda img: img.convert("RGB"))

    if "resize" in opt.preprocess:
        steps.append(lambda img: img.resize((opt.load_size, opt.load_size), method))
    elif "scale_width" in opt.preprocess:
        steps.append(lambda img: _scale_width(img, opt.load_size, opt.crop_size, method))

    # fused native tail: crop (+flip) + normalize in one pass
    use_native_tail = (
        convert and "crop" in opt.preprocess and params is not None
    )

    if "crop" in opt.preprocess and not use_native_tail:
        if params is None:
            steps.append(lambda img: _center_crop(img, opt.crop_size))
        else:
            steps.append(lambda img: _crop(img, params["crop_pos"], opt.crop_size))

    if opt.preprocess == "none":
        steps.append(lambda img: _make_power_2(img, base=4, method=method))

    do_flip = (not opt.no_flip) and params is not None and params["flip"]
    if do_flip and not use_native_tail:
        steps.append(lambda img: img.transpose(Image.FLIP_LEFT_RIGHT))

    def apply(img: Image.Image) -> np.ndarray:
        for s in steps:
            img = s(img)
        if not convert:
            return img
        if use_native_tail:
            from nemar_tpu_torch.data import native_ops

            arr = np.asarray(img, dtype=np.uint8)
            if arr.ndim == 2:
                arr = arr[:, :, None]
            h, w = arr.shape[:2]
            cs = opt.crop_size
            if h >= cs and w >= cs:
                x, y = params["crop_pos"]
                x = min(x, w - cs)
                y = min(y, h - cs)
                return native_ops.crop_flip_norm(arr, y, x, cs, cs, do_flip)
            # undersized image: skip crop (reference _crop behavior)
            out = arr.astype(np.float32) / 127.5 - 1.0
            return out[:, ::-1].copy() if do_flip else out
        arr = np.asarray(img, dtype=np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr * 2.0 - 1.0  # Normalize(0.5, 0.5)

    return apply


def _make_power_2(img, base, method=Image.BICUBIC):
    ow, oh = img.size
    w = int(round(ow / base) * base)
    h = int(round(oh / base) * base)
    if h == oh and w == ow:
        return img
    _print_size_warning(ow, oh, w, h)
    return img.resize((w, h), method)


def _scale_width(img, target_size, crop_size, method=Image.BICUBIC):
    ow, oh = img.size
    if ow == target_size and oh >= crop_size:
        return img
    w = target_size
    h = int(max(target_size * oh / ow, crop_size))
    return img.resize((w, h), method)


def _crop(img, pos, size):
    ow, oh = img.size
    x1, y1 = pos
    if ow > size or oh > size:
        return img.crop((x1, y1, x1 + size, y1 + size))
    return img


def _center_crop(img, size):
    ow, oh = img.size
    x1 = max(0, (ow - size) // 2)
    y1 = max(0, (oh - size) // 2)
    return img.crop((x1, y1, x1 + size, y1 + size))


_warned = False


def _print_size_warning(ow, oh, w, h):
    global _warned
    if not _warned:
        print(
            f"The image size needs to be a multiple of 4. The loaded image size "
            f"was ({ow}, {oh}), so it was adjusted to ({w}, {h})."
        )
        _warned = True
