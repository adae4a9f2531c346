"""Recursive image listing (reference data/image_folder.py)."""

from __future__ import annotations

import os

IMG_EXTENSIONS = [
    ".jpg", ".JPG", ".jpeg", ".JPEG", ".png", ".PNG", ".ppm", ".PPM",
    ".bmp", ".BMP", ".tif", ".TIF", ".tiff", ".TIFF", ".webp",
]


def is_image_file(filename: str) -> bool:
    return any(filename.endswith(ext) for ext in IMG_EXTENSIONS)


def make_dataset(directory: str, max_dataset_size=float("inf")):
    images = []
    assert os.path.isdir(directory), f"{directory} is not a valid directory"
    for root, _, fnames in sorted(os.walk(directory)):
        for fname in sorted(fnames):
            if is_image_file(fname):
                images.append(os.path.join(root, fname))
    return images[: min(max_dataset_size, len(images))]
