"""Carry the JAX package's parameters across: flax trees -> torch state_dicts.

``flax_to_torch(params, module, dtype)`` takes a flax variables tree as
nested dicts of numpy arrays (``{'params': {...}}`` or the inner dict) and
returns the state_dict of ``module``, as tensors of ``dtype`` (float32 by
default), one of this package's nets, whose attribute names
are the flax names in creation order (``models/networks.py``: the ResNet
and UNet generators, whose ``ConvTranspose_0`` is the UNet's innermost,
the PatchGAN and the pixel D, each of cycle_gan's four nets;
``models/stn/unet_stn.py``, ``models/stn/affine_stn.py``):

  * ``Conv`` kernels go from HWIO to OIHW; biases are copied as they are
    (under instance norm the fused trunk blocks' load but are inert, as in
    JAX);
  * ``ConvTranspose`` kernels (flax ``ConvTranspose(k, s2, 'SAME')``) are
    flipped spatially and permuted (kh, kw, in, out) -> (in, out, kh, kw),
    whatever k. The modules differ in their padding: flax pads the
    dilated input by (2, 1) for k 3 and by (2, 2) for k 4. So the ResNet
    decoder's 3x3 runs ``ConvTranspose2d(stride=2, padding=0)`` cropped to
    ``[:2H, :2W]`` (flipping and using ``padding=1, output_padding=1``
    instead is off by one pixel), and the UNet's 4x4
    ``ConvTranspose2d(stride=2, padding=1)``, uncropped;
  * ``Dense`` kernels (in, out) are transposed to ``nn.Linear``'s (out,
    in); their rows keep flax's order (the affine STN flattens its features
    NHWC, as flax does, so no permutation is needed).

The JAX state's EMA shadows (``state.ema["G"]``, ``state.ema["R"]``) are
parameter trees of G and R: ``flax_to_torch(state.ema["G"], netG)`` is the
state_dict of the pseudo-net ``{suffix}_net_G_ema.pth`` (``--ema_decay``,
``models/nemar_model.py``), with netG's keys.

A module that flax's ``nn.remat`` wrapped is named after the wrapped class
with ``Checkpoint`` in front (``--remat``'s ResNet trunk blocks:
``CheckpointResnetBlock_3``): it is read as the module it wraps
(``ResnetBlock_3``), so a tree from a run with or without --remat converts
alike.

A flax leaf without a counterpart, a parameter the tree does not give, or a
shape that differs raises.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn as nn


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def kernel_to_torch(mod: nn.Module, kernel: np.ndarray) -> np.ndarray:
    """A flax kernel of the layer ``mod`` in the layout of ``mod.weight``."""
    if isinstance(mod, nn.ConvTranspose2d):
        return kernel[::-1, ::-1].transpose(2, 3, 0, 1)
    if isinstance(mod, nn.Linear):
        return kernel.T
    return kernel.transpose(3, 2, 0, 1)


def _unwrap_remat(name: str) -> str:
    """A flax module name with ``nn.remat``'s ``Checkpoint`` prefix removed."""
    return name.removeprefix("Checkpoint")


def flax_to_torch(params: Mapping, module: nn.Module, dtype: torch.dtype = torch.float32) -> dict:
    tree = params["params"] if "params" in params else params
    mods = dict(module.named_modules())
    target = module.state_dict()
    out = {}
    for path, arr in _flatten(tree).items():
        *mod_path, leaf = path
        name = ".".join(_unwrap_remat(m) for m in mod_path)
        mod = mods.get(name)
        if not isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)) \
                or leaf not in ("kernel", "bias"):
            raise KeyError(f"flax leaf {'/'.join(path)} has no counterpart in "
                           f"{type(module).__name__}")
        if leaf == "bias":
            key, val = f"{name}.bias", arr
        else:
            key, val = f"{name}.weight", kernel_to_torch(mod, arr)
        if tuple(val.shape) != tuple(target[key].shape):
            raise ValueError(f"{'/'.join(path)}: shape {val.shape} does not fit {key} "
                             f"{tuple(target[key].shape)}")
        out[key] = torch.tensor(np.ascontiguousarray(val), dtype=dtype)
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"flax tree lacks {missing} of {type(module).__name__}")
    return out
