"""Carry the JAX package's parameters across: flax trees -> torch state_dicts.

``flax_to_torch(params, module, dtype)`` takes a flax variables tree as
nested dicts of numpy arrays (``{'params': {...}}`` or the inner dict) and
returns the state_dict of ``module``, as tensors of ``dtype`` (float32 by
default), one of this package's nets, whose attribute names
are the flax names in creation order (``models/networks.py``,
``models/stn/unet_stn.py``, ``models/stn/affine_stn.py``):

  * ``Conv`` kernels go from HWIO to OIHW; biases are copied as they are
    (the trunk blocks' biases load but are inert through IN, as in JAX);
  * ``ConvTranspose`` kernels (flax ``ConvTranspose(k, s2, 'SAME')``) are
    flipped spatially and permuted (kh, kw, in, out) -> (in, out, kh, kw);
    the module runs ``ConvTranspose2d(stride=2, padding=0)`` and crops to
    ``[:2H, :2W]``, which matches flax exactly. (Flipping and using
    ``padding=1, output_padding=1`` instead is off by one pixel.)
  * ``Dense`` kernels (in, out) are transposed to ``nn.Linear``'s (out,
    in); their rows keep flax's order (the affine STN flattens its features
    NHWC, as flax does, so no permutation is needed).

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


def flax_to_torch(params: Mapping, module: nn.Module, dtype: torch.dtype = torch.float32) -> dict:
    tree = params["params"] if "params" in params else params
    mods = dict(module.named_modules())
    target = module.state_dict()
    out = {}
    for path, arr in _flatten(tree).items():
        *mod_path, leaf = path
        name = ".".join(mod_path)
        mod = mods.get(name)
        if not isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)) \
                or leaf not in ("kernel", "bias"):
            raise KeyError(f"flax leaf {'/'.join(path)} has no counterpart in "
                           f"{type(module).__name__}")
        if leaf == "bias":
            key, val = f"{name}.bias", arr
        elif isinstance(mod, nn.ConvTranspose2d):
            key, val = f"{name}.weight", arr[::-1, ::-1].transpose(2, 3, 0, 1)
        elif isinstance(mod, nn.Linear):
            key, val = f"{name}.weight", arr.T
        else:
            key, val = f"{name}.weight", arr.transpose(3, 2, 0, 1)
        if tuple(val.shape) != tuple(target[key].shape):
            raise ValueError(f"{'/'.join(path)}: shape {val.shape} does not fit {key} "
                             f"{tuple(target[key].shape)}")
        out[key] = torch.tensor(np.ascontiguousarray(val), dtype=dtype)
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"flax tree lacks {missing} of {type(module).__name__}")
    return out
