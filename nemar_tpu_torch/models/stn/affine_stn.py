"""Global affine STN R: a conv encoder and a two-layer dense head predict a
residual affine Δθ from the (a, b) pair; θ = identity + Δθ samples every
image in ``imgs`` through ``affine_grid`` in ONE bilinear grid sample
(K-warp on the card).

Counterpart of ``nemar_tpu/models/stn/affine_stn.py``:

  * ``n_downs`` x [conv k3 s2 p1, IN + leaky_relu(0.2)], widths doubling
    from ngf to at most 8 ngf (the IN on K-in on the card);
  * head 'flatten' (the features of the last map, in the reference's NHWC
    order) or 'gap' (their spatial mean), then ``Dense_0`` to 64 and
    leaky_relu 0.2, then ``Dense_1`` to the 6 entries of Δθ, zero-initialised
    (here and, after its init draws, by the model) so a fresh R warps by the
    identity;
  * reg: the batch mean of Σ Δθ²; aux: θ, the grid, Δθ and the implied
    displacement field, grid − identity.

Under ``--bf16`` Δθ and the reg are bf16, as in the JAX package; θ and the
grid are fp32 (identity + Δθ cast up), and so is the implied field.

Under --mesh_spatial ``forward`` takes a ``band``, this rank's rows of the
frame: each conv and its instance norm run in band form
(``networks.conv_band``, ``norm_act_band``) at every level, on the bands
its geometry gives, uneven, one row or empty (64^2 over 4 ranks: the last
conv's 4 input rows in bands of one); the head runs on the last map
gathered (``spatial.gather_frame``: 8x8x256 at 256^2),
so every rank holds the same Δθ; the grid is the band's rows of
``affine_grid`` and the images are sampled from their gathered frames.
What every rank computes whole reaches the loss only through the band's
share: the warp of its rows, and reg over the group's size (the gradient
all-reduce sums over every rank).

Layers are named ``Conv_<k>`` and ``Dense_<k>`` as flax names them, so the
state_dict matches the flax tree (``utils/convert.py`` transposes the dense
kernels).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from nemar_tpu_torch.models.networks import (conv_band, norm_act, norm_act_band, to_nchw,
                                             to_nhwc)
from nemar_tpu_torch.ops.warp import affine_grid, grid_sample_multi, identity_grid
from nemar_tpu_torch.parallel import spatial


class AffineSTN(nn.Module):
    def __init__(self, in_channels: int = 6, ngf: int = 32, n_downs: int = 5,
                 padding_mode: str = "zeros", align_corners: bool = False,
                 head: str = "flatten", size: int = 256):
        """``size``: the input's side, which fixes Dense_0's width under
        the 'flatten' head."""
        super().__init__()
        if head not in ("flatten", "gap"):
            raise ValueError(f"unknown affine STN head {head!r}")
        self.n_downs = n_downs
        self.padding_mode = padding_mode
        self.align_corners = align_corners
        self.head = head
        cin, ch, side = in_channels, ngf, size
        for k in range(n_downs):
            setattr(self, f"Conv_{k}", nn.Conv2d(cin, ch, 3, stride=2, padding=1))
            cin, ch, side = ch, min(ch * 2, ngf * 8), -(-side // 2)
        self.Dense_0 = nn.Linear(cin * (side * side if head == "flatten" else 1), 64)
        self.Dense_1 = nn.Linear(64, 6)
        nn.init.zeros_(self.Dense_1.weight)
        nn.init.zeros_(self.Dense_1.bias)

    def heads(self) -> list:
        """The zero-initialised layer: Δθ's."""
        return [self.Dense_1]

    def predict_dtheta(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """(N, 2, 3) residual affine parameters from NCHW a and b."""
        h = torch.cat([a, b], dim=1)
        for k in range(self.n_downs):
            h = norm_act(getattr(self, f"Conv_{k}")(h), "leaky_relu")
        return self._head(h)

    def predict_dtheta_band(self, a: torch.Tensor, b: torch.Tensor, band) -> torch.Tensor:
        """``predict_dtheta`` of the frame of which a and b are this rank's
        band: the encoder in band form at every level (its bands uneven, one
        row or empty where the levels are thinner than the group), then
        the head on the last map's frame, gathered (the same Δθ on every
        rank)."""
        h, bd = torch.cat([a, b], dim=1), band
        for k in range(self.n_downs):
            h, bd = conv_band(getattr(self, f"Conv_{k}"), h, bd)
            h = norm_act_band(h, bd, "leaky_relu")
        return self._head(spatial.gather_frame(h, bd, dim=2))

    def _head(self, h: torch.Tensor) -> torch.Tensor:
        """Δθ (N, 2, 3) from the last map (NCHW)."""
        if self.head == "gap":
            h = h.mean(dim=(2, 3))
        else:
            # the reference flattens NHWC: (y, x, c) order, as Dense_0's rows
            h = to_nhwc(h).reshape(h.shape[0], -1)
        h = F.leaky_relu(self.Dense_0(h), 0.2)
        return self.Dense_1(h).reshape(-1, 2, 3)

    def forward(self, a: torch.Tensor, b: torch.Tensor, imgs: Sequence[torch.Tensor] = (),
                n_grad_imgs: int = -1, band=None):
        """(warped imgs, identity reg, {'theta', 'grid', 'dtheta', 'flow'});
        images NCHW in and out. With ``band`` (``spatial.Band``) a, b, the
        images, the grid and the flow are this rank's band of the frame's,
        reg its share."""
        if band is not None:
            return self._forward_band(a, b, imgs, n_grad_imgs, band)
        dtheta = self.predict_dtheta(a, b)
        n, _, h, w = a.shape
        # grid coordinates are at least fp32 whatever the activations' type
        cdt = torch.float64 if dtheta.dtype == torch.float64 else torch.float32
        # made on the device (no copy from the host: a CUDA graph captures it)
        eye = torch.eye(2, 3, dtype=cdt, device=a.device)
        theta = eye[None] + dtheta.to(cdt)
        grid = affine_grid(theta, (n, 1, h, w), self.align_corners)
        warped = ()
        if imgs:
            warped = grid_sample_multi([to_nhwc(i) for i in imgs], grid, "bilinear",
                                       self.padding_mode, self.align_corners, n_grad_imgs)
            warped = tuple(to_nchw(wp) for wp in warped)
        reg = dtheta.reshape(n, -1).square().sum(dim=1).mean()
        flow = grid - identity_grid(h, w, self.align_corners, grid.dtype, grid.device)[None]
        return warped, reg, {"theta": theta, "grid": grid, "dtheta": dtheta, "flow": flow}

    def _forward_band(self, a, b, imgs, n_grad_imgs: int, band):
        dtheta = self.predict_dtheta_band(a, b, band)
        n, w = a.shape[0], a.shape[3]
        cdt = torch.float64 if dtheta.dtype == torch.float64 else torch.float32
        eye = torch.eye(2, 3, dtype=cdt, device=a.device)
        theta = eye[None] + dtheta.to(cdt)
        grid = affine_grid(theta, (n, 1, band.height, w), self.align_corners)[:, band.r0:band.r1]
        warped = ()
        if imgs:
            frames = [spatial.gather_frame(to_nhwc(i), band, dim=1) for i in imgs]
            warped = grid_sample_multi(frames, grid, "bilinear", self.padding_mode,
                                       self.align_corners, n_grad_imgs)
            warped = tuple(to_nchw(wp) for wp in warped)
        # Δθ is the same on every rank: each holds 1/size of its reg
        reg = dtheta.reshape(n, -1).square().sum(dim=1).mean() / band.size
        ident = identity_grid(band.height, w, self.align_corners, grid.dtype, grid.device)
        flow = grid - ident[band.r0:band.r1][None]
        return warped, reg, {"theta": theta, "grid": grid, "dtheta": dtheta, "flow": flow}
