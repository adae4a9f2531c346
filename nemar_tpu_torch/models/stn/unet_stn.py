"""Dense deformable STN R: a UNet over the (a, b) pair predicts a per-pixel
displacement field φ in normalised grid units; every image in ``imgs`` is
warped with identity + φ in ONE bilinear grid sample (K-warp on the card).

Counterpart of ``nemar_tpu/models/stn/unet_stn.py`` (single flow head):

  * encoder: ``depth`` x [conv k3 s2 p1, IN + leaky_relu(0.2)], widths
    min(ngf * 2^i, 8 ngf);
  * decoder: nearest x2 upsample, conv k3 p1, IN + leaky_relu, then concat
    [skip, h];
  * head: conv k3 p1 to 2 channels, zero-initialised, so a fresh R warps by
    the identity;
  * optional ``bounded_flow``: tanh(φ) * bound.

Convs are named ``Conv_<k>`` in the reference's creation order, so the
state_dict matches the flax tree. ``--stn_head_impl fact`` and
``--stn_up_impl fused*`` are the reference's exact rewrites of the same
convolutions for the TPU's lane width; here they are the direct convs.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from nemar_tpu_torch.models.networks import norm_act, to_nchw, to_nhwc
from nemar_tpu_torch.ops.warp import grid_sample_multi, identity_grid


def smoothness_loss(flow: torch.Tensor, smooth_type: str = "l1", order: int = 1) -> torch.Tensor:
    """Difference-based TV penalty on a (N, H, W, 2) field (order 1 or 2)."""
    dy = flow[:, 1:, :, :] - flow[:, :-1, :, :]
    dx = flow[:, :, 1:, :] - flow[:, :, :-1, :]
    if order == 2:
        dy = dy[:, 1:, :, :] - dy[:, :-1, :, :]
        dx = dx[:, :, 1:, :] - dx[:, :, :-1, :]
    if smooth_type == "l1":
        return dy.abs().mean() + dx.abs().mean()
    if smooth_type == "l2":
        return dy.square().mean() + dx.square().mean()
    raise NotImplementedError(f"smooth type {smooth_type!r}")


class UnetSTN(nn.Module):
    def __init__(self, in_channels: int = 6, ngf: int = 32, depth: int = 5,
                 flow_scale: float = 1.0, smooth_type: str = "l1", smooth_order: int = 1,
                 padding_mode: str = "zeros", align_corners: bool = False,
                 bounded_flow: float = 0.0, level_scale: float = 1.0):
        super().__init__()
        self.depth = depth
        self.flow_scale = flow_scale
        self.smooth_type = smooth_type
        self.smooth_order = smooth_order
        self.padding_mode = padding_mode
        self.align_corners = align_corners
        self.bounded_flow = bounded_flow
        self.level_scale = level_scale
        chans = [min(ngf * 2**i, ngf * 8) for i in range(depth)]
        convs = []
        cin = in_channels
        for ch in chans:  # encoder
            convs.append(nn.Conv2d(cin, ch, 3, stride=2, padding=1))
            cin = ch
        for i in reversed(range(depth)):  # decoder
            out_ch = chans[i - 1] if i > 0 else ngf
            convs.append(nn.Conv2d(cin, out_ch, 3, padding=1))
            cin = out_ch + (chans[i - 1] if i > 0 else 0)
        head = nn.Conv2d(cin, 2, 3, padding=1)
        nn.init.zeros_(head.weight)
        nn.init.zeros_(head.bias)
        convs.append(head)
        for k, conv in enumerate(convs):
            setattr(self, f"Conv_{k}", conv)
        self.n_convs = len(convs)

    def head(self) -> nn.Conv2d:
        """The zero-initialised flow head."""
        return getattr(self, f"Conv_{self.n_convs - 1}")

    def predict_flow(self, a: torch.Tensor, b: torch.Tensor):
        """(N, H, W, 2) field in normalised grid units from NCHW a and b."""
        h = torch.cat([a, b], dim=1)
        skips = []
        for k in range(self.depth):
            h = norm_act(getattr(self, f"Conv_{k}")(h), "leaky_relu")
            skips.append(h)
        for j, i in enumerate(reversed(range(self.depth))):
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            h = norm_act(getattr(self, f"Conv_{self.depth + j}")(h), "leaky_relu")
            if i > 0:
                h = torch.cat([skips[i - 1], h], dim=1)
        flow = to_nhwc(self.level_scale * self.head()(h)) * self.flow_scale
        if self.bounded_flow > 0:
            flow = torch.tanh(flow) * self.bounded_flow
        return flow

    def forward(self, a: torch.Tensor, b: torch.Tensor, imgs: Sequence[torch.Tensor] = (),
                n_grad_imgs: int = -1):
        """(warped imgs, smoothness reg, {'flow', 'grid'}); images NCHW in and out."""
        flow = self.predict_flow(a, b)
        n, h, w, _ = flow.shape
        # grid coordinates are at least fp32 whatever the activations' type
        cdt = torch.float64 if flow.dtype == torch.float64 else torch.float32
        grid = identity_grid(h, w, self.align_corners, cdt, flow.device)[None] + flow.to(cdt)
        warped = ()
        if imgs:
            warped = grid_sample_multi([to_nhwc(i) for i in imgs], grid, "bilinear",
                                       self.padding_mode, self.align_corners, n_grad_imgs)
            warped = tuple(to_nchw(wp) for wp in warped)
        reg = smoothness_loss(flow, self.smooth_type, self.smooth_order)
        return warped, reg, {"flow": flow, "grid": grid}
