"""Dense deformable STN R: a UNet over the (a, b) pair predicts a per-pixel
displacement field φ in normalised grid units; every image in ``imgs`` is
warped with identity + φ in ONE bilinear grid sample (K-warp on the card).

Counterpart of ``nemar_tpu/models/stn/unet_stn.py``:

  * encoder: ``depth`` x [conv k3 s2 p1, IN + leaky_relu(0.2)], widths
    min(ngf * 2^i, 8 ngf);
  * decoder: nearest x2 upsample, conv k3 p1, IN + leaky_relu, then concat
    [skip, h];
  * flow heads: conv k3 p1 to 2 channels, times ``level_scale``,
    zero-initialised (here and, after its init draws, by the model), so a
    fresh R warps by the identity. One head on the full-resolution feature;
    with ``multiscale`` also one on every decoder level's concatenated
    feature of at least ``head_min_res`` pixels a side. The per-level fields are resized bilinearly to full
    resolution (``resize_bilinear``) and composed coarse to fine, each
    level refining the warp so far (``compose_flows``: a border-padded grid
    sample of the 2-channel field, K-warp and K-warp-bwd on the card);
  * then ``flow_scale`` and the optional ``bounded_flow``: tanh(φ) * bound;
  * reg: the TV of the final field; under ``multiscale`` each head's TV at
    its own resolution, before scale and tanh, averaged over the heads.

Under ``--bf16`` (the model runs R on bf16 copies of its parameters) the
field, its compositions and the TV are bf16, as in the JAX package; the
grid the images are sampled at is fp32 (identity + the field cast up).

Under --mesh_spatial (``parallel/spatial.py``) ``forward`` takes a
``band``, this rank's rows of the frame: the UNet's convolutions run on the
band with their halo rows (``networks.conv_band``), its instance norms with
the frame's statistics, the nearest up-sampling locally; the grid is the
band's rows of the frame's identity plus φ's band; the warped images are
sampled from the whole frames (``spatial.gather_frame``: d img, a frame on
every rank, is summed over the group and cut to the band), the JAX
package's ``mm`` route under GSPMD computing the same function; the TV
takes one row of φ from below the band, two for order 2
(``smoothness_loss_band``). Each level computes on the band its geometry
gives (``Band.conv``, ``Band.up``), any of them uneven, one row or empty;
where a decoder level meets its skip, and the full-resolution field the
input's band, its rows are re-cut (``spatial.reband``). Under
``multiscale`` each head's field is on its level's band: its resize takes
the band's rows of the weights against the coarse field's gathered frame
(``resize_bilinear(rows=)``, still two matrix products), each composition
samples the field so far from its gathered frame (``compose_flows_band``),
and each level's TV is its band's share; the tanh bound is elementwise on
φ's band.

Convs are named ``Conv_<k>`` in the reference's creation order (the
multiscale heads between the decoder's convs), so the state_dict matches
the flax tree. ``--stn_head_impl fact`` and ``--stn_up_impl fused*`` are the
reference's exact rewrites of the same convolutions for the TPU's lane
width; here they are the direct convs.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from nemar_tpu_torch.models.networks import conv_band, norm_act, norm_act_band, to_nchw, to_nhwc
from nemar_tpu_torch.ops.warp import (compose_flows, grid_sample, grid_sample_multi,
                                      identity_grid)
from nemar_tpu_torch.parallel import spatial


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with gradient +1 at 0, as ``jax.grad(jnp.abs)``; torch.abs has 0.
    A fresh R's field is zero, so every difference of the TV below sits on
    that tie at R's first update."""
    return torch.where(x >= 0, x, -x)


def smoothness_loss(flow: torch.Tensor, smooth_type: str = "l1", order: int = 1) -> torch.Tensor:
    """Difference-based TV penalty on a (N, H, W, 2) field (order 1 or 2)."""
    dy = flow[:, 1:, :, :] - flow[:, :-1, :, :]
    dx = flow[:, :, 1:, :] - flow[:, :, :-1, :]
    if order == 2:
        dy = dy[:, 1:, :, :] - dy[:, :-1, :, :]
        dx = dx[:, :, 1:, :] - dx[:, :, :-1, :]
    if smooth_type == "l1":
        return _abs(dy).mean() + _abs(dx).mean()
    if smooth_type == "l2":
        return dy.square().mean() + dx.square().mean()
    raise NotImplementedError(f"smooth type {smooth_type!r}")


def smoothness_loss_band(flow: torch.Tensor, band, smooth_type: str = "l1",
                         order: int = 1) -> torch.Tensor:
    """This rank's share of ``smoothness_loss`` (order 1 or 2) of the frame
    of which the (N, H, W, 2) flow is its band: the differences that start
    in the band take the next ``order`` rows below it, from whichever ranks
    hold them (fewer near the frame's bottom, where the differences end),
    so each difference is counted once, a thin or empty band's too; each
    term is the band's sum over the frame's count."""
    n, h, w, c = flow.shape
    bottoms = tuple(min(order, band.height - b) for _, b in band.bounds)
    below = spatial.exchange_rows(flow, band, (0,) * band.size, bottoms, dim=1, mode="zeros")
    dy = below[:, 1:] - below[:, :-1]
    dx = flow[:, :, 1:] - flow[:, :, :-1]
    if order == 2:
        dy = dy[:, 1:] - dy[:, :-1]
        dx = dx[:, :, 1:] - dx[:, :, :-1]
    if smooth_type == "l1":
        fy, fx = _abs(dy), _abs(dx)
    elif smooth_type == "l2":
        fy, fx = dy.square(), dx.square()
    else:
        raise NotImplementedError(f"smooth type {smooth_type!r}")
    return (fy.sum() / (n * (band.height - order) * w * c)
            + fx.sum() / (n * band.height * (w - order) * c))


@functools.cache
def resize_weights(n_in: int, n_out: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(n_out, n_in) weights of ``jax.image.resize(..., 'bilinear')`` along
    one axis, computed in ``dtype`` as jax computes them in its float type
    (``compute_weight_mat``: a triangle kernel at half-pixel centres, each
    row normalised by its sum, so an edge sample takes the edge pixel whole;
    no anti-aliasing filter going up); for bf16, in fp32 and then rounded,
    as jax casts its fp32 weights to a bf16 field's type. Cached: callers
    must not write to it."""
    out_dtype, dtype = dtype, (torch.float32 if dtype == torch.bfloat16 else dtype)
    inv_scale = torch.tensor(1.0 / (n_out / n_in), dtype=dtype)
    sample = (torch.arange(n_out, dtype=dtype) + 0.5) * inv_scale - 0.5
    dist = (sample[:, None] - torch.arange(n_in, dtype=dtype)[None, :]).abs()
    w = torch.clamp_min(1.0 - dist, 0.0)
    total = w.sum(dim=1, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[:, None], w, 0.0).to(device=device, dtype=out_dtype)


def resize_bilinear(f: torch.Tensor, height: int, width: int, rows: slice | None = None
                    ) -> torch.Tensor:
    """``jax.image.resize(f, (n, height, width, c), 'bilinear')`` of an NHWC
    field, as jax computes it: one weight matrix per axis, contracted with
    the field (an axis of unchanged size is left as it is). Two matrix
    products, so the backward is the transposed contraction, again two
    products, with no scatter: F.interpolate's bilinear backward adds with
    float atomics on CUDA and would make two training runs differ.
    ``rows``: only those output rows (a band's, --mesh_spatial), the same
    products with the H weights' rows cut to them."""
    n, h, w, c = f.shape
    if h != height:
        # (height, h) @ (h, n w c)
        wh = resize_weights(h, height, f.dtype, f.device)
        if rows is not None:
            wh = wh[rows]
        f = wh @ f.permute(1, 0, 2, 3).reshape(h, n * w * c)
        f = f.reshape(wh.shape[0], n, w, c).permute(1, 0, 2, 3)
    if w != width:
        # (width, w) @ (w, n height c)
        ho = f.shape[1]
        g = f.permute(2, 0, 1, 3).reshape(w, n * ho * c)
        f = (resize_weights(w, width, f.dtype, f.device) @ g).reshape(width, n, ho, c)
        f = f.permute(1, 2, 0, 3)
    return f


def compose_flows_band(flow_outer: torch.Tensor, flow_inner: torch.Tensor, band,
                       align_corners: bool = False) -> torch.Tensor:
    """``compose_flows`` of the frames of which both (N, H_band, W, 2) fields
    are this rank's band: the inner field's frame gathered and sampled at
    the band's rows of identity + outer (its adjoint sums the ranks'
    gradients of the frame in rank order)."""
    _, h, w, _ = flow_outer.shape
    ident = identity_grid(band.height, w, align_corners, flow_outer.dtype, flow_outer.device)
    grid = ident[band.r0:band.r1][None] + flow_outer
    inner_at = grid_sample(spatial.gather_frame(flow_inner, band, dim=1), grid, "bilinear",
                           "border", align_corners)
    return flow_outer + inner_at


class UnetSTN(nn.Module):
    def __init__(self, in_channels: int = 6, ngf: int = 32, depth: int = 5,
                 flow_scale: float = 1.0, smooth_type: str = "l1", smooth_order: int = 1,
                 padding_mode: str = "zeros", align_corners: bool = False,
                 bounded_flow: float = 0.0, multiscale: bool = False, level_scale: float = 1.0,
                 head_min_res: int = 0, size: int | None = None):
        """``size``: the input's side, which decides the heads' levels under
        ``multiscale`` with ``head_min_res`` > 0 (the feature of decoder
        level i is size / 2^i a side)."""
        super().__init__()
        if multiscale and head_min_res > 0 and size is None:
            raise ValueError("--stn_head_min_res needs the input size to place the heads")
        self.depth = depth
        self.flow_scale = flow_scale
        self.smooth_type = smooth_type
        self.smooth_order = smooth_order
        self.padding_mode = padding_mode
        self.align_corners = align_corners
        self.bounded_flow = bounded_flow
        self.multiscale = multiscale
        self.level_scale = level_scale
        self.head_min_res = head_min_res
        chans = [min(ngf * 2**i, ngf * 8) for i in range(depth)]
        convs = []
        # decoder level -> index of its head conv (level 0: full resolution)
        self.head_index = {}
        cin = in_channels
        for ch in chans:  # encoder
            convs.append(nn.Conv2d(cin, ch, 3, stride=2, padding=1))
            cin = ch
        for i in reversed(range(depth)):  # decoder
            out_ch = chans[i - 1] if i > 0 else ngf
            convs.append(nn.Conv2d(cin, out_ch, 3, padding=1))
            cin = out_ch + (chans[i - 1] if i > 0 else 0)
            if i > 0 and multiscale and (head_min_res <= 0 or size // 2**i >= head_min_res):
                self.head_index[i] = len(convs)
                convs.append(nn.Conv2d(cin, 2, 3, padding=1))
        self.head_index[0] = len(convs)
        convs.append(nn.Conv2d(cin, 2, 3, padding=1))
        for k, conv in enumerate(convs):
            setattr(self, f"Conv_{k}", conv)
        self.n_convs = len(convs)
        for head in self.heads():
            nn.init.zeros_(head.weight)
            nn.init.zeros_(head.bias)

    def heads(self) -> list:
        """The flow heads, coarse to fine (the full-resolution one last)."""
        return [getattr(self, f"Conv_{k}") for k in self.head_index.values()]

    def _field(self, level: int, h: torch.Tensor) -> torch.Tensor:
        """A head's field, NHWC, damped by ``level_scale``."""
        return to_nhwc(self.level_scale * getattr(self, f"Conv_{self.head_index[level]}")(h))

    def predict_flow(self, a: torch.Tensor, b: torch.Tensor) -> tuple:
        """((N, H, W, 2) field in normalised grid units, level-wise TV)
        from NCHW a and b; the TV is None without ``multiscale``."""
        hh, ww = a.shape[2], a.shape[3]
        h = torch.cat([a, b], dim=1)
        skips = []
        for k in range(self.depth):
            h = norm_act(getattr(self, f"Conv_{k}")(h), "leaky_relu")
            skips.append(h)
        flows = []
        for j, i in enumerate(reversed(range(self.depth))):
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            h = norm_act(getattr(self, f"Conv_{self.depth + j + len(flows)}")(h), "leaky_relu")
            if i > 0:
                h = torch.cat([skips[i - 1], h], dim=1)
                wanted = self.multiscale and h.shape[2] >= self.head_min_res
                if wanted != (i in self.head_index):
                    raise ValueError(f"R was built with heads at levels {sorted(self.head_index)}"
                                     f" for another input size than {hh}x{ww}")
                if wanted:
                    flows.append(self._field(i, h))
        flows.append(self._field(0, h))
        level_reg = None
        flow = flows[0] if flows[0].shape[1] == hh else resize_bilinear(flows[0], hh, ww)
        if self.multiscale:
            level_reg = smoothness_loss(flows[0], self.smooth_type, self.smooth_order)
        for f in flows[1:]:
            level_reg = level_reg + smoothness_loss(f, self.smooth_type, self.smooth_order)
            f_full = f if f.shape[1] == hh else resize_bilinear(f, hh, ww)
            # the warp so far applied first (inner), this level refines (outer)
            flow = compose_flows(f_full, flow, self.align_corners)
        if level_reg is not None:
            level_reg = level_reg / len(flows)
        flow = flow * self.flow_scale
        if self.bounded_flow > 0:
            flow = torch.tanh(flow) * self.bounded_flow
        return flow, level_reg

    def predict_flow_band(self, a: torch.Tensor, b: torch.Tensor, band) -> tuple:
        """``predict_flow`` of the frame of which a and b are this rank's
        band: (φ's band (N, H_band, W, 2), the level-wise TV's share or
        None)."""
        hh, ww = band.height, a.shape[3]
        h, bd = torch.cat([a, b], dim=1), band
        skips = []
        for k in range(self.depth):
            h, bd = conv_band(getattr(self, f"Conv_{k}"), h, bd)
            h = norm_act_band(h, bd, "leaky_relu")
            skips.append((h, bd))
        flows = []  # (a head's field on its level's band, that band), coarse to fine
        for j, i in enumerate(reversed(range(self.depth))):
            h, bd = spatial.up2(h), bd.up(2)
            h, bd = conv_band(getattr(self, f"Conv_{self.depth + j + len(flows)}"), h, bd)
            h = norm_act_band(h, bd, "leaky_relu")
            if i > 0:
                # the up-sampled level's band re-cut to its skip's (the
                # levels split unevenly: 7 rows over 2 ranks, 4 | 3, come
                # back as 8 | 6 against a skip of 7 | 7)
                skip, sb = skips[i - 1]
                h, bd = spatial.reband(h, bd, sb), sb
                h = torch.cat([skip, h], dim=1)
                wanted = self.multiscale and bd.height >= self.head_min_res
                if wanted != (i in self.head_index):
                    raise ValueError(f"R was built with heads at levels {sorted(self.head_index)}"
                                     f" for another input size than {hh}x{ww}")
                if wanted:
                    flows.append((self._field_band(i, h, bd), bd))
        flows.append((self._field_band(0, h, bd), bd))

        def full(f, fb):  # a field at the output's resolution, this rank's rows
            if fb.height == hh:
                return spatial.reband(f, fb, band, dim=1)
            return resize_bilinear(spatial.gather_frame(f, fb, dim=1), hh, ww,
                                   slice(band.r0, band.r1))

        level_reg = None
        flow = full(*flows[0])
        if self.multiscale:
            level_reg = smoothness_loss_band(flows[0][0], flows[0][1], self.smooth_type,
                                             self.smooth_order)
        for f, fb in flows[1:]:
            level_reg = level_reg + smoothness_loss_band(f, fb, self.smooth_type,
                                                         self.smooth_order)
            # the warp so far applied first (inner), this level refines (outer)
            flow = compose_flows_band(full(f, fb), flow, band, self.align_corners)
        if level_reg is not None:
            level_reg = level_reg / len(flows)
        flow = flow * self.flow_scale
        if self.bounded_flow > 0:
            flow = torch.tanh(flow) * self.bounded_flow
        return flow, level_reg

    def _field_band(self, level: int, h: torch.Tensor, band) -> torch.Tensor:
        """``_field`` of the frame of which h is this rank's band."""
        head = getattr(self, f"Conv_{self.head_index[level]}")
        return to_nhwc(self.level_scale * conv_band(head, h, band)[0])

    def forward(self, a: torch.Tensor, b: torch.Tensor, imgs: Sequence[torch.Tensor] = (),
                n_grad_imgs: int = -1, band=None):
        """(warped imgs, smoothness reg, {'flow', 'grid'}); images NCHW in and out.
        With ``band`` (``spatial.Band``) a, b and every output are this
        rank's band of the frame, the reg its share."""
        if band is not None:
            return self._forward_band(a, b, imgs, n_grad_imgs, band)
        flow, level_reg = self.predict_flow(a, b)
        n, h, w, _ = flow.shape
        # grid coordinates are at least fp32 whatever the activations' type
        cdt = torch.float64 if flow.dtype == torch.float64 else torch.float32
        grid = identity_grid(h, w, self.align_corners, cdt, flow.device)[None] + flow.to(cdt)
        warped = ()
        if imgs:
            warped = grid_sample_multi([to_nhwc(i) for i in imgs], grid, "bilinear",
                                       self.padding_mode, self.align_corners, n_grad_imgs)
            warped = tuple(to_nchw(wp) for wp in warped)
        reg = (level_reg if self.multiscale
               else smoothness_loss(flow, self.smooth_type, self.smooth_order))
        return warped, reg, {"flow": flow, "grid": grid}

    def _forward_band(self, a, b, imgs, n_grad_imgs: int, band):
        flow, level_reg = self.predict_flow_band(a, b, band)
        n, h, w, _ = flow.shape
        cdt = torch.float64 if flow.dtype == torch.float64 else torch.float32
        ident = identity_grid(band.height, w, self.align_corners, cdt, flow.device)
        grid = ident[band.r0:band.r1][None] + flow.to(cdt)
        warped = ()
        if imgs:
            frames = [spatial.gather_frame(to_nhwc(i), band, dim=1) for i in imgs]
            warped = grid_sample_multi(frames, grid, "bilinear", self.padding_mode,
                                       self.align_corners, n_grad_imgs)
            warped = tuple(to_nchw(wp) for wp in warped)
        reg = (level_reg if self.multiscale
               else smoothness_loss_band(flow, band, self.smooth_type, self.smooth_order))
        return warped, reg, {"flow": flow, "grid": grid}
