"""Spatial-transformer warp core: identity/affine grids, grid_sample, flows.

Counterpart of ``nemar_tpu/ops/warp.py``, with the same semantics (those of
``torch.nn.functional.grid_sample``) and the same NHWC layout at the public
functions, so the two packages are compared like with like:

  * grid (N, Ho, Wo, 2), last dim (x, y) normalised to [-1, 1];
  * ``align_corners=False``: pix = ((g + 1) * size - 1) / 2,
    ``align_corners=True``: pix = (g + 1) / 2 * (size - 1);
  * padding modes 'zeros', 'border', 'reflection'; modes 'bilinear',
    'nearest'.

Bilinear sampling is one ``torch.autograd.Function`` from the grid to the
output (``_GridSample``) that dispatches on the image's device. A CPU
tensor takes the plain path: the coordinate transform (unnormalise +
padding mode, ``_compute_source_coords``) in torch, then ``_sample_plain``
(a gather that mirrors the JAX package's ``_grid_sample_xla``), and
``_grid_sample_plain_bwd`` backward, from g to (d img, d grid). A CUDA
tensor launches K-warp and K-warp-bwd (``ops/warp_cuda.py``), each from the
normalised grid, with the coordinate transform and its derivative in the
kernel. 'nearest' is ``_GridSampleNearest`` on either device: the JAX
package computes it in plain XLA, a rounded gather (ties to even), not in
a Pallas kernel, so its counterpart here is the plain gather, with a
deterministic VJP (d img summed by a sorted ``index_put_``, the same bits
in every call on the card; d grid zero, as JAX's gradient of the
rounding).

The grid gradient follows the JAX package where a coordinate sits exactly
on a limit of the padding mode's clip (the identity grid's edge pixels):
half the gradient passes, as ``jax.grad`` of ``jnp.clip`` gives, and the
reflection's abs has slope +1 at 0. It differs there from
``F.grid_sample``'s backward, which passes none at the border.

``grad_channels`` limits d img to the first channels, the rest get exact
zeros, as ``grid_sample_pallas(grad_channels=...)`` does: the model warps
(fake_B, real_A) in one call and only fake_B needs an image gradient.

A bfloat16 image (``--bf16``) is sampled through an fp32 copy, on the card
and on the CPU alike: the image cast up, the output cast down, and in the
backward g up and d img down (``ops/cast.py``, counted on
``grid_sample.casts``); the grid is fp32 whatever the image's type, and so
is d grid. K-warp's bf16 variant is queued as ROADMAP.md A7b.
"""

from __future__ import annotations

from typing import Sequence

import torch

from nemar_tpu_torch.ops import warp_cuda
from nemar_tpu_torch.ops.cast import to_dtype

# ---------------------------------------------------------------------------
# Coordinate transforms
# ---------------------------------------------------------------------------


def _unnormalize(coord: torch.Tensor, size: int, align_corners: bool) -> torch.Tensor:
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1.0)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _clip(pix: torch.Tensor, size: int) -> torch.Tensor:
    """Clip to [0, size - 1] as ``jnp.clip`` (a max, then a min): autograd
    gives half the gradient where pix equals a limit (a quarter when both
    limits are 0), as ``jax.grad`` does; ``torch.clamp`` would give all of it."""
    lo = torch.zeros((), dtype=pix.dtype, device=pix.device)
    return torch.minimum(torch.maximum(pix, lo), lo + (size - 1))


def _reflect(coord: torch.Tensor, twice_low: float, twice_high: float) -> torch.Tensor:
    """torch's reflect_coordinates: reflect into [twice_low/2, twice_high/2].
    The abs has gradient +1 at 0, as ``jax.grad(jnp.abs)``; torch.abs has 0."""
    if twice_low == twice_high:
        return torch.zeros_like(coord)
    mn = twice_low / 2.0
    span = (twice_high - twice_low) / 2.0
    d = coord - mn
    x = torch.where(d >= 0, d, -d)
    extra = torch.remainder(x, 2.0 * span)
    return mn + torch.where(extra > span, 2.0 * span - extra, extra)


def _compute_source_coords(coord: torch.Tensor, size: int, align_corners: bool,
                           padding_mode: str) -> torch.Tensor:
    """Unnormalise and apply the padding-mode coordinate transform.

    Its gradient takes the JAX package's conventions where a coordinate sits
    on a tie (``_clip``, ``_reflect``): the identity grid maps exactly onto
    pixels 0 and size - 1, where ``border`` and ``reflection`` pass half
    the gradient. ``F.grid_sample``'s backward passes none there."""
    pix = _unnormalize(coord, size, align_corners)
    if padding_mode == "border":
        pix = _clip(pix, size)
    elif padding_mode == "reflection":
        if align_corners:
            pix = _reflect(pix, 0.0, 2.0 * (size - 1))
        else:
            pix = _reflect(pix, -1.0, 2.0 * size - 1.0)
        pix = _clip(pix, size)
    elif padding_mode != "zeros":
        raise ValueError(f"unknown padding_mode: {padding_mode!r}")
    return pix


def _clip_slope(pix: torch.Tensor, size: int) -> torch.Tensor:
    """d _clip(pix) / d pix, written out: max's factor (1 above 0, 1/2 at 0,
    0 below) times min's on max's result (1 below size - 1, 1/2 at it)."""
    hi = float(size - 1)
    up = torch.where(pix > 0, 1.0, torch.where(pix == 0, 0.5, 0.0))
    m = torch.clamp_min(pix, 0.0)
    return up * torch.where(m < hi, 1.0, torch.where(m == hi, 0.5, 0.0))


def _source_coords_and_slope(coord: torch.Tensor, size: int, align_corners: bool,
                             padding_mode: str) -> tuple:
    """(``_compute_source_coords(coord)``, its derivative in coord), written
    out with the same tie conventions, as K-warp-bwd computes them."""
    pix = _unnormalize(coord, size, align_corners)
    slope = torch.full_like(pix, 0.5 * (size - 1) if align_corners else 0.5 * size)
    if padding_mode == "reflection":
        if align_corners and size == 1:
            return torch.zeros_like(pix), torch.zeros_like(pix)
        mn, span = (0.0, size - 1.0) if align_corners else (-0.5, float(size))
        d = pix - mn
        extra = torch.remainder(torch.where(d >= 0, d, -d), 2.0 * span)
        flip = extra > span
        pix = mn + torch.where(flip, 2.0 * span - extra, extra)
        slope = slope * torch.where(d >= 0, 1.0, -1.0) * torch.where(flip, -1.0, 1.0)
    if padding_mode in ("border", "reflection"):
        slope = slope * _clip_slope(pix, size)
        pix = torch.clamp(pix, 0.0, float(size - 1))
    elif padding_mode != "zeros":
        raise ValueError(f"unknown padding_mode: {padding_mode!r}")
    return pix, slope


# ---------------------------------------------------------------------------
# Grid construction
# ---------------------------------------------------------------------------


def _base_coords_1d(size: int, align_corners: bool, dtype, device) -> torch.Tensor:
    """Normalised sample centres along one axis (torch affine_grid base)."""
    if size == 1:
        return torch.full((1,), -1.0 if align_corners else 0.0, dtype=dtype, device=device)
    if align_corners:
        return torch.linspace(-1.0, 1.0, size, dtype=dtype, device=device)
    i = torch.arange(size, dtype=dtype, device=device)
    return (2.0 * i + 1.0) / size - 1.0


def identity_grid(height: int, width: int, align_corners: bool = False,
                  dtype=torch.float32, device=None) -> torch.Tensor:
    """(H, W, 2) identity sampling grid, last dim (x, y) normalised."""
    xs = _base_coords_1d(width, align_corners, dtype, device)
    ys = _base_coords_1d(height, align_corners, dtype, device)
    gx = xs[None, :].expand(height, width)
    gy = ys[:, None].expand(height, width)
    return torch.stack([gx, gy], dim=-1)


def affine_grid(theta: torch.Tensor, size: Sequence[int],
                align_corners: bool = False) -> torch.Tensor:
    """``torch.nn.functional.affine_grid`` equivalent, NHWC grid out.

    theta (N, 2, 3); size (N, C, H, W), (N, H, W) or (H, W).
    """
    if theta.dim() != 3 or tuple(theta.shape[-2:]) != (2, 3):
        raise ValueError(f"theta must be (N, 2, 3), got {tuple(theta.shape)}")
    if isinstance(size, int) or not hasattr(size, "__len__") or len(size) not in (2, 3, 4):
        raise ValueError(f"size must be (N, C, H, W), (N, H, W) or (H, W); got {size!r}")
    h, w = size[-2], size[-1]
    base = identity_grid(h, w, align_corners, theta.dtype, theta.device)
    x = base[..., 0][None, :, :, None]
    y = base[..., 1][None, :, :, None]
    t = theta[:, None, None, :, :]
    # explicit broadcast arithmetic, as the reference: no matmul precision
    # mode can touch grid coordinates
    return t[..., 0] * x + t[..., 1] * y + t[..., 2]


# ---------------------------------------------------------------------------
# grid_sample
# ---------------------------------------------------------------------------


def _sample_plain(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                  mode: str) -> torch.Tensor:
    """Gather-based sampling at pixel coords (mirror of ``_grid_sample_xla``).

    img (N, H, W, C); x, y (N, Ho, Wo) -> (N, Ho, Wo, C).
    """
    n, h, w, c = img.shape
    gh, gw = x.shape[1], x.shape[2]
    x = x.reshape(n, gh * gw)
    y = y.reshape(n, gh * gw)
    flat = img.reshape(n, h * w, c)

    def gather(ix, iy):
        idx = (iy * w + ix)[:, :, None].expand(n, gh * gw, c)
        return torch.gather(flat, 1, idx)

    if mode == "nearest":
        idx, valid = _nearest_taps(h, w, x, y)
        vals = torch.gather(flat, 1, idx[:, :, None].expand(n, gh * gw, c))
        zero = torch.zeros((), dtype=img.dtype, device=img.device)
        return torch.where(valid[..., None], vals, zero).reshape(n, gh, gw, c)
    if mode != "bilinear":
        raise ValueError(f"unknown mode: {mode!r}")

    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    out = torch.zeros((n, gh * gw, c), dtype=img.dtype, device=img.device)
    for dy, dx, wgt in (
        (0, 0, (1.0 - wx) * (1.0 - wy)),
        (0, 1, wx * (1.0 - wy)),
        (1, 0, (1.0 - wx) * wy),
        (1, 1, wx * wy),
    ):
        cx, cy = x0 + dx, y0 + dy
        valid = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
        vals = gather(cx.clamp(0, w - 1).long(), cy.clamp(0, h - 1).long())
        zero = torch.zeros((), dtype=img.dtype, device=img.device)
        out = out + torch.where(valid[..., None], vals, zero) * wgt[..., None].to(img.dtype)
    return out.reshape(n, gh, gw, c)


def _grid_sample_plain_bwd(img: torch.Tensor, grid: torch.Tensor, g: torch.Tensor,
                           padding_mode: str, align_corners: bool, grad_channels: int) -> tuple:
    """Plain version of K-warp-bwd: (d img, d grid) of bilinear sampling of
    img (N, H, W, C) at grid (N, Ho, Wo, 2), given g = d out (N, Ho, Wo, C),
    written out (no autograd).

    d img covers the first ``grad_channels`` channels (exact zeros for the
    rest; None when 0); the taps' values are zero out of frame, and floor()
    carries no gradient, as in the JAX package's gather. d grid is d x, d y
    at the pixel coordinates times the coordinate transform's slope, with the
    JAX package's conventions at ties (``_source_coords_and_slope``).
    """
    if grid.dtype != torch.float64:
        grid = grid.float()
    n, h, w, c = img.shape
    gh, gw = grid.shape[1], grid.shape[2]
    x, sx = _source_coords_and_slope(grid[..., 0], w, align_corners, padding_mode)
    y, sy = _source_coords_and_slope(grid[..., 1], h, align_corners, padding_mode)
    x = x.reshape(n, gh * gw)
    y = y.reshape(n, gh * gw)
    g = g.reshape(n, gh * gw, c)
    flat = img.reshape(n, h * w, c)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    taps = []
    for dy, dx, wgt in (
        (0, 0, (1.0 - wx) * (1.0 - wy)),
        (0, 1, wx * (1.0 - wy)),
        (1, 0, (1.0 - wx) * wy),
        (1, 1, wx * wy),
    ):
        cx, cy = x0 + dx, y0 + dy
        valid = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
        idx = cy.clamp(0, h - 1).long() * w + cx.clamp(0, w - 1).long()
        vals = torch.gather(flat, 1, idx[:, :, None].expand(n, gh * gw, c))
        taps.append((torch.where(valid[..., None], vals, 0.0), valid, idx, wgt))
    (v00, *_), (v01, *_), (v10, *_), (v11, *_) = taps
    dx = (g * ((v01 - v00) * (1.0 - wy)[..., None] + (v11 - v10) * wy[..., None])).sum(-1)
    dy = (g * ((v10 - v00) * (1.0 - wx)[..., None] + (v11 - v01) * wx[..., None])).sum(-1)
    dimg = None
    if grad_channels:
        acc = torch.zeros((n, h * w, grad_channels), dtype=img.dtype, device=img.device)
        gg = g[..., :grad_channels]
        for _, valid, idx, wgt in taps:
            # out of frame, nothing (not g * 0, which is NaN for g = inf)
            contrib = torch.where(valid[..., None], gg * wgt[..., None], 0.0)
            acc.scatter_add_(1, idx[:, :, None].expand(n, gh * gw, grad_channels), contrib)
        pad = torch.zeros((n, h * w, c - grad_channels), dtype=img.dtype, device=img.device)
        dimg = torch.cat([acc, pad], dim=-1).reshape(n, h, w, c)
    dgrid = torch.stack([dx.reshape(n, gh, gw) * sx, dy.reshape(n, gh, gw) * sy], dim=-1)
    return dimg, dgrid.to(grid.dtype)


def _check(img: torch.Tensor, grid: torch.Tensor) -> None:
    if img.dim() != 4 or grid.dim() != 4 or grid.shape[-1] != 2 or grid.shape[0] != img.shape[0]:
        raise ValueError(f"bad grid shape {tuple(grid.shape)} for image {tuple(img.shape)}")


def _pixel_coords(img, grid, padding_mode, align_corners):
    # sampling coordinates never round through a type narrower than float32
    # (1 px of error at the far edge of a 256-wide image in bf16); values may
    if grid.dtype != torch.float64:
        grid = grid.float()
    _, h, w, _ = img.shape
    x = _compute_source_coords(grid[..., 0], w, align_corners, padding_mode)
    y = _compute_source_coords(grid[..., 1], h, align_corners, padding_mode)
    return x, y


def grid_sample_plain(img: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear",
                      padding_mode: str = "zeros", align_corners: bool = False) -> torch.Tensor:
    """Plain PyTorch ``grid_sample`` on any device: img (N, H, W, C) NHWC."""
    _check(img, grid)
    x, y = _pixel_coords(img, grid, padding_mode, align_corners)
    return _sample_plain(img, x, y, mode)


def _nearest_taps(h: int, w: int, x: torch.Tensor, y: torch.Tensor) -> tuple:
    """(idx, valid), each (N, Ho*Wo): the flat source pixel of each output
    of nearest sampling at pixel coords x, y (N, ...) in an h x w frame
    (clipped into it) and whether it lies in the frame, as the JAX
    package's ``_grid_sample_xla`` computes them."""
    n = x.shape[0]
    # round half to even, as torch's grid_sample (std::nearbyint) and jnp.round
    xi, yi = torch.round(x).reshape(n, -1), torch.round(y).reshape(n, -1)
    valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    return yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long(), valid


class _GridSampleNearest(torch.autograd.Function):
    """Nearest sampling of img (N, H, W, C) at a normalised grid, on any
    device, differentiable in img (first ``grad_channels`` channels); d
    grid is zero. d img adds each output's g into its source pixel with
    ``index_put_(accumulate=True)``, which sorts the indices and sums each
    pixel's terms in that order (on CUDA too): no float atomics."""

    @staticmethod
    def forward(ctx, img, grid, padding_mode, align_corners, grad_channels):
        n, h, w, c = img.shape
        x, y = _pixel_coords(img, grid, padding_mode, align_corners)
        ctx.save_for_backward(*_nearest_taps(h, w, x, y))
        ctx.conf = (img.shape, grad_channels, grid.shape, grid.dtype)
        return _sample_plain(img, x, y, "nearest")

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        idx, valid = ctx.saved_tensors
        (n, h, w, c), gc, grid_shape, grid_dtype = ctx.conf
        dimg = dgrid = None
        if ctx.needs_input_grad[0]:
            g = g.reshape(n, -1, c)[..., :gc]
            # out of frame, nothing (not g * 0, which is NaN for g = inf)
            contrib = torch.where(valid[..., None], g, torch.zeros((), dtype=g.dtype,
                                                                   device=g.device))
            base = torch.arange(n, device=idx.device)[:, None] * (h * w)
            acc = torch.zeros((n * h * w, gc), dtype=g.dtype, device=g.device)
            acc.index_put_(((base + idx).reshape(-1),), contrib.reshape(-1, gc), accumulate=True)
            pad = torch.zeros((n * h * w, c - gc), dtype=g.dtype, device=g.device)
            dimg = torch.cat([acc, pad], dim=1).reshape(n, h, w, c)
        if ctx.needs_input_grad[1]:
            dgrid = torch.zeros(grid_shape, dtype=grid_dtype, device=idx.device)
        return dimg, dgrid, None, None, None


class _GridSample(torch.autograd.Function):
    """Bilinear zeros-padded sampling of img at a normalised grid (after the
    padding mode's coordinate transform), differentiable in img (first
    ``grad_channels`` channels) and the grid: the plain versions on the
    CPU, K-warp / K-warp-bwd on CUDA."""

    @staticmethod
    def forward(ctx, img, grid, padding_mode, align_corners, grad_channels):
        ctx.conf = (padding_mode, align_corners, grad_channels)
        ctx.save_for_backward(img, grid)
        if img.is_cuda:
            return warp_cuda.warp_bilinear(img, grid, padding_mode, align_corners)
        x, y = _pixel_coords(img, grid, padding_mode, align_corners)
        return _sample_plain(img, x, y, "bilinear")

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        img, grid = ctx.saved_tensors
        padding_mode, align_corners, gc = ctx.conf
        gc = gc if ctx.needs_input_grad[0] else 0
        if img.is_cuda:
            dimg, dgrid = warp_cuda.warp_grid_bwd(img, grid, g.contiguous(), padding_mode,
                                                  align_corners, gc)
        else:
            dimg, dgrid = _grid_sample_plain_bwd(img, grid, g, padding_mode, align_corners, gc)
        return dimg, dgrid if ctx.needs_input_grad[1] else None, None, None, None


def grid_sample(img: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear",
                padding_mode: str = "zeros", align_corners: bool = False,
                grad_channels: int = -1) -> torch.Tensor:
    """Sample ``img`` (N, H, W, C) at ``grid`` (N, Ho, Wo, 2) locations.

    Bilinear: CPU tensors take the plain gather; CUDA tensors the kernels
    K-warp and K-warp-bwd. Nearest: the plain gather on either device. ``grad_channels >= 0`` limits d img to the
    first channels (exact zeros for the rest); -1 means all. A bf16 image is
    sampled through an fp32 copy and the output cast back to bf16, each
    cast counted on ``grid_sample.casts``.
    """
    if img.dtype == torch.bfloat16:
        out = grid_sample(to_dtype(img, torch.float32, grid_sample), grid, mode, padding_mode,
                          align_corners, grad_channels)
        return to_dtype(out, torch.bfloat16, grid_sample)
    if (img.is_cuda and not (img.requires_grad or grid.requires_grad) and mode == "bilinear"
            and grid.dtype == torch.float32):
        # nothing to differentiate: the kernel's operator alone, which checks
        # what it takes; through _GridSample the b1 call costs 0.05 ms of host
        # time instead of 0.03, F.grid_sample's (PERF.md, section 6)
        return warp_cuda.warp_bilinear(img, grid, padding_mode, align_corners)
    _check(img, grid)
    if padding_mode not in warp_cuda.PADDING_MODES:
        raise ValueError(f"unknown padding_mode: {padding_mode!r}")
    if not img.is_cuda and img.device.type != "cpu":
        raise ValueError(f"grid_sample: unsupported device {img.device}")
    c = img.shape[-1]
    gc = c if grad_channels < 0 else min(grad_channels, c)
    if mode == "nearest":
        return _GridSampleNearest.apply(img, grid, padding_mode, align_corners, gc)
    if mode != "bilinear":
        raise ValueError(f"unknown mode: {mode!r}")
    if grid.dtype != torch.float64:
        grid = grid.float()
    if img.is_cuda:
        img, grid = img.contiguous(), grid.contiguous()
    return _GridSample.apply(img, grid, padding_mode, align_corners, gc)


grid_sample.casts = 0


# ---------------------------------------------------------------------------
# Displacement-field (flow) helpers
# ---------------------------------------------------------------------------


def grid_sample_multi(imgs: Sequence[torch.Tensor], grid: torch.Tensor, mode: str = "bilinear",
                      padding_mode: str = "zeros", align_corners: bool = False,
                      n_grad_imgs: int = -1) -> tuple:
    """Sample several NHWC images at the SAME grid in one call.

    Concatenates along channels, samples once, splits back. With
    ``n_grad_imgs >= 0`` only the first n images carry a gradient (the rest
    are detached), as in the reference, and the sampling computes d img for
    their channels only (a detach alone would not stop the one sampling
    call from computing d img for the whole concatenation).
    """
    if 0 <= n_grad_imgs < len(imgs):
        imgs = tuple(imgs[:n_grad_imgs]) + tuple(i.detach() for i in imgs[n_grad_imgs:])
    sizes = [i.shape[-1] for i in imgs]
    gc = sum(sizes[:n_grad_imgs]) if n_grad_imgs >= 0 else -1
    if len(imgs) == 1:
        return (grid_sample(imgs[0], grid, mode, padding_mode, align_corners, gc),)
    cat = torch.cat([i.to(imgs[0].dtype) for i in imgs], dim=-1)
    out = grid_sample(cat, grid, mode, padding_mode, align_corners, gc)
    return tuple(torch.split(out, sizes, dim=-1))


def warp_with_flow(img: torch.Tensor, flow: torch.Tensor, align_corners: bool = False,
                   padding_mode: str = "border") -> torch.Tensor:
    """Warp ``img`` by a dense displacement field ``flow`` (N, H, W, 2) in
    normalised grid units, added to the identity grid."""
    _, h, w, _ = flow.shape
    grid = identity_grid(h, w, align_corners, flow.dtype, flow.device)[None] + flow
    return grid_sample(img, grid, "bilinear", padding_mode, align_corners)


def compose_flows(flow_outer: torch.Tensor, flow_inner: torch.Tensor,
                  align_corners: bool = False) -> torch.Tensor:
    """outer ∘ inner: result(p) = inner(p + outer(p)) + outer(p)."""
    _, h, w, _ = flow_outer.shape
    grid = identity_grid(h, w, align_corners, flow_outer.dtype, flow_outer.device)[None] + flow_outer
    inner_at = grid_sample(flow_inner, grid, "bilinear", "border", align_corners)
    return flow_outer + inner_at
