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
``_sample_plain_bwd`` backward. A CUDA tensor launches K-warp, which runs
the coordinate transform in the kernel, and K-warp-bwd at the pixel
coordinates (``ops/warp_cuda.py``). Backward, the coordinates are
recomputed in torch and d x, d y chain to d grid through torch autograd of
the transform, exactly where the JAX package leaves the transform outside
its kernel's custom VJP. 'nearest' is plain torch on the CPU and raises on
CUDA, where no path of the package uses it.

``grad_channels`` limits d img to the first channels, the rest get exact
zeros, as ``grid_sample_pallas(grad_channels=...)`` does: the model warps
(fake_B, real_A) in one call and only fake_B needs an image gradient.
"""

from __future__ import annotations

from typing import Sequence

import torch

from nemar_tpu_torch.ops import warp_cuda

# ---------------------------------------------------------------------------
# Coordinate transforms
# ---------------------------------------------------------------------------


def _unnormalize(coord: torch.Tensor, size: int, align_corners: bool) -> torch.Tensor:
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1.0)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _reflect(coord: torch.Tensor, twice_low: float, twice_high: float) -> torch.Tensor:
    """torch's reflect_coordinates: reflect into [twice_low/2, twice_high/2]."""
    if twice_low == twice_high:
        return torch.zeros_like(coord)
    mn = twice_low / 2.0
    span = (twice_high - twice_low) / 2.0
    x = torch.abs(coord - mn)
    extra = torch.remainder(x, 2.0 * span)
    return mn + torch.where(extra > span, 2.0 * span - extra, extra)


def _compute_source_coords(coord: torch.Tensor, size: int, align_corners: bool,
                           padding_mode: str) -> torch.Tensor:
    """Unnormalise and apply the padding-mode coordinate transform."""
    pix = _unnormalize(coord, size, align_corners)
    if padding_mode == "border":
        pix = torch.clamp(pix, 0.0, float(size - 1))
    elif padding_mode == "reflection":
        if align_corners:
            pix = _reflect(pix, 0.0, 2.0 * (size - 1))
        else:
            pix = _reflect(pix, -1.0, 2.0 * size - 1.0)
        pix = torch.clamp(pix, 0.0, float(size - 1))
    elif padding_mode != "zeros":
        raise ValueError(f"unknown padding_mode: {padding_mode!r}")
    return pix


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
        # round half to even, as torch's grid_sample (std::nearbyint)
        xi, yi = torch.round(x), torch.round(y)
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        vals = gather(xi.clamp(0, w - 1).long(), yi.clamp(0, h - 1).long())
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


def _sample_plain_bwd(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                      grad_channels: int) -> tuple:
    """Plain version of K-warp-bwd: (d img, d x, d y) of bilinear
    ``_sample_plain`` given g = d out (N, Ho, Wo, C).

    d img covers the first ``grad_channels`` channels (exact zeros for the
    rest; None when 0); the taps' values are zero out of frame, and floor()
    carries no gradient, as in the JAX package's gather.
    """
    n, h, w, c = img.shape
    gh, gw = x.shape[1], x.shape[2]
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
            contrib = gg * torch.where(valid, wgt, 0.0)[..., None]
            acc.scatter_add_(1, idx[:, :, None].expand(n, gh * gw, grad_channels), contrib)
        pad = torch.zeros((n, h * w, c - grad_channels), dtype=img.dtype, device=img.device)
        dimg = torch.cat([acc, pad], dim=-1).reshape(n, h, w, c)
    return dimg, dx.reshape(n, gh, gw), dy.reshape(n, gh, gw)


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
    def backward(ctx, g):
        img, grid = ctx.saved_tensors
        padding_mode, align_corners, gc = ctx.conf
        gc = gc if ctx.needs_input_grad[0] else 0
        with torch.enable_grad():
            gr = grid.detach().requires_grad_(ctx.needs_input_grad[1])
            x, y = _pixel_coords(img, gr, padding_mode, align_corners)
        if img.is_cuda:
            dimg, dx, dy = warp_cuda.warp_bilinear_bwd(
                img, x.detach().contiguous(), y.detach().contiguous(), g.contiguous(), gc)
        else:
            dimg, dx, dy = _sample_plain_bwd(img, x.detach(), y.detach(), g, gc)
        dgrid = torch.autograd.grad((x, y), gr, (dx, dy))[0] if ctx.needs_input_grad[1] else None
        return dimg, dgrid, None, None, None


def grid_sample(img: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear",
                padding_mode: str = "zeros", align_corners: bool = False,
                grad_channels: int = -1) -> torch.Tensor:
    """Sample ``img`` (N, H, W, C) at ``grid`` (N, Ho, Wo, 2) locations.

    CPU tensors take the plain gather; CUDA tensors the kernels K-warp and
    K-warp-bwd (bilinear only). ``grad_channels >= 0`` limits d img to the
    first channels (exact zeros for the rest); -1 means all.
    """
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
    if mode != "bilinear":
        if img.is_cuda:
            raise NotImplementedError(
                f"grid_sample mode {mode!r} has no CUDA kernel; the CUDA path samples bilinearly")
        return grid_sample_plain(img, grid, mode, padding_mode, align_corners)
    if grid.dtype != torch.float64:
        grid = grid.float()
    if img.is_cuda:
        img, grid = img.contiguous(), grid.contiguous()
    c = img.shape[-1]
    return _GridSample.apply(img, grid, padding_mode, align_corners,
                             c if grad_channels < 0 else min(grad_channels, c))


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
