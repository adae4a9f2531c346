"""The image height in bands over a spatial group (``--mesh_spatial``): the
counterpart of the JAX package's 'spatial' mesh axis
(``nemar_tpu/parallel/mesh.py``: ``batch_sharding(spatial_dim=1)``), where
GSPMD splits H over the axis and inserts the halo exchanges. Here the
exchanges are written out, so a rank holds only its band of each
activation and the step computes the whole frame's function.

Band geometry. A ``Band`` is this rank's rows [r0, r1) of a frame of
``height`` rows, with every rank's bounds. The input height splits evenly
(``Band.split``: s divides H). A convolution's output row i belongs to the
rank that holds its input row ``stride * i`` (``Band.conv``), so an evenly
split input of a stride-2 layer gives an evenly split output when its
band is even, and the stride-1 k4 p1 layers of D, which take 32 rows to 31
and 30 at 256^2, give bands of 16 and 15, then 16 and 14. Up-sampling by 2
doubles every band (``Band.up``). ``Band.conv`` also returns the rows each
rank's output band needs beyond its input band: ``top`` above, ``bottom``
below (negative: rows of the band it does not read).

Primitives, each a ``torch.autograd.Function`` whose backward is the
adjoint, every sum in a fixed order, so every rank of a spatial group
computes the same bits. Each adjoint is a Function too, whose backward is
the primitive again (both maps are linear), so a band function can be
differentiated twice, as the WGAN-GP penalty differentiates D:

  * ``exchange_rows``: the band with ``top`` rows above it and ``bottom``
    below, from the neighbours (one ``all_gather`` over the spatial group
    of every rank's edge rows: no send/recv, so a CUDA graph could capture
    it), or at the frame's edge padded locally, by reflection or zeros, as
    the layer pads. Its adjoint sends each halo row's gradient back to its
    owner (again one all_gather) and adds it there, the rank above's after
    the rank below's.
  * ``gather_frame``: all_gather of the bands into the frame. Its adjoint
    sums every rank's gradient of the frame in rank order, then keeps the
    band.
  * ``gather_parts`` (with ``differentiable``) and ``group_sum``: every
    rank's partial sums stacked, and their sum over the group; the
    adjoint hands each rank the gradient of its own part.
  * ``frame_mean``: a band's share of a mean over the frame, its sum over
    the frame's count: summed over the group, the mean. The step's losses
    are such shares, and ``parallel.all_reduce_grads`` sums the gradients
    over all W ranks and divides by the data width.

The band forms of the convolutions and kernels built on them live beside
their whole-frame versions (``ops/*``, ``models/*``), each under a
``band`` argument; ``band=None`` is the one-process path, unchanged.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from nemar_tpu_torch import parallel


@dataclasses.dataclass(frozen=True)
class Band:
    """Rows [bounds[index][0], bounds[index][1]) of a frame of ``height``
    rows, held by spatial rank ``index`` of ``len(bounds)``."""

    bounds: tuple
    index: int
    height: int

    @property
    def r0(self) -> int:
        return self.bounds[self.index][0]

    @property
    def r1(self) -> int:
        return self.bounds[self.index][1]

    @property
    def rows(self) -> int:
        return self.r1 - self.r0

    @property
    def size(self) -> int:
        return len(self.bounds)

    @property
    def first(self) -> bool:
        return self.index == 0

    @property
    def last(self) -> bool:
        return self.index == self.size - 1

    @staticmethod
    def split(height: int, size: int, index: int) -> "Band":
        """The even split of ``height`` rows over ``size`` ranks, as the JAX
        package's ``device_put`` of an H sharded on 'spatial' (which refuses
        an H the axis does not divide)."""
        if height % size:
            raise ValueError(f"--mesh_spatial {size} does not divide the image height {height}")
        b = height // size
        return Band(tuple((j * b, (j + 1) * b) for j in range(size)), index, height)

    def up(self, factor: int = 2) -> "Band":
        """The band of an up-sampling by ``factor`` (nearest, or a stride-2
        transposed conv cropped to 2H)."""
        return Band(tuple((a * factor, b * factor) for a, b in self.bounds), self.index,
                    self.height * factor)

    def down(self, factor: int = 2) -> "Band":
        """The band of a ``factor`` x ``factor`` average pooling, each band's
        rows pooled on their own (every bound a multiple of ``factor``: the
        caller's geometry check)."""
        return Band(tuple((a // factor, b // factor) for a, b in self.bounds), self.index,
                    self.height // factor)

    def fits(self, k: int, stride: int = 1, pad: int = 0) -> bool:
        """Whether ``conv(k, stride, pad)`` takes this geometry (no rank's
        band is thinner than a halo it must send, none is empty)."""
        try:
            self.conv(k, stride, pad)
        except ValueError:
            return False
        return True

    def conv(self, k: int, stride: int = 1, pad: int = 0) -> tuple:
        """A conv (k, stride, pad) over the height -> (output band, tops,
        bottoms): output row i is the band's that holds input row stride *
        i; ``tops[j]`` / ``bottoms[j]`` are the input rows rank j reads
        above / below its band (padding rows at the frame's edges
        included; negative: rows of its band it does not read). Refuses a
        geometry whose exchange a rank could not serve: an empty output
        band, or a band thinner than a halo it must send."""
        out_h = (self.height + 2 * pad - k) // stride + 1
        out, tops, bottoms = [], [], []
        for j, (a, b) in enumerate(self.bounds):
            o0 = min(-(-a // stride), out_h)
            o1 = out_h if j == self.size - 1 else min(-(-b // stride), out_h)
            if o1 <= o0:
                raise ValueError(f"--mesh_spatial {self.size}: rank {j}'s band of a conv "
                                 f"(k {k}, stride {stride}) over {self.height} rows is empty")
            out.append((o0, o1))
            tops.append(a - (o0 * stride - pad))
            bottoms.append((o1 - 1) * stride - pad + k - b)
        for j, (a, b) in enumerate(self.bounds):
            rows = b - a
            sends = max([bottoms[j - 1] if j > 0 else 0, tops[j + 1] if j + 1 < self.size else 0])
            edge = max(tops[j] if j == 0 else 0, bottoms[j] if j == self.size - 1 else 0)
            if sends > rows or edge >= rows:
                raise ValueError(f"--mesh_spatial {self.size}: rank {j}'s band of {rows} rows "
                                 f"of {self.height} is thinner than a halo it must send "
                                 f"(conv k {k}, stride {stride}, pad {pad})")
        return Band(tuple(out), self.index, out_h), tuple(tops), tuple(bottoms)


def _gather(t: torch.Tensor) -> list:
    """Every spatial rank's t (one shape on all), in rank order. Each call
    counts on ``_gather.calls`` (every exchange, gather and statistics'
    all-gather of the band forms is one)."""
    _gather.calls += 1
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(parallel.spatial_size())]
    dist.all_gather(parts, t, group=parallel.spatial_group())
    return parts


_gather.calls = 0


def _pad_rows(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """t with zero rows appended along ``dim`` up to n rows."""
    if t.shape[dim] == n:
        return t
    shape = list(t.shape)
    shape[dim] = n - t.shape[dim]
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


def _edge(x: torch.Tensor, dim: int, rows: int, top: bool, mode: str) -> torch.Tensor:
    """``rows`` padding rows beyond the frame's top (or bottom) edge of x:
    the reflection (``networks.reflect_pad``'s rows) or zeros."""
    h = x.shape[dim]
    if mode == "zeros":
        shape = list(x.shape)
        shape[dim] = rows
        return x.new_zeros(shape)
    if top:
        return x.narrow(dim, 1, rows).flip(dim)
    return x.narrow(dim, h - rows - 1, rows).flip(dim)


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, band, tops, bottoms, dim, mode):
        j = band.index
        top, bottom = tops[j], bottoms[j]
        h = x.shape[dim]
        ctx.band, ctx.tops, ctx.bottoms, ctx.dim, ctx.mode = band, tops, bottoms, dim, mode
        # every rank sends its first rows (the rank above's bottom halo) and
        # its last rows (the rank below's top halo), packed to one shape
        send_b = max([bottoms[k] for k in range(band.size - 1)] + [0])
        send_t = max([tops[k] for k in range(1, band.size)] + [0])
        parts = None
        if send_b > 0 or send_t > 0:
            first = x.narrow(dim, 0, min(max(send_b, 0), h))
            last = x.narrow(dim, h - min(max(send_t, 0), h), min(max(send_t, 0), h))
            parts = _gather(torch.cat([_pad_rows(first, dim, send_b),
                                       _pad_rows(last, dim, send_t)], dim=dim))
        pieces = []
        body = x
        if top < 0:
            body = body.narrow(dim, -top, body.shape[dim] + top)
        elif top > 0:
            if band.first:
                pieces.append(_edge(x, dim, top, True, mode))
            else:
                above = parts[j - 1].narrow(dim, send_b, send_t)
                pieces.append(above.narrow(dim, send_t - top, top))
        pieces.append(body if bottom >= 0 else body.narrow(dim, 0, body.shape[dim] + bottom))
        if bottom > 0:
            if band.last:
                pieces.append(_edge(x, dim, bottom, False, mode))
            else:
                pieces.append(parts[j + 1].narrow(dim, 0, bottom))
        return torch.cat(pieces, dim=dim) if len(pieces) > 1 else pieces[0].clone()

    @staticmethod
    def backward(ctx, g):
        return (_ExchangeAdjoint.apply(g, ctx.band, ctx.tops, ctx.bottoms, ctx.dim, ctx.mode),
                None, None, None, None, None)


class _ExchangeAdjoint(torch.autograd.Function):
    """The adjoint exchange as a Function: both maps are linear, so its
    backward is the exchange again (WGAN-GP's double backward)."""

    @staticmethod
    def forward(ctx, g, band, tops, bottoms, dim, mode):
        ctx.band, ctx.tops, ctx.bottoms, ctx.dim, ctx.mode = band, tops, bottoms, dim, mode
        return _exchange_adjoint(g, band, tops, bottoms, dim, mode)

    @staticmethod
    def backward(ctx, gg):
        return (_Exchange.apply(gg, ctx.band, ctx.tops, ctx.bottoms, ctx.dim, ctx.mode),
                None, None, None, None, None)


def _exchange_adjoint(g: torch.Tensor, band: Band, tops: tuple, bottoms: tuple, dim: int,
                     mode: str) -> torch.Tensor:
    """The adjoint of ``exchange_rows``: g (the gradient of the band with
    its halos) -> the gradient of the band. Each halo row's gradient goes
    back to its owner (one all_gather of every rank's halo gradients) and
    is added there, the rank below's first, then the rank above's; at the
    frame's edge a reflected row's is added onto the row it reflects."""
    j = band.index
    top, bottom = tops[j], bottoms[j]
    h = band.rows
    core = g.narrow(dim, max(top, 0), g.shape[dim] - max(top, 0) - max(bottom, 0))
    pieces = [core]
    if top < 0:
        pieces.insert(0, _zeros_rows(g, dim, -top))
    if bottom < 0:
        pieces.append(_zeros_rows(g, dim, -bottom))
    d = torch.cat(pieces, dim=dim) if len(pieces) > 1 else core.clone()
    recv_t = max([tops[k] for k in range(1, band.size)] + [0])  # halos the rank above gets
    recv_b = max([bottoms[k] for k in range(band.size - 1)] + [0])
    if recv_t > 0 or recv_b > 0:
        gt = g.narrow(dim, 0, top) if top > 0 and not band.first else _zeros_rows(g, dim, 0)
        gb = (g.narrow(dim, g.shape[dim] - bottom, bottom) if bottom > 0 and not band.last
              else _zeros_rows(g, dim, 0))
        parts = _gather(torch.cat([_pad_rows(gt, dim, recv_t), _pad_rows(gb, dim, recv_b)],
                                  dim=dim))
        if not band.last and tops[j + 1] > 0:  # the rank below's top halo: my last rows
            n = tops[j + 1]
            d.narrow(dim, h - n, n).add_(parts[j + 1].narrow(dim, 0, n))
        if not band.first and bottoms[j - 1] > 0:  # the rank above's bottom halo: my first rows
            n = bottoms[j - 1]
            d.narrow(dim, 0, n).add_(parts[j - 1].narrow(dim, recv_t, n))
    if mode == "reflect":
        if band.first and top > 0:
            d.narrow(dim, 1, top).add_(g.narrow(dim, 0, top).flip(dim))
        if band.last and bottom > 0:
            d.narrow(dim, h - bottom - 1, bottom).add_(
                g.narrow(dim, g.shape[dim] - bottom, bottom).flip(dim))
    return d


def _zeros_rows(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    shape = list(t.shape)
    shape[dim] = n
    return t.new_zeros(shape)


def exchange_rows(x: torch.Tensor, band: Band, tops: tuple, bottoms: tuple, dim: int = 2,
                  mode: str = "zeros") -> torch.Tensor:
    """x (this rank's band along ``dim``) with ``tops[index]`` rows above it
    and ``bottoms[index]`` below (every rank's counts given, as
    ``Band.conv`` returns them; a negative count drops rows of the band):
    the neighbours' rows, or past the frame's edge ``mode``'s padding
    ('reflect' or 'zeros'). Differentiable (the adjoint exchange)."""
    if mode not in ("reflect", "zeros"):
        raise ValueError(f"exchange_rows: mode {mode!r}")
    return _Exchange.apply(x, band, tuple(tops), tuple(bottoms), dim, mode)


class _GatherFrame(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, band, dim):
        ctx.band, ctx.dim = band, dim
        most = max(b - a for a, b in band.bounds)
        parts = _gather(_pad_rows(x, dim, most))
        return torch.cat([p.narrow(dim, 0, b - a) for p, (a, b) in zip(parts, band.bounds)],
                         dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _GatherFrameAdjoint.apply(g, ctx.band, ctx.dim), None, None


class _GatherFrameAdjoint(torch.autograd.Function):
    """The adjoint of ``gather_frame``: every rank's gradient of the frame
    summed in rank order, this rank's band kept. Its backward is
    ``gather_frame`` again."""

    @staticmethod
    def forward(ctx, g, band, dim):
        ctx.band, ctx.dim = band, dim
        parts = _gather(g)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total.narrow(dim, band.r0, band.rows).contiguous()

    @staticmethod
    def backward(ctx, gg):
        return _GatherFrame.apply(gg, ctx.band, ctx.dim), None, None


def gather_frame(x: torch.Tensor, band: Band, dim: int = 2) -> torch.Tensor:
    """The whole frame of which x is this rank's band along ``dim`` (every
    rank gets it). Differentiable, twice and more: the adjoint sums the
    ranks' gradients of the frame in rank order and keeps the band."""
    return _GatherFrame.apply(x, band, dim)


class _GatherParts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return torch.stack(_gather(t))

    @staticmethod
    def backward(ctx, g):
        return _GatherPartsAdjoint.apply(g)


class _GatherPartsAdjoint(torch.autograd.Function):
    """The adjoint of the differentiable ``gather_parts``: (size, *shape)
    on every rank -> this rank's part's gradient, the ranks' rows of its
    index summed in rank order. Its backward is ``gather_parts`` again."""

    @staticmethod
    def forward(ctx, g):
        parts = _gather(g)
        j = parallel.spatial_rank()
        total = parts[0][j]
        for p in parts[1:]:
            total = total + p[j]
        return total

    @staticmethod
    def backward(ctx, gg):
        return _GatherParts.apply(gg)


def gather_parts(t: torch.Tensor, differentiable: bool = False) -> torch.Tensor:
    """(size, *t.shape): every spatial rank's t stacked in rank order: the
    band forms' partial statistics, which a merge then takes in one fixed
    global order. No gradient, or with ``differentiable`` the adjoint (each
    rank gets the gradient of its own part, summed over the ranks in rank
    order), itself differentiable: the band's partial sums of a function
    that is differentiated twice (K-in's band backward, the WGAN-GP
    penalty's norm)."""
    if differentiable:
        return _GatherParts.apply(t.contiguous())
    return torch.stack(_gather(t.detach()))


def group_sum(t: torch.Tensor) -> torch.Tensor:
    """t summed over the spatial group in rank order, the same on every
    rank; differentiable any number of times (its adjoint is the same sum
    of the incoming gradients)."""
    return gather_parts(t, differentiable=True).sum(dim=0)


def frame_mean(x: torch.Tensor, band: Band, dim: int = 2) -> torch.Tensor:
    """This band's share of the mean of the frame of which x is the band
    along ``dim``: its sum over the frame's count."""
    count = x.numel() // max(x.shape[dim], 1) * band.height
    return x.sum() / count


def fold_halo_rows(d: torch.Tensor, band: Band, pad: int = 1, dim: int = 1) -> torch.Tensor:
    """In place, on the gradient d of a band padded by ``pad`` rows above
    and below (a dgrad's padded domain, every rank's band of one height):
    the padded rows that are a neighbour's rows are added to that
    neighbour's (one all_gather) and zeroed here; at the frame's edges they
    stay, for the kernel's own fold of the reflection. -> d."""
    h = band.rows
    parts = _gather(torch.cat([d.narrow(dim, 0, pad), d.narrow(dim, h + pad, pad)], dim=dim))
    j = band.index
    if not band.first:
        d.narrow(dim, pad, pad).add_(parts[j - 1].narrow(dim, pad, pad))
        d.narrow(dim, 0, pad).zero_()
    if not band.last:
        d.narrow(dim, h, pad).add_(parts[j + 1].narrow(dim, 0, pad))
        d.narrow(dim, h + pad, pad).zero_()
    return d
