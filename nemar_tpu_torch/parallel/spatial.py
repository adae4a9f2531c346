"""The image height in bands over a spatial group (``--mesh_spatial``): the
counterpart of the JAX package's 'spatial' mesh axis
(``nemar_tpu/parallel/mesh.py``: ``batch_sharding(spatial_dim=1)``), where
GSPMD splits H over the axis and inserts the halo exchanges. Here the
exchanges are written out, so a rank holds only its band of each
activation and the step computes the whole frame's function.

Band geometry. A ``Band`` is this rank's rows [r0, r1) of a frame of
``height`` rows, with every rank's bounds: any partition of the frame in
rank order, its bands uneven, one row or empty. The input height splits
evenly (``Band.split``: s divides H, as the JAX package's ``device_put``).
A convolution's output row i belongs to the rank that holds its input row
``stride * i`` (``Band.conv``): the stride-1 k4 p1 layers of D take 32
rows to 31 and 30 at 256^2, bands of 16 and 15, then 16 and 14, and at
32^2 4 rows to 3 and 2, bands of 2 and 1, then 2 and none. Up-sampling by
2 doubles every band (``Band.up``), which need not give the band its
input's level had (36^2 at s = 2: G's trunk of 5 | 4 rows comes back as
20 | 16 against 18 | 18): where two levels meet (a skip's concatenation,
G's output against its input, a 2x2 pool that needs even bounds) the rows
are re-cut (``reband``). ``Band.conv`` also returns the rows each rank's
output band needs beyond its input band: ``top`` above, ``bottom`` below
(negative: rows of the band it does not read).

Primitives, each a ``torch.autograd.Function`` whose backward is the
adjoint, every sum in a fixed order, so every rank of a spatial group
computes the same bits and two runs the same. Each adjoint is a Function
too, whose backward is the primitive again (both maps are linear), so a
band function can be differentiated twice, as the WGAN-GP penalty
differentiates D:

  * ``exchange_rows``: the band with ``top`` rows above it and ``bottom``
    below, from whichever ranks own them, however many that is, or past
    the frame's edge padded by reflection or zeros, as the layer pads (a
    reflected row may belong to a rank beyond a thin edge band). One
    ``all_gather`` over the spatial group of the rows some other rank
    reads (no send/recv, so a CUDA graph could capture it). Its adjoint
    sends each halo row's gradient back to its owner (again one
    all_gather), which adds the contributions in rank order after its own.
  * ``reband``: the rows of one partition of a frame moved to another
    (one all_gather; the adjoint is the reverse move).
  * ``gather_frame``: all_gather of the bands into the frame. Its adjoint
    sums every rank's gradient of the frame in rank order, then keeps the
    band.
  * ``gather_parts`` (with ``differentiable``) and ``group_sum``: every
    rank's partial sums stacked, and their sum over the group; the
    adjoint hands each rank the gradient of its own part.
  * ``frame_mean``: a band's share of a mean over the frame, its sum over
    the frame's count (0 on an empty band): summed over the group, the
    mean. The step's losses are such shares, and
    ``parallel.all_reduce_grads`` sums the gradients over all W ranks and
    divides by the data width.

A rank whose band of a layer is empty still makes that layer's
collectives, in the same order as every other rank, and its band
functions stay in the autograd graph (an empty output band of a
convolution is the one row it would hold next, computed and dropped), so
that every rank runs the same collectives in the backward too
(``up2`` and ``pool2``: the nearest up-sampling and the 2x2 pooling, which
PyTorch refuses on a tensor without rows).

The band forms of the convolutions and kernels built on them live beside
their whole-frame versions (``ops/*``, ``models/*``), each under a
``band`` argument; ``band=None`` is the one-process path, unchanged.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from nemar_tpu_torch import parallel


@dataclasses.dataclass(frozen=True)
class Band:
    """Rows [bounds[index][0], bounds[index][1]) of a frame of ``height``
    rows, held by spatial rank ``index`` of ``len(bounds)``; the bounds
    partition the frame in rank order (a band may be empty)."""

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
    def most(self) -> int:
        """The rows of the largest band."""
        return max(b - a for a, b in self.bounds)

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

    def aligned(self, factor: int = 2) -> "Band":
        """The partition whose every bound is this one's rounded down to a
        multiple of ``factor`` (the frame's end kept): what a ``factor`` x
        ``factor`` pooling of each band on its own needs (``reband`` to it
        first)."""
        if self.height % factor:
            raise ValueError(f"a pooling by {factor} of a frame of {self.height} rows")
        cut = [a - a % factor for a, _ in self.bounds[1:]] + [self.height]
        return Band(tuple(zip([0] + cut[:-1], cut)), self.index, self.height)

    def pooled(self, factor: int = 2) -> "Band":
        """The band of a ``factor`` x ``factor`` pooling of this aligned
        partition (``aligned``)."""
        if self != self.aligned(factor):
            raise ValueError(f"bands {self.bounds} are not aligned to {factor}")
        return Band(tuple((a // factor, b // factor) for a, b in self.bounds), self.index,
                    self.height // factor)

    def conv(self, k: int, stride: int = 1, pad: int = 0) -> tuple:
        """A conv (k, stride, pad) over the height -> (output band, tops,
        bottoms): output row i is the band's that holds input row stride *
        i; ``tops[j]`` / ``bottoms[j]`` are the input rows rank j reads
        above / below its band (padding rows at the frame's edges
        included; negative: rows of its band it does not read), from
        whichever ranks hold them. A rank whose output band is empty reads
        the k rows of the output row it would hold next, whose convolution
        its caller computes and drops (``networks.conv_band``), so that
        the rank stays in the graph of every collective."""
        out_h = (self.height + 2 * pad - k) // stride + 1
        out, tops, bottoms = [], [], []
        for j, (a, b) in enumerate(self.bounds):
            o0 = min(-(-a // stride), out_h)
            o1 = out_h if j == self.size - 1 else min(-(-b // stride), out_h)
            o1 = max(o1, o0)
            out.append((o0, o1))
            tops.append(a - (o0 * stride - pad))
            bottoms.append((max(o1, o0 + 1) - 1) * stride - pad + k - b)
        return Band(tuple(out), self.index, out_h), tuple(tops), tuple(bottoms)


@functools.lru_cache(maxsize=1024)
def band_pixels(band: Band, w: int) -> torch.Tensor:
    """Every rank's pixels of a sample's band of width ``w``, a host int32
    tensor (cached: callers must not write to it): what the band stages'
    merges of tile partials read on the host (``csrc/band.cuh``)."""
    return torch.tensor([(b - a) * w for a, b in band.bounds], dtype=torch.int32)


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


def _zeros_rows(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    shape = list(t.shape)
    shape[dim] = n
    return t.new_zeros(shape)


# ---------------------------------------------------------------------------
# row moves: exchange_rows and reband are one map, each rank's output a
# list of the frame's rows (or zero rows) taken from their owners
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class _Plan:
    """How rank ``index`` assembles its output rows, and what every rank
    publishes. ``pub_runs``: this rank's published rows as runs (local
    start, length), ``pub_len[k]`` rank k's count, ``width`` the largest
    (the all-gather's rows; 0: no collective); ``segments``: the output in
    order, each (source, start, length, flipped) with source 'own' (x's
    local rows), a rank k (its published rows, by position) or 'zero'."""

    index: int
    rows: int
    width: int
    pub_runs: tuple
    pub_len: tuple
    segments: tuple


def _runs(idx: list) -> list:
    """idx cut into runs that step by +1 or by -1: [(start, length,
    flipped)], a run the rows [start, start + length), taken in reverse
    when flipped."""
    runs = []
    for i in idx:
        r = runs[-1] if runs else None
        if r and abs(i - r[-1]) == 1 and (len(r) == 1 or i - r[-1] == r[-1] - r[-2]):
            r.append(i)
        else:
            runs.append([i])
    return [(min(r[0], r[-1]), len(r), r[-1] < r[0]) for r in runs]


@functools.lru_cache(maxsize=4096)
def _plan(bounds: tuple, height: int, wanted: tuple, mode: str, index: int) -> _Plan:
    """The plan of rank ``index`` for outputs ``wanted`` (per rank, the
    frame rows (lo, hi) it assembles: rows past the frame padded by
    ``mode``) from a frame split by ``bounds``."""
    def owner(r):
        for k, (a, b) in enumerate(bounds):
            if a <= r < b:
                return k
        raise AssertionError(r)

    def source(r):  # (owner, frame row) or None (a zero row)
        if 0 <= r < height:
            return owner(r), r
        if mode == "zeros":
            return None
        q = -r if r < 0 else 2 * (height - 1) - r
        if not 0 <= q < height:
            raise ValueError(f"a reflection of row {r} of a frame of {height} rows")
        return owner(q), q

    reads = [[source(r) for r in range(lo, max(hi, lo))] for lo, hi in wanted]
    # every rank's rows that another rank reads, in row order
    pub = [set() for _ in bounds]
    for j, rs in enumerate(reads):
        for src in rs:
            if src is not None and src[0] != j:
                pub[src[0]].add(src[1])
    pub = [sorted(p) for p in pub]
    pos = [{q: i for i, q in enumerate(p)} for p in pub]
    a = bounds[index][0]
    segments = []
    for kind, grp in _groups(reads[index], index, a, pos):
        for start, n, flip in _runs(grp):
            segments.append((kind, start, n, flip))
    return _Plan(index, bounds[index][1] - a, max(len(p) for p in pub),
                 tuple((s, n) for s, n, _ in _runs([q - a for q in pub[index]])),
                 tuple(len(p) for p in pub), tuple(segments))


def _groups(reads: list, index: int, a: int, pos: list) -> list:
    """reads (rank index's sources in order) cut where the source changes:
    [(source, [indices])], indices local rows ('own'), positions in the
    owner's published rows (rank k) or zero-row counts ('zero')."""
    out = []
    for s in reads:
        if s is None:
            kind, i = "zero", 0
        elif s[0] == index:
            kind, i = "own", s[1] - a
        else:
            kind, i = s[0], pos[s[0]][s[1]]
        if out and out[-1][0] == kind and kind == "zero":
            out[-1][1].append(out[-1][1][-1] + 1)
        elif out and out[-1][0] == kind:
            out[-1][1].append(i)
        else:
            out.append((kind, [i]))
    return out


def _move(x: torch.Tensor, plan: _Plan, dim: int) -> torch.Tensor:
    """The rows of ``plan``'s output from x (this rank's band along dim)."""
    parts = None
    if plan.width:
        send = [x.narrow(dim, s, n) for s, n in plan.pub_runs]
        send = torch.cat(send, dim=dim) if send else _zeros_rows(x, dim, 0)
        parts = _gather(_pad_rows(send, dim, plan.width))
    pieces = []
    for kind, start, n, flip in plan.segments:
        if kind == "zero":
            pieces.append(_zeros_rows(x, dim, n))
            continue
        t = (x if kind == "own" else parts[kind]).narrow(dim, start, n)
        pieces.append(t.flip(dim) if flip else t)
    if not pieces:
        return _zeros_rows(x, dim, 0)
    return torch.cat(pieces, dim=dim) if len(pieces) > 1 else pieces[0].clone()


def _move_adjoint(g: torch.Tensor, plan: _Plan, dim: int) -> torch.Tensor:
    """The adjoint of ``_move``: g (the gradient of the output) -> the
    gradient of the band. Each row's gradient goes back to its owner (one
    all_gather of every rank's contributions to every rank's published
    rows), which adds, to its own rows' contributions in the output's
    order, the ranks' in rank order."""
    d = _zeros_rows(g, dim, plan.rows)
    size = len(plan.pub_len)
    send = _zeros_rows(g, dim, size * plan.width) if plan.width else None
    at = 0
    for kind, start, n, flip in plan.segments:
        t = g.narrow(dim, at, n)
        t = t.flip(dim) if flip else t
        at += n
        if kind == "own":
            d.narrow(dim, start, n).add_(t)
        elif kind != "zero":
            send.narrow(dim, kind * plan.width + start, n).add_(t)
    if plan.width:
        parts = _gather(send)
        mine = plan.pub_len[plan.index]
        if mine:
            total = parts[0].narrow(dim, plan.index * plan.width, mine)
            for p in parts[1:]:
                total = total + p.narrow(dim, plan.index * plan.width, mine)
            at = 0
            for s, n in plan.pub_runs:
                d.narrow(dim, s, n).add_(total.narrow(dim, at, n))
                at += n
    return d


class _Move(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan, dim):
        ctx.plan, ctx.dim = plan, dim
        return _move(x, plan, dim)

    @staticmethod
    def backward(ctx, g):
        return _MoveAdjoint.apply(g, ctx.plan, ctx.dim), None, None


class _MoveAdjoint(torch.autograd.Function):
    """The adjoint move as a Function: both maps are linear, so its
    backward is the move again (WGAN-GP's double backward)."""

    @staticmethod
    def forward(ctx, g, plan, dim):
        ctx.plan, ctx.dim = plan, dim
        return _move_adjoint(g.contiguous(), plan, dim)

    @staticmethod
    def backward(ctx, gg):
        return _Move.apply(gg, ctx.plan, ctx.dim), None, None


def _exchange_plan(band: Band, tops: tuple, bottoms: tuple, mode: str) -> _Plan:
    wanted = tuple((a - t, b + u) for (a, b), t, u in zip(band.bounds, tops, bottoms))
    return _plan(band.bounds, band.height, wanted, mode, band.index)


def exchange_rows(x: torch.Tensor, band: Band, tops: tuple, bottoms: tuple, dim: int = 2,
                  mode: str = "zeros") -> torch.Tensor:
    """x (this rank's band along ``dim``) with ``tops[index]`` rows above it
    and ``bottoms[index]`` below (every rank's counts given, as
    ``Band.conv`` returns them; a negative count drops rows of the band):
    the rows of whichever ranks own them, or past the frame's edge
    ``mode``'s padding ('reflect' or 'zeros'). Differentiable (the adjoint
    exchange), twice and more."""
    if mode not in ("reflect", "zeros"):
        raise ValueError(f"exchange_rows: mode {mode!r}")
    return _Move.apply(x, _exchange_plan(band, tuple(tops), tuple(bottoms), mode), dim)


def reband(x: torch.Tensor, src: Band, dst: Band, dim: int = 2) -> torch.Tensor:
    """x, this rank's band of ``src``'s partition along ``dim``, as its band
    of ``dst``'s partition of the same frame (one all_gather; none when
    the two are one partition). Differentiable: the adjoint moves the
    gradient back."""
    if (src.height, src.index) != (dst.height, dst.index) or src.size != dst.size:
        raise ValueError(f"reband: {src} and {dst} are not partitions of one frame")
    if src.bounds == dst.bounds:
        return x
    return _Move.apply(x, _plan(src.bounds, src.height, dst.bounds, "zeros", src.index), dim)


class _GatherFrame(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, band, dim):
        ctx.band, ctx.dim = band, dim
        parts = _gather(_pad_rows(x, dim, band.most))
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
    along ``dim``: its sum over the frame's count (the frame's rows times
    the other dimensions; an empty band's share is 0)."""
    count = math.prod(n for i, n in enumerate(x.shape) if i != dim % x.dim()) * band.height
    return x.sum() / count


def up2(x: torch.Tensor) -> torch.Tensor:
    """The nearest x2 up-sampling of an NCHW band (``F.interpolate``), an
    empty band's too (its rows none, its columns doubled), in the graph."""
    if x.shape[2]:
        return F.interpolate(x, scale_factor=2, mode="nearest")
    return torch.cat([x, x], dim=3)


def pool2(x: torch.Tensor) -> torch.Tensor:
    """The 2x2 average pooling of an NCHW band (``F.avg_pool2d``; its bounds
    even, ``Band.aligned``), an empty band's too, in the graph."""
    return F.avg_pool2d(x, 2) if x.shape[2] else x[:, :, :, ::2]


def fold_halo_rows(d: torch.Tensor, band: Band, pad: int = 1, dim: int = 1) -> torch.Tensor:
    """In place, on the gradient d of a band padded by ``pad`` rows above
    and below as ``exchange_rows(x, band, pad, pad, mode='reflect')`` pads
    it (a dgrad's padded domain): the adjoint of that exchange, so each
    padded row's gradient is added to the row it holds, wherever it lives
    (a neighbour's row, or at the frame's edges the row it reflects), and
    the padded rows are zeroed. -> d."""
    plan = _exchange_plan(band, (pad,) * band.size, (pad,) * band.size, "reflect")
    db = _move_adjoint(d, plan, dim)
    d.narrow(dim, pad, band.rows).copy_(db)
    d.narrow(dim, 0, pad).zero_()
    d.narrow(dim, pad + band.rows, pad).zero_()
    return d
