"""The ResNet generator's 7x7 head conv over a reflect-padded input:

    out = conv7x7(reflect_pad3(x), W)

NHWC x (N, H, W, Ci), HWIO W (7, 7, Ci, Co), no bias (the generator adds
it: the head feeds tanh, not an instance norm, so its bias is live). The counterpart of ``nemar_tpu/ops/conv_head_roll.py:conv_head_roll``
(``--c7_impl roll``) and ``nemar_tpu/ops/attic/conv_head.py:conv_head``
(``--block_impl pallas_all``), which compute this function in two TPU
layouts, and of the direct conv the JAX generator runs otherwise.

``conv_head`` is a ``torch.autograd.Function`` that dispatches on the
device. A CPU tensor takes ``conv_head_plain`` (reflect pad + ``F.conv2d``)
forward and ``conv_head_bwd_plain`` (the VJP written out) backward. A CUDA
tensor launches the CUDA kernels K-head (``csrc/head_fwd.cu``, replacing
the TPU kernels B4 and B6's forwards) and K-head-bwd (``csrc/head_bwd.cu``,
their backwards). Both compute the convolutions in their own bodies: no
cuDNN, cuBLAS or ``F.conv2d`` on that path, and no float atomics.

K-head is one launch a call. On the model's head (Co <= 3, Ci <= 64, Ci a
multiple of 4) it is a GEMM on the tensor cores in 3xTF32 with the 49 taps
folded into N (Y[q, (tap, co)] = sum_ci xpad[q, ci] W[tap, ci, co] over 64
padded positions q of a strip's row), streamed down the frame, each row's Y
collapsed into a ring of the 7 output rows it feeds (out[y, c] = sum_dy
sum_dx Y_{y + dy}[c + dx, (dy, dx, co)]); ``head_fwd_plan`` cuts the frame
into strips and the strips' rows into one run a block of a persistent grid,
and ``head_fwd_steps`` lists a block's steps as the kernel walks them. Any
other shape takes the kernel's direct route, a convolution on the CUDA
cores.

K-head-bwd is two GEMMs on the tensor cores in 3xTF32 with the 49 taps
folded into them (dW: N = 49 Co; dX: K = 49 Co), over tiles of the
reflect-padded frame, and one launch that merges dW's per-block partials in
fp64 and folds the frame's part of dX onto the image's edge pixels: three
launches a call, one operator call. ``head_bwd_plan`` sizes the tiles, the
grids and the scratch (a pure function of the shapes and the card's SM
count).

Each launch takes at most ``MAX_CO`` = 8 output channels. A wider head
(``--output_nc 9``) takes one launch of each kernel a chunk of 8
(``head_chunks``): the chunks' outputs and weight gradients are
concatenated, their input gradients added in chunk order.

Under ``--bf16`` (x and w bfloat16) the head runs on fp32 copies, on the
card and on the CPU alike: x and w cast up, the output cast down, and in
the backward g up and dx and dw down (``ops/cast.py``, counted on
``conv_head.casts``). K-head's GEMM folds the 49 taps into N, a layout
built for 3xTF32; its bf16 variant is queued as ROADMAP.md A7b.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from nemar_tpu_torch.ops import _build
from nemar_tpu_torch.ops.cast import to_dtype
from nemar_tpu_torch.ops.conv_fused import (
    conv_adjoint_plain, conv_wgrad_plain, reflect_pad_adjoint,
)

PAD = 3
MAX_CO = 8
# K-head-bwd's tiling limits (csrc/head_bwd.cu: TILE_MAX, GW_MAX): a tile's
# positions, and the floats of its g window, (tr + 6) (tc + 6) Co
_TILE_MAX = 1024
_GW_MAX = 4096
_TC_MAX = 128  # tile columns
_TR_MAX = 8    # tile rows
_WG_MT, _WG_NB = 64, 160  # a dW block's input channels and (tap, co) columns
_DX_WGS = 3               # warpgroups of a dX block
# K-head's wgmma route (csrc/head_fwd.cu: G_M, G_CO_MAX, G_KS_MAX): 64
# padded positions a strip's row, so at most 58 output columns; one wgmma of
# N = 49 Co rounded up to 8, at most 152, so Co <= 3; two 32-deep K slices,
# so Ci <= 64, in 16-byte copies
_FWD_M = 64
_FWD_TC_MAX = _FWD_M - 2 * PAD
_FWD_CO_MAX = 3
_FWD_CI_MAX = 64


def conv_head_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``conv_head`` (any device)."""
    xp = F.pad(x.permute(0, 3, 1, 2), (PAD, PAD, PAD, PAD), mode="reflect")
    return F.conv2d(xp, w.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)


def conv_head_bwd_plain(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor) -> tuple:
    """Plain version of K-head-bwd: (dx, dw) of ``conv_head`` given g = d out,
    written out (no autograd) with K-block-bwd's plain helpers at k = 7: dW
    from the padded input's 49 windows, dx the reflect-pad adjoint of the
    conv's input adjoint."""
    return reflect_pad_adjoint(conv_adjoint_plain(g, w), PAD), conv_wgrad_plain(x, g, 7)


class HeadFwdPlan(NamedTuple):
    """K-head's route and tiling of one call: ``wgmma`` picks the route; the
    wgmma route cuts each output row into ``cx`` strips of ``tc`` columns
    (the last may be narrower), each read as 64 padded positions, and the
    ``units`` = N cx H strip rows, in (sample, strip, row) order with the
    row fastest, into ``blocks`` even runs, one a block of a persistent
    grid. The direct route takes none of it."""
    tc: int
    cx: int
    blocks: int
    units: int
    wgmma: bool


def _run_steps(units: int, h: int, blocks: int, block: int) -> int:
    """Steps of one block's run: its strip rows, and 6 halo rows for each
    strip it touches (csrc/head_fwd.cu: run_steps)."""
    u0, u1 = units * block // blocks, units * (block + 1) // blocks
    return u1 - u0 + 2 * PAD * ((u1 - 1) // h - u0 // h + 1) if u1 > u0 else 0


@functools.lru_cache(maxsize=64)
def head_fwd_plan(n: int, h: int, w: int, ci: int, co: int, sms: int) -> HeadFwdPlan:
    """K-head's route and tiling for x (n, h, w, ci), Co outputs, on a card
    of ``sms`` SMs. The wgmma route takes Co <= 3 and Ci <= 64 in multiples
    of 4 (the model's head); its strips are as even as whole columns allow,
    each at most 58 wide (256 -> 5 strips of 52). Its grid holds at most one
    block a SM (a block is two warpgroups, and W's split copy and the
    buffers take 149 KB of its shared memory, so a second would not fit),
    and the fewer steps its longest run takes the better: ``sms`` blocks
    (runs may cross a strip's end, 6 more halo rows), or, where the strips
    are fewer than the SMs, k runs a strip for the largest k that fits (runs
    then end at the strips' ends). At 256^2 that is 130 blocks of at most
    16 steps at batch 1, and 132 of at most 90 at batch 8. Every other shape
    takes the direct route (the tiling is then what the wgmma route would
    take, which the CPU tests' emulation of it can use at any Co)."""
    tc = -(-w // -(-w // _FWD_TC_MAX))
    cx = -(-w // tc)
    units = n * cx * h
    grids = {min(sms, units)}
    if n * cx <= sms:
        grids.add(n * cx * min(sms // (n * cx), h))

    def longest(blocks):
        return max(_run_steps(units, h, blocks, b) for b in range(blocks))

    wgmma = co <= _FWD_CO_MAX and ci <= _FWD_CI_MAX and ci % 4 == 0
    return HeadFwdPlan(tc, cx, min(sorted(grids), key=longest), units, wgmma)


def head_fwd_steps(plan: HeadFwdPlan, h: int, w: int, block: int) -> list:
    """The steps of one block of K-head's wgmma route, in its order (csrc/
    head_fwd.cu: Cursor): (sample, first output column of the strip, its
    width, padded row r, first output row y0 of the segment). A segment, a
    strip's rows y0 .. y0 + R - 1 within the block's run, takes the padded
    rows y0 .. y0 + R + 5; at r >= y0 + 6 output row r - 6 is complete."""
    u0 = plan.units * block // plan.blocks
    u1 = plan.units * (block + 1) // plan.blocks
    steps = []
    u = u0
    while u < u1:
        col, y0 = divmod(u, h)
        rows = min(h - y0, u1 - u)
        img, strip = divmod(col, plan.cx)
        j0 = strip * plan.tc
        steps += [(img, j0, min(plan.tc, w - j0), y0 + k, y0) for k in range(rows + 2 * PAD)]
        u += rows
    return steps


class HeadBwdPlan(NamedTuple):
    """K-head-bwd's tiling of one call: the padded frame, (H + 6) x (W + 6)
    per sample, cut into ``ty`` x ``cx`` tiles of ``tr`` x ``tc`` positions
    (``tiles`` in all), the persistent grids of the dW and dX launches, and
    the scratch's floats: dW's partials (one set a dW block) and the frame
    around each image (6 (W + 6) + 6 H positions of Ci)."""
    tr: int
    tc: int
    ty: int
    cx: int
    tiles: int
    dw_blocks: int
    dx_blocks: int
    part_floats: int
    frame_floats: int


def head_bwd_plan(n: int, h: int, w: int, ci: int, co: int, sms: int) -> HeadBwdPlan:
    """The tiles, grids and scratch of K-head-bwd for x (n, h, w, ci), Co
    outputs, on a card of ``sms`` SMs. Tiles are at most 128 columns wide
    (the strips of a row as even as whole positions allow) and 8 rows high,
    within the kernel's limits on a tile's positions and g window, and low
    enough that there are about two a SM where the frame allows it: at batch
    1, 256^2, 393 tiles, so that both GEMMs fill the card. dW's partials are
    per block (a persistent grid of at most one block a SM), so their number
    does not grow with the batch."""
    hp, wp = h + 2 * PAD, w + 2 * PAD
    halo = 2 * PAD
    tc_cap = max(1, min(_TC_MAX, _GW_MAX // ((1 + halo) * co) - halo))
    cx = -(-wp // tc_cap)
    tc = -(-wp // cx)
    tr_cap = max(1, min(_TR_MAX, _GW_MAX // ((tc + halo) * co) - halo, _TILE_MAX // tc))
    tr = max(1, min(tr_cap, n * hp * cx // (2 * sms)))
    ty = -(-hp // tr)
    tiles = n * ty * cx
    dw_tiles = -(-ci // _WG_MT) * -(-49 * co // _WG_NB)
    dw_blocks = max(1, min(tiles, sms // dw_tiles))
    dx_tiles = -(-ci // (64 if co <= 3 else 32))
    dx_blocks = max(1, min(-(-tiles // _DX_WGS), sms // dx_tiles))
    return HeadBwdPlan(tr, tc, ty, cx, tiles, dw_blocks, dx_blocks,
                       dw_blocks * 49 * ci * co, n * (6 * wp + 6 * h) * ci)


def head_bwd_tile(plan: HeadBwdPlan, t: int) -> tuple:
    """(sample, first padded row, first padded column) of tile t, as the
    kernels number them (csrc/head_bwd.cu: Geometry::tile)."""
    img, r = divmod(t, plan.ty * plan.cx)
    return img, (r // plan.cx) * plan.tr, (r % plan.cx) * plan.tc


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_cuda(what: str, x: torch.Tensor, w: torch.Tensor) -> None:
    if not (x.is_cuda and w.device == x.device):
        raise ValueError(f"{what}: x and w must be on one CUDA device")
    if not (x.dtype == w.dtype == torch.float32):
        raise TypeError(f"{what}: the kernel takes float32 x and w")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{what}: x {tuple(x.shape)} must be NHWC-contiguous")
    n, h, wd, ci = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (7, 7, ci) or not 1 <= w.shape[3] <= MAX_CO:
        raise ValueError(f"{what}: w {tuple(w.shape)} is not (7, 7, {ci}, Co <= {MAX_CO})")
    if h <= PAD or wd <= PAD:
        raise ValueError(f"{what}: H, W must be >= {PAD + 1} for the reflect pad, "
                         f"got {(h, wd)}")


def conv_head_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch K-head. x (N, H, W, Ci) fp32 NHWC-contiguous on a CUDA device;
    w (7, 7, Ci, Co) HWIO fp32 (made contiguous here). Returns (N, H, W, Co).
    The route is ``head_fwd_plan``'s; an x whose data is not 16-byte aligned
    (a view at an odd offset), which the wgmma route's copies cannot read,
    takes the direct route."""
    _check_cuda("conv_head_cuda", x, w)
    w = w.contiguous()
    n, h, wd, ci = x.shape
    co = w.shape[3]
    plan = head_fwd_plan(n, h, wd, ci, co, _sm_count(x.device.index))
    blocks = plan.blocks if plan.wgmma and x.data_ptr() % 16 == 0 else 0
    out = torch.empty((n, h, wd, co), dtype=torch.float32, device=x.device)
    _build.op("conv_head_fwd")(x, w, out, plan.tc, blocks)
    conv_head_cuda.launches += 1
    return out


conv_head_cuda.launches = 0


def conv_head_bwd_cuda(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor) -> tuple:
    """Launch K-head-bwd: (dx, dw) of ``conv_head`` given g = d out
    (N, H, W, Co); same layouts and shape rules as ``conv_head_cuda``."""
    _check_cuda("conv_head_bwd_cuda", x, w)
    w = w.contiguous()
    n, h, wd, ci = x.shape
    co = w.shape[3]
    if tuple(g.shape) != (n, h, wd, co) or g.dtype != torch.float32 or not g.is_contiguous() \
            or g.device != x.device:
        raise ValueError(f"conv_head_bwd_cuda: g {tuple(g.shape)} must be a contiguous fp32 "
                         f"({n}, {h}, {wd}, {co}) tensor on x's device")
    plan = head_bwd_plan(n, h, wd, ci, co, _sm_count(x.device.index))
    part = torch.empty(plan.part_floats, dtype=torch.float32, device=x.device)
    frame = torch.empty(plan.frame_floats, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dw = torch.empty((7, 7, ci, co), dtype=torch.float32, device=x.device)
    _build.op("conv_head_bwd")(x, w, g, part, frame, dx, dw, plan.tr, plan.tc, plan.dw_blocks,
                               plan.dx_blocks)
    conv_head_bwd_cuda.launches += 1
    return dx, dw


conv_head_bwd_cuda.launches = 0


def head_chunks(co: int) -> list:
    """The output channels [a, b) of each K-head launch for a Co-channel
    head: chunks of ``MAX_CO`` from channel 0."""
    return [(a, min(a + MAX_CO, co)) for a in range(0, co, MAX_CO)]


def head_fwd_chunked(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K-head at any Co: one launch a chunk, the outputs concatenated."""
    if w.shape[3] <= MAX_CO:
        return conv_head_cuda(x, w)
    return torch.cat([conv_head_cuda(x, w[..., a:b]) for a, b in head_chunks(w.shape[3])], dim=3)


def head_bwd_chunked(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor) -> tuple:
    """K-head-bwd at any Co: one launch a chunk of g's channels; dx the sum
    of the chunks' in chunk order, dw their concatenation."""
    if w.shape[3] <= MAX_CO:
        return conv_head_bwd_cuda(x, w, g.contiguous())
    dx, dws = None, []
    for a, b in head_chunks(w.shape[3]):
        d, dw = conv_head_bwd_cuda(x, w[..., a:b], g[..., a:b].contiguous())
        dx = d if dx is None else dx + d
        dws.append(dw)
    return dx, torch.cat(dws, dim=3)


class _ConvHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return head_fwd_chunked(x, w) if x.is_cuda else conv_head_plain(x, w)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        if g.is_cuda:
            return head_bwd_chunked(x, w, g)
        return conv_head_bwd_plain(x, w, g)


def conv_head(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """conv7x7(reflect_pad3(x), w); NHWC x, HWIO w, no bias. Differentiable
    in x and w. x and w are both fp32 (or float64 on the CPU) or both
    bf16; bf16 runs on fp32 copies, each cast counted on ``conv_head.casts``."""
    if not x.is_cuda and x.device.type != "cpu":
        raise ValueError(f"conv_head: unsupported device {x.device}")
    if torch.bfloat16 in (x.dtype, w.dtype):
        if x.dtype != w.dtype:
            raise TypeError(f"conv_head: x is {x.dtype} and w {w.dtype}: a mix of bf16 "
                            f"and another type")
        out = _ConvHead.apply(to_dtype(x, torch.float32, conv_head),
                              to_dtype(w, torch.float32, conv_head))
        return to_dtype(out, torch.bfloat16, conv_head)
    return _ConvHead.apply(x, w)


conv_head.casts = 0


def conv_head_band(x: torch.Tensor, w: torch.Tensor, band) -> torch.Tensor:
    """``conv_head`` of the frame of which the NHWC x is this rank's band
    (``parallel.spatial.Band``, --mesh_spatial): x with its 3 rows above and
    below in place (the neighbours' rows; the frame's reflection at its
    edges), then K-head as it is. K-head reflect-pads what it is given, so
    it computes 3 rows more above and below than the band's, from padding:
    they are dropped, and their gradient is 0, so K-head-bwd's d x of the
    padded band is exact, its rows past the band the halo rows' gradient,
    which the exchange's adjoint sends back to their owners; d w is the
    band's share. Costs 6 rows of the padded band's GEMM rows (~5% at a
    128-row band)."""
    from nemar_tpu_torch.parallel import spatial

    h = x.shape[1]
    three = (3,) * band.size
    xp = spatial.exchange_rows(x, band, three, three, dim=1, mode="reflect")
    return conv_head(xp, w)[:, 3:3 + h]
