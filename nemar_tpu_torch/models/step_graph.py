"""--steps_per_execution on the card: the NeMAR training step as one CUDA
graph, replayed once per batch of a chunk.

The JAX package runs a chunk of k steps in one dispatch (``lax.scan`` in
``nemar_tpu/models/nemar_model.py:_train_scan_impl``), which kills the
host's dispatch latency. The Hopper counterpart captures one step in a
``torch.cuda.CUDAGraph`` and replays it k times: a replay launches the
step's few hundred kernels in one call, and a chunk performs no host
synchronisation.

``Chunk`` puts a chunk on the device: the batches stacked on the host and
copied in one copy from pinned memory, and the chunk's draws (the pool's
and the penalty's, drawn on the host from the model's CPU generator in
the order k steps draw them, so the card draws what the CPU draws) in one
copy per kind. ``StepGraph`` holds what a captured step reads and writes
besides the model's own tensors: the static inputs (real_A and real_B as
NCHW views of NHWC memory, the strides ``to_device_nchw`` gives, so the
kernels take the routes they take step by step), one step's draws, the GAN
weight and R's gate as device scalars, and the losses' sums. Before each
step the step's slice of the chunk is copied into them on the device.

Every tensor of the model that the step writes is written in place (the
parameters, Adam's moments, step counts and lr, which are device tensors
under ``capturable`` Adam, the pool and the EMA shadows), so a replay
writes to the addresses the capture saw. A graph is captured against those
tensors, and is captured again when one of them has been replaced (a load,
new optimizers). The first step at a new shape, or after such a
replacement, runs eagerly on a side stream (Adam makes its state, and the
lazy set-ups of the kernels' wrappers and of cuDNN happen outside the
capture); the next is captured and then replayed (a capture executes
nothing); the rest are replayed. Each step of a chunk is taken exactly
once. A capture or a replay that fails raises: no step falls back to an
eager one. On the CPU the same steps run eagerly on the same buffers.

In a data-parallel run over NCCL the step's collectives (the gradients'
all-reduces, the pool's gather) are captured with it and replayed; the
communicator exists by then, made by the eager first step. Under
--mesh_spatial the step is the band step on each batch's band, and its
exchanges, all-gathers on the spatial group, are captured alike (a run
on two or more cards, which no check here has run yet). gloo's
collectives cannot be captured: a graph in a gloo group is refused, it
does not fall back to eager steps.
"""

from __future__ import annotations

import numpy as np
import torch

from nemar_tpu_torch import parallel


class Chunk:
    """A chunk's batches and draws on the device. ``a``, ``b``: (k, N, H,
    W, C) in the parameters' dtype, this rank's rows and, under
    --mesh_spatial, its band of them (H the band's rows); ``draws``: one
    (k, ...) tensor per draw a step takes, in the order it takes them. An
    empty batch or draw is not pinned (nothing to copy)."""

    def __init__(self, batches: list, draws: list, device: torch.device, dtype: torch.dtype):
        self.n = len(batches)
        shapes = [(self.n, *np.shape(batches[0][k])) for k in ("A", "B")]
        sizes = [int(np.prod(s)) for s in shapes]
        pin = device.type == "cuda" and sum(sizes) > 0
        host = torch.empty(sum(sizes), dtype=torch.float32, pin_memory=pin)
        flat = host.numpy()
        for key, shape, lo, size in zip(("A", "B"), shapes, (0, sizes[0]), sizes):
            np.stack([np.asarray(bt[key], np.float32) for bt in batches],
                     out=flat[lo:lo + size].reshape(shape))
        dev = host.to(device, non_blocking=pin)
        self.a = dev[:sizes[0]].view(shapes[0]).to(dtype)
        self.b = dev[sizes[0]:].view(shapes[1]).to(dtype)
        stacked = [torch.stack(col) for col in zip(*draws)]
        cuda = device.type == "cuda"
        self.draws = [(t.pin_memory() if cuda and t.numel() else t).to(
            device, non_blocking=cuda and t.numel() > 0) for t in stacked]

    def key(self) -> tuple:
        """What a graph of the step depends on: the shapes and dtypes of one
        step's inputs and draws (a band's rows among them; the model adds
        the band itself)."""
        return tuple((tuple(t.shape[1:]), t.dtype) for t in (self.a, self.b, *self.draws))

    def last(self) -> tuple:
        """The last batch's real_A, real_B (NCHW views, as ``set_input``)."""
        return self.a[-1].permute(0, 3, 1, 2), self.b[-1].permute(0, 3, 1, 2)


def _captured(model) -> list:
    """The model's tensors a captured step reads or writes in place, with
    their addresses: the parameters, each optimizer with its lr and state,
    the pool and the EMA shadows."""
    objs = [p for net in model.nets().values() for p in net.parameters()]
    for optimizer in model.optimizers.values():
        objs.append(optimizer)
        for group in optimizer.param_groups:
            objs.append(group["lr"])
            for p in group["params"]:
                objs.extend(optimizer.state[p].values())
    if model.pool is not None:
        objs.extend(model.pool)
    if model.ema is not None:
        objs.extend(t for shadow in model.ema.values() for t in shadow.values())
    return [(o, o.data_ptr() if isinstance(o, torch.Tensor) else None) for o in objs]


def _same(a: list | None, b: list) -> bool:
    return a is not None and len(a) == len(b) and all(
        x is y and p == q for (x, p), (y, q) in zip(a, b))


class StepGraph:
    """One chunk shape's static buffers and, on the card, its graph."""

    def __init__(self, model, chunk: Chunk, dtype: torch.dtype):
        dev = model.device
        self.a = torch.empty(chunk.a.shape[1:], dtype=dtype, device=dev)
        self.b = torch.empty(chunk.b.shape[1:], dtype=dtype, device=dev)
        self.draws = [torch.empty(d.shape[1:], dtype=d.dtype, device=dev) for d in chunk.draws]
        self.gan_scale = torch.zeros((), dtype=dtype, device=dev)
        self.r_gate = torch.zeros((), dtype=dtype, device=dev)
        self.sums = {k: torch.zeros((), dtype=dtype, device=dev) for k in model.loss_names}
        self.graph = None
        self.captured = None  # _captured(model) when the graph was captured
        self.warm = None  # the same after the eager step before the capture

    def run(self, model, chunk: Chunk, gan_scale: float, r_gate: float, graph: bool) -> dict:
        """A step on each batch of ``chunk`` -> the mean losses. ``graph``:
        the steps are replays of the captured step (the card)."""
        if graph and parallel.backend() == "gloo":
            raise NotImplementedError(
                "--steps_per_execution on the card in a gloo process group: gloo's "
                "collectives cannot be captured in a CUDA graph (run the ranks over NCCL)")
        self.gan_scale.fill_(gan_scale)
        self.r_gate.fill_(r_gate)
        for s in self.sums.values():
            s.zero_()
        for i in range(chunk.n):
            self.a.copy_(chunk.a[i])
            self.b.copy_(chunk.b[i])
            for dst, src in zip(self.draws, chunk.draws):
                dst.copy_(src[i])
            if graph:
                self._graph_step(model)
            else:
                self.step(model)
        return {k: s / chunk.n for k, s in self.sums.items()}

    def step(self, model) -> None:
        """The model's step on the static buffers, its losses added into
        the sums."""
        slots = iter(self.draws)
        model._slots = slots
        try:
            losses = model._train_step(self.a.permute(0, 3, 1, 2), self.b.permute(0, 3, 1, 2),
                                       self.gan_scale, self.r_gate)
        finally:
            model._slots = None
        if next(slots, None) is not None:
            raise RuntimeError("the step took fewer draws than were drawn for it")
        for k, v in losses.items():
            self.sums[k].add_(v)

    def _graph_step(self, model) -> None:
        now = _captured(model)
        if self.graph is not None and _same(self.captured, now):
            self.graph.replay()
            return
        if not _same(self.warm, now):
            # the first step here: eagerly, on a side stream, as a capture
            # wants; Adam makes its state in it
            self.graph = None
            main = torch.cuda.current_stream(model.device)
            side = torch.cuda.Stream(model.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                self.step(model)
            main.wait_stream(side)
            self.warm = _captured(model)
            return
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.step(model)
        self.graph, self.captured = graph, now
        graph.replay()
