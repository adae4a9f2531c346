"""Data parallelism over several devices: the counterpart of
``nemar_tpu/parallel/mesh.py`` (``make_mesh``, ``shard_batch``,
``replicate``), one process per device.

The JAX package runs one SPMD program over a ('data',) mesh: ``--batch_size``
is the GLOBAL batch, split over 'data' by ``shard_batch`` (a batch the axis
does not divide is replicated), the parameters are replicated, and XLA
inserts the gradient psum. Every sharded quantity is a quantity of the
global batch: the losses are means over it, batch norm normalises over it,
the image pool is one global state, ``--grad_accum`` splits it into
contiguous global microbatches. The port keeps those semantics, so a run
over W ranks equals the one-process run on the same global batch:

  * ``launch`` starts one process per device (``torch.multiprocessing``,
    spawn), each in one process group (NCCL on CUDA, gloo on the CPU) whose
    rendezvous is a ``file://`` store in a fresh temporary directory (no
    TCP port is chosen, so concurrent launches cannot collide), with a
    timeout, so a rank that hangs in a collective fails;
  * every rank builds the same model from the same seed and reads the same
    global batch stream; ``shard_rows`` keeps its rows;
  * ``all_reduce_grads`` averages the gradients at the points where the JAX
    step has its psum; ``all_gather_rows`` and ``sum_over_ranks`` give the
    pool its global batch and batch norm its global statistics
    (``models/networks.py``); ``mean_over_ranks`` the reported losses.

Explicit all-reduces, not ``DistributedDataParallel``: DDP reduces from
hooks that fire during the backward. That clashes with the NeMAR step's
order (D's step before G+R's backward, D frozen there), with WGAN-GP's
double backward (``autograd.grad(create_graph=True)`` through D would fire
D's hooks), with ``--grad_accum`` (it would need ``no_sync`` on all but the
last microbatch), with the capture of the step as one CUDA graph (hooks and
buckets made lazily) and with the checkpoints' layout (DDP's ``module.``
prefix). Here each reduction is one flat buffer in the parameters' fixed
order, the same on every rank and deterministic at a fixed world size.
Overlapping it with the backward is left for later.

Outside ``launch`` there is no process group: ``world()`` is 1 and every
function here is the identity, so a one-process run is the code path it
was before. Inside one, ``world()`` may still be 1 (one device through
NCCL): then the gradients and losses go through the collective (a copy)
and batch norm, dropout and the pool take their one-process paths.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import shutil
import sys
import tempfile
import time
import traceback
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

# the device ``launch`` gave this process (None outside a launch)
_device: torch.device | None = None


def initialized() -> bool:
    """Whether this process is a rank of a process group."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world() -> int:
    return dist.get_world_size() if initialized() else 1


def device() -> torch.device | None:
    """The device ``launch`` gave this rank, or None outside a launch."""
    return _device


def backend() -> str | None:
    return dist.get_backend() if initialized() else None


def devices(opt) -> list:
    """The devices of a run: ``cuda:k`` for each of --gpu_ids (which the
    options have already cut to --num_devices), or, with --gpu_ids -1,
    max(1, --num_devices) ranks on the CPU (the counterpart of the JAX
    package's --num_devices on its virtual CPU devices)."""
    if opt.gpu_ids:
        return [torch.device("cuda", i) for i in opt.gpu_ids]
    return [torch.device("cpu")] * max(1, getattr(opt, "num_devices", -1))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def launch(fn: Callable, devs: Sequence, backend: str | None = None, args: tuple = (),
           timeout: float | None = None, pg_timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` in one process per device of ``devs`` (a rank each,
    in that order), all in one process group; -> the ranks' return values,
    in rank order (they must pickle: host objects, no CUDA tensors).

    ``backend``: NCCL when the devices are CUDA devices, gloo on the CPU
    (either may be named; gloo also takes CUDA tensors). ``fn`` is pickled
    by its import path. The kernels are built here once, before the ranks
    start, so W ranks do not run W builds. A rank that raises makes this
    raise, with its traceback, and the other ranks are terminated;
    ``timeout`` bounds the whole launch (None: no bound) and ``pg_timeout``
    every collective. Every process started here is ended before it
    returns."""
    devs = [torch.device(d) for d in devs]
    if not devs:
        raise ValueError("launch: no devices")
    cuda = any(d.type == "cuda" for d in devs)
    if cuda:
        if not torch.cuda.is_available():
            raise RuntimeError(f"launch on {devs}: torch.cuda.is_available() is False")
        from nemar_tpu_torch.ops import _build

        _build.build()
    backend = backend or ("nccl" if cuda else "gloo")
    n = len(devs)
    # the CPU ranks share the host's cores
    threads = max(1, torch.get_num_threads() // n)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="nemar_launch_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                         args=(r, n, devs[r], backend, init, pg_timeout, threads, fn, args,
                               results))
             for r in range(n)]
    out: list = [None] * n
    try:
        for p in procs:
            p.start()
        pending = set(range(n))
        deadline = None if timeout is None else time.monotonic() + timeout
        gone: dict = {}  # rank -> when it was first seen exited without a result
        while pending:
            try:
                r, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                now = time.monotonic()
                for r in sorted(pending):
                    code = procs[r].exitcode
                    if code is None:
                        continue
                    # a rank's result (or its traceback) may still be in
                    # flight just after it exits
                    if now - gone.setdefault(r, now) > (30.0 if code == 0 else 5.0):
                        raise RuntimeError(f"launch: rank {r} exited with code {code} "
                                           f"without a result")
                if deadline is not None and now > deadline:
                    raise TimeoutError(f"launch: ranks {sorted(pending)} did not finish "
                                       f"within {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"launch: rank {r} raised:\n{payload}")
            out[r] = pickle.loads(payload)
            pending.discard(r)
        for p in procs:
            p.join(timeout=60.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _rank_main(r: int, n: int, dev: torch.device, backend: str, init: str, pg_timeout: float,
               threads: int, fn: Callable, args: tuple, results) -> None:
    """One rank: join the group, run fn, send back (rank, ok, result or
    traceback)."""
    global _device
    code = 0
    try:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(threads)
        dist.init_process_group(backend, init_method=init, world_size=n, rank=r,
                                timeout=datetime.timedelta(seconds=pg_timeout))
        _device = dev
        # pickled here, by value: a tensor through the queue itself would be
        # shared memory that this process's exit takes away
        results.put((r, True, pickle.dumps(fn(*args))))
    except BaseException:  # reported to the launcher, which raises
        results.put((r, False, traceback.format_exc()))
        code = 1
    finally:
        if initialized():
            dist.destroy_process_group()
    if code:
        sys.exit(code)


# ---------------------------------------------------------------------------
# the global batch
# ---------------------------------------------------------------------------


def sharded(n: int) -> bool:
    """Whether a global (micro)batch of n rows is split over the ranks: W
    divides it, as the JAX package's ``shard_batch`` asks; otherwise each
    rank holds all of it (replicated)."""
    w = world()
    return w > 1 and n % w == 0


def rows_in(n: int) -> slice:
    """This rank's rows of a global (micro)batch of n rows."""
    if not sharded(n):
        return slice(0, n)
    s = n // world()
    return slice(rank() * s, (rank() + 1) * s)


def shard_slices(n: int, k: int = 1) -> list:
    """This rank's rows of a global batch of n rows taken as k contiguous
    microbatches (--grad_accum), one slice per microbatch: the rank's shard
    of each, or all of a microbatch that W does not divide."""
    if n % k:
        raise ValueError(f"--grad_accum {k} must divide the batch of {n}")
    m = n // k
    return [slice(j * m + s.start, j * m + s.stop) for j in range(k) for s in (rows_in(m),)]


def shard_rows(batch: dict, k: int = 1) -> dict:
    """This rank's rows of a global batch (a dict of NHWC numpy arrays and
    per-row lists): for each of its k microbatches the rank's shard,
    concatenated, so ``torch.chunk(local, k)`` gives the rank's shard of
    each global microbatch. Values without the batch's rows pass through."""
    if world() == 1:
        return batch
    n = len(batch["A"])
    slices = shard_slices(n, k)
    out = {}
    for key, v in batch.items():
        if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == n:
            out[key] = np.concatenate([v[s] for s in slices])
        elif isinstance(v, list) and len(v) == n:
            out[key] = [x for s in slices for x in v[s]]
        else:
            out[key] = v
    return out


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def all_reduce_grads(params: Sequence[torch.Tensor]) -> None:
    """Average the gradients of ``params`` over the ranks, in place: one
    flat buffer in the parameters' order, SUM, then divided by W. A None
    grad counts as zeros, so every rank reduces the same layout, and stays
    None (every rank runs the same step, so it is None on every rank: the
    fused blocks' inert biases). Nothing here waits for the device, so a
    CUDA graph can capture it. A no-op outside a process group. Each call
    counts on ``all_reduce_grads.calls`` (a graph's replays run none)."""
    if not initialized():
        return
    all_reduce_grads.calls += 1
    params = list(params)
    flat = torch.cat([p.grad.reshape(-1) if p.grad is not None
                      else torch.zeros(p.numel(), dtype=p.dtype, device=p.device)
                      for p in params])
    dist.all_reduce(flat)
    flat.div_(world())
    offset = 0
    for p in params:
        if p.grad is not None:
            p.grad.copy_(flat[offset:offset + p.numel()].view_as(p))
        offset += p.numel()


all_reduce_grads.calls = 0


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's x (the same shape on each) concatenated along dim 0 in
    rank order: the global batch of a sharded one. No gradient."""
    if world() == 1:
        return x
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(world())]
    dist.all_gather(parts, x)
    return torch.cat(parts)


def sum_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the ranks, differentiable: its backward sums the
    incoming gradients over the ranks in turn, so a quantity of the global
    batch (batch norm's statistics) gets the gradient of the global
    loss, the ranks' mean of their losses, once ``all_reduce_grads`` has
    averaged the parameters' gradients."""
    if world() == 1:
        return x
    return _SumOverRanks.apply(x)


class _SumOverRanks(torch.autograd.Function):
    """SUM all-reduce whose backward is the same all-reduce of the incoming
    gradient (itself differentiable: WGAN-GP's double backward through a
    batch norm goes through it twice)."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, g):
        return _SumOverRanks.apply(g)


def mean_over_ranks(values: dict) -> dict:
    """{name: scalar tensor or float} -> {name: float}, each the mean over
    the ranks (every rank calls it with the same names)."""
    names = list(values)
    if not initialized() or not names:
        return {k: float(values[k]) for k in names}
    dev = _device if _device is not None else torch.device("cpu")
    t = torch.stack([torch.as_tensor(values[k], dtype=torch.float64).reshape(()).to(dev)
                     for k in names])
    dist.all_reduce(t)
    t = (t / world()).cpu()
    return {k: float(t[i]) for i, k in enumerate(names)}
