"""Several hosts on one machine: the counterpart of
``scripts/multiprocess_smoke.py`` (2 processes x 4 devices over a TCP
coordinator, one NeMAR step on their ('data', 'spatial') mesh).

Starts HOSTS launcher processes, the "hosts", each launching its ranks
(``parallel.launch(hosts=(index, count), init=...)``). The ranks of all
hosts join one group through host 0's TCP store on 127.0.0.1, on a free
port that host 0 passes on. Each rank runs the training loop
(``train._train``) for one step at the JAX script's net: 32^2, global
batch 8, ngf / ndf / stn_ngf 8, --stn_depth 3, --mesh_spatial 2 (a host's
2 ranks are one spatial group), the synthetic set read by ``--loader
grain``: host p reads shard p of its 8 records, one batch of 4 rows, the
global batch's rows 4p..4p+3. Every host builds the same parameters from
the seed. Each rank checks its losses finite; the parent checks every
rank's state (parameters and Adam state, ``state_digest``) equal.

    python -m nemar_tpu_torch.multiprocess_smoke                 # ranks on cuda:0
    python -m nemar_tpu_torch.multiprocess_smoke --gpu_ids -1    # on the CPU

The ranks talk over gloo: on one machine they share its cards, and NCCL
refuses two ranks on one card. Exit 0 = every rank of every host took the
step, with finite losses and equal states.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os
import pickle
import queue
import signal
import sys
import tempfile
import time
import traceback
from typing import Callable, Sequence

import torch

from nemar_tpu_torch import parallel

HOSTS, RANKS = 2, 2
GLOBAL_BATCH = 8
# the JAX script's options (scripts/multiprocess_smoke.py:45-52), one epoch
# of one step: each host's shard is one batch
NET = ["--model", "nemar", "--dataset_mode", "synthetic", "--synthetic_size",
       str(GLOBAL_BATCH), "--crop_size", "32", "--load_size", "32", "--batch_size",
       str(GLOBAL_BATCH), "--ngf", "8", "--ndf", "8", "--stn_ngf", "8", "--stn_depth", "3",
       "--mesh_spatial", "2", "--loader", "grain", "--num_threads", "2",
       "--n_epochs", "1", "--n_epochs_decay", "0", "--display_freq", "0", "--print_freq", "0",
       "--save_latest_freq", "0", "--save_epoch_freq", "0"]


def run_hosts(fn: Callable, devs: Sequence, args: tuple = (), hosts: int = HOSTS,
              backend: str | None = None, timeout: float = 600.0,
              pg_timeout: float = 300.0) -> list:
    """Run ``fn(*args)`` on ``hosts`` hosts of this machine, each a
    launcher process of its own with one rank per device of ``devs``, all
    in one group over host 0's TCP store; -> each host's ranks' values,
    in host order. A host that fails ends the others and makes this raise,
    with its traceback. Every process started here is ended before it
    returns."""
    ctx = torch.multiprocessing.get_context("spawn")
    results, port_q = ctx.Queue(), ctx.Queue()

    def start(index, init):
        p = ctx.Process(target=_host_main, name=f"host{index}",
                        args=(index, hosts, init, port_q, results, fn, list(devs), args,
                              backend, timeout, pg_timeout))
        p.start()
        return p

    procs = []
    out: list = [None] * hosts
    try:
        procs.append(start(0, None))
        port = port_q.get(timeout=120.0)
        procs += [start(h, f"tcp://127.0.0.1:{port}") for h in range(1, hosts)]
        deadline = time.monotonic() + timeout + 60.0
        pending = set(range(hosts))
        while pending:
            try:
                h, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                gone = [h for h in pending if procs[h].exitcode not in (None, 0)]
                if gone:
                    raise RuntimeError(f"run_hosts: host {gone[0]} exited with code "
                                       f"{procs[gone[0]].exitcode} without a result")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"run_hosts: hosts {sorted(pending)} did not finish")
                continue
            if not ok:
                raise RuntimeError(f"run_hosts: host {h} failed:\n{payload}")
            out[h] = pickle.loads(payload)
            pending.discard(h)
    finally:
        for p in procs:
            p.join(timeout=30.0)
            if p.is_alive():  # its launcher ends its ranks on SIGTERM
                p.terminate()
                p.join(timeout=30.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        results.close()
        port_q.close()
    return out


def _host_main(index: int, count: int, init, port_q, results, fn, devs, args, backend,
               timeout, pg_timeout) -> None:
    """One host: its launcher (host 0 opens the store and passes its port
    on); sends back (host, ok, its ranks' values or a traceback)."""
    # a terminated host still ends its ranks (launch's finally)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(1))
    try:
        if index == 0:
            init = parallel.host_store("127.0.0.1", 0, pg_timeout)
            port_q.put(init.port)
        ranks = parallel.launch(fn, devs, backend=backend, args=args, timeout=timeout,
                                pg_timeout=pg_timeout, hosts=(index, count), init=init)
        results.put((index, True, pickle.dumps(ranks)))
    except BaseException:
        results.put((index, False, traceback.format_exc()))
        sys.exit(1)


def smoke_rank(opt, dtype: torch.dtype | None = None, keep_params: bool = False) -> dict:
    """One rank of the smoke: the training loop (one step), its losses
    checked finite; -> rank, host, state digest, losses and step, and with
    ``keep_params`` at global rank 0 the parameters (on the host)."""
    from nemar_tpu_torch import train
    from nemar_tpu_torch.models.base_model import state_digest, to_host

    parallel.set_mesh(opt.mesh_spatial)
    with contextlib.ExitStack() as stack:
        if parallel.rank() != 0:
            stack.enter_context(contextlib.redirect_stdout(
                stack.enter_context(open(os.devnull, "w"))))
        model = train._train(opt, dtype)
    losses = model.get_current_losses()
    bad = {k: v for k, v in losses.items() if not math.isfinite(v)}
    if bad:
        raise AssertionError(f"rank {parallel.rank()}: non-finite losses {bad}")
    out = {"rank": parallel.rank(), "host": parallel.host(), "digest": state_digest(model),
           "losses": losses, "step": model.step}
    if keep_params and parallel.rank() == 0:
        out["params"] = {n: {k: to_host(p) for k, p in net.named_parameters()}
                         for n, net in model.nets().items()}
    return out


def smoke_devices(gpu_ids: str, ranks: int) -> list:
    """A host's devices: ``ranks`` CPU ranks, or the cards of ``gpu_ids``
    in turn."""
    ids = [int(i) for i in gpu_ids.split(",") if int(i) >= 0]
    if not ids:
        return [torch.device("cpu")] * ranks
    return [torch.device("cuda", ids[r % len(ids)]) for r in range(ranks)]


def smoke(gpu_ids: str = "0", ranks: int = RANKS, hosts: int = HOSTS, extra: Sequence = (),
          dtype: torch.dtype | None = None, keep_params: bool = False,
          timeout: float = 600.0) -> list:
    """The smoke's step over ``hosts`` x ``ranks`` (``extra``: more training
    options, after NET's); -> every rank's ``smoke_rank`` value, in global
    rank order, once their states are checked equal."""
    from nemar_tpu_torch.options import TrainOptions

    with tempfile.TemporaryDirectory(prefix="nemar_hosts_") as ckpt:
        with contextlib.redirect_stdout(open(os.devnull, "w")):
            opt = TrainOptions().parse([*NET, "--gpu_ids", gpu_ids, "--checkpoints_dir", ckpt,
                                        "--name", "hosts", *extra])
        devs = smoke_devices(gpu_ids, ranks)
        parallel.check_mesh(opt.mesh_spatial, ranks, hosts)
        out = [r for host in run_hosts(smoke_rank, devs, args=(opt, dtype, keep_params),
                                       hosts=hosts, backend="gloo", timeout=timeout)
               for r in host]
    digests = {r["digest"] for r in out}
    if len(digests) != 1 or any(r["step"] != 1 for r in out):
        raise AssertionError(f"the ranks' states differ: {[(r['rank'], r['step'], r['digest'])
                                                              for r in out]}")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--gpu_ids", default="0", help="cards of each host's ranks; -1: CPU")
    a = parser.parse_args(argv)
    if a.gpu_ids != "-1" and not torch.cuda.is_available():
        print("multiprocess_smoke: no CUDA device (pass --gpu_ids -1 for the CPU)",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    out = smoke(a.gpu_ids)
    for r in out:
        print(f"[host {r['host']} rank {r['rank']}] step ok: {r['losses']}", flush=True)
    print(f"multiprocess smoke: OK ({HOSTS} hosts x {RANKS} ranks, equal states "
          f"{out[0]['digest'][:16]}, {time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
