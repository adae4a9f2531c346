"""Times of K-warp-bwd, K-block, K-block-bwd, K-convt, K-convt-bwd, K-in,
K-in-bwd, K-head and K-head-bwd at the shapes the model gives them, of the
b1 request and of the b1 and b8 training steps, and the SASS of every
kernel, for one tree of the port.

    python3 nemar_tpu_torch/probe.py [--root DIR] [--parts PART,...]
    python3 nemar_tpu_torch/probe.py --trace-check N

Needs one CUDA device and the CUDA toolkit. Imports ``nemar_tpu_torch``
from ``--root`` (default: the checkout this file lies in), so that another
tree, e.g. a parent commit unpacked by ``git archive``, is measured by the
same code: this checkout's ``chip_smoke.median_ms`` and
``chip_smoke.device_ms`` (which raises unless every traced call shows the
same launches). Two trees are compared by running this alternately in
fresh processes on one card (parent, change, change, parent, ...).
``--parts`` picks the parts below (default: all). Prints one JSON line:

- ``warp_bwd``: the grid-sample backward as the model runs it
  (``torch.autograd.grad`` through ``ops.warp.grid_sample``, 8 x 256 x 256
  x 4, d img for 3 channels, a smooth field of a few pixels): device time
  by kernel in launch order, and ``aten.grid_sampler_2d_backward``'s on the
  same image, grid and g;
- ``block`` and ``block_bwd``: one K-block and one K-block-bwd call at
  8 x 64 x 64 x 256 (the backward fed the plain forward's saved values): the
  median CUDA-event time of 20 calls, and the device time by kernel (12
  launches a call for the backward);
- ``block_bf16``: the bf16 variants on bf16 inputs (x N(0, 1), W N(0,
  0.02^2)): one K-block-bf16 call at 1 and 8 x 64 x 64 x 256, one
  K-block-bwd-bf16 call at 8 x 64 x 64 x 256 (fed the plain forward's saved
  values), and one K-convt-bf16 and K-convt-bwd-bf16 call at each decoder
  stage at batch 1 and 8: the median CUDA-event time of 20 calls and the
  device time by kernel (the same launches in every traced call);
- ``convt``: one K-convt and one K-convt-bwd call at each decoder stage at
  batch 1 and 8 (``chip_smoke.CONVT_SHAPES``; the backward fed the plain
  forward's saved values): the median CUDA-event time of 20 calls, and the
  device time by kernel (the same launches in every traced call);
- ``head``: one K-head and one K-head-bwd call at ``chip_smoke.HEAD_SHAPE``
  at batch 1 and 8 (G's 7x7 head, 256 x 256 x 64 -> 3; the backward's g
  drawn N(0, 1)): the median CUDA-event time of 20 calls, and the device
  time by kernel (the same launches in every traced call), through the
  tree's ``ops.conv_head.conv_head_cuda`` / ``conv_head_bwd_cuda``;
- ``in``: K-in and K-in-bwd called as the autograd Function calls them
  (the tree's ``norm_cuda`` wrappers, or ``norm_triton``'s on a tree before
  them): per call the median CUDA-event time of 20 calls and the device
  time and launches from the profiler, summed over the calls of a b1
  request (K-in at ``chip_smoke.IN_SHAPES``) and of a b8 step (K-in and
  K-in-bwd at ``chip_smoke.IN_BWD_SHAPES``); and the same calls issued
  back to back as the model issues them: their CUDA-event time (median of
  20) and their host time without synchronisation (mean of 20);
- ``request``: the b1 request of ``chip_smoke.py``'s phase 3 (its options,
  seeded checkpoints and batches; set_input -> test ->
  get_current_visuals): the median host time of 20 after 2 warm-up
  requests;
- ``train_step`` and ``train_step_b1``: the b8 and b1 training steps of
  ``chip_smoke.py``'s phase 5 (its options and seeded batches): the median
  host time of 6 steps after 2 warm-up steps, each ending in
  ``torch.cuda.synchronize()``;
- ``train_step_bf16``: ``train_step`` with ``--bf16``;
- ``step_params``: 3 fp32 steps of phase 5's b8 training step from the
  seed (its options and seeded batches), then a sha256 of every
  parameter's bytes (G, D, R in state_dict order) and the losses: two
  trees whose hashes agree train bit for bit alike;
- ``step_bf16_device``: phase 5's b8 training step with ``--bf16``: after
  2 warm-up steps, 3 steps each under the profiler: each step's device
  time (its kernels', memcpys' and memsets' events);
- ``science_bf16``: the science recipe's 256^2 multiscale arm
  (``chip_smoke.py``'s phase 7 options, batch 8, its own synthetic
  batches) in fp32 and with ``--bf16``: the median host time of 4 steps
  after 2 warm-up steps, then one more step under the profiler: device time
  (the kernels', memcpys' and memsets' events), the device's busy share of
  the step, and the 12 largest device times by kernel name;
- ``fit_512``: BASELINE.md config #4's training step (``chip_smoke.py``'s
  phase 11: 512^2 pairs at batch 32, lsgan, fp32) at ``--grad_accum`` 1, 2
  and 4: whether one step fits the card (a CUDA out-of-memory error is
  caught and recorded), and where it does the peak memory
  (``torch.cuda.max_memory_allocated``) and the host time of a second step;
- ``a5_split``: where the A5 step's time goes (``chip_smoke.py``'s phase
  10, 256^2, batch 8): the median host time of 4 steps after 2 warm-up
  steps of phase 5's step, then with ``--grad_accum 2``, then also
  ``--gan_mode wgangp``, then with all of ``chip_smoke.A5_FLAGS``; and the
  WGAN-GP penalty alone at a microbatch of 4 (D's pass over the mix, its
  input gradient with the graph, the penalty's backward into D): its median
  CUDA-event time and its device time by kernel;
- ``sass``: for each kernel of the tree's library, its SASS instructions
  (``cuobjdump -sass``) counted and hashed, so that two trees' lines show
  which kernels compile to the same code;
- the card's name and power limit.

``--trace-check N`` measures the profiler's trace window instead, and
prints one JSON line: for N traces of ten calls of four small kernels with
the window unpadded and N with it padded by 0.05 s
(``chip_smoke.trace_events``), the device events each kept of 40, and for
each complete padded trace the median, least and largest time in
microseconds from a kernel's launch (the runtime's ``cudaLaunchKernel``) to
its start, as the trace places the two.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]


def sass_digest(library: Path, nvcc: str) -> dict:
    """{kernel: [instructions, sha256 prefix]} of the library's SASS. The
    anonymous namespace's mangled name, which hashes the source's path, is
    cut down to the source's name."""
    text = subprocess.run([str(Path(nvcc).with_name("cuobjdump")), "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", text)
    names, digests = [], []
    for name, body in zip(parts[1::2], parts[2::2]):
        code = [" ".join(m.split()) for m in re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", body)]
        names.append(re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_(\w+?_cu)_[0-9a-f]+", r"\1", name))
        digests.append([len(code), hashlib.sha256("\n".join(code).encode()).hexdigest()[:16]])
    if shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                               text=True, check=True).stdout.splitlines()
    return dict(sorted(zip(names, digests)))


def in_kernels(chip_smoke, torch, rng, dev) -> dict:
    """The ``in`` part (see the module's docstring)."""
    import functools
    import importlib

    try:
        mod = importlib.import_module("nemar_tpu_torch.ops.norm_cuda")
        fwd, bwd = mod.instance_norm_act_cuda, mod.instance_norm_act_bwd_cuda
    except ImportError:  # a tree before K-in's CUDA kernels
        mod = importlib.import_module("nemar_tpu_torch.ops.norm_triton")
        fwd, bwd = mod.instance_norm_act_triton, mod.instance_norm_act_bwd_triton
    n = chip_smoke.TRAIN_BATCH
    cells = {"fwd_b1_request": [(fwd, (1, h, w, c), act, calls)
                                for c, h, w, act, calls in chip_smoke.IN_SHAPES],
             "fwd_b8_step": [(fwd, (n * m, h, w, c), act, calls)
                             for c, h, w, act, m, calls in chip_smoke.IN_BWD_SHAPES],
             "bwd_b8_step": [(bwd, (n * m, h, w, c), act, calls)
                             for c, h, w, act, m, calls in chip_smoke.IN_BWD_SHAPES]}
    out = {}
    for cell, calls_of in cells.items():
        total = {"module": mod.__name__, "event_ms": 0.0, "device_ms": 0.0,
                 "launches_per_call": []}
        seq = []
        for fn, shape, act, calls in calls_of:
            x = chip_smoke.randn(rng, shape, 2.0, dev) + 0.5
            if fn is bwd:
                g = chip_smoke.randn(rng, shape, 1.0, dev)
                call = functools.partial(bwd, x, g, fwd(x, act)[1], act)
            else:
                call = functools.partial(fwd, x, act)
            dms, by = chip_smoke.device_ms(call, None, 10)
            total["event_ms"] += calls * chip_smoke.median_ms(call)
            total["device_ms"] += calls * dms
            total["launches_per_call"].append(sum(k for _, k, _ in by))
            seq += [call] * calls

        def run_seq():
            for call in seq:
                call()

        total["seq_event_ms"] = chip_smoke.median_ms(run_seq)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            run_seq()
        total["seq_host_ms"] = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        out[cell] = total
    return out


def request_ms(chip_smoke, torch, reps: int = 20) -> dict:
    """The ``request`` part (see the module's docstring)."""
    import numpy as np
    from nemar_tpu_torch.models import create_model
    from nemar_tpu_torch.options import TestOptions

    with tempfile.TemporaryDirectory(prefix="nemar_probe_") as ckpt:
        opt = TestOptions().parse([*chip_smoke.SLICE_ARGS, "--gpu_ids", "0",
                                   "--checkpoints_dir", ckpt])
        seeded = create_model(opt)
        # a tree from before the multiscale STN has one head, netR.head()
        net = seeded.netR
        head = net.heads()[-1] if hasattr(net, "heads") else net.head()
        with torch.no_grad():  # as phase 3: a field of a few pixels
            head.weight.copy_(1e-3 * torch.randn(head.weight.shape,
                                                 generator=torch.Generator().manual_seed(1)))
        seeded.save_networks("latest")
        del seeded
        model = create_model(opt)
        model.setup(opt)
        model.eval()
        times = []
        for i, b in enumerate(chip_smoke.request_batches(2 + reps, 1, seed=2)):
            t0 = time.perf_counter()
            model.set_input(b)
            model.test()
            model.get_current_visuals()  # copies to the host: synchronises
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
    return {"batch": 1, "ms_median": float(np.median(times)), "ms": times}


def train_step_ms(chip_smoke, torch, batch: int, flags: tuple = (), steps: int = 8) -> dict:
    """The ``train_step`` parts (see the module's docstring): the median
    host time of ``steps`` - 2 steps after 2 warm-up steps, with ``flags``
    added to phase 5's options."""
    import numpy as np

    with tempfile.TemporaryDirectory(prefix="nemar_probe_") as ckpt:
        model = chip_smoke.train_model([*chip_smoke.TRAIN_ARGS, *flags, "--gpu_ids", "0",
                                        "--checkpoints_dir", ckpt, "--batch_size", str(batch)])
        times = []
        for i, b in enumerate(chip_smoke.request_batches(steps, batch, seed=4)):
            t0 = time.perf_counter()
            model.set_input(b)
            model.optimize_parameters()
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
        del model
    return {"batch": batch, "ms_median": float(np.median(times)), "ms": times}


def step_params(chip_smoke, torch, steps: int = 3) -> dict:
    """The ``step_params`` part (see the module's docstring)."""
    with tempfile.TemporaryDirectory(prefix="nemar_probe_") as ckpt:
        model = chip_smoke.train_model([*chip_smoke.TRAIN_ARGS, "--gpu_ids", "0",
                                        "--checkpoints_dir", ckpt,
                                        "--batch_size", str(chip_smoke.TRAIN_BATCH)])
        for b in chip_smoke.request_batches(steps, chip_smoke.TRAIN_BATCH, seed=4):
            model.set_input(b)
            model.optimize_parameters()
        digest = hashlib.sha256()
        for name, net in model.nets().items():
            for key, p in net.state_dict().items():
                digest.update(f"{name}.{key}".encode())
                digest.update(p.detach().cpu().numpy().tobytes())
        losses = model.get_current_losses()
        del model
    return {"steps": steps, "sha256": digest.hexdigest(), "losses": losses}


def science_bf16(chip_smoke, torch) -> dict:
    """The ``science_bf16`` part (see the module's docstring)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, extra in (("fp32", ()), ("bf16", ("--bf16",))):
        with tempfile.TemporaryDirectory(prefix="nemar_probe_") as ckpt:
            model = chip_smoke.train_model([*chip_smoke._science_args("multiscale", ckpt),
                                            *extra])
            batches = chip_smoke._science_batches(model.opt, 7)
            times = []
            for i, b in enumerate(batches[:6]):
                t0 = time.perf_counter()
                model.set_input(b)
                model.optimize_parameters()
                torch.cuda.synchronize()
                if i >= 2:
                    times.append((time.perf_counter() - t0) * 1e3)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                model.set_input(batches[6])
                model.optimize_parameters()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            by = {}
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            device = sum(by.values())
            out[name] = {"ms_median": float(np.median(times)), "ms": times,
                         "profiled_wall_ms": wall, "device_ms": device,
                         "busy_share": device / wall,
                         "top_kernels_ms": sorted(by.items(), key=lambda kv: -kv[1])[:12]}
            del model
    return out


def step_bf16_device(chip_smoke, torch, steps: int = 3) -> dict:
    """The ``step_bf16_device`` part (see the module's docstring)."""
    from torch.profiler import ProfilerActivity, profile

    n = chip_smoke.TRAIN_BATCH
    with tempfile.TemporaryDirectory(prefix="nemar_probe_") as ckpt:
        model = chip_smoke.train_model([*chip_smoke.TRAIN_ARGS, "--bf16", "--gpu_ids", "0",
                                        "--checkpoints_dir", ckpt, "--batch_size", str(n)])
        batches = chip_smoke.request_batches(2 + steps, n, seed=4)
        for b in batches[:2]:
            model.set_input(b)
            model.optimize_parameters()
        torch.cuda.synchronize()
        device = []
        for b in batches[2:]:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                model.set_input(b)
                model.optimize_parameters()
                torch.cuda.synchronize()
            device.append(sum(e.time_range.elapsed_us() / 1e3 for e in prof.events()
                              if e.device_type == torch.autograd.DeviceType.CUDA))
        del model
    return {"batch": n, "device_ms": device}


def fit_512(chip_smoke, torch, k: int) -> dict:
    """The ``fit_512`` part at --grad_accum k (see the module's docstring)."""
    import gc

    args = [*chip_smoke.TRAIN_ARGS, *chip_smoke.B32_ARGS, "--grad_accum", str(k),
            "--gpu_ids", "0"]
    with tempfile.TemporaryDirectory(prefix="nemar_probe_") as ckpt:
        model = chip_smoke.train_model([*args, "--checkpoints_dir", ckpt])
        batch = chip_smoke.request_batches(1, model.opt.batch_size, 12, model.opt.crop_size)[0]
        torch.cuda.reset_peak_memory_stats()
        out = {"grad_accum": k, "fits": True}
        try:
            for step in range(2):
                t0 = time.perf_counter()
                model.set_input(batch)
                model.optimize_parameters()
                torch.cuda.synchronize()
            out["ms"] = (time.perf_counter() - t0) * 1e3
        except torch.cuda.OutOfMemoryError as e:
            out.update(fits=False, step=step, error=str(e).splitlines()[0])
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def a5_split(chip_smoke, torch) -> dict:
    """The ``a5_split`` part (see the module's docstring)."""
    from nemar_tpu_torch.models import networks

    n, a5 = chip_smoke.TRAIN_BATCH, chip_smoke.A5_FLAGS
    variants = {"phase5": (), "grad_accum_2": ("--grad_accum", "2"),
                "grad_accum_2_wgangp": ("--grad_accum", "2", "--gan_mode", "wgangp"), "a5": a5}
    out = {name: train_step_ms(chip_smoke, torch, n, flags, steps=6)
           for name, flags in variants.items()}
    with tempfile.TemporaryDirectory(prefix="nemar_probe_") as ckpt:
        model = chip_smoke.train_model([*chip_smoke.TRAIN_ARGS, *a5, "--gpu_ids", "0",
                                        "--checkpoints_dir", ckpt, "--batch_size", str(n)])
    model.set_input(chip_smoke.request_batches(1, n, seed=4)[0])
    net_d, real, fake = model.netD, model.real_B[: n // 2], model.real_B[n // 2:].flip(3)
    alpha = torch.rand((n // 2, 1, 1, 1), generator=torch.Generator().manual_seed(0)).cuda()
    params = list(net_d.parameters())

    def penalty():
        networks.cal_gradient_penalty(net_d, real, fake, alpha).backward(inputs=params)

    dms, by = chip_smoke.device_ms(penalty, None, 5)
    out["penalty_b4"] = {"event_ms": chip_smoke.median_ms(penalty, iters=10), "device_ms": dms,
                         "by_kernel": by}
    return out


PARTS = ("warp_bwd", "block", "block_bf16", "convt", "head", "in", "request", "train_step_b1",
         "train_step", "train_step_bf16", "step_bf16_device", "step_params", "science_bf16",
         "fit_512", "a5_split", "sass")


def trace_check(chip_smoke, torch, traces: int) -> dict:
    """The ``--trace-check`` line (see the module's docstring)."""
    import numpy as np

    x = torch.zeros(1024, device="cuda")

    def fn():
        for _ in range(4):
            x.add_(1.0)

    fn()
    torch.cuda.synchronize()
    out = {"unpadded_events": [], "padded_events": [], "launch_to_start_us": []}
    for _ in range(traces):
        for key, pad_s in (("unpadded_events", 0.0), ("padded_events", 0.05)):
            events = chip_smoke.trace_events(fn, 10, pad_s)
            device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
            out[key].append(len(device))
            launches = [e for e in events if e.name.startswith("cudaLaunchKernel")]
            if pad_s and len(device) == len(launches) == 40:
                gap = [d.time_range.start - h.time_range.start for h, d in zip(
                    sorted(launches, key=lambda e: e.time_range.start),
                    sorted(device, key=lambda e: e.time_range.start))]
                out["launch_to_start_us"].append(
                    [float(np.median(gap)), float(min(gap)), float(max(gap))])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=CHECKOUT)
    ap.add_argument("--parts", default=",".join(PARTS),
                    help=f"comma-separated parts to measure, of {', '.join(PARTS)}")
    ap.add_argument("--trace-check", type=int, default=0, metavar="N",
                    help="measure the profiler's trace window over N traces and exit")
    args = ap.parse_args()
    parts = args.parts.split(",")
    if not set(parts) <= set(PARTS):
        ap.error(f"unknown parts {sorted(set(parts) - set(PARTS))}")
    sys.path.insert(0, str(CHECKOUT))
    import chip_smoke
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 2
    if args.trace_check:
        print(json.dumps(trace_check(chip_smoke, torch, args.trace_check)), flush=True)
        return 0
    sys.path.insert(0, str(args.root.resolve()))
    from nemar_tpu_torch.ops import _build, conv_fused, convt_fused, warp

    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    n = chip_smoke.TRAIN_BATCH

    out = {"root": str(args.root.resolve())}
    if "warp_bwd" in parts:
        img = chip_smoke.randn(rng, (n, 256, 256, 4), 1.0, dev)
        grid = chip_smoke.smooth_grid(rng, n, 256, 256).to(dev)
        g = chip_smoke.randn(rng, (n, 256, 256, 4), 1.0, dev)
        img_rg, grid_rg = img.clone().requires_grad_(), grid.clone().requires_grad_()
        res = warp.grid_sample(img_rg, grid_rg, "bilinear", "zeros", False, 3)
        img_nchw, g_nchw = img.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        warp_ms, warp_by = chip_smoke.device_ms(
            lambda: torch.autograd.grad(res, (img_rg, grid_rg), g, retain_graph=True), None, 20)
        lib_ms, lib_by = chip_smoke.device_ms(
            lambda: torch.ops.aten.grid_sampler_2d_backward(g_nchw, img_nchw, grid, 0, 0, False,
                                                            [True, True]), None, 20)
        out["warp_bwd"] = {"shape": [n, 256, 256, 4], "grad_channels": 3, "device_ms": warp_ms,
                           "by_kernel": warp_by, "library_device_ms": lib_ms,
                           "library_by_kernel": lib_by}

    if "block" in parts:
        x, gb = (chip_smoke.randn(rng, (n, 64, 64, 256), 1.0, dev) for _ in range(2))
        w1, w2 = (chip_smoke.randn(rng, (3, 3, 256, 256), 0.02, dev) for _ in range(2))
        saved = conv_fused.resblock_fwd_plain(x, w1, w2)[1:]

        def block_bwd():
            return conv_fused.resblock_bwd_cuda(x, w1, w2, *saved, gb)

        event_ms = chip_smoke.median_ms(block_bwd)
        block_ms, block_by = chip_smoke.device_ms(block_bwd, 12, 10)
        block_fwd_ms = chip_smoke.median_ms(lambda: conv_fused.fused_resblock_cuda(x, w1, w2))
        out["block"] = {"shape": [n, 64, 64, 256], "event_ms": block_fwd_ms}
        out["block_bwd"] = {"shape": [n, 64, 64, 256], "event_ms": event_ms,
                            "device_ms": block_ms, "by_kernel": block_by}

    if "block_bf16" in parts:
        bf, timed = torch.bfloat16, {}

        def record(name, fn):
            dms, by = chip_smoke.device_ms(fn, None, 10)
            timed[name] = {"event_ms": chip_smoke.median_ms(fn), "device_ms": dms, "by_kernel": by}

        w1, w2 = (chip_smoke.randn(rng, (3, 3, 256, 256), 0.02, dev).to(bf) for _ in range(2))
        for b in (1, n):
            x = chip_smoke.randn(rng, (b, 64, 64, 256), 1.0, dev).to(bf)
            record(f"K-block-bf16 {b}x64x64x256",
                   lambda: conv_fused.fused_resblock_cuda(x, w1, w2))
        gb = chip_smoke.randn(rng, x.shape, 1.0, dev).to(bf)
        saved = conv_fused.resblock_fwd_plain(x, w1, w2)[1:]
        record(f"K-block-bwd-bf16 {n}x64x64x256",
               lambda: conv_fused.resblock_bwd_cuda(x, w1, w2, *saved, gb))
        for (h, w, ci, co, _), b in ((shape, b) for shape in chip_smoke.CONVT_SHAPES
                                     for b in (1, n)):
            xc = chip_smoke.randn(rng, (b, h, w, ci), 1.0, dev).to(bf)
            wk = chip_smoke.randn(rng, (3, 3, ci, co), 0.02, dev).to(bf)
            gc = chip_smoke.randn(rng, (b, 2 * h, 2 * w, co), 1.0, dev).to(bf)
            saved_c = convt_fused.convt_in_fwd_plain(xc, wk)[1:]
            record(f"K-convt-bf16 {b}x{h}x{w}x{ci}->{co}",
                   lambda: convt_fused.fused_convt_in_cuda(xc, wk))
            record(f"K-convt-bwd-bf16 {b}x{h}x{w}x{ci}->{co}",
                   lambda: convt_fused.convt_in_bwd_cuda(xc, wk, *saved_c, gc))
        out["block_bf16"] = timed

    if "convt" in parts:
        convt = {}
        for (h, w, ci, co, _), b in ((shape, b) for shape in chip_smoke.CONVT_SHAPES
                                     for b in (1, n)):
            xc = chip_smoke.randn(rng, (b, h, w, ci), 1.0, dev)
            wk = chip_smoke.randn(rng, (3, 3, ci, co), 0.02, dev)
            gc = chip_smoke.randn(rng, (b, 2 * h, 2 * w, co), 1.0, dev)
            saved_c = convt_fused.convt_in_fwd_plain(xc, wk)[1:]
            calls = {"fwd": lambda: convt_fused.fused_convt_in_cuda(xc, wk),
                     "bwd": lambda: convt_fused.convt_in_bwd_cuda(xc, wk, *saved_c, gc)}
            for name, fn in calls.items():
                dms, by = chip_smoke.device_ms(fn, None, 10)
                convt[f"{name} {b}x{h}x{w}x{ci}->{co}"] = {
                    "event_ms": chip_smoke.median_ms(fn), "device_ms": dms, "by_kernel": by}
        out["convt"] = convt

    if "head" in parts:
        from nemar_tpu_torch.ops import conv_head

        head = {}
        h, w, ci, co, _ = chip_smoke.HEAD_SHAPE
        for b in (1, n):
            xh = chip_smoke.randn(rng, (b, h, w, ci), 1.0, dev)
            wh = chip_smoke.randn(rng, (7, 7, ci, co), 0.02, dev)
            gh = chip_smoke.randn(rng, (b, h, w, co), 1.0, dev)
            calls = {"fwd": lambda: conv_head.conv_head_cuda(xh, wh),
                     "bwd": lambda: conv_head.conv_head_bwd_cuda(xh, wh, gh)}
            for name, fn in calls.items():
                dms, by = chip_smoke.device_ms(fn, None, 10)
                head[f"{name} {b}x{h}x{w}x{ci}->{co}"] = {
                    "event_ms": chip_smoke.median_ms(fn), "device_ms": dms, "by_kernel": by}
        out["head"] = head

    if "in" in parts:
        out["in"] = in_kernels(chip_smoke, torch, rng, dev)
    if "request" in parts:
        out["request"] = request_ms(chip_smoke, torch)
    if "train_step_b1" in parts:
        out["train_step_b1"] = train_step_ms(chip_smoke, torch, 1)
    if "train_step" in parts:
        out["train_step"] = train_step_ms(chip_smoke, torch, n)
    if "train_step_bf16" in parts:
        out["train_step_bf16"] = train_step_ms(chip_smoke, torch, n, ("--bf16",))
    if "step_params" in parts:
        out["step_params"] = step_params(chip_smoke, torch)
    if "science_bf16" in parts:
        out["science_bf16"] = science_bf16(chip_smoke, torch)
    if "step_bf16_device" in parts:
        out["step_bf16_device"] = step_bf16_device(chip_smoke, torch)
    if "fit_512" in parts:
        out["fit_512"] = [fit_512(chip_smoke, torch, k) for k in (1, 2, 4)]
    if "a5_split" in parts:
        out["a5_split"] = a5_split(chip_smoke, torch)
    if "sass" in parts:
        out["sass"] = sass_digest(_build.library_path(), _build._nvcc())

    out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"],
                                 capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
