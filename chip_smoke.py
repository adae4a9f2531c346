#!/usr/bin/env python3
"""Smoke run of nemar_tpu_torch on one NVIDIA card (H100): build, check, time.

    python3 chip_smoke.py            # from the repository root; needs one CUDA device

Drives the port's inference path and its training step — NeMAR's default
model at full width and 256^2 (ResNet-6 G at ngf 64, depth-5 UNet STN at
stn_ngf 32, 70x70 PatchGAN D at ndf 64) — through the entry points a user
calls, and prints one line per phase. Any failure raises and the exit code
is not 0.

  0. environment: versions, the card, ``nvidia-smi``'s name and power limit;
  1. build: one nvcc per nemar_tpu_torch/csrc/*.cu, all at once, then a
     link (Triton compiles K-in and K-in-bwd at their first launch);
  2. each forward kernel (K-warp, K-in, K-block, K-head, K-convt) against
     its plain PyTorch version on the card, at the slice's shapes, with
     TF32 off: max abs error against the stated tolerance, the median
     CUDA-event time of kernel and plain version, the time of the one
     PyTorch call that computes the same function where there is one
     (F.grid_sample for K-warp, nn.Conv2d(padding_mode='reflect') for
     K-head), and the kernel's bound on this card. K-warp is timed as the
     model calls it, ops/warp.grid_sample from the normalised grid, call by
     call in alternation with F.grid_sample on the same grid (and with
     the kernel through grid_sample's autograd.Function,
     ``autograd_fn_ms``), and both by their device time from torch.profiler
     (``device_ms``: the host's cost is the difference; a trace that misses
     a launch is taken again, then fails the run);
  2b. each backward kernel likewise, at the training step's shapes (batch
     8); K-block-bwd and K-convt-bwd are fed the plain forward's saved
     values, and their comparison with their own forward's is shown beside.
     K-warp-bwd's library time is aten.grid_sampler_2d_backward's on the
     same image, grid and g. K-block-bwd and K-convt-bwd (and in phase 2
     K-block and K-convt), whose GEMMs run in 3xTF32 on the tensor cores,
     also print their TFLOP/s, their tensor-core bound ``tc_bound_ms``
     (their fp32 products x 3 at 495 TFLOP/s TF32) beside the fp32
     ``bound_ms``, their device time per launch from the profiler (the
     launches of each traced call asserted), and their largest relative
     error against the plain version run in float64, which must be at most
     4x the fp32 plain version's. Beside K-convt and K-convt-bwd, cuDNN's
     transposed convolution at the same shapes (forward, and backward to
     dx and dw; deterministic, TF32 off) is timed as a yardstick for their
     GEMMs;
  3. the inference slice: options parsed as ``nemar_tpu_torch.test`` parses
     them (``--gpu_ids 0``), seeded checkpoints written (the flow head drawn
     non-zero, so the warp samples between pixels) and loaded by
     ``setup()``, then 8 requests of batch 1 (set_input -> test ->
     get_current_visuals + the registration metrics). The launch counters
     are zeroed just before and must show K-block 12, K-warp 1, K-in 16,
     K-head 2 and K-convt 4 launches per request and no backward launch. Then the same model at
     batch 8, and a torch.profiler pass over 3 batch-1 requests
     (chiprun_out/profile_b1.txt, and the device's busy share);
  4. card against CPU: the same checkpoints on a CPU model (the plain
     path), one request, outputs and flow within 1e-3;
  5. the training slice: options parsed as ``nemar_tpu_torch.train`` parses
     them, batch 8, seeded synthetic batches; 2 warm-up steps, then 6
     counted steps with the counters zeroed just before: ms per step,
     pairs/s, the launches per step of all ten kernels (asserted), finite
     losses, and the zero-initialised flow head must have moved; a
     torch.profiler pass over 2 steps (chiprun_out/profile_train_b8.txt,
     and the device's busy share); then 6 more steps with cuDNN's default
     (non-deterministic) algorithms, for what determinism costs;
  5b. one batch-1 step each with the default flags, ``--block_impl
     pallas_all`` and ``--c7_impl roll``: each flag is accepted, launches
     the same kernels per step, and gives bit-identical losses;
  6. card against CPU for one training step on a 256^2 batch-1 pair, from
     one shared state (phase 5's checkpoint, saved before its
     non-deterministic steps, and Adam moments): the seven losses within
     1e-4 relative, every gradient within max(1e-3, 3 x the step's own
     conditioning baseline) (‖Δg‖/‖g‖), the updated parameters within 1e-5
     (with the Adam caveat of tests/test_torch_nemar_train.py); see
     ``compare_train_with_cpu``. Then two fresh, identical two-step runs on
     the card, which must give bit-identical losses and parameters.

The line before the last is a JSON object with one entry per kernel. For a
forward kernel, ``ms``/``plain_ms``/``library_ms`` are the kernel's, the
plain version's and the library call's device time for one inference
request at batch 1, summed over that request's calls, and ``bound_ms`` the
least time the card could take for the same calls (the larger of their
fp32 operations at 67 TFLOP/s and their bytes at 3.35 TB/s, the H100 SXM's
peaks at 700 W; ``bound_by`` says which); for a backward kernel, the same
for one training step at batch 8. ``launches`` counts phase 3's requests
(forward kernels) or phase 5's steps (backward kernels). The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
REQUESTS = 8
SLICE_ARGS = [
    "--model", "nemar", "--netG", "resnet_6blocks", "--ngf", "64", "--ndf", "64",
    "--stn_type", "unet", "--stn_ngf", "32", "--stn_depth", "5",
    "--input_nc", "1", "--output_nc", "3", "--crop_size", "256", "--load_size", "256",
    "--norm", "instance", "--stn_field_source", "pair", "--dataset_mode", "synthetic",
    "--name", "smoke", "--eval_registration",
]
# (C, H, W, act, calls per request) of every instance norm K-in runs: G's
# encoder (its decoder's are K-convt's), the STN
IN_SHAPES = [
    (64, 256, 256, "relu", 2), (128, 128, 128, "relu", 2), (256, 64, 64, "relu", 2),  # G x2
    (32, 128, 128, "leaky_relu", 2), (64, 64, 64, "leaky_relu", 2),                   # STN
    (128, 32, 32, "leaky_relu", 2), (256, 16, 16, "leaky_relu", 2),
    (256, 8, 8, "leaky_relu", 1), (32, 256, 256, "leaky_relu", 1),
]
# (H, W, Ci, Co, calls per request / step) of G's decoder stages (K-convt)
# and its 7x7 head (K-head), two G passes each
CONVT_SHAPES = [(64, 64, 256, 128, 2), (128, 128, 128, 64, 2)]
HEAD_SHAPE = (256, 256, 64, 3, 2)
TOL = {"K-warp": 1e-5, "K-in": 1e-5, "K-block": 1e-3, "K-head": 1e-4, "K-convt": 1e-4,
       # backward tolerances, relative to the largest reference value: the
       # warp's and IN's are fp32 roundoff of short sums; the block's that of
       # four 2304-deep GEMMs summed over up to 32768 pixels around two IN
       # backwards; the head's and the decoder's weight gradients are sums
       # over up to 524288 pixels, merged in fp64 across tiles / splits
       "K-warp-bwd": 1e-5, "K-in-bwd": 1e-5, "K-block-bwd": 1e-3,
       "K-head-bwd": 1e-4, "K-convt-bwd": 1e-4}
# the H100's peaks (NVIDIA's data sheet, SXM, 700 W): fp32 outside the
# tensor cores, and device memory; each kernel's bound is the larger of its
# operations over the first and its bytes over the second
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# TF32 on the tensor cores (dense), for K-block-bwd's 3xTF32 GEMMs: three
# TF32 products per fp32 product
PEAK_TF32_FLOPS = 495e12
# phase 6's conditioning baseline: the CPU step again with real_A scaled by
# 1 + PERTURB, about how far the card's activations sit from the CPU's
# (phase 4: up to 6.5e-5 absolute on outputs in [-1, 1])
PERTURB = 1e-5
TRAIN_BATCH = 8
TRAIN_STEPS = 6
TRAIN_ARGS = [
    "--model", "nemar", "--netG", "resnet_6blocks", "--ngf", "64", "--ndf", "64",
    "--stn_type", "unet", "--stn_ngf", "32", "--stn_depth", "5",
    "--input_nc", "1", "--output_nc", "3", "--crop_size", "256", "--load_size", "256",
    "--norm", "instance", "--stn_field_source", "pair", "--dataset_mode", "synthetic",
    "--name", "smoke_train",
]
# (C, H, W, act, batch multiple, calls per step) of every instance norm
# backward K-in-bwd runs in a training step: G's encoder in two passes, the
# STN, D in the D step (one pass over [real; fake], twice the batch) and D
# in the G step
IN_BWD_SHAPES = [
    (64, 256, 256, "relu", 1, 2), (128, 128, 128, "relu", 1, 2), (256, 64, 64, "relu", 1, 2),
    (32, 128, 128, "leaky_relu", 1, 2), (64, 64, 64, "leaky_relu", 1, 2),
    (128, 32, 32, "leaky_relu", 1, 2), (256, 16, 16, "leaky_relu", 1, 2),
    (256, 8, 8, "leaky_relu", 1, 1), (32, 256, 256, "leaky_relu", 1, 1),
    (128, 64, 64, "leaky_relu", 2, 1), (256, 32, 32, "leaky_relu", 2, 1),
    (512, 31, 31, "leaky_relu", 2, 1),
    (128, 64, 64, "leaky_relu", 1, 1), (256, 32, 32, "leaky_relu", 1, 1),
    (512, 31, 31, "leaky_relu", 1, 1),
]
# launches per inference request and per training step
REQUEST_LAUNCHES = {"K-block": 12, "K-warp": 1, "K-in": 16, "K-head": 2, "K-convt": 4,
                    "K-block-bwd": 0, "K-warp-bwd": 0, "K-in-bwd": 0, "K-head-bwd": 0,
                    "K-convt-bwd": 0}
STEP_LAUNCHES = {"K-block": 12, "K-warp": 1, "K-in": 22, "K-head": 2, "K-convt": 4,
                 "K-block-bwd": 12, "K-warp-bwd": 1, "K-in-bwd": 22, "K-head-bwd": 2,
                 "K-convt-bwd": 4}
# the TPU layouts of G's head and decoder: accepted, and the same kernels run
LAYOUT_FLAGS = [["--block_impl", "pallas_all"], ["--c7_impl", "roll"]]


def phase(tag: str, /, **fields) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() over iters calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def paired_median_ms(*fns, iters: int = 200, warmup: int = 10) -> list:
    """Median CUDA-event times of each of fns, timed call by call in
    alternation, so that all see the same state of the host and the card."""
    for _ in range(warmup):
        for fn in fns:
            fn()
    times = [[] for _ in fns]
    for _ in range(iters):
        for fn, ts in zip(fns, times):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
    return [float(np.median(ts)) for ts in times]


# device_ms's traces that needed more than one try: (launches, reps, events
# seen in each try), printed after phases 2 and 2b
TRACE_RETRIES = []


def trace_events(fn, reps: int, pad_s: float) -> list:
    """The events of ``reps`` calls of fn in one torch.profiler trace of the
    CUDA activity (device events: kernels, memcpys, memsets; host events:
    the CUDA runtime's calls), after one traced warm-up call whose events
    are dropped (the first launches of a trace can go unrecorded).

    The profiler keeps only the device events whose times, taken to the
    host's clock, fall inside the trace's window, and on an H100 host some
    traces place every kernel up to 2.4 ms before its own launch
    (``probe.py --trace-check``), so a window of a few milliseconds can
    lose some or all of them. The window is therefore padded with ``pad_s``
    seconds of an idle card on each side, and the warm-up call ends
    ``pad_s`` before it starts."""
    from torch.profiler import ProfilerActivity, schedule
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CUDA],
                       schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        time.sleep(pad_s)
        prof.step()
        time.sleep(pad_s)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad_s)
        prof.step()
    return list(prof.events())


def device_ms(fn, launches: int | None, reps: int = 10) -> tuple:
    """fn's device time per call from torch.profiler (the sum of the CUDA
    kernels, memcpys and memsets it runs), and that time by kernel, in the
    order of their first launch: [(kernel, launches per call, ms per call)].

    Each of the ``reps`` traced calls must show ``launches`` device events
    (None: the same number, at least one): a trace that does not is taken
    again with its window's padding doubled, from 0.05 s to 1.6 s, and then
    this raises, so no time is returned that was not measured in full."""
    fn()
    torch.cuda.synchronize()
    seen = []
    for pad_s in (0.05, 0.1, 0.2, 0.4, 0.8, 1.6):
        events = [e for e in trace_events(fn, reps, pad_s)
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        seen.append(len(events))
        if events and len(events) % reps == 0 and launches in (None, len(events) // reps):
            break
    else:
        raise AssertionError(f"the profiler traced {seen} device events over {reps} calls, "
                             f"not {launches or 'a whole number'} per call")
    if len(seen) > 1:
        TRACE_RETRIES.append((launches, reps, seen))
    by_kernel = {}
    for e in sorted(events, key=lambda e: e.time_range.start):
        name = e.name.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]
        count, us = by_kernel.get(name, (0, 0.0))
        by_kernel[name] = (count + 1, us + e.time_range.elapsed_us())
    per_kernel = [(k, round(n / reps, 2), round(us / reps / 1e3, 4)) for k, (n, us) in by_kernel.items()]
    return sum(us for _, us in by_kernel.values()) / reps / 1e3, per_kernel


def smooth_images(rng, n: int, c: int, size: int = 256) -> np.ndarray:
    """Seeded smooth test images in [-1, 1], NHWC: sums of low-frequency waves."""
    yy, xx = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size), indexing="ij")
    out = np.zeros((n, size, size, c), np.float32)
    for i in range(n):
        for ch in range(c):
            f = rng.uniform(1, 6, (4, 2))
            ph = rng.uniform(0, 2 * np.pi, 4)
            out[i, :, :, ch] = sum(np.sin(2 * np.pi * (f[k, 0] * xx + f[k, 1] * yy) + ph[k])
                                   for k in range(4)) / 4
    return out


def smooth_grid(rng, n: int, h: int, w: int, px: float = 3.0) -> torch.Tensor:
    """Identity grid plus a smooth random field of a few pixels, fractional."""
    from nemar_tpu_torch.ops.warp import identity_grid

    coarse = torch.from_numpy(rng.standard_normal((n, 2, 8, 8)).astype(np.float32))
    field = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bicubic",
                                            align_corners=False)
    field = field.permute(0, 2, 3, 1) * torch.tensor([2.0 * px / w, 2.0 * px / h])
    return identity_grid(h, w)[None] + field


def warp_bwd_tie_case(rng, align_corners: bool, dev) -> tuple:
    """(img, grid) for K-warp-bwd's check in one padding mode: a ragged
    33 x 47 image sampled at a 21 x 19 grid whose entries are, at random,
    exactly -1 or +1, the identity grid's first or last value on their axis
    (where the clip and the reflection sit on their ties), or uniform in
    [-1.3, 1.3] (off the frame too). tests/test_torch_cuda_kernels.py sweeps
    more shapes and fields."""
    from nemar_tpu_torch.ops.warp import identity_grid

    h, w = 33, 47
    img = rng.standard_normal((2, h, w, 4)).astype(np.float32)
    ident = identity_grid(h, w, align_corners).numpy()
    edges = ((ident[0, 0, 0], ident[0, -1, 0]), (ident[0, 0, 1], ident[-1, 0, 1]))
    grid = rng.uniform(-1.3, 1.3, (2, 21, 19, 2)).astype(np.float32)
    pick = rng.integers(0, 5, grid.shape)
    for axis in (0, 1):
        for k, v in enumerate((-1.0, 1.0, *edges[axis])):
            grid[..., axis][pick[..., axis] == k] = v
    return torch.from_numpy(img).to(dev), torch.from_numpy(grid).to(dev)


def bound(flops: float, *tensors) -> tuple:
    """(ms on the operations' bound, ms on the bytes' bound) of one call:
    its fp32 operations over the fp32 peak, and the bytes of ``tensors``
    (each input read once, each output written once) over the memory rate."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


class Tally:
    """One kernel's numbers summed over the calls of a request or a step."""

    def __init__(self):
        self.err, self.ms, self.plain_ms, self.lib_ms = 0.0, 0.0, 0.0, None
        self.ops_ms, self.bytes_ms, self.bound_ms, self.tc_ms = 0.0, 0.0, 0.0, 0.0
        self.device_ms = 0.0

    def add(self, calls: int, err: float, ms: float, pms: float, bnd: tuple,
            lib_ms: float | None = None) -> None:
        self.err = max(self.err, err)
        self.ms += calls * ms
        self.plain_ms += calls * pms
        if lib_ms is not None:
            self.lib_ms = (self.lib_ms or 0.0) + calls * lib_ms
        self.ops_ms += calls * bnd[0]
        self.bytes_ms += calls * bnd[1]
        self.bound_ms += calls * max(bnd)
        # a GEMM's operations in 3xTF32 on the tensor cores: the larger of
        # that and its bytes (fp32-accurate on this card, PERF.md section 6)
        self.tc_ms += calls * max(bnd[0] * PEAK_FP32_FLOPS * 3 / PEAK_TF32_FLOPS, bnd[1])

    def result(self, gemm: bool = False) -> dict:
        out = {"max_abs_err": self.err, "ms": self.ms, "plain_ms": self.plain_ms,
               "bound_ms": self.bound_ms,
               "bound_by": "operations" if self.ops_ms >= self.bytes_ms else "bytes",
               "library_ms": self.lib_ms}
        if gemm:
            out["tc_bound_ms"] = self.tc_ms
        return out


def randn(rng, shape, scale: float = 1.0, dev=None) -> torch.Tensor:
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(dev)


def check_kernels(dev) -> dict:
    """Phase 2: every forward kernel against its plain version at the
    slice's shapes. Each kernel's totals are those of one batch-1 request;
    ``library_ms`` times the one PyTorch call that computes the same
    function, where there is one (the port never calls it)."""
    from nemar_tpu_torch.ops import conv_fused, conv_head, convt_fused, norm, norm_triton, warp

    rng = np.random.default_rng(0)
    results = {}

    # K-warp: the slice's one sample per request, (fake_B, real_A) = 4
    # channels. Timed as the model calls it: ops/warp.grid_sample from the
    # normalised grid (one launch, the coordinate transform in the kernel),
    # against F.grid_sample on the same image and grid, call by call in
    # alternation; each with its device time from the profiler beside the
    # CUDA-event time (at b1 both calls are bound by the host). Alternated
    # with them, ``autograd_fn_ms`` times the kernel through the
    # autograd.Function that grid_sample takes when a gradient is needed (its
    # own checks left out), for what grid_sample's direct path saves. The
    # three padding modes and both align_corners are checked on a small
    # ragged grid.
    F = torch.nn.functional
    img = torch.from_numpy(smooth_images(rng, 2, 3, 40)).to(dev)
    grid = torch.from_numpy(rng.uniform(-1.3, 1.3, (2, 23, 31, 2)).astype(np.float32)).to(dev)
    modes_err = 0.0
    for pad in ("zeros", "border", "reflection"):
        for ac in (False, True):
            got = warp.grid_sample(img, grid, "bilinear", pad, ac)
            modes_err = max(modes_err, torch.max(torch.abs(
                got - warp.grid_sample_plain(img, grid, "bilinear", pad, ac))).item())
    if not modes_err <= TOL["K-warp"]:
        raise AssertionError(f"K-warp disagrees with its plain version across padding modes: "
                             f"{modes_err}")
    tally = Tally()
    for n in (1, 8):
        img = torch.from_numpy(smooth_images(rng, n, 4)).to(dev)
        grid = smooth_grid(rng, n, 256, 256).to(dev)
        got = warp.grid_sample(img, grid)
        ref = warp.grid_sample_plain(img, grid)
        err = torch.max(torch.abs(got - ref)).item()
        img_nchw = img.permute(0, 3, 1, 2)

        def kern():
            return warp.grid_sample(img, grid)

        def lib():
            return F.grid_sample(img_nchw, grid, "bilinear", "zeros", False)

        def autograd_fn():
            with torch.no_grad():
                return warp._GridSample.apply(img, grid, "zeros", False, 4)

        lib_err = torch.max(torch.abs(lib().permute(0, 2, 3, 1) - ref)).item()
        ms, lms, fms = paired_median_ms(kern, lib, autograd_fn)
        pms = median_ms(lambda: warp.grid_sample_plain(img, grid))
        dms, dl = device_ms(kern, 1, 50)
        lib_dms, ldl = device_ms(lib, None, 50)
        bnd = bound(8 * got.numel(), img, grid, got)
        phase("kernel", name="K-warp", shape=f"{n}x256x256x4", max_abs_err=err,
              tol=TOL["K-warp"], padding_modes_max_abs_err=modes_err, ms=ms, library_ms=lms,
              autograd_fn_ms=fms, device_ms=dms, library_device_ms=lib_dms,
              launches_per_call=sum(k for _, k, _ in dl),
              library_launches_per_call=sum(k for _, k, _ in ldl), plain_ms=pms,
              library_err=lib_err, bound_ms=max(bnd))
        if not err <= TOL["K-warp"]:
            raise AssertionError(f"K-warp disagrees with its plain version: {err}")
        if n == 1:
            tally.add(1, err, ms, pms, bnd, lms)
            results["K-warp"] = tally.result()
            results["K-warp"].update(device_ms=dms, library_device_ms=lib_dms)

    # K-in: every instance norm shape of one request, batch 1
    tally = Tally()
    for c, h, w, act, calls in IN_SHAPES:
        x = randn(rng, (1, h, w, c), 2.0, dev) + 0.5
        got, _ = norm_triton.instance_norm_act_triton(x, act)
        ref = norm.instance_norm_act_plain(x, act)
        err = torch.max(torch.abs(got - ref)).item()
        ms = median_ms(lambda: norm_triton.instance_norm_act_triton(x, act))
        pms = median_ms(lambda: norm.instance_norm_act_plain(x, act))
        phase("kernel", name="K-in", shape=f"1x{h}x{w}x{c}", act=act, calls=calls,
              max_abs_err=err, tol=TOL["K-in"], ms=ms, plain_ms=pms)
        if not err <= TOL["K-in"]:
            raise AssertionError(f"K-in disagrees with its plain version at {(c, h, w)}: {err}")
        tally.add(calls, err, ms, pms, bound(6 * x.numel(), x, got))
    results["K-in"] = tally.result()

    # K-block: the trunk, N x 64 x 64 x 256, 6 blocks x 2 G passes per
    # request. Its two convolutions run in 3xTF32 on the tensor cores: held
    # also against the plain forward in float64 (the same inputs cast up),
    # its largest relative error on out, y1, y2 at most 4x the fp32 plain
    # version's; its device time per launch from the profiler (6 a call).
    # Its GEMM tiles are 64 channels wide at b1 and 128 at b8, so both
    # widths are checked.
    for n in (1, 8):
        x = randn(rng, (n, 64, 64, 256), 1.0, dev)
        w1, w2 = (randn(rng, (3, 3, 256, 256), 0.02, dev) for _ in range(2))

        def kern():
            return conv_fused.fused_resblock_cuda(x, w1, w2)

        got, again = kern(), kern()
        repeatable = all(torch.equal(p, q) for p, q in zip(got, again))
        ref = conv_fused.resblock_fwd_plain(x, w1, w2)
        err = torch.max(torch.abs(got[0] - ref[0])).item()
        ref64 = conv_fused.resblock_fwd_plain(x.double(), w1.double(), w2.double())
        err64 = [max_rel_err([p.double()], [q]) for p, q in zip(got[:3], ref64[:3])]
        plain_err64 = [max_rel_err([p.double()], [q]) for p, q in zip(ref[:3], ref64[:3])]
        del ref64, again
        ms = median_ms(kern, iters=20)
        pms = median_ms(lambda: conv_fused.resblock_plain(x, w1, w2), iters=10)
        dms, per_launch = device_ms(kern, 6, 10)
        flops = 2 * 2 * n * 64 * 64 * 256 * 9 * 256
        bnd = bound(flops, x, w1, w2, *got)
        tc_bound = 3 * flops / PEAK_TF32_FLOPS * 1e3
        phase("kernel", name="K-block", shape=f"{n}x64x64x256", max_abs_err=err,
              tol=TOL["K-block"], bitwise_repeatable=repeatable,
              rel_err_vs_fp64_out_y1_y2=json.dumps(err64),
              plain_fp32_rel_err_vs_fp64=json.dumps(plain_err64), ms=ms, device_ms=dms,
              plain_ms=pms, tflops=round(flops / ms / 1e9, 2),
              plain_tflops=round(flops / pms / 1e9, 2), bound_ms=max(bnd), tc_bound_ms=tc_bound,
              launches_per_call=sum(k for _, k, _ in per_launch),
              device_ms_by_kernel=json.dumps(per_launch))
        if not (err <= TOL["K-block"] and repeatable):
            raise AssertionError(f"K-block disagrees with its plain version: {err}, "
                                 f"repeatable {repeatable}")
        if not max(err64) <= 4 * max(plain_err64):
            raise AssertionError(f"K-block is less accurate than fp32 allows: {err64} against "
                                 f"fp64, the fp32 plain version {plain_err64}")
        if n == 1:
            tally = Tally()
            tally.add(12, err, ms, pms, bnd)
            results["K-block"] = tally.result(gemm=True)
            results["K-block"].update(device_ms=12 * dms)

    # K-head: G's 7x7 output conv, N x 256 x 256 x 64 -> 3, twice per
    # request; the library call is nn.Conv2d(padding_mode='reflect')
    h, w, ci, co, calls = HEAD_SHAPE
    for n in (1, 8):
        x = randn(rng, (n, h, w, ci), 1.0, dev)
        wk = randn(rng, (7, 7, ci, co), 0.02, dev)
        got = conv_head.conv_head_cuda(x, wk)
        ref = conv_head.conv_head_plain(x, wk)
        err = torch.max(torch.abs(got - ref)).item()
        ms = median_ms(lambda: conv_head.conv_head_cuda(x, wk))
        pms = median_ms(lambda: conv_head.conv_head_plain(x, wk))
        lib = torch.nn.Conv2d(ci, co, 7, padding=3, padding_mode="reflect", bias=False).to(dev)
        with torch.no_grad():
            lib.weight.copy_(wk.permute(3, 2, 0, 1))
            x_nchw = x.permute(0, 3, 1, 2)
            lib_err = torch.max(torch.abs(lib(x_nchw).permute(0, 2, 3, 1) - ref)).item()
            lms = median_ms(lambda: lib(x_nchw))
        flops = 2 * n * h * w * 49 * ci * co
        bnd = bound(flops, x, wk, got)
        phase("kernel", name="K-head", shape=f"{n}x{h}x{w}x{ci}->{co}", calls=calls,
              max_abs_err=err, tol=TOL["K-head"], ms=ms, plain_ms=pms, library_ms=lms,
              library_err=lib_err, bound_ms=max(bnd), tflops=round(flops / ms / 1e9, 2))
        if not err <= TOL["K-head"]:
            raise AssertionError(f"K-head disagrees with its plain version: {err}")
        if n == 1:
            tally = Tally()
            tally.add(calls, err, ms, pms, bnd, lms)
            results["K-head"] = tally.result(gemm=True)

    # K-convt: G's two decoder stages, twice each per request. Its GEMMs run
    # in 3xTF32 on the tensor cores: held also against the plain forward in
    # float64 (out and yhat, at most 4x the fp32 plain version's error), with
    # its device time per launch (4 a call); cuDNN's transposed convolution
    # at the same shape is the yardstick for the GEMM
    tally = Tally()
    for h, w, ci, co, calls in CONVT_SHAPES:
        for n in (1, 8):
            x = randn(rng, (n, h, w, ci), 1.0, dev)
            wk = randn(rng, (3, 3, ci, co), 0.02, dev)

            def kern():
                return convt_fused.fused_convt_in_cuda(x, wk)

            got, again = kern(), kern()
            repeatable = all(torch.equal(p, q) for p, q in zip(got, again))
            ref = convt_fused.convt_in_fwd_plain(x, wk)
            err = max(torch.max(torch.abs(got[0] - ref[0])).item(),
                      torch.max(torch.abs(got[1] - ref[1])).item())
            ref64 = convt_fused.convt_in_fwd_plain(x.double(), wk.double())
            err64 = [max_rel_err([p.double()], [q]) for p, q in zip(got[:2], ref64[:2])]
            plain_err64 = [max_rel_err([p.double()], [q]) for p, q in zip(ref[:2], ref64[:2])]
            del ref64, again
            ms = median_ms(kern)
            pms = median_ms(lambda: convt_fused.convt_in_plain(x, wk))
            dms, per_launch = device_ms(kern, 4, 10)
            cudnn_ms = cudnn_convt_ms(x, wk)[0]
            flops = 2 * n * h * w * 9 * ci * co
            bnd = bound(flops, x, wk, *got)
            phase("kernel", name="K-convt", shape=f"{n}x{h}x{w}x{ci}->{co}", calls=calls,
                  max_abs_err=err, tol=TOL["K-convt"], bitwise_repeatable=repeatable,
                  rel_err_vs_fp64_out_yhat=json.dumps(err64),
                  plain_fp32_rel_err_vs_fp64=json.dumps(plain_err64), ms=ms, device_ms=dms,
                  plain_ms=pms, cudnn_convt_ms=cudnn_ms, bound_ms=max(bnd),
                  tc_bound_ms=3 * flops / PEAK_TF32_FLOPS * 1e3,
                  tflops=round(flops / ms / 1e9, 2), launches_per_call=sum(k for _, k, _ in per_launch),
                  device_ms_by_kernel=json.dumps(per_launch))
            if not (err <= TOL["K-convt"] and repeatable):
                raise AssertionError(f"K-convt disagrees with its plain version: {err}, "
                                     f"repeatable {repeatable}")
            if not max(err64) <= 4 * max(plain_err64):
                raise AssertionError(f"K-convt is less accurate than fp32 allows: {err64} against "
                                     f"fp64, the fp32 plain version {plain_err64}")
            if n == 1:
                tally.add(calls, err, ms, pms, bnd)
                tally.device_ms += calls * dms
    results["K-convt"] = dict(tally.result(gemm=True), device_ms=tally.device_ms)
    torch.cuda.synchronize()
    return results


def cudnn_convt_ms(x: torch.Tensor, wk: torch.Tensor) -> tuple:
    """Median ms of cuDNN's transposed convolution (F.conv_transpose2d,
    stride 2, channels_last) at a decoder stage's shape, forward and
    backward to (dx, dw), with deterministic algorithms and TF32 off: the
    yardstick for K-convt's and K-convt-bwd's GEMMs (no PyTorch call
    computes ConvTranspose + IN + ReLU)."""
    conv_t = torch.nn.functional.conv_transpose2d
    xr = x.permute(0, 3, 1, 2).detach().requires_grad_()
    wt = wk.flip(0, 1).permute(2, 3, 0, 1).contiguous().requires_grad_()
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with torch.no_grad():
            fwd = median_ms(lambda: conv_t(xr, wt, stride=2))
        y = conv_t(xr, wt, stride=2)
        gy = torch.ones_like(y)
        bwd = median_ms(lambda: torch.autograd.grad(y, (xr, wt), gy, retain_graph=True), iters=10)
    finally:
        torch.backends.cudnn.deterministic = prev
    return fwd, bwd


def max_rel_err(got, ref) -> float:
    """Largest |got - ref| over the largest |ref|, across the outputs."""
    return max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, ref)
               if a is not None)


def max_abs_err(got, ref) -> float:
    return max(float((p - q).abs().max()) for p, q in zip(got, ref))


def check_bwd_kernels(dev) -> dict:
    """Phase 2b: every backward kernel against its plain version at the
    training step's shapes (batch 8), with each launch repeated to show it
    is bit-for-bit repeatable. Each kernel's totals are those of one step."""
    from nemar_tpu_torch.ops import conv_fused, conv_head, convt_fused, norm, norm_triton
    from nemar_tpu_torch.ops import warp, warp_cuda

    rng = np.random.default_rng(1)
    results = {}
    n = TRAIN_BATCH

    # K-warp-bwd: one operator from (img, grid, g) to (d img, d grid). First
    # every padding mode and align_corners against the plain version on a
    # small ragged grid with entries on the clip's and the reflection's ties,
    # each launch repeated bit for bit. Then the step's one sampling of
    # (fake_B, real_A), d img for fake_B's 3 channels only, timed as the
    # model runs it: _GridSample's backward from g to (d img, d grid),
    # against aten.grid_sampler_2d_backward on the same image, grid and g (d
    # img of 4 channels, d grid), call by call in alternation, and both by
    # their device time from the profiler (2 launches a call for the kernel).
    modes_err, modes_repeatable = 0.0, True
    for pad in ("zeros", "border", "reflection"):
        for ac in (False, True):
            img, grid = warp_bwd_tie_case(rng, ac, dev)
            g = randn(rng, tuple(grid.shape[:3]) + (img.shape[3],), 1.0, dev)
            got = warp_cuda.warp_grid_bwd(img, grid, g, pad, ac, 3)
            again = warp_cuda.warp_grid_bwd(img, grid, g, pad, ac, 3)
            ref = warp._grid_sample_plain_bwd(img, grid, g, pad, ac, 3)
            modes_err = max(modes_err, max_rel_err(got, ref))
            modes_repeatable &= all(torch.equal(p, q) for p, q in zip(got, again))
    if not (modes_err <= TOL["K-warp-bwd"] and modes_repeatable):
        raise AssertionError(f"K-warp-bwd across padding modes and ties: err {modes_err}, "
                             f"repeatable {modes_repeatable}")
    for b in (1, n):
        img = torch.from_numpy(smooth_images(rng, b, 4)).to(dev)
        grid = smooth_grid(rng, b, 256, 256).to(dev)
        g = randn(rng, (b, 256, 256, 4), 1.0, dev)
        ctx = SimpleNamespace(saved_tensors=(img, grid), conf=("zeros", False, 3),
                              needs_input_grad=(True, True, False, False, False))

        def kern():
            return warp._GridSample.backward(ctx, g)[:2]

        got, again = kern(), kern()
        ref = warp._grid_sample_plain_bwd(img, grid, g, "zeros", False, 3)
        err = max_rel_err(got, ref)
        abs_err = max_abs_err(got, ref)
        repeatable = all(torch.equal(p, q) for p, q in zip(got, again))
        img_nchw, g_nchw = img.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)

        def lib():
            return torch.ops.aten.grid_sampler_2d_backward(g_nchw, img_nchw, grid, 0, 0, False,
                                                           [True, True])

        ms, lms = paired_median_ms(kern, lib)
        pms = median_ms(lambda: warp._grid_sample_plain_bwd(img, grid, g, "zeros", False, 3))
        dms, dl = device_ms(kern, 2, 50)
        lib_dms, ldl = device_ms(lib, None, 50)
        bnd = bound(20 * g.numel(), img, grid, g, *got)
        phase("kernel_bwd", name="K-warp-bwd", shape=f"{b}x256x256x4", grad_channels=3,
              max_rel_err=err, tol=TOL["K-warp-bwd"], max_abs_err=abs_err,
              modes_ties_ragged_max_rel_err=modes_err, bitwise_repeatable=repeatable, ms=ms,
              library_ms=lms, device_ms=dms, library_device_ms=lib_dms,
              launches_per_call=sum(k for _, k, _ in dl),
              library_launches_per_call=sum(k for _, k, _ in ldl),
              device_ms_by_kernel=json.dumps(dl), plain_ms=pms, bound_ms=max(bnd))
        if not (err <= TOL["K-warp-bwd"] and repeatable and not torch.any(got[0][..., 3])):
            raise AssertionError(f"K-warp-bwd: err {err}, repeatable {repeatable}")
        if b == n:
            tally = Tally()
            tally.add(1, abs_err, ms, pms, bnd, lms)
            results["K-warp-bwd"] = tally.result()
            results["K-warp-bwd"].update(device_ms=dms, library_device_ms=lib_dms)

    # K-in-bwd: every instance-norm backward of a step
    tally = Tally()
    for c, h, w, act, mult, calls in IN_BWD_SHAPES:
        shape = (n * mult, h, w, c)
        x = randn(rng, shape, 2.0, dev) + 0.5
        g = randn(rng, shape, 1.0, dev)
        _, stats = norm_triton.instance_norm_act_triton(x, act)
        got = norm_triton.instance_norm_act_bwd_triton(x, g, stats, act)
        again = norm_triton.instance_norm_act_bwd_triton(x, g, stats, act)
        ref = norm.instance_norm_act_bwd_plain(x, g, stats, act)
        err = max_rel_err([got], [ref])
        abs_err = float((got - ref).abs().max())
        ms = median_ms(lambda: norm_triton.instance_norm_act_bwd_triton(x, g, stats, act))
        pms = median_ms(lambda: norm.instance_norm_act_bwd_plain(x, g, stats, act))
        phase("kernel_bwd", name="K-in-bwd", shape="x".join(map(str, shape)), act=act,
              calls=calls, max_rel_err=err, tol=TOL["K-in-bwd"], max_abs_err=abs_err,
              bitwise_repeatable=torch.equal(got, again), ms=ms, plain_ms=pms)
        if not (err <= TOL["K-in-bwd"] and torch.equal(got, again)):
            raise AssertionError(f"K-in-bwd disagrees at {shape} {act}: {err}")
        tally.add(calls, abs_err, ms, pms, bound(8 * x.numel(), x, g, stats, got))
    results["K-in-bwd"] = tally.result()

    # K-block-bwd: the trunk. The kernel is fed the plain forward's saved
    # values (y1, y2, stats), as the plain backward uses them: with K-block's
    # own, a y1hat within roundoff of 0 can sit on the other side of the relu
    # than in the plain forward, and that element's gradient then differs by
    # O(1) (counted and shown as relu_flips / err_with_kblock_saved). Its
    # accuracy is also held against the plain backward in float64 from the
    # same inputs and saved values cast up (the relu mask is the same): the
    # kernel's largest relative error at most 4x the fp32 plain version's
    # (3xTF32 is fp32-level; 1xTF32 would be ~100x).
    for b in (1, n):
        c = 256
        x = randn(rng, (b, 64, 64, c), 1.0, dev)
        w1, w2 = (randn(rng, (3, 3, c, c), 0.02, dev) for _ in range(2))
        g = randn(rng, (b, 64, 64, c), 1.0, dev)
        saved = conv_fused.resblock_fwd_plain(x, w1, w2)[1:]
        got = conv_fused.resblock_bwd_cuda(x, w1, w2, *saved, g)
        again = conv_fused.resblock_bwd_cuda(x, w1, w2, *saved, g)
        ref = conv_fused.resblock_bwd_plain(x, w1, w2, g, saved=saved)
        err = max_rel_err(got, ref)
        abs_err = max_abs_err(got, ref)
        repeatable = all(torch.equal(p, q) for p, q in zip(got, again))
        ref64 = conv_fused.resblock_bwd_plain(x.double(), w1.double(), w2.double(), g.double(),
                                              saved=tuple(t.double() for t in saved))
        err64 = [max_rel_err([p.double()], [q]) for p, q in zip(got, ref64)]
        plain_err64 = [max_rel_err([p.double()], [q]) for p, q in zip(ref, ref64)]
        del ref64
        _, y1k, y2k, stk = conv_fused.fused_resblock_cuda(x, w1, w2)
        own = conv_fused.resblock_bwd_cuda(x, w1, w2, y1k, y2k, stk, g)
        flips = int(torch.sum((norm.normalise(y1k, stk[:, :2]) > 0)
                              != (norm.normalise(saved[0], saved[2][:, :2]) > 0)))

        def kern():
            return conv_fused.resblock_bwd_cuda(x, w1, w2, *saved, g)

        ms = median_ms(kern, iters=20)
        pms = median_ms(lambda: conv_fused.resblock_bwd_plain(x, w1, w2, g, saved=saved), iters=10)
        dms, per_launch = device_ms(kern, 12, 10)
        flops = 4 * 2 * b * 64 * 64 * 256 * 9 * 256
        bnd = bound(flops, x, *saved, g, w1, w2, *got)
        tc_bound = 3 * flops / PEAK_TF32_FLOPS * 1e3
        phase("kernel_bwd", name="K-block-bwd", shape=f"{b}x64x64x256",
              max_rel_err_dx_dw1_dw2=json.dumps([max_rel_err([p], [q]) for p, q in zip(got, ref)]),
              tol=TOL["K-block-bwd"], max_abs_err=abs_err, bitwise_repeatable=repeatable,
              rel_err_vs_fp64=json.dumps(err64), plain_fp32_rel_err_vs_fp64=json.dumps(plain_err64),
              err_with_kblock_saved=max_rel_err(own, ref), relu_flips=flips, ms=ms,
              device_ms=dms, plain_ms=pms, tflops=round(flops / ms / 1e9, 2),
              plain_tflops=round(flops / pms / 1e9, 2), bound_ms=max(bnd), tc_bound_ms=tc_bound,
              launches_per_call=sum(n for _, n, _ in per_launch),
              device_ms_by_kernel=json.dumps(per_launch))
        if not (err <= TOL["K-block-bwd"] and repeatable):
            raise AssertionError(f"K-block-bwd disagrees with its plain version: {err}")
        if not max(err64) <= 4 * max(plain_err64):
            raise AssertionError(f"K-block-bwd is less accurate than fp32 allows: {err64} against "
                                 f"fp64, the fp32 plain version {plain_err64}")
        if b == n:
            tally = Tally()
            tally.add(12, abs_err, ms, pms, bnd)
            results["K-block-bwd"] = tally.result(gemm=True)
            results["K-block-bwd"].update(device_ms=12 * dms)

    # K-head-bwd: G's 7x7 output conv, twice per step
    h, w, ci, co, calls = HEAD_SHAPE
    x = randn(rng, (n, h, w, ci), 1.0, dev)
    wk = randn(rng, (7, 7, ci, co), 0.02, dev)
    g = randn(rng, (n, h, w, co), 1.0, dev)
    got = conv_head.conv_head_bwd_cuda(x, wk, g)
    again = conv_head.conv_head_bwd_cuda(x, wk, g)
    ref = conv_head.conv_head_bwd_plain(x, wk, g)
    err = max_rel_err(got, ref)
    abs_err = max_abs_err(got, ref)
    repeatable = all(torch.equal(p, q) for p, q in zip(got, again))
    ms = median_ms(lambda: conv_head.conv_head_bwd_cuda(x, wk, g), iters=10)
    pms = median_ms(lambda: conv_head.conv_head_bwd_plain(x, wk, g), iters=5)
    flops = 2 * 2 * n * h * w * 49 * ci * co
    phase("kernel_bwd", name="K-head-bwd", shape=f"{n}x{h}x{w}x{ci}->{co}", calls=calls,
          max_rel_err_dx_dw=json.dumps([max_rel_err([p], [q]) for p, q in zip(got, ref)]),
          tol=TOL["K-head-bwd"], max_abs_err=abs_err, bitwise_repeatable=repeatable, ms=ms,
          plain_ms=pms, tflops=round(flops / ms / 1e9, 2))
    if not (err <= TOL["K-head-bwd"] and repeatable):
        raise AssertionError(f"K-head-bwd disagrees with its plain version: {err}")
    tally = Tally()
    tally.add(calls, abs_err, ms, pms, bound(flops, x, wk, g, *got))
    results["K-head-bwd"] = tally.result(gemm=True)

    # K-convt-bwd: G's two decoder stages, twice each per step. As for
    # K-block-bwd, the kernel is fed the plain forward's saved (yhat, stats),
    # and is held also against the plain backward in float64 from the same
    # inputs and saved values cast up; the comparison with K-convt's own
    # saved values is shown beside it. Its device time per launch (6 a call)
    # and cuDNN's transposed convolution backward as the GEMMs' yardstick.
    tally = Tally()
    for h, w, ci, co, calls in CONVT_SHAPES:
        x = randn(rng, (n, h, w, ci), 1.0, dev)
        wk = randn(rng, (3, 3, ci, co), 0.02, dev)
        g = randn(rng, (n, 2 * h, 2 * w, co), 1.0, dev)
        saved = convt_fused.convt_in_fwd_plain(x, wk)[1:]

        def kern():
            return convt_fused.convt_in_bwd_cuda(x, wk, *saved, g)

        got, again = kern(), kern()
        ref = convt_fused.convt_in_bwd_plain(x, wk, g, saved=saved)
        err = max_rel_err(got, ref)
        abs_err = max_abs_err(got, ref)
        repeatable = all(torch.equal(p, q) for p, q in zip(got, again))
        ref64 = convt_fused.convt_in_bwd_plain(x.double(), wk.double(), g.double(),
                                               saved=tuple(t.double() for t in saved))
        err64 = [max_rel_err([p.double()], [q]) for p, q in zip(got, ref64)]
        plain_err64 = [max_rel_err([p.double()], [q]) for p, q in zip(ref, ref64)]
        del ref64, again
        _, yk, sk = convt_fused.fused_convt_in_cuda(x, wk)
        own = convt_fused.convt_in_bwd_cuda(x, wk, yk, sk, g)
        flips = int(torch.sum((yk > 0) != (saved[0] > 0)))
        ms = median_ms(kern, iters=10)
        pms = median_ms(lambda: convt_fused.convt_in_bwd_plain(x, wk, g, saved=saved), iters=5)
        dms, per_launch = device_ms(kern, 6, 10)
        cudnn_ms = cudnn_convt_ms(x, wk)[1]
        flops = 2 * 2 * n * h * w * 9 * ci * co
        phase("kernel_bwd", name="K-convt-bwd", shape=f"{n}x{h}x{w}x{ci}->{co}", calls=calls,
              max_rel_err_dx_dw=json.dumps([max_rel_err([p], [q]) for p, q in zip(got, ref)]),
              tol=TOL["K-convt-bwd"], max_abs_err=abs_err, bitwise_repeatable=repeatable,
              rel_err_vs_fp64_dx_dw=json.dumps(err64),
              plain_fp32_rel_err_vs_fp64=json.dumps(plain_err64),
              err_with_kconvt_saved=max_rel_err(own, ref), relu_flips=flips, ms=ms,
              device_ms=dms, plain_ms=pms, cudnn_convt_bwd_ms=cudnn_ms,
              tflops=round(flops / ms / 1e9, 2), tc_bound_ms=3 * flops / PEAK_TF32_FLOPS * 1e3,
              launches_per_call=sum(k for _, k, _ in per_launch),
              device_ms_by_kernel=json.dumps(per_launch))
        if not (err <= TOL["K-convt-bwd"] and repeatable):
            raise AssertionError(f"K-convt-bwd disagrees with its plain version: {err}")
        if not max(err64) <= 4 * max(plain_err64):
            raise AssertionError(f"K-convt-bwd is less accurate than fp32 allows: {err64} against "
                                 f"fp64, the fp32 plain version {plain_err64}")
        tally.add(calls, abs_err, ms, pms, bound(flops, x, wk, *saved, g, *got))
        tally.device_ms += calls * dms
    results["K-convt-bwd"] = dict(tally.result(gemm=True), device_ms=tally.device_ms)
    torch.cuda.synchronize()
    return results


def launch_counters():
    from nemar_tpu_torch.ops import conv_fused, conv_head, convt_fused, norm_triton, warp_cuda

    return {"K-block": conv_fused.fused_resblock_cuda, "K-warp": warp_cuda.warp_bilinear,
            "K-in": norm_triton.instance_norm_act_triton, "K-head": conv_head.conv_head_cuda,
            "K-convt": convt_fused.fused_convt_in_cuda,
            "K-block-bwd": conv_fused.resblock_bwd_cuda, "K-warp-bwd": warp_cuda.warp_grid_bwd,
            "K-in-bwd": norm_triton.instance_norm_act_bwd_triton,
            "K-head-bwd": conv_head.conv_head_bwd_cuda,
            "K-convt-bwd": convt_fused.convt_in_bwd_cuda}


def zero_counters() -> dict:
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    return counters


def request_batches(n_batches: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [{"A": smooth_images(rng, n, 1), "B": smooth_images(rng, n, 3),
             "A_paths": [f"smoke_{seed}_{i}_{j}" for j in range(n)]} for i in range(n_batches)]


def run_slice(ckpt: str) -> tuple:
    """Phase 3. Returns (launches, the first request's outputs, that request)."""
    from nemar_tpu_torch.models import create_model
    from nemar_tpu_torch.options import TestOptions
    from nemar_tpu_torch.test import accumulate_metrics, new_metrics, summarize

    opt = TestOptions().parse([*SLICE_ARGS, "--gpu_ids", "0", "--checkpoints_dir", ckpt])
    seeded = create_model(opt)
    head = seeded.netR.head()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        # a few pixels of field at 256^2: the warp samples between pixels
        head.weight.copy_(1e-3 * torch.randn(head.weight.shape, generator=gen))
    seeded.save_networks("latest")
    del seeded

    model = create_model(opt)
    model.setup(opt)  # loads latest_net_{G,D,R}.pth
    model.eval()
    batches = request_batches(REQUESTS, 1, seed=2)
    for b in batches[:2]:  # warm-up requests, outside the counted run
        model.set_input(b)
        model.test()
    torch.cuda.synchronize()

    counters = zero_counters()
    acc = new_metrics()
    times, first = [], None
    for b in batches:
        t0 = time.perf_counter()
        model.set_input(b)
        model.test()
        visuals = model.get_current_visuals()  # copies to the host: synchronises
        times.append((time.perf_counter() - t0) * 1e3)
        accumulate_metrics(acc, visuals, model.last_flow)
        if first is None:
            first = dict(visuals, flow=model.last_flow)
        for k, v in visuals.items():
            if not np.all(np.isfinite(v)):
                raise AssertionError(f"non-finite values in {k}")
    launches = {k: fn.launches for k, fn in counters.items()}
    want = {k: v * REQUESTS for k, v in REQUEST_LAUNCHES.items()}
    flow_px = float(np.abs(first["flow"]).max() * 128)
    phase("slice", requests=REQUESTS, batch=1, launches=json.dumps(launches),
          expected=json.dumps(want), ms_per_pair_median=round(float(np.median(times)), 3),
          ms_per_pair_mean=round(float(np.mean(times)), 3), max_flow_px=round(flow_px, 3),
          metrics=json.dumps(summarize(acc)))
    if launches != want:
        raise AssertionError(f"launch counts {launches} != expected {want}")
    if not 0.2 < flow_px < 30:
        raise AssertionError(f"the field is not a few pixels: max {flow_px} px")

    big = request_batches(3, 8, seed=3)
    t8 = []
    for b in big:
        t0 = time.perf_counter()
        model.set_input(b)
        model.test()
        out = model.get_current_visuals()
        t8.append((time.perf_counter() - t0) * 1e3)
        if not all(np.all(np.isfinite(v)) for v in out.values()):
            raise AssertionError("non-finite values at batch 8")
    phase("slice", requests=len(big), batch=8,
          ms_per_pair_median_of_last_2=round(float(np.median(t8[1:])) / 8, 3),
          ms_per_batch=json.dumps([round(t, 3) for t in t8]))

    profile_request(model, batches[0])
    return launches, first, batches[0]


def profile(run, reps: int, name: str, unit: str) -> None:
    """Device time by kernel name over ``reps`` calls of ``run``, written to
    chiprun_out/<name>.txt, and the device's busy share of the window
    (kernel time over wall time)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    # the window is padded as trace_events pads it, so that no device event
    # the trace places off its launch falls outside
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                       record_shapes=True) as prof:
        time.sleep(0.05)
        t0 = time.perf_counter()
        for i in range(reps):
            run(i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        time.sleep(0.05)
    # device work = the kernel, memcpy and memset events (an aten op's
    # "self device time" repeats the time of the kernels it launched)
    device_us = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=40)
    table += "\n" + prof.key_averages(group_by_input_shape=True).table(
        sort_by="self_device_time_total", row_limit=30)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"{name}.txt"), "w") as f:
        f.write(table)
    phase("profile", name=name, reps=reps,
          **{f"wall_ms_per_{unit}": round(wall_us / reps / 1e3, 3),
             f"device_ms_per_{unit}": round(device_us / reps / 1e3, 3)},
          device_busy_share=round(device_us / wall_us, 3))


def profile_request(model, batch, reps: int = 3) -> None:
    """Device time by kernel name for batch-1 requests."""
    def run(_):
        model.set_input(batch)
        model.test()

    profile(run, reps, "profile_b1", "request")


def compare_with_cpu(ckpt: str, first: dict, batch: dict) -> None:
    """Phase 4: the same checkpoints and request through the CPU's plain path."""
    from nemar_tpu_torch.models import create_model
    from nemar_tpu_torch.options import TestOptions

    opt = TestOptions().parse([*SLICE_ARGS, "--gpu_ids", "-1", "--checkpoints_dir", ckpt])
    cpu = create_model(opt)
    cpu.setup(opt)
    cpu.set_input(batch)
    cpu.test()
    ref = dict(cpu.get_current_visuals(), flow=cpu.last_flow)
    for k in ("fake_B", "reg_fakeB", "warped_A", "fake_B2", "flow"):
        err = float(np.max(np.abs(first[k] - ref[k])))
        phase("card_vs_cpu", output=k, max_abs_err=err, tol=1e-3)
        if not err <= 1e-3:
            raise AssertionError(f"card and CPU disagree on {k}: {err}")


def train_model(args: list):
    from nemar_tpu_torch.models import create_model
    from nemar_tpu_torch.options import TrainOptions

    opt = TrainOptions().parse(args)
    model = create_model(opt)
    model.setup(opt)
    model.set_epoch(opt.epoch_count)
    return model


def run_train(ckpt: str) -> dict:
    """Phase 5. Returns the launches over the counted steps. Saves the model
    as epoch ``smoke`` before the steps with cuDNN's non-deterministic
    algorithms, so phase 6 starts from the same state in every run."""
    model = train_model([*TRAIN_ARGS, "--gpu_ids", "0", "--checkpoints_dir", ckpt,
                         "--batch_size", str(TRAIN_BATCH)])
    head = model.netR.head()
    head0 = head.weight.detach().clone()
    batches = request_batches(2 + TRAIN_STEPS, TRAIN_BATCH, seed=4)
    for b in batches[:2]:  # warm-up steps, outside the counted run
        model.set_input(b)
        model.optimize_parameters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    counters = zero_counters()
    times = []
    for b in batches[2:]:
        t0 = time.perf_counter()
        model.set_input(b)
        model.optimize_parameters()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {k: fn.launches for k, fn in counters.items()}
    losses = model.get_current_losses()
    want = {k: v * TRAIN_STEPS for k, v in STEP_LAUNCHES.items()}
    moved = float((head.weight.detach() - head0).abs().max())
    ms = float(np.median(times))
    phase("train", batch=TRAIN_BATCH, steps=TRAIN_STEPS, launches=json.dumps(launches),
          expected=json.dumps(want), ms_per_step_median=round(ms, 3),
          ms_per_step=json.dumps([round(t, 3) for t in times]),
          pairs_per_s=round(TRAIN_BATCH / ms * 1e3, 3),
          peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3),
          losses=json.dumps({k: round(v, 6) for k, v in losses.items()}),
          head_moved_max=moved)
    if launches != want:
        raise AssertionError(f"launch counts {launches} != expected {want}")
    if not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"non-finite losses {losses}")
    if not moved > 0.0:
        raise AssertionError("the R flow head did not move")

    def run(i):
        model.set_input(batches[2 + i])
        model.optimize_parameters()

    profile(run, 2, "profile_train_b8", "step")
    model.save_networks("smoke")

    # what determinism costs: the same steps with cuDNN's default
    # algorithms (the convolutions outside the kernels), then back
    torch.backends.cudnn.deterministic = False
    try:
        for b in batches[:2]:
            model.set_input(b)
            model.optimize_parameters()
        torch.cuda.synchronize()
        free = []
        for b in batches[2:]:
            t0 = time.perf_counter()
            model.set_input(b)
            model.optimize_parameters()
            torch.cuda.synchronize()
            free.append((time.perf_counter() - t0) * 1e3)
    finally:
        torch.backends.cudnn.deterministic = True
    ms_free = float(np.median(free))
    phase("train_cudnn_default", batch=TRAIN_BATCH, steps=TRAIN_STEPS,
          ms_per_step_median=round(ms_free, 3), deterministic_ms_per_step=round(ms, 3),
          determinism_cost=round(ms / ms_free - 1, 4))
    return launches


def run_layout_flags(ckpt: str) -> None:
    """Phase 5b: one batch-1 training step with the default flags and with
    each of G's TPU layout flags (``LAYOUT_FLAGS``), from the same seed and
    pair. Each flag is accepted, launches the same kernels as often (the
    counters zeroed just before the step), and gives bit-identical losses."""
    pair = request_batches(1, 1, seed=7)[0]
    ref = None
    for flag in [[], *LAYOUT_FLAGS]:
        model = train_model([*TRAIN_ARGS, *flag, "--gpu_ids", "0", "--checkpoints_dir", ckpt,
                             "--batch_size", "1", "--name", "smoke_layout"])
        counters = zero_counters()
        model.set_input(pair)
        model.optimize_parameters()
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        losses = model.get_current_losses()
        phase("layout_flag", flag=" ".join(flag) or "default", batch=1,
              launches=json.dumps(launches), losses=json.dumps(losses))
        if launches != STEP_LAUNCHES:
            raise AssertionError(f"{flag}: launch counts {launches} != {STEP_LAUNCHES}")
        if ref is None:
            ref = losses
        elif losses != ref:
            raise AssertionError(f"{flag}: losses {losses} differ from the default's {ref}")
        del model


def _in_biases(model) -> dict:
    """Per net, the biases of convolutions followed by instance norm (zero
    gradient up to roundoff)."""
    g = {k for k in model.netG.state_dict() if k.endswith(".bias")
         and not k.startswith(f"Conv_{1 + model.netG.n_downsampling}.")}
    d = {f"Conv_{i}.bias" for i in range(1, model.netD.n_layers + 1)}
    r = {f"Conv_{i}.bias" for i in range(model.netR.n_convs - 1)}
    return {"G": g, "D": d, "R": r}


def _grad(net_params: dict, key: str) -> torch.Tensor:
    p = net_params[key]
    return torch.zeros_like(p).cpu() if p.grad is None else p.grad.detach().cpu()


def compare_train_with_cpu(ckpt: str) -> None:
    """Phase 6: one training step, card against CPU, from one shared state,
    and against the step's own conditioning; then two fresh two-step runs
    on the card, bit for bit.

    The shared state is the phase-5 model's nets (epoch ``smoke``, saved
    before its non-deterministic steps) after one step on the card from a
    fresh Adam: parameters, Adam moments and steps, saved as ``smoke6`` and
    restored by --continue_train. The compared step is Adam's second, whose
    update is at most ~1.05 lr (the bound the parameter check takes); the
    first is not compared: its update is lr * sign(g), so the G step's
    gradient, taken against the updated D, jumps with the sign of D-gradient
    elements that are zero up to roundoff.
    Even from the shared state, the step's gradients are ill-conditioned:
    the CPU against itself with real_A scaled by 1 + 1e-6 moves R's weight
    gradients by up to 1.6% (measured; the smoothness term alone is stable,
    the image terms are not: likely relu masks and the recon L1's sign
    flipping where a value sits within roundoff of 0, reached by R through
    the warp). So each gradient is held to max(1e-3, 3 x its
    baseline), the baseline being the CPU against itself with real_A scaled
    by 1 + PERTURB (printed)."""
    pairs = request_batches(2, 1, seed=5)
    args = [*TRAIN_ARGS, "--checkpoints_dir", ckpt, "--continue_train", "--batch_size", "1"]
    card = train_model([*args, "--epoch", "smoke", "--gpu_ids", "0"])
    card.optimizers = card.make_optimizers()  # phase 5's nets, a fresh Adam
    card.set_input(pairs[0])
    card.optimize_parameters()
    card.save_networks("smoke6")
    runs = {"card": card}
    for name in ("cpu", "cpu_perturbed"):
        runs[name] = train_model([*args, "--epoch", "smoke6", "--gpu_ids", "-1"])
    before = {}
    for name, m in runs.items():
        before[name] = {n: {k: p.detach().cpu().clone() for k, p in net.named_parameters()}
                        for n, net in m.nets().items()}
        scale = np.float32(1 + PERTURB) if name == "cpu_perturbed" else np.float32(1)
        m.set_input(dict(pairs[1], A=pairs[1]["A"] * scale))
        m.optimize_parameters()
    losses = {name: m.get_current_losses() for name, m in runs.items()}
    lc = losses["cpu"]

    def loss_rel(other):
        return {k: abs(other[k] - lc[k]) / max(abs(lc[k]), 1e-12) for k in lc}

    loss_errs, loss_base = loss_rel(losses["card"]), loss_rel(losses["cpu_perturbed"])
    skip = _in_biases(card)
    bound = card.opt.lr * 1.1  # Adam's step bound from a warm state, with margin
    grad_worst, bias_err, param_err, unresolved, fails = [], 0.0, 0.0, 0, []
    per_net = {}
    for n in ("G", "D", "R"):
        net_grad, net_base, net_param = 0.0, 0.0, 0.0
        params = {name: dict(m.nets()[n].named_parameters()) for name, m in runs.items()}
        for key in params["cpu"]:
            gc = _grad(params["cpu"], key)
            gg, gp = _grad(params["card"], key), _grad(params["cpu_perturbed"], key)
            if key in skip[n]:  # roundoff of a 65536-term sum that is 0 exactly,
                # relative to the conv's weight gradient (absolute below norm 1)
                scale = float(torch.linalg.vector_norm(_grad(params["cpu"],
                                                             key.replace(".bias", ".weight"))))
                bias_err = max(bias_err, max(float(gg.abs().max()), float(gc.abs().max()))
                               / max(scale, 1.0))
                continue
            norm = float(torch.linalg.vector_norm(gc))
            if norm == 0.0:  # no gradient at this state: none on the card either
                if torch.any(gg):
                    fails.append(f"grad {n}.{key}: non-zero on the card only")
                continue
            err = float(torch.linalg.vector_norm(gg - gc)) / norm
            base = float(torch.linalg.vector_norm(gp - gc)) / norm
            grad_worst.append((f"{n}.{key}", err, base))
            net_grad, net_base = max(net_grad, err), max(net_base, base)
            if err > max(1e-3, 3 * base):
                fails.append(f"grad {n}.{key}: {err} (baseline {base})")
            # where the two gradients agree to 1e-3, so must the updates (to
            # 1e-5); the other elements move by at most one Adam step each
            free = (gg - gc).abs() > 1e-3 * gc.abs()
            unresolved += int(free.sum())
            dcard = params["card"][key].detach().cpu() - before["card"][n][key]
            dcpu = params["cpu"][key].detach() - before["cpu"][n][key]
            if float(torch.where(free, dcard.abs() + dcpu.abs(), 0.0).max()) > 2 * bound:
                fails.append(f"{n}.{key}: an unresolved element moved more than lr")
            net_param = max(net_param, float(torch.where(free, 0.0, dcard - dcpu).abs().max()))
        per_net[n] = {"grad_err": net_grad, "grad_baseline": net_base, "param_err": net_param}
        param_err = max(param_err, net_param)
    grad_worst.sort(key=lambda t: -t[1])
    phase("train_card_vs_cpu", loss_rel_err=json.dumps(loss_errs),
          loss_baseline=json.dumps(loss_base), tol_losses=1e-4,
          worst_grads_err_baseline=json.dumps(grad_worst[:8]), per_net=json.dumps(per_net),
          grads_max_rel_err=grad_worst[0][1], tol_grads="max(1e-3, 3 x baseline)",
          in_bias_grad_over_weight_grad=bias_err, tol_in_bias=1e-4,
          unresolved_elements=unresolved, params_max_abs_err=param_err, tol_params=1e-5)
    if max(loss_errs.values()) > 1e-4:
        fails.append(f"losses {loss_errs}")
    if bias_err > 1e-4 or param_err > 1e-5:
        fails.append(f"IN biases {bias_err}, params {param_err}")
    if fails:
        raise AssertionError("card and CPU disagree on the training step: " + "; ".join(fails))
    del runs, card

    # two fresh, identical two-step runs on the card
    batches = request_batches(2, TRAIN_BATCH, seed=6)
    outs = []
    for _ in range(2):
        m = train_model([*TRAIN_ARGS, "--checkpoints_dir", ckpt, "--continue_train",
                         "--epoch", "smoke", "--gpu_ids", "0", "--batch_size", str(TRAIN_BATCH)])
        losses = []
        for b in batches:
            m.set_input(b)
            m.optimize_parameters()
            losses.append(list(m.get_current_losses().values()))
        outs.append((np.array(losses), [p.detach().clone() for p in
                                        (*m.netG.parameters(), *m.netD.parameters(),
                                         *m.netR.parameters())]))
        del m
    loss_diff = float(np.abs(outs[0][0] - outs[1][0]).max())
    param_diff = max(float((a - b).abs().max()) for a, b in zip(outs[0][1], outs[1][1]))
    phase("train_determinism", steps=2, batch=TRAIN_BATCH, max_loss_diff=loss_diff,
          max_param_diff=param_diff)
    if loss_diff != 0.0 or param_diff != 0.0:
        raise AssertionError("two identical training runs on the card differ")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from nemar_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    smi = smi.strip().splitlines()[0]
    phase("env", python=sys.version.split()[0], torch=torch.__version__,
          cuda=torch.version.cuda, device=repr(torch.cuda.get_device_name(0)),
          count=torch.cuda.device_count())
    print(smi, flush=True)

    path, secs = _build.build()
    ptxas = path.with_suffix(".log").read_text().splitlines()
    phase("build", library=os.path.relpath(path, ROOT), nvcc_seconds=round(secs, 2),
          registers=json.dumps([ln.split("Used ")[1].split(",")[0]
                                for ln in ptxas if "Used " in ln]),
          spill_bytes=sum(int(b) for ln in ptxas for b in re.findall(r"(\d+) bytes spill", ln)))

    t0 = time.perf_counter()
    results = check_kernels(dev)
    phase("kernels", seconds=round(time.perf_counter() - t0, 2),
          trace_retries=json.dumps(TRACE_RETRIES))
    TRACE_RETRIES.clear()
    t0 = time.perf_counter()
    results.update(check_bwd_kernels(dev))
    phase("kernels_bwd", seconds=round(time.perf_counter() - t0, 2),
          trace_retries=json.dumps(TRACE_RETRIES))

    with tempfile.TemporaryDirectory(prefix="nemar_smoke_") as ckpt:
        launches, first, batch = run_slice(ckpt)
        compare_with_cpu(ckpt, first, batch)
        t0 = time.perf_counter()
        train_launches = run_train(ckpt)
        phase("train_phase", seconds=round(time.perf_counter() - t0, 2))
        t0 = time.perf_counter()
        run_layout_flags(ckpt)
        phase("layout_flags_phase", seconds=round(time.perf_counter() - t0, 2))
        t0 = time.perf_counter()
        compare_train_with_cpu(ckpt)
        phase("train_vs_cpu_phase", seconds=round(time.perf_counter() - t0, 2))
    # the inference kernels' launches come from phase 3, the backward ones'
    # from phase 5 (the inference path launches none)
    launches.update({k: v for k, v in train_launches.items() if k.endswith("-bwd")})

    sources = {"K-block": ("cuda", "nemar_tpu_torch/csrc/resblock_fwd.cu",
                           "nemar_tpu/ops/conv_fused.py:228"),
               "K-warp": ("cuda", "nemar_tpu_torch/csrc/warp_fwd.cu",
                          "nemar_tpu/ops/warp_pallas.py:152"),
               "K-in": ("triton", "nemar_tpu_torch/ops/norm_triton.py",
                        "nemar_tpu/ops/norm.py:193"),
               "K-head": ("cuda", "nemar_tpu_torch/csrc/head_fwd.cu",
                          "nemar_tpu/ops/conv_head_roll.py:151"),
               "K-convt": ("cuda", "nemar_tpu_torch/csrc/convt_fwd.cu",
                           "nemar_tpu/ops/attic/convt_fused.py:105"),
               "K-block-bwd": ("cuda", "nemar_tpu_torch/csrc/resblock_bwd.cu",
                               "nemar_tpu/ops/conv_fused.py:544"),
               "K-warp-bwd": ("cuda", "nemar_tpu_torch/csrc/warp_bwd.cu",
                              "nemar_tpu/ops/warp_pallas.py:448"),
               "K-in-bwd": ("triton", "nemar_tpu_torch/ops/norm_triton.py",
                            "nemar_tpu/ops/norm.py:89"),
               "K-head-bwd": ("cuda", "nemar_tpu_torch/csrc/head_bwd.cu",
                              "nemar_tpu/ops/conv_head_roll.py:174"),
               "K-convt-bwd": ("cuda", "nemar_tpu_torch/csrc/convt_bwd.cu",
                               "nemar_tpu/ops/attic/convt_fused.py:216")}
    kernels = [{"name": k, "route": r, "source": s, "replaces": rep, "launches": launches[k],
                **results[k]} for k, (r, s, rep) in sources.items()]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
