#!/usr/bin/env python3
"""Smoke run of nemar_tpu_torch on one NVIDIA card (H100): build, check, time.

    python3 chip_smoke.py            # from the repository root; needs one CUDA device

Drives the port's inference path — NeMAR's default model at full width and
256^2 (ResNet-6 G at ngf 64, depth-5 UNet STN at stn_ngf 32, 70x70
PatchGAN D built and loaded) — through the entry points a user calls, and
prints one line per phase. Any failure raises and the exit code is not 0.

  0. environment: versions, the card, ``nvidia-smi``'s name and power limit;
  1. build: nvcc compiles nemar_tpu_torch/csrc/*.cu (Triton compiles K-in at
     its first launch in phase 2);
  2. each kernel against its plain PyTorch version on the card, at the
     slice's shapes, with TF32 off: max abs error against the stated
     tolerance, and the median CUDA-event time of kernel and plain version;
  3. the slice: options parsed as ``nemar_tpu_torch.test`` parses them
     (``--gpu_ids 0``), seeded checkpoints written (the flow head drawn
     non-zero, so the warp samples between pixels) and loaded by
     ``setup()``, then 8 requests of batch 1 (set_input -> test ->
     get_current_visuals + the registration metrics). The launch counters
     are zeroed just before and must show K-block 12, K-warp 1 and K-in 20
     launches per request. Then the same model at batch 8, and a
     torch.profiler pass over 3 batch-1 requests: device time by kernel
     name and input shape (chiprun_out/profile_b1.txt) and the device's busy
     share of that window;
  4. card against CPU: the same checkpoints on a CPU model (the plain
     path), one request, outputs and flow within 1e-3.

The line before the last is a JSON object with one entry per kernel
(``ms``/``plain_ms``: the kernel's and the plain version's device time for
one request at batch 1, summed over that request's calls); the last line is
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
# (C, H, W, act, calls per request) of every instance norm outside the trunk
IN_SHAPES = [
    (64, 256, 256, "relu", 4), (128, 128, 128, "relu", 4), (256, 64, 64, "relu", 2),  # G x2
    (32, 128, 128, "leaky_relu", 2), (64, 64, 64, "leaky_relu", 2),                   # STN
    (128, 32, 32, "leaky_relu", 2), (256, 16, 16, "leaky_relu", 2),
    (256, 8, 8, "leaky_relu", 1), (32, 256, 256, "leaky_relu", 1),
]
TOL = {"K-warp": 1e-5, "K-in": 1e-5, "K-block": 1e-3}


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


def check_kernels(dev) -> dict:
    """Phase 2: every kernel against its plain version at the slice's shapes."""
    from nemar_tpu_torch.ops import conv_fused, norm, norm_triton, warp, warp_cuda

    rng = np.random.default_rng(0)
    results = {}

    # K-warp: the slice's one sample per request, (fake_B, real_A) = 4 channels
    per_request = {}
    for n in (1, 8):
        img = torch.from_numpy(smooth_images(rng, n, 4)).to(dev)
        grid = smooth_grid(rng, n, 256, 256).to(dev)
        xs, ys = (c.contiguous() for c in warp._pixel_coords(img, grid, "zeros", False))
        got = warp_cuda.warp_bilinear(img, xs, ys)
        ref = warp._sample_plain(img, xs, ys, "bilinear")
        err = torch.max(torch.abs(got - ref)).item()
        frac = torch.mean(((xs - xs.floor()) > 1e-3).float()).item()
        ms = median_ms(lambda: warp_cuda.warp_bilinear(img, xs, ys))
        pms = median_ms(lambda: warp._sample_plain(img, xs, ys, "bilinear"))
        phase("kernel", name="K-warp", shape=f"{n}x256x256x4", max_abs_err=err,
              tol=TOL["K-warp"], ms=ms, plain_ms=pms, fractional_x=round(frac, 3))
        if not err <= TOL["K-warp"]:
            raise AssertionError(f"K-warp disagrees with its plain version: {err}")
        if n == 1:
            per_request = {"max_abs_err": err, "ms": ms, "plain_ms": pms}
    results["K-warp"] = per_request

    # K-in: every instance norm shape of one request, batch 1
    tot = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
    for c, h, w, act, calls in IN_SHAPES:
        x = torch.from_numpy((rng.standard_normal((1, h, w, c)) * 2 + 0.5).astype(np.float32)).to(dev)
        got = norm_triton.instance_norm_act_triton(x, act)
        ref = norm.instance_norm_act_plain(x, act)
        err = torch.max(torch.abs(got - ref)).item()
        ms = median_ms(lambda: norm_triton.instance_norm_act_triton(x, act))
        pms = median_ms(lambda: norm.instance_norm_act_plain(x, act))
        phase("kernel", name="K-in", shape=f"1x{h}x{w}x{c}", act=act, calls=calls,
              max_abs_err=err, tol=TOL["K-in"], ms=ms, plain_ms=pms)
        if not err <= TOL["K-in"]:
            raise AssertionError(f"K-in disagrees with its plain version at {(c, h, w)}: {err}")
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        tot["ms"] += calls * ms
        tot["plain_ms"] += calls * pms
    results["K-in"] = tot

    # K-block: the trunk, N x 64 x 64 x 256, 6 blocks x 2 G passes per request
    for n in (1, 8):
        x = torch.from_numpy(rng.standard_normal((n, 64, 64, 256)).astype(np.float32)).to(dev)
        w1, w2 = (torch.from_numpy((0.02 * rng.standard_normal((3, 3, 256, 256))).astype(np.float32)).to(dev)
                  for _ in range(2))
        got = conv_fused.fused_resblock_cuda(x, w1, w2)
        ref = conv_fused.resblock_plain(x, w1, w2)
        err = torch.max(torch.abs(got - ref)).item()
        ms = median_ms(lambda: conv_fused.fused_resblock_cuda(x, w1, w2), iters=10)
        pms = median_ms(lambda: conv_fused.resblock_plain(x, w1, w2), iters=10)
        flops = 2 * 2 * n * 64 * 64 * 256 * 9 * 256
        phase("kernel", name="K-block", shape=f"{n}x64x64x256", max_abs_err=err,
              tol=TOL["K-block"], ms=ms, plain_ms=pms,
              tflops=round(flops / ms / 1e9, 2), plain_tflops=round(flops / pms / 1e9, 2))
        if not err <= TOL["K-block"]:
            raise AssertionError(f"K-block disagrees with its plain version: {err}")
        if n == 1:
            results["K-block"] = {"max_abs_err": err, "ms": 12 * ms, "plain_ms": 12 * pms}
    torch.cuda.synchronize()
    return results


def launch_counters():
    from nemar_tpu_torch.ops import conv_fused, norm_triton, warp_cuda

    return {"K-block": conv_fused.fused_resblock_cuda, "K-warp": warp_cuda.warp_bilinear,
            "K-in": norm_triton.instance_norm_act_triton}


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

    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
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
    want = {"K-block": 12 * REQUESTS, "K-warp": REQUESTS, "K-in": 20 * REQUESTS}
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


def profile_request(model, batch, reps: int = 3) -> None:
    """Device time by kernel name for batch-1 requests, and the device's busy
    share of the window (kernel time over wall time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            model.set_input(batch)
            model.test()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device work = the kernel, memcpy and memset events (an aten op's
    # "self device time" repeats the time of the kernels it launched)
    device_us = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=30)
    table += "\n" + prof.key_averages(group_by_input_shape=True).table(
        sort_by="self_device_time_total", row_limit=20)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "profile_b1.txt"), "w") as f:
        f.write(table)
    phase("profile", requests=reps, wall_ms_per_request=round(wall_us / reps / 1e3, 3),
          device_ms_per_request=round(device_us / reps / 1e3, 3),
          device_busy_share=round(device_us / wall_us, 3))


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
    phase("kernels", seconds=round(time.perf_counter() - t0, 2))

    with tempfile.TemporaryDirectory(prefix="nemar_smoke_") as ckpt:
        launches, first, batch = run_slice(ckpt)
        compare_with_cpu(ckpt, first, batch)

    sources = {"K-block": ("cuda", "nemar_tpu_torch/csrc/resblock_fwd.cu",
                           "nemar_tpu/ops/conv_fused.py:228"),
               "K-warp": ("cuda", "nemar_tpu_torch/csrc/warp_fwd.cu",
                          "nemar_tpu/ops/warp_pallas.py:152"),
               "K-in": ("triton", "nemar_tpu_torch/ops/norm_triton.py",
                        "nemar_tpu/ops/norm.py:193")}
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
