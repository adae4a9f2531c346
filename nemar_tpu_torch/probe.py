"""Times of K-warp-bwd, K-block, K-block-bwd, K-convt and K-convt-bwd at the
training step's shapes, of the b8 training step, and the SASS of every
kernel, for one tree of the port.

    python3 nemar_tpu_torch/probe.py [--root DIR]
    python3 nemar_tpu_torch/probe.py --trace-check N

Needs one CUDA device and the CUDA toolkit. Imports ``nemar_tpu_torch``
from ``--root`` (default: the checkout this file lies in), so that another
tree, e.g. a parent commit unpacked by ``git archive``, is measured by the
same code: this checkout's ``chip_smoke.median_ms`` and
``chip_smoke.device_ms`` (which raises unless every traced call shows the
same launches). Two trees are compared by running this alternately in
fresh processes on one card (parent, change, change, parent, ...). Prints
one JSON line:

- ``warp_bwd``: the grid-sample backward as the model runs it
  (``torch.autograd.grad`` through ``ops.warp.grid_sample``, 8 x 256 x 256
  x 4, d img for 3 channels, a smooth field of a few pixels): device time
  by kernel in launch order, and ``aten.grid_sampler_2d_backward``'s on the
  same image, grid and g;
- ``block`` and ``block_bwd``: one K-block and one K-block-bwd call at
  8 x 64 x 64 x 256 (the backward fed the plain forward's saved values): the
  median CUDA-event time of 20 calls, and the device time by kernel (12
  launches a call for the backward);
- ``convt``: one K-convt and one K-convt-bwd call at each decoder stage at
  batch 1 and 8 (``chip_smoke.CONVT_SHAPES``; the backward fed the plain
  forward's saved values): the median CUDA-event time of 20 calls, and the
  device time by kernel (the same launches in every traced call);
- ``train_step``: the b8 training step of ``chip_smoke.py``'s phase 5 (its
  options and seeded batches): the median host time of 6 steps after 2
  warm-up steps, each ending in ``torch.cuda.synchronize()``;
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
    ap.add_argument("--trace-check", type=int, default=0, metavar="N",
                    help="measure the profiler's trace window over N traces and exit")
    args = ap.parse_args()
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

    img = chip_smoke.randn(rng, (n, 256, 256, 4), 1.0, dev)
    grid = chip_smoke.smooth_grid(rng, n, 256, 256).to(dev)
    g = chip_smoke.randn(rng, (n, 256, 256, 4), 1.0, dev)
    img_rg, grid_rg = img.clone().requires_grad_(), grid.clone().requires_grad_()
    out = warp.grid_sample(img_rg, grid_rg, "bilinear", "zeros", False, 3)
    img_nchw, g_nchw = img.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    warp_ms, warp_by = chip_smoke.device_ms(
        lambda: torch.autograd.grad(out, (img_rg, grid_rg), g, retain_graph=True), None, 20)
    lib_ms, lib_by = chip_smoke.device_ms(
        lambda: torch.ops.aten.grid_sampler_2d_backward(g_nchw, img_nchw, grid, 0, 0, False,
                                                        [True, True]), None, 20)

    x, gb = (chip_smoke.randn(rng, (n, 64, 64, 256), 1.0, dev) for _ in range(2))
    w1, w2 = (chip_smoke.randn(rng, (3, 3, 256, 256), 0.02, dev) for _ in range(2))
    saved = conv_fused.resblock_fwd_plain(x, w1, w2)[1:]

    def block_bwd():
        return conv_fused.resblock_bwd_cuda(x, w1, w2, *saved, gb)

    event_ms = chip_smoke.median_ms(block_bwd)
    block_ms, block_by = chip_smoke.device_ms(block_bwd, 12, 10)
    block_fwd_ms = chip_smoke.median_ms(lambda: conv_fused.fused_resblock_cuda(x, w1, w2))

    convt = {}
    for (h, w, ci, co, _), b in ((shape, b) for shape in chip_smoke.CONVT_SHAPES for b in (1, n)):
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

    with tempfile.TemporaryDirectory(prefix="nemar_probe_") as ckpt:
        model = chip_smoke.train_model([*chip_smoke.TRAIN_ARGS, "--gpu_ids", "0",
                                        "--checkpoints_dir", ckpt, "--batch_size", str(n)])
        times = []
        for i, b in enumerate(chip_smoke.request_batches(8, n, seed=4)):
            t0 = time.perf_counter()
            model.set_input(b)
            model.optimize_parameters()
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
        del model

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "root": str(args.root.resolve()), "card": smi,
        "warp_bwd": {"shape": [n, 256, 256, 4], "grad_channels": 3, "device_ms": warp_ms,
                     "by_kernel": warp_by, "library_device_ms": lib_ms,
                     "library_by_kernel": lib_by},
        "block": {"shape": [n, 64, 64, 256], "event_ms": block_fwd_ms},
        "block_bwd": {"shape": [n, 64, 64, 256], "event_ms": event_ms, "device_ms": block_ms,
                      "by_kernel": block_by},
        "convt": convt,
        "train_step": {"batch": n, "ms_median": float(np.median(times)), "ms": times},
        "sass": sass_digest(_build.library_path(), _build._nvcc())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
