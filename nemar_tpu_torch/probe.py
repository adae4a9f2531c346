"""Times of K-warp-bwd and K-block-bwd at the training step's shapes, and
the SASS of every kernel, for one tree of the port.

    python3 nemar_tpu_torch/probe.py [--root DIR]

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
- ``block_bwd``: one K-block-bwd call at 8 x 64 x 64 x 256, fed the plain
  forward's saved values: the median CUDA-event time of 20 calls, and the
  device time by kernel (12 launches a call);
- ``sass``: for each kernel of the tree's library, its SASS instructions
  (``cuobjdump -sass``) counted and hashed, so that two trees' lines show
  which kernels compile to the same code;
- the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import shutil
import subprocess
import sys
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=CHECKOUT)
    args = ap.parse_args()
    sys.path.insert(0, str(CHECKOUT))
    import chip_smoke
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve()))
    from nemar_tpu_torch.ops import _build, conv_fused, warp

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

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "root": str(args.root.resolve()), "card": smi,
        "warp_bwd": {"shape": [n, 256, 256, 4], "grad_channels": 3, "device_ms": warp_ms,
                     "by_kernel": warp_by, "library_device_ms": lib_ms,
                     "library_by_kernel": lib_by},
        "block_bwd": {"shape": [n, 64, 64, 256], "event_ms": event_ms, "device_ms": block_ms,
                      "by_kernel": block_by},
        "sass": sass_digest(_build.library_path(), _build._nvcc())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
