#!/usr/bin/env python3
"""Smoke run of nemar_tpu_torch on one NVIDIA card (H100): build, check, time.

    python3 chip_smoke.py            # from the repository root; needs one CUDA device

Drives the port's inference path and its training step — NeMAR's default
model at full width and 256^2 (ResNet-6 G at ngf 64, depth-5 UNet STN at
stn_ngf 32, 70x70 PatchGAN D at ndf 64) — through the entry points a user
calls, and prints one line per phase. Any failure raises and the exit code
is not 0.

  0. environment: versions, the card, ``nvidia-smi``'s name and power limit;
  1. build: one nvcc per nemar_tpu_torch/csrc/*.cu and csrc/ops.cpp, all at
     once, then a link;
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
     a launch is taken again, then fails the run). K-in is checked at every
     instance norm of a batch-1 request and of a batch-8 training step's
     forward: twice bit for bit, its event and device time per call (one
     launch a call, asserted), and F.instance_norm on the same data (no
     activation) beside it as a yardstick, not as the library call. K-head
     and its library call also by their device time; at the model's shape
     K-head takes its wgmma route (a 3xTF32 GEMM, one launch a call,
     asserted by the kernel's name), held also against a float64 run (at
     most 4x the fp32 plain version's error), bit for bit across two calls,
     with its tensor-core bound ``tc_bound_ms``; its direct route (the
     shapes off the model's) at one such shape against its plain version;
  2b. each backward kernel likewise, at the training step's shapes (batch
     8); K-block-bwd and K-convt-bwd are fed the plain forward's saved
     values, and their comparison with their own forward's is shown beside.
     K-in-bwd is timed like K-in, at the batch-8 and the batch-1 step's
     shapes, with F.instance_norm's autograd backward as its yardstick.
     K-warp-bwd's library time is aten.grid_sampler_2d_backward's on the
     same image, grid and g. K-block-bwd, K-convt-bwd and K-head-bwd (at
     the batch-8 and the batch-1 step's shapes; and in phase 2 K-block and
     K-convt), whose GEMMs run in 3xTF32 on the tensor cores,
     also print their TFLOP/s, their tensor-core bound ``tc_bound_ms``
     (their fp32 products x 3 at 495 TFLOP/s TF32) beside the fp32
     ``bound_ms``, their device time per launch from the profiler (the
     launches of each traced call asserted), and their largest relative
     error against the plain version run in float64, which must be at most
     4x the fp32 plain version's. Beside K-convt and K-convt-bwd, cuDNN's
     transposed convolution at the same shapes (forward, and backward to
     dx and dw; deterministic, TF32 off) is timed as a yardstick for their
     GEMMs, and beside K-head-bwd cuDNN's backward of the same function
     (the convolution's, then the reflect pad's: two calls), by event and
     device time, with the deterministic and the default algorithms.
     Then K-in's double backward (the WGAN-GP penalty's, through D) at D's
     three instance norms of the penalty's pass, at phase 10's microbatch
     of 4 and at batch 8: d x by K-in-bwd
     and the VJP of (x, g) -> d x by stock ops against the plain function's
     autograd on the card, within 1e-4 of the largest value, one K-in and
     one K-in-bwd launch a call (asserted).
     In phases 2 and 2b also the bf16 variants (--bf16) of K-block,
     K-convt, K-in and their backwards against their plain versions at bf16
     on the same bf16 inputs, at the shapes of phases 2, 2b, 10 and 11
     (``check_bf16_kernels``, ``check_bf16_bwd_kernels``; phases 8, 12 and
     12b hold them at their own shapes): each bf16 output
     within one bf16 ulp of its value (K-block's forward stage by stage;
     downstream of a rounding inside the kernel, of the tensor's largest
     value), the fp32 statistics within 1e-5, twice bit for bit; the GEMM
     variants at phase 2's b1 and phase 2b's b8 shapes also against a
     float64 computation from the same bf16 inputs with the same roundings
     (no worse than the plain fp32 version), timed by event and device time
     (launches asserted) beside cuDNN's bf16 convolutions of the same shapes;
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
     1e-4 relative, every gradient within max(1e-3, 3 x the median of the
     step's own conditioning baselines from PERTURBATIONS perturbed inputs)
     (‖Δg‖/‖g‖; the limit of the first baseline alone is printed beside
     it), the updated parameters within 1e-5
     (with the Adam caveat of tests/test_torch_nemar_train.py); see
     ``compare_train_with_cpu``. Then two fresh, identical two-step runs on
     the card, which must give bit-identical losses and parameters.
  7. the science recipe's 256^2 multiscale arm (``scripts/science_final.py``'s
     flags, fp32; ``SCIENCE_SHARED``, ``SCIENCE_ARMS``) at batch 8, parsed
     as ``nemar_tpu_torch.train`` parses it, on the port's synthetic data:
     2 warm-up steps, 4 counted ones (ms per step as their median and as
     the window over the steps, pairs/s, the launches per step asserted:
     ``SCIENCE_LAUNCHES``, whose comment works them out, so the STN's 5
     compositions are seen on K-warp and K-warp-bwd), finite losses, every
     head of R moved, a profile of 1 step
     (chiprun_out/profile_science_multiscale.txt); then two fresh two-step
     runs, bit for bit;
  7b. the affine arm likewise (Dense_1, R's head, must move);
  7c. each arm's trained R, its heads moved by a seeded draw so that the
     field is a few pixels (at least 10x the tolerance), on the card and on
     the CPU, one 256^2 pair: the flow, the grid and both warped images
     within 1e-3;
  8. G at each shape the JAX package runs that does not fill a G kernel's
     tiles (``OFF_KERNEL_SHAPES``: ``--ngf 16``, a 48^2 crop,
     ``--output_nc 9``, ``--ngf 6``): first each of G's ops at the shape
     through its autograd op (the wrappers' channel padding, K-head's
     chunks of 8, K-block's masked pixel tails) against its plain version,
     values and gradients; then a b1 training step with the counters zeroed
     just before: every G kernel's launches asserted (K-head's and
     K-head-bwd's once a chunk), the seven losses within 1e-4 relative of
     the CPU's step from the same state, and a second card run bit for bit.
  9. the JAX package's default-on adversarial gate
     (``tests/test_adversarial_gate.py``: 48^2, 96 pairs, 22 epochs, G and
     D at ngf 32, the damped depth-4 multiscale UNet STN), through
     ``nemar_tpu_torch.science.run_adversarial_gate`` on the card: the best
     held-out direction cosine of the last 6 epochs above 0.5 and the
     field above 0.4 px, as there; the launches of every kernel over the
     run asserted (``ADV_GATE_STEP``, ``ADV_GATE_EVAL``, worked out in
     their comment); the trail, ms per step and seconds printed.
  10. the rest of the JAX package's training step (ROADMAP.md A5,
     ``A5_FLAGS``: --init_type xavier, --ema_decay 0.999, --pool_size 50,
     --grad_accum 2, --gan_mode wgangp) on the default model at 256^2,
     batch 8: two fresh runs of 8 steps bit for bit (parameters, EMA
     shadows, pool, losses), past the pool's filling (its swaps counted and
     asserted); in the first step, K-in, K-in-bwd, K-warp and K-warp-bwd
     against their plain versions at every configuration the step gives
     them, on its own activations, and then G's kernels at the microbatch's
     shapes (``check_g_kernels_at``); 4 more steps with every kernel's launches per step asserted
     (``accum_launches``), K-in-bwd at least as often per microbatch as in
     phase 5's step, ms per step, pairs/s, peak memory; a repeated-slot pool
     swap on the card against the CPU, bit for bit, the last writer kept; a
     profile of 1 step (chiprun_out/profile_a5_step.txt); then (10b) one
     step at batch 8 (microbatches of 4) on the card against the CPU from
     that run's saved state, as phase 6 holds one, plus the penalty among
     the losses, the EMA shadows and the pool (``compare_a5_with_cpu``);
  11. BASELINE.md config #4 (``B32_ARGS``): 512^2 pairs at batch 32 in 4
     microbatches of 8, lsgan, fp32, full width: 3 steps; in the first,
     K-in, K-in-bwd, K-warp and K-warp-bwd against their plain versions at
     every configuration the step gives them, then G's kernels (K-block,
     K-convt, K-head, values and gradients, the backwards fed the plain
     forward's saved values as in phase 2b) at the microbatch's shapes;
     ms per step, pairs/s, peak memory, launches asserted, a profile of 1
     step (chiprun_out/profile_b32_512.txt). Whether batch 32 fits without
     accumulation is measured by ``nemar_tpu_torch/probe.py --parts
     fit_512``, not here.
  12. --bf16 (ROADMAP.md A7) on the default model at 256^2 (``run_bf16``):
     phase 3's checkpoints through ``nemar_tpu_torch.test``'s options with
     --bf16, 8 b1 requests with every counter zeroed just before (the bf16
     variants' launches, K-warp's and K-head's and their casts asserted:
     ``bf16_launches``, BF16_CASTS_*), then b8, each twice bit for bit; the
     card's bf16 outputs against the CPU's fp32 within 4x the CPU's own
     bf16-vs-fp32 difference; the b8 training step (ms, pairs/s, peak
     memory, launches and casts, two runs bit for bit; in the first step,
     K-in's and K-in-bwd's bf16 variants, K-warp and K-warp-bwd against
     their plain versions at every configuration the step gives them), and
     one b1 step's losses and gradients card against CPU by the same rule;
     phase 8's bf16 step is watched the same way;
  12b. 512^2 b32 under --bf16 --remat in 2 microbatches of 16
     (BF16_B32_ARGS, bench.py's first try at that cell): in the first step
     the watch of phase 12, then the bf16 variants of the core's operators
     at the microbatch's shapes (``check_g_kernels_bf16_at``); ms per step,
     pairs/s, peak memory, launches and casts asserted; then the same
     steps from the same seed without --remat: its launches asserted, the
     parameters bit for bit against the run with it, and the peak memory
     higher than with it (asserted);
  13. cycle_gan at its template defaults (ROADMAP.md A9, ``CYCLE_ARGS``:
     resnet_9blocks at ngf 64, ndf 64, instance norm, lsgan, a pool of 50,
     256^2, batch 1), parsed as ``nemar_tpu_torch.train`` parses it: two
     fresh runs of 3 steps bit for bit (parameters, pools, losses); in the
     first step K-in and K-in-bwd against their plain versions at every
     configuration, then G's kernels at G's shapes (K-head writes Co 3);
     6 timed steps: ms per step, pairs/s, peak memory, the launches per
     step of every kernel asserted (``CYCLE_STEP_LAUNCHES``: 6 G passes, 4
     D passes); a profile of 1 step (chiprun_out/profile_cycle_gan.txt);
  13b. one cycle_gan step on the card against the CPU's at a 64^2 crop with
     the same widths, from one shared state, as phase 6 holds NeMAR's
     (``compare_cycle_with_cpu``);
  14. pix2pix at its template defaults (``PIX2PIX_ARGS``: unet_256 at ngf
     64, batch norm, dropout, vanilla, 256^2, batch 1): two fresh runs of 3
     steps bit for bit (dropout draws from the model's seeded generator on
     the card), 6 timed steps (no kernel launched: batch norm and the
     UNet are plain); then one step under --norm instance with K-in and
     K-in-bwd held at every configuration, the UNet's 2x2x512 planes
     among them, and their launches asserted;
  15. ``--model test --model_suffix _A`` (``nemar_tpu_torch.test``'s
     options) on phase 13's saved G_A: 8 b1 requests, ms a request, the
     launches asserted, each output against G_A's in a cycle_gan model
     restored from the same checkpoint;
  16. --remat on phase 5's step (256^2, batch 8): the parameters after 2
     steps bit for bit against the step without it; then 4 steps of each
     in turns: ms per step, pairs/s, peak memory (lower with --remat,
     asserted) and the launches (the backwards as phase 5's).
  17. --steps_per_execution 4 as a CUDA graph of the step (ROADMAP.md A9b,
     ``run_step_graph``) on phase 5's cell: 10 batches (chunks of 4, 4, 2)
     through ``optimize_parameters_scan`` on the graph and, in a model from
     the same seed, through the same chunk code run eagerly: the mean
     losses, parameters, Adam's state, pool, EMA and step generator bit
     for bit; the eager run's launches phase 5's per step, the graph run's
     two steps' (the eager first and the capture); the peak memory of
     each; then chunks in turns on the graph, the eager chunk code and the
     step-by-step path: ms a step; one chunk of each profiled: device ms,
     busy share, the device events by name equal (a trace that misses
     some is taken again); capturable Adam against plain Adam on copies of
     G's parameters with the same gradients (``adam_capturable_vs_plain``);
  17b. the same under --bf16 (phase 12's cell), and the graph's memory at
     phase 12b's cell (512^2, batch 32, --bf16 --remat --grad_accum 2);
  17c. the same on phase 10's A5 flags with --gan_warmup_epochs 1
     --gan_ramp_epochs 2 --stn_warmup_epochs 1 --stn_ramp_epochs 2, the
     chunks at epochs 1, 2, 3 and the lr assigned between them (nothing
     stale in the graph);
  17d. the b1 fp32 step at k = 8: ms a step on the graph, the eager chunk
     code and the step-by-step path, in turns;
  17e. --async_checkpoint (A12) under --steps_per_execution 2: a save
     returns before any of its files or its meta is written (the writer
     held), the meta names a save only once its files are in place, a run
     resumed with --auto_resume equals the uninterrupted one bit for bit,
     Adam's state loads across the capturable setting both ways; and
     pix2pix with dropout trained 2 steps on the CPU and resumed on the
     card draws at step 3 the masks of a run on the card alone (ROADMAP.md
     queue C 3).
  18. data parallelism through the port's launcher
     (``nemar_tpu_torch.parallel.launch`` with [cuda:0] and NCCL,
     ``run_nccl_world1``): phase 5's cell for NCCL_STEPS steps in a rank
     of world size 1 against the same steps in this process without a
     process group: the launches of all ten kernels per step phase 5's,
     the losses and every parameter bit for bit, ms a step of both, the
     NCCL kernels' device time per step by name from the profiler; then
     --steps_per_execution NCCL_SPE in the rank: the graph's replays bit
     for bit against the eager chunk, the gradients' all-reduces captured
     with the step (run in Python only by its eager first step and its
     capture);
  18b. two ranks sharing cuda:0 over gloo (the launcher called with
     [cuda:0, cuda:0], ``run_gloo_two_ranks``): the NeMAR b8 step (4 rows
     a rank) from phase 6's shared state and pix2pix at its template
     defaults (batch norm over the global batch, dropout drawn for it) at
     global batch GLOO_PIX2PIX_BATCH: the ranks' states bit-identical
     after each of GLOO_STEPS steps, the first step within phase 6's
     limits of the one-process step on the card (``step_against_cpu``),
     ms a step of each rank.

The smoke's total time is printed (``[total]``) before the device lines.
The line before the last is a JSON object with one entry per kernel. For a
forward kernel, ``ms``/``plain_ms``/``library_ms`` are the kernel's, the
plain version's and the library call's device time for one inference
request at batch 1, summed over that request's calls, and ``bound_ms`` the
least time the card could take for the same calls (the larger of their
fp32 operations at 67 TFLOP/s and their bytes at 3.35 TB/s, the H100 SXM's
peaks at 700 W; ``bound_by`` says which); for a backward kernel, the same
for one training step at batch 8. ``launches`` counts phase 3's requests
(forward kernels) or phase 5's steps (backward kernels). K-in's and
K-in-bwd's entries add their device time, their yardstick's event and
device time, and K-in's b8 step and K-in-bwd's b1 step likewise; K-head's
adds its and its library call's device time, K-head-bwd's its device time
and its cuDNN yardstick's event and device time (deterministic). The bf16
variants have entries of their own (``K-block-bf16``, ...): the same
totals at bf16 (their bound's operations at the 989 TFLOP/s bf16 peak),
their launches from phase 12's requests and steps, and cuDNN's bf16
convolutions of the same shapes (F.instance_norm at bf16 for K-in) as a
yardstick. The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings
from types import SimpleNamespace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
START = time.perf_counter()
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
# phase 6's conditioning baselines: the CPU step again from each of
# PERTURBATIONS perturbed inputs (``perturbed``), of relative size PERTURB,
# about how far the card's activations sit from the CPU's (phase 4: up to
# 6.5e-5 absolute on outputs in [-1, 1]); a gradient's limit takes the
# median of its baselines
PERTURB = 1e-5
PERTURBATIONS = 3
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
# phases 7 and 7b: the two 256^2 arms of scripts/science_final.py (its
# flags at :87-127), fp32 (the recipe's --bf16 is its TPU runs' only), at
# batch 8; --epoch_count past each arm's R warm-up and ramp, so R's gate is
# open, as is the GAN's
SCIENCE_SHARED = [
    "--model", "nemar", "--dataset_mode", "synthetic", "--crop_size", "256", "--load_size", "256",
    "--batch_size", "8", "--synthetic_size", "192", "--synthetic_pad_crop",
    "--synthetic_appearance", "smooth", "--synthetic_fresh_affine", "--recon_pyramid", "5",
    "--border_mask", "--stn_lr", "1e-3", "--stn_beta1", "0.9", "--ngf", "32", "--ndf", "32",
    "--stn_ngf", "16", "--stn_depth", "6", "--gpu_ids", "0",
]
SCIENCE_ARMS = {
    "multiscale": ["--stn_type", "unet", "--stn_multiscale", "--stn_level_scale", "0.25",
                   "--stn_bounded_flow", "0.15", "--lambda_smooth", "40",
                   "--stn_smooth_order", "2", "--stn_warmup_epochs", "3",
                   "--stn_ramp_epochs", "8", "--stn_grad_clip", "0.5", "--epoch_count", "12"],
    "affine": ["--stn_type", "affine", "--lambda_smooth", "0.1", "--stn_warmup_epochs", "3",
               "--stn_ramp_epochs", "5", "--stn_grad_clip", "1.0", "--epoch_count", "9"],
}
SCIENCE_STEPS = 4
# Launches per step of the science arms. Both run G at ngf 32 (trunk
# 64^2 x 128, head 32 -> 3: every G kernel takes it) twice, as phase 5:
# K-block 12, K-convt 4, K-head 2 and their backwards alike; K-in 6 for G's
# encoder (3 convs, 2 passes) and 6 for D (3 normed convs, one pass in the
# D step, one in the G step), K-in-bwd the same 12, plus R's:
#  * multiscale, depth 6 at 256^2: 6 + 6 normed convs, so K-in +12 and
#    K-in-bwd +12 (24 each); heads at the decoder's levels 5..1 (8^2 to
#    128^2) and at 256^2, 6 fields, composed in 5 border-padded grid samples
#    of a 2-channel field, each with a backward to the field and to the
#    grid; then the warp of (fake_B, real_A) and --border_mask's validity
#    warp (no gradient): K-warp 5 + 1 + 1 = 7, K-warp-bwd 5 + 1 = 6;
#  * affine, 5 normed convs: K-in 17, K-in-bwd 17; K-warp 1 + 1 = 2 (the
#    warp, the mask), K-warp-bwd 1.
G_STEP = {"K-block": 12, "K-convt": 4, "K-head": 2, "K-block-bwd": 12, "K-convt-bwd": 4,
          "K-head-bwd": 2}
SCIENCE_LAUNCHES = {
    "multiscale": {**G_STEP, "K-in": 24, "K-in-bwd": 24, "K-warp": 7, "K-warp-bwd": 6},
    "affine": {**G_STEP, "K-in": 17, "K-in-bwd": 17, "K-warp": 2, "K-warp-bwd": 1},
}
# phase 8: shapes the JAX package runs that do not fill a G kernel's tiles
# (ROADMAP.md queue C item 1): a 64-channel trunk (padded to 128), a 12^2
# trunk (144 pixels: masked tails), a 9-channel head (two K-head chunks), a
# 12 -> 6 decoder stage (padded to 12 -> 8); each a b1 step on the card and
# on the CPU
OFF_KERNEL_SHAPES = {
    "ngf16": ["--ngf", "16", "--crop_size", "64", "--load_size", "64"],
    "crop48": ["--crop_size", "48", "--load_size", "48", "--stn_depth", "4"],
    "output_nc9": ["--output_nc", "9", "--crop_size", "64", "--load_size", "64"],
    "ngf6": ["--ngf", "6", "--crop_size", "64", "--load_size", "64"],
}
# phase 9: the 48^2 adversarial gate (res, pairs, epochs), 12 steps of 8
# pairs an epoch, evaluated on 12 held-out pairs after each of the last 6
# epochs. G at ngf 32 on a 48^2 crop has a 12^2 x 128 trunk (144 pixels:
# K-block's and K-block-bwd's masked tails) and 2 decoder stages to a
# 3-channel head, two passes a step: K-block 12, K-convt 4, K-head 2 and
# their backwards alike. K-in: G's encoder 3 x 2, D's 3 normed convs in the
# D step and in the G step, R's depth-4 UNet 4 + 4: 20; K-in-bwd the same.
# R has heads at the decoder's levels 3, 2, 1 (6^2, 12^2, 24^2) and at
# 48^2: 4 fields, 3 compositions, each with a backward; then the warp of
# (fake_B, real_A) and --border_mask's validity warp (no gradient): K-warp
# 3 + 1 + 1 = 5, K-warp-bwd 3 + 1 = 4. An evaluation is one forward at
# batch 12 without autograd: G twice, R, the warps, no D and no backward.
ADV_GATE = (48, 96, 22)
ADV_GATE_STEPS = ADV_GATE[2] * (ADV_GATE[1] // 8)
ADV_GATE_EVALS = 6
ADV_GATE_STEP = {**G_STEP, "K-in": 20, "K-in-bwd": 20, "K-warp": 5, "K-warp-bwd": 4}
ADV_GATE_EVAL = {"K-block": 12, "K-convt": 4, "K-head": 2, "K-in": 14, "K-warp": 5,
                 "K-block-bwd": 0, "K-convt-bwd": 0, "K-head-bwd": 0, "K-in-bwd": 0,
                 "K-warp-bwd": 0}
# phase 7c: the std of the seeded draw added to R's heads, for a field of
# about 4 px at 256^2 (multiscale: 6 heads, each level scaled by 0.25)
R_HEAD_DRAW = {"multiscale": 5e-3, "affine": 2e-3}
# phase 2b: D's instance norms at 256^2 in the WGAN-GP penalty's pass over
# the mix of real and fake (one sample a pair, not 2): (C, H, W), at the
# batches D_IN_BATCHES (phase 10's microbatch of 4, and 8)
D_IN_SHAPES = [(128, 64, 64), (256, 32, 32), (512, 31, 31)]
D_IN_BATCHES = (TRAIN_BATCH // 2, TRAIN_BATCH)
# phase 10: the rest of the JAX training step (ROADMAP.md A5) at full width;
# the two bit-for-bit runs take A5_STEPS steps of 8, so the pool of 50
# fills in the 7th and swaps from then on
A5_FLAGS = ["--init_type", "xavier", "--ema_decay", "0.999", "--pool_size", "50",
            "--grad_accum", "2", "--gan_mode", "wgangp"]
A5_STEPS = 8
A5_TIMED_STEPS = 4
# phase 11: BASELINE.md config #4, 512^2 pairs at batch 32, in 4 microbatches
# of 8 (lsgan, fp32)
B32_ARGS = ["--crop_size", "512", "--load_size", "512", "--batch_size", "32",
            "--grad_accum", "4"]
B32_STEPS = 3
# the forward kernels of one forward pass of the step's model (G twice, R,
# the warp), which each microbatch but a lone one runs once more without
# autograd for the D phase (``_train_step_accum``)
FWD_LAUNCHES = {"K-block": 12, "K-convt": 4, "K-head": 2, "K-in": 16, "K-warp": 1}


def accum_launches(k: int, wgangp: bool) -> dict:
    """Launches per step of the default model under --grad_accum k: k times
    a microbatch's, which is phase 5's step plus the D phase's forward
    (FWD_LAUNCHES). Under wgangp each microbatch adds the penalty's D pass
    over the mix (K-in 3), its first-order gradient (K-in-bwd 3, with the
    graph) and, in the D loss's backward, the first-order backward of the
    mix's three instance norms (K-in-bwd 3): the gradient's graph reads
    the first two's outputs, and the third's gets the zero gradient that
    the next convolution's double backward hands its input."""
    micro = {key: v + FWD_LAUNCHES.get(key, 0) for key, v in STEP_LAUNCHES.items()}
    if wgangp:
        micro["K-in"] += 3
        micro["K-in-bwd"] += 6
    return {key: k * v for key, v in micro.items()}


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
    again with its window's padding doubled, from 0.0125 s (5x the 2.4 ms
    a trace can misplace an event by) to 1.6 s, and then
    this raises, so no time is returned that was not measured in full."""
    fn()
    torch.cuda.synchronize()
    seen = []
    for pad_s in (0.0125, 0.025, 0.05, 0.1, 0.2, 0.4, 0.8, 1.6):
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
    """Seeded normals: from a numpy generator, drawn on the host; from a
    torch.Generator on the card, drawn there (large operands: the host
    draws ~50 M values a second)."""
    if isinstance(rng, torch.Generator):
        return scale * torch.randn(shape, generator=rng, device=rng.device)
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(dev)


def card_rng(seed: int) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(seed)


def in_yardstick(x: torch.Tensor, g: torch.Tensor | None = None):
    """F.instance_norm on x's data (its NCHW view), without the activation:
    forward, or given g its autograd backward to x. A yardstick for K-in and
    K-in-bwd, not their library call: no PyTorch call computes IN + relu or
    IN + leaky_relu. The port never calls it."""
    xr = x.permute(0, 3, 1, 2)
    if g is None:
        return lambda: torch.nn.functional.instance_norm(xr)
    xr = xr.detach().requires_grad_()
    y = torch.nn.functional.instance_norm(xr)
    gy = g.permute(0, 3, 1, 2)
    return lambda: torch.autograd.grad(y, xr, gy, retain_graph=True)


IN_TIMES = ("ms", "device_ms", "yardstick_ms", "yardstick_device_ms")


def time_in_call(kern, yard) -> dict:
    """One K-in / K-in-bwd call's CUDA-event time (timed call by call in
    alternation with the yardstick's) and device time from the profiler
    (one launch a call, asserted), and the yardstick's."""
    ms, yms = paired_median_ms(kern, yard, iters=20, warmup=3)
    dms, _ = device_ms(kern, 1, 10)
    ydms, _ = device_ms(yard, None, 10)
    return dict(zip(IN_TIMES, (ms, dms, yms, ydms)))


def check_in(dev) -> dict:
    """K-in in phase 2: every instance norm of one request at batch 1
    (IN_SHAPES; the totals) and every forward of a training step at batch 8
    (IN_BWD_SHAPES, the ``b8_step_*`` totals), each against its plain
    version, twice bit for bit, and timed by ``time_in_call``."""
    from nemar_tpu_torch.ops import norm, norm_cuda

    rng = np.random.default_rng(10)
    tally, step = Tally(), dict.fromkeys(IN_TIMES, 0.0)
    req = dict.fromkeys(IN_TIMES, 0.0)
    cases = ([(1, c, h, w, act, calls) for c, h, w, act, calls in IN_SHAPES]
             + [(TRAIN_BATCH * mult, c, h, w, act, calls)
                for c, h, w, act, mult, calls in IN_BWD_SHAPES])
    for i, (n, c, h, w, act, calls) in enumerate(cases):
        x = randn(rng, (n, h, w, c), 2.0, dev) + 0.5

        def kern():
            return norm_cuda.instance_norm_act_cuda(x, act)

        (got, stats), (again, again_stats) = kern(), kern()
        repeatable = torch.equal(got, again) and torch.equal(stats, again_stats)
        ref = norm.instance_norm_act_plain(x, act)
        err = torch.max(torch.abs(got - ref)).item()
        times = time_in_call(kern, in_yardstick(x))
        pms = median_ms(lambda: norm.instance_norm_act_plain(x, act))
        bnd = bound(6 * x.numel(), x, got)
        request = i < len(IN_SHAPES)
        phase("kernel", name="K-in", shape=f"{n}x{h}x{w}x{c}", act=act, calls=calls,
              per="b1 request" if request else f"b{TRAIN_BATCH} step", max_abs_err=err,
              tol=TOL["K-in"], bitwise_repeatable=repeatable, plain_ms=pms, bound_ms=max(bnd),
              **times)
        if not (err <= TOL["K-in"] and repeatable):
            raise AssertionError(f"K-in disagrees with its plain version at {(n, h, w, c)}: "
                                 f"{err}, repeatable {repeatable}")
        for k, v in times.items():
            (req if request else step)[k] += calls * v
        if request:
            tally.add(calls, err, times["ms"], pms, bnd)
    return dict(tally.result(), **{k: req[k] for k in IN_TIMES[1:]},
                **{f"b8_step_{k}": v for k, v in step.items()})


def check_in_bwd(dev) -> dict:
    """K-in-bwd in phase 2b: every instance-norm backward of a training step
    at batch 8 (the totals), then at batch 1 (the ``b1_step_*`` totals),
    each against its plain version, twice bit for bit, and timed by
    ``time_in_call`` with F.instance_norm's autograd backward as the
    yardstick."""
    from nemar_tpu_torch.ops import norm, norm_cuda

    rng = np.random.default_rng(11)
    n = TRAIN_BATCH
    tally, per_step = Tally(), {b: dict.fromkeys(IN_TIMES, 0.0) for b in (n, 1)}
    for b in (n, 1):
        for c, h, w, act, mult, calls in IN_BWD_SHAPES:
            shape = (b * mult, h, w, c)
            x = randn(rng, shape, 2.0, dev) + 0.5
            g = randn(rng, shape, 1.0, dev)
            _, stats = norm_cuda.instance_norm_act_cuda(x, act)

            def kern():
                return norm_cuda.instance_norm_act_bwd_cuda(x, g, stats, act)

            got, again = kern(), kern()
            ref = norm.instance_norm_act_bwd_plain(x, g, stats, act)
            err = max_rel_err([got], [ref])
            abs_err = float((got - ref).abs().max())
            times = time_in_call(kern, in_yardstick(x, g))
            pms = median_ms(lambda: norm.instance_norm_act_bwd_plain(x, g, stats, act))
            bnd = bound(8 * x.numel(), x, g, stats, got)
            phase("kernel_bwd", name="K-in-bwd", shape="x".join(map(str, shape)), act=act,
                  calls=calls, per=f"b{b} step", max_rel_err=err, tol=TOL["K-in-bwd"],
                  max_abs_err=abs_err, bitwise_repeatable=torch.equal(got, again), plain_ms=pms,
                  bound_ms=max(bnd), **times)
            if not (err <= TOL["K-in-bwd"] and torch.equal(got, again)):
                raise AssertionError(f"K-in-bwd disagrees at {shape} {act}: {err}")
            for k, v in times.items():
                per_step[b][k] += calls * v
            if b == n:
                tally.add(calls, abs_err, times["ms"], pms, bnd)
    return dict(tally.result(), **{k: per_step[n][k] for k in IN_TIMES[1:]},
                **{f"b1_step_{k}": v for k, v in per_step[1].items()})


def check_in_double_bwd(dev) -> None:
    """Phase 2b: K-in's double backward at D_IN_SHAPES (leaky_relu) and
    each of D_IN_BATCHES: d x = the first-order backward (K-in-bwd, through
    the Function that the WGAN-GP penalty differentiates), then the VJP of
    (x, g) -> d x with a random gg (stock ops recomputing the statistics),
    against the same two derivatives of the plain function by autograd on
    the card, within 1e-4 of the largest value; the time of both and the
    K-in and K-in-bwd launches of one call (1 each, asserted)."""
    from nemar_tpu_torch.ops import norm

    rng = np.random.default_rng(14)
    for n, (c, h, w) in ((n, s) for n in D_IN_BATCHES for s in D_IN_SHAPES):
        x = randn(rng, (n, h, w, c), 2.0, dev) + 0.5
        g, gg = randn(rng, x.shape, 1.0, dev), randn(rng, x.shape, 1.0, dev)

        def second_order(fn):
            def call():
                xr, gr = x.clone().requires_grad_(), g.clone().requires_grad_()
                (dx,) = torch.autograd.grad(fn(xr, "leaky_relu"), xr, gr, create_graph=True)
                return (dx.detach(), *torch.autograd.grad(dx, (xr, gr), gg))
            return call

        kern = second_order(norm.instance_norm_act)
        plain = second_order(norm.instance_norm_act_plain)
        counters = zero_counters()
        got = kern()
        torch.cuda.synchronize()
        launches = {k: counters[k].launches for k in ("K-in", "K-in-bwd")}
        ref = plain()
        errs = [max_rel_err([p], [q]) for p, q in zip(got, ref)]
        ms, pms = paired_median_ms(kern, plain, iters=10, warmup=2)
        phase("kernel_double_bwd", name="K-in-bwd", shape=f"{n}x{h}x{w}x{c}", act="leaky_relu",
              max_rel_err_dx_ddx_dg=json.dumps(errs), tol=1e-4, launches=json.dumps(launches),
              ms=ms, plain_ms=pms)
        if launches != {"K-in": 1, "K-in-bwd": 1}:
            raise AssertionError(f"K-in's double backward launched {launches}")
        if not max(errs) <= 1e-4:
            raise AssertionError(f"K-in's double backward disagrees at {x.shape}: {errs}")


def check_kernels(dev) -> dict:
    """Phase 2: every forward kernel against its plain version at the
    slice's shapes. Each kernel's totals are those of one batch-1 request;
    ``library_ms`` times the one PyTorch call that computes the same
    function, where there is one (the port never calls it)."""
    from nemar_tpu_torch.ops import conv_fused, conv_head, convt_fused, warp

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

    results["K-in"] = check_in(dev)

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
    # request; the library call is nn.Conv2d(padding_mode='reflect'); both
    # also by their device time. At this shape K-head takes its wgmma route
    # (ops/conv_head.py:head_fwd_plan; one launch a call, asserted from the
    # trace by name), a 3xTF32 GEMM on the tensor cores: held also against
    # the plain version in float64 (at most 4x the fp32 plain version's
    # error), bit for bit across two calls, with its tensor-core bound. Then
    # its direct route, which shapes off the model's take, at one of them.
    h, w, ci, co, calls = HEAD_SHAPE
    for n in (1, 8):
        x = randn(rng, (n, h, w, ci), 1.0, dev)
        wk = randn(rng, (7, 7, ci, co), 0.02, dev)

        def kern():
            return conv_head.conv_head_cuda(x, wk)

        got, again = kern(), kern()
        repeatable = torch.equal(got, again)
        ref = conv_head.conv_head_plain(x, wk)
        err = torch.max(torch.abs(got - ref)).item()
        ref64 = conv_head.conv_head_plain(x.double(), wk.double())
        err64, plain_err64 = max_rel_err([got.double()], [ref64]), max_rel_err([ref.double()], [ref64])
        del ref64, again
        ms = median_ms(kern)
        pms = median_ms(lambda: conv_head.conv_head_plain(x, wk))
        lib = torch.nn.Conv2d(ci, co, 7, padding=3, padding_mode="reflect", bias=False).to(dev)
        with torch.no_grad():
            lib.weight.copy_(wk.permute(3, 2, 0, 1))
            x_nchw = x.permute(0, 3, 1, 2)
            lib_err = torch.max(torch.abs(lib(x_nchw).permute(0, 2, 3, 1) - ref)).item()
            lms = median_ms(lambda: lib(x_nchw))
            lib_dms, _ = device_ms(lambda: lib(x_nchw), None, 10)
        dms, per_launch = device_ms(kern, 1, 10)
        flops = 2 * n * h * w * 49 * ci * co
        bnd = bound(flops, x, wk, got)
        phase("kernel", name="K-head", shape=f"{n}x{h}x{w}x{ci}->{co}", calls=calls,
              max_abs_err=err, tol=TOL["K-head"], bitwise_repeatable=repeatable,
              rel_err_vs_fp64=err64, plain_fp32_rel_err_vs_fp64=plain_err64, ms=ms,
              device_ms=dms, plain_ms=pms, library_ms=lms, library_device_ms=lib_dms,
              library_err=lib_err, bound_ms=max(bnd), tc_bound_ms=3 * flops / PEAK_TF32_FLOPS * 1e3,
              tflops=round(flops / ms / 1e9, 2), launches_per_call=sum(k for _, k, _ in per_launch),
              device_ms_by_kernel=json.dumps(per_launch))
        if not (err <= TOL["K-head"] and repeatable):
            raise AssertionError(f"K-head disagrees with its plain version: {err}, "
                                 f"repeatable {repeatable}")
        if not err64 <= 4 * plain_err64:
            raise AssertionError(f"K-head is less accurate than fp32 allows: {err64} against "
                                 f"fp64, the fp32 plain version {plain_err64}")
        if "head_fwd_wgmma_kernel" not in per_launch[0][0]:
            raise AssertionError(f"K-head did not take its wgmma route: {per_launch}")
        if n == 1:
            tally = Tally()
            tally.add(calls, err, ms, pms, bnd, lms)
            results["K-head"] = dict(tally.result(gemm=True), device_ms=calls * dms,
                                     library_device_ms=calls * lib_dms)
    x = randn(rng, (2, 37, 70, 20), 1.0, dev)
    wk = randn(rng, (7, 7, 20, 8), 0.02, dev)
    got, again = conv_head.conv_head_cuda(x, wk), conv_head.conv_head_cuda(x, wk)
    ref = conv_head.conv_head_plain(x, wk)
    err = torch.max(torch.abs(got - ref)).item()
    _, per_launch = device_ms(lambda: conv_head.conv_head_cuda(x, wk), 1, 10)
    phase("kernel", name="K-head", route="direct", shape="2x37x70x20->8", max_abs_err=err,
          tol=TOL["K-head"], bitwise_repeatable=torch.equal(got, again),
          device_ms_by_kernel=json.dumps(per_launch))
    if not (err <= TOL["K-head"] and torch.equal(got, again)
            and "head_fwd_direct_kernel" in per_launch[0][0]):
        raise AssertionError(f"K-head's direct route disagrees with its plain version: {err}, "
                             f"{per_launch}")

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


def check_warp_nearest(dev) -> None:
    """Phase 2's line for ``grid_sample(mode='nearest')`` on the card: the
    plain gather (the JAX package's nearest is plain XLA, no Pallas kernel,
    so it has no kernel here either) at the slice's request shape (the
    (fake_B, real_A) pair, 4 channels, 256^2) with a field of a few pixels,
    and on a ragged grid past the frame in each padding mode: the outputs
    equal to the CPU's, d img within 1e-5 of the CPU's (the same sums in
    another order) and the same bits in two calls, d grid zero."""
    from nemar_tpu_torch.ops import warp

    rng = np.random.default_rng(21)
    cases = [("zeros", smooth_images(rng, 1, 4), smooth_grid(rng, 1, 256, 256).cpu())]
    for pad in ("zeros", "border", "reflection"):
        cases.append((pad, smooth_images(rng, 2, 3, 40),
                      torch.from_numpy(rng.uniform(-1.3, 1.3, (2, 23, 31, 2)).astype(np.float32))))
    out_err, dimg_err, deterministic, dgrid_zero = 0.0, 0.0, True, True
    for pad, img, grid in cases:
        g = torch.from_numpy(rng.standard_normal((*grid.shape[:3], img.shape[-1]))
                             .astype(np.float32))
        runs = []
        for d in ("cpu", dev, dev):
            x = torch.from_numpy(img).to(d).requires_grad_()
            t = grid.to(d).requires_grad_()
            out = warp.grid_sample(x, t, "nearest", pad, False)
            dx, dt = torch.autograd.grad(out, (x, t), g.to(d))
            runs.append((out.detach().cpu(), dx.cpu(), dt.cpu()))
        (o0, dx0, _), (o1, dx1, dt1), (_, dx2, _) = runs
        out_err = max(out_err, float((o1 - o0).abs().max()))
        dimg_err = max(dimg_err, float((dx1 - dx0).abs().max()))
        deterministic &= torch.equal(dx1, dx2)
        dgrid_zero &= not torch.any(dt1)
    phase("warp_nearest", route="plain gather (no kernel: plain XLA in the JAX package)",
          cases=len(cases), out_max_abs_err=out_err, dimg_max_abs_err=dimg_err, tol_dimg=1e-5,
          dimg_bit_identical_twice=deterministic, dgrid_zero=dgrid_zero)
    if not (out_err == 0.0 and dimg_err <= 1e-5 and deterministic and dgrid_zero):
        raise AssertionError("grid_sample(mode='nearest') on the card disagrees with the CPU's "
                             "or is not deterministic")


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


def cudnn_head_bwd(x: torch.Tensor, wk: torch.Tensor, g: torch.Tensor, ref: tuple) -> dict:
    """cuDNN's backward of K-head's function at x's shape, TF32 off: the
    convolution's backward to its input and weight on the reflect-padded
    NCHW input (aten.convolution_backward), then the pad's backward
    (aten.reflection_pad2d_backward). A yardstick for K-head-bwd, not its
    library call (two calls compute the function); the port never calls it.
    Its event and device times with cuDNN's deterministic algorithms (as the
    training step runs) and with the default ones, and its largest relative
    error against ``ref`` = (dx, dW)."""
    aten = torch.ops.aten
    x_nchw = x.permute(0, 3, 1, 2)
    xp = torch.nn.functional.pad(x_nchw, (3, 3, 3, 3), mode="reflect")
    wt = wk.permute(3, 2, 0, 1).contiguous()
    gn = g.permute(0, 3, 1, 2).contiguous()

    def run():
        gi, gw, _ = aten.convolution_backward(gn, xp, wt, None, [1, 1], [0, 0], [1, 1], False,
                                              [0, 0], 1, [True, True, False])
        return aten.reflection_pad2d_backward(gi, x_nchw, [3, 3, 3, 3]), gw

    out = {}
    prev = torch.backends.cudnn.deterministic
    try:
        for name, det in (("deterministic", True), ("default", False)):
            torch.backends.cudnn.deterministic = det
            if det:
                dx, dw = run()
                out["yardstick_cudnn_err"] = max_rel_err(
                    [dx.permute(0, 2, 3, 1), dw.permute(2, 3, 1, 0)], ref)
            out[f"yardstick_cudnn_{name}_ms"] = median_ms(run, iters=10)
            out[f"yardstick_cudnn_{name}_device_ms"] = device_ms(run, None, 10)[0]
    finally:
        torch.backends.cudnn.deterministic = prev
    return out


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
    from nemar_tpu_torch.ops import conv_fused, conv_head, convt_fused, norm
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

    results["K-in-bwd"] = check_in_bwd(dev)
    check_in_double_bwd(dev)

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

    # K-head-bwd: G's 7x7 output conv, twice per step, at the b1 and the b8
    # step's shapes. Its two GEMMs run in 3xTF32 on the tensor cores: held
    # also against the plain backward in float64 (dx and dW, at most 4x the
    # fp32 plain version's error), with its device time by launch (3 a call,
    # asserted) and cuDNN's backward of the same function as a yardstick
    # (two calls: the convolution's backward on the reflect-padded input,
    # then the pad's), with the deterministic algorithms the step uses and
    # with the default ones
    h, w, ci, co, calls = HEAD_SHAPE
    for b in (1, n):
        x = randn(rng, (b, h, w, ci), 1.0, dev)
        wk = randn(rng, (7, 7, ci, co), 0.02, dev)
        g = randn(rng, (b, h, w, co), 1.0, dev)

        def kern():
            return conv_head.conv_head_bwd_cuda(x, wk, g)

        got, again = kern(), kern()
        ref = conv_head.conv_head_bwd_plain(x, wk, g)
        err = max_rel_err(got, ref)
        abs_err = max_abs_err(got, ref)
        repeatable = all(torch.equal(p, q) for p, q in zip(got, again))
        ref64 = conv_head.conv_head_bwd_plain(x.double(), wk.double(), g.double())
        err64 = [max_rel_err([p.double()], [q]) for p, q in zip(got, ref64)]
        plain_err64 = [max_rel_err([p.double()], [q]) for p, q in zip(ref, ref64)]
        del ref64, again
        ms = median_ms(kern, iters=20)
        pms = median_ms(lambda: conv_head.conv_head_bwd_plain(x, wk, g), iters=5)
        dms, per_launch = device_ms(kern, 3, 10)
        yard = cudnn_head_bwd(x, wk, g, ref)
        flops = 2 * 2 * b * h * w * 49 * ci * co
        bnd = bound(flops, x, wk, g, *got)
        tc_bound = 3 * flops / PEAK_TF32_FLOPS * 1e3
        phase("kernel_bwd", name="K-head-bwd", shape=f"{b}x{h}x{w}x{ci}->{co}", calls=calls,
              max_rel_err_dx_dw=json.dumps([max_rel_err([p], [q]) for p, q in zip(got, ref)]),
              tol=TOL["K-head-bwd"], max_abs_err=abs_err, bitwise_repeatable=repeatable,
              rel_err_vs_fp64_dx_dw=json.dumps(err64),
              plain_fp32_rel_err_vs_fp64=json.dumps(plain_err64), ms=ms, device_ms=dms,
              plain_ms=pms, tflops=round(flops / ms / 1e9, 2), bound_ms=max(bnd),
              bound_by="operations" if bnd[0] >= bnd[1] else "bytes", tc_bound_ms=tc_bound,
              launches_per_call=sum(k for _, k, _ in per_launch),
              device_ms_by_kernel=json.dumps(per_launch), **yard)
        if not (err <= TOL["K-head-bwd"] and repeatable):
            raise AssertionError(f"K-head-bwd disagrees with its plain version: {err}, "
                                 f"repeatable {repeatable}")
        if not max(err64) <= 4 * max(plain_err64):
            raise AssertionError(f"K-head-bwd is less accurate than fp32 allows: {err64} against "
                                 f"fp64, the fp32 plain version {plain_err64}")
        if b == n:
            tally = Tally()
            tally.add(calls, abs_err, ms, pms, bnd)
            results["K-head-bwd"] = dict(
                tally.result(gemm=True), device_ms=calls * dms,
                yardstick_cudnn_ms=calls * yard["yardstick_cudnn_deterministic_ms"],
                yardstick_cudnn_device_ms=calls * yard["yardstick_cudnn_deterministic_device_ms"])

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
    from nemar_tpu_torch.ops import conv_fused, conv_head, convt_fused, norm_cuda, warp_cuda

    return {"K-block": conv_fused.fused_resblock_cuda, "K-warp": warp_cuda.warp_bilinear,
            "K-in": norm_cuda.instance_norm_act_cuda, "K-head": conv_head.conv_head_cuda,
            "K-convt": convt_fused.fused_convt_in_cuda,
            "K-block-bwd": conv_fused.resblock_bwd_cuda, "K-warp-bwd": warp_cuda.warp_grid_bwd,
            "K-in-bwd": norm_cuda.instance_norm_act_bwd_cuda,
            "K-head-bwd": conv_head.conv_head_bwd_cuda,
            "K-convt-bwd": convt_fused.convt_in_bwd_cuda}


def zero_counters() -> dict:
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    return counters


def request_batches(n_batches: int, n: int, seed: int, size: int = 256):
    rng = np.random.default_rng(seed)
    return [{"A": smooth_images(rng, n, 1, size), "B": smooth_images(rng, n, 3, size),
             "A_paths": [f"smoke_{seed}_{i}_{j}" for j in range(n)]} for i in range(n_batches)]


def run_slice(ckpt: str) -> tuple:
    """Phase 3. Returns (launches, the first request's outputs, that request)."""
    from nemar_tpu_torch.models import create_model
    from nemar_tpu_torch.options import TestOptions
    from nemar_tpu_torch.test import accumulate_metrics, new_metrics, summarize

    opt = TestOptions().parse([*SLICE_ARGS, "--gpu_ids", "0", "--checkpoints_dir", ckpt])
    seeded = create_model(opt)
    head = seeded.netR.heads()[-1]
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


def device_work(prof) -> list:
    """A profile's device work: the kernel, memcpy and memset events (an
    aten op's "self device time" repeats the time of the kernels it
    launched), without the device-side spans of the host's annotations
    (``Optimizer.step#Adam.step`` spans Adam's kernels)."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _is_memory_op(name: str) -> bool:
    """A copy or a memset: eagerly a ``Memcpy ...`` / ``Memset ...`` event,
    in a CUDA graph's replay also the CUDA runtime's own kernels for its memory
    nodes (``memset32``, ``memcpy128``, ...)."""
    return name.lower().startswith(("memset", "memcpy"))


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
    device_us = sum(e.time_range.elapsed_us() for e in device_work(prof))
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
    head = model.netR.heads()[-1]
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


def _zero_grad_biases(model) -> dict:
    """Per net, the biases whose gradient is 0 up to roundoff: those of
    convolutions followed by instance norm and, under wgangp, D's output
    bias (the Wasserstein loss moves by +1 and -1 with it, and the penalty,
    a gradient in D's input, does not see it)."""
    g = {k for k in model.netG.state_dict() if k.endswith(".bias")
         and not k.startswith(f"Conv_{1 + model.netG.n_downsampling}.")}
    d = {f"Conv_{i}.bias" for i in range(1, model.netD.n_layers + 1)}
    if model.gan_mode == "wgangp":
        d.add(f"Conv_{model.netD.n_layers + 1}.bias")
    r = {f"Conv_{i}.bias" for i in range(model.netR.n_convs - 1)}
    return {"G": g, "D": d, "R": r}


def _grad(net_params: dict, key: str) -> torch.Tensor:
    p = net_params[key]
    return torch.zeros_like(p).cpu() if p.grad is None else p.grad.detach().cpu()


def adam_bound(t: int, b1: float, b2: float = 0.999) -> float:
    """max |m / sqrt(v)| of Adam's bias-corrected t-th step over all
    gradient histories: sqrt(sum_k a_k^2 / w_k), a_k and w_k the weights of
    gradient k in m and v (1.054 at t = 2, 1.637 at t = 8 with b1 = 0.5)."""
    return float(np.sqrt(sum(((1 - b1) * b1 ** (t - k) / (1 - b1**t)) ** 2
                             / ((1 - b2) * b2 ** (t - k) / (1 - b2**t))
                             for k in range(1, t + 1))))


def perturbed(arr: np.ndarray, i: int) -> np.ndarray:
    """The i-th of the PERTURBATIONS perturbations of an input batch: the
    batch scaled by 1 + PERTURB (i = 0: the one baseline the check had
    before it took three), by 1 - PERTURB (i = 1), and each element by 1
    +- PERTURB with seeded signs (i = 2)."""
    if i == 0:
        return arr * np.float32(1 + PERTURB)
    if i == 1:
        return arr * np.float32(1 - PERTURB)
    signs = np.random.default_rng(1000 + i).choice(np.float32([-1, 1]), np.shape(arr))
    return (arr * (1 + PERTURB * signs)).astype(np.float32)


def perturbed_runs() -> list:
    return [f"cpu_perturbed_{i}" for i in range(PERTURBATIONS)]


def step_against_cpu(runs: dict, before: dict, loss_floor: float = 0.0,
                     adam_t: int | None = None, nets: dict | None = None,
                     skip: dict | None = None) -> tuple:
    """The comparison of phases 6 and 10: one step on the card against the
    same step on the CPU (``runs['card']``, ``runs['cpu']``) from one shared
    state, and against the CPU's steps from PERTURBATIONS perturbed inputs
    (``runs['cpu_perturbed_<i>']``, ``perturbed``), the conditioning
    baselines: each gradient is held to max(1e-3, 3 x the median of its
    baselines); the limit the check took from the first baseline alone is
    printed beside it, with how many gradients each limit fails and how
    the limit moved (the new over the old, over the gradients). ``before``
    holds each run's parameters before the step. Returns (the fields to print,
    the failures of the gradient and parameter checks, the losses'
    relative errors, each over max(|loss|, loss_floor)). An unresolved
    element may move by at most one Adam step in each run: lr x 1.1 from
    phase 6's second Adam step, or lr x ``adam_bound(adam_t, beta1)`` (+
    1e-3 for roundoff) from the adam_t-th. See ``compare_train_with_cpu``.
    ``nets`` maps each net to its optimizer (NeMAR's G, D, R by default),
    ``skip`` each net to its biases of zero gradient
    (``_zero_grad_biases`` by default)."""
    card = runs["card"]
    pert = perturbed_runs()
    losses = {name: m.get_current_losses() for name, m in runs.items()}
    lc = losses["cpu"]

    def loss_rel(other):
        return {k: abs(other[k] - lc[k]) / max(abs(lc[k]), loss_floor, 1e-12) for k in lc}

    loss_errs = loss_rel(losses["card"])
    loss_bases = [loss_rel(losses[p]) for p in pert]
    loss_base = {k: float(np.median([b[k] for b in loss_bases])) for k in lc}
    skip = _zero_grad_biases(card) if skip is None else skip
    grad_worst, bias_err, param_err, unresolved, fails = [], 0.0, 0.0, 0, []
    old_fails, limit_moves = 0, []
    per_net = {}
    for n, o in (nets or {n: n for n in ("G", "D", "R")}).items():
        group = card.optimizers[o].param_groups[0]
        bound = (card.opt.lr * 1.1 if adam_t is None  # phase 6's, with margin
                 else group["lr"] * adam_bound(adam_t, group["betas"][0]) * (1 + 1e-3))
        net_grad, net_base, net_param = 0.0, 0.0, 0.0
        params = {name: dict(m.nets()[n].named_parameters()) for name, m in runs.items()}
        for key in params["cpu"]:
            gc, gg = _grad(params["cpu"], key), _grad(params["card"], key)
            if key in skip[n]:  # roundoff of a sum that is 0 exactly, relative
                # to the conv's weight gradient (absolute below norm 1)
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
            bases = [float(torch.linalg.vector_norm(_grad(params[p], key) - gc)) / norm
                     for p in pert]
            base = float(np.median(bases))
            old, limit = max(1e-3, 3 * bases[0]), max(1e-3, 3 * base)
            grad_worst.append((f"{n}.{key}", err, bases, old, limit))
            limit_moves.append(limit / old)
            net_grad, net_base = max(net_grad, err), max(net_base, base)
            old_fails += err > old
            if err > limit:
                fails.append(f"grad {n}.{key}: {err} (baselines {bases}, limit {limit})")
            # where the two gradients agree to 1e-3, so must the updates (to
            # 1e-5); the other elements move by at most one Adam step each
            free = (gg - gc).abs() > 1e-3 * gc.abs()
            unresolved += int(free.sum())
            dcard = params["card"][key].detach().cpu() - before["card"][n][key]
            dcpu = params["cpu"][key].detach().cpu() - before["cpu"][n][key]
            if float(torch.where(free, dcard.abs() + dcpu.abs(), 0.0).max()) > 2 * bound:
                fails.append(f"{n}.{key}: an unresolved element moved more than lr")
            net_param = max(net_param, float(torch.where(free, 0.0, dcard - dcpu).abs().max()))
        per_net[n] = {"grad_err": net_grad, "grad_baseline": net_base, "param_err": net_param}
        param_err = max(param_err, net_param)
    grad_worst.sort(key=lambda t: -t[1])
    fields = dict(loss_rel_err=json.dumps(loss_errs), loss_baseline=json.dumps(loss_base),
                  tol_losses=1e-4,
                  worst_grads_err_baselines_old_new_limit=json.dumps(grad_worst[:8]),
                  per_net=json.dumps(per_net), grads_max_rel_err=grad_worst[0][1],
                  tol_grads=f"max(1e-3, 3 x median of {PERTURBATIONS} baselines)",
                  grads_failing_old_limit=old_fails,
                  grads_failing_new_limit=sum(e > lim for _, e, _, _, lim in grad_worst),
                  new_over_old_limit=json.dumps({
                      "min": min(limit_moves), "median": float(np.median(limit_moves)),
                      "max": max(limit_moves), "grads": len(limit_moves)}),
                  zero_grad_bias_over_weight_grad=bias_err,
                  tol_zero_grad_bias=1e-4, unresolved_elements=unresolved,
                  params_max_abs_err=param_err, tol_params=1e-5)
    if bias_err > 1e-4 or param_err > 1e-5:
        fails.append(f"zero-gradient biases {bias_err}, params {param_err}")
    return fields, fails, loss_errs


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
    the warp). So each gradient is held to max(1e-3, 3 x the median of its
    baselines), each baseline the CPU against itself with real_A
    perturbed (``perturbed``: scaled by 1 + PERTURB, by 1 - PERTURB, and
    elementwise by 1 +- PERTURB; printed). One baseline alone tripped the
    check where a gradient's conditioning happened to be small at that
    perturbation."""
    pairs = request_batches(2, 1, seed=5)
    args = [*TRAIN_ARGS, "--checkpoints_dir", ckpt, "--continue_train", "--batch_size", "1"]
    card = train_model([*args, "--epoch", "smoke", "--gpu_ids", "0"])
    card.optimizers = card.make_optimizers()  # phase 5's nets, a fresh Adam
    card.set_input(pairs[0])
    card.optimize_parameters()
    card.save_networks("smoke6")
    runs = {"card": card}
    for name in ("cpu", *perturbed_runs()):
        runs[name] = train_model([*args, "--epoch", "smoke6", "--gpu_ids", "-1"])
    before = {}
    for i, (name, m) in enumerate(runs.items()):
        before[name] = {n: {k: p.detach().cpu().clone() for k, p in net.named_parameters()}
                        for n, net in m.nets().items()}
        a = pairs[1]["A"] if i < 2 else perturbed(pairs[1]["A"], i - 2)
        m.set_input(dict(pairs[1], A=a))
        m.optimize_parameters()
    fields, fails, loss_errs = step_against_cpu(runs, before)
    phase("train_card_vs_cpu", **fields)
    if max(loss_errs.values()) > 1e-4:
        fails.append(f"losses {loss_errs}")
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


def _science_args(arm: str, ckpt: str) -> list:
    return [*SCIENCE_SHARED, *SCIENCE_ARMS[arm], "--checkpoints_dir", ckpt,
            "--name", f"science_{arm}"]


def _science_batches(opt, n: int) -> list:
    """n batches of the recipe's synthetic data (the arm's own dataset
    flags, seeded), made before the steps."""
    from nemar_tpu_torch.data import create_dataset

    it = iter(create_dataset(opt))
    return [next(it) for _ in range(n)]


def _params(model) -> list:
    return [p.detach().clone() for net in model.nets().values() for p in net.parameters()]


def run_science_arm(arm: str, ckpt: str) -> dict:
    """Phases 7 (multiscale) and 7b (affine): the science recipe's 256^2 arm
    at batch 8, parsed as ``nemar_tpu_torch.train`` parses it: 2 warm-up
    steps, then SCIENCE_STEPS counted ones with the counters zeroed just
    before (ms per step, pairs/s, the launches per step asserted), finite
    losses, every head of R moved; then two fresh two-step runs, bit for
    bit. A torch.profiler pass over 1 more step writes
    chiprun_out/profile_science_<arm>.txt and the device's busy share.
    Saves R's state for phase 7c; returns the counted launches."""
    model = train_model(_science_args(arm, ckpt))
    heads0 = [h.weight.detach().clone() for h in model.netR.heads()]
    batches = _science_batches(model.opt, 2 + SCIENCE_STEPS)
    for b in batches[:2]:
        model.set_input(b)
        model.optimize_parameters()
    torch.cuda.synchronize()
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
    want = {k: v * SCIENCE_STEPS for k, v in SCIENCE_LAUNCHES[arm].items()}
    moved = [float((h.weight.detach() - h0).abs().max())
             for h, h0 in zip(model.netR.heads(), heads0)]
    ms = float(np.median(times))
    window_ms = float(np.sum(times)) / SCIENCE_STEPS
    model.test()  # the last batch's field
    flow_px = float(np.abs(model.last_flow).max()) * 128
    n = model.opt.batch_size
    phase("science_" + arm, batch=n, steps=SCIENCE_STEPS, gate=model._r_gate_scalar(),
          gan_w=model._gan_w_scalar(), launches=json.dumps(launches), expected=json.dumps(want),
          ms_per_step_median=round(ms, 3), ms_per_step_window=round(window_ms, 3),
          ms_per_step=json.dumps([round(t, 3) for t in times]),
          pairs_per_s=round(n / ms * 1e3, 3), pairs_per_s_window=round(n / window_ms * 1e3, 3),
          losses=json.dumps({k: round(v, 6) for k, v in losses.items()}),
          heads_moved_max=json.dumps(moved), max_flow_px=round(flow_px, 3))
    if launches != want:
        raise AssertionError(f"{arm}: launch counts {launches} != expected {want}")
    if model._r_gate_scalar() != 1.0 or model._gan_w_scalar() != 1.0:
        raise AssertionError(f"{arm}: R's gate or the GAN weight is not open")
    if not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"{arm}: non-finite losses {losses}")
    if not all(m > 0.0 for m in moved):
        raise AssertionError(f"{arm}: a head of R did not move: {moved}")
    torch.save(model.netR.state_dict(), os.path.join(ckpt, f"science_{arm}_R.pth"))

    def run(i):
        model.set_input(batches[2 + i])
        model.optimize_parameters()

    profile(run, 1, f"profile_science_{arm}", "step")
    del model

    outs = []
    for _ in range(2):
        m = train_model(_science_args(arm, ckpt))
        losses = []
        for b in batches[:2]:
            m.set_input(b)
            m.optimize_parameters()
            losses.append(list(m.get_current_losses().values()))
        outs.append((np.array(losses), _params(m)))
        del m
    loss_diff = float(np.abs(outs[0][0] - outs[1][0]).max())
    param_diff = max(float((a - b).abs().max()) for a, b in zip(outs[0][1], outs[1][1]))
    phase("science_" + arm + "_determinism", steps=2, batch=n, max_loss_diff=loss_diff,
          max_param_diff=param_diff)
    if loss_diff != 0.0 or param_diff != 0.0:
        raise AssertionError(f"{arm}: two identical training runs on the card differ")
    return launches


def compare_r_with_cpu(ckpt: str) -> None:
    """Phase 7c: each science arm's trained R (phases 7, 7b), its heads moved
    by a seeded draw (R_HEAD_DRAW) so that the field is a few pixels, on the
    card and on the CPU, on one 256^2 pair at batch 1: the flow, the grid
    and both warped images within 1e-3, as phase 4 holds inference; the
    field at least 10x that tolerance, so that the comparison has something
    to catch."""
    from nemar_tpu_torch.models.stn import define_stn
    from nemar_tpu_torch.options import TrainOptions

    for arm in SCIENCE_ARMS:
        opt = TrainOptions().parse(_science_args(arm, ckpt))
        state = torch.load(os.path.join(ckpt, f"science_{arm}_R.pth"), weights_only=True)
        pair = _science_batches(opt, 1)[0]
        a, b = (torch.from_numpy(pair[k][:1]).permute(0, 3, 1, 2) for k in ("A", "B"))
        net = define_stn(opt, opt.stn_type)
        net.load_state_dict(state)
        gen = torch.Generator().manual_seed(6)
        with torch.no_grad():
            for h in net.heads():
                h.weight.add_(R_HEAD_DRAW[arm] * torch.randn(h.weight.shape, generator=gen))
        state = {k: v.clone() for k, v in net.state_dict().items()}
        outs = {}
        for dev in ("cuda", "cpu"):
            net = define_stn(opt, opt.stn_type)
            net.load_state_dict(state)
            net = net.to(dev, memory_format=torch.channels_last).eval()
            with torch.no_grad():
                (wb, wa), reg, aux = net(a.to(dev), b.to(dev), (b.to(dev), a.to(dev)),
                                         n_grad_imgs=1)
            outs[dev] = {"flow": aux["flow"], "grid": aux["grid"], "warped_B": wb,
                         "warped_A": wa, "reg": reg}
        errs = {k: float((outs["cuda"][k].cpu() - outs["cpu"][k]).abs().max()) for k in outs["cpu"]}
        flow_px = float(outs["cpu"]["flow"].abs().max()) * 128
        phase("science_r_card_vs_cpu", arm=arm, batch=1, max_abs_err=json.dumps(errs), tol=1e-3,
              max_flow_px=round(flow_px, 3))
        if not max(errs.values()) <= 1e-3:
            raise AssertionError(f"{arm}: R on the card and on the CPU disagree: {errs}")
        if not flow_px >= 10 * 1e-3 * 128:
            raise AssertionError(f"{arm}: R's field ({flow_px} px) is within 10x the tolerance")


def _g_op_shapes(model, crop: int, n: int = 1) -> dict:
    """The shapes G gives its kernels at a batch of n crop x crop inputs:
    the trunk's NHWC x, each decoder stage's (NHWC x, Co), the head's (NHWC
    x, Co)."""
    g = model.netG
    t = crop // 2**g.n_downsampling
    trunk = g.ResnetBlock_0.Conv_0.in_channels
    convt = [((n, t << i, t << i, getattr(g, f"ConvTranspose_{i}").in_channels),
              getattr(g, f"ConvTranspose_{i}").out_channels) for i in range(g.n_downsampling)]
    head = getattr(g, f"Conv_{1 + g.n_downsampling}")
    return {"block": (n, t, t, trunk), "convt": convt,
            "head": ((n, crop, crop, head.in_channels), head.out_channels)}


def check_g_ops_off_tiles(shapes: dict, dev, dtype: torch.dtype = torch.float32) -> dict:
    """Each of G's ops at ``shapes`` through its autograd op on the card
    (the wrappers' channel padding, K-head's chunks, K-block's masked
    pixel tails) against its plain version on the same inputs: the largest
    error of the value and of the gradients, each over the largest
    reference value, within the kernel's TOL. At bf16 (the bf16 variants,
    K-head's cast), in bf16 spacings of each tensor's largest value, within
    BF16_ULPS: through autograd each backward takes its own forward's saved
    values, downstream of its roundings."""
    from nemar_tpu_torch.ops import conv_fused, conv_head, convt_fused

    rng = np.random.default_rng(12)

    def rel(fn, plain, args, g_shape):
        args = [a.to(dtype).requires_grad_() for a in args]
        g = randn(rng, g_shape, 1.0, dev).to(dtype)
        out, ref = fn(*args), plain(*args)
        got = torch.autograd.grad(out, args, g)
        want = torch.autograd.grad(ref, args, g)
        if dtype == torch.bfloat16:
            return (bf16_ulps(out.detach(), ref.detach(), at_scale=True),
                    max(bf16_ulps(p, q, at_scale=True) for p, q in zip(got, want)))
        return max_rel_err([out.detach()], [ref.detach()]), max_rel_err(got, want)

    c = shapes["block"][3]
    errs = {"K-block": rel(conv_fused.fused_resblock, conv_fused.resblock_plain,
                           [randn(rng, shapes["block"], 1.0, dev),
                            randn(rng, (3, 3, c, c), 0.05, dev),
                            randn(rng, (3, 3, c, c), 0.05, dev)], shapes["block"])}
    for i, (x_shape, co) in enumerate(shapes["convt"]):
        n, h, w, ci = x_shape
        errs[f"K-convt_{i}"] = rel(convt_fused.fused_convt_in, convt_fused.convt_in_plain,
                                   [randn(rng, x_shape, 1.0, dev),
                                    randn(rng, (3, 3, ci, co), 0.05, dev)], (n, 2 * h, 2 * w, co))
    x_shape, co = shapes["head"]
    errs["K-head"] = rel(conv_head.conv_head, conv_head.conv_head_plain,
                         [randn(rng, x_shape, 1.0, dev),
                          randn(rng, (7, 7, x_shape[3], co), 0.05, dev)], x_shape[:3] + (co,))
    for k, (fwd, bwd) in errs.items():
        name = k.split("_")[0]
        tol = ((BF16_ULPS, BF16_ULPS) if dtype == torch.bfloat16
               else (TOL[name], TOL[name + "-bwd"]))
        if not (fwd <= tol[0] and bwd <= tol[1]):
            raise AssertionError(f"{k} at {shapes} ({dtype}): value / gradient errors {fwd}, "
                                 f"{bwd} above {tol}")
    return errs


def check_g_kernels_at(shapes: dict, dev) -> dict:
    """G's kernels at ``shapes`` (``_g_op_shapes`` of a model whose trunk
    and decoder fill the kernels' tiles: no padding, one K-head chunk), by
    their launch wrappers against their plain versions on the same inputs:
    each forward's value; each backward fed the plain forward's saved
    values (K-block's y1, y2, stats, K-convt's yhat, stats), as phase 2b
    feeds them, since at these sizes a pre-relu value within roundoff of 0
    can take the other side of the relu in the kernel's forward and move
    that element's gradient by O(1) (phase 2b's ``relu_flips``). The
    largest error of the value and of the gradients, each over the largest
    reference value, within the kernel's TOL."""
    from nemar_tpu_torch.ops import conv_fused, conv_head, convt_fused

    rng = np.random.default_rng(16)
    errs = {}
    x_shape = shapes["block"]
    c = x_shape[3]
    x, g = randn(rng, x_shape, 1.0, dev), randn(rng, x_shape, 1.0, dev)
    w1, w2 = (randn(rng, (3, 3, c, c), 0.05, dev) for _ in range(2))
    out, *saved = conv_fused.resblock_fwd_plain(x, w1, w2)
    errs["K-block"] = (max_rel_err([conv_fused.fused_resblock_cuda(x, w1, w2)[0]], [out]),
                       max_rel_err(conv_fused.resblock_bwd_cuda(x, w1, w2, *saved, g),
                                   conv_fused.resblock_bwd_plain(x, w1, w2, g, saved=saved)))
    for i, (x_shape, co) in enumerate(shapes["convt"]):
        n, h, w, ci = x_shape
        x, wk = randn(rng, x_shape, 1.0, dev), randn(rng, (3, 3, ci, co), 0.05, dev)
        g = randn(rng, (n, 2 * h, 2 * w, co), 1.0, dev)
        out, *saved = convt_fused.convt_in_fwd_plain(x, wk)
        errs[f"K-convt_{i}"] = (
            max_rel_err([convt_fused.fused_convt_in_cuda(x, wk)[0]], [out]),
            max_rel_err(convt_fused.convt_in_bwd_cuda(x, wk, *saved, g),
                        convt_fused.convt_in_bwd_plain(x, wk, g, saved=saved)))
    x_shape, co = shapes["head"]
    x, wk = randn(rng, x_shape, 1.0, dev), randn(rng, (7, 7, x_shape[3], co), 0.05, dev)
    g = randn(rng, x_shape[:3] + (co,), 1.0, dev)
    errs["K-head"] = (max_rel_err([conv_head.conv_head_cuda(x, wk)],
                                  [conv_head.conv_head_plain(x, wk)]),
                      max_rel_err(conv_head.conv_head_bwd_cuda(x, wk, g),
                                  conv_head.conv_head_bwd_plain(x, wk, g)))
    for k, (fwd, bwd) in errs.items():
        name = k.split("_")[0]
        if not (fwd <= TOL[name] and bwd <= TOL[name + "-bwd"]):
            raise AssertionError(f"{k} at {shapes}: value / gradient errors {fwd}, {bwd} "
                                 f"above {TOL[name]}, {TOL[name + '-bwd']}")
    return errs


def check_g_kernels_bf16_at(shapes: dict, dev) -> dict:
    """``check_g_kernels_at`` for the --bf16 path: the bf16 variants of
    K-block, K-block-bwd, K-convt and K-convt-bwd at ``shapes`` by their
    launch wrappers against their plain versions at bf16 on the same bf16
    inputs, as phases 2 and 2b hold them (``hold_bf16``: K-block's forward
    stage by stage, each backward fed the plain forward's saved values, in
    bf16 spacings of the largest value); K-head, whose fp32 kernel runs on
    the upcast bf16 operands under --bf16, on such operands within its
    TOL. Returns {kernel: [forward, backward] largest error}."""
    from nemar_tpu_torch.ops import conv_fused, conv_head, convt_fused

    rng = card_rng(17)
    bf = torch.bfloat16
    x_shape = shapes["block"]
    c, shape = x_shape[3], "x".join(map(str, x_shape))
    x, g = randn(rng, x_shape, 1.0, dev).to(bf), randn(rng, x_shape, 1.0, dev).to(bf)
    w1, w2 = (randn(rng, (3, 3, c, c), 0.02, dev).to(bf) for _ in range(2))
    got, again = [conv_fused.fused_resblock_cuda(x, w1, w2) for _ in range(2)]
    errs = {"K-block": [hold_bf16("K-block-bf16", shape, got, again,
                                  block_fwd_ref_bf16(x, w1, w2, got[2]), tag="kernel_at")]}
    del got, again
    saved = conv_fused.resblock_fwd_plain(x, w1, w2)[1:]
    got, again = [conv_fused.resblock_bwd_cuda(x, w1, w2, *saved, g) for _ in range(2)]
    errs["K-block"].append(hold_bf16("K-block-bwd-bf16", shape, got, again,
                                     conv_fused.resblock_bwd_plain(x, w1, w2, g, saved=saved),
                                     tag="kernel_bwd_at", at_scale=True))
    del got, again, saved
    for i, (x_shape, co) in enumerate(shapes["convt"]):
        n, h, w, ci = x_shape
        shape = f"{n}x{h}x{w}x{ci}->{co}"
        x = randn(rng, x_shape, 1.0, dev).to(bf)
        wk = randn(rng, (3, 3, ci, co), 0.02, dev).to(bf)
        g = randn(rng, (n, 2 * h, 2 * w, co), 1.0, dev).to(bf)
        got, again = [convt_fused.fused_convt_in_cuda(x, wk) for _ in range(2)]
        errs[f"K-convt_{i}"] = [hold_bf16("K-convt-bf16", shape, got, again,
                                          convt_fused.convt_in_fwd_plain(x, wk), tag="kernel_at")]
        saved = convt_fused.convt_in_fwd_plain(x, wk)[1:]
        got, again = [convt_fused.convt_in_bwd_cuda(x, wk, *saved, g) for _ in range(2)]
        errs[f"K-convt_{i}"].append(hold_bf16(
            "K-convt-bwd-bf16", shape, got, again,
            convt_fused.convt_in_bwd_plain(x, wk, g, saved=saved), tag="kernel_bwd_at",
            at_scale=True))
        del got, again, saved
    x_shape, co = shapes["head"]
    x = randn(rng, x_shape, 1.0, dev).to(bf).float()
    wk = randn(rng, (7, 7, x_shape[3], co), 0.02, dev).to(bf).float()
    g = randn(rng, x_shape[:3] + (co,), 1.0, dev).to(bf).float()
    errs["K-head"] = [max_rel_err([conv_head.conv_head_cuda(x, wk)],
                                  [conv_head.conv_head_plain(x, wk)]),
                      max_rel_err(conv_head.conv_head_bwd_cuda(x, wk, g),
                                  conv_head.conv_head_bwd_plain(x, wk, g))]
    if not (errs["K-head"][0] <= TOL["K-head"] and errs["K-head"][1] <= TOL["K-head-bwd"]):
        raise AssertionError(f"K-head at {shapes} on bf16 operands: value / gradient errors "
                             f"{errs['K-head']} above {TOL['K-head']}, {TOL['K-head-bwd']}")
    return errs


def _g_step_launches(model) -> dict:
    """Launches of one b1 step of the default recipe, as phase 5 counts
    them: two G passes, each 6 K-block, 2 K-convt, K-head once a chunk of 8
    output channels and 3 K-in (the encoder); R's depth-d UNet 2d K-in; D's
    two passes 6; K-warp 1 (the warp of (fake_B, real_A)); each backward
    as its forward."""
    from nemar_tpu_torch.ops.conv_head import head_chunks

    chunks = len(head_chunks(getattr(model.netG, f"Conv_{1 + model.netG.n_downsampling}")
                             .out_channels))
    want = {"K-block": 12, "K-warp": 1, "K-in": 2 * 3 + 2 * model.netR.depth + 6,
            "K-head": 2 * chunks, "K-convt": 4}
    want.update({k + "-bwd": v for k, v in want.items()})
    return want


def run_off_kernel_shapes(ckpt: str) -> None:
    """Phase 8: at each of OFF_KERNEL_SHAPES, G's ops on the card against
    their plain versions (``check_g_ops_off_tiles``), then one b1 training
    step on the card (the counters zeroed just before: every G kernel's
    launches asserted), its seven losses against the CPU's step from the
    same state (fresh Adam) within 1e-4 relative, and a second card run,
    bit for bit. Then the same under --bf16: G's ops at bf16, and a b1 step
    on the card from the same state (the bf16 variants' launches and the
    casts asserted; K-in's and K-in-bwd's bf16 variants, K-warp and
    K-warp-bwd held at each configuration the step gives them,
    ``watch_kernels``), its losses against the CPU's fp32 step within
    BF16_VS_CPU x the CPU's own bf16 step's difference from it."""
    from nemar_tpu_torch.ops.conv_head import head_chunks

    dev = torch.device("cuda", 0)
    for case, flags in OFF_KERNEL_SHAPES.items():
        args = [*TRAIN_ARGS, *flags, "--checkpoints_dir", ckpt, "--batch_size", "1",
                "--name", f"smoke_{case}"]
        crop = int(flags[flags.index("--crop_size") + 1])
        nc = 9 if "--output_nc" in flags else 3
        rng = np.random.default_rng(8)
        pair = {"A": smooth_images(rng, 1, 1, crop), "B": smooth_images(rng, 1, nc, crop)}
        runs = []
        for _ in range(2):
            card = train_model([*args, "--gpu_ids", "0"])
            state = {n: {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
                     for n, net in card.nets().items()}
            want = _g_step_launches(card)
            shapes = _g_op_shapes(card, crop)
            counters = zero_counters()
            card.set_input(pair)
            card.optimize_parameters()
            torch.cuda.synchronize()
            launches = {k: fn.launches for k, fn in counters.items()}
            runs.append((card.get_current_losses(), _params(card), launches))
            del card
        op_errs = check_g_ops_off_tiles(shapes, dev)
        cpu = train_model([*args, "--gpu_ids", "-1"])
        for n, net in cpu.nets().items():
            net.load_state_dict(state[n])
        cpu.set_input(pair)
        cpu.optimize_parameters()
        lc = cpu.get_current_losses()
        losses, params, launches = runs[0]
        errs = {k: abs(losses[k] - lc[k]) / max(abs(lc[k]), 1e-12) for k in lc}
        same = runs[1][0] == losses and all(torch.equal(p, q) for p, q in zip(params, runs[1][1]))
        c = shapes["block"][3]
        feeds = {"trunk": f"{shapes['block']} -> C {-(-c // 128) * 128}",
                 "convt": [f"{ci} -> {co} as {-(-ci // 4) * 4} -> {-(-co // 4) * 4}"
                           for (_, _, _, ci), co in shapes["convt"]],
                 "head_chunks": head_chunks(shapes["head"][1])}
        phase("off_kernel_shape", case=case, flags=" ".join(flags), batch=1,
              kernel_feeds=json.dumps(feeds),
              op_rel_err_value_grad=json.dumps({k: [f"{a:.3g}", f"{b:.3g}"]
                                                for k, (a, b) in op_errs.items()}),
              launches=json.dumps(launches), expected=json.dumps(want),
              loss_rel_err=json.dumps(errs), tol=1e-4, bit_identical=same)
        if launches != want or runs[1][2] != want:
            raise AssertionError(f"{case}: launch counts {launches} != expected {want}")
        if not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"{case}: non-finite losses {losses}")
        if not max(errs.values()) <= 1e-4:
            raise AssertionError(f"{case}: card and CPU losses disagree: {errs}")
        if not same:
            raise AssertionError(f"{case}: two identical steps on the card differ")
        del cpu
        op16 = check_g_ops_off_tiles(shapes, dev, torch.bfloat16)
        bf16_steps = {}
        for name, gpu in (("card", "0"), ("cpu", "-1")):
            m = train_model([*args, "--bf16", "--gpu_ids", gpu])
            for n, net in m.nets().items():
                net.load_state_dict(state[n])
            with watch_kernels(bf16=True) if gpu == "0" else contextlib.nullcontext({}) as got:
                counters, casts = zero_all_counters()
                m.set_input(pair)
                m.optimize_parameters()
                torch.cuda.synchronize()
                bf16_steps[name] = (m.get_current_losses(),
                                    {k: fn.launches for k, fn in counters.items()},
                                    {k: fn.casts for k, fn in casts.items()})
            if gpu == "0":
                seen, watched = got, check_watched(got, f"{case} --bf16")
            del m
        (l16, launches16, casts16), (l16c, _, _) = bf16_steps["card"], bf16_steps["cpu"]
        want16 = bf16_launches({k: want.get(k, 0) for k in counters if k not in BF16.values()})
        err16 = (_rel_to_max(l16, lc, list(lc)), _rel_to_max(l16c, lc, list(lc)))
        phase("off_kernel_shape_bf16", case=case, batch=1,
              op_bf16_ulps_value_grad=json.dumps(op16),
              watched_configs_max_err=json.dumps(watched), watched=json.dumps(seen),
              launches=json.dumps(launches16),
              expected=json.dumps(want16), casts=json.dumps(casts16),
              losses_card_bf16_vs_cpu_fp32_and_cpu_bf16_vs_cpu_fp32=json.dumps(err16),
              factor=BF16_VS_CPU)
        if launches16 != want16 or casts16 != BF16_CASTS_STEP:
            raise AssertionError(f"{case} --bf16: launches {launches16} / casts {casts16}, "
                                 f"expected {want16} / {BF16_CASTS_STEP}")
        if not (all(np.isfinite(v) for v in l16.values())
                and 0 < err16[0] <= BF16_VS_CPU * err16[1]):
            raise AssertionError(f"{case} --bf16: losses {l16}, against the CPU {err16}")


def run_adversarial_gate() -> None:
    """Phase 9: the JAX package's 48^2 adversarial gate on the card, the
    counters zeroed just before: the held-out direction locked (cos > 0.5,
    field > 0.4 px, the best of the last 6 epochs, as
    ``tests/test_adversarial_gate.py`` asserts) and every kernel launched
    ADV_GATE_STEPS x ADV_GATE_STEP + ADV_GATE_EVALS x ADV_GATE_EVAL times."""
    from nemar_tpu_torch.science import run_adversarial_gate as gate

    counters = zero_counters()
    cos, mag, trail, ms = gate(*ADV_GATE, device="cuda:0")
    launches = {k: fn.launches for k, fn in counters.items()}
    want = {k: ADV_GATE_STEPS * ADV_GATE_STEP[k] + ADV_GATE_EVALS * ADV_GATE_EVAL[k]
            for k in counters}
    res, pairs, epochs = ADV_GATE
    phase("adversarial_gate", res=res, pairs=pairs, epochs=epochs, steps=ADV_GATE_STEPS,
          cos=round(cos, 4), mag_px=round(mag, 4), ms_per_step=round(ms, 3),
          trail=json.dumps([[round(c, 4), round(m, 4)] for c, m in trail]),
          launches=json.dumps(launches), expected=json.dumps(want))
    if launches != want:
        raise AssertionError(f"adversarial gate: launch counts {launches} != expected {want}")
    if not cos > 0.5:
        raise AssertionError(f"held-out direction cos {cos:.2f} (trail {trail})")
    if not mag > 0.4:
        raise AssertionError(f"field magnitude {mag:.2f}px: not moving")


def _rel_err(got, ref) -> float:
    """``max_rel_err``, 0 where the reference and the result are both 0."""
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(got, ref) if a is not None)


@contextlib.contextmanager
def watch_kernels(bf16: bool = False):
    """A context in which the first launch of K-in, K-in-bwd, K-warp and
    K-warp-bwd at each configuration (shapes and options) is held against
    the kernel's plain version on that launch's own inputs, the activations
    of the path that runs inside, by ``_rel_err``; with ``bf16``, K-in's
    and K-in-bwd's bf16 variants in their place (--bf16), against their
    plain versions at bf16 in bf16 spacings of each value (``bf16_ulps``),
    as phases 2 and 2b hold them. Yields {kernel: {config: error}}. A wrapper
    counts its launches on the name its module binds it to, so the watching
    wrapper carries the count inside and hands it back on exit; the
    counters are not zeroed inside."""
    from nemar_tpu_torch.ops import norm, norm_cuda, warp, warp_cuda

    k_in = ("K-in-bf16", "K-in-bwd-bf16") if bf16 else ("K-in", "K-in-bwd")
    seen = {k: {} for k in (*k_in, "K-warp", "K-warp-bwd")}

    def held(name, key, got, plain):
        key = " ".join(map(str, key))
        if key not in seen[name]:
            with torch.no_grad():
                ref = plain()
                seen[name][key] = (max(bf16_ulps(p, q) for p, q in zip(got, ref))
                                   if name.endswith("-bf16") else _rel_err(got, ref))

    def in_fwd(name, orig, x, act="relu", eps=1e-5, negative_slope=0.2):
        y, stats = orig(x, act, eps, negative_slope)
        held(name, ("x".join(map(str, x.shape)), act), [y],
             lambda: [norm.instance_norm_act_plain(x, act, eps, negative_slope)])
        return y, stats

    def in_bwd(name, orig, x, g, stats, act="relu", negative_slope=0.2):
        dx = orig(x, g, stats, act, negative_slope)
        held(name, ("x".join(map(str, x.shape)), act), [dx],
             lambda: [norm.instance_norm_act_bwd_plain(x, g, stats, act, negative_slope)])
        return dx

    def warp_fwd(orig, img, grid, padding_mode="zeros", align_corners=False):
        out = orig(img, grid, padding_mode, align_corners)
        held("K-warp", ("x".join(map(str, img.shape)), "x".join(map(str, grid.shape)),
                        padding_mode, align_corners), [out],
             lambda: [warp.grid_sample_plain(img, grid, "bilinear", padding_mode, align_corners)])
        return out

    def warp_bwd(orig, img, grid, g, padding_mode="zeros", align_corners=False,
                 grad_channels=-1):
        out = orig(img, grid, g, padding_mode, align_corners, grad_channels)
        gc = img.shape[-1] if grad_channels < 0 else grad_channels
        held("K-warp-bwd", ("x".join(map(str, img.shape)), "x".join(map(str, grid.shape)),
                            padding_mode, align_corners, gc), out,
             lambda: warp._grid_sample_plain_bwd(img, grid, g, padding_mode, align_corners, gc))
        return out

    suffix = "_bf16" if bf16 else ""
    hooks = {(norm_cuda, f"instance_norm_act{suffix}_cuda"): functools.partial(in_fwd, k_in[0]),
             (norm_cuda, f"instance_norm_act_bwd{suffix}_cuda"): functools.partial(in_bwd, k_in[1]),
             (warp_cuda, "warp_bilinear"): warp_fwd, (warp_cuda, "warp_grid_bwd"): warp_bwd}
    saved = {key: getattr(*key) for key in hooks}
    for (mod, name), hook in hooks.items():
        watching = functools.partial(hook, saved[(mod, name)])
        watching.launches = saved[(mod, name)].launches
        setattr(mod, name, watching)
    try:
        yield seen
    finally:
        for (mod, name), fn in saved.items():
            fn.launches = getattr(mod, name).launches
            setattr(mod, name, fn)


def check_watched(seen: dict, where: str) -> dict:
    """``watch_kernels``'s errors within each kernel's TOL (a bf16
    variant's within BF16_ULPS), every kernel seen; returns {kernel:
    [configurations, largest error]}."""
    for k, errs in seen.items():
        if not errs:
            raise AssertionError(f"{where}: {k} was not launched")
        tol = BF16_ULPS if k.endswith("-bf16") else TOL[k]
        bad = {c: e for c, e in errs.items() if not e <= tol}
        if bad:
            raise AssertionError(f"{where}: {k} disagrees with its plain version (tol "
                                 f"{tol}): {bad}")
    return {k: [len(errs), max(errs.values())] for k, errs in seen.items()}


@contextlib.contextmanager
def watch_pool(tally: dict):
    """A context in which every ``query_pool`` call adds its swaps to
    ``tally['swaps']`` and its swaps into a slot that another swap of the
    same call also takes to ``tally['repeated']``."""
    from nemar_tpu_torch.utils import image_pool

    orig = image_pool.query_pool

    def query(images, count, fakes, use_old, rand_idx):
        p, n = images.shape[0], fakes.shape[0]
        filling = count + torch.arange(n, device=images.device) < p
        slots = rand_idx[~filling & use_old & (rand_idx < count)]
        tally["swaps"] += int(slots.numel())
        tally["repeated"] += int(slots.numel()) - int(torch.unique(slots).numel())
        return orig(images, count, fakes, use_old, rand_idx)

    image_pool.query_pool = query
    try:
        yield tally
    finally:
        image_pool.query_pool = orig


def check_pool_last_writer(pool: tuple, dev) -> dict:
    """``query_pool`` on the card from a full pool with a draw whose swaps
    take slot 7 three times and slot 3 once, against the CPU's call on the
    same tensors, bit for bit: slot 7 holds the last of its writers, slot 3
    its one, and the batch D sees reads the buffer as it was before."""
    from nemar_tpu_torch.utils import image_pool

    images, count = (t.to(dev) for t in pool)
    if int(count) != images.shape[0]:
        raise AssertionError(f"the pool holds {int(count)} of {images.shape[0]}")
    rng = np.random.default_rng(15)
    fakes = randn(rng, (4, *images.shape[1:]), 1.0, dev)
    use_old, rand_idx = torch.ones(4, dtype=torch.bool), torch.tensor([7, 7, 3, 7])
    card = image_pool.query_pool(images, count, fakes, use_old.to(dev), rand_idx.to(dev))
    cpu = image_pool.query_pool(images.cpu(), count.cpu(), fakes.cpu(), use_old, rand_idx)
    new, _, out = card
    checks = {"card_equals_cpu": all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu)),
              "last_writer": torch.equal(new[7], fakes[3]) and torch.equal(new[3], fakes[2]),
              "reads_before": torch.equal(out, images[rand_idx.to(dev)]),
              "others_kept": torch.equal(new[:3], images[:3])}
    if not all(checks.values()):
        raise AssertionError(f"the pool's repeated-slot swap on the card: {checks}")
    return checks


def _train_state(model) -> dict:
    """A model's parameters, EMA shadows and pool, cloned to the CPU."""
    out = {f"{n}.{k}": p.detach().cpu().clone() for n, net in model.nets().items()
           for k, p in net.named_parameters()}
    for n, shadow in (model.ema or {}).items():
        out.update({f"{n}_ema.{k}": v.cpu().clone() for k, v in shadow.items()})
    if model.pool is not None:
        out["pool.images"], out["pool.count"] = (t.cpu().clone() for t in model.pool)
    return out


def _a5_args(ckpt: str, *extra) -> list:
    return [*TRAIN_ARGS, *A5_FLAGS, "--checkpoints_dir", ckpt, "--name", "smoke_a5", *extra]


def run_a5_step(ckpt: str) -> None:
    """Phase 10: the rest of the JAX training step (A5_FLAGS: xavier init,
    EMA 0.999, a pool of 50, 2 microbatches, WGAN-GP) on the default model
    at 256^2, batch 8. Two fresh models from one seed take A5_STEPS steps
    each, past the pool's filling: their parameters, EMA shadows, pool and
    losses bit for bit. In the first run's first step each of K-in,
    K-in-bwd, K-warp and K-warp-bwd is held against its plain version at
    every configuration the step gives it (``watch_kernels``: the
    microbatch of 4, D's pass over [real; fake] and the penalty's), and the
    first run's pool swaps are counted (``watch_pool``: some, asserted); G's
    kernels at the microbatch's shapes against theirs (``check_g_kernels_at``).
    The second run then takes A5_TIMED_STEPS more with the counters zeroed
    just before: ms per step (median), pairs/s, peak memory, every kernel's
    launches per step (``accum_launches``, asserted), K-in-bwd at least as
    often per microbatch of 4 as in phase 5's lsgan step (the penalty's
    first-order gradient runs on it), finite losses, the pool full; its
    pool takes a repeated-slot swap on the card (``check_pool_last_writer``);
    then it is saved as epoch ``a5`` (the shared state of
    ``compare_a5_with_cpu``) and one more step is profiled
    (chiprun_out/profile_a5_step.txt)."""
    dev = torch.device("cuda", 0)
    args = _a5_args(ckpt, "--gpu_ids", "0", "--batch_size", str(TRAIN_BATCH))
    batches = request_batches(A5_STEPS + A5_TIMED_STEPS + 1, TRAIN_BATCH, seed=9)
    runs, pool_tally = [], {"swaps": 0, "repeated": 0}
    for r in range(2):
        model = train_model(args)
        with contextlib.ExitStack() as stack:
            if r == 0:
                stack.enter_context(watch_pool(pool_tally))
            for i, b in enumerate(batches[:A5_STEPS]):
                with watch_kernels() if (r, i) == (0, 0) else contextlib.nullcontext() as seen:
                    model.set_input(b)
                    model.optimize_parameters()
                    torch.cuda.synchronize()
                if (r, i) == (0, 0):
                    watched = check_watched(seen, "A5 step")
        runs.append((_train_state(model), model.get_current_losses()))
    same = runs[0][1] == runs[1][1] and all(torch.equal(v, runs[1][0][k])
                                            for k, v in runs[0][0].items())
    op_errs = check_g_kernels_at(_g_op_shapes(model, model.opt.crop_size,
                                              TRAIN_BATCH // model.grad_accum), dev)
    torch.cuda.reset_peak_memory_stats()
    counters = zero_counters()
    times = []
    for b in batches[A5_STEPS:-1]:
        t0 = time.perf_counter()
        model.set_input(b)
        model.optimize_parameters()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {k: fn.launches for k, fn in counters.items()}
    losses = model.get_current_losses()
    k = model.grad_accum
    want = {key: v * A5_TIMED_STEPS for key, v in accum_launches(k, True).items()}
    per_micro = launches["K-in-bwd"] / (A5_TIMED_STEPS * k)
    ms = float(np.median(times))
    phase("a5_step", flags=" ".join(A5_FLAGS), batch=TRAIN_BATCH, microbatch=TRAIN_BATCH // k,
          steps=A5_TIMED_STEPS, ms_per_step_median=round(ms, 3),
          ms_per_step=json.dumps([round(t, 3) for t in times]),
          pairs_per_s=round(TRAIN_BATCH / ms * 1e3, 3),
          peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3),
          launches=json.dumps(launches), expected=json.dumps(want),
          k_in_bwd_per_microbatch=per_micro, phase5_k_in_bwd=STEP_LAUNCHES["K-in-bwd"],
          pool_count=int(model.pool[1]), pool_swaps_in_compared_run=json.dumps(pool_tally),
          losses=json.dumps({key: round(v, 6) for key, v in losses.items()}),
          bit_identical_twice=same, compared=len(runs[0][0]), steps_compared=A5_STEPS,
          watched_configs_max_rel_err=json.dumps(watched),
          g_kernels_rel_err_value_grad=json.dumps({key: [f"{a:.3g}", f"{b:.3g}"]
                                               for key, (a, b) in op_errs.items()}))
    if launches != want:
        raise AssertionError(f"A5 step: launch counts {launches} != expected {want}")
    if not per_micro >= STEP_LAUNCHES["K-in-bwd"]:
        raise AssertionError(f"K-in-bwd ran {per_micro} times a microbatch, under phase 5's")
    if not all(np.isfinite(v) for v in losses.values()) or "D_gp" not in losses:
        raise AssertionError(f"A5 step: losses {losses}")
    if int(model.pool[1]) != 50:
        raise AssertionError(f"the pool holds {int(model.pool[1])} of 50 after "
                             f"{A5_STEPS + A5_TIMED_STEPS} steps of {TRAIN_BATCH}")
    if not same:
        raise AssertionError("two identical A5 runs on the card differ")
    if not pool_tally["swaps"] > 0:
        raise AssertionError(f"the pool never swapped in {A5_STEPS} steps: {pool_tally}")
    phase("a5_pool_last_writer", **check_pool_last_writer(model.pool, dev))
    model.save_networks("a5")

    def run(i):
        model.set_input(batches[-1])
        model.optimize_parameters()

    profile(run, 1, "profile_a5_step", "step")
    del model


def _g_gan_with(model, d_state: dict, pair: dict) -> float:
    """The G phase's G_GAN of ``model`` (its nets as loaded, no step taken)
    on ``pair``'s microbatches against D with ``d_state``, without
    autograd: the mean over the microbatches, as the step reports it."""
    model.netD.load_state_dict(d_state)
    model.set_input(pair)
    k, gan_w = model.grad_accum, model._gan_w_scalar()
    with torch.no_grad():
        terms = [model._head_loss(model._forward_parts(a, b), b, gan_w)[1][0]
                 for a, b in zip(torch.chunk(model.real_A, k), torch.chunk(model.real_B, k))]
    return float(sum(terms[1:], terms[0]) / k)


def compare_a5_with_cpu(ckpt: str) -> None:
    """Phase 10b: one A5 step (A5_FLAGS, batch 8: two microbatches of 4, as
    phase 10 times) on the card against the CPU from phase 10's saved state
    (parameters, Adam moments, EMA shadows, the full pool, the generator's
    state, so both draw the same pool swaps, several a microbatch, and
    penalty alphas), by ``step_against_cpu``: the
    gradients within max(1e-3, 3 x the median of the baselines) and the
    parameters within 1e-5
    as in phase 6, an unresolved element by at most one Adam step from the
    state's (``adam_bound``); D's output bias among the biases whose
    gradient is 0 up to roundoff (``_zero_grad_biases``); the losses (the
    penalty D_gp among them) within 1e-4 of max(|loss|, 0.1), since
    wgangp's D_real, D_fake and G_GAN are means of D's raw outputs that sit
    near 0; the EMA shadows within 1e-5, the parameters' tolerance; the
    pool's buffer within 1e-3, phase 4's tolerance on G's outputs, and its
    count exactly.

    G_GAN is read through D after D's Adam step, where each unresolved
    element may take a different step on the card (above): at batch 8 that
    moved G_GAN by ~6e-5 on an H100 (5.7e-4 of 0.1), while the perturbed
    CPU run, whose G and R are all but blind to a scaled real_A (instance
    norm), moved it by 2.3e-7. So G_GAN is held in two parts, each recomputed on
    the CPU from the shared state (``_g_gan_with``): with the card's updated
    D, the card's G_GAN within 1e-4 (G, R and D's forward on the card); and
    with the CPU's, the CPU's own (the recomputation, within 1e-6). What
    the two updated Ds make of the same fakes is printed
    (``g_gan_d_update_rel``), not bounded: its elements are the parameter
    check's."""
    pair = request_batches(1, TRAIN_BATCH, seed=10)[0]
    args = _a5_args(ckpt, "--continue_train", "--epoch", "a5", "--batch_size", str(TRAIN_BATCH))
    runs = {name: train_model([*args, "--gpu_ids", dev]) for name, dev in
            (("card", "0"), ("cpu", "-1"), *((p, "-1") for p in perturbed_runs()))}
    before, after = {}, {}
    pool0 = runs["cpu"].pool[0].clone()
    for i, (name, m) in enumerate(runs.items()):
        before[name] = {n: {k: p.detach().cpu().clone() for k, p in net.named_parameters()}
                        for n, net in m.nets().items()}
        m.set_input(dict(pair, A=pair["A"] if i < 2 else perturbed(pair["A"], i - 2)))
        m.optimize_parameters()
        after[name] = _train_state(m)
    fields, fails, loss_errs = step_against_cpu(runs, before, loss_floor=0.1,
                                                adam_t=runs["card"].step)
    shared = train_model([*args, "--gpu_ids", "-1"])  # the state before the step
    gan = {name: _g_gan_with(shared, {k: v.detach().cpu() for k, v in
                                      runs[name].netD.state_dict().items()}, pair)
           for name in ("card", "cpu")}
    reported = {name: runs[name].get_current_losses()["G_GAN"] for name in ("card", "cpu")}

    def rel(a, b):
        return abs(a - b) / max(abs(b), 0.1)

    gan_errs = {"g_gan_card_same_d_rel": rel(reported["card"], gan["card"]),
                "g_gan_cpu_recomputed_rel": rel(reported["cpu"], gan["cpu"]),
                "g_gan_d_update_rel": rel(gan["card"], gan["cpu"])}
    del loss_errs["G_GAN"]
    card, cpu = after["card"], after["cpu"]
    shadow_err = max(float((card[k] - v).abs().max()) for k, v in cpu.items() if "_ema." in k)
    pool_err = float((card["pool.images"] - cpu["pool.images"]).abs().max())
    swapped = int(((cpu["pool.images"] - pool0).flatten(1).abs().amax(1) > 0).sum())
    phase("a5_card_vs_cpu", batch=TRAIN_BATCH, microbatch=TRAIN_BATCH // runs["card"].grad_accum,
          **fields, shadows_max_abs_err=shadow_err,
          tol_shadows=1e-5, pool_max_abs_err=pool_err, tol_pool=1e-3, pool_slots_swapped=swapped,
          pool_count=json.dumps([int(card["pool.count"]), int(cpu["pool.count"])]),
          g_gan=json.dumps({"reported": reported, "recomputed": gan}), **gan_errs,
          tol_g_gan_same_d=1e-4, tol_g_gan_recomputed=1e-6)
    if max(loss_errs.values()) > 1e-4:
        fails.append(f"losses {loss_errs}")
    if not (gan_errs["g_gan_card_same_d_rel"] <= 1e-4
            and gan_errs["g_gan_cpu_recomputed_rel"] <= 1e-6):
        fails.append(f"G_GAN {gan_errs}")
    if "D_gp" not in loss_errs:
        fails.append("no penalty term D_gp among the losses")
    if not shadow_err <= 1e-5:
        fails.append(f"EMA shadows {shadow_err}")
    if not (pool_err <= 1e-3 and torch.equal(card["pool.count"], cpu["pool.count"])):
        fails.append(f"pool {pool_err}")
    if fails:
        raise AssertionError("card and CPU disagree on the A5 step: " + "; ".join(fails))


def run_b32_512(ckpt: str) -> None:
    """Phase 11: BASELINE.md config #4 (B32_ARGS: 512^2 pairs, batch 32,
    4 microbatches of 8, lsgan, fp32) on the default model at full width:
    B32_STEPS steps, the first a warm-up, in which K-in, K-in-bwd, K-warp
    and K-warp-bwd are held against their plain versions at every
    configuration the step gives them (``watch_kernels``: G, R and D at
    512^2 and a microbatch of 8, D's pass over [real; fake] at 16); then G's
    kernels at the microbatch's shapes against theirs (K-block on
    8x128x128x256, K-convt to 8x512x512x64, K-head on 8x512x512x64, values
    and gradients: ``check_g_kernels_at``); over the other steps, with the counters
    zeroed just before, ms per step (median), pairs/s, peak memory
    (``torch.cuda.max_memory_allocated``), every kernel's launches per step
    (``accum_launches``, asserted) and finite losses; then one profiled step
    (chiprun_out/profile_b32_512.txt)."""
    model = train_model([*TRAIN_ARGS, *B32_ARGS, "--gpu_ids", "0", "--checkpoints_dir", ckpt,
                         "--name", "smoke_b32"])
    n, k = model.opt.batch_size, model.grad_accum
    batches = request_batches(2, n, seed=11, size=model.opt.crop_size)
    with watch_kernels() as seen:
        model.set_input(batches[0])
        model.optimize_parameters()
        torch.cuda.synchronize()
    watched = check_watched(seen, "512^2 b32")
    op_errs = check_g_kernels_at(_g_op_shapes(model, model.opt.crop_size, n // k),
                                 torch.device("cuda", 0))
    phase("b32_512_kernels", microbatch=n // k, watched_configs_max_rel_err=json.dumps(watched),
          watched=json.dumps(seen),
          g_kernels_rel_err_value_grad=json.dumps({key: [f"{a:.3g}", f"{b:.3g}"]
                                               for key, (a, b) in op_errs.items()}))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = zero_counters()
    times = []
    for i in range(1, B32_STEPS):
        t0 = time.perf_counter()
        model.set_input(batches[i % 2])
        model.optimize_parameters()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {key: fn.launches for key, fn in counters.items()}
    want = {key: v * (B32_STEPS - 1) for key, v in accum_launches(k, False).items()}
    losses = model.get_current_losses()
    ms = float(np.median(times))
    phase("b32_512", flags=" ".join(B32_ARGS), batch=n, microbatch=n // k, steps=B32_STEPS - 1,
          ms_per_step_median=round(ms, 3), ms_per_step=json.dumps([round(t, 3) for t in times]),
          pairs_per_s=round(n / ms * 1e3, 3),
          peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3),
          launches=json.dumps(launches), expected=json.dumps(want),
          losses=json.dumps({key: round(v, 6) for key, v in losses.items()}))
    if launches != want:
        raise AssertionError(f"512^2 b32: launch counts {launches} != expected {want}")
    if not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"512^2 b32: non-finite losses {losses}")

    def run(i):
        model.set_input(batches[i % 2])
        model.optimize_parameters()

    profile(run, 1, "profile_b32_512", "step")
    del model


# ---------------------------------------------------------------------------
# --bf16 (ROADMAP.md A7): the bf16 variants and the bf16 path
# ---------------------------------------------------------------------------
# the bf16 variant of each kernel that has one; K-warp and K-head (and their
# backwards) run their fp32 kernels under --bf16, behind counted casts
BF16 = {"K-block": "K-block-bf16", "K-convt": "K-convt-bf16", "K-in": "K-in-bf16",
        "K-block-bwd": "K-block-bwd-bf16", "K-convt-bwd": "K-convt-bwd-bf16",
        "K-in-bwd": "K-in-bwd-bf16"}
# the H100 SXM's dense bf16 tensor-core peak at 700 W (NVIDIA's data sheet)
PEAK_BF16_FLOPS = 989e12
# a bf16 output's tolerance against its plain version: where the output is
# one rounding of fp32 arithmetic on the same bf16 values, one bf16 spacing
# of the value (ulp), the spacing taken at no less than BF16_FLOOR x the
# tensor's largest value (an element that cancels to near 0 carries the
# fp32 sums' roundoff, ~1e-7 of the terms, in absolute terms); where a
# bf16 rounding inside the kernel lies upstream (K-block-bwd's and
# K-convt-bwd's outputs, downstream of dz's rounding: fp32 roundoff puts
# some of its elements on the other side of a rounding, as it does in the
# plain version, so the two differ there by an ulp of dz), one bf16 spacing
# of the tensor's largest value. fp32 outputs (statistics, the pre-norm
# conv output) within BF16_FP32_TOL of the largest value. K-block's forward
# is held stage by stage: y1hat, h1 and the first statistics against the
# plain version from x, then y2, the second statistics and out against the
# plain version from the kernel's own h1 (``block_fwd_ref_bf16``)
BF16_ULPS = 1.0
BF16_FLOOR = 1e-3
BF16_FP32_TOL = 1e-5
# the trunk (N, side) at 256 channels of phases 2 (b1, b8), 10 (a
# microbatch of 4) and 11 (512^2: a microbatch of 8); the decoder stages
# (N, H, W, Ci, Co) likewise. Phase 12b holds them at its microbatch of 16
# itself (``check_g_kernels_bf16_at``).
BF16_BLOCK = [(1, 64), (8, 64), (4, 64), (8, 128)]
BF16_CONVT = ([(n, *s[:4]) for s in CONVT_SHAPES for n in (1, 8, 4)]
              + [(8, h, w, ci, co) for h, w, ci, co in ((128, 128, 256, 128), (256, 256, 128, 64))])
# phase 12: the --bf16 path at full width, 256^2; the card's bf16 outputs and
# losses against the CPU's fp32 ones, within BF16_VS_CPU x the CPU's own
# bf16-vs-fp32 difference
BF16_STEPS = 4
BF16_VS_CPU = 4.0
# per b1 request and per b8 step under --bf16: the casts around K-warp's and
# K-head's fp32 kernels. A request's one warp of (fake_B, real_A) casts the
# image up and the output down (2) and each of its two K-head calls x and w
# up and the output down (6); a step adds the backward of each cast (warp 2,
# head 6): g up, then d img (dx, dw) down
BF16_CASTS_REQUEST = {"K-warp": 2, "K-head": 6}
BF16_CASTS_STEP = {"K-warp": 4, "K-head": 12}
# phase 12b: 512^2 pairs at batch 32 under --bf16 --remat in 2 microbatches
# of 16 (bench.py's first try at that cell), and without --remat to compare
BF16_B32_ARGS = ["--crop_size", "512", "--load_size", "512", "--batch_size", "32",
                 "--grad_accum", "2", "--bf16", "--remat"]
BF16_B32_STEPS = 3


def remat_launches(plain: dict, depth: int, k: int, bf16: bool = False) -> dict:
    """Launches per step of the default model's step ``plain`` under
    --remat, in k microbatches: each trunk block whose backward runs is
    run forward again (K-block += K-block-bwd), and each microbatch's R
    of the G phase (K-warp 1, K-in 2 x depth: R's encoder and decoder); the
    bf16 variants' under --bf16."""
    tag = "-bf16" if bf16 else ""
    out = dict(plain)
    out["K-block" + tag] += plain["K-block-bwd" + tag]
    out["K-in" + tag] += 2 * depth * k
    out["K-warp"] += k
    return out


def bf16_launches(fp32: dict) -> dict:
    """Launches of the fp32 path (every kernel's) as the --bf16 path runs
    them: a kernel with a bf16 variant's moved onto the variant, 0 on the
    fp32 kernel."""
    out = {k: (0 if k in BF16 else v) for k, v in fp32.items()}
    out.update({BF16[k]: v for k, v in fp32.items() if k in BF16})
    return out


class Bf16Launches:
    """The bf16 variant's launch count of a wrapper that launches either
    variant (``fn.launches_bf16``), read and set as ``.launches``."""

    def __init__(self, fn):
        self.fn = fn

    @property
    def launches(self) -> int:
        return self.fn.launches_bf16

    @launches.setter
    def launches(self, value: int) -> None:
        self.fn.launches_bf16 = value


def bf16_counters() -> dict:
    """The bf16 variants' launch counters: K-in's and K-in-bwd's own
    wrappers, the core's operators' bf16 counts on their one wrapper."""
    from nemar_tpu_torch.ops import conv_fused, convt_fused, norm_cuda

    return {"K-block-bf16": Bf16Launches(conv_fused.fused_resblock_cuda),
            "K-convt-bf16": Bf16Launches(convt_fused.fused_convt_in_cuda),
            "K-in-bf16": norm_cuda.instance_norm_act_bf16_cuda,
            "K-block-bwd-bf16": Bf16Launches(conv_fused.resblock_bwd_cuda),
            "K-convt-bwd-bf16": Bf16Launches(convt_fused.convt_in_bwd_cuda),
            "K-in-bwd-bf16": norm_cuda.instance_norm_act_bwd_bf16_cuda}


def zero_all_counters() -> tuple:
    """Every kernel's launch counter (fp32 kernels and bf16 variants) and
    the cast counters of K-warp's and K-head's wrappers, set to 0:
    (launches, casts), the functions that carry them."""
    from nemar_tpu_torch.ops import conv_head, warp

    counters = {**zero_counters(), **bf16_counters()}
    for fn in counters.values():
        fn.launches = 0
    casts = {"K-warp": warp.grid_sample, "K-head": conv_head.conv_head}
    for fn in casts.values():
        fn.casts = 0
    return counters, casts


def bf16_ulps(got: torch.Tensor, ref: torch.Tensor, at_scale: bool = False) -> float:
    """Largest |got - ref| in units of the bf16 spacing of ref's value (2^(e
    - 7) for |ref| in [2^e, 2^(e + 1))), the value taken at no less than
    BF16_FLOOR x max|ref|; with ``at_scale``, of max|ref|. A reference that
    is 0 everywhere (a gradient that does not reach a net yet) is met only
    by 0: 0 ulps, else infinitely many."""
    got, ref = got.double(), ref.double()
    top = float(ref.abs().max())
    if top == 0:
        return math.inf if bool(got.any()) else 0.0
    mag = torch.full_like(ref, top) if at_scale else torch.clamp_min(ref.abs(), BF16_FLOOR * top)
    return float(((got - ref).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max())


def block_fwd_ref_bf16(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, h1: torch.Tensor):
    """K-block's bf16 plain forward in its two stages, each one rounding of
    fp32 arithmetic on the same bf16 values as the kernel's: (y1hat, h1) and
    the first statistics from x, then y2, the second statistics and out
    from ``h1``, the kernel's (a rounding of h1 that lands the other way
    moves y2 by W times an ulp, and out by more than one)."""
    from nemar_tpu_torch.ops import conv_fused, norm

    _, y1hat, h1_ref, _, stats = conv_fused.resblock_fwd_plain(x, w1, w2)
    y2 = conv_fused.conv3x3_reflect(h1.float(), w2.float())
    st2 = norm.instance_norm_stats(y2)
    out = (x.float() + norm.normalise(y2, st2)).to(torch.bfloat16)
    return out, y1hat, h1_ref, y2, torch.cat([stats[:, :2], st2], dim=1)


def bound_bf16(flops: float, *tensors) -> tuple:
    """``bound`` with the operations at the bf16 tensor-core peak."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def cudnn_bf16_convs(x: torch.Tensor, ws: list, transposed: bool = False) -> tuple:
    """Median ms of cuDNN's bf16 convolutions of K-block's shape (a 3x3 over
    the reflect-padded input for each HWIO w of ``ws``) or K-convt's (the
    transposed convolution, stride 2, of flax's kernel), forward, and
    backward to the input and the weights; channels_last, deterministic.
    The yardstick of the core's bf16 operators (no PyTorch call computes
    them with their instance norms); the port never calls it."""
    F_ = torch.nn.functional
    xr = x.permute(0, 3, 1, 2).detach().requires_grad_()
    if transposed:
        wr = [w.flip(0, 1).permute(2, 3, 0, 1).contiguous().requires_grad_() for w in ws]
    else:
        wr = [w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
              .requires_grad_() for w in ws]

    def fwd():
        if transposed:
            return [F_.conv_transpose2d(xr, w, stride=2) for w in wr]
        return [F_.conv2d(F_.pad(xr, (1, 1, 1, 1), mode="reflect"), w) for w in wr]

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with torch.no_grad():
            fms = median_ms(fwd, iters=10)
        ys = fwd()
        gs = [torch.ones_like(y) for y in ys]
        bms = median_ms(lambda: torch.autograd.grad(ys, [xr, *wr], gs, retain_graph=True),
                        iters=10)
    finally:
        torch.backends.cudnn.deterministic = prev
    return fms, bms


def hold_bf16(name: str, shape: str, got: tuple, again: tuple, ref: tuple,
              tag: str = "kernel", at_scale: bool = False, **extra) -> float:
    """A bf16 variant's outputs against its plain version's at bf16 on the
    same inputs: every bf16 output within BF16_ULPS (of its values, or with
    ``at_scale`` of its largest value), every fp32 one within BF16_FP32_TOL,
    and two calls bit for bit. Prints the phase line; returns the largest
    absolute error."""
    ulps = max((bf16_ulps(p, q, at_scale) for p, q in zip(got, ref)
                if q.dtype == torch.bfloat16), default=0.0)
    rel = max((max_rel_err([p], [q]) for p, q in zip(got, ref) if q.dtype != torch.bfloat16),
              default=0.0)
    abs_err = max(float((p.double() - q.double()).abs().max()) for p, q in zip(got, ref))
    repeatable = all(torch.equal(p, q) for p, q in zip(got, again))
    phase(tag, name=name, shape=shape, max_bf16_ulps=ulps, tol_ulps=BF16_ULPS,
          ulps_of="the tensor's largest value" if at_scale else "each value",
          max_rel_err_fp32=rel, tol_fp32=BF16_FP32_TOL, max_abs_err=abs_err,
          bitwise_repeatable=repeatable, **extra)
    if not (ulps <= BF16_ULPS and rel <= BF16_FP32_TOL and repeatable):
        raise AssertionError(f"{name} at {shape} disagrees with its plain version at bf16: "
                             f"{ulps} ulps, fp32 {rel}, repeatable {repeatable}")
    return abs_err


def vs_fp64_bf16(name: str, got: tuple, ref: tuple, ref64: tuple) -> dict:
    """The core's bf16 error against a float64 computation from the same
    bf16 inputs with the same roundings (the plain version in float64),
    beside the plain fp32 version's: the kernel's largest relative error at
    most 4x the plain version's, plus one bf16 spacing of the largest value
    for a bf16 output (a rounding that lands on the other side)."""
    err = [max_rel_err([p.double()], [q.double()]) for p, q in zip(got, ref64)]
    plain = [max_rel_err([p.double()], [q.double()]) for p, q in zip(ref, ref64)]
    slack = [2.0**-8 if q.dtype == torch.bfloat16 else 0.0 for q in got]
    if not all(e <= 4 * p + s for e, p, s in zip(err, plain, slack)):
        raise AssertionError(f"{name} is less accurate than the plain fp32 version allows "
                             f"against fp64: {err}, plain {plain}")
    return {"rel_err_vs_fp64": json.dumps(err), "plain_fp32_rel_err_vs_fp64": json.dumps(plain)}


def timed_bf16(kern, plain, launches: int, flops: float, tensors: tuple) -> dict:
    """A bf16 variant's CUDA-event and device time (``launches`` a call,
    asserted), its plain version's time, its bound at bf16."""
    ms = median_ms(kern, iters=10)
    dms, per_launch = device_ms(kern, launches, 5)
    bnd = bound_bf16(flops, *tensors)
    return {"ms": ms, "device_ms": dms, "plain_ms": median_ms(plain, iters=3),
            "bound": bnd, "bound_ms": max(bnd), "tflops": round(flops / ms / 1e9, 2),
            "device_ms_by_kernel": json.dumps(per_launch)}


def check_bf16_kernels(dev) -> dict:
    """Phase 2 for the bf16 variants of K-block, K-convt and K-in: each
    against its plain version at bf16 on the same bf16 inputs
    (``hold_bf16``) at the shapes of phases 2, 10 and 11 (BF16_BLOCK,
    BF16_CONVT; K-in at IN_SHAPES, b1, and IN_BWD_SHAPES at b8 and phase
    10's microbatch of 4); K-block and
    K-convt at phase 2's b1 shapes also against float64 (``vs_fp64_bf16``)
    and timed (``timed_bf16``), with cuDNN's bf16 convolutions of the same
    shapes as a yardstick (F.instance_norm at bf16 for K-in). The totals are
    those of one b1 request."""
    from nemar_tpu_torch.ops import conv_fused, convt_fused, norm, norm_cuda

    rng = np.random.default_rng(20)
    bf = torch.bfloat16
    results = {}
    for n, side in BF16_BLOCK:
        x = randn(rng, (n, side, side, 256), 1.0, dev).to(bf)
        w1, w2 = (randn(rng, (3, 3, 256, 256), 0.02, dev).to(bf) for _ in range(2))

        def kern():
            return conv_fused.fused_resblock_cuda(x, w1, w2)

        got, again = kern(), kern()
        ref = block_fwd_ref_bf16(x, w1, w2, got[2])
        extra = {}
        if n == 1:
            extra = vs_fp64_bf16("K-block-bf16", got, conv_fused.resblock_fwd_plain(x, w1, w2),
                                 conv_fused.resblock_fwd_plain(x, w1, w2, work=torch.float64))
            t = timed_bf16(kern, lambda: conv_fused.resblock_fwd_plain(x, w1, w2), 7,
                           2 * 2 * n * side * side * 256 * 9 * 256, (x, w1, w2, *got))
            yard = cudnn_bf16_convs(x, [w1, w2])[0]
            extra.update({k: v for k, v in t.items() if k != "bound"}, yardstick_cudnn_bf16_ms=yard)
        err = hold_bf16("K-block-bf16", f"{n}x{side}x{side}x256", got, again, ref, **extra)
        if n == 1:
            tally = Tally()
            tally.add(12, err, t["ms"], t["plain_ms"], t["bound"])
            results["K-block-bf16"] = dict(tally.result(), device_ms=12 * t["device_ms"],
                                           yardstick_cudnn_bf16_ms=12 * yard)
        del got, again, ref

    tally, yard = Tally(), 0.0
    for n, h, w, ci, co in BF16_CONVT:
        x = randn(rng, (n, h, w, ci), 1.0, dev).to(bf)
        wk = randn(rng, (3, 3, ci, co), 0.02, dev).to(bf)

        def kern():
            return convt_fused.fused_convt_in_cuda(x, wk)

        got, again = kern(), kern()
        ref = convt_fused.convt_in_fwd_plain(x, wk)
        extra = {}
        if n == 1:
            extra = vs_fp64_bf16("K-convt-bf16", got, ref,
                                 convt_fused.convt_in_fwd_plain(x, wk, work=torch.float64))
            t = timed_bf16(kern, lambda: convt_fused.convt_in_fwd_plain(x, wk), 4,
                           2 * n * h * w * 9 * ci * co, (x, wk, *got))
            cudnn = cudnn_bf16_convs(x, [wk], transposed=True)[0]
            extra.update({k: v for k, v in t.items() if k != "bound"},
                         yardstick_cudnn_bf16_ms=cudnn)
        err = hold_bf16("K-convt-bf16", f"{n}x{h}x{w}x{ci}->{co}", got, again, ref, **extra)
        if n == 1:
            tally.add(2, err, t["ms"], t["plain_ms"], t["bound"])
            tally.device_ms += 2 * t["device_ms"]
            yard += 2 * cudnn
    results["K-convt-bf16"] = dict(tally.result(), device_ms=tally.device_ms,
                                   yardstick_cudnn_bf16_ms=yard)

    tally, step_ms, yard = Tally(), 0.0, 0.0
    cases = ([(1, c, h, w, act, calls, "b1 request") for c, h, w, act, calls in IN_SHAPES]
             + [(b * mult, c, h, w, act, calls, per)
                for b, per in ((TRAIN_BATCH, "b8 step"), (TRAIN_BATCH // 2, "b4 microbatch"))
                for c, h, w, act, mult, calls in IN_BWD_SHAPES])
    card = card_rng(20)
    for n, c, h, w, act, calls, per in cases:
        x = (randn(card if per == "b4 microbatch" else rng, (n, h, w, c), 2.0, dev) + 0.5).to(bf)

        def kern():
            return norm_cuda.instance_norm_act_bf16_cuda(x, act)

        got, again = kern(), kern()
        ref = (norm.instance_norm_act_plain(x, act), norm.instance_norm_stats(x))
        ms = median_ms(kern, iters=10) if per != "b4 microbatch" else None
        err = hold_bf16("K-in-bf16", f"{n}x{h}x{w}x{c}", got, again, ref, act=act,
                        calls=calls, per=per, ms=ms)
        if per == "b1 request":
            pms = median_ms(lambda: norm.instance_norm_act_plain(x, act), iters=3)
            yard += calls * median_ms(in_yardstick(x), iters=10)
            tally.add(calls, err, ms, pms, bound_bf16(6 * x.numel(), x, *got))
            tally.device_ms += calls * device_ms(kern, 1, 5)[0]  # one cooperative launch
        elif per == "b8 step":
            step_ms += calls * ms
    results["K-in-bf16"] = dict(tally.result(), device_ms=tally.device_ms, yardstick_ms=yard,
                                b8_step_ms=step_ms)
    torch.cuda.synchronize()
    return results


def check_bf16_bwd_kernels(dev) -> dict:
    """Phase 2b for the bf16 variants of K-block-bwd, K-convt-bwd and
    K-in-bwd, as ``check_bf16_kernels`` holds the forwards: fed the plain
    forward's saved values at bf16 (as phase 2b feeds the fp32 ones) at the
    shapes of phases 2b, 10 and 11 (K-in-bwd at IN_BWD_SHAPES, b8 and b4), at
    phase 2b's b8 shapes also against float64 from the same bf16 inputs and
    saved values, and timed, cuDNN's bf16 convolution backward as the
    yardstick (F.instance_norm's backward at bf16 for K-in-bwd). The totals
    are those of one b8 step."""
    from nemar_tpu_torch.ops import conv_fused, convt_fused, norm, norm_cuda

    rng = np.random.default_rng(21)
    bf = torch.bfloat16
    results = {}
    for n, side in BF16_BLOCK[1:]:
        x = randn(rng, (n, side, side, 256), 1.0, dev).to(bf)
        w1, w2 = (randn(rng, (3, 3, 256, 256), 0.02, dev).to(bf) for _ in range(2))
        g = randn(rng, x.shape, 1.0, dev).to(bf)
        saved = conv_fused.resblock_fwd_plain(x, w1, w2)[1:]

        def kern():
            return conv_fused.resblock_bwd_cuda(x, w1, w2, *saved, g)

        got, again = kern(), kern()
        ref = conv_fused.resblock_bwd_plain(x, w1, w2, g, saved=saved)
        extra = {}
        if (n, side) == (TRAIN_BATCH, 64):
            extra = vs_fp64_bf16("K-block-bwd-bf16", got, ref, conv_fused.resblock_bwd_plain(
                x, w1, w2, g, saved=saved, work=torch.float64))
            t = timed_bf16(kern, lambda: conv_fused.resblock_bwd_plain(x, w1, w2, g, saved=saved),
                           12, 4 * 2 * n * side * side * 256 * 9 * 256,
                           (x, w1, w2, *saved, g, *got))
            yard = cudnn_bf16_convs(x, [w1, w2])[1]
            extra.update({k: v for k, v in t.items() if k != "bound"},
                         yardstick_cudnn_bf16_bwd_ms=yard)
        err = hold_bf16("K-block-bwd-bf16", f"{n}x{side}x{side}x256", got, again, ref,
                        tag="kernel_bwd", at_scale=True, **extra)
        if (n, side) == (TRAIN_BATCH, 64):
            tally = Tally()
            tally.add(12, err, t["ms"], t["plain_ms"], t["bound"])
            results["K-block-bwd-bf16"] = dict(tally.result(), device_ms=12 * t["device_ms"],
                                               yardstick_cudnn_bf16_ms=12 * yard)
        del got, again, ref, saved

    tally, yard = Tally(), 0.0
    for n, h, w, ci, co in BF16_CONVT:
        if n == 1:
            continue
        x = randn(rng, (n, h, w, ci), 1.0, dev).to(bf)
        wk = randn(rng, (3, 3, ci, co), 0.02, dev).to(bf)
        g = randn(rng, (n, 2 * h, 2 * w, co), 1.0, dev).to(bf)
        saved = convt_fused.convt_in_fwd_plain(x, wk)[1:]

        def kern():
            return convt_fused.convt_in_bwd_cuda(x, wk, *saved, g)

        got, again = kern(), kern()
        ref = convt_fused.convt_in_bwd_plain(x, wk, g, saved=saved)
        extra = {}
        main = n == TRAIN_BATCH and (h, w, ci, co) in [s[:4] for s in CONVT_SHAPES]
        if main:
            extra = vs_fp64_bf16("K-convt-bwd-bf16", got, ref, convt_fused.convt_in_bwd_plain(
                x, wk, g, saved=saved, work=torch.float64))
            t = timed_bf16(kern, lambda: convt_fused.convt_in_bwd_plain(x, wk, g, saved=saved),
                           6, 2 * 2 * n * h * w * 9 * ci * co, (x, wk, *saved, g, *got))
            cudnn = cudnn_bf16_convs(x, [wk], transposed=True)[1]
            extra.update({k: v for k, v in t.items() if k != "bound"},
                         yardstick_cudnn_bf16_bwd_ms=cudnn)
        err = hold_bf16("K-convt-bwd-bf16", f"{n}x{h}x{w}x{ci}->{co}", got, again, ref,
                        tag="kernel_bwd", at_scale=True, **extra)
        if main:
            tally.add(2, err, t["ms"], t["plain_ms"], t["bound"])
            tally.device_ms += 2 * t["device_ms"]
            yard += 2 * cudnn
    results["K-convt-bwd-bf16"] = dict(tally.result(), device_ms=tally.device_ms,
                                       yardstick_cudnn_bf16_ms=yard)

    tally, yard = Tally(), 0.0
    # a b8 step; phase 10's microbatch of 4, drawn on the card
    for b, draw in ((TRAIN_BATCH, rng), (TRAIN_BATCH // 2, card_rng(21))):
        for c, h, w, act, mult, calls in IN_BWD_SHAPES:
            shape = (b * mult, h, w, c)
            x = (randn(draw, shape, 2.0, dev) + 0.5).to(bf)
            g = randn(draw, shape, 1.0, dev).to(bf)
            _, stats = norm_cuda.instance_norm_act_bf16_cuda(x, act)

            def kern():
                return norm_cuda.instance_norm_act_bwd_bf16_cuda(x, g, stats, act)

            got, again = (kern(),), (kern(),)
            ref = (norm.instance_norm_act_bwd_plain(x, g, stats, act),)
            if b != TRAIN_BATCH:
                hold_bf16("K-in-bwd-bf16", "x".join(map(str, shape)), got, again, ref,
                          tag="kernel_bwd", act=act, per="b4 microbatch")
                continue
            ms = median_ms(kern, iters=10)
            pms = median_ms(lambda: norm.instance_norm_act_bwd_plain(x, g, stats, act), iters=3)
            err = hold_bf16("K-in-bwd-bf16", "x".join(map(str, shape)), got, again, ref,
                            tag="kernel_bwd", act=act, calls=calls, ms=ms, plain_ms=pms)
            yard += calls * median_ms(in_yardstick(x, g), iters=10)
            tally.add(calls, err, ms, pms, bound_bf16(8 * x.numel(), x, g, stats, *got))
            tally.device_ms += calls * device_ms(kern, 1, 5)[0]  # one cooperative launch
    results["K-in-bwd-bf16"] = dict(tally.result(), device_ms=tally.device_ms, yardstick_ms=yard)
    torch.cuda.synchronize()
    return results


def _rel_to_max(got: dict, ref: dict, keys) -> float:
    """max |got[k] - ref[k]| over the keys, over the largest |ref[k]|:
    scalars and arrays alike, each entry one vector."""
    diff = max(float(np.max(np.abs(np.asarray(got[k], np.float64) - np.asarray(ref[k], np.float64))))
               for k in keys)
    return diff / max(float(np.max(np.abs(np.asarray(ref[k], np.float64)))) for k in keys)


def _bf16_step_on(args: list, pair: dict) -> tuple:
    """One b1 training step of a fresh model from the seed: (losses, {net:
    its gradients flattened into one vector})."""
    model = train_model(args)
    model.set_input(pair)
    model.optimize_parameters()
    grads = {n: torch.cat([p.grad.detach().flatten().double().cpu() for p in net.parameters()
                           if p.grad is not None]).numpy() for n, net in model.nets().items()}
    return model.get_current_losses(), grads


def run_bf16(ckpt: str) -> dict:
    """Phase 12: the --bf16 path at full width, 256^2 (BF16_*). Inference:
    phase 3's checkpoints through ``nemar_tpu_torch.test``'s options with
    --bf16, 8 b1 requests with every counter zeroed just before (the bf16
    variants' launches and the casts asserted, ms per pair), then batch 8;
    each twice bit for bit. Card against CPU at b1: the card's bf16
    outputs against the CPU's fp32 ones within BF16_VS_CPU x the CPU's own
    bf16-vs-fp32 difference, per output; a profile of 3 requests
    (chiprun_out/profile_bf16_b1.txt). The b8 training step: 2 warm-up
    steps, the first watched (``watch_kernels``: K-in's and K-in-bwd's
    bf16 variants, K-warp and K-warp-bwd held at each configuration), then
    BF16_STEPS with the counters zeroed just before: ms per
    step, pairs/s, peak memory, launches and casts asserted, finite losses,
    a profile of one more step (chiprun_out/profile_bf16_step.txt);
    a fresh model's first two steps bit for bit the first model's; then one
    b1 step on the card and on the CPU (bf16 and fp32) from the seed: the
    seven losses as one vector and each net's gradients as one, card bf16
    against CPU fp32 within BF16_VS_CPU x CPU bf16 against CPU fp32; the
    casts' cost (``time_bf16_casts``).
    Returns the launches of the request (forward variants) and the step
    (backward variants)."""
    from nemar_tpu_torch.models import create_model
    from nemar_tpu_torch.options import TestOptions

    opt = TestOptions().parse([*SLICE_ARGS, "--bf16", "--gpu_ids", "0", "--checkpoints_dir", ckpt])
    model = create_model(opt)
    model.setup(opt)
    model.eval()
    batches = request_batches(REQUESTS, 1, seed=2)
    outs = []
    for b in batches[:2]:
        model.set_input(b)
        model.test()
        outs.append(dict(model.get_current_visuals(), flow=model.last_flow))
    torch.cuda.synchronize()
    counters, casts = zero_all_counters()
    times = []
    for b in batches:
        t0 = time.perf_counter()
        model.set_input(b)
        model.test()
        visuals = model.get_current_visuals()
        times.append((time.perf_counter() - t0) * 1e3)
        if not all(np.all(np.isfinite(v)) for v in visuals.values()):
            raise AssertionError("--bf16 inference: non-finite outputs")
    launches = {k: fn.launches for k, fn in counters.items()}
    cast_counts = {k: fn.casts for k, fn in casts.items()}
    want = {k: v * REQUESTS for k, v in bf16_launches(REQUEST_LAUNCHES).items()}
    want_casts = {k: v * REQUESTS for k, v in BF16_CASTS_REQUEST.items()}
    first = outs[0]
    model.set_input(batches[0])
    model.test()
    again = dict(model.get_current_visuals(), flow=model.last_flow)
    same_b1 = all(np.array_equal(first[k], again[k]) for k in first)
    big = request_batches(3, 8, seed=3)
    t8, b8_out = [], []
    for b in [*big, big[0]]:
        t0 = time.perf_counter()
        model.set_input(b)
        model.test()
        b8_out.append(model.get_current_visuals())
        t8.append((time.perf_counter() - t0) * 1e3)
    same_b8 = all(np.array_equal(b8_out[0][k], b8_out[-1][k]) for k in b8_out[0])
    phase("bf16_slice", requests=REQUESTS, batch=1, launches=json.dumps(launches),
          expected=json.dumps(want), casts=json.dumps(cast_counts),
          expected_casts=json.dumps(want_casts),
          ms_per_pair_median=round(float(np.median(times)), 3),
          b8_ms_per_pair_median_of_last_2=round(float(np.median(t8[1:3])) / 8, 3),
          bit_identical_twice_b1=same_b1, bit_identical_twice_b8=same_b8)
    if launches != want or cast_counts != want_casts:
        raise AssertionError(f"--bf16 request: launches {launches} / casts {cast_counts}, "
                             f"expected {want} / {want_casts}")
    if not (same_b1 and same_b8):
        raise AssertionError("--bf16 inference is not bit for bit repeatable")

    def run_request(_):
        model.set_input(batches[0])
        model.test()

    profile(run_request, 3, "profile_bf16_b1", "request")
    del model

    # card against CPU, b1: the card's bf16 against the CPU's fp32, bounded
    # by the CPU's own bf16-vs-fp32 difference
    cpu = {}
    for name, extra in (("fp32", []), ("bf16", ["--bf16"])):
        o = TestOptions().parse([*SLICE_ARGS, *extra, "--gpu_ids", "-1", "--checkpoints_dir", ckpt])
        m = create_model(o)
        m.setup(o)
        m.set_input(batches[0])
        m.test()
        cpu[name] = dict(m.get_current_visuals(), flow=m.last_flow)
        del m
    errs = {}
    for k in ("fake_B", "reg_fakeB", "warped_A", "fake_B2", "flow"):
        card_err = float(np.max(np.abs(first[k] - cpu["fp32"][k])))
        cpu_err = float(np.max(np.abs(cpu["bf16"][k] - cpu["fp32"][k])))
        errs[k] = (card_err, cpu_err)
    phase("bf16_card_vs_cpu", batch=1, card_bf16_vs_cpu_fp32_and_cpu_bf16_vs_cpu_fp32=json.dumps(errs),
          factor=BF16_VS_CPU)
    if not all(0 < c <= BF16_VS_CPU * p for c, p in errs.values()):
        raise AssertionError(f"--bf16 card against CPU: {errs}")

    # the b8 step
    args = [*TRAIN_ARGS, "--bf16", "--checkpoints_dir", ckpt, "--name", "smoke_bf16"]
    model = train_model([*args, "--gpu_ids", "0", "--batch_size", str(TRAIN_BATCH)])
    sb = request_batches(2 + BF16_STEPS, TRAIN_BATCH, seed=4)
    with watch_kernels(bf16=True) as seen:
        model.set_input(sb[0])
        model.optimize_parameters()
        torch.cuda.synchronize()
    watched = check_watched(seen, "--bf16 b8 step")
    model.set_input(sb[1])
    model.optimize_parameters()
    state2 = _train_state(model)
    losses2 = model.get_current_losses()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters, casts = zero_all_counters()
    times = []
    for b in sb[2:]:
        t0 = time.perf_counter()
        model.set_input(b)
        model.optimize_parameters()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_launches = {k: fn.launches for k, fn in counters.items()}
    step_casts = {k: fn.casts for k, fn in casts.items()}
    want = {k: v * BF16_STEPS for k, v in bf16_launches(STEP_LAUNCHES).items()}
    want_casts = {k: v * BF16_STEPS for k, v in BF16_CASTS_STEP.items()}
    losses = model.get_current_losses()
    peak = torch.cuda.max_memory_allocated() / 2**30

    def run(i):
        model.set_input(sb[2 + i % BF16_STEPS])
        model.optimize_parameters()

    profile(run, 1, "profile_bf16_step", "step")
    del model
    twin = train_model([*args, "--gpu_ids", "0", "--batch_size", str(TRAIN_BATCH)])
    for b in sb[:2]:
        twin.set_input(b)
        twin.optimize_parameters()
    same = (twin.get_current_losses() == losses2
            and all(torch.equal(v, state2[k]) for k, v in _train_state(twin).items()))
    del twin
    ms = float(np.median(times))
    phase("bf16_train", batch=TRAIN_BATCH, steps=BF16_STEPS, launches=json.dumps(step_launches),
          expected=json.dumps(want), casts=json.dumps(step_casts),
          expected_casts=json.dumps(want_casts), ms_per_step_median=round(ms, 3),
          ms_per_step=json.dumps([round(t, 3) for t in times]),
          pairs_per_s=round(TRAIN_BATCH / ms * 1e3, 3), peak_mem_gib=round(peak, 3),
          losses=json.dumps({k: round(v, 6) for k, v in losses.items()}),
          bit_identical_twice=same, watched_configs_max_err=json.dumps(watched),
          watched=json.dumps(seen))
    if step_launches != want or step_casts != want_casts:
        raise AssertionError(f"--bf16 step: launches {step_launches} / casts {step_casts}, "
                             f"expected {want} / {want_casts}")
    if not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"--bf16 step: non-finite losses {losses}")
    if not same:
        raise AssertionError("two identical --bf16 runs on the card differ")

    # card against CPU, one b1 step from the seed
    pair = request_batches(1, 1, seed=5)[0]
    steps = {name: _bf16_step_on([*TRAIN_ARGS, *extra, "--gpu_ids", dev, "--checkpoints_dir", ckpt,
                                  "--name", f"smoke_bf16_{name}", "--batch_size", "1"], pair)
             for name, extra, dev in (("card_bf16", ["--bf16"], "0"), ("cpu_bf16", ["--bf16"], "-1"),
                                      ("cpu_fp32", [], "-1"))}
    (l_card, g_card), (l_cpu16, g_cpu16), (l_cpu32, g_cpu32) = steps.values()
    keys = list(l_cpu32)
    errs = {"losses": (_rel_to_max(l_card, l_cpu32, keys), _rel_to_max(l_cpu16, l_cpu32, keys))}
    for n in g_cpu32:
        errs[f"grad_{n}"] = (_rel_to_max({0: g_card[n]}, {0: g_cpu32[n]}, [0]),
                             _rel_to_max({0: g_cpu16[n]}, {0: g_cpu32[n]}, [0]))
    phase("bf16_train_card_vs_cpu", batch=1,
          card_bf16_vs_cpu_fp32_and_cpu_bf16_vs_cpu_fp32=json.dumps(errs), factor=BF16_VS_CPU)
    if not all(0 < c <= BF16_VS_CPU * p for c, p in errs.values()):
        raise AssertionError(f"--bf16 step, card against CPU: {errs}")
    time_bf16_casts(torch.device("cuda", 0))
    return {**{k: v for k, v in launches.items() if not k.endswith("-bwd-bf16")},
            **{k: v for k, v in step_launches.items() if k.endswith("-bwd-bf16")}}


def time_bf16_casts(dev) -> dict:
    """Phase 12: what the casts around K-warp's and K-head's fp32 kernels
    cost under --bf16, at a b1 request's and a b8 step's shapes: the median
    CUDA-event time of the op as the bf16 model calls it (bf16 image, or x
    and w: cast up, the fp32 kernel, the output cast down; and with g, its
    backward through the casts) against the same op on fp32 tensors, in
    alternation; the difference is the casts'. Returns ms per request (b1,
    forward) and per step (b8, forward and backward), K-warp once and
    K-head twice each (the casts' totals scaled by those calls)."""
    from nemar_tpu_torch.ops import conv_head, warp

    rng = np.random.default_rng(22)
    h, w, ci, co, calls = HEAD_SHAPE
    out = {"K-warp": {}, "K-head": {}}
    for n in (1, TRAIN_BATCH):
        img = randn(rng, (n, 256, 256, 4), 1.0, dev)
        grid = smooth_grid(rng, n, 256, 256).to(dev)
        x, wk = randn(rng, (n, h, w, ci), 1.0, dev), randn(rng, (7, 7, ci, co), 0.02, dev)
        gw, gh = randn(rng, (n, 256, 256, 4), 1.0, dev), randn(rng, (n, h, w, co), 1.0, dev)
        ops = {"K-warp": (lambda a: warp.grid_sample(a[0], grid, grad_channels=3), [img], gw, 1),
               "K-head": (lambda a: conv_head.conv_head(a[0], a[1]), [x, wk], gh, calls)}
        for name, (fn, args, g, k) in ops.items():
            runs = []
            for dt in (torch.bfloat16, torch.float32):
                ins = [a.to(dt).requires_grad_(n > 1) for a in args]
                if n == 1:
                    runs.append(functools.partial(fn, ins))
                else:
                    runs.append(lambda fn=fn, ins=ins, gd=g.to(dt):
                                torch.autograd.grad(fn(ins), ins, gd))
            bf, fp = paired_median_ms(*runs, iters=30, warmup=5)
            out[name].update({f"b{n}_bf16_ms": bf, f"b{n}_fp32_ms": fp,
                              f"b{n}_casts_ms": k * (bf - fp)})
    phase("bf16_casts", per="b1 request (forward) and b8 step (forward and backward)",
          **{k: json.dumps(v) for k, v in out.items()})
    return out


def run_bf16_b32_512(ckpt: str) -> None:
    """Phase 12b: 512^2 pairs at batch 32 under --bf16 --remat in 2
    microbatches of 16 (BF16_B32_ARGS, bench.py's first try at that cell),
    at full width: BF16_B32_STEPS steps, the first a warm-up, in which
    K-in's and K-in-bwd's bf16 variants, K-warp and K-warp-bwd are held at
    every configuration the step gives them (``watch_kernels``: G, R and D
    at 512^2 and a microbatch of 16, D's pass over [real; fake] at 32);
    then the bf16 variants of the core's operators at the microbatch's
    shapes (K-block on 16x128x128x256, K-convt to 16x512x512x64, K-head's
    fp32 kernel on bf16 operands at 16x512x512x64:
    ``check_g_kernels_bf16_at``); over the others, with every counter
    zeroed just before, ms per step, pairs/s, peak memory, the launches
    (``remat_launches`` of ``accum_launches`` on the bf16 variants) and the
    casts (a microbatch's D-phase forward, its G-phase forward and
    backward, and R's forward again: BF16_CASTS_REQUEST + BF16_CASTS_STEP +
    K-warp's 2) asserted, finite losses. Then a fresh model without
    --remat takes the same steps on the same batches: its launches
    asserted, every parameter bit for bit against the run with --remat, and
    its peak memory above that run's."""
    args = [*TRAIN_ARGS, *BF16_B32_ARGS, "--gpu_ids", "0", "--checkpoints_dir", ckpt,
            "--name", "smoke_bf16_b32"]
    model = train_model(args)
    n, k = model.opt.batch_size, model.grad_accum
    batches = request_batches(2, n, seed=12, size=model.opt.crop_size)
    t0 = time.perf_counter()
    with watch_kernels(bf16=True) as seen:
        model.set_input(batches[0])
        model.optimize_parameters()
        torch.cuda.synchronize()
    watched = check_watched(seen, "512^2 b32 --bf16 --remat")
    t1 = time.perf_counter()
    op_errs = check_g_kernels_bf16_at(_g_op_shapes(model, model.opt.crop_size, n // k),
                                      torch.device("cuda", 0))
    phase("bf16_b32_512_kernels", microbatch=n // k, watched_step_seconds=round(t1 - t0, 2),
          g_kernels_seconds=round(time.perf_counter() - t1, 2),
          watched_configs_max_err=json.dumps(watched), watched=json.dumps(seen),
          g_kernels_err_value_grad=json.dumps(op_errs))
    steps = BF16_B32_STEPS - 1
    plain_step = bf16_launches(accum_launches(k, False))
    want = {"remat": remat_launches(plain_step, model.netR.depth, k, bf16=True),
            "plain": plain_step}
    per_micro = {key: BF16_CASTS_REQUEST[key] + BF16_CASTS_STEP[key] for key in BF16_CASTS_STEP}
    casts_want = {"remat": {**per_micro, "K-warp": per_micro["K-warp"] + 2}, "plain": per_micro}
    out, states = {}, {}
    for name in ("remat", "plain"):
        if name == "plain":
            del model
            model = train_model([a for a in args if a != "--remat"])
            model.set_input(batches[0])
            model.optimize_parameters()
        assert model.remat == (name == "remat")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counters, casts = zero_all_counters()
        times = []
        for i in range(1, BF16_B32_STEPS):
            t0 = time.perf_counter()
            model.set_input(batches[i % 2])
            model.optimize_parameters()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = {key: fn.launches for key, fn in counters.items()}
        cast_counts = {key: fn.casts for key, fn in casts.items()}
        losses = model.get_current_losses()
        ms = float(np.median(times))
        out[name] = {"ms_per_step_median": round(ms, 3),
                     "ms_per_step": [round(t, 3) for t in times],
                     "pairs_per_s": round(n / ms * 1e3, 3),
                     "peak_mem_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3),
                     "launches": launches,
                     "expected": {key: v * steps for key, v in want[name].items()},
                     "casts": cast_counts,
                     "expected_casts": {key: steps * k * v for key, v in casts_want[name].items()},
                     "losses": {key: round(v, 6) for key, v in losses.items()}}
        states[name] = _net_state(model)
    del model
    same = (states["remat"].keys() == states["plain"].keys()
            and all(torch.equal(v, states["plain"][key]) for key, v in states["remat"].items()))
    phase("bf16_b32_512", flags=" ".join(BF16_B32_ARGS), batch=n, microbatch=n // k, steps=steps,
          bit_identical_without_remat=same, compared=len(states["remat"]),
          **{name: json.dumps(rec) for name, rec in out.items()})
    for name, rec in out.items():
        if rec["launches"] != rec["expected"] or rec["casts"] != rec["expected_casts"]:
            raise AssertionError(f"512^2 b32 --bf16 ({name}): launches {rec['launches']} / casts "
                                 f"{rec['casts']}, expected {rec['expected']} / "
                                 f"{rec['expected_casts']}")
        if not all(np.isfinite(v) for v in rec["losses"].values()):
            raise AssertionError(f"512^2 b32 --bf16 ({name}): non-finite losses {rec['losses']}")
    if not same:
        raise AssertionError("512^2 b32 --bf16: --remat changed the parameters")
    if not out["remat"]["peak_mem_gib"] < out["plain"]["peak_mem_gib"]:
        raise AssertionError(f"512^2 b32 --bf16: --remat did not lower the peak memory: {out}")


# ---------------------------------------------------------------------------
# The template model families (ROADMAP.md A9): cycle_gan, pix2pix, test, and
# --remat on NeMAR's step
# ---------------------------------------------------------------------------
# phase 13: cycle_gan at its template defaults (resnet_9blocks, instance
# norm, lsgan, a pool of 50, no dropout) at full width, 256^2, batch 1
CYCLE_ARGS = [
    "--model", "cycle_gan", "--netG", "resnet_9blocks", "--ngf", "64", "--ndf", "64",
    "--input_nc", "3", "--output_nc", "3", "--crop_size", "256", "--load_size", "256",
    "--dataset_mode", "synthetic", "--name", "smoke_cycle", "--pool_size", "50",
    "--batch_size", "1",
]
CYCLE_STEPS = 3  # each of the two runs held bit for bit
CYCLE_TIMED_STEPS = 6
# the card-against-CPU step's crop (the same widths): the CPU's six G passes
# at 256^2 would take minutes
CYCLE_CPU_CROP = 64
# launches per cycle_gan step: 6 G passes (G_A(a), G_B(fake_B), G_B(b),
# G_A(fake_A) and the identities G_A(b), G_B(a)), each 9 K-block, 2 K-convt,
# 1 K-head (Co 3) and 3 K-in (the encoder); 4 D passes (D_A(fake_B) and
# D_B(fake_A) in G's loss; D_A over [b; fake_B] and D_B over [a; fake_A] in
# the D step), each 3 K-in; every pass is in a backward
CYCLE_STEP_LAUNCHES = {"K-block": 54, "K-warp": 0, "K-in": 30, "K-head": 6, "K-convt": 12}
CYCLE_STEP_LAUNCHES.update({k + "-bwd": v for k, v in CYCLE_STEP_LAUNCHES.items()})
# phase 14: pix2pix at its template defaults (unet_256, batch norm, dropout,
# vanilla GAN, no pool) at full width, 256^2, batch 1
PIX2PIX_ARGS = [
    "--model", "pix2pix", "--netG", "unet_256", "--ngf", "64", "--ndf", "64",
    "--input_nc", "3", "--output_nc", "3", "--crop_size", "256", "--load_size", "256",
    "--dataset_mode", "synthetic", "--name", "smoke_pix2pix", "--batch_size", "1",
]
PIX2PIX_STEPS = 3
PIX2PIX_TIMED_STEPS = 6
# the UNet's instance norms under --norm instance, per step: 6 on the encoder
# (levels 1..6: 128^2 x 128 down to 2^2 x 512) and 7 on the decoder (2^2 x
# 512 up to 128^2 x 64), and D's 3 in one pass over [real; fake] in the D
# step and one in G's loss; each in a backward
PIX2PIX_IN_LAUNCHES = {"K-in": 19, "K-in-bwd": 19}
# phase 15: --model test --model_suffix _A on phase 13's G_A
TEST_REQUESTS = 8
TEST_REQUEST_LAUNCHES = {"K-block": 9, "K-warp": 0, "K-in": 3, "K-head": 1, "K-convt": 2}
TEST_REQUEST_LAUNCHES.update({k + "-bwd": 0 for k in list(TEST_REQUEST_LAUNCHES)})
# phase 16: --remat on phase 5's step (256^2, batch 8)
REMAT_STEPS = 2  # held bit for bit against the step without --remat
REMAT_TIMED_STEPS = 4


def pair_batches(n_batches: int, n: int, seed: int, size: int = 256) -> list:
    """Seeded 3-channel A and B batches (``smooth_images``)."""
    rng = np.random.default_rng(seed)
    return [{"A": smooth_images(rng, n, 3, size), "B": smooth_images(rng, n, 3, size),
             "A_paths": [f"smoke_{seed}_{i}_{j}" for j in range(n)]} for i in range(n_batches)]


def _net_state(model) -> dict:
    """Every parameter of a model's nets, and its pools, cloned to the CPU."""
    out = {f"{n}.{k}": p.detach().cpu().clone() for n, net in model.nets().items()
           for k, p in net.named_parameters()}
    for key, (images, count) in (getattr(model, "pools", None) or {}).items():
        out[f"pool_{key}.images"], out[f"pool_{key}.count"] = images.cpu(), count.cpu()
    return out


def _runs_bit_identical(args: list, batches: list, watch_first: bool = False) -> tuple:
    """Two fresh models of ``args`` from one seed take a step on each batch:
    (the second model, whether their parameters, pools and losses are equal
    bit for bit, how many tensors were compared, the first step's
    ``watch_kernels`` record when ``watch_first``, whether the second
    model's dropout generator moved)."""
    runs, seen = [], None
    for r in range(2):
        model = train_model(args)
        gen0 = model.drop_gen.get_state()
        for i, b in enumerate(batches):
            watching = watch_first and (r, i) == (0, 0)
            with watch_kernels() if watching else contextlib.nullcontext() as record:
                model.set_input(b)
                model.optimize_parameters()
                torch.cuda.synchronize()
            if watching:
                seen = record
        runs.append((_net_state(model), model.get_current_losses()))
        if r == 0:
            del model
    same = runs[0][1] == runs[1][1] and all(torch.equal(v, runs[1][0][k])
                                            for k, v in runs[0][0].items())
    return model, same, len(runs[0][0]), seen, not torch.equal(model.drop_gen.get_state(), gen0)


def _timed_steps(model, batches: list) -> tuple:
    """A step on each batch with the counters zeroed just before and the
    peak memory reset: (ms per step, the launches, the peak GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = zero_counters()
    times = []
    for b in batches:
        t0 = time.perf_counter()
        model.set_input(b)
        model.optimize_parameters()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return (times, {k: fn.launches for k, fn in counters.items()},
            torch.cuda.max_memory_allocated() / 2**30)


def _in_only(seen: dict, where: str) -> dict:
    """``check_watched`` for K-in and K-in-bwd, on a path that warps nothing
    (K-warp and K-warp-bwd must not have launched)."""
    if seen["K-warp"] or seen["K-warp-bwd"]:
        raise AssertionError(f"{where}: K-warp launched on a path without a warp")
    return check_watched({k: seen[k] for k in ("K-in", "K-in-bwd")}, where)


def run_cycle_gan(ckpt: str) -> dict:
    """Phase 13: cycle_gan at its template defaults (CYCLE_ARGS) on the card.
    Two fresh models from one seed take CYCLE_STEPS steps each on the same
    pairs: their parameters, pools and losses bit for bit; in the first
    run's first step K-in and K-in-bwd are held against their plain
    versions at every configuration the step gives them
    (``watch_kernels``), then G's kernels at G's shapes (K-block on
    1x64x64x256, K-convt to 1x256x256x64, K-head 1x256x256x64 -> 3, values
    and gradients: ``check_g_kernels_at``). The second run takes
    CYCLE_TIMED_STEPS more with the counters zeroed just before: ms per
    step, pairs/s, peak memory, every kernel's launches per step
    (CYCLE_STEP_LAUNCHES, asserted), finite losses; one profiled step
    (chiprun_out/profile_cycle_gan.txt); then it is saved (``latest``, for
    phase 15). Returns the launches per step."""
    dev = torch.device("cuda", 0)
    args = [*CYCLE_ARGS, "--gpu_ids", "0", "--checkpoints_dir", ckpt]
    batches = pair_batches(CYCLE_STEPS + CYCLE_TIMED_STEPS + 1, 1, seed=13)
    model, same, compared, seen, _ = _runs_bit_identical(args, batches[:CYCLE_STEPS], True)
    watched = _in_only(seen, "cycle_gan step")
    op_errs = check_g_kernels_at(_g_op_shapes(SimpleNamespace(netG=model.netG_A),
                                              model.opt.crop_size), dev)
    times, launches, peak = _timed_steps(model, batches[CYCLE_STEPS:-1])
    per_step = {k: v // CYCLE_TIMED_STEPS for k, v in launches.items()}
    want = {k: v * CYCLE_TIMED_STEPS for k, v in CYCLE_STEP_LAUNCHES.items()}
    losses = model.get_current_losses()
    ms = float(np.median(times))
    phase("cycle_gan", batch=1, steps=CYCLE_TIMED_STEPS, ms_per_step_median=round(ms, 3),
          ms_per_step=json.dumps([round(t, 3) for t in times]),
          pairs_per_s=round(1e3 / ms, 3), peak_mem_gib=round(peak, 3),
          launches_per_step=json.dumps(per_step), expected=json.dumps(CYCLE_STEP_LAUNCHES),
          pool_count=int(model.pools["B"][1]),
          losses=json.dumps({k: round(v, 6) for k, v in losses.items()}),
          bit_identical_twice=same, compared=compared, steps_compared=CYCLE_STEPS,
          watched_configs_max_rel_err=json.dumps(watched),
          g_kernels_rel_err_value_grad=json.dumps({k: [f"{a:.3g}", f"{b:.3g}"]
                                               for k, (a, b) in op_errs.items()}))
    if launches != want:
        raise AssertionError(f"cycle_gan: launch counts {launches} != expected {want}")
    if not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"cycle_gan: non-finite losses {losses}")
    if not same:
        raise AssertionError("two identical cycle_gan runs on the card differ")

    def run(i):
        model.set_input(batches[-1])
        model.optimize_parameters()

    profile(run, 1, "profile_cycle_gan", "step")
    model.save_networks("latest")
    del model
    return per_step


def compare_cycle_with_cpu(ckpt: str) -> None:
    """Phase 13b: one cycle_gan step on the card against the CPU's, as phase
    6 holds NeMAR's, at a CYCLE_CPU_CROP^2 crop with the template's widths:
    the shared state is the card's model after one step from its seed
    (nets, both Adams, the pools, the generators), saved and restored by
    --continue_train; the compared step is Adam's second. The eight losses
    within 1e-4 relative, every gradient within max(1e-3, 3 x the median of
    its baselines),
    the updated parameters within 1e-5 (``step_against_cpu``; the biases
    of zero gradient: every G bias but the head's, D's Conv_1..3). The
    baselines are the CPU's steps with real_A and real_B perturbed alike
    (``perturbed``): both feed the generators (NeMAR's real_B is only a target),
    and with real_A alone G_B's baseline misses the paths through real_B
    (G_B(b), G_A(G_B(b)), G_B's identity on a: measured 6.9e-4 against the
    card's 2.1e-3 at G_B's trunk, while G_A's was 3.3e-3)."""
    size = str(CYCLE_CPU_CROP)
    args = [*CYCLE_ARGS, "--crop_size", size, "--load_size", size, "--checkpoints_dir", ckpt,
            "--name", "smoke_cycle_cpu"]
    pairs = pair_batches(2, 1, seed=14, size=CYCLE_CPU_CROP)
    card = train_model([*args, "--gpu_ids", "0"])
    card.set_input(pairs[0])
    card.optimize_parameters()
    card.save_networks("shared")
    runs = {"card": card}
    for name in ("cpu", *perturbed_runs()):
        runs[name] = train_model([*args, "--continue_train", "--epoch", "shared", "--gpu_ids",
                                  "-1"])
    before = {}
    for i, (name, m) in enumerate(runs.items()):
        before[name] = {n: {k: p.detach().cpu().clone() for k, p in net.named_parameters()}
                        for n, net in m.nets().items()}
        ab = {k: pairs[1][k] if i < 2 else perturbed(pairs[1][k], i - 2) for k in ("A", "B")}
        m.set_input(dict(pairs[1], **ab))
        m.optimize_parameters()
    g_skip = {k for k in card.netG_A.state_dict() if k.endswith(".bias") and k != "Conv_3.bias"}
    d_skip = {f"Conv_{i}.bias" for i in range(1, card.netD_A.n_layers + 1)}
    fields, fails, loss_errs = step_against_cpu(
        runs, before, nets={"G_A": "G", "G_B": "G", "D_A": "D", "D_B": "D"},
        skip={"G_A": g_skip, "G_B": g_skip, "D_A": d_skip, "D_B": d_skip})
    phase("cycle_gan_card_vs_cpu", crop=CYCLE_CPU_CROP, batch=1, **fields)
    if max(loss_errs.values()) > 1e-4:
        fails.append(f"losses {loss_errs}")
    if fails:
        raise AssertionError("card and CPU disagree on the cycle_gan step: " + "; ".join(fails))


def run_pix2pix(ckpt: str) -> None:
    """Phase 14: pix2pix at its template defaults (PIX2PIX_ARGS: unet_256,
    batch norm, dropout, vanilla GAN) on the card. Two fresh models from one
    seed take PIX2PIX_STEPS steps each on the same pairs: parameters and
    losses bit for bit (dropout draws from the model's seeded generator on
    the card, which must have moved); then PIX2PIX_TIMED_STEPS more with the
    counters zeroed just before: ms per step, pairs/s, peak memory, and no
    kernel launched (batch norm and the UNet's convolutions are plain, as
    in the JAX package). Then one step under --norm instance in
    ``watch_kernels``: K-in and K-in-bwd held against their plain versions
    at every configuration the UNet and D give them, among them the
    2x2x512 planes of the UNet's innermost levels at batch 1, and their
    launches (PIX2PIX_IN_LAUNCHES) asserted."""
    args = [*PIX2PIX_ARGS, "--gpu_ids", "0", "--checkpoints_dir", ckpt]
    batches = pair_batches(PIX2PIX_STEPS + PIX2PIX_TIMED_STEPS, 1, seed=15)
    model, same, compared, _, drew = _runs_bit_identical(args, batches[:PIX2PIX_STEPS])
    times, launches, peak = _timed_steps(model, batches[PIX2PIX_STEPS:])
    losses = model.get_current_losses()
    ms = float(np.median(times))
    phase("pix2pix", batch=1, norm=model.opt.norm, dropout=not model.opt.no_dropout,
          steps=PIX2PIX_TIMED_STEPS, ms_per_step_median=round(ms, 3),
          ms_per_step=json.dumps([round(t, 3) for t in times]), pairs_per_s=round(1e3 / ms, 3),
          peak_mem_gib=round(peak, 3), launches=json.dumps(launches),
          losses=json.dumps({k: round(v, 6) for k, v in losses.items()}),
          bit_identical_twice=same, compared=compared, steps_compared=PIX2PIX_STEPS,
          dropout_drew=drew)
    if any(launches.values()):
        raise AssertionError(f"pix2pix under batch norm launched kernels: {launches}")
    if not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"pix2pix: non-finite losses {losses}")
    if not (same and drew):
        raise AssertionError(f"pix2pix: bit-identical {same}, dropout drew {drew}")
    del model

    model = train_model([*args, "--norm", "instance", "--name", "smoke_pix2pix_in"])
    counters = zero_counters()
    with watch_kernels() as seen:
        model.set_input(batches[0])
        model.optimize_parameters()
        torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    watched = _in_only(seen, "pix2pix --norm instance step")
    planes = [c for c in (*seen["K-in"], *seen["K-in-bwd"]) if c.startswith("1x2x2x512 ")]
    phase("pix2pix_instance", batch=1, launches=json.dumps(launches),
          expected=json.dumps(PIX2PIX_IN_LAUNCHES),
          watched_configs_max_rel_err=json.dumps(watched),
          watched=json.dumps(seen), unet_2x2_configs=json.dumps(planes))
    if {k: launches[k] for k in PIX2PIX_IN_LAUNCHES} != PIX2PIX_IN_LAUNCHES \
            or any(v for k, v in launches.items() if k not in PIX2PIX_IN_LAUNCHES):
        raise AssertionError(f"pix2pix --norm instance: launches {launches}")
    if not all(any(c.startswith("1x2x2x512 ") for c in seen[k]) for k in ("K-in", "K-in-bwd")):
        raise AssertionError(f"K-in / K-in-bwd never saw the UNet's 2x2 planes: {seen}")
    del model


def run_test_model(ckpt: str) -> None:
    """Phase 15: ``--model test --model_suffix _A --no_dropout``, parsed as
    ``nemar_tpu_torch.test`` parses it, loads phase 13's saved G_A and
    serves TEST_REQUESTS b1 requests (two warm-ups before): ms a request,
    the launches a request (TEST_REQUEST_LAUNCHES, asserted, the counters
    zeroed just before), finite outputs, and each output against phase
    13's G_A on the same request in a cycle_gan model restored from the
    same checkpoint (bit-identical expected; held within 1e-5)."""
    from nemar_tpu_torch.models import create_model
    from nemar_tpu_torch.options import TestOptions

    flags = ["--dataset_mode", "synthetic", "--gpu_ids", "0", "--checkpoints_dir", ckpt,
             "--name", "smoke_cycle", "--crop_size", "256", "--load_size", "256",
             "--input_nc", "3", "--output_nc", "3", "--ngf", "64", "--netG", "resnet_9blocks"]
    opt = TestOptions().parse(["--model", "test", "--model_suffix", "_A", "--no_dropout",
                               *flags])
    model = create_model(opt)
    model.setup(opt)
    ref_opt = TestOptions().parse(["--model", "cycle_gan", *flags])
    ref = create_model(ref_opt)
    ref.setup(ref_opt)
    batches = pair_batches(TEST_REQUESTS + 2, 1, seed=16)
    for b in batches[:2]:
        model.set_input(b)
        model.test()
    torch.cuda.synchronize()
    counters = zero_counters()
    times, outs = [], []
    for b in batches[2:]:
        t0 = time.perf_counter()
        model.set_input(b)
        model.test()
        outs.append(model.get_current_visuals()["fake"])  # copies to the host: synchronises
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {k: fn.launches for k, fn in counters.items()}
    want = {k: v * TEST_REQUESTS for k, v in TEST_REQUEST_LAUNCHES.items()}
    errs = []
    with torch.no_grad():
        for b, out in zip(batches[2:], outs):
            ref.set_input(b)
            errs.append(float(np.abs(out - ref.netG_A(ref.real_A).permute(0, 2, 3, 1)
                                     .cpu().numpy()).max()))
    phase("test_model", requests=TEST_REQUESTS, batch=1,
          ms_per_request_median=round(float(np.median(times)), 3),
          ms_per_request=json.dumps([round(t, 3) for t in times]),
          launches=json.dumps(launches), expected=json.dumps(want),
          max_abs_err_vs_cycle_gan_g_a=max(errs), bit_identical=max(errs) == 0.0, tol=1e-5)
    if launches != want:
        raise AssertionError(f"test model: launch counts {launches} != expected {want}")
    if not all(np.all(np.isfinite(o)) for o in outs) or not max(errs) <= 1e-5:
        raise AssertionError(f"test model against cycle_gan's G_A: {errs}")


def run_remat(ckpt: str) -> None:
    """Phase 16: --remat on phase 5's step (TRAIN_ARGS, 256^2, batch 8).
    Two fresh models from one seed, without and with --remat, take
    REMAT_STEPS steps on the same batches: every parameter bit for bit.
    Then each takes REMAT_TIMED_STEPS more, in turns (without, with), the
    counters zeroed and the peak memory reset just before each: ms per
    step, pairs/s, peak memory (lower with --remat, asserted), the
    launches per step, asserted: phase 5's, and with --remat each trunk
    block's forward and R's again in the backward (K-block 24, K-in 22 +
    R's 2 x depth, K-warp 2)."""
    args = [*TRAIN_ARGS, "--gpu_ids", "0", "--checkpoints_dir", ckpt, "--batch_size",
            str(TRAIN_BATCH), "--name", "smoke_remat"]
    batches = request_batches(REMAT_STEPS + REMAT_TIMED_STEPS, TRAIN_BATCH, seed=17)
    models, states = [], []
    for flags in ([], ["--remat"]):
        m = train_model([*args, *flags])
        for b in batches[:REMAT_STEPS]:
            m.set_input(b)
            m.optimize_parameters()
        torch.cuda.synchronize()
        models.append(m)
        states.append(_net_state(m))
    same = all(torch.equal(v, states[1][k]) for k, v in states[0].items())
    out = {}
    for i in range(REMAT_TIMED_STEPS):
        for name, m in zip(("plain", "remat"), models):
            times, launches, peak = _timed_steps(m, [batches[REMAT_STEPS + i]])
            rec = out.setdefault(name, {"ms": [], "peak_gib": 0.0})
            rec["ms"].append(round(times[0], 3))
            rec["peak_gib"] = max(rec["peak_gib"], round(peak, 3))
            rec["launches"] = launches
    fields = {}
    for name, rec in out.items():
        ms = float(np.median(rec["ms"]))
        fields[name] = {"ms_per_step_median": round(ms, 3), "ms_per_step": rec["ms"],
                        "pairs_per_s": round(TRAIN_BATCH / ms * 1e3, 3),
                        "peak_mem_gib": rec["peak_gib"], "launches_per_step": rec["launches"]}
    phase("remat", batch=TRAIN_BATCH, steps_compared=REMAT_STEPS, bit_identical=same,
          compared=len(states[0]), **{k: json.dumps(v) for k, v in fields.items()})
    plain, remat = out["plain"]["launches"], out["remat"]["launches"]
    want = remat_launches(STEP_LAUNCHES, models[1].netR.depth, 1)
    if not same:
        raise AssertionError("--remat changed the parameters after "
                             f"{REMAT_STEPS} steps")
    if plain != STEP_LAUNCHES or remat != want:
        raise AssertionError(f"launches {plain} without --remat, {remat} with it; "
                             f"expected {STEP_LAUNCHES}, {want}")
    if not out["remat"]["peak_gib"] < out["plain"]["peak_gib"]:
        raise AssertionError(f"--remat did not lower the peak memory: {fields}")


# phase 17: --steps_per_execution as a CUDA graph of the step (ROADMAP.md
# A9b). SPE_BATCHES batches (2 chunks of SPE and a tail of 2) through
# optimize_parameters_scan on the graph and, in a second model from the same
# seed, through the same chunk code run eagerly
# (optimize_parameters_scan_eager); then SPE_TIMED_CHUNKS chunks of each, and
# of the step-by-step path, in turns
SPE = 4
SPE_BATCHES = 10
SPE_TIMED_CHUNKS = 4
SPE_TRACES = 4
# 17c: A5_FLAGS with warm-ups and ramps; its three chunks at epochs 1, 2, 3
# (GAN weight 0, 0.5, 1; R's gate likewise) with the lr assigned between them
SPE_SCHEDULE_FLAGS = ["--gan_warmup_epochs", "1", "--gan_ramp_epochs", "2",
                      "--stn_warmup_epochs", "1", "--stn_ramp_epochs", "2"]
SPE_SCHEDULE = [(1, 1.0), (2, 0.5), (3, 0.25)]  # (epoch, lr / --lr) of each chunk
# 17d: the b1 step, k = 8
SPE_B1 = 8
SPE_B1_CHUNKS = 4
# 17b: the memory of the graph at BF16_B32_ARGS (phase 12b's cell), chunks of 2
SPE_B32 = 2


def _chunk_state(model) -> dict:
    """``_train_state`` and every Adam's state, the step generator's."""
    out = _train_state(model)
    for n, o in model.optimizers.items():
        for i, st in o.state_dict()["state"].items():
            out.update({f"adam_{n}.{i}.{k}": v.detach().cpu().clone() for k, v in st.items()})
    out["rng"] = model.rng.get_state()
    return out


def _spe_run(model, chunks: list, graph: bool, schedule=None) -> dict:
    """``chunks`` through ``model`` (on the graph, or the same chunk code
    run eagerly), the counters zeroed and the peak memory reset just
    before, the cache emptied: each chunk's mean losses, the launches, the
    peak allocated and reserved GiB and the state after."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters, _ = zero_all_counters()
    run = model.optimize_parameters_scan if graph else model.optimize_parameters_scan_eager
    losses = []
    for i, chunk in enumerate(chunks):
        if schedule:
            model.set_epoch(schedule[i][0])
            model.current_lr = model.opt.lr * schedule[i][1]
        run(chunk)
        losses.append({k: v.clone() for k, v in model._losses.items()})
    torch.cuda.synchronize()
    return {"losses": losses, "launches": {k: fn.launches for k, fn in counters.items()},
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "reserved_gib": torch.cuda.max_memory_reserved() / 2**30,
            "state": _chunk_state(model)}


def profile_chunk(run, name: str) -> tuple:
    """One call of ``run`` under torch.profiler: wall and device ms, the
    device's busy share, and the device events counted by name, the copies
    and memsets together (the table in chiprun_out/<name>.txt)."""
    from collections import Counter

    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        time.sleep(0.05)
    events = device_work(prof)
    device_us = sum(e.time_range.elapsed_us() for e in events)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"{name}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    # a graph's replay runs its memory nodes as other events than the eager
    # copies and memsets: those are counted together
    return ({"wall_ms": round(wall_us / 1e3, 3), "device_ms": round(device_us / 1e3, 3),
             "busy": round(device_us / wall_us, 3), "device_events": len(events)},
            Counter("copies and memsets" if _is_memory_op(e.name) else e.name for e in events))


def _time_chunks(runs: dict, chunks: list) -> dict:
    """Each of ``runs`` ({name: fn(chunk)}) on each chunk, in turns: ms a
    step, the median over the chunks."""
    times = {name: [] for name in runs}
    for chunk in chunks:
        for name, fn in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(chunk)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3 / len(chunk))
    return {name: {"ms_per_step_median": round(float(np.median(t)), 3),
                   "ms_per_step": [round(x, 3) for x in t]} for name, t in times.items()}


def _steps(model):
    def run(chunk):
        for b in chunk:
            model.set_input(b)
            model.optimize_parameters()
    return run


def run_step_graph(ckpt: str, tag: str, args: list, batch: int, per_step: dict,
                   schedule=None, seed: int = 18) -> dict:
    """Phases 17, 17b, 17c: ``args`` at ``batch`` under --steps_per_execution
    SPE. A model takes SPE_BATCHES batches in chunks (SPE, SPE, 2) through
    the graph; before it, alone on the card, a model from the same seed
    takes them through the same chunk code run eagerly (``schedule``: the
    epoch and lr of each chunk, set on both). Held: each chunk's mean
    losses, and after the run the parameters, every Adam's moments and
    step counts, the EMA shadows, the pool and the step generator's state,
    bit for bit; the eager run's launches SPE_BATCHES x ``per_step`` (the
    matching step-by-step phase's) and the graph run's 2 x ``per_step``
    (its first step runs eagerly, the second is captured and counted there,
    the rest are replays); the peak memory of each run. Then
    SPE_TIMED_CHUNKS chunks of SPE in turns on the graph, the eager chunk
    code and the step-by-step path (a third model): ms a step; and one
    chunk of the graph and of the eager code profiled: device ms, busy
    share, and the device events by name, equal (the replays run every
    kernel the eager steps run)."""
    name = f"smoke_spe_{tag}"
    spe_args = [*args, "--gpu_ids", "0", "--checkpoints_dir", ckpt, "--batch_size", str(batch),
                "--steps_per_execution", str(SPE)]
    batches = request_batches(SPE_BATCHES + SPE * (SPE_TIMED_CHUNKS + 2), batch, seed=seed)
    chunks = [batches[:SPE], batches[SPE:2 * SPE], batches[2 * SPE:SPE_BATCHES]]
    eager = train_model([*spe_args, "--name", name + "_eager"])
    e = _spe_run(eager, chunks, False, schedule)
    del eager
    graph = train_model([*spe_args, "--name", name + "_graph"])
    g = _spe_run(graph, chunks, True, schedule)
    same_losses = all(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
                      for a, b in zip(g["losses"], e["losses"]))
    differ = sorted(k for k, v in e["state"].items() if not torch.equal(v, g["state"][k]))
    zeros = {k: 0 for k in e["launches"]}
    want_eager = {**zeros, **{k: v * SPE_BATCHES for k, v in per_step.items()}}
    want_graph = {**zeros, **{k: v * 2 for k, v in per_step.items()}}
    fields = {"eager": {"peak_mem_gib": round(e["peak_gib"], 3),
                        "reserved_gib": round(e["reserved_gib"], 3)},
              "graph": {"peak_mem_gib": round(g["peak_gib"], 3),
                        "reserved_gib": round(g["reserved_gib"], 3)}}

    eager = train_model([*spe_args, "--name", name + "_eager2"])
    plain = train_model([*args, "--gpu_ids", "0", "--checkpoints_dir", ckpt, "--batch_size",
                         str(batch), "--name", name + "_plain"])
    timed = [batches[SPE_BATCHES + SPE * i:SPE_BATCHES + SPE * (i + 1)]
             for i in range(SPE_TIMED_CHUNKS + 2)]
    runs = {"graph": graph.optimize_parameters_scan,
            "eager": eager.optimize_parameters_scan_eager, "plain": _steps(plain)}
    adam = adam_capturable_vs_plain(graph) if tag == "fp32" else None
    runs["eager"](timed[0])  # Adam's first step, outside the timed chunks
    runs["plain"](timed[0])
    times = _time_chunks(runs, timed[1:-1])
    # a trace can miss a few device events (PERF.md section 7): profiled
    # again, up to SPE_TRACES times, until the two chunks' events agree
    for attempt in range(1, SPE_TRACES + 1):
        prof_g, count_g = profile_chunk(lambda: graph.optimize_parameters_scan(timed[-1]),
                                        f"profile_spe_{tag}_graph")
        prof_e, count_e = profile_chunk(lambda: eager.optimize_parameters_scan_eager(timed[-1]),
                                        f"profile_spe_{tag}_eager")
        count_diff = {k: [count_g.get(k, 0), count_e.get(k, 0)]
                      for k in set(count_g) | set(count_e) if count_g.get(k, 0) != count_e.get(k, 0)}
        if not count_diff:
            break
    for k in fields:
        fields[k].update(times[k], **(prof_g if k == "graph" else prof_e))
    fields["plain"] = times["plain"]
    phase(f"step_graph_{tag}", batch=batch, spe=SPE, batches=SPE_BATCHES,
          chunks=json.dumps([len(c) for c in chunks]), bit_identical=not differ and same_losses,
          compared=len(e["state"]), differ=json.dumps(differ[:8]),
          launches_eager=json.dumps(e["launches"]), launches_graph=json.dumps(g["launches"]),
          launches_per_step=json.dumps(per_step),
          graphs=len(graph._step_graphs), capturable_vs_plain_adam=json.dumps(adam),
          profiled_events_equal=not count_diff,
          trace_attempts=attempt, events_differ=json.dumps(count_diff),
          **{k: json.dumps(v) for k, v in fields.items()},
          losses=json.dumps({k: round(float(v), 6) for k, v in g["losses"][-1].items()}))
    if differ or not same_losses:
        raise AssertionError(f"{tag}: the graph's replays differ from the eager chunk: {differ}")
    if e["launches"] != want_eager or g["launches"] != want_graph:
        raise AssertionError(f"{tag}: launches {e['launches']} eager, {g['launches']} graph; "
                             f"expected {want_eager}, {want_graph}")
    if count_diff or not sum(count_g.values()):
        raise AssertionError(f"{tag}: the replays' device events differ: {count_diff}")
    if not all(np.isfinite(float(v)) for v in g["losses"][-1].values()):
        raise AssertionError(f"{tag}: non-finite losses")
    del graph, eager, plain
    return fields


def adam_capturable_vs_plain(model, steps: int = 3) -> dict:
    """Capturable Adam (its step count, bias corrections and lr on the
    card, in fp32) against plain Adam (bias corrections in double on the
    host) on copies of ``model``'s G parameters with the same seeded
    gradients, ``steps`` steps at the model's lr and betas: whether the
    parameters stay bit-identical, the largest difference, and that over
    the largest update."""
    group = model.optimizers["G"].param_groups[0]
    lr, betas = model.opt.lr, group["betas"]
    start = [p.detach().clone() for p in model.netG.parameters()]
    gen = card_rng(23)
    grads = [[torch.randn(p.shape, generator=gen, device=p.device) * 1e-2 for p in start]
             for _ in range(steps)]
    out = {}
    for capturable in (True, False):
        params = [torch.nn.Parameter(p.clone()) for p in start]
        adam = torch.optim.Adam(params, lr=torch.tensor(lr, device=start[0].device)
                                if capturable else lr, betas=betas, eps=1e-8,
                                capturable=capturable)
        for g in grads:
            for p, gi in zip(params, g):
                p.grad = gi.clone()
            adam.step()
        out[capturable] = [p.detach() for p in params]
    diff = max(float((a - b).abs().max()) for a, b in zip(out[True], out[False]))
    update = max(float((a - s).abs().max()) for a, s in zip(out[False], start))
    return {"steps": steps, "bit_identical": diff == 0.0, "max_abs_diff": diff,
            "max_update": update, "diff_over_update": diff / update}


def run_step_graph_b32(ckpt: str) -> None:
    """Phase 17b, second cell: the graph's memory at BF16_B32_ARGS (512^2,
    batch 32, --bf16 --remat --grad_accum 2): 2 chunks of SPE_B32 eagerly,
    then on the graph (a model from the same seed each, alone on the card):
    the peak allocated and reserved memory of each, ms a step of each's
    second chunk, the parameters bit for bit."""
    args = [*TRAIN_ARGS, *BF16_B32_ARGS, "--gpu_ids", "0", "--checkpoints_dir", ckpt,
            "--steps_per_execution", str(SPE_B32)]
    batches = request_batches(2 * SPE_B32, 32, seed=19, size=512)
    chunks = [batches[:SPE_B32], batches[SPE_B32:]]
    out, states = {}, {}
    for name, graph in (("eager", False), ("graph", True)):
        model = train_model([*args, "--name", f"smoke_spe_b32_{name}"])
        run = model.optimize_parameters_scan if graph else model.optimize_parameters_scan_eager
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        run(chunks[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(chunks[1])
        torch.cuda.synchronize()
        out[name] = {"ms_per_step": round((time.perf_counter() - t0) * 1e3 / SPE_B32, 3),
                     "peak_mem_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3),
                     "reserved_gib": round(torch.cuda.max_memory_reserved() / 2**30, 3)}
        states[name] = _train_state(model)
        del model
    same = all(torch.equal(v, states["graph"][k]) for k, v in states["eager"].items())
    phase("step_graph_bf16_b32_512", flags=" ".join(BF16_B32_ARGS), spe=SPE_B32, chunks=2,
          bit_identical=same, **{k: json.dumps(v) for k, v in out.items()})
    if not same:
        raise AssertionError("512^2 b32: the graph's replays differ from the eager chunk")


def run_step_graph_b1(ckpt: str) -> None:
    """Phase 17d: the b1 fp32 step at k = SPE_B1: SPE_B1_CHUNKS chunks in
    turns on the graph, the eager chunk code and the step-by-step path
    (after one chunk of each outside the timing, the graph's capture in
    it): ms a step."""
    args = [*TRAIN_ARGS, "--gpu_ids", "0", "--checkpoints_dir", ckpt, "--batch_size", "1"]
    spe = ["--steps_per_execution", str(SPE_B1)]
    batches = request_batches(SPE_B1 * (SPE_B1_CHUNKS + 1), 1, seed=20)
    chunks = [batches[SPE_B1 * i:SPE_B1 * (i + 1)] for i in range(SPE_B1_CHUNKS + 1)]
    graph = train_model([*args, *spe, "--name", "smoke_spe_b1_graph"])
    eager = train_model([*args, *spe, "--name", "smoke_spe_b1_eager"])
    plain = train_model([*args, "--name", "smoke_spe_b1_plain"])
    runs = {"graph": graph.optimize_parameters_scan,
            "eager": eager.optimize_parameters_scan_eager, "plain": _steps(plain)}
    for fn in runs.values():
        fn(chunks[0])
    times = _time_chunks(runs, chunks[1:])
    prof, _ = profile_chunk(lambda: graph.optimize_parameters_scan(chunks[-1]),
                            "profile_spe_b1_graph")
    prof_e, _ = profile_chunk(lambda: eager.optimize_parameters_scan_eager(chunks[-1]),
                              "profile_spe_b1_eager")
    times["graph"].update(prof)
    times["eager"].update(prof_e)
    phase("step_graph_b1", batch=1, spe=SPE_B1, chunks=SPE_B1_CHUNKS,
          **{k: json.dumps(v) for k, v in times.items()})
    del graph, eager, plain


class _HeldWriter:
    """``base_model.write_checkpoint`` held until ``release`` is set."""

    def __init__(self):
        import threading

        from nemar_tpu_torch.models import base_model

        self.mod, self.orig = base_model, base_model.write_checkpoint
        self.release, self.started = threading.Event(), threading.Event()

    def __enter__(self):
        def held(files):
            self.started.set()
            if not self.release.wait(300):
                raise TimeoutError("the held checkpoint writer was never released")
            self.orig(files)

        self.mod.write_checkpoint = held
        return self

    def __exit__(self, *exc):
        self.release.set()
        self.mod.write_checkpoint = self.orig


def _dropout_masks(model, batch) -> list:
    """The keep masks of each Dropout call in one training step of
    ``model`` on ``batch``, drawn again from the generator's state at the
    call (on the CPU)."""
    from nemar_tpu_torch.models import networks

    masks, orig = [], networks.Dropout.forward

    def forward(self, x):
        if self.training:
            gen = torch.Generator(x.device)
            gen.set_state(self.generator.get_state())
            masks.append((torch.empty_like(x).uniform_(generator=gen) >= self.p).cpu())
        return orig(self, x)

    networks.Dropout.forward = forward
    try:
        model.set_input(batch)
        model.optimize_parameters()
    finally:
        networks.Dropout.forward = orig
    return masks


def run_async_and_resume(ckpt: str) -> None:
    """Phase 17e, on the card. (1) --async_checkpoint at phase 5's cell
    under --steps_per_execution 2: a chunk, an asynchronous save with the
    writer held: it returns with none of its files and no meta written;
    released, the meta names it once the files are in place. (2) A run
    (chunk, async save as train.py's epoch end, chunk while it is in
    flight, join) and a run resumed from that save with --auto_resume
    (chunk): every parameter, Adam moment and step count bit for bit. The
    save, made by capturable Adam, loads into the step-by-step model's
    plain Adam, and phase 5's (plain Adam) into a capturable one: Adam's
    state equal to the file's. Times: the async save's return against a
    synchronous save's. (3) pix2pix with dropout at 256^2 (unet_256 at ngf
    8) trained 2 steps on the CPU, saved, resumed on the card: its step 3
    draws the masks that a run on the card alone draws at its step 3."""
    plain_args = [*TRAIN_ARGS, "--gpu_ids", "0", "--checkpoints_dir", ckpt, "--batch_size",
                  str(TRAIN_BATCH)]
    spe_args = [*plain_args, "--steps_per_execution", "2"]
    args = [*spe_args, "--async_checkpoint", "--name", "smoke_async"]
    batches = request_batches(6, TRAIN_BATCH, seed=21)
    save_dir = os.path.join(ckpt, "smoke_async")
    meta_path = os.path.join(save_dir, "checkpoint_meta.json")

    run = train_model(args)
    run.optimize_parameters_scan(batches[:2])
    with _HeldWriter() as held:
        t0 = time.perf_counter()
        run.save_networks("latest")
        async_ms = (time.perf_counter() - t0) * 1e3
        if not held.started.wait(60):
            raise AssertionError("the asynchronous save never started writing")
        landed = [f for f in os.listdir(save_dir) if f.startswith("latest_")]
        meta_before = os.path.exists(meta_path)
        held.release.set()
        run.save_networks(1)  # joins the first, publishes its meta, starts its own
    with open(meta_path) as f:
        meta_mid = json.load(f)
    run.update_learning_rate(1)
    run.set_epoch(2)
    run.optimize_parameters_scan(batches[2:4])  # while the second save is in flight
    run._flush_pending_meta()
    with open(meta_path) as f:
        meta_end = json.load(f)
    resumed = train_model([*args, "--auto_resume", "--epoch_count", "2"])
    resumed.optimize_parameters_scan(batches[2:4])
    want, got = _chunk_state(run), _chunk_state(resumed)
    differ = sorted(k for k, v in want.items() if not torch.equal(v, got[k]))
    resumed_lr = resumed.current_lr == run.current_lr

    saved = torch.load(os.path.join(save_dir, "1_state.pth"), map_location="cpu",
                       weights_only=True)["optimizers"]
    plain = train_model([*plain_args, "--name", "smoke_async", "--continue_train", "--epoch",
                         "1", "--epoch_count", "2"])
    cross = {"capturable_into_plain": _adam_equals(plain, saved)}
    smoke = torch.load(os.path.join(ckpt, "smoke_train", "smoke_state.pth"), map_location="cpu",
                       weights_only=True)["optimizers"]
    into = train_model([*spe_args, "--continue_train", "--epoch", "smoke"])
    cross["plain_into_capturable"] = _adam_equals(into, smoke)
    steps_on = {"plain": str(plain.optimizers["G"].state_dict()["state"][0]["step"].device),
                "capturable": str(into.optimizers["G"].state_dict()["state"][0]["step"].device)}
    sync = train_model([*spe_args, "--name", "smoke_sync"])
    sync.optimize_parameters_scan(batches[4:6])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sync.save_networks("latest")
    sync_ms = (time.perf_counter() - t0) * 1e3
    del run, resumed, plain, into, sync

    p2p = ["--model", "pix2pix", "--netG", "unet_256", "--ngf", "8", "--ndf", "8",
           "--input_nc", "3", "--output_nc", "3", "--crop_size", "256", "--load_size", "256",
           "--dataset_mode", "synthetic", "--batch_size", "1", "--checkpoints_dir", ckpt]
    pairs = pair_batches(3, 1, seed=22)
    cpu = train_model([*p2p, "--gpu_ids", "-1", "--name", "smoke_drop_cpu"])
    for b in pairs[:2]:
        cpu.set_input(b)
        cpu.optimize_parameters()
    cpu.save_networks("latest")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        moved = train_model([*p2p, "--gpu_ids", "0", "--name", "smoke_drop_cpu",
                             "--continue_train"])
    card = train_model([*p2p, "--gpu_ids", "0", "--name", "smoke_drop_card"])
    for b in pairs[:2]:
        card.set_input(b)
        card.optimize_parameters()
    masks = {"resumed": _dropout_masks(moved, pairs[2]), "card": _dropout_masks(card, pairs[2])}
    same_masks = (len(masks["card"]) == len(masks["resumed"]) > 0
                  and all(torch.equal(a, b) for a, b in zip(masks["card"], masks["resumed"])))
    warned = [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]
    phase("async_checkpoint", batch=TRAIN_BATCH, spe=2, async_save_ms=round(async_ms, 3),
          sync_save_ms=round(sync_ms, 3), files_when_returned=len(landed),
          meta_when_returned=meta_before, meta_after_second_save=json.dumps(meta_mid),
          meta_at_end=json.dumps(meta_end), resume_bit_identical=not differ,
          compared=len(want), differ=json.dumps(differ[:8]), resumed_lr_equal=resumed_lr,
          cross_capturable=json.dumps(cross), adam_step_on=json.dumps(steps_on))
    phase("dropout_resume", model="pix2pix", steps_on_cpu=2, resumed_on="cuda",
          step=3, dropout_calls=len(masks["card"]), masks_equal=same_masks,
          warnings=json.dumps(warned))
    if landed or meta_before:
        raise AssertionError(f"the async save wrote {landed} (meta: {meta_before}) before "
                             "returning")
    if meta_mid.get("latest") != "latest" or meta_end.get("latest") != "1":
        raise AssertionError(f"the meta named {meta_mid}, then {meta_end}")
    if differ or not resumed_lr:
        raise AssertionError(f"the --auto_resume run differs from the uninterrupted one: {differ}")
    if not all(cross.values()):
        raise AssertionError(f"Adam's state across the capturable setting: {cross}")
    if not same_masks or warned:
        raise AssertionError(f"pix2pix resumed on the card drew other masks ({same_masks}) or "
                             f"warned {warned}")


def _adam_equals(model, saved: dict) -> bool:
    """Every Adam state of ``model`` equal to ``saved`` (a state file's
    optimizers), on the CPU."""
    for n, o in model.optimizers.items():
        have = o.state_dict()["state"]
        want = saved[n]["state"]
        if have.keys() != want.keys() or not have:
            return False
        for i, st in want.items():
            for k, v in st.items():
                if not torch.equal(have[i][k].detach().cpu().to(v.dtype), v):
                    return False
    return True


def run_step_graph_phases(ckpt: str) -> None:
    """Phases 17-17e (ROADMAP.md A9b, A12), each timed."""
    cells = (("17", lambda: run_step_graph(ckpt, "fp32", TRAIN_ARGS, TRAIN_BATCH, STEP_LAUNCHES)),
             ("17b", lambda: run_step_graph(ckpt, "bf16", [*TRAIN_ARGS, "--bf16"], TRAIN_BATCH,
                                            bf16_launches(STEP_LAUNCHES))),
             ("17b_512", lambda: run_step_graph_b32(ckpt)),
             ("17c", lambda: run_step_graph(ckpt, "a5", [*TRAIN_ARGS, *A5_FLAGS,
                                                         *SPE_SCHEDULE_FLAGS],
                                            TRAIN_BATCH, accum_launches(2, True), SPE_SCHEDULE)),
             ("17d", lambda: run_step_graph_b1(ckpt)),
             ("17e", lambda: run_async_and_resume(ckpt)))
    for tag, fn in cells:
        t0 = time.perf_counter()
        fn()
        phase("step_graph_phase", phase=tag, seconds=round(time.perf_counter() - t0, 2))


# phase 18: phase 5's cell through the port's launcher at NCCL world size 1
NCCL_STEPS = 4
NCCL_SPE = 4
NCCL_TIMEOUT = 900.0  # seconds, the launch and each collective
# phase 18b: two ranks on cuda:0 over gloo; steps per run (the first compared
# with the one-process step, every one's state held equal across the ranks)
GLOO_STEPS = 3
GLOO_PIX2PIX_BATCH = 2


def fp32_only() -> None:
    """TF32 off outside the kernels' own 3xTF32 GEMMs, as the smoke runs
    (a launched rank starts from PyTorch's defaults, which allow TF32 in
    cuDNN's convolutions)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _param_hashes(model) -> dict:
    """{net.parameter: SHA-256 of its bytes}."""
    import hashlib

    return {f"{n}.{k}": hashlib.sha256(p.detach().cpu().contiguous().numpy().tobytes())
            .hexdigest() for n, net in model.nets().items() for k, p in net.named_parameters()}


def _timed_losses(model, batches: list) -> tuple:
    """A step on each batch: (ms of each, the losses after each)."""
    times, losses = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.set_input(b)
        model.optimize_parameters()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(dict(model.get_current_losses()))
    return times, losses


def _nccl_ms(run, reps: int) -> dict:
    """{NCCL kernel name: device ms per rep} over ``reps`` calls of run."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        for i in range(reps):
            run(i)
        torch.cuda.synchronize()
        time.sleep(0.05)
    out: dict = {}
    for e in device_work(prof):
        if "nccl" in e.name.lower():
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return out


def _nccl_rank(ckpt: str, batches: list) -> dict:
    """Phase 18 inside its rank (NCCL, world 1): phase 5's step on each
    batch with the counters zeroed just before (ms, losses, launches, the
    parameters' hashes), the NCCL kernels' device time over 2 more steps,
    then a chunk of NCCL_SPE steps through the CUDA graph and through the
    eager chunk code, each from the seed: their states' digests, losses,
    the gradient all-reduces each ran in Python (the graph's: its eager
    first step's and its capture's), and the NCCL kernels in a chunk of
    replays."""
    from nemar_tpu_torch import parallel
    from nemar_tpu_torch.models.base_model import state_digest

    fp32_only()
    args = [*TRAIN_ARGS, "--gpu_ids", "0", "--checkpoints_dir", ckpt, "--batch_size",
            str(TRAIN_BATCH), "--name", "smoke_nccl"]
    model = train_model(args)
    counters = zero_counters()
    times, losses = _timed_losses(model, batches)
    out = {"backend": parallel.backend(), "world": parallel.world(),
           "device": str(parallel.device()), "ms": times, "losses": losses,
           "launches": {k: fn.launches for k, fn in counters.items()},
           "hashes": _param_hashes(model)}
    calls = parallel.all_reduce_grads.calls

    def step(i):
        model.set_input(batches[i])
        model.optimize_parameters()

    out["nccl_ms_per_step"] = _nccl_ms(step, 2)
    out["all_reduce_calls_per_step"] = (parallel.all_reduce_grads.calls - calls) / 2
    del model
    spe = {}
    for mode in ("graph", "eager"):
        m = train_model([*args, "--steps_per_execution", str(NCCL_SPE), "--name",
                         f"smoke_nccl_{mode}"])
        run = m.optimize_parameters_scan if mode == "graph" else m.optimize_parameters_scan_eager
        calls = parallel.all_reduce_grads.calls
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(batches)
        torch.cuda.synchronize()
        spe[mode] = {"ms_chunk": (time.perf_counter() - t0) * 1e3,
                     "all_reduce_calls": parallel.all_reduce_grads.calls - calls,
                     "digest": state_digest(m), "losses": dict(m.get_current_losses())}
        if mode == "graph":  # a chunk of replays alone
            calls = parallel.all_reduce_grads.calls
            spe[mode]["nccl_ms_per_replayed_chunk"] = _nccl_ms(lambda i: run(batches), 1)
            spe[mode]["replay_all_reduce_calls"] = parallel.all_reduce_grads.calls - calls
        del m
    out["spe"] = spe
    return out


def run_nccl_world1(ckpt: str) -> None:
    """Phase 18: phase 5's cell (NeMAR fp32, 256^2, batch 8, full width)
    in a rank of the port's launcher (``nemar_tpu_torch.parallel.launch``
    with [cuda:0] and NCCL), against the same NCCL_STEPS steps in this
    process without a process group: the launches of all ten kernels per
    step phase 5's, the losses and every parameter after the steps bit for
    bit, ms a step of both, the NCCL kernels' device time per step by name;
    then --steps_per_execution NCCL_SPE: the graph's replays bit for bit
    against the eager chunk, with the gradients' all-reduce inside the
    captured step (the graph's chunk ran it in Python only in its eager
    first step and its capture)."""
    from nemar_tpu_torch import parallel

    batches = request_batches(NCCL_STEPS, TRAIN_BATCH, seed=18)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    (r,) = parallel.launch(_nccl_rank, [torch.device("cuda", 0)], backend="nccl",
                           args=(ckpt, batches), timeout=NCCL_TIMEOUT, pg_timeout=NCCL_TIMEOUT)
    launch_s = time.perf_counter() - t0
    model = train_model([*TRAIN_ARGS, "--gpu_ids", "0", "--checkpoints_dir", ckpt, "--batch_size",
                         str(TRAIN_BATCH), "--name", "smoke_nccl_ref"])
    counters = zero_counters()
    times, losses = _timed_losses(model, batches)
    launches = {k: fn.launches for k, fn in counters.items()}
    hashes = _param_hashes(model)
    del model
    want = {k: v * NCCL_STEPS for k, v in STEP_LAUNCHES.items()}
    spe = r["spe"]
    same_params = r["hashes"] == hashes
    phase("nccl_world1", backend=r["backend"], world=r["world"], device=r["device"],
          steps=NCCL_STEPS, batch=TRAIN_BATCH, launches=json.dumps(r["launches"]),
          expected=json.dumps(want), losses_bit_identical=r["losses"] == losses,
          params_bit_identical=same_params, params_compared=len(hashes),
          params_differing=json.dumps([k for k, v in hashes.items() if r["hashes"][k] != v][:8]),
          losses_first_step=json.dumps({"nccl": r["losses"][0], "no_group": losses[0]}),
          ms_per_step_nccl=json.dumps([round(t, 3) for t in r["ms"]]),
          ms_per_step_no_group=json.dumps([round(t, 3) for t in times]),
          ms_per_step_median_nccl=round(float(np.median(r["ms"][1:])), 3),
          ms_per_step_median_no_group=round(float(np.median(times[1:])), 3),
          nccl_device_ms_per_step=json.dumps(r["nccl_ms_per_step"]),
          all_reduce_calls_per_step=r["all_reduce_calls_per_step"],
          launch_seconds=round(launch_s, 2))
    phase("nccl_world1_spe", k=NCCL_SPE, graph_bit_identical_to_eager=(
              spe["graph"]["digest"] == spe["eager"]["digest"]),
          losses_equal=spe["graph"]["losses"] == spe["eager"]["losses"],
          all_reduce_calls=json.dumps({m: spe[m]["all_reduce_calls"] for m in spe}),
          replayed_chunk_all_reduce_calls=spe["graph"]["replay_all_reduce_calls"],
          nccl_device_ms_per_replayed_chunk=json.dumps(
              spe["graph"]["nccl_ms_per_replayed_chunk"]),
          ms_chunk=json.dumps({m: round(spe[m]["ms_chunk"], 3) for m in spe}))
    fails = []
    if (r["backend"], r["world"]) != ("nccl", 1):
        fails.append(f"the rank ran {r['backend']} at world {r['world']}")
    if r["launches"] != want or launches != want:
        fails.append(f"launches {r['launches']} / {launches} != {want}")
    if r["losses"] != losses or not same_params:
        fails.append("the NCCL rank's losses or parameters differ from the run without a group")
    if r["all_reduce_calls_per_step"] != 2:
        fails.append(f"{r['all_reduce_calls_per_step']} gradient all-reduces a step, not 2")
    if spe["graph"]["digest"] != spe["eager"]["digest"] or \
            spe["graph"]["losses"] != spe["eager"]["losses"]:
        fails.append("the graph's chunk differs from the eager chunk")
    # eager: 2 a step; graph: the eager first step's 2 and the capture's 2
    if (spe["eager"]["all_reduce_calls"], spe["graph"]["all_reduce_calls"],
            spe["graph"]["replay_all_reduce_calls"]) != (2 * NCCL_SPE, 4, 0):
        fails.append(f"all-reduce calls {spe}")
    if fails:
        raise AssertionError("phase 18: " + "; ".join(fails))


def _gloo_rank(cells: list) -> list:
    """Phase 18b inside its rank (gloo, 2 ranks on cuda:0): for each (args,
    batches) a model from the args' saved state takes a step on each batch;
    -> per cell the ms of each step, the state's digest after each, the
    losses after the first and, at rank 0, the parameters and gradients
    after the first (on the host)."""
    from nemar_tpu_torch import parallel
    from nemar_tpu_torch.models.base_model import state_digest, to_host

    fp32_only()
    outs = []
    for args, batches in cells:
        model = train_model(args)
        out = {"ms": [], "digests": [], "rank": parallel.rank()}
        for i, b in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.set_input(b)
            model.optimize_parameters()
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["digests"].append(state_digest(model))
            losses = dict(model.get_current_losses())
            if i == 0:
                out["losses"] = losses
                if parallel.rank() == 0:  # host copies, which later steps do not reach
                    out["params"] = {n: {k: to_host(p) for k, p in net.named_parameters()}
                                     for n, net in model.nets().items()}
                    out["grads"] = {n: {k: to_host(p.grad) for k, p in net.named_parameters()}
                                    for n, net in model.nets().items()}
        outs.append(out)
        del model
    return outs


def _unet_norm_biases(net) -> set:
    """The UNet G's biases of convolutions a norm follows."""
    n = net.num_downs
    return ({f"Conv_{i}.bias" for i in range(1, n - 1)}
            | {f"ConvTranspose_{j}.bias" for j in range(n - 1)})


def _hold_two_ranks(tag: str, args: list, batch: dict, ranks: list, pert_keys: tuple,
                    nets: dict | None = None, skip: dict | None = None) -> None:
    """The two ranks' first step (rank 0's parameters and gradients)
    against the same step in this process on the card, by phase 6's rule
    (``step_against_cpu``: "card" is the two ranks, "cpu" the one process,
    and the baselines the one process from perturbed inputs); the ranks'
    states bit-identical after every step."""
    r0, r1 = ranks
    runs = {}
    one_ms = None
    for i, name in enumerate(("two", "cpu", *perturbed_runs())):
        m = train_model(args)
        if name == "two":  # rank 0's step
            for n, net in m.nets().items():
                for k, p in net.named_parameters():
                    p.data.copy_(r0["params"][n][k])
                    g = r0["grads"][n][k]
                    p.grad = None if g is None else g.to(p.device)
            m._losses = dict(r0["losses"])
            runs["card"] = m
            continue
        if i == 1:
            before = {n: {k: p.detach().cpu().clone() for k, p in net.named_parameters()}
                      for n, net in m.nets().items()}
        b = batch if i == 1 else dict(batch, **{k: perturbed(batch[k], i - 2) for k in pert_keys})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.set_input(b)
        m.optimize_parameters()
        torch.cuda.synchronize()
        if i == 1:
            one_ms = (time.perf_counter() - t0) * 1e3
        runs[name] = m
    fields, fails, loss_errs = step_against_cpu(runs, {n: before for n in runs}, nets=nets,
                                                skip=skip)
    same = r0["digests"] == r1["digests"] and r0["losses"] == r1["losses"]
    phase(f"gloo_two_ranks_{tag}", steps=len(r0["digests"]), ranks_bit_identical=same,
          ms_per_step_rank0=json.dumps([round(t, 3) for t in r0["ms"]]),
          ms_per_step_rank1=json.dumps([round(t, 3) for t in r1["ms"]]),
          ms_one_process_first_step=round(one_ms, 3), **fields)
    if max(loss_errs.values()) > 1e-4:
        fails.append(f"losses {loss_errs}")
    if not same:
        fails.append("the two ranks' states differ")
    if fails:
        raise AssertionError(f"phase 18b {tag}: " + "; ".join(fails))


def run_gloo_two_ranks(ckpt: str) -> None:
    """Phase 18b: two ranks sharing cuda:0 over gloo (the launcher called
    with [cuda:0, cuda:0]): the NeMAR b8 step (4 rows a rank) from phase
    6's shared state, and pix2pix at its template defaults (batch norm over
    the global batch, dropout drawn for it) at global batch
    GLOO_PIX2PIX_BATCH from a state shared the same way (one step in this
    process from the seed); each for GLOO_STEPS steps, the ranks' states
    bit-identical after each, the first step within phase 6's limits of
    the one-process step on the card (the reduction order differs); ms a
    step of each rank."""
    from nemar_tpu_torch import parallel

    dev = torch.device("cuda", 0)
    nemar = [*TRAIN_ARGS, "--checkpoints_dir", ckpt, "--continue_train", "--epoch", "smoke6",
             "--gpu_ids", "0", "--batch_size", str(TRAIN_BATCH)]
    nemar_batches = request_batches(GLOO_STEPS, TRAIN_BATCH, seed=19)
    pix = [*PIX2PIX_ARGS, "--gpu_ids", "0", "--checkpoints_dir", ckpt, "--name", "smoke_pix2pix_dp",
           "--batch_size", str(GLOO_PIX2PIX_BATCH)]
    pix_batches = pair_batches(1 + GLOO_STEPS, GLOO_PIX2PIX_BATCH, seed=20)
    m = train_model(pix)
    m.set_input(pix_batches[0])
    m.optimize_parameters()
    m.save_networks("shared")
    skip = {"G": _unet_norm_biases(m.netG),
            "D": {f"Conv_{i}.bias" for i in range(1, m.netD.n_layers + 1)}}
    del m
    pix = [*pix, "--continue_train", "--epoch", "shared"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = parallel.launch(_gloo_rank, [dev, dev], backend="gloo",
                            args=([(nemar, nemar_batches), (pix, pix_batches[1:])],),
                            timeout=NCCL_TIMEOUT, pg_timeout=NCCL_TIMEOUT)
    phase("gloo_two_ranks", seconds=round(time.perf_counter() - t0, 2))
    _hold_two_ranks("nemar", nemar, nemar_batches[0], [r[0] for r in ranks], ("A",))
    _hold_two_ranks("pix2pix", pix, pix_batches[1], [r[1] for r in ranks], ("A", "B"),
                    nets={"G": "G", "D": "D"}, skip=skip)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from nemar_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    fp32_only()
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
    check_warp_nearest(dev)
    t1 = time.perf_counter()
    results.update(check_bf16_kernels(dev))
    phase("kernels", seconds=round(time.perf_counter() - t0, 2),
          bf16_seconds=round(time.perf_counter() - t1, 2), trace_retries=json.dumps(TRACE_RETRIES))
    TRACE_RETRIES.clear()
    t0 = time.perf_counter()
    results.update(check_bwd_kernels(dev))
    t1 = time.perf_counter()
    results.update(check_bf16_bwd_kernels(dev))
    phase("kernels_bwd", seconds=round(time.perf_counter() - t0, 2),
          bf16_seconds=round(time.perf_counter() - t1, 2), trace_retries=json.dumps(TRACE_RETRIES))

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
        for arm in SCIENCE_ARMS:
            t0 = time.perf_counter()
            run_science_arm(arm, ckpt)
            phase("science_phase", arm=arm, seconds=round(time.perf_counter() - t0, 2))
        t0 = time.perf_counter()
        compare_r_with_cpu(ckpt)
        phase("science_r_vs_cpu_phase", seconds=round(time.perf_counter() - t0, 2))
        t0 = time.perf_counter()
        run_off_kernel_shapes(ckpt)
        phase("off_kernel_shapes_phase", seconds=round(time.perf_counter() - t0, 2))
        t0 = time.perf_counter()
        run_adversarial_gate()
        phase("adversarial_gate_phase", seconds=round(time.perf_counter() - t0, 2))
        t0 = time.perf_counter()
        run_a5_step(ckpt)
        phase("a5_phase", seconds=round(time.perf_counter() - t0, 2))
        t0 = time.perf_counter()
        compare_a5_with_cpu(ckpt)
        phase("a5_vs_cpu_phase", seconds=round(time.perf_counter() - t0, 2))
        t0 = time.perf_counter()
        run_b32_512(ckpt)
        phase("b32_512_phase", seconds=round(time.perf_counter() - t0, 2))
        t0 = time.perf_counter()
        bf16_launch_counts = run_bf16(ckpt)
        phase("bf16_phase", seconds=round(time.perf_counter() - t0, 2))
        t0 = time.perf_counter()
        run_bf16_b32_512(ckpt)
        phase("bf16_b32_512_phase", seconds=round(time.perf_counter() - t0, 2))
        for tag, fn in (("cycle_gan", run_cycle_gan), ("cycle_gan_vs_cpu", compare_cycle_with_cpu),
                        ("pix2pix", run_pix2pix), ("test_model", run_test_model),
                        ("remat", run_remat)):
            t0 = time.perf_counter()
            fn(ckpt)
            phase(f"{tag}_phase", seconds=round(time.perf_counter() - t0, 2))
        run_step_graph_phases(ckpt)
        for tag, fn in (("nccl_world1", run_nccl_world1), ("gloo_two_ranks", run_gloo_two_ranks)):
            t0 = time.perf_counter()
            fn(ckpt)
            phase(f"{tag}_phase", seconds=round(time.perf_counter() - t0, 2))
    # the inference kernels' launches come from phase 3, the backward ones'
    # from phase 5 (the inference path launches none); the bf16 variants'
    # from phase 12's requests and steps
    launches.update({k: v for k, v in train_launches.items() if k.endswith("-bwd")})
    launches.update({BF16[k]: bf16_launch_counts[BF16[k]] for k in BF16})

    sources = {"K-block": ("cuda", "nemar_tpu_torch/csrc/resblock_fwd.cu",
                           "nemar_tpu/ops/conv_fused.py:228"),
               "K-warp": ("cuda", "nemar_tpu_torch/csrc/warp_fwd.cu",
                          "nemar_tpu/ops/warp_pallas.py:152"),
               "K-in": ("cuda", "nemar_tpu_torch/csrc/in_act_fwd.cu",
                        "nemar_tpu/ops/norm.py:193"),
               "K-head": ("cuda", "nemar_tpu_torch/csrc/head_fwd.cu",
                          "nemar_tpu/ops/conv_head_roll.py:151"),
               "K-convt": ("cuda", "nemar_tpu_torch/csrc/convt_fwd.cu",
                           "nemar_tpu/ops/attic/convt_fused.py:105"),
               "K-block-bwd": ("cuda", "nemar_tpu_torch/csrc/resblock_bwd.cu",
                               "nemar_tpu/ops/conv_fused.py:544"),
               "K-warp-bwd": ("cuda", "nemar_tpu_torch/csrc/warp_bwd.cu",
                              "nemar_tpu/ops/warp_pallas.py:448"),
               "K-in-bwd": ("cuda", "nemar_tpu_torch/csrc/in_act_bwd.cu",
                            "nemar_tpu/ops/norm.py:89"),
               "K-head-bwd": ("cuda", "nemar_tpu_torch/csrc/head_bwd.cu",
                              "nemar_tpu/ops/conv_head_roll.py:174"),
               "K-convt-bwd": ("cuda", "nemar_tpu_torch/csrc/convt_bwd.cu",
                               "nemar_tpu/ops/attic/convt_fused.py:216")}
    # each bf16 variant replaces the same TPU kernel as its fp32 kernel,
    # which the JAX package runs in bf16 under --bf16
    sources.update({BF16[k]: sources[k] for k in BF16})
    kernels = [{"name": k, "route": r, "source": s, "replaces": rep, "launches": launches[k],
                **results[k]} for k, (r, s, rep) in sources.items()]
    phase("total", seconds=round(time.perf_counter() - START, 2))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
