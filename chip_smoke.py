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
     step at batch A5_CPU_BATCH (microbatches of 2) on the card against
     the CPU from that run's saved state, as phase 6 holds one, plus the
     penalty among the losses, the EMA shadows and the pool
     (``compare_a5_with_cpu``);
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
  19. the image height in bands over two ranks (``--mesh_spatial 2``; two
     ranks sharing cuda:0 over gloo, one spatial group, ``run_spatial``):
     in each rank, ``[spatial_kernels]``: each kernel's band form (K-in,
     K-in-bwd, K-block, K-block-bwd, K-convt, K-convt-bwd, K-head,
     K-head-bwd, K-warp, K-warp-bwd) on the card against its plain band
     form on the card (the plain ops with the same exchanges) at the band
     shapes of the 256^2 b8 step and of phase 19b's recipe, within the
     kernel's TOL, and bit for bit in two calls, the bf16 band forms of
     K-in, K-block, K-convt and their backwards at both against their
     plain bf16 band forms (K-in's and K-convt's forwards within BF16_ULPS
     of each value and their statistics within BF16_FP32_TOL, K-block's
     forward stage by stage, the backwards within BF16_ULPS of the
     tensor's largest value), each timed forward and backward beside its
     plain band form; then one b1
     request, which gathers the frames, within the inference limit (1e-3)
     of the one-process request; then
     SPATIAL_STEPS b8 steps from phase 6's shared state: the ranks' states
     bit-identical after each, the first step within phase 6's limits of
     the one-process step (``_hold_two_ranks``), each kernel's launches per
     rank per step (the band forms' calls and their stages:
     SPATIAL_STEP_LAUNCHES), ms a step per rank, and each rank's peak
     allocated memory over its first step beside the one-process step's,
     with the bytes each step saves for its backwards (``saved_bytes``).
  19b. the registration recipe in bands (``run_spatial_recipe``; two ranks
     on cuda:0 over gloo): the science arms' 256^2 flags (SCIENCE_SHARED,
     SCIENCE_ARMS), the multiscale arm under --bf16 for
     SPATIAL_RECIPE_STEPS b8 steps, then one affine-arm step in fp32, each
     from a state saved from the seed with R's heads drawn: the ranks
     bit-identical, the launches per step and rank
     (SPATIAL_RECIPE_LAUNCHES: the bf16 band forms' calls and stages, the
     fp32 ones' for the affine arm), the bf16 step within
     test_torch_bf16.py's rule (a) of the one-process bf16 step
     (``_hold_bf16_rule_a``), the affine step within phase 6's limits of
     the one-process step, ms a step and each rank's peak memory over its
     first step beside the one-process step's.
  19c. NeMAR's step flags in bands (``run_spatial_flags``; two ranks on
     cuda:0 over gloo, 256^2 b8, SPATIAL_FLAGS): (a) --gan_mode wgangp with
     --remat and without it, SPATIAL_FLAG_STEPS steps each from phase 6's
     shared state; (b) --g_batch --stn_padding_mode border
     --stn_align_corners, one step from that state; (c)
     --stn_field_source fake --freeze_g --gan_mode vanilla --netG
     resnet_9blocks, one step from a state saved from the seed with R's
     head drawn. The ranks bit-identical after every step; (a) under
     --remat bit for bit the band step without it; the launches per step
     and rank asserted (SPATIAL_FLAG_LAUNCHES; K-in-bwd's band stages
     inside the penalty apart, SPATIAL_PENALTY_IN_BWD); each cell's first
     step within phase 6's limits of the one-process step (under wgangp
     G_GAN in two parts, as phase 10b holds it: the two ranks' within 1e-4
     of the one process's recomputed with their updated D); ms a step and
     rank, each rank's peak memory over its
     first step beside one process's, with and without --remat. Its
     ``[spatial_kernels]``: K-in's band double backward at D's three band
     shapes of the penalty's pass (``check_band_double_bwd``) against its
     plain band form and the whole-frame plain function, within 1e-4 of
     the largest value, bit for bit twice, its launches asserted.
  19d. the band geometry of the JAX package's spatial mesh
     (``run_spatial_geometry``; two ranks on cuda:0 over gloo,
     SPATIAL_GEOMETRY): (a) NeMAR's default network at 224^2 b8 with
     --recon_pyramid 5, fp32 (the STN's 14- and 7-row levels in bands of 7
     | 7 and 4 | 3, its skips re-cut, G's output re-cut, the pyramid's
     bands re-cut to even bounds before each pool), then one b1 request;
     (b) __graft_entry__.py's network flags (32^2, ngf, ndf and stn_ngf 8)
     at --stn_depth 3 and 5 (D's bands of 2 and 1 rows, then 2 and none;
     at depth 5 the STN's bottom level of one row, rank 1's band empty);
     SPATIAL_GEOMETRY_STEPS b8 steps each from a state saved from the seed
     with R's head drawn. The ranks bit-identical after every step, the
     launches per step and rank asserted (``geometry_launches``), each
     cell's first step within phase 6's limits of the one-process step,
     the request, from the ranks' state after the steps, within 1e-3 of
     the one-process request at that state, ms a step and rank and each
     rank's peak memory beside one process's. Its ``[spatial_kernels]``:
     the band forms of K-in, K-block, K-convt and K-head, forward and
     backward, fp32 and bf16, on bands of 33 | 32, 1 | 64 and (K-in) 0 |
     65 rows (GEOMETRY_BANDS), as phase 19's (``check_band_kernels``).
  19e. the template models in bands (``run_spatial_templates``; two ranks
     on cuda:0 over gloo, SPATIAL_TEMPLATES), at full width: (a) pix2pix
     at its template defaults (unet_256, batch norm, dropout, vanilla,
     256^2 b1: the innermost level of one row in bands of 1 and none, the
     dropout masks the frame's cut to the bands), (b) cycle_gan at its
     template defaults (resnet_9blocks, instance norm, a pool of 50, 256^2
     b1), each SPATIAL_TEMPLATE_STEPS steps from a state saved from the
     seed; (c) NeMAR's default network under --norm batch --netD pixel,
     b8, one step, G and R from phase 6's state; (d) --model test, parsed
     as test.py parses it, serving (b)'s G_A as the ranks saved it, a b1
     request. The ranks bit-identical after every step, the launches per
     step and rank asserted (SPATIAL_TEMPLATE_LAUNCHES: none on (a), the
     band forms' and K-head's on (b), K-head's, K-warp's and R's K-in band
     forms on (c)), each cell's first step within phase 6's limits of the
     one-process step, the request within 1e-3 of the one-process
     request, ms a step and rank and each rank's peak memory beside one
     process's. Its ``[spatial_kernels]``: the band forms of K-in, K-block,
     K-convt and K-head, forward and backward, fp32, at cycle_gan's b1
     band shapes, against their plain band forms, bit for bit twice.

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
yardstick. The band forms (phases 19 and 19b) have entries of their own,
``<kernel>-band`` and ``<kernel>-band-bf16`` (``band_kernel_entries``): one
call at the 256^2 b8 step's band shapes (summed over K-convt's two), its
exchanges and all-gathers included, beside its plain band form, its
bound the band's work, and its stage launches in the main path's first
step (phase 19's fp32 step, 19b's bf16 step). The last line is ``{"ok":
true, "device": {...}}``.
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
# phase 10b's batch: the card's A5 step against the CPU's, and the CPU's
# perturbed baselines, at two microbatches of 2 (the CPU's four wgangp steps
# at 256^2 were the smoke's longest phase at batch 8)
A5_CPU_BATCH = 4
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
    convolutions followed by a norm (instance or batch) and, under wgangp, D's output
    bias (the Wasserstein loss moves by +1 and -1 with it, and the penalty,
    a gradient in D's input, does not see it)."""
    g = {k for k in model.netG.state_dict() if k.endswith(".bias")
         and not k.startswith(f"Conv_{1 + model.netG.n_downsampling}.")}
    # the pixel D: its Conv_1, before its norm, and Conv_2 its output
    n_layers = getattr(model.netD, "n_layers", 1)
    d = {f"Conv_{i}.bias" for i in range(1, n_layers + 1)}
    if model.gan_mode == "wgangp":
        d.add(f"Conv_{n_layers + 1}.bias")
    net_r = model.netR
    if hasattr(net_r, "n_downs"):  # the affine STN
        r = {f"Conv_{i}.bias" for i in range(net_r.n_downs)}
    else:  # the UNet: every conv but the flow heads
        heads = set(net_r.head_index.values())
        r = {f"Conv_{i}.bias" for i in range(net_r.n_convs) if i not in heads}
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
    """Phase 10b: one A5 step (A5_FLAGS, batch A5_CPU_BATCH: two microbatches
    of 2) on the card against the CPU from phase 10's saved state
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
    pair = request_batches(1, A5_CPU_BATCH, seed=10)[0]
    args = _a5_args(ckpt, "--continue_train", "--epoch", "a5", "--batch_size", str(A5_CPU_BATCH))
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
    phase("a5_card_vs_cpu", batch=A5_CPU_BATCH,
          microbatch=A5_CPU_BATCH // runs["card"].grad_accum,
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
    shapes as a yardstick (F.instance_norm at bf16 for K-in); K-block and
    K-convt also timed at the b8 step's shapes. The totals are those of one
    b1 request (K-block's b8 call, and K-convt's two b8 calls at each
    decoder stage, a b8 step's forward, beside them: ``b8_*``)."""
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
        # timed at the b1 request's shape and at the b8 step's
        timed = side == 64 and n in (1, TRAIN_BATCH)
        if n == 1:
            extra = vs_fp64_bf16("K-block-bf16", got, conv_fused.resblock_fwd_plain(x, w1, w2),
                                 conv_fused.resblock_fwd_plain(x, w1, w2, work=torch.float64))
        if timed:
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
        elif timed:
            results["K-block-bf16"].update(b8_device_ms=t["device_ms"], b8_bound_ms=t["bound_ms"],
                                           b8_yardstick_cudnn_bf16_ms=yard)
        del got, again, ref

    tally, yard = Tally(), 0.0
    b8 = {"b8_device_ms": 0.0, "b8_bound_ms": 0.0, "b8_yardstick_cudnn_bf16_ms": 0.0}
    b8_stages = {}
    for n, h, w, ci, co in BF16_CONVT:
        x = randn(rng, (n, h, w, ci), 1.0, dev).to(bf)
        wk = randn(rng, (3, 3, ci, co), 0.02, dev).to(bf)

        def kern():
            return convt_fused.fused_convt_in_cuda(x, wk)

        got, again = kern(), kern()
        ref = convt_fused.convt_in_fwd_plain(x, wk)
        extra = {}
        # timed at the b1 request's shapes and at the b8 step's
        timed = n in (1, TRAIN_BATCH) and (h, w, ci, co) in [s[:4] for s in CONVT_SHAPES]
        if n == 1:
            extra = vs_fp64_bf16("K-convt-bf16", got, ref,
                                 convt_fused.convt_in_fwd_plain(x, wk, work=torch.float64))
        if timed:
            t = timed_bf16(kern, lambda: convt_fused.convt_in_fwd_plain(x, wk), 3,
                           2 * n * h * w * 9 * ci * co, (x, wk, *got))
            cudnn = cudnn_bf16_convs(x, [wk], transposed=True)[0]
            extra.update({k: v for k, v in t.items() if k != "bound"},
                         yardstick_cudnn_bf16_ms=cudnn)
        err = hold_bf16("K-convt-bf16", f"{n}x{h}x{w}x{ci}->{co}", got, again, ref, **extra)
        if timed and n == 1:
            tally.add(2, err, t["ms"], t["plain_ms"], t["bound"])
            tally.device_ms += 2 * t["device_ms"]
            yard += 2 * cudnn
        elif timed:
            # a b8 step's forward: two calls at each stage
            b8["b8_device_ms"] += 2 * t["device_ms"]
            b8["b8_bound_ms"] += 2 * t["bound_ms"]
            b8["b8_yardstick_cudnn_bf16_ms"] += 2 * cudnn
            b8_stages[f"{n}x{h}x{w}x{ci}->{co}"] = {"device_ms": t["device_ms"],
                                                    "bound_ms": t["bound_ms"]}
    results["K-convt-bf16"] = dict(tally.result(), device_ms=tally.device_ms,
                                   yardstick_cudnn_bf16_ms=yard, **b8,
                                   b8_by_stage=json.dumps(b8_stages))

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

    tally, yard, by_stage = Tally(), 0.0, {}
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
            by_stage[f"{n}x{h}x{w}x{ci}->{co}"] = {"device_ms": t["device_ms"],
                                                   "bound_ms": t["bound_ms"]}
    results["K-convt-bwd-bf16"] = dict(tally.result(), device_ms=tally.device_ms,
                                       yardstick_cudnn_bf16_ms=yard,
                                       b8_by_stage=json.dumps(by_stage))

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
GLOO_STEPS = 1
GLOO_PIX2PIX_BATCH = 2
# phase 19: --mesh_spatial 2, two ranks on cuda:0
SPATIAL = 2
SPATIAL_STEPS = 2
# launches per step and rank of the band step (every rank runs every layer
# on its band): the kernels that run as they are (K-head on the band with
# its halo rows, K-warp from the gathered frames) phase 5's counts, the
# one-process launchers of the kernels that have a band form none
SPATIAL_STEP_LAUNCHES = {"K-block": 0, "K-warp": 1, "K-in": 0, "K-head": 2, "K-convt": 0,
                         "K-block-bwd": 0, "K-warp-bwd": 1, "K-in-bwd": 0, "K-head-bwd": 2,
                         "K-convt-bwd": 0}
# the band forms: (calls, stage launches) per step and rank, one call where
# phase 5's step makes one (STEP_LAUNCHES): K-in 2 stages a call (partials,
# merge + apply), K-block 4 (conv1, stats, conv2, residual), K-block-bwd 5,
# K-convt 2, K-convt-bwd 3; each stage's launcher is a few kernels
SPATIAL_BAND_STEP = {"K-in": (22, 44), "K-in-bwd": (22, 44), "K-block": (12, 48),
                     "K-block-bwd": (12, 60), "K-convt": (4, 8), "K-convt-bwd": (4, 12),
                     **{k + "-bf16": (0, 0) for k in ("K-in", "K-in-bwd", "K-block",
                                                      "K-block-bwd", "K-convt", "K-convt-bwd")}}


# phase 19b: the registration recipe in bands, two ranks of one spatial group
# on cuda:0 over gloo: the science arms' 256^2 flags (SCIENCE_SHARED,
# SCIENCE_ARMS: ngf/ndf 32, stn_ngf 16, stn_depth 6, b8, --recon_pyramid 5,
# --border_mask), the multiscale arm under --bf16 for SPATIAL_RECIPE_STEPS
# steps, then one affine-arm step in fp32, from a saved state of each arm
# with R's heads drawn (R_HEAD_DRAW)
SPATIAL_RECIPE_STEPS = 2
SPATIAL_RECIPE = {"multiscale": (["--bf16"], SPATIAL_RECIPE_STEPS), "affine": ([], 1)}
# launches per step and rank: the kernels that run as they are (phase 7's
# and 7b's counts: SCIENCE_LAUNCHES' working; under --bf16 K-warp and K-head
# on their fp32 kernels), the band forms' (calls, stages) where phase 7's
# and 7b's steps make a call (K-in 24 / 17 a step and its backward alike)
_BAND_ZERO = {k + t: (0, 0) for t in ("", "-bf16")
              for k in ("K-in", "K-in-bwd", "K-block", "K-block-bwd", "K-convt", "K-convt-bwd")}
SPATIAL_RECIPE_LAUNCHES = {
    "multiscale": ({"K-warp": 7, "K-warp-bwd": 6, "K-head": 2, "K-head-bwd": 2},
                   {**_BAND_ZERO, "K-in-bf16": (24, 48), "K-in-bwd-bf16": (24, 48),
                    "K-block-bf16": (12, 48), "K-block-bwd-bf16": (12, 60),
                    "K-convt-bf16": (4, 8), "K-convt-bwd-bf16": (4, 12)}),
    "affine": ({"K-warp": 2, "K-warp-bwd": 1, "K-head": 2, "K-head-bwd": 2},
               {**_BAND_ZERO, "K-in": (17, 34), "K-in-bwd": (17, 34), "K-block": (12, 48),
                "K-block-bwd": (12, 60), "K-convt": (4, 8), "K-convt-bwd": (4, 12)}),
}
# phase 19c: NeMAR's step flags in bands, two ranks of one spatial group on
# cuda:0 over gloo at 256^2 b8 (TRAIN_ARGS): (a) wgangp under --remat and
# without it, from phase 6's shared state, SPATIAL_FLAG_STEPS steps each;
# (b) --g_batch with the warp's border padding and align_corners, from the
# same state, 1 step; (c) --stn_field_source fake --freeze_g, vanilla,
# resnet_9blocks, from a state saved from the seed with R's head drawn
# (R_HEAD_DRAW's multiscale std), 1 step
SPATIAL_FLAG_STEPS = 1
SPATIAL_FLAGS = {
    "wgangp_remat": (["--gan_mode", "wgangp", "--remat"], SPATIAL_FLAG_STEPS),
    "wgangp": (["--gan_mode", "wgangp"], SPATIAL_FLAG_STEPS),
    "g_batch_border_align": (["--g_batch", "--stn_padding_mode", "border",
                              "--stn_align_corners"], 1),
    "fake_freeze_g_vanilla_9blocks": (["--stn_field_source", "fake", "--freeze_g", "--gan_mode",
                                       "vanilla", "--netG", "resnet_9blocks"], 1),
}
# launches per step and rank, worked out from phase 19's
# (SPATIAL_STEP_LAUNCHES, SPATIAL_BAND_STEP: (calls, stages)):
#  * wgangp adds the penalty's D pass over the mix (K-in 3 calls), its
#    first-order backward with the graph (K-in-bwd 3, inside the penalty)
#    and, in the D loss's backward, the mix's three norms' backward (K-in-bwd
#    3), as ``accum_launches``; --remat runs each trunk block's band form
#    again (K-block 12) and R (K-in 2 x 5, K-warp 1), as ``remat_launches``;
#  * --g_batch runs G once at 2N: G's calls halve (K-in 3, K-block 6,
#    K-convt 2, K-head 1 and their backwards), and fake_B is warped on its
#    own (K-warp 2, K-warp-bwd 2);
#  * --freeze_g's D step is a forward without autograd (D's K-in-bwd 3 go),
#    resnet_9blocks has 9 trunk blocks a pass (K-block 18)
_SPATIAL_WARP = {"K-block": 0, "K-in": 0, "K-convt": 0, "K-block-bwd": 0, "K-in-bwd": 0,
                 "K-convt-bwd": 0}
SPATIAL_FLAG_LAUNCHES = {
    "wgangp_remat": ({**_SPATIAL_WARP, "K-head": 2, "K-head-bwd": 2, "K-warp": 2,
                      "K-warp-bwd": 1},
                     {**_BAND_ZERO, "K-in": (35, 70), "K-in-bwd": (28, 56), "K-block": (24, 96),
                      "K-block-bwd": (12, 60), "K-convt": (4, 8), "K-convt-bwd": (4, 12)}),
    "wgangp": ({**_SPATIAL_WARP, "K-head": 2, "K-head-bwd": 2, "K-warp": 1, "K-warp-bwd": 1},
               {**_BAND_ZERO, "K-in": (25, 50), "K-in-bwd": (28, 56), "K-block": (12, 48),
                "K-block-bwd": (12, 60), "K-convt": (4, 8), "K-convt-bwd": (4, 12)}),
    "g_batch_border_align": ({**_SPATIAL_WARP, "K-head": 1, "K-head-bwd": 1, "K-warp": 2,
                              "K-warp-bwd": 2},
                             {**_BAND_ZERO, "K-in": (19, 38), "K-in-bwd": (19, 38),
                              "K-block": (6, 24), "K-block-bwd": (6, 30), "K-convt": (2, 4),
                              "K-convt-bwd": (2, 6)}),
    "fake_freeze_g_vanilla_9blocks": ({**_SPATIAL_WARP, "K-head": 2, "K-head-bwd": 2,
                                       "K-warp": 1, "K-warp-bwd": 1},
                                      {**_BAND_ZERO, "K-in": (22, 44), "K-in-bwd": (19, 38),
                                       "K-block": (18, 72), "K-block-bwd": (18, 90),
                                       "K-convt": (4, 8), "K-convt-bwd": (4, 12)}),
}
# K-in-bwd's band stages inside the penalty a step (its first-order
# gradient, through D's three norms): (calls, stages)
SPATIAL_PENALTY_IN_BWD = (3, 6)
# phase 19d: the band geometry of the JAX package's spatial mesh, two ranks
# of one spatial group on cuda:0 over gloo, each cell from a state saved
# from the seed with R's head drawn (R_HEAD_DRAW's multiscale std): (a)
# NeMAR's default network (TRAIN_ARGS) at 224^2 with --recon_pyramid 5; (b)
# __graft_entry__.py's network flags (32^2, ngf, ndf and stn_ngf 8, no
# pool) at --stn_depth 3 and 5; b8, SPATIAL_GEOMETRY_STEPS steps each
SPATIAL_GEOMETRY_STEPS = 1
_GRAFT_NET = ["--ngf", "8", "--ndf", "8", "--stn_ngf", "8", "--crop_size", "32",
              "--load_size", "32", "--pool_size", "0"]
SPATIAL_GEOMETRY = {
    "224_pyramid_5": (["--crop_size", "224", "--load_size", "224", "--recon_pyramid", "5"],
                      224, 5),
    "graft_depth_3": ([*_GRAFT_NET, "--stn_depth", "3"], 32, 3),
    "graft_depth_5": ([*_GRAFT_NET, "--stn_depth", "5"], 32, 5),
}
# its [spatial_kernels]: the bounds of a 65-row frame over the two ranks
GEOMETRY_BANDS = {"uneven": ((0, 33), (33, 65)), "thin": ((0, 1), (1, 65)),
                  "empty": ((0, 0), (0, 65))}


def geometry_launches(depth: int) -> tuple:
    """Launches per step and rank of a 19d cell: phase 19's
    (SPATIAL_STEP_LAUNCHES, SPATIAL_BAND_STEP), K-in's calls G's 6, D's 6
    and the STN's 2 a level (depth 5: phase 19's 22), its backward's alike;
    an empty band's K-in launches its stages as any other (no empty grid)."""
    k_in = 12 + 2 * depth
    return (dict(SPATIAL_STEP_LAUNCHES),
            {**SPATIAL_BAND_STEP, "K-in": (k_in, 2 * k_in), "K-in-bwd": (k_in, 2 * k_in)})


# phase 19e: the template models in bands, two ranks of one spatial group on
# cuda:0 over gloo, at full width: (a) pix2pix at its template defaults
# (PIX2PIX_ARGS: unet_256, ngf and ndf 64, batch norm, dropout on, vanilla
# GAN, 256^2, b1: eight levels down to one row in bands of 1 and none, the
# dropout masks cut to the bands) and (b) cycle_gan at its template defaults
# (CYCLE_ARGS: resnet_9blocks, instance norm, lsgan, a pool of 50, 256^2,
# b1), each from a state saved from the seed, SPATIAL_TEMPLATE_STEPS steps;
# (c) NeMAR's default network (TRAIN_ARGS) under --norm batch --netD pixel
# at b8, G and R from phase 6's shared state and D from the seed, 1 step;
# (d) the test model (test.py's parse, --model test --model_suffix _A)
# serving (b)'s G_A as the ranks saved it after their steps, a b1 request
SPATIAL_TEMPLATE_STEPS = 1
SPATIAL_TEMPLATES = {
    "pix2pix": (PIX2PIX_ARGS, 1, SPATIAL_TEMPLATE_STEPS),
    "cycle_gan": (CYCLE_ARGS, 1, SPATIAL_TEMPLATE_STEPS),
    "nemar_batch_pixel": ([*TRAIN_ARGS, "--norm", "batch", "--netD", "pixel"], TRAIN_BATCH, 1),
}
# launches per step and rank, worked out from phases 13 and 19
# (CYCLE_STEP_LAUNCHES, SPATIAL_BAND_STEP's stages a call):
#  * pix2pix none: the UNet, batch norm and the PatchGAN are stock
#    convolutions and norms, as the JAX package's XLA (phase 14);
#  * cycle_gan: K-head on the padded band (6 G passes, each in a backward);
#    the band forms' calls where phase 13's step makes one (K-in 30,
#    K-block 54, K-convt 12 and their backwards), (calls, stages);
#  * NeMAR under batch norm with the pixel D: K-head and K-warp as phase
#    19's step, R's instance norms the band forms (2 a level, 5 levels);
#    G's trunk, decoder and norms and D stock;
#  * the test model's request: G_A once, without a backward
SPATIAL_TEMPLATE_LAUNCHES = {
    "pix2pix": ({}, _BAND_ZERO),
    "cycle_gan": ({"K-head": 6, "K-head-bwd": 6},
                  {**_BAND_ZERO, "K-in": (30, 60), "K-in-bwd": (30, 60),
                   "K-block": (54, 216), "K-block-bwd": (54, 270), "K-convt": (12, 24),
                   "K-convt-bwd": (12, 36)}),
    "nemar_batch_pixel": ({"K-head": 2, "K-head-bwd": 2, "K-warp": 1, "K-warp-bwd": 1},
                          {**_BAND_ZERO, "K-in": (10, 20), "K-in-bwd": (10, 20)}),
    "request": ({"K-head": 1}, {**_BAND_ZERO, "K-in": (3, 6), "K-block": (9, 36),
                                "K-convt": (2, 4)}),
}


# phase 19f: --steps_per_execution in bands, two ranks of one spatial group
# on cuda:0 over gloo: NeMAR's default network (TRAIN_ARGS) at b8 from a
# state saved from the seed with R's head drawn (R_HEAD_DRAW's multiscale
# std), a pool of 50 filled before the chunk (its steps swap) and wgangp (so
# the chunk has draws), (a) fp32 and (b) --bf16: a chunk of SPATIAL_CHUNK
# steps through optimize_parameters_scan_eager (gloo's collectives cannot be
# captured in a CUDA graph) beside as many band optimize_parameters calls,
# the chunk run twice; one process's chunk of the same batches is the step
# graph's replays (optimize_parameters_scan)
SPATIAL_CHUNK = 2
SPATIAL_CHUNK_FLAGS = ["--pool_size", "50", "--gan_mode", "wgangp", "--steps_per_execution",
                       str(SPATIAL_CHUNK)]
SPATIAL_CHUNK_CELLS = {"fp32": [], "bf16": ["--bf16"]}
# the refusal a chunk on the graph meets in a gloo group (step_graph.StepGraph)
GLOO_GRAPH_REFUSAL = "gloo's collectives cannot be captured"


# test_torch_bf16.py's rule (a): a tensor of at most BF16_FEW elements is
# held as a scalar, its e floored at BF16_Q, bf16's relative spacing
BF16_Q = 2.0**-8
BF16_FEW = 8


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
                    nets: dict | None = None, skip: dict | None = None,
                    adam_t: int | None = None, g_gan_via_d: bool = False) -> None:
    """The two ranks' first step (rank 0's parameters and gradients)
    against the same step in this process on the card, by phase 6's rule
    (``step_against_cpu``: "card" is the two ranks, "cpu" the one process,
    and the baselines the one process from perturbed inputs); the ranks'
    states bit-identical after every step. Each loss within 1e-4; with
    ``g_gan_via_d`` (phase 19c's wgangp cells) G_GAN in two parts, as phase
    10b holds it (``compare_a5_with_cpu``): it is read through D after D's
    Adam step, whose elements of roundoff-sized gradient may step either
    way in the two runs, so the two ranks' G_GAN is held within 1e-4
    (of max(|G_GAN|, 0.1)) of the one process's recomputed with the two
    ranks' updated D, the one process's own within 1e-6 of its
    recomputation, and what the two updated Ds make of it is printed."""
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
                                                skip=skip, adam_t=adam_t)
    same = r0["digests"] == r1["digests"] and r0["losses"] == r1["losses"]
    gan_fields = {}
    if g_gan_via_d:
        shared = train_model(args)  # the state before the step
        gan = {"two": _g_gan_with(shared, r0["params"]["D"], batch),
               "one": _g_gan_with(shared, {k: v.detach() for k, v in
                                           runs["cpu"].netD.state_dict().items()}, batch)}
        del shared
        reported = {"two": r0["losses"]["G_GAN"],
                    "one": runs["cpu"].get_current_losses()["G_GAN"]}

        def rel(a, b):
            return abs(a - b) / max(abs(b), 0.1)

        gan_fields = {"g_gan": json.dumps({"reported": reported, "recomputed": gan}),
                      "g_gan_two_same_d_rel": rel(reported["two"], gan["two"]),
                      "g_gan_one_recomputed_rel": rel(reported["one"], gan["one"]),
                      "g_gan_d_update_rel": rel(gan["two"], gan["one"]),
                      "tol_g_gan_same_d": 1e-4, "tol_g_gan_recomputed": 1e-6}
        del loss_errs["G_GAN"]
        if not (gan_fields["g_gan_two_same_d_rel"] <= 1e-4
                and gan_fields["g_gan_one_recomputed_rel"] <= 1e-6):
            fails.append(f"G_GAN {gan_fields}")
    phase(f"gloo_two_ranks_{tag}", steps=len(r0["digests"]), ranks_bit_identical=same,
          ms_per_step_rank0=json.dumps([round(t, 3) for t in r0["ms"]]),
          ms_per_step_rank1=json.dumps([round(t, 3) for t in r1["ms"]]),
          ms_one_process_first_step=round(one_ms, 3), **fields, **gan_fields)
    if max(loss_errs.values()) > 1e-4:
        fails.append(f"losses {loss_errs}")
    if not same:
        fails.append("the two ranks' states differ")
    if fails:
        raise AssertionError(f"gloo_two_ranks_{tag}: " + "; ".join(fails))


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


def band_counters() -> dict:
    """{kernel: (its band form's call counter, its stage counter)}: the
    launchers' ``.launches`` and ``.stages`` (K-in's two stages counted on
    their own wrappers)."""
    from nemar_tpu_torch.ops import conv_fused, convt_fused, norm_cuda

    return {"K-in": (norm_cuda.in_band_part_cuda, norm_cuda.in_band_apply_cuda),
            "K-in-bwd": (norm_cuda.in_band_bwd_part_cuda, norm_cuda.in_band_bwd_apply_cuda),
            "K-block": conv_fused.block_band_fwd_cuda,
            "K-block-bwd": conv_fused.block_band_bwd_cuda,
            "K-convt": convt_fused.convt_band_fwd_cuda,
            "K-convt-bwd": convt_fused.convt_band_bwd_cuda}


def zero_band_counters() -> None:
    for c in band_counters().values():
        for fn in (c if isinstance(c, tuple) else (c,)):
            fn.launches = fn.launches_bf16 = 0
            if hasattr(fn, "stages"):
                fn.stages = fn.stages_bf16 = 0


def read_band_counters() -> dict:
    """{kernel: (calls, stage launches)} since ``zero_band_counters``, the
    fp32 band forms' under the kernel's name, the bf16 variants' under
    ``<kernel>-bf16``."""
    out = {}
    for k, c in band_counters().items():
        for tag, sfx in (("", ""), ("-bf16", "_bf16")):
            if isinstance(c, tuple):
                calls = getattr(c[0], "launches" + sfx)
                out[k + tag] = (calls, calls + getattr(c[1], "launches" + sfx))
            else:
                out[k + tag] = (getattr(c, "launches" + sfx), getattr(c, "stages" + sfx))
    return out


def check_band_kernels(geometry: bool = False, templates: bool = False) -> dict:
    """Phase 19's ``[spatial_kernels]``, in a rank of the spatial group:
    each kernel's band form on the card against its plain band form on
    the card (the plain ops with the same exchanges), at the band shapes of
    the 256^2 b8 step at s = 2, each rank its band of one seeded frame: the
    output's max abs error, the input and weight gradients' (a seeded
    upstream gradient; the weights' the band's shares) max error over the
    largest reference value, the band form twice bit for bit, and the
    forward's and the backward's median event time (their exchanges and
    all-gathers included) beside the plain band form's, with the bound of
    the band's work. The cases named ``(recipe)`` are phase 19b's band
    shapes (the 256^2 recipe at ngf/ndf 32, b8), in fp32 and bf16, so that
    every GEMM instantiation of the band steps is held here. The bf16 band
    forms of K-in, K-block and K-convt (``-bf16``) on bf16 operands against
    their plain bf16 band forms: K-in's and K-convt's forwards, one
    rounding of fp32 arithmetic, within BF16_ULPS of each value (``yhat``
    too) and their fp32 statistics within BF16_FP32_TOL (``fwd_parts``);
    K-block's forward stage by stage (``block_band_stages_bf16``); the
    gradients, downstream of dz's rounding, within BF16_ULPS of the
    tensor's largest value. K-block-bwd's and K-convt-bwd's band forms
    take the plain forward's saved values, as phase 2b's checks do: through
    autograd, the relu masks of two fp32 forwards differ where a normalised
    value is within roundoff of 0, which moves K-block's dx by up to 1.3e-2
    of its largest value at these shapes (measured on the card).

    With ``geometry`` (phase 19d) the cases of GEOMETRY_BANDS instead: each
    band form at phase 19's widths on a 65-row frame in bands of 33 and 32
    rows (``(uneven)``), of 1 and 64 (``(thin)``: K-head's 3-row halo
    reflected across the band of one) and, for K-in, of 0 and 65
    (``(empty)``), fp32 and bf16 (K-head fp32: its bf16 runs the fp32 kernel
    behind casts); each case's band-form calls and stage launches counted
    (``launches``). An empty band's errors are its partner's (0 here).

    With ``templates`` (phase 19e) the fp32 band forms at cycle_gan's b1
    band shapes (ngf, ndf 64, 256^2 over the two ranks): G's first K-in,
    a trunk block (256 channels, a 64-row frame in 32 | 32), both decoder
    stages, the head, and D's last normed conv over [real; fake] (31 rows
    in 16 | 15); each case's calls and stages counted (``launches``)."""
    from nemar_tpu_torch import parallel
    from nemar_tpu_torch.ops import conv_fused, conv_head, convt_fused, norm, norm_cuda
    from nemar_tpu_torch.ops.warp import grid_sample, grid_sample_plain, identity_grid
    from nemar_tpu_torch.parallel import spatial

    j = parallel.spatial_rank()
    out = {}

    def case(name, tol, tol_bwd, frames, weights, band, kern, plain, saved=None,
             kern_bwd=None, bf16=False, flops=(0.0, 0.0), stages=None, fwd_parts=None,
             plain_from_saved=None):
        # plain_from_saved: the plain band backward fed the same saved values
        # as the kernel's (the geometry cases' bf16 comparisons), not
        # autograd through a plain forward of its own
        xs = [f.narrow(1, band.r0, band.rows).contiguous() for f in frames]
        # the plain forward's saved values, once (cuDNN's transposed
        # convolution is not deterministic outside the step's setting)
        sv = saved(*xs, *weights) if saved is not None else None

        def run(fn):
            a = [x.clone().requires_grad_() for x in xs]
            b = [w.clone().requires_grad_() for w in weights]
            y = fn(*a, *b)
            g = randn(card_rng(77), tuple(y.shape)).to(y.dtype)
            from_saved = kern_bwd if fn is kern else plain_from_saved
            if from_saved is not None:
                # the backward fed the plain forward's saved values, so both
                # take the same relu masks (as phase 2b's checks)
                grads = from_saved(*sv, g)
                bwd = lambda: from_saved(*sv, g)  # noqa: E731
            else:
                grads = torch.autograd.grad(y, a + b, g, retain_graph=True)
                bwd = lambda: torch.autograd.grad(y, a + b, g, retain_graph=True)  # noqa: E731
            torch.cuda.synchronize()
            return [y.detach(), *grads], bwd, (y, g)

        zero_band_counters()
        counters = zero_counters()
        got, bwd, yg = run(kern)
        launches = {**{k: v for k, v in read_band_counters().items() if v[0]},
                    **{k: fn.launches for k, fn in counters.items() if fn.launches}}
        (again, _, _), (ref, plain_bwd, _) = run(kern), run(plain)
        if not yg[0].numel():  # an empty band: nothing of its own to hold
            got, ref = [t for t in got if t.numel()], [t for t in ref if t.numel()]
        fp32_err = 0.0
        if bf16:
            if stages is not None:
                fwd_err = max(stages(*xs, *weights))
            else:
                kp, pp = fwd_parts(*xs, *weights)
                fwd_err = max([bf16_ulps(a, b) for a, b in zip(kp, pp)
                               if b.dtype == bf and b.numel()] + [0.0])
                fp32_err = max(max_rel_err([a], [b]) for a, b in zip(kp, pp) if b.dtype != bf)
            errs = [bf16_ulps(a, b, at_scale=True) for a, b in zip(got[1:], ref[1:])]
        else:
            fwd_err = max_abs_err(got[:1], ref[:1]) if yg[0].numel() else 0.0
            errs = [max_rel_err([a], [b]) for a, b in zip(got[1:], ref[1:])]
        # the band's row of an input gradient's largest error
        rows = [int(((a.float() - b.float()).abs().amax(dim=(0, 2, 3))).argmax())
                for a, b in zip(got[1:1 + len(xs)], ref[1:1 + len(xs)]) if a.numel()]
        with torch.no_grad():
            ms = median_ms(lambda: kern(*xs, *weights), iters=5, warmup=1)
            pms = median_ms(lambda: plain(*xs, *weights), iters=3, warmup=1)
        bms, pbms = median_ms(bwd, iters=5, warmup=1), median_ms(plain_bwd, iters=3, warmup=1)
        peak = bound_bf16 if bf16 else bound
        bnd = peak(flops[0], *xs, *weights, yg[0])
        bnd_bwd = peak(flops[1], *xs, *weights, yg[1], *got[1:])
        out[name] = {"fwd_err": fwd_err, "bwd_err": max(errs, default=0.0), "bwd_errs": errs,
                     "worst_rows": rows, "tol": tol, "tol_bwd": tol_bwd,
                     "fp32_err": fp32_err, "tol_fp32": BF16_FP32_TOL,
                     "unit": ("bf16 ulps (forward: " + ("of each value" if fwd_parts else
                                                        "of the largest value, by stage")
                              + "; backward: of the largest value)") if bf16 else "abs; rel",
                     "fwd_abs_err": max_abs_err(got[:1], ref[:1]) if yg[0].numel() else 0.0,
                     "bwd_abs_err": max((float((a.double() - b.double()).abs().max())
                                         for a, b in zip(got[1:], ref[1:])), default=0.0),
                     "launches": launches,
                     "bits": all(torch.equal(p, q) for p, q in zip(got, again)),
                     "band": list(xs[0].shape), "ms": round(ms, 4), "plain_ms": round(pms, 4),
                     "bwd_ms": round(bms, 4), "plain_bwd_ms": round(pbms, 4),
                     "bound": bnd, "bound_bwd": bnd_bwd}

    rng = card_rng(41)
    frame = lambda *shape: randn(rng, shape)  # noqa: E731
    bf = torch.bfloat16
    dts = (("", torch.float32), ("-bf16", bf))

    def in_case(name, tag, dt, shape, band, act):
        # shape (N, H, W, C): the frame's, of which band holds rows
        x = frame(*shape).to(dt)
        chunks = norm_cuda.band_chunks(max(b - a for a, b in band.bounds) * shape[2])
        fl = x.numel() * band.rows / shape[1]
        case(name, *((BF16_ULPS, BF16_ULPS) if tag else (TOL["K-in"], TOL["K-in-bwd"])), [x],
             [], band, lambda x: norm.instance_norm_act_band(x, band, act),
             lambda x: norm.instance_norm_act_band(x, band, act, plain=True),
             bf16=bool(tag), flops=(6.0 * fl, 8.0 * fl),
             fwd_parts=lambda x: (norm_cuda.in_band_apply_cuda(
                 x, spatial.gather_parts(norm_cuda.in_band_part_cuda(x, chunks)), act, 1e-5, 0.2),
                 (norm.instance_norm_act_band(x, band, act, plain=True), norm.in_band_stats(x))))

    def block_case(name, tag, dt, side, c, band=None, batch=TRAIN_BATCH):
        # a side x side frame (of band's height, given a band)
        band = band or spatial.Band.split(side, SPATIAL, j)
        gemm = 2 * 2 * batch * band.rows * side * 9 * c * c  # two 3x3 convs of the band
        case(name, *((BF16_ULPS, BF16_ULPS) if tag else (TOL["K-block"], TOL["K-block-bwd"])),
             [frame(batch, band.height, side, c).to(dt)],
             [(frame(3, 3, c, c) * 0.02).to(dt), (frame(3, 3, c, c) * 0.02).to(dt)],
             band, lambda x, w1, w2: conv_fused.fused_resblock_band(x, w1, w2, band),
             lambda x, w1, w2: conv_fused.resblock_band_plain(x, w1, w2, band),
             saved=lambda x, w1, w2: (w1, w2,
                                      *conv_fused.resblock_band_saved_plain(x, w1, w2, band)),
             kern_bwd=lambda *a: conv_fused.block_band_bwd_cuda(*a, band), bf16=bool(tag),
             flops=(gemm, 2 * gemm), stages=block_band_stages_bf16(band) if tag else None,
             plain_from_saved=(lambda *a: conv_fused.resblock_band_bwd_plain_bf16(*a, band))
             if tag and geometry else None)

    def convt_case(name, tag, dt, hh, ci, co, band=None, batch=TRAIN_BATCH):
        band = band or spatial.Band.split(hh, SPATIAL, j)
        gemm = 2 * batch * band.rows * hh * 9 * ci * co

        def xp(x):
            return spatial.exchange_rows(x, band, (1,) * band.size, (0,) * band.size, dim=1,
                                         mode="zeros").contiguous()

        case(name, *((BF16_ULPS, BF16_ULPS) if tag else (TOL["K-convt"], TOL["K-convt-bwd"])),
             [frame(batch, band.height, hh, ci).to(dt)],
             [(frame(3, 3, ci, co) * 0.02).to(dt)], band,
             lambda x, w: convt_fused.fused_convt_in_band(x, w, band),
             lambda x, w: convt_fused.convt_band_plain(x, w, band),
             saved=lambda x, w: (lambda xp, yhat, st: (xp, w, yhat, st))(
                 *convt_fused.convt_band_saved_plain(x, w, band)),
             kern_bwd=lambda *a: convt_fused.convt_band_bwd_cuda(*a, band),
             bf16=bool(tag), flops=(gemm, 2 * gemm),
             plain_from_saved=(lambda *a: convt_fused.convt_band_bwd_plain_bf16(*a, band))
             if tag and geometry else None,
             fwd_parts=lambda x, w: (convt_fused.convt_band_fwd_cuda(xp(x), w, band), (
                 lambda out, saved: (out, *saved[1:]))(
                     *convt_fused.convt_band_fwd_plain_bf16(x, w, band))))

    def head_case(name, band, width, batch=TRAIN_BATCH):
        three = (3,) * band.size
        case(name, TOL["K-head"], TOL["K-head-bwd"], [frame(batch, band.height, width, 64)],
             [frame(7, 7, 64, 3) * 0.02], band,
             lambda x, w: conv_head.conv_head_band(x, w, band),
             lambda x, w: conv_head.conv_head_plain(spatial.exchange_rows(
                 x, band, three, three, dim=1, mode="reflect"), w)[:, 3:3 + band.rows])

    if geometry:
        for geo, bounds in GEOMETRY_BANDS.items():
            band = spatial.Band(bounds, j, bounds[-1][1])
            for tag, dt in dts:
                in_case(f"K-in{tag} ({geo})", tag, dt, (TRAIN_BATCH, band.height, 256, 64), band,
                        "relu")
                if geo == "empty":
                    continue
                block_case(f"K-block{tag} ({geo})", tag, dt, 64, 256, band)
                convt_case(f"K-convt{tag} 256->128 ({geo})", tag, dt, 64, 256, 128, band)
            if geo != "empty":
                head_case(f"K-head ({geo})", band, 256)
        return out
    # phase 19's step (ngf 64): G's first K-in, its trunk and its decoder;
    # D's third normed conv, 31 rows in bands of 16 and 15
    b256 = spatial.Band.split(256, SPATIAL, j)
    b31 = b256.conv(4, 2, 1)[0].conv(4, 2, 1)[0].conv(4, 2, 1)[0].conv(4, 1, 1)[0]
    if templates:
        f32 = torch.float32
        in_case("K-in (cycle_gan)", "", f32, (1, 256, 256, 64), b256, "relu")
        in_case("K-in (cycle_gan D, 31 rows)", "", f32, (2, 31, 31, 512), b31, "leaky_relu")
        block_case("K-block (cycle_gan)", "", f32, 64, 256, batch=1)
        for hh, ci, co in ((64, 256, 128), (128, 128, 64)):
            convt_case(f"K-convt {ci}->{co} (cycle_gan)", "", f32, hh, ci, co, batch=1)
        head_case("K-head (cycle_gan)", b256, 256, batch=1)
        return out
    for tag, dt in dts:
        in_case("K-in" + tag, tag, dt, (TRAIN_BATCH, 256, 256, 64), b256, "relu")
    in_case("K-in (D, 31 rows)", "", torch.float32, (2 * TRAIN_BATCH, 31, 31, 512), b31,
            "leaky_relu")
    for tag, dt in dts:
        block_case("K-block" + tag, tag, dt, 64, 256)
    for tag, dt in dts:
        for hh, ci, co in ((64, 256, 128), (128, 128, 64)):
            convt_case(f"K-convt{tag} {ci}->{co}", tag, dt, hh, ci, co)
    # phase 19b's recipe (ngf/ndf 32), its bf16 and fp32 arms alike
    for tag, dt in dts:
        in_case(f"K-in{tag} (recipe)", tag, dt, (TRAIN_BATCH, 256, 256, 32), b256, "relu")
        in_case(f"K-in{tag} (recipe D, 31 rows)", tag, dt, (2 * TRAIN_BATCH, 31, 31, 256), b31,
                "leaky_relu")
        block_case(f"K-block{tag} (recipe)", tag, dt, 64, 128)
        for hh, ci, co in ((64, 128, 64), (128, 64, 32)):
            convt_case(f"K-convt{tag} {ci}->{co} (recipe)", tag, dt, hh, ci, co)
    head_case("K-head", b256, 256)
    ident = identity_grid(256, 256, False, torch.float32, frame(1).device)[b256.r0:b256.r1][None]

    def warp(sample):
        return lambda img, flow: sample(spatial.gather_frame(img, b256, dim=1), ident + flow,
                                        "bilinear", "zeros", False)

    case("K-warp", TOL["K-warp"], TOL["K-warp-bwd"],
         [frame(TRAIN_BATCH, 256, 256, 4), frame(TRAIN_BATCH, 256, 256, 2) * 0.02], [], b256,
         warp(grid_sample), warp(grid_sample_plain))
    return out


def block_band_stages_bf16(band):
    """K-block's bf16 band form held stage by stage, as
    ``block_fwd_ref_bf16`` holds the whole-frame variant: -> a function of
    (x, w1, w2) giving the bf16 spacings (of each tensor's largest value)
    between the kernel's y1hat and h1p and the plain band form's from x,
    and between its out and the plain out from the kernel's own h1p (a
    rounding of h1 that lands the other way moves y2 by W times a spacing,
    and out by more than one)."""
    from nemar_tpu_torch.ops import conv_fused, norm
    from nemar_tpu_torch.parallel import spatial

    def held(x, w1, w2):
        one = (1,) * band.size
        xp = spatial.exchange_rows(x, band, one, one, dim=1, mode="reflect").contiguous()
        with torch.no_grad():
            out, (_, y1hat, h1p, _, _) = conv_fused.block_band_fwd_cuda(x, xp, w1, w2, band)
            _, (_, y1hat_ref, h1p_ref, _, _) = conv_fused.resblock_band_fwd_plain_bf16(
                x, w1, w2, band)
            y2 = conv_fused.conv3x3_wreflect(h1p.float(), w2.float())
            out_ref = (x.float() + norm.normalise(y2, norm.in_band_stats(y2))).to(torch.bfloat16)
        return [bf16_ulps(p, q, at_scale=True)
                for p, q in ((y1hat, y1hat_ref), (h1p, h1p_ref), (out, out_ref))]

    return held


# the band forms' entries of the kernels line: (entry, [spatial_kernels]
# cases, forward or backward, the band-form counter), the fp32 band forms
# timed at phase 19's step's shapes, the bf16 ones at phase 19b's recipe's
# (the one step that launches them); each band form replaces the TPU kernel
# its whole-frame kernel replaces
BAND_CASES = {"": {"K-in": ["K-in"], "K-block": ["K-block"],
                   "K-convt": ["K-convt 256->128", "K-convt 128->64"]},
              "-bf16": {"K-in": ["K-in-bf16 (recipe)"], "K-block": ["K-block-bf16 (recipe)"],
                        "K-convt": ["K-convt-bf16 128->64 (recipe)",
                                    "K-convt-bf16 64->32 (recipe)"]}}
BAND_ENTRIES = [(f"{k}{d}-band{t}", cases, d, k + d + t)
                for t, fam in BAND_CASES.items() for k, cases in fam.items()
                for d in ("", "-bwd")]
BAND_SOURCES = {"K-in": "nemar_tpu_torch/csrc/in_band.cu",
                "K-block": "nemar_tpu_torch/csrc/resblock_fwd.cu",
                "K-block-bwd": "nemar_tpu_torch/csrc/resblock_bwd.cu",
                "K-convt": "nemar_tpu_torch/csrc/convt_fwd.cu",
                "K-convt-bwd": "nemar_tpu_torch/csrc/convt_bwd.cu"}


def band_kernel_entries(checks: dict, launches: dict, replaces: dict) -> list:
    """The band forms' entries of the kernels line, from rank 0's
    ``[spatial_kernels]`` (one call of each case at the step's band shape,
    summed over a family's shapes; ms, plain ms, the bound of the band's
    work, the largest absolute error) and ``launches``, {counter: stage
    launches} of the main path's steps (phase 19's fp32 step, 19b's bf16
    steps)."""
    out = []
    for name, cases, d, counter in BAND_ENTRIES:
        fam = counter.replace("-bf16", "")
        ms = plain_ms = ops = byt = err = 0.0
        for c in cases:
            r = checks[c]
            ms += r["bwd_ms" if d else "ms"]
            plain_ms += r["plain_bwd_ms" if d else "plain_ms"]
            bnd = r["bound_bwd" if d else "bound"]
            ops, byt = ops + bnd[0], byt + bnd[1]
            err = max(err, r["bwd_abs_err" if d else "fwd_abs_err"])
        src = BAND_SOURCES["K-in" if fam.startswith("K-in") else fam]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces[fam], "launches": launches[counter],
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": max(ops, byt),
                    "bound_by": "operations" if ops >= byt else "bytes", "library_ms": None})
    return out


@contextlib.contextmanager
def saved_bytes():
    """Inside, every CUDA tensor autograd saves for a backward is counted
    once by its storage: -> a dict whose ``bytes`` holds the sum."""
    seen = {}
    out = {"bytes": 0}

    def pack(t):
        if t.is_cuda:
            st = t.untyped_storage()
            seen.setdefault(st.data_ptr(), st.nbytes())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        yield out
    out["bytes"] = sum(seen.values())


def _spatial_rank(args: list, request: dict, batches: list) -> dict:
    """Phase 19 inside its rank (gloo, one spatial group of 2 on cuda:0):
    ``check_band_kernels``; a model from phase 6's state answers the b1
    request (the frames gathered on every rank) and takes a step on each
    batch; -> the checks, rank 0's request visuals, per step the ms, the
    state's digest, the launches (``launch_counters``, ``read_band_counters``)
    and the spatial group's all-gathers (``spatial._gather.calls``),
    the losses after the first and, at rank 0, the parameters and
    gradients after the first (on the host), and the peak allocated memory
    over the first step."""
    from nemar_tpu_torch import parallel
    from nemar_tpu_torch.models.base_model import state_digest, to_host
    from nemar_tpu_torch.parallel import spatial

    fp32_only()
    parallel.set_mesh(SPATIAL)
    out = {"kernels": check_band_kernels(), "rank": parallel.rank(), "ms": [], "digests": [],
           "launches": [], "band_launches": [], "gathers": []}
    model = train_model(args)
    model.set_input(request)
    model.test()
    if parallel.rank() == 0:
        out["request"] = dict(model.get_current_visuals())
    for i, b in enumerate(batches):
        counters = zero_counters()
        zero_band_counters()
        spatial._gather.calls = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.set_input(b)
        if i == 0:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
        with saved_bytes() if i == 0 else contextlib.nullcontext() as saved:
            model.optimize_parameters()
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            out["memory"] = {"before": before, "peak": torch.cuda.max_memory_allocated(),
                             "saved": saved["bytes"]}
        out["launches"].append({k: fn.launches for k, fn in counters.items()})
        out["band_launches"].append(read_band_counters())
        out["gathers"].append(spatial._gather.calls)
        out["digests"].append(state_digest(model))
        losses = dict(model.get_current_losses())
        if i == 0:
            out["losses"] = losses
            if parallel.rank() == 0:
                out["params"] = {n: {k: to_host(p) for k, p in net.named_parameters()}
                                 for n, net in model.nets().items()}
                out["grads"] = {n: {k: to_host(p.grad) for k, p in net.named_parameters()}
                                for n, net in model.nets().items()}
    return out


def run_spatial(ckpt: str) -> None:
    """Phase 19: --mesh_spatial 2 over two ranks sharing cuda:0 (gloo): the
    band forms' checks, the b1 request and SPATIAL_STEPS b8 steps from phase
    6's shared state (``_spatial_rank``), held here against this process's
    request and step on the card; the launches per rank and step; each
    rank's peak memory over its first step beside the one-process step's."""
    from nemar_tpu_torch import parallel

    dev = torch.device("cuda", 0)
    args = [*TRAIN_ARGS, "--checkpoints_dir", ckpt, "--continue_train", "--epoch", "smoke6",
            "--gpu_ids", "0", "--batch_size", str(TRAIN_BATCH)]
    request = request_batches(1, 1, seed=31)[0]
    batches = request_batches(SPATIAL_STEPS, TRAIN_BATCH, seed=29)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = parallel.launch(_spatial_rank, [dev, dev], backend="gloo",
                            args=([*args, "--mesh_spatial", str(SPATIAL)], request, batches),
                            timeout=NCCL_TIMEOUT, pg_timeout=NCCL_TIMEOUT)
    phase("spatial", seconds=round(time.perf_counter() - t0, 2))
    fails = []
    for r in ranks:
        for name, c in r["kernels"].items():
            phase("spatial_kernels", rank=r["rank"], kernel=repr(name), **c)
            if not (c["fwd_err"] <= c["tol"] and c["bwd_err"] <= c["tol_bwd"]
                    and c["fp32_err"] <= c["tol_fp32"] and c["bits"]):
                fails.append(f"rank {r['rank']} {name}: {c}")
    for r in ranks:
        for i, (got, band) in enumerate(zip(r["launches"], r["band_launches"])):
            want = {k: v for k, v in SPATIAL_STEP_LAUNCHES.items()}
            bad = {k: v for k, v in got.items() if v != want[k]}
            bad.update({k: v for k, v in band.items() if tuple(v) != SPATIAL_BAND_STEP[k]})
            if bad:
                fails.append(f"rank {r['rank']} step {i}: launches {bad}")
        phase("spatial_launches", rank=r["rank"], per_step=json.dumps(r["launches"][0]),
              band_calls_stages_per_step=json.dumps(r["band_launches"][0]),
              all_gathers_per_step=json.dumps(r["gathers"]))
    # the request against this process's
    m = train_model(args)
    m.set_input(request)
    m.test()
    want = m.get_current_visuals()
    req_err = max(float(np.abs(ranks[0]["request"][k] - want[k]).max()) for k in want)
    phase("spatial_request", max_abs_err=req_err, tol=1e-3)
    if not req_err <= 1e-3:
        fails.append(f"the b1 request: {req_err}")
    # the one-process step's peak memory over what was allocated before it
    # (the model and its Adam state included there, and in a rank's
    # ``before``), from the same state
    del m
    torch.cuda.synchronize()
    empty = torch.cuda.memory_allocated()
    m = train_model(args)
    m.set_input(batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    with saved_bytes() as saved:
        m.optimize_parameters()
    torch.cuda.synchronize()
    one_peak = torch.cuda.max_memory_allocated() - before
    del m
    gib = 2.0**30
    phase("spatial_memory", one_process_step_peak_over_before_gib=round(one_peak / gib, 3),
          one_process_before_gib=round((before - empty) / gib, 3),
          one_process_saved_for_backward_gib=round(saved["bytes"] / gib, 3),
          **{f"rank{r['rank']}_saved_for_backward_gib": round(r["memory"]["saved"] / gib, 3)
             for r in ranks},
          **{f"rank{r['rank']}_step_peak_over_before_gib":
             round((r["memory"]["peak"] - r["memory"]["before"]) / gib, 3) for r in ranks},
          **{f"rank{r['rank']}_before_gib": round(r["memory"]["before"] / gib, 3)
             for r in ranks},
          **{f"rank{r['rank']}_peak_gib": round(r["memory"]["peak"] / gib, 3) for r in ranks})
    if fails:
        raise AssertionError("phase 19: " + "; ".join(fails))
    _hold_two_ranks("spatial", args, batches[0], ranks, ("A",))
    return ranks[0]["kernels"], {k: v[1] for k, v in ranks[0]["band_launches"][0].items()}


def _band_steps_rank(cells: list, requests: dict | None = None,
                     saves: dict | None = None) -> list:
    """Phases 19b-19e inside their rank: for each (args, batches) a
    model from the args' saved state takes a step on each batch; -> per cell
    the ms of each step, the state's digest, the launches
    (``zero_all_counters``, ``read_band_counters``, zeroed before each step;
    K-in-bwd's band calls and stages inside the WGAN-GP penalty apart), the
    losses after the first, the peak memory over the first and, at rank 0,
    the parameters and gradients after the first (on the host). A cell
    with a request in ``requests`` ({cell index: batch}) answers it after
    its steps; rank 0 returns the gathered visuals and the parameters. A
    cell in ``saves`` ({cell index: suffix}) is then saved under that suffix
    (every rank in the save, rank 0 writing; a barrier after it)."""
    from nemar_tpu_torch import parallel
    from nemar_tpu_torch.models import networks
    from nemar_tpu_torch.models.base_model import state_digest, to_host

    fp32_only()
    parallel.set_mesh(SPATIAL)
    penalty = networks.cal_gradient_penalty
    inside = [0, 0]

    def counted(*a, **k):
        before = read_band_counters()["K-in-bwd"]
        gp = penalty(*a, **k)
        after = read_band_counters()["K-in-bwd"]
        inside[0] += after[0] - before[0]
        inside[1] += after[1] - before[1]
        return gp

    networks.cal_gradient_penalty = counted
    outs = []
    try:
        for args, batches in cells:
            model = train_model(args)
            out = {"ms": [], "digests": [], "launches": [], "band_launches": [],
                   "penalty_in_bwd": [], "rank": parallel.rank()}
            for i, b in enumerate(batches):
                counters, _ = zero_all_counters()
                zero_band_counters()
                inside[:] = [0, 0]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model.set_input(b)
                if i == 0:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    before = torch.cuda.memory_allocated()
                model.optimize_parameters()
                torch.cuda.synchronize()
                out["ms"].append((time.perf_counter() - t0) * 1e3)
                if i == 0:
                    out["peak_over_before"] = torch.cuda.max_memory_allocated() - before
                out["launches"].append({k: fn.launches for k, fn in counters.items()})
                out["band_launches"].append(read_band_counters())
                out["penalty_in_bwd"].append(tuple(inside))
                out["digests"].append(state_digest(model))
                if i == 0:
                    out["losses"] = dict(model.get_current_losses())
                    if parallel.rank() == 0:
                        out["params"] = {n: {k: to_host(p) for k, p in net.named_parameters()}
                                         for n, net in model.nets().items()}
                        out["grads"] = {n: {k: to_host(p.grad) for k, p in
                                            net.named_parameters()}
                                        for n, net in model.nets().items()}
            if requests and len(outs) in requests:
                model.set_input(requests[len(outs)])
                model.test()
                if parallel.rank() == 0:
                    out["request"] = dict(model.get_current_visuals())
                    out["final_params"] = {n: {k: to_host(p) for k, p in
                                               net.named_parameters()}
                                           for n, net in model.nets().items()}
            if saves and len(outs) in saves:
                model.save_networks(saves[len(outs)])
                torch.distributed.barrier()
            outs.append(out)
            del model
    finally:
        networks.cal_gradient_penalty = penalty
    return outs


def _hold_bf16_rule_a(args: list, batch: dict, r0: dict, tag: str = "spatial_recipe",
                      arm: str = "multiscale") -> None:
    """The band bf16 step (rank 0's losses and gradients) against the
    one-process bf16 step from the same state, by test_torch_bf16.py's
    rule (a): with e = max|T_one,bf16 - T_one,fp32| / max|T_one,fp32| (the
    one process's own bf16 error; at least BF16_Q for a tensor of at most
    BF16_FEW elements), max|T_band,bf16 - T_one,bf16| / max|T_one,fp32| <=
    2 e + 1e-6. A gradient 0 in the fp32 step must be 0 in both bf16 steps;
    one that is None (no path to the loss) must be None in all. The biases
    an instance norm follows have a gradient of roundoff (their e is not
    bf16's error): held, as test_torch_bf16.py holds them, within 5% of
    their conv's largest weight gradient."""
    runs, peak = {}, {}
    for name, a in (("bf16", args), ("fp32", [x for x in args if x != "--bf16"])):
        m = train_model(a)
        m.set_input(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        m.optimize_parameters()
        torch.cuda.synchronize()
        peak[name] = (torch.cuda.max_memory_allocated() - before,
                      (time.perf_counter() - t0) * 1e3)
        skip = _zero_grad_biases(m)
        runs[name] = {"losses": {k: torch.tensor(v) for k, v in m.get_current_losses().items()},
                      **{n: {k: None if p.grad is None else p.grad.detach().cpu()
                             for k, p in net.named_parameters()}
                         for n, net in m.nets().items()}}
        del m
    band = {"losses": {k: torch.tensor(v) for k, v in r0["losses"].items()}, **r0["grads"]}
    worst, fails = {}, []
    for n, tensors in runs["fp32"].items():
        for k, t32 in tensors.items():
            t16, tb = runs["bf16"][n][k], band[n][k]
            if t32 is None:
                if t16 is not None or tb is not None:
                    fails.append(f"{n}.{k}: a gradient where the fp32 step has none")
                continue
            if k in skip.get(n, ()):
                w = float(tensors[k.replace(".bias", ".weight")].abs().max())
                if not float(tb.abs().max()) <= 0.05 * w:
                    fails.append(f"{n}.{k}: a roundoff gradient above 5% of its weight's")
                continue
            scale = float(t32.abs().max())
            if scale == 0:
                if bool(t16.any()) or bool(tb.any()):
                    fails.append(f"{n}.{k}: not 0 as in the fp32 step")
                continue
            e = float((t16.double() - t32.double()).abs().max()) / scale
            if t32.numel() <= BF16_FEW:
                e = max(e, BF16_Q)
            a = float((tb.double() - t16.double()).abs().max()) / scale
            ratio = a / (2 * e + 1e-6)
            worst[f"{n}.{k}"] = ratio
            if ratio > 1:
                fails.append(f"{n}.{k}: {a:.3g} > 2 e + 1e-6, e = {e:.3g}")
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:4]
    gib = 2.0**30
    phase(f"{tag}_one_process", arm=arm,
          **{f"{k}_step_peak_over_before_gib": round(v[0] / gib, 3) for k, v in peak.items()},
          **{f"{k}_first_step_ms": round(v[1], 3) for k, v in peak.items()})
    phase(f"{tag}_bf16_rule_a", tensors=len(worst),
          worst_over_limit=json.dumps({k: round(v, 4) for k, v in top}),
          losses_band=json.dumps({k: float(v) for k, v in band["losses"].items()}),
          losses_one_process_bf16=json.dumps({k: float(v) for k, v in
                                               runs["bf16"]["losses"].items()}))
    if fails:
        raise AssertionError(f"{tag}, rule (a): " + "; ".join(fails[:8]))


def run_spatial_recipe(ckpt: str) -> dict:
    """Phase 19b: the registration recipe in bands (SPATIAL_RECIPE) over two
    ranks sharing cuda:0 (gloo): per arm a state saved here from the seed
    with R's heads drawn, then ``_band_steps_rank``; the ranks
    bit-identical after every step, the launches per step and rank
    (SPATIAL_RECIPE_LAUNCHES), the multiscale arm's bf16 step held to rule
    (a) of the one-process bf16 step (``_hold_bf16_rule_a``), the affine
    arm's fp32 step to phase 6's limits of the one-process step
    (``_hold_two_ranks``). -> the bf16 band forms' stage launches of the
    first multiscale step."""
    from nemar_tpu_torch import parallel

    dev = torch.device("cuda", 0)
    cells = []
    for arm, (extra, steps) in SPATIAL_RECIPE.items():
        args = [*_science_args(arm, ckpt), *extra, "--name", f"spatial_recipe_{arm}"]
        m = train_model(args)
        gen = torch.Generator().manual_seed(6)
        with torch.no_grad():
            for h in m.netR.heads():
                h.weight.add_(R_HEAD_DRAW[arm] * torch.randn(h.weight.shape, generator=gen)
                              .to(h.weight.device))
        m.save_networks("recipe")
        batches = _science_batches(m.opt, steps)
        del m
        cells.append(([*args, "--continue_train", "--epoch", "recipe",
                       "--mesh_spatial", str(SPATIAL)], batches))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = parallel.launch(_band_steps_rank, [dev, dev], backend="gloo", args=(cells,),
                            timeout=NCCL_TIMEOUT, pg_timeout=NCCL_TIMEOUT)
    phase("spatial_recipe", seconds=round(time.perf_counter() - t0, 2))
    fails = []
    for c, arm in enumerate(SPATIAL_RECIPE):
        r0, r1 = ranks[0][c], ranks[1][c]
        want, want_band = SPATIAL_RECIPE_LAUNCHES[arm]
        for r in (r0, r1):
            for i, (got, band) in enumerate(zip(r["launches"], r["band_launches"])):
                bad = {k: v for k, v in got.items() if v != want.get(k, 0)}
                bad.update({k: v for k, v in band.items() if tuple(v) != want_band[k]})
                if bad:
                    fails.append(f"{arm} rank {r['rank']} step {i}: launches {bad}")
        same = r0["digests"] == r1["digests"] and r0["losses"] == r1["losses"]
        phase("spatial_recipe_" + arm, steps=len(r0["ms"]), ranks_bit_identical=same,
              step_peak_over_before_gib=json.dumps([round(r["peak_over_before"] / 2.0**30, 3)
                                                    for r in (r0, r1)]),
              ms_per_step_rank0=json.dumps([round(t, 3) for t in r0["ms"]]),
              ms_per_step_rank1=json.dumps([round(t, 3) for t in r1["ms"]]),
              launches_per_step=json.dumps(r0["launches"][0]),
              band_calls_stages_per_step=json.dumps(
                  {k: v for k, v in r0["band_launches"][0].items() if v[0]}),
              losses=json.dumps(r0["losses"]))
        if not same:
            fails.append(f"{arm}: the two ranks' states differ")
    if fails:
        raise AssertionError("phase 19b: " + "; ".join(fails))
    # the one-process runs: each cell's args without the trailing
    # --mesh_spatial
    (args_ms, batches_ms), (args_af, batches_af) = cells
    _hold_bf16_rule_a(args_ms[:-2], batches_ms[0], ranks[0][0])
    # from a state saved before any step: Adam's first step (each net's own
    # lr, R's at --stn_lr)
    _hold_two_ranks("recipe_affine", args_af[:-2], batches_af[0], [r[1] for r in ranks], ("A",),
                    adam_t=1)
    return {k: v[1] for k, v in ranks[0][0]["band_launches"][0].items()}


def check_band_double_bwd() -> dict:
    """Phase 19c's ``[spatial_kernels]``, in a rank of the spatial group: K-in's
    band double backward (the WGAN-GP penalty's, through D's band form) at
    D's three instance norms of the penalty's pass over the mix at 256^2 b8
    (D_IN_SHAPES, one sample a pair: bands of 32, 16 and 16 / 15 rows),
    leaky_relu, each rank its band of one seeded frame: d x by K-in-bwd's
    band stages (through the Function the penalty differentiates), then the
    VJP of (x, g) -> d x (stock ops with the frame's sums through the
    differentiable all-gather), against the same two derivatives of the
    plain band form and of the whole-frame plain function by autograd, cut
    to the band, on the card: within 1e-4 of the largest value, bit for bit
    in two calls, the band forms' launches of one call asserted (K-in's
    partials and apply once, K-in-bwd's once), and the time of the band
    form and of the plain band form."""
    from nemar_tpu_torch import parallel
    from nemar_tpu_torch.ops import norm
    from nemar_tpu_torch.parallel import spatial

    j = parallel.spatial_rank()
    rng = card_rng(43)
    out = {}
    # D's bands: its k4 convs' from the 256-row frame's (Band.conv), the
    # normed ones after Conv_0
    bands, b = {}, spatial.Band.split(256, SPATIAL, j)
    for stride in (2, 2, 2, 1):
        b = b.conv(4, stride, 1)[0]
        bands.setdefault(b.height, b)
    for c, h, w in D_IN_SHAPES:
        band = bands[h]
        frames = [randn(rng, (TRAIN_BATCH, h, w, c), 2.0) + 0.5, randn(rng, (TRAIN_BATCH, h, w, c)),
                  randn(rng, (TRAIN_BATCH, h, w, c))]

        def second_order(fn, rows):
            def call():
                x, g, gg = (f[:, rows] for f in frames)
                xr, gr = x.clone().requires_grad_(), g.clone().requires_grad_()
                (dx,) = torch.autograd.grad(fn(xr), xr, gr, create_graph=True)
                got = (dx.detach(), *torch.autograd.grad(dx, (xr, gr), gg))
                torch.cuda.synchronize()
                return got
            return call

        rows = slice(band.r0, band.r1)
        kern = second_order(lambda x: norm.instance_norm_act_band(x, band, "leaky_relu"), rows)
        plain = second_order(lambda x: norm.instance_norm_act_band(x, band, "leaky_relu",
                                                                   plain=True), rows)
        frame = second_order(lambda x: norm.instance_norm_act_plain(x, "leaky_relu"),
                             slice(None))
        zero_band_counters()
        got = kern()
        launches = {k: v for k, v in read_band_counters().items() if v[0]}
        again, ref, whole = kern(), plain(), frame()
        errs = [max_rel_err([p], [q]) for p, q in zip(got, ref)]
        frame_errs = [max_rel_err([p], [q[:, rows]]) for p, q in zip(got, whole)]
        ms, pms = paired_median_ms(kern, plain, iters=5, warmup=1)
        out[f"K-in-bwd-band double backward (D, {h} rows)"] = {
            "band": f"{TRAIN_BATCH}x{band.rows}x{w}x{c}", "act": "leaky_relu",
            "max_rel_err_dx_ddx_dg": errs, "vs_frame_max_rel_err_dx_ddx_dg": frame_errs,
            "tol": 1e-4, "bits": all(torch.equal(p, q) for p, q in zip(got, again)),
            "launches": launches, "ms": ms, "plain_ms": pms}
    return out


def _spatial_flags_rank(cells: list) -> dict:
    """Phase 19c inside its rank: ``_band_steps_rank`` on the cells (which
    lays out the mesh), then ``check_band_double_bwd``."""
    from nemar_tpu_torch import parallel

    cells = _band_steps_rank(cells)
    return {"kernels": check_band_double_bwd(), "rank": parallel.rank(), "cells": cells}


def _one_process_peak(args: list, batch: dict) -> tuple:
    """(peak allocated memory over what was allocated before the step, ms)
    of one step in this process from the args' saved state."""
    m = train_model(args)
    m.set_input(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    m.optimize_parameters()
    torch.cuda.synchronize()
    out = (torch.cuda.max_memory_allocated() - before, (time.perf_counter() - t0) * 1e3)
    del m
    return out


def run_spatial_flags(ckpt: str) -> None:
    """Phase 19c: NeMAR's step flags in bands (SPATIAL_FLAGS) over two ranks
    sharing cuda:0 (gloo): ``_spatial_flags_rank``; K-in's band double
    backward held (``check_band_double_bwd``); the ranks bit-identical
    after every step; the wgangp step under --remat bit for bit the step
    without it; the launches per step and rank (SPATIAL_FLAG_LAUNCHES, and
    K-in-bwd's band stages inside the penalty, SPATIAL_PENALTY_IN_BWD);
    each cell's first step within phase 6's limits of the one-process step
    on the card (``_hold_two_ranks``); ms a step and rank, and each rank's
    peak memory over its first step beside one process's, with and without
    --remat."""
    from nemar_tpu_torch import parallel

    dev = torch.device("cuda", 0)
    shared = [*TRAIN_ARGS, "--checkpoints_dir", ckpt, "--continue_train", "--epoch", "smoke6",
              "--gpu_ids", "0", "--batch_size", str(TRAIN_BATCH)]
    batches = request_batches(SPATIAL_FLAG_STEPS, TRAIN_BATCH, seed=37)
    cells = {}
    for name, (flags, steps) in SPATIAL_FLAGS.items():
        if "--netG" not in flags:
            cells[name] = ([*shared, *flags], batches[:steps])
            continue
        # phase 6's G has 6 blocks: a state of this G from the seed
        args = [*TRAIN_ARGS, "--checkpoints_dir", ckpt, "--gpu_ids", "0", "--batch_size",
                str(TRAIN_BATCH), *flags, "--name", f"spatial_flags_{name}"]
        m = train_model(args)
        gen = torch.Generator().manual_seed(7)
        with torch.no_grad():
            for h in m.netR.heads():
                h.weight.add_(R_HEAD_DRAW["multiscale"] * torch.randn(
                    h.weight.shape, generator=gen).to(h.weight.device))
        m.save_networks("flags")
        del m
        cells[name] = ([*args, "--continue_train", "--epoch", "flags"], batches[:steps])
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = parallel.launch(
        _spatial_flags_rank, [dev, dev], backend="gloo",
        args=([([*a, "--mesh_spatial", str(SPATIAL)], b) for a, b in cells.values()],),
        timeout=NCCL_TIMEOUT, pg_timeout=NCCL_TIMEOUT)
    phase("spatial_flags", seconds=round(time.perf_counter() - t0, 2))
    fails = []
    for r in ranks:
        for name, c in r["kernels"].items():
            phase("spatial_kernels", rank=r["rank"], kernel=repr(name), **c)
            if not (max(c["max_rel_err_dx_ddx_dg"]) <= c["tol"]
                    and max(c["vs_frame_max_rel_err_dx_ddx_dg"]) <= c["tol"] and c["bits"]
                    and c["launches"] == {"K-in": (1, 2), "K-in-bwd": (1, 2)}):
                fails.append(f"rank {r['rank']} {name}: {c}")
    gib = 2.0**30
    for c, name in enumerate(cells):
        r0, r1 = ranks[0]["cells"][c], ranks[1]["cells"][c]
        want, want_band = SPATIAL_FLAG_LAUNCHES[name]
        for rank, r in enumerate((r0, r1)):
            for i, (got, band, gp) in enumerate(zip(r["launches"], r["band_launches"],
                                                    r["penalty_in_bwd"])):
                bad = {k: v for k, v in got.items() if v != want.get(k, 0)}
                bad.update({k: v for k, v in band.items() if tuple(v) != want_band[k]})
                if gp != (SPATIAL_PENALTY_IN_BWD if "wgangp" in name else (0, 0)):
                    bad["K-in-bwd inside the penalty"] = gp
                if bad:
                    fails.append(f"{name} rank {rank} step {i}: launches {bad}")
        same = r0["digests"] == r1["digests"] and r0["losses"] == r1["losses"]
        one_peak, one_ms = _one_process_peak(cells[name][0], cells[name][1][0])
        phase("spatial_flags_" + name, steps=len(r0["ms"]), ranks_bit_identical=same,
              step_peak_over_before_gib=json.dumps([round(r["peak_over_before"] / gib, 3)
                                                    for r in (r0, r1)]),
              one_process_step_peak_over_before_gib=round(one_peak / gib, 3),
              one_process_first_step_ms=round(one_ms, 3),
              ms_per_step_rank0=json.dumps([round(t, 3) for t in r0["ms"]]),
              ms_per_step_rank1=json.dumps([round(t, 3) for t in r1["ms"]]),
              launches_per_step=json.dumps({k: v for k, v in r0["launches"][0].items() if v}),
              band_calls_stages_per_step=json.dumps(
                  {k: v for k, v in r0["band_launches"][0].items() if v[0]}),
              in_bwd_calls_stages_inside_penalty=json.dumps(r0["penalty_in_bwd"][0]),
              losses=json.dumps(r0["losses"]))
        if not same:
            fails.append(f"{name}: the two ranks' states differ")
    names = list(cells)
    remat, plain = (ranks[0]["cells"][names.index(n)] for n in ("wgangp_remat", "wgangp"))
    remat_bits = remat["digests"] == plain["digests"] and remat["losses"] == plain["losses"]
    phase("spatial_flags_remat", steps=len(remat["digests"]), bit_identical=remat_bits)
    if not remat_bits:
        fails.append("wgangp under --remat differs from the band step without it")
    if fails:
        raise AssertionError("phase 19c: " + "; ".join(fails))
    for c, name in enumerate(cells):
        if name == "wgangp":  # bit for bit the --remat cell, held above
            continue
        args, steps = cells[name]
        _hold_two_ranks("flags_" + name, args, steps[0], [r["cells"][c] for r in ranks], ("A",),
                        adam_t=1 if "--netG" in SPATIAL_FLAGS[name][0] else None,
                        g_gan_via_d="wgangp" in name)


def _spatial_geometry_rank(cells: list, request: dict) -> dict:
    """Phase 19d inside its rank: ``check_band_kernels(geometry=True)``, then
    ``_band_steps_rank`` on the cells, the first answering ``request``."""
    from nemar_tpu_torch import parallel

    fp32_only()
    parallel.set_mesh(SPATIAL)
    kernels = check_band_kernels(geometry=True)
    return {"kernels": kernels, "rank": parallel.rank(),
            "cells": _band_steps_rank(cells, {0: request})}


def _geometry_case_launches(name: str) -> dict:
    """The band-form calls and stages (and K-head's launches) of one call,
    forward and backward, of a 19d ``[spatial_kernels]`` case."""
    tag = "-bf16" if "-bf16" in name else ""
    if name.startswith("K-in"):
        return {"K-in" + tag: (1, 2), "K-in-bwd" + tag: (1, 2)}
    if name.startswith("K-block"):
        return {"K-block" + tag: (1, 4), "K-block-bwd" + tag: (1, 5)}
    if name.startswith("K-convt"):
        return {"K-convt" + tag: (1, 2), "K-convt-bwd" + tag: (1, 3)}
    return {"K-head": 1, "K-head-bwd": 1}


def run_spatial_geometry(ckpt: str) -> None:
    """Phase 19d: the band geometry of the JAX package's spatial mesh
    (SPATIAL_GEOMETRY) over two ranks sharing cuda:0 (gloo): per cell a
    state saved here from the seed with R's head drawn, then
    ``_spatial_geometry_rank``; the band forms at uneven, one-row and empty
    bands held against their plain band forms (``[spatial_kernels]``); the
    ranks bit-identical after every step; the launches per step and rank
    (``geometry_launches``); each cell's first step within phase 6's limits
    of the one-process step (``_hold_two_ranks``); the b1 request of cell
    (a), answered in bands after its steps, within the inference limit
    (1e-3) of the one-process request from the same parameters; ms a step
    and rank, and each rank's peak memory over its first step beside one
    process's."""
    from nemar_tpu_torch import parallel

    dev = torch.device("cuda", 0)
    cells = []
    for name, (flags, size, _) in SPATIAL_GEOMETRY.items():
        args = [*TRAIN_ARGS, "--checkpoints_dir", ckpt, "--gpu_ids", "0", "--batch_size",
                str(TRAIN_BATCH), *flags, "--name", f"spatial_geometry_{name}"]
        m = train_model(args)
        gen = torch.Generator().manual_seed(8)
        with torch.no_grad():
            for h in m.netR.heads():
                h.weight.add_(R_HEAD_DRAW["multiscale"] * torch.randn(
                    h.weight.shape, generator=gen).to(h.weight.device))
        m.save_networks("geometry")
        del m
        cells.append(([*args, "--continue_train", "--epoch", "geometry"],
                      request_batches(SPATIAL_GEOMETRY_STEPS, TRAIN_BATCH, seed=47, size=size)))
    request = request_batches(1, 1, seed=53, size=SPATIAL_GEOMETRY["224_pyramid_5"][1])[0]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = parallel.launch(
        _spatial_geometry_rank, [dev, dev], backend="gloo",
        args=([([*a, "--mesh_spatial", str(SPATIAL)], b) for a, b in cells], request),
        timeout=NCCL_TIMEOUT, pg_timeout=NCCL_TIMEOUT)
    phase("spatial_geometry", seconds=round(time.perf_counter() - t0, 2))
    fails = []
    for r in ranks:
        for name, c in r["kernels"].items():
            phase("spatial_kernels", rank=r["rank"], kernel=repr(name), **c)
            want = _geometry_case_launches(name)
            if not (c["fwd_err"] <= c["tol"] and c["bwd_err"] <= c["tol_bwd"]
                    and c["fp32_err"] <= c["tol_fp32"] and c["bits"] and c["launches"] == want):
                fails.append(f"rank {r['rank']} {name}: {c} (launches wanted {want})")
    gib = 2.0**30
    for c, (name, (_, _, depth)) in enumerate(SPATIAL_GEOMETRY.items()):
        r0, r1 = ranks[0]["cells"][c], ranks[1]["cells"][c]
        want, want_band = geometry_launches(depth)
        for rank, r in enumerate((r0, r1)):
            for i, (got, band) in enumerate(zip(r["launches"], r["band_launches"])):
                bad = {k: v for k, v in got.items() if v != want.get(k, 0)}
                bad.update({k: v for k, v in band.items() if tuple(v) != want_band[k]})
                if bad:
                    fails.append(f"{name} rank {rank} step {i}: launches {bad}")
        same = r0["digests"] == r1["digests"] and r0["losses"] == r1["losses"]
        one_peak, one_ms = _one_process_peak(cells[c][0], cells[c][1][0])
        phase("spatial_geometry_" + name, steps=len(r0["ms"]), ranks_bit_identical=same,
              step_peak_over_before_gib=json.dumps([round(r["peak_over_before"] / gib, 3)
                                                    for r in (r0, r1)]),
              one_process_step_peak_over_before_gib=round(one_peak / gib, 3),
              one_process_first_step_ms=round(one_ms, 3),
              ms_per_step_rank0=json.dumps([round(t, 3) for t in r0["ms"]]),
              ms_per_step_rank1=json.dumps([round(t, 3) for t in r1["ms"]]),
              launches_per_step=json.dumps({k: v for k, v in r0["launches"][0].items() if v}),
              band_calls_stages_per_step=json.dumps(
                  {k: v for k, v in r0["band_launches"][0].items() if v[0]}),
              losses=json.dumps(r0["losses"]))
        if not same:
            fails.append(f"{name}: the two ranks' states differ")
    # the request: the ranks' gathered visuals against one process's from
    # the parameters the ranks hold after their steps
    r0 = ranks[0]["cells"][0]
    m = train_model(cells[0][0])
    with torch.no_grad():
        for n, net in m.nets().items():
            for k, p in net.named_parameters():
                p.copy_(r0["final_params"][n][k])
    m.set_input(request)
    m.test()
    want = m.get_current_visuals()
    del m
    req_err = max(float(np.abs(r0["request"][k] - want[k]).max()) for k in want)
    phase("spatial_geometry_request", size=SPATIAL_GEOMETRY["224_pyramid_5"][1],
          max_abs_err=req_err, tol=1e-3)
    if not req_err <= 1e-3:
        fails.append(f"the b1 request: {req_err}")
    if fails:
        raise AssertionError("phase 19d: " + "; ".join(fails))
    for c, name in enumerate(SPATIAL_GEOMETRY):
        args, steps = cells[c]
        _hold_two_ranks("geometry_" + name, args, steps[0], [r["cells"][c] for r in ranks],
                        ("A",), adam_t=1)


def _spatial_templates_rank(cells: list, serve: list, request: dict) -> dict:
    """Phase 19e inside its rank: ``check_band_kernels(templates=True)``;
    ``_band_steps_rank`` on the cells, the cycle_gan cell saved after its
    steps as ``templates_steps``; then the test model of ``serve`` (as
    test.py parses it) answering ``request`` in bands, its launches
    counted: rank 0 returns its visuals."""
    from nemar_tpu_torch import parallel
    from nemar_tpu_torch.models import create_model
    from nemar_tpu_torch.options import TestOptions

    fp32_only()
    parallel.set_mesh(SPATIAL)
    out = {"kernels": check_band_kernels(templates=True), "rank": parallel.rank(),
           "cells": _band_steps_rank(cells, saves={list(SPATIAL_TEMPLATES).index("cycle_gan"):
                                                   "templates_steps"})}
    opt = TestOptions().parse(serve)
    model = create_model(opt)
    model.setup(opt)
    counters, _ = zero_all_counters()
    zero_band_counters()
    model.set_input(request)
    model.test()
    torch.cuda.synchronize()
    out["request_launches"] = {k: fn.launches for k, fn in counters.items()}
    out["request_band_launches"] = read_band_counters()
    if parallel.rank() == 0:
        out["request"] = dict(model.get_current_visuals())
    return out


def _template_skip(model) -> dict:
    """Per net, the biases of zero gradient up to roundoff of a phase 19e
    cell (``step_against_cpu``'s ``skip``): NeMAR's ``_zero_grad_biases``;
    else a norm follows each but the ResNet head's, the UNet's first and
    innermost convolutions' and its outermost transposed one's, and D's
    first and last ones'."""
    if hasattr(model, "netR"):
        return _zero_grad_biases(model)

    def skip(net):
        if hasattr(net, "num_downs"):
            return _unet_norm_biases(net)
        if hasattr(net, "n_layers"):
            return {f"Conv_{i}.bias" for i in range(1, net.n_layers + 1)}
        head = f"Conv_{1 + net.n_downsampling}.bias"
        return {k for k in net.state_dict() if k.endswith(".bias") and k != head}

    return {n: skip(net) for n, net in model.nets().items()}


def run_spatial_templates(ckpt: str) -> None:
    """Phase 19e: the template models in bands (SPATIAL_TEMPLATES) over two
    ranks sharing cuda:0 (gloo): per cell a state saved here (from the
    seed; NeMAR's G and R phase 6's), then ``_spatial_templates_rank``; the
    band forms at cycle_gan's b1 band shapes held against their plain band
    forms, bit for bit twice (``[spatial_kernels]``); the ranks
    bit-identical after every step; the launches per step and rank
    (SPATIAL_TEMPLATE_LAUNCHES); each cell's first step within phase 6's
    limits of the one-process step (``_hold_two_ranks``); the test model's
    request in bands within the inference limit (1e-3) of the one-process
    request from the same checkpoint; ms a step and rank, and each rank's
    peak memory over its first step beside one process's."""
    from nemar_tpu_torch import parallel
    from nemar_tpu_torch.models import create_model
    from nemar_tpu_torch.options import TestOptions

    dev = torch.device("cuda", 0)
    cells = []
    for name, (flags, batch, steps) in SPATIAL_TEMPLATES.items():
        args = [*flags, "--checkpoints_dir", ckpt, "--gpu_ids", "0", "--batch_size", str(batch),
                "--name", f"spatial_templates_{name}"]
        m = train_model(args)
        if name == "nemar_batch_pixel":  # G and R phase 6's, D from the seed
            for n in "GR":
                m.nets()[n].load_state_dict(torch.load(
                    os.path.join(ckpt, "smoke_train", f"smoke6_net_{n}.pth"), map_location=dev,
                    weights_only=True))
        m.save_networks("templates")
        del m
        pairs = (request_batches(steps, batch, seed=59) if name.startswith("nemar")
                 else pair_batches(steps, batch, seed=59))
        cells.append(([*args, "--continue_train", "--epoch", "templates"], pairs))
    serve = ["--model", "test", "--model_suffix", "_A", "--no_dropout", "--dataset_mode",
             "synthetic", "--gpu_ids", "0", "--checkpoints_dir", ckpt, "--name",
             "spatial_templates_cycle_gan", "--epoch", "templates_steps", "--crop_size", "256",
             "--load_size", "256", "--input_nc", "3", "--output_nc", "3", "--ngf", "64",
             "--netG", "resnet_9blocks"]
    request = pair_batches(1, 1, seed=61)[0]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = parallel.launch(
        _spatial_templates_rank, [dev, dev], backend="gloo",
        args=([([*a, "--mesh_spatial", str(SPATIAL)], b) for a, b in cells],
              [*serve, "--mesh_spatial", str(SPATIAL)], request),
        timeout=NCCL_TIMEOUT, pg_timeout=NCCL_TIMEOUT)
    phase("spatial_templates", seconds=round(time.perf_counter() - t0, 2))
    fails = []
    for r in ranks:
        for name, c in r["kernels"].items():
            phase("spatial_kernels", rank=r["rank"], kernel=repr(name), **c)
            want = _geometry_case_launches(name)
            if not (c["fwd_err"] <= c["tol"] and c["bwd_err"] <= c["tol_bwd"] and c["bits"]
                    and c["launches"] == want):
                fails.append(f"rank {r['rank']} {name}: {c} (launches wanted {want})")
    gib = 2.0**30

    def bad_launches(got, band, name):
        want, want_band = SPATIAL_TEMPLATE_LAUNCHES[name]
        bad = {k: v for k, v in got.items() if v != want.get(k, 0)}
        bad.update({k: v for k, v in band.items() if tuple(v) != want_band[k]})
        return bad

    for c, name in enumerate(SPATIAL_TEMPLATES):
        r0, r1 = ranks[0]["cells"][c], ranks[1]["cells"][c]
        for rank, r in enumerate((r0, r1)):
            for i, (got, band) in enumerate(zip(r["launches"], r["band_launches"])):
                bad = bad_launches(got, band, name)
                if bad:
                    fails.append(f"{name} rank {rank} step {i}: launches {bad}")
        same = r0["digests"] == r1["digests"] and r0["losses"] == r1["losses"]
        one_peak, one_ms = _one_process_peak(cells[c][0], cells[c][1][0])
        phase("spatial_templates_" + name, steps=len(r0["ms"]), ranks_bit_identical=same,
              step_peak_over_before_gib=json.dumps([round(r["peak_over_before"] / gib, 3)
                                                    for r in (r0, r1)]),
              one_process_step_peak_over_before_gib=round(one_peak / gib, 3),
              one_process_first_step_ms=round(one_ms, 3),
              ms_per_step_rank0=json.dumps([round(t, 3) for t in r0["ms"]]),
              ms_per_step_rank1=json.dumps([round(t, 3) for t in r1["ms"]]),
              launches_per_step=json.dumps({k: v for k, v in r0["launches"][0].items() if v}),
              band_calls_stages_per_step=json.dumps(
                  {k: v for k, v in r0["band_launches"][0].items() if v[0]}),
              losses=json.dumps(r0["losses"]))
        if not same or not all(np.isfinite(v) for v in r0["losses"].values()):
            fails.append(f"{name}: the two ranks' states differ, or a loss is not finite")
    # the request: the ranks' gathered visuals against one process's from
    # the same checkpoint
    for r in ranks:
        bad = bad_launches(r["request_launches"], r["request_band_launches"], "request")
        if bad:
            fails.append(f"the request at rank {r['rank']}: launches {bad}")
    opt = TestOptions().parse(serve)
    m = create_model(opt)
    m.setup(opt)
    m.set_input(request)
    m.test()
    want = m.get_current_visuals()
    del m
    got = ranks[0]["request"]
    req_err = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    phase("spatial_templates_request", batch=1, max_abs_err=req_err, tol=1e-3,
          finite=bool(np.all(np.isfinite(got["fake"]))),
          launches=json.dumps({k: v for k, v in ranks[0]["request_launches"].items() if v}),
          band_calls_stages=json.dumps({k: v for k, v in
                                        ranks[0]["request_band_launches"].items() if v[0]}))
    if not (req_err <= 1e-3 and list(got) == list(want) == ["real", "fake"]):
        fails.append(f"the request: {req_err}")
    if fails:
        raise AssertionError("phase 19e: " + "; ".join(fails))
    for c, name in enumerate(SPATIAL_TEMPLATES):
        args, steps = cells[c]
        host = train_model(args)
        nets = {n: o for n, o in (("G", "G"), ("D", "D"), ("R", "R"), ("G_A", "G"), ("G_B", "G"),
                                  ("D_A", "D"), ("D_B", "D")) if n in host.nets()}
        skip = _template_skip(host)
        del host
        _hold_two_ranks("templates_" + name, args, steps[0], [r["cells"][c] for r in ranks],
                        ("A",) if name.startswith("nemar") else ("A", "B"), nets=nets,
                        skip=skip, adam_t=1)



def _chunk_digests(model) -> tuple:
    """SHA-256s over ``_chunk_state`` (parameters, Adam's state, the pool,
    the step generator's state): (with this rank's band of the pool, with
    its frames gathered from the spatial group, the same on every rank)."""
    import hashlib

    from nemar_tpu_torch.parallel import spatial

    state = _chunk_state(model)
    frames = spatial.gather_frame(model.pool[0], model.band_of(model.opt.crop_size)).cpu()
    out = []
    for images in (state["pool.images"], frames):
        h = hashlib.sha256()
        for k, v in sorted({**state, "pool.images": images}.items()):
            h.update(k.encode())
            h.update(v.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
        out.append(h.hexdigest())
    return tuple(out)


def _spatial_chunk_rank(cells: list) -> list:
    """Phase 19f inside its rank: per (args, batches) a model from the
    args' saved state (its pool full) runs the batches as one chunk
    (``optimize_parameters_scan_eager``), a second one as band
    ``optimize_parameters`` calls, and a third as the chunk again (the
    chunk twice); the counters zeroed and the peak memory reset before
    each. -> per cell and run the ms a step, the
    launches (``zero_all_counters``), the band forms' calls and stages, the
    peak over what was allocated before, the state's digests
    (``_chunk_digests``) and the band losses' means; the chunk's global
    mean losses and, at rank 0, its parameters; the steps' first step as
    ``_hold_two_ranks`` reads it (its global losses, each step's ms and
    ``state_digest``; at rank 0 the parameters and gradients after it);
    and what ``optimize_parameters_scan`` (the graph) raises in the gloo
    group."""
    from nemar_tpu_torch import parallel
    from nemar_tpu_torch.models.base_model import state_digest, to_host

    fp32_only()
    parallel.set_mesh(SPATIAL)
    lead = parallel.rank() == 0
    outs = []
    for args, batches in cells:
        cell = {"rank": parallel.rank()}
        for run in ("chunk", "steps", "again"):
            model = train_model(args)
            counters, _ = zero_all_counters()
            zero_band_counters()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            out = {"ms": [], "digests": []}
            t0 = time.perf_counter()
            if run != "steps":
                model.optimize_parameters_scan_eager(batches)
                means = model._losses
            else:
                sums = None
                for i, b in enumerate(batches):
                    t1 = time.perf_counter()
                    model.set_input(b)
                    model.optimize_parameters()
                    torch.cuda.synchronize()
                    out["ms"].append((time.perf_counter() - t1) * 1e3)
                    out["digests"].append(state_digest(model))
                    sums = (model._losses if sums is None
                            else {k: sums[k] + v for k, v in model._losses.items()})
                    if i == 0:  # the first step, for _hold_two_ranks
                        out["losses"] = dict(model.get_current_losses())
                        if lead:
                            out["params"] = {n: {k: to_host(p) for k, p in
                                                 net.named_parameters()}
                                             for n, net in model.nets().items()}
                            out["grads"] = {n: {k: to_host(p.grad) for k, p in
                                                net.named_parameters()}
                                            for n, net in model.nets().items()}
                means = {k: v / len(batches) for k, v in sums.items()}
            torch.cuda.synchronize()
            band, frames = _chunk_digests(model)
            out.update(ms_per_step=(time.perf_counter() - t0) * 1e3 / len(batches),
                       peak_over_before=torch.cuda.max_memory_allocated() - before,
                       launches={k: fn.launches for k, fn in counters.items()},
                       band_launches=read_band_counters(), digest=band, frames_digest=frames,
                       band_losses={k: float(v) for k, v in means.items()})
            if run == "chunk":
                out["losses"] = dict(model.get_current_losses())
                if lead:
                    out["params"] = {n: {k: to_host(p) for k, p in net.named_parameters()}
                                     for n, net in model.nets().items()}
                try:  # the graph, refused in a gloo group before any step
                    model.optimize_parameters_scan(batches)
                    cell["refusal"] = None
                except NotImplementedError as e:
                    cell["refusal"] = str(e)
            cell[run] = out
            del model
        outs.append(cell)
    return outs


def _one_process_chunk(args: list, batches: list) -> tuple:
    """One process's chunk of ``batches`` on the step graph
    (``optimize_parameters_scan``: its replays) from the args' saved state:
    (the model, ms a step, the peak memory over what was allocated before
    the chunk)."""
    m = train_model(args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    m.optimize_parameters_scan(batches)
    torch.cuda.synchronize()
    assert all(g.graph is not None for g in m._step_graphs.values())
    return (m, (time.perf_counter() - t0) * 1e3 / len(batches),
            torch.cuda.max_memory_allocated() - before)


def run_spatial_chunks(ckpt: str) -> None:
    """Phase 19f: --steps_per_execution in bands over two ranks sharing
    cuda:0 (gloo), fp32 and --bf16 (SPATIAL_CHUNK_CELLS), from a state saved
    here with the pool full: ``_spatial_chunk_rank``. Held: the band chunk
    equal bit for bit to as many band steps fed the same draws (state,
    band losses), on both ranks; the two ranks bit-identical; the chunk
    run twice bit-identical; the band forms' calls and stages and the kernels'
    launches over the chunk those of the band steps (fp32: SPATIAL_CHUNK x
    phase 19c's wgangp step); ``optimize_parameters_scan`` refused in the
    gloo group by StepGraph's own refusal; the chunk's first step (the band
    steps' first, which the chunk equals) within phase 6's limits of one
    process's step on the card (fp32: ``_hold_two_ranks``, G_GAN read
    through D as phase 19c holds wgangp; bf16: ``_hold_bf16_rule_a``); and
    the chunk against one process's chunk of the same batches on the step
    graph: every parameter within the chunk's Adam bound (each run moves
    an element by at most the sum of Adam's bounds over its steps), the
    losses finite, their relative differences printed (four steps of
    wgangp from a fresh Adam amplify roundoff to ~1e-3: PERF.md, PR 23).
    Printed: ms a step and rank, and each rank's peak over the chunk
    beside one process's chunk."""
    from nemar_tpu_torch import parallel

    dev = torch.device("cuda", 0)
    base = [*TRAIN_ARGS, *SPATIAL_CHUNK_FLAGS, "--checkpoints_dir", ckpt, "--gpu_ids", "0",
            "--batch_size", str(TRAIN_BATCH), "--name", "spatial_chunks"]
    m = train_model(base)
    gen = torch.Generator().manual_seed(73)
    with torch.no_grad():
        for h in m.netR.heads():
            h.weight.add_(R_HEAD_DRAW["multiscale"] * torch.randn(
                h.weight.shape, generator=gen).to(h.weight.device))
    # the pool full of 50 smooth images, as the batches are (its steps swap)
    m.pool[0].copy_(torch.from_numpy(np.ascontiguousarray(
        smooth_images(np.random.default_rng(71), 50, 3).transpose(0, 3, 1, 2))))
    m.pool[1].fill_(50)
    m.save_networks("chunks")
    del m
    batches = request_batches(SPATIAL_CHUNK, TRAIN_BATCH, seed=67)
    cells = {name: [*base, *flags, "--continue_train", "--epoch", "chunks"]
             for name, flags in SPATIAL_CHUNK_CELLS.items()}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = parallel.launch(
        _spatial_chunk_rank, [dev, dev], backend="gloo",
        args=([([*a, "--mesh_spatial", str(SPATIAL)], batches) for a in cells.values()],),
        timeout=NCCL_TIMEOUT, pg_timeout=NCCL_TIMEOUT)
    phase("spatial_chunks", seconds=round(time.perf_counter() - t0, 2))
    fails = []
    gib = 2.0**30
    want_fp32 = {k: SPATIAL_CHUNK * v for k, v in SPATIAL_FLAG_LAUNCHES["wgangp"][0].items()}
    want_band_fp32 = {k: tuple(SPATIAL_CHUNK * x for x in v)
                      for k, v in SPATIAL_FLAG_LAUNCHES["wgangp"][1].items()}
    for c, name in enumerate(cells):
        r0, r1 = ranks[0][c], ranks[1][c]
        for r in (r0, r1):
            chunk, steps = r["chunk"], r["steps"]
            if chunk["digest"] != steps["digest"] or chunk["band_losses"] != steps["band_losses"]:
                fails.append(f"{name} rank {r['rank']}: the chunk differs from the band steps")
            if chunk["launches"] != steps["launches"] or \
                    chunk["band_launches"] != steps["band_launches"]:
                fails.append(f"{name} rank {r['rank']}: launches {chunk['launches']} "
                             f"{chunk['band_launches']} against the steps' {steps['launches']} "
                             f"{steps['band_launches']}")
            if name == "fp32":
                bad = {k: v for k, v in chunk["launches"].items() if v != want_fp32.get(k, 0)}
                bad.update({k: v for k, v in chunk["band_launches"].items()
                            if tuple(v) != want_band_fp32[k]})
                if bad:
                    fails.append(f"{name} rank {r['rank']}: launches over the chunk {bad}")
            if not (r["refusal"] and GLOO_GRAPH_REFUSAL in r["refusal"]):
                fails.append(f"{name} rank {r['rank']}: the graph in a gloo group: "
                             f"{r['refusal']!r}")
        same = (r0["chunk"]["frames_digest"] == r1["chunk"]["frames_digest"]
                and r0["chunk"]["losses"] == r1["chunk"]["losses"])
        twice = all(r["again"]["digest"] == r["chunk"]["digest"] for r in (r0, r1))
        # the chunk against one process's on the step graph
        one, one_ms, one_peak = _one_process_chunk(cells[name], batches)
        lc = dict(one.get_current_losses())
        loss_rel = {k: abs(r0["chunk"]["losses"][k] - v) / max(abs(v), 1e-12)
                    for k, v in lc.items()}
        # each run moves an element by at most lr x Adam's bound at each step
        over = 0.0
        for n, net in one.nets().items():
            group = one.optimizers[n].param_groups[0]
            bound = float(group["lr"]) * sum(adam_bound(t, group["betas"][0])
                                             for t in range(1, SPATIAL_CHUNK + 1)) * (1 + 1e-3)
            err = max(float((p.detach().cpu() - r0["chunk"]["params"][n][k]).abs().max())
                      for k, p in net.named_parameters())
            over = max(over, err / (2 * bound))
        del one
        torch.cuda.empty_cache()
        phase("spatial_chunks_" + name, chunk=SPATIAL_CHUNK, ranks_bit_identical=same,
              twice_bit_identical=twice,
              chunk_equals_band_steps=r0["chunk"]["digest"] == r0["steps"]["digest"],
              ms_per_step_rank0=round(r0["chunk"]["ms_per_step"], 3),
              ms_per_step_rank1=round(r1["chunk"]["ms_per_step"], 3),
              band_steps_ms_per_step_rank0=round(r0["steps"]["ms_per_step"], 3),
              one_process_graph_ms_per_step=round(one_ms, 3),
              chunk_peak_over_before_gib=json.dumps(
                  [round(r["chunk"]["peak_over_before"] / gib, 3) for r in (r0, r1)]),
              one_process_chunk_peak_over_before_gib=round(one_peak / gib, 3),
              launches_over_chunk=json.dumps({k: v for k, v in r0["chunk"]["launches"].items()
                                              if v}),
              band_calls_stages_over_chunk=json.dumps(
                  {k: v for k, v in r0["chunk"]["band_launches"].items() if v[0]}),
              refusal=json.dumps(r0["refusal"]), losses=json.dumps(r0["chunk"]["losses"]),
              vs_graph_loss_rel_err=json.dumps(loss_rel),
              vs_graph_params_max_err_over_adam_bound=over)
        if not same:
            fails.append(f"{name}: the two ranks' states differ")
        if not twice:
            fails.append(f"{name}: the chunk run twice differs")
        if not (over <= 1 and all(np.isfinite(v) for v in r0["chunk"]["losses"].values())):
            fails.append(f"{name} against one process's graph: params at {over} of the Adam "
                         f"bound, losses {r0['chunk']['losses']}")
    if fails:
        raise AssertionError("phase 19f: " + "; ".join(fails))
    # the chunk's first step (the band steps' first) against one process's
    _hold_two_ranks("chunks_fp32", cells["fp32"], batches[0],
                    [ranks[0][0]["steps"], ranks[1][0]["steps"]], ("A",), g_gan_via_d=True)
    _hold_bf16_rule_a(cells["bf16"], batches[0], ranks[0][1]["steps"], tag="spatial_chunks",
                      arm="bf16 chunk's first step")

# ---------------------------------------------------------------------------
# phase 20: --loader grain (worker processes) on image files, and two hosts
# ---------------------------------------------------------------------------
# a seeded multimodal PNG set written by the phase: FILE_PAIRS pairs at
# FILE_SIZE^2 (trainA one channel, IR-like; trainB RGB), cropped to 256;
# an epoch of it is 24 batches of 8, long past the fill of FILE_WORKERS
# workers (each makes whole batches, two ahead), so it shows their steady
# rate
FILE_PAIRS, FILE_SIZE, FILE_CROP = 192, 286, 256
FILE_STEPS = 4
FILE_WORKERS = 4
FILE_BANNED = ("jax", "jaxlib", "grain", "nemar_tpu", "flax")
# phase 20b: hosts on this machine, each one rank on cuda:0 (gloo), each
# reading its shard in batches of TRAIN_BATCH / FILE_HOSTS rows
FILE_HOSTS, FILE_HOST_STEPS = 2, 2


def write_pairs(root: str, n: int = FILE_PAIRS, size: int = FILE_SIZE, seed: int = 20) -> None:
    """{root}/trainA/*.png (one channel: a smooth scene, shifted a few
    pixels) and {root}/trainB/*.png (RGB: the scene through three monotone
    maps), 8-bit like real data, as ``scripts/science_realdata.py`` makes
    them. The draws are taken in order, the pairs written on threads."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    rng = np.random.default_rng(seed)
    for sub in ("trainA", "trainB"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    draws = [(rng.random((9, 9)).astype(np.float32), rng.integers(0, 9, 2)) for _ in range(n)]

    def write(i):
        coarse, (dy, dx) = draws[i]
        scene = np.asarray(Image.fromarray(coarse).resize((size + 8, size + 8), Image.BICUBIC))
        scene = np.clip(scene, 0.0, 1.0)
        a = scene[dy:dy + size, dx:dx + size]
        b = scene[4:4 + size, 4:4 + size]
        b = np.stack([b ** 0.5, b, 1.0 - b ** 2], axis=-1)
        Image.fromarray((a * 255).astype(np.uint8), "L").save(
            os.path.join(root, "trainA", f"{i:03d}.png"))
        Image.fromarray((b * 255).astype(np.uint8)).save(
            os.path.join(root, "trainB", f"{i:03d}.png"))

    with ThreadPoolExecutor(8) as ex:
        list(ex.map(write, range(n)))


def banned_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FILE_BANNED)


class _Tap:
    """A loader's batches as the training loop takes them: each kept, the
    ms the loop waited for it and the ms of the step that took it (the
    card synchronised before the next)."""

    def __init__(self, loader):
        self.loader, self.batches, self.wait_ms, self.step_ms = loader, [], [], []

    def __len__(self):
        return len(self.loader)

    def num_batches(self):
        return self.loader.num_batches()

    def __iter__(self):
        t = time.perf_counter()
        for b in self.loader:
            got = time.perf_counter()
            self.wait_ms.append((got - t) * 1e3)
            self.batches.append(b)
            yield b
            torch.cuda.synchronize()
            t = time.perf_counter()
            self.step_ms.append((t - got) * 1e3)


def _file_args(ckpt: str, root: str, name: str, *extra) -> list:
    return [*TRAIN_ARGS, "--name", name, "--checkpoints_dir", ckpt, "--gpu_ids", "0",
            "--dataset_mode", "multimodal", "--dataroot", root, "--load_size", str(FILE_SIZE),
            "--crop_size", str(FILE_CROP), "--batch_size", str(TRAIN_BATCH), "--n_epochs", "1",
            "--n_epochs_decay", "0", "--display_freq", "0", "--print_freq", "0",
            "--save_latest_freq", "0", "--save_epoch_freq", "0", *extra]


def _train_through_entry(args: list) -> tuple:
    """``nemar_tpu_torch.train.main(args)`` with its loader tapped: (the
    model, the tap)."""
    from nemar_tpu_torch import train

    taps = []
    real = train.create_dataset

    def tapped(opt):
        taps.append(_Tap(real(opt)))
        return taps[-1]

    train.create_dataset = tapped
    try:
        with contextlib.redirect_stdout(open(os.devnull, "w")):
            model = train.main(args)
    finally:
        train.create_dataset = real
    close = getattr(taps[0].loader, "close", None)
    if close is not None:
        close()
    return model, taps[0]


def _loader_epochs(args: list, epochs: int = 2) -> dict:
    """``epochs`` passes of the loader of ``args`` over its set: the ms to
    its first batch (a worker loader's start), the ms a batch of each
    epoch (the first with the workers' start; the later ones with the
    workers kept), each batch's arrival (ms from its epoch's start) and
    each epoch's record paths in order."""
    from nemar_tpu_torch.data import create_dataset
    from nemar_tpu_torch.options import TrainOptions

    with contextlib.redirect_stdout(open(os.devnull, "w")):
        opt = TrainOptions().parse(args)
        loader = create_dataset(opt)
    out = {"paths": [], "ms_per_batch": [], "arrivals": []}
    for e in range(epochs):
        t0 = time.perf_counter()
        paths, arrivals = [], []
        for b in loader:
            arrivals.append((time.perf_counter() - t0) * 1e3)
            if not paths and e == 0:
                out["first_ms"] = arrivals[0]
            paths.append(b["A_paths"])
        out["ms_per_batch"].append(arrivals[-1] / len(paths))
        out["arrivals"].append(arrivals)
        out["paths"].append([p for ps in paths for p in ps])
    close = getattr(loader, "close", None)
    if close is not None:
        close()
    return out


def steady_ms(arrivals: list, fill: int) -> float:
    """A loader's ms a batch once its pipeline is full: from the arrival
    of its first round of ``fill`` batches (one a worker, made together)
    to that of its last batch."""
    return (arrivals[-1] - arrivals[fill - 1]) / (len(arrivals) - fill)


def run_file_loader(ckpt: str, root: str) -> None:
    """Phase 20a: NeMAR's default network at 256^2 b8 trained FILE_STEPS
    steps through the entry point on the PNG set, once with --loader
    threads and once with --loader grain --num_threads FILE_WORKERS, both
    --serial_batches: the batches the loop took bit-identical, the two
    runs' parameters and Adam states bit-identical (``state_digest``), no
    module of JAX, grain, flax or the JAX package in this process after
    them. Shuffled, each loader's epochs (two) hold the same records, each
    once, the worker loader's order the same at 0 and FILE_WORKERS workers
    and another in each epoch. Printed: the loaders' ms a batch over the
    set in each of two epochs (the first with the workers' start, which
    is printed apart), their steady ms a batch in each (``steady_ms``:
    past the pipeline's fill), beside the step's ms."""
    from nemar_tpu_torch.data import create_dataset
    from nemar_tpu_torch.data.grain_loader import GrainDatasetLoader
    from nemar_tpu_torch.models.base_model import state_digest
    from nemar_tpu_torch.options import TrainOptions

    fp32_only()
    steps = ["--max_dataset_size", str(FILE_STEPS * TRAIN_BATCH), "--serial_batches"]
    runs = {}
    for loader, extra in (("threads", ("--loader", "threads")),
                          ("grain", ("--loader", "grain", "--num_threads", str(FILE_WORKERS)))):
        model, tap = _train_through_entry(_file_args(ckpt, root, f"smoke_files_{loader}",
                                                     *steps, *extra))
        assert isinstance(tap.loader, GrainDatasetLoader) == (loader == "grain")
        losses = model.get_current_losses()
        runs[loader] = {"digest": state_digest(model), "tap": tap, "losses": losses,
                        "step": model.step}
        del model
        torch.cuda.empty_cache()
    th, gr = runs["threads"], runs["grain"]
    same_batches = (len(th["tap"].batches) == len(gr["tap"].batches) == FILE_STEPS and all(
        all(np.array_equal(a[k], b[k]) for k in ("A", "B")) and a["A_paths"] == b["A_paths"]
        for a, b in zip(th["tap"].batches, gr["tap"].batches)))
    same_state = th["digest"] == gr["digest"] and th["step"] == gr["step"] == FILE_STEPS
    finite = all(math.isfinite(v) for r in runs.values() for v in r["losses"].values())
    banned = banned_modules()
    # shuffled, over the whole set: the worker loader at 0 and FILE_WORKERS
    # workers (the same order), the thread loader (the same records)
    passes = {name: _loader_epochs(_file_args(ckpt, root, "smoke_files_shuffled", *extra))
              for name, extra in (
                  ("grain_0", ("--loader", "grain", "--num_threads", "0")),
                  ("grain", ("--loader", "grain", "--num_threads", str(FILE_WORKERS))),
                  ("threads", ("--loader", "threads")))}
    records = {k: v["paths"] for k, v in passes.items()}
    fill = {"grain_0": 1, "grain": FILE_WORKERS, "threads": 1}
    steady = {k: [round(steady_ms(a, fill[k]), 3) for a in v["arrivals"]]
              for k, v in passes.items()}
    same_records = all(
        sorted(a) == sorted(b) and len(set(a)) == len(a) == FILE_PAIRS
        for a, b in zip(records["threads"], records["grain"]))
    same_order = (records["grain"] == records["grain_0"]
                  and records["grain"][0] != records["grain"][1])
    phase("file_loader", pairs=FILE_PAIRS, size=FILE_SIZE, crop=FILE_CROP, batch=TRAIN_BATCH,
          steps=FILE_STEPS, workers=FILE_WORKERS, batches_bit_identical=same_batches,
          states_bit_identical=same_state, shuffled_records_equal=same_records,
          shuffled_order_same_at_0_workers=same_order,
          banned_modules=json.dumps(banned),
          step_ms_threads=json.dumps([round(t, 3) for t in th["tap"].step_ms]),
          step_ms_grain=json.dumps([round(t, 3) for t in gr["tap"].step_ms]),
          wait_ms_threads=json.dumps([round(t, 3) for t in th["tap"].wait_ms]),
          wait_ms_grain=json.dumps([round(t, 3) for t in gr["tap"].wait_ms]),
          loader_ms_per_batch_by_epoch=json.dumps(
              {k: [round(t, 3) for t in v["ms_per_batch"]] for k, v in passes.items()}),
          loader_steady_ms_by_epoch=json.dumps(steady),
          loader_first_ms=json.dumps({k: round(v["first_ms"], 3) for k, v in passes.items()}),
          loader_batches=FILE_PAIRS // TRAIN_BATCH, losses_grain=json.dumps(gr["losses"]))
    fails = [k for k, ok in (("batches", same_batches), ("states", same_state),
                             ("finite", finite), ("shuffled records", same_records),
                             ("shuffled order at 0 workers", same_order),
                             ("no JAX module", not banned)) if not ok]
    if fails:
        raise AssertionError(f"file_loader: {fails}")


def _host_rank(args: list, steps: int) -> dict:
    """Phase 20b inside a rank of one host: the model from ``args``, its
    loader (this host's shard), ``steps`` steps; -> the ms of each, the
    digest after each, the losses and (at rank 0) the parameters and
    gradients after the first, this host's first batch, and the modules of
    JAX, grain or the JAX package the rank holds."""
    from nemar_tpu_torch import parallel
    from nemar_tpu_torch.data import create_dataset
    from nemar_tpu_torch.models.base_model import state_digest, to_host

    fp32_only()
    with contextlib.redirect_stdout(open(os.devnull, "w")):
        model = train_model(args)
        loader = create_dataset(model.opt)
    out = {"ms": [], "digests": [], "rank": parallel.rank(), "host": parallel.host()}
    for i, b in enumerate(loader):
        if i == steps:
            break
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.set_input(b)
        model.optimize_parameters()
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["digests"].append(state_digest(model))
        if i == 0:
            out["batch"] = {k: b[k] for k in ("A", "B")}
            out["losses"] = dict(model.get_current_losses())
            if parallel.rank() == 0:
                out["params"] = {n: {k: to_host(p) for k, p in net.named_parameters()}
                                 for n, net in model.nets().items()}
                out["grads"] = {n: {k: to_host(p.grad) for k, p in net.named_parameters()}
                                for n, net in model.nets().items()}
    loader.close()
    out["banned"] = banned_modules()
    return out


def run_two_hosts(ckpt: str, root: str, dev: torch.device = torch.device("cuda", 0)) -> None:
    """Phase 20b: FILE_HOSTS hosts on this machine (launcher processes of
    their own, ``multiprocess_smoke.run_hosts``), each one rank on cuda:0,
    joined over host 0's TCP store on 127.0.0.1 (gloo: NCCL refuses two
    ranks on one card); --loader grain reading each host's shard of the PNG
    set, the global b8 batch as TRAIN_BATCH / FILE_HOSTS rows a host, from
    phase 6's saved state (``smoke6``), FILE_HOST_STEPS steps. Held: the
    ranks bit-identical after each step; the first step within phase 6's
    limits of one process fed the global batch (the hosts' first batches
    in host order: ``_hold_two_ranks``); no JAX module in a rank."""
    from nemar_tpu_torch.multiprocess_smoke import run_hosts

    args = [*_file_args(ckpt, root, "smoke_train", "--loader", "grain", "--num_threads", "0",
                        "--max_dataset_size",
                        str(FILE_HOST_STEPS * TRAIN_BATCH)),
            "--continue_train", "--epoch", "smoke6"]
    t0 = time.perf_counter()
    hosts = run_hosts(_host_rank, [dev], args=(args, FILE_HOST_STEPS),
                      hosts=FILE_HOSTS, backend="gloo", timeout=NCCL_TIMEOUT,
                      pg_timeout=NCCL_TIMEOUT)
    ranks = [r for h in hosts for r in h]
    phase("two_hosts", hosts=FILE_HOSTS, seconds=round(time.perf_counter() - t0, 2),
          host_rows=len(ranks[0]["batch"]["A"]),
          banned_modules=json.dumps(sorted({m for r in ranks for m in r["banned"]})))
    assert [(r["host"], r["rank"]) for r in ranks] == [(h, h) for h in range(FILE_HOSTS)]
    assert all(len(r["digests"]) == FILE_HOST_STEPS for r in ranks)
    assert not any(r["banned"] for r in ranks), [r["banned"] for r in ranks]
    batch = {k: np.concatenate([r["batch"][k] for r in ranks]) for k in ("A", "B")}
    assert len(batch["A"]) == TRAIN_BATCH
    _hold_two_ranks("two_hosts", args, batch, ranks, ("A",))


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
        t0 = time.perf_counter()
        band_checks, band_launches = run_spatial(ckpt)
        phase("spatial_phase", seconds=round(time.perf_counter() - t0, 2))
        t0 = time.perf_counter()
        band_launches.update({k: v for k, v in run_spatial_recipe(ckpt).items()
                              if k.endswith("-bf16")})
        phase("spatial_recipe_phase", seconds=round(time.perf_counter() - t0, 2))
        t0 = time.perf_counter()
        run_spatial_flags(ckpt)
        phase("spatial_flags_phase", seconds=round(time.perf_counter() - t0, 2))
        t0 = time.perf_counter()
        run_spatial_geometry(ckpt)
        phase("spatial_geometry_phase", seconds=round(time.perf_counter() - t0, 2))
        t0 = time.perf_counter()
        run_spatial_templates(ckpt)
        phase("spatial_templates_phase", seconds=round(time.perf_counter() - t0, 2))
        t0 = time.perf_counter()
        run_spatial_chunks(ckpt)
        phase("spatial_chunks_phase", seconds=round(time.perf_counter() - t0, 2))
        t0 = time.perf_counter()
        files = os.path.join(ckpt, "pairs")
        write_pairs(files)
        run_file_loader(ckpt, files)
        phase("file_loader_phase", seconds=round(time.perf_counter() - t0, 2))
        t0 = time.perf_counter()
        run_two_hosts(ckpt, files)
        phase("two_hosts_phase", seconds=round(time.perf_counter() - t0, 2))
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
    kernels += band_kernel_entries(band_checks, band_launches,
                                   {k: rep for k, (_, _, rep) in sources.items()})
    phase("total", seconds=round(time.perf_counter() - START, 2))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
