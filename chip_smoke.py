#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Phases, each printing its own lines; any failure exits non-zero:

1. the card's name and power limit, the build of every kernel in
   ``egonerf_torch/csrc`` from the checkout, and each kernel's registers
   and spills from ptxas (a spill in the VM-grid lookups, K4, K4c or the
   cull's K12 and K13 fails);
2. each kernel of the render path (K1, K3, K4 with its fine-chart epilogue,
   K6, K7) against its plain PyTorch version on the card, on the inputs one
   4096-ray chunk of the production model gives it (K4 also on K5's sorted
   uniforms, without the merge, at the smoke config's 48 + 48 samples and
   on hard rays: zero density, one spike, repeated coarse depths, u near 1
   and on the cdf's edges, u reversed; its epilogue's coords equal to K7's
   on the same depths bit for bit), each kernel of the training step (K2,
   K4, K5, K6b) on the inputs of one production training step (K4's and
   K4c's training instantiations, which draw K5's uniforms in their
   prologue, bit for bit with K5 followed by the op at 128 and 1, 33, 48,
   97, 255 draws a ray, without the merge and on K4's hard rays, and so at
   the ray offsets of a data-parallel shard, with K5 at the same offset;
   K5 at an offset bit for bit with the rows of its draw from ray 0), K1,
   K3 and
   K2 at the smoke config's widths and at one the kernels' scalar
   instantiation takes, and the envmap's (K6e, K6 with K8's lookup inside:
   its env bit for bit with K8's and its other outputs with K8 + K6's, also
   on rays at the seam and the poles; K8, K8b, K6 with a given env and K6b
   with the background) on the inputs of one production step of the
   outdoor shape, K6b at 1, 33, 96, 256 and 1536 samples a ray in its three
   instantiations, with times from CUDA events (K1, K2 and K3 also with a cold L2); K1's
   training instantiation's relu mask against the states of its lane-order
   sums; K2's layout (``bwd_layout``), and K2 (two grids and S=1) also on
   two hard inputs: every sample at one point, and the samples shuffled;
   and K2 on recorded steps of the smoke config and of the JAX ``tensorf``
   preset's first two grids (128^3 and, after its first upsample, 161^3);
3. one 2000x1000 equirectangular view at full production width through
   ``Renderer.render_view``, with seeded random weights: finite rgb in
   [0, 1], finite depth, and each render kernel launched once per chunk
   (K7 for the coarse chart; the fine chart is K4's epilogue);
4. a few chunks rendered with the kernels and with the plain versions on
   the card, end to end;
5. where the time of those chunks goes on the device, from torch.profiler;
6. production training steps through ``Trainer.train_step`` (batch 4096,
   128 + 128 samples, N_voxel 27e6, MSE, Adam) on the synthetic scene:
   step ms, train rays/s, peak memory, every kernel launched once per
   step (K7 for the coarse chart, the fine one in K4; K4 in its training
   instantiation, which draws K5's uniforms, so no K5), and where the time
   goes from torch.profiler (K2's share of the step too, as in phases 10
   and 16);
7. one production training step with the kernels and with the plain
   versions, same weights and draws: the loss and every gradient;
8. the smoke run of ``configs/smoke/synthetic.txt`` (300 iterations)
   through the command line ``python -m egonerf_torch``, its test PSNR
   against the JAX package's 14.92 dB, and ``--evaluation 1`` from the
   checkpoint it wrote (the files JAX writes, ``mean.json`` with every
   metric but LPIPS);
8v. the same smoke run with EgoNeRF's grid upsampling (N_voxel 27,000 ->
   64,000 at steps 100 and 200) and with its linear ray sampling, each test
   PSNR against the JAX package's for the same arguments on the CPU
   (``tests/smoke_variants_jax.py``) less the seed band;
9. the outdoor shape (``presets.outdoor_overrides``: the fields of
   ``configs/egonerf/omniblender/bistro_square.txt``, an envmap of
   2000x1000x3) on the procedural scene with its background at infinity:
   one 2000x1000 view (K6e once a chunk, no K8), a few chunks against the
   plain versions, and where the time goes;
10. 20 envmap pretrain steps (K8 and K8b once each) and 20 production
    envmap training steps (K6e, K6b and K8b, no K8), with launches per step
    and where the time goes;
11. one envmap training step with the kernels and with the plain
    versions: the loss and every gradient, the envmap's included;
12. ``python -m egonerf_torch --config .../bistro_square.txt`` on the
    procedural scene (pretrain, a few steps, ``--evaluation 1``; its
    ``envmap.png``, ``_bg`` PNGs and the pretrain's
    ``pretrained_envmap.png``);
13. the JAX package's envmap quality recipe through the port's
    ``tools/envmap_e2e.py`` (500 pretrain + 3000 steps, N_voxel 8e6, 12 + 2
    views at 800x400): its test PSNR against the JAX package's 28.67 dB
    less its seed band;
14. the TensoRF family (TensorVMSplit, ``presets.tensorf_mask_overrides``:
    the xyz chart at 256^3, 256 samples a ray) with a 128^3 alpha mask of
    about half occupancy: one 1000x500 view (K1, K9, K6 once per chunk);
    phase 2 holds its kernels (K1, K2, K3 on a single grid, K6 and K6b with
    the sample gates, K9) against their plain versions on the inputs of
    one of its steps and of its bake;
15. a few of those chunks with the kernels and with the plain versions;
16. the JAX ``tensorf_bench`` recipe (1200 steps, the mask baked at 1000)
    through the port's ``tools/tensorf_bench.py`` (its timed segments and
    the gate occupancy), then 20 timed steps (K1, K2, K9, K6, K6b once a
    step), where the time goes, the bake's time and launches;
17. one of those steps with the kernels and with the plain versions;
18. the JAX ``tensorf`` quality recipe unchanged (6000 steps, 128^3 ->
    256^3 at 1000/2000/3000, 12 + 2 views at 1000x500): its test PSNR
    against the JAX package's 40.40 dB less the seed band.

The JAX package's opt-in shader and line forms (``EGONERF_MIXED_MM``,
``EGONERF_BIAS_DOT``, ``EGONERF_SPLIT_L1``, ``EGONERF_HOIST_DIRS``,
``EGONERF_LINE_HAT=0``) have phases of their own, each run right after the
phase it is compared with:

2. (also) K10, the mixed-precision product, in its three layouts (the
   forward, da, db) and K11, the bias gradient, on the inputs of two
   recorded production steps under the forms (every shader layer, the
   basis, the hoist's ray term), each against the exact product of its
   bf16 operands and its plain version (the forward bit for bit), timed
   beside ``torch.matmul`` on bf16 operands and ``dout.sum(0)``; K2's line
   mode 2 on the production step's inputs and at the widths;
7b. on the production trainer, each switch alone and MIXED_MM + BIAS_DOT +
    HOIST_DIRS together, beside the default in the same process: the
    render chunk's device ms (median of 7) and the step's (median of 20),
    the launches of K10 and K11 a chunk and a step, 3 chunks and one step
    against the plain versions (phases 4 and 7's limits);
8b. the smoke run of phase 8 under the combined switches: K10 and K11
    launched, its test PSNR within the seed band of phase 8's;
15b. TensoRF's view chunks and steps as in 7b under HOIST_DIRS, SPLIT_L1
    and BIAS_DOT.

The JAX package's opt-in empty-space cull (``eval_keep``, ``train_keep``)
likewise:

2. (also) K4c, the cull's coarse pass (K4 with the cull score in its
   epilogue), against its plain version: z and dists within K4's limit and
   equal bit for bit to K4's weights instantiation's, the score bit for bit
   with K12's plain version on the plain weights; K4's weights
   instantiation against the plain weights (``_warp_weights``), and K12
   (the standalone cull score) and K13 (the top-K compaction, on K4c's
   scores) against their plain versions bit for bit, on one production
   chunk at K = 192 and 128, at the smoke config's 48 + 48 samples, on hard
   rays (all-zero weights, one spike, repeated coarse depths, long runs of
   equal scores, perturbed scores, K = 1 and S - 1; K4c also on K4's hard
   rays, K5's uniforms and without the merge) and on a recorded culled
   production training step; times and bounds;
3c-5c. the 2000x1000 view at eval_keep 192 and 128 (one each of K3, K4c,
    K13, K1, K6 and two of K7 a chunk, no K4, K4w or K12; K4c and K13
    never without the cull), its s/image and render chunk beside
    the unculled ones, a few chunks against the plain versions (phase 4's
    limits) with the rays whose kept set differs, and where the time goes;
6c. 20 production steps each at train_keep 128: the tie-break, Gumbel
    scores (tau 1), and a full step every 4; step ms and launches;
7c. one culled step against the plain versions, the same draws (the
    cull's uniforms too), at phase 7's limits;
8c. phase 8's trained smoke model rendered at eval_keep 64 of its 96
    merged samples: test PSNR against ground truth and against the
    unculled render (a record).

The captured-data path (the loaders, the pose readers, the
theta-importance sampler) likewise:

2. (also) K14, the theta sampler's row draw, against its plain version bit
   for bit on a production batch (4,096 draws) of the 1920x960 Ricoh raster,
   full and cropped to roi [0.05, 0.95, 0, 1], on hard uniforms (0, every
   cdf value and its float32 neighbours, above the cdf's end), on a cdf
   with ties ending below 1 and at h = 1, timed beside ``torch.searchsorted``;
   K14f, the sampler drawing, picking and gathering a batch in one launch,
   ids and rows bit for bit with its plain version (both rasters at two
   batch counters, 2^20 draws, ties, h = 1, a cdf read unstaged);
   K15 (one bf16 table's plane or line lookup, no gradient) and K16 (a
   float32 line stack's linear sample), whose caller is phase 36's
   ``microbench_lookup``, at the fine
   grid's shapes over 1,048,576 points (each also at S = 1) within REL_TOL
   of their plain versions, each beside ``F.grid_sample`` on the same table
   (2-D at S = 1, 3-D with the chart as depth at S = 2);
19. JAX's egocentric end-to-end recipe unchanged: an 8-frame 240x120
    capture from the port's writer, its COLMAP and OpenVSLAM poses against
    the render's (1e-5), its rays and pixels against ``trace_rays`` (1e-5,
    1.5/255), and the recipe through the command line with
    ``theta_importance`` (K14f once a step, no K14): test PSNR above 8.5 dB (below
    every seed's in either package); then the recipe trained 600 steps,
    its PSNR 3 dB above a constant colour's (the train frames' mean), which
    is what a field trained on shuffled pixels reaches;
20. ``configs/egonerf/ricoh/garden.txt`` as shipped on a synthesised
    1920x960 capture of 8 frames (6 train, 2 test); the PNG codec on one of
    its frames written again with Average, with Paeth and by PIL (pixels
    equal, timed beside PIL); through the command line
    with ``theta_importance`` (K14f once a step), then steps timed and
    profiled under theta and under ``simple`` in this process, one test view
    (s/image, peak memory, PSNR as a record) and K14f's distribution over
    2^24 draws (every
    row, image and column within 6 binomial deviations);
21. ``configs/egonerf/omniblender/archiviz-flat.txt`` on a 2000x1000
    OmniBlender-layout scene of 6 frames written here: 20 steps through the
    command line (``simple``), then timed steps and one test view.

The evaluation outputs, EgoNeRF's linear sampling and its grid upsampling:

22. phase 21's trainer through ``evaluation()`` (2 views at 2000x1000):
    s/image with PSNR alone and no images, with every metric and the
    images in turn, and overlapped with the next view's render (in turns),
    the host ms of a view's SSIM map, PSNRs and PNGs, ``mean.json``, the
    files against JAX's list; ``evaluation_path`` over 3 frames of the
    LLFF loader's spiral around the scene's poses; the LPIPS graph (alex,
    vgg, weights from SEED) on a 2000x1000 pair on the card, timed, against
    the same graph on the host (rel 1e-4);
23. the production EgoNeRF with ``exp_sampling`` off (the chart's linear
    radius: K7's mode 2, K4's mode-2 epilogue): K7 and K4 against their
    plain versions on a chunk and a recorded step, one 2000x1000 view with
    a few chunks against the plain versions, timed and profiled steps, one
    step against the plain versions;
24. the production EgoNeRF from N_voxel 8e6 upsampled to 27e6 after step
    10 by ``Trainer.upsample`` (24l: the same with the linear radius): the
    params against the host's resampling, the fine line modes before and
    after, K1-K4 and K7 on a recorded step of the new grid against their
    plain versions, timed steps after the event.

The entropy, sparsity and depth losses (LOSSES: entropy 1e-3, sparsity
0.1 on 10,000 points, depth supervision):

2. (also) on the inputs of a production step with the entropy and
   sparsity terms (indoor, outdoor, TensoRF): K6's training instantiation
   (alpha out) in its three forms (K6, K6e, gated; alpha abs <= 1e-6, the
   rest at K6's limits), K6b's (d_alpha in) in its three (rel 1e-5 as K6b;
   also at 1, 33 and 1536 samples), K3's (the relu mask equal to its
   lane-order states) and K2 at no appearance channels (per cell as K2) on
   the sparsity lookup's points at S = 2 and S = 1, and K14f at 10 floats a
   row bit for bit (the same ids as at 9);
8v. (also) the smoke run with the three losses against the JAX package's
   CPU figure less the seed band;
25. the production trainers with the three losses through
    ``Trainer.train_step``: indoor, culled at train_keep 128, under
    ``theta_importance`` (K14f at 10 floats), outdoor (K6e with alpha) and
    TensoRF (gated, S = 1): step ms (median of 20) beside the same steps
    with the losses off in the same process, launches (the training
    instantiations once a step, one more K3 and K2), device operations a
    step, and one loss step against the plain versions (loss rel 1e-5,
    gradients 1e-3).

The rest of the TensoRF family (TensorVM, TensorCP, NDC rays, filter_ray):

2. (also) TensorVM's relu-free K1, K3 and K2 at S = 1 on the inputs of
   phase 2's TensoRF step and bake, with decomposition 0's density
   channels zeroed on half of its plane's rows (negative, exactly zero and
   positive partials), at K1's, K3's and K2's limits; K17, the CP line
   product, in its eval (bf16 lines), training (float32) and density-only
   (float32) forms on the hat and the linear line weights, and K17b, its
   backward (per row as K2, at K2's limit; also with every sample on four
   points, and on 10,000 points of the density alone), on a recorded
   TensorCP step at CP-384 (``presets.tensorcp_overrides``: 500^3, 96 +
   288 channels, 1,048,576 samples);
8v. (also) the smoke run as TensorVM and as TensorCP (96 + 288
   components) on the xyz chart against the JAX package's CPU figure less
   the seed band;
26. TensorVM at the ``tensorf_bench`` shape with a 128^3 mask of half
    occupancy: one step against the plain versions, 20 timed steps (K1 and
    K2 in their relu-free instantiations, K9, K6, K6b once a step) beside
    TensorVMSplit's in this process, the profile, a 1000x500 view and a few
    of its chunks against the plain versions, and the bake (K3 relu-free,
    K9);
27. TensorCP at CP-384 likewise: K17's training form and K17b once a step,
    the view on K17's eval form, the bake on its density-only form, each
    on the hat (counted by form and line mode, so the linear forms' 0 is a
    count);
28. TensorVMSplit on the bench scene with ``ndc_ray``: a step against the
    plain versions and timed NDC steps; a trainer with ``filter_ray`` on
    the scene's training rays and rays whose lines miss the box: the
    filter's kept count against the slab test on the host and against the
    rays that touch the box, its seconds, the sampler's buffer, and timed
    steps after it.

The other charts, the other shading modes and mesh export:

8v. (also) the smoke run as TensorVMSplit on generic_sphere (exp,
   interval_th, r0 0.05) and on balanced_sphere, and as EgoNeRF under SH,
   each against the JAX package's CPU figure less the seed band;
29. TensorVMSplit at the ``tensorf_mask_overrides`` widths on generic_sphere
    (exp, interval_th, r0 0.03, N_voxel 256^3 -> [128, 254, 508]) on the
    indoor scene with a 128^3 mask of half occupancy: K7s (generic_sphere's
    chart with the samplers' in-box mask) against its plain version at
    K7's limits and its mask bit for bit with ``_in_box`` of torch's points
    on a chunk (radial modes 0, 1 and 2), on rays from outside the box, on
    rays at and along its faces, on the poles and the phi = +-pi seam and
    on a recorded step, its radial column bit for bit on the grid's
    entries and an ulp either side, timed beside each plain chart's map; a
    2000x1000 view (K1, K9, K6, K7s once a chunk; a chunk's device
    operations), 20 timed steps (K7s once a step, no searchsorted in the
    profile), a step against the plain versions, the bake and a 128^3
    density grid for the export (K7s and K3); balanced_sphere at the same
    budget (a view, steps, a step against plain); sphere, the two
    directional charts, euler_sphere and cylinder (a step against plain and
    one step's launches each);
30. the production EgoNeRF under MLP_Fea, SH, MLP_PE and MLP in one
    process: a view with chunks against plain and its profile, 20 timed and
    profiled steps, a step against plain; MLP_PE and MLP under MIXED_MM
    (K10's launches); RGB at data_dim_color 3 (a view, a step against
    plain); TensorVMSplit at phase 14's shape under MLP_PE (a view, a step
    against plain);
31. ``--export_mesh 1`` on phase 8's smoke checkpoint through the command
    line (the PLY's counts and seconds), and the production EgoNeRF's
    density grid at 128^3 and 256^3 (K7 and K3 once per 8 x-rows): device
    ms, host seconds of the marching tetrahedra, and the grid against the
    plain versions' (rel <= 1e-5 of max|plain|);
32. the production training step through the data-parallel path on an
    NCCL process group of one rank (loopback): 20 timed steps beside two
    single-process trainers', in turns, the parameters after each round
    against the two single-process runs' spread (``noise_check``), the
    step's profile (the all-reduce), and one
    2000x1000 view rendered with its chunks split over the group against
    the same view unsplit, bit for bit;
33. two gloo ranks sharing the card (``python3 chip_smoke.py --gloo-rank
    R PORT DIR``, each under its own timeout) train the smoke config: rank
    1's shard draws from ray 1024 on (K4's offset on the card); the ranks'
    parameters bit for bit, and as close to the single-process trainer's
    after the same steps as two single-process runs are to each other
    (``noise_check``);
34. a production trainer run of PROFILE_RUN_ITERS steps with
    ``profile_dir``: ``traced_steps.json`` holds 24, the trace names the
    step's kernels, and the steps' ms inside and outside the window.

The quality-record tools (``egonerf_torch/tools``):

18. (also) the ``tensorf`` recipe is ``quality_run``'s preset;
35. ``quality_run``'s refscale preset through its ``_run`` at full
    production width (N_voxel 27e6, 128 + 128 samples, batch 4096, 12 + 2
    views at 2000x1000), cut to its first REFSCALE_CUT_ITERS steps (the
    full run's learning-rate schedule): its test PSNR at or above the first
    reading of the same cut run less the JAX seed spread; ``occ_probe`` (K7,
    K3, K4, K9) and ``eval_bench`` (keeps 0, 192, 128, 192o) on its
    checkpoint, the unculled view 0 within 1e-3 dB of the trainer's (each
    view's PSNR from ``evaluation()`` of the final checkpoint, their mean
    the run's record within 1e-3 dB); ``envmap_probe`` (K8) on phase 13's
    envmap run.  Each tool's
    kernels counted from 0 around its run.

The measurement tools (``egonerf_torch/tools``):

36. ``profile_step``'s per-operation and family tables of phase 34's trace
    (every device operation in one family, the families summing to the
    window's device time, "other" printed with its top names, the
    device-busy share) and ``capture_eval`` of one 2000x1000 view with its
    tables; ``eval_probe`` at chunk 4096 in its four modes (none, rgb, all,
    and pipe2: the copy on a side stream); ``eval_ship`` over 2 views;
    ``microbench_lookup`` (K16, K15's line and plane, K1 in two line modes,
    K2 in three, K4 merged and unmerged, each against its plain version,
    timed beside ``F.grid_sample`` and ``torch.sort``), the caller whose
    launches K15's and K16's rows report.  Each tool's kernels counted from
    0 around its run.  The run's seconds are printed before the last lines.

The real-data pipeline (``egonerf_torch/tools/real_data_run.py``):

37. ``real_data_run`` through its keyword entry on two scenes written in
    the loaders' layouts under ``build/`` at the shipped configs' full
    width (N_voxel 27e6, 128 + 128 samples, batch 4096): ``barbershop``
    (OmniBlender, 2000x1000) and ``garden`` (Ricoh360, 1920x960: the
    ``imgs/`` layout, the envmap and the TV losses), REAL_FRAMES frames and
    REAL_ITERS iterations (the only cuts), the run's folder and its record
    under ``build/``: rc 0, the record's test PSNR that of ``mean.json``
    within 1e-3 dB, the kernels counted from 0 around each run (the steps'
    kernels once a step, the render's once a chunk of each test view, with
    the envmap K8 once a chunk of the envmap's image), the wall seconds
    and the peak memory; then the command line on an absent scene: exit 3,
    nothing launched or allocated; and ``docs/torch/`` untouched by the
    phase.

The train-time cull quality A/B (``egonerf_torch/tools/cull_ab.py``):

38. ``cull_ab.run`` at keep CULL_AB_KEEP with an unculled step every
    CULL_AB_EVERY, on the production model at ``sampler_ab``'s shape,
    cut to CULL_AB_ITERS steps with an evaluation every CULL_AB_VIS, its
    record written under ``build/``: the kernels counted from 0 around the
    run (K4c + draw and K13 once a culled step, K4 + draw once an unculled
    one, K2 and K6b once a step), the record's keep, ``full_every``, tag
    and PSNR steps those asked for, and ``docs/torch/`` untouched.

The second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it prints no
result and exits 2.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import socket
import subprocess
import sys
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and the float32
# rate outside the tensor cores, which the kernels of this path use
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# the dense bf16 tensor-core rate, which K10's products use
PEAK_BF16_OPS_PER_S = 989e12

# kernel vs plain on identical inputs: float32 sums taken in another order
REL_TOL = 1e-5
# K2 against its plain version, per gradient cell: float32 atomics add in
# another order, so the error is held to the sum of the absolute terms
K2_TOL = 1e-4
# K5: the same Philox bits and float64 logs; only the float32 cumsum order
# differs, on values in (0, 1)
K5_TOL = 1e-6
# the draws a ray at which K4's and K4c's training instantiations are held
# to K5 then the op, beside the production 128: n + 1 off the 4- and
# 32-grids, one draw, and more than a lane's 4 in K4c
DRAW_SWEEP = (48, 1, 33, 97, 255)
# the ray offsets at which they are held so: the second rank's first ray of
# the production batch on two ranks, and one past 32 bits (the counter's
# third word)
DRAW_OFFSETS = (2048, 2 ** 32 + 3)
# K7 vs plain, on the normalized coords in [-1, 1]: the kernel repeats the
# plain version's float32 steps one by one, but its acos and atan2 come
# from the CUDA math library nvcc links and torch's from the one torch was
# built with, whose last bits may differ; the chart flag must agree on
# every sample
K7_TOL = 1e-5
# K8 vs plain: the same corners and weights; sigmoids in (0, 1), float32 ulps
K8_TOL = 1e-6
# K6e's hard directions (tests/test_torch_envmap.py::_env_dirs): the seam
# (atan2 = +-pi: v = 1 and 0), the poles (u = 1 and 0, atan2(0, 0) = 0), and
# directions at z = 0
ENV_HARD_DIRS = ((-1.0, 0.0, 0.3), (-1.0, -0.0, -0.4), (-2.0, 0.0, 0.0), (-1.0, 1e-30, 0.2),
                 (0.0, 0.0, 1.0), (0.0, 0.0, -1.0), (0.0, 0.0, 5.0), (3.0, 4.0, 0.0),
                 (-4.0, 3.0, 0.0), (1.0, 0.0, 0.0), (0.0, -1.0, 0.0))
# K6b's sample counts in phase 2: one sample, chunks of 2 and 3 that cross
# the shared arrays' 32-word rows, the production 256, and the wrapper's
# largest, a one-warp block
K6B_SWEEP_S = (1, 33, 96, 256, 1536)
# K9 vs plain: the same eight products of 0/1 cells, added in the same order
K9_TOL = 1e-6
# one training step, kernels vs plain: the loss to rel 1e-5; each gradient
# tensor in relative L2 norm, see phase 7
GRAD_TOL = 1e-3
# K10 against the exact product of the same bf16 operands (float64), per
# element, as a share of sum|terms|: both the kernel and the plain version
# add exact float32 products in float32, K <= 150 of them in the forward and
# da (recursive summation errs by at most about K u, u = 2**-24, ~9e-6); db
# and K11 sum a million rows, which are held to K2_TOL as K2's cells are
MM_TOL = 1e-5
SEED = 0
IMAGE_HW = (1000, 2000)
# ~0.1 s of device spin at H100 clocks: longer than the host needs to
# enqueue one timed run
SLEEP_CYCLES = 200_000_000
# read between two launches of a cold-L2 time: five times the 50 MB L2
FLUSH_BYTES = 256 << 20
# phase 2's K1/K2/K3 at the other widths: random tables from SEED on a grid
# of the smoke config's size (N_voxel 64e3), samples of its batch (2048 rays
# x 96) spread over [-1.05, 1.05].  (C, n_density): the smoke config's fine
# grid (configs/smoke/synthetic.txt); its coarse grid's C = 8 (K3 reads all
# channels; K1 and K2 split them mid-lane at 4); a width off the 8-channel
# grid, which takes K1/K3's scalar instantiation; one off the 4-channel grid,
# which takes K2's too
WIDTH_GRID = (40, 40, 40)
WIDTH_SAMPLES = 2048 * 96
WIDTHS = (("smoke fine", 24, 8), ("smoke coarse", 8, 4), ("scalar", 20, 4),
          ("K2 scalar", 18, 6))
# device-side names of the kernels in csrc/
PORT_KERNELS = ("vm_lookup_kernel", "vm_field_bwd_kernel", "resample_kernel",
                "resample_score_kernel", "sorted_uniform_kernel", "composite_kernel",
                "composite_bwd_kernel",
                "chart_kernel", "chart_sphere_kernel", "envmap_kernel", "envmap_bwd_kernel",
                "alphamask_kernel",
                "mm_fwd_kernel", "mm_fwd_narrow_kernel", "mm_rows_kernel", "mm_db_kernel",
                "mm_db_sum_kernel",
                "bias_grad_part_kernel", "bias_grad_sum_kernel", "cull_score_kernel",
                "top_k_kernel", "theta_ids_kernel", "theta_batch_kernel", "vm_sample_kernel",
                "line_sample_kernel", "cp_fwd_kernel", "cp_dens_sum_kernel", "cp_bwd_kernel",
                "cp_bwd_sum_kernel")
TRAIN_WARMUP, TRAIN_STEPS, PROFILE_STEPS = 5, 20, 3
SMOKE_ITERS = 300
DEVICE = "cuda"
# the JAX package's smoke result and its seed band (NOTES.md:77, :139)
JAX_SMOKE_PSNR, SEED_BAND_DB = 14.92, 2.45
SMOKE_CONFIG = "configs/smoke/synthetic.txt"
# the smoke recipe's variants (phase 8v): EgoNeRF's grid upsampling (N_voxel
# 27,000 -> 64,000 in two steps, at steps 100 and 200), its linear ray
# sampling, the entropy, sparsity and depth losses at once (the weights of
# phase 25), TensorVM and TensorCP (at its published 96 + 288 components)
# on the xyz chart, TensorVMSplit on generic_sphere (the recipe's exp,
# interval_th, r0 0.05) and on balanced_sphere, and EgoNeRF under SH, each
# beside the JAX package's test PSNR for the same arguments on the CPU
# (tests/smoke_variants_jax.py)
SMOKE_VARIANTS = {"upsample": ["--N_voxel_init", "27000", "--upsamp_list", "[100,200]"],
                  "linear": ["--exp_sampling", "0"],
                  "losses": ["--entropy_weight", "1e-3", "--sparsity_lambda", "0.1",
                             "--use_depth", "1"],
                  "tensorvm": ["--model_name", "TensorVM", "--coordinates_name", "xyz",
                               "--resampling", "0"],
                  "tensorcp": ["--model_name", "TensorCP", "--coordinates_name", "xyz",
                               "--resampling", "0", "--n_lamb_sigma", "[96]",
                               "--n_lamb_sh", "[288]"],
                  "generic_sphere": ["--model_name", "TensorVMSplit", "--coordinates_name",
                                     "generic_sphere", "--resampling", "0"],
                  "balanced_sphere": ["--model_name", "TensorVMSplit", "--coordinates_name",
                                      "balanced_sphere", "--resampling", "0"],
                  "sh": ["--shadingMode", "SH", "--data_dim_color", "27"]}
# JAX_PLATFORMS=cpu python tests/smoke_variants_jax.py (the JAX package on the
# CPU, 300 iterations each)
JAX_SMOKE_VARIANT_PSNR = {"upsample": 16.25, "linear": 15.12, "losses": 14.88, "tensorvm": 16.02,
                          "tensorcp": 18.05, "generic_sphere": 14.83, "balanced_sphere": 14.79,
                          "sh": 24.40}
# the outdoor config driven through the command line (phase 12)
OUTDOOR_CLI_ITERS = 20
# the JAX package's envmap quality recipe's result (docs/results_envmap_e2e.json;
# the recipe is egonerf_torch/tools/envmap_e2e.py's)
JAX_ENV_E2E_PSNR = 28.67
# the envmap scene of phases 9-11: the procedural scene's default views,
# its background at infinity
ENV_SCENE = dict(n_train=8, n_test=2, height=100, width=200, background="env")
# the TensoRF view of phase 14 (the quality recipe's test views' size), the
# bake's resolution cap, and the JAX package's tensorf result
# (docs/results_tensorf.json; the seed band was measured on EgoNeRF)
TF_IMAGE_HW = (500, 1000)
TF_MASK_RESO = 128
JAX_TENSORF_PSNR = 40.40
# the shader and line forms (phases 2, 7b, 8b, 15b): each form's switches
# (keyword arguments of shader_form), EgoNeRF's and TensoRF's, and the
# render chunks timed for each form
FORMS = (("default", {}), ("MIXED_MM", dict(mixed=True)), ("BIAS_DOT", dict(bias=True)),
         ("SPLIT_L1", dict(split=True)), ("HOIST_DIRS", dict(hoist=True)),
         ("LINE_HAT=0", dict(line_hat=False)),
         ("MIXED_MM+BIAS_DOT+HOIST_DIRS", dict(mixed=True, bias=True, hoist=True)))
TF_FORMS = (("default", {}), ("HOIST_DIRS", dict(hoist=True)), ("SPLIT_L1", dict(split=True)),
            ("BIAS_DOT", dict(bias=True)))
COMBINED = FORMS[-1]
FORM_CHUNKS = 7
# the empty-space cull (phases 2, 3c-8c): the JAX package's keeps at the
# production shape's 256 merged samples (BASELINE.md:223-262, 327-345), the
# training keep with its full step every 4, and a keep of the smoke run's
# 48 + 48
CULL_KEEPS = (192, 128)
CULL_TRAIN_KEEP, CULL_FULL_EVERY = 128, 4
SMOKE_KEEP = 64
# K10's checks at row counts off the production chunk: one short of it (a
# tail stage of 31 rows in db, 1-3 floats of a 150- or 135-float row past
# the bulk copies) and fewer rows than one stage
MM_ODD_ROWS = (1_048_575, 17)
# the captured-data path (phases 2, 19-21): K14 on a production batch of the
# Ricoh raster (1920x960), full and cropped to the roi of JAX's egocentric
# recipe, with the config default lambda over RICOH_FRAMES - RICOH_TEST
# images; its distribution over 2^24 draws within 6 binomial deviations;
# K15/K16 at the fine grid's shapes over one chunk's points
THETA_DRAWS = 4096
RICOH_WH = (1920, 960)
THETA_ROIS = ((0.0, 1.0, 0.0, 1.0), (0.05, 0.95, 0.0, 1.0))
THETA_LAMBDA = 5.0
THETA_IMAGES = 6
THETA_DIST_DRAWS = 1 << 24
THETA_SIGMA = 6.0
NOGRAD_POINTS = 1 << 20
NOGRAD_PLANE = (2, 172, 516, 16)
NOGRAD_LINE = (2, 516, 16)
# JAX's egocentric end-to-end recipe (tests/test_egocentric_e2e.py:67-104)
# and its floors.  JAX's test asserts > 10 dB at its default seed, but over
# seeds the recipe lands 9.18-10.03 dB in JAX and 8.82-10.47 in the port (60
# steps, CPU; tests/egocentric_seed_spread.py), so the port is held to
# EGO_E2E_FLOOR_DB, below each of them.  That floor only tells a trained
# field from an untrained one (5.72 dB): at 60 steps the recipe trained on
# pixels shuffled across the rays scores 9.42 dB and one constant colour
# 10.76.  So the recipe is also trained EGO_LONG_ITERS steps, where the
# field must beat the constant colour of the train frames' mean, measured
# in the run, by EGO_LONG_MARGIN_DB (shuffled pixels reach that colour and
# no more: 10.78 dB)
EGO_E2E_HW = (120, 240)
EGO_E2E_FLOOR_DB = 8.5
EGO_LONG_ITERS, EGO_LONG_MARGIN_DB = 600, 3.0
EGO_E2E = dict(roi=[0.05, 0.95, 0.0, 1.0], jax_psnr=10.0, config=dict(
    dataset_name="egocentric", model_name="EgoNeRF", coordinates_name="yinyang",
    exp_sampling=True, interval_th=True, r0="0.05", resampling=True, use_coarse_sample=True,
    localization_method="colmap", sampling_method="theta_importance",
    theta_importance_lambda=4.0, n_coarse=16, n_fine=16, batch_size=512, n_iters=60,
    N_voxel_init=24 ** 3, N_voxel_final=24 ** 3, n_lamb_sigma="[4,4,4]",
    n_lamb_sh="[8,8,8]", data_dim_color=12, shadingMode="MLP_Fea", fea2denseAct="softplus",
    density_shift="-8", featureC=32, view_pe=2, fea_pe=2, lr_init=0.02, lr_basis=1e-3,
    sparsity_lambda=0, near_far="[0.05, 9.0]", progress_refresh_rate=20,
    expname="ricoh_e2e", i_weights=10 ** 7, eval_chunk=512, steps_per_call=10))
# the shipped Ricoh and OmniBlender configs on synthesised captures: the
# frame counts are the only cut
RICOH_CONFIG = "configs/egonerf/ricoh/garden.txt"
RICOH_FRAMES, RICOH_TEST, RICOH_ITERS = 8, 2, 300
OMNI_CONFIG = "configs/egonerf/omniblender/archiviz-flat.txt"
OMNI_FRAMES, OMNI_TEST, OMNI_ITERS = 6, 2, 20
# phase 22: evaluation() of phase 21's scene in three forms, in the order
# EVAL_ORDER (the two forms with the metrics twice each, in turns), the
# trajectory's frames, and the LPIPS graph against the host's
EVAL_RUNS = (("PSNR alone, no images", dict(compute_extra_metrics=False, save_images=False,
                                            overlap=False)),
             ("every metric and the images, in turn", dict(overlap=False)),
             ("every metric and the images, overlapped", dict(overlap=True)))
EVAL_ORDER = (0, 1, 2, 2, 1)
PATH_FRAMES = 3
LPIPS_TOL = 1e-4
# phase 25 (and phase 2's rows of the losses' kernels): the three losses at
# the weights the port's trainer test names (tests/test_torch_train.py's
# PORTED), JAX's N_sparsity_points default; the switches of the three
LOSSES = dict(entropy_weight=1e-3, sparsity_lambda=0.1, use_depth=True,
              N_sparsity_points=10_000)
LOSS_SWITCHES = ("entropy_weight", "sparsity_lambda", "use_depth")
# K6's training instantiation against its plain version: alpha is the same
# float32 exp of the same products on both sides, its libraries' expf
ALPHA_TOL = 1e-6
# K6b's training instantiation at these sample counts (and the steps' 256)
K6B_ALPHA_SWEEP_S = (1, 33, 1536)
# phase 24: the production EgoNeRF upsampled from N_voxel 8e6 to the
# production grid after step 10; the host's resampling of the same grid in
# float32 (the same lerps of the same rows)
UPSAMPLE_FROM, UPSAMPLE_AT = 8_000_000, 10
UPSAMPLE_TOL = 1e-6
# phase 29: TensorVMSplit at the tensorf_mask_overrides widths on
# generic_sphere (exponential radius under interval_th, r0 0.03; N_voxel
# 256^3 gives [128, 254, 508]) on the indoor scene of phases 3-7
CHART_29 = dict(coordinates_name="generic_sphere", exp_sampling=True, interval_th=True,
                r0="0.03", near_far="[0.01, 15.0]")
# phase 30: the production EgoNeRF's shading modes, MLP_Fea first (the
# others are timed beside it), RGB at its three channels
SHADING_30 = (("MLP_Fea", {}), ("SH", {}), ("MLP_PE", {}), ("MLP", {}),
              ("RGB", dict(data_dim_color=3)))
# phase 31: the export's density grids
EXPORT_GRIDS = (128, 256)
# phase 33: the smoke config's steps on two gloo ranks and each worker's
# timeout
GLOO_STEPS, GLOO_TIMEOUT_S = 10, 300
# phases 32-33: a data-parallel run against a single-process one on the
# same draws.  K2's float32 atomics add in another order on every run, and
# Adam carries that through the steps, so two single-process runs part
# too: the data-parallel run (its parameters in relative L2 norm, the
# worst tensor, and its step MSEs) must stay within NOISE_FACTOR times
# what two single-process runs part by, or NOISE_FLOOR where they do not
# part (the shards' sums in another order)
NOISE_FACTOR, NOISE_FLOOR = 4.0, 1e-5
# phase 34: the profiled run's steps (the window opens at step 16 and holds
# PROFILE_TRACE_ITERS), and the kernels that every step of it launches
PROFILE_RUN_ITERS = 48
STEP_KERNELS = ("vm_lookup_kernel", "vm_field_bwd_kernel", "resample_kernel",
                "composite_kernel", "composite_bwd_kernel", "chart_kernel")
# phase 35: quality_run's refscale preset cut to REFSCALE_CUT_ITERS steps (the
# full 10k would not leave this script a margin in its time limit) on the
# full run's learning-rate schedule (lr_decay_iters 10000: the cut run is
# the full run's first steps; decaying over 3000 instead gave 35.12 dB);
# its floor is the first reading of this phase's own cut run (H100 80GB HBM3
# at 700 W; a second run read 39.372 dB) less the JAX package's seed spread
# (docs/results_seed_variance.json: 2.445 dB)
REFSCALE_CUT_ITERS = 3000
REFSCALE_CUT_PSNR = 39.626
SEED_SPREAD_DB = 2.445
# eval_bench's keeps (the oracle row 192o) and occ_probe's budgets
EVAL_BENCH_KEEPS = ("0", "192", "128", "192o")
OCC_BUDGETS = (32, 64, 96, 128, 192)
# phase 37: real_data_run on scenes written here at the loaders' full frame
# sizes (scene, collection layout, frame (h, w)); the frame counts (REAL_TEST
# of them test views) and the iterations are the only cuts of the shipped
# configs
REAL_SCENES = (("barbershop", "omniblender", IMAGE_HW), ("garden", "ricoh", RICOH_WH[::-1]))
REAL_FRAMES = {"barbershop": 6, "garden": 8}
REAL_TEST, REAL_ITERS = 2, 20
# phase 38: cull_ab at sampler_ab's production shape, keep 128 with an
# unculled step every 4 (JAX's `--full_every=4` record), cut to 40 of its
# 3000 steps with an evaluation every 20 (the only cuts)
CULL_AB_KEEP, CULL_AB_EVERY, CULL_AB_ITERS, CULL_AB_VIS = 128, 4, 40, 20
# phase 39: the upstream chart class a pickled EgoNeRF checkpoint names (its
# kwargs["coordinates"]), with the attributes the import reads
UPSTREAM_COORDINATES = '''"""Stand-in of the upstream models/coordinates.py: the chart class
an EgoNeRF checkpoint pickles."""


class YinYangSphericalCoords:
    def __init__(self, device, aabb, exp_r=False, N_voxel=None, r0=None, interval_th=False):
        self.device = device
        self.aabb = aabb
        self.exp_r = exp_r
        self.N_voxel = N_voxel
        self.r0 = r0
        self.interval_th = interval_th
'''
# and the global_step its checkpoint stores
UPSTREAM_STEP = 30000


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def time_ms(fn, reps: int = 20) -> float:
    """Device time of one ``fn`` call, after one warm run: the mean of
    ``reps`` back-to-back calls queued behind a device-side sleep, so the
    host's launch work stays outside the two events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_cold_ms(fn, reps: int = 10) -> float:
    """Device time of one ``fn`` call with a cold L2: before each call a
    read of FLUSH_BYTES evicts what the last one left; the events bracket
    the call alone, all queued behind a device-side sleep."""
    flush = torch.zeros(FLUSH_BYTES // 4, device=DEVICE)
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in events:
        flush.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes: float, n_ops: float, peak_ops: float = PEAK_F32_OPS_PER_S):
    b = n_bytes / PEAK_BYTES_PER_S * 1e3
    o = n_ops / peak_ops * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def max_err(outs, refs):
    """(max abs error, max abs error / max |ref|) over matching outputs."""
    abs_err = rel = 0.0
    for o, r in zip(outs, refs):
        if not r.numel():  # an empty output (K17's density-only appearance)
            continue
        e = float((o - r).abs().max())
        abs_err = max(abs_err, e)
        rel = max(rel, e / max(float(r.abs().max()), 1e-30))
    return abs_err, rel


def profile(run, n: int, label: str, unit: str, top: int = 12) -> dict:
    """Device time by kernel over ``run()`` (``n`` units of work), the
    share of the wall time the device was busy (under the profiler's
    overhead), and the device operations (kernels, copies, sets) a unit.
    Returns {kernel name: device ms a unit} ({} when the profiler saw no
    device time)."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    # a user annotation's device row (Adam's "Optimizer.step#Adam.step")
    # spans kernels that have rows of their own: it would count them twice
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(ms for _, ms, _ in rows)
    if not rows:
        print(f"{label} profile: the profiler recorded no device time (not measured)",
              flush=True)
        return {}
    print(f"{label} profile over {n} {unit}s: device busy {busy_ms:.3f} ms of "
          f"{wall_ms:.3f} ms wall ({busy_ms / wall_ms:.1%}), {busy_ms / n:.3f} "
          f"ms/{unit} on the device, {sum(c for *_, c in rows) / n:.1f} device operations "
          f"a {unit}", flush=True)
    for name, ms, count in sorted(rows, key=lambda r: -r[1])[:top]:
        print(f"{label}   {ms / n:9.4f} ms/{unit} {ms / busy_ms:6.1%} "
              f"x{count // n:<3d} {name[:90]}", flush=True)
    # the port's kernels inside the run, where the L2 holds what the
    # preceding kernels left (phase 2 runs each back to back)
    for name, ms, count in rows:
        if any(f"::{k}" in name or name.startswith(k) for k in PORT_KERNELS):
            print(f"{label} in the run: {ms / count:.4f} ms/launch x{count} "
                  f"{name[:60]}", flush=True)
    return {name: ms / n for name, ms, _ in rows}


def k2_share(label: str, rows: dict, step_ms: float) -> None:
    """K2's device time a step from a profile's rows, and its share of the
    step's device time and of the median step."""
    busy = sum(rows.values())
    k2 = sum(ms for name, ms in rows.items() if "vm_field_bwd_kernel" in name)
    if busy:
        print(f"{label} K2 in the step: {k2:.4f} ms a step, {k2 / busy:.1%} of the step's "
              f"device time, {k2 / step_ms:.1%} of the median step ({step_ms:.3f} ms)",
              flush=True)


def check_close(name: str, tol_desc: str, ok: bool, abs_err: float, rel_err: float):
    print(f"phase 2 {name}: max abs err {abs_err:.3e}, max rel err {rel_err:.3e} "
          f"({tol_desc}) -> {'ok' if ok else 'MISS'}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")


class Recorder:
    """A kernel wrapper that keeps the arguments of its last call."""

    def __init__(self, fn):
        self.fn, self.args, self.kwargs = fn, None, {}

    def __call__(self, *args, **kwargs):
        self.args, self.kwargs = args, kwargs
        return self.fn(*args, **kwargs)


class CallLog:
    """A kernel wrapper that keeps the arguments of every call (a
    Recorder keeps only the last: a bake calls its lookups slab by slab)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kwargs):
        self.calls.append(args)
        return self.fn(*args, **kwargs)


def kernel_row(name, source, replaces, abs_err, ms, plain_ms, n_bytes, n_ops,
               library_ms=None, peak_ops=PEAK_F32_OPS_PER_S) -> dict:
    bound_ms, bound_by = bound(n_bytes, n_ops, peak_ops)
    lib = "" if library_ms is None else f", library call {library_ms:.4f} ms"
    print(f"phase 2 {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib}, bound "
          f"{bound_ms:.4f} ms ({bound_by}, {n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.3f} Gop)",
          flush=True)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def check_case(name, source, replaces, kern, plain, args, n_bytes, n_ops, abs_tol=None,
               tol_desc=None, cold=False) -> dict:
    """One kernel against its plain version on ``args``: same shapes, finite,
    within rel REL_TOL of max|plain| (or ``abs_tol``); then its row with
    both times (and, with ``cold``, the kernel's cold-L2 time printed)."""
    with torch.no_grad():
        out, ref = kern(*args), plain(*args)
    torch.cuda.synchronize()
    out = out if isinstance(out, tuple) else (out,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for o, r in zip(out, ref):
        if o.shape != r.shape:
            fail(f"{name}: shape {tuple(o.shape)} != plain {tuple(r.shape)}")
        if not torch.isfinite(o).all():
            fail(f"{name}: non-finite output")
    abs_err, rel_err = max_err(out, ref)
    if abs_tol is None:
        ok, tol_desc = rel_err <= REL_TOL, f"rel <= {REL_TOL:.0e} of max|plain|"
    else:
        ok = abs_err <= abs_tol
    check_close(name, tol_desc, ok, abs_err, rel_err)
    row = kernel_row(name, source, replaces, abs_err, time_ms(lambda: kern(*args)),
                     time_ms(lambda: plain(*args), reps=5), n_bytes, n_ops)
    if cold:
        print(f"phase 2 {name}: kernel {time_cold_ms(lambda: kern(*args)):.4f} ms with a cold "
              f"L2 ({FLUSH_BYTES >> 20} MB read before each call), {row['ms']:.4f} ms warm",
              flush=True)
    return row


def k2_compare(name, args, ops, kw=None) -> float:
    """K2 against its plain version: per cell |kernel - plain| <= K2_TOL *
    sum|terms| (float32 atomics add in another order), the plain version's
    float32 terms summed in float64 (its float32 index_add rounds by up to
    ~3e-4 of the terms where a million samples hit one cell); the float32
    plain version's error is printed beside.  ``kw`` goes to both (the
    relu-free form's).  Returns the max abs error."""
    kw = kw or {}
    got = ops.KERNELS.field_bwd(*args, **kw)
    ref = ops.PLAIN.field_bwd(*args, accumulate=torch.float64, **kw)
    ref32 = ops.PLAIN.field_bwd(*args, **kw)
    mag = ops.PLAIN.field_bwd(*args, magnitude=True, accumulate=torch.float64, **kw)
    torch.cuda.synchronize()
    return per_cell_check(name, got[0] + got[1], ref[0] + ref[1], ref32[0] + ref32[1],
                          mag[0] + mag[1])


def per_cell_check(name, got, ref, ref32, mag) -> float:
    """A scatter kernel's tables against its plain version's float32 terms
    summed in float64 (``ref``; ``ref32`` in float32, ``mag`` their
    magnitudes): per cell |kernel - plain| <= K2_TOL * sum|terms|; the
    float32 plain version's error is printed beside.  Returns the max abs
    error."""
    worst = worst32 = abs_err = 0.0
    for g, r, r32, m in zip(got, ref, ref32, mag):
        if not torch.isfinite(g).all():
            fail(f"{name}: non-finite gradient")
        d = (g.double() - r).abs()
        abs_err = max(abs_err, float(d.max()))
        worst = max(worst, float((d / (m + 1e-30)).max()))
        worst32 = max(worst32, float(((g.double() - r32.double()).abs() / (m + 1e-30)).max()))
    check_close(name, f"per cell <= {K2_TOL:.0e} x sum|terms| of the float64-summed plain; "
                f"{worst32:.2e} against the float32 plain", worst <= K2_TOL, abs_err, worst)
    return abs_err


def k2_adversarial(args):
    """K2's two hard inputs from one recorded call, every sample's
    cotangents and mask kept: all samples at one point (one plane cell and
    one line row each: the longest runs, the hottest shared rows), and the
    samples shuffled (no ray structure, so no runs)."""
    coords, planes, lines, d_dens, d_app, mask, *rest = args
    n = coords.shape[0]
    one = coords[n // 2].expand(n, 4).contiguous()
    perm = torch.randperm(n, generator=torch.Generator(device=coords.device).manual_seed(SEED),
                          device=coords.device)
    return (("one cell", (one, planes, lines, d_dens, d_app, mask, *rest)),
            ("shuffled", (coords[perm].contiguous(), planes, lines, d_dens[perm].contiguous(),
                          d_app[perm].contiguous(), mask[perm].contiguous(), *rest)))


def check_field_bwd(name, args, ops, adversarial=False, kw=None) -> dict:
    """K2 against its plain version (:func:`k2_compare`), its layout, its
    row with a cold-L2 time printed, and with ``adversarial`` the same on
    :func:`k2_adversarial`'s inputs; ``kw`` goes to every call (the
    relu-free form's)."""
    from egonerf_torch.ops import vm_lookup

    kw = kw or {}
    coords, planes, lines, d_dens, d_app, mask, n_density = args[:7]
    layout = vm_lookup._bwd_layout_of(coords, planes, lines, n_density, d_app)
    print(f"phase 2 {name}: bwd_layout {layout.group} lanes a sample, "
          f"{'vector' if layout.vector else 'scalar'}", flush=True)
    abs_err = k2_compare(name, args, ops, kw)
    n_ch = sum(p.shape[-1] for p in planes)
    row = kernel_row(
        name, "egonerf_torch/csrc/vm_lookup.cu", "egonerf_tpu/ops/vm_lookup.py:482", abs_err,
        time_ms(lambda: ops.KERNELS.field_bwd(*args, **kw)),
        time_ms(lambda: ops.PLAIN.field_bwd(*args, **kw), reps=5),
        nbytes(coords, *planes, *lines, d_dens, d_app, *([] if mask is None else [mask]))
        + sum(4 * t.numel() for t in planes + lines),
        # per sample and channel: plane (7) and line (3) recomputed, dp and
        # dl, 4 + 2 weighted contributions
        coords.shape[0] * n_ch * 18)
    cold = time_cold_ms(lambda: ops.KERNELS.field_bwd(*args, **kw))
    print(f"phase 2 {name}: kernel {cold:.4f} ms with a cold L2 ({FLUSH_BYTES >> 20} MB read "
          f"before each call), {row['ms']:.4f} ms warm", flush=True)
    if adversarial:
        for label, a in k2_adversarial(args):
            k2_compare(f"{name}, {label}", a, ops)
            print(f"phase 2 {name}, {label}: kernel "
                  f"{time_ms(lambda: ops.KERNELS.field_bwd(*a)):.4f} ms", flush=True)
    return row


def lane_order_mask(coords, planes, lines, n_density, line_hat):
    """The relu mask K1 must write: the state of each density partial
    summed in K1's lane order from the plain products (which K1's equal
    bit for bit)."""
    from egonerf_torch.ops import vm_lookup as vm

    xyz = coords[:, :3]
    sel = vm.chart_sel(coords, planes[0].shape[0])
    mask = torch.zeros(coords.shape[0], dtype=torch.uint8, device=coords.device)
    for i in range(3):
        m0, m1 = vm.MAT_MODE[i]
        line_fn = vm.sample_line_hat if line_hat[i] else vm.sample_line
        prod = (vm.sample_plane(planes[i], xyz[:, m0], xyz[:, m1], sel)
                * line_fn(lines[i], xyz[:, vm.VEC_MODE[i]], sel))
        mask |= vm.relu_states(vm._warp_order_sum(prod[:, :n_density[i]])) << (2 * i)
    return mask


def check_relu_mask(name, args, ops) -> None:
    """K1's training instantiation: density and appearance as the eval one
    writes them, and the relu mask equal to :func:`lane_order_mask` on
    every sample; both instantiations' times."""
    with torch.no_grad():
        dens, app, mask = ops.KERNELS.field(*args, with_mask=True)
        want_d, want_a = ops.KERNELS.field(*args)
        want_m = lane_order_mask(*args)
    torch.cuda.synchronize()
    flips = int((mask != want_m).sum())
    ties = int(sum(((want_m >> (2 * i)) & 3 == 1).sum() for i in range(3)))
    same = torch.equal(dens, want_d) and torch.equal(app, want_a)
    ok = flips == 0 and same
    print(f"phase 2 {name}: mask differs on {flips} of {mask.numel():,} samples ({ties:,} "
          f"exact-zero partials), density and appearance "
          f"{'equal' if same else 'NOT equal'} to the eval instantiation's -> "
          f"{'ok' if ok else 'MISS'}; kernel "
          f"{time_ms(lambda: ops.KERNELS.field(*args, with_mask=True)):.4f} ms with the mask, "
          f"{time_ms(lambda: ops.KERNELS.field(*args)):.4f} ms without", flush=True)
    if not ok:
        fail(f"{name} disagrees with the lane-order mask or the eval instantiation")


def width_checks(ops) -> None:
    """Phase 2, K1, K3 and K2 at the widths of WIDTHS on stacks of two grids
    and of one, each against its plain version (rel REL_TOL; K2 per cell)
    on random bf16 tables and samples from SEED; K1 also with float32 line
    weights (off the hat gate)."""
    from egonerf_torch.ops import vm_lookup

    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    gs = WIDTH_GRID
    n = WIDTH_SAMPLES
    src, vm = "egonerf_torch/csrc/vm_lookup.cu", "egonerf_tpu/ops/vm_lookup.py"
    for s in (2, 1):
        xyz = torch.rand(n, 3, generator=g, device=DEVICE) * 2.1 - 1.05
        flag = torch.randint(0, s, (n, 1), generator=g, device=DEVICE).float()
        coords = torch.cat([xyz, flag], dim=-1).contiguous()
        for label, c, cd in WIDTHS:
            planes = [(0.1 * torch.randn(s, gs[vm_lookup.MAT_MODE[i][1]],
                                         gs[vm_lookup.MAT_MODE[i][0]], c, generator=g,
                                         device=DEVICE)).to(torch.bfloat16) for i in range(3)]
            lines = [(0.1 * torch.randn(s, gs[vm_lookup.VEC_MODE[i]], c, generator=g,
                                        device=DEVICE)).to(torch.bfloat16) for i in range(3)]
            n_app = 3 * (c - cd)
            n_ch = 3 * c
            layout = vm_lookup.lookup_layout(coords, planes, lines, n_app)
            tag = (f"C={c}/{cd} S={s} ({label}: {layout.group} lanes a sample, "
                   f"{'vector' if layout.vector else 'scalar'})")
            for hat in (True, False):
                check_case(f"K1 field_fwd {tag}{'' if hat else ' f32 lines'}", src, f"{vm}:467",
                           ops.KERNELS.field, ops.PLAIN.field,
                           (coords, planes, lines, (cd,) * 3, (hat,) * 3),
                           nbytes(coords, *planes, *lines) + n * (1 + n_app) * 4, n * n_ch * 11)
            check_case(f"K3 density_fwd {tag}", src, f"{vm}:436", ops.KERNELS.density,
                       ops.PLAIN.density, (coords, planes, lines),
                       nbytes(coords, *planes, *lines) + n * 4, n * n_ch * 11)
            check_relu_mask(f"K1 relu mask {tag}", (coords, planes, lines, (cd,) * 3, (True,) * 3),
                            ops)
            d_dens = torch.randn(n, generator=g, device=DEVICE)
            d_app = torch.randn(n, n_app, generator=g, device=DEVICE)
            # each decomposition's state drawn from {0, 1, 2}: the tie's
            # half gradient on a third of the samples
            mask = sum(torch.randint(0, 3, (n,), generator=g, device=DEVICE, dtype=torch.uint8)
                       << (2 * i) for i in range(3)).to(torch.uint8)
            check_field_bwd(f"K2 field_bwd {tag}",
                            (coords, planes, lines, d_dens, d_app, mask, (cd,) * 3, (True,) * 3),
                            ops)
            check_field_bwd(f"K2 field_bwd {tag} line mode 2",
                            (coords, planes, lines, d_dens, d_app, mask, (cd,) * 3,
                             (vm_lookup.LINEAR_BF16_GRAD,) * 3), ops)


def expect_launches(label: str, launches: dict, want: dict) -> None:
    if launches != want:
        fail(f"{label} launch counts {launches}, expected {want}")


def check_chart(name: str, ops, args) -> float:
    """K7 against its plain version: the chart flag on every sample, the
    coords within K7_TOL; returns the max abs error."""
    got, ref = ops.KERNELS.chart(*args), ops.PLAIN.chart(*args)
    torch.cuda.synchronize()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        fail(f"{name}: shape {tuple(got.shape)} (plain {tuple(ref.shape)}) or non-finite")
    flips = int((got[:, 3] != ref[:, 3]).sum())
    col_err = (got - ref).abs().amax(dim=0).tolist()
    abs_err = max(col_err)
    ok = flips == 0 and abs_err <= K7_TOL
    print(f"phase 2 {name}: {got.shape[0]:,} samples, chart flag differs on {flips}, "
          f"{int(ref[:, 3].sum()):,} yang; max abs err {abs_err:.3e} (r {col_err[0]:.1e}, "
          f"theta {col_err[1]:.1e}, phi {col_err[2]:.1e}; {int((got != ref).any(1).sum()):,} "
          f"samples differ at all) (flags identical, abs <= {K7_TOL:.0e}) -> "
          f"{'ok' if ok else 'MISS'}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return abs_err


def chart_cost(rays_o, z, n_grid):
    """K7's bytes (the rays' origins and directions, the depths and the
    radial grid read once, the coords written once) and float32 operations
    (~170 a sample: two acos, two atan2, the sqrt, the search and the
    normalization)."""
    n = z.numel()
    return rays_o.shape[0] * 24 + n * 4 + n_grid * 4 + n * 16, n * 170


def k4_cost(c_feat, n_f, n_out, n_grid=None):
    """K4's bytes at eval (c_feat, the coarse depths and dists read once,
    z_vals and dists written once; with the chart epilogue also the rays'
    origins and directions and the radial grid of ``n_grid`` entries read,
    the coords written) and float32 operations (a ray's weights and pdf,
    ~12 a coarse sample; a draw's search and bracket; the merge and the
    dists, 2 a merged sample; the chart, ~170 a merged sample)."""
    r, s = c_feat.shape
    n_bytes = 3 * r * s * 4 + 2 * r * n_out * 4
    n_ops = r * (12 * s + n_f * (int(np.log2(s)) + 8) + 2 * n_out)
    if n_grid is not None:
        n_bytes += r * 24 + n_grid * 4 + r * n_out * 16
        n_ops += r * n_out * 170
    return n_bytes, n_ops


def k4_compare(name, ops, args, far, rays=None) -> float:
    """K4 against its plain version on ``args``: z_vals and dists within
    1e-5 x far (float32 sums in another order move a draw by a few ulps of
    far).  With ``rays`` = (rays_o, viewdirs, coords) the fused op: its
    coords equal to K7's on the kernel's own z_vals bit for bit (both take
    the chart from csrc/chart.cuh), so every flag too, and within K7_TOL
    of the plain chart of those depths with every flag equal.  Returns the
    max abs error of the depths."""
    tol = REL_TOL * far
    got = (ops.pdf.resample(*args) if rays is None
           else ops.KERNELS.resample_chart(*args, *rays))
    ref = ops.pdf.resample_plain(*args)
    torch.cuda.synchronize()
    for o, r in zip(got, ref):
        if o.shape != r.shape or not torch.isfinite(o).all():
            fail(f"{name}: shape {tuple(o.shape)} (plain {tuple(r.shape)}) or non-finite")
    abs_err = max_err(got[:2], ref)[0]
    ok, msg = abs_err <= tol, ""
    if rays is not None:
        norm = got[2]
        k7 = ops.KERNELS.chart(*rays[:2], got[0], rays[2])
        plain = ops.PLAIN.chart(*rays[:2], got[0], rays[2])
        torch.cuda.synchronize()
        if norm.shape != k7.shape or not torch.isfinite(norm).all():
            fail(f"{name}: coords {tuple(norm.shape)} (K7 {tuple(k7.shape)}) or non-finite")
        bits = int((norm.view(torch.int32) != k7.view(torch.int32)).any(1).sum())
        flips = int((norm[:, 3] != plain[:, 3]).sum())
        c_err = float((norm - plain).abs().max())
        ok = ok and bits == 0 and flips == 0 and c_err <= K7_TOL
        msg = (f"; coords: {bits} of {norm.shape[0]:,} samples differ from K7's on the same "
               f"depths (0 allowed), chart flag differs from the plain chart's on {flips}, "
               f"max abs {c_err:.3e} (<= {K7_TOL:.0e})")
    print(f"phase 2 {name}: max abs err {abs_err:.3e} (abs <= {tol:.1e}, 1e-5 x far){msg} -> "
          f"{'ok' if ok else 'MISS'}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return abs_err


def k4_hard_inputs(c_feat, coarse_z, n_f, act, u):
    """K4's hard rays, from the chunk's first 1024: [(label, c_feat,
    coarse_z, coarse_dists, u)].  Zero density (every weight 0, the pdf at
    its 1e-5 floor: near-degenerate brackets); one spike (one coarse
    sample holds the ray); every coarse depth twice (the bin edges equal
    coarse depths, so draws at t = 0 tie with them); u near 1 (1 - k 2^-24,
    at and past cdf[-1]); u on the cdf's edges (the bracket's own ends);
    u reversed (draws out of order: the kernel's full-rank merge)."""
    from egonerf_torch.models.egonerf import _dists
    from egonerf_torch.ops import pdf, volrend

    r = min(1024, c_feat.shape[0])
    dev = c_feat.device
    f, z = c_feat[:r].contiguous(), coarse_z[:r].contiguous()
    d = _dists(z)
    s = f.shape[1]
    zero = torch.full_like(f, -1e4)  # softplus(-1e4 - 8) is 0
    spike = zero.clone()
    at = torch.randint(1, s - 1, (r,), generator=torch.Generator(device=dev).manual_seed(SEED),
                       device=dev)
    spike[torch.arange(r, device=dev), at] = 30.0
    z_rep = z[:, ::2].repeat_interleave(2, dim=1)[:, :s].contiguous()
    near_one = (1.0 - torch.arange(n_f - 1, -1, -1, device=dev, dtype=torch.float32)
                * 2.0 ** -24).expand(r, n_f).contiguous()
    sigma = volrend.density_activation(f, *act[::2])
    alpha = volrend.raw2alpha(sigma, d * act[1])[0]
    cdf = pdf._warp_cdf(pdf._warp_weights(alpha)[:, 1:-1])
    pick = torch.arange(n_f, device=dev) * (cdf.shape[1] - 1) // max(n_f - 1, 1)
    edges = cdf[:, pick].contiguous()
    return [("zero density", zero, z, d, None), ("one spike", spike, z, d, None),
            ("repeated coarse depths", f, z_rep, _dists(z_rep), None),
            ("u near 1", f, z, d, near_one), ("u on the cdf's edges", f, z, d, edges),
            ("u reversed", f, z, d, u[:r].flip(1).contiguous())]


def k4_checks(label, ops, args, far, rays) -> None:
    """K4 with and without its chart epilogue on ``args`` (the inputs of a
    chunk or of a recorded step): each against its plain version, and the
    fused launch timed against K4 and K7 launched apart."""
    k4_compare(f"K4 resample ({label})", ops, args, far)
    k4_compare(f"K4 resample + chart ({label})", ops, args, far, rays)
    fused = time_ms(lambda: ops.KERNELS.resample_chart(*args, *rays))
    apart = time_ms(lambda: ops.pdf.resample(*args))
    z_vals = ops.pdf.resample(*args)[0]
    k7 = time_ms(lambda: ops.KERNELS.chart(*rays[:2], z_vals, rays[2]))
    print(f"phase 2 K4 ({label}): fused with the fine chart {fused:.4f} ms; apart K4 "
          f"{apart:.4f} + K7 {k7:.4f} = {apart + k7:.4f} ms", flush=True)


def render_kernel_checks(model, params, dirs, ops, presets, dists_of) -> dict:
    """Phase 2, render path: K1, K3, K4 (with and without its fine-chart
    epilogue), K6, K7 on one production chunk."""
    dev = dirs.device
    cfg, coords = model.cfg, model.coordinates
    n_view = dirs.shape[0]
    chunk = presets.EVAL_CHUNK
    n_c, n_f = presets.RENDER["n_coarse"], presets.RENDER["n_fine"]
    pick = torch.arange(chunk, device=dev) * (n_view // chunk)  # spread over the view
    viewdirs = dirs[pick]
    rays_o = torch.zeros_like(viewdirs)
    ray_dz = viewdirs[:, 2].contiguous()
    tables = model.lookup_tables(params)
    coarse_z = model.sample_depths_exp(chunk, n_c, dev)
    coarse_dists = dists_of(coarse_z)
    c_norm = ops.PLAIN.chart(rays_o, viewdirs, coarse_z, coords, 2)
    c_feat = ops.PLAIN.density(c_norm, tables.coarse_planes, tables.coarse_lines)
    c_feat = c_feat.reshape(chunk, n_c)
    act = (cfg.density_shift, cfg.distance_scale, cfg.fea2dense_act)
    z_vals, dists = ops.pdf.resample_plain(c_feat, coarse_z, coarse_dists, n_f, None, True,
                                           *act)
    f_norm = ops.PLAIN.chart(rays_o, viewdirs, z_vals, coords)
    hat = model._line_hat(tables.fine_lines, f_norm.shape[0])
    feat, app_feat = model.compute_field(params, f_norm, tables)
    feat = feat.reshape(chunk, -1)
    rgb = model.shader.apply_params(params, "shader.", viewdirs[:, None, :].expand(
        chunk, z_vals.shape[1], 3), app_feat.reshape(chunk, z_vals.shape[1], -1))
    n_s = z_vals.shape[1]
    print(f"phase 2 inputs: {chunk} rays, {c_norm.shape[0]:,} coarse and "
          f"{f_norm.shape[0]:,} fine samples; line hat path {hat}", flush=True)

    cases = [
        ("K1 field_fwd", "egonerf_torch/csrc/vm_lookup.cu",
         "egonerf_tpu/ops/vm_lookup.py:467", ops.KERNELS.field, ops.PLAIN.field,
         (f_norm, tables.fine_planes, tables.fine_lines, cfg.density_n_comp, hat),
         nbytes(f_norm, *tables.fine_planes, *tables.fine_lines)
         + f_norm.shape[0] * (1 + sum(cfg.app_n_comp)) * 4,
         f_norm.shape[0] * sum(p.shape[-1] for p in tables.fine_planes) * 11),
        ("K3 density_fwd", "egonerf_torch/csrc/vm_lookup.cu",
         "egonerf_tpu/ops/vm_lookup.py:436", ops.KERNELS.density, ops.PLAIN.density,
         (c_norm, tables.coarse_planes, tables.coarse_lines),
         nbytes(c_norm, *tables.coarse_planes, *tables.coarse_lines) + c_norm.shape[0] * 4,
         c_norm.shape[0] * sum(p.shape[-1] for p in tables.coarse_planes) * 11),
        ("K6 composite", "egonerf_torch/csrc/composite.cu",
         "egonerf_tpu/ops/volrend.py:11", ops.KERNELS.composite, ops.PLAIN.composite,
         (feat, dists, z_vals, rgb, ray_dz, *act),
         nbytes(feat, dists, z_vals, rgb, ray_dz) + chunk * 6 * 4,
         chunk * n_s * 20),
    ]
    table = {}
    for case in cases:
        table[case[0].split()[0]] = check_case(*case, cold=case[0].startswith(("K1", "K3")))

    # K4 on the chunk with and without its fine-chart epilogue, on the
    # column slices of the (R, 6) rays as the model passes them; then on K5's
    # sorted uniforms (the training draws), without the merge, at the smoke
    # config's 48 + 48 samples, and on the hard rays
    rays = torch.cat([rays_o, viewdirs], dim=-1)
    n_grid = coords.ref_grid.shape[0]
    far = model.near_far[1]
    fine_rays = (rays[:, :3], rays[:, 3:6], coords)
    args = (c_feat, coarse_z, coarse_dists, n_f, None, True, *act)
    k4_checks("eval chunk", ops, args, far, fine_rays)
    u = ops.KERNELS.sorted_uniform(chunk, n_f, SEED, 0, dev)
    k4_compare("K4 resample + chart (sorted uniforms)", ops,
               (c_feat, coarse_z, coarse_dists, n_f, u, True, *act), far, fine_rays)
    k4_compare("K4 resample + chart (no merge)", ops,
               (c_feat, coarse_z, coarse_dists, n_f, None, False, *act), far, fine_rays)
    z48 = model.sample_depths_exp(chunk, 48, dev)
    f48 = ops.KERNELS.density(ops.KERNELS.chart(rays[:, :3], rays[:, 3:6], z48, coords, 2),
                              tables.coarse_planes, tables.coarse_lines).reshape(chunk, 48)
    u48 = ops.KERNELS.sorted_uniform(chunk, 48, SEED, 1, dev)
    for label, u_in in (("48 + 48, eval", None), ("48 + 48, sorted uniforms", u48)):
        k4_compare(f"K4 resample + chart ({label})", ops,
                   (f48, z48, dists_of(z48), 48, u_in, True, *act), far, fine_rays)
    for label, f_h, z_h, d_h, u_h in k4_hard_inputs(c_feat, coarse_z, n_f, act, u):
        r_h = f_h.shape[0]
        h_args = (f_h, z_h, d_h, n_f, u_h, True, *act)
        k4_compare(f"K4 resample ({label})", ops, h_args, far)
        k4_compare(f"K4 resample + chart ({label})", ops, h_args, far,
                   (rays[:r_h, :3], rays[:r_h, 3:6], coords))
        z_p = ops.pdf.resample_plain(*h_args)[0]
        fine_p = ops.pdf.resample_plain(f_h, z_h, d_h, n_f, u_h, False, *act)[0]
        print(f"phase 2 K4 ({label}): {int((fine_p[:, 1:] < fine_p[:, :-1]).any(1).sum())} "
              f"of {r_h} rays' plain draws out of order (the kernel's full-rank merge), "
              f"{int((z_p[:, 1:] == z_p[:, :-1]).sum()):,} equal neighbours in the merged "
              f"depths", flush=True)
    # the row: the fused launch the forward makes, its bytes with the coords
    table["K4"] = kernel_row(
        "K4 resample + fine chart", "egonerf_torch/csrc/resample.cu",
        "egonerf_tpu/ops/pdf.py:14",
        k4_compare("K4 resample + chart (row)", ops, args, far, fine_rays),
        time_ms(lambda: ops.KERNELS.resample_chart(*args, *fine_rays)),
        time_ms(lambda: ops.PLAIN.resample_chart(*args, *fine_rays), reps=5),
        *k4_cost(c_feat, n_f, n_s, n_grid=n_grid))
    print(f"phase 2 K4 resample + fine chart: kernel "
          f"{time_cold_ms(lambda: ops.KERNELS.resample_chart(*args, *fine_rays)):.4f} ms with a "
          f"cold L2 ({FLUSH_BYTES >> 20} MB read before each call)", flush=True)

    # K7, the coarse (downsample 2) and the fine chart of the chunk
    errs, times = [], {}
    for label, z, ds in (("coarse", coarse_z, 2), ("fine", z_vals, None)):
        args = (rays[:, :3], rays[:, 3:6], z, coords, ds)
        errs.append(check_chart(f"K7 chart {label}", ops, args))
        times[label] = (time_ms(lambda: ops.KERNELS.chart(*args)),
                        time_ms(lambda: ops.PLAIN.chart(*args), reps=5))
        n_bytes, n_ops = chart_cost(rays, z, n_grid)
        b_ms, b_by = bound(n_bytes, n_ops)
        print(f"phase 2 K7 chart {label}: kernel {times[label][0]:.4f} ms, plain "
              f"{times[label][1]:.4f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
    # the closed-form exponential cells (the configs without interval_th),
    # and a linear radius (a chart without exp_r)
    for label, exp_r, ds in (("exp cells, downsample 2", True, 2),
                             ("exp cells", True, None), ("linear r", False, None)):
        other = type(coords)(coords.aabb, exp_r=exp_r, N_voxel=presets.N_VOXEL, r0=coords.r0,
                             interval_th=False)
        check_chart(f"K7 chart {label}", ops, (rays[:, :3], rays[:, 3:6], z_vals, other, ds))
    # the row: the coarse chart, the one the forward launches K7 for
    table["K7"] = kernel_row("K7 chart (coarse)", "egonerf_torch/csrc/chart.cu",
                             "egonerf_tpu/coords/yinyang.py:47", max(errs), *times["coarse"],
                             *chart_cost(rays, coarse_z, n_grid))
    c_args = (rays[:, :3], rays[:, 3:6], coarse_z, coords, 2)
    print(f"phase 2 K7 chart (coarse): kernel "
          f"{time_cold_ms(lambda: ops.KERNELS.chart(*c_args)):.4f} ms with a cold L2", flush=True)
    return table


def drawn_u(ops, args, draw, ray0: int = 0) -> tuple:
    """K4's or K4c's arguments ``args`` (u None) with K5's uniforms for the
    ``draw`` key (seed, step) at the ray offset ``ray0`` as u: the launches
    that the training instantiation's prologue replaces."""
    u = ops.KERNELS.sorted_uniform(args[0].shape[0], args[3], *draw, args[0].device, ray0=ray0)
    return (*args[:4], u, *args[5:])


def draw_equal(name, ops, op, args, draw, rays=(), ray0: int = 0) -> None:
    """``op`` (K4's ``resample_chart`` with ``rays``, or K4c's
    ``resample_score``) with the ``draw`` key at the ray offset ``ray0`` on
    ``args`` (u None) against K5 at that offset followed by ``op`` on its
    uniforms: every output (z_vals, dists, and the coords or the scores)
    bit for bit."""
    got = op(*args, *rays, draw=draw, ray0=ray0)
    want = op(*drawn_u(ops, args, draw, ray0), *rays)
    torch.cuda.synchronize()
    diff = bits_differ(got, want)
    print(f"phase 2 {name}: {diff} of {sum(w.numel() for w in want):,} outputs differ from K5 "
          f"then the same op on its uniforms (bit for bit) -> {'ok' if diff == 0 else 'MISS'}",
          flush=True)
    if diff:
        fail(f"{name}: the draw in the prologue differs from K5's")


def offset_draw_checks(ops, args, rays, draw, far) -> None:
    """Phase 2, the ray offset of a data-parallel shard: K5 at each of
    DRAW_OFFSETS against its plain version (K5_TOL) and, at the offsets
    inside the batch, bit for bit against the rows of its draw from ray 0;
    K4's and K4c's training instantiations at an offset against their plain
    versions at it (K4's limit); and each timed at the offset against
    offset 0, in turns (0, offset, offset, 0)."""
    c_feat, n_f = args[0], args[3]
    r, dev = c_feat.shape[0], c_feat.device
    from_zero = ops.KERNELS.sorted_uniform(r, n_f, *draw, dev)
    for ray0 in DRAW_OFFSETS:
        u = ops.KERNELS.sorted_uniform(r, n_f, *draw, dev, ray0=ray0)
        ref = ops.PLAIN.sorted_uniform(r, n_f, *draw, dev, ray0=ray0)
        torch.cuda.synchronize()
        abs_err = float((u - ref).abs().max())
        check_close(f"K5 sorted_uniform at ray offset {ray0}", f"abs <= {K5_TOL:.0e}",
                    abs_err <= K5_TOL, abs_err, abs_err)
        if ray0 < r:
            tail = ops.KERNELS.sorted_uniform(r - ray0, n_f, *draw, dev, ray0=ray0)
            diff = bits_differ([tail], [from_zero[ray0:]])
            print(f"phase 2 K5 at ray offset {ray0}: {diff} of {tail.numel():,} uniforms differ "
                  f"from rows {ray0}: of the draw from ray 0 (bit for bit) -> "
                  f"{'ok' if diff == 0 else 'MISS'}", flush=True)
            if diff:
                fail(f"K5 at ray offset {ray0} draws other rows than from ray 0")
    for name, op, plain, extra in (
            ("K4 + draw", ops.KERNELS.resample_chart, ops.PLAIN.resample_chart, rays),
            ("K4c + draw", ops.KERNELS.resample_score, ops.PLAIN.resample_score, ())):
        ray0 = DRAW_OFFSETS[0]
        got = op(*args, *extra, draw=draw, ray0=ray0)
        ref = plain(*args, *extra, draw=draw, ray0=ray0)
        torch.cuda.synchronize()
        abs_err = max_err(got[:2], ref[:2])[0]
        check_close(f"{name} at ray offset {ray0} against its plain version (z_vals, dists)",
                    f"abs <= {REL_TOL * far:.1e}, 1e-5 x far", abs_err <= REL_TOL * far,
                    abs_err, abs_err / far)
        t = {}
        for key in ("0", "offset", "offset ", "0 "):
            t[key] = time_ms(lambda: op(*args, *extra, draw=draw,
                                        ray0=ray0 if key.startswith("offset") else 0))
        print(f"phase 2 {name} (training) at ray offset {ray0}: "
              f"{(t['offset'] + t['offset ']) / 2:.4f} ms against {(t['0'] + t['0 ']) / 2:.4f} "
              f"ms at offset 0, in turns ({t['0']:.4f}, {t['offset']:.4f}, {t['offset ']:.4f}, "
              f"{t['0 ']:.4f})", flush=True)


def draw_checks(ops, args, rays, draw, far) -> dict:
    """Phase 2, K5's draw in the prologue of K4's and K4c's training
    instantiations, on a recorded production training step (``args``: K4's
    arguments with u None; ``rays``: the chart's; ``draw``: the step's key):
    each bit for bit with K5 followed by the same op on K5's uniforms, at the
    step's 128 + 128 and at DRAW_SWEEP draws a ray (n + 1 off the 4- and
    32-grids), on K4's hard rays and without the merge; the fused launch
    against its plain version (the key's plain draws, K4's limit) and timed
    beside the pair it replaces.  Returns the rows "K4+draw", "K4c+draw"."""
    c_feat, coarse_z, coarse_dists, n_f = args[:4]
    act = args[6:9]
    r, n_c = c_feat.shape
    chart_op, score_op = ops.KERNELS.resample_chart, ops.KERNELS.resample_score
    for ray0 in (0, *DRAW_OFFSETS):
        at = f", ray offset {ray0}" if ray0 else ""
        for f in (n_f, *DRAW_SWEEP):
            a = (c_feat, coarse_z, coarse_dists, f, None, True, *act)
            draw_equal(f"K4 + draw ({r} x {n_c} + {f}{at})", ops, chart_op, a, draw, rays, ray0)
            draw_equal(f"K4c + draw ({r} x {n_c} + {f}{at})", ops, score_op, a, draw,
                       ray0=ray0)
    offset_draw_checks(ops, args, rays, draw, far)
    a = (c_feat, coarse_z, coarse_dists, n_f, None, False, *act)
    draw_equal("K4 + draw (no merge)", ops, chart_op, a, draw, rays)
    draw_equal("K4c + draw (no merge)", ops, score_op, a, draw)
    u = drawn_u(ops, args, draw)[4]
    for label, f_h, z_h, d_h, u_h in k4_hard_inputs(c_feat, coarse_z, n_f, act, u):
        if u_h is not None:  # the hard uniforms are not draws
            continue
        a = (f_h, z_h, d_h, n_f, None, True, *act)
        r_h = f_h.shape[0]
        draw_equal(f"K4 + draw ({label})", ops, chart_op, a, draw,
                   (rays[0][:r_h], rays[1][:r_h], rays[2]))
        draw_equal(f"K4c + draw ({label})", ops, score_op, a, draw)

    table = {}
    n_out = n_c + n_f
    n_grid = rays[2].ref_grid.shape[0]
    # a draw: a quarter of a Philox block (10 rounds, ~8 integer operations
    # each), its float64 log (~20), the running sum and the division
    draw_ops = r * (n_f + 1) * 45
    for key, name, op, extra, cost in (
            ("K4+draw", "K4 + draw (training)", chart_op, rays,
             k4_cost(c_feat, n_f, n_out, n_grid=n_grid)),
            ("K4c+draw", "K4c + draw (training)", score_op, (), k4c_cost(c_feat, n_f, n_out))):
        plain = ops.PLAIN.resample_chart if op is chart_op else ops.PLAIN.resample_score
        got, ref = op(*args, *extra, draw=draw), plain(*args, *extra, draw=draw)
        torch.cuda.synchronize()
        abs_err = max_err(got[:2], ref[:2])[0]
        check_close(f"{name} against its plain version (z_vals, dists)",
                    f"abs <= {REL_TOL * far:.1e}, 1e-5 x far: K5's float32 sums in another "
                    f"order", abs_err <= REL_TOL * far, abs_err, abs_err / far)
        with_u = drawn_u(ops, args, draw)
        pair = time_ms(lambda: op(*drawn_u(ops, args, draw), *extra))
        k5 = time_ms(lambda: ops.KERNELS.sorted_uniform(r, n_f, *draw, c_feat.device))
        alone = time_ms(lambda: op(*with_u, *extra))
        table[key] = kernel_row(
            name, "egonerf_torch/csrc/resample.cu", "egonerf_tpu/ops/merge.py:25", abs_err,
            time_ms(lambda: op(*args, *extra, draw=draw)),
            time_ms(lambda: plain(*args, *extra, draw=draw), reps=5), cost[0],
            cost[1] + draw_ops)
        print(f"phase 2 {name}: one launch {table[key]['ms']:.4f} ms; the pair it replaces, K5 "
              f"then the op on K5's uniforms, {pair:.4f} ms back to back (K5 {k5:.4f} + the op "
              f"{alone:.4f} = {k5 + alone:.4f})", flush=True)
    return table


def train_kernel_checks(trainer, ops) -> dict:
    """Phase 2, training step: K2, K4, K5, K6b on the inputs one production
    training step gives them (recorded from a real step), and K4's and
    K4c's training instantiations with K5's draw in their prologue."""
    model = trainer.model
    cfg = model.cfg
    rec_k1 = Recorder(ops.KERNELS.field)
    rec_f = Recorder(ops.KERNELS.field_bwd)
    rec_c = Recorder(ops.KERNELS.composite_bwd)
    rec_r = Recorder(ops.KERNELS.resample_chart)
    model.ops = ops.KERNELS._replace(field=rec_k1, field_bwd=rec_f, composite_bwd=rec_c,
                                     resample_chart=rec_r)
    trainer.train_step(0)
    model.ops = ops.KERNELS
    torch.cuda.synchronize()
    # the step drew its u in K4's prologue: K4 checked on K5's uniforms for
    # the step's key, and the draw itself by draw_checks
    draw = rec_r.kwargs["draw"]
    k4_checks("training step", ops, drawn_u(ops, rec_r.args[:9], draw), model.near_far[1],
              rec_r.args[9:12])
    table = draw_checks(ops, rec_r.args[:9], rec_r.args[9:12], draw, model.near_far[1])

    coords, line_hat = rec_f.args[0], rec_f.args[7]
    n = coords.shape[0]
    check_relu_mask("K1 relu mask (training step)", rec_k1.args, ops)
    table["K2"] = check_field_bwd("K2 field_bwd", rec_f.args, ops, adversarial=True)
    # EGONERF_LINE_HAT=0's line mode on the same inputs: linear weights, each
    # corner's cotangent rounded to bf16 (the production lines hold JAX's
    # one-hot gate); against its plain version under K2's limit
    from egonerf_torch.ops import vm_lookup
    lin = (*rec_f.args[:7], (vm_lookup.LINEAR_BF16_GRAD,) * 3)
    if not all(vm_lookup.line_onehot_ok(l.shape[0] * l.shape[1], rec_f.args[0].shape[0])
               for l in rec_f.args[2]):
        fail("the production step's lines are past JAX's one-hot gate")
    check_field_bwd("K2 field_bwd (line mode 2, EGONERF_LINE_HAT=0)", lin, ops)

    # K5: the same bits; rel K5_TOL
    b, n_f = trainer.cfg.batch_size, trainer.cfg.n_fine
    u = ops.KERNELS.sorted_uniform(b, n_f, SEED, 1, coords.device)
    u_ref = ops.PLAIN.sorted_uniform(b, n_f, SEED, 1, coords.device)
    torch.cuda.synchronize()
    abs_err = float((u - u_ref).abs().max())
    sorted_ok = bool((u[:, 1:] >= u[:, :-1]).all() and (u > 0).all() and (u < 1).all())
    check_close("K5 sorted_uniform", f"abs <= {K5_TOL:.0e}, sorted in (0, 1)",
                abs_err <= K5_TOL and sorted_ok, abs_err, abs_err)
    table["K5"] = kernel_row(
        "K5 sorted_uniform", "egonerf_torch/csrc/sorted_uniform.cu",
        "egonerf_tpu/ops/merge.py:25", abs_err,
        time_ms(lambda: ops.KERNELS.sorted_uniform(b, n_f, SEED, 1, coords.device)),
        time_ms(lambda: ops.PLAIN.sorted_uniform(b, n_f, SEED, 1, coords.device), reps=5),
        4 * b * n_f,
        # per draw: 10 Philox rounds (~12 integer operations each), the log
        # (~20), the cumsum and the division
        b * (n_f + 1) * 142)

    # K6b: rel REL_TOL of max|plain|
    feat, dists, rgb, g_rgb = rec_c.args[:4]
    got = ops.KERNELS.composite_bwd(*rec_c.args)
    ref = ops.PLAIN.composite_bwd(*rec_c.args)
    torch.cuda.synchronize()
    abs_err, rel_err = max_err(got, ref)
    check_close("K6b composite_bwd", f"rel <= {REL_TOL:.0e} of max|plain|",
                rel_err <= REL_TOL, abs_err, rel_err)
    table["K6b"] = kernel_row(
        "K6b composite_bwd", "egonerf_torch/csrc/composite.cu",
        "egonerf_tpu/models/egonerf.py:466", abs_err,
        time_ms(lambda: ops.KERNELS.composite_bwd(*rec_c.args)),
        time_ms(lambda: ops.PLAIN.composite_bwd(*rec_c.args), reps=5),
        nbytes(feat, dists, rgb, g_rgb) + 4 * (feat.numel() + rgb.numel()),
        feat.numel() * 60)
    print(f"phase 2 training inputs: {trainer.cfg.batch_size} rays, {n:,} fine samples; "
          f"line hat path {list(line_hat)}; compute dtype {cfg.compute_dtype}", flush=True)
    return table


def k6b_case(r, s, env, gated, seed, dev):
    """K6b's arguments on ``r`` seeded rays of ``s`` samples: densities
    from empty to opaque, colours past [0, 1] (so the clip's three slopes
    all occur), the envmap's radiance and the gates where asked."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=dev)
    feat = (rand(r, s) * 16.0 - 4.0) * (rand(r, 1) * 2.0)
    dists = rand(r, s) * (2.0 / s)
    rgb = rand(r, s, 3) * 1.4 - 0.2
    g = rand(r, 3) * 2.0 - 1.0
    e = rand(r, 3) if env else None
    valid = (rand(r, s) < 0.7) if gated else None
    return (feat, dists, rgb, g, -8.0, 25.0, "softplus", e, valid, 1e-4 if gated else None)


def k6b_sweep(ops) -> None:
    """Phase 2, K6b on seeded rays of each of K6B_SWEEP_S samples in its
    three instantiations (EgoNeRF, envmap, gated) against the plain
    version, rel REL_TOL of max|plain|: its layout (warps a block, shared
    bytes), which the kernel's entry chooses and reports, changes with S."""
    from egonerf_torch.ops import volrend

    for s in K6B_SWEEP_S:
        r = 1024 if s > 256 else 4096
        for label, env, gated in (("EgoNeRF", False, False), ("env", True, False),
                                  ("gated", False, True)):
            warps, smem = volrend.bwd_geometry(s, gated)
            args = k6b_case(r, s, env, gated, SEED + s, DEVICE)
            with torch.no_grad():
                out, ref = ops.KERNELS.composite_bwd(*args), ops.PLAIN.composite_bwd(*args)
            torch.cuda.synchronize()
            if not all(torch.isfinite(o).all() for o in out):
                fail(f"K6b {label} at S = {s}: non-finite output")
            abs_err, rel_err = max_err(out, ref)
            check_close(f"K6b composite_bwd {label} at {r} x {s} ({warps} warps a block, "
                        f"{smem} shared bytes)", f"rel <= {REL_TOL:.0e} of max|plain|",
                        rel_err <= REL_TOL, abs_err, rel_err)


def bits_differ(got, want) -> int:
    return sum(int((g.view(torch.int32) != w.view(torch.int32)).sum())
               for g, w in zip(got, want))


def k6e_against_pair(label, ops, c_args) -> None:
    """K6e on ``c_args`` against the pair it replaces, K8 then K6 with K8's
    env: env and every other output (rgb, depth, acc, bg, bg_map) bit for
    bit."""
    emission, dirs = c_args[11], c_args[12]
    got = ops.KERNELS.composite(*c_args)
    env = ops.KERNELS.envmap(emission, dirs)
    pair = ops.KERNELS.composite(*c_args[:8], env)
    torch.cuda.synchronize()
    d_env, d_rest = bits_differ(got[5:], [env]), bits_differ(got[:5], pair)
    print(f"phase 2 K6e ({label}, {dirs.shape[0]} rays): env differs from K8's on {d_env} of "
          f"{env.numel()} values, rgb, depth, acc, bg and bg_map from K8 + K6's on {d_rest} of "
          f"{sum(o.numel() for o in pair)} (bit for bit) -> "
          f"{'ok' if d_env == d_rest == 0 else 'MISS'}", flush=True)
    if d_env or d_rest:
        fail(f"K6e ({label}) differs from K8 + K6 with the background")


@torch.no_grad()
def envmap_kernel_checks(trainer, ops) -> dict:
    """Phase 2, the envmap: K6e (K6 with K8's lookup inside), K8, K8b, K6
    with a given env and K6b with the background, on the inputs one
    production step of the outdoor shape gives them (recorded from its
    forward and backward; the weights do not move).  K6e's env must be K8's
    bit for bit and its other outputs those of K8 followed by K6 with that
    env, on the step's rays and on the seam and the poles (ENV_HARD_DIRS)."""
    import torch.nn.functional as F
    from egonerf_torch.models import StepKey
    from egonerf_torch.ops import envmap

    model, params, cfg = trainer.model, trainer.params, trainer.cfg
    rec = {k: Recorder(getattr(ops.KERNELS, k))
           for k in ("envmap_bwd", "composite", "composite_bwd")}
    model.ops = ops.KERNELS._replace(**rec)
    try:
        with torch.enable_grad():
            row = trainer.sampler.next_batch()
            out = model.forward(params, row[:, :6], key=StepKey(trainer.generator, cfg.seed, 0),
                                is_train=True, n_coarse=cfg.n_coarse, n_fine=cfg.n_fine)
            torch.mean((out["rgb"] - row[:, 6:9]) ** 2).backward()
    finally:
        model.ops = ops.KERNELS
        for p in params.values():
            p.grad = None
    torch.cuda.synchronize()
    table = {}
    c_args = rec["composite"].args
    feat, dists, z_vals, rgb, ray_dz = c_args[:5]
    emission, dirs = c_args[11], c_args[12]
    h, r = emission.shape[1], dirs.shape[0]

    # K8: the same corners and weights, sigmoids within K8_TOL
    abs_err, rel_err = max_err([ops.KERNELS.envmap(emission, dirs)],
                               [ops.PLAIN.envmap(emission, dirs)])
    check_close("K8 envmap_fwd", f"abs <= {K8_TOL:.0e}", abs_err <= K8_TOL, abs_err, rel_err)
    corners = envmap.envmap_corners(dirs, h)
    texels = int(torch.cat([i[w > 0] for i, w in corners]).unique().numel())
    # the library yardstick: F.grid_sample's bilinear lookup alone, on the
    # same table and the same canonical coords (no sigmoid)
    grid = (envmap.direction_to_canonical(dirs) * 2.0 - 1.0).reshape(1, 1, r, 2).contiguous()
    image = emission.permute(2, 0, 1)[None].contiguous()
    lib_ms = time_ms(lambda: F.grid_sample(image, grid, mode="bilinear", padding_mode="zeros",
                                           align_corners=True))
    k8_ms = time_ms(lambda: ops.KERNELS.envmap(emission, dirs))
    table["K8"] = kernel_row(
        "K8 envmap_fwd", "egonerf_torch/csrc/envmap.cu", "egonerf_tpu/ops/grid_sample.py:59",
        abs_err, k8_ms, time_ms(lambda: ops.PLAIN.envmap(emission, dirs), reps=5),
        # the directions, the texels this batch touches, the radiance out
        r * 12 + texels * 12 + r * 12,
        # per ray: the norm and the canonical map with atan2 (~40), two
        # corners (~10), 4 x 3 weighted adds, 3 sigmoids (~20 each)
        r * 134, library_ms=lib_ms)
    print(f"phase 2 K8 inputs: {r} rays on a {tuple(emission.shape)} table, {texels:,} "
          f"texels touched", flush=True)

    # K8b: float32 atomics against index_add_'s order, rel REL_TOL of max|plain|
    b_args = rec["envmap_bwd"].args
    abs_err, rel_err = max_err([ops.KERNELS.envmap_bwd(*b_args)], [ops.PLAIN.envmap_bwd(*b_args)])
    check_close("K8b envmap_bwd", f"rel <= {REL_TOL:.0e} of max|plain|", rel_err <= REL_TOL,
                abs_err, rel_err)
    # the library yardstick: one index_add of the 4 corner contributions
    # (made beforehand) into the zeroed table
    g = b_args[2] * (b_args[1] * (1.0 - b_args[1]))
    idx = torch.cat([i for i, _ in corners])
    vals = torch.cat([g * w[:, None] for _, w in corners])
    zero = torch.zeros(2 * h * h, 3, device=dirs.device)
    lib_ms = time_ms(lambda: zero.index_add(0, idx, vals))
    table["K8b"] = kernel_row(
        "K8b envmap_bwd", "egonerf_torch/csrc/envmap.cu", "egonerf_tpu/ops/grid_sample.py:76",
        abs_err, time_ms(lambda: ops.KERNELS.envmap_bwd(*b_args)),
        time_ms(lambda: ops.PLAIN.envmap_bwd(*b_args), reps=5),
        # directions, radiance and its cotangent in; the whole table out
        3 * r * 12 + 2 * h * h * 12, r * 110, library_ms=lib_ms)

    # K6e: env K8's and the rest K8 + K6's bit for bit, on the step's rays
    # and on rays looking at the seam and the poles; rel REL_TOL of max|plain|
    k6e_against_pair("outdoor step", ops, c_args)
    hard = torch.tensor(ENV_HARD_DIRS, dtype=torch.float32, device=dirs.device)
    n = hard.shape[0]
    k6e_against_pair("seam and poles", ops, tuple(x[:n].contiguous() for x in c_args[:5])
                     + c_args[5:12] + (hard,))
    abs_err, rel_err = max_err(ops.KERNELS.composite(*c_args), ops.PLAIN.composite(*c_args))
    check_close("K6e composite +envmap", f"rel <= {REL_TOL:.0e} of max|plain|",
                rel_err <= REL_TOL, abs_err, rel_err)
    env = ops.KERNELS.envmap(emission, dirs)
    pair_args = c_args[:8] + (env,)
    table["K6e"] = kernel_row(
        "K6e composite +envmap", "egonerf_torch/csrc/composite.cu",
        "egonerf_tpu/models/egonerf.py:481", abs_err,
        time_ms(lambda: ops.KERNELS.composite(*c_args)),
        time_ms(lambda: ops.PLAIN.composite(*c_args), reps=5),
        # K6 env's bytes, with the directions and the texels in and env out
        nbytes(feat, dists, z_vals, rgb, ray_dz) + r * 9 * 4 + r * 12 + texels * 12 + r * 12,
        feat.numel() * 20 + r * 134)
    k6_ms = time_ms(lambda: ops.KERNELS.composite(*pair_args))
    print(f"phase 2 K6e: one launch {table['K6e']['ms']:.4f} ms; the pair it replaces, K8 "
          f"{k8_ms:.4f} + K6 with env {k6_ms:.4f} = {k8_ms + k6_ms:.4f} ms", flush=True)

    # K6 with a given env (the pair's second half; TensorVMSplit's envmap
    # form) and K6b with the background: rel REL_TOL of max|plain|
    abs_err, rel_err = max_err(ops.KERNELS.composite(*pair_args),
                               ops.PLAIN.composite(*pair_args))
    check_close("K6 composite +env", f"rel <= {REL_TOL:.0e} of max|plain|", rel_err <= REL_TOL,
                abs_err, rel_err)
    table["K6+env"] = kernel_row(
        "K6 composite +env", "egonerf_torch/csrc/composite.cu",
        "egonerf_tpu/models/egonerf.py:481", abs_err, k6_ms,
        time_ms(lambda: ops.PLAIN.composite(*pair_args), reps=5),
        nbytes(feat, dists, z_vals, rgb, ray_dz, env) + r * 9 * 4, feat.numel() * 20)
    bw_args = rec["composite_bwd"].args
    abs_err, rel_err = max_err(ops.KERNELS.composite_bwd(*bw_args),
                               ops.PLAIN.composite_bwd(*bw_args))
    check_close("K6b composite_bwd +env", f"rel <= {REL_TOL:.0e} of max|plain|",
                rel_err <= REL_TOL, abs_err, rel_err)
    table["K6b+env"] = kernel_row(
        "K6b composite_bwd +env", "egonerf_torch/csrc/composite.cu",
        "egonerf_tpu/models/egonerf.py:483", abs_err,
        time_ms(lambda: ops.KERNELS.composite_bwd(*bw_args)),
        time_ms(lambda: ops.PLAIN.composite_bwd(*bw_args), reps=5),
        nbytes(*bw_args[:4], bw_args[7]) + 4 * (feat.numel() + rgb.numel()) + r * 12,
        feat.numel() * 60)
    return table


def render_phases(model, params, dirs_np, ops, presets, Renderer, wrappers,
                  phases=(3, 4, 5), renderer=None, per_chunk=None, hw=IMAGE_HW) -> dict:
    """Phases 3-5 (9 for the envmap model, 14-15 for TensoRF) under no_grad:
    one view of ``hw`` through ``renderer`` (EgoNeRF's production render by
    default), whose chunks must launch each kernel ``per_chunk`` times
    (EgoNeRF's K1, K3, K4, K6, K7 once; with the envmap K6 is K6e and K8
    is not launched); a few
    chunks against the plain versions; the profile.  Returns the launches
    of the view and its seconds."""
    p_view, p_e2e, p_prof = phases
    env = model.cfg.use_envmap
    dev = model.device
    n_view = dirs_np.shape[0]
    chunk = presets.EVAL_CHUNK
    if renderer is None:
        renderer = Renderer(model, chunk=chunk, **presets.RENDER)
        per_chunk = dict(K1=1, K3=1, K4=1, K7=1, **{"K6e" if env else "K6": 1})
    chunk = renderer.chunk
    renderer.set_directions(dirs_np)
    c2w = np.eye(4, dtype=np.float32)[:3]
    renderer.render_view(params, c2w)  # warm: cuBLAS handles, allocator pools
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = renderer.render_view(params, c2w)
    torch.cuda.synchronize()
    s_image = time.time() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    n_chunks = -(-n_view // chunk)
    want = {k: per_chunk.get(k, 0) * n_chunks for k in wrappers}
    rgb_img, depth_img = out["rgb"], out["depth"]
    print(f"phase {p_view} render {hw[1]}x{hw[0]}: {s_image:.3f} s/image, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated, launches "
          f"{launches} (expect {n_chunks} chunks x {per_chunk}, 0 of the rest)", flush=True)
    if tuple(rgb_img.shape) != (n_view, 3) or tuple(depth_img.shape) != (n_view,):
        fail(f"render shapes {tuple(rgb_img.shape)}, {tuple(depth_img.shape)}")
    if not (torch.isfinite(rgb_img).all() and torch.isfinite(depth_img).all()):
        fail("non-finite rgb or depth")
    if float(rgb_img.min()) < 0.0 or float(rgb_img.max()) > 1.0:
        fail("rgb outside [0, 1]")
    if env:
        bg = out["bg"]
        if tuple(bg.shape) != (n_view, 3) or not torch.isfinite(bg).all() or float(
                bg.min()) < 0.0 or float(bg.max()) > 1.0:
            fail("bg not a finite (N, 3) map in [0, 1]")
        print(f"phase {p_view} background: bg mean {float(bg.mean()):.6f}", flush=True)
    expect_launches("render", launches, want)
    print(f"phase {p_view} image: rgb mean {float(rgb_img.mean()):.6f}, depth range "
          f"[{float(depth_img.min()):.4f}, {float(depth_img.max()):.4f}]", flush=True)
    del out, rgb_img, depth_img

    # -- phase 4: end to end, kernels against plain versions
    dirs = torch.as_tensor(dirs_np, device=dev)
    n_e2e = 3 * chunk
    pick = torch.arange(n_e2e, device=dev) * (n_view // n_e2e)
    rays = torch.cat([torch.zeros_like(dirs[pick]), dirs[pick]], dim=-1)
    e2e = Renderer(model, chunk=chunk, **renderer.render_kwargs)
    got = e2e.render_rays(params, rays)
    model.ops = ops.PLAIN
    try:
        want_out = e2e.render_rays(params, rays)
    finally:
        model.ops = ops.KERNELS
    d_rgb = max(float((got[k] - want_out[k]).abs().max()) for k in ("rgb", "bg")
                if k in got)
    d_depth = float((got["depth"] - want_out["depth"]).abs().max())
    # K4's depths (EgoNeRF) differ from the plain ones in the last float32
    # bits, which moves the fine samples a little; rgb (and bg) stay within
    # 1e-5 and depth within K4's own 1e-5 x far
    tol_rgb, tol_depth = REL_TOL, REL_TOL * model.near_far[1]
    print(f"phase {p_e2e} end to end over {n_e2e} rays: max |rgb{', bg' if env else ''} - "
          f"plain| {d_rgb:.3e} (<= {tol_rgb:.1e}), max |depth - plain| {d_depth:.3e} "
          f"(<= {tol_depth:.1e})", flush=True)
    if d_rgb > tol_rgb or d_depth > tol_depth:
        fail("end-to-end render disagrees with the plain versions")

    # -- phase 5: where the time goes, from torch.profiler
    profile(lambda: e2e.render_rays(params, rays), n_e2e // chunk, f"phase {p_prof}", "chunk")
    return launches, s_image


def timed_steps(step, label: str, cfg, wrappers, want: dict, warmup: int = TRAIN_WARMUP):
    """``TRAIN_STEPS`` calls of ``step(i)`` after ``warmup`` ones, each
    between two CUDA events: the median ms/step, rays/s and peak memory;
    the launches must be ``want``.  Returns the launches and the median."""
    it = 1
    for _ in range(warmup):
        step(it)
        it += 1
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(TRAIN_STEPS)]
    t0 = time.time()
    for start, end in events:
        start.record()
        mse = step(it)
        end.record()
        it += 1
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    step_ms = sorted(s.elapsed_time(e) for s, e in events)
    median = step_ms[len(step_ms) // 2]
    mse_v = float(mse)
    print(f"{label}, batch {cfg.batch_size}: median {median:.3f} ms/step (CUDA "
          f"events; mean {sum(step_ms) / len(step_ms):.3f}, min {step_ms[0]:.3f}, max "
          f"{step_ms[-1]:.3f}), {cfg.batch_size / median * 1e3:,.0f} "
          f"train rays/s; {wall / TRAIN_STEPS * 1e3:.3f} ms/step by the host clock; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated; last mse "
          f"{mse_v:.6f}", flush=True)
    print(f"{label} launches over {TRAIN_STEPS} steps: {launches} (expect {want})", flush=True)
    expect_launches(label, launches, want)
    if not np.isfinite(mse_v):
        fail(f"{label}: non-finite training loss")
    return launches, median


def step_launches(wrappers, envmap: bool) -> dict:
    """The launches of ``TRAIN_STEPS`` EgoNeRF training steps in the default
    form: each kernel of K1-K7 once a step (K7 the coarse chart, the fine
    one in K4's epilogue; K4 its training instantiation, which draws K5's
    uniforms in its prologue, so no K5; with the envmap K6 is K6e, and K8b
    gives the table its gradient, no K8), never K9 (EgoNeRF's
    forward reads no mask), nor K10 and K11 (the opt-in shader forms)."""
    per_step = {"K1", "K2", "K3", "K4", "K4+draw", "K6b", "K7"} | (
        {"K6e", "K8b"} if envmap else {"K6"})
    return {k: TRAIN_STEPS if k in per_step else 0 for k in wrappers}


def step_vs_plain(trainer, ops, label: str, cull_keep: int = 0, it: int = 5) -> None:
    """One training step with the kernels and with the plain versions, the
    same weights and draws: ``Trainer.loss`` at iteration ``it`` (the MSE
    and the terms the config turns on; with the sparsity loss its points
    drawn here, the same on both sides) to rel REL_TOL, every gradient to
    GRAD_TOL in relative L2 norm.  With ``cull_keep`` the step culls to
    that many samples a ray (the tie-break on the same ``cull_u``), and the
    rays whose kept set differs on the two sides are printed."""
    cfg = trainer.cfg
    model, params = trainer.model, trainer.params
    dev = trainer.device
    row = trainer.sampler.next_batch()
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    jitter = torch.rand(cfg.batch_size, cfg.n_coarse, device=dev, generator=gen)
    u = ops.KERNELS.sorted_uniform(cfg.batch_size, cfg.n_fine, SEED, 10 ** 6, dev)
    cull = {}
    if cull_keep:
        cull = dict(train_keep=cull_keep, cull_u=torch.rand(
            cfg.batch_size, cfg.n_coarse + cfg.n_fine, device=dev, generator=gen))
    pts = None
    if cfg.sparsity_lambda > 0:
        # EgoNeRF's points carry a chart flag, TensorVMSplit's do not
        n = cfg.N_sparsity_points
        pts = torch.rand(n, 3, device=dev, generator=gen) * 2.0 - 1.0
        if cfg.model_name == "EgoNeRF":
            pts = torch.cat([pts, (torch.rand(n, 1, device=dev, generator=gen) < 0.5).float()],
                            -1)
    depth_gt = row[:, 9] if cfg.use_depth else None
    logs = []

    def loss_and_grads(o):
        logs.append(CallLog(o.select_top_k))
        model.ops = o._replace(select_top_k=logs[-1])
        try:
            for p in params.values():
                p.grad = None
            out = model.forward(params, row[:, :6], is_train=True, n_coarse=cfg.n_coarse,
                                n_fine=cfg.n_fine, exp_sampling=cfg.exp_sampling,
                                ndc_ray=bool(cfg.ndc_ray), jitter=jitter, u=u,
                                with_alpha=trainer.entropy_on(it), **cull)
            loss, _ = trainer.loss(out, row[:, 6:9], it, depth_gt, pts)
            loss.backward()
            return loss.item(), {k: p.grad.detach().clone() for k, p in params.items()}
        finally:
            model.ops = ops.KERNELS

    loss_k, grads_k = loss_and_grads(ops.KERNELS)
    loss_p, grads_p = loss_and_grads(ops.PLAIN)
    if cull_keep:
        n_set, n_score, n_rays = kept_set_diff(logs[0].calls, logs[1].calls)
        print(f"{label} culled step (train_keep {cull_keep}, tie-break): {n_set} of {n_rays} "
              f"rays keep a different sample set with the kernels than with the plain "
              f"versions; {n_score} rays' scores differ in any bit", flush=True)
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    print(f"{label} training step, kernels vs plain: loss {loss_k:.8f} vs {loss_p:.8f} "
          f"(rel {rel_loss:.2e} <= {REL_TOL:.0e})", flush=True)
    worst = 0.0
    for k in sorted(grads_p):
        g, r = grads_k[k], grads_p[k]
        if not torch.isfinite(g).all():
            fail(f"non-finite gradient {k}")
        l2 = float((g - r).norm() / r.norm().clamp_min(1e-30))
        mx = float((g - r).abs().max() / r.abs().max().clamp_min(1e-30))
        worst = max(worst, l2)
        print(f"{label}   {k:22s} |g - plain| / |plain| {l2:.2e} (<= {GRAD_TOL:.0e}), "
              f"max |g - plain| / max |plain| {mx:.2e}", flush=True)
    for p in params.values():
        p.grad = None
    if rel_loss > REL_TOL or worst > GRAD_TOL:
        fail(f"{label}: the training step with the kernels disagrees with the plain versions")


def train_phases(trainer, ops, wrappers) -> tuple:
    """Phases 6 and 7; returns the launches of the timed steps and their
    median ms."""
    cfg = trainer.cfg
    launches, median = timed_steps(
        trainer.train_step, f"phase 6 training step, {cfg.n_coarse} + {cfg.n_fine} samples, "
        f"grid {trainer.model.grid_size}", cfg, wrappers, step_launches(wrappers, envmap=False))
    it = 10 ** 4

    def steps():
        nonlocal it
        for _ in range(PROFILE_STEPS):
            trainer.train_step(it)
            it += 1
    k2_share("phase 6", profile(steps, PROFILE_STEPS, "phase 6", "step", top=16), median)
    step_vs_plain(trainer, ops, "phase 7")
    return launches, median


def envmap_train_phases(trainer, ops, wrappers) -> tuple:
    """Phases 10 and 11: envmap pretrain steps (K8 and K8b once each) and
    production envmap training steps, and one step against the plain
    versions; returns the launches of the timed pretrain steps and of the
    timed training steps."""
    cfg = trainer.cfg
    pretrain, _ = timed_steps(lambda it: trainer.pretrain_step(), "phase 10 envmap pretrain step "
                f"({tuple(trainer.params['envmap'].shape)} table)", cfg, wrappers,
                {k: (TRAIN_STEPS if k in ("K8", "K8b") else 0) for k in wrappers}, warmup=3)

    def pretrain_steps():
        for _ in range(PROFILE_STEPS):
            trainer.pretrain_step()
    profile(pretrain_steps, PROFILE_STEPS, "phase 10 pretrain", "step")
    launches, median = timed_steps(
        trainer.train_step, f"phase 10 envmap training step, {cfg.n_coarse} + {cfg.n_fine} "
        f"samples, grid {trainer.model.grid_size}", cfg, wrappers,
        step_launches(wrappers, envmap=True))
    it = 10 ** 4

    def steps():
        nonlocal it
        for _ in range(PROFILE_STEPS):
            trainer.train_step(it)
            it += 1
    k2_share("phase 10", profile(steps, PROFILE_STEPS, "phase 10", "step", top=16), median)
    step_vs_plain(trainer, ops, "phase 11")
    return pretrain, launches


def quality_phase(root: str) -> float:
    """Phase 8: the smoke run through the command line; returns its test
    PSNR."""
    from egonerf_torch.__main__ import main as cli_main

    base = os.path.join(root, "build", "chip_smoke_runs")
    shutil.rmtree(base, ignore_errors=True)  # the trainer resumes from what it finds
    argv = ["--config", os.path.join(root, SMOKE_CONFIG), "--n_iters", str(SMOKE_ITERS),
            "--vis_list", f"[{SMOKE_ITERS}]", "--N_vis", "-1", "--basedir", base]
    t0 = time.time()
    cli_main(argv)
    torch.cuda.synchronize()
    train_s = time.time() - t0
    logdir = os.path.join(base, "smoke")
    test_psnr = float(np.loadtxt(os.path.join(logdir, "imgs_vis", f"{SMOKE_ITERS - 1:06d}_mean.txt"))[0])
    from egonerf_torch.render.renderer import Renderer, evaluation
    from egonerf_torch.train.checkpoint import latest_checkpoint
    from egonerf_torch.train.config import parse_cli
    from egonerf_torch.train.trainer import _load_model
    from egonerf_torch.data.datasets import SyntheticEgoDataset

    cfg = parse_cli(argv)
    train_views = SyntheticEgoDataset(split="train", is_stack=True, near_far=cfg.near_far)
    model, header = _load_model(cfg, latest_checkpoint(logdir), train_views.scene_bbox,
                                train_views.near_far, DEVICE)
    train_psnr = float(np.mean(evaluation(train_views, model, model.params(),
                                          Renderer.from_config(model, cfg, False))))
    print(f"phase 8 smoke run ({SMOKE_CONFIG}, {SMOKE_ITERS} iterations, {train_s:.1f} s with its "
          f"evaluation): test PSNR {test_psnr:.2f} dB, train-view PSNR {train_psnr:.2f} dB; "
          f"the JAX package {JAX_SMOKE_PSNR:.2f} dB (NOTES.md:77), floor "
          f"{JAX_SMOKE_PSNR - SEED_BAND_DB:.2f} dB (its seed band)", flush=True)
    if not test_psnr >= JAX_SMOKE_PSNR - SEED_BAND_DB:
        fail(f"smoke test PSNR {test_psnr:.2f} dB below {JAX_SMOKE_PSNR - SEED_BAND_DB:.2f}")
    # the checkpoint it wrote, reloaded through --evaluation 1
    cli_main(argv + ["--evaluation", "1"])
    reloaded = float(np.loadtxt(os.path.join(logdir, "evaluation", "mean.txt"))[0])
    print(f"phase 8 --evaluation 1 from {os.path.basename(latest_checkpoint(logdir))} "
          f"(global_step {header['global_step']}): test PSNR {reloaded:.4f} dB", flush=True)
    if abs(reloaded - test_psnr) > 1e-3:
        fail(f"reloaded checkpoint renders {reloaded:.4f} dB, training ended at "
             f"{test_psnr:.4f} dB")
    # its outputs: JAX's files, every metric but LPIPS (no weights file)
    eval_dir = os.path.join(logdir, "evaluation")
    with open(os.path.join(eval_dir, "mean.json")) as f:
        summary = json.load(f)
    want = eval_files(summary["n_images"], False)
    print(f"phase 8 --evaluation 1 wrote {files_under(eval_dir)}; mean.json "
          f"{json.dumps(summary)}", flush=True)
    if files_under(eval_dir) != want or summary["ssim"] is None:
        fail(f"phase 8 --evaluation 1 wrote {files_under(eval_dir)}, JAX writes {want}")
    return test_psnr


def outdoor_cli_phase(root: str, presets) -> None:
    """Phase 12: the outdoor config through the command line on the
    procedural scene: its envmap pretrain and a few steps, then
    ``--evaluation 1`` from the checkpoint it wrote."""
    from egonerf_torch.__main__ import main as cli_main

    base = os.path.join(root, "build", "chip_smoke_runs", "outdoor_cli")
    shutil.rmtree(base, ignore_errors=True)
    n = str(OUTDOOR_CLI_ITERS)
    argv = ["--config", str(presets.OUTDOOR_CONFIG), "--dataset_name", "synthetic",
            "--n_iters", n, "--iter_pretrain_envmap", n, "--progress_refresh_rate", n,
            "--basedir", base]
    t0 = time.time()
    cli_main(argv)
    cli_main(argv + ["--evaluation", "1"])
    torch.cuda.synchronize()
    mean = os.path.join(base, "EgoNeRF", "evaluation", "mean.txt")
    psnr = float(np.loadtxt(mean)[0])
    print(f"phase 12 {os.path.relpath(presets.OUTDOOR_CONFIG, root)} through the command line "
          f"(dataset synthetic, {n} pretrain + {n} steps, then --evaluation 1): "
          f"{time.time() - t0:.1f} s, test PSNR {psnr:.2f} dB", flush=True)
    if not np.isfinite(psnr):
        fail("the outdoor config's evaluation gave a non-finite PSNR")
    # the envmap's images: envmap.png and the _bg PNGs of --evaluation 1, the
    # pretrain's pretrained_envmap.png
    eval_dir = os.path.dirname(mean)
    with open(os.path.join(eval_dir, "mean.json")) as f:
        n_images = json.load(f)["n_images"]
    pretrained = os.path.join(base, "EgoNeRF", "imgs_vis", "pretrained_envmap.png")
    print(f"phase 12 --evaluation 1 wrote {files_under(eval_dir)}; pretrained_envmap.png "
          f"{'written' if os.path.exists(pretrained) else 'MISSING'}", flush=True)
    if files_under(eval_dir) != eval_files(n_images, True) or not os.path.exists(pretrained):
        fail("phase 12: the envmap's images are not the files JAX writes")


def envmap_quality_phase(root: str) -> None:
    """Phase 13: the JAX package's envmap quality recipe through
    ``tools/envmap_e2e.py``'s ``_run`` (its pretrain included), writing
    under ``build/chip_smoke_runs/envmap_e2e``."""
    from egonerf_torch.tools import envmap_e2e

    t0 = time.time()
    rec = envmap_e2e._run(device=DEVICE, basedir=os.path.join(root, "build", "chip_smoke_runs"))
    torch.cuda.synchronize()
    psnr, e = rec["final_test_psnr"], rec["config"]
    floor = JAX_ENV_E2E_PSNR - SEED_BAND_DB
    print(f"phase 13 envmap quality recipe ({e['iter_pretrain_envmap']} pretrain + "
          f"{e['n_iters']} steps, N_voxel {e['n_voxel']:.0e}, envmap_res_H {e['envmap_res_H']}, "
          f"{e['views']} views): test PSNR {psnr:.2f} dB; the "
          f"JAX package {JAX_ENV_E2E_PSNR:.2f} dB (docs/results_envmap_e2e.json), floor "
          f"{floor:.2f} dB; {rec['wall_s']:.1f} s training and evaluation, "
          f"{time.time() - t0 - rec['wall_s']:.1f} s set-up", flush=True)
    if not psnr >= floor:
        fail(f"envmap test PSNR {psnr:.2f} dB below {floor:.2f}")


def half_mask(n: int, device) -> torch.Tensor:
    """An (n, n, n) occupancy volume of half occupancy for the phases that
    run before any bake (2, 14, 15): a smooth random field from SEED (six
    plane waves of low frequency) thresholded at its median, so the mask
    has blobs and boundaries as a baked one does."""
    g = torch.Generator(device=device).manual_seed(SEED)
    ax = torch.linspace(-1.0, 1.0, n, device=device)
    x = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), dim=-1)
    field = torch.zeros(n, n, n, device=device)
    for _ in range(6):
        k = (torch.rand(3, generator=g, device=device) * 2.0 - 1.0) * 6.0
        field += torch.cos(x @ k + 6.28 * torch.rand(1, generator=g, device=device))
    return (field > field.flatten().kthvalue(field.numel() // 2).values).to(torch.uint8)


def tensorf_kernel_checks(trainer, ops) -> dict:
    """Phase 2, the TensoRF path: K3 and K9 on the inputs of its bake (the
    dense 128^3 grid on the 256^3 tables, under the installed mask), K1,
    K2, K6 and K6b with the gates and K9 on the inputs of one of its
    training steps, each against its plain version; TensorVM's relu-free
    K1, K3 and K2 on the same inputs (:func:`norelu_kernel_checks`)."""
    import torch.nn.functional as F
    from egonerf_torch.ops import volrend

    model, cfg = trainer.model, trainer.model.cfg
    mask = model.alpha_mask
    rec = {k: Recorder(getattr(ops.KERNELS, k)) for k in ("density", "alpha")}
    model.ops = ops.KERNELS._replace(**rec)
    try:
        model.update_alpha_mask(trainer.params, [min(r, TF_MASK_RESO) for r in model.grid_size])
    finally:
        model.ops, model.alpha_mask = ops.KERNELS, mask
    d_args = rec["density"].args
    rec = {k: Recorder(getattr(ops.KERNELS, k))
           for k in ("field", "field_bwd", "composite", "composite_bwd", "alpha")}
    model.ops = ops.KERNELS._replace(**rec)
    try:
        trainer.train_step(0)
    finally:
        model.ops = ops.KERNELS
    torch.cuda.synchronize()
    vm_src, vm = "egonerf_torch/csrc/vm_lookup.cu", "egonerf_tpu/ops/vm_lookup.py"
    comp_src, comp = "egonerf_torch/csrc/composite.cu", "egonerf_tpu/models/tensorf.py"
    table = {}

    coords, planes, lines = rec["field"].args[:3]
    n, n_ch = coords.shape[0], sum(p.shape[-1] for p in planes)
    n_app = n_ch - sum(cfg.density_n_comp)
    print(f"phase 2 TensoRF inputs: {trainer.cfg.batch_size} rays x {trainer.cfg.n_coarse} "
          f"samples ({n:,}), grid {model.grid_size}, stacks of {planes[0].shape[0]}; line hat "
          f"path {list(rec['field'].args[4])}; bake {d_args[0].shape[0]:,} points", flush=True)
    table["K1 (S=1)"] = check_case(
        "K1 field_fwd (S=1)", vm_src, f"{vm}:467", ops.KERNELS.field, ops.PLAIN.field,
        rec["field"].args, nbytes(coords, *planes, *lines) + n * (1 + n_app) * 4, n * n_ch * 11,
        cold=True)
    check_relu_mask("K1 relu mask (S=1)", rec["field"].args, ops)
    table["K2 (S=1)"] = check_field_bwd("K2 field_bwd (S=1)", rec["field_bwd"].args, ops,
                                        adversarial=True)
    dc, dp, dl = d_args
    table["K3 (S=1)"] = check_case(
        "K3 density_fwd (S=1)", vm_src, f"{vm}:436", ops.KERNELS.density, ops.PLAIN.density,
        d_args, nbytes(dc, *dp, *dl) + dc.shape[0] * 4,
        dc.shape[0] * sum(p.shape[-1] for p in dp) * 11, cold=True)
    table.update(norelu_kernel_checks(ops, rec["field"].args, rec["field_bwd"].args, d_args))

    c_args = rec["composite"].args
    feat, dists, z, rgb, dz = c_args[:5]
    valid, thres = c_args[9], c_args[10]
    kept = volrend._warp_transmittance(volrend._alpha(
        feat, dists, cfg.density_shift, cfg.distance_scale, cfg.fea2dense_act, valid))[0] > thres
    print(f"phase 2 TensoRF gates: {float(valid.float().mean()):.1%} of the samples in the box "
          f"and the mask, {float(kept.float().mean()):.1%} above the rgb gate {thres:g}",
          flush=True)
    table["K6 gated"] = check_case(
        "K6 composite (gated)", comp_src, f"{comp}:231", ops.KERNELS.composite,
        ops.PLAIN.composite, rec["composite"].args,
        nbytes(feat, dists, z, rgb, dz, valid) + feat.shape[0] * 6 * 4, feat.numel() * 20)
    b_args = rec["composite_bwd"].args
    table["K6b gated"] = check_case(
        "K6b composite_bwd (gated)", comp_src, f"{comp}:244", ops.KERNELS.composite_bwd,
        ops.PLAIN.composite_bwd, b_args,
        nbytes(*b_args[:4], valid) + 4 * (feat.numel() + rgb.numel()), feat.numel() * 60)

    a_coords, vol = rec["alpha"].args
    row = check_case("K9 alpha_fwd", "egonerf_torch/csrc/alphamask.cu",
                     "egonerf_tpu/models/alphamask.py:50", ops.KERNELS.alpha, ops.PLAIN.alpha,
                     rec["alpha"].args,
                     # coords read once, the occupancy written once, the volume
                     nbytes(a_coords, vol) + a_coords.shape[0] * 4,
                     # three cells (~8 each), 12 weight products, 8 adds
                     a_coords.shape[0] * 44, abs_tol=K9_TOL, tol_desc=f"abs <= {K9_TOL:.0e}")
    # the library yardstick: F.grid_sample's trilinear lookup on a float copy
    # of the volume (zeros padding), which the port never calls
    image = vol.float()[None]
    grid = a_coords[:, :3].reshape(1, 1, 1, -1, 3).contiguous()
    row["library_ms"] = time_ms(lambda: F.grid_sample(image, grid, mode="bilinear",
                                                      padding_mode="zeros", align_corners=True))
    print(f"phase 2 K9 inputs: {a_coords.shape[0]:,} samples on a {tuple(vol.shape)} volume "
          f"({float(vol.float().mean()):.1%} occupied); F.grid_sample {row['library_ms']:.4f} ms",
          flush=True)
    table["K9"] = row
    return table


def k2_stage_checks(root, ops) -> None:
    """Phase 2, K2 on recorded steps of the main paths that phase 2 meets
    nowhere else: the smoke config's (``SMOKE_CONFIG``, its own scene) and
    the JAX ``tensorf`` preset's first two grids (128^3, and 161^3 after
    its first upsample) on its quality recipe's scene, random weights from
    SEED; each held to its plain version and timed
    (:func:`check_field_bwd`)."""
    from egonerf_torch.data.datasets import SyntheticEgoDataset
    from egonerf_torch.tools import quality_run
    from egonerf_torch.train.config import load_config
    from egonerf_torch.train.trainer import Trainer

    base = os.path.join(root, "build", "chip_smoke_runs")

    def recorded(trainer, it):
        rec = Recorder(ops.KERNELS.field_bwd)
        trainer.model.ops = ops.KERNELS._replace(field_bwd=rec)
        try:
            trainer.train_step(it)
        finally:
            trainer.model.ops = ops.KERNELS
        torch.cuda.synchronize()
        return rec.args

    smoke = Trainer(load_config(os.path.join(root, SMOKE_CONFIG), overrides=dict(
        basedir=base, expname="k2_smoke")), device=DEVICE)
    args = recorded(smoke, 0)
    print(f"phase 2 smoke step inputs: {smoke.cfg.batch_size} rays, {args[0].shape[0]:,} fine "
          f"samples, grid {smoke.model.grid_size}", flush=True)
    check_field_bwd("K2 field_bwd (smoke step)", args, ops)
    del smoke, args
    cfg, scene = quality_run.preset_spec("tensorf", basedir=base, expname="k2_stages",
                                         progress_refresh_rate=10 ** 9)
    tf = Trainer(cfg, device=DEVICE)
    scene = dict(scene, near_far=tf.cfg.near_far)
    tf.set_datasets(SyntheticEgoDataset(split="train", **scene),
                    SyntheticEgoDataset(split="test", is_stack=True, **scene))
    for it in (0, tf.upsamp_list[0]):
        if it:
            tf.upsample(it)
        args = recorded(tf, it)
        print(f"phase 2 tensorf step inputs at {it}: {tf.cfg.batch_size} rays x "
              f"{tf.cfg.n_coarse} samples ({args[0].shape[0]:,}), grid {tf.model.grid_size}",
              flush=True)
        check_field_bwd(f"K2 field_bwd (S=1, {tf.model.grid_size[0]}^3)", args, ops)
    del tf, args
    torch.cuda.empty_cache()


def tensorf_bench_phases(root, presets, ops, wrappers):
    """Phases 16-17: the JAX ``tensorf_bench`` recipe through
    ``tools/tensorf_bench.py`` (its training, its timed segments and gate
    occupancy), then timed steps, the profile, the bake, and one step
    against the plain versions.  Returns the launches of the timed steps
    and of the bake."""
    from egonerf_torch.tools import tensorf_bench

    t0 = time.time()
    trainer = tensorf_bench.trained(DEVICE, basedir=os.path.join(root, "build",
                                                                 "chip_smoke_runs"))
    torch.cuda.synchronize()
    cfg, model = trainer.cfg, trainer.model
    scene = presets.TENSORF_BENCH_SCENE
    if model.alpha_mask is None:
        fail("the tensorf_bench recipe baked no alpha mask")
    print(f"phase 16 tensorf_bench recipe ({cfg.n_iters} steps, the mask baked at "
          f"{cfg.update_AlphaMask_list}, grid {model.grid_size}, {cfg.n_coarse} samples a ray, "
          f"{scene['n_train']} views at {scene['width']}x{scene['height']}): {time.time() - t0:.1f} "
          f"s; mask {model.alpha_mask.grid_size}, {float(model.alpha_mask.vol.float().mean()):.1%} "
          f"occupied", flush=True)
    rec = tensorf_bench.measure(trainer)
    print(f"phase 16 tensorf_bench segments ({tensorf_bench.CALLS_PER_SEG} x "
          f"{tensorf_bench.STEPS_PER_CALL} steps each, CUDA events): "
          f"{rec['segments_rays_per_sec']} rays/s, median step {rec['step_ms_p50']:.3f} ms",
          flush=True)
    print(f"phase 16 gate occupancy {rec['gate_occupancy']:.4f} (weight > "
          f"{cfg.rm_weight_mask_thre:g} on the first {cfg.batch_size} training rays, the "
          f"tool's)", flush=True)
    per_step = ("K1", "K2", "K9", "K6", "K6b")
    launches, median = timed_steps(
        trainer.train_step, f"phase 16 TensoRF training step, {cfg.n_coarse} samples, grid "
        f"{model.grid_size}", cfg, wrappers, {k: TRAIN_STEPS if k in per_step else 0
                                              for k in wrappers})
    it = 10 ** 4

    def steps():
        nonlocal it
        for _ in range(PROFILE_STEPS):
            trainer.train_step(it)
            it += 1
    k2_share("phase 16", profile(steps, PROFILE_STEPS, "phase 16", "step", top=16), median)

    # the bake, timed, under the mask it replaces (K3, then K9 inside compute_alpha)
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    trainer.update_alpha_mask()
    torch.cuda.synchronize()
    bake_ms = (time.time() - t0) * 1e3
    bake = {k: w.launches for k, w in wrappers.items()}
    print(f"phase 16 bake at {[min(r, TF_MASK_RESO) for r in model.grid_size]}: {bake_ms:.1f} ms, "
          f"launches {bake}", flush=True)
    if bake["K3"] < 1 or bake["K9"] < 1 or any(v for k, v in bake.items() if k not in ("K3", "K9")):
        fail(f"the bake launched {bake}, expected K3 and K9 only")

    step_vs_plain(trainer, ops, "phase 17")
    return launches, bake


def tensorf_quality_phase(root) -> None:
    """Phase 18: the JAX ``tensorf`` quality recipe unchanged (``quality_run``'s
    preset) through ``Trainer`` + ``set_datasets``."""
    from egonerf_torch.data.datasets import SyntheticEgoDataset
    from egonerf_torch.tools import quality_run
    from egonerf_torch.train.trainer import Trainer

    base = os.path.join(root, "build", "chip_smoke_runs")
    cfg, scene = quality_run.preset_spec("tensorf", basedir=base)
    shutil.rmtree(os.path.join(base, "tensorf"), ignore_errors=True)
    t0 = time.time()
    trainer = Trainer(cfg, device=DEVICE)
    scene = dict(scene, near_far=cfg.near_far)
    trainer.set_datasets(SyntheticEgoDataset(split="train", **scene),
                         SyntheticEgoDataset(split="test", is_stack=True, **scene))
    t1 = time.time()
    psnr = float(np.mean(trainer.train()))
    torch.cuda.synchronize()
    floor = JAX_TENSORF_PSNR - SEED_BAND_DB
    print(f"phase 18 tensorf quality recipe ({cfg.n_iters} steps, N_voxel {cfg.N_voxel_init:,} -> "
          f"{cfg.N_voxel_final:,} at {cfg.upsamp_list}, final grid {trainer.model.grid_size}, "
          f"{scene['n_train']} + {scene['n_test']} views at {scene['width']}x{scene['height']}): "
          f"test PSNR {psnr:.2f} dB; the JAX package {JAX_TENSORF_PSNR:.2f} dB "
          f"(docs/results_tensorf.json), floor {floor:.2f} dB (the seed band measured on "
          f"EgoNeRF); {time.time() - t1:.1f} s training and evaluation, {t1 - t0:.1f} s set-up",
          flush=True)
    if not psnr >= floor:
        fail(f"tensorf test PSNR {psnr:.2f} dB below {floor:.2f}")


@contextlib.contextmanager
def shader_form(model, mixed=False, bias=False, split=False, hoist=False, line_hat=True):
    """One form of the shader and the lines: the switches the models read
    (``EGONERF_MIXED_MM``, ``EGONERF_BIAS_DOT``, ``EGONERF_SPLIT_L1``,
    ``EGONERF_HOIST_DIRS``, ``EGONERF_LINE_HAT``, read at import into
    module attributes) set as the environment would set them, and an
    EgoNeRF ``model``'s ``mixed_mm`` as its construction decides it from
    the switch (bf16 compute only); everything restored after."""
    from egonerf_torch.models import egonerf, shading, tensorf

    values = ((egonerf, "_MIXED_MM", mixed), (shading, "_BIAS_DOT", bias),
              (shading, "_SPLIT_L1", split), (egonerf, "_HOIST_DIRS", hoist),
              (tensorf, "_HOIST_DIRS", hoist), (egonerf, "_LINE_HAT", line_hat),
              (tensorf, "_LINE_HAT", line_hat))
    saved = [(m, a, getattr(m, a)) for m, a, _ in values]
    had = getattr(model, "mixed_mm", None)
    try:
        for m, a, v in values:
            setattr(m, a, v)
        if had is not None:
            model.mixed_mm = mixed and model.cfg.compute_dtype == "bfloat16"
        yield
    finally:
        for m, a, v in saved:
            setattr(m, a, v)
        if had is not None:
            model.mixed_mm = had


def form_launches(model, sw: dict, train: bool) -> dict:
    """K10's and K11's launches one EgoNeRF (``mixed_mm`` possible) or
    TensoRF forward (and, with ``train``, its backward) makes under the
    switches ``sw``: K10 takes the basis (both charts in one call) and each
    shader product, the hoist's two first-layer products in place of one;
    its backward gives every product a db and each product whose input
    carries a gradient a da (not the hoist's viewdir term); K11 takes each
    of the three layers' bias under the bias-dot add, in the backward."""
    mixed = getattr(model, "mixed_mm", False)  # as shader_form set it
    products = (5 if sw.get("hoist") else 4) if mixed else 0
    out = {"K10": products, "K10da": 0, "K10db": 0, "K11": 0}
    if train:
        out.update(K10da=4 if mixed else 0, K10db=products, K11=3 if sw.get("bias") else 0)
    return out


def mm_library():
    """(label, fn(x16, y16)): the one PyTorch call that computes K10's
    function on bf16 operands, products summed in float32 with a float32
    result: ``torch.mm(x16, y16, out_dtype=torch.float32)`` where this
    torch has it for CUDA; else the operands in float32 (bf16 values are
    exact in TF32) under TF32 for that call only."""
    x = torch.ones(16, 16, dtype=torch.bfloat16, device=DEVICE)
    try:
        torch.mm(x, x, out_dtype=torch.float32)
        return "torch.mm(x16, y16, out_dtype=torch.float32)", (
            lambda x16, y16: torch.mm(x16, y16, out_dtype=torch.float32))
    except (TypeError, RuntimeError, NotImplementedError):
        pass

    def tf32(x16, y16):
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return torch.matmul(x16.float(), y16.float())
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
    return "torch.matmul(x16.float(), y16.float()) under TF32", tf32


def mm_operands(layout, args):
    """The (x, y) of K10's product x @ y in each layout."""
    if layout == "mm":
        return args
    if layout == "mm_da":
        return args[0], args[1].t()
    return args[0].t(), args[1]


def mm_check(name, layout, kern, plain, args):
    """K10 in ``layout`` on ``args`` against the exact sum of the same bf16
    products (float64; per element MM_TOL of sum|terms| for the forward and
    da, K2_TOL for db, which sums a million rows) and its plain version (the
    forward bit for bit: both add in k order).  Returns (the kernel's
    output, max abs error against the plain version)."""
    x, y = mm_operands(layout, args)
    with torch.no_grad():
        got, ref = kern(*args), plain(*args)
        x64, y64 = x.to(torch.bfloat16).double(), y.to(torch.bfloat16).double()
        exact, terms = x64 @ y64, x64.abs() @ y64.abs()
    torch.cuda.synchronize()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        fail(f"{name}: shape {tuple(got.shape)} or non-finite values")
    share = float(((got.double() - exact).abs() / (terms + 1e-30)).max())
    abs_err = float((got - ref).abs().max())
    tol = MM_TOL if layout != "mm_db" else K2_TOL
    same = layout != "mm" or torch.equal(got, ref)
    check_close(name, f"per element <= {tol:.0e} x sum|terms| of the exact bf16 product; "
                f"{abs_err:.2e} abs against the float32 plain version"
                + (", equal to it bit for bit" if layout == "mm" else ""),
                share <= tol and same, abs_err, share)
    return got, abs_err


def shader_kernel_checks(trainer, ops) -> dict:
    """Phase 2, K10 in its three layouts and K11 on the inputs two
    production training steps give them (recorded, under EGONERF_MIXED_MM
    and under MIXED_MM + BIAS_DOT + HOIST_DIRS): every shader layer, the
    basis of both charts, the hoist's two first-layer products.  Each
    against the exact sum of the same bf16 products (float64; MM_TOL of
    sum|terms| for the forward and da, K2_TOL for db and K11, which sum a
    million rows) and against its plain version (each layout also at
    MM_ODD_ROWS rows, db twice on the same inputs bit for bit), with its
    time, the plain version's and the library call's (``mm_library``: the
    same function; ``dout.sum(0)``).  Returns the rows of l1's three
    layouts and of K11."""
    model = trainer.model
    calls = {k: [] for k in ("mm", "mm_da", "mm_db", "bias_grad")}

    def recording(name):
        fn = getattr(ops.KERNELS, name)

        def rec(*args):
            calls[name].append(args)
            return fn(*args)
        return rec

    model.ops = ops.KERNELS._replace(**{k: recording(k) for k in calls})
    try:
        for sw in (dict(mixed=True), COMBINED[1]):
            with shader_form(model, **sw):
                trainer.train_step(0)
    finally:
        model.ops = ops.KERNELS
    torch.cuda.synchronize()
    src, jax_src = "egonerf_torch/csrc/mixed_mm.cu", "egonerf_tpu/ops/mm.py:31"
    lib_label, lib_call = mm_library()
    print(f"phase 2 K10's library call (the same function): {lib_label}", flush=True)
    rows, seen, da_rows = {}, set(), {}
    for layout, row_name in (("mm", "fwd"), ("mm_da", "da"), ("mm_db", "db")):
        kern, plain = getattr(ops.KERNELS, layout), getattr(ops.PLAIN, layout)
        for args in calls[layout]:
            x, y = mm_operands(layout, args)
            shape = (tuple(x.shape), tuple(y.shape))
            if (layout, shape) in seen:
                continue
            seen.add((layout, shape))
            name = f"K10 mixed_mm {row_name} ({x.shape[0]}x{x.shape[1]} @ {y.shape[0]}x{y.shape[1]})"
            got, abs_err = mm_check(name, layout, kern, plain, args)
            if layout == "mm_db":
                with torch.no_grad():
                    again = kern(*args)
                torch.cuda.synchronize()
                print(f"phase 2 {name}: two calls equal bit for bit: {torch.equal(got, again)}",
                      flush=True)
                if not torch.equal(got, again):
                    fail(f"{name} differs between two calls on the same inputs")
                del again
            del got
            for m in MM_ODD_ROWS:  # off the production chunk
                if m < args[0].shape[0]:
                    odd = (args[0][:m], args[1] if layout != "mm_db" else args[1][:m])
                    mm_check(f"{name} at {m} rows", layout, kern, plain, odd)
            rows_m, depth, cols = x.shape[0], x.shape[1], y.shape[1]
            n_bytes, n_ops = nbytes(*args) + 4 * rows_m * cols, 2.0 * rows_m * depth * cols
            x16, y16 = x.to(torch.bfloat16), y.to(torch.bfloat16)
            lib_ms = time_ms(lambda: lib_call(x16, y16))
            cast_ms = time_ms(lambda: lib_call(x.to(torch.bfloat16), y.to(torch.bfloat16)))
            del x16, y16
            # the forward sums in k order on the CUDA cores: float32 fmas,
            # whose time is its floor (above its byte bound for l1, l2);
            # da and db use the tensor cores' bf16 rate
            fwd = layout == "mm"
            row = kernel_row(name, src, jax_src, abs_err, time_ms(lambda: kern(*args)),
                             time_ms(lambda: plain(*args), reps=5), n_bytes, n_ops,
                             library_ms=lib_ms,
                             peak_ops=PEAK_F32_OPS_PER_S if fwd else PEAK_BF16_OPS_PER_S)
            held = ("the fma floor (k order on the CUDA cores)" if fwd and row["bound_by"] ==
                    "operations" else "the byte bound")
            print(f"phase 2 {name}: byte bound {n_bytes / PEAK_BYTES_PER_S * 1e3:.4f} ms, "
                  f"float32 fma floor {n_ops / PEAK_F32_OPS_PER_S * 1e3:.4f} ms, bf16 tensor "
                  f"floor {n_ops / PEAK_BF16_OPS_PER_S * 1e3:.4f} ms; held to {held}; library "
                  f"call {lib_ms:.4f} ms, {cast_ms:.4f} ms with the casts of the float32 "
                  "operands", flush=True)
            if layout == "mm_da":
                da_rows[f"{depth} -> {cols}"] = row
            n_in = model.shader.l1.in_features
            if {"mm": x.shape[1], "mm_da": y.shape[1], "mm_db": x.shape[0]}[layout] == n_in:
                rows[f"K10 {row_name}"] = row  # l1's product, its da and its db
    # da at each recorded shape (depth -> columns: l1 128 -> 150, l2 128 ->
    # 128, l3 3 -> 128, the basis 54 -> 144; the hoist's features 128 -> 135)
    print("phase 2 K10 da at the recorded shapes (depth -> columns): " + "; ".join(
        f"{shape} {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ({r['bound_ms'] / r['ms']:.0%}), "
        f"library {r['library_ms']:.4f}" for shape, r in da_rows.items()), flush=True)
    for (dout,) in calls["bias_grad"]:
        if ("bias", dout.shape) in seen:
            continue
        seen.add(("bias", dout.shape))
        name = f"K11 bias_grad ({dout.shape[0]}x{dout.shape[1]})"
        with torch.no_grad():
            got, ref = ops.KERNELS.bias_grad(dout), ops.PLAIN.bias_grad(dout)
            exact, terms = dout.double().sum(0), dout.double().abs().sum(0)
        torch.cuda.synchronize()
        share = float(((got.double() - exact).abs() / (terms + 1e-30)).max())
        abs_err = float((got - ref).abs().max())
        check_close(name, f"per column <= {K2_TOL:.0e} x sum|terms| of the float64 sum; "
                    f"{abs_err:.2e} abs against the float32 plain version",
                    share <= K2_TOL and bool(torch.isfinite(got).all()), abs_err, share)
        row = kernel_row(name, "egonerf_torch/csrc/bias_grad.cu",
                         "egonerf_tpu/models/shading.py:71", abs_err,
                         time_ms(lambda: ops.KERNELS.bias_grad(dout)),
                         time_ms(lambda: ops.PLAIN.bias_grad(dout), reps=5),
                         nbytes(dout) + 4 * dout.shape[1], dout.numel(),
                         library_ms=time_ms(lambda: dout.sum(0)))
        if dout.shape[1] == model.shader.l1.out_features:
            rows["K11"] = row  # l1's (and l2's) bias
    missing = {"K10 fwd", "K10 da", "K10 db", "K11"} - set(rows)
    if missing:
        fail(f"phase 2: no recorded call for {sorted(missing)}")
    # the last step's autograd nodes keep the recording functions (their
    # ctx), and so the recorded activations, alive past this phase
    for recorded in calls.values():
        recorded.clear()
    return rows


def chunk_times(model, params, rays, chunk: int, render_kw: dict, wrappers):
    """Device ms of each of ``FORM_CHUNKS`` eval chunks of ``rays`` (after a
    warm one; CUDA events around each forward, all queued behind a device
    sleep), on tables prepared once, and the launches they made."""
    with torch.no_grad():
        tables = model.lookup_tables(params)

        def run(c):
            return model.forward(params, rays[c * chunk:(c + 1) * chunk], key=None,
                                 is_train=False, tables=tables, **render_kw)
        run(0)
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(FORM_CHUNKS)]
        torch.cuda._sleep(SLEEP_CYCLES)
        for c, (start, end) in enumerate(events, start=1):
            start.record()
            run(c)
            end.record()
        torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    return sorted(s.elapsed_time(e) for s, e in events), launches


def form_phases(phase: str, trainer, ops, renderer, dirs_np, per_chunk: dict, wrappers,
                step_want: dict, forms) -> dict:
    """Phase 7b (EgoNeRF, the production trainer) or 15b (TensoRF): under
    each of ``forms``, in this process and on the same weights as the
    default: the device ms of FORM_CHUNKS render chunks (median), their
    launches (``per_chunk`` a chunk, K10 as ``form_launches``), three chunks
    against the plain versions (rgb within REL_TOL, depth within
    REL_TOL x far), TRAIN_STEPS timed steps (median; ``step_want`` the
    default form's launches over them, K10/K11 as ``form_launches``) and one
    step against the plain versions (phase 7's limits).  Returns each
    form's (chunk ms, step ms, launches of the steps)."""
    model, params, cfg = trainer.model, trainer.params, trainer.cfg
    dev = trainer.device
    chunk = renderer.chunk
    dirs = torch.as_tensor(dirs_np, device=dev)
    n = FORM_CHUNKS + 1
    pick = torch.arange(n * chunk, device=dev) * (dirs.shape[0] // (n * chunk))
    rays = torch.cat([torch.zeros_like(dirs[pick]), dirs[pick]], dim=-1)
    e2e_rays = rays[:3 * chunk]
    far = model.near_far[1]
    out = {}
    for label, sw in forms:
        with shader_form(model, **sw):
            times, launches = chunk_times(model, params, rays, chunk, renderer.render_kwargs,
                                          wrappers)
            want = {k: per_chunk.get(k, 0) * FORM_CHUNKS for k in wrappers}
            want.update({k: v * FORM_CHUNKS for k, v in form_launches(model, sw, False).items()})
            expect_launches(f"phase {phase} {label} render", launches, want)
            got = renderer.render_rays(params, e2e_rays)
            model.ops = ops.PLAIN
            try:
                ref = renderer.render_rays(params, e2e_rays)
            finally:
                model.ops = ops.KERNELS
            d_rgb = float((got["rgb"] - ref["rgb"]).abs().max())
            d_depth = float((got["depth"] - ref["depth"]).abs().max())
            print(f"phase {phase} {label}: render chunk {times[len(times) // 2]:.3f} ms median "
                  f"of {FORM_CHUNKS} (min {times[0]:.3f}, max {times[-1]:.3f}); K10 "
                  f"{launches['K10']} launches over {FORM_CHUNKS} chunks; {3 * chunk} rays "
                  f"against the plain versions: max |rgb - plain| {d_rgb:.3e} (<= "
                  f"{REL_TOL:.1e}), max |depth - plain| {d_depth:.3e} (<= {REL_TOL * far:.1e})",
                  flush=True)
            if d_rgb > REL_TOL or d_depth > REL_TOL * far:
                fail(f"phase {phase} {label}: the render disagrees with the plain versions")
            want = dict(step_want)
            want.update({k: v * TRAIN_STEPS for k, v in form_launches(model, sw, True).items()})
            step_l, median = timed_steps(trainer.train_step, f"phase {phase} {label} training "
                                         "step", cfg, wrappers, want)
            step_vs_plain(trainer, ops, f"phase {phase} {label}")
        out[label] = (times[len(times) // 2], median, step_l)
    base_chunk, base_step, _ = out[forms[0][0]]
    for label, (c_ms, s_ms, step_l) in out.items():
        per = {k: step_l[k] // TRAIN_STEPS for k in ("K10", "K10da", "K10db", "K11")}
        print(f"phase {phase} summary {label}: chunk {c_ms:.3f} ms ({c_ms - base_chunk:+.3f} "
              f"against the default's {base_chunk:.3f}), step {s_ms:.3f} ms ({s_ms - base_step:+.3f} "
              f"against {base_step:.3f}); K10/K10da/K10db/K11 a step {per}", flush=True)
    return out


def combined_quality_phase(root: str, default_psnr: float, wrappers) -> None:
    """Phase 8b: the smoke run of phase 8 again, through the command line,
    under MIXED_MM + BIAS_DOT + HOIST_DIRS: it must launch K10 and K11 and
    land within the seed band of phase 8's test PSNR."""
    from egonerf_torch.__main__ import main as cli_main

    base = os.path.join(root, "build", "chip_smoke_runs", "forms")
    shutil.rmtree(base, ignore_errors=True)
    argv = ["--config", os.path.join(root, SMOKE_CONFIG), "--n_iters", str(SMOKE_ITERS),
            "--vis_list", f"[{SMOKE_ITERS}]", "--N_vis", "-1", "--basedir", base]
    for w in wrappers.values():
        w.launches = 0
    t0 = time.time()
    with shader_form(None, **COMBINED[1]):
        cli_main(argv)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    psnr = float(np.loadtxt(os.path.join(base, "smoke", "imgs_vis",
                                         f"{SMOKE_ITERS - 1:06d}_mean.txt"))[0])
    print(f"phase 8b smoke run under {COMBINED[0]} ({SMOKE_ITERS} iterations, "
          f"{time.time() - t0:.1f} s with its evaluation): test PSNR {psnr:.2f} dB against "
          f"phase 8's {default_psnr:.2f} dB ({psnr - default_psnr:+.2f}; band +-{SEED_BAND_DB}); "
          f"launches {launches}", flush=True)
    if min(launches[k] for k in ("K10", "K10da", "K10db", "K11")) < 1:
        fail("the smoke run under the combined forms launched no K10 or K11")
    if not abs(psnr - default_psnr) <= SEED_BAND_DB:
        fail(f"the combined forms' smoke PSNR {psnr:.2f} dB is outside the {SEED_BAND_DB} dB "
             f"band of the default's {default_psnr:.2f}")


def k12_cost(z_vals, coarse_z):
    """K12's bytes (z, the coarse depths and weights read once, the score
    written once) and operations (the dilation's two max a coarse sample; a
    search of ceil(log2(C + 1)) steps of ~3 operations and the select a
    sample)."""
    r, s = z_vals.shape
    c = coarse_z.shape[1]
    return 4 * r * (2 * s + 2 * c), r * (2 * c + s * (3 * int(np.ceil(np.log2(c + 1))) + 2))


def k13_cost(r, s, k):
    """K13's bytes (z, dists and the score read once, the kept z and dists
    written once) and the function's operations, whatever design computes
    it: a sample's order key (~4) and its rank against the K-th largest
    key with the ties before it (a compare and a count, 2), a kept
    sample's two copies."""
    return 4 * r * (3 * s + 2 * k), r * (6 * s + 2 * k)


def bits_equal(name, kern, plain, args) -> float:
    """K12, K13 or K4's weights against the plain version on ``args``: the
    outputs equal bit for bit; returns the max abs error (0)."""
    got, ref = kern(*args), plain(*args)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for o, r in zip(got, ref):
        if o.shape != r.shape or not torch.isfinite(o).all():
            fail(f"{name}: shape {tuple(o.shape)} (plain {tuple(r.shape)}) or non-finite")
    diff = sum(int((o.view(torch.int32) != r.view(torch.int32)).sum()) for o, r in zip(got, ref))
    abs_err = max_err(got, ref)[0]
    print(f"phase 2 {name}: {diff} of {sum(o.numel() for o in got):,} outputs differ from the "
          f"plain version's bits (0 allowed), max abs err {abs_err:.3e} -> "
          f"{'ok' if diff == 0 else 'MISS'}", flush=True)
    if diff:
        fail(f"{name} disagrees with its plain version")
    return abs_err


def k4_weights_compare(name, ops, args, far) -> float:
    """K4's weights instantiation against its plain version: z_vals and
    dists within 1e-5 x far as K4's (and equal bit for bit to the kernel's
    other instantiation on the same inputs: one code path), the weights
    within rel REL_TOL of max|plain| (expf and the products' order, as K6's
    weights).  Returns the max abs error."""
    got = ops.KERNELS.resample_weights(*args)
    ref = ops.PLAIN.resample_weights(*args)
    other = ops.pdf.resample(*args)
    torch.cuda.synchronize()
    for o, r in zip(got, ref):
        if o.shape != r.shape or not torch.isfinite(o).all():
            fail(f"{name}: shape {tuple(o.shape)} (plain {tuple(r.shape)}) or non-finite")
    z_err = max_err(got[:2], ref[:2])[0]
    w_abs, w_rel = max_err(got[2:], ref[2:])
    same = all(torch.equal(a, b) for a, b in zip(got[:2], other))
    w_bits = int((got[2].view(torch.int32) != ref[2].view(torch.int32)).sum())
    ok = z_err <= REL_TOL * far and w_rel <= REL_TOL and same
    print(f"phase 2 {name}: depths max abs err {z_err:.3e} (<= {REL_TOL * far:.1e}), equal to "
          f"resample_fwd's bit for bit: {same}; weights max abs err {w_abs:.3e}, rel "
          f"{w_rel:.3e} (<= {REL_TOL:.0e} of max|plain|), {w_bits:,} of {got[2].numel():,} "
          f"differ in their bits -> {'ok' if ok else 'MISS'}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return max(z_err, w_abs)


def k4c_compare(name, ops, args, far) -> float:
    """K4c against its plain version on ``args``: z_vals and dists within
    1e-5 x far as K4's, and equal bit for bit to those of K4's weights
    instantiation on the same inputs (the two launches K4c replaces); the
    score bit for bit with K12's plain version on the kernel's depths and
    the plain weights.  Returns the max abs error."""
    from egonerf_torch.ops.cull import coarse_importance_plain

    got = ops.KERNELS.resample_score(*args)
    ref = ops.PLAIN.resample_weights(*args)
    pair = ops.KERNELS.resample_weights(*args)
    torch.cuda.synchronize()
    if (any(o.shape != ref[0].shape or not torch.isfinite(o).all() for o in got)
            or ref[1].shape != ref[0].shape):
        fail(f"{name}: shapes {[tuple(o.shape) for o in got]} (plain {tuple(ref[0].shape)}) or "
             f"non-finite")
    ref_s = coarse_importance_plain(got[0], args[1], ref[2])
    z_err = max_err(got[:2], ref[:2])[0]
    same = all(torch.equal(a, b) for a, b in zip(got[:2], pair[:2]))
    s_bits = int((got[2].view(torch.int32) != ref_s.view(torch.int32)).sum())
    s_err = max_err(got[2:], (ref_s,))[0]
    ok = z_err <= REL_TOL * far and same and s_bits == 0
    print(f"phase 2 {name}: depths max abs err {z_err:.3e} (<= {REL_TOL * far:.1e}), equal to "
          f"K4's weights instantiation's bit for bit: {same}; scores: {s_bits} of "
          f"{got[2].numel():,} differ from K12's plain version's bits on the plain weights (0 "
          f"allowed), {int((got[2] == 0).sum()):,} zero -> {'ok' if ok else 'MISS'}",
          flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return max(z_err, s_err)


def k4c_cost(c_feat, n_f, n_out):
    """K4c's bytes (K4's, and the score written once) and operations (K4's,
    and a select and a max or two an output)."""
    n_bytes, n_ops = k4_cost(c_feat, n_f, n_out)
    return n_bytes + 4 * c_feat.shape[0] * n_out, n_ops + 3 * c_feat.shape[0] * n_out


def cull_chain_checks(label, ops, args, far, keeps) -> tuple:
    """K4's weights and K12 on its output (the standalone ops), K4c, and
    K13 on K4c's scores at each of ``keeps`` and at 1 and S - 1, each
    against its plain version on the kernel's own inputs.  Returns
    (z_vals, dists, weights, score)."""
    from egonerf_torch.ops import cull

    k4_weights_compare(f"K4 weights ({label})", ops, args, far)
    z_vals, dists, weights = ops.KERNELS.resample_weights(*args)
    coarse_z = args[1]
    bits_equal(f"K12 coarse_importance ({label})", cull.coarse_importance,
               cull.coarse_importance_plain, (z_vals, coarse_z, weights))
    k4c_compare(f"K4c resample_score ({label})", ops, args, far)
    z_vals, dists, score = ops.KERNELS.resample_score(*args)
    s = z_vals.shape[1]
    for k in sorted({*keeps, 1, s - 1}, reverse=True):
        bits_equal(f"K13 select_top_k ({label}, K={k})", ops.KERNELS.select_top_k,
                   ops.PLAIN.select_top_k, (z_vals, dists, score, k))
    return z_vals, dists, weights, score


@torch.no_grad()
def cull_kernel_checks(model, params, dirs, ops, presets, trainer) -> dict:
    """Phase 2, the empty-space cull: K4c, the standalone K4 weights
    instantiation and K12, and K13 on one production chunk (eval), at the
    smoke config's 48 + 48 samples, on hard rays (all-zero weights, one
    spike, repeated coarse depths, long runs of equal scores, perturbed
    scores; K4c also on K4's hard rays, K5's uniforms and without the
    merge) and on a recorded culled production training step, each against
    its plain version: K4c's score, K12 and K13 bit for bit; the rows with
    their times and bounds."""
    from egonerf_torch.models.egonerf import _dists
    from egonerf_torch.ops import cull

    dev = dirs.device
    cfg, coords = model.cfg, model.coordinates
    chunk = presets.EVAL_CHUNK
    n_c, n_f = presets.RENDER["n_coarse"], presets.RENDER["n_fine"]
    pick = torch.arange(chunk, device=dev) * (dirs.shape[0] // chunk)
    viewdirs = dirs[pick]
    rays_o = torch.zeros_like(viewdirs)
    tables = model.lookup_tables(params)
    act = (cfg.density_shift, cfg.distance_scale, cfg.fea2dense_act)
    far = model.near_far[1]
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)

    def coarse(n):
        z = model.sample_depths_exp(chunk, n, dev)
        norm = ops.KERNELS.chart(rays_o, viewdirs, z, coords, 2)
        f = ops.KERNELS.density(norm, tables.coarse_planes, tables.coarse_lines)
        return f.reshape(chunk, n), z, _dists(z)

    c_feat, coarse_z, coarse_dists = coarse(n_c)
    args = (c_feat, coarse_z, coarse_dists, n_f, None, True, *act)
    z_vals, dists, weights, score = cull_chain_checks("eval chunk", ops, args, far, CULL_KEEPS)
    r, s = z_vals.shape
    print(f"phase 2 cull inputs: {r} rays x {s} merged samples from {n_c} coarse; "
          f"{int((weights == 0).sum()):,} of {weights.numel():,} coarse weights 0, "
          f"{int((score == 0).sum()):,} of {score.numel():,} scores 0", flush=True)

    # the smoke config's widths: 48 + 48 merged, keep SMOKE_KEEP
    f48, z48, d48 = coarse(48)
    cull_chain_checks("48 + 48, eval", ops, (f48, z48, d48, 48, None, True, *act), far,
                      (SMOKE_KEEP,))

    # hard rays, the chunk's first 1024
    h = min(1024, r)
    zh, ch = z_vals[:h].contiguous(), coarse_z[:h].contiguous()
    zero = torch.zeros_like(weights[:h])
    spike = zero.clone()
    spike[torch.arange(h, device=dev),
          torch.randint(0, n_c, (h,), generator=gen, device=dev)] = 0.5
    for label, w in (("all-zero weights", zero), ("one spike", spike)):
        bits_equal(f"K12 coarse_importance ({label})", cull.coarse_importance,
                   cull.coarse_importance_plain, (zh, ch, w))
        sh = cull.coarse_importance(zh, ch, w)
        for k in (*CULL_KEEPS, 1, s - 1):
            bits_equal(f"K13 select_top_k ({label}, K={k})", ops.KERNELS.select_top_k,
                       ops.PLAIN.select_top_k, (zh, dists[:h].contiguous(), sh, k))
    z_rep = ch[:, ::2].repeat_interleave(2, dim=1)[:, :n_c].contiguous()
    _, _, w_rep, s_rep = cull_chain_checks(
        "repeated coarse depths", ops,
        (c_feat[:h].contiguous(), z_rep, _dists(z_rep), n_f, None, True, *act), far, CULL_KEEPS)
    runs = (torch.randint(0, 3, (h, -(-s // 16)), generator=gen, device=dev).float() * 0.25)
    runs = runs.repeat_interleave(16, dim=1)[:, :s].contiguous()
    u = torch.rand(r, s, generator=gen, device=dev)
    for label, sc in (("long runs of equal scores", runs),
                      ("tie-break scores", cull.train_tiebreak(score, u)[:h].contiguous()),
                      ("Gumbel scores, tau 1", cull.gumbel_perturb(score, u, 1.0)[:h].contiguous())):
        for k in (*CULL_KEEPS, 1, s - 1):
            bits_equal(f"K13 select_top_k ({label}, K={k})", ops.KERNELS.select_top_k,
                       ops.PLAIN.select_top_k, (zh, dists[:h].contiguous(), sc, k))
    print(f"phase 2 cull hard rays: {h} rays; repeated coarse depths give "
          f"{int((z_rep[:, 1:] == z_rep[:, :-1]).sum()):,} empty intervals, "
          f"{int((s_rep == 0).sum()):,} zero scores", flush=True)
    # K4c on K4's hard rays (zero density, one spike, repeated coarse
    # depths, u near 1 and on the cdf's edges, u reversed: the full-rank
    # walk), on K5's sorted uniforms and without the merge
    u = ops.KERNELS.sorted_uniform(chunk, n_f, SEED, 0, dev)
    for label, f_h, z_h, d_h, u_h in k4_hard_inputs(c_feat, coarse_z, n_f, act, u):
        k4c_compare(f"K4c resample_score ({label})", ops, (f_h, z_h, d_h, n_f, u_h, True, *act),
                    far)
    for label, u_in, merge in (("sorted uniforms", u, True), ("no merge", None, False)):
        k4c_compare(f"K4c resample_score ({label})", ops,
                    (c_feat, coarse_z, coarse_dists, n_f, u_in, merge, *act), far)
    # other widths: 160 + 96 (the instantiation for more than 128 samples a
    # lane set), 34 + 31 (pdf runs unlike the weights' runs, scalar rows)
    for n_cw, n_fw in ((160, 96), (34, 31)):
        k4c_compare(f"K4c resample_score ({n_cw} + {n_fw})", ops,
                    (*coarse(n_cw), n_fw, None, True, *act), far)

    # a recorded culled production training step (tie-break, keep 128)
    model_t, cfg_t = trainer.model, trainer.cfg
    logs = {k: Recorder(getattr(ops.KERNELS, k)) for k in ("resample_score", "select_top_k")}
    model_t.ops = ops.KERNELS._replace(**logs)
    cfg_t.train_keep = CULL_TRAIN_KEEP
    try:
        with torch.enable_grad():
            trainer.train_step(0)
    finally:
        model_t.ops = ops.KERNELS
        cfg_t.train_keep = 0
    torch.cuda.synchronize()
    # the step drew its u in K4c's prologue: the checks on K5's uniforms for
    # its key, and the draw itself bit for bit
    t_draw = logs["resample_score"].kwargs["draw"]
    draw_equal("K4c + draw (culled training step)", ops, ops.KERNELS.resample_score,
               logs["resample_score"].args, t_draw)
    t_args = drawn_u(ops, logs["resample_score"].args, t_draw)
    k4c_compare("K4c resample_score (training step)", ops, t_args, model_t.near_far[1])
    k4_weights_compare("K4 weights (training step)", ops, t_args, model_t.near_far[1])
    tw = ops.KERNELS.resample_weights(*t_args)
    bits_equal("K12 coarse_importance (training step)", cull.coarse_importance,
               cull.coarse_importance_plain, (tw[0], t_args[1], tw[2]))
    tz, td, ts, _ = logs["select_top_k"].args
    for k in sorted({CULL_TRAIN_KEEP, *CULL_KEEPS}, reverse=True):
        bits_equal(f"K13 select_top_k (training step, tie-break, K={k})",
                   ops.KERNELS.select_top_k, ops.PLAIN.select_top_k, (tz, td, ts, k))
    print(f"phase 2 cull training inputs: {tz.shape[0]} rays x {tz.shape[1]} merged samples "
          f"(K5's uniforms, jittered coarse depths), tie-break scores", flush=True)

    # the rows: one production chunk's inputs at keep CULL_KEEPS[0]; K4w and
    # K12 are the standalone ops (the oracle scorer takes K4w's depths)
    table = {"K4c": kernel_row(
        "K4c resample_score", "egonerf_torch/csrc/resample.cu", "egonerf_tpu/ops/cull.py:30",
        k4c_compare("K4c resample_score (row)", ops, args, far),
        time_ms(lambda: ops.KERNELS.resample_score(*args)),
        time_ms(lambda: ops.PLAIN.resample_score(*args), reps=5), *k4c_cost(c_feat, n_f, s))}
    n_bytes, n_ops = k4_cost(c_feat, n_f, s)
    table["K4w"] = kernel_row(
        "K4 weights", "egonerf_torch/csrc/resample.cu", "egonerf_tpu/models/egonerf.py:393",
        k4_weights_compare("K4 weights (row)", ops, args, far),
        time_ms(lambda: ops.KERNELS.resample_weights(*args)),
        time_ms(lambda: ops.PLAIN.resample_weights(*args), reps=5), n_bytes + 4 * r * n_c,
        n_ops)
    k12 = (z_vals, coarse_z, weights)
    table["K12"] = kernel_row(
        "K12 coarse_importance", "egonerf_torch/csrc/cull.cu", "egonerf_tpu/ops/cull.py:30",
        bits_equal("K12 coarse_importance (row)", cull.coarse_importance,
                   cull.coarse_importance_plain, k12),
        time_ms(lambda: cull.coarse_importance(*k12)),
        time_ms(lambda: cull.coarse_importance_plain(*k12), reps=5), *k12_cost(z_vals, coarse_z))
    print(f"phase 2 K4c: one launch {table['K4c']['ms']:.4f} ms; the two it replaces, K4w "
          f"{table['K4w']['ms']:.4f} + K12 {table['K12']['ms']:.4f} = "
          f"{table['K4w']['ms'] + table['K12']['ms']:.4f} ms", flush=True)
    for k in CULL_KEEPS:
        k13 = (z_vals, dists, score, k)
        row = kernel_row(
            f"K13 select_top_k (K={k})", "egonerf_torch/csrc/cull.cu",
            "egonerf_tpu/ops/cull.py:103",
            bits_equal(f"K13 select_top_k (row, K={k})", ops.KERNELS.select_top_k,
                       ops.PLAIN.select_top_k, k13),
            time_ms(lambda: ops.KERNELS.select_top_k(*k13)),
            time_ms(lambda: ops.PLAIN.select_top_k(*k13), reps=5), *k13_cost(r, s, k),
            library_ms=topk_library_ms(f"K13 (K={k})", z_vals, dists, score, k, ops))
        table.setdefault("K13", row)
    return table


def topk_library_ms(label, z_vals, dists, score, k, ops) -> float:
    """The library call beside K13: ``torch.topk(score, k)`` on the same
    scores, timed; printed beside it, the whole selection in library calls
    (topk, a sort of the kept indices, two gathers) and the rays whose kept
    set differs from K13's (``lax.top_k`` breaks ties toward the lower
    index, K13 too; ``torch.topk`` promises no tie rule)."""
    topk_ms = time_ms(lambda: torch.topk(score, k, dim=-1))

    def select():
        idx = torch.topk(score, k, dim=-1, sorted=False).indices.sort(dim=-1).values
        return torch.gather(z_vals, -1, idx), torch.gather(dists, -1, idx)
    whole_ms = time_ms(select)
    z_lib, _ = select()
    z_k13, _ = ops.KERNELS.select_top_k(z_vals, dists, score, k)
    differ = int((z_lib != z_k13).any(dim=-1).sum())
    ties = int((score[:, 1:] == score[:, :-1]).any(dim=-1).sum())
    print(f"phase 2 {label}: torch.topk {topk_ms:.4f} ms; topk + sort + two gathers "
          f"{whole_ms:.4f} ms; its kept set differs from K13's (ties to the lower index) on "
          f"{differ} of {score.shape[0]} rays ({ties} rays hold equal neighbouring scores)",
          flush=True)
    return topk_ms


def kept_set_diff(calls_a, calls_b) -> tuple:
    """(rays whose kept sample set differs, rays whose scores differ in any
    bit, rays) between two logs of K13's calls on the same rays."""
    from egonerf_torch.ops.cull import select_top_k_plain

    n_set = n_score = n = 0
    for (za, _, sa, k), (_, _, sb, _) in zip(calls_a, calls_b):
        idx = torch.arange(za.shape[1], device=za.device, dtype=torch.float32).expand_as(za)
        ka = select_top_k_plain(idx, idx, sa, k)[0]
        kb = select_top_k_plain(idx, idx, sb, k)[0]
        n_set += int((ka != kb).any(1).sum())
        n_score += int((sa.view(torch.int32) != sb.view(torch.int32)).any(1).sum())
        n += za.shape[0]
    return n_set, n_score, n


def logged_render(model, params, rays, chunk, render_kw, ops, o) -> list:
    """Render ``rays`` with the ops ``o``; returns K13's calls."""
    from egonerf_torch.render.renderer import Renderer

    log = CallLog(o.select_top_k)
    model.ops = o._replace(select_top_k=log)
    try:
        Renderer(model, chunk=chunk, **render_kw).render_rays(params, rays)
    finally:
        model.ops = ops.KERNELS
    return log.calls


def cull_render_phases(model, params, dirs_np, ops, presets, wrappers, unculled_s) -> dict:
    """Phases 3c-5c: the 2000x1000 view through ``Renderer.render_view`` at
    each eval_keep of CULL_KEEPS (launches a chunk: one each of K3, K4c,
    K13, K1, K6, and two of K7; no K4, K4w or K12), a few
    chunks against the plain versions (phase 4's limits) with the rays
    whose kept set differs, where the time goes; then the render chunk's
    device ms, default and culled, in one process.  Returns the launches
    of the view at CULL_KEEPS[0]."""
    from egonerf_torch.render.renderer import Renderer

    chunk = presets.EVAL_CHUNK
    per_chunk = dict(K1=1, K3=1, K4c=1, K6=1, K7=2, K13=1)
    dev = model.device
    dirs = torch.as_tensor(dirs_np, device=dev)
    n = FORM_CHUNKS + 1
    pick = torch.arange(n * chunk, device=dev) * (dirs.shape[0] // (n * chunk))
    rays = torch.cat([torch.zeros_like(dirs[pick]), dirs[pick]], dim=-1)
    views, chunks = {}, {}
    base_ms, base_l = chunk_times(model, params, rays, chunk, presets.RENDER, wrappers)
    for keep in CULL_KEEPS:
        kw = dict(presets.RENDER, eval_keep=keep)
        tag = f"c (eval_keep {keep})"
        launches, s_image = render_phases(
            model, params, dirs_np, ops, presets, Renderer, wrappers,
            phases=(f"3{tag}", f"4{tag}", f"5{tag}"),
            renderer=Renderer(model, chunk=chunk, **kw), per_chunk=per_chunk)
        e2e = rays[:3 * chunk]
        n_set, n_score, n_rays = kept_set_diff(
            logged_render(model, params, e2e, chunk, kw, ops, ops.KERNELS),
            logged_render(model, params, e2e, chunk, kw, ops, ops.PLAIN))
        print(f"phase 4{tag}: {n_set} of {n_rays} rays keep a different sample set with the "
              f"kernels than with the plain versions; {n_score} rays' scores differ in any bit",
              flush=True)
        times, chunk_l = chunk_times(model, params, rays, chunk, kw, wrappers)
        expect_launches(f"phase 3{tag} chunks", chunk_l,
                        {k: per_chunk.get(k, 0) * FORM_CHUNKS for k in wrappers})
        views[keep], chunks[keep] = (launches, s_image), times[len(times) // 2]
    base = base_ms[len(base_ms) // 2]
    print(f"phase 3c summary: s/image unculled {unculled_s:.3f} (phase 3), "
          + ", ".join(f"eval_keep {k} {views[k][1]:.3f}" for k in CULL_KEEPS)
          + f"; render chunk device ms (median of {FORM_CHUNKS}) unculled {base:.3f}, "
          + ", ".join(f"eval_keep {k} {chunks[k]:.3f} ({chunks[k] / base:.1%})"
                      for k in CULL_KEEPS), flush=True)
    if base_l["K12"] or base_l["K13"] or base_l["K4w"] or base_l["K4c"]:
        fail(f"the unculled chunks launched the cull's kernels: {base_l}")
    return views[CULL_KEEPS[0]][0]


def cull_train_phases(trainer, ops, wrappers, unculled_ms) -> dict:
    """Phases 6c and 7c: TRAIN_STEPS timed production steps at train_keep
    CULL_TRAIN_KEEP with the tie-break, with Gumbel scores (tau 1) and with
    an unculled step every CULL_FULL_EVERY (each culled step launches K1-K3,
    K4c in its training instantiation (K5's draws in its prologue), K6, K6b
    and K13 once and K7 twice, no K4, K4w, K5 or K12; a full step the
    default's kernels), then one culled step against the plain versions
    with the same draws.  Returns the launches of the tie-break's steps."""
    cfg = trainer.cfg
    culled = {"K1", "K2", "K3", "K4c", "K4c+draw", "K6", "K6b", "K13"}
    full = step_launches(wrappers, envmap=False)
    medians, launches = {}, {}
    try:
        for label, tau, every in (("tie-break", 0.0, 0), ("Gumbel, tau 1", 1.0, 0),
                                  (f"full step every {CULL_FULL_EVERY}", 0.0, CULL_FULL_EVERY)):
            cfg.train_keep, cfg.train_cull_tau, cfg.train_keep_full_every = (
                CULL_TRAIN_KEEP, tau, every)
            its = range(TRAIN_WARMUP + 1, TRAIN_WARMUP + 1 + TRAIN_STEPS)
            n_full = sum(1 for it in its if every and it % every == 0)
            want = {k: (full[k] // TRAIN_STEPS) * n_full
                    + (TRAIN_STEPS - n_full) * ((k in culled) + (k == "K7") * 2)
                    for k in wrappers}
            launches[label], medians[label] = timed_steps(
                trainer.train_step, f"phase 6c train_keep {CULL_TRAIN_KEEP}, {label}", cfg,
                wrappers, want)
    finally:
        cfg.train_keep, cfg.train_cull_tau, cfg.train_keep_full_every = 0, 0.0, 0
    print(f"phase 6c summary: median step ms unculled {unculled_ms:.3f} (phase 6), "
          + ", ".join(f"{k} {v:.3f} ({v / unculled_ms:.1%})" for k, v in medians.items())
          + " (the last a culled step: its mean is in its line)", flush=True)
    step_vs_plain(trainer, ops, "phase 7c", cull_keep=CULL_TRAIN_KEEP)
    return launches["tie-break"]


def cull_quality_phase(root: str, smoke_psnr: float) -> None:
    """Phase 8c: phase 8's trained smoke model rendered at eval_keep
    SMOKE_KEEP (of its 48 + 48 merged samples) and unculled on its test
    views: the test PSNR of each against ground truth, and the culled
    render's against the unculled one.  A record, with no floor."""
    from egonerf_torch.data.datasets import dataset_class
    from egonerf_torch.render.metrics import psnr
    from egonerf_torch.render.renderer import Renderer
    from egonerf_torch.train.checkpoint import latest_checkpoint
    from egonerf_torch.train.config import parse_cli
    from egonerf_torch.train.trainer import _load_model

    base = os.path.join(root, "build", "chip_smoke_runs")
    cfg = parse_cli(["--config", os.path.join(root, SMOKE_CONFIG), "--basedir", base])
    test = dataset_class(cfg.dataset_name)(
        data_dir=cfg.datadir, split="test", is_stack=True, downsample=1, near_far=cfg.near_far,
        roi=cfg.roi, localization_method=cfg.localization_method, skip=1)
    model, _ = _load_model(cfg, latest_checkpoint(os.path.join(base, "smoke")), test.scene_bbox,
                           test.near_far, DEVICE)
    params = model.params()
    full = Renderer.from_config(model, cfg, test.white_bg)
    culled = Renderer.from_config(model, cfg, test.white_bg, eval_keep=SMOKE_KEEP)
    w, h = test.img_wh
    rows = []
    t0 = time.time()
    for i in range(test.all_rays.shape[0]):
        rays = test.all_rays[i].reshape(-1, 6)
        gt = np.asarray(test.all_rgbs[i]).reshape(h, w, 3)
        a = full.render_rays(params, rays)["rgb"].reshape(h, w, 3).cpu().numpy()
        b = culled.render_rays(params, rays)["rgb"].reshape(h, w, 3).cpu().numpy()
        rows.append((psnr(a, gt), psnr(b, gt), psnr(b, a)))
    full_gt, cull_gt, cull_full = np.mean(rows, axis=0)
    print(f"phase 8c smoke model at eval_keep {SMOKE_KEEP} of {cfg.n_coarse} + {cfg.n_fine} "
          f"merged samples ({len(rows)} test views, {time.time() - t0:.1f} s): test PSNR "
          f"{cull_gt:.2f} dB against ground truth (unculled {full_gt:.2f}; phase 8 "
          f"{smoke_psnr:.2f}), {cull_full:.2f} dB against the unculled render (a record, no "
          f"floor)", flush=True)
    if not np.isfinite([cull_gt, full_gt]).all():
        fail("phase 8c: non-finite PSNR")


# -- the captured-data path: K14-K16 (phase 2) and phases 19-21 ---------------
def ids_equal(name, ops, args) -> None:
    """K14 against its plain version on ``args``: every id equal."""
    got, ref = ops.KERNELS.theta_ids(*args), ops.PLAIN.theta_ids(*args)
    torch.cuda.synchronize()
    diff = int((got != ref).sum()) if got.shape == ref.shape else -1
    print(f"phase 2 {name}: {diff} of {ref.numel():,} ids differ from the plain version's "
          f"(0 allowed) -> {'ok' if diff == 0 else 'MISS'}", flush=True)
    if diff:
        fail(f"{name} disagrees with its plain version")


def theta_launches(wrappers, steps: int) -> str:
    """The theta sampler's launches over ``steps`` theta steps: K14f once a
    step and no K14 (the row pick alone); fails otherwise."""
    k14f, k14 = wrappers["K14f"].launches, wrappers["K14"].launches
    if k14f != steps or k14:
        fail(f"{k14f} K14f and {k14} K14 launches over {steps} theta steps (expect {steps} "
             f"and 0)")
    return f"K14f launched {k14f} times (expect {steps}), K14 {k14} (expect 0)"


def batch_equal(name, ops, args) -> torch.Tensor:
    """K14f against its plain version on ``args``: every id and every row
    value bit for bit.  Returns the ids."""
    got, ref = ops.KERNELS.theta_batch(*args), ops.PLAIN.theta_batch(*args)
    torch.cuda.synchronize()
    same = all(g.shape == r.shape for g, r in zip(got, ref))
    d_ids = int((got[0] != ref[0]).sum()) if same else -1
    d_rows = bits_differ(got[1:], ref[1:]) if same else -1
    print(f"phase 2 {name}: {d_ids} of {ref[0].numel():,} ids and {d_rows} of "
          f"{ref[1].numel():,} row values differ from the plain version's (0 allowed) -> "
          f"{'ok' if d_ids == d_rows == 0 else 'MISS'}", flush=True)
    if d_ids or d_rows:
        fail(f"{name} disagrees with its plain version")
    return got[0]


def hard_uniforms(cdf: torch.Tensor) -> torch.Tensor:
    """K14's hard uniforms on ``cdf``: 0, 1 - ulp, the float32 successor of
    cdf[-1] (above it: the clamp), every cdf value (ties take the first row)
    and both float32 neighbours of each."""
    one = torch.ones_like(cdf[:1])
    return torch.cat([torch.zeros_like(cdf[:1]), torch.nextafter(one, torch.zeros_like(one)),
                      torch.nextafter(cdf[-1:], 2 * one), cdf,
                      torch.nextafter(cdf, torch.full_like(cdf, 2.0)),
                      torch.nextafter(cdf, torch.full_like(cdf, -1.0))])


def theta_raster(roi, n_img=THETA_IMAGES, batch=THETA_DRAWS):
    """JAX's ThetaImportanceSampler (the port's copy) on the Ricoh raster
    cropped by ``roi``, over ``n_img`` images."""
    from egonerf_torch.data.samplers import ThetaImportanceSampler

    w0, h0 = RICOH_WH
    w = int(roi[3] * w0) - int(roi[2] * w0)
    h = int(roi[1] * h0) - int(roi[0] * h0)
    return ThetaImportanceSampler(THETA_LAMBDA, n_img * w * h, RICOH_WH, batch, roi)


def theta_draws(sam, n, gen, dev):
    """(img, col, u, cdf, w, h): ``n`` draws of the theta sampler's step,
    from ``gen``, and its float32 cdf."""
    cdf = torch.as_tensor(np.cumsum(sam.weight).astype(np.float32), device=dev)
    img = torch.randint(0, sam.img_len, (n,), generator=gen, device=dev)
    col = torch.randint(0, sam.w, (n,), generator=gen, device=dev)
    u = torch.rand(n, generator=gen, device=dev)
    return img, col, u, cdf, sam.w, sam.h


def theta_kernel_checks(ops) -> dict:
    """Phase 2, K14: bit for bit against its plain version on a production
    batch (4,096 draws) of the Ricoh raster, full and roi-cropped, on hard
    uniforms of each, on a cdf with ties ending below 1, and at h = 1; its
    row, timed beside ``torch.searchsorted`` on the same cdf and uniforms."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    for roi in THETA_ROIS:
        args = theta_draws(theta_raster(roi), THETA_DRAWS, gen, dev)
        ids_equal(f"K14 {args[4]}x{args[5]} raster, roi {list(roi)}", ops, args)
        cdf = args[3]
        u = hard_uniforms(cdf)
        zeros = torch.zeros(u.shape[0], dtype=torch.int64, device=dev)
        ids_equal(f"K14 {u.shape[0]:,} hard uniforms, roi {list(roi)}", ops,
                  (zeros, zeros, u, cdf, args[4], args[5]))
    ties = torch.tensor([0.1, 0.1, 0.1, 0.5, 0.5, 0.9999], device=dev)
    u = hard_uniforms(ties)
    zeros = torch.zeros(u.shape[0], dtype=torch.int64, device=dev)
    ids_equal("K14 ties and a cdf ending below 1", ops, (zeros, zeros, u, ties, 1, 6))
    one = torch.ones(1, device=dev)
    u = torch.tensor([0.0, 0.5, 1.0, 2.0], device=dev)
    zeros = torch.zeros(4, dtype=torch.int64, device=dev)
    ids_equal("K14 h = 1", ops, (zeros, torch.arange(4, device=dev), u, one, 5, 1))
    img, col, u, cdf, w, h = args
    n_bytes = nbytes(img, col, u, cdf) + 8 * u.shape[0]
    # a draw: ceil(log2 h) probes of a compare and a select, the id's
    # multiply-adds
    n_ops = u.shape[0] * (2 * int(np.ceil(np.log2(h))) + 6)
    lib_ms = time_ms(lambda: torch.searchsorted(cdf, u, side="left"))
    table = {"K14": kernel_row(
        "K14", "egonerf_torch/csrc/theta_sampler.cu", "egonerf_tpu/data/samplers.py:98", 0.0,
        time_ms(lambda: ops.KERNELS.theta_ids(*args)),
        time_ms(lambda: ops.PLAIN.theta_ids(*args), reps=5), n_bytes, n_ops, library_ms=lib_ms)}
    table["K14f"] = theta_batch_checks(ops, gen)
    return table


def theta_batch_checks(ops, gen) -> dict:
    """Phase 2, K14f (the theta sampler drawing, picking and gathering a
    batch in one launch) bit for bit against its plain version: a
    production batch (4,096 draws) of each Ricoh raster's buffer at two
    consecutive batch counters, which must differ, 2^20 draws (the grid
    strides), K14's cdf with ties ending below 1, h = 1, and a cdf too long
    to stage.  Returns its row, on the roi-cropped raster."""
    dev = torch.device(DEVICE)
    for roi in THETA_ROIS:
        sam = theta_raster(roi)
        cdf = torch.as_tensor(np.cumsum(sam.weight).astype(np.float32), device=dev)
        buffer = torch.rand(sam.img_len * sam.w * sam.h, 9, generator=gen, device=dev)
        ids = [batch_equal(f"K14f {sam.w}x{sam.h} raster, roi {list(roi)}, batch {t}", ops,
                           (buffer, cdf, sam.w, sam.h, THETA_DRAWS, SEED, t)) for t in (1, 2)]
        same = int((ids[0] == ids[1]).sum())
        print(f"phase 2 K14f batches 1 and 2: {same} of {THETA_DRAWS} ids equal", flush=True)
        if same > THETA_DRAWS // 100:
            fail("K14f's consecutive batches repeat their draws")
    batch_equal(f"K14f {sam.w}x{sam.h} raster, {1 << 20:,} draws", ops,
                (buffer, cdf, sam.w, sam.h, 1 << 20, SEED, 3))
    ties = torch.tensor([0.1, 0.1, 0.1, 0.5, 0.5, 0.9999], device=dev)
    long_cdf = torch.as_tensor(np.cumsum(np.full(20000, 1 / 20000)).astype(np.float32),
                               device=dev)
    for label, c, w in (("ties and a cdf ending below 1", ties, 1),
                        ("h = 1", torch.ones(1, device=dev), 5),
                        (f"h = {long_cdf.shape[0]:,} (the cdf read, not staged)", long_cdf, 1)):
        small = torch.rand(4 * c.shape[0] * w, 9, generator=gen, device=dev)
        batch_equal(f"K14f {label}", ops, (small, c, w, c.shape[0], 1 << 16, SEED, 4))
    args = (buffer, cdf, sam.w, sam.h, THETA_DRAWS, SEED, 5)
    # a draw: the id read and the row read and written; the cdf once
    n_bytes = THETA_DRAWS * (8 + 2 * 36) + 4 * sam.h
    # a draw: 10 Philox rounds (~8 integer operations each), the mapping,
    # ceil(log2 h) probes of a compare and a select, the id's multiply-adds
    n_ops = THETA_DRAWS * (80 + 6 + 2 * int(np.ceil(np.log2(sam.h))) + 6)
    return kernel_row(
        "K14f theta_batch", "egonerf_torch/csrc/theta_sampler.cu",
        "egonerf_tpu/data/samplers.py:87", 0.0, time_ms(lambda: ops.KERNELS.theta_batch(*args)),
        time_ms(lambda: ops.PLAIN.theta_batch(*args), reps=5), n_bytes, n_ops)


def nograd_kernel_checks(ops) -> dict:
    """Phase 2, K15 and K16 at the production fine grid's shapes (phase 36's
    ``microbench_lookup`` calls them): the 2-chart (172, 516) plane and 516-row line at 16
    channels over one chunk's 1,048,576 points, coords over [-1.05, 1.05]
    and random charts, each also at S = 1 (grid 0); each within REL_TOL of
    its plain version.  Each row's library call is ``F.grid_sample`` on the
    same table (``microbench_lookup.library_grid_sample``: 2-D at S = 1, 3-D
    with the chart as the depth at S = 2); its values are compared with the
    kernel's too."""
    from egonerf_torch.ops import grid_sample, vm_lookup
    from egonerf_torch.tools.microbench_lookup import library_grid_sample

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    n = NOGRAD_POINTS
    plane = torch.randn(NOGRAD_PLANE, generator=gen, device=dev).bfloat16()
    line = torch.randn(NOGRAD_LINE, generator=gen, device=dev)
    x, y, z = (torch.rand(n, generator=gen, device=dev) * 2.1 - 1.05 for _ in range(3))
    sel = torch.randint(0, 2, (n,), generator=gen, device=dev)
    c = NOGRAD_PLANE[-1]
    out_bytes = 4 * n * c
    line16 = line.bfloat16()
    plane1, line16_1, line1 = (t[:1].contiguous() for t in (plane, line16, line))
    cases = (  # name, source, replaces, kernel, plain, args, bytes, operations
        ("K15 plane", "vm_lookup.cu", "vm_lookup.py:636", vm_lookup.sample_plane_nograd,
         vm_lookup.sample_plane_nograd_plain, (plane, x, y, sel), 4 * 2 * c + 30),
        ("K15 plane (S=1)", "vm_lookup.cu", "vm_lookup.py:636", vm_lookup.sample_plane_nograd,
         vm_lookup.sample_plane_nograd_plain, (plane1, x, y), 4 * 2 * c + 30),
        ("K15 line", "vm_lookup.cu", "vm_lookup.py:645", vm_lookup.sample_line_nograd,
         vm_lookup.sample_line_nograd_plain, (line16, z, sel), 3 * c + 15),
        ("K15 line (S=1)", "vm_lookup.cu", "vm_lookup.py:645", vm_lookup.sample_line_nograd,
         vm_lookup.sample_line_nograd_plain, (line16_1, z), 3 * c + 15),
        ("K16", "grid_sample.cu", "grid_sample.py:38", grid_sample.sample_line,
         grid_sample.sample_line_plain, (line, z, sel), 3 * c + 15),
        ("K16 (S=1)", "grid_sample.cu", "grid_sample.py:38", grid_sample.sample_line,
         grid_sample.sample_line_plain, (line1, z), 3 * c + 15))
    rows = {}
    for name, src, rep, kern, plain, args, ops_per_point in cases:
        rows[name] = row = check_case(
            name, f"egonerf_torch/csrc/{src}", f"egonerf_tpu/ops/{rep}", kern, plain, args,
            nbytes(*args) + out_bytes, n * ops_per_point)
        table, grid_sel = args[0], (sel if args[-1] is sel else None)
        lib = (library_grid_sample(table, None, args[1], grid_sel) if table.dim() == 3
               else library_grid_sample(table, args[1], args[2], grid_sel))
        with torch.no_grad():
            out = kern(*args)
            d = float((lib().t() - out).abs().max())
            tol = REL_TOL * float(out.abs().max())
        row["library_ms"] = lib_ms = time_ms(lib)
        print(f"phase 2 {name}: library call F.grid_sample ({2 if grid_sel is None else 3}-D) "
              f"{lib_ms:.4f} ms, max |library - kernel| {d:.3e} (<= {tol:.3e}, rel {REL_TOL:.0e})",
              flush=True)
        if not d <= tol:
            fail(f"{name}: the library call does not compute the kernel's function")
    return rows


def make_omniblender_scene(out_dir: str, n_frames: int, n_test: int, hw) -> None:
    """An OmniBlender-layout scene of the procedural world, as
    tests/test_loaders.py:25-40 lays one out: ``transform.json`` (the
    frames' c2w), ``images/`` (equirect PNGs of ``hw``), ``train.txt`` and
    ``test.txt`` (every ``n_frames // n_test``-th frame tests)."""
    from egonerf_torch.data.png import write_png
    from egonerf_torch.data.ray_utils import get_ray_directions_360, get_rays
    from egonerf_torch.data.synthetic import make_poses, trace_rays

    h, w = hw
    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    dirs = get_ray_directions_360(h, w)
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    poses = make_poses(n_frames)
    frames, names = [], [f"cam_{k:03d}" for k in range(n_frames)]
    for c2w, name in zip(poses, names):
        rgb, _ = trace_rays(*get_rays(dirs, c2w))
        write_png(os.path.join(out_dir, "images", f"{name}.png"),
                  (np.clip(rgb.reshape(h, w, 3), 0, 1) * 255 + 0.5).astype(np.uint8))
        frames.append({"file_path": f"{name}.png", "transform_matrix": c2w.tolist()})
    with open(os.path.join(out_dir, "transform.json"), "w") as f:
        json.dump({"indoor": True, "frames": frames}, f)
    test = set(range(0, n_frames, n_frames // n_test)[:n_test])
    for split, keep in (("train", lambda k: k not in test), ("test", lambda k: k in test)):
        with open(os.path.join(out_dir, f"{split}.txt"), "w") as f:
            f.write("\n".join(n for k, n in enumerate(names) if keep(k)) + "\n")


def egocentric_e2e_phase(root: str, wrappers) -> None:
    """Phase 19: JAX's egocentric end-to-end recipe unchanged
    (tests/test_egocentric_e2e.py:67-104): an 8-frame 240x120 capture from
    the port's writer, loaded under COLMAP and OpenVSLAM poses (the render
    poses to 1e-5; the roi-cropped rays to 1e-5 and pixels to 1.5/255 of
    ``trace_rays``), then the recipe trained through the command line with
    ``theta_importance`` (K14f once a step, no K14): test PSNR above
    EGO_E2E_FLOOR_DB.  Then the recipe trained EGO_LONG_ITERS steps in this
    process: its untrained field's PSNR (a record) and the constant colour's
    (the train frames' mean), and its trained PSNR EGO_LONG_MARGIN_DB above
    the constant colour's."""
    from egonerf_torch.__main__ import main as cli_main
    from egonerf_torch.data.datasets import EgocentricVideoDataset
    from egonerf_torch.data.ray_utils import get_ray_directions_360, get_rays
    from egonerf_torch.data.synthetic import trace_rays
    from egonerf_torch.render.metrics import mse2psnr
    from egonerf_torch.tools.make_egocentric_capture import make_capture
    from egonerf_torch.train.config import parse_cli
    from egonerf_torch.train.trainer import Trainer

    base = os.path.join(root, "build", "chip_smoke_runs", "egocentric")
    shutil.rmtree(base, ignore_errors=True)
    cap = os.path.join(base, "capture")
    h, w = EGO_E2E_HW
    downsample, roi = RICOH_WH[0] / w, EGO_E2E["roi"]
    poses = make_capture(cap, n_frames=8, height=h, n_test=2, seed=3)
    with open(os.path.join(cap, "train.txt")) as f:
        idx = [int(n.split("_")[1]) for n in f.read().split()]
    for method in ("colmap", "openvslam"):
        ds = EgocentricVideoDataset(data_dir=cap, split="train", downsample=downsample,
                                    near_far=(0.05, 9.0), roi=roi, localization_method=method)
        err = float(np.abs(ds.poses - poses[idx].astype(np.float32)).max())
        print(f"phase 19 {method} poses: max |loaded - rendered| {err:.2e} (<= 1e-5)",
              flush=True)
        if not err <= 1e-5:
            fail(f"the {method} poses of the capture do not round-trip")
    test = EgocentricVideoDataset(data_dir=cap, split="test", is_stack=True,
                                  downsample=downsample, near_far=(0.05, 9.0), roi=roi)
    dirs = get_ray_directions_360(h, w)
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    with open(os.path.join(cap, "test.txt")) as f:
        names = f.read().split()
    ray_err = px_err = 0.0
    for j, name in enumerate(names):
        rays_o, rays_d = get_rays(dirs, poses[int(name.split("_")[1])].astype(np.float32), roi)
        ray_err = max(ray_err, float(np.abs(test.all_rays[j] - np.concatenate(
            [rays_o, rays_d], -1)).max()))
        rgb, _ = trace_rays(rays_o, rays_d, 8.0, "wall")
        px_err = max(px_err, float(np.abs(test.all_rgbs[j].reshape(-1, 3)
                                          - np.clip(rgb, 0, 1)).max()))
    print(f"phase 19 test frames: max |ray - get_rays| {ray_err:.2e} (<= 1e-5), max |pixel - "
          f"trace_rays| {px_err * 255:.3f}/255 (< 1.5/255)", flush=True)
    if not (ray_err <= 1e-5 and px_err < 1.5 / 255):
        fail("the capture's rays or pixels differ from the render")

    def argv_of(**over):
        recipe = dict(EGO_E2E["config"], datadir=cap, downsample_train=downsample,
                      downsample_test=downsample, roi=str(roi), basedir=base, **over)
        return [tok for k, v in recipe.items() for tok in (f"--{k}", str(v))]

    iters, expname = EGO_E2E["config"]["n_iters"], EGO_E2E["config"]["expname"]
    for wr in wrappers.values():
        wr.launches = 0
    t0 = time.time()
    cli_main(argv_of(vis_list=f"[{iters}]", N_vis=-1))
    torch.cuda.synchronize()
    psnr = float(np.loadtxt(os.path.join(base, expname, "imgs_vis",
                                         f"{iters - 1:06d}_mean.txt"))[0])
    print(f"phase 19 JAX's egocentric recipe through the command line ({iters} iterations, "
          f"theta_importance, {time.time() - t0:.1f} s with its evaluation): test PSNR "
          f"{psnr:.2f} dB (JAX's test asserts {EGO_E2E['jax_psnr']:.1f} dB at its seed), floor "
          f"{EGO_E2E_FLOOR_DB:.2f} dB; {theta_launches(wrappers, iters)}", flush=True)
    if not psnr > EGO_E2E_FLOOR_DB:
        fail(f"the egocentric recipe reached {psnr:.2f} dB, not above {EGO_E2E_FLOOR_DB:.2f}")

    trainer = Trainer(parse_cli(argv_of(n_iters=EGO_LONG_ITERS, expname=f"{expname}_long",
                                        N_vis=0)))
    untrained = float(np.mean(trainer._evaluate(None)))
    mean_rgb = trainer.train_dataset.all_rgbs.reshape(-1, 3).mean(0)
    const = float(np.mean([mse2psnr(float(np.mean((f.reshape(-1, 3) - mean_rgb) ** 2)))
                           for f in trainer.test_dataset.all_rgbs]))
    for wr in wrappers.values():
        wr.launches = 0
    t0 = time.time()
    trainer.train()
    torch.cuda.synchronize()
    trained = float(np.mean(trainer._evaluate(None)))
    floor = const + EGO_LONG_MARGIN_DB
    print(f"phase 19 the recipe trained {EGO_LONG_ITERS} iterations ({time.time() - t0:.1f} s): "
          f"test PSNR {trained:.2f} dB, floor {floor:.2f} dB = the train frames' mean colour's "
          f"{const:.2f} dB + {EGO_LONG_MARGIN_DB}; untrained field {untrained:.2f} dB (a "
          f"record); {theta_launches(wrappers, EGO_LONG_ITERS)}", flush=True)
    if not trained > floor:
        fail(f"the recipe trained {EGO_LONG_ITERS} steps reached {trained:.2f} dB, not above "
             f"the constant colour's {const:.2f} + {EGO_LONG_MARGIN_DB} dB")


def view_phase(label: str, trainer) -> None:
    """One test view of ``trainer`` rendered from its dataset's directions
    and pose: s/image, peak memory and its PSNR against the frame (a
    record)."""
    from egonerf_torch.render.metrics import mse2psnr

    test = trainer.test_dataset
    renderer = trainer.renderer
    renderer.set_directions(test.directions)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with torch.no_grad():
        out = renderer.render_view(trainer.params, test.poses[0])
    torch.cuda.synchronize()
    s_image = time.time() - t0
    rgb = out["rgb"]
    w, h = test.img_wh
    if tuple(rgb.shape) != (w * h, 3) or not torch.isfinite(rgb).all():
        fail(f"{label}: the test view is not a finite ({w * h}, 3) image")
    gt = torch.as_tensor(test.all_rgbs[0].reshape(-1, 3), device=rgb.device)
    psnr = mse2psnr(float(((rgb - gt) ** 2).mean()))
    print(f"{label} test view {w}x{h}: {s_image:.3f} s/image, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated, PSNR {psnr:.2f} dB "
          f"against the frame (a record)", flush=True)


def theta_distribution(trainer, wrappers) -> None:
    """K14f's distribution on the card: THETA_DIST_DRAWS draws of the
    trainer's sampler in one launch (a batch counter no step takes); every
    row's count within THETA_SIGMA binomial deviations of draws *
    weight[row], every image's and column's of the uniform count, and the
    rows those of the ids."""
    s = trainer.sampler
    n = THETA_DIST_DRAWS
    ids, rows = wrappers["K14f"](s.buffer, s.cdf, s.w, s.h, n, s.seed, 2 ** 31)
    if not torch.equal(rows, s.buffer[ids]):
        fail("K14f's rows are not the buffer's rows at its ids")
    del rows
    weight = np.diff(np.concatenate([[0.0], s.cdf.double().cpu().numpy()]))
    weight[-1] += 1.0 - float(s.cdf[-1])  # u above the cast cdf's end takes the last row
    worst = {}
    for what, idx, p in (("row", (ids % (s.w * s.h)) // s.w, weight),
                         ("image", ids // (s.w * s.h), np.full(s.img_len, 1.0 / s.img_len)),
                         ("column", ids % s.w, np.full(s.w, 1.0 / s.w))):
        count = torch.bincount(idx, minlength=p.shape[0]).double().cpu().numpy()
        if count.shape[0] != p.shape[0]:
            fail(f"K14f drew a {what} outside the raster")
        z = np.abs(count - n * p) / np.sqrt(n * p * (1 - p))
        worst[what] = float(z.max())
    print(f"phase 20 K14f distribution over {n:,} draws ({s.h} rows, {s.img_len} images, {s.w} "
          f"columns): worst deviation {worst['row']:.2f} sigma (rows), {worst['image']:.2f} "
          f"(images), {worst['column']:.2f} (columns); limit {THETA_SIGMA}", flush=True)
    if max(worst.values()) > THETA_SIGMA:
        fail(f"K14f's draws stray from their distribution: {worst}")


def png_decode_phase(frame_path: str) -> None:
    """The PNG codec on a 1920x960 frame of the capture, written again with
    Average and with Paeth on every row (the filters a byte-serial
    reconstruction needs) and, where PIL is installed, by PIL (its adaptive
    filters): each decoded equal to the frame, timed beside PIL's decode."""
    import io

    from egonerf_torch.data import png

    frame = png.read_image(frame_path)
    try:
        from PIL import Image
    except ImportError:
        Image = None
    cases = [(f"filter {k} on every row", png.encode(frame, k)) for k in (3, 4)]
    if Image is not None:
        buf = io.BytesIO()
        Image.fromarray(frame).save(buf, format="PNG")
        cases.append(("written by PIL", buf.getvalue()))
    for name, data in cases:
        t0 = time.perf_counter()
        out = png.decode(data)
        ms = (time.perf_counter() - t0) * 1e3
        if not np.array_equal(out, frame):
            fail(f"the PNG codec misreads a frame {name}")
        pil = "PIL is not installed"
        if Image is not None:
            t0 = time.perf_counter()
            ref = np.asarray(Image.open(io.BytesIO(data)))
            pil = f"PIL {(time.perf_counter() - t0) * 1e3:.1f} ms"
            if not np.array_equal(ref, frame):
                fail(f"PIL misreads a frame {name}")
        print(f"phase 20 PNG decode of a {frame.shape[1]}x{frame.shape[0]} frame {name}: "
              f"codec {ms:.1f} ms (host), {pil}; pixels equal", flush=True)


def ricoh_phase(root: str, wrappers) -> int:
    """Phase 20: ``configs/egonerf/ricoh/garden.txt`` as shipped on a
    synthesised 1920x960 capture (RICOH_FRAMES frames, the only cut) through
    the command line with ``theta_importance``; then, in this process and
    resumed from its checkpoint, TRAIN_STEPS timed steps under theta (K14f
    once a step, no K14) and under ``simple`` (neither), one test view, and
    K14f's distribution.  Returns K14f's launches over the timed theta steps."""
    import dataclasses

    from egonerf_torch.__main__ import main as cli_main
    from egonerf_torch.tools.make_egocentric_capture import make_capture
    from egonerf_torch.train.config import parse_cli
    from egonerf_torch.train.trainer import Trainer

    base = os.path.join(root, "build", "chip_smoke_runs", "ricoh")
    shutil.rmtree(base, ignore_errors=True)
    cap = os.path.join(base, "capture")
    t0 = time.time()
    make_capture(cap, n_frames=RICOH_FRAMES, height=RICOH_WH[1], n_test=RICOH_TEST)
    print(f"phase 20 capture: {RICOH_FRAMES} frames at {RICOH_WH[0]}x{RICOH_WH[1]} in "
          f"{time.time() - t0:.1f} s", flush=True)
    png_decode_phase(os.path.join(cap, "imgs", "frame_0000.png"))
    argv = ["--config", os.path.join(root, RICOH_CONFIG), "--datadir", cap, "--basedir", base,
            "--sampling_method", "theta_importance", "--n_iters", str(RICOH_ITERS),
            "--vis_list", f"[{RICOH_ITERS}]", "--N_vis", "-1", "--progress_refresh_rate", "100"]
    for wr in wrappers.values():
        wr.launches = 0
    t0 = time.time()
    cli_main(argv)
    torch.cuda.synchronize()
    cfg = parse_cli(argv)
    logdir = os.path.join(base, cfg.expname)
    psnr = float(np.loadtxt(os.path.join(logdir, "imgs_vis", f"{RICOH_ITERS - 1:06d}_mean.txt"))[0])
    print(f"phase 20 {RICOH_CONFIG} through the command line (theta_importance, {RICOH_ITERS} "
          f"iterations, envmap {cfg.envmap_res_H}, {time.time() - t0:.1f} s with loading and "
          f"its evaluation): test PSNR {psnr:.2f} dB (a record); "
          f"{theta_launches(wrappers, RICOH_ITERS)}", flush=True)

    trainer = Trainer(cfg)
    print(f"phase 20 trainer: {trainer.train_dataset.all_rays.shape[0]:,} training rays "
          f"resident ({trainer.sampler.buffer.numel() * 4 / 2**20:.0f} MiB), grid "
          f"{trainer.model.grid_size}, resumed at step {trainer.start_step}", flush=True)
    want = step_launches(wrappers, envmap=True)
    theta_l, theta_ms = timed_steps(trainer.train_step, "phase 20 training step, theta_importance",
                                    cfg, wrappers, dict(want, K14f=TRAIN_STEPS))

    def steps():
        for it in range(10 ** 4, 10 ** 4 + PROFILE_STEPS):
            trainer.train_step(it)
    profile(steps, PROFILE_STEPS, "phase 20 theta", "step")
    theta_distribution(trainer, wrappers)
    trainer.cfg = dataclasses.replace(cfg, sampling_method="simple")
    trainer._install_sampler()
    _, simple_ms = timed_steps(trainer.train_step, "phase 20 training step, simple", cfg,
                               wrappers, want)
    profile(steps, PROFILE_STEPS, "phase 20 simple", "step")
    print(f"phase 20 step: theta_importance {theta_ms:.3f} ms, simple {simple_ms:.3f} ms "
          f"({theta_ms - simple_ms:+.3f})", flush=True)
    view_phase("phase 20", trainer)
    return theta_l["K14f"]


def omniblender_phase(root: str, wrappers) -> None:
    """Phase 21: ``configs/egonerf/omniblender/archiviz-flat.txt`` on an
    OmniBlender-layout scene at 2000x1000 written here (OMNI_FRAMES
    frames): OMNI_ITERS steps through the command line with the default
    ``simple`` sampler, then, resumed in this process, TRAIN_STEPS timed
    steps and one test view."""
    from egonerf_torch.__main__ import main as cli_main
    from egonerf_torch.train.config import parse_cli
    from egonerf_torch.train.trainer import Trainer

    base = os.path.join(root, "build", "chip_smoke_runs", "omniblender")
    shutil.rmtree(base, ignore_errors=True)
    scene = os.path.join(base, "scene")
    t0 = time.time()
    make_omniblender_scene(scene, OMNI_FRAMES, OMNI_TEST, IMAGE_HW)
    print(f"phase 21 scene: {OMNI_FRAMES} frames at {IMAGE_HW[1]}x{IMAGE_HW[0]} in "
          f"{time.time() - t0:.1f} s", flush=True)
    argv = ["--config", os.path.join(root, OMNI_CONFIG), "--datadir", scene, "--basedir", base,
            "--n_iters", str(OMNI_ITERS), "--progress_refresh_rate", "10"]
    t0 = time.time()
    cli_main(argv)
    torch.cuda.synchronize()
    print(f"phase 21 {OMNI_CONFIG} through the command line ({OMNI_ITERS} iterations, simple): "
          f"{time.time() - t0:.1f} s with loading", flush=True)
    cfg = parse_cli(argv)
    trainer = Trainer(cfg)
    if trainer.start_step != OMNI_ITERS:
        fail(f"the OmniBlender run did not resume at step {OMNI_ITERS}")
    timed_steps(trainer.train_step, "phase 21 training step", cfg, wrappers,
                step_launches(wrappers, envmap=False))
    view_phase("phase 21", trainer)
    evaluation_phase(base, trainer)


# -- the evaluation outputs, linear sampling and grid upsampling --------------
def docs_state(root: str) -> list:
    """Each record under ``docs/torch/`` with its modification time."""
    docs = os.path.join(root, "docs", "torch")
    return sorted((f, os.path.getmtime(os.path.join(docs, f)))
                  for f in files_under(docs) if not f.endswith("/"))


def files_under(root: str) -> list:
    """Sorted paths of the files (and, with a trailing /, the folders) under
    ``root``, relative to it."""
    out = []
    for d, dirs, files in os.walk(root):
        rel = os.path.relpath(d, root)
        out += [os.path.normpath(os.path.join(rel, f)) for f in files]
        out += [os.path.normpath(os.path.join(rel, x)) + "/" for x in dirs]
    return sorted(out)


def eval_files(n_views: int, env: bool, prefix: str = "") -> list:
    """The files the JAX package's ``evaluation`` writes for ``n_views``
    views with its metrics and images on (``renderer.py:200-348``)."""
    names = [f"{prefix}mean.json", f"{prefix}mean.txt", "rgbd/"]
    for i in range(n_views):
        names += [f"{prefix}{i:03d}.png", f"rgbd/{prefix}{i:03d}.png"]
        if env:
            names.append(f"{prefix}{i:03d}_bg.png")
    if env and n_views:
        names.append(f"{prefix}envmap.png")
    return sorted(names)


def host_work_ms(trainer, out_dir: str) -> None:
    """The host work of one view of phase 22's evaluation, each part timed
    alone on view 0's arrays: the SSIM map (both means), PSNR and WS-PSNR,
    the rgb PNG and the rgbd PNG (the depth colour map included)."""
    from egonerf_torch.data.png import write_png
    from egonerf_torch.render.metrics import psnr, ssim_and_ws_ssim, ws_psnr
    from egonerf_torch.render.viz import to_uint8, visualize_depth

    test = trainer.test_dataset
    w, h = test.img_wh
    t0 = time.time()
    with torch.no_grad():
        out = trainer.renderer.render_view(trainer.params, test.poses[0])
    rgb = out["rgb"].reshape(h, w, 3).cpu().numpy()
    depth = out["depth"].reshape(h, w).cpu().numpy()
    render_ms = (time.time() - t0) * 1e3
    gt = np.asarray(test.all_rgbs[0]).reshape(h, w, 3)
    os.makedirs(out_dir, exist_ok=True)
    parts = {
        "SSIM map (SSIM and WS-SSIM)": lambda: ssim_and_ws_ssim(rgb, gt, 1.0),
        "PSNR and WS-PSNR": lambda: (psnr(rgb, gt), ws_psnr(rgb, gt)),
        "rgb PNG": lambda: write_png(os.path.join(out_dir, "rgb.png"), to_uint8(rgb)),
        "rgbd PNG": lambda: write_png(os.path.join(out_dir, "rgbd.png"), np.concatenate(
            [to_uint8(rgb), visualize_depth(depth, test.near_far)[0]], axis=1)),
    }
    ms = {}
    for name, fn in parts.items():
        t0 = time.time()
        fn()
        ms[name] = (time.time() - t0) * 1e3
    print(f"phase 22 host work a view ({w}x{h}): " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in ms.items()) + f"; {sum(ms.values()):.1f} ms in all, "
        f"beside {render_ms:.1f} ms to render and copy the view", flush=True)


def lpips_phase(trainer) -> None:
    """Phase 22: the LPIPS graph (alex and vgg) on the card with weights drawn
    from SEED, on a 2000x1000 pair (test frame 0 and its render), timed, and
    the same graph on the host: rel LPIPS_TOL (float32 convolutions summed
    in other orders; TF32 off on the card)."""
    from egonerf_torch._device import full_f32_matmul
    from egonerf_torch.render import lpips

    full_f32_matmul()
    test = trainer.test_dataset
    w, h = test.img_wh
    gt = torch.as_tensor(np.asarray(test.all_rgbs[0], np.float32).reshape(h, w, 3))
    with torch.no_grad():
        im = trainer.renderer.render_view(trainer.params, test.poses[0])["rgb"].reshape(h, w, 3)
        for net in ("alex", "vgg"):
            arrays = lpips.random_arrays(net, SEED)
            card = lpips.params_from_arrays(arrays, net, DEVICE)
            host = lpips.params_from_arrays(arrays, net, "cpu")
            a, b = gt.to(DEVICE), im.contiguous()
            got = float(lpips.lpips_pair(card, a, b, net))
            ms = time_ms(lambda: lpips.lpips_pair(card, a, b, net), reps=3)
            t0 = time.time()
            want = float(lpips.lpips_pair(host, gt, im.cpu(), net))
            host_s = time.time() - t0
            rel = abs(got - want) / abs(want)
            print(f"phase 22 LPIPS {net} graph on a {w}x{h} pair, seeded weights: {got:.6f} on "
                  f"the card in {ms:.2f} ms, {want:.6f} on the host in {host_s:.2f} s, rel "
                  f"{rel:.2e} (<= {LPIPS_TOL:.0e}) -> {'ok' if rel <= LPIPS_TOL else 'MISS'}",
                  flush=True)
            if not (np.isfinite(got) and rel <= LPIPS_TOL):
                fail(f"the LPIPS {net} graph on the card disagrees with the host's")


def evaluation_phase(base: str, trainer) -> None:
    """Phase 22: phase 21's trainer (2000x1000, 2 test views) through
    ``evaluation()``: s/image with PSNR alone and no images, with every
    metric and the images in turn, and overlapped with the next view's
    render (EVAL_ORDER), the host work of a view, ``mean.json`` and the
    files (JAX's list); then ``evaluation_path`` over PATH_FRAMES frames of
    the scene's trajectory and the LPIPS graph."""
    from egonerf_torch.data.ray_utils import get_spiral
    from egonerf_torch.render.renderer import evaluation, evaluation_path

    test, model = trainer.test_dataset, trainer.model
    n_views = test.all_rays.shape[0]
    per_image = {label: [] for label, _ in EVAL_RUNS}
    for turn, k in enumerate(EVAL_ORDER):
        label, kw = EVAL_RUNS[k]
        out_dir = os.path.join(base, f"evaluation_{turn}")
        torch.cuda.synchronize()
        t0 = time.time()
        psnrs = evaluation(test, model, trainer.params, trainer.renderer, save_path=out_dir, **kw)
        torch.cuda.synchronize()
        per_image[label].append((time.time() - t0) / n_views)
        if len(psnrs) != n_views or not np.all(np.isfinite(psnrs)):
            fail(f"phase 22 {label}: PSNRs {psnrs}")
        want = (eval_files(n_views, False) if kw.get("save_images", True)
                else ["mean.json", "mean.txt", "rgbd/"])
        if files_under(out_dir) != want:
            fail(f"phase 22 {label}: wrote {files_under(out_dir)}, JAX writes {want}")
        with open(os.path.join(out_dir, "mean.json")) as f:
            summary = json.load(f)
    for label, times in per_image.items():
        print(f"phase 22 evaluation, {label}: " + ", ".join(f"{t:.3f}" for t in times)
              + f" s/image over {n_views} views of {test.img_wh[0]}x{test.img_wh[1]}",
              flush=True)
    turns, overlapped = per_image[EVAL_RUNS[1][0]], per_image[EVAL_RUNS[2][0]]
    spread = max(max(turns) - min(turns), max(overlapped) - min(overlapped))
    gain = min(turns) - max(overlapped)
    print(f"phase 22 overlap: metrics and images in turn {min(turns):.3f}-{max(turns):.3f}, "
          f"overlapped {min(overlapped):.3f}-{max(overlapped):.3f} s/image; the overlap gains "
          f"{gain:.3f} s/image at least, the spread within a form {spread:.3f}", flush=True)
    print(f"phase 22 mean.json: {json.dumps(summary)}", flush=True)
    for k in ("psnr", "ssim", "ws_ssim", "ws_psnr"):
        if summary[k] is None or not np.isfinite(summary[k]):
            fail(f"phase 22 mean.json: {k} is {summary[k]}")
    print(f"phase 22 files: {files_under(os.path.join(base, 'evaluation_1'))} (JAX's list)",
          flush=True)
    host_work_ms(trainer, os.path.join(base, "host_work"))

    # the trajectory: PATH_FRAMES frames of the spiral the LLFF loader builds,
    # around this scene's training poses
    c2ws = get_spiral(np.asarray(trainer.train_dataset.poses)[:, :3, :4],
                      np.asarray([test.near_far]), n_views=PATH_FRAMES)
    path_dir = os.path.join(base, "imgs_path_all")
    t0 = time.time()
    frames = evaluation_path(test, model, trainer.params, c2ws, trainer.renderer,
                             save_path=path_dir)
    path_s = (time.time() - t0) / PATH_FRAMES
    want = sorted(["rgbd/"] + [f"{i:03d}.png" for i in range(PATH_FRAMES)]
                  + [f"rgbd/{i:03d}.png" for i in range(PATH_FRAMES)])
    got = files_under(path_dir)
    print(f"phase 22 render_path: {PATH_FRAMES} frames in {path_s:.3f} s/frame, files {got}",
          flush=True)
    if got != want or len(frames) != PATH_FRAMES or any(
            f.shape != (test.img_wh[1], test.img_wh[0], 3) for f in frames):
        fail(f"phase 22 render_path wrote {got}, expected {want}")
    lpips_phase(trainer)


def upsample_reference(trainer, reso) -> dict:
    """The grid's planes and lines resampled onto ``reso`` on the host (the
    chart's ``up_sampling_VM`` on CPU tensors, in the grid before the event):
    what the event must give on the card."""
    from egonerf_torch.ops.vm_lookup import MAT_MODE, VEC_MODE

    up = trainer.coords.up_sampling_VM
    want = {}
    for kind in ("density", "app"):
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            plane = trainer.params[f"{kind}_planes.{i}"].detach().cpu()
            line = trainer.params[f"{kind}_lines.{i}"].detach().cpu()
            want[f"{kind}_planes.{i}"] = up(plane, reso, ids=[m1, m0])
            want[f"{kind}_lines.{i}"] = up(line, reso, ids=[VEC_MODE[i]])
    return want


def step_kernels_on_grid(label: str, trainer, ops) -> None:
    """K1, K2, K3, K4 (with its fine chart) and K7 on the inputs of one
    recorded training step of ``trainer``, each against its plain version
    at phase 2's limits."""
    model = trainer.model
    recs = {k: Recorder(getattr(ops.KERNELS, k))
            for k in ("field", "field_bwd", "density", "resample_chart", "chart")}
    model.ops = ops.KERNELS._replace(**recs)
    try:
        trainer.train_step(10 ** 5)
    finally:
        model.ops = ops.KERNELS
    torch.cuda.synchronize()
    with torch.no_grad():
        args = recs["field"].args
        abs_err, rel = max_err(ops.KERNELS.field(*args)[:2], ops.PLAIN.field(*args)[:2])
        check_close(f"K1 field_fwd ({label})", f"rel <= {REL_TOL:.0e} of max|plain|",
                    rel <= REL_TOL, abs_err, rel)
        check_relu_mask(f"K1 relu mask ({label})", args, ops)
        k2_compare(f"K2 field_bwd ({label})", recs["field_bwd"].args, ops)
        args = recs["density"].args
        abs_err, rel = max_err([ops.KERNELS.density(*args)], [ops.PLAIN.density(*args)])
        check_close(f"K3 density_fwd ({label})", f"rel <= {REL_TOL:.0e} of max|plain|",
                    rel <= REL_TOL, abs_err, rel)
        rec = recs["resample_chart"]
        k4_checks(label, ops, drawn_u(ops, rec.args[:9], rec.kwargs["draw"]),
                  model.near_far[1], rec.args[9:12])
        check_chart(f"K7 chart (coarse, {label})", ops, recs["chart"].args)


def upsample_phase(root, presets, ops, wrappers, exp: bool) -> None:
    """Phase 24 (24l with ``exp_sampling`` off, the linear radius): the
    production EgoNeRF from N_voxel UPSAMPLE_FROM, upsampled to the
    production grid after step UPSAMPLE_AT by ``Trainer.upsample``: the new
    params against the host's resampling, the line modes before and after,
    K1-K4 and K7 on the new grid against their plain versions, and timed
    steps after the event."""
    from egonerf_torch.train.config import load_config
    from egonerf_torch.train.trainer import Trainer

    label = "24" if exp else "24l"
    cfg = load_config(overrides=presets.production_overrides(
        basedir=os.path.join(root, "build", "chip_smoke_runs"), expname=f"upsample_{label}",
        n_iters=10 ** 9, N_vis=0, progress_refresh_rate=10 ** 9, N_voxel_init=UPSAMPLE_FROM,
        upsamp_list=f"[{UPSAMPLE_AT}]", exp_sampling=exp))
    trainer = Trainer(cfg, device=DEVICE)
    model = trainer.model
    if trainer.upsamp_list != [UPSAMPLE_AT] or trainer.n_voxel_list != [presets.N_VOXEL]:
        fail(f"phase {label}: upsample schedule {trainer.upsamp_list}, {trainer.n_voxel_list}")
    for it in range(UPSAMPLE_AT + 1):
        trainer.train_step(it)
    reso = trainer.coords.N_to_reso(trainer.n_voxel_list[0])
    want = upsample_reference(trainer, reso)
    n_step = cfg.batch_size * (cfg.n_coarse + cfg.n_fine)
    n_chunk = presets.EVAL_CHUNK * (cfg.n_coarse + cfg.n_fine)

    def modes():
        lines = model.fused_tables(trainer.params)[1]
        return model._line_hat(lines, n_step), model._line_hat(lines, n_chunk)

    before = (list(model.grid_size), model.step_size, modes())
    torch.cuda.synchronize()
    t0 = time.time()
    trainer.upsample(UPSAMPLE_AT)
    torch.cuda.synchronize()
    event_ms = (time.time() - t0) * 1e3
    err = 0.0
    for k, w in want.items():
        got = trainer.params[k].detach()
        if tuple(got.shape) != tuple(w.shape):
            fail(f"phase {label}: {k} {tuple(got.shape)} after the event, {tuple(w.shape)} "
                 f"by the host's resampling")
        err = max(err, float((got.cpu() - w).abs().max()))
    print(f"phase {label} upsample ({'exponential radius, interval_th' if exp else 'linear '}"
          f"{'' if exp else 'radius'}) after step {UPSAMPLE_AT}: grid {before[0]} -> "
          f"{model.grid_size}, step size {before[1]:.6f} -> {model.step_size:.6f}, the event "
          f"{event_ms:.1f} ms; params against the host's resampling max abs {err:.2e} (<= "
          f"{UPSAMPLE_TOL:.0e}); fine line modes (step {n_step:,} samples, chunk {n_chunk:,}) "
          f"{before[2]} -> {modes()} (0 linear, 1 hat)", flush=True)
    if err > UPSAMPLE_TOL or model.grid_size != list(reso) or trainer.coords.resolution != reso:
        fail(f"phase {label}: the upsampled grid disagrees with the host's resampling")
    if exp and trainer.coords.ref_grid.shape[0] != reso[0] + 1:
        fail(f"phase {label}: the radial lookup grid was not re-made")
    step_kernels_on_grid(f"phase {label}, upsampled grid", trainer, ops)
    timed_steps(trainer.train_step, f"phase {label} training step after the upsample, grid "
                f"{model.grid_size}", cfg, wrappers, step_launches(wrappers, envmap=False))


def linear_kernel_checks(trainer, ops, dirs, chunk: int) -> dict:
    """Phase 23: K7 in its linear radial mode (2) on a chunk's coarse depths
    and K4 with the mode-2 fine chart in its epilogue, each against its
    plain version on one production chunk (rows with times and bounds) and
    on one recorded training step."""
    from egonerf_torch.models.egonerf import _dists
    from egonerf_torch.ops import chart

    model, cfg = trainer.model, trainer.model.cfg
    coords, dev = model.coordinates, dirs.device
    mode = chart.chart_args(coords, 2, dev)[8]
    if mode != 2:
        fail(f"phase 23: the chart's radial mode is {mode}, not 2 (linear)")
    n_c, n_f = trainer.cfg.n_coarse, trainer.cfg.n_fine
    pick = torch.arange(chunk, device=dev) * (dirs.shape[0] // chunk)
    viewdirs = dirs[pick]
    rays = torch.cat([torch.zeros_like(viewdirs), viewdirs], dim=-1)
    params = trainer.params
    with torch.no_grad():
        tables = model.lookup_tables(params)
        coarse_z = model.sample_depths_linear(rays[:, :3], rays[:, 3:6], n_c)
        c_args = (rays[:, :3], rays[:, 3:6], coarse_z, coords, 2)
        err7 = check_chart("K7 chart (coarse, linear r)", ops, c_args)
        c_norm = ops.PLAIN.chart(*c_args)
        c_feat = ops.PLAIN.density(c_norm, tables.coarse_planes,
                                   tables.coarse_lines).reshape(chunk, n_c)
        act = (cfg.density_shift, cfg.distance_scale, cfg.fea2dense_act)
        args = (c_feat, coarse_z, _dists(coarse_z), n_f, None, True, *act)
        fine_rays = (rays[:, :3], rays[:, 3:6], coords)
        err4 = k4_compare("K4 resample + chart (linear r, eval chunk)", ops, args,
                          model.near_far[1], fine_rays)
        # the same directions from origins 16-24 outside the box, so each ray
        # enters the box at its own depth (t_min differs per ray; some clip
        # to far)
        away = torch.rand(chunk, 1, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(SEED)) * 8 + 16
        out_rays = torch.cat([-viewdirs * away, viewdirs], dim=-1)
        z_out = model.sample_depths_linear(out_rays[:, :3], out_rays[:, 3:6], n_c)
        o_args = (out_rays[:, :3], out_rays[:, 3:6], z_out, coords, 2)
        err7 = max(err7, check_chart("K7 chart (coarse, linear r, rays from outside the box)",
                                     ops, o_args))
        o_feat = ops.PLAIN.density(ops.PLAIN.chart(*o_args), tables.coarse_planes,
                                   tables.coarse_lines).reshape(chunk, n_c)
        err4 = max(err4, k4_compare(
            "K4 resample + chart (linear r, rays from outside the box)", ops,
            (o_feat, z_out, _dists(z_out), n_f, None, True, *act), model.near_far[1],
            (out_rays[:, :3], out_rays[:, 3:6], coords)))
        print(f"phase 23 rays from outside the box: t_min in [{float(z_out[:, 0].min()):.4f}, "
              f"{float(z_out[:, 0].max()):.4f}], {int((z_out[:, 0] > z_out[0, 0]).sum())} of "
              f"{chunk} above the first ray's", flush=True)
        table = {
            "K7 (linear r)": kernel_row(
                "K7 chart (coarse, linear r)", "egonerf_torch/csrc/chart.cu",
                "egonerf_tpu/coords/yinyang.py:74", err7,
                time_ms(lambda: ops.KERNELS.chart(*c_args)),
                time_ms(lambda: ops.PLAIN.chart(*c_args), reps=5),
                *chart_cost(rays, coarse_z, 0)),
            "K4 (linear r)": kernel_row(
                "K4 resample + fine chart (linear r)", "egonerf_torch/csrc/resample.cu",
                "egonerf_tpu/ops/pdf.py:14", err4,
                time_ms(lambda: ops.KERNELS.resample_chart(*args, *fine_rays)),
                time_ms(lambda: ops.PLAIN.resample_chart(*args, *fine_rays), reps=5),
                *k4_cost(c_feat, n_f, n_c + n_f, n_grid=0))}
    print(f"phase 23 linear depths of the chunk: t_min in [{float(coarse_z[:, 0].min()):.4f}, "
          f"{float(coarse_z[:, 0].max()):.4f}], step {model.step_size:.6f}, last depth up to "
          f"{float(coarse_z[:, -1].max()):.4f}", flush=True)
    # one recorded training step: its coarse chart and its resampling
    rec_c, rec_r = Recorder(ops.KERNELS.chart), Recorder(ops.KERNELS.resample_chart)
    model.ops = ops.KERNELS._replace(chart=rec_c, resample_chart=rec_r)
    try:
        trainer.train_step(0)
    finally:
        model.ops = ops.KERNELS
    torch.cuda.synchronize()
    with torch.no_grad():
        check_chart("K7 chart (coarse, linear r, training step)", ops, rec_c.args)
        k4_checks("linear r, training step", ops,
                  drawn_u(ops, rec_r.args[:9], rec_r.kwargs["draw"]), model.near_far[1],
                  rec_r.args[9:12])
    return table


def linear_phase(root, presets, ops, wrappers, dirs_np) -> dict:
    """Phase 23: EgoNeRF's linear ray sampling at the production width
    (``exp_sampling`` off: the chart's linear radius, K7's mode 2 and K4's
    mode-2 epilogue): the kernels against their plain versions, one
    2000x1000 view with a few chunks against the plain versions and its
    profile, timed and profiled steps, one step against the plain versions.
    Returns the two kernels' rows with their launches in the view."""
    from egonerf_torch.render.renderer import Renderer
    from egonerf_torch.train.config import load_config
    from egonerf_torch.train.trainer import Trainer

    cfg = load_config(overrides=presets.production_overrides(
        basedir=os.path.join(root, "build", "chip_smoke_runs"), expname="linear",
        n_iters=10 ** 9, N_vis=0, progress_refresh_rate=10 ** 9, exp_sampling=False))
    trainer = Trainer(cfg, device=DEVICE)
    print(f"phase 23 linear trainer: grid {trainer.model.grid_size}, step size "
          f"{trainer.model.step_size:.6f}, {cfg.n_coarse} + {cfg.n_fine} samples", flush=True)
    rows = linear_kernel_checks(trainer, ops, torch.as_tensor(dirs_np, device=DEVICE),
                                presets.EVAL_CHUNK)
    with torch.no_grad():
        launches, _ = render_phases(
            trainer.model, trainer.params, dirs_np, ops, presets, Renderer, wrappers,
            phases=("23", "23", "23"),
            renderer=Renderer.from_config(trainer.model, cfg, trainer.white_bg),
            per_chunk=dict(K1=1, K3=1, K4=1, K6=1, K7=1))
    _, median = timed_steps(trainer.train_step, f"phase 23 linear training step, {cfg.n_coarse} "
                            f"+ {cfg.n_fine} samples", cfg, wrappers,
                            step_launches(wrappers, envmap=False))
    it = 10 ** 4

    def steps():
        nonlocal it
        for _ in range(PROFILE_STEPS):
            trainer.train_step(it)
            it += 1
    profile(steps, PROFILE_STEPS, "phase 23", "step")
    step_vs_plain(trainer, ops, "phase 23")
    rows["K7 (linear r)"]["launches"] = launches["K7"]
    rows["K4 (linear r)"]["launches"] = launches["K4"]
    return rows


# -- the training losses: K6/K6b/K3's training instantiations, K2 at no
# appearance channels, K14f at 10 floats (phase 2) and phase 25 ---------------
@contextlib.contextmanager
def losses(cfg, on: bool, keys=LOSS_SWITCHES):
    """The switches ``keys`` of the losses at LOSSES's values (``on``) or
    off in ``cfg`` for the block, then back as they were.  ``use_depth``'s
    buffer column is installed with the sampler: switching it on needs a
    trainer built with it."""
    saved = {k: getattr(cfg, k) for k in keys}
    for k in keys:
        setattr(cfg, k, LOSSES[k] if on else type(LOSSES[k])(0))
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(cfg, k, v)


def record_loss_step(trainer, ops) -> dict:
    """One training step of ``trainer`` with the entropy and sparsity terms
    on (the weights do not matter to the kernels' inputs; the depth term
    launches nothing), recording the calls of K6, K6b, K3 (the last: the
    sparsity lookup's training instantiation) and every K2."""
    model, cfg = trainer.model, trainer.cfg
    recs = {k: Recorder(getattr(ops.KERNELS, k)) for k in ("composite", "composite_bwd",
                                                            "density")}
    log = CallLog(ops.KERNELS.field_bwd)
    model.ops = ops.KERNELS._replace(field_bwd=log, **recs)
    try:
        with losses(cfg, True, ("entropy_weight", "sparsity_lambda")):
            trainer.train_step(1)
    finally:
        model.ops = ops.KERNELS
    torch.cuda.synchronize()
    if not recs["composite"].kwargs.get("with_alpha") or "d_alpha" not in \
            recs["composite_bwd"].kwargs or not recs["density"].kwargs.get("with_mask"):
        fail("the loss step took the default instantiations")
    dens_k2 = [a for a in log.calls if a[4].shape[1] == 0]
    if len(dens_k2) != 1:
        fail(f"the loss step launched {len(dens_k2)} K2 at no appearance channels, not 1")
    return dict(recs, k2=dens_k2[0])


def composite_alpha_case(name, ops, args, kwargs, n_bytes, n_ops) -> dict:
    """K6's training instantiation against its plain version: alpha abs <=
    ALPHA_TOL, every other output at K6's limit (rel REL_TOL of
    max|plain|); its row with times, the alpha written in the bytes."""
    with torch.no_grad():
        out, ref = ops.KERNELS.composite(*args, **kwargs), ops.PLAIN.composite(*args, **kwargs)
    torch.cuda.synchronize()
    for o, r in zip(out, ref):
        if o.shape != r.shape or not torch.isfinite(o).all():
            fail(f"{name}: shape {tuple(o.shape)} (plain {tuple(r.shape)}) or non-finite")
    a_err = float((out[-1] - ref[-1]).abs().max())
    abs_err, rel_err = max_err(out[:-1], ref[:-1])
    check_close(name, f"alpha abs {a_err:.2e} <= {ALPHA_TOL:.0e}; the rest rel <= "
                f"{REL_TOL:.0e} of max|plain|", a_err <= ALPHA_TOL and rel_err <= REL_TOL,
                max(abs_err, a_err), rel_err)
    return kernel_row(name, "egonerf_torch/csrc/composite.cu", "egonerf_tpu/ops/volrend.py:11",
                      max(abs_err, a_err),
                      time_ms(lambda: ops.KERNELS.composite(*args, **kwargs)),
                      time_ms(lambda: ops.PLAIN.composite(*args, **kwargs), reps=5), n_bytes,
                      n_ops)


def touched_table_bytes(coords, planes, lines) -> int:
    """The bytes of the rows of ``planes`` and ``lines`` that the lookups at
    ``coords`` read (each row once; float32 line weights): what a lookup
    of few points must move, where the whole tables would overcount."""
    from egonerf_torch.ops import vm_lookup as vm

    xyz, sel = coords[:, :3], vm.chart_sel(coords, planes[0].shape[0])
    total = 0
    for i in range(3):
        m0, m1 = vm.MAT_MODE[i]
        _, h, w, c = planes[i].shape
        rows = torch.cat([idx[wt != 0] for idx, wt in
                          vm._plane_corners(xyz[:, m0], xyz[:, m1], sel, h, w)])
        lrows = torch.cat([idx[wt != 0] for idx, wt in
                           vm._line_rows(xyz[:, vm.VEC_MODE[i]], sel, lines[i].shape[1],
                                         vm.LINEAR)])
        total += (rows.unique().numel() * c * planes[i].element_size()
                  + lrows.unique().numel() * c * lines[i].element_size())
    return total


def density_train_case(name, ops, args) -> dict:
    """K3's training instantiation against its plain version: the density
    rel REL_TOL of max|plain| (and equal to the eval instantiation's), the
    relu mask equal to the states of its lane-order sums (the plain
    version's) on every sample; its row."""
    with torch.no_grad():
        dens, mask = ops.KERNELS.density(*args, with_mask=True)
        want_d, want_m = ops.PLAIN.density(*args, with_mask=True)
        eval_d = ops.KERNELS.density(*args)
    torch.cuda.synchronize()
    abs_err, rel_err = max_err([dens], [want_d])
    flips = int((mask != want_m).sum())
    ties = int(sum(((want_m >> (2 * i)) & 3 == 1).sum() for i in range(3)))
    same = torch.equal(dens, eval_d)
    check_close(name, f"rel <= {REL_TOL:.0e} of max|plain|; mask differs on {flips} of "
                f"{mask.numel():,} samples ({ties} exact-zero partials), density "
                f"{'equal' if same else 'NOT equal'} to the eval instantiation's",
                rel_err <= REL_TOL and flips == 0 and same, abs_err, rel_err)
    coords, planes, lines = args
    return kernel_row(
        name, "egonerf_torch/csrc/vm_lookup.cu", "egonerf_tpu/ops/vm_lookup.py:436", abs_err,
        time_ms(lambda: ops.KERNELS.density(*args, with_mask=True)),
        time_ms(lambda: ops.PLAIN.density(*args, with_mask=True), reps=5),
        # the coords, the rows the points touch; the density and mask out
        nbytes(coords) + touched_table_bytes(coords, planes, lines) + coords.shape[0] * 5,
        coords.shape[0] * sum(p.shape[-1] for p in planes) * 11)


def k6b_alpha_sweep(ops) -> None:
    """Phase 2, K6b's training instantiation on seeded rays of each of
    K6B_ALPHA_SWEEP_S samples in its three forms (EgoNeRF, envmap, gated),
    rel REL_TOL of max|plain|."""
    from egonerf_torch.ops import volrend

    for s in K6B_ALPHA_SWEEP_S:
        r = 1024 if s > 256 else 4096
        for label, env, gated in (("EgoNeRF", False, False), ("env", True, False),
                                  ("gated", False, True)):
            warps, smem = volrend.bwd_geometry(s, gated, d_alpha=True)
            args = k6b_case(r, s, env, gated, SEED + 7 * s, DEVICE)
            d_alpha = torch.randn(r, s, device=DEVICE,
                                  generator=torch.Generator(device=DEVICE).manual_seed(s))
            with torch.no_grad():
                out = ops.KERNELS.composite_bwd(*args, d_alpha=d_alpha)
                ref = ops.PLAIN.composite_bwd(*args, d_alpha=d_alpha)
            torch.cuda.synchronize()
            if not all(torch.isfinite(o).all() for o in out):
                fail(f"K6b alpha {label} at S = {s}: non-finite output")
            abs_err, rel_err = max_err(out, ref)
            check_close(f"K6b composite_bwd with d_alpha, {label} at {r} x {s} ({warps} warps "
                        f"a block, {smem} shared bytes)", f"rel <= {REL_TOL:.0e} of max|plain|",
                        rel_err <= REL_TOL, abs_err, rel_err)


def loss_kernel_checks(trainer, outdoor, tf, ops) -> dict:
    """Phase 2, the training losses' kernels on the inputs one production
    step with the entropy and sparsity terms gives them (indoor, outdoor,
    TensoRF): K6's training instantiation in its three forms (K6, K6e,
    gated) and K6b's with d_alpha, K3's training instantiation and K2 at no
    appearance channels on the N_sparsity_points lookups (S = 2 and S = 1),
    K6b with d_alpha at K6B_ALPHA_SWEEP_S samples, and K14f at 10 floats a
    row bit for bit.  Returns their rows."""
    from egonerf_torch.ops import envmap

    table = {}
    # the rows of K3's training instantiation and K2 at no appearance
    # channels: the indoor step's (S = 2) and TensoRF's (S = 1); the
    # outdoor step's lookup is checked alike
    for label, tr, k6, k6b, s1 in (("indoor", trainer, "K6 alpha", "K6b alpha", ""),
                                   ("outdoor", outdoor, "K6e alpha", "K6b+env alpha",
                                    " (outdoor)"),
                                   ("TensoRF", tf, "K6 gated alpha", "K6b gated alpha",
                                    " (S=1)")):
        rec = record_loss_step(tr, ops)
        c_args, c_kw = rec["composite"].args, rec["composite"].kwargs
        feat, dists, z, rgb, dz = c_args[:5]
        valid, emission, dirs = c_args[9], c_args[11], c_args[12]
        r, s = feat.shape
        # K6's bytes and outputs, the alphas written; the gates' mask; K6e's
        # directions, the texels this batch touches, env and bg_map out
        n_bytes = nbytes(feat, dists, z, rgb, dz) + r * 6 * 4 + 4 * r * s
        if valid is not None:
            n_bytes += nbytes(valid)
        if emission is not None:
            corners = envmap.envmap_corners(dirs, emission.shape[1])
            texels = int(torch.cat([i[w > 0] for i, w in corners]).unique().numel())
            n_bytes += r * 12 + texels * 12 + r * 24
        table[k6] = composite_alpha_case(f"{k6} composite with alpha ({label} loss step)", ops,
                                         c_args, c_kw, n_bytes, r * s * 20)
        b_args, b_kw = rec["composite_bwd"].args, rec["composite_bwd"].kwargs
        b_extra = [t for t in b_args[4:] if isinstance(t, torch.Tensor)]
        # K6b's, with d_alpha read
        table[k6b] = check_case(
            f"{k6b} composite_bwd with d_alpha ({label} loss step)",
            "egonerf_torch/csrc/composite.cu", "egonerf_tpu/ops/volrend.py:27",
            lambda *a: ops.KERNELS.composite_bwd(*a, **b_kw),
            lambda *a: ops.PLAIN.composite_bwd(*a, **b_kw), b_args,
            nbytes(*b_args[:4], *b_extra, b_kw["d_alpha"]) + 4 * (feat.numel() + rgb.numel()),
            feat.numel() * 62)
        d_args = rec["density"].args
        table[f"K3 train{s1}"] = density_train_case(
            f"K3 density_fwd, training instantiation ({label} sparsity lookup, "
            f"{d_args[0].shape[0]:,} points)", ops, d_args)
        k2_args = rec["k2"]
        row = check_field_bwd(
            f"K2 field_bwd at no appearance channels ({label} sparsity lookup)", k2_args, ops)
        # JAX's float32 VJPs of the lookups, _plane_bwd and _line_bwd; the
        # bound reads only the rows the points touch (the gradient tables
        # are written whole)
        row["replaces"] = "egonerf_tpu/ops/vm_lookup.py:456"
        k_coords, k_planes, k_lines = k2_args[:3]
        row["bound_ms"], row["bound_by"] = bound(
            nbytes(k_coords, *k2_args[3:6]) + touched_table_bytes(k_coords, k_planes, k_lines)
            + sum(4 * t.numel() for t in (*k_planes, *k_lines)),
            k_coords.shape[0] * sum(p.shape[-1] for p in k_planes) * 18)
        print(f"phase 2 K2 at no appearance channels ({label}): bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}) with the touched rows read", flush=True)
        table[f"K2 (n_app=0){s1}"] = row
        print(f"phase 2 loss step ({label}): composite {r} x {s}, sparsity lookup on "
              f"{d_args[0].shape[0]:,} points, density tables "
              f"{[tuple(p.shape) for p in d_args[1]]}", flush=True)
    k6b_alpha_sweep(ops)
    # K14f at 10 floats a row (rays | rgb | depth): both rasters, two
    # batches, bit for bit
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 29)
    for roi in THETA_ROIS:
        sam = theta_raster(roi)
        cdf = torch.as_tensor(np.cumsum(sam.weight).astype(np.float32), device=dev)
        buffer = torch.rand(sam.img_len * sam.w * sam.h, 10, generator=gen, device=dev)
        for t in (1, 2):
            ids = batch_equal(f"K14f at 10 floats, {sam.w}x{sam.h} raster, roi {list(roi)}, "
                              f"batch {t}", ops, (buffer, cdf, sam.w, sam.h, THETA_DRAWS, SEED, t))
            want = ops.KERNELS.theta_batch(buffer[:, :9].contiguous(), cdf, sam.w, sam.h,
                                           THETA_DRAWS, SEED, t)[0]
            if not torch.equal(ids, want):
                fail("K14f draws other ids at 10 floats than at 9")
    args = (buffer, cdf, sam.w, sam.h, THETA_DRAWS, SEED, 5)
    table["K14f (10 floats)"] = kernel_row(
        "K14f theta_batch (10 floats)", "egonerf_torch/csrc/theta_sampler.cu",
        "egonerf_tpu/data/samplers.py:87", 0.0, time_ms(lambda: ops.KERNELS.theta_batch(*args)),
        time_ms(lambda: ops.PLAIN.theta_batch(*args), reps=5),
        THETA_DRAWS * (8 + 2 * 40) + 4 * sam.h,
        THETA_DRAWS * (80 + 6 + 2 * int(np.ceil(np.log2(sam.h))) + 6))
    return table


def loss_launches(base: dict) -> dict:
    """``base``'s launches of TRAIN_STEPS default steps, plus those of the
    three losses: K6 and K6b in their training instantiations (counted in
    their forms too), and one more K3 (its training instantiation) and K2
    (at no appearance channels) a step."""
    want = dict(base)
    for k in ("K6 alpha", "K6b alpha", "K3 train", "K2 dens"):
        want[k] = TRAIN_STEPS
    want["K3"] += TRAIN_STEPS
    want["K2"] += TRAIN_STEPS
    return want


def loss_variant(label, trainer, ops, wrappers, base: dict, it: int, cull_keep: int = 0):
    """Phase 25 for one trainer with LOSSES on: TRAIN_STEPS timed steps
    (launches: ``base`` plus the losses'), the same with the losses off in
    this process, the profile of the loss steps, one loss step against the
    plain versions.  Returns (launches, loss median, default median)."""
    cfg = trainer.cfg
    cfg.train_keep = cull_keep
    try:
        launches, median = timed_steps(
            trainer.train_step, f"phase 25 {label} step with the losses", cfg, wrappers,
            loss_launches(base))
        steps_it = 10 ** 4

        def steps():
            nonlocal steps_it
            for _ in range(PROFILE_STEPS):
                trainer.train_step(steps_it)
                steps_it += 1
        profile(steps, PROFILE_STEPS, f"phase 25 {label}", "step", top=16)
        step_vs_plain(trainer, ops, f"phase 25 {label}", cull_keep, it)
        with losses(cfg, False):
            _, default = timed_steps(trainer.train_step, f"phase 25 {label} step, losses off",
                                     cfg, wrappers, base)
    finally:
        cfg.train_keep = 0
    print(f"phase 25 summary {label}: median step {median:.3f} ms with the losses, "
          f"{default:.3f} ms without ({median - default:+.3f} ms)", flush=True)
    return launches, median, default


def losses_phase(root, presets, ops, wrappers) -> dict:
    """Phase 25: the entropy, sparsity and depth losses (LOSSES) at full
    width through ``Trainer.train_step``: the indoor production trainer,
    the outdoor shape (K6e with alpha), a culled step (train_keep
    CULL_TRAIN_KEEP), the TensoRF shape (gated, S = 1) and the indoor
    trainer under ``theta_importance`` (K14f at 10 floats).  Returns the
    launches of the training instantiations in the timed loss steps, by
    kernel row."""
    from egonerf_torch.data.datasets import SyntheticEgoDataset
    from egonerf_torch.models.alphamask import AlphaGridMask
    from egonerf_torch.train.config import load_config
    from egonerf_torch.train.trainer import Trainer

    base_dir = os.path.join(root, "build", "chip_smoke_runs")
    common = dict(basedir=base_dir, n_iters=10 ** 9, N_vis=0, progress_refresh_rate=10 ** 9,
                  **LOSSES)
    rows = {}

    def trainer_of(overrides, scene=None):
        t = Trainer(load_config(overrides=overrides), device=DEVICE)
        if scene is not None:
            s = dict(scene, near_far=t.cfg.near_far)
            t.set_datasets(SyntheticEgoDataset(split="train", **s),
                           SyntheticEgoDataset(split="test", is_stack=True, **s))
        if t.sampler.buffer.shape[1] != 10:
            fail(f"phase 25: a buffer of {t.sampler.buffer.shape[1]} floats a ray under use_depth")
        return t

    indoor = trainer_of(presets.production_overrides(expname="losses", **common))
    print(f"phase 25 indoor trainer: {LOSSES}, {indoor.sampler.buffer.shape[0]:,} rays of "
          f"{indoor.sampler.buffer.shape[1]} floats, "
          f"{int((indoor.sampler.buffer[:, 9] != 0).sum()):,} with a depth", flush=True)
    plain = step_launches(wrappers, envmap=False)
    launches, _, _ = loss_variant("indoor", indoor, ops, wrappers, plain, 5)
    rows.update({"K6 alpha": launches["K6 alpha"], "K6b alpha": launches["K6b alpha"],
                 "K3 train": launches["K3 train"], "K2 (n_app=0)": launches["K2 dens"]})
    culled = {k: TRAIN_STEPS * ((k in ("K1", "K2", "K3", "K4c", "K4c+draw", "K6", "K6b",
                                       "K13")) + (k == "K7") * 2) for k in wrappers}
    loss_variant(f"culled (train_keep {CULL_TRAIN_KEEP})", indoor, ops, wrappers, culled, 5,
                 cull_keep=CULL_TRAIN_KEEP)
    del indoor
    torch.cuda.empty_cache()

    theta = trainer_of(presets.production_overrides(expname="losses_theta",
                                                    sampling_method="theta_importance",
                                                    **common))
    launches, _, _ = loss_variant("theta_importance", theta, ops, wrappers,
                                  dict(plain, K14f=TRAIN_STEPS), 5)
    rows["K14f (10 floats)"] = launches["K14f"]
    del theta
    torch.cuda.empty_cache()

    outdoor = trainer_of(presets.outdoor_overrides(expname="losses_outdoor", **common),
                         ENV_SCENE)
    launches, _, _ = loss_variant("outdoor", outdoor, ops, wrappers,
                                  step_launches(wrappers, envmap=True), 5)
    rows.update({"K6e alpha": launches["K6 alpha"], "K6b+env alpha": launches["K6b alpha"]})
    del outdoor
    torch.cuda.empty_cache()

    tf = trainer_of(presets.tensorf_mask_overrides(expname="losses_tensorf", **common),
                    presets.TENSORF_BENCH_SCENE)
    tf.model.alpha_mask = AlphaGridMask(half_mask(TF_MASK_RESO, DEVICE), device=DEVICE)
    tf_base = {k: TRAIN_STEPS if k in ("K1", "K2", "K9", "K6", "K6b") else 0 for k in wrappers}
    launches, _, _ = loss_variant("TensoRF", tf, ops, wrappers, tf_base, 5)
    rows.update({"K6 gated alpha": launches["K6 alpha"], "K6b gated alpha": launches["K6b alpha"],
                 "K3 train (S=1)": launches["K3 train"],
                 "K2 (n_app=0) (S=1)": launches["K2 dens"]})
    del tf
    torch.cuda.empty_cache()
    return rows


# -- the rest of the TensoRF family: TensorVM, TensorCP, NDC, filter_ray -------
def partial_states(coords, planes, lines, n_density, line_hat, ops) -> str:
    """The share of negative, exactly zero and positive density partials of
    these inputs (the plain version's relu states)."""
    mask = ops.PLAIN.field(coords, planes, lines, n_density, line_hat, with_mask=True)[2]
    states = torch.stack([(mask >> (2 * i)) & 3 for i in range(3)])
    n = states.numel()
    return ", ".join(f"{int((states == v).sum()) / n:.1%} {label}"
                     for v, label in ((0, "negative"), (1, "exactly zero"), (2, "positive")))


def norelu_kernel_checks(ops, f_args, b_args, d_args) -> dict:
    """Phase 2, TensorVM's relu-free K1, K3 and K2 at S = 1 on the inputs
    of a recorded TensoRF step and bake, with decomposition 0's density
    channels zeroed on half of its plane's rows, so that the partials are
    negative, exactly zero and positive: each against its plain version at
    K1's, K3's and K2's limits.  Returns their rows."""
    vm_src, vm = "egonerf_torch/csrc/vm_lookup.cu", "egonerf_tpu/ops/vm_lookup.py"
    coords, planes, lines, n_density, line_hat = f_args[:5]

    def zeroed(ps, nd):
        p0 = ps[0].clone()
        p0[:, : p0.shape[1] // 2, :, :nd] = 0
        return [p0, *ps[1:]]

    planes = zeroed(planes, n_density[0])
    print(f"phase 2 relu-free inputs: the TensoRF step's {coords.shape[0]:,} samples, plane 0's "
          f"density channels zeroed on half its rows: partials "
          f"{partial_states(coords, planes, lines, n_density, line_hat, ops)}", flush=True)
    n, n_ch = coords.shape[0], sum(p.shape[-1] for p in planes)
    n_app = n_ch - sum(n_density)
    table = {}
    table["K1 (S=1, no relu)"] = check_case(
        "K1 field_fwd (S=1, no relu)", vm_src, f"{vm}:467",
        lambda *a: ops.KERNELS.field(*a, relu=False), lambda *a: ops.PLAIN.field(*a, relu=False),
        (coords, planes, lines, n_density, line_hat),
        nbytes(coords, *planes, *lines) + n * (1 + n_app) * 4, n * n_ch * 11)
    dc, dp, dl = d_args
    table["K3 (S=1, no relu)"] = check_case(
        "K3 density_fwd (S=1, no relu)", vm_src, f"{vm}:436",
        lambda *a: ops.KERNELS.density(*a, relu=False),
        lambda *a: ops.PLAIN.density(*a, relu=False), (dc, zeroed(dp, dp[0].shape[-1]), dl),
        nbytes(dc, *dp, *dl) + dc.shape[0] * 4, dc.shape[0] * sum(p.shape[-1] for p in dp) * 11)
    bc, _, bl, d_dens, d_app, _, nd, lh = b_args[:8]
    table["K2 (S=1, no relu)"] = check_field_bwd(
        "K2 field_bwd (S=1, no relu)", (bc, planes, bl, d_dens, d_app, None, nd, lh), ops,
        kw=dict(relu=False))
    return table


def cp_bwd_case(name, args, ops, row=True, unstaged=False):
    """K17b against its plain version per row (:func:`per_cell_check`, K2's
    limit: float32 atomics add in another order), timed; its row (with
    ``unstaged``, the unstaged form's)."""
    from egonerf_torch.ops import cp

    coords, lines, d_dens, d_app, nd, modes = args
    plan = cp.launch_plan(coords, lines, nd, d_app if d_app.shape[1] else None, backward=True,
                          unstaged=unstaged)
    print(f"phase 2 {name}: {plan}", flush=True)
    got = ops.KERNELS.cp_bwd(*args, unstaged=unstaged)
    ref = ops.PLAIN.cp_bwd(*args, accumulate=torch.float64)
    ref32 = ops.PLAIN.cp_bwd(*args)
    mag = ops.PLAIN.cp_bwd(*args, magnitude=True, accumulate=torch.float64)
    torch.cuda.synchronize()
    abs_err = per_cell_check(name, got, ref, ref32, mag)
    del got, ref, ref32, mag
    ms = time_ms(lambda: ops.KERNELS.cp_bwd(*args, unstaged=unstaged))
    if not row:
        print(f"phase 2 {name}: kernel {ms:.4f} ms", flush=True)
        return None
    return kernel_row(
        name, "egonerf_torch/csrc/cp_lookup.cu", "egonerf_tpu/ops/vm_lookup.py:611", abs_err,
        ms, time_ms(lambda: ops.PLAIN.cp_bwd(*args), reps=5),
        # coords and cotangents read once, the lines read, the gradients written
        nbytes(coords, *lines, d_dens, d_app) + sum(4 * l.numel() for l in lines),
        # per sample and channel: three line samples (9), the three douts
        # (5), two weighted contributions an axis (6)
        coords.shape[0] * lines[0].shape[-1] * 20)


def cp_fwd_case(name, args, ops, unstaged=False, cold=False) -> dict:
    """K17 against its plain version at K1's limit (rel 1e-5 of max|plain|:
    the density sums go in another order), timed; its row."""
    from egonerf_torch.ops import cp

    coords, tabs, nd, modes = args
    n = coords.shape[0]
    print(f"phase 2 {name}: {cp.launch_plan(coords, tabs, nd, unstaged=unstaged)}", flush=True)
    return check_case(
        name, "egonerf_torch/csrc/cp_lookup.cu", "egonerf_tpu/models/tensorf.py:459",
        lambda *a: ops.KERNELS.cp(*a, unstaged=unstaged), ops.PLAIN.cp, args,
        nbytes(coords, *tabs) + n * 4 + n * (tabs[0].shape[-1] - nd) * 4,
        # per sample and channel: three line samples (9), two products, the
        # density sum
        n * tabs[0].shape[-1] * 12, cold=cold)


def record_cp_step(trainer, ops, plain=False):
    """The K17 and K17b arguments of one TensorCP training step: (coords,
    lines, n_density, line modes, d_dens, d_app); with ``plain`` the step
    runs their plain versions."""
    model = trainer.model
    src = ops.PLAIN if plain else ops.KERNELS
    rec_f, rec_b = Recorder(src.cp), Recorder(src.cp_bwd)
    model.ops = ops.KERNELS._replace(cp=rec_f, cp_bwd=rec_b)
    try:
        trainer.train_step(0)
    finally:
        model.ops = ops.KERNELS
    torch.cuda.synchronize()
    coords, lines, nd, modes = rec_f.args
    d_dens, d_app = rec_b.args[2:4]
    return coords, lines, nd, modes, d_dens, d_app


def cp_registers() -> None:
    """ptxas's registers of the staged and the unstaged K17 and K17b."""
    from egonerf_torch import _build

    for name, regs, spill in _build.ptxas_report("cp_lookup"):
        if "_kernel<" in name:
            print(f"phase 2 K17/K17b registers: {regs} ({spill} bytes spilled) "
                  f"{name.split('(float')[0]}", flush=True)


def cp_kernel_checks(trainer, ops) -> dict:
    """Phase 2, K17 and K17b at CP-384 on the inputs of one recorded
    TensorCP training step (1,048,576 samples; lines of 500 rows, 96 + 288
    channels): K17 in its eval (bf16 lines), training (float32) and
    density-only (96 float32 channels: the bake, ``compute_alpha`` and the
    sparsity loss) forms on the hat and the linear line weights, at K1's
    limit (rel 1e-5 of max|plain|: the density sums go in another order);
    K17b on both weights and with every sample on four points (a few rows,
    262,144 terms a row and no run to merge), per row at K2's limit; each
    staged kernel's time beside the unstaged form's (the PR 18 kernels) in
    turns.  Then the shapes the staging must take: the scalar instantiation
    (6 + 20 channels), uneven and long lines (17, 500, 1,700 rows), lines
    past the staging limit (the unstaged form), n = 1 and an n no part or
    run divides.  Returns their rows, named as the launch counters (``K17
    (form, mode)``, ``K17b (mode)``, ``K17 (unstaged)``, ``K17b
    (unstaged)``)."""
    from egonerf_torch.ops import cp
    from egonerf_torch.ops.vm_lookup import HAT, LINEAR

    coords, lines, nd, modes, d_dens, d_app = record_cp_step(trainer, ops)
    n, c = coords.shape[0], lines[0].shape[-1]
    print(f"phase 2 TensorCP inputs: {trainer.cfg.batch_size} rays x {trainer.cfg.n_coarse} "
          f"samples ({n:,}), lines {[tuple(l.shape) for l in lines]} ({nd} density + "
          f"{c - nd} appearance channels), grid {trainer.model.grid_size}, line modes "
          f"{list(modes)}", flush=True)
    cp_registers()
    bf = [l.to(torch.bfloat16) for l in lines]
    dens32 = [l[..., :nd].contiguous() for l in lines]
    table = {}
    for mode_name, m in (("hat", HAT), ("linear", LINEAR)):
        mm = (m,) * 3
        for form, tabs in (("eval", bf), ("train", lines), ("density", dens32)):
            table[f"K17 ({form}, {mode_name})"] = cp_fwd_case(
                f"K17 cp_fwd ({form}, {mode_name})", (coords, tabs, nd, mm), ops,
                cold=form == "train")
        table[f"K17b ({mode_name})"] = cp_bwd_case(
            f"K17b cp_bwd ({mode_name})", (coords, lines, d_dens, d_app, nd, mm), ops)
    # the staged kernels beside the unstaged form (the PR 18 kernels) on the
    # step, in turns (unstaged, staged, staged, unstaged)
    for form, tabs in (("eval", bf), ("train", lines), ("density", dens32)):
        t = turns({"unstaged": lambda t=tabs: ops.KERNELS.cp(coords, t, nd, modes, unstaged=True),
                   "staged": lambda t=tabs: ops.KERNELS.cp(coords, t, nd, modes)})
        print(f"phase 2 K17 ({form}, hat) in turns: staged {t['staged']:.4f} ms, unstaged form "
              f"{t['unstaged']:.4f} ms; shared bytes {cp.launch_plan(coords, tabs, nd)[1].smem:,} "
              f"(unstaged 0)", flush=True)
    b_args = (coords, lines, d_dens, d_app, nd, modes)
    t = turns({"unstaged": lambda: ops.KERNELS.cp_bwd(*b_args, unstaged=True),
               "staged": lambda: ops.KERNELS.cp_bwd(*b_args)})
    print(f"phase 2 K17b (hat) in turns: staged {t['staged']:.4f} ms, unstaged form "
          f"{t['unstaged']:.4f} ms; shared bytes "
          f"{cp.launch_plan(coords, lines, nd, d_app, backward=True)[1].smem:,} (unstaged 0)",
          flush=True)
    # consecutive samples on alternate points: no run to merge, so an
    # atomic a term, 262,144 terms a row (the float32 plain version's error,
    # printed beside, is several times K2's limit here)
    few = coords[torch.arange(n, device=coords.device) % 4 * (n // 4)].contiguous()
    cp_bwd_case("K17b cp_bwd (hat, every sample on four points)",
                (few, lines, d_dens, d_app, nd, modes), ops, row=False)
    k = min(10_000, n)
    cp_bwd_case(f"K17b cp_bwd (density only, {k:,} points)",
                (coords[:k].contiguous(), dens32, d_dens[:k].contiguous(),
                 d_app.new_zeros(k, 0), nd, modes), ops, row=False)
    table.update(cp_shape_checks(coords, d_dens, d_app, modes, ops))
    return table


def cp_shape_checks(coords, d_dens, d_app, modes, ops) -> dict:
    """K17 (three forms) and K17b on seeded lines of other shapes, on the
    step's samples and cotangents: the scalar instantiation (6 + 20
    channels), uneven and long lines (17, 500, 1,700 rows, 96 + 288: one
    block an SM), lines past the staging limit (17, 500, 30,000 rows: the
    unstaged form, whose rows it returns), and n = 1 and 1,048,573 (no part
    or run divides it) at CP-384's shape.  Each at its kernel's limit."""
    from egonerf_torch.ops import cp

    gen = torch.Generator(device=coords.device).manual_seed(SEED)

    def seeded(ls, ch):
        return [torch.randn(1, l, ch, device=coords.device, generator=gen) * 0.3 for l in ls]

    def case(label, ls, nd, ch, n, unstaged_rows=False):
        lines = seeded(ls, ch)
        cs_, dd = coords[:n].contiguous(), d_dens[:n].contiguous()
        da = torch.randn(n, ch - nd, device=coords.device, generator=gen)
        rows = {}
        for form, tabs in (("eval", [l.to(torch.bfloat16) for l in lines]), ("train", lines),
                           ("density", [l[..., :nd].contiguous() for l in lines])):
            rows[form] = cp_fwd_case(f"K17 cp_fwd ({form}, {label})", (cs_, tabs, nd, modes),
                                     ops)
        rows["bwd"] = cp_bwd_case(f"K17b cp_bwd ({label})", (cs_, lines, dd, da, nd, modes), ops,
                                  row=unstaged_rows)
        return rows

    n = coords.shape[0]
    case("scalar, 6 + 20 channels", (500, 500, 500), 6, 26, n)
    case("lines of 17, 500, 1,700 rows", (17, 500, 1_700), 96, 384, n)
    past = case("lines of 17, 500, 30,000 rows: unstaged", (17, 500, 30_000), 96, 384, n,
                unstaged_rows=True)
    if cp.launch_plan(coords, seeded((17, 500, 30_000), 8), 4)[1] is not None:
        fail("lines of 30,517 rows got a staged K17 plan")
    for m in (1, min(n, 1_048_573)):
        case(f"n = {m:,}", (500, 500, 500), 96, 384, m)
    return {"K17 (unstaged)": past["train"], "K17b (unstaged)": past["bwd"]}


def turns(runs: dict) -> dict:
    """Each of ``runs`` timed by :func:`time_ms` in turns (a, b, ..., b,
    a); the mean of its two."""
    names = list(runs)
    t = {k: [] for k in names}
    for k in names + names[::-1]:
        t[k].append(time_ms(runs[k]))
    return {k: sum(v) / len(v) for k, v in t.items()}


def family_trainer(root, presets, overrides, expname):
    """A TensoRF-family trainer on the bench scene with a 128^3 mask of
    half occupancy (random weights from the config's seed)."""
    from egonerf_torch.data.datasets import SyntheticEgoDataset
    from egonerf_torch.models.alphamask import AlphaGridMask
    from egonerf_torch.train.config import load_config
    from egonerf_torch.train.trainer import Trainer

    cfg = load_config(overrides=overrides(
        basedir=os.path.join(root, "build", "chip_smoke_runs"), expname=expname,
        n_iters=10 ** 9, progress_refresh_rate=10 ** 9))
    trainer = Trainer(cfg, device=DEVICE)
    scene = dict(presets.TENSORF_BENCH_SCENE, near_far=cfg.near_far)
    trainer.set_datasets(SyntheticEgoDataset(split="train", **scene),
                         SyntheticEgoDataset(split="test", is_stack=True, **scene))
    trainer.model.alpha_mask = AlphaGridMask(half_mask(TF_MASK_RESO, trainer.device),
                                             device=trainer.device)
    return trainer


def family_phase(phase, trainer, ops, wrappers, presets, Renderer, per_step, per_chunk,
                 per_bake, base_ms=None) -> dict:
    """Phases 26 and 27 for one TensoRF member: a step against the plain
    versions, TRAIN_STEPS timed steps (``per_step`` kernels once a step;
    beside TensorVMSplit's ``base_ms`` of this process), the profile, a
    1000x500 view (``per_chunk`` kernels once a chunk, a few chunks against
    the plain versions), and the bake at 128^3 (``per_bake`` launched, the
    rest not).  Returns the launches of the steps, the view and the bake."""
    from egonerf_torch.data.ray_utils import get_ray_directions_360

    cfg, model = trainer.cfg, trainer.model
    label = f"phase {phase} {cfg.model_name}"
    step_vs_plain(trainer, ops, label)
    steps, median = timed_steps(
        trainer.train_step, f"{label} training step, {cfg.n_coarse} samples, grid "
        f"{model.grid_size}", cfg, wrappers,
        {k: TRAIN_STEPS if k in per_step else 0 for k in wrappers})
    if base_ms is not None:
        print(f"{label} step {median:.3f} ms beside TensorVMSplit's {base_ms:.3f} ms in this "
              f"process ({median - base_ms:+.3f})", flush=True)
    it = 10 ** 4

    def run():
        nonlocal it
        for _ in range(PROFILE_STEPS):
            trainer.train_step(it)
            it += 1
    profile(run, PROFILE_STEPS, label, "step", top=12)
    with torch.no_grad():
        view, s_image = render_phases(
            model, trainer.params, get_ray_directions_360(*TF_IMAGE_HW).reshape(-1, 3), ops,
            presets, Renderer, wrappers, phases=(phase, phase, phase),
            renderer=Renderer.from_config(model, cfg, trainer.white_bg), per_chunk=per_chunk,
            hw=TF_IMAGE_HW)
    mask = model.alpha_mask
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    trainer.update_alpha_mask()
    torch.cuda.synchronize()
    bake_ms = (time.time() - t0) * 1e3
    bake = {k: w.launches for k, w in wrappers.items()}
    model.alpha_mask = mask
    print(f"{label} bake at {[min(r, TF_MASK_RESO) for r in model.grid_size]}: {bake_ms:.1f} ms, "
          f"launches {bake}", flush=True)
    if any(bake[k] < 1 for k in per_bake) or any(v for k, v in bake.items()
                                                 if k not in per_bake):
        fail(f"{label}: the bake launched {bake}, expected {sorted(per_bake)} only")
    return {"steps": steps, "view": view, "bake": bake, "median": median, "s_image": s_image}


def ndc_filter_phase(root, presets, ops, wrappers) -> None:
    """Phase 28 on the TensoRF bench scene: TensorVMSplit's training step
    under ``ndc_ray`` against the plain versions, and timed NDC steps (K1,
    K2, K9, K6, K6b once a step); then a trainer with ``filter_ray``: the
    filter's kept count on the scene's training rays against the slab test
    on the host, its seconds, the sampler's buffer, and timed steps."""
    from egonerf_torch.data.datasets import SyntheticEgoDataset

    per_step = ("K1", "K2", "K9", "K6", "K6b")
    want = {k: TRAIN_STEPS if k in per_step else 0 for k in wrappers}
    ndc = family_trainer(root, presets, lambda **kw: presets.tensorf_mask_overrides(
        ndc_ray=1, **kw), "tensorf_ndc")
    step_vs_plain(ndc, ops, "phase 28 NDC")
    timed_steps(ndc.train_step, f"phase 28 TensorVMSplit NDC training step, {ndc.cfg.n_coarse} "
                f"samples over [near, far]", ndc.cfg, wrappers, want)
    del ndc
    torch.cuda.empty_cache()
    filt = family_trainer(root, presets, lambda **kw: presets.tensorf_mask_overrides(
        filter_ray=1, **kw), "tensorf_filter")
    train = SyntheticEgoDataset(split="train", **dict(presets.TENSORF_BENCH_SCENE,
                                                      near_far=filt.cfg.near_far))
    rays, rgbs = np.asarray(train.all_rays), np.asarray(train.all_rgbs)
    # a tenth as many rays again whose lines miss the box (from three box
    # radii out along u, heading across u) and as many heading away from it
    # (their lines cross the box behind the origin: JAX's slab test has no
    # t > 0, so it keeps them)
    box = filt.model.aabb
    centre, radius = box.mean(0), float(np.linalg.norm(box[1] - box[0])) / 2
    rng = np.random.default_rng(SEED)
    m = rays.shape[0] // 10
    u = rng.normal(size=(2 * m, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    v = np.cross(u, rng.normal(size=(2 * m, 3)))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    origins = centre + 3 * radius * u
    extra = np.concatenate([np.concatenate([origins[:m], v[:m]], 1),
                            np.concatenate([origins[m:], u[m:]], 1)]).astype(np.float32)
    all_rays = np.concatenate([rays[:, :6], extra])
    all_rgbs = np.concatenate([rgbs, np.zeros((2 * m, rgbs.shape[1]), rgbs.dtype)])

    def slab(r):  # the slab test on the host, as JAX's _filter_chunk computes it
        vec = np.where(r[:, 3:6] == 0, np.float32(1e-6), r[:, 3:6])
        rate_a, rate_b = (box[1] - r[:, :3]) / vec, (box[0] - r[:, :3]) / vec
        return np.minimum(rate_a, rate_b).max(-1) < np.maximum(rate_a, rate_b).min(-1)

    touch = int(slab(rays).sum())
    torch.cuda.synchronize()
    t0 = time.time()
    kept = filt.model.filtering_rays(filt.params, all_rays, all_rgbs, bbox_only=True)[0].shape[0]
    seconds = time.time() - t0
    host_kept = int(slab(all_rays).sum())
    train.all_rays, train.all_rgbs = all_rays, all_rgbs
    filt.set_datasets(train, filt.test_dataset)  # filters again as it installs the sampler
    resident = int(filt.sampler.buffer.shape[0])
    print(f"phase 28 filter_ray: kept {kept:,} of {all_rays.shape[0]:,} rays ({rays.shape[0]:,} "
          f"of the scene, {touch:,} of them touching the box; {m:,} whose lines miss it; {m:,} "
          f"heading away) in {seconds:.3f} s (the host's slab test {host_kept:,}; the sampler "
          f"holds {resident:,})", flush=True)
    if not kept == host_kept == resident == touch + m < all_rays.shape[0]:
        fail("phase 28: filter_ray kept other rays than the slab test")
    timed_steps(filt.train_step, "phase 28 TensorVMSplit training step after filter_ray",
                filt.cfg, wrappers, want)
    del filt
    torch.cuda.empty_cache()


def variant_quality_phase(root: str) -> None:
    """Phase 8v: the smoke recipe of phase 8 through the command line under
    each of SMOKE_VARIANTS (EgoNeRF's grid upsampling, its linear
    sampling): test PSNR above the JAX package's for the same recipe on the
    CPU (tests/smoke_variants_jax.py) less the seed band."""
    from egonerf_torch.__main__ import main as cli_main
    from egonerf_torch.train.checkpoint import latest_checkpoint, load_checkpoint

    for name, extra in SMOKE_VARIANTS.items():
        base = os.path.join(root, "build", "chip_smoke_runs", f"smoke_{name}")
        shutil.rmtree(base, ignore_errors=True)
        argv = ["--config", os.path.join(root, SMOKE_CONFIG), "--n_iters", str(SMOKE_ITERS),
                "--vis_list", f"[{SMOKE_ITERS}]", "--N_vis", "-1", "--basedir", base, *extra]
        t0 = time.time()
        cli_main(argv)
        torch.cuda.synchronize()
        logdir = os.path.join(base, "smoke")
        psnr = float(np.loadtxt(os.path.join(logdir, "imgs_vis",
                                             f"{SMOKE_ITERS - 1:06d}_mean.txt"))[0])
        _, header = load_checkpoint(latest_checkpoint(logdir))
        floor = JAX_SMOKE_VARIANT_PSNR[name] - SEED_BAND_DB
        print(f"phase 8v smoke run, {name} ({' '.join(extra)}; {SMOKE_ITERS} iterations, "
              f"{time.time() - t0:.1f} s): test PSNR {psnr:.2f} dB, grid "
              f"{header['coords_spec']['resolution']}; the JAX package on the CPU "
              f"{JAX_SMOKE_VARIANT_PSNR[name]:.2f} dB, floor {floor:.2f} dB", flush=True)
        if not psnr >= floor:
            fail(f"smoke {name} test PSNR {psnr:.2f} dB below {floor:.2f}")


# -- the other charts, shading modes and mesh export: phases 29-31 -------------
def sphere_check(name: str, ops, args, model=None, exact_r=False) -> float:
    """K7s against its plain version: every flag 0 on both sides, the coords
    within K7_TOL; with ``model`` (a TensoRF model) K7s asked for the mask
    in its aabb, the mask bit for bit with the model's ``_in_box`` of
    torch's points (the samplers' mask the path used before K7s gave it);
    with ``exact_r`` the radial column bit for bit.  Returns the max abs
    error."""
    if model is None:
        got, ref = ops.KERNELS.chart_sphere(*args), ops.PLAIN.chart_sphere(*args)
    else:
        box = model._box(args[0].device)
        (got, got_m), (ref, _) = (ops.KERNELS.chart_sphere(*args, box),
                                  ops.PLAIN.chart_sphere(*args, box))
        in_box = model._in_box(args[0][:, None, :] + args[1][:, None, :]
                               * args[2][..., None]).reshape(-1)
    torch.cuda.synchronize()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        fail(f"{name}: shape {tuple(got.shape)} (plain {tuple(ref.shape)}) or non-finite")
    flags = int((got[:, 3] != 0).sum()) + int((ref[:, 3] != 0).sum())
    col_err = (got - ref).abs().amax(dim=0).tolist()
    abs_err = max(col_err)
    r_bits = int((got[:, 0] != ref[:, 0]).sum())
    ok = flags == 0 and abs_err <= K7_TOL and (r_bits == 0 or not exact_r)
    mask = ""
    if model is not None:
        m_bits = int((got_m != in_box).sum())
        ok = ok and m_bits == 0 and got_m.dtype == torch.bool
        mask = (f"; mask: {m_bits} of {in_box.numel():,} differ from _in_box of torch's points "
                f"({int(in_box.sum()):,} in the box)")
    print(f"phase 29 {name}: {got.shape[0]:,} samples, nonzero flags {flags}; max abs err "
          f"{abs_err:.3e} (r {col_err[0]:.1e}, theta {col_err[1]:.1e}, phi {col_err[2]:.1e}; "
          f"{int((got != ref).any(1).sum()):,} samples differ at all, the radial column on "
          f"{r_bits}){mask} (flags 0, abs <= {K7_TOL:.0e}"
          f"{', the radial column bit for bit' if exact_r else ''}"
          f"{', the mask bit for bit' if model is not None else ''}) -> "
          f"{'ok' if ok else 'MISS'}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return abs_err


def sphere_edge_radii(coords, dev):
    """K7s's arguments whose radii are the radial grid's entries, an ulp
    either side of each, 0 and past the last entry (1.5x, 2x): one ray from
    the centre of a copy of ``coords`` centred on the origin (the same
    radial grid), along +x, so each depth is its radius exactly."""
    from egonerf_torch.coords.spherical import GenericSphericalCoords

    centred = GenericSphericalCoords(coords.aabb - np.float32(coords.center), exp_r=True,
                                     r0=coords.r0, interval_th=True)
    centred.set_resolution(coords.resolution, r0=coords.r0)
    grid = np.asarray(centred.ref_grid, np.float32)
    if not np.array_equal(grid, coords.ref_grid) or np.any(centred.center != 0):
        fail("phase 29: the centred chart's radial grid is not the chart's")
    r = np.concatenate([grid, np.nextafter(grid, np.float32(np.inf)),
                        np.nextafter(grid[1:], np.float32(0)),
                        np.float32([0.0, 1.5 * grid[-1], 2 * grid[-1]])]).astype(np.float32)
    z = torch.as_tensor(r, device=dev)[None]
    o = torch.zeros(1, 3, device=dev)
    d = torch.tensor([[1.0, 0.0, 0.0]], device=dev)
    return o, d, z, centred


def face_rays(box: np.ndarray, near: float, n: int, dev):
    """Rays at the aabb's faces: half axis-aligned from ``near`` + 1 outside,
    so the uniform sampler's first sample lies on the face they enter or
    within an ulp of it; half lying in a face's plane, parallel to it
    (every sample on the face).  The other two coordinates inside the box,
    on its edges or an ulp outside."""
    rng = np.random.default_rng(SEED)
    lo, hi = box
    axis = rng.integers(0, 3, n)
    sign = rng.choice([-1.0, 1.0], n).astype(np.float32)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    pick = rng.integers(0, 5, (n, 3))
    o = np.where(pick == 1, lo, np.where(pick == 2, hi, o))
    o = np.where(pick == 3, np.nextafter(hi, np.float32(np.inf)), o)
    o = np.where(pick == 4, np.nextafter(lo, np.float32(-np.inf)), o).astype(np.float32)
    d = np.zeros((n, 3), np.float32)
    rows = np.arange(n)
    face = np.where(sign > 0, lo[axis], hi[axis])
    inside = rows < n // 2
    d[rows, axis] = np.where(inside, sign, 0.0)
    d[~inside, (axis[~inside] + 1) % 3] = 1.0
    off = np.float32(near + 1.0)
    o[rows, axis] = np.where(inside, face - sign * off, face)
    return torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)


def chart_trainer(root, presets, expname, **deltas):
    """TensorVMSplit at the ``tensorf_mask_overrides`` widths (256 samples a
    ray) with CHART_29's chart on the indoor procedural scene of phases 3-7
    (its default views, near/far), a 128^3 mask of half occupancy."""
    from egonerf_torch.models.alphamask import AlphaGridMask
    from egonerf_torch.train.config import load_config
    from egonerf_torch.train.trainer import Trainer

    cfg = load_config(overrides=presets.tensorf_mask_overrides(**{**CHART_29, **dict(
        basedir=os.path.join(root, "build", "chip_smoke_runs"), expname=expname,
        n_iters=10 ** 9, progress_refresh_rate=10 ** 9), **deltas}))
    trainer = Trainer(cfg, device=DEVICE)
    trainer.model.alpha_mask = AlphaGridMask(half_mask(TF_MASK_RESO, trainer.device),
                                             device=trainer.device)
    return trainer


def plain_chart_ms(coords, pts) -> float:
    """Device ms of a chart's plain map (from_cartesian, normalize_coord, the
    flag column) on ``pts``, as the TensoRF forward runs it."""
    import torch.nn.functional as F

    return time_ms(lambda: F.pad(coords.normalize_coord(coords.from_cartesian(pts)), (0, 1)),
                   reps=5)


def sphere_kernel_checks(trainer, ops, dirs, chunk: int) -> dict:
    """Phase 29: K7s against its plain version at K7's limits, its mask bit
    for bit with the model's ``_in_box`` of torch's points, on one chunk of
    the view's rays and their exponential depths (radial modes 0, 1, 2:
    the lookup under interval_th, the closed-form cells, linear), on rays
    from outside the box, on rays at and along its faces, on the poles and
    the phi = +-pi seam (both signs of zero) and on a recorded training
    step; the radial column bit for bit on the grid's entries, an ulp
    either side, 0 and past the last; its row with time and bound; and each
    plain chart's map on the chunk's points, timed beside it."""
    from egonerf_torch.coords import make_coordinates
    from egonerf_torch.coords.spherical import GenericSphericalCoords
    from egonerf_torch.ops import chart

    model, cfg = trainer.model, trainer.cfg
    coords, dev = model.coordinates, dirs.device
    n = cfg.n_coarse
    pick = torch.arange(chunk, device=dev) * (dirs.shape[0] // chunk)
    viewdirs = dirs[pick]
    rays_o = torch.zeros_like(viewdirs)
    table = chart.radial_buckets(coords.ref_grid)
    print(f"phase 29 K7s radial bucket table: {len(table.start)} buckets for "
          f"{coords.ref_grid.shape[0]} grid entries, walk at most {table.walk}", flush=True)
    with torch.no_grad():
        pts, z, _ = model.sample_ray_exp(rays_o, viewdirs, n)
        args = (rays_o, viewdirs, z, coords)
        err = sphere_check("K7s chart_sphere (exp depths, mode 0)", ops, args, model)
        for label, exp_r, interval in (("mode 1, closed-form exp", True, False),
                                       ("mode 2, linear", False, False)):
            other = GenericSphericalCoords(coords.aabb, exp_r=exp_r, N_voxel=cfg.N_voxel_init,
                                           r0=float(cfg.r0), interval_th=interval)
            err = max(err, sphere_check(f"K7s chart_sphere ({label})", ops,
                                        (rays_o, viewdirs, z, other), model))
        err = max(err, sphere_check("K7s chart_sphere (radial grid entries, an ulp either side, "
                                    "0, past the last)", ops, sphere_edge_radii(coords, dev),
                                    exact_r=True))
        # a grid whose bucket table is capped, so K7s walks its cells in a loop
        fine = GenericSphericalCoords(coords.aabb, exp_r=True, r0=0.001, interval_th=True)
        fine.set_resolution([1024, *coords.resolution[1:]], r0=0.001)
        walk = chart.radial_buckets(fine.ref_grid).walk
        err = max(err, sphere_check(f"K7s chart_sphere (r0 0.001, n_r 1024: a walk of up to "
                                    f"{walk})", ops, sphere_edge_radii(fine, dev), exact_r=True))
        err = max(err, sphere_check(f"K7s chart_sphere (r0 0.001, n_r 1024, exp depths)", ops,
                                    (rays_o, viewdirs, z, fine), model, exact_r=True))
        box = torch.as_tensor(coords.aabb, device=dev)
        reach = float((box[1] - box[0]).norm()) / 2
        away = torch.rand(chunk, 1, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(SEED)) * 8 + reach
        out_o = -viewdirs * away
        z_out = model.depths_uniform(out_o, viewdirs, n)
        err = max(err, sphere_check("K7s chart_sphere (rays from outside the box)", ops,
                                    (out_o, viewdirs, z_out, coords), model))
        face_o, face_d = face_rays(model.aabb, model.near_far[0], chunk, dev)
        z_face = model.depths_uniform(face_o, face_d, n)
        first = face_o + face_d * z_face[:, :1]
        on_face = int(((first == model._box(dev)[0]) | (first == model._box(dev)[1]))
                      .any(-1).sum())
        print(f"phase 29 rays at the faces: {on_face:,} of {chunk:,} first samples exactly on "
              f"a face", flush=True)
        err = max(err, sphere_check("K7s chart_sphere (rays at and along the box's faces)", ops,
                                    (face_o, face_d, z_face, coords), model))
        hard = torch.tensor(ENV_HARD_DIRS, dtype=torch.float32, device=dev)
        hard = hard / hard.norm(dim=-1, keepdim=True)
        hard = hard.repeat(-(-chunk // hard.shape[0]), 1)[:chunk]
        centre = torch.as_tensor(coords.center, device=dev).expand(chunk, 3)
        err = max(err, sphere_check("K7s chart_sphere (poles and the phi = +-pi seam, from the "
                                    "centre)", ops, (centre, hard, z, coords), model))
        n_grid = coords.ref_grid.shape[0]
        n_bytes, n_ops = chart_cost(rays_o, z, n_grid)
        row = kernel_row("K7s chart_sphere (exp depths, mode 0, with the mask)",
                         "egonerf_torch/csrc/chart.cu", "egonerf_tpu/coords/spherical.py:48",
                         err, time_ms(lambda: ops.KERNELS.chart_sphere(*args, box)),
                         time_ms(lambda: ops.PLAIN.chart_sphere(*args, box), reps=5),
                         n_bytes + z.numel() + 4 * len(table.start), n_ops)
        print(f"phase 29 K7s without the mask: "
              f"{time_ms(lambda: ops.KERNELS.chart_sphere(*args)):.4f} ms", flush=True)
        print(f"phase 29 chart centre {coords.center.tolist()}, far r {coords.far_r:.4f}, "
              f"radial grid {n_grid} entries; depths [{float(z.min()):.4f}, "
              f"{float(z.max()):.4f}]", flush=True)
        for name in ("sphere", "balanced_sphere", "directional_sphere",
                     "directional_balanced_sphere", "euler_sphere", "cylinder",
                     "generic_sphere"):
            c = make_coordinates(name, coords.aabb, exp_r=False, N_voxel=cfg.N_voxel_init,
                                 r0=float(cfg.r0))
            if c.resolution is None:
                c.set_resolution(c.N_to_reso(cfg.N_voxel_init))
            label = "generic_sphere, linear r" if name == "generic_sphere" else name
            print(f"phase 29 plain chart {label}: {plain_chart_ms(c, pts):.4f} ms on the chunk's "
                  f"{pts.shape[0] * pts.shape[1]:,} points (K7s {row['ms']:.4f} ms)",
                  flush=True)
    rec = Recorder(ops.KERNELS.chart_sphere)
    model.ops = ops.KERNELS._replace(chart_sphere=rec)
    try:
        trainer.train_step(0)
    finally:
        model.ops = ops.KERNELS
    torch.cuda.synchronize()
    if len(rec.args) != 5:
        fail("phase 29: the training step did not ask K7s for the in-box mask")
    with torch.no_grad():
        sphere_check("K7s chart_sphere (training step)", ops, rec.args[:4], model)
    return row


def chart_phase(root, presets, ops, wrappers, dirs_np) -> dict:
    """Phase 29: TensorVMSplit on generic_sphere (exp, interval_th, r0 0.03)
    at full width: K7s against its plain version, a 2000x1000 view (K1, K9,
    K6 and K7s once a chunk), 20 steps (K1, K2, K9, K6, K6b, K7s once a
    step) with no searchsorted in the profile, a step against the plain
    versions, the bake and a 128^3 mesh export (K7s and K3); then
    balanced_sphere at the same budget (a view, steps, a step against
    plain) and the other five charts (a step against plain and one step's
    launches each).  Returns the K7s row with its launches in the view."""
    from egonerf_torch.render.export import density_grid
    from egonerf_torch.render.renderer import Renderer

    trainer = chart_trainer(root, presets, "chart_generic")
    cfg, model = trainer.cfg, trainer.model
    print(f"phase 29 generic_sphere trainer: chart resolution {trainer.coords.resolution}, "
          f"model grid {model.grid_size}, {cfg.n_coarse} samples a ray, step "
          f"{model.step_size:.5f}, mask {model.alpha_mask.grid_size}, "
          f"{trainer.sampler.buffer.shape[0]:,} training rays", flush=True)
    # 16,777,216 ** (1 / 3) is 255.99999999999991 in float64, so N_to_reso
    # gives [128, 254, 508] (n_r 127 forced even), in JAX as here
    if trainer.coords.resolution != [128, 254, 508]:
        fail(f"phase 29: generic_sphere at N_voxel {cfg.N_voxel_init} gives "
             f"{trainer.coords.resolution}, not [128, 254, 508]")
    row = sphere_kernel_checks(trainer, ops, torch.as_tensor(dirs_np, device=DEVICE),
                               presets.EVAL_CHUNK)
    per_step = ("K1", "K2", "K9", "K6", "K6b", "K7s")
    with torch.no_grad():
        view, s_image = render_phases(
            model, trainer.params, dirs_np, ops, presets, Renderer, wrappers,
            phases=("29", "29", "29"), renderer=Renderer.from_config(model, cfg,
                                                                     trainer.white_bg),
            per_chunk=dict(K1=1, K9=1, K6=1, K7s=1))
    row["launches"] = view["K7s"]
    _, median = timed_steps(trainer.train_step, f"phase 29 generic_sphere training step, "
                            f"{cfg.n_coarse} samples", cfg, wrappers,
                            {k: TRAIN_STEPS if k in per_step else 0 for k in wrappers})
    it = 10 ** 4

    def steps():
        nonlocal it
        for _ in range(PROFILE_STEPS):
            trainer.train_step(it)
            it += 1
    names = profile(steps, PROFILE_STEPS, "phase 29 generic_sphere", "step")
    # a chunk's device operations (the step's are above): K7s gives the
    # in-box mask, so neither forms the samples' points in torch
    renderer = Renderer.from_config(model, cfg, trainer.white_bg)
    dirs = torch.as_tensor(dirs_np, device=DEVICE)
    pick = torch.arange(renderer.chunk, device=DEVICE) * (dirs.shape[0] // renderer.chunk)
    chunk_rays = torch.cat([torch.zeros_like(dirs[pick]), dirs[pick]], -1)
    with torch.no_grad():
        profile(lambda: renderer.render_rays(trainer.params, chunk_rays), 1,
                "phase 29 generic_sphere", "chunk")
    found = [k for k in names if "searchsorted" in k.lower()]
    print(f"phase 29 searchsorted kernels in the steps' profile: {found or 'none'}", flush=True)
    if found or not names:
        fail("phase 29: the generic_sphere step ran searchsorted, or the profile was empty")
    step_vs_plain(trainer, ops, "phase 29 generic_sphere")
    mask = model.alpha_mask
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    trainer.update_alpha_mask()
    torch.cuda.synchronize()
    bake = {k: w.launches for k, w in wrappers.items() if w.launches}
    model.alpha_mask = mask
    print(f"phase 29 bake: {(time.time() - t0) * 1e3:.1f} ms, launches {bake}", flush=True)
    if set(bake) != {"K3", "K9"}:
        fail(f"phase 29: the bake launched {bake}, expected K3 and K9")
    for w in wrappers.values():
        w.launches = 0
    with torch.no_grad():
        alpha = density_grid(model, trainer.params, 128)
    torch.cuda.synchronize()
    export = {k: w.launches for k, w in wrappers.items() if w.launches}
    print(f"phase 29 export's density grid at 128^3: launches {export}, alpha in "
          f"[{float(alpha.min()):.4g}, {float(alpha.max()):.4g}]", flush=True)
    if export != {"K3": 16, "K7s": 16}:
        fail(f"phase 29: the export launched {export}, expected 16 of K3 and K7s")
    del trainer, alpha
    torch.cuda.empty_cache()

    bal = chart_trainer(root, presets, "chart_balanced", coordinates_name="balanced_sphere")
    print(f"phase 29 balanced_sphere trainer: chart resolution {bal.coords.resolution}, ratio "
          f"{bal.coords.ratio:.6f}, r0 {bal.coords.r0:.6g}", flush=True)
    with torch.no_grad():
        render_phases(bal.model, bal.params, dirs_np, ops, presets, Renderer, wrappers,
                      phases=("29 balanced", "29 balanced", "29 balanced"),
                      renderer=Renderer.from_config(bal.model, bal.cfg, bal.white_bg),
                      per_chunk=dict(K1=1, K9=1, K6=1))
    _, bal_ms = timed_steps(bal.train_step, f"phase 29 balanced_sphere training step, "
                            f"{bal.cfg.n_coarse} samples", bal.cfg, wrappers,
                            {k: TRAIN_STEPS if k in per_step[:5] else 0 for k in wrappers})
    print(f"phase 29 balanced_sphere step {bal_ms:.3f} ms beside generic_sphere's {median:.3f} "
          f"({bal_ms - median:+.3f}); generic view {s_image:.3f} s/image", flush=True)
    step_vs_plain(bal, ops, "phase 29 balanced_sphere")
    del bal
    torch.cuda.empty_cache()
    for name in ("sphere", "directional_sphere", "directional_balanced_sphere", "euler_sphere",
                 "cylinder"):
        other = chart_trainer(root, presets, f"chart_{name}", coordinates_name=name)
        step_vs_plain(other, ops, f"phase 29 {name}")
        for w in wrappers.values():
            w.launches = 0
        other.train_step(1)
        torch.cuda.synchronize()
        launches = {k: w.launches for k, w in wrappers.items() if w.launches}
        print(f"phase 29 {name}: chart resolution {other.coords.resolution}, model grid "
              f"{other.model.grid_size}; one step's launches {launches}", flush=True)
        if launches != {k: 1 for k in per_step[:5]}:
            fail(f"phase 29 {name}: a step launched {launches}")
        del other
        torch.cuda.empty_cache()
    return row


def shading_phase(root, presets, ops, wrappers, dirs_np) -> None:
    """Phase 30: the production EgoNeRF under each of SHADING_30 in one
    process (MLP_Fea first): a 2000x1000 view with a few chunks against the
    plain versions and its profile, 20 timed and profiled steps (device
    operations a step), a step against the plain versions; MLP_PE and MLP
    also under EGONERF_MIXED_MM (K10's launches); RGB at data_dim_color 3
    (a view, a step against plain); TensorVMSplit at phase 14's shape under
    MLP_PE, the config default (a 1000x500 view, a step against plain)."""
    from egonerf_torch.data.ray_utils import get_ray_directions_360
    from egonerf_torch.render.renderer import Renderer
    from egonerf_torch.train.config import load_config
    from egonerf_torch.train.trainer import Trainer

    runs = os.path.join(root, "build", "chip_smoke_runs")
    summary = {}
    for mode, extra in SHADING_30:
        cfg = load_config(overrides=presets.production_overrides(
            basedir=runs, expname=f"shading_{mode}", n_iters=10 ** 9, N_vis=0,
            progress_refresh_rate=10 ** 9, shadingMode=mode, **extra))
        trainer = Trainer(cfg, device=DEVICE)
        label = f"phase 30 {mode}"
        print(f"{label}: data_dim_color {cfg.data_dim_color}, shader "
              f"{sum(p.numel() for k, p in trainer.params.items() if k.startswith('shader')):,} "
              f"parameters", flush=True)
        with torch.no_grad():
            _, s_image = render_phases(trainer.model, trainer.params, dirs_np, ops, presets,
                                       Renderer, wrappers, phases=(f"30 {mode}",) * 3)
        if mode == "RGB":
            step_vs_plain(trainer, ops, label)
            summary[mode] = (s_image, None)
            del trainer
            torch.cuda.empty_cache()
            continue
        _, median = timed_steps(trainer.train_step, f"{label} training step", cfg, wrappers,
                                step_launches(wrappers, envmap=False))
        it = 10 ** 4

        def steps():
            nonlocal it
            for _ in range(PROFILE_STEPS):
                trainer.train_step(it)
                it += 1
        profile(steps, PROFILE_STEPS, label, "step")
        step_vs_plain(trainer, ops, label)
        summary[mode] = (s_image, median)
        if mode in ("MLP_PE", "MLP"):
            sw = dict(mixed=True)
            with shader_form(trainer.model, **sw):
                want = step_launches(wrappers, envmap=False)
                want.update({k: TRAIN_STEPS * n
                             for k, n in form_launches(trainer.model, sw, True).items()})
                _, mixed_ms = timed_steps(trainer.train_step, f"{label} training step under "
                                          "MIXED_MM", cfg, wrappers, want)
            print(f"{label} under MIXED_MM: {mixed_ms:.3f} ms a step against {median:.3f} "
                  f"({mixed_ms - median:+.3f})", flush=True)
        del trainer
        torch.cuda.empty_cache()
    base_s, base_ms = summary["MLP_Fea"]
    for mode, (s_image, median) in summary.items():
        step = "" if median is None else (f", step {median:.3f} ms "
                                          f"({median - base_ms:+.3f} against MLP_Fea)")
        print(f"phase 30 {mode}: view {s_image:.3f} s/image ({s_image - base_s:+.3f} against "
              f"MLP_Fea){step}", flush=True)
    tf = family_trainer(root, presets, lambda **kw: presets.tensorf_mask_overrides(
        shadingMode="MLP_PE", **kw), "tensorf_mlp_pe")
    with torch.no_grad():
        render_phases(tf.model, tf.params, get_ray_directions_360(*TF_IMAGE_HW).reshape(-1, 3),
                      ops, presets, Renderer, wrappers, phases=("30 TensorVMSplit MLP_PE",) * 3,
                      renderer=Renderer.from_config(tf.model, tf.cfg, tf.white_bg),
                      per_chunk=dict(K1=1, K9=1, K6=1), hw=TF_IMAGE_HW)
    step_vs_plain(tf, ops, "phase 30 TensorVMSplit MLP_PE")
    del tf
    torch.cuda.empty_cache()


def ply_counts(path: str) -> tuple:
    """(vertices, faces) named in a PLY's header."""
    with open(path, "rb") as f:
        head = f.read(512).split(b"end_header\n")[0].decode()
    counts = dict(line.split()[1:3] for line in head.splitlines()
                  if line.startswith("element "))
    return int(counts["vertex"]), int(counts["face"])


def export_phase(root, presets, ops, wrappers) -> None:
    """Phase 31: ``--export_mesh 1`` through the command line on phase 8's
    smoke checkpoint (the PLY, its counts and seconds); then the production
    EgoNeRF's density grid (the density tables x20, so alphas spread) at
    EXPORT_GRIDS: the device ms of the grid (K7 and K3 once each per
    chunk_rows x-rows), the host seconds of the marching tetrahedra at the
    grid's 99th percentile, and the kernels' grid against the plain
    versions' (rel <= REL_TOL of max|plain|, as K3)."""
    from egonerf_torch.__main__ import main as cli_main
    from egonerf_torch.render.export import density_grid, marching_tetrahedra, write_ply
    from egonerf_torch.train.checkpoint import latest_checkpoint

    base = os.path.join(root, "build", "chip_smoke_runs")
    logdir = os.path.join(base, "smoke")
    ckpt = latest_checkpoint(logdir)
    if ckpt is None:
        fail("phase 31: phase 8's smoke checkpoint is gone")
    argv = ["--config", os.path.join(root, SMOKE_CONFIG), "--n_iters", str(SMOKE_ITERS),
            "--vis_list", f"[{SMOKE_ITERS}]", "--N_vis", "-1", "--basedir", base,
            "--export_mesh", "1"]
    t0 = time.time()
    cli_main(argv)
    torch.cuda.synchronize()
    ply = os.path.join(logdir, "smoke.ply")
    if not os.path.exists(ply):
        fail("phase 31: --export_mesh 1 wrote no PLY")
    n_v, n_f = ply_counts(ply)
    with open(ply, "rb") as f:
        head = len(f.read(512).split(b"end_header\n")[0]) + len(b"end_header\n")
    size = os.path.getsize(ply)
    print(f"phase 31 --export_mesh 1 on {os.path.basename(ckpt)}: {ply} with {n_v:,} vertices "
          f"and {n_f:,} faces, {size:,} bytes; the command {time.time() - t0:.1f} s "
          f"(resume, export at 128^3)", flush=True)
    if size != head + 12 * n_v + 13 * n_f:
        fail(f"phase 31: the PLY holds {size} bytes, its header names {n_v} vertices and "
             f"{n_f} faces")

    model = presets.production_model(device=DEVICE)
    params = model.init_params(torch.Generator(device=DEVICE).manual_seed(SEED))
    with torch.no_grad():
        for k, p in params.items():
            if k.startswith("density_"):
                p.mul_(20.0)
    aabb = np.asarray(model.aabb, np.float32)
    with torch.no_grad():
        density_grid(model, params, EXPORT_GRIDS[0])  # warm
        for g in EXPORT_GRIDS:
            for w in wrappers.values():
                w.launches = 0
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            alpha = density_grid(model, params, g)
            end.record()
            torch.cuda.synchronize()
            launches = {k: w.launches for k, w in wrappers.items() if w.launches}
            model.ops = ops.PLAIN
            try:
                ref = density_grid(model, params, g)
            finally:
                model.ops = ops.KERNELS
            abs_err, rel_err = max_err((alpha,), (ref,))
            host = alpha.cpu().numpy()
            # random tables put a surface about every cell at JAX's level 0.005;
            # the level of the top 1% keeps the mesh to blobs around the peaks
            level = float(np.quantile(host[::4, ::4, ::4], 0.99))
            t0 = time.time()
            verts, faces = marching_tetrahedra(host, level, spacing=(aabb[1] - aabb[0]) / (g - 1),
                                               origin=aabb[0])
            march_s = time.time() - t0
            out = os.path.join(base, f"production_{g}.ply")
            write_ply(out, verts, faces)
            n_chunks = -(-g // 8)
            print(f"phase 31 production EgoNeRF density grid {g}^3: {start.elapsed_time(end):.3f} "
                  f"ms on the device (events around the call), launches {launches} (expect "
                  f"{n_chunks} of K7 and K3); vs plain max abs err {abs_err:.3e}, rel "
                  f"{rel_err:.3e} (<= {REL_TOL:.0e}); level {level:.4g} (the 99th percentile), "
                  f"{float((host >= level).mean()):.2%} of the grid at or above it; marching "
                  f"tetrahedra {march_s:.2f} s on the host: "
                  f"{len(verts):,} vertices, {len(faces):,} faces, {os.path.getsize(out):,} bytes",
                  flush=True)
            if launches != {"K3": n_chunks, "K7": n_chunks}:
                fail(f"phase 31: the density grid launched {launches}")
            if not torch.isfinite(alpha).all() or rel_err > REL_TOL:
                fail("phase 31: the density grid disagrees with the plain versions")
            if len(faces) == 0:
                fail("phase 31: the production density grid has no surface")
            del alpha, ref, host, verts, faces
    del model, params
    torch.cuda.empty_cache()


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def production_trainer(root, presets, expname, **deltas):
    from egonerf_torch.train.config import load_config
    from egonerf_torch.train.trainer import Trainer

    return Trainer(load_config(overrides=presets.production_overrides(
        basedir=os.path.join(root, "build", "chip_smoke_runs"), expname=expname,
        **{"n_iters": 10 ** 9, "N_vis": 0, "progress_refresh_rate": 10 ** 9, **deltas})),
        device=DEVICE)


def params_differ(a: dict, b: dict) -> tuple:
    """(entries that differ in any bit, max |a - b|, the largest relative
    L2 norm of a tensor's difference and its name) over two parameter
    sets."""
    n, mx, worst, worst_k = 0, 0.0, 0.0, ""
    with torch.no_grad():
        for k in a:
            x, y = a[k].detach().float(), b[k].detach().float()
            n += bits_differ([x], [y])
            mx = max(mx, float((x - y).abs().max()))
            l2 = float((x - y).norm() / y.norm().clamp_min(1e-30))
            if l2 >= worst:
                worst, worst_k = l2, k
    return n, mx, worst, worst_k


def noise_check(label, runs: dict, mses: dict = None) -> None:
    """The data-parallel run ``runs["parallel"]`` against the
    single-process ``runs["alone"]`` beside the second single-process run
    ``runs["twin"]`` (parameter dicts): the worst tensor's relative L2 norm
    of the difference, and with ``mses`` (name: the step MSEs) the largest
    relative difference of a step's MSE, each within NOISE_FACTOR times
    the twin's, or NOISE_FLOOR."""
    n_diff, max_diff, dp_l2, dp_k = params_differ(runs["parallel"], runs["alone"])
    _, _, twin_l2, twin_k = params_differ(runs["twin"], runs["alone"])
    limit = max(NOISE_FACTOR * twin_l2, NOISE_FLOOR)
    ok = dp_l2 <= limit
    line = (f"{label}: parameters against the single-process run: relative L2 {dp_l2:.3e} "
            f"(worst {dp_k}), {n_diff:,} entries differ, max |diff| {max_diff:.3e}; a second "
            f"single-process run {twin_l2:.3e} (worst {twin_k}); limit {limit:.3e}")
    if mses is not None:
        ref = np.asarray(mses["alone"])
        dp_m = float(np.max(np.abs(np.asarray(mses["parallel"]) / ref - 1)))
        twin_m = float(np.max(np.abs(np.asarray(mses["twin"]) / ref - 1)))
        m_limit = max(NOISE_FACTOR * twin_m, NOISE_FLOOR)
        ok = ok and dp_m <= m_limit
        line += (f"; step MSEs rel {dp_m:.3e} (second run {twin_m:.3e}, limit "
                 f"{m_limit:.3e})")
    print(f"{line} -> {'ok' if ok else 'MISS'}", flush=True)
    if not ok:
        fail(f"{label}: the data-parallel run left the single-process runs' spread")


def dp_phase(root, presets, wrappers, dirs_np, phase6_ms) -> None:
    """Phase 32: the production training step through the data-parallel
    path on an NCCL group of one rank beside two single-process trainers:
    two rounds of timed steps in turns, the parameters after each round
    (one rank's mean is the gradient itself, so only K2's float32 atomics,
    whose order changes from run to run, part them: ``noise_check``), one
    2000x1000 view with its chunks split over the group against the same
    view unsplit on the same weights, and the parallel step's profile."""
    import torch.distributed as dist
    from egonerf_torch.render.renderer import Renderer

    alone = production_trainer(root, presets, "dp_alone")
    twin = production_trainer(root, presets, "dp_twin")
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        dp = production_trainer(root, presets, "dp_world1")
        if dp.mesh is None or dp.mesh.world != 1 or alone.mesh is not None:
            fail("phase 32: the trainers did not take the paths asked for")
        want = step_launches(wrappers, envmap=False)
        runs = {"alone": alone, "parallel": dp, "twin": twin}
        ms = {}
        for rnd, order in ((1, ("alone", "parallel", "twin")), (2, ("twin", "parallel", "alone"))):
            for name in order:
                tr = runs[name]
                _, ms[(name, rnd)] = timed_steps(
                    tr.train_step, f"phase 32 round {rnd}, {name} training step "
                    f"({'NCCL, world size 1' if tr.mesh else 'no process group'})", tr.cfg,
                    wrappers, want)
            noise_check(f"phase 32 round {rnd}, after {rnd * (TRAIN_WARMUP + TRAIN_STEPS)} "
                        f"steps", {k: tr.params for k, tr in runs.items()})
        par = (ms[("parallel", 1)] + ms[("parallel", 2)]) / 2
        one = sum(ms[(k, r)] for k in ("alone", "twin") for r in (1, 2)) / 4
        print(f"phase 32 step: data-parallel (world size 1) {par:.3f} ms against the "
              f"single-process {one:.3f} ms in the same turns (+{par - one:.3f} ms: the "
              f"all-reduce of one flat bucket and the shard's bookkeeping); phase 6's median "
              f"{phase6_ms:.3f} ms", flush=True)
        del twin, runs
        torch.cuda.empty_cache()

        views = {}
        for name, tr in (("unsplit", alone), ("split", dp)):
            # both on the single-process trainer's weights
            r = Renderer(tr.model, chunk=presets.EVAL_CHUNK, mesh=tr.mesh, **presets.RENDER)
            r.set_directions(dirs_np)
            with torch.no_grad():
                r.render_view(alone.params, np.eye(4, dtype=np.float32))
                torch.cuda.synchronize()
                for w in wrappers.values():
                    w.launches = 0
                t0 = time.time()
                views[name] = r.render_view(alone.params, np.eye(4, dtype=np.float32))
                torch.cuda.synchronize()
            print(f"phase 32 view {IMAGE_HW[1]}x{IMAGE_HW[0]}, {name} "
                  f"({'chunks over the NCCL group' if tr.mesh else 'no group'}): "
                  f"{time.time() - t0:.3f} s; launches "
                  f"{ {k: w.launches for k, w in wrappers.items() if w.launches} }", flush=True)
        n_diff = bits_differ([views["split"][k] for k in ("rgb", "depth")],
                             [views["unsplit"][k] for k in ("rgb", "depth")])
        print(f"phase 32 view split over the group against unsplit: {n_diff} outputs differ "
              f"(bit for bit: the same chunks) -> {'ok' if n_diff == 0 else 'MISS'}",
              flush=True)
        if n_diff or not torch.isfinite(views["split"]["rgb"]).all():
            fail("phase 32: the split view differs from the unsplit one")
        it = 10 ** 5

        def steps():
            nonlocal it
            for _ in range(PROFILE_STEPS):
                dp.train_step(it)
                it += 1
        profile(steps, PROFILE_STEPS, "phase 32 data-parallel", "step", top=16)
    finally:
        dist.destroy_process_group()


def smoke_trainer(root, expname):
    from egonerf_torch.train.config import parse_cli
    from egonerf_torch.train.trainer import Trainer

    base = os.path.join(root, "build", "chip_smoke_runs")
    return Trainer(parse_cli(["--config", os.path.join(root, SMOKE_CONFIG), "--basedir", base,
                              "--expname", expname, "--N_vis", "0", "--n_iters", "1000000",
                              "--progress_refresh_rate", "1000000"]), device=DEVICE)


def gloo_worker(rank: int, port: int, out_dir: str) -> int:
    """One rank of phase 33: join a two-rank gloo group, train the smoke
    config GLOO_STEPS steps on the card through the data-parallel path,
    and write the step MSEs and the parameters to ``out_dir``."""
    import torch.distributed as dist

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from egonerf_torch.ops import pdf

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    trainer = smoke_trainer(root, "gloo")
    lo, hi = trainer.mesh.shard(trainer.cfg.batch_size)
    pdf.resample_chart.draw_form.launches = 0
    mses = [float(trainer.train_step(it)) for it in range(GLOO_STEPS)]
    torch.cuda.synchronize()
    print(f"phase 33 rank {rank}: rays [{lo}, {hi}) of each {trainer.cfg.batch_size}-ray batch, "
          f"{pdf.resample_chart.draw_form.launches} launches of K4's training instantiation "
          f"over {GLOO_STEPS} steps, last mse {mses[-1]:.6f}", flush=True)
    if torch.device(DEVICE).type == "cuda" and pdf.resample_chart.draw_form.launches != GLOO_STEPS:
        print(f"chip_smoke FAILED: phase 33 rank {rank}: K4's training instantiation did not "
              f"launch once a step", flush=True)
        return 1
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), mses=np.asarray(mses),
             **{k: p.detach().cpu().numpy() for k, p in trainer.params.items()})
    dist.destroy_process_group()
    return 0


def gloo_phase(root) -> None:
    """Phase 33: two gloo ranks on the one card train the smoke config
    (each rank half the batch, K4 drawing from the shard's first global
    ray); the ranks' parameters bit for bit, and the steps against two
    single-process runs on the same draws (``noise_check``)."""
    out_dir = os.path.join(root, "build", "chip_smoke_runs", "gloo_ranks")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    port = free_port()
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--gloo-rank", str(r),
                               str(port), out_dir]) for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=GLOO_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        fail(f"phase 33: a gloo rank did not finish in {GLOO_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        fail(f"phase 33: gloo ranks exited {[p.returncode for p in procs]}")
    ranks = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(2)]
    print(f"phase 33: two gloo ranks on the card, {GLOO_STEPS} smoke steps, "
          f"{time.time() - t0:.1f} s with their start", flush=True)
    n_diff = sum(int((ranks[0][k] != ranks[1][k]).sum()) for k in ranks[0])
    print(f"phase 33: {n_diff} entries differ between the ranks (bit for bit) -> "
          f"{'ok' if n_diff == 0 else 'MISS'}", flush=True)
    if n_diff:
        fail("phase 33: the two ranks hold different parameters")
    runs, mses = {}, {}
    for name in ("alone", "twin"):
        tr = smoke_trainer(root, f"gloo_{name}")
        mses[name] = [float(tr.train_step(it)) for it in range(GLOO_STEPS)]
        runs[name] = {k: p.detach() for k, p in tr.params.items()}
        del tr
    runs["parallel"] = {k: torch.from_numpy(ranks[0][k]).to(DEVICE) for k in runs["alone"]}
    mses["parallel"] = ranks[0]["mses"]
    noise_check(f"phase 33 two ranks after {GLOO_STEPS} steps", runs, mses)


def profile_phase(root, presets, wrappers) -> tuple:
    """Phase 34: a production trainer run of PROFILE_RUN_ITERS steps with
    ``profile_dir``; each step synchronised and timed on the host clock,
    inside and outside the window; the trace's count and kernels.  Returns
    the trace's folder and its events (``tools/profile_step.py`` reads
    them)."""
    from egonerf_torch.tools import profile_step
    from egonerf_torch.train.trainer import PROFILE_TRACE_ITERS

    out = os.path.join(root, "build", "chip_smoke_runs", "profile_trace")
    shutil.rmtree(out, ignore_errors=True)
    tr = production_trainer(root, presets, "profiled", n_iters=PROFILE_RUN_ITERS,
                            profile_dir=out)
    tr.save = lambda path, global_step: None  # the run's checkpoint is not measured here
    step, ms = tr.train_step, {}

    def timed(it):
        t = time.perf_counter()
        mse = step(it)
        torch.cuda.synchronize()
        ms[it] = (time.perf_counter() - t) * 1e3
        return mse
    tr.train_step = timed
    for w in wrappers.values():
        w.launches = 0
    t0 = time.time()
    tr.train()
    wall = time.time() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    expect_launches("phase 34", launches, {k: PROFILE_RUN_ITERS * v // TRAIN_STEPS
                                           for k, v in step_launches(wrappers, False).items()})
    with open(os.path.join(out, "traced_steps.json")) as f:
        traced = json.load(f)["steps"]
    trace = os.path.join(out, "trace.json")
    events = profile_step.load_trace(out)
    kernels = {name for name, _, _ in profile_step.device_events(events)}
    found = [k for k in PORT_KERNELS if any(k in n for n in kernels)]
    missing = [k for k in STEP_KERNELS if k not in found]
    inside = [ms[i] for i in range(16, 16 + PROFILE_TRACE_ITERS)]
    outside = [ms[i] for i in range(TRAIN_WARMUP, 16)] + \
        [ms[i] for i in range(16 + PROFILE_TRACE_ITERS, PROFILE_RUN_ITERS)]
    print(f"phase 34 profiled run: {PROFILE_RUN_ITERS} steps in {wall:.2f} s; traced_steps.json "
          f"{traced} (expect {PROFILE_TRACE_ITERS}); trace {os.path.getsize(trace) / 2**20:.1f} "
          f"MB, {len(events):,} events, {len(kernels)} device operation names; the port's kernels "
          f"in it: {found}", flush=True)
    print(f"phase 34 step ms (each synchronised, host clock): inside the window median "
          f"{float(np.median(inside)):.3f} mean {float(np.mean(inside)):.3f}; outside median "
          f"{float(np.median(outside)):.3f} mean {float(np.mean(outside)):.3f}; the window's "
          f"open, close and trace export with the run's other host work "
          f"{wall * 1e3 - sum(ms.values()):.1f} ms", flush=True)
    if traced != PROFILE_TRACE_ITERS or missing:
        fail(f"phase 34: traced {traced} steps, step kernels missing from the trace {missing}")
    return out, events


def counted(wrappers, run):
    """``run()`` with every launch count set to 0 first; (its result, the
    counts it left)."""
    for w in wrappers.values():
        w.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {k: w.launches for k, w in wrappers.items()}


def expect_launched(label: str, launches: dict, kernels) -> None:
    missing = [k for k in kernels if not launches[k]]
    print(f"{label} launches: " + ", ".join(f"{k} {launches[k]}" for k in kernels), flush=True)
    if missing:
        fail(f"{label}: {missing} never launched")


def checkpoint_test_psnrs(logdir) -> list:
    """Each test view's PSNR of a refscale run's final checkpoint, by the
    trainer's own ``evaluation()`` (no files written)."""
    from egonerf_torch.data.datasets import SyntheticEgoDataset
    from egonerf_torch.render.renderer import Renderer, evaluation
    from egonerf_torch.tools import quality_run
    from egonerf_torch.train.checkpoint import latest_checkpoint
    from egonerf_torch.train.config import load_config
    from egonerf_torch.train.trainer import _load_model

    cfg = load_config(os.path.join(logdir, "args.txt"))
    test_ds = SyntheticEgoDataset(split="test", is_stack=True, near_far=cfg.near_far,
                                  **quality_run.preset_spec("refscale")[1])
    model, _ = _load_model(cfg, latest_checkpoint(logdir), test_ds.scene_bbox,
                           test_ds.near_far, DEVICE)
    with torch.no_grad():
        return evaluation(test_ds, model, model.params(),
                          Renderer.from_config(model, cfg, test_ds.white_bg),
                          compute_extra_metrics=False, save_images=False)


def tools_phase(root, wrappers) -> None:
    """Phase 35: the quality-record tools at the production shape:
    ``quality_run``'s refscale preset through its ``_run`` (cut to
    REFSCALE_CUT_ITERS steps), then ``occ_probe`` and ``eval_bench`` on its
    checkpoint, and ``envmap_probe`` on phase 13's envmap run."""
    from egonerf_torch.tools import envmap_e2e, envmap_probe, eval_bench, occ_probe, quality_run

    card = card_line()
    base = os.path.join(root, "build", "chip_smoke_runs")
    t0 = time.time()
    rec, launches = counted(wrappers, lambda: quality_run._run(
        "refscale", device=DEVICE, basedir=base, n_iters=REFSCALE_CUT_ITERS,
        lr_decay_iters=quality_run.REFSCALE_ITERS["refscale"]))
    wall = time.time() - t0
    logdir = os.path.join(base, "refscale")
    views = checkpoint_test_psnrs(logdir)
    floor = REFSCALE_CUT_PSNR - SEED_SPREAD_DB
    psnr = rec["final_test_psnr"]
    print(f"phase 35 quality_run refscale cut to its first {rec['n_iters']} of 10000 steps "
          f"({rec['views']}, N_voxel {rec['n_voxel_final']:,}, 128 + 128 samples, batch 4096; "
          f"{card}): test PSNR {psnr:.3f} dB (the final checkpoint's views "
          f"{', '.join(f'{v:.4f}' for v in views)}), ssim {rec['metrics']['ssim']:.4f}; floor "
          f"{floor:.3f} dB = this cut run's first reading {REFSCALE_CUT_PSNR:.3f} dB - "
          f"{SEED_SPREAD_DB} dB (the JAX package's seed spread); the JAX package's full 10k "
          f"run 44.065 dB; {rec['wall_s']} s of training and evaluation, {wall:.1f} s in all",
          flush=True)
    expect_launched("phase 35 refscale run", launches,
                    ("K1", "K2", "K3", "K4", "K4+draw", "K6", "K6b", "K7"))
    if not psnr >= floor:
        fail(f"phase 35: refscale test PSNR {psnr:.3f} dB below its floor {floor:.3f}")
    if not abs(float(np.mean(views)) - psnr) <= 1e-3:
        fail(f"phase 35: the final checkpoint's views {views} do not give the run's test PSNR "
             f"{psnr:.3f} dB")

    occ, launches = counted(wrappers, lambda: occ_probe._run(logdir, OCC_BUDGETS, device=DEVICE))
    print(f"phase 35 occ_probe ({card}): {json.dumps(occ)}", flush=True)
    expect_launched("phase 35 occ_probe", launches, ("K7", "K3", "K4", "K9"))
    n_rays = 2 * IMAGE_HW[0] * IMAGE_HW[1]
    if occ["n_rays"] != n_rays or not 0.0 <= occ["occupied_sample_frac"] <= 1.0:
        fail(f"phase 35: occ_probe counted {occ['n_rays']} rays (expect {n_rays}), occupied "
             f"share {occ['occupied_sample_frac']}")

    bench, launches = counted(wrappers, lambda: eval_bench._run(
        logdir, EVAL_BENCH_KEEPS, n_repeats=1, device=DEVICE))
    for row in bench["rows"]:
        print(f"phase 35 eval_bench ({card}): {json.dumps(row)}", flush=True)
    expect_launched("phase 35 eval_bench", launches,
                    ("K1", "K3", "K4", "K6", "K7", "K4c", "K13", "K4w"))
    full = bench["rows"][0]
    print(f"phase 35 eval_bench unculled view 0: {full['psnr_vs_gt']:.3f} dB against the "
          f"trainer's {views[0]:.4f} dB (its evaluation() of the final checkpoint; within "
          f"1e-3 dB, the row rounded to 1e-3); the cull "
          f"rows are a record (JAX's cull failed its own quality bar)", flush=True)
    if full["eval_keep"] != 0 or not abs(full["psnr_vs_gt"] - views[0]) <= 1e-3:
        fail(f"phase 35: eval_bench's unculled view 0 {full['psnr_vs_gt']} dB, the trainer's "
             f"{views[0]:.4f} dB")

    env, launches = counted(wrappers, lambda: envmap_probe._run(
        os.path.join(base, "envmap_e2e"), n_train=envmap_e2e.N_TRAIN, n_test=envmap_e2e.N_TEST,
        height=envmap_e2e.IMG_H, width=envmap_e2e.IMG_W, device=DEVICE))
    print(f"phase 35 envmap_probe on phase 13's run ({card}): {json.dumps(env)}", flush=True)
    expect_launched("phase 35 envmap_probe", launches, ("K8",))
    values = [env["envmap_only_psnr_vs_gt_texture"]] + [
        v for im in env["per_image"] for v in (im["psnr_bg"], im["psnr_fg"])]
    if not np.all(np.isfinite(values)):
        fail(f"phase 35: envmap_probe gave {values}")


def measure_tools_phase(root, wrappers, trace_dir: str, events: list) -> dict:
    """Phase 36: the measurement tools at the production shape.
    ``profile_step``'s tables of phase 34's trace (every device operation
    in a family, the families summing to the window's device time) and
    ``capture_eval`` of one 2000x1000 view; ``eval_probe`` at chunk 4096 in
    its four modes; ``eval_ship`` over 2 views; ``microbench_lookup`` (each
    form against its plain version; the first caller of K15 and K16).
    Each tool's kernels counted from 0 around its run; returns
    microbench_lookup's."""
    from egonerf_torch import presets
    from egonerf_torch.tools import eval_probe, eval_ship, microbench_lookup, profile_step

    card = card_line()
    base = os.path.join(root, "build", "chip_smoke_runs")

    def accounted(label, rec, total_ms):
        fams = {r["family"]: r["ms_per_step"] for r in rec["families"]}
        print(f"phase 36 {label} ({card}): {rec['n_device_ops']:,} device operations, "
              f"{rec['ms_per_step_total']:.4f} ms a unit, 'other' {fams.get('other', 0.0):.4f} "
              f"ms ({100 * fams.get('other', 0.0) / rec['ms_per_step_total']:.2f}%), device busy "
              f"{rec['busy_share']:.2%} of the window", flush=True)
        if not abs(sum(fams.values()) - total_ms) <= 1e-6 * total_ms:
            fail(f"phase 36: the {label} families sum to {sum(fams.values())} ms, the device "
                 f"operations to {total_ms} ms")
        return fams

    rows = profile_step.summarize(trace_dir, top=16, events=events)
    step = accounted("profile_step families of phase 34's step",
                     profile_step.families(trace_dir, write=False, device=card, events=events),
                     sum(ms for _, ms, _ in rows))
    missing = [f for f in ("K1 field", "K2 field backward", "K3 density", "K4 resample",
                           "K6 composite", "K6b composite backward", "K7 chart", "shader GEMMs",
                           "Adam (multi_tensor_apply)") if not step.get(f)]
    if missing:
        fail(f"phase 36: the step's families {missing} hold no device time")

    eval_dir, launches = counted(wrappers, lambda: profile_step.capture_eval(
        n_images=1, device=DEVICE, profile_dir=os.path.join(base, "profile_eval"),
        basedir=os.path.join(base, "profile_eval_run")))
    expect_launched("phase 36 capture_eval", launches, ("K1", "K3", "K4", "K6", "K7"))
    rows = profile_step.summarize(eval_dir, top=12)
    view = accounted("profile_step families of one traced view",
                     profile_step.families(eval_dir, write=False, device=card),
                     sum(ms for _, ms, _ in rows))
    if not view.get("K1 field") or not view.get("shader GEMMs"):
        fail(f"phase 36: the view's families {sorted(view)} lack K1 or the shader GEMMs")

    probe, launches = counted(wrappers, lambda: eval_probe._run(
        chunks=(presets.EVAL_CHUNK,), reps=1, device=DEVICE,
        basedir=os.path.join(base, "eval_probe")))
    expect_launched("phase 36 eval_probe", launches, ("K1", "K3", "K4", "K6", "K7"))
    for row in probe["rows"]:
        print(f"phase 36 eval_probe ({card}): {json.dumps(row)}", flush=True)
    if [r["mode"] for r in probe["rows"]] != list(eval_probe.MODES) or not all(
            np.isfinite(r["sec_per_image"]) and r["sec_per_image"] > 0 for r in probe["rows"]):
        fail(f"phase 36: eval_probe gave {probe['rows']}")

    ship, launches = counted(wrappers, lambda: eval_ship._run(
        n_images=2, device=DEVICE, basedir=os.path.join(base, "eval_ship")))
    expect_launched("phase 36 eval_ship", launches, ("K1", "K3", "K4", "K6", "K7"))
    print(f"phase 36 eval_ship ({card}): {json.dumps(ship)}", flush=True)
    if not ship["sec_per_image_amortized"] > 0:
        fail(f"phase 36: eval_ship gave {ship}")

    bench, launches = counted(wrappers, lambda: microbench_lookup._run(device=DEVICE))
    expect_launched("phase 36 microbench_lookup", launches,
                    ("K15 plane", "K15 line", "K16", "K1", "K2", "K4"))
    if len(bench["forms"]) != 16:
        fail(f"phase 36: microbench_lookup timed {len(bench['forms'])} forms, expect 16")
    return launches


def real_launches(wrappers, envmap: bool, n_chunks: int) -> dict:
    """The launches of a ``real_data_run`` of REAL_ITERS steps and its
    REAL_TEST test views of ``n_chunks`` chunks: the steps' kernels once a
    step (as phase 21 counts them), the render's K1, K3, K4, K7 and K6 (K6e
    with the envmap) once a chunk, and with the envmap K8 once a chunk of
    the envmap's image (one ``pretrain_envmap`` render of the first view)."""
    want = {k: v // TRAIN_STEPS * REAL_ITERS for k, v in step_launches(wrappers, envmap).items()}
    for k in ("K1", "K3", "K4", "K7", "K6e" if envmap else "K6"):
        want[k] += REAL_TEST * n_chunks
    if envmap:
        want["K8"] += n_chunks
    return want


def real_data_phase(root, wrappers) -> None:
    """Phase 37: ``real_data_run`` on an OmniBlender-layout ``barbershop``
    and a Ricoh-layout ``garden`` written under ``build/``, each through
    :func:`real_data_run.run` with the run's folder and its record under
    ``build/``; then its command line on an absent scene."""
    from egonerf_torch.presets import EVAL_CHUNK
    from egonerf_torch.tools import real_data_run
    from egonerf_torch.tools.fetch_data import scene_dir
    from egonerf_torch.tools.make_egocentric_capture import make_capture

    card = card_line()
    base = os.path.join(root, "build", "chip_smoke_runs", "real")
    shutil.rmtree(base, ignore_errors=True)
    docs_before = docs_state(root)
    for scene, layout, (h, w) in REAL_SCENES:
        data = scene_dir(scene, base)
        n_frames = REAL_FRAMES[scene]
        t0 = time.time()
        if layout == "ricoh":
            make_capture(data, n_frames=n_frames, height=h, n_test=REAL_TEST)
        else:
            make_omniblender_scene(data, n_frames, REAL_TEST, (h, w))
        cfg = real_data_run.scene_config(scene, base)
        print(f"phase 37 {scene} ({os.path.relpath(real_data_run.config_for(scene), root)}): "
              f"{n_frames} frames ({REAL_TEST} test) at {w}x{h} written in "
              f"{time.time() - t0:.1f} s; cuts: {n_frames} frames, {REAL_ITERS} of the config's "
              f"{cfg.n_iters} iterations; N_voxel {cfg.N_voxel_final:,}, {cfg.n_coarse} + "
              f"{cfg.n_fine} samples, batch {cfg.batch_size}", flush=True)
        record = os.path.join(base, f"results_real_{scene}.json")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        rc, launches = counted(wrappers, lambda: real_data_run.run(
            scene, base, REAL_ITERS, device=DEVICE, results=record,
            basedir=os.path.join(base, "log", scene)))
        wall = time.time() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if rc != 0 or not os.path.exists(record):
            fail(f"phase 37: real_data_run {scene} returned {rc}, record at {record}: "
                 f"{os.path.exists(record)}")
        with open(record) as f:
            rec = json.load(f)
        with open(os.path.join(root, rec["artifacts"], "imgs_test_all", "mean.json")) as f:
            mean = json.load(f)
        psnr = rec["final_test_psnr"]
        print(f"phase 37 {scene} through real_data_run ({card}): rc {rc}, {rec['n_iters']} "
              f"iterations and {mean['n_images']} test views in {wall:.1f} s (the record's "
              f"wall_s {rec['wall_s']}, loading included; the test views' s/image on the "
              f"evaluation's 'eval total' line); peak {peak:.2f} GiB allocated; test PSNR "
              f"{psnr:.3f} dB (mean.json {mean['psnr']:.4f}, within 1e-3; a record of random "
              f"weights after {REAL_ITERS} steps); record {os.path.relpath(record, root)}",
              flush=True)
        if not (rec["metrics"] == mean and mean["n_images"] == REAL_TEST
                and rec["n_iters"] == REAL_ITERS and rec["device"] == card and np.isfinite(psnr)
                and abs(psnr - mean["psnr"]) <= 1e-3):
            fail(f"phase 37: {scene}'s record {rec} does not hold its mean.json {mean}")
        want = real_launches(wrappers, cfg.use_envmap, -(-w * h // EVAL_CHUNK))
        expect_launches(f"phase 37 {scene}", launches, want)
        print(f"phase 37 {scene} launches: " + ", ".join(
            f"{k} {v}" for k, v in launches.items() if v), flush=True)
        torch.cuda.empty_cache()

    allocated = torch.cuda.memory_allocated()
    rc, launches = counted(wrappers, lambda: real_data_run.main(
        ["bricks", "--dest", base, "--iters", str(REAL_ITERS)]))
    print(f"phase 37 absent scene {scene_dir('bricks', os.path.relpath(base, root))}: rc {rc} "
          f"(expect 3), launches {sum(launches.values())}, allocated "
          f"{torch.cuda.memory_allocated() - allocated:+d} bytes", flush=True)
    if rc != 3 or any(launches.values()) or torch.cuda.memory_allocated() != allocated:
        fail("phase 37: the absent scene did not exit 3 untouched")
    if docs_state(root) != docs_before:
        fail("phase 37 wrote into docs/torch/")


def cull_ab_phase(root, wrappers) -> None:
    """Phase 38: ``cull_ab.run`` at keep CULL_AB_KEEP with an unculled step
    every CULL_AB_EVERY, on the production model at ``sampler_ab``'s shape
    cut to CULL_AB_ITERS steps (an evaluation every CULL_AB_VIS), its run's
    folder and its record under ``build/``."""
    from egonerf_torch.tools import cull_ab, sampler_ab

    card = card_line()
    base = os.path.join(root, "build", "chip_smoke_runs", "cull_ab")
    shutil.rmtree(base, ignore_errors=True)
    docs_before = docs_state(root)
    vis = list(range(CULL_AB_VIS, CULL_AB_ITERS + 1, CULL_AB_VIS))
    t0 = time.time()
    rec, launches = counted(wrappers, lambda: cull_ab.run(
        [CULL_AB_KEEP], full_every=CULL_AB_EVERY, device=DEVICE, basedir=base,
        n_iters=CULL_AB_ITERS, vis_list=str(vis)))
    wall = time.time() - t0
    record = os.path.join(base, f"results_{cull_ab.record_name(full_every=CULL_AB_EVERY)}.json")
    with open(record, "w") as f:
        json.dump(rec, f, indent=1)
    n_full = sum(1 for it in range(CULL_AB_ITERS) if it % CULL_AB_EVERY == 0)
    want = {"K4c+draw": CULL_AB_ITERS - n_full, "K13": CULL_AB_ITERS - n_full,
            "K4+draw": n_full, "K2": CULL_AB_ITERS, "K6b": CULL_AB_ITERS}
    got = {k: launches[k] for k in want}
    runs = rec["runs"]
    curve = runs[0]["psnr_by_iter"] if len(runs) == 1 else {}
    print(f"phase 38 cull_ab keep {CULL_AB_KEEP}, full step every {CULL_AB_EVERY} "
          f"({sampler_ab.N_TRAIN}+{sampler_ab.N_TEST} views at {sampler_ab.IMG_W}x"
          f"{sampler_ab.IMG_H}, N_voxel 27,000,000, 128 + 128 samples, batch 4096; {card}): "
          f"{CULL_AB_ITERS} of {sampler_ab.N_ITERS} steps in {wall:.1f} s (the run's wall_s "
          f"{runs[0]['wall_s'] if runs else None}); test PSNR by step {curve} (random weights "
          f"after {CULL_AB_ITERS} steps: a record); record {os.path.relpath(record, root)}",
          flush=True)
    print("phase 38 launches: " + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
          + "; expected " + ", ".join(f"{k} {v}" for k, v in want.items()), flush=True)
    if got != want:
        fail(f"phase 38: launches {got}, expected {want}")
    if not (len(runs) == 1 and runs[0]["variant"] == f"tk{CULL_AB_KEEP}fe{CULL_AB_EVERY}_wall"
            and runs[0]["train_keep"] == CULL_AB_KEEP
            and runs[0]["train_keep_full_every"] == CULL_AB_EVERY
            and runs[0]["train_cull_tau"] == 0.0 and rec["train_keep_full_every"] == CULL_AB_EVERY
            and rec["scene"] == "wall" and rec["device"] == card):
        fail(f"phase 38: the record {rec} is not the run asked for")
    if sorted(curve) != vis or not all(np.isfinite(v) and v > 0 for v in curve.values()):
        fail(f"phase 38: PSNR by step {curve}, expected finite values at steps {vis}")
    if docs_state(root) != docs_before:
        fail("phase 38 wrote into docs/torch/")


def upstream_checkpoint(model, params, masks, coordinates, global_step: int) -> dict:
    """The port's EgoNeRF as the upstream repository saves it: ``kwargs``
    with the live chart, the per-chart ``(1, C, H, W)`` planes and ``(1, C,
    L, 1)`` lines, the ``nn.Linear`` basis and shader, the envmap ``(3, 2h,
    h)`` and the bit-packed yin and yang masks."""
    cfg = model.cfg
    sd = {}
    for i in range(3):
        for name in ("density", "app"):
            for s, chart in enumerate(("yin", "yang")):
                plane, line = params[f"{name}_planes.{i}"][s], params[f"{name}_lines.{i}"][s]
                sd[f"{name}_plane_{chart}.{i}"] = plane.permute(2, 0, 1)[None]
                sd[f"{name}_line_{chart}.{i}"] = line.T[None, :, :, None]
    for s, chart in enumerate(("yin", "yang")):
        sd[f"basis_mat_{chart}.weight"] = params["basis"][s].T
    for idx, key in zip((0, 2, 4), ("l1", "l2", "l3")):
        for part in ("weight", "bias"):
            sd[f"renderModule.mlp.{idx}.{part}"] = params[f"shader.{key}.{part}"]
    emission = params["envmap"].permute(2, 0, 1)
    sd["envmap.emission"] = emission
    ckpt = {"kwargs": {"aabb": torch.tensor(model.aabb), "gridSize": list(model.grid_size),
                       "density_n_comp": list(cfg.density_n_comp),
                       "appearance_n_comp": list(cfg.app_n_comp), "app_dim": cfg.app_dim,
                       "density_shift": cfg.density_shift,
                       "alphaMask_thres": cfg.alpha_mask_thres,
                       "distance_scale": cfg.distance_scale,
                       "rayMarch_weight_thres": cfg.ray_march_weight_thres,
                       "fea2denseAct": cfg.fea2dense_act, "near_far": list(model.near_far),
                       "step_ratio": cfg.step_ratio, "shadingMode": cfg.shading_mode,
                       "pos_pe": cfg.pos_pe, "view_pe": cfg.view_pe, "fea_pe": cfg.fea_pe,
                       "featureC": cfg.feature_c, "coordinates": coordinates,
                       "use_envmap": cfg.use_envmap},
            "state_dict": {k: v.detach().cpu().contiguous() for k, v in sd.items()},
            "global_step": global_step,
            "envmap.emission": emission.detach().cpu().numpy(),
            "envmap_res_H": cfg.envmap_res_h}
    for vol, chart in zip(masks, ("yin", "yang")):
        ckpt[f"alphaMask_{chart}.shape"] = vol.shape
        ckpt[f"alphaMask_{chart}.mask"] = np.packbits(vol.reshape(-1))
    return ckpt


def reference_ckpt_phase(root, wrappers) -> None:
    """Phase 39: an upstream ``.th`` of the outdoor production model through
    ``import_reference_ckpt.main`` and ``load_jax_checkpoint`` on the card:
    the arrays, the masks and a 2000x1000 view bit for bit with the
    source's, the view's launches, the file's size, the seconds and the
    peak memory."""
    import contextlib
    import io

    from egonerf_torch import presets
    from egonerf_torch.coords import make_coordinates
    from egonerf_torch.data.datasets import SyntheticEgoDataset
    from egonerf_torch.data.ray_utils import get_ray_directions_360
    from egonerf_torch.models import build_model, load_jax_checkpoint, model_meta
    from egonerf_torch.models.alphamask import mask_from_volumes
    from egonerf_torch.render.renderer import Renderer
    from egonerf_torch.tools import import_reference_ckpt
    from egonerf_torch.train.config import load_config

    card = card_line()
    dev = torch.device(DEVICE)
    base = os.path.join(root, "build", "chip_smoke_runs", "reference")
    shutil.rmtree(base, ignore_errors=True)
    checkout = os.path.join(base, "checkout")
    os.makedirs(os.path.join(checkout, "models"))
    with open(os.path.join(checkout, "models", "__init__.py"), "w") as f:
        f.write('"""Stand-in of the upstream EgoNeRF models package."""\n')
    with open(os.path.join(checkout, "models", "coordinates.py"), "w") as f:
        f.write(UPSTREAM_COORDINATES)

    # the outdoor trainer's model (phase 1): its config, scene box, chart and seed
    cfg = load_config(overrides=presets.outdoor_overrides(
        basedir=os.path.join(root, "build", "chip_smoke_runs"), expname="reference"))
    aabb = SyntheticEgoDataset(split="train", **dict(ENV_SCENE, near_far=cfg.near_far)).scene_bbox
    coords = make_coordinates(cfg.coordinates_name, aabb, exp_r=cfg.exp_sampling,
                              N_voxel=cfg.N_voxel_init, r0=cfg.r0, interval_th=cfg.interval_th)
    model = build_model(cfg, aabb, coords.resolution, coords, cfg.near_far, device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED))
    # a pair of seeded volumes at the grid, (z, y, x) as the bake lays them out
    rng = np.random.default_rng(SEED)
    vols = [rng.random(model.grid_size[::-1]) < 0.5 for _ in range(2)]
    model.alpha_mask = mask_from_volumes(vols, dev)

    th = os.path.join(base, "outdoor.th")
    npz = os.path.join(base, "outdoor.npz")
    sys.path.insert(0, checkout)
    try:
        from models.coordinates import YinYangSphericalCoords as RefCoords

        ref_coords = RefCoords("cpu", torch.tensor(model.aabb), exp_r=coords.exp_r,
                               N_voxel=cfg.N_voxel_init, r0=coords.r0,
                               interval_th=coords.interval_th)
        torch.save(upstream_checkpoint(model, params, vols, ref_coords, UPSTREAM_STEP), th)
    finally:
        sys.path.remove(checkout)
        # the tool imports the checkout afresh, as a new process would
        for name in [k for k in sys.modules if k == "models" or k.startswith("models.")]:
            del sys.modules[name]
    th_mb = os.path.getsize(th) / 1e6

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        import_reference_ckpt.main([th, npz, f"--reference={checkout}"])
    convert_s = time.time() - t0
    line = out.getvalue().strip()
    loaded, lparams, header = load_jax_checkpoint(npz, near_far=cfg.near_far, device=DEVICE)
    torch.cuda.synchronize()
    load_s = time.time() - t0 - convert_s
    print(f"phase 39 import_reference_ckpt ({card}): {os.path.relpath(th, root)} "
          f"{th_mb:.1f} MB (grid {model.grid_size}, envmap "
          f"{tuple(params['envmap'].shape)}, masks {vols[0].shape} x 2) converted in "
          f"{convert_s:.2f} s to {os.path.getsize(npz) / 1e6:.1f} MB, loaded on the card in "
          f"{load_s:.2f} s, peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
          f"allocated; printed {line}", flush=True)
    info = json.loads(line)
    if not (info == {"out": npz, "global_step": UPSTREAM_STEP,
                     "resolution": list(model.grid_size), "use_envmap": True,
                     "alpha_masks": True}
            and header["global_step"] == UPSTREAM_STEP
            and header["coords_spec"] == coords.to_spec()
            and header["model_meta"] == model_meta(None, model)):
        fail(f"phase 39: the conversion printed {info}, header {header}")
    differ = sorted(set(params) ^ set(lparams)) + [
        k for k in params if k in lparams and not (params[k].dtype == lparams[k].dtype
                                                    and torch.equal(params[k], lparams[k]))]
    if differ or not torch.equal(model.alpha_mask.vol, loaded.alpha_mask.vol):
        fail(f"phase 39: arrays {differ} (or the masks) differ from the source's")
    print(f"phase 39 arrays: {len(params)} parameters "
          f"({sum(p.numel() for p in params.values()):,} floats) and the yin and yang masks "
          f"({2 * vols[0].size:,} bits) bit for bit with the source's", flush=True)

    renders, launches = {}, {}
    dirs = get_ray_directions_360(*IMAGE_HW).reshape(-1, 3)
    n_chunks = -(-dirs.shape[0] // presets.EVAL_CHUNK)
    c2w = np.eye(4, dtype=np.float32)[:3]
    with torch.no_grad():
        for label, m, p in (("source", model, params), ("imported", loaded, lparams)):
            renderer = Renderer(m, chunk=presets.EVAL_CHUNK, **presets.RENDER)
            renderer.set_directions(dirs)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            renders[label], launches[label] = counted(wrappers,
                                                      lambda: renderer.render_view(p, c2w))
            s_image = time.time() - t0
            print(f"phase 39 {label} view {IMAGE_HW[1]}x{IMAGE_HW[0]} ({card}): "
                  f"{s_image:.3f} s/image, peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
                  f"GiB allocated", flush=True)
    want = {k: n_chunks if k in ("K1", "K3", "K4", "K6e", "K7") else 0 for k in wrappers}
    print("phase 39 imported view launches: " + ", ".join(
        f"{k} {v}" for k, v in launches["imported"].items() if v), flush=True)
    expect_launches("phase 39 imported view", launches["imported"], want)
    src, imp = renders["source"], renders["imported"]
    same = {k: torch.equal(src[k], imp[k]) for k in ("rgb", "depth", "bg")}
    finite = all(bool(torch.isfinite(src[k]).all()) for k in same)
    print(f"phase 39 the imported view against the source's: {same}; rgb mean "
          f"{float(imp['rgb'].mean()):.6f}", flush=True)
    if not (all(same.values()) and finite and tuple(imp["rgb"].shape) == (dirs.shape[0], 3)):
        fail("phase 39: the imported model's view is not the source's bit for bit")


def kernel_wrappers() -> dict:
    """Each kernel's wrapper (or form) by its name in the kernel line: the
    objects whose ``launches`` count the launches."""
    from egonerf_torch.ops import (alphamask, bias, chart, cp, cull, envmap, grid_sample, merge,
                                   mm, pdf, sampler, vm_lookup, volrend)

    wrappers = {"K1": vm_lookup.field_fwd, "K2": vm_lookup.field_bwd,
                "K3": vm_lookup.density_fwd, "K4": pdf.resample,
                "K4+draw": pdf.resample_chart.draw_form, "K5": merge.sorted_uniform,
                "K6": volrend.composite, "K6e": volrend.composite.envmap_form,
                "K6+env": volrend.composite.env_form, "K6b": volrend.composite_bwd,
                "K7": chart.chart_fwd, "K7s": chart.chart_sphere_fwd,
                "K8": envmap.envmap_fwd, "K8b": envmap.envmap_bwd, "K9": alphamask.alpha_fwd,
                "K10": mm.mixed_mm, "K10da": mm.mixed_mm_da, "K10db": mm.mixed_mm_db,
                "K11": bias.bias_grad, "K4w": pdf.resample_weights,
                "K12": cull.coarse_importance, "K4c": pdf.resample_score,
                "K4c+draw": pdf.resample_score.draw_form, "K13": cull.select_top_k,
                "K14": sampler.theta_ids, "K14f": sampler.theta_batch,
                "K15 plane": vm_lookup.sample_plane_nograd,
                "K15 line": vm_lookup.sample_line_nograd, "K16": grid_sample.sample_line,
                # the training instantiations of the losses, each also counted
                # in its kernel's own count (K6, K6e or K6+env; K6b; K3; K2)
                "K6 alpha": volrend.composite.alpha_form,
                "K6b alpha": volrend.composite_bwd.alpha_form,
                "K3 train": vm_lookup.density_fwd.train_form,
                "K2 dens": vm_lookup.field_bwd.density_form,
                # TensorVM's relu-free instantiations (also in K1, K3, K2),
                # TensorCP's line product and its forms (also in K17, K17b)
                "K1 norelu": vm_lookup.field_fwd.norelu_form,
                "K3 norelu": vm_lookup.density_fwd.norelu_form,
                "K2 norelu": vm_lookup.field_bwd.norelu_form,
                "K17": cp.cp_fwd, "K17b": cp.cp_bwd,
                **{f"K17 ({form}, {mode})": w for (form, mode), w in cp.cp_fwd.forms.items()},
                **{f"K17b ({mode})" if form == "train" else f"K17b ({form}, {mode})": w
                   for (form, mode), w in cp.cp_bwd.forms.items()},
                # lines past the staging limit (counted in K17, K17b too)
                "K17 (unstaged)": cp.cp_fwd.unstaged, "K17b (unstaged)": cp.cp_bwd.unstaged}
    return wrappers


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    t_start = time.time()
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from egonerf_torch import _build, ops, presets
    from egonerf_torch.data.ray_utils import get_ray_directions_360
    from egonerf_torch.models.egonerf import _dists
    from egonerf_torch.data.datasets import SyntheticEgoDataset
    from egonerf_torch.models.alphamask import AlphaGridMask
    from egonerf_torch.ops import (alphamask, bias, chart, cp, cull, envmap, grid_sample, merge,
                                   mm, pdf, sampler, vm_lookup, volrend)
    from egonerf_torch.render.renderer import Renderer
    from egonerf_torch.train.config import load_config
    from egonerf_torch.train.trainer import Trainer

    dev = torch.device(DEVICE)
    wrappers = kernel_wrappers()

    # -- phase 1: card + build ----------------------------------------------
    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.time()
    libs = _build.build_all()
    print(f"phase 1 build: {len(libs)} libraries ({', '.join(sorted(libs))}) "
          f"in {time.time() - t0:.1f} s", flush=True)
    for stem in sorted(libs):
        for name, regs, spill in _build.ptxas_report(stem):
            print(f"phase 1 ptxas {stem}: {regs} registers, {spill} bytes spilled: {name}",
                  flush=True)
            if (stem in ("vm_lookup", "resample", "cull")
                    or (stem == "mixed_mm" and "mm_rows_kernel" in name)) and spill:
                fail(f"{name} spills {spill} bytes")

    model = presets.production_model(device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED))
    print(f"model: grid {model.grid_size}, "
          f"{sum(p.numel() for p in params.values()):,} parameters", flush=True)
    dirs_np = get_ray_directions_360(*IMAGE_HW).reshape(-1, 3)
    trainer = production_trainer(root, presets, "production")
    print(f"trainer: synthetic scene, {trainer.sampler.buffer.shape[0]:,} training rays "
          f"resident, grid {trainer.model.grid_size}", flush=True)
    outdoor = Trainer(load_config(overrides=presets.outdoor_overrides(
        basedir=os.path.join(root, "build", "chip_smoke_runs"), expname="outdoor",
        n_iters=10 ** 9, N_vis=0, progress_refresh_rate=10 ** 9)), device=dev)
    scene = dict(ENV_SCENE, near_far=outdoor.cfg.near_far)
    outdoor.set_datasets(SyntheticEgoDataset(split="train", **scene),
                         SyntheticEgoDataset(split="test", is_stack=True, **scene))
    print(f"outdoor trainer ({os.path.relpath(presets.OUTDOOR_CONFIG, root)}): near/far "
          f"{outdoor.cfg.near_far}, r0 {outdoor.cfg.r0}, grid {outdoor.model.grid_size}, "
          f"envmap {tuple(outdoor.params['envmap'].shape)}; synthetic scene with its "
          f"background at infinity, {outdoor.sampler.buffer.shape[0]:,} training rays",
          flush=True)

    # the TensoRF shape with random weights and a 128^3 mask of half occupancy
    tf = Trainer(load_config(overrides=presets.tensorf_mask_overrides(
        basedir=os.path.join(root, "build", "chip_smoke_runs"), expname="tensorf_step",
        n_iters=10 ** 9, progress_refresh_rate=10 ** 9)), device=dev)
    tf_scene = dict(presets.TENSORF_BENCH_SCENE, near_far=tf.cfg.near_far)
    tf.set_datasets(SyntheticEgoDataset(split="train", **tf_scene),
                    SyntheticEgoDataset(split="test", is_stack=True, **tf_scene))
    tf.model.alpha_mask = AlphaGridMask(half_mask(TF_MASK_RESO, dev), device=dev)
    print(f"TensoRF trainer ({tf.cfg.model_name}, {tf.cfg.coordinates_name} chart): grid "
          f"{tf.model.grid_size}, step {tf.model.step_size:.5f}, mask "
          f"{tf.model.alpha_mask.grid_size}, {tf.sampler.buffer.shape[0]:,} training rays",
          flush=True)
    # TensorCP at its published width (CP-384) on the same scene and mask
    cp_tf = family_trainer(root, presets, presets.tensorcp_overrides, "tensorcp")
    print(f"TensorCP trainer: grid {cp_tf.model.grid_size}, lines "
          f"{[tuple(cp_tf.params[f'density_lines.{i}'].shape) for i in range(3)]} + "
          f"{[tuple(cp_tf.params[f'app_lines.{i}'].shape) for i in range(3)]}", flush=True)

    # -- phase 2: each kernel against its plain version ------------------------
    with torch.no_grad():
        rows = render_kernel_checks(model, params, torch.as_tensor(dirs_np, device=dev), ops,
                                    presets, _dists)
    rows.update(train_kernel_checks(trainer, ops))
    rows.update(cull_kernel_checks(model, params, torch.as_tensor(dirs_np, device=dev), ops,
                                   presets, trainer))
    form_rows = shader_kernel_checks(trainer, ops)
    width_checks(ops)
    rows.update(envmap_kernel_checks(outdoor, ops))
    k6b_sweep(ops)
    tf_rows = tensorf_kernel_checks(tf, ops)
    cp_rows = cp_kernel_checks(cp_tf, ops)
    k2_stage_checks(root, ops)
    loss_rows = loss_kernel_checks(trainer, outdoor, tf, ops)
    capture_rows = theta_kernel_checks(ops)
    capture_rows.update(nograd_kernel_checks(ops))

    # -- phases 3-5: the render -------------------------------------------------
    with torch.no_grad():
        render_launches, render_s = render_phases(model, params, dirs_np, ops, presets,
                                                  Renderer, wrappers)
        # -- phases 3c-5c: the culled view at each eval_keep ----------------------
        cull_launches = cull_render_phases(model, params, dirs_np, ops, presets, wrappers,
                                           render_s)
    del model, params
    # -- phases 6-7: the training step ------------------------------------------
    train_launches, train_ms = train_phases(trainer, ops, wrappers)
    # -- phases 6c-7c: culled training steps --------------------------------------
    cull_step_launches = cull_train_phases(trainer, ops, wrappers, train_ms)
    # -- phase 7b: the shader and line forms on the production trainer ---------
    forms = form_phases("7b", trainer, ops, Renderer(trainer.model, chunk=presets.EVAL_CHUNK,
                                                      **presets.RENDER),
                        dirs_np, dict(K1=1, K3=1, K4=1, K6=1, K7=1), wrappers,
                        step_launches(wrappers, envmap=False), FORMS)
    # K10's and K11's rows report their launches over the combined form's steps
    for k, w in (("K10 fwd", "K10"), ("K10 da", "K10da"), ("K10 db", "K10db"), ("K11", "K11")):
        form_rows[k]["launches"] = forms[COMBINED[0]][2][w]
    del trainer
    torch.cuda.empty_cache()

    # -- phase 8: the smoke run through the command line, and under the forms ---
    smoke_psnr = quality_phase(root)
    cull_quality_phase(root, smoke_psnr)
    combined_quality_phase(root, smoke_psnr, wrappers)
    variant_quality_phase(root)

    # -- phases 9-11: the outdoor shape: render, envmap training --------------
    with torch.no_grad():
        env_render, _ = render_phases(outdoor.model, outdoor.params, dirs_np, ops, presets,
                                      Renderer, wrappers, phases=(9, 9, 9))
    env_pretrain, env_train = envmap_train_phases(outdoor, ops, wrappers)
    del outdoor
    torch.cuda.empty_cache()
    # the render path's kernels report their launches per image, the
    # training kernels theirs over the timed steps; the envmap rows those of
    # the outdoor shape: K6e its view's, K8 the pretrain steps' (the outdoor
    # view and steps launch none), K6 with a given env its count over the
    # view, the pretrain and the training steps (none: only TensorVMSplit's
    # envmap form takes it)
    for k, row in rows.items():
        if k == "K6e":
            row["launches"] = env_render["K6e"]
        elif k == "K8":
            row["launches"] = env_pretrain["K8"]
        elif k == "K6+env":
            row["launches"] = env_render[k] + env_pretrain[k] + env_train[k]
        elif k in ("K8b", "K6b+env"):
            row["launches"] = env_train[k.split("+")[0]]
        elif k in ("K4c", "K4w", "K12", "K13"):
            # the cull's kernels: their launches in the culled view (phase 3c;
            # 0 for K4w and K12, which the cull path no longer launches)
            row["launches"] = cull_launches[k]
        elif k == "K4c+draw":
            # K4c's training instantiation: its launches in the culled steps
            # (phase 6c, the tie-break)
            row["launches"] = cull_step_launches[k]
        else:
            row["launches"] = render_launches[k] if render_launches[k] else train_launches[k]

    # -- phases 12-13: the outdoor config's command line, envmap quality -------
    outdoor_cli_phase(root, presets)
    envmap_quality_phase(root)

    # -- phases 14-15: the TensoRF view and its chunks against plain -----------
    with torch.no_grad():
        render_phases(tf.model, tf.params, get_ray_directions_360(*TF_IMAGE_HW).reshape(-1, 3),
                      ops, presets, Renderer, wrappers, phases=(14, 15, 14),
                      renderer=Renderer.from_config(tf.model, tf.cfg, tf.white_bg),
                      per_chunk=dict(K1=1, K9=1, K6=1), hw=TF_IMAGE_HW)
    # -- phase 15b: TensoRF's view chunks and steps under the shader forms ----
    form_phases("15b", tf, ops, Renderer.from_config(tf.model, tf.cfg, tf.white_bg),
                get_ray_directions_360(*TF_IMAGE_HW).reshape(-1, 3), dict(K1=1, K9=1, K6=1),
                wrappers, {k: TRAIN_STEPS if k in ("K1", "K2", "K9", "K6", "K6b") else 0
                           for k in wrappers}, TF_FORMS)
    del tf
    torch.cuda.empty_cache()
    # -- phases 16-18: the tensorf_bench recipe and its steps, the quality recipe
    tf_steps, tf_bake = tensorf_bench_phases(root, presets, ops, wrappers)
    torch.cuda.empty_cache()
    for k, row in tf_rows.items():
        row["launches"] = tf_bake["K3"] if k.startswith("K3") else tf_steps[k.split()[0]]
    tensorf_quality_phase(root)

    # -- phases 19-21: the captured-data path ------------------------------------
    egocentric_e2e_phase(root, wrappers)
    torch.cuda.empty_cache()
    capture_rows["K14f"]["launches"] = ricoh_phase(root, wrappers)
    torch.cuda.empty_cache()
    omniblender_phase(root, wrappers)
    torch.cuda.empty_cache()

    # -- phases 23-24: linear sampling and grid upsampling at production width --
    linear_rows = linear_phase(root, presets, ops, wrappers, dirs_np)
    torch.cuda.empty_cache()
    upsample_phase(root, presets, ops, wrappers, exp=True)
    torch.cuda.empty_cache()
    upsample_phase(root, presets, ops, wrappers, exp=False)
    torch.cuda.empty_cache()

    # -- phase 25: the entropy, sparsity and depth losses at full width --------
    for k, n in losses_phase(root, presets, ops, wrappers).items():
        loss_rows[k]["launches"] = n

    # -- phases 26-28: TensorVM, TensorCP, NDC rays and filter_ray ------------
    base = family_trainer(root, presets, presets.tensorf_mask_overrides, "tensorf_base")
    _, base_ms = timed_steps(
        base.train_step, "phase 26 TensorVMSplit training step (beside TensorVM and TensorCP)",
        base.cfg, wrappers, {k: TRAIN_STEPS if k in ("K1", "K2", "K9", "K6", "K6b") else 0
                             for k in wrappers})
    del base
    vm = family_trainer(root, presets, lambda **kw: presets.tensorf_mask_overrides(
        model_name="TensorVM", **kw), "tensorvm")
    vm_out = family_phase(26, vm, ops, wrappers, presets, Renderer,
                          ("K1", "K2", "K9", "K6", "K6b", "K1 norelu", "K2 norelu"),
                          {"K1": 1, "K1 norelu": 1, "K9": 1, "K6": 1}, ("K3", "K3 norelu", "K9"),
                          base_ms)
    del vm
    torch.cuda.empty_cache()
    cp_out = family_phase(27, cp_tf, ops, wrappers, presets, Renderer,
                          ("K17", "K17 (train, hat)", "K17b", "K17b (hat)", "K9", "K6", "K6b"),
                          {"K17": 1, "K17 (eval, hat)": 1, "K9": 1, "K6": 1},
                          ("K17", "K17 (density, hat)", "K9"), base_ms)
    del cp_tf
    torch.cuda.empty_cache()
    ndc_filter_phase(root, presets, ops, wrappers)
    # -- phases 29-31: the other charts, the shading modes, mesh export ------
    k7s_row = chart_phase(root, presets, ops, wrappers, dirs_np)
    torch.cuda.empty_cache()
    shading_phase(root, presets, ops, wrappers, dirs_np)
    torch.cuda.empty_cache()
    export_phase(root, presets, ops, wrappers)
    torch.cuda.empty_cache()
    # the relu-free rows: their launches in TensorVM's steps and bake; each
    # K17 and K17b row its own counter's (form and line mode) over TensorCP's
    # steps, view and bake
    for k, (part, counter) in {"K1 (S=1, no relu)": ("steps", "K1 norelu"),
                               "K2 (S=1, no relu)": ("steps", "K2 norelu"),
                               "K3 (S=1, no relu)": ("bake", "K3 norelu")}.items():
        tf_rows[k]["launches"] = vm_out[part][counter]
    for k, row in cp_rows.items():
        row["launches"] = sum(cp_out[part][k] for part in ("steps", "view", "bake"))

    # -- phases 32-34: data parallelism and the profiler hook -----------------
    dp_phase(root, presets, wrappers, dirs_np, train_ms)
    torch.cuda.empty_cache()
    gloo_phase(root)
    torch.cuda.empty_cache()
    trace_dir, events = profile_phase(root, presets, wrappers)
    torch.cuda.empty_cache()
    # -- phase 35: the quality-record tools ------------------------------------
    tools_phase(root, wrappers)
    torch.cuda.empty_cache()
    # -- phase 36: the measurement tools; K15's and K16's launches are
    # microbench_lookup's (each row its wrapper's count, S = 2 and 1 alike)
    bench = measure_tools_phase(root, wrappers, trace_dir, events)
    del events
    torch.cuda.empty_cache()
    for k in ("K15 plane", "K15 line", "K16"):
        for row in (capture_rows[k], capture_rows[f"{k} (S=1)"]):
            row["launches"] = bench[k]
    # -- phase 37: the real-data pipeline on scenes in the loaders' layouts ----
    real_data_phase(root, wrappers)
    torch.cuda.empty_cache()
    # -- phase 38: the train-time cull quality A/B -----------------------------
    cull_ab_phase(root, wrappers)
    torch.cuda.empty_cache()
    # -- phase 39: an upstream checkpoint through the import tool ------------
    reference_ckpt_phase(root, wrappers)

    print(json.dumps({"kernels": [rows[k] for k in ("K1", "K2", "K3", "K4", "K4+draw", "K5",
                                                     "K6", "K6b", "K6e", "K6+env", "K6b+env",
                                                     "K7", "K8", "K8b", "K4w", "K12", "K4c",
                                                     "K4c+draw", "K13")]
                      + [linear_rows[k] for k in ("K7 (linear r)", "K4 (linear r)")]
                      + [tf_rows[k] for k in ("K1 (S=1)", "K2 (S=1)", "K3 (S=1)", "K6 gated",
                                              "K6b gated", "K9")]
                      + [form_rows[k] for k in ("K10 fwd", "K10 da", "K10 db", "K11")]
                      + [capture_rows[k] for k in ("K14", "K14f", "K15 plane", "K15 plane (S=1)",
                                                   "K15 line", "K15 line (S=1)", "K16",
                                                   "K16 (S=1)")]
                      + [loss_rows[k] for k in ("K6 alpha", "K6e alpha", "K6 gated alpha",
                                                "K6b alpha", "K6b+env alpha", "K6b gated alpha",
                                                "K3 train", "K3 train (S=1)", "K2 (n_app=0)",
                                                "K2 (n_app=0) (S=1)", "K14f (10 floats)")]
                      + [tf_rows[k] for k in ("K1 (S=1, no relu)", "K2 (S=1, no relu)",
                                              "K3 (S=1, no relu)")]
                      + list(cp_rows.values()) + [k7s_row]}),
          flush=True)
    print(f"chip_smoke: {time.time() - t_start:.1f} s", flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gloo-rank"]:
        sys.exit(gloo_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
