#!/usr/bin/env python3
"""Smoke run of svgir_tpu_torch on one CUDA card (Hopper, sm_90a).

    python3 chip_smoke.py            # all phases, from the repository root
    python3 chip_smoke.py --profile DIR   # also write torch.profiler
                                          # tables of stage-1, stage-2 and
                                          # S = 64 steps and a bake to DIR
    python3 chip_smoke.py --parent DIR    # also time the blend, B2, B7's
                                          # backward, B8 and B9 kernels of
                                          # another checkout DIR
                                          # (its own wrappers, built there)
                                          # in turns beside this tree's;
                                          # repeatable
    python3 chip_smoke.py --recipe-tables RUN [--profile DIR]
                                          # only the kernels at the
                                          # recipe's scale, on the newest
                                          # checkpoints of a
                                          # cli.full_schedule run in RUN

Phases (any failure ends the run with a non-zero exit and no result line):
  1. build    compile csrc/*.cu with nvcc (in parallel) and load them
              (launch_floor.cu is an empty kernel, timed in 6);
              print the card's name and power limit, and the registers,
              stack and spills of every blend instantiation (ptxas -v).
  2. render   the bench scene (800x800 camera, 50,000 surfels on a ball
              shell, rotation_init="normal", OptimizationConfig defaults;
              data from a seeded torch.Generator) rendered forward only
              (render_view_stage1, the eval path) at the default instance
              cap; launch counts reset just before and read just after.
              Its padded instance count sizes the cap of the later phases
              as bench.py does (x1.05, rounded up to 2048).
  3. train    five steps of train_stage1 on the bench scene; loss, Adam
              moments and parameters finite, no binner overflow; launch
              counts reset just before and read just after.
  4. kernels  each kernel against its plain PyTorch version on the card, on
              the exact inputs the train step gives it (captured from one
              step of the bench scene), plus a vertex-channel case (CV > 0,
              multi-chunk tiles, weight-sum cotangent present) on a smaller
              scene.  B1/B2 must be equal integer for integer; B3/B4 within
              the tolerances below.  B1 also on the bench scene at tile 16
              (2,500 tiles) and on the synthetic rects of the CPU tests
              (tests/torch_kernel_inputs.py: full-grid, empty, inverted,
              edge-ending and out-of-grid rects, one chunk, tile 16 on a
              non-square grid) and on grids past one block's shared memory
              (256 x 256, counted in bands of tile rows; 60,000 x 3, in
              bands of a row's columns).  B2 also at tile 16 and on the
              edge cases of the CPU tests (instance_inputs: a chunk whose
              256 rects all cover one tile, one of empty and inverted
              rects, a last chunk ending in padding, m past and below
              total_raw, a 50 x 50 grid, the two wide grids, walked in
              bands) and on the synthetic rects clipped to their grids.
              B3/B4 also on the blend's edge
              inputs of the CPU tests (a tile with no chunk, one that
              saturates in its first chunk, padding rows among real ones,
              alpha clamped at 0.99, u and v past their clamps; CA/CV
              14/0, 13/13, 16/16 and 3/4) at every tile the wrappers take
              (32, 24, 16 and 8), and on the near-clamp inputs
              (blend_near_clamp_inputs: pixels that take pairs with alpha
              just below 0.99), where B3 is held to its plain version in
              float64 as at the recipe's size (35).
  5. parity   the small scene rendered forward and backward on the card
              (kernels) and on the CPU (plain versions): image and
              gradients agree.
  6. timing   median times of the render and the train step (at the snug
              and at the default cap), of each kernel, its plain version
              and, for B1, a bincount + cumsums yardstick of its whole
              function (counts and carry; the counts-only one beside it).
              Every kernel row, here and in 11, 16 and 23, has its per-call
              ms (CUDA events around each Python call: host time
              included) and its device_ms (torch.profiler's durations of
              the device operations over 20 back-to-back calls), and so
              has its library yardstick.  The blend rows add the kernel
              each launch takes (registers, spills, blocks per SM) and,
              with --parent, the other tree's kernels timed in turns
              beside them; the work
              counts give the warp visits of each warp patch (the shuffle
              model of the backward).  B1 is timed on the 256 x 256 grid
              with its yardstick; with --parent, B2 in turns with the
              other tree's.  The launch floor: an empty kernel's device
              time (one block of 32 threads, and B2's grid), beside the
              bounds below it (launch_floor_device_ms in every row).
  Stage 2 (the deferred-PBR mode, bench_stage2.py's configuration: the
  bench scene upgrade_to_pbr'd, a synthetic radiance bake with S = 24
  incident samples per surfel made from a seeded generator, a 32x64 env):
  7. s2 render   render_view_svgss(is_training=False) at the snug cap:
                 finite images, no overflow; B7 forward and B3 launched.
  8. s2 train    five steps of make_svgss_train_step: finite loss, moments
                 and parameters (env included), a nonzero env gradient, no
                 overflow; B7 forward and backward, B3 and B4 launched at
                 least once per step.
  9. s2 kernels  B7 forward/backward and B3/B4 at CA 13 / CV 13 against
                 their plain versions on the inputs of one stage-2 step,
                 B3 at CA 16 / CV 16 on the eval render's inputs; B7's
                 forward also on both of the eval render's lookups and on
                 the edge cases of the CPU tests (envs 16x32 and 32x64, M
                 37, 1,027 and 20,003, and each one shorter and not
                 16-byte aligned), the backward too; the backward on a
                 64x128 env (one copy of d_env a block); forward and
                 backward on envs past one block's shared memory (128x256,
                 256x512: read in place, gradient summed in slices).
                 Then one stage-2 step with a 128x256 env
                 (train.py --env_resolution 128): finite, the env
                 gradient nonzero, B7 against its plain version on it.
  10. s2 parity  a small stage-2 scene rendered and stepped on the card and
                 on the CPU, with a 16x32 and a 128x256 env: images, loss
                 and gradients agree.
  11. s2 timing  stage-2 train step and eval render medians; B7 with its
                 plain version, bound and grid_sample yardstick (the
                 forward also on each eval lookup, and both on the env-128
                 step); B3/B4 at stage-2 width; with --parent, B7's
                 backward on both steps' cotangents in turns with the other
                 tree's (the two held within TOL_ENV_BWD).
  The radiance bake that starts stage 2 (the bench scene upgraded to PBR,
  S = 64 samples per surfel and a 32x64 env as the recipe's --sample_num 64
  --env_resolution 32 (script/run_tensoir.sh), k_hits 16; the
  configuration's default env is 16x32, and H = 128 only
  direct_light_map_init's default argument):
  12. bake+train train_stage2(bake=None) for three steps: the bake over
                 the 50k surfels (grid march on B8), then the steps; launch
                 counts reset just before and read just after; B8 and the
                 step's kernels launched; exhausted share, bake seconds,
                 finite loss, moments and parameters; one S = 64 step's
                 time and peak memory; B7 forward and backward on that
                 step's 3.2M lookups against their plain versions and
                 timed (with grid_sample, bound and launches; with
                 --parent, the backward in turns with the other tree's).
                 The bench surfels face outward, so
                 no ray of this bake hits a front face: the same surfels
                 turned inward are baked too (bake_radiance, S = 64, k 16;
                 most rays hit and lists fill), with one S = 64 step on
                 that bake.
  13. march      B8 against its plain version (march_plain) on the first
                 ray chunk (65,536 rays) of each of those bakes and on a
                 small bake's rays (3,000 surfels facing inward), also at
                 k 8, 32, 64 and 128 on 8,192 of them: idx equal and t
                 equal on every slot, or within the stated count.
  14. oracle     the grid march through B8 (nearest_hits_grid) against the
                 brute tracer (nearest_hits) on the 4,096 rays with the
                 most hits of each of those ray sets.
  15. bake parity a small bake on the card (B8) against the CPU's plain
                 path.
  16. bake timing a second, warm bake (seconds, launches per bake) and a
                 warm inward bake; B8's ms per launch on both first chunks
                 with its plain version and its bound, counted from the
                 visits each chunk's data needs; the brute and the grid
                 bake at 3,000 and 6,000 surfels (either side of the
                 switch at 4,096); with --parent, B8 on both first chunks
                 in turns with the other tree's (held hit for hit).
  The tile-major paths (RasterConfig(strip=0), train.py --strip 0, and the
  sort binner, binner="sort") with B5/B6 (csrc/blend_forward.cu,
  csrc/blend_backward.cu, tile-major entries) and the column copies B9:
  17. strip0 train  five train_stage1 steps with strip=0 at the snug cap:
                 finite, no overflow; B5/B6 launched every step, B3/B4
                 never; launch counts reset just before and read just after.
  18. strip0 kernels B5/B6 against their plain versions on one strip-0
                 step's inputs, and against B3/B4 on the same inputs: B5's
                 output assembled to image layout equals B3's image within
                 TOL_IMG with eff equal, B6's rows B4's within TOL_ROWS,
                 and bit-equal to them; also on the blend's edge inputs.
  19. strip0 s2  five stage-2 steps (S = 24) and an eval render at strip 0;
                 B5/B6 at CA 13 / CV 13 and B5 at 16 / 16 checked as in 18.
  20. sort       render_view_stage1 with the sort binner at the snug cap:
                 B5 launched, B1-B4 not; its integers on the card equal the
                 CPU's on the same preprocess outputs and the counting
                 binner's layout; the image equals the counting render.
  21. small      the small scene forward and backward on both tile-major
                 branches, card against CPU, and against the port's dense
                 oracle render_dense on the card.
  22. cols       B9 (pad_cols / slice_cols) against F.pad and the slice
                 copy, bitwise, at M = the cap rounded up to 1024, stage-1
                 KR -> 128 -> KR; the slice also at kout 1, 127 and 13, at
                 M = 1024 and on an input off 8-byte alignment.  B9 has no
                 caller on any path.
  23. timing     strip-0 against strip-8 stage-1 steps in turns, the
                 renders (counting strip 8 / strip 0, sort) and the stage-2
                 step and eval render at both; B5/B6/B9 per launch with
                 their plain versions, bounds and (B9) F.pad / slice copy;
                 with --parent, B9 in turns with the other tree's.

  Densification and the training CLI (the trainer's entry point):
  24. densify    the bench scene at init_from_points' default capacity
                 (65,536 rows for its 50,000 surfels), 40 train_stage1
                 steps at the snug instance cap (auto-grow on) that densify
                 every 5 from 5 (percent_dense 0.01: clones and splits) and
                 reset opacity every 20: each cadence's alive count equals
                 what its report implies; clones, splits, prunes and a
                 capacity doubling happen; each reset clamps opacity to
                 0.01 with zero moments; params, moments and losses finite;
                 B1-B4 launched on every step.  densify_and_prune on the
                 card against the CPU on the first cadence's state with the
                 same noise (masks and counts equal, values within
                 TOL_DENSIFY), and its time with a stage-1 step's at 65,536
                 and 131,072 rows with the same surfels alive.
  25. cli        a Blender-layout scene written to a temporary directory (8
                 RGBA 800x800 training frames and 2 test frames rendered
                 on the card, no point cloud), then python -m
                 svgir_tpu_torch.cli.train's main: stage 1 for 60
                 iterations from the 100,000 bootstrap points in morton
                 order, densify every 10 from 10, opacity reset at 60,
                 checkpoints at 30 and 60, the snug cap probe
                 (--max_instances 0), --eval (the two test views rendered
                 and scored at the end); the same run resumed from
                 chkpnt30.npz (Adam step equal; alive count, loss and the
                 norms of each parameter group and its second moment
                 within TOL_RESUME_*); stage 2 from chkpnt60.npz for 3
                 iterations at --sample_num 64 --env_resolution 32 with
                 --eval, and --finetune_visibility (1,000 iterations) in
                 another stage-2 run from 6,000 of its surfels; then
                 python -m
                 svgir_tpu_torch.cli.eval_relighting on the stage-2
                 checkpoint with two HDRs written with OpenCV at
                 --sample_num 384 (one metrics.json a light, pbr_psnr
                 finite, pbr_lpips a number or the note).  Output files,
                 finite logs, kernel launches (B8 in the bakes), and the
                 seconds of scene load, probe, loop, checkpoint write and
                 read, bake, the fine-tuning and the relighting.

  Relighting and the visibility tracers (stage 2's evaluation):
  26. relight    the bench surfels facing inward (their hemisphere rays
                 hit), upgraded to PBR with random base colour and
                 roughness; two HDR lights written with OpenCV (512x1024
                 sky with a sun, uniform 64x128) through load_hdr and
                 env_light_init; eval_relighting over four 800x800 views
                 at S = 384 (the bake once, 293 B8 chunks at k 16, then
                 irradiance_full a light), with the albedo calibration on
                 a synthetic GT albedo over each view's covered pixels;
                 launch counts reset just before and read just after
                 (B1, B2, B3, B7's forward and B8 launched, no backward).
                 Checks: pairs with a hit, finite non-zero radiances, the
                 same view different under the two lights, the summaries
                 written.  B7's forward on the EnvLight lookup (N x 384
                 queries, 32x64 map), B8 on the bake's first chunk and B3
                 on the relit render (its n_contrib flips held to what one
                 pair at alpha 1/255 moves) against their plain versions,
                 timed with bound (and grid_sample for B7); the B3 work
                 of this render and of the stage-2 eval render logged.
                 Card against CPU on a 2,048-surfel patch at S = 32:
                 irradiance_full within
                 TOL_IRR, the relit 128x128 crop within TOL_S2_IMG.
  27. visibility finetune_visibility for 10 iterations on the same surfels
                 (the grid tracer), each iteration's trace timed; on 4,096
                 of its rays the grid against its own acceptance tested
                 densely (within TOL_VIS on rays clear of the 0.9 cut) and
                 against the brute tracer (the rays that differ counted:
                 different functions by design); the grid on the card
                 against the CPU on 2,048 rays.

  The evaluation and viewing commands (on phase 25's scene and
  checkpoints: chkpnt60.npz of stage 1, chkpnt63.npz and point_cloud.ply
  of stage 2, about 94,000 surfels), render_sh and the stand-in harness:
  28. nvs        python -m svgir_tpu_torch.cli.eval_nvs's main four times
                 at the cap probed over the scene's views: chkpnt60 at the
                 default --eval_scale 4 (200x200) and at 1 (800x800),
                 chkpnt63 with -t render_relight --skip_train, and a copy of
                 it without its bake (the CLI bakes once at k 16, B8);
                 each metrics.json finite and equal to the printed JSON, no
                 overflow, B1-B3 launched in each run, B7's forward in the
                 stage-2 runs, B8 only in the one that bakes ([nvs] lines:
                 ms a view, the bake's seconds).
  29. relighting cli.relighting on a config directory that composes
                 point_cloud.ply twice (the identity; turned 2.8 rad about y
                 to face the frames, scaled 0.8, moved 2.5) with the first
                 12 frames of
                 configs/example/ (800x800, a light rotation each), under
                 both HDRs, capturing pbr_env, normal and roughness; then
                 the PLY alone in orbit form with --rotate_light (8 frames at
                 512): the composition twice the surfels with its second
                 half apply_transform's, one bake a run, every frame PNG,
                 the mp4s written or skipped with the message, B1-B3, B7's
                 forward and B8 launched; normal_eval of the normal frames
                 against themselves (MAE below MAE_SELF_TOL); gui
                 --headless on chkpnt63 for 4 frames at 512 ([relighting]
                 lines: the bake, ms a frame, the video).
  30. render_sh  render_sh_image on the bench surfels facing inward at
                 800x800: the grid tracer on 640,000 camera rays in chunks
                 of 65,536; B8 against march_plain slot for slot on the
                 first chunk (the top rows: no ray hits) and on the chunk
                 whose rays hit most; the image against the brute tracer
                 on the 4,096 rays nearest its centre (hits equal, render
                 within TOL_RENDER_SH); B8 on both chunks timed with its
                 bound.
  31. standin    eval/standin.run_standin_parity on the card at
                 tests/test_e2e_parity.py's pipeline configuration (its
                 thresholds must hold) and at its medium one (its five
                 numbers beside the thresholds and the JAX package's CPU
                 numbers: a finding, not a gate); launches of the stage-2
                 kernels.

  The parallel paths (svgir_tpu_torch/parallel/, torch.distributed; the
  card's machine has one card):
  32. parallel   world size 1 on NCCL: make_dp_train_step on the bench
                 scene against make_train_step (bit-equal where the single
                 step is bit-stable between two runs, else held to
                 TOL_PAR_MOMENT and lr); make_dp_svgss_train_step at
                 S = 64 on the main path's bake (phase 12) against
                 make_svgss_train_step; rasterize_sharded (all-gather, the
                 exchange at the cap the partition needs, balanced rows)
                 forward and backward against rasterize at strip 0 (B5/B6)
                 with check_image's tolerances, the gradients within
                 TOL_PAR_GRAD; each timed (steps in turns with the single
                 step); the row imbalance, equal-area against balanced, and
                 the bytes a rank receives in a forward (all-gather against
                 exchange) at 2, 4 and 8 ranks; bake_radiance_sharded on
                 the 50,000 inward surfels at S = 8 (brute, k 8) against
                 the grid bake (B8) on the same draws, timed.  Launches of
                 each path are counted and checked.
  33. two ranks  two processes on the one card over gloo (NCCL refuses two
                 ranks on one device): the DP stage-1 step over two views
                 (the replicas bit-equal, against Adam on the mean of the
                 two views' gradients) and rasterize_sharded over uneven
                 balanced bands, both variants, forward and backward
                 against phase 32's single-device render; ms of each path
                 (two ranks sharing one card: correctness, not scaling) and
                 the bytes a rank receives.

  The recipe (the reference's two-stage schedule through the commands a
  user runs):
  34. recipe     python -m svgir_tpu_torch.cli.make_synth_dataset's main
                 at full width and fewer views (800x800, 20,000 GT
                 surfels, S = 24, 6 + 2 views), then cli.full_schedule's
                 main on that scene: 700 stage-1 iterations (the
                 densification passes at 600 and 700 run), 30 stage-2
                 iterations at S = 64 with their bake, eval_nvs of both
                 stages (and of stage 1's test views at scale 1 beside
                 the default scale 4).  Checks: every file written, losses and PSNRs
                 finite, no binner overflow in either log, the last
                 densification pass leaves more surfels alive than the
                 first, each part's launches (B1-B4 every stage-1 step,
                 B1-B4 and B7 every stage-2 step, B8 in the bake, no B5,
                 B6 or B9).  A [recipe] line: each part's seconds and
                 peak memory, ms a step, the alive counts and the passes,
                 the bake's grid, exhausted share and seconds, the PSNRs.
  35. recipe size (run after 11, where torch.profiler keeps its device
                 records) the bench generator at the recipe's size:
                 264,865 surfels in 524,288 rows, binned as the recipe
                 bins (strip 8, counting binner, snug cap); one stage-1
                 step and one S = 64 step on a synthetic bake of every
                 row with a 32 x 64 env, each with launch counts reset
                 just before and read just after.  B1/B2 equal to their
                 plain versions; B3 within TOL_IMG and 1e-5 of its plain
                 version evaluated in float64 (the float32 plain version
                 drifts past that there: PERF.md), its n_contrib flips
                 within check_image's flip rule; B4 within TOL_ROWS; B7's
                 forward within TOL_ENV_FWD and its backward within
                 TOL_ENV_BWD of its plain version (a float64 sum).
                 [split] lines: every pixel or texel where a float32
                 version and float64 part, with its class.  Rows
                 ``*_recipe_size`` with each step's ms and peak memory.

With --recipe-tables RUN the script builds the kernels and runs only the
recipe's tables (``recipe_tables``): B1-B4 on a step of RUN's stage-1
checkpoint, B1-B4 and B7 on an S = 64 step of its newest stage-2
checkpoint, B8 on the fullest chunk of a bake of that checkpoint's
surfels, each against its plain version (B3's image against its plain
version in float64, as in phase 35, with [split] lines) and timed with
its bound; the steps' ms and peak memory, the bake's; with --profile
DIR, the profiles
of three steps of each stage and of the bake; and ``[recipe-scale]``:
the stage-1 checkpoint's test PSNR at eval_nvs's scale 4, at scale 1,
pooled from scale 1, and at scale 4 with the screen-space dilation cut
to its scale-1 size.  A row's ``launches`` counts this run's one step
(or bake) of the row; ``recipe_run_launches`` the schedule's, from RUN's
schedule.json.  A disagreement with a plain version is logged, named
in the row's ``disagrees`` and fails the run after the tables.  That
mode ends with the kernels JSON and the card's line, and without the
result line: it runs none of the phases.

The output ends with three lines: the kernels JSON, the nvidia-smi line
(the card's name and power limit), and {"ok": true, "device": {...}}.
Each kernel row of the JSON also carries ``parallel_launches`` and
``recipe_launches``: its launches on each path of phases 32-33 and in
each part of phase 34 (the rows of phase 35 too).
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time

# B3/B4 tolerances (kernel vs plain, same inputs, same device).  The kernel
# sums in another order (sequential per pixel, shuffle trees over pixels),
# so channel sums and row reductions differ by float32 rounding; the
# reconstructed transmittance of saturated pixels may cross the 1e-4 gate
# at another instance (ROADMAP C-7), so logT is held to 1e-4 there.
TOL_IMG = 1e-4          # absolute, plus 1e-4 relative, on channel sums
TOL_LOGT_SAT = 1e-4     # absolute, saturated pixels
TOL_ROWS = 1e-3         # of each row kind's largest magnitude (d_slab)

# B7 tolerances: the forward rounds every product and sum as the plain
# version does (exact in principle, 1e-6 absolute allowed); the backward
# sums each block's queries with shared-memory atomics in a varying order.
TOL_ENV_FWD = 1e-6      # absolute
TOL_ENV_BWD = 1e-5      # of the largest |d_env|
# Stage-2 parity, card vs CPU: the vertex channels are divided by the
# opacity and pass through sRGB, which amplifies float32 rounding
# (tests/test_torch_svgss.py); gradients as the CPU tests hold them.
TOL_S2_IMG = 2e-4       # absolute; direct/indirect twice that
TOL_S2_DEPTH = 5e-4     # relative
TOL_S2_GRAD = 2.5e-3    # of each gradient's largest magnitude

STAGE1_KERNELS = ("binning_counts", "binning_instances", "blend_forward",
                  "blend_backward")
STAGE2_KERNELS = STAGE1_KERNELS + ("env_lookup_forward",
                                   "env_lookup_backward")

# B8 against its plain version: both round every operation of the surfel
# test in the same order, so they should agree hit for hit; a slot may
# differ only where expf and torch's exp part at an alpha threshold.
MARCH_SLOT_TOL = 1e-4   # share of a chunk's finite slots that may differ
# The small bake, card against CPU: the geometry (quaternion rotations,
# incident directions) differs by float32 rounding between the devices.
BAKE_HIT_TOL = 1e-3     # share of rays that may differ
BAKE_VAL_TOL = 1e-4     # absolute, radiance / visibility / uv

HBM_BYTES_S = 3.35e12   # H100 SXM device memory rate
FP32_OPS_S = 67e12      # H100 SXM float32 (and integer ALU) rate, non-tensor


def log(*a):
    print(*a, flush=True)


def kernel_inputs():
    """``tests/torch_kernel_inputs.py`` (numpy only), loaded by its path: a
    ``tests`` package installed elsewhere may shadow the repository's."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "torch_kernel_inputs.py")
    spec = importlib.util.spec_from_file_location("torch_kernel_inputs", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps=10, warmup=2) -> float:
    """Median device time of fn() in ms (CUDA events around each call)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def device_ms(fn, reps=20):
    """Device time of one fn() in ms, from the card's own clock: the
    durations torch.profiler records for the device operations (kernels,
    memsets, copies) of ``reps`` back-to-back calls, without the host time
    of each call (argument checks, allocation, launch).  Returns (ms,
    device operations per call, share of those launches the profiler
    recorded).

    On the H100 machine the profiler drops some device records, more as a
    run goes on (up to 19 of 20 launches of one kernel late in a run), so
    each operation is counted by name: its mean duration over the records
    it has, times its launches per call (its records over ``reps``,
    rounded up: right while fewer than ``reps`` of its records are lost).
    The window is padded on both sides so that records near its edges are
    kept."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):        # a window may lose all of its records
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
        try:
            return device_by_name(prof, reps)[:3]
        except AssertionError:
            if attempt == 2:
                raise
            log(f"[timing] the profiler recorded no device operation of "
                f"{reps} calls; profiling again")


def device_by_name(prof, reps):
    """(ms, operations, share recorded, {name: ms}) per call of a
    profiled window of ``reps`` calls, each device operation counted by
    name as ``device_ms`` says."""
    import math

    from torch.autograd import DeviceType
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and \
                not getattr(e, "is_user_annotation", False):
            n_us = by_name.setdefault(e.name, [0, 0.0])
            n_us[0] += 1
            n_us[1] += e.time_range.elapsed_us()
    if not by_name:
        raise AssertionError("torch.profiler recorded no device operation")
    per_call = {k: math.ceil(n / reps) for k, (n, _) in by_name.items()}
    op_ms = {k: us / n * per_call[k] / 1e3 for k, (n, us) in by_name.items()}
    ops = sum(per_call.values())
    return (sum(op_ms.values()), ops,
            sum(n for n, _ in by_name.values()) / (ops * reps), op_ms)


def timings(kfn, pfn, lfn=None, *, reps=20, plain_reps=3):
    """The timing keys of a kernels-JSON entry: the wrapper's per-call
    ``ms`` (events around each call) and its ``device_ms``, the plain
    version's per-call ms, and the library call's per-call and device ms
    (None without one)."""
    dms, nk, rec = device_ms(kfn, reps=reps)
    out = {"ms": cuda_ms(kfn, reps=reps), "device_ms": dms,
           "device_ops": nk, "profiler_recorded": rec,
           "plain_ms": cuda_ms(pfn, reps=plain_reps, warmup=1),
           "library_ms": None, "library_device_ms": None}
    if lfn is not None:
        out["library_ms"] = cuda_ms(lfn, reps=reps)
        out["library_device_ms"] = device_ms(lfn, reps=reps)[0]
    return out


def fmt_times(t, lib_name=""):
    return (f"{t['ms']:.4f} ms per call, {t['device_ms']:.4f} ms on the "
            f"device ({t['device_ops']} device ops per call, "
            f"{t['profiler_recorded']:.2f} of them recorded; plain "
            f"{t['plain_ms']:.3f} ms"
            + (f"; {lib_name} {t['library_ms']:.4f} ms per call, "
               f"{t['library_device_ms']:.4f} ms on the device"
               if t["library_ms"] is not None else "") + ")")


def in_turns(old, new):
    """Another tree's kernel call ``old`` and this tree's ``new``, timed in
    turns (old, new, new, old): on the device and per call."""
    dev = [device_ms(f)[0] for f in (old, new, new, old)]
    call = [cuda_ms(f, reps=20) for f in (old, new, new, old)]
    return {"parent_device_ms": (dev[0] + dev[3]) / 2,
            "device_ms": (dev[1] + dev[2]) / 2,
            "parent_ms": (call[0] + call[3]) / 2,
            "ms": (call[1] + call[2]) / 2, "device_turns": dev,
            "call_turns": call}


def log_turns(o, what, card):
    log(f"[parent] {what}: device {o['device_ms']:.4f} ms (parent "
        f"{o['parent_device_ms']:.4f}), per call {o['ms']:.4f} ms (parent "
        f"{o['parent_ms']:.4f}); in turns parent/this/this/parent: device "
        + "/".join(f"{x:.4f}" for x in o["device_turns"]) + ", per call "
        + "/".join(f"{x:.4f}" for x in o["call_turns"]) + f"; card: {card}")


def launch_floor(blocks=1, threads=32):
    """One launch of the empty kernel of ``csrc/launch_floor.cu`` on
    ``blocks`` x ``threads``: what any launch costs on the card."""
    import ctypes

    import torch

    from svgir_tpu_torch.kernels import build
    fn = build.entry("launch_floor", "svgir_empty",
                     (ctypes.c_int, ctypes.c_int, ctypes.c_void_p))
    s = torch.cuda.current_stream().cuda_stream

    def launch():
        build.check(fn(blocks, threads, s), "svgir_empty")
    return launch


def host_ms(fn, reps=10, warmup=2) -> float:
    """Median wall time of fn() in ms, each call ended by a synchronize."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bench_scene(device, n=50_000, res=800, seed=0, inward=False, capacity=0):
    """The scene of bench.py, with its random draws from torch; with
    ``inward`` the same surfels face the ball's centre (bake rays then
    meet front faces across the shell).  ``capacity`` 0 is ``n`` rows,
    None ``init_from_points``' default."""
    import torch

    from svgir_tpu_torch.cameras import look_at_camera
    from svgir_tpu_torch.models import gaussians as G
    from svgir_tpu_torch.utils.transforms import normalize

    g = torch.Generator(device=device).manual_seed(seed)
    dirs = normalize(torch.randn(n, 3, generator=g, device=device))
    r = 0.7 + 0.3 * torch.rand(n, 1, generator=g, device=device)
    cols = torch.rand(n, 3, generator=g, device=device)
    gt = torch.rand(3, res, res, generator=g, device=device)
    state = G.init_from_points(dirs * r, cols,
                               normals=-dirs if inward else dirs,
                               capacity=n if capacity == 0 else capacity,
                               rotation_init="normal", device=device)
    cam = look_at_camera(eye=[0.5, 0.4, -2.6], target=[0, 0, 0],
                         up=[0, -1, 0], fovx=math.pi / 3, fovy=math.pi / 3,
                         width=res, height=res, device=device)
    import dataclasses
    cam = dataclasses.replace(cam, image=gt,
                              image_mask=torch.ones(1, res, res,
                                                    device=device))
    return state, cam


def small_scene(device, n=6000, res=128, seed=1):
    """Surfels facing a close camera, with 3 plain features and 8 vertex
    features (CV = 2): tiles hold several chunks and saturate."""
    import torch

    from svgir_tpu_torch.cameras import look_at_camera
    from svgir_tpu_torch.utils.transforms import normal_to_rotation, normalize

    g = torch.Generator().manual_seed(seed)
    dirs = normalize(torch.randn(n, 3, generator=g))
    sc = dict(means=dirs.clone(), quats=normal_to_rotation(dirs),
              scales=torch.exp(torch.randn(n, 3, generator=g) * 0.3) * 0.12,
              opacity=0.2 + 0.6 * torch.rand(n, generator=g),
              colors=torch.rand(n, 3, generator=g),
              features=torch.rand(n, 3, generator=g),
              vfeatures=torch.rand(n, 8, generator=g))
    sc = {k: v.to(device) for k, v in sc.items()}
    cam = look_at_camera(eye=[0.3, 0.2, -1.8], target=[0, 0, 0],
                         up=[0, -1, 0], fovx=math.pi / 3, fovy=math.pi / 3,
                         width=res, height=res, device=device)
    return sc, cam


class Capture:
    """Records the arguments of the first call of each kernel entry point
    (ops functions looked up at call time)."""

    def __init__(self):
        from svgir_tpu_torch.ops import (binning, blend_pallas,
                                         blend_pallas_strip,
                                         env_lookup_pallas, rasterizer)
        # (module, function, key in ``calls``)
        self.targets = [
            (binning, "compute_counts", "compute_counts"),
            (binning, "compute_instances", "compute_instances"),
            (blend_pallas_strip, "blend_forward", "blend_forward"),
            (blend_pallas_strip, "blend_backward", "blend_backward"),
            (blend_pallas, "blend_forward", "blend_forward_tiles"),
            (blend_pallas, "blend_backward", "blend_backward_tiles"),
            (rasterizer, "bin_instances", "bin_instances"),
            (env_lookup_pallas, "env_lookup_forward", "env_lookup_forward"),
            (env_lookup_pallas, "env_lookup_backward",
             "env_lookup_backward")]
        self.calls = {}
        self.every = {}         # key -> the arguments of every call

    def __enter__(self):
        self.saved = []
        for mod, name, key in self.targets:
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))

            def rec(*a, _fn=fn, _key=key, **kw):
                self.calls.setdefault(_key, (a, kw))
                self.every.setdefault(_key, []).append((a, kw))
                return _fn(*a, **kw)
            setattr(mod, name, rec)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def loss_small(bufs, tgt):
    return ((bufs.color - tgt).abs().mean() + bufs.depth.mean()
            + 0.3 * bufs.normal.sum() + 0.2 * bufs.feature.sum()
            + 0.1 * bufs.vfeature.sum() + 0.05 * bufs.opacity.mean()
            + 1e-3 * bufs.weights.sum())


def run_small(sc, cam, device, cfg=None):
    """Forward + backward of the small scene; returns (bufs, grads)."""
    import torch

    from svgir_tpu_torch.config import RasterConfig
    from svgir_tpu_torch.ops.rasterizer import rasterize

    cfg = cfg or RasterConfig(max_instances=1 << 18)
    args = {k: v.detach().clone().requires_grad_(True) for k, v in sc.items()}
    bg = torch.tensor([0.2, 0.1, 0.4], device=device)
    tgt = torch.rand(3, cam.height, cam.width,
                     generator=torch.Generator().manual_seed(5)).to(device)
    bufs = rasterize(args["means"], args["scales"], args["quats"],
                     args["opacity"], cam, bg, colors=args["colors"],
                     features=args["features"], vfeatures=args["vfeatures"],
                     cfg=cfg)
    grads = torch.autograd.grad(loss_small(bufs, tgt), list(args.values()))
    return bufs, dict(zip(args, grads))


def max_err_rel(a, b):
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-6)


def compare_counts(a, kw, label):
    """B1 kernel vs plain on the rects ``a``: counts and carry equal
    integer for integer."""
    import torch

    from svgir_tpu_torch.kernels import binning as K
    from svgir_tpu_torch.ops import binning_pallas as P

    kk = dict(grid_x=kw["grid_x"], grid_y=kw["grid_y"],
              gauss_chunk=kw.get("gauss_chunk", 256))
    kc, kcar = K.counts(*a, **kk)
    pc, pcar = P.counts_plain(*a, **kk)
    torch.cuda.synchronize()
    if not (torch.equal(kc, pc) and torch.equal(kcar, pcar)):
        bad = int((kc != pc).sum() + (kcar != pcar).sum())
        raise AssertionError(f"B1 [{label}] counts kernel disagrees with its "
                             f"plain version at {bad} entries")
    return f"{label}: {kcar.shape[0]} chunks x {kc.numel()} tiles"


def compare_instances(a, kw, label, kernel=None):
    """B2 kernel (this tree's, or ``kernel``) vs plain on the arguments
    ``a``, ``kw``: slot and gid equal integer for integer."""
    import torch

    from svgir_tpu_torch.kernels import binning as K
    from svgir_tpu_torch.ops import binning_pallas as P

    ks, kg = (kernel or K.instances)(*a, **kw)
    ps, pg = P.instances_plain(*a, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(ks, ps) and torch.equal(kg, pg)):
        bad = int((ks != ps).sum() + (kg != pg).sum())
        raise AssertionError(f"B2 [{label}] instances kernel disagrees with "
                             f"its plain version at {bad} entries")
    return (f"{label}: {int(a[7])} instances of {kw['m']} slots, "
            f"{a[6].shape[0]} chunks x {a[6].shape[1]} tiles")


def instance_case(inp, dev):
    """B2's arguments on ``dev`` from a dict of
    ``tests/torch_kernel_inputs.instances_from_rects``."""
    import torch
    a = [torch.from_numpy(inp[k]).to(dev) for k in (
        "x0", "y0", "x1", "y1", "offsets", "order", "table")]
    a.append(torch.tensor(inp["total_raw"], dtype=torch.int32, device=dev))
    return a, dict(m=inp["m"], grid_x=inp["grid_x"], gauss_chunk=256)


def compare_binning(calls):
    """B1, B2 kernel vs plain on the captured inputs: integer equality."""
    compare_counts(*calls["compute_counts"], "captured")
    compare_instances(*calls["compute_instances"], "captured")


def compare_blend(calls, label, hdr=False, exact=False):
    """B3, B4 kernel vs plain on the captured inputs; returns max errors.
    (The captured logT image is a saved autograd output: no_grad keeps the
    plain versions from recording a graph on it.)  ``hdr``: a render whose
    features are lit by an HDR light (``check_image``'s ``feature_max``).
    ``exact`` (the recipe's size): B3's image is held to its plain version
    evaluated in float64 (``blend_float64``), and its n_contrib flips to
    ``check_image``'s flip rule with the largest slab feature."""
    import torch

    with torch.no_grad():
        return _compare_blend(calls, label, hdr, exact)


def blend_float64(a, kw):
    """B3's plain version evaluated in float64 on a captured call's
    arguments ``a``, ``kw`` (the slab cast to float64; the thresholds are
    the kernels' float32 constants): its image, float64."""
    import torch

    from svgir_tpu_torch.ops import blend_pallas_strip as P
    with torch.no_grad():
        return P.blend_forward_plain(a[0].double(), *a[1:],
                                     **{**kw, "emit_wsum": False})[0]


def split_blend(calls, label, card, pairs=6):
    """B3 and its float32 plain version, each against the plain version in
    float64 (``blend_float64``), at every pixel where kernel and float32
    plain version differ past ``check_image``'s limits, where the kernel
    lies past them from float64, or where kernel and float64 blend another
    number of pairs.  Each such pixel
    is logged with its logT and its worst channel sum (kernel - float64,
    float32 plain - float64) and its three n_contrib, in one class: (a)
    the kernel lies past the limit from float64; (b) it lies within it,
    and the float32 plain version farther or on the other side; (c) the
    kernel blends
    another number of pairs than float64 (a pair at alpha 1/255, or the
    gate at log 1e-4), which ``check_image``'s flip rule judges.  For the
    ``pairs`` pixels of class (a) first, then the largest logT gaps, each
    pair the tile tests there: log1p(-alpha) as the kernel takes it (the
    kernel on a slab that holds that pair's row alone) beside the float32
    and float64 values, with alpha and the power's cancellation (the
    quadratic form's terms over |power|).  Returns {class: pixels}."""
    import torch

    from svgir_tpu_torch.kernels import blend as K
    from svgir_tpu_torch.ops import blend_pallas_strip as P
    from svgir_tpu_torch.ops.common import ALPHA_MIN, LOG_T_EPS

    a, kw = calls["blend_forward"]
    slab, t_start, t_count = a
    n = kw["ca"] + kw["cv"]
    with torch.no_grad():
        ki, ke, _ = K.blend_forward(*a, **kw)
        pi = P.blend_forward_plain(*a, **kw)[0]
        di = blend_float64(a, kw)
        ki, pi = ki.double(), pi.double()
    fmax = float(slab[:, 12:].abs().max())
    step = -math.log1p(-1.0 / 255.0)

    def over(ref):
        """|ki - ref| over check_image's limit: [1 + n, H, W], logT first."""
        lim = torch.where(ref[n] < LOG_T_EPS, TOL_LOGT_SAT, 1e-5)
        o = [((ki[n] - ref[n]).abs() / lim)[None]]
        if n:
            o.append((ki[:n] - ref[:n]).abs()
                     / (TOL_IMG * (1 + ref[:n].abs())))
        return torch.cat(o)
    od = over(di)
    ov = torch.maximum(over(pi), od)         # against either reference
    past = od.amax(0) > 1                    # the kernel, from float64
    # each pixel's worst quantity (0: logT; 1 + c: channel c)
    worst = torch.where(past, od.argmax(0), ov.argmax(0))
    bad = torch.nonzero((ov.amax(0) > 1)
                        | (ki[n + 1] != di[n + 1])).tolist()
    gap = (ki[n] - pi[n]).abs()
    classes, rows = {"a": 0, "b": 0, "c": 0}, []
    for y, x in bad:
        nk, npl, nd = (int(t[n + 1, y, x]) for t in (ki, pi, di))
        ch = int(worst[y, x]) - 1
        at = n if ch < 0 else ch            # the worst quantity's channel
        ek, ep = float(ki[at, y, x] - di[at, y, x]), \
            float(pi[at, y, x] - di[at, y, x])
        if ch < 0:
            lim = TOL_LOGT_SAT if float(di[n, y, x]) < LOG_T_EPS else 1e-5
        else:
            lim = TOL_IMG * (1 + abs(float(di[ch, y, x])))
        if nk != nd:
            cls = "c"
            pf = di[:n, y, x].abs()
            within = (abs(float(ki[n, y, x] - di[n, y, x]))
                      <= step * 1.01 + 1e-5) and bool(
                ((ki[:n, y, x] - di[:n, y, x]).abs()
                 <= (fmax + pf) / 255.0 + TOL_IMG * (1 + pf)).all())
        else:
            cls = "a" if bool(past[y, x]) else "b"
            within = cls == "b"
        classes[cls] += 1
        rows.append((cls, -float(gap[y, x]), y, x))
        log(f"[split] {label} B3 pixel ({y}, {x}), "
            + ("logT" if ch < 0 else f"channel {ch}")
            + f": kernel - float64 {ek:.4g}, float32 plain - float64 "
            f"{ep:.4g} (limit {lim:.3g}); logT {float(di[n, y, x]):.7g}; "
            f"n_contrib kernel {nk}, plain {npl}, float64 {nd}; class "
            f"({cls}), " + ("within" if within else "PAST")
            + (" the flip rule" if cls == "c" else " the limit from "
               "float64"))
    tile, gx, chunk = kw["tile"], kw["grid_x"], kw["chunk"]
    shown = [r for c in "acb" for r in sorted(r for r in rows
                                              if r[0] == c)[:pairs]]
    for _, _, y, x in shown:
        t = (y // tile) * gx + x // tile
        r0 = int(t_start[t])
        s = slab[r0:r0 + int(ke[t]) * chunk]
        px = torch.full((1, 1, 1), float(x), device=slab.device)
        py = torch.full((1, 1, 1), float(y), device=slab.device)
        with torch.no_grad():
            m32 = P._chunk_math(s[None], px, py)
            m64 = P._chunk_math(s[None].double(), px, py)
        edge = (m64["power"] <= 0) & ((m64["alpha"] - ALPHA_MIN).abs()
                                      < 1e-4 * ALPHA_MIN)
        tests = torch.nonzero((m32["ok"] | m64["ok"] | edge)[0, 0])[:, 0]
        sums, quiet = [0.0, 0.0], 0
        for i in tests.tolist():
            one = torch.zeros_like(slab)
            one[r0 + i] = slab[r0 + i]
            with torch.no_grad():
                lk = float(K.blend_forward(one, t_start, t_count,
                                           **kw)[0][n, y, x])
            l32, l64 = (float(m["loga"][0, 0, i]) for m in (m32, m64))
            p32, p64 = (float(m["power"][0, 0, i]) for m in (m32, m64))
            a32, a64 = (float(m["alpha"][0, 0, i]) for m in (m32, m64))
            r = s[i].double()
            dx, dy = float(m64["dx"][0, 0, i]), float(m64["dy"][0, 0, i])
            terms = 0.5 * (abs(float(r[2])) * dx * dx
                           + abs(float(r[4])) * dy * dy) \
                + abs(float(r[3]) * dx * dy)
            sums[0] += lk - l64
            sums[1] += l32 - l64
            at_edge = abs(a64 - ALPHA_MIN) < 1e-4 * ALPHA_MIN
            if max(abs(lk - l64), abs(l32 - l64)) < 2e-7 and not at_edge:
                quiet += 1
                continue
            log(f"[split] {label} ({y}, {x}) row {r0 + i}: power "
                f"{p32:.9g} / {p64:.12g} (terms / |power| "
                f"{terms / max(abs(p64), 1e-30):.3g}), alpha {a32:.9g} / "
                f"{a64:.12g}" + (" AT 1/255" if at_edge else "")
                + f"; log1p(-alpha) kernel {lk:.9g}, float32 {l32:.9g}, "
                f"float64 {l64:.12g}")
        log(f"[split] {label} ({y}, {x}): {len(tests)} pairs ({quiet} "
            "within 2e-7 of float64 in both, not shown); summed "
            f"per-pair error against float64: kernel {sums[0]:.4g}, "
            f"float32 plain {sums[1]:.4g}; the rest of kernel - float64 "
            f"(its running sum) "
            f"{float(ki[n, y, x] - di[n, y, x]) - sums[0]:.4g}")
    log(f"[split] {label} B3: {len(bad)} pixels where the kernel lies past "
        "the limits from its float32 plain version or from float64, or "
        "blends another number of pairs than float64; by class "
        f"{classes}; largest slab feature {fmax:.4g}; card: {card}")
    return classes


def check_image(ki, pi, nch, tag, feature_max=None):
    """A blend image (kernel ``ki``) against its reference ``pi``, both
    [CA+CV+2, Hp, Wp]: channel sums within TOL_IMG, logT within 1e-5
    (TOL_LOGT_SAT where saturated), n_contrib at all but 1e-4 of the
    pixels; returns (max channel error, max logT error, n_contrib
    mismatches).  ``feature_max`` (the largest feature any instance
    carries, on a render lit by an HDR light): the pixels where n_contrib
    differs (a pair whose alpha lies at 1/255 is blended by one rounding
    of exp and not by the other) are held instead to what one such pair
    moves: logT by -log(1 - 1/255), the sums by 1/255 of (feature_max +
    the sum) beyond TOL_IMG."""
    import torch

    from svgir_tpu_torch.ops.common import LOG_T_EPS

    flip = ki[nch + 1] != pi[nch + 1]
    nc_bad = int(flip.sum())
    keep = ~flip if feature_max is not None else flip | ~flip
    d = (ki[:nch] - pi[:nch]).abs()
    err_img = float(d.max()) if nch else 0.0
    lim = TOL_IMG * (1 + pi[:nch].abs())
    viol = ~(d <= lim) & keep[None]
    if bool(viol.any()):
        pix = viol.any(0)
        where = torch.nonzero(viol)        # row-major, as d[viol]
        c, y, x = (int(v) for v in where[torch.argmax(d[viol])])
        raise AssertionError(
            f"{tag} channel sums differ by {err_img}: {int(viol.sum())} "
            f"sums at {int(pix.sum())} pixels over the tolerance, "
            f"{int((pix & flip).sum())} of those pixels where n_contrib "
            f"differs ({nc_bad} such pixels in all); the largest at "
            f"channel {c}, pixel ({y}, {x}): kernel {float(ki[c, y, x]):.7g}"
            f", plain {float(pi[c, y, x]):.7g}, logT "
            f"{float(ki[nch, y, x]):.7g} / {float(pi[nch, y, x]):.7g}, "
            f"n_contrib {float(ki[nch + 1, y, x]):.0f} / "
            f"{float(pi[nch + 1, y, x]):.0f}")
    sat = pi[nch] < LOG_T_EPS
    dl = (ki[nch] - pi[nch]).abs()
    err_lt = float(dl.max())
    over = ((dl > 1e-5) & ~sat | (dl > TOL_LOGT_SAT) & sat) & keep
    if bool(over.any()):
        y, x = (int(v) for v in torch.nonzero(over)[torch.argmax(dl[over])])
        raise AssertionError(
            f"{tag} logT differs by {err_lt}: at {int((over & ~sat).sum())}"
            f" unsaturated and {int((over & sat).sum())} saturated pixels "
            f"over the tolerance; the largest at pixel ({y}, {x}): kernel "
            f"{float(ki[nch, y, x]):.7g}, plain {float(pi[nch, y, x]):.7g},"
            f" n_contrib {float(ki[nch + 1, y, x]):.0f} / "
            f"{float(pi[nch + 1, y, x]):.0f}")
    if nc_bad > ki[nch + 1].numel() // 10000:
        raise AssertionError(f"{tag} n_contrib differs at {nc_bad} pixels")
    if feature_max is not None and nc_bad:
        step = -math.log1p(-1.0 / 255.0)
        pf = pi[:nch, flip].abs()
        if bool((dl[flip] > step * 1.01 + 1e-5).any()) or bool(
                (d[:, flip] > (feature_max + pf) / 255.0
                 + TOL_IMG * (1 + pf)).any()):
            raise AssertionError(f"{tag} differs at its {nc_bad} n_contrib "
                                 "flips by more than one pair at alpha "
                                 "1/255 moves it")
    return err_img, err_lt, nc_bad


def check_rows(kd, pd, ca, tag):
    """Gradient rows d_slab against a reference, each row kind within
    TOL_ROWS of its largest magnitude; returns the max absolute error."""
    err = 0.0
    kinds = {"mean2d": slice(0, 2), "conic": slice(2, 5),
             "opacity": slice(5, 6), "jinv": slice(6, 10),
             "lam": slice(10, 12), "plain": slice(12, 12 + ca),
             "vertex": slice(12 + ca, None)}
    for kind, sl in kinds.items():
        if pd[:, sl].numel() == 0:
            continue
        e = max_err_rel(kd[:, sl], pd[:, sl])
        err = max(err, float((kd[:, sl] - pd[:, sl]).abs().max()))
        if e > TOL_ROWS:
            raise AssertionError(f"{tag} {kind} rows differ by {e} of their "
                                 "largest magnitude")
    return err


def _compare_blend(calls, label, hdr=False, exact=False):
    import torch

    from svgir_tpu_torch.kernels import blend as K
    from svgir_tpu_torch.ops import blend_pallas_strip as P

    a, kw = calls["blend_forward"]
    ki, ke, kwsum = K.blend_forward(*a, **kw)
    pi, pe, pwsum = P.blend_forward_plain(*a, **kw)
    torch.cuda.synchronize()
    ca, cv = kw["ca"], kw["cv"]
    if not torch.equal(ke, pe):
        raise AssertionError(f"B3 [{label}] eff differs: "
                             f"{int((ke != pe).sum())} tiles")
    fmax = float(a[0][:, 12:].abs().max()) if hdr or exact else None
    ref = blend_float64(a, kw) if exact else pi
    err_img, err_lt, nc_bad = check_image(
        ki, ref, ca + cv,
        f"B3 [{label}]" + (" against float64" if exact else ""), fmax)
    err_w = 0.0
    if kwsum is not None:
        err_w = max_err_rel(kwsum, pwsum)
        if err_w > TOL_ROWS:
            raise AssertionError(f"B3 [{label}] weight sums differ: {err_w}")
    against = ""
    if exact:
        # away from the n_contrib flips, which the flip rule judged: the
        # kernel's and the float32 plain version's errors from float64
        from svgir_tpu_torch.ops.common import LOG_T_EPS
        n = ca + cv
        live = ref[n] >= LOG_T_EPS

        def off(x):
            keep = x[n + 1] == ref[n + 1]
            e_img = float((x[:n] - ref[:n])[:, keep].abs().max()) \
                if n and bool(keep.any()) else 0.0
            e_lt = float((x[n] - ref[n])[keep & live].abs().max()) \
                if bool((keep & live).any()) else 0.0
            return e_img, e_lt
        err_img, err_lt = off(ki)
        p_img, p_lt = off(pi)
        against = (f" against float64, logT where unsaturated, away from "
                   f"its {nc_bad} n_contrib flips (the float32 plain "
                   f"version: img {p_img:.3g}, logT {p_lt:.3g})")
    err3 = max(err_img, err_lt, err_w)
    if "blend_backward" not in calls:            # a forward-only render
        log(f"[kernels] {label}: B3 max|err| img {err_img:.3g} logT "
            f"{err_lt:.3g}{against}; n_contrib mismatches {nc_bad}"
            + (f" (largest instance feature {fmax:.4g})" if hdr else ""))
        return err3, None

    b, bkw = calls["blend_backward"]
    kd = K.blend_backward(*b, **bkw)
    pd = P.blend_backward_plain(*b, **bkw)
    torch.cuda.synchronize()
    err4 = check_rows(kd, pd, ca, f"B4 [{label}]")
    log(f"[kernels] {label}: B3 max|err| img {err_img:.3g} logT {err_lt:.3g}"
        f"{against} wsum(rel) {err_w:.3g}; B4 max|err| {err4:.3g}; "
        f"n_contrib mismatches {nc_bad}")
    return err3, err4


def blend_edge_calls(d, dev):
    """Blend inputs ``d`` of tests/torch_kernel_inputs.py (the edge inputs,
    the near-clamp ones) on the card as captured calls of B3/B4 and of
    B5/B6: the backward's eff, logT and meta from the plain forward, its
    cotangents from the inputs."""
    import torch

    from svgir_tpu_torch.ops import blend_pallas as BP
    from svgir_tpu_torch.ops import blend_pallas_strip as BS

    t = {k: torch.from_numpy(v).to(dev) for k, v in d.items()
         if hasattr(v, "shape")}
    kw = {k: d[k] for k in ("ca", "cv", "grid_x", "grid_y", "tile",
                            "chunk")}
    nch = d["ca"] + d["cv"]
    lay = dict(grid_x=d["grid_x"], grid_y=d["grid_y"], tile=d["tile"])
    a = (t["slab"], t["tile_start"], t["tile_count"])
    with torch.no_grad():
        img, eff, _ = BS.blend_forward_plain(*a, **kw)
        out, _ = BP.blend_forward_plain(*a, **kw)
    g_out = torch.cat([BP.to_tiles(t["g_img"][:nch + 1], **lay),
                       torch.zeros_like(out[:, :2])], 1).contiguous()
    return {
        "blend_forward": (a, kw),
        "blend_backward": ((t["slab"], t["tile_start"], eff, t["g_img"],
                            img[nch].contiguous(), t["g_wsum"]), kw),
        "blend_forward_tiles": (a, kw),
        "blend_backward_tiles": ((t["slab"], t["tile_start"], g_out,
                                  out[:, nch:].contiguous(), t["g_wsum"]),
                                 kw)}


_PTXAS_KERNEL = re.compile(r"svgir_blend_(fwd|bwd)_kernelI((?:L[ib]\d+E)+)E")


def ptxas_blend(text):
    """Registers and spills of each blend instantiation in ``ptxas -v``
    output: {(direction, template arguments): {...}}, the arguments as
    mangled (ints and bools in order: for this tree MAXA, MAXV, EXACT,
    PPT, the backward's IB, ASYNC, TILES, then the backward's own)."""
    out, cur = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line or \
                "Function properties for" in line:
            m = _PTXAS_KERNEL.search(line)
            cur = None
            if m:
                args = tuple(int(x) for x in re.findall(r"L[ib](\d+)E", m[2]))
                cur = ("forward" if m[1] == "fwd" else "backward", args)
                out.setdefault(cur, {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[cur].update(stack_bytes=int(m[1]), spill_stores=int(m[2]),
                            spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m[1])
    return out


def blend_build(table, direction, ca, cv, tile, chunk, tiles=False):
    """The kernel a blend launch takes (its compiled widths, pixels per
    thread, instances per round, blocks per SM, threads, shared memory)
    with its registers and spills from the build log."""
    from svgir_tpu_torch.kernels import blend as K
    info = K.kernel_info(direction, ca=ca, cv=cv, tile=tile, chunk=chunk)
    at = 6 if direction == "backward" else 5       # TILES among the args
    for widths in ((ca, cv, 1), (16, 0, 0), (32, 16, 0)):
        for (d, args), v in table.items():
            if d == direction and args[:3] == widths and \
                    args[3] == info["ppt"] and args[at] == int(tiles):
                return {**info, "compiled_widths": f"{widths[0]}/{widths[1]}"
                        + ("" if widths[2] else " (generic)"), **v}
    raise AssertionError(f"no {direction} blend instantiation in the build "
                         f"log for {ca}/{cv}, tile {tile}")


def parent_kernels(parent_dir):
    """The blend, binning, column-copy, env-gradient (B7's backward) and
    march (B8) wrappers of another checkout
    (``parent_dir`` holds its ``svgir_tpu_torch``), imported from there
    with its own build module,
    which builds its kernels in ``parent_dir``: this tree's modules are set
    aside while the other's load, then put back.  Calls go through the
    other tree's own wrappers, so an interface that differs raises."""
    import importlib
    import os

    def ours():
        return {k: v for k, v in sys.modules.items()
                if k == "svgir_tpu_torch" or k.startswith("svgir_tpu_torch.")}
    mine = ours()
    for k in mine:
        del sys.modules[k]
    root = os.path.abspath(parent_dir)
    sys.path.insert(0, root)
    try:
        mod = importlib.import_module("svgir_tpu_torch.kernels.blend")
        bin_ = importlib.import_module("svgir_tpu_torch.kernels.binning")
        cols = importlib.import_module("svgir_tpu_torch.kernels.cols")
        env = importlib.import_module("svgir_tpu_torch.kernels.env_lookup")
        march = importlib.import_module("svgir_tpu_torch.kernels.march")
        bld = importlib.import_module("svgir_tpu_torch.kernels.build")
    finally:
        sys.path.remove(root)
        for k in ours():
            del sys.modules[k]
        sys.modules.update(mine)
    if not os.path.abspath(mod.__file__).startswith(root + os.sep):
        raise RuntimeError(f"--parent {parent_dir}: imported {mod.__file__}")
    bld.build()
    log_path = bld.BUILD_DIR / "build.log"
    return {"label": os.path.basename(os.path.normpath(parent_dir)),
            "blend_forward": mod.blend_forward,
            "blend_backward": mod.blend_backward,
            "blend_forward_tiles": mod.blend_forward_tiles,
            "blend_backward_tiles": mod.blend_backward_tiles,
            "counts": bin_.counts, "instances": bin_.instances,
            "pad_cols": cols.pad_cols, "slice_cols": cols.slice_cols,
            "env_lookup_backward": env.env_lookup_backward,
            "march": march.march,
            "ptxas": log_path.read_text() if log_path.exists() else ""}


def compare_parent(parent, calls, label, card, tiles=False):
    """Another tree's blend kernels (``parent_kernels``; B3/B4, or B5/B6 with
    ``tiles``) against this tree's on the captured inputs (held to each
    other at the kernel tolerances), then both timed in turns (other, this,
    this, other): per call and on the device.  Returns {"forward": {...},
    "backward": {...}}."""
    import torch

    from svgir_tpu_torch.kernels import blend as K
    from svgir_tpu_torch.ops import blend_pallas as BP

    fwd, bwd = ("blend_forward_tiles", "blend_backward_tiles") if tiles \
        else ("blend_forward", "blend_backward")
    a, kw = calls[fwd]
    nch = kw["ca"] + kw["cv"]
    lay = dict(grid_x=kw["grid_x"], grid_y=kw["grid_y"], tile=kw["tile"])
    mine = {"blend_forward": K.blend_forward,
            "blend_backward": K.blend_backward,
            "blend_forward_tiles": K.blend_forward_tiles,
            "blend_backward_tiles": K.blend_backward_tiles}
    runs = {"forward": (lambda: parent[fwd](*a, **kw),
                        lambda: mine[fwd](*a, **kw))}
    with torch.no_grad():
        po, ko = parent[fwd](*a, **kw), mine[fwd](*a, **kw)
        torch.cuda.synchronize()
        if tiles:
            pi, ki = (BP.to_image(o[0][:, :nch + 2], **lay) for o in (po, ko))
            same_eff = torch.equal(po[0][:, nch + 2], ko[0][:, nch + 2])
        else:
            pi, ki, same_eff = po[0], ko[0], torch.equal(po[1], ko[1])
        if not same_eff:
            raise AssertionError(f"{fwd} [{label}]: chunks processed differ "
                                 "from the parent's")
        check_image(ki, pi, nch, f"{fwd} against the parent's [{label}]")
        if bwd in calls:
            b, bkw = calls[bwd]
            check_rows(mine[bwd](*b, **bkw), parent[bwd](*b, **bkw),
                       kw["ca"], f"{bwd} against the parent's [{label}]")
            runs["backward"] = (lambda: parent[bwd](*b, **bkw),
                                lambda: mine[bwd](*b, **bkw))
        out = {}
        for direction, (old, new) in runs.items():
            out[direction] = in_turns(old, new)
            log_turns(out[direction], f"{parent['label']} {label}: "
                      f"{direction}{' (tiles)' if tiles else ''}", card)
    return out


def parent_env_backward(parents, b, bkw, label, card):
    """Each other tree's B7 backward against this tree's on cotangents ``b``
    (within TOL_ENV_BWD of the largest |d_env|), then both timed in turns;
    returns {label: times}."""
    import torch

    from svgir_tpu_torch.kernels import env_lookup as K
    out = {}
    for p in parents:
        with torch.no_grad():
            mine, theirs = K.env_lookup_backward(*b, **bkw), \
                p["env_lookup_backward"](*b, **bkw)
            torch.cuda.synchronize()
        e = float((mine - theirs).abs().max())
        if e > TOL_ENV_BWD * max(float(theirs.abs().max()), 1e-30):
            raise AssertionError(f"B7 backward [{label}] differs from "
                                 f"{p['label']}'s by {e}")
        o = in_turns(lambda p=p: p["env_lookup_backward"](*b, **bkw),
                     lambda: K.env_lookup_backward(*b, **bkw))
        out[p["label"]] = o
        log_turns(o, f"{p['label']} env_lookup_backward [{label}]", card)
    return out


def parent_march(parents, grid, o, d, mkw, label, card):
    """Each other tree's B8 against this tree's on one ray chunk (hit for
    hit, within MARCH_SLOT_TOL of the finite slots), then both timed in
    turns; returns {label: times}."""
    import torch

    from svgir_tpu_torch.kernels import march as K
    from svgir_tpu_torch.ops import grid_tracer as GT
    args = (grid.block_geo, grid.block_start, grid.cell_count, o, d)
    kw = dict(lo=grid.lo, inv_cell=grid.inv_cell, res=grid.res,
              dt=GT.grid_dt(grid), t_max=mkw["t_max"], n_steps=mkw["n_steps"],
              kmax=mkw["kmax"], cap=grid.cell_cap, k=mkw["k"])
    out = {}
    for p in parents:
        with torch.no_grad():
            (kt, ki), (pt, pi) = K.march(*args, **kw), p["march"](*args, **kw)
            torch.cuda.synchronize()
        fin = torch.isfinite(pt)
        bad = int(((ki != pi) | (torch.isfinite(kt) != fin)
                   | (fin & (kt != pt))).sum())
        log(f"[parent] B8 [{label}] against {p['label']}'s: {int(fin.sum())} "
            f"finite slots, {bad} differ")
        if bad > MARCH_SLOT_TOL * max(int(fin.sum()), 1):
            raise AssertionError(f"B8 [{label}] differs from {p['label']}'s "
                                 f"at {bad} slots")
        o_ = in_turns(lambda p=p: p["march"](*args, **kw),
                      lambda: K.march(*args, **kw))
        out[p["label"]] = o_
        log_turns(o_, f"{p['label']} march [{label}]", card)
    return out


# Float operations the blend needs per (pixel, instance) pair, by what the
# pair needs (an exp, log1p or division counts as one; a multiply-add as
# two; each nonzero term of a sum over the tile's pixels as one add):
#   test   every pair of a real row: offset, power, exp, alpha, both tests;
#   ok     the pair passes the footprint test: forward log1p and logT update;
#          backward loga, logT_excl, the logT part of d_alpha, d_power and
#          the six geometry rows (mean2d, conic, opacity) with their sums;
#   gated  ok and above the transmittance threshold: the weight, the plain
#          channel sums (forward) or dw, the plain rows and the weight part
#          of d_alpha (backward); with CV > 0 also the bilinear (u, v), the
#          vertex sums or rows, and in the backward d_Jinv and d_lam.
# Pairs past the footprint and padding rows need nothing more: their
# contributions and gradient terms are exactly zero.
FWD_TEST, FWD_OK = 16, 4
BWD_TEST, BWD_OK = 16, 36


def fwd_gated_ops(ca, cv):
    return 4 + 2 * ca + (30 + 8 * cv if cv else 0)


def bwd_gated_ops(ca, cv, has_gwsum):
    return 7 + 4 * ca + int(has_gwsum) + (84 + 17 * cv if cv else 0)


def bounds(calls, tiles=False):
    """Least time (ms) the card could take for each kernel's work on the
    captured inputs: max(bytes / HBM rate, operations / float32 rate), each
    input read once and each output written once.  The blend's work is
    counted on these inputs by the plain forward: the real rows of the
    chunks each tile processes, and their (pixel, row) pairs that are
    tested, pass the footprint test, and blend.  ``tiles``: the tile-major
    blend B5/B6 (keys ``blend_*_tiles``), whose output carries the chunks
    processed as one more row instead of B3's ``eff``; B6 reads the same
    bytes as B4 (cotangent rows, logT, one chunk count per tile).  The
    binning kernels and the backward are counted where they were
    captured."""
    import torch

    from svgir_tpu_torch.ops import blend_pallas_strip as BS

    fwd, bwd = ("blend_forward_tiles", "blend_backward_tiles") if tiles \
        else ("blend_forward", "blend_backward")
    b3, kw3 = calls[fwd]
    slab, ts, tc = b3
    m, kr = slab.shape
    ca, cv = kw3["ca"], kw3["cv"]
    T = kw3["grid_x"] * kw3["grid_y"]
    hw = T * kw3["tile"] ** 2
    g_wsum = calls[bwd][0][-1] if bwd in calls else None   # last argument
    work = {}
    with torch.no_grad():
        BS.blend_forward_plain(*b3, **kw3, work=work)
    ops_fwd = (work["pairs"] * FWD_TEST + work["ok"] * FWD_OK
               + work["gated"] * fwd_gated_ops(ca, cv))
    ops_bwd = (work["pairs"] * BWD_TEST + work["ok"] * BWD_OK
               + work["gated"] * bwd_gated_ops(ca, cv, g_wsum is not None))
    out = {"blend_work": work}

    def bound(name, nbytes, ops):
        tb, to = nbytes / HBM_BYTES_S * 1e3, ops / FP32_OPS_S * 1e3
        out[name] = (max(tb, to), "bytes" if tb >= to else "operations")

    if "compute_counts" in calls:
        a, kw = calls["compute_counts"]
        ns = a[0].numel()
        nchunks = ns // kw.get("gauss_chunk", 256)
        a2, kw2 = calls["compute_instances"]
        total_raw = int(a2[7])
        bound("binning_counts", 16 * ns + 4 * T + 4 * nchunks * T, total_raw)
        bound("binning_instances", 24 * ns + 4 * nchunks * T + 8 * kw2["m"],
              total_raw * max(1, math.ceil(math.log2(ns))))
    rows_b = 4 * work["rows"] * kr               # real slab rows, read once
    out_b = 4 * (ca + cv + 3) * hw + 8 * T if tiles \
        else 4 * (ca + cv + 2) * hw + 12 * T
    bound(fwd, rows_b + out_b + (4 * m if kw3.get("emit_wsum", True) else 0),
          ops_fwd)
    bound(bwd, rows_b + 4 * (ca + cv + 2) * hw + 8 * T
          + (4 * m if g_wsum is not None else 0) + 4 * m * kr, ops_bwd)
    return out


def library_counts(calls):
    """One-call-per-stage PyTorch yardstick of the B1 counts alone (kept
    for continuity with earlier runs): corner bincount of the rect
    difference array, then a 2-D cumsum."""
    import torch
    a, kw = calls["compute_counts"]
    x0, y0, x1, y1 = (t.long() for t in a)
    gx, gy = kw["grid_x"], kw["grid_y"]
    W = gx + 1

    def fn():
        idx = torch.cat([y0 * W + x0, y0 * W + x1, y1 * W + x0, y1 * W + x1])
        wts = torch.cat([torch.ones_like(x0), -torch.ones_like(x0),
                         -torch.ones_like(x0), torch.ones_like(x0)])
        d = torch.bincount(idx, weights=wts.float(),
                           minlength=(gy + 1) * W).view(gy + 1, W)
        return d.cumsum(0).cumsum(1)[:gy, :gx]
    return fn


def library_counts_carry(calls):
    """One-call-per-stage PyTorch yardstick of B1's whole function, counts
    and carry: a bincount of each Gaussian's four difference-array corners
    in its chunk's plane ([nchunks, gy+1, gx+1]; empty and inverted rects
    weigh 0), a 2-D cumsum per chunk, then an exclusive cumsum over the
    chunks.  Returns (counts [T], carry [nchunks, T]) int32."""
    import torch
    a, kw = calls["compute_counts"]
    gx, gy = kw["grid_x"], kw["grid_y"]
    gc = kw.get("gauss_chunk", 256)
    x0, y0 = a[0].long().clamp(0, gx), a[1].long().clamp(0, gy)
    x1, y1 = a[2].long().clamp(0, gx), a[3].long().clamp(0, gy)
    ns = x0.numel()
    nchunks, W = ns // gc, gx + 1
    plane = torch.arange(ns, device=x0.device) // gc * ((gy + 1) * W)

    def fn():
        live = ((x1 > x0) & (y1 > y0)).float()
        idx = torch.cat([plane + y0 * W + x0, plane + y0 * W + x1,
                         plane + y1 * W + x0, plane + y1 * W + x1])
        wts = torch.cat([live, -live, -live, live])
        d = torch.bincount(idx, weights=wts, minlength=nchunks * (gy + 1) * W)
        per = d.view(nchunks, gy + 1, W).cumsum(1).cumsum(2)[:, :gy, :gx]
        per = per.reshape(nchunks, gx * gy).to(torch.int32)
        inc = per.cumsum(0, dtype=torch.int32)
        return inc[-1], inc - per
    return fn


def b1_yardstick(calls):
    """``library_counts_carry`` of the captured calls, after a check that
    it computes what B1 computes on them."""
    import torch

    from svgir_tpu_torch.kernels import binning as K
    a, kw = calls["compute_counts"]
    lib = library_counts_carry(calls)
    lc, lcar = lib()
    kc, kcar = K.counts(*a, grid_x=kw["grid_x"], grid_y=kw["grid_y"],
                        gauss_chunk=kw.get("gauss_chunk", 256))
    if not (torch.equal(lc, kc) and torch.equal(lcar, kcar)):
        raise AssertionError("the B1 yardstick computes another function")
    return lib


def kernel_calls(calls):
    """Zero-argument calls of each kernel captured in ``calls`` (B1-B4,
    B7): {name: (its wrapper, its plain version, its library yardstick or
    None)}, B1's yardstick checked against B1."""
    from svgir_tpu_torch.kernels import binning as KB
    from svgir_tpu_torch.kernels import blend as KBL
    from svgir_tpu_torch.kernels import env_lookup as KE
    from svgir_tpu_torch.ops import binning_pallas as BP
    from svgir_tpu_torch.ops import blend_pallas_strip as BS
    from svgir_tpu_torch.ops import env_lookup_pallas as EP

    out = {}
    if "compute_counts" in calls:
        a1, kw1 = calls["compute_counts"]
        kk1 = dict(grid_x=kw1["grid_x"], grid_y=kw1["grid_y"],
                   gauss_chunk=kw1.get("gauss_chunk", 256))
        a2, kw2 = calls["compute_instances"]
        out["binning_counts"] = (lambda: KB.counts(*a1, **kk1),
                                 lambda: BP.counts_plain(*a1, **kk1),
                                 b1_yardstick(calls))
        out["binning_instances"] = (lambda: KB.instances(*a2, **kw2),
                                    lambda: BP.instances_plain(*a2, **kw2),
                                    None)
    if "blend_forward" in calls:
        a3, kw3 = calls["blend_forward"]
        out["blend_forward"] = (lambda: KBL.blend_forward(*a3, **kw3),
                                lambda: BS.blend_forward_plain(*a3, **kw3),
                                None)
    if "blend_backward" in calls:
        a4, kw4 = calls["blend_backward"]
        out["blend_backward"] = (lambda: KBL.blend_backward(*a4, **kw4),
                                 lambda: BS.blend_backward_plain(*a4, **kw4),
                                 None)
    if "env_lookup_forward" in calls:
        fa, _ = calls["env_lookup_forward"]
        out["env_lookup_forward"] = (lambda: KE.env_lookup_forward(*fa),
                                     lambda: EP.env_lookup_forward_plain(*fa),
                                     library_env_forward(fa))
    if "env_lookup_backward" in calls:
        ba, bkw = calls["env_lookup_backward"]
        out["env_lookup_backward"] = (
            lambda: KE.env_lookup_backward(*ba, **bkw),
            lambda: EP.env_lookup_backward_plain(*ba, **bkw),
            library_env_backward(calls))
    return out


def profile_step(fn, out_dir, name="chip_smoke_profile.txt", steps=3):
    """torch.profiler table of ``steps`` train steps (after a warm-up),
    sorted by device time, written to ``out_dir/name``, with the device
    busy time per step counted by name as ``device_ms`` counts it;
    returns {device operation: ms per step}."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.02)
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.02)
    busy, ops, rec, op_ms = device_by_name(prof, steps)
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    head = (f"{steps} steps; device busy {busy:.3f} ms per step ({ops} "
            f"device operations, {rec:.3f} of them recorded)")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        f.write(head + "\n" + table)
    log(f"[profile] {name}: {head}; by device time over the {steps} steps:")
    for line in table.splitlines()[:25]:
        log("[profile] " + line)
    return op_ms


# ---------------------------------------------------------------------------
# stage 2
# ---------------------------------------------------------------------------

S2_SAMPLES = 24         # incident samples per surfel (bench_stage2.py)
S2_ENV_H = 32           # env map 32 x 64


def stage2_inputs(state, device, *, samples=S2_SAMPLES, env_h=S2_ENV_H,
                  seed=2):
    """bench_stage2.py:69-92 on ``state``: upgrade_to_pbr, a synthetic bake
    (its values do not change the step's cost) with the equirect
    coordinates of its incident directions, radiances from the bake and a
    fresh env map, all drawn from one seeded generator."""
    import torch

    from svgir_tpu_torch.config import OptimizationConfig
    from svgir_tpu_torch.models import gaussians as G
    from svgir_tpu_torch.models import lights as LT
    from svgir_tpu_torch.utils.graphics import fibonacci_sphere_sampling
    from svgir_tpu_torch.utils.transforms import normalize

    g = torch.Generator(device=device).manual_seed(seed)
    n = state["params"]["xyz"].shape[0]
    st = G.upgrade_to_pbr(state)
    inc, areas = fibonacci_sphere_sampling(
        normalize(torch.randn(n, 3, generator=g, device=device)), samples)
    qx, qy = LT.equirect_grid_coords(inc)
    bake = {
        "radiance": torch.rand(n, samples, 3, generator=g, device=device),
        "visibility": (torch.rand(n, samples, 1, generator=g, device=device)
                       > 0.3).float(),
        "incident_dirs": inc, "incident_areas": areas,
        "incident_qxy": torch.stack([qx, qy], -1),
        "hit_idx": torch.randint(-1, n, (n, samples), generator=g,
                                 device=device),
        "uv": torch.rand(n, samples, 2, generator=g, device=device),
    }
    params = dict(st["params"])
    params["radiances"] = bake["radiance"].clone()
    params["radiance_ratio"] = torch.ones((), device=device)
    env = LT.direct_light_map_init(env_h, OptimizationConfig().light_init,
                                   generator=g, device=device)
    return {**st, "params": params}, bake, env


def compare_env_forward(a, label):
    """B7 forward kernel vs plain on (env, u, v) ``a``: within
    TOL_ENV_FWD; returns the max absolute error."""
    import torch

    from svgir_tpu_torch.kernels import env_lookup as K
    from svgir_tpu_torch.ops import env_lookup_pallas as P

    with torch.no_grad():
        kf, pf = K.env_lookup_forward(*a), P.env_lookup_forward_plain(*a)
        torch.cuda.synchronize()
    if kf.shape != pf.shape:
        raise AssertionError(f"B7 [{label}] forward of shape "
                             f"{tuple(kf.shape)}, not {tuple(pf.shape)}")
    ef = float((kf - pf).abs().max()) if pf.numel() else 0.0
    if ef > TOL_ENV_FWD:
        raise AssertionError(f"B7 [{label}] forward differs by {ef}")
    return ef


def compare_env(calls, label):
    """B7 forward and backward kernel vs plain on the captured inputs;
    returns the max absolute errors."""
    import torch

    from svgir_tpu_torch.kernels import env_lookup as K
    from svgir_tpu_torch.ops import env_lookup_pallas as P

    a, _ = calls["env_lookup_forward"]
    ef = compare_env_forward(a, label)
    with torch.no_grad():
        b, bkw = calls["env_lookup_backward"]
        kb = K.env_lookup_backward(*b, **bkw)
        pb = P.env_lookup_backward_plain(*b, **bkw)
        torch.cuda.synchronize()
    eb = float((kb - pb).abs().max())
    scale = max(float(pb.abs().max()), 1e-30)
    log(f"[kernels] {label}: B7 forward max|err| {ef:.3g} over "
        f"{a[1].numel()} queries; backward max|err| {eb:.3g} "
        f"({eb / scale:.3g} of max |d_env| {scale:.4g})")
    if eb > TOL_ENV_BWD * scale:
        raise AssertionError(f"B7 [{label}] backward differs by {eb}")
    return ef, eb


def compare_env_backward(u, v, g, h, w, label):
    """B7 backward kernel vs plain on queries u, v and cotangents g into an
    h x w env: within TOL_ENV_BWD of the largest |d_env|; returns the max
    absolute error."""
    import torch

    from svgir_tpu_torch.kernels import env_lookup as K
    from svgir_tpu_torch.ops import env_lookup_pallas as P

    with torch.no_grad():
        kb = K.env_lookup_backward(u, v, g, h=h, w=w)
        pb = P.env_lookup_backward_plain(u, v, g, h=h, w=w)
        torch.cuda.synchronize()
    eb = float((kb - pb).abs().max())
    if eb > TOL_ENV_BWD * max(float(pb.abs().max()), 1e-30):
        raise AssertionError(f"B7 [{label}] backward differs by {eb}")
    return eb


def split_env_backward(calls, label, card):
    """B7's backward on a captured step against the plain version
    evaluated in float64 (coordinates and cotangents cast), beside its
    plain version (a float64 sum of float32 taps) and the float32 running
    sum of the same taps (``index_add_`` in float32, the plain version's
    sum before it summed in float64): each one's largest error as a share
    of max |d_env|, and at the texels where kernel and float32 sum differ
    past TOL_ENV_BWD, both against float64 there.  Returns the kernel's
    and the float32 sum's largest errors against float64."""
    import torch

    from svgir_tpu_torch.kernels import env_lookup as K
    from svgir_tpu_torch.ops import env_lookup_pallas as P

    (u, v, g), kw = calls["env_lookup_backward"]
    h, w = kw["h"], kw["w"]
    with torch.no_grad():
        exact = P.env_lookup_backward_plain(u.double(), v.double(),
                                            g.double(), h=h, w=w)
        kb = K.env_lookup_backward(u, v, g, h=h, w=w).double()
        pb = P.env_lookup_backward_plain(u, v, g, h=h, w=w).double()
        su, wu = P._taps(u, w)
        sv, wv = P._taps(v, h)
        base = sv * w + su
        wu, wv = wu[:, None], wv[:, None]
        a0, a1 = (1 - wu) * g, wu * g
        f32 = g.new_zeros(h * w, g.shape[1])
        for idx, val in ((base, (1 - wv) * a0), (base + 1, (1 - wv) * a1),
                         (base + w, wv * a0), (base + w + 1, wv * a1)):
            f32.index_add_(0, idx, val)
        f32 = f32.reshape(h, w, -1).double()
    scale = max(float(exact.abs().max()), 1e-30)
    ek, ep, ef = (float((x - exact).abs().max()) / scale
                  for x in (kb, pb, f32))
    bad = (kb - f32).abs() > TOL_ENV_BWD * float(f32.abs().max())
    nb = int(bad.sum())
    at = "" if not nb else (
        f"; at the {nb} texel values where kernel and float32 sum differ "
        "past TOL_ENV_BWD: kernel - float64 up to "
        f"{float((kb - exact)[bad].abs().max()) / scale:.3g}, float32 sum "
        f"- float64 up to {float((f32 - exact)[bad].abs().max()) / scale:.3g}")
    log(f"[split] {label} B7 backward over {u.numel()} queries, against "
        f"float64 (shares of max |d_env| {scale:.6g}): kernel {ek:.3g}, "
        f"plain version (float64 sum) {ep:.3g}, float32 running sum "
        f"{ef:.3g}{at}; card: {card}")
    return ek, ef


# Float operations of B7 per query: each of the two coordinates' taps
# (floor, two clamps of the floor, subtract, two clamps of the fraction,
# convert, compare-select: 8), the two complements (2); per channel the
# forward's three lerps (3 each), the backward's two tap weights and four
# weighted adds into d_env (10).
ENV_TAP_OPS = 18


def env_bounds(a):
    """Least time (ms) of B7's forward and backward on the forward's
    arguments ``a`` (env, u, v): each query's u, v read once, its samples
    (forward) or cotangents (backward) once, the env read (forward) or
    d_env written (backward) once."""
    h, w, c = a[0].shape
    m = a[1].numel()
    nb = 4 * (2 * m + m * c + h * w * c)
    out = {}
    for name, ops in (("env_lookup_forward", m * (ENV_TAP_OPS + 9 * c)),
                      ("env_lookup_backward", m * (ENV_TAP_OPS + 10 * c))):
        tb, to = nb / HBM_BYTES_S * 1e3, ops / FP32_OPS_S * 1e3
        out[name] = (max(tb, to), "bytes" if tb >= to else "operations")
    return out


def _grid_sample_args(a):
    import torch
    env, u, v = a
    h, w = env.shape[:2]
    envt = env.detach().permute(2, 0, 1)[None].contiguous()   # [1, C, H, W]
    grid = torch.stack([u / (w - 1) * 2 - 1, v / (h - 1) * 2 - 1],
                       -1)[None, None]                           # [1, 1, M, 2]
    return envt, grid


def library_env_forward(a):
    """One-call PyTorch yardstick of B7's forward on (env, u, v) ``a``:
    grid_sample(align_corners=True) on the same env and coordinates."""
    import torch.nn.functional as F
    envt, grid = _grid_sample_args(a)
    return lambda: F.grid_sample(envt, grid, mode="bilinear",
                                 align_corners=True)


def library_env_backward(calls):
    """One-call PyTorch yardstick of B7's backward: grid_sample's env
    gradient alone, on the step's coordinates and cotangents."""
    import torch
    envt, grid = _grid_sample_args(calls["env_lookup_forward"][0])
    g = calls["env_lookup_backward"][0][2]
    gout = g.t().contiguous()[None, :, None, :]                  # [1, C, 1, M]
    return lambda: torch.ops.aten.grid_sampler_2d_backward(
        gout, envt, grid, 0, 0, True, [True, False])


def small_stage2(device, n=2000, res=96, samples=8, seed=3, env_h=16):
    """A small stage-2 scene on ``device``, made on the CPU from a seeded
    generator: surfels on a sphere facing a close camera, random PBR
    parameters, a synthetic bake and an env_h x 2 env_h env."""
    import dataclasses

    import torch

    from svgir_tpu_torch.cameras import look_at_camera
    from svgir_tpu_torch.models import gaussians as G

    g = torch.Generator().manual_seed(seed)
    dirs = torch.randn(n, 3, generator=g)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    state = G.init_from_points(dirs, torch.rand(n, 3, generator=g),
                               normals=dirs, capacity=n,
                               rotation_init="normal", device="cpu")
    state, bake, env = stage2_inputs(state, "cpu", samples=samples,
                                     env_h=env_h, seed=seed)
    p = state["params"]
    p["opacity"] = torch.randn(n, 1, generator=g) + 0.5
    p["base_color"] = 0.5 * torch.randn(n, 12, generator=g)
    p["roughness"] = 0.5 * torch.randn(n, 4, generator=g)
    p["normal"] = 0.1 * torch.randn(n, 12, generator=g)
    cam = look_at_camera(eye=[0.3, 0.2, -2.2], target=[0, 0, 0],
                         up=[0, -1, 0], fovx=math.pi / 3, fovy=math.pi / 3,
                         width=res, height=res, device="cpu")
    cam = dataclasses.replace(cam, image=torch.rand(3, res, res,
                                                    generator=g),
                              image_mask=torch.ones(1, res, res))

    def to(x):
        return x.to(device) if torch.is_tensor(x) else x
    cam = dataclasses.replace(cam, **{
        f.name: to(getattr(cam, f.name)) for f in dataclasses.fields(cam)})
    state = {**state, "params": {k: to(v) for k, v in p.items()},
             "alive": to(state["alive"])}
    return state, {k: to(v) for k, v in bake.items()}, \
        {"env": to(env["params"]["env"])}, cam


def run_small_stage2(device, env_h=16):
    """The small stage-2 scene's eval images, train-mode loss and
    gradients (every parameter group and the env) on ``device``."""
    import torch

    from svgir_tpu_torch.config import OptimizationConfig, RasterConfig
    from svgir_tpu_torch.render.svgss import render_svgss, render_view_svgss

    state, bake, env, cam = small_stage2(device, env_h=env_h)
    cfg = RasterConfig(max_instances=1 << 18)
    bg = torch.zeros(3, device=device)
    with torch.no_grad():
        ev = render_view_svgss(cam, state["params"], bake, env, bg,
                               is_training=False, alive=state["alive"],
                               cfg=cfg)
    p = {k: v.clone().requires_grad_(True)
         for k, v in state["params"].items()}
    e = env["env"].clone().requires_grad_(True)
    opt = OptimizationConfig(lambda_base_color_smooth=0.1,
                             lambda_roughness_smooth=0.05,
                             lambda_env_smooth=0.02)
    r = render_svgss(cam, p, bg, bake=bake, env_params={"env": e}, opt=opt,
                     is_training=True, alive=state["alive"], cfg=cfg)
    names = list(p)
    grads = torch.autograd.grad(r["loss"], [p[k] for k in names] + [e],
                                allow_unused=True)
    out = {k: g for k, g in zip(names + ["env"], grads) if g is not None}
    return ev, r, out


# ---------------------------------------------------------------------------
# the radiance bake
# ---------------------------------------------------------------------------

BAKE_SAMPLES = 64       # train_stage2's sample_num (--sample_num 64)
BAKE_ENV_H = 32         # the recipe's --env_resolution 32 (train_stage2's
                        # and the configuration's default is 16)
# Float operations of B8 (csrc/march.cu), an exp or division counting one:
# a candidate test (the plane hit, its local uv and ellipse metric, the
# power's six products and sums, alpha and the eight acceptance tests with
# their conjunction) and a step of the cell walk (the midpoint and the
# three clamped cell coordinates).  The merge's inserts are not counted.
MARCH_TEST_OPS = 84
MARCH_STEP_OPS = 33


class Recorder:
    """Wraps ``mod.name`` while open: records each call's arguments,
    result and wall seconds (synchronized on both sides); with ``keep``,
    only the first ``keep`` calls (``secs`` has every call's seconds, and
    ``seen`` every call's ``inspect(result)``)."""

    def __init__(self, mod, name, keep=None, inspect=None):
        self.mod, self.name, self.calls = mod, name, []
        self.keep, self.secs = keep, []
        self.inspect, self.seen = inspect, []

    def __enter__(self):
        import torch
        self.fn = getattr(self.mod, self.name)

        def rec(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.fn(*a, **kw)
            torch.cuda.synchronize()
            self.secs.append(time.perf_counter() - t0)
            if self.inspect is not None:
                self.seen.append(self.inspect(out))
            if self.keep is None or len(self.calls) < self.keep:
                self.calls.append((a, kw, out, self.secs[-1]))
            return out
        setattr(self.mod, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.fn)


def march_work(grid, o, d, t, *, n_steps, kmax, k):
    """The work B8's function needs on rays (o, d) whose result is t
    [R, k]: the visits before the walk may stop (a full list whose k-th t
    lies at or before the visit's start: nothing later can enter), the
    steps walked to there, and the distinct blocks and cells those visits
    read."""
    import torch

    from svgir_tpu_torch.ops import grid_tracer as GT
    nb, _, cells = GT._run_scan(grid, o, d, n_steps=n_steps, kmax=kmax)
    j = torch.arange(n_steps, device=o.device)
    t_lo = j.to(torch.float32) * GT.grid_dt(grid)
    kth = torch.where(torch.isfinite(t[:, k - 1]), t[:, k - 1],
                      torch.full_like(t[:, 0], float("inf")))
    late = (nb > 0) & ~(t_lo[None] < kth[:, None])
    stop = torch.where(late.any(1), late.to(torch.int32).argmax(1),
                       torch.full_like(j[:1], n_steps).expand(len(o)))
    needed = (nb > 0) & (j[None] < stop[:, None])
    cells_u = torch.unique(cells[needed])
    cnt = torch.clamp(grid.cell_count[cells_u.long()], max=grid.cell_cap)
    return {"blocks": int((nb * needed).sum()), "all_blocks": int(nb.sum()),
            "steps": int(stop.sum()), "cells": int(cells_u.numel()),
            "distinct_blocks": int(((cnt + 63) // 64).sum())}


def march_bound(work, r, k):
    """Least time (ms) of B8 on ``work``: the 24 fields the test reads of
    each distinct block (6 KB) and its cell's two entries read once, each
    ray's 24 bytes read and its k hits (8 bytes each) written once; the
    needed candidate tests and walk steps at the float32 rate."""
    nbytes = work["distinct_blocks"] * 24 * 64 * 4 + work["cells"] * 8 \
        + r * (24 + 8 * k)
    ops = work["blocks"] * 64 * MARCH_TEST_OPS + work["steps"] * MARCH_STEP_OPS
    tb, to = nbytes / HBM_BYTES_S * 1e3, ops / FP32_OPS_S * 1e3
    return max(tb, to), "bytes" if tb >= to else "operations"


def small_bake_inputs(n=3000, seed=5):
    """bake_radiance inputs of a small scene made on the CPU from a seeded
    generator: surfels on a thin ball shell facing its centre (normals
    more than 60 degrees from -z, where rotation_between_z divides by
    1 + n_z), SH colours, and the spirals' azimuth draws."""
    import torch

    from svgir_tpu_torch.models import gaussians as G
    from svgir_tpu_torch.utils.transforms import normalize

    g = torch.Generator().manual_seed(seed)
    d = normalize(torch.randn(2 * n, 3, generator=g))
    d = d[d[:, 2] < 0.5][:n]
    pts = d * (0.3 + 0.05 * torch.rand(len(d), 1, generator=g))
    st = G.init_from_points(pts, torch.rand(len(d), 3, generator=g),
                            normals=-d, capacity=len(d),
                            rotation_init="normal", device="cpu")
    p = st["params"]
    shs = 0.3 * torch.randn(len(d), 16, 3, generator=g)
    az = torch.rand(len(d), 1, generator=g)
    return (p["xyz"], G.get_scaling(p), G.get_rotation(p),
            G.get_opacity(p)[:, 0], shs), az


def run_bake(state, cam, opt, cfg, bg, card, dev, parents=(),
             profile_dir=None):
    """Phases 12-16; returns B8's and B7's entries of the kernels JSON (the
    main path's first chunk, and the inward bench bake's), and the
    arguments of the S = 64 step on the main path's bake.  With
    ``profile_dir``, also writes the profile of one S = 64 step there;
    with ``parents``, times their B7 backward and B8 in turns."""
    import torch

    from svgir_tpu_torch import kernels
    from svgir_tpu_torch.config import RasterConfig
    from svgir_tpu_torch.kernels import env_lookup as KE
    from svgir_tpu_torch.models import gaussians as G
    from svgir_tpu_torch.models import radiance as RAD
    from svgir_tpu_torch.ops import env_lookup_pallas as EP
    from svgir_tpu_torch.ops import grid_tracer as GT
    from svgir_tpu_torch.ops import march_pallas as MP
    from svgir_tpu_torch.ops import tracing as TR
    from svgir_tpu_torch.render.stage1 import render_view_stage1
    from svgir_tpu_torch.train import optim, trainer

    # ---- 12. bake + train: train_stage2(bake=None) (main path) ----------
    pbr = G.upgrade_to_pbr(state)
    steps = 3
    torch.cuda.synchronize()
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with Recorder(trainer, "bake_radiance_compact") as rc, \
            Recorder(GT, "nearest_hits_grid") as rg:
        st3, _, env3, bake3, hist3 = trainer.train_stage2(
            pbr, [cam], opt, raster_cfg=cfg, sample_num=BAKE_SAMPLES,
            env_resolution=BAKE_ENV_H, first_iter=30_000,
            iterations=30_000 + steps, log_every=1, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    peak_all = torch.cuda.max_memory_allocated()
    (_, bkw, bake_out, bake_s), = rc.calls
    exhausted = float(bake_out["exhausted_frac"])
    hits = bake3["hit_idx"]
    log(f"[bake+train] train_stage2(bake=None), {int(state['alive'].sum())} "
        f"surfels x S={BAKE_SAMPLES}: bake {bake_s:.3f} s (cold: kernel load, grid "
        f"build, {len(rg.calls)} ray chunks whose grid tracing took "
        f"{sum(c[3] for c in rg.calls):.3f} s), exhausted_frac {exhausted:.6f},"
        f" rays with a first hit {float((hits >= 0).float().mean()):.4f}, "
        f"mean visibility {float(bake3['visibility'].mean()):.4f}; "
        f"{steps} steps: " + ", ".join(
            f"loss {h['loss']:.6f} psnr_pbr {h['psnr_pbr']:.4f}"
            for h in hist3) + f"; wall {wall:.3f} s, peak memory "
        f"{peak_all / 2**30:.3f} GiB; card: {card}")
    log(f"[bake+train] launches {launches}")
    if launches["march"] < 1:
        raise AssertionError("the bake did not launch the march kernel")
    for k in STAGE2_KERNELS:
        if launches[k] < steps:
            raise AssertionError(f"bake+train launched {k} {launches[k]} "
                                 f"times in {steps} steps")
    if tuple(hits.shape) != (state["alive"].shape[0], BAKE_SAMPLES):
        raise AssertionError(f"bake: hit_idx of shape {tuple(hits.shape)}")
    for k in ("radiance", "visibility", "uv", "incident_qxy"):
        if not bool(torch.isfinite(bake3[k]).all()):
            raise AssertionError(f"bake: non-finite {k}")
    if any(not math.isfinite(h["loss"]) or h.get("overflow")
           for h in hist3):
        raise AssertionError(f"bake+train: bad step {hist3}")
    for k, v in list(st3["params"].items()) + \
            [("env", env3["params"]["env"]),
             ("env m", env3["opt"]["m"]["env"]),
             ("env v", env3["opt"]["v"]["env"])]:
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"bake+train: non-finite values in {k}")

    step3 = trainer.make_svgss_train_step(
        opt, cfg, bg, lrs=optim.group_lrs(opt, 1.0, use_pbr=True),
        device=dev)
    s3_args = (st3, optim.adam_init(st3["params"]), env3, bake3, cam, 1.0,
               1e-5, opt.radiance_lr)
    step3(*s3_args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step3(*s3_args)
    torch.cuda.synchronize()
    peak_step = torch.cuda.max_memory_allocated()
    step_ms = host_ms(lambda: step3(*s3_args), reps=5, warmup=1)
    log(f"[bake+train] S={BAKE_SAMPLES} stage-2 train step {step_ms:.3f} ms"
        f" (median of 5), peak memory {peak_step / 2**30:.3f} GiB "
        f"(max_memory_allocated); card: {card}")
    if profile_dir:
        profile_step(lambda: step3(*s3_args), profile_dir,
                     "chip_smoke_profile_stage2_s64.txt")
    # B7 on the bench scene's S = 64 step (50,000 rows x 64: 3.2M
    # queries, a tenth of the recipe's; phase 35 runs the recipe's size)
    with Capture() as cap64:
        step3(*s3_args)
    torch.cuda.synchronize()
    c64 = cap64.calls
    env_label = (f"S = {BAKE_SAMPLES} step, env {BAKE_ENV_H}x"
                 f"{2 * BAKE_ENV_H}")
    e7 = compare_env(c64, env_label)
    fa64, _ = c64["env_lookup_forward"]
    ba64, bkw64 = c64["env_lookup_backward"]
    bnd64 = env_bounds(fa64)
    b7_entries = []
    for i, (name, kfn, pfn, lfn) in enumerate((
            ("env_lookup_forward", lambda: KE.env_lookup_forward(*fa64),
             lambda: EP.env_lookup_forward_plain(*fa64),
             library_env_forward(fa64)),
            ("env_lookup_backward",
             lambda: KE.env_lookup_backward(*ba64, **bkw64),
             lambda: EP.env_lookup_backward_plain(*ba64, **bkw64),
             library_env_backward(c64)))):
        with torch.no_grad():
            t = timings(kfn, pfn, lfn)
        bd = bnd64[name]
        b7_entries.append({
            "name": f"{name}_s64", "route": "cuda",
            "source": "svgir_tpu_torch/csrc/env_lookup.cu",
            "replaces": "svgir_tpu/ops/env_lookup_pallas.py:"
            + ("63" if i == 0 else "76"), "launches": launches[name],
            "max_abs_err": e7[i], **t, "bound_ms": bd[0], "bound_by": bd[1]})
        log(f"[bake timing] {name} on the bench scene's 50,000 rows "
            f"({env_label}, {fa64[1].numel()} queries): "
            + fmt_times(t, "grid_sample")
            + f", bound {bd[0]:.4f} ms by {bd[1]}; {launches[name]} "
            f"launches in the bake and {steps} steps; card: {card}")
    times = parent_env_backward(parents, ba64, bkw64, env_label, card)
    if times:
        b7_entries[1]["parent"] = times

    # ---- the bench scene turned inward: a full-size bake whose rays hit --
    # The main path's surfels face outward, so none of its rays meets a
    # front face.  The same 50,000 surfels facing the centre, baked at
    # S = 64 and k 16, give B8 (13), the oracle (14) and the timings (16)
    # chunks of the main path's size and grid size in which lists fill.
    in_state, _ = bench_scene(dev, inward=True)
    p_in = in_state["params"]
    in_inputs = (p_in["xyz"], G.get_scaling(p_in), G.get_rotation(p_in),
                 G.get_opacity(p_in)[:, 0], G.get_shs(p_in))
    in_kw = dict(sample_num=BAKE_SAMPLES, k_hits=16, azimuth=torch.rand(
        p_in["xyz"].shape[0], 1, device=dev,
        generator=torch.Generator(device=dev).manual_seed(7)))
    with Recorder(GT, "nearest_hits_grid") as ri:
        b_in = RAD.bake_radiance(*in_inputs, **in_kw)
    in_hit = float((b_in["hit_idx"] >= 0).float().mean())
    log(f"[inward] the bench surfels facing inward, bake_radiance at S="
        f"{BAKE_SAMPLES}, k 16: {len(ri.calls)} ray chunks, rays with a "
        f"first hit {in_hit:.4f}, exhausted_frac "
        f"{float(b_in['exhausted_frac']):.6f}, mean visibility "
        f"{float(b_in['visibility'].mean()):.4f}")
    if in_hit == 0.0:
        raise AssertionError("inward bake: no ray has a first hit")
    for key in ("radiance", "visibility", "uv"):
        if not bool(torch.isfinite(b_in[key]).all()):
            raise AssertionError(f"inward bake: non-finite {key}")
    # one S = 64 step on this bake (hit rows spread over the surfels)
    bake_in = {x: v for x, v in b_in.items() if x != "exhausted_frac"}
    st_in = G.upgrade_to_pbr(in_state)
    prm = dict(st_in["params"])
    prm["radiances"] = bake_in["radiance"].clone()
    prm["radiance_ratio"] = torch.ones((), device=dev)
    st_in = {**st_in, "params": prm, "stats": in_state["stats"]}
    in_args = (st_in, optim.adam_init(prm), env3, bake_in, cam, 1.0, 1e-5,
               opt.radiance_lr)
    # the inward surfels cover more tiles: the cap is sized from their own
    # forward render as phase 2 sizes the main path's
    with torch.no_grad(), Capture() as cap_in:
        render_view_stage1(cam, p_in, bg, alive=in_state["alive"],
                           cfg=RasterConfig())
    padded_in = int(cap_in.calls["blend_forward"][0][2].sum())
    cfg_in = RasterConfig(max_instances=-(-padded_in * 21 // (20 * 2048))
                          * 2048)
    step_in = trainer.make_svgss_train_step(
        opt, cfg_in, bg, lrs=optim.group_lrs(opt, 1.0, use_pbr=True),
        device=dev)
    tb_in = step_in(*in_args)[3]
    if not math.isfinite(float(tb_in["loss"])) or bool(tb_in["overflow"]):
        raise AssertionError(f"inward S={BAKE_SAMPLES} step: loss "
                             f"{float(tb_in['loss'])}, overflow "
                             f"{bool(tb_in['overflow'])}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_in(*in_args)
    torch.cuda.synchronize()
    peak_in = torch.cuda.max_memory_allocated()
    step_in_ms = host_ms(lambda: step_in(*in_args), reps=5, warmup=1)
    log(f"[inward] S={BAKE_SAMPLES} stage-2 train step on the inward bake "
        f"{step_in_ms:.3f} ms at cap {cfg_in.max_instances} ({padded_in} "
        f"padded instances; median of 5; the main path's bake: "
        f"{step_ms:.3f} ms at cap {cfg.max_instances}), peak memory "
        f"{peak_in / 2**30:.3f} GiB; card: {card}")
    if profile_dir:
        profile_step(lambda: step_in(*in_args), profile_dir,
                     "chip_smoke_profile_stage2_s64_inward.txt")

    # ---- 13. B8 against its plain version ---------------------------------
    # on the first ray chunk of the main path's bake (no hits), of the
    # inward bake (lists fill and merge at full size), and on a small
    # bake's rays (surfels facing inward) at every k the kernel takes
    (geo, grid, o, d), hkw, _, _ = rg.calls[0]
    k = hkw["k"]
    mkw = dict(t_max=hkw["t_max"], k=k, n_steps=hkw["n_steps"],
               kmax=GT._run_kmax(grid))
    (geo_i, grid_i, o_i, d_i), ikw, _, _ = ri.calls[0]
    imkw = dict(t_max=ikw["t_max"], k=ikw["k"], n_steps=ikw["n_steps"],
                kmax=GT._run_kmax(grid_i))
    inputs, az = small_bake_inputs()
    kw = dict(sample_num=16, use_grid=True)
    with Recorder(GT, "nearest_hits_grid") as rs:
        b_dev = RAD.bake_radiance(*[x.to(dev) for x in inputs],
                                  azimuth=az.to(dev), **kw)
    (_, grid_s, o_s, d_s), skw, _, _ = rs.calls[0]
    smkw = dict(t_max=skw["t_max"], k=skw["k"], n_steps=skw["n_steps"],
                kmax=GT._run_kmax(grid_s))
    cases = {"bench chunk": (grid, o, d, mkw),
             "inward bench chunk": (grid_i, o_i, d_i, imkw),
             "small bake": (grid_s, o_s, d_s, smkw)}
    # the kernel's other register layouts and the re-bake's doubled k
    for kk in (8, 32, 64, 128):
        cases[f"small bake, k {kk}"] = (grid_s, o_s[:8192], d_s[:8192],
                                        {**smkw, "k": kk})
    err, err_i = 0.0, 0.0
    for label, (g_, o_, d_, kw_) in cases.items():
        with torch.no_grad():
            kt, ki = MP.march(g_, o_, d_, **kw_)
            pt, pi = MP.march_plain(g_, o_, d_, **kw_)
        torch.cuda.synchronize()
        fin = torch.isfinite(pt)
        bad = int(((ki != pi) | (torch.isfinite(kt) != fin)
                   | (fin & (kt != pt))).sum())
        n_fin = int(fin.sum())
        both = fin & torch.isfinite(kt)
        e = float((kt - pt)[both].abs().max()) if bool(both.any()) else 0.0
        err = max(err, e)
        log(f"[march] B8 vs plain, {label}: {len(o_)} rays (grid res "
            f"{g_.res}, cap {g_.cell_cap}, {g_.block_geo.shape[0] - 1} "
            f"blocks, {g_.big_ids.shape[0]} big surfels, n_steps "
            f"{kw_['n_steps']}, kmax {kw_['kmax']}, k {kw_['k']}): {n_fin} "
            f"finite slots, {int(fin[:, -1].sum())} full lists, {bad} slots"
            f" differ, max|t err| {e:.3g}")
        if bad > MARCH_SLOT_TOL * max(n_fin, 1):
            raise AssertionError(f"B8 differs from its plain version at "
                                 f"{bad} of {n_fin} finite slots")
        if label == "bench chunk":
            bench_t = pt
        elif label == "inward bench chunk":
            in_t, err_i = pt, e
            if n_fin < 0.25 * pt.numel():
                raise AssertionError(f"the inward chunk has only {n_fin} "
                                     "finite slots")
        elif label == "small bake":
            small_t = pt

    # ---- 14. the grid march (B8) against the brute oracle ---------------
    # on the 4,096 rays with the most hits of the bench chunk, the inward
    # bench chunk and the small bake (the main path's bench surfels face
    # outward: their rays meet only back faces, which the hit test rejects)
    geo_s = TR.build_surfel_geometry(*[x.to(dev) for x in inputs[:4]])
    for label, (geo_, g_, o_, d_, kw_, t_) in {
            "bench chunk": (geo, grid, o, d, hkw, bench_t),
            "inward bench chunk": (geo_i, grid_i, o_i, d_i, ikw, in_t),
            "small bake": (geo_s, grid_s, o_s, d_s, skw, small_t)}.items():
        sel = torch.argsort(torch.isfinite(t_).sum(1), descending=True,
                            stable=True)[:4096]
        with torch.no_grad():
            hg = GT.nearest_hits_grid(geo_, g_, o_[sel], d_[sel],
                                      t_max=kw_["t_max"], k=kw_["k"],
                                      n_steps=kw_["n_steps"])
            hb = TR.nearest_hits(geo_, o_[sel], d_[sel], k=kw_["k"])
        torch.cuda.synchronize()
        fb = torch.isfinite(hb["t"])
        bad_o = int(((fb != torch.isfinite(hg["t"]))
                     | (fb & ((hg["idx"] != hb["idx"])
                              | (hg["t"] != hb["t"])))).sum())
        log(f"[oracle] grid march (B8) vs brute, {label}, 4096 rays: "
            f"{int(fb.sum())} finite slots, {bad_o} differ")
        if label != "bench chunk" and not bool(fb.any()):
            raise AssertionError(f"oracle: no hits on the {label}")
        if bad_o > MARCH_SLOT_TOL * max(int(fb.sum()), 1):
            raise AssertionError(f"grid march differs from brute at {bad_o}"
                                 f" slots ({label})")

    # ---- 15. the small bake on the card against the CPU's plain path ----
    # a ray differs when its first hit does or its radiance, visibility or
    # uv is off by more than BAKE_VAL_TOL (a later hit can flip at an
    # acceptance boundary between the devices' roundings)
    b_cpu = RAD.bake_radiance(*inputs, azimuth=az, **kw)
    off = b_dev["hit_idx"].cpu() != b_cpu["hit_idx"]
    for key in ("radiance", "visibility", "uv"):
        off |= ((b_dev[key].cpu() - b_cpu[key]).abs()
                > BAKE_VAL_TOL).any(-1)
    n_rays = off.numel()
    worst = max(float((b_dev[key].cpu() - b_cpu[key]).abs()[~off].max())
                for key in ("radiance", "visibility", "uv"))
    log(f"[bake parity] {inputs[0].shape[0]} surfels x 16: card vs CPU "
        f"differ on {int(off.sum())} of {n_rays} rays "
        f"({int((b_cpu['hit_idx'] >= 0).sum())} with a first hit); the "
        f"others within {worst:.3g}")
    if int(off.sum()) > BAKE_HIT_TOL * n_rays:
        raise AssertionError("bake parity: card and CPU bakes differ")

    # ---- 16. timing ------------------------------------------------------
    params, alive = rc.calls[0][0]
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    trainer.bake_radiance_compact(params, alive, **bkw)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    per_bake = kernels.launches()["march"]
    if profile_dir:
        profile_step(lambda: trainer.bake_radiance_compact(params, alive,
                                                           **bkw),
                     profile_dir, "chip_smoke_profile_bake.txt", steps=1)
    with torch.no_grad():
        tb = timings(lambda: MP.march(grid, o, d, **mkw),
                     lambda: MP.march_plain(grid, o, d, **mkw), reps=10,
                     plain_reps=2)
    work = march_work(grid, o, d, bench_t, **{x: mkw[x] for x in
                                              ("n_steps", "kmax", "k")})
    bms, by = march_bound(work, len(o), k)
    log(f"[bake timing] warm bake {warm_s:.3f} s ({per_bake} B8 launches, "
        f"{len(o)} rays each but the last); B8 {fmt_times(tb)}, bound "
        f"{bms:.4f} ms by {by}; the chunk's "
        f"rays visit {work['all_blocks']} blocks, {work['blocks']} before "
        f"their lists are settled, {work['distinct_blocks']} distinct; "
        f"card: {card}")
    # the inward bench bake: warm, and B8 on its first chunk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    RAD.bake_radiance(*in_inputs, **in_kw)
    torch.cuda.synchronize()
    warm_in_s = time.perf_counter() - t0
    with torch.no_grad():
        tb_i = timings(lambda: MP.march(grid_i, o_i, d_i, **imkw),
                       lambda: MP.march_plain(grid_i, o_i, d_i, **imkw),
                       reps=10, plain_reps=2)
    work_i = march_work(grid_i, o_i, d_i, in_t,
                        **{x: imkw[x] for x in ("n_steps", "kmax", "k")})
    bms_i, by_i = march_bound(work_i, len(o_i), imkw["k"])
    log(f"[bake timing] inward bench bake (k 16): warm {warm_in_s:.3f} s; "
        f"B8 on its first chunk {fmt_times(tb_i)}, bound "
        f"{bms_i:.4f} ms by {by_i}; the chunk's rays visit "
        f"{work_i['all_blocks']} blocks, {work_i['blocks']} before their "
        f"lists are settled, {work_i['distinct_blocks']} distinct; grid res "
        f"{grid_i.res}, cap {grid_i.cell_cap}; card: {card}")
    # the brute and the grid tracer on each side of bake_radiance's switch
    # (the grid from 4,096 surfels)
    for n_s, seed in ((3000, 5), (6000, 6)):
        inp, az_s = small_bake_inputs(n=n_s, seed=seed)
        inp, az_s = [x.to(dev) for x in inp], az_s.to(dev)
        t_b = {ug: host_ms(lambda: RAD.bake_radiance(
            *inp, azimuth=az_s, sample_num=BAKE_SAMPLES, use_grid=ug),
            reps=3, warmup=1) for ug in (False, True)}
        log(f"[bake timing] bake_radiance of {inp[0].shape[0]} inward "
            f"surfels x S={BAKE_SAMPLES}: brute {t_b[False]:.3f} ms, grid "
            f"{t_b[True]:.3f} ms (median of 3, warm); card: {card}")
    entry = {"route": "cuda", "source": "svgir_tpu_torch/csrc/march.cu",
             "replaces": "svgir_tpu/ops/march_pallas.py:66",
             "launches": launches["march"]}
    b8 = [{"name": "march", **entry, "max_abs_err": err, **tb,
           "bound_ms": bms, "bound_by": by},
          {"name": "march_inward_bench", **entry, "max_abs_err": err_i,
           **tb_i, "bound_ms": bms_i, "bound_by": by_i}]
    # B8 against each --parent tree's, in turns, on both chunks
    for e, (g_, o_, d_, kw_, label) in zip(b8, (
            (grid, o, d, mkw, "no-hit chunk"),
            (grid_i, o_i, d_i, imkw, "inward chunk"))):
        times = parent_march(parents, g_, o_, d_, kw_, label, card)
        if times:
            e["parent"] = times
    return b8 + b7_entries, s3_args


# ---------------------------------------------------------------------------
# the tile-major paths: strip 0 and the sort binner (B5, B6), and B9
# ---------------------------------------------------------------------------

# The port's dense oracle against its tiled paths on the card: the oracle
# walks the Gaussians in depth-ordered batches, the kernels per pixel in
# order, so sums differ by float32 rounding; past saturation the oracle's
# logT keeps falling where a tile stops at its exit chunk (ROADMAP C-7), so
# T (below 1e-4 there) and the images through it differ by up to 1e-4 of the
# background; n_contrib may flip where logT crosses the 1e-4 gate at another
# instance.
TOL_DENSE_IMG = 2e-4    # absolute
TOL_DENSE_REL = 1e-3    # depth (where opacity > 0.05) and weights, of max
TOL_DENSE_NC = 1e-3     # share of pixels whose n_contrib may differ
B9_KOUT = 128           # the reference's lane width: stage-1 KR -> 128


def compare_tiles(calls, label):
    """B5/B6 kernel vs plain on the captured inputs, and against B3/B4 on
    the same inputs: B5's output assembled to image layout against B3's
    image and eff, B6's rows against B4's on the same cotangents and logT
    re-laid as images.  Returns (B5 max error, B6 max error or None)."""
    import torch

    from svgir_tpu_torch.kernels import blend as K
    from svgir_tpu_torch.ops import blend_pallas as BP

    with torch.no_grad():
        a, kw = calls["blend_forward_tiles"]
        ca, cv = kw["ca"], kw["cv"]
        nch = ca + cv
        lay = dict(grid_x=kw["grid_x"], grid_y=kw["grid_y"], tile=kw["tile"])
        ko, kws = K.blend_forward_tiles(*a, **kw)
        po, pws = BP.blend_forward_plain(*a, **kw)
        bi, be, bws = K.blend_forward(*a, **kw)
        torch.cuda.synchronize()
        if not torch.equal(ko[:, nch + 2], po[:, nch + 2]):
            raise AssertionError(f"B5 [{label}] chunks processed differ from "
                                 "the plain version's")
        ki = BP.to_image(ko[:, :nch + 2], **lay)
        e_img, e_lt, nc_bad = check_image(
            ki, BP.to_image(po[:, :nch + 2], **lay), nch, f"B5 [{label}]")
        err_w = 0.0
        if kws is not None:
            err_w = max_err_rel(kws, pws)
            if err_w > TOL_ROWS or max_err_rel(kws, bws) > TOL_ROWS:
                raise AssertionError(f"B5 [{label}] weight sums differ: "
                                     f"{err_w}")
        if not torch.equal(ko[:, nch + 2, 0].to(torch.int32), be):
            raise AssertionError(f"B5 [{label}] chunks processed differ from "
                                 "B3's eff")
        x_img, x_lt, _ = check_image(ki, bi, nch, f"B5 vs B3 [{label}]")
        if not torch.equal(ki, bi) or (kws is not None and
                                       not torch.equal(kws, bws)):
            raise AssertionError(f"B5 [{label}] is not bit-equal to B3")
        msg = (f"[kernels] {label}: B5 max|err| img {e_img:.3g} logT "
               f"{e_lt:.3g} wsum(rel) {err_w:.3g}, n_contrib mismatches "
               f"{nc_bad}; assembled against B3: img {x_img:.3g} logT "
               f"{x_lt:.3g}, eff equal, bit-equal")
        err5 = max(e_img, e_lt, err_w)
        if "blend_backward_tiles" not in calls:      # a forward-only render
            log(msg)
            return err5, None
        b, bkw = calls["blend_backward_tiles"]
        kd = K.blend_backward_tiles(*b, **bkw)
        pd = BP.blend_backward_plain(*b, **bkw)
        slab, ts, g_out, meta, g_wsum = b
        d4 = K.blend_backward(
            slab, ts, meta[:, 2, 0].to(torch.int32).contiguous(),
            BP.to_image(g_out[:, :nch + 1], **lay).contiguous(),
            BP.to_image(meta[:, :1], **lay)[0].contiguous(), g_wsum, **bkw)
        torch.cuda.synchronize()
    err6 = check_rows(kd, pd, ca, f"B6 [{label}]")
    x6 = check_rows(kd, d4, ca, f"B6 vs B4 [{label}]")
    if not torch.equal(kd, d4):
        raise AssertionError(f"B6 [{label}] is not bit-equal to B4")
    log(msg + f"; B6 max|err| {err6:.3g}, against B4 {x6:.3g}")
    return err5, err6


def check_launches(launches, label, *, at_least=(), none=()):
    """Raise unless each kernel of ``at_least`` ((name, count) pairs) was
    launched that often and none of ``none`` was launched."""
    for k, n in at_least:
        if launches[k] < n:
            raise AssertionError(f"{label} launched {k} {launches[k]} times, "
                                 f"expected at least {n}")
    for k in none:
        if launches[k]:
            raise AssertionError(f"{label} launched {k} {launches[k]} times "
                                 "(another path than the one asked for)")


def run_tiles(state, cam, opt, cfg, bg, card, dev, *, step8, s2,
              edge_calls, ptx, parents, profile_dir=None):
    """Phases 17-23; returns the kernels JSON entries of B5, B6 and B9.
    ``step8`` is the strip-8 stage-1 step with its arguments, ``s2`` the
    stage-2 inputs with the strip-8 stage-2 step and its arguments."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from svgir_tpu_torch import kernels
    from svgir_tpu_torch.config import RasterConfig
    from svgir_tpu_torch.kernels import blend as KBL
    from svgir_tpu_torch.kernels import cols as KC
    from svgir_tpu_torch.ops import binning as BN
    from svgir_tpu_torch.ops import blend_pallas as BP
    from svgir_tpu_torch.ops.dense_ref import render_dense
    from svgir_tpu_torch.ops.preprocess import preprocess
    from svgir_tpu_torch.render.stage1 import render_view_stage1
    from svgir_tpu_torch.render.svgss import render_view_svgss
    from svgir_tpu_torch.train import optim, trainer

    cfg0 = dataclasses.replace(cfg, strip=0)
    strip_kernels = ("blend_forward", "blend_backward")
    steps = 5
    t_tiles = time.time()

    # ---- 17. strip-0 train: train_stage1 with RasterConfig(strip=0) ------
    torch.cuda.synchronize()
    kernels.reset_launches()
    st, ost, hist = trainer.train_stage1(
        state, [cam], opt, raster_cfg=cfg0, iterations=steps, log_every=1,
        device=dev)
    torch.cuda.synchronize()
    l17 = kernels.launches()
    log(f"[strip0 train] {steps} steps at cap {cfg0.max_instances}: " +
        ", ".join(f"it {h['iter']} loss {h['loss']:.6f} psnr {h['psnr']:.4f}"
                  for h in hist))
    log(f"[strip0 train] launches {l17}")
    for h in hist:
        if not math.isfinite(h["loss"]) or h.get("overflow"):
            raise AssertionError(f"strip-0 train: bad step {h}")
    for k, v in list(st["params"].items()) + list(ost["m"].items()) + \
            list(ost["v"].items()):
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"strip-0 train: non-finite values in {k}")
    check_launches(l17, "strip-0 train", at_least=(
        ("binning_counts", 1), ("binning_instances", 1),
        ("blend_forward_tiles", steps), ("blend_backward_tiles", steps)),
        none=strip_kernels)

    # ---- 18. strip-0 kernels: B5/B6 against plain and against B3/B4 -----
    step0 = trainer.make_train_step(opt, cfg0, bg,
                                    lrs=optim.group_lrs(opt, 1.0), device=dev)
    s1_args = (state, optim.adam_init(state["params"]), cam, 1.0, 1.6e-4)
    with Capture() as cap0:
        step0(*s1_args)
    torch.cuda.synchronize()
    c0 = cap0.calls
    if any(k in c0 for k in strip_kernels):
        raise AssertionError("the strip-0 step called the image-layout blend")
    e5, e6 = compare_tiles(c0, "strip 0, bench step")
    compare_binning(c0)
    for (name, tile), ec in edge_calls.items():
        compare_tiles(ec, f"edge inputs {name}, tile {tile}")

    # ---- 19. stage 2 at strip 0: five S = 24 steps and an eval render ----
    s2_state, bake, env0, step2_8, s2_args8 = s2
    step2_0 = trainer.make_svgss_train_step(
        opt, cfg0, bg, lrs=optim.group_lrs(opt, 1.0, use_pbr=True),
        device=dev)
    st2 = {**s2_state, "stats": state["stats"]}
    ost2, env2 = optim.adam_init(st2["params"]), env0
    torch.cuda.synchronize()
    kernels.reset_launches()
    s2_hist = []
    for i in range(steps):
        st2, ost2, env2, tb2 = step2_0(st2, ost2, env2, bake, cam, 100.0 + i,
                                       1e-5, opt.radiance_lr)
        s2_hist.append((float(tb2["loss"]), bool(tb2["overflow"])))
    torch.cuda.synchronize()
    l19 = kernels.launches()
    log(f"[strip0 s2 train] {steps} steps: losses "
        f"{[round(x, 6) for x, _ in s2_hist]}; launches {l19}")
    if any(not math.isfinite(x) or o for x, o in s2_hist):
        raise AssertionError(f"strip-0 stage-2 train: bad step {s2_hist}")
    for k, v in list(st2["params"].items()) + [("env",
                                                env2["params"]["env"])]:
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"strip-0 stage-2 train: non-finite {k}")
    check_launches(l19, "strip-0 stage-2 train", at_least=(
        ("blend_forward_tiles", steps), ("blend_backward_tiles", steps),
        ("env_lookup_forward", steps), ("env_lookup_backward", steps)),
        none=strip_kernels)
    s2_args0 = ({**s2_state, "stats": state["stats"]},
                optim.adam_init(s2_state["params"]), env0, bake, cam, 100.0,
                1e-5, opt.radiance_lr)
    with Capture() as cap19:
        step2_0(*s2_args0)

    def render_s2(c):
        with torch.no_grad():
            return render_view_svgss(cam, s2_state["params"], bake,
                                     env0["params"], bg, is_training=False,
                                     alive=s2_state["alive"], cfg=c)
    torch.cuda.synchronize()
    kernels.reset_launches()
    with Capture() as cap19e:
        res2 = render_s2(cfg0)
    torch.cuda.synchronize()
    l19e = kernels.launches()
    for k in ("render", "pbr", "pbr_env", "base_color", "direct", "indirect"):
        if tuple(res2[k].shape) != (3, cam.height, cam.width) or \
                not bool(torch.isfinite(res2[k]).all()):
            raise AssertionError(f"strip-0 stage-2 render: bad {k} image")
    check_launches(l19e, "strip-0 stage-2 eval render",
                   at_least=(("blend_forward_tiles", 1),
                             ("env_lookup_forward", 1)), none=strip_kernels)
    widths = [(c.calls["blend_forward_tiles"][1]["ca"],
               c.calls["blend_forward_tiles"][1]["cv"]) for c in (cap19,
                                                                  cap19e)]
    if widths != [(13, 13), (16, 16)]:
        raise AssertionError(f"strip-0 stage-2 blend widths {widths}")
    e5s2, e6s2 = compare_tiles(cap19.calls,
                               "strip 0, stage-2 step CA=13 CV=13")
    e5s2e, _ = compare_tiles(cap19e.calls, "strip 0, stage-2 eval CA=16 CV=16")

    # ---- 20. the sort binner: render_view_stage1(binner="sort") ----------
    cfg_sort = RasterConfig(binner="sort", max_instances=cfg.max_instances)

    def render1(c):
        with torch.no_grad():
            return render_view_stage1(cam, state["params"], bg,
                                      alive=state["alive"], cfg=c)
    torch.cuda.synchronize()
    kernels.reset_launches()
    with Capture() as cap20:
        res_sort = render1(cfg_sort)
    torch.cuda.synchronize()
    l20 = kernels.launches()
    img_s = res_sort["render"]
    if tuple(img_s.shape) != (3, cam.height, cam.width) or \
            not bool(torch.isfinite(img_s).all()):
        raise AssertionError("sort-binner render: bad image")
    if bool(res_sort["overflow"]):
        raise AssertionError("sort-binner render: overflow")
    check_launches(l20, "sort-binner render",
                   at_least=(("blend_forward_tiles", 1),),
                   none=strip_kernels + ("binning_counts",
                                         "binning_instances"))
    img_c = render1(cfg)["render"]
    d_img = (img_s - img_c).abs()
    if not bool((d_img <= TOL_IMG * (1 + img_c.abs())).all()):
        raise AssertionError(f"sort-binner render differs from the counting "
                             f"render by {float(d_img.max())}")
    (prep,), bkw = cap20.calls["bin_instances"]
    prep_cpu = type(prep)(*(x.detach().cpu() for x in prep))
    chunk, cap = cfg_sort.chunk, cfg_sort.max_instances
    b_d = BN.bin_instances(prep, **bkw)
    b_c = BN.bin_instances(prep_cpu, **bkw)
    p_d = BN.pad_to_chunks(b_d, chunk=chunk, max_instances=cap)
    p_c = BN.pad_to_chunks(b_c, chunk=chunk, max_instances=cap)
    cnt = BN.bin_instances_counting(prep, **bkw)
    for label, x, y, fields in (
            ("bin_instances", b_d, b_c, BN.BinnedInstances._fields),
            ("pad_to_chunks", p_d, p_c, BN.PaddedInstances._fields[:-1]),
            ("counting binner", p_d, cnt, ("gaussian_id", "tile_start",
                                           "tile_count", "num_instances"))):
        for f in fields:
            if not torch.equal(getattr(x, f).cpu(), getattr(y, f).cpu()):
                raise AssertionError(f"sort binner on the card: {f} of "
                                     f"{label} differs")
    e5s, _ = compare_tiles(cap20.calls, "sort binner, bench render")
    log(f"[sort] render_view_stage1(binner='sort') at cap {cap}: "
        f"{int(b_d.num_instances)} instances ({int(p_d.num_instances)} "
        f"padded); integers equal to the CPU's (bin_instances, "
        f"pad_to_chunks) and to the counting binner's layout; image within "
        f"{float(d_img.max()):.3g} of the counting render; launches {l20}")

    # ---- 21. small-scene parity: card vs CPU, and vs render_dense --------
    sc_dev, cam_dev = small_scene(dev)
    sc_cpu, cam_cpu = small_scene("cpu")
    small_bg = torch.tensor([0.2, 0.1, 0.4], device=dev)
    for label, c in (("strip 0", RasterConfig(max_instances=1 << 18,
                                              strip=0)),
                     ("sort", RasterConfig(max_instances=1 << 18,
                                           binner="sort"))):
        torch.cuda.synchronize()
        kernels.reset_launches()
        bufs_d, grads_d = run_small(sc_dev, cam_dev, dev, c)
        torch.cuda.synchronize()
        check_launches(kernels.launches(), f"small scene, {label}",
                       at_least=(("blend_forward_tiles", 1),
                                 ("blend_backward_tiles", 1)),
                       none=strip_kernels)
        bufs_c, grads_c = run_small(sc_cpu, cam_cpu, "cpu", c)
        for f in ("color", "depth", "normal", "feature", "vfeature",
                  "opacity"):
            e = max_err_rel(getattr(bufs_d, f).detach().cpu(),
                            getattr(bufs_c, f).detach())
            if e > 1e-4:
                raise AssertionError(f"parity ({label}): {f} differs by {e}")
        for k in grads_c:
            e = max_err_rel(grads_d[k].cpu(), grads_c[k])
            if e > 1e-3:
                raise AssertionError(f"parity ({label}): d{k} differs by {e}")
        with torch.no_grad():
            p = preprocess(
                sc_dev["means"], sc_dev["scales"], sc_dev["quats"],
                cam_dev.world_view, cam_dev.full_proj, cam_dev.camera_center,
                width=cam_dev.width, height=cam_dev.height,
                tanfovx=cam_dev.tanfovx, tanfovy=cam_dev.tanfovy,
                focal_x=cam_dev.focal_x, focal_y=cam_dev.focal_y,
                colors=sc_dev["colors"], cfg=c)
            dense = render_dense(p, sc_dev["opacity"], sc_dev["features"],
                                 sc_dev["vfeatures"], small_bg,
                                 width=cam_dev.width, height=cam_dev.height,
                                 cfg=c)
        worst = max(float((getattr(bufs_d, f).detach()
                           - getattr(dense, f)).abs().max())
                    for f in ("color", "normal", "feature", "vfeature",
                              "opacity", "final_t"))
        if worst > TOL_DENSE_IMG:
            raise AssertionError(f"small scene ({label}) differs from "
                                 f"render_dense by {worst}")
        op = dense.opacity[0] > 0.05
        e_depth = max_err_rel(bufs_d.depth.detach()[0][op], dense.depth[0][op])
        e_w = max_err_rel(bufs_d.weights.detach(), dense.weights)
        nc = int((bufs_d.n_contrib != dense.n_contrib).sum())
        if e_depth > TOL_DENSE_REL or e_w > TOL_DENSE_REL or \
                nc > TOL_DENSE_NC * dense.n_contrib.numel():
            raise AssertionError(f"small scene ({label}) against render_dense:"
                                 f" depth {e_depth}, weights {e_w}, n_contrib "
                                 f"{nc} pixels")
        log(f"[small] {label}: card == CPU (image 1e-4, gradients 1e-3 of "
            f"max); against render_dense on the card: images within "
            f"{worst:.3g}, depth {e_depth:.3g} and weights {e_w:.3g} of max, "
            f"n_contrib differs at {nc} pixels")

    # ---- 22. B9 against its plain versions, bitwise ----------------------
    m9 = -(-cfg.max_instances // 1024) * 1024
    kr = c0["blend_forward_tiles"][0][0].shape[1]
    x9 = torch.randn(m9, kr, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(9))
    kernels.reset_launches()
    kp = KC.pad_cols(x9, B9_KOUT)
    ks = KC.slice_cols(kp, kr)
    same = BP.pad_cols(x9, kr)
    pp = BP.pad_cols_plain(x9, B9_KOUT)
    torch.cuda.synchronize()
    e9 = {"pad_cols": float((kp - pp).abs().max()),
          "slice_cols": float((ks - BP.slice_cols_plain(pp, kr)).abs().max())}
    if not (torch.equal(kp, pp) and torch.equal(ks, BP.slice_cols_plain(pp, kr))
            and torch.equal(ks, x9) and same is x9):
        raise AssertionError("B9 differs from its plain versions")
    check_launches(kernels.launches(), "B9",
                   at_least=(("pad_cols", 1), ("slice_cols", 1)))
    # the slice at its edges: kout 1, kin - 1, an odd kout (4-byte loads),
    # M of one block, and an input 4 bytes off 8-byte alignment
    kx = kp[:1024].contiguous()
    off = torch.empty(1024 * 126 + 1, device=dev)[1:].view(1024, 126)
    off.copy_(kp[:1024, :126])
    for label, xx, ko in (("kout 1", kp, 1), ("kin - 1", kp, B9_KOUT - 1),
                          ("odd kout 13", kp, 13), ("M = 1024", kx, kr),
                          ("4 bytes off alignment", off, 64)):
        got = KC.slice_cols(xx, ko)
        if not torch.equal(got, BP.slice_cols_plain(xx, ko)):
            raise AssertionError(f"B9 slice differs from its plain version "
                                 f"({label}: {tuple(xx.shape)} -> {ko})")
    for p in parents:
        if not (torch.equal(p["pad_cols"](x9, B9_KOUT), kp) and
                torch.equal(p["slice_cols"](kp, kr), ks)):
            raise AssertionError(f"B9 differs from {p['label']}'s")
    log(f"[cols] B9 at M={m9}: pad {kr} -> {B9_KOUT} and slice back equal "
        "to F.pad and the slice copy, bit for bit; the slice also at kout "
        "1, 127 and 13, M = 1024 and on an input off 8-byte alignment")

    # ---- 23. timing --------------------------------------------------------
    step8_fn, step8_args = step8
    t = {}
    for label, fn in (("strip 8", lambda: step8_fn(*step8_args)),
                      ("strip 0", lambda: step0(*s1_args)),
                      ("strip 0 again", lambda: step0(*s1_args)),
                      ("strip 8 again", lambda: step8_fn(*step8_args))):
        t[label] = host_ms(fn, reps=10)
    r = {label: host_ms(lambda: render1(c), reps=10)
         for label, c in (("counting, strip 8", cfg),
                          ("counting, strip 0", cfg0), ("sort", cfg_sort))}
    t2 = {label: host_ms(fn, reps=10) for label, fn in (
        ("stage 2, strip 8", lambda: step2_8(*s2_args8)),
        ("stage 2, strip 0", lambda: step2_0(*s2_args0)),
        ("eval render, strip 8", lambda: render_s2(cfg)),
        ("eval render, strip 0", lambda: render_s2(cfg0)))}
    log(f"[tiles timing] stage-1 train step (median of 10, in turns): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in t.items())
        + "; forward render: " + ", ".join(f"{k} {v:.3f} ms"
                                           for k, v in r.items())
        + "; " + ", ".join(f"{k} {v:.3f} ms" for k, v in t2.items())
        + f"; cap {cfg.max_instances}; card: {card}")
    if profile_dir:
        profile_step(lambda: step0(*s1_args), profile_dir,
                     "chip_smoke_profile_strip0.txt")

    bnd = bounds(c0, tiles=True)
    bnd2 = bounds(cap19.calls, tiles=True)
    bnd2e = bounds(cap19e.calls, tiles=True)
    bnd_s = bounds(cap20.calls, tiles=True)
    src_f = "svgir_tpu_torch/csrc/blend_forward.cu"
    src_b = "svgir_tpu_torch/csrc/blend_backward.cu"
    rep_f, rep_b = ("svgir_tpu/ops/blend_pallas.py:197",
                    "svgir_tpu/ops/blend_pallas.py:429")
    fw, bw = "blend_forward_tiles", "blend_backward_tiles"
    timed = {}
    for name, calls, bd, lc, ef, eb in (
            ("", c0, bnd, l17, e5, e6),
            ("_stage2", cap19.calls, bnd2, l19, e5s2, e6s2),
            ("_stage2_eval", cap19e.calls, bnd2e, l19e, e5s2e, None),
            ("_sort", cap20.calls, bnd_s, l20, e5s, None)):
        a5, kw5 = calls[fw]
        timed[fw + name] = (
            lambda a5=a5, kw5=kw5: KBL.blend_forward_tiles(*a5, **kw5),
            lambda a5=a5, kw5=kw5: BP.blend_forward_plain(*a5, **kw5),
            rep_f, src_f, lc[fw], ef, bd[fw], None)
        if eb is not None:
            a6, kw6 = calls[bw]
            timed[bw + name] = (
                lambda a6=a6, kw6=kw6: KBL.blend_backward_tiles(*a6, **kw6),
                lambda a6=a6, kw6=kw6: BP.blend_backward_plain(*a6, **kw6),
                rep_b, src_b, lc[bw], eb, bd[bw], None)
    for name, kfn, pfn, lfn, rep, nbytes in (
            ("pad_cols", lambda: KC.pad_cols(x9, B9_KOUT),
             lambda: BP.pad_cols_plain(x9, B9_KOUT),
             lambda: F.pad(x9, (0, B9_KOUT - kr)),
             "svgir_tpu/ops/blend_pallas.py:748", 4 * m9 * (kr + B9_KOUT)),
            ("slice_cols", lambda: KC.slice_cols(kp, kr),
             lambda: BP.slice_cols_plain(kp, kr),
             lambda: kp[:, :kr].contiguous(),
             "svgir_tpu/ops/blend_pallas.py:774", 8 * m9 * kr)):
        # launches on the main paths run above (phases 17, 19 and 20): B9
        # has no caller in the port, so these read 0
        lc = sum(c[name] for c in (l17, l19, l19e, l20))
        timed[name] = (kfn, pfn, rep, "svgir_tpu_torch/csrc/cols.cu", lc,
                       e9[name], (nbytes / HBM_BYTES_S * 1e3, "bytes"), lfn)
    report = []
    for name, (kfn, pfn, rep, src, lc, err, bd, lfn) in timed.items():
        with torch.no_grad():
            t = timings(kfn, pfn, lfn)
        report.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": lc, "max_abs_err": err, **t,
            "bound_ms": bd[0], "bound_by": bd[1]})
        log(f"[tiles timing] {name}: " + fmt_times(t, "F.pad / slice copy")
            + f", bound {bd[0]:.4f} ms by {bd[1]}; {lc} launches on its "
            f"path; card: {card}")
        if name in ("pad_cols", "slice_cols"):
            for p in parents:
                a = (x9, B9_KOUT) if name == "pad_cols" else (kp, kr)
                o = in_turns(lambda p=p, a=a: p[name](*a), kfn)
                report[-1].setdefault("parent", {})[p["label"]] = o
                log_turns(o, f"{p['label']} {name}", card)
    for calls, label, suffix in ((c0, "strip 0, stage 1", ""),
                                 (cap19.calls, "strip 0, stage-2 step",
                                  "_stage2"),
                                 (cap19e.calls, "strip 0, stage-2 eval",
                                  "_stage2_eval")):
        kw = calls[fw][1]
        geo = dict(ca=kw["ca"], cv=kw["cv"], tile=kw["tile"],
                   chunk=kw["chunk"], tiles=True)
        cp = {p["label"]: compare_parent(p, calls, label, card, tiles=True)
              for p in parents}
        for entry in report:
            for direction, name in (("forward", fw + suffix),
                                    ("backward", bw + suffix)):
                if entry["name"] == name:
                    entry["build"] = blend_build(ptx, direction, **geo)
                    parent_times = {k: v[direction] for k, v in cp.items()
                                    if direction in v}
                    if parent_times:
                        entry["parent"] = parent_times
    log(f"[tiles] phases 17-23: {time.time() - t_tiles:.1f} s")
    return report


# ---------------------------------------------------------------------------
# densification and the training CLI
# ---------------------------------------------------------------------------

# densify_and_prune on the card against the CPU, on one state with the same
# split noise: the decisions are comparisons of the same float32 values, so
# masks and counts are equal; placed values pass through exp, log and the
# rotation, which the devices round a last place apart.
TOL_DENSIFY = 1e-6      # absolute and relative, params and Adam moments
# The CLI's stage-1 run resumed from its checkpoint at 30 against the
# uninterrupted run to 60: the card's scatter-adds sum in another order
# from run to run (ROADMAP hazard 6), which can move a densify decision at
# its threshold, so the two runs are held close, not equal.  The Adam step
# count must be equal (a resume at the wrong iteration, or with the
# learning-rate schedule restarted, runs another number of steps).  The
# norms over the alive rows of each parameter group and of its second Adam
# moment are blind to the order of the rows; a resume that dropped the
# moments would leave the second moment with 30 steps of gradients instead
# of 60.  Readings on an H100 (alive 93,895 against 93,897): loss 2.1e-7
# relative, the norms up to 3.9e-4 (the xyz second moment; the scaling
# norm 3.5e-4, which the -1e10 log-scales of split children dominate, so
# that it moves by about 9e-5 for each such row gained or lost).
TOL_RESUME_ALIVE = 1e-3  # share of the alive count
TOL_RESUME_LOSS = 1e-3   # relative, the last logged loss
TOL_RESUME_NORM = 1e-2   # relative, each norm


def _resume_norms(res):
    """The norms over the alive rows of each parameter group and of its
    second Adam moment, from train_stage1's (state, opt_state, ...)."""
    state, opt_state = res[0], res[1]
    alive = state["alive"]
    out = {f"param/{k}": float(v[alive].double().norm())
           for k, v in state["params"].items()}
    out.update({f"v/{k}": float(v[alive].double().norm())
                for k, v in opt_state["v"].items()})
    return out


def _densify_expected(n_before, rep, cap):
    """The alive count densify_and_prune's report implies: the survivors
    (alive, less the pruned and the split originals) plus the children that
    found a free slot."""
    surv = n_before - int(rep["n_prune"]) - int(rep["n_split"])
    want = int(rep["n_clone"]) + 2 * int(rep["n_split"])
    return surv + min(want, cap - surv)


def densify_vs_cpu(a, kw):
    """densify_and_prune on the card (its arguments ``a``: state, Adam
    state and split noise, and keywords ``kw``) against the same call on
    CPU copies of them; returns (the largest difference in units of its
    allowance, where)."""
    import torch

    from svgir_tpu_torch.models import gaussians as G

    def cpu(x):
        if isinstance(x, torch.Tensor):
            return x.cpu()
        if isinstance(x, dict):
            return {k: cpu(v) for k, v in x.items()}
        if isinstance(x, list):
            return [cpu(v) for v in x]
        return x

    out_d = G.densify_and_prune(*a, **kw)
    out_c = G.densify_and_prune(*cpu(list(a)), **kw)
    for k in out_c[2]:
        if int(out_d[2][k]) != int(out_c[2][k]):
            raise AssertionError(f"densify card vs CPU: {k} "
                                 f"{int(out_d[2][k])} != {int(out_c[2][k])}")
    if not torch.equal(out_d[0]["alive"].cpu(), out_c[0]["alive"]):
        raise AssertionError("densify card vs CPU: alive masks differ")
    pairs = [(f"param {k}", out_d[0]["params"][k], out_c[0]["params"][k])
             for k in out_c[0]["params"]]
    pairs += [(f"moment {m} of {k}", out_d[1][m][k], out_c[1][m][k])
              for m in ("m", "v") for k in out_c[1][m]]
    # each difference in units of its allowance (TOL_DENSIFY (1 + |cpu|))
    worst = max((float(((d.cpu().double() - c.double()).abs()
                        / (TOL_DENSIFY * (1 + c.double().abs()))).max()), w)
                for w, d, c in pairs)
    if worst[0] > 1.0:
        raise AssertionError(f"densify card vs CPU: {worst[1]} differs by "
                             f"{worst[0]:.3g} x its allowance")
    return worst


def write_blender_scene(root, state, dev, n_frames=8, res=800, n_test=2):
    """A Blender-layout scene in ``root``: ``n_frames`` RGBA PNG frames of
    the bench surfels rendered on the card from a ring of cameras and
    ``n_test`` more from between them, their ``transforms_train.json`` and
    ``transforms_test.json``, and no point cloud (the reader bootstraps
    100,000 random points)."""
    import os

    import numpy as np
    import torch

    from svgir_tpu_torch.cameras import look_at_camera
    from svgir_tpu_torch.config import RasterConfig
    import cv2
    from svgir_tpu_torch.render.stage1 import render_view_stage1

    os.makedirs(os.path.join(root, "train"))
    os.makedirs(os.path.join(root, "test"))
    fov = math.pi / 3
    frames = {"train": [], "test": []}
    bg = torch.zeros(3, device=dev)
    for i in range(n_frames + n_test):
        split, j = ("train", i) if i < n_frames else ("test", i - n_frames)
        a = 2 * math.pi * (i if i < n_frames else j + 0.5) / n_frames
        eye = [2.6 * math.sin(a), 0.4 * math.cos(3 * a), -2.6 * math.cos(a)]
        cam = look_at_camera(eye=eye, target=[0, 0, 0], up=[0, -1, 0],
                             fovx=fov, fovy=fov, width=res, height=res,
                             device=dev)
        with torch.no_grad():
            r = render_view_stage1(cam, state["params"], bg,
                                   alive=state["alive"], cfg=RasterConfig())
        alpha = r["opacity"].clamp(0, 1)
        rgb = (r["render"] / alpha.clamp(min=1e-6)).clamp(0, 1)
        rgba = torch.cat([rgb, alpha]).permute(1, 2, 0)
        rgba8 = (rgba * 255 + 0.5).to(torch.uint8).cpu().numpy()
        if not cv2.imwrite(os.path.join(root, split, f"r_{j}.png"),
                           cv2.cvtColor(rgba8, cv2.COLOR_RGBA2BGRA)):
            raise RuntimeError(f"cv2 could not write frame {i}")
        # OpenCV axes (x right, y down, z forward) -> Blender's (y up, z
        # back): the reader flips the two columns back
        c2w = np.eye(4)
        c2w[:3, :3] = np.linalg.inv(cam.world_view[:3, :3].cpu().numpy()
                                    .astype(np.float64))
        c2w[:3, 3] = eye
        c2w[:3, 1:3] *= -1
        frames[split].append({"file_path": f"./{split}/r_{j}",
                              "transform_matrix": c2w.tolist()})
    import json
    for split, fr in frames.items():
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": fov, "frames": fr}, f)


def run_trainer(card, dev):
    """Phases 24-25: densification at full width and the training CLI;
    then phases 28-29 on the CLI's scene and checkpoints."""
    import json
    import os
    import tempfile

    import torch

    from svgir_tpu_torch import kernels
    from svgir_tpu_torch.cli import eval_relighting as cli_relight
    from svgir_tpu_torch.cli import train as cli
    from svgir_tpu_torch.config import OptimizationConfig, RasterConfig
    from svgir_tpu_torch.data import readers
    from svgir_tpu_torch.eval import relighting as REL
    from svgir_tpu_torch.models import gaussians as G
    from svgir_tpu_torch.models import radiance as RAD
    from svgir_tpu_torch.train import cap_probe, optim, trainer
    from svgir_tpu_torch.train import checkpoint as CK

    t_phase = time.time()
    # ---- 24. densify: train_stage1 with the cadence at full width -------
    # the bench scene at init_from_points' capacity for 50,000 (65,536).
    # percent_dense is the median of the surfels' largest start scales
    # (extent 1), so about half clone and half split; a zero gradient
    # threshold makes every surfel act (as tests/test_guards.py's), so the
    # children outnumber the free rows and the loop grows the capacity
    state, cam = bench_scene(dev, capacity=None)
    cap0 = state["alive"].shape[0]
    if cap0 != G._round_capacity(int(state["alive"].sum())):
        raise AssertionError(f"densify: capacity {cap0} is not "
                             "init_from_points' default")
    iters = 40
    scale_med = float(G.get_scaling(state["params"]).max(1).values[
        state["alive"]].median())
    opt = OptimizationConfig(
        densify_from_iter=5, densification_interval=5,
        opacity_reset_interval=20, percent_dense=scale_med,
        densify_grad_threshold=0.0, position_lr_max_steps=iters)
    cfg = RasterConfig(max_instances=cap_probe.snug_instance_cap(
        state["params"], [cam], RasterConfig(), alive=state["alive"]))
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with Recorder(G, "densify_and_prune") as rec_d, \
            Recorder(G, "reset_opacity") as rec_r, \
            Recorder(G, "grow_capacity") as rec_g:
        st, ost, hist = trainer.train_stage1(
            state, [cam], opt, raster_cfg=cfg, iterations=iters,
            log_every=1, device=dev)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = kernels.launches()
    check_launches(launches, "densify run", at_least=[
        (k, iters) for k in STAGE1_KERNELS])
    for h in hist:
        if not math.isfinite(h["loss"]):
            raise AssertionError(f"densify run: bad step {h}")
    for k, v in list(st["params"].items()) + list(ost["m"].items()) + \
            list(ost["v"].items()):
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"densify run: non-finite values in {k}")
    alive_at = {h["iter"]: h["n_alive"] for h in hist}
    events = {"clone": 0, "split": 0, "prune": 0}
    for (a, kw, out, sec) in rec_d.calls:
        n_before = int(a[0]["alive"].sum())
        cap = a[0]["alive"].shape[0]
        rep = out[2]
        want = _densify_expected(n_before, rep, cap)
        if int(rep["n_alive"]) != want or \
                int(out[0]["alive"].sum()) != want:
            raise AssertionError(f"densify: alive {int(rep['n_alive'])}, "
                                 f"the report implies {want}")
        for k in events:
            events[k] += int(rep[f"n_{k}"])
        log(f"[densify] cap {cap}: alive {n_before} -> {want} (clone "
            f"{int(rep['n_clone'])}, split {int(rep['n_split'])}, prune "
            f"{int(rep['n_prune'])}, out of capacity "
            f"{bool(rep['out_of_capacity'])}), {sec * 1e3:.2f} ms")
    if len(rec_d.calls) != ((iters - opt.densify_from_iter)
                            // opt.densification_interval):
        raise AssertionError(f"densify ran {len(rec_d.calls)} times")
    if not all(events.values()) or not rec_g.calls:
        raise AssertionError(f"densify run lacks an event: {events}, "
                             f"{len(rec_g.calls)} capacity doublings")
    for (a, kw, out, sec) in rec_r.calls:
        top = float(G.get_opacity(out[0]).max())
        if top > 0.01 * (1 + 1e-6) or bool(out[1]["m"]["opacity"].any()):
            raise AssertionError(f"opacity reset: max opacity {top}")
    if len(rec_r.calls) != 2:
        raise AssertionError(f"opacity reset ran {len(rec_r.calls)} times")
    log(f"[densify] percent_dense {scale_med:.6g}, densify_grad_threshold "
        f"{opt.densify_grad_threshold}")
    log(f"[densify] {iters} steps in {loop_s:.2f} s: alive "
        f"{int(state['alive'].sum())} -> {int(st['alive'].sum())}, capacity "
        f"{cap0} -> {st['alive'].shape[0]} ({len(rec_g.calls)} doublings), "
        f"instance cap {cfg.max_instances}; events {events}; launches "
        f"{launches}; alive by iteration {alive_at}")

    # densify_and_prune on the card against the CPU, on the state of the
    # first cadence, the same noise injected
    a, kw, _, _ = rec_d.calls[0]
    worst = densify_vs_cpu(a, kw)
    log(f"[densify] card == CPU on the first cadence's state (cap "
        f"{a[0]['alive'].shape[0]}): masks and counts equal, largest "
        f"difference {worst[0]:.3g} x {TOL_DENSIFY} (1 + |cpu|) "
        f"({worst[1]})")
    # its time at 65,536 and 131,072 rows, and a step's at each with the
    # same surfels alive
    step = trainer.make_train_step(opt, cfg, torch.zeros(3, device=dev),
                                   lrs=optim.group_lrs(opt, 1.0), device=dev)
    for grown in (False, True):
        s_, o_ = a[0], a[1]
        if grown:
            s_, o_ = G.grow_capacity(s_, o_, 2 * s_["alive"].shape[0])
        cap = s_["alive"].shape[0]
        nz = torch.randn(2, cap, 3, device=dev,
                         generator=torch.Generator(dev).manual_seed(9))
        fn = (lambda s_=s_, o_=o_, nz=nz: G.densify_and_prune(
            s_, o_, nz, **kw))
        d_ms = cuda_ms(fn, reps=10)
        d_dev = device_ms(fn, reps=10)[0]
        s_ms = host_ms(lambda s_=s_, o_=o_: step(s_, o_, cam, 10.0, 1e-4),
                       reps=10)
        log(f"[densify] capacity {cap} ({int(s_['alive'].sum())} alive): "
            f"densify_and_prune {d_ms:.3f} ms per call, {d_dev:.3f} ms on "
            f"the device; stage-1 step {s_ms:.3f} ms; card: {card}")
    log(f"[densify] {time.time() - t_phase:.1f} s")

    # ---- 25. the CLI: stage 1 at 800 x 800, its resume, stage 2 ----------
    t_cli = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        scene = os.path.join(tmp, "scene")
        write_blender_scene(scene, state, dev)
        out_a, out_b, out_c = (os.path.join(tmp, d) for d in "abc")
        # the bootstrap's random points start as wide splats, and the
        # size gate (20 pixels, active past the first opacity reset)
        # prunes nearly all of them within 60 iterations when the reset
        # comes at 30, leaving too few surfels for the bake's grid march;
        # so the reset comes at 60 and this run never applies the gate
        # (phase 24 does, from its first reset at 20)
        flags = ["-s", scene, "--iterations", "60", "--densify_from_iter",
                 "10", "--densification_interval", "10",
                 "--opacity_reset_interval", "60", "--checkpoint_interval",
                 "30", "--max_instances", "0", "--position_lr_max_steps",
                 "60", "--quiet"]

        def run(argv, label, kernels_needed):
            torch.cuda.synchronize()
            kernels.reset_launches()
            with Recorder(readers, "load_scene") as r_load, \
                    Recorder(cap_probe, "snug_instance_cap") as r_probe, \
                    Recorder(trainer, "train_stage1") as r_s1, \
                    Recorder(trainer, "train_stage2") as r_s2, \
                    Recorder(trainer, "bake_radiance_compact") as r_bake, \
                    Recorder(CK, "save_checkpoint") as r_save, \
                    Recorder(CK, "load_checkpoint") as r_ld:
                t0 = time.perf_counter()
                cli.main(argv)
                torch.cuda.synchronize()
                total = time.perf_counter() - t0
            lc = kernels.launches()
            check_launches(lc, label, at_least=[(k, 1)
                                                for k in kernels_needed])

            def secs(r):
                return sum(c[3] for c in r.calls)
            save_in = sum(c[3] for c in r_save.calls[:-1])
            loop = secs(r_s1) + secs(r_s2) - secs(r_bake) - save_in
            out = argv[argv.index("-m") + 1]
            with open(os.path.join(out, "train_log.jsonl")) as f:
                log_ = [json.loads(line) for line in f]
            for e in log_:
                if not math.isfinite(e["loss"]):
                    raise AssertionError(f"{label}: bad log entry {e}")
            for name in ("cfg_args.json", "cameras.json", "point_cloud.ply",
                         "train_log.jsonl", f"chkpnt{argv[argv.index('--iterations') + 1]}.npz"):
                if not os.path.exists(os.path.join(out, name)):
                    raise AssertionError(f"{label}: no {name}")
            res = (r_s1.calls or r_s2.calls)[0][2]
            cap = res[0]["alive"].shape[0]
            log(f"[cli] {label}: {total:.2f} s: scene load "
                f"{secs(r_load):.2f} s, probe {secs(r_probe):.2f} s (cap "
                f"{r_probe.calls[0][2]}), loop {loop:.2f} s, checkpoint "
                f"write {secs(r_save):.2f} s ({len(r_save.calls)}) / read "
                f"{secs(r_ld):.2f} s, bake {secs(r_bake):.2f} s; capacity "
                f"at the end {cap}, alive {int(res[0]['alive'].sum())} "
                f"(by logged iteration: "
                f"{[(e['iter'], e.get('n_alive')) for e in log_]}); "
                f"launches {lc}; card: {card}")
            return log_, res, r_load.calls[0][2], r_probe.calls[0][2]

        # stage 1 with --eval: the two test views rendered at the end
        log_a, res_a, sc, _ = run(flags + ["-m", out_a, "--eval"],
                                  "stage 1, 60 iterations, --eval",
                                  STAGE1_KERNELS)
        with open(os.path.join(out_a, "eval", "metrics.json")) as f:
            ev = json.load(f)
        log(f"[cli] stage 1 --eval: {json.dumps(ev)}")
        if ev["n_views"] != 2 or not math.isfinite(ev["psnr"]) or \
                not os.path.exists(os.path.join(out_a, "eval", "renders",
                                                "00001_depth.png")):
            raise AssertionError(f"cli --eval: {ev}")
        if sc.points.shape[0] != readers.BOOTSTRAP_POINTS:
            raise AssertionError(f"cli: the start cloud has "
                                 f"{sc.points.shape[0]} points, not the "
                                 f"{readers.BOOTSTRAP_POINTS} of the "
                                 "bootstrap")
        log_b, res_b, _, _ = run(flags + ["-m", out_b, "-c", os.path.join(
            out_a, "chkpnt30.npz")], "stage 1 resumed at 30", STAGE1_KERNELS)
        na, nb = int(res_a[0]["alive"].sum()), int(res_b[0]["alive"].sum())
        la, lb = log_a[-1]["loss"], log_b[-1]["loss"]
        sa, sb = res_a[1]["step"], res_b[1]["step"]
        norms_a, norms_b = _resume_norms(res_a), _resume_norms(res_b)
        # a group the loss has not reached yet (shs_rest at SH degree 0)
        # has zero moments in both runs
        rel = {k: abs(norms_b[k] - norms_a[k]) / norms_a[k] if norms_a[k]
               else float(norms_b[k] != 0.0) for k in norms_a}
        log(f"[cli] resumed against uninterrupted at 60: Adam step {sb} vs "
            f"{sa}, alive {nb} vs {na}, loss {lb!r} vs {la!r}, norms over "
            f"the alive rows (resumed, uninterrupted, relative difference): "
            + ", ".join(f"{k} {norms_b[k]!r} {norms_a[k]!r} {rel[k]:.3e}"
                        for k in norms_a))
        bad = [k for k, r in rel.items() if not r <= TOL_RESUME_NORM]
        if sa != sb or abs(na - nb) > TOL_RESUME_ALIVE * na or \
                abs(la - lb) > TOL_RESUME_LOSS * abs(la) or bad:
            raise AssertionError(f"cli resume: step {sb} vs {sa}, alive {nb} "
                                 f"vs {na}, loss {lb} vs {la}, norms off "
                                 f"{bad}")
        # --finetune_visibility (1,000 iterations) runs on a 6,000-surfel
        # checkpoint of chkpnt60's first alive rows: at its ~94,000 surfels
        # an iteration takes 444 ms on an H100 80GB HBM3 at 700 W, so the
        # flag there would take about 7 minutes
        ck60 = os.path.join(out_a, "chkpnt60.npz")
        log_c, _, _, cap_c = run(
            ["-s", scene, "-m", out_c, "-t", "render_relight", "-c", ck60,
             "--iterations", "63", "--sample_num", "64",
             "--env_resolution", "32", "--max_instances", "0",
             "--position_lr_max_steps", "63", "--quiet", "--eval"],
            "stage 2 from chkpnt60, S = 64, env 32x64, --eval",
            STAGE2_KERNELS + ("march",))
        log(f"[cli] stage 2: psnr_pbr {log_c[-1]['psnr_pbr']:.4f}, loss "
            f"{log_c[-1]['loss']:.6f}")
        _, tree = CK.load_checkpoint(ck60, device=dev)
        small = os.path.join(tmp, "chkpnt60_6000.npz")
        rows = torch.nonzero(tree["state"]["alive"])[:, 0][:6000]
        p6 = {k: v[rows] for k, v in tree["state"]["params"].items()}
        st6 = {"params": p6, "alive": torch.ones(len(rows), dtype=bool,
                                                 device=dev),
               "stats": G.init_stats(len(rows), device=dev)}
        CK.save_checkpoint(small, 60, st6, optim.adam_init(p6))
        with Recorder(G, "finetune_visibility") as r_ft:
            run(["-s", scene, "-m", os.path.join(tmp, "d"), "-t",
                 "render_relight", "-c", small, "--iterations", "61",
                 "--sample_num", "64", "--env_resolution", "32",
                 "--max_instances", "0", "--position_lr_max_steps", "61",
                 "--finetune_visibility", "--quiet"],
                "stage 2 on 6,000 surfels, --finetune_visibility",
                STAGE2_KERNELS + ("march",))
        (fa, fkw, fout, f_s), = r_ft.calls
        if torch.equal(fout["params"]["visibility_rest"],
                       fa[0]["params"]["visibility_rest"]):
            raise AssertionError("cli: --finetune_visibility changed nothing")
        log(f"[cli] --finetune_visibility: {int(fa[0]['alive'].sum())} "
            f"surfels, 1,000 iterations in {f_s:.2f} s; card: {card}")
        with open(os.path.join(out_c, "eval", "metrics.json")) as f:
            log(f"[cli] stage 2 --eval: {f.read().strip()}")

        # the relighting CLI on the stage-2 checkpoint, both HDRs, S = 384
        hdrs = write_hdrs(tmp)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with Recorder(REL, "bake_radiance_compact") as r_bk, \
                Recorder(RAD, "irradiance_full") as r_irr:
            res_r = cli_relight.main(
                ["-s", scene, "-m", out_c, "-c", os.path.join(
                    out_c, "chkpnt63.npz"), "--hdr", *hdrs, "--sample_num",
                 str(RELIGHT_SAMPLES), "--max_instances", str(cap_c)])
        torch.cuda.synchronize()
        rel_s = time.perf_counter() - t0
        lc = kernels.launches()
        check_launches(lc, "relighting CLI", at_least=[
            ("binning_counts", 1), ("binning_instances", 1),
            ("blend_forward", 1), ("env_lookup_forward", 1), ("march", 1)])
        for path in hdrs:
            name = os.path.splitext(os.path.basename(path))[0]
            with open(os.path.join(out_c, "eval_relight", name,
                                   "metrics.json")) as f:
                m = json.load(f)
            if m != res_r[name] or not math.isfinite(m["pbr_psnr"]) or \
                    not isinstance(m["pbr_lpips"], (float, str)):
                raise AssertionError(f"relighting CLI, {name}: {m}")
            log(f"[cli] eval_relighting {name}: {json.dumps(m)}")
        bk = r_bk.calls[0][2]
        log(f"[cli] eval_relighting CLI: {rel_s:.2f} s for {len(hdrs)} "
            f"lights x {res_r[name]['n_views']} views at S="
            f"{RELIGHT_SAMPLES}: bake {r_bk.calls[0][3]:.2f} s (pairs with "
            f"a hit {float((bk['hit_idx'] >= 0).float().mean()):.5f}, "
            f"exhausted_frac {float(bk['exhausted_frac']):.6f}), "
            f"irradiance_full " + ", ".join(f"{c[3]:.2f}" for c in
                                             r_irr.calls)
            + f" s; launches {lc}; card: {card}")
        log(f"[cli] {time.time() - t_cli:.1f} s")

        # ---- 28-29. the evaluation and viewing commands on these files ---
        run_eval_commands(card, dev, tmp, scene,
                          os.path.join(out_a, "chkpnt60.npz"),
                          os.path.join(out_c, "chkpnt63.npz"),
                          os.path.join(out_c, "point_cloud.ply"), hdrs)


# ---------------------------------------------------------------------------
# relighting under new HDR lights, and the visibility tracers
# ---------------------------------------------------------------------------

RELIGHT_SAMPLES = 384   # eval_relighting.py's --sample_num
RELIGHT_VIEWS = 4
SUBSET = 2048           # surfels (phase 26) and rays (27) held card vs CPU
SUBSET_SAMPLES = 32     # the patch's bake (the CPU shades ~4 us a sample)
# irradiance_full, card against CPU on the same bake: the devices round
# the shading's rsqrt, pow and divisions a last place apart, and GGX's
# denominator (1 - NoH^2 (1 - alpha^2)) amplifies that near mirror
# directions, so each device is held to a float64 evaluation of the same
# shading: the card no farther from it than twice the CPU, plus
TOL_IRR = 1e-5          # of the largest irradiance
TOL_VIS = 1e-5          # tests/test_grid_tracer.py::test_grid_matches_brute
VIS_ITERS = 10          # finetune_visibility iterations timed at full width
VIS_CLEAR = 1e-3        # rays compared lie this far from the 0.9 cut


def write_hdrs(root):
    """Two HDR lights written with OpenCV (float32, RGBE): a 512 x 1024
    sky, blue at the zenith fading to a warm horizon and a dark ground, with
    a sun of radiance 40 (a gaussian of 6 pixels), and a uniform grey 64 x
    128 one.  Returns their paths."""
    import os

    import cv2
    import numpy as np

    h, w = 512, 1024
    y = (np.arange(h, dtype=np.float32) + 0.5) / h            # 0: zenith
    sky = np.where(y[:, None] < 0.5,
                   np.array([0.35, 0.55, 1.2]) * (1 - y[:, None])
                   + np.array([1.0, 0.8, 0.6]) * y[:, None],
                   np.array([0.15, 0.12, 0.1]))
    img = np.repeat(sky[:, None, :], w, 1).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    img += (40.0 * np.exp(-((yy - 140.0) ** 2 + (xx - 300.0) ** 2)
                          / (2 * 6.0 ** 2)))[..., None].astype(np.float32)
    paths = [os.path.join(root, "sky_sun.hdr"),
             os.path.join(root, "uniform.hdr")]
    for path, rgb in ((paths[0], img),
                      (paths[1], np.full((64, 128, 3), 0.8, np.float32))):
        if not cv2.imwrite(path, np.ascontiguousarray(rgb[..., ::-1])):
            raise RuntimeError(f"cv2 could not write {path}")
    return paths


def ring_cameras(dev, n, res, radius=2.6, gt=None, start=0.0):
    """``n`` cameras on a ring around the origin looking at it, each with
    the image ``gt`` (or none) and a full mask."""
    import dataclasses

    import torch

    from svgir_tpu_torch.cameras import look_at_camera
    cams = []
    for i in range(n):
        a = start + 2 * math.pi * i / n
        cam = look_at_camera(
            eye=[radius * math.sin(a), 0.4 * math.cos(3 * a),
                 -radius * math.cos(a)], target=[0, 0, 0], up=[0, -1, 0],
            fovx=math.pi / 3, fovy=math.pi / 3, width=res, height=res,
            device=dev)
        if gt is not None:
            cam = dataclasses.replace(
                cam, image=gt, image_mask=torch.ones(1, res, res,
                                                     device=dev))
        cams.append(cam)
    return cams


def patch_subset(params, alive, n):
    """The ``n`` alive surfels nearest to the first one (a patch of the
    shell, its full thickness: their hemisphere rays meet each other),
    as params of n rows, all alive."""
    import torch
    rows = torch.nonzero(alive)[:, 0]
    xyz = params["xyz"][rows]
    near = rows[torch.argsort((xyz - xyz[0]).norm(dim=-1))[:n]]
    return {k: (v[near] if v.dim() and v.shape[0] == alive.shape[0] else v)
            for k, v in params.items()}


def run_relight(card, dev):
    """Phases 26-27: relighting the inward bench scene under two HDR
    lights (rebake at S = 384, irradiance_full, eval_relighting over four
    views), and the visibility tracers with finetune_visibility at full
    width.  Returns the kernels-JSON entries of B7's forward on the
    EnvLight lookup, B8 on the S = 384 chunks and B3 on the relit render."""
    import json
    import os
    import tempfile

    import torch

    from svgir_tpu_torch import kernels
    from svgir_tpu_torch.config import RasterConfig
    from svgir_tpu_torch.eval import relighting as REL
    from svgir_tpu_torch.kernels import blend as KBL
    from svgir_tpu_torch.kernels import env_lookup as KE
    from svgir_tpu_torch.models import gaussians as G
    from svgir_tpu_torch.models import lights as LT
    from svgir_tpu_torch.models import radiance as RAD
    from svgir_tpu_torch.ops import blend_pallas_strip as BS
    from svgir_tpu_torch.ops import env_lookup_pallas as EP
    from svgir_tpu_torch.ops import grid_tracer as GT
    from svgir_tpu_torch.ops import march_pallas as MP
    from svgir_tpu_torch.ops import tracing as TR
    from svgir_tpu_torch.render.stage1 import render_view_stage1
    from svgir_tpu_torch.train import cap_probe

    t_phase = time.time()
    # ---- 26. relighting: eval_relighting on the inward bench scene -------
    # the bench surfels facing the centre (their hemisphere rays hit),
    # upgraded to PBR with random base colour and roughness
    state, cam = bench_scene(dev, inward=True)
    st = G.upgrade_to_pbr(state)
    g = torch.Generator(device=dev).manual_seed(11)
    params = dict(st["params"])
    for k in ("base_color", "roughness"):
        params[k] = 0.5 * torch.randn(params[k].shape, generator=g,
                                      device=dev)
    alive = st["alive"]
    n = int(alive.sum())
    res = cam.width
    cams = ring_cameras(dev, RELIGHT_VIEWS, res, gt=cam.image)
    cfg = RasterConfig(max_instances=cap_probe.snug_instance_cap(
        params, cams, RasterConfig(), alive=alive))
    # a synthetic GT albedo (0.5) over each view's covered pixels
    gt_albedo = torch.full((3, res, res), 0.5, device=dev)
    with torch.no_grad():
        masks = [(render_view_stage1(c, params, torch.zeros(3, device=dev),
                                     alive=alive, cfg=cfg)["opacity"] > 0.5)
                 .float() for c in cams]

    def gt_albedo_fn(idx):
        return gt_albedo, masks[idx]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        envs = [(os.path.splitext(os.path.basename(p))[0],
                 LT.env_light_init(LT.load_hdr(p), device=dev))
                for p in write_hdrs(tmp)]
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        summaries, bake = {}, None
        with Capture() as cap, \
                Recorder(REL, "bake_radiance_compact") as r_bake, \
                Recorder(RAD, "bake_radiance", keep=0) as r_pass, \
                Recorder(RAD, "irradiance_full") as r_irr, \
                Recorder(REL, "render_svgss") as r_view, \
                Recorder(REL.M, "image_metrics") as r_met, \
                Recorder(REL.M, "lpips") as r_lp, \
                Recorder(REL, "save_image") as r_png, \
                Recorder(GT, "nearest_hits_grid", keep=1) as r_grid:
            for name, env in envs:
                summaries[name] = REL.eval_relighting(
                    os.path.join(tmp, "out"), params, alive, env, cams,
                    sample_num=RELIGHT_SAMPLES, raster_cfg=cfg,
                    gt_albedo_fn=gt_albedo_fn, light_name=name, bake=bake)
                bake = r_bake.calls[0][2]
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = kernels.launches()
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(tmp, "out", envs[0][0], "metrics.json")) as f:
            written = json.load(f)
    check_launches(launches, "relighting", at_least=[
        ("binning_counts", 1), ("binning_instances", 1),
        ("blend_forward", 1), ("env_lookup_forward", 1), ("march", 1)],
        none=("blend_backward", "env_lookup_backward"))
    if len(r_bake.calls) != 1 or len(r_pass.secs) != 1:
        raise AssertionError(f"relighting baked {len(r_bake.calls)} times "
                             f"in {len(r_pass.secs)} passes for two lights "
                             "(the reference: once, at k 16)")
    hits = bake["hit_idx"][alive] >= 0
    hit_share = float(hits.float().mean())
    rads = [c[2] for c in r_irr.calls]
    for name, rad in zip((e[0] for e in envs), rads):
        if not bool(torch.isfinite(rad).all()) or \
                not bool((rad[alive] != 0).any()):
            raise AssertionError(f"relighting: radiances under {name} are "
                                 "not finite or all zero")
    if hit_share <= 0.0:
        raise AssertionError("relighting: no (surfel, sample) pair has a hit")
    if written != summaries[envs[0][0]]:
        raise AssertionError("relighting: metrics.json is not the summary")
    for name, s in summaries.items():
        if s["n_views"] != RELIGHT_VIEWS or not math.isfinite(
                s["pbr_psnr"]) or not math.isfinite(s["albedo_psnr"]):
            raise AssertionError(f"relighting under {name}: {s}")
    view_s = [c[3] for c in r_view.calls]
    # the same view under the two lights (calls 1 and 6: after each
    # light's calibration render)
    per_light = len(r_view.calls) // 2
    pbr_a = r_view.calls[1][2]["pbr"]
    pbr_b = r_view.calls[per_light + 1][2]["pbr"]
    cover = float(r_view.calls[1][2]["opacity"].mean())
    bcs = r_view.calls[1][1]["base_color_scale"]
    if cover <= 0.0 or torch.equal(pbr_a, pbr_b):
        raise AssertionError(f"relighting: view 0 covers {cover}; its pbr "
                             "is the same under both lights")
    if not (bool(torch.isfinite(bcs).all()) and float(bcs.max()) < 100):
        raise AssertionError(f"relighting: albedo scale {bcs.tolist()}")
    log(f"[relight] inward bench scene, {n} surfels, S={RELIGHT_SAMPLES}, "
        f"{RELIGHT_VIEWS} views of {res}x{res} (cap {cfg.max_instances}), "
        f"lights "
        + ", ".join(f"{k} {tuple(e['envmap'].shape)} -> "
                    f"{tuple(e['lookup'].shape)}" for k, e in envs)
        + f": load_hdr + env_light_init {load_s:.3f} s; bake "
        f"{r_bake.calls[0][3]:.3f} s ({len(r_grid.secs)} grid-march "
        f"chunks, one pass at k 16 as the reference's; exhausted_frac "
        f"{float(bake['exhausted_frac']):.6f}, pairs with a hit "
        f"{hit_share:.4f}); irradiance_full "
        + ", ".join(f"{c[3]:.3f}" for c in r_irr.calls) + " s; views "
        + ", ".join(f"{s:.3f}" for s in view_s) + " s (the first of each "
        f"light's is the calibration render); image metrics "
        f"{sum(c[3] for c in r_met.calls):.3f} s, lpips "
        f"{sum(c[3] for c in r_lp.calls):.3f} s, PNG writes "
        f"{sum(c[3] for c in r_png.calls):.3f} s; total {total_s:.3f} s; "
        f"albedo scale {[round(x, 4) for x in bcs.tolist()]}, "
        f"view 0's opacity {cover:.4f}, its pbr under the two lights "
        f"{float(pbr_a.mean()):.4f} and {float(pbr_b.mean()):.4f}; "
        f"peak memory {peak / 2**30:.3f} GiB; launches {launches}; "
        f"card: {card}")
    for name, s in summaries.items():
        log(f"[relight] {name}: " + json.dumps(s))

    # B7's forward on the EnvLight lookup (N x 384 bake directions on the
    # 32 x 64 map), B8 on the S = 384 bake's first chunk and B3 on the
    # relit render, against their plain versions
    fa = cap.calls["env_lookup_forward"][0]
    e7 = compare_env_forward(fa, "EnvLight lookup")
    (geo8, grid8, o8, d8), hkw, _, _ = r_grid.calls[0]
    mkw = dict(t_max=hkw["t_max"], k=hkw["k"], n_steps=hkw["n_steps"],
               kmax=GT._run_kmax(grid8))
    with torch.no_grad():
        kt, ki = MP.march(grid8, o8, d8, **mkw)
        pt, pi = MP.march_plain(grid8, o8, d8, **mkw)
    torch.cuda.synchronize()
    fin = torch.isfinite(pt)
    bad = int(((ki != pi) | (torch.isfinite(kt) != fin)
               | (fin & (kt != pt))).sum())
    both = fin & torch.isfinite(kt)
    e8 = float((kt - pt)[both].abs().max()) if bool(both.any()) else 0.0
    log(f"[relight] B8 vs plain on the S={RELIGHT_SAMPLES} bake's first "
        f"chunk ({len(o8)} rays, grid res {grid8.res}, cap "
        f"{grid8.cell_cap}, n_steps {mkw['n_steps']}, k {mkw['k']}): "
        f"{int(fin.sum())} finite slots, {bad} differ, max|t err| {e8:.3g};"
        f" B7 forward on {fa[1].numel()} EnvLight queries max|err| {e7:.3g}")
    if bad > MARCH_SLOT_TOL * max(int(fin.sum()), 1):
        raise AssertionError(f"B8 differs from its plain version at {bad} "
                             "slots on the S = 384 chunk")
    e3, _ = compare_blend(cap.calls, "relit render", hdr=True)

    # card against CPU on a 2,048-surfel patch: irradiance_full on the
    # card's bake of the patch, and the relit image of a 128 x 128 camera
    sub = patch_subset(params, alive, SUBSET)
    sub_alive = torch.ones(SUBSET, dtype=torch.bool, device=dev)
    env0 = envs[0][1]
    with torch.no_grad():
        b_sub, rad_d = REL.rebake_radiance_for_light(
            sub, sub_alive, env0, sample_num=SUBSET_SAMPLES)
        cpu = {k: v.cpu() for k, v in b_sub.items()}
        env_cpu = {k: (v.cpu() if v is not None else None)
                   for k, v in env0.items()}
        sub_cpu = {k: v.cpu() for k, v in sub.items()}
        _, rad_c = REL.rebake_radiance_for_light(
            sub_cpu, sub_alive.cpu(), env_cpu,
            sample_num=SUBSET_SAMPLES, bake=cpu)
        # the same shading in float64 on the CPU, from the CPU's inputs
        n_sub = sub_cpu["xyz"].shape[0]
        env_term = LT.env_light_direct(env_cpu, cpu["incident_dirs"]) \
            * cpu["incident_areas"]
        rad_64 = RAD.irradiance_full(
            {k: (v.double() if v.is_floating_point() else v)
             for k, v in cpu.items()}, env_term.double(),
            G.get_shading_normal(sub_cpu).double(),
            G.get_base_color(sub_cpu).reshape(n_sub, 3, 4).transpose(1, 2)
            .double(), G.get_roughness(sub_cpu)[:, 0].double())
    scale = float(rad_c.abs().max())
    e_irr = float((rad_d.cpu() - rad_c).abs().max())
    e_d64 = float((rad_d.cpu().double() - rad_64).abs().max())
    e_c64 = float((rad_c.double() - rad_64).abs().max())
    sub_hits = float((b_sub["hit_idx"] >= 0).float().mean())
    if scale == 0.0 or e_d64 > 2 * e_c64 + TOL_IRR * scale:
        raise AssertionError(f"irradiance_full: the card lies {e_d64} from "
                             f"float64, the CPU {e_c64} (of {scale})")
    centre = sub["xyz"].mean(0).cpu().numpy()
    eye = (centre * 0.0).tolist()              # from the ball's centre
    from svgir_tpu_torch.cameras import look_at_camera
    crop = {d: look_at_camera(eye=eye, target=centre.tolist(),
                              up=[0, -1, 0], fovx=math.pi / 4,
                              fovy=math.pi / 4, width=128, height=128,
                              device=d) for d in (dev, "cpu")}
    imgs = {}
    for d, (p_, b_, e_, r_) in {
            dev: (sub, b_sub, env0, rad_c.to(dev)),
            "cpu": (sub_cpu, cpu, env_cpu, rad_c)}.items():
        p2 = {**p_, "radiances": r_,
              "radiance_ratio": torch.ones((), device=d)}
        with torch.no_grad():
            res = REL.render_svgss(
                crop[d], p2, torch.zeros(3, device=d),
                bake={k: v for k, v in b_.items() if k != "exhausted_frac"},
                env_params=None,
                env_fn=lambda x, e_=e_: LT.env_light_direct(e_, x),
                env_qxy_fn=lambda q, e_=e_: LT.env_light_direct_qxy(
                    e_, q[..., 0], q[..., 1]),
                is_training=False, alive=sub_alive.to(d),
                cfg=RasterConfig(max_instances=1 << 18))
        imgs[d] = res
    e_img = max(float((imgs[dev][k].cpu() - imgs["cpu"][k]).abs().max())
                for k in ("pbr", "base_color", "visibility"))
    cover = float(imgs["cpu"]["opacity"].mean())
    log(f"[relight] card vs CPU on a {SUBSET}-surfel patch at S="
        f"{SUBSET_SAMPLES} (pairs with a hit {sub_hits:.4f}): "
        f"irradiance_full within {e_irr:.3g} of {scale:.4g}, from a float64 "
        f"evaluation {e_d64:.3g} (card) and {e_c64:.3g} (CPU); the relit "
        f"128x128 crop (opacity {cover:.3f}, the CPU's radiances on both) "
        f"within {e_img:.3g} (pbr, base colour, visibility)")
    if e_img > TOL_S2_IMG or cover <= 0.0:
        raise AssertionError(f"relit crop: card vs CPU differ by {e_img} "
                             f"(coverage {cover})")

    # timings and the kernels-JSON rows
    report = []
    bnd_env = env_bounds(fa)["env_lookup_forward"]
    with torch.no_grad():
        t7 = timings(lambda: KE.env_lookup_forward(*fa),
                     lambda: EP.env_lookup_forward_plain(*fa),
                     library_env_forward(fa))
        t8 = timings(lambda: MP.march(grid8, o8, d8, **mkw),
                     lambda: MP.march_plain(grid8, o8, d8, **mkw), reps=10,
                     plain_reps=1)
        a3, kw3 = cap.calls["blend_forward"]
        t3 = timings(lambda: KBL.blend_forward(*a3, **kw3),
                     lambda: BS.blend_forward_plain(*a3, **kw3))
    work8 = march_work(grid8, o8, d8, pt, **{x: mkw[x] for x in
                                              ("n_steps", "kmax", "k")})
    bnd8 = march_bound(work8, len(o8), mkw["k"])
    bnd3_all = bounds(cap.calls)
    bnd3 = bnd3_all["blend_forward"]
    log_blend_work(bnd3_all, a3, kw3, "relit render (view 0 under the "
                   "first light, before the calibration)")
    for name, src, rep, key, err, t, bd, what in (
            ("env_lookup_forward_envlight",
             "svgir_tpu_torch/csrc/env_lookup.cu",
             "svgir_tpu/ops/env_lookup_pallas.py:63", "env_lookup_forward",
             e7, t7, bnd_env, f"{fa[1].numel()} EnvLight queries, "
             f"{tuple(fa[0].shape)} map"),
            ("march_s384", "svgir_tpu_torch/csrc/march.cu",
             "svgir_tpu/ops/march_pallas.py:66", "march", e8, t8, bnd8,
             f"{len(o8)} rays of the S={RELIGHT_SAMPLES} bake; they visit "
             f"{work8['all_blocks']} blocks, {work8['blocks']} before their "
             f"lists settle, {work8['distinct_blocks']} distinct"),
            ("blend_forward_relight", "svgir_tpu_torch/csrc/blend_forward.cu",
             "svgir_tpu/ops/blend_pallas_strip.py:51", "blend_forward", e3,
             t3, bnd3, f"the relit render, CA {kw3['ca']} / CV "
             f"{kw3['cv']}")):
        report.append({"name": name, "route": "cuda", "source": src,
                       "replaces": rep, "launches": launches[key],
                       "max_abs_err": err, **t, "bound_ms": bd[0],
                       "bound_by": bd[1]})
        log(f"[relight timing] {name} ({what}): "
            + fmt_times(t, "grid_sample") + f", bound {bd[0]:.4f} ms by "
            f"{bd[1]}; {launches[key]} launches in the relighting run; "
            f"card: {card}")
    if not (kw3["ca"] <= 32 and kw3["cv"] <= 16):
        raise AssertionError(f"relit render at CA {kw3['ca']} / CV "
                             f"{kw3['cv']}: past the blend's bound")
    log(f"[relight] {time.time() - t_phase:.1f} s")

    # ---- 27. visibility: finetune_visibility at full width ---------------
    t_phase = time.time()
    vstate = {**st, "params": params}
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with Recorder(GT, "build_grid_auto") as r_build, \
            Recorder(GT, "trace_visibility_grid") as r_vis:
        out = G.finetune_visibility(
            vstate, iterations=VIS_ITERS,
            generator=torch.Generator(device=dev).manual_seed(7))
    torch.cuda.synchronize()
    ft_s = time.perf_counter() - t0
    if len(r_vis.calls) != VIS_ITERS:
        raise AssertionError(f"finetune_visibility at {n} surfels traced "
                             f"{len(r_vis.calls)} times through the grid")
    for k in ("visibility_dc", "visibility_rest"):
        v = out["params"][k]
        if not bool(torch.isfinite(v).all()) or torch.equal(v, params[k]):
            raise AssertionError(f"finetune_visibility: {k} not updated")
    (geo_v, grid_v, o_v, d_v), vkw, tr0, _ = r_vis.calls[0]
    trace_s = [c[3] for c in r_vis.calls]
    vis0 = tr0["visibility"][:, 0]
    with torch.no_grad():
        _, cells_v, _, _ = GT._vis_runs(grid_v, o_v, d_v, **vkw)
        blocks = int(((torch.clamp(grid_v.cell_count[cells_v],
                                   max=grid_v.cell_cap) + GT.BLK - 1)
                      // GT.BLK).sum())
    log(f"[visibility] finetune_visibility, {n} surfels, {VIS_ITERS} "
        f"iterations: {ft_s:.3f} s ({ft_s / VIS_ITERS * 1e3:.1f} ms an "
        f"iteration with the grid build of {r_build.calls[0][3]:.3f} s; "
        f"res {grid_v.res}, cap {grid_v.cell_cap}, {grid_v.big_ids.shape[0]}"
        f" big surfels, n_steps {vkw['n_steps']}, t_max {vkw['t_max']:.4f};"
        f" the first iteration's rays visit {len(cells_v)} cell runs, "
        f"{blocks} blocks of {GT.BLK} candidates);"
        f" trace_visibility_grid per iteration "
        + ", ".join(f"{s * 1e3:.1f}" for s in trace_s) + " ms; first "
        f"iteration's targets: visible {float((vis0 > 0).float().mean()):.4f}"
        f", mean contribute {float(tr0['contribute'].float().mean()):.3f}; "
        f"card: {card}")

    # the grid against the port's brute tracer, and against the grid's own
    # acceptance tested densely, on 4,096 of the first iteration's rays
    sel = torch.arange(0, len(o_v), max(len(o_v) // 4096, 1),
                       device=dev)[:4096]
    ro, rd = o_v[sel], d_v[sel]
    with torch.no_grad():
        vg = GT.trace_visibility_grid(geo_v, grid_v, ro, rd, **vkw)
        vb = TR.trace_visibility(geo_v, ro, rd)
        packed = GT.pack_geometry(geo_v)[:-1]
        big = torch.zeros(len(packed), dtype=torch.bool, device=dev)
        big[grid_v.big_ids.long()] = True
        # the walk's steps end at n_steps dt; the big surfels' pass at t_max
        lo = torch.full((), 0.01, device=dev)
        log_t = torch.zeros(len(ro), dtype=torch.float64, device=dev)
        for rows_, hi in ((torch.nonzero(~big)[:, 0], min(
                vkw["t_max"], vkw["n_steps"] * float(GT.grid_dt(grid_v)))),
                (torch.nonzero(big)[:, 0], vkw["t_max"])):
            for c0 in range(0, len(rows_), 256):
                pk = packed[rows_[c0:c0 + 256]][None]
                cand = GT._test_candidates(pk, ro, rd, lo,
                                           torch.full((), hi, device=dev))
                log_t += GT._vis_terms(cand, pk[..., 24])[0].double()
    t_dense = torch.exp(log_t)
    clear = (t_dense - 0.9).abs() >= VIS_CLEAR
    dense = torch.where(t_dense < 0.9, torch.zeros_like(t_dense), t_dense)
    e_dense = float((vg["visibility"][:, 0].double() - dense)[clear].abs()
                    .max())
    differ = int(((vg["visibility"] - vb["visibility"]).abs()
                  > TOL_VIS).sum())
    log(f"[visibility] 4096 rays: the grid against its own acceptance "
        f"tested densely within {e_dense:.3g} on the {int(clear.sum())} rays"
        f" clear of the 0.9 cut; the grid against the brute tracer: "
        f"{differ} rays differ by more than {TOL_VIS} (different functions "
        f"by design: the brute tracer takes the max-density point and has "
        f"no ellipse test); visible: grid {int((vg['visibility'] > 0).sum())}"
        f", brute {int((vb['visibility'] > 0).sum())}")
    if e_dense > TOL_VIS or int(clear.sum()) < 0.95 * len(ro):
        raise AssertionError(f"grid visibility differs from its dense "
                             f"oracle by {e_dense}")
    # the card against the CPU on 2,048 of those rays, on one grid
    grid_c = GT.TraceGrid(*[x.cpu() if isinstance(x, torch.Tensor) else x
                            for x in grid_v])
    geo_c = TR.SurfelGeometry(*[x.cpu() for x in geo_v])
    vc = GT.trace_visibility_grid(geo_c, grid_c, ro[:SUBSET].cpu(),
                                  rd[:SUBSET].cpu(), **vkw)
    ok = clear[:SUBSET].cpu()
    e_cpu = float((vg["visibility"][:SUBSET].cpu() - vc["visibility"])[ok]
                  .abs().max())
    n_cnt = int((vg["contribute"][:SUBSET].cpu() != vc["contribute"])
                .sum())
    log(f"[visibility] card vs CPU on {SUBSET} rays: visibility within "
        f"{e_cpu:.3g} on the rays clear of the cut, contribute differs on "
        f"{n_cnt}")
    if e_cpu > TOL_VIS or n_cnt > 0.001 * SUBSET:
        raise AssertionError(f"visibility: card vs CPU differ by {e_cpu}, "
                             f"{n_cnt} counts")
    log(f"[visibility] {time.time() - t_phase:.1f} s")
    return report


# ---------------------------------------------------------------------------
# the evaluation and viewing commands, render_sh, the stand-in harness
# ---------------------------------------------------------------------------

EVAL_KERNELS = ("binning_counts", "binning_instances", "blend_forward")
TRAJ_FRAMES = 12        # frames of configs/example/ the relighting runs
# normal_eval of frames against themselves: arccos of a float32 dot
# product a few last places below 1 is up to ~0.04 degrees, not 0
MAE_SELF_TOL = 0.05     # degrees
RENDER_SH_RAYS = 4096   # rays near the image centre held grid vs brute
TOL_RENDER_SH = 1e-5    # tests/test_render_sh.py's grid vs brute
# tests/test_e2e_parity.py: the thresholds of each configuration and, for
# the medium one, the JAX package's CPU numbers in its docstring
STANDIN = {
    "pipeline": (dict(n_gt=250, n_views=8, res=40, sample_num=8,
                      stage1_iters=200, stage2_iters=100, init_points=120,
                      capacity=512),
                 {"n_alive_after_stage1": 150, "stage1_nvs_psnr": 12.0,
                  "stage2_pbr_psnr": 11.5, "relight_psnr": 12.0,
                  "albedo_psnr": 16.0}, None),
    "medium": (dict(n_gt=1000, n_views=12, res=64, sample_num=8,
                    stage1_iters=600, stage2_iters=250, init_points=400,
                    capacity=16384),
               {"n_alive_after_stage1": 8000, "stage1_nvs_psnr": 15.6,
                "stage2_pbr_psnr": 16.6, "relight_psnr": 17.0,
                "albedo_psnr": 18.5},
               {"n_alive_after_stage1": 12711, "stage1_nvs_psnr": 17.1,
                "stage2_pbr_psnr": 18.1, "relight_psnr": 18.5,
                "albedo_psnr": 20.0}),
}


def _overflowed(res):
    return bool(res["overflow"].any()) if "overflow" in res else False


def probe_views(state, cams):
    """The snug instance cap of every view of ``cams`` (the probe itself
    bins only three), the largest of them."""
    from svgir_tpu_torch.config import RasterConfig
    from svgir_tpu_torch.train import cap_probe
    return max(cap_probe.snug_instance_cap(state["params"], [c],
                                           RasterConfig(),
                                           alive=state["alive"])
               for c in cams)


def write_relight_config(root, ply, example):
    """A config directory composing ``ply`` twice (at the identity, and
    turned 2.8 rad about y, scaled by 0.8 and moved 2.5) with the first
    TRAJ_FRAMES frames of ``example``'s trajectory and light rotations.
    Those frames look along +z from z = -3 to -1.2, where phase 25's
    surfels (identity rotations from the bootstrap cloud, barely trained)
    show their back faces, which the rasterizer culls: the turn makes the
    second copy face them, and its move (to 35 degrees off +z, on the far
    side) keeps it in their view.  Returns the second transform."""
    import json
    import os

    import numpy as np

    os.makedirs(root)
    a, b = 2.8, math.radians(-35.0)
    tf = np.eye(4)
    tf[:3, :3] = 0.8 * np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                                 [-math.sin(a), 0, math.cos(a)]])
    tf[:3, 3] = [2.5 * math.sin(b), 0.0, 2.5 * math.cos(b)]
    with open(os.path.join(root, "transform.json"), "w") as f:
        json.dump({"a": {"path": ply, "transform": np.eye(4).ravel()
                         .tolist()},
                   "b": {"path": ply, "transform": tf.ravel().tolist()}}, f)
    for name, key in (("trajectory", "trajectory"),
                      ("light_transform", "transform")):
        with open(os.path.join(example, f"{name}.json")) as f:
            d = json.load(f)
        d[key] = {k: v for k, v in list(d[key].items())[:TRAJ_FRAMES]}
        with open(os.path.join(root, f"{name}.json"), "w") as f:
            json.dump(d, f)
    return tf


def run_eval_commands(card, dev, tmp, scene, ck60, ck63, ply, hdrs):
    """Phases 28-29: the eval_nvs, relighting, normal_eval and gui
    commands on phase 25's scene and checkpoints."""
    import contextlib
    import io
    import json
    import os

    import numpy as np
    import torch

    from svgir_tpu_torch import kernels
    from svgir_tpu_torch.cli import eval_nvs, gui, normal_eval
    from svgir_tpu_torch.cli import relighting as cli_rl
    from svgir_tpu_torch.data import readers
    from svgir_tpu_torch.eval import nvs
    from svgir_tpu_torch.eval import relighting as REL
    from svgir_tpu_torch.models import gaussians as G
    from svgir_tpu_torch.render import stage1, svgss
    from svgir_tpu_torch.train import checkpoint as CK

    t_phase = time.time()
    # ---- 28. eval_nvs: stage 1 at scale 4 and 1, stage 2, its bake -----
    sc = readers.load_scene(scene, eval_split=True)
    cams = sc.train_cameras + sc.test_cameras
    _, t63 = CK.load_checkpoint(ck63, device=dev)
    cap = max(probe_views(CK.load_checkpoint(ck, device=dev)[1]["state"],
                          cams) for ck in (ck60, ck63))
    nobake = os.path.join(tmp, "chkpnt63_nobake.npz")
    CK.save_checkpoint(nobake, 63, t63["state"], t63["opt"], env=t63["env"])
    n63 = int(t63["state"]["alive"].sum())
    del t63
    runs = (("stage 1, scale 4", ["-c", ck60], EVAL_KERNELS),
            ("stage 1, scale 1", ["-c", ck60, "--eval_scale", "1"],
             EVAL_KERNELS),
            ("stage 2, its bake", ["-c", ck63, "-t", "render_relight",
                                   "--skip_train"],
             EVAL_KERNELS + ("env_lookup_forward",)),
            ("stage 2, no bake", ["-c", nobake, "-t", "render_relight",
                                  "--skip_train"],
             EVAL_KERNELS + ("env_lookup_forward", "march")))
    for i, (label, flags, needed) in enumerate(runs):
        out = os.path.join(tmp, f"nvs{i}")
        torch.cuda.synchronize()
        kernels.reset_launches()
        with Recorder(stage1, "render_stage1", keep=0,
                      inspect=_overflowed) as r1, \
                Recorder(svgss, "render_svgss", keep=0,
                         inspect=_overflowed) as r2, \
                Recorder(nvs, "render_set", keep=0) as r_set, \
                Recorder(eval_nvs, "bake_once", keep=0) as r_bake, \
                contextlib.redirect_stdout(io.StringIO()) as printed:
            t0 = time.perf_counter()
            res = eval_nvs.main(["-s", scene, "-m", out, "--max_instances",
                                 str(cap)] + flags)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
        lc = kernels.launches()
        check_launches(lc, f"eval_nvs {label}",
                       at_least=[(k, 1) for k in needed],
                       none=("blend_backward", "env_lookup_backward")
                       + (() if "march" in needed else ("march",)))
        if json.loads(printed.getvalue()) != res:
            raise AssertionError(f"eval_nvs {label}: printed JSON differs")
        views = r1.secs + r2.secs
        if any(r1.seen + r2.seen):
            raise AssertionError(f"eval_nvs {label}: binner overflow at "
                                 f"cap {cap}")
        for split, m in res.items():
            with open(os.path.join(out, "eval", split, "metrics.json")) as f:
                if json.load(f) != m:
                    raise AssertionError(f"eval_nvs {label}: {split}'s "
                                         "metrics.json differs")
            if not (math.isfinite(m["psnr"]) and math.isfinite(m["ssim"])):
                raise AssertionError(f"eval_nvs {label}: {m}")
        if len(r_bake.secs) != (1 if "march" in needed else 0):
            raise AssertionError(f"eval_nvs {label}: baked "
                                 f"{len(r_bake.secs)} times")
        w = cams[0].width / float(flags[flags.index("--eval_scale") + 1]
                                  if "--eval_scale" in flags else 4.0)
        log(f"[nvs] {label}: {total:.2f} s, {len(views)} views of "
            f"{int(w)}x{int(w)} at cap {cap}: render "
            f"{statistics.median(views) * 1e3:.2f} ms a view (median), "
            f"render_set {sum(r_set.secs) / len(views) * 1e3:.2f} ms a view"
            f" with metrics and PNGs"
            + (f"; bake once at k 16 over {n63} surfels "
               f"{r_bake.secs[0]:.3f} s" if r_bake.secs else "")
            + f"; {json.dumps(res)}; launches {lc}; card: {card}")
    log(f"[nvs] {time.time() - t_phase:.1f} s")

    # ---- 29. relighting (composition), normal_eval, gui -------------------
    t_phase = time.time()
    example = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs", "example")
    cfg_dir = os.path.join(tmp, "relight_config")
    tf = write_relight_config(cfg_dir, ply, example)
    entries, traject, _ = cli_rl.load_config(cfg_dir)
    with torch.no_grad():
        comp = cli_rl.compose(entries, device=dev)
    tcams, _ = cli_rl.trajectory_cameras(traject, device=dev)
    cap_rl = probe_views(comp, tcams)
    # the composition: twice the PLY's surfels, each half the PLY under
    # its transform (the identity too: a split child's log-scale of
    # -1e10 becomes -inf there, as in the reference)
    one = CK.load_model_ply(ply, device=dev)
    n1 = int(one["alive"].sum())
    if int(comp["alive"].sum()) != 2 * n1 or not bool(
            comp["alive"][:2 * n1].all()):
        raise AssertionError(f"composition: {int(comp['alive'].sum())} "
                             f"alive for 2 x {n1}")
    worst = 0.0
    for half, m in enumerate((np.eye(4), tf)):
        with torch.no_grad():
            want = G.apply_transform(
                {k: v[:n1] for k, v in one["params"].items()},
                torch.as_tensor(m, dtype=torch.float32, device=dev))
        for k in ("xyz", "scaling", "rotation"):
            got = comp["params"][k][half * n1:(half + 1) * n1]
            diff = torch.where(got == want[k], torch.zeros_like(got),
                               (got - want[k]).abs())
            worst = max(worst, float(diff.max()))
    if not worst <= 1e-6:
        raise AssertionError(f"composition: a half differs from "
                             f"apply_transform by {worst}")
    log(f"[relighting] composed {2 * n1} surfels (2 x {n1}; each half "
        f"within {worst:.3g} of apply_transform); cap {cap_rl} over the "
        f"{len(tcams)} trajectory views")
    del comp, one, want

    def relight(label, argv, frame_ids, captures):
        out = argv[argv.index("--output") + 1]
        torch.cuda.synchronize()
        kernels.reset_launches()
        video = io.StringIO()
        write = cli_rl.write_videos

        def quiet_write(*a, **kw):
            with contextlib.redirect_stdout(video):
                return write(*a, **kw)
        cli_rl.write_videos = quiet_write
        try:
            with Recorder(REL, "rebake_radiance_for_light", keep=0) as r_b, \
                    Recorder(svgss, "render_svgss", keep=0,
                             inspect=_overflowed) as r_f, \
                    Recorder(cli_rl, "write_videos", keep=0) as r_v, \
                    contextlib.redirect_stdout(io.StringIO()):
                t0 = time.perf_counter()
                cli_rl.main(argv)
                torch.cuda.synchronize()
                total = time.perf_counter() - t0
        finally:
            cli_rl.write_videos = write
        lc = kernels.launches()
        check_launches(lc, f"relighting {label}",
                       at_least=[(k, 1) for k in EVAL_KERNELS
                                 + ("env_lookup_forward", "march")],
                       none=("blend_backward", "env_lookup_backward"))
        if len(r_b.secs) != 1 or len(r_f.secs) != len(frame_ids) or \
                any(r_f.seen):
            raise AssertionError(f"relighting {label}: {len(r_b.secs)} "
                                 f"bakes, {len(r_f.secs)} frames, overflow "
                                 f"{sum(r_f.seen)}")
        for ct in captures:
            for fid in frame_ids:
                if not os.path.exists(os.path.join(out, ct,
                                                   f"frame_{fid}.png")):
                    raise AssertionError(f"relighting {label}: no {ct} "
                                         f"frame {fid}")
        said = video.getvalue().strip()
        mp4 = [ct for ct in captures
               if os.path.exists(os.path.join(out, f"{ct}.mp4"))]
        if len(mp4) != len(captures) and "video export skipped" not in said:
            raise AssertionError(f"relighting {label}: mp4s {mp4}, {said!r}")
        log(f"[relighting] {label}: {total:.2f} s: bake {r_b.secs[0]:.3f} "
            f"s, {len(r_f.secs)} frames {statistics.median(r_f.secs) * 1e3:.2f}"
            f" ms a frame (median render), video {r_v.secs[0]:.3f} s "
            f"({said!r}); launches {lc}; card: {card}")
        return out

    fids = [str(i) for i in range(TRAJ_FRAMES)]
    captures = ("pbr_env", "normal", "roughness")
    for path in hdrs:
        name = os.path.splitext(os.path.basename(path))[0]
        out = relight(f"composed, {name}, 800x800",
                      ["--config", cfg_dir, "--hdr", path, "--output",
                       os.path.join(tmp, f"relight_{name}"),
                       "--capture_list", ",".join(captures),
                       "--max_instances", str(cap_rl)], fids, captures)
        first = out
    orbit_cams = cli_rl.orbit_cameras(8, 3.0, 0.5, math.pi / 3, 512,
                                      device=dev)
    cap_orbit = probe_views(CK.load_model_ply(ply, device=dev), orbit_cams)
    relight("the PLY alone, orbit, --rotate_light, 512x512",
            ["--config", ply, "--hdr", hdrs[0], "--output",
             os.path.join(tmp, "relight_orbit"), "--rotate_light",
             "--frames", "8", "--resolution", "512", "--max_instances",
             str(cap_orbit)], [str(i) for i in range(8)], ("pbr_env",))

    normal_dir = os.path.join(first, "normal")
    with contextlib.redirect_stdout(io.StringIO()):
        mae = normal_eval.main(["--pred_dir", normal_dir, "--gt_dir",
                                normal_dir])
    if not 0.0 <= mae < MAE_SELF_TOL:
        raise AssertionError(f"normal_eval of frames against themselves: "
                             f"MAE {mae} degrees")
    log(f"[relighting] normal_eval of the {TRAJ_FRAMES} normal frames "
        f"against themselves: MAE {mae!r} degrees")

    gui_out = os.path.join(tmp, "gui")
    gcams = []
    for i in range(4):
        oc = gui.OrbitCamera(512, 512, device=dev)
        oc.azimuth = 2 * math.pi * i / 4
        gcams.append(oc.camera())
    cap_gui = probe_views(CK.load_checkpoint(ck63, device=dev)[1]["state"],
                          gcams)
    torch.cuda.synchronize()
    kernels.reset_launches()
    with Recorder(svgss, "render_svgss", keep=0, inspect=_overflowed) as r_g, \
            contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        gui.main(["-c", ck63, "--headless", "--frames", "4", "--resolution",
                  "512", "--max_instances", str(cap_gui), "--output",
                  gui_out])
        torch.cuda.synchronize()
        gui_s = time.perf_counter() - t0
    lc = kernels.launches()
    check_launches(lc, "gui", at_least=[(k, 1) for k in EVAL_KERNELS
                                        + ("env_lookup_forward",)])
    if sorted(os.listdir(gui_out)) != [f"{i:04d}.png" for i in range(4)] \
            or any(r_g.seen):
        raise AssertionError(f"gui: {sorted(os.listdir(gui_out))}, overflow"
                             f" {sum(r_g.seen)}")
    log(f"[relighting] gui --headless: 4 frames at 512x512 in {gui_s:.2f} s "
        f"({statistics.median(r_g.secs) * 1e3:.2f} ms a render); launches "
        f"{lc}; card: {card}")
    log(f"[relighting] {time.time() - t_phase:.1f} s")


def run_render_sh(card, dev):
    """Phase 30: render_sh_image on the inward bench scene at 800x800 (the
    grid tracer, B8 on camera rays); returns B8's kernels-JSON rows (its
    first chunk and the chunk whose rays hit most)."""
    import torch

    from svgir_tpu_torch import kernels
    from svgir_tpu_torch.eval import render_sh as RS
    from svgir_tpu_torch.models import gaussians as G
    from svgir_tpu_torch.ops import grid_tracer as GT
    from svgir_tpu_torch.ops import march_pallas as MP
    from svgir_tpu_torch.ops import tracing as TR
    from svgir_tpu_torch.utils import profiling

    t_phase = time.time()
    state, cam = bench_scene(dev, inward=True)
    p = state["params"]
    args = (p["xyz"], G.get_scaling(p), G.get_rotation(p),
            G.get_opacity(p)[:, 0], G.get_shs(p))
    torch.cuda.synchronize()
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with Recorder(GT, "nearest_hits_grid") as r_grid, \
            profiling.Timing("render_sh", verbose=False) as timing:
        img = RS.render_sh_image(*args, cam, valid=state["alive"])
        timing.result = img
    render_s = timing.ms / 1e3
    peak = profiling.device_memory_stats(dev)["allocated_bytes.all.peak"]
    launches = kernels.launches()
    check_launches(launches, "render_sh", at_least=[("march", 1)],
                   none=("blend_forward", "env_lookup_forward"))
    n_chunks = len(r_grid.secs)
    hit = img["hit"].reshape(-1)
    if not bool(torch.isfinite(img["render"]).all()) or \
            not bool((hit >= 0).any()) or n_chunks != launches["march"]:
        raise AssertionError(f"render_sh: finite "
                             f"{bool(torch.isfinite(img['render']).all())}, "
                             f"{int((hit >= 0).sum())} hits, {n_chunks} "
                             f"chunks, {launches['march']} B8 launches")
    # B8 against its plain version on the first 65,536-ray chunk (the top
    # rows: long marches from outside the grid through empty cells) and on
    # the chunk whose rays hit most
    grid = r_grid.calls[0][0][1]
    hkw = r_grid.calls[0][1]
    mkw = dict(t_max=hkw["t_max"], k=hkw["k"],
               n_steps=GT._concrete_n_steps(grid, hkw["t_max"]),
               kmax=GT._run_kmax(grid))
    full = max(range(n_chunks), key=lambda i: int(torch.isfinite(
        r_grid.calls[i][2]["t"]).sum()))
    chunks = {}
    for label, i in (("first", 0), ("fullest", full)):
        o, d = r_grid.calls[i][0][2:4]
        with torch.no_grad():
            kt, ki = MP.march(grid, o, d, **mkw)
            pt, pi = MP.march_plain(grid, o, d, **mkw)
        torch.cuda.synchronize()
        fin = torch.isfinite(pt)
        bad = int(((ki != pi) | (torch.isfinite(kt) != fin)
                   | (fin & (kt != pt))).sum())
        both = fin & torch.isfinite(kt)
        err = float((kt - pt)[both].abs().max()) if bool(both.any()) else 0.0
        n_fin = int(fin.sum())
        log(f"[render_sh] B8 vs plain on the {label} chunk (chunk {i}): "
            f"{len(o)} camera rays (grid res {grid.res}, cap "
            f"{grid.cell_cap}, n_steps {mkw['n_steps']}, t_max "
            f"{mkw['t_max']:.4f}): {n_fin} finite slots, "
            f"{int(fin[:, -1].sum())} full lists, {bad} slots differ, "
            f"max|t err| {err:.3g}")
        if bad > MARCH_SLOT_TOL * max(n_fin, 1) or \
                (label == "fullest" and n_fin == 0):
            raise AssertionError(f"render_sh: B8 differs from its plain "
                                 f"version at {bad} of {n_fin} finite slots "
                                 f"of the {label} chunk")
        chunks[label] = (i, o, d, pt, err)
    del r_grid
    # the grid image against the brute tracer on the rays nearest the
    # image centre (a 64 x 64 window)
    h, w = cam.height, cam.width
    ys, xs = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    dist = (ys - h / 2) ** 2 + (xs - w / 2) ** 2
    sel = torch.argsort(dist.reshape(-1), stable=True)[:RENDER_SH_RAYS]
    rays_d = cam.world_directions().reshape(3, -1).T[sel].contiguous()
    rays_o = cam.camera_center[None].expand_as(rays_d).contiguous()
    geo_b = TR.build_surfel_geometry(*args[:4], valid=state["alive"])
    with torch.no_grad():
        hb = TR.nearest_hits(geo_b, rays_o, rays_d, k=hkw["k"])
        mb = TR.radiance_march(hb, torch.full((len(sel),), -1,
                                              dtype=torch.int32, device=dev),
                               args[4], args[0], rays_o, **RS._CAMERA_WINDOWS)
    n_hit = int((mb["first_hit"] >= 0).sum())
    same_hit = bool(torch.equal(mb["first_hit"], hit[sel]))
    e_img = float((mb["radiance"].T - img["render"].reshape(3, -1)[:, sel])
                  .abs().max())
    log(f"[render_sh] grid against brute on the {RENDER_SH_RAYS} rays "
        f"nearest the centre: {n_hit} hit, hits equal {same_hit}, render "
        f"within {e_img:.3g}")
    if not same_hit or e_img > TOL_RENDER_SH or n_hit == 0:
        raise AssertionError(f"render_sh: grid vs brute hits equal "
                             f"{same_hit}, render {e_img}, {n_hit} hits")
    rows = []
    for label, name in (("first", "march_camera_rays"),
                        ("fullest", "march_camera_rays_hits")):
        i, o, d, pt, err = chunks[label]
        with torch.no_grad():
            t8 = timings(lambda: MP.march(grid, o, d, **mkw),
                         lambda: MP.march_plain(grid, o, d, **mkw), reps=10,
                         plain_reps=1)
        work = march_work(grid, o, d, pt, **{x: mkw[x] for x in
                                             ("n_steps", "kmax", "k")})
        bms, by = march_bound(work, len(o), mkw["k"])
        log(f"[render_sh] B8 on the {label} chunk (chunk {i}): "
            f"{fmt_times(t8)}, bound {bms:.4f} ms by {by}; its rays visit "
            f"{work['all_blocks']} blocks, {work['blocks']} before their "
            f"lists settle, {work['distinct_blocks']} distinct, in "
            f"{work['steps']} steps; card: {card}")
        rows.append({"name": name, "route": "cuda",
                     "source": "svgir_tpu_torch/csrc/march.cu",
                     "replaces": "svgir_tpu/ops/march_pallas.py:66",
                     "launches": launches["march"], "max_abs_err": err,
                     **t8, "bound_ms": bms, "bound_by": by})
    log(f"[render_sh] 800x800, {int(state['alive'].sum())} inward surfels, "
        f"{h * w} camera rays in {n_chunks} chunks: {render_s:.3f} s "
        f"(first call, utils/profiling.Timing), peak memory "
        f"{peak / 2**30:.3f} GiB (device_memory_stats), "
        f"{float((hit >= 0).float().mean()):.4f} of the rays hit; "
        f"{launches['march']} B8 launches an image; card: {card}")
    log(f"[render_sh] {time.time() - t_phase:.1f} s")
    return rows


def run_standin(card, dev):
    """Phase 31: the stand-in harness on the card at the configurations of
    tests/test_e2e_parity.py; the pipeline one must meet its thresholds."""
    import torch

    from svgir_tpu_torch import kernels
    from svgir_tpu_torch.eval.standin import run_standin_parity

    t_phase = time.time()
    for label, (kw, floor, jax_cpu) in STANDIN.items():
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = run_standin_parity(verbose=False, device=dev, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        lc = kernels.launches()
        check_launches(lc, f"stand-in {label}",
                       at_least=[(k, 1) for k in STAGE2_KERNELS])
        missed = [k for k, v in floor.items() if not out[k] > v]
        log(f"[standin] {label} ({kw}): {secs:.1f} s; " + ", ".join(
            f"{k} {out[k]:.4f} (threshold {floor[k]}"
            + (f", JAX on the CPU {jax_cpu[k]}" if jax_cpu else "") + ")"
            for k in floor) + f"; launches {lc}; card: {card}")
        if missed and label == "pipeline":
            raise AssertionError(f"stand-in {label} missed {missed}: {out}")
        if missed:
            log(f"[standin] {label} misses {missed} (a finding, not a "
                "failure)")
    log(f"[standin] {time.time() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# the parallel paths (phases 32-33): view data parallelism, the sharded
# rasterizer and the sharded bake on torch.distributed
# ---------------------------------------------------------------------------

PAR_SAMPLES = 8         # the sharded bake's S: 400,000 rays, brute tracer
PAR_WORLDS = (2, 4, 8)  # world sizes whose row imbalance and traffic count
TOL_PAR_GRAD = 1e-3     # sharded gradients, of each one's largest (TOL_ROWS)
TOL_PAR_MOMENT = 1e-5   # Adam moments, of each one's largest, where the
                        # gradients' atomics reorder sums between two runs
PAR_STEPS = 10          # timed repetitions of each parallel path
PAR_KR = 12 + 9 + 5     # slab columns at the stage-1 widths (S = 5)
PAR_CO = 9 + 5 + 3      # blend output channels at those widths
GSHARD_KERNELS = ("binning_counts", "binning_instances",
                  "blend_forward_tiles", "blend_backward_tiles")


def par_inputs(state, cam):
    """params -> the rasterizer's arguments at the stage-1 widths (shs;
    features [geo normal, depth, depth^2]; the alive mask)."""
    import torch

    from svgir_tpu_torch.models import gaussians as G

    def inputs(p):
        xyz = p["xyz"]
        hom = torch.cat([xyz, xyz.new_ones(xyz.shape[0], 1)], -1)
        depth = (hom @ cam.world_view.T)[:, 2:3]
        return ((xyz, G.get_scaling(p), G.get_rotation(p),
                 G.get_opacity(p)[:, 0]),
                dict(shs=G.get_shs(p), features=torch.cat(
                    [G.get_geo_normal(p), depth, depth * depth], -1),
                    mask=state["alive"]))
    return inputs


def par_target(cam, seed=11):
    import torch
    return torch.rand(3, cam.height, cam.width, device=cam.world_view.device,
                      generator=torch.Generator(
                          device=cam.world_view.device).manual_seed(seed))


def par_loss(bufs, tgt):
    """A loss of every blended channel but the depth (whose 1 / (1 - T)
    amplifies the last bits where opacity is small)."""
    return ((bufs.color - tgt).abs().mean() + 0.3 * bufs.normal.mean()
            + 0.2 * bufs.feature.mean() + 0.05 * bufs.opacity.mean()
            + 1e-6 * bufs.weights.sum())


def par_render(state, cam, tgt, render):
    """Forward and backward of ``render(args, kw)``: (buffers, gradients of
    the raw parameters)."""
    from svgir_tpu_torch.train.trainer import loss_grads

    p = {k: v.detach().requires_grad_(True)
         for k, v in state["params"].items()}
    args, kw = par_inputs(state, cam)(p)
    bufs = render(args, kw)
    gp, _ = loss_grads(par_loss(bufs, tgt), p, [])
    return bufs, {k: g.detach() for k, g in gp.items() if bool(
        (g != 0).any())}


def buffers_image(b):
    """[channel sums..., logT, n_contrib] of a render's buffers, for
    check_image (the depth is held apart)."""
    import torch
    return torch.cat([b.color, b.normal, b.feature, b.vfeature,
                      torch.log(b.final_t)[None],
                      b.n_contrib[None].to(torch.float32)]).detach()


def hold_render(a, ga, b, gb, tag):
    """A sharded render (a, its gradients ga) against a single-device one:
    check_image's tolerances on the channel sums, logT and n_contrib; the
    depth where the opacity passes 0.05 within TOL_S2_DEPTH relative; the
    weight sums within TOL_IMG relative; each gradient within TOL_PAR_GRAD
    of its largest magnitude.  Returns the worst errors."""
    nch = 6 + a.feature.shape[0] + a.vfeature.shape[0]
    e_img, e_lt, nc = check_image(buffers_image(a), buffers_image(b), nch,
                                  tag)
    m = b.opacity[0].detach() > 0.05
    e_d = float(((a.depth[0] - b.depth[0]).abs()
                 / b.depth[0].abs().clamp(min=1e-6))[m].detach().max())
    if e_d > TOL_S2_DEPTH:
        raise AssertionError(f"{tag}: depth differs by {e_d} (relative)")
    e_w = max_err_rel(a.weights, b.weights)
    if e_w > TOL_IMG:
        raise AssertionError(f"{tag}: weights differ by {e_w} of the max")
    if bool(a.overflow) or bool(b.overflow):
        raise AssertionError(f"{tag}: binner or exchange overflow")
    if sorted(ga) != sorted(gb):
        raise AssertionError(f"{tag}: other groups got gradients")
    e_g = max((max_err_rel(ga[k], gb[k]), k) for k in gb)
    if e_g[0] > TOL_PAR_GRAD:
        raise AssertionError(f"{tag}: d{e_g[1]} differs by {e_g[0]} of its "
                             "largest magnitude")
    return dict(img=e_img, logt=e_lt, n_contrib=nc, depth=e_d, weights=e_w,
                grad=e_g[0])


class deterministic:
    """PyTorch's deterministic algorithms (index_add_ and the gathers'
    backward without atomics), so that two runs of a step give the same
    bits where no hand-written kernel adds with atomics; uninitialized
    memory is left as it is."""

    def __enter__(self):
        import torch
        import torch.utils.deterministic as det
        self.saved = (torch.are_deterministic_algorithms_enabled(),
                      torch.is_deterministic_algorithms_warn_only_enabled(),
                      det.fill_uninitialized_memory)
        torch.use_deterministic_algorithms(True, warn_only=True)
        det.fill_uninitialized_memory = False

    def __exit__(self, *exc):
        import torch
        import torch.utils.deterministic as det
        torch.use_deterministic_algorithms(self.saved[0],
                                           warn_only=self.saved[1])
        det.fill_uninitialized_memory = self.saved[2]


def stable_keys(a, b):
    """The parameter groups whose values and moments two runs of one step
    (a, b: (params, opt_state)) give bit for bit."""
    import torch
    return [k for k in a[0] if torch.equal(a[0][k], b[0][k])
            and torch.equal(a[1]["m"][k], b[1]["m"][k])
            and torch.equal(a[1]["v"][k], b[1]["v"][k])]


def hold_step(a, b, tag, lrs, stable):
    """Two Adam steps' (params, opt_state) on the same state: bit-equal in
    the groups of ``stable``; elsewhere (a hand-written kernel's atomics
    order the sums differently from run to run) the first moments within
    TOL_PAR_MOMENT of their largest and the parameters equal where the
    gradient passes 1e-6 of its largest (the first step moves them by
    lr * sign(g)), within 2 lr elsewhere.  Returns the groups that differ
    in any bit."""
    import torch

    (pa, oa), (pb, ob) = a, b
    differ = [k for k in pb if not (torch.equal(pa[k], pb[k])
                                    and torch.equal(oa["m"][k], ob["m"][k])
                                    and torch.equal(oa["v"][k], ob["v"][k]))]
    for k in differ:
        if k in stable:
            raise AssertionError(f"{tag}: {k} is not bit-equal, though the "
                                 "single step gives it bit for bit")
        mb = ob["m"][k]
        if max_err_rel(oa["m"][k], mb) > TOL_PAR_MOMENT:
            raise AssertionError(f"{tag}: the first moment of {k} differs")
        big = mb.abs() >= 1e-6 * float(mb.abs().max())
        d = (pa[k] - pb[k]).abs()
        if bool((d[big] > 1e-6 * (1 + pb[k].abs()[big])).any()) or \
                bool((d[~big] > 2 * lrs[k]).any()):
            raise AssertionError(f"{tag}: the parameters of {k} differ")
    return differ


def exchange_need(state, cam, cfg, starts):
    """The exchange cap a partition needs: the most splats one rank's shard
    of the Gaussians sends one band."""
    import torch

    from svgir_tpu_torch.models import gaussians as G
    from svgir_tpu_torch.parallel import gshard

    p = state["params"]
    with torch.no_grad():
        prep = gshard._project(p["xyz"], G.get_scaling(p), G.get_rotation(p),
                               cam, cfg)
    d = len(starts) - 1
    valid = prep.valid & state["alive"]
    n_l = valid.shape[0] // d
    need = 0
    for src in range(d):
        sl = slice(src * n_l, (src + 1) * n_l)
        for r in range(d):
            ov = valid[sl] & (prep.rect_min[sl, 1] < starts[r + 1]) & \
                (prep.rect_max[sl, 1] > starts[r])
            need = max(need, int(ov.sum()))
    return need


def traffic(n, kr, tiles, co, tile, d, cap=None):
    """Bytes a rank receives in one forward of rasterize_sharded over d
    ranks: the all-gathers of slab, depth, validity, rects and radii
    (or, with ``cap``, the two all-to-alls of [d, cap] slab and metadata
    rows, the weight sums' way back and their gather), the weights'
    all-reduce (a ring: twice (d-1)/d of it) and the gather of the
    bands."""
    part = (d - 1) / d
    image = part * tiles * co * tile * tile * 4
    if cap is None:
        return part * n * (4 * kr + 4 + 1 + 16 + 4) + 2 * part * n * 4 \
            + image
    return part * d * cap * (4 * kr + 24 + 4) + part * n * (4 + 4) + image


def run_parallel(card, dev, state, cam, opt, cfg, bg, s3_args):
    """Phase 32: the parallel paths at world size 1 on NCCL, at full width;
    returns {path: launches}."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    from svgir_tpu_torch import kernels
    from svgir_tpu_torch.models import gaussians as G
    from svgir_tpu_torch.models import radiance as RAD
    from svgir_tpu_torch.ops.rasterizer import rasterize
    from svgir_tpu_torch.parallel import dp, gshard
    from svgir_tpu_torch.train import optim, trainer

    t_phase = time.time()
    paths = {}
    tmp = tempfile.mkdtemp()
    dp.init_distributed(f"file://{os.path.join(tmp, 'store')}", 1, 0,
                        device=dev)
    log(f"[parallel] world 1, backend {dist.get_backend()}, "
        f"torch {torch.__version__}")
    mesh = dp.make_mesh(device_type=torch.device(dev).type)

    def launched(label, fn, at_least, none=()):
        torch.cuda.synchronize()
        kernels.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        lc = kernels.launches()
        check_launches(lc, label, at_least=[(k, 1) for k in at_least],
                       none=none)
        paths[label] = lc
        return out

    # ---- DP stage 1: make_dp_train_step against make_train_step ---------
    lrs = optim.group_lrs(opt, 1.0)
    step1 = trainer.make_train_step(opt, cfg, bg, lrs=lrs, device=dev)
    dstep1 = dp.make_dp_train_step(mesh, opt, cfg, bg, lrs=lrs, device=dev)
    ost0 = optim.adam_init(state["params"])
    batch = dp.stack_cameras([cam])
    with deterministic():
        s_a = step1(state, ost0, cam, 1.0, 1.6e-4)
        s_b = step1(state, ost0, cam, 1.0, 1.6e-4)
        d1 = launched("dp stage 1", lambda: dstep1(state, ost0, batch, 1.0,
                                                   1.6e-4), STAGE1_KERNELS)
    stable = stable_keys((s_a[0]["params"], s_a[1]),
                         (s_b[0]["params"], s_b[1]))
    lrs1 = {**lrs, "xyz": 1.6e-4}
    diff = hold_step((d1[0]["params"], d1[1]), (s_a[0]["params"], s_a[1]),
                     "dp stage 1", lrs1, stable)
    for k in ("xyz_gradient_accum", "weights_accum", "denom",
              "max_radii2d"):
        if max_err_rel(d1[0]["stats"][k], s_a[0]["stats"][k]) > \
                (0 if not diff else TOL_PAR_MOMENT):
            raise AssertionError(f"dp stage 1: statistics {k} differ")
    if abs(float(d1[2]["loss"]) - float(s_a[2]["loss"])) > 1e-6:
        raise AssertionError("dp stage 1: loss differs")
    t1 = [host_ms(lambda: step1(state, ost0, cam, 1.0, 1.6e-4),
                  reps=PAR_STEPS),
          host_ms(lambda: dstep1(state, ost0, batch, 1.0, 1.6e-4),
                  reps=PAR_STEPS)]
    t1 += [host_ms(lambda: dstep1(state, ost0, batch, 1.0, 1.6e-4),
                   reps=PAR_STEPS),
           host_ms(lambda: step1(state, ost0, cam, 1.0, 1.6e-4),
                   reps=PAR_STEPS)]
    log(f"[parallel] dp stage 1 at world 1 (deterministic algorithms): "
        + ("bit-equal to make_train_step" if not diff else
           f"{diff} differ in some bit, as two runs of make_train_step do;"
           " within tolerances")
        + f"; step {(t1[1] + t1[2]) / 2:.3f} ms against make_train_step's "
        f"{(t1[0] + t1[3]) / 2:.3f} ms (in turns: "
        + ", ".join(f"{x:.3f}" for x in t1) + "); "
        f"launches {paths['dp stage 1']}; card: {card}")

    # ---- DP stage 2 at S = 64, on the main path's bake ----------------
    st3, _, env3, bake3, cam3, it3, xyz3, rad3 = s3_args
    lrs2 = optim.group_lrs(opt, 1.0, use_pbr=True)
    step2 = trainer.make_svgss_train_step(opt, cfg, bg, lrs=lrs2, device=dev)
    dstep2 = dp.make_dp_svgss_train_step(mesh, opt, cfg, bg, lrs=lrs2,
                                         device=dev)
    ost3 = optim.adam_init(st3["params"])
    args2 = (st3, ost3, env3, bake3)
    batch3 = dp.stack_cameras([cam3])

    def joint(r):
        """(params, opt_state) of a stage-2 step, the env among them."""
        return ({**r[0]["params"], "env": r[2]["params"]["env"]},
                {x: {**r[1][x], "env": r[2]["opt"][x]["env"]}
                 for x in ("m", "v")})
    with deterministic():
        s2a = joint(step2(*args2, cam3, it3, xyz3, rad3))
        s2b = joint(step2(*args2, cam3, it3, xyz3, rad3))
        d2 = joint(launched("dp stage 2", lambda: dstep2(
            *args2, batch3, it3, xyz3, rad3), STAGE2_KERNELS))
    lrs2s = {**lrs2, "xyz": xyz3, "radiances": rad3, "env": opt.env_lr}
    diff2 = hold_step(d2, s2a, "dp stage 2", lrs2s, stable_keys(s2a, s2b))
    t2 = [host_ms(lambda: step2(*args2, cam3, it3, xyz3, rad3), reps=5),
          host_ms(lambda: dstep2(*args2, batch3, it3, xyz3, rad3), reps=5)]
    log(f"[parallel] dp stage 2 at S = {BAKE_SAMPLES} on the main path's "
        f"bake, world 1 (deterministic algorithms): "
        + ("bit-equal to make_svgss_train_step" if not diff2 else
           f"{diff2} differ in some bit, as two runs of "
           "make_svgss_train_step do (B7's atomics); within tolerances")
        + f"; step {t2[1]:.3f} ms against {t2[0]:.3f} ms; launches "
        f"{paths['dp stage 2']}; card: {card}")

    # ---- rasterize_sharded against rasterize at strip 0 (B5/B6) ---------
    import dataclasses
    cfg0 = dataclasses.replace(cfg, strip=0)
    tgt = par_target(cam)
    p = state["params"]
    hist = gshard.row_instance_histogram(
        p["xyz"], G.get_scaling(p), G.get_rotation(p), G.get_opacity(p)[:, 0],
        cam, mask=state["alive"], cfg=cfg)
    starts1 = gshard.balanced_row_starts(hist, 1)
    need1 = exchange_need(state, cam, cfg, starts1)
    def single_fn(a, kw):
        return rasterize(*a, cam, bg, cfg=cfg0, **kw)

    single = launched("rasterize strip 0",
                      lambda: par_render(state, cam, tgt, single_fn),
                      GSHARD_KERNELS)

    def sharded(cap, starts):
        return lambda a, kw: gshard.rasterize_sharded(
            mesh, "data", *a, cam, bg, cfg=cfg, exchange_cap=cap,
            row_starts=starts, **kw)

    variants = {"all-gather": (None, None), "exchange": (need1, None),
                "balanced": (None, starts1)}
    errs = {}
    for name, (cap, starts) in variants.items():
        out = launched(f"rasterize_sharded {name}",
                       lambda: par_render(state, cam, tgt,
                                          sharded(cap, starts)),
                       GSHARD_KERNELS, none=("blend_forward",
                                             "blend_backward"))
        errs[name] = hold_render(*out, *single, f"rasterize_sharded {name}")
    torch.save({"bufs": {f: getattr(single[0], f).detach().cpu() for f in
                         single[0]._fields},
                "grads": {k: v.cpu() for k, v in single[1].items()}},
               os.path.join(tmp, "single.pt"))

    def fwd(render):
        with torch.no_grad():
            render(*par_inputs(state, cam)(state["params"]))

    def fwd_bwd(render):
        par_render(state, cam, tgt, render)

    times = {}
    for name, fn in (("rasterize", single_fn),
                     ("all-gather", sharded(None, None)),
                     ("exchange", sharded(need1, None))):
        times[name] = (host_ms(lambda: fwd(fn), reps=PAR_STEPS),
                       host_ms(lambda: fwd_bwd(fn), reps=PAR_STEPS))
    log(f"[parallel] rasterize_sharded at world 1 against rasterize at "
        f"strip 0 (exchange cap {need1}): " + "; ".join(
            f"{k}: image {v['img']:.3g}, logT {v['logt']:.3g}, n_contrib "
            f"flips {v['n_contrib']}, depth {v['depth']:.3g}, weights "
            f"{v['weights']:.3g}, gradients {v['grad']:.3g} of max"
            for k, v in errs.items()))
    log(f"[parallel] forward / forward + backward ms: " + "; ".join(
        f"{k} {a:.3f} / {b:.3f}" for k, (a, b) in times.items())
        + f"; card: {card}")

    # row imbalance and traffic of wider worlds on this scene
    n = p["xyz"].shape[0]
    tiles = (-(-cam.width // cfg.tile)) * (-(-cam.height // cfg.tile))
    for d in PAR_WORLDS:
        grid = -(-cam.height // cfg.tile)
        even = tuple(range(0, -(-grid // d) * d + 1, -(-grid // d)))
        bal = gshard.balanced_row_starts(hist, d)
        st_e = gshard.instance_stats(
            p["xyz"], G.get_scaling(p), G.get_rotation(p),
            G.get_opacity(p)[:, 0], cam, even, mask=state["alive"], cfg=cfg)
        st_b = gshard.instance_stats(
            p["xyz"], G.get_scaling(p), G.get_rotation(p),
            G.get_opacity(p)[:, 0], cam, bal, mask=state["alive"], cfg=cfg)
        need = exchange_need(state, cam, cfg, bal)
        log(f"[parallel] {d} ranks on the bench scene: row imbalance "
            f"(max/mean instances) equal-area {st_e['imbalance']:.4f} "
            f"{even}, balanced {st_b['imbalance']:.4f} {bal}; bytes a rank "
            f"receives a forward: all-gather "
            f"{traffic(n, PAR_KR, tiles, PAR_CO, cfg.tile, d):.0f}, exchange"
            f" at cap {need} "
            f"{traffic(n, PAR_KR, tiles, PAR_CO, cfg.tile, d, need):.0f}")

    # ---- the sharded bake (brute) against the grid bake (B8) ------------
    in_state, _ = bench_scene(dev, inward=True)
    q = in_state["params"]
    geo = (q["xyz"], G.get_scaling(q), G.get_rotation(q),
           G.get_opacity(q)[:, 0], G.get_shs(q))
    az = torch.rand(q["xyz"].shape[0], 1, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(9))
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    sb = dp.bake_radiance_sharded(mesh, "data", *geo, sample_num=PAR_SAMPLES,
                                  azimuth=az)
    torch.cuda.synchronize()
    brute_s = time.perf_counter() - t0
    paths["bake_radiance_sharded"] = kernels.launches()
    t0 = time.perf_counter()
    gb = launched("bake_radiance grid", lambda: RAD.bake_radiance(
        *geo, sample_num=PAR_SAMPLES, azimuth=az, k_hits=8, use_grid=True),
        ("march",))
    grid_s = time.perf_counter() - t0
    off = sb["hit_idx"] != gb["hit_idx"]
    for key in ("radiance", "visibility", "uv"):
        off |= ((sb[key] - gb[key]).abs() > BAKE_VAL_TOL).any(-1)
    n_rays = off.numel()
    hit = float((sb["hit_idx"] >= 0).float().mean())
    log(f"[parallel] bake_radiance_sharded, {q['xyz'].shape[0]} inward "
        f"surfels x S={PAR_SAMPLES} ({n_rays} rays, brute, k 8): {brute_s:.3f}"
        f" s; the grid bake on the same draws {grid_s:.3f} s; rays with a "
        f"first hit {hit:.4f}; rays that differ {int(off.sum())}; card: "
        f"{card}")
    if hit == 0.0 or int(off.sum()) > BAKE_HIT_TOL * n_rays:
        raise AssertionError("sharded bake: no hits, or it differs from the "
                             "grid bake")
    dist.destroy_process_group()
    log(f"[parallel] {time.time() - t_phase:.1f} s")
    return paths, tmp


PAR_RANKS = 2           # phase 33: ranks sharing the one card, on gloo


def second_camera(cam, dev):
    """A second view of the bench scene, with its own random target."""
    import dataclasses

    import torch

    from svgir_tpu_torch.cameras import look_at_camera

    c = look_at_camera(eye=[-0.9, 0.3, -2.5], target=[0, 0, 0],
                       up=[0, -1, 0], fovx=math.pi / 3, fovy=math.pi / 3,
                       width=cam.width, height=cam.height, device=dev)
    g = torch.Generator(device=dev).manual_seed(12)
    return dataclasses.replace(
        c, image=torch.rand(3, cam.height, cam.width, device=dev,
                            generator=g),
        image_mask=torch.ones(1, cam.height, cam.width, device=dev))


def par_rank(rank, tmp, cap, starts, exchange_cap, dev):
    """Phase 33's rank: the DP stage-1 step over two cameras and the
    sharded render over two bands, on gloo over CUDA tensors; writes its
    results to ``tmp/rank<r>.pt``."""
    import os

    import torch

    from svgir_tpu_torch import kernels
    from svgir_tpu_torch.config import OptimizationConfig, RasterConfig
    from svgir_tpu_torch.parallel import dp, gshard
    from svgir_tpu_torch.train import optim

    dp.init_distributed(f"file://{os.path.join(tmp, 'store')}", PAR_RANKS,
                        rank, device=dev, backend="gloo")
    state, cam = bench_scene(dev)
    cams = [cam, second_camera(cam, dev)]
    opt = OptimizationConfig()
    cfg = RasterConfig(max_instances=cap)
    bg = torch.zeros(3, device=dev)
    mesh = dp.make_mesh(device_type=torch.device(dev).type)
    out = {"launches": {}, "ms": {}}

    def launched(label, fn):
        torch.cuda.synchronize()
        kernels.reset_launches()
        r = fn()
        torch.cuda.synchronize()
        out["launches"][label] = kernels.launches()
        return r

    step = dp.make_dp_train_step(mesh, opt, cfg, bg,
                                 lrs=optim.group_lrs(opt, 1.0), device=dev)
    ost0 = optim.adam_init(state["params"])
    batch = dp.stack_cameras(cams)
    with deterministic():
        new, ost, metrics = launched("dp stage 1", lambda: step(
            state, ost0, batch, 1.0, 1.6e-4))
    out["ms"]["dp stage 1"] = host_ms(
        lambda: step(state, ost0, batch, 1.0, 1.6e-4), reps=PAR_STEPS)
    out["dp"] = {"params": new["params"], "m": ost["m"], "v": ost["v"],
                 "stats": new["stats"], "loss": metrics["loss"]}
    tgt = par_target(cam)
    for name, c in (("all-gather", None), ("exchange", exchange_cap)):
        def render(a, kw, c=c):
            return gshard.rasterize_sharded(
                mesh, "data", *a, cam, bg, cfg=cfg, exchange_cap=c,
                row_starts=starts, **kw)
        bufs, grads = launched(
            name, lambda: par_render(state, cam, tgt, render))
        out[name] = {"bufs": {f: getattr(bufs, f).detach() for f in
                              bufs._fields}, "grads": grads}

        def fwd(render=render):
            with torch.no_grad():
                render(*par_inputs(state, cam)(state["params"]))
        out["ms"][name] = (
            host_ms(fwd, reps=PAR_STEPS),
            host_ms(lambda: par_render(state, cam, tgt, render),
                    reps=PAR_STEPS))
    out = _to_cpu(out)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def _to_cpu(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    return x


def run_two_ranks(card, dev, cfg, tmp, paths):
    """Phase 33: two ranks on the one card over gloo (NCCL refuses two
    ranks on one device): the DP stage-1 step against the Adam step on the
    mean of the two views' gradients, and the sharded render over uneven
    balanced bands against phase 32's single-device render."""
    import os

    import torch
    import torch.multiprocessing as mp

    from svgir_tpu_torch.models import gaussians as G
    from svgir_tpu_torch.parallel import gshard
    from svgir_tpu_torch.render.stage1 import render_stage1
    from svgir_tpu_torch.train import optim
    from svgir_tpu_torch.train.trainer import loss_grads

    t_phase = time.time()
    state, cam = bench_scene(dev)
    p = state["params"]
    hist = gshard.row_instance_histogram(
        p["xyz"], G.get_scaling(p), G.get_rotation(p), G.get_opacity(p)[:, 0],
        cam, mask=state["alive"], cfg=cfg)
    starts = gshard.balanced_row_starts(hist, PAR_RANKS)
    imbalance = gshard.instance_stats(
        p["xyz"], G.get_scaling(p), G.get_rotation(p), G.get_opacity(p)[:, 0],
        cam, starts, mask=state["alive"], cfg=cfg)["imbalance"]
    need = exchange_need(state, cam, cfg, starts)
    cap = 2 * cfg.max_instances     # the band's share of the snug cap,
    # padded per tile, may pass half of it
    torch.cuda.empty_cache()        # the ranks allocate on the same card
    mp.start_processes(par_rank, args=(tmp, cap, starts, need,
                                       "cuda:0" if dev == "cuda" else dev),
                       nprocs=PAR_RANKS, start_method="spawn")
    outs = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=True)
            for r in range(PAR_RANKS)]
    # the ranks' replicas are bit-equal
    for r in range(1, PAR_RANKS):
        for group in ("params", "m", "v", "stats"):
            for k, v in outs[0]["dp"][group].items():
                if not torch.equal(v, outs[r]["dp"][group][k]):
                    raise AssertionError(f"two ranks: rank {r}'s {group} {k}"
                                         " differs from rank 0's")
    # the DP step against Adam on the mean of the two views' gradients
    from svgir_tpu_torch.config import OptimizationConfig, RasterConfig
    opt = OptimizationConfig()
    rcfg = RasterConfig(max_instances=cap)
    cams = [cam, second_camera(cam, dev)]
    bg = torch.zeros(3, device=dev)
    grads, losses = [], []
    with deterministic():
        for c in cams:
            prm = {k: v.detach().requires_grad_(True) for k, v in p.items()}
            off = torch.zeros(p["xyz"].shape[0], 2, device=dev,
                              requires_grad=True)
            res = render_stage1(c, prm, bg, opt=opt, iteration=1.0,
                                is_training=True, alive=state["alive"],
                                mean2d_offset=off, cfg=rcfg)
            grads.append(loss_grads(res["loss"], prm, [off])[0])
            losses.append(float(res["loss"]))
    mean = {k: (grads[0][k] + grads[1][k]) / 2 for k in grads[0]}
    lrs = {**optim.group_lrs(opt, 1.0), "xyz": 1.6e-4}
    ref = optim.adam_step({k: v.detach() for k, v in p.items()}, mean,
                          optim.adam_init(p), lrs)
    got = outs[0]["dp"]
    # a sum of two is the same either way round: bit-equal throughout
    hold_step(
        (got["params"], {"m": got["m"], "v": got["v"]}),
        ({k: v.cpu() for k, v in ref[0].items()},
         {x: {k: v.cpu() for k, v in ref[1][x].items()} for x in ("m", "v")}),
        "two ranks, dp stage 1", lrs, stable=list(ref[0]))
    if abs(float(got["loss"]) - sum(losses) / 2) > 1e-5:
        raise AssertionError("two ranks: dp loss is not the views' mean")
    # the sharded render against phase 32's single-device one
    single = torch.load(os.path.join(tmp, "single.pt"), weights_only=True)
    from svgir_tpu_torch.ops.rasterizer import RenderBuffers
    sb = RenderBuffers(**single["bufs"])
    errs = {}
    for name in ("all-gather", "exchange"):
        o = outs[0][name]
        errs[name] = hold_render(RenderBuffers(**o["bufs"]), o["grads"], sb,
                                 single["grads"], f"two ranks, {name}")
        for r in range(1, PAR_RANKS):
            if not torch.equal(outs[r][name]["bufs"]["color"],
                               o["bufs"]["color"]):
                raise AssertionError(f"two ranks: {name} images differ "
                                     "between the ranks")
    for r, o in enumerate(outs):
        for label, lc in o["launches"].items():
            paths[f"two ranks, rank {r}, {label}"] = lc
            at_least = STAGE1_KERNELS if label == "dp stage 1" else \
                GSHARD_KERNELS
            check_launches(lc, f"two ranks, rank {r}, {label}",
                           at_least=[(k, 1) for k in at_least])
    ms = outs[0]["ms"]
    n = state["params"]["xyz"].shape[0]
    tiles = (-(-cam.width // cfg.tile)) * (-(-cam.height // cfg.tile))
    log(f"[two ranks] {PAR_RANKS} ranks on one card over gloo (CUDA "
        f"tensors; no collective went through the host), bands {starts} "
        f"(row imbalance {imbalance:.4f}), exchange cap {need}: dp stage 1 "
        f"replicas bit-equal, and bit-equal to Adam on the mean of the two "
        f"views' gradients (deterministic algorithms); " + "; ".join(
            f"{k}: image {v['img']:.3g}, logT {v['logt']:.3g}, n_contrib "
            f"flips {v['n_contrib']}, depth {v['depth']:.3g}, weights "
            f"{v['weights']:.3g}, gradients {v['grad']:.3g} of max"
            for k, v in errs.items()))
    log(f"[two ranks] ms (two ranks sharing one card: correctness, not "
        f"scaling): dp stage 1 step {ms['dp stage 1']:.3f}; "
        + "; ".join(f"{k} forward {ms[k][0]:.3f}, forward + backward "
                    f"{ms[k][1]:.3f}" for k in ("all-gather", "exchange"))
        + f"; bytes a rank receives a forward: all-gather "
        f"{traffic(n, PAR_KR, tiles, PAR_CO, cfg.tile, PAR_RANKS):.0f}, "
        f"exchange "
        f"{traffic(n, PAR_KR, tiles, PAR_CO, cfg.tile, PAR_RANKS, need):.0f}"
        "; "
        f"launches {outs[0]['launches']}; card: {card}")
    log(f"[two ranks] {time.time() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# the recipe (phase 34) and its tables at the reference's scale
# ---------------------------------------------------------------------------

# Phase 34's cut of the recipe: the generator at full width with 6 + 2
# views; stage 1 past the first densification passes (from iteration 500,
# every 100); a few S = 64 steps with their bake.
RECIPE_SCENE = ["--res", "800", "--views", "6", "--test-views", "2",
                "--n-gt", "20000", "--sample-num", "24"]
RECIPE_S1 = 700
RECIPE_S2 = 30


def _read_log(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _schedule_parts(sched):
    """``[recipe]``-line text of a schedule.json's parts."""
    return ", ".join(f"{k} {v['seconds']:.1f} s (peak "
                     f"{v.get('peak_gb', float('nan')):.2f} GiB)"
                     for k, v in sched["parts"].items())


def _densify_counts(out):
    return {k: int(v) for k, v in out[2].items() if k.startswith("n_")}


def run_recipe(card, dev):
    """Phase 34: cli.make_synth_dataset, then cli.full_schedule on its
    scene, as a user runs them; returns each part's launches."""
    import os
    import tempfile

    import torch

    from svgir_tpu_torch import kernels
    from svgir_tpu_torch.cli import (eval_nvs, full_schedule,
                                     make_synth_dataset)
    from svgir_tpu_torch.models import gaussians as G
    from svgir_tpu_torch.ops import grid_tracer as GT
    from svgir_tpu_torch.train import trainer

    t_phase = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        scene, run = os.path.join(tmp, "scene"), os.path.join(tmp, "run")
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        make_synth_dataset.main(["--out", scene, *RECIPE_SCENE])
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        gen_launches = kernels.launches()
        check_launches(gen_launches, "recipe scene",
                       at_least=[("binning_counts", 8), ("blend_forward", 8),
                                 ("env_lookup_forward", 8), ("march", 1)])
        for split, flag in (("train", "--views"), ("test", "--test-views")):
            n = int(RECIPE_SCENE[RECIPE_SCENE.index(flag) + 1])
            for i in range(n):
                if not os.path.exists(os.path.join(scene, split,
                                                   f"r_{i}.png")):
                    raise AssertionError(f"recipe scene: no {split}/r_{i}")
        torch.cuda.synchronize()
        kernels.reset_launches()
        with Recorder(trainer, "bake_radiance_compact") as r_bake, \
                Recorder(GT, "build_grid_auto") as r_grid, \
                Recorder(G, "densify_and_prune", keep=0,
                         inspect=_densify_counts) as r_dens:
            full_schedule.main(["--scene", scene, "--run", run,
                                "--s1_iters", str(RECIPE_S1), "--s2_iters",
                                str(RECIPE_S1 + RECIPE_S2)])
        torch.cuda.synchronize()
        with open(os.path.join(run, "schedule.json")) as f:
            sched = json.load(f)
        out1, out2 = os.path.join(run, "gss"), os.path.join(run,
                                                            "render_relight")
        for path in (f"gss/chkpnt{RECIPE_S1}.npz",
                     f"render_relight/chkpnt{RECIPE_S1 + RECIPE_S2}.npz",
                     "gss/eval/metrics.json", "gss/eval/test/metrics.json",
                     "gss/eval/train/metrics.json",
                     "render_relight/eval/metrics.json",
                     "render_relight/eval/test/metrics.json"):
            if not os.path.exists(os.path.join(run, path)):
                raise AssertionError(f"recipe: no {path}")
        # the stage-1 test views at full size beside eval_nvs's default
        # scale 4 (200x200)
        full = eval_nvs.main(["--eval", "-s", scene, "-m",
                              os.path.join(tmp, "scale1"), "-c",
                              sched["stage1_checkpoint"], "--skip_train",
                              "--eval_scale", "1"])
        log1 = _read_log(os.path.join(out1, "train_log.jsonl"))
        log2 = _read_log(os.path.join(out2, "train_log.jsonl"))
        with open(os.path.join(out1, "eval", "metrics.json")) as f:
            end1 = json.load(f)
        with open(os.path.join(out2, "eval", "metrics.json")) as f:
            end2 = json.load(f)
    for e in log1 + log2:
        if not math.isfinite(e["loss"]) or e.get("overflow"):
            raise AssertionError(f"recipe: bad log entry {e}")
    psnrs = {"stage 1 eval_nvs test": sched["eval_stage1"]["test"]["psnr"],
             "stage 1 eval_nvs test at scale 1": full["test"]["psnr"],
             "stage 1 eval_nvs train": sched["eval_stage1"]["train"]["psnr"],
             "stage 2 eval_nvs test": sched["eval_stage2"]["test"]["psnr"],
             "stage 1 end-of-run test": end1["psnr"],
             "stage 2 end-of-run test (pbr)": end2["psnr"]}
    if not all(math.isfinite(v) for v in psnrs.values()):
        raise AssertionError(f"recipe: PSNRs {psnrs}")
    # the first pass prunes the bootstrap's unseen points; the later ones
    # must add more surfels than they prune
    passes = r_dens.seen
    if len(passes) < 2 or not passes[-1]["n_alive"] > passes[0]["n_alive"]:
        raise AssertionError(f"recipe: the densification passes {passes} "
                             "did not grow the model")
    parts = {"scene": gen_launches,
             **{k: v["launches"] for k, v in sched["parts"].items()}}
    need = {"stage1": [(k, RECIPE_S1) for k in STAGE1_KERNELS],
            "stage2": [(k, RECIPE_S2) for k in STAGE2_KERNELS]
            + [("march", 1)],
            "eval_stage1": [(k, 1) for k in STAGE1_KERNELS[:3]],
            "eval_stage2": [(k, 1) for k in STAGE1_KERNELS[:3]]
            + [("env_lookup_forward", 1)]}
    for part, at_least in need.items():
        check_launches(parts[part], f"recipe {part}", at_least=at_least,
                       none=("blend_forward_tiles", "blend_backward_tiles",
                             "pad_cols", "slice_cols"))
    bakes = [(int(c[0][1].sum()), float(c[2]["exhausted_frac"]),
              round(c[3], 3)) for c in r_bake.calls]
    grids = [(g.res, g.cell_cap, g.overflow) for _, _, g, _ in r_grid.calls]
    if any(g[2] for g in grids):
        log(f"[recipe] the bake's grid clipped its cell lists: {grids}")
    ms1 = log1[-1]["elapsed"] / RECIPE_S1 * 1e3
    ms2 = log2[-1]["elapsed"] / RECIPE_S2 * 1e3
    log(f"[recipe] scene (8 views of 800x800, 20,000 GT surfels, S = 24) "
        f"{gen_s:.1f} s; schedule: {_schedule_parts(sched)}; stage 1 "
        f"{ms1:.2f} ms a step over {RECIPE_S1} (densifying), alive "
        f"{log1[0]['n_alive']} -> {log1[-1]['n_alive']}, densification "
        f"passes {passes}; stage 2 {ms2:.2f} ms a step over "
        f"{RECIPE_S2} at S = 64; bakes (alive, exhausted share, s): "
        f"{bakes}; grids (res, cell cap, clipped): {grids}; PSNRs "
        + ", ".join(f"{k} {v:.4f}" for k, v in psnrs.items())
        + f"; phase {time.time() - t_phase:.1f} s; card: {card}")
    log("[recipe] launches by part: " + json.dumps(
        {p: {k: v for k, v in lc.items() if v} for p, lc in parts.items()}))
    return parts


# Phase 35: the recipe's size in every run.  The bench scene's generator
# with the alive surfels and rows of the recipe's chkpnt3000 (PERF.md §5).
RECIPE_ALIVE = 264_865
RECIPE_ROWS = 524_288


def run_recipe_size(card, dev):
    """Phase 35: B1-B4 on a stage-1 step, then B1-B4 and B7 on an S = 64
    step, at the recipe's size: ``bench_scene`` with RECIPE_ALIVE surfels in
    RECIPE_ROWS rows, binned as the recipe bins (strip 8, the counting
    binner, a snug cap), and for the S = 64 step a synthetic bake of every
    row (``stage2_inputs``) and a 32 x 64 env.  Each step runs once with the
    launch counts set to 0 just before it and read just after; each kernel
    is held to its plain version on that step's inputs (B3's image to the
    plain version in float64, ``compare_blend(exact=True)``; ``split_blend``
    and ``split_env_backward`` log where the float32 versions part), timed
    beside its bound and library yardstick; each step's ms and peak
    memory.  Returns the kernels-JSON rows, named ``*_recipe_size``."""
    import torch

    from svgir_tpu_torch.config import OptimizationConfig, RasterConfig
    from svgir_tpu_torch.train import optim, trainer
    from svgir_tpu_torch.train.cap_probe import snug_instance_cap

    t_phase = time.time()
    torch.cuda.empty_cache()
    state, cam = bench_scene(dev, n=RECIPE_ALIVE, capacity=RECIPE_ROWS)
    opt = OptimizationConfig()
    bg = torch.zeros(3, device=dev)
    cfg = RasterConfig(max_instances=snug_instance_cap(
        state["params"], [cam], RasterConfig(), alive=state["alive"]))
    log(f"[recipe-size] {RECIPE_ALIVE} surfels in {RECIPE_ROWS} rows, "
        f"{cam.width}x{cam.height}, strip {cfg.strip}, {cfg.binner} "
        f"binner, cap {cfg.max_instances}; card: {card}")
    report = []

    def row(name, suffix, t, bnd, err, launched, **extra):
        report.append({
            "name": f"{name}{suffix}_recipe_size", "route": "cuda",
            "source": f"svgir_tpu_torch/csrc/{SOURCES[name]}",
            "replaces": f"svgir_tpu/ops/{REPLACES[name]}",
            "launches": launched[name], "max_abs_err": err, **t,
            "bound_ms": bnd[0], "bound_by": bnd[1], **extra})
        log(f"[recipe-size] {name}{suffix}: " + fmt_times(t, "library")
            + f", bound {bnd[0]:.4f} ms by {bnd[1]}, max|err| {err:.3g}; "
            f"{launched[name]} launches in the step; card: {card}")

    def held_step(fn, label, names):
        """One step, counted and captured; B1/B2 equal to their plain
        versions, B3/B4 held and split; returns (calls, launches, bounds,
        B3's and B4's errors)."""
        with Capture() as cap:
            _, launched = counted(fn, f"recipe-size {label}",
                                  [(k, 1) for k in names])
        calls = cap.calls
        compare_binning(calls)
        split_blend(calls, f"recipe size, {label}", card)
        e3, e4 = compare_blend(calls, f"recipe size, {label}", exact=True)
        bnd = bounds(calls)
        wk = bnd["blend_work"]
        log(f"[recipe-size] {label}: {int(calls['compute_instances'][0][7])}"
            f" instances; blend work {wk['rows']} real rows, {wk['pairs']} "
            f"pairs, {wk['ok']} pass the footprint test, {wk['gated']} "
            "blend")
        return calls, launched, bnd, e3, e4

    def rows(calls, launched, bnd, errs, step, suffix=""):
        kw3 = calls["blend_forward"][1]
        with torch.no_grad():
            for name, (kfn, pfn, lfn) in kernel_calls(calls).items():
                blend = name.startswith("blend")
                extra = dict(step_ms=step[0], step_peak_gib=step[1])
                if blend:
                    extra.update(ca=kw3["ca"], cv=kw3["cv"])
                if name == "blend_forward":
                    extra["oracle"] = "plain version in float64"
                elif name == "binning_counts":
                    extra["library"] = "bincount + cumsums, counts and carry"
                elif name.startswith("env"):
                    extra["queries"] = calls[name][0][1].numel()
                row(name, suffix if blend else "", timings(kfn, pfn, lfn),
                    bnd[name], errs[name], launched, **extra)

    # ---- stage 1 -------------------------------------------------------
    step1 = trainer.make_train_step(opt, cfg, bg,
                                    lrs=optim.group_lrs(opt, 1.0),
                                    device=dev)
    args1 = (state, optim.adam_init(state["params"]), cam, 1.0, 1.6e-4)
    cost = peak_ms(lambda: step1(*args1), "stage-1 step", card, "recipe-size")
    c1, l1, bnd1, e3, e4 = held_step(lambda: step1(*args1), "stage-1 step",
                                     STAGE1_KERNELS)
    rows(c1, l1, bnd1, dict(binning_counts=0.0, binning_instances=0.0,
                            blend_forward=e3, blend_backward=e4), cost)
    del c1, args1

    # ---- S = 64 --------------------------------------------------------
    s2_state, bake, env = stage2_inputs(state, dev, samples=BAKE_SAMPLES,
                                        env_h=BAKE_ENV_H)
    step2 = trainer.make_svgss_train_step(
        opt, cfg, bg, lrs=optim.group_lrs(opt, 1.0, use_pbr=True),
        device=dev)
    args2 = ({**s2_state, "stats": state["stats"]},
             optim.adam_init(s2_state["params"]), env, bake, cam, 100.0,
             1e-5, opt.radiance_lr)
    label = f"S = {BAKE_SAMPLES} step"
    cost = peak_ms(lambda: step2(*args2), label, card, "recipe-size", reps=5)
    c2, l2, bnd2, e3, e4 = held_step(lambda: step2(*args2), label,
                                     STAGE2_KERNELS)
    e7 = compare_env(c2, f"recipe size, {label}")
    split_env_backward(c2, f"recipe size, {label}", card)
    for k in ("compute_counts", "compute_instances"):   # rows of stage 1
        del c2[k]
    rows(c2, l2, {**bnd2, **env_bounds(c2["env_lookup_forward"][0])},
         dict(blend_forward=e3, blend_backward=e4, env_lookup_forward=e7[0],
              env_lookup_backward=e7[1]), cost, f"_s{BAKE_SAMPLES}")
    log(f"[recipe-size] {time.time() - t_phase:.1f} s; card: {card}")
    return report


# Each kernel's source and the TPU kernel it replaces, for the JSON rows
# of the recipe's size.
SOURCES = {"binning_counts": "binning.cu", "binning_instances": "binning.cu",
           "blend_forward": "blend_forward.cu",
           "blend_backward": "blend_backward.cu",
           "env_lookup_forward": "env_lookup.cu",
           "env_lookup_backward": "env_lookup.cu", "march": "march.cu"}
REPLACES = {"binning_counts": "binning_pallas.py:44",
            "binning_instances": "binning_pallas.py:114",
            "blend_forward": "blend_pallas_strip.py:51",
            "blend_backward": "blend_pallas_strip.py:267",
            "env_lookup_forward": "env_lookup_pallas.py:63",
            "env_lookup_backward": "env_lookup_pallas.py:76",
            "march": "march_pallas.py:66"}


def counted(fn, label, at_least):
    """fn() with the kernels' launch counts set to 0 just before it, read
    just after; fails if a kernel of ``at_least`` ((name, count) pairs) was
    launched too few times.  Returns (fn's result, the counts)."""
    import torch

    from svgir_tpu_torch import kernels
    torch.cuda.synchronize()
    kernels.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    launched = kernels.launches()
    check_launches(launched, label, at_least=at_least)
    return out, launched


def peak_ms(fn, label, card, tag="recipe-table", reps=10):
    """Logs a step's ``fn`` median wall time (each call ended by a
    synchronize) and its peak device memory; returns both."""
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = host_ms(fn, reps=reps, warmup=1)
    log(f"[{tag}] {label}: {ms:.3f} ms a step (median of {reps}, ended by "
        f"a synchronize), peak {peak:.3f} GiB; card: {card}")
    return ms, peak


def recipe_tables(run, card, dev, profile_dir=None):
    """``--recipe-tables RUN``: the kernels at the recipe's scale, on the
    newest checkpoints of a cli.full_schedule run in RUN (its
    schedule.json names the scene): B1-B4 on a stage-1 step, B1-B4 and
    B7 on an S = 64 step, B8 on the fullest ray chunk of a bake of the
    stage-2 checkpoint's surfels, each against its plain version, timed
    with its bound; the steps' and the bake's wall times and peak memory;
    with ``profile_dir``, torch.profiler tables of three steps of each
    stage and of a bake; ``recipe_scale_probe`` on the stage-1
    checkpoint.  ``launches`` in a row is the kernel's launches in this
    run's one step (or bake) of the row, counted from 0 just before it;
    ``recipe_run_launches`` the launches of the whole schedule RUN ran,
    read from its schedule.json.  A kernel that disagrees with its plain
    version is logged and named in its rows' ``disagrees``; the tables go
    on.  Returns (rows, {kernel: disagreements})."""
    import os

    import torch

    from svgir_tpu_torch.cli import full_schedule as FS
    from svgir_tpu_torch.cli import train as CLI
    from svgir_tpu_torch.config import (OptimizationConfig, RasterConfig,
                                        from_args)
    from svgir_tpu_torch.data.readers import load_scene
    from svgir_tpu_torch.kernels import blend as KBL
    from svgir_tpu_torch.ops import blend_pallas_strip as BS
    from svgir_tpu_torch.ops import grid_tracer as GT
    from svgir_tpu_torch.ops import march_pallas as MP
    from svgir_tpu_torch.train import checkpoint as CK
    from svgir_tpu_torch.train import optim, trainer
    from svgir_tpu_torch.train.cap_probe import snug_instance_cap
    from svgir_tpu_torch.train.staging import stage_cameras

    with open(os.path.join(run, "schedule.json")) as f:
        sched = json.load(f)
    per_run = {}
    for part in sched["parts"].values():
        for k, v in part.get("launches", {}).items():
            per_run[k] = per_run.get(k, 0) + v
    scene = load_scene(sched["scene"], white_background=False,
                       eval_split=False)
    extent = scene.cameras_extent
    cams = stage_cameras([trainer.strip_meta(c)
                          for c in scene.train_cameras[:3]], device=dev)
    bg = torch.zeros(3, device=dev)
    report = []
    sched_path = os.path.join(run, "schedule.json")
    disagree = {}       # kernel name -> what its comparison said

    def held(fn, names, label):
        """fn(), a comparison of kernels with their plain versions: a
        disagreement is logged and kept for ``names``' rows, the tables
        go on, and the run fails at its end."""
        try:
            return fn()
        except AssertionError as exc:
            for n in names:
                disagree.setdefault(n, []).append(f"{label}: {exc}")
            log(f"[recipe-table] DISAGREES {label}: {exc}; card: {card}")
            return None

    def row(name, label, t, bnd, err, launched, per, **extra):
        report.append({
            "name": f"{name}_recipe_"
            + re.sub(r"[^a-z0-9]+", "_", label.lower()).strip("_"),
            "route": "cuda",
            "source": f"svgir_tpu_torch/csrc/{SOURCES[name]}",
            "replaces": f"svgir_tpu/ops/{REPLACES[name]}",
            "launches": launched[name], "launches_in": per,
            "max_abs_err": err, **t,
            "bound_ms": bnd[0], "bound_by": bnd[1],
            "recipe_run_launches": per_run.get(name, 0),
            "recipe_run_launches_from": sched_path,
            **({"disagrees": disagree[name]} if name in disagree else {}),
            **extra})
        log(f"[recipe-table] {name}, {label}: " + fmt_times(t, "library")
            + f", bound {bnd[0]:.4f} ms by {bnd[1]}, max|err| {err:.3g}; "
            f"{launched[name]} launches in {per} (this run); "
            f"{per_run.get(name, 0)} in the schedule of {sched_path}; "
            f"card: {card}")

    def blend_rows(calls, label, launched, per):
        nan = float("nan")
        split_blend(calls, f"recipe {label}", card)
        errs = held(lambda: compare_blend(calls, f"recipe {label}",
                                          exact=True),
                    ("blend_forward", "blend_backward"), f"B3/B4 {label}")
        err3, err4 = errs or (nan, nan)
        if errs is None:        # B4 too, where B3 stopped the comparison
            b, bkw = calls["blend_backward"]
            with torch.no_grad():
                err4 = held(lambda: check_rows(
                    KBL.blend_backward(*b, **bkw),
                    BS.blend_backward_plain(*b, **bkw),
                    calls["blend_forward"][1]["ca"], f"B4 [recipe {label}]"),
                    ("blend_backward",), f"B4 {label}")
            err4 = nan if err4 is None else err4
        bnd = bounds(calls)
        wk = bnd["blend_work"]
        log(f"[recipe-table] {label} blend work: {wk['rows']} real rows, "
            f"{wk['pairs']} pairs, {wk['ok']} pass the footprint test, "
            f"{wk['gated']} blend")
        kw3 = calls["blend_forward"][1]
        k = kernel_calls(calls)
        with torch.no_grad():
            for name, err in (("blend_forward", err3),
                              ("blend_backward", err4)):
                row(name, label, timings(*k[name]), bnd[name], err,
                    launched, per, ca=kw3["ca"], cv=kw3["cv"])
        return bnd

    # ---- stage 1: the completed stage-1 checkpoint --------------------
    it1, ck1 = FS.latest_checkpoint(os.path.join(run, "gss"))
    recipe_scale_probe(ck1, sched["scene"], card, dev)
    _, tree = CK.load_checkpoint(ck1, device=dev)
    st1, ost1 = tree["state"], tree["opt"]
    opt1 = from_args(OptimizationConfig, CLI.build_parser().parse_args(
        ["-s", sched["scene"], *FS.STAGE1_FLAGS]))
    cfg1 = RasterConfig(max_instances=snug_instance_cap(
        st1["params"], scene.train_cameras, RasterConfig(),
        alive=st1["alive"]))
    step1 = trainer.make_train_step(
        opt1, cfg1, bg, lrs=optim.group_lrs(opt1, extent),
        track_stats=it1 < opt1.densify_until_iter, device=dev)
    xyz1 = opt1.position_lr_final * extent
    turn = [0]

    def s1():
        turn[0] += 1
        return step1(st1, ost1, cams[turn[0] % len(cams)], float(it1), xyz1)
    log(f"[recipe-table] stage 1 from {ck1}: {int(st1['alive'].sum())} "
        f"alive of {st1['alive'].shape[0]}, cap {cfg1.max_instances}")
    with Capture() as cap1:
        _, l1 = counted(lambda: step1(st1, ost1, cams[0], float(it1), xyz1),
                        "recipe-table stage-1 step",
                        [(k, 1) for k in STAGE1_KERNELS])
    c1 = cap1.calls
    held(lambda: compare_binning(c1), ("binning_counts", "binning_instances"),
         "B1/B2 stage 1")
    bnd1 = blend_rows(c1, "stage 1", l1, "a stage-1 step")
    k1 = kernel_calls(c1)
    with torch.no_grad():
        for name in ("binning_counts", "binning_instances"):
            row(name, "stage 1", timings(*k1[name]), bnd1[name], 0.0, l1,
                "a stage-1 step")
    log(f"[recipe-table] stage 1: {int(c1['compute_instances'][0][7])} "
        "instances")
    peak_ms(s1, "stage-1 step", card)
    if profile_dir:
        profile_step(s1, profile_dir, "recipe_profile_stage1.txt")
    del st1, ost1, tree, c1, cap1

    # ---- stage 2 at S = 64: the newest stage-2 checkpoint --------------
    it2, ck2 = FS.latest_checkpoint(os.path.join(run, "render_relight"))
    _, tree = CK.load_checkpoint(ck2, device=dev)
    st2, ost2, env2 = tree["state"], tree["opt"], tree["env"]
    bake = {k: v for k, v in tree["extra"].items() if k != "exhausted_frac"}
    s_num = bake["hit_idx"].shape[1]
    opt2 = from_args(OptimizationConfig, CLI.build_parser().parse_args(
        ["-s", sched["scene"], *FS.STAGE2_FLAGS]))
    cfg2 = RasterConfig(max_instances=snug_instance_cap(
        st2["params"], scene.train_cameras, RasterConfig(),
        alive=st2["alive"]))
    step2 = trainer.make_svgss_train_step(
        opt2, cfg2, bg, lrs=optim.group_lrs(opt2, extent, use_pbr=True),
        device=dev)

    def s2():
        turn[0] += 1
        return step2(st2, ost2, env2, bake, cams[turn[0] % len(cams)],
                     float(it2 - it1), 0.0, 0.0)
    log(f"[recipe-table] stage 2 from {ck2}: {int(st2['alive'].sum())} "
        f"alive of {st2['alive'].shape[0]}, S = {s_num}, env "
        f"{tuple(env2['params']['env'].shape)}, cap {cfg2.max_instances}")
    with Capture() as cap2:
        _, l2 = counted(lambda: step2(st2, ost2, env2, bake, cams[0],
                                      float(it2 - it1), 0.0, 0.0),
                        f"recipe-table S = {s_num} step",
                        [(k, 1) for k in STAGE2_KERNELS])
    c2 = cap2.calls
    held(lambda: compare_binning(c2), ("binning_counts", "binning_instances"),
         "B1/B2 stage 2")
    per2 = f"an S = {s_num} step"
    blend_rows(c2, "stage 2", l2, per2)
    e7 = held(lambda: compare_env(c2, f"recipe S = {s_num}"),
              ("env_lookup_forward", "env_lookup_backward"),
              f"B7 S = {s_num}")
    e7 = e7 or (float("nan"), float("nan"))
    split_env_backward(c2, f"recipe S = {s_num}", card)
    fa, _ = c2["env_lookup_forward"]
    bnd7 = env_bounds(fa)
    k2 = kernel_calls(c2)
    with torch.no_grad():
        for i, name in enumerate(("env_lookup_forward",
                                  "env_lookup_backward")):
            row(name, f"S = {s_num}", timings(*k2[name]), bnd7[name],
                e7[i], l2, per2, queries=fa[1].numel())
    peak_ms(s2, f"S = {s_num} step", card)
    if profile_dir:
        ops = profile_step(s2, profile_dir, "recipe_profile_stage2.txt")
        gather = sum(v for k, v in ops.items() if "indexing_backward" in k)
        log(f"[recipe-table] S = {s_num} step: the gather backward "
            f"(indexing_backward_kernel) {gather:.3f} ms a step of "
            f"{sum(ops.values()):.3f} ms busy; card: {card}")
    del ost2, env2, bake, c2, cap2, tree

    # ---- the bake of the stage-2 checkpoint's surfels ------------------
    params, alive = st2["params"], st2["alive"]
    az = torch.rand(int(alive.sum()), 1, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))

    def finite(out):
        return int(torch.isfinite(out["t"]).sum())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad(), Recorder(GT, "nearest_hits_grid",
                                   inspect=finite) as rg:
        _, l8 = counted(lambda: trainer.bake_radiance_compact(
            params, alive, sample_num=s_num, azimuth=az),
            "recipe-table bake", [("march", 1)])
    cold = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    with torch.no_grad():
        trainer.bake_radiance_compact(params, alive, sample_num=s_num,
                                      azimuth=az)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    log(f"[recipe-table] bake of {int(alive.sum())} surfels x S={s_num}: "
        f"{cold:.3f} s cold, {warm:.3f} s warm, peak {peak:.3f} GiB, "
        f"{len(rg.calls)} grid-march chunks; card: {card}")
    if profile_dir:
        with torch.no_grad():
            profile_step(lambda: trainer.bake_radiance_compact(
                params, alive, sample_num=s_num, azimuth=az), profile_dir,
                "recipe_profile_bake.txt", steps=1)
    full = max(range(len(rg.calls)), key=lambda i: rg.seen[i])
    (_, grid, o, d), hkw, _, _ = rg.calls[full]
    mkw = dict(t_max=hkw["t_max"], k=hkw["k"], n_steps=hkw["n_steps"],
               kmax=GT._run_kmax(grid))
    with torch.no_grad():
        kt, ki = MP.march(grid, o, d, **mkw)
        pt, pi = MP.march_plain(grid, o, d, **mkw)
        torch.cuda.synchronize()
        fin = torch.isfinite(pt)
        bad = int(((ki != pi) | (torch.isfinite(kt) != fin)
                   | (fin & (kt != pt))).sum())
        both = fin & torch.isfinite(kt)
        err = float((kt - pt)[both].abs().max()) if bool(both.any()) else 0.0
        if bad > MARCH_SLOT_TOL * max(int(fin.sum()), 1):
            def fail():
                raise AssertionError(f"recipe bake: B8 differs from its "
                                     f"plain version at {bad} slots")
            held(fail, ("march",), "B8 bake")
        t = timings(lambda: MP.march(grid, o, d, **mkw),
                    lambda: MP.march_plain(grid, o, d, **mkw), reps=10,
                    plain_reps=1)
    work = march_work(grid, o, d, pt, **{x: mkw[x] for x in
                                         ("n_steps", "kmax", "k")})
    row("march", "bake, fullest chunk", t,
        march_bound(work, len(o), mkw["k"]), err, l8, "a bake", chunk=full,
        finite_slots=int(fin.sum()), full_lists=int(fin[:, -1].sum()),
        grid_res=grid.res, cell_cap=grid.cell_cap, **work)
    log(f"[recipe-table] B8's fullest chunk ({full} of {len(rg.calls)}): "
        f"{len(o)} rays, {int(fin.sum())} finite slots, "
        f"{int(fin[:, -1].sum())} full lists, {bad} slots differ; grid res "
        f"{grid.res}, cap {grid.cell_cap}; work {work}")
    return report, disagree


@contextlib.contextmanager
def _dilation(var, seen=None):
    """Preprocess with the screen-space low-pass variance ``var`` (px^2)
    in place of the rasterizer's 0.3; ``seen`` receives each call's
    (view depth, the footprint's own x and y variances)."""
    from svgir_tpu_torch.ops import preprocess as P
    orig = P._ewa_cov2d

    def patched(p_view, *args):
        out = orig(p_view, *args)
        if seen is not None:
            seen.append((p_view[:, 2], out[:, 0] - 0.3, out[:, 2] - 0.3))
        return out + out.new_tensor([var - 0.3, 0.0, var - 0.3])
    P._ewa_cov2d = patched
    try:
        yield
    finally:
        P._ewa_cov2d = orig


def recipe_scale_probe(ck, scene_path, card, dev):
    """Why eval_nvs's default scale 4 scores below scale 1 on a
    recipe-sized model: the stage-1 checkpoint ``ck`` rendered on the
    scene's test views as eval_nvs renders them (``render_stage1``,
    2^20 instance slots, black background), scored against the
    area-resampled images: at scale 4 (200x200; eval_nvs's number), at
    scale 1, at scale 1 averaged over 4x4 blocks (the scale-4 image of
    the model seen at the resolution it was fitted at), and at scale 4
    with the rasterizer's +0.3 px^2 screen-space dilation cut to
    0.3/16 (the same filter in scene units as at scale 1).  Also the
    share of the alive surfels in front of each camera whose own
    footprint (both screen variances) is under the 0.3 px^2 dilation,
    at each scale."""
    import torch
    import torch.nn.functional as F

    from svgir_tpu_torch.config import OptimizationConfig, RasterConfig
    from svgir_tpu_torch.data.readers import load_scene
    from svgir_tpu_torch.eval import metrics as M
    from svgir_tpu_torch.render.stage1 import render_stage1
    from svgir_tpu_torch.train import checkpoint as CK
    from svgir_tpu_torch.train.staging import stage_cameras
    from svgir_tpu_torch.train.trainer import strip_meta

    t0 = time.time()
    scene = load_scene(scene_path, white_background=False, eval_split=True)
    _, tree = CK.load_checkpoint(ck, device=dev)
    params = tree["state"]["params"]
    alive = tree["state"]["alive"].to(bool)
    bg = torch.zeros(3, device=dev)
    cfg, opt = RasterConfig(max_instances=1 << 20), OptimizationConfig()

    def render(cam, var=0.3, seen=None):
        with _dilation(var, seen):
            res = render_stage1(stage_cameras([strip_meta(cam)],
                                              device=dev)[0],
                                params, bg, opt=opt, is_training=False,
                                alive=alive, cfg=cfg)
        if bool(res["overflow"]):
            raise AssertionError("recipe scale probe: binner overflow")
        return torch.clamp(res["render"], 0, 1)

    def small(seen):
        z, vx, vy = seen[-1]
        rows = alive & (z > 0.2)
        own = torch.maximum(vx, vy)[rows]
        return (float((own < 0.3).float().mean()),
                float(own.clamp(min=0).sqrt().median()))

    psnr = {k: [] for k in ("scale 4", "scale 1", "scale 1 pooled 4x4",
                            "scale 4, dilation 0.3/16")}
    share = {"scale 1": [], "scale 4": []}
    with torch.no_grad():
        for c1, c4 in zip(scene.test_cameras_at(1), scene.test_cameras_at(4)):
            gt1, gt4 = c1.image.to(dev), c4.image.to(dev)
            seen1, seen4 = [], []
            r1, r4 = render(c1, seen=seen1), render(c4, seen=seen4)
            psnr["scale 4"].append(M.psnr(r4, gt4))
            psnr["scale 1"].append(M.psnr(r1, gt1))
            psnr["scale 1 pooled 4x4"].append(
                M.psnr(F.avg_pool2d(r1[None], 4)[0], gt4))
            psnr["scale 4, dilation 0.3/16"].append(
                M.psnr(render(c4, var=0.3 / 16), gt4))
            share["scale 1"].append(small(seen1))
            share["scale 4"].append(small(seen4))
    mean = {k: statistics.fmean(v) for k, v in psnr.items()}
    if not all(math.isfinite(v) for v in mean.values()):
        raise AssertionError(f"recipe scale probe: PSNRs {mean}")
    log(f"[recipe-scale] {ck}: {int(alive.sum())} alive, "
        f"{len(psnr['scale 4'])} test views; test PSNR "
        + ", ".join(f"{k} {v:.4f} dB" for k, v in mean.items())
        + "; alive surfels in front whose own footprint is under the "
        "0.3 px^2 dilation (share, median own sigma px): "
        + ", ".join(f"{k} ({statistics.fmean(a for a, _ in v):.4f}, "
                    f"{statistics.fmean(b for _, b in v):.4f})"
                    for k, v in share.items())
        + f"; {time.time() - t0:.1f} s; card: {card}")
    return mean


def log_blend_work(bnd, a, kw, label):
    """Logs what a B3 call had to do: its instances, the real rows of the
    chunks its tiles processed, the (pixel, row) pairs tested, passing the
    footprint test and blending, and its tiles with any instance."""
    wk = bnd["blend_work"]
    tc = a[2]
    log(f"[blend work] {label}: {int(tc.sum())} instances over "
        f"{int((tc > 0).sum())} of {tc.numel()} tiles (max "
        f"{int(tc.max())} a tile), {wk['rows']} real rows in processed "
        f"chunks, {wk['pairs']} pairs, {wk['ok']} pass the footprint test, "
        f"{wk['gated']} blend; CA {kw['ca']} / CV {kw['cv']}, slab "
        f"{tuple(a[0].shape)}")


def blend_extras(report, calls, label, ptx, parents, card, names=None):
    """Adds to the blend entries of ``report`` (B3 and B4 on ``calls``) the
    kernel each launch takes with its registers and spills and, with
    --parent, each other tree's kernels timed in turns beside them
    ({label: times} under "parent")."""
    a, kw = calls["blend_forward"]
    geo = dict(ca=kw["ca"], cv=kw["cv"], tile=kw["tile"], chunk=kw["chunk"])
    names = names or {"forward": "blend_forward",
                      "backward": "blend_backward"}
    if "blend_backward" not in calls:
        names = {k: v for k, v in names.items() if k == "forward"}
    cp = {p["label"]: compare_parent(p, calls, label, card) for p in parents}
    for entry in report:
        for direction, name in names.items():
            if entry["name"] == name:
                entry["build"] = blend_build(ptx, direction, **geo)
                if cp:
                    entry["parent"] = {k: v[direction] for k, v in cp.items()}
                log(f"[build] {name}: {entry['build']}")


def log_warp_visits(work, kw, label):
    """The shuffle model of the blend backward on these inputs: the (warp,
    real row) visits where some pixel of the warp passes the footprint
    test, for each warp patch, and the warp shuffles they cost: the old
    layout (32 x 1 patches, 5 shuffles per row) against the new one (16
    per group of 16 rows)."""
    ca, cv = kw["ca"], kw["cv"]
    rows_old = 12 + ca + 4 * cv
    rows_new = (12 if cv else 6) + ca + 4 * cv
    v = work["warp_visits"]
    old = v["32x1"] * 5 * rows_old
    log(f"[work] {label}: warp visits with a pixel past the footprint test "
        f"of {work['warp_visit_total']['32x1']} (32 x 1 patches): "
        + ", ".join(f"{k} {n}" for k, n in v.items())
        + f"; backward shuffles, old layout {old} ("
        f"{v['32x1']} x 5 x {rows_old}), new: "
        + ", ".join(f"{k} {n * -(-rows_new // 16) * 16}"
                    for k, n in v.items() if k != "32x1"))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    try:
        import svgir_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the repository root (svgir_tpu_torch "
              "not importable)", file=sys.stderr)
        return 2

    from svgir_tpu_torch import kernels
    from svgir_tpu_torch.config import OptimizationConfig, RasterConfig
    from svgir_tpu_torch.kernels import build
    from svgir_tpu_torch.models import gaussians as G
    from svgir_tpu_torch.ops import binning as BN
    from svgir_tpu_torch.ops import binning_pallas as BP
    from svgir_tpu_torch.ops import blend_pallas_strip as BS
    from svgir_tpu_torch.ops.preprocess import preprocess
    from svgir_tpu_torch.render.stage1 import render_view_stage1
    from svgir_tpu_torch.train import optim, trainer
    inputs = kernel_inputs()

    dev = "cuda"
    t_start = time.time()
    # ---- 1. build ------------------------------------------------------
    t0 = time.time()
    build.build()
    for stem in ("binning", "blend_forward", "blend_backward", "cols",
                 "env_lookup", "launch_floor", "march"):
        build.library(stem)
    card = nvidia_smi()
    log(f"[build] {time.time() - t0:.1f} s; card: {card}")
    build_log = (build.BUILD_DIR / "build.log").read_text() \
        if (build.BUILD_DIR / "build.log").exists() else ""
    for line in build_log.splitlines():
        if any(k in line for k in ("registers", "spill", "Function properties",
                                   "==")):
            log("[ptxas] " + line.strip())
    ptx = ptxas_blend(build_log)
    for (direction, args), v in sorted(ptx.items()):
        log(f"[ptxas] blend {direction} <{', '.join(map(str, args))}>: {v}")
    if "--recipe-tables" in sys.argv[1:-1]:
        out_dir = sys.argv[sys.argv.index("--profile") + 1] \
            if "--profile" in sys.argv[1:-1] else None
        # the floor first: late in a long run the profiler drops records
        floor_ms = device_ms(launch_floor())[0]
        report, disagree = recipe_tables(
            sys.argv[sys.argv.index("--recipe-tables") + 1], card, dev,
            out_dir)
        # the kernels JSON and the card, and not the result line: this
        # mode does not run the phases
        for entry in report:
            entry["launch_floor_device_ms"] = floor_ms
        print(json.dumps({"kernels": report}), flush=True)
        print(card, flush=True)
        if disagree:
            print("recipe tables: kernels disagree with their plain "
                  f"versions: {json.dumps(disagree)}", file=sys.stderr,
                  flush=True)
            return 1
        return 0
    parents = [parent_kernels(sys.argv[i + 1])
               for i, a in enumerate(sys.argv[1:-1], 1) if a == "--parent"]
    for p in parents:
        for (direction, args), v in sorted(ptxas_blend(p["ptxas"]).items()):
            log(f"[ptxas] {p['label']}'s blend {direction} "
                f"<{', '.join(map(str, args))}>: {v}")

    # ---- 2. render (eval path) ----------------------------------------
    state, cam = bench_scene(dev)
    opt = OptimizationConfig()
    cfg = RasterConfig()
    bg = torch.zeros(3, device=dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    with torch.no_grad(), Capture() as cap_render:
        res = render_view_stage1(cam, state["params"], bg,
                                 alive=state["alive"], cfg=cfg)
    torch.cuda.synchronize()
    render_launches = kernels.launches()
    padded = int(cap_render.calls["blend_forward"][0][2].sum())
    cfg_default = cfg
    cfg = RasterConfig(max_instances=-(-padded * 21 // (20 * 2048)) * 2048)
    img = res["render"]
    if tuple(img.shape) != (3, 800, 800) or not bool(torch.isfinite(img).all()):
        raise AssertionError("render: bad image")
    if bool(res["overflow"]):
        raise AssertionError("render: binner overflow")
    log(f"[render] 800x800, 50k surfels: mean {float(img.mean()):.5f}, "
        f"covered {float((res['n_contrib'] > 0).float().mean()):.4f}, "
        f"launches {render_launches}; padded instances {padded} -> cap "
        f"{cfg.max_instances}")
    for k in ("binning_counts", "binning_instances", "blend_forward"):
        if render_launches[k] < 1:
            raise AssertionError(f"render path did not launch {k}")

    # ---- 3. train (main path) -----------------------------------------
    steps = 5
    torch.cuda.synchronize()
    kernels.reset_launches()
    st, ost, hist = trainer.train_stage1(
        state, [cam], opt, raster_cfg=cfg, iterations=steps, log_every=1,
        device=dev)
    torch.cuda.synchronize()
    train_launches = kernels.launches()
    log(f"[train] {steps} steps: " + ", ".join(
        f"it {h['iter']} loss {h['loss']:.6f} psnr {h['psnr']:.4f}"
        for h in hist))
    log(f"[train] launches {train_launches}")
    for h in hist:
        if not math.isfinite(h["loss"]) or h.get("overflow"):
            raise AssertionError(f"train: bad step {h}")
    for k, v in list(st["params"].items()) + list(ost["m"].items()) + \
            list(ost["v"].items()):
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"train: non-finite values in {k}")
    if not any(bool((ost["m"][k] != 0).any()) for k in ost["m"]):
        raise AssertionError("train: all gradients are zero")
    for k in STAGE1_KERNELS:
        if train_launches[k] < 1:
            raise AssertionError(f"train path did not launch {k}")

    # ---- 4. kernels vs plain ------------------------------------------
    step = trainer.make_train_step(opt, cfg, bg, lrs=optim.group_lrs(opt, 1.0),
                                   device=dev)
    ost0 = optim.adam_init(state["params"])
    with Capture() as cap_bench:
        step(state, ost0, cam, 1.0, 1.6e-4)
    torch.cuda.synchronize()
    calls = cap_bench.calls
    compare_binning(calls)
    log("[kernels] bench: B1, B2 equal to their plain versions")
    # B1 on the bench scene at tile 16 (2,500 tiles) and on the synthetic
    # rects of the CPU tests (tests/torch_kernel_inputs.py)
    p1 = state["params"]
    cfg16 = RasterConfig(tile=16)
    with torch.no_grad(), Capture() as cap16:
        prep16 = preprocess(
            p1["xyz"], G.get_scaling(p1), G.get_rotation(p1), cam.world_view,
            cam.full_proj, cam.camera_center, width=cam.width,
            height=cam.height, tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
            focal_x=cam.focal_x, focal_y=cam.focal_y,
            colors=torch.zeros_like(p1["xyz"]), cfg=cfg16)
        BN.bin_instances_counting(prep16, width=cam.width, height=cam.height,
                                  cfg=cfg16)
    done = [compare_counts(*cap16.calls["compute_counts"],
                           "bench scene, tile 16")]
    done_b2 = [compare_instances(*cap16.calls["compute_instances"],
                                 "bench scene, tile 16")]
    # B2 at its edge cases (a chunk whose rects all cover one tile, one of
    # empty and inverted rects, a last chunk ending in padding, m past and
    # below total_raw, tile 16, the wide grids, walked in bands) and on
    # B1's synthetic rects clipped to their grids
    for name in inputs.INSTANCE_CASES:
        done_b2.append(compare_instances(
            *instance_case(inputs.instance_inputs(name), dev), name))
    for name in inputs.RECT_CASES:
        rects, (gx, gy) = inputs.synthetic_rects(name)
        done_b2.append(compare_instances(*instance_case(
            inputs.instances_from_rects(rects, gx, gy), dev),
            f"synthetic {name}"))
    for name in inputs.RECT_CASES:
        rects, (gx, gy) = inputs.synthetic_rects(name)
        done.append(compare_counts(
            [torch.from_numpy(r).to(dev) for r in rects],
            dict(grid_x=gx, grid_y=gy), f"synthetic {name}"))
    for gx, gy in ((256, 256), (60_000, 3)):
        # past a block's shared memory: counted in bands of tile rows (256 x
        # 256: tile 16 over 4,096 x 4,096) or of a row's columns (60,000 x 3)
        done.append(compare_counts(
            [torch.from_numpy(r).to(dev)
             for r in inputs.wide_grid_rects(gx, gy)],
            dict(grid_x=gx, grid_y=gy), f"wide grid {gx} x {gy}"))
    log("[kernels] B1 equal to its plain version on " + "; ".join(done))
    log("[kernels] B2 equal to its plain version on " + "; ".join(done_b2))
    err3, err4 = compare_blend(calls, "bench")
    # the blend's edge inputs at every exact width and a generic one, at
    # every tile the wrappers take (32 is the main path's; at 24 and 8 the
    # stage-1 backward's 4-pixel lane patches do not fit, so it takes the
    # generic kernel)
    edge_calls, err3e, err4e = {}, 0.0, 0.0
    for tile in (32, 24, 16, 8):
        for name in inputs.BLEND_EDGE_CASES:
            ec = blend_edge_calls(inputs.blend_edge_inputs(name, tile=tile),
                                  dev)
            edge_calls[(name, tile)] = ec
            e3x, e4x = compare_blend(ec, f"edge inputs {name}, tile {tile}")
            err3e, err4e = max(err3e, e3x), max(err4e, e4x)
    # pixels that take pairs just below the alpha clamp, the regime in
    # which a float32 log(1 - alpha) drifts from exact: B3 held to its
    # plain version in float64, as at the recipe's size (phase 35)
    ec = blend_edge_calls(inputs.blend_near_clamp_inputs(), dev)
    split_blend(ec, "near-clamp inputs", card)
    e3x, e4x = compare_blend(ec, "near-clamp inputs", exact=True)
    err3e, err4e = max(err3e, e3x), max(err4e, e4x)

    sc_dev, cam_dev = small_scene(dev)
    with Capture() as cap_small:
        bufs_dev, grads_dev = run_small(sc_dev, cam_dev, dev)
    torch.cuda.synchronize()
    cv = cap_small.calls["blend_forward"][1]["cv"]
    eff_s = cap_small.calls["blend_backward"][0][2]
    tc_s = cap_small.calls["blend_forward"][0][2] // 128
    if cv < 1 or int(eff_s.max()) < 2 or not bool((eff_s < tc_s).any()) \
            or cap_small.calls["blend_backward"][0][5] is None:
        raise AssertionError("small scene does not exercise CV > 0, multiple "
                             "chunks, early exit and g_wsum")
    compare_binning(cap_small.calls)
    e3s, e4s = compare_blend(cap_small.calls, "small CV=2")
    err3, err4 = max(err3, e3s, err3e), max(err4, e4s, err4e)

    # ---- 5. parity: card (kernels) vs CPU (plain versions) -------------
    sc_cpu, cam_cpu = small_scene("cpu")
    bufs_cpu, grads_cpu = run_small(sc_cpu, cam_cpu, "cpu")
    for f in ("color", "depth", "normal", "feature", "vfeature", "opacity"):
        e = max_err_rel(getattr(bufs_dev, f).detach().cpu(),
                        getattr(bufs_cpu, f).detach())
        if e > 1e-4:
            raise AssertionError(f"parity: {f} differs by {e} (relative)")
    for k in grads_cpu:
        e = max_err_rel(grads_dev[k].cpu(), grads_cpu[k])
        if e > 1e-3:
            raise AssertionError(f"parity: d{k} differs by {e} (relative)")
    log("[parity] small scene: card == CPU (image 1e-4, gradients 1e-3 of "
        "max)")

    # ---- 6. timing ------------------------------------------------------
    from svgir_tpu_torch.kernels import binning as KB
    from svgir_tpu_torch.kernels import blend as KBL
    a2, kw2 = calls["compute_instances"]
    a3, kw3 = calls["blend_forward"]
    lib_b1_counts = library_counts(calls)
    timed = kernel_calls(calls)
    replaces = {k: f"svgir_tpu/ops/{v}" for k, v in REPLACES.items()}
    sources = {k: f"svgir_tpu_torch/csrc/{v}" for k, v in SOURCES.items()}
    errs = {"binning_counts": 0.0, "binning_instances": 0.0,
            "blend_forward": err3, "blend_backward": err4}
    bnd = bounds(calls)
    wk = bnd["blend_work"]
    log(f"[timing] blend work on the bench inputs: {wk['rows']} real rows "
        f"in processed chunks, {wk['pairs']} (pixel, row) pairs, {wk['ok']} "
        f"pass the footprint test, {wk['gated']} blend")
    report = []
    for name, (kfn, pfn, lfn) in timed.items():
        t = timings(kfn, pfn, lfn)
        entry = {
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": train_launches[name],
            "max_abs_err": errs[name], **t,
            "bound_ms": bnd[name][0], "bound_by": bnd[name][1]}
        extra = ""
        if name == "binning_counts":
            entry["library_counts_only_ms"] = cuda_ms(lib_b1_counts, reps=20)
            entry["library_counts_only_device_ms"] = device_ms(
                lib_b1_counts)[0]
            extra = (f"; counts-only bincount + 2-D cumsum "
                     f"{entry['library_counts_only_ms']:.4f} ms per call, "
                     f"{entry['library_counts_only_device_ms']:.4f} ms on "
                     "the device")
        report.append(entry)
        log(f"[timing] {name}: " + fmt_times(t, "bincount + cumsums")
            + f", bound {bnd[name][0]:.4f} ms by {bnd[name][1]}{extra}; "
            f"card: {card}")
    blend_extras(report, calls, "stage 1", ptx, parents, card)
    log_warp_visits(wk, kw3, "stage 1")
    # B2 against each --parent tree's, in turns, on the bench step's inputs
    b2_entry = next(e for e in report if e["name"] == "binning_instances")
    for p in parents:
        compare_instances(a2, kw2, f"captured, {p['label']}'s kernel",
                          kernel=p["instances"])
        o = in_turns(lambda p=p: p["instances"](*a2, **kw2),
                     lambda: KB.instances(*a2, **kw2))
        b2_entry.setdefault("parent", {})[p["label"]] = o
        log_turns(o, f"{p['label']} binning_instances", card)
    # the launch floor: an empty kernel of one block of 32 threads, and of
    # B2's grid on these inputs (a block per chunk, one per 2,048 slots)
    b2_grid = a2[0].numel() // kw2["gauss_chunk"] + -(-kw2["m"] // 2048)
    floor = {}
    for label, fn in (("1 x 32", launch_floor()),
                      (f"{b2_grid} x 512", launch_floor(b2_grid, 512))):
        floor[label] = (device_ms(fn)[0], cuda_ms(fn, reps=20))
        log(f"[timing] launch floor, empty kernel of {label} threads: "
            f"{floor[label][0]:.4f} ms on the device, {floor[label][1]:.4f} "
            f"ms per call; card: {card}")
    floor_ms = floor["1 x 32"][0]
    # B1 on a grid past a block's shared memory (counted in bands; no main
    # path runs such a grid, so 0 launches)
    rw = [torch.from_numpy(r).to(dev) for r in inputs.wide_grid_rects(256, 256)]
    kkw = dict(grid_x=256, grid_y=256, gauss_chunk=256)
    lib_w = b1_yardstick({"compute_counts": (rw, kkw)})
    t = timings(lambda: KB.counts(*rw, **kkw),
                lambda: BP.counts_plain(*rw, **kkw), lib_w)
    nsw, tw = rw[0].numel(), 256 * 256
    bw = (16 * nsw + 4 * tw + 4 * (nsw // 256) * tw) / HBM_BYTES_S * 1e3
    report.append({
        "name": "binning_counts_wide_grid", "route": "cuda",
        "source": sources["binning_counts"],
        "replaces": replaces["binning_counts"], "launches": 0,
        "max_abs_err": 0.0, **t, "bound_ms": bw, "bound_by": "bytes"})
    log(f"[timing] binning_counts on a 256 x 256 grid ({nsw} rects, in "
        f"bands): " + fmt_times(t, "bincount + cumsums") + f", bound "
        f"{bw:.4f} ms by bytes; card: {card}")

    def render_once(c):
        with torch.no_grad():
            render_view_stage1(cam, state["params"], bg, alive=state["alive"],
                               cfg=c)
    step_default = trainer.make_train_step(
        opt, cfg_default, bg, lrs=optim.group_lrs(opt, 1.0), device=dev)
    for label, c, fn in (("snug", cfg, step), ("default", cfg_default,
                                               step_default)):
        render_ms = host_ms(lambda: render_once(c), reps=10)
        step_ms = host_ms(lambda: fn(state, ost0, cam, 1.0, 1.6e-4), reps=10)
        log(f"[timing] cap {c.max_instances} ({label}): render 800x800/50k "
            f"forward {render_ms:.3f} ms; train step {step_ms:.3f} ms; "
            f"card: {card}")
    log(f"[timing] instances {int(a2[7])} (padded {int(a3[2].sum())}); the "
        "four kernels' sum per step: "
        f"{sum(r['ms'] for r in report):.3f} ms")
    log(f"[stage 1] {time.time() - t_start:.1f} s")

    # ---- 7. stage-2 render (eval path) ---------------------------------
    from svgir_tpu_torch.kernels import env_lookup as KE
    from svgir_tpu_torch.ops import env_lookup_pallas as EP
    from svgir_tpu_torch.render.svgss import render_view_svgss

    s2_state, bake, env0 = stage2_inputs(state, dev)
    alive = s2_state["alive"]

    def render_s2():
        with torch.no_grad():
            return render_view_svgss(cam, s2_state["params"], bake,
                                     env0["params"], bg, is_training=False,
                                     alive=alive, cfg=cfg)
    torch.cuda.synchronize()
    kernels.reset_launches()
    with Capture() as cap_s2_render:
        res2 = render_s2()
    torch.cuda.synchronize()
    s2_render_launches = kernels.launches()
    for k in ("render", "pbr", "pbr_env", "render_env", "base_color",
              "direct", "indirect"):
        if tuple(res2[k].shape) != (3, 800, 800) or \
                not bool(torch.isfinite(res2[k]).all()):
            raise AssertionError(f"stage-2 render: bad {k} image")
    if bool(res2["overflow"]):
        raise AssertionError("stage-2 render: binner overflow")
    log(f"[s2 render] 800x800, 50k surfels, S={S2_SAMPLES}, env "
        f"{S2_ENV_H}x{2 * S2_ENV_H}: pbr mean {float(res2['pbr'].mean()):.5f}"
        f", pbr_env mean {float(res2['pbr_env'].mean()):.5f}, launches "
        f"{s2_render_launches}")
    for k in ("env_lookup_forward", "blend_forward"):
        if s2_render_launches[k] < 1:
            raise AssertionError(f"stage-2 render did not launch {k}")

    # ---- 8. stage-2 train (main path) ----------------------------------
    lrs2 = optim.group_lrs(opt, 1.0, use_pbr=True)
    step2 = trainer.make_svgss_train_step(opt, cfg, bg, lrs=lrs2,
                                          device=dev)
    st2 = {**s2_state, "stats": state["stats"]}
    ost2, env2 = optim.adam_init(st2["params"]), env0
    torch.cuda.synchronize()
    kernels.reset_launches()
    s2_hist = []
    for i in range(steps):
        st2, ost2, env2, tb2 = step2(st2, ost2, env2, bake, cam,
                                     100.0 + i, 1e-5, opt.radiance_lr)
        s2_hist.append((float(tb2["loss"]), float(tb2["psnr_pbr"]),
                        bool(tb2["overflow"])))
    torch.cuda.synchronize()
    s2_train_launches = kernels.launches()
    log(f"[s2 train] {steps} steps: " + ", ".join(
        f"loss {l:.6f} psnr_pbr {q:.4f}" for l, q, _ in s2_hist))
    log(f"[s2 train] launches {s2_train_launches}")
    if any(not math.isfinite(l) or o for l, _, o in s2_hist):
        raise AssertionError(f"stage-2 train: bad step {s2_hist}")
    tensors = list(st2["params"].items()) + list(ost2["m"].items()) + \
        list(ost2["v"].items()) + [("env", env2["params"]["env"]),
                                   ("env m", env2["opt"]["m"]["env"]),
                                   ("env v", env2["opt"]["v"]["env"])]
    for k, v in tensors:
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"stage-2 train: non-finite values in {k}")
    if not bool((env2["opt"]["m"]["env"] != 0).any()):
        raise AssertionError("stage-2 train: the env got no gradient")
    for k in STAGE2_KERNELS:
        if s2_train_launches[k] < steps:
            raise AssertionError(f"stage-2 train launched {k} "
                                 f"{s2_train_launches[k]} times in {steps} "
                                 "steps")

    # ---- 9. stage-2 kernels vs plain ------------------------------------
    ost2_0 = optim.adam_init(s2_state["params"])
    s2_args = ({**s2_state, "stats": state["stats"]}, ost2_0, env0, bake,
               cam, 100.0, 1e-5, opt.radiance_lr)
    with Capture() as cap_s2:
        step2(*s2_args)
    torch.cuda.synchronize()
    c2 = cap_s2.calls
    kw_s2 = c2["blend_forward"][1]
    kw_s2e = cap_s2_render.calls["blend_forward"][1]
    if (kw_s2["ca"], kw_s2["cv"]) != (13, 13) or \
            (kw_s2e["ca"], kw_s2e["cv"]) != (16, 16):
        raise AssertionError("stage-2 blend widths are not CA/CV 13/13 "
                             "(train) and 16/16 (eval)")
    e7f, e7b = compare_env(c2, "stage-2 step")
    evals = cap_s2_render.every["env_lookup_forward"]
    e7fe = [compare_env_forward(a, f"stage-2 eval call {i}")
            for i, (a, _) in enumerate(evals)]
    e7f_edge, e7b_edge = 0.0, 0.0
    for h, w in ((16, 32), (32, 64)):
        for m in (37, 1_027, 20_003):
            env, u, v, g = inputs.env_lookup_inputs(h, w, 3, m, seed=m)
            env, u, v, g = (torch.from_numpy(x).to(dev) for x in (env, u, v, g))
            lab = f"edge cases {h}x{w}, M={m}"
            e7f_edge = max(e7f_edge, compare_env_forward((env, u, v), lab))
            e7b_edge = max(e7b_edge, compare_env_backward(u, v, g, h, w, lab))
            # u, v and g starting 4 bytes into their buffers: not 16-byte
            # aligned
            lab = f"edge cases {h}x{w}, M={m - 1}, unaligned"
            e7f_edge = max(e7f_edge, compare_env_forward(
                (env, u[1:], v[1:]), lab))
            e7b_edge = max(e7b_edge, compare_env_backward(
                u[1:], v[1:], g.reshape(-1)[1:3 * m - 2].reshape(m - 1, 3),
                h, w, lab))
    log(f"[kernels] B7 forward on the eval render's {len(evals)} lookups "
        f"({', '.join(str(a[1].numel()) for a, _ in evals)} queries): "
        f"max|err| {max(e7fe):.3g}; on the edge cases (16x32 and 32x64, "
        f"M 37, 1,027, 20,003 and one less, unaligned): forward "
        f"{e7f_edge:.3g}, backward {e7b_edge:.3g}")
    # B7's backward on an env that fits one copy a block but too few for
    # one a warp (64x128: the route of shared atomics)
    env, u, v, g = (torch.from_numpy(x).to(dev)
                    for x in inputs.env_lookup_inputs(64, 128, 3, 20_003))
    e7b_mid = compare_env_backward(u, v, g, 64, 128, "env 64x128, M=20003")
    log(f"[kernels] B7 backward on a 64x128 env (one copy a block, M "
        f"20,003): max|err| {e7b_mid:.3g}")
    # envs past a block's shared memory: read in place, gradient summed in
    # slices
    e7_wide = [0.0, 0.0]
    for h, w in ((128, 256), (256, 512)):
        env, u, v, g = (torch.from_numpy(x).to(dev)
                        for x in inputs.env_lookup_inputs(h, w, 3, 20_003))
        for uu, vv, gg, tag in ((u, v, g, ""), (u[1:], v[1:],
                                                g[1:].contiguous(),
                                                ", unaligned")):
            lab = f"env {h}x{w}, M={uu.numel()}{tag}"
            e7_wide[0] = max(e7_wide[0], compare_env_forward((env, uu, vv),
                                                             lab))
            e7_wide[1] = max(e7_wide[1], compare_env_backward(uu, vv, gg, h,
                                                              w, lab))
    log(f"[kernels] B7 on envs past shared memory (128x256, 256x512; M "
        f"20,003 and one less, unaligned): forward max|err| "
        f"{e7_wide[0]:.3g}, backward {e7_wide[1]:.3g}")
    compare_binning(c2)
    compare_binning(cap_s2_render.calls)
    e3s2, e4s2 = compare_blend(c2, "stage-2 step CA=13 CV=13")
    e3s2e, _ = compare_blend(cap_s2_render.calls, "stage-2 eval CA=16 CV=16")

    # ---- 9b. a stage-2 step with a 128 x 256 env (train.py
    # --env_resolution 128; H = 128 is direct_light_map_init's default
    # argument, the configuration's default is 16): B7 past shared memory
    s2_128, bake128, env128 = stage2_inputs(state, dev, env_h=128)
    st128 = {**s2_128, "stats": state["stats"]}
    s2_args128 = (st128, optim.adam_init(st128["params"]), env128, bake128,
                  cam, 100.0, 1e-5, opt.radiance_lr)
    torch.cuda.synchronize()
    kernels.reset_launches()
    with Capture() as cap128:
        _, _, env128b, tb128 = step2(*s2_args128)
    torch.cuda.synchronize()
    l128 = kernels.launches()
    if not math.isfinite(float(tb128["loss"])) or bool(tb128["overflow"]):
        raise AssertionError("stage-2 step, env 128: bad step")
    if not bool(torch.isfinite(env128b["params"]["env"]).all()) or \
            not bool((env128b["opt"]["m"]["env"] != 0).any()):
        raise AssertionError("stage-2 step, env 128: the env got no finite "
                             "gradient")
    check_launches(l128, "stage-2 step, env 128", at_least=(
        ("env_lookup_forward", 1), ("env_lookup_backward", 1),
        ("blend_forward", 1), ("blend_backward", 1)))
    e7f128, e7b128 = compare_env(cap128.calls, "stage-2 step, env 128x256")
    log(f"[s2 env 128] loss {float(tb128['loss']):.6f}, launches {l128}")

    # ---- 10. stage-2 parity: card vs CPU (16 x 32 and 128 x 256 envs) ---
    for env_h in (16, 128):
        ev_d, r_d, g_d = run_small_stage2(dev, env_h)
        ev_c, r_c, g_c = run_small_stage2("cpu", env_h)
        for k in ("render", "pbr", "base_color", "roughness", "direct",
                  "indirect", "pbr_env", "render_env", "opacity"):
            f = 2 if k in ("direct", "indirect") else 1
            e = float((ev_d[k].cpu() - ev_c[k]).abs().max())
            if e > f * TOL_S2_IMG:
                raise AssertionError(f"s2 parity: {k} differs by {e}")
        e = float(((ev_d["depth"].cpu() - ev_c["depth"]).abs()
                   / ev_c["depth"].abs().clamp(min=1e-6)).max())
        if e > TOL_S2_DEPTH:
            raise AssertionError(f"s2 parity: depth differs by {e} "
                                 "(relative)")
        el = abs(r_d["loss"].item() - r_c["loss"].item())
        if el > 1e-5 * max(1.0, abs(r_c["loss"].item())):
            raise AssertionError(f"s2 parity: loss differs by {el}")
        if sorted(g_d) != sorted(g_c):
            raise AssertionError("s2 parity: different groups got gradients")
        worst = max((max_err_rel(g_d[k].cpu(), g_c[k]), k) for k in g_c)
        if worst[0] > TOL_S2_GRAD:
            raise AssertionError(f"s2 parity: d{worst[1]} differs by "
                                 f"{worst[0]} of its largest magnitude")
        log(f"[s2 parity] small stage-2 scene, env {env_h}x{2 * env_h}: "
            f"card == CPU (images {TOL_S2_IMG}, depth {TOL_S2_DEPTH} "
            f"relative, loss within {el:.3g}, gradients within "
            f"{worst[0]:.3g} of max, worst d{worst[1]})")

    # ---- 11. stage-2 timing ---------------------------------------------
    step2_ms = host_ms(lambda: step2(*s2_args), reps=10)
    render2_ms = host_ms(render_s2, reps=10)
    log(f"[s2 timing] cap {cfg.max_instances}: stage-2 train step "
        f"{step2_ms:.3f} ms; eval render {render2_ms:.3f} ms; card: {card}")
    bnd2 = bounds(c2)
    bnd2e = bounds({**c2, "blend_forward": cap_s2_render.calls[
        "blend_forward"]})
    log_blend_work(bnd2e, *cap_s2_render.calls["blend_forward"],
                   "stage-2 eval render")
    fa, _ = c2["env_lookup_forward"]
    ba, bkw = c2["env_lookup_backward"]
    bnd_env = env_bounds(fa)
    b3, kw3s = c2["blend_forward"]
    b4, kw4s = c2["blend_backward"]
    b3e, kw3e = cap_s2_render.calls["blend_forward"]
    timed2 = {
        "env_lookup_forward": (
            lambda: KE.env_lookup_forward(*fa),
            lambda: EP.env_lookup_forward_plain(*fa),
            "svgir_tpu/ops/env_lookup_pallas.py:63",
            "svgir_tpu_torch/csrc/env_lookup.cu", s2_train_launches, e7f,
            bnd_env["env_lookup_forward"], library_env_forward(fa)),
        "env_lookup_backward": (
            lambda: KE.env_lookup_backward(*ba, **bkw),
            lambda: EP.env_lookup_backward_plain(*ba, **bkw),
            "svgir_tpu/ops/env_lookup_pallas.py:76",
            "svgir_tpu_torch/csrc/env_lookup.cu", s2_train_launches, e7b,
            bnd_env["env_lookup_backward"], library_env_backward(c2)),
        "blend_forward_stage2": (
            lambda: KBL.blend_forward(*b3, **kw3s),
            lambda: BS.blend_forward_plain(*b3, **kw3s),
            replaces["blend_forward"], sources["blend_forward"],
            s2_train_launches, e3s2, bnd2["blend_forward"], None),
        "blend_backward_stage2": (
            lambda: KBL.blend_backward(*b4, **kw4s),
            lambda: BS.blend_backward_plain(*b4, **kw4s),
            replaces["blend_backward"], sources["blend_backward"],
            s2_train_launches, e4s2, bnd2["blend_backward"], None),
        "blend_forward_stage2_eval": (
            lambda: KBL.blend_forward(*b3e, **kw3e),
            lambda: BS.blend_forward_plain(*b3e, **kw3e),
            replaces["blend_forward"], sources["blend_forward"],
            s2_render_launches, e3s2e, bnd2e["blend_forward"], None),
    }
    # B7 on the env-128 step's lookups (the env read in place, the
    # gradient added with atomics)
    fa128, _ = cap128.calls["env_lookup_forward"]
    ba128, bkw128 = cap128.calls["env_lookup_backward"]
    for name, kfn, pfn, rep_, err, direction, lfn in (
            ("env_lookup_forward_stage2_env128",
             lambda: KE.env_lookup_forward(*fa128),
             lambda: EP.env_lookup_forward_plain(*fa128),
             "svgir_tpu/ops/env_lookup_pallas.py:63", e7f128,
             "env_lookup_forward", library_env_forward(fa128)),
            ("env_lookup_backward_stage2_env128",
             lambda: KE.env_lookup_backward(*ba128, **bkw128),
             lambda: EP.env_lookup_backward_plain(*ba128, **bkw128),
             "svgir_tpu/ops/env_lookup_pallas.py:76", e7b128,
             "env_lookup_backward", library_env_backward(cap128.calls))):
        timed2[name] = (kfn, pfn, rep_, "svgir_tpu_torch/csrc/env_lookup.cu",
                        l128, err, env_bounds(fa128)[direction], lfn)
    # B7's forward on each of the eval render's lookups (1.2M bake
    # directions and 640,000 camera rays)
    for i, (a, _) in enumerate(evals):
        timed2["env_lookup_forward_stage2_eval" + (f"_{i + 1}" if i else "")] \
            = (lambda a=a: KE.env_lookup_forward(*a),
               lambda a=a: EP.env_lookup_forward_plain(*a),
               "svgir_tpu/ops/env_lookup_pallas.py:63",
               "svgir_tpu_torch/csrc/env_lookup.cu", s2_render_launches,
               e7fe[i], env_bounds(a)["env_lookup_forward"],
               library_env_forward(a))
    for name, (kfn, pfn, rep, src, lc, err, bd, lfn) in timed2.items():
        with torch.no_grad():
            t = timings(kfn, pfn, lfn)
        key = name.split("_stage2")[0]
        report.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": lc[key], "max_abs_err": err, **t,
            "bound_ms": bd[0], "bound_by": bd[1]})
        log(f"[s2 timing] {name}: " + fmt_times(t, "grid_sample")
            + f", bound {bd[0]:.4f} ms by {bd[1]}; card: {card}")
    # B7's backward against each --parent tree's, in turns
    for name, (b_, bkw_), label in (
            ("env_lookup_backward", (ba, bkw), "S = 24 step"),
            ("env_lookup_backward_stage2_env128", (ba128, bkw128),
             "env 128x256 step")):
        times = parent_env_backward(parents, b_, bkw_, label, card)
        if times:
            next(e for e in report if e["name"] == name)["parent"] = times
    blend_extras(report, c2, "stage-2 step", ptx, parents, card,
                 {"forward": "blend_forward_stage2",
                  "backward": "blend_backward_stage2"})
    blend_extras(report, cap_s2_render.calls, "stage-2 eval", ptx, parents,
                 card, {"forward": "blend_forward_stage2_eval"})
    wk2 = bnd2["blend_work"]
    log_warp_visits(wk2, kw3s, "stage 2")
    log(f"[s2 timing] blend work on the stage-2 step's inputs: {wk2['rows']} "
        f"real rows, {wk2['pairs']} pairs, {wk2['ok']} pass the footprint "
        f"test, {wk2['gated']} blend; {fa[1].numel()} env queries per step")

    log(f"[stage 2] {time.time() - t_start:.1f} s")

    # ---- 35. the recipe's size: B1-B4 and B7 on 524,288 rows -------------
    # (early in the run, where torch.profiler keeps its device records)
    report.extend(run_recipe_size(card, dev))
    torch.cuda.empty_cache()

    # ---- 12-16. the radiance bake ------------------------------------------
    out_dir = sys.argv[sys.argv.index("--profile") + 1] \
        if "--profile" in sys.argv[1:-1] else None
    bake_rows, s3_args = run_bake(state, cam, opt, cfg, bg, card, dev,
                                  parents, out_dir)
    report.extend(bake_rows)

    # ---- 17-23. the tile-major paths (strip 0, sort binner) and B9 -------
    report.extend(run_tiles(
        state, cam, opt, cfg, bg, card, dev,
        step8=(step, (state, ost0, cam, 1.0, 1.6e-4)),
        s2=(s2_state, bake, env0, step2, s2_args), edge_calls=edge_calls,
        ptx=ptx, parents=parents, profile_dir=out_dir))

    # ---- 24-25. densification and the training CLI -------------------------
    run_trainer(card, dev)

    # ---- 26-27. relighting under HDR lights, visibility ---------------------
    report.extend(run_relight(card, dev))

    # ---- 30. render_sh: camera rays through the grid (B8) ----------------
    report.extend(run_render_sh(card, dev))

    # ---- 31. the stand-in harness -----------------------------------------
    run_standin(card, dev)

    # ---- 32-33. the parallel paths: world 1 on NCCL, two ranks on gloo ----
    import shutil
    paths, par_tmp = run_parallel(card, dev, state, cam, opt, cfg, bg,
                                  s3_args)
    try:
        run_two_ranks(card, dev, cfg, par_tmp, paths)
    finally:
        shutil.rmtree(par_tmp, ignore_errors=True)
    for entry in report:
        key = max((k for k in kernels.KERNEL_NAMES
                   if entry["name"].startswith(k)), key=len, default=None)
        if key is not None:
            entry["parallel_launches"] = {path: lc[key]
                                          for path, lc in paths.items()}

    # ---- 34. the recipe: the scene generator and full_schedule -----------
    recipe = run_recipe(card, dev)
    for entry in report:
        key = max((k for k in kernels.KERNEL_NAMES
                   if entry["name"].startswith(k)), key=len, default=None)
        if key is not None:
            entry["recipe_launches"] = {part: lc[key]
                                        for part, lc in recipe.items()}

    if out_dir:
        profile_step(lambda: step(state, ost0, cam, 1.0, 1.6e-4), out_dir)
        profile_step(lambda: step2(*s2_args), out_dir,
                     "chip_smoke_profile_stage2.txt")
    log(f"[done] {time.time() - t_start:.1f} s")
    return finish(report, card, floor_ms)


def finish(report, card, floor_ms):
    """The last three lines: the kernels JSON, the card, the result."""
    import torch
    for entry in report:
        entry["launch_floor_device_ms"] = floor_ms
    print(json.dumps({"kernels": report}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
