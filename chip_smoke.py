#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``diffuman4d_torch``) on one GPU.

    python3 chip_smoke.py                    # every phase, as a release check
    python3 chip_smoke.py --phases kernels   # build + kernel checks only
    python3 chip_smoke.py --phases build,train,kernels   # the train path only
    python3 chip_smoke.py --phases build,tune,kernels    # the attention sweep only
    python3 chip_smoke.py --phases build,demo4d          # demo_4d, budgeted and resumed
    python3 chip_smoke.py --phases build,variants,kernels  # DPM++ / Euler / FreeU / skeletons
    python3 chip_smoke.py --phases build,bench,train,train_run  # the measurement entry points
    python3 chip_smoke.py --phases build,waves,kernels   # waves and CP over NCCL, CP shapes
    python3 chip_smoke.py --phases build,train_dp        # dp / tp training over NCCL
    python3 chip_smoke.py --phases build,units,kernels   # the measurement tools

Phases:

1. ``build``: compile every CUDA kernel of ``diffuman4d_torch/csrc`` with
   ``nvcc`` for sm_90a into ``build/`` (one ``nvcc`` per source, in parallel).
1b. ``tune``: the attention tuner's entry point
   (``diffuman4d_torch.tune_attention.main``) on six hot shapes
   (``TUNE_SHAPES``), writing a table under ``build/smoke/``: every
   candidate kernel and block size is timed, the skewed-pipeline (B1/B2),
   single-pass (B8), batched single-pass (B9) and two-level (B10) kernels
   among them. Counters are zeroed just before it and read just after: each
   of the four must have launched, and no candidate may have failed. Its winners are printed
   beside the committed table's (a different winner is reported, not
   failed: another card's clocks are no fault of the program).
1c. ``bench``: ``python -m diffuman4d_torch.bench`` in a child process, as
   a user runs it (its scene under ``build/smoke/bench``): it must exit 0
   and print the smoke tier's ``smoke_window_step_sec`` line and the full
   tier's ``cam_frames_per_sec_per_chip`` line (a 48-camera demo_3d task
   at 1024^2, warm and cold), every value positive, and the full tier's
   ``launches`` must show B1, B2, B8, B9, B3 and B4 each launched. Its
   times are logged beside the card's name and power limit, and the shapes
   its wrappers launched (its ``shapes.json``) go to the kernels phase.
2. ``reference``: the full-width UNet on one small CFG window and the VAE
   decoder on one small latent, each run once through the kernels and once
   with every kernel swapped for its plain version; the outputs must agree.
   Then one loss + backward of a UNet of full width per layer and one layer
   per block (4 frames, 32^2 latents) through the train kernels and through
   their plain versions; the gradients must agree.
3. ``slice``: one demo_3d spatial task through the port's sampler at full
   width -- a synthetic 16-camera scene at 1024^2, inputs [1, 5, 9, 13],
   window 12 (CFG batch 32 at 128^2 latents, as in production demo_3d),
   stride 1 (the sampler requires the frame count, here 1, to be a
   multiple of the stride), one round, DDIM, CFG 2.0, random bf16 weights
   from a seed: 12 windows, 12 steps per target, 12 decoded images. Its
   attention follows the committed dispatch table
   (``diffuman4d_torch/ops/attention_table.json``). Launch counters (and
   the wrappers' records of launched shapes) are zeroed just before it and
   read just after: every launch must be the one the table routes its shape
   to, every kernel the table routes the slice's attention shapes to must
   have run, and so must the fused conv.
3b. ``cli``: production demo_3d through the port's own CLI
   (``diffuman4d_torch.cli.main``, in this process): the random bf16 models
   are written as a diffusers directory (``io/checkpoints.py``
   ``save_hf_checkpoint``) under ``build/smoke/model``, on the bench
   phase's synthetic 48-camera, one-frame scene at 1024^2 (a 16-camera one
   made here when that phase did not run) ``exp=demo_3d``
   (window 12, stride 1, one round, DDIM, CFG 2.0, bf16) cut to cameras
   0-15 with inputs [1, 5, 9, 13] (the bench carries the 48-camera task)
   runs from that directory with ``evaluating=true``: sampling,
   nerfstudio export, metrics. Launch counters and shape records are zeroed
   just before the call and read just after. It must return 0 and write 16
   JPEGs, ``transforms.json`` with 16 frames, ``transforms_input.json``
   with 4 and ``metrics.json`` with 12 values and a finite mean PSNR; the
   loaded weights must equal the saved ones bit for bit; the task must run
   12 windows; B3 and B4 must have launched, every attention launch on
   the kernel the table routes its shape to.
3c. ``demo4d``: the ``exp=demo_4d`` preset's schedule (window 12, three
   rounds spatial / temporal / spatial, DDIM, CFG 2.0 split on the temporal
   domain, bf16, random weights from seed 0), cut from stride 2 to stride 4
   (3 windows a task at the same shapes: the cut that pays for the units
   phase), on a synthetic scene of 16 cameras x 12 frames at 1024^2 (4
   frames rendered, the rest hardlinked), inputs [1, 5, 9, 13]: 12 spatial
   tasks per spatial round and 12 temporal tasks of L = 24 rows, 108 window
   steps, in two parts on one output directory. (a) One session of
   ``demo4d_chain`` (its ``run_chain`` with this process's session, rolled
   up by ``demo4d_report``, whose session, grid and image counts must match
   the state): the sampler, built as the CLI builds it, with
   ``pose_cache_mb=200`` (the 16-row spatial tasks materialise their pose
   features, the 24-row temporal tasks stream them) in chunks of one window
   (3 a task), ``task_budget=17`` and a state every 4 tasks: it must stop
   with ``state/grid_state.d4d`` at round 1 + 5 tasks, its latents equal to
   the card's grid bit for bit. Then, for one temporal task, every chunk's
   streamed pose features must equal the cache's materialised rows -- at the
   pipeline's chunking of the task's windows and at windows of 4 + 4 rows
   in chunks of 2 whose unions are renumbered and padded (pad_u 12, 4 pad
   rows) -- and the cached conditional latents warm must equal cold, bit
   for bit, each row computed beside other rows on the two sides.
   (b) ``cli.main(["exp=demo_4d", ...,
   "evaluating=true"])`` must resume at round 1 + 5 tasks, run the other 7 +
   12 tasks, return 0 and write 192 JPEGs, ``transforms.json`` with 192
   frames, ``metrics.json`` with 144 values and a finite mean PSNR and a
   final state at round 3 with every target cell at the last step and every
   input cell at 0. Counters and shape records are zeroed just before each
   part and read just after: B3 and B4 must launch in both, every
   attention launch on the kernel the table routes its shape to, at the
   spatial (L = 16, CFG batch 32) and temporal (L = 24, split CFG) shapes.
   (c) ``temporal_wave_proof``'s ``main`` on the same scene and cut: it
   must seed and write a round-1 state and run one temporal task, launching
   B3 and B4, every attention launch on its routed kernel.
3d. ``variants``: the checkpoint variants from diffusers directories
   written by ``save_hf_checkpoint`` (random bf16 weights from seed 0 at
   the production widths, SD2.1's noise schedule). (a) The skeleton-latent
   UNet (``enable_pose_encoder=False``, ``in_channels=15``: every row's
   skeleton VAE-encoded into the UNet's input) under DPM++: ``cli.main(
   ["exp=demo_4d", ...])`` on the demo4d grid (16 x 12, inputs [1, 5, 9,
   13]) cut to two rounds (spatial, temporal) at stride 4, 3 windows a
   task, with ``to_nerfstudio=false evaluating=false``, stopped by a task
   budget after the first temporal task; then a second ``cli.main`` resumes
   and finishes. The state's ``aux_*`` arrays must equal the card's grid
   history bit for bit when each call stops, the resumed sampler's history
   must equal the file, ``has_prev`` must mark exactly the stepped latents,
   and the outputs must be complete (192 JPEGs); per task and domain,
   ``prepare_conditions`` and ``sliding_denoise`` are timed. For the first
   temporal task, skeleton latents encoded beside other rows and each
   chunk's gathered rows (a window a chunk, and padded windows of 4 + 4
   rows) must equal the task's own encode bit for bit. (b) The same
   weights under Euler with FreeU at its defaults (``UNetConfig.freeu``),
   one demo_3d task of 16 cameras through ``load_pipeline``; a window step
   of the full-width model (4 frames at 32^2 latents, CFG) through the
   kernels and through the plain versions must agree within the reference
   phase's bound; a production window step (CFG batch 32 at 128^2) is timed
   with FreeU and without, in turns. Counters are zeroed just before each
   call and task and read just after: B3 and B4 must launch in each,
   every attention launch on the kernel the table routes its shape to.
4. ``train``: three optimiser steps of the full-width UNet (0.87 B
   parameters, fp32 masters, bf16 compute, per-block remat, AdamW) on one
   window batch of the synthetic scene through ``WindowBatcher`` +
   ``encode_training_batch`` (B = 1, L = 12: 4 condition rows + 8 targets,
   1024^2 images, 128^2 latents) with a fixed noise draw, twice from the
   same weights. Counters are zeroed just before and read just after: the
   forward-with-logsumexp kernel, the fused backward and the fused conv
   must have launched the reckoned number of times; the loss must be
   finite, fall from step 1 to step 3 and repeat bit for bit at every step.
   Then ``diffuman4d_torch.train_step_chip`` (the entry point, in this
   process) runs the same shape with Adafactor, 3 timed steps: its record
   must hold a finite loss and a step time, not an out-of-memory record;
   its peak memory is logged beside AdamW's.
4b. ``waves``: the multi-device sampling paths on one card, in a child
   process started as ``torchrun`` starts rank 0 of 1 (``RANK=0
   WORLD_SIZE=1 MASTER_ADDR=127.0.0.1``), so that
   ``parallel/distributed.initialize`` brings up NCCL. demo_4d's preset
   (window 12, stride 2, DDIM, CFG 2.0, random bf16 weights from seed 0)
   on the demo4d scene cut to 2 frames and one spatial round (two tasks of
   16 rows, 6 windows each) runs through the serial ``execute_tasks`` and
   through ``execute_tasks_parallel(make_mesh())`` (waves of one, each
   wave's rows all-gathered over the NCCL group): the grids, timestep
   indices, grid-state files and JPEGs must be equal, byte for byte, and
   each wave must make its two collectives. Counters are zeroed just
   before the wave run and read just after: B1/B2, B3 and B4 must launch.
   Then one full-width no-CFG window step (16 frames at 128^2 latents)
   through ``parallel/cp_unet.make_cp_unet_apply`` on the 1-rank model
   group must equal the plain forward (bit for bit, or within the
   reference phase's bound), with as many K/V all-gathers as
   ``cp_comm_budget`` counts (22) plus the output's. It prints the wave
   phases, the NCCL version and the card's name and power limit.
4c. ``train_dp``: data- and tensor-parallel training on one card, in a
   child process started as ``waves`` starts one (NCCL at world size 1).
   The full-width UNet in bf16 at the ``train`` phase's shape (one
   12-frame window at 128^2 latents, remat, attention "train") takes two
   AdamW steps through ``make_train_step`` on a 1 x 1 mesh over the
   process group (the masters and moments of every weight that
   ``shard_params_for_tp`` places held as model-axis slices, the
   gradients all-reduced over the data group in one buffer, the working
   copy all-gathered after each update), then the same two steps without
   a mesh from the same weights: loss, gradient norm, masters and moments
   must be equal bit for bit. Counters are zeroed just before the mesh
   steps and read just after: the forward-with-logsumexp kernel, the
   fused backward and the fused conv must launch. Then ``train(...,
   mesh=)`` runs three steps with a state at step 2, and a second call
   resumes that state in another directory for the third: the two final
   states must be equal bit for bit, and the loop's VAE encodes
   must launch the d = 512 attention and the fused conv. Last, the
   synthetic scene's visual hull is carved on the card and on the CPU
   (``preprocess/visual_hull.carve_scene``), and the two PLY files must be
   equal. It prints the step times with and without the mesh, the time in
   all-reduces and all-gathers per step, the peak memory, the state's bytes
   and the launches, beside the card's name and power limit.
4d. ``units``: the port's measurement tools at full width, each through
   its ``main`` in this process at a few calls (a warm-up, then one window
   of ``--iters``; ``UNITS_TOOLS``), writing its JSON beside the ``--out``
   file under ``units/``: ``profile_units``, ``profile_unet_units``,
   ``profile_vae``, ``profile_vae_conv`` (which holds B4 against its plain
   version at the VAE shapes), ``profile_window`` (spatial: the attention
   shapes, a full window step, VAE encode and decode of 4),
   ``attn_ceiling`` and ``bench_flash_backward`` (which holds dQ, dK and dV
   against the plain version). Each must exit 0 with every time positive;
   counters are zeroed just before the tools and read just after: B3, B4,
   B5 and the fused backward must launch, every attention launch on the
   kernel the table routes its shape to, and the window step's shapes among
   them. One line per tool.
5. ``kernels``: each kernel against its plain PyTorch version, in bf16,
   with CUDA-event times of both, of the one PyTorch library call that
   computes the same function (a yardstick, called nowhere in the port) and
   the card's bound for the work, at a fixed list of the paths' shapes (the
   d = 64 kernel at the table's blocks; the single pass at S 256, 512 and
   1,024, a ragged S and its largest Sk, 4,096) plus every (shape, epilogue
   variant or block sizes) the tune, bench, slice, cli, demo4d, train,
   variants, waves, train_dp and units phases launched, and context parallelism's attention shapes
   (``CP_ATTN64_SHAPES``: Sq = Sk * groups / n queries against the gathered
   Sk keys, the bench's windows at model 4 and 8) on the kernel ``route``
   gives each, each beside its Sq = Sk time; the temporal mid block (Sk
   6,144) must route to the d = 64 skewed kernel.
   Where the plain attention cannot hold the S x S scores it is compared on
   a random subset of query rows against the full K/V and timed
   query-chunked; dK/dV are then compared with Q and dO cut to that subset
   on both sides. The fused backward is also launched twice more at each
   train shape, and its dQ, dK and dV must repeat bit for bit. The GroupNorm
   + SiLU pair (``GN_SHAPES``: the UNet's levels at a CFG window, a temporal
   step's 960 channels, the VAE's 1024^2 stage, then every shape the paths
   launched; inputs whose images, groups and channels differ in mean and
   scale by far more than the tolerance) must agree with its plain version
   elementwise within ``GN_REL_TOL`` and repeat bit for bit; its bound is 6
   bytes an element. The reference phase counts its launches beside the
   other kernels'.

``--phases profile`` (not in the default set) adds a torch.profiler
breakdown of one CFG window step, one VAE decode micro-batch, a VAE encode
of 2 images at 1024^2 and one train step by kernel group, written beside
the ``--out`` file as ``profile_*.txt``, then ``probe_temporal_mem`` at the
production 48 x 150 shapes (CFG fused, then the temporal domain split).
``--phases build,demo4d_prod`` (not in the default set) runs the production
demo_4d grid (48 cameras x 150 frames at 1024^2, 4 frames rendered) through
``python -m diffuman4d_torch.demo4d_prefix``'s ``main``: a session of 2
spatial tasks, then a fresh call that resumes from its state and runs 1
more, with the seconds per task, ``save_state``'s copy to the host and
write of the 0.94 GB grid, the resume's load and the peak memory; then a
session of two production temporal tasks (300 rows, 75 windows, streamed
in 15 chunks of 5) from a state that claims round 1 done; then a DPM++
checkpoint's one-task session and a resumed one, with the state's bytes
(latents and multistep history), ``save_state``'s copy and write and the
resume's load; last, ``demo4d_slice`` (one spatial and one temporal task on
the full grid, CFG fused, the state written and resumed).
``--phases build,overlap`` (not in the default set) times 4 tasks of
demo_4d's last round (16 x 12, every target decoded) through the saver
thread and through the serial path, in turns after one untimed run.
``--phases build,train_run`` (not in the default set) runs ``python -m
diffuman4d_torch.train_run_chip`` (full width, window 6 at 512^2,
Adafactor, host EMA) in a child process for 12 steps with a checkpoint
every 6, then in a second one that must resume at step 12 and run to 18,
then ``--report``: the logged steps and the state checkpoints must
continue across the two sessions and every loss must be finite.

Exit code 0 only when every phase passed. The last stdout line is the JSON
device record; the line before it lists the kernels. Without a CUDA device
it exits 2 and prints nothing on stdout.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("build", "tune", "bench", "reference", "slice", "cli", "demo4d", "train", "variants",
          "waves", "train_dp", "units", "kernels")
EXTRA_PHASES = ("profile", "demo4d_prod", "overlap", "train_run")  # run only when asked for

# (B, S, H) at head dim 64: the UNet's attention at a 16-row CFG window over
# 128^2 latents (3D window attention and per-frame attention at each level)
ATTN64_SHAPES = [
    (2, 65536, 10),  # 3D, 64^2 level (largest: the kernel's headline time)
    (32, 16384, 5),  # per-frame, 128^2
    (32, 4096, 10),  # per-frame, 64^2
    (2, 16384, 20),  # 3D, 32^2
    (32, 1024, 20),  # per-frame, 32^2
    (2, 4096, 20),  # 3D, 16^2 mid block
]
# the slice's attention shapes at head dim 64: the above and the per-frame
# 16^2 mid block (a window of 12 targets and 4 inputs in the slice and in
# production demo_3d alike)
SLICE_ATTN64_SHAPES = ATTN64_SHAPES + [(32, 256, 20)]
# the cli phase: production demo_3d (the JAX package's exp=demo_3d preset:
# window 12, stride 1) cut to 16 of the bench scene's 48 cameras, inputs [1,
# 5, 9, 13], so 12 targets and 12 windows (the bench carries the 48-camera
# task)
CLI_CAMERAS, CLI_INPUTS = 16, (1, 5, 9, 13)
ATTN512_SHAPES = [(2, 16384, 1)]  # VAE mid block at 128^2 latents
# (B, Sq, Sk, H, *blocks) of the single pass (B8) and its batched form (B9):
# the per-frame 16^2 mid block (the heaviest path shape, first), 512 and
# 1,024 keys (the per-frame 32^2 level), a ragged length and the largest Sk
# the gate admits
SINGLE_PASS_SHAPES = [(32, 256, 256, 20, 128), (32, 512, 512, 20, 128),
                      (32, 1024, 1024, 20, 128), (32, 777, 777, 20, 64),
                      (4, 200, 4096, 20, 128)]
SINGLE_PASS_BATCHED_SHAPES = [(32, 256, 256, 20, 128, 5), (32, 512, 512, 20, 128, 4),
                              (32, 1024, 1024, 20, 128, 8), (24, 300, 700, 10, 64, 4)]
# demo4d: the demo_4d preset's schedule on the smallest grid its window
# admits with more than one round, 16 cameras (12 targets) x 12 frames
D4D_CAMERAS, D4D_FRAMES, D4D_INPUTS = 16, 12, (1, 5, 9, 13)
# part (a) stops after round 1 (12 spatial tasks) and 5 temporal tasks, with
# a state every 4 tasks; at 200 MB of pose cache the 16-row spatial tasks
# (168 MB of pose features) materialise and the 24-row temporal tasks
# (252 MB) stream, as production's 48-row and 300-row tasks do at 640 MB
D4D_BUDGET, D4D_CKPT_EVERY, D4D_POSE_CACHE_MB = 17, 4, 200
# the demo4d phase runs the preset at stride 4 (3 windows a task, half the
# preset's window steps at the same shapes: the cut that pays for the units
# phase); its pipeline streams a temporal task in chunks of one window (3
# chunks a task), as production's 300-row tasks run in chunks of 5; every
# window of a 24-row task holds all 24 rows, so the equality check adds
# windows of 4 + 4 rows in chunks of 2, whose chunk unions differ (10, 10
# and 12 rows: pad_u 12, 4 pad rows), which the pipeline renumbers and pads
D4D_STRIDE = 4
D4D_WINDOWS = 3  # windows per task in both domains (12 targets, stride 4)
D4D_WINDOW_CHUNK, D4D_PAD_CHUNK = 1, 2
D4D_PADDED_WINDOWS = [(k, 4) for k in (0, 1, 2, 3, 4, 6)]  # (first frame, frames)
# variants: SD2.1's noise schedule in a diffusers scheduler config (the class
# name is set per run); (a) runs demo_4d's preset on the demo4d grid cut to
# two rounds (spatial, temporal) at stride 4 (3 windows a task, each of
# production's shape), stopped after the first temporal task
SD21_SCHEDULER = {"num_train_timesteps": 1000, "beta_start": 0.00085, "beta_end": 0.012,
                  "beta_schedule": "scaled_linear", "prediction_type": "epsilon",
                  "timestep_spacing": "leading", "steps_offset": 1, "set_alpha_to_one": False}
VAR_ROUNDS, VAR_STRIDE, VAR_BUDGET = 2, 4, D4D_FRAMES + 1
# the overlap phase: tasks of demo_4d's last round (spatial, every target
# row decoded) per run, through the saver thread and through the serial path
OVERLAP_TASKS = 4
# demo4d_prod: production temporal tasks in one session, so that the IO and
# saver threads overlap a denoise as in a long run
PROD_TEMPORAL_TASKS = 2
# (B, S, H) at head dim 64 of a temporal window: L = 24 rows (12 frames of
# the condition camera and of the target), CFG split into two calls of
# batch L: 3D attention over all 24 frames, per-frame attention at each level
TEMPORAL_ATTN64_SHAPES = [
    (1, 24 * 4096, 10), (24, 16384, 5), (24, 4096, 10), (1, 24 * 1024, 20), (24, 1024, 20),
    (1, 24 * 256, 20), (24, 256, 20),
]
# waves: demo_4d's preset (window 12, stride 2, DDIM, CFG 2.0) on the demo4d
# scene cut to 2 frames and one spatial round: two tasks of 16 rows, 6
# windows each; and one no-CFG window step of 16 frames at 128^2 latents
WAVES_FRAMES, WAVES_CP_FRAMES = 2, 16
# context parallelism's attention shapes at head dim 64 (B, Sq, Sk, H): each
# rank of a model axis of n attends Sq = Sk * groups / n queries against the
# gathered Sk keys of its CFG group; the bench's windows with fused CFG
# (groups 2), spatial L = 16 at model 4 (three 3D levels) and 8, temporal
# L = 24 at model 4 (model 2 gives Sq = Sk, the shapes checked already)
CP_ATTN64_SHAPES = [
    (1, 32768, 65536, 10), (1, 8192, 16384, 20), (1, 2048, 4096, 20),  # spatial, model 4
    (1, 16384, 65536, 10),  # spatial, model 8
    (1, 49152, 98304, 10), (1, 12288, 24576, 20), (1, 3072, 6144, 20),  # temporal, model 4
]
# hot shapes of the tuner timed by the tune phase: the per-frame 16^2, 32^2
# and 64^2 attention, the 3D 16^2 mid block and, where the two-level kernel
# was meant to win, the 3D 32^2 and 64^2 levels
TUNE_SHAPES = "2d@16sq_mid,2d@32sq,2d@64sq,3d@16sq_mid,3d_spatial@32sq,3d_spatial@64sq"
# the port's attention kernels (flash_attention.KERNELS) by their names in
# the results and the kernels line
ATTN_NAMES = {"flash_d64": "flash_fwd_d64", "flash_d512": "flash_fwd_d512",
              "single_pass": "flash_fwd_single_pass",
              "single_pass_batched": "flash_fwd_single_pass_batched",
              "two_level": "flash_fwd_two_level"}
# (B, H, W, Cin, Cout): the VAE stages at 1024^2 images, and two resnets
# that change the channel count
CONV_SHAPES = [
    (2, 1024, 1024, 128, 128),
    (2, 512, 512, 256, 256),
    (2, 256, 256, 512, 512),
    (2, 128, 128, 512, 512),
    (2, 1024, 1024, 256, 128),
    (2, 512, 512, 512, 256),
]
# (B, H, W, C, groups) of the GroupNorm pair: the UNet's levels at a CFG
# window (batch 32 at 128^2 latents: 320, 640 and 1,280 channels), a temporal
# step's up-block concatenation (batch 24, 960 channels) and the VAE decoder's
# last stage at 1024^2
GN_SHAPES = [(32, 128, 128, 320, 32), (32, 64, 64, 640, 32), (32, 32, 32, 1280, 32),
             (24, 128, 128, 960, 32), (2, 1024, 1024, 128, 32)]
# (B, S, H) at head dim 64 of the train step (B = 1 window of L = 12 frames
# over 128^2 latents): per-frame and 3D attention at each level
TRAIN_ATTN_SHAPES = [
    (1, 49152, 10),  # 3D, 64^2 (the heaviest single call)
    (12, 16384, 5),  # per-frame, 128^2
    (12, 4096, 10),  # per-frame, 64^2
    (1, 12288, 20),  # 3D, 32^2
    (12, 1024, 20),  # per-frame, 32^2
    (1, 3072, 20),  # 3D, 16^2 mid block
    (12, 256, 20),  # per-frame, 16^2 mid block
]
TRAIN_L = 12  # frames of the train window: 4 condition rows + 8 targets
TRAIN_STEPS = 3
# the bench's kernels by the TPU kernel each replaces: each must launch in
# its full tier (B10: the table routes no path shape to it)
BENCH_KERNELS = ("B1", "B2", "B8", "B9", "B3", "B4")
BENCH_TIMEOUT_S = 900
# the bench's scene (python -m diffuman4d_torch.bench makes 48 cameras at
# 1024^2 under BENCH_SCENE_DIR, label "scene"), which the cli phase reuses
BENCH_SCENE = "scene"
# train_run: a session of 12 steps with a checkpoint every 6, then a
# resumed session to 18 (window 6 at 512^2, Adafactor, host EMA)
TRAIN_RUN_STEPS, TRAIN_RUN_RESUMED, TRAIN_RUN_EVERY = 12, 18, 6
# attention calls of one UNet forward: 3 levels x (2 down + 3 up) + 1 mid
# transformer blocks, each with one 3D / per-frame pair
ATTN_CALLS_PER_FORWARD = 32
# the card's published peaks (NVIDIA H100 SXM data sheet): dense bf16 tensor
# cores and HBM3 bandwidth; a kernel's bound is the larger of its FLOPs over
# the one and its bytes (inputs read once, outputs written once) over the other
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# (affine, silu, residual) of the epilogue variants
CONV_VARIANTS = {"plain": (False, False, False), "affine_silu": (True, True, False),
                 "affine_silu_res": (True, True, True)}

# Attention inputs: batch 0 has randn q and k (logits ~ N(0, 1): a nearly
# uniform softmax over all S keys, outputs of order sqrt(e / S)); the other
# batch rows scale q by ATTN_PEAK (logits ~ N(0, 9): a few keys carry each
# row, outputs of order 1). Each batch row's max abs error is bounded by
# ATTN_REL_TOL times its largest reference output: 4 bf16 ulps of it. The
# kernel rounds the unnormalised P to bf16 where the plain version rounds
# the normalised one, and sums in another order. Dropping one 64-key tile
# in 64 gives 0.28 / 0.52 on this measure.
ATTN_PEAK = 3.0
ATTN_REL_TOL = 2 ** -5
# bf16 outputs; fp32 accumulation in another order, and the prologue's
# fp32 affine may round an activation to the neighbouring bf16 value
CONV_REL_TOL = 2 ** -6
# the GroupNorm pair vs its plain version, bf16: the plain version rounds
# the affine's output to bf16 and SiLU's again, the kernel once, after SiLU;
# statistics in another order (fp32 partials, double totals). Within 4 bf16
# ulps of max(1, |reference|) elementwise; a wrong group or channel gives O(1).
GN_REL_TOL = 2 ** -5
# relative L2 error of a bf16 network run through the kernels vs through
# the plain versions (a wrong kernel gives O(1))
E2E_REL_TOL = 5e-2
# the backward kernels vs their plain versions (the same roundings of Qs, P
# and dS on both sides, fp32 sums in another order): 4 bf16 ulps of the
# largest gradient entry of each (batch row, head); the second half of the
# heads has peaked logits. L2 is fp32: sums in another order only.
BWD_REL_TOL = 2 ** -5
L2_ABS_TOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, iters: int = 3, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: FLOPs at the bf16 peak or bytes
    at the HBM rate, whichever is larger."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes
            else "bytes"}


def try_ms(fn, **kw):
    """Time a library yardstick; None where the library cannot run it."""
    import torch

    try:
        return cuda_ms(fn, **kw)
    except RuntimeError as e:  # out of memory included
        log(f"    library call not timed: {type(e).__name__}: {str(e)[:100]}")
        torch.cuda.empty_cache()
        return None


# ------------------------------------------------------------------ phases
def phase_build() -> dict:
    from diffuman4d_torch.ops import cuda_build

    t0 = time.perf_counter()
    paths = cuda_build.build()
    secs = time.perf_counter() - t0
    for name in paths:  # ptxas: each instance's registers, spills and warnings
        for line in cuda_build.build_logs.get(name, "").splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill", "warning")):
                log(f"  ptxas {name}: {line.strip()}")
    log(f"build: {len(paths)} libraries in {secs:.1f} s")
    return {"build_s": secs}


def _query_chunk(B: int, S: int, H: int, budget_bytes: float = 12e9) -> int:
    """Query rows per plain-attention chunk: ~16 bytes per score element
    (fp32 scores, probabilities, casts) within ``budget_bytes``."""
    c = int(budget_bytes // (16 * B * H * S))
    return max(16, min(S, 1 << max(4, int(math.log2(max(c, 1))))))


def check_attention(B: int, S: int, Sk: int, H: int, D: int, gen, kernel: str | None = None,
                    blocks: tuple = (), cache: dict | None = None) -> dict:
    """Attention kernel ``kernel`` (a key of ``flash_attention.KERNELS``;
    default: the one of head dim D) at block sizes ``blocks`` against the
    plain version, with both times, the library's and the bound. ``cache``
    keeps the plain and library times per shape for the next block sizes."""
    import torch

    from diffuman4d_torch.ops import flash_attention as fa

    kernel = kernel or f"flash_d{D}"
    kw = dict(zip(fa.BLOCK_PARAMS[kernel], blocks))
    wrapper = fa.KERNELS[kernel]

    def fn(q, k, v):
        return wrapper(q, k, v, **kw)

    q = torch.randn((B, S, H, D), generator=gen, device="cuda")
    q[1:] *= ATTN_PEAK
    q = q.bfloat16()
    k, v = (torch.randn((B, Sk, H, D), generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    out = fn(q, k, v)
    c = _query_chunk(B, Sk, H)
    rows = torch.randperm(S, generator=gen, device="cuda")[:c].sort().values
    ref = fa.attention_plain(q[:, rows], k, v).float()
    diff = (out[:, rows].float() - ref).abs().amax(dim=(1, 2, 3))
    rel = (diff / ref.abs().amax(dim=(1, 2, 3))).max().item()
    err = diff.max().item()
    ms = cuda_ms(lambda: fn(q, k, v), iters=3 if S >= 16384 else 10)

    def plain_chunked():
        for i in range(0, S, c):
            fa.attention_plain(q[:, i : i + c], k, v)

    cache = {} if cache is None else cache
    if (B, S, Sk, H, D) not in cache:
        plain_ms = cuda_ms(plain_chunked, iters=1, warmup=0 if S >= 16384 else 1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # (B, H, S, D) views
        library_ms = try_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt),
                            iters=3 if S >= 16384 else 10)
        cache[(B, S, Sk, H, D)] = plain_ms, library_ms
    plain_ms, library_ms = cache[(B, S, Sk, H, D)]
    flop = 4.0 * B * H * S * Sk * D
    shape = (f"B{B}xS{S}xH{H}xD{D}" + (f"xSk{Sk}" if Sk != S else "")
             + "".join(f":{n}{b}" for n, b in kw.items()))
    res = {"shape": shape, "flop": flop, "max_abs_err": err, "rel_err": rel, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "tflops": flop / ms / 1e9,
           "checked_rows": int(rows.numel()),
           **bound(flop, 2.0 * (2 * q.numel() + 2 * k.numel()))}
    log(f"  {kernel} {shape}: err {err:.3e} (rel {rel:.3e}, tol {ATTN_REL_TOL:.3e})  "
        f"kernel {ms:.3f} ms ({res['tflops']:.1f} TFLOP/s)  plain {plain_ms:.3f} ms  "
        f"library {library_ms} ms  bound {res['bound_ms']:.3f} ms  rows {rows.numel()}")
    if not rel <= ATTN_REL_TOL:
        raise AssertionError(f"{kernel} {shape}: error {rel} of the largest output "
                             f"> {ATTN_REL_TOL}")
    return res


def check_conv(B: int, H: int, W: int, cin: int, cout: int, affine: bool, silu: bool,
               residual: bool, gen) -> dict:
    import torch

    from diffuman4d_torch.ops import conv

    variant = next((n for n, f in CONV_VARIANTS.items() if f == (affine, silu, residual)),
                   f"affine{int(affine)}_silu{int(silu)}_res{int(residual)}")
    x = torch.randn((B, H, W, cin), generator=gen, device="cuda").bfloat16()
    w = torch.randn((cout, cin, 3, 3), generator=gen, device="cuda") / math.sqrt(9 * cin)
    bias = 0.1 * torch.randn((cout,), generator=gen, device="cuda")
    kw = {"silu": silu}
    if affine:
        kw.update(scale=1 + 0.2 * torch.randn((B, cin), generator=gen, device="cuda"),
                  shift=0.2 * torch.randn((B, cin), generator=gen, device="cuda"))
    if residual:
        kw["residual"] = torch.randn((B, H, W, cout), generator=gen, device="cuda").bfloat16()
    out = conv.conv3x3(x, w, bias, **kw)
    ref = conv.conv3x3_plain(x, w, bias, **kw)
    err = (out.float() - ref.float()).abs().max().item()
    tol = CONV_REL_TOL * max(1.0, ref.float().abs().max().item())
    ms = cuda_ms(lambda: conv.conv3x3(x, w, bias, **kw))
    plain_ms = cuda_ms(lambda: conv.conv3x3_plain(x, w, bias, **kw))
    wl = w.bfloat16().contiguous(memory_format=torch.channels_last)
    bl = bias.bfloat16()

    def library():
        """Eager GroupNorm-affine + SiLU, one bf16 channels-last conv2d, residual add."""
        h = x
        if affine:
            h = h.float() * kw["scale"][:, None, None, :] + kw["shift"][:, None, None, :]
        if silu:
            h = torch.nn.functional.silu(h.float())
        y = torch.nn.functional.conv2d(h.bfloat16().permute(0, 3, 1, 2), wl, bl, padding=1)
        y = y.permute(0, 2, 3, 1)
        return y + kw["residual"] if residual else y

    library_ms = try_ms(library)
    flop = 2.0 * B * H * W * cout * 9 * cin
    nbytes = 2.0 * (x.numel() + w.numel() + B * H * W * cout * (2 if residual else 1))
    res = {"shape": f"B{B}x{H}x{W}x{cin}->{cout}:{variant}", "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "tflops": flop / ms / 1e9,
           **bound(flop, nbytes)}
    log(f"  conv3x3 {res['shape']}: err {err:.3e} (tol {tol:.3e})  kernel {ms:.3f} ms "
        f"({res['tflops']:.1f} TFLOP/s)  plain {plain_ms:.3f} ms  library {library_ms} ms  "
        f"bound {res['bound_ms']:.3f} ms ({res['bound_by']})")
    if not err <= tol:
        raise AssertionError(f"conv3x3 {res['shape']}: max abs err {err} > {tol}")
    return res


def check_groupnorm(B: int, H: int, W: int, C: int, groups: int, gen) -> dict:
    """The GroupNorm + SiLU pair against its plain version at one shape, with
    ``F.group_norm`` + ``F.silu`` (channels-last) as the library yardstick."""
    import torch
    import torch.nn.functional as F

    from diffuman4d_torch.ops import groupnorm as gn

    # images, groups and channels far apart: a mean per (image, group) over
    # [-4, 4] plus each channel's own, a scale per (image, channel) over
    # [0.5, 4]; statistics of another group, image or the whole image are
    # off by several units where the tolerance is ~0.03
    m = 8 * torch.rand((B, groups, 1), generator=gen, device="cuda") - 4
    m = (m + 0.5 * torch.randn((B, groups, C // groups), generator=gen, device="cuda"))
    s = 0.5 * 8 ** torch.rand((B, 1, 1, C), generator=gen, device="cuda")
    x = torch.randn((B, H, W, C), generator=gen, device="cuda").mul_(s)
    x = x.add_(m.reshape(B, 1, 1, C)).bfloat16()
    w = (1 + 0.2 * torch.randn((C,), generator=gen, device="cuda")).bfloat16()
    b = (0.2 * torch.randn((C,), generator=gen, device="cuda")).bfloat16()
    out = gn.group_norm(x, w, b, groups, 1e-5, silu=True)
    ref = gn.group_norm_plain(x, w, b, groups, 1e-5, silu=True)
    diff = (out.float() - ref.float()).abs()
    over = (diff - GN_REL_TOL * ref.float().abs().clamp_min(1.0)).max().item()
    err = diff.max().item()
    del diff
    repeat = torch.equal(out, gn.group_norm(x, w, b, groups, 1e-5, silu=True))
    ms = cuda_ms(lambda: gn.group_norm(x, w, b, groups, 1e-5, silu=True), iters=10)
    plain_ms = cuda_ms(lambda: gn.group_norm_plain(x, w, b, groups, 1e-5, silu=True))
    xc = x.permute(0, 3, 1, 2)  # NCHW view, channels-last memory
    library_ms = try_ms(lambda: F.silu(F.group_norm(xc, groups, w, b, 1e-5)), iters=10)
    nbytes = 6.0 * x.numel()  # x read twice, y written once
    res = {"shape": f"B{B}x{H}x{W}x{C}:G{groups}", "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "repeatable": repeat,
           "gb_per_s": nbytes / ms / 1e6, **bound(0.0, nbytes)}
    log(f"  groupnorm {res['shape']}: err {err:.3e}  kernel {ms:.4f} ms "
        f"({res['gb_per_s']:.0f} GB/s, {res['bound_ms'] / ms:.1%} of the bound)  plain "
        f"{plain_ms:.3f} ms  library {library_ms} ms  bound {res['bound_ms']:.4f} ms")
    if not over <= 0:
        raise AssertionError(f"groupnorm {res['shape']}: error {err} beyond {GN_REL_TOL} "
                             f"of max(1, |reference|) (by {over})")
    if not repeat:
        raise AssertionError(f"groupnorm {res['shape']}: two launches gave other bits")
    return res


def _head_rel_err(got, want) -> float:
    """Largest error of each (batch row, head) over its largest reference
    entry; tensors are (B, S, H, D)."""
    got, want = got.float(), want.float()
    return ((got - want).abs().amax(dim=(1, 3)) / want.abs().amax(dim=(1, 3))).max().item()


def check_attention_train(B: int, S: int, Sk: int, H: int, gen) -> dict:
    """The forward with logsumexp (out, L2) and the fused backward (dQ, dK,
    dV) at head dim 64 against their plain versions, with times, bounds and
    the library's forward / backward, and the backward's bit-repeatability
    over two more launches. Returns one result per kernel."""
    import torch
    import torch.nn.functional as F

    from diffuman4d_torch.ops import flash_backward as fb

    D = 64
    q = torch.randn((B, S, H, D), generator=gen, device="cuda")
    q[:, :, H // 2:] *= ATTN_PEAK  # heads of the second half: peaked logits
    q = q.bfloat16()
    k, v = (torch.randn((B, Sk, H, D), generator=gen, device="cuda").bfloat16() for _ in range(2))
    dout = torch.randn((B, S, H, D), generator=gen, device="cuda").bfloat16()
    qs = fb.scale_q(q)
    c = _query_chunk(B, Sk, H, budget_bytes=8e9)
    rows = torch.randperm(S, generator=gen, device="cuda")[:c].sort().values

    out, l2 = fb.flash_fwd_lse(qs, k, v)
    out_ref, l2_ref = fb.flash_fwd_lse_plain(qs[:, rows], k, v)
    errs = {"flash_fwd_lse": ((out[:, rows].float() - out_ref.float()).abs().max().item(),
                              _head_rel_err(out[:, rows], out_ref))}
    l2_err = (l2[:, :, rows] - l2_ref).abs().max().item()
    del out_ref, l2_ref
    delta = fb.attention_delta(out, dout)
    sub = (qs[:, rows].contiguous(), k, v, dout[:, rows].contiguous(),
           l2[:, :, rows].contiguous(), delta[:, :, rows].contiguous())
    # a dQ row needs all keys but only its own query: the full launch's rows
    # against the plain version on the subset; dK and dV sum over every
    # query, so they come from a launch with the queries (and dO, L2,
    # delta) cut to the subset on both sides
    dq = fb.flash_bwd(qs, k, v, dout, l2, delta)[0][:, rows]
    dq_ref, dk_ref, dv_ref = fb.flash_bwd_plain(*sub)
    _, dk, dv = fb.flash_bwd(*sub)
    pairs = ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref))
    errs["flash_bwd"] = (max((a.float() - b.float()).abs().max().item() for a, b in pairs),
                         max(_head_rel_err(a, b) for a, b in pairs))
    finite = all(torch.isfinite(x).all().item() for x in (out, l2, dq, dk, dv))
    del dq, dk, dv, dq_ref, dk_ref, dv_ref, pairs, sub
    # the dQ partials are added in key-block order: two launches, same bits
    first = fb.flash_bwd(qs, k, v, dout, l2, delta)
    repeat = all(torch.equal(a, b) for a, b in zip(first, fb.flash_bwd(qs, k, v, dout, l2, delta)))
    del first

    big = S >= 12288
    it = dict(iters=3 if big else 10)
    ms = {"flash_fwd_lse": cuda_ms(lambda: fb.flash_fwd_lse(qs, k, v), **it),
          "flash_bwd": cuda_ms(lambda: fb.flash_bwd(qs, k, v, dout, l2, delta), **it)}

    def chunked(fn):
        def run():
            for i in range(0, S, c):
                r = slice(i, i + c)
                fn(qs[:, r], k, v, dout[:, r], l2[:, :, r], delta[:, :, r])
        return run

    pl = dict(iters=1, warmup=0 if big else 1)
    plain_ms = {
        "flash_fwd_lse": cuda_ms(chunked(lambda qs_, k_, v_, *_: fb.flash_fwd_lse_plain(qs_, k_, v_)),
                                 **pl),
        "flash_bwd": cuda_ms(chunked(fb.flash_bwd_plain), **pl)}
    # the library: one SDPA forward; its backward (dQ, dK and dV in one
    # autograd call) stands beside the fused backward
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    lib_fwd = try_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), **it)
    lib_bwd = None
    if lib_fwd is not None:
        o = F.scaled_dot_product_attention(qt, kt, vt)
        go = dout.transpose(1, 2)
        lib_bwd = try_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), go, retain_graph=True), **it)
        del o
    library_ms = {"flash_fwd_lse": lib_fwd, "flash_bwd": lib_bwd}

    unit = 2.0 * B * H * S * Sk * D  # one S x Sk x D matrix product
    qb, kb, vec = 2.0 * q.numel(), 2.0 * k.numel(), 4.0 * B * H * S
    # minimal work: fwd 2 products (S, PV); bwd 5 (S, dP, dV, dK, dQ), reading
    # qs, dO, k, v, L2, delta and writing dQ, dK, dV once
    bounds = {"flash_fwd_lse": bound(2 * unit, 2 * qb + 2 * kb + vec),
              "flash_bwd": bound(5 * unit, 3 * qb + 4 * kb + 2 * vec)}
    nprod = {"flash_fwd_lse": 2, "flash_bwd": 5}
    shape = f"B{B}xS{S}xH{H}xD{D}" + (f"xSk{Sk}" if Sk != S else "")
    results = {}
    for name in ms:
        err, rel = errs[name]
        results[name] = {"shape": shape, "max_abs_err": err, "rel_err": rel, "ms": ms[name],
                         "plain_ms": plain_ms[name], "library_ms": library_ms[name],
                         "tflops": nprod[name] * unit / ms[name] / 1e9,
                         "checked_rows": int(rows.numel()), **bounds[name]}
        log(f"  {name} {shape}: err {err:.3e} (rel {rel:.3e}, tol {BWD_REL_TOL:.3e})  kernel "
            f"{ms[name]:.3f} ms ({results[name]['tflops']:.1f} TFLOP/s)  plain "
            f"{plain_ms[name]:.3f} ms  library {library_ms[name]} ms  bound "
            f"{bounds[name]['bound_ms']:.3f} ms  rows {rows.numel()}")
    results["flash_fwd_lse"]["l2_abs_err"] = l2_err
    results["flash_bwd"]["repeat_bits"] = repeat
    log(f"    L2 max abs err {l2_err:.3e} (tol {L2_ABS_TOL:.0e}); backward bit-equal over two "
        f"launches: {repeat}")
    if not finite:
        raise AssertionError(f"attention train {shape}: non-finite output")
    if not repeat:
        raise AssertionError(f"flash_bwd {shape}: two launches gave different bits")
    for name, (_, rel) in errs.items():
        tol = ATTN_REL_TOL if name == "flash_fwd_lse" else BWD_REL_TOL
        if not rel <= tol:
            raise AssertionError(f"{name} {shape}: error {rel} of the largest entry > {tol}")
    if not l2_err <= L2_ABS_TOL:
        raise AssertionError(f"flash_fwd_lse {shape}: L2 error {l2_err} > {L2_ABS_TOL}")
    return results


def check_conv_grad(B: int, H: int, W: int, cin: int, cout: int, affine: bool, silu: bool,
                    residual: bool, gen) -> dict:
    """Gradients through the fused conv (kernel forward, library-convolution
    backward on bf16 operands) against autograd through the plain version."""
    import torch

    from diffuman4d_torch.ops import conv

    def leaf(t):
        return t.requires_grad_(True)

    x = leaf(torch.randn((B, H, W, cin), generator=gen, device="cuda").bfloat16())
    w = leaf(torch.randn((cout, cin, 3, 3), generator=gen, device="cuda") / math.sqrt(9 * cin))
    bias = leaf(0.1 * torch.randn((cout,), generator=gen, device="cuda"))
    kw = {"silu": silu}
    if affine:
        kw.update(scale=leaf(1 + 0.2 * torch.randn((B, cin), generator=gen, device="cuda")),
                  shift=leaf(0.2 * torch.randn((B, cin), generator=gen, device="cuda")))
    if residual:
        kw["residual"] = leaf(torch.randn((B, H, W, cout), generator=gen, device="cuda").bfloat16())
    g = torch.randn((B, H, W, cout), generator=gen, device="cuda").bfloat16()
    leaves = [x, w, bias] + [kw[n] for n in ("scale", "shift", "residual") if n in kw]
    before = conv.conv3x3.launches
    got = torch.autograd.grad(conv.conv3x3(x, w, bias, **kw), leaves, g)
    launched = conv.conv3x3.launches - before
    want = torch.autograd.grad(conv.conv3x3_plain(x, w, bias, **kw), leaves, g)
    rel = max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
              for a, b in zip(got, want))
    shape = f"B{B}x{H}x{W}x{cin}->{cout}:affine{int(affine)}_silu{int(silu)}_res{int(residual)}"
    log(f"  conv3x3 grad {shape}: worst relative error {rel:.3e} (tol {CONV_REL_TOL:.3e}), "
        f"kernel launches {launched}")
    if launched != 1:
        raise AssertionError(f"conv3x3 grad {shape}: the forward launched {launched} kernels")
    if not rel <= CONV_REL_TOL:
        raise AssertionError(f"conv3x3 grad {shape}: relative error {rel} > {CONV_REL_TOL}")
    return {"shape": shape, "rel_err": rel}


def _ordered(fixed: list, launched) -> list:
    """The fixed shapes in their order, then those launched but not fixed."""
    return fixed + sorted(set(launched) - set(fixed), key=lambda s: (s[:5], s))


def phase_kernels(launched: dict) -> dict:
    """Every kernel against its plain version at the fixed shapes and at
    each shape in ``launched`` (the wrappers' ``shapes`` records of the
    paths that ran, the bench's child process included)."""
    import torch

    torch.backends.cudnn.allow_tf32 = False  # the plain conv runs in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {name: [] for name in ATTN_NAMES.values()}
    results.update({"conv3x3": [], "flash_fwd_lse": [], "flash_bwd": [], "conv3x3_grad": []})
    cache: dict = {}  # plain and library times per attention shape
    fixed_attn = {
        # the d = 64 kernel at the blocks the table gives each shape
        "flash_d64": [(B, S, S, H, *_d64_blocks(B, S, H)) for B, S, H in ATTN64_SHAPES],
        "flash_d512": [(B, S, S, H) for B, S, H in ATTN512_SHAPES],
        "single_pass": SINGLE_PASS_SHAPES, "single_pass_batched": SINGLE_PASS_BATCHED_SHAPES}
    for kernel, name in ATTN_NAMES.items():
        D = 512 if kernel == "flash_d512" else 64
        fixed = fixed_attn.get(kernel, [])
        for B, S, Sk, H, *blocks in _ordered(fixed, map(tuple, launched.get(name, ()))):
            results[name].append(check_attention(B, S, Sk, H, D, gen, kernel, tuple(blocks),
                                                 cache))
            torch.cuda.empty_cache()
        if not fixed:  # B10: the heaviest launch first, fastest block sizes first
            results[name].sort(key=lambda r: (-r["flop"], r["ms"]))
    # context parallelism's Sq != Sk shapes, each on its routed kernel
    results["cp_shapes"] = phase_cp_shapes(gen, cache)
    for row in results["cp_shapes"]:
        for check in row.values():
            results[ATTN_NAMES[check["kernel"]]].append(check)
    fixed = [shape + flags for shape in CONV_SHAPES for flags in CONV_VARIANTS.values()]
    for shape in _ordered(fixed, launched.get("conv3x3", ())):
        results["conv3x3"].append(check_conv(*shape, gen))
        torch.cuda.empty_cache()
    results["groupnorm"] = []
    for shape in _ordered(GN_SHAPES, launched.get("groupnorm", ())):
        results["groupnorm"].append(check_groupnorm(*shape, gen))
        torch.cuda.empty_cache()
    # the train path: B5 and the fused B6 + B7 at its fixed shapes and at
    # every shape it launched
    train_launched = set().union(*(launched.get(n, ()) for n in ("flash_fwd_lse", "flash_bwd")))
    for B, S, Sk, H in _ordered([(B, S, S, H) for B, S, H in TRAIN_ATTN_SHAPES], train_launched):
        for name, res in check_attention_train(B, S, Sk, H, gen).items():
            results[name].append(res)
        torch.cuda.empty_cache()
    # the fused conv's gradient at the UNet's 128^2 x 640 upsampler (train batch 12)
    for flags in ((False, False, False), (True, True, True)):
        results["conv3x3_grad"].append(check_conv_grad(TRAIN_L, 128, 128, 640, 640, *flags, gen))
        torch.cuda.empty_cache()
    return results


def _d64_blocks(B: int, S: int, H: int) -> tuple:
    """The d = 64 kernel's blocks at (B, S, H): the table's where it routes
    the shape there, else the wrapper's default."""
    from diffuman4d_torch.ops import flash_attention as fa

    name, params = _routed(B, S, S, H, 64)
    return tuple(params.values()) if name == "flash_d64" else fa.SKEW_DEFAULT


@contextlib.contextmanager
def plain_versions():
    """Route the model's kernel call sites to the plain versions."""
    from diffuman4d_torch.models import layers, vae
    from diffuman4d_torch.ops import conv, flash_attention, flash_backward, groupnorm

    def attention(q, k, v, *, implementation="auto"):
        if implementation == "train":
            return flash_backward.flash_attention_train_plain(q, k, v)
        return flash_attention.attention_plain(q, k, v)

    saved = (layers.dot_product_attention, vae.dot_product_attention, layers.conv3x3,
             layers.group_norm, layers.groupnorm_affine)
    layers.dot_product_attention = vae.dot_product_attention = attention
    layers.conv3x3 = conv.conv3x3_plain
    layers.group_norm = groupnorm.group_norm_plain
    layers.groupnorm_affine = groupnorm.groupnorm_affine_plain
    try:
        yield
    finally:
        (layers.dot_product_attention, vae.dot_product_attention, layers.conv3x3,
         layers.group_norm, layers.groupnorm_affine) = saved


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-12)).item()


def phase_reference(unet, vae) -> dict:
    """Kernels vs plain versions through the full-width models at a small
    input: one CFG window of 4 frames at 32^2 latents (3D and per-frame
    attention at d=64) and a VAE decode of one 64^2 latent (d=512 mid
    attention, fused convs from 128^2 x 512 up to 512^2 x 128)."""
    import torch

    from diffuman4d_torch.ops import conv, flash_attention as fa, groupnorm

    gen = torch.Generator(device="cuda").manual_seed(1)
    L = 4
    x = torch.randn((2 * L, 32, 32, 11), generator=gen, device="cuda").bfloat16()
    pose = 0.1 * torch.randn((2 * L, 32, 32, 320), generator=gen, device="cuda").bfloat16()
    t = torch.full((2 * L,), 901, device="cuda")
    z = torch.randn((1, 64, 64, 4), generator=gen, device="cuda").bfloat16()
    def counts():  # d = 64 attention (whichever kernel the table picks), d = 512, conv,
        # the GroupNorm pair
        return (sum(f.launches for n, f in fa.KERNELS.items() if n != "flash_d512"),
                fa.flash_attention_d512.launches, conv.conv3x3.launches,
                groupnorm.groupnorm_stats.launches, groupnorm.groupnorm_apply.launches)

    before = counts()
    with torch.no_grad():
        eps = unet(x, t, num_frames=L, pose_features=pose)
        img = vae.decode(z)
        launched = tuple(a - b for a, b in zip(counts(), before))
        before = counts()
        with plain_versions():
            eps_ref = unet(x, t, num_frames=L, pose_features=pose)
            img_ref = vae.decode(z)
        if counts() != before:
            raise AssertionError("reference: a kernel launched inside the plain run")
    res = {"unet_rel_l2": _rel_l2(eps, eps_ref), "vae_rel_l2": _rel_l2(img, img_ref),
           "launches": launched}
    log(f"reference: UNet eps rel L2 {res['unet_rel_l2']:.3e}, VAE decode rel L2 "
        f"{res['vae_rel_l2']:.3e}, kernel launches {launched}")
    if not all(torch.isfinite(a).all() for a in (eps, img)):
        raise AssertionError("reference: non-finite output")
    if min(launched) == 0:
        raise AssertionError(f"reference: a kernel did not run {launched}")
    if not (res["unet_rel_l2"] <= E2E_REL_TOL and res["vae_rel_l2"] <= E2E_REL_TOL):
        raise AssertionError(f"reference: kernels disagree with the plain versions {res}")
    return res


def _train_batch(gen, L: int, lat: int, device="cuda") -> dict:
    """A random window batch (B = 1) in the layout of ``encode_training_batch``:
    the first third of the rows are condition rows."""
    import torch

    is_cond = torch.zeros((1, L), dtype=torch.bool, device=device)
    is_cond[:, : L // 3] = True

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device).bfloat16()

    return {"latents_x0": rnd(1, L, lat, lat, 4), "plucker": rnd(1, L, lat, lat, 6),
            "skeletons": rnd(1, L, lat * 8, lat * 8, 3).clamp(-1, 1), "is_cond": is_cond}


def phase_reference_train() -> dict:
    """One loss + backward of a UNet of full width per layer, one layer per
    block (0.50 B parameters), 4 frames at 32^2 latents: gradients through
    the train kernels vs through their plain versions on the card."""
    import torch

    from diffuman4d_torch.models.unet import UNetConfig
    from diffuman4d_torch.models.vae import VAEConfig
    from diffuman4d_torch.ops import flash_backward as fb
    from diffuman4d_torch.sampling.loader import build_models
    from diffuman4d_torch.schedulers.diffusion import Scheduler, SchedulerConfig
    from diffuman4d_torch.training.trainer import TrainConfig, diffusion_loss

    unet, _ = build_models(UNetConfig(layers_per_block=1),
                           VAEConfig(block_out_channels=(32, 32, 32, 32), layers_per_block=1),
                           device="cuda", dtype=torch.bfloat16, seed=3)
    gen = torch.Generator(device="cuda").manual_seed(4)
    batch = _train_batch(gen, 4, 32)
    t = torch.tensor([500], device="cuda")
    eps = torch.randn((1, 4, 32, 32, 4), generator=gen, device="cuda")
    sched, cfg = Scheduler(SchedulerConfig(), "cuda"), TrainConfig()
    wrappers = (fb.flash_fwd_lse, fb.flash_bwd)

    def grads():
        for p in unet.parameters():
            p.grad = None
        with unet.configured(attn_implementation="train"):
            loss = diffusion_loss(unet, sched, cfg, batch, "spatial", t=t, eps=eps)
            loss.backward()
        return loss.item(), torch.cat([p.grad.float().flatten() for p in unet.parameters()])

    before = [f.launches for f in wrappers]
    loss, g = grads()
    launched = [f.launches - b for f, b in zip(wrappers, before)]
    before = [f.launches for f in wrappers]
    with plain_versions():
        loss_ref, g_ref = grads()
    if [f.launches for f in wrappers] != before:
        raise AssertionError("reference: a kernel launched inside the plain train run")
    n_blocks = sum(1 for m in unet.modules() if type(m).__name__ == "MultiviewTransformerBlock")
    res = {"train_loss": loss, "train_loss_plain": loss_ref, "grad_rel_l2": _rel_l2(g, g_ref),
           "launches": launched, "transformer_blocks": n_blocks}
    log(f"reference (train): loss {loss:.6f} vs plain {loss_ref:.6f}, gradient rel L2 "
        f"{res['grad_rel_l2']:.3e}, launches fwd/bwd {launched} over {n_blocks} blocks")
    # remat: two forwards per attention, one backward
    if launched != [4 * n_blocks, 2 * n_blocks]:
        raise AssertionError(f"reference: train kernel launches {launched}")
    if not (math.isfinite(loss) and torch.isfinite(g).all()):
        raise AssertionError("reference: non-finite train loss or gradient")
    if not (abs(loss - loss_ref) <= E2E_REL_TOL * abs(loss_ref)
            and res["grad_rel_l2"] <= E2E_REL_TOL):
        raise AssertionError(f"reference: train kernels disagree with the plain versions {res}")
    return res


PROFILE_GROUPS = (  # kernel-name pattern -> group, first match wins
    ("flash_bwd_fused_kernel|dq_convert_kernel", "flash attention backward, fused (csrc)"),
    ("flash_fwd_wgmma_kernel", "flash attention fwd, TMA + wgmma (csrc)"),
    ("flash_fwd_skew_kernel", "flash attention fwd, skewed scores (csrc)"),
    ("flash_fwd_d512_kernel", "flash attention d = 512, TMA + wgmma (csrc)"),
    ("single_pass_wgmma_kernel", "single-pass attention (csrc)"),
    ("conv3x3_wgmma_kernel", "fused conv3x3, TMA + wgmma (csrc)"),
    ("gn_stats_kernel|gn_finalize_kernel|gn_apply_kernel", "GroupNorm (+ SiLU) pair (csrc)"),
    ("fprop|conv|implicit|winograd", "cuDNN conv"),
    ("gemm|nvjet|xmma|cutlass|sm90", "GEMM"),
    ("norm|reduce|softmax", "norm / reduction"),
    ("", "elementwise / copy / other"),
)


def phase_profile(unet, vae, out_dir: Path) -> dict:
    """Device time by kernel group (torch.profiler) for one CFG window step
    of the slice (batch 32 at 128^2 latents, 16-frame 3D attention), one
    VAE decode micro-batch (2 latents of 128^2), a VAE encode of 2 images
    at 1024^2 and one full-width train step, plus each one's wall time
    around a synchronise: the device's idle share is 1 - busy / wall. Then
    ``probe_temporal_mem``'s programs at the production 48 x 150 shapes."""
    import re

    import torch

    from diffuman4d_torch.utils.tracing import trace_to

    out_dir.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((32, 128, 128, 11), generator=gen, device="cuda").bfloat16()
    pose = 0.1 * torch.randn((32, 128, 128, 320), generator=gen, device="cuda").bfloat16()
    t = torch.full((32,), 901, device="cuda")
    z = torch.randn((2, 128, 128, 4), generator=gen, device="cuda").bfloat16()
    from diffuman4d_torch.schedulers.diffusion import Scheduler, SchedulerConfig
    from diffuman4d_torch.training.trainer import TrainConfig, create_train_state, make_train_step

    def no_grad(fn):
        def run():
            with torch.no_grad():
                return fn()
        return run

    # one full-width train step (B = 1, L = 12, 128^2 latents, remat, AdamW);
    # it moves the weights, so it is profiled last
    tcfg = TrainConfig()
    batch = _train_batch(gen, TRAIN_L, 128)
    t_fix = torch.tensor([500], device="cuda")
    eps = torch.randn((1, TRAIN_L, 128, 128, 4), generator=gen, device="cuda")
    state = create_train_state(unet, tcfg)
    step = make_train_step(unet, Scheduler(SchedulerConfig(), "cuda"), tcfg)
    img = torch.rand((2, 1024, 1024, 3), generator=gen, device="cuda").bfloat16() * 2 - 1
    noise = torch.randn((2, 128, 128, 4), generator=gen, device="cuda")
    work = {"unet_window_step": no_grad(lambda: unet(x, t, num_frames=16, pose_features=pose)),
            "vae_decode_x2": no_grad(lambda: vae.decode(z)),
            "vae_encode_x2": no_grad(lambda: vae.encode(img, noise=noise)),
            "train_step": lambda: step(state, batch, t=t_fix, eps=eps)}
    res = {}
    for name, fn in work.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with trace_to(str(out_dir / f"trace_{name}")) as prof:
            fn()
            torch.cuda.synchronize()
        groups: dict[str, float] = {}
        kernels = []
        for evt in prof.key_averages():
            us = getattr(evt, "self_device_time_total", 0.0) or 0.0
            if us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            kernels.append((us, evt.count, evt.key))
            group = next(g for pat, g in PROFILE_GROUPS
                         if not pat or re.search(pat, evt.key, re.I))
            groups[group] = groups.get(group, 0.0) + us / 1e3
        busy_ms = sum(groups.values())
        kernels.sort(reverse=True)
        res[name] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                     "idle_share": 1 - busy_ms / wall_ms, "groups_ms": groups,
                     "top": [{"ms": us / 1e3, "calls": n, "kernel": k[:120]}
                             for us, n, k in kernels[:12]]}
        log(f"profile {name}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms")
        for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
            log(f"    {ms:9.2f} ms  {100 * ms / busy_ms:5.1f}%  {g}")
        (out_dir / f"profile_{name}.txt").write_text(prof.key_averages().table(
            sort_by="self_cuda_time_total", row_limit=40))
    del state, step
    torch.cuda.empty_cache()
    # probe_temporal_mem at the production 48 x 150 shapes: both domains
    # with CFG fused, then the temporal domain with CFG split (production's)
    import io

    from diffuman4d_torch import probe_temporal_mem

    res["probe_temporal_mem"] = []
    for argv in ([], ["--domains", "temporal", "--split", "temporal", "--skip-chunk-cond"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = probe_temporal_mem.main(argv)
        lines = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
        for line in lines:
            log(f"probe_temporal_mem {' '.join(argv)}: {json.dumps(line)}")
        res["probe_temporal_mem"].append({"argv": argv, "rc": rc, "lines": lines})
        torch.cuda.empty_cache()
        if rc != 0 or not any("peak_above_gb" in x for x in lines):
            raise AssertionError(f"profile: probe_temporal_mem {argv} exited {rc}: {lines}")
    return res


def _timed(obj, name: str, acc: dict) -> None:
    """Wrap ``obj.name`` so its wall time (device work included) adds up
    in ``acc[name]``."""
    import torch

    fn = getattr(obj, name)

    def wrapper(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0
        return out

    setattr(obj, name, wrapper)


def _reset(wrappers) -> None:
    """Zero the launch counts and the per-shape records."""
    from collections import Counter

    for fn in wrappers:
        fn.launches = 0
        fn.shapes = Counter()


def _path_wrappers() -> dict:
    """The kernel wrappers that the sampling paths launch, by their names in
    the results: the attention kernels, the fused conv and the GroupNorm
    pair (its statistics wrapper: one launch per GroupNorm)."""
    from diffuman4d_torch.ops import conv, groupnorm
    from diffuman4d_torch.ops import flash_attention as fa

    return {**{ATTN_NAMES[n]: f for n, f in fa.KERNELS.items()}, "conv3x3": conv.conv3x3,
            "groupnorm": groupnorm.groupnorm_stats}


def _kernel_counts(wrappers: dict) -> tuple[dict, dict]:
    """Launches per kernel (the d = 64 kernel's split by TPU kernel) and
    the launched shapes, from the wrappers' counters."""
    from diffuman4d_torch.ops import flash_attention as fa

    launches = {name: fn.launches for name, fn in wrappers.items()}
    launches.update(_d64_split(fa.flash_attention_d64.shapes))
    return launches, {name: sorted(fn.shapes) for name, fn in wrappers.items()}


def _scene(work: Path) -> str:
    """The synthetic 16-camera, one-frame scene at 1024^2 (made once)."""
    from diffuman4d_torch.data import make_synthetic_scene

    if not (work / "data" / "scene0").is_dir():
        make_synthetic_scene(str(work / "data"), "scene0", num_cams=16, num_frames=1,
                             image_size=1024)
    return str(work / "data")


def phase_train(unet, vae, work: Path) -> dict:
    """Three optimiser steps of the full-width UNet on one window batch of
    the synthetic scene, run twice from the same weights."""
    import numpy as np
    import torch

    from diffuman4d_torch.data import SpaTemDataset
    from diffuman4d_torch.ops import conv, flash_attention as fa, flash_backward as fb
    from diffuman4d_torch.sampling.pipeline import Diffuman4DPipeline
    from diffuman4d_torch.schedulers.diffusion import Scheduler, SchedulerConfig
    from diffuman4d_torch.training.data import (
        WindowBatcher,
        WindowBatcherConfig,
        encode_training_batch,
    )
    from diffuman4d_torch.training.trainer import (
        TrainConfig,
        create_train_state,
        make_train_step,
        sync_module,
    )

    t0 = time.perf_counter()
    dataset = SpaTemDataset(data_dir=_scene(work), scene_label="scene0", height=1024, width=1024)
    pipe = Diffuman4DPipeline(unet, vae, Scheduler(SchedulerConfig()), image_size=1024,
                              vae_batch=4, device="cuda")
    batcher = WindowBatcher(dataset, WindowBatcherConfig(
        window_size=TRAIN_L - 4, tem_labels=["000000"],
        input_spa_labels=["01", "05", "09", "13"]))
    raw = batcher.make_batch(np.random.default_rng(0), 1, "spatial")
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in unet.parameters())
    start = {k: p.detach().clone() for k, p in unet.named_parameters()}
    tcfg = TrainConfig()  # the defaults: lr 1e-5, remat, AdamW, attention "train"
    step = make_train_step(unet, pipe.scheduler, tcfg, "spatial")

    wrappers = {"flash_fwd_lse": fb.flash_fwd_lse, "flash_bwd": fb.flash_bwd,
                "conv3x3": conv.conv3x3,
                **{ATTN_NAMES[n]: f for n, f in fa.KERNELS.items()}}
    runs = []
    for run in range(2):
        sync_module(unet, start)
        state = create_train_state(unet, tcfg)
        gen = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.reset_peak_memory_stats()
        _reset(wrappers.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = encode_training_batch(pipe, raw, gen)
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t0
        encode_launches = {n: f.launches for n, f in wrappers.items()}
        # the fixed noise draw: one timestep and one eps for all three steps
        t_fix = torch.randint(0, 1000, (1,), generator=gen, device="cuda")
        eps = torch.randn(batch["latents_x0"].shape, generator=gen, device="cuda")
        losses, norms, step_s, off_graph = [], [], [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, batch, t=t_fix, eps=eps)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
            off_graph = m["params_without_grad"]
        launches = {n: f.launches for n, f in wrappers.items()}
        shapes = {n: sorted(f.shapes) for n, f in wrappers.items()}
        runs.append({"losses": losses, "grad_norms": norms, "step_s": step_s,
                     "encode_s": encode_s, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "launches": launches, "encode_launches": encode_launches,
                     "params_without_grad": off_graph, "t": int(t_fix.item())})
        del state
        torch.cuda.empty_cache()
    sync_module(unet, start)
    first = runs[0]
    res = {"setup_s": setup_s, "n_params": n_params, "rows": list(raw["pixel_values"].shape),
           "latents": list(batch["latents_x0"].shape), "runs": runs, "shapes": shapes,
           "launches": first["launches"],
           "repeat_bits": [a == b for a, b in zip(first["losses"], runs[1]["losses"])]}
    log(f"train: {json.dumps(res)}")
    steps = {n: first["launches"][n] - first["encode_launches"][n] for n in wrappers}
    expect = {"flash_fwd_lse": 2 * ATTN_CALLS_PER_FORWARD * TRAIN_STEPS,
              "flash_bwd": ATTN_CALLS_PER_FORWARD * TRAIN_STEPS,
              "conv3x3": 2 * TRAIN_STEPS,  # the 128^2 x 640 upsampler, forward and recompute
              **{name: 0 for name in ATTN_NAMES.values()}}
    if list(batch["latents_x0"].shape) != [1, TRAIN_L, 128, 128, 4] or n_params < 0.8e9:
        raise AssertionError(f"train: not the full-width step: {res['latents']}, {n_params}")
    if steps != expect:
        raise AssertionError(f"train: launches in the steps {steps}, reckoned {expect}")
    if first["encode_launches"]["flash_fwd_d512"] == 0 or first["encode_launches"]["conv3x3"] == 0:
        raise AssertionError(f"train: the VAE encode launched {first['encode_launches']}")
    for r in runs:
        if not all(math.isfinite(v) for v in r["losses"] + r["grad_norms"]):
            raise AssertionError(f"train: non-finite loss or gradient norm {r}")
        if not r["losses"][-1] < r["losses"][0]:
            raise AssertionError(f"train: the loss did not fall: {r['losses']}")
        if r["params_without_grad"]:
            raise AssertionError(f"train: parameters without a gradient: "
                                 f"{r['params_without_grad'][:8]}")
    if not all(res["repeat_bits"]):
        raise AssertionError(f"train: the losses do not repeat bit for bit: {first['losses']} "
                             f"vs {runs[1]['losses']}")

    # the Adafactor step through the port's train_step_chip entry point
    from diffuman4d_torch import train_step_chip

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ada = train_step_chip.main(["--optimizer", "adafactor", "--steps", str(TRAIN_STEPS),
                                "--out", str(work / "train_step_torch.json")])
    res["adafactor"] = {**ada, "wall_s": time.perf_counter() - t0}
    log(f"train: adafactor {ada.get('value')} s a step ({ada.get('all_steps_s')}), peak "
        f"{ada.get('hbm_peak_gb')} GiB (AdamW above: "
        f"{max(r['peak_gb'] for r in runs) / 1.073741824:.2f} GiB), "
        f"{ada.get('tflop_per_step')} TFLOP a step, MFU {ada.get('mfu_vs_989tf_bf16')}")
    if ada.get("oom") or not ada.get("value") or not math.isfinite(ada.get("loss", math.nan)):
        raise AssertionError(f"train: the Adafactor step failed: {ada}")
    return res


def _module_run(args: list, env: dict | None = None, timeout: float = 900) -> tuple:
    """``python -m`` in a child process from the checkout's root: (return
    code, stdout, stderr)."""
    e = {**os.environ, "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""),
         **(env or {})}
    proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=e, capture_output=True,
                          text=True, timeout=timeout)
    return proc.returncode, proc.stdout, proc.stderr


def phase_bench(work: Path, smi: str) -> dict:
    """``python -m diffuman4d_torch.bench`` as a user runs it: both tiers'
    lines, every value positive, every kernel of the full tier launched."""
    t0 = time.perf_counter()
    rc, out, err = _module_run(["diffuman4d_torch.bench"], timeout=BENCH_TIMEOUT_S + 60,
                               env={"BENCH_SCENE_DIR": str(work / "bench"),
                                    "BENCH_TIMEOUT_S": str(BENCH_TIMEOUT_S)})
    wall_s = time.perf_counter() - t0
    (work / "bench_stderr.log").write_text(err)
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    for x in err.splitlines():
        if x.startswith("[bench]"):
            log(f"  {x}")
    res = {"rc": rc, "wall_s": wall_s, "card": smi, "lines": lines}
    log(f"bench ({smi}): rc {rc}, {wall_s:.1f} s, {json.dumps(lines)}")
    if rc != 0:
        raise AssertionError(f"bench: exit code {rc}: {err[-2000:]}")
    if [x["metric"] for x in lines] != ["smoke_window_step_sec", "cam_frames_per_sec_per_chip"]:
        raise AssertionError(f"bench: lines {lines}")
    full = lines[1]
    for x in lines:
        if not (isinstance(x["value"], float) and x["value"] > 0 and x["vs_baseline"] > 0):
            raise AssertionError(f"bench: {x['metric']} = {x['value']}")
    if not (full["warm"] > 0 and full["cold"] == full["value"]):
        raise AssertionError(f"bench: warm {full['warm']}, cold {full['cold']}")
    missing = [k for k in BENCH_KERNELS if not full["launches"].get(k)]
    if missing:
        raise AssertionError(f"bench: {missing} never launched in the full tier: "
                             f"{full['launches']}")
    # the shapes each wrapper launched in either tier (the child's records),
    # by the names of the kernels phase, which holds each against its plain
    # version
    tiers = json.loads((work / "bench" / "shapes.json").read_text())
    res["shapes"] = {ATTN_NAMES.get(name, name): sorted({tuple(key[:-1]) for t in tiers.values()
                                                         for key in t[name]})
                     for name in tiers["full"]}
    log(f"  bench: launched shapes {json.dumps(res['shapes'])}")
    return res


def phase_train_run(work: Path, smi: str) -> dict:
    """``python -m diffuman4d_torch.train_run_chip``: a session, a second
    process that resumes from its newest state and runs on, then
    ``--report``."""
    out, scene = work / "train_run", work / "train_scene"
    common = ["diffuman4d_torch.train_run_chip", "--out", str(out), "--scene", str(scene),
              "--checkpoint-every", str(TRAIN_RUN_EVERY)]
    sessions = []
    for steps in (TRAIN_RUN_STEPS, TRAIN_RUN_RESUMED):
        t0 = time.perf_counter()
        rc, stdout, err = _module_run(common + ["--steps", str(steps)])
        (work / f"train_run_{steps}.log").write_text(stdout + err)
        rep = next((json.loads(x.split(" ", 1)[1]) for x in stdout.splitlines()
                    if x.startswith("[train_run] {")), None)
        resumed = [x for x in err.splitlines() if "resumed train state" in x]
        sessions.append({"rc": rc, "wall_s": time.perf_counter() - t0, "report": rep,
                         "resumed": resumed})
        log(f"train_run ({smi}): --steps {steps}: rc {rc}, "
            f"{sessions[-1]['wall_s']:.1f} s, {json.dumps(rep)}")
        if rc != 0 or rep is None:
            raise AssertionError(f"train_run: --steps {steps} exited {rc}: {err[-2000:]}")
    rc, stdout, err = _module_run(["diffuman4d_torch.train_run_chip", "--report", "--out",
                                   str(out)])
    report = json.loads(stdout.strip().splitlines()[-1])
    ckpt_gb = sum(f.stat().st_size for f in out.iterdir()) / 1e9
    shutil.rmtree(out)  # fp32 states with the EMA shadow: ~7 GB each
    res = {"sessions": sessions, "report": report, "ckpt_gb": ckpt_gb, "card": smi}
    log(f"train_run: report {json.dumps(report)}, {ckpt_gb:.1f} GB of checkpoints")
    first, second = (x["report"] for x in sessions)
    states = [f"state_{n:07d}.pt" for n in range(TRAIN_RUN_EVERY, TRAIN_RUN_RESUMED + 1,
                                                   TRAIN_RUN_EVERY)]
    if sessions[0]["resumed"] or not sessions[1]["resumed"] or \
            f"at step {TRAIN_RUN_STEPS} " not in sessions[1]["resumed"][0]:
        raise AssertionError(f"train_run: resume lines {[x['resumed'] for x in sessions]}")
    if first["state_checkpoints"] != states[:2] or second["state_checkpoints"] != states:
        raise AssertionError(f"train_run: checkpoints {first['state_checkpoints']} then "
                             f"{second['state_checkpoints']}")
    # log_every 3: steps 1, 4, 7, 10 in the first session, then 13 and 16
    if (first["last_step"], second["first_step"], second["last_step"]) != (10, 1, 16):
        raise AssertionError(f"train_run: logged steps {first} then {second}")
    if rc != 0 or {k: v for k, v in second.items() if k in report} != report:
        raise AssertionError(f"train_run: --report exited {rc}: {report}")
    losses = report["loss_series_every10"] + [report["loss_first5th_mean"],
                                              report["loss_last5th_mean"]]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train_run: non-finite loss {report}")
    return res


def phase_tune(work: Path) -> dict:
    """The tuner's entry point on TUNE_SHAPES into ``work``; its winners
    beside the committed table's."""
    from diffuman4d_torch import tune_attention
    from diffuman4d_torch.ops import attention as attn, flash_attention as fa

    work.mkdir(parents=True, exist_ok=True)
    out = work / "attention_table.json"
    _reset(fa.KERNELS.values())
    t0 = time.perf_counter()
    rc = tune_attention.main(["--shapes", TUNE_SHAPES, "--out", str(out)])
    secs = time.perf_counter() - t0
    launches = {ATTN_NAMES[n]: f.launches for n, f in fa.KERNELS.items()}
    launches.update(_d64_split(fa.flash_attention_d64.shapes))
    shapes = {ATTN_NAMES[n]: sorted(f.shapes) for n, f in fa.KERNELS.items()}
    table = json.loads(out.read_text())
    committed = {e["name"]: e for e in attn._dispatch_table()}
    winners = {}
    for e in table["entries"]:
        c = committed.get(e["name"], {})
        mine = (e["impl"], e["block_q"], e.get("block_k_major"), e["block_k"], e.get("block_b"))
        theirs = (c.get("impl"), c.get("block_q"), c.get("block_k_major"), c.get("block_k"),
                  c.get("block_b"))
        winners[e["name"]] = {"this_run": mine, "tflops": e["tflops"], "committed": theirs,
                              "committed_tflops": c.get("tflops"), "agree": mine == theirs}
        log(f"  winner {e['name']}: this run {mine} {e['tflops']} TFLOP/s, committed {theirs} "
            f"{c.get('tflops')} TFLOP/s" + ("" if mine == theirs else "  (differs)"))
    res = {"tune_s": secs, "device": table.get("device"), "power_limit": table.get("power_limit"),
           "launches": launches, "shapes": shapes, "winners": winners}
    log(f"tune: {secs:.1f} s, launches {launches}")
    if rc != 0:
        raise AssertionError(f"tune: the tuner exited {rc}")
    failed = {e["name"]: e["candidates_failed"] for e in table["entries"]
              if e["candidates_failed"]}
    if failed or len(table["entries"]) != len(TUNE_SHAPES.split(",")):
        raise AssertionError(f"tune: failed candidates {failed}, {len(table['entries'])} entries")
    for name in ("flash_fwd_d64", "flash_fwd_single_pass", "flash_fwd_single_pass_batched",
                 "flash_fwd_two_level"):
        if not launches[name]:
            raise AssertionError(f"tune: {name} never launched: {launches}")
    return res


def phase_slice(unet, vae, work: Path) -> dict:
    import numpy as np
    import torch

    from diffuman4d_torch.data import SpaTemDataset
    from diffuman4d_torch.ops import flash_attention as fa
    from diffuman4d_torch.sampling.pipeline import Diffuman4DPipeline, SlidingConfig
    from diffuman4d_torch.sampling.sampler import SlidingIterativeSampler
    from diffuman4d_torch.schedulers.diffusion import Scheduler, SchedulerConfig

    shutil.rmtree(work / "out", ignore_errors=True)
    t0 = time.perf_counter()
    dataset = SpaTemDataset(data_dir=_scene(work), scene_label="scene0",
                            height=1024, width=1024)
    sliding = SlidingConfig(window_size=12, sliding_stride=1, alternation_rounds=1,
                            guidance_scale=2.0)
    pipe = Diffuman4DPipeline(unet, vae, Scheduler(SchedulerConfig(kind="ddim")), sliding,
                              image_size=1024, vae_batch=4, device="cuda")
    sampler = SlidingIterativeSampler(
        dataset, pipe, output_dir=str(work / "out"), spa_label_range=(0, 16, 1),
        tem_label_range=(0, 1, 1), input_spa_labels=[1, 5, 9, 13], seed=0)
    setup_s = time.perf_counter() - t0

    phases: dict[str, float] = {}
    _timed(sampler, "load_sample", phases)
    for name in ("prepare_conditions", "sliding_denoise", "decode"):
        _timed(pipe, name, phases)
    decoded = []
    decode = pipe.decode
    pipe.decode = lambda lat: decoded.append(decode(lat)) or decoded[-1]

    torch.cuda.reset_peak_memory_stats()
    wrappers = _path_wrappers()
    _reset(wrappers.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sampler.execute_tasks()  # validates the grid and the output set itself
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches, shapes = _kernel_counts(wrappers)
    routed = _check_routes(fa.KERNELS, [(B, S, S, H, 64) for B, S, H in SLICE_ATTN64_SHAPES])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    images = np.concatenate(decoded)
    jpgs = sorted((work / "out" / "images").rglob("*.jpg"))
    res = {"setup_s": setup_s, "total_s": total_s, "phases_s": phases, "peak_gb": peak_gb,
           "launches": launches, "shapes": shapes, "routed": routed,
           "windows": int(sampler._windows_for(
               sampler.all_tasks[0][0], 16).shape[0]),
           "decoded": list(images.shape), "jpgs": len(jpgs),
           "image_mean": float(images.mean()), "image_std": float(images.std())}
    log(f"slice: {json.dumps(res)}")
    if images.shape != (12, 1024, 1024, 3) or images.dtype != np.uint8:
        raise AssertionError(f"slice: decoded {images.shape} {images.dtype}")
    if len(jpgs) != 16:
        raise AssertionError(f"slice: {len(jpgs)} images on disk, expected 16")
    if not images.std() > 0:
        raise AssertionError("slice: decoded images are constant")
    if not launches["conv3x3"] or not launches["flash_fwd_d512"] or not launches["groupnorm"]:
        raise AssertionError(f"slice: a kernel of the path never launched: {launches}")
    return res


@contextlib.contextmanager
def _patched(obj, name: str, make):
    """Replace ``obj.name`` by ``make(original)`` for the block."""
    original = getattr(obj, name)
    setattr(obj, name, make(original))
    try:
        yield
    finally:
        setattr(obj, name, original)


def phase_cli(unet, vae, work: Path) -> dict:
    """Production demo_3d (cut to 16 cameras) from a diffusers directory
    through the port's CLI."""
    import numpy as np
    import torch

    from diffuman4d_torch import cli
    from diffuman4d_torch.data import make_synthetic_scene
    from diffuman4d_torch.io.checkpoints import save_hf_checkpoint
    from diffuman4d_torch.ops import flash_attention as fa
    from diffuman4d_torch.sampling import loader, pipeline as pp

    # the bench phase's 48-camera scene (made here when that phase did not run)
    model_dir, data_dir, out = work / "model", work / "bench", work / "cli_out"
    t0 = time.perf_counter()
    save_hf_checkpoint(str(model_dir), unet, vae)
    write_s = time.perf_counter() - t0
    ckpt_gb = sum(f.stat().st_size for f in model_dir.rglob("*") if f.is_file()) / 1e9
    t0 = time.perf_counter()
    if not (data_dir / BENCH_SCENE / "transforms.json").is_file():
        make_synthetic_scene(str(data_dir), BENCH_SCENE, num_cams=CLI_CAMERAS, num_frames=1,
                             image_size=1024)
    scene_s = time.perf_counter() - t0

    loaded, windows = {}, []

    def recording_load(load):
        def run(*a, **k):
            loaded["pipe"] = load(*a, **k)
            return loaded["pipe"]
        return run

    def counting_denoise(denoise):
        def run(self, cond, latents, t_idx, task_windows, domain, **kw):
            windows.append(len(task_windows))
            return denoise(self, cond, latents, t_idx, task_windows, domain, **kw)
        return run

    wrappers = _path_wrappers()
    argv = ["exp=demo_3d", f"data.data_dir={data_dir}", f"data.scene_label={BENCH_SCENE}",
            f"sampler.spa_label_range=[0,{CLI_CAMERAS},1]",
            "sampler.input_spa_labels=[" + ",".join(map(str, CLI_INPUTS)) + "]",
            f"model.model_dir={model_dir}", f"sampler.output_dir={out}", "evaluating=true"]
    with _patched(loader, "load_pipeline", recording_load), \
            _patched(pp.Diffuman4DPipeline, "sliding_denoise", counting_denoise):
        torch.cuda.reset_peak_memory_stats()
        _reset(wrappers.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
    launches, shapes = _kernel_counts(wrappers)
    routed = _check_routes(fa.KERNELS, [(B, S, S, H, 64) for B, S, H in SLICE_ATTN64_SHAPES])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    pipe = loaded.pop("pipe")
    unequal = []
    for tag, saved, got in (("unet", unet, pipe.unet), ("vae", vae, pipe.vae)):
        got = got.state_dict()
        unequal += [f"{tag}.{k}" for k, v in saved.state_dict().items()
                    if not torch.equal(v, got[k])]
    del pipe
    shutil.rmtree(model_dir)  # 3.8 GB of fp32 weights
    torch.cuda.empty_cache()
    jpgs = sorted((out / "images").rglob("*.jpg"))
    tfs = json.loads((out / "transforms.json").read_text())
    tfs_in = json.loads((out / "transforms_input.json").read_text())
    metrics = json.loads((out / "metrics.json").read_text())
    phases = json.loads((out / "phases.json").read_text())
    res = {"rc": rc, "cli_s": cli_s, "ckpt_write_s": write_s, "ckpt_gb": ckpt_gb,
           "scene_s": scene_s,
           **{f"{k.split('/')[-1]}_s": v["total_s"] for k, v in phases.items()},
           "phases": phases, "peak_gb": peak_gb, "launches": launches, "shapes": shapes,
           "routed": routed, "windows": sum(windows), "tasks": len(windows), "jpgs": len(jpgs),
           "frames": len(tfs["frames"]), "input_frames": len(tfs_in["frames"]),
           "metrics_mean": metrics["mean"], "metrics_values": len(metrics["values"]),
           "weights_unequal": unequal[:8]}
    log(f"cli: {json.dumps(res)}")
    log(f"cli: checkpoint write {write_s:.2f} s ({ckpt_gb:.2f} GB), load "
        f"{res.get('load_pipeline_s')} s, sampling {res.get('sampling_s')} s (phases.json: "
        + ", ".join(f"{k} {v['total_s']} s" for k, v in phases.items() if k.startswith("task/"))
        + f"), export {res.get('to_nerfstudio_s')} s, evaluate {res.get('evaluate_s')} s, "
        f"peak {peak_gb:.2f} GB, launches {launches}")
    n_in = len(CLI_INPUTS)
    want = {"rc": 0, "jpgs": CLI_CAMERAS, "frames": CLI_CAMERAS, "input_frames": n_in,
            "metrics_values": CLI_CAMERAS - n_in, "windows": CLI_CAMERAS - n_in,
            "tasks": 1, "weights_unequal": []}
    if wrong := {k: (res[k], v) for k, v in want.items() if res[k] != v}:
        raise AssertionError(f"cli: (got, expected) {wrong}")
    if not math.isfinite(metrics["mean"]["psnr"]):
        raise AssertionError(f"cli: mean PSNR {metrics['mean']}")
    for name in ("flash_fwd_d512", "conv3x3"):  # attention: _check_routes
        if not launches[name]:
            raise AssertionError(f"cli: {name} never launched: {launches}")
    return res


def _recording(acc: list, name: str):
    """A maker for ``_patched`` that wraps the pipeline's ``name``
    (``sliding_denoise`` or ``prepare_conditions``) to append (name, domain,
    streamed, windows, seconds) per call; the call ends with a synchronise,
    as the sampler's phase around it does."""
    import torch

    def make(fn):
        def run(self, *a, **k):
            t0 = time.perf_counter()
            out = fn(self, *a, **k)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if name == "sliding_denoise":
                cond, _, _, windows, domain = a
                acc.append((name, domain, "skel_rows" in cond, len(windows), secs))
            else:
                acc.append((name, a[0].domain, "skel_rows" in out, 0, secs))
            return out
        return run
    return make


def _by_domain(calls: list) -> dict:
    """Per domain: tasks, streamed tasks, windows and seconds of the
    recorded calls."""
    out: dict = {}
    for name, domain, streamed, windows, secs in calls:
        d = out.setdefault(domain, {"tasks": 0, "streamed": 0, "windows": 0,
                                    "sliding_denoise_s": 0.0, "prepare_conditions_s": 0.0})
        d[f"{name}_s"] += secs
        if name == "sliding_denoise":
            d["tasks"] += 1
            d["streamed"] += streamed
            d["windows"] += windows
    for d in out.values():
        d["s_per_window"] = d["sliding_denoise_s"] / max(d["windows"], 1)
    return out


def _padded_windows(n_rows: int):
    """Windows of D4D_PADDED_WINDOWS over a temporal task of ``n_rows``
    rows (condition rows first, then the target's): 4 + 4 rows each, whose
    chunk unions differ in size, so a chunk's rows are renumbered and
    padded."""
    import numpy as np

    half = n_rows // 2
    return np.stack([np.r_[np.arange(k, k + n), half + np.arange(k, k + n)]
                     for k, n in D4D_PADDED_WINDOWS])


def _streamed_chunks(pipe, cond, windows, c: int, materialised,
                     key: str = "pose_features") -> dict:
    """Every chunk's ``key`` rows (streamed pose features, or gathered
    skeleton latents), pad rows included, against the materialised rows of
    the same labels, and each chunk's renumbered windows mapped back
    through its row union against the task's."""
    import numpy as np
    import torch

    pad_u = pipe._chunk_pad_u(windows, c)
    unequal, rows, padded = [], 0, 0
    for i in range(0, len(windows), c):
        w = windows[i : i + c]
        chunk, wc = pipe._chunk_cond(cond, w, pad_u)
        U, _ = pipe._chunk_rows(w, pad_u)
        if not np.array_equal(U[wc], w):
            unequal.append(("windows", i))
        feats = chunk[key]
        if feats.shape[0] != pad_u:
            unequal.append(("rows", i, feats.shape[0]))
        unequal += [(i, r) for j, r in enumerate(U.tolist())
                    if not torch.equal(feats[j], materialised[r])]
        rows += len(U)
        padded += pad_u - np.unique(w).size
    return {"chunks": -(-len(windows) // c), "pad_u": pad_u, "rows": rows,
            "padded_rows": padded, "unequal": unequal}


def _cache_equalities(pipe, sampler) -> dict:
    """On the card, for the first temporal task: its streamed per-chunk pose
    features, chunk by chunk, against the cache's materialised rows -- at
    the pipeline's own chunking of the task's windows, and at windows of 4 +
    4 rows whose chunk unions are padded -- and its cached conditional
    latents warm against cold. On each side a row shares its micro-batch
    with other rows (the cache is first filled with every third row), so
    equality shows that a row's value does not depend on its batch."""
    import dataclasses

    import numpy as np
    import torch

    task = sampler.all_tasks[1][0]
    sample = sampler.load_sample(task)
    windows = sampler._windows_for(task, len(sample.labels))
    padded = _padded_windows(len(sample.labels))
    cond_rows = list(np.nonzero(sample.cond_masks == 0.0)[0])
    with torch.no_grad():
        pipe.clear_condition_caches()
        cond = pipe.prepare_conditions(sample)
        pipe._pose_features_lru(dataclasses.replace(sample, labels=sample.labels[1::3],
                                                    skeletons=sample.skeletons[1::3]))
        materialised = pipe._pose_features_lru(sample)
        task_chunks = _streamed_chunks(pipe, cond, windows,
                                       pipe._window_chunk_size(len(windows)), materialised)
        padded_chunks = _streamed_chunks(pipe, cond, padded, D4D_PAD_CHUNK, materialised)
        pipe.clear_condition_caches()
        cold = pipe._cond_latents_cached(sample, cond_rows)
        pipe.clear_condition_caches()
        pipe._cond_latents_cached(sample, cond_rows[1::3])
        warm = pipe._cond_latents_cached(sample, cond_rows)
        hits = pipe._cond_latents_cached(sample, cond_rows)
        pipe.clear_condition_caches()
    return {"task": task.domain_label, "streamed": "skel_rows" in cond,
            "task_chunks": task_chunks, "padded_chunks": padded_chunks,
            "cond_rows": len(cond_rows), "cond_latents_equal": bool(
                torch.equal(cold, warm) and torch.equal(cold, hits))}


def _skeleton_equalities(pipe, sampler) -> dict:
    """On the card, for the first temporal task of the skeleton-latent UNet:
    every third row's skeleton latent encoded beside other rows against the
    task's own encode, and each chunk's gathered skeleton latents -- a
    window a chunk, and windows of 4 + 4 rows whose chunk unions are
    renumbered and padded -- against the materialised rows, bit for bit."""
    import torch

    task = sampler.all_tasks[1][0]
    sample = sampler.load_sample(task)
    windows = sampler._windows_for(task, len(sample.labels))
    with torch.no_grad():
        pipe.clear_condition_caches()
        cond = pipe.prepare_conditions(sample)
        z = cond["skeleton_latents"]
        every_third = pipe.encode_images(pipe._skeletons_to_device(sample, range(1, len(z), 3)),
                                         pipe.skeleton_noise(sample.labels[1::3]))
        res = {"task": task.domain_label, "rows": len(z),
               "batch_independent": bool(torch.equal(every_third, z[1::3])),
               "task_chunks": _streamed_chunks(pipe, cond, windows, 1, z, "skeleton_latents"),
               "padded_chunks": _streamed_chunks(pipe, cond, _padded_windows(len(z)),
                                                 D4D_PAD_CHUNK, z, "skeleton_latents")}
        pipe.clear_condition_caches()
    return res


def phase_demo4d(work: Path) -> dict:
    """demo_4d's schedule at full width in two parts on one output
    directory: (a) a budgeted prefix through the sampler, as a session of
    ``demo4d_chain`` rolled up by ``demo4d_report``, (b) the rest through
    the port's CLI, which resumes from (a)'s grid state; then (c)
    ``temporal_wave_proof``'s temporal task on the same scene."""
    import io

    import numpy as np
    import torch

    from diffuman4d_torch import (
        cli, demo4d_chain, demo4d_prefix, demo4d_report, temporal_wave_proof)
    from diffuman4d_torch.configs.presets import build_config
    from diffuman4d_torch.io.gridstate import read_state
    from diffuman4d_torch.ops import flash_attention as fa
    from diffuman4d_torch.sampling import loader, pipeline as pp
    from diffuman4d_torch.sampling.sampler import _to_host_bits
    from diffuman4d_torch.utils.tracing import report

    out = work / "demo4d_out"
    t0 = time.perf_counter()
    data_dir = _d4d_scene(work)
    scene_s = time.perf_counter() - t0
    argv = ["exp=demo_4d", f"data.data_dir={data_dir}", "data.scene_label=scene0",
            f"sampler.spa_label_range=[0,{D4D_CAMERAS},1]",
            f"sampler.tem_label_range=[0,{D4D_FRAMES},1]",
            "sampler.input_spa_labels=[" + ",".join(map(str, D4D_INPUTS)) + "]",
            f"sampler.sliding_stride={D4D_STRIDE}", f"sampler.output_dir={out}",
            "evaluating=true"]
    cfg = build_config(argv)
    total_steps = loader.sliding_from(cfg.sampler).total_steps
    wrappers = _path_wrappers()
    expected = [(B, S, S, H, 64) for B, S, H in SLICE_ATTN64_SHAPES + TEMPORAL_ATTN64_SHAPES]

    # (a) the budgeted prefix: the sampler directly, the CLI's construction,
    # as one session of demo4d_chain (in this process), rolled up by
    # demo4d_report
    calls_a: list = []
    pipe = loader.load_pipeline(cfg.model, cfg.sampler, cfg.data, device="cuda",
                                pose_cache_mb=D4D_POSE_CACHE_MB, window_chunk=D4D_WINDOW_CHUNK)
    a: dict = {}

    def session(argv: list, log_path: Path) -> int:
        opts = demo4d_prefix._args(argv)
        sampler = cli.build_sampler(cfg, pipe, task_budget=opts.task_budget,
                                    checkpoint_every_tasks=opts.checkpoint_every)
        a["sampler"], a["fresh"] = sampler, (sampler._completed_rounds,
                                             sampler._resume_tasks_done)
        report(reset=True)
        with _patched(pp.Diffuman4DPipeline, "sliding_denoise",
                      _recording(calls_a, "sliding_denoise")), \
                _patched(pp.Diffuman4DPipeline, "prepare_conditions",
                         _recording(calls_a, "prepare_conditions")):
            torch.cuda.reset_peak_memory_stats()
            _reset(wrappers.values())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sampler.execute_tasks()
            torch.cuda.synchronize()
            a["prefix_s"] = time.perf_counter() - t0
        a["phases"] = report(reset=True)
        log_path.write_text(json.dumps({  # the line demo4d_prefix prints
            "resumed_rounds": a["fresh"][0], "resumed_tasks": a["fresh"][1],
            "tasks_run": sampler._tasks_run, "run_s": a["prefix_s"],
            "complete": sampler._completed_rounds == len(sampler.all_tasks),
            "phases": a["phases"]}) + "\n")
        return 0

    chain_dir = work / "demo4d_chain"
    sessions = demo4d_chain.run_chain(D4D_BUDGET, 1, 0, chain_dir, [], session=session,
                                      checkpoint_every=D4D_CKPT_EVERY)
    sampler, fresh, prefix_s, phases_a = a["sampler"], a["fresh"], a["prefix_s"], a["phases"]
    launches_a, shapes_a = _kernel_counts(wrappers)
    routed_a = _check_routes(fa.KERNELS, expected)
    peak_a = torch.cuda.max_memory_allocated() / 1e9
    meta_a, data = read_state(sampler._state_path)
    grid_bits = _to_host_bits(sampler.grid_latents)
    state_a_equal = bool(np.array_equal(np.asarray(data["latents"]), grid_bits)
                         and np.array_equal(np.asarray(data["t_idx"]), sampler.grid_t_idx))
    state_gb = Path(sampler._state_path).stat().st_size / 1e9
    del data
    rolled = demo4d_report.report(str(chain_dir / "sessions.jsonl"), str(out))
    rolled_got = {"sessions": [(r["rc"], r["start_round"], r["start_tasks"], r["tasks"])
                               for r in rolled["sessions"]],
                  "grid": (rolled["grid"]["completed_rounds"],
                           rolled["grid"]["tasks_done_in_round"]),
                  "images": rolled["images_on_disk"]}
    rolled_want = {"sessions": [(0, 0, 0, D4D_BUDGET)],
                   "grid": (meta_a["completed_rounds"], meta_a["tasks_done_in_round"]),
                   "images": len(list((out / "images").rglob("*.jpg")))}
    log(f"demo4d: chain {json.dumps(sessions)}; report {json.dumps(rolled_got)}")
    if rolled_got != rolled_want:
        raise AssertionError(f"demo4d: chain / report {rolled_got}, expected {rolled_want}")
    t0 = time.perf_counter()
    equalities = _cache_equalities(pipe, sampler)
    equalities_s = time.perf_counter() - t0
    del sampler, pipe
    a.clear()
    torch.cuda.empty_cache()

    # (b) the rest through the CLI, from (a)'s state
    calls_b: list = []
    resumed = {}

    def recording_build(build):
        def run(*a, **k):
            s = build(*a, **k)
            resumed["at"] = [s._completed_rounds, s._resume_tasks_done]
            return s
        return run

    with _patched(cli, "build_sampler", recording_build), \
            _patched(pp.Diffuman4DPipeline, "sliding_denoise",
                     _recording(calls_b, "sliding_denoise")), \
            _patched(pp.Diffuman4DPipeline, "prepare_conditions",
                     _recording(calls_b, "prepare_conditions")):
        torch.cuda.reset_peak_memory_stats()
        _reset(wrappers.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
    launches_b, shapes_b = _kernel_counts(wrappers)
    routed_b = _check_routes(fa.KERNELS, expected)
    peak_b = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()

    # (c) temporal_wave_proof on this scene: a seeded round-1 state, then one
    # temporal task of the preset (cut to stride 4 like the rest)
    buf = io.StringIO()
    _reset(wrappers.values())
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc_proof = temporal_wave_proof.main(
            ["--scene", str(data_dir), "--out", str(work / "demo4d_tproof"), "--size", "1024",
             "--task-budget", "1", *argv[2:-2]])
    proof_s = time.perf_counter() - t0
    proof_lines = buf.getvalue().strip().splitlines()
    log("\n".join(x for x in proof_lines if x.startswith("[tproof]")))
    proof = json.loads(proof_lines[-1]) if rc_proof == 0 else {}
    _check_routes(fa.KERNELS, [])
    proof_launches = {n: f.launches for n, f in wrappers.items()}
    torch.cuda.empty_cache()

    meta, data = read_state(str(out / "state" / "grid_state.d4d"))
    t_idx = np.asarray(data["t_idx"])
    inputs = [int(i) for i in D4D_INPUTS]
    targets = [i for i in range(D4D_CAMERAS) if i not in inputs]
    jpgs = sorted((out / "images").rglob("*.jpg"))
    metrics = json.loads((out / "metrics.json").read_text())
    phases = json.loads((out / "phases.json").read_text())
    res = {"scene_s": scene_s, "prefix_s": prefix_s, "cli_s": cli_s, "equalities_s": equalities_s,
           "chain": sessions, "report": rolled_got,
           "tproof": {"rc": rc_proof, "s": proof_s, "run": proof, "launches": proof_launches},
           "prefix": {"fresh_at": fresh, "state": meta_a, "state_equals_grid": state_a_equal,
                      "state_gb": state_gb, "by_domain": _by_domain(calls_a),
                      "phases": phases_a, "peak_gb": peak_a, "launches": launches_a,
                      "routed": routed_a},
           "equalities": equalities,
           "cli": {"rc": rc, "resumed_at": resumed.get("at"), "by_domain": _by_domain(calls_b),
                   "phases": phases, "peak_gb": peak_b, "launches": launches_b,
                   "routed": routed_b},
           "launches": {n: launches_a[n] + launches_b[n] for n in launches_a},
           "shapes": {n: sorted(set(shapes_a[n]) | set(shapes_b[n])) for n in shapes_a},
           "state": meta, "jpgs": len(jpgs),
           "frames": len(json.loads((out / "transforms.json").read_text())["frames"]),
           "metrics_values": len(metrics["values"]), "metrics_mean": metrics["mean"],
           "targets_at": sorted(set(t_idx[targets].ravel().tolist())),
           "inputs_at": sorted(set(t_idx[inputs].ravel().tolist())), "total_steps": total_steps}
    log(f"demo4d: {json.dumps(res)}")
    log(f"demo4d: prefix {prefix_s:.2f} s ({_by_domain(calls_a)}), state "
        f"{phases_a.get('save_state/d2h', {}).get('mean_s')} s d2h + "
        f"{phases_a.get('save_state/write', {}).get('mean_s')} s write ({state_gb:.3f} GB); "
        f"CLI {cli_s:.2f} s, resume {phases.get('resume/load', {}).get('total_s')} s, "
        f"peak {peak_a:.2f} / {peak_b:.2f} GB, launches {res['launches']}")
    n_tem = len(targets)  # temporal tasks: one per target camera
    want = {"fresh_at": (0, 0), "prefix_state": (1, D4D_BUDGET - D4D_FRAMES),
            "prefix_calls": {"spatial": (D4D_FRAMES, 0, D4D_FRAMES * D4D_WINDOWS),
                             "temporal": (D4D_BUDGET - D4D_FRAMES, D4D_BUDGET - D4D_FRAMES,
                                          (D4D_BUDGET - D4D_FRAMES) * D4D_WINDOWS)},
            "state_equals_grid": True, "rc": 0, "resumed_at": [1, D4D_BUDGET - D4D_FRAMES],
            "cli_calls": {"temporal": (n_tem - (D4D_BUDGET - D4D_FRAMES), 0,
                                       (n_tem - (D4D_BUDGET - D4D_FRAMES)) * D4D_WINDOWS),
                          "spatial": (D4D_FRAMES, 0, D4D_FRAMES * D4D_WINDOWS)},
            "jpgs": D4D_CAMERAS * D4D_FRAMES, "frames": D4D_CAMERAS * D4D_FRAMES,
            "metrics_values": n_tem * D4D_FRAMES, "state": (3, 0),
            "targets_at": [total_steps], "inputs_at": [0],
            "equalities": (True, D4D_WINDOWS // D4D_WINDOW_CHUNK, [], 12, 4, [], True)}

    def calls(by):
        return {d: (v["tasks"], v["streamed"], v["windows"]) for d, v in by.items()}

    got = {"fresh_at": fresh, "prefix_state": (meta_a["completed_rounds"],
                                               meta_a["tasks_done_in_round"]),
           "prefix_calls": calls(res["prefix"]["by_domain"]), "state_equals_grid": state_a_equal,
           "rc": rc, "resumed_at": resumed.get("at"), "cli_calls": calls(res["cli"]["by_domain"]),
           "jpgs": res["jpgs"], "frames": res["frames"], "metrics_values": res["metrics_values"],
           "state": (meta["completed_rounds"], meta["tasks_done_in_round"]),
           "targets_at": res["targets_at"], "inputs_at": res["inputs_at"],
           "equalities": (equalities["streamed"], equalities["task_chunks"]["chunks"],
                          equalities["task_chunks"]["unequal"],
                          equalities["padded_chunks"]["pad_u"],
                          equalities["padded_chunks"]["padded_rows"],
                          equalities["padded_chunks"]["unequal"],
                          equalities["cond_latents_equal"])}
    if wrong := {k: (got[k], v) for k, v in want.items() if got[k] != v}:
        raise AssertionError(f"demo4d: (got, expected) {wrong}")
    if not math.isfinite(metrics["mean"]["psnr"]):
        raise AssertionError(f"demo4d: mean PSNR {metrics['mean']}")
    seeded = work / "demo4d_tproof" / "state" / "grid_state_seeded.d4d"
    proof_got = (rc_proof, proof.get("tasks"), proof.get("state"), seeded.is_file())
    if proof_got != (0, 1, [1, 1], True) or not (proof_launches["flash_fwd_d512"]
                                                  and proof_launches["conv3x3"]):
        raise AssertionError(f"demo4d: temporal_wave_proof rc {rc_proof}, {proof}, seeded state "
                             f"{seeded.is_file()}, launches {proof_launches}")
    for part, launches in (("prefix", launches_a), ("cli", launches_b)):
        for name in ("flash_fwd_d512", "conv3x3"):  # attention: _check_routes
            if not launches[name]:
                raise AssertionError(f"demo4d {part}: {name} never launched: {launches}")
    return res


def _grid_history(sampler, state_path) -> dict:
    """The sampler's device grid and history against a state file, bit for
    bit, and whether the history marks exactly the stepped latents."""
    import numpy as np

    from diffuman4d_torch.io.gridstate import read_state
    from diffuman4d_torch.sampling.sampler import _to_host_bits

    meta, data = read_state(str(state_path))
    has_prev = sampler.grid_aux["has_prev"].cpu().numpy()
    out = {"state": [meta["completed_rounds"], meta["tasks_done_in_round"]],
           "aux_names": sorted(k for k in data if k.startswith("aux_")),
           "aux_equal": all(np.array_equal(np.asarray(data[f"aux_{k}"]), _to_host_bits(v))
                            for k, v in sampler.grid_aux.items()),
           "latents_equal": bool(np.array_equal(np.asarray(data["latents"]),
                                                _to_host_bits(sampler.grid_latents))),
           "has_prev_is_stepped": bool(np.array_equal(has_prev, sampler.grid_t_idx > 0)),
           "stepped": int(has_prev.sum()),
           "state_gb": Path(state_path).stat().st_size / 1e9}
    del data
    return out


def phase_variants(work: Path) -> dict:
    """The checkpoint variants on the card, from diffusers directories: (a)
    the skeleton-latent UNet under DPM++ through the CLI's demo_4d on the
    16 x 12 grid, stopped by a task budget after the first temporal task
    and resumed to the end, the history checked against the state at both
    ends, the skeleton latents' batch independence and chunks between; (b) the same weights under Euler with FreeU, one demo_3d task
    through ``load_pipeline``, a small full-width window step through the
    kernels and through the plain versions, and a production window step
    with and without FreeU."""
    import dataclasses

    import numpy as np
    import torch

    from diffuman4d_torch import cli
    from diffuman4d_torch.configs.presets import build_config
    from diffuman4d_torch.io import checkpoints
    from diffuman4d_torch.models.freeu import FreeUConfig
    from diffuman4d_torch.models.unet import UNetConfig
    from diffuman4d_torch.ops import flash_attention as fa
    from diffuman4d_torch.sampling import loader, pipeline as pp

    model_dir, out = work / "variants_model", work / "variants_out"
    t0 = time.perf_counter()
    unet, vae = loader.build_models(UNetConfig(enable_pose_encoder=False, in_channels=15),
                                    device="cuda", dtype=torch.bfloat16, seed=0)
    checkpoints.save_hf_checkpoint(str(model_dir), unet, vae, scheduler_config=dict(
        SD21_SCHEDULER, _class_name="DPMSolverMultistepScheduler"))
    del unet, vae
    torch.cuda.empty_cache()
    write_s = time.perf_counter() - t0
    data_dir = _d4d_scene(work)
    argv = ["exp=demo_4d", f"data.data_dir={data_dir}", "data.scene_label=scene0",
            f"sampler.spa_label_range=[0,{D4D_CAMERAS},1]",
            f"sampler.tem_label_range=[0,{D4D_FRAMES},1]",
            "sampler.input_spa_labels=[" + ",".join(map(str, D4D_INPUTS)) + "]",
            f"sampler.alternation_rounds={VAR_ROUNDS}", f"sampler.sliding_stride={VAR_STRIDE}",
            f"model.model_dir={model_dir}", f"sampler.output_dir={out}",
            "to_nerfstudio=false", "evaluating=false"]
    wrappers = _path_wrappers()
    spatial = [(B, S, S, H, 64) for B, S, H in SLICE_ATTN64_SHAPES]
    temporal = [(B, S, S, H, 64) for B, S, H in TEMPORAL_ATTN64_SHAPES]
    state = out / "state" / "grid_state.d4d"

    def run_cli(budget, resume_check: dict):
        """One ``cli.main`` call, the sampler built with ``budget``; the
        built sampler is kept, and a resumed one is held to the state file
        it resumed from."""
        built: dict = {}

        def building(build):
            def run(*a, **k):
                s = build(*a, **k, **({"task_budget": budget} if budget else {}))
                built["sampler"] = s
                built["resumed_at"] = [s._completed_rounds, s._resume_tasks_done]
                if state.is_file():
                    resume_check.update(_grid_history(s, state))
                return s
            return run

        calls: list = []
        with _patched(cli, "build_sampler", building), \
                _patched(pp.Diffuman4DPipeline, "sliding_denoise",
                         _recording(calls, "sliding_denoise")), \
                _patched(pp.Diffuman4DPipeline, "prepare_conditions",
                         _recording(calls, "prepare_conditions")):
            torch.cuda.reset_peak_memory_stats()
            _reset(wrappers.values())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = cli.main(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        launches, shapes = _kernel_counts(wrappers)
        return {"rc": rc, "cli_s": secs, "resumed_at": built["resumed_at"],
                "by_domain": _by_domain(calls), "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "launches": launches, "shapes": shapes,
                "phases": json.loads((out / "phases.json").read_text())}, built["sampler"]

    # (a) DPM++, the skeleton-latent UNet: a budgeted CLI call, then the rest
    first, sampler = run_cli(VAR_BUDGET, {})
    first["routed"] = _check_routes(fa.KERNELS, spatial + temporal)
    first["at_stop"] = _grid_history(sampler, state)
    kind, enable_pose = sampler.pipeline.scheduler.config.kind, \
        sampler.pipeline.unet.config.enable_pose_encoder
    t0 = time.perf_counter()
    equalities = _skeleton_equalities(sampler.pipeline, sampler)
    equalities["s"] = time.perf_counter() - t0
    del sampler
    torch.cuda.empty_cache()
    resumed: dict = {}
    second, sampler = run_cli(None, resumed)
    second["routed"] = _check_routes(fa.KERNELS, temporal)
    second["at_end"] = _grid_history(sampler, state)
    t_idx = sampler.grid_t_idx.copy()
    del sampler
    torch.cuda.empty_cache()
    inputs = list(D4D_INPUTS)
    targets = [i for i in range(D4D_CAMERAS) if i not in inputs]
    jpgs = len(list((out / "images").rglob("*.jpg")))

    # (b) Euler + FreeU from the same weights: one demo_3d task of 16 cameras
    (model_dir / "scheduler" / "scheduler_config.json").write_text(json.dumps(
        dict(SD21_SCHEDULER, _class_name="EulerDiscreteScheduler")))
    cfg = build_config(["exp=demo_3d", f"data.data_dir={_scene(work)}", "data.scene_label=scene0",
                        "sampler.spa_label_range=[0,16,1]", "sampler.input_spa_labels=[1,5,9,13]",
                        f"model.model_dir={model_dir}",
                        f"sampler.output_dir={work / 'variants_euler_out'}"])
    with _patched(checkpoints, "unet_config_from_hf",
                  lambda read: lambda c: dataclasses.replace(read(c),
                                                             freeu=tuple(FreeUConfig()))):
        pipe = loader.load_pipeline(cfg.model, cfg.sampler, cfg.data, device="cuda")
    sampler = cli.build_sampler(cfg, pipe)
    decoded: list = []
    decode = pipe.decode
    pipe.decode = lambda lat: decoded.append(decode(lat)) or decoded[-1]
    _reset(wrappers.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sampler.execute_tasks()
    torch.cuda.synchronize()
    task_s = time.perf_counter() - t0
    euler_launches, euler_shapes = _kernel_counts(wrappers)
    euler_routed = _check_routes(fa.KERNELS, spatial)
    images = np.concatenate(decoded)

    # a small full-width window step (4 frames at 32^2 latents, CFG) through
    # the kernels and through the plain versions
    gen = torch.Generator(device="cuda").manual_seed(2)
    L, lat = 4, 32
    is_cond = torch.tensor([True, False, False, False], device="cuda")

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    cond_w = {"is_cond": is_cond, "pix_latents": rnd(L, lat, lat, 4), "plucker": rnd(L, lat, lat, 6),
              "skeleton_latents": rnd(L, lat, lat, 4)}
    x = rnd(L, lat, lat, 4) * pipe.scheduler.init_noise_sigma
    ti = torch.tensor([0, 1, 1, 1], device="cuda")
    with torch.no_grad():
        got, _, _ = pipe._denoise_step(cond_w, x, ti, "spatial")
        with plain_versions():
            want, _, _ = pipe._denoise_step(cond_w, x, ti, "spatial")
    step_rel_l2 = _rel_l2(got, want)

    # a production window step (the task's first window, CFG batch 32 at
    # 128^2) with FreeU and without, in turns
    task = sampler.all_tasks[0][0]
    sample = sampler.load_sample(task)
    window = torch.from_numpy(sampler._windows_for(task, len(sample.labels))[0]).cuda()
    with torch.no_grad():
        cond = pipe.prepare_conditions(sample)
        cond_w = {k: v[window] for k, v in cond.items()}
        x = sampler.grid_latents[window, 0]
        ti = torch.zeros(len(window), dtype=torch.int64, device="cuda")
        freeu = [b.freeu for b in pipe.unet.up_blocks]

        def step(on: bool):
            for b, f in zip(pipe.unet.up_blocks, freeu):
                b.freeu = f if on else None
            return cuda_ms(lambda: pipe._denoise_step(cond_w, x, ti, "spatial"), iters=2)

        turns = [step(True), step(False), step(False), step(True)]
    del pipe, sampler, cond
    torch.cuda.empty_cache()
    shutil.rmtree(model_dir)  # 3.8 GB of fp32 weights

    res = {"ckpt_write_s": write_s, "first": first, "equalities": equalities,
           "resumed_from_state": resumed,
           "second": second, "kind": kind, "enable_pose_encoder": enable_pose, "jpgs": jpgs,
           "targets_at": sorted(set(t_idx[targets].ravel().tolist())),
           "inputs_at": sorted(set(t_idx[inputs].ravel().tolist())),
           "euler": {"task_s": task_s, "launches": euler_launches, "routed": euler_routed,
                     "decoded": list(images.shape), "image_std": float(images.std()),
                     "window_step_rel_l2": step_rel_l2,
                     "window_step_ms_freeu_off_on": {"freeu": [turns[0], turns[3]],
                                                     "plain": [turns[1], turns[2]]}},
           "launches": {n: first["launches"][n] + second["launches"][n] + euler_launches[n]
                        for n in first["launches"]},
           "shapes": {n: sorted(set(first["shapes"][n]) | set(second["shapes"][n])
                                | set(euler_shapes[n])) for n in first["shapes"]}}
    log(f"variants: {json.dumps(res)}")
    for part in (first, second):
        log(f"variants (a): cli {part['cli_s']:.2f} s from {part['resumed_at']}, by domain "
            f"{json.dumps(part['by_domain'])}, state d2h "
            f"{part['phases'].get('save_state/d2h', {}).get('total_s')} s + write "
            f"{part['phases'].get('save_state/write', {}).get('total_s')} s, resume "
            f"{part['phases'].get('resume/load', {}).get('total_s')} s, peak "
            f"{part['peak_gb']:.2f} GB, launches {part['launches']}")
    log(f"variants (b): Euler + FreeU task {task_s:.2f} s, window step kernels vs plain rel L2 "
        f"{step_rel_l2:.3e}, production window step FreeU {turns[0]:.1f} / {turns[3]:.1f} ms, "
        f"without {turns[1]:.1f} / {turns[2]:.1f} ms")
    n_tem = VAR_BUDGET - D4D_FRAMES  # temporal tasks before the stop
    windows = (D4D_CAMERAS - len(D4D_INPUTS)) // VAR_STRIDE  # a task's, in both domains
    want = {"kind": ("dpm++", False), "first_rc": 0, "first_at": [[0, 0], [1, n_tem]],
            "first_calls": {"spatial": (D4D_FRAMES, 0, D4D_FRAMES * windows),
                            "temporal": (n_tem, 0, n_tem * windows)},
            "at_stop": (["aux_has_prev", "aux_prev_x0"], True, True, True),
            "second_rc": 0, "resumed_at": [1, n_tem],
            "resumed_from_state": (True, True, True),
            "second_calls": {"temporal": (len(targets) - n_tem, 0,
                                          (len(targets) - n_tem) * windows)},
            "at_end": ([VAR_ROUNDS, 0], True, True, True, len(targets) * D4D_FRAMES),
            "jpgs": D4D_CAMERAS * D4D_FRAMES, "inputs_at": [0],
            "equalities": (True, windows, [], 12, 4, []),
            "euler_decoded": [12, 1024, 1024, 3]}
    got = {"kind": (kind, enable_pose), "first_rc": first["rc"],
           "first_at": [first["resumed_at"], first["at_stop"]["state"]],
           "first_calls": {d: (v["tasks"], v["streamed"], v["windows"])
                           for d, v in first["by_domain"].items()},
           "at_stop": (first["at_stop"]["aux_names"], first["at_stop"]["aux_equal"],
                       first["at_stop"]["latents_equal"],
                       first["at_stop"]["has_prev_is_stepped"]),
           "second_rc": second["rc"], "resumed_at": second["resumed_at"],
           "resumed_from_state": (resumed.get("aux_equal"), resumed.get("latents_equal"),
                                  resumed.get("has_prev_is_stepped")),
           "second_calls": {d: (v["tasks"], v["streamed"], v["windows"])
                            for d, v in second["by_domain"].items()},
           "at_end": (second["at_end"]["state"], second["at_end"]["aux_equal"],
                      second["at_end"]["latents_equal"],
                      second["at_end"]["has_prev_is_stepped"], second["at_end"]["stepped"]),
           "jpgs": jpgs, "inputs_at": res["inputs_at"], "euler_decoded": list(images.shape),
           "equalities": (equalities["batch_independent"],
                          equalities["task_chunks"]["chunks"],
                          equalities["task_chunks"]["unequal"],
                          equalities["padded_chunks"]["pad_u"],
                          equalities["padded_chunks"]["padded_rows"],
                          equalities["padded_chunks"]["unequal"])}
    if wrong := {k: (got[k], v) for k, v in want.items() if got[k] != v}:
        raise AssertionError(f"variants: (got, expected) {wrong}")
    if len(res["targets_at"]) != 1 or res["targets_at"][0] <= 0:
        raise AssertionError(f"variants: targets at {res['targets_at']}")
    if not images.std() > 0 or not step_rel_l2 <= E2E_REL_TOL:
        raise AssertionError(f"variants: Euler + FreeU images std {images.std()}, window step "
                             f"rel L2 {step_rel_l2} (bound {E2E_REL_TOL})")
    for part, launches in (("a1", first["launches"]), ("a2", second["launches"]),
                           ("b", euler_launches)):
        for name in ("flash_fwd_d512", "conv3x3"):  # attention: _check_routes
            if not launches[name]:
                raise AssertionError(f"variants {part}: {name} never launched: {launches}")
    return res


def _d4d_scene(work: Path) -> Path:
    """The demo4d phase's 16-camera x 12-frame scene at 1024^2 (made once)."""
    from diffuman4d_torch.data import make_synthetic_scene

    data_dir = work / "data4d"
    if not (data_dir / "scene0" / "transforms.json").is_file():
        make_synthetic_scene(str(data_dir), "scene0", num_cams=D4D_CAMERAS,
                             num_frames=D4D_FRAMES, image_size=1024, unique_frames=4)
    return data_dir


def phase_overlap(work: Path) -> dict:
    """The saver thread against the serial path on demo_4d's last round
    (spatial, every target row decoded and written), 16 x 12 at 1024^2:
    ``OVERLAP_TASKS`` tasks through ``execute_tasks`` (next load on the IO
    thread, decode + save on the saver thread) and the same tasks through
    ``execute_one_task`` one after another (load, denoise, decode, save),
    in turns after one untimed serial run, from the same grid and with
    cold caches each time. The grid
    is set as after round 2 (targets at 2 x steps per round); the latents
    are the initial noise, which changes no work."""
    import torch

    from diffuman4d_torch import cli
    from diffuman4d_torch.configs.presets import build_config
    from diffuman4d_torch.sampling import loader
    from diffuman4d_torch.utils.tracing import report

    data_dir = _d4d_scene(work)
    argv = ["exp=demo_4d", f"data.data_dir={data_dir}", "data.scene_label=scene0",
            f"sampler.spa_label_range=[0,{D4D_CAMERAS},1]",
            f"sampler.tem_label_range=[0,{D4D_FRAMES},1]",
            "sampler.input_spa_labels=[" + ",".join(map(str, D4D_INPUTS)) + "]",
            f"sampler.output_dir={work / 'overlap_out'}"]
    cfg = build_config(argv)
    pipe = loader.load_pipeline(cfg.model, cfg.sampler, cfg.data, device="cuda")
    sampler = cli.build_sampler(cfg, pipe, task_budget=OVERLAP_TASKS, checkpoint_every_tasks=0)
    targets = [sampler._spa_index[s] for s in sampler.target_spa_labels]
    t0_idx = sampler.grid_t_idx.copy()
    t0_idx[targets] = 2 * pipe.sliding.steps_per_alt
    lat0 = sampler.grid_latents.clone()
    last = len(sampler.all_tasks) - 1

    def start():
        sampler.grid_latents, sampler.grid_t_idx = lat0.clone(), t0_idx.copy()
        sampler._completed_rounds, sampler._resume_tasks_done, sampler._tasks_run = last, 0, 0
        pipe.clear_condition_caches()
        report(reset=True)
        torch.cuda.synchronize()
        return time.perf_counter()

    def threaded():
        t0 = start()
        sampler.execute_tasks()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def serial():
        t0 = start()
        for task in sampler.all_tasks[last][:OVERLAP_TASKS]:
            sampler.execute_one_task(task)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    serial()  # the process's first decodes and encodes pick their algorithms here
    runs = []
    for name, fn in (("threaded", threaded), ("serial", serial), ("serial", serial),
                     ("threaded", threaded)):
        secs = fn()
        phases = {k: v["total_s"] for k, v in report(reset=True).items()}
        if sampler._tasks_run not in (0, OVERLAP_TASKS) or sampler.grid_t_idx[targets][
                :, :OVERLAP_TASKS].min() != 3 * pipe.sliding.steps_per_alt:
            raise AssertionError(f"overlap {name}: {sampler._tasks_run} tasks, t_idx "
                                 f"{sampler.grid_t_idx[targets][:, :OVERLAP_TASKS]}")
        runs.append({"path": name, "s": secs, "s_per_task": secs / OVERLAP_TASKS,
                     "phases": phases})
        log(f"overlap: {name} {OVERLAP_TASKS} tasks {secs:.2f} s ({secs / OVERLAP_TASKS:.3f} s a "
            f"task), phases {phases}")
    mean = {p: sum(r["s"] for r in runs if r["path"] == p) / 2 for p in ("threaded", "serial")}
    res = {"tasks": OVERLAP_TASKS, "runs": runs, "mean_s": mean,
           "saved_s_per_task": (mean["serial"] - mean["threaded"]) / OVERLAP_TASKS}
    log(f"overlap: {json.dumps(res)}")
    del sampler, pipe
    torch.cuda.empty_cache()
    return res


def phase_demo4d_prod(work: Path) -> dict:
    """Production demo_4d (48 cameras x 150 frames at 1024^2) through the
    prefix script: a session of 2 tasks, then a fresh call that resumes and
    runs 1 more. Then production temporal tasks (300 rows, 75 windows,
    streamed in chunks of 5): a state claiming round 1 done is written from
    the spatial sessions' grid (targets at the end of round 1; the other
    latents are noise, which changes no work) and a session of
    ``PROD_TEMPORAL_TASKS`` tasks resumes from it: the second task's load
    runs on the IO thread and the first's input-row writes on the saver
    thread, each beside a denoise. Last, from a diffusers directory with a
    DPM++ scheduler, a one-task session and one that resumes from its state,
    which then holds the multistep history beside the latents."""
    import io

    import numpy as np
    import torch

    from diffuman4d_torch import demo4d_prefix
    from diffuman4d_torch.configs import presets
    from diffuman4d_torch.configs.presets import build_config
    from diffuman4d_torch.io.checkpoints import save_hf_checkpoint
    from diffuman4d_torch.io.gridstate import read_state, write_state
    from diffuman4d_torch.sampling import loader, pipeline as pp

    scene, out, tem_out = work / "prod_scene", work / "prod_out", work / "prod_tem_out"

    def session(out_dir, budget):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = demo4d_prefix.main(["--scene", str(scene), "--out", str(out_dir),
                                     "--task-budget", str(budget)])
        lines = buf.getvalue().strip().splitlines()
        log("\n".join(line for line in lines[:-1] if not line.startswith("{")))
        torch.cuda.empty_cache()
        return {"rc": rc, **json.loads(lines[-1])}

    runs = [session(out, 2), session(out, 1)]
    meta, data = read_state(str(out / "state" / "grid_state.d4d"))
    state_gb = (out / "state" / "grid_state.d4d").stat().st_size / 1e9

    cfg = build_config(["exp=demo_4d"])
    steps = loader.sliding_from(cfg.sampler).steps_per_alt
    t_idx = np.array(data["t_idx"])
    targets = [i for i in range(t_idx.shape[0]) if i not in cfg.sampler.input_spa_labels]
    t_idx[targets] = steps
    write_state(str(tem_out / "state" / "grid_state.d4d"),
                {**meta, "completed_rounds": 1, "tasks_done_in_round": 0},
                {"latents": np.array(data["latents"]), "t_idx": t_idx})
    del data
    chunks, calls = [], []

    def recording_chunk(chunk_cond):
        def run(self, cond, wchunk, pad_u):
            chunks.append((len(wchunk), int(pad_u), int(np.unique(wchunk).size)))
            return chunk_cond(self, cond, wchunk, pad_u)
        return run

    with _patched(pp.Diffuman4DPipeline, "_chunk_cond", recording_chunk), \
            _patched(pp.Diffuman4DPipeline, "sliding_denoise",
                     _recording(calls, "sliding_denoise")), \
            _patched(pp.Diffuman4DPipeline, "prepare_conditions",
                     _recording(calls, "prepare_conditions")):
        runs.append(session(tem_out, PROD_TEMPORAL_TASKS))
    tem_meta, _ = read_state(str(tem_out / "state" / "grid_state.d4d"))
    temporal = {"by_domain": _by_domain(calls), "chunks": len(chunks),
                "windows_per_chunk": sorted({c[0] for c in chunks}),
                "pad_u": sorted({c[1] for c in chunks}),
                "union_rows": sorted({c[2] for c in chunks}), "state": tem_meta}
    res = {"runs": runs, "state": meta, "state_gb": state_gb, "temporal": temporal}
    for r in runs:
        ph = r["phases"]
        log(f"demo4d_prod: resumed at {r['resumed_rounds']} + {r['resumed_tasks']}, "
            f"{r['tasks_run']} tasks in {r['run_s']:.2f} s ({r['s_per_task']:.2f} s a task), "
            f"save_state d2h {ph['save_state/d2h']['total_s']} s + write "
            f"{ph['save_state/write']['total_s']} s ({state_gb:.3f} GB), resume "
            f"{ph.get('resume/load', {}).get('total_s')} s, sampler init "
            f"{ph['prefix/sampler_init']['total_s']} s, peak {r.get('peak_gb')} GB")
    log(f"demo4d_prod: temporal task {json.dumps(temporal)}")

    # a DPM++ checkpoint on the production grid: a one-task session and its
    # state (latents + the multistep history), then a session that resumes
    # from it and runs one task more
    dpm_dir, dpm_out = work / "prod_dpm_model", work / "prod_dpm_out"
    unet, vae = loader.build_models(device="cuda", dtype=torch.bfloat16, seed=0)
    save_hf_checkpoint(str(dpm_dir), unet, vae, scheduler_config=dict(
        SD21_SCHEDULER, _class_name="DPMSolverMultistepScheduler"))
    del unet, vae
    torch.cuda.empty_cache()
    with _patched(presets, "build_config",
                  lambda build: lambda argv: build(list(argv) + [f"model.model_dir={dpm_dir}"])):
        dpm_runs = [session(dpm_out, 1), session(dpm_out, 1)]
    shutil.rmtree(dpm_dir)
    dpm_meta, dpm_data = read_state(str(dpm_out / "state" / "grid_state.d4d"))
    dpm = {"runs": dpm_runs, "state": dpm_meta,
           "arrays": {k: [str(v.dtype), list(v.shape), int(v.nbytes)]
                      for k, v in dpm_data.items()},
           "state_bytes": (dpm_out / "state" / "grid_state.d4d").stat().st_size}
    del dpm_data
    res["dpm"] = dpm
    for r in dpm_runs:
        ph = r["phases"]
        log(f"demo4d_prod DPM++: resumed at {r['resumed_rounds']} + {r['resumed_tasks']}, "
            f"{r['tasks_run']} task in {r['run_s']:.2f} s, state {dpm['state_bytes']} bytes: "
            f"save_state d2h {ph['save_state/d2h']['total_s']} s + write "
            f"{ph['save_state/write']['total_s']} s, resume load "
            f"{ph.get('resume/load', {}).get('total_s')} s, peak {r.get('peak_gb')} GB")
    log(f"demo4d_prod: {json.dumps(res)}")
    got = [(r["rc"], r["resumed_rounds"], r["resumed_tasks"], r["tasks_run"]) for r in runs]
    n_tem = temporal["by_domain"].get("temporal", {})
    n = PROD_TEMPORAL_TASKS
    if got != [(0, 0, 0, 2), (0, 0, 2, 1), (0, 1, 0, n)] or (
            meta["completed_rounds"], meta["tasks_done_in_round"]) != (0, 3) or (
            tem_meta["completed_rounds"], tem_meta["tasks_done_in_round"]) != (1, n) or (
            n_tem.get("tasks"), n_tem.get("streamed"), n_tem.get("windows")) != (n, n, 75 * n) or (
            temporal["chunks"], temporal["windows_per_chunk"]) != (15 * n, [5]):
        raise AssertionError(f"demo4d_prod: runs {got}, states {meta} / {tem_meta}, "
                             f"temporal task {temporal}")
    got = [(r["rc"], r["resumed_rounds"], r["resumed_tasks"], r["tasks_run"]) for r in dpm_runs]
    if got != [(0, 0, 0, 1), (0, 0, 1, 1)] or sorted(dpm["arrays"]) != [
            "aux_has_prev", "aux_prev_x0", "latents", "t_idx"]:
        raise AssertionError(f"demo4d_prod DPM++: runs {got}, state {dpm}")

    # demo4d_slice: one spatial and one temporal task of the full grid at
    # production shapes, CFG fused on both (the script's pipeline), then the
    # state written and resumed
    from diffuman4d_torch import demo4d_slice

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = demo4d_slice.main(["--scene", str(scene), "--out", str(work / "prod_slice_out")])
    lines = buf.getvalue().strip().splitlines()
    log("\n".join(x for x in lines if x.startswith("[slice]")))
    res["slice"] = json.loads(lines[-1]) if rc == 0 else {"rc": rc}
    torch.cuda.empty_cache()
    tasks = res["slice"].get("tasks", {})
    if rc != 0 or res["slice"]["grid"][:2] != [48, 150] or \
            [tasks.get(d, {}).get("rows") for d in ("spatial", "temporal")] != [48, 300]:
        raise AssertionError(f"demo4d_prod: demo4d_slice exited {rc}: {res['slice']}")
    return res


# the units phase: the port's per-unit measurement tools at full width, in
# this process, each at a few calls (warm-up, then one window of --iters)
UNITS_TOOLS = (
    ("profile_units", ["--iters", "2"]),
    ("profile_unet_units", ["--iters", "2"]),
    ("profile_vae", ["--iters", "2"]),
    ("profile_vae_conv", ["--iters", "2"]),
    ("profile_window", ["--iters", "1", "--domain", "spatial"]),
    ("attn_ceiling", ["--iters", "3"]),
    ("bench_flash_backward", ["--iters", "1"]),
)


def phase_units(out_dir: Path, smi: str) -> dict:
    """The measurement tools' entry points (``main``) at full width, each
    writing its JSON under ``out_dir``; counters zeroed just before the
    tools and read just after (every attention launch on the kernel the
    table routes its shape to, and the window step's shapes among them)."""
    import importlib
    import io

    import torch

    from diffuman4d_torch.ops import flash_attention as fa, flash_backward as fb

    out_dir.mkdir(parents=True, exist_ok=True)
    wrappers = {**_path_wrappers(), "flash_fwd_lse": fb.flash_fwd_lse,
                "flash_bwd": fb.flash_bwd}
    _reset(wrappers.values())
    tools = {}
    for name, argv in UNITS_TOOLS:
        tool = importlib.import_module(f"diffuman4d_torch.{name}")
        out = out_dir / f"{name}.json"
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = tool.main([*argv, "--windows", "1", "--out", str(out)])
        secs = time.perf_counter() - t0
        (out_dir / f"{name}.log").write_text(buf.getvalue())
        rep = json.loads(out.read_text())
        results = rep["results"]
        ms = [r["ms"] for r in results.values() if isinstance(r, dict) and "ms" in r]
        ms += [r[k]["ms"] for r in results.values() for k in ("train", "library")
               if isinstance(r.get(k), dict) and "ms" in r[k]]
        ms += [r[k] for r in results.values() for k in ("flash_ms", "attn_ms") if k in r]
        tools[name] = {"rc": rc, "s": secs, "records": len(results), "card": rep["card"]}
        log(f"units {name}: rc {rc}, {len(results)} records, {secs:.1f} s, fastest "
            f"{min(ms):.4f} ms, slowest {max(ms):.2f} ms ({rep['card']['name']}, "
            f"{rep['card']['power_limit']})")
        torch.cuda.empty_cache()
        if rc != 0 or not ms or not all(math.isfinite(x) and x > 0 for x in ms):
            raise AssertionError(f"units: {name} exited {rc} with times {ms}")
    launches, shapes = _kernel_counts(wrappers)
    routed = _check_routes(fa.KERNELS, [(B, S, S, H, 64) for B, S, H in SLICE_ATTN64_SHAPES])
    log(f"units ({smi}): launches {launches}")
    for name in ("flash_fwd_d512", "conv3x3", "flash_fwd_lse", "flash_bwd"):
        if not launches[name]:
            raise AssertionError(f"units: {name} never launched: {launches}")
    return {"tools": tools, "launches": launches, "shapes": shapes, "routed": routed}


def _d64_split(shapes) -> dict:
    """The d = 64 kernel serves two TPU kernels: 3D window attention (the
    CFG pair as batch 2) and per-frame attention (batch 2 L)."""
    window = sum(n for (B, *_), n in shapes.items() if B <= 2)
    return {"flash_fwd_d64_window": window,
            "flash_fwd_d64_frame": sum(shapes.values()) - window}


def _routed(B: int, S: int, Sk: int, H: int, D: int) -> tuple[str, dict]:
    """The kernel and every block size a launch at this shape takes under
    ``route``: the route's block sizes over the wrapper's defaults."""
    import inspect

    from diffuman4d_torch.ops import attention as attn
    from diffuman4d_torch.ops import flash_attention as fa

    name, params = attn.route((B, S, H, D), (B, Sk, H, D))
    defaults = inspect.signature(fa.KERNELS[name]).parameters
    return name, {p: params.get(p, defaults[p].default) for p in fa.BLOCK_PARAMS[name]}


def _check_routes(kernels: dict, expected) -> dict:
    """Every attention launch recorded in ``kernels[name].shapes`` must be
    the kernel and block sizes that ``route`` gives its shape, and each
    shape of ``expected`` (B, S, Sk, H, D) must have been launched where it
    routes. Returns {shape: "kernel(blocks)"} of ``expected``."""
    from diffuman4d_torch.ops import flash_attention as fa

    for name, fn in kernels.items():
        for B, S, Sk, H, *blocks in fn.shapes:
            D = 512 if name == "flash_d512" else 64
            want = _routed(B, S, Sk, H, D)
            if want != (name, dict(zip(fa.BLOCK_PARAMS[name], blocks))):
                raise AssertionError(f"attention B{B} S{S} Sk{Sk} H{H} ran on {name} {blocks}, "
                                     f"the table routes it to {want}")
    routed = {}
    for B, S, Sk, H, D in expected:
        name, params = _routed(B, S, Sk, H, D)
        key = (B, S, Sk, H, *params.values())
        if not kernels[name].shapes.get(key):
            raise AssertionError(f"attention {key} routes to {name}, which never ran it")
        routed[f"B{B}xS{S}xH{H}"] = f"{name}{tuple(params.values()) or ''}"
    log(f"  routes: {routed}")
    return routed



def _jpegs(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("images/*/*.jpg"))}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_waves(work: Path, smi: str) -> dict:
    """The multi-device sampling paths at world size 1 over NCCL, in a
    child process started as torchrun starts a rank (``RANK=0
    WORLD_SIZE=1``): see :func:`waves_child`."""
    out_json = work / "waves.json"
    env = {**os.environ, "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--waves-child",
                           str(out_json)], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=900)
    wall_s = time.perf_counter() - t0
    (work / "waves_child.log").write_text(proc.stdout + proc.stderr)
    for line in proc.stdout.splitlines():
        log(f"  {line}")
    if proc.returncode != 0:
        raise AssertionError(f"waves: child exit code {proc.returncode}: {proc.stderr[-3000:]}")
    res = json.loads(out_json.read_text())
    # the launched shapes as the other phases record them (JSON made them lists)
    res.update(wall_s=wall_s, card=smi,
               shapes={k: [tuple(x) for x in v] for k, v in res["shapes"].items()})
    log(f"waves ({smi}): NCCL {res['nccl']}, child {wall_s:.1f} s, serial {res['serial_s']:.2f} s,"
        f" waves {res['waves_s']:.2f} s, CP window step {res['cp']['cp_ms']:.1f} ms "
        f"(plain {res['cp']['plain_ms']:.1f} ms)")
    return res


def waves_child(out_json: str) -> int:
    """In a process that torchrun's variables name rank 0 of 1: the process
    group over NCCL (``parallel/distributed.initialize``); demo_4d's preset
    on the demo4d scene cut to 2 frames and one spatial round (two tasks),
    through the serial ``execute_tasks`` and through
    ``execute_tasks_parallel(make_mesh())`` (waves of one over the NCCL
    group), which must give equal grids, grid-state bytes and JPEGs, with
    launch counters zeroed just before each run and read just after; then
    one full-width no-CFG window step (16 frames at 128^2) through
    ``make_cp_unet_apply`` on the 1-rank model group, which must equal the
    plain forward with as many K/V all-gathers as ``cp_comm_budget``
    counts."""
    import numpy as np
    import torch

    from diffuman4d_torch import cli
    from diffuman4d_torch.configs.presets import build_config
    from diffuman4d_torch.ops import context_parallel as cpa
    from diffuman4d_torch.parallel import distributed as pdist
    from diffuman4d_torch.parallel.cp_unet import cp_comm_budget, make_cp_unet_apply
    from diffuman4d_torch.parallel.mesh import make_mesh
    from diffuman4d_torch.sampling import loader
    from diffuman4d_torch.utils.tracing import report

    work = ROOT / "build" / "smoke"
    t0 = time.perf_counter()
    if not pdist.initialize("cuda"):
        raise AssertionError("waves: initialize() saw no RANK / WORLD_SIZE")
    res = {"init_s": time.perf_counter() - t0, "backend": torch.distributed.get_backend(),
           "world": torch.distributed.get_world_size(),
           "nccl": ".".join(map(str, torch.cuda.nccl.version()))}
    log(f"waves: process group {res['backend']} (NCCL {res['nccl']}), world {res['world']}, "
        f"up in {res['init_s']:.2f} s")
    if res["backend"] != "nccl" or res["world"] != 1:
        raise AssertionError(f"waves: {res}")
    mesh = make_mesh()
    gathers = []
    all_gather = torch.distributed.all_gather

    def counting_all_gather(*a, **k):
        gathers.append(tuple(a[1].shape))
        return all_gather(*a, **k)

    torch.distributed.all_gather = counting_all_gather
    data_dir = _d4d_scene(work)
    argv = ["exp=demo_4d", f"data.data_dir={data_dir}", "data.scene_label=scene0",
            f"sampler.spa_label_range=[0,{D4D_CAMERAS},1]",
            f"sampler.tem_label_range=[0,{WAVES_FRAMES},1]",
            "sampler.input_spa_labels=[" + ",".join(map(str, D4D_INPUTS)) + "]",
            "sampler.alternation_rounds=1"]
    cfg = build_config(argv)
    pipe = loader.load_pipeline(cfg.model, cfg.sampler, cfg.data, device="cuda")
    wrappers = _path_wrappers()
    runs = {}
    with torch.no_grad():
        for name in ("serial", "waves"):
            out = work / f"waves_{name}"
            shutil.rmtree(out, ignore_errors=True)
            pipe.clear_condition_caches()
            sampler = cli.build_sampler(build_config(argv + [f"sampler.output_dir={out}"]), pipe)
            report(reset=True)
            _reset(wrappers.values())
            gathers.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "serial":
                sampler.execute_tasks()
            else:
                sampler.execute_tasks_parallel(mesh)
            torch.cuda.synchronize()
            launches, shapes = _kernel_counts(wrappers)
            runs[name] = {"s": time.perf_counter() - t0, "phases": report(reset=True),
                          "launches": launches, "shapes": shapes, "gathers": list(gathers),
                          "grid": sampler.grid_latents.clone(), "t_idx": sampler.grid_t_idx,
                          "state": Path(sampler._state_path).read_bytes(), "jpgs": _jpegs(out)}
            log(f"waves: {name} {runs[name]['s']:.2f} s, phases "
                + ", ".join(f"{k} {v['total_s']} s x{v['count']}"
                            for k, v in runs[name]["phases"].items()))
    serial, waves = runs["serial"], runs["waves"]
    res.update(serial_s=serial["s"], waves_s=waves["s"], phases=waves["phases"],
               serial_phases=serial["phases"], launches=waves["launches"],
               shapes=waves["shapes"], wave_gathers=waves["gathers"],
               jpgs=len(waves["jpgs"]),
               grid_equal=torch.equal(serial["grid"], waves["grid"]),
               t_idx_equal=bool(np.array_equal(serial["t_idx"], waves["t_idx"])),
               state_equal=serial["state"] == waves["state"],
               jpgs_equal=serial["jpgs"] == waves["jpgs"])
    del runs, sampler
    torch.cuda.empty_cache()

    # one no-CFG window step through the context-parallel apply
    unet, L, dev, lat = pipe.unet, WAVES_CP_FRAMES, pipe.device, pipe.latent_size
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((L, lat, lat, unet.config.in_channels), generator=gen,
                    device=dev).to(unet.dtype)
    pf = torch.randn((L, lat, lat, unet.config.block_out_channels[0]), generator=gen,
                     device=dev).to(unet.dtype)
    t = torch.full((L,), 500, device=dev)
    tem = torch.zeros((L,), dtype=torch.int32, device=dev)
    cp_fwd = make_cp_unet_apply(unet, mesh)
    with torch.no_grad():
        plain = unet(x, t, tem_indices=tem, num_frames=L, pose_features=pf)
        cpa.cp_attention_grouped.all_gathers = 0
        gathers.clear()
        cp = cp_fwd(x, t, tem, L, pose_features=pf)
        n_gathers = cpa.cp_attention_grouped.all_gathers
        n_collectives = len(gathers)
        plain_ms = cuda_ms(lambda: unet(x, t, tem_indices=tem, num_frames=L,
                                        pose_features=pf), iters=2)
        cp_ms = cuda_ms(lambda: cp_fwd(x, t, tem, L, pose_features=pf), iters=2)
    budget = cp_comm_budget(unet.config, num_frames=L, latent_hw=lat, groups=1, n_model=1)
    res["cp"] = {"frames": L, "equal": torch.equal(plain, cp), "rel_l2": _rel_l2(cp, plain),
                 "all_gathers": n_gathers, "budget": budget["expected_all_gathers"],
                 "collectives": n_collectives, "plain_ms": plain_ms, "cp_ms": cp_ms,
                 "finite": bool(torch.isfinite(cp).all())}
    torch.distributed.destroy_process_group()
    Path(out_json).write_text(json.dumps(res))
    log(f"waves: {json.dumps({k: v for k, v in res.items() if k != 'shapes'})}")

    want = {"grid_equal": True, "t_idx_equal": True, "state_equal": True, "jpgs_equal": True,
            "jpgs": D4D_CAMERAS * WAVES_FRAMES}
    if wrong := {k: (res[k], v) for k, v in want.items() if res[k] != v}:
        raise AssertionError(f"waves vs serial: (got, expected) {wrong}")
    # each wave all-gathers its latents and timestep indices over the data axis
    if len(res["wave_gathers"]) != 2 * WAVES_FRAMES:
        raise AssertionError(f"waves: collectives {res['wave_gathers']}")
    if missing := [k for k in ("flash_fwd_d64_window", "flash_fwd_d64_frame", "flash_fwd_d512",
                               "conv3x3") if not res["launches"].get(k)]:
        raise AssertionError(f"waves: {missing} never launched: {res['launches']}")
    c = res["cp"]
    if not (c["finite"] and (c["equal"] or c["rel_l2"] <= E2E_REL_TOL)
            and c["all_gathers"] == c["budget"] and c["collectives"] == c["budget"] + 1):
        raise AssertionError(f"waves: CP window step {c}")
    return 0


def phase_train_dp(work: Path, smi: str) -> dict:
    """Data- and tensor-parallel training at world size 1 over NCCL, in a
    child process started as torchrun starts a rank: see
    :func:`train_dp_child`."""
    out_json = work / "train_dp.json"
    env = {**os.environ, "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--train-dp-child",
                           str(out_json)], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=900)
    wall_s = time.perf_counter() - t0
    (work / "train_dp_child.log").write_text(proc.stdout + proc.stderr)
    for line in proc.stdout.splitlines():
        log(f"  {line}")
    if proc.returncode != 0:
        raise AssertionError(f"train_dp: child exit code {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    res = json.loads(out_json.read_text())
    res.update(wall_s=wall_s, card=smi,
               shapes={k: [tuple(x) for x in v] for k, v in res["shapes"].items()})
    m = res["mesh"]
    log(f"train_dp ({smi}): child {wall_s:.1f} s (set-up {res['setup_s']:.1f} s, the steps with "
        f"and without the mesh and their comparison {res['steps_and_compare_s']:.1f} s); "
        f"steps on the 1 x 1 mesh {m['step_s']} s, "
        f"without {res['plain']['step_s']} s; all-reduces {m['all_reduce_s']} s and "
        f"all-gathers {m['all_gather_s']} s in each step; peak {m['peak_gib']:.2f} GiB (without "
        f"{res['plain']['peak_gib']:.2f}); state {m['state_bytes']} B; launches "
        f"{res['launches']} (steps {m['launches']}, loop {res['loop_launches']}); loop "
        f"{res['loop']['s']} s; hull {res['vhull']}")
    return res


def _state_equal(a, b) -> dict:
    """Which parts of two train states (or state files' trees) differ:
    part -> number of tensors not equal bit for bit."""
    import torch

    def differ(x, y) -> bool:
        return not torch.equal(x, y.to(x.device))

    out = {"params": sum(differ(a["params"][k], v) for k, v in b["params"].items())}
    for slot, tree in b["opt_state"].items():
        if slot != "count":
            out[slot] = sum(differ(a["opt_state"][slot][k], v) for k, v in tree.items())
    return out


def train_dp_child(out_json: str) -> int:
    """In a process that torchrun's variables name rank 0 of 1: the process
    group over NCCL and a 1 x 1 mesh of it. Two AdamW steps of the
    full-width UNet through the mesh's train step and two without a mesh
    (bit-equal); the loop under the mesh, interrupted and resumed against
    uninterrupted (bit-equal); the visual hull on the card and on the CPU."""
    import numpy as np
    import torch

    from diffuman4d_torch.data import SpaTemDataset
    from diffuman4d_torch.ops import conv, flash_attention as fa, flash_backward as fb
    from diffuman4d_torch.parallel import distributed as pdist
    from diffuman4d_torch.parallel.mesh import make_mesh
    from diffuman4d_torch.preprocess.visual_hull import carve_scene
    from diffuman4d_torch.sampling.loader import build_models
    from diffuman4d_torch.sampling.pipeline import Diffuman4DPipeline
    from diffuman4d_torch.schedulers.diffusion import Scheduler, SchedulerConfig
    from diffuman4d_torch.training import trainer as pt
    from diffuman4d_torch.training.data import (
        WindowBatcher,
        WindowBatcherConfig,
        encode_training_batch,
    )
    from diffuman4d_torch.training.loop import LoopConfig, train

    work = ROOT / "build" / "smoke"
    t0 = time.perf_counter()
    if not pdist.initialize("cuda"):
        raise AssertionError("train_dp: initialize() saw no RANK / WORLD_SIZE")
    res = {"init_s": time.perf_counter() - t0, "backend": torch.distributed.get_backend(),
           "world": torch.distributed.get_world_size(),
           "nccl": ".".join(map(str, torch.cuda.nccl.version()))}
    if res["backend"] != "nccl" or res["world"] != 1:
        raise AssertionError(f"train_dp: {res}")
    mesh = make_mesh()
    comm = {"all_reduce": [], "all_gather": []}
    originals = {}
    for name in comm:  # time each collective, the card's queue drained around it
        originals[name] = fn = getattr(torch.distributed, name)

        def timed(*a, _fn=fn, _name=name, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = _fn(*a, **k)
            torch.cuda.synchronize()
            comm[_name].append(time.perf_counter() - t)
            return out

        setattr(torch.distributed, name, timed)

    unet, vae = build_models(device="cuda", dtype=torch.bfloat16, seed=0)
    pipe = Diffuman4DPipeline(unet, vae, Scheduler(SchedulerConfig()), image_size=1024,
                              vae_batch=4, device="cuda")
    dataset = SpaTemDataset(data_dir=_scene(work), scene_label="scene0", height=1024, width=1024)
    batcher = WindowBatcher(dataset, WindowBatcherConfig(
        window_size=TRAIN_L - 4, tem_labels=["000000"],
        input_spa_labels=["01", "05", "09", "13"]))
    raw = batcher.make_batch(np.random.default_rng(0), 1, "spatial")
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = encode_training_batch(pipe, raw, gen)
    t_fix, eps = pt.draw_noise(pipe.scheduler, gen, batch["latents_x0"].shape)
    torch.cuda.synchronize()
    res["setup_s"] = time.perf_counter() - t0  # the group, the models and one encoded batch
    start = {k: p.detach().clone() for k, p in unet.named_parameters()}
    wrappers = {"flash_fwd_lse": fb.flash_fwd_lse, "flash_bwd": fb.flash_bwd,
                "conv3x3": conv.conv3x3, "flash_fwd_d512": fa.KERNELS["flash_d512"]}
    tcfg = pt.TrainConfig()  # lr 1e-5, remat, AdamW, attention "train"

    def two_steps(on_mesh: bool) -> tuple:
        pt.sync_module(unet, start)
        m = mesh if on_mesh else None
        state = pt.create_train_state(unet, tcfg, m)
        step = pt.make_train_step(unet, pipe.scheduler, tcfg, "spatial", m)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for v in comm.values():
            v.clear()
        _reset(wrappers.values())
        out = {"losses": [], "grad_norms": [], "step_s": [], "all_reduce_s": [],
               "all_gather_s": []}
        for _ in range(2):  # the first step's first all-reduce brings up the communicator
            n = {k: len(v) for k, v in comm.items()}
            t = time.perf_counter()
            state, metrics = step(state, batch, t=t_fix, eps=eps)
            torch.cuda.synchronize()
            out["step_s"].append(time.perf_counter() - t)
            out["losses"].append(metrics["loss"].item())
            out["grad_norms"].append(metrics["grad_norm"].item())
            for k in comm:
                out[f"{k}_s"].append(sum(comm[k][n[k]:]))
        out.update(peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   launches={n: f.launches for n, f in wrappers.items()},
                   shapes={n: sorted(f.shapes) for n, f in wrappers.items()},
                   collectives={k: len(v) for k, v in comm.items()},
                   state_bytes=metrics["state_bytes"],
                   sharded=len(state.layout.dims) if state.layout else 0)
        return state, out

    mesh_state, res["mesh"] = two_steps(True)
    log(f"train_dp: mesh {json.dumps({k: v for k, v in res['mesh'].items() if k != 'shapes'})}")
    # to the host, so that the plain run's peak is its own
    on_host = {"params": {k: v.cpu() for k, v in mesh_state.params.items()},
               "opt_state": {slot: v if slot == "count" else {k: x.cpu() for k, x in v.items()}
                             for slot, v in mesh_state.opt_state.items()}}
    del mesh_state
    torch.cuda.empty_cache()
    plain_state, res["plain"] = two_steps(False)
    res["steps_differ"] = _state_equal(
        on_host, {"params": plain_state.params, "opt_state": plain_state.opt_state})
    res["steps_and_compare_s"] = time.perf_counter() - t0 - res["setup_s"]
    res["bit_equal"] = (res["mesh"]["losses"] == res["plain"]["losses"]
                        and res["mesh"]["grad_norms"] == res["plain"]["grad_norms"]
                        and not any(res["steps_differ"].values()))
    del on_host, plain_state
    torch.cuda.empty_cache()
    log(f"train_dp: 1 x 1 mesh vs plain, bit-equal {res['bit_equal']} "
        f"(tensors differing {res['steps_differ']})")

    # the loop under the mesh: 3 steps in one run with a state at step 2 (the loop also
    # writes one at its last step, as the JAX loop does), and that state resumed in a
    # second directory for the 3rd step; the two runs' states are compared as they return
    def loop(out: Path) -> tuple:
        pt.sync_module(unet, start)
        lcfg = LoopConfig(steps=3, batch_size=1, window_size=TRAIN_L - 4, checkpoint_every=2,
                          log_every=1, out_dir=str(out), seed=3, domains=("spatial",))
        t = time.perf_counter()
        state = train(pipe, batcher, lcfg, tcfg, mesh=mesh)
        torch.cuda.synchronize()
        return time.perf_counter() - t, state

    a, b = work / "train_dp_a", work / "train_dp_b"
    for d in (a, b):
        shutil.rmtree(d, ignore_errors=True)
    _reset(wrappers.values())
    s_a, want = loop(a)
    b.mkdir(parents=True)
    os.link(a / "state_0000002.pt", b / "state_0000002.pt")
    s_b, got = loop(b)
    res["loop_launches"] = {n: f.launches for n, f in wrappers.items()}
    # the path's launches and shapes: the mesh steps and the loop's run and resume
    res["launches"] = {n: res["mesh"]["launches"][n] + res["loop_launches"][n] for n in wrappers}
    res["shapes"] = {n: sorted(set(map(tuple, res["mesh"]["shapes"][n])) | set(f.shapes))
                     for n, f in wrappers.items()}
    pt.sync_module(unet, start)
    res["loop"] = {"s": [s_a, s_b],
                   "resumed_differ": _state_equal(pt.gather_train_state(got),
                                                  pt.gather_train_state(want)),
                   "step": [got.step, want.step],
                   "state_file_gb": (a / "state_0000003.pt").stat().st_size / 1e9,
                   "losses": [json.loads(x)["loss"] for x in
                              (a / "metrics.jsonl").read_text().splitlines()],
                   "resumed_losses": [json.loads(x)["loss"] for x in
                                      (b / "metrics.jsonl").read_text().splitlines()]}
    del got, want
    for d in (a, b):
        shutil.rmtree(d, ignore_errors=True)
    torch.distributed.destroy_process_group()
    for name, fn in originals.items():
        setattr(torch.distributed, name, fn)
    log(f"train_dp: loop {json.dumps(res['loop'])}, launches {res['loop_launches']}")

    # the synthetic scene's visual hull, on the card and on the CPU
    scene = Path(_scene(work)) / "scene0"
    hull = {}
    for device in ("cuda", "cpu"):
        out = work / f"vhull_{device}"
        t = time.perf_counter()
        paths = carve_scene(str(scene / "fmasks"), str(scene / "transforms.json"), str(out),
                            voxel_size=0.05, device=device)
        hull[device] = {"s": time.perf_counter() - t, "ply": Path(paths[0]).read_bytes()}
    res["vhull"] = {"cuda_s": hull["cuda"]["s"], "cpu_s": hull["cpu"]["s"],
                    "equal": hull["cuda"]["ply"] == hull["cpu"]["ply"],
                    "ply_bytes": len(hull["cuda"]["ply"])}
    Path(out_json).write_text(json.dumps(res))
    log(f"train_dp: visual hull {res['vhull']}")

    if not res["bit_equal"]:
        raise AssertionError(f"train_dp: the 1 x 1 mesh step differs from the plain step: "
                             f"{res['mesh']['losses']} vs {res['plain']['losses']}, "
                             f"{res['steps_differ']}")
    m = res["mesh"]
    if not all(math.isfinite(v) for v in m["losses"] + m["grad_norms"]):
        raise AssertionError(f"train_dp: non-finite loss or norm {m}")
    if m["sharded"] < 250 or m["collectives"] != {"all_reduce": 6, "all_gather": 2}:
        raise AssertionError(f"train_dp: {m['sharded']} sharded, collectives {m['collectives']}")
    if missing := [k for k in ("flash_fwd_lse", "flash_bwd", "conv3x3") if not m["launches"][k]]:
        raise AssertionError(f"train_dp: {missing} never launched in the mesh steps")
    if missing := [k for k in ("flash_fwd_d512", "conv3x3") if not res["loop_launches"][k]]:
        raise AssertionError(f"train_dp: {missing} never launched in the loop")
    if (any(res["loop"]["resumed_differ"].values()) or res["loop"]["step"] != [3, 3]
            or res["loop"]["resumed_losses"] != res["loop"]["losses"][2:]):
        raise AssertionError(f"train_dp: resumed loop vs uninterrupted {res['loop']}")
    if not res["vhull"]["equal"] or res["vhull"]["ply_bytes"] < 400:
        raise AssertionError(f"train_dp: visual hull {res['vhull']}")
    return 0


def phase_cp_shapes(gen, cache: dict) -> list:
    """Context parallelism's attention shapes (``CP_ATTN64_SHAPES``) on the
    kernel ``route`` gives each, against the plain version, each beside its
    Sq = Sk time (one rank attending the whole CFG group's queries). The
    temporal mid block (Sk 6,144, over the single pass's 4,096) must route
    to the d = 64 skewed kernel."""
    import torch

    out = []
    for B, Sq, Sk, H in CP_ATTN64_SHAPES:
        row = {}
        for tag, S in (("cp", Sq), ("full", Sk)):
            name, params = _routed(B, S, Sk, H, 64)
            row[tag] = {"kernel": name, **check_attention(B, S, Sk, H, 64, gen, name,
                                                          tuple(params.values()), cache)}
            torch.cuda.empty_cache()
        if Sk > 4096 and row["cp"]["kernel"] != "flash_d64":
            raise AssertionError(f"CP B{B} Sq{Sq} Sk{Sk} H{H} routes to {row['cp']['kernel']}")
        log(f"  CP B{B}xSq{Sq}xSk{Sk}xH{H}: {row['cp']['kernel']} {row['cp']['ms']:.3f} ms, "
            f"Sq = Sk {row['full']['ms']:.3f} ms ({row['cp']['ms'] / row['full']['ms']:.3f}x, "
            f"{Sq / Sk:.3f} of the queries)")
        out.append(row)
    return out


# -------------------------------------------------------------------- main
_FA = "diffuman4d_tpu/ops/flash_attention.py"
_FB = "diffuman4d_tpu/ops/flash_backward.py"
# name -> (source, the TPU kernel it replaces, results key of its checks,
# index of its headline check, phases whose runs count its launches: the
# first in which it launched). The sampling paths (demo4d, cli, slice,
# variants) launch whatever the committed table routes their shapes to: B10
# and the skewed-pipeline kernel (B1/B2) at the 3D and per-frame shapes, the
# single pass (B8) at the per-frame 32^2 level; the tuner launches every
# candidate.
PATHS = ("demo4d", "cli", "slice", "variants", "waves")
KERNEL_META = {
    "flash_fwd_d64_window": ("diffuman4d_torch/csrc/flash_attn_skew_hopper.cu",
                             f"{_FA}:342 (_flash_kernel_v4)", "flash_fwd_d64", 0,
                             (*PATHS, "tune", "units")),
    "flash_fwd_d64_frame": ("diffuman4d_torch/csrc/flash_attn_skew_hopper.cu",
                            f"{_FA}:199 (_flash_kernel_v3)", "flash_fwd_d64", 1,
                            (*PATHS, "tune", "units")),
    "flash_fwd_d512": ("diffuman4d_torch/csrc/flash_attn_d512.cu", f"{_FA}:54 (_flash_kernel)",
                       "flash_fwd_d512", 0, (*PATHS, "units")),
    "conv3x3": ("diffuman4d_torch/csrc/conv3x3_hopper.cu",
                "diffuman4d_tpu/ops/conv.py:46 (_conv_kernel)", "conv3x3", 2, (*PATHS, "units")),
    "flash_fwd_lse": ("diffuman4d_torch/csrc/flash_attn_hopper.cu", f"{_FB}:49 (_fwd_kernel)",
                      "flash_fwd_lse", 0, ("train", "units")),
    "flash_bwd": ("diffuman4d_torch/csrc/flash_attn_bwd.cu",
                  f"{_FB}:162 (_dkdv_kernel) and {_FB}:205 (_dq_kernel)", "flash_bwd", 0,
                  ("train", "units")),
    "flash_fwd_single_pass": ("diffuman4d_torch/csrc/flash_attn_single_hopper.cu",
                              f"{_FA}:463 (_flash_kernel_v5)", "flash_fwd_single_pass", 0,
                              (*PATHS, "tune", "units")),
    "flash_fwd_single_pass_batched": ("diffuman4d_torch/csrc/flash_attn_single_hopper.cu",
                                      f"{_FA}:530 (_flash_kernel_v6)",
                                      "flash_fwd_single_pass_batched", 0,
                                      (*PATHS, "tune", "units")),
    "flash_fwd_two_level": ("diffuman4d_torch/csrc/flash_attn_hopper.cu",
                            f"{_FA}:96 (_flash_kernel_v2)", "flash_fwd_two_level", 0,
                            (*PATHS, "tune")),
}

# kernels that replace no TPU kernel (the JAX package left the work to XLA):
# name -> (source, why it was added, then as in KERNEL_META)
PORT_KERNEL_META = {
    "groupnorm": ("diffuman4d_torch/csrc/groupnorm_hopper.cu",
                  "none: GroupNorm (+ SiLU), eager PyTorch moved ~60 bytes per element",
                  "groupnorm", 0, (*PATHS, "units")),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES + EXTRA_PHASES)}")
    ap.add_argument("--out", default=str(ROOT / "results" / "chip_smoke.json"),
                    help="where to write the full results as JSON")
    ap.add_argument("--waves-child", metavar="JSON", help=argparse.SUPPRESS)
    ap.add_argument("--train-dp-child", metavar="JSON", help=argparse.SUPPRESS)
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    if unknown := set(phases) - set(PHASES + EXTRA_PHASES):
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 2
    if not (ROOT / "diffuman4d_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} holds no diffuman4d_torch package", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if args.waves_child:  # the waves phase's rank process
        return waves_child(args.waves_child)
    if args.train_dp_child:  # the train_dp phase's rank process
        return train_dp_child(args.train_dp_child)

    smi = nvidia_smi_line()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    results: dict = {"card": smi, "failed": []}
    t_start = time.perf_counter()

    def run(name, fn, *a):
        log(f"== {name}")
        t0 = time.perf_counter()
        try:
            results[name] = fn(*a)
        except Exception as e:  # noqa: BLE001 -- every phase is reported, then the run fails
            import traceback

            traceback.print_exc()
            results["failed"].append(name)
            log(f"FAILED {name}: {type(e).__name__}: {e}")
        log(f"== {name}: {time.perf_counter() - t0:.1f} s")

    if "build" in phases or "kernels" in phases:
        run("build", phase_build)
    work = ROOT / "build" / "smoke"
    shutil.rmtree(work, ignore_errors=True)
    if "tune" in phases:
        run("tune", phase_tune, work)
        torch.cuda.empty_cache()
    if "bench" in phases:
        run("bench", phase_bench, work, smi)
    if "reference" in phases:
        run("reference_train", phase_reference_train)
        torch.cuda.empty_cache()
    if {"reference", "slice", "cli", "demo4d", "train", "profile"} & set(phases):
        from diffuman4d_torch.sampling.loader import build_models

        unet, vae = build_models(device="cuda", dtype=torch.bfloat16, seed=0)
        if "reference" in phases:
            run("reference", phase_reference, unet, vae)
        if "slice" in phases:
            run("slice", phase_slice, unet, vae, work)
            torch.cuda.empty_cache()
        if "cli" in phases:
            run("cli", phase_cli, unet, vae, work)
            torch.cuda.empty_cache()
        if "demo4d" in phases:
            run("demo4d", phase_demo4d, work)
            torch.cuda.empty_cache()
        if "train" in phases:  # moves the UNet's weights and puts them back
            run("train", phase_train, unet, vae, work)
        if "profile" in phases:
            run("profile", phase_profile, unet, vae, Path(args.out).parent)
        del unet, vae
        torch.cuda.empty_cache()
    if "variants" in phases:
        run("variants", phase_variants, work)
        torch.cuda.empty_cache()
    if "demo4d_prod" in phases:
        run("demo4d_prod", phase_demo4d_prod, work)
        torch.cuda.empty_cache()
    if "overlap" in phases:
        run("overlap", phase_overlap, work)
    if "train_run" in phases:
        run("train_run", phase_train_run, work, smi)
    if "waves" in phases:
        run("waves", phase_waves, work, smi)
    if "train_dp" in phases:
        run("train_dp", phase_train_dp, work, smi)
    if "units" in phases:
        run("units", phase_units, Path(args.out).parent / "units", smi)
    if "kernels" in phases and "build" not in results["failed"]:
        launched: dict = {}
        for phase in ("tune", "bench", "slice", "cli", "demo4d", "train", "variants", "waves",
                      "train_dp", "units"):
            for name, shapes in results.get(phase, {}).get("shapes", {}).items():
                launched[name] = list(launched.get(name, ())) + list(shapes)
        run("kernels", phase_kernels, launched)
    results["wall_s"] = time.perf_counter() - t_start

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    if results["failed"]:
        log(f"chip_smoke: FAILED phases {results['failed']}")
        return 1

    kernels = []
    for name, (source, replaces, key, idx, phase) in (KERNEL_META | PORT_KERNEL_META).items():
        checks = results.get("kernels", {}).get(key, [])
        head = checks[idx] if len(checks) > idx else {}
        ran = [p for p in ((phase,) if isinstance(phase, str) else phase) if p in results]
        if not ran:  # a partial run (--phases) drove none of this kernel's paths
            continue
        phase = next((p for p in ran if results[p]["launches"].get(name)), ran[0] if ran else None)
        launches = results.get(phase, {}).get("launches", {}).get(name)
        if launches == 0 or ("kernels" in results and not head):
            log(f"chip_smoke: FAILED kernel {name}: {launches} launches on the {phase} path, "
                f"{len(checks)} checks")
            return 1
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "launches_phase": phase,
            "max_abs_err": max((c["max_abs_err"] for c in checks), default=None),
            **{k: head.get(k) for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                        "tflops", "gb_per_s", "shape")},
        })
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
