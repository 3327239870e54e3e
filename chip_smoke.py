#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (asdslam_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. build the hand-written CUDA kernels from the sources in the checkout
   (one nvcc per source, started together) and print the card's name and
   power limit;
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes, on a tie/duplicate problem and on the contract's edge
   cases (every row gated out, n = 1, m = 1, ragged m, no window, duplicates
   across a tile and a cell boundary, non-finite positions, a large
   20000x20000 problem); each check also
   runs the kernel twice (bitwise-equal outputs) and shows, from the
   kernel's own tile summaries, that no culled tile pair holds a gated-in
   pair;
3. drive the fused tracking step at full width (make_extractor +
   make_track_step) at the KITTI shape (1241x376, 2000 features, 8 levels,
   an 8192-row candidate block) over chained frames of the synthetic
   corridor from a hand-built state, with launch counts reset just before
   and read just after; one frame is re-run with the plain matcher and
   compared, and the masked_nn arguments of that frame's two searches are
   recorded and checked as in phase 2;
4. time the step and each kernel (CUDA events, the whole wrapper call) beside
   its plain version and its bound, with the gated-in pairs, the share of
   live tile pairs and the host's enqueue time; the profiler's readings
   (device busy share, each CUDA kernel's device time) are taken last of
   all, after phase 5;
5. drive the whole system through its entry point: System.track_monocular in
   synchronous mode at the same shape with the trained ASDNet over 20 frames
   of the corridor (two-view bootstrap, fused tracking, keyframes, local
   mapping inline), twice from fresh Systems; check the bootstrap, the
   keyframes and their mapping passes, the tracked share, finiteness, the
   sim3 ATE against the renderer's ground truth, that masked_nn was launched
   from the fused step and from the fuse, and that both runs give bitwise
   equal trajectories; hold masked_nn against its plain version on a fuse
   call's recorded inputs and time it; print the bootstrap's, a mapping
   pass's and the frames' times;
6. the default configuration: System(SlamConfig(), do_loop_closing=True)
   (pipelined tracking, the asynchronous mapping worker, loop closing with
   its online vocabulary) at the same shape over the circle of
   tests/test_e2e_loop.py, twice from fresh Systems with the synchronous
   mode run between them on the same frames; check a closed loop, the
   keyframe sim3 ATE, bitwise-equal frame and keyframe trajectories,
   accepted loops and map counts, no worker alive after finish(), every
   returned pose finite; queue _dispatch_fused for chained frames under
   torch.cuda.set_sync_debug_mode("error"); count masked_nn's launches at
   the loop closer's two call sites and hold it against its plain version
   on their recorded inputs; print frames/s of both modes, the calls that
   inserted keyframes, the join waits, phase B's and the loop closer's
   spans;
7. localization mode, persistence and EuRoC's lens, each in the config's
   default mode (pipelined, asynchronous):
   a. save_map of phase 5's second System; load_visual_map -> save_visual_map
      reproduces the file byte for byte; System(localization_mode=True)
      .load_map (its vocabulary trained from the map) tracks the same 20
      frames: no keyframe added, at least half tracked, the median distance
      of its camera centres to phase 5's trajectory under its bar,
      masked_nn launched from the step, chained dispatches clean under
      set_sync_debug_mode("error"); then relocalization on the card (the
      rich map accepted with >= 50 inliers, the relocalization's widening
      search run from that pose, which launches masked_nn and is held
      against its plain version, a thin map of 40 points rejected);
   b. the same file with cfg.loc_extend_map over frames 10-39 of the
      corridor: keyframes added beyond the prior map, the prior-map flags
      (every loaded keyframe flagged, no new one), more than 50 new
      unflagged points, the sim3 ATE of the tracked frames under its bar;
   c. EuRoC's camera file (read_cam_info + config_from_cam_info at 752x480)
      and 20 frames of the corridor rendered through its radtan lens, the
      default configuration with loop closing: uv_und moved off uv by more
      than 1 px, the bootstrap, the tracked share, the sim3 ATE under its
      bar, masked_nn launched from the step, clean chained dispatches;
   and print each sub-phase's frames/s, median call and load_map time;
8. the port's entry points, each through its main(argv) in-process at the
   same full widths, with masked_nn's launches counted by call site:
   a. 30 frames of phase 5's corridor written as a KITTI layout (times.txt,
      image_0/%06d.png, a camera file), run_slam_torch.py over it with the
      trained ASDNet, saving the map, the online vocabulary, the result dump,
      visualization snapshots and the profile: its JSON line, the tracked
      share and keyframes under bars from the JAX package's run_slam.py on the
      same directory, the trajectory file, the map reproduced byte for byte
      by load -> save, the five result files, the snapshots;
   b. train_vocab_torch.py on that map, the vocabulary loaded back;
   c. run_slam_torch.py --localization on that map under that vocabulary over
      the first 20 frames: no keyframe added, the median camera-centre
      distance to 8a's trajectory under phase 7a's bar;
   d. display_map_torch.py on that map with a PLY: a finite mean reprojection
      error under its bar;
   e. eval_euroc_proxy_torch.py --frames 40 (752x480 through EuRoC's lens,
      loop closing on): the tracked share, keyframes and the ATE under bars from the
      JAX package's eval_euroc_proxy.py, the render span apart from
      tracking, and masked_nn held against its plain version on one of its
      local-map searches;
9. ASDNet training through train_asdnet_torch.py's main(argv), at the net's
   only width:
   a. a pair cache of 16 384 training and 4 000 held-out make_batch pairs
      (a CPU generator of fixed seed), 300 steps at the default batch of
      512: finite losses, the trained FPR@95 below the random ASDNet's and
      the classical descriptor's and within a band of the JAX package's
      train_asdnet.py on the same cache and flags; steps/s and train_s;
   b. a PhotoTour layout (8-bit BMP tiles, info.txt, an m50 list) written
      from make_batch(size=64) pairs, 20 steps through --phototour;
   c. run_slam_torch.py with 9a's weights over 20 frames of phase 5's
      corridor as a KITTI layout: the tracked share under phase 8a's bar,
      the keyframes, masked_nn's launches by site, and masked_nn held
      against its plain version on one of its local-map searches;
10. the ORB descriptor path, K1 at d = 256, the assignment engines and the
   native host library:
   a. K1 at d = 256 against its plain version as in phase 2 (twice bitwise,
      the culling from its own tile summaries) on the motion and local-map
      shapes, the tie problem, every edge case, and a motion search between
      the ORB features of two corridor frames with duplicated columns,
      where the kernel must equal the plain version bit for bit;
   b. the fused tracking step with the ORB extractor (make_extractor(cfg,
      orb.apply, rotate_patches=True) + make_track_step) at the same full
      width over 8 chained frames from phase 3's hand-built state: 24 K1
      launches at d = 256, n_inliers and the pose error under bars from the
      JAX package's same chain on a CPU, one frame against the plain
      matcher, that frame's two searches against the plain version bit for
      bit; frames/s and the ORB extraction's ms beside the ASD one's;
   c. both assignment engines on a masked 500x400 score matrix on the card,
      equal to the port's CPU result;
   d. the native library: its build log, phase 8a's 30 PNGs decoded by it
      bit for bit as by the numpy decoder, the prefetching loader over them
      in order, phase 5's map written by it byte for byte as by the struct
      writer and read back, and phase 8a having decoded through it;
11. the multi-device path (asdslam_torch/parallel/), every shard on the one
   card (the mesh places shards round-robin on the cards there are):
   a. the point-major BA step on tests/multihost_child.py's problem (numpy,
      seed 42) over 1, 2, 4 and 8 shards against each other and against the
      port's CPU result, three steps on 8 shards (the error below 0.05 of
      its start, the fixed camera unmoved), the reduced elements equal at 64
      and 1024 points and within the camera-block bound, two runs bitwise;
   b. phase 6's loop-closed map (KITTI shape) through LoopCloser._global_ba
      at n_devices 2 and 8 (routed through _global_ba_mesh), against each
      other, finite and moved; the mean reprojection error before and after
      and each call's time beside the one-device global_bundle_adjust;
   c. multi_seq.make_dp_track_step at the KITTI shape over 4 chained frames
      from phase 3's hand-built state (sequence b's frames darkened by
      5% (b % 4) + 1% (b // 4)), each shard one batched step (torch.func.vmap
      of the single step, one CUDA graph per shard and batch size): 4 shards
      of one sequence, then one shard of 1, 4 and 16 sequences; in each run
      3 masked_nn launches a frame per shard (48, 12, 12, 12), nothing
      reduced, every sequence's features and result bit for bit its single
      step, tracking held; ms a frame and sequence-frames/s of the batched
      step beside the per-sequence loop (the single step once per sequence,
      kept here only for the comparison), each graph's pool bytes; the
      batched local-map search of the 4- and 16-sequence runs, one launch,
      held bit for bit to its per-problem launches and each problem to the
      plain version (check_k1), timed beside the B single launches and the
      bound at B times the bytes;
   d. the trained ASDNet on one frame's 2000 patches over 4 shards against
      the whole batch;
   e. processes (this script run as ``--multihost-child``, started at the
      phase's start): two ranks on the card over gloo (init_multihost's
      rule) agreeing with each other and with the in-process 2-shard mesh,
      and one NCCL rank at world size 1 bitwise the in-process 1-shard mesh;
   and prints a `multi_device` JSON line;
12. the last of the JAX repository's surfaces, through the port's own entry
   points:
   a. System.save_debug_image on phase 5's second System over its last
      keyframe's frame (no matplotlib): the returned dict equals
      debug_info()'s, the PNG reads back (this script's own decoder) equal
      to the drawn overlay with the title in its tEXt chunk, every
      reprojection's pixel red;
   b. eval_kitti_proxy_torch.py at full width (1241x376, KITTI 03's
      intrinsics) over 40 frames of each of two synthetic KITTI-like ground
      truths that the phase writes (KITTI_PATHS), the first also with K1
      replaced by its plain version on the card and with its frames
      rendered on the CPU: the tracked share and
      each of the three ATEs under a bar from the JAX package's
      eval_kitti_proxy.py on the same files, masked_nn's launches by site,
      and K1 against its plain version on a local-map search of the run;
      each CPU-rendered frame rendered on the card too, and five frames of
      the EuRoC proxy on both: the pixels that differ, those moved by more
      than 1e-5 (in each frame at most 0.1% of them,
      tests/test_torch_proxy.py's bar) and the largest difference (in each
      frame at most 1e-6: the card's render is the CPU's but for the last
      bits);
   c. mfu_bench_torch.py and profile_stages_torch.py in-process: their JSON
      lines, every share of the roofline table in (0, 1.05], seven stages;
      the matcher rows are logged beside phase 4's K1 times at the same
      shapes;
13. the port's inverses and solves on singular input, and the LM loops:
   a. the degenerate inputs that tests/test_torch_singular.py feeds to both
      packages (singular_inputs: the two-view bootstrap with every feature
      at one pixel, a singular T2 or K, singular homographies, PnP,
      triangulation, the essential graph and global BA with a non-finite
      input, sim3_log at s = 0, inv3x3 of a zero block) on the card against
      the CPU: the same finiteness pattern, the same values within each
      test's bar;
   b. the host synchronisations of optimize_pose_graph and
      global_bundle_adjust (set_sync_debug_mode("warn")) at 1 and 3 LM
      iterations, which must be equal: the setup reads index tables back,
      the loops nothing;
14. the CUDA-graph capture (asdslam_torch/utils/graphs.py, the reference's
   jax.jit), each site against its ``.eager`` on the same inputs:
   a. phase 3's step over 8 chained frames captured and eager: every output
      bitwise equal frame by frame, masked_nn's 3 launches a frame counted
      through the replays; ms a frame by host clock and CUDA events for
      both, the graph's pool size, and (with the profiler's readings, last)
      the device's idle share, K1's device time inside the graph and the
      largest kernels; its extractor, and the same through EuRoC's lens
      (with_undistortion), on 3 frames twice: bitwise equal, ms of both;
   b. frame k + 1 queued before frame k is fetched: every fetched frame
      equals the eager chain's (the returned outputs are clones);
   c. the essential graph, global BA and the largest local BA on their
      arguments recorded in phase 6's first run, and bench_torch.py's local
      BA (64 cameras, 4096 points): captured bitwise equal to eager, host ms
      of both (the captured first call with its warm-up and capture apart);
   d. phase 5's synchronous System over its 20 frames with every site
      eager: the frame trajectory bitwise the captured run's; frames/s of
      both (phase 6's dispatch check ran on the captured step).

15. the reference's remaining jit sites (JIT_SITES: the loop funnel, the
   keyframe pass, relocalization and the staged track, the bootstrap, the
   BoW descent), each a module-level graphs.captured callable, recorded by
   SiteLog from phase 5 to phase 8 (each call's host ms and what it did:
   warm-up, capture or replay; the arguments of each site's first call in
   phases 6-8):
   a. each site on its recorded arguments: ``.eager``, then warm-up,
      capture and replay, bit for bit; host ms of each beside the process's
      first call and its captures and replays in phases 5-8; each site's
      keys, shapes and pool bytes (the triangulation one shape, the fuse at
      most four);
   b. the Sim3 stages of phase 6's first run up to its first loop, each
      split into the sites' calls, the essential graph, global BA and the
      rest;
   c. the keyframe pass's padded slots: the replay on the recorded padded
      inputs against the same cut to the live slots (CUDA events);
   d. phase 6's default configuration once more with every JIT site eager:
      frame and keyframe trajectories and loops bitwise the captured first
      run's; frames/s of it and of phase 6's first and last captured runs;
   e. a fresh process (this script run as ``--sim3-first-calls``): the
      first and second calls of the Sim3 program's parts, where a process's
      first loop pays its one-off cost.
   ``python3 chip_smoke.py --phase15`` runs it alone.
16. the reference's last jit sites (LAST_SITES: the mesh BA step's two
   halves, the data-parallel descriptor's shard program, the ASDNet train
   step with its backward and update, the three renderers, the greedy
   engine, the 3D-3D Sim3 alignment), each a module-level graphs.captured callable whose calls in
   phases 5-8 SiteLog records:
   a. each site against its ``.eager``, bit for bit, through a fresh
      callable (warm-up, capture, replays): the halves on 11a's problem at
      1, 2, 4 and 8 shards, and three whole steps captured and eager at
      each (all equal); phase 6's loop-closed map through _global_ba_mesh
      at n_devices 2 and 8, eager and captured (all equal); the shard
      program and dp_descriptor_fn on 11d's patches; five KITTI-proxy
      frames (render_boxes) and the five EuRoC-proxy frames of 12b
      (raycast_grid), each with and without depth, and five corridor
      frames (render_frame) pinhole and through EuRoC's lens; the greedy
      engine on 10c's 500x400 matrix; the 3D-3D Sim3 alignment (no
      caller on the system's paths) on its test problem; five train steps
      on 9a's pair cache
      from one snapshot, eager then captured, with cuDNN deterministic
      (parameters, running statistics and losses bitwise, no .grad left)
      and with its defaults (tests/test_torch_train.py's gpu bars);
   b. captured against eager: each site's ms (CUDA events where it is one
      call, host ms a frame for the renderers), its pool bytes, the mesh
      GBA's host ms beside the one-device captured GBA's, the train step's
      steps/s;
   c. 9a's training through train_asdnet_torch.py with the captured step
      and with the eager one: FPR@95 within 9a's band, steps/s.
   ``python3 chip_smoke.py --phase16`` runs it alone.

Prints a `kernels` JSON line before the last line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX or of the JAX package.
"""

import contextlib
import gc
import io
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

# phases 3 and 5 are kept short: phase 6 takes most of the time limit
N_CHAINED = 8          # frames of phase 3's chain
N_SYSTEM = 20          # frames of phase 5
# The JAX package's System on the same 20 frames and configuration, on a CPU
# (python tests/test_torch_system.py --reference-ate 0.3 0.004 20): 19 of 20
# tracked, 3 keyframes, sim3 ATE 0.022411 m.  The port is held to twice that
# or 0.5 m, whichever is larger.
REFERENCE_ATE = 0.022411
ATE_BAR = max(2 * REFERENCE_ATE, 0.5)
STEP_M, TURN = 0.3, 0.004
# Phase 6: tests/test_e2e_loop.py's circle (a full turn in 110 frames plus 45
# of revisit) at the KITTI shape, and 12 frames past it for the dispatch check
N_LOOP, N_LOOP_EXTRA = 155, 12
LOOP_STEP, LOOP_TURN = 0.22, 2 * np.pi / 110
LOOP_SCENE = dict(floor_y=2.0, ceil_y=-3.0, left_x=-8.0, right_x=8.0, back_z=-8.0, front_z=16.0)
# The JAX package's System with SlamConfig() defaults (pipelined, asynchronous)
# and loop closing on the same 155 frames, trained ASDNet, on a CPU (python
# tests/test_torch_loop.py --reference-loop): 153 frames tracked, 27
# keyframes, one loop (keyframe 26 onto 3, at frame 126), keyframe sim3 ATE
# 0.0387 m over a 30.5 m path.  The port is held to max(2x that ATE, 2% of
# the path), tests/test_e2e_loop.py's bar.
REF_LOOP = dict(loops=1, keyframes=27, ate=0.03865, frame=126)
# Phase 7.  The JAX package on the same frames and configurations, on a CPU
# (python tests/test_torch_localization.py --reference-phase7): (a) from its
# synchronous map of phase 5's 20 frames (3 keyframes), a localization System
# tracks 19 of them, median camera-centre distance to the mapping run
# 0.000954; (b) loc_extend_map over frames 10-39: keyframes 3 -> 4, 253 new
# unflagged points, sim3 ATE 0.021652 m over 29 frames; (c) EuRoC's lens at
# 752x480: 19 of 20 tracked, 4 keyframes, sim3 ATE 0.013084 m.  Each bar is
# twice that or tests/test_localization_mode.py's / test_undistortion_e2e.py's
# own bar, whichever is larger.
REF_LOC = dict(median_centre_m=0.000954, extend_ate_m=0.021652, lens_ate_m=0.013084)
LOC_BAR = max(2 * REF_LOC["median_centre_m"], 0.05)
EXTEND_ATE_BAR = max(2 * REF_LOC["extend_ate_m"], 0.5)
LENS_ATE_BAR = max(2 * REF_LOC["lens_ate_m"], 0.5)
N_EXTEND, EXTEND_FIRST = 40, 10   # 7b: frames 10-39 of the corridor
N_DISPATCH = 6                    # chained dispatches of 7a's and 7c's checks
EUROC_CAM = ("458.654,457.296,367.215,248.375,-0.28340811,0.07395907,0.00019359,"
             "1.76187114e-05")    # EuRoC MH cam0: fx, fy, cx, cy, k1, k2, p1, p2
EUROC_W, EUROC_H = 752, 480
# Phase 8: the entry points.  8a: N_ENTRY frames of phase 5's corridor as a
# KITTI-layout directory; 8c: localization over its first N_ENTRY_LOC frames;
# 8e: the EuRoC proxy's first N_EUROC frames.
N_ENTRY, N_ENTRY_LOC, N_EUROC = 30, 20, 40
# The JAX package's scripts on the same inputs, on a CPU (python
# tests/test_torch_cli.py --reference-phase8): run_slam.py tracks 26 of the 30
# frames with 5 keyframes and 1067 points; in localization mode on its map 18
# of 20 frames; display_map.py on that map 0.76 px; eval_euroc_proxy.py
# --frames 40 tracks 37 with 4 keyframes, sim3 ATE 0.021 m.  The port is held
# to 70% tracked and the JAX keyframe count +-2 (8a), 2 px (8d), 75% tracked,
# the keyframe count +-2 and an ATE under 0.08 m (8e); 8c to phase 7a's bar.
# The port's own 40 EuRoC frames read 0.038 m on a CPU and 0.039 m on the
# card: the ~1% keypoint gap moves a 2.9 m path's ATE by that much, so 0.08 m
# is twice the port's and about four times the JAX package's.
REF_ENTRY = dict(run_slam=dict(tracked=26, keyframes=5, map_points=1067),
                 localization=dict(tracked=18, keyframes=5), display_map=0.76)
REF_EUROC = dict(tracked=37, keyframes=4, ate_m=0.021)
ENTRY_TRACKED_BAR, ENTRY_REPROJ_BAR = 0.7, 2.0
ENTRY_KF_RANGE = (REF_ENTRY["run_slam"]["keyframes"] - 2, REF_ENTRY["run_slam"]["keyframes"] + 2)
EUROC_TRACKED_BAR, EUROC_ATE_BAR = 0.75, 0.08
EUROC_KF_RANGE = (REF_EUROC["keyframes"] - 2, REF_EUROC["keyframes"] + 2)
# Phase 9: ASDNet training.  9a: a cache of N_POOL + N_HELD_OUT make_batch
# pairs (a CPU generator of seed 0) and train_asdnet_torch.py over it for
# N_STEPS steps of TRAIN_BATCH pairs; 9b: a PhotoTour layout of N_TOUR_POINTS
# 3D points, N_TOUR_STEPS steps; 9c: run_slam_torch.py with 9a's weights over
# phase 5's first N_TRAINED frames.  The JAX package's train_asdnet.py on the
# same cache and flags, on a CPU (python tests/test_torch_train.py
# --reference-phase9): FPR@95 trained 0.0003 (one false positive among the
# 4,000 held-out negatives), random 0.0838, classical 0.0318.  9a's trained
# FPR@95 is held within 0.0025 of it (ten false positives), below the random
# ASDNet's and the classical descriptor's; 9c to phase 8a's tracked share.
N_POOL, N_HELD_OUT, N_STEPS, TRAIN_BATCH = 16384, 4000, 300, 512
N_TOUR_POINTS, N_TOUR_STEPS, N_TRAINED = 512, 20, 20
REF_TRAIN = dict(fpr95_asd_trained=0.0003, fpr95_asd_random=0.0838, fpr95_patch_classical=0.0318)
TRAIN_FPR_BAND = 0.0025
# Phase 10b: the JAX package's fused step with the ORB extractor on the same
# hand-built state and 8 chained corridor frames at the KITTI shape, on a CPU
# (python tests/test_torch_orb.py --reference-phase10): n_inliers per frame
# and the largest |pose - ground truth| per frame.  Each frame's n_inliers is
# held to 90% of the JAX package's, and the pose error to twice its worst
# frame or 0.01 (twice the 5e-3 bar of tests/test_torch_orb.py between the
# packages' poses), whichever is larger.
REF_ORB = dict(n_inliers=[1982, 1984, 1981, 1823, 1770, 1738, 1671, 1624],
               max_pose_err=0.003814)
ORB_INLIER_SHARE = 0.9
ORB_POSE_BAR = max(2 * REF_ORB["max_pose_err"], 0.01)
ASSIGN_SHAPE = (500, 400)
# Phase 12b: eval_kitti_proxy_torch.py at full width over N_KITTI frames of
# each of two synthetic KITTI-like ground truths (KITTI_PATHS: a car that
# moves the first number of m a frame at 10 Hz, turning right by the second
# number of rad a frame) through KITTI 03's intrinsics.
N_KITTI = 40
KITTI_PATHS = {"right": (1.0, 0.01), "left": (0.8, -0.015)}
KITTI03_CAM = "721.5377,721.5377,609.5593,172.854"   # fx, fy, cx, cy
KITTI_ATES = ("ate_sim3_m", "ate_kf_sim3_m", "ate_frame_recomposed_m")
# The JAX package's eval_kitti_proxy.py on the same ground truths, on a CPU
# (python tests/test_torch_kitti_eval.py --reference-phase12): tracked of 40,
# keyframes and the three sim3 ATEs (frames, keyframes, recomposed) over a
# 39.0 m ("right") and a 31.2 m ("left") path.  The port is held to 75%
# tracked and each ATE under twice the JAX package's value of that ATE on
# that path.
REF_KITTI = {
    "right": dict(tracked=36, keyframes=16, ate_sim3_m=0.196, ate_kf_sim3_m=0.137,
                  ate_frame_recomposed_m=0.184),
    "left": dict(tracked=34, keyframes=16, ate_sim3_m=0.218, ate_kf_sim3_m=0.176,
                 ate_frame_recomposed_m=0.167),
}
KITTI_TRACKED_BAR = 0.75
KITTI_ATE_BARS = {path: {key: 2 * ref[key] for key in KITTI_ATES}
                  for path, ref in REF_KITTI.items()}


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, reps):
    """ms a call of ``fn``: one window of ``reps`` chained calls after a
    warm-up call, by CUDA events (the measurement scripts' timer)."""
    import torch
    from asdslam_torch.utils import roofline

    return roofline.time_ms(fn, torch.device("cuda"), reps, windows=1)


# --------------------------------------------------------------------------- #
# K1: masked_nn against its plain version
# --------------------------------------------------------------------------- #
def nn_problem(n, m, d=128, seed=0, ties=True):
    """A projection-search problem with genuine correspondences (the
    reference's tests/test_pallas_match.py problem, rebuilt with numpy):
    duplicate columns 100<-3 and m-1<-7, rows equal to a column, windows and
    levels that gate."""
    g = np.random.default_rng(seed)

    def unit(x):
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)

    a = unit(g.standard_normal((n, d)))
    b = unit(g.standard_normal((m, d)))
    half = min(n, m) // 2
    b[:half] = unit(a[:half] + 0.05 * g.standard_normal((half, d)))
    if ties:
        b[100] = b[3]
        b[m - 1] = b[7]
        a[:8] = b[3]
    uv_a = g.uniform(0, 600, (n, 2)).astype(np.float32)
    uv_b = g.uniform(0, 600, (m, 2)).astype(np.float32)
    uv_b[:half] = uv_a[:half] + 20 * g.standard_normal((half, 2))
    valid_a = g.uniform(size=n) > 0.1
    valid_b = g.uniform(size=m) > 0.1
    lvl_a = g.integers(0, 4, n).astype(np.int32)
    lvl_b = g.integers(0, 4, m).astype(np.int32)
    lvl_b[:half] = lvl_a[:half]
    radius = (60.0 + 40.0 * g.uniform(size=n)).astype(np.float32)
    skip_b = g.uniform(size=m) > 0.5
    valid_a[:40] = False  # a block of masked rows
    return dict(desc_a=a, desc_b=b, uv_a=uv_a, uv_b=uv_b, valid_a=valid_a,
                valid_b=valid_b & ~skip_b, levels_a=lvl_a, levels_b=lvl_b,
                rad2=radius * radius)


def edge_problem(case, d=128):
    """The contract's edge cases, built on the tie problem."""
    shape = {"ragged m 1100x2001": (1100, 2001), "large 20000x20000": (20000, 20000)}
    p = nn_problem(*shape.get(case, (300, 257)), d=d, ties=True, seed=11)
    r = np.sqrt(p["rad2"])
    if case == "all rows gated out":
        r[:] = 0.0
        p["uv_b"] += 0.5
    elif case == "n = 1":
        p = {k: (v[:1] if k in ("desc_a", "uv_a", "valid_a", "levels_a", "rad2") else v)
             for k, v in p.items()}
        p["valid_a"][0] = True
        r = r[:1]
    elif case == "m = 1":
        p = {k: (v[:1] if k in ("desc_b", "uv_b", "valid_b", "levels_b") else v)
             for k, v in p.items()}
        p["uv_a"][:] = p["uv_b"][0]
        p["valid_a"][:] = True
        p["valid_b"][:] = True
        p["levels_a"][:] = p["levels_b"][0]
    elif case == "duplicates across a tile and a cell boundary":
        p["desc_b"][64] = p["desc_b"][63]
        p["uv_b"][63] = (31.5, 100.0)
        p["uv_b"][64] = (32.5, 100.0)
        p["valid_b"][63:65] = True
        p["levels_b"][63:65] = 1
        p["desc_a"][:4] = p["desc_b"][63]
        p["uv_a"][:4] = (32.0, 100.0)
        p["valid_a"][:4] = True
        p["levels_a"][:4] = 1
        r[:4] = 5.0
    elif case == "non-finite positions":
        p["valid_a"][:8] = True
        p["uv_a"][0] = (np.nan, 10.0)
        p["uv_a"][1] = (np.inf, 10.0)
        p["uv_a"][2] = (-np.inf, np.inf)
        p["uv_a"][3] = (np.inf, 10.0)
        r[3] = np.inf
        r[4] = np.inf
        r[5] = np.nan
        p["uv_b"][5] = (np.nan, 3.0)
        p["uv_b"][6] = (np.inf, 3.0)
    p["rad2"] = None if case == "no window" else (r * r).astype(np.float32)
    return p


# the last: more entries than the sort keeps keys for in shared memory, one
# column split, and more column tiles than one pass of the live-tile list
EDGE_CASES = ("all rows gated out", "n = 1", "m = 1", "ragged m 1100x2001", "no window",
              "duplicates across a tile and a cell boundary", "non-finite positions",
              "large 20000x20000")


def k1_args(prob):
    """masked_nn's arguments on the card, optional ones filled as the
    wrapper fills them."""
    import torch
    from asdslam_torch.ops import masked_nn as k1

    t = {k: (None if v is None else torch.as_tensor(v).cuda()) for k, v in prob.items()}
    uv_a, uv_b, rad2, la, lb = k1._defaults(t["desc_a"], t["desc_b"], t["uv_a"], t["uv_b"],
                                            t["rad2"], t["levels_a"], t["levels_b"])
    return (t["desc_a"], t["desc_b"], t["valid_a"], t["valid_b"], uv_a, uv_b, rad2, la, lb,
            (-1.0, 1.0))


def check_k1(case, args, ratio=0.8, max_dist=1.2, best_tol=5e-5, bitwise=False):
    """Kernel vs plain on one set of arguments; raises on disagreement (|d|
    above 5e-5, or above ``best_tol`` on ``best``; with ``bitwise``, any
    difference in idx, best or second), on outputs that differ between two
    runs, or on a culled tile pair that holds a gated-in pair.  Returns (the
    larger of max |d best| and max |d second|, gated-in pairs, share of live
    tile pairs)."""
    import torch
    from asdslam_torch.ops import masked_nn as k1

    (idx, best, second), prep = k1.masked_nn_tiles(*args)
    again, _ = k1.masked_nn_tiles(*args)
    pidx, pbest, psecond = k1.masked_nn_plain(*args)
    torch.cuda.synchronize()
    for name, x, y in zip(("idx", "best", "second"), (idx, best, second), again):
        if not torch.equal(x, y):
            raise AssertionError(f"{case}: {name} differs between two runs")

    if bitwise:
        for name, x, y in zip(("idx", "best", "second"), (idx, best, second),
                              (pidx, pbest, psecond)):
            if not torch.equal(x, y):
                raise AssertionError(f"{case}: {name} differs from the plain version on "
                                     f"{int((x != y).sum())} rows (bitwise bar)")

    def ok_of(b, s):
        return (b <= max_dist) & (b < ratio * s)

    ok, pok = ok_of(best, second), ok_of(pbest, psecond)
    if not torch.equal(ok, pok):
        raise AssertionError(f"{case}: ok differs on {int((ok != pok).sum())} rows")
    clear = (psecond - pbest) > 1e-4
    if not torch.equal(idx[clear], pidx[clear]):
        raise AssertionError(f"{case}: idx differs on {int((idx[clear] != pidx[clear]).sum())} clear rows")
    gated_in = pbest < k1.BIG
    if not torch.equal(best >= k1.BIG, ~gated_in):
        raise AssertionError(f"{case}: masked rows differ")
    err = float((best[gated_in] - pbest[gated_in]).abs().max()) if gated_in.any() else 0.0
    serr = float((second - psecond)[psecond < k1.BIG].abs().max()) if (psecond < k1.BIG).any() else 0.0
    if err > min(5e-5, best_tol) or serr > 5e-5:
        raise AssertionError(f"{case}: |d best| {err} (bar {min(5e-5, best_tol)}), "
                             f"|d second| {serr} (bar 5e-5)")

    # the culling, from the kernel's own ordering and summaries
    gated = k1.gate_plain(*args[2:])
    culled, live = k1.culled_gated_pairs(prep, gated, args[9])
    if culled:
        raise AssertionError(f"{case}: culled tile pairs hold {culled} gated-in pairs")
    pairs_in, share = int(gated.sum()), float(live.float().mean())
    log(f"K1 {case}: N={args[0].shape[0]} M={args[1].shape[0]} d={args[0].shape[1]} ok rows "
        f"{int(ok.sum())}, gated-in rows {int(gated_in.sum())}, gated-in pairs {pairs_in}, live tile pairs "
        f"{share:.4f}, max|d best| {err:.3g}, max|d second| {serr:.3g}, two runs bitwise equal"
        + (", bitwise equal to the plain version" if bitwise else ""))
    return max(err, serr), pairs_in, share


def k1_full_args(args):
    """masked_nn's ten arguments from a call's ``args``, the optional inputs
    filled as the wrapper fills them."""
    from asdslam_torch.ops import masked_nn as k1

    a = list(args) + [(-1e9, 1e9)] * (10 - len(args))
    a[4:9] = k1._defaults(a[0], a[1], *a[4:9])
    return tuple(a)


def k1_bound_ms(args, pairs_in):
    """Least time for the function on these inputs: its bytes (each input
    read once, each output written once) over the memory rate, or the bf16
    dot of the pairs that pass the gates (what this data needs; a culling
    kernel does not evaluate the gate for every pair) over the bf16 peak,
    whichever is larger; a batched call's bytes are B problems'.  The counts are the roofline module's, which
    mfu_bench_torch.py's matcher rows use too."""
    from asdslam_torch.utils.roofline import H100, matcher_bytes, matcher_flops

    (n, d), m = args[0].shape[-2:], args[1].shape[-2]
    batch = args[0].shape[0] if args[0].ndim == 3 else 1  # a batched call's B problems
    t_bytes = batch * matcher_bytes(n, m, d) / H100["bytes"]
    t_ops = matcher_flops(pairs_in, d) / H100["bf16"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def k1_host_ms(args, reps=20):
    """Host ms per wrapper call to enqueue it (no synchronisation inside)."""
    import torch
    from asdslam_torch.ops import masked_nn as k1

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        k1.masked_nn(*args)
    return (time.perf_counter() - t0) * 1e3 / reps


def k1_device_ms(args, reps=20):
    """{kernel: device ms per call} from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from asdslam_torch.ops import masked_nn as k1

    device = {}
    for _ in range(3):  # a profile now and then comes back without device events
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                k1.masked_nn(*args)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            for name in ("order_kernel", "gather_kernel", "search_kernel"):
                if name in e.key:
                    t = getattr(e, "self_device_time_total", None)
                    t = getattr(e, "self_cuda_time_total", 0) if t is None else t
                    device[name] = t / 1e3 / reps
        if device:
            break
    return device


def record_searches(step, frames_u8, state, cand):
    """The masked_nn arguments of both searches of one chained frame (the
    wrapper is replaced for that frame only), from the step's ``.eager``: a
    replayed graph calls no Python, and a capture's arguments hold nothing
    yet (phase 14 holds the two bit for bit)."""
    from asdslam_torch.ops import masked_nn as k1

    calls, real = [], k1.masked_nn

    def recorder(*a):
        calls.append(a)
        return real(*a)

    k1.masked_nn = recorder
    try:
        run_chain(getattr(step, "eager", step), frames_u8, state, cand, 1, 1)
    finally:
        k1.masked_nn = real
    if len(calls) != 3:
        raise AssertionError(f"one frame made {len(calls)} masked_nn calls, not 3")
    # the narrow motion search (the wide one runs beside it and is kept only
    # where the narrow finds too few), the local-map search
    return calls[0], calls[2]


def orb_problem(cfg, extract, frames_u8, device):
    """masked_nn's arguments for a motion search between the features that
    the ORB extractor ``extract`` finds in two corridor frames (rows: frame
    0, columns: frame 1; windows of search_radius_motion * 1.2^level px),
    with columns 100<-3 and M-1<-7 duplicated.  ORB entries are +-1/16, so
    every dot and norm is exact in bf16 and f32 and distances tie wherever
    Hamming distances do."""
    import torch

    fa, fb = [extract(f.to(device).to(torch.float32) * (1.0 / 255.0)) for f in frames_u8[:2]]
    desc_b, valid_b = fb.desc.clone(), fb.valid.clone()
    m = desc_b.shape[0]
    desc_b[100], desc_b[m - 1] = desc_b[3], desc_b[7]
    valid_b[100], valid_b[m - 1] = valid_b[3], valid_b[7]
    scales = torch.tensor(cfg.scale_factors, device=device)
    r = cfg.search_radius_motion * scales[fa.level.long()]
    return (fa.desc.contiguous(), desc_b, fa.valid, valid_b, fa.uv.contiguous(),
            fb.uv.contiguous(), (r * r).contiguous(), fa.level, fb.level, (-1.0, 1.0))


# --------------------------------------------------------------------------- #
# The main path: the fused tracking step at full width
# --------------------------------------------------------------------------- #
def build_tracking(cfg, device, descriptor_fn=None, rotate_patches=False):
    """The main path's extractor, frames and hand-built state; the trained
    ASDNet unless ``descriptor_fn`` is given (the ORB path: orb.apply with
    ``rotate_patches``)."""
    import torch
    from asdslam_torch.frontend import track_step as ts
    from asdslam_torch.frontend.extractor import make_extractor
    from asdslam_torch.geometry import se3
    from asdslam_torch.io import synthetic
    from asdslam_torch.models.asdnet import ASDNet, load_weights

    K = torch.tensor([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1.0]])
    if descriptor_fn is None:
        descriptor_fn = ASDNet().to(device)
        weights = os.path.join(os.path.dirname(os.path.abspath(__file__)), "asdnet_weights.pkl")
        descriptor_fn.load_state_dict(load_weights(weights))
    extract = make_extractor(cfg, descriptor_fn, rotate_patches=rotate_patches)

    step_m, turn = STEP_M, TURN
    frames, poses = synthetic.render_sequence(
        K, N_SYSTEM, cfg.image_height, cfg.image_width, step=step_m, turn=turn,
        device=device)
    frames_u8 = [(f * 255.0).clamp(0, 255).to(torch.uint8).cpu() for f in frames]
    images = [f.to(device).to(torch.float32) * (1.0 / 255.0) for f in frames_u8[:6]]

    # State as the tracker holds it after frame 0: the previous frame's
    # features and their map points, and a local-map candidate block of
    # local_ba_max_points rows (map points of the first frames' features).
    N, P = cfg.n_features, cfg.local_ba_max_points
    feats = [extract(img) for img in images]
    rows = []
    for i, f in enumerate(feats):
        geo = synthetic.map_points(poses[i], K, f.uv, f.level, f.valid,
                                   cfg.scale_factor, cfg.n_levels)
        keep = f.valid.nonzero()[:, 0]
        rows.append([x[keep] for x in geo[:4]] + [f.desc[keep]])
    cand = [torch.cat([r[j] for r in rows])[:P] for j in range(5)]
    n_real = cand[0].shape[0]
    if n_real < P:
        raise AssertionError(f"candidate block has {n_real} < {P} real rows")
    cand = ts.PointBlock(pos=cand[0], normal=cand[1], min_dist=cand[2], max_dist=cand[3],
                         desc=cand[4].contiguous(),
                         valid=torch.ones(P, dtype=torch.bool, device=device))
    prev_feat = feats[0]
    prev_geom = ts.GeomBlock(*synthetic.map_points(
        poses[0], K, prev_feat.uv, prev_feat.level, prev_feat.valid,
        cfg.scale_factor, cfg.n_levels))
    vel = se3.pose_pack(*se3.se3_exp(torch.tensor([0.0, turn, 0.0, 0.0, 0.0, -step_m],
                                                  device=device)))
    state = dict(feat=prev_feat, geom=prev_geom, pose=poses[0].clone(), vel=vel,
                 crow=torch.full((N,), -1, dtype=torch.int32, device=device))
    return K, extract, frames_u8, poses, cand, state


def run_chain(step, frames_u8, state, cand, first, count):
    return [res for _, res in chain_outputs(step, frames_u8, state, cand, first, count)]


def chain_outputs(step, frames_u8, state, cand, first, count):
    """(feat, TrackResult) of each of ``count`` chained frames from ``first``."""
    feat, geom, pose, vel, crow = (state[k] for k in ("feat", "geom", "pose", "vel", "crow"))
    out = []
    for i in range(first, first + count):
        feat, res = step(frames_u8[i], pose, vel, feat, geom, cand, crow)
        geom, pose, vel, crow = res.next_geom, res.pose, res.velocity, res.crow
        out.append((feat, res))
    return out


def frame_latencies(step, frames_u8, state, cand, passes):
    """Host-clock ms of each chained frame, synchronised after each, over
    ``passes`` runs of the sequence from the same state."""
    import torch
    out = []
    for _ in range(passes):
        feat, geom, pose, vel, crow = (state[k] for k in ("feat", "geom", "pose", "vel", "crow"))
        for i in range(1, N_CHAINED + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            feat, res = step(frames_u8[i], pose, vel, feat, geom, cand, crow)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
            geom, pose, vel, crow = res.next_geom, res.pose, res.velocity, res.crow
    return np.array(out)


def layer_times(cfg, K, extract, frames_u8, state, cand, device):
    """One call of each layer of the step on frame 1's inputs: extraction,
    the two projection searches (kernel path) and one pose-only BA."""
    import torch
    from asdslam_torch.backend import ba
    from asdslam_torch.ops import match

    img = frames_u8[1].to(device).float() / 255.0
    feat = extract(img)
    prev, geom = state["feat"], state["geom"]
    scales = torch.tensor(cfg.scale_factors, device=device)
    r_prev = cfg.search_radius_motion * scales[prev.level.long()]
    r_cand = cfg.search_radius_local * torch.ones(cand.pos.shape[0], device=device)
    lvl_cand = torch.zeros(cand.pos.shape[0], dtype=torch.int32, device=device)
    Kd = K.to(device)
    inv_s2 = torch.tensor(cfg.inv_level_sigma2, device=device)[feat.level.long()]
    return {
        "extract": time_ms(lambda: extract(img), 5),
        "motion_search": time_ms(lambda: match.search_projection(
            prev.desc, feat.desc, prev.uv, feat.uv_und, prev.valid, feat.valid, r_prev,
            cfg.match_th_high, 1.0, prev.level, feat.level), 10),
        "pose_only_ba": time_ms(lambda: ba.pose_only_optimize(
            state["pose"], geom.pos, feat.uv_und, inv_s2, geom.valid & feat.valid, Kd), 3),
        # candidate rows placed at the features' positions, so the windows
        # gate about as densely as in the step
        "local_map_search": time_ms(lambda: match.search_projection(
            cand.desc, feat.desc, feat.uv_und[torch.arange(cand.pos.shape[0], device=device)
                                              % feat.uv.shape[0]].contiguous(),
            feat.uv_und, cand.valid, feat.valid, r_cand, cfg.match_th_high, 0.8,
            lvl_cand, feat.level), 10),
    }


def device_busy(step, frames_u8, state, cand):
    """(device kernel time, wall time, {K1 kernel: device ms a frame}, the
    five largest kernels as [(name, device ms a frame)]) in ms over 3
    chained frames, from torch.profiler with CUDA activity only (tracing the
    host's calls too slows the traced frames and takes a minute to
    summarise): the sum of device self time over all events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_chain(step, frames_u8, state, cand, 1, 3)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # the attribute's name changed across PyTorch versions
    attr = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    busy = sum(getattr(e, attr) for e in events) / 1e3
    k1_ms = {name: sum(getattr(e, attr) for e in events if name in e.key) / 1e3 / 3
             for name in ("order_kernel", "gather_kernel", "search_kernel")}
    top = sorted(((e.key, getattr(e, attr) / 1e3 / 3) for e in events), key=lambda x: -x[1])[:5]
    return busy, wall, k1_ms, top


# --------------------------------------------------------------------------- #
# Phase 5: the whole system through System.track_monocular
# --------------------------------------------------------------------------- #
def run_system(cfg, frames_u8, weights, device, record_fuse=False):
    """One fresh System over the frames.  Returns the system, per frame
    whether it was tracked, its host-clock ms and whether it inserted a
    keyframe, each mapping pass's report, masked_nn's launches from the
    fused step, from the fuse and in all, and (``record_fuse``) the
    arguments of the fuse's masked_nn calls."""
    import torch
    from asdslam_torch.frontend import track_step as ts
    from asdslam_torch.ops import masked_nn as k1
    from asdslam_torch.system import System

    system = System(cfg, asdnet_params=weights, device=device)
    counts = {"step": 0, "fuse": 0}
    fuse_calls = []

    def counted(fn, key):
        def wrapper(*a, **kw):
            before = k1.masked_nn.launches
            out = fn(*a, **kw)
            counts[key] += k1.masked_nn.launches - before
            return out
        return wrapper

    # the mapper's fuse (LocalMapper._fuse_pairs) launches K1 from a captured
    # call: its warm-up runs in Python on real inputs (recorded), its capture
    # on buffers that hold nothing yet (skipped), its replays not at all
    real_fuse, real_nn = system.local_mapper._fuse_pairs, k1.masked_nn

    def fuse(*a, **kw):
        if not record_fuse:
            return real_fuse(*a, **kw)

        def recorder(*args):
            if not torch.cuda.is_current_stream_capturing():
                fuse_calls.append(args)
            return real_nn(*args)

        k1.masked_nn = recorder
        try:
            return real_fuse(*a, **kw)
        finally:
            k1.masked_nn = real_nn

    system.tracker._fused = counted(
        ts.make_track_step(cfg, system.K, system.extract, device=device), "step")
    system.local_mapper._fuse_pairs = counted(fuse, "fuse")
    passes = []
    real_process = system.local_mapper.process

    def process(kf):
        real_process(kf)
        passes.append(dict(system.local_mapper.last_pass))

    system.local_mapper.process = process
    tracked, ms, is_kf = [], [], []
    torch.cuda.synchronize()
    k1.masked_nn.launches = 0
    for i, frame in enumerate(frames_u8):
        n_kf = system.store.n_kf
        t0 = time.perf_counter()
        pose = system.track_monocular(frame, i)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        tracked.append(pose is not None)
        is_kf.append(system.store.n_kf > n_kf)
    launches = k1.masked_nn.launches
    return dict(system=system, tracked=tracked, ms=np.array(ms), is_kf=np.array(is_kf),
                passes=passes, counts=counts, launches=launches, fuse_calls=fuse_calls)


def check_system(run, again, poses_gt, cfg):
    """Phase 5's checks; raises on the first that fails.  Returns the ATE."""
    from asdslam_torch.utils import evaluate

    system, tracked = run["system"], run["tracked"]
    store, stats = system.store, system.stats()
    if store.n_kf < 2 or not any(tracked):
        raise AssertionError(f"the two-view bootstrap did not succeed: {stats}")
    boot = int(store.kf_frame_id[1])
    after = tracked[boot + 1:]
    if stats["n_keyframes"] < 3:
        raise AssertionError(f"no keyframe after the bootstrap: {stats}")
    if not run["passes"] or sum(p["new_points"] for p in run["passes"]) == 0:
        raise AssertionError(f"local mapping triangulated no point: {run['passes']}")
    bas = [p["local_ba"] for p in run["passes"] if p["local_ba"]]
    if not bas or not all(b["finite"] for b in bas):
        raise AssertionError(f"local BA did not run or left non-finite values: {run['passes']}")
    if sum(after) < 0.6 * len(after):
        raise AssertionError(f"tracked {sum(after)} of {len(after)} frames after the bootstrap")
    traj = system.frame_trajectory()
    if not all(np.isfinite(p).all() for _, p in traj):
        raise AssertionError("non-finite pose in the frame trajectory")
    if not (np.isfinite(store.mp_pos[store.mp_valid]).all()
            and np.isfinite(store.kf_pose[:store.n_kf]).all()):
        raise AssertionError("non-finite map point or keyframe pose")
    est = evaluate.camera_centers(traj)
    gt = evaluate.camera_centers([(i, p) for i, p in enumerate(poses_gt)])
    e, g = evaluate.associate_by_id(est, gt)
    ate = evaluate.ate_rmse(e, g, align="sim3")
    if not ate < ATE_BAR:
        raise AssertionError(f"sim3 ATE {ate:.4f} m >= {ATE_BAR} m")
    c = run["counts"]
    if c["step"] < 2 * sum(after) * 0.9 or c["fuse"] < 2:
        raise AssertionError(f"masked_nn launches: fused step {c['step']}, fuse {c['fuse']}")
    t2 = again["system"].frame_trajectory()
    if len(t2) != len(traj) or any(fa != fb or pa.tobytes() != pb.tobytes()
                                   for (fa, pa), (fb, pb) in zip(traj, t2)):
        raise AssertionError("two runs from fresh Systems gave different frame trajectories")
    log(f"system: {N_SYSTEM} frames, bootstrap on frames "
        f"({int(store.kf_frame_id[0])}, {boot}), tracked {sum(after)} of {len(after)} after it, "
        f"{stats}, mapping passes {len(run['passes'])} "
        f"(new points {[p['new_points'] for p in run['passes']]}, fuse pairs "
        f"{[p['fuse_pairs'] for p in run['passes']]}, local BA "
        f"{[(b['n_opt'], b['points'], b['obs'], b['k_max']) for b in bas]} as (n_opt, P, O, Kmax)), "
        f"sim3 ATE {ate:.4f} m (bar {ATE_BAR} m; the JAX package on a CPU: {REFERENCE_ATE} m), "
        f"masked_nn launches: fused step {c['step']}, fuse {c['fuse']}, all {run['launches']}; "
        f"a second run's trajectory is bitwise equal")
    return ate


def span_ms(tracer, path):
    """Mean ms per call of the spans ``span_stats`` selects, or None."""
    calls, total = span_stats(tracer, path)
    return total / calls if calls else None


def span_stats(tracer, path):
    """(calls, total ms) of the spans whose path is ``path`` or ends in
    "/" + ``path``."""
    hits = [v for k, v in tracer.spans.items() if k == path or k.endswith("/" + path)]
    return sum(h.count for h in hits), sum(h.total for h in hits) * 1e3


# --------------------------------------------------------------------------- #
# Phase 6: the default configuration (pipelined tracking, the asynchronous
# mapping worker, loop closing) through System.track_monocular
# --------------------------------------------------------------------------- #
LOOP_SITES = ("loop_guided", "loop_fuse")


def render_loop(cfg, device):
    """The circle of tests/test_e2e_loop.py at ``cfg``'s shape: a full turn
    in 110 frames plus a revisit, then N_LOOP_EXTRA frames more for the
    dispatch check.  Returns (uint8 frames on the host, poses [n, 7])."""
    import torch
    from asdslam_torch.io import synthetic

    K = torch.tensor([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1.0]])
    frames, poses = synthetic.render_sequence(
        K, N_LOOP + N_LOOP_EXTRA, cfg.image_height, cfg.image_width, step=LOOP_STEP,
        turn=LOOP_TURN, scene=synthetic.Scene(**LOOP_SCENE), device=device)
    frames_u8 = [(f * 255.0).clamp(0, 255).to(torch.uint8).cpu() for f in frames]
    return frames_u8, poses.cpu().numpy()


def run_default(cfg, frames_u8, weights, device, record=False):
    """One fresh System(cfg, do_loop_closing=True) over the first N_LOOP
    frames, then finish().  Returns the system, each call's pose, host ms
    and whether it inserted a keyframe, the wall time, masked_nn's launches
    in all and at the loop closer's two call sites, and (``record``) the
    masked_nn arguments of the first calls at those sites."""
    import torch
    from asdslam_torch.ops import masked_nn as k1
    from asdslam_torch.system import System

    system = System(cfg, asdnet_params=weights, do_loop_closing=True, device=device)
    lc = system.loop_closer
    for name, site in (("_guided_support", "loop_guided"),
                       ("_fuse_mps_into_kf", "loop_fuse")):
        def labelled(*a, _fn=getattr(lc, name), _site=site, **kw):
            with k1.call_site(_site):
                return _fn(*a, **kw)
        setattr(lc, name, labelled)
    recorded = {site: [] for site in LOOP_SITES}
    real_nn = k1.masked_nn

    def recorder(*args):
        # the loop closer's searches are captured: the first call of a key
        # (the warm-up) is recorded, its capture is not (its buffers hold
        # nothing yet), its replays run no Python
        site = getattr(k1._tls, "site", None)
        if site in recorded and len(recorded[site]) < 4 \
                and not torch.cuda.is_current_stream_capturing():
            recorded[site].append(k1_full_args(args))
        return real_nn(*args)

    poses, ms, is_kf = [], [], []
    torch.cuda.synchronize()
    real_nn.launches, real_nn.by_site = 0, {}
    if record:
        k1.masked_nn = recorder
    try:
        t_start = time.perf_counter()
        for i in range(N_LOOP):
            n_kf = system.store.n_kf
            t0 = time.perf_counter()
            poses.append(system.track_monocular(frames_u8[i], i))
            ms.append((time.perf_counter() - t0) * 1e3)
            is_kf.append(system.store.n_kf > n_kf)
        t0 = time.perf_counter()
        system.finish()
        torch.cuda.synchronize()
        finish_ms = (time.perf_counter() - t0) * 1e3
        wall = time.perf_counter() - t_start
    finally:
        k1.masked_nn = real_nn
    return dict(system=system, poses=poses, ms=np.array(ms), is_kf=np.array(is_kf),
                wall_s=wall, finish_ms=finish_ms, launches=real_nn.launches,
                by_site=dict(real_nn.by_site), recorded=recorded)


def check_dispatch_no_sync(system, frames_u8, first=N_LOOP, count=N_LOOP_EXTRA):
    """Queue the fused step for ``count`` chained frames from ``first`` (past
    the end of the sequence the system tracked) under
    torch.cuda.set_sync_debug_mode("error"): any synchronisation inside
    _dispatch_fused raises.  The frames are never committed; the tracker is
    left with nothing pending."""
    import torch

    tr = system.tracker
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(first, first + count):
            feat, res = tr._dispatch_fused(frames_u8[i])
            if feat is None:
                raise AssertionError(f"frame {i}: the fused path was not available")
            tr._pend = (i, feat, res, tr._cand_ids, tr._cand_epoch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if not torch.isfinite(res.pose).all():
        raise AssertionError("a dispatched frame's pose is not finite")
    tr._pend = None


def check_default(first, again, poses_gt):
    """Phase 6's checks; raises on the first that fails.  Returns (the
    keyframe trajectory's sim3 ATE, the path length)."""
    import threading
    from asdslam_torch.utils import evaluate

    system = first["system"]
    lc = system.loop_closer
    if system.tracker._map_thread is not None or any(
            t.name == "asdslam-mapping" and t.is_alive() for t in threading.enumerate()):
        raise AssertionError("a mapping worker is alive after finish()")
    if system.tracker._pend is not None:
        raise AssertionError("a frame is still pending after finish()")
    if not all(p is None or np.isfinite(p).all() for p in first["poses"]):
        raise AssertionError("a returned pose is not finite")
    if lc.n_loops_closed < 1:
        raise AssertionError(f"no loop closed: {lc.counters}, {system.stats()}")
    kf_traj = system.keyframe_trajectory()
    est = evaluate.camera_centers(kf_traj)
    gt = evaluate.camera_centers([(i, p) for i, p in enumerate(poses_gt[:N_LOOP])])
    e, g = evaluate.associate_by_id(est, gt)
    ate = evaluate.ate_rmse(e, g, align="sim3")
    path = float(np.linalg.norm(np.diff(np.stack([gt[i] for i in range(N_LOOP)]), axis=0),
                                axis=1).sum())
    bar = max(2 * REF_LOOP["ate"], 0.02 * path)
    if not ate < bar:
        raise AssertionError(f"keyframe sim3 ATE {ate:.4f} m >= {bar:.4f} m")
    other = again["system"]

    def same(ta, tb):
        return len(ta) == len(tb) and all(fa == fb and pa.tobytes() == pb.tobytes()
                                          for (fa, pa), (fb, pb) in zip(ta, tb))
    if not same(system.frame_trajectory(), other.frame_trajectory()):
        raise AssertionError("two runs gave different frame trajectories")
    if not same(kf_traj, other.keyframe_trajectory()):
        raise AssertionError("two runs gave different keyframe trajectories")
    if lc.accepted_log != other.loop_closer.accepted_log:
        raise AssertionError(f"accepted loops differ: {lc.accepted_log} vs "
                             f"{other.loop_closer.accepted_log}")
    if system.stats() != other.stats():
        raise AssertionError(f"map counts differ: {system.stats()} vs {other.stats()}")
    return ate, path, bar


def phase6(cfg, weights, device, card, errs, k1_cases, sites=None):
    """The default configuration over the loop sequence: two runs and, timed
    between them in the same process, the synchronous mode; the checks; the
    dispatch check; K1 at the loop closer's call sites.  Adds those calls to
    ``k1_cases`` / ``errs`` and returns the numbers for the JSON line and the
    first run's System (phase 11 reads its map) and the LM loops' arguments
    recorded in that run (phase 14c), and the first and last runs.  ``sites``, phase
    15's SiteLog, labels each run and times the worker's sites in the
    first."""
    frames_u8, poses_gt = render_loop(cfg, device)
    sync_cfg = cfg.replace(pipelined_tracking=False, async_mapping=False)
    sites = sites or SiteLog()  # (not entered: labels only)
    sites.phase, sites.keep, sites.timed = "6 first", True, set(LOOP_FUNNEL) | {"bow_descend"}
    with record_lm_calls() as lm_calls:
        first = run_default(cfg, frames_u8, weights, device, record=True)
    sites.phase, sites.timed = "6 sync", ()
    sync = run_default(sync_cfg, frames_u8, weights, device)
    sites.phase = "6 again"
    again = run_default(cfg, frames_u8, weights, device)
    ate, path, bar = check_default(first, again, poses_gt)
    check_dispatch_no_sync(again["system"], frames_u8)
    lc = first["system"].loop_closer
    by_site = first["by_site"]
    stats = first["system"].stats()
    log(f"default configuration: {N_LOOP} frames, {stats}, loops {lc.accepted_log} "
        f"(the JAX package on a CPU: {REF_LOOP}), funnel {lc.counters}, keyframe sim3 ATE "
        f"{ate:.4f} m over a {path:.2f} m path (bar {bar:.4f} m); a second run bitwise equal in "
        f"frame and keyframe trajectories, accepted loops and map counts; no worker alive after "
        f"finish(); _dispatch_fused queued {N_LOOP_EXTRA} chained frames under "
        f"set_sync_debug_mode('error'); masked_nn launches {first['launches']}, at the loop "
        f"closer {by_site}")
    sync_lc = sync["system"].loop_closer
    log(f"synchronous mode on the same frames: {sync['system'].stats()}, loops "
        f"{sync_lc.accepted_log}")

    out = {"frames": N_LOOP, "stats": stats, "loops": lc.accepted_log, "funnel": lc.counters,
           "ate_m": ate, "ate_bar_m": bar, "path_m": path, "launches": first["launches"],
           "by_site": by_site, "sync_stats": sync["system"].stats(),
           "sync_loops": sync_lc.accepted_log}
    for name, run in (("default", first), ("sync", sync), ("default_again", again)):
        ms, is_kf = run["ms"], run["is_kf"]
        tr = run["system"].tracer
        # the calls while a keyframe's worker may run (the overlap window
        # after each keyframe call) against the other calls without one
        after_kf = np.zeros(len(ms), bool)
        for k in np.nonzero(is_kf)[0]:
            after_kf[k + 1:k + 1 + cfg.mapping_overlap_frames] = True
        after_kf &= ~is_kf
        spans = {k: span_stats(tr, k) for k in (
            "join_mapping", "triangulate_sync", "mapping", "mapping/fuse", "mapping/local_ba",
            "loop_closing", "loop_closing/vocab_train", "loop_closing/bow",
            "loop_closing/detect", "loop_closing/sim3", "sim3/fuse",
            "sim3/essential_graph", "sim3/gba", "fused_track/kernel", "create_kf")}
        out[name] = {"fps": N_LOOP / run["wall_s"], "wall_s": run["wall_s"],
                     "finish_ms": run["finish_ms"],
                     "call_ms_median_no_kf": float(np.median(ms[~is_kf])),
                     "call_ms_median_after_kf": float(np.median(ms[after_kf])),
                     "call_ms_median_quiet": float(np.median(ms[~is_kf & ~after_kf])),
                     "keyframe_call_ms": [round(float(x), 1) for x in ms[is_kf]],
                     "spans_calls_total_ms": spans}
        log(f"{name}: {out[name]['fps']:.3f} frames/s over {N_LOOP} frames ({run['wall_s']:.1f} "
            f"s, finish() {run['finish_ms']:.1f} ms); median call without a keyframe "
            f"{out[name]['call_ms_median_no_kf']:.1f} ms (in the {cfg.mapping_overlap_frames} "
            f"calls after a keyframe {out[name]['call_ms_median_after_kf']:.1f}, the others "
            f"{out[name]['call_ms_median_quiet']:.1f}); calls that inserted keyframes "
            f"{out[name]['keyframe_call_ms']} ms [{card}]")
        log(f"  spans (calls, total ms): "
            + ", ".join(f"{k} {c} / {t:.1f}" for k, (c, t) in spans.items() if c) + f" [{card}]")
    # K1 at the loop closer's call sites, on their recorded inputs
    for site, case in zip(LOOP_SITES, ("loop guided search", "loop fuse")):
        if by_site.get(site, 0) < 1 or not first["recorded"][site]:
            raise AssertionError(f"masked_nn was not launched from {site}: {by_site}")
        args = max(first["recorded"][site], key=lambda a: int(a[2].sum()))  # most live rows
        err, pairs_in, share = check_k1(case, args)
        errs.append(err)
        k1_cases[case] = (args, pairs_in, share)
    return out, first["system"], lm_calls, (first, again)


# --------------------------------------------------------------------------- #
# Phase 7: localization mode on a saved map, loc_extend_map, EuRoC's lens
# --------------------------------------------------------------------------- #
@contextlib.contextmanager
def k1_sites():
    """Count masked_nn's launches inside the block by call site, from zero:
    the fused step ("step", both its dispatch and its synchronous use),
    relocalization ("reloc"), the keyframe fuse ("fuse"), and the rest
    ("other": the staged searches, the loop closer's).  Yields a dict that
    holds "launches" and "by_site" when the block ends; every Tracker built
    inside the block is counted."""
    from asdslam_torch.backend.local_mapping import LocalMapper
    from asdslam_torch.frontend.tracking import Tracker
    from asdslam_torch.ops import masked_nn as k1

    def labelled(fn, site):
        def wrapper(*a, **kw):
            with k1.call_site(site):
                return fn(*a, **kw)
        return wrapper

    patched = [(Tracker, name, getattr(Tracker, name), site)
               for name, site in (("_dispatch_fused", "step"), ("_try_fused", "step"),
                                  ("_relocalize", "reloc"))]
    patched.append((LocalMapper, "_fuse_pairs", LocalMapper._fuse_pairs, "fuse"))
    for owner, name, fn, site in patched:
        setattr(owner, name, labelled(fn, site))
    out, counted = {}, k1._COUNTED  # the wrapper's counts, whatever stands in for it
    counted.launches, counted.by_site = 0, {}
    try:
        yield out
    finally:
        for owner, name, fn, _ in patched:
            setattr(owner, name, fn)
    out["launches"], out["by_site"] = counted.launches, dict(counted.by_site)
    out["by_site"]["other"] = out["launches"] - sum(out["by_site"].values())


def drive(system, frames_u8, ids):
    """Track frames ``ids`` through system.track_monocular, then finish(),
    with masked_nn's launches counted by call site (``k1_sites``).  Returns
    the returned poses, each call's host ms, the wall time and the counts."""
    import torch

    poses, ms = [], []
    torch.cuda.synchronize()
    with k1_sites() as counts:
        t_start = time.perf_counter()
        for i in ids:
            t0 = time.perf_counter()
            poses.append(system.track_monocular(frames_u8[i], i))
            ms.append((time.perf_counter() - t0) * 1e3)
        system.finish()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
    return dict(poses=poses, ms=np.array(ms), wall_s=wall, **counts)


def load_localization(cfg, path, weights, device):
    """System(cfg, localization_mode=True) with ``path`` loaded; returns it
    and load_map's host ms (the vocabulary's training included)."""
    import torch
    from asdslam_torch.system import System

    system = System(cfg, asdnet_params=weights, localization_mode=True, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    system.load_map(path)
    torch.cuda.synchronize()
    return system, (time.perf_counter() - t0) * 1e3


def sim3_ate(system, poses_gt, ids):
    from asdslam_torch.utils import evaluate

    est = evaluate.camera_centers(system.frame_trajectory())
    gt = evaluate.camera_centers([(i, poses_gt[i]) for i in ids])
    e, g = evaluate.associate_by_id(est, gt)
    return evaluate.ate_rmse(e, g, align="sim3"), len(e)


def check_finite(system, run):
    store = system.store
    if not all(p is None or np.isfinite(p).all() for p in run["poses"]):
        raise AssertionError("a returned pose is not finite")
    if not (np.isfinite(store.mp_pos[store.mp_valid]).all()
            and np.isfinite(store.kf_pose[:store.n_kf]).all()):
        raise AssertionError("non-finite map point or keyframe pose")


def reloc_stages(tracker, feat, match_mod, pnp_mod, search="search_global", pnp="ransac_pnp"):
    """``tracker._relocalize(feat)`` with each candidate keyframe's fate
    recorded: the global search's matches, the PnP RANSAC's verdict and
    inliers, the pose-only BA's inliers, the widening searches' new
    bindings, and the stage that rejected it ("matches": too few matches to
    map points, "pnp", "pose-only BA", "inliers": under reloc_min_inliers
    after any widening; None: accepted).  Works on either package's Tracker:
    pass the modules it calls and the names it calls there (the JAX
    package's ops/match.py and estimators/pnp.py; the port's
    frontend/tracking.py with its captured "_search_global" and
    "_ransac_pnp").  Returns (accepted, the candidates' records)."""
    def host(x):
        return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)

    cands = []
    real = (getattr(match_mod, search), getattr(pnp_mod, pnp))

    def search_wrapper(*a, **kw):
        out = real[0](*a, **kw)
        cands.append(dict(matches=int(host(out[2]).sum()), stage="matches"))
        return out

    def pnp_wrapper(*a, **kw):
        res = real[1](*a, **kw)
        c = cands[-1]
        c.update(pnp=bool(host(res.success)), pnp_inliers=int(host(res.n_inliers)),
                 stage="pnp")
        return res

    def optimize(*a, **kw):
        ok = type(tracker)._optimize_current(tracker, *a, **kw)
        c = cands[-1]
        c.setdefault("ba_inliers", []).append(int(tracker.n_inliers) if ok else None)
        if "widened" not in c:
            c["stage"] = "inliers" if ok else "pose-only BA"
        return ok

    def widen(*a, **kw):
        n = type(tracker)._reloc_widen(tracker, *a, **kw)
        cands[-1].setdefault("widened", []).append(int(n))
        return n

    names = (search, pnp)
    setattr(match_mod, names[0], search_wrapper)
    setattr(pnp_mod, names[1], pnp_wrapper)
    tracker._optimize_current, tracker._reloc_widen = optimize, widen
    try:
        accepted = tracker._relocalize(feat)
    finally:
        setattr(match_mod, names[0], real[0])
        setattr(pnp_mod, names[1], real[1])
        del tracker._optimize_current, tracker._reloc_widen
    if accepted:
        cands[-1]["stage"] = None
    return accepted, cands


def reloc_acceptance(system, frames_u8, device):
    """Relocalization on the card (tests/test_localization_mode.py::
    TestRelocAcceptance): the rich map accepted with >= reloc_min_inliers;
    the relocalization's widening search (``Tracker._reloc_widen``, which a
    candidate with fewer than 50 inliers gets) run from the pose it found,
    against the keyframe whose points it bound most, with masked_nn's
    arguments recorded; then a thin map (40 of keyframe 0's points)
    rejected, with the stage that rejected each candidate recorded
    (``reloc_stages``).  Returns (the rich run's inliers, the widening's new
    bindings and masked_nn launches, the thin run's launches, the recorded
    arguments, the thin run's candidates).  Leaves the store thinned."""
    import torch
    from asdslam_torch.frontend import tracking
    from asdslam_torch.ops import masked_nn as k1

    tr, store = system.tracker, system.store
    feat = tr.extract(torch.as_tensor(frames_u8[5]).to(device).float() / 255.0)
    if not tr._relocalize(feat) or tr.n_inliers < system.cfg.reloc_min_inliers:
        raise AssertionError(f"the rich map did not relocalize: {tr.n_inliers} inliers")
    rich = int(tr.n_inliers)
    bound = tr.cur_mp[tr.cur_mp >= 0]
    kf = int(np.argmax([np.isin(store.kf_mp[k], bound).sum() for k in range(store.n_kf)]))
    calls, real_nn = [], k1.masked_nn

    def recorder(*args):
        calls.append(k1_full_args(args))
        return real_nn(*args)

    torch.cuda.synchronize()
    real_nn.launches = 0
    k1.masked_nn = recorder
    try:
        with eager_sites(["project_search"]):  # the search in Python, recorded
            added = tr._reloc_widen(feat, kf, radius=10.0, max_dist=system.cfg.match_th_high)
    finally:
        k1.masked_nn = real_nn
    widen_launches = real_nn.launches
    if widen_launches < 1 or not calls:
        raise AssertionError("the relocalization's widening search launched no masked_nn")
    kf_mp = store.kf_mp[0]
    keep = np.unique(kf_mp[kf_mp >= 0])
    keep = keep[store.mp_valid[keep]][:40]
    mask = np.zeros_like(store.mp_valid)
    mask[keep] = True
    store.mp_valid[:] = mask
    tr.n_inliers = 0
    real_nn.launches = 0
    accepted, stages = reloc_stages(tr, feat, tracking, tracking, "_search_global", "_ransac_pnp")
    if accepted:
        raise AssertionError(f"a thin map of 40 points relocalized ({tr.n_inliers} inliers)")
    return rich, int(added), widen_launches, real_nn.launches, calls, stages


def phase7(cfg, mapped, frames_u8, weights, device, card, errs, k1_cases):
    """7a-7c (module docstring); ``mapped`` is phase 5's second System and
    ``frames_u8`` its frames.  Adds the relocalization search to
    ``k1_cases`` / ``errs`` and returns the numbers for the JSON line."""
    import tempfile
    import torch
    from asdslam_torch.io import datasets, synthetic
    from asdslam_torch.mapping import persistence
    from asdslam_torch.system import System
    from asdslam_torch.utils import evaluate

    out = {}
    K = torch.tensor([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1.0]])
    frames, poses_gt = synthetic.render_sequence(
        K, N_EXTEND, cfg.image_height, cfg.image_width, step=STEP_M, turn=TURN, device=device)
    ext_u8 = [(f * 255.0).clamp(0, 255).to(torch.uint8).cpu() for f in frames]
    if not all(torch.equal(a, b) for a, b in zip(ext_u8, frames_u8)):
        raise AssertionError("the 40-frame corridor does not start with phase 5's frames")
    poses_gt = poses_gt.cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        # ---- 7a: save, reload, localize ------------------------------------ #
        path = os.path.join(tmp, "phase5.map")
        t0 = time.perf_counter()
        mapped.save_map(path)
        save_ms = (time.perf_counter() - t0) * 1e3
        again = os.path.join(tmp, "again.map")
        persistence.save_visual_map(persistence.load_visual_map(path), again)
        with open(path, "rb") as fa, open(again, "rb") as fb:
            if fa.read() != fb.read():
                raise AssertionError("load_visual_map -> save_visual_map changed the file")
        n_map = mapped.store.n_kf
        loc, load_ms = load_localization(cfg, path, weights, device)
        if loc.loop_closer.vocab is None or loc.store.n_kf != n_map:
            raise AssertionError(f"load_map: {loc.store.n_kf} keyframes of {n_map}, vocabulary "
                                 f"{loc.loop_closer.vocab is not None}")
        run_a = drive(loc, frames_u8, range(N_SYSTEM))
        check_finite(loc, run_a)
        traj = loc.frame_trajectory()
        if loc.store.n_kf != n_map:
            raise AssertionError(f"localization mode added keyframes: {loc.store.n_kf} != {n_map}")
        if len(traj) < N_SYSTEM // 2:
            raise AssertionError(f"localization tracked {len(traj)} of {N_SYSTEM} frames")
        e1, e2 = evaluate.associate_by_id(evaluate.camera_centers(mapped.frame_trajectory()),
                                          evaluate.camera_centers(traj))
        median = float(np.median(np.linalg.norm(e1 - e2, axis=1)))
        if not median < LOC_BAR:
            raise AssertionError(f"median camera-centre distance {median:.6f} >= {LOC_BAR}")
        if run_a["by_site"].get("step", 0) < 1:
            raise AssertionError(f"masked_nn was not launched from the step: {run_a['by_site']}")
        check_dispatch_no_sync(loc, ext_u8, N_SYSTEM, N_DISPATCH)
        loc_stats = loc.stats()
        rich, added, widen_launches, thin_launches, calls, thin = reloc_acceptance(
            loc, frames_u8, device)
        args = max(calls, key=lambda a: int(a[2].sum()))  # most live rows
        err, pairs_in, share = check_k1("relocalization search", args, best_tol=1e-6)
        errs.append(err)
        k1_cases["relocalization search"] = (args, pairs_in, share)
        out["7a"] = dict(frames=N_SYSTEM, map_keyframes=n_map, tracked=len(traj),
                         median_centre_m=median, bar_m=LOC_BAR, ref=REF_LOC["median_centre_m"],
                         save_ms=save_ms, load_ms=load_ms, launches=run_a["launches"],
                         by_site=run_a["by_site"], reloc_rich_inliers=rich,
                         reloc_widen_added=added, reloc_widen_launches=widen_launches,
                         reloc_thin_launches=thin_launches, reloc_thin_candidates=thin,
                         fps=N_SYSTEM / run_a["wall_s"],
                         call_ms_median=float(np.median(run_a["ms"])), stats=loc_stats)
        log(f"7a localization: save_map {save_ms:.1f} ms, the file reproduced byte for byte; "
            f"load_map {load_ms:.1f} ms (vocabulary training included); {len(traj)} of "
            f"{N_SYSTEM} frames tracked, keyframes {n_map} unchanged, median camera-centre "
            f"distance to phase 5's trajectory {median:.6f} m (bar {LOC_BAR}; the JAX package on "
            f"a CPU {REF_LOC['median_centre_m']}); masked_nn launches {run_a['launches']} "
            f"{run_a['by_site']}; {N_DISPATCH} chained dispatches clean under "
            f"set_sync_debug_mode('error'); relocalization: rich map accepted with {rich} "
            f"inliers, its widening search {widen_launches} masked_nn launches ({added} new "
            f"bindings), a thin map rejected ({thin_launches} launches; its candidates {thin})")
        # ---- 7b: loc_extend_map --------------------------------------------- #
        ext, ext_load_ms = load_localization(cfg.replace(loc_extend_map=True), path, weights,
                                             device)
        ids = range(EXTEND_FIRST, N_EXTEND)
        run_b = drive(ext, ext_u8, ids)
        check_finite(ext, run_b)
        st = ext.store
        new_mp = int((st.mp_valid[:st.n_mp] & ~st.mp_global[:st.n_mp]).sum())
        if st.n_kf <= n_map:
            raise AssertionError(f"loc_extend_map added no keyframe: {st.n_kf}")
        if not st.kf_global[:n_map].all() or st.kf_global[n_map:st.n_kf].any():
            raise AssertionError(f"prior-map flags: {st.kf_global[:st.n_kf]}")
        if new_mp <= 50:
            raise AssertionError(f"loc_extend_map created {new_mp} unflagged points")
        ate_b, n_b = sim3_ate(ext, poses_gt, ids)
        if not ate_b < EXTEND_ATE_BAR:
            raise AssertionError(f"loc_extend_map sim3 ATE {ate_b:.4f} m >= {EXTEND_ATE_BAR}")
        out["7b"] = dict(frames=len(ids), keyframes=(n_map, int(st.n_kf)), new_points=new_mp,
                         tracked=n_b, ate_m=ate_b, bar_m=EXTEND_ATE_BAR, ref=REF_LOC["extend_ate_m"],
                         load_ms=ext_load_ms, launches=run_b["launches"], by_site=run_b["by_site"],
                         fps=len(ids) / run_b["wall_s"],
                         call_ms_median=float(np.median(run_b["ms"])), stats=ext.stats())
        log(f"7b loc_extend_map: load_map {ext_load_ms:.1f} ms; frames {EXTEND_FIRST}-"
            f"{N_EXTEND - 1}: keyframes {n_map} -> {st.n_kf}, prior-map flags on the loaded ones "
            f"only, {new_mp} new unflagged points, {n_b} tracked, sim3 ATE {ate_b:.4f} m (bar "
            f"{EXTEND_ATE_BAR}; the JAX package on a CPU {REF_LOC['extend_ate_m']}); masked_nn "
            f"launches {run_b['launches']} {run_b['by_site']}")
        # ---- 7c: EuRoC's lens ------------------------------------------------ #
        cam_file = os.path.join(tmp, "euroc_cam0.txt")
        with open(cam_file, "w") as f:
            f.write(EUROC_CAM + "\n")
        lens_cfg = datasets.config_from_cam_info(cfg, datasets.read_cam_info(cam_file),
                                                 EUROC_W, EUROC_H)
    if not lens_cfg.has_distortion:
        raise AssertionError(f"the camera file gave no distortion: {lens_cfg.dist_coeffs}")
    lK = torch.tensor([[lens_cfg.fx, 0, lens_cfg.cx], [0, lens_cfg.fy, lens_cfg.cy],
                       [0, 0, 1.0]])
    frames, lens_gt = synthetic.render_sequence(
        lK, N_SYSTEM + N_DISPATCH, EUROC_H, EUROC_W, step=STEP_M, turn=TURN,
        dist=tuple(lens_cfg.dist_coeffs), device=device)
    lens_u8 = [(f * 255.0).clamp(0, 255).to(torch.uint8).cpu() for f in frames]
    lens_gt = lens_gt.cpu().numpy()
    lens = System(lens_cfg, asdnet_params=weights, do_loop_closing=True, device=device)
    feat = lens.extract(torch.as_tensor(lens_u8[0]).to(device).float() / 255.0)
    shift = (feat.uv_und - feat.uv).norm(dim=1)
    valid = feat.valid
    max_shift = float(shift[valid].max())
    if not max_shift > 1.0:
        raise AssertionError(f"uv_und moved at most {max_shift:.3f} px off uv")
    if bool((shift[~valid] != 0).any()):
        raise AssertionError("uv_und moved on invalid features")
    ids = range(N_SYSTEM)
    run_c = drive(lens, lens_u8, ids)
    check_finite(lens, run_c)
    store, traj = lens.store, lens.frame_trajectory()
    if store.n_kf < 2 or not traj:
        raise AssertionError(f"the lens path did not bootstrap: {lens.stats()}")
    boot = int(store.kf_frame_id[1])
    after = [fid for fid, _ in traj if fid > boot]
    if len(after) < 0.6 * (N_SYSTEM - 1 - boot):
        raise AssertionError(f"lens path: {len(after)} of {N_SYSTEM - 1 - boot} frames tracked "
                             f"after the bootstrap on frame {boot}")
    ate_c, n_c = sim3_ate(lens, lens_gt, ids)
    if not ate_c < LENS_ATE_BAR:
        raise AssertionError(f"lens path sim3 ATE {ate_c:.4f} m >= {LENS_ATE_BAR}")
    if run_c["by_site"].get("step", 0) < 1:
        raise AssertionError(f"masked_nn was not launched from the lens path's step: "
                             f"{run_c['by_site']}")
    check_dispatch_no_sync(lens, lens_u8, N_SYSTEM, N_DISPATCH)
    out["7c"] = dict(frames=N_SYSTEM, shape=(EUROC_W, EUROC_H), max_uv_shift_px=max_shift,
                     bootstrap_frame=boot, tracked=n_c, ate_m=ate_c, bar_m=LENS_ATE_BAR,
                     ref=REF_LOC["lens_ate_m"], launches=run_c["launches"],
                     by_site=run_c["by_site"], fps=N_SYSTEM / run_c["wall_s"],
                     call_ms_median=float(np.median(run_c["ms"])), stats=lens.stats())
    log(f"7c EuRoC lens ({EUROC_W}x{EUROC_H}, dist {lens_cfg.dist_coeffs}): uv_und off uv by up "
        f"to {max_shift:.2f} px, bootstrap on frame {boot}, {n_c} of {N_SYSTEM} tracked, "
        f"{lens.stats()}, sim3 ATE {ate_c:.4f} m (bar {LENS_ATE_BAR}; the JAX package on a CPU "
        f"{REF_LOC['lens_ate_m']}); masked_nn launches {run_c['launches']} {run_c['by_site']}; "
        f"{N_DISPATCH} chained dispatches clean under set_sync_debug_mode('error')")
    for name in ("7a", "7b", "7c"):
        o = out[name]
        log(f"{name}: {o['fps']:.3f} frames/s over {o['frames']} frames, median call "
            f"{o['call_ms_median']:.1f} ms" + (f", load_map {o['load_ms']:.1f} ms"
                                                if "load_ms" in o else "") + f" [{card}]")
    return out


# --------------------------------------------------------------------------- #
# Phase 8: the port's own entry points, called in-process
# --------------------------------------------------------------------------- #
def png_bytes(img_u8):
    """A [H, W] uint8 image as an 8-bit grayscale PNG (filter 0 on every row)."""
    import struct
    import zlib

    h, w = img_u8.shape

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + img_u8[i].tobytes() for i in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_kitti_dir(root, frames_u8, cfg):
    """The KITTI layout run_slam reads (times.txt, image_0/%06d.png) of
    ``frames_u8`` at 10 Hz, and a camera file of ``cfg``'s intrinsics
    without distortion.  Returns (the sequence directory, the camera file)."""
    seq = os.path.join(root, "seq")
    os.makedirs(os.path.join(seq, "image_0"), exist_ok=True)
    with open(os.path.join(seq, "times.txt"), "w") as f:
        f.writelines(f"{0.1 * i:e}\n" for i in range(len(frames_u8)))
    for i, img in enumerate(frames_u8):
        with open(os.path.join(seq, "image_0", f"{i:06d}.png"), "wb") as f:
            f.write(png_bytes(np.asarray(img, np.uint8)))
    cam = os.path.join(root, "cam.txt")
    with open(cam, "w") as f:
        f.write(f"{cfg.fx},{cfg.fy},{cfg.cx},{cfg.cy},0,0,0,0\n")
    return seq, cam


def write_kitti_ground_truth(root, path="right", n=N_KITTI):
    """A KITTI-like ground truth in the reference repository's layout under
    ``root`` (the kitti_proxy module's GT_DIR and CAM_DIR both point there):
    nvidia_asnd_KITTI03/stamped_groundtruth.txt, ``n`` TUM rows at 10 Hz of
    KITTI_PATHS[path]'s car, and kitti03.txt with KITTI 03's intrinsics.
    Synthetic: not KITTI's path."""
    step, yaw = KITTI_PATHS[path]
    os.makedirs(os.path.join(root, "nvidia_asnd_KITTI03"), exist_ok=True)
    a = yaw * np.arange(n)
    # the camera's forward axis in the world is (sin a, 0, cos a)
    x = np.concatenate([[0.0], np.cumsum(step * np.sin(a[1:]))])
    z = np.concatenate([[0.0], np.cumsum(step * np.cos(a[1:]))])
    with open(os.path.join(root, "nvidia_asnd_KITTI03", "stamped_groundtruth.txt"), "w") as f:
        for i in range(n):   # ts tx ty tz qx qy qz qw of T_wc, a rotation about y
            f.write(f"{0.1 * i:.6f} {x[i]:.6f} 0.000000 {z[i]:.6f} 0.000000 "
                    f"{np.sin(a[i] / 2):.9f} 0.000000 {np.cos(a[i] / 2):.9f}\n")
    with open(os.path.join(root, "kitti03.txt"), "w") as f:
        f.write(KITTI03_CAM + "\n")


def run_entry(main_fn, argv):
    """``main_fn(argv)`` with masked_nn's launches counted by call site and
    its standard output captured.  Returns (what it returned, its output,
    the counts, the host seconds)."""
    import torch

    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with k1_sites() as counts, contextlib.redirect_stdout(buf):
        ret = main_fn(argv)
        torch.cuda.synchronize()
    return ret, buf.getvalue(), counts, time.perf_counter() - t0


@contextlib.contextmanager
def local_map_search(cfg):
    """Keep the arguments of one local-map search of the fused step made
    inside the block (the 20th run in Python, or the last before it) in the
    yielded dict under "args", filled as the wrapper fills them.  The step
    is captured: its warm-up runs in Python with real inputs, its capture
    runs in Python on buffers that hold nothing yet (skipped), its replays
    not at all, so the kept search is the warm-up's."""
    import torch
    from asdslam_torch.ops import masked_nn as k1

    real_nn, seen, kept = k1.masked_nn, [0], {}

    def recorder(*args):
        if getattr(k1._tls, "site", None) == "step" and seen[0] < 20 \
                and args[0].shape[0] == cfg.local_ba_max_points \
                and not torch.cuda.is_current_stream_capturing():
            seen[0] += 1
            kept["args"] = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                                 for a in k1_full_args(args))
        return real_nn(*args)

    k1.masked_nn = recorder
    try:
        yield kept
    finally:
        k1.masked_nn = real_nn


@contextlib.contextmanager
def plain_k1():
    """Every masked_nn call made inside the block goes to its plain version,
    on the card too; nothing is launched or counted.  The module-level
    capture sites are fresh ones inside the block, so that no graph captured
    before it with the kernel is replayed."""
    from asdslam_torch.ops import masked_nn as k1
    from asdslam_torch.utils import graphs

    real_nn = k1.masked_nn
    saved = [(m, a, getattr(m, a)) for m, a in site_owners(JIT_SITES)]
    k1.masked_nn = lambda *args: k1.masked_nn_plain(*k1_full_args(args))
    for m, a, site in saved:
        setattr(m, a, graphs.captured(site.eager, site.name))
    try:
        yield {}
    finally:
        k1.masked_nn = real_nn
        for m, a, site in saved:
            setattr(m, a, site)


@contextlib.contextmanager
def cpu_rendered(kitti_proxy, device):
    """A kitti_proxy.KittiProxySequence built inside the block renders on
    the CPU and hands each frame to ``device``.  Each frame is rendered on
    ``device`` too and compared with the CPU's: the yielded dict holds the
    frames' ``pixel_gap``s in order under "gaps"."""
    import torch

    cls = kitti_proxy.KittiProxySequence
    init, getitem = cls.__init__, cls.__getitem__
    out = {"gaps": []}

    def init_cpu(self, *a, **kw):
        init(self, *a, **dict(kw, device="cpu"))

    def getitem_to(self, i):
        ts, img = getitem(self, i)
        w = kitti_proxy.select_boxes(self.world, self.centers[i], self.n_boxes)
        card = kitti_proxy.render_boxes(torch.as_tensor(self.gt_pose7[i]).to(device),
                                        self.K.to(device), w.bmin, w.bmax, w.salt,
                                        self.height, self.width)
        out["gaps"].append(dict(frame=i, **pixel_gap(img, card)))
        return ts, img.to(device)

    cls.__init__, cls.__getitem__ = init_cpu, getitem_to
    try:
        yield out
    finally:
        cls.__init__, cls.__getitem__ = init, getitem


# tests/test_torch_proxy.py's bar: a frame may differ from another render of
# it on at most this share of its pixels by more than MOVED
PIXEL_SHARE_BAR = 1e-3
MOVED = 1e-5
# the card's frames are the CPU's but for sigmoid's last bits (at most
# 1.19e-7 apart on an H100): a pixel further apart fails
CARD_GAP_BAR = 1e-6
EUROC_GAP_FRAMES = (0, 325, 650, 975, 1299)   # of the 1,300-frame EuRoC proxy


def pixel_gap(cpu, card):
    """Pixels of two renders of a frame that differ at all and that moved
    by more than MOVED, and the largest |difference|."""
    d = (cpu.cpu() - card.cpu()).abs()
    return dict(pixels=d.numel(), differ=int((d > 0).sum()), moved=int((d > MOVED).sum()),
                max_abs=float(d.max()))


def gap_sums(gaps):
    """pixel_gap's counts summed over frames, the largest moved share of a
    frame and the largest |difference|."""
    out = {k: sum(g[k] for g in gaps) for k in ("pixels", "differ", "moved")}
    return dict(out, frames=len(gaps), max_abs=max(g["max_abs"] for g in gaps),
                frame_moved_share=max(g["moved"] / g["pixels"] for g in gaps))


def gap_text(gaps):
    s = gap_sums(gaps)
    return (f"{s['frames']} frames: {s['differ']} of {s['pixels']} pixels differ "
            f"(share {s['differ'] / s['pixels']:.3g}), {s['moved']} moved by more than "
            f"{MOVED} (share {s['moved'] / s['pixels']:.3g}, in a frame at most "
            f"{s['frame_moved_share']:.3g}, bar {PIXEL_SHARE_BAR}), largest |d| "
            f"{s['max_abs']:.3g} (bar {CARD_GAP_BAR})")


def check_gaps(what, gaps):
    """Each frame within tests/test_torch_proxy.py's bar (at most
    PIXEL_SHARE_BAR of its pixels moved by more than MOVED) and no pixel
    further apart than CARD_GAP_BAR."""
    for g in gaps:
        if g["moved"] > PIXEL_SHARE_BAR * g["pixels"] or g["max_abs"] > CARD_GAP_BAR:
            raise AssertionError(f"{what}: frame {g['frame']} rendered on the card against the "
                                 f"CPU's: {g} (bars: moved share {PIXEL_SHARE_BAR}, |d| "
                                 f"{CARD_GAP_BAR})")


def euroc_render_gap(device):
    """The EUROC_GAP_FRAMES of the EuRoC proxy (752x480 through the radtan
    lens) rendered on ``device`` and on the CPU: their ``pixel_gap``s."""
    from asdslam_torch.io import euroc_proxy

    cpu = euroc_proxy.EurocProxySequence(device="cpu")
    card = euroc_proxy.EurocProxySequence(device=device)
    return [dict(frame=i, **pixel_gap(cpu[i][1], card[i][1])) for i in EUROC_GAP_FRAMES]


def last_json(text):
    """The last line of ``text`` that is a JSON object."""
    lines = [l for l in text.splitlines() if l.startswith("{")]
    if not lines:
        raise AssertionError(f"no JSON line in the output:\n{text[-2000:]}")
    return json.loads(lines[-1])


# --------------------------------------------------------------------------- #
# Phase 9: ASDNet training through train_asdnet_torch.py, its weights tracked
# --------------------------------------------------------------------------- #
def write_bmp8(path, img):
    """An 8-bit palette grayscale BMP (bottom-up rows, padded to 4 bytes),
    as PhotoTour's tiles are stored."""
    import struct

    h, w = img.shape
    stride = (w + 3) & ~3
    palette = b"".join(struct.pack("<BBBB", i, i, i, 0) for i in range(256))
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w] = img
    pixel_data = rows[::-1].tobytes()
    off = 14 + 40 + len(palette)
    header = (b"BM" + struct.pack("<IHHI", off + len(pixel_data), 0, 0, off)
              + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 8, 0, len(pixel_data), 2835, 2835, 256, 0))
    with open(path, "wb") as f:
        f.write(header + palette + pixel_data)


def write_phototour(root, anchors, positives):
    """A PhotoTour sequence directory of matched 64x64 pairs: 3D point i
    holds patches 2i (the anchor) and 2i + 1 (the positive), 16x16 patches a
    ``patches%04d.bmp`` tile, ``info.txt`` of point ids and an m50 pair list
    (a match and a non-match per point)."""
    os.makedirs(root, exist_ok=True)
    n = len(anchors)
    patches = np.empty((2 * n, 64, 64), np.uint8)
    patches[0::2] = np.clip(np.round(anchors * 255.0), 0, 255)
    patches[1::2] = np.clip(np.round(positives * 255.0), 0, 255)
    ids = np.repeat(np.arange(n), 2)
    for t in range(0, 2 * n, 256):
        tile = np.zeros((16 * 64, 16 * 64), np.uint8)
        for k, patch in enumerate(patches[t:t + 256]):
            tile[(k // 16) * 64:(k // 16 + 1) * 64, (k % 16) * 64:(k % 16 + 1) * 64] = patch
        write_bmp8(os.path.join(root, f"patches{t // 256:04d}.bmp"), tile)
    np.savetxt(os.path.join(root, "info.txt"), np.stack([ids, np.zeros_like(ids)], 1), fmt="%d")
    rows = [[2 * i, i, 0, 2 * i + 1, i, 0] for i in range(n)]
    rows += [[2 * i, i, 0, (2 * i + 5) % (2 * n), ids[(2 * i + 5) % (2 * n)], 0] for i in range(n)]
    np.savetxt(os.path.join(root, "m50_100000_100000_0.txt"), np.asarray(rows), fmt="%d")


def logged_losses(text):
    """The losses train_asdnet_torch.py prints every 200 steps."""
    return [float(l.split()[3]) for l in text.splitlines() if l.startswith("step ")]


def phase9(cfg, frames_u8, device, card, errs, k1_cases):
    """9a-9c (module docstring): train_asdnet_torch.py over a pair cache and
    over a PhotoTour layout, then run_slam_torch.py with the weights it
    wrote.  Adds 9c's local-map search to ``k1_cases`` / ``errs`` and returns
    the numbers for the JSON line."""
    import tempfile
    import torch
    import run_slam_torch
    import train_asdnet_torch
    from asdslam_torch.models import train as T

    dev = ["--device", device]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # ---- 9a: the default batch over a cache of make_batch pairs ----------- #
        cache, weights = os.path.join(tmp, "pairs.npz"), os.path.join(tmp, "trained.pkl")
        t0 = time.perf_counter()
        T.write_pair_cache(cache, N_POOL, N_HELD_OUT)
        cache_s = time.perf_counter() - t0
        res, text, run_a, sec = run_entry(train_asdnet_torch.main, dev + [
            "--pairs_cache", cache, "--steps", str(N_STEPS), "--batch", str(TRAIN_BATCH),
            "--eval_pairs", str(N_HELD_OUT), "--out", weights])
        losses = logged_losses(text) + [res["final_loss"]]
        if not np.isfinite(losses).all():
            raise AssertionError(f"9a: losses {losses}")
        trained = res["fpr95_asd_trained"]
        if not trained < min(res["fpr95_asd_random"], res["fpr95_patch_classical"]):
            raise AssertionError(f"9a: trained FPR@95 {trained} not below the random ASDNet's "
                                 f"and the classical descriptor's: {res}")
        if not abs(trained - REF_TRAIN["fpr95_asd_trained"]) <= TRAIN_FPR_BAND:
            raise AssertionError(f"9a: trained FPR@95 {trained} off the JAX package's "
                                 f"{REF_TRAIN['fpr95_asd_trained']} by more than {TRAIN_FPR_BAND}")
        log(f"9a train_asdnet_torch.py --pairs_cache ({N_POOL} + {N_HELD_OUT} make_batch pairs, "
            f"written in {cache_s:.1f} s) --steps {N_STEPS} --batch {TRAIN_BATCH}: "
            f"{res['steps_per_s']} steps/s, train_s {res['train_s']} (training and the three "
            f"evaluations), FPR@95 trained {trained} / random {res['fpr95_asd_random']} / "
            f"classical {res['fpr95_patch_classical']} (the JAX package on a CPU {REF_TRAIN}, band "
            f"{TRAIN_FPR_BAND}); losses {[round(x, 4) for x in losses]}; {sec:.1f} s [{card}]")
        out["9a"] = dict(result=res, losses=losses, cache_s=cache_s, seconds=sec, ref=REF_TRAIN,
                         band=TRAIN_FPR_BAND, launches=run_a["launches"])
        # ---- 9b: the PhotoTour reader path ----------------------------------- #
        tour = os.path.join(tmp, "liberty")
        a, p = T.make_batch(T.draw_batch(torch.Generator().manual_seed(3), N_TOUR_POINTS, size=64),
                            size=64)
        write_phototour(tour, a.numpy(), p.numpy())
        res_b, text, _, sec = run_entry(train_asdnet_torch.main, dev + [
            "--phototour", tour, "--steps", str(N_TOUR_STEPS), "--batch", "256", "--pool",
            "2048", "--eval_pairs", "512", "--out", os.path.join(tmp, "tour.pkl")])
        if not np.isfinite(res_b["final_loss"]) or res_b["train_pairs"] != 2048 \
                or res_b["source"] != tour:
            raise AssertionError(f"9b: {res_b}")
        out["9b"] = dict(result=res_b, seconds=sec)
        log(f"9b train_asdnet_torch.py --phototour ({2 * N_TOUR_POINTS} patches in "
            f"{len(os.listdir(tour)) - 2} BMP tiles) --steps {N_TOUR_STEPS}: {res_b}; {sec:.1f} s "
            f"[{card}]")
        # ---- 9c: the trained weights tracking phase 5's corridor ------------- #
        seq, cam = write_kitti_dir(tmp, frames_u8[:N_TRAINED], cfg)
        with local_map_search(cfg) as kept:
            _, text, run_c, sec = run_entry(run_slam_torch.main, dev + [
                "--dataset", "kitti", "--seq_dir", seq, "--camera_config", cam,
                "--asdnet_weights", weights, "--output_addr", os.path.join(tmp, "traj.txt")])
        line = last_json(text)
        if line["frames"] != N_TRAINED or line["tracked"] < ENTRY_TRACKED_BAR * N_TRAINED:
            raise AssertionError(f"9c: {line} (tracked bar {ENTRY_TRACKED_BAR} of {N_TRAINED})")
        if run_c["by_site"].get("step", 0) < 1 or "args" not in kept:
            raise AssertionError(f"9c: masked_nn launches {run_c['by_site']}")
        err, pairs_in, share = check_k1("trained weights local-map search", kept["args"])
        errs.append(err)
        k1_cases["trained weights local-map search"] = (kept["args"], pairs_in, share)
        out["9c"] = dict(line=line, tracked_bar=ENTRY_TRACKED_BAR, seconds=sec,
                         launches=run_c["launches"], by_site=run_c["by_site"])
        log(f"9c run_slam_torch.py --asdnet_weights (9a's) over {N_TRAINED} corridor frames at "
            f"{cfg.image_width}x{cfg.image_height}: {line}; keyframes {line['keyframes']}; "
            f"masked_nn launches {run_c['launches']} {run_c['by_site']}; {sec:.1f} s [{card}]")
    return out


def train_busy(device, n_steps=10):
    """(device kernel ms, wall ms, the five largest CUDA kernels' device ms
    a step) over ``n_steps`` train_steps at TRAIN_BATCH after three warm
    ones, from torch.profiler with CUDA activity only."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from asdslam_torch.models import asdnet
    from asdslam_torch.models import train as T

    model = asdnet.ASDNetTrain(asdnet.init_params(
        asdnet.draw_init_seeds(torch.Generator().manual_seed(0)))).to(device)
    g = torch.Generator(device).manual_seed(0)
    a, p = T.make_batch(T.draw_batch(g, TRAIN_BATCH))
    lr = torch.tensor(0.1, device=device)

    def steps(n):
        for _ in range(n):
            T.train_step(model, a, p, lr, T.draw_step(g, TRAIN_BATCH))

    steps(3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps(n_steps)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    attr = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    per_step = sorted(((e.key, getattr(e, attr) / 1e3 / n_steps) for e in events),
                      key=lambda kv: -kv[1])
    return sum(ms for _, ms in per_step) * n_steps, wall, per_step[:5]


def phase8(cfg, device, card, errs, k1_cases, euroc_scale=1.0):
    """8a-8e (module docstring) through each script's main(argv) at
    ``cfg``'s shape; EuRoC's proxy at ``euroc_scale``.  Adds the EuRoC proxy's
    local-map search to ``k1_cases`` / ``errs`` and returns the numbers for
    the JSON line, with masked_nn's launches by sub-phase and site."""
    import tempfile
    import torch
    import display_map_torch
    import eval_euroc_proxy_torch
    import run_slam_torch
    import train_vocab_torch
    from asdslam_torch.io import synthetic
    from asdslam_torch.loop import vocab as vocab_mod
    from asdslam_torch.mapping import persistence
    from asdslam_torch.native import loader as native
    from asdslam_torch.utils import evaluate

    weights = os.path.join(os.path.dirname(os.path.abspath(__file__)), "asdnet_weights.pkl")
    dev = ["--device", device]
    out = {}
    K = torch.tensor([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1.0]])
    frames, _ = synthetic.render_sequence(K, N_ENTRY, cfg.image_height, cfg.image_width,
                                          step=STEP_M, turn=TURN, device=device)
    frames_u8 = [(f * 255.0).clamp(0, 255).to(torch.uint8).cpu().numpy() for f in frames]
    with tempfile.TemporaryDirectory() as tmp:
        # ---- 8a: run_slam_torch over a KITTI-layout directory ----------------- #
        seq, cam = write_kitti_dir(tmp, frames_u8, cfg)
        paths = {k: os.path.join(tmp, v) for k, v in (
            ("map", "run.map"), ("voc", "online_voc.npz"), ("res", "result"), ("viz", "viz"),
            ("traj", "traj.txt"), ("voc2", "voc.npz"), ("loc_traj", "loc_traj.txt"),
            ("ply", "map.ply"), ("euroc", "euroc.json"))}
        kitti = ["--dataset", "kitti", "--seq_dir", seq, "--camera_config", cam,
                 "--asdnet_weights", weights]
        decoded = native.decode_png_gray.decoded
        mapped, text, run_a, sec = run_entry(run_slam_torch.main, kitti + dev + [
            "--output_addr", paths["traj"], "--save_map", paths["map"], "--save_voc",
            paths["voc"], "--save_result_dir", paths["res"], "--viz_dir", paths["viz"],
            "--viz_every", "10", "--profile"])
        line = last_json(text)
        n_lines = sum(1 for _ in open(paths["traj"]))
        if line["frames"] != N_ENTRY or line["tracked"] < ENTRY_TRACKED_BAR * N_ENTRY:
            raise AssertionError(f"8a: {line} (tracked bar {ENTRY_TRACKED_BAR} of {N_ENTRY})")
        if not ENTRY_KF_RANGE[0] <= line["keyframes"] <= ENTRY_KF_RANGE[1]:
            raise AssertionError(f"8a: {line['keyframes']} keyframes, outside {ENTRY_KF_RANGE}")
        if n_lines != line["keyframes"]:
            raise AssertionError(f"8a: the trajectory file has {n_lines} lines for "
                                 f"{line['keyframes']} keyframes")
        again = os.path.join(tmp, "again.map")
        persistence.save_visual_map(persistence.load_visual_map(paths["map"]), again)
        with open(paths["map"], "rb") as fa, open(again, "rb") as fb:
            if fa.read() != fb.read():
                raise AssertionError("8a: load_visual_map -> save_visual_map changed the file")
        res_files = {n: os.path.getsize(os.path.join(paths["res"], n + ".txt"))
                     for n in ("traj", "track", "posi", "kps", "desc")}
        if not all(res_files.values()):
            raise AssertionError(f"8a: empty result files {res_files}")
        snaps = {t: len(os.listdir(os.path.join(paths["viz"], t)))
                 for t in ("map/trajectory", "map/points", "map/topdown", "camera/frame")
                 if os.path.isdir(os.path.join(paths["viz"], t))}
        if snaps.get("camera/frame") != 3 or snaps.get("map/topdown") != 3 \
                or not snaps.get("map/points") or not snaps.get("map/trajectory"):
            raise AssertionError(f"8a: visualization snapshots {snaps}")
        if run_a["by_site"].get("step", 0) < 1 or run_a["by_site"].get("fuse", 0) < 1:
            raise AssertionError(f"8a: masked_nn launches {run_a['by_site']}")
        decoded = native.decode_png_gray.decoded - decoded
        if decoded < N_ENTRY:
            raise AssertionError(f"8a: {decoded} of {N_ENTRY} PNGs went through the native decoder")
        out["8a"] = dict(line=line, keyframes_bar=ENTRY_KF_RANGE, ref=REF_ENTRY, seconds=sec,
                         native_decodes=decoded,
                         result_bytes=res_files, viz=snaps, online_vocab=os.path.exists(
                             paths["voc"]), launches=run_a["launches"], by_site=run_a["by_site"])
        log(f"8a run_slam_torch.py --dataset kitti ({N_ENTRY} PNGs at {cfg.image_width}x"
            f"{cfg.image_height}): {line}; {n_lines} trajectory lines; the map reproduced byte for "
            f"byte; {decoded} PNGs decoded natively; result files {res_files}; snapshots {snaps}; "
            f"online vocabulary saved "
            f"{out['8a']['online_vocab']}; the JAX package's run_slam.py on the same directory on "
            f"a CPU {REF_ENTRY['run_slam']}; masked_nn launches {run_a['launches']} "
            f"{run_a['by_site']}; {sec:.1f} s [{card}]")
        for l in text.splitlines():
            if l.startswith("frame/fused_track ") or l.startswith("frame "):
                log("  " + l)
        # ---- 8b: train_vocab_torch on 8a's map ----------------------------- #
        _, text, run_b, sec = run_entry(train_vocab_torch.main, dev + [
            "--map_addr", paths["map"], "--out", paths["voc2"]])
        voc = vocab_mod.load_vocab(paths["voc2"], device=device)
        if voc.n_words != 10 ** 4 or len(voc.levels) != 5:
            raise AssertionError(f"8b: {voc.n_words} words, {len(voc.levels)} levels")
        out["8b"] = dict(seconds=sec, words=voc.n_words, launches=run_b["launches"])
        log(f"8b train_vocab_torch.py: {text.strip().splitlines()[0]}; {voc.n_words} words "
            f"loaded back; {sec:.1f} s [{card}]")
        # ---- 8c: localization on 8a's map under 8b's vocabulary -------------- #
        loc, text, run_c, sec = run_entry(run_slam_torch.main, kitti + dev + [
            "--localization", "--map_addr", paths["map"], "--voc_addr", paths["voc2"],
            "--max_frame", str(N_ENTRY_LOC), "--output_addr", paths["loc_traj"]])
        line_c = last_json(text)
        traj = loc.frame_trajectory()
        if line_c["keyframes"] != line["keyframes"] or loc.store.n_kf != mapped.store.n_kf:
            raise AssertionError(f"8c: localization changed the keyframes: {line_c}")
        if len(traj) < N_ENTRY_LOC // 2:
            raise AssertionError(f"8c: {len(traj)} of {N_ENTRY_LOC} frames tracked")
        e1, e2 = evaluate.associate_by_id(evaluate.camera_centers(mapped.frame_trajectory()),
                                          evaluate.camera_centers(traj))
        median = float(np.median(np.linalg.norm(e1 - e2, axis=1)))
        if not median < LOC_BAR:
            raise AssertionError(f"8c: median camera-centre distance {median:.6f} >= {LOC_BAR}")
        if run_c["by_site"].get("step", 0) < 1:
            raise AssertionError(f"8c: masked_nn launches {run_c['by_site']}")
        out["8c"] = dict(line=line_c, tracked=len(traj), median_centre_m=median, bar_m=LOC_BAR,
                         seconds=sec, launches=run_c["launches"], by_site=run_c["by_site"])
        log(f"8c run_slam_torch.py --localization --voc_addr, frames 0-{N_ENTRY_LOC - 1}: "
            f"{line_c}; {len(traj)} tracked, keyframes unchanged, median camera-centre distance "
            f"to 8a's trajectory {median:.6f} m (bar {LOC_BAR}); masked_nn launches "
            f"{run_c['launches']} {run_c['by_site']}; {sec:.1f} s [{card}]")
        # ---- 8d: display_map_torch on 8a's map ----------------------------- #
        summary, text, _, sec = run_entry(display_map_torch.main, dev + [
            paths["map"], "--ply", paths["ply"]])
        err = summary["avg_reproj_error_px"]
        with open(paths["ply"]) as f:
            vertices = int(next(l for l in f if l.startswith("element vertex")).split()[2])
        if not (np.isfinite(err) and err < ENTRY_REPROJ_BAR) or summary["observations"] < 1:
            raise AssertionError(f"8d: {summary} (bar {ENTRY_REPROJ_BAR} px)")
        if vertices != summary["map_points"] + summary["frames"]:
            raise AssertionError(f"8d: the PLY has {vertices} vertices for {summary}")
        out["8d"] = dict(summary=summary, bar_px=ENTRY_REPROJ_BAR, seconds=sec)
        log(f"8d display_map_torch.py: {summary}, PLY of {vertices} vertices (bar "
            f"{ENTRY_REPROJ_BAR} px; the JAX display_map.py on the JAX package's map of the same "
            f"directory {REF_ENTRY['display_map']}) [{card}]")
        # ---- 8e: eval_euroc_proxy_torch, 40 frames through the lens ----------- #
        with local_map_search(cfg) as kept:
            (euroc, result), text, run_e, sec = run_entry(
                eval_euroc_proxy_torch.main, dev + ["--frames", str(N_EUROC), "--scale",
                                                    str(euroc_scale), "--out", paths["euroc"]])
        render = euroc.tracer.spans["render"].total
        if result["tracked"] < EUROC_TRACKED_BAR * N_EUROC:
            raise AssertionError(f"8e: {result['tracked']} of {N_EUROC} tracked")
        if not result.get("ate_sim3_m", np.inf) < EUROC_ATE_BAR:
            raise AssertionError(f"8e: sim3 ATE {result.get('ate_sim3_m')} >= {EUROC_ATE_BAR}")
        if not EUROC_KF_RANGE[0] <= result["keyframes"] <= EUROC_KF_RANGE[1]:
            raise AssertionError(f"8e: {result['keyframes']} keyframes, outside {EUROC_KF_RANGE}")
        if run_e["by_site"].get("step", 0) < 1 or "args" not in kept:
            raise AssertionError(f"8e: masked_nn launches {run_e['by_site']}")
        err, pairs_in, share = check_k1("EuRoC proxy local-map search", kept["args"])
        errs.append(err)
        k1_cases["EuRoC proxy local-map search"] = (kept["args"], pairs_in, share)
        out["8e"] = dict(result={k: v for k, v in result.items() if k != "drift"},
                         tracked_bar=EUROC_TRACKED_BAR, ate_bar_m=EUROC_ATE_BAR,
                         keyframes_bar=EUROC_KF_RANGE, ref=REF_EUROC,
                         render_s=render, seconds=sec, launches=run_e["launches"],
                         by_site=run_e["by_site"])
        log(f"8e eval_euroc_proxy_torch.py --frames {N_EUROC} ({result['resolution']}, the "
            f"radtan lens, loop closing): tracked {result['tracked']}, keyframes "
            f"{result['keyframes']}, sim3 ATE {result.get('ate_sim3_m')} m (bars: tracked >= "
            f"{EUROC_TRACKED_BAR} of the frames, keyframes in {EUROC_KF_RANGE}, ATE < {EUROC_ATE_BAR}; "
            f"the JAX package's 40 frames "
            f"on a CPU {REF_EUROC}); {result['fps']} frames/s, {result['fps_tracking']} without "
            f"the render span ({render:.2f} s over {N_EUROC} renders); masked_nn launches "
            f"{run_e['launches']} {run_e['by_site']}; {sec:.1f} s [{card}]")
    return out


# --------------------------------------------------------------------------- #
# Phase 10: ORB with K1 at d = 256, the assignment engines, the native library
# --------------------------------------------------------------------------- #
def phase10(cfg, device, card, errs, k1_cases, asd_extract_ms, mapped, native_decodes_8a):
    """10a-10d (module docstring).  ``asd_extract_ms`` is phase 4's ASD
    extraction, ``mapped`` phase 5's second System, ``native_decodes_8a``
    the PNGs phase 8a decoded natively.  Adds 10a's and 10b's K1 checks to
    ``k1_cases`` / ``errs`` and returns the numbers for the JSON line."""
    import tempfile
    import torch
    from asdslam_torch.frontend import track_step as ts
    from asdslam_torch.io import datasets, synthetic
    from asdslam_torch.mapping import persistence
    from asdslam_torch.native import build as native_build
    from asdslam_torch.native import loader as native
    from asdslam_torch.ops import assignment, orb
    from asdslam_torch.ops import masked_nn as k1

    out = {}
    # ---- 10a: K1 at d = 256 against its plain version ----------------------- #
    t0 = time.perf_counter()
    problems = [(f"{case} d256", nn_problem(n, m, d=256, ties=ties, seed=n + m))
                for case, n, m, ties in (("motion 2000x2000x256", 2000, 2000, False),
                                         ("local-map 8192x2000x256", 8192, 2000, False),
                                         ("ties 300x257", 300, 257, True))]
    problems += [(f"{case} d256", edge_problem(case, d=256)) for case in EDGE_CASES]
    for case, prob in problems:
        args = k1_args(prob)
        err, pairs_in, share = check_k1(case, args)
        errs.append(err)
        k1_cases[case] = (args, pairs_in, share)

    # ---- 10b: the fused step with the ORB extractor ------------------------- #
    K, extract, frames_u8, poses, cand, state = build_tracking(
        cfg, device, descriptor_fn=orb.apply, rotate_patches=True)
    if cand.desc.shape[1] != orb.ORB_DIM or state["feat"].desc.shape[1] != orb.ORB_DIM:
        raise AssertionError(f"10b: descriptors {tuple(cand.desc.shape)}, not 256 wide")
    args = orb_problem(cfg, extract, frames_u8, device)
    err, pairs_in, share = check_k1("ORB corridor features d256", args, bitwise=True)
    errs.append(err)
    k1_cases["ORB corridor features d256"] = (args, pairs_in, share)
    out["10a_seconds"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    step = ts.make_track_step(cfg, K, extract, device=device)
    torch.cuda.synchronize()
    k1.masked_nn.launches = 0
    results = run_chain(step, frames_u8, state, cand, 1, N_CHAINED)
    torch.cuda.synchronize()
    launches = k1.masked_nn.launches
    if launches != 3 * N_CHAINED:
        raise AssertionError(f"10b: masked_nn launched {launches} times in {N_CHAINED} frames")
    for i, res in enumerate(results):
        for name, x in [("pose", res.pose), ("velocity", res.velocity)] + list(
                res.next_geom._asdict().items()):
            if x.is_floating_point() and not torch.isfinite(x).all():
                raise AssertionError(f"10b frame {i + 1}: non-finite {name}")
    n_in = [int(r.n_inliers) for r in results]
    pose_err = [float((r.pose - poses[i + 1]).abs().max()) for i, r in enumerate(results)]
    log(f"10b ORB fused step: {N_CHAINED} chained frames, masked_nn launches {launches} at "
        f"d = 256, n_inliers {n_in} (the JAX package on a CPU {REF_ORB['n_inliers']}), max "
        f"|pose - ground truth| {[round(e, 4) for e in pose_err]} (bar {ORB_POSE_BAR:.4f}; "
        f"the JAX package's worst {REF_ORB['max_pose_err']})")
    floor = [max(cfg.min_localmap_matches, ORB_INLIER_SHARE * r) for r in REF_ORB["n_inliers"]]
    if any(n < f for n, f in zip(n_in, floor)) or max(pose_err) > ORB_POSE_BAR:
        raise AssertionError(f"10b: n_inliers {n_in} (floor {floor}) or pose error {pose_err}")
    plain_step = ts.make_track_step(cfg.replace(use_pallas_match=False), K, extract,
                                    device=device)
    (res_k,) = run_chain(step, frames_u8, state, cand, 1, 1)
    (res_p,) = run_chain(plain_step, frames_u8, state, cand, 1, 1)
    src_eq = float((res_k.src == res_p.src).float().mean())
    dpose = float((res_k.pose - res_p.pose).abs().max())
    log(f"10b kernel vs plain matcher, one frame: src equal on {src_eq:.4f}, max|d pose| {dpose:.3g}")
    if src_eq < 0.99 or dpose > 1e-3:
        raise AssertionError("10b: the ORB step disagrees with its plain-matcher version")
    for case, args in zip(("ORB motion 2000x2000x256", "ORB local-map 8192x2000x256"),
                          record_searches(step, frames_u8, state, cand)):
        args = tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in k1_full_args(args))
        err, pairs_in, share = check_k1(case, args, bitwise=True)
        errs.append(err)
        k1_cases[case] = (args, pairs_in, share)
    run_chain(step, frames_u8, state, cand, 1, 2)  # warm
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    int(run_chain(step, frames_u8, state, cand, 1, N_CHAINED)[-1].n_inliers)
    torch.cuda.synchronize()
    fps = N_CHAINED / (time.perf_counter() - t1)
    img = frames_u8[1].to(device).float() / 255.0
    orb_ms = time_ms(lambda: extract(img), 5)
    log(f"10b ORB fused step: {fps:.2f} frames/s over {N_CHAINED} chained frames; extraction "
        f"{orb_ms:.3f} ms a frame with ORB, {asd_extract_ms:.3f} ms with ASDNet (phase 4; CUDA "
        f"events) [{card}]")
    out["10b"] = dict(frames=N_CHAINED, launches=launches, n_inliers=n_in, pose_err=pose_err,
                      ref=REF_ORB, pose_bar=ORB_POSE_BAR, src_equal_plain=src_eq,
                      dpose_plain=dpose, fps=fps, orb_extract_ms=orb_ms,
                      asd_extract_ms=asd_extract_ms, seconds=time.perf_counter() - t0)

    # ---- 10c: the assignment engines on the card ----------------------------- #
    g = np.random.default_rng(10)
    n, m = ASSIGN_SHAPE
    score = torch.tensor((g.integers(0, 50, (n, m)) / 50).astype(np.float32))
    valid = torch.tensor(g.uniform(size=(n, m)) < 0.3)
    out["10c"] = {}
    for name, fn in (("greedy", assignment.greedy_assignment),
                     ("non_exclusive", assignment.non_exclusive_assignment)):
        cpu = fn(score, valid, 0.1)
        sc, vc = score.to(device), valid.to(device)
        gpu = fn(sc, vc, 0.1)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b.cpu()) for a, b in zip(cpu, gpu)):
            raise AssertionError(f"10c: {name} on the card differs from the CPU")
        ms = time_ms(lambda: fn(sc, vc, 0.1), 3)
        out["10c"][name] = dict(assigned=int(cpu[-1].sum()), ms=ms)
        log(f"10c {name}_assignment {n}x{m}: equal to the CPU result, {int(cpu[-1].sum())} rows "
            f"assigned, {ms:.3f} ms a call [{card}]")

    # ---- 10d: the native library ----------------------------------------------- #
    t0 = time.perf_counter()
    if not native.native_available():
        raise AssertionError("10d: the native library is not available")
    log(f"10d native library {native_build.library_path().name}; its build in this process:")
    for line in (native.BUILD_LOG or "(built before this process)").splitlines():
        log("  " + line)
    if native_decodes_8a < N_ENTRY:
        raise AssertionError(f"10d: phase 8a decoded {native_decodes_8a} PNGs natively")
    K = torch.tensor([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1.0]])
    frames, _ = synthetic.render_sequence(K, N_ENTRY, cfg.image_height, cfg.image_width,
                                          step=STEP_M, turn=TURN, device=device)
    entry_u8 = [(f * 255.0).clamp(0, 255).to(torch.uint8).cpu().numpy() for f in frames]
    with tempfile.TemporaryDirectory() as tmp:
        seq, _ = write_kitti_dir(tmp, entry_u8, cfg)
        paths = [os.path.join(seq, "image_0", f"{i:06d}.png") for i in range(N_ENTRY)]
        t1 = time.perf_counter()
        decoded = [datasets.load_image_gray(p) for p in paths]
        decode_ms = (time.perf_counter() - t1) * 1e3 / N_ENTRY
        for p, img, u8 in zip(paths, decoded, entry_u8):
            if not np.array_equal(img, datasets._load_png_gray(p)) or \
                    not np.array_equal(img, u8.astype(np.float32) / 255.0):
                raise AssertionError(f"10d: {p} decodes differently from the numpy decoder")
        loader = native.PrefetchLoader(paths, cfg.image_height, cfg.image_width)
        got = list(loader)
        loader.close()
        if len(got) != N_ENTRY or not all(np.array_equal(a, b) for a, b in zip(got, decoded)):
            raise AssertionError("10d: the prefetching loader's frames differ or are out of order")
        data = persistence.export_map(mapped.store, mapped.cfg, mapped.cfg.covis_weight_posegraph)
        nat, ref = os.path.join(tmp, "native.map"), os.path.join(tmp, "struct.map")
        t1 = time.perf_counter()
        if not native.map_save_native(nat, data):
            raise AssertionError("10d: map_save_native declined phase 5's map")
        save_ms = (time.perf_counter() - t1) * 1e3
        persistence.save_visual_map(data, ref, use_native=False)
        with open(nat, "rb") as fa, open(ref, "rb") as fb:
            nbytes = len(fa.read())
            fa.seek(0)
            if fa.read() != fb.read():
                raise AssertionError("10d: the native .map differs from the struct writer's")
        back = native.map_load_native(nat)
        again = os.path.join(tmp, "again.map")
        persistence.save_visual_map(back, again, use_native=False)
        with open(again, "rb") as fa, open(ref, "rb") as fb:
            if fa.read() != fb.read():
                raise AssertionError("10d: the map read back natively does not write the same bytes")
    out["10d"] = dict(native_decodes_8a=native_decodes_8a, pngs=N_ENTRY, decode_ms=decode_ms,
                      map_bytes=nbytes, map_save_ms=save_ms, seconds=time.perf_counter() - t0)
    log(f"10d {N_ENTRY} PNGs at {cfg.image_width}x{cfg.image_height} decoded natively bit for bit "
        f"as by the numpy decoder ({decode_ms:.2f} ms a frame, load_image_gray), the prefetching "
        f"loader in order; phase 5's map ({nbytes} bytes, {len(data.frames)} keyframes) written "
        f"natively byte for byte as by the struct writer ({save_ms:.1f} ms) and read back; phase "
        f"8a decoded {native_decodes_8a} PNGs natively [{card}]")
    return out


# --------------------------------------------------------------------------- #
# Phase 11: the multi-device path
# --------------------------------------------------------------------------- #
MD_SHARDS = (1, 2, 4, 8)
# tests/test_parallel.py's bars across shard counts and process topologies
MD_POSE_BAR, MD_POINT_BAR = 5e-3, 2e-2
# tests/test_parallel.py::TestSystemMeshGBA's bars across mesh sizes
GBA_POSE_BAR, GBA_POINT_BAR = 2e-4, 2e-3
GBA_MESHES = (2, 8)
# 11c's runs as (shards, sequences): the reference test's four shards of one
# sequence each, then one shard of B sequences for B = 1, 4 and 16
SEQ_RUNS = ((4, 4), (1, 1), (1, 4), (1, 16))
N_SEQ_FRAMES = 4
DP_PATCH_SHARDS = 4
CHILD_TIMEOUT = 300
MD_K = np.array([[500.0, 0.0, 320.0], [0.0, 500.0, 240.0], [0.0, 0.0, 1.0]], np.float32)


def make_problem_np(n_cams=4, n_pts=64, n_dev=8):
    """tests/multihost_child.py::make_problem_np: a BA problem from numpy's
    generator of seed 42 (poses0, pts0, cam_idx, pt_idx, uv, inv_s2,
    valid); the last camera is the fixed one."""
    rng = np.random.default_rng(42)
    pts_gt = rng.uniform(-2.0, 2.0, (n_pts, 3)) + np.array([0.0, 0.0, 6.0])
    poses_gt = np.asarray([[1.0, 0.0, 0.0, 0.0, 0.3 * c, 0.0, 0.0] for c in range(n_cams)],
                          np.float32)
    O = 16 * n_dev * ((n_cams * n_pts) // (16 * n_dev))
    cam_idx = (np.arange(O) % n_cams).astype(np.int32)
    pt_idx = (np.arange(O) % n_pts).astype(np.int32)
    xc = pts_gt[pt_idx] + poses_gt[cam_idx, 4:7]  # identity rotations
    uv = np.stack([500.0 * xc[:, 0] / xc[:, 2] + 320.0,
                   500.0 * xc[:, 1] / xc[:, 2] + 240.0], axis=1).astype(np.float32)
    poses0 = poses_gt.copy()
    poses0[:n_cams - 1, 4:] += 0.05 * rng.standard_normal((n_cams - 1, 3))
    pts0 = (pts_gt + 0.05 * rng.standard_normal(pts_gt.shape)).astype(np.float32)
    return (poses0.astype(np.float32), pts0, cam_idx, pt_idx, uv,
            np.ones(O, np.float32), np.ones(O, bool))


def md_steps(mesh, problem, steps=1):
    """``steps`` point-major BA steps of ``problem`` over ``mesh``, as one
    process of it: the layout and its tables on the host, this process's
    shards, the steps, one gather of the points.  Returns host arrays."""
    import torch
    from asdslam_torch.parallel import dist

    poses0, pts0, cam_idx, pt_idx, uv, inv_s2, valid = problem
    (pts_pm, cam_o, pt_o, uv_o, s2_o, va_o, Pn_pad) = dist.layout_point_major(
        pts0, cam_idx, pt_idx, uv, inv_s2, valid, mesh.size)
    obs = dist.shard_observations(mesh, cam_o, pt_o, uv_o, s2_o, va_o, Pn_pad, 3)
    poses, pts = torch.tensor(poses0), dist.shard_to_mesh(mesh, pts_pm, "data")
    step = dist.make_pm_step(mesh, 3)
    for _ in range(steps):
        poses, pts = step(poses, pts, obs, torch.tensor(MD_K))
    return poses.cpu().numpy(), mesh.gather(pts)[:len(pts0)].cpu().numpy()


def md_rmse(problem, poses, pts):
    import torch
    from asdslam_torch.backend import ba

    obs = ba.Obs(*(torch.tensor(x) for x in problem[2:]))
    r, _, _, _ = ba._project_residuals(torch.tensor(poses), torch.tensor(pts), obs,
                                       torch.tensor(MD_K))
    return float(torch.sqrt(torch.mean(torch.sum(r * r, dim=1))))


def md_close(what, a, b, bar_poses, bar_points):
    """Max |a - b| over poses and points, raising past the bars."""
    dp, dx = (float(np.abs(x - y).max()) for x, y in zip(a, b))
    if not (dp <= bar_poses and dx <= bar_points):
        raise AssertionError(f"{what}: poses {dp:.3g} (bar {bar_poses}), points {dx:.3g} "
                             f"(bar {bar_points})")
    return dp, dx


def multihost_child(argv):
    """One process of 11e: ``--multihost-child RANK WORLD PORT BACKEND DEVICE
    OUT`` (BACKEND "auto" takes init_multihost's rule; DEVICE "cuda").  One
    shard on this process's card, one step of make_problem_np's problem,
    the result in OUT/rank{RANK}.npz."""
    rank, world, port, backend, device, out = (int(argv[0]), int(argv[1]), argv[2], argv[3],
                                               argv[4], argv[5])
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    import torch.distributed
    from asdslam_torch.parallel import dist

    dist.init_multihost(f"localhost:{port}", world, rank,
                        backend=None if backend == "auto" else backend)
    try:
        mesh = dist.global_mesh(1, device=device)
        poses, pts = md_steps(mesh, make_problem_np())
        np.savez(os.path.join(out, f"rank{rank}.npz"), poses=poses, pts=pts,
                 backend=torch.distributed.get_backend(), device=str(mesh.devices[0]),
                 reduced=mesh.reduced_elems)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def start_children(tmp, device):
    """11e's processes, started together: two ranks over the default rule
    (gloo: they share the card) and one rank alone (NCCL).  Returns
    [(name, out_dir, world, [Popen])]."""
    import socket

    groups = []
    for name, world in (("gloo_pair", 2), ("nccl_alone", 1)):
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = str(s.getsockname()[1])
        out = os.path.join(tmp, name)
        os.makedirs(out)
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--multihost-child", str(r), str(world),
             port, "auto", device, out], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(world)]
        groups.append((name, out, world, procs))
    return groups


def finish_children(groups):
    """Wait for 11e's processes (each under CHILD_TIMEOUT); a failed or
    hung one fails the phase.  Returns {name: [rank results]}."""
    results = {}
    try:
        for name, out, world, procs in groups:
            for r, p in enumerate(procs):
                try:
                    text = p.communicate(timeout=CHILD_TIMEOUT)[0].decode(errors="replace")
                except subprocess.TimeoutExpired:
                    raise AssertionError(f"11e {name} rank {r} hung past {CHILD_TIMEOUT} s")
                if p.returncode != 0:
                    raise AssertionError(f"11e {name} rank {r} exited {p.returncode}:\n"
                                         f"{text[-3000:]}")
            results[name] = [dict(np.load(os.path.join(out, f"rank{r}.npz")))
                             for r in range(world)]
    finally:
        for _, _, _, procs in groups:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return results


def map_reproj_px(store, cfg):
    """Mean reprojection error (px) of every valid map point's
    observations in the store's keyframes."""
    from asdslam_torch.mapping.map_store import _pose_np_batch

    mp_ids = np.nonzero(store.mp_valid[:store.n_mp])[0]
    pt_row, kfs, feats = store.observation_rows(mp_ids)
    R, t = _pose_np_batch(store.kf_pose[kfs])
    xc = np.einsum("oij,oj->oi", R, store.mp_pos[mp_ids][pt_row]) + t
    uv = np.stack([cfg.fx * xc[:, 0] / xc[:, 2] + cfg.cx,
                   cfg.fy * xc[:, 1] / xc[:, 2] + cfg.cy], axis=1)
    return float(np.linalg.norm(uv - store.kf_uv_t[kfs, feats], axis=1).mean())


def seq_frame(frame_u8, b):
    """Sequence b's frame: the corridor's, darkened by 5% a step of b % 4 and
    1% a step of b // 4 (the reference test's 1 - 0.05 b for b < 4)."""
    import torch

    scale = 1 - 0.05 * (b % 4) - 0.01 * (b // 4)
    return (frame_u8.to(torch.float32) * scale).clamp(0, 255).to(torch.uint8)


def tile_tree(x, n):
    """(Nested) tuples of tensors with a leading axis of ``n`` copies."""
    import torch

    if isinstance(x, tuple):
        return type(x)(*(tile_tree(f, n) for f in x))
    return torch.stack([x] * n)


def phase11c(cfg, device, card, tracking):
    """11c (module docstring), on ``build_tracking``'s ``tracking``: each of
    SEQ_RUNS through
    multi_seq.make_dp_track_step over N_SEQ_FRAMES chained frames from phase
    3's hand-built state, held bit for bit to each sequence's single step;
    the batched step timed against the per-sequence loop (the single step
    once per sequence a frame, what the port ran before the batched step).
    Returns (the numbers, masked_nn launches of the timed runs, {B: the
    arguments of a one-shard run's batched local-map search})."""
    import torch
    from asdslam_torch.frontend import track_step as ts
    from asdslam_torch.ops import masked_nn as k1
    from asdslam_torch.parallel import dist, multi_seq

    K, extract, frames_u8, poses, cand, state = tracking
    n_max = max(n for _, n in SEQ_RUNS)
    frames = [[seq_frame(frames_u8[i], b) for i in range(N_SEQ_FRAMES + 1)]
              for b in range(n_max)]
    keys = ("feat", "geom", "pose", "vel", "crow")
    single = ts.make_track_step(cfg, K, extract, device=device)

    def chain(b):
        feat, geom, pose, vel, crow = (state[k] for k in keys)
        out = []
        for i in range(1, N_SEQ_FRAMES + 1):
            feat, res = single(frames[b][i], pose, vel, feat, geom, cand, crow)
            geom, pose, vel, crow = res.next_geom, res.pose, res.velocity, res.crow
            out.append((feat, res))
        return out

    refs = [chain(b) for b in range(n_max)]  # warms and captures the single step too

    def run_batched(step, n):
        pose, vel, feat, geom = (tile_tree(state[k], n) for k in ("pose", "vel", "feat", "geom"))
        crow, bcand, results = tile_tree(state["crow"], n), tile_tree(cand, n), []
        for i in range(1, N_SEQ_FRAMES + 1):
            imgs = torch.stack([frames[b][i] for b in range(n)])
            feat, res = step(imgs, pose, vel, feat, geom, bcand, crow)
            pose, vel, geom, crow = res.pose, res.velocity, res.next_geom, res.crow
            results.append((feat, res))
        return results

    def first_local_map_search(step, n):
        """The batched masked_nn arguments of the first frame's local-map
        search, from the shard's eager (vmapped) step."""
        calls, real = [], k1._run

        def recorder(args, level_window):
            calls.append(tuple(args) + (level_window,))
            return real(args, level_window)

        k1._run = recorder
        try:
            with torch.no_grad():
                getattr(step.steps[0], "eager", step.steps[0])(
                    torch.stack([frames[b][1] for b in range(n)]).to(device),
                    *(tile_tree(state[k], n) for k in ("pose", "vel", "feat", "geom")),
                    tile_tree(cand, n), tile_tree(state["crow"], n))
        finally:
            k1._run = real
        if len(calls) != 3 or calls[2][0].shape[0] != n:
            raise AssertionError(f"11c: the batched step made {len(calls)} masked_nn calls")
        return calls[2]

    runs, launches, batched_k1 = {}, 0, {}
    for shards, n in SEQ_RUNS:
        mesh = dist.make_mesh(shards, device)
        step = multi_seq.make_dp_track_step(cfg, K, extract, mesh)
        run_batched(step, n)  # each shard's step warms its graph
        run_batched(step, n)  # and captures it
        torch.cuda.synchronize()
        k1.masked_nn.launches = 0
        t1 = time.perf_counter()
        batched = run_batched(step, n)
        torch.cuda.synchronize()
        batched_s = time.perf_counter() - t1
        count = k1.masked_nn.launches
        launches += count
        if count != 3 * N_SEQ_FRAMES * shards:
            raise AssertionError(f"11c {shards} shard(s) x {n // shards} sequences: masked_nn "
                                 f"launched {count} times, not {3 * N_SEQ_FRAMES * shards}")
        if mesh.reduced_elems != 0:
            raise AssertionError(f"11c: the batched step reduced {mesh.reduced_elems}")
        # the per-sequence loop on the same frames, the single step's graph warm
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for b in range(n):
            chain(b)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t1
        n_in = []
        for b in range(n):
            for i, ((feat, res), (bf, br)) in enumerate(zip(refs[b], batched)):
                for name, x, y in (("feat", feat, multi_seq._take(bf, b, device)),
                                   ("result", res, multi_seq._take(br, b, device))):
                    if not all(torch.equal(u, v) for u, v in zip(tree_leaves(x), tree_leaves(y))):
                        raise AssertionError(f"11c {shards} shard(s) x {n // shards}: sequence {b} "
                                             f"frame {i + 1}: {name} differs from the single step")
                if not torch.isfinite(res.pose).all():
                    raise AssertionError(f"11c sequence {b} frame {i + 1}: non-finite pose")
            n_in.append(int(refs[b][-1][1].n_inliers))
        if min(n_in) < cfg.min_localmap_matches:
            raise AssertionError(f"11c: tracking lost, last n_inliers {n_in}")
        pools = [e["pool_bytes"] for s in step.steps if hasattr(s, "graphs")
                 for e in s.graphs.stats()]
        tag = f"{shards}x{n // shards}"
        runs[tag] = dict(shards=shards, sequences=n, launches=count,
                         launches_a_frame_per_shard=count / (N_SEQ_FRAMES * shards),
                         batched_ms_a_frame=batched_s * 1e3 / N_SEQ_FRAMES,
                         batched_seq_frames_per_s=n * N_SEQ_FRAMES / batched_s,
                         loop_ms_a_frame=loop_s * 1e3 / N_SEQ_FRAMES,
                         loop_seq_frames_per_s=n * N_SEQ_FRAMES / loop_s,
                         pool_bytes=pools, last_n_inliers=n_in)
        log(f"11c {shards} shard(s) x {n // shards} sequence(s) over {N_SEQ_FRAMES} chained frames "
            f"at {cfg.image_width}x{cfg.image_height}: masked_nn launches {count} "
            f"({count / (N_SEQ_FRAMES * shards):.0f} a frame per shard), nothing reduced, every "
            f"sequence bit for bit its single step, last n_inliers {n_in}; batched step "
            f"{batched_s * 1e3 / N_SEQ_FRAMES:.2f} ms a frame, "
            f"{n * N_SEQ_FRAMES / batched_s:.3f} sequence-frames/s; per-sequence loop "
            f"{loop_s * 1e3 / N_SEQ_FRAMES:.2f} ms a frame, {n * N_SEQ_FRAMES / loop_s:.3f} "
            f"sequence-frames/s; graph pools {[round(p / 2**30, 3) for p in pools]} GiB [{card}]")
        if shards == 1 and n > 1:
            batched_k1[n] = first_local_map_search(step, n)
        del step, batched
        gc.collect()
        torch.cuda.empty_cache()
    return dict(frames=N_SEQ_FRAMES, runs=runs, k1={}), launches, batched_k1


def check_k1_batched(case, args):
    """check_k1 on a batched call's arguments ([B, ...], one launch): the
    batched launch bit for bit the B per-problem launches, and each problem
    against the plain version as check_k1 holds it (the culling from the
    batched launch's own summaries).  Returns check_k1's numbers over the
    batch (pairs summed, the live share averaged)."""
    import torch
    from asdslam_torch.ops import masked_nn as k1

    n = args[0].shape[0]
    (idx, best, second), prep = k1.masked_nn_tiles(*args)
    errs, pairs, shares = [], 0, []
    for b in range(n):
        one = tuple(a[b] for a in args[:9]) + (args[9],)
        single = k1.masked_nn_tiles(*one)[0]
        for name, x, y in zip(("idx", "best", "second"), (idx[b], best[b], second[b]), single):
            if not torch.equal(x, y):
                raise AssertionError(f"{case}: problem {b}'s {name} differs from its own launch")
        err, pairs_in, share = check_k1(f"{case} problem {b}", one)
        gated = k1.gate_plain(*one[2:])
        culled, _ = k1.culled_gated_pairs(k1.Prepared(
            prep.perm_a[b], prep.perm_b[b], k1.TileSummary(*(f[b] for f in prep.rows)),
            k1.TileSummary(*(f[b] for f in prep.cols))), gated, one[9])
        if culled:
            raise AssertionError(f"{case}: the batched launch culls {culled} gated-in pairs of "
                                 f"problem {b}")
        errs.append(err)
        pairs += pairs_in
        shares.append(share)
    log(f"K1 {case}: B={n} N={args[0].shape[1]} M={args[1].shape[1]} d={args[0].shape[2]}, one "
        f"launch bit for bit its {n} per-problem launches, each within check_k1's bars of the "
        f"plain version, gated-in pairs {pairs}")
    return max(errs), pairs, float(np.mean(shares))


def batched_k1_times(args, pairs_in, card):
    """CUDA-event ms of one batched launch and of its B per-problem launches
    (whole wrapper calls), beside the bound at B times the bytes and the
    batch's gated-in pairs."""
    from asdslam_torch.ops import masked_nn as k1

    n = args[0].shape[0]
    per = [tuple(a[b] for a in args[:9]) + (args[9],) for b in range(n)]
    batched_ms = time_ms(lambda: k1.masked_nn(*args), 20)
    singles_ms = time_ms(lambda: [k1.masked_nn(*p) for p in per], 20)
    bound, bound_by = k1_bound_ms(args, pairs_in)
    log(f"K1 11c local-map search B={n}: one batched launch {batched_ms:.4f} ms, {n} single "
        f"launches {singles_ms:.4f} ms, bound {bound:.5f} ms ({bound_by}) [{card}]")
    return dict(batched_ms=batched_ms, singles_ms=singles_ms, bound_ms=bound,
                bound_by=bound_by, gated_in_pairs=pairs_in)


def phase11(cfg, device, card, loop_system, errs, k1_cases):
    """11a-11e (module docstring).  ``loop_system`` is phase 6's first
    default-configuration System, after its loop.  Adds 11c's batched
    local-map searches to ``k1_cases`` / ``errs``.  Returns (the numbers
    for the multi_device line, 11c's masked_nn launches)."""
    import copy
    import tempfile
    import torch
    from asdslam_torch.frontend import track_step as ts
    from asdslam_torch.loop.loop_closing import LoopCloser
    from asdslam_torch.ops import masked_nn as k1
    from asdslam_torch.parallel import dist, multi_seq
    from asdslam_torch.utils.tracing import Tracer

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        groups = start_children(tmp, device)  # they start up while 11a-11d run
        try:
            # ---- 11a: the distributed BA step ----------------------------- #
            t0 = time.perf_counter()
            problem = make_problem_np()
            ba_res, step_ms, meshes = {}, {}, {}
            for n in MD_SHARDS:
                meshes[n] = dist.make_mesh(n, device)
                md_steps(dist.make_mesh(n, device), problem)  # warm
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                ba_res[n] = md_steps(meshes[n], problem)
                step_ms[n] = (time.perf_counter() - t1) * 1e3
            on = {str(d) for m in meshes.values() for d in m.devices}
            if len(on) != 1:
                raise AssertionError(f"11a: the shards are on {on}, not on one card")
            cpu = md_steps(dist.make_mesh(8, "cpu"), problem)
            spread = {n: md_close(f"11a {n} shards against 1", ba_res[n], ba_res[1], MD_POSE_BAR,
                                  MD_POINT_BAR) for n in MD_SHARDS[1:]}
            vs_cpu = {n: md_close(f"11a {n} shards against the CPU's 8", ba_res[n], cpu,
                                  MD_POSE_BAR, MD_POINT_BAR) for n in MD_SHARDS}
            again = md_steps(dist.make_mesh(8, device), problem)
            if not all(np.array_equal(a, b) for a, b in zip(again, ba_res[8])):
                raise AssertionError("11a: two runs of the 8-shard step differ")
            e0 = md_rmse(problem, problem[0], problem[1])
            p3, x3 = md_steps(dist.make_mesh(8, device), problem, steps=3)
            e3 = md_rmse(problem, p3, x3)
            if not (np.isfinite(p3).all() and np.isfinite(x3).all() and e3 < 0.05 * e0):
                raise AssertionError(f"11a: three steps took the error from {e0} to {e3}")
            if not np.array_equal(p3[3], problem[0][3]):
                raise AssertionError("11a: the fixed camera moved")
            reduced = {}
            for n_pts in (64, 1024):
                mesh = dist.make_mesh(8, device)
                md_steps(mesh, make_problem_np(n_pts=n_pts))
                reduced[n_pts] = mesh.reduced_elems
            bound = 4 * (3 * 3 * 36 + 3 * 36 + 2 * 3 * 6)
            if reduced[64] != reduced[1024] or not 0 < reduced[64] <= bound:
                raise AssertionError(f"11a: reduced elements {reduced} (bound {bound})")
            out["11a"] = dict(step_ms=step_ms, spread_vs_1=spread, vs_cpu=vs_cpu,
                              rmse_px=[e0, e3], reduced_elems=reduced, reduced_bound=bound,
                              seconds=time.perf_counter() - t0)
            log(f"11a the point-major BA step on {MD_SHARDS} shards of {on.pop()}: against 1 shard "
                f"(poses, points) {spread}, against the CPU's 8 shards {vs_cpu} (bars "
                f"{MD_POSE_BAR} / {MD_POINT_BAR}); two runs bitwise equal; three steps on 8 "
                f"shards {e0:.4f} -> {e3:.3g} px rms, the fixed camera unmoved; reduced "
                f"elements a step {reduced} (bound {bound}); layout + step + gather "
                + ", ".join(f"{n} shards {v:.1f} ms" for n, v in step_ms.items())
                + f" [{card}]")

            # ---- 11b: the System's mesh global BA at full width ----------- #
            t0 = time.perf_counter()
            lc0 = loop_system.loop_closer
            before = loop_system.store
            n_kf = before.n_kf
            gba = {}
            for k in (1,) + GBA_MESHES:
                lc = LoopCloser(lc0.cfg.replace(n_devices=k), lc0.K, copy.deepcopy(before),
                                device=device)
                lc.tracer = Tracer()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                lc._global_ba()
                torch.cuda.synchronize()
                gba[k] = dict(ms=(time.perf_counter() - t1) * 1e3, store=lc.store,
                              spans=sorted(lc.tracer.spans))
                if (k > 1) != (gba[k]["spans"] == ["gba_mesh"]):
                    raise AssertionError(f"11b n_devices {k}: spans {gba[k]['spans']}")
            a, b = gba[GBA_MESHES[0]]["store"], gba[GBA_MESHES[1]]["store"]
            live = a.mp_valid[:a.n_mp]
            dpose = float(np.abs(a.kf_pose[:n_kf] - b.kf_pose[:n_kf]).max())
            dpts = float(np.abs(a.mp_pos[:a.n_mp][live] - b.mp_pos[:b.n_mp][live]).max())
            moved = float(np.abs(a.kf_pose[:n_kf] - before.kf_pose[:n_kf]).max())
            if not (np.isfinite(a.kf_pose[:n_kf]).all() and np.isfinite(a.mp_pos[:a.n_mp][live]).all()
                    and moved > 0):
                raise AssertionError(f"11b: the mesh GBA left a non-finite or unmoved map "
                                     f"(moved {moved})")
            if not (dpose <= GBA_POSE_BAR and dpts <= GBA_POINT_BAR):
                raise AssertionError(f"11b: {GBA_MESHES} shards differ by poses {dpose:.3g}, "
                                     f"points {dpts:.3g} (bars {GBA_POSE_BAR} / {GBA_POINT_BAR})")
            err = {"before": map_reproj_px(before, cfg),
                   **{k: map_reproj_px(v["store"], cfg) for k, v in gba.items()}}
            out["11b"] = dict(keyframes=n_kf, map_points=int(live.sum()),
                              ms={k: v["ms"] for k, v in gba.items()}, mesh_pose_diff=dpose,
                              mesh_point_diff=dpts, moved=moved, reproj_px=err,
                              seconds=time.perf_counter() - t0)
            log(f"11b phase 6's map ({n_kf} keyframes, {int(live.sum())} points): _global_ba "
                f"through _global_ba_mesh at n_devices {GBA_MESHES}: poses {dpose:.3g}, points "
                f"{dpts:.3g} apart (bars {GBA_POSE_BAR} / {GBA_POINT_BAR}), poses moved up to "
                f"{moved:.3g}; mean reprojection error before {err['before']:.4f} px, after "
                + ", ".join(f"n_devices {k} {err[k]:.4f}" for k in gba)
                + "; host ms a call (the one-device global_bundle_adjust at n_devices 1) "
                + ", ".join(f"{k}: {v['ms']:.1f}" for k, v in gba.items()) + f" [{card}]")

            # ---- 11c: multi-sequence tracking at full width ---------------- #
            t0 = time.perf_counter()
            tracking = build_tracking(cfg, device)
            frames_u8 = tracking[2]
            out["11c"], launches, batched_k1 = phase11c(cfg, device, card, tracking)
            out["11c"]["seconds"] = time.perf_counter() - t0
            for n_seq, args in batched_k1.items():
                case = f"11c batched local-map search B={n_seq}"
                err, pairs_in, share = check_k1_batched(case, args)
                errs.append(err)
                k1_cases[case] = (args, pairs_in, share)
                out["11c"]["k1"][n_seq] = batched_k1_times(args, pairs_in, card)

            # ---- 11d: the data-parallel descriptor ------------------------- #
            from asdslam_torch.frontend.extractor import make_extractor
            from asdslam_torch.models.asdnet import ASDNet, load_weights
            weights = load_weights(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                "asdnet_weights.pkl"))
            net = ASDNet().to(device)
            net.load_state_dict(weights)
            seen = []
            make_extractor(cfg, lambda p: seen.append(p) or net(p))(
                frames_u8[1].to(device).to(torch.float32) / 255.0)
            patches = seen[0]
            dp = dist.dp_descriptor_fn(weights, dist.make_mesh(DP_PATCH_SHARDS, device))
            with torch.no_grad():
                d_dp, d_whole = dp(patches), net(patches)
            d_err = float((d_dp - d_whole).abs().max())
            if d_dp.shape != d_whole.shape or not d_err <= 2e-2:
                raise AssertionError(f"11d: {tuple(d_dp.shape)} descriptors {d_err:.3g} from "
                                     "the whole batch's (bar 2e-2)")
            out["11d"] = dict(patches=int(patches.shape[0]), shards=DP_PATCH_SHARDS,
                              max_abs_err=d_err)
            log(f"11d ASDNet (trained) on {patches.shape[0]} patches over {DP_PATCH_SHARDS} "
                f"shards: max |d| {d_err:.3g} from the whole batch (bar 2e-2)")
        except BaseException:
            for _, _, _, procs in groups:
                for p in procs:
                    p.kill()
            raise

        # ---- 11e: processes ----------------------------------------------- #
        t0 = time.perf_counter()
        kids = finish_children(groups)
        pair, alone = kids["gloo_pair"], kids["nccl_alone"]
        if [str(r["backend"]) for r in pair] != ["gloo", "gloo"] or \
                str(alone[0]["backend"]) != "nccl":
            raise AssertionError(f"11e: backends {[str(r['backend']) for r in pair]} / "
                                 f"{alone[0]['backend']}")
        on = {str(r["device"]) for r in pair + alone}
        if len(on) != 1:
            raise AssertionError(f"11e: the ranks are on {on}, not on one card")
        ranks = md_close("11e the two gloo ranks", (pair[0]["poses"], pair[0]["pts"]),
                         (pair[1]["poses"], pair[1]["pts"]), 1e-6, 1e-6)
        vs_mesh = md_close("11e the gloo ranks against the in-process 2-shard mesh",
                           (pair[0]["poses"], pair[0]["pts"]), ba_res[2], MD_POSE_BAR,
                           MD_POINT_BAR)
        if not (np.array_equal(alone[0]["poses"], ba_res[1][0])
                and np.array_equal(alone[0]["pts"], ba_res[1][1])):
            raise AssertionError("11e: the NCCL rank differs from the in-process 1-shard mesh")
        out["11e"] = dict(gloo_ranks_diff=ranks, gloo_vs_mesh2=vs_mesh,
                          nccl_vs_mesh1="bitwise", wait_s=time.perf_counter() - t0)
        log(f"11e two processes on {on.pop()} over gloo (init_multihost's rule), one shard each: "
            f"ranks {ranks} apart (bar 1e-6), {vs_mesh} from the in-process 2-shard mesh "
            f"(bars {MD_POSE_BAR} / {MD_POINT_BAR}); one NCCL rank at world size 1 bitwise the "
            f"in-process 1-shard mesh; waited {time.perf_counter() - t0:.1f} s for them")
    return out, launches


# --------------------------------------------------------------------------- #
# Phase 12: the debug image, the KITTI-proxy twin, the measurement twins
# --------------------------------------------------------------------------- #
def read_png_rgb(path):
    """(uint8 [H, W, 3], {tEXt keyword: text}) of an 8-bit RGB PNG whose
    rows all use filter 0, as viz.write_png_rgb writes them."""
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    pos, idat, text = 8, b"", {}
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if zlib.crc32(tag + body) & 0xFFFFFFFF != struct.unpack(">I", data[pos + 8 + n:
                                                                         pos + 12 + n])[0]:
            raise AssertionError(f"{path}: bad CRC in {tag}")
        if tag == b"IHDR":
            w, h, depth, colour = struct.unpack(">IIBB", body[:10])
            if (depth, colour) != (8, 2):
                raise AssertionError(f"{path}: depth {depth}, colour type {colour}")
        elif tag == b"IDAT":
            idat += body
        elif tag == b"tEXt":
            key, value = body.split(b"\x00", 1)
            text[key.decode("latin-1")] = value.decode("latin-1")
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise AssertionError(f"{path}: a row filter other than 0")
    return rows[:, 1:].reshape(h, w, 3).copy(), text


def phase12(cfg, device, card, mapped, frames_u8, errs, k1_cases):
    """12a-12c (module docstring).  ``mapped`` is phase 5's second System
    and ``frames_u8`` its frames.  Adds 12b's local-map search to
    ``k1_cases`` / ``errs`` and returns the numbers for the JSON line, with
    12b's masked_nn launches by site and 12c's two JSON lines."""
    import tempfile
    import torch
    import eval_kitti_proxy_torch
    import mfu_bench_torch
    import profile_stages_torch
    from asdslam_torch import viz
    from asdslam_torch.io import kitti_proxy

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # ---- 12a: the debug image over the last keyframe's frame --------- #
        s = mapped.store
        k = int(np.flatnonzero(s.kf_valid)[-1])
        frame = frames_u8[int(s.kf_frame_id[k])]
        path = os.path.join(tmp, "debug.png")
        t0 = time.perf_counter()
        info = mapped.save_debug_image(path, image=frame)
        sec = time.perf_counter() - t0
        ref, proj, obs, ok = mapped.debug_info()
        img, text = read_png_rgb(path)
        want = viz.draw_debug_overlay(frame.shape, obs, proj, ok, viz.debug_caption(ref),
                                      backdrop=frame.numpy())
        if info != ref or not info["n_matches"]:
            raise AssertionError(f"12a: save_debug_image returned {info}, debug_info {ref}")
        if img.shape != (cfg.image_height + viz.BAND_H, cfg.image_width, 3) \
                or not np.array_equal(img, want) or text != {"Title": viz.debug_caption(ref)}:
            raise AssertionError(f"12a: the PNG reads back as {img.shape} {text}")
        centres = np.rint(proj[ok][:, ::-1]).astype(np.int64)
        inside = ((centres >= 0) & (centres < (cfg.image_height, cfg.image_width))).all(1)
        if not (img[centres[inside, 0], centres[inside, 1]] == viz.RED).all():
            raise AssertionError("12a: a reprojection's pixel is not red")
        out["12a"] = dict(info=info, png_bytes=os.path.getsize(path), shape=list(img.shape),
                          seconds=sec)
        log(f"12a save_debug_image over keyframe {k}'s frame: {info}; a {img.shape} PNG of "
            f"{out['12a']['png_bytes']} bytes read back equal to the drawn overlay, title "
            f"{text['Title']!r}; {sec * 1e3:.1f} ms [{card}]")

        # ---- 12b: eval_kitti_proxy_torch on two synthetic KITTI-like paths  #
        # "right" through K1, then again through K1's plain version on the
        # card and with the frames rendered on the CPU (what each adds to the
        # gap between the card's ATEs and the CPU's), "left" through K1
        saved = kitti_proxy.GT_DIR, kitti_proxy.CAM_DIR
        runs, launches, by_site, gaps = {}, 0, {}, {}
        routes = {"kernel": lambda: local_map_search(cfg), "plain": plain_k1,
                  "cpu_frames": lambda: cpu_rendered(kitti_proxy, device)}
        try:
            for path, route in (("right", "kernel"), ("right", "plain"),
                                ("right", "cpu_frames"), ("left", "kernel")):
                root = os.path.join(tmp, path)
                write_kitti_ground_truth(root, path)
                kitti_proxy.GT_DIR = kitti_proxy.CAM_DIR = root
                kernel = route != "plain"
                with routes[route]() as kept:
                    (system, result), text, run_b, sec = run_entry(
                        eval_kitti_proxy_torch.main,
                        ["--device", device, "--out", os.path.join(root, f"{route}.json")])
                line = last_json(text)
                if (result["frames"], result["scale"]) != (N_KITTI, 1.0) \
                        or system.cfg.image_width != 1241 \
                        or system.cfg.fx != float(KITTI03_CAM.split(",")[0]):
                    raise AssertionError(f"12b: not the full-width KITTI 03 camera: {line}")
                if result["tracked"] < KITTI_TRACKED_BAR * N_KITTI:
                    raise AssertionError(f"12b {path} {route}: {result['tracked']} of {N_KITTI} "
                                         f"tracked")
                bars = KITTI_ATE_BARS[path]
                for key in KITTI_ATES:
                    if not result.get(key, np.inf) < bars[key]:
                        raise AssertionError(f"12b {path} {route}: {key} {result.get(key)} >= "
                                             f"{bars[key]}")
                if kernel and (run_b["by_site"].get("step", 0) < 1
                               or run_b["by_site"].get("fuse", 0) < 1
                               or (route == "kernel" and "args" not in kept)):
                    raise AssertionError(f"12b {path}: masked_nn launches {run_b['by_site']}")
                if not kernel and run_b["launches"]:
                    raise AssertionError(f"12b {path} plain: masked_nn launched "
                                         f"{run_b['by_site']}")
                if route == "kernel" and path == "right":
                    case = "KITTI proxy local-map search"
                    err, pairs_in, share = check_k1(case, kept["args"])
                    errs.append(err)
                    k1_cases[case] = (kept["args"], pairs_in, share)
                if kernel:
                    launches += run_b["launches"]
                    for site, c in run_b["by_site"].items():
                        by_site[site] = by_site.get(site, 0) + c
                if route == "cpu_frames":
                    gaps["kitti_right"] = kept["gaps"]
                render = system.tracer.spans["render"].total
                runs[f"{path}_{route}"] = dict(
                    result={k: v for k, v in result.items() if k not in ("drift", "drift_kf")},
                    render_s=render, seconds=sec, launches=run_b["launches"],
                    by_site=run_b["by_site"])
                log(f"12b eval_kitti_proxy_torch.py (1241x376, KITTI 03's intrinsics, {N_KITTI} "
                    f"frames of the synthetic path {path!r}: {KITTI_PATHS[path][0]} m and "
                    f"{KITTI_PATHS[path][1]} rad of yaw a frame), "
                    + {"kernel": "K1", "plain": "K1 replaced by its plain version",
                       "cpu_frames": "K1, the frames rendered on the CPU"}[route] + ": tracked "
                    f"{result['tracked']}, keyframes {result['keyframes']}, sim3 ATE frame / "
                    f"keyframe / recomposed " + " / ".join(str(result.get(k)) for k in KITTI_ATES)
                    + f" m over {result['path_length_m']} m (bars: tracked >= {KITTI_TRACKED_BAR} "
                    f"of the frames, ATEs < " + " / ".join(f"{bars[k]:.3f}" for k in KITTI_ATES)
                    + f"; the JAX package's eval_kitti_proxy.py on a CPU {REF_KITTI[path]}); "
                    f"{result['fps']} frames/s, {result['fps_tracking']} without the render span "
                    f"({render:.2f} s over {N_KITTI} renders); masked_nn launches "
                    f"{run_b['launches']} {run_b['by_site']}; {sec:.1f} s [{card}]")
        finally:
            kitti_proxy.GT_DIR, kitti_proxy.CAM_DIR = saved
        spread = {k: [runs[r]["result"].get(k) for r in runs] for k in KITTI_ATES}
        log(f"12b the runs' ATEs ({', '.join(runs)}): {spread}")

        # ---- 12b: the card's renders against the CPU's --------------------- #
        t0 = time.perf_counter()
        gaps["euroc"] = euroc_render_gap(device)
        for name, what in (("kitti_right", f"the {N_KITTI} frames of 'right'"),
                           ("euroc", f"EuRoC-proxy frames {list(EUROC_GAP_FRAMES)}")):
            log(f"12b renders, the card against the CPU, {what}: {gap_text(gaps[name])} "
                f"[{card}]")
            check_gaps(f"12b {name}", gaps[name])
        out["12b"] = dict(runs=runs, tracked_bar=KITTI_TRACKED_BAR, ate_bars_m=KITTI_ATE_BARS,
                          ref=REF_KITTI, launches=launches, by_site=by_site,
                          render_gap={k: gap_sums(v) for k, v in gaps.items()},
                          render_gap_s=time.perf_counter() - t0)

    # ---- 12c: the measurement twins in-process ---------------------------- #
    for name, main_fn in (("mfu_bench_torch", mfu_bench_torch.main),
                          ("profile_stages_torch", profile_stages_torch.main)):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            ret = main_fn(["--device", device])
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        lines = buf.getvalue().splitlines()
        if json.loads(lines[-1]) != ret or ret["card"] != card:
            raise AssertionError(f"12c: {name} printed {lines[-1][:300]}")
        for l in lines:
            log(f"  {name}: {l}")
        out[name] = dict(ret, seconds=sec)
    rows = out["mfu_bench_torch"]["kernels"]
    for r in rows:
        shares = [r[k] for k in ("mfu", "bw_util", "sol_frac")]
        if any(x is None or not 0 < x <= 1.05 for x in shares):
            raise AssertionError(f"12c: {r}")
    if len(out["profile_stages_torch"]["stages"]) != 7:
        raise AssertionError(f"12c: stages {out['profile_stages_torch']['stages']}")
    log("12c roofline: " + "; ".join(
        f"{r['name']} {r['ms']:.3f} ms, MFU {r['mfu']:.3g} of the {r['peak']} peak, bandwidth "
        f"{r['bw_util']:.3g}, {r['bound']}-bound, sol_frac {r['sol_frac']:.3g}" for r in rows)
        + f" [{card}]")
    return out


# --------------------------------------------------------------------------- #
# Phase 13: singular inputs and the LM loops' host synchronisations
# --------------------------------------------------------------------------- #
LM_ITERS = (1, 3)
SING_N = 200
SING_K = np.array([[500.0, 0.0, 320.0], [0.0, 500.0, 240.0], [0.0, 0.0, 1.0]], np.float32)


def gba_problem_np(n_cams=5, n_pts=120, seed=5):
    """A global-BA problem from numpy: cameras along x yawing 0.05 rad
    apart, points in front, 0.3 px noise, the first two cameras fixed and
    moved last (the reference's gauge order), the others and the points
    perturbed.  Returns (poses7, points, pt_valid, cam_idx, pt_idx, uv,
    inv_sigma2, valid, n_opt) for SING_K."""
    g = np.random.default_rng(seed)
    X = (g.uniform(-3, 3, (n_pts, 3)) + [0.0, 0.0, 8.0]).astype(np.float32)
    yaw = 0.05 * np.arange(n_cams)
    q = np.stack([np.cos(yaw / 2), 0 * yaw, np.sin(yaw / 2), 0 * yaw], 1)
    t = np.stack([0.4 * np.arange(n_cams) - 1.0, 0 * yaw, 0.1 * np.arange(n_cams)], 1)
    poses = np.concatenate([q, t], 1).astype(np.float32)
    cam_idx = np.repeat(np.arange(n_cams), n_pts).astype(np.int32)
    pt_idx = np.tile(np.arange(n_pts), n_cams).astype(np.int32)
    c, s = np.cos(yaw)[cam_idx], np.sin(yaw)[cam_idx]
    x, y, z = X[pt_idx].T
    xc = np.stack([c * x + s * z, y, -s * x + c * z], 1) + t[cam_idx]
    uv = (xc[:, :2] / xc[:, 2:] * 500.0 + [320.0, 240.0]
          + 0.3 * g.standard_normal((len(cam_idx), 2))).astype(np.float32)
    order = list(range(2, n_cams)) + [0, 1]
    poses0 = poses[order]
    poses0[:n_cams - 2, 4:] += (0.05 * g.standard_normal((n_cams - 2, 3))).astype(np.float32)
    X0 = (X + 0.05 * g.standard_normal(X.shape)).astype(np.float32)
    O = len(cam_idx)
    cam_remap = np.argsort(order).astype(np.int32)[cam_idx]
    return (poses0, X0, np.ones(n_pts, bool), cam_remap, pt_idx, uv,
            np.ones(O, np.float32), np.ones(O, bool), n_cams - 2)


def pose_graph_problem_np(n=40, seed=7):
    """An essential graph from numpy: a chain of ``n`` sim3 keyframes 1 m
    and 0.02 rad of yaw apart, drifted in every step (a bias and numpy's
    noise of seed ``seed``), with edges to
    the next and to the one after (weight 1) and a loop edge from the last
    back to the first (weight 5), the first fixed.  Returns (poses8, i, j,
    meas, weight, fixed)."""
    import torch
    from asdslam_torch.geometry import sim3

    g = np.random.default_rng(seed)
    step = torch.tensor([0.0, 0.02, 0.0, 1.0, 0.0, 0.0, 0.0])
    drift = torch.tensor([0.0, 0.0, 0.01, 0.0, 0.02, 0.0, 0.004])
    gt = [sim3.sim3_pack(torch.ones(()), torch.eye(3), torch.zeros(3))]
    for _ in range(n - 1):
        gt.append(sim3.retract(gt[-1], step))
    est = [gt[0]]
    for _ in range(n - 1):
        noise = torch.tensor(g.normal(0, 0.005, 7), dtype=torch.float32)
        est.append(sim3.retract(est[-1], step + drift + noise))
    pairs = [(a, a + 1, 1.0) for a in range(n - 1)] + [(a, a + 2, 1.0) for a in range(n - 2)]
    pairs.append((0, n - 1, 5.0))
    meas = []
    for a, b, _ in pairs:
        Sa, Sb = sim3.sim3_unpack(gt[a]), sim3.sim3_unpack(gt[b])
        meas.append(sim3.sim3_pack(*sim3.compose(*Sb, *sim3.inverse(*Sa))))
    fixed = np.zeros(n, bool)
    fixed[0] = True
    return (torch.stack(est).numpy(), np.array([a for a, _, _ in pairs]),
            np.array([b for _, b, _ in pairs]), torch.stack(meas).numpy(),
            np.array([w for _, _, w in pairs], np.float32), fixed)


def host_syncs(fn):
    """The host synchronisations ``fn()`` makes on the card, each as the
    "file:line" of the Python call that made it: the warnings of
    torch.cuda.set_sync_debug_mode("warn") while it runs."""
    import warnings
    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message)]


def lm_sync_counts(device):
    """The essential graph's and global BA's host synchronisations at each
    of LM_ITERS iterations, on pose_graph_problem_np and gba_problem_np
    uploaded to ``device``: {"pose_graph": {iters: [their "file:line"]},
    "global_ba": ...}."""
    import torch
    from asdslam_torch.backend import ba, global_ba, pose_graph

    def dev(x):
        return torch.as_tensor(x).to(device)

    poses8, i, j, meas, w, fixed = map(dev, pose_graph_problem_np())
    edges = pose_graph.PoseGraphEdges(i=i, j=j, meas=meas, weight=w,
                                      valid=torch.ones(len(w), dtype=torch.bool, device=device))
    poses7, X, pt_valid, *obs, n_opt = gba_problem_np()
    obs = ba.Obs(*map(dev, obs))
    args = (dev(poses7), dev(X), dev(pt_valid), obs, dev(SING_K))
    runs = {"pose_graph": lambda n: pose_graph.optimize_pose_graph(poses8, edges, fixed,
                                                                    iters=n),
            "global_ba": lambda n: global_ba.global_bundle_adjust(*args, n_opt=n_opt, iters=n)}
    for run in runs.values():
        host_syncs(lambda: run(1))  # warm: the process's one-off work is not the loop's
    return {name: {n: host_syncs(lambda: run(n)) for n in LM_ITERS}
            for name, run in runs.items()}


def with_value(problem, k, at, value):
    """``problem`` (a tuple of arrays) with element ``at`` of its ``k``-th
    array set to ``value``."""
    x = problem[k].copy()
    x[at] = value
    return problem[:k] + (x,) + problem[k + 1:]


def singular_inputs():
    """The singular and degenerate inputs of phase 13a, which
    tests/test_torch_singular.py feeds to both packages: numpy arrays from
    a generator of fixed seed, SING_N features where a function takes
    features."""
    import torch
    from asdslam_torch.geometry import sim3

    n = SING_N
    g = np.random.default_rng(0)

    def unit(x):
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)

    uv1 = g.uniform(0, 480, (n, 2)).astype(np.float32)
    uv2 = (uv1 + g.normal(0, 1, uv1.shape)).astype(np.float32)
    uv_far = uv1 + 1.0                # its mean deviation overflows: T2 singular
    uv_far[3, 0] = 3e38
    desc = unit(g.standard_normal((64, 128)))
    pg, gba = pose_graph_problem_np(), gba_problem_np()
    s = np.array([0.0, 1.0, 1.3, 0.0, 0.7], np.float32)
    R = sim3.se3.so3_exp(torch.tensor(g.normal(0, 0.3, (5, 3)),
                                    dtype=torch.float32)).numpy()
    t = g.normal(0, 1, (5, 3)).astype(np.float32)
    t[1, 0], t[2, 2] = np.inf, np.nan
    return dict(
        K=SING_K, K0=np.zeros((3, 3), np.float32), valid=np.ones(n, bool),
        pixels={p: np.tile(np.asarray(p, np.float32), (n, 1)) for p in ((0.0, 0.0),
                                                                         (100.0, 50.0))},
        uv1=uv1, uv2=uv2, uv_far=uv_far,
        # a zero, a rank-1, a regular and a rank-2 homography
        H=np.stack([np.zeros((3, 3)), np.outer([1.0, 2.0, 3.0], [1.0, 0.0, 1.0]), np.eye(3),
                    np.diag([1.0, 1.0, 0.0])]).astype(np.float32),
        H_diag=np.diag([1.0, 1.2, 0.9]).astype(np.float32),
        # (R1, t1, R2, t2) of fundamental_from_poses
        poses=(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
               np.eye(3, dtype=np.float32), np.ones(3, np.float32)),
        X=(g.uniform(-2, 2, (n, 3)) + [0.0, 0.0, 6.0]).astype(np.float32),
        chi2=np.full(n, 5.991, np.float32),
        # triangulate_neighbors: a keyframe's descriptors and pixels, one
        # neighbour's near copies of them 0.5 m to the side
        tri=dict(desc=desc, uv=uv1[:64], nb_desc=unit(desc + 0.05 * g.standard_normal(
            desc.shape)), nb_uv=(uv1[:64] + g.normal(0, 2, (64, 2))).astype(np.float32),
            nb_t=np.array([0.5, 0.0, 0.0], np.float32)),
        pose_graph={"a NaN measurement": with_value(pg, 3, (3, 4), np.nan),
                    "an infinite measurement": with_value(pg, 3, (3, 4), np.inf)},
        global_ba={"a NaN observation": with_value(gba, 5, (5, 0), np.nan),
                   "an infinite observation": with_value(gba, 5, (5, 0), np.inf),
                   "a NaN point": with_value(gba, 1, (2, 1), np.nan)},
        sim3=(s, R, t),
        zero_blocks=np.zeros((2, 3, 3), np.float32))


def singular_cases():
    """singular_inputs through the port: name -> a function of a device
    that returns [(label, output, atol, rtol)] (atol None: the finiteness
    pattern alone), with the bars of tests/test_torch_singular.py and a CPU
    generator of fixed seed for the RANSAC draws."""
    import torch
    from asdslam_torch.backend import ba, global_ba, mapping_kernels, pose_graph
    from asdslam_torch.estimators import linalg, pnp, twoview
    from asdslam_torch.geometry import sim3
    from asdslam_torch.ops import match

    x = singular_inputs()
    draws = torch.rand(300, SING_N, generator=torch.Generator().manual_seed(0))
    eye, tri = np.eye(3, dtype=np.float32), x["tri"]

    def on(dev, *xs):
        return [torch.as_tensor(a).to(dev) for a in xs]

    def two_view(uv1, uv2, K):
        def run(dev):
            r = twoview.initialize_two_view(*on(dev, draws[:200], uv1, uv2, x["valid"], K))
            chosen = "score_h" if bool(r.used_homography) else "score_f"
            return ([(f, getattr(r, f), 0.0, 1e-4 if f == chosen else 2e-2)
                     for f in ("score_h", "score_f")]
                    + [(f, getattr(r, f), None, None) for f in ("R", "t", "points")]
                    + [(f, getattr(r, f), 0.0, 0.0) for f in ("success", "used_homography",
                                                              "good")])
        return run

    def outputs(fn, atol=0.0, rtol=0.0):
        return lambda dev: [(f"output {k}", o, atol, rtol) for k, o in enumerate(fn(dev))]

    def tri_run(dev):
        return mapping_kernels.triangulate_neighbors(
            *on(dev, tri["desc"], tri["uv"], np.zeros(64, np.int64), np.ones(64, bool)),
            on(dev, tri["nb_desc"]), on(dev, tri["nb_uv"]), on(dev, np.zeros(64, np.int64)),
            *on(dev, np.ones((1, 64), bool), eye[None], tri["nb_t"][None], eye,
                np.zeros(3, np.float32), x["K0"], np.ones(8, np.float32)),
            max_dist=1.0, ratio=0.9, fmean=500.0)

    def pg(problem):
        def run(dev):
            p, a, b, m, w, f = on(dev, *problem)
            edges = pose_graph.PoseGraphEdges(i=a, j=b, meas=m, weight=w,
                                              valid=torch.ones(len(w), dtype=torch.bool,
                                                               device=dev))
            return [pose_graph.optimize_pose_graph(p, edges, f, iters=3)]
        return run

    def gba(problem):
        poses7, X, pt_valid, *obs, n_opt = problem

        def run(dev):
            return global_ba.global_bundle_adjust(*on(dev, poses7, X, pt_valid),
                                                  ba.Obs(*on(dev, *obs)), *on(dev, SING_K),
                                                  n_opt=n_opt, iters=3, cg_iters=20)
        return run

    (p0, p1), K, K0 = x["pixels"].values(), x["K"], x["K0"]
    return {
        "two-view, every feature at (0, 0)": two_view(p0, p0, K),
        "two-view, every feature at (100, 50)": two_view(p1, p1, K),
        "two-view, a feature at x = 3e38 (T2 singular)": two_view(x["uv1"], x["uv_far"], K),
        "two-view, K = 0": two_view(x["uv1"], x["uv2"], K0),
        "_score_h on singular hypotheses": outputs(
            lambda dev: twoview._score_h(*on(dev, x["H"], x["uv1"], x["uv2"], x["valid"]), 1.0),
            rtol=1e-4),
        "fundamental_from_poses, K = 0": outputs(
            lambda dev: [match.fundamental_from_poses(*on(dev, K0, *x["poses"]))]),
        "_decompose_h, K = 0": outputs(lambda dev: twoview._decompose_h(*on(dev, x["H_diag"],
                                                                           K0))),
        "ransac_pnp, K = 0": outputs(lambda dev: pnp.ransac_pnp(*on(
            dev, draws, x["X"], x["uv1"], x["valid"], K0, x["chi2"]))),
        "triangulate_neighbors, K = 0": outputs(tri_run),
        **{f"optimize_pose_graph, {k}": outputs(pg(v), atol=1e-5)
           for k, v in x["pose_graph"].items()},
        **{f"global_bundle_adjust, {k}": outputs(gba(v), atol=2e-5, rtol=1e-3)
           for k, v in x["global_ba"].items()},
        "sim3_log, s = 0 and a non-finite t": outputs(
            lambda dev: [sim3.sim3_log(*on(dev, *x["sim3"]))], atol=1e-5, rtol=1e-4),
        "inv3x3 of a zero block": outputs(lambda dev: [linalg.inv3x3(*on(dev,
                                                                         x["zero_blocks"]))]),
    }


def check_singular(device):
    """Each of singular_cases on ``device`` against the CPU: the same
    finiteness pattern in every output, integer and boolean outputs equal,
    finite values within the stated bars.  Returns {case: the number of
    non-finite output elements on the card}."""
    out = {}
    for name, run in singular_cases().items():
        nonfinite = 0
        for (label, a, atol, rtol), (_, b, _, _) in zip(run(device), run("cpu")):
            a, b = a.detach().cpu().numpy(), b.detach().numpy()
            if a.dtype.kind != "f":
                ok = np.array_equal(a, b)
            else:
                fin = np.isfinite(b)
                ok = np.array_equal(np.isfinite(a), fin) and (
                    atol is None or np.allclose(a[fin], b[fin], atol=atol, rtol=rtol))
                nonfinite += int((~np.isfinite(a)).sum())
            if not ok:
                raise AssertionError(f"13a {name}: {label} on the card {a.ravel()[:8]} against "
                                     f"the CPU's {b.ravel()[:8]}")
        out[name] = nonfinite
    return out


def phase13(device, card):
    """13a-13b (module docstring); returns the numbers for the JSON line."""
    t0 = time.perf_counter()
    nonfinite = check_singular(device)
    log(f"13a singular and degenerate inputs, the card against the CPU, each output's "
        f"finiteness pattern and values: {len(nonfinite)} cases agree; non-finite output "
        f"elements on the card by case {nonfinite}; {time.perf_counter() - t0:.1f} s [{card}]")
    syncs = lm_sync_counts(device)
    counts = {k: {n: len(v) for n, v in by_iters.items()} for k, by_iters in syncs.items()}
    log(f"13b host synchronisations (set_sync_debug_mode warnings) by LM iterations: "
        + "; ".join(f"{k} " + ", ".join(f"{n} -> {len(c)} at {sorted(set(c))}"
                                        for n, c in v.items())
                    for k, v in syncs.items()) + f" [{card}]")
    for name, by_iters in counts.items():
        if len(set(by_iters.values())) != 1:
            raise AssertionError(f"13b: {name}'s host synchronisations change with its LM "
                                 f"iterations: {syncs[name]}")
    return dict(singular_nonfinite=nonfinite, lm_syncs=counts,
                seconds=time.perf_counter() - t0)


def tree_leaves(x):
    if isinstance(x, (tuple, list)):
        return [leaf for f in x for leaf in tree_leaves(f)]
    return [x]


# --------------------------------------------------------------------------- #
# Phase 14: the CUDA-graph capture (asdslam_torch/utils/graphs.py)
# --------------------------------------------------------------------------- #
def same_bits(a, b):
    """Tensors (or constants) equal bit for bit: shape, dtype and bytes
    (NaN equals NaN of the same payload, -0.0 differs from 0.0)."""
    import torch

    if not isinstance(a, torch.Tensor):
        return a == b
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    flat = [t.detach().reshape(-1).contiguous().cpu() for t in (a, b)]
    return torch.equal(flat[0].view(torch.uint8), flat[1].view(torch.uint8))


def tree_same_bits(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(same_bits(x, y) for x, y in zip(la, lb))


@contextlib.contextmanager
def eager_sites(names=None):
    """Inside the block the capture sites run eagerly: with no ``names``
    every site (graphs.captured returns its function, for the extractors
    and fused steps built inside the block; the module-level captured LM
    iterations, JIT_SITES and LAST_SITES are their ``.eager``); else the
    JIT_SITES or LAST_SITES named.  A patch of this script only: the port
    has no such switch."""
    from asdslam_torch.backend import ba, global_ba, pose_graph
    from asdslam_torch.utils import graphs

    owners = site_owners([*JIT_SITES, *LAST_SITES] if names is None else names)
    saved = []
    if names is None:
        saved.append((graphs, "captured", graphs.captured))
        owners += [(m, "_lm_step") for m in (ba, global_ba, pose_graph)]
    saved += [(m, a, getattr(m, a)) for m, a in owners]
    if names is None:
        graphs.captured = lambda fn, name, grad=False: fn
    for m, a in owners:
        setattr(m, a, getattr(m, a).eager)
    try:
        yield
    finally:
        for owner, name, value in saved:
            setattr(owner, name, value)


def local_ba_problem(cfg, device, points=4096, obs=16384):
    """bench_torch.py's local-BA problem (seed 9): local_ba_max_kfs +
    local_ba_max_fixed cameras, ``points`` points, ``obs`` observations.
    Returns (BAProblem, K, n_opt)."""
    import torch
    from asdslam_torch.backend import ba

    K = torch.tensor([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1.0]])
    C = cfg.local_ba_max_kfs + cfg.local_ba_max_fixed
    gen = torch.Generator().manual_seed(9)
    pts = torch.rand(points, 3, generator=gen) * 10.0 - 5.0 + torch.tensor([0.0, 0.0, 10.0])
    poses7 = torch.tensor([1.0, 0, 0, 0, 0, 0, 0]).repeat(C, 1)
    poses7[:, 6] = torch.arange(C) * 0.1
    cam_idx = torch.randint(0, C, (obs,), generator=gen)
    pt_idx = torch.randint(0, points, (obs,), generator=gen)
    uv = torch.stack([K[0, 0] * pts[pt_idx, 0] / pts[pt_idx, 2] + K[0, 2],
                      K[1, 1] * pts[pt_idx, 1] / pts[pt_idx, 2] + K[1, 2]], 1)
    o = ba.Obs(cam_idx=cam_idx.to(device), pt_idx=pt_idx.to(device), uv=uv.to(device),
               inv_sigma2=torch.ones(obs, device=device),
               valid=torch.ones(obs, dtype=torch.bool, device=device))
    pt_obs = ba.build_pt_obs(pt_idx.numpy(), np.ones(obs, bool), points, 16)
    prob = ba.BAProblem(poses7=poses7.to(device), points=pts.to(device),
                        pt_valid=torch.ones(points, dtype=torch.bool, device=device),
                        obs=o, pt_obs=torch.as_tensor(pt_obs).to(device))
    return prob, K.to(device), cfg.local_ba_max_kfs


def check_chain(step, frames_u8, state, cand, count):
    """The captured step over ``count`` chained frames against its
    ``.eager``, frame by frame, bit for bit in every output (features and
    TrackResult), with K1 launched 3 times a frame (replays counted).
    Returns (the eager chain's outputs, the launches counted)."""
    import torch
    from asdslam_torch.ops import masked_nn as k1

    eager = chain_outputs(step.eager, frames_u8, state, cand, 1, count)
    torch.cuda.synchronize()
    k1.masked_nn.launches = 0
    replayed = chain_outputs(step, frames_u8, state, cand, 1, count)
    torch.cuda.synchronize()
    if k1.masked_nn.launches != 3 * count:
        raise AssertionError(f"14a: masked_nn counted {k1.masked_nn.launches} launches in "
                             f"{count} captured frames, not {3 * count}")
    for i, (a, b) in enumerate(zip(replayed, eager)):
        if not tree_same_bits(a, b):
            bad = [n for n, (x, y) in enumerate(zip(tree_leaves(a), tree_leaves(b)))
                   if not same_bits(x, y)]
            raise AssertionError(f"14a: frame {i + 1}: the captured step differs from the eager "
                                 f"one in output leaves {bad}")
    return eager, k1.masked_nn.launches


def check_extractors(cfg, extract, frames_u8, device):
    """The captured extractor, and the same wrapped by with_undistortion
    through EuRoC's lens, against their eager functions (the lens wrapper
    over the eager extractor) on 3 corridor frames twice over (warm-up,
    capture, replays), bit for bit.  Returns {name: (eager ms, captured
    ms)} by CUDA events."""
    import torch
    from asdslam_torch.frontend.extractor import with_undistortion
    from asdslam_torch.geometry import camera

    dist = [float(x) for x in EUROC_CAM.split(",")[4:]]
    cam = camera.Camera.create(cfg.fx, cfg.fy, cfg.cx, cfg.cy, *dist, device=device)
    with eager_sites():
        lens_eager = with_undistortion(extract.eager, cam)
    images = [f.to(device).to(torch.float32) * (1.0 / 255.0) for f in frames_u8[1:4]]
    out = {}
    for name, ex, eager in (("extract", extract, extract.eager),
                            ("extract_undistorted", with_undistortion(extract, cam), lens_eager)):
        for _ in range(2):
            for i, img in enumerate(images):
                if not tree_same_bits(ex(img), eager(img)):
                    raise AssertionError(f"14a: the captured {name} differs from the eager one "
                                         f"on frame {i + 1}")
        out[name] = (time_ms(lambda: eager(images[0]), 10), time_ms(lambda: ex(images[0]), 10))
    return out


def pipelined_hazard(step, frames_u8, state, cand, eager):
    """14b: frame k + 1 is queued (its inputs copied into the graph's static
    buffers, the graph replayed) before frame k's result is fetched, as
    Tracker._process_pipelined does; each fetched frame must equal the eager
    chain's.  Returns the frames compared."""
    feat, geom, pose, vel, crow = (state[k] for k in ("feat", "geom", "pose", "vel", "crow"))
    pend, fetched = None, []
    for i in range(1, len(eager) + 1):
        feat, res = step(frames_u8[i], pose, vel, feat, geom, cand, crow)
        if pend is not None:
            fetched.append(tuple(t.cpu() for t in tree_leaves(pend)))
        pend = (feat, res)
        geom, pose, vel, crow = res.next_geom, res.pose, res.velocity, res.crow
    fetched.append(tuple(t.cpu() for t in tree_leaves(pend)))
    for k, (got, want) in enumerate(zip(fetched, eager)):
        if not tree_same_bits(got, tuple(tree_leaves(want))):
            raise AssertionError(f"14b: frame {k + 1} fetched after frame {k + 2} was queued "
                                 "differs from the eager chain's")
    return len(fetched)


def chain_ms(step, frames_u8, state, cand, count=N_CHAINED):
    """(host ms, CUDA-event ms) a frame over ``count`` chained frames,
    synchronised once at the end, after a warm chain of two."""
    import torch

    chain_outputs(step, frames_u8, state, cand, 1, 2)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    chain_outputs(step, frames_u8, state, cand, 1, count)
    end.record()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / count, start.elapsed_time(end) / count


def timed_call(fn):
    """(fn(), host ms until the card is done with it)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def check_lm_call(fn, args, kwargs):
    """An LM loop on recorded inputs: eagerly (``eager_sites``), then
    captured twice (the first call on a new key warms one iteration and
    captures the next; the second replays them all), bit for bit equal.
    Returns the host ms of the three calls."""
    with eager_sites():
        want, eager_ms = timed_call(lambda: fn(*args, **kwargs))
    first, first_ms = timed_call(lambda: fn(*args, **kwargs))
    again, again_ms = timed_call(lambda: fn(*args, **kwargs))
    for name, got in (("first captured call", first), ("second captured call", again)):
        if not tree_same_bits(got, want):
            raise AssertionError(f"14c: {getattr(fn, '__name__', fn)}'s {name} differs from "
                                 "the eager run")
    return dict(eager_ms=eager_ms, captured_first_ms=first_ms, captured_ms=again_ms)


@contextlib.contextmanager
def record_lm_calls():
    """Keep the arguments (cloned at call time) of the first essential
    graph, the first global BA and the local BA call with the most
    optimized cameras made inside the block, from any thread: the yielded
    dict maps each function's name to (function, args, kwargs)."""
    from asdslam_torch.backend import ba, global_ba, pose_graph

    kept, lock = {}, threading.Lock()

    def recorder(owner, name):
        real = getattr(owner, name)

        def wrapper(*a, **kw):
            size = kw.get("n_opt", 0)
            with lock:
                keep = name not in kept or (name == "bundle_adjust" and size > kept[name][0])
                if keep:
                    kept[name] = (size, real, clone_tree(a), clone_tree(kw))
            return real(*a, **kw)
        return real, wrapper

    patched = [(m, n) for m, n in ((pose_graph, "optimize_pose_graph"),
                                   (global_ba, "global_bundle_adjust"),
                                   (ba, "bundle_adjust"))]
    reals = []
    for owner, name in patched:
        real, wrapper = recorder(owner, name)
        reals.append((owner, name, real))
        setattr(owner, name, wrapper)
    out = {}
    try:
        yield out
    finally:
        for owner, name, real in reals:
            setattr(owner, name, real)
        out.update({name: v[1:] for name, v in kept.items()})


def phase14(cfg, step, extract, frames_u8, state, cand, lm_calls, captured_run, weights,
            device, card):
    """14a-14d (module docstring); ``extract`` is the step's extractor,
    ``lm_calls`` phase 6's record_lm_calls, ``captured_run`` phase 5's
    second run.  Returns the numbers for the
    JSON line; the profiler's readings come later (14a's idle share)."""
    import torch
    from asdslam_torch.backend import ba

    out = {}
    # ---- 14a: the fused step, captured against eager ------------------------ #
    eager, launches = check_chain(step, frames_u8, state, cand, N_CHAINED)
    timings = {}
    for name, fn in (("eager", step.eager), ("captured", step), ("captured_again", step),
                     ("eager_again", step.eager)):
        timings[name] = chain_ms(fn, frames_u8, state, cand)
    pools = step.graphs.stats()
    extractors = check_extractors(cfg, extract, frames_u8, device)
    log("14a the extractors captured against .eager on 3 frames, twice: bitwise equal; ms a "
        "call (CUDA events, eager / captured): "
        + ", ".join(f"{k} {e:.3f} / {c:.3f}" for k, (e, c) in extractors.items()) + f" [{card}]")
    out["14a"] = dict(frames=N_CHAINED, launches=launches, extractor_ms=extractors,
                      host_ms_a_frame={k: v[0] for k, v in timings.items()},
                      event_ms_a_frame={k: v[1] for k, v in timings.items()}, graphs=pools)
    log(f"14a the fused step over {N_CHAINED} chained frames, captured against .eager: every "
        f"output bitwise equal frame by frame, masked_nn 3 launches a frame through replays; ms "
        f"a frame (host clock / CUDA events, eager, captured, captured, eager): "
        + ", ".join(f"{k} {h:.2f} / {e:.2f}" for k, (h, e) in timings.items())
        + f"; the step's graphs (replays, pool bytes, capture ms): "
        + ", ".join(f"({g['replays']}, {g['pool_bytes']}, {g['capture_ms']:.0f})" for g in pools)
        + f" [{card}]")
    # ---- 14b: frame k + 1 queued before frame k is fetched ----------------- #
    n = pipelined_hazard(step, frames_u8, state, cand, eager)
    out["14b"] = dict(frames=n)
    log(f"14b {n} frames each fetched after the next was queued equal the eager chain's")
    # ---- 14c: the three LM loops ------------------------------------------- #
    prob, K, n_opt = local_ba_problem(cfg, device)
    calls = dict(lm_calls)
    calls["bench local BA 64 cameras, 4096 points"] = (
        ba.bundle_adjust, (prob, K), dict(n_opt=n_opt, iters=15))
    lm = {}
    for name, (fn, args, kwargs) in calls.items():
        lm[name] = check_lm_call(fn, args, kwargs)
        ms = lm[name]
        log(f"14c {name}: captured bitwise equal to eager; host ms eager {ms['eager_ms']:.1f}, "
            f"captured first call (warm-up + capture) {ms['captured_first_ms']:.1f}, "
            f"captured {ms['captured_ms']:.1f} [{card}]")
    if set(lm_calls) != {"optimize_pose_graph", "global_bundle_adjust", "bundle_adjust"}:
        raise AssertionError(f"14c: phase 6 recorded {sorted(lm_calls)}")
    out["14c"] = lm
    # ---- 14d: a whole System with and without the capture ------------------ #
    sync_cfg = cfg.replace(pipelined_tracking=False, async_mapping=False)
    with eager_sites():
        eager_run = run_system(sync_cfg, frames_u8, weights, device)
    ta, tb = captured_run["system"].frame_trajectory(), eager_run["system"].frame_trajectory()
    if len(ta) != len(tb) or any(fa != fb or pa.tobytes() != pb.tobytes()
                                 for (fa, pa), (fb, pb) in zip(ta, tb)):
        raise AssertionError("14d: the captured System's trajectory differs from the eager one's")
    fps = {name: len(r["ms"]) / (r["ms"].sum() / 1e3)
           for name, r in (("captured", captured_run), ("eager", eager_run))}
    out["14d"] = dict(frames=N_SYSTEM, fps=fps)
    log(f"14d the synchronous System over {N_SYSTEM} frames, captured and with every site eager: "
        f"frame trajectories bitwise equal; frames/s captured {fps['captured']:.2f}, eager "
        f"{fps['eager']:.2f} [{card}]")
    torch.cuda.synchronize()
    return out


# --------------------------------------------------------------------------- #
# Phase 15: the reference's remaining jit sites, captured
# --------------------------------------------------------------------------- #
# name: (module, attribute of its graphs.captured callable, the JAX jit)
JIT_SITES = {
    "loop_search_global": ("asdslam_torch.loop.loop_closing", "_search_global",
                           "asdslam_tpu/ops/match.py:263"),
    "loop_sim3": ("asdslam_torch.loop.loop_closing", "_sim3",
                  "asdslam_tpu/estimators/sim3_horn.py:64, :139"),
    "loop_guided": ("asdslam_torch.loop.loop_closing", "_guided_counts",
                    "asdslam_tpu/frontend/visibility.py:19, asdslam_tpu/ops/match.py:199"),
    "loop_project_search": ("asdslam_torch.loop.loop_closing", "_project_search",
                            "asdslam_tpu/frontend/visibility.py:19, "
                            "asdslam_tpu/ops/match.py:199"),
    "triangulate_neighbors": ("asdslam_torch.backend.local_mapping", "_triangulate",
                              "asdslam_tpu/backend/mapping_kernels.py:26"),
    "fuse_pairs": ("asdslam_torch.backend.local_mapping", "_fuse",
                   "asdslam_tpu/backend/mapping_kernels.py:80"),
    "search_window": ("asdslam_torch.frontend.tracking", "_search_window",
                      "asdslam_tpu/ops/match.py:174"),
    "initialize_two_view": ("asdslam_torch.frontend.tracking", "_two_view",
                            "asdslam_tpu/estimators/twoview.py:270"),
    "track_search_global": ("asdslam_torch.frontend.tracking", "_search_global",
                            "asdslam_tpu/ops/match.py:263"),
    "ransac_pnp": ("asdslam_torch.frontend.tracking", "_ransac_pnp",
                   "asdslam_tpu/estimators/pnp.py:60"),
    "pose_only_optimize": ("asdslam_torch.frontend.tracking", "_pose_only",
                           "asdslam_tpu/backend/ba.py:101"),
    "motion_search": ("asdslam_torch.frontend.tracking", "_motion_search",
                      "asdslam_tpu/ops/match.py:199"),
    "project_search": ("asdslam_torch.frontend.tracking", "_project_search",
                       "asdslam_tpu/frontend/visibility.py:19, asdslam_tpu/ops/match.py:199"),
    "bow_descend": ("asdslam_torch.loop.vocab", "_descend", "asdslam_tpu/loop/vocab.py:85"),
}
LOOP_FUNNEL = ("loop_search_global", "loop_sim3", "loop_guided", "loop_project_search")


def site_owners(names):
    """(module, attribute) of each JIT_SITES or LAST_SITES name."""
    import importlib

    sites = {**JIT_SITES, **LAST_SITES}
    return [(importlib.import_module(sites[n][0]), sites[n][1]) for n in names]


def jit_site(name):
    """The captured callable of a JIT_SITES name."""
    (module, attr), = site_owners([name])
    site = getattr(module, attr)
    return getattr(site, "captured", site)  # under SiteLog: the wrapped site


def to_device(x, device):
    """``x`` (tensors in tuples, named tuples, lists and dicts) with its
    tensors on ``device``."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_device(v, device) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(to_device(v, device) for v in x)
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    return x


def clone_tree(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(clone_tree(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(clone_tree(v) for v in x)
    if isinstance(x, dict):
        return {k: clone_tree(v) for k, v in x.items()}
    return x


def check_site(name, site, args, kwargs, phase="15a"):
    """One capture site on its inputs: ``.eager``, then the site three times
    (on a new key: the warm-up, the capture with its first replay, a
    replay), each bit for bit the eager result.  Returns the host ms of the
    eager call and of each call with what it did."""
    from asdslam_torch.utils import graphs

    want, eager_ms = timed_call(lambda: site.eager(*args, **kwargs))
    calls = []
    for i in range(3):
        got, ms = timed_call(lambda: site(*args, **kwargs))
        kind = graphs.last_call()
        if not tree_same_bits(got, want):
            bad = [n for n, (x, y) in enumerate(zip(tree_leaves(got), tree_leaves(want)))
                   if not same_bits(x, y)]
            raise AssertionError(f"{phase}: {name}'s call {i + 1} ({kind}) differs from .eager in "
                                 f"output leaves {bad}")
        calls.append((kind, ms))
    return dict(eager_ms=eager_ms, calls=calls)


class SiteLog:
    """``with SiteLog() as log:`` wraps every JIT_SITES and LAST_SITES
    callable: each call's
    host ms (the calling thread's stream synchronised before and after, so
    they hold the card's work too), what it did (``graphs.last_call()``),
    its start and end on the host clock, its thread and the label
    ``log.phase``, and the call's key but for the stream; the ms only for
    the sites named in ``log.timed`` (the others are not synchronised: a
    synchronisation in the tracker's thread would stall its pipeline); while
    ``log.keep`` the arguments of each site's first call (cloned at the
    call).  LoopCloser's Sim3 stage a candidate
    (``_compute_sim3_and_correct``, with kf, cand and the verdict), its
    essential graph and its global BA are timed the same way."""

    LOOP_METHODS = ("_compute_sim3_and_correct", "_optimize_essential_graph", "_global_ba")

    def __init__(self):
        self.calls, self.loop, self.args = [], [], {}
        self.phase, self.keep, self.timed = None, False, ()
        self._lock = threading.Lock()
        self._saved = []

    def _site_wrapper(self, name, site):
        import torch
        from asdslam_torch.utils import graphs

        def wrapper(*a, **kw):
            if self.keep and name not in self.args:
                self.args[name] = (clone_tree(a), clone_tree(kw))
            shape = hash(graphs._flatten((a, kw), []))  # the key but for the stream
            timed = name in self.timed
            if timed:
                stream = torch.cuda.current_stream()
                stream.synchronize()
            t0 = time.perf_counter()
            out = site(*a, **kw)
            if timed:
                stream.synchronize()
            t1 = time.perf_counter()
            with self._lock:
                self.calls.append(dict(site=name, kind=graphs.last_call(), shape=shape,
                                       ms=(t1 - t0) * 1e3 if timed else None, t0=t0, t1=t1,
                                       thread=threading.get_ident(), phase=self.phase))
            return out
        wrapper.eager, wrapper.captured = site.eager, site
        return wrapper

    def _loop_wrapper(self, name, fn):
        def wrapper(closer, *a, **kw):
            t0 = time.perf_counter()
            out = fn(closer, *a, **kw)
            with self._lock:
                self.loop.append(dict(method=name, t0=t0, t1=time.perf_counter(),
                                      thread=threading.get_ident(), phase=self.phase,
                                      args=[int(x) for x in a[:2]] if name == self.LOOP_METHODS[0]
                                      else None, accepted=out if name == self.LOOP_METHODS[0]
                                      else None))
            return out
        return wrapper

    def __enter__(self):
        from asdslam_torch.loop.loop_closing import LoopCloser

        names = [*JIT_SITES, *LAST_SITES]
        for name, (m, a) in zip(names, site_owners(names)):
            site = getattr(m, a)
            self._saved.append((m, a, site))
            setattr(m, a, self._site_wrapper(name, site))
        for name in self.LOOP_METHODS:
            fn = getattr(LoopCloser, name)
            self._saved.append((LoopCloser, name, fn))
            setattr(LoopCloser, name, self._loop_wrapper(name, fn))
        return self

    def __exit__(self, *exc):
        for owner, name, value in self._saved:
            setattr(owner, name, value)
        self._saved = []

    def first_calls(self):
        """Per site: the first call in the process (its phase, what it did,
        ms), the warm-ups, captures and replays (count, ms)."""
        out = {}
        for name in JIT_SITES:
            calls = [c for c in self.calls if c["site"] == name and c["ms"] is not None]
            if not calls:
                continue
            by = {k: [c["ms"] for c in calls if c["kind"] == k]
                  for k in ("warm-up", "capture", "replay")}
            out[name] = dict(first=dict(phase=calls[0]["phase"], kind=calls[0]["kind"],
                                        ms=calls[0]["ms"]),
                             warm_ups=len(by["warm-up"]), warm_up_ms_max=max(by["warm-up"],
                                                                              default=None),
                             captures=len(by["capture"]), capture_ms=by["capture"],
                             replays=len(by["replay"]),
                             replay_ms_median=float(np.median(by["replay"]))
                             if by["replay"] else None,
                             replay_ms_total=float(np.sum(by["replay"])))
        return out

    def first_loop(self, phase):
        """Where the process's first loop spent its time: every Sim3 stage
        (one a candidate) of run ``phase`` up to and including the first
        accepted one, with the site calls made inside each (ms by site and
        what they did), its essential graph and global BA, and the rest
        (the stage's host work and its fetches)."""
        stages = []
        for st in (c for c in self.loop if c["phase"] == phase
                   and c["method"] == self.LOOP_METHODS[0]):
            inside = [c for c in self.calls if c["thread"] == st["thread"] and c["ms"] is not None
                      and st["t0"] <= c["t0"] and c["t1"] <= st["t1"]]
            sites = {}
            for c in inside:
                key = f"{c['site']} ({c['kind']})"
                sites[key] = sites.get(key, 0.0) + c["ms"]
            children = {c["method"]: (c["t1"] - c["t0"]) * 1e3 for c in self.loop
                        if c["thread"] == st["thread"] and c["method"] != self.LOOP_METHODS[0]
                        and st["t0"] <= c["t0"] and c["t1"] <= st["t1"]}
            ms = (st["t1"] - st["t0"]) * 1e3
            stages.append(dict(kf=st["args"][0], cand=st["args"][1], accepted=st["accepted"],
                               ms=ms, sites_ms=sites, children_ms=children,
                               rest_ms=ms - sum(sites.values()) - sum(children.values())))
            if st["accepted"]:
                break
        return stages


def record_motion_search(system, frame_u8, device):
    """The staged motion model's arguments (``Tracker._track_motion_model``,
    which the fused step's failed gates fall back to) on ``frame_u8`` from
    the state ``system``'s tracker ended in: {"motion_search": (args,
    kwargs)}."""
    import torch

    tr = system.tracker
    if tr.velocity is None:
        tr.velocity = np.array([1.0, 0, 0, 0, 0, 0, 0], np.float32)
    feat = tr.extract(torch.as_tensor(frame_u8).to(device).float() / 255.0)
    with SiteLog() as extra:
        extra.keep = True
        tr._track_motion_model(feat)
    return {k: v for k, v in extra.args.items() if k == "motion_search"}


def padded_slot_ms(name, site, args, kwargs):
    """The device time of the keyframe pass's padded slots: the captured
    call's replay (CUDA events) on its recorded padded inputs against the
    same inputs cut to the live slots (a graph of its own)."""
    import torch

    if name == "triangulate_neighbors":
        live = int(args[7].any(dim=1).nonzero().max()) + 1  # nb_free: the padded slots last
        cut = tuple(a[:live] if i in (4, 5, 6) else a for i, a in enumerate(args))
        cut = cut[:7] + (cut[7][:live], cut[8][:live], cut[9][:live]) + cut[10:]
        cut_kwargs = kwargs
        slots = (live, len(args[4]))
    else:
        live = int(args[5].any(dim=1).nonzero().max()) + 1  # mp_valid: the padded pairs last
        cut = args[:7] + tuple(a[:live] for a in args[7:11]) + args[11:]
        cut_kwargs = dict(kwargs, n_live=live)
        slots = (live, args[5].shape[0])
    out = {}
    for form, a, kw in (("padded", args, kwargs), ("live", cut, cut_kwargs)):
        for _ in range(3):  # warm-up, capture, replay
            site(*a, **kw)
        torch.cuda.synchronize()
        out[form] = time_ms(lambda: site(*a, **kw), 10)
    return dict(live_slots=slots[0], slots=slots[1], padded_ms=out["padded"],
                live_ms=out["live"], padded_slots_ms=out["padded"] - out["live"])


def phase15(cfg, weights, device, card, sites, captured_runs):
    """15a-15e (module docstring); ``sites`` is the SiteLog of phases 5-8,
    ``captured_runs`` phase 6's first and last runs.  Returns the numbers
    for the JSON line."""
    import torch
    from asdslam_torch.utils import graphs

    captured_first, captured_again = captured_runs
    out = {}
    frames_u8, _ = render_loop(cfg, device)
    # ---- 15a: every site on its recorded inputs, captured against eager -- #
    if "motion_search" not in sites.args:  # no fused step failed its gates
        sites.args.update(record_motion_search(captured_first["system"], frames_u8[N_LOOP],
                                               device))
    missing = sorted(set(JIT_SITES) - set(sites.args))
    if missing:
        raise AssertionError(f"15a: phases 6-8 never called {missing}")
    process = sites.first_calls()
    checks = {}
    for name, (args, kwargs) in sites.args.items():
        if name not in JIT_SITES:  # LAST_SITES: phase 16's
            continue
        site = jit_site(name)
        checks[name] = check_site(name, site, args, kwargs)
        checks[name]["in_process"] = process.get(name)
    for name, c in checks.items():
        p = c["in_process"]
        log(f"15a {name} ({JIT_SITES[name][2]}): captured bitwise equal to .eager on the "
            f"inputs of its first call in phases 6-8; host ms here eager {c['eager_ms']:.2f}, "
            + ", ".join(f"{k} {ms:.2f}" for k, ms in c["calls"])
            + (f"; in phases 5-8: first call {p['first']['ms']:.1f} ({p['first']['kind']}, "
               f"{p['first']['phase']}), warm-ups {p['warm_ups']} (the longest "
               f"{p['warm_up_ms_max'] or 0:.1f}), captures {p['captures']} "
               f"({', '.join(f'{x:.1f}' for x in p['capture_ms'])}), replays {p['replays']} "
               f"(median {p['replay_ms_median'] or 0:.2f}, total {p['replay_ms_total']:.1f})"
               if p else "") + f" [{card}]")
    # the sites' graphs: keys now, the shapes (keys but for the stream) that
    # phase 6's three runs called (one configuration), calls by what they
    # did in phase 6, pools
    graphs_by_site = {}
    for name in JIT_SITES:
        site = jit_site(name)
        stats = site.stats()
        in6 = [c for c in sites.calls if c["site"] == name and c["phase"].startswith("6")]
        graphs_by_site[name] = dict(
            keys=len(site._entries), shapes_phase6=len({c["shape"] for c in in6}),
            calls_phase6={k: sum(c["kind"] == k for c in in6)
                          for k in ("warm-up", "capture", "replay")},
            pool_bytes=[s["pool_bytes"] for s in stats],
            replays=sum(s["replays"] for s in stats))
    log("15a the sites' graphs (keys, shapes in phase 6, phase 6's warm-ups / captures / "
        "replays, pool bytes a graph): "
        + ", ".join(f"{n} {g['keys']}, {g['shapes_phase6']}, "
                    + " / ".join(str(v) for v in g["calls_phase6"].values())
                    + f", {g['pool_bytes']}" for n, g in graphs_by_site.items()) + f" [{card}]")
    if graphs_by_site["triangulate_neighbors"]["shapes_phase6"] != 1 \
            or not 1 <= graphs_by_site["fuse_pairs"]["shapes_phase6"] <= 4:
        raise AssertionError(f"15a: the keyframe pass's shapes in phase 6: {graphs_by_site}")
    if any(g["keys"] > graphs.MAX_GRAPHS for g in graphs_by_site.values()):
        raise AssertionError(f"15a: a site over {graphs.MAX_GRAPHS} keys: {graphs_by_site}")
    out["15a"] = dict(checks=checks, graphs=graphs_by_site)
    # ---- 15b: where the first loop's Sim3 stage went ------------------------ #
    stages = sites.first_loop("6 first")
    if not stages or not stages[-1]["accepted"]:
        raise AssertionError(f"15b: no accepted loop in phase 6's first run: {stages}")
    total = {}
    for st in stages:
        for k, v in list(st["sites_ms"].items()) + list(st["children_ms"].items()):
            total[k] = total.get(k, 0.0) + v
        total["the rest (host work, fetches)"] = total.get(
            "the rest (host work, fetches)", 0.0) + st["rest_ms"]
    out["15b"] = dict(stages=stages, total_ms=sum(st["ms"] for st in stages), by_part_ms=total)
    log(f"15b phase 6's first run: {len(stages)} Sim3 stages up to its first loop (kf "
        f"{stages[-1]['kf']}, cand {stages[-1]['cand']}), {out['15b']['total_ms']:.1f} ms; by "
        "part (ms): " + ", ".join(f"{k} {v:.1f}" for k, v in sorted(total.items(),
                                                                      key=lambda kv: -kv[1]))
        + f" [{card}]")
    # ---- 15c: the keyframe pass's padded slots ------------------------------ #
    out["15c"] = {}
    for name in ("triangulate_neighbors", "fuse_pairs"):
        args, kwargs = sites.args[name]
        r = out["15c"][name] = padded_slot_ms(name, jit_site(name), args, kwargs)
        log(f"15c {name}: the replay on its {r['slots']} slots {r['padded_ms']:.3f} ms against "
            f"{r['live_ms']:.3f} ms on its {r['live_slots']} live ones: the padded slots "
            f"{r['padded_slots_ms']:.3f} ms of the card a keyframe (CUDA events) [{card}]")
    # ---- 15d: phase 6 with the new sites eager ------------------------------ #
    with eager_sites(list(JIT_SITES)):
        eager_run = run_default(cfg, frames_u8, weights, device)
    a, b = captured_first["system"], eager_run["system"]
    for what, ta, tb in (("frame", a.frame_trajectory(), b.frame_trajectory()),
                         ("keyframe", a.keyframe_trajectory(), b.keyframe_trajectory())):
        if len(ta) != len(tb) or any(fa != fb or pa.tobytes() != pb.tobytes()
                                     for (fa, pa), (fb, pb) in zip(ta, tb)):
            raise AssertionError(f"15d: the {what} trajectory with the sites eager differs from "
                                 "the captured run's")
    if a.loop_closer.accepted_log != b.loop_closer.accepted_log:
        raise AssertionError(f"15d: loops {b.loop_closer.accepted_log} with the sites eager, "
                             f"{a.loop_closer.accepted_log} captured")
    spans = {k: span_stats(eager_run["system"].tracer, k)
             for k in ("join_mapping", "mapping", "loop_closing", "loop_closing/sim3",
                       "sim3/essential_graph", "sim3/gba", "create_kf")}
    ms, is_kf = eager_run["ms"], eager_run["is_kf"]
    out["15d"] = dict(fps_sites_eager=N_LOOP / eager_run["wall_s"],
                      fps_captured_first=N_LOOP / captured_first["wall_s"],
                      fps_captured_again=N_LOOP / captured_again["wall_s"],
                      loops=b.loop_closer.accepted_log,
                      keyframe_call_ms=[round(float(x), 1) for x in ms[is_kf]],
                      captured_again_keyframe_call_ms=[
                          round(float(x), 1)
                          for x in captured_again["ms"][captured_again["is_kf"]]],
                      spans_calls_total_ms=spans)
    log(f"15d phase 6 with the new sites eager: frame and keyframe trajectories and loops "
        f"{b.loop_closer.accepted_log} bitwise the captured first run's; frames/s "
        f"{out['15d']['fps_sites_eager']:.3f} eager against {out['15d']['fps_captured_first']:.3f}"
        f" / {out['15d']['fps_captured_again']:.3f} captured (first / last run); keyframe calls "
        f"{out['15d']['keyframe_call_ms']} ms (captured, last run: "
        f"{out['15d']['captured_again_keyframe_call_ms']}); spans (calls, total ms): "
        + ", ".join(f"{k} {c} / {t:.1f}" for k, (c, t) in spans.items() if c) + f" [{card}]")
    # ---- 15e: the first Sim3 call of a process, part by part --------------- #
    out["15e"] = first_sim3_calls()
    log("15e a fresh process's first and second calls of the Sim3 program's parts (host ms, "
        "synchronised): " + ", ".join(f"{k} {v[0]:.1f} / {v[1]:.1f}"
                                       for k, v in out["15e"].items()) + f" [{card}]")
    torch.cuda.synchronize()
    return out


def first_sim3_calls():
    """``python3 chip_smoke.py --sim3-first-calls`` in a fresh process: the
    host ms (synchronised) of the first and second call of each part of the
    loop funnel's Sim3 program in order, on a synthetic problem of
    n_features matches (seed 0): the Horn fit's Jacobi sweeps over 300
    hypotheses, the whole RANSAC, ``torch.func.jacfwd`` of a small
    function, the Gauss-Newton refine.  Returns {part: (first, second)}."""
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--sim3-first-calls"],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"15e: the child failed: {res.stderr[-2000:]}")
    return {k: tuple(v) for k, v in json.loads(res.stdout.splitlines()[-1]).items()}


def sim3_first_calls_child():
    """The child of ``first_sim3_calls``: prints one JSON line."""
    import torch
    from torch.func import jacfwd
    from asdslam_torch.config import SlamConfig
    from asdslam_torch.estimators import linalg, sim3_horn
    from asdslam_torch.geometry import se3

    dev, cfg = "cuda", SlamConfig()
    n, gen = cfg.n_features, torch.Generator().manual_seed(0)
    P1 = torch.rand(n, 3, generator=gen) * torch.tensor([4.0, 3.0, 6.0]) + torch.tensor(
        [-2.0, -1.5, 4.0])
    R = se3.so3_exp(torch.tensor([[0.02, -0.05, 0.01]]))[0]
    P2 = 1.3 * P1 @ R.T + torch.tensor([0.3, -0.1, 0.2])
    K = torch.tensor([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1.0]])

    def proj(P):
        return torch.stack([K[0, 0] * P[:, 0] / P[:, 2] + K[0, 2],
                            K[1, 1] * P[:, 1] / P[:, 2] + K[1, 2]], 1)
    g = torch.rand(cfg.sim3_ransac_iters, n, generator=gen)
    ones = torch.ones(n)
    args = [x.to(dev) for x in (g, P1, P2, proj(P1), proj(P2), ones > 0, K, 9.21 * ones,
                                9.21 * ones)]
    sym = torch.rand(cfg.sim3_ransac_iters, 4, 4, generator=gen).to(dev)
    sym = sym + sym.transpose(1, 2)
    parts = {
        "jacobi_eigh 300x4x4": lambda: linalg.jacobi_eigh(sym),
        "ransac_sim3": lambda: sim3_horn.ransac_sim3(*args, min_inliers=20),
        "jacfwd of x * x": lambda: jacfwd(lambda x: x * x)(args[1][0]),
        "refine_sim3": lambda: sim3_horn.refine_sim3(
            torch.ones((), device=dev), torch.eye(3, device=dev), torch.zeros(3, device=dev),
            *args[1:5], args[5], args[6], args[7], args[8]),
    }
    out = {}
    for name, fn in parts.items():
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = times
    print(json.dumps(out))
    return 0


# --------------------------------------------------------------------------- #
# Phase 16: the reference's last jit sites
# --------------------------------------------------------------------------- #
# The captured callables of the reference's last eager jit sites, by name:
# (module, attribute, the JAX jit).  SiteLog wraps them beside JIT_SITES.
LAST_SITES = {
    "pm_local_blocks": ("asdslam_torch.parallel.dist", "pm_local_blocks",
                        "asdslam_tpu/parallel/dist.py:231"),
    "pm_update": ("asdslam_torch.parallel.dist", "pm_update", "asdslam_tpu/parallel/dist.py:231"),
    "dp_descriptor": ("asdslam_torch.parallel.dist", "shard_descriptors",
                      "asdslam_tpu/parallel/dist.py:88"),
    "train_step": ("asdslam_torch.models.train", "train_step", "asdslam_tpu/models/train.py:131"),
    "render_frame": ("asdslam_torch.io.synthetic", "_render_frame",
                     "asdslam_tpu/io/synthetic.py:55"),
    "render_boxes": ("asdslam_torch.io.kitti_proxy", "_render_boxes",
                     "asdslam_tpu/io/kitti_proxy.py:170"),
    "raycast_grid": ("asdslam_torch.io.kitti_proxy", "_raycast_grid",
                     "asdslam_tpu/io/kitti_proxy.py:186"),
    "greedy_assignment": ("asdslam_torch.ops.assignment", "greedy_assignment",
                          "asdslam_tpu/ops/assignment.py:46"),
    "sim3_align": ("asdslam_torch.estimators.sim3_horn", "optimize_sim3_align",
                   "asdslam_tpu/estimators/sim3_horn.py:202"),
}
MESH_HALVES = ("pm_local_blocks", "pm_update")
N_TRAIN_CHECK = 5          # 16a's train steps, eager and captured from one snapshot
# tests/test_torch_train.py's bars: one step on the card against the CPU
# (its gpu test), and five chained steps against the JAX package
TRAIN_LOSS_BAR, TRAIN_CONV_BAR = 1e-4, 1e-3
CHAIN_LOSS_BAR, CHAIN_CONV_BAR = 0.05, 0.1
N_TRAIN_RATE = 60          # 16b's timed steps of each form
KITTI_CHECK_FRAMES = (0, 10, 20, 30, 39)      # of N_KITTI frames of KITTI_PATHS["right"]


@contextlib.contextmanager
def first_site_args(names):
    """Keep the arguments (cloned at the call) of the first call of each
    named site (JIT_SITES or LAST_SITES) made inside the block."""
    kept, saved = {}, []
    for name, (m, a) in zip(names, site_owners(names)):
        site = getattr(m, a)
        saved.append((m, a, site))

        def wrapper(*args, _name=name, _site=site, **kw):
            if _name not in kept:
                kept[_name] = (clone_tree(args), clone_tree(kw))
            return _site(*args, **kw)
        wrapper.eager = site.eager
        setattr(m, a, wrapper)
    try:
        yield kept
    finally:
        for m, a, site in saved:
            setattr(m, a, site)


def fresh_site(name):
    """A new captured callable of the named site's function: no key of its
    own yet, so its first calls warm up, capture and replay."""
    from asdslam_torch.utils import graphs

    site = jit_site(name)
    return graphs.captured(site.eager, site.name, site.grad)


def check_fresh(name, args, kwargs, reps=5):
    """check_site on a fresh callable of ``name`` (warm-up, capture, replay,
    each bit for bit ``.eager``), then the replay and the eager call by
    CUDA events over ``reps`` calls, and the graph's pool bytes."""
    site = fresh_site(name)
    out = check_site(name, site, args, kwargs, phase="16a")
    out.update(eager_event_ms=time_ms(lambda: site.eager(*args, **kwargs), reps),
               replay_event_ms=time_ms(lambda: site(*args, **kwargs), reps),
               pool_bytes=[s["pool_bytes"] for s in site.stats()])
    return out


def check_frames(name, frames_args):
    """A fresh callable of ``name`` over real frames' arguments in order
    (the first call warms up, the second captures, the rest replay), each
    bit for bit ``.eager``.  Returns host ms a frame of both and the pool
    bytes."""
    from asdslam_torch.utils import graphs

    site = fresh_site(name)
    eager_ms, calls = [], []
    for i, args in enumerate(frames_args):
        want, ms = timed_call(lambda: site.eager(*args))
        eager_ms.append(ms)
        got, ms = timed_call(lambda: site(*args))
        calls.append((graphs.last_call(), ms))
        if not tree_same_bits(got, want):
            raise AssertionError(f"16a: {name} frame {i} ({calls[-1][0]}) differs from .eager")
    replay = [ms for kind, ms in calls if kind == "replay"]
    return dict(frames=len(frames_args), calls=calls, eager_ms=float(np.mean(eager_ms)),
                replay_ms=float(np.mean(replay)) if replay else None,
                pool_bytes=[s["pool_bytes"] for s in site.stats()])


def mesh_step_checks(device, card):
    """16a's mesh step: each half on the arguments of 11a's step at every
    shard count (a fresh callable: warm-up, capture, replay); three steps
    eager and captured at every shard count, each bitwise equal to the
    others."""
    from asdslam_torch.parallel import dist

    problem = make_problem_np()
    halves, runs = {}, {}
    for n in MD_SHARDS:
        with first_site_args(MESH_HALVES) as kept:
            md_steps(dist.make_mesh(n, device), problem)
        for name in MESH_HALVES:
            halves[f"{name} {n} shards"] = check_fresh(name, *kept[name])
        with eager_sites(list(MESH_HALVES)):
            eager = md_steps(dist.make_mesh(n, device), problem, steps=3)
        runs[n] = md_steps(dist.make_mesh(n, device), problem, steps=3)
        if not all(np.array_equal(a, b) for a, b in zip(eager, runs[n])):
            raise AssertionError(f"16a: three captured mesh steps on {n} shards differ from "
                                 "the eager steps")
    for n in MD_SHARDS[1:]:
        if not all(np.array_equal(a, b) for a, b in zip(runs[n], runs[1])):
            raise AssertionError(f"16a: three captured mesh steps on {n} shards differ from 1 "
                                 "shard's")
    for key, c in halves.items():
        log(f"16a {key}: captured bitwise equal to .eager (" + ", ".join(
            f"{k} {ms:.2f}" for k, ms in c["calls"]) + f" host ms; eager {c['eager_ms']:.2f}); "
            f"CUDA events eager {c['eager_event_ms']:.3f} ms, replay {c['replay_event_ms']:.3f}"
            f" ms; pool {c['pool_bytes']} B [{card}]")
    log(f"16a three mesh steps, captured and eager, on {MD_SHARDS} shards: all bitwise equal "
        f"[{card}]")
    return halves


def mesh_gba_checks(loop_system, device, card):
    """16a/16b's mesh GBA: phase 6's loop-closed map through
    LoopCloser._global_ba at each of GBA_MESHES with the halves eager, then
    captured twice (the first call warms and captures, the second
    replays): every result bitwise the others; host ms of each beside the
    one-device captured GBA's two calls."""
    import copy
    import torch
    from asdslam_torch.loop.loop_closing import LoopCloser

    lc0, before = loop_system.loop_closer, loop_system.store
    n_kf, n_mp = before.n_kf, before.n_mp
    results, ms = {}, {}

    def run(k):
        lc = LoopCloser(lc0.cfg.replace(n_devices=k), lc0.K, copy.deepcopy(before),
                        device=device)
        _, t = timed_call(lc._global_ba)
        return (lc.store.kf_pose[:n_kf].copy(), lc.store.mp_pos[:n_mp].copy()), t

    for k in GBA_MESHES:
        with eager_sites(list(MESH_HALVES)):
            results[(k, "eager")], ms[(k, "eager")] = run(k)
        for form in ("captured first", "captured again"):
            results[(k, form)], ms[(k, form)] = run(k)
    for form in ("captured first", "captured again"):
        _, ms[(1, form)] = run(1)
    want = results[(GBA_MESHES[0], "eager")]
    for key, got in results.items():
        if not all(np.array_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"16a: the mesh GBA {key} differs from n_devices "
                                 f"{GBA_MESHES[0]} eager")
    if not np.isfinite(want[0]).all() or np.array_equal(want[0], before.kf_pose[:n_kf]):
        raise AssertionError("16a: the mesh GBA left non-finite or unmoved poses")
    out = {f"n_devices {k} {form}": v for (k, form), v in ms.items()}
    log(f"16a phase 6's map ({n_kf} keyframes) through _global_ba_mesh at n_devices "
        f"{GBA_MESHES}, eager and captured: all bitwise equal [{card}]")
    log("16b mesh GBA host ms a call: " + ", ".join(f"{k} {v:.1f}" for k, v in out.items())
        + " (n_devices 1: the one-device captured global_bundle_adjust) " + f"[{card}]")
    return out


def dp_descriptor_checks(cfg, weights, device, card):
    """16a's data-parallel descriptor on 11d's patches (one frame's 2000
    from the trained extractor): the shard program on its first shard's
    arguments (a fresh callable), and dp_descriptor_fn's output captured
    (three calls) bitwise equal to the eager one."""
    import torch
    from asdslam_torch.frontend.extractor import make_extractor
    from asdslam_torch.models.asdnet import ASDNet
    from asdslam_torch.parallel import dist

    net = ASDNet().to(device)
    net.load_state_dict(weights)
    frames_u8 = build_tracking(cfg, device)[2]
    seen = []
    with torch.no_grad():
        make_extractor(cfg, lambda p: seen.append(p) or net(p))(
            frames_u8[1].to(device).to(torch.float32) / 255.0)
    dp = dist.dp_descriptor_fn(weights, dist.make_mesh(DP_PATCH_SHARDS, device))
    with eager_sites(["dp_descriptor"]):
        want = dp(seen[0])
    for i in range(3):
        with first_site_args(["dp_descriptor"]) as kept:
            got = dp(seen[0])
        if not same_bits(got, want):
            raise AssertionError(f"16a: dp_descriptor_fn's call {i + 1} differs from eager")
    out = check_fresh("dp_descriptor", *kept["dp_descriptor"])
    log(f"16a dp_descriptor ({DP_PATCH_SHARDS} shards of {seen[0].shape[0]} patches): the shard "
        "program and dp_descriptor_fn captured bitwise equal to eager; CUDA events a shard "
        f"eager {out['eager_event_ms']:.3f} ms, replay {out['replay_event_ms']:.3f} ms; pool "
        f"{out['pool_bytes']} B [{card}]")
    return out


def train_checks(cache, device, card):
    """16a/16b's train step on 9a's pair cache at TRAIN_BATCH: from one
    snapshot of train_asdnet_torch.py's seeded model, N_TRAIN_CHECK steps
    eager (``.eager``) and the same steps through a fresh captured step
    (warm-up, capture, replays), with cuDNN deterministic (parameters,
    running statistics and losses bit for bit) and with its defaults, whose
    weight gradients are not bitwise run to run (the first step within
    tests/test_torch_train.py's gpu bars, the chain within its five-step
    bars; two eager runs' gap beside it); then N_TRAIN_RATE steps of each
    form timed (host clock, synchronised at the ends)."""
    import torch
    from asdslam_torch.models import asdnet
    from asdslam_torch.models import train as T

    z = np.load(cache)
    pool_a, pool_p = (torch.as_tensor(z[k]).to(device) for k in ("pool_a", "pool_p"))
    rng = np.random.default_rng(0)
    gen = torch.Generator(device).manual_seed(1)
    steps = [(torch.as_tensor(rng.integers(0, len(pool_a), TRAIN_BATCH)).to(device),
              T.draw_step(gen, TRAIN_BATCH)) for _ in range(N_TRAIN_CHECK)]
    lrs = T.lr_table(N_STEPS, 0.5, device)
    model = asdnet.ASDNetTrain(asdnet.init_params(
        asdnet.draw_init_seeds(torch.Generator().manual_seed(0)))).to(device)
    snap = {k: v.clone() for k, v in model.state_dict().items()}

    def restore():
        with torch.no_grad():
            for k, v in model.state_dict().items():
                v.copy_(snap[k])

    def state():
        return {k: v.clone() for k, v in model.state_dict().items()}

    def run(step_fn):
        """(losses, the state after the first step, the state after the last)"""
        restore()
        losses, first = [], None
        for i, (sel, draws) in enumerate(steps):
            losses.append(step_fn(model, pool_a[sel], pool_p[sel], lrs[i], draws))
            first = first or state()
        return torch.stack(losses), first, state()

    def gaps(a, b):
        """(max |d loss| over the steps, |d conv| after the first step and
        after the last, |d running statistics| after the last)"""
        def most(x, y, prefix):
            return max(float((x[k] - y[k]).abs().max()) for k in x if k.startswith(prefix))
        return (float((a[0] - b[0]).abs().max()), most(a[1], b[1], "conv"),
                most(a[2], b[2], "conv"), most(a[2], b[2], "bn_"))

    flags = torch.backends.cudnn
    saved = flags.deterministic, flags.benchmark
    out = {}
    try:
        for setting in ("deterministic", "default"):
            flags.deterministic, flags.benchmark = setting == "deterministic", False
            eager = run(T.train_step.eager)
            again = run(T.train_step.eager) if setting == "default" else eager
            site = fresh_site("train_step")
            captured = run(site)
            if any(c.grad is not None for c in model.conv):
                raise AssertionError("16a: a captured train step left a .grad on the convs")
            loss_d, first_d, conv_d, stat_d = gaps(eager, captured)
            if setting == "deterministic":
                if not tree_same_bits((eager[0], *eager[2].values()),
                                      (captured[0], *captured[2].values())):
                    raise AssertionError(f"16a: {N_TRAIN_CHECK} captured train steps with cuDNN "
                                         f"deterministic differ from eager: loss {loss_d:.3g}, "
                                         f"convs {conv_d:.3g}, running stats {stat_d:.3g}")
            elif not (float((eager[0][0] - captured[0][0]).abs()) <= TRAIN_LOSS_BAR
                      and first_d <= TRAIN_CONV_BAR and loss_d <= CHAIN_LOSS_BAR
                      and conv_d <= CHAIN_CONV_BAR):
                raise AssertionError(f"16a: captured train steps with cuDNN's defaults: loss "
                                     f"{loss_d:.3g}, convs {first_d:.3g} after the first step "
                                     f"(bars {TRAIN_LOSS_BAR} / {TRAIN_CONV_BAR}), {conv_d:.3g}"
                                     f" after {N_TRAIN_CHECK} (bars {CHAIN_LOSS_BAR} / "
                                     f"{CHAIN_CONV_BAR})")
            out[setting] = dict(loss_diff=loss_d, conv_diff_first=first_d, conv_diff=conv_d,
                                stats_diff=stat_d, eager_again=gaps(eager, again),
                                pool_bytes=[s["pool_bytes"] for s in site.stats()])
            log(f"16a train_step, {N_TRAIN_CHECK} steps at batch {TRAIN_BATCH} on 9a's cache, "
                f"cuDNN {setting}: captured (warm-up, capture, replays) against eager: losses "
                f"{loss_d:.3g}, convs {first_d:.3g} after the first step and {conv_d:.3g} after "
                f"the last, running statistics {stat_d:.3g} apart"
                + (" (bitwise)" if setting == "deterministic" else
                   f" (bars: the first step {TRAIN_LOSS_BAR} / {TRAIN_CONV_BAR}, the chain "
                   f"{CHAIN_LOSS_BAR} / {CHAIN_CONV_BAR}); two eager runs (loss, convs first / "
                   f"last, stats) " + " / ".join(f"{x:.3g}" for x in out[setting]["eager_again"]))
                + f"; no .grad left; pool {out[setting]['pool_bytes']} B [{card}]")
        flags.deterministic, flags.benchmark = saved
        rates = {}
        for form, fn in (("captured", site), ("eager", T.train_step.eager),
                         ("eager again", T.train_step.eager), ("captured again", site)):
            sel, draws = steps[0]
            a, p = pool_a[sel], pool_p[sel]
            fn(model, a, p, lrs[0], draws)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(N_TRAIN_RATE):
                fn(model, a, p, lrs[i], draws)
            torch.cuda.synchronize()
            rates[form] = N_TRAIN_RATE / (time.perf_counter() - t0)
        out["steps_per_s"] = rates
        log(f"16b train_step steps/s at batch {TRAIN_BATCH} over {N_TRAIN_RATE} steps (host "
            "clock, synchronised at the ends, cuDNN's defaults): "
            + ", ".join(f"{k} {v:.2f}" for k, v in rates.items()) + f" [{card}]")
    finally:
        flags.deterministic, flags.benchmark = saved
    return out


def render_checks(cfg, device, card):
    """16a/16b's renderers on real frames: five KITTI-proxy frames
    (render_boxes at 1241x376, KITTI 03's intrinsics, 256 boxes, on
    KITTI_PATHS["right"]'s ground truth) and the five EUROC_GAP_FRAMES of
    the EuRoC proxy (raycast_grid through its lens grid, 96 boxes), each
    with and without depth, and the corridor (render_frame) at cfg's shape
    and through EuRoC's lens at 752x480: a fresh callable each (warm-up,
    capture, replays), every frame bit for bit ``.eager``; host ms a frame
    of both."""
    import tempfile
    import torch
    from asdslam_torch.io import euroc_proxy, kitti_proxy as kp, synthetic

    dev = torch.device(device)
    out = {}
    with tempfile.TemporaryDirectory() as root:
        write_kitti_ground_truth(root)
        saved = kp.GT_DIR, kp.CAM_DIR
        kp.GT_DIR = kp.CAM_DIR = root
        try:
            seq = kp.KittiProxySequence("03", max_frames=N_KITTI, device=device)
        finally:
            kp.GT_DIR, kp.CAM_DIR = saved
    eu = euroc_proxy.EurocProxySequence(device=device)
    for depth in (False, True):
        kitti = []
        for i in KITTI_CHECK_FRAMES:
            w = kp.select_boxes(seq.world, seq.centers[i], seq.n_boxes)
            kitti.append((kp._on(seq.gt_pose7[i], dev), seq.K, *kp._boxes_on(
                w.bmin, w.bmax, w.salt, dev), seq.height, seq.width, 0.35, depth))
        out[f"render_boxes depth={depth}"] = check_frames("render_boxes", kitti)
        euroc = []
        for i in EUROC_GAP_FRAMES:
            w = kp.select_boxes(eu.world, eu.centers[i], eu.n_boxes)
            euroc.append((kp._on(eu.gt_pose7[i], dev), eu._xn, eu._yn, *kp._boxes_on(
                w.bmin, w.bmax, w.salt, dev), 0.22, depth))
        out[f"raycast_grid depth={depth}"] = check_frames("raycast_grid", euroc)
    K = torch.tensor([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1.0]], device=dev)
    poses = synthetic.make_trajectory(5, STEP_M, TURN, device=device)
    dist = tuple(float(x) for x in EUROC_CAM.split(",")[4:])
    fx, fy, cx, cy = (float(x) for x in EUROC_CAM.split(",")[:4])
    lK = torch.tensor([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]], device=dev)
    lens = synthetic.camera_mod.Camera.create(1.0, 1.0, 0.0, 0.0, *dist, device=dev)
    out["render_frame pinhole"] = check_frames(
        "render_frame", [(poses[i], K, cfg.image_height, cfg.image_width, synthetic.Scene(),
                          None) for i in range(5)])
    out["render_frame EuRoC lens"] = check_frames(
        "render_frame", [(poses[i], lK, EUROC_H, EUROC_W, synthetic.Scene(), lens)
                         for i in range(5)])
    for key, r in out.items():
        log(f"16a {key}: {r['frames']} frames captured bitwise equal to .eager ("
            + ", ".join(kind for kind, _ in r["calls"]) + f"); 16b host ms a frame eager "
            f"{r['eager_ms']:.2f}, replay {r['replay_ms']:.2f}; pool {r['pool_bytes']} B "
            f"[{card}]")
    return out


def assignment_check(device, card):
    """16a/16b's greedy engine on 10c's masked 500x400 matrix."""
    import torch

    g = np.random.default_rng(10)
    n, m = ASSIGN_SHAPE
    score = torch.tensor((g.integers(0, 50, (n, m)) / 50).astype(np.float32)).to(device)
    valid = torch.tensor(g.uniform(size=(n, m)) < 0.3).to(device)
    out = check_fresh("greedy_assignment", (score, valid, 0.1), {}, reps=3)
    log(f"16a greedy_assignment {n}x{m}: captured bitwise equal to .eager (" + ", ".join(
        f"{k} {ms:.2f}" for k, ms in out["calls"]) + " host ms); 16b ms a call by CUDA events "
        f"eager {out['eager_event_ms']:.3f}, replay {out['replay_event_ms']:.3f}; pool "
        f"{out['pool_bytes']} B [{card}]")
    return out


def sim3_align_problem(n=200, seed=3):
    """tests/test_torch_loop.py's 3D-3D alignment problem (numpy): 200
    points under s = 1.4 and a rotation, 40 of them outliers."""
    import torch
    from asdslam_torch.geometry import se3

    g = np.random.default_rng(seed)
    X = g.uniform(-5, 5, (n, 3)).astype(np.float32)
    R = se3.so3_exp(torch.tensor([[0.1, -0.2, 0.3]]))[0].numpy()
    Y = (1.4 * X @ R.T + [2.0, -1.0, 0.5] + 0.01 * g.normal(size=(n, 3))).astype(np.float32)
    Y[:40] += (5.0 * g.normal(size=(40, 3))).astype(np.float32)
    return X, Y


def sim3_align_check(device, card):
    """16a/16b's 3D-3D Sim3 alignment (no caller on the system's paths, in
    either package) on its test problem."""
    import torch

    X, Y = sim3_align_problem()
    args = (torch.tensor(X).to(device), torch.tensor(Y).to(device),
            torch.ones(len(X), dtype=torch.bool, device=device))
    out = check_fresh("sim3_align", args, {}, reps=3)
    log(f"16a optimize_sim3_align ({len(X)} points): captured bitwise equal to .eager ("
        + ", ".join(f"{k} {ms:.2f}" for k, ms in out["calls"]) + " host ms); 16b ms a call by "
        f"CUDA events eager {out['eager_event_ms']:.3f}, replay {out['replay_event_ms']:.3f}; "
        f"pool {out['pool_bytes']} B [{card}]")
    return out


def phase16(cfg, weights, device, card, loop_system, sites=None):
    """16a-16c (module docstring); ``loop_system`` is phase 6's first
    default-configuration System (after its loop), ``sites`` the SiteLog
    of phases 5-8 (None: not recorded).  Returns the numbers for the JSON
    line."""
    import tempfile
    import torch
    import train_asdnet_torch
    from asdslam_torch.models import train as T

    out = {}
    if sites is not None:
        out["in_phases_5_8"] = {
            name: {k: sum(c["site"] == name and c["kind"] == k for c in sites.calls)
                   for k in ("warm-up", "capture", "replay")} for name in LAST_SITES}
        log("16 the new sites' calls in phases 5-8 (warm-ups / captures / replays): "
            + ", ".join(f"{n} " + " / ".join(str(v) for v in c.values())
                        for n, c in out["in_phases_5_8"].items()) + f" [{card}]")
    out["mesh_halves"] = mesh_step_checks(device, card)
    out["mesh_gba_ms"] = mesh_gba_checks(loop_system, device, card)
    out["dp_descriptor"] = dp_descriptor_checks(cfg, weights, device, card)
    out["renderers"] = render_checks(cfg, device, card)
    out["greedy_assignment"] = assignment_check(device, card)
    out["sim3_align"] = sim3_align_check(device, card)
    with tempfile.TemporaryDirectory() as tmp:
        cache = os.path.join(tmp, "pairs.npz")
        T.write_pair_cache(cache, N_POOL, N_HELD_OUT)
        out["train_step"] = train_checks(cache, device, card)
        # ---- 16c: 9a's training, captured and eager ------------------------ #
        out["16c"] = {}
        for form in ("captured", "eager"):
            with (eager_sites(["train_step"]) if form == "eager" else contextlib.nullcontext()):
                res, _, _, sec = run_entry(train_asdnet_torch.main, [
                    "--device", device, "--pairs_cache", cache, "--steps", str(N_STEPS),
                    "--batch", str(TRAIN_BATCH), "--eval_pairs", str(N_HELD_OUT), "--out",
                    os.path.join(tmp, f"{form}.pkl")])
            trained = res["fpr95_asd_trained"]
            if not (np.isfinite(res["final_loss"])
                    and abs(trained - REF_TRAIN["fpr95_asd_trained"]) <= TRAIN_FPR_BAND
                    and trained < min(res["fpr95_asd_random"], res["fpr95_patch_classical"])):
                raise AssertionError(f"16c: 9a's training {form}: {res} (band {TRAIN_FPR_BAND} "
                                     f"of {REF_TRAIN['fpr95_asd_trained']})")
            out["16c"][form] = dict(result=res, seconds=sec)
            log(f"16c 9a's training (train_asdnet_torch.py, {N_STEPS} steps at batch "
                f"{TRAIN_BATCH}) with the {form} step: FPR@95 trained {trained} (JAX package "
                f"{REF_TRAIN['fpr95_asd_trained']}, band {TRAIN_FPR_BAND}), random "
                f"{res['fpr95_asd_random']}, classical {res['fpr95_patch_classical']}; "
                f"{res['steps_per_s']} steps/s, final loss {res['final_loss']:.4f}, {sec:.1f} s "
                f"[{card}]")
    torch.cuda.synchronize()
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from asdslam_torch import kernels
    from asdslam_torch.config import SlamConfig
    from asdslam_torch.frontend import track_step as ts
    from asdslam_torch.ops import masked_nn as k1

    device = "cuda"
    t_main = time.perf_counter()

    def stamp(phase):
        # the Systems a phase dropped hold CUDA graphs (each tracker's step
        # graph has a pool of ~1.8 GB): collect them and free their pools
        gc.collect()
        torch.cuda.empty_cache()
        log(f"-- {phase} done at {time.perf_counter() - t_main:.0f} s, "
            f"{torch.cuda.memory_reserved() / 2**30:.1f} GiB reserved")

    # ---- 1. build ---------------------------------------------------------- #
    t0 = time.perf_counter()
    build_logs = kernels.build()
    log(f"built {sorted(build_logs) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  {name}: {line.strip()}")
    card = card_line()
    log(f"card: {card}")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()

    # ---- 2. K1 against its plain version ----------------------------------- #
    errs, k1_cases = [], {}
    problems = [(case, nn_problem(n, m, ties=ties, seed=n + m))
                for case, n, m, ties in (("motion 2000x2000", 2000, 2000, False),
                                         ("local-map 8192x2000", 8192, 2000, False),
                                         ("ties 300x257", 300, 257, True))]
    problems += [(case, edge_problem(case)) for case in EDGE_CASES]
    for case, prob in problems:
        args = k1_args(prob)
        err, pairs_in, share = check_k1(case, args)
        errs.append(err)
        k1_cases[case] = (args, pairs_in, share)

    stamp("phases 1-2")
    # ---- 3. the main path at full width ------------------------------------ #
    # KITTI defaults: 1241x376, 2000 features, 8 levels, 8192 candidates
    cfg = SlamConfig()
    K, extract, frames_u8, poses, cand, state = build_tracking(cfg, device)
    step = ts.make_track_step(cfg, K, extract, device=device)
    torch.cuda.synchronize()
    k1.masked_nn.launches = 0
    results = run_chain(step, frames_u8, state, cand, 1, N_CHAINED)
    torch.cuda.synchronize()
    launches = k1.masked_nn.launches
    if launches != 3 * N_CHAINED:  # both motion radii and the local map, every frame
        raise AssertionError(f"masked_nn launched {launches} times in {N_CHAINED} frames")
    for i, res in enumerate(results):
        fields = [("pose", res.pose), ("velocity", res.velocity)]
        fields += [(f"next_geom.{k}", v) for k, v in res.next_geom._asdict().items()]
        for name, x in fields:
            if x.is_floating_point() and not torch.isfinite(x).all():
                raise AssertionError(f"frame {i + 1}: non-finite {name}")
    n_in = [int(r.n_inliers) for r in results]
    pose_err = [float((r.pose - poses[i + 1]).abs().max()) for i, r in enumerate(results)]
    log(f"main path: {N_CHAINED} chained frames, masked_nn launches {launches}, "
        f"n_inliers {n_in}")
    log(f"  max |pose - ground truth| per frame: {[round(e, 4) for e in pose_err]}")
    if min(n_in) < cfg.min_localmap_matches:
        raise AssertionError(f"tracking lost: n_inliers {n_in}")

    # one frame through the plain matcher, from the same state
    plain_step = ts.make_track_step(cfg.replace(use_pallas_match=False), K, extract,
                                    device=device)
    (res_k,) = run_chain(step, frames_u8, state, cand, 1, 1)
    (res_p,) = run_chain(plain_step, frames_u8, state, cand, 1, 1)
    src_eq = float((res_k.src == res_p.src).float().mean())
    dpose = float((res_k.pose - res_p.pose).abs().max())
    log(f"kernel vs plain matcher, one frame: src equal on {src_eq:.4f}, max|d pose| {dpose:.3g}")
    if src_eq < 0.99 or dpose > 1e-3:
        raise AssertionError("the step disagrees with its plain-matcher version")
    # the two searches of that frame, on their real inputs
    for case, args in zip(("frame 1 motion search", "frame 1 local-map search"),
                          record_searches(step, frames_u8, state, cand)):
        err, pairs_in, share = check_k1(case, args)
        errs.append(err)
        k1_cases[case] = (args, pairs_in, share)

    # ---- 4. timings ---------------------------------------------------------- #
    run_chain(step, frames_u8, state, cand, 1, 2)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_timed = N_CHAINED
    res = run_chain(step, frames_u8, state, cand, 1, n_timed)[-1]
    int(res.n_inliers)
    torch.cuda.synchronize()
    fps = n_timed / (time.perf_counter() - t0)

    log(f"fused step: {fps:.2f} frames/s over {n_timed} chained frames "
        f"(host clock, synchronised at the end) [{card}]")
    lat = frame_latencies(step, frames_u8, state, cand, passes=2)
    log(f"per-frame latency over {len(lat)} frames (synchronised each frame): "
        f"median {np.median(lat):.2f} ms, p85 {np.percentile(lat, 85):.2f} ms [{card}]")
    layers = layer_times(cfg, K, extract, frames_u8, state, cand, device)
    log("per layer, one call each (CUDA events, ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in layers.items()) + f" [{card}]")

    stamp("phases 3-4")
    # ---- 5. the whole system through its entry point ----------------------- #
    from asdslam_torch.models.asdnet import load_weights
    weights = load_weights(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                        "asdnet_weights.pkl"))
    sync_cfg = cfg.replace(pipelined_tracking=False, async_mapping=False)
    sites = SiteLog().__enter__()  # phase 15's record of the capture sites, phases 5-8
    sites.phase, sites.timed = "5", set(JIT_SITES)
    first = run_system(sync_cfg, frames_u8, weights, device, record_fuse=True)
    second = run_system(sync_cfg, frames_u8, weights, device)
    sites.timed = ()
    ate = check_system(first, second, poses.cpu().numpy(), sync_cfg)
    launches_system = first["launches"]
    if not first["fuse_calls"]:
        raise AssertionError("no masked_nn call was recorded from the fuse")
    fuse_args = max(first["fuse_calls"], key=lambda a: int(a[2].sum()))  # most live rows
    err, pairs_in, share = check_k1("keyframe fuse", fuse_args)
    errs.append(err)
    k1_cases["keyframe fuse"] = (fuse_args, pairs_in, share)
    # timings from the second run (the first also builds, warms and records)
    tr = second["system"].tracer
    frame_ms, is_kf = second["ms"], second["is_kf"]
    steady = frame_ms[np.array(second["tracked"]) & ~is_kf]
    system_fps = len(frame_ms) / (frame_ms.sum() / 1e3)
    bootstrap = {k: span_ms(tr, "initialize/" + k) for k in ("match", "twoview", "init_ba")}
    mapping = {"triangulate": span_ms(tr, "mapping_a/triangulate"),
               "fuse": span_ms(tr, "mapping/fuse"), "local_ba": span_ms(tr, "mapping/local_ba"),
               "total": span_ms(tr, "create_kf")}
    fuse_per_kf = first["counts"]["fuse"] / max(1, len(first["passes"]))
    log("bootstrap (host clock, ms per call, each span ends in a fetch): "
        + ", ".join(f"{k} {v:.1f}" for k, v in bootstrap.items()) + f" [{card}]")
    log("a keyframe's mapping pass (host clock, mean ms over "
        f"{len(second['passes'])} passes): "
        + ", ".join(f"{k} {v:.1f}" for k, v in mapping.items())
        + f"; masked_nn launches per keyframe from the fuse {fuse_per_kf:.1f} [{card}]")
    log(f"System.track_monocular: {system_fps:.2f} frames/s over {len(frame_ms)} frames; per "
        f"frame median {np.median(steady):.1f} ms over {len(steady)} tracked frames without a "
        f"keyframe (of which the fused step with its fetch {span_ms(tr, 'fused_track/kernel'):.1f}"
        f" ms), frames that inserted keyframes (the bootstrap first) "
        f"{[round(float(x), 1) for x in frame_ms[is_kf]]} ms [{card}]")
    # the chain once more, so that the System's frames stand between two
    # readings of the same step in the same process
    lat_after = frame_latencies(step, frames_u8, state, cand, passes=1)
    log(f"the hand-built chain again, after the System runs: median {np.median(lat_after):.2f} "
        f"ms over {len(lat_after)} frames (before them: {np.median(lat):.2f} ms) [{card}]")
    log(f"the second run's largest spans (host clock) [{card}]:")
    for line in tr.report().splitlines()[:13]:
        log("  " + line)

    stamp("phase 5")
    # ---- 6. the default configuration -------------------------------------- #
    default, loop_system, lm_calls, default_runs = phase6(cfg, weights, device, card, errs,
                                                         k1_cases, sites)
    stamp("phase 6")
    sites.phase = "7"
    # ---- 7. localization mode, persistence, EuRoC's lens ------------------- #
    localization = phase7(cfg, second["system"], frames_u8, weights, device, card, errs,
                          k1_cases)
    launches_loc = sum(localization[k]["launches"] for k in ("7a", "7b", "7c"))
    stamp("phase 7")
    sites.phase = "8"
    # ---- 8. the entry points ------------------------------------------------ #
    try:
        entry = phase8(cfg, device, card, errs, k1_cases)
    finally:
        sites.__exit__()
    launches_entry = sum(entry[k].get("launches", 0) for k in entry)
    stamp("phase 8")
    # ---- 9. ASDNet training ------------------------------------------------ #
    t0 = time.perf_counter()
    training = phase9(cfg, frames_u8, device, card, errs, k1_cases)
    training["seconds"] = time.perf_counter() - t0
    launches_train = training["9c"]["launches"]
    stamp("phase 9")
    # ---- 10. ORB with K1 at d = 256, assignment, the native library -------- #
    t0 = time.perf_counter()
    orb_path = phase10(cfg, device, card, errs, k1_cases, layers["extract"], second["system"],
                       entry["8a"]["native_decodes"])
    orb_path["seconds"] = time.perf_counter() - t0
    launches_orb = orb_path["10b"]["launches"]
    stamp("phase 10")
    # ---- 11. the multi-device path ----------------------------------------- #
    t0 = time.perf_counter()
    multi_device, launches_multi = phase11(cfg, device, card, loop_system, errs, k1_cases)
    multi_device["seconds"] = time.perf_counter() - t0
    log(json.dumps({"multi_device": multi_device, "card": card}))
    stamp("phase 11")
    # ---- 12. the debug image, the KITTI-proxy twin, the measurement twins -- #
    t0 = time.perf_counter()
    tools = phase12(cfg, device, card, second["system"], frames_u8, errs, k1_cases)
    tools["seconds"] = time.perf_counter() - t0
    launches_kitti = tools["12b"]["launches"]
    stamp("phase 12")
    # ---- 13. singular inputs, the LM loops' host synchronisations ---------- #
    faults = phase13(device, card)
    stamp("phase 13")
    # ---- 14. the CUDA-graph capture, against the eager sites --------------- #
    t0 = time.perf_counter()
    capture = phase14(cfg, step, extract, frames_u8, state, cand, lm_calls, second, weights,
                      device, card)
    capture["seconds"] = time.perf_counter() - t0
    stamp("phase 14")
    # ---- 15. the reference's remaining jit sites, captured ----------------- #
    t0 = time.perf_counter()
    jit_sites = phase15(cfg, weights, device, card, sites, default_runs)
    jit_sites["seconds"] = time.perf_counter() - t0
    del default_runs
    stamp("phase 15")
    # ---- 16. the reference's last jit sites, captured ---------------------- #
    t0 = time.perf_counter()
    last_sites = phase16(cfg, weights, device, card, loop_system, sites)
    last_sites["seconds"] = time.perf_counter() - t0
    stamp("phase 16")

    # K1 by shape.  Everything that reads a clock comes before the first use
    # of torch.profiler: once it has traced, later launches of the process
    # cost more on the host.
    shapes = []
    for case in ("motion 2000x2000", "local-map 8192x2000",
                 "frame 1 motion search", "frame 1 local-map search", "keyframe fuse",
                 "loop guided search", "loop fuse", "relocalization search",
                 "EuRoC proxy local-map search", "trained weights local-map search",
                 "KITTI proxy local-map search", "motion 2000x2000x256 d256", "local-map 8192x2000x256 d256",
                 "ORB motion 2000x2000x256", "ORB local-map 8192x2000x256",
                 "11c batched local-map search B=4", "11c batched local-map search B=16"):
        args, pairs_in, share = k1_cases[case]
        bound, bound_by = k1_bound_ms(args, pairs_in)
        batch = args[0].shape[0] if args[0].ndim == 3 else 1  # one launch for B problems
        shapes.append(dict(shape=case, batch=batch, n=args[0].shape[-2], m=args[1].shape[-2],
                           d=args[0].shape[-1],
                           ms=time_ms(lambda: k1.masked_nn(*args), 50),
                           plain_ms=time_ms(lambda: k1.masked_nn_plain(*args), 5),
                           bound_ms=bound, bound_by=bound_by,
                           gated_in_pairs=pairs_in, live_tile_share=share,
                           host_enqueue_ms=k1_host_ms(args)))
    stamp("K1 timings")
    busy, wall, k1_step_ms, top = device_busy(step, frames_u8, state, cand)
    log(f"profiler over 3 chained frames of the captured step: device busy {busy:.1f} ms of "
        f"{wall:.1f} ms wall (idle share {1 - busy / wall:.3f}); K1's kernels inside the graph, "
        "device ms a frame: " + ", ".join(f"{k} {v:.4f}" for k, v in k1_step_ms.items())
        + "; largest kernels, device ms a frame: "
        + ", ".join(f"{k[:60]} {v:.3f}" for k, v in top) + f" [{card}]")
    e_busy, e_wall, e_k1, _ = device_busy(step.eager, frames_u8, state, cand)
    log(f"profiler over 3 chained frames of the eager step: device busy {e_busy:.1f} ms of "
        f"{e_wall:.1f} ms wall (idle share {1 - e_busy / e_wall:.3f}); K1's kernels, device ms a "
        "frame: " + ", ".join(f"{k} {v:.4f}" for k, v in e_k1.items()) + f" [{card}]")
    capture["14a"].update(busy_ms=busy, wall_ms=wall, idle_share=1 - busy / wall,
                          k1_device_ms_a_frame=k1_step_ms, top_kernels_ms=top,
                          eager_busy_ms=e_busy,
                          eager_wall_ms=e_wall, eager_idle_share=1 - e_busy / e_wall,
                          eager_k1_device_ms_a_frame=e_k1)
    for sh in shapes:
        sh["device_ms"] = k1_device_ms(k1_cases[sh["shape"]][0])
        log(f"masked_nn {sh['shape']}: kernel {sh['ms']:.4f} ms (whole wrapper call), plain "
            f"(no yardstick) {sh['plain_ms']:.4f} ms, gated-in pairs {sh['gated_in_pairs']}, "
            f"live tile pairs {sh['live_tile_share']:.4f}, bound {sh['bound_ms']:.5f} ms "
            f"({sh['bound_by']}); host enqueue {sh['host_enqueue_ms']:.4f} ms, device "
            + ", ".join(f"{k} {v:.4f}" for k, v in sh["device_ms"].items()) + f" ms [{card}]")
    mfu_rows = {r["name"]: r for r in tools["mfu_bench_torch"]["kernels"]}
    for row, case in (("match_motion_2000x2000", "motion 2000x2000"),
                      ("match_localmap_8192x2000", "local-map 8192x2000")):
        sh = next(x for x in shapes if x["shape"] == case)
        log(f"{row}: mfu_bench_torch's search_projection (its random inputs, a 15 px window, "
            f"{mfu_rows[row]['pairs_in']} gated-in pairs, median of 5 windows of 10 calls) "
            f"{mfu_rows[row]['ms']:.4f} ms, least {mfu_rows[row]['sol_ms']:.5f} ms "
            f"({mfu_rows[row]['bound']}), sol_frac {mfu_rows[row]['sol_frac']:.5f}; beside it "
            f"K1's masked_nn on phase 2's {case} ({sh['gated_in_pairs']} gated-in pairs) "
            f"{sh['ms']:.4f} ms (bound {sh['bound_ms']:.5f} ms, {sh['bound_by']}) [{card}]")
    t_busy, t_wall, t_top = train_busy(device)
    training["profile"] = dict(steps=10, busy_ms=t_busy, wall_ms=t_wall, top_kernels_ms=t_top)
    log(f"profiler over 10 training steps at batch {TRAIN_BATCH}: device busy {t_busy:.1f} ms of "
        f"{t_wall:.1f} ms wall (idle share {1 - t_busy / t_wall:.3f}); largest kernels, device ms a "
        f"step: " + ", ".join(f"{k[:60]} {v:.3f}" for k, v in t_top) + f" [{card}]")
    stamp("the profiler's readings")
    log("masked_nn: no single PyTorch call computes a masked top-2 search, so library_ms is null")
    main_shape = shapes[3]  # the local-map search on its real inputs, every frame's larger call
    log(json.dumps({"kernels": [{
        "name": "masked_nn", "route": "cuda",
        "source": "asdslam_torch/csrc/masked_nn.cu",
        "replaces": "asdslam_tpu/ops/pallas_match.py:42",
        "launches": (launches + launches_system + default["launches"] + launches_loc
                     + launches_entry + launches_train + launches_orb + launches_multi
                     + launches_kitti + capture["14a"]["launches"]),
        "max_abs_err": max(errs),
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
        "library_ms": None, "by_shape": shapes}],
        "fused_step_fps": fps, "frame_ms_median": float(np.median(lat)),
        "frame_ms_p85": float(np.percentile(lat, 85)),
        "frame_ms_median_after_system": float(np.median(lat_after)), "layers_ms": layers,
        "device_busy_ms": busy, "device_wall_ms": wall,
        "launches_by_path": {"chained_step": launches, "system": launches_system,
                             "system_fused_step": first["counts"]["step"],
                             "system_fuse": first["counts"]["fuse"],
                             "default_config": default["launches"],
                             "default_config_by_site": default["by_site"],
                             "localization": localization["7a"]["launches"],
                             "localization_by_site": localization["7a"]["by_site"],
                             "loc_extend_map": localization["7b"]["launches"],
                             "loc_extend_map_by_site": localization["7b"]["by_site"],
                             "euroc_lens": localization["7c"]["launches"],
                             "euroc_lens_by_site": localization["7c"]["by_site"],
                             **{f"entry_points_{k}": entry[k]["launches"]
                                for k in ("8a", "8c", "8e")},
                             **{f"entry_points_{k}_by_site": entry[k]["by_site"]
                                for k in ("8a", "8c", "8e")},
                             "trained_weights": launches_train,
                             "trained_weights_by_site": training["9c"]["by_site"],
                             "orb_chained_step": launches_orb,
                             "multi_sequence": launches_multi,
                             "kitti_eval": launches_kitti,
                             "kitti_eval_by_site": tools["12b"]["by_site"],
                             "captured_chain": capture["14a"]["launches"]},
        "default_config": default, "localization": localization, "entry_points": entry,
        "training": training, "orb_path": orb_path, "phase12": tools, "phase13": faults,
        "phase14": capture, "phase15": jit_sites, "phase16": last_sites,
        "system": {"frames": N_SYSTEM, "fps": system_fps,
                   "frame_ms_median": float(np.median(steady)),
                   "keyframe_frame_ms": [float(x) for x in frame_ms[is_kf]],
                   "bootstrap_ms": bootstrap, "mapping_ms": mapping, "ate_m": ate,
                   "ate_bar_m": ATE_BAR, "stats": first["system"].stats(),
                   "passes": first["passes"], "fuse_launches_per_keyframe": fuse_per_kf},
        "card": card}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


def phase14_alone():
    """``python3 chip_smoke.py --phase14``: phase 14 without the other
    phases, for a change to a capture site (~3 min).  Its LM arguments are
    the essential graph and global BA of phase 13's problems and the largest
    local BA of phase 5's first run (recorded there), with bench_torch.py's
    local BA; its profiler readings of the step follow.  Prints one JSON
    line; exit code 0 when every check passed."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from asdslam_torch import kernels
    from asdslam_torch.backend import ba, global_ba, pose_graph
    from asdslam_torch.config import SlamConfig
    from asdslam_torch.frontend import track_step as ts
    from asdslam_torch.models.asdnet import load_weights

    device, card = "cuda", card_line()
    kernels.build()
    log(f"card: {card}")
    cfg = SlamConfig()
    K, extract, frames_u8, poses, cand, state = build_tracking(cfg, device)
    step = ts.make_track_step(cfg, K, extract, device=device)
    weights = load_weights(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                        "asdnet_weights.pkl"))
    sync_cfg = cfg.replace(pipelined_tracking=False, async_mapping=False)
    with record_lm_calls() as recorded:
        run_system(sync_cfg, frames_u8, weights, device)
    captured_run = run_system(sync_cfg, frames_u8, weights, device)

    def dev(x):
        return torch.as_tensor(x).to(device)

    poses8, i, j, meas, w, fixed = map(dev, pose_graph_problem_np())
    edges = pose_graph.PoseGraphEdges(i=i, j=j, meas=meas, weight=w,
                                      valid=torch.ones(len(w), dtype=torch.bool, device=device))
    poses7, X, pt_valid, *obs, n_opt = gba_problem_np()
    lm_calls = {
        "optimize_pose_graph": (pose_graph.optimize_pose_graph, (poses8, edges, fixed),
                                dict(iters=15)),
        "global_bundle_adjust": (global_ba.global_bundle_adjust,
                                 (dev(poses7), dev(X), dev(pt_valid), ba.Obs(*map(dev, obs)),
                                  dev(SING_K)), dict(n_opt=n_opt, iters=10, cg_iters=40)),
        "bundle_adjust": recorded["bundle_adjust"]}
    out = phase14(cfg, step, extract, frames_u8, state, cand, lm_calls, captured_run, weights,
                  device, card)
    busy, wall, k1_ms, top = device_busy(step, frames_u8, state, cand)
    e_busy, e_wall, e_k1, _ = device_busy(step.eager, frames_u8, state, cand)
    out["14a"].update(idle_share=1 - busy / wall, k1_device_ms_a_frame=k1_ms,
                      top_kernels_ms=top, eager_idle_share=1 - e_busy / e_wall,
                      eager_k1_device_ms_a_frame=e_k1)
    log(f"14a idle share captured {1 - busy / wall:.3f}, eager {1 - e_busy / e_wall:.3f}; K1's "
        f"device ms a frame inside the graph {k1_ms}; largest kernels {top} [{card}]")
    log(json.dumps({"phase14": out, "card": card}))
    return 0


def phase15_alone():
    """``python3 chip_smoke.py --phase15``: phase 15 without the other
    phases, for a change to a capture site (~5 min): phase 5's synchronous
    System twice, phase 6's default configuration twice (its first run
    recorded), phase 7a's localization on phase 5's map with its
    relocalization checks, then phase 15.  Prints one JSON line; exit code 0
    when every check passed."""
    import tempfile
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from asdslam_torch import kernels
    from asdslam_torch.config import SlamConfig
    from asdslam_torch.models.asdnet import load_weights

    device, card = "cuda", card_line()
    kernels.build()
    log(f"card: {card}")
    cfg = SlamConfig()
    frames_u8 = build_tracking(cfg, device)[2]
    weights = load_weights(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                        "asdnet_weights.pkl"))
    sync_cfg = cfg.replace(pipelined_tracking=False, async_mapping=False)
    with SiteLog() as sites:
        sites.phase, sites.timed = "5", set(JIT_SITES)
        run_system(sync_cfg, frames_u8, weights, device)
        mapped = run_system(sync_cfg, frames_u8, weights, device)["system"]
        sites.phase, sites.keep, sites.timed = "6 first", True, set(LOOP_FUNNEL) | {"bow_descend"}
        loop_frames = render_loop(cfg, device)[0]
        first = run_default(cfg, loop_frames, weights, device)
        sites.phase, sites.timed = "6 again", ()
        again = run_default(cfg, loop_frames, weights, device)
        sites.phase = "7"
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "phase5.map")
            mapped.save_map(path)
            loc = load_localization(cfg, path, weights, device)[0]
            drive(loc, frames_u8, range(N_SYSTEM))
            reloc_acceptance(loc, frames_u8, device)
    out = phase15(cfg, weights, device, card, sites, (first, again))
    log(json.dumps({"phase15": out, "card": card}, default=str))
    return 0


def phase16_alone():
    """``python3 chip_smoke.py --phase16``: phase 16 without the other
    phases, for a change to one of its sites (~3 min): phase 6's default
    configuration once (the map 16a's mesh GBA reads), then phase 16.
    Prints one JSON line; exit code 0 when every check passed."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from asdslam_torch import kernels
    from asdslam_torch.config import SlamConfig
    from asdslam_torch.models.asdnet import load_weights

    device, card = "cuda", card_line()
    kernels.build()
    log(f"card: {card}")
    cfg = SlamConfig()
    weights = load_weights(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                        "asdnet_weights.pkl"))
    loop_system = run_default(cfg, render_loop(cfg, device)[0], weights, device)["system"]
    if not loop_system.loop_closer.accepted_log:
        raise AssertionError("phase 6's run closed no loop")
    out = phase16(cfg, weights, device, card, loop_system)
    log(json.dumps({"phase16": out, "card": card}, default=str))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multihost-child"]:
        sys.exit(multihost_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--phase14"]:
        sys.exit(phase14_alone())
    if sys.argv[1:2] == ["--phase15"]:
        sys.exit(phase15_alone())
    if sys.argv[1:2] == ["--phase16"]:
        sys.exit(phase16_alone())
    if sys.argv[1:2] == ["--sim3-first-calls"]:
        sys.exit(sim3_first_calls_child())
    sys.exit(main())
