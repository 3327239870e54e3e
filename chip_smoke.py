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
   synchronous mode at the same shape with the trained ASDNet over 40 frames
   of the corridor (two-view bootstrap, fused tracking, keyframes, local
   mapping inline), twice from fresh Systems; check the bootstrap, the
   keyframes and their mapping passes, the tracked share, finiteness, the
   sim3 ATE against the renderer's ground truth, that masked_nn was launched
   from the fused step and from the fuse, and that both runs give bitwise
   equal trajectories; hold masked_nn against its plain version on a fuse
   call's recorded inputs and time it; print the bootstrap's, a mapping
   pass's and the frames' times.

Prints a `kernels` JSON line before the last line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX or of the JAX package.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

# H100 SXM dense peaks (NVIDIA data sheet), for the bounds
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
N_CHAINED = 12
N_SYSTEM = 40          # frames of phase 5
# The JAX package's System on the same 40 frames and configuration, on a CPU
# (python tests/test_torch_system.py --reference-ate): 39 of 40 tracked, 5
# keyframes, sim3 ATE 0.0297 m.  The port is held to twice that or 0.5 m,
# whichever is larger.
REFERENCE_ATE = 0.0297
ATE_BAR = max(2 * REFERENCE_ATE, 0.5)
STEP_M, TURN = 0.3, 0.004


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def edge_problem(case):
    """The contract's edge cases, built on the tie problem."""
    shape = {"ragged m 1100x2001": (1100, 2001), "large 20000x20000": (20000, 20000)}
    p = nn_problem(*shape.get(case, (300, 257)), ties=True, seed=11)
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


def check_k1(case, args, ratio=0.8, max_dist=1.2):
    """Kernel vs plain on one set of arguments; raises on disagreement, on
    outputs that differ between two runs, or on a culled tile pair that
    holds a gated-in pair.  Returns (the larger of max |d best| and
    max |d second|, gated-in pairs, share of live tile pairs)."""
    import torch
    from asdslam_torch.ops import masked_nn as k1

    (idx, best, second), prep = k1.masked_nn_tiles(*args)
    again, _ = k1.masked_nn_tiles(*args)
    pidx, pbest, psecond = k1.masked_nn_plain(*args)
    torch.cuda.synchronize()
    for name, x, y in zip(("idx", "best", "second"), (idx, best, second), again):
        if not torch.equal(x, y):
            raise AssertionError(f"{case}: {name} differs between two runs")

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
    if err > 5e-5 or serr > 5e-5:
        raise AssertionError(f"{case}: |d best| {err}, |d second| {serr} > 5e-5")

    # the culling, from the kernel's own ordering and summaries
    gated = k1.gate_plain(*args[2:])
    culled, live = k1.culled_gated_pairs(prep, gated, args[9])
    if culled:
        raise AssertionError(f"{case}: culled tile pairs hold {culled} gated-in pairs")
    pairs_in, share = int(gated.sum()), float(live.float().mean())
    log(f"K1 {case}: N={args[0].shape[0]} M={args[1].shape[0]} ok rows {int(ok.sum())}, "
        f"gated-in rows {int(gated_in.sum())}, gated-in pairs {pairs_in}, live tile pairs "
        f"{share:.4f}, max|d best| {err:.3g}, max|d second| {serr:.3g}, two runs bitwise equal")
    return max(err, serr), pairs_in, share


def k1_bound_ms(args, pairs_in):
    """Least time for the function on these inputs: bytes (each input read
    once, each output written once) over the memory rate, or the bf16 dot of
    the pairs that pass the gates (what this data needs; a culling kernel
    does not evaluate the gate for every pair) over the bf16 peak, whichever
    is larger."""
    n, d = args[0].shape
    in_bytes = sum(a.numel() * a.element_size() for a in args[:9])
    t_bytes = (in_bytes + n * 12) / PEAK_BYTES
    t_ops = 2.0 * d * pairs_in / PEAK_BF16_FLOPS
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
    wrapper is replaced for that frame only)."""
    from asdslam_torch.ops import masked_nn as k1

    calls, real = [], k1.masked_nn

    def recorder(*a):
        calls.append(a)
        return real(*a)

    recorder.launches = real.launches
    k1.masked_nn = recorder
    try:
        run_chain(step, frames_u8, state, cand, 1, 1)
    finally:
        k1.masked_nn = real
    if len(calls) < 2:
        raise AssertionError(f"one frame made {len(calls)} masked_nn calls")
    return calls[-2], calls[-1]  # the motion search's last try, the local-map search


# --------------------------------------------------------------------------- #
# The main path: the fused tracking step at full width
# --------------------------------------------------------------------------- #
def build_tracking(cfg, device):
    import torch
    from asdslam_torch.frontend import track_step as ts
    from asdslam_torch.frontend.extractor import make_extractor
    from asdslam_torch.geometry import se3
    from asdslam_torch.io import synthetic
    from asdslam_torch.models.asdnet import ASDNet, load_weights

    K = torch.tensor([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1.0]])
    net = ASDNet().to(device)
    weights = os.path.join(os.path.dirname(os.path.abspath(__file__)), "asdnet_weights.pkl")
    net.load_state_dict(load_weights(weights))
    extract = make_extractor(cfg, net)

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
    feat, geom, pose, vel, crow = (state[k] for k in ("feat", "geom", "pose", "vel", "crow"))
    results = []
    for i in range(first, first + count):
        feat, res = step(frames_u8[i], pose, vel, feat, geom, cand, crow)
        geom, pose, vel, crow = res.next_geom, res.pose, res.velocity, res.crow
        results.append(res)
    return results


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
    """(device kernel time, wall time) in ms over 3 chained frames, from
    torch.profiler: the sum of device self time over all events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_chain(step, frames_u8, state, cand, 1, 3)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # the attribute's name changed across PyTorch versions
    attr = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    busy = sum(getattr(e, attr) for e in events) / 1e3
    return busy, wall


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
    from asdslam_torch.backend import mapping_kernels
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

    real_fuse, real_nn = mapping_kernels.fuse_pairs, k1.masked_nn

    def fuse(*a, **kw):
        if not record_fuse:
            return real_fuse(*a, **kw)

        def recorder(*args):
            fuse_calls.append(args)
            return real_nn(*args)

        # the wrapper counts on whatever the module calls `masked_nn`
        recorder.launches = real_nn.launches
        k1.masked_nn = recorder
        try:
            return real_fuse(*a, **kw)
        finally:
            k1.masked_nn = real_nn
            real_nn.launches = recorder.launches

    system.tracker._fused = counted(
        ts.make_track_step(cfg, system.K, system.extract, device=device), "step")
    mapping_kernels.fuse_pairs = counted(fuse, "fuse")
    passes = []
    real_process = system.local_mapper.process

    def process(kf):
        real_process(kf)
        passes.append(dict(system.local_mapper.last_pass))

    system.local_mapper.process = process
    tracked, ms, is_kf = [], [], []
    torch.cuda.synchronize()
    k1.masked_nn.launches = 0
    try:
        for i, frame in enumerate(frames_u8):
            n_kf = system.store.n_kf
            t0 = time.perf_counter()
            pose = system.track_monocular(frame, i)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            tracked.append(pose is not None)
            is_kf.append(system.store.n_kf > n_kf)
    finally:
        mapping_kernels.fuse_pairs = real_fuse
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


def span_ms(tracer, suffix):
    """Mean ms per call of the span whose path ends in ``suffix``."""
    hits = [v for k, v in tracer.spans.items() if k.endswith(suffix)]
    if not hits:
        return None
    return sum(h.total for h in hits) / sum(h.count for h in hits) * 1e3


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
    if not 2 * N_CHAINED <= launches <= 3 * N_CHAINED:
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

    # ---- 5. the whole system through its entry point ----------------------- #
    from asdslam_torch.models.asdnet import load_weights
    weights = load_weights(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                        "asdnet_weights.pkl"))
    sync_cfg = cfg.replace(pipelined_tracking=False, async_mapping=False)
    first = run_system(sync_cfg, frames_u8, weights, device, record_fuse=True)
    second = run_system(sync_cfg, frames_u8, weights, device)
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

    # K1 by shape.  Everything that reads a clock comes before the first use
    # of torch.profiler: once it has traced, later launches of the process
    # cost more on the host.
    shapes = []
    for case in ("motion 2000x2000", "local-map 8192x2000",
                 "frame 1 motion search", "frame 1 local-map search", "keyframe fuse"):
        args, pairs_in, share = k1_cases[case]
        bound, bound_by = k1_bound_ms(args, pairs_in)
        shapes.append(dict(shape=case, n=args[0].shape[0], m=args[1].shape[0],
                           ms=time_ms(lambda: k1.masked_nn(*args), 50),
                           plain_ms=time_ms(lambda: k1.masked_nn_plain(*args), 5),
                           bound_ms=bound, bound_by=bound_by,
                           gated_in_pairs=pairs_in, live_tile_share=share,
                           host_enqueue_ms=k1_host_ms(args)))
    busy, wall = device_busy(step, frames_u8, state, cand)
    log(f"profiler over 3 chained frames: device busy {busy:.1f} ms of {wall:.1f} ms wall "
        f"(idle share {1 - busy / wall:.3f}) [{card}]")
    for sh in shapes:
        sh["device_ms"] = k1_device_ms(k1_cases[sh["shape"]][0])
        log(f"masked_nn {sh['shape']}: kernel {sh['ms']:.4f} ms (whole wrapper call), plain "
            f"(no yardstick) {sh['plain_ms']:.4f} ms, gated-in pairs {sh['gated_in_pairs']}, "
            f"live tile pairs {sh['live_tile_share']:.4f}, bound {sh['bound_ms']:.5f} ms "
            f"({sh['bound_by']}); host enqueue {sh['host_enqueue_ms']:.4f} ms, device "
            + ", ".join(f"{k} {v:.4f}" for k, v in sh["device_ms"].items()) + f" ms [{card}]")
    log("masked_nn: no single PyTorch call computes a masked top-2 search, so library_ms is null")
    main_shape = shapes[3]  # the local-map search on its real inputs, every frame's larger call
    log(json.dumps({"kernels": [{
        "name": "masked_nn", "route": "cuda",
        "source": "asdslam_torch/csrc/masked_nn.cu",
        "replaces": "asdslam_tpu/ops/pallas_match.py:42",
        "launches": launches + launches_system, "max_abs_err": max(errs),
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
        "library_ms": None, "by_shape": shapes}],
        "fused_step_fps": fps, "frame_ms_median": float(np.median(lat)),
        "frame_ms_p85": float(np.percentile(lat, 85)),
        "frame_ms_median_after_system": float(np.median(lat_after)), "layers_ms": layers,
        "device_busy_ms": busy, "device_wall_ms": wall,
        "launches_by_path": {"chained_step": launches, "system": launches_system,
                             "system_fused_step": first["counts"]["step"],
                             "system_fuse": first["counts"]["fuse"]},
        "system": {"frames": N_SYSTEM, "fps": system_fps,
                   "frame_ms_median": float(np.median(steady)),
                   "keyframe_frame_ms": [float(x) for x in frame_ms[is_kf]],
                   "bootstrap_ms": bootstrap, "mapping_ms": mapping, "ate_m": ate,
                   "ate_bar_m": ATE_BAR, "stats": first["system"].stats(),
                   "passes": first["passes"], "fuse_launches_per_keyframe": fuse_per_kf},
        "card": card}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
