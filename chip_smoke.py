#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (asdslam_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. build the hand-written CUDA kernels from the sources in the checkout
   (one nvcc per source, started together) and print the card's name and
   power limit;
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and on a tie/duplicate problem;
3. drive the main path at full width: the fused tracking step
   (make_extractor + make_track_step) at the KITTI shape (1241x376, 2000
   features, 8 levels, an 8192-row candidate block) over chained frames of
   the synthetic corridor, with launch counts reset just before and read
   just after; one frame is re-run with the plain matcher and compared;
4. time the step and each kernel (CUDA events) beside its plain version and
   its bound.

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
N_CHAINED = 24


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


def check_masked_nn(case, prob, ratio=0.8, max_dist=1.2):
    """Kernel vs plain on one problem; raises on disagreement.  Returns
    (max |best - best_plain| over gated-in rows, kernel args)."""
    import torch
    from asdslam_torch.ops import masked_nn as k1

    t = {k: torch.as_tensor(v).cuda() for k, v in prob.items()}
    args = (t["desc_a"], t["desc_b"], t["valid_a"], t["valid_b"], t["uv_a"], t["uv_b"],
            t["rad2"], t["levels_a"], t["levels_b"], (-1.0, 1.0))
    idx, best, second = k1.masked_nn(*args)
    pidx, pbest, psecond = k1.masked_nn_plain(*args)
    torch.cuda.synchronize()

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
    log(f"K1 {case}: N={prob['desc_a'].shape[0]} M={prob['desc_b'].shape[0]} "
        f"ok rows {int(ok.sum())}, gated-in rows {int(gated_in.sum())}, "
        f"max|d best| {err:.3g}, max|d second| {serr:.3g}")
    return max(err, serr), args


def k1_bound_ms(args):
    """Least time for the function on these inputs: bytes (each input read
    once, each output written once) over the memory rate, or operations over
    the peak rate of their type -- the bf16 dot for the pairs that pass the
    gates (what this data needs) plus ~10 f32 gate/distance operations for
    every pair -- whichever is larger."""
    desc_a, desc_b = args[0], args[1]
    n, d = desc_a.shape
    m = desc_b.shape[0]
    in_bytes = sum(a.numel() * a.element_size() for a in args[:9])
    out_bytes = n * 12
    dx = args[4][:, None, 0] - args[5][None, :, 0]
    dy = args[4][:, None, 1] - args[5][None, :, 1]
    ld = (args[8][None, :] - args[7][:, None]).float()
    gated = ((dx * dx + dy * dy) <= args[6][:, None]) & args[2][:, None] & args[3][None, :]
    gated &= (ld >= args[9][0]) & (ld <= args[9][1])
    pairs_in = int(gated.sum())
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES
    t_ops = max(2.0 * d * pairs_in / PEAK_BF16_FLOPS, 10.0 * n * m / PEAK_F32_FLOPS)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), pairs_in


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

    step_m, turn = 0.3, 0.004
    frames, poses = synthetic.render_sequence(
        K, N_CHAINED + 1, cfg.image_height, cfg.image_width, step=step_m, turn=turn,
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
    errs, k1_args = [], {}
    for case, n, m, ties in (("motion 2000x2000", 2000, 2000, False),
                             ("local-map 8192x2000", 8192, 2000, False),
                             ("ties 300x257", 300, 257, True)):
        err, args = check_masked_nn(case, nn_problem(n, m, ties=ties, seed=n + m))
        errs.append(err)
        k1_args[case] = args

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
    lat = frame_latencies(step, frames_u8, state, cand, passes=3)
    log(f"per-frame latency over {len(lat)} frames (synchronised each frame): "
        f"median {np.median(lat):.2f} ms, p85 {np.percentile(lat, 85):.2f} ms [{card}]")
    layers = layer_times(cfg, K, extract, frames_u8, state, cand, device)
    log("per layer, one call each (CUDA events, ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in layers.items()) + f" [{card}]")
    busy, wall = device_busy(step, frames_u8, state, cand)
    log(f"profiler over 3 chained frames: device busy {busy:.1f} ms of {wall:.1f} ms wall "
        f"(idle share {1 - busy / wall:.3f}) [{card}]")

    shapes = []
    for case in ("motion 2000x2000", "local-map 8192x2000"):
        args = k1_args[case]
        ms = time_ms(lambda: k1.masked_nn(*args), 50)
        plain_ms = time_ms(lambda: k1.masked_nn_plain(*args), 5)
        bound, bound_by, pairs_in = k1_bound_ms(args)
        shapes.append(dict(shape=case, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                           bound_by=bound_by, gated_in_pairs=pairs_in))
        log(f"masked_nn {case}: kernel {ms:.4f} ms, plain (no yardstick) {plain_ms:.4f} ms, "
            f"bound {bound:.5f} ms ({bound_by}) [{card}]")
    log("masked_nn: no single PyTorch call computes a masked top-2 search, so library_ms is null")
    main_shape = shapes[1]  # the local-map search, the larger launch of every frame
    log(json.dumps({"kernels": [{
        "name": "masked_nn", "route": "cuda",
        "source": "asdslam_torch/csrc/masked_nn.cu",
        "replaces": "asdslam_tpu/ops/pallas_match.py:42",
        "launches": launches, "max_abs_err": max(errs),
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
        "library_ms": None, "by_shape": shapes}],
        "fused_step_fps": fps, "frame_ms_median": float(np.median(lat)),
        "frame_ms_p85": float(np.percentile(lat, 85)), "layers_ms": layers,
        "device_busy_ms": busy, "device_wall_ms": wall, "card": card}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
