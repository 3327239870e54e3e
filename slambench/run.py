"""The port's benchmark: one run of one cell.

    python3 slambench/run.py --workload kitti.cruise --seed 7 --seconds 30 --trace 0

Run from the root of a checkout (``BENCHMARK.json`` beside ``slambench/``)
on a machine with an NVIDIA card.  A run:

1. reads the cell from ``BENCHMARK.json``, its configuration from
   ``slambench/configs/<config>.json`` and its traffic from
   ``slambench/traffic/<traffic>.json``;
2. renders the stream's frames on the card from ``--seed``
   (``generator.py``, the traffic's world from ``slambench/worlds/``) and
   holds them on the host as uint8;
3. builds ``asdslam_torch.system.System`` as the configuration states it
   (its mode, loop closing, the repository's trained descriptor weights)
   and warms it up on the traffic's first ``warmup_frames`` frames (the
   bootstrap, the first keyframes, the online vocabulary, the captures of
   the steady path), as the traffic's session says
   (``slambench/sessions/<session>.py``);
4. resets the System's ``Tracer``;
5. feeds frames closed-loop for ``--seconds``: each frame goes to
   ``track_monocular`` when the previous call returns; with ``--trace 1`` a
   slice in the middle of the window runs under ``torch.profiler``;
6. calls ``finish()``, reads the peak memory, frees the System, holds what
   the window produced against the plain references (``check.py``) and
   prints the result as the last line of standard output.

Standard error carries the run's counts (calls, keyframes, valid feature
slots, the card's name, power limit and clocks), then each number compared
beside its limit as its last lines.  Each metric is read by
``slambench/metrics/<name>.py``; a metric whose reader finds nothing to
read is left out of the line.  Without a card, or with fewer cards than the
cell asks for, the run exits 2 and prints no result; a module of JAX or of
the JAX package in the process exits 3.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "asdslam_tpu")
# build and kernel caches at fixed paths inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "build/slambench/torch_extensions",
          "TRITON_CACHE_DIR": "build/slambench/triton"}
SAMPLE_KEYFRAMES = 3     # keyframes of the window whose descriptors are judged
SLICE_AT, SLICE_S = 0.4, 3.0   # the profiled slice: from 40% of the window, 3 s


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_json(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def cell_of(manifest: dict, workload: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def plugin(folder: str, name: str):
    """The module ``slambench/<folder>/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"slambench_{folder}_{name.replace('.', '_')}", os.path.join(HERE, folder, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """``slambench/metrics/<name>.py``'s ``read``."""
    return plugin("metrics", name).read


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_state() -> str:
    """nvidia-smi's name, power limit, SM and memory clocks, power draw."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.mem,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
            check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def slam_config(fields: dict):
    from asdslam_torch.config import SlamConfig
    return SlamConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()})


# --------------------------------------------------------------------------- #
# The profiled slice
# --------------------------------------------------------------------------- #
class Slice:
    """``torch.profiler`` over a slice of the window, the Tracer's spans
    mirrored as ``record_function`` labels while it is open."""

    def __init__(self, tracer, probe):
        import contextlib
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        self.torch, self.probe, self.tracer = torch, probe, tracer
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.open = False
        span = tracer.span

        @contextlib.contextmanager
        def labelled(name):
            if not self.open:
                with span(name):
                    yield
                return
            with span(name), record_function("span:" + name):
                yield

        tracer.span = labelled

    def start(self, frame):
        """Open the slice before ``frame``; ``self.before`` is the Tracer's
        spans and the host clock then."""
        self.before = (self.tracer.as_dict(), time.perf_counter(), frame)
        self.torch.cuda.synchronize()
        self.prof.start()
        self.probe.slice = []
        self.open = True
        self.t0 = time.perf_counter()

    def stop(self, frame):
        self.torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self.t0
        self.open = False
        self.launches, self.probe.slice = self.probe.slice, None
        self.prof.stop()
        self.after = (self.tracer.as_dict(), time.perf_counter(), frame)

    def outside(self, spans, frames, window_s, calls, first):
        """The window's spans, frame count, seconds and call times without
        the slice's (the profiler slows what it watches)."""
        (s0, t0, f0), (s1, t1, f1) = self.before, self.after
        out = {}
        for name, s in spans.items():
            a, b = s0.get(name), s1.get(name)
            count = s["count"] - (b["count"] if b else 0) + (a["count"] if a else 0)
            total = s["total_s"] - (b["total_s"] if b else 0.0) + (a["total_s"] if a else 0.0)
            if count > 0:
                out[name] = {"count": count, "total_s": total, "mean_ms": total / count * 1e3}
        kept = calls[:f0 - first] + calls[f1 - first:]
        return out, frames - (f1 - f0), window_s - (t1 - t0), kept

    def summary(self):
        """{"kernels": [(name, t0_us, t1_us)], "busy_s", "wall_s",
        "k1_launches", "device_ops", "idle_gaps"}."""
        from torch.autograd import DeviceType
        events = self.prof.events()
        # the device's activities, without the spans' own ranges that the
        # profiler mirrors onto the device's timeline
        kernels = [(e.name, e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA and not e.name.startswith("span:")]
        host = [(e.name, e.time_range.start, e.time_range.end) for e in events
                if e.device_type == DeviceType.CPU]
        merged = []
        for _, a, b in sorted(kernels, key=lambda k: k[1]):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        busy_us = sum(b - a for a, b in merged)
        by_name = {}
        for name, a, b in kernels:
            by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                       for i in range(len(merged) - 1)), reverse=True)[:10]
        return {"kernels": kernels, "busy_s": busy_us * 1e-6, "wall_s": self.wall_s,
                "k1_launches": list(self.launches),
                "device_ops": [[name[:160], s] for name, s in ops],
                "idle_gaps": [[self._doing(host, (a + b) / 2), g * 1e-6] for g, a, b in gaps]}

    @staticmethod
    def _doing(host, t):
        """The innermost Tracer span open on the host at ``t``, else the
        innermost profiled host operation."""
        covering = [(b - a, name) for name, a, b in host if a <= t <= b]
        spans = [c for c in covering if c[1].startswith("span:")]
        pick = min(spans or covering, default=None)
        return pick[1] if pick else "no host event"


# --------------------------------------------------------------------------- #
# One run
# --------------------------------------------------------------------------- #
def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             slam_overrides=None, traffic_overrides=None, collect: bool = False) -> dict:
    """One run of ``workload``; returns {"line": the result's dict,
    "checks": {name: (value, limit)}} and, with ``collect``, what was
    judged ("judged").  ``slam_overrides`` / ``traffic_overrides`` change
    the configuration and the traffic (the tests' small CPU runs)."""
    import torch

    import check
    import generator
    from probe import K1Probe, host_copy

    sys.path.insert(0, ROOT)
    from asdslam_torch.ops import masked_nn
    from asdslam_torch.utils import graphs

    manifest = load_json("BENCHMARK.json")
    cell = cell_of(manifest, workload)
    spec = load_json("slambench", "configs", cell["config"] + ".json")
    traffic = dict(load_json("slambench", "traffic", cell["traffic"] + ".json"))
    traffic.update(traffic_overrides or {})
    slam = dict(spec["slam"])
    slam.update(slam_overrides or {})
    cfg = slam_config(slam)
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    warmup = int(traffic["warmup_frames"])
    n_frames = warmup + int(math.ceil(seconds * float(traffic["max_fps"])))
    stream = generator.make_stream(traffic, slam, n_frames, seed, dev)
    sync()
    log(f"stream: {n_frames} frames of {cell['traffic']} at {slam['image_width']}x"
        f"{slam['image_height']} from seed {seed} ({time.perf_counter() - _T0:.1f} s in)")

    probe = K1Probe(masked_nn, graphs)
    in_window = [False]
    captures = []
    warm, capture = graphs._warm, graphs._capture

    def counted(kind, fn):
        def wrapper(f, *a, **kw):
            if in_window[0]:
                captures.append(f"{kind}:{getattr(f, '__name__', f)}@{probe.clock}")
            return fn(f, *a, **kw)
        return wrapper

    graphs._warm, graphs._capture = counted("warm-up", warm), counted("capture", capture)
    try:
        session = plugin("sessions", traffic["session"])
        system = session.start(spec, cfg, stream.frames, warmup, device, log)
        sync()
        prof = Slice(system.tracer, probe) if trace else None
        if prof is not None:
            # CUPTI's first start is slow: pay it in the set-up
            prof.start(0)
            prof.stop(0)
            prof = Slice(system.tracer, probe)
        store = system.store
        kf_before = store.n_kf
        system.tracer.reset()
        log("card before the window: " + (card_state() if cuda else "cpu"))
        sync()
        setup_s = time.perf_counter() - _T0
        calls = []
        i = warmup
        in_window[0] = True
        t_win = time.perf_counter()
        while True:
            el = time.perf_counter() - t_win
            if el >= seconds:
                break
            if prof is not None and not prof.open and not hasattr(prof, "wall_s") \
                    and el >= SLICE_AT * seconds:
                prof.start(i)
            elif prof is not None and prof.open and el >= SLICE_AT * seconds + SLICE_S:
                prof.stop(i)
            if i >= n_frames:
                raise RuntimeError(f"the stream's {n_frames} frames ran out after "
                                   f"{el:.1f} s of the {seconds} s window")
            probe.clock = i
            t = time.perf_counter()
            system.track_monocular(stream.frames[i], i)
            calls.append(time.perf_counter() - t)
            i += 1
        window_s = time.perf_counter() - t_win
        in_window[0] = False
        if prof is not None and prof.open:
            prof.stop(i)
        spans = system.tracer.as_dict()
        frames = i - warmup
        fed = frames
        system.finish()
        sync()
        log("card after the window: " + (card_state() if cuda else "cpu"))
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

        # what the window produced, to the host
        window_ids = range(warmup, warmup + fed)
        traj = dict(system.frame_trajectory())
        tracked = [f for f in window_ids if f in traj]
        est = np.stack([traj[f] for f in tracked]) if tracked else np.zeros((0, 7))
        kf_ids = [k for k in range(kf_before, store.n_kf)
                  if warmup <= store.kf_frame_id[k] < warmup + fed]
        valid_share = (float(np.mean([store.kf_host[k].valid.mean() for k in kf_ids]))
                       if kf_ids else math.nan)
        pick = (np.random.default_rng(seed).choice(kf_ids, min(SAMPLE_KEYFRAMES, len(kf_ids)),
                                                   replace=False) if kf_ids else [])
        samples = []
        for k in sorted(int(k) for k in pick):
            f = store.kf_features[k]
            samples.append((stream.frames[int(store.kf_frame_id[k])], f.uv.cpu().numpy(),
                            f.level.cpu().numpy(), f.desc.cpu().numpy(),
                            f.valid.cpu().numpy()))
        launches = [host_copy(r) for r in probe.since(warmup)]
        n_loops = system.loop_closer.n_loops_closed if system.loop_closer is not None else 0
        profile = prof.summary() if prof is not None else None
        if prof is not None:
            spans, frames, window_s, calls = prof.outside(spans, frames, window_s, calls, warmup)
    finally:
        graphs._warm, graphs._capture = warm, capture
        probe.close()
    del system, store, probe
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    log(f"window: {fed} calls of track_monocular, {frames} of them outside a profiled slice, "
        f"in {window_s:.3f} s; "
        f"{len(kf_ids)} keyframes inserted; valid feature slots {valid_share:.4f}; "
        f"{len(tracked)} of {fed} frames tracked; {n_loops} loops closed; "
        f"{len(launches)} K1 launches judged, of shapes {sorted({l[0][0].shape[0] for l in launches})}"
        f" x {sorted({l[0][1].shape[0] for l in launches})}; "
        f"captures in the window: {len(captures)} {captures}")
    slow = sorted(range(len(calls)), key=lambda k: -calls[k])[:12]
    log("slowest calls (frame: ms): " + ", ".join(
        f"{warmup + k}: {calls[k] * 1e3:.0f}" for k in sorted(slow)))
    if profile is not None:
        log(f"profiled slice: {prof.after[2] - prof.before[2]} frames, {profile['wall_s']:.3f} s, device busy "
            f"{profile['busy_s']:.3f} s, {len(profile['k1_launches'])} K1 launches")

    # the comparisons, after the program's state is freed
    weights_path = os.path.join(ROOT, spec["system"]["weights"])
    weights = __import__("reference").load_weights(weights_path)
    gt = stream.pose7[tracked] if tracked else np.zeros((0, 7))
    values = {
        "ate_share": check.ate_share(est, gt),
        "desc_gap": check.desc_gap(samples, weights, slam, dev) if samples else math.inf,
        "k1_gap": check.k1_gap(launches, dev) if launches else math.inf,
    }
    limits = spec["limits"]
    checks = {k: (values[k], limits[k]) for k in values}
    correct = all(math.isfinite(v) and v <= lim for v, lim in checks.values())

    peaks = None
    if cuda:
        import roofline
        peaks = roofline.peaks_for(torch.cuda.get_device_name(dev))
    run = {"frames": frames, "window_s": window_s, "calls_s": calls, "spans": spans,
           "setup_s": setup_s, "n_features": cfg.n_features, "peaks": peaks,
           "profile": profile}
    metrics = {}
    for m in manifest["per_layer" if trace else "end_to_end"]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    line = {"correct": correct, "attempted": fed, "failed": fed - len(tracked),
            "metrics": metrics,
            "device": {"platform": "gpu" if cuda else "cpu",
                       "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                       "count": 1, "memory_peak_bytes": int(peak)}}
    if profile is not None:
        line["device"].update(busy_s=profile["busy_s"], window_s=profile["wall_s"])
        line["breakdown"] = {"device_ops": profile["device_ops"],
                             "idle_gaps": profile["idle_gaps"]}
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    out = {"line": line, "checks": checks}
    if collect:
        out["judged"] = {"samples": samples, "launches": launches, "est": est, "gt": gt,
                         "weights": weights, "slam": slam, "tracked": tracked}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, path in CACHES.items():
        os.environ[var] = os.path.join(ROOT, path)
    cell = cell_of(load_json("BENCHMARK.json"), args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"{args.workload} needs {cell['chips']} CUDA device(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        log(f"modules of JAX or of the JAX package were loaded: {bad}")
        return 3
    for name, (v, lim) in out["checks"].items():
        log(f"check {name}: {v!r} limit {lim!r}")
    print(json.dumps(out["line"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
