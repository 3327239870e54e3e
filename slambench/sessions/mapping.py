"""``"session": "mapping"``: the System of the configuration's ``system``
block (its keys other than ``weights`` are the System's keyword arguments)
in the configuration's mode, mapping as it tracks, warmed up on the
stream's first frames.

A session module's ``start(spec, cfg, frames, warmup, device, log)`` builds
the System a cell's window drives and returns it warmed up, with the
stream's first ``warmup`` frames fed.  A new session is a new file here,
named by a traffic file's ``session``.
"""

from __future__ import annotations

import contextlib
import os
import time

# what the loop funnel's warm-up reaches inside the program: a rename there
# fails the run here, rather than moving the funnel's first run into the
# window unseen
FUNNEL_HOOKS = ("_compute_sim3_and_correct", "_correct_loop", "counters")


def start(spec, cfg, frames, warmup, device, log):
    from asdslam_torch import system as system_mod
    from asdslam_torch.models import asdnet

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    kw = {k: v for k, v in spec["system"].items() if k != "weights"}
    system = system_mod.System(cfg, asdnet_params=asdnet.load_weights(
        os.path.join(root, spec["system"]["weights"])), device=device, **kw)
    for i in range(warmup):
        system.track_monocular(frames[i], i)
    if system.loop_closer is not None:
        warm_loop_funnel(system, log)
    return system


def warm_loop_funnel(system, log):
    """Run the loop closer's candidate check (the Sim3 funnel: the global
    search, the Sim3 RANSAC and refinement, the guided support) twice on the
    newest pair of neighbouring keyframes whose matches pass its first gate,
    on the mapping worker's stream, with the loop correction held off and
    the counters put back, so that the funnel's first run (its warm-up, with
    the process's first Sim3 refinement, many seconds) and its capture fall
    in the set-up.  A false candidate may first reach the funnel at a frame
    that depends on the seed; without this, that cost would land inside the
    window of some seeds and not of others.  Drains the pipeline and joins
    the worker first (``finish``).  Raises where the program lacks what it
    reaches."""
    import torch
    lc, store = system.loop_closer, system.store
    missing = [h for h in FUNNEL_HOOKS if not hasattr(lc, h)]
    if not hasattr(system.tracker, "_map_stream"):
        missing.append("Tracker._map_stream")
    if missing:
        raise RuntimeError(f"the loop funnel's warm-up cannot reach {missing} in the program")
    system.finish()
    ks = [k for k in range(store.n_kf) if store.kf_valid[k]]
    check = lc._compute_sim3_and_correct
    counters = dict(lc.counters)
    lc._correct_loop = lambda *a, **kw: None
    stream = system.tracker._map_stream
    t0 = time.perf_counter()
    pair = None
    try:
        with torch.no_grad(), (torch.cuda.stream(stream) if stream is not None
                               else contextlib.nullcontext()):
            # the newest pair of neighbours whose matches pass the funnel's
            # first gate (the newest keyframe may not hold its points yet)
            for i in range(1, min(len(ks), 8)):
                gate = lc.counters.get("match_gate", 0)
                check(ks[-i], ks[-i - 1])
                if lc.counters.get("match_gate", 0) > gate:
                    pair = (ks[-i], ks[-i - 1])
                    check(*pair)
                    break
            if stream is not None:
                stream.synchronize()
    finally:
        del lc._correct_loop
        lc.counters.clear()
        lc.counters.update(counters)
    if pair is None:
        # a map too thin to pass the gate (a broken run's): the check judges it
        log(f"loop funnel warm-up: no pair of the newest {min(len(ks), 8)} keyframes passed "
            "its first gate")
    else:
        log(f"loop funnel warm-up on keyframes {pair}: {time.perf_counter() - t0:.1f} s")
