"""The readings that the limits of ``correct`` are set from.

    python3 slambench/control.py --workload kitti.cruise --seconds 10 --seeds 11 12 13

For each seed, one run of the cell at its own size on the card (a short
window at the cell's own load, in a process of its own), then, on what that
window produced:

- the program's reading of each number (``check.py``), as a benchmark run
  reads it;
- the control's: the reference computed in the precision below the one the
  configuration states (float8 where the program's descriptor convolutions
  and K1's dot are bfloat16), put in the program's place and judged the
  same way (``desc_gap``, ``k1_gap``);
- the fault "a step that returns its state unchanged": every frame of the
  window given the window's first tracked pose (``ate_share``);
- where the window closed a loop or the configuration's ``limits`` name
  ``loop_gap``: ``loop_gap`` of the program's keyframes, and of a run of
  the same seed under each of two faults, under ``"loop"``: "a loop found
  and counted but not corrected" (``LoopCloser._correct_loop`` a no-op, so
  the loop closer still records each loop it accepts), and "a loop
  corrected at its ends alone" (the Sim3 correction of the loop keyframe's
  group and the fuse kept, the essential graph and global BA no-ops), each
  with the loops and the lap's gap at each one (``per_loop``).

Prints one JSON line a seed, then one with each number's largest program
reading and smallest control and fault readings.  The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)


@contextlib.contextmanager
def patched(cls, **methods):
    """``cls``'s methods replaced for the block."""
    orig = {name: getattr(cls, name) for name in methods}
    for name, fn in methods.items():
        setattr(cls, name, fn)
    try:
        yield
    finally:
        for name, fn in orig.items():
            setattr(cls, name, fn)


def _skip(self, *a, **kw):
    return None


def loop_uncorrected():
    """The fault "a loop found and counted but not corrected": every
    ``LoopCloser`` skips the correction (the Sim3 pose write, the fuse, the
    essential graph, global BA) of the loops it accepts, and records them
    all the same."""
    from asdslam_torch.loop import loop_closing
    return patched(loop_closing.LoopCloser, _correct_loop=_skip)


def loop_ends_only():
    """The fault "a loop corrected at its ends alone": the loop keyframe and
    its covisible group are moved by the Sim3 and the loop's points fused,
    but the essential graph and global BA do nothing, so the rest of the lap
    keeps its drift."""
    from asdslam_torch.loop import loop_closing
    return patched(loop_closing.LoopCloser, _optimize_essential_graph=_skip,
                   _global_ba=_skip)


LOOP_FAULTS = {"fault_loop_uncorrected": loop_uncorrected,
               "fault_loop_ends_only": loop_ends_only}


def loop_readings(judged) -> dict:
    """A run's window: ``loop_gap`` on every keyframe's pose, the loops,
    and the gap at each loop alone."""
    import check
    j = judged
    return {"loop_gap": check.loop_gap(j["loops"], j["keyframes"], j["truth"]),
            "loops": [list(l) for l in j["loops"]],
            "per_loop": [check.loop_gap([l], j["keyframes"], j["truth"]) for l in j["loops"]]}


def readings(workload: str, seed: int, seconds: float, device: str = "cuda",
             slam_overrides=None, traffic_overrides=None, until_loop: bool = False,
             loop_faults=tuple(LOOP_FAULTS)) -> dict:
    import numpy as np

    import check
    import run

    def one():
        return run.run_cell(workload, seed, seconds, False, device=device,
                            slam_overrides=slam_overrides, traffic_overrides=traffic_overrides,
                            collect=True, until_loop=until_loop)

    out = one()
    j = out["judged"]
    dev = device
    still = np.repeat(j["est"][:1], len(j["est"]), axis=0)
    loop = None
    if j["loops"] or "loop_gap" in out["checks"]:
        loop = {"program": loop_readings(j)}
        for name in loop_faults:
            with LOOP_FAULTS[name]():
                loop[name] = loop_readings(one()["judged"])
    return {
        "seed": seed,
        "program": {k: v for k, (v, _lim) in out["checks"].items()},
        "control": {
            "desc_gap": check.desc_gap(j["samples"], j["weights"], j["slam"], dev, "fp8",
                                       program=False),
            "k1_gap": (check.k1_gap(j["launches"], dev, judged=check.k1_control)
                       if j["launches"] else math.inf),
        },
        "fault_state_unchanged": {"ate_share": check.ate_share(still, j["gt"])},
        "frames": out["line"]["attempted"], "tracked": len(j["tracked"]),
        "keyframes_judged": len(j["samples"]), "launches_judged": len(j["launches"]),
        "loop": loop,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--one", action="store_true", help="one seed in this process")
    p.add_argument("--log-dir", help="where each seed's standard error is written")
    args = p.parse_args(argv)
    if args.one:
        import run
        for var, path in run.CACHES.items():
            os.environ[var] = os.path.join(run.ROOT, path)
        print(json.dumps(readings(args.workload, args.seeds[0], args.seconds)), flush=True)
        return 0
    rows = []
    for seed in args.seeds:
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", "--workload",
                            args.workload, "--seconds", str(args.seconds), "--seeds", str(seed)],
                           capture_output=True, text=True)
        if args.log_dir:
            os.makedirs(args.log_dir, exist_ok=True)
            with open(os.path.join(args.log_dir, f"{args.workload}.{seed}.err"), "w") as f:
                f.write(r.stderr)
        if r.returncode != 0:
            print(r.stderr[-4000:], file=sys.stderr)
            return r.returncode
        rows.append(json.loads(r.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    summary = {
        "workload": args.workload, "seeds": args.seeds,
        "program_max": {k: max(r["program"][k] for r in rows) for k in rows[0]["program"]},
        "control_min": {k: min(r["control"][k] for r in rows) for k in rows[0]["control"]},
        "fault_min": {k: min(r["fault_state_unchanged"][k] for r in rows)
                      for k in rows[0]["fault_state_unchanged"]},
    }
    looped = [r["loop"] for r in rows if r["loop"] is not None]
    if looped:
        summary["loop"] = {"program_max": max(l["program"]["loop_gap"] for l in looped)}
        for name in LOOP_FAULTS:
            summary["loop"][name + "_min"] = min(l[name]["loop_gap"] for l in looped)
            # at the program's loop count: each window's first loop alone
            summary["loop"][name + "_first_loop_min"] = min(
                l[name]["per_loop"][0] if l[name]["per_loop"] else math.inf for l in looped)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
