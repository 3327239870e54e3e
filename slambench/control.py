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
  window given the window's first tracked pose (``ate_share``).

Prints one JSON line a seed, then one with each number's largest program
reading and smallest control and fault readings.  The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)


def readings(workload: str, seed: int, seconds: float, device: str = "cuda",
             slam_overrides=None, traffic_overrides=None) -> dict:
    import numpy as np

    import check
    import run

    out = run.run_cell(workload, seed, seconds, False, device=device,
                       slam_overrides=slam_overrides, traffic_overrides=traffic_overrides,
                       collect=True)
    j = out["judged"]
    dev = device
    still = np.repeat(j["est"][:1], len(j["est"]), axis=0)
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
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
