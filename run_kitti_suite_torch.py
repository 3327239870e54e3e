#!/usr/bin/env python3
"""Run the port over the KITTI proxy suite (sequences 00-10) and build the
11-row ATE table next to BASELINE.md's.

The twin of run_kitti_suite.py: each sequence runs
eval_kitti_proxy_torch.py in its own subprocess (fresh device memory),
writing ATE_{tag}_seq{XX}.json next to this script (the tag defaults to
"torch", so the JAX runs' files are left alone), and ``--device`` is passed
through; the script then aggregates the markdown table.  Pass --voc_addr
to reuse one offline vocabulary across all sequences.  summarize_ate.py and
make_r05_table.py read the JSON files as they read the JAX script's.

Usage:
  python run_kitti_suite_torch.py --voc_addr voc.npz --tag torch
  python run_kitti_suite_torch.py --seqs 00,03 --max_frames 300   # smoke
"""

import argparse
import json
import os
import subprocess
import sys
import time

# ascending cost, headline first
DEFAULT_ORDER = ["00", "04", "03", "01", "06", "07", "10", "09", "05", "08", "02"]

REFERENCE_ATE = {  # BASELINE.md (real imagery: context, not comparison)
    "00": 7.52, "01": 208.16, "02": 22.48, "03": 1.07, "04": 0.84,
    "05": 3.40, "06": 7.76, "07": 1.59, "08": 52.40, "09": 7.17, "10": 7.15,
}


def make_table(rows):
    lines = ["| Seq | Frames | Tracked | KFs | Loops | frame ATE (m) |"
             " recomposed (m) | %path | KF ATE (m) | fps | fps_track |"
             " ref ASD (real imagery, m) |",
             "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        ate = r.get("ate_sim3_m", float("nan"))
        rca = r.get("ate_frame_recomposed_m", "-")
        kfa = r.get("ate_kf_sim3_m", "-")
        pl = r.get("path_length_m", 0) or 1
        # %path over the recomposed frame ATE where there is one (the
        # reference protocol's number), else over the live frame ATE
        pct = rca if isinstance(rca, float) else ate
        lines.append(
            f"| {r['seq']} | {r['frames']} | {r['tracked']} | {r['keyframes']}"
            f" | {r.get('loops_closed', 0)} | {ate} | {rca} |"
            f" {100.0 * pct / pl:.2f}% | {kfa} | {r.get('fps', 0)} |"
            f" {r.get('fps_tracking', '-')} |"
            f" {REFERENCE_ATE.get(r['seq'], '-')} |")
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--seqs", default=",".join(DEFAULT_ORDER))
    p.add_argument("--descriptor", default="patch")
    p.add_argument("--asdnet_weights", default="")
    p.add_argument("--voc_addr", default="")
    p.add_argument("--max_frames", type=int, default=0)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--tag", default="torch")
    p.add_argument("--out_md", default="")
    p.add_argument("--budget_s", type=float, default=0,
                   help="stop launching new sequences after this wall budget")
    p.add_argument("--per_seq_timeout_s", type=float, default=6000,
                   help="kill a sequence run exceeding this (suite proceeds)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    from asdslam_torch.system import require_device

    require_device(args.device)
    here = os.path.dirname(os.path.abspath(__file__))
    seqs = [s for s in args.seqs.split(",") if s]
    t0 = time.time()
    rows = []
    for seq in seqs:
        if args.budget_s and time.time() - t0 > args.budget_s:
            print(f"[suite] budget exhausted before seq {seq}", flush=True)
            break
        out = os.path.join(here, f"ATE_{args.tag}_seq{seq}.json")
        cmd = [sys.executable, os.path.join(here, "eval_kitti_proxy_torch.py"),
               "--seq", seq, "--scale", str(args.scale),
               "--descriptor", args.descriptor, "--out", out, "--device", args.device]
        if args.max_frames:
            cmd += ["--max_frames", str(args.max_frames)]
        if args.voc_addr:
            cmd += ["--voc_addr", args.voc_addr]
        if args.asdnet_weights:
            cmd += ["--asdnet_weights", args.asdnet_weights]
        print(f"[suite] seq {seq}: {' '.join(cmd)}", flush=True)
        t1 = time.time()
        try:
            rc = subprocess.run(cmd, timeout=args.per_seq_timeout_s).returncode
        except subprocess.TimeoutExpired:
            rc = "timeout"
        print(f"[suite] seq {seq} done rc={rc} {time.time() - t1:.0f}s", flush=True)
        if os.path.exists(out):
            with open(out) as f:
                rows.append(json.load(f))

    table = make_table(rows)
    print(table, flush=True)
    if args.out_md:
        with open(args.out_md, "w") as f:
            f.write(table + "\n")
    return rows


if __name__ == "__main__":
    main()
