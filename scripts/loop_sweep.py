"""Loop-recall sensitivity sweep.

Runs odometry ONCE on the 10-12-32 revisit window, then re-runs ONLY the
loop pass (ScanContext retrieval + refinement + gates — cheap now that the
detector reuses stored descriptors) over a grid of
``dist_threshold`` x ``num_candidates`` x ``num_exclude_recent``, scoring
each operating point's recall / false-candidate / accepted-edge-quality
against ground truth.  The output table justifies the shipped operating
point vs the reference's ``SC_DIST_THRES`` semantics
(``Scancontext.cpp:330-339``: candidates under the threshold accepted,
nearest-of-10 ring-key candidates).

    python scripts/loop_sweep.py --output /tmp/loop_sweep [--frames 1600]
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import oxford_sim as OS


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seq", default="10-12-32")
    ap.add_argument("--start", type=int, default=1200)
    ap.add_argument("--frames", type=int, default=1600)
    ap.add_argument("--chunk", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--output", required=True)
    ap.add_argument("--thresholds", default="0.5,0.6,0.7,0.8")
    ap.add_argument("--candidates", default="5,10,20")
    ap.add_argument("--exclude", default="50,100,200")
    args = ap.parse_args(argv)
    os.makedirs(args.output, exist_ok=True)

    from randt_slam_tpu.config import from_reference_yaml
    from randt_slam_tpu.io import kitti_eval as KE
    from randt_slam_tpu.loops import detector
    from randt_slam_tpu.pipeline import slam

    gt44 = KE.load_kitti_poses(OS.REF_GT.format(seq=args.seq))[
        args.start:args.start + args.frames]
    gt = np.stack([gt44[:, 0, 3], gt44[:, 1, 3],
                   np.arctan2(gt44[:, 1, 0], gt44[:, 0, 0])], 1).astype(
        np.float32)
    scans, azimuths, ranges = OS.build_world_and_scans(gt, seed=args.seed)
    stamps = (np.arange(len(gt)) * OS.DT).astype(np.float32)

    cfg0 = from_reference_yaml(OS.REF_YAML)
    frames = slam.frames_from_arrays(scans, azimuths, ranges, stamps,
                                     host=True)
    print("odometry pass (once)...", flush=True)
    odo = slam.run_odometry(cfg0, frames, chunk=args.chunk)

    base_sc = cfg0.scan_context
    rows = []
    grid = [(t, c, e)
            for t in map(float, args.thresholds.split(","))
            for c in map(int, args.candidates.split(","))
            for e in map(int, args.exclude.split(","))]
    # mark the shipped operating point even if off-grid
    shipped = (base_sc.dist_threshold, base_sc.num_candidates,
               base_sc.num_exclude_recent)
    if shipped not in grid:
        grid.append(shipped)
    for t, c, e in grid:
        cfg = cfg0.replace(scan_context=dataclasses.replace(
            base_sc, dist_threshold=t, num_candidates=c,
            num_exclude_recent=e))
        t0 = time.perf_counter()
        loops = detector.detect_loops(cfg, odo, frames)
        wall = time.perf_counter() - t0
        diag = OS.recall_diagnostics(cfg, gt, odo, loops)
        row = {
            "dist_threshold": t, "num_candidates": c,
            "num_exclude_recent": e,
            "shipped": (t, c, e) == shipped,
            "n_sc_candidates": loops.n_sc_candidates,
            "n_accepted": loops.n_accepted,
            "n_odom_gate_rejected": loops.n_odom_gate_rejected,
            "wall_s": round(wall, 1),
            **diag,
        }
        opp = max(diag.get("revisit_opportunities", 0), 1)
        row["recall_pct"] = round(100.0 * diag["opp_accepted"] / opp, 1)
        if loops.n_accepted:
            _, err_t, _ = OS.loop_edge_errors(gt, odo, loops)
            row["loop_err_t_median_m"] = round(float(np.median(err_t)), 3)
            row["loop_err_t_max_m"] = round(float(err_t.max()), 2)
            row["loops_worse_1m"] = int((err_t > 1.0).sum())
        print(json.dumps(row), flush=True)
        rows.append(row)

    out = {
        "sequence": args.seq, "start": args.start, "frames": args.frames,
        "shipped_operating_point": {
            "dist_threshold": shipped[0], "num_candidates": shipped[1],
            "num_exclude_recent": shipped[2]},
        "rows": rows,
    }
    with open(os.path.join(args.output, "loop_sweep.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {args.output}/loop_sweep.json ({len(rows)} points)")
    return out


if __name__ == "__main__":
    main()
