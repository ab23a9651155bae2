"""Full-length acceptance sweep: all 8 Oxford sequences at full GT length
.  Runs ``oxford_sim`` per sequence (simulated returns
along the REAL GT route — raw radar is unfetchable here, OXFORD_RESULTS.md
§1), scores with the validated kitti_eval protocol, and writes one summary
JSON + per-sequence metrics under ``acceptance/``.

    python scripts/run_acceptance.py --outdir acceptance --tmp /tmp/acc_r3

Each sequence is run in a SUBPROCESS so a failure (OOM, saturation assert)
costs one sequence, not the sweep; metrics land incrementally so a partial
sweep is still evidence.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

SEQS = ["10-11-46", "10-12-32", "16-11-53", "16-13-09",
        "17-13-26", "18-14-14", "18-14-46", "18-15-20"]

REF_SLAM_ATE = {  # oxford_results/randt_eval_*/slam/est/result.txt:4
    "10-11-46": 5.29699, "10-12-32": 5.39495, "16-11-53": 10.35684,
    "16-13-09": 3.99550, "17-13-26": 5.88557, "18-14-14": 6.44629,
    "18-14-46": 6.27229, "18-15-20": 4.02929,
}


def _config_fingerprint() -> str:
    """Stable hash of the solver/gate fields that define the shipped
    operating point (so SUMMARY rows betray config drift)."""
    import hashlib

    sys.path.insert(0, REPO)
    sys.path.insert(0, HERE)
    from oxford_sim import shipped_config

    cfg = shipped_config()  # hash exactly what oxford_sim runs
    lf, mc, gf = cfg.local_fuser, cfg.matcher, cfg.global_fuser
    key = repr((lf.loop_odom_gate, lf.loop_odom_gate_rot_base_deg,
                lf.loop_odom_gate_rot_deg_per_100m,
                lf.loop_odom_gate_trans_base_m, lf.loop_odom_gate_trans_pct,
                lf.loop_closure_max_cs_divergence,
                mc.lm_function_tolerance, mc.lm_max_iterations,
                mc.gnc_steps, cfg.scan_context.dist_threshold,
                cfg.scan_context.num_candidates,
                cfg.scan_context.num_exclude_recent,
                gf.dcs_loop_defense, gf.dcs_scale))
    return hashlib.sha256(key.encode()).hexdigest()[:12]


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--outdir", default=os.path.join(REPO, "acceptance"))
    ap.add_argument("--tmp", default="/tmp/acc_r3")
    ap.add_argument("--frames", type=int, default=99999)
    ap.add_argument("--chunk", type=int, default=250)
    ap.add_argument("--seqs", default=",".join(SEQS))
    ap.add_argument("--ablate", default="")
    ap.add_argument("--suffix", default="")
    ap.add_argument("--gate-drift-scale", type=float, default=None,
                    help="pass through to oxford_sim (degraded-sensor gate "
                         "recalibration mitigation rows)")
    args = ap.parse_args()
    os.makedirs(args.outdir, exist_ok=True)

    # merge into an existing summary so partial re-runs refresh rows instead
    # of dropping the others
    summary = {}
    spath = os.path.join(args.outdir, f"SUMMARY{args.suffix}.json")
    if os.path.exists(spath):
        with open(spath) as f:
            summary = json.load(f)
    for seq in args.seqs.split(","):
        out = os.path.join(args.tmp, seq + args.suffix)
        t0 = time.time()
        cmd = [sys.executable, os.path.join(HERE, "oxford_sim.py"),
               "--seq", seq, "--frames", str(args.frames),
               "--chunk", str(args.chunk), "--output", out]
        if args.ablate:
            cmd += ["--ablate", args.ablate]
        if args.gate_drift_scale is not None:
            cmd += ["--gate-drift-scale", str(args.gate_drift_scale)]
        print(f"=== {seq}{args.suffix} ===", flush=True)
        r = subprocess.run(cmd, capture_output=True, text=True)
        wall = time.time() - t0
        if r.returncode != 0:
            print(f"{seq} FAILED ({wall:.0f}s):\n{r.stdout[-2000:]}\n"
                  f"{r.stderr[-4000:]}", flush=True)
            summary[seq] = {"error": r.returncode}
            with open(spath, "w") as f:
                json.dump(summary, f, indent=2)
            continue
        with open(os.path.join(out, "metrics.json")) as f:
            m = json.load(f)
        dst = os.path.join(args.outdir,
                           f"{seq}{args.suffix}_metrics.json")
        with open(dst, "w") as f:
            json.dump(m, f, indent=2)
        ok = m["slam"]["ate_m"] <= REF_SLAM_ATE[seq]
        # steady wall: the raw wall folds in compile time; the steady composite
        # (median odometry chunk x chunks + steady loop stages + pgo) is the
        # pipeline's own cost and is reported alongside, never instead.
        wall_steady = None
        try:
            tm = m.get("timings", {})
            cs = tm.get("odometry_chunk_seconds", [])
            ls = tm.get("loop_stages", {})
            if len(cs) >= 2:
                import statistics
                odo_steady = statistics.median(cs[1:]) * len(cs)
                loop_steady = (
                    ls.get("features_s", 0.0)
                    + ls.get("retrieval_steady_s", ls.get("retrieval_s", 0.0))
                    + ls.get("cand_features_s", 0.0)
                    + ls.get("refine_gate_steady_s",
                             ls.get("refine_gate_s", 0.0)))
                wall_steady = round(
                    odo_steady + loop_steady + tm.get("pgo_s", 0.0), 1)
        except Exception:
            pass
        summary[seq] = {
            "frames": m["frames"],
            "slam_ate_m": m["slam"]["ate_m"],
            "ref_slam_ate_m": REF_SLAM_ATE[seq],
            "beats_reference": bool(ok),
            "n_loops": m["n_loop_closures"],
            "wall_s": round(wall, 1),
            "wall_steady_s": wall_steady,
            # config provenance: every row written by this script runs the
            # shipped (gate-calibrated) configuration; the fingerprint makes
            # a later config drift visible in the artifact itself.  Gate-
            # recalibration mitigation rows are explicitly NOT the shipped
            # config and say so.
            "final_gate_config": args.gate_drift_scale is None,
            "config_fingerprint": _config_fingerprint(),
        }
        if args.gate_drift_scale is not None:
            summary[seq]["gate_drift_scale"] = args.gate_drift_scale
        print(json.dumps(summary[seq]), flush=True)
        with open(os.path.join(args.outdir,
                               f"SUMMARY{args.suffix}.json"), "w") as f:
            json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))


if __name__ == "__main__":
    main()
