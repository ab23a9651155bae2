"""Accuracy regression gate: re-runs a short
oxford_sim window that CONTAINS the 10-12-32 revisit (GT frames 1200..2800
bracket the ~1423 -> ~2691 revisit pair) and fails loudly if drift, ATE, or
loop-closure behavior leaves the accepted band.  Run this on the GPU after
any change to the registration / loop / PGO path.

    python scripts/acceptance_gate.py            # gate (exit 1 on regression)
    python scripts/acceptance_gate.py --selftest # prove the gate turns red

The self-test breaks the loop acceptance gate (CS-divergence threshold -> 0,
so every loop is rejected) and asserts the gate FAILS — a gate that can't go
red is not a gate.
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Bands: ~3x the values measured on this window at the round-4 tuning
# (2026-08-20: odom 0.124 %, SLAM ATE 0.165 m, 31 loops, median loop error
# 0.033 m, 0 rejected frames) — loose enough for seed/compiler drift, tight
# enough that halved loop recall or +30% odometry drift trips them
#.
BANDS = {
    "odom_trans_err_pct_max": 0.4,
    "slam_ate_m_max": 1.0,
    "min_loop_closures": 16,  # > measured/2 = 15.5, so halved recall trips
    "loop_err_t_median_m_max": 0.3,
    "max_rejected_frames": 10,
}


def run_gate(extra_env=None):
    import oxford_sim

    if extra_env:
        os.environ.update(extra_env)
    out = tempfile.mkdtemp(prefix="acceptance_gate_")
    m = oxford_sim.main([
        "--seq", "10-12-32", "--start", "1200", "--frames", "1600",
        "--chunk", "200", "--output", out,
    ])
    failures = []
    if m["odom"]["trans_err_pct"] > BANDS["odom_trans_err_pct_max"]:
        failures.append(
            f"odometry drift {m['odom']['trans_err_pct']:.3f}% > "
            f"{BANDS['odom_trans_err_pct_max']}%")
    if m["slam"]["ate_m"] > BANDS["slam_ate_m_max"]:
        failures.append(
            f"SLAM ATE {m['slam']['ate_m']:.2f} m > {BANDS['slam_ate_m_max']} m")
    if m["n_loop_closures"] < BANDS["min_loop_closures"]:
        failures.append(
            f"loop closures {m['n_loop_closures']} < "
            f"{BANDS['min_loop_closures']}")
    if m.get("loop_err_t_median_m", 0.0) > BANDS["loop_err_t_median_m_max"]:
        failures.append(
            f"loop edge median error {m['loop_err_t_median_m']} m > "
            f"{BANDS['loop_err_t_median_m_max']} m")
    if m["rejected_frames"] > BANDS["max_rejected_frames"]:
        failures.append(
            f"rejected frames {m['rejected_frames']} > "
            f"{BANDS['max_rejected_frames']}")
    return m, failures


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--selftest", action="store_true")
    args = ap.parse_args()

    if args.selftest:
        # Break the loop gate: CS threshold 0 rejects every refined loop.
        # (config override honored by from_reference_yaml via env, see
        # config.py; fall back to monkeypatching the loaded config)
        import oxford_sim
        from randt_slam_tpu import config as CFG

        orig = CFG.from_reference_yaml

        def broken(path, **kw):
            cfg = orig(path, **kw)
            import dataclasses
            lf = dataclasses.replace(cfg.local_fuser,
                                     loop_closure_max_cs_divergence=0.0)
            return dataclasses.replace(cfg, local_fuser=lf)

        CFG.from_reference_yaml = broken
        oxford_sim.from_reference_yaml = broken
        m, failures = run_gate()
        if failures:
            print("SELFTEST OK — gate went red on a broken loop gate:")
            for f in failures:
                print("  ", f)
            sys.exit(0)
        print("SELFTEST FAILED — gate stayed green with loops disabled")
        sys.exit(1)

    m, failures = run_gate()
    if failures:
        print("ACCEPTANCE GATE FAILED:")
        for f in failures:
            print("  ", f)
        sys.exit(1)
    print("acceptance gate OK:",
          json.dumps({k: m[k] for k in
                      ("n_loop_closures", "rejected_frames")} |
                     {"slam_ate_m": m["slam"]["ate_m"],
                      "odom_trans_err_pct": m["odom"]["trans_err_pct"]}))


if __name__ == "__main__":
    main()
