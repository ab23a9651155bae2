"""Oxford-scale acceptance run on the REAL ground-truth trajectory.

The raw Oxford Radar RobotCar data is not fetchable in this environment (zero
egress), but the reference checks in the per-frame ground-truth trajectory of
every evaluation sequence (``oxford_results/randt_eval_*/odom/gt/01.txt``,
8609 poses at 4 Hz — real vehicle dynamics, real loop geometry).  This driver
gets as close to the acceptance run as the environment permits:

  1. load the real GT trajectory (sequence 10-12-32 by default) and take the
     first N frames (3000 by default — the route revisits frame ~1423's
     position at frame ~2691, so the window contains genuine loop closures),
  2. place a synthetic scatterer world along the real route and render
     Navtech-geometry polar scans (400 azimuths, 8.64 cm bins to 100 m, the
     same grid ``io/oxford.py`` produces from real PNGs at downsample 2),
  3. run the FULL pipeline configured from the reference's own
     ``parameters_oxford.yaml`` (114x114-cell NDT maps, ScanContext loops,
     final PGO),
  4. score odometry and SLAM with the validated ``io/kitti_eval`` pipeline
     (the same protocol as every BASELINE.md number).

Usage:
    python scripts/oxford_sim.py --frames 3000 --output /tmp/oxford_sim
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REF_GT = ("/root/reference/oxford_results/randt_eval_{seq}/odom/gt/01.txt")
REF_YAML = ("/root/reference/ros/ndt_radar_slam/config/parameters_oxford.yaml")

N_AZIMUTHS = 400
BIN_WIDTH = 0.0432 * 2          # io/oxford.py downsample_bins=2 grid
MAX_RANGE = 100.0               # parameters_oxford.yaml radar_preprocessor
DT = 0.25                       # 4 Hz Navtech frame rate


# Sensor-fidelity ablation presets: each maps to
# render_scan_fast kwargs.  "saturation" caps at ~the strongest facade power
# (Navtech uint8 clipping), "multipath" spawns double-bounce ghosts on 15% of
# returns, "jitter" adds 0.3 deg azimuth encoder noise (>1/3 of the 0.9 deg
# beam spacing).
ABLATIONS = {
    "saturation": {"saturate_at": 140.0},
    "multipath": {"multipath_ghost_prob": 0.15},
    "jitter": {"azimuth_jitter_deg": 0.3},
    # Combined REALISTIC sensor profile: what a real
    # Navtech plausibly does all at once, milder than the single-axis STRESS
    # ablations above — uint8 quantization (always on in this driver),
    # calibrated saturation, 0.1 deg encoder jitter (vs 0.3 stress), 5%
    # multipath ghosts (vs 15% stress).  Run as a second headline table next
    # to the clean one (acceptance/SUMMARY_realistic.json).
    "realistic": {"saturate_at": 140.0, "azimuth_jitter_deg": 0.1,
                  "multipath_ghost_prob": 0.05},
}


def shipped_config(no_dcs_defense: bool = False):
    """The SHIPPED acceptance configuration: the reference's own Oxford YAML
    plus the calibrated operating point (num_exclude_recent=50
    from the round-4 recall sweep; the DCS two-stage loop defense is the
    config default).  Factored out so run_acceptance's config fingerprint
    hashes exactly what this driver runs."""
    import dataclasses as _dc

    from randt_slam_tpu.config import from_reference_yaml

    cfg = from_reference_yaml(REF_YAML)
    cfg = cfg.replace(scan_context=_dc.replace(
        cfg.scan_context, num_exclude_recent=50))
    if no_dcs_defense:
        cfg = cfg.replace(global_fuser=_dc.replace(
            cfg.global_fuser, dcs_loop_defense=False))
    return cfg


def build_world_and_scans(gt_poses, seed=0, n_walls_per_km=300,
                          corridor=50.0, log=print, render_kwargs=None):
    from randt_slam_tpu.io import synthetic as S

    rng = np.random.default_rng(seed)
    steps = np.linalg.norm(np.diff(gt_poses[:, :2], axis=0), axis=1)
    path_len = steps.sum()
    n_walls = max(40, int(n_walls_per_km * path_len / 1000.0))
    # World anchors must be uniform in ARC LENGTH: make_world samples
    # trajectory rows uniformly, which would thin the world out exactly where
    # the car drives fast (density ~ 1/speed) — resample the route at 1 m
    # spacing first.
    cum = np.concatenate([[0.0], np.cumsum(steps)])
    arc = np.arange(0.0, path_len, 1.0)
    resampled = np.stack([
        np.interp(arc, cum, gt_poses[:, 0]),
        np.interp(arc, cum, gt_poses[:, 1]),
        np.zeros_like(arc),
    ], axis=1).astype(np.float32)
    landmarks = S.make_world(
        rng, trajectory=resampled, n_walls=n_walls, corridor=corridor,
        n_clutter=n_walls * 2,
    )
    log(f"world: {len(landmarks)} scatterers over {path_len:.0f} m "
        f"({n_walls} walls)")

    azimuths = (np.arange(N_AZIMUTHS) / N_AZIMUTHS * 2 * np.pi - np.pi
                ).astype(np.float32)
    n_bins = int(MAX_RANGE / BIN_WIDTH)
    ranges = ((np.arange(n_bins) + 0.5) * BIN_WIDTH).astype(np.float32)

    T = len(gt_poses)
    render_kwargs = render_kwargs or {}
    # uint8 transport: the real Navtech sensor quantizes return power to
    # uint8, so this is the realistic precision — and it quarters host RAM
    # and the host->device upload that bounds offline replay throughput.
    scans = np.empty((T, N_AZIMUTHS, n_bins), np.uint8)
    t0 = time.perf_counter()
    for t in range(T):
        p = gt_poses[t]
        near = (np.abs(landmarks[:, 0] - p[0]) < MAX_RANGE + 5) & (
            np.abs(landmarks[:, 1] - p[1]) < MAX_RANGE + 5)
        scans[t] = np.clip(S.render_scan_fast(
            p, landmarks[near], azimuths, ranges, rng, **render_kwargs
        ), 0.0, 255.0).astype(np.uint8)
        if t % 500 == 499:
            log(f"rendered {t + 1}/{T} frames "
                f"({(time.perf_counter() - t0) / (t + 1) * 1000:.0f} ms/frame)")
    return scans, azimuths, ranges


def recall_diagnostics(cfg, gt, odo, loops, opp_radius=7.5):
    """Loop RECALL vs ground truth: a query keyframe has
    a genuine revisit opportunity if some earlier foreign-submap keyframe's
    GT position lies within ``opp_radius`` and at least
    ``num_exclude_recent`` keyframes back.  Break every opportunity down by
    what the detector did with it."""
    qn = loops.query_node
    gt_nodes = gt[np.asarray(odo.node_frame)]
    nsub = np.asarray(odo.node_submap)
    d2 = np.linalg.norm(
        gt_nodes[qn][:, None, :2] - gt_nodes[None, :, :2], axis=-1)
    exclude = cfg.scan_context.num_exclude_recent
    elig = (np.arange(len(gt_nodes))[None, :] <= qn[:, None] - exclude)
    elig &= nsub[None, :] != nsub[qn][:, None]
    has_opp = ((d2 < opp_radius) & elig).any(axis=1)
    stages = loops.query_stage[has_opp]
    return {
        "revisit_opportunities": int(has_opp.sum()),
        "opp_no_candidate": int((stages == 0).sum()),
        "opp_same_submap": int((stages == 1).sum()),
        "opp_cs_rejected": int((stages == 2).sum()),
        "opp_accepted": int((stages == 3).sum()),
        "false_candidates": int(((loops.query_stage >= 2) & ~has_opp).sum()),
    }


def loop_edge_errors(gt, odo, loops):
    """Per accepted loop edge (root r -> query q): translation / rotation
    error of the claimed relative SE(2) vs gt_r^-1 * gt_q."""
    import jax.numpy as jnp

    from randt_slam_tpu.geometry import compose, inverse

    lb = loops.edge_begin
    le = loops.edge_end
    g_r = gt[np.asarray(odo.node_frame)[lb]]
    g_q = gt[np.asarray(odo.node_frame)[le]]
    rel_gt = np.asarray(compose(inverse(jnp.asarray(g_r)), jnp.asarray(g_q)))
    err_t = np.linalg.norm(loops.edge_trans[:, :2] - rel_gt[:, :2], axis=1)
    err_r = np.abs(np.arctan2(
        np.sin(loops.edge_trans[:, 2] - rel_gt[:, 2]),
        np.cos(loops.edge_trans[:, 2] - rel_gt[:, 2])))
    return rel_gt, err_t, err_r


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seq", default="10-12-32")
    ap.add_argument("--start", type=int, default=0,
                    help="first GT frame of the window (e.g. --start 1200 "
                         "--frames 1600 brackets 10-12-32's revisit pair "
                         "~1423/~2691)")
    ap.add_argument("--frames", type=int, default=3000)
    ap.add_argument("--output", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=250)
    ap.add_argument("--odometry-only", action="store_true")
    ap.add_argument("--online", action="store_true",
                    help="cadence-faithful replay through OnlineSlam: loop "
                         "search + PGO + submap re-anchoring DURING the run "
                         "(the reference's online timers), one final PGO at "
                         "the end.  The reference's own "
                         "offline mode (ndt_slam.cpp:124,176) searches loops "
                         "per frame but optimizes once at bag end — the "
                         "default batch path here matches that; --online "
                         "adds the mid-run feedback of the live system.")
    ap.add_argument("--loop-every", type=int, default=5,
                    help="--online: loop-search cadence in frames (0.8 Hz "
                         "timer at 4 Hz radar)")
    ap.add_argument("--pgo-every", type=int, default=20,
                    help="--online: PGO cadence in frames (0.2 Hz timer)")
    ap.add_argument("--ablate", default="",
                    help="comma-separated sensor ablations: "
                         + ",".join(ABLATIONS))
    ap.add_argument("--robust-kernel", default=None,
                    choices=["huber", "dcs"],
                    help="override the PGO robust kernel (DCS evidence runs"
                         " — see GlobalFuserConfig.robust_kernel)")
    ap.add_argument("--robust-two-stage", action="store_true",
                    help="enable the two-stage robust PGO schedule")
    ap.add_argument("--no-dcs-defense", action="store_true",
                    help="disable the shipped DCS two-stage loop defense "
                         "(GlobalFuserConfig.dcs_loop_defense) for A/B runs")
    ap.add_argument("--gate-drift-scale", type=float, default=None,
                    help="scale the loop odometry-consistency gate's drift "
                         "envelope (loop_odom_gate_trans_pct AND "
                         "loop_odom_gate_rot_deg_per_100m) by this factor — "
                         "the documented mitigation for degraded sensors "
                         "whose odometry drift exceeds the clean-sim "
                         "calibration (realistic-profile failures); the DCS "
                         "two-stage defense covers the extra bad-edge risk")
    args = ap.parse_args(argv)
    os.makedirs(args.output, exist_ok=True)

    from randt_slam_tpu.config import from_reference_yaml
    from randt_slam_tpu.io import formats, kitti_eval as KE
    from randt_slam_tpu.pipeline import slam

    gt44 = KE.load_kitti_poses(REF_GT.format(seq=args.seq))[
        args.start:args.start + args.frames]
    gt = np.stack([gt44[:, 0, 3], gt44[:, 1, 3],
                   np.arctan2(gt44[:, 1, 0], gt44[:, 0, 0])], 1).astype(np.float32)
    render_kwargs = {}
    for name in filter(None, args.ablate.split(",")):
        render_kwargs.update(ABLATIONS[name])
    scans, azimuths, ranges = build_world_and_scans(
        gt, seed=args.seed, render_kwargs=render_kwargs)
    stamps = (np.arange(len(gt)) * DT).astype(np.float32)

    cfg = shipped_config(no_dcs_defense=args.no_dcs_defense)
    import dataclasses as _dc

    if args.robust_kernel or args.robust_two_stage:
        gf = cfg.global_fuser
        if args.robust_kernel:
            gf = _dc.replace(gf, robust_kernel=args.robust_kernel)
        if args.robust_two_stage:
            gf = _dc.replace(gf, robust_two_stage=True)
        cfg = cfg.replace(global_fuser=gf)
    if args.gate_drift_scale is not None:
        lf = cfg.local_fuser
        cfg = cfg.replace(local_fuser=_dc.replace(
            lf,
            loop_odom_gate_trans_pct=(lf.loop_odom_gate_trans_pct
                                      * args.gate_drift_scale),
            loop_odom_gate_rot_deg_per_100m=(
                lf.loop_odom_gate_rot_deg_per_100m * args.gate_drift_scale)))
    # frames stay on host as float16 (renders are f16 already); run_odometry
    # uploads per chunk and the front end upcasts on device — halves the
    # host->device transfer that bounds offline replay throughput
    frames = slam.frames_from_arrays(scans, azimuths, ranges, stamps,
                                     host=True)

    t0 = time.perf_counter()
    res = None
    if args.odometry_only:
        odo = slam.run_odometry(cfg, frames, chunk=args.chunk)
        node_pose = odo.node_pose
        node_frame = odo.node_frame
        timings = {}
        n_loops = 0
        odom = odo.odom_poses
    elif args.online:
        import jax
        import jax.numpy as jnp

        from randt_slam_tpu.pipeline.online import OnlineSlam

        eng = OnlineSlam(cfg, loop_every=args.loop_every,
                         pgo_every=args.pgo_every)
        T = len(gt)
        t_first = None
        frame_walls = []
        for t in range(T):
            t_f = time.perf_counter()
            fr = jax.tree.map(lambda x: jnp.asarray(x[t]), frames)
            eng.process_frame(fr)
            frame_walls.append(time.perf_counter() - t_f)
            if t == 0:
                t_first = time.perf_counter() - t0
            if t % 500 == 499:
                print(f"online {t + 1}/{T} frames "
                      f"({(time.perf_counter() - t0) / (t + 1) * 1e3:.0f} "
                      f"ms/frame)", flush=True)
        eng.finalize()
        odom = np.stack(eng.odom_trace)
        node_pose = eng.trajectory()
        node_frame = np.asarray(eng.node_frame)
        n_loops = eng.n_loop_edges
        # steady per-frame stats exclude the first 200 frames (compile
        # window); the 4 Hz sensor budget is 0.25 s/frame
        fw = np.asarray(frame_walls[200:] if T > 400 else frame_walls)
        timings = {"mode": "online", "first_frame_s": round(t_first, 1),
                   "loop_every": args.loop_every,
                   "pgo_every": args.pgo_every,
                   "frame_ms_median_steady": round(
                       float(np.median(fw)) * 1e3, 1),
                   "frame_ms_p90_steady": round(
                       float(np.percentile(fw, 90)) * 1e3, 1),
                   "frame_ms_max_steady": round(float(fw.max()) * 1e3, 1),
                   "realtime_4hz_ok": bool(np.median(fw) <= 0.25),
                   "frames_over_budget_pct": round(
                       float((fw > 0.25).mean() * 100.0), 2),
                   # per-stage medians (and worst PGO tick) from the engine
                   "stage_ms_median": {
                       k: round(float(np.median(v)) * 1e3, 1)
                       for k, v in eng.stage_walls.items() if v},
                   "stage_ms_max": {
                       k: round(float(np.max(v)) * 1e3, 1)
                       for k, v in eng.stage_walls.items() if v}}

        class _O:  # minimal OdometryResult view for the shared tail
            pass

        odo = _O()
        odo.odom_poses = odom
        odo.node_pose = node_pose
        odo.node_frame = node_frame
        odo.node_submap = np.asarray(eng.node_submap)
        odo.node_traversed = np.asarray(eng.node_traversed)
        odo.rejected_frames = np.asarray(eng.rejected_trace, bool)
        odo.saturation = {}
        odo.chunk_seconds = np.zeros(0)
    else:
        res = slam.run_slam(cfg, frames, use_scan=True, chunk=args.chunk)
        odo = res.odometry
        odom = odo.odom_poses
        node_pose = res.node_pose_optimized
        node_frame = res.node_frame
        timings = dict(res.timings)
        timings["loop_stages"] = getattr(res.loops, "timings", {})
        n_loops = res.loops.n_accepted
    wall = time.perf_counter() - t0

    recall_diag = {}
    if res is not None and len(res.loops.query_node):
        recall_diag = recall_diagnostics(cfg, gt, odo, res.loops)

    # Loop-edge quality vs ground truth: each accepted edge (root r -> query
    # q) claims the relative SE(2) trans; compare against gt_r^-1 * gt_q.
    loop_diag = {}
    if res is not None and n_loops:
        lb = res.loops.edge_begin
        le = res.loops.edge_end
        rel_gt, err_t, err_r = loop_edge_errors(gt, odo, res.loops)
        np.savez(os.path.join(args.output, "loops.npz"),
                 edge_begin=lb, edge_end=le, trans=res.loops.edge_trans,
                 rel_gt=rel_gt, err_t=err_t, err_r=err_r,
                 cs=res.loops.cs_divergences,
                 node_pose_odom=np.asarray(odo.node_pose),
                 node_traversed=np.asarray(odo.node_traversed))
        # Full pose-graph dump for offline PGO experiments (solver/kernel
        # sweeps without replaying the 10-minute pipeline).
        np.savez(os.path.join(args.output, "graph.npz"),
                 odo_begin=odo.edge_begin, odo_end=odo.edge_end,
                 odo_trans=odo.edge_trans,
                 odo_sqrt_info=odo.edge_sqrt_information,
                 loop_begin=lb, loop_end=le,
                 loop_trans=res.loops.edge_trans,
                 loop_sqrt_info=res.loops.edge_sqrt_information,
                 node_pose_odom=np.asarray(odo.node_pose),
                 node_submap=np.asarray(odo.node_submap),
                 node_is_root=np.asarray(odo.node_is_root),
                 node_frame=np.asarray(odo.node_frame),
                 node_pose_opt=node_pose, rel_gt=rel_gt)
        loop_diag = {
            "loop_err_t_median_m": round(float(np.median(err_t)), 3),
            "loop_err_t_max_m": round(float(err_t.max()), 2),
            "loops_worse_1m": int((err_t > 1.0).sum()),
            "loops_worse_5m": int((err_t > 5.0).sum()),
        }

    ev_odom = KE.evaluate(KE.poses_from_se2(gt), KE.poses_from_se2(odom))
    ev_slam = KE.evaluate(KE.poses_from_se2(gt[node_frame]),
                          KE.poses_from_se2(node_pose))
    # compile-separated throughput: chunk 0 carries the XLA compile
    cs = np.asarray(odo.chunk_seconds)
    if len(cs) > 1:
        steady = float(np.median(cs[1:]))
        timings = dict(timings)
        timings["odometry_first_chunk_s"] = round(float(cs[0]), 2)
        timings["odometry_steady_chunk_s"] = round(steady, 2)
        timings["odometry_steady_fps"] = round(args.chunk / steady, 1)
        timings["odometry_chunk_seconds"] = [round(float(x), 2) for x in cs]

    metrics = {
        "sequence": args.seq,
        "ablate": args.ablate,
        "frames": int(len(gt)),
        "wall_s": round(wall, 1),
        "frames_per_second": round(len(gt) / wall, 2),
        "n_nodes": int(len(node_pose)),
        "n_loop_closures": int(n_loops),
        "n_odom_gate_rejected": (int(res.loops.n_odom_gate_rejected)
                                 if res is not None else 0),
        "n_sc_candidates": (int(res.loops.n_sc_candidates)
                            if res is not None else 0),
        "rejected_frames": int(np.asarray(odo.rejected_frames).sum()),
        "saturation": odo.saturation,
        "odom": {k: round(v, 5) for k, v in ev_odom.items()},
        "slam": {k: round(v, 5) for k, v in ev_slam.items()},
        "timings": timings,
        **recall_diag,
        **loop_diag,
    }
    with open(os.path.join(args.output, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    formats.write_kitti(os.path.join(args.output, "odom_kitti.txt"), odom)
    formats.write_kitti(os.path.join(args.output, "slam_kitti.txt"), node_pose)
    formats.write_kitti(os.path.join(args.output, "gt_kitti.txt"), gt)
    print(json.dumps(metrics, indent=2))
    return metrics


if __name__ == "__main__":
    main()
