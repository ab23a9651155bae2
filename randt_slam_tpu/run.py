"""Command-line SLAM driver — the ``ndt_slam_node`` equivalent, ROS-free.

Offline deterministic replay (the mode behind the reference's published
results, ``NDTSlam::initializeOffline``) over a converted ``.npz`` sequence
or a synthetic world, with trajectory/metric/OGM exports in the formats the
reference's external evaluation pipeline consumes (TUM + KITTI,
``oxford-dataset.md:71-103``).

Usage:
    python -m randt_slam_tpu.run --input synthetic --frames 130 --loop \
        --output /tmp/run1
    python -m randt_slam_tpu.run --input seq.npz --config oxford \
        --ref-yaml path/a.yaml path/b.yaml --output outdir --ogm
"""

from __future__ import annotations

import argparse
import json
import os
import time


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", required=True,
                   help="'synthetic' or path to a converted .npz sequence")
    p.add_argument("--config", default="oxford",
                   choices=["oxford", "indoor", "synthetic"],
                   help="configuration preset")
    p.add_argument("--ref-yaml", nargs="*", default=None,
                   help="reference-style layered YAML files (override preset)")
    p.add_argument("--output", required=True, help="output directory")
    p.add_argument("--frames", type=int, default=None, help="frame cap")
    p.add_argument("--odometry-only", action="store_true",
                   help="skip loop closure + pose-graph optimization")
    p.add_argument("--online", action="store_true",
                   help="incremental mode with mid-run PGO feedback")
    p.add_argument("--ogm", action="store_true", help="render the global OGM")
    p.add_argument("--render", action="store_true",
                   help="write map.png — the RViz view offline: OGM backdrop"
                        " (with --ogm), NDT covariance ellipses, odometry +"
                        " optimized trajectory")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--loop", action="store_true",
                   help="synthetic: closed-loop trajectory")
    p.add_argument("--python-loop", action="store_true",
                   help="drive frames with a Python loop instead of lax.scan")
    p.add_argument("--viz-every", type=int, default=0,
                   help="--online: every N frames overwrite live/ with the "
                        "current map view (RViz-stream equivalent; 0 = off)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file; online: saved every "
                        "--checkpoint-every frames, offline: final carry")
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--resume", default=None,
                   help="resume an --online run from a checkpoint file")
    p.add_argument("--export-ndt", action="store_true",
                   help="export the final submap's NDT cells "
                        "(NormalDistributions-equivalent npz)")
    return p


def load_config(args):
    from . import config as CFG

    if args.ref_yaml:
        return CFG.from_reference_yaml(*args.ref_yaml)
    if args.config == "oxford":
        return CFG.oxford_config()
    if args.config == "indoor":
        return CFG.indoor_config()
    return CFG.synthetic_config()


def load_frames(args, cfg):
    import numpy as np

    from .io import oxford, synthetic
    from .pipeline import slam

    if args.input == "synthetic":
        seq = synthetic.generate(
            seed=args.seed, n_frames=args.frames or 120, n_azimuths=256,
            n_bins=256, loop=args.loop,
        )
        frames = slam.frames_from_arrays(
            seq.intensity, seq.azimuths, seq.ranges, seq.stamps,
            imu_yaw=seq.imu_yaw,
        )
        return frames, seq.gt_poses, seq.stamps
    seq = oxford.load_npz_sequence(args.input, max_frames=args.frames)
    frames = slam.frames_from_arrays(
        seq.intensity, seq.azimuths, seq.ranges, seq.stamps,
        imu_yaw=getattr(seq, "imu_yaw", None),
    )
    return frames, seq.gt_poses, seq.stamps


def export_live_view(output: str, cfg, engine, with_ogm: bool = False):
    """Periodic online visualization export — the live-stream equivalent of
    the reference's RViz publishers (``rviz_visualization.cpp:13-18`` streams
    NDT markers + OGM continuously on ROS topics).  ROS-free here: overwrite
    ``live/{map.png, ndt_submap.npz, trajectory.json[, ogm.pgm]}`` with the
    CURRENT engine state, so an external viewer polling the directory watches
    the run evolve mid-flight instead of only seeing end-of-run artifacts
."""
    import jax.numpy as jnp
    import numpy as np

    from .io import viz
    from .ndt import grid as G
    from .registration.matcher import transform_mean_cov

    live = os.path.join(output, "live")
    os.makedirs(live, exist_ok=True)
    carry = engine.carry
    mu, cov, valid = G.derive_sparse_fields(
        carry.submap, cfg.ndt_map.min_points_per_cell, cfg.ndt_map.cell)
    mu_w, cov_w = transform_mean_cov(
        jnp.asarray(carry.submap_origin), mu, cov)
    mu_w, cov_w, valid = (np.asarray(mu_w), np.asarray(cov_w),
                          np.asarray(valid))
    viz.export_normal_distributions(
        os.path.join(live, "ndt_submap.npz"), mu_w, cov_w, valid)
    ogm_grid = extent = None
    if with_ogm and cfg.visualize_ogm and engine._count_grids:
        ogm_grid = engine.render_ogm()
        viz.write_pgm(os.path.join(live, "ogm.pgm"), ogm_grid)
        o = cfg.ogm
        extent = (-0.5 * o.size_x * o.resolution,
                  0.5 * o.size_x * o.resolution,
                  -0.5 * o.size_y * o.resolution,
                  0.5 * o.size_y * o.resolution)
    node_pose = engine.trajectory()
    odom = (np.stack(engine.odom_trace) if engine.odom_trace
            else np.zeros((0, 3), np.float32))
    viz.export_trajectory_json(
        os.path.join(live, "trajectory.json"),
        np.asarray(engine.node_stamp), node_pose)
    viz.render_map_png(
        os.path.join(live, "map.png"), node_pose=node_pose, odom=odom,
        ndt_mean=mu_w, ndt_cov=cov_w, ndt_valid=valid,
        ogm=ogm_grid, ogm_extent=extent,
        title=f"online frame {len(odom)} — {engine.n_loop_edges} loops")


def main(argv=None):
    args = build_parser().parse_args(argv)
    os.makedirs(args.output, exist_ok=True)

    # Multi-host entry (BASELINE config 5): a no-op unless the launcher set
    # RANDT_COORDINATOR/RANDT_NUM_PROCESSES/RANDT_PROCESS_ID — after which
    # jax.devices() spans every host and the sharded paths span them too.
    # MUST run before any backend-touching import (jax.distributed rule).
    from .parallel.mesh import init_distributed

    if init_distributed():
        import jax

        print(f"distributed: process {jax.process_index()}/"
              f"{jax.process_count()}, {jax.device_count()} devices")

    import numpy as np

    from .io import formats, viz
    from .pipeline import slam
    from .utils.profiling import Profiler

    cfg = load_config(args)
    frames, gt_poses, stamps = load_frames(args, cfg)
    prof = Profiler()
    t0 = time.perf_counter()

    final_carry = None
    ogm_grid = None
    if args.online:
        import jax
        from .pipeline.online import OnlineSlam

        engine = OnlineSlam(cfg)
        start = 0
        if args.resume:
            engine.load_checkpoint(args.resume)
            start = engine._frame_count
        T = int(frames.stamp.shape[0])
        with prof.stage("online_total"):
            for t in range(start, T):
                fr = jax.tree.map(lambda x: x[t], frames)
                engine.process_frame(fr)
                if (args.checkpoint
                        and (t + 1) % args.checkpoint_every == 0):
                    engine.save_checkpoint(args.checkpoint)
                if args.viz_every and (t + 1) % args.viz_every == 0:
                    with prof.stage("online_viz"):
                        export_live_view(args.output, cfg, engine,
                                         with_ogm=args.ogm)
        # bag-end semantics (``ndt_slam.cpp:176-178``): drain the pending
        # loop queue, one final PGO over every edge + re-anchoring
        with prof.stage("online_finalize"):
            engine.finalize()
        if args.checkpoint:
            engine.save_checkpoint(args.checkpoint)
        final_carry = engine.carry
        if args.ogm and cfg.visualize_ogm:
            ogm_grid = engine.render_ogm()
            viz.write_pgm(os.path.join(args.output, "ogm.pgm"), ogm_grid)
        odom = np.stack(engine.odom_trace)
        node_pose = engine.trajectory()
        node_stamp = np.asarray(engine.node_stamp)
        node_frame = np.asarray(engine.node_frame, int)
        n_loops = engine.n_loop_edges
    elif args.odometry_only:
        with prof.stage("odometry"):
            res = slam.run_odometry(cfg, frames,
                                    use_scan=not args.python_loop)
        odom = res.odom_poses
        node_pose = res.node_pose
        node_stamp = res.node_stamp
        node_frame = res.node_frame
        n_loops = 0
        final_carry = res.final_carry
    else:
        with prof.stage("slam_total"):
            res = slam.run_slam(cfg, frames, use_scan=not args.python_loop)
        odom = res.odometry.odom_poses
        node_pose = res.node_pose_optimized
        node_stamp = res.node_stamp
        node_frame = res.node_frame
        n_loops = res.loops.n_accepted
        final_carry = res.odometry.final_carry
        for k, v in res.timings.items():
            if isinstance(v, (int, float)):  # skip tags like pgo_solver
                prof.stages[f"slam.{k}"].add(v)
        if args.ogm:
            with prof.stage("ogm"):
                ogm_grid, _ = slam.render_ogm(cfg, res, frames)
            viz.write_pgm(os.path.join(args.output, "ogm.pgm"), ogm_grid)

    wall = time.perf_counter() - t0
    T = len(odom)

    if args.checkpoint and not args.online and final_carry is not None:
        from .utils import checkpoint as CK

        CK.save_carry(args.checkpoint, final_carry)
    if args.export_ndt and final_carry is not None:
        # NormalDistributions-equivalent export of the active submap's cells
        # (``/aligned_normal_distribution`` topic, ndt_msgs wire format).
        from .ndt import grid as G

        mu, cov, valid = G.derive_sparse_fields(
            final_carry.submap, cfg.ndt_map.min_points_per_cell,
            cfg.ndt_map.cell)
        viz.export_normal_distributions(
            os.path.join(args.output, "ndt_submap.npz"),
            np.asarray(mu), np.asarray(cov), np.asarray(valid))
    if args.render:
        # RViz-equivalent snapshot (``rviz_visualization.cpp:21-80``): OGM
        # backdrop + active-submap NDT ellipses (world frame) + trajectories.
        ndt = (None, None, None)
        if final_carry is not None:
            import jax.numpy as jnp

            from .ndt import grid as G
            from .registration.matcher import transform_mean_cov

            mu, cov, valid = G.derive_sparse_fields(
                final_carry.submap, cfg.ndt_map.min_points_per_cell,
                cfg.ndt_map.cell)
            mu_w, cov_w = transform_mean_cov(
                jnp.asarray(final_carry.submap_origin), mu, cov)
            ndt = (np.asarray(mu_w), np.asarray(cov_w), np.asarray(valid))
        extent = None
        if ogm_grid is not None:
            o = cfg.ogm
            extent = (-0.5 * o.size_x * o.resolution,
                      0.5 * o.size_x * o.resolution,
                      -0.5 * o.size_y * o.resolution,
                      0.5 * o.size_y * o.resolution)
        viz.render_map_png(
            os.path.join(args.output, "map.png"),
            node_pose=node_pose, odom=odom,
            ndt_mean=ndt[0], ndt_cov=ndt[1], ndt_valid=ndt[2],
            ogm=ogm_grid, ogm_extent=extent,
            title=f"{args.input} — {T} frames, {int(n_loops)} loops")

    # exports (/ndt_odom and /randt_path equivalents)
    formats.write_tum(os.path.join(args.output, "odom_tum.txt"), stamps, odom)
    formats.write_kitti(os.path.join(args.output, "odom_kitti.txt"), odom)
    formats.write_tum(os.path.join(args.output, "slam_tum.txt"),
                      node_stamp, node_pose)
    formats.write_kitti(os.path.join(args.output, "slam_kitti.txt"), node_pose)
    viz.export_trajectory_json(
        os.path.join(args.output, "trajectory.json"), node_stamp, node_pose)

    import jax

    dev = jax.devices()[0]
    metrics = {
        # the device the run used, so a CPU run is visible as one
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "frames": T,
        "wall_s": round(wall, 3),
        "frames_per_second": round(T / wall, 2),
        "n_nodes": int(len(node_pose)),
        "n_loop_closures": int(n_loops),
    }
    if not args.online:
        odo_res = res if args.odometry_only else res.odometry
        metrics["saturation"] = odo_res.saturation
        if not args.odometry_only and "loop_prewarm_error" in res.timings:
            metrics["loop_prewarm_error"] = res.timings["loop_prewarm_error"]
    if gt_poses is not None:
        metrics.update({
            "odom_ate_m": round(formats.ate(odom, gt_poses[:T]), 4),
            "slam_ate_m": round(
                formats.ate(node_pose, gt_poses[node_frame]), 4),
        })
        t_rpe, r_rpe = formats.rpe(odom, gt_poses[:T])
        metrics["odom_rpe_m"] = round(t_rpe, 4)
        metrics["odom_rpe_deg"] = round(r_rpe, 4)
        kt, kr = formats.kitti_drift(odom, gt_poses[:T])
        metrics["odom_kitti_trans_pct"] = round(kt, 4)
        metrics["odom_kitti_rot_degp100m"] = round(kr, 4)
    metrics["profile"] = prof.report()
    # NaN (e.g. KITTI drift on paths shorter than 100 m) is not valid JSON
    metrics = {k: (None if isinstance(v, float) and v != v else v)
               for k, v in metrics.items()}
    with open(os.path.join(args.output, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    print(json.dumps(metrics, indent=2))
    return metrics


if __name__ == "__main__":
    main()
