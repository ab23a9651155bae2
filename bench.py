"""Benchmark: radar SLAM on one GPU at real Oxford geometry.

Configuration comes from the reference's own ``parameters_oxford.yaml``
(114x114-cell NDT maps at 3.5 m) and the frames have the real converted
geometry (400 azimuths x 1157 range bins of 8.64 cm out to the 100 m config
range — what ``io/oxford.py`` produces from raw PNGs at downsample 2).  The
trajectory is a snippet of the REAL Oxford ground truth with a simulated
scatterer world (raw radar data is not fetchable in this environment; see
OXFORD_RESULTS.md).

Reported (one JSON line):
  * front-end frames/s over a lax.scan of the full odometry step (primary)
  * steady-state END-TO-END frames/s (odometry + loop closure + PGO,
    compile-separated) on a 1600-frame window containing the sequence's
    real revisit, so the loop phase does real candidate work
  * pose-graph solve milliseconds at the real sequence's size (4077 nodes)
  * batch-scaling curve (1/2/4/8 vmapped sequences on one device)
  * the device (platform, kind, count) it ran on

Baseline: the reference (CPU C++/Ceres) publishes no FPS numbers in-repo
(BASELINE.md); its hard constraint is the Navtech radar's 4 Hz frame rate.
``vs_baseline`` is measured against 4 frames/s.
"""

import json
import os
import sys
import time

import numpy as np

REF_YAML = "/root/reference/ros/ndt_radar_slam/config/parameters_oxford.yaml"
REF_GT = "/root/reference/oxford_results/randt_eval_10-12-32/odom/gt/01.txt"

N_AZ = 400
BIN_W = 0.0864
MAX_RANGE = 100.0
T = 160


def build_config():
    from randt_slam_tpu.config import from_reference_yaml, oxford_config

    if os.path.exists(REF_YAML):
        return from_reference_yaml(REF_YAML)
    return oxford_config()


def build_frames(start=0, n_frames=T, host=False):
    from randt_slam_tpu.io import kitti_eval as KE
    from randt_slam_tpu.io import synthetic as S
    from randt_slam_tpu.pipeline import slam

    rng = np.random.default_rng(0)
    if os.path.exists(REF_GT):
        gt44 = KE.load_kitti_poses(REF_GT)[start:start + n_frames]
        gt = np.stack([gt44[:, 0, 3], gt44[:, 1, 3],
                       np.arctan2(gt44[:, 1, 0], gt44[:, 0, 0])], 1)
        gt = gt.astype(np.float32)
    else:
        gt = S.make_trajectory(rng, n_frames, dt=0.25, speed=4.0)
    landmarks = S.make_world(rng, trajectory=gt, n_walls=120, corridor=50.0,
                             n_clutter=240)
    az = (np.arange(N_AZ) / N_AZ * 2 * np.pi - np.pi).astype(np.float32)
    n_bins = int(MAX_RANGE / BIN_W)
    ranges = ((np.arange(n_bins) + 0.5) * BIN_W).astype(np.float32)
    # uint8 transport for host-resident sequences: the real Navtech sensor
    # quantizes return power to uint8, and the host->device upload bounds
    # offline replay throughput (same choice as scripts/oxford_sim.py)
    raw = np.stack([
        S.render_scan_fast(
            p, landmarks[(np.abs(landmarks[:, 0] - p[0]) < MAX_RANGE + 5)
                         & (np.abs(landmarks[:, 1] - p[1]) < MAX_RANGE + 5)],
            az, ranges, rng)
        for p in gt
    ])
    scans = (np.clip(raw, 0.0, 255.0).astype(np.uint8) if host
             else raw.astype(np.float32))
    stamps = (np.arange(len(gt)) * 0.25).astype(np.float32)
    frames = slam.frames_from_arrays(scans, az, ranges, stamps, host=host)
    return frames, gt


def bench_pgo_ms(n_nodes=4077, dense_node_limit=2048):
    """Pose-graph solve at the real Oxford sequence size (BASELINE.md row),
    routed by ``schur.optimize_auto`` at ``dense_node_limit``."""
    import jax
    import jax.numpy as jnp

    from randt_slam_tpu.graph import pose_graph as PG
    from randt_slam_tpu.config import GlobalFuserConfig

    rng = np.random.default_rng(1)
    t = np.linspace(0, 4 * np.pi, n_nodes)
    gt = np.stack([60 * np.cos(t), 60 * np.sin(t), t + np.pi / 2], 1)
    noisy = gt + np.concatenate(
        [np.zeros((1, 3)), np.cumsum(rng.normal(0, 0.03, (n_nodes - 1, 3)), 0)]
    )
    eb = np.arange(n_nodes - 1)
    ee = eb + 1
    # relative gt transforms as edge measurements
    c = np.cos(gt[:-1, 2]); s = np.sin(gt[:-1, 2])
    d = gt[1:] - gt[:-1]
    trans = np.stack([c * d[:, 0] + s * d[:, 1],
                      -s * d[:, 0] + c * d[:, 1], d[:, 2]], 1)
    # loop edges every 100 nodes back to the matching lap position; like the
    # reference's constraints (root_node -> query, ``local_fuser.cpp:341-347``)
    # they anchor at the matched submap's ROOT node (submaps of 8 below)
    per = 8
    lap = n_nodes // 2
    lq = np.arange(lap, n_nodes - 1, 100)           # query nodes
    lr = ((lq - lap) // per) * per                  # matched submap roots
    cl = np.cos(gt[lr, 2]); sl = np.sin(gt[lr, 2])
    dl = gt[lq] - gt[lr]
    ltrans = np.stack([cl * dl[:, 0] + sl * dl[:, 1],
                       -sl * dl[:, 0] + cl * dl[:, 1], dl[:, 2]], 1)
    eb = np.concatenate([eb, lr]); ee = np.concatenate([ee, lq])
    trans = np.concatenate([trans, ltrans])
    sqrtI = np.tile(np.diag([10.0, 10.0, 50.0]), (len(eb), 1, 1))
    g = PG.PoseGraph(
        poses=jnp.asarray(noisy, jnp.float32),
        id_begin=jnp.asarray(eb, jnp.int32),
        id_end=jnp.asarray(ee, jnp.int32),
        trans=jnp.asarray(trans, jnp.float32),
        sqrt_information=jnp.asarray(sqrtI, jnp.float32),
        valid=jnp.ones(len(eb), bool),
    )
    # What the pipeline actually runs at this size (``schur.optimize_auto``):
    # the submap-sharded Schur path — dense LU/Cholesky factorizations of the
    # full (3N, 3N) system stop being the right tool beyond ~2k nodes.  A
    # fixed iteration budget mirrors the reference's bounded Ceres refinement
    # per 0.2 Hz tick.
    from randt_slam_tpu.graph import schur

    node_submap = np.minimum(np.arange(n_nodes) // per, n_nodes // per - 1)
    node_is_root = np.zeros(n_nodes, bool)
    node_is_root[::per] = True
    cfg = GlobalFuserConfig(max_iterations=10)
    poses, info = schur.optimize_auto(
        g, cfg, node_submap=node_submap, node_is_root=node_is_root,
        dense_node_limit=dense_node_limit)  # compile
    jax.block_until_ready(poses)
    t0 = time.perf_counter()
    poses, info = schur.optimize_auto(
        g, cfg, node_submap=node_submap, node_is_root=node_is_root,
        dense_node_limit=dense_node_limit)
    jax.block_until_ready(poses)
    solve_ms = (time.perf_counter() - t0) * 1000.0

    it_s = schur.benchmark_schur_iteration(
        g, GlobalFuserConfig(), node_submap, node_is_root)
    return solve_ms, int(info["iterations"]), info["solver"], it_s * 1000.0


def bench_batched_fps(cfg, frames, batch=4):
    """Aggregate frames/s with ``batch`` independent sequences vmapped on ONE
    device (``parallel/batch.py``) — per-sequence SLAM is latency-bound, so
    fleet throughput is the number that scales with hardware (BASELINE
    configs 4-5)."""
    import jax
    import jax.numpy as jnp

    from randt_slam_tpu.parallel import batch as PB

    frames_b = jax.tree.map(
        lambda x: jnp.broadcast_to(jnp.asarray(x), (batch,) + x.shape), frames)
    carries = PB.init_batched_carry(cfg, batch)
    scan_fn = PB.make_batched_scan(cfg, jnp.zeros(3))
    _, outs = scan_fn(carries, frames_b)          # compile + warmup
    jax.block_until_ready(outs.odom_pose)
    t0 = time.perf_counter()
    _, outs = scan_fn(carries, frames_b)
    jax.block_until_ready(outs.odom_pose)
    return batch * T / (time.perf_counter() - t0)


def bench_e2e(cfg):
    """Steady-state END-TO-END throughput at Oxford geometry on a window that
    CONTAINS the sequence's revisit (GT frames 1200..2800 bracket the
    ~1423 -> ~2691 revisit pair), so the loop phase measures real candidate
    work.  Compile is separated per phase: odometry via
    per-chunk walls (chunk 0 carries the compile), loop + PGO by running each
    phase a second time in-process (retrace hits the in-process/persistent
    compile caches; the second call is the steady cost a long-running service
    pays)."""
    import jax
    import jax.numpy as jnp

    from randt_slam_tpu.graph import schur
    from randt_slam_tpu.loops import detector
    from randt_slam_tpu.pipeline import slam
    from randt_slam_tpu.graph import pose_graph as PG

    T2 = 1600
    frames, gt = build_frames(start=1200, n_frames=T2, host=True)
    res = slam.run_slam(cfg, frames, use_scan=True, chunk=200)
    cs = np.asarray(res.odometry.chunk_seconds)
    odo_steady_s = float(np.median(cs[1:])) * len(cs)

    t0 = time.perf_counter()
    loops = detector.detect_loops(cfg, res.odometry, frames, jnp.zeros(3))
    loop_steady_s = time.perf_counter() - t0

    odo = res.odometry
    eb = np.concatenate([odo.edge_begin, loops.edge_begin]).astype(np.int32)
    ee = np.concatenate([odo.edge_end, loops.edge_end]).astype(np.int32)
    et = np.concatenate([odo.edge_trans, loops.edge_trans]).astype(np.float32)
    ei = np.concatenate(
        [odo.edge_sqrt_information, loops.edge_sqrt_information]
    ).astype(np.float32)
    g = PG.PoseGraph(
        poses=jnp.asarray(odo.node_pose, jnp.float32),
        id_begin=jnp.asarray(eb), id_end=jnp.asarray(ee),
        trans=jnp.asarray(et), sqrt_information=jnp.asarray(ei),
        valid=jnp.ones(len(eb), bool),
    )
    t0 = time.perf_counter()
    poses, info = schur.optimize_auto(
        g, cfg.global_fuser, node_submap=odo.node_submap,
        node_is_root=odo.node_is_root)
    jax.block_until_ready(poses)
    pgo_steady_s = time.perf_counter() - t0

    # Device-resident odometry: the host-resident path above pays the scan
    # upload per chunk.  Upload the whole uint8 sequence to device memory
    # once, then run the SAME chunked scan (per-chunk "_put" becomes a device
    # slice); this is the pipeline's own steady rate.
    dframes = jax.device_put(frames)
    jax.block_until_ready(dframes.intensity)
    t0 = time.perf_counter()
    odo_d = slam.run_odometry(cfg, dframes, chunk=200)
    odo_dev_wall_s = time.perf_counter() - t0
    cs_d = np.asarray(odo_d.chunk_seconds)
    # steady rate = median chunk excluding the compile-bearing first chunk;
    # with <=1 chunk there is no steady window — use the raw wall (the
    # median of an empty slice is NaN).
    odo_dev_s = (float(np.median(cs_d[1:])) * len(cs_d)
                 if len(cs_d) >= 2 else odo_dev_wall_s)
    del dframes, odo_d

    steady_total = odo_steady_s + loop_steady_s + pgo_steady_s
    dev_total = odo_dev_s + loop_steady_s + pgo_steady_s
    return {
        "e2e_frames": T2,
        "e2e_steady_fps": round(T2 / steady_total, 2),
        "e2e_steady_fps_device_resident": round(T2 / dev_total, 2),
        "e2e_odometry_steady_s_device_resident": round(odo_dev_s, 1),
        "e2e_wall_fps_incl_compile": round(
            T2 / (res.timings["odometry_s"] + res.timings["loop_closure_s"]
                  + res.timings["pgo_s"]), 2),
        "e2e_odometry_steady_s": round(odo_steady_s, 1),
        "e2e_loop_steady_s": round(loop_steady_s, 1),
        "e2e_pgo_steady_s": round(pgo_steady_s, 2),
        "e2e_loop_candidates": int(loops.n_sc_candidates),
        "e2e_loops_accepted": int(loops.n_accepted),
    }


def main():
    import jax
    import jax.numpy as jnp
    from functools import partial

    from randt_slam_tpu.pipeline import slam

    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX found "
                 f"{jax.devices()[0].platform!r}")
    cfg = build_config()
    frames, gt = build_frames()

    # Use run_odometry's OWN jitted scan so its compile (persistently cached
    # afterwards) is paid exactly once for both the fps measurement and the
    # loop/PGO phases.
    t0 = time.perf_counter()
    odo = slam.run_odometry(cfg, frames)
    first_s = time.perf_counter() - t0

    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        odo = slam.run_odometry(cfg, frames)
        times.append(time.perf_counter() - t0)
    # steady-state: the in-process retrace hits the persistent compile cache;
    # host-side unstacking is included (it is part of the pipeline).
    fps = T / min(times)

    pgo_ms, pgo_iters, pgo_solver, schur_iter_ms = bench_pgo_ms()

    # batch-scaling curve on one device (BASELINE config 4)
    batch_curve = {}
    for b in (1, 2, 4, 8):
        batch_curve[f"batched_{b}seq_fps"] = round(
            bench_batched_fps(cfg, frames, batch=b), 2)

    e2e = bench_e2e(cfg)

    # MFU/roofline of the hot kernels against the device's published peaks,
    # measured fresh each run; a failure here fails the bench.
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "scripts"))
    import mfu as MFU
    mfu = {}
    # pass this module in explicitly — mfu must not import bench itself
    for row in MFU.main(quiet=True, include_schur=False,
                        bench_mod=sys.modules[__name__]):
        key = row["kernel"].split(" ")[0]
        mfu[f"mfu_{key}"] = {
            k: v for k, v in row.items()
            if k in ("device_time_ms", "mfu_vs_f32_peak",
                     "hbm_utilization", "limiter")}

    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "radar_frames_per_second_1chip",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / 4.0, 2),
        "extra": {
            "geometry": f"{N_AZ}x{int(MAX_RANGE / BIN_W)} bins, "
                        f"{cfg.ndt_map.size_x}^2-cell map (parameters_oxford.yaml)",
            **e2e,
            "pose_graph_solve_ms_4077_nodes": round(pgo_ms, 1),
            "pose_graph_iterations": pgo_iters,
            "pose_graph_solver": pgo_solver,
            "pose_graph_schur_iter_ms_4077_nodes": round(schur_iter_ms, 2),
            **batch_curve,
            **mfu,
        },
    }))


if __name__ == "__main__":
    main()
