"""Online (incremental) mode and the CLI driver.

Regression coverage for the early-database ScanContext kNN crash (top_k with
k > N) and smoke coverage of ``python -m randt_slam_tpu.run`` exports.
"""

import json
import os

import numpy as np
import jax
import pytest

from randt_slam_tpu.io import synthetic
from randt_slam_tpu.pipeline import slam
from __graft_entry__ import _tiny_cfg


@pytest.fixture(scope="module")
def tiny_seq():
    cfg = _tiny_cfg()
    seq = synthetic.generate(seed=5, n_frames=16, n_azimuths=64, n_bins=128,
                             max_range=40.0, speed=3.0, dt=0.25, n_walls=40)
    frames = slam.frames_from_arrays(
        seq.intensity, seq.azimuths, seq.ranges, seq.stamps
    )
    return cfg, seq, frames


def test_online_mode_runs_and_detects_early(tiny_seq):
    from randt_slam_tpu.pipeline.online import OnlineSlam

    cfg, seq, frames = tiny_seq
    # loop_every=2 forces detect_loops while the SC database is shorter than
    # num_candidates (the reference kd-tree tolerates this; top_k must too)
    eng = OnlineSlam(cfg, loop_every=2, pgo_every=6)
    for t in range(16):
        fr = jax.tree.map(lambda x: x[t], frames)
        pose = eng.process_frame(fr)
        assert np.all(np.isfinite(pose))
    assert len(eng.node_pose) >= 3
    traj = eng.trajectory()
    assert traj.shape[1] == 3 and np.all(np.isfinite(traj))
    # odometry should move roughly with the commanded speed
    assert np.linalg.norm(eng.odom_trace[-1][:2]) > 1.0


def test_cli_odometry_smoke(tmp_path, monkeypatch):
    from randt_slam_tpu import run as cli

    out = str(tmp_path / "out")
    # patch the synthetic preset to the tiny config so the smoke test stays
    # CPU-fast; frame shapes must match the capacities
    monkeypatch.setattr(cli, "load_config", lambda args: _tiny_cfg())
    monkeypatch.setattr(
        cli, "load_frames",
        lambda args, cfg: _tiny_frames(cfg, args.frames or 10),
    )
    cli.main(["--input", "synthetic", "--config", "synthetic",
              "--frames", "10", "--odometry-only", "--python-loop",
              "--output", out])
    metrics = json.load(open(os.path.join(out, "metrics.json")))
    assert metrics["frames"] == 10
    assert np.isfinite(metrics["odom_ate_m"])
    for f in ["odom_tum.txt", "odom_kitti.txt", "slam_tum.txt",
              "trajectory.json"]:
        assert os.path.exists(os.path.join(out, f)), f


def _tiny_frames(cfg, n):
    seq = synthetic.generate(seed=6, n_frames=n, n_azimuths=64, n_bins=128,
                             max_range=40.0, speed=3.0, dt=0.25, n_walls=40)
    frames = slam.frames_from_arrays(
        seq.intensity, seq.azimuths, seq.ranges, seq.stamps
    )
    return frames, seq.gt_poses, seq.stamps


def test_online_checkpoint_resume_reproduces(tmp_path, tiny_seq):
    """Resume mid-sequence must reproduce the uninterrupted trajectory
: device carry + host graph/SC/queue state round-trip."""
    from randt_slam_tpu.pipeline.online import OnlineSlam

    cfg, seq, frames = tiny_seq
    T = 16
    ref = OnlineSlam(cfg, loop_every=3, pgo_every=7)
    for t in range(T):
        ref.process_frame(jax.tree.map(lambda x: x[t], frames))

    half = 8
    a = OnlineSlam(cfg, loop_every=3, pgo_every=7)
    for t in range(half):
        a.process_frame(jax.tree.map(lambda x: x[t], frames))
    ckpt = str(tmp_path / "ck.npz")
    a.save_checkpoint(ckpt)

    b = OnlineSlam(cfg, loop_every=3, pgo_every=7)
    b.load_checkpoint(ckpt)
    assert b._frame_count == half
    for t in range(half, T):
        b.process_frame(jax.tree.map(lambda x: x[t], frames))

    np.testing.assert_allclose(np.stack(b.odom_trace),
                               np.stack(ref.odom_trace), atol=1e-6)
    np.testing.assert_allclose(b.trajectory(), ref.trajectory(), atol=1e-6)
    assert b.n_loop_edges == ref.n_loop_edges
    assert len(b.edges) == len(ref.edges)


def test_online_ogm_cadence(tiny_seq):
    """visualize_ogm=True raytraces keyframe beams online and renders a
    fused global OGM (``ndt_slam.cpp:366-368`` cadence)."""
    import dataclasses

    from randt_slam_tpu.pipeline.online import OnlineSlam

    cfg, seq, frames = tiny_seq
    cfg = dataclasses.replace(cfg, visualize_ogm=True)
    eng = OnlineSlam(cfg, loop_every=50, pgo_every=50)
    for t in range(16):
        eng.process_frame(jax.tree.map(lambda x: x[t], frames))
    assert eng._count_grids, "no counting grids accumulated"
    g = next(iter(eng._count_grids.values()))
    assert (g > 0).any() and (g < 0).any(), "no hits/free cells traced"
    ogm = eng.render_ogm()
    o = cfg.ogm
    assert ogm.shape == (o.size_y, o.size_x)
    assert np.isfinite(ogm).all()
    assert ogm.max() > 0.5 and ogm.min() < 0.5  # occupied + free evidence


def test_online_live_viz_export(tmp_path, monkeypatch):
    """--online --viz-every overwrites live/ with the current map view each
    cadence (the RViz NDT-marker + OGM stream equivalent,
    ``rviz_visualization.cpp:13-18``)."""
    import dataclasses

    from randt_slam_tpu import run as cli

    out = str(tmp_path / "out")
    cfg = dataclasses.replace(_tiny_cfg(), visualize_ogm=True)
    monkeypatch.setattr(cli, "load_config", lambda args: cfg)
    monkeypatch.setattr(
        cli, "load_frames",
        lambda args, cfg: _tiny_frames(cfg, args.frames or 12),
    )
    cli.main(["--input", "synthetic", "--config", "synthetic",
              "--frames", "12", "--online", "--viz-every", "5", "--ogm",
              "--output", out])
    live = os.path.join(out, "live")
    for f in ["map.png", "ndt_submap.npz", "trajectory.json", "ogm.pgm"]:
        assert os.path.exists(os.path.join(live, f)), f
    ndt = np.load(os.path.join(live, "ndt_submap.npz"))
    assert ndt["mean_x"].size > 0 and np.isfinite(ndt["mean_x"]).all()
    traj = json.load(open(os.path.join(live, "trajectory.json")))
    assert len(traj) >= 1 and np.isfinite(traj[-1]["x"])


def test_saturation_counters_surface(tiny_seq):
    """Capacity saturation is reported, not silent."""
    import dataclasses

    from randt_slam_tpu.config import CapacityConfig

    cfg, seq, frames = tiny_seq
    res = slam.run_odometry(cfg, frames, use_scan=False)
    assert set(res.saturation) == {"scan_cell_budget_frames",
                                   "submap_table_full_frames",
                                   "submap_store_full"}
    # squeeze the scan-cell budget to force saturation and see it reported
    tiny_cap = dataclasses.replace(cfg.capacity, max_scan_cells=8)
    cfg2 = dataclasses.replace(cfg, capacity=tiny_cap)
    res2 = slam.run_odometry(cfg2, frames, use_scan=False)
    assert res2.saturation["scan_cell_budget_frames"] > 0


def test_online_pgo_routes_schur_beyond_dense_limit(tiny_seq, monkeypatch):
    """Online PGO must survive graphs beyond the dense solver's node limit
    (full-sequence Oxford reaches ~4k nodes): ``optimize_pose_graph`` routes
    through ``schur.optimize_auto``.  Graph state is
    injected directly — driving 2k+ keyframes through the front end would
    take minutes without testing anything extra."""
    from randt_slam_tpu.graph import schur
    from randt_slam_tpu.pipeline.online import OnlineSlam

    cfg, seq, frames = tiny_seq
    eng = OnlineSlam(cfg, loop_every=10**9, pgo_every=10**9)

    rng = np.random.default_rng(3)
    N = 2100
    per = 10
    t = np.linspace(0, 4 * np.pi, N)
    gt = np.stack([40 * np.cos(t), 40 * np.sin(t), t + np.pi / 2], 1)
    noisy = gt + np.concatenate(
        [np.zeros((1, 3)), np.cumsum(rng.normal(0, 0.01, (N - 1, 3)), 0)])
    eng.node_pose = [p.astype(np.float32) for p in noisy]
    eng.node_submap = (np.arange(N) // per).tolist()
    eng.node_is_root = (np.arange(N) % per == 0).tolist()

    def rel(a, b):
        c, s = np.cos(a[2]), np.sin(a[2])
        d = b - a
        return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                         np.arctan2(np.sin(d[2]), np.cos(d[2]))],
                        np.float32)

    sqrtI = np.diag([10.0, 10.0, 20.0]).astype(np.float32)
    eng.edges = [(i, i + 1, rel(gt[i], gt[i + 1]), sqrtI)
                 for i in range(N - 1)]
    # a few loop edges root -> later interior (as the detector emits them)
    for q in range(N // 2 + 5, N - 1, 400):
        r = (q - N // 2) // per * per
        eng.edges.append((r, q, rel(gt[r], gt[q]), sqrtI))
        eng.n_loop_edges += 1

    routed = {}
    orig = schur.optimize_auto

    def spy(*a, **k):
        poses, info = orig(*a, **k)
        routed["solver"] = info["solver"]
        return poses, info

    monkeypatch.setattr(schur, "optimize_auto", spy)
    eng.optimize_pose_graph()
    assert routed["solver"] == "schur"
    opt = np.stack(eng.node_pose)
    assert np.all(np.isfinite(opt))
    # optimization must pull the noisy chain toward ground truth
    before = np.linalg.norm(noisy[:, :2] - gt[:, :2], axis=1).mean()
    after = np.linalg.norm(opt[:, :2] - gt[:, :2], axis=1).mean()
    assert after < 0.5 * before
