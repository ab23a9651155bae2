"""rosbag1 ingestion (io/rosbag.py): round-trip, conversion, pipeline feed.

The reference consumes its primary (Zenodo indoor/mixed) benchmark as ROS1
bags of ``sensor_msgs/PointCloud2`` + ``sensor_msgs/Imu``
(``ndt_slam.cpp:94-209``); these tests prove the ROS-free ingestion path:
write a byte-exact rosbag v2.0 -> read it back -> convert to the canonical
``.npz`` -> drive the pipeline with the INGESTED imu_yaw.
"""

import numpy as np
import pytest

from randt_slam_tpu.io import rosbag as RB


def _cloud(rng, n=50, rmax=20.0):
    ang = rng.uniform(-np.pi, np.pi, n)
    r = rng.uniform(2.0, rmax, n)
    return np.stack([r * np.cos(ang), r * np.sin(ang),
                     rng.uniform(60, 200, n)], axis=1).astype(np.float32)


@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_bag_roundtrip_pointcloud_and_imu(tmp_path, compression):
    rng = np.random.default_rng(0)
    clouds = [_cloud(rng) for _ in range(3)]
    yaws = [0.1, 0.2, 0.35]
    msgs = []
    for t in range(3):
        msgs.append(("/radar_data", "sensor_msgs/PointCloud2", 10.0 + t,
                     RB.serialize_pointcloud2(clouds[t], 10.0 + t)))
        msgs.append(("/imu/data", "sensor_msgs/Imu", 10.0 + t + 0.01,
                     RB.serialize_imu(yaws[t], 10.0 + t + 0.01)))
    path = str(tmp_path / f"mini_{compression}.bag")
    RB.write_bag(path, msgs, compression=compression)

    got_pc, got_imu = [], []
    for m in RB.read_messages(path):
        if m.msg_type.endswith("PointCloud2"):
            assert m.topic == "/radar_data"
            got_pc.append(RB.parse_pointcloud2(m.raw))
        else:
            assert m.topic == "/imu/data"
            got_imu.append(RB.parse_imu(m.raw))
    assert len(got_pc) == 3 and len(got_imu) == 3
    for t in range(3):
        np.testing.assert_array_equal(got_pc[t].points_xyi, clouds[t])
        assert got_pc[t].stamp == pytest.approx(10.0 + t, abs=1e-6)
        assert got_imu[t].yaw == pytest.approx(yaws[t], abs=1e-9)


def test_pointcloud2_strided_fields_and_bigendian_guard(tmp_path):
    """Clouds with extra fields / padding between x, y, intensity parse by
    offset, not position (real Navtech/Zenodo clouds carry extra channels)."""
    import struct

    rng = np.random.default_rng(1)
    pts = _cloud(rng, n=7)
    # hand-build a PointCloud2 with fields x(0), z(4), y(8), intensity(16),
    # point_step 24 (padding after intensity)
    n = len(pts)
    frame_id = "radar"
    out = struct.pack("<IIII", 0, 5, 0, len(frame_id)) + frame_id.encode()
    out += struct.pack("<III", 1, n, 4)
    for name, off in (("x", 0), ("z", 4), ("y", 8), ("intensity", 16)):
        out += struct.pack("<I", len(name)) + name.encode()
        out += struct.pack("<IBI", off, 7, 1)
    out += struct.pack("<BII", 0, 24, 24 * n)
    rec = np.zeros((n, 6), np.float32)
    rec[:, 0] = pts[:, 0]
    rec[:, 1] = 99.0          # z decoy
    rec[:, 2] = pts[:, 1]
    rec[:, 4] = pts[:, 2]
    body = rec.tobytes()
    out += struct.pack("<I", len(body)) + body + struct.pack("<B", 1)

    pc = RB.parse_pointcloud2(out)
    np.testing.assert_array_equal(pc.points_xyi, pts)


def test_convert_bag_to_npz_with_imu(tmp_path):
    from randt_slam_tpu.io import oxford

    rng = np.random.default_rng(2)
    T = 6
    msgs = []
    yaw_truth = np.cumsum(rng.uniform(-0.1, 0.1, T))
    for t in range(T):
        msgs.append(("/radar_data", "sensor_msgs/PointCloud2", 100.0 + t * 0.25,
                     RB.serialize_pointcloud2(_cloud(rng), 100.0 + t * 0.25)))
        # 4 imu samples per radar frame (realistic rate mismatch)
        for k in range(4):
            st = 100.0 + t * 0.25 + k * 0.0625
            msgs.append(("/imu/data", "sensor_msgs/Imu", st,
                         RB.serialize_imu(float(yaw_truth[t]), st)))
    bag = str(tmp_path / "seq.bag")
    RB.write_bag(bag, msgs)
    npz = str(tmp_path / "seq.npz")
    info = RB.convert_bag(bag, npz, n_azimuths=64, n_bins=128)
    assert info["frames"] == T and info["imu_samples"] == 4 * T
    assert info["radar_topic"] == "/radar_data"

    seq = oxford.load_npz_sequence(npz)
    assert seq.intensity.shape == (T, 64, 128)
    assert seq.imu_yaw is not None
    # nearest-stamp association reproduces the per-frame yaw
    np.testing.assert_allclose(seq.imu_yaw, yaw_truth, atol=1e-5)
    # packed polar image holds the cloud intensities (max-combined)
    assert seq.intensity.max() > 100


def test_bag_pipeline_e2e_with_ingested_imu(tmp_path):
    """Full chain: synthetic world -> point clouds -> BAG -> npz -> odometry
    with ``use_imu: true`` consuming the INGESTED (not synthetic-array) yaw
."""
    import dataclasses

    import jax

    from __graft_entry__ import _tiny_cfg
    from randt_slam_tpu.io import oxford, synthetic
    from randt_slam_tpu.pipeline import slam

    seq = synthetic.generate(seed=7, n_frames=12, n_azimuths=64, n_bins=128,
                             max_range=40.0, speed=3.0, dt=0.25, n_walls=40)
    # polar scans -> point clouds (the inverse of pack_polar_image): take
    # every bin above the speckle floor as an (x, y, intensity) return
    msgs = []
    for t in range(12):
        a_idx, r_idx = np.nonzero(seq.intensity[t] > 60.0)
        ang = seq.azimuths[a_idx]
        r = seq.ranges[r_idx]
        pts = np.stack([r * np.cos(ang), r * np.sin(ang),
                        seq.intensity[t][a_idx, r_idx]], axis=1)
        st = float(seq.stamps[t]) + 50.0
        msgs.append(("/radar_data", "sensor_msgs/PointCloud2", st,
                     RB.serialize_pointcloud2(pts, st)))
        msgs.append(("/imu/data", "sensor_msgs/Imu", st,
                     RB.serialize_imu(float(seq.imu_yaw[t]), st)))
    bag = str(tmp_path / "e2e.bag")
    RB.write_bag(bag, msgs, compression="bz2")
    npz = str(tmp_path / "e2e.npz")
    RB.convert_bag(bag, npz, n_azimuths=64, n_bins=128, max_range=40.0)

    loaded = oxford.load_npz_sequence(npz)
    np.testing.assert_allclose(loaded.imu_yaw, seq.imu_yaw, atol=1e-5)

    cfg = _tiny_cfg()
    cfg = dataclasses.replace(
        cfg, matcher=dataclasses.replace(cfg.matcher, use_imu=True))
    frames = slam.frames_from_arrays(loaded.intensity, loaded.azimuths,
                                     loaded.ranges, loaded.stamps,
                                     imu_yaw=loaded.imu_yaw)
    odo = slam.run_odometry(cfg, frames)
    gt = seq.gt_poses
    err = np.linalg.norm(odo.odom_poses[:, :2] - gt[:, :2], axis=1)
    assert np.isfinite(err).all() and err.max() < 3.0
