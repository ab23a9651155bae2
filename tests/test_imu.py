"""End-to-end IMU path.

The reference feeds relative yaw from consecutive IMU quaternions into a
rotation + bias-walk residual (``ndt_matcher.cpp:146-181``,
``local_fuser.cpp:110-120``).  These tests drive the full front end with
``use_imu=True`` on a synthetic sequence whose IMU readings carry a known
constant bias drift and assert (a) the bias state converges to the true rate,
(b) accuracy does not degrade versus the IMU-off run, and (c) toggling the
IMU channel changes the solution (the round-1 failure mode was ``run.py``
silently dropping ``seq.imu_yaw``).

The convergence fixture uses a straight-line trajectory: with zero true yaw
rate the radar pins the heading and the biased gyro reading is directly
observable, making the bias estimate deterministic instead of absorbing
world-dependent radar heading drift.
"""

import dataclasses

import numpy as np
import pytest

from randt_slam_tpu.config import synthetic_config
from randt_slam_tpu.io import formats, synthetic
from randt_slam_tpu.pipeline import slam
from randt_slam_tpu.registration import residuals as R

TRUE_BIAS = 0.02  # rad/s
N = 40


def _cfg(use_imu: bool):
    cfg = synthetic_config()
    # weight_imu_bias relaxed from the reference's 7.5e5 so the bias random
    # walk can adapt within a 40-frame test (mechanism test, not tuning).
    m = dataclasses.replace(cfg.matcher, use_imu=use_imu,
                            weight_imu=64.0, weight_imu_bias=50.0)
    return dataclasses.replace(cfg, use_imu=use_imu, matcher=m)


@pytest.fixture(scope="module")
def straight_seq():
    rng = np.random.default_rng(4)
    dt, speed = 0.25, 4.0
    poses = np.zeros((N, 3), np.float32)
    poses[:, 0] = np.arange(N) * speed * dt
    landmarks = synthetic.make_world(rng, trajectory=poses, n_walls=150,
                                     corridor=45.0)
    A, Rb = 256, 256
    az = (np.arange(A) / A * 2 * np.pi - np.pi).astype(np.float32)
    ranges = ((np.arange(Rb) + 0.5) * (80.0 / Rb)).astype(np.float32)
    scans = np.stack(
        [synthetic.render_scan(p, landmarks, az, ranges, rng) for p in poses]
    )
    stamps = (np.arange(N) * dt).astype(np.float32)
    imu = (poses[:, 2] + TRUE_BIAS * stamps
           + rng.normal(0, 0.001, N)).astype(np.float32)
    return scans, az, ranges, stamps, imu, poses


def _run(cfg, seq, with_imu: bool):
    scans, az, ranges, stamps, imu, _ = seq
    frames = slam.frames_from_arrays(
        scans, az, ranges, stamps, imu_yaw=imu if with_imu else None
    )
    return slam.run_odometry(cfg, frames, use_scan=True)


def test_imu_bias_converges_and_accuracy_holds(straight_seq):
    gt = straight_seq[5]
    res_off = _run(_cfg(False), straight_seq, with_imu=False)
    res_on = _run(_cfg(True), straight_seq, with_imu=True)

    ate_off = formats.ate(res_off.odom_poses, gt)
    ate_on = formats.ate(res_on.odom_poses, gt)
    assert np.isfinite(ate_on)
    assert ate_on <= ate_off * 1.10 + 0.05, (
        f"IMU-on ATE {ate_on} worse than IMU-off {ate_off}")

    # Bias state of the newest window state converges to the true rate.
    bias = float(np.asarray(res_on.final_carry.states)[-1, R.BIAS])
    assert 0.5 * TRUE_BIAS < bias < 1.6 * TRUE_BIAS, (
        f"bias estimate {bias} did not converge toward {TRUE_BIAS}")

    # The IMU-off run never touches the bias slot.
    bias_off = float(np.asarray(res_off.final_carry.states)[-1, R.BIAS])
    assert bias_off == 0.0


def test_imu_measurements_reach_the_residual(straight_seq):
    """Toggling the IMU channel must change the estimate (no silent no-op)."""
    cfg = _cfg(True)
    sub = tuple(x[:16] if np.ndim(x) and len(x) == N else x
                for x in straight_seq)
    res_with = _run(cfg, sub, with_imu=True)
    res_zero = _run(cfg, sub, with_imu=False)
    d = np.abs(res_with.odom_poses - res_zero.odom_poses).max()
    assert d > 1e-6, "IMU measurements do not influence the solution"
