"""Smoke test of the radar SLAM main path on one GPU.

    python chip_smoke.py

Runs, in one process on one card, at the real Oxford sensor geometry
(400 azimuths x 1157 range bins out to 100 m) and ``oxford_config()``:

  1. device check: JAX must report a GPU, else exit non-zero;
  2. offline SLAM through ``randt_slam_tpu.run.main`` on a synthetic
     closed-loop sequence written as a converted ``.npz`` (loop closure, PGO,
     OGM and every export);
  3. the same entry with ``--online`` on the first frames;
  4. the fleet path (``parallel/batch.make_batched_scan``, B copies, no mesh)
     against the single-sequence odometry;
  5. the hot ops on the card (the moment reductions, the window gather, and
     the LM window solve's Pallas kernel) against numpy float64 references,
     and the first front-end poses on the GPU against the same run on the
     CPU backend;
  6. timings (compile seconds, steady front-end ms/frame, end-to-end
     frames/s), each printed beside the card's name and power limit.

Any failed check exits non-zero before the last line, which is the JSON
object ``{"ok": true, "device": {...}}``.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

N_AZ, N_BINS, MAX_RANGE = 400, 1157, 100.0   # Oxford geometry (io/oxford.py)
OFFLINE_FRAMES = 320      # 1.25 laps of a closed loop: the last quarter revisits
ONLINE_FRAMES = 60
COMPARE_FRAMES = 40       # fleet and GPU-vs-CPU comparisons
FLEET_B = 4
# Per-pose agreement of two odometry runs of the same frames.  Both sides
# run float32 at `highest` matmul precision; they differ in summation order
# (the GPU's scatter-add is atomic, so its order changes between runs, and
# XLA:CPU sums in yet another order) and, against the CPU, in the window
# solve (the GPU's elimination kernel, the CPU's pivoted LU).  That perturbs
# each frame's LM solution in the last float32 digits, and odometry
# compounds it over 40 frames: the H100 runs measured up to 4.4e-3 m and
# 9e-4 rad.  1e-2 m and 1e-3 rad stay far below a wrong association (a cell
# is 3.5 m).
POSE_TOL_M, POSE_TOL_RAD = 1e-2, 1e-3
# Loop-closed SLAM may not be worse than its own odometry by more than this:
# loop edges carry the refinement noise of a 3.5 m-cell NDT match.
SLAM_ATE_MARGIN_M = 0.25
EXPECT_PLATFORM = "gpu"


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


class Report:
    """Prints each phase's numbers as one JSON line beside the card."""

    def __init__(self, card: str):
        self.card = card

    def __call__(self, phase: str, **numbers):
        print(json.dumps({"phase": phase, "card": self.card, **numbers}),
              flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def write_sequence(path, n_frames, n_az=N_AZ, n_bins=N_BINS,
                   max_range=MAX_RANGE, seed=0):
    """Synthetic closed loop in the converted format ``io/oxford.py`` reads,
    with uint8 scans as the Navtech sensor delivers them."""
    from randt_slam_tpu.io import synthetic

    seq = synthetic.generate(seed=seed, n_frames=n_frames, n_azimuths=n_az,
                             n_bins=n_bins, max_range=max_range, loop=True)
    np.savez(path,
             intensity=np.clip(seq.intensity, 0, 255).astype(np.uint8),
             azimuths=seq.azimuths, ranges=seq.ranges, stamps=seq.stamps,
             gt_poses=seq.gt_poses, imu_yaw=seq.imu_yaw)


def offline_phase(report, npz, out, config="oxford"):
    from randt_slam_tpu import run

    m = run.main(["--input", npz, "--config", config, "--ogm",
                  "--output", out])
    check(m["device"]["platform"] == EXPECT_PLATFORM,
          f"offline run used {m['device']}")
    odom, slam = m["odom_ate_m"], m["slam_ate_m"]
    check(odom is not None and math.isfinite(odom), f"odometry ATE {odom}")
    check(slam is not None and math.isfinite(slam), f"SLAM ATE {slam}")
    check(m["n_loop_closures"] >= 1, "no loop closure accepted")
    check(slam <= odom + SLAM_ATE_MARGIN_M,
          f"SLAM ATE {slam} > odometry ATE {odom} + {SLAM_ATE_MARGIN_M}")
    for f in ("odom_tum.txt", "slam_kitti.txt", "trajectory.json", "ogm.pgm"):
        check(os.path.getsize(os.path.join(out, f)) > 0, f"missing {f}")
    check("loop_prewarm_error" not in m,
          f"loop prewarm failed: {m.get('loop_prewarm_error')}")
    prof = m["profile"]
    report("offline", frames=m["frames"], wall_s=m["wall_s"],
           frames_per_second=m["frames_per_second"], odom_ate_m=odom,
           slam_ate_m=slam, loop_closures=m["n_loop_closures"],
           stages_s={k: v["total_s"] for k, v in prof.items()
                     if isinstance(v, dict) and "total_s" in v})
    return m


def online_phase(report, npz, out, n_frames, config="oxford"):
    from randt_slam_tpu import run

    m = run.main(["--input", npz, "--config", config, "--online",
                  "--frames", str(n_frames), "--output", out])
    poses = np.loadtxt(os.path.join(out, "odom_tum.txt"))
    check(poses.shape[0] == n_frames, f"online wrote {poses.shape[0]} poses")
    check(bool(np.all(np.isfinite(poses))), "online poses not finite")
    check(math.isfinite(m["odom_ate_m"]), f"online ATE {m['odom_ate_m']}")
    report("online", frames=m["frames"], wall_s=m["wall_s"],
           frames_per_second=m["frames_per_second"],
           odom_ate_m=m["odom_ate_m"], slam_ate_m=m["slam_ate_m"])


def pose_diff(a, b):
    from randt_slam_tpu.geometry import normalize_angle

    dt = float(np.max(np.linalg.norm(a[..., :2] - b[..., :2], axis=-1)))
    dr = float(np.max(np.abs(np.asarray(normalize_angle(a[..., 2] - b[..., 2])))))
    return dt, dr


def frontend_phases(report, cfg, frames_host, n, batch):
    """Steady front-end time, the fleet path, and GPU-vs-CPU odometry."""
    import jax
    import jax.numpy as jnp

    from randt_slam_tpu.parallel import batch as PB
    from randt_slam_tpu.pipeline import slam

    sub = jax.tree.map(lambda x: x[:n], frames_host)
    t0 = time.perf_counter()
    odo = slam.run_odometry(cfg, jax.device_put(sub))
    first_s = time.perf_counter() - t0
    dev = jax.device_put(sub)
    jax.block_until_ready(dev)
    t0 = time.perf_counter()
    odo = slam.run_odometry(cfg, dev)
    steady_s = time.perf_counter() - t0
    ref = np.asarray(odo.odom_poses)
    check(bool(np.all(np.isfinite(ref))), "front-end poses not finite")
    report("frontend", frames=n, first_call_s=first_s, steady_s=steady_s,
           compile_s=first_s - steady_s,
           steady_ms_per_frame=1e3 * steady_s / n)

    scan_fn = PB.make_batched_scan(cfg, jnp.zeros(3))
    frames_b = jax.tree.map(
        lambda x: jnp.broadcast_to(jnp.asarray(x), (batch,) + x.shape), sub)
    t0 = time.perf_counter()
    _, outs = scan_fn(PB.init_batched_carry(cfg, batch), frames_b)
    fleet = np.asarray(outs.odom_pose)
    fleet_s = time.perf_counter() - t0
    dts, drs = zip(*(pose_diff(fleet[b], ref) for b in range(batch)))
    report("fleet", batch=batch, frames=n, first_call_s=fleet_s,
           max_pose_diff_m=max(dts), max_pose_diff_rad=max(drs))
    check(max(dts) <= POSE_TOL_M and max(drs) <= POSE_TOL_RAD,
          f"fleet odometry differs: {max(dts)} m, {max(drs)} rad")

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        odo_cpu = slam.run_odometry(cfg, jax.device_put(sub, cpu))
    dt, dr = pose_diff(np.asarray(odo_cpu.odom_poses), ref)
    report("gpu_vs_cpu", frames=n, max_pose_diff_m=dt, max_pose_diff_rad=dr)
    check(dt <= POSE_TOL_M and dr <= POSE_TOL_RAD,
          f"GPU and CPU odometry differ: {dt} m, {dr} rad")


def reference_phase(report, n_segments):
    """The hot ops on the card against numpy float64 at real widths."""
    import jax
    import jax.numpy as jnp

    from randt_slam_tpu.ops.segment_moments import (segment_moments,
                                                    segment_topk_moments)
    from randt_slam_tpu.ops.spd_solve import spd_solve
    from randt_slam_tpu.ops.window_slice import row_windows
    from randt_slam_tpu.registration.solver import solve_damped

    rng = np.random.default_rng(0)
    P, CH, k = 8192, 13, 512   # max_points, moment channels, max_scan_cells
    vals = rng.normal(0, 10, (P, CH)).astype(np.float32)
    vals[:, 0] = rng.random(P) < 0.8          # channel 0 = point weight
    ids = rng.integers(-50, n_segments + 50, P).astype(np.int32)
    ok = (ids >= 0) & (ids < n_segments)
    want = np.zeros((n_segments, CH))
    np.add.at(want, ids[ok], vals[ok].astype(np.float64))
    got = np.asarray(jax.jit(segment_moments, static_argnums=2)(
        vals, ids, n_segments))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    seg_err = float(np.max(np.abs(got - want)))

    out, topi = jax.jit(segment_topk_moments, static_argnums=(2, 3))(
        vals, ids, n_segments, k)
    out, topi = np.asarray(out), np.asarray(topi)
    np.testing.assert_allclose(out, want[topi], rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(out[:, 0], np.sort(want[:, 0])[::-1][:k])

    # the preprocessor's windows: 2 * 32 + 1 bins over an image padded by 32
    win, width = 65, N_BINS + 64
    img = rng.random((N_AZ, width)).astype(np.float32)
    rng_row = rng.random(width).astype(np.float32)
    starts = rng.integers(0, width - win + 1, N_AZ).astype(np.int32)
    starts[:2] = (0, width - win)              # both image edges
    iw, rw = jax.jit(row_windows, static_argnums=3)(img, rng_row, starts, win)
    cols = starts[:, None] + np.arange(win)
    np.testing.assert_array_equal(np.asarray(iw),
                                  np.take_along_axis(img, cols, axis=1))
    np.testing.assert_array_equal(np.asarray(rw), rng_row[cols])

    # the LM window solve: damped, Jacobi-scaled 36x36 SPD system, through
    # the Pallas kernel as compiled for the card and through the LM loop's
    # own entry point (which picks the kernel on CUDA)
    J = rng.normal(0, 1, (120, 36)) * np.logspace(0, 4, 36)[None, :]
    A = J.T @ J
    d = 1.0 / np.sqrt(np.diag(A))
    A = A * d[:, None] * d[None, :] + 1e-4 * np.eye(36)
    b = rng.normal(0, 1, 36)
    rel = {}
    for name, fn in (("kernel", spd_solve), ("solve_damped", solve_damped)):
        x = np.asarray(jax.jit(fn)(jnp.asarray(A, jnp.float32),
                                   jnp.asarray(b, jnp.float32)), np.float64)
        rel[name] = float(np.linalg.norm(A @ x - b) / np.linalg.norm(b))
        check(rel[name] <= 1e-4, f"36x36 {name} relative residual {rel[name]}")
    report("reference", segment_points=P, segments=n_segments, topk=k,
           segment_max_abs_err=seg_err, windows="exact",
           solve36_rel_residual=rel)


def main():
    sys.path.insert(0, REPO)
    import jax

    dev = jax.devices()[0]
    if dev.platform != EXPECT_PLATFORM:
        print(f"chip_smoke: JAX found no GPU (platform {dev.platform!r})",
              file=sys.stderr)
        sys.exit(2)
    card = card_line()
    print(f"card: {card}", flush=True)
    report = Report(card)

    from randt_slam_tpu import config as CFG
    from randt_slam_tpu.io import oxford
    from randt_slam_tpu.pipeline import slam

    work = os.path.join(REPO, ".chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        npz = os.path.join(work, "sequence.npz")
        t0 = time.perf_counter()
        write_sequence(npz, OFFLINE_FRAMES)
        report("setup", frames=OFFLINE_FRAMES, azimuths=N_AZ, bins=N_BINS,
               generate_s=time.perf_counter() - t0)

        cfg = CFG.oxford_config()
        reference_phase(report, cfg.preprocessor.n_clusters)
        offline_phase(report, npz, os.path.join(work, "offline"))
        online_phase(report, npz, os.path.join(work, "online"), ONLINE_FRAMES)
        seq = oxford.load_npz_sequence(npz, max_frames=COMPARE_FRAMES)
        frames = slam.frames_from_arrays(
            seq.intensity, seq.azimuths, seq.ranges, seq.stamps,
            imu_yaw=seq.imu_yaw, host=True)
        frontend_phases(report, cfg, frames, COMPARE_FRAMES, FLEET_B)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
