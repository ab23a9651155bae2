import numpy as np
import jax
import jax.numpy as jnp

from randt_slam_tpu.config import SlamConfig, MapConfig, MatcherConfig, derive
from randt_slam_tpu.ndt import cells as C
from randt_slam_tpu.registration import barron, matcher
from randt_slam_tpu.registration import residuals as R


def test_barron_weight_is_rho_derivative():
    s = jnp.linspace(0.01, 30.0, 50)
    for alpha in (-2.0, 0.0, 2.0, 1.0):
        for mu in (1.0, 5.0):
            rho = lambda x: barron.rho(x, 1.3, alpha, mu)
            grad = jax.vmap(jax.grad(rho))(s)
            w = barron.weight(s, 1.3, alpha, mu)
            np.testing.assert_allclose(np.asarray(w), np.asarray(grad), rtol=1e-3)


def test_barron_cauchy_and_quadratic_limits():
    s = jnp.asarray([0.5, 4.0])
    np.testing.assert_allclose(np.asarray(barron.rho(s, 2.0, 3.0, 1.0)), np.asarray(s))
    # alpha ~ 0: b log(1 + s/b)
    out = np.asarray(barron.rho(s, 1.0, 0.0, 2.0))
    np.testing.assert_allclose(out, 2.0 * np.log1p(np.asarray(s) / 2.0), rtol=1e-5)


def test_gnc_schedule_matches_reference_arithmetic():
    mu0 = barron.gnc_mu_init(jnp.asarray(8.0), 1.0, 10, 1.4)
    np.testing.assert_allclose(float(mu0), min(16.0, 1.4**9), rtol=1e-6)
    assert bool(barron.gnc_continue(jnp.asarray(1.0), 1.4))
    assert not bool(barron.gnc_continue(jnp.asarray(0.8), 1.4))


def test_predict_state_clamps_dt_and_rotates_midpoint():
    s = jnp.zeros(9).at[R.VX].set(2.0).at[R.OM].set(0.5)
    out = np.asarray(R.predict_state(s, jnp.asarray(0.01)))  # clamped to 0.2
    dt = 0.2
    mid = 0.5 * dt * 0.5
    np.testing.assert_allclose(out[R.X], np.cos(mid) * 2.0 * dt, rtol=1e-5)
    np.testing.assert_allclose(out[R.Y], np.sin(mid) * 2.0 * dt, rtol=1e-5)
    np.testing.assert_allclose(out[R.TH], dt * 0.5, rtol=1e-5)


def test_motion_residual_zero_for_perfect_prediction():
    s0 = jnp.zeros(9).at[R.VX].set(1.5).at[R.OM].set(0.3)
    s1 = R.predict_state(s0, jnp.asarray(0.5))
    sqrtI = jnp.eye(8)
    r = np.asarray(R.motion_residual(s0, s1, jnp.asarray(0.5), sqrtI))
    np.testing.assert_allclose(r, np.zeros(8), atol=1e-6)


def test_ndt_residual_whitening():
    pose = jnp.asarray([0.0, 0.0, 0.0])
    m_mean = jnp.asarray([1.0, 0.0, 5.0])
    f_mean = jnp.asarray([0.0, 0.0, 5.0])
    cov = jnp.eye(3) * 0.5
    r = float(R.ndt_residual(pose, m_mean, cov, f_mean, cov))
    np.testing.assert_allclose(r, 1.0, rtol=1e-5)  # sqrt(1/(0.5+0.5))
    # perfect alignment -> ~0
    r0 = float(R.ndt_residual(pose, f_mean, cov, f_mean, cov))
    assert r0 < 1e-4


def _random_cells(rng, n, extent=20.0):
    mu = np.zeros((n, 3), np.float32)
    mu[:, :2] = rng.uniform(-extent, extent, (n, 2))
    mu[:, 2] = rng.uniform(40, 120, n)
    cov = np.zeros((n, 3, 3), np.float32)
    for i in range(n):
        A = rng.normal(0, 0.4, (2, 2))
        cov[i, :2, :2] = A @ A.T + 0.05 * np.eye(2)
        cov[i, 2, 2] = rng.uniform(2.0, 20.0)
    return jnp.asarray(mu), jnp.asarray(cov)


def test_estimate_loop_recovers_known_transform():
    rng = np.random.default_rng(0)
    cfg = derive(SlamConfig(
        ndt_map=MapConfig(size_x=200, size_y=200, resolution=2.0),
        matcher=MatcherConfig(smoothing_steps=3),
    ))
    n = 60
    m_mu, m_cov = _random_cells(rng, n)
    true_pose = jnp.asarray([1.2, -0.8, 0.15])
    f_mu, f_cov = matcher.transform_mean_cov(true_pose, m_mu, m_cov)
    valid = jnp.ones(n, bool)
    init = jnp.asarray([0.8, -0.5, 0.05])  # off by ~0.5 m / 0.1 rad
    est = matcher.estimate_loop(cfg, init, f_mu, f_cov, valid, m_mu, m_cov, valid)
    np.testing.assert_allclose(np.asarray(est.pose), np.asarray(true_pose), atol=0.02)
    # Second-nearest-neighbor pairs keep the mean cost away from zero even at
    # perfect alignment; just require it to be small.
    assert float(est.mean_cost) < 0.5
    assert int(est.n_pairs) > 0


def test_estimate_loop_robust_to_outlier_cells():
    rng = np.random.default_rng(1)
    cfg = derive(SlamConfig(
        ndt_map=MapConfig(size_x=200, size_y=200, resolution=2.0),
    ))
    n = 80
    m_mu, m_cov = _random_cells(rng, n)
    true_pose = jnp.asarray([0.9, 0.4, -0.1])
    f_mu, f_cov = matcher.transform_mean_cov(true_pose, m_mu, m_cov)
    # corrupt 20% of the fixed cells
    n_out = 16
    f_mu = f_mu.at[:n_out, :2].add(jnp.asarray(rng.uniform(3, 6, (n_out, 2)) *
                                               rng.choice([-1, 1], (n_out, 2))))
    valid = jnp.ones(n, bool)
    init = jnp.asarray([0.6, 0.2, 0.0])
    est = matcher.estimate_loop(cfg, init, f_mu, f_cov, valid, m_mu, m_cov, valid)
    np.testing.assert_allclose(np.asarray(est.pose), np.asarray(true_pose), atol=0.1)


def test_ndt_residual_2d_matches_numpy_oracle():
    """2-D non-intensity D2D residual (``ceres_residuals.h:421-451``):
    closed-form check against a dense numpy evaluation."""
    rng = np.random.default_rng(7)
    pose = np.array([0.7, -0.3, 0.4])
    m_mu, m_cov = _random_cells(rng, 12)
    f_mu, f_cov = _random_cells(rng, 12)
    got = np.asarray(R.ndt_residual_sq_2d(
        jnp.asarray(pose), m_mu, m_cov, f_mu, f_cov))
    c, s = np.cos(pose[2]), np.sin(pose[2])
    Rm = np.array([[c, -s], [s, c]])
    for i in range(12):
        d = Rm @ np.asarray(m_mu)[i, :2] + pose[:2] - np.asarray(f_mu)[i, :2]
        S = Rm @ np.asarray(m_cov)[i, :2, :2] @ Rm.T + np.asarray(f_cov)[i, :2, :2]
        want = float(d @ np.linalg.solve(S, d))
        np.testing.assert_allclose(got[i], want, rtol=2e-4)


def test_mahalanobis_position_matches_intensity_limit():
    """As the intensity variance grows with decoupled blocks, the 3-D cell
    distance converges to the 2-D position distance
    (``ndt_cell.cpp:165-176``)."""
    from randt_slam_tpu.ndt import cells as C

    rng = np.random.default_rng(3)
    mu_a, cov_a = _random_cells(rng, 8)
    mu_b, cov_b = _random_cells(rng, 8)
    big = 1e7
    cov_a = cov_a.at[:, 2, 2].set(big)
    cov_b = cov_b.at[:, 2, 2].set(big)
    d3 = np.asarray(C.mahalanobis_sq_intensity(mu_a, cov_a, mu_b, cov_b))
    d2 = np.asarray(C.mahalanobis_sq_position(mu_a, cov_a, mu_b, cov_b))
    np.testing.assert_allclose(d3, d2, rtol=1e-3)


def test_estimate_loop_non_intensity_variant():
    """``use_intensity_in_loop_closure: false`` solves the same alignment on
    position blocks only."""
    import dataclasses

    from randt_slam_tpu.config import LocalFuserConfig

    rng = np.random.default_rng(5)
    cfg = derive(SlamConfig(
        ndt_map=MapConfig(size_x=200, size_y=200, resolution=2.0),
        matcher=MatcherConfig(use_intensity_as_dimension=False),
        local_fuser=LocalFuserConfig(use_intensity_in_loop_closure=False),
    ))
    n = 60
    m_mu, m_cov = _random_cells(rng, n)
    true_pose = jnp.asarray([1.0, -0.6, 0.12])
    f_mu, f_cov = matcher.transform_mean_cov(true_pose, m_mu, m_cov)
    # Scramble intensity means of the fixed cells: the 2-D variant must not
    # care, proving the flag switches the residual.
    f_mu = f_mu.at[:, 2].set(jnp.asarray(rng.uniform(40, 120, n), jnp.float32))
    valid = jnp.ones(n, bool)
    init = jnp.asarray([0.7, -0.4, 0.05])
    est = matcher.estimate_loop(cfg, init, f_mu, f_cov, valid, m_mu, m_cov, valid)
    np.testing.assert_allclose(np.asarray(est.pose), np.asarray(true_pose),
                               atol=0.05)


def test_window_estimator_non_intensity_end_to_end():
    """Full synthetic odometry with ``use_intensity_as_dimension: false``:
    the pipeline must run and track."""
    import dataclasses

    from randt_slam_tpu.config import synthetic_config
    from randt_slam_tpu.io import formats, synthetic
    from randt_slam_tpu.pipeline import slam

    cfg = synthetic_config()
    cfg = dataclasses.replace(
        cfg,
        matcher=dataclasses.replace(cfg.matcher,
                                    use_intensity_as_dimension=False),
    )
    seq = synthetic.generate(seed=3, n_frames=24, n_azimuths=256, n_bins=256,
                             speed=4.0, dt=0.25)
    frames = slam.frames_from_arrays(
        seq.intensity, seq.azimuths, seq.ranges, seq.stamps
    )
    res = slam.run_odometry(cfg, frames, use_scan=True)
    err = formats.ate(res.odom_poses, seq.gt_poses[:24], align=True)
    assert np.isfinite(err) and err < 2.0, f"2-D variant diverged: ATE {err}"
