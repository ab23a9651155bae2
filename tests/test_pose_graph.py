import numpy as np
import jax.numpy as jnp

from randt_slam_tpu.config import GlobalFuserConfig
from randt_slam_tpu.graph import pose_graph as PG
from randt_slam_tpu import geometry as geo


def make_circle_graph(rng, n=30, drift=0.02, n_loops=3):
    """Ground truth on a circle; odometry edges with simulated drift; exact
    loop edges.  Classic PGO smoke problem."""
    gt = np.zeros((n, 3))
    for i in range(1, n):
        th = 2 * np.pi * i / n
        gt[i] = [10 * np.cos(th) - 10, 10 * np.sin(th), geo.normalize_angle(th + np.pi / 2)]
    gt[:, 2] = np.arctan2(np.sin(gt[:, 2]), np.cos(gt[:, 2]))

    # noisy odometry chain
    est = gt.copy()
    rels = []
    for i in range(1, n):
        rel = np.asarray(geo.relative(jnp.asarray(gt[i - 1]), jnp.asarray(gt[i])))
        noisy = rel + rng.normal(0, drift, 3)
        rels.append(noisy)
    for i in range(1, n):
        est[i] = np.asarray(geo.compose(jnp.asarray(est[i - 1]), jnp.asarray(rels[i - 1])))

    eb = list(range(n - 1))
    ee = list(range(1, n))
    et = [r for r in rels]
    ei = [np.diag([10.0, 10.0, 50.0])] * (n - 1)
    # exact loop closures to ground truth
    for k in range(n_loops):
        a, b = 0, n - 1 - k * 2
        rel = np.asarray(geo.relative(jnp.asarray(gt[a]), jnp.asarray(gt[b])))
        eb.append(a); ee.append(b); et.append(rel)
        ei.append(np.diag([30.0, 30.0, 30.0]))
    E = len(eb)
    g = PG.PoseGraph(
        poses=jnp.asarray(est, jnp.float32),
        id_begin=jnp.asarray(eb, jnp.int32),
        id_end=jnp.asarray(ee, jnp.int32),
        trans=jnp.asarray(np.stack(et), jnp.float32),
        sqrt_information=jnp.asarray(np.stack(ei), jnp.float32),
        valid=jnp.ones(E, bool),
    )
    return g, gt, est


def test_residual_zero_on_consistent_graph():
    rng = np.random.default_rng(0)
    g, gt, _ = make_circle_graph(rng, drift=0.0)
    r = PG.edge_residuals(jnp.asarray(gt, jnp.float32), g)
    np.testing.assert_allclose(np.asarray(r), 0.0, atol=1e-3)


def test_jacobians_match_autodiff():
    import jax
    rng = np.random.default_rng(1)
    g, gt, est = make_circle_graph(rng)
    poses = jnp.asarray(est, jnp.float32)

    def res_flat(p):
        return PG.edge_residuals(p.reshape(-1, 3), g).reshape(-1)

    J = jax.jacfwd(res_flat)(poses.reshape(-1)).reshape(len(g.id_begin), 3, -1, 3)
    Ja, Jb = PG._edge_jacobians(poses, g)
    for e in range(len(g.id_begin)):
        a, b = int(g.id_begin[e]), int(g.id_end[e])
        np.testing.assert_allclose(np.asarray(J[e, :, a]), np.asarray(Ja[e]),
                                   atol=2e-3, rtol=1e-3)
        np.testing.assert_allclose(np.asarray(J[e, :, b]), np.asarray(Jb[e]),
                                   atol=2e-3, rtol=1e-3)


def test_optimize_recovers_circle():
    rng = np.random.default_rng(2)
    g, gt, est = make_circle_graph(rng, n=40, drift=0.03, n_loops=4)
    drift_err = np.sqrt(np.mean(np.sum((est[:, :2] - gt[:, :2]) ** 2, axis=1)))
    poses, info = PG.optimize(g, GlobalFuserConfig())
    poses = np.asarray(poses)
    opt_err = np.sqrt(np.mean(np.sum((poses[:, :2] - gt[:, :2]) ** 2, axis=1)))
    assert opt_err < 0.4 * drift_err, (drift_err, opt_err)
    # gauge: node 0 unchanged
    np.testing.assert_allclose(poses[0], est[0], atol=1e-6)


def test_max_update_index_filters_loop_edges():
    rng = np.random.default_rng(3)
    g, gt, est = make_circle_graph(rng, n=20, drift=0.05, n_loops=2)
    # exclude all loop edges -> result equals odometry-only optimization,
    # which (chain + gauge fix) keeps the initial guess
    poses, _ = PG.optimize(g, GlobalFuserConfig(), max_update_index=0)
    np.testing.assert_allclose(np.asarray(poses), est, atol=2e-2)


def test_recover_covariances_chain_growth():
    """Marginal covariance grows along an odometry chain and is zero at the
    gauge-fixed node (the reference's commented-out ceres::Covariance path,
    ``global_fuser.cpp:62-87``)."""
    import jax.numpy as jnp
    import numpy as np

    from randt_slam_tpu.config import GlobalFuserConfig
    from randt_slam_tpu.graph import pose_graph as PG

    N = 5
    poses = jnp.asarray(
        np.cumsum(np.tile([1.0, 0.0, 0.0], (N, 1)), 0), jnp.float32
    )
    g = PG.PoseGraph(
        poses=poses,
        id_begin=jnp.arange(N - 1, dtype=jnp.int32),
        id_end=jnp.arange(1, N, dtype=jnp.int32),
        trans=jnp.tile(jnp.asarray([1.0, 0.0, 0.0]), (N - 1, 1)),
        sqrt_information=jnp.tile(jnp.eye(3), (N - 1, 1, 1)),
        valid=jnp.ones(N - 1, bool),
    )
    cov = np.asarray(PG.recover_covariances(g, poses, GlobalFuserConfig()))
    assert np.allclose(cov[0], 0.0)
    sx = cov[:, 0, 0]
    assert np.all(np.diff(sx[1:]) > 0), sx
    np.testing.assert_allclose(sx[1], 1.0, rtol=1e-4)


def _outlier_loop_graph(rng, n=400, drift=0.01):
    """Replica of the acceptance-run failure mode (10-12-32): a drifting
    chain, a dense cluster of accurate loop closures late in the trajectory,
    and ONE gross outlier loop edge bridging an otherwise unconstrained early
    region — exactly the topology where a single bad edge warps the graph."""
    g, gt, est = make_circle_graph(rng, n=n, drift=drift, n_loops=0)
    eb = list(np.asarray(g.id_begin))
    ee = list(np.asarray(g.id_end))
    et = list(np.asarray(g.trans))
    ei = list(np.asarray(g.sqrt_information))
    loop_sqrtI = np.diag([1.0, 1.0, 0.1])
    for a, b in [(n - 120 + 7 * k, n - 60 + 7 * k) for k in range(8)]:
        rel = np.asarray(geo.relative(jnp.asarray(gt[a]), jnp.asarray(gt[b])))
        eb.append(a); ee.append(b); et.append(rel); ei.append(loop_sqrtI)
    # the outlier: inside the loop-pinned late region, 4 m off in
    # translation — the good loops hold the truth, so the outlier's residual
    # survives at the least-squares optimum and IRLS can identify it
    a, b = n - 115, n - 55
    rel = np.array(geo.relative(jnp.asarray(gt[a]), jnp.asarray(gt[b])))
    rel[:2] += [3.0, -2.6]
    eb.append(a); ee.append(b); et.append(rel); ei.append(loop_sqrtI)
    E = len(eb)
    bad = PG.PoseGraph(
        poses=jnp.asarray(est, jnp.float32),
        id_begin=jnp.asarray(eb, jnp.int32),
        id_end=jnp.asarray(ee, jnp.int32),
        trans=jnp.asarray(np.stack(et), jnp.float32),
        sqrt_information=jnp.asarray(np.stack(ei), jnp.float32),
        valid=jnp.ones(E, bool),
    )
    return bad, gt


def test_dcs_two_stage_suppresses_outlier_loop():
    """Robust-PGO extension: DCS on loop edges only, two-stage.
    The quadratic solve is visibly corrupted by the outlier; the robust solve
    must land near ground truth (reference has only all-edge Huber,
    ``global_fuser.cpp:17-23``, and runs Oxford with it off).

    NOTE the topology: the outlier must land in a region pinned by good
    loops.  An outlier bridging an otherwise-unconstrained arc is ABSORBED
    by the least-squares optimum (its residual goes small while the arc
    bends) and no residual-based kernel can find it — that case is what the
    odometry-consistency gate (``loops/detector.py::odom_consistency_gate``)
    exists for, tested in test_loops.py."""
    from randt_slam_tpu.graph import schur

    rng = np.random.default_rng(7)
    n = 400
    g, gt = _outlier_loop_graph(rng, n=n)

    def window_ate(poses):
        # error over the loop-pinned window, expressed RELATIVE to its first
        # node (the good loops define local truth there; global gauge drift
        # from the unconstrained early arc is common to both solves)
        w = slice(n - 130, n - 40)
        p = np.asarray(poses)
        rel_p = p[w, :2] - p[n - 130, :2]
        rel_g = gt[w, :2] - gt[n - 130, :2]
        return float(np.sqrt((np.linalg.norm(rel_p - rel_g, axis=1) ** 2)
                             .mean()))

    # dcs_loop_defense is the SHIPPED default now — turn it off to get the
    # truly quadratic baseline this test contrasts against
    plain, _ = schur.optimize_auto(g, GlobalFuserConfig(dcs_loop_defense=False))
    robust_cfg = GlobalFuserConfig(
        use_robust_loss=True, loss_function_scale=1.0, robust_kernel="dcs",
        robust_loop_edges_only=True, robust_two_stage=True)
    robust, info = schur.optimize_auto(g, robust_cfg)
    assert info["two_stage"]
    # oracle: the same solve with the outlier edge simply removed
    oracle, _ = schur.optimize_auto(
        g._replace(valid=g.valid.at[-1].set(False)),
        GlobalFuserConfig(dcs_loop_defense=False))
    p, r, o = window_ate(plain), window_ate(robust), window_ate(oracle)
    assert r < 0.8 * p, (p, r, o)          # clearly better than quadratic
    assert r < 1.15 * o + 0.05, (p, r, o)  # and ~at the outlier-free optimum


def test_huber_all_edges_reference_parity_still_works():
    """The reference-shaped knob (Huber, all edges, single stage) still
    optimizes a clean graph to the same solution as the quadratic solve."""
    rng = np.random.default_rng(3)
    g, gt, _ = make_circle_graph(rng, n=40, drift=0.01, n_loops=3)
    plain, _ = PG.optimize(g, GlobalFuserConfig(dcs_loop_defense=False))
    hub, _ = PG.optimize(g, GlobalFuserConfig(
        dcs_loop_defense=False,
        use_robust_loss=True, loss_function_scale=750.0))
    np.testing.assert_allclose(np.asarray(plain), np.asarray(hub), atol=1e-2)


def test_optimize_bucketed_matches_unpadded():
    """The shape-bucketed dense wrapper (online PGO ticks) must return the
    unpadded solve's solution bit-for-bit-close: padded nodes are gauge-fixed
    and padded edges invalid, so they cannot influence the optimum."""
    rng = np.random.default_rng(11)
    g, gt, _ = make_circle_graph(rng, n=37, drift=0.02, n_loops=3)
    cfg = GlobalFuserConfig(dcs_loop_defense=False)
    ref, _ = PG.optimize(g, cfg)
    buck, _ = PG.optimize_bucketed(g, cfg, bucket_nodes=16, bucket_edges=32)
    assert buck.shape == ref.shape
    np.testing.assert_allclose(np.asarray(buck), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)
    # max_update_index gating matches optimize's
    ref2, _ = PG.optimize(g, cfg, max_update_index=10)
    buck2, _ = PG.optimize_bucketed(g, cfg, max_update_index=10,
                                    bucket_nodes=16, bucket_edges=32)
    np.testing.assert_allclose(np.asarray(buck2), np.asarray(ref2),
                               rtol=1e-4, atol=1e-4)
