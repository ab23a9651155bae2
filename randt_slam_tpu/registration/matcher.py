"""Sliding-window scan-to-submap registration (the reference ``Matcher``).

Re-architecture of ``RS/src/ndt_registration/ndt_matcher.cpp`` as batched
array code:

* ``predictTransform`` (:22-59)        -> :func:`predict_next_state`
* ``estimateTransformCeres`` (:322-424)-> :func:`estimate_window`
* ``estimateLoopConstraint`` (:426-493)-> :func:`estimate_loop`

The window problem is fully batched: data association (once per frame, as in
the reference, which builds the ceres::Problem once and re-solves it through
the GNC schedule) gathers fixed-map neighbors for every (window slot, fixed
map, moving cell); the residual vector and its forward-mode Jacobian then have
one fixed shape per config and the whole GNC x LM iteration runs inside jit.

Window parameter layout: params (W+1, 9) where row 0 is the anchor state
(pose constant, velocities free — ``addMotionParameterBlock(..., true)`` only
fixes the pose block, ``ndt_matcher.cpp:290-313``) and rows 1..W are the
active states, row W the current frame.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SlamConfig
from ..geometry import compose, normalize_angle, rotmat
from ..ndt import grid as G
from . import residuals as R
from . import solver


class ScanWindow(NamedTuple):
    """Derived NDT fields of the last W scans (moving maps), base frame.

    Slot W-1 is the current scan; slot j pairs with window state j+1.
    """

    mean: jax.Array   # (W, C, 3)
    cov: jax.Array    # (W, C, 3, 3)
    valid: jax.Array  # (W, C)


class FixedMaps(NamedTuple):
    """Derived fields of the fixed NDT maps (current submap + optional
    previous submap transformed into the current frame,
    ``local_fuser.cpp:128-136``).  Sparse storage: a dense int32 index grid
    per map plus compact derived-field tables."""

    index: tuple       # F-tuple of (H, W) int32 index grids (-1 = empty);
                       # kept unstacked so the (H, W) grids are not copied
                       # into a fresh (F, H, W) buffer every frame
    mean: jax.Array    # (F, S, 3)
    cov: jax.Array     # (F, S, 3, 3)
    valid: jax.Array   # (F, S)
    use: jax.Array     # (F,) bool — second map only during submap overlap


def transform_mean_cov(pose, mean, cov):
    """Rigid transform of cell distributions: mu' = R3 mu + t3,
    cov' = R3 cov R3^T (``Cell::transformCell``, ``ndt_cell.cpp:117-123``).
    pose (..., 3) broadcast against mean (..., C, 3)."""
    th = pose[..., 2]
    R2 = rotmat(th)
    dt = mean.dtype
    z = jnp.zeros(pose.shape[:-1] + (2, 1), dt)
    top = jnp.concatenate([R2, z], axis=-1)
    bot = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], dt), pose.shape[:-1] + (1, 3))
    A = jnp.concatenate([top, bot], axis=-2)
    t3 = jnp.concatenate([pose[..., :2], jnp.zeros(pose.shape[:-1] + (1,), dt)], -1)
    mu = jnp.einsum("...ij,...cj->...ci", A, mean) + t3[..., None, :]
    cv = jnp.einsum("...ij,...cjk,...lk->...cil", A, cov, A)
    return mu, cv


def predict_next_state(state, raw_dt, use_constant_velocity: bool):
    """``Matcher::predictTransform``: constant-velocity/acceleration rollout
    of the newest state.  The reference zeroes lin_acc before predicting
    (``ndt_matcher.cpp:26``)."""
    s = state
    if True:  # the reference always zeroes acceleration for the prediction
        s = s.at[..., R.AX].set(0.0).at[..., R.AY].set(0.0)
    return R.predict_state(s, raw_dt)


class WindowEstimate(NamedTuple):
    states: jax.Array      # (W+1, 9) updated window states
    rejected: jax.Array    # bool — pose-jump rejection fired
    cost: jax.Array
    n_residuals: jax.Array


def estimate_window(
    cfg: SlamConfig,
    states,        # (W+1, 9) anchor + active states (newest = predicted)
    stamps,        # (W+1,)
    state_exists,  # (W+1,) bool — False for slots before trajectory start
    imu_meas,      # (W,) relative yaw measurements per transition
    scans: ScanWindow,
    fixed: FixedMaps,
    prior_pose,    # (3,) pose-jump rejection reference (pre-prediction pose)
    use_structured_linearizer: bool = True,
):
    """One frame of the sliding-window smoother (``estimateTransformCeres``)."""
    mcfg = cfg.matcher
    W = mcfg.smoothing_steps
    K = mcfg.n_results_nn_lookup
    geom = G.GridGeom.from_config(cfg.ndt_map)
    dtype = states.dtype
    # ``use_intensity_as_dimension`` selects the 3-D vs 2-D D2D residual and
    # the NN metric: the reference's non-intensity path always looks up by
    # Euclidean position (``ndt_matcher.cpp:252-257``).
    use_int = bool(mcfg.use_intensity_as_dimension)
    lookup_dist = bool(mcfg.lookup_distribution) and use_int

    # ---- data association (once per frame, at current estimates) ----------
    # Query cells of window slot j (state row j, scan slot j-1), transformed
    # by that state's pose (``ndt_matcher.cpp:206-214``).
    poses = states[1:, :3]  # (W, 3)
    q_mu, q_cov = transform_mean_cov(poses, scans.mean, scans.cov)  # (W, C, ...)

    C = scans.mean.shape[1]
    Fn = fixed.mean.shape[0]
    radius = cfg.ndt_map.nn_window_radius

    # Static loop over fixed maps (keeps the (H, W) index grids unstacked),
    # vmap over window slots.
    per_map = []
    for f in range(Fn):
        nb = jax.vmap(
            lambda qm, qc, qv, f=f: G.window_neighbors_sparse(
                geom, fixed.index[f], fixed.mean[f], fixed.cov[f],
                fixed.valid[f], qm, qc, qv, K, radius,
                use_distribution_metric=lookup_dist,
            )
        )(q_mu.reshape(W, C, 3), q_cov.reshape(W, C, 3, 3), scans.valid)
        per_map.append(nb)
    assoc = jax.tree.map(lambda *a: jnp.stack(a, axis=1), *per_map)  # (W,F,...)
    # assoc.*: (W, F, C, K, ...)
    # Window size shrinks early in a submap: the anchor (pose-constant) state
    # is the OLDEST existing state, mirroring
    # ``smoothing_steps_iter = min(trajectory.size()-1, smoothing_steps)``
    # (``ndt_matcher.cpp:343-356``).  Row indices run 0..W; rows <= anchor_row
    # contribute no NDT/motion factors.
    n_exist = jnp.sum(state_exists.astype(jnp.int32))
    anchor_row = (W + 1) - n_exist  # in [0, W]
    rows = jnp.arange(W + 1)
    slot_active = rows[1:] > anchor_row  # (W,) NDT/motion factor slots
    pair_valid = (
        assoc.valid
        & fixed.use[None, :, None, None]
        & slot_active[:, None, None, None]
    )

    # Benign values for invalid (padded) moving cells: keeps Jacobians finite
    # in float32 (their pair weights are zero).
    eye3 = jnp.eye(3, dtype=scans.cov.dtype)
    safe_mean = jnp.where(scans.valid[..., None], scans.mean, 0.0)
    safe_cov = jnp.where(scans.valid[..., None, None], scans.cov, eye3)
    m_mean_b = jnp.broadcast_to(
        safe_mean[:, None, :, None, :], (W, Fn, C, K, 3)
    )
    m_cov_b = jnp.broadcast_to(
        safe_cov[:, None, :, None, :, :], (W, Fn, C, K, 3, 3)
    )

    # ---- residual function over flattened params ---------------------------
    sqrtI = (
        jnp.asarray(np.asarray(mcfg.motion_sqrt_information), dtype)
        * mcfg.covariance_scaling_factor
    )
    dts = stamps[1:] - stamps[:-1]  # (W,)

    def residual_fn(p_flat):
        p = p_flat.reshape(W + 1, 9)
        pose_w = p[1:, :3]  # (W, 3)
        r_ndt = R.ndt_residual(
            pose_w[:, None, None, None, :], m_mean_b, m_cov_b,
            assoc.mean, assoc.cov, use_intensity=use_int,
        )  # (W, F, C, K)
        r_mot = jax.vmap(R.motion_residual, in_axes=(0, 0, 0, None))(
            p[:-1], p[1:], dts, sqrtI
        )  # (W, 8)
        r_imu = jax.vmap(R.imu_residual, in_axes=(0, 0, 0, 0, None, None))(
            p[:-1], p[1:], dts, imu_meas, mcfg.weight_imu, mcfg.weight_imu_bias
        )  # (W, 2)
        return r_ndt.reshape(-1), jnp.concatenate([r_mot.reshape(-1), r_imu.reshape(-1)])

    ndt_valid = pair_valid.reshape(-1)
    trans_active = slot_active  # transition into row j exists iff j > anchor
    mot_valid = jnp.repeat(trans_active, 8)
    imu_valid = jnp.repeat(trans_active & bool(mcfg.use_imu), 2)
    aux_valid = jnp.concatenate([mot_valid, imu_valid])

    # ---- parameter masks ----------------------------------------------------
    # Anchor row: pose fixed but velocities free
    # (``addMotionParameterBlock(..., set_constant=true)`` only pins the pose
    # block, ``ndt_matcher.cpp:290-313``); anchor bias constant (:352);
    # acceleration frozen under the constant-velocity model (:301-303);
    # bias active only with IMU; non-existing rows fully frozen.
    per_state = np.ones(9, bool)
    per_state[R.AX] = per_state[R.AY] = not mcfg.use_constant_velocity_model
    per_state[R.BIAS] = bool(mcfg.use_imu)
    static_mask = jnp.asarray(np.tile(per_state, (W + 1, 1)))  # (W+1, 9)
    pose_cols = jnp.asarray(
        np.isin(np.arange(9), [R.X, R.Y, R.TH])
    )
    is_anchor = rows == anchor_row  # (W+1,)
    anchor_frozen = is_anchor[:, None] & (pose_cols | (jnp.arange(9) == R.BIAS))[None, :]
    active_mask = (
        static_mask & ~anchor_frozen & state_exists[:, None]
    ).reshape(-1)
    angle_mask = jnp.tile(
        jnp.asarray(np.eye(1, 9, R.TH, dtype=bool)[0]), W + 1
    )

    n_cells = jnp.sum(
        jnp.where(slot_active[:, None], scans.valid, False).astype(dtype)
    )
    ndt_scale = mcfg.ndt_weight / jnp.maximum(n_cells * K, 1.0)

    # ---- structured linearizer ---------------------------------------------
    # Each NDT residual depends only on the 3 pose params of its window slot;
    # compute its Jacobian with 3 forward tangents per slot (vmapped) and
    # scatter per-slot 3x3 JᵀWJ blocks into the (P, P) normal equations —
    # replacing the dense jacfwd over all (W+1)*9 params.  Aux (motion/IMU)
    # residuals are few; their dense jacfwd is negligible.
    from . import barron

    active_f = active_mask.astype(dtype)
    scale_ = mcfg.loss_function_scale
    alpha_ = mcfg.loss_function_convexity

    def aux_fn(p_flat):
        p = p_flat.reshape(W + 1, 9)
        r_mot = jax.vmap(R.motion_residual, in_axes=(0, 0, 0, None))(
            p[:-1], p[1:], dts, sqrtI
        )
        r_imu = jax.vmap(R.imu_residual, in_axes=(0, 0, 0, 0, None, None))(
            p[:-1], p[1:], dts, imu_meas, mcfg.weight_imu, mcfg.weight_imu_bias
        )
        return jnp.concatenate([r_mot.reshape(-1), r_imu.reshape(-1)])

    def slot_residual(pose, mm, mc, am, ac):
        return R.ndt_residual(pose[None, None, None, :], mm, mc, am, ac,
                              use_intensity=use_int)  # (F,C,K)

    def linearize_fn(p_flat, mu):
        p = p_flat.reshape(W + 1, 9)
        poses_w = p[1:, :3]

        def slot_rj(pose, mm, mc, am, ac):
            r = slot_residual(pose, mm, mc, am, ac)
            Jp = jax.jacfwd(slot_residual)(pose, mm, mc, am, ac)
            return r, Jp

        r_ndt, Jn = jax.vmap(slot_rj)(
            poses_w, m_mean_b, m_cov_b, assoc.mean, assoc.cov
        )  # (W,F,C,K), (W,F,C,K,3)
        w_ndt = ndt_scale * barron.weight(r_ndt * r_ndt, scale_, alpha_, mu)
        w_ndt = jnp.where(pair_valid, w_ndt, 0.0)
        # Normal equations need full float32 (not a reduced-precision matmul
        # pass): conditioning of H decides the step quality.
        hp = jax.lax.Precision.HIGHEST
        Hj = jnp.einsum("wfck,wfcki,wfckj->wij", w_ndt, Jn, Jn, precision=hp)
        gj = jnp.einsum("wfck,wfcki->wi", w_ndt * r_ndt, Jn, precision=hp)

        ra = aux_fn(p_flat)
        Ja = jax.jacfwd(aux_fn)(p_flat)  # (Na, P) — Na ~ 10*W, tiny
        wa = jnp.where(aux_valid, 1.0, 0.0).astype(dtype)
        Jm = Ja * active_f[None, :]
        JW = Jm * wa[:, None]
        H = jnp.einsum("ni,nj->ij", Jm, JW, precision=hp)
        g = jnp.einsum("ni,n->i", JW, ra, precision=hp)
        for j in range(W):
            o = 9 * (j + 1)
            af = active_f[o:o + 3]
            H = H.at[o:o + 3, o:o + 3].add(Hj[j] * af[:, None] * af[None, :])
            g = g.at[o:o + 3].add(gj[j] * af)
        return H, g

    res = solver.gnc_solve(
        residual_fn,
        states.reshape(-1),
        active_mask,
        angle_mask,
        ndt_valid,
        aux_valid,
        ndt_scale,
        mcfg.loss_function_scale,
        mcfg.loss_function_convexity,
        mcfg.gnc_steps,
        mcfg.gnc_control_parameter_divisor,
        mcfg.lm_max_iterations,
        mcfg.lm_tolerance,
        linearize_fn=linearize_fn if use_structured_linearizer else None,
        lm_ftol=mcfg.lm_function_tolerance,
    )
    new_states = res.params.reshape(W + 1, 9)

    # ---- pose-jump rejection (``ndt_matcher.cpp:411-422``) -----------------
    newest = new_states[-1]
    dx = jnp.abs(newest[R.X] - prior_pose[0])
    dy = jnp.abs(newest[R.Y] - prior_pose[1])
    dth = jnp.abs(normalize_angle(newest[R.TH] - prior_pose[2]))
    reject = (
        (dx > mcfg.pose_reject_translation)
        | (dy > mcfg.pose_reject_translation)
        | (dth > mcfg.pose_reject_rotation)
    )
    prev = new_states[-2]
    fallback = (
        newest
        .at[R.X].set(prev[R.X]).at[R.Y].set(prev[R.Y]).at[R.TH].set(prev[R.TH])
        .at[R.VX].set(0.0).at[R.VY].set(0.0).at[R.OM].set(0.0)
        .at[R.AX].set(0.0).at[R.AY].set(0.0)
        .at[R.BIAS].set(prev[R.BIAS])
    )
    new_states = new_states.at[-1].set(jnp.where(reject, fallback, newest))

    return WindowEstimate(
        states=new_states,
        rejected=reject,
        cost=res.cost,
        n_residuals=res.n_ndt_valid,
    )


def global_grid_search(
    cfg: SlamConfig,
    init_pose,
    f_mean, f_cov, f_valid,
    m_mean, m_cov, m_valid,
    search_window_linear=None,
    search_window_angular=None,
    beam_width: int = 16,
    use_intensity=None,
):
    """Correlative-scan-matching global search
    (``Matcher::estimateTransformGlobalBNB``, ``ndt_matcher.cpp:495-608``).

    The reference walks a work queue of (pose, level) tuples, pruning by a
    cost threshold.  This build scores the ENTIRE coarsest grid as one
    batch, then runs ``csm_n_iter`` refinement levels keeping the
    ``beam_width`` best candidates and expanding each into its 3x3x3
    half-step neighborhood — a dense beam search covering the same candidate
    set with fixed shapes.  Scoring matches the reference: robust Barron cost
    (no GNC, :517) averaged over residual pairs, with association made ONCE
    at the center pose (:520).

    ``csm_cost_threshold`` pruning (``ndt_matcher.cpp:544-561``): candidates
    at or above the threshold are never expanded, and the returned optimum is
    taken only over below-threshold candidates.  If NO candidate ever scores
    below the threshold the reference returns an identity transform and cost
    1e5; here the initial pose and cost ``inf`` are returned instead
    (documented deviation — the identity return is a reference quirk that
    discards the initial guess entirely).
    """
    mcfg = cfg.matcher
    if use_intensity is None:
        use_intensity = bool(mcfg.use_intensity_as_dimension)
    win_l = mcfg.csm_window_linear if search_window_linear is None else min(
        search_window_linear, mcfg.csm_window_linear)
    win_a = mcfg.csm_window_angular if search_window_angular is None else min(
        search_window_angular, mcfg.csm_window_angular)
    lin_step = mcfg.csm_linear_step
    ang_step = float(np.arccos(
        1.0 - (lin_step * lin_step) / (2.0 * mcfg.csm_max_px_accurate_range ** 2)
    ))
    n_iter = mcfg.csm_n_iter
    K = 4  # fixed neighbor count of the reference's CSM association (:520)

    q_mu, q_cov = transform_mean_cov(init_pose, m_mean, m_cov)
    # Association happens once at the window center; the cutoff must cover
    # cells reachable anywhere inside the search window.
    cutoff = (cfg.ndt_map.nn_window_radius + 0.5) * cfg.ndt_map.resolution
    cutoff = max(cutoff, 0.5 * win_l + cfg.ndt_map.resolution)
    assoc = G.allpairs_neighbors(
        f_mean, f_cov, f_valid, q_mu, q_cov, m_valid, K, cutoff,
        use_distribution_metric=bool(mcfg.lookup_distribution) and use_intensity,
    )
    pair_valid = assoc.valid
    eye3 = jnp.eye(3, dtype=m_cov.dtype)
    safe_mean = jnp.where(m_valid[..., None], m_mean, 0.0)
    safe_cov = jnp.where(m_valid[..., None, None], m_cov, eye3)
    m_mu_b = jnp.broadcast_to(safe_mean[:, None, :], assoc.mean.shape)
    m_cov_b = jnp.broadcast_to(safe_cov[:, None, :, :], assoc.cov.shape)
    n_pairs = jnp.maximum(jnp.sum(pair_valid), 1)

    from . import barron

    def score(poses):  # (B, 3) -> (B,) mean robust cost
        r = R.ndt_residual(
            poses[:, None, None, :], m_mu_b[None], m_cov_b[None],
            assoc.mean[None], assoc.cov[None], use_intensity=use_intensity,
        )
        rho = barron.rho(r * r, mcfg.loss_function_scale,
                         mcfg.loss_function_convexity, 1.0)
        c = jnp.sum(jnp.where(pair_valid[None], rho, 0.0), axis=(1, 2))
        return 0.5 * c / n_pairs  # Ceres cost convention (0.5 sum rho)

    # coarsest level grid around init_pose
    step0 = (2.0 ** (n_iter - 1)) * lin_step
    nx = max(1, int(win_l / step0)) + 1
    na = max(1, int(win_a / ang_step))
    txs = jnp.linspace(-win_l / 2.0, win_l / 2.0, nx)
    angs = -win_a / 2.0 + jnp.arange(na) * ang_step
    TX, TY, AA = jnp.meshgrid(txs, txs, angs, indexing="ij")
    local = jnp.stack([TX.reshape(-1), TY.reshape(-1), AA.reshape(-1)], axis=-1)
    cands = compose(init_pose[None, :], local)
    costs = score(cands)

    thresh = jnp.asarray(mcfg.csm_cost_threshold, costs.dtype)

    def fold_best(best_pose, best_cost, cands, costs):
        """Running optimum over below-threshold candidates only."""
        masked = jnp.where(costs < thresh, costs, jnp.inf)
        i = jnp.argmin(masked)
        take = masked[i] < best_cost
        return (
            jnp.where(take, cands[i], best_pose),
            jnp.minimum(masked[i], best_cost),
        )

    best_pose, best_cost = fold_best(
        init_pose, jnp.asarray(jnp.inf, costs.dtype), cands, costs
    )

    offs = jnp.asarray(
        [[dx, dy, da] for dx in (-1.0, 0.0, 1.0) for dy in (-1.0, 0.0, 1.0)
         for da in (-1.0, 0.0, 1.0)]
    )
    for level in range(1, n_iter + 1):
        # Only below-threshold candidates may seed expansions (:544).
        expandable = jnp.where(costs < thresh, costs, jnp.inf)
        top_c, top_i = jax.lax.top_k(
            -expandable, min(beam_width, costs.shape[0])
        )
        parent_ok = jnp.isfinite(top_c)
        best = cands[top_i]
        step = (2.0 ** max(n_iter - 1 - level, -1)) * lin_step
        local = offs * jnp.asarray([step, step, ang_step])
        cands = compose(best[:, None, :], local[None, :, :]).reshape(-1, 3)
        costs = score(cands)
        costs = jnp.where(
            jnp.repeat(parent_ok, offs.shape[0]), costs, jnp.inf
        )
        best_pose, best_cost = fold_best(best_pose, best_cost, cands, costs)

    return best_pose, best_cost


class LoopEstimate(NamedTuple):
    pose: jax.Array
    mean_cost: jax.Array   # final robust cost / residual count (diagnostic,
                           # mirrors ``estimateLoopConstraint``'s return)
    n_pairs: jax.Array


def estimate_loop(
    cfg: SlamConfig,
    init_pose,                       # (3,) initial relative transform
    f_mean, f_cov, f_valid,          # compacted fixed submap cells (F, ...)
    m_mean, m_cov, m_valid,          # moving scan cells (C, ...)
):
    """Single-pose GNC refinement of a loop-closure candidate
    (``Matcher::estimateLoopConstraint``, ``ndt_matcher.cpp:426-493``).

    The fixed submap is compacted (flat cell list), so association is a
    masked all-pairs top-k with the search-window L-inf cutoff.  The loop
    path uses ``use_intensity_in_loop_closure`` for the residual/lookup
    variant (``local_fuser.cpp:335``), cascading from
    ``use_intensity_as_dimension`` when unset.
    """
    mcfg = cfg.matcher
    lcfg = cfg.local_fuser
    K = mcfg.n_results_nn_lookup
    use_int = bool(lcfg.use_intensity_in_loop_closure)

    q_mu, q_cov = transform_mean_cov(init_pose, m_mean, m_cov)
    cutoff = (cfg.ndt_map.nn_window_radius + 0.5) * cfg.ndt_map.resolution
    assoc = G.allpairs_neighbors(
        f_mean, f_cov, f_valid, q_mu, q_cov, m_valid, K, cutoff,
        use_distribution_metric=bool(mcfg.lookup_distribution) and use_int,
    )
    pair_valid = assoc.valid.reshape(-1)
    eye3 = jnp.eye(3, dtype=m_cov.dtype)
    safe_mean = jnp.where(m_valid[..., None], m_mean, 0.0)
    safe_cov = jnp.where(m_valid[..., None, None], m_cov, eye3)
    m_mu_b = jnp.broadcast_to(safe_mean[:, None, :], assoc.mean.shape)
    m_cov_b = jnp.broadcast_to(safe_cov[:, None, :, :], assoc.cov.shape)

    def residual_fn(pose):
        r = R.ndt_residual(
            pose[None, None, :], m_mu_b, m_cov_b, assoc.mean, assoc.cov,
            use_intensity=use_int,
        )
        return r.reshape(-1), jnp.zeros((1,), pose.dtype)

    res = solver.gnc_solve(
        residual_fn,
        init_pose,
        jnp.ones(3, bool),
        jnp.asarray([False, False, True]),
        pair_valid,
        jnp.zeros(1, bool),
        jnp.asarray(1.0, init_pose.dtype),   # ScaledLoss weight 1 (:479)
        lcfg.loop_closure_scale,
        mcfg.loss_function_convexity,
        lcfg.loop_closure_gnc_steps,
        mcfg.gnc_control_parameter_divisor,
        mcfg.lm_max_iterations,
        mcfg.lm_tolerance,
        lm_ftol=mcfg.lm_function_tolerance,
    )
    n = jnp.maximum(res.n_ndt_valid, 1)
    return LoopEstimate(pose=res.params, mean_cost=res.cost / n, n_pairs=res.n_ndt_valid)
