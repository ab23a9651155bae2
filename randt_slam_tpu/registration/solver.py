"""Batched Levenberg-Marquardt with Barron-loss graduated non-convexity.

Replaces the reference's Ceres solve loop (``Matcher::estimateTransformCeres``,
``RS/src/ndt_registration/ndt_matcher.cpp:322-424``): instead of a dynamically
assembled ceres::Problem re-solved per GNC step with LM trust regions, this
build evaluates ALL residuals as one fixed-shape batch, takes exact forward-
mode Jacobians (``jax.jacfwd``), applies the robust loss as IRLS weights
(rho'(s) — see ``barron.py``), and solves the tiny dense normal equations on
device.  The GNC mu schedule (``ndt_matcher.cpp:386-397``) runs as a
``lax.while_loop`` around the LM ``lax.while_loop`` — no host round trips.

Problem shape: parameter vector p (P,), two residual families:
  * NDT residuals  (robustified + ScaledLoss factor ``ndt_scale`` =
    ndt_weight / (n_cells * n_neighbours), ``ndt_matcher.cpp:392``)
  * auxiliary residuals (motion model / IMU; unit loss)
Masks select valid residuals and active parameters; invalid entries carry
zero weight so padded shapes never affect the solution.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import normalize_angle
from ..ops.spd_solve import spd_solve
from . import barron


class SolveResult(NamedTuple):
    params: jax.Array
    cost: jax.Array          # final robust cost: 0.5*(a*sum rho + sum r_aux^2)
    n_ndt_valid: jax.Array   # number of active NDT residuals
    gnc_rounds: jax.Array


def _robust_cost(r_ndt, r_aux, ndt_valid, aux_valid, ndt_scale, scale, alpha, mu):
    s = r_ndt * r_ndt
    c_ndt = jnp.sum(jnp.where(ndt_valid, barron.rho(s, scale, alpha, mu), 0.0))
    c_aux = jnp.sum(jnp.where(aux_valid, r_aux * r_aux, 0.0))
    return 0.5 * (ndt_scale * c_ndt + c_aux)


def solve_damped(A, b):
    """Solve the damped, Jacobi-scaled SPD normal equations: one Pallas
    kernel on CUDA devices (``ops/spd_solve.py``), XLA's LU elsewhere.  The
    choice is made per device when the computation is lowered."""
    return jax.lax.platform_dependent(A, b, cuda=spd_solve,
                                      default=jnp.linalg.solve)


def lm_solve(
    residual_fn: Callable,
    params0,
    active_mask,
    angle_mask,
    ndt_valid,
    aux_valid,
    ndt_scale,
    scale: float,
    alpha: float,
    mu,
    max_iters: int,
    tol: float,
    linearize_fn: Callable | None = None,
    ftol: float = 1e-6,
):
    """Damped Gauss-Newton (LM) at a fixed GNC mu.

    residual_fn(params) -> (r_ndt (Nn,), r_aux (Na,)).

    ``linearize_fn(params, mu) -> (H (P, P), g (P,))`` optionally supplies the
    IRLS-weighted normal equations directly.  The window estimator uses this
    to exploit block structure: each NDT residual depends on 3 pose params of
    one window slot, so its Jacobian needs 3 forward tangents (not all P=36)
    and Hᵀ assembly is a per-slot 3x3 block scatter — ~12x less jvp work than
    the dense ``jacfwd`` default.
    """
    P = params0.shape[0]
    active_f = active_mask.astype(params0.dtype)

    def stacked(p):
        rn, ra = residual_fn(p)
        return jnp.concatenate([rn, ra])

    n_ndt = ndt_valid.shape[0]

    def cost_at(p):
        rn, ra = residual_fn(p)
        return _robust_cost(rn, ra, ndt_valid, aux_valid, ndt_scale, scale, alpha, mu)

    def _dense_linearize(p, mu_):
        r = stacked(p)
        J = jax.jacfwd(stacked)(p)  # (N, P)
        rn = r[:n_ndt]
        w_ndt = ndt_scale * barron.weight(rn * rn, scale, alpha, mu_)
        w = jnp.concatenate(
            [
                jnp.where(ndt_valid, w_ndt, 0.0),
                jnp.where(aux_valid, 1.0, 0.0),
            ]
        )
        Jm = J * active_f[None, :]
        JW = Jm * w[:, None]
        return Jm.T @ JW, JW.T @ r

    lin = linearize_fn if linearize_fn is not None else _dense_linearize

    @jax.named_scope("lm_iter")
    def body(carry):
        p, lam, c_old, it, done = carry
        H, g = lin(p, mu)
        # Jacobi-scale the normal equations before solving: curvatures span
        # ~10 decades (NDT pose terms ~1e4, the newest state's velocity rows
        # ~1e-6), and an unscaled float32 solve leaks error into the weak
        # directions — observed as the newest angular velocity jumping to
        # arbitrary values, which then poisons the next frame's prediction.
        # Ceres applies the same diagonal scaling (in double).  After scaling,
        # active diagonals are 1 and Marquardt damping is lam * I.
        diag = jnp.diag(H)
        dscale = jax.lax.rsqrt(jnp.maximum(diag, 1e-10)) * active_f
        Hs = H * dscale[:, None] * dscale[None, :]
        damp = lam * active_f + (1.0 - active_f)
        A = Hs + jnp.diag(damp)
        rhs = g * dscale
        with jax.named_scope("lm_solve"):
            delta_s = -solve_damped(A, rhs)
        delta = delta_s * dscale

        trial = p + delta
        trial = jnp.where(angle_mask, normalize_angle(trial), trial)
        c_new = cost_at(trial)
        accept = c_new < c_old
        p_next = jnp.where(accept, trial, p)
        c_next = jnp.where(accept, c_new, c_old)
        lam_next = jnp.clip(
            jnp.where(accept, lam / 3.0, lam * 4.0), 1e-10, 1e8
        )
        # Ceres parameter_tolerance semantics: ||dx|| <= ptol * (||x|| + ptol)
        # — a RELATIVE step test.  The absolute form ``||dx|| < tol`` with
        # tol=1e-7 essentially never fires in float32,
        # leaving convergence one-legged on the ftol path.  ``delta`` is zero
        # on inactive params (dscale carries active_f), so the norms only see
        # the active block.
        p_norm = jnp.linalg.norm(p * active_f)
        small = jnp.linalg.norm(delta) <= tol * (p_norm + tol)
        # Ceres-style function tolerance (Solver::Options::function_tolerance,
        # default 1e-6, which the reference leaves untouched in
        # ``ndt_matcher.cpp:371-381``): an accepted step that improves the
        # cost by less than ftol * cost has converged.  Without this the loop
        # always runs to max_iters — the parameter tolerance alone (1e-7)
        # essentially never fires in float32.
        flat = (c_old - c_new) <= ftol * c_old
        done_next = (accept & (small | flat)) | ((~accept) & (lam >= 1e7))
        return p_next, lam_next, c_next, it + 1, done_next

    def cond(carry):
        _, _, _, it, done = carry
        return (it < max_iters) & (~done)

    c0 = cost_at(params0)
    lam0 = jnp.asarray(1e-4, params0.dtype)
    p, _, c, it, _ = jax.lax.while_loop(
        cond, body, (params0, lam0, c0, jnp.int32(0), jnp.bool_(False))
    )
    return p, c


def gnc_solve(
    residual_fn: Callable,
    params0,
    active_mask,
    angle_mask,
    ndt_valid,
    aux_valid,
    ndt_scale,
    scale: float,
    alpha: float,
    gnc_steps: int,
    divisor: float,
    lm_max_iters: int,
    lm_tol: float,
    linearize_fn: Callable | None = None,
    lm_ftol: float = 1e-6,
) -> SolveResult:
    """Graduated non-convexity: LM solves over the decreasing-mu schedule
    (do-while, ``ndt_matcher.cpp:390-397``)."""
    rn0, _ = residual_fn(params0)
    s0_max = jnp.max(jnp.where(ndt_valid, rn0 * rn0, 0.0))
    mu0 = barron.gnc_mu_init(s0_max, scale, gnc_steps, divisor)

    def cond(carry):
        _, mu, rounds = carry
        first = rounds == 0
        return first | barron.gnc_continue(mu, divisor)

    @jax.named_scope("gnc_solve")
    def body(carry):
        p, mu, rounds = carry
        mu_eff = jnp.maximum(mu, 1.0)
        p_new, _ = lm_solve(
            residual_fn, p, active_mask, angle_mask, ndt_valid, aux_valid,
            ndt_scale, scale, alpha, mu_eff, lm_max_iters, lm_tol,
            linearize_fn=linearize_fn, ftol=lm_ftol,
        )
        return p_new, mu / divisor, rounds + 1

    p, mu, rounds = jax.lax.while_loop(
        cond, body, (params0, mu0, jnp.int32(0))
    )
    mu_fin = jnp.maximum(mu, 1.0)
    rn, ra = residual_fn(p)
    final_cost = _robust_cost(
        rn, ra, ndt_valid, aux_valid, ndt_scale, scale, alpha, mu_fin
    )
    return SolveResult(
        params=p,
        cost=final_cost,
        n_ndt_valid=jnp.sum(ndt_valid),
        gnc_rounds=rounds,
    )
